"""Data-parallel training over ``torch.distributed``: one process a device.

The port of ``object_detector_tpu/parallel/mesh.py``. The reference runs
one jitted program over a 1-D ``data`` mesh: the batch is sharded, the
state replicated, and XLA inserts the collectives. Here every device has a
process of its own holding a whole copy of the state and its rows of the
batch, and the train step makes its collectives itself (`Mesh`), with
``all_reduce`` (SUM) and ``broadcast`` only: the two collectives gloo also
runs on CUDA tensors.

- `_multi_process_launch`: the torchrun contract (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) in place of
  ``jax.distributed``'s;
- `maybe_init_distributed`: ``init_process_group`` from that environment,
  NCCL on the card and gloo on the CPU;
- `make_mesh`: this process's `Mesh` (process group, rank, world size, the
  rank's device ``cuda:LOCAL_RANK``), with the reference's error where more
  devices are asked for than there are;
- `shard_batch`: this rank's rows of a global host batch;
- `spawn`: the processes of a run that no launcher started.

``batch_sharding`` and ``replicated`` have no counterpart: nothing is laid
out across devices by a sharding, since each process holds its own rows
and its own copy of the state.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# The environment a launcher exports to each process it starts (torchrun's).
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# Gradients are all-reduced in flat buckets of at most this many bytes.
BUCKET_BYTES = 25 * 2**20


def _multi_process_launch() -> bool:
    """True when a launcher started this process: torchrun, or any launcher
    that keeps its contract, exports every name of `LAUNCH_ENV`. A launch of
    one process is a launch too: it runs the collectives over a group of
    one."""
    return all(os.environ.get(name) for name in LAUNCH_ENV)


def backend_for(device: str | torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(device: str | torch.device = "cuda") -> bool:
    """Makes the default process group from the launch's environment when a
    launcher started this process (`_multi_process_launch`) and there is no
    group yet; returns whether it made one. A process of a run without a
    launcher does nothing here: `train` spawns the ranks it needs."""
    if dist.is_initialized() or not _multi_process_launch():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend_for(device), init_method="env://")
    return True


def local_devices(device: str | torch.device) -> int:
    """The devices of this host a rank can take: its CUDA cards, or for the
    CPU the cores this process may run on (a process each)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def world_size(data_parallel: int, device: str | torch.device = "cuda") -> int:
    """The number of ranks a run of ``mesh.data_parallel`` takes. Under a
    launch it is the launch's process count, which ``data_parallel`` (-1 or
    0: all of them) must equal. Without one, -1 and 0 ask for every CUDA
    card, and on the CPU for one process (the reference's CPU tests see
    eight fake devices instead). Raises the reference's error where more
    devices are asked for than there are."""
    launched = dist.is_initialized()
    available = dist.get_world_size() if launched else local_devices(device)
    if data_parallel in (-1, 0):
        n = available if launched or torch.device(device).type == "cuda" else 1
    else:
        n = data_parallel
    if n > available:
        raise ValueError(f"requested {n}-way data parallelism but only {available} devices")
    if launched and n != available:
        raise ValueError(
            f"mesh.data_parallel={n} but the launch started {available} processes: "
            "launch one process a device of the mesh"
        )
    return max(n, 1)


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward is the SUM of the cotangents: each
    rank's loss reaches every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: "Mesh") -> Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g: Tensor):
        return ctx.mesh.all_reduce_(g.clone(memory_format=torch.contiguous_format)), None


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel mesh seen from one rank: the process group, this
    process's rank in it, the world size and the device the rank computes
    on. ``bytes_reduced`` counts the bytes this rank has all-reduced.
    ``local_rank`` is the rank among the processes of this host (the
    launch's ``LOCAL_RANK``; the rank itself where it is not given)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    bytes_reduced: int = 0
    local_rank: Optional[int] = None

    def __post_init__(self):
        if self.local_rank is None:
            self.local_rank = self.rank

    def all_reduce_(self, x: Tensor) -> Tensor:
        """SUM of the dense tensor ``x`` over the ranks, in place; returns it."""
        self.bytes_reduced += x.numel() * x.element_size()
        dist.all_reduce(x, group=self.group)
        return x

    def all_reduce(self, x: Tensor) -> Tensor:
        """SUM of ``x`` over the ranks, as a new tensor, differentiable (the
        counterpart of a ``psum`` over flax's ``axis_name``)."""
        return _AllReduceSum.apply(x, self)

    def all_reduce_buckets(
        self, tensors: Sequence[Tensor], bucket_bytes: int = BUCKET_BYTES
    ) -> List[Tensor]:
        """The SUM over the ranks of each tensor, as new tensors: consecutive
        tensors of one dtype are flattened into buckets of at most
        ``bucket_bytes`` (a larger tensor is a bucket of its own), one
        all_reduce a bucket."""
        out: List[Tensor] = []
        i = 0
        while i < len(tensors):
            j, size = i, 0
            while j < len(tensors) and tensors[j].dtype == tensors[i].dtype:
                nbytes = tensors[j].numel() * tensors[j].element_size()
                if j > i and size + nbytes > bucket_bytes:
                    break
                size += nbytes
                j += 1
            bucket = tensors[i:j]
            flat = self.all_reduce_(torch.cat([t.reshape(-1) for t in bucket]))
            sizes = [t.numel() for t in bucket]
            out.extend(v.view_as(t) for v, t in zip(flat.split(sizes), bucket))
            i = j
        return out

    def broadcast_(self, x: Tensor, src: int = 0) -> Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns it."""
        dist.broadcast(x, src, group=self.group)
        return x

    def barrier(self) -> None:
        """Returns on each rank once every rank has called it (an
        all_reduce of one element)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)


def make_mesh(data_parallel: int = -1, device: str | torch.device = "cuda") -> Optional[Mesh]:
    """This process's mesh over the ranks of its launch: rank r computes on
    ``cuda:LOCAL_RANK`` (or the CPU). None for a run of one process without
    a launch: its step makes no collective. Raises the reference's error
    where ``data_parallel`` asks for more devices than there are
    (`world_size`), and where it asks for more than one process and no
    launcher started them."""
    n = world_size(data_parallel, device)
    if not dist.is_initialized():
        if n > 1:
            raise RuntimeError(
                f"{n}-way data parallelism takes a process a device: start them with "
                "torchrun, or train(), which spawns them"
            )
        return None
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
    return Mesh(dist.group.WORLD, dist.get_rank(), n, dev, local_rank=local)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global host batch, for every key, plus the
    global batch's boxes and valid flags as ``global_boxes`` and
    ``global_valid``: the step's augmentation draws for the global batch
    from them and applies this rank's rows (`train.step.make_train_step`).
    The caller places the result on ``mesh.device`` (the train loop through
    its prefetcher)."""
    total = len(batch["image"])
    if total % mesh.world:
        raise ValueError(f"global batch {total} not divisible by {mesh.world} devices")
    per = total // mesh.world
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return {**{k: v[rows] for k, v in batch.items()},
            "global_boxes": batch["boxes"], "global_valid": batch["valid"]}


def _spawned(rank: int, world: int, device: str, directory: str, fn: Callable, args: tuple):
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_for(device), init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(directory, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, device: str | torch.device, fn: Callable, args: tuple = ()) -> Any:
    """Runs ``fn(*args)`` in ``world`` new processes (the spawn start
    method) and returns rank 0's result. Rank r joins a process group over
    a file in a temporary directory, NCCL with ``cuda:r`` for a CUDA device
    and gloo for the CPU, so `make_mesh` sees the launch. A rank that raises
    ends the others, and the error is raised here. ``fn`` and ``args`` are
    pickled; rank 0's result comes back through ``torch.save``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="odt_spawn_") as directory:
        mp.spawn(_spawned, args=(world, str(device), directory, fn, args), nprocs=world, join=True)
        return torch.load(os.path.join(directory, "result.pt"), weights_only=False)
