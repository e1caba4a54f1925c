"""Checkpoint and resume, in the port's own format.

The port of ``object_detector_tpu/train/checkpoint.py``: the same contents
(params, BatchNorm running statistics, optimizer state, EMA, step, the
generator's state, the dataset cursor), keep-last-k retention and a save
interval, so a resumed run continues step for step. One ``torch.save`` file
per kept step, ``step_<n>.pt``, written synchronously to a temporary name
and renamed (so there is nothing to wait for or close). A checkpoint
written before the statistics were kept holds none: it restores a model
without BatchNorm (SSD-300/VGG16) and is refused for one with. The
reference's orbax checkpoints are converted to this format by
``tools/convert_orbax_checkpoint.py``, where JAX is installed.

Under data parallelism every rank holds the same state, so only rank 0
writes (``mesh``), every rank waits for it at a barrier after each save,
and every rank restores, after a barrier, from the same file. A
data-parallel run's checkpoint is the same file as a one-device run's.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from object_detector_tpu_torch.parallel.mesh import Mesh
from object_detector_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_every: int = 1000,
                 mesh: Optional[Mesh] = None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        self._save_every = max(1, save_every)
        self._mesh = mesh

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(
        self,
        state: TrainState,
        generator: torch.Generator,
        data_step: int,
        step: Optional[int] = None,
        force: bool = False,
    ) -> bool:
        """Save if the retention policy wants this step (a multiple of the
        interval, or ``force``) and it is not on disk already. Under a mesh
        every rank calls it and rank 0 alone writes; returns whether this
        process wrote."""
        if step is None:
            step = state.step
        if not force and step % self._save_every:
            return False
        wrote = (self._mesh is None or self._mesh.rank == 0) and self._write(
            state, generator, data_step, step)
        if self._mesh is not None:
            self._mesh.barrier()
        return wrote

    def _write(self, state: TrainState, generator: torch.Generator, data_step: int,
               step: int) -> bool:
        if self.latest_step() == step:
            return False  # e.g. the final forced save after an interval save
        cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
        payload = {
            "step": state.step,
            "params": cpu(state.params),
            "batch_stats": cpu(state.batch_stats),
            "opt_state": {k: cpu(v) for k, v in state.opt_state.items()},
            "ema_params": None if state.ema_params is None else cpu(state.ema_params),
            "generator_state": generator.get_state(),
            "generator_seed": generator.initial_seed(),
            "data_step": int(data_step),
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self._keep > 0:
            for old in self._steps()[: -self._keep]:
                os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(
        self, template_state: TrainState, template_generator: torch.Generator
    ) -> Optional[Tuple[TrainState, torch.Generator, int]]:
        """The latest checkpoint copied into the template's tensors (on
        their device) and generator, or None if there is none."""
        if self._mesh is not None:
            self._mesh.barrier()
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)

        def fill(dst, src, what):
            if set(dst) != set(src):
                raise ValueError(
                    f"checkpoint {self._path(step)} holds other {what} than the model: "
                    f"{sorted(set(dst) ^ set(src))[:5]}"
                )
            with torch.no_grad():
                for k, v in dst.items():
                    v.copy_(src[k])

        state = template_state
        fill(state.params, payload["params"], "params")
        if "batch_stats" in payload:
            fill(state.batch_stats, payload["batch_stats"], "BatchNorm statistics")
        elif state.batch_stats:
            raise ValueError(
                f"checkpoint {self._path(step)} holds no BatchNorm running statistics, which "
                "the model has: it was written before checkpoints carried them"
            )
        if set(state.opt_state) != set(payload["opt_state"]):
            raise ValueError(
                f"checkpoint {self._path(step)} holds optimizer state "
                f"{sorted(payload['opt_state'])}, the config asks for {sorted(state.opt_state)}"
            )
        for name, tree in state.opt_state.items():
            fill(tree, payload["opt_state"][name], f"optimizer state {name!r}")
        if (state.ema_params is None) != (payload["ema_params"] is None):
            raise ValueError(f"checkpoint {self._path(step)} and the config disagree on the EMA")
        if state.ema_params is not None:
            fill(state.ema_params, payload["ema_params"], "EMA params")
        state.step = int(payload["step"])
        template_generator.manual_seed(int(payload["generator_seed"]))
        template_generator.set_state(payload["generator_state"])
        return state, template_generator, int(payload["data_step"])
