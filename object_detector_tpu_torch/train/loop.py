"""End-to-end training loop: data -> train step -> checkpoints and metrics.

The port of ``object_detector_tpu/train/loop.py``: the host pipeline
(decoded cache + prefetch), the train step, checkpointing with resume, and
JSONL metrics, with the host-to-device boundary crossed once per step.

Data parallelism (``mesh.data_parallel``, `parallel.mesh`) runs one process
a device. Every rank builds the same batch stream from the same seed, keeps
its rows and the global batch's boxes (`parallel.mesh.shard_batch`), and
holds its own decoded cache of the whole dataset (a spilled cache is
decoded once a host and shared, `DecodedCache`). Rank 0 alone writes the
metrics log and the checkpoints and decides the refusal of a directory that
already holds one; every rank restores.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.convert import init_params
from object_detector_tpu_torch.core.config import DetectorConfig
from object_detector_tpu_torch.core.device import resolve_device
from object_detector_tpu_torch.data.pipeline import (
    DecodedCache,
    DevicePrefetcher,
    epoch_batches,
    make_place,
)
from object_detector_tpu_torch.data.types import Dataset
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.parallel import mesh as mesh_lib
from object_detector_tpu_torch.train.checkpoint import CheckpointManager
from object_detector_tpu_torch.train.state import TrainState, create_train_state
from object_detector_tpu_torch.train.step import make_train_step
from object_detector_tpu_torch.utils import profiling
from object_detector_tpu_torch.utils.logging import MetricsLogger, setup_logging


def init_model_state(
    cfg: DetectorConfig, seed: int, device: str | torch.device = "cuda"
) -> Tuple[torch.nn.Module, TrainState]:
    """The model with weights from ``seed`` on ``device``, and a fresh train
    state around copies of them and of its BatchNorm running statistics (mean
    0 and var 1, as the reference's init leaves them)."""
    dev = resolve_device(device)
    model = init_params(build_model(cfg), seed=seed).to(dev)
    return model, create_train_state(cfg.train, model.state_dict())


def train(
    cfg: DetectorConfig,
    dataset: Dataset,
    num_steps: Optional[int] = None,
    metrics_path: Optional[str] = None,
    resume: bool = False,
    checkpoint_dir: Optional[str] = None,
    profile_dir: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Trains ``num_steps`` (default ``cfg.train.num_steps``) steps and
    returns the final state. ``mesh.data_parallel`` = n > 1 in a process no
    launcher started (torchrun, or `parallel.mesh.spawn`) spawns n local
    processes, one a device, runs this function in each and returns rank
    0's final state; under a launch, this process is one rank of the run."""
    log = setup_logging()
    num_steps = num_steps or cfg.train.num_steps
    world = mesh_lib.world_size(cfg.mesh.data_parallel, device)
    if cfg.train.batch_size % world:
        raise ValueError(
            f"global batch {cfg.train.batch_size} not divisible by {world} devices"
        )
    if world > 1 and not dist.is_initialized():
        return mesh_lib.spawn(world, device, train, (
            cfg, dataset, num_steps, metrics_path, resume, checkpoint_dir, profile_dir, device))
    mesh = mesh_lib.make_mesh(cfg.mesh.data_parallel, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0  # writes the log and the checkpoints
    if lead:
        log.info(
            "training %s: %d rank(s)%s on %s, global batch %d, %d steps",
            cfg.name, world, "" if mesh is None else f", backend {dist.get_backend()}", dev,
            cfg.train.batch_size, num_steps,
        )

    # The run's root generator: its initial seed, folded with the step, seeds
    # each step's draws; its state travels in the checkpoint.
    generator = torch.Generator().manual_seed(cfg.train.seed)
    model, state = init_model_state(cfg, cfg.train.seed, dev)
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    step_fn = make_train_step(cfg, model, anchors, dev, mesh=mesh)

    ckpt_mgr: Optional[CheckpointManager] = None
    data_step = 0
    ckpt_dir = checkpoint_dir or cfg.train.checkpoint_dir
    if ckpt_dir:
        ckpt_mgr = CheckpointManager(
            ckpt_dir, cfg.train.keep_checkpoints, cfg.train.checkpoint_every, mesh=mesh
        )
        if resume:
            restored = ckpt_mgr.restore(state, generator)
            if restored is not None:
                state, generator, data_step = restored
                if lead:
                    log.info("resumed from step %d", state.step)
        else:
            latest = ckpt_mgr.latest_step()
            if mesh is not None:  # rank 0's reading decides for every rank
                latest = int(mesh.broadcast_(torch.tensor(
                    [-1 if latest is None else latest], device=dev)).item())
                latest = None if latest < 0 else latest
            if latest is not None:
                # Without this the run would train while the directory keeps
                # serving an older, possibly different model's, latest step to
                # evaluate/predict until the new run overtakes it.
                raise ValueError(
                    f"checkpoint dir {ckpt_dir} already has a checkpoint at "
                    f"step {latest}; pass --resume to continue "
                    "it or point --checkpoint at a fresh directory"
                )

    cache = DecodedCache(
        dataset, cfg.model.image_size, cfg.data.max_boxes, cfg.data.num_workers,
        max_ram_bytes=int(cfg.data.max_cache_ram_gb * 2**30),
        spill_dir=cfg.data.cache_spill_dir or None, mesh=mesh,
    )
    batches = epoch_batches(
        cache, cfg.train.batch_size, cfg.train.seed, start_step=data_step
    )
    place = make_place(dev)
    if mesh is not None:
        place = lambda b, to_device=place: to_device(mesh_lib.shard_batch(mesh, b))  # noqa: E731
    prefetcher = DevicePrefetcher(batches, place, depth=cfg.data.prefetch)

    metrics_log = MetricsLogger(metrics_path if lead else None, echo=lead)
    t_last = time.perf_counter()
    start_step = state.step
    last_logged_step = start_step

    try:
        with profiling.trace(profile_dir):
            for step_i in range(start_step, num_steps):
                batch = next(prefetcher)
                state, metrics = step_fn(state, batch, generator)
                data_step += 1
                if ckpt_mgr is not None:
                    ckpt_mgr.save(state, generator, data_step, step=step_i + 1)
                if (step_i + 1) % cfg.train.log_every == 0 or step_i + 1 == num_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    now = time.perf_counter()
                    # Steps really done since the last log: right after a resume
                    # at step N and for the final partial window.
                    steps_done = step_i + 1 - last_logged_step
                    imgs_per_sec = cfg.train.batch_size * steps_done / max(now - t_last, 1e-9)
                    t_last = now
                    last_logged_step = step_i + 1
                    metrics_log.log(
                        "train",
                        step=step_i + 1,
                        imgs_per_sec=imgs_per_sec,
                        imgs_per_sec_chip=imgs_per_sec / world,
                        **metrics,
                    )
    finally:
        prefetcher.close()
        if ckpt_mgr is not None:
            ckpt_mgr.save(state, generator, data_step, force=True)
        metrics_log.close()
    return state
