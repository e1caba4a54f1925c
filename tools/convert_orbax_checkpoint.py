#!/usr/bin/env python3
"""Converts a checkpoint of the JAX reference's training into the port's.

    python3 tools/convert_orbax_checkpoint.py --preset ssd300_vgg16_voc \\
        [--set train.batch_size=32 ...] --src <orbax dir> [--step n] --dst <dir>

Run it where JAX, flax and orbax are installed: it imports both packages.
It restores the reference's training state as the reference's own
``CheckpointManager.restore`` does (the latest step, or ``--step``) onto the shapes of
its ``init_model_state`` for the config, and writes ``step_<n>.pt``
into ``--dst`` in the port's format, which ``train --resume``,
``predict --checkpoint`` and ``evaluate --checkpoint`` of the port read:

- params and BatchNorm running statistics through ``convert.variables_from_jax``;
- the momentum trace, or Adam's moments, and the update count through
  ``convert.opt_state_from_optax`` (the count must equal the step);
- the EMA, the step and the dataset cursor as they are.

The reference's PRNG key has no counterpart: the port draws its
augmentations from a torch generator, so a resumed run draws other numbers
than the reference's would, by design. The generator is seeded with the
config's ``train.seed``, as the port's ``train`` seeds a fresh run.
``--preset`` and ``--set`` must describe the run that wrote the checkpoint
(the optimizer, the EMA and the model's shapes).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def convert(args: argparse.Namespace) -> int:
    """Converts; returns the step written."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from object_detector_tpu.cli.main import _load_config as ref_load_config
    from object_detector_tpu.train.checkpoint import CheckpointManager as RefCheckpointManager
    from object_detector_tpu.train.loop import init_model_state as ref_init_model_state
    from object_detector_tpu_torch.cli.main import _load_config
    from object_detector_tpu_torch.convert import (
        flatten_tree, opt_state_from_optax, params_from_jax, variables_from_jax,
    )
    from object_detector_tpu_torch.train.checkpoint import CheckpointManager
    from object_detector_tpu_torch.train.loop import init_model_state

    ref_cfg, cfg = ref_load_config(args), _load_config(args)
    key = jax.random.key(ref_cfg.train.seed)
    # The template's shapes and dtypes only: no initialization is computed.
    with jax.enable_x64(ref_cfg.model.compute_dtype == "float64"):
        template = jax.eval_shape(lambda k: ref_init_model_state(ref_cfg, k)[1], key)
    ref_mgr = RefCheckpointManager(args.src)
    steps = list(ref_mgr._mgr.all_steps())
    if not steps:
        raise SystemExit(f"no checkpoint in {args.src}")
    at = ref_mgr.latest_step() if args.step is None else args.step
    if at not in steps:
        raise SystemExit(f"no step {at} in {args.src}: {steps}")
    # The body of the reference's CheckpointManager.restore, which restores
    # only the latest step, at the chosen one: the payload its save writes.
    restored = ref_mgr._mgr.restore(at, args=ocp.args.StandardRestore({
        "state": jax.device_get(template),
        "rng_key": jax.device_get(jax.random.key_data(key)),
        "data_step": np.asarray(0)}))
    ref_state, data_step = restored["state"], int(restored["data_step"])
    ref_mgr.close()

    _, state = init_model_state(cfg, cfg.train.seed, device="cpu")
    step = int(ref_state.step)
    variables = variables_from_jax({"params": ref_state.params,
                                    "batch_stats": ref_state.batch_stats})
    opt_state, count = opt_state_from_optax(ref_state.opt_state)
    if count != step:
        raise ValueError(f"the optimizer's update count {count} is not the step {step}")
    ema = None if ref_state.ema_params is None else params_from_jax(
        flatten_tree(ref_state.ema_params))

    def fill(dst, src, what):
        if set(dst) != set(src):
            raise ValueError(f"the checkpoint holds other {what} than the port's "
                             f"{cfg.name}: {sorted(set(dst) ^ set(src))[:5]}")
        with torch.no_grad():
            for k, v in dst.items():
                if tuple(v.shape) != tuple(src[k].shape):
                    raise ValueError(f"{what} {k}: shape {tuple(src[k].shape)} in the "
                                     f"checkpoint, {tuple(v.shape)} in the model")
                v.copy_(src[k])

    fill(state.params, {k: v for k, v in variables.items() if k in state.params}, "params")
    fill(state.batch_stats, {k: v for k, v in variables.items() if k not in state.params},
         "BatchNorm statistics")
    if set(state.opt_state) != set(opt_state):
        raise ValueError(f"the checkpoint holds optimizer state {sorted(opt_state)}, the "
                         f"config asks for {sorted(state.opt_state)}")
    for name, tree in state.opt_state.items():
        fill(tree, opt_state[name], f"optimizer state {name!r}")
    if (state.ema_params is None) != (ema is None):
        raise ValueError("the checkpoint and the config disagree on the EMA")
    if ema is not None:
        fill(state.ema_params, ema, "EMA params")
    state.step = step
    generator = torch.Generator().manual_seed(cfg.train.seed)
    CheckpointManager(args.dst, keep=cfg.train.keep_checkpoints).save(
        state, generator, data_step, force=True)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--src", required=True, help="the reference's checkpoint directory")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--dst", required=True, help="the port's checkpoint directory")
    args = p.parse_args(argv)
    step = convert(args)
    print(f"wrote step {step} of {args.src} -> {args.dst}/step_{step}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
