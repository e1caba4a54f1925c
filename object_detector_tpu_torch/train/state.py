"""Train state, learning-rate schedules and the optimizer updates.

The port of ``object_detector_tpu/train/state.py``. The reference builds its
optimizer from optax; here the schedule is a plain function of the step and
the two updates (SGD with momentum, AdamW) are written out on tensors, in
optax's order of operations:

- the update count is 0 at the first update, so with a warmup the first
  step's rate is 0; ``num_steps`` counts the warmup;
- clipping scales by ``max_norm / norm`` with no epsilon;
- weight decay reaches every parameter, biases and the L2Norm scale
  included, and enters before the learning rate;
- SGD applies the rate after the momentum.

The state is updated in place: a step writes into the parameters, the
optimizer state and the EMA it is given, puts the forward's new BatchNorm
statistics in ``batch_stats`` and returns the same `TrainState`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import torch

from object_detector_tpu_torch.core.config import TrainConfig

Tensor = torch.Tensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Tensor]  # float32 leaves that require grad
    # BatchNorm running statistics, float32, keyed like the state_dict
    # (``....running_mean``, ``....running_var``); {} for VGG. No gradient,
    # no optimizer slot, no weight decay, no EMA.
    batch_stats: Dict[str, Tensor]
    # "sgd": {"trace": {name: tensor}}; "adamw": {"mu": {...}, "nu": {...}}.
    opt_state: Dict[str, Dict[str, Tensor]]
    ema_params: Optional[Dict[str, Tensor]]  # None when EMA is disabled


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate as a function of the update count (0 at the first)."""
    warmup = cfg.warmup_steps

    def warm(step: int) -> float:  # linear from 0 to base_lr over the warmup
        return cfg.base_lr * min(max(step, 0), warmup) / warmup

    if cfg.schedule == "cosine":
        decay_steps = cfg.num_steps - warmup
        if decay_steps <= 0:
            raise ValueError(f"cosine schedule needs num_steps > warmup_steps, got {cfg}")

        def cosine(step: int) -> float:
            if step < warmup:
                return warm(step)
            t = min(step - warmup, decay_steps)
            return cfg.base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

        return cosine
    if cfg.schedule == "step":
        # Classic SSD step decay: x0.1 at 2/3 and 5/6 of training, counted
        # from the end of the warmup.
        boundaries = (int(cfg.num_steps * 2 / 3), int(cfg.num_steps * 5 / 6))

        def stepped(step: int) -> float:
            if step < warmup:
                return warm(step)
            return cfg.base_lr * math.prod(0.1 for b in boundaries if step - warmup >= b)

        return stepped
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def global_norm(tensors: Mapping[str, Tensor]) -> Tensor:
    """sqrt of the sum of squares over every leaf (the norm of the leaves'
    norms), float32."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(
    cfg: TrainConfig,
) -> Callable[[TrainState, Mapping[str, Tensor], Optional[Tensor]], None]:
    """Returns update(state, grads, grad_norm=None): clips, applies the SGD
    or AdamW update to ``state.params`` and ``state.opt_state`` in place at
    the rate of update count ``state.step``, and moves the EMA. It does not
    advance ``state.step``. ``grad_norm`` is ``global_norm(grads)`` where the
    caller has it already. Every operation runs over all leaves at once
    (``torch._foreach_*``): a step's launches do not grow with the number of
    leaves."""
    schedule = make_schedule(cfg)
    if cfg.optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    @torch.no_grad()
    def update(
        state: TrainState, grads: Mapping[str, Tensor], grad_norm: Optional[Tensor] = None
    ) -> None:
        names = list(state.params)
        params = [state.params[n] for n in names]
        g = [grads[n] for n in names]
        lr = schedule(state.step)
        if cfg.grad_clip_norm > 0:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            # (g / norm) * max_norm where the norm reaches the limit, else
            # (g / 1) * 1 = g: the select is made on the two scalars, on the
            # device, with no device-to-host sync.
            keep = norm < cfg.grad_clip_norm
            one = torch.ones_like(norm)
            g = torch._foreach_div(g, torch.where(keep, one, norm))
            torch._foreach_mul_(g, torch.where(keep, one, one * cfg.grad_clip_norm))
        if cfg.optimizer == "sgd":
            g = torch._foreach_add(g, params, alpha=cfg.weight_decay)
            if cfg.momentum:
                trace = [state.opt_state["trace"][n] for n in names]
                torch._foreach_mul_(trace, cfg.momentum)
                torch._foreach_add_(trace, g)
                g = trace
            torch._foreach_add_(params, g, alpha=-lr)
        else:
            count = state.step + 1
            mu = [state.opt_state["mu"][n] for n in names]
            nu = [state.opt_state["nu"][n] for n in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
            u = torch._foreach_div(mu, 1.0 - ADAM_B1 ** count)
            denom = torch._foreach_div(nu, 1.0 - ADAM_B2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            torch._foreach_div_(u, denom)
            torch._foreach_add_(u, params, alpha=cfg.weight_decay)
            torch._foreach_add_(params, u, alpha=-lr)
        if state.ema_params is not None:
            ema = [state.ema_params[n] for n in names]
            torch._foreach_mul_(ema, cfg.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - cfg.ema_decay)

    return update


def _is_batch_stat(name: str) -> bool:
    """Whether a state_dict entry is a BatchNorm running statistic."""
    return name.endswith((".running_mean", ".running_var"))


def create_train_state(cfg: TrainConfig, variables: Mapping[str, Tensor]) -> TrainState:
    """A fresh state around ``variables`` (a model's state_dict, or its named
    parameters): the running statistics split off into ``batch_stats`` as
    float32 copies; the rest float32 copies that require grad, with zeroed
    optimizer state and the EMA's own copy when ``ema_decay > 0``."""
    own = {k: v.detach().to(torch.float32).clone().requires_grad_(True)
           for k, v in variables.items() if not _is_batch_stat(k)}
    stats = {k: v.detach().to(torch.float32).clone() for k, v in variables.items()
             if _is_batch_stat(k)}
    zeros = lambda: {k: torch.zeros_like(v, requires_grad=False) for k, v in own.items()}  # noqa: E731
    if cfg.optimizer == "sgd":
        opt_state = {"trace": zeros()}
    elif cfg.optimizer == "adamw":
        opt_state = {"mu": zeros(), "nu": zeros()}
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    ema = {k: v.detach().clone() for k, v in own.items()} if cfg.ema_decay > 0 else None
    return TrainState(step=0, params=own, batch_stats=stats, opt_state=opt_state, ema_params=ema)
