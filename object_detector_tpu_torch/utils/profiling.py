"""Tracing and step timing, and the debug-mode NaN checks.

The port of ``object_detector_tpu/utils/profiling.py``: `trace` is a
``torch.profiler`` scope in place of ``jax.profiler``'s, `StepTimer` fences
with ``torch.cuda.synchronize`` in place of ``block_until_ready``, and
`enable_debug_checks` raises on NaNs as ``jax_debug_nans`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterator, Mapping, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` scope that writes a Chrome/Perfetto trace
    (``*.pt.trace.json``) into ``log_dir`` when it ends, with the CUDA
    activity where a card is present; yields the profiler. A no-op that
    yields None when ``log_dir`` is None or empty. After earlier profiler
    sessions in the process, the records of the first kernels launched in
    a window have been seen missing from its trace: open it a step ahead
    of what it must show."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor in a nest of mappings, sequences and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, Mapping):
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = (getattr(tree, f.name) for f in dataclasses.fields(tree))
    else:
        return None
    for child in children:
        found = _first_tensor(child)
        if found is not None:
            return found
    return None


class StepTimer:
    """Wall-clock step timing with a device fence.

    ``lap(result)`` waits for the device of the first tensor in ``result``
    (``torch.cuda.synchronize``; nothing to wait for on the CPU) and returns
    the seconds since the previous lap. Use ``fence=False`` on the steady
    path, where the device runs ahead, and fence only the sampled steps.
    """

    def __init__(self):
        self._t0 = time.perf_counter()

    def lap(self, result: Any = None, fence: bool = True) -> float:
        if fence and result is not None:
            tensor = _first_tensor(result)
            if tensor is not None and tensor.device.type == "cuda":
                torch.cuda.synchronize(tensor.device)
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt


def _raise_on_nan(module: torch.nn.Module, inputs: Any, output: Any) -> None:
    tensors = [output] if isinstance(output, torch.Tensor) else (
        output if isinstance(output, (list, tuple)) else [])
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"invalid value (nan) in the output of {type(module).__name__}")


class DebugChecks:
    """What `enable_debug_checks` turned on; ``remove()`` (or leaving a
    ``with`` block) turns it off and restores the anomaly mode it found."""

    def __init__(self, nans: bool):
        self._anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
        self._hook = None
        if nans:
            torch.autograd.set_detect_anomaly(True, check_nan=True)
            self._hook = torch.nn.modules.module.register_module_forward_hook(_raise_on_nan)

    def remove(self) -> None:
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
            torch.autograd.set_detect_anomaly(*self._anomaly)

    def __enter__(self) -> "DebugChecks":
        return self

    def __exit__(self, *exc) -> None:
        self.remove()


def enable_debug_checks(nans: bool = True) -> DebugChecks:
    """Debug-mode numerical checks, for every module of the process: a NaN
    in a module's forward output raises ``FloatingPointError`` (as
    ``jax_debug_nans`` does), and autograd's anomaly mode raises a
    ``RuntimeError`` naming the backward function that returned one. Each
    check reads the tensor back to the host. Returns the handle that undoes
    both."""
    return DebugChecks(nans)
