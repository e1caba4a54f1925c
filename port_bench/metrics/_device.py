"""Shared arithmetic of the readers: device time under a span, a hand
kernel's roofline share, a model's share of a peak."""

from __future__ import annotations

from port_bench import kernels
from port_bench.reference import detector


def span_ms(r, span: str, keep=lambda name: True):
    """Device ms a call of ``span``, of the kernels ``keep`` accepts."""
    if r.trace is None or not r.trace.span_count(span):
        return None
    us = sum(d for name, d in r.trace.kernels(span) if keep(name))
    return us / r.trace.span_count(span) / 1e3


def roofline_pct(r, kernel: str, bound_ms_a_launch):
    """Least time over device time of a hand kernel's launches in the traced
    window, in %; None where it did not run."""
    if r.trace is None:
        return None
    launches, us = kernels.time_of(r.trace.kernels(), kernel)
    if not launches or us <= 0:
        return None
    return 100.0 * launches * bound_ms_a_launch * 1e3 / us


def mfu_pct(r, work: str, peak: float):
    """Conv operations (2 a multiply-add) of the work done in the untraced
    part of the window over its seconds and ``peak``, in %."""
    done, seconds = r.host.get(work), r.host.get("seconds_untraced")
    if not done or not seconds:
        return None
    ops = 2 * detector.macs_per_image(r.arch) * done
    return 100.0 * ops / seconds / peak


def idle_pct(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
