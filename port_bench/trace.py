"""The traced part of a window: ``torch.profiler`` over the card, and the
reduction of its trace to device time by kernel, by span and by interval.

Spans are ``record_function`` ranges the harness puts around calls into the
program's layers. A kernel belongs to a span when the host call that
launched it (matched by CUPTI's correlation id) lies inside the span. The
device is busy where any kernel, copy or memset runs: the union of their
intervals, so kernels that overlap count once.

The trace's device clock is held to CUDA events: `Profile.mark` launches a
marker kernel inside a ``bench.clock`` span and records an event after it,
once at each end and before every batch, and the device timestamps are
mapped piece by piece between the markers so that each two lie as far apart
as their events say. On the card's machines a trace has now and then come
with device durations at half their length, or stretched by a tenth over
part of the window.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "bench.window"
CLOCK_SPAN = "bench.clock"
# Markers closer than this (µs) on either clock are not a piece of their own.
MARK_GAP = 100.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def warm(device) -> None:
    """A throwaway profiler session in set-up: the first start of CUPTI takes
    seconds, which would otherwise fall inside the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


class Profile:
    """Context manager around the traced part: starts the profiler and the
    window span, and on exit synchronizes, stops and reduces the trace."""

    def __init__(self):
        self.prof = None
        self.span = None
        self.marker = None
        self.clock: List[torch.cuda.Event] = []
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.marker = torch.zeros(1, device="cuda")
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.mark()
        return self

    def mark(self) -> None:
        """A marker kernel, and a CUDA event recorded after it."""
        with torch.profiler.record_function(CLOCK_SPAN):
            self.marker.fill_(0.0)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.clock.append(event)

    def __exit__(self, *exc):
        self.mark()
        torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = Trace(events, [self.clock[0].elapsed_time(e) * 1e3 for e in self.clock])
        return False


class Trace:
    def __init__(self, events: List[dict], clock: Sequence[float] = ()):
        """``clock``: µs from the first `Profile.mark` to each."""
        self.device: List[Tuple[float, float, str, int]] = []  # (ts, end, name, corr)
        launch_ts: Dict[int, Tuple[float, int]] = {}
        spans: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                corr = (e.get("args") or {}).get("correlation", -1)
                name = e["name"] if cat == "kernel" else cat
                self.device.append((ts, ts + dur, name, corr))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                spans[e["name"]].append((ts, ts + dur, e.get("tid")))
        self.launch_ts = launch_ts
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.span_starts = {k: [r[0] for r in v] for k, v in self.spans.items()}
        window = self.spans.get(WINDOW_SPAN)
        if not window:
            raise RuntimeError("the trace holds no window span")
        self.t0, self.t1 = window[0][0], window[0][1]
        self.clock_pieces: List[float] = []
        self.clock_ratio = self._rescale(clock)
        self.device = [d for d in self.device if d[1] > self.t0 and d[0] < self.t1]
        self.device.sort()

    def _rescale(self, clock: Sequence[float]) -> float:
        """Maps the device timestamps, piece by piece between the markers
        found (at least ``MARK_GAP`` µs apart), onto the events' clock from
        the first of them; returns the markers' device distance over the
        events' from first to last, 1 with fewer than two markers."""
        ends = {}
        for ts, end, name, corr in self.device:
            i = self._span_of(CLOCK_SPAN, corr, ts)
            if i is not None and i < len(clock) and name not in DEVICE_CATS:
                ends[i] = end
        dev, ev = [], []
        for i in sorted(ends):
            if not dev or (ends[i] - dev[-1] >= MARK_GAP and clock[i] - ev[-1] >= MARK_GAP):
                dev.append(ends[i])
                ev.append(clock[i])
        if len(dev) < 2:
            return 1.0

        def to_events(ts: float) -> float:
            k = min(max(bisect.bisect_right(dev, ts) - 1, 0), len(dev) - 2)
            slope = (ev[k + 1] - ev[k]) / (dev[k + 1] - dev[k])
            return dev[0] + ev[k] - ev[0] + (ts - dev[k]) * slope

        self.device = [(to_events(ts), to_events(end), name, corr)
                       for ts, end, name, corr in self.device]
        pieces = [(d1 - d0) / (e1 - e0) for d0, d1, e0, e1 in zip(dev, dev[1:], ev, ev[1:])]
        self.clock_pieces = [min(pieces), max(pieces)]
        return (dev[-1] - dev[0]) / (ev[-1] - ev[0])

    def _span_of(self, span: str, corr: int, ts: float) -> Optional[int]:
        """The index of the ``span`` range that holds the launch of the
        device record ``corr`` (or its own start, without a launch)."""
        starts = self.span_starts.get(span)
        if not starts:
            return None
        launch = self.launch_ts.get(corr)
        at = launch[0] if launch else ts
        i = bisect.bisect_right(starts, at) - 1
        return i if i >= 0 and at <= self.spans[span][i][1] else None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for ts, end, _, _ in self.device:
            ts, end = max(ts, self.t0), min(end, self.t1)
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def kernels(self, span: Optional[str] = None) -> List[Tuple[str, float]]:
        """(name, device µs) of every kernel in the window, or of those
        launched inside ``span``."""
        return [(name, end - ts) for ts, end, name, corr in self.device
                if name not in DEVICE_CATS
                and (span is None or self._span_of(span, corr, ts) is not None)]

    def device_ops(self) -> List[list]:
        totals: Dict[str, float] = defaultdict(float)
        for ts, end, name, _ in self.device:
            totals[name] += (min(end, self.t1) - max(ts, self.t0)) / 1e6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self) -> List[list]:
        """Idle seconds of the device by the innermost harness span open on
        the host at each gap's middle ("host" where none is)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        totals: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label, width = "host", float("inf")
            for name, ranges in self.spans.items():
                if name == WINDOW_SPAN:
                    continue
                i = bisect.bisect_right(self.span_starts[name], mid) - 1
                if i >= 0 and mid <= ranges[i][1] and ranges[i][1] - ranges[i][0] < width:
                    label, width = name, ranges[i][1] - ranges[i][0]
            totals[label] += (b - a) / 1e6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, s] for name, s in top]
