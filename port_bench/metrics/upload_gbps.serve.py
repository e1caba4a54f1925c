"""GB/s of the entry layer's staged upload: the bytes that went through the
program's pinned ring (counter ``odt.upload.staged_bytes``) over the device
seconds of the host-to-device copies launched under its ``odt.upload``
spans. The bytes are scaled by the share of the staged chunks (counter
``odt.upload.chunks``, one copy each) whose copy records the trace holds
(a trace can miss the first device records of its window). Copies outside
the spans, such as the detections' readback, are not counted; a small copy
the ring leaves to the pageable path under the span (the DETR families'
extents, 512 bytes) adds its few µs to the time.

The counters add up only while a profiler records; in a run only the traced
window calls the program under a profiler. A program without
the counters or the spans reads None."""

SPAN = "odt.upload"
BYTES = "odt.upload.staged_bytes"
CHUNKS = "odt.upload.chunks"
COPY = "gpu_memcpy"


def read(r):
    from object_detector_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    t = r.trace
    if t is None or counters is None or not t.span_count(SPAN):
        return None
    counted = counters()
    staged, chunks = counted.get(BYTES), counted.get(CHUNKS)
    copies = [end - ts for ts, end, name, corr in t.device
              if name == COPY and t._span_of(SPAN, corr, ts) is not None]
    us = sum(copies)
    if not staged or not chunks or us <= 0:
        return None
    return staged * min(1.0, len(copies) / chunks) / us / 1e3
