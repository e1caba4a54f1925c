"""The entry layer's host-to-device copy of a batch, staged through a small
ring of pinned host buffers in chunks, so that the host's copy of chunk k+1
into the ring runs while the card's copy engine moves chunk k.

A pageable ``tensor.to("cuda")`` is one ``cudaMemcpy`` that CUDA stages
through its own pinned bounce buffers, on one host thread, with the caller
waiting. `StagedUpload` stages instead: each chunk is copied by the
host into a free pinned slot (``Tensor.copy_``, which runs on the intra-op
threads), then its ``non_blocking`` copy into the call's device tensor is
enqueued on the device's current stream, and the host moves on to the next
chunk. Each slot carries an event recorded after its copy to the card; a
slot is written again only after its event, in a later call too. The ring
is allocated on the first staged call and kept. The caller's memory is read
only during the call: once it returns, the caller may overwrite it.

The plan (`chunk_plan`) depends only on the bytes: a batch of fewer than
two chunks is one staged copy with no pipelining. A batch of fewer than
`PAGEABLE_BELOW` bytes (one or a few images: the bs=1 users' case) takes
the plain ``.to``, which the card measured as fast or faster there. A batch
already on the card skips staging, and on the CPU the plain ``.to`` stays.
A non-contiguous batch is staged from a contiguous copy of it. The device
tensor holds exactly the source's bytes.

While a profiler records, each staged call adds its bytes to
`STAGED_BYTES` and its chunks to `CHUNKS`; a bypass adds nothing.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

from object_detector_tpu_torch.utils import profiling

# The target bytes of a chunk and the slots of the ring, from the staged
# upload's time on the card at each serving batch's bytes (`chip_smoke.py`
# phase 49: on an H100 host 16 MiB in 2 slots took a RetinaNet batch of
# 50 MB in 2.0 ms, 4 MiB chunks 2.6 to 3.0, the pageable copy 6.9 to 7.5).
# A slot holds two chunks: `chunk_plan`'s longest range.
CHUNK_BYTES = 16 << 20
SLOTS = 2
# Below this many bytes the staged copy was slower than the pageable one on
# the card (270 KB: 0.085 against 0.043 to 0.053 ms; 1.57 MB: 0.186 against
# 0.162 to 0.170), and as fast at 3 MiB.
PAGEABLE_BELOW = 3 << 20
# Inner chunk bounds fall on multiples of this many bytes.
ALIGN = 4096
STAGED_BYTES = "odt.upload.staged_bytes"
CHUNKS = "odt.upload.chunks"


def chunk_plan(nbytes: int, chunk: int = CHUNK_BYTES) -> List[Tuple[int, int]]:
    """The byte ranges ``[start, end)`` that a staged copy of ``nbytes``
    moves, in order: ``max(1, nbytes // chunk)`` ranges of near-equal length
    that cover it, inner bounds on multiples of `ALIGN`; none for 0 bytes.
    Every range is shorter than ``2 * chunk`` for a ``chunk`` of at least
    ``2 * ALIGN``."""
    if nbytes <= 0:
        return []
    k = max(1, nbytes // chunk)
    bounds = [0] + [i * nbytes // k // ALIGN * ALIGN for i in range(1, k)] + [nbytes]
    return list(zip(bounds, bounds[1:]))


def stages(source: torch.device, target: torch.device, nbytes: int) -> bool:
    """Whether ``nbytes`` on ``source`` go to ``target`` through the ring:
    from the host to a card, from `PAGEABLE_BELOW` bytes up; every other
    copy is the plain ``.to``."""
    return source.type == "cpu" and target.type == "cuda" and nbytes >= PAGEABLE_BELOW


class StagedUpload:
    """``upload(x)`` -> ``x`` (a numpy array or a tensor) on ``device``, as
    ``torch.as_tensor(x).to(device)`` gives it, staged through the pinned
    ring for a host batch and a CUDA ``device`` (module docstring). Calls
    from several threads take turns."""

    def __init__(self, device: torch.device):
        self.device = device
        self._chunk, self._slots = CHUNK_BYTES, SLOTS
        self._ring: Optional[List[Tuple[torch.Tensor, torch.cuda.Event]]] = None
        self._next = 0
        self._lock = threading.Lock()

    def __call__(self, x) -> torch.Tensor:
        src = torch.as_tensor(x)
        nbytes = src.numel() * src.element_size()
        if not stages(src.device, self.device, nbytes):
            return src.to(self.device)
        src = src.contiguous()
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        plan = chunk_plan(nbytes, self._chunk)
        src_bytes, out_bytes = src.reshape(-1).view(torch.uint8), out.view(-1).view(torch.uint8)
        with self._lock:
            if self._ring is None:
                self._ring = [(torch.empty(2 * self._chunk, dtype=torch.uint8, pin_memory=True),
                               torch.cuda.Event()) for _ in range(self._slots)]
            stream = torch.cuda.current_stream(self.device)
            for start, end in plan:
                slot, copied = self._ring[self._next]
                self._next = (self._next + 1) % len(self._ring)
                copied.synchronize()
                staged = slot[:end - start]
                staged.copy_(src_bytes[start:end])
                out_bytes[start:end].copy_(staged, non_blocking=True)
                copied.record(stream)
        profiling.count(STAGED_BYTES, nbytes)
        profiling.count(CHUNKS, len(plan))
        return out
