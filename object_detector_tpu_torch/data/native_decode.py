"""The native JPEG decode pool (``native/jpeg_decoder.cpp``) through ``ctypes``.

The port's own copy of ``object_detector_tpu/data/native_decode.py``. The
pool decodes a batch of JPEG files on its own threads, without the GIL:
libjpeg's DCT scaling to at least the target size, then an area resize.
`DecodedCache` fills itself through it and hands the files it rejects
(corrupt, CMYK, not a JPEG) to PIL.

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``object_detector_tpu_torch/build/``, under a name
keyed by the source, the flags and the host's CPU (``-march=native``), so
a library built on one machine is never loaded on another. Processes that
build at once take turns on a lock file. ``native/`` is only read. Where
the library cannot be built or loaded, `decode_batch` returns None and
`load_error` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE.parent / "native" / "jpeg_decoder.cpp"
BUILD_DIR = _PACKAGE / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

# The loaded library, or why it could not be had (the first attempt's
# answer holds for the life of the process).
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _host_cpu() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags", b"Features"))]
    return b"\n".join(sorted(set(keep)))


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LD_FLAGS).encode() + b"\0" + _host_cpu())
    return BUILD_DIR / f"libodt_jpeg-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}: {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _error = f"{type(exc).__name__}: {exc}"
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.odt_decode_batch_status.restype = ctypes.c_int
    lib.odt_decode_batch_status.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library could not be built or loaded; None once it loaded."""
    _load()
    return _error


def decode_batch(
    paths: Sequence[str], size: int, num_threads: int = 4
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode and resize JPEG files -> ((N, size, size, 3) uint8, (N,) bool
    ok-mask), or None when the library is unavailable (the caller decodes
    with PIL). A file the decoder rejects is zero-filled with ok False, for
    the caller to decode again with PIL."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    status = np.zeros((n,), np.uint8)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.odt_decode_batch_status(names, n, size, out.ctypes.data_as(u8p),
                                status.ctypes.data_as(u8p), max(1, num_threads))
    return out, status == 0
