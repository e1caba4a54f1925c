"""Builds the port's CUDA sources into shared libraries and loads them.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``object_detector_tpu_torch/build/`` at first use, exposes a plain C
interface, and is loaded with ``ctypes``. Nothing here runs at import time:
the CPU tests import every module on hosts without ``nvcc``.

It is also the one launch path of the kernel wrappers (``kernels/*.py``):
`runs_plain` sends CPU tensors to a wrapper's plain version and refuses any
device but CUDA, and `launch` calls an entry point of `ENTRY_POINTS` on the
current stream and raises on its CUDA error.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"

# Kernel name -> source file under csrc/.
SOURCES = {
    "nms": "nms.cu", "stem": "stem.cu", "l2norm": "l2norm.cu", "pool_bwd": "pool_bwd.cu",
    "resnet_stem": "resnet_stem.cu", "bottleneck": "bottleneck.cu", "stem_fp": "stem_fp.cu",
    "requant_epilogue": "requant_epilogue.cu", "detr_attention": "detr_attention.cu",
    "conv3x3": "conv3x3.cu", "msda": "msda.cu",
}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Entry point -> (kernel name, argument types). Every entry point returns an
# int: a launch's CUDA error (0 for none), or a constant of the build. A
# launch's last argument is the stream.
ENTRY_POINTS = {
    "nms_rows": ("nms", [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P]),
    "nms_rows_bf16": ("nms", [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P]),
    "nms_rows_warp_max_k": ("nms", []),
    "stem_conv12_pool": ("stem", [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P]),
    "l2norm_requant": ("l2norm", [_P, _P, _F, _LL, _I, _P, _P]),
    "pool_bwd": ("pool_bwd", [_P, _P, _P, _LL, _I, _I, _I, _P]),
    "resnet_stem": ("resnet_stem", [_P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P]),
    "resnet_stem_smem_bytes": ("resnet_stem", []),
    "fused_bottleneck": ("bottleneck", [_P] * 10 + [_F] * 4 + [_I] * 5 + [_P, _P]),
    "stem_fused_producer": ("stem_fp",
                            [_P, _P, _P, _P, _P, _F, _P, _P, _F, _I, _I, _I, _P, _P]),
    "requant_epilogue": ("requant_epilogue", [_P, _LL, _I, _I, _P, _P, _P, _F, _P, _I, _I, _F,
                                              _I, _P, _P, _P, _I, _P]),
    "detr_attention": ("detr_attention", [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL,
                                          _P, _I, _I, _I, _I, _F, _P]),
    "conv3x3_requant": ("conv3x3", [_P, _I, _I, _I, _I, _P, _LL, _I, _I, _I, _P, _P, _F, _I, _P,
                                    _P, _I, _P]),
    "msda": ("msda", [_P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P] + [_I] * 12 + [_P]),
}

# -fmad=false: no contraction of a * b + c into an FMA, so the kernels round
# after every operation as their plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME, else nvcc on PATH

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: put nvcc on PATH or set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _included(src: Path, seen: List[Path]) -> List[Path]:
    """``src`` and every header under ``CSRC_DIR`` it includes with quotes,
    directly or through another such header, each once, in include order."""
    if src in seen:
        return seen
    seen.append(src)
    for name in _INCLUDE.findall(src.read_bytes()):
        header = CSRC_DIR / name.decode()
        if header.is_file():
            _included(header, seen)
    return seen


def library_path(name: str) -> Path:
    """Output path keyed by the source, the headers it includes from csrc/
    and the flags, so an edit to any of them rebuilds."""
    digest = hashlib.sha256()
    for path in _included(CSRC_DIR / SOURCES[name], []):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) with ``nvcc``, one process
    per source, all started together. Returns each new build's compiler
    output (the ``-Xptxas -v`` register and shared-memory report); sources
    already built are skipped. Processes that build at once (the ranks of a
    data-parallel run) take turns on a lock file, so each source is
    compiled once."""
    names = list(SOURCES) if names is None else list(names)
    if all(library_path(name).exists() for name in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        # flock is released when the file closes or the process ends.
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(names)


def _build(names: List[str]) -> Dict[str, str]:
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed, its entry points'
    signatures set."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for entry_name, (kernel, argtypes) in ENTRY_POINTS.items():
            if kernel == name:
                fn = getattr(lib, entry_name)  # the CDLL keeps this object
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(name: str) -> Any:
    """The entry point ``name`` of `ENTRY_POINTS`, its library loaded."""
    return getattr(load(ENTRY_POINTS[name][0]), name)


def runs_plain(wrapper: str, device: torch.device) -> bool:
    """Whether the kernel wrapper ``wrapper`` runs its plain version: True on
    the CPU, False on CUDA. Any other device is refused."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{wrapper} runs on cuda or cpu tensors, got {device}")
    return False


def launch(name: str, device: torch.device, *args: Any) -> None:
    """Calls the entry point ``name`` with ``args`` and the current stream of
    the CUDA ``device``, under its device guard. The stream is fetched as a
    raw handle, without building a ``torch.cuda.Stream`` object (7 us of a
    40 us call on an H100's host)."""
    fn = entry(name)
    with torch.cuda.device(device):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
