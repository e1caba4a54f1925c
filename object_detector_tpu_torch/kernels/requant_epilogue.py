"""The int8 engine's epilogue, from a GEMM's int32 accumulator to the next
layer's codes, a float32 sum or the logits, as one pass: a hand-written CUDA
kernel (``csrc/requant_epilogue.cu``) on the card, its plain PyTorch version
on the CPU.

It replaces no Pallas kernel: the reference left this arithmetic to XLA.
The port ran it as five to eight eager float32 passes, 54 to 65% of the int8
forward's device time at bs=64 (SSD-300, RetinaNet); the kernel reads each
accumulator once and writes each output once. The contract, on NHWC tensors:

    epilogue(acc, deq, bias, out_scale=None, relu=False, resid=None,
             resid_scale=None, addend=None, sum_dtype=None, relu_codes=False)
      acc    (..., C) int32; its rows of C may lie at any stride (the sliced
             result of `ops.int8.int_matmul`)
      deq, bias  (C,) float32, the dequant vector and the bias
      resid, resid_scale  int8 codes of acc's shape and their scale
      addend (B, H / 2, W / 2, C) float32 of a (B, H, W, C) acc, added as
             its nearest-neighbour 2x upsample (the FPN's top-down path)
    -> Epilogue(codes, sum, relu_codes) of acc's shape, each None unless
       asked for:
      codes  clip(round(y / out_scale), 0 if relu else -127, 127) int8
      sum    y in ``sum_dtype`` (float32, or bfloat16 logits)
      relu_codes  max(codes, 0) (``relu_codes=True``; P6's codes as P7's
             input)
    with y = acc * deq + bias [+ resid * resid_scale] [+ upsampled addend],
    each operation rounded to float32 as the engine's op-by-op form does:
    the residual's product before the add, a true divide, round half to even.

Scales are Python floats, rounded to float32 on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.ops import int8 as int8_ops

Tensor = torch.Tensor

_SUM_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2}


class Epilogue(NamedTuple):
    codes: Optional[Tensor]
    sum: Optional[Tensor]
    relu_codes: Optional[Tensor]


def fpn_upsample2x(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x upsample of an NHWC tensor (broadcast, reshape)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def epilogue_reference(
    acc: Tensor, deq: Tensor, bias: Tensor, out_scale: Optional[float] = None,
    relu: bool = False, resid: Optional[Tensor] = None, resid_scale: Optional[float] = None,
    addend: Optional[Tensor] = None, sum_dtype: Optional[torch.dtype] = None,
    relu_codes: bool = False,
) -> Epilogue:
    """Plain PyTorch version: the engine's eager chain, on either device."""
    y = int8_ops.dequant(acc, deq, bias, resid, None if resid is None
                         else int8_ops.scale_tensor(resid_scale, acc.device))
    if addend is not None:
        y = y + fpn_upsample2x(addend)
    total = None if sum_dtype is None else y.to(sum_dtype, copy=True)
    codes = relu_q = None
    if out_scale is not None:
        codes = int8_ops.quantize(y, int8_ops.scale_tensor(out_scale, y.device),
                                  0.0 if relu else -127.0)
        if relu_codes:
            relu_q = torch.clamp_min(codes, 0)
    return Epilogue(codes, total, relu_q)


def _check(acc, deq, bias, out_scale, resid, resid_scale, addend, sum_dtype, relu_codes) -> None:
    if acc.dtype != torch.int32 or acc.dim() < 1:
        raise TypeError(f"acc must be int32 with channels last, got {acc.dtype} {tuple(acc.shape)}")
    c = acc.shape[-1]
    for name, v in (("deq", deq), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be ({c},) float32, got {v.dtype} {tuple(v.shape)}")
    if out_scale is None and sum_dtype is None:
        raise ValueError("epilogue: ask for the codes (out_scale), the sum (sum_dtype) or both")
    if sum_dtype not in _SUM_KINDS:
        raise ValueError(f"sum_dtype must be None, float32 or bfloat16, got {sum_dtype}")
    if relu_codes and out_scale is None:
        raise ValueError("relu_codes needs out_scale")
    if (resid is None) != (resid_scale is None):
        raise ValueError("resid and resid_scale go together")
    if resid is not None and (resid.dtype != torch.int8 or resid.shape != acc.shape):
        raise ValueError(f"resid must be int8 of acc's shape {tuple(acc.shape)}, "
                         f"got {resid.dtype} {tuple(resid.shape)}")
    if addend is not None:
        want = (acc.shape[0], acc.shape[1] // 2, acc.shape[2] // 2, c) if acc.dim() == 4 else None
        if (addend.dtype != torch.float32 or want is None or acc.shape[1] % 2
                or acc.shape[2] % 2 or tuple(addend.shape) != want):
            raise ValueError(f"addend must be float32 (B, H / 2, W / 2, C) of a (B, H, W, C) "
                             f"acc with even H, W; got {addend.dtype} {tuple(addend.shape)} "
                             f"for acc {tuple(acc.shape)}")
    others = [t for t in (deq, bias, resid, addend) if t is not None]
    if any(t.device != acc.device for t in others):
        raise ValueError(f"acc on {acc.device}, its operands on {[str(t.device) for t in others]}")


def epilogue(
    acc: Tensor, deq: Tensor, bias: Tensor, out_scale: Optional[float] = None,
    relu: bool = False, resid: Optional[Tensor] = None, resid_scale: Optional[float] = None,
    addend: Optional[Tensor] = None, sum_dtype: Optional[torch.dtype] = None,
    relu_codes: bool = False,
) -> Epilogue:
    """Launches the CUDA kernel for CUDA tensors and runs `epilogue_reference`
    for CPU tensors. ``epilogue.launches`` counts kernel launches."""
    _check(acc, deq, bias, out_scale, resid, resid_scale, addend, sum_dtype, relu_codes)
    if build.runs_plain("epilogue", acc.device):
        return epilogue_reference(acc, deq, bias, out_scale, relu, resid, resid_scale, addend,
                                  sum_dtype, relu_codes)
    c = acc.shape[-1]
    try:
        rows2d = acc.view(-1, c)  # the rows at one stride, without a copy
    except RuntimeError:
        rows2d = None
    if rows2d is None or rows2d.stride(-1) != 1 or not all(
            t.is_contiguous() for t in (deq, bias, resid, addend) if t is not None):
        raise ValueError("epilogue takes acc's rows at one stride with unit channel stride, "
                         "and contiguous deq, bias, resid and addend")
    rows = rows2d.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"epilogue takes fewer than 2^31 rows, got {rows}")
    codes = torch.empty(acc.shape, dtype=torch.int8, device=acc.device) \
        if out_scale is not None else None
    relu_q = torch.empty_like(codes) if relu_codes else None
    total = torch.empty(acc.shape, dtype=sum_dtype, device=acc.device) \
        if sum_dtype is not None else None
    if rows == 0 or c == 0:
        return Epilogue(codes, total, relu_q)
    h, w = (acc.shape[1], acc.shape[2]) if addend is not None else (0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    build.launch(
        "requant_epilogue", acc.device,
        rows2d.data_ptr(), rows2d.stride(0), rows, c, deq.data_ptr(), bias.data_ptr(),
        ptr(resid), 0.0 if resid_scale is None else float(resid_scale), ptr(addend), h, w,
        1.0 if out_scale is None else float(out_scale), int(relu), ptr(codes), ptr(relu_q),
        ptr(total), _SUM_KINDS[sum_dtype],
    )
    epilogue.launches += 1
    return Epilogue(codes, total, relu_q)


epilogue.launches = 0
