"""The int8 engine's 3x3 stride-1 conv with its requant epilogue as one pass:
a hand-written Hopper implicit-GEMM kernel (``csrc/conv3x3.cu``: TMA in
im2col mode, wgmma, the epilogue on the accumulators in registers) on the
card, its plain PyTorch version on the CPU.

It replaces no Pallas kernel: the reference left the conv to XLA. The port
ran such a step as an im2col copy, cuBLASLt's int8 GEMM into an int32
accumulator and the one-pass epilogue of `kernels.requant_epilogue`; the
kernel reads the codes in place and writes only the step's output. The
contract, on NHWC tensors:

    conv3x3(x, w, deq, bias, padding="SAME", dilation=1, out_scale=None,
            relu=False, sum_dtype=None, operand=None)
      x      (B, H, W, Cin) int8 codes, contiguous; Cin a multiple of
             `CIN_MULTIPLE`
      w      (3, 3, Cin, Cout) int8, HWIO; ``operand`` its `gemm_operand`,
             if laid out already
      deq, bias  (Cout,) float32, the dequant vector and the bias
      padding    "SAME", "VALID" or an int on every side
    -> Epilogue(codes, sum, None) of shape (B, Ho, Wo, Cout), the codes
       (``out_scale`` given) or the sum (``sum_dtype`` given), equal bit
       for bit to
       ``epilogue(conv_int8(x, w, 1, padding, dilation), deq, bias,
       out_scale, relu, sum_dtype=sum_dtype)``.

Scales are Python floats, rounded to float32 on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from object_detector_tpu_torch.kernels import build
from object_detector_tpu_torch.kernels.requant_epilogue import (
    _SUM_KINDS, Epilogue, epilogue_reference,
)
from object_detector_tpu_torch.ops import int8 as int8_ops

Tensor = torch.Tensor
Padding = int8_ops.Padding

# A K-slice of the kernel's pipeline is 32, 64 or 128 bytes of one tap's
# channels (one wgmma k-step is 32).
CIN_MULTIPLE = 32


def conv3x3_reference(
    x: Tensor, w: Tensor, deq: Tensor, bias: Tensor, padding: Padding = "SAME",
    dilation: int = 1, out_scale: Optional[float] = None, relu: bool = False,
    sum_dtype: Optional[torch.dtype] = None, operand: Optional[Tensor] = None,
) -> Epilogue:
    """Plain version: the engine's int8 conv, then the epilogue's plain
    version, on either device."""
    acc = int8_ops.conv_int8(x, w, 1, padding, dilation, operand=operand)
    return epilogue_reference(acc, deq, bias, out_scale, relu, sum_dtype=sum_dtype)


def _pad(padding: Padding, dilation: int) -> int:
    """The zero rows and columns on every side of a 3x3 stride-1 conv."""
    if padding == "SAME":
        return dilation  # flax's SAME splits 2 * dilation evenly at stride 1
    if padding == "VALID":
        return 0
    if isinstance(padding, int) and padding >= 0:
        return padding
    raise ValueError(f"padding must be SAME, VALID or an int >= 0, got {padding!r}")


def _check(x, w, deq, bias, padding, dilation, out_scale, sum_dtype) -> None:
    if x.dtype != torch.int8 or x.dim() != 4 or w.dtype != torch.int8 or w.dim() != 4:
        raise TypeError(f"conv3x3 takes int8 NHWC codes and an int8 HWIO kernel, got "
                        f"{x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cin != x.shape[-1] or cin % CIN_MULTIPLE:
        raise ValueError(f"conv3x3 takes a 3x3 kernel over the codes' {x.shape[-1]} channels, "
                         f"a multiple of {CIN_MULTIPLE}; got {tuple(w.shape)}")
    for name, v in (("deq", deq), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},) float32, got {v.dtype} {tuple(v.shape)}")
    if (out_scale is None) == (sum_dtype is None):
        raise ValueError("conv3x3: ask for either the codes (out_scale) or the sum (sum_dtype)")
    if sum_dtype not in _SUM_KINDS:
        raise ValueError(f"sum_dtype must be None, float32 or bfloat16, got {sum_dtype}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"dilation must be an int >= 1, got {dilation!r}")
    pad = _pad(padding, dilation)
    if any(size + 2 * pad - 2 * dilation < 1 for size in x.shape[1:3]):
        raise ValueError(f"conv3x3: no output for a {tuple(x.shape[1:3])} map at padding "
                         f"{padding!r} and dilation {dilation}")
    others = [w, deq, bias]
    if any(t.device != x.device for t in others):
        raise ValueError(f"x on {x.device}, its operands on {[str(t.device) for t in others]}")


def conv3x3(
    x: Tensor, w: Tensor, deq: Tensor, bias: Tensor, padding: Padding = "SAME",
    dilation: int = 1, out_scale: Optional[float] = None, relu: bool = False,
    sum_dtype: Optional[torch.dtype] = None, operand: Optional[Tensor] = None,
) -> Epilogue:
    """Launches the CUDA kernel for CUDA tensors and runs `conv3x3_reference`
    for CPU tensors. ``conv3x3.launches`` counts kernel launches."""
    _check(x, w, deq, bias, padding, dilation, out_scale, sum_dtype)
    if build.runs_plain("conv3x3", x.device):
        return conv3x3_reference(x, w, deq, bias, padding, dilation, out_scale, relu, sum_dtype,
                                 operand)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    pad = _pad(padding, dilation)
    if operand is None:
        operand = int8_ops.gemm_operand(w)
    # `gemm_operand` on the card: (K, N) column-major, so each output
    # channel's 9 * Cin taps are one row of its storage.
    if (operand.shape[0] != 9 * cin or operand.stride(0) != 1 or operand.stride(1) % 16
            or operand.device != x.device):
        raise ValueError(f"operand must be gemm_operand(w) on the card, got "
                         f"{tuple(operand.shape)} at strides {operand.stride()}")
    if (not x.is_contiguous() or x.data_ptr() % 16 or operand.data_ptr() % 16
            or not deq.is_contiguous() or not bias.is_contiguous()):
        raise ValueError("conv3x3 takes contiguous codes and vectors, and 16-byte aligned codes "
                         "and operand")
    ho, wo = h + 2 * pad - 2 * dilation, wd + 2 * pad - 2 * dilation
    if b * ho * wo >= 2 ** 31:
        raise ValueError(f"conv3x3 takes fewer than 2^31 output pixels, got {b * ho * wo}")
    codes = out_scale is not None
    out = torch.empty((b, ho, wo, cout), dtype=torch.int8 if codes else sum_dtype,
                      device=x.device)
    if b > 0:
        build.launch(
            "conv3x3_requant", x.device,
            x.data_ptr(), b, h, wd, cin, operand.data_ptr(), operand.stride(1), cout, pad,
            dilation, deq.data_ptr(), bias.data_ptr(), float(out_scale) if codes else 1.0,
            int(relu), out.data_ptr() if codes else None, None if codes else out.data_ptr(),
            _SUM_KINDS[sum_dtype],
        )
        conv3x3.launches += 1
    return Epilogue(out, None, None) if codes else Epilogue(None, out, None)


conv3x3.launches = 0
