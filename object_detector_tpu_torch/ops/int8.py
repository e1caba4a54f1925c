"""Plain int8 tensor ops of the int8 engine: exact int8 convs, requant,
max pools and the edge pad, on NHWC tensors, on the CPU and on the card.

The port of the XLA side of ``object_detector_tpu/quant/engine.py``
(``_conv`` :477, ``_pool`` :607, the requant of :987, the input quantize of
:912 and the ``PadToEvenOp`` edge pad of :1180). The reference left these to
XLA; here the int8 convs are im2col + ``torch._int_mm`` (int8 x int8 ->
int32, exact on both devices) and everything else is plain PyTorch.

Every requant divides by the scale held as a float32 tensor on the data's
device: ATen's CUDA true-divide turns a CPU-scalar divisor into a multiply
by its reciprocal, which flips codes at rounding boundaries.

The steps run under the spans of `utils.profiling.span`, recorded while a
profiler records: ``odt.int8.im2col`` (pads and the window copy),
``odt.int8.gemm`` (``torch._int_mm``) and ``odt.int8.pool`` (pools and the
edge pad). The requant epilogue is `kernels.requant_epilogue`, under the
engine's ``odt.int8.epilogue``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from object_detector_tpu_torch.models.vgg import same_pads
from object_detector_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
Padding = Union[str, int]

# torch._int_mm on CUDA (cuBLASLt) takes more than 16 rows and inner and
# outer widths that are multiples of 8. On an H100 (torch 2.11, CUDA 12.8)
# it also refused every inner width of 32 with 64 or more columns unless the
# rows were a multiple of 32 (63 of 1602 shapes tried); conv1_1's
# 27 taps are padded to 32. So rows are padded to a multiple of 32 and
# widths to a multiple of 8, with zero codes, which is exact, and the result
# is sliced. The right operand goes in column-major: cuBLASLt then runs its
# int8 tensor-core GEMM ("tn") instead of a WMMA fallback ("nn"), 2.4 to 7.7
# times faster at the trunk's shapes on the same card.
_MM_ROW_MULTIPLE = 32
_MM_MULTIPLE = 8


def scale_tensor(s: float, device: torch.device) -> Tensor:
    """A scale as a 0-dim float32 tensor on ``device`` (float32(s))."""
    return torch.full((), s, dtype=torch.float32, device=device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gemm_operand(w: Tensor) -> Tensor:
    """An HWIO int8 kernel as `int_matmul`'s right operand: (K, N), K =
    kh * kw * cin in the kernel's row order. On the card both widths are
    padded to a multiple of 8 with zero codes and the operand is
    column-major. A caller that reuses a kernel lays it out once."""
    kh, kw, cin, cout = w.shape
    b = w.reshape(kh * kw * cin, cout)
    if b.device.type != "cuda":
        return b
    k, n = b.shape
    pad = (0, _round_up(k, _MM_MULTIPLE) - k, 0, _round_up(n, _MM_MULTIPLE) - n)
    return F.pad(b.t(), pad).contiguous().t()


def int_matmul(a: Tensor, b: Tensor, n: int) -> Tensor:
    """(M, K) int8 @ `gemm_operand` ``b`` -> (M, n) int32, exact; ``n`` is
    the kernel's output width (``b`` may be wider on the card)."""
    if a.device.type != "cuda":
        with span("odt.int8.gemm"):
            return torch._int_mm(a, b)
    m, k = a.shape
    mp, kp = _round_up(m, _MM_ROW_MULTIPLE), b.shape[0]
    if (mp, kp) != (m, k):
        with span("odt.int8.im2col"):
            a = F.pad(a, (0, kp - k, 0, mp - m))
    with span("odt.int8.gemm"):
        out = torch._int_mm(a, b)
        return out[:m, :n] if (mp, b.shape[1]) != (m, n) else out


def conv_pads(size: int, kernel: int, stride: int, dilation: int,
              padding: Padding) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis, flax's rule for SAME."""
    if padding == "SAME":
        return same_pads(size, kernel, stride, dilation)
    if padding == "VALID":
        return 0, 0
    if isinstance(padding, int):
        return padding, padding
    raise ValueError(f"padding must be SAME, VALID or an int, got {padding!r}")


def conv_int8(
    x: Tensor,  # (B, H, W, Cin) int8
    w: Tensor,  # (kh, kw, Cin, Cout) int8, HWIO
    stride: int = 1,
    padding: Padding = "SAME",
    dilation: int = 1,
    operand: Optional[Tensor] = None,  # gemm_operand(w), if laid out already
) -> Tensor:
    """Int8 conv with int32 accumulation, flax/XLA padding (zero codes):
    (B, Ho, Wo, Cout) int32, equal to ``lax.conv_general_dilated`` with
    ``preferred_element_type=int32``."""
    b, h, w_in, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin or x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"conv_int8: x {x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}")
    ph = conv_pads(h, kh, stride, dilation, padding)
    pw = conv_pads(w_in, kw, stride, dilation, padding)
    ho = (h + ph[0] + ph[1] - dilation * (kh - 1) - 1) // stride + 1
    wo = (w_in + pw[0] + pw[1] - dilation * (kw - 1) - 1) // stride + 1
    with span("odt.int8.im2col"):
        if ph != (0, 0) or pw != (0, 0):
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        if kh == kw == 1 and stride == 1:
            patches = x.reshape(b * ho * wo, cin)
        else:
            # (B, Ho, Wo, kh, kw, Cin) window view, copied once into (M, K)
            # in the (ky, kx, cin) order of the HWIO kernel's rows. The copy
            # moves each pixel's codes as the widest words that divide Cin.
            word = next(dt for dt in (torch.int64, torch.int32, torch.int8)
                        if cin % dt.itemsize == 0)
            xw = x.contiguous().view(word)
            sb, sh, sw, sc = xw.stride()
            windows = xw.as_strided(
                (b, ho, wo, kh, kw, xw.shape[-1]),
                (sb, sh * stride, sw * stride, sh * dilation, sw * dilation, sc),
            )
            patches = windows.reshape(b * ho * wo, -1).view(torch.int8)
    acc = int_matmul(patches, gemm_operand(w) if operand is None else operand, cout)
    return acc.reshape(b, ho, wo, cout)


def quantize(y: Tensor, scale: Tensor, low: float = -127.0) -> Tensor:
    """clip(round(y / scale), low, 127) as int8; round half to even. ``y``
    is float32 and may be overwritten."""
    return y.div_(scale).round_().clamp_(low, 127.0).to(torch.int8)


def dequant(
    acc: Tensor,  # int32 accumulator
    deq: Tensor,  # (Cout,) float32
    bias: Tensor,  # (Cout,) float32
    resid: Optional[Tensor] = None,  # int8 residual codes, acc's shape
    resid_scale: Optional[Tensor] = None,  # 0-dim float32, their scale
) -> Tensor:
    """``acc.f32 * deq + bias`` [``+ resid.f32 * resid_scale``] in float32,
    each operation rounded (the residual product before it is added): the
    arithmetic of every requant before its quantize. A ReLU is the
    quantize's lower bound 0: dividing by a positive scale and rounding keep
    the sign, so clipping the code at 0 equals clipping y at 0 first."""
    y = torch.mul(acc, deq).add_(bias)  # acc -> float32 rounds to nearest, as astype does
    if resid is not None:
        y.add_(resid.to(torch.float32).mul_(resid_scale))
    return y


def max_pool(
    x: Tensor,  # (B, H, W, C), int8 or float
    size: int,
    stride: int,
    pad_same: bool = False,
    explicit_pad: Optional[int] = None,
) -> Tensor:
    """``lax.reduce_window(max)`` over H and W with VALID or SAME padding, or
    ``explicit_pad`` on every side (the ResNet stem's pool). Pads with the
    dtype's minimum (-inf for floats), the reference's init value."""
    _, h, w, _ = x.shape
    if explicit_pad is not None:
        ph = pw = (explicit_pad, explicit_pad)
    elif pad_same:
        ph, pw = same_pads(h, size, stride, 1), same_pads(w, size, stride, 1)
    else:
        ph = pw = (0, 0)
    ho = (h + ph[0] + ph[1] - size) // stride + 1
    wo = (w + pw[0] + pw[1] - size) // stride + 1
    with span("odt.int8.pool"):
        if ph != (0, 0) or pw != (0, 0):
            low = torch.iinfo(x.dtype).min if not x.dtype.is_floating_point else float("-inf")
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=low)
        out = None
        for dy in range(size):
            for dx in range(size):
                win = x[:, dy : dy + (ho - 1) * stride + 1 : stride,
                        dx : dx + (wo - 1) * stride + 1 : stride, :]
                out = win if out is None else torch.maximum(out, win)
        return out.contiguous()


def pad_to_even(x: Tensor) -> Tensor:
    """Replicate the last row / column where H / W is odd (75 -> 76)."""
    with span("odt.int8.pool"):
        if x.shape[1] % 2:
            x = torch.cat([x, x[:, -1:]], dim=1)
        if x.shape[2] % 2:
            x = torch.cat([x, x[:, :, -1:]], dim=2)
        return x
