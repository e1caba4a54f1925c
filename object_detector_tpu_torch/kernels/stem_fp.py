"""All of VGG block 1 in int8: conv1_1 + requant + conv1_2 + requant + 2x2/s2
max pool, from the input codes to the pooled codes, as one hand-written CUDA
kernel (``csrc/stem_fp.cu``) whose two convs run on the int8 tensor cores.

The port of ``object_detector_tpu/kernels/stem_pallas.py``'s
``_stem_fp_kernel`` (launched by ``stem_fused_producer``). The TPU kernel
reads a 128-lane tap stack of the input (``build_stem_x6``), odd-pair-packed
weights, a column-halo mask and a batch-in-sublanes layout; those serve the
TPU's tiles and are not ported. The contract is the function, on NHWC codes,
with ``rq(v, s) = clip(round_half_even(v / s), -127, 127)`` and ``/`` a true
division:

    stem_fused_producer(x_q, w1, deq1, bias1, s1, w2, deq2, bias2, s2)
      x_q   (B, H, W, 3) int8 input codes, H and W even
      w1    (3, 3, 3, 64) int8 HWIO conv1_1 kernel
      deq1  (64,) float32, float32(input scale) * conv1_1's weight scale
      w2    (3, 3, 64, 64) int8 HWIO conv1_2 kernel
      deq2  (64,) float32, float32(s1) * conv1_2's weight scale
      bias1, bias2  (64,) float32; s1, s2 the two activation scales
    -> (B, H/2, W/2, 64) int8:
      q1  = rq(max(conv3x3_same(x_q, w1).f32 * deq1 + bias1, 0), s1)
      out = maxpool2x2(rq(max(conv3x3_same(q1, w2).f32 * deq2 + bias2, 0), s2))
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from object_detector_tpu_torch.kernels import build, int8_pack, stem
from object_detector_tpu_torch.kernels.requant_epilogue import epilogue_reference
from object_detector_tpu_torch.ops import int8 as int8_ops
from object_detector_tpu_torch.utils.profiling import spanned

Tensor = torch.Tensor

CHANNELS = 64


def stem_fused_producer_reference(
    x_q: Tensor, w1: Tensor, deq1: Tensor, bias1: Tensor, s1: float,
    w2: Tensor, deq2: Tensor, bias2: Tensor, s2: float,
    packed: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """Plain PyTorch version, the engine's unfused route on either device:
    conv1_1 through the int8 conv and the requant epilogue's plain version,
    then `stem.stem_conv12_pool_reference`. ``packed`` is the wrapper's
    argument, unused here."""
    del packed
    acc = int8_ops.conv_int8(x_q, w1, 1, "SAME", 1)
    q1 = epilogue_reference(acc, deq1, bias1, float(s1), relu=True).codes
    return stem.stem_conv12_pool_reference(q1, w2, deq2, bias2, s2)


def pack_weights(w1: Tensor, w2: Tensor) -> Tuple[Tensor, Tensor]:
    """The kernel's B operands in the packed layout of
    `int8_pack.pack_b_operand`: w1 (3, 3, 3, 64) as the (32, 64) matrix of
    row k = 3 * tap + cin for k < 27 and zero rows 27..31 (the kernel's
    im2col row of a pixel is its 27 input codes and 5 zero bytes); w2 (3, 3,
    64, 64) as B2's operand, `stem.pack_weights`: both kernels run the same
    conv1_2 stage."""
    w1_kn = torch.nn.functional.pad(w1.reshape(27, CHANNELS), (0, 0, 0, 5))
    return int8_pack.pack_b_operand(w1_kn), stem.pack_weights(w2)


def _check(x_q: Tensor, w1: Tensor, deq1: Tensor, bias1: Tensor,
           w2: Tensor, deq2: Tensor, bias2: Tensor) -> None:
    if x_q.dim() != 4 or x_q.shape[-1] != 3 or x_q.shape[1] % 2 or x_q.shape[2] % 2:
        raise ValueError(f"x_q must be (B, H, W, 3) with H, W even, got {tuple(x_q.shape)}")
    if tuple(w1.shape) != (3, 3, 3, CHANNELS):
        raise ValueError(f"w1 must be (3, 3, 3, {CHANNELS}), got {tuple(w1.shape)}")
    if tuple(w2.shape) != (3, 3, CHANNELS, CHANNELS):
        raise ValueError(f"w2 must be (3, 3, {CHANNELS}, {CHANNELS}), got {tuple(w2.shape)}")
    vectors = (deq1, bias1, deq2, bias2)
    if any(tuple(v.shape) != (CHANNELS,) for v in vectors):
        raise ValueError(f"deq1, bias1, deq2 and bias2 must be ({CHANNELS},), got "
                         f"{[tuple(v.shape) for v in vectors]}")
    if x_q.dtype != torch.int8 or w1.dtype != torch.int8 or w2.dtype != torch.int8:
        raise TypeError(f"x_q, w1 and w2 must be int8, got {x_q.dtype}, {w1.dtype}, {w2.dtype}")
    if any(v.dtype != torch.float32 for v in vectors):
        raise TypeError(f"deq1, bias1, deq2 and bias2 must be float32, got "
                        f"{[v.dtype for v in vectors]}")
    for t in (w1, w2, *vectors):
        if t.device != x_q.device:
            raise ValueError(f"all operands must be on {x_q.device}, got one on {t.device}")


@spanned("odt.kernel.stem_fp")
def stem_fused_producer(
    x_q: Tensor, w1: Tensor, deq1: Tensor, bias1: Tensor, s1: float,
    w2: Tensor, deq2: Tensor, bias2: Tensor, s2: float,
    packed: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """Launches the CUDA kernel for CUDA tensors and runs
    `stem_fused_producer_reference` for CPU tensors. ``packed`` is
    ``pack_weights(w1, w2)`` where the caller keeps it (it is made here
    otherwise). ``stem_fused_producer.launches`` counts kernel launches."""
    _check(x_q, w1, deq1, bias1, w2, deq2, bias2)
    if build.runs_plain("stem_fused_producer", x_q.device):
        return stem_fused_producer_reference(x_q, w1, deq1, bias1, s1, w2, deq2, bias2, s2)
    if not all(t.is_contiguous() for t in (x_q, deq1, bias1, deq2, bias2)):
        raise ValueError("stem_fused_producer takes contiguous x_q, deq1, bias1, deq2 and bias2")
    w1_packed, w2_packed = pack_weights(w1, w2) if packed is None else packed
    b, h, w, _ = x_q.shape
    out = torch.empty((b, h // 2, w // 2, CHANNELS), dtype=torch.int8, device=x_q.device)
    if out.numel() == 0:
        return out
    build.launch(
        "stem_fused_producer", x_q.device,
        x_q.data_ptr(), w1_packed.data_ptr(), w2_packed.data_ptr(), deq1.data_ptr(),
        bias1.data_ptr(), float(s1), deq2.data_ptr(), bias2.data_ptr(), float(s2),
        b, h, w, out.data_ptr(),
    )
    stem_fused_producer.launches += 1
    return out


stem_fused_producer.launches = 0
