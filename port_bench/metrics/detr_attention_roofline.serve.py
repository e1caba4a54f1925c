"""DETR's attention cores, in % of their bound: the bfloat16 FLOPs of QK^T
and PV over the pairs of an unmasked query and an unmasked key (encoder
self-attention, decoder self- and cross-attention; `detr_counts.
attention_flops` of each image the traced calls served, at the program's
mean token count, `detr_counts.traced_tokens_an_image`) at the bf16
tensor-core peak, over the device time of the kernels under
``odt.detr.attention``. The FLOPs are scaled by the share of attention
ranges whose kernels the trace holds. The masked pairs are work an
implementation may skip, and the mean's pairs are at most the images' own,
so the share cannot pass 100%."""

from port_bench import counts, detr_counts
from port_bench.metrics._program import held_share

SPAN = "odt.detr.attention"


def read(r):
    tokens = detr_counts.traced_tokens_an_image(r)
    if r.trace is None or tokens is None or not r.trace.span_count(SPAN):
        return None
    us = sum(d for _, d in r.trace.kernels(SPAN))
    if us <= 0:
        return None
    images = r.trace.span_count(detr_counts.PREDICT) * r.host["batch"]
    flops = images * detr_counts.attention_flops(r.arch, tokens)
    least_us = flops * held_share(r, SPAN) / counts.BF16_FLOPS_PER_S * 1e6
    return 100.0 * least_us / us
