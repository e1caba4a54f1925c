"""The sampling core of multi-scale deformable attention, in % of its
bound: the least time of the traced calls' sampling (`deformable_counts.
sampling_least_s` of each image served, at the program's mean unmasked
token count) over the device time of the kernels under
``odt.deformable.sampling``, the least time scaled by the share of those
ranges whose kernels the trace holds. Each launch's bound is the larger of
its float32 operations (2 a corner and channel) at the card's non-FMA
float32 rate and its rows' reference points, offsets, logits and output
read or written once at the HBM rate (the values' rows it must read depend
on the offsets and are not counted). The work is counted on the rows an
image needs (its unmasked tokens, the decoder's queries), which are at most
those the kernel runs, and the mean's rows are the images' own, so the
share cannot pass 100%. The program's
``odt.deformable.sampled_points`` has to be the shapes' count of every row
it was given, or the reader gives nothing."""

from port_bench import deformable_counts as dc
from port_bench.metrics._program import held_share


def read(r):
    tokens = dc.traced_tokens_an_image(r)
    if r.trace is None or tokens is None or not r.trace.span_count(dc.SAMPLING) \
            or not dc.points_agree(r):
        return None
    us = sum(d for _, d in r.trace.kernels(dc.SAMPLING))
    if us <= 0:
        return None
    images = r.trace.span_count(dc.PREDICT) * r.host["batch"]
    least_us = images * dc.sampling_least_s(r.arch, tokens) * held_share(r, dc.SAMPLING) * 1e6
    return 100.0 * least_us / us
