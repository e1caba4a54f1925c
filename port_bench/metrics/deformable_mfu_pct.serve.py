"""Deformable DETR's forward as a share of the card's peaks over the
untraced part of the window, in %: the least time of the images served
there (`deformable_counts.least_s`: the int8 trunk's operations at the int8
peak, the levels' and the transformer's bfloat16 FLOPs at the bf16 peak,
the sampling's float32 operations at the non-FMA float32 rate, at the traced
calls' mean unmasked token count) over its seconds."""

from port_bench import deformable_counts as dc


def read(r):
    tokens = dc.traced_tokens_an_image(r)
    images, seconds = r.host.get("images_untraced"), r.host.get("seconds_untraced")
    if tokens is None or not images or not seconds:
        return None
    return 100.0 * images * dc.least_s(r.arch, tokens) / seconds
