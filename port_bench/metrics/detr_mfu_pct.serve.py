"""DETR's forward as a share of the card's peaks over the untraced part of
the window, in %: the least time of the images served there (the int8
trunk's operations on the whole canvas at the int8 peak, plus the
transformer's bfloat16 FLOPs on an image's unmasked tokens at the bf16
peak, `detr_counts`, at the traced calls' mean token count) over its
seconds."""

from port_bench import counts, detr_counts


def read(r):
    tokens = detr_counts.traced_tokens_an_image(r)
    images, seconds = r.host.get("images_untraced"), r.host.get("seconds_untraced")
    if tokens is None or not images or not seconds:
        return None
    least_s = images * (detr_counts.trunk_int8_ops(r.arch) / counts.INT8_OPS_PER_S
                        + detr_counts.transformer_flops(r.arch, tokens) / counts.BF16_FLOPS_PER_S)
    return 100.0 * least_s / seconds
