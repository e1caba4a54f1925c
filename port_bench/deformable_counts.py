"""Frozen work counts of Deformable DETR: the trunk's int8 operations on a
canvas, the bfloat16 FLOPs of the levels' projections and of the
transformer, and the sampling core's float32 operations and bytes.

Only the work that no implementation can skip is counted. The trunk and the
levels' projections run over the whole canvas (their convolutions see the
padding, and GroupNorm's statistics take it in). The tokens of the padding
take part in nothing an image's detections depend on, so the transformer
and the encoder's sampling are counted on an image's unmasked tokens alone
(the decoder's on its queries, and its value projection on the unmasked
memory). The unmasked tokens are the program's own count
(`traced_tokens_an_image`), which may be a mean over the images. A product
of an (m, k) and a (k, n) matrix is 2 m k n operations. A bilinear sample is
4 corners, each a product and a sum a channel.
"""

from __future__ import annotations

from port_bench import counts
from port_bench.reference import deformable_detr

PREDICT = "odt.predict"
PREDICT_CALLS = "odt.predict.calls"
VALID_TOKENS = "odt.deformable.valid_tokens"
SAMPLED_POINTS = "odt.deformable.sampled_points"
SAMPLING = "odt.deformable.sampling"
CORNERS = 4
# float32 operations a corner and channel: the product and the sum.
OPS_PER_CORNER_CHANNEL = 2


def _counter(name: str):
    from object_detector_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    return None if counters is None else counters().get(name)


def traced_tokens_an_image(r):
    """Unmasked tokens over the levels an image of the calls a traced run
    made: the program's counters (``odt.deformable.valid_tokens``,
    ``odt.predict.calls``, which add up only while a profiler records) over
    the run's batch. None where the program keeps no such counter."""
    if not r.host.get("batch"):
        return None
    tokens, calls = _counter(VALID_TOKENS), _counter(PREDICT_CALLS)
    if not tokens or not calls:
        return None
    return tokens / (calls * r.host["batch"])


def level_sides(arch):
    """Each level's side on the canvas: C3 at stride 8, each further level
    half the one before, rounding up."""
    sides, s = [], arch["model"]["image_size"]
    for _ in range(3):
        s = -(-s // 2)
    for _ in range(arch["deformable"]["levels"]):
        sides.append(s)
        s = -(-s // 2)
    return sides


def canvas_tokens(arch) -> int:
    return sum(s * s for s in level_sides(arch))


def trunk_int8_ops(arch) -> int:
    """Operations of the int8 trunk on one canvas: 2 a conv multiply-add."""
    return 2 * deformable_detr.macs_per_image(arch)


def levels_flops(arch) -> int:
    """The levels' projections on one whole canvas: the 1x1 convs on C3, C4
    and C5 and the 3x3/s2 conv on C5."""
    d = arch["deformable"]["d_model"]
    widths = deformable_detr.TRUNK_CHANNELS + (9 * deformable_detr.TRUNK_CHANNELS[-1],)
    return sum(2 * d * c * s * s for c, s in zip(widths, level_sides(arch)))


def _heads_levels(arch):
    c = arch["deformable"]
    return c["heads"] * c["levels"]


def transformer_flops(arch, n: float) -> float:
    """bfloat16 FLOPs of one image with ``n`` unmasked tokens: every encoder
    product on the tokens (value, offset, attention-weight and output
    projections, the FFN), every decoder product on the queries (the
    self-attention and its four projections, the offsets, weights and
    output projection, the FFN) and its value projection on the tokens."""
    c = arch["deformable"]
    d, f, q = c["d_model"], c["ffn"], c["queries"]
    hl = _heads_levels(arch)
    encoder = c["enc_layers"] * n * 2 * (2 * d * d + d * hl * c["enc_points"] * 3 + 2 * d * f)
    decoder = c["dec_layers"] * (2 * 4 * d * d * q + 4 * d * q * q
                                 + 2 * q * (d * hl * c["dec_points"] * 3 + d * d + 2 * d * f)
                                 + 2 * d * d * n)
    return encoder + decoder


def _sampling(arch, rows: float, points: int):
    """(float32 operations, least bytes) of one sampling call over ``rows``
    query rows: each row's reference points, offsets and logits read once,
    its output written once. The values are gathered where the offsets
    point, so how many of their rows a call must read depends on the data (a
    decoder call touches a fraction of the map: on the card it ran in less
    than the time of reading the whole unmasked map once); they are left
    out."""
    c = arch["deformable"]
    d, levels = c["d_model"], c["levels"]
    n_points = _heads_levels(arch) * points
    ops = rows * n_points * CORNERS * (d // c["heads"]) * OPS_PER_CORNER_CHANNEL
    row_bytes = 4 * levels * 2 + 4 * n_points * 2 + 4 * n_points + 2 * d
    return ops, rows * row_bytes


def sampling_least_s(arch, n: float) -> float:
    """Least seconds of an image's sampling calls with ``n`` unmasked
    tokens: each call the larger of its float32 operations at the
    non-FMA float32 rate and its bytes at the HBM rate, over the encoder's
    calls (``n`` rows) and the decoder's (the queries)."""
    c = arch["deformable"]
    total = 0.0
    for layers, rows, points in ((c["enc_layers"], n, c["enc_points"]),
                                 (c["dec_layers"], c["queries"], c["dec_points"])):
        ops, nbytes = _sampling(arch, rows, points)
        total += layers * max(ops / counts.F32_OPS_PER_S, nbytes / counts.HBM_BYTES_PER_S)
    return total


def sampling_ops(arch, n: float) -> float:
    c = arch["deformable"]
    return (_sampling(arch, n, c["enc_points"])[0] * c["enc_layers"]
            + _sampling(arch, c["queries"], c["dec_points"])[0] * c["dec_layers"])


def points_a_call(arch, batch: int) -> int:
    """Query rows x heads x levels x points of one predict call of ``batch``
    canvases, every row of the canvas (`SAMPLED_POINTS`' count)."""
    c = arch["deformable"]
    hl = _heads_levels(arch)
    return batch * hl * (c["enc_layers"] * canvas_tokens(arch) * c["enc_points"]
                         + c["dec_layers"] * c["queries"] * c["dec_points"])


def points_agree(r) -> bool:
    """Whether the program's `SAMPLED_POINTS` over its predict calls is the
    shapes' count (`points_a_call`)."""
    points, calls = _counter(SAMPLED_POINTS), _counter(PREDICT_CALLS)
    return bool(points and calls and r.host.get("batch")
                and points == calls * points_a_call(r.arch, r.host["batch"]))


def least_s(arch, n: float) -> float:
    """The least seconds of one image at the card's peaks: the trunk's int8
    operations, the levels' and transformer's bfloat16 FLOPs and the
    sampling's float32 operations."""
    return (trunk_int8_ops(arch) / counts.INT8_OPS_PER_S
            + (levels_flops(arch) + transformer_flops(arch, n)) / counts.BF16_FLOPS_PER_S
            + sampling_ops(arch, n) / counts.F32_OPS_PER_S)
