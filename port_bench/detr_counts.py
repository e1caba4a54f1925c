"""Frozen work counts of DETR: the trunk's int8 operations on a canvas, the
transformer's bfloat16 FLOPs on an image's unmasked tokens, and the part of
them in the attention cores.

Only the work that no implementation can skip is counted: the trunk runs
over the whole canvas (its convolutions see the padding), but the tokens of
the padding take part in nothing an image's detections depend on, so the
transformer is counted on the unmasked tokens alone, and the attention on
the pairs of an unmasked query and an unmasked key. A product of an (m, k)
and a (k, n) matrix is 2 m k n operations. The unmasked tokens are the
program's own count (`traced_tokens_an_image`); an image's ``n`` may be a
mean, which the n x n pairs of the encoder take as a lower bound.
"""

from __future__ import annotations

from port_bench.reference import detr

PREDICT = "odt.predict"
PREDICT_CALLS = "odt.predict.calls"
VALID_TOKENS = "odt.detr.valid_tokens"


def traced_tokens_an_image(r):
    """Unmasked C5 tokens an image of the calls a traced run made: the
    program's counters (``odt.detr.valid_tokens``, ``odt.predict.calls``,
    which add up only while a profiler records) over the run's batch. None
    where the program keeps no such counter."""
    from object_detector_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or not r.host.get("batch"):
        return None
    seen = counters()
    tokens, calls = seen.get(VALID_TOKENS), seen.get(PREDICT_CALLS)
    if not tokens or not calls:
        return None
    return tokens / (calls * r.host["batch"])


def trunk_int8_ops(arch) -> int:
    """Operations of the int8 trunk on one canvas: 2 a conv multiply-add."""
    return 2 * detr.macs_per_image(arch)


def attention_flops(arch, n: float) -> float:
    """QK^T and PV of one image with ``n`` unmasked tokens, over all heads:
    encoder self-attention (n x n), decoder self-attention (Q x Q) and
    cross-attention (Q x n), 4 d a pair."""
    t = arch["transformer"]
    d, q = t["d_model"], t["queries"]
    return 4 * d * (t["enc_layers"] * n * n + t["dec_layers"] * (q * q + q * n))


def transformer_flops(arch, n: float) -> float:
    """bfloat16 FLOPs of one image with ``n`` unmasked tokens: the input
    projection, every encoder and decoder product, and the attention."""
    t = arch["transformer"]
    d, f, q = t["d_model"], t["ffn"], t["queries"]
    proj = 2 * detr.C5_CHANNELS * d * n
    encoder = t["enc_layers"] * (2 * 4 * d * d * n + 2 * 2 * d * f * n)
    # Self-attention's four projections and cross-attention's query and out
    # projections on the queries; its key and value projections on the tokens.
    decoder = t["dec_layers"] * (2 * 6 * d * d * q + 2 * 2 * d * d * n + 2 * 2 * d * f * q)
    return proj + encoder + decoder + attention_flops(arch, n)
