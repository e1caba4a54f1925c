"""DETR's attention core (`kernels.attention.masked_attention`): on the CPU
its plain version against ``F.scaled_dot_product_attention`` with the same
boolean mask, the wrapper's routing and refusals and the skipped-key
counter; on the card (``cuda``-marked) the CUDA kernel against the plain
version at the ``detr_dc5_int8_batch32`` cell's own shapes (32 canvases of
1088 px, 4,624 C5 tokens, landscape and portrait images 3:1), padded keys
that change nothing, and 18 launches a DETR forward.

This file imports neither JAX nor the reference, so on the card it runs as

    python -m pytest tests/test_torch_detr_attention.py --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from object_detector_tpu_torch.kernels import attention
from object_detector_tpu_torch.models import detr
from object_detector_tpu_torch.utils import profiling

HEADS, D = 8, 256
# The cell's canvas and its two image shapes (h, w): landscape images leave
# C5's column 67 and rows 50 to 67 masked, portrait ones rows 67 and 18 of
# every 68 columns.
CANVAS, LANDSCAPE, PORTRAIT = 1088, (800, 1066), (1066, 800)
QUERIES = 100
# Attention launches of one DETR forward: 6 encoder self-attentions, 6
# decoder self-attentions and 6 cross-attentions.
FORWARD_LAUNCHES = 18
# The float32 plain version against SDPA in float32: the same function,
# summed in another order over up to 4,624 keys (read: 5e-6 at outputs of a
# few units).
PLAIN_TOL = 1e-5


def _extents(batch, portrait_every=4):
    """(B, 2) extents: every ``portrait_every``-th image portrait, the rest
    landscape (3:1 at 4)."""
    return torch.tensor([PORTRAIT if i % portrait_every == portrait_every - 1 else LANDSCAPE
                         for i in range(batch)])


def _key_pad(extents, canvas=CANVAS, device="cpu"):
    """(B, Hf * Wf) padding of C5 tokens, as `DETRModel.transform` makes it."""
    side = detr.trunk_feature_size(canvas, dilate_c5=True)
    return detr.feature_mask(extents.to(device), (canvas, canvas), (side, side)).flatten(1)


def _qkv(b, lq, lk, gen, device, fused=False, dtype=torch.float32, gain=1.5):
    """Projected q, k, v with scores of a few units; with ``fused``, q and k
    are the two halves of one (B, L, 2d) projection (`MultiheadAttention`'s
    self-attention), views at row stride 2d."""
    def draw(*shape):
        return (torch.randn(*shape, generator=gen, device=device) * gain).to(dtype)

    if fused:
        q, k = draw(b, lq, 2 * D).chunk(2, dim=-1)
    else:
        q, k = draw(b, lq, D), draw(b, lk, D)
    return q, k, draw(b, lk, D)


def _sdpa(q, k, v, key_pad):
    """The port's former `attend`: SDPA over (B, heads, L, 32) with the
    boolean keep-mask."""
    b, lq, d = q.shape
    lk = k.shape[1]
    split = lambda x, n: x.reshape(b, n, HEADS, d // HEADS).transpose(1, 2)  # noqa: E731
    keep = None if key_pad is None else ~key_pad[:, None, None, :]
    out = F.scaled_dot_product_attention(split(q, lq), split(k, lk), split(v, lk), attn_mask=keep)
    return out.transpose(1, 2).reshape(b, lq, d)


# ---------------------------------------------------------------- the CPU

# (name, batch, queries, canvas of the keys, portrait share, fused, masked):
# self-attention on a 272 px canvas (17 x 17 tokens, the cell's mask
# patterns at a quarter of its side); the decoder's 100 queries against the
# cell's own 4,624 keys; unmasked decoder self-attention; q and k as the
# chunk views of a fused projection.
PLAIN_CASES = [
    ("landscape", 2, None, 272, 0, False, True),
    ("portrait", 2, None, 272, 1, False, True),
    ("mixed_fused", 4, None, 272, 4, True, True),
    ("cross_100_of_4624", 2, QUERIES, CANVAS, 2, False, True),
    ("unmasked_100", 2, QUERIES, None, 0, True, False),
]


@pytest.mark.parametrize("name,b,lq,canvas,every,fused,masked", PLAIN_CASES,
                         ids=[c[0] for c in PLAIN_CASES])
def test_the_plain_version_is_sdpa_with_the_mask(name, b, lq, canvas, every, fused, masked):
    gen = torch.Generator().manual_seed(len(name))
    key_pad = None
    if masked:
        ext = _extents(b, every) if every else torch.tensor([LANDSCAPE] * b)
        key_pad = _key_pad(ext * canvas // CANVAS, canvas)
    lk = key_pad.shape[1] if masked else QUERIES
    q, k, v = _qkv(b, lq or lk, lk, gen, "cpu", fused=fused)
    if fused:
        assert q.stride(1) == 2 * D and not q.is_contiguous()
    if masked:
        assert bool(key_pad.any()) and not bool(key_pad.all(1).any())
    got = attention.masked_attention_reference(q, k, v, HEADS, key_pad)
    assert got.dtype == torch.float32 and got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, _sdpa(q, k, v, key_pad), rtol=PLAIN_TOL, atol=PLAIN_TOL)


def test_the_cells_masks_leave_the_stated_keys():
    pad = _key_pad(_extents(4)).reshape(4, 68, 68)
    landscape, portrait = pad[0], pad[3]
    assert int((~pad).sum(dim=(1, 2))[0]) == int((~pad).sum(dim=(1, 2))[3]) == 3350
    assert bool(landscape[50:].all()) and bool(landscape[:, 67].all())
    assert not bool(landscape[:50, :67].any())
    assert bool(portrait[67].all()) and int(portrait[:67].all(0).sum()) == 18


@pytest.mark.parametrize("dtype,heads", [(torch.float32, HEADS), (torch.bfloat16, HEADS),
                                         (torch.float32, 16)])
def test_the_wrapper_runs_the_plain_version_for_cpu_tensors(dtype, heads):
    gen = torch.Generator().manual_seed(3)
    key_pad = _key_pad(_extents(2, 2) // 4, 272)
    q, k, v = _qkv(2, 40, key_pad.shape[1], gen, "cpu", dtype=dtype)
    before = attention.masked_attention.launches
    got = attention.masked_attention(q, k, v, heads, key_pad)
    assert attention.masked_attention.launches == before
    assert got.dtype == dtype
    assert torch.equal(got, attention.masked_attention_reference(q, k, v, heads, key_pad))


def test_padded_keys_change_nothing_in_the_plain_version():
    gen = torch.Generator().manual_seed(4)
    key_pad = _key_pad(_extents(2, 2) // 4, 272)
    q, k, v = _qkv(2, 289, 289, gen, "cpu")
    want = attention.masked_attention(q, k, v, HEADS, key_pad)
    noise = torch.randn(k.shape, generator=gen) * 100
    k2 = torch.where(key_pad[..., None], noise, k)
    v2 = torch.where(key_pad[..., None], -noise, v)
    assert torch.equal(attention.masked_attention(q, k2, v2, HEADS, key_pad), want)


def _meta(dtype=torch.bfloat16, grad=False):
    q = torch.empty(2, 10, D, dtype=dtype, device="meta", requires_grad=grad)
    return q, torch.empty(2, 12, D, dtype=dtype, device="meta"), torch.empty(
        2, 12, D, dtype=dtype, device="meta")


# The kernel's refusals, checked before any launch, on tensors of the meta
# device (no data, no card): what it takes otherwise (bf16, heads of 32, no
# autograd) is refused only for not lying on the card.
REFUSALS = [
    ("float32", dict(dtype=torch.float32), HEADS, TypeError, "bfloat16"),
    ("float16", dict(dtype=torch.float16), HEADS, TypeError, "bfloat16"),
    ("heads_of_16", {}, 16, ValueError, "heads of 32"),
    ("heads_of_64", {}, 4, ValueError, "heads of 32"),
    ("requires_grad", dict(grad=True), HEADS, ValueError, "autograd"),
    ("not_on_the_card", {}, HEADS, ValueError, "cuda or cpu"),
]


@pytest.mark.parametrize("name,kw,heads,error,says", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name, kw, heads, error, says):
    with pytest.raises(error, match=says):
        attention.masked_attention(*_meta(**kw), heads, None)


def test_the_wrapper_refuses_shapes_that_disagree():
    q, k, v = _meta()
    with pytest.raises(ValueError):
        attention.masked_attention(q, k[:, :, :128], v, HEADS, None)
    with pytest.raises(ValueError):
        attention.masked_attention(q, k, v, 7, None)
    with pytest.raises(ValueError):
        attention.masked_attention(q, k, v, HEADS, torch.zeros(2, 11, dtype=torch.bool,
                                                               device="meta"))


def test_the_wrapper_refuses_more_masked_keys_than_shared_memory_holds():
    """A masked call's list of unmasked keys lives in the block's shared
    memory: past `MAX_MASKED_KEYS` keys the kernel is refused, an unmasked
    call of as many keys is not."""
    lk = attention.MAX_MASKED_KEYS + 1
    q = torch.empty(1, 4, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, lk, D, dtype=torch.bfloat16, device="meta")
    pad = torch.empty(1, lk, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="masked keys"):
        attention.masked_attention(q, k, k, HEADS, pad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention.masked_attention(q, k, k, HEADS, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention.masked_attention(q, k[:, :-1], k[:, :-1], HEADS, pad[:, :-1])


def test_the_skipped_key_counter_adds_masked_keys_only_while_a_profiler_records():
    gen = torch.Generator().manual_seed(5)
    key_pad = _key_pad(_extents(4) // 4, 272)
    q, k, v = _qkv(4, 30, key_pad.shape[1], gen, "cpu")
    profiling.reset_counters()
    attention.masked_attention(q, k, v, HEADS, key_pad)
    assert attention.SKIPPED_KEYS not in profiling.counters()
    other = key_pad.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        attention.masked_attention(q, k, v, HEADS, key_pad)
        attention.masked_attention(q, k, v, HEADS, None)
        attention.masked_attention(q, k, v, HEADS, key_pad)
        attention.masked_attention(q, k, v, HEADS, other)
        other[:, :3] = True  # a mask changed in place is counted anew
        attention.masked_attention(q, k, v, HEADS, other)
    counted = profiling.counters().get(attention.SKIPPED_KEYS)
    profiling.reset_counters()
    assert counted == 3 * int(key_pad.sum()) + int(other.sum())


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the attention kernel has no CPU mode")
    return torch.device("cuda")


# The kernel against the plain version (float32 softmax and products on the
# same bf16 inputs, rounded to bf16 once at the end). The kernel rounds P to
# bf16 before PV (a relative 2^-9 a weight, which averages over the keys)
# and its output once more, so the two differ by about one bf16 step of the
# output's value: on an NVIDIA H100 at the cell's shapes at most 0.0156 at
# outputs up to 7.3 (one step there), 99.9% of them within 0.0039. The
# limit is two steps of the value (2^-7 relative) and, for outputs near
# zero, 2^-8 of the values' scale (V ~ N(0, 1.5^2)).
KERNEL_RTOL, KERNEL_ATOL = 2 ** -7, 1.5 * 2 ** -8

# (name, queries, masked, fused): the encoder's self-attention, the
# decoder's cross-attention and its unmasked self-attention, at batch 32.
CELL_CASES = [
    ("encoder", None, True, True),
    ("cross", QUERIES, True, False),
    ("decoder_self", QUERIES, False, True),
]


def _cell_case(name, lq, masked, fused, device, batch=32):
    gen = torch.Generator(device=device).manual_seed(len(name))
    key_pad = _key_pad(_extents(batch), device=device) if masked else None
    lk = key_pad.shape[1] if masked else QUERIES
    q, k, v = _qkv(batch, lq or lk, lk, gen, device, fused=fused, dtype=torch.bfloat16)
    return q, k, v, key_pad


def _plain(q, k, v, key_pad, block=4):
    """The plain version image block by image block (its float32 scores of
    4 images of the cell take 2.7 GB)."""
    return torch.cat([attention.masked_attention_reference(
        q[i:i + block], k[i:i + block], v[i:i + block], HEADS,
        None if key_pad is None else key_pad[i:i + block]) for i in range(0, q.shape[0], block)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,lq,masked,fused", CELL_CASES, ids=[c[0] for c in CELL_CASES])
def test_kernel_is_the_plain_version_at_the_cells_shapes(cuda_device, name, lq, masked, fused):
    q, k, v, key_pad = _cell_case(name, lq, masked, fused, cuda_device)
    before = attention.masked_attention.launches
    got = attention.masked_attention(q, k, v, HEADS, key_pad)
    torch.cuda.synchronize()
    assert attention.masked_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), _plain(q, k, v, key_pad).float(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lq,masked,fused", CELL_CASES[:2], ids=[c[0] for c in CELL_CASES[:2]])
def test_padded_keys_change_nothing_in_the_kernel(cuda_device, name, lq, masked, fused):
    q, k, v, key_pad = _cell_case(name, lq, masked, fused, cuda_device)
    want = attention.masked_attention(q, k, v, HEADS, key_pad)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    noise = (torch.randn(k.shape, generator=gen, device=cuda_device) * 100).to(k.dtype)
    k2 = torch.where(key_pad[..., None], noise, k)
    v2 = torch.where(key_pad[..., None], -noise, v)
    assert torch.equal(attention.masked_attention(q, k2, v2, HEADS, key_pad), want)


# Ragged and odd inputs: queries and keys off the tiles (1, 63, 65, 129
# keys; 1 and 130 queries), an image with one key, q at a row stride that is
# not a multiple of 8 (copied), a batch whose first image has no unmasked key
# (NaN rows in both versions).
@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(1, 1), (130, 63), (7, 65), (128, 129), (100, 4624)])
def test_kernel_on_ragged_tiles(cuda_device, lq, lk):
    gen = torch.Generator(device=cuda_device).manual_seed(lq * 7 + lk)
    q, k, v = _qkv(3, lq, lk, gen, cuda_device, dtype=torch.bfloat16)
    key_pad = torch.rand(3, lk, generator=gen, device=cuda_device) < 0.3
    key_pad[0, 0] = False
    key_pad[1] = False
    key_pad[2] = True
    key_pad[2, lk // 2] = False  # one key
    wide = torch.zeros(3, lq, D + 3, dtype=torch.bfloat16, device=cuda_device)
    wide[..., 3:] = q
    for qq in (q, wide[..., 3:]):
        for pad in (key_pad, None):
            got = attention.masked_attention(qq, k, v, HEADS, pad)
            torch.testing.assert_close(got.float(), _plain(qq, k, v, pad).float(),
                                       rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    key_pad[0] = True
    got = attention.masked_attention(q, k, v, HEADS, key_pad)
    assert bool(got[0].isnan().all()) and bool(torch.isfinite(got[1:]).all())


@pytest.mark.cuda
def test_the_kernel_wrapper_raises_on_the_card(cuda_device):
    q, k, v, _ = _cell_case("raises", QUERIES, False, False, cuda_device, batch=2)
    with pytest.raises(TypeError):
        attention.masked_attention(q.float(), k.float(), v.float(), HEADS, None)
    with pytest.raises(ValueError):
        attention.masked_attention(q, k, v, 16, None)
    with pytest.raises(ValueError):
        attention.masked_attention(q.requires_grad_(), k, v, HEADS, None)


@pytest.mark.cuda
def test_a_detr_forward_launches_the_kernel_18_times(cuda_device, monkeypatch):
    """The float DETR-DC5 at the preset's widths in bf16 on two canvases of
    the cell (one of each orientation): 18 launches, 1,274 keys left out of
    every masked call of each image, and the forward with the plain version
    swapped in within DETR_LOGIT_GAP and DETR_BOX_GAP (stated below)."""
    import json
    from pathlib import Path

    from object_detector_tpu_torch.core.config import get_config
    from object_detector_tpu_torch.models.retinanet import build_model
    from object_detector_tpu_torch.ops.augment import normalize
    from port_bench.detr_weights import make_weights

    cell = json.loads((Path(__file__).resolve().parent.parent / "port_bench" / "configs"
                       / "detr_r50_dc5_coco.json").read_text())
    cfg = get_config("detr_r50_dc5_coco")
    model = build_model(cfg)
    model.load_state_dict(make_weights(cell["resolved"], cell["weights"], 2 ** 33 + 5, "cpu"))
    model = model.to(cuda_device).eval()
    extents = torch.tensor([LANDSCAPE, PORTRAIT], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    images = normalize(torch.rand(2, CANVAS, CANVAS, 3, generator=gen, device=cuda_device))
    rows = torch.arange(CANVAS, device=cuda_device)
    inside = (rows[None, :, None] < extents[:, :1, None]) & (rows[None, None, :]
                                                              < extents[:, 1:, None])
    images = images * inside[..., None]
    with torch.inference_mode():
        model(images, extents)
        before = attention.masked_attention.launches
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            logits, boxes = model(images, extents)
        torch.cuda.synchronize()
        skipped = profiling.counters().get(attention.SKIPPED_KEYS)
        profiling.reset_counters()
        assert attention.masked_attention.launches == before + FORWARD_LAUNCHES
        t = cfg.transformer
        assert skipped == (t.enc_layers + t.dec_layers) * 2 * (68 * 68 - 3350)
        monkeypatch.setattr(detr, "masked_attention", attention.masked_attention_reference)
        plain_logits, plain_boxes = model(images, extents)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(boxes).all())
    assert float((logits - plain_logits).abs().max()) < DETR_LOGIT_GAP
    assert float((boxes - plain_boxes).abs().max()) < DETR_BOX_GAP


# Twelve bf16 layers carry the kernel's rounding of P into the outputs: on
# an NVIDIA H100, over three seeds' weights, the logits moved by 0.092 to
# 0.122 and the boxes by 0.0054 to 0.0087 of the extent; the limits leave
# about three times that. A fault in the kernel (a wrong key, a lost tile)
# moves them by units.
DETR_LOGIT_GAP, DETR_BOX_GAP = 0.4, 0.03
