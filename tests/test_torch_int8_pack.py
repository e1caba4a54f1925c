"""The operands of the int8 tensor-core kernels, checked on the CPU where
they are made (the kernels themselves run only on the card).

Each conv of the fused bottleneck (``csrc/bottleneck.cu``), of VGG block 1
(``csrc/stem_fp.cu``) and of the ResNet stem (``csrc/resnet_stem.cu``) is
rebuilt from the packed weights the way the kernel's ``mma.sync.m16n8k32``
fragments read them (`kernel_b_matrix`; for conv1_1 also the A rows the
kernel builds with ``__byte_perm``, for the ResNet stem the A rows it reads
from its phase patch) and held equal to the int8 conv it stands for; B2's
conv1_2 operand is B4's. Also the exact signed quantize rule
(``csrc/int8_mma.cuh`` `quantize_code`, the ResNet stem's input quantize and
the L2Norm's whole chain) on ties, and: an edit to a header that a source
includes changes the library's path, so every kernel that includes it
rebuilds."""

import numpy as np
import pytest
import torch

from object_detector_tpu_torch.kernels import (
    bottleneck, build, int8_pack, l2norm, resnet_stem, stem, stem_fp,
)
from object_detector_tpu_torch.ops import int8 as int8_ops

torch.set_num_threads(2)


def kernel_b_matrix(packed: torch.Tensor, k: int, n: int) -> np.ndarray:
    """The (K, N) matrix that the kernel's B fragments read from ``packed``.
    Lane L of pair q at k-step s of pass p holds b[0], b[1] of n-tile 2q, then
    of n-tile 2q + 1; b[0] is column g = L // 4 of its n-tile, rows 4t .. 4t
    + 3 of the k-step (t = L % 4), b[1] rows 16 + 4t .. 16 + 4t + 3. Fails if
    an element is read twice or not at all."""
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (n // 64, k // 32, 4, 32, 16)
    p, s, q, lane, byte = np.meshgrid(*(np.arange(d) for d in packed.shape), indexing="ij")
    g, t = lane // 4, lane % 4
    n_tile = 2 * q + byte // 8
    reg = (byte // 4) % 2
    rows = (32 * s + 16 * reg + 4 * t + byte % 4).ravel()
    cols = (64 * p + 8 * n_tile + g).ravel()
    seen = np.zeros((k, n), np.int64)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()
    w = np.zeros((k, n), np.int64)
    w[rows, cols] = packed.numpy().astype(np.int64).ravel()
    return w


def _taps(a: np.ndarray):
    """The nine (ky, kx) windows of a SAME 3x3 over NHWC ``a`` (zero padded)."""
    h, w = a.shape[1:3]
    ap = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return [ap[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]


def _ints(shape, seed, lim=127):
    return np.random.default_rng(seed).integers(-lim, lim + 1, shape).astype(np.int8)


def _conv(x, w):
    return int8_ops.conv_int8(torch.from_numpy(x), torch.from_numpy(w)).numpy()


# (C, Cm) of ResNet-50's four stages.
RESNET_WIDTHS = {"stage1": (256, 64), "stage2": (512, 128), "stage3": (1024, 256),
                 "stage4": (2048, 512)}


@pytest.mark.parametrize("stage", list(RESNET_WIDTHS))
def test_bottleneck_packed_operands_rebuild_the_convs(stage):
    """conv1 (x . W1), conv2 (the nine taps of mid1, each against rows
    Cm * tap .. of W2) and conv3 (mid2 . W3), from the matrices the kernel
    reads, equal the int8 convs."""
    c, cm = RESNET_WIDTHS[stage]
    w1, w2, w3 = _ints((c, cm), 1), _ints((3, 3, cm, cm), 2), _ints((cm, c), 3)
    p1, p2, p3 = bottleneck.pack_weights(*(torch.from_numpy(w) for w in (w1, w2, w3)))
    m1, m2, m3 = kernel_b_matrix(p1, c, cm), kernel_b_matrix(p2, 9 * cm, cm), \
        kernel_b_matrix(p3, cm, c)
    x, mid1, mid2 = _ints((1, 3, 5, c), 4), _ints((1, 3, 5, cm), 5), _ints((1, 3, 5, cm), 6)
    np.testing.assert_array_equal(x.astype(np.int64) @ m1, _conv(x, w1.reshape(1, 1, c, cm)))
    acc2 = sum(win.astype(np.int64) @ m2[cm * tap: cm * (tap + 1)]
               for tap, win in enumerate(_taps(mid1)))
    np.testing.assert_array_equal(acc2, _conv(mid1, w2))
    np.testing.assert_array_equal(mid2.astype(np.int64) @ m3, _conv(mid2, w3.reshape(1, 1, cm, c)))


def _byte_perm(lo: np.ndarray, hi: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm on words given as (..., 4) uint8 arrays: byte i of
    the result is byte (sel >> 4 i) & 7 of lo's four bytes then hi's."""
    both = np.concatenate([lo, hi], axis=-1)
    return np.stack([both[..., (sel >> (4 * i)) & 7] for i in range(4)], axis=-1)


def _conv11_rows(x_q: np.ndarray) -> np.ndarray:
    """The 32-byte A row of every pixel as csrc/stem_fp.cu's im2col_word
    builds it: the nine taps' words (3 codes and a zero byte); word j < 7 is
    __byte_perm of the words of taps a = j + j // 3 and a + 1 (a zero word
    past tap 8) by selector 0x4210, 0x5421, 0x6542 for j % 3; word 7 is 0."""
    words = [np.pad(win, ((0, 0),) * 3 + ((0, 1),)).view(np.uint8) for win in _taps(x_q)]
    zero = np.zeros_like(words[0])
    out = []
    for j in range(7):
        a = j + j // 3
        out.append(_byte_perm(words[a], words[a + 1] if a < 8 else zero,
                              (0x4210, 0x5421, 0x6542)[j % 3]))
    out.append(zero)
    return np.concatenate(out, axis=-1).view(np.int8)


@pytest.mark.parametrize("conv", ["conv1_1", "conv1_2"])
def test_stem_fp_packed_operands_rebuild_the_convs(conv):
    """conv1_1 from the kernel's A rows (K = 27 padded to 32) against the
    (32, 64) matrix it reads, conv1_2 from the nine taps against rows 64 *
    tap .. of the (576, 64) one: both equal the int8 convs."""
    w1, w2 = _ints((3, 3, 3, 64), 7), _ints((3, 3, 64, 64), 8)
    p1, p2 = stem_fp.pack_weights(torch.from_numpy(w1), torch.from_numpy(w2))
    if conv == "conv1_1":
        x_q = _ints((2, 5, 7, 3), 9)
        rows = _conv11_rows(x_q).astype(np.int64)
        assert rows.shape == (2, 5, 7, 32) and not rows[..., 27:].any()
        m1 = kernel_b_matrix(p1, 32, 64)
        assert not m1[27:].any()
        np.testing.assert_array_equal(rows @ m1, _conv(x_q, w1))
    else:
        q1 = _ints((1, 6, 8, 64), 10)
        m2 = kernel_b_matrix(p2, 576, 64)
        acc = sum(win.astype(np.int64) @ m2[64 * tap: 64 * (tap + 1)]
                  for tap, win in enumerate(_taps(q1)))
        np.testing.assert_array_equal(acc, _conv(q1, w2))


def resnet_stem_conv_from_packed(x_q: np.ndarray, packed: torch.Tensor) -> np.ndarray:
    """The ResNet stem's 7x7/s2 pad-3 conv as csrc/resnet_stem.cu computes it:
    the phase image z (phase pixel (Y, X) holds input (2 Y + py - 3, 2 X + px
    - 3, c) at byte 6 py + 3 px + c, zero codes outside the image), conv
    pixel (oy, ox)'s 192-byte A row gathered as the kernel reads it (16-byte
    chunk j at z's byte offset (oy * row + ox * 12) + (j // 3) * row + (j % 3)
    * 16, row being a phase row's bytes), times the (192, 64) matrix that the
    B fragments read. Column n is output channel `COLUMN_CHANNELS[n]`."""
    b, h, w, _ = x_q.shape
    ho, wo = h // 2, w // 2
    xp = np.pad(x_q, ((0, 0), (3, 3), (3, 3), (0, 0)))
    z = xp.reshape(b, ho + 3, 2, wo + 3, 2, 3).transpose(0, 1, 3, 2, 4, 5).reshape(b, -1)
    row = 12 * (wo + 3)
    oy, ox = np.meshgrid(np.arange(ho), np.arange(wo), indexing="ij")
    base = (oy * row + ox * 12)[..., None]
    offsets = np.array([(j // 3) * row + (j % 3) * 16 + e for j in range(12) for e in range(16)])
    rows = z[:, base + offsets]  # (B, Ho, Wo, 192)
    return rows.astype(np.int64) @ kernel_b_matrix(packed, resnet_stem.K_S2D, 64)


@pytest.mark.parametrize("kind", ["random", "saturated"])
@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 12, 20), (1, 28, 16)])
def test_resnet_stem_packed_operand_rebuilds_the_conv(kind, shape):
    """The space-to-depth K order (4 x 4 taps of the 12 phase channels, the
    kernel zero-padded to 8x8) against the phase-staged input gives the int8
    7x7/s2 pad-3 conv, on random codes and on codes and weights at the ends
    of their range."""
    rng = np.random.default_rng(sum(shape))
    if kind == "saturated":
        x_q = rng.choice(np.array([-127, 127], np.int8), (*shape, 3))
        w_q = rng.choice(np.array([-128, -127, 127], np.int8), (7, 7, 3, 64))
    else:
        x_q, w_q = _ints((*shape, 3), 11), _ints((7, 7, 3, 64), 12)
    packed = resnet_stem.pack_weights(torch.from_numpy(w_q))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (1, 6, 4, 32, 16)
    m = kernel_b_matrix(packed, resnet_stem.K_S2D, 64)
    assert sorted(resnet_stem.COLUMN_CHANNELS) == list(range(64))
    assert np.abs(m).sum() == np.abs(w_q.astype(np.int64)).sum()  # every tap once, the rest 0
    want = int8_ops.conv_int8(torch.from_numpy(x_q), torch.from_numpy(w_q), stride=2,
                              padding=3).numpy()
    got = resnet_stem_conv_from_packed(x_q, packed)
    np.testing.assert_array_equal(got, want[..., list(resnet_stem.COLUMN_CHANNELS)])


def quantize_by_reciprocal(x: torch.Tensor, s: float) -> torch.Tensor:
    """csrc/int8_mma.cuh `quantize_code` in float32 operations: q = x *
    RN(1 / s); where q lies within 2^-13 of a half-integer, q = x / s; then
    the clip and the round half to even by the 1.5 * 2^23 trick."""
    s32 = torch.tensor(s, dtype=torch.float32)
    magic = torch.tensor(12582912.0)
    q = x * torch.reciprocal(s32)
    near = ((q - ((q + magic) - magic)).abs() > 0.5 - 2.0 ** -13)
    q = torch.where(near, x / s32, q).clamp(-127.0, 127.0)
    return ((q + magic) - magic).to(torch.int8)


def test_resnet_stem_quantize_rule_equals_the_true_divide_on_ties():
    """Inputs at (n + 1/2) * s and one ulp either side, for several scales
    and every n that reaches the clip: the reciprocal rule gives the codes of
    clip(round(x / s)), the true divide. The product by RN(1 / s) alone does
    not, on some of them."""
    naive_differs = 0
    for s in (0.02, 0.0173, 1.0 / 3.0, 0.5, 3.7e-3, 0.0187):
        n = np.arange(-140, 140, dtype=np.float32)
        half = (n + np.float32(0.5)) * np.float32(s)
        x = np.concatenate([half, np.nextafter(half, -np.inf), np.nextafter(half, np.inf),
                            n * np.float32(s)]).astype(np.float32)
        xt = torch.from_numpy(x)
        want = int8_ops.quantize(xt.clone(), int8_ops.scale_tensor(s, torch.device("cpu")))
        np.testing.assert_array_equal(quantize_by_reciprocal(xt, s).numpy(), want.numpy())
        naive = (xt * torch.reciprocal(torch.tensor(s, dtype=torch.float32))).round().clamp(
            -127, 127).to(torch.int8)
        naive_differs += int((naive != want).sum())
    assert naive_differs > 0


TIE_SCALES = (0.02, 0.0173, 1.0 / 3.0, 0.5, 3.7e-3, 0.0187)


def l2norm_tie_case(s: float):
    """(q0, gamma) whose L2Norm values y land at (n + 1/2) * s for n from
    -140 to 139 and one ulp either side (and at n * s): pixel i holds code
    +1 (the first half of the pixels) or -1 at channel i % 1120 and zeros
    elsewhere, so 1 / sqrt(1 + 1e-12) rounds to 1 and y = +-gamma exactly;
    then 16 all-zero pixels. C = 1120, a multiple of 16."""
    n = np.arange(-140, 140, dtype=np.float32)
    half = (n + np.float32(0.5)) * np.float32(s)
    gamma = np.concatenate([half, np.nextafter(half, -np.inf), np.nextafter(half, np.inf),
                            n * np.float32(s)]).astype(np.float32)
    c = gamma.size
    q0 = np.zeros((2 * c + 16, c), np.int8)
    q0[np.arange(c), np.arange(c)] = 1
    q0[c + np.arange(c), np.arange(c)] = -1
    return torch.from_numpy(q0.reshape(1, 1, -1, c)), torch.from_numpy(gamma)


def l2norm_by_reciprocal(q0: torch.Tensor, gamma: torch.Tensor, s: float) -> torch.Tensor:
    """csrc/l2norm.cu's chain in float32 operations: the exact sum of
    squares, inv = 1 / sqrt(ss + 1e-12), y = (x * inv) * gamma, then
    `quantize_code` (`quantize_by_reciprocal`)."""
    x = q0.to(torch.float32)
    ss = q0.to(torch.int32).square().sum(dim=-1, keepdim=True).to(torch.float32)
    inv = torch.reciprocal(torch.sqrt(ss + torch.tensor(1e-12, dtype=torch.float32)))
    return quantize_by_reciprocal((x * inv) * gamma, s)


def test_l2norm_quantize_rule_equals_the_reference_on_ties():
    """B3's whole chain with the shared quantize rule gives the plain
    version's codes (a true divide by the scale) where y / s sits at a
    half-integer or one ulp from it, for signed y and through the clip at
    +-127; zero pixels give zero codes. The product by RN(1 / s) alone does
    not, on some of them."""
    naive_differs = 0
    for s in TIE_SCALES:
        q0, gamma = l2norm_tie_case(s)
        want = l2norm.l2norm_requant_reference(q0, gamma, s)
        got = l2norm_by_reciprocal(q0, gamma, s)
        assert torch.equal(got, want)
        assert not want[..., -16:, :].any()
        assert int(want.max()) == 127 and int(want.min()) == -127
        y = (q0.to(torch.float32) * gamma)
        naive = (y * torch.reciprocal(torch.tensor(s, dtype=torch.float32))).round().clamp(
            -127, 127).to(torch.int8)
        naive_differs += int((naive != want).sum())
    assert naive_differs > 0


def test_stem_pack_weights_is_the_second_operand_of_stem_fp():
    """B2 and B4 run one conv1_2 stage: B2's packed operand is, byte for
    byte, the second tensor `stem_fp.pack_weights` returns, and it rebuilds
    conv1_2 (`test_stem_fp_packed_operands_rebuild_the_convs`)."""
    w1, w2 = _ints((3, 3, 3, 64), 13), _ints((3, 3, 64, 64), 14)
    packed = stem.pack_weights(torch.from_numpy(w2))
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == stem.PACKED_SHAPE
    second = stem_fp.pack_weights(torch.from_numpy(w1), torch.from_numpy(w2))[1]
    assert tuple(second.shape) == tuple(packed.shape)
    assert second.numpy().tobytes() == packed.numpy().tobytes()


def test_pack_b_operand_refuses_widths_off_the_layout():
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_pack.pack_b_operand(torch.zeros((48, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="N of 64"):
        int8_pack.pack_b_operand(torch.zeros((64, 96), dtype=torch.int8))


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    """Five sources include int8_mma.cuh: an edit to it (or to a source)
    gives each a new library path, so all five rebuild; a source that does
    not include it keeps its path. B2 and B4 include conv12_pool.cuh (which
    includes int8_mma.cuh): an edit to it rebuilds those two only."""
    tensor_core = ("bottleneck", "stem_fp", "resnet_stem", "stem", "l2norm")
    for name in (*tensor_core, "nms"):
        (tmp_path / build.SOURCES[name]).write_bytes((build.CSRC_DIR / build.SOURCES[name]).read_bytes())
    for header in ("int8_mma.cuh", "conv12_pool.cuh"):
        (tmp_path / header).write_bytes((build.CSRC_DIR / header).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    names = (*tensor_core, "nms")
    before = {n: build.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    header = tmp_path / "int8_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// an edit\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in tensor_core)
    assert after["nms"] == before["nms"]
    stage = tmp_path / "conv12_pool.cuh"
    stage.write_bytes(stage.read_bytes() + b"\n")
    again = {n: build.library_path(n) for n in names}
    assert {n for n in names if again[n] != after[n]} == {"stem", "stem_fp"}
    src = tmp_path / "stem_fp.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("stem_fp") != again["stem_fp"]
    assert build.library_path("bottleneck") == again["bottleneck"]
