"""Port vs reference: the float SSD/ResNet-50 model, the carrying across of
its flax ``variables`` (both collections) and the BatchNorm fold, on a small
config: ResNet-50's own depth and widths at 64 px, float32, batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.models import ssd as ref_ssd
from object_detector_tpu.quant import engine as ref_engine
from object_detector_tpu_torch.convert import (
    flatten_tree, init_params, names_to_jax, params_from_jax, variables_from_jax,
)
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.models import resnet, ssd, vgg
from object_detector_tpu_torch.quant import engine
from object_detector_tpu_torch.train import loop

torch.set_num_threads(2)

SIZE = 64


def small_configs(**eval_kw):
    """(reference config, port config) of an SSD/ResNet-50 at 64 px: taps of
    8, 4 and 2 cells and two extra blocks that go 2 -> 1 -> 1, the sizes at
    which a 3x3/s2 SAME conv pads (0, 1) and (1, 1)."""
    out = []
    for mod in (ref_config, config):
        out.append(mod.DetectorConfig(
            name="ssd64_resnet_test",
            model=mod.ModelConfig(family="ssd", backbone="resnet50", image_size=SIZE,
                                  num_classes=4, compute_dtype="float32"),
            anchors=mod.AnchorConfig(
                feature_sizes=(8, 4, 2, 1, 1),
                sizes=((8., 16.), (16., 28.), (28., 40.), (40., 52.), (52., 62.)),
                aspect_ratios=((2.0,),) * 5,
            ),
            eval=mod.EvalConfig(pre_nms_top_k=64, max_detections=16, **eval_kw),
        ))
    return tuple(out)


def _seeded_batch_norm(tree, rng):
    """Every BatchNorm leaf of a flax collection drawn from ``rng``: with the
    identity BatchNorm of a fresh init a wrong fold would be invisible."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) and set(value) == {"scale", "bias"}:
            n = value["scale"].shape
            out[key] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
        elif isinstance(value, dict) and set(value) == {"mean", "var"}:
            n = value["mean"].shape
            out[key] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        elif isinstance(value, dict):
            out[key] = _seeded_batch_norm(value, rng)
        else:
            out[key] = np.asarray(value)
    return out


def small_variables(ref_cfg, seed):
    """flax ``variables`` of the small model: kernels from flax's init, every
    BatchNorm's parameters and statistics from a numpy seed."""
    model = ref_ssd.SSDModel(ref_cfg)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return {name: _seeded_batch_norm(jax.tree_util.tree_map(np.asarray, variables[name]), rng)
            for name in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def small():
    ref_cfg, cfg = small_configs()
    variables = small_variables(ref_cfg, seed=3)
    return ref_cfg, cfg, variables, variables_from_jax(variables)


def test_ssd_resnet_model_matches_flax(small):
    """atol 2e-3, the reference's own band for this model against its folded
    form (tests/test_quant.py:105); observed 2e-5 on logits up to 8."""
    ref_cfg, cfg, variables, state = small
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (2, SIZE, SIZE, 3)).astype(np.float32)
    model = ref_ssd.SSDModel(ref_cfg)
    want_cls, want_box = jax.jit(lambda v, i: model.apply(v, i, train=False))(
        variables, jnp.asarray(x))
    port = ssd.SSDModel(cfg)
    port.load_state_dict(state)
    with torch.no_grad():
        got_cls, got_box = port.eval()(torch.from_numpy(x))
    assert got_cls.shape == (2, cfg.anchors.num_anchors, 4) and got_cls.dtype == torch.float32
    assert port.l2norm is None and not any(k.startswith("l2norm") for k in state)
    assert float(np.abs(np.asarray(want_cls)).max()) > 1.0
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box), rtol=0, atol=2e-3)


def test_variables_round_trip_and_cover_the_state_dict(small):
    ref_cfg, cfg, variables, state = small
    port = ssd.SSDModel(cfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert "backbone.stem_bn.running_var" in state and "backbone.stem_conv.bias" not in state
    assert "backbone.stage2_block1.bn_proj.weight" in state
    assert "backbone.stage2_block2.proj.weight" not in state
    flat = {**flatten_tree(variables["params"]), **flatten_tree(variables["batch_stats"])}
    back = names_to_jax(state)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # The VGG tree still maps as before: an L2Norm's lone scale stays a scale.
    vgg_flat = {"l2norm/scale": np.ones(4, np.float32),
                "backbone/conv1_1/kernel": np.zeros((3, 3, 3, 8), np.float32),
                "backbone/conv1_1/bias": np.zeros(8, np.float32)}
    assert set(params_from_jax(vgg_flat)) == {
        "l2norm.scale", "backbone.conv1_1.weight", "backbone.conv1_1.bias"}
    with pytest.raises(KeyError):
        params_from_jax({"backbone/stem_bn/gamma": np.ones(4, np.float32)})


def test_fold_resnet50_equals_the_reference(small):
    """Exact: both fold in numpy float32, operation for operation."""
    ref_cfg, cfg, variables, state = small
    want = flatten_tree(ref_engine.fold_resnet50(variables["params"], variables["batch_stats"]))
    folded = engine.fold_resnet50(state)
    assert not any(".bn" in k or "stem_bn" in k for k in folded)
    got = names_to_jax(folded)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert folded["head0.cls.weight"] is state["head0.cls.weight"]  # passes through


def test_batch_norm_follows_flax():
    """One BatchNorm against flax's: float32 within 1e-5 on values up to 10
    (a few ulps: ATen orders the products differently), and bf16 flax's
    value or its neighbour (both compute in float32 on float32 parameters
    and round once)."""
    from flax import linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(0, 2.0, (2, 5, 5, 16)).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.5, 16).astype(np.float32),
             "var": rng.uniform(0.3, 3.0, 16).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.normal(0, 0.5, 16).astype(np.float32)}
    port = resnet.BatchNorm(16)
    port.load_state_dict(variables_from_jax({"params": params, "batch_stats": stats}))
    for dtype, jdtype, atol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 0)):
        module = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdtype)
        want = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x).astype(jdtype))
        with torch.no_grad():
            got = port(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == dtype
        diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        if atol:
            assert diff.max() <= atol
        else:  # bf16: the same value or its neighbour (an ulp of the float32 result decides)
            assert (diff > 0).mean() < 0.02 and diff.max() <= 2.0 ** -6


def test_strided_same_conv_at_sizes_two_and_one_follows_xla():
    """The SSD-512 extras end 4 -> 2 -> 1 with 3x3/s2 SAME convs; SSD-300
    never reaches those sizes."""
    rng = np.random.default_rng(6)
    assert vgg.same_pads(2, 3, 2, 1) == (0, 1) and vgg.same_pads(1, 3, 2, 1) == (1, 1)
    kernel = rng.normal(0, 1, (3, 3, 4, 6)).astype(np.float32)
    conv = vgg.Conv(4, 6, 3, stride=2, bias=False)
    conv.load_state_dict(params_from_jax({"kernel": kernel}))
    for size in (4, 2, 1):
        x = rng.normal(0, 1, (1, size, size, 4)).astype(np.float32)
        dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape, ("NHWC", "HWIO", "NHWC"))
        want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
                                            dimension_numbers=dn)
        with torch.no_grad():
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape == (1, -(-size // 2), -(-size // 2), 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_params_batch_norm_identity_or_seeded():
    ref_cfg, cfg = small_configs()
    plain = init_params(ssd.SSDModel(cfg), seed=1).state_dict()
    assert torch.all(plain["backbone.stem_bn.weight"] == 1)
    assert torch.all(plain["backbone.stem_bn.running_var"] == 1)
    assert not plain["backbone.stage3_block2.bn2.running_mean"].any()
    a = init_params(ssd.SSDModel(cfg), seed=1, random_batch_stats=True).state_dict()
    b = init_params(ssd.SSDModel(cfg), seed=1, random_batch_stats=True).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    var, weight = a["backbone.stage4_block3.bn3.running_var"], a["backbone.stem_bn.weight"]
    assert 0.5 <= float(var.min()) < float(var.max()) < 2.0
    assert 0.5 <= float(weight.min()) < float(weight.max()) < 1.5
    assert a["backbone.stem_bn.running_mean"].abs().max() > 0


def test_full_width_ssd512_model_has_seven_levels():
    """The preset itself, port only, one image: 24564 anchors over 7 levels,
    the extras fed from C5's 2048 channels, bf16 inside and float32 out."""
    cfg = config.get_config("ssd512_resnet50_coco")
    model = init_params(ssd.SSDModel(cfg), seed=0, random_batch_stats=True).eval()
    assert model.num_levels == 7 and model.extras.conv8_1.weight.shape[1] == 2048
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (1, 512, 512, 3)).astype(np.float32))
    with torch.no_grad():
        cls_logits, box_offsets = model(x)
    assert cls_logits.shape == (1, 24564, 80) and box_offsets.shape == (1, 24564, 4)
    assert cls_logits.dtype == torch.float32 and bool(torch.isfinite(cls_logits).all())


def test_train_refuses_a_batch_norm_backbone():
    """Training needs batch statistics, held against flax first."""
    from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset

    ref_cfg, cfg = small_configs()
    with pytest.raises(NotImplementedError, match="batch statistics"):
        loop.train(cfg, make_synthetic_dataset(num_images=2, image_size=SIZE), num_steps=1,
                   device="cpu")
