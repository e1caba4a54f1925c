"""Port vs reference: the float RetinaNet/FPN model, its anchors, the
carrying across of its flax ``variables`` and its seeded init, on
`tiny_retinanet_config` (ResNet-50's depth and widths, 128 px, FPN and
heads of 32 channels), and the float serving entry points for the family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.data.pipeline import DecodedCache as RefDecodedCache
from object_detector_tpu.data.synthetic import make_synthetic_dataset as ref_synthetic
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.models import retinanet as ref_retinanet
from object_detector_tpu_torch.anchors import priors
from object_detector_tpu_torch.anchors.priors import retinanet_anchors
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import (
    flatten_tree, init_params, names_to_jax, params_from_jax, variables_from_jax,
)
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.eval import evaluator
from object_detector_tpu_torch.models import retinanet, ssd
from object_detector_tpu_torch.train import loop, step
from test_torch_resnet import _seeded_batch_norm

torch.set_num_threads(2)

SIZE = 128


def tiny_configs(head_depth=1):
    """(reference config, port config) of `tiny_retinanet_config` with
    ``head_depth`` convs a subnet."""
    return tuple(mod.tiny_retinanet_config().override({"model.head_depth": head_depth})
                 for mod in (ref_config, config))


def variables_at_depth(variables, head_depth):
    """flax ``variables`` of a model with ``head_depth`` convs a subnet, cut
    from those of a deeper one: the subnets' convs beyond the depth go."""
    params = {k: v for k, v in variables["params"].items()}
    for head in ("cls_head", "box_head"):
        params[head] = {k: v for k, v in params[head].items()
                        if k == "out" or int(k[len("conv"):]) < head_depth}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def tiny_variables(seed, head_depth=2):
    """flax ``variables`` of the tiny RetinaNet with ``head_depth`` convs a
    subnet: kernels from flax's init, every BatchNorm's parameters and
    statistics from a numpy seed."""
    ref_cfg, _ = tiny_configs(head_depth)
    model = ref_retinanet.RetinaNetModel(ref_cfg)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return {name: _seeded_batch_norm(jax.tree_util.tree_map(np.asarray, variables[name]), rng)
            for name in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def deep():
    """Variables of the tiny model at head depth 2 (one flax init serves
    both depths) and a seeded batch."""
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (2, SIZE, SIZE, 3)).astype(np.float32)
    return tiny_variables(seed=3), x


@pytest.mark.parametrize("head_depth", [1, 2])
def test_retinanet_model_matches_flax(deep, head_depth):
    """atol 2e-3, the reference's own band for this model
    (tests/test_quant.py:141); at depth 2 the subnets' weights are shared by
    all five levels twice over."""
    ref_cfg, cfg = tiny_configs(head_depth)
    variables = variables_at_depth(deep[0], head_depth)
    x = deep[1]
    model = ref_retinanet.RetinaNetModel(ref_cfg)
    want_cls, want_box = jax.jit(lambda v, i: model.apply(v, i, train=False))(
        variables, jnp.asarray(x))
    port = retinanet.build_model(cfg)
    assert isinstance(port, retinanet.RetinaNetModel)
    port.load_state_dict(variables_from_jax(variables))
    with torch.no_grad():
        got_cls, got_box = port.eval()(torch.from_numpy(x))
    n = priors.retinanet_anchors(SIZE).shape[0]
    assert got_cls.shape == (2, n, 3) and got_box.shape == (2, n, 4)
    assert got_cls.dtype == got_box.dtype == torch.float32
    assert float(np.abs(np.asarray(want_cls)).max()) > 1.0
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box), rtol=0, atol=2e-3)


def test_bfloat16_model_runs_and_stays_near_float32(deep):
    """The preset's compute dtype: finite float32 outputs near float32's."""
    _, cfg = tiny_configs(2)
    state = variables_from_jax(deep[0])
    outs = {}
    for dtype in ("float32", "bfloat16"):
        port = retinanet.RetinaNetModel(cfg.override({"model.compute_dtype": dtype}))
        port.load_state_dict(state)
        with torch.no_grad():
            outs[dtype] = port.eval()(torch.from_numpy(deep[1]))
    for got, want in zip(outs["bfloat16"], outs["float32"]):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert float((got - want).abs().mean()) < 0.1


def test_variables_round_trip_and_cover_the_state_dict(deep):
    variables = deep[0]
    _, cfg = tiny_configs(2)
    state = variables_from_jax(variables)
    port = retinanet.RetinaNetModel(cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    for key in ("fpn.lateral3.weight", "fpn.smooth5.bias", "fpn.p6.weight", "fpn.p7.bias",
                "cls_head.conv1.weight", "cls_head.out.bias", "box_head.out.weight",
                "backbone.stem_bn.running_var"):
        assert key in state, key
    assert tuple(state["cls_head.out.weight"].shape) == (9 * 3, 32, 3, 3)
    assert tuple(state["fpn.p6.weight"].shape) == (32, 2048, 3, 3)
    flat = {**flatten_tree(variables["params"]), **flatten_tree(variables["batch_stats"])}
    back = names_to_jax(state)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    assert set(params_from_jax(flatten_tree(variables["params"]))) == {
        k for k in state if "running_" not in k}


def test_init_params_puts_the_class_bias_on_the_cls_subnet_only(deep):
    """As the reference's init: -log(99) on cls_head.out, zero on every other
    bias of the FPN and heads (box_head.out too)."""
    _, cfg = tiny_configs(2)
    state = init_params(retinanet.RetinaNetModel(cfg), seed=0).state_dict()
    flax_init = variables_from_jax(deep[0])  # the flax init's biases
    zero = [k for k in state if k.endswith(".bias") and not k.startswith("backbone.")
            and k != "cls_head.out.bias"]
    assert "box_head.out.bias" in zero and "fpn.lateral3.bias" in zero and len(zero) == 13
    for tree in (state, flax_init):
        assert torch.all(tree["cls_head.out.bias"] == float(np.float32(ssd.CLASS_BIAS_INIT)))
        assert all(not tree[k].any() for k in zero)


@pytest.mark.parametrize("size", [128, 512])
def test_retinanet_anchors_bit_equal(size):
    got = priors.retinanet_anchors(size)
    np.testing.assert_array_equal(got, ref_priors.retinanet_anchors(size))
    cfg = config.retinanet_anchor_config(size)
    np.testing.assert_array_equal(priors.anchors_for_model("retinanet", cfg, size), got)
    assert got.shape == ({128: 3069, 512: 49104}[size], 4) and cfg.num_anchors == len(got)


def test_upsample2x_is_the_reference_s():
    x = np.random.default_rng(7).normal(0, 1, (2, 3, 5, 4)).astype(np.float32)
    want = ref_retinanet._upsample2x(jnp.asarray(x))
    got = retinanet.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ssd_model_refuses_the_family_and_training_refuses_it():
    """SSDModel refuses the family; training builds the family's own model
    and its train state carries the backbone's running statistics (the
    step itself: tests/test_torch_retinanet_train.py)."""
    _, cfg = tiny_configs()
    with pytest.raises(NotImplementedError, match="retinanet"):
        ssd.SSDModel(cfg)
    assert isinstance(retinanet.build_model(config.get_config("ssd300_vgg16_voc")), ssd.SSDModel)
    model, state = loop.init_model_state(cfg, seed=0, device="cpu")
    assert isinstance(model, retinanet.RetinaNetModel) and "fpn.p7.weight" in state.params
    assert len(state.batch_stats) == 106 and not any(k in state.params for k in state.batch_stats)
    assert all(torch.equal(v, torch.ones_like(v) if k.endswith("var") else torch.zeros_like(v))
               for k, v in state.batch_stats.items())
    step_fn = step.make_train_step(cfg, model, retinanet_anchors(SIZE), device="cpu")
    assert callable(step_fn.loss_fn)


# ---------------------------------------------------------------------------
# Float serving of the family
# ---------------------------------------------------------------------------

def _assert_detections_match(got, want, atol=1e-4):
    valid = got.valid.numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_predict_fn_matches_reference(deep, use_pallas):
    """uint8 images to detections: the plain per-class NMS, and the kernel
    path with the preset's prefilter (exact_prefilter=False, more anchors
    than 2 * pre_nms_top_k)."""
    ref_cfg, cfg = (c.override({"eval.nms_exact_prefilter": False}) for c in tiny_configs(1))
    variables = variables_at_depth(deep[0], 1)
    images = np.random.default_rng(9).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    anchors = priors.retinanet_anchors(SIZE)
    assert len(anchors) > 2 * cfg.eval.pre_nms_top_k
    model = ref_retinanet.RetinaNetModel(ref_cfg)
    want = ref_evaluator.make_predict_fn(ref_cfg, model, anchors, use_pallas)(
        variables, jnp.asarray(images))
    port = retinanet.build_model(cfg)
    port.load_state_dict(variables_from_jax(variables))
    got = evaluator.make_predict_fn(cfg, port, anchors, use_pallas, device="cpu")(images)
    _assert_detections_match(got, want)


def test_float_predictor_and_entry_points_default_to_cuda(deep):
    _, cfg = tiny_configs(1)
    state = variables_from_jax(variables_at_depth(deep[0], 1))
    predictor = Predictor(cfg, state, device="cpu")
    assert isinstance(predictor.model, retinanet.RetinaNetModel)
    scene = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    dets = predictor.predict_array(scene, score_threshold=0.0)
    assert 0 < len(dets) <= cfg.eval.max_detections
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(cfg, state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluator.make_predict_fn(cfg, retinanet.build_model(cfg), priors.retinanet_anchors(SIZE))


def test_float_sweep_matches_reference(deep):
    """`evaluate_dataset` builds the family's model: the COCO dict of the
    reference's sweep over 12 synthetic images at batch 8 (the last batch
    overlaps), within 1e-6."""
    ref_cfg, cfg = (c.override({"eval.map_style": "coco"}) for c in tiny_configs(1))
    variables = variables_at_depth(deep[0], 1)
    dataset = make_synthetic_dataset(num_images=12, image_size=SIZE, seed=5)
    ref_dataset = ref_synthetic(num_images=12, image_size=SIZE, seed=5)
    cache = DecodedCache(dataset, SIZE, cfg.data.max_boxes, 1)
    ref_cache = RefDecodedCache(ref_dataset, SIZE, ref_cfg.data.max_boxes, 1)
    want = ref_evaluator.evaluate_dataset(ref_cfg, ref_retinanet.RetinaNetModel(ref_cfg),
                                          variables, ref_dataset, cache=ref_cache)
    got = evaluator.evaluate_dataset(cfg, variables_from_jax(variables), dataset, cache=cache,
                                     device="cpu")
    assert set(got) == set(want) and {"mAP", "AP50", "AR100"} <= set(got)
    for key, value in want.items():
        assert np.isfinite(got[key]) and abs(got[key] - value) <= 1e-6, (key, got[key], value)
