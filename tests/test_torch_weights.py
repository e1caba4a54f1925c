"""Port vs reference: torchvision backbone import (``utils/weights.py``,
``cli/convert_weights.py``).

The source dicts are built from the canonical key and shape inventory, as
tests/test_weights.py builds them (no .pth is downloaded). The port's
converter CLI must write the reference CLI's .npz key for key and bit for
bit, the port's graft must give the reference's grafted variables bit for
bit, and a grafted full-width SSD-300 must serve the reference's
detections."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.cli import convert_weights as ref_cli
from object_detector_tpu.core import config as ref_config
from object_detector_tpu.eval import evaluator as ref_evaluator
from object_detector_tpu.models import retinanet as ref_models
from object_detector_tpu.utils import weights as ref_weights
from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.cli import convert_weights
from object_detector_tpu_torch.convert import (
    flatten_tree, init_params, names_to_jax, variables_from_jax,
)
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.eval.evaluator import make_predict_fn
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.utils import weights
from test_weights import _fake_state

torch.set_num_threads(2)

PRESET = {"vgg16": "ssd300_vgg16_voc", "resnet50": "ssd512_resnet50_coco"}
CASES = [(arch, head) for arch in ("vgg16", "resnet50") for head in (True, False)]


def _case_id(case):
    return f"{case[0]}-{'head' if case[1] else 'headless'}"


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Each arch's canonical dict (seed 0), and .pth files with and without
    the ImageNet head (removed after the module: VGG16's is 0.5 GB)."""
    root = tmp_path_factory.mktemp("weights")
    out = {}
    for arch in ("vgg16", "resnet50"):
        state = _fake_state(arch)
        for head in (True, False):
            kept = {k: v for k, v in state.items()
                    if head or not k.startswith(("classifier.", "fc."))}
            path = str(root / f"{arch}-{head}.pth")
            torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in kept.items()}, path)
            out[arch, head] = (kept, path)
    yield out
    shutil.rmtree(root)


@pytest.mark.parametrize("arch", ["vgg16", "resnet50"])
def test_inventory_and_validator_messages_equal_the_reference(arch):
    assert weights.torchvision_state_dict_shapes(arch) == \
        ref_weights.torchvision_state_dict_shapes(arch)
    state = _fake_state(arch, with_head=False, seed=4)
    weights.validate_torch_state_dict(state, arch, allow_missing_fc=True)
    first = next(iter(state))
    drifts = [
        (state, {}),  # strict: the head is missing
        ({**state, first: state[first][..., :1]}, {"allow_missing_fc": True}),
        ({**state, "features.99.weight": np.zeros(1, np.float32)}, {"allow_missing_fc": True}),
        ({k: v for k, v in state.items() if k != first}, {"allow_missing_fc": True}),
    ]
    for bad, kw in drifts:
        with pytest.raises(ValueError) as want:
            ref_weights.validate_torch_state_dict(bad, arch, **kw)
        with pytest.raises(ValueError) as got:
            weights.validate_torch_state_dict(bad, arch, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown arch 'vgg19'"):
        weights.torchvision_state_dict_shapes("vgg19")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_npz_equals_the_reference_cli_bit_for_bit(sources, tmp_path, case):
    arch, head = case
    _, src = sources[case]
    port_npz, ref_npz = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert convert_weights.main(["--backbone", arch, "--src", src, "--dst", port_npz]) == 0
    assert ref_cli.main(["--backbone", arch, "--src", src, "--dst", ref_npz]) == 0
    with np.load(port_npz) as got, np.load(ref_npz) as want:
        assert sorted(got.files) == sorted(want.files)
        assert any(k.startswith("stats:") for k in want.files) == (arch == "resnet50")
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # Either package's file loads in the other: the port reads the
    # reference's file into the reference's tree in the port's names.
    loaded = convert_weights.load_backbone_npz(ref_npz)
    ref_loaded = ref_cli.load_backbone_npz(port_npz)
    want = variables_from_jax({"params": ref_loaded["params"],
                               "batch_stats": ref_loaded["batch_stats"]})
    assert set(loaded) == set(want)
    for k in want:
        torch.testing.assert_close(loaded[k], want[k], rtol=0, atol=0, msg=k)
    assert convert_weights.unflatten_tree(flatten_tree(ref_loaded["params"])).keys() == \
        ref_cli.unflatten_tree(flatten_tree(ref_loaded["params"])).keys()
    os.remove(port_npz), os.remove(ref_npz)  # up to 90 MB each


def _port_init(arch, seed=0):
    cfg = config.get_config(PRESET[arch])
    return cfg, init_params(build_model(cfg), seed=seed,
                            random_batch_stats=arch == "resnet50").state_dict()


def _flax_variables(state_dict):
    flat = names_to_jax(state_dict)
    stats = {k: v for k, v in flat.items() if k.endswith(("/mean", "/var"))}
    params = {k: v for k, v in flat.items() if k not in stats}
    return {"params": ref_cli.unflatten_tree(params), "batch_stats": ref_cli.unflatten_tree(stats)}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_inject_equals_the_reference_graft_bit_for_bit(sources, case):
    """The port's graft into its init against variables_from_jax of the
    reference's graft into the same init: every entry bit for bit, the
    backbone's from the source, the rest (and a headless VGG's fc6/fc7)
    unchanged."""
    arch, head = case
    state, _ = sources[case]
    _, init = _port_init(arch)
    if arch == "vgg16":
        converted, (ref_params, ref_stats) = weights.vgg16_from_torch(state), (
            ref_weights.vgg16_from_torch(state), {})
    else:
        converted, (ref_params, ref_stats) = weights.resnet50_from_torch(state), \
            ref_weights.resnet50_from_torch(state)
    got = weights.inject_backbone(init, converted)
    variables = _flax_variables(init)
    want = variables_from_jax({
        "params": ref_weights.inject_backbone(variables["params"], ref_params),
        "batch_stats": (ref_weights.inject_backbone(variables["batch_stats"], ref_stats)
                        if ref_stats else variables["batch_stats"])})
    assert set(got) == set(want) == set(init)
    for k in want:
        assert got[k].dtype == init[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    moved = {k for k in init if not torch.equal(got[k], init[k])}
    assert moved == {f"backbone.{k}" for k in converted}
    assert ("backbone.fc6.weight" in moved) == (arch == "vgg16" and head)


def test_inject_raises_the_reference_errors():
    _, init = _port_init("vgg16")
    variables = _flax_variables(init)
    with pytest.raises(KeyError) as want:
        ref_weights.inject_backbone(variables["params"], {"conv9_9": {"kernel": np.zeros(1)}})
    with pytest.raises(KeyError) as got:
        weights.inject_backbone(init, {"conv9_9.weight": np.zeros(1)})
    assert str(got.value) == str(want.value) == \
        "\"backbone layer 'conv9_9' missing from model params\""
    with pytest.raises(ValueError, match=r"shape \(3, 3, 3, 99\) != model \(3, 3, 3, 64\)"):
        ref_weights.inject_backbone(variables["params"],
                                    {"conv1_1": {"kernel": np.zeros((3, 3, 3, 99), np.float32)}})
    with pytest.raises(ValueError, match=r"conv1_1.weight: shape \(99, 3, 3, 3\) != model "
                                         r"\(64, 3, 3, 3\)"):
        weights.inject_backbone(init, {"conv1_1.weight": np.zeros((99, 3, 3, 3), np.float32)})


def he_scaled_state(arch, seed=0):
    """A torchvision-layout dict from the inventory whose activations stay
    finite through the whole backbone: He-scaled weights, small biases,
    BatchNorm with scale near 1 and running statistics in range."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in weights.torchvision_state_dict_shapes(arch).items():
        if key.endswith("num_batches_tracked"):
            out[key] = np.asarray(100, np.int64)
        elif key.endswith("running_var"):
            out[key] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif key.endswith("running_mean") or (len(shape) == 1 and not key.endswith("weight")):
            out[key] = rng.normal(0, 0.05, shape).astype(np.float32)
        elif len(shape) == 1:  # a BatchNorm's scale
            out[key] = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(np.sqrt(2.0 / fan_in)))
    return out


def test_injected_ssd300_serves_the_reference_detections(tmp_path):
    """Full-width ssd300_vgg16_voc (float32) with a converted VGG16 (its
    classifier too) through the CLI's .npz, at bs=1 on the CPU: the port's
    make_predict_fn against the reference's on the reference's grafted
    variables, within the float predict tests' tolerances (valid and
    classes equal, scores and boxes 1e-4). Random heads give thousands of
    candidates within a few 1e-6 of each other, whose order float32
    rounding decides; the score threshold keeps the ~20 best, which lie
    1e-5 or more apart (the logits agree within about 1e-5)."""
    src, npz = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg16.npz")
    torch.save({k: torch.from_numpy(v) for k, v in he_scaled_state("vgg16").items()}, src)
    assert convert_weights.main(["--backbone", "vgg16", "--src", src, "--dst", npz]) == 0
    os.remove(src)
    overrides = {"model.compute_dtype": "float32", "eval.score_threshold": 0.18}
    cfg = config.get_config("ssd300_vgg16_voc").override(overrides)
    ref_cfg = ref_config.get_config("ssd300_vgg16_voc").override(overrides)
    init = init_params(build_model(cfg), seed=1).state_dict()
    state = weights.inject_backbone(init, convert_weights.load_backbone_npz(npz))
    ref_backbone = ref_cli.load_backbone_npz(npz)["params"]
    os.remove(npz)
    variables = _flax_variables(init)
    variables = {"params": ref_weights.inject_backbone(variables["params"], ref_backbone)}

    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    image = np.random.default_rng(2).integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    image[0, 80:220, 60:240] = (200, 60, 40)
    ref_model = ref_models.build_model(ref_cfg)
    want = ref_evaluator.make_predict_fn(ref_cfg, ref_model, anchors, False)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(image))
    model = build_model(cfg)
    model.load_state_dict(state)
    got = make_predict_fn(cfg, model, anchors, device="cpu")(image)
    valid = got.valid.numpy()
    assert valid.sum() > 10
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid], atol=1e-4)
