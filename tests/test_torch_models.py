"""Port vs reference: the float SSD/VGG16 model and its parts, with flax
weights carried across by `params_from_jax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.models import ssd as ref_ssd
from object_detector_tpu.models import vgg as ref_vgg
from object_detector_tpu_torch.convert import flatten_tree, init_params, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.models import ssd, vgg

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_same_pads_follow_flax():
    assert vgg.same_pads(10, 3, 2, 1) == (0, 1)  # conv9_2: asymmetric
    assert vgg.same_pads(19, 3, 2, 1) == (1, 1)  # conv8_2
    assert vgg.same_pads(19, 3, 1, 6) == (6, 6)  # fc6, dilation 6
    assert vgg.same_pads(38, 1, 1, 1) == (0, 0)


def test_l2norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (2, 5, 5, 16)).astype(np.float32)
    module = ref_vgg.L2Norm(init_scale=20.0)
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    scale = rng.uniform(5, 25, 16).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale)}}
    want = module.apply(variables, jnp.asarray(x))
    port = vgg.L2Norm(16)
    port.scale.data = torch.from_numpy(scale)
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_extra_layers_match_reference_with_asymmetric_pad():
    """19 -> 10 -> 5 -> 3: the second stride-2 SAME conv pads (0, 1)."""
    blocks = ((8, 16, 2, "SAME"), (8, 16, 2, "SAME"), (8, 16, 1, "VALID"))
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.0, (2, 19, 19, 12)).astype(np.float32)
    module = ref_vgg.SSDExtraLayers(blocks=blocks, compute_dtype=jnp.float32)
    variables = module.init(jax.random.key(1), jnp.asarray(x))
    want = module.apply(variables, jnp.asarray(x))
    port = vgg.SSDExtraLayers(12, blocks)
    port.load_state_dict(params_from_jax(flatten_tree(variables["params"])))
    got = port(_nchw(x))
    assert [t.shape[2] for t in got] == [10, 5, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def _ref_and_port(name, seed, **overrides):
    ref_cfg = ref_config.get_config(name).override(overrides)
    port_cfg = config.get_config(name).override(overrides)
    s = ref_cfg.model.image_size
    ref_model = ref_ssd.SSDModel(ref_cfg)
    init = jax.jit(lambda k, x: ref_model.init(k, x, train=False))
    variables = init(jax.random.key(seed), jnp.zeros((1, s, s, 3), jnp.float32))
    port_model = ssd.SSDModel(port_cfg)
    port_model.load_state_dict(params_from_jax(flatten_tree(variables["params"])))
    return ref_model, variables, port_model.eval()


@pytest.mark.parametrize(
    "name,overrides,tol",
    [
        ("tiny_test", {}, 1e-4),
        # Full width, float32, batch 1: every level of SSD-300 (8732 anchors).
        ("ssd300_vgg16_voc", {"model.compute_dtype": "float32"}, 1e-3),
    ],
)
def test_ssd_model_matches_reference(name, overrides, tol):
    ref_model, variables, port_model = _ref_and_port(name, seed=2, **overrides)
    s = port_model.config.model.image_size
    batch = 2 if name == "tiny_test" else 1
    x = np.random.default_rng(3).normal(0, 1.0, (batch, s, s, 3)).astype(np.float32)
    want_cls, want_box = jax.jit(lambda v, i: ref_model.apply(v, i, train=False))(
        variables, jnp.asarray(x)
    )
    with torch.no_grad():
        got_cls, got_box = port_model(torch.from_numpy(x))
    num_anchors = port_model.config.anchors.num_anchors
    assert got_cls.shape == (batch, num_anchors, port_model.config.model.num_classes)
    assert got_box.shape == (batch, num_anchors, 4)
    assert got_cls.dtype == torch.float32 and got_box.dtype == torch.float32
    if name == "ssd300_vgg16_voc":
        assert num_anchors == 8732
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box), rtol=tol, atol=tol)


def test_params_from_jax_covers_the_state_dict():
    cfg = config.get_config("tiny_test")
    ref_cfg = ref_config.get_config("tiny_test")
    variables = ref_ssd.SSDModel(ref_cfg).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False
    )
    converted = params_from_jax(flatten_tree(variables["params"]))
    port = ssd.SSDModel(cfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want


def test_init_params_is_seeded_and_follows_the_reference_scheme():
    cfg = config.get_config("tiny_test")
    a = init_params(ssd.SSDModel(cfg), seed=4).state_dict()
    b = init_params(ssd.SSDModel(cfg), seed=4).state_dict()
    c = init_params(ssd.SSDModel(cfg), seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.conv1_1.weight"], c["backbone.conv1_1.weight"])
    assert torch.all(a["head0.cls.bias"] == torch.tensor(ssd.CLASS_BIAS_INIT))
    assert torch.all(a["head0.box.bias"] == 0)
    assert torch.all(a["l2norm.scale"] == 20.0)
    # lecun-normal: std sqrt(1 / fan_in), truncated at 2 std.
    w = a["backbone.conv3_1.weight"]
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("pack_block1", [False, True])
@pytest.mark.parametrize("remat_block1", [False, True])
def test_pack_and_remat_block1_are_accepted_and_change_nothing(pack_block1, remat_block1):
    """The reference's image-pair packing of block 1 (models/vgg.py:119) is
    accepted and ignored by the port, and its rematerialisation (:141-142)
    recomputes block 1 in the backward (models/vgg.py): every combination
    gives the same forward and the same gradients on tiny_test, bit for
    bit."""
    base_cfg = config.get_config("tiny_test")
    params = init_params(ssd.SSDModel(base_cfg), seed=6).state_dict()
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (2, 64, 64, 3)).astype(np.float32))

    def run(pack, remat):
        cfg = base_cfg.override({"model.pack_block1": pack, "model.remat_block1": remat})
        model = ssd.SSDModel(cfg)
        model.load_state_dict(params)
        cls, box = model(x)
        loss = cls.square().mean() + box.abs().mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return [cls.detach(), box.detach()], grads

    want_out, want_grads = run(False, False)
    got_out, got_grads = run(pack_block1, remat_block1)
    for g, w in zip(got_out + list(got_grads), want_out + list(want_grads)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pool_grad_kernel", [False, True])
def test_remat_block1_keeps_no_block1_activation_for_the_backward(pool_grad_kernel):
    """With model.remat_block1 the forward saves no activation of block 1
    for the backward: the bytes packed by autograd's saved-tensor hooks
    (torch.autograd.graph.saved_tensors_hooks) fall by at least conv1_1's
    and conv1_2's outputs, (B, 64, H, W) float32 each, and the gradients
    stay bit for bit the same, also through torch.func.functional_call with
    parameters other than the module's own (the train step's way)."""
    cfg = config.get_config("tiny_test").override({"model.pool_grad_kernel": pool_grad_kernel})
    x = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype(np.float32))
    lent = {k: v.detach().clone().requires_grad_(True)
            for k, v in init_params(ssd.SSDModel(cfg), seed=9).named_parameters()}
    runs = []
    for remat in (False, True):
        model = init_params(ssd.SSDModel(cfg.override({"model.remat_block1": remat})), seed=6)
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            cls, box = torch.func.functional_call(model, lent, (x,))
        loss = cls.square().mean() + box.abs().mean()
        runs.append((saved[0], torch.autograd.grad(loss, list(lent.values()))))
    (plain_bytes, plain_grads), (remat_bytes, remat_grads) = runs
    assert plain_bytes - remat_bytes >= 2 * (2 * 64 * 64 * 64 * 4)
    for a, b in zip(plain_grads, remat_grads):
        assert torch.equal(a, b)
