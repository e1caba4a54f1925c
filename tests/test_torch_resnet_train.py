"""Port vs reference: training with batch statistics on SSD/ResNet-50
(ResNet-50's own depth and widths at 64 px, seeded weights and BatchNorm
statistics). BatchNorm in training mode against flax's, one step against
the reference's ``make_train_step(augment=False)`` (loss, metrics, every
gradient leaf, the updated params and EMA, every updated running
statistic), ``loss_fn`` leaving the state as it was, and serving what was
trained: the entry points after a step, ``predict --checkpoint`` and
``evaluate --checkpoint`` in float and int8."""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from object_detector_tpu.anchors import priors as ref_priors
from object_detector_tpu.losses.detection import detection_loss as ref_detection_loss
from object_detector_tpu.models import retinanet as ref_models
from object_detector_tpu.ops import augment as ref_augment
from object_detector_tpu.train import state as ref_state
from object_detector_tpu.train import step as ref_step
from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.cli import main as cli
from object_detector_tpu_torch.cli.predictor import Predictor
from object_detector_tpu_torch.convert import (
    flatten_tree, init_params, names_to_jax, variables_from_jax,
)
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.eval import evaluator
from object_detector_tpu_torch.models import resnet
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.train import state, step
from object_detector_tpu_torch.train.checkpoint import CheckpointManager
from object_detector_tpu_torch.train.loop import init_model_state
from test_torch_resnet import SIZE, small_configs

torch.set_num_threads(2)

STEP_OVERRIDES = {"train.warmup_steps": 0, "train.base_lr": 1e-2, "train.ema_decay": 0.9}
# Step parity computes in float64 on both sides (float32 parameters,
# float32 loss): through some fifty training-mode BatchNorms the backward
# amplifies float32 rounding about 150-fold, so that the port's own float32
# gradients of the stem are 1% from its float64 ones on this config.
FLOAT64 = {"model.compute_dtype": "float64"}


# ---------------------------------------------------------------------------
# BatchNorm in training mode
# ---------------------------------------------------------------------------

def _batch_norm_case(dtype):
    """(x NHWC float32, flax params, flax batch_stats) with 16 channels over
    2 x 5 x 5 positions. Channel 0 sits far above its spread: 49 values of
    528 and one of 529 in float32 (532 in bfloat16, which cannot hold 529),
    where float32 E[x]^2 has an ulp of 1/32 and the fast variance is
    rounding noise: torch's E[x^2] - E[x]^2 is -1/32 there (the true
    variance is 0.0196), and without the clip the output would be NaN."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, (2, 5, 5, 16)).astype(np.float32)
    x[..., 0] = 528.0
    x[1, 4, 4, 0] = 529.0 if dtype == torch.float32 else 532.0
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.normal(0, 0.5, 16).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, 16).astype(np.float32),
             "var": rng.uniform(0.3, 3.0, 16).astype(np.float32)}
    return x, params, stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_training_follows_flax(dtype):
    """The output and both new running statistics against flax's
    ``nn.BatchNorm(use_running_average=False)``.

    Channels 1 to 15: in float32 the output within 1e-5 relative and
    absolute, in bfloat16 flax's value or its neighbour (both normalize in
    float32 and round once); the running statistics within 1e-6. Channel 0,
    where each framework's fast variance is its own rounding noise (XLA
    multiplies the sums by 1/n, torch divides): the running mean within
    1e-6, the running variance within 0.01 of flax's (0.1 times the noise of
    a few ulps of E[x]^2), the output finite; in float32 the port's batch
    variance is its clipped -1/32, so its running variance is exactly 0.9
    of the old one; in bfloat16 (true variance 0.3136) the output within 10%.
    The running variance is the biased one: torch's BatchNorm2d would keep
    0.002 more in channel 0, and 0.1 x 2% of the batch variance more in
    the others (n / (n - 1) with n = 50)."""
    x, params, stats = _batch_norm_case(dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    module = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdtype)
    want, updates = module.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x).astype(jdtype), mutable=["batch_stats"])
    want_stats = {k: np.asarray(v) for k, v in updates["batch_stats"].items()}
    port = resnet.BatchNorm(16)
    port.load_state_dict(variables_from_jax({"params": params, "batch_stats": stats}))
    port.train()
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1)
    assert got.dtype == dtype
    got_f, want_f = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got_f).all() and np.isfinite(want_f).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got_f[..., 1:], want_f[..., 1:], rtol=1e-5, atol=1e-5)
        x0 = xt[:, 0].float()
        assert float(x0.square().mean() - x0.mean().square()) == -1 / 32  # clipped to 0
        assert port.running_var[0] == torch.tensor(stats["var"][0]) * 0.9
    else:
        diff = np.abs(got_f - want_f)[..., 1:]
        assert (diff > 0).mean() < 0.02 and (diff <= np.abs(want_f[..., 1:]) * 2.0 ** -7).all()
        np.testing.assert_allclose(got_f[..., 0], want_f[..., 0], rtol=0.1)
    for name, leaf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(leaf[1:].numpy(), want_stats[name][1:], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_mean[0].item(), want_stats["mean"][0], rtol=1e-6)
    assert abs(port.running_var[0].item() - want_stats["var"][0]) <= 0.01
    unbiased = xt.float().var(dim=(0, 2, 3))
    biased_moved = port.running_var - torch.from_numpy(stats["var"]) * 0.9
    assert ((0.1 * unbiased - biased_moved)[1:] > 1e-4).all()


def test_batch_norm_eval_mode_uses_and_keeps_the_running_statistics():
    x, params, stats = _batch_norm_case(torch.float32)
    port = resnet.BatchNorm(16)
    port.load_state_dict(variables_from_jax({"params": params, "batch_stats": stats}))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port.eval()(xt)
    want = (xt - port.running_mean[:, None, None]) * torch.rsqrt(
        port.running_var[:, None, None] + 1e-5) * port.weight[:, None, None] + port.bias[:, None, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())


# ---------------------------------------------------------------------------
# One step against the reference
# ---------------------------------------------------------------------------

def unflatten(flat):
    tree = {}
    for path, value in flat.items():
        *scopes, leaf = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def seeded_variables(cfg, seed):
    """flax ``variables`` of the port's seeded init with every BatchNorm's
    parameters and statistics drawn from the seed (no flax init to
    compile)."""
    flat = names_to_jax(init_params(build_model(cfg), seed=seed,
                                    random_batch_stats=True).state_dict())
    stats = {k: v for k, v in flat.items() if k.endswith(("/mean", "/var"))}
    params = {k: v for k, v in flat.items() if k not in stats}
    return {"params": unflatten(params), "batch_stats": unflatten(stats)}


def noise_batch(cfg, n, seed=0):
    """``n`` images of the synthetic set at the config's size, their pixels
    seeded noise under the same boxes (see test_torch_train_step._batch)."""
    s = cfg.model.image_size
    cache = DecodedCache(make_synthetic_dataset(num_images=n, image_size=s), s,
                         cfg.data.max_boxes, num_workers=1)
    batch = cache.gather(np.arange(n))
    batch["image"] = np.random.default_rng(seed).integers(0, 256, batch["image"].shape,
                                                         dtype=np.uint8)
    return batch


def step_against_reference(ref_cfg, cfg, variables, batch, op_by_op=False):
    """One step of the reference's ``make_train_step(augment=False)`` and of
    the port's from the same variables and batch, with the reference's
    gradients from its own loss. ``op_by_op`` runs the reference under
    ``jax.disable_jit`` (see tests/test_torch_retinanet_train.py). Returns
    both sides' loss, metrics, gradients, params, EMA and batch_stats as
    flat numpy dicts in flax names, and the port's state before the
    step."""
    ref_model = ref_models.build_model(ref_cfg)
    anchors = ref_priors.anchors_for_model(ref_cfg.model.family, ref_cfg.anchors,
                                           ref_cfg.model.image_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_loss(params, batch_stats):
        images = ref_augment.normalize(jbatch["image"].astype(jnp.float32) / 255.0)
        targets = ref_step.encode_batch_targets(jbatch["boxes"], jbatch["labels"],
                                                jbatch["valid"], jnp.asarray(anchors), ref_cfg)
        (cls_logits, box_preds), _ = ref_model.apply(
            {"params": params, "batch_stats": batch_stats}, images, train=True,
            mutable=["batch_stats"])
        t = ref_cfg.train
        return ref_detection_loss(
            cls_logits, box_preds, targets.cls, targets.box, use_focal=t.use_focal,
            focal_alpha=t.focal_alpha, focal_gamma=t.focal_gamma, smooth_l1_beta=t.smooth_l1_beta,
            box_loss_weight=t.box_loss_weight, negatives_per_positive=t.negatives_per_positive)[0]

    with jax.enable_x64(ref_cfg.model.compute_dtype == "float64"), (
            jax.disable_jit() if op_by_op else contextlib.nullcontext()):
        want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss))(
            variables["params"], variables["batch_stats"])
        ref_st = ref_state.create_train_state(ref_cfg.train, jax.tree.map(jnp.asarray, variables))
        ref_fn = ref_step.make_train_step(ref_cfg, ref_model, anchors, augment=False)
        ref_st, want_metrics = ref_fn(ref_st, jbatch, jax.random.key(0))
    want = {"loss": float(want_loss), "metrics": {k: float(v) for k, v in want_metrics.items()},
            "grads": flatten_tree(want_grads), "params": flatten_tree(ref_st.params),
            "ema": flatten_tree(ref_st.ema_params) if ref_st.ema_params is not None else None,
            "batch_stats": flatten_tree(ref_st.batch_stats), "step": int(ref_st.step)}

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    st = state.create_train_state(cfg.train, variables_from_jax(variables))
    before = {name: {k: v.detach().clone() for k, v in tree.items()}
              for name, tree in (("params", st.params), ("batch_stats", st.batch_stats))}
    fn = step.make_train_step(cfg, build_model(cfg), anchors, device="cpu", augment=False)
    total, _, _ = fn.loss_fn(st.params, st.batch_stats, tbatch, seed=0)
    grads = dict(zip(st.params, torch.autograd.grad(total, list(st.params.values()))))
    st, metrics = fn(st, tbatch, torch.Generator().manual_seed(0))
    got = {"loss": float(total.detach()), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": names_to_jax(grads), "params": names_to_jax(st.params),
           "ema": names_to_jax(st.ema_params) if st.ema_params is not None else None,
           "batch_stats": names_to_jax(st.batch_stats), "step": st.step}
    return want, got, before


def assert_step_matches(want, got, part, params_atol=2e-6):
    """The tolerances of one step against the reference, by part. Loss and
    metrics: 1e-5 and 1e-4 relative. Gradients: rtol 1e-4 and atol 1e-4,
    the class of tests/test_torch_train_step.py. Params and EMA: rtol 1e-5
    and ``params_atol``; for sgd 2e-6, lr 1e-2 times a clipped gradient
    that agrees within 1e-4. Running statistics: 1e-4 relative and
    absolute."""
    if part == "loss":
        assert got["step"] == want["step"] == 1
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["metrics"]) == set(want["metrics"]) == {
            "loss", "cls_loss", "box_loss", "num_positives", "grad_norm"}
        assert want["metrics"]["num_positives"] >= 1
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
        return
    tol = {"grads": (1e-4, 1e-4), "params": (1e-5, params_atol), "ema": (1e-5, params_atol),
           "batch_stats": (1e-4, 1e-4)}[part]
    assert set(got[part]) == set(want[part])
    for k, v in want[part].items():
        np.testing.assert_allclose(got[part][k], v, rtol=tol[0], atol=tol[1], err_msg=k)


@pytest.fixture(scope="module")
def ssd_step():
    ref_cfg, cfg = (c.override({**STEP_OVERRIDES, **FLOAT64}) for c in small_configs())
    variables = seeded_variables(cfg, seed=3)
    return step_against_reference(ref_cfg, cfg, variables, noise_batch(cfg, 2))


@pytest.mark.parametrize("part", ["loss", "grads", "params", "ema", "batch_stats"])
def test_one_step_matches_reference(ssd_step, part):
    """sgd with momentum, weight decay, clipping and the EMA on."""
    want, got, _ = ssd_step
    assert_step_matches(want, got, part)


def test_one_step_moves_every_statistic_and_kernel(ssd_step):
    want, got, before = ssd_step
    stats = got["batch_stats"]
    assert len(stats) == 106  # 53 BatchNorms, mean and var each
    old = names_to_jax(before["batch_stats"])
    assert all(not np.array_equal(stats[k], old[k]) for k in stats)
    assert all((v >= 0).all() for k, v in stats.items() if k.endswith("/var"))
    old_params = names_to_jax(before["params"])
    assert all(not np.array_equal(got["params"][k], old_params[k])
               for k in got["params"] if k.endswith("kernel"))
    assert not any(k.endswith(("/mean", "/var")) for k in got["grads"])


def test_loss_fn_is_pure():
    """Calling loss_fn twice, then taking the step, gives the state of the
    step alone: loss_fn moves copies of the statistics, never the state's
    nor the model's, and leaves the model's mode as it was."""
    _, cfg = small_configs()
    cfg = cfg.override(STEP_OVERRIDES)
    batch = {k: torch.from_numpy(v) for k, v in noise_batch(cfg, 2).items()}
    anchors = anchors_for_model("ssd", cfg.anchors, SIZE)
    out = []
    for calls in (2, 0):
        st = state.create_train_state(cfg.train, init_params(
            build_model(cfg), seed=3, random_batch_stats=True).state_dict())
        model = init_params(build_model(cfg), seed=0).eval()
        own = {k: v.clone() for k, v in model.state_dict().items()}
        fn = step.make_train_step(cfg, model, anchors, device="cpu", augment=False)
        for _ in range(calls):
            before = {k: v.clone() for k, v in st.batch_stats.items()}
            total, _, new = fn.loss_fn(st.params, st.batch_stats, batch, seed=0)
            assert all(torch.equal(before[k], v) for k, v in st.batch_stats.items())
            assert not any(torch.equal(new[k], v) for k, v in st.batch_stats.items())
        st, _ = fn(st, batch, torch.Generator().manual_seed(0))
        assert not model.training
        assert all(torch.equal(own[k], v) for k, v in model.state_dict().items())
        out.append(st)
    for name in ("params", "batch_stats", "ema_params"):
        a, b = getattr(out[0], name), getattr(out[1], name)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), name


# ---------------------------------------------------------------------------
# Serving what was trained
# ---------------------------------------------------------------------------

def _same_detections(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_every_entry_point_serves_running_statistics_after_a_step():
    """After a training step on a model, make_predict_fn on that model,
    Predictor, evaluate_dataset and the int8 engine give the detections of
    the same state_dict served by a fresh model (or engine): the running
    statistics, not the batch's."""
    _, cfg = small_configs()
    cfg = cfg.override({**STEP_OVERRIDES, "eval.batch_size": 4, "eval.score_threshold": 0.0})
    anchors = anchors_for_model("ssd", cfg.anchors, SIZE)
    batch = {k: torch.from_numpy(v) for k, v in noise_batch(cfg, 2).items()}
    model = init_params(build_model(cfg), seed=3, random_batch_stats=True)
    st = state.create_train_state(cfg.train, model.state_dict())
    fn = step.make_train_step(cfg, model, anchors, device="cpu", augment=False)
    model.train()  # as a caller's own training loop may leave it
    st, _ = fn(st, batch, torch.Generator().manual_seed(0))
    served = {k: v.detach() for k, v in {**st.params, **st.batch_stats}.items()}
    model.load_state_dict(served)
    assert model.training
    images = np.random.default_rng(7).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)

    fresh = build_model(cfg)
    fresh.load_state_dict(served)
    predict_fresh = evaluator.make_predict_fn(cfg, fresh, anchors, device="cpu")
    want = predict_fresh(images)
    assert want.valid.any()
    got = evaluator.make_predict_fn(cfg, model, anchors, device="cpu")(images)
    assert _same_detections(got, want)
    assert all(torch.equal(served[k], v) for k, v in model.state_dict().items())
    dets = Predictor(cfg, served, device="cpu").predict_array(images[0], 0.0)
    want1 = predict_fresh(images[:1])
    assert [d.score for d in dets] == [float(s) for s, v in zip(want1.scores[0], want1.valid[0]) if v]

    calib = images[:2]
    want8 = evaluator.make_int8_predict_fn(cfg, served, anchors, calib, device="cpu")(images)
    model.train()
    got8 = evaluator.make_int8_predict_fn(cfg, model.state_dict(), anchors, calib,
                                          device="cpu")(images)
    assert _same_detections(got8, want8) and want8.valid.any()

    dataset = make_synthetic_dataset(num_images=4, image_size=SIZE)
    sweep = evaluator.evaluate_dataset(cfg, served, dataset, device="cpu")
    assert all(np.isfinite(v) for v in sweep.values())
    assert all(torch.equal(served[k], v) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def trained_retinanet(tmp_path_factory):
    """tiny RetinaNet cut from the preset through the CLI's own overrides,
    trained 3 steps with the EMA on: (argv of the shared flags, checkpoint
    dir, final state)."""
    ck = str(tmp_path_factory.mktemp("resnet_train") / "ck")
    flags = ["--preset", "retinanet_fpn_coco", "--device", "cpu"]
    for pair in ("model.image_size=128", "model.fpn_channels=32", "model.head_depth=1",
                 "mesh.data_parallel=1", "data.dataset=synthetic", "train.ema_decay=0.5",
                 "train.warmup_steps=0", "train.base_lr=0.01", "eval.batch_size=8",
                 "eval.max_detections=8", "data.num_workers=1"):
        flags += ["--set", pair]
    assert cli.main(["train", *flags, "--steps", "3", "--checkpoint", ck,
                     "--set", "train.batch_size=2"]) == 0
    cfg = cli._load_config(cli.build_parser().parse_args(["evaluate", *flags, "--checkpoint", ck]))
    _, st = init_model_state(cfg, seed=0, device="cpu")
    st = CheckpointManager(ck).restore(st, torch.Generator())[0]
    return flags, ck, cfg, st


def test_restore_serves_the_ema_params_with_the_non_ema_statistics(trained_retinanet):
    _, ck, cfg, st = trained_retinanet
    assert st.step == 3 and len(st.batch_stats) == 106
    served = cli._restore_variables(cfg, ck)
    assert set(served) == set(build_model(cfg).state_dict())
    for k, v in served.items():
        want = st.batch_stats[k] if k in st.batch_stats else st.ema_params[k]
        assert torch.equal(v, want), k
    assert not torch.equal(served["fpn.p7.weight"], st.params["fpn.p7.weight"].detach())
    assert not torch.equal(st.batch_stats["backbone.stem_bn.running_var"], torch.ones(64))


@pytest.mark.parametrize("int8", [False, True])
def test_predict_and_evaluate_checkpoint_serve_the_trained_model(trained_retinanet, tmp_path,
                                                                 capsys, int8):
    """``predict --checkpoint`` gives the detections of a Predictor on the
    restored state_dict; ``evaluate --checkpoint`` gives evaluate_dataset's
    COCO dict on it, of finite values."""
    from PIL import Image

    flags, ck, cfg, _ = trained_retinanet
    served = cli._restore_variables(cfg, ck)
    extra = ["--int8"] if int8 else []
    image = np.random.default_rng(12).integers(0, 60, (90, 120, 3), dtype=np.uint8)
    image[20:70, 30:100] = (220, 60, 60)
    path = tmp_path / "scene.png"
    Image.fromarray(image).save(path)
    capsys.readouterr()
    assert cli.main(["predict", *flags, "--image", str(path), "--checkpoint", ck,
                     "--score-threshold", "0.0", *extra]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    want = Predictor(cfg, served, device="cpu", int8=int8).predict_array(image, 0.0)
    assert len(lines) == len(want) > 0
    assert [d["score"] for d in lines] == [round(d.score, 4) for d in want]

    assert cli.main(["evaluate", *flags, "--checkpoint", ck, *extra]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dataset = make_synthetic_dataset(image_size=cfg.model.image_size)
    assert result == evaluator.evaluate_dataset(cfg, served, dataset, int8=int8, device="cpu")
    assert {"mAP", "AP50", "AR100"} <= set(result)
    assert all(np.isfinite(v) for v in result.values())
