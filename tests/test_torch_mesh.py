"""Data-parallel training (``parallel/mesh.py``) on the CPU over gloo.

The ranks are processes that `parallel.mesh.spawn` starts (the spawn start
method; a process group over a file in a temporary directory, put under the
test's ``tmp_path``). They import this module, which imports no JAX at its
top, and each reports what it imported. Held here: the launch contract and
the reference's errors; the differentiable all-reduce; the DP-2 and DP-4
step of ``tiny_test`` (augmentation off and on) against the one-process
step on the concatenated batch and against the reference's step; the
ResNet families' DP-2 step in float64 with the BatchNorm moments of the
global batch, and per-rank moments missing the same bound; ``train()``
through the spawn path with rank-0 checkpoints and a resume bit for bit.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from object_detector_tpu_torch.anchors.priors import anchors_for_model
from object_detector_tpu_torch.convert import init_params
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.data.pipeline import DecodedCache
from object_detector_tpu_torch.data.synthetic import make_synthetic_dataset
from object_detector_tpu_torch.models.resnet import BatchNorm
from object_detector_tpu_torch.models.retinanet import build_model
from object_detector_tpu_torch.parallel import mesh as mesh_lib
from object_detector_tpu_torch.train.checkpoint import CheckpointManager
from object_detector_tpu_torch.train.loop import train
from object_detector_tpu_torch.train import state as state_lib
from object_detector_tpu_torch.train import step as step_lib
from object_detector_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

REFERENCE_MODULES = ("jax", "jaxlib", "flax", "optax", "object_detector_tpu")
# The one-process step's params against the reference's on tiny_test
# (test_torch_train_step.py::test_one_step_matches_reference): rtol, atol.
REFERENCE_PARAMS_TOL = (1e-5, 2e-6)
# The float64 class of the ResNet families' step tests
# (test_torch_resnet_train.py::assert_step_matches), by part.
FLOAT64_TOL = {"grads": (1e-4, 1e-4), "params": (1e-5, 2e-6), "ema": (1e-5, 2e-6),
               "stats": (1e-4, 1e-4)}
# The reference's dp8 bounds (tests/test_train_step.py:47-70) on params, and
# the same on the EMA.
DP_TOL = {"params": (0.0, 2e-5), "ema": (0.0, 2e-5)}


class _PerRankBatchNorm(BatchNorm):
    """BatchNorm on its own rank's rows: it drops the reduction the step
    hands it, as a data-parallel step without the BatchNorm all-reduce
    would."""

    all_reduce = property(lambda self: None, lambda self, value: None)


def _noise_batch(cfg, n):
    """``n`` images of the synthetic set, their pixels seeded noise under the
    same boxes (see test_torch_train_step._batch)."""
    s = cfg.model.image_size
    cache = DecodedCache(make_synthetic_dataset(num_images=n, image_size=s), s,
                         cfg.data.max_boxes, num_workers=1)
    batch = cache.gather(np.arange(n))
    batch["image"] = np.random.default_rng(0).integers(0, 256, batch["image"].shape,
                                                       dtype=np.uint8)
    return batch


def _step(case, mesh):
    """One step of ``case`` (cfg, weights or a seed, global host batch,
    augment, per-rank BatchNorm) on this rank's rows, or on the whole batch
    without a mesh: the global metrics, the (reduced) gradients the update
    was given, and the state after the step, on the CPU."""
    cfg, weights, batch, augment, per_rank = case
    grads = {}

    def recording_optimizer(train_cfg):
        update = state_lib.make_optimizer(train_cfg)

        def record(st, g, norm=None):
            grads.update({k: v.clone() for k, v in g.items()})
            update(st, g, norm)

        return record

    if isinstance(weights, int):
        weights = init_params(build_model(cfg), seed=weights, random_batch_stats=True).state_dict()
    model = build_model(cfg)
    if per_rank:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.__class__ = _PerRankBatchNorm
    st = create_train_state(cfg.train, weights)
    anchors = anchors_for_model(cfg.model.family, cfg.anchors, cfg.model.image_size)
    step_lib.make_optimizer = recording_optimizer
    try:
        fn = step_lib.make_train_step(cfg, model, anchors, device="cpu", augment=augment,
                                      mesh=mesh)
    finally:
        step_lib.make_optimizer = state_lib.make_optimizer
    rows = batch if mesh is None else mesh_lib.shard_batch(mesh, batch)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rows.items()}
    before = 0 if mesh is None else mesh.bytes_reduced
    st, metrics = fn(st, rows, torch.Generator().manual_seed(0))
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
           "params": {k: v.detach() for k, v in st.params.items()},
           "ema": st.ema_params, "stats": st.batch_stats,
           "bytes_a_step": 0 if mesh is None else mesh.bytes_reduced - before}
    if mesh is not None:
        out["ranks_bit_equal"] = _same_on_every_rank(
            mesh, [*st.params.values(), *st.batch_stats.values(), *st.ema_params.values()])
    return out


def _same_on_every_rank(mesh, tensors) -> bool:
    differ = 0
    for t in tensors:
        theirs = t.detach().clone()
        mesh.broadcast_(theirs)
        differ += int(not torch.equal(theirs, t))
    return int(mesh.all_reduce_(torch.tensor([differ])).item()) == 0


def _rank_cases(cases, checks_all_reduce):
    """Runs in each spawned rank: the DP step of every case, and on rank 0
    the one-process step on the whole batch (a per-rank case is held against
    its global case's), compared there leaf by leaf: each part's largest
    difference and whether every leaf is within the case's bounds."""
    mesh = mesh_lib.make_mesh(-1, "cpu")
    torch.set_num_threads(max(1, 4 // mesh.world))
    out, one = {}, {}
    for name, (cfg, weights, batch, augment, per_rank, tol) in cases.items():
        got = _step((cfg, weights, batch, augment, per_rank), mesh)
        if mesh.rank:
            continue
        # A per-rank case is held against its global case's one-process
        # step, a remat case against its plain case's.
        key = name.replace("-per_rank", "-global").replace("-remat", "")
        if key not in one:
            one[key] = _step((cfg, weights, batch, augment, False), None)
        want = one[key]
        out[name] = {
            "metrics": got["metrics"], "one_metrics": want["metrics"],
            "ranks_bit_equal": got["ranks_bit_equal"], "bytes_a_step": got["bytes_a_step"],
            "n_params": sum(v.numel() for v in want["params"].values()),
            "n_stats": len(want["stats"]),
            "parts": {part: {"max_abs": _worst(got[part], want[part]),
                             "close": _all_close(got[part], want[part], rtol, atol)}
                      for part, (rtol, atol) in tol.items()}}
        if name == "tiny-aug_off":
            out[name]["params"] = got["params"]
    if checks_all_reduce:
        out["all_reduce"] = _all_reduce_checks(mesh)
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules} & set(REFERENCE_MODULES))
    return out


def _all_close(got, want, rtol, atol) -> bool:
    return set(got) == set(want) and bool(want) and all(
        torch.allclose(got[k], want[k], rtol=rtol, atol=atol) for k in want)


def _worst(got, want) -> float:
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def _all_reduce_checks(mesh):
    """Rank r holds x_r = (r + 1) * [1, 2, 3] and takes the loss
    sum(w_r * all_reduce(x_r)) with w_r = r + 2: every rank's gradient of
    x_r is the sum of the w's."""
    r = mesh.rank
    x = (torch.arange(1.0, 4.0, dtype=torch.float64) * (r + 1)).requires_grad_(True)
    y = mesh.all_reduce(x)
    (gx,) = torch.autograd.grad((y * (r + 2)).sum(), x)
    parts = [torch.full((n,), float(r + 1)) for n in (3, 5, 7)] + [torch.ones(2, dtype=torch.int64)]
    before = mesh.bytes_reduced
    summed = mesh.all_reduce_buckets(parts, bucket_bytes=32)
    return {"y": y.detach(), "gx": gx, "buckets": summed,
            "bucket_bytes": mesh.bytes_reduced - before,
            "broadcast": mesh.broadcast_(torch.tensor([10.0 * r + 1.0])),
            "parts_untouched": all(torch.equal(p, torch.full((p.numel(),), float(r + 1)))
                                   for p in parts[:3])}


@pytest.fixture(autouse=True)
def _temporary_files_under(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


TINY = {"model.pool_grad_kernel": True, "train.ema_decay": 0.9}


def _tiny():
    return config.get_config("tiny_test").override(TINY)


def _ssd64_resnet():
    """The 64 px SSD/ResNet-50 of tests/test_torch_resnet.py."""
    from test_torch_resnet import small_configs

    return small_configs()[1]


@pytest.fixture(scope="module")
def tiny_weights():
    """tiny_test's weights from the reference's init, and the reference's
    variables, so that one set of DP runs is held against both sides."""
    import jax
    import jax.numpy as jnp

    from object_detector_tpu.core import config as ref_config
    from object_detector_tpu.models import ssd as ref_ssd
    from object_detector_tpu_torch.convert import flatten_tree, params_from_jax

    ref_cfg = ref_config.get_config("tiny_test").override(TINY)
    s = ref_cfg.model.image_size
    ref_model = ref_ssd.SSDModel(ref_cfg)
    variables = ref_model.init(jax.random.key(0), jnp.zeros((1, s, s, 3), jnp.float32), train=True)
    flat = {k: np.array(v) for k, v in flatten_tree(variables["params"]).items()}
    return params_from_jax(flat), ref_cfg, ref_model, variables


def _resnet_cases():
    step = {"train.warmup_steps": 0, "train.base_lr": 1e-2, "train.ema_decay": 0.9,
            "model.compute_dtype": "float64"}
    out = {}
    for family, cfg in (("ssd64_resnet", _ssd64_resnet()),
                        ("tiny_retinanet", config.tiny_retinanet_config())):
        cfg = cfg.override(step)
        batch = _noise_batch(cfg, 4)
        out[f"{family}-global"] = (cfg, 3, batch, False, False, FLOAT64_TOL)
    # Per-rank moments on one family show that the reduction is needed.
    out["ssd64_resnet-per_rank"] = (*out["ssd64_resnet-global"][:4], True, FLOAT64_TOL)
    return out


def _tiny_cases(weights, remat=False):
    batch = _noise_batch(_tiny(), 8)
    cases = {f"tiny-aug_{'on' if aug else 'off'}": (_tiny(), weights, batch, aug, False, DP_TOL)
             for aug in (False, True)}
    if remat:
        cfg = _tiny().override({"model.remat_block1": True})
        cases["tiny-aug_on-remat"] = (cfg, weights, batch, True, False, DP_TOL)
    return cases


@pytest.fixture(scope="module")
def runs(tiny_weights, tmp_path_factory):
    """Rank 0's reports of the DP-2 ranks (every case, and the all-reduce
    checks) and of the DP-4 ranks (tiny_test), both launched at once."""
    tiny = _tiny_cases(tiny_weights[0])
    resnet = _resnet_cases()
    remat = _tiny_cases(tiny_weights[0], remat=True)
    tempfile.tempdir = str(tmp_path_factory.mktemp("ranks"))
    try:
        with ThreadPoolExecutor(2) as pool:
            dp2 = pool.submit(mesh_lib.spawn, 2, "cpu", _rank_cases, ({**remat, **resnet}, True))
            dp4 = pool.submit(mesh_lib.spawn, 4, "cpu", _rank_cases, (tiny, False))
            return {2: dp2.result(), 4: dp4.result()}
    finally:
        tempfile.tempdir = None


def _close(got, want, rtol, atol, what):
    assert set(got) == set(want) and want, what
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol, msg=f"{what} {k}")


def _within(report, parts):
    for part in parts:
        assert report["parts"][part]["close"], (part, report["parts"][part]["max_abs"])


def test_multi_process_launch_contract(monkeypatch):
    """The counterpart of tests/test_multihost_mesh.py's: a process is
    launched when it carries torchrun's whole environment, a launch of one
    process included."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "29500"}
    for name in env:
        monkeypatch.delenv(name, raising=False)
    assert not mesh_lib._multi_process_launch()
    assert not mesh_lib.maybe_init_distributed("cpu") and not dist.is_initialized()
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert mesh_lib._multi_process_launch()
    for name in env:
        monkeypatch.delenv(name)
        assert not mesh_lib._multi_process_launch(), f"launched without {name}"
        monkeypatch.setenv(name, env[name])
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("RANK", "9")
    assert mesh_lib._multi_process_launch()
    assert mesh_lib.backend_for("cuda") == "nccl" and mesh_lib.backend_for("cpu") == "gloo"


def test_make_mesh_raises_the_reference_message():
    cores = len(os.sched_getaffinity(0))
    with pytest.raises(ValueError, match=f"requested {cores + 1}-way data parallelism but "
                                         f"only {cores} devices"):
        mesh_lib.make_mesh(cores + 1, "cpu")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {cards + 1}-way data parallelism but "
                                         f"only {cards} devices"):
        mesh_lib.make_mesh(cards + 1, "cuda")
    # Without a launch: -1 and 0 are one process on the CPU, and there is no
    # mesh; more than one process needs a launch.
    assert mesh_lib.make_mesh(-1, "cpu") is None and mesh_lib.make_mesh(0, "cpu") is None
    assert mesh_lib.world_size(-1, "cpu") == mesh_lib.world_size(1, "cpu") == 1
    assert mesh_lib.world_size(2, "cpu") == 2
    with pytest.raises(RuntimeError, match="2-way data parallelism takes a process a device"):
        mesh_lib.make_mesh(2, "cpu")


def test_batch_size_not_divisible_raises_the_reference_wording(tmp_path):
    """Before any process is spawned (the reference's train/loop.py:54-57)."""
    cfg = _tiny().override({"mesh.data_parallel": 2, "train.batch_size": 7})
    with pytest.raises(ValueError, match="global batch 7 not divisible by 2 devices"):
        train(cfg, make_synthetic_dataset(num_images=8, image_size=64), num_steps=1,
              checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    assert not os.path.exists(tmp_path / "ck")
    mesh = mesh_lib.Mesh(None, 1, 2, torch.device("cpu"))
    batch = {k: np.arange(12).reshape(4, 3) for k in ("image", "boxes", "labels", "valid")}
    rows = mesh_lib.shard_batch(mesh, batch)
    np.testing.assert_array_equal(rows["image"], batch["image"][2:])
    np.testing.assert_array_equal(rows["global_boxes"], batch["boxes"])
    with pytest.raises(ValueError, match="global batch 4 not divisible by 3 devices"):
        mesh_lib.shard_batch(mesh_lib.Mesh(None, 0, 3, torch.device("cpu")), batch)


def test_all_reduce_forward_and_backward_at_world_2(runs):
    got = runs[2]["all_reduce"]  # rank 0's
    torch.testing.assert_close(got["y"], torch.tensor([3.0, 6.0, 9.0], dtype=torch.float64))
    # d/dx_0 of sum_r (r + 2) * sum(all_reduce(x)) = 2 + 3.
    torch.testing.assert_close(got["gx"], torch.full((3,), 5.0, dtype=torch.float64))
    assert [b.tolist() for b in got["buckets"]] == [[3.0] * 3, [3.0] * 5, [3.0] * 7, [2, 2]]
    assert got["parts_untouched"]
    assert got["bucket_bytes"] == 4 * (3 + 5 + 7) + 8 * 2
    assert got["broadcast"].tolist() == [1.0]


def test_ranks_import_no_jax(runs):
    assert runs[2]["imported"] == runs[4]["imported"] == []


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("aug", ["off", "on"])
def test_dp_step_equals_one_process_step(runs, world, aug):
    """The reference's dp8 bounds (tests/test_train_step.py:47-70): loss
    within 1e-4 relative, params and EMA within 2e-5; the ranks bit-equal.
    With augmentation on, each rank draws for the global batch and applies
    its rows: the same draws as one process's."""
    got = runs[world][f"tiny-aug_{aug}"]
    assert got["ranks_bit_equal"]
    for k, v in got["one_metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert got["metrics"]["num_positives"] == got["one_metrics"]["num_positives"] >= 1
    _within(got, ("params", "ema"))
    # The gradients once (in buckets of 25 MB), the positive count and the
    # three loss metrics.
    assert got["bytes_a_step"] == 4 * got["n_params"] + 8 + 4 * 3


def test_dp_step_with_remat_block1_equals_one_process_step(runs):
    """model.remat_block1 under the data-parallel step: block 1 recomputed
    in each rank's backward (its parameters handed to the recompute, as the
    step lends them through functional_call), the DP-2 step with
    augmentation on within the dp8 bounds of one process's step without
    remat on the whole batch, the ranks bit-equal."""
    got = runs[2]["tiny-aug_on-remat"]
    assert got["ranks_bit_equal"]
    for k, v in got["one_metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    _within(got, ("params", "ema"))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_reference(runs, tiny_weights, world):
    """The DP step against the reference's make_train_step(mesh=None) on the
    concatenated batch, with test_one_step_matches_reference's tolerances
    (its own tests/test_train_step.py::test_dp8_matches_single_device ties
    that step to its sharded one)."""
    import jax
    import jax.numpy as jnp

    from object_detector_tpu.anchors import priors as ref_priors
    from object_detector_tpu.train import state as ref_state
    from object_detector_tpu.train import step as ref_step
    from object_detector_tpu_torch.convert import flatten_tree, names_to_jax

    _, ref_cfg, ref_model, variables = tiny_weights
    batch = _noise_batch(_tiny(), 8)
    anchors = ref_priors.ssd_anchors(ref_cfg.anchors, ref_cfg.model.image_size)
    ref_st = ref_state.create_train_state(ref_cfg.train, jax.tree.map(jnp.copy, variables))
    ref_fn = ref_step.make_train_step(ref_cfg, ref_model, anchors, augment=False)
    ref_st, want_metrics = ref_fn(ref_st, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.key(0))
    got = runs[world]["tiny-aug_off"]
    for k, v in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, err_msg=k)
    want_params = flatten_tree(ref_st.params)
    got_params = names_to_jax(got["params"])
    assert set(got_params) == set(want_params)
    rtol, atol = REFERENCE_PARAMS_TOL
    for k in want_params:
        np.testing.assert_allclose(got_params[k], want_params[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("family", ["ssd64_resnet", "tiny_retinanet"])
def test_resnet_dp_step_equals_one_process_float64(runs, family):
    """Two images a rank, float64 compute: the BatchNorm moments are the
    global batch's, so loss, gradients, params, EMA and all 106 running
    statistics equal the one-process step's within the float64 class of
    test_torch_resnet_train.py, and the ranks are bit-equal."""
    got = runs[2][f"{family}-global"]
    assert got["ranks_bit_equal"] and got["n_stats"] == 106
    for k, v in got["one_metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5 if k == "loss" else 1e-4,
                                   err_msg=k)
    _within(got, FLOAT64_TOL)


def test_per_rank_statistics_miss_the_bound(runs):
    """The same DP-2 step with each rank's BatchNorm on its own two images
    (no BatchNorm all-reduce; the loss normalizer and the gradients still
    reduced): its running statistics and gradients fall outside the bound
    the global step meets, so the reduction is what makes the step equal."""
    got, synced = runs[2]["ssd64_resnet-per_rank"], runs[2]["ssd64_resnet-global"]
    assert not got["ranks_bit_equal"]  # each rank keeps its own statistics
    for part in ("stats", "grads"):
        assert not got["parts"][part]["close"], part
        assert got["parts"][part]["max_abs"] > 100 * synced["parts"][part]["max_abs"], part


def test_train_spawns_ranks_and_resumes_bit_for_bit(tmp_path, monkeypatch):
    """train() at mesh.data_parallel=2 on the CPU spawns two gloo ranks.
    Rank 0 alone writes: each step's metrics line once, with imgs_per_sec_chip
    = imgs_per_sec / 2, and one file a kept checkpoint. Removing the last
    checkpoint and resuming from step 2 gives step 3 bit for bit: params,
    statistics, optimizer state, EMA and the logged loss."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    cfg = _tiny().override({"mesh.data_parallel": 2, "train.batch_size": 4,
                            "train.log_every": 1, "train.checkpoint_every": 2,
                            "data.num_workers": 1})
    ds = make_synthetic_dataset(num_images=12, image_size=64)
    ck = tmp_path / "ck"
    whole = train(cfg, ds, num_steps=3, checkpoint_dir=str(ck), device="cpu",
                  metrics_path=str(tmp_path / "a.jsonl"))
    assert whole.step == 3
    assert sorted(os.listdir(ck)) == ["step_2.pt", "step_3.pt"]
    rows = [json.loads(line) for line in open(tmp_path / "a.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert r["imgs_per_sec_chip"] == r["imgs_per_sec"] / 2 and r["imgs_per_sec"] > 0
    final = torch.load(ck / "step_3.pt", weights_only=True)
    os.remove(ck / "step_3.pt")
    resumed = train(cfg, ds, num_steps=3, checkpoint_dir=str(ck), device="cpu", resume=True,
                    metrics_path=str(tmp_path / "b.jsonl"))
    assert resumed.step == 3 and CheckpointManager(str(ck)).latest_step() == 3
    assert resumed.batch_stats == whole.batch_stats == {}
    for name in ("params", "ema_params"):
        _close(getattr(resumed, name), getattr(whole, name), 0.0, 0.0, name)
    for name in whole.opt_state:
        _close(resumed.opt_state[name], whole.opt_state[name], 0.0, 0.0, name)
    _close(torch.load(ck / "step_3.pt", weights_only=True)["params"], final["params"], 0.0, 0.0,
           "checkpoint")
    (row,) = [json.loads(line) for line in open(tmp_path / "b.jsonl")]
    assert row["step"] == 3 and row["loss"] == rows[-1]["loss"]
