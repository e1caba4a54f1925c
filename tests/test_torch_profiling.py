"""Port vs reference: the profiling utilities (``utils/profiling.py``).

`trace` writes a Chrome/Perfetto trace and is a no-op for None; `StepTimer`
laps wall time with a device fence; `enable_debug_checks` raises
``FloatingPointError`` on the input on which the reference's
``jax_debug_nans`` raises, stays silent on a clean one, and its handle
leaves no global state behind."""

import glob
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_tpu.core import config as ref_config
from object_detector_tpu.models import ssd as ref_ssd
from object_detector_tpu.utils import profiling as ref_profiling
from object_detector_tpu_torch.convert import flatten_tree, params_from_jax
from object_detector_tpu_torch.core import config
from object_detector_tpu_torch.models import ssd
from object_detector_tpu_torch.train.state import TrainState
from object_detector_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_trace_writes_a_trace_and_none_is_a_noop(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert prof is not None
        conv(torch.ones(1, 3, 8, 8))
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    for off in (None, ""):
        with profiling.trace(off) as prof:
            assert prof is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace"]


def test_step_timer_laps_wall_time_with_and_without_a_fence():
    state = TrainState(step=1, params={"w": torch.ones(3)}, batch_stats={},
                       opt_state={}, ema_params=None)
    start = time.perf_counter()
    timer, laps = profiling.StepTimer(), []
    for result in (None, torch.ones(2), {"a": [1, (torch.zeros(1),)]}, (state, {}), "no tensor"):
        time.sleep(0.01)
        laps.append(timer.lap(result))
    time.sleep(0.01)
    laps.append(timer.lap(torch.ones(1), fence=False))
    total = time.perf_counter() - start
    # Each lap covers its own sleep, and the laps add up to the wall time.
    assert all(lap >= 0.01 for lap in laps) and sum(laps) <= total
    assert profiling._first_tensor((state, {})) is state.params["w"]
    # The reference's timer on the same results: the same contract.
    assert ref_profiling.StepTimer().lap(jnp.ones(2)) >= 0


@pytest.fixture(scope="module")
def tiny_models():
    ref_cfg, cfg = ref_config.get_config("tiny_test"), config.get_config("tiny_test")
    ref_model = ref_ssd.SSDModel(ref_cfg)
    variables = ref_model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    model = ssd.SSDModel(cfg).eval()
    model.load_state_dict(params_from_jax(flatten_tree(variables["params"])))
    return ref_model, variables, model


def _inputs():
    clean = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    bad = clean.copy()
    bad[0, 10, 20, 1] = np.nan
    return clean, bad


def test_debug_checks_raise_where_jax_debug_nans_raises(tiny_models):
    ref_model, variables, model = tiny_models
    clean, bad = _inputs()
    def forward(x):
        # The reference checks "every jitted output" (its enable_debug_checks),
        # on a program's first call: a call that JAX dispatches from its
        # cache of an earlier call, or op by op after other tests ran, was
        # seen to let the NaN through. So each input gets a program of its own.
        return jax.jit(lambda v, x: ref_model.apply(v, x, train=False))(variables, x)

    ref_profiling.enable_debug_checks()
    try:
        forward(jnp.asarray(clean))
        with pytest.raises(FloatingPointError):
            forward(jnp.asarray(bad))
    finally:
        jax.config.update("jax_debug_nans", False)

    handle = profiling.enable_debug_checks()
    try:
        with torch.no_grad():
            model(torch.from_numpy(clean))
            with pytest.raises(FloatingPointError, match="nan"):
                model(torch.from_numpy(bad))
    finally:
        handle.remove()


def test_debug_checks_catch_the_backward_and_undo_themselves(tiny_models):
    """Anomaly mode names the backward function that returned a NaN; the
    handle (here as a context manager) restores the anomaly mode and drops
    the forward hook, so the next forward on a NaN input runs through."""
    _, _, model = tiny_models
    _, bad = _inputs()
    hooks_before = dict(torch.nn.modules.module._global_forward_hooks)
    assert not torch.is_anomaly_enabled()
    with profiling.enable_debug_checks():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            x.sqrt().sum().backward()
    assert not torch.is_anomaly_enabled()
    assert dict(torch.nn.modules.module._global_forward_hooks) == hooks_before
    with torch.no_grad():
        cls_logits, _ = model(torch.from_numpy(bad))
    assert torch.isnan(cls_logits).any()
    profiling.enable_debug_checks(nans=False).remove()
    assert not torch.is_anomaly_enabled()
