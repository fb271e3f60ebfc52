"""The JAX package's last functions without a counterpart in the port, each
held against its JAX counterpart on the CPU.

``GBDT.get_training_score`` (gbdt.py:648, read by ``Booster``'s train score
and ``GBDT.eval_train``) on GBDT and DART, ``BinnedDataset.device_view``,
``ModelRegistry.request_width`` and ``early_stop_defaults`` on resident and
parked models, ``obs.launches.as_flat_dict`` and
``obs.recompile.as_flat_dict`` on the same counts,
``obs.hostmem.reset_high_water``, ``obs.profiling.trace_block``,
``obs.mfu.device_peaks`` and the level span's ``classes`` field
(``launches = levels * classes``, 1 class a level in the port, whose level
pass takes a level's windows in one launch).  Small data: 2,000 rows x 6
features, 63 bins, 15 leaves (``test_torch_boosters``' fixtures).
"""
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu import obs as jax_obs
from lightgbm_tpu.obs import hostmem as jax_hostmem
from lightgbm_tpu.obs import launches as jax_launches
from lightgbm_tpu.obs import mfu as jax_mfu
from lightgbm_tpu.obs import recompile as jax_recompile
from lightgbm_tpu.obs.registry import read_events
from lightgbm_tpu.serving import ModelRegistry as JRegistry
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.obs import hostmem, launches, mfu, profiling, recompile
from lightgbm_tpu_torch.serving import ModelRegistry
from test_torch_boosters import BASE, make_data
from test_torch_quant import one_thread  # noqa: F401
from test_torch_serving import carry
from test_torch_telemetry import toy_booster

CPU = "cpu"
# predictions and train scores of equal trees (test_torch_boosters)
SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    jax_obs.disable()
    yield
    obs.disable()
    jax_obs.disable()


# ---- GBDT.get_training_score ----

@pytest.mark.parametrize("booster", [
    dict(), dict(boosting="dart", drop_rate=0.5, skip_drop=0.0)],
    ids=["gbdt", "dart"])
def test_get_training_score_equals_jax(booster, one_thread):  # noqa: F811
    X, y = make_data("binary")
    params = dict(BASE, objective="binary", metric="binary_logloss",
                  **booster)
    ref = J.train(params, J.Dataset(X, y), num_boost_round=4,
                  verbose_eval=False)
    port = P.train(params, P.Dataset(X, y), num_boost_round=4,
                   verbose_eval=False, device=CPU)
    jb, pb = ref._booster, port._booster
    want = np.asarray(jb.get_training_score()[:, :jb.num_data])
    got = pb.get_training_score()
    assert got is pb.train_score and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=SCORE_ATOL)
    # eval_train and the Booster's train score read it
    (_, name, val, _), = pb.eval_train()
    (_, jname, jval, _), = jb.eval_train()
    assert name == jname and abs(val - jval) < SCORE_ATOL
    np.testing.assert_array_equal(port._flat_score("train"),
                                  got[0].double().numpy())


def test_get_training_score_is_what_eval_train_reads(one_thread):  # noqa
    X, y = make_data("binary")
    port = P.train(dict(BASE, objective="binary", metric="binary_logloss"),
                   P.Dataset(X, y), num_boost_round=2, verbose_eval=False,
                   device=CPU)
    b = port._booster
    before = b.eval_train()[0][2]

    class Shifted(type(b)):
        def get_training_score(self):
            return self.train_score + 1.0
    b.__class__ = Shifted
    assert b.eval_train()[0][2] != before
    assert not np.array_equal(port._flat_score("train"),
                              b.train_score[0].double().numpy())


# ---- BinnedDataset.device_view ----

def test_device_view_cached_and_equal_to_the_bins():
    X, y = make_data("binary")
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    jds = J.Dataset(X, y, params={"max_bin": 63}).construct().handle
    view = ds.device_view(CPU)
    assert view.device.type == "cpu" and ds.device_view("cpu") is view
    np.testing.assert_array_equal(view.numpy(), np.asarray(
        jds.device_view()))
    ds.binned = ds.binned.copy()          # a new matrix is a new view
    assert ds.device_view(CPU) is not view
    wide = BinnedDataset.from_matrix(
        np.random.RandomState(0).normal(size=(3000, 2)), max_bin=511,
        min_data_in_bin=1)
    assert wide.binned.dtype == np.uint16
    assert wide.device_view(CPU).dtype == torch.int32
    np.testing.assert_array_equal(wide.device_view(CPU).numpy(),
                                  wide.binned.astype(np.int32))


def test_device_view_follows_the_device_rule(monkeypatch):
    ds = BinnedDataset.from_matrix(*make_data("binary"), max_bin=63)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.device_view()


# ---- ModelRegistry.request_width and early_stop_defaults ----

@pytest.fixture(scope="module")
def registries():
    """The same two models in both packages' registries, the first parked
    (a budget that holds one model), the second resident; the second is
    binary, whose objective allows explicit early stopping."""
    X, y = make_data("binary")
    out = []
    for objective in ("regression", "binary"):
        knobs = dict(pred_early_stop=True, pred_early_stop_margin=2.5,
                     pred_early_stop_freq=4)
        jb = J.train(dict(BASE, objective=objective, **knobs),
                     J.Dataset(X, y), num_boost_round=3,
                     verbose_eval=False)._booster
        out.append((jb, carry(jb, **knobs)))
    one = ModelRegistry(budget_mb=0, device=CPU).register(
        "probe", out[0][1]).resident_bytes
    reg = ModelRegistry(budget_mb=one * 1.5 / (1 << 20), device=CPU)
    jreg = JRegistry(budget_mb=one * 1.5 / (1 << 20))
    layout = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    jlayout = J.Dataset(X, y, params={"max_bin": 63}).construct().handle
    for r, lay, k in ((reg, layout, 1), (jreg, jlayout, 0)):
        r.register("parked", out[0][k], layout_ds=lay)
        r.register("resident", out[1][k], layout_ds=lay)
    return reg, jreg


def test_registry_request_width_equals_jax(registries):
    reg, jreg = registries
    assert reg.resident_names() == ["resident"]
    assert reg.stats()["parked"] == ["parked"]
    for name in ("parked", "resident", "unknown"):
        for binned in (False, True):
            assert reg.request_width(name, binned) == jreg.request_width(
                name, binned), (name, binned)
    assert reg.request_width("resident") == 6
    assert reg.request_width("unknown", True) is None


def test_registry_early_stop_defaults_equal_jax(registries):
    reg, jreg = registries
    for name in ("parked", "resident", "unknown"):
        assert reg.early_stop_defaults(name) == jreg.early_stop_defaults(
            name), name
    assert reg.early_stop_defaults("resident") == ((2.5, 4), True)
    # a regression model: no early stopping, whatever its config says
    assert reg.early_stop_defaults("parked") == ((-1.0, 10), False)
    assert reg.early_stop_defaults("unknown") == ((-1.0, 10), False)


# ---- the flat forms of the launch and miss counters ----

def test_launches_as_flat_dict_equals_jax():
    launches.reset()
    jax_launches.reset()
    try:
        for mod in (launches, jax_launches):
            mod.record("level", 8, trees=2)
            mod.record("leaf", 14)
            mod.record("leaf", 14, trees=3)
        assert launches.as_flat_dict() == jax_launches.as_flat_dict() == {
            "leaf": 56, "level": 16}
        assert list(launches.as_flat_dict()) == ["leaf", "level"]
    finally:
        launches.reset()
        jax_launches.reset()


def test_recompile_as_flat_dict_equals_jax():
    saved, jsaved = recompile.counts(), jax_recompile.counts()
    recompile.reset()
    jax_recompile.reset()
    try:
        for mod in (recompile, jax_recompile):
            mod.record("predict_stack", "raw:0-3:k0:f32")
            mod.record("predict_stack", "raw:0-3:k0:f32", n=2)
            mod.record("kernels", "load")
        assert recompile.as_flat_dict() == jax_recompile.as_flat_dict() == {
            "kernels|load": 1, "predict_stack|raw:0-3:k0:f32": 3}
    finally:
        recompile.reset()
        jax_recompile.reset()
        for (fn, bucket), n in saved.items():
            recompile.record(fn, bucket, n)
        for (fn, bucket), n in jsaved.items():
            jax_recompile.record(fn, bucket, n)


def test_reset_high_water_equals_jax():
    for mod in (hostmem, jax_hostmem):
        mod.note()
        assert mod.high_water() > 0
        mod.reset_high_water()
        assert mod.high_water() == 0
        cur = mod.note()
        assert mod.high_water() == cur > 0


# ---- obs.profiling.trace_block and obs.mfu.device_peaks ----

def test_trace_block_writes_a_trace(tmp_path):
    out = str(tmp_path / "cap")
    with profiling.trace_block(out):
        torch.ones(64).sum()
    with open(os.path.join(out, profiling.TRACE_FILE)) as fh:
        assert "traceEvents" in json.load(fh)
    assert not profiling.profiler_running()


def test_trace_block_is_null_inside_another_profiler(tmp_path):
    out = str(tmp_path / "inner")
    with torch.profiler.profile():
        with profiling.trace_block(out) as got:
            torch.ones(8).sum()
    assert got is None and not os.path.exists(out)
    # and it never nests with a capture's process lock held
    assert profiling._process_lock.acquire(blocking=False)
    try:
        with profiling.trace_block(out) as got:
            pass
        assert got is None and not os.path.exists(out)
    finally:
        profiling._process_lock.release()


def test_device_peaks_none_on_the_cpu_as_jax():
    assert mfu.device_peaks(torch.device("cpu")) is None
    assert mfu.device_peaks("cpu") is None
    assert jax_mfu.device_peaks() is None          # the JAX CPU backend
    if not torch.cuda.is_available():
        assert mfu.device_peaks() is None


def test_device_peaks_the_card_row(monkeypatch):
    from lightgbm_tpu_torch.plan import device_specs
    monkeypatch.setattr(device_specs, "_current_kind_cache",
                        "nvidia h100 80gb hbm3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mfu.device_peaks() == {"bw": 3.35e12, "ops": 34e12 / 2,
                                  "kind": "nvidia h100 80gb hbm3"}
    assert mfu.device_peaks(torch.device("cpu")) is None


# ---- the level span's classes ----

def test_level_span_classes(tmp_path):
    out = str(tmp_path / "t.jsonl")
    obs.configure(out=out, freq=1)
    b, _, _ = toy_booster(num_iterations=2, max_depth=3,
                          tree_grow_mode="level", num_leaves=8)
    b.train()
    obs.disable()
    spans = [e for e in read_events(out)
             if e["kind"] == "span" and e["name"] == "tree_build"]
    assert len(spans) == 2
    learner = b.learner
    assert learner.level_classes() == 1
    assert learner.launches_per_tree() == (learner.level_count()
                                           * learner.level_classes())
    for s in spans:
        assert s["mode"] == "level" and s["classes"] == 1
        assert s["launches"] == s["levels"] * s["classes"] == 3


def test_level_launches_rule_equals_jax(monkeypatch):
    """The JAX learner's rule, launches = levels x classes (its classes
    the bucket classes of its schedule), and the port's on the same
    configuration: the same levels; the port's classes 1.  The JAX
    learner grows leaf-wise without its Pallas kernels, so its rule is
    read in level mode as it would be on its TPU."""
    X, y = make_data("binary")
    params = dict(BASE, objective="binary", tree_grow_mode="level",
                  max_depth=4)
    jb = J.Booster(params, J.Dataset(X, y))._booster
    pb = P.Booster(params, P.Dataset(X, y), device=CPU)._booster
    jl, pl = jb.learner, pb.learner
    monkeypatch.setattr(jl, "effective_grow_mode", lambda: "level")
    assert jl.launches_per_tree() == jl.level_count() * jl.level_classes()
    assert pl.launches_per_tree() == pl.level_count() * pl.level_classes()
    assert pl.level_count() == jl.level_count() == 4
    assert pl.level_classes() == 1
