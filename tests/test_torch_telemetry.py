"""The port's telemetry core (``lightgbm_tpu_torch/obs``) against the JAX
package's (``lightgbm_tpu/obs``), on the CPU.

Registry semantics, the JSONL schema (``validate_event``, torn final line),
``engine.train``'s per-iteration cadence, the summary artifact, the miss
gauge (``obs.recompile``: predictors stacked for new keys; flat across
steady predicts), run scoping of misses and host phases, the C ABI impls,
quantized-training and non-finite-guard counters, and split-pass
accounting (``obs.launches``: L-1 passes a leaf-wise tree, equal to the
JAX package's count on the same training, and equal to the calls of the
split-pass functions, which are the kernels' launches on the card).  The
same training through both packages gives event streams of the same kinds,
the same counters and the same iteration events.  With telemetry off, the
hot loops make zero telemetry calls (the spy of
``tests/test_telemetry.py``).
"""
import json
import threading
import time

import numpy as np
import pytest

from lightgbm_tpu import obs as jax_obs
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.obs import launches
from lightgbm_tpu_torch.obs.registry import (EVENT_SCHEMA_VERSION, Histogram,
                                             MetricsRegistry, Telemetry,
                                             read_events, validate_event)
from test_torch_quant import one_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    jax_obs.disable()
    yield
    obs.disable()
    jax_obs.disable()


def toy_booster(n=2048, num_iterations=8, seed=0, **params):
    """``tests/test_telemetry.py``'s ``_toy_booster`` for the port."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    y = X[:, 0] * 1.5 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=n)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=16)
    params = dict(dict(num_leaves=15, min_data_in_leaf=5), **params)
    cfg = Config(objective="regression", num_iterations=num_iterations,
                 verbosity=-1, **params)
    obj = create_objective("regression", cfg, device=CPU)
    return create_boosting(cfg.boosting, cfg, ds, obj, device=CPU), X, y


def regression_data(n=600, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    return X, X[:, 0] + rng.normal(scale=0.1, size=n)


# ---- registry semantics and the JSONL schema ----

def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    reg.gauge("g").set(7.0)
    h = reg.histogram("h")
    for v in range(100):
        h.observe(float(v))
    s = h.summary()
    assert reg.counter("c").value == 5 and reg.gauge("g").value == 7.0
    assert s["count"] == 100 and s["min"] == 0.0 and s["max"] == 99.0
    assert s["p50"] == pytest.approx(50.0, abs=1.0)
    assert s["p99"] == pytest.approx(98.0, abs=1.0)
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 5 and snap["gauges"]["g"] == 7.0
    assert snap["histograms"]["h"]["count"] == 100
    empty = Histogram()
    assert empty.summary() == {"count": 0, "sum": 0.0}
    empty.observe(3.0)
    assert empty.summary()["p99"] == 3.0


def test_jsonl_schema_roundtrip(tmp_path):
    path = str(tmp_path / "tele.jsonl")
    tele = Telemetry(out=path, freq=3, meta={"entry": "test"})
    tele.event("iteration", iteration=1, dt_s=0.5)
    with tele.time_block("timed"):
        pass
    tele.close()
    events = read_events(path)
    assert [e["kind"] for e in events] == ["run_start", "iteration", "timed"]
    for e in events:
        assert e["v"] == EVENT_SCHEMA_VERSION
        validate_event(e)
    # the JAX package reads the port's stream (one schema)
    from lightgbm_tpu.obs.registry import read_events as jax_read
    assert jax_read(path) == events


@pytest.mark.parametrize("bad", [
    {"ts": 1.0, "kind": "x"}, {"v": 1, "ts": "no", "kind": "x"},
    {"v": 1, "ts": 1.0, "kind": ""}, {"v": 1, "ts": 1.0, "kind": "x",
                                      "f": [1]}],
    ids=["no_version", "ts", "kind", "non_scalar"])
def test_jsonl_schema_rejects_bad_events(bad):
    with pytest.raises(ValueError):
        validate_event(bad)


def test_torn_final_line_dropped_midfile_corruption_raises(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "ts": 1.0, "kind": "ok"}\nnot json\n'
                   '{"v": 1, "ts": 2.0, "kind": "ok"}\n')
    with pytest.raises(ValueError):
        read_events(str(bad))
    torn = tmp_path / "torn.jsonl"
    torn.write_text('{"v": 1, "ts": 1.0, "kind": "ok"}\n{"v": 1, "ts": 2.')
    assert [e["kind"] for e in read_events(str(torn))] == ["ok"]


# ---- engine.train: cadence, ownership, and the JAX run's events ----

@pytest.mark.parametrize("freq,expected", [(1, 10), (2, 5), (3, 3)])
def test_engine_train_iteration_cadence(tmp_path, freq, expected):
    X, y = regression_data()
    out = str(tmp_path / "t.jsonl")
    P.train({"objective": "regression", "num_leaves": 7,
             "min_data_in_leaf": 5, "verbosity": -1, "telemetry_out": out,
             "telemetry_freq": freq}, P.Dataset(X, y), num_boost_round=10,
            device=CPU)
    events = read_events(out)
    assert sum(e["kind"] == "iteration" for e in events) == expected
    with open(out + ".summary.json") as fh:
        summary = json.load(fh)
    assert summary["iterations"] == 10
    assert summary["value"] is not None and summary["value"] > 0
    assert obs.active() is None


def test_engine_train_events_equal_jax(tmp_path, one_thread):
    """The same training through both packages' ``train`` with
    ``telemetry_out``: the event kinds, the counters, the iteration events
    and the split-pass accounting agree."""
    import lightgbm_tpu as J
    X, y = regression_data()
    params = {"objective": "regression", "num_leaves": 7,
              "min_data_in_leaf": 5, "verbosity": -1, "telemetry_freq": 2,
              "max_bin": 63}
    out, jout = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    P.train(dict(params, telemetry_out=out),
            P.Dataset(X, y, params={"max_bin": 63}), 6, device=CPU)
    J.train(dict(params, telemetry_out=jout),
            J.Dataset(X, label=y, params={"max_bin": 63}), 6)
    ev, jev = read_events(out), read_events(jout)
    kinds = {e["kind"] for e in ev}
    # the plan provenance and MFU events included
    assert kinds == {e["kind"] for e in jev}
    for k in ("iteration", "run_start", "run_end"):
        assert (sum(e["kind"] == k for e in ev)
                == sum(e["kind"] == k for e in jev)), k
    with open(out + ".summary.json") as a, open(jout + ".summary.json") as b:
        s, js = json.load(a), json.load(b)
    assert s["counters"] == js["counters"]
    assert s["tree_kernel_launches"] == js["tree_kernel_launches"]
    assert s["iterations"] == js["iterations"] == 6
    assert s["rows"] == js["rows"] == 600


def test_engine_train_closes_run_on_exception(tmp_path):
    def bad_fobj(score, ds):
        raise RuntimeError("user objective blew up")

    X, y = regression_data(400)
    out = str(tmp_path / "aborted.jsonl")
    with pytest.raises(RuntimeError):
        P.train({"objective": "none", "num_leaves": 7, "verbosity": -1,
                 "telemetry_out": out}, P.Dataset(X, y), 3, fobj=bad_fobj,
                device=CPU)
    assert obs.active() is None
    for e in read_events(out):
        validate_event(e)


def test_engine_train_records_into_a_caller_run():
    """A run the caller configured is recorded into and left open, and
    ``Booster.telemetry_summary`` reads it."""
    X, y = regression_data()
    tele = obs.configure(freq=1)
    b = P.train({"objective": "regression", "num_leaves": 7,
                 "verbosity": -1}, P.Dataset(X, y), 3, device=CPU)
    assert obs.active() is tele
    s = b.telemetry_summary()
    assert s["iterations"] == 3 and s["counters"]["trees_built"] == 3
    obs.disable()
    assert b.telemetry_summary() is None


def test_summary_artifact_contents(tmp_path):
    out = str(tmp_path / "run.jsonl")
    tele = obs.configure(out=out, freq=1, entry="test")
    booster, X, _ = toy_booster(num_iterations=6, snapshot_freq=2,
                                snapshot_keep=0)
    booster.train(snapshot_out=str(tmp_path / "model.txt"))
    booster.predict(X[:600])
    from lightgbm_tpu_torch.obs.report import finalize_run, human_table
    summary = finalize_run(tele, gbdt=booster, wall_s=1.0,
                           iters=int(booster.iter_))
    for e in read_events(out):
        validate_event(e)
    # one rate a chunk: train() cuts its 6 iterations at snapshot_freq=2
    # into 3 fused chunks, as the JAX package's driver does
    assert summary["rows_per_s"]["count"] == 3
    assert "TreeLearner::Train" in summary["host_phases"]
    assert "GBDT::TrainChunk" in summary["host_phases"]
    assert summary["histograms"]["checkpoint_write_s"]["count"] == 3
    assert "predict_dispatch_s_bucket_1024" in summary["histograms"]
    # the first chunk of length 2 is the fused path's one miss
    assert summary["recompiles"] == {"predict_stack|raw:0-6:k0:exact": 1,
                                     "fused_train|k=2": 1}
    res = summary["resilience"]
    assert res["preemptions"] == 0 and res["io_retries"] == 0
    assert res["checkpoint_skipped"] == 0
    # the driver's gauges win over finalize_run's wall_s argument
    assert summary["wall_s"] != 1.0
    assert summary["value"] == pytest.approx(
        booster.num_data * booster.iter_ / summary["wall_s"])
    # the cost model's shares are None on the CPU (no peaks), never zeros;
    # its byte and accumulation counts are recorded; the plan block says
    # the trees ran under the analytic plan; no engine, no capture armed
    assert summary["mfu"] is None and summary["device_util"] is None
    assert summary["gauges"]["est_bytes"] > 0
    assert summary["gauges"]["est_macs"] > 0
    assert summary["plan"]["provenance"] == "analytic"
    for key in ("alerts", "profiling"):
        assert key not in summary
    # the card's memory is absent on a CPU run
    assert "devmem" not in summary
    assert "feature_importance" in summary
    text = human_table(summary)
    assert "row-trees/s" in text and "recompiles (total)" in text
    kinds = {e["kind"] for e in read_events(out)}
    assert {"train_chunk", "checkpoint_write", "predict", "span",
            "compile", "recompile", "run_end"} <= kinds


# ---- the miss gauge (obs.recompile) ----

def test_misses_flat_across_steady_predicts():
    """A stacked predictor is the port's miss: one per new key, none for
    predicts of any size on a fixed model."""
    booster, X, _ = toy_booster(num_iterations=4)
    booster.train()
    booster.predict(X[:600])
    obs.recompile.reset()
    for n in (600, 700, 1024, 2048, 600):
        booster.predict(X[:n])
    booster.predict(X[:600], num_iteration=2)
    assert obs.recompile.counts() == {
        ("predict_stack", "raw:0-2:k0:exact"): 1}
    booster.predict(X[:600], num_iteration=2)
    assert obs.recompile.total("predict_stack") == 1


def test_recompile_record_attribution():
    obs.recompile.reset()
    obs.recompile.record("fn_x", 128)
    obs.recompile.record("fn_x", 1024, 2)
    obs.recompile.record("fn_y", 128)
    assert obs.recompile.counts() == {("fn_x", "128"): 1,
                                      ("fn_x", "1024"): 2,
                                      ("fn_y", "128"): 1}
    assert obs.recompile.total("fn_x") == 3 and obs.recompile.total() == 4
    obs.recompile.reset()
    assert obs.recompile.total() == 0


def test_recompiles_and_host_phases_scoped_per_run():
    from lightgbm_tpu_torch.obs.report import summarize
    from lightgbm_tpu_torch.utils.timer import global_timer
    obs.recompile.record("fn_scoped", "b1")
    global_timer.start("phase_scoped")
    time.sleep(0.02)
    global_timer.stop("phase_scoped")
    tele1 = obs.configure(freq=1)
    obs.recompile.record("fn_scoped", "b1", 2)
    s1 = summarize(tele1)
    assert s1["recompiles"].get("fn_scoped|b1") == 2
    assert "phase_scoped" not in s1["host_phases"]
    tele2 = obs.configure(freq=1)
    s2 = summarize(tele2)
    assert "fn_scoped|b1" not in s2["recompiles"]
    assert s2["recompile_total"] == 0
    obs.recompile.reset()
    obs.recompile.record("fn_scoped", "b1")
    assert summarize(tele2)["recompiles"].get("fn_scoped|b1") == 1
    global_timer.start("phase_scoped")
    time.sleep(0.02)
    global_timer.stop("phase_scoped")
    assert 0.01 < summarize(tele2)["host_phases"]["phase_scoped"] < 1.0


def test_resumed_run_iterations_not_inflated(tmp_path):
    from lightgbm_tpu_torch.checkpoint import load_checkpoint
    b1, _, _ = toy_booster(num_iterations=4, snapshot_freq=2,
                           snapshot_keep=0, metric_freq=10)
    prefix = str(tmp_path / "m.txt")
    b1.train(snapshot_out=prefix)
    meta, arrays, model_str = load_checkpoint(prefix + ".ckpt_iter_2")
    b2, _, _ = toy_booster(num_iterations=4, snapshot_freq=2,
                           snapshot_keep=0, metric_freq=10)
    b2.restore_train_state(meta, arrays, model_str)
    tele = obs.configure(freq=1)
    b2.train(None)
    assert b2.iter_ == 4
    assert tele.gauge("train_iterations").value == 2


# ---- zero telemetry calls when off ----

def test_telemetry_off_hot_loop_makes_zero_calls(monkeypatch, tmp_path):
    """With telemetry off, training (exact and quantized, GOSS and DART),
    predicts (raw, binned, contributions), a serving round trip, a span and
    a retried I/O fault make no telemetry call and start no listener."""
    calls = []

    def spy(name):
        orig = getattr(Telemetry, name)

        def wrapper(self, *a, **k):
            calls.append((name, a))
            return orig(self, *a, **k)
        return wrapper

    for name in ("event", "counter", "gauge", "histogram", "time_block"):
        monkeypatch.setattr(Telemetry, name, spy(name))
    from lightgbm_tpu_torch.obs import compile as obs_compile
    from lightgbm_tpu_torch.obs import devmem as obs_devmem
    from lightgbm_tpu_torch.obs import exporter as obs_exporter
    from lightgbm_tpu_torch.obs import quality as obs_quality
    from lightgbm_tpu_torch.obs import spans as obs_spans
    monkeypatch.setattr(obs_spans, "record_span",
                        lambda *a, **k: calls.append(("record_span", a)))
    monkeypatch.setattr(obs_spans.Span, "__init__",
                        lambda self, *a, **k: calls.append(("Span", a)))
    monkeypatch.setattr(obs_exporter, "start_exporter",
                        lambda *a, **k: calls.append(("start_exporter", a)))
    monkeypatch.setattr(obs_quality.QualityMonitor, "__init__",
                        lambda self, *a, **k: calls.append(("monitor", a)))
    monkeypatch.setattr(obs_quality.QualityBaseline, "from_model",
                        classmethod(lambda cls, *a, **k:
                                    calls.append(("baseline", a))))
    monkeypatch.setattr(obs_compile, "note_dispatch",
                        lambda *a, **k: calls.append(("compile", a)))
    monkeypatch.setattr(obs_devmem, "sample",
                        lambda *a, **k: calls.append(("devmem", a)))
    assert obs.active() is None
    booster, X, _ = toy_booster(num_iterations=4)
    booster.train()
    qb, _, _ = toy_booster(n=512, num_iterations=2,
                           hist_precision="quantized")
    qb.train()
    for boosting in ("goss", "dart"):
        b, _, _ = toy_booster(n=512, num_iterations=3, boosting=boosting,
                              learning_rate=0.5)
        b.train()
    booster.predict(X[:600])
    booster.predict_binned(booster.train_data)
    booster.predict_contrib(X[:64])
    from lightgbm_tpu_torch.serving import Server
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("spy", booster)
        srv.predict("spy", X[:8])
    assert not any(t.name == "lgbm-tpu-metrics"
                   for t in threading.enumerate())
    with obs_spans.span("noop"):
        pass
    import errno

    from lightgbm_tpu_torch.utils import file_io
    state = {"n": 0}

    def eio_once(stage, path):
        if stage == "written" and state["n"] == 0:
            state["n"] += 1
            raise OSError(errno.EIO, "injected")

    file_io.set_fault_hook(eio_once)
    try:
        file_io.atomic_write(str(tmp_path / "t.txt"), "x")
    finally:
        file_io.set_fault_hook(None)
    assert state["n"] == 1
    assert calls == [], calls[:5]


def test_telemetry_off_no_events_leak():
    booster, _, _ = toy_booster(num_iterations=4)
    booster.train()
    tele = obs.configure(freq=1)
    assert [e["kind"] for e in tele.events] == ["run_start"]


# ---- the C ABI impls ----

def test_c_api_telemetry_impls(tmp_path):
    from lightgbm_tpu_torch.c_api import (_impl_telemetry_configure,
                                          _impl_telemetry_disable,
                                          _impl_telemetry_recompile_count,
                                          _impl_telemetry_summary)
    assert _impl_telemetry_summary() == ""
    _impl_telemetry_configure(str(tmp_path / "capi.jsonl"), 2)
    tele = obs.active()
    assert tele is not None and tele.freq == 2
    tele.gauge("train_rows").set(10)
    s = json.loads(_impl_telemetry_summary())
    assert s["metric"] == "telemetry_run" and s["rows"] == 10
    assert _impl_telemetry_recompile_count() == obs.recompile.total()
    _impl_telemetry_disable()
    assert obs.active() is None and _impl_telemetry_summary() == ""


# ---- quantized training, non-finite guards, GOSS and DART ----

def test_quant_telemetry_counters(tmp_path):
    out = str(tmp_path / "q.jsonl")
    tele = obs.configure(out=out, freq=1)
    booster, _, _ = toy_booster(n=512, num_iterations=4,
                                hist_precision="quantized")
    booster.train()
    # nothing is evaluated, so train() runs the 4 iterations as one fused
    # chunk (the JAX test's train_chunk(4), tests/test_telemetry.py:580)
    assert tele.counter("quant_chunks").value == 1
    assert tele.counter("quant_iters").value == 4
    assert tele.gauge("quant_grad_levels").value == 127
    assert tele.gauge("quant_hess_levels").value == 255
    assert tele.gauge("quant_hist_channels").value == 2
    from lightgbm_tpu_torch.obs.report import finalize_run, human_table
    summary = finalize_run(tele, gbdt=booster)
    q = summary["quant"]
    assert q["iterations"] == 4 and q["grad_levels"] == 127
    assert "quant:" in human_table(summary)
    assert any(e["kind"] == "quant" and e["exact_channels"] == 4
               for e in read_events(out))
    tele2 = obs.configure(freq=1)
    b2, _, _ = toy_booster(n=512, num_iterations=2)
    b2.train()
    from lightgbm_tpu_torch.obs.report import summarize
    assert "quant" not in summarize(tele2)


def test_nan_trip_counter():
    from lightgbm_tpu_torch.utils.log import Log
    tele = obs.configure(freq=1)
    booster, _, _ = toy_booster(num_iterations=3, nan_policy="clip")
    n = booster.num_data
    lvl = Log._level
    Log.reset_level(Log.Level.FATAL)
    try:
        booster.train_one_iter(np.full((1, n), np.nan, np.float32),
                               np.ones((1, n), np.float32))
    finally:
        Log.reset_level(lvl)
    assert tele.counter("nan_policy_trips").value == 1
    assert "nan_trip" in [e["kind"] for e in tele.events]


@pytest.mark.parametrize("boosting,kind,metric", [
    ("goss", "goss_select", "goss_top_k"),
    ("dart", "dart_drop", "dart_dropped_trees")])
def test_sampling_boosters_telemetry(boosting, kind, metric):
    tele = obs.configure(freq=1)
    booster, _, _ = toy_booster(n=512, num_iterations=4, boosting=boosting,
                                learning_rate=0.5)
    booster.train()
    assert kind in [e["kind"] for e in tele.events]
    snap = tele.registry.snapshot()
    assert metric in snap["gauges"] or metric in snap["histograms"]


# ---- split-pass accounting (obs.launches) ----

def _counting(monkeypatch):
    """Count the calls of the split-pass functions the learner runs (on
    the card each is one launch of the split-pass kernel)."""
    from lightgbm_tpu_torch.core import tree_learner as tl
    n = {"partition": 0, "partition_level": 0}
    for name, key in (("partition_hist", "partition"),
                      ("partition_hist_window", "partition"),
                      ("partition_hist_level", "partition_level"),
                      ("partition_hist_level_window", "partition_level")):
        real = getattr(tl, name)

        def wrapped(*a, _real=real, _key=key, **k):
            n[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tl, name, wrapped)
    # the defaults of SerialTreeLearner.train were bound at definition
    real_train = tl.SerialTreeLearner.train

    def train(self, *a, **k):
        k.setdefault("part_fn", tl.partition_hist)
        k.setdefault("window_fn", tl.partition_hist_window)
        k.setdefault("level_fn", tl.partition_hist_level)
        k.setdefault("level_window_fn", tl.partition_hist_level_window)
        return real_train(self, *a, **k)
    monkeypatch.setattr(tl.SerialTreeLearner, "train", train)
    return n


def test_tree_kernel_launches_leaf_wise_equal_jax(monkeypatch):
    """A leaf-wise tree of L leaves makes L-1 split passes: the port's
    count equals the JAX package's on the same training (both through
    their fused chunk, train() running the 2 iterations as one) and the
    split-pass calls."""
    from lightgbm_tpu.obs import launches as jax_launches
    from test_telemetry import _toy_booster as jax_toy
    jb, _, _ = jax_toy(num_iterations=2)
    assert jb._can_fuse_iters()
    jax_launches.reset()
    jb.train_chunk(2)
    n = _counting(monkeypatch)
    launches.reset()
    b, _, _ = toy_booster(num_iterations=2)
    assert b._can_fuse_iters() and b._can_carry_rows()
    b.train()
    assert all(t.num_leaves == 15 for t in b.models)
    assert launches.counts() == jax_launches.counts() == {"leaf": 2 * 14}
    assert launches.per_tree("leaf") == 14.0 == b.learner.launches_per_tree()
    assert n == {"partition": 28, "partition_level": 0}


def test_tree_kernel_launches_leaf_wise_equal_jax_fused_path(monkeypatch):
    """The same count against the JAX package's fused Pallas path, run in
    interpret mode through the ``pl.load``/``pl.store`` shim of
    ``test_torch_level_oracle`` (undone after the test)."""
    from jax.experimental import pallas as pl

    from lightgbm_tpu.obs import launches as jax_launches
    from test_telemetry import _fused_booster
    from test_torch_level_oracle import _store
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    jax_launches.reset()
    jb = _fused_booster(iters=2, num_leaves=8)
    assert jb._can_fuse_iters()
    jb.train_chunk(2)
    rng = np.random.RandomState(3)
    X = rng.normal(size=(4096, 8))
    y = X[:, 0] * 1.5 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=4096)
    launches.reset()
    P.train({"objective": "regression", "num_leaves": 8,
             "min_data_in_leaf": 2, "max_bin": 16, "verbosity": -1},
            P.Dataset(X, y, params={"max_bin": 16}), 2, device=CPU)
    assert launches.counts() == jax_launches.counts() == {"leaf": 2 * 7}


def test_tree_kernel_launches_level_wise(monkeypatch):
    """Level growth makes one split pass a level: at most max_depth a tree,
    fewer than the leaf-wise L-1, equal to the level-pass calls."""
    n = _counting(monkeypatch)
    launches.reset()
    b, _, _ = toy_booster(num_iterations=2, max_depth=3,
                          tree_grow_mode="level", num_leaves=8)
    b.train()
    assert b.learner.effective_grow_mode() == "level"
    assert launches.counts() == {"level": n["partition_level"]}
    assert n["partition"] == 0
    per_tree = launches.per_tree("level")
    assert per_tree <= 3 < b.config.num_leaves - 1


def test_tree_kernel_launches_in_summary_and_spans(tmp_path):
    from lightgbm_tpu_torch.obs.report import finalize_run, human_table
    out = str(tmp_path / "t.jsonl")
    tele = obs.configure(out=out, freq=1)
    b, _, _ = toy_booster(num_iterations=2, max_depth=3,
                          tree_grow_mode="level", num_leaves=8)
    b.train()
    summary = finalize_run(tele, gbdt=b)
    obs.disable()
    lv = summary["tree_kernel_launches"]["level"]
    assert lv["trees"] == 2
    assert lv["launches"] == summary["tree_kernel_launch_total"]
    assert summary["counters"]["tree_kernel_launches"] == lv["launches"]
    assert "launches[level]" in human_table(summary)
    spans = [e for e in read_events(out)
             if e["kind"] == "span" and e["name"] == "tree_build"]
    assert len(spans) == 2
    assert sum(s["launches"] for s in spans) == lv["launches"]
    assert all(s["mode"] == "level" and s["levels"] == s["launches"]
               for s in spans)
