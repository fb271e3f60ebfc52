"""The port's alert engine, profiler captures and MFU estimate
(``lightgbm_tpu_torch/obs/alerts.py``, ``profiling.py``, ``mfu.py``)
against the JAX package's, on the CPU.

- the window math's goldens (``breach_fraction``, ``burn_rate``,
  ``window_rate``) agree with the JAX module's, and both engines fire and
  resolve the same on scripted series (gauge, rate, quantile rules);
- ``/alerts``, the firing gauges, ``obs.configure(alert_rules=...)``
  through ``train()``, and a watchdog stall raising an incident;
- ``/debug/profile`` writes a ``torch.profiler`` Chrome trace into the run's
  capture directory; the flight recorder fires once; a capture is refused
  while another capture or any other ``torch.profiler`` runs;
- ``row_visits`` and the smaller children's rows of the cost model equal
  the JAX estimator's on the same model text, and ``finalize_run`` records
  the estimate (``mfu``/``device_util`` None on the CPU, consistent shares
  against the H100 row).
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as P
from lightgbm_tpu import obs as j_obs
from lightgbm_tpu.obs import alerts as j_alerts
from lightgbm_tpu_torch import obs, resilience
from lightgbm_tpu_torch.obs import alerts, mfu, profiling
from lightgbm_tpu_torch.obs.exporter import start_exporter
from lightgbm_tpu_torch.obs.report import finalize_run, human_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_slate():
    obs.disable()
    j_obs.disable()
    resilience.clear_stall()
    yield
    obs.disable()
    j_obs.disable()
    resilience.stop_watchdog()
    resilience.clear_stall()


def _get(exp, path, timeout=60):
    return urllib.request.urlopen(
        "http://127.0.0.1:%d%s" % (exp.port, path), timeout=timeout).read(
    ).decode()


# ---- window math: the same goldens in both packages ----

SAMPLES = [(0.0, False), (10.0, True), (20.0, True), (30.0, False)]
POINTS = [(0.0, 0.0), (10.0, 5.0), (20.0, 15.0)]


@pytest.mark.parametrize("mod", [alerts, j_alerts], ids=["port", "jax"])
def test_window_math_goldens(mod):
    assert mod.breach_fraction(SAMPLES, now=30.0, window_s=15.0) == 0.5
    assert mod.breach_fraction(SAMPLES, now=30.0, window_s=10.0) == 0.0
    assert mod.breach_fraction(SAMPLES, now=30.0, window_s=100.0) == 0.5
    assert mod.breach_fraction(SAMPLES, now=300.0, window_s=10.0) is None
    assert mod.burn_rate(0.3, 0.1) == pytest.approx(3.0)
    assert mod.burn_rate(0.2, 0.0) == mod.BURN_CAP
    assert mod.burn_rate(0.0, 0.0) == 0.0
    assert mod.burn_rate(None, 0.1) is None
    assert mod.burn_rate(1.0, 1e-12) == mod.BURN_CAP
    assert mod.window_rate(POINTS, now=20.0, window_s=10.0) == 1.0
    assert mod.window_rate(POINTS, now=20.0, window_s=30.0) == 0.75
    assert mod.window_rate([(0.0, 3.0)], now=1.0, window_s=10.0) == 0.0


@pytest.mark.parametrize("case", range(40))
def test_window_math_agrees_on_random_series(case):
    rng = np.random.RandomState(case)
    ts = np.sort(rng.uniform(0, 100, size=rng.randint(0, 12)))
    samples = [(float(t), bool(rng.rand() < 0.4)) for t in ts]
    points = [(float(t), float(c)) for t, c in
              zip(ts, np.cumsum(rng.randint(0, 5, size=len(ts))))]
    now, win = float(rng.uniform(0, 120)), float(rng.uniform(1, 60))
    budget = float(rng.choice([0.0, 0.05, 0.5]))
    f = alerts.breach_fraction(samples, now, win)
    assert f == j_alerts.breach_fraction(samples, now, win)
    assert alerts.burn_rate(f, budget) == j_alerts.burn_rate(f, budget)
    assert alerts.window_rate(points, now, win) == j_alerts.window_rate(
        points, now, win)


# ---- the engines on scripted series ----

RULES = {
    "gauge_zero_budget": (
        {"name": "q", "kind": "gauge", "gauge": "queue_depth", "max": 10.0,
         "budget": 0.0, "fast_window_s": 10.0, "slow_window_s": 30.0,
         "capture": False},
        [(0.0, ("gauge", "queue_depth", 50.0)), (31.0, ("gauge", "queue_depth",
                                                        1.0)),
         (32.0, None), (33.0, None)]),
    "gauge_budget_fraction": (
        {"name": "b", "kind": "gauge", "gauge": "g", "max": 1.0,
         "budget": 0.5, "fast_window_s": 10.0, "slow_window_s": 10.0,
         "capture": False},
        [(1.0, ("gauge", "g", 5.0)), (2.0, ("gauge", "g", 0.0)),
         (3.0, None), (4.0, ("gauge", "g", 5.0)), (5.0, None),
         (16.0, ("gauge", "g", 0.0))]),
    "rate": (
        {"name": "rej", "kind": "rate", "counter": "serve_rejected",
         "max_per_s": 0.0, "fast_window_s": 10.0, "slow_window_s": 30.0,
         "capture": False},
        [(0.0, ("counter", "serve_rejected", 0)),
         (1.0, ("counter", "serve_rejected", 5)), (32.0, None),
         (33.0, None), (34.0, None)]),
    "quantile_idle": (
        {"name": "p", "kind": "quantile",
         "metric": "serve_latency_s_model_*", "quantile": "p99", "max": 1.0,
         "budget": 0.0, "fast_window_s": 10.0, "slow_window_s": 20.0,
         "capture": False},
        [(0.0, ("hist", "serve_latency_s_model_x", 5.0)), (5.0, None),
         (21.0, None), (22.0, ("hist", "serve_latency_s_model_x", 5.0)),
         (23.0, ("hist", "serve_latency_s_model_y", 0.01))]),
}


def _script(obs_mod, alerts_mod, rule, steps):
    tele = obs_mod.configure(freq=1)
    eng = alerts_mod.AlertEngine(tele, [rule])
    trace = []
    for now, action in steps:
        if action is not None:
            kind, name, v = action
            if kind == "gauge":
                tele.gauge(name).set(v)
            elif kind == "counter":
                tele.counter(name).inc(v)
            else:
                tele.histogram(name).observe(v)
        eng.tick(now=now)
        snap = eng.snapshot()
        trace.append((snap["firing"], snap["fired_total"],
                      [(s["series"], s["state"], s["value"], s["fast_burn"],
                        s["slow_burn"]) for s in snap["series"]]))
    events = [(e["rule"], e["state"]) for e in tele.events
              if e["kind"] == "alert"]
    gauges = {k: v for k, v in tele.registry.snapshot()["gauges"].items()
              if k.startswith("alert_firing_")}
    fired = tele.registry.snapshot()["counters"].get("alerts_fired", 0)
    obs_mod.disable()
    return trace, events, gauges, fired


@pytest.mark.parametrize("name", list(RULES))
def test_engine_fires_and_resolves_as_the_jax_engine(name):
    rule, steps = RULES[name]
    ours = _script(obs, alerts, dict(rule), steps)
    theirs = _script(j_obs, j_alerts, dict(rule), steps)
    assert ours == theirs
    states = [st for _, st in ours[1]]
    assert states and states[0] == "firing"


def test_rules_load_like_the_jax_package(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"alerts": [
        {"name": "ok", "kind": "gauge", "gauge": "g", "max": 1},
        {"name": "bad-kind", "kind": "wat"},
        {"kind": "gauge", "gauge": "g", "max": 1}]}))
    assert alerts.load_rules(str(path)) == j_alerts.load_rules(str(path))
    budgets = os.path.join(REPO, "PERF_BUDGETS.json")
    assert alerts.load_rules(budgets) == j_alerts.load_rules(budgets)
    assert [r["name"] for r in alerts.load_rules(str(path))] == ["ok"]


def test_alerts_endpoint_gauges_and_close(tmp_path):
    tele = obs.configure(out=str(tmp_path / "t.jsonl"), freq=1)
    exp = start_exporter(tele, port=0)
    assert json.loads(_get(exp, "/alerts")) == {
        "enabled": False, "series": [], "firing": 0, "fired_total": 0}
    eng = alerts.install(
        tele, rules=[{"name": "q", "kind": "gauge", "gauge": "d",
                      "max": 1.0, "fast_window_s": 1.0,
                      "slow_window_s": 2.0, "capture": False}],
        interval_s=0.05)
    tele.gauge("d").set(9.0)
    deadline = time.time() + 10
    body = {}
    while time.time() < deadline:
        body = json.loads(_get(exp, "/alerts"))
        if body.get("firing"):
            break
        time.sleep(0.05)
    assert body["enabled"] and body["firing"] == 1, body
    assert 'lgbm_tpu_alert_state{rule="q",series="d"} 1' in _get(
        exp, "/metrics")
    summary = finalize_run(tele)
    assert summary["alerts"]["fired_total"] == 1
    assert "alerts:" in human_table(summary)
    thread = eng._thread
    obs.disable()
    assert not thread.is_alive()


def test_train_arms_alert_rules_and_flight_recorder(tmp_path):
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{"name": "iters", "kind": "gauge",
                                  "gauge": "bag_data_cnt", "max": 1e9}]))
    X = np.random.RandomState(0).normal(size=(300, 3))
    out = str(tmp_path / "r.jsonl")
    P.train({"objective": "regression", "verbosity": -1,
             "telemetry_out": out, "alert_rules": str(rules),
             "alert_interval_s": 0.05, "flight_recorder": True},
            P.Dataset(X, X[:, 0]), 2, device=CPU)
    summary = json.load(open(out + ".summary.json"))
    assert summary["alerts"]["enabled"] and summary["alerts"]["rules"] == 1
    assert summary["profiling"]["flight_recorder_armed"] is True
    assert obs.active() is None


def test_watchdog_stall_is_an_incident(tmp_path):
    tele = obs.configure(out=str(tmp_path / "w.jsonl"), freq=1)
    profiling.arm_flight_recorder(tele, seconds=0.05)
    hits = []
    resilience.start_watchdog(0.2, abort=False, on_stall=hits.append)
    t0 = time.monotonic()
    with resilience.watch("train_one_iter", iteration=1):
        while not hits and time.monotonic() - t0 < 60.0:
            time.sleep(0.02)
    assert hits
    assert tele.counter("alerts_fired").value == 1
    ev = [e for e in tele.events if e["kind"] == "alert"]
    assert ev[0]["rule"] == "watchdog_stall" and ev[0]["state"] == "firing"
    st = profiling.state(tele)
    assert st.auto_fired and st.captures[0]["reason"] == "watchdog_stall"
    assert os.path.exists(st.captures[0]["trace"])
    summary = finalize_run(tele)
    assert summary["alerts"] == {"enabled": False, "series": [],
                                 "fired_total": 1}


# ---- profiler captures ----

def test_debug_profile_writes_a_trace(tmp_path):
    tele = obs.configure(out=str(tmp_path / "t.jsonl"), freq=1)
    exp = start_exporter(tele, port=0)
    body = json.loads(_get(exp, "/debug/profile?seconds=0.1"))
    assert body.get("error") is None, body
    assert body["reason"] == "http" and body["n"] == 1
    assert body["dir"].startswith(str(tmp_path / "t.jsonl") + ".profiles")
    meta = json.load(open(os.path.join(body["dir"], "capture.json")))
    assert meta["reason"] == "http" and meta["v"] == 1
    trace = json.load(open(body["trace"]))
    assert "traceEvents" in trace
    assert tele.counter("profile_captures").value == 1
    summary = finalize_run(tele)
    assert summary["profiling"]["captures"][0]["reason"] == "http"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(exp, "/debug/profile?seconds=nope")
    assert ei.value.code == 400


def test_flight_recorder_fires_once(monkeypatch):
    tele = obs.configure(freq=1)
    calls = []
    monkeypatch.setattr(profiling, "capture",
                        lambda t, seconds, reason: calls.append(reason)
                        or {"n": len(calls), "reason": reason})
    assert profiling.on_incident("early") is None
    profiling.arm_flight_recorder(tele)
    assert profiling.on_incident("first")["reason"] == "first"
    assert profiling.on_incident("second") is None
    assert calls == ["first"]


def test_capture_never_concurrent(tmp_path):
    tele = obs.configure(out=str(tmp_path / "t.jsonl"), freq=1)
    st = profiling.state(tele, create=True)
    st.active = True
    out = profiling.capture(tele, seconds=0.05, reason="x")
    assert out["busy"] and "already in progress" in out["error"]
    profiling.arm_flight_recorder(tele)
    assert profiling.on_incident("mid") is None
    st.active = False
    assert not st.auto_fired and st.captures == []


def test_capture_refused_under_another_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tele = obs.configure(out=str(tmp_path / "t.jsonl"), freq=1)
    exp = start_exporter(tele, port=0)
    with profile(activities=[ProfilerActivity.CPU]):
        out = profiling.capture(tele, seconds=0.05, reason="nested")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exp, "/debug/profile?seconds=0.05")
    assert out["busy"] and "another torch.profiler" in out["error"]
    assert ei.value.code == 409
    assert profiling.state(tele).captures == []
    # the process lock was released: a capture now succeeds
    assert "error" not in profiling.capture(tele, seconds=0.05)


def test_capture_layout():
    import tempfile
    d = profiling.open_capture(tempfile.mkdtemp(), 3, "profile tree!")
    assert os.path.basename(d) == "capture_03_profile_tree_"
    meta = profiling.write_meta(d, reason="unit", seconds=0.1)
    assert json.load(open(os.path.join(d, "capture.json")))["reason"] \
        == "unit" and meta["dir"] == d


# ---- the cost model ----

def _model(seed=0, n=1500, iters=4, **params):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 7))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0) * 1.0
    p = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "min_data_in_leaf": 5}, **params)
    return P.train(p, P.Dataset(X, y), iters, device=CPU), X


def _jax_cost(trees, n, iters, F, max_bin):
    """The JAX estimator's row visits and smaller-child rows: its MACs are
    linear in the root rows, so two row counts give the child rows."""
    from lightgbm_tpu.core.partition import TS
    from lightgbm_tpu.obs.mfu import training_cost_model
    a = training_cost_model(trees, n, iters, F, max_bin)
    b = training_cost_model(trees, n + 1000, iters, F, max_bin)
    per_row = (b["macs"] - a["macs"]) / (1000.0 * iters)
    hist = (a["macs"] - a["row_visits"] * 2 * TS * 128) / per_row - n * iters
    return a["row_visits"], hist


@pytest.mark.parametrize("params", [
    {}, {"tree_grow_mode": "level"}, {"hist_precision": "quantized"},
    {"objective": "multiclass", "num_class": 3},
    {"bagging_fraction": 0.7, "bagging_freq": 1}])
def test_tree_work_equals_the_jax_estimator(params):
    from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
    from lightgbm_tpu.config import Config as JConfig
    b, X = _model(**params)
    if "num_class" in params:
        X = X[:, :7]
    text = b.model_to_string()
    jb = JGBDT(JConfig())
    jb.load_model_from_string(text)
    trees = b._booster.models
    assert len(jb.models) == len(trees)
    visits, hist = _jax_cost(jb.models, len(X), 4, X.shape[1], 63)
    work = mfu.tree_work(trees)
    assert work["row_visits"] == visits
    assert work["hist_rows"] == pytest.approx(hist, rel=1e-9, abs=1e-6)
    cost = mfu.training_cost_model(trees, len(X), 4, X.shape[1], 63)
    assert cost["row_visits"] == visits
    assert cost["hist_rows"] == pytest.approx(hist + len(trees) * len(X))


def test_cost_model_counts_bytes_as_the_bound_column():
    b, X = _model(iters=2)
    trees = b._booster.models
    n, F = len(X), X.shape[1]
    work = mfu.tree_work(trees)
    cost = mfu.training_cost_model(trees, n, 2, F, 63)
    # W = 128 at 7 u8 columns; histogram rows read one 32-byte sector of
    # bins and one of g/h; each output [F, 2, 64] f32
    assert cost["row_width"] == 128 and mfu.hist_row_bytes(F, 1) == 64
    hist_rows = work["hist_rows"] + len(trees) * n
    outputs = (len(trees) + work["splits"]) * F * 2 * 64 * 4
    assert cost["bytes"] == 2 * 128 * work["row_visits"] \
        + 64 * hist_rows + outputs
    assert cost["macs"] == 2 * F * hist_rows


def test_finalize_run_records_the_estimate(tmp_path, monkeypatch):
    out = str(tmp_path / "m.jsonl")
    b, X = _model(telemetry_out=out)
    summary = json.load(open(out + ".summary.json"))
    gauges = summary["gauges"]
    assert gauges["est_bytes"] > 0 and gauges["est_macs"] > 0
    assert summary["mfu"] is None and summary["device_util"] is None
    ev = [e for e in obs.read_events(out) if e["kind"] == "mfu_estimate"]
    assert len(ev) == 1 and ev[0]["device_kind"] is None
    # against the H100 row the shares follow the wall
    monkeypatch.setattr(mfu, "current_device_kind",
                        lambda device=None: "nvidia h100 80gb hbm3")
    tele = obs.configure(freq=1)
    est = mfu.record_training_estimate(tele, b._booster, 2.0)
    assert est["device_util"] == est["bytes"] / 2.0 / 3.35e12
    assert est["mfu"] == est["macs"] / 2.0 / 17e12
    assert 0 < est["device_util"] <= 1
    assert tele.gauge("device_util").value == est["device_util"]
