"""The port's live observability plane, on the CPU: the exporter
(``/metrics``, ``/healthz``, ``/summary.json``), spans, per-rank shard
sinks (an explicit rank, the env override and a gloo group of two
processes), the streaming event reader, the histogram reservoir, the card's
memory gauges (absent on a CPU run), the quality plane's scoring against the
JAX package's, and the alert engine and flight recorder that
``alert_rules`` and ``flight_recorder`` arm.  Cases follow
``tests/test_obs_plane.py``; the JAX package's results are the oracle
where a value can be compared (PSI, JS, the Prometheus exposition's metric
names for the same registry).
"""
import json
import os
import random
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu import obs as jax_obs
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import obs, resilience
from lightgbm_tpu_torch.obs import devmem, spans
from lightgbm_tpu_torch.obs.exporter import (health_snapshot,
                                             render_prometheus,
                                             start_exporter)
from lightgbm_tpu_torch.obs.registry import (Histogram, iter_events,
                                             read_events, validate_event)
from lightgbm_tpu_torch.obs.report import finalize_run
from lightgbm_tpu_torch.serving import Server
from test_torch_telemetry import toy_booster

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_slate():
    obs.disable()
    resilience.clear_preemption()
    resilience.clear_stall()
    yield
    obs.disable()
    jax_obs.disable()
    resilience.clear_preemption()
    resilience.clear_stall()
    resilience.stop_watchdog()


def _get(exp, path, timeout=10):
    return urllib.request.urlopen(
        "http://127.0.0.1:%d%s" % (exp.port, path),
        timeout=timeout).read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def trained():
    booster, X, _ = toy_booster(num_iterations=4)
    booster.train()
    return booster, X


# ---- the exporter ----

def test_metrics_prometheus_from_live_serving(trained, tmp_path):
    booster, X = trained
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("prod", booster)
        srv.predict("prod", X[:64])  # stacks its predictor outside the run
        tele = obs.configure(out=str(tmp_path / "srv.jsonl"), freq=1)
        exp = start_exporter(tele, port=0)
        futs = [srv.submit("prod", X[i:i + 16]) for i in range(0, 320, 16)]
        for f in futs:
            f.result()
        text = _get(exp, "/metrics")
        obs.disable()
    assert "# TYPE lgbm_tpu_serve_requests_model_prod_total counter" in text
    assert "lgbm_tpu_serve_requests_model_prod_total 20" in text
    assert "lgbm_tpu_serve_rows_model_prod_total 320" in text
    assert "lgbm_tpu_run_recompiles 0" in text
    assert 'lgbm_tpu_serve_latency_s_model_prod{quantile="0.99"}' in text
    assert 'lgbm_tpu_residency_bytes{model="prod",kind="actual"}' in text
    for line in text.strip().splitlines():
        assert line.startswith("#") or len(line.rsplit(None, 1)) == 2, line


def test_metrics_no_duplicate_metric_names_and_jax_names():
    """No metric name twice (duplicates fail a Prometheus scrape), and the
    registry's own series carry the JAX exposition's names."""
    from lightgbm_tpu.obs.exporter import render_prometheus as jax_render
    tele = obs.configure(freq=1)
    for name in ("recompiles", "io_retries", "predict_fallbacks",
                 "tree_kernel_launches", "my_counter"):
        tele.counter(name).inc(3)
    tele.gauge("my_gauge").set(2.0)
    tele.histogram("my_hist").observe(0.5)
    exp = start_exporter(tele, port=0)
    text = _get(exp, "/metrics")
    snap = tele.registry.snapshot()
    obs.disable()
    types = [line for line in text.splitlines() if line.startswith("# TYPE")]
    assert len(types) == len(set(types))
    keys = [line.rsplit(None, 1)[0] for line in text.splitlines()
            if line and not line.startswith("#")]
    assert len(keys) == len(set(keys))
    assert "lgbm_tpu_my_counter_total 3" in text
    assert text.count("# TYPE lgbm_tpu_io_retries_total") == 1
    ours = {t for t in types if "my_" in t}
    theirs = {t for t in jax_render(snap).splitlines()
              if t.startswith("# TYPE") and "my_" in t}
    assert ours == theirs == {
        "# TYPE lgbm_tpu_my_counter_total counter",
        "# TYPE lgbm_tpu_my_gauge gauge",
        "# TYPE lgbm_tpu_my_hist summary"}


def test_metrics_renders_always_on_counters():
    text = render_prometheus({"counters": {}, "gauges": {},
                              "histograms": {}})
    for name in ("recompiles_total", "tree_kernel_launches_total",
                 "predict_fallbacks_total", "io_retries_total",
                 "host_rss_bytes", "host_rss_high_water_bytes"):
        assert "# TYPE lgbm_tpu_%s" % name in text
    # the planner's fallback counter is always on; no alert engine, no
    # alert state
    assert "lgbm_tpu_plan_cache_fallbacks_total 0" in text
    assert "alert" not in text


@pytest.mark.parametrize("path,code", [("/summary.json", 200),
                                       ("/nope", 404),
                                       ("/alerts", 200)])
def test_exporter_paths(tmp_path, path, code):
    tele = obs.configure(out=str(tmp_path / "s.jsonl"), freq=1)
    tele.gauge("train_rows").set(42)
    exp = start_exporter(tele, port=0)
    try:
        body = _get(exp, path)
        got = 200
    except urllib.error.HTTPError as err:
        got, body = err.code, ""
    obs.disable()
    assert got == code
    if path == "/summary.json":
        assert json.loads(body)["rows"] == 42
    elif path == "/alerts":
        assert json.loads(body) == {"enabled": False, "series": [],
                                    "firing": 0, "fired_total": 0}


def test_exporter_stops_with_close_and_start_is_idempotent():
    tele = obs.configure(freq=1)
    exp = start_exporter(tele, port=0)
    assert start_exporter(tele, port=0) is exp
    assert any(t.name == "lgbm-tpu-metrics" for t in threading.enumerate())
    obs.disable()
    time.sleep(0.1)
    assert not any(t.name == "lgbm-tpu-metrics"
                   for t in threading.enumerate())
    with pytest.raises(OSError):
        _get(exp, "/metrics", timeout=2)


def test_healthz_ok_then_draining_on_preemption():
    tele = obs.configure(freq=1)
    exp = start_exporter(tele, port=0)
    h = json.loads(_get(exp, "/healthz"))
    assert h["status"] == "ok" and h["preemption_requested"] is False
    resilience.request_preemption()
    assert json.loads(_get(exp, "/healthz"))["status"] == "draining"
    resilience.clear_preemption()
    assert json.loads(_get(exp, "/healthz"))["status"] == "ok"


def test_healthz_serving_queue_depth_provider_two_servers(trained):
    booster, X = trained
    a = Server(max_batch_wait_us=0, device=CPU)
    b = Server(max_batch_wait_us=0, device=CPU)
    try:
        a.register("m", booster)
        a.predict("m", X[:4])
        h = health_snapshot()
        assert h["serving"]["queue_depth"] == 0
        assert h["serving"]["completed"] >= 1
        assert h["queue_depth"] == 0 and "serving#2" in h
        b.close()
        assert "serving" in health_snapshot()
    finally:
        a.close()
        b.close()
    assert not any(k.startswith("serving") for k in health_snapshot())


def test_healthz_watchdog_and_checkpoint_age(tmp_path):
    from lightgbm_tpu_torch.checkpoint import last_checkpoint_time
    resilience.start_watchdog(30.0, abort=False)
    try:
        h = health_snapshot()
        assert h["watchdog"]["active"] is True
        assert h["watchdog"]["open_sections"] == 0
        with resilience.watch("probe_section"):
            h2 = health_snapshot()
            assert h2["watchdog"]["open_sections"] == 1
    finally:
        resilience.stop_watchdog()
    booster, _, _ = toy_booster(num_iterations=2, snapshot_keep=0)
    booster.train()
    booster.save_checkpoint(str(tmp_path / "m.txt"))
    assert last_checkpoint_time() is not None
    assert health_snapshot()["last_checkpoint_age_s"] < 60.0


def test_healthz_stalled_gives_503():
    tele = obs.configure(freq=1)
    exp = start_exporter(tele, port=0)
    fired = threading.Event()
    resilience.start_watchdog(0.05, abort=False,
                              on_stall=lambda d: fired.set(),
                              first_dispatch_grace=1.0)
    with resilience.watch("stuck"):
        assert fired.wait(timeout=5.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exp, "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "stalled"
    assert tele.gauge("watchdog_stall_s").value is not None
    assert "watchdog_stall" in [e["kind"] for e in tele.events]


def test_exporter_scrape_does_not_block_training(tmp_path):
    booster, _, _ = toy_booster(num_iterations=12)
    tele = obs.configure(out=str(tmp_path / "c.jsonl"), freq=1)
    exp = start_exporter(tele, port=0)
    stop, scrapes, errors = threading.Event(), [], []

    def scraper():
        while not stop.is_set():
            try:
                scrapes.append(_get(exp, "/metrics"))
                json.loads(_get(exp, "/healthz"))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

    th = threading.Thread(target=scraper)
    th.start()
    try:
        # three fused chunks, as the JAX test runs them: the chunk metrics
        # exist from the first chunk's end, while two more train
        for _ in range(3):
            booster.train_chunk(4)
    finally:
        stop.set()
        th.join(timeout=10)
    assert not errors, errors[:3]
    assert scrapes and "lgbm_tpu_chunk_dispatch_s_count" in scrapes[-1]


def test_engine_train_metrics_port_serves_live(tmp_path):
    """metrics_port > 0 through train's params serves the run live and is
    gone after it; metrics_port=0 starts no listener (the param default)."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(400, 4))
    seen = {}

    def probe(env):
        if env.iteration == 1 and "text" not in seen:
            exp = obs.active().exporter
            if exp is not None:
                seen["text"] = _get(exp, "/metrics")
                seen["health"] = json.loads(_get(exp, "/healthz"))

    for port in (0, _free_port()):
        P.train({"objective": "regression", "num_leaves": 7,
                 "verbosity": -1, "metrics_port": port,
                 "telemetry_out": str(tmp_path / ("mp%d.jsonl" % port))},
                P.Dataset(X, X[:, 0]), 3, callbacks=[probe], device=CPU)
        if port == 0:
            assert "text" not in seen
    assert "lgbm_tpu_tree_kernel_launches_total" in seen["text"]
    assert seen["health"]["status"] == "ok"
    assert obs.active() is None
    assert not any(t.name == "lgbm-tpu-metrics"
                   for t in threading.enumerate())


def test_metrics_params_validate():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg = Config(metrics_port=9099, metrics_addr="127.0.0.1")
    assert cfg.metrics_port == 9099 and cfg.metrics_addr == "127.0.0.1"
    assert Config(telemetry_port=1234).metrics_port == 1234
    for bad in (-1, 70000):
        with pytest.raises(LightGBMError):
            Config(metrics_port=bad)


@pytest.mark.parametrize("kw", [dict(alert_rules="rules.json"),
                                dict(flight_recorder=True)],
                         ids=["alert_rules", "flight_recorder"])
def test_alert_and_flight_recorder_planes_arm(kw, tmp_path):
    """``obs.configure`` and ``train()``'s params arm the alert engine
    (from a rules file) and the flight recorder on the run; the run owns
    them and its close stops the engine's thread."""
    if "alert_rules" in kw:
        rules = tmp_path / kw["alert_rules"]
        rules.write_text(json.dumps([{"name": "g", "kind": "gauge",
                                      "gauge": "g", "max": 1.0}]))
        kw = dict(kw, alert_rules=str(rules))
    tele = obs.configure(**kw)
    if "alert_rules" in kw:
        assert tele.alerts is not None and tele.alerts._thread.is_alive()
        thread = tele.alerts._thread
    else:
        assert tele.profiling.armed and not tele.profiling.auto_fired
    obs.disable()
    if "alert_rules" in kw:
        assert not thread.is_alive()
    X = np.random.RandomState(0).normal(size=(200, 3))
    out = os.path.join(tempfile.mkdtemp(), "r.jsonl")
    P.train(dict({"objective": "regression", "verbosity": -1,
                  "telemetry_out": out}, **kw),
            P.Dataset(X, X[:, 0]), 1, device=CPU)
    summary = json.load(open(out + ".summary.json"))
    if "alert_rules" in kw:
        assert summary["alerts"]["enabled"] and summary["alerts"][
            "rules"] == 1
    else:
        assert summary["profiling"]["flight_recorder_armed"] is True
    assert obs.active() is None


# ---- spans ----

def test_span_events_validate_and_nest(tmp_path):
    path = str(tmp_path / "sp.jsonl")
    obs.configure(out=path, freq=1)
    with spans.span("outer", phase="x"):
        with spans.span("inner"):
            time.sleep(0.01)
    obs.disable()
    evs = [e for e in read_events(path) if e["kind"] == "span"]
    for e in evs:
        validate_event(e)
    by_name = {e["name"]: e for e in evs}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["trace_id"] == outer["trace_id"]
    assert inner["parent_id"] == outer["span_id"]
    assert outer["parent_id"] is None
    assert outer["dur_s"] >= inner["dur_s"] >= 0.01
    assert outer["phase"] == "x"


def test_span_off_is_shared_nullcontext():
    assert obs.active() is None
    assert spans.span("a") is spans.span("b", k=1)


def test_serving_request_span_lifeline(trained, tmp_path):
    booster, X = trained
    path = str(tmp_path / "serve.jsonl")
    with Server(max_batch_wait_us=2000, device=CPU) as srv:
        srv.register("m", booster)
        srv.predict("m", X[:8])
        obs.configure(out=path, freq=1)
        srv.predict("m", X[:8])
    obs.disable()
    traces = {}
    for e in read_events(path):
        if e["kind"] == "span":
            traces.setdefault(e["trace_id"], {})[e["name"]] = e
    req = [t for t in traces.values() if "serve_request" in t]
    assert len(req) == 1
    t = req[0]
    assert {"serve_request", "queue_wait", "coalesce", "dispatch"} <= set(t)
    root = t["serve_request"]
    for child in ("queue_wait", "coalesce", "dispatch"):
        assert t[child]["parent_id"] == root["span_id"]
    assert t["queue_wait"]["t0"] + t["queue_wait"]["dur_s"] \
        <= t["dispatch"]["t0"] + 1e-6


def test_serving_spans_sampled_by_telemetry_freq(trained, tmp_path):
    booster, X = trained
    path = str(tmp_path / "sampled.jsonl")
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", booster)
        srv.predict("m", X[:8])
        obs.configure(out=path, freq=1000)
        for _ in range(6):
            srv.predict("m", X[:8])
    obs.disable()
    evs = read_events(path)
    assert sum(e["kind"] == "serve_batch" for e in evs) == 6
    assert sum(e["kind"] == "span" for e in evs) < 6 * 4


def test_training_chunk_tree_and_checkpoint_spans(tmp_path):
    path = str(tmp_path / "train.jsonl")
    tele = obs.configure(out=path, freq=1)
    booster, _, _ = toy_booster(num_iterations=4, snapshot_freq=2,
                                snapshot_keep=0)
    booster.train(snapshot_out=str(tmp_path / "m.txt"))
    run_trace = tele.trace_id
    obs.disable()
    sp = [e for e in read_events(path) if e["kind"] == "span"]
    names = [e["name"] for e in sp]
    # snapshot_freq=2 cuts the 4 iterations into 2 fused chunks of 2 trees
    assert names.count("train_chunk") == 2
    assert [e["iters"] for e in sp if e["name"] == "train_chunk"] == [2, 2]
    assert all(e["fused"] for e in sp if e["name"] == "train_chunk")
    assert names.count("tree_build") == 4
    assert names.count("checkpoint_write") == 2
    assert all(e["trace_id"] == run_trace for e in sp
               if e["name"] in ("train_chunk", "tree_build"))
    assert all(e["launches"] == 14 for e in sp if e["name"] == "tree_build")


# ---- per-rank shard sinks ----

def test_rank_shard_sink_and_leader_summary(tmp_path):
    base = str(tmp_path / "pod.jsonl")
    for rank in (1, 0):
        tele = obs.configure(out=base, freq=1, rank=rank, entry="t")
        tele.event("probe", x=1)
        summary = finalize_run(tele)
        obs.disable()
        shard = obs.shard_path(base, rank)
        assert all(e["rank"] == rank for e in read_events(shard))
        assert summary["rank"] == rank and summary["host"]
        # rank 0 alone writes <base>.summary.json
        assert os.path.exists(base + ".summary.json") == (rank == 0)
    assert not os.path.exists(base)


def test_rank_env_override_and_unsharded_default(tmp_path, monkeypatch):
    out = str(tmp_path / "solo.jsonl")
    tele = obs.configure(out=out, freq=1)
    assert tele.rank is None
    obs.disable()
    assert "rank" not in read_events(out)[0]
    base = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(obs.RANK_ENV, "2")
    X = np.random.RandomState(0).normal(size=(400, 4))
    P.train({"objective": "regression", "num_leaves": 7, "verbosity": -1,
             "telemetry_out": base}, P.Dataset(X, X[:, 0]), 3, device=CPU)
    shard = obs.shard_path(base, 2)
    assert os.path.exists(shard) and not os.path.exists(base)
    assert not os.path.exists(base + ".summary.json")
    assert all(e["rank"] == 2 for e in read_events(shard))


def test_rank_shards_through_a_gloo_group(tmp_path):
    """Two processes in a gloo group train data-parallel with
    ``telemetry_out``: the rank comes from the group, each writes its own
    shard, rank 0 alone the summary, and both count the same split
    passes."""
    import torch_parallel_ranks as R
    out = R.spawn("telemetry_shards", 2, str(tmp_path), arg=str(tmp_path))
    assert [r["ranks"] for r in out] == [[0], [1]]
    assert out[0]["launches"] == out[1]["launches"]
    base = os.path.join(str(tmp_path), "pod.jsonl")
    assert os.path.exists(base + ".summary.json")
    with open(base + ".summary.json") as fh:
        assert json.load(fh)["rank"] == 0


# ---- the streaming reader and the histogram reservoir ----

def test_iter_events_streaming_and_torn_tail(tmp_path):
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as fh:
        for i in range(10):
            fh.write(json.dumps({"v": 1, "ts": float(i), "kind": "k%d" % i})
                     + "\n")
        fh.write('{"v": 1, "ts": 10.')
    it = iter_events(path)
    first = next(it)
    rest = list(it)
    assert first["kind"] == "k0" and len(rest) == 9
    assert read_events(path) == [first] + rest
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as fh:
        fh.write('{"v": 1, "ts": 1.0, "kind": "ok"}\nnot json\n'
                 '{"v": 1, "ts": 2.0, "kind": "ok"}\n')
    with pytest.raises(ValueError, match="line 2"):
        list(iter_events(bad))


def test_histogram_reservoir_covers_whole_run(monkeypatch):
    from lightgbm_tpu_torch.obs import registry as reg
    monkeypatch.setattr(reg, "HISTOGRAM_SAMPLE_CAP", 256)
    random.seed(7)
    h = Histogram()
    for _ in range(256):
        h.observe(1.0)
    for _ in range(256 * 9):
        h.observe(100.0)
    s = h.summary()
    assert s["count"] == 2560 and s["min"] == 1.0 and s["max"] == 100.0
    assert s["p50"] == 100.0 and s["p99"] == 100.0
    monkeypatch.setattr(reg, "HISTOGRAM_SAMPLE_CAP", 64)
    h2 = Histogram()
    for i in range(1000):
        h2.observe(float(i))
    assert len(h2._samples) == 64 and h2.count == 1000


# ---- the card's memory: none on a CPU run ----

def test_devmem_reports_no_device_on_a_cpu_run(trained, tmp_path):
    booster, X = trained
    tele = obs.configure(out=str(tmp_path / "d.jsonl"), freq=1)
    booster.predict(X[:600])
    assert devmem.sample(tele, phase="probe") == []
    summary = finalize_run(tele, gbdt=booster)
    assert "devmem" not in summary
    assert "devmem" not in [e["kind"] for e in tele.events]


# ---- the quality plane against the JAX package's scoring ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psi_and_js_equal_jax(seed):
    from lightgbm_tpu.obs import quality as jq
    from lightgbm_tpu_torch.obs import quality as q
    rng = np.random.RandomState(seed)
    a, b = rng.randint(0, 50, size=16), rng.randint(0, 50, size=16)
    b[rng.randint(16)] = 0
    assert q.psi(a, b) == jq.psi(a, b)
    assert q.js_divergence(a, b) == jq.js_divergence(a, b)
    counts = rng.randint(1, 9, size=255)
    groups, n = q.mass_groups(counts, own_last_bin=True)
    jgroups, jn = jq.mass_groups(counts, own_last_bin=True)
    assert n == jn and np.array_equal(groups, jgroups)


def test_quality_snapshot_equals_jax_on_the_same_rows(tmp_path):
    """The same model, layout and served rows through both packages'
    monitors give the same per-feature drift report."""
    from lightgbm_tpu.obs import quality as jq
    from lightgbm_tpu_torch.obs import quality as q
    from test_serving import _train as jax_train
    from test_torch_serving import carry, layout_of
    jb, X = jax_train(seed=3, objective="binary", num_leaves=15, iters=12,
                      nan_frac=0.05)
    g = carry(jb)
    ds = layout_of(X, jb)
    rng = np.random.RandomState(0)
    shifted = X[:400].copy()
    shifted[:, 0] += rng.normal(loc=1.5, size=400).astype(np.float32)
    reports = []
    for mod, model, layout in ((q, g, ds), (jq, jb, jb.train_data)):
        mon = mod.QualityMonitor()
        mon.observe(None, "m", model, layout, 1, shifted, "raw")
        reports.append(mon.snapshot()["models"]["m"])
    ours, theirs = reports
    assert [f["name"] for f in ours["features"]] \
        == [f["name"] for f in theirs["features"]]
    for f, jf in zip(ours["features"], theirs["features"]):
        assert f["psi"] == jf["psi"] and f["js"] == jf["js"]
    assert ours["feature_max"] == theirs["feature_max"] == "Column_0"
    assert ours["level"] == theirs["level"] == "alert"
