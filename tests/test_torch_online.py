"""The port's train-while-serve loop (``lightgbm_tpu_torch/online``) against
the JAX package's (``lightgbm_tpu/online``), on the CPU.

- ``RowBuffer`` and ``RetrainPolicy`` take the same decisions as the JAX
  package's on scripted sequences and input grids;
- the warm-start continuation: ``train(k)`` -> publish -> continue to
  ``k + m`` equals checkpoint-resume at the same boundary byte for byte
  (bagging on), and equals the JAX package's continuation's trees at 63
  bins;
- the controller through ``serve_and_train(..., device="cpu")``: extend and
  refit cycles, window binning against the live layout, the persisted
  window and a preempted cycle resumed, ``publish_out`` warm start, the
  drift trigger, the freshness gauges, the summary's ``online`` block and
  the ``/healthz`` online block.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.boosting import create_boosting as j_create_boosting
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.objective import create_objective as j_create_objective
from lightgbm_tpu.online import RetrainPolicy as JRetrainPolicy
from lightgbm_tpu.online import RowBuffer as JRowBuffer
from lightgbm_tpu_torch import obs, serve_and_train
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.online import (OnlineController, RetrainPolicy,
                                       RowBuffer)
from lightgbm_tpu_torch.online.controller import WINDOW_SUFFIX
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_bagging import assert_same_trees
from test_torch_quant import one_thread  # noqa: F401

CPU = "cpu"


def _make_xy(seed, n=400, shift=None):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 5))
    if shift is not None:
        X[:, 0] = rng.uniform(*shift, size=n)
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 2)
         + 0.1 * rng.normal(size=n)).astype(np.float64)
    return X, y


CFG = dict(objective="regression", num_leaves=8, min_data_in_leaf=5,
           verbosity=-1, max_bin=63)


def _bootstrap(seed=0, n=400, rounds=4, train=True, **params):
    X, y = _make_xy(seed, n)
    cfg = Config(dict(CFG, num_iterations=rounds, **params))
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63,
                                   min_data_in_leaf=5)
    b = create_boosting(cfg.boosting, cfg, ds,
                        create_objective(cfg.objective, cfg, CPU),
                        device=CPU)
    if train:
        b.train()
    return b, ds, X, y


def _jax_bootstrap(seed=0, n=400, rounds=4, train=True, **params):
    X, y = _make_xy(seed, n)
    cfg = JConfig(**dict(CFG, num_iterations=rounds, **params))
    ds = JBinnedDataset.from_matrix(X, label=y, max_bin=63,
                                    min_data_in_leaf=5)
    b = j_create_boosting(cfg.boosting, cfg, ds,
                          j_create_objective(cfg.objective, cfg))
    if train:
        b.train()
    return b, ds


def _params(**over):
    p = {"objective": "regression", "verbosity": -1,
         "online_rounds": 2, "online_min_rows": 0, "online_interval_s": 0,
         "online_drift_trigger": False, "online_poll_s": 0.02,
         "max_batch_wait_us": 0}
    p.update(over)
    return p


def _text(b):
    t = b.save_model_to_string()
    return t[:t.index("\nparameters:")]


@pytest.fixture(autouse=True)
def _no_leaked_run():
    yield
    obs.disable()


# ---- RowBuffer and RetrainPolicy, beside the JAX package's ----

def _buffer_script(cls, steps, max_rows):
    buf = cls(width=3, max_rows=max_rows)
    out = []
    for op, n, extra in steps:
        if op == "ingest":
            X = np.arange(n * 3, dtype=np.float64).reshape(n, 3) + extra
            w = np.full(n, 2.0) if extra % 2 else None
            out.append(("ingest", buf.ingest(X, np.full(n, extra),
                                             weight=w)))
        elif op == "window":
            X, y, w, taken = buf.window(max_rows=n)
            out.append(("window", X.tolist(), y.tolist(),
                        None if w is None else w.tolist(), taken))
            if extra:
                buf.mark_trained(taken)
        out.append((buf.rows_ingested, buf.rows_trained, buf.rows_dropped,
                    buf.rows_behind(), buf.buffered))
    return out


BUFFER_SCRIPTS = {
    "accounting": (100, [("ingest", 10, 0), ("window", 0, 1),
                         ("ingest", 4, 1), ("window", 6, 0),
                         ("window", 0, 1)]),
    "drop_oldest": (10, [("ingest", 6, 2), ("ingest", 6, 4),
                         ("window", 0, 1), ("ingest", 3, 5),
                         ("window", 4, 0)]),
    "over_cap_chunk": (5, [("ingest", 3, 0), ("ingest", 9, 3),
                           ("window", 0, 1), ("ingest", 1, 6)]),
    "behind_evicted": (8, [("ingest", 4, 0), ("window", 0, 0),
                           ("ingest", 4, 1), ("ingest", 4, 2),
                           ("window", 3, 1), ("ingest", 7, 3)]),
}


@pytest.mark.parametrize("name", list(BUFFER_SCRIPTS))
def test_row_buffer_decides_as_the_jax_buffer(name):
    max_rows, steps = BUFFER_SCRIPTS[name]
    assert _buffer_script(RowBuffer, steps, max_rows) == _buffer_script(
        JRowBuffer, steps, max_rows)


def test_row_buffer_validation():
    buf = RowBuffer(width=3, max_rows=10)
    with pytest.raises(LightGBMError):
        buf.ingest(np.zeros((2, 4)), np.zeros(2))
    with pytest.raises(LightGBMError):
        buf.ingest(np.zeros((2, 3)), np.zeros(3))
    with pytest.raises(LightGBMError):
        buf.ingest(np.zeros((2, 3)), np.zeros(2), weight=np.ones(3))


POLICIES = [dict(min_rows=100, interval_s=50.0, drift_trigger=True,
                 max_rows_behind=500, max_seconds_behind=200.0),
            dict(min_rows=0, interval_s=0.0, drift_trigger=False),
            dict(min_rows=1, drift_trigger=False),
            dict(min_rows=0, interval_s=10.0, drift_trigger=True,
                 drift_min_rows=5)]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_decides_as_the_jax_policy(kw):
    ours, theirs = RetrainPolicy(**kw), JRetrainPolicy(**kw)
    assert ours.active() == theirs.active()
    now = 1000.0
    for behind in (0, 1, 99, 100, 150, 499, 500, 600):
        for last in (now, now - 9.0, now - 60.0, now - 199.0, now - 300.0):
            for q in (None, {}, {"level": "alert", "rows": 1000},
                      {"level": "alert", "rows": 4},
                      {"level": "warn", "rows": 1000}):
                assert ours.reason(behind, last, q, now=now) == \
                    theirs.reason(behind, last, q, now=now), (behind, last, q)


def test_policy_from_config():
    cfg = Config(online_min_rows=7, online_interval_s=3.0,
                 online_drift_trigger=False, online_max_rows_behind=9)
    p = RetrainPolicy.from_config(cfg)
    assert (p.min_rows, p.interval_s, p.drift_trigger,
            p.max_rows_behind) == (7, 3.0, False, 9)


# ---- the warm-start continuation contract ----

BAG = dict(bagging_fraction=0.8, bagging_freq=1, snapshot_freq=2)


def test_continuation_equals_checkpoint_resume(tmp_path):
    k, m = 4, 4
    ref = _bootstrap(rounds=k + m, **BAG)[0]
    a = _bootstrap(rounds=k, **BAG)[0]
    prefix = str(tmp_path / "ck")
    a.save_checkpoint(prefix)
    b2 = _bootstrap(rounds=k + m, train=False, **BAG)[0]
    assert b2.resume_from_checkpoint(prefix) == k
    b2.train()
    assert _text(b2) == _text(ref)
    pub = _bootstrap(rounds=k, **BAG)[0]
    c, ds_c = _bootstrap(rounds=k + m, train=False, **BAG)[:2]
    assert c.warm_start_continuation(pub.save_model_to_string(),
                                     train_data=ds_c,
                                     objective=c.objective) == k
    c.train()
    assert _text(c) == _text(ref) == _text(b2)


def test_continuation_equals_the_jax_continuation(one_thread):
    k, m = 3, 3
    pub = _bootstrap(rounds=k, **BAG)[0]
    text = pub.save_model_to_string()
    c, ds_c = _bootstrap(rounds=k + m, train=False, **BAG)[:2]
    c.warm_start_continuation(text, train_data=ds_c, objective=c.objective)
    c.train()
    jc, jds = _jax_bootstrap(rounds=k + m, train=False, **BAG)
    assert jc.warm_start_continuation(text, train_data=jds,
                                      objective=jc.objective) == k
    jc.train()
    assert_same_trees(jc.models, c.models)


def test_window_dataset_clones_mappers_with_window_occupancy():
    b, ds, X, y = _bootstrap()
    ctrl = OnlineController.__new__(OnlineController)
    ctrl.base_ds = ds
    Xw, yw = _make_xy(3, 120)
    wds = OnlineController._window_dataset(ctrl, Xw, yw, None)
    assert wds.num_data == 120 and wds.group_idx is ds.group_idx
    for i, (mb, mw) in enumerate(zip(ds.bin_mappers, wds.bin_mappers)):
        assert mw is not mb
        if not mb.is_trivial:
            np.testing.assert_array_equal(mw.bin_upper_bound,
                                          mb.bin_upper_bound)
            want = np.bincount(mb.values_to_bins(Xw[:, i]),
                               minlength=mb.num_bin)
            np.testing.assert_array_equal(mw.cnt_in_bin, want)
    np.testing.assert_array_equal(
        wds.binned, BinnedDataset.from_matrix(Xw, label=yw,
                                              reference=ds).binned)


# ---- the controller ----

def test_controller_extend_cycle_and_stats():
    b, ds, X, y = _bootstrap()
    ctrl = serve_and_train(b, train_set=ds, params=_params(), name="m",
                           device=CPU)
    try:
        assert ctrl.generation == 1
        it0 = ctrl.booster.iter_
        ctrl.ingest(*_make_xy(5, 150))
        assert ctrl.run_cycle("manual")
        st = ctrl.stats()
        assert st["generation"] == 2 and st["cycles"] == 1
        assert st["iterations"] == it0 + 2
        assert st["rows_behind"] == 0
        assert st["rows_ingested"] == 150 == st["rows_trained"]
        ref = ctrl.predict(X[:8].astype(np.float32))
        ctrl.ingest(*_make_xy(6, 150))
        assert ctrl.run_cycle("manual")
        assert ctrl.generation == 3
        got = ctrl.predict(X[:8].astype(np.float32))
        assert not np.array_equal(ref, got)
        # the response equals the live generation's own predictor
        from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
        live = FusedPredictor(ctrl.booster.models, device=CPU)
        np.testing.assert_array_equal(
            np.asarray(got, np.float64).ravel(),
            np.asarray(live(X[:8].astype(np.float32)), np.float64).ravel())
    finally:
        ctrl.close()
    assert ctrl.stats()["serving"]["dropped"] == 0


def test_empty_window_and_fresh_rows_guard():
    b, ds, X, y = _bootstrap()
    ctrl = serve_and_train(b, train_set=ds, params=_params(), name="m",
                           device=CPU)
    try:
        assert not ctrl.run_cycle("manual")
        ctrl.ingest(*_make_xy(5, 50))
        assert ctrl.run_cycle("manual")
        assert not ctrl.run_cycle("flush", require_fresh=True)
        assert ctrl.generation == 2
        with pytest.raises(LightGBMError):
            ctrl.ingest(np.zeros((3, 2)), np.zeros(3))
    finally:
        ctrl.close()


def test_refit_keeps_the_structure():
    b, ds, X, y = _bootstrap()
    n_trees = b.num_trees
    ctrl = serve_and_train(b, train_set=ds, params=_params(
        online_update="refit", online_window_rows=128), name="m",
        device=CPU)
    try:
        ref = ctrl.predict(X[:8].astype(np.float32))
        ctrl.ingest(*_make_xy(5, 128))
        assert ctrl.run_cycle("refit")
        got = ctrl.predict(X[:8].astype(np.float32))
        assert ctrl.generation == 2
        assert ctrl.booster.num_trees == n_trees
        assert not np.array_equal(ref, got)
    finally:
        ctrl.close()


def test_window_persist_and_preempted_cycle_resume(tmp_path):
    """A cycle whose process died after persisting its window is replayed
    by the next controller on the same prefix and publishes the same
    generation an uninterrupted cycle would."""
    Xf, yf = _make_xy(5, 60)
    b, ds, X, y = _bootstrap()
    ctrl = serve_and_train(b, train_set=ds, params=_params(), name="m",
                           device=CPU)
    ctrl.ingest(Xf, yf)
    assert ctrl.run_cycle("manual")
    want = ctrl.predict(X[:8].astype(np.float32))
    ctrl.close()

    prefix = str(tmp_path / "model.txt")
    b2, ds2, _, _ = _bootstrap()
    ctrl2 = serve_and_train(b2, train_set=ds2, params=_params(), name="m",
                            device=CPU, checkpoint_prefix=prefix)
    meta = {"cycle": 1, "reason": "manual", "taken": 60, "mode": "extend",
            "target_iterations": 6, "rows_ingested": 60,
            "rows_trained": 0, "rows_dropped": 0}
    ctrl2._persist_window(Xf, yf, None, meta)
    pending = ctrl2._load_pending_window()
    np.testing.assert_array_equal(pending["X"], Xf)
    assert pending["w"] is None and pending["meta"] == meta
    ctrl2.close()

    b3, ds3, _, _ = _bootstrap()
    ctrl3 = serve_and_train(b3, train_set=ds3, params=_params(), name="m",
                            device=CPU, checkpoint_prefix=prefix)
    try:
        deadline = time.time() + 60
        while ctrl3.generation < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert ctrl3.generation == 2 and ctrl3.cycles == 1
        np.testing.assert_array_equal(
            ctrl3.predict(X[:8].astype(np.float32)), want)
        assert not os.path.exists(prefix + WINDOW_SUFFIX)
    finally:
        ctrl3.close()


def test_publish_out_warm_start(tmp_path):
    prefix = str(tmp_path / "model.txt")
    b, ds, X, y = _bootstrap()
    ctrl = serve_and_train(b, train_set=ds, params=_params(), name="m",
                           publish_out=prefix, device=CPU)
    ctrl.ingest(*_make_xy(5, 100))
    assert ctrl.run_cycle("manual")
    want = ctrl.predict(X[:8].astype(np.float32))
    iters = ctrl.booster.iter_
    ctrl.close()
    b2, ds2, _, _ = _bootstrap()
    ctrl2 = serve_and_train(b2, train_set=ds2, params=_params(), name="m",
                            publish_out=prefix, device=CPU)
    try:
        assert ctrl2.booster.iter_ == iters
        np.testing.assert_array_equal(
            want, ctrl2.predict(X[:8].astype(np.float32)))
    finally:
        ctrl2.close()


def test_drift_triggered_cycle_comes_back_clean(tmp_path):
    tele = obs.configure(out=str(tmp_path / "drift.jsonl"), freq=1)
    b, ds, X, y = _bootstrap(n=600)
    ctrl = serve_and_train(b, train_set=ds, params=_params(
        online_drift_trigger=True), name="m", device=CPU)
    try:
        Xs, ys = _make_xy(21, 600, shift=(5.0, 9.0))
        for lo in range(0, 600, 100):
            ctrl.predict(Xs[lo:lo + 100].astype(np.float32))
        ctrl.ingest(Xs, ys)
        from lightgbm_tpu_torch.obs import quality
        mon = quality.monitor(tele)
        assert mon.snapshot()["models"]["m"]["level"] == "alert"
        deadline = time.time() + 60
        while ctrl.generation < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert ctrl.generation >= 2, (ctrl.stats(), ctrl.last_error)
        assert ctrl.last_trigger == "drift"
        for lo in range(0, 600, 100):
            ctrl.predict(Xs[lo:lo + 100].astype(np.float32))
        snap = mon.snapshot()["models"]["m"]
        assert snap["generation"] >= 2 and snap["level"] == "ok", snap
    finally:
        ctrl.close()


def test_freshness_summary_and_healthz(tmp_path):
    """The rows-behind gauge falls to 0 at each publish, the summary's
    ``online`` block counts the cycles by trigger, and ``/healthz`` carries
    the controller's block while it runs."""
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    out = str(tmp_path / "online.jsonl")
    b, ds, X, y = _bootstrap()
    ctrl = serve_and_train(b, train_set=ds, params=_params(
        telemetry_out=out, metrics_port=port, online_min_rows=50),
        name="m", device=CPU)
    try:
        tele = obs.active()
        behind = []
        for seed in (7, 8):
            ctrl.ingest(*_make_xy(seed, 60))
            deadline = time.time() + 60
            while ctrl.buffer.rows_behind() and time.time() < deadline:
                time.sleep(0.02)
            behind.append(tele.gauge("online_rows_behind").value)
        assert behind == [0, 0] and ctrl.generation == 3
        health = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % port, timeout=30).read())
        onl = [v for k, v in health.items() if k.startswith("online")]
        assert onl and onl[0]["generation"] == 3, health
    finally:
        ctrl.close()
    summary = json.load(open(out + ".summary.json"))
    blk = summary["online"]
    assert blk["cycles"] == 2 and blk["triggers"] == {"rows": 2}
    assert blk["generation"] == 3 and blk["rows_behind"] == 0
    assert blk["train_s"]["count"] == 2
    cycles = [e for e in obs.read_events(out) if e["kind"] == "online_cycle"]
    assert [e["rows_behind"] for e in cycles] == [0, 0]
