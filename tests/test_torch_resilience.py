"""The port's resilience plane (``lightgbm_tpu_torch/resilience.py``) and
the rest of ``utils/file_io.py``, on the CPU, after
``tests/test_resilience.py``.

Carried over: the handler's per-signal ownership and restore; the
preemption poll at an iteration boundary (the port has no fused chunk, so
a flag set before training stops the loop after iteration 1, where the JAX
package finishes its first chunk); an emergency resume byte-equal to the
uninterrupted run for GBDT, DART, GOSS and RF, with bagging and a
validation set; the early-stopping state in the emergency checkpoint;
``train()`` and CLI preemption (exit 75, the rerun resumes); the watchdog
(fires with its artifact, no false positive, the grace of the first kernel
build, which in the port is per section rather than per compiled program,
the release of a fired non-aborting watchdog's slot, ``watch`` a no-op
without one); the IO retry policy (transient ``EIO`` retried, ``ENOSPC``
fatal at once, the directory fsync's stage order, retry exhaustion, the
``io_retry_*`` parameters); a periodic checkpoint skipped on a full disk;
a registered scheme read by the loader, held against the JAX loader;
``dataset_fingerprint``, held against the JAX package's; and the C ABI's
resilience entries.

Not carried: the elastic resume cases (:491-553), which reshard a score
cache padded for another device count of a JAX mesh (the port has one
device and no padding; ``restore_train_state`` cuts a JAX checkpoint's
padded rows, tested in ``test_torch_checkpoint.py``); the telemetry case
(:464), since the port has no telemetry sink; and the predictor-fallback
and sharded-predict cases (:565-631), which test degraded paths the port
does not have: one test here pins that the port's paths leave
``fallback_counts()`` empty instead.
"""
import ctypes
import errno
import json
import os
import signal
import time

import numpy as np
import pytest

from lightgbm_tpu import resilience as jax_resilience
from lightgbm_tpu.checkpoint import dataset_fingerprint as jax_fingerprint
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinnedDataset
from lightgbm_tpu.io.loader import DatasetLoader as JaxLoader
from lightgbm_tpu.utils import file_io as jax_file_io
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import kernels, resilience
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.checkpoint import (dataset_fingerprint,
                                           list_checkpoints)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.loader import DatasetLoader
from lightgbm_tpu_torch.metric.metric import create_metrics
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.utils import file_io
from test_torch_quant import one_thread  # noqa: F401

BASE = dict(objective="regression", num_leaves=15, min_data_in_leaf=5,
            metric_freq=4, verbosity=-1)


@pytest.fixture(autouse=True)
def _restore_log_level():
    """The in-process CLI runs set the process-global log level from
    ``verbosity``; put back the level each test found, so a later test
    file in the same process still sees its warnings."""
    from lightgbm_tpu_torch.utils.log import Log
    level = Log._level
    yield
    Log.reset_level(level)


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    """Every test starts and ends with supervision disarmed."""
    resilience.clear_preemption()
    yield
    resilience.clear_preemption()
    resilience.uninstall_preemption_handler()
    resilience.stop_watchdog()
    resilience.clear_stall()
    file_io.set_fault_hook(None)


def make_data(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 5))
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 2)
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def build_booster(params, n_iter, snapshot_freq=-1, valid=True):
    cfg = Config(dict(params, num_iterations=n_iter,
                      snapshot_freq=snapshot_freq))
    X, y = make_data()
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=cfg.max_bin,
                                   min_data_in_leaf=cfg.min_data_in_leaf)
    booster = create_boosting(cfg.boosting, cfg, ds,
                              create_objective(cfg.objective, cfg,
                                               device="cpu"), device="cpu")
    booster.add_train_metrics(create_metrics(cfg.metric, cfg))
    if valid:
        Xv, yv = make_data(200, 7)
        vs = BinnedDataset.from_matrix(Xv, label=yv, reference=ds)
        booster.add_valid_data(vs, "valid_1")
    return booster


def preempt_after(booster, n_iters):
    """Set the preemption flag when iteration ``n_iters`` has been trained
    (a signal may land at any time; the loop looks at the flag at the next
    iteration end, so this is the earliest point it can be seen)."""
    orig = booster.watched_iter

    def one(*a, **k):
        r = orig(*a, **k)
        if booster.iter_ == n_iters:
            resilience.request_preemption()
        return r

    booster.watched_iter = one


# ---- signal handling ----

def test_handler_install_ownership():
    """Ownership is per signal: a second installer owns only the signals
    it added, and its disarm leaves the first owner's armed."""
    try:
        assert resilience.install_preemption_handler(
            (signal.SIGTERM,)) == (signal.SIGTERM,)
        assert resilience.install_preemption_handler((signal.SIGTERM,)) == ()
        owned, wd = resilience.arm_supervision(True, 0.0)
        assert owned == (signal.SIGINT,) and not wd
        resilience.disarm_supervision(owned, wd)
        assert signal.getsignal(signal.SIGTERM) is \
            resilience._on_preempt_signal
        assert signal.getsignal(signal.SIGINT) is not \
            resilience._on_preempt_signal
    finally:
        resilience.uninstall_preemption_handler()


def test_install_uninstall_restores_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        resilience.install_preemption_handler()
        assert not resilience.preemption_requested()
        signal.raise_signal(signal.SIGTERM)
        assert resilience.preemption_requested()
        assert seen == []  # our handler, not the previous one
        resilience.uninstall_preemption_handler()
        signal.raise_signal(signal.SIGTERM)
        assert seen == [signal.SIGTERM]  # the previous handler is back
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---- emergency checkpoints ----

def test_preemption_polled_at_iteration_boundary(tmp_path, one_thread):
    """A flag set before training stops the loop at the first iteration
    end, with trees and iteration aligned and the emergency checkpoint at
    that iteration."""
    out = str(tmp_path / "model.txt")
    booster = build_booster(dict(BASE), 20, snapshot_freq=7)
    resilience.request_preemption()
    with pytest.raises(resilience.TrainingPreempted) as exc:
        booster.train(snapshot_out=out)
    assert exc.value.iteration == 1
    assert booster.num_trees == 1
    assert [i for i, _ in list_checkpoints(out)] == [1]
    assert exc.value.checkpoint_path == out + ".ckpt_iter_1"
    assert exc.value.checkpoint_seconds >= 0
    assert not resilience.preemption_requested()  # the flag was consumed


@pytest.mark.parametrize("extra", [
    dict(bagging_fraction=0.8, bagging_freq=3),
    dict(boosting="dart", bagging_fraction=0.8, bagging_freq=2),
    dict(boosting="goss", learning_rate=0.3),
    dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1,
         feature_fraction=0.8),
], ids=["gbdt_bagging", "dart", "goss", "rf"])
def test_emergency_resume_bit_exact(tmp_path, extra, one_thread):
    """train(N) == train, preempted at iteration 5, resumed in a fresh
    booster: the same model text and train score bytes."""
    params = dict(BASE, **extra)
    total = 12
    out = str(tmp_path / "model.txt")
    full = build_booster(params, total)
    full.train()

    pre = build_booster(params, total)
    preempt_after(pre, 5)
    with pytest.raises(resilience.TrainingPreempted) as exc:
        pre.train(snapshot_out=out)
    assert exc.value.iteration == 5
    assert not resilience.preemption_requested()

    resumed = build_booster(params, total)
    assert resumed.resume_from_checkpoint(out) == 5
    resumed.train()
    assert resumed.save_model_to_string() == full.save_model_to_string()
    assert resumed.train_score.numpy().tobytes() == \
        full.train_score.numpy().tobytes()
    for a, b in zip(resumed.valid_sets, full.valid_sets):
        assert a["score"].numpy().tobytes() == b["score"].numpy().tobytes()


def test_emergency_checkpoint_carries_early_stopping_state(tmp_path,
                                                          one_thread):
    """The poll sits after the eval of an evaluation iteration, so the
    emergency checkpoint holds the early-stopping state a periodic one
    would, and the resumed run's patience goes on."""
    params = dict(BASE, early_stopping_round=3, metric_freq=2)
    total = 16
    out = str(tmp_path / "model.txt")
    full = build_booster(params, total)
    full.train()

    pre = build_booster(params, total)
    preempt_after(pre, 6)
    with pytest.raises(resilience.TrainingPreempted) as exc:
        pre.train(snapshot_out=out)
    assert pre._es_state
    resumed = build_booster(params, total)
    resumed.resume_from_checkpoint(out)
    assert resumed._es_state == pre._es_state
    assert resumed.iter_ == exc.value.iteration == 6
    resumed.train()
    assert resumed.save_model_to_string() == full.save_model_to_string()


def test_engine_train_preemption(tmp_path, one_thread):
    X, y = make_data()
    prefix = str(tmp_path / "engine_ckpt")
    params = dict(objective="regression", num_leaves=15, min_data_in_leaf=5,
                  snapshot_freq=4, verbosity=-1)
    full = P.train(params, P.Dataset(X, label=y), num_boost_round=12,
                   device="cpu")

    def preempt_at(env):
        if env.iteration == 7:
            resilience.request_preemption()

    with pytest.raises(resilience.TrainingPreempted) as exc:
        P.train(params, P.Dataset(X, label=y), num_boost_round=12,
                checkpoint_prefix=prefix, preemption_checkpoint=True,
                callbacks=[preempt_at], device="cpu")
    # raised in iteration 7's callback, seen at that iteration's end (8
    # trees), as in the JAX package
    assert exc.value.iteration == 8
    assert exc.value.checkpoint_path == prefix + ".ckpt_iter_8"
    assert not resilience.preemption_requested()
    # the handlers the call installed are gone again
    assert signal.getsignal(signal.SIGTERM) is not \
        resilience._on_preempt_signal
    resumed = P.train(params, P.Dataset(X, label=y), num_boost_round=12,
                      checkpoint_prefix=prefix, device="cpu")
    assert resumed.model_to_string() == full.model_to_string()
    assert list_checkpoints(prefix) == []


def test_engine_preemption_param_and_no_flag(tmp_path, one_thread):
    """The parameter arms it too, and an armed run that is not preempted
    trains as an unarmed one."""
    X, y = make_data()
    params = dict(objective="regression", num_leaves=15, min_data_in_leaf=5,
                  verbosity=-1)
    plain = P.train(params, P.Dataset(X, label=y), num_boost_round=4,
                    device="cpu")
    armed = P.train(dict(params, preemption_checkpoint=True,
                         watchdog_timeout_s=600), P.Dataset(X, label=y),
                    num_boost_round=4,
                    checkpoint_prefix=str(tmp_path / "p"), device="cpu")
    assert armed.model_to_string().split("\nparameters:")[0] == \
        plain.model_to_string().split("\nparameters:")[0]
    assert resilience.watchdog_active() is None  # the call disarmed it
    assert resilience.last_stall() is None


def write_tsv(path, X, y):
    with open(path, "w") as fh:
        for row, lab in zip(X, y):
            fh.write("%g\t" % lab + "\t".join("%g" % v for v in row) + "\n")


def test_cli_preemption_exit_code_and_rerun_resumes(tmp_path, one_thread):
    """task=train with preemption_checkpoint=true: a preempted run exits
    75 with an emergency checkpoint and no model; the same command again
    resumes and writes the uninterrupted run's model."""
    from lightgbm_tpu_torch.cli import Application, main
    X, y = make_data()
    data = str(tmp_path / "train.tsv")
    write_tsv(data, X, y)

    def argv(out):
        return ["task=train", "data=" + data, "output_model=" + out,
                "objective=regression", "num_iterations=12",
                "num_leaves=15", "min_data_in_leaf=5", "metric_freq=4",
                "is_provide_training_metric=true",
                "preemption_checkpoint=true", "verbosity=-1"]

    ref_out = str(tmp_path / "ref.txt")
    Application(argv(ref_out), device="cpu").run()

    out = str(tmp_path / "model.txt")
    resilience.request_preemption()
    with pytest.raises(SystemExit) as exc:
        Application(argv(out), device="cpu").run()
    assert exc.value.code == resilience.EXIT_PREEMPTED == 75
    assert [i for i, _ in list_checkpoints(out)] == [1]
    assert not os.path.exists(out)

    assert main(argv(out), device="cpu") == 0  # resumes and completes

    def body(path):
        text = open(path).read()
        return text[:text.index("\nparameters:")]

    assert body(out) == body(ref_out)
    assert list_checkpoints(out) == []


def test_preemption_between_ingest_chunks(tmp_path):
    """A flag set during a streaming load stops it between chunks with
    TrainingPreempted(0), as the JAX loader does; nothing is written."""
    X, y = make_data()
    data = str(tmp_path / "train.tsv")
    write_tsv(data, X, y)
    for module, loader in (
            (resilience, DatasetLoader(Config(data_chunk_rows=100))),
            (jax_resilience, JaxLoader(JaxConfig(dict(data_chunk_rows=100))))):
        module.request_preemption()
        with pytest.raises(module.TrainingPreempted) as exc:
            loader.load_from_file(data)
        assert exc.value.iteration == 0
        assert not module.preemption_requested()


# ---- the watchdog ----

def test_watchdog_fires_on_stalled_dispatch(tmp_path):
    art = str(tmp_path / "stall.json")
    hits = []
    resilience.start_watchdog(0.25, artifact=art, abort=False,
                              on_stall=hits.append)
    t0 = time.monotonic()
    with resilience.watch("train_one_iter", iteration=5):
        while not hits and time.monotonic() - t0 < 2.0:
            time.sleep(0.02)
    assert hits, "the watchdog did not fire on a stalled section"
    assert time.monotonic() - t0 < 2 * 0.25 + 0.3
    diag = hits[0]
    assert diag["section"] == "train_one_iter"
    assert diag["stall_s"] >= 0.25
    assert diag["info"] == {"iteration": 5}
    assert resilience.last_stall() is diag
    on_disk = json.load(open(art))
    assert on_disk["section"] == "train_one_iter"
    for key in ("launches", "kernel_build_s", "host_phases", "devices"):
        assert key in on_disk
    assert on_disk["devices"] == ["cpu"]


def test_watchdog_no_false_positive_on_progress():
    hits = []
    resilience.start_watchdog(0.4, abort=False, on_stall=hits.append)
    for i in range(8):
        with resilience.watch("train_one_iter", iteration=i):
            time.sleep(0.05)
    time.sleep(0.5)  # no open section: nothing to fire on
    assert hits == []


def test_watchdog_grace_on_first_build(monkeypatch):
    """A section that may launch a kernel and opens before the kernels
    are built may hold their nvcc build: it gets the grace bar.  Once they
    are built, the plain timeout applies."""
    monkeypatch.setattr(kernels._STATE, "build_seconds", None)
    hits = []
    resilience.start_watchdog(0.15, abort=False, on_stall=hits.append,
                              first_dispatch_grace=10.0)
    with resilience.watch("train_one_iter", builds=True):
        time.sleep(0.5)  # > timeout, < the grace bar of 1.5 s
    assert hits == []
    monkeypatch.setattr(kernels._STATE, "build_seconds", 3.0)
    with resilience.watch("train_one_iter", builds=True):
        t0 = time.monotonic()
        while not hits and time.monotonic() - t0 < 2.0:
            time.sleep(0.02)
    assert hits and hits[0]["stall_s"] >= 0.15


def test_watchdog_grace_is_per_section(monkeypatch):
    """The bar is fixed when a section opens: a section that opened before
    the build keeps its grace after the build completes, and a section
    that launches no kernel (``builds=False``) never has one."""
    monkeypatch.setattr(kernels._STATE, "build_seconds", None)
    hits = []
    resilience.start_watchdog(0.15, abort=False, on_stall=hits.append,
                              first_dispatch_grace=10.0)
    with resilience.watch("train_one_iter", builds=True):
        monkeypatch.setattr(kernels._STATE, "build_seconds", 3.0)
        time.sleep(0.45)
    assert hits == []
    monkeypatch.setattr(kernels._STATE, "build_seconds", None)
    with resilience.watch("host_only", builds=False):
        t0 = time.monotonic()
        while not hits and time.monotonic() - t0 < 2.0:
            time.sleep(0.02)
    assert hits and hits[0]["section"] == "host_only"


def test_nonabort_watchdog_releases_active_slot():
    hits = []
    resilience.start_watchdog(0.1, abort=False, on_stall=hits.append)
    with resilience.watch("train_one_iter"):
        t0 = time.monotonic()
        while not hits and time.monotonic() - t0 < 2.0:
            time.sleep(0.02)
    assert hits
    t0 = time.monotonic()
    while resilience.watchdog_active() is not None \
            and time.monotonic() - t0 < 2.0:
        time.sleep(0.02)
    assert resilience.watchdog_active() is None
    _, own_wd = resilience.arm_supervision(False, 0.5)
    assert own_wd and resilience.watchdog_active() is not None
    assert resilience.last_stall() is None  # a fresh watchdog, no evidence


def test_watch_is_noop_without_watchdog():
    assert resilience.watchdog_active() is None
    assert resilience.watchdog_status() is None
    with resilience.watch("anything", x=1):
        pass


def test_every_iteration_runs_in_a_watch_section(one_thread):
    """Booster.update (engine.train, the C ABI) and GBDT.train (the CLI)
    both train inside a watchdog section."""
    resilience.start_watchdog(600.0, abort=False)
    X, y = make_data()
    bst = P.Booster(dict(BASE), P.Dataset(X, label=y), device="cpu")
    gbdt = bst._booster
    seen = []
    orig = gbdt.train_one_iter

    def one(*a, **k):
        seen.append(resilience.watchdog_status()["open_sections"])
        return orig(*a, **k)

    gbdt.train_one_iter = one
    bst.update()
    gbdt.config.num_iterations = 3
    gbdt.train()
    assert seen == [1, 1, 1]


# ---- IO retries ----

def test_atomic_write_retries_transient_eio(tmp_path):
    path = str(tmp_path / "f.txt")
    state = {"n": 0}

    def eio_once(stage, p):
        if stage == "written" and state["n"] == 0:
            state["n"] += 1
            raise OSError(errno.EIO, "injected")

    before = file_io.io_retry_count()
    file_io.set_fault_hook(eio_once)
    file_io.atomic_write(path, "survived")
    file_io.set_fault_hook(None)
    assert open(path).read() == "survived"
    assert file_io.io_retry_count() == before + 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_atomic_write_enospc_is_fatal_and_fast(tmp_path):
    path = str(tmp_path / "f.txt")
    file_io.atomic_write(path, "gen-1")
    attempts = []

    def full_disk(stage, p):
        if stage == "written":
            attempts.append(1)
            raise OSError(errno.ENOSPC, "injected")

    file_io.set_fault_hook(full_disk)
    with pytest.raises(OSError) as exc:
        file_io.atomic_write(path, "gen-2")
    file_io.set_fault_hook(None)
    assert exc.value.errno == errno.ENOSPC
    assert len(attempts) == 1
    assert open(path).read() == "gen-1"


def test_atomic_write_dir_fsync_stage_order(tmp_path):
    path = str(tmp_path / "f.txt")
    stages = []
    file_io.set_fault_hook(lambda s, p: stages.append(s))
    file_io.atomic_write(path, "x")
    file_io.set_fault_hook(None)
    assert stages == ["written", "synced", "replaced"]


def test_retry_exhaustion_raises(tmp_path):
    file_io.configure_retries(attempts=2, base_delay=0.001)
    calls = []
    try:
        def always_eio(stage, p):
            if stage == "written":
                calls.append(1)
                raise OSError(errno.EIO, "injected")
        file_io.set_fault_hook(always_eio)
        with pytest.raises(OSError):
            file_io.atomic_write(str(tmp_path / "f.txt"), "x")
        assert len(calls) == 2
    finally:
        file_io.set_fault_hook(None)
        file_io.configure_retries(attempts=3, base_delay=0.05)


def test_retry_params_configure_the_policy():
    """``io_retry_attempts`` / ``io_retry_backoff_s`` set the process-wide
    policy, as in the JAX package's config."""
    try:
        Config(io_retry_attempts=5, io_retry_backoff_s=0.01)
        JaxConfig(dict(io_retry_attempts=5, io_retry_backoff_s=0.01))
        assert file_io._RETRY == jax_file_io._RETRY == \
            {"attempts": 5, "base_delay": 0.01}
    finally:
        file_io.configure_retries(attempts=3, base_delay=0.05)
        jax_file_io.configure_retries(attempts=3, base_delay=0.05)


def test_periodic_checkpoint_skipped_on_disk_full(tmp_path, one_thread):
    out = str(tmp_path / "model.txt")

    def full_disk(stage, path):
        if stage == "written" and (".ckpt_iter_" in path
                                   or ".snapshot_iter_" in path):
            raise OSError(errno.ENOSPC, "injected")

    booster = build_booster(dict(BASE), 12, snapshot_freq=5)
    file_io.set_fault_hook(full_disk)
    booster.train(snapshot_out=out)
    file_io.set_fault_hook(None)
    assert booster.num_trees == 12
    assert list_checkpoints(out) == []
    booster.save_model(out)
    assert os.path.exists(out)


# ---- the scheme registry ----

def test_registered_scheme_through_the_loader(tmp_path):
    """A registered ``mem://`` scheme serves the data file's checks and
    its side files to the loader, as the JAX loader reads them."""
    n = 60
    rng = np.random.RandomState(3)
    base = tmp_path / "train.tsv"
    weights = rng.uniform(0.5, 2.0, n)
    np.savetxt(str(base) + ".weight", weights)
    np.savetxt(str(base) + ".query", [20, 25, 15], fmt="%d")
    np.savetxt(str(base) + ".init", rng.normal(size=n))

    def opener(path, mode):
        return open(os.path.join(str(tmp_path), path.split("://", 1)[1]),
                    mode)

    file_io.register_scheme("mem", opener)
    jax_file_io.register_scheme("mem", opener)
    try:
        assert file_io.exists("mem://train.tsv.weight")
        assert not file_io.exists("mem://absent")
        ours = DatasetLoader(Config())._side_files("mem://train.tsv", None,
                                                   None, 0, n)
        theirs = JaxLoader(JaxConfig())._side_files("mem://train.tsv", None,
                                                    None, 0, n)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[0], np.loadtxt(str(base)
                                                          + ".weight"))
        np.testing.assert_array_equal(ours[1], [20, 25, 15])
        with pytest.raises(Exception, match="does not exist"):
            DatasetLoader(Config()).load_from_file("mem://absent.tsv")
    finally:
        file_io._SCHEMES.pop("mem", None)
        jax_file_io._SCHEMES.pop("mem", None)
    with pytest.raises(OSError, match="No file-IO handler"):
        file_io.open_file("nope://x")


def test_hdfs_without_pyarrow_raises_by_name(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(OSError, match="hdfs:// paths need pyarrow"):
        file_io.open_file("hdfs://namenode/x", "rb")


# ---- the fingerprint ----

def test_dataset_fingerprint_stable_sensitive_and_equal_to_jax():
    X, y = make_data()
    a = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    b = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    assert dataset_fingerprint(a) == dataset_fingerprint(b)
    assert dataset_fingerprint(a) == jax_fingerprint(
        JaxBinnedDataset.from_matrix(X, label=y, max_bin=255))
    Xw, yw = make_data(seed=1)
    c = BinnedDataset.from_matrix(Xw, label=yw, max_bin=255)
    assert dataset_fingerprint(a)["bin_digest"] != \
        dataset_fingerprint(c)["bin_digest"]
    d = BinnedDataset.from_matrix(X[:-1], label=y[:-1], max_bin=255)
    assert dataset_fingerprint(d)["num_rows"] == len(X) - 1


# ---- the C ABI's entries and the fallback counter ----

def test_c_api_resilience_entries():
    from lightgbm_tpu_torch import c_api
    table = c_api.bind()
    flag = ctypes.c_int64(-1)
    assert table["LGBM_PreemptionRequested"](ctypes.addressof(flag)) == 0
    assert flag.value == 0
    resilience.request_preemption()
    assert table["LGBM_PreemptionRequested"](ctypes.addressof(flag)) == 0
    assert flag.value == 1
    resilience.clear_preemption()
    try:
        assert table["LGBM_PreemptionInstall"]() == 0
        assert signal.getsignal(signal.SIGTERM) is \
            resilience._on_preempt_signal
    finally:
        resilience.uninstall_preemption_handler()
    count = ctypes.c_int64(-1)
    assert table["LGBM_PredictFallbackCount"](ctypes.addressof(count)) == 0
    assert count.value == sum(resilience.fallback_counts().values()) == 0


def test_port_paths_leave_fallback_counts_empty(one_thread):
    """The port has no degraded path: training, every prediction path and
    the binned forms count no fallback."""
    resilience.reset_fallbacks()
    X, y = make_data(600)
    bst = P.train(dict(BASE, objective="binary"),
                  P.Dataset(X, label=(y > 0).astype(float)),
                  num_boost_round=3, device="cpu")
    for kw in (dict(), dict(raw_score=True), dict(pred_leaf=True),
               dict(pred_contrib=True), dict(precision="bf16")):
        bst.predict(X, **kw)
        bst.predict(X[:5], **kw)
    bst._booster.predict_binned()
    assert resilience.fallback_counts() == {}
    from lightgbm_tpu_torch.c_api import _impl_predict_fallback_count
    assert _impl_predict_fallback_count() == 0
