"""The port's CLI against the JAX package's CLI and its own Python API, on
the CPU.

``lightgbm_tpu_torch.cli`` (with ``device="cpu"``) and ``lightgbm_tpu.cli``
train on the same TSV files (1,500 rows x 8 features): the models have the
same trees (split features, thresholds, children, decision types and leaf
counts equal; leaf values within ``test_torch_train.leaf_value_tolerance``,
as f32 sums in another order give) and ``task=predict`` writes the same
``LightGBM_predict_result.txt`` within 1e-5, which equals
``Booster(model_file=...).predict`` within the ``%g`` print.  The CLI's
model text equals ``GBDT.train``'s on the Python API's dataset of the
parsed matrix.
Also: auto-resume of ``task=train`` with ``snapshot_freq`` (a run killed in
its final model write resumes from its newest checkpoint, removes its
checkpoints when it completes, and writes the model a fresh run writes), a
config file with command-line overrides, ``main`` in a subprocess (and
``python -m lightgbm_tpu_torch``, which runs on CUDA and fails without it),
``task=convert_model`` compiled with ``g++`` and equal to ``predict`` to
rtol 1e-10 on the f32 regime's rows, ``task=refit`` against the JAX
package's refit, and the planes the CLI arms: ``task=online``,
``plan_cache``, ``alert_rules`` and ``flight_recorder``.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as P
from lightgbm_tpu.cli import Application as JApplication
from lightgbm_tpu_torch import checkpoint as ckpt_mod
from lightgbm_tpu_torch import cli as cli_mod
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.cli import Application, main, parse_args
from lightgbm_tpu_torch.io.parser import parse_file
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tsv(path, X, y):
    with open(path, "w") as fh:
        for row, lab in zip(X, y):
            fh.write("%g\t" % lab + "\t".join("%g" % v for v in row) + "\n")


@pytest.fixture(autouse=True)
def _restore_log_level():
    """``Application`` sets the process-global log level from
    ``verbosity``; put back the level each test found, so a later test
    file in the same process still sees its warnings."""
    from lightgbm_tpu_torch.utils.log import Log
    level = Log._level
    yield
    Log.reset_level(level)


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    X = rng.normal(size=(1500, 8))
    logit = X[:, 0] * 2 + X[:, 1] ** 2 - 1
    y = (logit + rng.normal(scale=0.5, size=1500) > 0).astype(float)
    train, test = str(tmp / "data.train"), str(tmp / "data.test")
    write_tsv(train, X[:1200], y[:1200])
    write_tsv(test, X[1200:], y[1200:])
    return tmp, train, test, X, y


def run(argv):
    Application(argv, device="cpu").run()


def assert_same_trees(path_a, path_b, n):
    a = P.Booster(model_file=path_a, device="cpu")._booster.models
    b = P.Booster(model_file=path_b, device="cpu")._booster.models
    assert len(a) == len(b)
    for i, (ta, tb) in enumerate(zip(a, b)):
        nl = ta.num_leaves
        assert tb.num_leaves == nl, "tree %d" % i
        for name in ("split_feature", "threshold", "left_child",
                     "right_child", "decision_type"):
            np.testing.assert_array_equal(getattr(ta, name)[:nl - 1],
                                          getattr(tb, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(ta.leaf_count[:nl], tb.leaf_count[:nl])
        np.testing.assert_array_less(
            np.abs(ta.leaf_value[:nl] - tb.leaf_value[:nl]),
            leaf_value_tolerance(tb, n), err_msg="tree %d" % i)


def trees_text(path):
    with open(path) as fh:
        text = fh.read()
    return text[:text.index("\nparameters:")]


TRAIN = ["task=train", "objective=binary", "num_trees=20", "num_leaves=15",
         "max_bin=63",
         "verbosity=-1", "metric=binary_logloss"]


def test_train_predict_match_jax_and_python(data_files, one_thread):
    tmp, train, test, X, y = data_files
    model, jmodel = str(tmp / "model.txt"), str(tmp / "jmodel.txt")
    out, jout = str(tmp / "preds.txt"), str(tmp / "jpreds.txt")
    run(TRAIN + ["data=%s" % train, "valid=%s" % test,
                 "output_model=%s" % model])
    JApplication(TRAIN + ["data=%s" % train, "valid=%s" % test,
                          "output_model=%s" % jmodel]).run()
    assert_same_trees(model, jmodel, 1200)
    run(["task=predict", "data=%s" % test, "input_model=%s" % model,
         "output_result=%s" % out, "verbosity=-1"])
    JApplication(["task=predict", "data=%s" % test,
                  "input_model=%s" % jmodel, "output_result=%s" % jout,
                  "verbosity=-1"]).run()
    cli_preds = np.loadtxt(out)
    np.testing.assert_allclose(cli_preds, np.loadtxt(jout), rtol=0,
                               atol=1e-5)
    assert len(cli_preds) == 300
    bst = P.Booster(model_file=model, device="cpu")
    feats, _, _ = parse_file(test, label_idx=0)
    np.testing.assert_allclose(cli_preds, bst.predict(feats), rtol=1e-5)
    assert np.mean((cli_preds > 0.5) == y[1200:]) > 0.8


def test_cli_equals_python_api(data_files, one_thread):
    """The CLI's trees are those of the Python API's dataset of the parsed
    matrix with the same params, trained by the loop ``task=train`` runs
    (``GBDT.train``: nothing is evaluated, so its 20 iterations are one
    fused chunk, whose carried exact sums round differently from 20 single
    iterations; ``tests/test_torch_chunk.py`` holds the two paths to each
    other)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import create_objective
    tmp, train, test, X, y = data_files
    model = str(tmp / "model_api.txt")
    run(TRAIN + ["data=%s" % train, "output_model=%s" % model])
    feats, label, _ = parse_file(train, label_idx=0)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  metric="binary_logloss", max_bin=63)
    ds = P.Dataset(feats, label, params=params).construct().handle
    cfg = Config(dict(params, num_iterations=20))
    gbdt = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                device="cpu")
    gbdt.train()
    text = gbdt.save_model_to_string()
    assert trees_text(model) == text[:text.index("\nparameters:")]


def test_auto_resume(data_files, tmp_path, monkeypatch, one_thread):
    tmp, train, test, X, y = data_files
    model = str(tmp_path / "model_resume.txt")
    args = TRAIN[:2] + ["num_trees=12", "num_leaves=15", "verbosity=-1",
                        "data=%s" % train, "output_model=%s" % model,
                        "snapshot_freq=5"]

    class Preempted(RuntimeError):
        pass

    real_save = GBDT.save_model

    def die_on_final_write(self, filename, *a, **k):
        if filename == model:
            raise Preempted(filename)
        return real_save(self, filename, *a, **k)

    # run 1 dies in its final model write: the checkpoints of iterations 5
    # and 10 are on disk, the model is not
    monkeypatch.setattr(GBDT, "save_model", die_on_final_write)
    with pytest.raises(Preempted):
        run(args)
    monkeypatch.setattr(GBDT, "save_model", real_save)
    assert not os.path.exists(model)
    assert [it for it, _ in ckpt_mod.list_checkpoints(model)] == [10, 5]

    seen = {}
    real_load = ckpt_mod.load_latest_checkpoint

    def spy(prefix):
        res = real_load(prefix)
        seen["iteration"] = None if res is None else res[0]["iteration"]
        return res

    monkeypatch.setattr(cli_mod, "load_latest_checkpoint", spy)
    run(args)                      # resumes from iteration 10
    assert seen["iteration"] == 10
    assert ckpt_mod.list_checkpoints(model) == []
    with open(model) as fh:
        resumed = fh.read()
    seen.clear()
    run(args)                      # no checkpoint left: trains afresh
    assert seen["iteration"] is None
    with open(model) as fh:
        assert fh.read() == resumed


def test_config_file(data_files):
    tmp, train, test, X, y = data_files
    model = str(tmp / "model2.txt")
    conf = str(tmp / "train.conf")
    with open(conf, "w") as fh:
        fh.write("task = train\nobjective = binary\ndata = %s\n"
                 "num_trees = 5\nnum_leaves = 7\noutput_model = %s\n"
                 "verbosity = -1\n" % (train, model))
    run(["config=%s" % conf, "num_trees=3"])
    assert P.Booster(model_file=model, device="cpu").num_trees() == 3
    params = parse_args(["config=%s" % conf, "num_trees=3"])
    assert params["num_trees"] == "3"
    assert params["num_leaves"] == "7"


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_main_in_a_subprocess(data_files):
    tmp, train, test, X, y = data_files
    model = str(tmp / "model3.txt")
    argv = ["task=train", "data=%s" % train, "objective=binary",
            "num_trees=3", "num_leaves=7", "output_model=%s" % model,
            "verbosity=-1"]
    code = ("import sys; from lightgbm_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code] + argv,
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(model)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_module_runs_on_cuda_only(data_files):
    """``python -m lightgbm_tpu_torch`` runs on CUDA: without it, it fails
    and writes no model."""
    tmp, train, test, X, y = data_files
    model = str(tmp / "model4.txt")
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         "data=%s" % train, "objective=binary", "num_trees=3",
         "output_model=%s" % model],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 1
    assert "CUDA is not available" in r.stdout + r.stderr
    assert not os.path.exists(model)


def _compile(cpp, tmp_path):
    so = str(tmp_path / "pred.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", cpp, "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.Predict, lib.PredictRaw):
        fn.argtypes = [ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double)]
    return lib


def _call(fn, rows, k):
    out = np.zeros(k)
    got = []
    ptr = ctypes.POINTER(ctypes.c_double)
    for row in rows:
        arr = np.ascontiguousarray(row, dtype=np.float64)
        fn(arr.ctypes.data_as(ptr), out.ctypes.data_as(ptr))
        got.append(out.copy())
    return np.asarray(got)


@pytest.mark.parametrize("extra", [
    [], ["objective=multiclass", "num_class=3", "metric=multi_logloss"],
    ["boosting=rf", "bagging_fraction=0.6", "bagging_freq=1",
     "feature_fraction=0.8"]])
def test_convert_model_compiles_and_matches(data_files, tmp_path, extra):
    """The C++ of task=convert_model, built with g++, equals predict on
    the training rows (1,200: the f32 regime of predict) to rtol 1e-10;
    with NaN and zero values routed by the missing rules."""
    tmp, train, test, X, y = data_files
    data = train
    if extra and "multiclass" in extra[0]:
        data = str(tmp_path / "multi.train")
        write_tsv(data, X[:1200], np.digitize(X[:1200, 0], [-0.5, 0.5]))
    model = str(tmp_path / "model_cg.txt")
    run(["task=train", "data=%s" % data, "objective=binary",
         "num_trees=5", "num_leaves=15", "output_model=%s" % model,
         "verbosity=-1", "use_missing=true"] + extra)
    cpp = str(tmp_path / "pred.cpp")
    run(["task=convert_model", "input_model=%s" % model,
         "convert_model=%s" % cpp, "verbosity=-1"])
    lib = _compile(cpp, tmp_path)
    bst = P.Booster(model_file=model, device="cpu")
    feats = parse_file(data, label_idx=0)[0].copy()
    feats[::17, 0] = np.nan
    feats[::13, 1] = 0.0
    k = bst.num_model_per_iteration()
    raw = bst.predict(feats, raw_score=True).reshape(len(feats), k)
    got_raw = _call(lib.PredictRaw, feats, k)
    if bst._booster.average_output:
        got_raw = got_raw / (bst.num_trees() // k)
    np.testing.assert_allclose(got_raw, raw, rtol=1e-10, atol=0)
    if not extra:
        np.testing.assert_allclose(_call(lib.Predict, feats, 1)[:, 0],
                                   bst.predict(feats), rtol=1e-10)


def test_refit_matches_jax(data_files, one_thread):
    tmp, train, test, X, y = data_files
    model = str(tmp / "model_refit_in.txt")
    run(TRAIN + ["data=%s" % train, "output_model=%s" % model])
    out, jout = str(tmp / "refit.txt"), str(tmp / "jrefit.txt")
    args = ["task=refit", "data=%s" % test, "input_model=%s" % model,
            "objective=binary", "verbosity=-1"]
    run(args + ["output_model=%s" % out])
    JApplication(args + ["output_model=%s" % jout]).run()
    a = P.Booster(model_file=out, device="cpu")._booster.models
    b = P.Booster(model_file=jout, device="cpu")._booster.models
    old = P.Booster(model_file=model, device="cpu")._booster.models
    assert len(a) == len(b) == 20
    changed = 0
    for ta, tb, to in zip(a, b, old):
        nl = ta.num_leaves
        np.testing.assert_array_equal(ta.split_feature[:nl - 1],
                                      to.split_feature[:nl - 1])
        np.testing.assert_allclose(ta.leaf_value[:nl], tb.leaf_value[:nl],
                                   rtol=1e-5, atol=1e-7)
        changed += not np.allclose(ta.leaf_value[:nl], to.leaf_value[:nl])
    assert changed > 0


def test_timer_scopes(data_files, one_thread):
    """A CLI run's host scopes land in ``global_timer``, which the CLI
    prints at debug verbosity (``utils/timer.py``)."""
    from lightgbm_tpu_torch.utils.timer import FunctionTimer, global_timer
    tmp, train, test, X, y = data_files
    global_timer.reset()
    run(TRAIN[:2] + ["num_trees=2", "num_leaves=7", "verbosity=-1",
                     "data=%s" % train,
                     "output_model=%s" % str(tmp / "model_t.txt")])
    totals = global_timer.totals()
    for name in ("GBDT::Boosting", "GBDT::Bagging", "TreeLearner::Train",
                 "GBDT::UpdateScore"):
        assert totals[name] > 0, name
    with FunctionTimer("outer"):
        with FunctionTimer("outer"):
            pass
    assert global_timer.total("outer") > 0
    assert "TreeLearner::Train" in global_timer.summary()
    global_timer.reset()
    assert global_timer.totals() == {}


def _cache_for(train, tmp_path):
    """A tuned-plan cache keyed by the CLI learner's shape class."""
    from lightgbm_tpu_torch.plan import cache, planner
    X = parse_file(train, label_idx=0)[0]
    ds = P.Dataset(X, np.zeros(len(X))).construct().handle
    sc = planner.shape_class(ds.num_data, ds.num_features, 256,
                             device_kind="cpu")
    c = cache.PlanCache(device_kind="cpu")
    c.put(sc, planner.analytic_plan(sc)._replace(part_block_bytes=64 << 10))
    return c.save(str(tmp_path / "plans.json"))


@pytest.mark.parametrize("arg", ["task=online", "task=serve_and_train",
                                 "plan_cache=plans.json",
                                 "alert_rules=rules.json",
                                 "flight_recorder=true"])
def test_planes_from_the_cli(arg, data_files, tmp_path):
    """Each plane the CLI once refused runs: the online task (and its
    ``serve_and_train`` alias) serves the feed while it trains and writes
    the scores and the published model; ``plan_cache`` engages the tuned
    plan, ``alert_rules`` the alert engine and ``flight_recorder`` the
    incident capture, each into the run's summary."""
    import json
    from lightgbm_tpu_torch.plan import cache as plan_cache
    from lightgbm_tpu_torch.plan import state as plan_state
    _, train, test, X, y = data_files
    out = str(tmp_path / "run.jsonl")
    model = str(tmp_path / "model.txt")
    argv = ["data=%s" % train, "num_trees=3", "num_leaves=7",
            "objective=binary", "verbosity=-1", "output_model=%s" % model,
            "telemetry_out=%s" % out]
    key = arg.split("=")[0]
    if key == "task":
        result = str(tmp_path / "scores.txt")
        argv += [arg, "online_feed=%s" % test, "online_rounds=2",
                 "online_min_rows=100", "online_drift_trigger=false",
                 "output_result=%s" % result, "max_batch_wait_us=0"]
    elif key == "plan_cache":
        argv.append("plan_cache=%s" % _cache_for(train, tmp_path))
    elif key == "alert_rules":
        rules = tmp_path / "rules.json"
        rules.write_text(json.dumps([{"name": "bag", "kind": "gauge",
                                      "gauge": "bag_data_cnt",
                                      "max": 1e9}]))
        argv.append("alert_rules=%s" % rules)
    else:
        argv.append(arg)
    try:
        run(argv)
    finally:
        plan_state.reset()
        plan_cache.reset_fallbacks()
    summary = json.load(open(out + ".summary.json"))
    if key == "task":
        scores = np.loadtxt(result)
        assert scores.shape == (300,)
        assert summary["online"]["cycles"] >= 1
        assert summary["online"]["rows_behind"] == 0
        published = P.Booster(model_file=model, device="cpu")
        assert published.current_iteration() == 3 + 2 * summary[
            "online"]["cycles"]
    elif key == "plan_cache":
        assert summary["plan"]["provenance"] == "tuned"
        assert summary["plan"]["cache_fallbacks"] == 0
    elif key == "alert_rules":
        assert summary["alerts"]["enabled"] and summary["alerts"][
            "rules"] == 1
    else:
        assert summary["profiling"]["flight_recorder_armed"] is True
    assert os.path.exists(model)
