"""The slice as a whole: ``lightgbm_tpu_torch.train`` against
``lightgbm_tpu.train`` on the CPU.

Both train the binary objective on the same seeded data (2,000 rows x 300
features, 63 bins, a held-out set of 1,000 rows, 15 leaves, up to 10
rounds) with ``metric=["auc", "binary_logloss"]`` and early stopping after 2
rounds without improvement; the held-out labels are noisy enough that AUC
stops improving before round 10.  (At 255 bins, leaves of 40-100 rows among
300 features meet near-tied gains that f32 rounding decides differently in
XLA and in PyTorch: one tree of eight differed in one threshold bin.)
Required: the trees equal (split features, threshold bins, leaf counts;
leaf values within ``leaf_value_tolerance`` of ``test_torch_train.py``),
``evals_result`` per iteration within 1e-6 (the
port's f32 scores carry the same tree outputs summed in the same order),
the same ``best_iteration``, predictions within 1e-5, and the validation
scores accumulated in training equal to ``predict(raw_score=True)`` within
1e-5 (f32 running sums against f64 sums).  A JAX-trained model string carried
into the port predicts the same, and ``init_model`` continues it to the same
trees as the JAX continuation.  The port pins one torch thread.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import lightgbm_tpu as J
from lightgbm_tpu.metric.metric import create_metrics as jax_metrics
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.metric.metric import create_metrics
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

N, NV, NF = 2000, 1000, 300
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              metric=["auc", "binary_logloss"], min_data_in_leaf=40,
              max_bin=63, verbosity=-1)
# binning parameters travel with the Dataset, as in the reference
DS_PARAMS = {"max_bin": 63}
ROUNDS, STOP = 10, 2


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N + NV, NF)).astype(np.float32)
    logit = X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3] + 0.5 * X[:, 4]
    y = (logit + rng.normal(scale=1.5, size=N + NV) > 0).astype(np.float64)
    return X[:N], y[:N], X[N:], y[N:]


def run(lib, **kw):
    X, y, Xv, yv = make_data()
    train = lib.Dataset(X, y, params=DS_PARAMS)
    valid = lib.Dataset(Xv, yv, reference=train)
    evals = {}
    booster = lib.train(PARAMS, train, num_boost_round=ROUNDS,
                        valid_sets=[valid], evals_result=evals,
                        early_stopping_rounds=STOP, verbose_eval=False, **kw)
    return booster, evals


@pytest.fixture(scope="module")
def trained():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = run(J)
        port = run(P, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return ref, port


def assert_trees_equal(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        nl = a.num_leaves
        assert b.num_leaves == nl
        for name in ("split_feature", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, N))


def test_trees_equal(trained):
    (ref, _), (port, _) = trained
    assert port.current_iteration() == ref.current_iteration() < ROUNDS
    assert_trees_equal(ref._booster.models, port._booster.models)


def test_evals_result_and_best_iteration_equal(trained):
    (ref, ref_ev), (port, port_ev) = trained
    assert list(port_ev) == list(ref_ev) == ["valid_0"]
    for metric in ("auc", "binary_logloss"):
        np.testing.assert_allclose(port_ev["valid_0"][metric],
                                   ref_ev["valid_0"][metric], rtol=0,
                                   atol=1e-6, err_msg=metric)
    assert port.best_iteration == ref.best_iteration
    assert 0 < port.best_iteration < port.current_iteration()
    for metric, value in ref.best_score["valid_0"].items():
        assert abs(port.best_score["valid_0"][metric] - value) <= 1e-6


def test_predict_close(trained):
    (ref, _), (port, _) = trained
    _, _, Xv, _ = make_data()
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(Xv, raw_score=raw),
                                   ref.predict(Xv, raw_score=raw), rtol=0,
                                   atol=1e-5)


def test_valid_scores_equal_predict(trained):
    _, (port, _) = trained
    _, _, Xv, _ = make_data()
    score = port._booster.valid_sets[0]["score"][0].double().numpy()
    want = port.predict(Xv, raw_score=True,
                        num_iteration=port.current_iteration())
    np.testing.assert_allclose(score, want, rtol=0, atol=1e-5)


def test_jax_model_string_predicts_the_same(trained):
    (ref, _), _ = trained
    _, _, Xv, _ = make_data()
    carried = booster_from_model_string(ref.model_to_string(), PARAMS,
                                        device="cpu")
    assert carried.num_trees() == ref.best_iteration
    for raw in (True, False):
        np.testing.assert_allclose(carried.predict(Xv, raw_score=raw),
                                   ref.predict(Xv, raw_score=raw), rtol=0,
                                   atol=1e-6)


def test_init_model_continues_like_jax(trained, tmp_path, one_thread):
    (ref, _), _ = trained
    X, y, Xv, _ = make_data()
    path = str(tmp_path / "model.txt")
    ref.save_model(path)
    more = dict(PARAMS, metric="binary_logloss")
    ref2 = J.train(more, J.Dataset(X, y, params=DS_PARAMS),
                   num_boost_round=3, init_model=path, verbose_eval=False)
    port2 = P.train(more, P.Dataset(X, y, params=DS_PARAMS),
                    num_boost_round=3, init_model=path, verbose_eval=False,
                    device="cpu")
    assert port2.num_trees() == ref2.num_trees() == ref.best_iteration + 3
    assert_trees_equal(ref2._booster.models, port2._booster.models)
    np.testing.assert_allclose(port2.predict(Xv, raw_score=True),
                               ref2.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-5)


def test_gbdt_train_stops_at_the_same_iteration(trained, one_thread):
    """``GBDT.train`` (the host loop with ``early_stopping_round``) stops
    where the engine's callback did."""
    _, (port, _) = trained
    X, y, Xv, yv = make_data()
    train = P.Dataset(X, y, params=DS_PARAMS).construct()
    valid = P.Dataset(Xv, yv, reference=train).construct()
    cfg = Config(dict(PARAMS, num_iterations=ROUNDS,
                      early_stopping_round=STOP))
    gbdt = P.GBDT(cfg, train.handle,
                  P.create_objective("binary", cfg, device="cpu"),
                  device="cpu")
    gbdt.add_valid_data(valid.handle, "valid_0")
    gbdt.train()
    assert gbdt.best_iteration == port.best_iteration
    assert gbdt.current_iteration == port.current_iteration()


def test_dataset_reference_bins_like_jax():
    X, y, Xv, yv = make_data()
    ref_train = J.Dataset(X, y, params=DS_PARAMS).construct()
    ref_valid = J.Dataset(Xv, yv, reference=ref_train).construct()
    train = P.Dataset(X, y, params=DS_PARAMS)
    valid = train.create_valid(Xv, yv).construct()
    np.testing.assert_array_equal(np.asarray(valid.handle.binned),
                                  np.asarray(ref_valid.handle.binned))
    assert valid.handle.bin_mappers is train.handle.bin_mappers
    assert valid.num_data() == NV and valid.num_feature() == NF


@pytest.mark.parametrize("metric", [None, "", "auc", "logloss",
                                    ["auc", "binary_logloss"],
                                    "binary_error,auc"])
def test_metric_names_and_values_like_jax(metric):
    """``metric`` is read as the JAX package reads it (one name, a list,
    aliases, ``None``/``""``), and the metrics of f32 validation scores agree
    with the JAX package's."""
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
    from lightgbm_tpu.objective import create_objective as jax_create_objective
    from lightgbm_tpu_torch.io.metadata import Metadata
    params = dict(objective="binary")
    if metric is not None:
        params["metric"] = metric
    ours = create_metrics(Config(params).metric, Config(params))
    theirs = jax_metrics(JaxConfig(params).metric, JaxConfig(params))
    assert [type(m).__name__ for m in ours] == \
        [type(m).__name__ for m in theirs]
    rng = np.random.RandomState(3)
    y = (rng.uniform(size=500) < 0.4).astype(np.float64)
    score = rng.normal(size=(1, 500)).astype(np.float32)
    objective = P.create_objective("binary", Config(params), device="cpu")
    jax_objective = jax_create_objective("binary", JaxConfig(params))
    md, jmd = Metadata(500), JaxMetadata(500)
    md.set_label(y)
    jmd.set_label(y)
    for a, b in zip(ours, theirs):
        a.init(md, 500)
        b.init(jmd, 500)
        np.testing.assert_allclose(a.eval(score, objective),
                                   b.eval(score, jax_objective), rtol=1e-12)


def test_refusals():
    X, y, _, _ = make_data()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.Dataset(pd.DataFrame(X[:50]), y[:50])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.engine.cv(PARAMS, P.Dataset(X, y))
    booster = P.train(PARAMS, P.Dataset(X[:300], y[:300]),
                      num_boost_round=1, device="cpu")
    with pytest.raises(NotImplementedError, match="pred_contrib"):
        booster.predict(X[:10], pred_contrib=True)
