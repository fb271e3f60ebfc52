"""Every prediction path of the port against the JAX package, on the CPU.

The JAX package predicts in two regimes (``GBDT._raw_predict``): from 512
rows on, f32 rows against f32 thresholds rounded toward -inf with an f32
running sum in tree order; below 512, f64 rows, thresholds and sums.  A
model trained by the JAX package (binary, 5 rounds, 15 leaves, 6 features of
f32 data) is carried into the port by its model string; the same rows go
through both.  The adversarial rows hold one feature at
``nextafter(threshold, inf)`` of some node: f32 rounding sends them left,
f64 right.  Required: bit-equal scores and leaves from 512 rows on, scores
within 1e-12 below (the JAX package's small-batch sum is numpy's pairwise
sum, the port's one add per tree), leaves equal; prediction early stop
(``pred_early_stop``) on and off, at 300 and 2,048 rows, the same way; the
bf16 tier bit-equal to the JAX package's and routed as the exact tier; the
binned paths (``raw_predict_binned``, ``predict_binned``,
``predict_leaf_index_binned``) equal to the JAX package's on dense, EFB
(``from_csr``) and categorical fixtures, and raw equal to binned on the
training rows (f32 data: every f32 value sits on one side of its bin's
bound in both routings); multiclass outputs and iteration subsets; ``refit``
(leaf values within rtol 1e-6: the gradients are f32 sigmoids of two
libraries); and the Booster's introspection (``dump_model``,
``get_split_value_histogram``, ``eval``, ``num_model_per_iteration``).
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu as J
from lightgbm_tpu.core.predict import floor_thresholds_f32 as jax_floor
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import GBDT, Config, create_objective
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.core.predict import floor_thresholds_f32
from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(1)

N = 2000
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63, verbosity=-1)
DS = {"max_bin": 63}
ES = dict(pred_early_stop=True, pred_early_stop_freq=2,
          pred_early_stop_margin=1.0)


def make_data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 + rng.normal(size=n) > 0.5).astype(float)
    return X, y


def close(got, want, n):
    """Bit-equal from 512 rows on, within 1e-12 below."""
    if n >= 512:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def binary():
    X, y = make_data()
    ref = J.train(dict(PARAMS), J.Dataset(X, y, params=DS),
                  num_boost_round=5, verbose_eval=False)
    port = booster_from_model_string(ref.model_to_string(), device="cpu")
    return X, y, ref, port


def adversarial_rows(ref, n, seed=1):
    """Rows with one feature at nextafter(threshold, inf) of some node."""
    rng = np.random.RandomState(seed)
    thr = [(int(t.split_feature[i]), float(t.threshold[i]))
           for t in ref._booster.models for i in range(t.num_leaves - 1)]
    A = rng.normal(size=(n, 6))
    for r in range(n):
        f, th = thr[r % len(thr)]
        A[r, f] = np.nextafter(th, np.inf)
    return A


def test_floor_thresholds_match_jax():
    rng = np.random.RandomState(3)
    thr = np.concatenate([rng.normal(size=1000),
                          rng.normal(size=100).astype(np.float32),
                          [0.0, -0.0, 1e-40, -1e-40, 3e38, 1.5]])
    np.testing.assert_array_equal(floor_thresholds_f32(thr), jax_floor(thr))
    t32 = floor_thresholds_f32(thr)
    assert (t32.astype(np.float64) <= thr).all()


def test_f32_regime_bit_equal_on_adversarial_rows(binary):
    """2,048 f64 rows: f32 rows, floored thresholds, an f32 sum in tree
    order, as the JAX package's device scan."""
    _, _, ref, port = binary
    A = adversarial_rows(ref, 2048)
    want = ref.predict(A, raw_score=True)
    np.testing.assert_array_equal(port.predict(A, raw_score=True), want)
    np.testing.assert_array_equal(port.predict(A), ref.predict(A))
    # the rows do tell the regimes apart: the f64 walk routes them right
    host = sum(t.predict(A) for t in port._booster.models)
    assert (np.abs(host - want) > 1e-3).sum() > 100


def test_f64_regime_on_small_batches(binary):
    _, _, ref, port = binary
    A = adversarial_rows(ref, 256)
    got = port.predict(A, raw_score=True)
    np.testing.assert_allclose(got, ref.predict(A, raw_score=True), rtol=0,
                               atol=1e-12)
    host = sum(t.predict(A) for t in port._booster.models)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rows", [256, 2048])
def test_pred_leaf_in_both_regimes(binary, rows):
    _, _, ref, port = binary
    A = adversarial_rows(ref, rows)
    got = port.predict(A, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == (rows, 5)
    np.testing.assert_array_equal(got, ref.predict(A, pred_leaf=True))
    if rows < 512:
        want = np.stack([t.predict_leaf_index(A)
                         for t in port._booster.models], axis=1)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def early_stop_model():
    X, y = make_data()
    ref = J.train(dict(PARAMS, **ES), J.Dataset(X, y, params=DS),
                  num_boost_round=10, verbose_eval=False)
    return ref, ref.model_to_string()


@pytest.mark.parametrize("rows", [300, 2048])
@pytest.mark.parametrize("early_stop", [True, False])
def test_pred_early_stop_matches_jax(early_stop_model, rows, early_stop):
    _, text = early_stop_model
    params = dict(PARAMS, **ES) if early_stop else dict(PARAMS)
    port = booster_from_model_string(text, params=params, device="cpu")
    jax_b = J.Booster(params=params, model_str=text)
    Z = np.random.RandomState(rows).normal(size=(rows, 6))
    want = jax_b.predict(Z, raw_score=True)
    close(port.predict(Z, raw_score=True), want, rows)
    full = J.Booster(params=dict(PARAMS), model_str=text).predict(
        Z, raw_score=True)
    stopped = np.abs(want - full) > 1e-4
    assert stopped.any() == early_stop


def test_need_accurate_prediction_turns_early_stop_off():
    """Regression needs accurate predictions: pred_early_stop is ignored
    (predictor.hpp:38-47)."""
    X, y = make_data()
    params = dict(PARAMS, objective="regression")
    ref = J.train(params, J.Dataset(X, y, params=DS), num_boost_round=6,
                  verbose_eval=False)
    text = ref.model_to_string()
    port = booster_from_model_string(text, params=dict(params, **ES),
                                     device="cpu")
    assert port._booster.objective.need_accurate_prediction
    assert port._booster._predict_early_stop()[0] < 0
    Z = np.random.RandomState(5).normal(size=(1000, 6))
    np.testing.assert_array_equal(port.predict(Z, raw_score=True),
                                  ref.predict(Z, raw_score=True))


@pytest.mark.parametrize("rows", [256, 2048])
def test_bf16_tier(binary, rows):
    """bf16 leaf values and score carry, each add rounded: bit-equal to the
    JAX package's bf16 tier (which runs on the device at every size), and
    the same leaves as the exact tier."""
    _, _, ref, port = binary
    A = adversarial_rows(ref, rows)
    got = port.predict(A, raw_score=True, precision="bf16")
    np.testing.assert_array_equal(
        got, ref.predict(A, raw_score=True, precision="bf16"))
    trees = port._booster.models
    exact = FusedPredictor(trees, device="cpu")(A)
    assert 0 < np.abs(got - exact).max() < 0.05
    for p in ("exact", "bf16"):
        leaves = FusedPredictor(trees, precision=p, device="cpu")(
            A, want_leaf=True)
        np.testing.assert_array_equal(leaves,
                                      ref.predict(A, pred_leaf=True)
                                      if rows >= 512 else
                                      port.predict(A.astype(np.float32),
                                                   pred_leaf=True))
    with pytest.raises(ValueError, match="precision"):
        port.predict(A, precision="fp8")


# ---- binned row stores ----

def dense_case():
    X, y = make_data(seed=2)
    return dict(X=X, y=y, kw={}, params={})


def efb_case():
    rng = np.random.RandomState(9)
    n, levels = 2400, 12
    cols, lv = [], []
    for b in range(3):
        w = (0.7 + 0.05 * b) ** np.arange(levels)
        c = np.floor(n * w / w.sum()).astype(int)
        c[0] += n - c.sum()
        v = rng.permutation(np.repeat(np.arange(levels), c))
        oh = np.zeros((n, levels), np.float32)
        oh[np.arange(n), v] = 1.0
        cols.append(oh)
        lv.append(v)
    X = np.concatenate(cols, 1)
    y = ((lv[0] % 3 == 0) + 0.5 * (lv[1] > 5)
         + rng.normal(scale=0.3, size=n) > 0.8).astype(np.float64)
    return dict(X=sps.csr_matrix(X), y=y, kw={}, params={}, dense=X)


def cat_case():
    rng = np.random.RandomState(4)
    n = 2400
    c12 = rng.choice(12, size=n, p=np.sort(rng.dirichlet(np.ones(12)))[::-1])
    c3 = rng.choice(3, size=n, p=[0.5, 0.3, 0.2])
    x = rng.normal(size=n).astype(np.float32)
    logit = 2.0 * np.isin(c12, [0, 3, 7]) + 0.7 * (c3 == 1) + x - 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(float)
    X = np.column_stack([c12, c3, x]).astype(np.float32)
    return dict(X=X, y=y, kw=dict(categorical_feature=[0, 1]),
                params=dict(min_data_per_group=20, cat_smooth=5.0))


CASES = {"dense": dense_case, "efb": efb_case, "categorical": cat_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def binned_case(request):
    c = CASES[request.param]()
    params = dict(PARAMS, **c["params"])
    jds = J.Dataset(c["X"], c["y"], params=DS, **c["kw"])
    ref = J.train(params, jds, num_boost_round=4, verbose_eval=False)
    pds = P.Dataset(c["X"], c["y"], params=DS, **c["kw"])
    pds.construct()
    port = booster_from_model_string(ref.model_to_string(), params=params,
                                     device="cpu")
    return c, ref, jds, port, pds


def test_binned_paths_match_jax(binned_case):
    c, ref, jds, port, pds = binned_case
    np.testing.assert_array_equal(pds.handle.binned, jds.handle.binned)
    jb, pb = ref._booster, port._booster
    np.testing.assert_array_equal(pb.raw_predict_binned(pds.handle),
                                  jb.raw_predict_binned(jds.handle))
    np.testing.assert_array_equal(port.predict_binned(pds),
                                  ref.predict_binned(jds))
    np.testing.assert_array_equal(port.predict_binned(pds, pred_leaf=True),
                                  ref.predict_binned(jds, pred_leaf=True))
    np.testing.assert_array_equal(
        pb.raw_predict_binned(pds.handle, num_iteration=2,
                              start_iteration=1),
        jb.raw_predict_binned(jds.handle, num_iteration=2,
                              start_iteration=1))


def test_raw_equals_binned_on_training_rows(binned_case):
    c, _, _, port, pds = binned_case
    X = c.get("dense", c["X"])
    np.testing.assert_array_equal(port.predict(X, raw_score=True),
                                  port.predict_binned(pds, raw_score=True))
    np.testing.assert_array_equal(port.predict(X, pred_leaf=True),
                                  port.predict_binned(pds, pred_leaf=True))


# ---- multiclass, iteration subsets ----

@pytest.fixture(scope="module")
def multiclass():
    X, _ = make_data(seed=6)
    y = (np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5])).astype(float)
    params = dict(PARAMS, objective="multiclass", num_class=3)
    ref = J.train(params, J.Dataset(X, y, params=DS), num_boost_round=3,
                  verbose_eval=False)
    port = booster_from_model_string(ref.model_to_string(), params=params,
                                     device="cpu")
    return X, ref, port


@pytest.mark.parametrize("rows", [256, 2048])
@pytest.mark.parametrize("subset", [(0, None), (1, 1), (0, 2), (1, None)])
def test_multiclass_and_iteration_subsets(multiclass, rows, subset):
    _, ref, port = multiclass
    start, num = subset
    A = adversarial_rows(ref, rows)
    for raw in (True, False):
        got = port.predict(A, raw_score=raw, start_iteration=start,
                           num_iteration=num)
        assert got.shape == (rows, 3)
        close(got, ref.predict(A, raw_score=raw, start_iteration=start,
                               num_iteration=num), rows)
    np.testing.assert_array_equal(
        port.predict(A, pred_leaf=True, num_iteration=num),
        ref.predict(A, pred_leaf=True, num_iteration=num))
    assert port.num_model_per_iteration() == 3


def test_multiclass_binned(multiclass):
    X, ref, port = multiclass
    jds = J.Dataset(X, np.zeros(len(X)), params=DS).construct()
    pds = P.Dataset(X, np.zeros(len(X)), params=DS).construct()
    got = port._booster.raw_predict_binned(pds.handle)
    assert got.shape == (3, len(X))
    np.testing.assert_array_equal(got,
                                  ref._booster.raw_predict_binned(jds.handle))
    np.testing.assert_array_equal(
        port.predict_binned(pds, pred_leaf=True),
        ref.predict_binned(jds, pred_leaf=True))


# ---- refit and the Booster's introspection ----

def test_refit_matches_jax(binary, one_thread):
    X, y, ref, _ = binary
    cfg = Config(dict(PARAMS, refit_decay_rate=0.7))
    pds = P.Dataset(X, y, params=DS).construct()
    gbdt = GBDT(cfg, pds.handle, create_objective("binary", cfg, "cpu"),
                device="cpu")
    gbdt.load_model_from_string(ref.model_to_string())
    jref = J.Booster(params=dict(PARAMS, refit_decay_rate=0.7),
                     train_set=J.Dataset(X, y, params=DS))
    jref._booster.load_model_from_string(ref.model_to_string())
    leaves = gbdt.predict_leaf_index_binned()
    np.testing.assert_array_equal(
        leaves, jref._booster.predict_leaf_index_binned())
    gbdt.refit(leaves)
    jref._booster.refit(leaves)
    for a, b in zip(jref._booster.models, gbdt.models):
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(
        gbdt.train_score.numpy(),
        np.asarray(jref._booster.train_score)[:, :len(y)], rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError, match="leaf_preds"):
        gbdt.refit(leaves[:, :2])


def test_dump_model_and_split_histogram_match_jax(binary):
    _, _, ref, port = binary
    assert port.dump_model() == ref.dump_model()
    assert port.dump_model(num_iteration=2, start_iteration=1) == \
        ref.dump_model(num_iteration=2, start_iteration=1)
    for f in range(3):
        h, e = port.get_split_value_histogram(f)
        hj, ej = ref.get_split_value_histogram(f)
        np.testing.assert_array_equal(h, hj)
        np.testing.assert_array_equal(e, ej)
        np.testing.assert_array_equal(
            port.get_split_value_histogram(f, bins=4, xgboost_style=True),
            ref.get_split_value_histogram(f, bins=4, xgboost_style=True))
    name = port.feature_name()[0]
    np.testing.assert_array_equal(port.get_split_value_histogram(name)[0],
                                  ref.get_split_value_histogram(name)[0])


def test_booster_eval(one_thread):
    X, y = make_data()
    train = P.Dataset(X[:1500], y[:1500], params=DS)
    valid = P.Dataset(X[1500:], y[1500:], reference=train)
    params = dict(PARAMS, metric=["auc", "binary_logloss"])
    bst = P.train(params, train, num_boost_round=3, valid_sets=[valid],
                  valid_names=["v"], verbose_eval=False, device="cpu")
    got = bst.eval(valid, "v")
    assert [r[1] for r in got] == ["auc", "binary_logloss"]
    assert got == [r for r in bst.eval_valid() if r[0] == "v"]
    assert [r[1:] for r in bst.eval(train, "t")] == \
        [r[1:] for r in bst.eval_train()]
    with pytest.raises(P.basic.LightGBMError, match="add_valid"):
        bst.eval(P.Dataset(X[:10], y[:10], reference=train), "x")
