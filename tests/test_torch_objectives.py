"""Every objective of the port against the JAX package's, on the CPU.

For each of the 16 names of ``lightgbm_tpu/objective/__init__.py``'s table,
on seeded data suited to it (3,000 rows x 10 features; ranking in queries of
30 documents; multiclass with 3 classes), with and without sample weights:

- gradients and hessians of the same f32 scores: max|diff| <= 1e-6 x max|g|
  (and x max|h|) for the pointwise objectives, whose f32 operations are the
  JAX ones in the same order (only ``exp``/``log1p`` may round differently);
  1e-5 x max|g| for the two ranking objectives, whose pair sums run in
  another order;
- ``boost_from_score`` of every class equal (host numpy on both sides);
- ``renew_tree_output`` of l1, quantile and mape equal, with and without
  weights (the same numpy percentiles);
- ``lightgbm_tpu_torch.train`` against ``lightgbm_tpu.train`` (63 bins, 15
  leaves, 3 rounds, one torch thread): trees equal (split features,
  threshold bins, child pointers, leaf counts), leaf values and raw
  predictions within 1e-4.

The parameter list of ROADMAP queue 3 runs the same training
comparison on the binary objective: split regularisation, class weighting,
``sigmoid``, ``boost_from_average=false``, sample weights, ``init_score``,
15 bins with NaNs and zeros and ``use_missing=false``, quantized gradients;
the first case also holds ``predict(num_iteration=2)``, converted
predictions and ``feature_importance`` (split counts equal, gains within
1e-5 relative).  ``max_delta_step=0.3`` can clamp both children of a split
to the same output, so that every threshold's gain there is f32 rounding of
zero and the two sides pick different thresholds (ROADMAP queue 3 records
tree 0 parting at its 8th split and a raw prediction gap of 0.035 after 3
rounds): it is held to a score budget instead, raw predictions within 0.1
and train log loss within 1e-3 (measured on this data: the trees agree, gap
1.8e-6, log losses 1.2e-9 apart).

A hand-written l2 ``fobj`` grows the trees of ``objective=regression``
(with ``boost_from_average=false``, as a custom objective starts from 0) in
the port, and the trees of ``lightgbm_tpu.train(fobj=...)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import Config, create_objective
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)

OBJECTIVES = ["regression", "regression_l1", "quantile", "huber", "fair",
              "poisson", "mape", "gamma", "tweedie", "binary", "multiclass",
              "multiclassova", "cross_entropy", "cross_entropy_lambda",
              "lambdarank", "rank_xendcg"]
RANK = ("lambdarank", "rank_xendcg")
RENEW = ("regression_l1", "quantile", "mape")
N, NF, QUERY = 3000, 10, 30
LEAF_ATOL = 1e-4
PREDICT_ATOL = 1e-4


def make_data(obj, n=N, f=NF, seed=0):
    """(X, label, group) for objective ``obj``."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = (X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n))
    group = None
    if obj == "binary":
        y = (z > 0).astype(np.float64)
    elif obj.startswith("multiclass"):
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)
    elif obj.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-z))
    elif obj == "poisson":
        y = rng.poisson(np.exp(0.3 * z)).astype(np.float64)
    elif obj in ("gamma", "tweedie"):
        y = np.exp(0.3 * z) + 0.01
    elif obj in RANK:
        y = np.clip(np.floor(z + 1), 0, 4)
        group = [QUERY] * (n // QUERY)
    else:
        y = 3.0 * z
    return X, y, group


def params_for(obj, **extra):
    p = dict(objective=obj, num_leaves=15, learning_rate=0.1, max_bin=63,
             min_data_in_leaf=20, verbosity=-1)
    if obj.startswith("multiclass"):
        p["num_class"] = 3
    p.update(extra)
    return p


def objectives(obj, weighted, seed=0):
    """The JAX and the port objective, initialised on the same metadata."""
    X, y, group = make_data(obj)
    n = len(y)
    w = (np.random.RandomState(seed + 7).uniform(0.5, 2.0, n)
         if weighted else None)
    params = params_for(obj)
    ref = jax_objective(obj, JaxConfig(**params))
    port = create_objective(obj, Config(**params), device="cpu")
    for o, md in ((ref, JaxMetadata(n)), (port, Metadata(n))):
        md.set_label(y)
        md.set_weights(w)
        md.set_group(group)
        o.init(md, n)
    return ref, port, n


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("obj", OBJECTIVES)
def test_gradients_equal(obj, weighted):
    ref, port, n = objectives(obj, weighted)
    k = ref.num_model_per_iteration
    rng = np.random.RandomState(1)
    score = rng.normal(scale=0.5, size=(k, n)).astype(np.float32)
    if k == 1:
        score = score[0]
    want = ref.get_gradients(jnp.asarray(score))
    got = port.get_gradients(torch.from_numpy(score))
    rel = 1e-5 if obj in RANK else 1e-6
    for w, g, what in zip(want, got, ("grad", "hess")):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        scale = float(np.abs(w).max())
        assert scale > 0
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, "%s: max|diff| %.3g, max %.3g" % (
            what, err, scale)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("obj", OBJECTIVES)
def test_boost_from_score_equal(obj, weighted):
    ref, port, _ = objectives(obj, weighted)
    for k in range(ref.num_model_per_iteration):
        assert port.boost_from_score(k) == ref.boost_from_score(k)


@pytest.mark.parametrize("obj", RENEW)
def test_renew_tree_output_equal(obj):
    ref, port, _ = objectives(obj, weighted=False)
    rng = np.random.RandomState(3)
    for size in (1, 2, 7, 100, 1001):
        residual = rng.normal(size=size).astype(np.float32)
        weights = rng.uniform(0.1, 3.0, size).astype(np.float32)
        for w in ((None, weights) if obj != "mape" else (weights,)):
            assert port.renew_tree_output(residual, w) == \
                ref.renew_tree_output(residual, w)


def train_both(params, X, y, group=None, init_score=None, weight=None,
               rounds=3, **kw):
    out = []
    for lib, extra in ((J, {}), (P, dict(device="cpu"))):
        ds = lib.Dataset(X, y, group=group, init_score=init_score,
                         weight=weight,
                         params={k: params[k] for k in
                                 ("max_bin", "min_data_in_bin", "use_missing")
                                 if k in params})
        out.append(lib.train(params, ds, num_boost_round=rounds,
                             verbose_eval=False, **extra, **kw))
    return out


def assert_same_trees(ref_models, port_models):
    assert len(ref_models) == len(port_models)
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl, "tree %d" % i
        for name in ("split_feature", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl],
                                      err_msg="tree %d" % i)
        np.testing.assert_allclose(b.leaf_value[:nl], a.leaf_value[:nl],
                                   rtol=0, atol=LEAF_ATOL,
                                   err_msg="tree %d" % i)


@pytest.mark.parametrize("obj", OBJECTIVES)
def test_training_matches_jax(obj, one_thread):
    X, y, group = make_data(obj)
    ref, port = train_both(params_for(obj), X, y, group)
    k = ref._booster.num_tree_per_iteration
    assert port._booster.num_tree_per_iteration == k
    assert port.num_trees() == 3 * k
    assert any(t.num_leaves > 2 for t in port._booster.models)
    assert_same_trees(ref._booster.models, port._booster.models)
    want = ref.predict(X, raw_score=True)
    got = port.predict(X, raw_score=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_ATOL)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4,
                               atol=PREDICT_ATOL)


def test_unknown_objective_fails_as_in_jax():
    with pytest.raises(Exception) as ref_err:
        jax_objective("no_such_objective", JaxConfig())
    with pytest.raises(LightGBMError) as port_err:
        create_objective("no_such_objective", Config(), device="cpu")
    assert str(port_err.value) == str(ref_err.value)


PARAMETER_CASES = {
    "split_params": dict(max_depth=3, lambda_l1=1.0, lambda_l2=5.0,
                         min_gain_to_split=2.0, min_sum_hessian_in_leaf=5.0),
    "is_unbalance": dict(is_unbalance=True),
    "scale_pos_weight": dict(scale_pos_weight=3.0),
    "sigmoid": dict(sigmoid=2.0),
    "no_boost_from_average": dict(boost_from_average=False),
    "weights": {},
    "init_score": {},
    "bins15_nan_zero": dict(max_bin=15, min_data_in_bin=50,
                            use_missing=False),
    "quantized": dict(hist_precision="quantized"),
}


def parameter_case_data(case):
    X, y, _ = make_data("binary")
    rng = np.random.RandomState(11)
    y = np.where(rng.uniform(size=len(y)) < 0.7, y, 0.0)   # unbalanced
    kw = {}
    if case == "weights":
        kw["weight"] = rng.uniform(0.5, 2.0, len(y))
    if case == "init_score":
        kw["init_score"] = rng.normal(scale=0.3, size=len(y))
    if case == "bins15_nan_zero":
        X = X.copy()
        X[rng.uniform(size=X.shape) < 0.05] = np.nan
        X[rng.uniform(size=X.shape) < 0.3] = 0.0
    return X, y, kw


@pytest.mark.parametrize("case", list(PARAMETER_CASES))
def test_split_and_objective_parameters_match_jax(case, one_thread):
    X, y, kw = parameter_case_data(case)
    params = params_for("binary", **PARAMETER_CASES[case])
    ref, port = train_both(params, X, y, **kw)
    assert_same_trees(ref._booster.models, port._booster.models)
    head = lambda b: b.model_to_string().split("\ntree_sizes=")[0]  # noqa
    assert head(port) == head(ref)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=PREDICT_ATOL)
    if case == "split_params":
        for it in (1, 2):
            np.testing.assert_allclose(
                port.predict(X, num_iteration=it),
                ref.predict(X, num_iteration=it), rtol=0, atol=PREDICT_ATOL)
        np.testing.assert_array_equal(port.feature_importance("split"),
                                      ref.feature_importance("split"))
        np.testing.assert_allclose(port.feature_importance("gain"),
                                   ref.feature_importance("gain"), rtol=1e-5)


def test_max_delta_step_within_score_budget(one_thread):
    X, y, kw = parameter_case_data("max_delta_step")
    ref, port = train_both(params_for("binary", max_delta_step=0.3), X, y)
    gap = np.abs(port.predict(X, raw_score=True)
                 - ref.predict(X, raw_score=True)).max()
    assert gap <= 0.1

    def logloss(p):
        return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    assert abs(logloss(port.predict(X)) - logloss(ref.predict(X))) <= 1e-3


def test_l2_fobj_grows_the_regression_trees(one_thread):
    X, y, _ = make_data("regression")

    def fobj(preds, data):
        return preds - data.get_label(), np.ones_like(preds)
    params = params_for("regression", boost_from_average=False)
    ds = {"max_bin": 63}
    builtin = P.train(params, P.Dataset(X, y, params=ds), num_boost_round=3,
                      verbose_eval=False, device="cpu")
    custom = P.train(params, P.Dataset(X, y, params=ds), num_boost_round=3,
                     fobj=fobj, verbose_eval=False, device="cpu")
    assert custom._booster.objective is None
    assert_same_trees(builtin._booster.models, custom._booster.models)
    ref = J.train(params, J.Dataset(X, y, params=ds), num_boost_round=3,
                  fobj=fobj, verbose_eval=False)
    assert_same_trees(ref._booster.models, custom._booster.models)
    np.testing.assert_allclose(custom.predict(X), ref.predict(X), rtol=0,
                               atol=PREDICT_ATOL)
