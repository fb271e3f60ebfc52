"""GOSS, DART and random forest on the port against the JAX package, on the
CPU.

Both packages train through their own ``train()`` on the same numpy input
(binary: 2,000 rows x 6 features; multiclass: 3 classes of the same
features), max_bin=63, num_leaves=15.  Required: trees equal (split
features, threshold bins, children, leaf counts), leaf values within
``test_torch_train.leaf_value_tolerance``, predictions within 1e-4 and the
model headers equal (``tree_sizes`` aside: it counts the characters of the
trees' printed leaf values).  DART runs with ``skip_drop=0`` and
``drop_rate=0.5``, so that most iterations drop trees, each way of
``uniform_drop`` and ``xgboost_dart_mode``; GOSS with
``learning_rate=0.3``, so that it samples from iteration 3 on.

Also held here: the GOSS row weights byte for byte against the JAX
package's host selection on a key full of ties, the order of the GOSS
stream's draws, DART's drop sequence over 10 iterations, RF's ``predict``
as the mean of its trees, DART and RF through ``train()`` with a validation
set and early stopping, and GOSS there by a loss budget (its sample parts
from the JAX package's after 14 iterations: ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.boosting.goss import GOSS as JaxGOSS
from lightgbm_tpu_torch.boosting.goss import goss_weights
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

torch.set_num_threads(2)

N = 2000
BASE = dict(num_leaves=15, max_bin=63, verbosity=-1)
BOOSTERS = {
    "goss": dict(boosting="goss", learning_rate=0.3),
    "dart": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0),
    "dart_uniform": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0,
                         uniform_drop=True),
    "dart_xgboost": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0,
                         xgboost_dart_mode=True),
    "dart_uniform_xgboost": dict(boosting="dart", drop_rate=0.5,
                                 skip_drop=0.0, uniform_drop=True,
                                 xgboost_dart_mode=True),
    "rf": dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
               feature_fraction=0.8),
}
OBJECTIVES = {
    "binary": dict(objective="binary"),
    "multiclass": dict(objective="multiclass", num_class=3),
}


def make_data(kind: str, n: int = N, seed: int = 0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3] + rng.normal(
        scale=0.5, size=n)
    if kind == "binary":
        return X, (z > 0).astype(np.float64)
    return X, np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(
        np.float64)


def train_both(params, X, y, iters, **kw):
    ref = J.train(params, J.Dataset(X, y), num_boost_round=iters,
                  verbose_eval=False, **kw)
    port = P.train(params, P.Dataset(X, y), num_boost_round=iters,
                   verbose_eval=False, device="cpu", **kw)
    return ref, port


def header(booster) -> list:
    text = booster.model_to_string()
    return [line for line in text[:text.index("Tree=")].splitlines()
            if not line.startswith("tree_sizes=")]


def assert_trees_equal(ref_models, port_models, n):
    assert len(ref_models) == len(port_models)
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl, "tree %d" % i
        for name in ("split_feature_inner", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl],
                                      err_msg="tree %d" % i)
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, n), err_msg="tree %d" % i)


@pytest.mark.parametrize("objective", list(OBJECTIVES))
@pytest.mark.parametrize("booster", list(BOOSTERS))
def test_boosters_match_jax(booster, objective, one_thread):
    X, y = make_data(objective)
    params = dict(BASE, **OBJECTIVES[objective], **BOOSTERS[booster])
    iters = 5 if booster == "rf" else 8
    ref, port = train_both(params, X, y, iters)
    gbdt = port._booster
    assert type(gbdt).__name__ == type(ref._booster).__name__
    assert_trees_equal(ref._booster.models, gbdt.models, N)
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(X[:500], raw_score=raw),
                                   ref.predict(X[:500], raw_score=raw),
                                   rtol=0, atol=1e-4)
    assert header(port) == header(ref)
    np.testing.assert_allclose(
        gbdt.train_score.numpy(),
        np.asarray(ref._booster.train_score)[:, :N], rtol=0, atol=1e-4)
    if booster.startswith("dart"):
        assert gbdt.tree_weight == pytest.approx(ref._booster.tree_weight,
                                                 rel=1e-12)
    if booster == "goss":
        # iterations 3-7 sampled: top 20% plus 10% of the rest
        assert gbdt.bag_data_cnt == int(N * 0.2) + int(N * 0.1)


def test_goss_weights_match_jax_host_selection():
    """Heavy ties: the device sort's lower-index preference replays
    ``np.argsort(-key, kind="stable")``, including which tied rows make the
    top-k cut and how the rest's order maps the sampled positions."""
    key = np.tile(np.asarray([3.0, 1.0, 3.0, 2.0, 0.5, 3.0, 2.0, 1.0],
                             np.float32), 25)
    sampled = np.asarray([0, 7, 31, 150])
    want = np.asarray(JaxGOSS._select_weights_host(None, key, 40, sampled,
                                                   7.5))
    got = goss_weights(torch.from_numpy(key), 40, sampled, 7.5).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got == 1.0).sum() == 40 and (got == 7.5).sum() == sampled.size


def test_goss_stream_and_weights_per_iteration(one_thread):
    """Each sampled iteration's weights equal the host recompute from its
    own key, and the sequential stream made exactly the JAX package's
    draws: a fresh ``RandomState(bagging_seed)`` replaying one ``choice``
    per sampled iteration lands where the booster's stream is."""
    X, y = make_data("binary")
    params = dict(BASE, objective="binary", **BOOSTERS["goss"])
    booster = P.Booster(params, P.Dataset(X, y), device="cpu")
    gbdt = booster._booster
    top_k, other_k = int(N * 0.2), int(N * 0.1)
    for it in range(6):
        booster.update()
        if it < int(1 / 0.3):
            assert gbdt.goss_weight is None
            continue
        key = gbdt.goss_key.numpy()
        want = np.asarray(JaxGOSS._select_weights_host(
            None, key, top_k, gbdt.goss_sampled, (N - top_k) / other_k))
        np.testing.assert_array_equal(gbdt.goss_weight.numpy(), want)
        assert int((want != 0).sum()) == top_k + other_k
    ref = np.random.RandomState(params.get("bagging_seed", 3))
    for _ in range(6 - int(1 / 0.3)):
        ref.choice(N - top_k, size=other_k, replace=False)
    assert gbdt._bag_rng.randint(1 << 30) == ref.randint(1 << 30)


@pytest.mark.parametrize("uniform", [False, True], ids=["weighted",
                                                        "uniform"])
def test_dart_drop_sequence_matches_jax(uniform, one_thread):
    """``drop_index`` of each of 10 iterations, with the defaults' skip_drop
    (0.5) and max_drop=2 so that the cap is reached."""
    X, y = make_data("binary")
    params = dict(BASE, objective="binary", boosting="dart", drop_rate=0.6,
                  max_drop=2, uniform_drop=uniform)
    ref = J.Booster(params, J.Dataset(X, y))
    port = P.Booster(params, P.Dataset(X, y), device="cpu")
    seq_ref, seq_port = [], []
    for _ in range(10):
        ref.update()
        port.update()
        seq_ref.append(list(ref._booster.drop_index))
        seq_port.append(list(port._booster.drop_index))
    assert seq_port == seq_ref
    assert sum(len(d) > 0 for d in seq_port) >= 2
    assert max(len(d) for d in seq_port) == 2
    assert port._booster.shrinkage_rate == pytest.approx(
        ref._booster.shrinkage_rate, rel=1e-15)


def test_rf_predict_is_the_mean_of_its_trees(one_thread):
    X, y = make_data("binary")
    params = dict(BASE, objective="binary", **BOOSTERS["rf"])
    port = P.train(params, P.Dataset(X, y), num_boost_round=4,
                   verbose_eval=False, device="cpu")
    models = port._booster.models
    assert len(models) == 4 and "average_output" in header(port)
    mean = np.mean([t.predict(X[:300].astype(np.float64)) for t in models],
                   axis=0)
    np.testing.assert_allclose(port.predict(X[:300], raw_score=True), mean,
                               rtol=0, atol=1e-12)
    # the running average of the train scores is that mean too (in f32)
    np.testing.assert_allclose(port._booster.train_score[0, :300].numpy(),
                               mean, rtol=0, atol=1e-5)
    loaded = P.Booster(model_str=port.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(X[:300], raw_score=True), mean,
                               rtol=0, atol=1e-12)


def train_with_validation(booster, rounds):
    """Both packages' ``train()`` with a validation set and early stopping
    (3 rounds): (JAX booster, port booster, JAX evals, port evals)."""
    X, y = make_data("binary", n=3000, seed=3)
    Xv, yv = make_data("binary", n=1000, seed=4)
    params = dict(BASE, objective="binary", metric="binary_logloss",
                  **BOOSTERS[booster])
    evals = ({}, {})
    out = []
    for lgb, ev in zip((J, P), evals):
        train = lgb.Dataset(X, y)
        valid = lgb.Dataset(Xv, yv, reference=train)
        kw = {} if lgb is J else dict(device="cpu")
        out.append(lgb.train(params, train, num_boost_round=rounds,
                             valid_sets=[valid], valid_names=["v"],
                             early_stopping_rounds=3, evals_result=ev,
                             verbose_eval=False, **kw))
    return (*out, *evals), Xv


@pytest.mark.parametrize("booster", ["dart", "rf"])
def test_booster_with_validation_and_early_stopping(booster, one_thread):
    """``train()`` with a validation set and early stopping: the same
    per-iteration validation log loss, the same best iteration and the same
    validation scores as the JAX package's."""
    (ref, port, *evals), Xv = train_with_validation(booster, 30)
    np.testing.assert_allclose(evals[1]["v"]["binary_logloss"],
                               evals[0]["v"]["binary_logloss"], rtol=1e-5)
    assert port.best_iteration == ref.best_iteration
    np.testing.assert_allclose(
        port._booster.valid_sets[0]["score"].numpy(),
        np.asarray(ref._booster.valid_sets[0]["score"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-4)


def test_goss_with_validation_loss_within_budget(one_thread):
    """GOSS through ``train()`` with a validation set for 30 rounds.  The
    sampled rows' positions index the stable order of the whole rest of
    the key, so a swap of two keys within the packages' f32 difference
    (2.3e-6 here, from train scores 3.3e-5 apart) changes the sample: in
    this fixture the weights first differ at iteration 14, in 4 of 3,000
    rows, and the runs part from there (ROADMAP queue 3).  Held: the
    validation log loss equal through iteration 14, and each later one
    within 2% of the JAX package's reduction from the initial loss."""
    (ref, port, ev_ref, ev_port), _ = train_with_validation("goss", 30)
    want = np.asarray(ev_ref["v"]["binary_logloss"])
    got = np.asarray(ev_port["v"]["binary_logloss"])
    assert got.size == want.size
    np.testing.assert_allclose(got[:14], want[:14], rtol=1e-5)
    # the validation log loss at the initial score (boost from average)
    y = make_data("binary", n=3000, seed=3)[1]
    yv = make_data("binary", n=1000, seed=4)[1]
    s0 = np.log(y.mean() / (1 - y.mean()))
    start = float(np.mean(np.logaddexp(0.0, s0) - yv * s0))
    assert np.all(np.abs(got - want) <= 0.02 * (start - want))
