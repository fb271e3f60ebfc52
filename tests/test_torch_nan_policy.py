"""``nan_policy`` in the port against the JAX package, on the CPU.

A custom binary log-loss objective returns one NaN gradient at iteration 2;
both packages train on the same rows with ``lightgbm_tpu.train`` and
``lightgbm_tpu_torch.train``.  ``raise`` raises in both.  Under
``skip_iter`` the iteration adds one constant tree and the scores stay
untouched; under ``clip`` the NaN becomes 0 and training goes on.  In both
cases the trees are equal (split features, threshold bins, children, leaf
counts), the leaf values within ``test_torch_train.leaf_value_tolerance``
and the predictions within 1e-4.  A poisoned built-in objective at the first
iteration holds the skipped trees to the boost-from-average offset, as the
JAX package keeps it (gbdt.py:1357-1360).
"""
import numpy as np
import pytest

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.utils.log import LightGBMError as JaxError
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

N, F, ITERS, NAN_AT = 3000, 8, 5, 2
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              verbosity=-1)
DATA = {"max_bin": 63}


def make_data():
    rng = np.random.RandomState(3)
    X = rng.normal(size=(N, F))
    y = (X[:, 0] * 2 + X[:, 1] ** 2 - 1
         + rng.normal(scale=0.5, size=N) > 0).astype(np.float64)
    return X, y


def poisoned_logloss():
    """Binary log-loss gradients, with a NaN in row 7 on the third call."""
    calls = {"n": 0}

    def fobj(preds, data):
        y = data.get_label()
        p = 1.0 / (1.0 + np.exp(-preds))
        g, h = p - y, p * (1.0 - p)
        if calls["n"] == NAN_AT:
            g = g.copy()
            g[7] = np.nan
        calls["n"] += 1
        return g, h
    return fobj


def train_both(policy):
    X, y = make_data()
    params = dict(PARAMS, nan_policy=policy)
    ref = J.train(params, J.Dataset(X, y, params=DATA),
                  num_boost_round=ITERS, fobj=poisoned_logloss(),
                  verbose_eval=False)
    port = P.train(params, P.Dataset(X, y, params=DATA),
                   num_boost_round=ITERS, fobj=poisoned_logloss(),
                   verbose_eval=False, device="cpu")
    return X, ref, port


def assert_same_model(X, ref, port):
    a_models, b_models = ref._booster.models, port._booster.models
    assert len(a_models) == len(b_models) == ITERS
    for i, (a, b) in enumerate(zip(a_models, b_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl, "tree %d" % i
        for name in ("split_feature", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        if nl > 1:
            np.testing.assert_array_less(
                np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
                leaf_value_tolerance(a, X.shape[0]), err_msg="tree %d" % i)
        else:
            assert b.leaf_value[0] == a.leaf_value[0]
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True),
                               rtol=0, atol=1e-4)


def test_raise_raises_in_both(one_thread):
    with pytest.raises(JaxError, match="non-finite"):
        train_both("raise")
    X, y = make_data()
    with pytest.raises(LightGBMError, match="non-finite.*iteration 2"):
        P.train(dict(PARAMS, nan_policy="raise"),
                P.Dataset(X, y, params=DATA), num_boost_round=ITERS,
                fobj=poisoned_logloss(), verbose_eval=False, device="cpu")


def test_skip_iter_matches_jax(one_thread):
    X, ref, port = train_both("skip_iter")
    models = port._booster.models
    assert models[NAN_AT].num_leaves == 1
    assert models[NAN_AT].leaf_value[0] == 0.0
    assert all(t.num_leaves > 1 for i, t in enumerate(models) if i != NAN_AT)
    assert port.current_iteration() == ITERS
    assert_same_model(X, ref, port)


def test_clip_matches_jax(one_thread):
    X, ref, port = train_both("clip")
    assert all(t.num_leaves > 1 for t in port._booster.models)
    assert np.isfinite(port._booster.train_score.numpy()).all()
    assert_same_model(X, ref, port)


def _poison_first_iteration(gbdt):
    """The built-in objective's gradients turn NaN at the first call."""
    real = gbdt.objective.get_gradients
    calls = {"n": 0}

    def get_gradients(score):
        g, h = real(score)
        if calls["n"] == 0:
            g = g * float("nan")
        calls["n"] += 1
        return g, h
    gbdt.objective.get_gradients = get_gradients


def test_skip_first_iteration_keeps_the_offset(one_thread):
    """A skipped first iteration's constant tree carries the
    boost-from-average offset, which is already in the scores."""
    X, y = make_data()
    params = dict(PARAMS, nan_policy="skip_iter")
    ref = J.Booster(params, J.Dataset(X, y, params=DATA))
    port = P.Booster(params, P.Dataset(X, y, params=DATA), device="cpu")
    _poison_first_iteration(ref._booster)
    _poison_first_iteration(port._booster)
    for _ in range(3):
        ref.update()
        port.update()
    ref._booster._drain_nonfinite_checks()
    first = port._booster.models[0]
    assert first.num_leaves == 1
    assert first.leaf_value[0] != 0.0
    assert first.leaf_value[0] == pytest.approx(
        ref._booster.models[0].leaf_value[0], abs=1e-12)
    assert_same_model_iters(X, ref, port, 3)


def assert_same_model_iters(X, ref, port, iters):
    assert len(port._booster.models) == len(ref._booster.models) == iters
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(port._booster.train_score[0].numpy(),
                               np.asarray(ref._booster.train_score)[0, :N],
                               rtol=0, atol=1e-5)
