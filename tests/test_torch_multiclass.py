"""Multiclass boosting in the port against the JAX package, on the CPU.

``multiclass`` (softmax) and ``multiclassova`` with ``num_class=3`` (3,000
training and 1,000 held-out rows x 10 features, 63 bins, 15 leaves, one
torch thread):

- K = 3 trees an iteration, ``num_tree_per_iteration`` and the model text's
  ``num_class``/``num_tree_per_iteration`` as the JAX package writes them;
- the port's model text loads in ``lightgbm_tpu`` and the JAX package's in
  the port: predictions [n, 3] (raw and converted) within 1e-4, the JAX
  text's in the port within 1e-6 of the JAX booster's own (the same leaf
  values, summed in f64 by the port and in f32 by the JAX predictor);
  softmax rows sum to 1;
- early stopping on ``multi_logloss`` (validation set, 2 rounds of patience,
  noisy labels so it stops before round 30) stops at the JAX package's
  ``best_iteration`` and ``current_iteration``, with the same per-iteration
  ``multi_logloss`` and ``multi_error`` within 1e-6;
- ``init_model`` continues a 3-class model to the JAX continuation's trees.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from test_torch_objectives import assert_same_trees
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)

N, NV, NF, K = 3000, 1000, 10, 3
DS = {"max_bin": 63}


def make_data(noise=0.5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N + NV, NF)).astype(np.float32)
    z = (X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + rng.normal(scale=noise, size=N + NV))
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)
    return X[:N], y[:N], X[N:], y[N:]


def params(obj, **extra):
    return dict(objective=obj, num_class=K, num_leaves=15, learning_rate=0.1,
                max_bin=63, min_data_in_leaf=20, verbosity=-1, **extra)


@pytest.fixture(scope="module", params=["multiclass", "multiclassova"])
def trained(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        X, y, Xv, _ = make_data()
        p = params(request.param)
        ref = J.train(p, J.Dataset(X, y, params=DS), num_boost_round=3,
                      verbose_eval=False)
        port = P.train(p, P.Dataset(X, y, params=DS), num_boost_round=3,
                       verbose_eval=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return request.param, Xv, ref, port


def test_k_trees_an_iteration(trained):
    _, _, ref, port = trained
    gbdt = port._booster
    assert gbdt.num_tree_per_iteration == K
    assert port.num_trees() == 3 * K and port.current_iteration() == 3
    assert gbdt.train_score.shape == (K, N)
    assert_same_trees(ref._booster.models, gbdt.models)
    text = port.model_to_string()
    assert "\nnum_class=%d\n" % K in text
    assert "\nnum_tree_per_iteration=%d\n" % K in text
    head = lambda b: b.model_to_string().split("\ntree_sizes=")[0]  # noqa
    assert head(port) == head(ref)


def test_predictions_and_model_text_cross_load(trained):
    obj, Xv, ref, port = trained
    for raw in (True, False):
        want = ref.predict(Xv, raw_score=raw)
        got = port.predict(Xv, raw_score=raw)
        assert got.shape == want.shape == (NV, K)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        # the port's text in the JAX package, the JAX text in the port
        in_jax = J.Booster(model_str=port.model_to_string(), params=params(obj))
        np.testing.assert_allclose(in_jax.predict(Xv, raw_score=raw), got,
                                   rtol=0, atol=1e-4)
        in_port = P.Booster(model_str=ref.model_to_string(),
                            params=params(obj), device="cpu")
        assert in_port.num_trees() == 3 * K
        np.testing.assert_allclose(in_port.predict(Xv, raw_score=raw), want,
                                   rtol=0, atol=1e-6)
    if obj == "multiclass":
        np.testing.assert_allclose(port.predict(Xv).sum(axis=1), 1.0,
                                   rtol=0, atol=1e-12)


def test_early_stopping_on_multi_logloss_like_jax(one_thread):
    X, y, Xv, yv = make_data(noise=3.0, seed=1)
    p = params("multiclass", metric=["multi_logloss", "multi_error"])
    out = []
    for lib, kw in ((J, {}), (P, dict(device="cpu"))):
        train = lib.Dataset(X, y, params=DS)
        valid = lib.Dataset(Xv, yv, reference=train)
        evals = {}
        b = lib.train(p, train, num_boost_round=30, valid_sets=[valid],
                      evals_result=evals, early_stopping_rounds=2,
                      verbose_eval=False, **kw)
        out.append((b, evals))
    (ref, ref_ev), (port, port_ev) = out
    assert port.best_iteration == ref.best_iteration
    assert port.current_iteration() == ref.current_iteration() < 30
    assert 0 < port.best_iteration < port.current_iteration()
    for metric in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(port_ev["valid_0"][metric],
                                   ref_ev["valid_0"][metric], rtol=0,
                                   atol=1e-6, err_msg=metric)


def test_init_model_continues_like_jax(trained, one_thread, tmp_path):
    obj, _, ref, _ = trained
    X, y, Xv, _ = make_data()
    path = str(tmp_path / "model.txt")
    ref.save_model(path)
    ref2 = J.train(params(obj), J.Dataset(X, y, params=DS),
                   num_boost_round=2, init_model=path, verbose_eval=False)
    port2 = P.train(params(obj), P.Dataset(X, y, params=DS),
                    num_boost_round=2, init_model=path, verbose_eval=False,
                    device="cpu")
    assert port2.num_trees() == ref2.num_trees() == 5 * K
    assert_same_trees(ref2._booster.models, port2._booster.models)
    np.testing.assert_allclose(port2.predict(Xv, raw_score=True),
                               ref2.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-4)
