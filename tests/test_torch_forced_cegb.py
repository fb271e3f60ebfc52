"""Forced splits (serial_tree_learner.cpp:458 ForceSplits) and CEGB
(cost_effective_gradient_boosting.hpp:21-120) on the port against the JAX
package, on the CPU.

Both packages train through their own ``train()`` on the same numpy input:
5,000 rows x 6 features with a binary label (``tests/test_forced_cegb.py``'s
data, thresholded), max_bin=63, num_leaves=15, learning_rate=0.1, 6
iterations.  Required: trees equal (split features, threshold bins,
children, leaf counts), leaf values within
``test_torch_train.leaf_value_tolerance``, predictions within 1e-4.  The
coupled refund case is ``test_cegb_coupled_refund_promotes_cached_candidates``
of the JAX package's tests (L2 regression, 4,000 rows x 4 features), held to
the same trees with its leaf values within :func:`l2_leaf_tolerance`.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.core import tree_learner as port_tl
from lightgbm_tpu_torch.utils.log import Log
from test_torch_boosters import assert_trees_equal
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)

N = 5000
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, verbosity=0)
ITERS = 6
# a three-split schedule in the form of LightGBM's
# examples/binary_classification/forced_splits.json
FORCED = {"feature": 5, "threshold": 0.25,
          "left": {"feature": 4, "threshold": -0.5},
          "right": {"feature": 4, "threshold": 0.4}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(13)
    X = rng.normal(size=(N, 6)).astype(np.float32)
    z = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] + 0.4 * X[:, 3]
         + rng.normal(scale=0.4, size=N))
    return X, (z > 0).astype(np.float64)


@pytest.fixture
def warnings():
    """The port's log lines of level warning or worse, one per line.  The
    log level is process-global (an in-process CLI run with verbosity=-1
    earlier in the same process leaves it at FATAL), so it is pinned to
    WARNING here and restored after."""
    lines = []
    level = Log._level
    Log.reset_level(Log.Level.WARNING)
    Log.reset_callback(lines.append)
    try:
        yield lines
    finally:
        Log.reset_callback(None)
        Log.reset_level(level)


def forced_file(tmp_path, spec) -> str:
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    return str(path)


def train_both(X, y, params, iters=ITERS, cats=None):
    kw = {} if cats is None else dict(categorical_feature=cats)
    ref = J.train(params, J.Dataset(X, y, **kw), num_boost_round=iters,
                  verbose_eval=False)
    port = P.train(params, P.Dataset(X, y, **kw), num_boost_round=iters,
                   verbose_eval=False, device="cpu")
    return ref, port


def assert_same(ref, port, X):
    assert_trees_equal(ref._booster.models, port._booster.models, len(X))
    np.testing.assert_allclose(port.predict(X[:1000], raw_score=True),
                               ref.predict(X[:1000], raw_score=True),
                               rtol=0, atol=1e-4)


def warned(lines, text) -> int:
    return sum("[Warning]" in line and text in line for line in lines)


# ---- forced splits ----

def test_forced_split_trees_match_jax(data, tmp_path, one_thread):
    X, y = data
    fname = forced_file(tmp_path, FORCED)
    ref, port = train_both(X, y, dict(PARAMS, forcedsplits_filename=fname))
    assert_same(ref, port, X)
    sched = port._booster.learner.forced
    np.testing.assert_array_equal(sched[0], [0, 0, 1])   # leaf of each step
    np.testing.assert_array_equal(sched[1], [5, 4, 4])
    for tree in port._booster.models:
        # the first three splits are the forced ones, in BFS order
        np.testing.assert_array_equal(tree.split_feature[:3], [5, 4, 4])
        np.testing.assert_array_equal(tree.threshold_in_bin[:3], sched[2])
        assert tree.left_child[0] == 1 and tree.right_child[0] == 2


def test_forced_splits_missing_file(data, tmp_path, warnings, one_thread):
    """A missing file: one warning and no schedule (the trees of a run
    without forced splits)."""
    X, y = data
    params = dict(PARAMS, forcedsplits_filename=str(tmp_path / "none.json"))
    ref, port = train_both(X, y, params, iters=2)
    assert port._booster.learner.forced is None
    assert warned(warnings, "does not exist") == 1
    assert_same(ref, port, X)
    free = P.train(PARAMS, P.Dataset(X, y), num_boost_round=2,
                   verbose_eval=False, device="cpu")
    assert_trees_equal(free._booster.models, port._booster.models, N)


def test_forced_split_on_categorical_feature_drops_the_rest(
        data, tmp_path, warnings, one_thread):
    """A categorical feature in the schedule ends it there, with a warning:
    only the root split is forced."""
    X, y = data
    Xc = X.copy()
    Xc[:, 5] = np.digitize(X[:, 5], [-1.0, 0.0, 1.0])   # 4 categories
    spec = {"feature": 0, "threshold": 0.1,
            "left": {"feature": 5, "threshold": 1.0},
            "right": {"feature": 1, "threshold": 0.0}}
    params = dict(PARAMS, forcedsplits_filename=forced_file(tmp_path, spec))
    ref, port = train_both(Xc, y, params, iters=3, cats=[5])
    sched = port._booster.learner.forced
    assert [a.tolist() for a in sched] == [[0], [0], [sched[2][0]]]
    assert warned(warnings, "unusable feature 5") == 1
    assert_same(ref, port, Xc)
    assert all(t.split_feature[0] == 0 for t in port._booster.models)


def test_level_growth_with_forced_splits_grows_leaf_wise(
        data, tmp_path, warnings, one_thread):
    X, y = data
    params = dict(PARAMS, tree_grow_mode="level",
                  forcedsplits_filename=forced_file(tmp_path, FORCED))
    ref, port = train_both(X, y, params, iters=3)
    learner = port._booster.learner
    assert learner.effective_grow_mode() == "leaf"
    assert learner.launches_per_tree() == PARAMS["num_leaves"] - 1
    assert warned(warnings, "tree_grow_mode=level unavailable "
                            "(forced splits); growing leaf-wise") == 1
    assert_same(ref, port, X)
    assert all(t.split_feature[0] == 5 for t in port._booster.models)


# ---- CEGB ----

@pytest.mark.parametrize("params", [
    dict(cegb_penalty_split=0.002),
    dict(cegb_penalty_feature_coupled=[0.0, 0.0, 20.0, 20.0, 20.0, 20.0]),
    dict(cegb_penalty_feature_lazy=[0.01, 0.01, 0.05, 0.05, 0.05, 0.05]),
    dict(cegb_penalty_split=0.001, cegb_tradeoff=2.0,
         cegb_penalty_feature_coupled=[1.0, 5.0, 5.0, 5.0, 5.0, 5.0],
         cegb_penalty_feature_lazy=[0.01] * 6),
], ids=["split", "coupled", "lazy", "all_three"])
def test_cegb_trees_match_jax(data, params, one_thread):
    X, y = data
    ref, port = train_both(X, y, dict(PARAMS, **params))
    assert_same(ref, port, X)
    # the penalties change the model
    free = P.train(PARAMS, P.Dataset(X, y), num_boost_round=ITERS,
                   verbose_eval=False, device="cpu")
    ours = port._booster.models
    assert any(a.num_leaves != b.num_leaves
               or not np.array_equal(a.split_feature, b.split_feature)
               for a, b in zip(free._booster.models, ours))


def l2_leaf_tolerance(tree, n, gmax, lr):
    """rtol 1e-5 plus the f32 cancellation of a leaf's gradient sum, as in
    ``leaf_value_tolerance``: L2 regression has |g| <= ``gmax`` and h = 1,
    so the sum of hessians is an exact count and the gradient sum carries
    up to (depth + 2) roundings of sums as large as ``n * gmax``."""
    nl = tree.num_leaves
    v = np.abs(tree.leaf_value[:nl])
    h = np.asarray(tree.leaf_weight[:nl], np.float64)
    depth = np.asarray(tree.leaf_depth[:nl], np.float64)
    return 1e-5 * v + lr * 2 * (depth + 2) * 2.0 ** -24 * n * gmax / h


def test_cegb_coupled_refund_promotes_cached_candidates(monkeypatch,
                                                        one_thread):
    """A coupled penalty on every feature: the first split on feature 0
    refunds its penalty in the other leaves' cached candidates, some of
    which then win (counted by a spy on ``_DeviceGrowth._refund``, the
    build that grows these trees), so feature 0 splits several nodes.
    Trees equal the JAX package's."""
    rng = np.random.RandomState(6)
    n = 4000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.sin(2 * X[:, 0]) * 2 + 0.2 * X[:, 1] + rng.normal(scale=0.2,
                                                             size=n)
    promoted = []
    refund = port_tl._DeviceGrowth._refund
    col = port_tl._B["feature"]

    def spy(self, fid, ok):
        before = self.best[:self.L, col].clone()
        refund(self, fid, ok)
        promoted.append(int((self.best[:self.L, col] != before).sum()))
    monkeypatch.setattr(port_tl._DeviceGrowth, "_refund", spy)
    params = dict(objective="regression", num_leaves=15, learning_rate=0.2,
                  max_bin=63, verbosity=-1,
                  cegb_penalty_feature_coupled=[3.0, 3.0, 3.0, 3.0])
    ref, port = train_both(X, y, params, iters=8)
    a_models, b_models = ref._booster.models, port._booster.models
    assert len(a_models) == len(b_models) == 8
    gmax = float(np.abs(y - y.mean()).max())
    for i, (a, b) in enumerate(zip(a_models, b_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl
        for name in ("split_feature_inner", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            l2_leaf_tolerance(a, n, gmax, 0.2))
    splits_on_0 = sum(int(t.split_feature[i]) == 0 for t in b_models
                      for i in range(t.num_leaves - 1))
    assert splits_on_0 >= 2
    assert sum(promoted) > 0


def test_cegb_lazy_paid_bits_match_jax(data, one_thread):
    """The per-(row, feature) paid bits after 3 trees: byte for byte the
    JAX learner's ``cegb_paid``, in original row order."""
    X, y = data
    params = dict(PARAMS, cegb_penalty_feature_lazy=[0.01, 0.01, 0.02, 0.02,
                                                     0.05, 0.05])
    ref, port = train_both(X, y, params, iters=3)
    assert_same(ref, port, X)
    want = np.asarray(ref._booster.learner.cegb_paid)[:N]
    learner = port._booster.learner
    got = learner.cegb_paid.numpy()
    assert got.shape == want.shape == (N, 1)
    np.testing.assert_array_equal(got, want)
    assert learner.layout.bitbytes == 1
    assert (got != 0).any()
    np.testing.assert_array_equal(learner.cegb_used,
                                  np.asarray(ref._booster.learner.cegb_used))
