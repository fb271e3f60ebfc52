"""The bounded histogram pool (``histogram_pool_size``; the reference's LRU
HistogramPool, feature_histogram.hpp:687) on the port against the JAX
package, on the CPU.

With a pool the per-leaf histogram cache becomes K slots, and a parent whose
slot was evicted is rebuilt by streaming its window.  A rebuilt parent is
not bit-equal to the subtraction chain, so pooled against unbounded is held
to the JAX package's own bounds (``tests/test_hist_pool.py``
``test_pooled_build_exact_mode_tight``: at least 98% of the split features
and of the rows' leaves equal, sorted leaf values within rtol 1e-4 and atol
1e-5).  The port's pooled tree against the JAX package's pooled tree at the
same K takes the same slots and rebuilds (the bookkeeping is host
integers), so it is held to tree equality, leaf values within
``test_torch_train.leaf_value_tolerance`` scaled to this fixture's
gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.tree_learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu_torch import BinnedDataset, Config
from lightgbm_tpu_torch.core import tree_learner as port_tl
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)


def problem(n=3000, f=10, seed=5):
    """``tests/test_hist_pool.py``'s fixture: L2 gradients of a nonlinear
    target, unit hessians."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + X[:, 2] * X[:, 3] \
        + rng.normal(scale=0.1, size=n)
    grad = (-(y - y.mean())).astype(np.float32)
    return X, y, grad, np.ones(n, np.float32)


def port_learner(X, y, **params):
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    return port_tl.SerialTreeLearner(ds, Config(**params), device="cpu")


def port_tree(learner, grad, hess):
    return learner.train(torch.from_numpy(grad), torch.from_numpy(hess),
                         len(grad))


@pytest.mark.parametrize("mb,f", [(0.5, 8), (0.02, 10), (3.0, 40),
                                  (0.001, 10)])
def test_slot_count_matches_jax(mb, f):
    X, y, _, _ = problem(f=f)
    ref = JaxLearner(JaxDataset.from_matrix(X, label=y, max_bin=63),
                     JaxConfig(num_leaves=31, histogram_pool_size=mb))
    port = port_learner(X, y, num_leaves=31, histogram_pool_size=mb)
    assert port.hist_pool_slots == ref.hist_pool_slots >= 2
    assert port.hist_pool_slots == port_tl.pool_slot_count(
        mb, port.num_columns, port.num_bins)


def test_pooled_build_matches_unbounded(one_thread):
    """K = 4 slots on a 31-leaf tree: constant eviction and rebuilds."""
    X, y, grad, hess = problem(f=11, seed=7)
    want = port_tree(port_learner(X, y, num_leaves=31, min_data_in_leaf=5),
                     grad, hess)
    pooled = port_learner(X, y, num_leaves=31, min_data_in_leaf=5,
                          histogram_pool_size=1)
    pooled.hist_pool_slots = 4
    got = port_tree(pooled, grad, hess)
    nl = want.num_leaves
    assert got.num_leaves == nl == 31
    assert got.pool_misses > 0 and want.pool_misses == 0
    same_split = np.mean(got.split_feature[:nl - 1]
                         == want.split_feature[:nl - 1])
    assert same_split >= 0.98, f"only {same_split:.2%} splits agree"
    assert (got.row_leaf == want.row_leaf).double().mean() >= 0.98
    np.testing.assert_allclose(np.sort(got.leaf_value[:nl]),
                               np.sort(want.leaf_value[:nl]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slots", [2, 4, 9])
def test_pooled_tree_matches_jax_pooled_tree(slots, one_thread):
    X, y, grad, hess = problem()
    ref = JaxLearner(JaxDataset.from_matrix(X, label=y, max_bin=63),
                     JaxConfig(num_leaves=31, min_data_in_leaf=5,
                               histogram_pool_size=1))
    ref.hist_pool_slots = slots
    want = jax.tree_util.tree_map(np.asarray, ref.train(
        jnp.asarray(grad), jnp.asarray(hess), len(grad)))
    port = port_learner(X, y, num_leaves=31, min_data_in_leaf=5,
                        histogram_pool_size=1)
    port.hist_pool_slots = slots
    got = port_tree(port, grad, hess)
    nl = int(want.num_leaves)
    assert got.num_leaves == nl
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(got, name)[:nl - 1],
                                      getattr(want, name)[:nl - 1],
                                      err_msg=name)
    np.testing.assert_array_equal(got.leaf_count[:nl], want.leaf_count[:nl])
    np.testing.assert_array_equal(got.row_leaf.numpy(), want.row_leaf)
    # leaf_value_tolerance's rounding bound for L2: h = 1, |g| <= gmax
    depth = want.leaf_depth[:nl].astype(np.float64)
    gmax = float(np.abs(grad).max())
    tol = (1e-5 * np.abs(want.leaf_value[:nl]) + 2 * (depth + 2) * 2.0 ** -24
           * len(grad) * gmax / want.leaf_weight[:nl])
    np.testing.assert_array_less(
        np.abs(got.leaf_value[:nl] - want.leaf_value[:nl]), tol)


def test_pool_cache_is_k_slots(monkeypatch, one_thread):
    """The cache tensor is [K, columns, 2, B], independent of num_leaves;
    without a pool (the device build) it is [num_leaves + 1, columns, 2,
    B]: a row a leaf and the row that dead steps write."""
    shapes = []
    for cls, name in ((port_tl._Growth, "arrays"),
                      (port_tl._DeviceGrowth, "finish")):
        real = getattr(cls, name)

        def spy(self, *a, _real=real, **k):
            shapes.append(tuple(self.hist.shape))
            return _real(self, *a, **k)
        monkeypatch.setattr(cls, name, spy)
    X, y, grad, hess = problem(f=12)
    for pool in (False, True):
        lrn = port_learner(X, y, num_leaves=255, min_data_in_leaf=2,
                           **(dict(histogram_pool_size=1) if pool else {}))
        if pool:
            lrn.hist_pool_slots = 8
        port_tree(lrn, grad, hess)
    cols, B = lrn.num_columns, lrn.num_bins
    assert shapes == [(256, cols, 2, B), (8, cols, 2, B)]


def test_pool_is_ignored_with_forced_splits_or_cegb(tmp_path):
    X, y, _, _ = problem(f=6)
    path = tmp_path / "forced.json"
    path.write_text('{"feature": 0, "threshold": 0.0}')
    for extra in (dict(forcedsplits_filename=str(path)),
                  dict(cegb_penalty_split=0.1)):
        lrn = port_learner(X, y, num_leaves=31, histogram_pool_size=1,
                           **extra)
        assert lrn.hist_pool_slots == 0
