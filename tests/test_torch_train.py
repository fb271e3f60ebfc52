"""The slice as a whole: the port's GBDT against the JAX package's, on the CPU.

Both train the binary objective on the same binned data: the reference's
``BinnedDataset`` is carried into the port with
``convert.dataset_from_arrays``.  About 4,000 rows x 8 features, max_bin=63,
num_leaves=15, 3 iterations.  Required: every tree's split features, threshold
bins and leaf counts equal; leaf values within rtol 1e-5 plus the bound of the
f32 cancellation in their sums (``leaf_value_tolerance``); train scores within
1e-5 absolute (f32 sums in another order); a reference model string loaded
through ``convert`` predicts within 1e-6 of the reference.

A second dataset holds NaNs.  A leaf that has no NaN rows sees both missing
directions give the same partition, so the reference's rule "missing-left wins
ties" is decided there by f32 rounding, which differs between XLA and PyTorch:
``default_left`` and the hessian-estimated leaf counts may then differ while
every training row still lands in the same leaf.  On that data the trees'
splits, thresholds and shape must be equal and the per-row scores close.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import GBDT, Config, create_objective
from lightgbm_tpu_torch.convert import (dataset_from_arrays,
                                        gbdt_from_model_string)
from lightgbm_tpu_torch.core.tree_learner import (route_binned,
                                                  tree_output_binned)

torch.set_num_threads(2)

PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, verbosity=-1)
ITERS = 3


@pytest.fixture(scope="module", params=["dense", "nan"])
def trained(request):
    rng = np.random.RandomState(0)
    n, f = 4000, 8
    X = rng.normal(size=(n, f)).astype(np.float32)
    if request.param == "nan":
        X[rng.uniform(size=(n, f)) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) * 2 + np.nan_to_num(X[:, 1]) ** 2
          - np.nan_to_num(X[:, 2] * X[:, 3]) + rng.normal(scale=0.5, size=n))
         > 0).astype(np.float64)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref_cfg = JaxConfig(**PARAMS)
    ref = JaxGBDT(ref_cfg, ref_ds, jax_objective("binary", ref_cfg))
    for _ in range(ITERS):
        ref.train_one_iter()

    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y,
        mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    cfg = Config(**PARAMS)
    port = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                device="cpu")
    for _ in range(ITERS):
        port.train_one_iter()
    return X, y, ref, port, request.param


def test_trees_equal(trained):
    X, _, ref, port, kind = trained
    assert len(ref.models) == len(port.models) == ITERS
    for a, b in zip(ref.models, port.models):
        nl = a.num_leaves
        assert b.num_leaves == nl
        for name in ("split_feature_inner", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg=name)
        np.testing.assert_allclose(b.threshold[:nl - 1], a.threshold[:nl - 1])
        if kind == "dense":
            np.testing.assert_array_equal(b.decision_type[:nl - 1],
                                          a.decision_type[:nl - 1])
            np.testing.assert_array_equal(b.leaf_count[:nl],
                                          a.leaf_count[:nl])
            np.testing.assert_array_less(
                np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
                leaf_value_tolerance(a, X.shape[0]))


def leaf_value_tolerance(tree, n):
    """rtol 1e-5, plus the f32 cancellation both sides carry.

    A leaf's sums G and H are not summed over its own rows: each comes from
    f32 prefix sums over bins and ``total - prefix`` at its parent, and the
    parent's histogram from the subtraction trick one level up, so it carries
    up to (depth + 2) roundings of sums as large as the root's.  Binary
    log-loss bounds |g| by 1 and h by 1/4, so those sums are at most n and
    n/4, and each rounding errs by at most u = 2**-24 of them.  The value
    lr * G / H then errs by lr * (dG + |G/H| dH) / H on each side; both the
    port and the reference carry such an error (measured: about 1e-5 of H
    on a 48-row leaf, in opposite directions)."""
    nl = tree.num_leaves
    v = np.abs(tree.leaf_value[:nl])
    h = np.asarray(tree.leaf_weight[:nl], np.float64)
    depth = np.asarray(tree.leaf_depth[:nl], np.float64)
    lr = PARAMS["learning_rate"]
    roundings = 2 * (depth + 2) * 2.0 ** -24
    return 1e-5 * v + lr * roundings * (n + (v / lr) * n / 4) / h


def test_train_scores_close(trained):
    X, _, ref, port, _ = trained
    want = np.asarray(ref.train_score)[0, :X.shape[0]]
    got = port.train_score[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predict_close(trained):
    X, _, ref, port, _ = trained
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(X[:500], raw_score=raw),
                                   ref.predict(X[:500], raw_score=raw),
                                   rtol=0, atol=1e-5)


def test_reference_model_string_loads_and_predicts(trained):
    X, _, ref, _, _ = trained
    text = ref.save_model_to_string()
    port = gbdt_from_model_string(text, Config(**PARAMS), device="cpu")
    assert len(port.models) == ITERS
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)


def test_port_model_string_round_trip(trained):
    X, _, _, port, _ = trained
    again = gbdt_from_model_string(port.save_model_to_string(),
                                   Config(**PARAMS), device="cpu")
    np.testing.assert_array_equal(again.predict(X, raw_score=True),
                                  port.predict(X, raw_score=True))


def test_row_leaf_matches_routing_the_bins(trained):
    """The leaf of every row read back from the partitioned store's order
    bytes equals the leaf that routing its bins through the tree gives."""
    _, _, _, port, _ = trained
    arrays = port.last_arrays
    bins = torch.from_numpy(np.asarray(port.train_data.binned))
    feat_host = port.learner.feat_host
    leaf = route_binned(bins, arrays, feat_host)
    assert arrays.num_leaves > 1
    assert torch.equal(leaf, arrays.row_leaf)
    np.testing.assert_array_equal(
        tree_output_binned(bins, arrays, feat_host).numpy(),
        arrays.leaf_value[arrays.row_leaf.numpy()])


def test_dataset_from_arrays_without_mappers_grows_the_same_trees(trained):
    X, y, ref, port, _ = trained
    rd = ref.train_data
    ds = dataset_from_arrays(rd.binned, rd.num_bin_per_feature,
                             rd.missing_types(), rd.default_bins(),
                             rd.feature_is_categorical(), y)
    cfg = Config(**PARAMS)
    other = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                 device="cpu")
    other.train_one_iter()
    a, b = port.models[0], other.models[0]
    nl = a.num_leaves
    np.testing.assert_array_equal(b.threshold_in_bin[:nl - 1],
                                  a.threshold_in_bin[:nl - 1])
    np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
