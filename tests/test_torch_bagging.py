"""Bagging and ``feature_fraction`` in the port against the JAX package, on
the CPU.

- The bag mask and its realised count equal ``lightgbm_tpu.boosting.gbdt.
  _bag_mask_for`` byte for byte, over seeds, iterations (and so windows),
  bagging frequencies and fractions, plain and pos/neg balanced (a per-row
  fraction): the port runs the JAX package's stateless hash in int64 masked
  to 32 bits.
- The ``feature_fraction`` masks of 10 iterations equal the JAX booster's
  (one draw an iteration from ``RandomState(feature_fraction_seed)``).
- Training with ``regression`` + bagging + ``feature_fraction`` (3,000 rows x
  10 features, 63 bins, 15 leaves, 3 rounds, one torch thread) grows the JAX
  package's trees: split features, threshold bins, child pointers and leaf
  counts equal, leaf values and predictions within 1e-4 (f32 sums in another
  order), the same bag masks and counts; leaf-wise exact, quantized, and
  binary with balanced bagging, through ``lightgbm_tpu_torch.train`` against
  ``lightgbm_tpu.train``; and level growth against the JAX package's level
  path in Pallas interpret mode, with the ``pl.load``/``pl.store`` shim set
  by ``monkeypatch`` as ``tests/test_torch_level_oracle.py`` sets it (4,096
  rows x 8 features, 2 iterations, a new bag each iteration).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.boosting.gbdt import _bag_mask_for as jax_bag_mask_for
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import GBDT, Config, create_objective
from lightgbm_tpu_torch.boosting.gbdt import bag_mask_for
from lightgbm_tpu_torch.convert import dataset_from_arrays
from test_torch_level_oracle import _shim_is_undone, _store  # noqa: F401
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)

LEAF_ATOL = 1e-4
PREDICT_ATOL = 1e-4


@pytest.mark.parametrize("seed,it,freq,frac", [
    (3, 0, 1, 0.8), (3, 7, 5, 0.8), (0, 1, 1, 0.5), (12345, 40, 3, 0.1),
    (2 ** 31 - 1, 99, 7, 0.999), (7, 2 ** 20, 2, 0.3)])
def test_bag_mask_bit_equal(seed, it, freq, frac):
    n = 50000
    ids = np.arange(n, dtype=np.int32)
    want, want_cnt = jax_bag_mask_for(jnp.asarray(ids), seed, jnp.int32(it),
                                      freq, frac)
    got, got_cnt = bag_mask_for(torch.from_numpy(ids).long(), seed, it, freq,
                                frac)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert got_cnt == int(want_cnt)
    assert 0 < got_cnt < n


@pytest.mark.parametrize("seed,it", [(3, 0), (11, 9), (99, 1000)])
def test_balanced_bag_mask_bit_equal(seed, it):
    """A per-row fraction (pos/neg balanced bagging)."""
    n = 30000
    rng = np.random.RandomState(seed)
    pos = rng.uniform(size=n) < 0.3
    frac = np.where(pos, np.float32(0.9), np.float32(0.2)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    want, want_cnt = jax_bag_mask_for(jnp.asarray(ids), seed, jnp.int32(it),
                                      4, jnp.asarray(frac))
    got, got_cnt = bag_mask_for(torch.from_numpy(ids).long(), seed, it, 4,
                                torch.from_numpy(frac))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert got_cnt == int(want_cnt)


def make_data(n=3000, f=10, seed=0, binary=False):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    z = (X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n))
    return X, ((z > 0).astype(np.float64) if binary else 3 * z)


def test_feature_mask_stream_equal():
    X, y = make_data()
    params = dict(objective="regression", feature_fraction=0.7,
                  feature_fraction_seed=5, max_bin=63, verbosity=-1)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref = JaxGBDT(JaxConfig(**params), ref_ds,
                  jax_objective("regression", JaxConfig(**params)))
    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y)
    cfg = Config(**params)
    port = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
                device="cpu")
    for _ in range(10):
        want = np.asarray(ref._feature_mask())
        got = port._feature_mask().numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 7


def assert_same_trees(ref_models, port_models):
    assert len(ref_models) == len(port_models)
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl > 2, "tree %d" % i
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


SAMPLING = {
    "regression": dict(objective="regression", bagging_fraction=0.7,
                       bagging_freq=2, feature_fraction=0.8),
    "quantized": dict(objective="regression", bagging_fraction=0.8,
                      bagging_freq=1, feature_fraction=0.9,
                      hist_precision="quantized"),
    "balanced": dict(objective="binary", pos_bagging_fraction=0.5,
                     neg_bagging_fraction=0.8, bagging_freq=1,
                     feature_fraction=0.8),
}


@pytest.mark.parametrize("case", list(SAMPLING))
def test_training_with_sampling_matches_jax(case, one_thread):
    X, y = make_data(binary=case == "balanced")
    params = dict(SAMPLING[case], num_leaves=15, learning_rate=0.1,
                  max_bin=63, min_data_in_leaf=20, verbosity=-1)
    ref = J.train(params, J.Dataset(X, y, params={"max_bin": 63}),
                  num_boost_round=3, verbose_eval=False)
    port = P.train(params, P.Dataset(X, y, params={"max_bin": 63}),
                   num_boost_round=3, verbose_eval=False, device="cpu")
    assert_same_trees(ref._booster.models, port._booster.models)
    rb, pb = ref._booster, port._booster
    assert pb.bag_data_cnt == rb.bag_data_cnt < len(y)
    np.testing.assert_array_equal(pb.bag_mask.numpy(),
                                  np.asarray(rb.bag_mask)[:len(y)])
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=PREDICT_ATOL)


def test_level_growth_with_sampling_matches_jax_level_path(monkeypatch,
                                                           one_thread):
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    monkeypatch.setenv("LIGHTGBM_TPU_EXACT_HIST", "1")
    X, y = make_data(n=4096, f=8)
    params = dict(objective="regression", num_leaves=15, learning_rate=0.1,
                  max_bin=63, verbosity=-1, tree_grow_mode="level",
                  bagging_fraction=0.75, bagging_freq=1,
                  feature_fraction=0.75)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref_cfg = JaxConfig(**params)
    ref = JaxGBDT(ref_cfg, ref_ds, jax_objective("regression", ref_cfg))
    ref.learner.use_pallas = True
    ref.learner.pallas_interpret = True
    assert ref.learner.effective_grow_mode() == "level"
    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y,
        mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    cfg = Config(**params)
    port = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
                device="cpu")
    counts = []
    for _ in range(2):
        ref.train_one_iter()
        port.train_one_iter()
        assert port.last_arrays.levels == port.learner.level_count()
        assert port.bag_data_cnt == ref.bag_data_cnt
        counts.append(port.bag_data_cnt)
    assert counts[0] != counts[1]          # a new bag each iteration
    assert_same_trees(ref.models, port.models)
    for a, b in zip(ref.models, port.models):
        nl = a.num_leaves
        for name in ("leaf_depth", "leaf_parent"):
            np.testing.assert_array_equal(getattr(b, name)[:nl],
                                          getattr(a, name)[:nl])
    np.testing.assert_allclose(port.train_score[0].numpy(),
                               np.asarray(ref.train_score)[0, :len(y)],
                               rtol=0, atol=PREDICT_ATOL)
