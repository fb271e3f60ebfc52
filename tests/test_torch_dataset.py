"""The port's dataset construction and row store against the JAX package's.

``lightgbm_tpu_torch.io.dataset.BinnedDataset.from_matrix`` must give the same
``binned`` matrix, bytes and all, as the reference on the same data, and the
row store the port's learner builds must be byte-equal to the one the
reference's ``build_tree_partitioned`` builds (tree_learner.py:293-402): the
reference's store is read back through its carried-row mode, whose extra
columns are zero here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core import tree_learner as jax_tl
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core import tree_learner as port_tl
from lightgbm_tpu_torch.io.dataset import BinnedDataset

torch.set_num_threads(2)


def make_matrix(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = np.stack([
        rng.normal(size=n),
        rng.exponential(size=n),
        rng.randint(0, 5, size=n).astype(float),         # few distinct values
        np.where(rng.uniform(size=n) < 0.3, 0.0, rng.normal(size=n)),
        np.where(rng.uniform(size=n) < 0.2, np.nan, rng.normal(size=n)),
        rng.uniform(-1, 1, size=n),
        np.full(n, 3.0),                                  # trivial feature
        rng.normal(size=n) * 1e3,
    ], axis=1).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0.5).astype(np.float64)
    return X, y


DATASETS = [
    ("bin255", dict(max_bin=255)),
    ("bin63", dict(max_bin=63)),
    ("bin15_packed", dict(max_bin=15)),
    ("bin600_u16", dict(max_bin=600)),
    ("zero_as_missing", dict(max_bin=63, zero_as_missing=True)),
    ("no_missing", dict(max_bin=63, use_missing=False)),
]


@pytest.mark.parametrize("name,kw", DATASETS, ids=[d[0] for d in DATASETS])
def test_from_matrix_binned_bytes_equal(name, kw):
    X, y = make_matrix(seed=len(name))
    ref = JaxDataset.from_matrix(X, label=y, **kw)
    got = BinnedDataset.from_matrix(X, label=y, **kw)
    assert got.binned.dtype == ref.binned.dtype
    np.testing.assert_array_equal(got.binned, ref.binned)
    assert list(got.num_bin_per_feature) == list(ref.num_bin_per_feature)
    np.testing.assert_array_equal(got.missing_types(), ref.missing_types())
    np.testing.assert_array_equal(got.default_bins(), ref.default_bins())
    assert got.used_feature_idx == ref.used_feature_idx
    assert got.is_bundled == ref.is_bundled
    for a, b in zip(got.bin_mappers, ref.bin_mappers):
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        for key in da:   # the NaN bin's upper bound is NaN on both sides
            np.testing.assert_array_equal(np.asarray(da[key]),
                                          np.asarray(db[key]), err_msg=key)


@pytest.mark.parametrize("max_bin", [255, 15, 600])
def test_row_store_bytes_equal(max_bin):
    X, y = make_matrix(n=1500, seed=7)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=max_bin)
    jcfg = JaxConfig(objective="binary", num_leaves=7, max_bin=max_bin,
                     verbosity=-1)
    jl = jax_tl.SerialTreeLearner(ref_ds, jcfg)
    n = ref_ds.num_data
    rng = np.random.RandomState(max_bin)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    zero = jnp.zeros(n, jnp.float32)
    _, ref_rows = jax_tl.build_tree_partitioned(
        jl.bins, jnp.asarray(grad), jnp.asarray(hess), jnp.int32(n),
        jnp.ones(ref_ds.num_features, bool), jl.feat, num_leaves=1,
        max_depth=-1, params=jl.params, num_bins=jl.num_bins,
        packed_cols=jl.packed_cols, carried=True, extra=(zero, zero),
        score_rate=jnp.float32(0.1))
    ref_rows = np.asarray(ref_rows)

    ds = BinnedDataset.from_matrix(X, label=y, max_bin=max_bin)
    cfg = Config(objective="binary", num_leaves=7, max_bin=max_bin,
                 verbosity=-1)
    learner = port_tl.SerialTreeLearner(ds, cfg, device="cpu")
    assert learner.packed == bool(jl.packed_cols)
    rows = port_tl.fill_gradients(learner.template, learner.layout,
                                  torch.from_numpy(grad),
                                  torch.from_numpy(hess)).numpy()
    W = learner.layout.W
    assert rows.shape == (n + port_tl.CHUNK, W)
    assert ref_rows.shape == (n, W)
    np.testing.assert_array_equal(rows[:n], ref_rows)
    # the spare CHUNK block (tree_learner.py:397-402): zero bins and values,
    # unique order ids n .. n + CHUNK - 1
    voff = learner.layout.voff
    spare = np.zeros((port_tl.CHUNK, W), np.uint8)
    spare[:, voff + 8:voff + 12] = np.arange(
        n, n + port_tl.CHUNK, dtype="<i4").view(np.uint8).reshape(-1, 4)
    np.testing.assert_array_equal(rows[n:], spare)


def test_bundled_dataset_is_refused():
    rng = np.random.RandomState(3)
    n = 2000
    X = np.zeros((n, 6), np.float32)
    for j in range(6):          # mutually exclusive sparse columns bundle
        rows = np.arange(j, n, 6)
        X[rows, j] = rng.uniform(1, 2, size=rows.size)
    y = (rng.uniform(size=n) < 0.5).astype(float)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    assert ds.is_bundled
    # bundled datasets train on their group columns now (the refusal went
    # with the port of EFB); the learner's store holds one column a group
    cfg = Config(objective="binary", num_leaves=7, verbosity=-1)
    learner = port_tl.SerialTreeLearner(ds, cfg, device="cpu")
    assert learner.grouped
    assert learner.num_columns == len(ds.feature_groups) < ds.num_features
