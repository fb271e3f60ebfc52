"""The port's level growth against the JAX package's own level path (exact).

The JAX learner grows level-wise only through its fused Pallas split pass
(``effective_grow_mode``); off the TPU that pass runs in Pallas interpret
mode, pinned on the learner as ``tests/test_partition_buckets.py``
(``_pin_interpret``) pins it.  Interpret mode needs ``pl.load``/``pl.store``,
which JAX 0.9 removed, so the test sets a two-attribute shim with
``monkeypatch`` (undone after the test, so it never reaches the JAX
package's own tests) and leaves the package itself untouched.

Exact mode also sets ``LIGHTGBM_TPU_EXACT_HIST=1`` (``monkeypatch.setenv``)
so that the interpret kernels sum in f32 rather than through the bf16 hi/lo
split (~2**-16 relative, histogram.py:51-56).  4096 rows x 8 features,
max_bin=63, num_leaves=15, 2 iterations: the trees must be equal (split
features, threshold bins, child pointers, leaf counts, depths and parents),
leaf values within ``tests/test_torch_train.py``'s tolerance, and the train
scores within the sum over the trees of their largest leaf tolerance.  The
JAX side takes about 40 s (interpret-mode compiles), so quantized mode is in
its own file, ``test_torch_level_oracle_quant.py``, and xdist spreads the
two.
"""
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import GBDT, Config, create_objective
from lightgbm_tpu_torch.convert import dataset_from_arrays
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

torch.set_num_threads(2)

N, NF, ITERS = 4096, 8, 2
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, verbosity=-1, tree_grow_mode="level")


def _store(ref, idx, val):
    ref[idx] = val


def run_both(monkeypatch, precision):
    """Train the JAX level path (interpret mode) and the port on the same
    binned data; returns (ref, port)."""
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    if precision == "exact":
        monkeypatch.setenv("LIGHTGBM_TPU_EXACT_HIST", "1")
    rng = np.random.RandomState(0)
    X = rng.normal(size=(N, NF)).astype(np.float32)
    y = ((X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
          + rng.normal(scale=0.5, size=N)) > 0).astype(np.float64)
    params = dict(PARAMS, hist_precision=precision)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref_cfg = JaxConfig(**params)
    ref = JaxGBDT(ref_cfg, ref_ds, jax_objective("binary", ref_cfg))
    ref.learner.use_pallas = True
    ref.learner.pallas_interpret = True
    assert ref.learner.effective_grow_mode() == "level"
    for _ in range(ITERS):
        ref.train_one_iter()
    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y,
        mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    cfg = Config(**params)
    port = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                device="cpu")
    for _ in range(ITERS):
        port.train_one_iter()
        assert port.last_arrays.levels == port.learner.level_count() == 4
    return ref, port


def check_against_reference(ref, port):
    assert len(ref.models) == len(port.models) == ITERS
    score_tol = 0.0
    for i, (a, b) in enumerate(zip(ref.models, port.models)):
        nl = a.num_leaves
        assert b.num_leaves == nl == PARAMS["num_leaves"]
        for name in ("split_feature_inner", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        for name in ("leaf_count", "leaf_depth", "leaf_parent"):
            np.testing.assert_array_equal(getattr(b, name)[:nl],
                                          getattr(a, name)[:nl],
                                          err_msg="tree %d %s" % (i, name))
        tol = leaf_value_tolerance(a, N)
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]), tol)
        score_tol += tol.max()
    # a row's score is the sum of one leaf value per tree, in f32
    want = np.asarray(ref.train_score)[0, :N]
    got = port.train_score[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=score_tol + 1e-6)


def test_level_growth_matches_jax_level_path_exact(monkeypatch, one_thread):
    check_against_reference(*run_both(monkeypatch, "exact"))


@pytest.fixture(autouse=True)
def _shim_is_undone():
    """After each test the shim is gone again (it must not leak into the JAX
    package's own tests, which run in the same worker)."""
    had = (hasattr(pl, "load"), hasattr(pl, "store"))
    yield
    assert (hasattr(pl, "load"), hasattr(pl, "store")) == had
