"""SHAP contributions of the port (``predict_contrib``) against the JAX
package, on the CPU.

A binary model trained by the JAX package (6 features of f32 data, 5% NaN,
15 leaves, 5 rounds) is carried into the port by its model string.  The
port's device TreeSHAP (``core/predict_contrib.py``, run here on CPU
tensors) is held to:

- the JAX package's device program within rtol 1e-12 (its ``contrib_scan``
  under jit; on JAX 0.9 it needs ``jax.experimental.enable_x64``, which the
  test sets to ``jax.enable_x64(True)`` with ``monkeypatch`` and undoes
  after; the compile counter shows the program ran);
- the JAX package's host recursion (``Tree.predict_contrib`` of its trees on
  f32-cast rows) within rtol 1e-12, and the port's own host recursion bit
  for bit (eager f64 torch rounds each op once, as the recursion does);
- every row summing to its f64 raw score within 1e-9;
- the binned path equal to the raw path bit for bit on the training rows;
- multiclass (K blocks of F + 1 columns concatenated), iteration subsets,
  the host recursion below 8 rows, categorical bitsets with unseen,
  negative and NaN categories, and EFB group columns, as
  ``tests/test_predict_contrib.py`` holds the JAX package;
- ``pred_contrib`` with ``precision="bf16"`` refused.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
from lightgbm_tpu.core.predict_contrib import contrib_compile_count
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import BinnedDataset, Config, GBDT, create_objective
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.core.predict import StackedTrees
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

RTOL = 1e-12
# what jax.experimental holds before any test sets the shim
_ENABLE_X64 = getattr(jax.experimental, "enable_x64", None)
N = 1500
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63, verbosity=-1)
DS = {"max_bin": 63}


def make_data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + rng.normal(size=n) > 0.5).astype(float)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    return X, y


def host_contrib(trees, X, ncol, K=1):
    """The host recursion over f32-cast rows, K classes concatenated."""
    Xh = np.asarray(X, dtype=np.float32)
    out = np.zeros((K, len(X), ncol))
    for i, t in enumerate(trees):
        out[i % K] += t.predict_contrib(Xh, ncol)
    return out[0] if K == 1 else np.concatenate(out, axis=1)


def raw_f64(trees, X):
    """The f64 raw score of f32-cast rows (the port's f64 walk)."""
    st = StackedTrees(trees, "cpu")
    return st.predict(np.asarray(X, np.float32), torch.float64)


@pytest.fixture(scope="module")
def binary():
    X, y = make_data()
    ref = J.train(dict(PARAMS), J.Dataset(X, y, params=DS),
                  num_boost_round=5, verbose_eval=False)
    port = booster_from_model_string(ref.model_to_string(), device="cpu")
    Xq = np.random.RandomState(7).normal(size=(300, 6))
    Xq[::11, 2] = np.nan
    return X, y, ref, port, Xq


def test_matches_jax_device_program(binary, monkeypatch):
    _, _, ref, port, Xq = binary
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    before = contrib_compile_count()
    want = ref.predict(Xq, pred_contrib=True)
    assert contrib_compile_count() > before
    got = port.predict(Xq, pred_contrib=True)
    assert got.shape == (300, 7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_shim_is_undone():
    """The shim above lives only inside its test."""
    assert getattr(jax.experimental, "enable_x64", None) is _ENABLE_X64


def test_matches_host_recursions(binary):
    _, _, ref, port, Xq = binary
    got = port.predict(Xq, pred_contrib=True)
    np.testing.assert_allclose(
        got, host_contrib(ref._booster.models, Xq, 7), rtol=RTOL,
        atol=1e-15)
    np.testing.assert_array_equal(
        got, host_contrib(port._booster.models, Xq, 7))


def test_rows_sum_to_raw_score(binary):
    _, _, _, port, Xq = binary
    phi = port.predict(Xq, pred_contrib=True)
    np.testing.assert_allclose(phi.sum(axis=1),
                               raw_f64(port._booster.models, Xq), rtol=0,
                               atol=1e-9)


def test_binned_equals_raw_on_training_rows(binary):
    X, y, _, port, _ = binary
    pds = P.Dataset(X, y, params=DS).construct()
    np.testing.assert_array_equal(
        port._booster.predict_contrib_binned(pds.handle),
        port.predict(X, pred_contrib=True))


@pytest.mark.parametrize("rows", [1, 7, 8, 9])
def test_small_batches(binary, rows):
    """Below 8 rows the host recursion serves (gbdt.py:2128): both give
    the same bits."""
    _, _, _, port, Xq = binary
    got = port.predict(Xq[:rows], pred_contrib=True)
    np.testing.assert_array_equal(
        got, host_contrib(port._booster.models, Xq[:rows], 7))


def test_iteration_subsets(binary):
    _, _, ref, port, Xq = binary
    models = port._booster.models
    for start, num in ((0, 2), (1, 3), (2, -1)):
        end = len(models) if num <= 0 else start + num
        got = port.predict(Xq, pred_contrib=True, start_iteration=start,
                           num_iteration=num)
        np.testing.assert_array_equal(
            got, host_contrib(models[start:end], Xq, 7))


def test_bf16_refused(binary):
    _, _, _, port, Xq = binary
    with pytest.raises(LightGBMError, match="bf16"):
        port.predict(Xq, pred_contrib=True, precision="bf16")


def test_multiclass_concatenation():
    X, _ = make_data(seed=3)
    y = np.digitize(np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]),
                    [-0.5, 0.5]).astype(float)
    params = dict(PARAMS, objective="multiclass", num_class=3)
    ref = J.train(params, J.Dataset(X, y, params=DS), num_boost_round=3,
                  verbose_eval=False)
    port = booster_from_model_string(ref.model_to_string(), params=params,
                                     device="cpu")
    Xq = X[:200]
    got = port.predict(Xq, pred_contrib=True)
    assert got.shape == (200, 3 * 7)
    np.testing.assert_allclose(
        got, host_contrib(ref._booster.models, Xq, 7, K=3), rtol=RTOL,
        atol=1e-15)
    raw = port.predict(Xq, raw_score=True)
    for k in range(3):
        np.testing.assert_allclose(got[:, k * 7:(k + 1) * 7].sum(axis=1),
                                   raw[:, k], rtol=0, atol=1e-5)


def train_gbdt(X, y, cfg, cats=()):
    ds = BinnedDataset.from_matrix(X, label=y, categorical_feature=list(cats),
                                   max_bin=int(cfg.max_bin))
    b = GBDT(cfg, ds, create_objective(cfg.objective, cfg, "cpu"),
             device="cpu")
    for _ in range(int(cfg.num_iterations)):
        b.train_one_iter()
    return b, ds


def test_categorical_and_unseen_routing():
    """Category bitsets, unseen, negative and NaN categories route as the
    host recursion routes them."""
    rng = np.random.RandomState(0)
    n, n_cats = 800, 40
    cat = rng.randint(0, n_cats, size=n)
    y = np.isin(cat, [0, 3, 7, 33]) * 3.0 + rng.normal(scale=0.2, size=n)
    X = np.column_stack([cat, rng.normal(size=n)]).astype(np.float32)
    cfg = Config(objective="regression", num_leaves=7, min_data_per_group=10,
                 cat_smooth=1.0, max_cat_to_onehot=4, num_iterations=8,
                 verbosity=-1)
    b, _ = train_gbdt(X, y, cfg, cats=[0])
    assert any(t.num_cat > 0 for t in b.models), "no categorical split"
    Xq = np.concatenate([X, [[99.0, 0.0], [np.nan, 0.0], [-3.0, 0.0],
                             [3.7, 0.5]]])
    got = b.predict_contrib(Xq)
    np.testing.assert_array_equal(got, host_contrib(b.models, Xq, 3))
    np.testing.assert_allclose(got.sum(axis=1), raw_f64(b.models, Xq),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(b.predict_contrib(X),
                                  b.predict_contrib_binned())


def test_efb_unfold_binned_path():
    """Mutually exclusive features bundled by EFB: the binned path unfolds
    the group codes as the raw path routes the values."""
    rng = np.random.RandomState(5)
    n, f = 700, 12
    X = np.zeros((n, f), np.float32)
    owner = rng.randint(0, f, size=n)
    X[np.arange(n), owner] = rng.uniform(1, 5, size=n)
    y = (owner % 3 == 0) * 2.0 + rng.normal(scale=0.1, size=n)
    cfg = Config(objective="regression", num_leaves=7, num_iterations=6,
                 max_bin=31, min_data_in_leaf=5, verbosity=-1)
    b, ds = train_gbdt(X, y, cfg)
    assert ds.binned.shape[1] < f, "EFB did not bundle the features"
    got = b.predict_contrib_binned()
    np.testing.assert_array_equal(got, b.predict_contrib(X))
    np.testing.assert_array_equal(got, host_contrib(b.models, X, f + 1))
