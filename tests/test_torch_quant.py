"""Quantized-gradient training in the port against the JAX package, on the CPU.

- ``quant_uniforms`` and ``quantize_gradients`` are bit-equal to the JAX
  functions (the hash runs in int64 masked to 32 bits; the f32 operations are
  the JAX ones in the same order), over several seeds and iterations, with
  zero, negative and maximal gradients;
- ``dequantize_hist`` is bit-equal to the JAX one;
- the quantized row-store histogram equals JAX ``histogram_rows(use_pallas=
  False, quantized=True)`` exactly: both are integer sums, exact in f32 at
  these sizes;
- the quantized split pass equals ``partition_hist_xla`` (rows, left count)
  plus the JAX quantized histogram of the child's window, exactly;
- quantized leaf-wise training: 4096 x 8, max_bin=63, num_leaves=15, 3
  iterations, through ``convert.dataset_from_arrays``: split features,
  threshold bins and leaf counts equal, leaf values and train scores within
  the tolerances of ``tests/test_torch_train.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core import histogram as jax_hist
from lightgbm_tpu.core import partition as jax_part
from lightgbm_tpu.core import quant as jax_quant
from lightgbm_tpu.core.split import dequantize_hist as jax_dequantize
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.objective import create_objective as jax_objective
from lightgbm_tpu_torch import GBDT, Config, create_objective
from lightgbm_tpu_torch.convert import dataset_from_arrays
from lightgbm_tpu_torch.core import histogram as port_hist
from lightgbm_tpu_torch.core import partition as port_part
from lightgbm_tpu_torch.core import quant as port_quant
from lightgbm_tpu_torch.core.split import dequantize_hist
from test_torch_partition import make_rows, routes
from test_torch_train import leaf_value_tolerance

torch.set_num_threads(2)

SEEDS_ITS = [(0, 0), (0, 1), (7, 3), (123456789, 99), (2 ** 31 - 1, 2 ** 20)]


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("seed,it", SEEDS_ITS)
def test_quant_uniforms_bit_equal(seed, it):
    ids = np.arange(50000, dtype=np.int32)
    want = jax_quant.quant_uniforms(jnp.asarray(ids), seed, it)
    got = port_quant.quant_uniforms(torch.from_numpy(ids), seed, it)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert float(got.max()) < 1.0


@pytest.mark.parametrize("seed,it", SEEDS_ITS)
def test_quantize_gradients_bit_equal(seed, it):
    rng = np.random.RandomState(seed % 1000 + it % 1000)
    n = 20000
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.0, 0.25, size=n).astype(np.float32)
    g[:100] = 0.0                      # exact zeros stay zero
    h[50:150] = 0.0
    g[200] = -np.abs(g).max() * 1.5    # the maximal gradient is negative
    g[201] = -g[200]
    ids = np.arange(n, dtype=np.int32)
    want = jax_quant.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                                        jnp.asarray(ids), it, seed)
    got = port_quant.quantize_gradients(torch.from_numpy(g),
                                        torch.from_numpy(h),
                                        torch.from_numpy(ids), it, seed)
    for w, p in zip(want, got):
        np.testing.assert_array_equal(bits(p.numpy()), bits(w))
    q_g, q_h, _ = got
    assert float(q_g.abs().max()) == port_quant.GRAD_LEVELS
    assert float(q_h.min()) >= 0 and float(q_h.max()) <= port_quant.HESS_LEVELS
    assert not q_g[:100].any() and not q_h[50:150].any()


def test_dequantize_hist_bit_equal():
    rng = np.random.RandomState(0)
    hist = rng.randint(-5000, 5000, size=(3, 6, 2, 32)).astype(np.float32)
    qscale = np.asarray([0.0123, 0.000456], np.float32)
    want = jax_dequantize(jnp.asarray(hist), jnp.asarray(qscale))
    got = dequantize_hist(torch.from_numpy(hist), torch.from_numpy(qscale))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def quantized_rows(n, f, b, seed, **kw):
    """make_rows with integer-valued g/h in the quantized ranges."""
    rows, voff = make_rows(n, f, b, seed=seed, **kw)
    rng = np.random.RandomState(seed + 100)
    gh = np.stack([rng.randint(-127, 128, size=n),
                   rng.randint(0, 256, size=n)], 1).astype("<f4")
    rows[:, voff:voff + 8] = gh.view(np.uint8)
    return rows, voff


LAYOUTS = {"b64": (64, {}), "b256": (256, {}), "bpc2": (512, dict(bpc=2)),
           "packed": (32, dict(packed=True))}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_histogram_rows_quantized_equals_jax(layout):
    b, kw = LAYOUTS[layout]
    n, f = 3000, 5
    rows, voff = quantized_rows(n, f, b, seed=3, **kw)
    for start, count in [(0, n), (17, 1234), (2999, 1), (5, 0)]:
        want = jax_hist.histogram_rows(
            jnp.asarray(rows), b, start, count, num_features=f, voff=voff,
            use_pallas=False, quantized=True, **kw)
        got = port_hist.histogram_rows(
            torch.from_numpy(rows), b, start, count, num_features=f,
            voff=voff, quantized=True, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["numerical", "nan_left", "categorical"])
def test_partition_hist_quantized_equals_xla(route):
    b, n, f = 64, 2500, 6
    rows, voff = quantized_rows(n, f, b, seed=4)
    (r, words) = routes(b)[route]
    gcol, thr, dleft, mt, nb, dbin, is_cat, unf, eoff = r
    for hist_left in (0, 1):
        for wb, wc in [(0, 0), (100, 900), (7, 1500), (0, n)]:
            scal = [wb, wc, gcol, thr, dleft, mt, nb, dbin, is_cat,
                    hist_left, unf, eoff] + words
            want_rows, _, want_nl = jax_part.partition_hist_xla(
                jnp.asarray(rows), jnp.asarray(scal, jnp.int32),
                num_features=f, num_bins=b, voff=voff)
            nl = int(want_nl)
            start, count = (wb, nl) if hist_left else (wb + nl, wc - nl)
            want_hist = jax_hist.histogram_rows(
                want_rows, b, start, count, num_features=f, voff=voff,
                use_pallas=False, quantized=True)
            got_rows, got_hist, got_nl = port_part.partition_hist(
                torch.from_numpy(rows.copy()), scal, num_features=f,
                num_bins=b, voff=voff, quantized=True)
            np.testing.assert_array_equal(got_rows.numpy(),
                                          np.asarray(want_rows))
            assert int(got_nl[0]) == nl
            np.testing.assert_array_equal(got_hist.numpy(),
                                          np.asarray(want_hist))


PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, verbosity=-1, hist_precision="quantized")
ITERS = 3


@pytest.fixture(scope="module")
def one_thread():
    """Train the port with one intra-op thread.  torch's CPU ``exp`` splits
    its work into 2048-element chunks over the threads it gets, and the
    chunking can change the last bit of a gradient (seen when a worker
    process makes its first parallel call); under quantization one bit can
    move a row's stochastically rounded gradient by a whole level."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(one_thread):
    rng = np.random.RandomState(0)
    n, f = 4096, 8
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
          + rng.normal(scale=0.5, size=n)) > 0).astype(np.float64)
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
    return X, ref, port


def test_quantized_training_trees_equal(trained):
    X, ref, port = trained
    assert len(ref.models) == len(port.models) == ITERS
    for a, b in zip(ref.models, port.models):
        nl = a.num_leaves
        assert b.num_leaves == nl > 2
        for name in ("split_feature_inner", "threshold_in_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg=name)
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, X.shape[0]))


def test_quantized_training_scores_close(trained):
    X, ref, port = trained
    want = np.asarray(ref.train_score)[0, :X.shape[0]]
    np.testing.assert_allclose(port.train_score[0].numpy(), want, rtol=0,
                               atol=1e-5)


def test_quantized_training_differs_from_exact(trained):
    """The quantized path really ran: exact training grows other trees."""
    X, _, port = trained
    cfg = Config(**dict(PARAMS, hist_precision="exact"))
    exact = GBDT(cfg, port.train_data,
                 create_objective("binary", cfg, device="cpu"), device="cpu")
    exact.train_one_iter()
    assert not np.array_equal(exact.models[0].leaf_value,
                              port.models[0].leaf_value)
