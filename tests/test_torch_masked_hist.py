"""The port's masked bins/values histogram against the JAX package.

``histogram_masked`` / ``build_histogram`` (the port's plain versions, on the
CPU) against ``histogram_pallas_masked`` / ``histogram_pallas`` (Pallas
interpret mode) and ``histogram_xla_masked`` / ``histogram_xla``, on the
shapes of ``tests/test_histogram.py`` (2048 rows x 4 features, 128 bins) and
``tests/test_packed_bins.py`` (2048 rows x 6 nibble-packed features, window
[100, 1600)).  Tolerances: the JAX kernel's default bf16 hi/lo split of the
values is good to about 2**-16 relative (histogram.py:11-15), so
``2**-15 * max|bin sum|``; with ``exact=True`` and against the XLA path both
sum in f32 and the port in f64 rounded once, so the f32 bound
``rows * 2**-24 * max|value|``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.histogram import (histogram_pallas,
                                         histogram_pallas_masked,
                                         histogram_xla, histogram_xla_masked,
                                         pack_nibbles)
from lightgbm_tpu_torch.core import histogram as H


def make(n=2048, f=4, b=128, seed=0, hi=None):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, hi or b, size=(n, f)).astype(np.uint8)
    vals = np.stack([rng.normal(size=n),
                     rng.uniform(0.1, 1.0, size=n)]).astype(np.float32)
    return bins, vals


def f32_bound(rows, vals):
    return rows * 2.0 ** -24 * float(np.abs(vals).max()) * 4


@pytest.mark.parametrize("exact", [False, True])
def test_build_histogram_matches_jax_kernel_and_xla(exact):
    bins, vals = make(seed=3 if exact else 0)
    got = H.build_histogram(bins, vals, 128, device="cpu").numpy()
    ref = np.asarray(histogram_pallas(jnp.asarray(bins), jnp.asarray(vals),
                                      128, row_tile=1024, interpret=True,
                                      exact=exact))
    xla = np.asarray(histogram_xla(jnp.asarray(bins), jnp.asarray(vals), 128))
    assert got.shape == (4, 2, 128)
    atol = (f32_bound(len(bins), vals) if exact
            else 2.0 ** -15 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=f32_bound(len(bins), vals))


@pytest.mark.parametrize("exact", [False, True])
def test_masked_window_matches_jax_kernel_and_xla(exact):
    bins, vals = make(n=2048, f=5, b=64, seed=1)
    start, count = 333, 1500
    got = H.histogram_masked(torch.from_numpy(bins), torch.from_numpy(vals),
                             64, start, count).numpy()
    jb, jv = jnp.asarray(bins), jnp.asarray(vals)
    ref = np.asarray(histogram_pallas_masked(
        jb, jv, 64, jnp.int32(start), jnp.int32(count), row_tile=1024,
        interpret=True, exact=exact))
    xla = np.asarray(histogram_xla_masked(jb, jv, 64, jnp.int32(start),
                                          jnp.int32(count)))
    atol = (f32_bound(count, vals) if exact
            else 2.0 ** -15 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    np.testing.assert_allclose(got, xla, rtol=0, atol=f32_bound(count, vals))


def test_nibble_packed_matches_jax_kernel_and_xla():
    bins, _ = make(n=2048, f=6, b=128, seed=1, hi=15)
    vals = np.random.RandomState(1).normal(size=(2, 2048)).astype(np.float32)
    packed = pack_nibbles(bins)
    got = H.histogram_masked(torch.from_numpy(packed), torch.from_numpy(vals),
                             128, 100, 1500, num_cols=6).numpy()
    ref = np.asarray(histogram_pallas_masked(
        jnp.asarray(packed), jnp.asarray(vals), 128, jnp.int32(100),
        jnp.int32(1500), num_cols=6, interpret=True, exact=True))
    xla = np.asarray(histogram_xla_masked(jnp.asarray(bins), jnp.asarray(vals),
                                          128, jnp.int32(100),
                                          jnp.int32(1500)))
    assert got.shape == (6, 2, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=f32_bound(1500, vals))
    np.testing.assert_allclose(got, xla, rtol=0, atol=f32_bound(1500, vals))


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_wider_bin_types_match_xla(dtype):
    bins, vals = make(n=3000, f=3, b=512, seed=4)
    bins = np.random.RandomState(4).randint(0, 512, (3000, 3)).astype(dtype)
    got = H.histogram_masked(torch.from_numpy(bins), torch.from_numpy(vals),
                             512, 10, 2900).numpy()
    xla = np.asarray(histogram_xla_masked(jnp.asarray(bins), jnp.asarray(vals),
                                          512, jnp.int32(10),
                                          jnp.int32(2900)))
    np.testing.assert_allclose(got, xla, rtol=0, atol=f32_bound(2900, vals))


def test_shape_rules_are_the_jax_entrys():
    bins, vals = make()
    b, v = torch.from_numpy(bins), torch.from_numpy(vals)
    with pytest.raises(ValueError, match="divide or be a multiple of 128"):
        H.histogram_masked(b, v, 96, 0, 10)
    with pytest.raises(ValueError, match="outside"):
        H.histogram_masked(b, v, 128, 2000, 100)
    with pytest.raises(ValueError, match="values must be"):
        H.histogram_masked(b, v[:, :10], 128, 0, 10)
    assert H.histogram_masked(b, v, 128, 5, 0).abs().max() == 0
