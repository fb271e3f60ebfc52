"""The port's row-store histogram against the JAX package's.

``lightgbm_tpu_torch.core.histogram.histogram_rows`` on CPU tensors (its plain
PyTorch version) is held against ``lightgbm_tpu.core.histogram.histogram_rows``
with ``use_pallas=False`` (the reference's XLA path) on the same row store made
from a seed with numpy.  Tolerance: 1e-6 of max|bin sum|, because the two sum
in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import histogram as jax_hist
from lightgbm_tpu_torch import device as port_device
from lightgbm_tpu_torch.core import histogram as port_hist

torch.set_num_threads(2)

RTOL = 1e-6


def make_rows(n, f, b, *, bpc=1, packed=False, seed=0):
    """[n, W] u8 row store: bins, f32 grad/hess at voff, s32 order."""
    rng = np.random.RandomState(seed)
    hi = min(b, 16) if packed else b
    bins = rng.randint(0, hi, size=(n, f))
    if packed:
        bin_bytes = jax_hist.pack_nibbles(bins)
    elif bpc == 2:
        bin_bytes = bins.astype("<u2").view(np.uint8).reshape(n, 2 * f)
    else:
        bin_bytes = bins.astype(np.uint8)
    voff = -(-bin_bytes.shape[1] // 4) * 4
    W = -(-(voff + 12) // 128) * 128
    rows = np.zeros((n, W), np.uint8)
    rows[:, :bin_bytes.shape[1]] = bin_bytes
    gh = np.stack([rng.normal(size=n), rng.uniform(0.1, 1.0, size=n)],
                  axis=1).astype("<f4")
    rows[:, voff:voff + 8] = gh.view(np.uint8)
    rows[:, voff + 8:voff + 12] = np.arange(n, dtype="<i4").view(
        np.uint8).reshape(n, 4)
    return rows, voff


def assert_hist_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= RTOL * scale


CASES = [
    # (name, F, B, bpc, packed, f_begin, num_features)
    ("u8", 6, 64, 1, False, 0, 6),
    ("u8_b256", 5, 256, 1, False, 0, 5),
    ("u16", 4, 512, 2, False, 0, 4),
    ("packed", 7, 32, 1, True, 0, 7),
    ("f_begin_u8", 8, 64, 1, False, 3, 4),
    ("f_begin_u16", 6, 512, 2, False, 2, 3),
]
WINDOWS = [(0, 3000), (0, 0), (17, 1000), (2999, 1), (1001, 1999)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_histogram_rows_matches_jax(case):
    name, f, b, bpc, packed, f_begin, nf = case
    rows, voff = make_rows(3000, f, b, bpc=bpc, packed=packed, seed=len(name))
    kw = dict(num_features=nf, voff=voff, bpc=bpc, packed=packed,
              f_begin=f_begin)
    rows_t = torch.from_numpy(rows)
    for start, count in WINDOWS:
        want = jax_hist.histogram_rows(jnp.asarray(rows), b, start, count,
                                       use_pallas=False, **kw)
        got = port_hist.histogram_rows(rows_t, b, start, count, **kw)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert_hist_close(got.numpy(), want)


def test_empty_window_is_zero():
    rows, voff = make_rows(256, 4, 32)
    got = port_hist.histogram_rows(torch.from_numpy(rows), 32, 100, 0,
                                   num_features=4, voff=voff)
    assert got.shape == (4, 2, 32)
    assert not got.any()


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rows, voff = make_rows(512, 4, 32, seed=3)
    rows_t = torch.from_numpy(rows)
    port_device.reset_launches()
    got = port_hist.histogram_rows(rows_t, 32, 5, 300, num_features=4,
                                   voff=voff)
    plain = port_hist.histogram_rows_plain(rows_t, 32, 5, 300,
                                           num_features=4, voff=voff)
    assert torch.equal(got, plain)
    assert port_device.launches()["histogram"] == 0


def test_rows_split_matches_jax():
    rows, voff = make_rows(700, 5, 512, bpc=2, seed=4)
    jb, jv = jax_hist.rows_split_xla(jnp.asarray(rows), 5, voff, bpc=2)
    pb, pv = port_hist.rows_split(torch.from_numpy(rows), 5, voff, bpc=2)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
