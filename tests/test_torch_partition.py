"""The port's fused split pass against the JAX package's reference contract.

``lightgbm_tpu_torch.core.partition.partition_hist`` on CPU tensors (its plain
PyTorch version) is held against ``lightgbm_tpu.core.partition.
partition_hist_xla`` (mask + cumsum + scatter, with ``histogram_xla_masked``
for the child) over the route matrix of the chip smoke test: numerical, NaN
missing with default left and right, zero missing, categorical bitset and EFB
unfold, on windows from empty to the whole store.  ``rows_new`` and ``nl``
must be equal; the histogram within 1e-6 of max|bin sum| (summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import histogram as jax_hist
from lightgbm_tpu.core import partition as jax_part
from lightgbm_tpu_torch.core import partition as port_part

torch.set_num_threads(2)

RTOL = 1e-6
N = 2500


def make_rows(n, f, b, *, bpc=1, packed=False, seed=0):
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


def routes(b, seed=0):
    """(group_col, threshold, default_left, missing_type, num_bin,
    default_bin, is_cat, use_unfold, efb_offset), bitset words."""
    rng = np.random.RandomState(seed)
    words = [int(w) for w in rng.randint(-2 ** 31, 2 ** 31, size=b // 32)]
    zero = [0] * (b // 32)
    return {
        "numerical": ((1, b // 2, 0, 0, b, 0, 0, 0, 0), zero),
        "nan_left": ((2, b // 3, 1, 1, b, 0, 0, 0, 0), zero),
        "nan_right": ((2, b // 3, 0, 1, b, 0, 0, 0, 0), zero),
        "zero_missing": ((3, b // 2, 1, 2, b, 5, 0, 0, 0), zero),
        "categorical": ((0, 0, 0, 0, b, 0, 1, 0, 0), words),
        "efb_unfold": ((4, 6, 0, 0, 12, 0, 0, 1, 9), zero),
    }


WINDOWS = [(0, 0), (100, 900), (7, 1500), (0, N), (2499, 1)]


def run_both(rows, scal, **kw):
    want_rows, want_hist, want_nl = jax_part.partition_hist_xla(
        jnp.asarray(rows), jnp.asarray(scal, jnp.int32), **kw)
    rows_t = torch.from_numpy(rows.copy())
    got_rows, got_hist, got_nl = port_part.partition_hist(rows_t, scal, **kw)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert int(got_nl[0]) == int(want_nl)
    want_hist = np.asarray(want_hist, np.float64)
    assert got_hist.shape == want_hist.shape
    scale = max(np.abs(want_hist).max(), 1e-30)
    assert np.abs(got_hist.numpy() - want_hist).max() <= RTOL * scale
    # the plain version returns a new store and leaves its input alone
    np.testing.assert_array_equal(rows_t.numpy(), rows)
    return int(got_nl[0])


@pytest.mark.parametrize("route", list(routes(64)))
@pytest.mark.parametrize("hist_left", [0, 1])
def test_partition_hist_matches_xla(route, hist_left):
    b = 64
    rows, voff = make_rows(N, 6, b, seed=1)
    (r, words) = routes(b)[route]
    gcol, thr, dleft, mt, nb, dbin, is_cat, unf, eoff = r
    for wb, wc in WINDOWS:
        scal = [wb, wc, gcol, thr, dleft, mt, nb, dbin, is_cat, hist_left,
                unf, eoff] + words
        nl = run_both(rows, scal, num_features=6, num_bins=b, voff=voff)
        assert 0 <= nl <= wc


@pytest.mark.parametrize("layout", ["bpc2", "packed", "b256"])
def test_partition_hist_layouts_match_xla(layout):
    if layout == "bpc2":
        b, kw = 512, dict(bpc=2)
    elif layout == "packed":
        b, kw = 32, dict(packed=True)
    else:
        b, kw = 256, {}
    rows, voff = make_rows(N, 5, b, seed=2, **kw)
    nb = 16 if layout == "packed" else b
    for wb, wc in WINDOWS:
        scal = [wb, wc, 3, nb // 3, 1, 1, nb, 0, 0, 1, 0, 0] + [0] * (b // 32)
        run_both(rows, scal, num_features=5, num_bins=b, voff=voff, **kw)


def test_scal_length_is_checked():
    rows, voff = make_rows(64, 4, 64)
    with pytest.raises(ValueError):
        port_part.partition_hist(torch.from_numpy(rows), [0, 10, 0, 3],
                                 num_features=4, num_bins=64, voff=voff)
