"""The port's count-balanced bin search (``io/binning.greedy_find_bin``,
its cuts found by binary searches over integer sums) against the JAX
package's (a linear scan a cut), on the CPU: the same bounds, bit for bit,
over value ranges with unit counts, small and skewed counts, rare big
values that take a bin of their own, big values at both ends, and a sample
count above the counts' sum; at 2, 15, 63 and 255 bins and
``min_data_in_bin`` 0, 1, 3 and 50.
"""
import numpy as np
import pytest

from lightgbm_tpu.io.binning import greedy_find_bin as jax_greedy
from lightgbm_tpu_torch.io.binning import BinMapper, greedy_find_bin

KINDS = ("unit", "small", "geometric", "rare_big", "zipf", "big_ends")


def counts_of(kind: str, n: int, rng) -> np.ndarray:
    if kind == "unit":
        return np.ones(n, np.int64)
    if kind == "small":
        return rng.randint(1, 5, size=n)
    if kind == "geometric":
        return rng.geometric(0.01, size=n)
    if kind == "rare_big":
        c = np.ones(n, np.int64)
        k = max(1, n // 50)
        c[rng.randint(0, n, size=k)] = rng.randint(100, 100_000, size=k)
        return c
    if kind == "zipf":
        return rng.zipf(1.5, size=n).clip(max=10 ** 6)
    c = rng.randint(1, 3, size=n)
    c[0] = c[-1] = 10 ** 5
    return c


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [3, 50, 1000, 30_000])
def test_bounds_equal_jax(kind, n):
    rng = np.random.RandomState(KINDS.index(kind) * 100_003 + n)
    for trial in range(4):
        vals = np.unique(rng.normal(size=n) * (1, 1000, 1e-3, 1)[trial])
        counts = counts_of(kind, len(vals), rng)
        total = int(counts.sum()) + (0, 17)[trial % 2]
        for max_bin in (2, 15, 63, 255):
            for min_data_in_bin in (0, 1, 3, 50):
                want = jax_greedy(vals, counts, max_bin, total,
                                  min_data_in_bin)
                got = greedy_find_bin(vals, counts, max_bin, total,
                                      min_data_in_bin)
                assert np.array_equal(np.asarray(got), np.asarray(want)), (
                    trial, max_bin, min_data_in_bin)


def test_bin_mapper_on_a_normal_sample_equals_jax():
    from lightgbm_tpu.io.binning import BinMapper as JaxBinMapper
    x = np.random.RandomState(0).normal(size=25_000)
    got, want = BinMapper(), JaxBinMapper()
    for m in (got, want):
        m.find_bin(x, len(x), 255, 3, 0, False, False, False)
    assert np.array_equal(np.asarray(got.bin_upper_bound),
                          np.asarray(want.bin_upper_bound))
    assert got.num_bin == want.num_bin == 255
