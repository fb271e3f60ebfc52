"""The plain reference on data small enough to work by hand."""
import math

import numpy as np
import pytest
import torch

from reference import gbdt as R
from reference import judge as J

X8 = np.arange(1, 9, dtype=np.float32)[:, None]      # 1 .. 8
Y8 = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=np.float64)


def _up(x):
    return math.nextafter(x, math.inf)


def test_bounds_by_hand():
    # 8 distinct positive values, at least 3 to a bin: cuts after 3 and 6,
    # each bound the midpoint nudged one ULP up, and the empty zero bin
    b = R.feature_bounds(X8[:, 0].astype(np.float64), 255)
    assert list(b) == [R.K_ZERO, _up(3.5), _up(6.5), math.inf]
    bins = R.bin_matrix(torch.from_numpy(X8), [b])
    assert bins[:, 0].tolist() == [1, 1, 1, 2, 2, 2, 3, 3]


def test_negative_values_and_zero_bin():
    v = np.array([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0])
    vals, cnts = R.distinct_counts(v, 0)
    assert list(vals) == [-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0]
    assert list(cnts) == [1, 1, 1, 0, 1, 1, 1]
    b = R.feature_bounds(v, 255, min_data_in_bin=1)
    assert list(b) == [_up(-2.5), _up(-1.5), -R.K_ZERO, R.K_ZERO, _up(1.5),
                       _up(2.5), math.inf]


def test_greedy_bounds_balance_counts():
    vals = np.arange(1000, dtype=np.float64)
    b = R.greedy_bounds(vals, np.ones(1000, dtype=np.int64), 10, 1000, 3)
    assert len(b) == 10
    edges = np.searchsorted(np.array(b), vals)
    assert set(np.bincount(edges)) == {100}


def test_sample_is_bottom_keys():
    idx = R.sample_indices(1000, 10, 1)
    keys = R.splitmix64(np.arange(1000, dtype=np.uint64)
                        ^ R.splitmix64(np.array([1], dtype=np.uint64))[0])
    assert list(idx) == sorted(np.argsort(keys)[:10])
    assert list(R.sample_indices(5, 10, 1)) == [0, 1, 2, 3, 4]


def test_quant_uniforms_by_hand():
    m = 0xFFFFFFFF

    def one(r, seed, it):
        x = (r & m) ^ ((seed * 2654435761) & m) ^ 0x7FB5D591
        x = (x + ((it * 0x9E3779B9) & m)) & m
        x ^= x >> 16
        x = (x * 2246822519) & m
        x ^= x >> 13
        x = (x * 3266489917) & m
        x ^= x >> 16
        return (x >> 8) * 2.0 ** -24
    got = R.quant_uniforms(5, 3, 2)
    assert list(got) == [np.float32(one(r, 3, 2)) for r in range(5)]


def test_one_split_by_hand():
    # at p = 1/2 the start is 0, g = +-1/2, h = 1/4; the best cut leaves
    # rows 1-3 (G 1.5, H .75) left and 4-8 (G -1.5, H 1.25) right
    X = torch.from_numpy(X8)
    bounds = [R.feature_bounds(X8[:, 0].astype(np.float64), 255)]
    p = R.Params(num_leaves=2, min_data_in_leaf=1)
    gr = R.Grower(X, R.bin_matrix(X, bounds), bounds, p)
    assert R.init_score(Y8) == 0.0
    yv = torch.from_numpy(np.where(Y8 > 0, 1.0, -1.0))
    g, h = R.binary_gradients(torch.zeros(8, dtype=torch.float64), yv)
    assert g.tolist() == [0.5] * 4 + [-0.5] * 4
    assert h.tolist() == [0.25] * 8
    t = gr.grow(g, h)
    assert (t.feature, t.thr_bin) == ([0], [1])
    assert t.rows.tolist() == [3, 5]
    np.testing.assert_allclose(t.values(), [-2.0, 1.2])
    # following that tree costs nothing; following the cut after 6 does
    same = R.Tree(np.array([0]), np.array([bounds[0][1]]), np.array([~0]),
                  np.array([~1]), np.zeros(2))
    assert gr.grow(g, h, follow=same).gaps == [0.0]
    other = R.Tree(np.array([0]), np.array([bounds[0][2]]), np.array([~0]),
                   np.array([~1]), np.zeros(2))
    gap = gr.grow(g, h, follow=other).gaps[0]
    assert gap == pytest.approx((4.8 - (1 / 1.5 + 1 / 0.5)) / 4.8, rel=1e-9)


def test_level_growth_rule():
    # level growth stops after ceil(log2 L) levels even with leaves to give
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.normal(size=(4000, 3)).astype(np.float32))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).double()
    bounds = R.find_bounds(X.numpy().astype(np.float64), 63)
    bins = R.bin_matrix(X, bounds)
    g, h = R.binary_gradients(torch.zeros(4000, dtype=torch.float64),
                              torch.where(y > 0, 1.0, -1.0).double())
    for L, nodes in ((4, 3), (6, 5), (9, 8)):
        t = R.Grower(X, bins, bounds, R.Params(num_leaves=L, level=True))
        out = t.grow(g, h)
        assert len(out.feature) == nodes
        depth = R.Tree(np.array(out.feature), np.zeros(nodes),
                       np.array(out.left), np.array(out.right),
                       np.zeros(nodes + 1)).depths()
        assert depth.max() <= math.ceil(math.log2(L))


def test_judge_passes_itself_and_fails_a_wrong_score():
    rng = np.random.RandomState(1)
    X = torch.from_numpy(rng.normal(size=(3000, 4)).astype(np.float32))
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).double().numpy()
    data = J.Data(X=X, y=y, X_test=X[:500],
                  params=R.Params(num_leaves=8), learning_rate=0.1,
                  max_bin=63, sample_cnt=1000, data_random_seed=1,
                  quantized=False, quant_seed=0)
    out = J.train_reference(data, 3, "alter")
    nums = J.judge(data, out)
    assert nums["bins_off"] == 0 and nums["trees_off"] == 0
    assert nums["split_gap"] == 0.0
    assert nums["score_gap"] < 1e-6 and nums["leaf_gap"] > 0.05
    out.train_score = out.train_score + 0.01
    assert J.judge(data, out)["score_gap"] > 1e-3


def _greedy_loop(vals, cnts, max_bin, total_cnt, min_data_in_bin):
    """GreedyFindBin as bin.cpp writes it, one value at a time."""
    n = len(vals)
    if n <= max_bin:
        return R.greedy_bounds(vals, cnts, max_bin, total_cnt,
                               min_data_in_bin)
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean = total_cnt / max_bin
    big = [c >= mean for c in cnts]
    rest_bins = max_bin - sum(big)
    rest_cnt = total_cnt - sum(c for c, b in zip(cnts, big) if b)
    mean = rest_cnt / rest_bins
    upper, lower, cur = [], [vals[0]], 0
    for i in range(n - 1):
        if not big[i]:
            rest_cnt -= cnts[i]
        cur += cnts[i]
        if big[i] or cur >= mean or (big[i + 1]
                                     and cur >= max(1.0, mean * 0.5)):
            upper.append(vals[i])
            lower.append(vals[i + 1])
            if len(upper) >= max_bin - 1:
                break
            cur = 0
            if not big[i]:
                rest_bins -= 1
                mean = rest_cnt / rest_bins
    bounds = []
    for u, lo in zip(upper, lower[1:]):
        val = _up((u + lo) / 2.0)
        if not bounds or val > _up(bounds[-1]):
            bounds.append(val)
    return bounds + [math.inf]


@pytest.mark.parametrize("case", range(12))
def test_greedy_matches_the_per_value_loop(case):
    rng = np.random.RandomState(case)
    n = int(rng.randint(300, 5000))
    vals = np.sort(rng.choice(100000, n, replace=False)).astype(np.float64)
    cnts = (np.ones(n, dtype=np.int64) if case % 2 else
            rng.choice([1, 1, 1, 2, 5, 400], n).astype(np.int64))
    max_bin = int(rng.choice([16, 63, 255]))
    got = R.greedy_bounds(vals, cnts, max_bin, int(cnts.sum()), 3)
    assert got == _greedy_loop(vals, cnts.tolist(), max_bin,
                               int(cnts.sum()), 3)
