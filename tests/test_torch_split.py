"""The port's numerical best-split scan against the JAX package's.

Histograms come from random rows made with numpy (so leaf totals and counts
are consistent), over features with every missing type.  Exact ties are built
in: a duplicated feature (the smaller feature id must win) and empty bins
(equal gains at neighbouring thresholds, where the direction's tie-break must
pick the same threshold as the reference, split.py:24-26).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import split as jax_split
from lightgbm_tpu_torch.core import split as port_split

torch.set_num_threads(2)

B = 64
# (num_bin, missing_type, default_bin): NONE, NAN, ZERO, two-bin NAN
FEATURES = [(40, 0, 0), (64, 1, 0), (30, 2, 4), (2, 1, 0), (50, 0, 3),
            (64, 1, 0), (17, 2, 0)]


def leaf(n, seed):
    """Rows of one leaf -> hist [F, 2, B] f32 and its totals."""
    rng = np.random.RandomState(seed)
    f = len(FEATURES) + 1
    bins = np.zeros((n, f), np.int64)
    for j, (nb, _, _) in enumerate(FEATURES):
        bins[:, j] = rng.randint(0, nb, size=n)
    bins[:, 4] = 2 * rng.randint(0, 25, size=n)        # empty odd bins
    bins[:, f - 1] = bins[:, 1]                       # exact duplicate of f1
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    hist = np.zeros((f, 2, B), np.float64)
    for j in range(f):
        np.add.at(hist[j, 0], bins[:, j], grad)
        np.add.at(hist[j, 1], bins[:, j], hess)
    return (hist.astype(np.float32), np.float32(grad.sum()),
            np.float32(hess.sum()), np.float32(n))


def feature_info():
    meta = FEATURES + [FEATURES[1]]
    nb, mt, db = (np.array([m[i] for m in meta]) for i in range(3))
    jf = jax_split.FeatureInfo(
        num_bin=jnp.asarray(nb, jnp.int32), missing_type=jnp.asarray(mt),
        default_bin=jnp.asarray(db), is_categorical=jnp.zeros(len(meta), bool))
    pf = port_split.FeatureInfo(
        num_bin=torch.as_tensor(nb), missing_type=torch.as_tensor(mt),
        default_bin=torch.as_tensor(db),
        is_categorical=torch.zeros(len(meta), dtype=torch.bool))
    return jf, pf


PARAMS = [
    dict(),
    dict(lambda_l1=0.5, lambda_l2=1.0, min_data_in_leaf=5),
    dict(max_delta_step=0.3, min_sum_hessian_in_leaf=2.0, min_gain_to_split=0.1),
]


def compare(got, want):
    for name in port_split.BestSplit._fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        if name in ("feature", "threshold", "default_left"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("p", range(len(PARAMS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_split_numerical_matches_jax(p, seed):
    jf, pf = feature_info()
    jparams = jax_split.SplitParams(**PARAMS[p])
    pparams = port_split.SplitParams(**PARAMS[p])
    mask = np.ones(len(FEATURES) + 1, bool)
    mask[6] = seed != 1
    hist, sg, sh, cnt = leaf(300 + 200 * seed, seed)
    want = jax_split.best_split_numerical(
        jnp.asarray(hist), jf, jnp.asarray(mask), sg, sh, cnt, jparams)
    got = port_split.best_split_numerical(
        torch.from_numpy(hist), pf, torch.from_numpy(mask),
        torch.tensor(sg), torch.tensor(sh), torch.tensor(cnt), pparams)
    compare(got, want)


def test_exact_ties_follow_reference_order():
    """Only the tied features can split: the duplicate pair (f1, f7) and the
    empty-bin feature f4; the chosen feature and threshold must match."""
    jf, pf = feature_info()
    for seed in range(4):
        hist, sg, sh, cnt = leaf(800, 10 + seed)
        for allowed in ([1, 7], [4], [4, 1, 7]):
            mask = np.zeros(len(FEATURES) + 1, bool)
            mask[allowed] = True
            want = jax_split.best_split_numerical(
                jnp.asarray(hist), jf, jnp.asarray(mask), sg, sh, cnt,
                jax_split.SplitParams())
            got = port_split.best_split_numerical(
                torch.from_numpy(hist), pf, torch.from_numpy(mask),
                torch.tensor(sg), torch.tensor(sh), torch.tensor(cnt),
                port_split.SplitParams())
            compare(got, want)
            if allowed == [1, 7]:
                assert int(got.feature) == 1


def test_batched_scan_equals_one_leaf_at_a_time():
    jf, pf = feature_info()
    leaves = [leaf(500, 20), leaf(700, 21)]
    mask = torch.ones(len(FEATURES) + 1, dtype=torch.bool)
    got = port_split.best_split_numerical(
        torch.stack([torch.from_numpy(h) for h, *_ in leaves]), pf, mask,
        torch.tensor([l[1] for l in leaves]),
        torch.tensor([l[2] for l in leaves]),
        torch.tensor([l[3] for l in leaves]), port_split.SplitParams())
    for i, (hist, sg, sh, cnt) in enumerate(leaves):
        want = jax_split.best_split_numerical(
            jnp.asarray(hist), jf, jnp.ones(len(FEATURES) + 1, bool), sg, sh,
            cnt, jax_split.SplitParams())
        compare(port_split.BestSplit(*[x[i] for x in got]), want)


def test_leaf_output_matches_jax():
    g = np.linspace(-3, 3, 13).astype(np.float32)
    h = np.linspace(0.5, 4, 13).astype(np.float32)
    for l1, l2, mds in [(0.0, 0.0, 0.0), (0.7, 2.0, 0.0), (0.2, 0.0, 0.4)]:
        want = jax_split.calculate_leaf_output(jnp.asarray(g), jnp.asarray(h),
                                               l1, l2, mds)
        got = port_split.calculate_leaf_output(torch.from_numpy(g),
                                               torch.from_numpy(h), l1, l2,
                                               mds)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
