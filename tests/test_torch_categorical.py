"""Categorical features on the port against the JAX package, on the CPU.

The split scan (``per_feature_best_categorical``: one-hot mode and the
sorted many-vs-many scan, with and without monotone bounds, one leaf and a
batch) on histograms of random rows; then training on ``make_cat_problem``'s
shape (tests/test_categorical.py: a 12-category column that carries the
target, plus a 3-category and a numerical column; 4096 rows, level counts
skewed and distinct), leaf-wise in both search modes (level growth with
categorical columns: ``test_torch_efb.py``, exact, and
``test_torch_level_oracle_cat.py``, quantized); then prediction of
categorical trees (unseen, negative, NaN and fractional categories), the
model text round trip both ways, and ``init_model`` with a categorical
model.

Tolerances: scans within rtol 1e-5 / atol 1e-5 with thresholds and bitsets
equal; trees equal (features, bin thresholds, decision types, category
bitsets, children, leaf counts) with leaf values within
``test_torch_train.leaf_value_tolerance``; predictions within 1e-4 of the
JAX package's, and within 1e-9 of the host ``Tree.predict`` (the same f64
sums).  In many-vs-many mode a split may send the other side of the same
partition left (the scan reaches it from both ends of the sorted
categories, at equal gain in real arithmetic; ROADMAP queue 3): such trees
are held to the same partition of the training rows
(``test_torch_efb.assert_trees_match``); one-hot mode has no such ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as J
from lightgbm_tpu.core import split as jax_split
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.convert import gbdt_from_model_string
from lightgbm_tpu_torch.core import split as port_split
from lightgbm_tpu_torch.core import tree_learner as port_tl
from test_torch_efb import (PARAMS, N, assert_predictions_close,
                            assert_trees_match, train_both)
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)

CATS = [0, 1]
CAT_PARAMS = dict(PARAMS, min_data_per_group=20, cat_smooth=5.0)


def skewed_levels(rng, n, levels, decay):
    """Level k on about n * decay**k / sum rows (distinct counts)."""
    w = decay ** np.arange(levels)
    c = np.floor(n * w / w.sum()).astype(int)
    c[0] += n - c.sum()
    return rng.permutation(np.repeat(np.arange(levels), c))


def make_cat_problem(n=N, seed=0):
    """make_cat_problem's shape: categories {0, 3, 7} of a 12-category
    column are hot; a 3-category column and a numerical one add to it."""
    rng = np.random.RandomState(seed)
    c12 = skewed_levels(rng, n, 12, 0.85)
    c3 = skewed_levels(rng, n, 3, 0.6)
    x = rng.normal(size=n)
    logit = 2.0 * np.isin(c12, [0, 3, 7]) + 0.7 * (c3 == 1) + x - 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(float)
    return np.column_stack([c12, c3, x, rng.normal(size=n)]), y


@pytest.fixture(scope="module")
def cat_data():
    return make_cat_problem()


# ---- the scan ----

B = 64
# (num_bin, missing_type, default_bin): categorical features
FEATURES = [(3, 0, 0), (12, 0, 0), (40, 2, 0), (13, 2, 0), (20, 0, 0)]


def leaf(n, seed):
    """A leaf's rows -> hist [F, 2, B] f32 and its totals; bin frequencies
    skewed so that sorted orders have no ties."""
    rng = np.random.RandomState(seed)
    F = len(FEATURES)
    bins = np.stack([rng.choice(nb, size=n, p=rng.dirichlet(np.full(nb, .6)))
                     for nb, _, _ in FEATURES], 1)
    grad = (rng.normal(size=n) + 1.2 * (bins[:, 1] % 3 == 0)
            - 0.8 * (bins[:, 2] < 10)).astype(np.float32)
    hess = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    hist = np.zeros((F, 2, B), np.float64)
    for j in range(F):
        np.add.at(hist[j, 0], bins[:, j], grad)
        np.add.at(hist[j, 1], bins[:, j], hess)
    return (hist.astype(np.float32), np.float32(grad.sum()),
            np.float32(hess.sum()), np.float32(n))


def feature_info(mono):
    nb, mt, db = (np.array([m[i] for m in FEATURES]) for i in range(3))
    F = len(FEATURES)
    jf = jax_split.FeatureInfo(
        num_bin=jnp.asarray(nb, jnp.int32), missing_type=jnp.asarray(mt),
        default_bin=jnp.asarray(db), is_categorical=jnp.ones(F, bool),
        monotone=jnp.asarray(mono, jnp.int32))
    pf = port_split.FeatureInfo(
        num_bin=torch.as_tensor(nb), missing_type=torch.as_tensor(mt),
        default_bin=torch.as_tensor(db),
        is_categorical=torch.ones(F, dtype=torch.bool),
        monotone=torch.as_tensor(mono))
    return jf, pf


# (params, monotone bounds of the leaf or None)
SCAN_CASES = [
    (dict(), None),
    (dict(min_data_per_group=10, cat_smooth=1.0), (-0.5, 0.4)),
    (dict(max_cat_to_onehot=13, min_data_in_leaf=5), None),
    (dict(max_cat_threshold=4, lambda_l1=0.3, lambda_l2=2.0, cat_l2=3.0),
     (-0.3, 0.6)),
    (dict(max_delta_step=0.2, min_sum_hessian_in_leaf=5.0,
          min_gain_to_split=0.5), None),
]


def compare_best(got, want, found):
    for name in port_split.FeatureBest._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if name in ("threshold", "default_left", "cat_bitset"):
            np.testing.assert_array_equal(g[found], w[found], err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("p", range(len(SCAN_CASES)))
def test_categorical_scan_matches_jax(p):
    params, bounds = SCAN_CASES[p]
    jf, pf = feature_info([0] * len(FEATURES))
    jp = jax_split.SplitParams(**params)
    pp = port_split.SplitParams(**params)
    mask = np.ones(len(FEATURES), bool)
    mask[3] = p != 1
    leaves = [leaf(1500 + 700 * s, 10 * p + s) for s in range(3)]
    for hist, sg, sh, cnt in leaves:
        jb = () if bounds is None else (jnp.float32(bounds[0]),
                                        jnp.float32(bounds[1]))
        pb = () if bounds is None else (torch.tensor(bounds[0]),
                                        torch.tensor(bounds[1]))
        want = jax_split.per_feature_best_categorical(
            jnp.asarray(hist), jf, jnp.asarray(mask), sg, sh, cnt, jp, *jb)
        got = port_split.per_feature_best_categorical(
            torch.from_numpy(hist), pf, torch.from_numpy(mask),
            torch.tensor(sg), torch.tensor(sh), torch.tensor(cnt), pp, *pb)
        found = np.isfinite(np.asarray(want.gain))
        assert found.any()
        compare_best(got, want, found)
    # a batch of leaves equals one leaf at a time
    batch = port_split.per_feature_best_categorical(
        torch.stack([torch.from_numpy(h) for h, *_ in leaves]), pf,
        torch.from_numpy(mask), *[torch.tensor([lf[i] for lf in leaves])
                                  for i in (1, 2, 3)], pp)
    for i, (hist, sg, sh, cnt) in enumerate(leaves):
        one = port_split.per_feature_best_categorical(
            torch.from_numpy(hist), pf, torch.from_numpy(mask),
            torch.tensor(sg), torch.tensor(sh), torch.tensor(cnt), pp)
        for name in port_split.FeatureBest._fields:
            assert torch.equal(getattr(batch, name)[i], getattr(one, name))


def test_both_search_modes_pick_jax_bitsets():
    """One-hot features send one bin left, many-vs-many ones a sorted
    prefix: the bitsets of both modes equal the JAX package's."""
    jf, pf = feature_info([0] * len(FEATURES))
    hist, sg, sh, cnt = leaf(4000, 99)
    mask = np.ones(len(FEATURES), bool)
    want = jax_split.per_feature_best_categorical(
        jnp.asarray(hist), jf, jnp.asarray(mask), sg, sh, cnt,
        jax_split.SplitParams(min_data_per_group=10, cat_smooth=1.0))
    got = port_split.per_feature_best_categorical(
        torch.from_numpy(hist), pf, torch.from_numpy(mask), torch.tensor(sg),
        torch.tensor(sh), torch.tensor(cnt),
        port_split.SplitParams(min_data_per_group=10, cat_smooth=1.0))
    words = got.cat_bitset.numpy()
    np.testing.assert_array_equal(words, np.asarray(want.cat_bitset))
    ones = [bin(int(w)).count("1") for w in words[:, 0]]
    assert ones[0] == 1                      # 3 bins <= max_cat_to_onehot
    assert max(ones[1:]) > 1                 # a many-vs-many prefix


# ---- training ----

@pytest.mark.parametrize("extra,side_swaps", [
    (dict(), True), (dict(max_cat_to_onehot=16), False)],
    ids=["many_vs_many", "one_hot"])
def test_categorical_trees_match_jax(cat_data, extra, side_swaps,
                                     one_thread):
    X, y = cat_data
    ref, port = train_both(X, y, dict(CAT_PARAMS, **extra), cats=CATS,
                           iters=3)
    assert port.learner.has_categorical
    assert all(t.num_cat > 0 for t in port.models)
    swaps = []
    assert_trees_match(ref.models, port.models, N, X, swaps)
    assert side_swaps or not swaps
    assert_predictions_close(ref, port, X[:1000])


# ---- prediction, model text, init_model ----

ODD_ROWS = np.array([[99.0, 0.0, 0.1, 0.0],     # unseen category
                     [-1.0, 1.0, 0.1, 0.0],     # negative
                     [np.nan, np.nan, 0.1, 0.0],
                     [3.7, 2.2, -0.3, 0.0],     # fractional: 3 and 2
                     [1e10, -5.0, 0.0, 0.0]])


@pytest.fixture(scope="module")
def boosters(cat_data):
    X, y = cat_data
    ref = J.train(dict(CAT_PARAMS), J.Dataset(X, y, categorical_feature=CATS),
                  num_boost_round=4, verbose_eval=False)
    port = P.train(dict(CAT_PARAMS), P.Dataset(X, y, categorical_feature=CATS),
                   num_boost_round=4, verbose_eval=False, device="cpu")
    return X, y, ref, port


def test_categorical_prediction_matches_jax(boosters, one_thread):
    """Unseen, negative, NaN and fractional categories route as the JAX
    package's and the host trees route them (tree.h:283-331)."""
    X, _, ref, port = boosters
    assert_trees_match(ref._booster.models, port._booster.models, N)
    rows = np.concatenate([X[:500], ODD_ROWS])
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(rows, raw_score=raw),
                                   ref.predict(rows, raw_score=raw),
                                   rtol=0, atol=1e-4)
    host = sum(t.predict(rows) for t in port._booster.models)
    np.testing.assert_allclose(port.predict(rows, raw_score=True), host,
                               rtol=0, atol=1e-9)


def test_categorical_model_text_round_trip(boosters):
    """The port's model text (cat_boundaries / cat_threshold) loads back
    into the port and into the JAX package, and the JAX package's loads
    into the port; every load predicts as the model it came from."""
    X, _, ref, port = boosters
    rows = np.concatenate([X[:300], ODD_ROWS])
    text = port.model_to_string()
    assert "cat_threshold=" in text
    want = port.predict(rows, raw_score=True)
    again = gbdt_from_model_string(text, device="cpu")
    np.testing.assert_allclose(again.predict(rows, raw_score=True), want,
                               rtol=0, atol=1e-9)
    jax_loaded = J.Booster(model_str=text)
    np.testing.assert_allclose(jax_loaded.predict(rows, raw_score=True),
                               want, rtol=0, atol=1e-6)
    from_jax = gbdt_from_model_string(ref.model_to_string(), device="cpu")
    np.testing.assert_allclose(from_jax.predict(rows, raw_score=True),
                               ref.predict(rows, raw_score=True), rtol=0,
                               atol=1e-6)


def test_init_model_with_categorical_model(boosters, one_thread):
    """``train(init_model=...)`` continues a categorical model: the loaded
    trees replay onto the training scores through their bin bitsets
    (``arrays_from_tree``), and the next trees equal the JAX package's
    continuation of the same model."""
    X, y, ref, _ = boosters
    text = ref.model_to_string()
    cont_ref = J.train(dict(CAT_PARAMS),
                       J.Dataset(X, y, categorical_feature=CATS),
                       num_boost_round=2, init_model=ref, verbose_eval=False)
    cont = P.train(dict(CAT_PARAMS), P.Dataset(X, y, categorical_feature=CATS),
                   num_boost_round=2, init_model=text, verbose_eval=False,
                   device="cpu")
    assert cont.num_trees() == cont_ref.num_trees() == 6
    assert_trees_match(cont_ref._booster.models[4:], cont._booster.models[4:],
                       N)
    np.testing.assert_allclose(cont.predict(X[:500], raw_score=True),
                               cont_ref.predict(X[:500], raw_score=True),
                               rtol=0, atol=1e-4)


def test_arrays_from_tree_routes_categorical_like_training(boosters):
    """A trained categorical tree, converted to model form and back
    (``tree_from_arrays`` -> ``arrays_from_tree``), keeps its bin bitsets
    and routes the training bins to the leaves training gave them."""
    _, _, _, port = boosters
    gbdt = port._booster
    a = gbdt.last_arrays
    back = port_tl.arrays_from_tree(gbdt.models[-1], gbdt.train_data)
    m = a.num_leaves - 1
    cat = gbdt.learner.feat_host["is_cat"][a.split_feature[:m]]
    assert cat.any()
    np.testing.assert_array_equal(back.cat_bitset[:m][cat],
                                  a.cat_bitset[:m][cat])
    bins = gbdt.learner.valid_bins(gbdt.train_data)
    leaf = port_tl.route_binned(bins, back, gbdt.learner.feat_host)
    assert torch.equal(leaf, a.row_leaf)
