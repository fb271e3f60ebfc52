"""EFB-bundled sparse data on the port against the JAX package, on the CPU.

The fixtures have the shape of ``tests/test_efb.py``'s: one-hot columns of
three categorical variables, 20 levels each (60 sparse columns that bundle
into a few group columns), with skewed level frequencies such that no
two levels of a variable have the same count (one-hot features with equal
counts give exactly tied gains, test_efb.py:46-52).  ``mixed_data`` adds a
12-category and a 3-category categorical column and two numerical ones.
4096 rows, max_bin=63, learning_rate=0.1, binary objective.

Both packages bin the same input with their own copies of the binning code;
the ``binned`` bytes and group layout must be equal before anything is
trained.  Tolerances: the trees equal (split features, threshold bins,
decision types, so ``default_left`` and the categorical flag, category
bitsets, children and leaf counts), leaf values within
``test_torch_train.leaf_value_tolerance``, predictions within 1e-4; the
unpacked per-feature histograms within 2**-16 of the largest bin sum (the
hi/lo split of the JAX package's exact mode, histogram.py:11-15).

The level case goes through both packages' ``train()`` on CSR input; the
JAX learner's level path only exists as its fused Pallas split pass, run
here in Pallas interpret mode (``LIGHTGBM_TPU_PALLAS_INTERPRET``) with the
``pl.load`` / ``pl.store`` shim of ``test_torch_level_oracle.py`` (both set
by ``monkeypatch`` and undone after the test); it takes about 40 s of this
file's ~60.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from jax.experimental import pallas as pl

import lightgbm_tpu as J
from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.histogram import histogram_rows as jax_histogram_rows
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.objective import create_objective as jax_objective
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import GBDT, BinnedDataset, Config, create_objective
from lightgbm_tpu_torch.core import tree_learner as port_tl
from lightgbm_tpu_torch.core.histogram import histogram_rows_plain
from test_torch_level_oracle import _shim_is_undone, _store  # noqa: F401
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

torch.set_num_threads(2)

N = 4096
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, verbosity=-1)
MIXED_CATS = [60, 61]


def one_hot_blocks(rng, n, blocks=3, levels=20):
    """[n, blocks * levels] one-hot columns and the level of each block.
    Level k of block b holds about n * d**k / sum(d**j) rows, d = 0.75,
    0.8, 0.85 (skewed, and no two counts equal), in shuffled rows."""
    cols, lv = [], []
    for b in range(blocks):
        w = (0.75 + 0.05 * b) ** np.arange(levels)
        c = np.floor(n * w / w.sum()).astype(int)
        c[0] += n - c.sum()
        v = rng.permutation(np.repeat(np.arange(levels), c))
        oh = np.zeros((n, levels))
        oh[np.arange(n), v] = 1.0
        cols.append(oh)
        lv.append(v)
    return np.concatenate(cols, 1), lv


def distinct_counts(X):
    """No two one-hot columns of a block have the same number of ones."""
    counts = X.sum(0)
    return all(len(set(counts[b:b + 20])) == 20 for b in range(0, 60, 20))


@pytest.fixture(scope="module")
def sparse_data():
    rng = np.random.RandomState(9)
    X, lv = one_hot_blocks(rng, N)
    assert distinct_counts(X)
    y = ((lv[0] % 3 == 0) + 0.5 * (lv[1] > 10)
         + rng.normal(scale=0.3, size=N) > 0.8).astype(np.float64)
    return X, y


def make_mixed(n, seed):
    rng = np.random.RandomState(seed)
    X, lv = one_hot_blocks(rng, n)
    c12 = rng.choice(12, size=n, p=np.sort(rng.dirichlet(np.ones(12)))[::-1])
    c3 = rng.choice(3, size=n, p=[0.5, 0.3, 0.2])
    num = rng.normal(size=(n, 2))
    logit = (1.2 * np.isin(c12, [0, 3, 7]) + 0.6 * (c3 == 1)
             + 0.8 * (lv[0] % 3 == 0) + num[:, 0] - 0.5 * num[:, 1])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(logit - 1.0)))).astype(float)
    return np.column_stack([X, c12, c3, num]), y


@pytest.fixture(scope="module")
def mixed_data():
    X, y = make_mixed(N, 4)
    assert distinct_counts(X[:, :60])
    return X, y


def datasets(X, y, cats=None, csr=False):
    """The JAX package's and the port's BinnedDataset of the same input,
    checked equal byte for byte (bins and group layout)."""
    kw = dict(max_bin=63)
    if csr:
        m = sps.csr_matrix(X)
        args = (m.indptr, m.indices, m.data, m.shape[1])
        ref = JaxDataset.from_csr(*args, label=y, **kw)
        port = BinnedDataset.from_csr(*args, label=y, **kw)
    else:
        if cats:
            kw["categorical_feature"] = cats
        ref = JaxDataset.from_matrix(X, label=y, **kw)
        port = BinnedDataset.from_matrix(X, label=y, **kw)
    np.testing.assert_array_equal(port.binned, ref.binned)
    assert port.feature_groups == ref.feature_groups
    np.testing.assert_array_equal(port.group_idx, ref.group_idx)
    np.testing.assert_array_equal(port.bin_offset, ref.bin_offset)
    return ref, port


def set_level_shim(monkeypatch, exact):
    """The JAX level path in Pallas interpret mode (see the module
    docstring); exact mode sums in f32 (``LIGHTGBM_TPU_EXACT_HIST``)."""
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    if exact:
        monkeypatch.setenv("LIGHTGBM_TPU_EXACT_HIST", "1")


def train_both(X, y, params, *, cats=None, iters=2):
    """Train the JAX package's GBDT and the port's, leaf-wise, on the same
    binned data."""
    ref_ds, port_ds = datasets(X, y, cats)
    ref_cfg = JaxConfig(**params)
    ref = JaxGBDT(ref_cfg, ref_ds, jax_objective(params["objective"],
                                                 ref_cfg))
    cfg = Config(**params)
    port = GBDT(cfg, port_ds, create_objective(params["objective"], cfg,
                                               device="cpu"), device="cpu")
    for _ in range(iters):
        ref.train_one_iter()
        port.train_one_iter()
    return ref, port


def same_partition(a, b, X, n):
    """Trees ``a`` and ``b`` send the rows of ``X`` (their training rows)
    to leaves that pair one to one, with leaf values within
    ``leaf_value_tolerance``: the same tree up to the sides of categorical
    splits.  The leaf counts, estimated from hessians, may differ by one:
    a swapped split estimates the other side's count and derives this one
    by subtraction."""
    la, lb = a.predict_leaf_index(X), b.predict_leaf_index(X)
    pairs = sorted(set(zip(la.tolist(), lb.tolist())))
    assert len(pairs) == len(set(la.tolist())) == len(set(lb.tolist()))
    ia, ib = np.asarray(pairs).T
    np.testing.assert_array_less(
        np.abs(b.leaf_count[ib].astype(np.int64) - a.leaf_count[ia]), 2)
    np.testing.assert_array_less(np.abs(b.leaf_value[ib] - a.leaf_value[ia]),
                                 leaf_value_tolerance(a, n)[ia])


def train_both_engines(monkeypatch, X, y, params, *, cats=None, csr=False,
                       iters=2):
    """Train through both packages' ``train()`` (the port on the CPU) on the
    same input, as scipy CSR when ``csr``, with ``categorical_feature``
    when ``cats``; level growth runs the JAX learner's fused level path in
    Pallas interpret mode (``LIGHTGBM_TPU_PALLAS_INTERPRET``; the caller
    sets the shim).  Returns the two boosters after checking that their
    datasets hold the same bytes."""
    if params.get("tree_grow_mode") == "level":
        monkeypatch.setenv("LIGHTGBM_TPU_PALLAS_INTERPRET", "1")
    data = sps.csr_matrix(X) if csr else X
    kw = {} if cats is None else dict(categorical_feature=cats)
    ref_train = J.Dataset(data, y, **kw)
    port_train = P.Dataset(data, y, **kw)
    ref = J.train(params, ref_train, num_boost_round=iters,
                  verbose_eval=False)
    port = P.train(params, port_train, num_boost_round=iters,
                   verbose_eval=False, device="cpu")
    np.testing.assert_array_equal(port_train.handle.binned,
                                  ref_train.handle.binned)
    if params.get("tree_grow_mode") == "level":
        assert ref._booster.learner.effective_grow_mode() == "level"
    return ref, port


def assert_trees_match(ref_models, port_models, n, X=None, swaps=None):
    """Trees equal, leaf values within ``leaf_value_tolerance``.

    With ``X`` (the training rows) and a list ``swaps``, a tree whose first
    difference is a categorical split sending disjoint category sets left
    (a side swap: a many-vs-many scan reaches one partition from both ends
    of the sorted categories, at equal gain in real arithmetic, and the
    rounding of the leaf totals picks the side, ROADMAP queue 3) is held to
    :func:`same_partition` instead, and (tree, node) is recorded in
    ``swaps``."""
    assert len(ref_models) == len(port_models)
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl, "tree %d" % i
        swapped = first_side_swap(a, b) if swaps is not None else None
        if swapped is not None:
            swaps.append((i, swapped))
            same_partition(a, b, X, n)
            continue
        for name in ("split_feature_inner", "threshold_in_bin",
                     "decision_type", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        assert b.num_cat == a.num_cat, "tree %d" % i
        assert b.cat_boundaries == a.cat_boundaries, "tree %d" % i
        assert b.cat_threshold == a.cat_threshold, "tree %d" % i
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl],
                                      err_msg="tree %d" % i)
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, n))


def cat_words(tree, node):
    """The category bitset words of a categorical node."""
    ci = int(tree.threshold_in_bin[node])
    return tree.cat_threshold[tree.cat_boundaries[ci]:
                              tree.cat_boundaries[ci + 1]]


def first_side_swap(a, b):
    """The first node (in node order) where ``a`` and ``b`` differ, when it
    is a categorical split of one feature in both whose left category sets
    are disjoint; else None."""
    for node in range(a.num_leaves - 1):
        same = all(getattr(a, f)[node] == getattr(b, f)[node] for f in
                   ("split_feature_inner", "decision_type"))
        if same and not int(a.decision_type[node]) & 1:
            if a.threshold_in_bin[node] == b.threshold_in_bin[node]:
                continue
            return None
        if not same:
            return None
        wa, wb = cat_words(a, node), cat_words(b, node)
        if wa == wb:
            continue
        if any(x & y for x, y in zip(wa, wb)):
            return None
        return node
    return None


def assert_predictions_close(ref, port, X):
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


def test_csr_binned_equals_dense_and_jax(sparse_data):
    """CSR input bins straight into the bundled group columns: the same
    bytes as the dense matrix and as the JAX package's ``from_csr``."""
    X, y = sparse_data
    ref, port = datasets(X, y, csr=True)
    dense = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    assert port.is_bundled and len(port.feature_groups) <= 6
    np.testing.assert_array_equal(port.binned, dense.binned)
    assert port.feature_groups == dense.feature_groups
    # the public Dataset takes scipy sparse input and bins it the same way
    ds = P.Dataset(sps.csr_matrix(X), y, params=dict(max_bin=63)).construct()
    np.testing.assert_array_equal(ds.handle.binned, port.binned)


@pytest.mark.parametrize("start,count", [(0, N), (1000, 1500)])
def test_unpacked_histograms_match_jax_unpack(sparse_data, start, count):
    """Group histograms of a window unpacked into per-feature histograms
    (``unpack_groups``) against the JAX package's histogram of the same row
    store unpacked by its learner's ``unpack`` (tree_learner.py:427-437),
    with the leaf totals of the window."""
    X, y = sparse_data
    ref_ds, port_ds = datasets(X, y)
    cfg = Config(**PARAMS)
    learner = port_tl.SerialTreeLearner(port_ds, cfg, device="cpu")
    jl = JaxGBDT(JaxConfig(**PARAMS), ref_ds,
                 jax_objective("binary", JaxConfig(**PARAMS))).learner
    rng = np.random.RandomState(1)
    grad = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.1, 0.3, size=N).astype(np.float32))
    rows = port_tl.fill_gradients(learner.template, learner.layout, grad,
                                  hess)
    kw = dict(num_features=learner.num_columns, voff=learner.layout.voff,
              bpc=learner.layout.bpc, packed=learner.packed)
    sg = grad[start:start + count].sum()
    sh = hess[start:start + count].sum()
    got = port_tl.unpack_groups(
        histogram_rows_plain(rows, learner.num_bins, start, count, **kw),
        learner.feat.group, learner.lanes, sg, sh)
    h = jax_histogram_rows(jnp.asarray(rows.numpy()), jl.num_bins, start,
                           count, use_pallas=False, **kw)
    lidx, lmask = jl.unpack_lanes
    hf = jnp.take_along_axis(h[jl.feat.group], lidx[:, None, :], axis=2)
    hf = hf * lmask[:, None, :]
    rest = jnp.sum(hf, axis=2)
    want = np.asarray(hf.at[:, 0, 0].set(float(sg) - rest[:, 0])
                      .at[:, 1, 0].set(float(sh) - rest[:, 1]))
    Bf = learner.feat_bins
    assert not np.asarray(want)[:, :, Bf:].any()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want[:, :, :Bf], rtol=0,
                               atol=2.0 ** -16 * scale)


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_bundled_training_matches_jax(sparse_data, precision, one_thread):
    """Leaf-wise growth on the group columns: the port's trees equal the
    JAX package's."""
    X, y = sparse_data
    ref, port = train_both(X, y, dict(PARAMS, hist_precision=precision),
                           iters=3)
    assert port.learner.grouped and port.train_data.is_bundled
    assert_trees_match(ref.models, port.models, N)
    assert_predictions_close(ref, port, X[:1000])


def test_bundled_level_training_matches_jax_level_path(mixed_data,
                                                       monkeypatch,
                                                       one_thread):
    """Level growth (exact) through ``train()`` on CSR input that bundles,
    with monotone constraints of both signs on its two numerical columns:
    the port's level passes unfold group codes, the bounds follow the level
    rule (tree_learner.py:1220-1230), and its trees equal the JAX level
    path's.  (Categorical columns in level growth: the quantized oracle of
    ``test_torch_level_oracle_cat.py``.)"""
    X, y = mixed_data
    set_level_shim(monkeypatch, exact=True)
    ref, port = train_both_engines(
        monkeypatch, X, y, dict(PARAMS, tree_grow_mode="level",
                                monotone_constraints=[0] * 62 + [1, -1]),
        csr=True)
    gbdt = port._booster
    assert gbdt.learner.grouped and gbdt.learner.has_monotone
    assert gbdt.last_arrays.levels == gbdt.learner.level_count() == 4
    assert_trees_match(ref._booster.models, gbdt.models, N)
    assert_predictions_close(ref, port, X[:1000])


def test_train_with_csr_validation_set(sparse_data, one_thread):
    """``train()`` on CSR input with a CSR validation set (binned with the
    training set's mappers and groups): the validation scores kept in
    training equal the Booster's raw predictions, the training rows' leaves
    equal ``route_binned`` over the group columns, and the model equals the
    JAX package's trained through its own ``train()``."""
    X, y = sparse_data
    Xt, yt = X[:3000], y[:3000]
    Xv, yv = X[3000:], y[3000:]
    params = dict(PARAMS, metric="auc")
    train = P.Dataset(sps.csr_matrix(Xt), yt)
    valid = train.create_valid(sps.csr_matrix(Xv), yv)
    evals = {}
    bst = P.train(params, train, num_boost_round=3, valid_sets=[valid],
                  valid_names=["v"], evals_result=evals, verbose_eval=False,
                  device="cpu")
    gbdt = bst._booster
    assert gbdt.train_data.is_bundled and valid.handle.is_bundled
    np.testing.assert_array_equal(valid.handle.group_idx,
                                  train.handle.group_idx)
    vscore = gbdt.valid_sets[0]["score"][0].double().numpy()
    np.testing.assert_allclose(bst.predict(sps.csr_matrix(Xv), raw_score=True),
                               vscore, rtol=0, atol=1e-5)
    a = gbdt.last_arrays
    bins = gbdt.learner.valid_bins(gbdt.train_data)
    leaf = port_tl.route_binned(bins, a, gbdt.learner.feat_host)
    assert torch.equal(leaf, a.row_leaf)
    jtrain = J.Dataset(sps.csr_matrix(Xt), yt)
    jvalid = jtrain.create_valid(sps.csr_matrix(Xv), yv)
    jevals = {}
    ref = J.train(params, jtrain, num_boost_round=3, valid_sets=[jvalid],
                  valid_names=["v"], evals_result=jevals, verbose_eval=False)
    assert_trees_match(ref._booster.models, gbdt.models, len(yt))
    np.testing.assert_allclose(evals["v"]["auc"], jevals["v"]["auc"],
                               rtol=0, atol=1e-6)
