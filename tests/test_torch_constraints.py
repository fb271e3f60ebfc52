"""Monotone constraints, ``extra_trees`` and ``feature_contri`` on the port
against the JAX package, on the CPU, and the learner's refusals.

Data: ``test_torch_categorical.make_cat_problem`` (4096 rows: a 12- and a
3-category column, two numerical ones) and, for the level path,
``test_torch_efb.mixed_data``.  Tolerances as in ``test_torch_efb.py``: trees
equal (features, bin thresholds, decision types, category bitsets,
children, leaf counts), leaf values within ``leaf_value_tolerance``,
predictions within 1e-4.

``extra_trees`` draws each feature's one candidate threshold from a hash of
the leaf's f32 gradient and hessian totals (split.py:141-165).  The port's
totals are f32 sums in another order than XLA's, so they differ from the JAX
package's in the last bits and the draws diverge, except where every sum is
exact: with integer gradients (L2 regression on integer labels from a zero
score) tree 0 is equal, leaf values included.  Over 10 boosting iterations
the two extra-trees models are budgeted by train log loss: the port's gap to
the JAX package's within 2% of the JAX package's loss reduction (measured
0.46%, ROADMAP queue 3).  The hash itself is held bit for bit.

The level rule of the monotone bounds (tree_learner.py:1220-1230) is held
against the JAX level path in ``test_torch_efb.py``'s level test, which
constrains two columns with +1 and -1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import split as jax_split
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.core import split as port_split
from lightgbm_tpu_torch.core import tree_learner as port_tl
from test_torch_categorical import CAT_PARAMS, CATS, make_cat_problem
from test_torch_efb import (MIXED_CATS, N, assert_predictions_close,
                            assert_trees_match, datasets, make_mixed,
                            train_both)
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cat_data():
    return make_cat_problem()


def logloss(score, y):
    s = np.asarray(score, np.float64)
    return float(np.mean(np.logaddexp(0.0, s) - y * s))


# ---- monotone constraints ----

@pytest.mark.parametrize("mono", [[0, 0, 1, -1], [0, 0, -1, 1]],
                         ids=["up_down", "down_up"])
def test_monotone_trees_match_jax(cat_data, mono, one_thread):
    """Both signs on the two numerical columns (the categorical ones take
    no constraint): trees equal the JAX package's up to the sides of
    many-vs-many categorical splits (``test_torch_efb.assert_trees_match``;
    in ``down_up`` tree 0's 13th split, gains 0.66215456 and 0.66215265,
    ROADMAP queue 3), and the predictions are monotone in each constrained
    column."""
    X, y = cat_data
    ref, port = train_both(X, y, dict(CAT_PARAMS, monotone_constraints=mono),
                           cats=CATS, iters=3)
    assert port.learner.has_monotone
    assert_trees_match(ref.models, port.models, N, X, swaps=[])
    assert_predictions_close(ref, port, X[:1000])
    grid = np.linspace(-3, 3, 41)
    for col, sign in ((2, mono[2]), (3, mono[3])):
        rows = np.repeat(X[:50], grid.size, axis=0)
        rows[:, col] = np.tile(grid, 50)
        p = port.predict(rows, raw_score=True).reshape(50, grid.size)
        assert (sign * np.diff(p, axis=1) >= -1e-12).all()


# ---- feature_contri ----

def test_feature_contri_trees_match_jax(cat_data, one_thread):
    X, y = cat_data
    ref, port = train_both(X, y, dict(CAT_PARAMS,
                                      feature_contri=[1.0, 0.5, 0.3, -1.0]),
                           cats=CATS, iters=3)
    contri = port_split.contri_scale(port.learner.params, "cpu")
    assert contri is not None
    assert float(contri[3]) == 0.0     # max(0, -1)
    assert_trees_match(ref.models, port.models, N)
    assert 3 not in {int(f) for t in port.models
                     for f in t.split_feature_inner[:t.num_leaves - 1]}


# ---- extra_trees ----

def test_extra_trees_hash_matches_jax():
    """The candidate threshold of each (feature, leaf): bit for bit."""
    nb = np.array([2, 3, 13, 64, 200, 255])
    F = nb.size
    jf = jax_split.FeatureInfo(jnp.asarray(nb, jnp.int32),
                               jnp.zeros(F, jnp.int32),
                               jnp.zeros(F, jnp.int32), jnp.zeros(F, bool))
    pf = port_split.FeatureInfo(torch.as_tensor(nb),
                                torch.zeros(F, dtype=torch.long),
                                torch.zeros(F, dtype=torch.long),
                                torch.zeros(F, dtype=torch.bool))
    rng = np.random.RandomState(0)
    sg = np.concatenate([rng.normal(size=20) * 1e3, [0.0, -0.0, 1e-30]])
    sh = np.abs(rng.normal(size=sg.size)) * 100
    sg, sh = sg.astype(np.float32), sh.astype(np.float32)
    t = np.arange(256)[None, :]
    for seed in (6, 0, 2 ** 31 + 5):
        want = np.stack([np.asarray(jax_split._extra_trees_mask(
            jf, jnp.float32(a), jnp.float32(b), jnp.asarray(t),
            jax_split.SplitParams(extra_trees=True, extra_seed=seed)))
            for a, b in zip(sg, sh)])
        got = port_split._extra_trees_mask(
            pf, torch.from_numpy(sg), torch.from_numpy(sh),
            torch.from_numpy(t),
            port_split.SplitParams(extra_trees=True, extra_seed=seed))
        np.testing.assert_array_equal(got.numpy(), want)


def test_extra_trees_tree0_matches_jax_with_exact_sums(cat_data, one_thread):
    """L2 regression on integer labels from a zero score: every gradient
    sum is an exact integer, so both draw the same thresholds and tree 0 is
    equal, leaf values exactly."""
    X, _ = cat_data
    rng = np.random.RandomState(5)
    yi = np.round(2 * X[:, 2] + 3 * np.isin(X[:, 0], [0, 3, 7])
                  + rng.normal(size=N))
    ref, port = train_both(X, yi, dict(CAT_PARAMS, objective="regression",
                                       boost_from_average=False,
                                       extra_trees=True), cats=CATS, iters=1)
    a, b = ref.models[0], port.models[0]
    nl = a.num_leaves
    assert b.num_leaves == nl > 1
    for name in ("split_feature_inner", "threshold_in_bin", "decision_type",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                      getattr(a, name)[:nl - 1])
    assert b.cat_threshold == a.cat_threshold
    np.testing.assert_array_equal(b.leaf_value[:nl], a.leaf_value[:nl])


def test_extra_trees_loss_within_budget(cat_data, one_thread):
    X, y = cat_data
    ref, port = train_both(X, y, dict(CAT_PARAMS, extra_trees=True),
                           cats=CATS, iters=10)
    start = logloss(np.full(N, np.log(y.mean() / (1 - y.mean()))), y)
    want = logloss(np.asarray(ref.train_score)[0, :N], y)
    got = logloss(port.train_score[0].numpy(), y)
    assert got < start and want < start
    assert abs(got - want) <= 0.02 * (start - want)


# ---- refusals ----

@pytest.fixture(scope="module")
def bundled_cat_dataset():
    X, y = make_mixed(2048, 4)
    return datasets(X, y, MIXED_CATS)[1]


@pytest.mark.parametrize("params,item", [
    (dict(tree_learner="data"), "item 13b"),
], ids=["parallel"])
def test_still_refused(bundled_cat_dataset, params, item):
    """A parallel learner trains from every row on every rank; a rank's
    stripe of the rows (a dataset the loader stamped ``shard``) is refused
    by name before any process group is touched."""
    import copy

    from lightgbm_tpu_torch.parallel import DataParallelTreeLearner
    cfg = Config(objective="binary", verbosity=-1, **params)
    stripe = copy.copy(bundled_cat_dataset)
    stripe.shard = {"rank": 0, "num_machines": 2, "begin": 0,
                    "end": stripe.num_data, "num_total": 2 * stripe.num_data}
    with pytest.raises(NotImplementedError, match="ROADMAP %s" % item):
        DataParallelTreeLearner(stripe, cfg, device="cpu")


@pytest.mark.parametrize("params", [
    dict(), dict(monotone_constraints=[0] * 62 + [1, -1]),
    dict(feature_contri=[0.5] * 64), dict(extra_trees=True),
    dict(forcedsplits_filename="forced.json"),
    dict(cegb_penalty_split=1e-4),
    dict(cegb_penalty_feature_coupled=[1.0, 2.0] * 32),
    dict(cegb_penalty_feature_lazy=[1e-4] * 64),
    dict(histogram_pool_size=64.0)],
    ids=["bundled_categorical", "monotone", "feature_contri", "extra_trees",
         "forced_splits", "cegb_split", "cegb_coupled", "cegb_lazy",
         "histogram_pool_size"])
def test_lifted_refusals_are_gone(bundled_cat_dataset, params, tmp_path):
    """EFB-bundled data, categorical features, monotone constraints,
    feature_contri, extra_trees, forced splits (on numerical column 62),
    the three CEGB penalties (lists over the dataset's 64 features) and the
    histogram pool build a learner and grow a tree."""
    ds = bundled_cat_dataset
    assert ds.is_bundled and ds.feature_is_categorical().any()
    if "forcedsplits_filename" in params:
        path = tmp_path / params["forcedsplits_filename"]
        path.write_text('{"feature": 62, "threshold": 0.0}')
        params = dict(params, forcedsplits_filename=str(path))
    cfg = Config(objective="binary", num_leaves=7, verbosity=-1, **params)
    learner = port_tl.SerialTreeLearner(ds, cfg, device="cpu")
    rng = np.random.RandomState(0)
    grad = torch.from_numpy(rng.normal(size=ds.num_data).astype(np.float32))
    hess = torch.full((ds.num_data,), 0.25)
    arrays = learner.train(grad, hess, ds.num_data)
    assert arrays.num_leaves > 1
    if "forcedsplits_filename" in params:
        assert arrays.split_feature[0] == ds.inner_feature_map[62]
