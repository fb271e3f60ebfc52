"""Ensemble compaction of the port (``lightgbm_tpu_torch/core/compact.py``)
against the JAX package's (``lightgbm_tpu/core/compact.py``), on the CPU.

The same model text goes through both packages' ``compact_trees``: the
compacted trees' text, node counts, codebook blocks and declared bound are
equal.  The port's generation (``compact_booster``) round-trips through its
model text, its measured ``max_score_delta`` stays within the declared
bound, and it swaps into a serving registry whose responses equal the
compacted trees' ``FusedPredictor`` bit for bit.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as P
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.core import compact as j_compact
from lightgbm_tpu.core.predict_fused import tree_block as j_tree_block
from lightgbm_tpu.plan import state as j_plan_state
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.core import compact
from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
from lightgbm_tpu_torch.serving import Server

CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_jax_plans():
    # the JAX tree_block reads its plan state's budget: no cache engaged
    j_plan_state.reset()
    yield
    j_plan_state.reset()


def _train(seed=0, objective="binary", iters=12, num_leaves=15, n=1500,
           features=8, **extra):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, features))
    if objective == "multiclass":
        y = np.argmax(X[:, :3], axis=1).astype(np.float64)
        extra["num_class"] = 3
    else:
        y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0) * 1.0
    params = dict({"objective": objective, "num_leaves": num_leaves,
                   "max_bin": 63, "verbosity": -1,
                   "min_data_in_leaf": 5}, **extra)
    return P.train(params, P.Dataset(X, y), iters, device=CPU), X, y


def _jax_trees(text):
    jb = JGBDT(JConfig())
    jb.load_model_from_string(text)
    return jb.models


@pytest.mark.parametrize("t,m,l", [(1, 1, 2), (100, 30, 31), (500, 254, 255),
                                   (7, 4000, 4001), (64, 1, 2),
                                   (1000, 62, 63)])
def test_tree_block_is_the_jax_sizing(t, m, l):
    assert compact.tree_block(t, m, l) == j_tree_block(t, m, l)


KW = {
    "codebook_merge": dict(leaf_codes=255),
    "codebook_only": dict(leaf_codes=255, merge_subtrees=False),
    "coarse": dict(leaf_codes=15),
    "prune_cap": dict(leaf_codes=255, prune_frac=0.05, leaf_cap=10),
    "block": dict(leaf_codes=63, block_g=4),
}


@pytest.mark.parametrize("kw", list(KW))
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_compact_trees_equals_the_jax_package(kw, objective):
    b, _, _ = _train(objective=objective)
    text = b.model_to_string()
    ours, st = compact.compact_trees(b._booster.models, **KW[kw])
    theirs, jst = j_compact.compact_trees(_jax_trees(text), **KW[kw])
    assert [t.to_string() for t in ours] == [t.to_string() for t in theirs]
    for key in ("trees", "nodes_in", "nodes_out", "tree_reduction",
                "declared_max_score_delta", "block_g", "max_leaves_in",
                "max_leaves_out", "model_bytes_in", "model_bytes_out",
                "leaf_codes", "leaf_cap", "prune_frac"):
        assert st[key] == jst[key], key


def test_codebook_only_keeps_the_structure():
    b, X, _ = _train()
    trees = b._booster.models
    out, st = compact.compact_trees(trees, leaf_codes=255,
                                    merge_subtrees=False)
    assert [t.num_leaves for t in out] == [t.num_leaves for t in trees]
    for old, new in zip(trees, out):
        assert sorted(zip(old.split_feature.tolist(),
                          old.threshold.tolist())) == sorted(
            zip(new.split_feature.tolist(), new.threshold.tolist()))
    rows = X[:400].astype(np.float32)
    delta = np.max(np.abs(np.asarray(FusedPredictor(trees, device=CPU)(rows))
                          - np.asarray(FusedPredictor(out, device=CPU)(rows))))
    assert delta <= st["declared_max_score_delta"]
    assert st["tree_reduction"] == 0.0 and st["bytes_in"] == st["bytes_out"]


def test_compact_booster_reduces_and_stays_in_bound():
    b, X, y = _train(seed=3, iters=30, num_leaves=31, n=2000, features=10)
    gen, st = compact.compact_booster(b, leaf_codes=255, prune_frac=0.05,
                                      leaf_cap=24)
    assert st["tree_reduction"] > 0 and st["byte_reduction"] > 0
    assert st["max_leaves_out"] <= 24 < st["max_leaves_in"]
    assert gen.device.type == "cpu"
    meas = compact.measure_compaction(b._booster, gen, X[:1000], y[:1000])
    assert meas["max_score_delta"] <= st["declared_max_score_delta"]
    assert meas["auc_delta"] <= 0.01
    # an immutable generation: its model text round-trips exactly
    gen2 = GBDT(gen.config, device=CPU)
    gen2.load_model_from_string(gen.save_model_to_string())
    np.testing.assert_array_equal(gen.predict(X[:600], raw_score=True),
                                  gen2.predict(X[:600], raw_score=True))


def test_compacted_generation_swaps_into_the_registry():
    b, X, _ = _train()
    gen, _ = compact.compact_booster(b, leaf_codes=255)
    rows = X[:64].astype(np.float32)
    want = FusedPredictor(gen.models, device=CPU)(rows)
    with Server(max_batch_wait_us=0, device=CPU) as srv:
        srv.register("m", b._booster)
        srv.predict("m", rows, raw_score=True)
        srv.swap("m", gen)
        got = srv.predict("m", rows, raw_score=True)
        stats = srv.stats()
    np.testing.assert_array_equal(np.asarray(got).ravel(),
                                  np.asarray(want).ravel())
    assert stats["dropped"] == 0 and stats["failed"] == 0
    assert gen._score_fingerprint_raw is b._booster._score_fingerprint_raw


def test_auc_helper_equals_the_jax_one():
    rng = np.random.RandomState(1)
    s = np.round(rng.normal(size=500), 1)     # ties
    y = (rng.rand(500) < 0.4) * 1.0
    assert compact._auc(s, y) == j_compact._auc(s, y)
