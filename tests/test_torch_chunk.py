"""The port's fused multi-iteration chunk (``GBDT.train_chunk``) against the
JAX package's, and against the port's own per-iteration path, on the CPU.

Data as the JAX chunk tests use it (``tests/test_carried_rows.py``,
``tests/test_fused_valid_bagging.py``): 3,000 x 8 rows from a seed, 63 bins,
15 leaves, one torch thread.

- Against the JAX ``train_chunk``: binary and L2 on the carried row store,
  weighted binary and 3-class softmax on the plain fused path, and binary
  with a validation set and bagging (0.7 every iteration, 0.6 every 3).
  Tolerances are the JAX tests' own: 2e-4 on scores and predictions for the
  carried path (its exact sums run in the store's permuted order,
  test_carried_rows.py), 2e-5 for the plain fused path and for a validation
  set with bagging (test_fused_valid_bagging.py).
- ``pointwise_gradients`` equal to ``get_gradients`` row for row, in any
  row order, and to the JAX package's within 1e-6.
- The chunk against the port's ``train_one_iter``: byte-equal where the
  sums are exact or the path is not carried (quantized, weighted,
  multiclass, level growth quantized), within 2e-4 for the exact carried
  store (leaf-wise and level-wise); ``trees_per_chunk`` 1, 2 and 3
  byte-equal; rollback after a carried chunk; the chunk's one guard read;
  the recompile counter flat across chunks of one length.
- The per-chunk non-finite guard under ``raise``, ``skip_iter`` and
  ``clip``: one rollback, the per-iteration retry, byte-equal to the
  per-iteration run (quantized), the fused path armed again after it.
- ``GBDT.train``'s chunk boundaries equal the JAX package's for the same
  ``metric_freq`` / ``snapshot_freq``; the fusion gates equal the JAX
  package's over a set of configurations; a JAX checkpoint written after a
  chunk resumes in the port; the carried ``RowLayout`` at F = 8, 112, 116.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting import create_boosting as jax_create_boosting
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinnedDataset
from lightgbm_tpu.objective import create_objective as jax_create_objective
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core.tree_learner import RowLayout, row_layout
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.metric.metric import create_metrics
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_quant import one_thread  # noqa: F401

N, F = 3000, 8
CARRIED_TOL = 2e-4     # tests/test_carried_rows.py
FUSED_TOL = 2e-5       # tests/test_fused_valid_bagging.py
BASE = dict(num_leaves=15, learning_rate=0.2, max_bin=63, verbosity=-1)


def make_data(objective="binary", n=N, seed=3):
    """``tests/test_carried_rows.py``'s data (3-class: the binary score cut
    in three)."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    z = X[:, 0] + X[:, 1] ** 2 + rng.normal(scale=0.4, size=n)
    if objective == "binary":
        y = (z > 0.4).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(z, [0.2, 1.2]).astype(np.float64)
    else:
        y = (X[:, 0] * 3 + np.sin(X[:, 1])
             + rng.normal(scale=0.1, size=n)).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n) if objective == "binary" else None
    return X, y, w


def booster(objective="binary", weighted=False, valid=False, iters=6,
            n=N, lib="port", train_metric=False, **params):
    """A port (or, ``lib="jax"``, JAX) GBDT on the shared data."""
    X, y, w = make_data(objective, n)
    params = dict(BASE, objective=objective, num_iterations=iters, **params)
    if objective == "multiclass":
        params["num_class"] = 3
    if lib == "jax":
        ds = JaxBinnedDataset.from_matrix(X, label=y, max_bin=63,
                                          weight=w if weighted else None)
        cfg = JaxConfig(**params)
        b = jax_create_boosting(cfg.boosting, cfg, ds,
                                jax_create_objective(objective, cfg))
        vds_cls = JaxBinnedDataset
    else:
        ds = BinnedDataset.from_matrix(X, label=y, max_bin=63,
                                       weight=w if weighted else None)
        cfg = Config(dict(params))
        b = create_boosting(cfg.boosting, cfg, ds,
                            create_objective(objective, cfg, device="cpu"),
                            device="cpu")
        vds_cls = BinnedDataset
    if train_metric:
        b.add_train_metrics(
            (create_metrics if lib == "port" else _jax_metrics)(
                cfg.metric, cfg))
    if valid:
        Xv, yv, _ = make_data(objective, 800, seed=9)
        b.add_valid_data(vds_cls.from_matrix(Xv, label=yv, max_bin=63,
                                             reference=ds), "valid_1")
    return b, X


def _jax_metrics(names, cfg):
    from lightgbm_tpu.metric.metric import create_metrics as jax_metrics
    return jax_metrics(names, cfg)


def per_iteration(b, iters):
    for _ in range(iters):
        b.train_one_iter()
    return b


def scores(b):
    return b.train_score.numpy()


def jax_scores(jb, n=N):
    return np.asarray(jb.train_score)[:, :n]


def trees_text(b):
    text = b.save_model_to_string()
    return text[:text.index("\nparameters:")]


def same_bytes(a, b):
    """The same trees (the model text before its parameters) and the same
    train and validation score bytes."""
    return (trees_text(a) == trees_text(b)
            and scores(a).tobytes() == scores(b).tobytes()
            and all(x["score"].numpy().tobytes() == y["score"].numpy()
                    .tobytes() for x, y in zip(a.valid_sets, b.valid_sets)))


def split_features(models):
    return [list(t.split_feature[:t.num_leaves - 1]) for t in models]


# ---- the port's chunk against the JAX package's ----

@pytest.mark.parametrize("objective,weighted,carried,tol", [
    ("binary", False, True, CARRIED_TOL),
    ("regression", False, True, CARRIED_TOL),
    ("binary", True, False, FUSED_TOL),
    ("multiclass", False, False, FUSED_TOL),
], ids=["binary_carried", "l2_carried", "weighted_binary_plain",
        "softmax3_plain"])
def test_chunk_matches_jax_chunk(objective, weighted, carried, tol,
                                 one_thread):
    p, X = booster(objective, weighted)
    j, _ = booster(objective, weighted, lib="jax")
    assert p._can_fuse_iters() and j._can_fuse_iters()
    assert p._can_carry_rows() == j._can_carry_rows() == carried
    p.train_chunk(6)
    j.train_chunk(6)
    assert len(p.models) == len(j.models)
    assert split_features(p.models) == split_features(j.models)
    np.testing.assert_allclose(scores(p), jax_scores(j), rtol=tol, atol=tol)
    np.testing.assert_allclose(p.predict(X, raw_score=True),
                               np.asarray(j.predict(X, raw_score=True)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bag", [{}, dict(bagging_fraction=0.7,
                                          bagging_freq=1),
                                 dict(bagging_fraction=0.6, bagging_freq=3)],
                         ids=["valid", "bag_0.7_1", "bag_0.6_3"])
def test_chunk_with_validation_and_bagging_matches_jax(bag, one_thread):
    p, _ = booster(valid=True, iters=8, **bag)
    j, _ = booster(valid=True, iters=8, lib="jax", **bag)
    p.train_chunk(8)
    j.train_chunk(8)
    np.testing.assert_allclose(scores(p), jax_scores(j), rtol=FUSED_TOL,
                               atol=FUSED_TOL)
    np.testing.assert_allclose(p.valid_sets[0]["score"].numpy(),
                               np.asarray(j.valid_sets[0]["score"]),
                               rtol=FUSED_TOL, atol=FUSED_TOL)
    ep = {(d, m): v for d, m, v, _ in p.eval_valid()}
    ej = {(d, m): v for d, m, v, _ in j.eval_valid()}
    assert ep.keys() == ej.keys()
    for key in ep:
        assert abs(ep[key] - ej[key]) < 1e-4, (key, ep[key], ej[key])


@pytest.mark.parametrize("objective,params", [
    ("binary", {}), ("binary", dict(is_unbalance=True)),
    ("binary", dict(scale_pos_weight=2.0, sigmoid=0.7)),
    ("regression", {}), ("regression", dict(reg_sqrt=True))],
    ids=["binary", "unbalance", "scale_pos_sigmoid", "l2", "l2_sqrt"])
def test_pointwise_gradients_equal_get_gradients(objective, params):
    X, y, _ = make_data(objective)
    cfg = Config(dict(BASE, objective=objective, **params))
    obj = create_objective(objective, cfg, device="cpu")
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    obj.init(ds.metadata, N)
    score = torch.as_tensor(np.random.RandomState(1).normal(size=N)
                            .astype(np.float32))
    aux = obj.carry_aux()
    g, h = obj.get_gradients(score)
    pg, ph = obj.pointwise_gradients(score, aux)
    assert torch.equal(g, pg) and torch.equal(h, ph)
    perm = torch.as_tensor(np.random.RandomState(2).permutation(N))
    qg, qh = obj.pointwise_gradients(score[perm], aux[perm])
    assert torch.equal(qg, g[perm]) and torch.equal(qh, h[perm])
    jcfg = JaxConfig(**dict(BASE, objective=objective, **params))
    jobj = jax_create_objective(objective, jcfg)
    jds = JaxBinnedDataset.from_matrix(X, label=y, max_bin=63)
    jobj.init(jds.metadata, N)
    jg, jh = jobj.pointwise_gradients(score.numpy(),
                                      np.asarray(jobj.carry_aux()))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)


def test_carry_aux_is_none_where_jax_has_none():
    """Sample weights, the regression family's other objectives and
    classes without both labels carry nothing, as in the JAX package."""
    X, y, w = make_data("binary")
    for objective, weighted, yy in (("binary", True, y),
                                    ("binary", False, np.zeros(N)),
                                    ("huber", False, y), ("regression", True,
                                                         y)):
        got = []
        for lib in ("port", "jax"):
            if lib == "port":
                cfg = Config(dict(BASE, objective=objective))
                obj = create_objective(objective, cfg, device="cpu")
                ds = BinnedDataset.from_matrix(
                    X, label=yy, max_bin=63, weight=w if weighted else None)
            else:
                cfg = JaxConfig(**dict(BASE, objective=objective))
                obj = jax_create_objective(objective, cfg)
                ds = JaxBinnedDataset.from_matrix(
                    X, label=yy, max_bin=63, weight=w if weighted else None)
            obj.init(ds.metadata, N)
            got.append(obj.carry_aux() is None)
        assert got == [True, True], (objective, weighted)


# ---- the chunk against the port's own per-iteration path ----

@pytest.mark.parametrize("objective,weighted,params,exact", [
    ("binary", False, dict(hist_precision="quantized"), True),
    ("binary", False, dict(hist_precision="quantized", bagging_fraction=0.8,
                           bagging_freq=2), True),
    ("regression", False, dict(hist_precision="quantized"), True),
    ("binary", True, {}, True),
    ("binary", True, dict(bagging_fraction=0.7, bagging_freq=2), True),
    ("multiclass", False, {}, True),
    ("binary", False, {}, False),
    ("regression", False, dict(bagging_fraction=0.6, bagging_freq=3), False),
    ("binary", False, dict(tree_grow_mode="level", max_depth=4,
                           hist_precision="quantized"), True),
    ("binary", False, dict(tree_grow_mode="level", max_depth=4), False),
], ids=["binary_quant", "binary_quant_bag", "l2_quant", "weighted",
        "weighted_bag", "softmax3", "binary_exact", "l2_exact_bag",
        "level_quant", "level_exact"])
def test_chunk_matches_per_iteration(objective, weighted, params, exact,
                                     one_thread):
    """Byte-equal where the carried store's sums are exact (quantized) or
    the chunk is the plain one; the exact carried store within 2e-4.  Level
    growth on a carried store assembles its leaves by depth parity."""
    a, X = booster(objective, weighted, valid=True, **params)
    b, _ = booster(objective, weighted, valid=True, **params)
    a.train_chunk(6)
    per_iteration(b, 6)
    if exact:
        assert same_bytes(a, b)
    else:
        assert split_features(a.models) == split_features(b.models)
        np.testing.assert_allclose(scores(a), scores(b), rtol=CARRIED_TOL,
                                   atol=CARRIED_TOL)
        np.testing.assert_allclose(a.valid_sets[0]["score"].numpy(),
                                   b.valid_sets[0]["score"].numpy(),
                                   rtol=CARRIED_TOL, atol=CARRIED_TOL)
    # the carried scores are in original row order: equal to predicting
    # the training rows with the chunk's trees
    np.testing.assert_allclose(scores(a)[0] if a.num_tree_per_iteration == 1
                               else scores(a).T,
                               a.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    assert a.chunk_reads == 0   # the guard is train()'s


@pytest.mark.parametrize("params", [{}, dict(bagging_fraction=0.7,
                                             bagging_freq=1)],
                         ids=["exact", "bagging"])
def test_trees_per_chunk_is_bit_identical(params, one_thread):
    ref, _ = booster(iters=7, **params)
    ref.train_chunk(7)
    for group in (2, 3):
        b, _ = booster(iters=7, trees_per_chunk=group, **params)
        assert b._trees_per_chunk() == group
        b.train_chunk(7)
        assert same_bytes(b, ref), group


def test_rollback_after_a_carried_chunk(one_thread):
    """The carried trees keep no row_leaf: rollback routes them over the
    bins (``test_carried_rollback_uses_original_order``)."""
    b4, _ = booster(iters=4, valid=True)
    b4.train_chunk(4)
    assert b4._last_iter_arrays[0].row_leaf.numel() == 0
    b4.rollback_one_iter()
    b3, _ = booster(iters=3, valid=True)
    b3.train_chunk(3)
    assert b4.current_iteration == 3 == b4.iter_
    assert trees_text(b4) == trees_text(b3)
    np.testing.assert_allclose(scores(b4), scores(b3), rtol=CARRIED_TOL,
                               atol=CARRIED_TOL)
    np.testing.assert_allclose(b4.valid_sets[0]["score"].numpy(),
                               b3.valid_sets[0]["score"].numpy(),
                               rtol=CARRIED_TOL, atol=CARRIED_TOL)


@pytest.mark.parametrize("params", [{}, dict(bagging_fraction=0.7,
                                             bagging_freq=2)],
                         ids=["carried", "carried_bagging"])
def test_one_guard_read_a_chunk(params, one_thread):
    """train() reads back one verdict a chunk beyond the trees' own
    fetches, which are one a tree (the device build reads each tree back
    once, its bag count with it), as on the per-iteration path."""
    fetches = {}
    for fuse in (True, False):
        b, _ = booster(iters=10, valid=True, metric_freq=5,
                       train_metric=True, **params)
        b.fuse_iters = fuse
        got = fetches[fuse] = []
        real = b.learner.train

        def counted(*args, _real=real, _got=got, **kw):
            out = _real(*args, **kw)
            _got.append((out[0] if kw.get("carried") else out)
                        .host_fetches)
            return out
        b.learner.train = counted
        b.train()
        assert b.iter_ == 10 and b.chunk_reads == 2
        assert got == [1] * len(b.models)
    assert len(fetches[True]) == len(fetches[False]) == 10


# ---- the per-chunk non-finite guard ----

def poison(b, at, rows=7):
    """NaN gradients in ``rows`` rows at iteration ``at``, through both
    gradient functions (the chunk's ``pointwise_gradients``, the
    per-iteration retry's ``get_gradients``)."""
    obj = b.objective
    for name in ("get_gradients", "pointwise_gradients"):
        real = getattr(obj, name)

        def bad(*args, _real=real):
            g, h = _real(*args)
            if b.iter_ == at:
                g = g.clone()
                g.reshape(-1)[:rows] = float("nan")
            return g, h
        setattr(obj, name, bad)


def test_guard_raise(one_thread):
    b, _ = booster(iters=8, metric_freq=4, train_metric=True)
    poison(b, 5)
    with pytest.raises(LightGBMError, match="non-finite"):
        b.train()
    assert b.chunk_reads == 2


@pytest.mark.parametrize("policy", ["skip_iter", "clip"])
def test_guard_rolls_back_and_retries(policy, one_thread, tmp_path):
    """The second chunk (iterations 4-7) is poisoned at iteration 5: one
    rollback, its iterations again one at a time (``skip_iter`` adds one
    constant tree, ``clip`` trains on the cleaned gradients), the third
    chunk fused again; the model and scores equal the per-iteration run's
    byte for byte (quantized: the chunk's sums are exact)."""
    kw = dict(iters=12, metric_freq=4, train_metric=True, valid=True,
              hist_precision="quantized", nan_policy=policy)
    a, _ = booster(**kw)
    poison(a, 5)
    tele = obs.configure(out=str(tmp_path / "t.jsonl"), freq=1)
    try:
        a.train()
        trips = [e for e in tele.events if e["kind"] == "nan_trip"]
    finally:
        obs.disable()
    b, _ = booster(**kw)
    poison(b, 5)
    b.fuse_iters = False
    b.train()
    assert [(e["iteration"], e["action"]) for e in trips] == [
        (4, "rollback_retry"), (5, policy)]
    assert same_bytes(a, b)
    assert np.isfinite(scores(a)).all()
    assert (a.models[5].num_leaves == 1) == (policy == "skip_iter")
    assert not a._fuse_failed and a._prechunk is None
    assert a.chunk_reads == 4   # 3 chunks and the retried one


def test_recompile_counter_flat_across_steady_chunks(one_thread):
    """The first chunk of a length counts one ``fused_train`` key; chunks
    of a length seen before count none
    (``test_recompile_zero_across_fused_training_steady_state``)."""
    from lightgbm_tpu_torch.obs import recompile
    b, _ = booster(iters=14)
    b.train_chunk(4)
    recompile.reset()
    b.train_chunk(4)
    b.train_chunk(4)
    assert recompile.total("fused_train") == 0, recompile.counts()
    b.train_chunk(2)
    assert recompile.counts().get(("fused_train", "k=2")) == 1


# ---- GBDT.train: chunk boundaries, gates, checkpoints, layout ----

def chunk_lengths(b):
    seen = []
    real = b.train_chunk

    def rec(k):
        seen.append(int(k))
        return real(k)
    b.train_chunk = rec
    return seen


@pytest.mark.parametrize("kw", [
    dict(metric_freq=3, snapshot_freq=4, valid=True),
    dict(metric_freq=3, snapshot_freq=-1, valid=False),
    dict(metric_freq=5, snapshot_freq=2, valid=False),
], ids=["metric3_snapshot4", "no_eval", "snapshot2"])
def test_train_chunk_boundaries_equal_jax(kw, one_thread, tmp_path):
    kw = dict(kw, iters=11)
    p, _ = booster(**kw)
    j, _ = booster(lib="jax", **kw)
    seen_p, seen_j = chunk_lengths(p), chunk_lengths(j)
    p.train(snapshot_out=str(tmp_path / "p"))
    j.train(snapshot_out=str(tmp_path / "j"))
    assert seen_p == seen_j and sum(seen_p) == 11
    assert p.iter_ == j.iter_ == 11


@pytest.mark.parametrize("params", [
    dict(objective="binary"), dict(objective="binary", weighted=True),
    dict(objective="multiclass"), dict(objective="regression"),
    dict(objective="huber"), dict(objective="regression_l1"),
    dict(objective="binary", feature_fraction=0.8),
    dict(objective="binary", bagging_fraction=0.7, bagging_freq=1),
    dict(objective="binary", pos_bagging_fraction=0.7, bagging_freq=1),
    dict(objective="binary", boosting="dart"),
    dict(objective="binary", boosting="goss"),
    dict(objective="binary", boosting="rf", bagging_fraction=0.7,
         bagging_freq=1, feature_fraction=0.8),
    dict(objective="binary", cegb_penalty_split=0.1),
    dict(objective="binary", tree_grow_mode="level", max_depth=4),
    dict(objective="binary", hist_precision="quantized"),
], ids=lambda d: "-".join("%s=%s" % kv for kv in sorted(d.items())))
def test_fusion_gates_equal_jax(params):
    params = dict(params)
    objective = params.pop("objective")
    weighted = params.pop("weighted", False)
    p, _ = booster(objective, weighted, **params)
    j, _ = booster(objective, weighted, lib="jax", **params)
    assert p._can_fuse_iters() == j._can_fuse_iters()
    assert p._can_carry_rows() == j._can_carry_rows()
    assert p._fused_bag() == j._fused_bag()
    assert type(p).fuse_iters == type(j).fuse_iters
    assert p._prechunk_rollback_safe == j._prechunk_rollback_safe


def test_jax_checkpoint_after_a_chunk_resumes_in_the_port(one_thread,
                                                          tmp_path):
    """A JAX booster checkpointed after a carried chunk of 4: the port
    restores its scores byte for byte and the next chunk stays within the
    carried tolerance of the JAX package's."""
    j, X = booster(iters=8, valid=True, lib="jax")
    j.train_chunk(4)
    prefix = str(tmp_path / "j")
    j.save_checkpoint(prefix)
    p, _ = booster(iters=8, valid=True)
    assert p.resume_from_checkpoint(prefix) == 4
    assert scores(p).tobytes() == jax_scores(j).astype(np.float32).tobytes()
    p.train_chunk(4)
    j.train_chunk(4)
    assert split_features(p.models) == split_features(j.models)
    np.testing.assert_allclose(scores(p), jax_scores(j), rtol=CARRIED_TOL,
                               atol=CARRIED_TOL)
    np.testing.assert_allclose(p.predict(X, raw_score=True),
                               np.asarray(j.predict(X, raw_score=True)),
                               rtol=CARRIED_TOL, atol=CARRIED_TOL)


@pytest.mark.parametrize("ncols,bpc,voff,plain_w,carried_w", [
    (8, 1, 8, 128, 128), (112, 1, 112, 128, 256), (116, 1, 116, 128, 256),
    (56, 2, 112, 128, 256)])
def test_carried_row_layout(ncols, bpc, voff, plain_w, carried_w):
    """tree_learner.py:311-319: aux at voff+12, score at voff+16, W a
    multiple of 128; the offsets equal the JAX learner's ``row_layout``."""
    plain = row_layout(ncols, bpc)
    lay = row_layout(ncols, bpc, carried=True)
    assert (plain.voff, plain.W, plain.bitoff) == (voff, plain_w, voff + 12)
    assert (lay.voff, lay.aoff, lay.soff, lay.W, lay.carried) == (
        voff, voff + 12, voff + 16, carried_w, True)
    assert lay.bitoff == voff + 20
    with pytest.raises(ValueError, match="mutually exclusive"):
        row_layout(ncols, bpc, bitbytes=1, carried=True)
    if bpc == 1:
        rng = np.random.RandomState(0)
        X = rng.normal(size=(256, ncols))
        y = (X[:, 0] > 0).astype(np.float64)
        cfg = JaxConfig(objective="binary", max_bin=63, verbosity=-1)
        jb = jax_create_boosting(
            "gbdt", cfg, JaxBinnedDataset.from_matrix(X, label=y, max_bin=63),
            jax_create_objective("binary", cfg))
        jl = jb.learner.row_layout()
        assert (jl["voff"], jl["aoff"], jl["soff"]) == (lay.voff, lay.aoff,
                                                        lay.soff)
        pcfg = Config(dict(objective="binary", max_bin=63, verbosity=-1))
        pb = create_boosting(
            "gbdt", pcfg, BinnedDataset.from_matrix(X, label=y, max_bin=63),
            create_objective("binary", pcfg, device="cpu"), device="cpu")
        got = pb.learner.row_layout(carried=True)
        assert isinstance(got, RowLayout) and got == lay
        assert pb.learner.row_layout() == plain
