"""The port's asynchronous training loop (``GBDT.train_one_iter``'s lazy
path and the fused chunk's pending trees) on the CPU.

Data of ``test_torch_chunk.py``: 3,000 x 8 rows from a seed, 63 bins, 15
leaves, one torch thread; 20 iterations, so that every run crosses the
stall poll at iteration 16.

- Lazy against forced materialization (the same booster with
  ``_poll_freq = 1`` and ``models`` read after every iteration): byte-equal
  model text, train scores and validation scores, for binary with a
  validation set, 3-class softmax, bagging, ``feature_fraction`` (the
  per-iteration path), GOSS, RF, a custom objective's gradients, level
  growth exact and quantized, the carried chunk, CEGB and the ``rs``
  learner of a gloo group (world size 1 and 2, every rank on one poll
  schedule).
- Against the JAX package's lazy ``train_one_iter`` and ``train()``: a
  stall at iteration 5 of 20 trims to the same model length, ``iter_``
  and warning, with scores within ``test_torch_train``'s 1e-5 (its chunk
  within ``test_torch_chunk``'s 2e-4); non-finite device gradients at
  iteration 3 under ``nan_policy=raise`` raise at the same call, the poll,
  naming iteration 3; ``capture_train_state`` inside the poll window
  resumes byte-equal to the uninterrupted run; ``rollback_one_iter`` after
  lazy iterations equals the shorter run; ``Booster.update``'s and
  ``LGBM_BoosterUpdateOneIter``'s ``is_finished`` come at the same call.
- Read count: 20 iterations without evaluation make 2 polls and 1
  materialization (``host_reads``), and the count grows with the polls,
  not with the iterations between them.
"""
import ctypes

import numpy as np
import pytest

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu.utils.log import LightGBMError as JaxError
from lightgbm_tpu_torch import c_api
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_chunk import CARRIED_TOL, booster, jax_scores, make_data
from test_torch_quant import one_thread  # noqa: F401
from torch_parallel_ranks import spawn

ITERS = 20
TRAIN_TOL = 1e-5       # test_torch_train.py: scores against the JAX package

LAZY_CASES = {
    "binary_valid": dict(valid=True),
    "multiclass": dict(objective="multiclass", valid=True),
    "bagging": dict(bagging_fraction=0.7, bagging_freq=2, valid=True),
    "feature_fraction": dict(feature_fraction=0.7, valid=True),
    "goss": dict(boosting="goss", top_rate=0.3, other_rate=0.2,
                 learning_rate=0.5),
    "rf": dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1,
               feature_fraction=0.8, valid=True),
    "level_exact": dict(tree_grow_mode="level", valid=True),
    "level_quantized": dict(tree_grow_mode="level",
                            hist_precision="quantized", valid=True),
    "cegb": dict(cegb_penalty_split=0.002,
                 cegb_penalty_feature_coupled=[0.2] * 8, valid=True),
}


def state(b):
    """Model text, train score bytes and validation score bytes."""
    return (b.save_model_to_string(), b.train_score.numpy().tobytes(),
            [vs["score"].numpy().tobytes() for vs in b.valid_sets])


def run(b, forced, step=None, iters=ITERS, trailing=False):
    """``iters`` iterations of ``step`` (``train_one_iter``); ``forced``:
    the poll every iteration and the trees read after each; ``trailing``:
    then the trailing poll, as ``train()`` ends."""
    if forced:
        b._poll_freq = 1
    step = step or b.train_one_iter
    for _ in range(iters):
        step()
        if forced:
            b.models
    if trailing and b._nl_handles:
        b._poll_stop()
    return b


@pytest.mark.parametrize("case", sorted(LAZY_CASES))
def test_lazy_equals_forced(case, one_thread):
    lazy = run(booster(**LAZY_CASES[case])[0], False, trailing=True)
    forced = run(booster(**LAZY_CASES[case])[0], True)
    assert lazy.iter_ == forced.iter_ and lazy.iter_ >= ITERS - 1
    assert state(lazy) == state(forced)


def logloss_grads(b):
    """A custom objective's host gradients of the binary log loss."""
    y = b.train_data.metadata.label
    p = 1.0 / (1.0 + np.exp(-b.train_score[0].numpy().astype(np.float64)))
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def test_custom_objective_lazy_equals_forced(one_thread):
    texts = []
    for forced in (False, True):
        b = booster(valid=True)[0]
        run(b, forced, step=lambda b=b: b.train_one_iter(*logloss_grads(b)))
        texts.append(state(b))
    assert texts[0] == texts[1]


def test_carried_chunk_lazy_equals_forced(one_thread):
    """The carried chunk leaves its 20 trees pending; read after every
    iteration instead (its commit wrapped), the bytes are the same."""
    got = []
    for forced in (False, True):
        b = booster(valid=True)[0]
        assert b._can_fuse_iters() and b._can_carry_rows()
        if forced:
            b._poll_freq = 1
            real = b._commit_lazy

            def commit(*a, _real=real, _b=b, **k):
                out = _real(*a, **k)
                _b.models
                return out
            b._commit_lazy = commit
        assert not b.train_chunk(ITERS)
        assert b.iter_ == ITERS and len(b._pending) == (0 if forced
                                                        else ITERS)
        got.append(state(b))
    assert got[0] == got[1]


@pytest.mark.parametrize("d", [1, 2])
def test_rs_learner_lazy_equals_forced(d, tmp_path):
    ranks = spawn("lazy_loop", d, str(tmp_path), ITERS)
    for r in ranks:
        assert r["lazy"] == dict(r["forced"], reads=r["lazy"]["reads"])
        assert r["lazy"]["iter"] == ITERS and r["lazy"]["reads"] == 3
    assert all(r == ranks[0] for r in ranks)


# ---- against the JAX package ----

STALL = dict(objective="regression", num_leaves=7, learning_rate=0.4,
             min_data_in_leaf=400, min_gain_to_split=20.0, max_bin=63,
             verbosity=-1)


def stall_data():
    """Two levels of the label apart on x0's sign: each tree halves the
    residual, so the split gain falls 4x an iteration until
    ``min_gain_to_split`` stops it."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(2000, 6))
    y = (X[:, 0] > 0) * 2.0 + 0.01 * rng.normal(size=2000)
    return X, y


def stall_boosters():
    X, y = stall_data()
    ref = J.Booster(STALL, J.Dataset(X, y, params={"max_bin": 63}))
    port = P.Booster(STALL, P.Dataset(X, y, params={"max_bin": 63}),
                     device="cpu")
    return ref, port


def test_stall_trims_as_jax(one_thread, capsys):
    ref, port = stall_boosters()
    got = {}
    for name, b in (("jax", ref), ("port", port)):
        capsys.readouterr()
        finished = []
        while len(finished) < ITERS and not any(finished):
            finished.append(b._booster.train_one_iter())
        got[name] = (finished, b._booster.iter_, len(b._booster.models),
                     capsys.readouterr())
    (jf, jit, jlen, jout), (pf, pit, plen, pout) = got["jax"], got["port"]
    assert pf == jf and pf.index(True) == 15
    assert pit == jit == plen == jlen == 5
    warn = "no more leaves that meet the split requirements"
    assert (warn in pout.out + pout.err) and (warn in jout.out + jout.err)
    np.testing.assert_allclose(port._booster.train_score.numpy(),
                               jax_scores(ref._booster, 2000), rtol=0,
                               atol=TRAIN_TOL)


def test_stall_in_train_as_jax(one_thread):
    """Through ``train()`` (the carried chunk of 20 iterations, the poll at
    its end): the same length and iteration."""
    X, y = stall_data()
    ref = J.train(dict(STALL, num_iterations=ITERS),
                  J.Dataset(X, y, params={"max_bin": 63}),
                  num_boost_round=ITERS, verbose_eval=False)
    jb = ref._booster
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    cfg = Config(**dict(STALL, num_iterations=ITERS))
    ds = P.Dataset(X, y, params={"max_bin": 63}).construct().handle
    pb = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
              device="cpu")
    pb.train()
    jb2 = J.Booster(dict(STALL, num_iterations=ITERS),
                    J.Dataset(X, y, params={"max_bin": 63}))._booster
    jb2.train()
    assert pb.iter_ == jb2.iter_ == len(pb.models) == len(jb2.models) < ITERS
    assert len(jb.models) >= pb.iter_
    np.testing.assert_allclose(pb.train_score.numpy(),
                               jax_scores(jb2, 2000), rtol=0,
                               atol=CARRIED_TOL)


def poison(get_gradients, at, set_nan):
    """``get_gradients`` with a NaN in row 7 of the gradient on call
    ``at`` (0-based)."""
    calls = {"n": 0}

    def poisoned(score):
        g, h = get_gradients(score)
        if calls["n"] == at:
            g = set_nan(g)
        calls["n"] += 1
        return g, h
    return poisoned


def _nan_jax(g):
    return g.at[7].set(float("nan"))


def _nan_port(g):
    g = g.clone()
    g[7] = float("nan")
    return g


@pytest.mark.parametrize("lib", ["jax", "port"])
def test_nonfinite_raises_at_the_poll(lib, one_thread):
    b = booster(valid=True, lib=lib)[0]
    b.objective.get_gradients = poison(
        b.objective.get_gradients, 3, _nan_jax if lib == "jax" else _nan_port)
    done = 0
    with pytest.raises(JaxError if lib == "jax" else LightGBMError,
                       match="non-finite.*iteration 3"):
        for _ in range(ITERS):
            b.train_one_iter()
            done += 1
    # the iterations after the bad one ran: the verdict waited for the poll
    assert done == 15


def test_nonfinite_drained_at_the_end(one_thread):
    """A bad iteration after the last poll raises in ``engine.train``'s
    drain (engine.py:282-285)."""
    X, y, _ = make_data()
    real = P.engine.Booster.update

    def update(self, train_set=None, fobj=None):
        g = self._booster
        if not hasattr(g, "_poisoned"):
            g._poisoned = True
            g.objective.get_gradients = poison(g.objective.get_gradients, 18,
                                               _nan_port)
        return real(self, train_set, fobj)
    P.engine.Booster.update = update
    try:
        with pytest.raises(LightGBMError, match="iteration 18"):
            P.train(dict(objective="binary", num_leaves=15, verbosity=-1),
                    P.Dataset(X, y, params={"max_bin": 63}),
                    num_boost_round=ITERS, verbose_eval=False, device="cpu")
    finally:
        P.engine.Booster.update = real


def test_capture_inside_the_poll_window_resumes_equal(one_thread):
    whole = run(booster(valid=True)[0], False)
    first = run(booster(valid=True)[0], False, iters=10)
    assert first._nl_handles
    meta, arrays, text = first.capture_train_state()
    assert not first._nl_handles and meta["iteration"] == 10
    resumed = booster(valid=True)[0]
    resumed.restore_train_state(meta, arrays, text)
    run(resumed, False, iters=ITERS - 10)
    assert resumed.iter_ == ITERS
    assert state(resumed) == state(whole)
    jfirst = run(booster(valid=True, lib="jax")[0], False, iters=10)
    jmeta = jfirst.capture_train_state()[0]
    assert jmeta["iteration"] == meta["iteration"]


def test_rollback_after_lazy_iterations(one_thread):
    b = run(booster(valid=True)[0], False, iters=8)
    assert b._pending and b._valid_queue
    b.rollback_one_iter()
    shorter = run(booster(valid=True)[0], False, iters=7)
    assert b.iter_ == 7 and not b._pending
    assert state(b) == state(shorter)
    jb = run(booster(valid=True, lib="jax")[0], False, iters=8)
    jb.rollback_one_iter()
    assert jb.iter_ == 7 and len(jb.models) == 7
    np.testing.assert_allclose(b.train_score.numpy(), jax_scores(jb),
                               rtol=0, atol=TRAIN_TOL)
    # later iterations and polls never meet the removed trees
    run(b, False, iters=ITERS - 7)
    run(shorter, False, iters=ITERS - 7)
    assert state(b) == state(shorter)


def test_update_is_finished_as_jax(one_thread):
    ref, port = stall_boosters()
    want = [ref.update() for _ in range(ITERS)]
    assert [port.update() for _ in range(ITERS)] == want
    assert port.current_iteration() == ref.current_iteration()
    entries = c_api._entries()
    X, y = stall_data()
    cb = c_api._CBooster(P.Booster(STALL, P.Dataset(
        X, y, params={"max_bin": 63}), device="cpu"))
    handle = c_api._new_handle(cb)
    fin = ctypes.c_int(-1)
    got = []
    for _ in range(ITERS):
        entries["LGBM_BoosterUpdateOneIter"](handle,
                                             ctypes.addressof(fin))
        got.append(bool(fin.value))
    c_api._free_handle(handle)
    assert got == want


@pytest.mark.parametrize("iters,polls", [(20, 2), (40, 3)])
def test_reads_are_the_polls_and_one_materialization(iters, polls,
                                                     one_thread):
    """``train()`` one iteration at a time (``fuse_iters = False``), no
    evaluation: a poll every 16 iterations and the trailing one; the
    trees come back in one read when first asked for."""
    b = booster(iters=iters)[0]
    b.fuse_iters = False
    b.train()
    assert b.iter_ == iters and b.host_reads == polls
    assert len(b._pending) == iters
    b.save_model_to_string()
    b.predict(make_data()[0][:10])
    assert b.host_reads == polls + 1 and not b._pending


@pytest.mark.parametrize("mode", ["leaf", "level"])
def test_host_loop_trees_in_the_lazy_loop(mode, one_thread):
    """A learner whose trees grow in the host loop (``host_loop=True``,
    the checks' oracle) gives the lazy loop host arrays, which it packs
    into a device record: the model equals the device build's."""
    import functools
    got = []
    for host_loop in (False, True):
        b = booster(valid=True, tree_grow_mode=mode)[0]
        b.learner.train = functools.partial(b.learner.train,
                                            host_loop=host_loop)
        got.append(state(run(b, False, iters=6)))
    assert got[0] == got[1]
