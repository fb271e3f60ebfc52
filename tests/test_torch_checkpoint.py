"""Checkpoints and resume of the port (``lightgbm_tpu_torch/checkpoint.py``),
and their compatibility with the JAX package's, on the CPU.

A run interrupted after a checkpoint and resumed from it must give what the
uninterrupted run gives: the model text (before ``parameters:``) and the f32
train score bytes, for GBDT with bagging (a window of 3 iterations, resumed
in its middle) and ``feature_fraction``, DART, GOSS, random forest and lazy
CEGB through ``train(checkpoint_prefix=)`` interrupted by a callback's
exception, and for GBDT's own loop (``GBDT.train(snapshot_out)``) with a
validation set and early stopping.  Also: the codec byte-equal to the JAX
package's, a corrupt newest checkpoint falling back to the previous one and
a truncated one refused, ``snapshot_keep``, the refusals of another
boosting, dataset or list of validation sets, ``rollback_one_iter``
giving back the previous iteration's score bytes, and checkpoints carried
across the packages: one the JAX package wrote at iteration 2 of an
interrupted run resumed by the port to iteration 6 gives the JAX package's
uninterrupted trees (split features, thresholds, children and leaf counts
equal; leaf values within ``test_torch_train.leaf_value_tolerance``), and
one the port wrote resumes in the JAX package the same way.  The port pins
one torch thread.
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as J
from lightgbm_tpu import checkpoint as jax_ckpt
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import BinnedDataset, Config, GBDT, create_objective
from lightgbm_tpu_torch import checkpoint as ckpt
from lightgbm_tpu_torch.metric.metric import create_metrics
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import leaf_value_tolerance

torch.set_num_threads(1)

N = 2000
BASE = dict(objective="binary", num_leaves=15, max_bin=63, verbosity=-1,
            snapshot_freq=2)
DS = {"max_bin": 63}
BOOSTERS = {
    "gbdt_bagging": dict(bagging_fraction=0.8, bagging_freq=3,
                         feature_fraction=0.7),
    "dart": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0,
                 bagging_fraction=0.8, bagging_freq=1),
    "goss": dict(boosting="goss", learning_rate=0.3),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
               feature_fraction=0.8),
    "cegb_lazy": dict(cegb_penalty_feature_lazy=[0.01] * 6,
                      cegb_penalty_split=0.01, cegb_tradeoff=0.1),
}


def make_data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 - 0.5 * X[:, 2]
         + rng.normal(size=n) > 0.5).astype(float)
    return X, y


def cut(text):
    return text[:text.index("\nparameters:")]


class Stop(Exception):
    pass


def stop_after(iteration):
    def cb(env):
        if env.iteration == iteration:
            raise Stop()
    return cb


def interrupted_then_resumed(lib, params, prefix, rounds=7, at=4, **kw):
    """Run ``rounds`` rounds interrupted after iteration ``at`` + 1, then
    the same call again, which resumes from the newest checkpoint."""
    X, y = make_data()
    with pytest.raises(Stop):
        lib.train(params, lib.Dataset(X, y, params=DS),
                  num_boost_round=rounds, verbose_eval=False,
                  checkpoint_prefix=prefix, callbacks=[stop_after(at)], **kw)
    left = sorted(os.path.basename(p) for _, p in
                  (ckpt if lib is P else jax_ckpt).list_checkpoints(prefix))
    booster = lib.train(params, lib.Dataset(X, y, params=DS),
                        num_boost_round=rounds, verbose_eval=False,
                        checkpoint_prefix=prefix, **kw)
    return booster, left


@pytest.mark.parametrize("name", sorted(BOOSTERS))
def test_resume_equals_uninterrupted(name, tmp_path, one_thread):
    params = dict(BASE, **BOOSTERS[name])
    X, y = make_data()
    full = P.train(params, P.Dataset(X, y, params=DS), num_boost_round=7,
                   verbose_eval=False, device="cpu")
    prefix = str(tmp_path / "m")
    res, left = interrupted_then_resumed(P, params, prefix, device="cpu")
    assert left == ["m.ckpt_iter_2", "m.ckpt_iter_4"]
    assert ckpt.list_checkpoints(prefix) == []   # the call completed
    assert cut(res.model_to_string()) == cut(full.model_to_string())
    assert res._booster.train_score.numpy().tobytes() == \
        full._booster.train_score.numpy().tobytes()
    if name == "cegb_lazy":
        assert torch.equal(res._booster.learner.cegb_paid,
                           full._booster.learner.cegb_paid)


def gbdt_with_valid(iters, device="cpu"):
    X, y = make_data()
    Xv, yv = make_data(600, seed=1)
    cfg = Config(dict(BASE, num_iterations=iters, learning_rate=0.5,
                      early_stopping_round=2, metric="auc", metric_freq=1,
                      bagging_fraction=0.7, bagging_freq=2))
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    vds = BinnedDataset.from_matrix(Xv, label=yv, reference=ds)
    b = GBDT(cfg, ds, create_objective("binary", cfg, device), device=device)
    b.add_valid_data(vds, "valid", create_metrics(["auc"], cfg))
    return b


def test_gbdt_train_loop_resume_with_early_stopping(tmp_path, one_thread):
    """GBDT.train's own early stopping state rides the checkpoint."""
    full = gbdt_with_valid(20)
    full.train()
    assert 4 < full.current_iteration < 20, "early stopping did not end it"
    prefix = str(tmp_path / "s")
    first = gbdt_with_valid(4)
    first.train(snapshot_out=prefix)
    assert [i for i, _ in ckpt.list_checkpoints(prefix)] == [4, 2]
    assert os.path.exists(prefix + ".snapshot_iter_4")
    res = gbdt_with_valid(20)
    assert res.resume_from_checkpoint(prefix) == 4
    res.train()
    assert res.best_iteration == full.best_iteration > 0
    assert cut(res.save_model_to_string()) == cut(full.save_model_to_string())
    assert res.train_score.numpy().tobytes() == \
        full.train_score.numpy().tobytes()
    assert res.valid_sets[0]["score"].numpy().tobytes() == \
        full.valid_sets[0]["score"].numpy().tobytes()


def test_codec_round_trip_and_jax_bytes():
    meta = {"iteration": 3, "boosting": "gbdt", "x": [1.5, "a"]}
    arrays = {"train_score": np.arange(12, dtype=np.float32).reshape(2, 6),
              "cegb_paid": np.arange(10, dtype=np.uint8).reshape(5, 2)}
    blob = ckpt.serialize_state(meta, arrays, "tree\nmodel")
    assert blob == jax_ckpt.serialize_state(meta, arrays, "tree\nmodel")
    m, a, s = ckpt.deserialize_state(blob)
    assert m == meta and s == "tree\nmodel"
    for k in arrays:
        np.testing.assert_array_equal(a[k], arrays[k])
        assert a[k].dtype == arrays[k].dtype
    with pytest.raises(ckpt.CheckpointError, match="truncated|trailer"):
        ckpt.deserialize_state(blob[:-5])
    bad = bytearray(blob)
    bad[20] ^= 1
    with pytest.raises(ckpt.CheckpointError, match="CRC32"):
        ckpt.deserialize_state(bytes(bad))


def test_fingerprint_equals_jax():
    X, y = make_data()
    X[::7, 3] = np.nan
    pds = P.Dataset(X, y, params=DS).construct().handle
    jds = J.Dataset(X, y, params=DS).construct().handle
    assert ckpt.dataset_fingerprint(pds) == jax_ckpt.dataset_fingerprint(jds)


def trained(params, rounds, device="cpu"):
    X, y = make_data()
    return P.train(params, P.Dataset(X, y, params=DS),
                   num_boost_round=rounds, verbose_eval=False, device=device)


def test_corrupt_newest_falls_back_and_truncated_refused(tmp_path):
    prefix = str(tmp_path / "c")
    b = trained(dict(BASE), 2)
    b.save_checkpoint(prefix)
    b.update()
    b.update()
    b.save_checkpoint(prefix)
    newest = ckpt.checkpoint_path(prefix, 4)
    data = bytearray(open(newest, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(data))
    fresh = trained(dict(BASE), 1)
    assert fresh.resume_from_checkpoint(prefix) == 2
    assert fresh.current_iteration() == 2
    with pytest.raises(ckpt.CheckpointError, match="CRC32"):
        ckpt.load_checkpoint(newest)
    full = open(ckpt.checkpoint_path(prefix, 2), "rb").read()
    open(newest, "wb").write(full[:len(full) - 100])
    with pytest.raises(ckpt.CheckpointError, match="trailer|length"):
        ckpt.load_checkpoint(newest)
    os.unlink(ckpt.checkpoint_path(prefix, 2))
    assert ckpt.load_latest_checkpoint(prefix) is None
    assert trained(dict(BASE), 1).resume_from_checkpoint(prefix) == 0


def test_snapshot_keep(tmp_path):
    prefix = str(tmp_path / "k")
    b = trained(dict(BASE, snapshot_keep=2), 1)
    for _ in range(4):
        b.save_checkpoint(prefix)
        b.update()
    assert [i for i, _ in ckpt.list_checkpoints(prefix)] == [4, 3]
    b.save_checkpoint(prefix)
    ckpt.prune_checkpoints(prefix, 0)
    assert len(ckpt.list_checkpoints(prefix)) == 2
    ckpt.cleanup_checkpoints(prefix)
    assert ckpt.list_checkpoints(prefix) == []


def test_refusals(tmp_path):
    prefix = str(tmp_path / "r")
    X, y = make_data()
    b = trained(dict(BASE), 2)
    b.save_checkpoint(prefix)
    with pytest.raises(ckpt.CheckpointError, match="boosting"):
        trained(dict(BASE, boosting="dart"), 1).resume_from_checkpoint(prefix)
    other = P.train(dict(BASE), P.Dataset(X[:1500], y[:1500], params=DS),
                    num_boost_round=1, verbose_eval=False, device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="different dataset"):
        other.resume_from_checkpoint(prefix)
    with_valid = trained(dict(BASE), 1)
    with_valid.add_valid(P.Dataset(X[:300], y[:300],
                                   reference=with_valid._train_set), "v")
    with pytest.raises(ckpt.CheckpointError, match="validation sets"):
        with_valid.resume_from_checkpoint(prefix)


def test_snapshot_freq_unset_warns(tmp_path, capsys):
    prefix = str(tmp_path / "w")
    X, y = make_data()
    P.train(dict(BASE, snapshot_freq=-1, verbosity=1),
            P.Dataset(X, y, params=DS), num_boost_round=2,
            verbose_eval=False, device="cpu", checkpoint_prefix=prefix)
    assert "snapshot_freq" in capsys.readouterr().out
    assert ckpt.list_checkpoints(prefix) == []


@pytest.mark.parametrize("name", ["gbdt", "goss", "rf"])
def test_rollback_gives_back_scores(name, one_thread):
    params = dict(BASE, **(BOOSTERS.get(name) or BOOSTERS["gbdt_bagging"]))
    X, y = make_data()
    four = trained(params, 4)
    five = trained(params, 5)
    five.rollback_one_iter()
    assert five.current_iteration() == 4
    assert cut(five.model_to_string()) == cut(four.model_to_string())
    assert five._booster.train_score.numpy().tobytes() == \
        four._booster.train_score.numpy().tobytes()
    np.testing.assert_array_equal(five.predict(X[:600], raw_score=True),
                                  four.predict(X[:600], raw_score=True))


def test_rollback_matches_jax_for_dart(one_thread):
    """DART subtracts the last trees from the scores (its drops changed
    them before the new trees), as the JAX package does."""
    params = dict(BASE, **BOOSTERS["dart"])
    X, y = make_data()
    port = trained(params, 5)
    ref = J.train(params, J.Dataset(X, y, params=DS), num_boost_round=5,
                  verbose_eval=False)
    port.rollback_one_iter()
    ref.rollback_one_iter()
    assert port.current_iteration() == ref.current_iteration() == 4
    np.testing.assert_allclose(
        port._booster.train_score.numpy(),
        np.asarray(ref._booster.train_score)[:, :N], rtol=0, atol=1e-5)


def assert_same_trees(ref_models, port_models, n):
    assert len(ref_models) == len(port_models)
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        nl = a.num_leaves
        assert b.num_leaves == nl, "tree %d" % i
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:nl - 1],
                                          getattr(a, name)[:nl - 1],
                                          err_msg="tree %d %s" % (i, name))
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        np.testing.assert_array_less(
            np.abs(b.leaf_value[:nl] - a.leaf_value[:nl]),
            leaf_value_tolerance(a, n))


CARRY = dict(BASE, bagging_fraction=0.8, bagging_freq=1,
             feature_fraction=0.8)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, one_thread):
    X, y = make_data()
    ref = J.train(dict(CARRY), J.Dataset(X, y, params=DS),
                  num_boost_round=6, verbose_eval=False)
    prefix = str(tmp_path / "j")
    with pytest.raises(Stop):
        J.train(dict(CARRY), J.Dataset(X, y, params=DS), num_boost_round=6,
                verbose_eval=False, checkpoint_prefix=prefix,
                callbacks=[stop_after(2)])
    assert [i for i, _ in ckpt.list_checkpoints(prefix)] == [2]
    port = P.train(dict(CARRY), P.Dataset(X, y, params=DS),
                   num_boost_round=6, verbose_eval=False, device="cpu",
                   checkpoint_prefix=prefix)
    assert port.current_iteration() == 6
    assert_same_trees(ref._booster.models, port._booster.models, N)


def test_port_checkpoint_resumes_in_jax(tmp_path, one_thread):
    X, y = make_data()
    ref = J.train(dict(CARRY), J.Dataset(X, y, params=DS),
                  num_boost_round=6, verbose_eval=False)
    prefix = str(tmp_path / "p")
    with pytest.raises(Stop):
        P.train(dict(CARRY), P.Dataset(X, y, params=DS), num_boost_round=6,
                verbose_eval=False, checkpoint_prefix=prefix,
                callbacks=[stop_after(2)], device="cpu")
    resumed = J.train(dict(CARRY), J.Dataset(X, y, params=DS),
                      num_boost_round=6, verbose_eval=False,
                      checkpoint_prefix=prefix)
    assert resumed.current_iteration() == 6
    assert_same_trees(ref._booster.models, resumed._booster.models, N)
