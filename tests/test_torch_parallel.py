"""The port's parallel tree learners against the JAX package's.

``lightgbm_tpu_torch.parallel`` runs one process per rank over a
``torch.distributed`` group; here each group is d processes on the CPU
(gloo, one torch thread each, ``tests/torch_parallel_ranks.py``), spawned
with ``torch.multiprocessing`` and joined by a deadline.  The ranks never
import ``jax``: the oracles, ``lightgbm_tpu.parallel``'s learners on
``default_mesh(d)`` of the 8 virtual CPU devices (``tests/conftest.py``),
run in this process.  On ``tests/test_parallel.py``'s problem (4000 x 11,
5% NaN, 63 bins, 15 leaves), at d = 2 and 4:

- every learner (``data``, ``feature``, ``voting`` with ``top_k=5``, and
  the ``psum`` learner) grows the JAX learner's tree: equal splits,
  thresholds and row leaves, leaf values within rtol 1e-4 and atol 1e-6
  (the allowance of ``tests/test_parallel.py`` for reduction order), and
  the port's serial tree within the same allowance;
- every rank holds the same tree, byte for byte;
- at world size 1 every learner gives the serial tree byte for byte;
- the factory's names and its serial choice at world size 1;
- ``GBDT`` end to end (4000 and 4003 rows, bagging): l2 within rel 2e-4 of
  serial and of the JAX data-parallel booster; quantized within rel 5e-2
  (``tests/test_hist_quant.py``'s band), and a quantized tree of every
  learner equal to the serial quantized tree: its integer sums cross the
  ranks exactly (as f32 below 2**24, where the JAX package sends bf16);
  forced splits through ``data`` take the psum learner
  (``tests/test_forced_cegb.py:142-160``);
- ``sharded_predict`` / ``sharded_predict_contrib`` equal one rank's
  predictor bit for bit, and the contributions equal the JAX package's
  (with the ``enable_x64`` shim of ``tests/test_torch_contrib.py``);
- only the write leader writes snapshots and emergency checkpoints;
- every rank's tree from the device build (``_DeviceGrowth``, one fetch a
  tree) equals its tree from the host loop (``host_loop=True``) byte for
  byte, two trees in a row, for ``data``, ``feature``, ``voting`` and
  ``psum``, exact and quantized, ``psum`` with forced splits and with CEGB
  (split, coupled and lazy penalties), and ``data`` with the histogram
  pool, whose device build reduces a histogram every step (zeros on a
  hit) where the host loop reduces only its misses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.parallel import (DataParallelTreeLearner as JData,
                                   FeatureParallelTreeLearner as JFeature,
                                   PartitionedDataParallelTreeLearner as JPsum,
                                   VotingParallelTreeLearner as JVoting,
                                   default_mesh)
from lightgbm_tpu_torch import BinnedDataset, Config
from lightgbm_tpu_torch.core.tree_learner import SerialTreeLearner
from lightgbm_tpu_torch.parallel import create_tree_learner

DS = (2, 4)
LEARNERS = ("data", "feature", "voting", "psum")
JAX_LEARNERS = {"data": (JData, {}), "feature": (JFeature, {}),
                "voting": (JVoting, {"top_k": 5}), "psum": (JPsum, {})}
PORT_CLASS = {"data": "DataParallelTreeLearner",
              "feature": "FeatureParallelTreeLearner",
              "voting": "VotingParallelTreeLearner",
              "psum": "PartitionedDataParallelTreeLearner",
              "serial": "SerialTreeLearner"}
# what jax.experimental holds before any test sets the shim
_ENABLE_X64 = getattr(jax.experimental, "enable_x64", None)

_RUNS = {}


def ranks(scenario, d, tmp_path_factory, arg=None):
    """The ranks' results of ``scenario`` on a d-rank group (one spawn per
    scenario and d for the whole module)."""
    key = (scenario, d)
    if key not in _RUNS:
        out = str(tmp_path_factory.mktemp("%s_%d" % (scenario, d)))
        _RUNS[key] = R.spawn(scenario, d, out, out if arg is None else arg)
    return _RUNS[key]


@pytest.fixture(scope="module")
def jax_problem():
    X, y, grad = R.problem()
    return JDataset.from_matrix(X, label=y, max_bin=63), jnp.asarray(grad)


_JAX_TREES = {}


def jax_tree(name, d, jax_problem):
    key = (name, d)
    if key not in _JAX_TREES:
        ds, grad = jax_problem
        cls, extra = JAX_LEARNERS[name]
        cfg = JConfig(**R.LEARNER_PARAMS, **extra)
        learner = cls(ds, cfg, mesh=default_mesh(d))
        a = jax.tree_util.tree_map(
            np.asarray, learner.train(grad, jnp.ones((R.N,), jnp.float32),
                                      R.N))
        _JAX_TREES[key] = (a, learner.feature_pad)
    return _JAX_TREES[key]


def assert_same_tree(got, want_nl, want_sf, want_thr, want_lv, want_rl):
    nl = got["num_leaves"]
    assert nl == want_nl
    np.testing.assert_array_equal(got["split_feature"], want_sf[:nl - 1])
    np.testing.assert_array_equal(got["threshold_bin"], want_thr[:nl - 1])
    np.testing.assert_allclose(got["leaf_value"], want_lv[:nl], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got["row_leaf"], want_rl[:R.N])


@pytest.mark.parametrize("name", LEARNERS)
@pytest.mark.parametrize("d", DS)
def test_learner_matches_jax_learner(d, name, jax_problem, tmp_path_factory):
    got = ranks("learners", d, tmp_path_factory)[0][(name, "exact")]
    want, _ = jax_tree(name, d, jax_problem)
    assert_same_tree(got, int(want.num_leaves), want.split_feature,
                     want.threshold_bin, want.leaf_value, want.row_leaf)


@pytest.mark.parametrize("name", LEARNERS)
@pytest.mark.parametrize("d", DS)
def test_learner_matches_serial(d, name, tmp_path_factory):
    res = ranks("learners", d, tmp_path_factory)[0]
    s = res[("serial", "exact")]
    assert res[(name, "exact")]["class"] == PORT_CLASS[name]
    assert_same_tree(res[(name, "exact")], s["num_leaves"],
                     s["split_feature"], s["threshold_bin"], s["leaf_value"],
                     s["row_leaf"])


@pytest.mark.parametrize("name", LEARNERS)
@pytest.mark.parametrize("d", DS)
def test_quantized_tree_equals_serial(d, name, tmp_path_factory):
    """Quantized gradients are integers with global scales and global row
    ids, so every rank's histograms are exact integer sums and their
    reduction is exact: the data, feature and psum learners grow the serial
    quantized tree to the bit (a bf16 payload, as the JAX package sends,
    breaks this).  Voting keeps dequantized local histograms and sums the
    elected ones in f32: its splits are serial's, its leaf values within
    the allowance of the exact learners."""
    res = ranks("learners", d, tmp_path_factory)[0]
    s, got = res[("serial", "quantized")], res[(name, "quantized")]
    if name == "voting":
        assert_same_tree(got, s["num_leaves"], s["split_feature"],
                         s["threshold_bin"], s["leaf_value"], s["row_leaf"])
        return
    for field in ("split_feature", "threshold_bin", "leaf_value",
                  "row_leaf"):
        np.testing.assert_array_equal(got[field], s[field], err_msg=field)


@pytest.mark.parametrize("d", DS)
def test_feature_pad(d, jax_problem, tmp_path_factory):
    """F = 11 pads to a multiple of d in the feature-sharded modes only, as
    the JAX learners pad it; no split lands on a pad feature."""
    res = ranks("learners", d, tmp_path_factory)[0]
    for name in LEARNERS:
        got = res[(name, "exact")]
        want = (-11) % d if name in ("data", "feature") else 0
        assert got["feature_pad"] == want, name
        assert got["feature_pad"] == jax_tree(name, d, jax_problem)[1]
        assert (got["split_feature"] < 11).all()


@pytest.mark.parametrize("d", DS)
def test_every_rank_holds_the_same_tree(d, tmp_path_factory):
    res = ranks("learners", d, tmp_path_factory)
    for key, rec in res[0].items():
        for other in res[1:]:
            for field, v in rec.items():
                if field in ("records", "calls", "bytes", "local_rows",
                             "kernel_calls"):
                    continue
                np.testing.assert_array_equal(np.asarray(other[key][field]),
                                              np.asarray(v),
                                              err_msg="%s %s" % (key, field))


@pytest.mark.parametrize("name", LEARNERS)
def test_world_size_one_is_serial_byte_for_byte(name, tmp_path_factory):
    """At world size 1 (the learner built directly on a one-rank group, as
    chip_smoke.py's path (V1) builds it) the tree and a 3-iteration model
    text's trees equal the serial learner's, byte for byte."""
    res = ranks("world_one", 1, tmp_path_factory)[0]
    for field, v in res["serial"].items():
        np.testing.assert_array_equal(res[name][field], v, err_msg=field)
    # the trees; the parameters footer holds each config's own keys
    cut = "\nparameters:"
    assert (res["texts"][name].split(cut)[0]
            == res["texts"]["serial"].split(cut)[0])


def test_factory_at_world_size_one(tmp_path_factory):
    res = ranks("world_one", 1, tmp_path_factory)[0]
    assert set(res["factory"].values()) == {"SerialTreeLearner"}


@pytest.mark.parametrize("d", DS)
def test_factory_names_under_a_group(d, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)[0]
    for lt in ("serial", "data", "feature", "voting"):
        assert res[("class", lt, "exact")] == PORT_CLASS[lt]


def test_factory_without_a_group_gives_serial():
    """No initialized process group: the serial learner, whatever the name
    (the JAX factory's one-device rule); an unknown name raises."""
    X, y, _ = R.problem()
    ds = BinnedDataset.from_matrix(X[:500], label=y[:500], max_bin=63)
    for lt in ("data", "feature", "voting"):
        learner = create_tree_learner(ds, Config(tree_learner=lt),
                                      device="cpu")
        assert type(learner) is SerialTreeLearner
    cfg = Config()
    cfg.tree_learner = "gossip"
    with pytest.raises(ValueError, match="Unknown tree learner type gossip"):
        create_tree_learner(ds, cfg, device="cpu")


def test_serial_learner_ignores_the_tree_learner_key():
    """SerialTreeLearner built with tree_learner=data grows the serial tree
    (the JAX class ignores the key; the factory chooses the learner)."""
    X, y, grad = R.problem()
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    g, h = torch.as_tensor(grad), torch.ones(R.N)
    trees = [R.tree_fields(SerialTreeLearner(
        ds, Config(tree_learner=lt, **R.LEARNER_PARAMS),
        device="cpu").train(g, h, R.N)) for lt in ("serial", "data")]
    for field, v in trees[0].items():
        np.testing.assert_array_equal(trees[1][field], v, err_msg=field)


@pytest.mark.parametrize("lt", ["data", "feature", "voting"])
@pytest.mark.parametrize("d", DS)
def test_gbdt_l2_matches_serial(d, lt, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)[0]
    want = res[("l2", "serial", "exact")]
    assert res[("l2", lt, "exact")] == pytest.approx(want, rel=2e-4)


@pytest.mark.parametrize("d", DS)
def test_gbdt_l2_matches_jax_data_parallel(d, tmp_path_factory):
    from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
    from lightgbm_tpu.objective import create_objective as jobj
    X, y, _ = R.problem()
    ds = JDataset.from_matrix(X, label=y, max_bin=63)
    cfg = JConfig(objective="regression", tree_learner="data", num_leaves=7,
                  num_iterations=5, learning_rate=0.2, metric="l2")
    b = JGBDT(cfg, ds, jobj("regression", cfg), mesh=default_mesh(d))
    for _ in range(5):
        b.train_one_iter()
    want = float(np.mean((y - np.asarray(b.train_score[0, :R.N])) ** 2))
    got = ranks("boosting", d, tmp_path_factory)[0][("l2", "data", "exact")]
    assert got == pytest.approx(want, rel=2e-4)


@pytest.mark.parametrize("d", DS)
def test_gbdt_indivisible_rows_with_bagging(d, tmp_path_factory):
    """4003 rows (no multiple of d) with bagging: the padded stripes, the
    bag mask on every rank, three trees, l2 within rel 2e-4 of serial."""
    res = ranks("boosting", d, tmp_path_factory)[0]
    assert res[("bag_class", "data")] == "DataParallelTreeLearner"
    assert res[("bag_trees", "data")] == 3
    assert res[("bag_l2", "data")] == pytest.approx(res[("bag_l2", "serial")],
                                                    rel=2e-4)


@pytest.mark.parametrize("d", DS)
def test_quantized_data_parallel(d, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)[0]
    want = res[("l2", "serial", "quantized")]
    for lt in ("data", "feature", "voting"):
        assert res[("l2", lt, "quantized")] == pytest.approx(want, rel=5e-2)
    # feature mode sums nothing across the ranks: serial's model exactly
    cut = "\nparameters:"
    assert (res[("text", "feature", "quantized")].split(cut)[0]
            == res[("text", "serial", "quantized")].split(cut)[0])


@pytest.mark.parametrize("d", DS)
def test_forced_splits_take_the_psum_learner(d, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)[0]
    assert res["forced_class"] == "PartitionedDataParallelTreeLearner"
    assert len(res["forced_roots"]) == 8
    for feat, thr in res["forced_roots"]:
        assert feat == 5 and abs(thr - 0.25) < 0.1


@pytest.mark.parametrize("d", DS)
def test_model_text_equal_on_every_rank(d, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)
    for key, v in res[0].items():
        if isinstance(key, tuple) and key[0] in ("text", "bag_text"):
            for other in res[1:]:
                assert other[key] == v, key


@pytest.mark.parametrize("d", DS)
def test_sharded_predict_equals_predict(d, tmp_path_factory):
    for r in ranks("boosting", d, tmp_path_factory):
        np.testing.assert_array_equal(r["predict_sharded"],
                                      r["predict_single"])
        np.testing.assert_array_equal(r["contrib_sharded"],
                                      r["contrib_single"])


@pytest.mark.parametrize("d", DS)
def test_sharded_contrib_matches_jax(d, tmp_path_factory, monkeypatch):
    from lightgbm_tpu.basic import Booster as JBooster
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    r = ranks("boosting", d, tmp_path_factory)[0]
    Xq = np.random.RandomState(11).normal(size=(1001, R.F))
    Xq[::7, 3] = np.nan
    ref = JBooster(model_str=r["predict_text"])
    want = ref.predict(np.asarray(Xq[:203], np.float32), pred_contrib=True)
    np.testing.assert_allclose(r["contrib_sharded"], want, rtol=1e-12,
                               atol=1e-15)


def test_shim_is_undone():
    assert getattr(jax.experimental, "enable_x64", None) is _ENABLE_X64


@pytest.mark.parametrize("d", DS)
def test_engine_train_under_a_group(d, tmp_path_factory):
    """``lightgbm_tpu_torch.train`` with ``tree_learner=data``, a validation
    set and a checkpoint prefix under the group: the data-parallel learner,
    one model and one validation curve on every rank, checkpoints written by
    rank 0 alone while training runs."""
    res = ranks("boosting", d, tmp_path_factory)
    assert res[0]["engine_class"] == "DataParallelTreeLearner"
    assert len(res[0]["engine_l2"]) == 4
    for r in res[1:]:
        assert r["engine_text"] == res[0]["engine_text"]
        assert r["engine_l2"] == res[0]["engine_l2"]
        assert not any(r["engine_ckpts"])
    # the callback runs before each iteration's checkpoint: iteration k
    # sees the k - 1 written before it
    assert [len(c) for c in res[0]["engine_ckpts"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("d", DS)
def test_only_the_write_leader_writes(d, tmp_path_factory):
    res = ranks("boosting", d, tmp_path_factory)
    files = res[0]["files"]
    assert any(f.startswith("snap_r0.snapshot_iter_5") for f in files)
    assert any(f.startswith("emergency_r0") for f in files)
    assert res[0]["emergency_path"] is not None
    for r in range(1, d):
        assert res[r]["emergency_path"] is None
        assert not any(f.startswith(("snap_r%d" % r, "emergency_r%d" % r))
                       for f in files), files


DEVICE_CASES = list(R.DEVICE_CASES)


@pytest.mark.parametrize("case", DEVICE_CASES,
                         ids=["-".join(c) for c in DEVICE_CASES])
@pytest.mark.parametrize("d", DS)
def test_device_build_equals_host_loop_on_every_rank(d, case,
                                                     tmp_path_factory):
    """Each rank's device-built trees equal its host-loop trees byte for
    byte (every TreeArrays field, the gathered row leaves, the lazy paid
    bits and the pool's misses), with one fetch and L - 1 split passes a
    tree where the host loop fetched once a split; both builds run the same
    collectives, but for the pool's rebuilds."""
    L = R.LEARNER_PARAMS["num_leaves"]
    for rank, res in enumerate(ranks("device_vs_host", d, tmp_path_factory)):
        r = res[case]
        assert r["equal"] == [True, True], (rank, r)
        assert r["fetches"] == [1, 1] and r["passes"] == [L - 1] * 2
        assert all(h >= n > 2 for h, n in zip(r["host_fetches"],
                                               r["num_leaves"]))
        dev, host = r["calls"]
        if case == ("data", "pool"):
            # a reduce-scatter every step on the device, a miss's alone in
            # the host loop
            assert sum(r["misses"]) > 0 and r["pool_slots"] >= 2
            assert dev["reduce_scatter"] == 2 * (1 + 2 * (L - 1))
            assert host["reduce_scatter"] == 2 * L + sum(r["misses"])
            fp = R.F + (-R.F) % d
            extra = dev["reduce_scatter"] - host["reduce_scatter"]
            assert (r["bytes"][0]["reduce_scatter"]
                    - r["bytes"][1]["reduce_scatter"]) == extra * fp * 2 \
                * 64 * 4
        else:
            assert dev == host
        if case == ("psum", "forced"):
            assert r["class"] == "PartitionedDataParallelTreeLearner"
            # the root takes the schedule's threshold, not the scan's
            assert {f for f, _ in r["roots"]} == {0}
            assert r["roots"] != res[("psum", "exact")]["roots"]
        if case == ("psum", "cegb"):
            assert all(p > 0 for p in r["paid"])
