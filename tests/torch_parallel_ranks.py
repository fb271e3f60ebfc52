"""The rank side of the port's multi-process tests (``tests/
test_torch_parallel.py``, ``tests/test_torch_comm.py``,
``tests/test_torch_obs_plane.py``).

Each rank is a process started by :func:`spawn` with ``torch.multiprocessing``
(the spawn context), one torch thread, in a gloo group on the CPU.  This
module imports ``torch`` and ``lightgbm_tpu_torch`` only, never ``jax``: the
JAX oracles run in the pytest process.  A scenario returns a picklable dict,
which the parent reads back from a file per rank.  :func:`spawn` joins the
ranks by a deadline and kills them past it, so a deadlocked collective fails
one test instead of hanging the suite.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import time
import traceback
from datetime import timedelta

import numpy as np

N, F = 4000, 11          # tests/test_parallel.py's problem
LEARNER_PARAMS = dict(num_leaves=15)


def problem():
    """tests/test_parallel.py's problem: 4000 x 11, 5% NaN, regression
    gradients of the centred label (hessians 1)."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(N, F))
    X[rng.uniform(size=(N, F)) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) * 1.5 + np.nan_to_num(X[:, 1]) ** 2
         + rng.normal(scale=0.1, size=N))
    grad = (y - y.mean()).astype(np.float32) * np.float32(-1.0)
    return X, y, grad


def indivisible():
    """tests/test_parallel.py's 4003 x 5 regression (rows no multiple of
    the ranks)."""
    rng = np.random.RandomState(3)
    X = rng.normal(size=(4003, 5))
    y = X[:, 0] + rng.normal(scale=0.1, size=4003)
    return X, y


def forced_data():
    """tests/test_forced_cegb.py's 5000 x 6 regression."""
    rng = np.random.RandomState(13)
    X = rng.normal(size=(5000, 6)).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] + 0.4 * X[:, 3]
         + rng.normal(scale=0.4, size=5000))
    return X, y


def tree_fields(a) -> dict:
    """The comparable part of a port TreeArrays, as numpy."""
    nl = int(a.num_leaves)
    return {"num_leaves": nl,
            "split_feature": np.asarray(a.split_feature[:nl - 1]),
            "threshold_bin": np.asarray(a.threshold_bin[:nl - 1]),
            "split_gain": np.asarray(a.split_gain[:nl - 1]),
            "leaf_value": np.asarray(a.leaf_value[:nl]),
            "leaf_count": np.asarray(a.leaf_count[:nl]),
            "row_leaf": a.row_leaf.cpu().numpy()}


# ---- scenarios (run on every rank) ----

def _learner_classes():
    from lightgbm_tpu_torch.core.tree_learner import SerialTreeLearner
    from lightgbm_tpu_torch.parallel import (
        DataParallelTreeLearner, FeatureParallelTreeLearner,
        PartitionedDataParallelTreeLearner, VotingParallelTreeLearner)
    return {"serial": (SerialTreeLearner, {}),
            "data": (DataParallelTreeLearner, {}),
            "feature": (FeatureParallelTreeLearner, {}),
            "voting": (VotingParallelTreeLearner, {"top_k": 5}),
            "psum": (PartitionedDataParallelTreeLearner, {})}


def learners(rank, d, arg):
    """One tree of every learner on the problem, exact and quantized: the
    tree, the feature padding and the comm's counts and records."""
    import torch

    from lightgbm_tpu_torch import BinnedDataset, Config
    X, y, grad = problem()
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    g = torch.as_tensor(grad)
    h = torch.ones(N)
    out = {}
    for name, (cls, extra) in _learner_classes().items():
        for prec in ("exact", "quantized"):
            cfg = Config(hist_precision=prec, **LEARNER_PARAMS, **extra)
            learner = cls(ds, cfg, device="cpu")
            arrays = learner.train(g, h, N)
            rec = tree_fields(arrays)
            rec["feature_pad"] = getattr(learner, "feature_pad", 0)
            rec["class"] = type(learner).__name__
            if learner.comm is not None:
                ops = learner.comm.ops
                rec["calls"] = dict(ops.calls)
                rec["bytes"] = dict(ops.bytes)
                rec["records"] = list(ops.records)
                rec["local_rows"] = int(learner.template.shape[0]
                                        - 4096)
            out[(name, prec)] = rec
    # the kernels' calls of feature mode, through recording plain versions:
    # the root histogram and every split pass over the rank's F/d window
    from lightgbm_tpu_torch.core.histogram import histogram_rows_plain
    from lightgbm_tpu_torch.core.partition import (
        partition_hist_window_plain)
    from lightgbm_tpu_torch.parallel import FeatureParallelTreeLearner
    calls = []

    def hist_fn(rows, num_bins, start, count, **kw):
        h = histogram_rows_plain(rows, num_bins, start, count, **kw)
        calls.append(("hist", kw.get("f_begin", 0), tuple(h.shape)))
        return h

    def window_fn(rows, scal, work=None, **kw):
        res = partition_hist_window_plain(rows, scal, work, **kw)
        calls.append(("part", int(scal[-1]), len(scal), tuple(res[0].shape)))
        return res
    learner = FeatureParallelTreeLearner(ds, Config(**LEARNER_PARAMS),
                                         device="cpu")
    rec = tree_fields(learner.train(g, h, N, hist_fn=hist_fn,
                                    window_fn=window_fn))
    rec["kernel_calls"] = calls
    out[("feature", "recorded")] = rec
    return out


def _l2(booster, y) -> float:
    pred = booster.train_score[0].double().cpu().numpy()
    return float(np.mean((y - pred) ** 2))


def _gbdt(X, y, params, iters, max_bin=63):
    from lightgbm_tpu_torch import BinnedDataset, Config, GBDT
    from lightgbm_tpu_torch.objective import create_objective
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=max_bin)
    cfg = Config(**params)
    b = GBDT(cfg, ds, create_objective(cfg.objective, cfg, device="cpu"),
             device="cpu")
    for _ in range(iters):
        b.train_one_iter()
    return b


_CKPTS = {}


def _list_checkpoints(arg, rank):
    """A train() callback recording, after each iteration, this rank's
    checkpoint files."""
    _CKPTS[rank] = []

    def record(env):
        _CKPTS[rank].append(sorted(f for f in os.listdir(arg)
                                   if f.startswith("ckpt_r%d" % rank)))
    return record


def boosting(rank, d, arg):
    """GBDT through the factory under the group: the end-to-end losses of
    the parallel learners and of serial, bagging at 4003 rows, quantized,
    forced splits, sharded prediction, the write leader."""
    from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
    from lightgbm_tpu_torch.resilience import emergency_checkpoint
    out = {}
    X, y, _ = problem()
    base = dict(objective="regression", num_leaves=7, learning_rate=0.2,
                metric="l2", verbosity=-1)
    for lt in ("serial", "data", "feature", "voting"):
        for prec in ("exact", "quantized"):
            b = _gbdt(X, y, dict(base, tree_learner=lt, hist_precision=prec,
                                 top_k=5), 5)
            out[("l2", lt, prec)] = _l2(b, y)
            out[("class", lt, prec)] = type(b.learner).__name__
            out[("text", lt, prec)] = b.save_model_to_string()
    Xi, yi = indivisible()
    for lt in ("serial", "data"):
        b = _gbdt(Xi, yi, dict(objective="regression", tree_learner=lt,
                               num_leaves=7, bagging_fraction=0.8,
                               bagging_freq=1, verbosity=-1), 3, max_bin=32)
        out[("bag_l2", lt)] = _l2(b, yi)
        out[("bag_trees", lt)] = b.num_trees
        out[("bag_class", lt)] = type(b.learner).__name__
        out[("bag_text", lt)] = b.save_model_to_string()
    # forced splits through tree_learner=data: the psum learner
    Xf, yf = forced_data()
    fname = os.path.join(arg, "forced.json")
    if rank == 0:
        with open(fname + ".tmp", "w") as fh:
            json.dump({"feature": 5, "threshold": 0.25}, fh)
        os.replace(fname + ".tmp", fname)
    import torch.distributed as dist
    dist.barrier()
    b = _gbdt(Xf, yf, dict(objective="regression", num_leaves=15,
                           learning_rate=0.2, tree_learner="data",
                           forcedsplits_filename=fname, verbosity=-1), 8)
    out["forced_class"] = type(b.learner).__name__
    out["forced_roots"] = [(int(t.split_feature[0]), float(t.threshold[0]))
                           for t in b.models]
    # sharded prediction of a data-parallel booster vs one rank's predictor
    bp = _gbdt(X, y, dict(base, tree_learner="data"), 5)
    Xq = np.random.RandomState(11).normal(size=(1001, F))
    Xq[::7, 3] = np.nan
    trees = bp.models
    single = FusedPredictor(trees, device="cpu")
    out["predict_sharded"] = bp.predict(Xq, raw_score=True)
    out["predict_single"] = single(Xq)
    Xc = np.asarray(Xq[:203], np.float32)
    out["contrib_sharded"] = bp.predict_contrib(Xc)
    out["contrib_single"] = single.predict_contrib(Xc, F + 1)
    out["predict_text"] = bp.save_model_to_string()
    # train() with a validation set and a checkpoint prefix: every rank
    # runs the same loop; rank 0 alone writes the checkpoints
    import lightgbm_tpu_torch as lgb
    evals = {}
    prefix = os.path.join(arg, "ckpt_r%d" % rank)
    bt = lgb.train(dict(base, tree_learner="data", snapshot_freq=1),
                   lgb.Dataset(X[:3000], y[:3000], params={"max_bin": 63}),
                   num_boost_round=4,
                   valid_sets=[lgb.Dataset(X[3000:], y[3000:],
                                           params={"max_bin": 63})],
                   valid_names=["valid"], evals_result=evals,
                   verbose_eval=False, checkpoint_prefix=prefix,
                   callbacks=[_list_checkpoints(arg, rank)], device="cpu")
    out["engine_text"] = bt.model_to_string()
    out["engine_l2"] = evals["valid"]["l2"]
    out["engine_class"] = type(bt._booster.learner).__name__
    out["engine_ckpts"] = _CKPTS[rank]
    # only the write leader writes snapshots and emergency checkpoints
    bp._write_snapshot(os.path.join(arg, "snap_r%d" % rank))
    path, _ = emergency_checkpoint(bp, os.path.join(arg,
                                                    "emergency_r%d" % rank))
    out["emergency_path"] = path
    dist.barrier()
    out["files"] = sorted(os.listdir(arg))
    return out


def world_one(rank, d, arg):
    """World size 1: every learner, built directly on the one-rank group,
    against the serial learner; the factory's choice."""
    import torch

    from lightgbm_tpu_torch import BinnedDataset, Config
    from lightgbm_tpu_torch.parallel import create_tree_learner
    X, y, grad = problem()
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    g, h = torch.as_tensor(grad), torch.ones(N)
    out = {}
    for name, (cls, extra) in _learner_classes().items():
        cfg = Config(**LEARNER_PARAMS, **extra)
        out[name] = tree_fields(cls(ds, cfg, device="cpu").train(g, h, N))
    out["factory"] = {
        lt: type(create_tree_learner(ds, Config(tree_learner=lt),
                                     device="cpu")).__name__
        for lt in ("serial", "data", "feature", "voting")}
    X2, y2, _ = problem()
    base = dict(objective="regression", num_leaves=7, learning_rate=0.2,
                verbosity=-1)
    texts = {}
    from lightgbm_tpu_torch import GBDT
    from lightgbm_tpu_torch.objective import create_objective
    for name, (cls, extra) in _learner_classes().items():
        cfg = Config(**base, **extra)
        b = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
                 device="cpu")
        if name != "serial":
            b.learner = cls(ds, cfg, device="cpu")
        for _ in range(3):
            b.train_one_iter()
        texts[name] = b.save_model_to_string()
    out["texts"] = texts
    return out


def comm_and_data(rank, d, arg):
    """The comm's own collectives, the loader's default allgather over the
    group, distdata's stripes and digest."""
    import torch

    from lightgbm_tpu_torch.io.loader import DatasetLoader, _default_allgather
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.parallel import ProcessComm, distdata
    ops = ProcessComm(device="cpu")
    out = {"pod": distdata.pod_info()}
    x = torch.arange(6, dtype=torch.float32) + rank
    out["sum"] = ops.all_reduce_sum(x).numpy()
    out["max"] = ops.all_reduce_max(x).numpy()
    h = torch.arange(4 * d * 2 * 3, dtype=torch.float32).reshape(
        4 * d, 2, 3) * (rank + 1)
    out["rs"] = ops.reduce_scatter_features(h).numpy()
    out["gather"] = ops.all_gather(x[None] * 0 + rank).numpy()
    out["bytes"] = ops.all_gather_bytes(b"r%d" % rank + b"x" * rank)
    out["default_allgather"] = _default_allgather(d)(b"rank%d" % rank)
    out["summary"] = ops.summary()
    # default_group: the default group, or a subgroup of the first ranks
    # (new_group is collective: every rank calls it)
    from lightgbm_tpu_torch.parallel import default_group
    sub = default_group(1)
    out["default_group"] = default_group() is None
    out["subgroup_size"] = (ProcessComm(sub, device="cpu").size if rank == 0
                            else None)
    # a CSV loaded by every rank: feature-sharded bin finding through the
    # default allgather, and the striped streaming scan (schema agreed)
    path = os.path.join(arg, "train.csv")
    cfg = Config(num_machines=d, max_bin=63, verbosity=-1,
                 pre_partition=True)
    ds = DatasetLoader(cfg).load_from_file(path, rank, d)
    out["mappers"] = [m.to_dict() for m in ds.bin_mappers]
    out["num_data"] = ds.num_data
    cfg2 = Config(num_machines=d, max_bin=63, verbosity=-1,
                  data_chunk_rows=500, pre_partition=False)
    ds2 = DatasetLoader(cfg2).load_from_file(path, rank, d)
    out["stream_shard"] = distdata.shard_of(ds2)
    out["stream_digest"] = distdata.schema_digest(
        ds2, total_rows=ds2.shard["num_total"])
    out["stream_mappers"] = [m.to_dict() for m in ds2.bin_mappers]
    out["stream_binned"] = np.asarray(ds2.binned)
    # a forced mismatch: this rank's digest against a doctored one
    try:
        distdata.verify_schema(ds2, lambda p: [p, b"00000000"][:d],
                               total_rows=ds2.shard["num_total"])
        out["mismatch"] = ""
    except Exception as exc:  # noqa: BLE001 - the message is the result
        out["mismatch"] = "%s: %s" % (type(exc).__name__, exc)
    return out


def telemetry_shards(rank, d, arg):
    """A data-parallel ``train`` with ``telemetry_out``: the rank comes
    from the group, each rank writes its own shard, rank 0 alone the
    summary."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    X, y = indivisible()
    base = os.path.join(arg, "pod.jsonl")
    lgb.train({"objective": "regression", "num_leaves": 7, "verbosity": -1,
               "tree_learner": "data", "telemetry_out": base},
              lgb.Dataset(X, y), 3, device="cpu")
    return {"ranks": sorted({e.get("rank") for e in obs.read_events(
                obs.shard_path(base, rank))}),
            "launches": obs.launches.counts()}


def _same_arrays(a, b) -> bool:
    """Two TreeArrays equal in every field the builds share (the per-row
    tensors included), byte for byte."""
    import torch
    for f in a._fields:
        if f in ("host_fetches", "split_passes"):
            continue
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if (x is None) != (y is None) or (x is not None
                                              and not torch.equal(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


# the device build against the host loop: (learner, precision, extra
# params); the forced schedule is tests/test_forced_cegb.py's
DEVICE_CASES = {
    **{(name, prec): (name, prec, {})
       for name in ("data", "feature", "voting", "psum")
       for prec in ("exact", "quantized")},
    ("psum", "forced"): ("psum", "exact", {"forced": True}),
    ("psum", "cegb"): ("psum", "exact", {
        "cegb_penalty_split": 0.002,
        "cegb_penalty_feature_coupled": [3.0] * F,
        "cegb_penalty_feature_lazy": [0.05] * F}),
    ("data", "pool"): ("data", "exact", {"histogram_pool_size": 0.02}),
}
FORCED_SPEC = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.5},
               "right": {"feature": 1, "threshold": 0.5}}


def device_vs_host(rank, d, arg):
    """Every learner's tree from the device build and from the host loop
    (``host_loop=True``, a fresh learner each, so CEGB's state starts
    alike), two trees in a row: whether they are equal byte for byte, the
    fetches of each, the pool's misses and the comm's counts of each."""
    import torch

    from lightgbm_tpu_torch import BinnedDataset, Config
    X, y, grad = problem()
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    g = torch.as_tensor(grad)
    h = torch.ones(N)
    forced = os.path.join(arg, "forced_r%d.json" % rank)
    with open(forced, "w") as fh:
        json.dump(FORCED_SPEC, fh)
    classes = _learner_classes()
    out = {}
    for key, (name, prec, extra) in DEVICE_CASES.items():
        cls, base = classes[name]
        params = dict(LEARNER_PARAMS, hist_precision=prec, **base)
        for k, v in extra.items():
            if k == "forced":
                params["forcedsplits_filename"] = forced
            else:
                params[k] = v
        builds = {}
        for build in ("device", "host"):
            learner = cls(ds, Config(**params), device="cpu")
            learner.comm.ops.reset()
            trees = [learner.train(g * s, h, N,
                                   host_loop=build == "host")
                     for s in (1.0, 0.5)]
            builds[build] = (trees, dict(learner.comm.ops.calls),
                             dict(learner.comm.ops.bytes),
                             type(learner).__name__,
                             learner.hist_pool_slots)
        dev, host = builds["device"], builds["host"]
        out[key] = {
            "equal": [_same_arrays(a, b) for a, b in zip(dev[0], host[0])],
            "fetches": [t.host_fetches for t in dev[0]],
            "host_fetches": [t.host_fetches for t in host[0]],
            "passes": [t.split_passes for t in dev[0]],
            "num_leaves": [t.num_leaves for t in dev[0]],
            "misses": [t.pool_misses for t in dev[0]],
            "paid": [None if t.paid_bits is None
                     else int(t.paid_bits.bool().sum()) for t in dev[0]],
            "calls": (dev[1], host[1]), "bytes": (dev[2], host[2]),
            "class": dev[3], "pool_slots": dev[4],
            "roots": [(int(t.split_feature[0]), int(t.threshold_bin[0]))
                      for t in dev[0]]}
    return out


def lazy_loop(rank, d, arg):
    """The asynchronous loop on the ``rs`` learner (``tree_learner=data``,
    built directly, as at world size 1 the factory gives the serial one):
    ``arg`` iterations of ``train_one_iter`` with a validation set, lazy and
    with forced materialization (the stall poll every iteration, ``models``
    read after each), then the trailing poll; each run's model text, score
    bytes, host reads and iteration, so that the ranks can be held to one
    poll schedule."""
    from lightgbm_tpu_torch import BinnedDataset, Config, GBDT
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.parallel.learners import DataParallelTreeLearner
    X, y, _ = problem()
    yb = (y > np.median(y)).astype(np.float64)
    ds = BinnedDataset.from_matrix(X, label=yb, max_bin=63)
    vds = BinnedDataset.from_matrix(X[:300], label=yb[:300], reference=ds)
    cfg = Config(objective="binary", num_leaves=7, learning_rate=0.2,
                 tree_learner="data", verbosity=-1)
    out = {}
    for forced in (False, True):
        b = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                 device="cpu")
        b.learner = DataParallelTreeLearner(ds, cfg, device="cpu")
        b.add_valid_data(vds, "valid_1")
        if forced:
            b._poll_freq = 1
        for _ in range(arg):
            b.train_one_iter()
            if forced:
                b.models
        if b._nl_handles:
            b._poll_stop()      # the trailing poll, as train() ends
        text = b.save_model_to_string()
        out["forced" if forced else "lazy"] = dict(
            text=text, reads=b.host_reads, iter=b.iter_,
            score=b.train_score.numpy().tobytes(),
            valid=b.valid_sets[0]["score"].numpy().tobytes())
    return out


SCENARIOS = {"learners": learners, "boosting": boosting,
             "world_one": world_one, "comm_and_data": comm_and_data,
             "telemetry_shards": telemetry_shards,
             "device_vs_host": device_vs_host, "lazy_loop": lazy_loop}


# ---- process plumbing ----

def _rank_main(rank, d, port, scenario, arg, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    try:
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                                % port, rank=rank, world_size=d,
                                timeout=timedelta(seconds=120))
        try:
            result = {"ok": SCENARIOS[scenario](rank, d, arg)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = {"error": traceback.format_exc()}
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, d: int, out_dir: str, arg=None,
          deadline_s: float = 240.0) -> list:
    """Run ``scenario`` on ``d`` ranks of a gloo group; returns the ranks'
    results in rank order.  Past ``deadline_s`` the ranks are killed and
    the call raises: a deadlock fails here, it never hangs the run."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, d, port, scenario, arg, out_dir),
                         daemon=True) for r in range(d)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError("%s on %d ranks: ranks %s still running after "
                             "%.0f s (killed)" % (scenario, d, hung,
                                                  deadline_s))
    results = []
    for r in range(d):
        with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as fh:
            res = pickle.load(fh)
        if "error" in res:
            raise AssertionError("rank %d of %d failed:\n%s"
                                 % (r, d, res["error"]))
        results.append(res["ok"])
    return results
