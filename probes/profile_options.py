"""Profiles of the leaf-wise device build against the host loop on the
card: where a tree's time goes for (N)'s forced splits and CEGB and for
(O)'s histogram pool.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/profile_options.py [--path N|O|both]

``N``: (A)'s task (1,048,576 rows x 28), tree 0 grown 3 times by each
build under (N)'s settings one option at a time (none, forced splits,
split + coupled CEGB, lazy CEGB, all) with the seconds of each tree, then
a ``torch.profiler`` table of one device-built tree with all of them;
then the pool's step captured in a CUDA graph at 100,000 x 200 with 2 MB
of slots, exact and quantized (``chip_smoke.regrow_tree0``).  ``O``:
(D)'s shape (400,000 x 2000, bins from 25,000 sampled rows) with (O)'s
pool, tree 0 grown 3 times by each build, then a profiler table of one
tree of each.  Each table is sorted by device time and by host time.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def trees(learner, g, h, n, reset=None):
    """Seconds of 3 trees of each build (ending in a synchronise)."""
    out = {}
    for build in ("device", "host loop"):
        ts = []
        for _ in range(3):
            if reset is not None:
                reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            learner.train(g, h, n, host_loop=build == "host loop")
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        out[build] = ["%.3f" % v for v in ts]
    return out


def table(learner, g, h, n, host_loop=False):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        learner.train(g, h, n, host_loop=host_loop)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    print(ka.table(sort_by="cpu_time_total", row_limit=25), flush=True)


def path_n(C) -> None:
    from lightgbm_tpu_torch import (BinnedDataset, Config, GBDT,
                                    create_objective)
    n = 1 << 20
    X, y, _, _ = C.synthetic_task(n)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    med = [float(np.median(X[:, f])) for f in (25, 26)]
    spec = {"feature": 25, "threshold": med[0],
            "left": {"feature": 26, "threshold": med[1]},
            "right": {"feature": 26, "threshold": med[1]}}
    F = ds.num_features
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "forced.json")
        with open(fname, "w") as fh:
            json.dump(spec, fh)
        coupled = dict(cegb_penalty_split=1e-5,
                       cegb_penalty_feature_coupled=[2.0] * F)
        lazy = dict(cegb_penalty_feature_lazy=[1e-5] * F)
        variants = {"none": {}, "forced": dict(forcedsplits_filename=fname),
                    "split+coupled": coupled, "lazy": lazy,
                    "all": dict(forcedsplits_filename=fname, **coupled,
                                **lazy)}
        for name, extra in variants.items():
            cfg = Config(**extra, **C.HIGGS_PARAMS)
            b = GBDT(cfg, ds, create_objective("binary", cfg))
            lr = b.learner
            g, h = C.initial_gradients(b, n)

            def reset():
                if lr.cegb is not None:
                    lr.restore_cegb_state(np.zeros(F, bool), np.zeros(
                        (n, lr.layout.bitbytes), np.uint8))
            print("(N) %s: seconds a tree %s" % (name, trees(lr, g, h, n,
                                                            reset)),
                  flush=True)
            if name == "all":
                reset()
                table(lr, g, h, n)
            del b, lr
            torch.cuda.empty_cache()
    Xw = np.random.RandomState(3).normal(size=(100000, 200)).astype(
        np.float32)
    yw = (Xw[:, 0] + Xw[:, 1] * Xw[:, 2] > 0).astype(np.float64)
    dw = BinnedDataset.from_matrix(Xw, label=yw, max_bin=255)
    for prec in ("exact", "quantized"):
        cfg = Config(histogram_pool_size=2, hist_precision=prec,
                     **C.HIGGS_PARAMS)
        b = GBDT(cfg, dw, create_objective("binary", cfg))
        print("pool, %s, %d slots, the step in a CUDA graph: %s"
              % (prec, b.learner.hist_pool_slots,
                 C.regrow_tree0(b, graph=True)), flush=True)


def path_o(C) -> None:
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    n = 400_000
    X, y, _, _ = C.epsilon_task(n, 1000, torch.device("cuda"))
    t = time.perf_counter()
    ds = lgb.Dataset(X, y, params=dict(
        max_bin=255, bin_construct_sample_cnt=C.EPSILON_BIN_SAMPLE,
        verbosity=-1)).construct().handle
    print("binning %.1f s" % (time.perf_counter() - t), flush=True)
    cfg = Config(histogram_pool_size=C.POOL_MB, **C.EPSILON_PARAMS)
    b = GBDT(cfg, ds, create_objective("binary", cfg))
    lr = b.learner
    g, h = C.initial_gradients(b, n)
    print("(O): seconds a tree %s" % trees(lr, g, h, n), flush=True)
    for host_loop in (False, True):
        print("===== (O) %s" % ("host loop" if host_loop else "device"),
              flush=True)
        table(lr, g, h, n, host_loop)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("N", "O", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_options: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.utils.log import Log
    print(C.gpu_name_and_power(), flush=True)
    kernels.build()
    Log.reset_level(Log.level_from_verbosity(-1))
    if args.path in ("N", "both"):
        path_n(C)
    if args.path in ("O", "both"):
        path_o(C)
    return 0


if __name__ == "__main__":
    sys.exit(main())
