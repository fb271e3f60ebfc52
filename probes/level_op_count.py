"""Operator calls a level step issues, level growth on the device against
the host loop, outside the level pass itself.

Runs on the CPU (a count, not a time)::

    python3 probes/level_op_count.py [--rows 50000]

It grows one 255-leaf ``tree_grow_mode=level`` tree of chip_smoke.py's
Higgs-shaped task (28 features, 255 bins), exact and quantized, once on the
device build (``_DeviceGrowth.level_step``) and once in the host loop
(``_Growth.split_level``), and counts the aten operator calls of each level
step with a ``TorchDispatchMode``, less those inside the level pass (on the
card one kernel call either way; on the CPU the plain versions).  Each call
is at least one kernel launch on the card.  Prints one JSON object: per
precision and build, the calls of each level and the tree's leaves.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.getcwd())


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=50_000)
    args = ap.parse_args()
    torch.set_num_threads(1)
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, Config
    from lightgbm_tpu_torch.core import tree_learner as TL
    from lightgbm_tpu_torch.utils.log import Log
    Log.reset_level(Log.level_from_verbosity(-1))
    n = args.rows
    X, y, _, _ = C.synthetic_task(n)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    grad = torch.from_numpy((0.5 - (y > 0)).astype(np.float32))
    hess = torch.full((n,), 0.25)
    inside = [0]

    def counted(fn):
        def call(*a, **k):
            with Count() as c:
                out = fn(*a, **k)
            inside[0] += c.n
            return out
        return call

    def per_level(step, calls):
        def run(self, *a):
            inside[0] = 0
            with Count() as c:
                out = step(self, *a)
            calls.append(c.n - inside[0])
            return out
        return run

    out = {}
    for precision in ("exact", "quantized"):
        cfg = Config(objective="binary", num_leaves=255, max_bin=255,
                     verbosity=-1, tree_grow_mode="level",
                     hist_precision=precision)
        learner = TL.SerialTreeLearner(ds, cfg, device="cpu")
        for build, cls, name, kw in (
                ("device", TL._DeviceGrowth, "level_step",
                 dict(level_window_fn=counted(
                     TL.partition_hist_level_window))),
                ("host loop", TL._Growth, "split_level",
                 dict(host_loop=True,
                      level_fn=counted(TL.partition_hist_level)))):
            calls = []
            real = getattr(cls, name)
            setattr(cls, name, per_level(real, calls))
            try:
                tree = learner.train(grad, hess, n, **kw)
            finally:
                setattr(cls, name, real)
            out["%s, %s" % (precision, build)] = dict(
                calls_per_level=calls, leaves=tree.num_leaves)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
