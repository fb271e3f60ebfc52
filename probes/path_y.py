"""chip_smoke.py's path (Y) alone (the fused multi-iteration chunk), with
the carried store's kernel contract at F = 112, what makes up each run's
peak device memory, and the chunk's s/iteration against ``train_one_iter``
timed in turns (fused, one at a time, one at a time, fused).

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_y.py [--rows 1048576] [--iters 10]

It builds the kernels, runs ``phase_carried_contract`` and ``phase_chunk``
with their checks on ``chip_smoke.synthetic_task(rows)``, then trains (Y1)'s
and (Y3)'s tasks through ``GBDT.train()`` fused and one iteration at a time
with the CUDA allocator's history recorded, printing at each run's peak the
eight largest live blocks and the lines of the port that made them; then
(Y1)'s task ``--iters`` iterations four times in turns.  The last two lines
are the card's name and power limit and a JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def peak_blocks(tag: str) -> float:
    """The peak of the recorded allocation trace (allocated bytes above the
    trace's start) and its eight largest live blocks, each with the port's
    innermost frames that allocated it."""
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    live, run, best, at_best = {}, 0, 0, {}
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            run += e["size"]
            if run > best:
                best, at_best = run, dict(live)
        elif e["action"] == "free_requested" and e["addr"] in live:
            run -= live.pop(e["addr"])[0]
    print("  %s: peak %.1f MiB above the trace's start"
          % (tag, best / 2 ** 20), flush=True)
    for size, frames in sorted(at_best.values(), key=lambda v: -v[0])[:8]:
        where = ["%s:%s %s" % (os.path.basename(f["filename"]), f["line"],
                               f["name"]) for f in frames
                 if "lightgbm_tpu_torch" in f["filename"]][:2]
        print("    %8.1f MiB  %s" % (size / 2 ** 20, " <- ".join(where)),
              flush=True)
    return best / 2 ** 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_y: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    dev = torch.device("cuda")
    card = C.gpu_name_and_power()
    kernels.build()
    print("kernels built in %.1f s" % kernels.build_seconds(), flush=True)
    C.phase_carried_contract(dev, C.CARRIED_ROWS)
    Log.reset_level(Log.level_from_verbosity(-1))
    data = C.synthetic_task(args.rows)
    X, y, X_test, y_test = data
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    t = time.perf_counter()
    y_out = C.phase_chunk(dev, data, ds)
    out = {"Y_s": time.perf_counter() - t,
           "runs": {k: {f: v for f, v in r.items() if f != "launches"}
                    for k, r in y_out["runs"].items()}}

    rng = np.random.RandomState(1)
    y_reg, y_reg_test = C.higgs_score(X, rng), C.higgs_score(X_test, rng)
    sets = {"binary": (ds, BinnedDataset.from_matrix(
        X_test, label=y_test, reference=ds)),
            "regression": (C.relabel(ds, y_reg), BinnedDataset.from_matrix(
                X_test, label=y_reg_test, reference=ds))}
    peaks = {}
    for name, objective, params in (("Y1", "binary", {}),
                                    ("Y3", "regression", C.CHUNK_RUNS[2][2])):
        train, valid = sets[objective]
        for fuse in (True, False):
            torch.cuda.memory._record_memory_history(max_entries=200000)
            r = C.chunk_train(train, valid, objective, params, 6, fuse)
            tag = "%s %s" % (name, "fused" if fuse else "train_one_iter")
            peaks[tag] = peak_blocks(tag)
            torch.cuda.memory._record_memory_history(enabled=None)
            del r
            torch.cuda.empty_cache()
    out["peak_mib"] = peaks

    train, valid = sets["binary"]
    turns = []
    for fuse in (True, False, False, True):
        r = C.chunk_train(train, valid, "binary", {}, args.iters, fuse)
        turns.append(["fused" if fuse else "train_one_iter", r["iter_s"]])
        print("  (Y1)'s task, %s: %.4f s/iteration, chunks %s"
              % (turns[-1][0], r["iter_s"],
                 ["%.4f" % (c[2] / c[1]) for c in r["chunks"]]), flush=True)
        del r
        torch.cuda.empty_cache()
    out["turns"] = turns
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
