"""chip_smoke.py's path (Z) alone: the asynchronous training loop.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_async.py [--rows 1048576] [--unchecked-rounds 0]

It builds the kernels, makes (A)'s synthetic task and runs
``chip_smoke.phase_async``: (B) and (C) lazy against forced materialization
with every synchronising call recorded, (A) with a validation set in turns,
and (Y1)'s chunk under the same check.  With ``--unchecked-rounds R`` it
then times (B) and (C) again, lazy against forced in R rounds of turns
(lazy, forced, forced, lazy; 5 iterations a turn) with no sync check, so
that the check's own cost is told apart from the loop's.  The last two
lines are the card's name and power limit and a JSON object of the
numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--unchecked-rounds", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_async: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    card = C.gpu_name_and_power()
    kernels.build()
    print("kernels built in %.1f s" % kernels.build_seconds(), flush=True)
    Log.reset_level(Log.level_from_verbosity(-1))
    data = C.synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    t = time.perf_counter()
    out = C.phase_async(torch.device("cuda"), data, ds)
    out["s"] = time.perf_counter() - t
    for path in ("B", "C") if args.unchecked_rounds else ():
        extra = C.PATHS[path][1]
        runs = {"lazy": C.async_booster(ds, extra, False),
                "forced": C.async_booster(ds, extra, True)}
        turns = {"lazy": [], "forced": []}
        for name in C.ASYNC_TURNS * args.unchecked_rounds:
            t = time.perf_counter()
            C.async_iters(runs[name], 5, name == "forced")
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t)
        out["unchecked_" + path] = turns
        print("  (%s) unchecked turns of 5 iterations, s: lazy %s, forced %s"
              % (path, ["%.4f" % v for v in turns["lazy"]],
                 ["%.4f" % v for v in turns["forced"]]), flush=True)
    print(card, flush=True)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
