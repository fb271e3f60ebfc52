"""chip_smoke.py's level growth on the device alone: the device-window level
pass against the host-map launch, then (B) and (C) and their comparison
with the host loop.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_level.py [--rows 1048576] [--iters 2] [--no-paths]

It builds the kernels, prints the level library's ``ptxas`` lines, checks
the level pass with its windows in device memory against the host-map
launch, G single-window calls and both plain versions over phase 3's
frontiers (``phase_level_split``, exact and quantized, both integer
grids), times the level pass at each depth of a tree over every row, both
launches (``times_quantized_and_level``), then trains (B) and (C)
(``phase_main_path``: one fetch a tree) and runs
``phase_level_device_build`` on each ((B)'s whole tree in one CUDA graph,
both builds in turns).  ``--no-paths`` stops after the kernel checks and
times.  The last two lines are the card's name and power limit and a JSON
object of the numbers.
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
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--no-paths", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_level: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    dev = torch.device("cuda")
    card = C.gpu_name_and_power()
    kernels.build()
    print("kernels built in %.1f s" % kernels.build_seconds(), flush=True)
    for line in kernels.ptxas_log()["partition_level"].splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.strip(), flush=True)
    t = time.perf_counter()
    out = {"level_err": C.phase_level_split(dev, args.rows)}
    out["times"] = C.times_quantized_and_level(dev, args.rows)
    out["kernels_s"] = time.perf_counter() - t
    if not args.no_paths:
        Log.reset_level(Log.level_from_verbosity(-1))
        data = C.synthetic_task(args.rows)
        ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
        for path in ("B", "C"):
            t = time.perf_counter()
            r = C.phase_main_path(dev, data, ds, path, args.iters, False)
            out[path] = dict(iter_s=r["iter_s"], fetches=r["fetches"],
                             launches=r["launches"])
            out[path]["level_build"] = C.phase_level_device_build(
                dev, ds, r.pop("booster"), path)
            out[path]["s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
