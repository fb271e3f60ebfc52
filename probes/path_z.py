"""chip_smoke.py's leaf-wise device build alone: (A) and its comparison
with the host loop, and (Y1), the fused chunk's carried store on the device
build.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_z.py [--rows 1048576] [--iters 5]

It builds the kernels, checks the device-window split pass against its
plain version and the host-window pass (``phase_window_split``), trains (A)
(``phase_main_path``: at most 2 fetches and L - 1 split passes a tree, its
checks), then ``phase_device_build`` ((A)'s first tree against the host
loop's, the step captured in a CUDA graph, both builds' s/iteration and
peak memory in turns) and (Y1) (``phase_chunk`` with that run only: at most
2 growth fetches a tree).  The last two lines are the card's name and power
limit and a JSON object of the numbers.
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
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_z: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    dev = torch.device("cuda")
    card = C.gpu_name_and_power()
    kernels.build()
    print("kernels built in %.1f s" % kernels.build_seconds(), flush=True)
    out = {"window_err": C.phase_window_split(dev, args.rows)}
    Log.reset_level(Log.level_from_verbosity(-1))
    data = C.synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    t = time.perf_counter()
    a = C.phase_main_path(dev, data, ds, "A", args.iters, False)
    out["A"] = dict(iter_s=a["iter_s"], fetches=a["fetches"],
                    launches=a["launches"], s=time.perf_counter() - t)
    out["device_build"] = C.phase_device_build(dev, ds, a.pop("booster"))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    y = C.phase_chunk(dev, data, ds, only=("Y1",))
    out["Y1"] = dict(y["runs"]["Y1"], s=time.perf_counter() - t)
    out["Y1"].pop("launches", None)
    print(card, flush=True)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
