"""chip_smoke.py's path (X) alone: the kernel planner and autotuner, MFU,
alerts and profiler captures, the online loop and compaction, after (A),
(B) and (C) at full size and (W1) (whose summary (X2) reads).

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_x.py [--rows 1048576]

It builds the kernels, bins ``chip_smoke.synthetic_task(rows)``, trains
(A), (B) and (C) for 5 iterations and ``phase_telemetry_train``, then runs
``phase_path_x`` with its checks, printing what chip_smoke.py prints for
them, the seconds of (X) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_x: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    print(C.gpu_name_and_power(), flush=True)
    kernels.build()
    dev = torch.device("cuda")
    Log.reset_level(Log.level_from_verbosity(-1))
    data = C.synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    texts = {}
    for p in ("A", "B", "C"):
        r = C.phase_main_path(dev, data, ds, p, 5, False)
        texts[p] = r["booster"].save_model_to_string()
        del r
        torch.cuda.empty_cache()
    w1 = C.phase_telemetry_train(dev, data, ds, 5, texts["A"])
    del w1["booster"]
    x = C.phase_path_x(dev, data, ds, texts, 5, w1)
    print("(X) took %.1f s" % x["s"], flush=True)
    print(C.gpu_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
