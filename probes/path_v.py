"""chip_smoke.py's path (V), the parallel tree learners, alone: (A) and (C)
at full size (what (V) is held to), then (V1) and (V2).

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_v.py [--rows 1048576]

It builds the kernels, bins ``chip_smoke.synthetic_task(rows)``, trains (A)
(leaf-wise, exact) and (C) (level, quantized) for 5 iterations, then runs
``phase_parallel_nccl`` and ``phase_parallel_gloo`` with their checks,
printing what chip_smoke.py prints for them and each phase's seconds.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_v: needs a CUDA card", file=sys.stderr)
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
    paths = {p: C.phase_main_path(dev, data, ds, p, 5, False)
             for p in ("A", "C")}
    a = paths["A"]
    a["text"] = a["booster"].save_model_to_string()
    a["tree0"] = C.tree0_sequence(a["booster"])
    a["tree0_terms"] = C.tree0_split_terms(a["booster"])
    t = time.perf_counter()
    C.phase_parallel_nccl(dev, data, ds, 5, a["text"])
    print("(V1) took %.1f s" % (time.perf_counter() - t), flush=True)
    t = time.perf_counter()
    C.phase_parallel_gloo(dev, args.rows, C.V2_ITERS, a, paths["C"]["losses"])
    print("(V2) took %.1f s" % (time.perf_counter() - t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
