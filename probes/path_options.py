"""chip_smoke.py's leaf-wise options on the device build, alone: the
device-window histogram and the split pass's feature window, then (N),
(V1), (V2) and (O) with the checks chip_smoke.py runs for them.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_options.py [--rows 1048576] [--iters 2]
                                   [--widef-rows 400000]

It builds the kernels, runs ``phase_window_hist`` and
``phase_window_feature_split``, bins ``chip_smoke.synthetic_task(rows)``,
trains (A) (leaf-wise, exact) and (C) (level, quantized), what (V) is held
to, then (N) (forced splits and CEGB), (V1) and (V2) (the parallel
learners), (D) (Epsilon-shaped, ``--widef-rows`` rows) and (O) (the
histogram pool on (D)'s bins), each with its regrowth by the host loop,
(N)'s and (O)'s step in a CUDA graph and the in-turns comparison of both
builds, printing each phase's seconds.
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
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--widef-rows", type=int, default=400_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_options: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    print(C.gpu_name_and_power(), flush=True)
    kernels.build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def took(what, t):
        print("%s took %.1f s [%.1f s into the probe]"
              % (what, time.perf_counter() - t, time.perf_counter() - t0),
              flush=True)
    t = time.perf_counter()
    C.phase_window_hist(dev, args.rows, args.widef_rows)
    took("window histogram", t)
    t = time.perf_counter()
    C.phase_window_feature_split(dev, args.rows)
    took("window split with the feature window", t)
    Log.reset_level(Log.level_from_verbosity(-1))
    data = C.synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    paths = {p: C.phase_main_path(dev, data, ds, p, args.iters, False)
             for p in ("A", "C")}
    a = paths["A"]
    a["text"] = a["booster"].save_model_to_string()
    a["tree0"] = C.tree0_sequence(a["booster"])
    a["tree0_terms"] = C.tree0_split_terms(a["booster"])
    t = time.perf_counter()
    C.phase_forced_cegb(dev, data, ds, False)
    took("(N)", t)
    t = time.perf_counter()
    C.phase_parallel_nccl(dev, data, ds, min(args.iters, C.V1_ITERS),
                          a["text"])
    took("(V1)", t)
    t = time.perf_counter()
    C.phase_parallel_gloo(dev, args.rows, min(args.iters, C.V2_ITERS), a,
                          paths["C"]["losses"])
    took("(V2)", t)
    del paths, a, ds, data
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eps = C.phase_epsilon(dev, args.widef_rows, max(args.widef_rows // 4,
                                                    1000), args.iters, False)
    took("(D)", t)
    t = time.perf_counter()
    C.phase_pool(dev, eps, False)
    took("(O)", t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
