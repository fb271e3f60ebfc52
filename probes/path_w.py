"""chip_smoke.py's path (W), telemetry and the serving tier, alone: (A),
(B) and (C) at full size (what (W) serves and is held to), then (W1), (W2)
and (W3).

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_w.py [--rows 1048576] [--profile]

It builds the kernels, bins ``chip_smoke.synthetic_task(rows)``, trains
(A) (leaf-wise, exact), (B) (level) and (C) (level, quantized) for 5
iterations, then runs ``phase_telemetry_train``, ``phase_serving`` and
``phase_serve_cli`` with their checks, printing what chip_smoke.py prints
for them and the seconds of (W).
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
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_w: needs a CUDA card", file=sys.stderr)
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
    t = time.perf_counter()
    w1 = C.phase_telemetry_train(dev, data, ds, 5, texts["A"])
    gbdt = w1.pop("booster")
    C.phase_serving(dev, data, ds, gbdt, texts, args.profile)
    torch.cuda.empty_cache()
    C.phase_serve_cli(dev, data, gbdt)
    print("(W) took %.1f s" % (time.perf_counter() - t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
