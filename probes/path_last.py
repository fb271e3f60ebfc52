"""chip_smoke.py's paths new to the card, alone: (F2) leaf renewal, (S5)
``cv``, (U2) the watchdog's abort, (D2) level growth and (K2) GOSS at the
Epsilon width, (I2) level growth and (L2) DART on the Allstate bundles,
(H2) ``rank_xendcg``, (S6) the scikit-learn estimators, and (T3) the C
host program on a CSV of (A)'s task.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/path_last.py [--rows 1048576] [--widef-rows 400000]
        [--ltr-rows 2270296] [--allstate-rows 1048576] [--csv-rows 524288]
        [--only F2,S5,...]

It builds the kernels, makes (A)'s task and bins, then each earlier path's
data the new paths reuse ((D)'s at ``--widef-rows`` through
``phase_epsilon``, (H)'s through ``phase_lambdarank``, (I)'s through
``phase_allstate``: each with its own checks) and runs the new paths with
chip_smoke.py's checks.  (T3) writes ``--csv-rows`` of (A)'s task as
(S) writes its file, loads it with the port's loader and runs
``start_capi_host``/``finish_capi_host`` on it.  Each path prints its
seconds; the last two lines are the card's name and power limit and a
JSON object of the seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

ALL = ("F2", "S5", "U2", "D2", "K2", "I2", "L2", "H2", "S6", "T3")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--widef-rows", type=int, default=400_000)
    ap.add_argument("--ltr-rows", type=int, default=2_270_296)
    ap.add_argument("--allstate-rows", type=int, default=1 << 20)
    ap.add_argument("--csv-rows", type=int, default=1 << 19)
    ap.add_argument("--only", default=",".join(ALL))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_last: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.utils.log import Log
    only = set(args.only.split(","))
    dev = torch.device("cuda")
    card = C.gpu_name_and_power()
    kernels.build()
    C.log("kernels built in %.1f s" % kernels.build_seconds())
    Log.reset_level(Log.level_from_verbosity(-1))
    t_start = time.perf_counter()
    secs = {}
    data = C.synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    for path, fn in (("F2", C.phase_renewal), ("S5", C.phase_cv)):
        if path in only:
            secs[path] = fn(dev, data, ds)["seconds"]
    if "U2" in only:
        secs["U2"] = C.phase_watchdog_abort(dev)["seconds"]
    if only & {"D2", "K2"}:
        eps = C.phase_epsilon(dev, args.widef_rows, args.widef_rows // 4, 2,
                              False)
        if "D2" in only:
            secs["D2"] = C.phase_epsilon_level(dev, eps)["seconds"]
        if "K2" in only:
            secs["K2"] = C.phase_goss_wide(dev, eps)["seconds"]
        del eps
        torch.cuda.empty_cache()
    if only & {"I2", "L2"}:
        r = C.phase_allstate(dev, args.allstate_rows, C.ALLSTATE_TEST_ROWS,
                             2, False)
        for path, v in C.phase_allstate_variants(dev, r["sets"]).items():
            secs[path] = v["seconds"]
        del r
        torch.cuda.empty_cache()
    if only & {"H2", "S6"}:
        ltr = C.phase_lambdarank(dev, args.ltr_rows, 2, False)["ltr"]
        if "H2" in only:
            secs["H2"] = C.phase_xendcg(dev, ltr)["seconds"]
        if "S6" in only:
            secs["S6"] = C.phase_sklearn(dev, data, ltr)["seconds"]
        del ltr
        torch.cuda.empty_cache()
    if "T3" in only:
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.io.loader import DatasetLoader
        t = time.perf_counter()
        os.makedirs(C.CLI_DIR, exist_ok=True)
        try:
            X, y = data[0][:args.csv_rows], data[1][:args.csv_rows]
            train_f = os.path.join(C.CLI_DIR, "higgs.train")
            C.write_fixed_csv(train_f, np.column_stack([y, X]))
            host = C.start_capi_host(train_f)
            params = dict(tok.split("=", 1) for tok in C.T3_PARAMS.split())
            train_ds = DatasetLoader(Config(params)).load_from_file(train_f)
            C.finish_capi_host(host, train_ds)
        finally:
            shutil.rmtree(C.CLI_DIR, ignore_errors=True)
        secs["T3"] = time.perf_counter() - t
    secs["total"] = time.perf_counter() - t_start
    print(card, flush=True)
    print(json.dumps(secs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
