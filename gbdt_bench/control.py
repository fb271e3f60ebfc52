"""The readings that set a cell's correctness limits from above, on the
chip at the cell's own size: the controls and faults put in the program's
place (``reference/judge.py`` ``train_reference``), judged as the program's
runs are.  The benchmark's own runs never run this; the program's readings
are the numbers each run of ``run.py`` prints.

    python3 gbdt_bench/control.py --workload <cell> --seeds 1,2,3 \
        --variants bf16,half,alter [--trees 3]

Each reading is one JSON line on standard output.
"""
import time

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cells, chip  # noqa: E402


def readings(cell, seed: int, variants, trees: int, device="cuda"):
    """Yield ``(variant, numbers, seconds)`` for each variant on one
    seed."""
    import torch
    from reference import judge as J
    driver = cells.module("drivers", cell.traffic["driver"])
    data = driver.judge_data(cell, seed, device)
    for v in variants:
        t = time.perf_counter()
        nums = J.judge(data, J.train_reference(data, trees, v))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield v, nums, time.perf_counter() - t


def main(argv=None) -> int:
    chip.one_host_thread()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", required=True)
    p.add_argument("--trees", type=int, default=3)
    a = p.parse_args(argv)
    cell = cells.cell(a.workload)
    chip.require_cards(cell.chips)
    for seed in (int(s) for s in a.seeds.split(",")):
        for kind, nums, secs in readings(cell, seed, a.variants.split(","),
                                         a.trees):
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              "seconds": secs, "numbers": nums}), flush=True)
    bad = chip.forbidden_modules()
    if bad:
        print("control: the run loaded %s" % ", ".join(bad), file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
