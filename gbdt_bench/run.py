"""Run one cell of the benchmark once, on the machine it is started on.

    python3 gbdt_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix and
metrics are named in ``BENCHMARK.json``; their files are found by name
under ``gbdt_bench/`` (``harness/cells.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted`` (window iterations),
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number of the correctness comparison beside its
limit, which are also the last lines of standard error.

Exit codes: 0 with a result; 2 for an unknown cell or bad arguments; 3
when the cards the cell needs are not there (no result: device numbers are
never taken from the CPU); 4 when the process loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cells, chip  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device, t0: float, config=None):
    """Drive the cell, judge what it produced, read its metrics: ``(result
    without device, checks, run)``.  ``config`` replaces the cell's
    configuration (the harness's tests run a small one on the CPU)."""
    from reference import judge as J
    driver = cells.module("drivers", cell.traffic["driver"])
    run = driver.run(cell, seed, seconds, trace, device, t0, config=config)
    t = time.perf_counter()
    data = driver.judge_data(cell, seed, device, config=config)
    nums = J.judge(data, run.outputs)
    run.outputs = None
    run.extra["reference_s"] = time.perf_counter() - t
    ctx = {"run": run, "cell": cell,
           "num_bins": [len(b) for b in data.bounds],
           "precision": cell.traffic["params"].get("hist_precision",
                                                   "exact")}
    del data
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": J.verdict(nums, cell.limits),
              "attempted": run.iterations, "failed": 0, "metrics": metrics}
    if trace and run.trace is not None:
        result["breakdown"] = {
            "device_ops": run.trace.top_device_ops(),
            "idle_gaps": run.host_trace.idle_by_host()}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in nums.items() if k in cell.limits}
    run.extra["readings"] = {k: v for k, v in nums.items()
                             if k not in cell.limits}
    return result, checks, run


def main(argv=None) -> int:
    chip.one_host_thread()
    args = parse(argv)
    try:
        cell = cells.cell(args.workload)
    except cells.UnknownName as e:
        print("gbdt_bench: %s" % e, file=sys.stderr)
        return 2
    try:
        chip.require_cards(cell.chips)
    except chip.NoCard as e:
        print("gbdt_bench: %s" % e, file=sys.stderr)
        return 3
    result, checks, run = execute(cell, args.seed % (1 << 63), args.seconds,
                                  bool(args.trace), "cuda", T0)
    dev = chip.device_record(cell.chips, run.peak_bytes)
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.window_s
    bad = chip.forbidden_modules()
    if bad:
        print("gbdt_bench: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    result["device"] = dev
    result["checks"] = checks
    print("gbdt_bench: setup %.2f s %s; window %.2f s, %d iterations; "
          "reference %.2f s" % (run.setup_s, json.dumps(
              {k: round(v, 3) for k, v in
               run.extra.get("setup_phases", {}).items()}),
              run.window_s, run.iterations, run.extra["reference_s"]),
          file=sys.stderr)
    for k, v in run.extra["readings"].items():
        print("reading %s %r (not held)" % (k, v), file=sys.stderr)
    for k, c in checks.items():
        print("check %s %r limit %r" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
