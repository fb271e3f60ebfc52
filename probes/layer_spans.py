"""The port's spans laid over the benchmark's traced window: which layer
launched each kernel, and in which layer the card sat idle.

Needs one CUDA card and ``nvcc``; run from the repository root::

    python3 probes/layer_spans.py --cells higgs-leaf,epsilon-level \\
        [--seed 2147483659] [--out build/layer_spans]

For each cell of ``BENCHMARK.json`` it runs the benchmark's training driver
(``gbdt_bench/drivers/train.py``) traced twice: once inside
``obs.spans.collect()`` and once without it, so the second run gives the
traced seconds an iteration that collecting costs.  The driver's profiler
windows are read as the benchmark reads them (``gbdt_bench/harness/
profile.py``), with each device activity's correlation id and each CUDA
launch record's host start and thread kept beside them.

The rule: a kernel belongs to the innermost span open on its launching
thread at its launch record's host start; an idle gap of the device-only
window belongs to the innermost span open on the training thread at the
gap's middle.  Printed per cell, and written as ``<out>/<cell>.json``: the
device milliseconds and launches an iteration of each span's kernels (the
port's ``hist_*``/``part_*``/``lvl_*`` kernels apart), the shares of the
kernels inside some span and of the port's inside ``split_pass``, the host
milliseconds an iteration inside ``tree_build`` spans, the share of the
idle time inside some span, the benchmark's own per-layer readings of the
same run, the host-and-device window's idle gaps by host operation, and the
traced seconds an iteration with and without the collector.  The last line
is the card's name and power limit.

``--tiny`` rehearses the control flow on the CPU at the harness's test
size; a CPU trace has no launch records, so every attribution is None.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "gbdt_bench"

# tree growth: the innermost spans of its kernels (bookkeeping, finish)
GROWTH = ("tree_build", "tree_finish")


def innermost(spans, queries):
    """For each ``(time_ns, thread)`` of ``queries``, the name of the
    innermost span of ``spans`` (``SpanRecord``s) open on that thread at
    that time, or None.  Spans nest per thread, so a sweep in time order
    with one stack a thread finds it."""
    out = [None] * len(queries)
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    asked = defaultdict(list)
    for i, (t, thread) in enumerate(queries):
        asked[thread].append((t, i))
    for thread, qs in asked.items():
        ss = sorted(by_thread.get(thread, ()),
                    key=lambda s: (s.t0_ns, -s.t1_ns))
        qs.sort()
        stack, j = [], 0
        for t, i in qs:
            while j < len(ss) and ss[j].t0_ns <= t:
                while stack and stack[-1].t1_ns < ss[j].t0_ns:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1].t1_ns < t:
                stack.pop()
            out[i] = stack[-1].name if stack else None
    return out


def attribute(kernels, launches, spans, gaps, training_thread, is_port,
              iterations):
    """The readings of one window.  ``kernels``: (name, duration_ns,
    correlation id) of each kernel; ``launches``: correlation id ->
    (host start_ns, thread) of the launch records; ``gaps``: (start_ns,
    end_ns) of the device's idle stretches.  None where no kernel has a
    launch record (a CPU trace)."""
    found = [launches.get(c) for _, _, c in kernels]
    if not kernels or not any(found):
        return None
    # a launch thread no span ran on (none, or an id the profiler gave
    # otherwise) is the training thread
    threads = {s.thread for s in spans}
    queries = [(lr[0], lr[1] if lr[1] in threads else training_thread)
               if lr else (-1, training_thread) for lr in found]
    where = innermost(spans, queries)
    by = defaultdict(lambda: [0, 0, 0, 0])   # ns, count; port ns, count
    for (name, d, _), lr, w in zip(kernels, found, where):
        key = w if lr is not None else "(no launch record)"
        row = by[key if key is not None else "(no span)"]
        if is_port(name):
            row[2] += d
            row[3] += 1
        else:
            row[0] += d
            row[1] += 1
    n = float(iterations)

    def ms(keys, port=False):
        return sum(by[k][2 if port else 0] for k in keys) * 1e-6 / n

    def count(keys, port=False):
        return sum(by[k][3 if port else 1] for k in keys) / n

    kernels_n = sum(r[1] + r[3] for r in by.values())
    outside = sum(by[k][1] + by[k][3] for k in
                  ("(no span)", "(no launch record)") if k in by)
    port_n = sum(r[3] for r in by.values())
    mids = [((a + b) // 2, training_thread) for a, b in gaps]
    gap_in = innermost(spans, mids)
    idle = sum(b - a for a, b in gaps)
    idle_in = sum(b - a for (a, b), w in zip(gaps, gap_in) if w is not None)
    idle_by = defaultdict(int)
    for (a, b), w in zip(gaps, gap_in):
        idle_by[w or "(no span)"] += b - a
    return {
        "objective_ms_per_iter": ms(["objective"]) + ms(["objective"], True),
        "split_scan_ms_per_iter": ms(["split_scan"])
        + ms(["split_scan"], True),
        "split_scan_launches_per_iter": count(["split_scan"])
        + count(["split_scan"], True),
        "growth_ms_per_iter": ms(GROWTH) + ms(GROWTH, True),
        "growth_launches_per_iter": count(GROWTH) + count(GROWTH, True),
        "idle_in_spans_pct": 100.0 * idle_in / idle if idle else None,
        "kernels_in_spans_pct": 100.0 * (kernels_n - outside) / kernels_n,
        "port_in_split_pass_pct": (100.0 * by["split_pass"][3] / port_n
                                   if port_n else None),
        "torch_ops_by_span_ms_per_iter": {
            k: v[0] * 1e-6 / n for k, v in sorted(by.items()) if v[1]},
        "launches_by_span_per_iter": {
            k: (v[1] + v[3]) / n for k, v in sorted(by.items())},
        "port_ms_by_span_per_iter": {
            k: v[2] * 1e-6 / n for k, v in sorted(by.items()) if v[3]},
        "idle_ms_by_span_per_iter": {
            k: v * 1e-6 / n for k, v in sorted(idle_by.items(),
                                                key=lambda kv: -kv[1])},
        "launch_records_found_pct": 100.0 * sum(f is not None
                                                for f in found) / len(found),
    }


def gaps_by_span(spans, gaps, training_thread):
    """The share (%) of the idle time of ``gaps`` by the innermost span
    open on the training thread at each gap's middle."""
    where = innermost(spans, [((a + b) // 2, training_thread)
                              for a, b in gaps])
    by = defaultdict(int)
    for (a, b), w in zip(gaps, where):
        by[w or "(no span)"] += b - a
    total = sum(by.values()) or 1
    return {k: 100.0 * v / total for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])}


def span_cost_us(device, n=200000, launches=8):
    """Microseconds a span site costs: no sink (the shared no-op), and a
    collected span with its named range, each with no profiler and under
    a device-only profiler window; and the same around ``launches`` small
    device operations a site (``*_launching``, per site, the operations
    included), since a launch may cost more inside a range.  ``range`` and
    ``nvtx``: the collected span's two ranges, each alone around them."""
    import torch
    from lightgbm_tpu_torch.obs import spans as S
    from lightgbm_tpu_torch.obs.trace import _RANGE
    x = torch.zeros(64, device=device)

    class Nvtx:
        def __enter__(self):
            torch.cuda.nvtx.range_push("split_scan")

        def __exit__(self, *exc):
            torch.cuda.nvtx.range_pop()

    def per_site(site, collect, k=0):
        m = n if k == 0 else n // 20

        def body():
            for _ in range(m):
                with site():
                    for _ in range(k):
                        x.add_(1.0)
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        if collect:
            with S.collect():
                body()
        else:
            body()
        if device == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e6 / m

    def step():
        return S.step("split_scan")

    out = {}
    for tag, k in (("", 0), ("_launching", launches)):
        out["off" + tag] = per_site(step, False, k)
        out["collecting" + tag] = per_site(step, True, k)
    out["range_launching"] = per_site(lambda: _RANGE("split_scan"), False,
                                      launches)
    if device == "cuda":
        out["nvtx_launching"] = per_site(Nvtx, False, launches)
    act = (torch.profiler.ProfilerActivity.CUDA if device == "cuda"
           else torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=[act]):
        for tag, k in (("", 0), ("_launching", launches)):
            out["off_profiled" + tag] = per_site(step, False, k)
            out["collecting_profiled" + tag] = per_site(step, True, k)
    return out


def window_host_ms(spans, warmup, iterations, name="tree_build"):
    """Host milliseconds an iteration inside ``name`` spans over the
    window's iterations (the ``iteration`` spans after ``warmup``)."""
    its = sorted((s for s in spans if s.name == "iteration"),
                 key=lambda s: s.t0_ns)[warmup:warmup + iterations]
    if not its:
        return None
    lo, hi = its[0].t0_ns, its[-1].t1_ns
    ns = sum(s.t1_ns - s.t0_ns for s in spans
             if s.name == name and lo <= s.t0_ns and s.t1_ns <= hi)
    return ns * 1e-6 / len(its)


def _keep_launches(P):
    """Wrap ``harness.profile.from_profiler``: the Trace it returns also
    carries ``corr`` (each device activity's correlation id, in the order
    of ``device``), ``launches`` (correlation id -> host start_ns and
    thread of each CUDA runtime or driver record) and ``launch_names``."""
    orig = P.from_profiler

    def from_profiler(prof):
        from torch.autograd import DeviceType
        t = orig(prof)
        corr, launches, names = [], {}, defaultdict(int)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    corr.append(e.correlation_id())
            elif e.name().startswith("cu") and e.correlation_id():
                tid = getattr(e, "device_resource_id", lambda: 0)()
                launches[e.correlation_id()] = (e.start_ns(), tid)
                names[e.name()] += 1
        t.corr, t.launches, t.launch_names = corr, launches, dict(names)
        return t
    P.from_profiler = from_profiler


def one_cell(cell_name, seed, device, tiny, out_dir, repeat):
    import gc

    import torch

    from drivers import train as D
    from harness import cells
    from harness.profile import _COPY, is_port_kernel
    from lightgbm_tpu_torch.obs import spans as S
    cell = cells.cell(cell_name)
    config = None
    if tiny:
        sys.path.insert(0, str(BENCH / "tests"))
        from conftest import small_config
        config = small_config(cell)
    res = {"cell": cell_name, "seed": seed, "order": [],
           "traced_s_per_iter": {"collecting": [], "not_collecting": []},
           "iterations": {"collecting": [], "not_collecting": []}}
    runs = {}
    # pairs in turns: collecting first in even pairs, last in odd ones
    order = [(k % 2 == 0) == (i == 0) for k in range(repeat)
             for i in range(2)]
    for collecting in order:
        t0 = time.perf_counter()
        if collecting:
            with S.collect() as got:
                run = D.run(cell, seed, 1 << 20, True, device, t0,
                            config=config)
        else:
            run = D.run(cell, seed, 1 << 20, True, device, t0, config=config)
        tag = "collecting" if collecting else "not_collecting"
        res["order"].append(tag)
        res["traced_s_per_iter"][tag].append(
            run.window_s / max(run.iterations, 1))
        res["iterations"][tag].append(run.iterations)
        if collecting not in runs:
            runs[collecting] = run
            if collecting:
                spans = list(got)
            run.extra["num_bins"] = [len(b) for b in run.outputs.bounds]
        run.outputs = None
        del run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    run, plain = runs[True], runs[False]
    res["spans"] = len(spans)
    names = defaultdict(int)
    for s in spans:
        names[s.name] += 1
    res["spans_by_name"] = dict(names)
    tr = run.trace
    iters = [s for s in spans if s.name == "iteration"]
    thread = iters[0].thread if iters else 0
    kernels = [(n, d, c) for (n, _, d), c in zip(tr.device, tr.corr)
               if not _COPY.match(n)]
    res["launch_record_names"] = getattr(tr, "launch_names", {})
    res["span_threads"] = sorted({s.thread for s in spans})
    res["launch_threads"] = sorted({v[1] for v in tr.launches.values()})[:8]
    res["attribution"] = attribute(kernels, tr.launches, spans, tr.gaps(),
                                   thread, is_port_kernel, run.iterations)
    res["tree_host_ms_per_iter"] = window_host_ms(spans, D.WARMUP,
                                                  run.iterations)
    res["host_window_idle_pct_by_span"] = gaps_by_span(
        spans, run.host_trace.gaps(), thread)
    # the benchmark's own readings of the same run, and of the run
    # without the collector (whose launches must not move)
    ctx = {"cell": cell, "precision": cell.traffic["params"].get(
        "hist_precision", "exact")}
    for tag, r in (("collecting", run), ("not_collecting", plain)):
        ctx["run"] = r
        ctx["num_bins"] = r.extra.get("num_bins", [])
        res.setdefault("benchmark", {})[tag] = {
            m["name"]: cells.module("metrics", m["name"]).read(ctx)
            for m in cell.per_layer}
    res["idle_gaps_host_window"] = {
        "collecting": run.host_trace.idle_by_host(),
        "not_collecting": plain.host_trace.idle_by_host()}
    res["device_ops"] = run.trace.top_device_ops(6)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ("%s.json" % cell_name), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="higgs-leaf,higgs-level-quant,"
                   "epsilon-leaf,epsilon-level",
                   help="comma-separated; empty: the span costs alone")
    p.add_argument("--seed", type=int, default=2147483659)
    p.add_argument("--out", default="build/layer_spans")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--repeat", type=int, default=1,
                   help="pairs of runs, with and without the collector")
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(REPO)]
    from harness import chip
    chip.one_host_thread()
    from harness import profile as P
    _keep_launches(P)
    device = "cpu" if args.tiny else "cuda"
    if not args.tiny:
        chip.require_cards(1)
    print(json.dumps({"span_cost_us": span_cost_us(device)}), flush=True)
    for i, name in enumerate(c for c in args.cells.split(",") if c):
        res = one_cell(name, args.seed + i, device, args.tiny,
                       REPO / args.out, args.repeat)
        short = {k: res[k] for k in ("cell", "traced_s_per_iter",
                                     "iterations", "spans",
                                     "tree_host_ms_per_iter")}
        a = res["attribution"] or {}
        short.update({k: v for k, v in a.items()
                      if not isinstance(v, dict)})
        short["torch_ops_by_span_ms_per_iter"] = a.get(
            "torch_ops_by_span_ms_per_iter")
        short["benchmark"] = res["benchmark"]
        short["idle_gaps"] = res["idle_gaps_host_window"]["collecting"][:4]
        short["launch_record_names"] = res["launch_record_names"]
        print(json.dumps(short), flush=True)
    if not args.tiny:
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
