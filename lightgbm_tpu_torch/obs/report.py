"""End-of-run telemetry summary: the JSON artifact and a human table.

The counterpart of ``lightgbm_tpu/obs/report.py`` (:1-690).
:func:`finalize_run` writes ``<telemetry_out>.summary.json`` beside the
run's JSONL (rank 0 alone under a multi-process group) and emits
``run_end``; :func:`summarize` builds the same dict live (``/summary.json``,
``Booster.telemetry_summary``).  Layout::

    {
      "v": 1, "metric": "telemetry_run", "unit": "row-trees/s",
      "value": <row-trees/s or null>, "iterations": N, "rows": N,
      "wall_s": ..., "rows_per_s": {...}, "host_phases": {...},
      "counters": {...}, "gauges": {...}, "histograms": {...},
      "recompiles": {"fn|bucket": n}, "recompile_total": n,
      "tree_kernel_launches": {mode: {"launches", "trees", "per_tree"}},
      "tree_kernel_launch_total": n, "resilience": {...},
      "mfu": x|null, "device_util": y|null,
      "serving": {...}, "online": {...}, "contrib": {...}, "ingest": {...},
      "quant": {...}, "compile": {...}, "devmem": {...},
      "profiling": {...}, "alerts": {...}, "plan": {...}, "quality": {...},
      "events": <event count>, "rank": ..., "host": ...
    }

Each named block is present only when the run recorded what it folds.
``mfu``/``device_util`` come from the cost model of ``obs/mfu.py`` over the
port's kernels (None on the CPU, which has no peaks); ``plan`` is the
kernel planner's provenance per site (``plan/state.py``), with the engaged
cache and its fallback counter.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from . import launches, recompile
from .registry import EVENT_SCHEMA_VERSION, Telemetry

_SERVE_REQ = "serve_requests_model_"
_SERVE_ROWS = "serve_rows_model_"
_SERVE_LAT = "serve_latency_s_model_"
_SERVE_OCC = "serve_occupancy_model_"
_SERVE_FB = "predict_fallbacks_model_"
_SERVE_PREC_REQ = "serve_requests_precision_"
_SERVE_PREC_ROWS = "serve_rows_precision_"


def serving_block(counters: Dict[str, Any], gauges: Dict[str, Any],
                  hists: Dict[str, Any]):
    """Fold the serving tier's per-model metrics into one summary section
    (None when the run never served).  Shared by :func:`summarize` and
    a died-run recovery path."""
    models: Dict[str, Dict[str, Any]] = {}

    def m(name):
        return models.setdefault(name, {})

    for name, n in counters.items():
        if name.startswith(_SERVE_REQ):
            m(name[len(_SERVE_REQ):])["requests"] = int(n)
        elif name.startswith(_SERVE_ROWS):
            m(name[len(_SERVE_ROWS):])["rows"] = int(n)
        elif name.startswith(_SERVE_FB):
            m(name[len(_SERVE_FB):])["fallbacks"] = int(n)
    for name, h in hists.items():
        if name.startswith(_SERVE_LAT):
            m(name[len(_SERVE_LAT):])["latency_s"] = h
        elif name.startswith(_SERVE_OCC):
            m(name[len(_SERVE_OCC):])["occupancy"] = h
    if not models and not counters.get("serve_batches") \
            and not counters.get("serve_rejected") \
            and not counters.get("serve_failed"):
        # rejected/failed-only runs still get a block: a fully saturated
        # deployment is exactly when the backpressure counters matter
        return None
    wall = gauges.get("serve_wall_s")
    for info in models.values():
        req = info.get("requests")
        info["qps"] = (req / wall) if (req and wall) else None
    # precision-tier traffic split: which share of the served
    # requests/rows rode the lossy bf16 tier vs exact.  Keyed per tier;
    # an all-exact run shows {"exact": ...} only
    precisions: Dict[str, Dict[str, int]] = {}
    for name, n in counters.items():
        if name.startswith(_SERVE_PREC_REQ):
            precisions.setdefault(name[len(_SERVE_PREC_REQ):],
                                  {})["requests"] = int(n)
        elif name.startswith(_SERVE_PREC_ROWS):
            precisions.setdefault(name[len(_SERVE_PREC_ROWS):],
                                  {})["rows"] = int(n)
    return {
        "models": models,
        "precisions": precisions,
        # the never-drop invariant (Server.close records it; None on runs
        # that died before close — the counters above still reconstruct)
        "dropped": gauges.get("serve_dropped"),
        "batches": int(counters.get("serve_batches", 0)),
        "single_row_fast": int(counters.get("serve_single_row_fast", 0)),
        "rejected": int(counters.get("serve_rejected", 0)),
        "failed": int(counters.get("serve_failed", 0)),
        "evictions": int(counters.get("serve_evictions", 0)),
        "swaps": int(counters.get("serve_swaps", 0)),
        "readmits": int(counters.get("serve_readmits", 0)),
        "queue_depth": hists.get("serve_queue_depth", {"count": 0}),
        "wall_s": wall,
    }


_CONTRIB_LAT = "contrib_latency_s_bucket_"


_ONLINE_TRIG = "online_trigger_"


def online_block(counters: Dict[str, Any], gauges: Dict[str, Any],
                 hists: Dict[str, Any]):
    """Fold the online controller's metrics into one section (None when
    the run never trained while serving; report.py:117-134 of the JAX
    package)."""
    cycles = counters.get("online_cycles")
    if not cycles:
        return None
    return {
        "cycles": int(cycles),
        "generation": gauges.get("online_generation"),
        "rows_behind": gauges.get("online_rows_behind"),
        "triggers": {name[len(_ONLINE_TRIG):]: int(n)
                     for name, n in sorted(counters.items())
                     if name.startswith(_ONLINE_TRIG)},
        "train_s": hists.get("online_train_s", {"count": 0}),
        "publish_s": hists.get("online_publish_s", {"count": 0}),
    }


def contrib_block(counters: Dict[str, Any], gauges: Dict[str, Any],
                  hists: Dict[str, Any]):
    """Fold the explanations plane (``pred_contrib``) into one
    summary section: device contrib dispatches/rows, per-shape-bucket
    latency histograms, serving-tier contrib request count and degraded
    fallbacks.  None when the run never served contributions.  Shared by
    :func:`summarize` and a died-run recovery."""
    calls = int(counters.get("contrib_calls", 0))
    reqs = int(counters.get("serve_contrib_requests", 0))
    fbs = int(counters.get("contrib_fallbacks", 0))
    if not calls and not reqs and not fbs:
        # fallbacks alone still get a block: a run whose EVERY contrib
        # call degraded at the booster level (calls==0) is exactly when
        # the fallbacks signal matters most
        return None
    del gauges  # symmetry with the sibling *_block helpers
    return {
        "calls": calls,
        "rows": int(counters.get("contrib_rows", 0)),
        "serve_requests": reqs,
        "fallbacks": fbs,
        "latency_s": {name[len(_CONTRIB_LAT):]: h
                      for name, h in sorted(hists.items())
                      if name.startswith(_CONTRIB_LAT)},
    }


def ingest_block(counters: Dict[str, Any], gauges: Dict[str, Any],
                 hists: Dict[str, Any]):
    """Fold the streaming loader's metrics (io/loader.py
    ``_load_streaming``) into one summary section: chunk/row counts, the
    per-chunk binning throughput histogram, pipeline stall time (wall the
    consumer spent waiting on the parse thread — the overlap the 2-deep
    pipeline failed to hide) and the host RSS high-water that makes the
    bounded-memory claim scrapeable.  None when the run never streamed.
    Shared by :func:`summarize` and a died-run
    recovery."""
    chunks = counters.get("ingest_chunks")
    if not chunks:
        return None
    return {
        "chunks": int(chunks),
        "rows": int(counters.get("ingest_rows", 0)),
        "rows_per_s": hists.get("ingest_chunk_rows_per_s", {"count": 0}),
        "stall_ms": gauges.get("ingest_stall_ms"),
        "rss_high_water_bytes": gauges.get("host_rss_high_water_bytes"),
    }


def quant_block(counters: Dict[str, Any], gauges: Dict[str, Any],
                hists: Dict[str, Any]):
    """Fold the quantized-gradient training facts (core/quant.py) into one
    summary section: how many chunks/iterations rode the integer-histogram
    path and its static geometry (grad/hess levels, 2-row operand
    channels).  None when the run trained exact.
    Shared by :func:`summarize` and a died-run
    recovery."""
    chunks = counters.get("quant_chunks")
    if not chunks:
        return None
    del hists  # symmetry with the sibling *_block helpers
    return {
        "chunks": int(chunks),
        "iterations": int(counters.get("quant_iters", 0)),
        "grad_levels": gauges.get("quant_grad_levels"),
        "hess_levels": gauges.get("quant_hess_levels"),
        "hist_channels": gauges.get("quant_hist_channels"),
    }


def summarize(tele: Telemetry, extra: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """Fold a run's registry + recompile counters into the summary dict."""
    from ..utils.timer import global_timer
    snap = tele.registry.snapshot()
    hists = snap["histograms"]
    gauges = snap["gauges"]
    rows = gauges.get("train_rows")
    iters = gauges.get("train_iterations")
    wall = gauges.get("train_wall_s")
    rows = int(rows) if rows is not None else None
    iters = int(iters) if iters is not None else None
    value = None
    if rows and iters and wall:
        value = rows * iters / wall
    # host phases scoped to THIS run: global_timer totals minus the
    # snapshot taken when the Telemetry was constructed (a second run in
    # the same process must not inherit the first run's scope time)
    base = getattr(tele, "timer_baseline", {})
    phases = {}
    for name, tot in global_timer.totals().items():
        delta = tot - base.get(name, 0.0)
        if delta > 1e-9:
            phases[name] = delta
    # recompiles likewise scoped to THIS run (an obs.recompile.reset()
    # after the baseline — a warmup — only shrinks counts, so
    # missing/negative deltas clamp to the post-reset values)
    rc_base = getattr(tele, "recompile_baseline", {})
    run_recompiles = {}
    for key, n in recompile.counts().items():
        delta = n - rc_base.get(key, 0)
        if delta > 0:
            run_recompiles["%s|%s" % key] = delta
    # split-kernel launch accounting, likewise run-scoped: total
    # launches and launches-per-tree attributed per growth mode so the
    # leaf-wise L-1 vs level-wise depth*classes structure reads off the
    # artifact directly
    lb = getattr(tele, "launch_baseline", {})
    tb = getattr(tele, "launch_tree_baseline", {})
    run_launches = {}
    launch_total = 0
    for mode, n in launches.counts().items():
        dl = n - lb.get(mode, 0)
        dt = launches.trees().get(mode, 0) - tb.get(mode, 0)
        if dl > 0:
            run_launches[mode] = {
                "launches": dl, "trees": dt,
                "per_tree": (dl / dt) if dt else None}
            launch_total += dl
    # resilience rollup (lightgbm_tpu/resilience.py): every fault the run
    # absorbed, as one named subsection — the drill report reads this
    counters = snap["counters"]
    resilience = {
        "preemptions": int(counters.get("preemptions", 0)),
        "io_retries": int(counters.get("io_retries", 0)),
        "predict_fallbacks": int(counters.get("predict_fallbacks", 0)),
        "checkpoint_skipped": int(counters.get("checkpoint_skipped", 0)),
        "preempt_checkpoint_s": hists.get("preempt_checkpoint_s",
                                          {"count": 0}),
        "watchdog_stall_s": gauges.get("watchdog_stall_s"),
    }
    out: Dict[str, Any] = {
        "v": EVENT_SCHEMA_VERSION,
        "metric": "telemetry_run",
        "unit": "row-trees/s",
        "value": value,
        "iterations": iters,
        "rows": rows,
        "wall_s": wall,
        "rows_per_s": hists.get("chunk_rows_per_s", {"count": 0}),
        "ns_per_row": hists.get("chunk_ns_per_row", {"count": 0}),
        "host_phases": phases,
        "counters": snap["counters"],
        "gauges": gauges,
        "histograms": hists,
        "recompiles": run_recompiles,
        "recompile_total": sum(run_recompiles.values()),
        "tree_kernel_launches": run_launches,
        "tree_kernel_launch_total": launch_total,
        "resilience": resilience,
        "mfu": gauges.get("mfu"),
        "device_util": gauges.get("device_util"),
        "events": getattr(tele, "event_count", len(tele.events)),
        # pod provenance: which host produced this summary (rank None =
        # single-process run)
        "rank": getattr(tele, "rank", None),
        "host": getattr(tele, "host", None),
    }
    # serving rollup (lightgbm_tpu/serving): per-model qps/latency/occupancy
    # plus eviction/swap counts — present only when the run served traffic
    serving = serving_block(counters, gauges, hists)
    if serving is not None:
        out["serving"] = serving
    # online-learning rollup (online/): train-while-serve cycles by
    # trigger, the live generation and the rows-behind gauge
    online = online_block(counters, gauges, hists)
    if online is not None:
        out["online"] = online
    # explanations rollup (core/predict_contrib.py): contrib
    # dispatch/row counts, per-bucket latency and degraded fallbacks —
    # present only when the run served pred_contrib traffic
    contrib = contrib_block(counters, gauges, hists)
    if contrib is not None:
        out["contrib"] = contrib
    # streaming-ingest rollup (io/loader.py): chunks, binning
    # throughput, pipeline stall and the host RSS high-water — present
    # only when the run streamed its dataset
    ingest = ingest_block(counters, gauges, hists)
    if ingest is not None:
        out["ingest"] = ingest
    # quantized-training rollup (core/quant.py): present only
    # when the run trained with hist_precision=quantized
    quant = quant_block(counters, gauges, hists)
    if quant is not None:
        out["quant"] = quant
    # rollups present only when their run-owned state exists: miss
    # seconds per (fn, bucket) and the card's memory high-water
    acct = getattr(tele, "compile_acct", None)
    if acct is not None:
        comp = acct.snapshot()
        if comp:
            out["compile"] = comp
    from . import devmem as _devmem
    dm = _devmem.snapshot(tele)
    if dm:
        out["devmem"] = dm
    # profiler captures and the live-alert tally (report.py:339-351 of the
    # JAX package)
    from . import profiling as _profiling
    prof = _profiling.snapshot(tele)
    if prof:
        out["profiling"] = prof
    eng = getattr(tele, "alerts", None)
    if eng is not None:
        out["alerts"] = eng.snapshot()
    elif counters.get("alerts_fired"):
        # out-of-band incidents (a watchdog stall without an engine)
        out["alerts"] = {"enabled": False, "series": [],
                         "fired_total": int(counters["alerts_fired"])}
    # kernel-plan provenance (plan/): which plan each site dispatched
    # under, the engaged cache and its always-on fallback counter
    stamps = getattr(tele, "plan_stamps", None)
    if stamps:
        from ..plan import cache as _plan_cache
        from ..plan import state as _plan_state
        sites = {site: {k: v for k, v in info.items() if k != "_tag"}
                 for site, info in stamps.items()}
        provs = {info["provenance"] for info in sites.values()}
        headline = ("pinned" if "pinned" in provs
                    else "tuned" if "tuned" in provs else "analytic")
        out["plan"] = {
            "provenance": headline,
            "sites": sites,
            "cache_path": _plan_state.configured_path(),
            "cache_fallbacks": _plan_cache.fallback_count(),
        }
    # model-quality rollup (obs/quality.py): per-model drift PSI/JS ranked
    # by importance, score PSI, generation + freshness — present only when
    # the run monitored traffic
    mon = getattr(tele, "quality", None)
    if mon is not None:
        q = mon.snapshot()
        if q:
            out["quality"] = q
    if extra:
        out.update(extra)
    return out


def human_table(summary: Dict[str, Any]) -> str:
    """Render a summary dict as the end-of-run report table."""
    lines = ["telemetry summary"]

    def row(k, v):
        lines.append("  %-34s %s" % (k, v))

    def num(v, fmt="%.6g"):
        return "-" if v is None else (fmt % v)

    row("row-trees/s", num(summary.get("value"), "%.1f"))
    row("iterations", num(summary.get("iterations"), "%d")
        if summary.get("iterations") is not None else "-")
    row("wall_s", num(summary.get("wall_s")))
    row("mfu", num(summary.get("mfu")))
    row("device_util", num(summary.get("device_util")))
    row("recompiles (total)", "%d" % summary.get("recompile_total", 0))
    for key, n in sorted((summary.get("recompiles") or {}).items()):
        row("  recompile %s" % key, "%d" % n)
    if summary.get("tree_kernel_launch_total"):
        row("tree kernel launches (total)",
            "%d" % summary["tree_kernel_launch_total"])
        for mode, d in sorted((summary.get("tree_kernel_launches")
                               or {}).items()):
            per = d.get("per_tree")
            row("  launches[%s]" % mode,
                "%d over %d trees (%s/tree)"
                % (d.get("launches", 0), d.get("trees", 0),
                   "-" if per is None else "%.1f" % per))
    srv = summary.get("serving") or {}
    if srv:
        lines.append("  serving:")
        for name, info in sorted((srv.get("models") or {}).items()):
            lat = info.get("latency_s") or {}
            occ = info.get("occupancy") or {}
            row("    model %s" % name,
                "req=%d rows=%d qps=%s p50=%s p99=%s occ=%s fb=%d"
                % (info.get("requests", 0), info.get("rows", 0),
                   "-" if info.get("qps") is None else "%.1f" % info["qps"],
                   "-" if not lat.get("count") else "%.6g" % lat["p50"],
                   "-" if not lat.get("count") else "%.6g" % lat["p99"],
                   "-" if not occ.get("count") else "%.2f" % occ["p50"],
                   info.get("fallbacks", 0)))
        row("    batches", "%d (single-row fast %d)"
            % (srv.get("batches", 0), srv.get("single_row_fast", 0)))
        prec = srv.get("precisions") or {}
        if prec:
            row("    precision tiers",
                " ".join("%s: req=%d rows=%d"
                         % (tier, info.get("requests", 0),
                            info.get("rows", 0))
                         for tier, info in sorted(prec.items())))
        qd = srv.get("queue_depth") or {}
        if qd.get("count"):
            row("    queue depth", "p50=%.6g p99=%.6g"
                % (qd.get("p50", float("nan")), qd.get("p99", float("nan"))))
        row("    evictions/swaps/readmits", "%d/%d/%d"
            % (srv.get("evictions", 0), srv.get("swaps", 0),
               srv.get("readmits", 0)))
        if srv.get("rejected") or srv.get("failed"):
            row("    rejected/failed", "%d/%d"
                % (srv.get("rejected", 0), srv.get("failed", 0)))
    qual = summary.get("quality") or {}
    if qual.get("models"):
        lines.append("  quality:")
        for name, info in sorted(qual["models"].items()):
            row("    model %s" % name,
                "gen=%s rows=%d level=%s psi_max=%s@%s score_psi=%s "
                "behind=%ss/%srows"
                % (info.get("generation"), info.get("rows", 0),
                   info.get("level", "ok"),
                   "-" if info.get("psi_max") is None
                   else "%.4f" % info["psi_max"],
                   info.get("feature_max") or "-",
                   "-" if info.get("score_psi") is None
                   else "%.4f" % info["score_psi"],
                   "-" if info.get("seconds_behind") is None
                   else "%.0f" % info["seconds_behind"],
                   "-" if info.get("rows_behind") is None
                   else "%d" % info["rows_behind"]))
            for f in (info.get("features") or [])[:5]:
                row("      %s" % f.get("name"),
                    "psi=%.4f js=%.4f imp=%.4f"
                    % (f.get("psi", 0.0), f.get("js", 0.0),
                       f.get("importance", 0.0)))
    ctb = summary.get("contrib") or {}
    if ctb:
        lines.append("  contrib:")
        row("    calls/rows", "%d/%d (serve requests %d, fallbacks %d)"
            % (ctb.get("calls", 0), ctb.get("rows", 0),
               ctb.get("serve_requests", 0), ctb.get("fallbacks", 0)))
        for bucket, h in sorted((ctb.get("latency_s") or {}).items(),
                                key=lambda kv: int(kv[0])):
            if h.get("count"):
                row("    bucket %s" % bucket, "n=%d p50=%.6g p99=%.6g"
                    % (h["count"], h.get("p50", float("nan")),
                       h.get("p99", float("nan"))))
    ing = summary.get("ingest") or {}
    if ing:
        lines.append("  ingest:")
        rps = ing.get("rows_per_s") or {}
        row("    chunks/rows", "%d/%d"
            % (ing.get("chunks", 0), ing.get("rows", 0)))
        if rps.get("count"):
            row("    chunk rows/s", "p50=%.6g p99=%.6g"
                % (rps.get("p50", float("nan")),
                   rps.get("p99", float("nan"))))
        row("    pipeline stall_ms",
            "-" if ing.get("stall_ms") is None
            else "%.3f" % ing["stall_ms"])
        hw = ing.get("rss_high_water_bytes")
        row("    host rss high-water",
            "-" if hw is None else "%.1f MiB" % (hw / (1 << 20)))
    qnt = summary.get("quant") or {}
    if qnt:
        lines.append("  quant:")
        row("    chunks/iterations", "%d/%d"
            % (qnt.get("chunks", 0), qnt.get("iterations", 0)))
        row("    levels (grad/hess)", "%s/%s"
            % (num(qnt.get("grad_levels"), "%d")
               if qnt.get("grad_levels") is not None else "-",
               num(qnt.get("hess_levels"), "%d")
               if qnt.get("hess_levels") is not None else "-"))
        row("    hist operand channels",
            "-" if qnt.get("hist_channels") is None
            else "%d" % qnt["hist_channels"])
    comp = summary.get("compile") or {}
    if comp.get("keys"):
        lines.append("  compile:")
        row("    compile_seconds_total",
            "%.6g (compiles %d, warm loads %d%s)"
            % (comp.get("compile_seconds_total", 0.0),
               comp.get("compiles", 0), comp.get("warm_loads", 0),
               (", unresolved %d" % comp["unresolved"])
               if comp.get("unresolved") else ""))
        for key, info in sorted(comp["keys"].items()):
            steady = info.get("steady_p50_s")
            row("    %s" % key,
                "n=%d warm=%d compile_s=%.6g steady_p50=%s"
                % (info.get("compiles", 0), info.get("warm_loads", 0),
                   info.get("compile_s", 0.0),
                   "-" if steady is None else "%.6g" % steady))
    dm = summary.get("devmem") or {}
    if dm.get("devices"):
        lines.append("  devmem:")
        row("    peak_bytes_max", "%d" % dm.get("peak_bytes_max", 0))
        for dev, ms in sorted(dm["devices"].items()):
            row("    device %s" % dev,
                " ".join("%s=%d" % (k, v) for k, v in sorted(ms.items())))
    onl = summary.get("online") or {}
    if onl:
        lines.append("  online:")
        trig = onl.get("triggers") or {}
        row("    cycles", "%d (%s) gen=%s rows_behind=%s"
            % (onl.get("cycles", 0),
               ", ".join("%s=%d" % kv for kv in sorted(trig.items()))
               or "-", onl.get("generation"), onl.get("rows_behind")))
    plan = summary.get("plan") or {}
    if plan:
        row("plan provenance", "%s (cache=%s, fallbacks=%d)"
            % (plan.get("provenance", "analytic"),
               plan.get("cache_path") or "-",
               plan.get("cache_fallbacks", 0)))
    al = summary.get("alerts") or {}
    if al:
        lines.append("  alerts:")
        row("    fired_total", "%d" % al.get("fired_total", 0))
        for st in al.get("series") or []:
            if st.get("state") == "firing":
                row("    %s[%s]" % (st.get("rule"), st.get("series", "-")),
                    "firing value=%s" % st.get("value", "-"))
    prof = summary.get("profiling") or {}
    for c in prof.get("captures") or []:
        row("  profiler capture #%d %s" % (c.get("n", 0),
                                           c.get("reason", "?")),
            c.get("error") or c.get("dir", "-"))
    res = summary.get("resilience") or {}
    shown = {k: v for k, v in sorted(res.items())
             if (isinstance(v, (int, float)) and v)
             or (isinstance(v, dict) and v.get("count"))}
    if shown:
        lines.append("  resilience:")
        for k, v in shown.items():
            if isinstance(v, dict):
                row("    " + k, "n=%d p50=%.6g p99=%.6g"
                    % (v["count"], v.get("p50", float("nan")),
                       v.get("p99", float("nan"))))
            else:
                row("    " + k, num(v))
    for name, h in sorted((summary.get("histograms") or {}).items()):
        if h.get("count"):
            row(name, "n=%d p50=%.6g p99=%.6g sum=%.6g"
                % (h["count"], h.get("p50", float("nan")),
                   h.get("p99", float("nan")), h.get("sum", 0.0)))
    phases = summary.get("host_phases") or {}
    if phases:
        lines.append("  host phases:")
        for name, tot in sorted(phases.items(), key=lambda kv: -kv[1]):
            row("    " + name, "%.6f s" % tot)
    counters = summary.get("counters") or {}
    for name, v in sorted(counters.items()):
        row("counter " + name, "%d" % v)
    return "\n".join(lines)


def _feature_importance_block(gbdt, top_n: int = 50):
    """{"split": {name: n}, "gain": {name: x}} for the trained model's
    nonzero-importance features (top ``top_n`` by gain); None for models
    with no trees or no importance surface."""
    try:
        split = gbdt.feature_importance("split")
        gain = gbdt.feature_importance("gain")
    except Exception:
        return None
    names = list(getattr(gbdt, "feature_names", []) or [])

    def nm(i):
        return names[i] if i < len(names) else "Column_%d" % i

    order = sorted(range(len(gain)), key=lambda i: (-gain[i], i))
    order = [i for i in order if split[i] > 0 or gain[i] > 0][:top_n]
    if not order:
        return None
    return {"split": {nm(i): int(split[i]) for i in order},
            "gain": {nm(i): round(float(gain[i]), 6) for i in order}}


def finalize_run(tele: Telemetry, gbdt=None, wall_s: Optional[float] = None,
                 iters: Optional[int] = None,
                 extra: Optional[Dict[str, Any]] = None,
                 summary_path: Optional[str] = None) -> Dict[str, Any]:
    """Close out a telemetry run: record headline gauges, write
    ``<out>.summary.json`` next to the JSONL, emit a ``run_end`` event, and
    return the summary dict.

    Gauges the training driver already recorded WIN: ``GBDT.train`` times
    the train loop only, while a CLI caller's ``wall_s`` spans dataset
    loading and compile too — overwriting would make the same training
    produce different row-trees/s headlines per entry point.  The
    ``wall_s``/``iters`` arguments are the fallback for runs that never
    went through a recording driver (a caller's own timed window)."""
    from ..utils.log import Log
    if wall_s is not None and tele.gauge("train_wall_s").value is None:
        tele.gauge("train_wall_s").set(wall_s)
    if iters is not None and tele.gauge("train_iterations").value is None:
        tele.gauge("train_iterations").set(iters)
    eff_wall = tele.gauge("train_wall_s").value
    eff_iters = tele.gauge("train_iterations").value
    if gbdt is not None:
        if tele.gauge("train_rows").value is None:
            tele.gauge("train_rows").set(int(gbdt.num_data))
        if eff_wall:
            # the cost model's shares of the card (report.py:656 of the
            # JAX package)
            from .mfu import record_training_estimate
            record_training_estimate(
                tele, gbdt, eff_wall,
                iters=int(eff_iters) if eff_iters else None)
        # split/gain feature importance rides the summary: the quality
        # table ranks drifted features by importance x PSI, and the
        # artifact should carry the ranking weights it used (top 50 by
        # gain to bound artifact size)
        fi = _feature_importance_block(gbdt)
        if fi is not None:
            extra = dict(extra or {})
            extra.setdefault("feature_importance", fi)
    # one final devmem poll so the summary's high-water covers the whole
    # run even when no exporter ever scraped (empty on a CPU run)
    from . import devmem as _devmem
    _devmem.sample(tele, phase="finalize")
    summary = summarize(tele, extra=extra)
    tele.event("run_end", wall_s=wall_s, iterations=iters)
    path = summary_path
    if path is None and tele.out_path:
        # the summary is named from the UNsharded base so the leader's
        # <out>.summary.json sits next to every rank's shard
        path = (getattr(tele, "summary_base", None)
                or tele.out_path) + ".summary.json"
    if path and getattr(tele, "rank", None) not in (None, 0):
        # leader-only file discipline: non-leader ranks keep their shard
        # JSONL but must not race d hosts over one summary path
        path = None
    if path:
        from ..utils.file_io import atomic_write
        atomic_write(path, json.dumps(summary, indent=1, default=str))
        Log.info("Wrote telemetry summary %s", path)
    tele.flush()
    Log.debug("%s", human_table(summary))
    return summary
