#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--rows 1048576] [--iters 5] [--profile]

It builds the hand-written CUDA kernels from ``lightgbm_tpu_torch/csrc`` into
``build/kernels`` (``nvcc``, ``sm_90a``) and runs five phases, each of which
raises on failure:

1. environment: the card's name and power limit, torch/CUDA versions, the
   kernels' build time and ``ptxas`` resource lines;
2. the histogram kernel against its plain PyTorch version on the card, at the
   main path's shapes (W=128, F=28, B=256 and 64; full, mid and 100-row
   windows) and at u16 (bpc=2), nibble-packed and feature-window shapes;
3. the fused split kernel against its plain version on the card, over window
   sizes (<= 992 rows, ~10k, >= 500k, empty) and routes (numerical, NaN missing
   with default left and right, zero missing, categorical bitset, EFB unfold);
4. the main path: the Higgs-shaped binary GBDT of ``bench.py`` (seed 0, 28
   features, max_bin=255, num_leaves=255, learning_rate=0.1) trained on the
   card through ``BinnedDataset.from_matrix`` -> ``Config`` -> ``GBDT`` ->
   ``train_one_iter`` -> ``predict``, with the kernels' launch counts read
   around it; its predictions are held against the host trees'
   ``Tree.predict`` and its train scores, and tree 0 is rebuilt with the
   plain versions as a check;
5. times of each kernel at the main path's shapes beside its bound, its plain
   version and one PyTorch library call.

Tolerances: a histogram may differ from the plain version's only by float
summation order, so ``max|diff| <= 1e-5 * max|bin sum|``; row stores and left
counts are integers and must be equal byte for byte; two launches on the same
input must give the same bits.

The line before the last is the card's name and power limit as ``nvidia-smi``
reports them, the one before that a JSON object with every kernel's numbers,
and the last line ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits with code 2 and prints no result.  ``--profile`` adds a
``torch.profiler`` table of one training iteration.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
HIST_RTOL = 1e-5              # of max|bin sum|: summation order only
SPLIT_GAIN_TIE_RTOL = 1e-6    # top-two gains closer than this are a tie
PREDICT_ATOL = 1e-9           # f64 sums of the same leaf values, any order
TRAIN_SCORE_ATOL = 1e-5       # f32 running sum of 6 terms of magnitude < 4


def log(*args) -> None:
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs ----

def make_store(n: int, F: int, B: int, *, bpc: int = 1, packed: bool = False,
               device, seed: int = 0) -> tuple:
    """A random [n + 4096, W] row store (bins, f32 grad/hess, s32 order) made
    on ``device`` from ``seed``; returns (rows, voff)."""
    from lightgbm_tpu_torch.core.tree_learner import CHUNK, row_layout
    g = torch.Generator(device=device).manual_seed(seed)
    ncols = (F + 1) // 2 if packed else F
    lay = row_layout(ncols, bpc)
    total = n + CHUNK
    rows = torch.zeros((total, lay.W), dtype=torch.uint8, device=device)
    hi = min(B, 16) if packed else B
    bins = torch.randint(0, hi, (total, F), generator=g, device=device)
    if packed:
        if F % 2:
            bins = torch.cat([bins, torch.zeros_like(bins[:, :1])], 1)
        rows[:, :ncols] = (bins[:, 0::2] | (bins[:, 1::2] << 4)).to(torch.uint8)
    elif bpc == 2:
        rows[:, 0:2 * F:2] = (bins & 255).to(torch.uint8)
        rows[:, 1:2 * F:2] = (bins >> 8).to(torch.uint8)
    else:
        rows[:, :F] = bins.to(torch.uint8)
    vals = torch.randn((total, 2), generator=g, device=device)
    rows[:, lay.voff:lay.voff + 8] = vals.contiguous().view(torch.uint8)
    order = torch.arange(total, dtype=torch.int32, device=device)
    rows[:, lay.voff + 8:lay.voff + 12] = order.view(torch.uint8).reshape(
        total, 4)
    return rows, lay.voff


def synthetic_task(n: int, f: int = 28, seed: int = 0):
    """bench.py's Higgs-shaped task: the same generator, seed and held-out
    tenth."""
    rng = np.random.RandomState(seed)
    n_test = max(n // 10, 1000)
    X_all = rng.normal(size=(n + n_test, f)).astype(np.float32)
    logit = (X_all[:, 0] * 2 + X_all[:, 1] ** 2 - X_all[:, 2] * X_all[:, 3]
             + rng.normal(scale=0.5, size=n + n_test))
    y_all = (logit > 0).astype(np.float64)
    return X_all[:n], y_all[:n], X_all[n:], y_all[n:]


# ------------------------------------------------------------- checking ----

def hist_err(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """max|a - b|, raising when it exceeds HIST_RTOL of max|b|."""
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    if not err <= HIST_RTOL * scale:
        raise AssertionError("%s: histogram max|diff| %.3g > %.0e * %.3g"
                             % (what, err, HIST_RTOL, scale))
    return err


def phase_histogram(device, n: int) -> float:
    """Phase 2: the histogram kernel against its plain version."""
    from lightgbm_tpu_torch.core import histogram as H
    worst = 0.0
    shapes = [dict(F=28, B=256), dict(F=28, B=64)]
    for shp in shapes:
        rows, voff = make_store(n, shp["F"], shp["B"], device=device, seed=1)
        for start, count in [(0, n), (12345, 20000), (777, 100), (5, 0)]:
            kw = dict(num_features=shp["F"], voff=voff)
            a = H.histogram_rows(rows, shp["B"], start, count, **kw)
            a2 = H.histogram_rows(rows, shp["B"], start, count, **kw)
            b = H.histogram_rows_plain(rows, shp["B"], start, count, **kw)
            what = "hist F=%d B=%d [%d, +%d)" % (shp["F"], shp["B"], start,
                                                 count)
            err = hist_err(a, b, what)
            if not torch.equal(a, a2):
                raise AssertionError(what + ": two launches differ")
            worst = max(worst, err)
            log("  %-34s max|diff| %.3g  bitwise-repeatable" % (what, err))
        del rows
    m = max(n // 4, 1000)
    others = [("bpc=2", dict(F=28, B=512, bpc=2), 0),
              ("packed", dict(F=28, B=32, packed=True), 0),
              ("f_begin", dict(F=28, B=256), 7)]
    for name, shp, f_begin in others:
        rows, voff = make_store(m, shp["F"], shp["B"], bpc=shp.get("bpc", 1),
                                packed=shp.get("packed", False),
                                device=device, seed=2)
        nf = shp["F"] - f_begin - (5 if f_begin else 0)
        kw = dict(num_features=nf, voff=voff, bpc=shp.get("bpc", 1),
                  packed=shp.get("packed", False), f_begin=f_begin)
        for start, count in [(0, m), (301, m // 3)]:
            a = H.histogram_rows(rows, shp["B"], start, count, **kw)
            a2 = H.histogram_rows(rows, shp["B"], start, count, **kw)
            b = H.histogram_rows_plain(rows, shp["B"], start, count, **kw)
            what = "hist %s F=%d B=%d [%d, +%d)" % (name, nf, shp["B"], start,
                                                    count)
            err = hist_err(a, b, what)
            if not torch.equal(a, a2):
                raise AssertionError(what + ": two launches differ")
            worst = max(worst, err)
            log("  %-34s max|diff| %.3g  bitwise-repeatable" % (what, err))
        del rows
    return worst


def split_routes(B: int, rng: np.random.RandomState) -> dict:
    """scal rows 2..11 and bitset words of each route to cover
    (partition.py:1030-1037)."""
    nw = B // 32
    words = [int(w) for w in rng.randint(-2 ** 31, 2 ** 31, size=nw)]
    zero = [0] * nw
    # (group_col, threshold, default_left, missing_type, num_bin, default_bin,
    #  is_cat, use_unfold, efb_offset), bitset words
    return {
        "numerical": ((3, B // 2, 0, 0, B, 0, 0, 0, 0), zero),
        "nan_left": ((5, B // 3, 1, 1, B, 0, 0, 0, 0), zero),
        "nan_right": ((5, B // 3, 0, 1, B, 0, 0, 0, 0), zero),
        "zero_missing": ((9, B // 2, 1, 2, B, 7, 0, 0, 0), zero),
        "categorical": ((11, 0, 0, 0, B, 0, 1, 0, 0), words),
        "efb_unfold": ((13, 20, 0, 0, 40, 0, 0, 1, 17), zero),
    }


def scal_row(wb, wc, route, words, hist_left) -> list:
    gcol, thr, dleft, mt, nb, dbin, is_cat, unf, eoff = route
    return ([wb, wc, gcol, thr, dleft, mt, nb, dbin, is_cat, hist_left, unf,
             eoff] + list(words))


def check_split(rows, scal, *, F, B, voff, bpc=1, packed=False,
                what="") -> float:
    from lightgbm_tpu_torch.core import partition as P
    kw = dict(num_features=F, num_bins=B, voff=voff, bpc=bpc, packed=packed)
    wb, wc = scal[0], scal[1]
    r_plain, h_plain, nl_plain = P.partition_hist_plain(rows, scal, **kw)
    r1, h1, nl1 = P.partition_hist(rows.clone(), scal, **kw)
    r2, h2, nl2 = P.partition_hist(rows.clone(), scal, **kw)
    if not torch.equal(r1, r_plain):
        raise AssertionError(what + ": rows_new differs from the plain version")
    if not (torch.equal(r1[:wb], rows[:wb])
            and torch.equal(r1[wb + wc:], rows[wb + wc:])):
        raise AssertionError(what + ": rows outside the window changed")
    if int(nl1[0]) != int(nl_plain[0]):
        raise AssertionError("%s: nl %d != plain %d"
                             % (what, int(nl1[0]), int(nl_plain[0])))
    err = hist_err(h1, h_plain, what)
    if not (torch.equal(r1, r2) and torch.equal(h1, h2)
            and torch.equal(nl1, nl2)):
        raise AssertionError(what + ": two runs differ")
    log("  %-40s nl %7d  max|diff| %.3g  bitwise-repeatable"
        % (what, int(nl1[0]), err))
    return err


def phase_split(device, n: int) -> float:
    """Phase 3: the fused split kernel against its plain version."""
    rng = np.random.RandomState(3)
    worst = 0.0
    windows = [(100, 900), (3001, 10000), (4096, max(n // 2 + 75000, 1)),
               (50, 0), (0, n)]
    for B in (256, 64):
        F = 28
        rows, voff = make_store(n, F, B, device=device, seed=4)
        routes = split_routes(B, rng)
        for wi, (wb, wc) in enumerate(windows):
            for name, (route, words) in routes.items():
                if B == 64 and name != "numerical":
                    continue
                scal = scal_row(wb, wc, route, words, (wi + len(name)) % 2)
                what = "split B=%d %s [%d, +%d)" % (B, name, wb, wc)
                worst = max(worst, check_split(rows, scal, F=F, B=B,
                                               voff=voff, what=what))
        del rows
    m = max(n // 8, 8192)
    for name, bpc, packed, B in [("bpc=2", 2, False, 512),
                                 ("packed", 1, True, 32)]:
        rows, voff = make_store(m, 28, B, bpc=bpc, packed=packed,
                                device=device, seed=5)
        nb = 16 if packed else B
        route = (6, nb // 3, 1, 1, nb, 0, 0, 0, 0)
        scal = scal_row(777, m // 2, route, [0] * (B // 32), 1)
        what = "split %s B=%d nan_left [777, +%d)" % (name, B, m // 2)
        worst = max(worst, check_split(rows, scal, F=28, B=B, voff=voff,
                                       bpc=bpc, packed=packed, what=what))
        del rows
    return worst


# ------------------------------------------------------------ main path ----

def logloss(score: torch.Tensor, label: torch.Tensor) -> float:
    s = score.double()
    return float(torch.mean(torch.nn.functional.softplus(s) - label * s))


def phase_main_path(device, n: int, iters: int, profile: bool) -> dict:
    """Phase 4: train the Higgs-shaped binary GBDT on the card."""
    from lightgbm_tpu_torch import (BinnedDataset, Config, GBDT,
                                    create_objective)
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.metric.binary import weighted_auc
    from lightgbm_tpu_torch.utils.log import Log
    Log.reset_level(Log.level_from_verbosity(-1))

    t0 = time.perf_counter()
    X, y, X_test, y_test = synthetic_task(n)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=255)
    cfg = Config(objective="binary", num_leaves=255, learning_rate=0.1,
                 max_bin=255, verbosity=-1)
    booster = GBDT(cfg, ds, create_objective("binary", cfg))
    torch.cuda.synchronize()
    log("  set-up (data, binning, row store upload) %.2f s"
        % (time.perf_counter() - t0))
    label = torch.as_tensor(y, device=booster.device)

    D.reset_launches()
    iter_s, losses = [], []
    for _ in range(iters):
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
        losses.append(logloss(booster.train_score[0], label))
    raw = booster.predict(X_test, raw_score=True)
    counts = D.launches()

    splits = sum(t.num_leaves - 1 for t in booster.models)
    auc = weighted_auc(y_test, raw, None)
    med = float(np.median(iter_s))
    log("  iterations %d, seconds per iteration %s (median %.4f)"
        % (iters, ["%.4f" % s for s in iter_s], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  train logloss per iteration %s" % ["%.6f" % v for v in losses])
    log("  held-out AUC %.6f over %d rows" % (auc, len(y_test)))
    log("  leaves per tree %s, splits %d" % (
        [t.num_leaves for t in booster.models], splits))
    log("  launches on the main path %s" % counts)
    start = logloss(torch.full_like(label, booster.objective.boost_from_score(0)),
                    label)
    if not all(b < a for a, b in zip([start] + losses, losses)):
        raise AssertionError("train logloss did not fall every iteration "
                             "(from %.6f at the initial score)" % start)
    if not np.isfinite(raw).all() or raw.shape != (len(y_test),):
        raise AssertionError("predict gave %s" % (raw.shape,))
    if not auc > 0.75:
        raise AssertionError("held-out AUC %.4f" % auc)
    check_predictions(booster, X, X_test, raw)
    if counts["histogram"] < iters:
        raise AssertionError("histogram kernel launched %d times for %d trees"
                             % (counts["histogram"], iters))
    if counts["partition"] != splits:
        raise AssertionError("split kernel launched %d times for %d splits"
                             % (counts["partition"], splits))

    trees = len(booster.models)
    check_tree0(booster, ds, n)
    if profile:
        busy_ms = profile_iteration(booster)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10, 100 - busy_ms / med / 10,
                                    med))
    return {"launches": counts, "iter_s": iter_s, "auc": auc,
            "splits": splits, "trees": trees}


def check_predictions(booster, X, X_test, raw, k: int = 2000) -> None:
    """The card's predictions against the host trees' own ``Tree.predict``
    (numpy, f64) on ``k`` held-out rows, and the card's f32 train scores
    (accumulated through the binned routes) against ``predict`` on ``k``
    training rows."""
    host = sum(t.predict(X_test[:k].astype(np.float64))
               for t in booster.models)
    err = float(np.abs(raw[:k] - host).max())
    if not err <= PREDICT_ATOL:
        raise AssertionError("card predict vs host Tree.predict: max|diff| "
                             "%.3g > %.0e" % (err, PREDICT_ATOL))
    train = booster.train_score[0, :k].double().cpu().numpy()
    err_t = float(np.abs(booster.predict(X[:k], raw_score=True)
                         - train).max())
    if not err_t <= TRAIN_SCORE_ATOL:
        raise AssertionError("train score vs predict on training rows: "
                             "max|diff| %.3g > %.0e" % (err_t,
                                                       TRAIN_SCORE_ATOL))
    log("  predict vs host Tree.predict on %d held-out rows: max|diff| %.3g; "
        "train score vs predict on %d training rows: max|diff| %.3g"
        % (k, err, k, err_t))


def check_tree0(booster, ds, n: int) -> None:
    """Rebuild tree 0 on the card with the plain versions (called directly:
    a check, not a path) and hold the kernel-built tree 0 against it."""
    from lightgbm_tpu_torch.core.histogram import histogram_rows_plain
    from lightgbm_tpu_torch.core.partition import partition_hist_plain
    init = booster.objective.boost_from_score(0)
    score0 = torch.zeros(n, dtype=torch.float32, device=booster.device)
    score0 += init
    grad, hess = booster.objective.get_gradients(score0)
    t = time.perf_counter()
    plain = booster.learner.train(grad, hess, n,
                                  hist_fn=histogram_rows_plain,
                                  part_fn=partition_hist_plain)
    torch.cuda.synchronize()
    log("  tree 0 rebuilt with the plain versions in %.3f s"
        % (time.perf_counter() - t))
    tree = booster.models[0]
    kern = split_sequence(tree.split_feature_inner, tree.threshold_in_bin,
                          tree.left_child, tree.right_child,
                          tree.split_gain, tree.num_leaves)
    ref = split_sequence(plain.split_feature, plain.threshold_bin,
                         plain.left_child, plain.right_child,
                         plain.split_gain, plain.num_leaves)
    for i, (a, b) in enumerate(zip(kern, ref)):
        if a[:3] != b[:3]:
            rel = abs(a[3] - b[3]) / max(abs(a[3]), abs(b[3]), 1e-30)
            if rel < SPLIT_GAIN_TIE_RTOL:
                log("  tree 0: split %d is a near tie (gains %.9g vs %.9g, "
                    "rel %.2g); the trees agree up to it" % (i, a[3], b[3],
                                                              rel))
                return
            raise AssertionError(
                "tree 0 split %d: kernel (feature, bin, parent) %s gain %.9g "
                "vs plain %s gain %.9g" % (i, a[:3], a[3], b[:3], b[3]))
    nl = tree.num_leaves
    counts_k = np.asarray(tree.leaf_count[:nl], np.int64)
    counts_p = np.round(plain.leaf_count[:nl]).astype(np.int64)
    if plain.num_leaves != nl or not np.array_equal(counts_k, counts_p):
        raise AssertionError("tree 0: leaf counts differ from the plain "
                             "rebuild")
    log("  tree 0 equal to the plain rebuild: %d splits (features, "
        "threshold bins, split order) and %d leaf counts" % (nl - 1, nl))


def split_sequence(feature, threshold, left, right, gain, num_leaves):
    """Splits in the order they were made: (feature, threshold bin, (parent
    node, side), gain) per node; node i is the i-th split."""
    m = num_leaves - 1
    parent = {0: (-1, 0)}
    for p in range(m):
        for side, c in ((0, int(left[p])), (1, int(right[p]))):
            if c >= 0:
                parent[c] = (p, side)
    return [(int(feature[i]), int(threshold[i]), parent[i], float(gain[i]))
            for i in range(m)]


def profile_iteration(booster) -> None:
    """One more training iteration under ``torch.profiler``: the kernels by
    device time, and the device's busy share of the iteration's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=25))
    # device time = the kernels' own rows (the operators' rows repeat it)
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    log("  profiled iteration: wall %.3f ms (profiler overhead included), "
        "device busy %.3f ms" % (wall_ms, busy_ms))
    return busy_ms


# ---------------------------------------------------------------- times ----

def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(device, n: int) -> dict:
    """Phase 5: kernel, bound, plain and library times at the main path's
    shapes: the root histogram and the root split's window of an n-row,
    28-feature, 256-bin store."""
    from lightgbm_tpu_torch.core import histogram as H
    from lightgbm_tpu_torch.core import partition as P
    from lightgbm_tpu_torch.device import reset_launches
    F, B = 28, 256
    out = {}
    rows, voff = make_store(n, F, B, device=device, seed=6)
    for count in (n, 20000, 1000):
        kw = dict(num_features=F, voff=voff)
        ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, count,
                                                       **kw), reps=20)
        bins, vals = H.rows_split(rows[:count], F, voff)
        ids = (bins + torch.arange(F, device=device)[None, :] * B).reshape(-1)
        v = vals.t()[:, None, :].expand(count, F, 2).reshape(-1, 2)
        acc = torch.zeros((F * B, 2), dtype=torch.float32, device=device)
        lib = cuda_ms(lambda: acc.index_add_(0, ids, v), reps=20)
        # bins and g/h sit in two 32-byte sectors of each 128-byte row; two
        # adds per (row, feature)
        b_ms, b_by = bound(count * 64 + F * 2 * B * 4, 2.0 * count * F)
        log("  histogram %8d rows: kernel %.4f ms, bound %.4f ms (%s), plain "
            "%.4f ms, index_add_ %.4f ms" % (count, ms, b_ms, b_by, plain, lib))
        if count == n:
            out["histogram"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib)
        del bins, vals, ids, v
    rng = np.random.RandomState(7)
    route, words = split_routes(B, rng)["numerical"]
    for wc in (n, 20000, 900):
        scal = scal_row(0, wc, route, words, 1)
        kw = dict(num_features=F, num_bins=B, voff=voff)
        work = rows.clone()
        ms = cuda_ms(lambda: P.partition_hist(work, scal, **kw))
        plain = cuda_ms(lambda: P.partition_hist_plain(rows, scal, **kw),
                        reps=20)
        # each window row read once and written once; the child histogram's
        # adds are two per (row, feature) of the smaller child
        b_ms, b_by = bound(2.0 * wc * rows.shape[1], 2.0 * (wc / 2) * F)
        log("  split pass %8d rows: kernel %.4f ms, bound %.4f ms (%s), plain "
            "%.4f ms, no single library call" % (wc, ms, b_ms, b_by, plain))
        if wc == n:
            out["partition"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
        del work
    reset_launches()
    return out


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="training rows of the main path (10500000 is the "
                         "published Higgs size)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of one iteration")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch import kernels
    from lightgbm_tpu_torch.device import reset_launches

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_name_and_power()
    log("[1] environment")
    log("  %s" % card)
    log("  python %s, torch %s, CUDA %s, %s x%d"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count()))
    kernels.build()
    log("  kernels built in %.2f s" % kernels.build_seconds())
    for name, text in kernels.ptxas_log().items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line:
                log("  %s: %s" % (name, line.strip()))

    t = time.perf_counter()
    log("[2] histogram kernel vs plain version")
    hist_err_max = phase_histogram(device, args.rows)
    log("[3] fused split kernel vs plain version")
    split_err_max = phase_split(device, args.rows)
    reset_launches()
    log("  phases 2-3 took %.1f s" % (time.perf_counter() - t))

    log("[4] main path: %d rows x 28 features, max_bin=255, num_leaves=255, "
        "%d iterations" % (args.rows, args.iters))
    main_path = phase_main_path(device, args.rows, args.iters, args.profile)

    log("[5] times (CUDA events, median)")
    times = phase_times(device, args.rows)
    trees = main_path["trees"]
    kernels_line = {"kernels": [
        dict(name="histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             launches=main_path["launches"]["histogram"],
             launches_per_tree=main_path["launches"]["histogram"] / trees,
             max_abs_err=hist_err_max, **times["histogram"]),
        dict(name="partition", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:1130",
             launches=main_path["launches"]["partition"],
             launches_per_tree=main_path["launches"]["partition"] / trees,
             max_abs_err=split_err_max, **times["partition"]),
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
