#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--rows 1048576] [--iters 5] [--profile]

It builds the hand-written CUDA kernels from ``lightgbm_tpu_torch/csrc`` into
``build/kernels`` (``nvcc``, ``sm_90a``, one process per source, all started
together) and runs these phases, each of which raises on failure:

1. environment: the card's name and power limit, torch/CUDA versions, the
   kernels' build time and ``ptxas`` resource lines;
2. the histogram kernel against its plain PyTorch version on the card, at the
   main path's shapes (W=128, F=28, B=256 and 64; full, mid and 100-row
   windows) and at u16 (bpc=2), nibble-packed and feature-window shapes;
   then the integer histogram kernel (quantized gradients) at the same
   shapes and on a window of more than 8.4M rows of hess 255 in one bin,
   whose sum needs the kernel's int64 reduction;
3. the fused split kernel against its plain version on the card, over window
   sizes (<= 992 rows, ~10k, >= 500k, empty) and routes (numerical, NaN missing
   with default left and right, zero missing, categorical bitset, EFB unfold);
   then the level-batched split kernel against G single-window kernel calls
   and against its plain version, exact and quantized, over frontiers: one
   whole-store window, a full level-7 frontier of 127 adjacent windows, a
   mix of small, ~10k-row and empty windows, and the route matrix;
4. the main paths: the Higgs-shaped binary GBDT of ``bench.py`` (seed 0, 28
   features, max_bin=255, num_leaves=255, learning_rate=0.1) trained on the
   card through ``BinnedDataset.from_matrix`` -> ``Config`` -> ``GBDT`` ->
   ``train_one_iter`` -> ``predict``, three ways in one call: (A) leaf-wise,
   exact; (B) ``tree_grow_mode=level``, exact; (C) ``tree_grow_mode=level``
   with ``hist_precision=quantized``.  The kernels' launch counts are set to
   0 just before each path and read just after it; each path's predictions
   are held against the host trees' ``Tree.predict`` and its train scores,
   and its tree 0 is rebuilt with the plain versions as a check;
5. times of each kernel at the main paths' shapes beside its bound, its
   plain version and one PyTorch library call.

Tolerances: a histogram may differ from the plain version's only by float
summation order, so ``max|diff| <= 1e-5 * max|bin sum|``; integer histograms
(quantized gradients), row stores and left counts must be equal bit for bit;
the level-batched pass must equal G single-window kernel calls bit for bit;
two launches on the same input must give the same bits.

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
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores;
                              # it also stands in for 32-bit integer adds
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
               quantized: bool = False, device, seed: int = 0) -> tuple:
    """A random [n + 4096, W] row store (bins, f32 grad/hess, s32 order) made
    on ``device`` from ``seed``; returns (rows, voff).  ``quantized``: the
    grad/hess are integers in [-127, 127] and [0, 255], as
    ``hist_precision=quantized`` stores them."""
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
    if quantized:
        vals = torch.stack([
            torch.randint(-127, 128, (total,), generator=g, device=device),
            torch.randint(0, 256, (total,), generator=g, device=device)],
            1).float()
    else:
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


def phase_histogram_int(device, n: int) -> float:
    """Phase 2, second part: the integer histogram kernel against its plain
    version (int64 sums): bit-equal and bitwise repeatable."""
    from lightgbm_tpu_torch.core import histogram as H

    def check(rows, B, start, count, what, **kw):
        a = H.histogram_rows(rows, B, start, count, quantized=True, **kw)
        a2 = H.histogram_rows(rows, B, start, count, quantized=True, **kw)
        b = H.histogram_rows_plain(rows, B, start, count, quantized=True,
                                   **kw)
        if not torch.equal(a, b):
            raise AssertionError("%s: differs from the plain version, "
                                 "max|diff| %.3g" % (what, float(
                                     (a - b).abs().max())))
        if not torch.equal(a, a2):
            raise AssertionError(what + ": two launches differ")
        log("  %-40s bit-equal, bitwise-repeatable" % what)
        return a

    for F, B in ((28, 256), (28, 64)):
        rows, voff = make_store(n, F, B, quantized=True, device=device,
                                seed=11)
        for start, count in [(0, n), (12345, 20000), (777, 100), (5, 0)]:
            check(rows, B, start, count, "int hist F=%d B=%d [%d, +%d)"
                  % (F, B, start, count), num_features=F, voff=voff)
        del rows
    m = max(n // 4, 1000)
    for name, B, bpc, packed in (("bpc=2", 512, 2, False),
                                 ("packed", 32, 1, True)):
        rows, voff = make_store(m, 28, B, bpc=bpc, packed=packed,
                                quantized=True, device=device, seed=12)
        for start, count in [(0, m), (301, m // 3)]:
            check(rows, B, start, count, "int hist %s F=28 B=%d [%d, +%d)"
                  % (name, B, start, count), num_features=28, voff=voff,
                  bpc=bpc, packed=packed)
        del rows
    # more than 2**31 / 255 rows of hess 255 in one bin: the window's sum
    # exceeds int32 and needs the int64 reduction
    big = 8_500_000
    rows = torch.zeros((big, 32), dtype=torch.uint8, device=device)
    rows[:, 1] = (torch.arange(big, device=device) % 4).to(torch.uint8)
    gh = torch.empty((big, 2), dtype=torch.float32, device=device)
    gh[:, 0] = torch.where(torch.arange(big, device=device) % 2 == 0,
                           127.0, -127.0)
    gh[:, 1] = 255.0
    rows[:, 4:12] = gh.view(torch.uint8)
    h = check(rows, 32, 0, big, "int hist %d rows of hess 255" % big,
              num_features=2, voff=4)
    want = np.float32(255 * big)
    if not (float(h[0, 1, 0]) == want and 255 * big > 2 ** 31):
        raise AssertionError("int64 reduction: bin sum %r, want %r"
                             % (float(h[0, 1, 0]), want))
    log("  hess sum of one bin %.0f = 255 x %d > 2**31" % (want, big))
    return 0.0


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


def level_frontiers(n: int, B: int, rng: np.random.RandomState) -> dict:
    """Frontiers of the level-batched pass: name -> scal rows [G, S]."""
    F = 28

    def tree_like(windows):
        return [scal_row(wb, wc, (int(rng.randint(F)), int(rng.randint(B)),
                                  int(rng.randint(2)), 0, B, 0, 0, 0, 0),
                         [0] * (B // 32), int(rng.randint(2)))
                for wb, wc in windows]

    bounds = np.linspace(0, n, 128).astype(np.int64)
    mixed = [(100, 900), (1500, 0), (5000, 10000), (20000, 992), (30000, 0),
             (40000, 12345), (60000, 1), (61000, 9999)]
    out = {"one window": tree_like([(0, n)]),
           "level-7 frontier": tree_like(
               [(int(a), int(b - a)) for a, b in zip(bounds, bounds[1:])]),
           "mixed": tree_like([(min(wb, n), max(0, min(wc, n - wb)))
                               for wb, wc in mixed])}
    routes = []
    start = 7
    for (name, (route, words)), wc in zip(split_routes(B, rng).items(),
                                          [900, 10000, n // 4, 0, 37,
                                           n // 8]):
        routes.append(scal_row(start, wc, route, words, len(name) % 2))
        start += wc + 13
    out["route matrix"] = routes
    return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}


def phase_level_split(device, n: int) -> float:
    """Phase 3, second part: the level-batched split kernel against G
    single-window kernel calls (bit for bit) and against its plain version,
    exact and quantized."""
    from lightgbm_tpu_torch.core import partition as P
    rng = np.random.RandomState(8)
    F, B = 28, 256
    worst = 0.0
    frontiers = level_frontiers(n, B, rng)
    for quantized in (False, True):
        rows, voff = make_store(n, F, B, quantized=quantized, device=device,
                                seed=9)
        kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
        for name, scals in frontiers.items():
            what = "level %s %s, %d windows" % (
                "quantized" if quantized else "exact", name, len(scals))
            r1, h1, nl1 = P.partition_hist_level(rows.clone(), scals, **kw)
            r2, h2, nl2 = P.partition_hist_level(rows.clone(), scals, **kw)
            r_seq = rows.clone()
            h_seq, nl_seq = [], []
            for sc in scals:
                r_seq, h, nl = P.partition_hist(r_seq, sc.tolist(), **kw)
                h_seq.append(h.clone())
                nl_seq.append(nl.clone())
            r_p, h_p, nl_p = P.partition_hist_level_plain(rows, scals, **kw)
            if not (torch.equal(r1, r_seq) and torch.equal(r1, r_p)):
                raise AssertionError(what + ": rows_new differs")
            inside = torch.zeros(rows.shape[0], dtype=torch.bool,
                                 device=device)
            for wb, wc in scals[:, :2]:
                inside[int(wb):int(wb + wc)] = True
            if not torch.equal(r1[~inside], rows[~inside]):
                raise AssertionError(what + ": rows outside the windows "
                                     "changed")
            if not (torch.equal(nl1, torch.cat(nl_seq))
                    and torch.equal(nl1, nl_p)):
                raise AssertionError(what + ": nl differs")
            if not torch.equal(h1, torch.stack(h_seq)):
                raise AssertionError(what + ": histograms differ from the "
                                     "single-window kernel calls")
            if quantized:
                if not torch.equal(h1, h_p):
                    raise AssertionError(what + ": histograms differ from "
                                         "the plain version")
                err = 0.0
            else:
                err = hist_err(h1, h_p, what)
            if not (torch.equal(r1, r2) and torch.equal(h1, h2)
                    and torch.equal(nl1, nl2)):
                raise AssertionError(what + ": two runs differ")
            worst = max(worst, err)
            log("  %-46s nl sum %8d  = %d single-window calls bit for bit; "
                "vs plain max|diff| %.3g" % (what, int(nl1.sum()), len(scals),
                                              err))
        del rows
    return worst


# ------------------------------------------------------------ main path ----

def logloss(score: torch.Tensor, label: torch.Tensor) -> float:
    s = score.double()
    return float(torch.mean(torch.nn.functional.softplus(s) - label * s))


PATHS = {
    "A": ("leaf-wise, exact", {}),
    "B": ("tree_grow_mode=level, exact", dict(tree_grow_mode="level")),
    "C": ("tree_grow_mode=level, hist_precision=quantized",
          dict(tree_grow_mode="level", hist_precision="quantized")),
}


def phase_main_path(device, data, ds, path: str, iters: int,
                    profile: bool) -> dict:
    """Phase 4: train the Higgs-shaped binary GBDT on the card along one of
    the main paths (``PATHS``), with the launch counts read around it."""
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.metric.binary import weighted_auc

    X, y, X_test, y_test = data
    n = len(y)
    name, extra = PATHS[path]
    log("  (%s) %s" % (path, name))
    cfg = Config(objective="binary", num_leaves=255, learning_rate=0.1,
                 max_bin=255, verbosity=-1, **extra)
    booster = GBDT(cfg, ds, create_objective("binary", cfg))
    label = torch.as_tensor(y, device=booster.device)

    D.reset_launches()
    iter_s, losses, fetches, levels = [], [], [], []
    for _ in range(iters):
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
        losses.append(logloss(booster.train_score[0], label))
        fetches.append(booster.last_arrays.host_fetches)
        levels.append(booster.last_arrays.levels)
    raw = booster.predict(X_test, raw_score=True)
    counts = D.launches()

    trees = len(booster.models)
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
    log("  device->host fetches per tree %s; level steps per tree %s"
        % (fetches, levels))
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
    expect_launches(path, counts, trees, splits, sum(levels),
                    booster.learner.level_count())
    check_tree0(booster, n, strict=path == "C")
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(booster)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10, 100 - busy_ms / med / 10,
                                    med))
    return {"launches": counts, "iter_s": iter_s, "auc": auc,
            "splits": splits, "trees": trees, "fetches": fetches,
            "levels": levels, "busy_ms": busy_ms}


def expect_launches(path: str, counts: dict, trees: int, splits: int,
                    levels: int, level_count: int) -> None:
    """Each path must run through its kernels and no other: (A) one root
    histogram per tree and one split pass per split; (B) and (C) one root
    histogram (the integer one in (C)) per tree and one level-batched split
    pass per level, ``level_count`` levels per tree."""
    if path == "A":
        want = {"histogram": trees, "partition": splits}
    else:
        if levels != level_count * trees:
            raise AssertionError("%d level steps for %d trees, want %d per "
                                 "tree" % (levels, trees, level_count))
        root = "histogram_int" if path == "C" else "histogram"
        want = {root: trees, "partition_level": levels}
    for k, v in counts.items():
        if v != want.get(k, 0):
            raise AssertionError("path %s: %s launched %d times, want %d"
                                 % (path, k, v, want.get(k, 0)))


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


def check_tree0(booster, n: int, strict: bool) -> None:
    """Rebuild tree 0 on the card with the plain versions (called directly:
    a check, not a path) and hold the kernel-built tree 0 against it.
    ``strict``: integer histograms (quantized) leave no near tie to excuse,
    so every split and gain must be equal."""
    from lightgbm_tpu_torch.core.histogram import histogram_rows_plain
    from lightgbm_tpu_torch.core.partition import (partition_hist_level_plain,
                                                   partition_hist_plain)
    init = booster.objective.boost_from_score(0)
    score0 = torch.zeros(n, dtype=torch.float32, device=booster.device)
    score0 += init
    grad, hess = booster.objective.get_gradients(score0)
    t = time.perf_counter()
    plain = booster.learner.train(grad, hess, n, iteration=0,
                                  hist_fn=histogram_rows_plain,
                                  part_fn=partition_hist_plain,
                                  level_fn=partition_hist_level_plain)
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
        if strict and a != b:
            raise AssertionError(
                "tree 0 split %d: kernel (feature, bin, parent, gain) %s vs "
                "plain %s" % (i, a, b))
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
        "threshold bins, split order%s) and %d leaf counts"
        % (nl - 1, ", gains" if strict else "", nl))


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
    del rows
    out.update(times_quantized_and_level(device, n))
    reset_launches()
    return out


def times_quantized_and_level(device, n: int) -> dict:
    """Phase 5, second part: the integer histogram kernel (quantized store)
    and the level-batched split kernel over one level-0 window and a full
    level-7 frontier of 127 windows, beside the same frontier as G
    single-window calls."""
    from lightgbm_tpu_torch.core import histogram as H
    from lightgbm_tpu_torch.core import partition as P
    F, B = 28, 256
    out = {}
    rows, voff = make_store(n, F, B, quantized=True, device=device, seed=13)
    for count in (n, 20000, 1000):
        kw = dict(num_features=F, voff=voff, quantized=True)
        ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, count,
                                                       **kw), reps=20)
        bins, vals = H.rows_split(rows[:count], F, voff)
        ids = (bins + torch.arange(F, device=device)[None, :] * B).reshape(-1)
        v = vals.t().long()[:, None, :].expand(count, F, 2).reshape(-1, 2)
        acc = torch.zeros((F * B, 2), dtype=torch.int64, device=device)
        lib = cuda_ms(lambda: acc.index_add_(0, ids, v), reps=20)
        # the two 32-byte sectors of bins and g/h per row; two integer adds
        # per (row, feature)
        b_ms, b_by = bound(count * 64 + F * 2 * B * 4, 2.0 * count * F)
        log("  int histogram %8d rows: kernel %.4f ms, bound %.4f ms (%s), "
            "plain %.4f ms, index_add_ (int64) %.4f ms"
            % (count, ms, b_ms, b_by, plain, lib))
        if count == n:
            out["histogram_int"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=lib)
        del bins, vals, ids, v
    del rows
    rng = np.random.RandomState(14)
    fr = level_frontiers(n, B, rng)
    for quantized in (False, True):
        rows, voff = make_store(n, F, B, quantized=quantized, device=device,
                                seed=15)
        kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
        for name in ("one window", "level-7 frontier"):
            scals = fr[name]
            work = rows.clone()
            ms = cuda_ms(lambda: P.partition_hist_level(work, scals, **kw))

            def sequential():
                for sc in scals:
                    P.partition_hist(work, sc.tolist(), **kw)
            seq = cuda_ms(sequential, reps=5, warmup=1)
            plain = cuda_ms(lambda: P.partition_hist_level_plain(
                rows, scals, **kw), reps=3, warmup=1)
            # every window row read once and written once; two adds per
            # (row, feature) of the smaller children
            sum_wc = float(scals[:, 1].sum())
            b_ms, b_by = bound(2.0 * sum_wc * rows.shape[1],
                               2.0 * (sum_wc / 2) * F)
            what = "%s, %s" % ("quantized" if quantized else "exact", name)
            log("  level split pass %-30s (%d windows, %d rows): kernel "
                "%.4f ms, bound %.4f ms (%s), %d single-window calls %.4f "
                "ms, plain %.4f ms, no single library call"
                % (what, len(scals), sum_wc, ms, b_ms, b_by, len(scals), seq,
                   plain))
            if name == "level-7 frontier":
                key = "partition_level_q" if quantized else "partition_level"
                out[key] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                sequential_ms=seq, windows=len(scals))
            del work
        del rows
    return out


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="training rows of the main paths (10500000 is the "
                         "published Higgs size)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of one iteration of "
                         "each main path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch import BinnedDataset, kernels
    from lightgbm_tpu_torch.device import reset_launches
    from lightgbm_tpu_torch.utils.log import Log

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
    log("[2] histogram kernels vs plain versions")
    hist_err_max = phase_histogram(device, args.rows)
    hist_int_err = phase_histogram_int(device, args.rows)
    log("[3] split kernels vs plain versions")
    split_err_max = phase_split(device, args.rows)
    level_err_max = phase_level_split(device, args.rows)
    reset_launches()
    log("  phases 2-3 took %.1f s" % (time.perf_counter() - t))

    log("[4] main paths: %d rows x 28 features, max_bin=255, num_leaves=255, "
        "%d iterations" % (args.rows, args.iters))
    Log.reset_level(Log.level_from_verbosity(-1))
    t0 = time.perf_counter()
    data = synthetic_task(args.rows)
    ds = BinnedDataset.from_matrix(data[0], label=data[1], max_bin=255)
    log("  set-up (data, binning) %.2f s" % (time.perf_counter() - t0))
    paths = {}
    for path in PATHS:
        paths[path] = phase_main_path(device, data, ds, path, args.iters,
                                      args.profile)
        torch.cuda.empty_cache()
    log("  median seconds per iteration: %s" % ", ".join(
        "(%s) %.4f" % (p, float(np.median(r["iter_s"])))
        for p, r in paths.items()))

    log("[5] times (CUDA events, median)")
    times = phase_times(device, args.rows)

    def launches(kernel):
        by_path = {p: r["launches"][kernel] for p, r in paths.items()
                   if r["launches"][kernel]}
        per_tree = {p: v / paths[p]["trees"] for p, v in by_path.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path,
                    launches_per_tree=per_tree)

    kernels_line = {"kernels": [
        dict(name="histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             max_abs_err=hist_err_max, **launches("histogram"),
             **times["histogram"]),
        dict(name="partition", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:1130",
             max_abs_err=split_err_max, **launches("partition"),
             **times["partition"]),
        dict(name="histogram_int", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram_int.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             also_replaces="lightgbm_tpu/core/partition.py:1080",
             max_abs_err=hist_int_err, **launches("histogram_int"),
             **times["histogram_int"]),
        dict(name="partition_level", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition_level.cu",
             replaces="lightgbm_tpu/core/partition.py:1191",
             max_abs_err=level_err_max, **launches("partition_level"),
             quantized_ms=times["partition_level_q"]["ms"],
             **times["partition_level"]),
    ]}
    for k in kernels_line["kernels"]:
        if k["launches"] == 0:
            raise AssertionError("%s was not launched on a main path"
                                 % k["name"])
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
