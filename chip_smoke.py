#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--rows 1048576] [--iters 5] [--widef-rows 400000]
                          [--widef-test-rows 100000] [--profile]

It builds the hand-written CUDA kernels from ``lightgbm_tpu_torch/csrc`` into
``build/kernels`` (``nvcc``, ``sm_90a``, one process per source, all started
together) and runs these phases, each of which raises on failure:

1. environment: the card's name and power limit, torch/CUDA versions, the
   kernels' build time and ``ptxas`` resource lines;
2. the histogram kernels against their plain PyTorch versions on the card:
   the row-store kernel at the Higgs shapes (W=128, F=28, B=256 and 64;
   full, mid, 100-row and empty windows) and at u16 (bpc=2), nibble-packed
   and feature-window shapes; the integer kernel (quantized gradients) at
   the same shapes plus a 1,000-row window, on windows its blocks write
   themselves and windows whose features several blocks share, and on a
   window of more than 8.4M rows of hess 255 in one bin, whose sum needs
   its int64 reduction; both again at the wide
   Epsilon shape (TPU kernel #2: F=2000, W=2048, B=256 and 64, bpc 1 and 2,
   nibble-packed at B=32, full, mid, 100-row and empty windows); and the
   masked bins/values kernel (TPU kernel #5) at 1,048,576 rows, F=28,
   B=64, 128 and 256, with u8, i16, i32 and nibble-packed bins, full and
   mid windows;
3. the fused split kernel against its plain version on the card, over window
   sizes (<= 992 rows, ~10k, >= 500k, empty) and routes (numerical, NaN missing
   with default left and right, zero missing, categorical bitset, EFB unfold);
   the level-batched split kernel (from one row store into a second)
   against G single-window kernel calls and against its plain version,
   exact and quantized, with every row outside the windows untouched in
   both stores, over frontiers: one
   whole-store window, a full level-7 frontier of 127 adjacent windows, a
   mix of small, ~10k-row and empty windows, and the route matrix; both
   split kernels again at F=2000 (the single-window one over five windows
   and two routes, the level one over one window and a level-7 frontier),
   exact and quantized; and the batched split scan of a level of 256
   children x 2000 features x 256 bins in one call, with its peak memory;
4. the main paths, with the kernels' launch counts set to 0 just before each
   and read just after it: the Higgs-shaped binary GBDT of ``bench.py``
   (seed 0, 28 features, max_bin=255, num_leaves=255, learning_rate=0.1)
   trained through ``BinnedDataset.from_matrix`` -> ``Config`` -> ``GBDT`` ->
   ``train_one_iter`` -> ``predict`` three ways: (A) leaf-wise, exact; (B)
   ``tree_grow_mode=level``, exact; (C) ``tree_grow_mode=level`` with
   ``hist_precision=quantized``; each path's predictions are held against
   the host trees' ``Tree.predict`` and its train scores, and its tree 0 is
   rebuilt with the plain versions as a check; (D) the Epsilon-shaped
   binary GBDT (400,000 training and 100,000 held-out rows of 2000 dense
   features made from a seed; the reference's published GPU settings:
   max_bin=255, num_leaves=255, learning_rate=0.1, min_data_in_leaf=1,
   min_sum_hessian_in_leaf=100, metric=auc, leaf-wise, exact) trained
   through ``lightgbm_tpu_torch.train`` with the held-out set as a
   validation set: 1 root histogram and 1 split pass per split, log loss
   falling every iteration, the held-out AUC of every iteration, the
   validation scores of training equal to ``Booster.predict``, tree 0 equal
   to its plain rebuild; (E) ``build_histogram`` (kernel #5's caller) over
   1,048,576 rows x 28 features;
5. times of each kernel at the main paths' shapes beside its bound, its
   plain version and one PyTorch library call (``index_add_``; for a split
   pass, which has none, the window's device-to-device copy): the
   histograms and split passes on the root window and on child-sized
   windows of 20,000 and 1,000 rows.  Times are CUDA-event medians of one
   call, the wrapper's host work included; each histogram, split pass and
   their ``index_add_`` or copy also get a queued time, the device time of
   one call when 25 calls are queued behind a sleeping kernel and run back
   to back.  The level pass is also timed (queued) at each depth
   0-7 of a tree over the whole store: 2**d equal windows.

Tolerances: a histogram may differ from the plain version's only by float
summation order, so ``max|diff| <= 1e-5 * max|bin sum|``; integer histograms
(quantized gradients), row stores and left counts must be equal bit for bit;
the level-batched pass must equal G single-window kernel calls bit for bit;
two launches on the same input must give the same bits.

The line before the last is the card's name and power limit as ``nvidia-smi``
reports them, the one before that a JSON object with every kernel's numbers,
and the last line ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits with code 2 and prints no result.  ``--profile`` adds a
``torch.profiler`` table of one training iteration of each path; on the
leaf-wise paths, the single-window split passes' ``part_scatter_kernel``
time beside their own copy-backs' (the ``Memcpy DtoD`` after each); on the
level paths, the level pass's scatter time, and a failure if any
``lvl_copyback_kernel`` ran.
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
VALID_SCORE_ATOL = 1e-5       # the same for the validation scores
WIDE_F = 2000                 # Epsilon's dense feature count


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
    bins = torch.randint(0, hi, (total, F), generator=g, device=device,
                         dtype=torch.int32)
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
    version (int64 sums): bit-equal and bitwise repeatable, on windows that
    its blocks write themselves (one segment) and on windows whose features
    several blocks share (partials and pass 2)."""
    from lightgbm_tpu_torch.core import histogram as H
    grids = set()

    def check(rows, B, start, count, what, **kw):
        ft, nseg = H.int_hist_grid(count, kw["num_features"], B)
        grids.add(nseg > 1)
        what += " %dx%d" % (-(-kw["num_features"] // ft), nseg)
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
        log("  %-48s bit-equal, bitwise-repeatable" % what)
        return a

    log("  (tiles x segments of each window after its name)")
    for F, B in ((28, 256), (28, 64)):
        rows, voff = make_store(n, F, B, quantized=True, device=device,
                                seed=11)
        for start, count in [(0, n), (12345, 20000), (4321, 1000), (777, 100),
                             (5, 0)]:
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
    if grids != {False, True}:
        raise AssertionError("the integer kernel's windows were not both "
                             "written directly and shared")
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
                quantized=False, what="") -> float:
    from lightgbm_tpu_torch.core import partition as P
    kw = dict(num_features=F, num_bins=B, voff=voff, bpc=bpc, packed=packed,
              quantized=quantized)
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
    if quantized:
        if not torch.equal(h1, h_plain):
            raise AssertionError(what + ": integer histogram differs from "
                                 "the plain version")
        err = 0.0
    else:
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


def check_level(rows, scals, what, **kw) -> float:
    """The level-batched split kernel on ``scals``, from ``rows`` into a
    second store, against G single-window kernel calls (bit for bit) and its
    plain version (bit for bit when quantized, else within HIST_RTOL): the
    windows of the destination equal the single-window calls' rows, and no
    row outside the windows changes in either store; two runs give the same
    bits."""
    from lightgbm_tpu_torch.core import partition as P
    device = rows.device
    src = rows.clone()
    dst0 = torch.full_like(rows, 0x5A)
    r1, r2, r_p = dst0.clone(), dst0.clone(), dst0.clone()
    h1, nl1 = P.partition_hist_level(src, r1, scals, **kw)
    h2, nl2 = P.partition_hist_level(src, r2, scals, **kw)
    r_seq = rows.clone()
    h_seq, nl_seq = [], []
    for sc in scals:
        r_seq, h, nl = P.partition_hist(r_seq, sc.tolist(), **kw)
        h_seq.append(h.clone())
        nl_seq.append(nl.clone())
    h_p, nl_p = P.partition_hist_level_plain(rows, r_p, scals, **kw)
    inside = torch.zeros(rows.shape[0], dtype=torch.bool, device=device)
    for wb, wc in scals[:, :2]:
        inside[int(wb):int(wb + wc)] = True
    if not torch.equal(src, rows):
        raise AssertionError(what + ": the source store changed")
    if not (torch.equal(r1[inside], r_seq[inside]) and torch.equal(r1, r_p)):
        raise AssertionError(what + ": the destination's windows differ")
    if not torch.equal(r1[~inside], dst0[~inside]):
        raise AssertionError(what + ": rows outside the windows changed")
    if not (torch.equal(nl1, torch.cat(nl_seq)) and torch.equal(nl1, nl_p)):
        raise AssertionError(what + ": nl differs")
    if not torch.equal(h1, torch.stack(h_seq)):
        raise AssertionError(what + ": histograms differ from the "
                             "single-window kernel calls")
    if kw.get("quantized"):
        if not torch.equal(h1, h_p):
            raise AssertionError(what + ": histograms differ from the plain "
                                 "version")
        err = 0.0
    else:
        err = hist_err(h1, h_p, what)
    if not (torch.equal(r1, r2) and torch.equal(h1, h2)
            and torch.equal(nl1, nl2)):
        raise AssertionError(what + ": two runs differ")
    log("  %-46s nl sum %8d  = %d single-window calls bit for bit, rows "
        "outside untouched in both stores; vs plain max|diff| %.3g"
        % (what, int(nl1.sum()), len(scals), err))
    return err


def phase_level_split(device, n: int) -> float:
    """Phase 3, second part: the level-batched split kernel against G
    single-window kernel calls (bit for bit) and against its plain version,
    exact and quantized."""
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
            worst = max(worst, check_level(rows, scals, what, **kw))
        del rows
    return worst


# ------------------------------------------------------------- wide F ----

def check_hist(rows, B, start, count, what, **kw) -> float:
    """The row-store histogram kernel against its plain version: bit-equal
    when ``quantized``, else within HIST_RTOL; two launches, same bits."""
    from lightgbm_tpu_torch.core import histogram as H
    a = H.histogram_rows(rows, B, start, count, **kw)
    a2 = H.histogram_rows(rows, B, start, count, **kw)
    b = H.histogram_rows_plain(rows, B, start, count, **kw)
    if kw.get("quantized"):
        if not torch.equal(a, b):
            raise AssertionError("%s: differs from the plain version, "
                                 "max|diff| %.3g"
                                 % (what, float((a - b).abs().max())))
        err = 0.0
    else:
        err = hist_err(a, b, what)
    if not torch.equal(a, a2):
        raise AssertionError(what + ": two launches differ")
    log("  %-46s max|diff| %.3g  bitwise-repeatable" % (what, err))
    return err


def phase_widef_hist(device, n: int) -> float:
    """Phase 2, wide F (TPU kernel #2, the classic layout): the histogram
    kernels at F = 2000, B = 256 and 64, bpc 1 and 2, full, mid, 100-row and
    empty windows, exact and integer, and nibble-packed at B = 32."""
    from lightgbm_tpu_torch.core import histogram as H
    F = WIDE_F
    nseg = H._segments(n, F, 256)
    log("  f64 partials of a root histogram at F=%d, B=256, %d rows: %d "
        "segments, %.1f MB (uncapped: %d segments, %.1f MB)"
        % (F, n, nseg, nseg * F * 2 * 256 * 8 / 1e6, -(-n // H._SEG_ROWS),
           -(-n // H._SEG_ROWS) * F * 2 * 256 * 8 / 1e6))
    worst = 0.0
    for quantized in (False, True):
        for B, bpc, packed in ((256, 1, False), (64, 1, False),
                               (256, 2, False), (64, 2, False),
                               (32, 1, True)):
            rows, voff = make_store(n, F, B, bpc=bpc, packed=packed,
                                    quantized=quantized, device=device,
                                    seed=21)
            windows = ([(0, n), (n // 3, n // 3)] if packed else
                       [(0, n), (n // 3, n // 3), (777, 100), (5, 0)])
            for start, count in windows:
                what = "%s hist F=%d B=%d bpc=%d%s [%d, +%d)" % (
                    "int" if quantized else "exact", F, B, bpc,
                    " packed" if packed else "", start, count)
                worst = max(worst, check_hist(
                    rows, B, start, count, what, num_features=F, voff=voff,
                    bpc=bpc, packed=packed, quantized=quantized))
            del rows
            torch.cuda.empty_cache()
    return worst


def phase_widef_split(device, n: int) -> float:
    """Phase 3, wide F: the single-window and level split kernels at
    F = 2000, B = 256 against their plain versions, exact and quantized, and
    the level pass over a level-7 frontier against G single-window calls."""
    from lightgbm_tpu_torch.core import partition as P
    rng = np.random.RandomState(23)
    F, B = WIDE_F, 256
    worst = 0.0
    routes = split_routes(B, rng)
    windows = [(100, 900), (3001, 10000), (4096, n // 2 + 7500), (50, 0),
               (0, n)]
    frontiers = level_frontiers(n, B, rng)
    for quantized in (False, True):
        rows, voff = make_store(n, F, B, quantized=quantized, device=device,
                                seed=24)
        for wi, (wb, wc) in enumerate(windows):
            for name in ("numerical", "nan_left"):
                route, words = routes[name]
                scal = scal_row(wb, wc, route, words, (wi + len(name)) % 2)
                what = "%s split F=%d %s [%d, +%d)" % (
                    "int" if quantized else "exact", F, name, wb, wc)
                worst = max(worst, check_split(rows, scal, F=F, B=B,
                                               voff=voff, quantized=quantized,
                                               what=what))
        kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
        for name in ("one window", "level-7 frontier"):
            scals = frontiers[name]
            if not quantized:
                ns = P.level_meta(scals, F, B, rows.shape[1]).hist.nseg
                log("  f64 partials of the level pass over the %s (%d "
                    "windows, %d rows): %d segments, %.1f MB"
                    % (name, len(scals), int(scals[:, 1].sum()), ns,
                       ns * F * 2 * B * 8 / 1e6))
            what = "level %s F=%d %s, %d windows" % (
                "quantized" if quantized else "exact", F, name, len(scals))
            worst = max(worst, check_level(rows, scals, what, **kw))
        del rows
        torch.cuda.empty_cache()
    return worst


def phase_scan_level(device) -> None:
    """Phase 3, the batched split scan of a level of 128 leaves (256
    children) at F = 2000, B = 256, in one call: it must fit the card."""
    from lightgbm_tpu_torch.core.split import (FeatureInfo, SplitParams,
                                               best_split_numerical)
    G, F, B = 256, WIDE_F, 256
    g = torch.Generator(device=device).manual_seed(31)
    hist = torch.empty((G, F, 2, B), device=device)
    hist[:, :, 0] = torch.randn((G, F, B), generator=g, device=device)
    hist[:, :, 1] = torch.rand((G, F, B), generator=g, device=device) * 2
    totals = hist[:, 0].sum(-1)
    feat = FeatureInfo(
        num_bin=torch.full((F,), 255, device=device),
        missing_type=torch.zeros(F, dtype=torch.int64, device=device),
        default_bin=torch.zeros(F, dtype=torch.int64, device=device),
        is_categorical=torch.zeros(F, dtype=torch.bool, device=device))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    best = best_split_numerical(
        hist, feat, torch.ones(F, dtype=torch.bool, device=device),
        totals[:, 0], totals[:, 1], torch.full((G,), 1e4, device=device),
        SplitParams(min_data_in_leaf=1, min_sum_hessian_in_leaf=1.0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    found = int((best.gain > 0).sum())
    if found == 0 or not bool(torch.isfinite(best.gain[best.gain > 0]).all()):
        raise AssertionError("level split scan found no finite split")
    log("  split scan of %d children x %d features x %d bins in one call: "
        "%.3f s, peak %.2f GB above its %.2f GB input; %d children with a "
        "split" % (G, F, B, dt, peak / 1e9, hist.numel() * 4 / 1e9, found))
    del hist, best
    torch.cuda.empty_cache()


def phase_masked_hist(device, R: int) -> float:
    """Phase 2, TPU kernel #5: the masked bins/values histogram against its
    plain version at R rows, F = 28, B = 64, 128 and 256 (u8 bins), i16 and
    i32 bins, nibble-packed bins, full and mid windows."""
    from lightgbm_tpu_torch.core import histogram as H
    F = 28
    g = torch.Generator(device=device).manual_seed(41)
    vals = torch.randn((2, R), generator=g, device=device)
    worst = 0.0
    cases = [("u8", B, torch.uint8, 0) for B in (64, 128, 256)]
    cases += [("i16", 256, torch.int16, 0), ("i32", 256, torch.int32, 0),
              ("packed", 32, torch.uint8, F)]
    for name, B, dtype, num_cols in cases:
        codes = torch.randint(0, 16 if num_cols else B, (R, F), generator=g,
                              device=device, dtype=torch.int32)
        if num_cols:
            codes = (codes[:, 0::2] | (codes[:, 1::2] << 4))
        bins = codes.to(dtype).contiguous()
        for start, count in ((0, R), (12345, R // 3)):
            a = H.histogram_masked(bins, vals, B, start, count,
                                   num_cols=num_cols)
            a2 = H.histogram_masked(bins, vals, B, start, count,
                                    num_cols=num_cols)
            b = H.histogram_masked_plain(bins, vals, B, start, count,
                                         num_cols=num_cols)
            what = "masked hist %s F=%d B=%d [%d, +%d)" % (name, F, B, start,
                                                          count)
            err = hist_err(a, b, what)
            worst = max(worst, err)
            if not torch.equal(a, a2):
                raise AssertionError(what + ": two launches differ")
            log("  %-46s max|diff| %.3g  bitwise-repeatable" % (what, err))
        del bins, codes
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


def epsilon_task(n: int, n_test: int, device, f: int = WIDE_F,
                 seed: int = 0):
    """Epsilon-shaped binary data (the reference's GPU benchmark: 400,000
    training and 100,000 test rows of 2000 dense features), made on
    ``device`` from ``seed`` and returned as host numpy: standard normal f32
    features, and labels drawn from a logistic model on 40 features plus 5
    products of pairs."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n + n_test, f), generator=g, device=device)
    cols = torch.randperm(f, generator=g, device=device)[:50].tolist()
    w = torch.randn(40, generator=g, device=device, dtype=torch.float64)
    logit = X[:, cols[:40]].double() @ (w * 1.5 / np.sqrt(40))
    for a, b in zip(cols[40::2], cols[41::2]):
        logit += 0.5 * X[:, a].double() * X[:, b].double()
    u = torch.rand(n + n_test, generator=g, device=device, dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).double().cpu().numpy()
    X = X.cpu().numpy()
    return X[:n], y[:n], X[n:], y[n:]


EPSILON_PARAMS = dict(objective="binary", max_bin=255, num_leaves=255,
                      learning_rate=0.1, min_data_in_leaf=1,
                      min_sum_hessian_in_leaf=100, metric="auc",
                      verbosity=-1)


class IterationRecorder:
    """A ``train`` callback: each iteration's wall time (update and
    evaluation, from its ``start`` callback to a device synchronise), the
    train log loss and the device->host fetches of its tree."""
    order = 5
    before_iteration = False

    def __init__(self, label: torch.Tensor) -> None:
        self.label = label
        self.iter_s, self.losses, self.fetches = [], [], []
        self.t = 0.0
        rec = self

        class Start:
            order = 0
            before_iteration = True

            def __call__(self, env) -> None:
                torch.cuda.synchronize()
                rec.t = time.perf_counter()
        self.start = Start()

    def __call__(self, env) -> None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.iter_s.append(t - self.t)
        gbdt = env.model._booster
        self.losses.append(logloss(gbdt.train_score[0], self.label))
        self.fetches.append(gbdt.last_arrays.host_fetches)


def phase_epsilon(device, n: int, n_test: int, iters: int,
                  profile: bool) -> dict:
    """Path (D): the Epsilon-shaped binary GBDT trained on the card through
    ``lightgbm_tpu_torch.train`` with a held-out validation set, at the
    reference's published GPU settings (2000 features, 255 bins, 255 leaves,
    leaf-wise, exact), with the launch counts read around the call."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    t0 = time.perf_counter()
    X, y, X_test, y_test = epsilon_task(n, n_test, device)
    t1 = time.perf_counter()
    train = lgb.Dataset(X, y).construct()
    valid = lgb.Dataset(X_test, y_test, reference=train).construct()
    t2 = time.perf_counter()
    log("  set-up: data %.2f s, binning %.2f s (%d + %d rows x %d features)"
        % (t1 - t0, t2 - t1, n, n_test, X.shape[1]))
    if train.handle.is_bundled or valid.handle.is_bundled:
        raise AssertionError("the Epsilon-shaped dataset came out bundled")
    label = torch.as_tensor(y, device=device)
    rec = IterationRecorder(label)
    evals = {}
    D.reset_launches()
    booster = lgb.train(EPSILON_PARAMS, train, num_boost_round=iters,
                        valid_sets=[valid], valid_names=["test"],
                        evals_result=evals, early_stopping_rounds=iters,
                        verbose_eval=False,
                        callbacks=[rec, rec.start])
    counts = D.launches()
    gbdt = booster._booster
    trees = len(gbdt.models)
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    aucs = evals["test"]["auc"]
    med = float(np.median(rec.iter_s))
    log("  iterations %d, seconds per iteration (train() update and "
        "evaluation) %s (median %.4f)"
        % (len(rec.iter_s), ["%.4f" % v for v in rec.iter_s], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  train logloss per iteration %s" % ["%.6f" % v for v in rec.losses])
    log("  held-out AUC per iteration %s over %d rows"
        % (["%.6f" % v for v in aucs], n_test))
    log("  best iteration %d, leaves per tree %s, splits %d"
        % (booster.best_iteration, [t.num_leaves for t in gbdt.models],
           splits))
    log("  device->host fetches per tree %s" % rec.fetches)
    log("  launches on path (D) %s" % counts)
    start = logloss(torch.full_like(label, gbdt.objective.boost_from_score(0)),
                    label)
    if not all(b < a for a, b in zip([start] + rec.losses, rec.losses)):
        raise AssertionError("train logloss did not fall every iteration "
                             "(from %.6f at the initial score)" % start)
    if len(aucs) != trees or not aucs[-1] > 0.6:
        raise AssertionError("held-out AUC per iteration %s" % aucs)
    # every tree (predict's default stops at best_iteration)
    raw = booster.predict(X_test, raw_score=True,
                          num_iteration=booster.current_iteration())
    vscore = gbdt.valid_sets[0]["score"][0].double().cpu().numpy()
    err_v = float(np.abs(raw - vscore).max())
    if not (raw.shape == (n_test,) and np.isfinite(raw).all()
            and err_v <= VALID_SCORE_ATOL):
        raise AssertionError("validation scores vs predict: max|diff| %.3g "
                             "> %.0e" % (err_v, VALID_SCORE_ATOL))
    log("  validation scores accumulated in training vs predict on %d rows: "
        "max|diff| %.3g" % (n_test, err_v))
    check_predictions(gbdt, X, X_test, raw)
    check_tree0(gbdt, n, strict=False)
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    # one root histogram per tree and one split pass per split, nothing else
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (D): launches %s, want %s" % (counts,
                                                                 want))
    return {"launches": counts, "iter_s": rec.iter_s, "auc": aucs,
            "trees": trees, "splits": splits, "busy_ms": busy_ms}


def phase_build_histogram(device, R: int) -> dict:
    """Path (E): the entry point ``build_histogram`` (TPU kernel #5's own
    caller) on R rows x 28 u8 bins at B = 256, with the launch counts read
    around the call, against the plain version."""
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.core import histogram as H
    g = torch.Generator(device=device).manual_seed(43)
    bins = torch.randint(0, 256, (R, 28), generator=g, device=device,
                         dtype=torch.int32).to(torch.uint8)
    vals = torch.randn((2, R), generator=g, device=device)
    D.reset_launches()
    h = H.build_histogram(bins, vals, 256)
    counts = D.launches()
    err = hist_err(h, H.histogram_masked_plain(bins, vals, 256, 0, R),
                   "build_histogram")
    log("  build_histogram %d rows x 28 features: launches %s, vs plain "
        "max|diff| %.3g" % (R, counts, err))
    if counts != {k: int(k == "histogram_masked") for k in counts}:
        raise AssertionError("path (E): launches %s" % counts)
    return {"launches": counts, "trees": 1}


def profile_iteration(booster) -> float:
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
    device = {e.key: e.self_device_time_total / 1e3 for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)}
    busy_ms = sum(device.values())
    log("  profiled iteration: wall %.3f ms (profiler overhead included), "
        "device busy %.3f ms" % (wall_ms, busy_ms))
    if booster.learner.tree_grow_mode == "level":
        # the level pass writes a second store and copies nothing back
        back = [k for k in device if "copyback" in k]
        if back:
            raise AssertionError("level path ran %s" % back)
        log("  level pass: %d lvl_scatter_kernel launches %.3f ms, no "
            "lvl_copyback_kernel; integer histogram kernels %.3f ms"
            % (sum(e.count for e in events if "lvl_scatter" in e.key
                   and e.device_type == torch.autograd.DeviceType.CUDA),
               sum(v for k, v in device.items() if "lvl_scatter" in k),
               sum(v for k, v in device.items() if "hist_int" in k)))
    # leaf-wise paths: each split pass's scatter against its own copy-back,
    # the device-to-device copy that comes next on the device
    # (csrc/partition.cu)
    work = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    scatter, copy = [], []
    for e, after in zip(work, work[1:]):
        if "part_scatter_kernel" in e.name:
            scatter.append(e.time_range.elapsed_us() / 1e3)
            if "Memcpy DtoD" in after.name:
                copy.append(after.time_range.elapsed_us() / 1e3)
    if scatter:
        log("  part_scatter_kernel %d launches %.3f ms, their copy-backs "
            "(Memcpy DtoD) %d copies %.3f ms%s"
            % (len(scatter), sum(scatter), len(copy), sum(copy),
               ": ratio %.2f" % (sum(scatter) / sum(copy)) if copy else ""))
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


def queued_ms(fn, reps: int = 25, trials: int = 5) -> float:
    """Device time of one ``fn()`` without the host's share: ``reps`` calls
    queued behind a sleeping kernel, so that the card runs them back to back,
    between two CUDA events; the median of ``trials`` such runs.  ``fn`` must
    not wait for the device."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 21, []
    while len(times) < trials:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()      # the card still sleeps: all were queued
        b.synchronize()
        if queued:
            times.append(a.elapsed_time(b) / reps)
        elif cycles >= 1 << 30:
            raise AssertionError("calls outran a %d-cycle sleep" % cycles)
        else:
            cycles *= 4
    return float(np.median(times))


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_bytes(F: int, bpc: int = 1) -> int:
    """Bytes a histogram must read per row-store row: the 32-byte sectors
    of its bin bytes and the one of its f32 grad/hess."""
    return 32 * -(-F * bpc // 32) + 32


def split_pass_sizes(rows, voff, F, B, route, words, counts,
                     reps: int) -> dict:
    """Times of the single-window split pass on windows [0, wc) of ``rows``
    for each wc of ``counts`` (the first one first), each beside its bound,
    its plain version and the window's device-to-device copy of wc * W
    bytes (2 * wc * W bytes read and written: the least data movement of a
    partition, and the copy-back inside the pass); the first size's numbers,
    with the others under ``sizes``."""
    from lightgbm_tpu_torch.core import partition as P
    W = rows.shape[1]
    out = []
    for wc in counts:
        scal = scal_row(0, wc, route, words, 1)
        kw = dict(num_features=F, num_bins=B, voff=voff)
        work = rows.clone()
        ms = cuda_ms(lambda: P.partition_hist(work, scal, **kw), reps=reps)
        dev = queued_ms(lambda: P.partition_hist(work, scal, **kw),
                        reps=reps)
        del work
        plain = cuda_ms(lambda: P.partition_hist_plain(rows, scal, **kw),
                        reps=3 if F > 100 else 20, warmup=1)
        dst = torch.empty((wc, W), dtype=torch.uint8, device=rows.device)
        copy = cuda_ms(lambda: dst.copy_(rows[:wc]), reps=reps)
        copy_dev = queued_ms(lambda: dst.copy_(rows[:wc]), reps=reps)
        del dst
        # each window row read once and written once; the child histogram's
        # adds are two per (row, feature) of the smaller child
        b_ms, b_by = bound(2.0 * wc * W, 2.0 * (wc / 2) * F)
        log("  split pass F=%d %8d rows: kernel %.4f ms (queued %.4f), bound "
            "%.4f ms (%s), plain %.4f ms, copy of the window %.4f ms (queued "
            "%.4f), no single library call"
            % (F, wc, ms, dev, b_ms, b_by, plain, copy, copy_dev))
        out.append(dict(rows=wc, ms=ms, queued_ms=dev, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        copy_ms=copy, copy_queued_ms=copy_dev))
        torch.cuda.empty_cache()
    return dict(out[0], sizes=out[1:])


def hist_index_add_ms(rows, voff, F, B, count, quantized=False) -> tuple:
    """One ``index_add_`` (f32, or int64 when ``quantized``) computing the
    histogram of rows [0, count) of the row store, over flattened
    (feature, bin) ids: its event time and its queued device time."""
    from lightgbm_tpu_torch.core import histogram as H
    bins, vals = H.rows_split(rows[:count], F, voff)
    ids = (bins + torch.arange(F, device=rows.device)[None, :] * B
           ).reshape(-1)
    del bins
    dt = torch.int64 if quantized else torch.float32
    v = vals.t().to(dt)[:, None, :].expand(count, F, 2).reshape(-1, 2)
    acc = torch.zeros((F * B, 2), dtype=dt, device=rows.device)
    lib = cuda_ms(lambda: acc.index_add_(0, ids, v), reps=3 if F > 100
                  else 20, warmup=1)
    lib_queued = queued_ms(lambda: acc.index_add_(0, ids, v),
                           reps=3 if count * F > 1e8 else 25)
    del ids, v, vals, acc
    torch.cuda.empty_cache()
    return lib, lib_queued


def times_widef(device, n: int) -> dict:
    """Phase 5, wide F: the histograms (exact at n, 20,000 and 1,000 rows;
    integer at n) and the split pass (at n, 20,000 and 1,000 rows) of an
    n-row, 2000-feature, 256-bin store, beside their bounds, plain versions,
    index_add_ and the window's copy."""
    from lightgbm_tpu_torch.core import histogram as H
    F, B = WIDE_F, 256
    out = {}
    for quantized in (False, True):
        rows, voff = make_store(n, F, B, quantized=quantized, device=device,
                                seed=51)
        kw = dict(num_features=F, voff=voff, quantized=quantized)
        sizes = []
        for count in ((n,) if quantized else (n, 20000, 1000)):
            ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw),
                         reps=10 if count == n else 25)
            dev = queued_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw),
                            reps=5 if count == n else 25)
            plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, count,
                                                           **kw),
                            reps=3, warmup=1)
            lib, lib_dev = hist_index_add_ms(rows, voff, F, B, count,
                                             quantized)
            b_ms, b_by = bound(count * row_bytes(F) + F * 2 * B * 4,
                               2.0 * count * F)
            log("  %s histogram F=%d %8d rows: kernel %.4f ms (queued %.4f), "
                "bound %.4f ms (%s), plain %.4f ms, index_add_ (%s) %.4f ms "
                "(queued %.4f)"
                % ("int" if quantized else "exact", F, count, ms, dev, b_ms,
                   b_by, plain, "int64" if quantized else "f32", lib,
                   lib_dev))
            sizes.append(dict(rows=count, ms=ms, queued_ms=dev,
                              plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib, library_queued_ms=lib_dev))
        key = "histogram_widef_q" if quantized else "histogram_widef"
        out[key] = dict(sizes[0], sizes=sizes[1:])
        if not quantized:
            rng = np.random.RandomState(52)
            route, words = split_routes(B, rng)["numerical"]
            out["partition_widef"] = split_pass_sizes(
                rows, voff, F, B, route, words, (n, 20000, 1000), reps=10)
        del rows
        torch.cuda.empty_cache()
    return out


def times_masked(device, R: int) -> dict:
    """Phase 5: the masked histogram (kernel #5) over R, 20,000 and 1,000
    rows x 28 u8 bins at B = 256, beside its bound, plain version and
    index_add_."""
    from lightgbm_tpu_torch.core import histogram as H
    F, B = 28, 256
    g = torch.Generator(device=device).manual_seed(53)
    bins = torch.randint(0, B, (R, F), generator=g, device=device,
                         dtype=torch.int32).to(torch.uint8)
    vals = torch.randn((2, R), generator=g, device=device)
    sizes = []
    for count in (R, 20000, 1000):
        ms = cuda_ms(lambda: H.histogram_masked(bins, vals, B, 0, count))
        dev = queued_ms(lambda: H.histogram_masked(bins, vals, B, 0, count))
        plain = cuda_ms(lambda: H.histogram_masked_plain(bins, vals, B, 0,
                                                         count), reps=10)
        ids = (bins[:count].long() + torch.arange(F, device=device)[None, :]
               * B).reshape(-1)
        v = vals[:, :count].t()[:, None, :].expand(count, F, 2).reshape(-1, 2)
        acc = torch.zeros((F * B, 2), dtype=torch.float32, device=device)
        lib = cuda_ms(lambda: acc.index_add_(0, ids, v), reps=10)
        lib_dev = queued_ms(lambda: acc.index_add_(0, ids, v))
        # each row's F bin bytes and its two f32 values
        b_ms, b_by = bound(count * (F + 8) + F * 2 * B * 4, 2.0 * count * F)
        log("  masked histogram %8d rows x %d u8 bins: kernel %.4f ms "
            "(queued %.4f), bound %.4f ms (%s), plain %.4f ms, index_add_ "
            "%.4f ms (queued %.4f)"
            % (count, F, ms, dev, b_ms, b_by, plain, lib, lib_dev))
        sizes.append(dict(rows=count, ms=ms, queued_ms=dev, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          library_queued_ms=lib_dev))
        del ids, v, acc
    return {"histogram_masked": dict(sizes[0], sizes=sizes[1:])}


def phase_times(device, n: int) -> dict:
    """Phase 5: kernel, bound, plain and library times at the main path's
    shapes: the histogram and the split pass over the root window of an
    n-row, 28-feature, 256-bin store and over child-sized windows."""
    from lightgbm_tpu_torch.core import histogram as H
    from lightgbm_tpu_torch.device import reset_launches
    F, B = 28, 256
    out = {}
    rows, voff = make_store(n, F, B, device=device, seed=6)
    sizes = []
    for count in (n, 20000, 1000):
        kw = dict(num_features=F, voff=voff)
        ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        dev = queued_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, count,
                                                       **kw), reps=20)
        lib, lib_dev = hist_index_add_ms(rows, voff, F, B, count)
        # the bins' and the g/h's 32-byte sectors of each row; two adds per
        # (row, feature)
        b_ms, b_by = bound(count * row_bytes(F) + F * 2 * B * 4,
                           2.0 * count * F)
        log("  histogram %8d rows: kernel %.4f ms (queued %.4f), bound %.4f "
            "ms (%s), plain %.4f ms, index_add_ %.4f ms (queued %.4f)"
            % (count, ms, dev, b_ms, b_by, plain, lib, lib_dev))
        sizes.append(dict(rows=count, ms=ms, queued_ms=dev, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          library_queued_ms=lib_dev))
    out["histogram"] = dict(sizes[0], sizes=sizes[1:])
    rng = np.random.RandomState(7)
    route, words = split_routes(B, rng)["numerical"]
    out["partition"] = split_pass_sizes(rows, voff, F, B, route, words,
                                        (n, 20000, 900), reps=25)
    del rows
    out.update(times_quantized_and_level(device, n))
    reset_launches()
    return out


def times_quantized_and_level(device, n: int) -> dict:
    """Phase 5, second part: the integer histogram kernel (quantized store),
    the single-window split pass with its integer child histogram, and the
    level-batched split kernel over one level-0 window and a full
    level-7 frontier of 127 windows, beside the same frontier as G
    single-window calls."""
    from lightgbm_tpu_torch.core import histogram as H
    from lightgbm_tpu_torch.core import partition as P
    F, B = 28, 256
    out = {}
    rows, voff = make_store(n, F, B, quantized=True, device=device, seed=13)
    sizes = []
    for count in (n, 20000, 1000):
        kw = dict(num_features=F, voff=voff, quantized=True)
        ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        dev = queued_ms(lambda: H.histogram_rows(rows, B, 0, count, **kw))
        plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, count,
                                                       **kw), reps=20)
        lib, lib_dev = hist_index_add_ms(rows, voff, F, B, count,
                                         quantized=True)
        # the 32-byte sectors of bins and g/h per row; two integer adds per
        # (row, feature)
        b_ms, b_by = bound(count * row_bytes(F) + F * 2 * B * 4,
                           2.0 * count * F)
        log("  int histogram %8d rows: kernel %.4f ms (queued %.4f), bound "
            "%.4f ms (%s), plain %.4f ms, index_add_ (int64) %.4f ms (queued "
            "%.4f)" % (count, ms, dev, b_ms, b_by, plain, lib, lib_dev))
        sizes.append(dict(rows=count, ms=ms, queued_ms=dev, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          library_queued_ms=lib_dev))
    out["histogram_int"] = dict(sizes[0], sizes=sizes[1:])
    # the single-window split pass with the integer child histogram, on the
    # root window (no path grows quantized trees leaf-wise)
    route, words = split_routes(B, np.random.RandomState(7))["numerical"]
    scal = scal_row(0, n, route, words, 1)
    skw = dict(num_features=F, num_bins=B, voff=voff, quantized=True)
    work = rows.clone()
    ms = cuda_ms(lambda: P.partition_hist(work, scal, **skw))
    dev = queued_ms(lambda: P.partition_hist(work, scal, **skw))
    plain = cuda_ms(lambda: P.partition_hist_plain(rows, scal, **skw),
                    reps=20)
    b_ms, b_by = bound(2.0 * n * rows.shape[1], 2.0 * (n / 2) * F)
    log("  quantized split pass %8d rows: kernel %.4f ms (queued %.4f), "
        "bound %.4f ms (%s), plain %.4f ms, no single library call"
        % (n, ms, dev, b_ms, b_by, plain))
    out["partition_q"] = dict(ms=ms, queued_ms=dev, plain_ms=plain,
                              bound_ms=b_ms)
    del rows, work
    rng = np.random.RandomState(14)
    fr = level_frontiers(n, B, rng)
    for quantized in (False, True):
        rows, voff = make_store(n, F, B, quantized=quantized, device=device,
                                seed=15)
        kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
        dst = torch.empty_like(rows)
        for name in ("one window", "level-7 frontier"):
            scals = fr[name]
            ms = cuda_ms(lambda: P.partition_hist_level(rows, dst, scals,
                                                        **kw))
            dev = queued_ms(lambda: P.partition_hist_level(rows, dst, scals,
                                                           **kw))
            # the level's own copy: its windows' rows, device to device
            lo = int(scals[:, 0].min())
            hi = int((scals[:, 0] + scals[:, 1]).max())
            copy = cuda_ms(lambda: dst[lo:hi].copy_(rows[lo:hi]))
            copy_dev = queued_ms(lambda: dst[lo:hi].copy_(rows[lo:hi]))
            work = rows.clone()

            def sequential():
                for sc in scals:
                    P.partition_hist(work, sc.tolist(), **kw)
            seq = cuda_ms(sequential, reps=5, warmup=1)
            plain = cuda_ms(lambda: P.partition_hist_level_plain(
                rows, dst, scals, **kw), reps=3, warmup=1)
            # every window row read once and written once; two adds per
            # (row, feature) of the smaller children
            sum_wc = float(scals[:, 1].sum())
            b_ms, b_by = bound(2.0 * sum_wc * rows.shape[1],
                               2.0 * (sum_wc / 2) * F)
            what = "%s, %s" % ("quantized" if quantized else "exact", name)
            log("  level split pass %-30s (%d windows, %d rows): kernel "
                "%.4f ms (queued %.4f), bound %.4f ms (%s), %d single-window "
                "calls %.4f ms, plain %.4f ms, copy of the windows %.4f ms "
                "(queued %.4f), no single library call"
                % (what, len(scals), sum_wc, ms, dev, b_ms, b_by, len(scals),
                   seq, plain, copy, copy_dev))
            if name == "level-7 frontier":
                key = "partition_level_q" if quantized else "partition_level"
                out[key] = dict(ms=ms, queued_ms=dev, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                copy_ms=copy, copy_queued_ms=copy_dev,
                                sequential_ms=seq, windows=len(scals))
            del work
        out["depths_q" if quantized else "depths"] = level_depth_ms(
            rows, dst, kw)
        del rows, dst
    return out


def level_depth_ms(rows, dst, kw) -> list:
    """Queued device times of the level pass at each depth d = 0..7 of a
    tree over every row of ``rows``: 2**d equal windows, random routes."""
    from lightgbm_tpu_torch.core import partition as P
    n = rows.shape[0] - 4096
    F, B = kw["num_features"], kw["num_bins"]
    rng = np.random.RandomState(16)
    times = []
    for d in range(8):
        bounds = np.linspace(0, n, 2 ** d + 1).astype(np.int64)
        scals = np.asarray([scal_row(
            int(a), int(b - a), (int(rng.randint(F)), int(rng.randint(B)), 0,
                                 0, B, 0, 0, 0, 0), [0] * (B // 32),
            int(rng.randint(2))) for a, b in zip(bounds, bounds[1:])])
        times.append(queued_ms(lambda: P.partition_hist_level(rows, dst,
                                                              scals, **kw)))
    log("  level pass %s at depths 0-7 of a %d-row tree (queued ms): %s; "
        "sum %.4f" % ("quantized" if kw["quantized"] else "exact", n,
                      " ".join("%.4f" % t for t in times), sum(times)))
    return times


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="training rows of the main paths (A)-(C) (10500000 "
                         "is the published Higgs size)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--widef-rows", type=int, default=400_000,
                    help="training rows of path (D) and of the wide-F "
                         "kernel phases (400000 is the published Epsilon "
                         "size)")
    ap.add_argument("--widef-test-rows", type=int, default=100_000,
                    help="held-out rows of path (D)")
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
    t_start = time.perf_counter()
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
    nw = args.widef_rows
    log("[2] histogram kernels vs plain versions")
    hist_err_max = phase_histogram(device, args.rows)
    hist_int_err = phase_histogram_int(device, args.rows)
    widef_err = phase_widef_hist(device, nw)
    masked_err = phase_masked_hist(device, 1 << 20)
    log("[3] split kernels vs plain versions")
    split_err_max = phase_split(device, args.rows)
    level_err_max = phase_level_split(device, args.rows)
    widef_split_err = phase_widef_split(device, nw)
    phase_scan_level(device)
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
    del data, ds
    log("  (D) Epsilon-shaped, lightgbm_tpu_torch.train with a validation "
        "set: %d + %d rows x %d features, max_bin=255, num_leaves=255, %d "
        "iterations" % (nw, args.widef_test_rows, WIDE_F, args.iters))
    paths["D"] = phase_epsilon(device, nw, args.widef_test_rows, args.iters,
                               args.profile)
    torch.cuda.empty_cache()
    log("  (E) build_histogram")
    paths["E"] = phase_build_histogram(device, 1 << 20)
    log("  median seconds per iteration: %s" % ", ".join(
        "(%s) %.4f" % (p, float(np.median(r["iter_s"])))
        for p, r in paths.items() if "iter_s" in r))

    log("[5] times (CUDA events, median)")
    times = phase_times(device, args.rows)
    times.update(times_widef(device, nw))
    times.update(times_masked(device, 1 << 20))
    reset_launches()

    def launches(kernel, only=None):
        by_path = {p: r["launches"][kernel] for p, r in paths.items()
                   if r["launches"][kernel] and (only is None or p in only)}
        per_tree = {p: v / paths[p]["trees"] for p, v in by_path.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path,
                    launches_per_tree=per_tree)

    kernels_line = {"kernels": [
        dict(name="histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             max_abs_err=hist_err_max, **launches("histogram", "ABC"),
             **times["histogram"]),
        dict(name="partition", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:1130",
             max_abs_err=split_err_max, **launches("partition", "ABC"),
             quantized_ms=times["partition_q"]["ms"],
             quantized_queued_ms=times["partition_q"]["queued_ms"],
             quantized_plain_ms=times["partition_q"]["plain_ms"],
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
             quantized_queued_ms=times["partition_level_q"]["queued_ms"],
             depths_queued_ms=times["depths"],
             quantized_depths_queued_ms=times["depths_q"],
             **times["partition_level"]),
        dict(name="histogram_widef", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/core/histogram.py:774",
             max_abs_err=widef_err, **launches("histogram", "D"),
             quantized_ms=times["histogram_widef_q"]["ms"],
             quantized_bound_ms=times["histogram_widef_q"]["bound_ms"],
             **times["histogram_widef"]),
        dict(name="partition_widef", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:281",
             max_abs_err=widef_split_err, **launches("partition", "D"),
             **times["partition_widef"]),
        dict(name="histogram_masked", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram_masked.cu",
             replaces="lightgbm_tpu/core/histogram.py:303",
             max_abs_err=masked_err, **launches("histogram_masked"),
             **times["histogram_masked"]),
    ]}
    for k in kernels_line["kernels"]:
        if k["launches"] == 0:
            raise AssertionError("%s was not launched on a main path"
                                 % k["name"])
    log("  whole script %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
