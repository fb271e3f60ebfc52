#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--rows 1048576] [--iters 5] [--widef-rows 400000]
                          [--widef-test-rows 100000] [--ltr-rows 2270296]
                          [--allstate-rows 1048576] [--expo-rows 11000000]
                          [--profile]

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
   to its plain rebuild; (F) L2 regression on (A)'s binned features with a
   real-valued label made from the seed, ``metric=l2``, the sampling of the
   reference's examples/regression/train.conf (``bagging_fraction=0.8``,
   ``bagging_freq=5``, ``feature_fraction=0.9``) and
   ``hist_precision=quantized``, leaf-wise: one integer root histogram per
   tree and one quantized split pass per split, the bag mask equal byte for
   byte to the hash recomputed on the host in numpy, l2 falling every
   iteration, tree 0 equal to its plain rebuild (strict); (G) 5-class
   softmax (``multiclass``, the reference's multiclass example) on (A)'s
   binned features through ``lightgbm_tpu_torch.train`` with (A)'s held-out
   rows as a validation set (``metric=multi_logloss,multi_error``): 5 trees
   an iteration, one root histogram per tree and one split pass per split,
   the train multi_logloss falling every iteration, ``Booster.predict``
   [n, 5] rows summing to 1 and equal to the validation scores of training,
   tree 0 of class 0 equal to its plain rebuild; (H) ``lambdarank`` at the
   MS LTR shape (2,270,296 rows x 137 dense features in queries of ~120
   documents, none above 1,251, relevance 0-4, made from a seed;
   ``metric=ndcg``, ``eval_at=1,3,5,10`` and (D)'s published settings)
   through ``lightgbm_tpu_torch.train``: the training NDCG@10 not falling
   over the run, the gradient step's device time and peak memory, one root
   histogram per tree and one split pass per split, tree 0 equal to its
   plain rebuild; (I) EFB on Allstate-shaped sparse data (the reference's
   Allstate row: 4,228 binary features, the one-hot codes of 30
   Zipf-skewed categorical columns made from a seed; 1,048,576 + 104,858
   rows, cut from 13,184,290) as scipy CSR through ``Dataset`` and
   ``BinnedDataset.from_csr`` (never densified, bundled into group
   columns) and ``lightgbm_tpu_torch.train`` with a CSR validation set at
   (D)'s settings: the root histogram over the group columns, one split
   pass per split, each unfolding its feature's group codes; (J)
   categorical features at the Expo shape (the reference's Expo row, 11M +
   100,000 rows of the airline columns Month, DayofMonth, DayOfWeek,
   UniqueCarrier, Origin and Dest, categorical, and DepTime and Distance,
   made from a seed) through ``train()`` at (D)'s settings: every
   categorical split the sorted many-vs-many search, routed by the split
   passes' category bitsets; (J2) (J)'s binned data with
   ``tree_grow_mode=level``, ``hist_precision=quantized``, monotone +1 on
   DepTime, ``extra_trees`` and ``max_cat_to_onehot=8`` (one-hot and
   many-vs-many splits), 2 iterations: the integer root histogram and one
   level pass per level, its windows routed by bitsets, every DepTime split
   with its left leaves at or below its right ones.  Each of (I), (J) and
   (J2) prints its binning seconds, s/iteration, train log loss and
   held-out AUC per iteration, the split passes' route counts
   (``device.route_launches``: launches with ``use_unfold = 1`` and with
   ``is_cat = 1``) and, with ``--profile``, the device's busy and idle
   share; holds the validation scores kept by training against
   ``Booster.predict`` (within 1e-5) and tree 0 against its plain rebuild
   (category bitsets included), and checks the histogram, split and level
   kernels against their plain versions on the path's own row store and
   route; (K) GOSS (``top_rate=0.2``, ``other_rate=0.1``) on (A)'s
   binned rows, 12 iterations, the last two sampled: each sampled
   iteration's device row weights equal byte for byte to the host's stable
   argsort of the fetched key with the sampling stream replayed from a
   fresh ``RandomState(bagging_seed)``, top_k + other_k of them nonzero;
   (L) DART at its defaults on (A)'s binned rows through ``train()`` with
   (A)'s held-out rows as a validation set, for as many iterations as the
   host's drop plan (``RandomState(drop_seed)``) needs for two to drop
   trees: the dropped iterations equal to the plan, the train score equal
   to the sum of the model's trees routed over the training bins (within
   1e-5 of its largest value), the validation scores equal to ``predict``;
   (M) random forest (``bagging_fraction=0.632``, ``bagging_freq=1``,
   ``feature_fraction=0.8``), 5 iterations: ``average_output`` in the
   model text, ``predict`` the mean of the trees, the first and last trees
   equal to plain rebuilds on the gradients of the constant initial score;
   (N) forced splits (a three-split schedule written to a temporary file:
   the root on feature 25, both children on feature 26, at the features'
   medians) and the split, coupled and lazy CEGB penalties, leaf-wise,
   exact, 5 iterations: every tree's first three splits the forced ones,
   the lazy paid bits equal to a recompute from the trees and the rows'
   leaves, tree 0 equal to its plain rebuild; (O) (D)'s binned rows with
   ``histogram_pool_size=125`` (32 slots of 255 leaves), 2 iterations:
   the cache's bytes against the per-leaf cache's, the peak device memory,
   the rebuilt parents (one histogram launch each), and (D)'s first two
   trees matched to the JAX package's bounds for a pooled build (98% of
   the split features and of the rows' leaves, sorted leaf values within
   rtol 1e-4); (E) ``build_histogram`` (kernel #5's caller) over 1,048,576
   rows x 28 features;
5. times of each kernel at the main paths' shapes beside its bound, its
   plain version and one PyTorch library call (``index_add_``; for a split
   pass, which has none, the window's device-to-device copy): the
   histograms and split passes on the root window and on child-sized
   windows of 20,000 and 1,000 rows.  Times are CUDA-event medians of one
   call, the wrapper's host work included; each histogram, split pass and
   their ``index_add_`` or copy also get a queued time, the device time of
   one call when 25 calls are queued behind a sleeping kernel and run back
   to back; the quantized split pass also beside its window's copy.  The
   level pass is also timed (queued) at each depth 0-7 of a tree over the
   whole store: 2**d equal windows.

Tolerances: a histogram may differ from the plain version's only by float
summation order, so ``max|diff| <= 1e-5 * max|bin sum|``; integer histograms
(quantized gradients), row stores and left counts must be equal bit for bit;
the level-batched pass must equal G single-window kernel calls bit for bit;
two launches on the same input must give the same bits.

The line before the last is the card's name and power limit as ``nvidia-smi``
reports them, the one before that a JSON object with every kernel's numbers
(the split passes' entries also count the launches that unfolded a group
column or routed by a bitset), and the last line ``{"ok": true, "device":
{...}}``.  Without CUDA the script
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
    training rows; ``raw`` is [n], or [n, K] for K classes."""
    K = booster.num_tree_per_iteration
    xs = X_test[:k].astype(np.float64)
    host = np.stack([sum(t.predict(xs) for t in booster.models[c::K])
                     for c in range(K)], axis=1)
    err = float(np.abs(raw[:k].reshape(-1, K) - host).max())
    if not err <= PREDICT_ATOL:
        raise AssertionError("card predict vs host Tree.predict: max|diff| "
                             "%.3g > %.0e" % (err, PREDICT_ATOL))
    train = booster.train_score[:, :k].double().cpu().numpy().T
    err_t = float(np.abs(booster.predict(X[:k], raw_score=True).reshape(-1, K)
                         - train).max())
    if not err_t <= TRAIN_SCORE_ATOL:
        raise AssertionError("train score vs predict on training rows: "
                             "max|diff| %.3g > %.0e" % (err_t,
                                                       TRAIN_SCORE_ATOL))
    log("  predict vs host Tree.predict on %d held-out rows: max|diff| %.3g; "
        "train score vs predict on %d training rows: max|diff| %.3g"
        % (k, err, k, err_t))


def check_tree0(booster, n: int, strict: bool, bag=None,
                feature_mask=None, index: int = 0, learner=None) -> None:
    """Rebuild tree 0 (class 0's first tree) on the card with the plain
    versions (called directly: a check, not a path) and hold the
    kernel-built tree 0 against it.  ``strict``: integer histograms
    (quantized) leave no near tie to excuse, so every split and gain must be
    equal.  ``bag`` = (mask, count) and ``feature_mask`` are iteration 0's,
    recomputed by the caller.  ``index`` picks another model trained on the
    gradients of the initial scores (a random forest's), ``learner`` a
    learner other than the booster's (one in its initial state where the
    booster's carries state between trees)."""
    from lightgbm_tpu_torch.core.histogram import histogram_rows_plain
    from lightgbm_tpu_torch.core.partition import (partition_hist_level_plain,
                                                   partition_hist_plain)
    K = booster.num_tree_per_iteration
    score0 = torch.zeros((K, n), dtype=torch.float32, device=booster.device)
    for c in range(K):
        score0[c] += booster.objective.boost_from_score(c)
    grad, hess = booster.objective.get_gradients(score0[0] if K == 1
                                                 else score0)
    grad, hess = grad.reshape(K, n)[0], hess.reshape(K, n)[0]
    count = n
    if bag is not None:
        grad, hess, count = grad * bag[0], hess * bag[0], bag[1]
    t = time.perf_counter()
    plain = (learner or booster.learner).train(
        grad, hess, count, feature_mask, iteration=0,
        hist_fn=histogram_rows_plain, part_fn=partition_hist_plain,
        level_fn=partition_hist_level_plain)
    torch.cuda.synchronize()
    log("  tree %d rebuilt with the plain versions in %.3f s"
        % (index, time.perf_counter() - t))
    tree = booster.models[index]
    from lightgbm_tpu_torch.core.tree_learner import tree_from_arrays
    ptree = tree_from_arrays(plain, booster.train_data)
    kern = split_sequence(tree.split_feature_inner, tree.threshold_in_bin,
                          tree.left_child, tree.right_child,
                          tree.split_gain, tree.num_leaves)
    ref = split_sequence(ptree.split_feature_inner, ptree.threshold_in_bin,
                         ptree.left_child, ptree.right_child,
                         ptree.split_gain, ptree.num_leaves)
    ncat = 0
    for i, (a, b) in enumerate(zip(kern, ref)):
        wa, wb = cat_bins(tree, i), cat_bins(ptree, i)
        if a[:3] == b[:3] and wa != wb and not (wa & wb) and not strict:
            log("  tree %d: split %d is a categorical side swap (kernel "
                "sends bins %s left, plain %s: one partition, gains %.9g vs "
                "%.9g); the trees agree up to it" % (index, i, sorted(wa),
                                                    sorted(wb), a[3], b[3]))
            return
        if strict and (a != b or wa != wb):
            raise AssertionError(
                "tree %d split %d: kernel (feature, bin, parent, gain) %s "
                "bins %s vs plain %s bins %s" % (index, i, a, sorted(wa), b,
                                                 sorted(wb)))
        if a[:3] != b[:3] or wa != wb:
            rel = abs(a[3] - b[3]) / max(abs(a[3]), abs(b[3]), 1e-30)
            if rel < SPLIT_GAIN_TIE_RTOL:
                log("  tree %d: split %d is a near tie (gains %.9g vs %.9g, "
                    "rel %.2g); the trees agree up to it" % (index, i, a[3],
                                                              b[3], rel))
                return
            raise AssertionError(
                "tree %d split %d: kernel (feature, bin, parent) %s gain "
                "%.9g bins %s vs plain %s gain %.9g bins %s"
                % (index, i, a[:3], a[3], sorted(wa), b[:3], b[3],
                   sorted(wb)))
        ncat += bool(wa)
    nl = tree.num_leaves
    counts_k = np.asarray(tree.leaf_count[:nl], np.int64)
    counts_p = np.asarray(ptree.leaf_count[:nl], np.int64)
    if ptree.num_leaves != nl or not np.array_equal(counts_k, counts_p):
        raise AssertionError("tree %d: leaf counts differ from the plain "
                             "rebuild" % index)
    log("  tree %d equal to the plain rebuild: %d splits (features, "
        "threshold bins, split order%s%s) and %d leaf counts"
        % (index, nl - 1, ", gains" if strict else "",
           ", %d category bitsets" % ncat if ncat else "", nl))


def cat_bins(tree, node: int) -> set:
    """The bins a categorical node of a host tree sends left (its inner
    bitset); empty for a numerical node."""
    if not int(tree.decision_type[node]) & 1:
        return set()
    ci = int(tree.threshold_in_bin[node])
    lo, hi = tree.cat_boundaries_inner[ci], tree.cat_boundaries_inner[ci + 1]
    return {32 * (w - lo) + j for w in range(lo, hi) for j in range(32)
            if (int(tree.cat_threshold_inner[w]) >> j) & 1}


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
    train loss (``loss(gbdt)``; binary log loss by default, computed after
    the time is taken) and the device->host fetches of its last tree."""
    order = 5
    before_iteration = False

    def __init__(self, label: torch.Tensor, loss=None) -> None:
        self.loss = loss or (lambda gbdt: logloss(gbdt.train_score[0], label))
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
        self.losses.append(self.loss(gbdt))
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
    torch.cuda.reset_peak_memory_stats()
    D.reset_launches()
    booster = lgb.train(EPSILON_PARAMS, train, num_boost_round=iters,
                        valid_sets=[valid], valid_names=["test"],
                        evals_result=evals, early_stopping_rounds=iters,
                        verbose_eval=False,
                        callbacks=[rec, rec.start])
    counts = D.launches()
    peak = torch.cuda.max_memory_allocated()
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
    log("  launches on path (D) %s; peak device memory %.1f MB, the "
        "per-leaf histogram cache %.1f MB" % (
            counts, peak / 1e6, hist_cache_bytes(gbdt.learner,
                                                  EPSILON_PARAMS["num_leaves"])
            / 1e6))
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
            "trees": trees, "splits": splits, "busy_ms": busy_ms,
            "peak_bytes": peak, "train": train, "models": gbdt.models[:2]}


def hist_cache_bytes(learner, rows: int) -> int:
    """Bytes of a histogram cache of ``rows`` leaves or slots: [rows,
    columns, 2, B] f32."""
    return rows * learner.num_columns * 2 * learner.num_bins * 4


# -------------------------------------------------- other objectives ----

def relabel(ds, label):
    """The binned dataset ``ds`` with another label: the same bins and bin
    mappers (a shallow copy; nothing is binned again)."""
    import copy
    from lightgbm_tpu_torch.io.metadata import Metadata
    out = copy.copy(ds)
    out.metadata = Metadata(ds.num_data)
    out.metadata.set_label(label)
    return out


def higgs_score(X, rng):
    """A real-valued target of the Higgs-shaped features, with noise."""
    return (X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3] + 0.5 * X[:, 4]
            + rng.normal(scale=0.5, size=len(X)))


def bag_mask_host(n: int, seed: int, window: int, frac: float) -> np.ndarray:
    """The bag mask recomputed on the host in numpy ``uint32`` arithmetic:
    the stateless hash of (row id, bagging window) of the JAX package's
    ``_bag_uniforms``, its top as an f32 in [0, 1), below ``frac``."""
    x = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
    x ^= np.uint32((seed + window * 0x9E3779B9) & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(2246822519)
    x ^= x >> np.uint32(13)
    x *= np.uint32(3266489917)
    x ^= x >> np.uint32(16)
    u = x.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    return (u < np.float32(frac)).astype(np.float32)


def first_feature_mask(cfg, num_features: int, device):
    """Iteration 0's ``feature_fraction`` draw, from a fresh stream of the
    booster's seed."""
    used = max(1, int(round(num_features * float(cfg.feature_fraction))))
    chosen = np.random.RandomState(int(cfg.feature_fraction_seed)).choice(
        num_features, size=used, replace=False)
    mask = np.zeros(num_features, dtype=bool)
    mask[chosen] = True
    return torch.as_tensor(mask, device=device)


REGRESSION_PARAMS = dict(objective="regression", metric="l2",
                         num_leaves=255, max_bin=255, learning_rate=0.1,
                         hist_precision="quantized", bagging_fraction=0.8,
                         bagging_freq=5, feature_fraction=0.9, verbosity=-1)


def phase_regression_bagging(device, data, ds, iters: int,
                             profile: bool) -> dict:
    """Path (F): L2 regression on (A)'s binned features with a real-valued
    label, bagging and ``feature_fraction`` as in the reference's
    examples/regression/train.conf, quantized gradients, leaf-wise:
    ``GBDT`` -> ``train_one_iter``, the launch counts read around it."""
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch import device as D
    X, _, X_test, _ = data
    n = len(X)
    rng = np.random.RandomState(1)
    y, y_test = higgs_score(X, rng), higgs_score(X_test, rng)
    cfg = Config(**REGRESSION_PARAMS)
    booster = GBDT(cfg, relabel(ds, y), create_objective("regression", cfg))
    label = torch.as_tensor(y, device=booster.device)

    def l2():
        return float(((booster.train_score[0].double() - label) ** 2).mean())
    D.reset_launches()
    iter_s, losses, fetches, bag_cnt = [], [], [], []
    for _ in range(iters):
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
        losses.append(l2())
        fetches.append(booster.last_arrays.host_fetches)
        bag_cnt.append(booster.bag_data_cnt)
    raw = booster.predict(X_test, raw_score=True)
    counts = D.launches()
    trees = len(booster.models)
    splits = sum(t.num_leaves - 1 for t in booster.models)
    med = float(np.median(iter_s))
    test_l2 = float(np.mean((raw - y_test) ** 2))
    log("  iterations %d, seconds per iteration %s (median %.4f)"
        % (iters, ["%.4f" % v for v in iter_s], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  train l2 per iteration %s; held-out l2 %.6f over %d rows"
        % (["%.6f" % v for v in losses], test_l2, len(y_test)))
    log("  realised bag_data_cnt per iteration %s of %d rows (bagging_fraction"
        " 0.8, bagging_freq 5); features %d of %d an iteration"
        % (bag_cnt, n, int(round(0.9 * ds.num_features)), ds.num_features))
    log("  leaves per tree %s, splits %d" % (
        [t.num_leaves for t in booster.models], splits))
    log("  device->host fetches per tree %s" % fetches)
    log("  launches on path (F) %s" % counts)
    start = float(np.mean((y - np.float32(y.mean())) ** 2))
    if not all(b < a for a, b in zip([start] + losses, losses)):
        raise AssertionError("train l2 did not fall every iteration (from "
                             "%.6f at the initial score)" % start)
    if not (np.isfinite(raw).all() and raw.shape == (len(y_test),)
            and test_l2 < start):
        raise AssertionError("predict gave %s, held-out l2 %.6f"
                             % (raw.shape, test_l2))
    # every iteration of this run lies in bagging window 0
    want = bag_mask_host(n, int(cfg.bagging_seed), 0, 0.8)
    got = booster.bag_mask.cpu().numpy()
    if not (np.array_equal(got.view(np.uint32), want.view(np.uint32))
            and bag_cnt == [int(want.sum())] * iters):
        raise AssertionError("bag mask differs from the host hash in %d rows"
                             " (counts %s, host %d)" % (
                                 int((got != want).sum()), bag_cnt,
                                 int(want.sum())))
    log("  bag mask equal to the host's numpy hash, byte for byte (%d rows "
        "in the bag)" % int(want.sum()))
    check_predictions(booster, X, X_test, raw)
    mask0 = torch.as_tensor(want, device=booster.device)
    check_tree0(booster, n, strict=True, bag=(mask0, int(want.sum())),
                feature_mask=first_feature_mask(cfg, ds.num_features,
                                                booster.device))
    # one integer root histogram per tree, one quantized split pass per split
    want_l = {"histogram_int": trees, "partition": splits}
    if counts != {k: want_l.get(k, 0) for k in counts}:
        raise AssertionError("path (F): launches %s, want %s"
                             % (counts, want_l))
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(booster)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return {"launches": counts, "iter_s": iter_s, "trees": trees,
            "splits": splits, "busy_ms": busy_ms, "l2": losses,
            "bag_data_cnt": bag_cnt}


NUM_CLASS = 5
MULTICLASS_PARAMS = dict(objective="multiclass", num_class=NUM_CLASS,
                         metric="multi_logloss,multi_error", num_leaves=255,
                         max_bin=255, learning_rate=0.1, verbosity=-1)


def multi_logloss(score: torch.Tensor, label: torch.Tensor) -> float:
    """Mean softmax cross entropy of [K, N] scores."""
    return float(torch.nn.functional.cross_entropy(score.double().T, label))


def phase_multiclass(device, data, ds, iters: int, profile: bool) -> dict:
    """Path (G): 5-class softmax on (A)'s binned features (the class of a
    noisy real-valued target's quintile), through ``lightgbm_tpu_torch.train``
    with (A)'s held-out rows as a validation set, leaf-wise, exact."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    X, _, X_test, _ = data
    n = len(X)
    rng = np.random.RandomState(2)
    z, z_test = higgs_score(X, rng), higgs_score(X_test, rng)
    cuts = np.quantile(z, np.arange(1, NUM_CLASS) / NUM_CLASS)
    y = np.digitize(z, cuts).astype(np.float64)
    y_test = np.digitize(z_test, cuts).astype(np.float64)
    train = lgb.Dataset(X, y)
    train.handle = relabel(ds, y)        # (A)'s bins and mappers
    valid = lgb.Dataset(X_test, y_test, reference=train).construct()
    label = torch.as_tensor(y, device=device).long()
    rec = IterationRecorder(label, loss=lambda gbdt: multi_logloss(
        gbdt.train_score, label))
    evals = {}
    D.reset_launches()
    booster = lgb.train(MULTICLASS_PARAMS, train, num_boost_round=iters,
                        valid_sets=[valid], valid_names=["test"],
                        evals_result=evals, verbose_eval=False,
                        callbacks=[rec, rec.start])
    counts = D.launches()
    gbdt = booster._booster
    trees = len(gbdt.models)
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    med = float(np.median(rec.iter_s))
    log("  iterations %d, seconds per iteration (train() update and "
        "evaluation) %s (median %.4f)"
        % (len(rec.iter_s), ["%.4f" % v for v in rec.iter_s], med))
    log("  row-trees/s %.1f (median iteration, %d trees an iteration)"
        % (n * NUM_CLASS / med, NUM_CLASS))
    log("  train multi_logloss per iteration %s"
        % ["%.6f" % v for v in rec.losses])
    log("  held-out multi_logloss %s, multi_error %s over %d rows"
        % (["%.6f" % v for v in evals["test"]["multi_logloss"]],
           ["%.6f" % v for v in evals["test"]["multi_error"]], len(y_test)))
    log("  trees %d, leaves per tree %s, splits %d"
        % (trees, [t.num_leaves for t in gbdt.models], splits))
    log("  launches on path (G) %s" % counts)
    if trees != NUM_CLASS * iters or gbdt.num_tree_per_iteration != NUM_CLASS:
        raise AssertionError("%d trees after %d iterations, want %d an "
                             "iteration" % (trees, iters, NUM_CLASS))
    start = float(np.log(NUM_CLASS))    # softmax of equal scores
    if not all(b < a for a, b in zip([start] + rec.losses, rec.losses)):
        raise AssertionError("train multi_logloss did not fall every "
                             "iteration (from %.6f)" % start)
    prob = booster.predict(X_test, num_iteration=booster.current_iteration())
    raw = booster.predict(X_test, raw_score=True,
                          num_iteration=booster.current_iteration())
    vscore = gbdt.valid_sets[0]["score"].double().cpu().numpy().T
    err_v = float(np.abs(raw - vscore).max())
    e = np.exp(vscore - vscore.max(axis=1, keepdims=True))
    err_p = float(np.abs(prob - e / e.sum(axis=1, keepdims=True)).max())
    err_sum = float(np.abs(prob.sum(axis=1) - 1.0).max())
    if not (prob.shape == (len(y_test), NUM_CLASS) and np.isfinite(prob).all()
            and err_sum <= 1e-12 and err_v <= VALID_SCORE_ATOL
            and err_p <= VALID_SCORE_ATOL):
        raise AssertionError(
            "predict %s: row sums off 1 by %.3g, raw vs validation scores "
            "%.3g, probabilities vs their softmax %.3g" % (
                prob.shape, err_sum, err_v, err_p))
    log("  predict [%d, %d]: rows sum to 1 within %.3g; vs the validation "
        "scores of training: raw max|diff| %.3g, probabilities %.3g"
        % (prob.shape + (err_sum, err_v, err_p)))
    check_predictions(gbdt, X, X_test, raw)
    check_tree0(gbdt, n, strict=False)
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (G): launches %s, want %s" % (counts,
                                                                 want))
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return {"launches": counts, "iter_s": rec.iter_s, "trees": trees,
            "splits": splits, "busy_ms": busy_ms,
            "multi_logloss": rec.losses}


LTR_ROWS = 2_270_296     # MSLR-WEB30K's training rows (docs/Experiments.rst)
LTR_F = 137
LTR_MAX_QUERY = 1251
LAMBDARANK_PARAMS = dict(objective="lambdarank", metric="ndcg",
                         eval_at=[1, 3, 5, 10], max_bin=255, num_leaves=255,
                         learning_rate=0.1, min_data_in_leaf=1,
                         min_sum_hessian_in_leaf=100, verbosity=-1)


def ltr_task(n: int, device, f: int = LTR_F, seed: int = 0):
    """MS LTR-shaped ranking data made from ``seed``: ``n`` rows of ``f``
    standard normal f32 features (made on ``device``), query sizes drawn
    log-normal with mean ~120 and cut to [1, 1251], relevance labels 0-4
    (about 52/32/13/2/1 %) from a linear score of 20 features plus noise.
    Returns host numpy (X, y, group)."""
    rng = np.random.RandomState(seed)
    sizes = []
    total = 0
    while total < n:
        s = np.clip(np.round(rng.lognormal(4.6, 0.6, size=4096)), 1,
                    LTR_MAX_QUERY).astype(np.int64)
        sizes.append(s)
        total += int(s.sum())
    sizes = np.concatenate(sizes)
    cum = np.cumsum(sizes)
    q = int(np.searchsorted(cum, n))
    sizes = sizes[:q + 1]
    sizes[-1] = n - (int(cum[q - 1]) if q > 0 else 0)
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, f), generator=g, device=device)
    cols = torch.randperm(f, generator=g, device=device)[:20]
    w = torch.randn(20, generator=g, device=device)
    score = X[:, cols] @ w / np.sqrt(20.0) + 0.7 * torch.randn(
        n, generator=g, device=device)
    cuts = torch.quantile(score[:1 << 20], torch.tensor(
        [0.52, 0.84, 0.97, 0.99], device=device))
    y = torch.bucketize(score, cuts).double()
    return X.cpu().numpy(), y.cpu().numpy(), sizes


def phase_lambdarank(device, n: int, iters: int, profile: bool) -> dict:
    """Path (H): lambdarank at the MS LTR shape (``n`` rows x 137 dense
    features, queries of ~120 documents), the published settings that (D)
    uses, through ``lightgbm_tpu_torch.train``, leaf-wise, exact; the
    training set's NDCG@1,3,5,10 after every iteration."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.metric.rank import NDCGMetric
    t0 = time.perf_counter()
    X, y, group = ltr_task(n, device)
    t1 = time.perf_counter()
    train = lgb.Dataset(X, y, group=group).construct()
    t2 = time.perf_counter()
    log("  set-up: data %.2f s, binning %.2f s (%d rows x %d features, %d "
        "queries of mean %.1f and max %d documents, labels 0-4 %s)"
        % (t1 - t0, t2 - t1, n, X.shape[1], len(group), group.mean(),
           group.max(), np.bincount(y.astype(np.int64), minlength=5)))
    if train.handle.is_bundled:
        raise AssertionError("the MS LTR-shaped dataset came out bundled")
    ndcg = NDCGMetric(lgb.Config(LAMBDARANK_PARAMS))
    ndcg.init(train.handle.metadata, n)
    t = time.perf_counter()
    initial = ndcg.eval(np.zeros(n))
    log("  training NDCG@1,3,5,10 at the initial score %s (host evaluation "
        "%.2f s)" % (["%.6f" % v for v in initial], time.perf_counter() - t))
    rec = IterationRecorder(None, loss=lambda gbdt: ndcg.eval(
        gbdt.train_score[0].double().cpu().numpy()))
    D.reset_launches()
    booster = lgb.train(LAMBDARANK_PARAMS, train, num_boost_round=iters,
                        verbose_eval=False, callbacks=[rec, rec.start])
    counts = D.launches()
    gbdt = booster._booster
    trees = len(gbdt.models)
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    med = float(np.median(rec.iter_s))
    log("  iterations %d, seconds per iteration (train() update) %s (median "
        "%.4f)" % (len(rec.iter_s), ["%.4f" % v for v in rec.iter_s], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  training NDCG@1,3,5,10 per iteration %s"
        % [["%.6f" % v for v in r] for r in rec.losses])
    log("  leaves per tree %s, splits %d"
        % ([t.num_leaves for t in gbdt.models], splits))
    log("  device->host fetches per tree %s" % rec.fetches)
    log("  launches on path (H) %s" % counts)
    at10 = [r[3] for r in rec.losses]
    if not (at10[-1] >= at10[0] and at10[-1] > initial[3]):
        raise AssertionError("training NDCG@10 fell over the run: %.6f at "
                             "the initial score, %s" % (initial[3], at10))
    # the lambdarank gradient step alone: device time and peak memory
    score = gbdt.train_score[0].clone()
    obj = gbdt.objective
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grad, hess = obj.get_gradients(score)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grad_ms = cuda_ms(lambda: obj.get_gradients(score), reps=5, warmup=1)
    grad_dev, graph_out = graph_ms(lambda: obj.get_gradients(score))
    if not (bool(torch.isfinite(grad).all()) and bool((hess >= 0).all())
            and torch.equal(graph_out[0], grad)
            and torch.equal(graph_out[1], hess)):
        raise AssertionError("lambdarank gradients not finite, or not "
                             "repeated by their CUDA graph")
    log("  lambdarank gradient step (%d bucket chunks): %.3f ms (CUDA events,"
        " median of 5; its CUDA graph's replay %.3f), peak device memory "
        "%.1f MB above its inputs"
        % (len(obj._buckets), grad_ms, grad_dev, peak / 2 ** 20))
    check_tree0(gbdt, n, strict=False)
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (H): launches %s, want %s" % (counts,
                                                                 want))
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return {"launches": counts, "iter_s": rec.iter_s, "trees": trees,
            "splits": splits, "busy_ms": busy_ms, "ndcg": rec.losses,
            "grad_ms": grad_ms, "grad_graph_ms": grad_dev,
            "grad_peak_mb": peak / 2 ** 20}


# ------------------------------------------ sparse and categorical data ----

ALLSTATE_ROWS = 1_048_576       # cut from 13,184,290 (host set-up time)
ALLSTATE_TEST_ROWS = 104_858
ALLSTATE_F = 4228               # docs/Experiments.rst's Allstate row
# about 30 categorical columns whose one-hot codes make the 4,228 features
ALLSTATE_CARDS = [2, 2, 3, 3, 4, 5, 6, 8, 10, 12, 15, 20, 25, 30, 40, 50, 60,
                  75, 90, 110, 130, 150, 175, 200, 230, 260, 300, 350, 420]
ALLSTATE_CARDS.append(ALLSTATE_F - sum(ALLSTATE_CARDS))
EXPO_ROWS = 11_000_000          # BASELINE.md:15, the reference's Expo row
EXPO_TEST_ROWS = 100_000
J2_ITERS = 2                    # path (J2)'s iterations on (J)'s bins
# the airline columns as szilard/benchm-ml prepares them: (name,
# categories); 0 categories = numerical
EXPO_COLUMNS = [("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300),
                ("DepTime", 0), ("Distance", 0)]
EXPO_CATS = [i for i, (_, k) in enumerate(EXPO_COLUMNS) if k]
SPARSE_CAT_PARAMS = dict(EPSILON_PARAMS)        # (D)'s published settings
EXPO_VARIANT_PARAMS = dict(
    SPARSE_CAT_PARAMS, tree_grow_mode="level", hist_precision="quantized",
    extra_trees=True, max_cat_to_onehot=8,
    monotone_constraints=[int(name == "DepTime")
                          for name, _ in EXPO_COLUMNS])


def zipf(k: int, s: float, device) -> torch.Tensor:
    """Probabilities of k levels falling as 1 / (rank + 1)**s."""
    p = 1.0 / torch.arange(1, k + 1, device=device, dtype=torch.float64) ** s
    return p / p.sum()


def allstate_task(n: int, n_test: int, device, seed: int = 0):
    """Allstate-shaped sparse binary data (the reference's Allstate row:
    4,228 features): the one-hot codes of ``ALLSTATE_CARDS``' 30
    categorical columns, each row one level of each column, levels drawn
    Zipf-skewed (the first level of the small columns is in over half the
    rows, most levels of the large ones are rare), made on ``device`` from
    ``seed``; labels from a logistic of five columns' level effects.
    Returns host CSR arrays (indptr, indices) of the training and held-out
    rows (values are ones) and the labels."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = n + n_test
    offsets = np.concatenate([[0], np.cumsum(ALLSTATE_CARDS)[:-1]])
    levels = torch.empty((total, len(ALLSTATE_CARDS)), dtype=torch.int64,
                         device=device)
    logit = torch.full((total,), -0.5, dtype=torch.float64, device=device)
    for c, k in enumerate(ALLSTATE_CARDS):
        p = zipf(k, 1.0 if k > 2 else 2.0, device)
        levels[:, c] = torch.multinomial(p, total, replacement=True,
                                         generator=g)
        if c % 6 == 3:
            effect = torch.randn(k, generator=g, device=device,
                                 dtype=torch.float64)
            logit += 0.8 * effect[levels[:, c]]
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).double().cpu().numpy()
    cols = (levels + torch.as_tensor(offsets, device=device)).int()
    cols = cols.cpu().numpy()
    nc = len(ALLSTATE_CARDS)

    def csr(a, b):
        return np.arange(0, nc * (b - a) + 1, nc), cols[a:b].reshape(-1)
    return csr(0, n), csr(n, total), y[:n], y[n:]


def sparse_matrix(indptr, indices):
    import scipy.sparse as sps
    return sps.csr_matrix((np.ones(len(indices), np.float64), indices,
                           indptr), shape=(len(indptr) - 1, ALLSTATE_F))


def expo_task(n: int, n_test: int, device, seed: int = 0):
    """Expo-shaped airline rows (the reference's Expo row and its
    categorical-split experiment, docs/Features.rst): ``EXPO_COLUMNS``, the
    six categorical ones Zipf-skewed (airports and carriers) or mildly
    uneven (calendar), DepTime as hhmm from a daily profile, Distance
    log-normal; the label (departure delayed) from a logistic of the
    carrier, the origin, the month, the hour and the distance, made on
    ``device`` from ``seed``.  Returns host f32 X and f64 labels."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = n + n_test
    X = torch.empty((total, len(EXPO_COLUMNS)), dtype=torch.float32,
                    device=device)
    logit = torch.full((total,), -1.6, dtype=torch.float64, device=device)
    for c, (name, k) in enumerate(EXPO_COLUMNS):
        if not k:
            continue
        s = 1.0 if k >= 22 else 0.3
        v = torch.multinomial(zipf(k, s, device), total, replacement=True,
                              generator=g)
        # airport and carrier codes are not ordered by traffic
        perm = torch.randperm(k, generator=g, device=device)
        X[:, c] = perm[v].float()
        if name in ("UniqueCarrier", "Origin", "Month"):
            effect = torch.randn(k, generator=g, device=device,
                                 dtype=torch.float64)
            logit += 0.5 * effect[perm[v]]
    minutes = torch.clamp(torch.randn(total, generator=g, device=device,
                                      dtype=torch.float64) * 260 + 800, 0,
                          1439)
    X[:, 6] = (torch.floor(minutes / 60) * 100
               + torch.remainder(minutes, 60)).float()
    dist = torch.clamp(torch.exp(torch.randn(
        total, generator=g, device=device, dtype=torch.float64) * 0.7 + 6.3),
        30, 4983)
    X[:, 7] = dist.float()
    logit += 1.2 * (minutes - 800) / 600 - 0.1 * torch.log(dist / 500)
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).double().cpu().numpy()
    X = X.cpu().numpy()
    return X[:n], y[:n], X[n:], y[n:]


def expect_routes(path: str, routes: dict, want: dict) -> None:
    """The split passes' route counts of a path (``route_launches``):
    ``want`` maps (kernel, route) to the expected number of launches (or of
    windows for keys ending in ``_windows``); every other count must be 0."""
    for kernel, counts in routes.items():
        for route, v in counts.items():
            if v != want.get((kernel, route), 0):
                raise AssertionError(
                    "path (%s): %s %s counted %d, want %d"
                    % (path, kernel, route, v, want.get((kernel, route), 0)))


def cat_split_modes(models, learner, onehot_max: int) -> dict:
    """Categorical splits of ``models`` by search mode and feature: one-hot
    when the feature has at most ``max_cat_to_onehot`` bins."""
    fh = learner.feat_host
    out = {}
    for t in models:
        for node in range(t.num_leaves - 1):
            if int(t.decision_type[node]) & 1:
                f = int(t.split_feature_inner[node])
                mode = ("one_hot" if fh["num_bin"][f] <= onehot_max
                        else "many_vs_many")
                out.setdefault(mode, {}).setdefault(f, 0)
                out[mode][f] += 1
    return out


def train_with_validation(params, train, valid, iters, label, auc_name):
    """``lightgbm_tpu_torch.train`` with a validation set, recorded by an
    :class:`IterationRecorder`, the launch and route counts read around
    it."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    rec = IterationRecorder(label)
    evals = {}
    D.reset_launches()
    booster = lgb.train(params, train, num_boost_round=iters,
                        valid_sets=[valid], valid_names=[auc_name],
                        evals_result=evals, verbose_eval=False,
                        callbacks=[rec, rec.start])
    return booster, rec, evals[auc_name]["auc"], D.launches(), \
        D.route_launches()


def report_training(path, booster, rec, aucs, counts, routes, n, n_test):
    gbdt = booster._booster
    trees = len(gbdt.models)
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    med = float(np.median(rec.iter_s))
    log("  iterations %d, seconds per iteration (train() update and "
        "evaluation) %s (median %.4f)"
        % (len(rec.iter_s), ["%.4f" % v for v in rec.iter_s], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  train logloss per iteration %s" % ["%.6f" % v for v in rec.losses])
    log("  held-out AUC per iteration %s over %d rows"
        % (["%.6f" % v for v in aucs], n_test))
    log("  leaves per tree %s, splits %d, levels per tree %s"
        % ([t.num_leaves for t in gbdt.models], splits,
           gbdt.learner.level_count() if gbdt.learner.tree_grow_mode
           == "level" else 0))
    log("  device->host fetches per tree %s" % rec.fetches)
    log("  launches on path (%s) %s; split-pass routes %s"
        % (path, counts, routes))
    return gbdt, trees, splits, med


def check_validation_scores(gbdt, booster, X_test, k=None) -> None:
    """Raw predictions through ``core/predict.py`` (``Booster.predict``)
    against the validation scores that ``train()`` kept, on the first ``k``
    held-out rows (all when None)."""
    raw = booster.predict(X_test if k is None else X_test[:k],
                          raw_score=True,
                          num_iteration=booster.current_iteration())
    m = raw.shape[0]
    vscore = gbdt.valid_sets[0]["score"][0, :m].double().cpu().numpy()
    err_v = float(np.abs(raw - vscore).max())
    if not (np.isfinite(raw).all() and err_v <= VALID_SCORE_ATOL):
        raise AssertionError("validation scores vs predict: max|diff| %.3g "
                             "> %.0e" % (err_v, VALID_SCORE_ATOL))
    log("  validation scores accumulated in training vs predict on %d rows: "
        "max|diff| %.3g" % (m, err_v))
    return raw


def falls(losses, start) -> bool:
    return all(b < a for a, b in zip([start] + losses, losses))


def phase_allstate(device, n: int, n_test: int, iters: int,
                   profile: bool) -> dict:
    """Path (I): EFB on Allstate-shaped sparse binary data (4,228 features,
    not cut): scipy CSR -> ``Dataset`` -> ``BinnedDataset.from_csr`` (never
    densified; its EFB bundles the features into group columns), through
    ``lightgbm_tpu_torch.train`` with a CSR validation set at (D)'s
    published settings: the root histogram over the group columns and one
    split pass per split that unfolds the split feature's group codes."""
    import lightgbm_tpu_torch as lgb
    t0 = time.perf_counter()
    tr, te, y, y_test = allstate_task(n, n_test, device)
    t1 = time.perf_counter()
    # binned with the training parameters, as train() would bin it
    train = lgb.Dataset(sparse_matrix(*tr), y,
                        params=SPARSE_CAT_PARAMS).construct()
    valid = train.create_valid(sparse_matrix(*te), y_test).construct()
    t2 = time.perf_counter()
    ds = train.handle
    G = ds.binned.shape[1]
    singles = sum(len(f) == 1 for f in ds.feature_groups)
    log("  set-up: data %.2f s, binning %.2f s (%d + %d rows x %d sparse "
        "binary features from %d categorical columns, cardinalities %s; %d "
        "nonzeros)" % (t1 - t0, t2 - t1, n, n_test, ALLSTATE_F,
                       len(ALLSTATE_CARDS), ALLSTATE_CARDS, len(tr[1])))
    log("  EFB: %d used features in G = %d group columns (%d of one "
        "feature), max_group_bin %d" % (ds.num_features, G, singles,
                                        ds.max_group_bin))
    if not (ds.is_bundled and valid.handle.is_bundled
            and ds.num_features == ALLSTATE_F):
        raise AssertionError("the Allstate-shaped dataset did not bundle its "
                             "%d features" % ds.num_features)
    label = torch.as_tensor(y, device=device)
    booster, rec, aucs, counts, routes = train_with_validation(
        SPARSE_CAT_PARAMS, train, valid, iters, label, "test")
    gbdt, trees, splits, med = report_training("I", booster, rec, aucs,
                                               counts, routes, n, n_test)
    lay = gbdt.learner.layout
    log("  row store %d x %d B = %.1f MB (%d group columns, W = %d), kernel "
        "bins %d, per-feature scan bins %d"
        % (gbdt.learner.template.shape[0], lay.W,
           gbdt.learner.template.numel() / 2 ** 20, G, lay.W,
           gbdt.learner.num_bins, gbdt.learner.feat_bins))
    start = logloss(torch.full_like(label, gbdt.objective.boost_from_score(0)),
                    label)
    if not falls(rec.losses, start):
        raise AssertionError("train logloss did not fall every iteration")
    if len(aucs) != trees or not aucs[-1] > 0.6:
        raise AssertionError("held-out AUC per iteration %s" % aucs)
    Xv = sparse_matrix(*te)
    raw = check_validation_scores(gbdt, booster, Xv, 20_000)
    Xt = sparse_matrix(*tr)[:2000].toarray()
    check_predictions(gbdt, Xt, Xv[:2000].toarray(), raw[:2000])
    check_tree0(gbdt, n, strict=False)
    times = check_path_kernels(gbdt.learner, "I", unfold=True)
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (I): launches %s, want %s" % (counts,
                                                                 want))
    expect_routes("I", routes, {("partition", "unfold"): splits,
                                ("partition", "unfold_windows"): splits})
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return {"launches": counts, "routes": routes, "iter_s": rec.iter_s,
            "auc": aucs, "trees": trees, "splits": splits,
            "busy_ms": busy_ms, "groups": G, "binning_s": t2 - t1,
            "times": times}


def phase_expo(device, n: int, n_test: int, iters: int,
               profile: bool) -> tuple:
    """Path (J): categorical features at the Expo shape (``EXPO_COLUMNS``,
    six categorical through ``categorical_feature``), through
    ``lightgbm_tpu_torch.train`` with a validation set at (D)'s published
    settings: every categorical column has more bins than
    ``max_cat_to_onehot=4``, so its splits are the sorted many-vs-many
    search, routed by the split passes' category bitsets.  Returns the
    path's record and the (train, valid) Datasets for (J2)."""
    import lightgbm_tpu_torch as lgb
    t0 = time.perf_counter()
    X, y, X_test, y_test = expo_task(n, n_test, device)
    t1 = time.perf_counter()
    train = lgb.Dataset(X, y, categorical_feature=EXPO_CATS,
                        params=SPARSE_CAT_PARAMS).construct()
    valid = train.create_valid(X_test, y_test).construct()
    t2 = time.perf_counter()
    ds = train.handle
    log("  set-up: data %.2f s, binning %.2f s (%d + %d rows x %d columns, "
        "categorical %s with %s bins; delayed share %.4f)"
        % (t1 - t0, t2 - t1, n, n_test, X.shape[1],
           [EXPO_COLUMNS[i][0] for i in EXPO_CATS],
           [ds.num_bin_per_feature[ds.inner_feature_map[i]]
            for i in EXPO_CATS], float(y.mean())))
    if ds.is_bundled or not ds.feature_is_categorical().any():
        raise AssertionError("the Expo-shaped dataset: bundled %s, "
                             "categorical %s" % (ds.is_bundled,
                                                 ds.feature_is_categorical()))
    label = torch.as_tensor(y, device=device)
    booster, rec, aucs, counts, routes = train_with_validation(
        SPARSE_CAT_PARAMS, train, valid, iters, label, "test")
    gbdt, trees, splits, med = report_training("J", booster, rec, aucs,
                                               counts, routes, n, n_test)
    modes = cat_split_modes(gbdt.models, gbdt.learner, 4)
    ncat = sum(t.num_cat for t in gbdt.models)
    log("  categorical splits %d of %d by mode and inner feature %s; kernel "
        "bins %d" % (ncat, splits, modes, gbdt.learner.num_bins))
    start = logloss(torch.full_like(label, gbdt.objective.boost_from_score(0)),
                    label)
    if not falls(rec.losses, start):
        raise AssertionError("train logloss did not fall every iteration")
    if len(aucs) != trees or not aucs[-1] > 0.6:
        raise AssertionError("held-out AUC per iteration %s" % aucs)
    if not ncat or set(modes) != {"many_vs_many"}:
        raise AssertionError("path (J): categorical splits by mode %s" % modes)
    raw = check_validation_scores(gbdt, booster, X_test)
    check_predictions(gbdt, X, X_test, raw)
    check_tree0(gbdt, n, strict=False)
    times = check_path_kernels(gbdt.learner, "J", categorical=True)
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (J): launches %s, want %s" % (counts,
                                                                 want))
    expect_routes("J", routes, {("partition", "categorical"): ncat,
                                ("partition", "categorical_windows"): ncat})
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return ({"launches": counts, "routes": routes, "iter_s": rec.iter_s,
             "auc": aucs, "trees": trees, "splits": splits, "modes": modes,
             "busy_ms": busy_ms, "binning_s": t2 - t1, "times": times},
            (train, valid, X_test))


def subtree_leaves(tree, node: int) -> list:
    out, stack = [], [node]
    while stack:
        c = stack.pop()
        for child in (int(tree.left_child[c]), int(tree.right_child[c])):
            if child < 0:
                out.append(~child)
            else:
                stack.append(child)
    return out


def phase_expo_variants(device, sets, iters: int, profile: bool) -> dict:
    """Path (J2): (J)'s binned data (not binned again) along the other
    forms: ``tree_grow_mode=level``, ``hist_precision=quantized``,
    ``monotone_constraints`` +1 on DepTime, ``extra_trees`` and
    ``max_cat_to_onehot=8`` (DayOfWeek's 7 categories in one-hot mode, the
    others many-vs-many): one integer root histogram per tree and one
    level pass per level, with category bitsets in its windows; every
    DepTime split keeps each leaf of its left subtree at or below each leaf
    of its right one."""
    train, valid, X_test = sets
    n, n_test = train.handle.num_data, valid.handle.num_data
    label = torch.as_tensor(np.asarray(train.handle.metadata.label),
                            device=device)
    booster, rec, aucs, counts, routes = train_with_validation(
        EXPO_VARIANT_PARAMS, train, valid, iters, label, "test")
    gbdt, trees, splits, med = report_training("J2", booster, rec, aucs,
                                               counts, routes, n, n_test)
    modes = cat_split_modes(gbdt.models, gbdt.learner, 8)
    ncat = sum(t.num_cat for t in gbdt.models)
    dep = gbdt.train_data.inner_feature_map[6]
    checked = 0
    for t in gbdt.models:
        for node in range(t.num_leaves - 1):
            if int(t.split_feature_inner[node]) == dep:
                left = subtree_leaves(t, int(t.left_child[node])) \
                    if t.left_child[node] >= 0 else [~int(t.left_child[node])]
                right = subtree_leaves(t, int(t.right_child[node])) \
                    if t.right_child[node] >= 0 \
                    else [~int(t.right_child[node])]
                if not (max(t.leaf_value[left]) <= min(t.leaf_value[right])):
                    raise AssertionError("a DepTime split breaks the +1 "
                                         "constraint at node %d" % node)
                checked += 1
    log("  categorical splits %d of %d by mode and inner feature %s; %d "
        "DepTime splits, each with its left leaves <= its right leaves"
        % (ncat, splits, modes, checked))
    if set(modes) != {"one_hot", "many_vs_many"} or not checked:
        raise AssertionError("path (J2): modes %s, DepTime splits %d"
                             % (modes, checked))
    start = logloss(torch.full_like(label, gbdt.objective.boost_from_score(0)),
                    label)
    if not falls(rec.losses, start):
        raise AssertionError("train logloss did not fall every iteration")
    check_validation_scores(gbdt, booster, X_test)
    check_tree0(gbdt, n, strict=True)
    times = check_path_kernels(gbdt.learner, "J2", categorical=True)
    levels = gbdt.learner.level_count() * trees
    want = {"histogram_int": trees, "partition_level": levels}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("path (J2): launches %s, want %s" % (counts,
                                                                  want))
    cat_windows = routes["partition_level"]["categorical_windows"]
    cat_launches = routes["partition_level"]["categorical"]
    expect_routes("J2", routes, {
        ("partition_level", "categorical"): cat_launches,
        ("partition_level", "categorical_windows"): ncat})
    if not 0 < cat_launches <= levels:
        raise AssertionError("path (J2): %d level passes with categorical "
                             "windows" % cat_launches)
    log("  level passes with category bitsets: %d of %d, %d windows"
        % (cat_launches, levels, cat_windows))
    busy_ms = None
    if profile:
        busy_ms = profile_iteration(gbdt)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (busy_ms / med / 10,
                                    100 - busy_ms / med / 10, med))
    return {"launches": counts, "routes": routes, "iter_s": rec.iter_s,
            "auc": aucs, "trees": trees, "splits": splits, "modes": modes,
            "busy_ms": busy_ms, "times": times}


def check_path_kernels(learner, path: str, unfold: bool = False,
                       categorical: bool = False) -> dict:
    """The kernels at a path's own shape, against their plain versions: the
    learner's row store (its bins, random gradients) through the root
    histogram (exact and integer), a split pass with the path's route (an
    EFB unfold of a bundled feature, or a category bitset) on a mid window,
    and in level mode a level pass whose windows take that route.  Then
    their times on the whole store (exact; in level mode the integer level
    pass over 8 windows), beside their bounds, plain versions and
    ``index_add_`` or the store's copy."""
    from lightgbm_tpu_torch.core.tree_learner import fill_gradients
    dev = learner.device
    g = torch.Generator(device=dev).manual_seed(31)
    n = learner.num_data
    lay = learner.layout
    F, B = learner.num_columns, learner.num_bins
    kw = dict(num_features=F, voff=lay.voff, bpc=lay.bpc,
              packed=learner.packed)
    fh = learner.feat_host
    rng = np.random.RandomState(7)
    words = [0] * (B // 32)
    if unfold:
        f = int(np.flatnonzero([len(gr) > 1 for gr in
                                learner.dataset.feature_groups])[0])
        fid = int(learner.dataset.feature_groups[f][1])
        route = (int(fh["group"][fid]), 0, 0, 0, int(fh["num_bin"][fid]),
                 0, 0, 1, int(fh["offset"][fid]))
    else:
        fid = int(np.flatnonzero(fh["is_cat"] & (fh["num_bin"] > 16))[0])
        for b in np.flatnonzero(rng.rand(int(fh["num_bin"][fid])) < 0.5):
            words[b >> 5] |= 1 << (int(b) & 31)
        words = [w - (1 << 32) if w >= 1 << 31 else w for w in words]
        route = (fid, 0, 0, 0, int(fh["num_bin"][fid]), 0, 1, 0, 0)
    name = "unfold" if unfold else "cat"
    level = learner.tree_grow_mode == "level"
    bounds_w = np.linspace(0, n, 9).astype(np.int64)
    scals = np.asarray([scal_row(int(a), int(b - a), route, words, i % 2)
                        for i, (a, b) in enumerate(zip(bounds_w,
                                                       bounds_w[1:]))],
                       dtype=np.int64)
    times = {}
    for quantized in (False, True):
        if quantized:
            grad = torch.randint(-127, 128, (n,), generator=g,
                                 device=dev).float()
            hess = torch.randint(0, 256, (n,), generator=g, device=dev).float()
        else:
            grad = torch.randn(n, generator=g, device=dev)
            hess = torch.rand(n, generator=g, device=dev)
        rows = fill_gradients(learner.template, lay, grad, hess)
        tag = "int" if quantized else "exact"
        check_hist(rows, B, 0, n, "(%s) %s root hist G=%d B=%d" % (
            path, tag, F, B), quantized=quantized, **kw)
        scal = scal_row(n // 7, n // 3, route, words, 1)
        check_split(rows, scal, F=F, B=B, voff=lay.voff, bpc=lay.bpc,
                    packed=learner.packed, quantized=quantized,
                    what="(%s) %s split %s" % (path, tag, name))
        if level:
            check_level(rows, scals, "(%s) %s level, 8 windows" % (path, tag),
                        num_bins=B, quantized=quantized, **kw)
        if quantized == level:
            times.update(path_times(rows, path, name, route, words, scals,
                                    B, quantized, kw))
        del rows
        torch.cuda.empty_cache()
    return times


def path_times(rows, path, name, route, words, scals, B, quantized,
               kw) -> dict:
    """Times of the path's kernels on its whole row store (the root
    window): the histogram (beside ``index_add_``) and the split pass with
    the path's route, or in level mode the level pass over ``scals``
    (beside the store's copy)."""
    from lightgbm_tpu_torch.core import histogram as H
    from lightgbm_tpu_torch.core import partition as P
    n = int(scals[:, 1].sum())
    F, W, bpc = kw["num_features"], rows.shape[1], kw["bpc"]
    hk = dict(kw, quantized=quantized)
    ms = cuda_ms(lambda: H.histogram_rows(rows, B, 0, n, **hk), reps=10)
    dev = queued_ms(lambda: H.histogram_rows(rows, B, 0, n, **hk), reps=10)
    plain = cuda_ms(lambda: H.histogram_rows_plain(rows, B, 0, n, **hk),
                    reps=3, warmup=1)
    lib, lib_dev = hist_index_add_ms(rows, kw["voff"], F, B, n, quantized,
                                     bpc)
    b_ms, b_by = bound(n * row_bytes(F, bpc), 2.0 * n * F)
    hist = dict(rows=n, ms=ms, queued_ms=dev, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, library_queued_ms=lib_dev)
    log("  (%s) %s histogram %d rows x %d columns, B=%d: kernel %.4f ms "
        "(queued %.4f), bound %.4f ms (%s), plain %.4f ms, index_add_ %.4f "
        "ms (queued %.4f)" % (path, "int" if quantized else "exact", n, F, B,
                              ms, dev, b_ms, b_by, plain, lib, lib_dev))
    pk = dict(hk, num_bins=B)
    dst = torch.empty_like(rows)
    if len(scals) > 1 and quantized:
        fn = lambda: P.partition_hist_level(rows, dst, scals, **pk)  # noqa
        pfn = lambda: P.partition_hist_level_plain(rows, dst, scals,  # noqa
                                                   **pk)
        what = "level pass, 8 windows"
    else:
        scal = scal_row(0, n, route, words, 1)
        work = rows.clone()
        fn = lambda: P.partition_hist(work, scal, **pk)  # noqa: E731
        pfn = lambda: P.partition_hist_plain(rows, scal, **pk)  # noqa
        what = "split pass"
    ms = cuda_ms(fn, reps=10)
    dev = queued_ms(fn, reps=10)
    plain = cuda_ms(pfn, reps=3, warmup=1)
    copy = cuda_ms(lambda: dst.copy_(rows), reps=10)
    copy_dev = queued_ms(lambda: dst.copy_(rows), reps=10)
    b_ms, b_by = bound(2.0 * n * W, 2.0 * (n / 2) * F)
    log("  (%s) %s %s route %d rows: kernel %.4f ms (queued %.4f), bound "
        "%.4f ms (%s), plain %.4f ms, copy of the store %.4f ms (queued "
        "%.4f)" % (path, what, name, n, ms, dev, b_ms, b_by, plain, copy,
                   copy_dev))
    split = dict(rows=n, ms=ms, queued_ms=dev, plain_ms=plain, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None, copy_ms=copy,
                 copy_queued_ms=copy_dev)
    torch.cuda.empty_cache()
    return {"histogram": hist, "split": split}


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


# ------------------------- other boosters, forced splits, CEGB, pool ----

HIGGS_PARAMS = dict(objective="binary", num_leaves=255, learning_rate=0.1,
                    max_bin=255, verbosity=-1)
GOSS_ITERS = 12     # 1 / learning_rate = 10 warm-up iterations, then 2
RF_ITERS = 5
FORCED_ITERS = 5
POOL_ITERS = 2
POOL_MB = 125       # 32 slots of 2000 x 2 x 256 f32 at (D)'s shape


def run_iterations(booster, iters: int, label, loss=None) -> dict:
    """``train_one_iter`` ``iters`` times with the launch counts read
    around the loop: each iteration's seconds (ending in a synchronise),
    the train loss after it (binary log loss unless ``loss``), its last
    tree's device->host fetches and the pool's rebuilt parents."""
    from lightgbm_tpu_torch import device as D
    loss = loss or (lambda: logloss(booster.train_score[0], label))
    out = {"iter_s": [], "losses": [], "fetches": [], "misses": []}
    D.reset_launches()
    for _ in range(iters):
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        out["iter_s"].append(time.perf_counter() - t)
        out["losses"].append(loss())
        out["fetches"].append(booster.last_arrays.host_fetches)
        out["misses"].append(booster.last_arrays.pool_misses)
    out["launches"] = D.launches()
    out["trees"] = len(booster.models)
    out["splits"] = sum(t.num_leaves - 1 for t in booster.models)
    return out


def report_path(path: str, r: dict, n: int, loss_name: str = "logloss"):
    med = float(np.median(r["iter_s"]))
    log("  iterations %d, seconds per iteration %s (median %.4f)"
        % (len(r["iter_s"]), ["%.4f" % v for v in r["iter_s"]], med))
    log("  row-trees/s %.1f (median iteration)" % (n / med))
    log("  train %s per iteration %s" % (loss_name, ["%.6f" % v
                                                    for v in r["losses"]]))
    log("  splits %d in %d trees; device->host fetches per tree %s"
        % (r["splits"], r["trees"], r["fetches"]))
    log("  launches on path (%s) %s" % (path, r["launches"]))
    return med


def expect_leafwise_launches(path: str, r: dict, rebuilt: int = 0) -> None:
    """One root histogram per tree (plus the pool's rebuilt parents) and one
    split pass per split, nothing else."""
    want = {"histogram": r["trees"] + rebuilt, "partition": r["splits"]}
    if r["launches"] != {k: want.get(k, 0) for k in r["launches"]}:
        raise AssertionError("path (%s): launches %s, want %s"
                             % (path, r["launches"], want))


def profile_path(r: dict, booster, profile: bool) -> None:
    r["busy_ms"] = None
    if profile:
        med = float(np.median(r["iter_s"]))
        r["busy_ms"] = profile_iteration(booster)
        log("  device busy %.1f%% and idle %.1f%% of the median unprofiled "
            "iteration (%.4f s)" % (r["busy_ms"] / med / 10,
                                    100 - r["busy_ms"] / med / 10, med))


def goss_weights_host(key: np.ndarray, top_k: int, sampled: np.ndarray,
                      multiply: float) -> np.ndarray:
    """GOSS row weights recomputed on the host: the stable descending order
    of ``np.argsort``, weight 1 for its first ``top_k`` rows and
    ``multiply`` at the positions ``sampled`` of the rest."""
    order = np.argsort(-key, kind="stable")
    w = np.zeros(key.size, np.float32)
    w[order[:top_k]] = 1.0
    w[order[top_k:][sampled]] = np.float32(multiply)
    return w


def phase_goss(device, data, ds, profile: bool) -> dict:
    """Path (K): GOSS (``top_rate=0.2``, ``other_rate=0.1``) on (A)'s
    binned rows, 12 iterations: the first ``1 / learning_rate`` = 10
    without sampling, then two sampled ones, whose device row weights must
    equal the host's stable argsort of the fetched key with the stream's
    draws replayed from a fresh ``RandomState(bagging_seed)``."""
    from lightgbm_tpu_torch import Config, create_objective
    from lightgbm_tpu_torch.boosting import create_boosting
    X, y, X_test, _ = data
    n = len(y)
    cfg = Config(boosting="goss", top_rate=0.2, other_rate=0.1,
                 **HIGGS_PARAMS)
    booster = create_boosting("goss", cfg, ds,
                              create_objective("binary", cfg))
    label = torch.as_tensor(y, device=booster.device)
    warm = int(1.0 / cfg.learning_rate)
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    replay = np.random.RandomState(int(cfg.bagging_seed))
    r = {"iter_s": [], "losses": [], "fetches": []}
    from lightgbm_tpu_torch import device as D
    D.reset_launches()
    for it in range(GOSS_ITERS):
        t = time.perf_counter()
        booster.train_one_iter()
        torch.cuda.synchronize()
        r["iter_s"].append(time.perf_counter() - t)
        r["losses"].append(logloss(booster.train_score[0], label))
        r["fetches"].append(booster.last_arrays.host_fetches)
        if it < warm:
            if booster.goss_weight is not None:
                raise AssertionError("GOSS sampled in warm-up iteration %d"
                                     % it)
            continue
        sampled = replay.choice(n - top_k, size=other_k, replace=False)
        key = booster.goss_key.cpu().numpy()
        want = goss_weights_host(key, top_k, sampled, (n - top_k) / other_k)
        got = booster.goss_weight.cpu().numpy()
        nz = int(np.count_nonzero(got))
        if not (np.array_equal(got.view(np.uint32), want.view(np.uint32))
                and nz == top_k + other_k
                and booster.bag_data_cnt == top_k + other_k):
            raise AssertionError(
                "iteration %d: GOSS weights differ from the host's in %d "
                "rows; %d nonzero, bag_data_cnt %d, want %d"
                % (it, int((got != want).sum()), nz, booster.bag_data_cnt,
                   top_k + other_k))
        log("  iteration %d: device weights equal the host argsort and "
            "replayed draws byte for byte; %d nonzero (top %d + other %d, "
            "x%.1f)" % (it, nz, top_k, other_k, (n - top_k) / other_k))
    r.update(launches=D.launches(), trees=len(booster.models),
             splits=sum(t.num_leaves - 1 for t in booster.models))
    report_path("K", r, n)
    log("  seconds per iteration: warm-up median %.4f, sampled %s"
        % (float(np.median(r["iter_s"][:warm])),
           ["%.4f" % v for v in r["iter_s"][warm:]]))
    start = logloss(torch.full_like(label,
                                    booster.objective.boost_from_score(0)),
                    label)
    if not (falls(r["losses"][:warm], start) and r["losses"][-1]
            < r["losses"][warm - 1] and np.isfinite(r["losses"]).all()):
        raise AssertionError("GOSS train log loss %s" % r["losses"])
    raw = booster.predict(X_test, raw_score=True)
    check_predictions(booster, X, X_test, raw)
    check_tree0(booster, n, strict=False)
    expect_leafwise_launches("K", r)
    profile_path(r, booster, profile)
    r["warm_s"] = r["iter_s"][:warm]
    return r


def dart_drop_plan(cfg, iters: int) -> list:
    """The dropped iterations of each of ``iters`` DART iterations, from
    ``RandomState(drop_seed)`` alone: without ``uniform_drop`` the draws
    depend on the iterations' weights, which are their learning rates
    ``learning_rate / (1 + k)`` scaled by each later drop (dart.hpp:95-183;
    this plan covers ``xgboost_dart_mode=false``)."""
    rng = np.random.RandomState(int(cfg.drop_seed))
    weight, total, plan = [], 0.0, []
    for it in range(iters):
        drop = []
        if rng.uniform() >= cfg.skip_drop and total > 0:
            inv_avg = len(weight) / total
            rate = min(cfg.drop_rate, cfg.max_drop * inv_avg / total)
            for i in range(it):
                if rng.uniform() < rate * weight[i] * inv_avg:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop:
                        break
        k = float(len(drop))
        for i in drop:
            total -= weight[i] / (k + 1.0)
            weight[i] *= k / (k + 1.0)
        weight.append(cfg.learning_rate / (1.0 + k))
        total += weight[-1]
        plan.append(drop)
    return plan


def phase_dart(device, data, ds, profile: bool) -> dict:
    """Path (L): DART at its defaults (``drop_rate=0.1``, ``skip_drop=0.5``,
    ``max_drop=50``, ``drop_seed=4``) on (A)'s binned rows through
    ``lightgbm_tpu_torch.train`` with (A)'s held-out rows as a validation
    set, for as many iterations as the host's drop plan needs for two of
    them to drop trees."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import Config
    X, y, X_test, y_test = data
    n = len(y)
    params = dict(HIGGS_PARAMS, boosting="dart", metric="binary_logloss")
    cfg = Config(**params)
    plan = dart_drop_plan(cfg, 64)
    iters = [i for i, d in enumerate(plan) if d][1] + 1
    log("  host drop plan of %d iterations: %s" % (iters, plan[:iters]))
    train = lgb.Dataset(X, y)
    train.handle = ds
    valid = lgb.Dataset(X_test, y_test, reference=train).construct()
    label = torch.as_tensor(y, device=device)
    drops = []

    class Drops:
        order = 6
        before_iteration = False

        def __call__(self, env):
            drops.append(list(env.model._booster.drop_index))
    rec = IterationRecorder(label)
    from lightgbm_tpu_torch import device as D
    evals = {}
    D.reset_launches()
    booster = lgb.train(params, train, num_boost_round=iters,
                        valid_sets=[valid], valid_names=["test"],
                        evals_result=evals, verbose_eval=False,
                        callbacks=[rec, rec.start, Drops()])
    gbdt = booster._booster
    r = {"iter_s": rec.iter_s, "losses": rec.losses,
         "fetches": rec.fetches, "launches": D.launches(),
         "trees": len(gbdt.models),
         "splits": sum(t.num_leaves - 1 for t in gbdt.models)}
    report_path("L", r, n)
    log("  dropped iterations per iteration %s; held-out log loss %s"
        % (drops, ["%.6f" % v for v in evals["test"]["binary_logloss"]]))
    if drops != plan[:iters]:
        raise AssertionError("drops %s, host plan %s" % (drops,
                                                          plan[:iters]))
    start = logloss(torch.full_like(label,
                                    gbdt.objective.boost_from_score(0)),
                    label)
    if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < start):
        raise AssertionError("DART train log loss %s" % r["losses"])
    # the train score is the sum of the (re-weighted) trees over the bins
    acc = torch.zeros(n, dtype=torch.float64, device=device)
    for tree in gbdt.models:
        gbdt._add_tree_score(tree, gbdt.train_bins(), acc)
    score = gbdt.train_score[0].double()
    err = float((score - acc).abs().max())
    bound = 1e-5 * float(score.abs().max())
    if not err <= bound:
        raise AssertionError("train score vs the sum of the trees: max|diff|"
                             " %.3g > %.3g" % (err, bound))
    log("  train score vs the sum of the model's %d trees routed over the "
        "training bins: max|diff| %.3g (bound %.3g)" % (len(gbdt.models),
                                                        err, bound))
    raw = check_validation_scores(gbdt, booster, X_test)
    check_predictions(gbdt, X, X_test, raw)
    check_tree0(gbdt, n, strict=False)
    expect_leafwise_launches("L", r)
    profile_path(r, gbdt, profile)
    r["drops"] = drops
    return r


def phase_rf(device, data, ds, profile: bool) -> dict:
    """Path (M): random forest (``bagging_fraction=0.632``,
    ``bagging_freq=1``, ``feature_fraction=0.8``) on (A)'s binned rows:
    ``average_output`` in the model text, ``predict`` the mean of the
    trees, the train score their running mean, and the first and last
    trees equal to plain rebuilds on the gradients of the constant initial
    score with their iteration's bag and feature masks."""
    from lightgbm_tpu_torch import Config, create_objective
    from lightgbm_tpu_torch.boosting import create_boosting
    X, y, X_test, _ = data
    n = len(y)
    cfg = Config(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
                 feature_fraction=0.8, **HIGGS_PARAMS)
    booster = create_boosting("rf", cfg, ds, create_objective("binary", cfg))
    label = torch.as_tensor(y, device=booster.device)
    r = run_iterations(booster, RF_ITERS, label)
    report_path("M", r, n)
    text = booster.save_model_to_string()
    if "\naverage_output\n" not in text[:text.index("Tree=")]:
        raise AssertionError("the model text lacks average_output")
    k = 2000
    xs = X_test[:k].astype(np.float64)
    mean = np.mean([t.predict(xs) for t in booster.models], axis=0)
    raw = booster.predict(X_test, raw_score=True)
    err = float(np.abs(raw[:k] - mean).max())
    train = booster.train_score[0, :k].double().cpu().numpy()
    err_t = float(np.abs(booster.predict(X[:k], raw_score=True)
                         - train).max())
    if not (err <= PREDICT_ATOL and err_t <= TRAIN_SCORE_ATOL
            and np.isfinite(raw).all()):
        raise AssertionError("RF predict vs the mean of Tree.predict %.3g, "
                             "train score vs predict %.3g" % (err, err_t))
    log("  model text has average_output; predict vs the mean of the %d "
        "trees' Tree.predict on %d held-out rows: max|diff| %.3g; train "
        "score (running mean) vs predict on %d training rows: %.3g"
        % (len(booster.models), k, err, k, err_t))
    if not (r["losses"][-1] < logloss(torch.full_like(
            label, booster.objective.boost_from_score(0)), label)):
        raise AssertionError("RF train log loss %s" % r["losses"])
    frng = np.random.RandomState(int(cfg.feature_fraction_seed))
    masks = []
    for _ in range(RF_ITERS):
        used = max(1, int(round(ds.num_features * 0.8)))
        m = np.zeros(ds.num_features, bool)
        m[frng.choice(ds.num_features, size=used, replace=False)] = True
        masks.append(torch.as_tensor(m, device=booster.device))
    for i in (0, RF_ITERS - 1):
        bag = bag_mask_host(n, int(cfg.bagging_seed), i, 0.632)
        check_tree0(booster, n, strict=False, index=i, feature_mask=masks[i],
                    bag=(torch.as_tensor(bag, device=booster.device),
                         int(bag.sum())))
    expect_leafwise_launches("M", r)
    profile_path(r, booster, profile)
    return r


def paid_bits_host(booster, bins, F: int) -> torch.Tensor:
    """Lazy CEGB's paid bits recomputed from the model: a row has paid
    feature f once a node splitting on f lies on its path in some tree,
    i.e. its leaf lies in the subtree of such a node."""
    from lightgbm_tpu_torch.core.tree_learner import (arrays_from_tree,
                                                      route_binned)
    n = bins.shape[0]
    bits = torch.zeros((n, -(-F // 8)), dtype=torch.uint8,
                       device=bins.device)
    fh = booster.learner.feat_host
    for tree in booster.models:
        leaf = route_binned(bins, arrays_from_tree(tree, booster.train_data),
                            fh)
        for node in range(tree.num_leaves - 1):
            f = int(tree.split_feature_inner[node])
            under = torch.as_tensor(subtree_leaves(tree, node),
                                    device=bins.device)
            bits[:, f // 8] |= (torch.isin(leaf, under).to(torch.uint8)
                                << (f % 8))
    return bits


def phase_forced_cegb(device, data, ds, profile: bool) -> dict:
    """Path (N): forced splits and CEGB on (A)'s binned rows, leaf-wise,
    exact: a three-split schedule in the form of LightGBM's
    examples/binary_classification/forced_splits.json (the root on feature
    25 and both its children on feature 26, at the features' medians)
    written to a temporary file, and the split, coupled and lazy CEGB
    penalties over the 28 features."""
    import tempfile
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch.core.tree_learner import SerialTreeLearner
    X, y, X_test, _ = data
    n = len(y)
    med = [float(np.median(X[:, f])) for f in (25, 26)]
    spec = {"feature": 25, "threshold": med[0],
            "left": {"feature": 26, "threshold": med[1]},
            "right": {"feature": 26, "threshold": med[1]}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_forced_")
    fname = os.path.join(tmp, "forced_splits.json")
    with open(fname, "w") as fh:
        json.dump(spec, fh)
    F = ds.num_features
    cfg = Config(forcedsplits_filename=fname, cegb_penalty_split=1e-5,
                 cegb_penalty_feature_coupled=[2.0] * F,
                 cegb_penalty_feature_lazy=[1e-5] * F, **HIGGS_PARAMS)
    try:
        booster = GBDT(cfg, ds, create_objective("binary", cfg))
        # tree 0's plain rebuild needs a learner in the initial CEGB state
        fresh = SerialTreeLearner(ds, cfg, booster.device)
    finally:
        os.remove(fname)
        os.rmdir(tmp)
    learner = booster.learner
    label = torch.as_tensor(y, device=booster.device)
    r = run_iterations(booster, FORCED_ITERS, label)
    report_path("N", r, n)
    sched = [a.tolist() for a in learner.forced]
    log("  forced schedule (leaf, feature, threshold bin): %s; row width %d "
        "(%d paid-bit bytes)" % (list(zip(*sched)), learner.layout.W,
                                 learner.layout.bitbytes))
    for i, t in enumerate(booster.models):
        got = (list(t.split_feature_inner[:3]), list(t.threshold_in_bin[:3]),
               int(t.left_child[0]), int(t.right_child[0]))
        if got != (sched[1], sched[2], 1, 2):
            raise AssertionError("tree %d's first splits %s, forced %s"
                                 % (i, got, sched))
    log("  every tree's first three splits are the forced ones")
    want = paid_bits_host(booster, booster.train_bins(), F)
    got = learner.cegb_paid
    if not torch.equal(got, want):
        raise AssertionError("paid bits differ from the host recompute in "
                             "%d rows" % int((got != want).any(1).sum()))
    used = np.flatnonzero(learner.cegb_used)
    log("  paid bits equal to the recompute from the trees and the rows' "
        "leaves (%d of %d rows x features paid); features used %s"
        % (int(sum(int(((got >> b) & 1).sum()) for b in range(8))), n * F,
           used.tolist()))
    start = logloss(torch.full_like(label,
                                    booster.objective.boost_from_score(0)),
                    label)
    if not falls(r["losses"], start):
        raise AssertionError("train log loss %s" % r["losses"])
    raw = booster.predict(X_test, raw_score=True)
    check_predictions(booster, X, X_test, raw)
    check_tree0(booster, n, strict=False, learner=fresh)
    del fresh
    expect_leafwise_launches("N", r)
    profile_path(r, booster, profile)
    return r


def phase_pool(device, eps: dict, profile: bool) -> dict:
    """Path (O): (D)'s binned Epsilon-shaped rows (not binned again) with
    ``histogram_pool_size=125``: K LRU slots in place of the per-leaf
    cache; an evicted parent is rebuilt from its window by the histogram
    kernel.  Held to (D)'s first two trees with the JAX package's bounds
    for a pooled build (tests/test_hist_pool.py
    ``test_pooled_build_exact_mode_tight``)."""
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch.core.tree_learner import (arrays_from_tree,
                                                      route_binned)
    ds = eps["train"].handle
    n = ds.num_data
    cfg = Config(histogram_pool_size=POOL_MB, **EPSILON_PARAMS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    booster = GBDT(cfg, ds, create_objective("binary", cfg))
    learner = booster.learner
    label = torch.as_tensor(np.asarray(ds.metadata.label), device=device)
    r = run_iterations(booster, POOL_ITERS, label)
    peak = torch.cuda.max_memory_allocated()
    report_path("O", r, n)
    K, L = learner.hist_pool_slots, EPSILON_PARAMS["num_leaves"]
    misses = sum(r["misses"])
    log("  pool: %d slots of %d leaves, cache %.1f MB against the per-leaf "
        "cache's %.1f MB; peak device memory %.1f MB (path (D) %.1f MB); "
        "rebuilt parents per tree %s"
        % (K, L, hist_cache_bytes(learner, K) / 1e6,
           hist_cache_bytes(learner, L) / 1e6, peak / 1e6,
           eps["peak_bytes"] / 1e6, r["misses"]))
    if K != 32 or misses == 0:
        raise AssertionError("%d slots (want 32), %d rebuilds" % (K, misses))
    bins = booster.train_bins()
    fh = learner.feat_host
    for i, (a, b) in enumerate(zip(eps["models"], booster.models)):
        nl = a.num_leaves
        same = float(np.mean(a.split_feature_inner[:nl - 1]
                             == b.split_feature_inner[:nl - 1]))
        la = route_binned(bins, arrays_from_tree(a, ds), fh)
        lb = route_binned(bins, arrays_from_tree(b, ds), fh)
        rows = float((la == lb).double().mean())
        va, vb = np.sort(a.leaf_value[:nl]), np.sort(b.leaf_value[:nl])
        close = (b.num_leaves == nl
                 and np.allclose(vb, va, rtol=1e-4, atol=1e-5))
        log("  tree %d vs (D)'s: %.2f%% of split features, %.2f%% of the "
            "rows' leaves equal; sorted leaf values max|diff| %.3g"
            % (i, 100 * same, 100 * rows, float(np.abs(va - vb).max())))
        if not (same >= 0.98 and rows >= 0.98 and close):
            raise AssertionError("pooled tree %d differs from (D)'s" % i)
    expect_leafwise_launches("O", r, rebuilt=misses)
    profile_path(r, booster, profile)
    r["peak_bytes"], r["cache_bytes"] = peak, hist_cache_bytes(learner, K)
    return r


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


def graph_ms(fn, reps: int = 5) -> tuple:
    """Device time of ``fn()`` without the host's share, for work of more
    kernels than the launch queue holds (where ``queued_ms`` cannot queue
    them behind a sleep): ``fn`` captured once in a CUDA graph, then the
    median event time of ``reps`` replays; returns (ms, the graph's
    output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return cuda_ms(graph.replay, reps=reps, warmup=1), out


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


def hist_index_add_ms(rows, voff, F, B, count, quantized=False,
                      bpc: int = 1) -> tuple:
    """One ``index_add_`` (f32, or int64 when ``quantized``) computing the
    histogram of rows [0, count) of the row store, over flattened
    (feature, bin) ids: its event time and its queued device time."""
    from lightgbm_tpu_torch.core import histogram as H
    bins, vals = H.rows_split(rows[:count], F, voff, bpc)
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
    # root window (path (F) grows quantized trees leaf-wise)
    route, words = split_routes(B, np.random.RandomState(7))["numerical"]
    scal = scal_row(0, n, route, words, 1)
    skw = dict(num_features=F, num_bins=B, voff=voff, quantized=True)
    work = rows.clone()
    ms = cuda_ms(lambda: P.partition_hist(work, scal, **skw))
    dev = queued_ms(lambda: P.partition_hist(work, scal, **skw))
    plain = cuda_ms(lambda: P.partition_hist_plain(rows, scal, **skw),
                    reps=20)
    dst = torch.empty((n, rows.shape[1]), dtype=torch.uint8,
                      device=rows.device)
    copy = cuda_ms(lambda: dst.copy_(rows[:n]))
    copy_dev = queued_ms(lambda: dst.copy_(rows[:n]))
    del dst
    b_ms, b_by = bound(2.0 * n * rows.shape[1], 2.0 * (n / 2) * F)
    log("  quantized split pass %8d rows: kernel %.4f ms (queued %.4f), "
        "bound %.4f ms (%s), plain %.4f ms, copy of the window %.4f ms "
        "(queued %.4f), no single library call"
        % (n, ms, dev, b_ms, b_by, plain, copy, copy_dev))
    out["partition_q"] = dict(ms=ms, queued_ms=dev, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by, copy_ms=copy,
                              copy_queued_ms=copy_dev)
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
    ap.add_argument("--ltr-rows", type=int, default=LTR_ROWS,
                    help="training rows of path (H) (2270296 is the "
                         "published MS LTR size)")
    ap.add_argument("--allstate-rows", type=int, default=ALLSTATE_ROWS,
                    help="training rows of path (I) (13184290 is the "
                         "published Allstate size)")
    ap.add_argument("--expo-rows", type=int, default=EXPO_ROWS,
                    help="training rows of paths (J) and (J2) (11000000 is "
                         "the published Expo size)")
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
    log("  (F) regression on (A)'s features: bagging_fraction=0.8, "
        "bagging_freq=5, feature_fraction=0.9, hist_precision=quantized, "
        "leaf-wise, %d iterations" % args.iters)
    paths["F"] = phase_regression_bagging(device, data, ds, args.iters,
                                          args.profile)
    torch.cuda.empty_cache()
    log("  (G) multiclass softmax (num_class=%d) on (A)'s features, "
        "lightgbm_tpu_torch.train with the held-out rows as a validation set,"
        " %d iterations" % (NUM_CLASS, args.iters))
    paths["G"] = phase_multiclass(device, data, ds, args.iters, args.profile)
    torch.cuda.empty_cache()
    log("  (K) GOSS on (A)'s binned rows: top_rate=0.2, other_rate=0.1, %d "
        "iterations (the first 10 without sampling)" % GOSS_ITERS)
    paths["K"] = phase_goss(device, data, ds, args.profile)
    torch.cuda.empty_cache()
    log("  (L) DART on (A)'s binned rows at its defaults, "
        "lightgbm_tpu_torch.train with the held-out rows as a validation "
        "set")
    paths["L"] = phase_dart(device, data, ds, args.profile)
    torch.cuda.empty_cache()
    log("  (M) random forest on (A)'s binned rows: bagging_fraction=0.632, "
        "bagging_freq=1, feature_fraction=0.8, %d iterations" % RF_ITERS)
    paths["M"] = phase_rf(device, data, ds, args.profile)
    torch.cuda.empty_cache()
    log("  (N) forced splits + CEGB on (A)'s binned rows, leaf-wise, exact, "
        "%d iterations" % FORCED_ITERS)
    paths["N"] = phase_forced_cegb(device, data, ds, args.profile)
    torch.cuda.empty_cache()
    del data, ds
    log("  (D) Epsilon-shaped, lightgbm_tpu_torch.train with a validation "
        "set: %d + %d rows x %d features, max_bin=255, num_leaves=255, %d "
        "iterations" % (nw, args.widef_test_rows, WIDE_F, args.iters))
    paths["D"] = phase_epsilon(device, nw, args.widef_test_rows, args.iters,
                               args.profile)
    torch.cuda.empty_cache()
    log("  (O) histogram pool on (D)'s binned rows: histogram_pool_size=%d, "
        "%d iterations" % (POOL_MB, POOL_ITERS))
    paths["O"] = phase_pool(device, paths["D"], args.profile)
    del paths["D"]["train"], paths["D"]["models"]
    torch.cuda.empty_cache()
    log("  (H) lambdarank, MS LTR-shaped: %d rows x %d features, metric=ndcg,"
        " eval_at=1,3,5,10, max_bin=255, num_leaves=255, %d iterations"
        % (args.ltr_rows, LTR_F, args.iters))
    paths["H"] = phase_lambdarank(device, args.ltr_rows, args.iters,
                                  args.profile)
    torch.cuda.empty_cache()
    log("  (I) EFB, Allstate-shaped sparse data from CSR, "
        "lightgbm_tpu_torch.train with a validation set: %d + %d rows x %d "
        "features, (D)'s settings, %d iterations"
        % (args.allstate_rows, ALLSTATE_TEST_ROWS, ALLSTATE_F, args.iters))
    paths["I"] = phase_allstate(device, args.allstate_rows,
                                ALLSTATE_TEST_ROWS, args.iters, args.profile)
    torch.cuda.empty_cache()
    log("  (J) categorical features, Expo-shaped: %d + %d rows x %d columns "
        "(%d categorical), (D)'s settings, %d iterations"
        % (args.expo_rows, EXPO_TEST_ROWS, len(EXPO_COLUMNS), len(EXPO_CATS),
           args.iters))
    paths["J"], expo_sets = phase_expo(device, args.expo_rows,
                                       EXPO_TEST_ROWS, args.iters,
                                       args.profile)
    torch.cuda.empty_cache()
    log("  (J2) (J)'s binned data: tree_grow_mode=level, "
        "hist_precision=quantized, monotone +1 on DepTime, extra_trees, "
        "max_cat_to_onehot=8, %d iterations" % J2_ITERS)
    paths["J2"] = phase_expo_variants(device, expo_sets, J2_ITERS,
                                      args.profile)
    del expo_sets
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
             max_abs_err=hist_err_max, **launches("histogram", "ABCGHIJ"),
             groups_root=paths["I"]["times"]["histogram"],
             expo_root=paths["J"]["times"]["histogram"],
             **times["histogram"]),
        dict(name="partition", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:1130",
             max_abs_err=split_err_max, **launches("partition", "ABCFGHIJ"),
             unfold_launches=paths["I"]["routes"]["partition"]["unfold"],
             categorical_launches=paths["J"]["routes"]["partition"][
                 "categorical"],
             unfold_root=paths["I"]["times"]["split"],
             categorical_root=paths["J"]["times"]["split"],
             quantized_launches=launches("partition", "F")["launches"],
             quantized_ms=times["partition_q"]["ms"],
             quantized_queued_ms=times["partition_q"]["queued_ms"],
             quantized_plain_ms=times["partition_q"]["plain_ms"],
             quantized_bound_ms=times["partition_q"]["bound_ms"],
             quantized_copy_ms=times["partition_q"]["copy_ms"],
             quantized_copy_queued_ms=times["partition_q"]["copy_queued_ms"],
             **times["partition"]),
        dict(name="histogram_int", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram_int.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             also_replaces="lightgbm_tpu/core/partition.py:1080",
             max_abs_err=hist_int_err, **launches("histogram_int"),
             expo_root=paths["J2"]["times"]["histogram"],
             **times["histogram_int"]),
        dict(name="partition_level", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition_level.cu",
             replaces="lightgbm_tpu/core/partition.py:1191",
             max_abs_err=level_err_max, **launches("partition_level"),
             categorical_launches=paths["J2"]["routes"]["partition_level"][
                 "categorical"],
             categorical_windows=paths["J2"]["routes"]["partition_level"][
                 "categorical_windows"],
             categorical_level=paths["J2"]["times"]["split"],
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
