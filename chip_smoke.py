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
   exact and quantized; the single-window kernel with the feature window
   (the scal row's trailing ``hist_feature_begin``, a feature-parallel
   rank's block: the histogram over columns [0, 14) and [14, 28) of 28,
   over the same window sizes and routes, and over [1000, 2000) of 2000),
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
   softmax (``multiclass``, the reference's multiclass example), 3
   iterations, on (A)'s
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
   categorical features at the Expo shape, 3 iterations (the reference's
   Expo row, 11M +
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
   rtol 1e-4); (P) prediction on (A)'s data with (A)'s trees each repeated
   100 times (500 trees at 5 iterations): the f32 regime over the training
   rows, the f64 regime on 511 rows, the binned path over (A)'s row store,
   ``pred_leaf`` on 65,536 rows, prediction early stop (freq 10, margin
   4.0) and the bf16 tier, each timed with its peak device memory; the
   card equal to the port's CPU run bit for bit (within 1e-12 for f64),
   the f32 scores within (T + 1) * 2**-24 * sum|v| of the f64
   ``Tree.predict`` sum, raw equal to binned on every training row, the
   leaves equal to ``Tree.predict_leaf_index`` and the bf16 tier's to the
   exact tier's; (Q) SHAP contributions of (A)'s model on 65,536 held-out
   rows (raw) and 65,536 training rows (binned): within rtol 1e-12 of the
   CPU run and of the host ``Tree.predict_contrib``, every row summing to
   its f64 raw score within 1e-9, binned equal to raw bit for bit; (R)
   checkpoint and resume on (A)'s bins into ``build/ckpt/``: GBDT with
   bagging and ``feature_fraction``, 4 iterations resumed from 2, and DART
   at (L)'s settings, 6 iterations resumed from 4, each equal to the
   uninterrupted run in model text and train score bytes, with the
   checkpoint's size and write and read seconds, and ``rollback_one_iter``
   after a 5th GBDT iteration giving back the 4-iteration score bytes;
   every path's ``predict`` is held to the port's CPU run bit for bit and
   to ``Tree.predict`` within that f32 bound; (E) ``build_histogram``
   (kernel #5's caller) over 1,048,576 rows x 28 features; (S) the CLI
   from text files (``python -m lightgbm_tpu_torch``'s ``Application``,
   no pandas on the card): (S1) (A)'s task written to a CSV of 1,048,576
   rows x 28 features and a label, each value in
   millionths in the fixed decimal form ``sDD.DDDDDD`` (so every correctly
   rounding parser reads it exactly), with a ``.weight`` side file and the
   held-out tenth as a validation file, trained by ``task=train``
   (``metric=auc``, (A)'s settings, 5 iterations): the loaded dataset
   byte-equal to ``BinnedDataset.from_matrix`` of the file's values (bin
   mappers, packed store, labels, weights, raw values), the model's trees
   equal to ``lightgbm_tpu_torch.train``'s on that matrix, one root
   histogram per tree and one split pass per split, and the kernels held
   to their plain versions on the CLI's row store (a numerical route);
   (S2) the file loaded one-shot, with ``data_chunk_rows=65536`` and with
   ``two_round``, one after another, each in a process of its own: each
   byte-equal to (S1)'s dataset, with its seconds and its peak resident
   set (sampled every 10 ms); (S3) ``task=predict`` on
   the validation file equal to ``Booster.predict`` within the ``%g``
   print, ``task=convert_model`` built with ``g++`` equal to ``predict``
   on 1,000 rows to rtol 1e-10, and ``task=refit`` on the training file
   (the same trees, held-out AUC > 0.75), none of which launches a kernel;
   (S4) the reference's binary, regression, multiclass and lambdarank
   examples and the LibSVM ``sparse_binary`` override through the CLI at
   ``test_parity.py``'s iteration counts, each within its windows around
   the reference CLI's metrics (``tests/data/golden_metrics.json``), one
   root histogram per tree and one split pass per split; (T) the C ABI:
   ``lib_lightgbm_tpu_torch.so`` (built by ``capi_build`` with ``gcc``
   into ``build/capi``) loaded with ctypes in this process, (A)'s rows as
   f64 row-major with f32 labels and the held-out rows as a validation
   set through ``LGBM_DatasetCreateFromMat``, (A)'s parameters, 5
   ``LGBM_BoosterUpdateOneIter``, ``LGBM_BoosterGetEval``, the model
   string size-then-fill, ``LGBM_BoosterPredictForMat`` (normal and raw)
   and ``LGBM_BoosterPredictForCSR`` on 1,000 rows: the model text
   byte-equal to ``lightgbm_tpu_torch.train``'s on the same data in the
   same run, the predictions equal to ``Booster.predict``'s to the last
   bit, one root histogram per tree and one split pass per split, and
   s/iteration beside ``train()``'s; (T2) a second C booster with
   ``tree_grow_mode=level hist_precision=quantized``: the integer root
   histogram and the level pass, its model equal to ``train()``'s; (U)
   preemption and the watchdog: ``train()`` at (A)'s shape with
   ``preemption_checkpoint``, ``watchdog_timeout_s=120`` and a checkpoint
   prefix under ``build/``, SIGTERM sent to this process after iteration
   2: ``TrainingPreempted`` and the emergency checkpoint (its write
   seconds and bytes); the same call resumed to 5 iterations with (T)'s
   trees and no watchdog stall; the CLI on ``tests/data``'s binary
   example with ``preemption_checkpoint=true snapshot_freq=1`` in a child
   process sent SIGTERM once its first checkpoint exists, which exits 75,
   and the same command again resuming to the uninterrupted CLI run's
   trees; (V) the parallel tree learners (``lightgbm_tpu_torch.parallel``)
   at (A)'s shape and settings: (V1) ``DataParallelTreeLearner``,
   ``FeatureParallelTreeLearner``, ``VotingParallelTreeLearner`` and
   ``PartitionedDataParallelTreeLearner`` built directly on a one-rank
   NCCL group (the factory gives the serial learner there) and trained
   through ``GBDT`` on (A)'s bins: each model's trees byte-equal to (A)'s,
   one root histogram per tree and one split pass per split, the comm's
   calls and bytes per split; (V2) two processes of a gloo group, both on
   the one card (NCCL cannot put two ranks on one GPU), each binning (A)'s
   task and training 2 iterations through the factory ``tree_learner=data``,
   ``feature``, ``voting`` (``top_k=20``: every feature elected) and
   ``data`` with ``hist_precision=quantized``: both ranks' models equal,
   ``feature``'s trees equal to (A)'s first two (it sums nothing across
   the ranks) or, where they are not, the first difference printed beside
   the count of features whose best split differs bitwise when (A)'s root
   histogram is scanned whole and in the ranks' two blocks (alone and as a
   batch of two leaves),
   ``data``'s, ``voting``'s and such a ``feature`` run's tree 0 equal to
   (A)'s up to a split whose
   two gains differ by less than 1e-6 relative to the terms an f32 gain is
   a difference of (the split leaf's G^2/H, plus the gain) and their train
   log loss
   within 2e-4 relative of (A)'s after as many iterations
   (``tests/test_parallel.py:151-152``), the quantized run's within 5e-2 of
   (C)'s, ``sharded_predict`` equal to one
   rank's predictor bit for bit, only rank 0 writing model files, and
   every ``feature`` split pass launched with the feature window; each
   run prints its s/iteration, train log loss, held-out AUC, the comm's
   calls and bytes per split and each rank's launches; the ranks are
   killed past a join deadline; (W) telemetry and the serving tier
   (``lightgbm_tpu_torch.obs``, ``lightgbm_tpu_torch.serving``): (W1) (A)'s
   task through ``lightgbm_tpu_torch.train`` with ``telemetry_out`` and
   ``metrics_port`` (a free port) into ``build/serve/``: the summary's
   ``tree_kernel_launches`` equal to the split-pass kernels' own launch
   counts and to the trees' splits, every JSONL event schema-valid, the
   summary's device memory peak equal to ``torch.cuda.max_memory_allocated``,
   ``/metrics`` and ``/healthz`` answering 200 during training, the trees
   equal to (A)'s; (W2) ``lightgbm_tpu_torch.serve`` with (A)'s trees each
   repeated 100 times (the 500-tree Higgs model) resident as ``higgs`` and
   (C)'s trees registered beside it under a residency budget of ``higgs``'s
   bytes plus half of (C)'s (one eviction of ``higgs``; (C) served, equal to
   its ``FusedPredictor``, and unregistered; ``higgs`` admitted again by the
   first request of the traffic), then 8 client threads submitting 262,144
   held-out and training rows, raw and binned, in requests of 1-4,096 rows
   (sizes from a seeded RNG, 4 in flight a client), with ``swap`` to (B)'s
   trees (repeated alike) under load once two fifths of the responses are
   back, the last two fifths of the requests submitted after it returned:
   every response equal to one ``FusedPredictor`` call over its rows, of the
   old or the new model, the new one for every request submitted after
   ``swap`` returned; zero drops and failures, one eviction, one
   re-admission, one swap, the miss gauge (``obs.recompile``) flat outside
   the warm-up and the swap; then 64 single-row requests through the
   compiled fast path, equal to the new model's ``FusedPredictor``; it
   prints rows/s, p50/p99 request latency, batches, mean batch rows and the
   peak device memory; (W3) CLI ``task=serve`` and ``task=predict`` on a
   CSV of 20,000 held-out rows: the outputs equal line for line; (X) the
   kernel planner, MFU, alerts and captures, the online loop and
   compaction (``phase_path_x``, the kernels' launch counts read around
   it): (X1) ``resolve`` at (A)'s and (C)'s shape classes gives the
   analytic plan, ``plan.autotune.run_sweep`` tunes both (4 reps, CUDA
   events: a 15-leaf tree of a synthetic set of the class's shape under
   each split-pass block size and integer block target, a walk of 128
   trees over 524,288 rows under each walk budget) and writes the cache
   into ``build/plan``; under every candidate pinned, (A)'s and (C)'s
   first trees equal the analytic plan's (model text, every split pass's
   left counts, the final row store) and (A)'s predictions are equal;
   ``train()`` with ``plan_cache`` equals (A) with provenance ``tuned`` and
   no fallback; a corrupt cache gives one warning, the counter and the
   analytic plan; (X2) (W1)'s summary carries ``mfu``, ``device_util``,
   ``est_bytes`` and ``est_macs`` (``obs/mfu.py``), 0 < ``device_util`` <=
   1 equal to ``est_bytes / wall / 3.35e12``; (X3) ``serve`` with
   ``alert_rules`` (a p99 rule of 1 s) over the Higgs model, warmed: the
   swap to (B)'s trees x300 without warm-up breaks it (``/alerts``
   firing), and it resolves once the traffic stops; ``/debug/profile
   ?seconds=2`` during a ``train()`` writes a Chrome trace naming
   ``hist_seg_kernel``, ``part_count_kernel`` and ``part_scatter_kernel``;
   two forced watchdog stalls fire the flight recorder once; (X4)
   ``serve_and_train`` of (A)'s task trained on 524,288 rows for 10
   iterations, 8 client threads, the other 524,288 rows as 4 windows
   (``online_min_rows=131072``, ``online_rounds=5``, the third window
   refit, the last with feature 0 shifted by 4 and served before it is
   ingested): at least 3 generations, no drop, every response equal to a
   generation live while it was in flight, each extended generation
   byte-equal to checkpoint-resume from its boundary on its window,
   ``rows_behind`` 0 after each publish, the last trigger ``drift``,
   latency p50/p99; (X5) ``compact_booster`` of the Higgs model
   (``leaf_codes=255``): on 262,144 held-out rows ``max_score_delta`` at
   most the declared bound, the AUC delta and the reductions, the
   compacted generation swapped into (X3)'s server under load, its
   responses within the f32 bound of its CPU predictions;
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
column, routed by a bitset or histogrammed a feature window), and the last
line ``{"ok": true, "device":
{...}}``.  Without CUDA the script
exits with code 2 and prints no result.  ``--profile`` adds a
``torch.profiler`` table of one training iteration of each path, and for
(W2) the port's trace ranges (``obs.trace.annotate``: ``serve_dispatch``,
``tree_block_predict``) over a burst of 16 requests; on the
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
F32_U = 2.0 ** -24             # f32 unit roundoff (predict's f32 regime)
CONTRIB_RTOL = 1e-12          # f64 TreeSHAP, card vs CPU and vs the host
CONTRIB_SUM_ATOL = 1e-9       # phi rows vs the f64 raw score
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
    # the feature window (the scal row's trailing hist_feature_begin, a
    # feature-parallel rank's block): the histogram over columns [0, 14) or
    # [14, 28) while every row is routed on the whole store, exact and
    # integer
    B = 256
    for quantized in (False, True):
        rows, voff = make_store(n, 28, B, quantized=quantized, device=device,
                                seed=6)
        routes = split_routes(B, rng)
        for f0 in (0, 14):
            for wi, (wb, wc) in enumerate(windows):
                for name, (route, words) in routes.items():
                    scal = scal_row(wb, wc, route, words,
                                    (wi + len(name)) % 2) + [f0]
                    what = "%s [%d, %d) %s [%d, +%d)" % (
                        "int" if quantized else "exact", f0, f0 + 14, name,
                        wb, wc)
                    worst = max(worst, check_split(
                        rows, scal, F=14, B=B, voff=voff,
                        quantized=quantized, what=what))
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
                # the feature window [1000, 2000)
                worst = max(worst, check_split(
                    rows, scal + [F // 2], F=F // 2, B=B, voff=voff,
                    quantized=quantized,
                    what=what + " window [%d, %d)" % (F // 2, F)))
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
            "levels": levels, "busy_ms": busy_ms, "booster": booster,
            "losses": losses}


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


def cpu_twin(booster):
    """The same model on the CPU, loaded from its model text (which keeps
    every f64 leaf value): the port's own CPU run, for the card-vs-CPU bit
    checks."""
    from lightgbm_tpu_torch import GBDT
    twin = GBDT(booster.config, device="cpu")
    twin.load_model_from_string(booster.save_model_to_string())
    return twin


def host_sums(models, xs: np.ndarray, K: int):
    """Per class, the host trees' f64 sum of ``Tree.predict`` over the rows
    ``xs`` ([n, K]), and the f32 bound of a running sum of the same leaf
    values: (T + 1) * 2**-24 * sum_t |v_t| per row (the rounding of each
    leaf value to f32, and of each of the T adds, each below 2**-24 of a
    partial sum whose magnitude is at most sum_t |v_t|)."""
    per = [np.stack([t.predict(xs) for t in models[c::K]]) for c in range(K)]
    host = np.stack([p.sum(axis=0) for p in per], axis=1)
    bound = np.stack([(len(p) + 1) * F32_U * np.abs(p).sum(axis=0)
                      for p in per], axis=1)
    return host, bound


def check_predictions(booster, X, X_test, raw, k: int = 2000) -> None:
    """The card's predictions on ``k`` held-out rows (from 512 rows on the
    f32 regime: f32 rows, floored f32 thresholds, an f32 running sum in tree
    order) against the same model's run on the CPU, bit for bit, and against
    the host trees' ``Tree.predict`` (numpy, f64) on the f32-cast rows
    within the f32 bound of :func:`host_sums` (averaged over the iterations
    for ``average_output``); and the card's f32 train scores (accumulated
    through the binned routes) against ``predict`` on ``k`` training rows.
    ``raw`` is [n], or [n, K] for K classes."""
    K = booster.num_tree_per_iteration
    got = raw[:k].reshape(-1, K)
    cpu = cpu_twin(booster).predict(X_test[:k], raw_score=True).reshape(-1, K)
    if not np.array_equal(got, cpu):
        raise AssertionError("card predict vs the CPU run: %d of %d values "
                             "differ" % (int((got != cpu).sum()), got.size))
    xs = np.asarray(X_test[:k], np.float32).astype(np.float64)
    host, bound = host_sums(booster.models, xs, K)
    if booster.average_output:
        host, bound = host / (len(booster.models) // K), \
            bound / (len(booster.models) // K)
    err = np.abs(got - host)
    if not (err <= bound).all():
        raise AssertionError("card predict vs host Tree.predict: max|diff| "
                             "%.3g over its f32 bound in %d rows"
                             % (float(err.max()), int((err > bound).sum())))
    train = booster.train_score[:, :k].double().cpu().numpy().T
    err_t = float(np.abs(booster.predict(X[:k], raw_score=True).reshape(-1, K)
                         - train).max())
    if not err_t <= TRAIN_SCORE_ATOL:
        raise AssertionError("train score vs predict on training rows: "
                             "max|diff| %.3g > %.0e" % (err_t,
                                                       TRAIN_SCORE_ATOL))
    log("  predict on %d held-out rows: equal bit for bit to the CPU run; vs "
        "host Tree.predict max|diff| %.3g (f32 bound up to %.3g); train "
        "score vs predict on %d training rows: max|diff| %.3g"
        % (k, float(err.max()), float(bound.max()), k, err_t))


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
# (G)'s and (J)'s iterations: 5-class trees take ~6 s an iteration and 11M
# categorical rows ~3 s; 3 make room for path (X)
MULTICLASS_ITERS = 3
EXPO_ITERS = 3
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
                       categorical: bool = False,
                       numerical: bool = False) -> dict:
    """The kernels at a path's own shape, against their plain versions: the
    learner's row store (its bins, random gradients) through the root
    histogram (exact and integer), a split pass with the path's route (an
    EFB unfold of a bundled feature, a category bitset, or with
    ``numerical`` a threshold at the middle bin of feature 0) on a mid
    window,
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
    elif numerical:
        nb = int(fh["num_bin"][0])
        col = 0 if fh["group"] is None else int(fh["group"][0])
        route = (col, nb // 2, 0, 0, nb, 0, 0, 0, 0)
    else:
        fid = int(np.flatnonzero(fh["is_cat"] & (fh["num_bin"] > 16))[0])
        for b in np.flatnonzero(rng.rand(int(fh["num_bin"][fid])) < 0.5):
            words[b >> 5] |= 1 << (int(b) & 31)
        words = [w - (1 << 32) if w >= 1 << 31 else w for w in words]
        route = (fid, 0, 0, 0, int(fh["num_bin"][fid]), 0, 1, 0, 0)
    name = "unfold" if unfold else "numerical" if numerical else "cat"
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
    raw = booster.predict(X_test, raw_score=True)
    if not np.isfinite(raw).all():
        raise AssertionError("RF predict is not finite")
    log("  model text has average_output; predict against the mean of the "
        "%d trees' Tree.predict, and the train score (running mean):"
        % len(booster.models))
    check_predictions(booster, X, X_test, raw)
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


PREDICT_REPEAT = 100          # (P): each of (A)'s 5 trees 100 times
PREDICT_SMALL_ROWS = 511      # the f64 regime (below 512 rows)
LEAF_ROWS = 65_536
EARLY_STOP = dict(pred_early_stop=True, pred_early_stop_freq=10,
                  pred_early_stop_margin=4.0)
CONTRIB_ROWS = 65_536
CKPT_DIR = os.path.join("build", "ckpt")


def timed(fn):
    """(result, seconds, peak device bytes) of one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            torch.cuda.max_memory_allocated() - base)


def repeated_model(booster, repeat: int, device, **params):
    """A GBDT on ``device`` holding ``booster``'s trees, each repeated
    ``repeat`` times in order (loaded from the model text), with
    ``params`` over the booster's own."""
    from lightgbm_tpu_torch import Config, GBDT
    big = GBDT(Config(dict(booster.config.raw_params, **params)),
               device=device)
    big.load_model_from_string(booster.save_model_to_string())
    big.models = [t for t in big.models for _ in range(repeat)]
    big._invalidate_predict_cache()
    return big


def phase_predict(device, data, ds, booster) -> dict:
    """Path (P): every prediction path on (A)'s data, with (A)'s 5 trees
    each repeated 100 times in order (a 500-tree ensemble, the size of the
    500-iteration Higgs model of docs/Experiments.rst): the f32 regime on
    the training rows, the f64 regime on 511 rows, the binned path on (A)'s
    row store, ``pred_leaf``, prediction early stop and the bf16 tier."""
    from lightgbm_tpu_torch.core.predict import StackedTrees
    X, _, X_test, _ = data
    n = len(X)
    big = repeated_model(booster, PREDICT_REPEAT, device)
    T = len(big.models)
    out = {}

    def report(name, rows, secs, peak):
        out[name] = dict(rows=rows, s=secs, rows_per_s=rows / secs,
                         peak_bytes=peak)
        log("  %-22s %9d rows  %.4f s  %.4g rows/s  peak %.1f MiB"
            % (name, rows, secs, rows / secs, peak / 2 ** 20))

    _, s0, _ = timed(lambda: big.predict(X[:2048], raw_score=True))
    log("  %d trees stacked on the card and first call in %.3f s"
        % (T, s0))
    raw, s, peak = timed(lambda: big.predict(X, raw_score=True))
    report("f32 raw", n, s, peak)
    small, s, peak = timed(lambda: big.predict(
        X_test[:PREDICT_SMALL_ROWS], raw_score=True))
    report("f64 raw (511 rows)", PREDICT_SMALL_ROWS, s, peak)
    big.raw_predict_binned(ds)      # stacks the binned predictor
    binned, s, peak = timed(lambda: big.raw_predict_binned(ds)[0])
    report("binned", n, s, peak)
    leaves, s, peak = timed(lambda: big.predict_leaf_index(X[:LEAF_ROWS]))
    report("pred_leaf", LEAF_ROWS, s, peak)
    es = repeated_model(booster, PREDICT_REPEAT, device, **EARLY_STOP)
    es.predict(X[:2048], raw_score=True)
    es_raw, s, peak = timed(lambda: es.predict(X, raw_score=True))
    report("pred_early_stop", n, s, peak)
    stopped = float(np.mean(es_raw != raw))
    log("  early stop (freq 10, margin 4.0) ended %.4f of the rows before "
        "the last tree" % stopped)
    big.predict(X[:2048], raw_score=True, precision="bf16")
    bf16, s, peak = timed(lambda: big.predict(X, raw_score=True,
                                              precision="bf16"))
    report("bf16", n, s, peak)
    # checks: the card against its CPU run, the host trees and itself
    cpu = repeated_model(booster, PREDICT_REPEAT, "cpu")
    k = 2000
    for name, card, twin in (
            ("f32", raw[:k], cpu.predict(X[:k], raw_score=True)),
            ("f64", small, cpu.predict(X_test[:PREDICT_SMALL_ROWS],
                                       raw_score=True)),
            ("early stop", es_raw[:k], repeated_model(
                booster, PREDICT_REPEAT, "cpu", **EARLY_STOP).predict(
                    X[:k], raw_score=True)),
            ("bf16", bf16[:k], cpu.predict(X[:k], raw_score=True,
                                           precision="bf16"))):
        if name == "f64":
            ok = np.allclose(card, twin, rtol=0, atol=1e-12)
        else:
            ok = np.array_equal(card, twin)
        if not ok:
            raise AssertionError("(P) %s scores: card vs CPU run differ by "
                                 "%.3g" % (name, np.abs(card - twin).max()))
    log("  card vs the port's CPU run on %d rows: f32, early stop and bf16 "
        "bit for bit, f64 (%d rows) within 1e-12" % (k, PREDICT_SMALL_ROWS))
    # the host sums of the 5 distinct trees, each counted 100 times
    xs = X[:k].astype(np.float64)
    base = [t.predict(xs) for t in booster.models]
    per = np.stack([base[i // PREDICT_REPEAT] for i in range(T)])
    host = per.sum(axis=0)
    bound = (T + 1) * F32_U * np.abs(per).sum(axis=0)
    err = np.abs(raw[:k] - host)
    if not (err <= bound).all():
        raise AssertionError("(P) f32 scores vs f64 Tree.predict: max|diff| "
                             "%.3g over the bound" % float(err.max()))
    log("  f32 scores vs the f64 Tree.predict sum of 500 trees: max|diff| "
        "%.3g, within (T + 1) * 2**-24 * sum|v| (up to %.3g)"
        % (float(err.max()), float(bound.max())))
    if not np.array_equal(raw, binned):
        raise AssertionError("(P) raw vs binned scores differ in %d training "
                             "rows" % int((raw != binned).sum()))
    log("  raw and binned scores bit-equal on the %d training rows" % n)
    xl = X[:LEAF_ROWS].astype(np.float64)
    distinct = [t.predict_leaf_index(xl) for t in booster.models]
    want = np.stack([distinct[i // PREDICT_REPEAT] for i in range(T)], 1)
    if not np.array_equal(leaves, want):
        raise AssertionError("(P) pred_leaf vs Tree.predict_leaf_index: %d "
                             "differ" % int((leaves != want).sum()))
    bf_leaves = big._fused_predictor(big.models, 0, T, 0,
                                     precision="bf16")(X[:LEAF_ROWS],
                                                       want_leaf=True)
    if not np.array_equal(bf_leaves, leaves):
        raise AssertionError("(P) the bf16 tier's leaves differ")
    err_bf = float(np.abs(bf16 - raw).max())
    log("  pred_leaf equal to Tree.predict_leaf_index on %d rows x %d trees;"
        " the bf16 tier in the same leaves, its scores within %.3g of the "
        "exact tier's" % (LEAF_ROWS, T, err_bf))
    if not (np.isfinite(raw).all() and stopped > 0):
        raise AssertionError("(P) scores not finite, or early stop ended "
                             "%.4f of the rows" % stopped)
    st = StackedTrees(booster.models, device)
    out.update(trees=T, depth=int(st.depths.max()), stopped_share=stopped,
               bf16_max_abs_err=err_bf, f32_max_abs_err=float(err.max()))
    return out


def phase_contrib(device, data, ds, booster) -> dict:
    """Path (Q): SHAP contributions of (A)'s 5-tree model on the card:
    65,536 held-out rows through the raw path and 65,536 training rows
    through the binned path."""
    from lightgbm_tpu_torch.core.predict import StackedTrees
    X, _, X_test, _ = data
    rows = CONTRIB_ROWS
    ncol = booster.max_feature_idx + 2
    sub = ds.subset(np.arange(rows))
    booster.predict_contrib(X_test[:8])          # harvest and stack
    phi, s, peak = timed(lambda: booster.predict_contrib(X_test[:rows]))
    out = {"raw": dict(rows=rows, s=s, rows_per_s=rows / s,
                       peak_bytes=peak)}
    log("  raw:    %d rows x %d trees (depth up to %d) in %.3f s, %.4g rows/s,"
        " peak %.1f MiB" % (rows, len(booster.models),
                            int(StackedTrees(booster.models, device)
                                .depths.max()), s, rows / s,
                            peak / 2 ** 20))
    phi_b, s, peak = timed(lambda: booster.predict_contrib_binned(sub))
    out["binned"] = dict(rows=rows, s=s, rows_per_s=rows / s,
                         peak_bytes=peak)
    log("  binned: %d training rows in %.3f s, %.4g rows/s, peak %.1f MiB"
        % (rows, s, rows / s, peak / 2 ** 20))
    cpu = cpu_twin(booster)
    want = cpu.predict_contrib(X_test[:256])
    if not np.allclose(phi[:256], want, rtol=CONTRIB_RTOL, atol=1e-15):
        raise AssertionError("(Q) card vs CPU contributions differ by %.3g"
                             % float(np.abs(phi[:256] - want).max()))
    xs = np.asarray(X_test[:16], np.float32)
    host = sum(t.predict_contrib(xs, ncol) for t in booster.models)
    if not np.allclose(phi[:16], host, rtol=CONTRIB_RTOL, atol=1e-15):
        raise AssertionError("(Q) card vs host Tree.predict_contrib differ "
                             "by %.3g" % float(np.abs(phi[:16] - host).max()))
    raw64 = StackedTrees(booster.models, device).predict(
        np.asarray(X_test[:rows], np.float32), torch.float64)
    err_sum = float(np.abs(phi.sum(axis=1) - raw64).max())
    if not (np.isfinite(phi).all() and err_sum <= CONTRIB_SUM_ATOL):
        raise AssertionError("(Q) rows sum to the raw score within %.3g"
                             % err_sum)
    phi_r = booster.predict_contrib(X[:rows])
    if not np.array_equal(phi_b, phi_r):
        raise AssertionError("(Q) binned vs raw contributions differ in %d "
                             "values" % int((phi_b != phi_r).sum()))
    log("  card vs the CPU run on 256 rows and vs host Tree.predict_contrib "
        "on 16 rows within rtol %.0e; rows sum to the f64 raw score within "
        "%.3g; binned equal to raw bit for bit on %d training rows"
        % (CONTRIB_RTOL, err_sum, rows))
    out["sum_max_abs_err"] = err_sum
    return out


def phase_checkpoint(device, data, ds) -> dict:
    """Path (R): checkpoint and resume on (A)'s bins.  GBDT with
    ``bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.9``, 4
    iterations, ``snapshot_freq=2`` into ``build/ckpt/``, resumed by a
    fresh booster from iteration 2; DART at (L)'s settings, 6 iterations,
    resumed from iteration 4; ``rollback_one_iter`` after a 5th GBDT
    iteration."""
    import shutil
    from lightgbm_tpu_torch import Config, create_objective
    from lightgbm_tpu_torch import checkpoint as ckpt
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.boosting import create_boosting
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    out = {"trees": 0}
    D.reset_launches()

    def make(params, iters):
        cfg = Config(dict(HIGGS_PARAMS, snapshot_freq=2,
                          num_iterations=iters, **params))
        return create_boosting(cfg.boosting, cfg, ds,
                               create_objective("binary", cfg))

    def head(b):
        text = b.save_model_to_string()
        return text[:text.index("\nparameters:")]

    cases = (("gbdt", dict(bagging_fraction=0.8, bagging_freq=1,
                           feature_fraction=0.9), 4, 2),
             ("dart", dict(boosting="dart"), 6, 4))
    for name, params, iters, at in cases:
        prefix = os.path.join(CKPT_DIR, name)
        full = make(params, iters)
        full.train(snapshot_out=prefix)
        out["trees"] += len(full.models)
        path = ckpt.checkpoint_path(prefix, at)
        size = os.path.getsize(path)
        res = make(params, iters)
        t = time.perf_counter()
        state = ckpt.load_checkpoint(path)
        ckpt.restore_state(res, state + (path,))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        ckpt.save_checkpoint(res, os.path.join(CKPT_DIR, name + "_again"))
        write_s = time.perf_counter() - t
        res.train()
        out["trees"] += len(res.models) - at
        same_text = head(res) == head(full)
        same_score = (res.train_score.cpu().numpy().tobytes()
                      == full.train_score.cpu().numpy().tobytes())
        log("  %s: %d iterations, resumed from iteration %d: model text %s,"
            " train_score bytes %s; checkpoint %d bytes, written in %.3f s,"
            " read and restored in %.3f s"
            % (name, iters, at, "equal" if same_text else "DIFFERENT",
               "equal" if same_score else "DIFFERENT", size, write_s, read_s))
        if not (same_text and same_score):
            raise AssertionError("(R) %s: the resumed run differs from the "
                                 "uninterrupted one" % name)
        out[name] = dict(bytes=size, write_s=write_s, read_s=read_s)
        if name == "gbdt":
            four = full.train_score.cpu().numpy().tobytes()
            full.train_one_iter()
            out["trees"] += 1
            full.rollback_one_iter()
            if full.train_score.cpu().numpy().tobytes() != four \
                    or full.current_iteration != iters:
                raise AssertionError("(R) rollback_one_iter did not give "
                                     "back the 4-iteration train score")
            log("  gbdt: a 5th iteration and rollback_one_iter give back "
                "the 4-iteration train_score bytes")
    out["launches"] = D.launches()
    log("  launches %s" % out["launches"])
    for k in ("histogram", "partition"):
        if out["launches"][k] == 0:
            raise AssertionError("(R) %s was not launched" % k)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


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


# ------------------------------- path (V): the parallel tree learners ----

PARALLEL_DIR = os.path.join("build", "parallel")
PARALLEL_DEADLINE_S = 600.0   # (V2)'s ranks are killed past this
TRAIN_LOSS_RTOL = 2e-4        # tests/test_parallel.py:151-152 (sum order)
QUANT_LOSS_RTOL = 5e-2        # tests/test_hist_quant.py:272-297's band
# (V2)'s iterations: two processes time-slice the one card, so an iteration
# takes seconds (2.5-4.5 s at (A)'s rows on the H100); 2 keep (V) near its
# time and the width whole, and make room for path (X)
V2_ITERS = 2
# (V2): tree_learner and its extra parameters, one run each
V2_RUNS = (("data", {}), ("feature", {}), ("voting", {"top_k": 20}),
           ("data_quantized", {"hist_precision": "quantized"}))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def comm_per_split(summary: dict, splits: int) -> dict:
    """Calls and bytes per split of each collective kind."""
    return {k: {"calls": v["calls"] / max(splits, 1),
                "bytes": v["bytes"] / max(splits, 1)}
            for k, v in summary.items()}


def tree_blocks(text: str) -> list:
    """The ``Tree=k`` blocks of a model text, in order (without the blank
    line after the last)."""
    return [b.rstrip("\n") for b in
            text.split("end of trees")[0].split("\nTree=")[1:]]


def tree0_sequence(booster) -> list:
    """Tree 0's splits in the order they were made (split_sequence)."""
    t = booster.models[0]
    return split_sequence(t.split_feature_inner, t.threshold_in_bin,
                          t.left_child, t.right_child, t.split_gain,
                          t.num_leaves)


def tree0_split_terms(booster) -> list:
    """For each split of tree 0 of a leaf-wise binary booster, G^2 / (H +
    l2) of the leaf it split: the term its gain is a difference against
    (gain = GL^2/HL + GR^2/HR - G^2/H, without l1 or max_delta_step), from
    the node's value before the split (o = -G / (H + l2), held in tree 0
    with the shrinkage and the initial score) and its hessian sum."""
    t = booster.models[0]
    l2 = float(booster.config.lambda_l2)
    init = booster.objective.boost_from_score(0)
    out = []
    for i in range(t.num_leaves - 1):
        o = (float(t.internal_value[i]) - init) / booster.shrinkage_rate
        out.append(o * o * (float(t.internal_weight[i]) + l2))
    return out


def expect_tree0_up_to_tie(what: str, got: list, want: list,
                           terms: list) -> None:
    """``got``'s tree 0 (a split sequence) must be ``want``'s up to the
    first split whose two gains differ by less than SPLIT_GAIN_TIE_RTOL
    relative to the terms they are computed from (``terms``: the split
    leaf's G^2/H, plus the gain; an f32 gain resolves no finer than those,
    and another summation order rounds them differently)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a[:3] == b[:3]:
            continue
        rel = abs(a[3] - b[3]) / (terms[i] + max(abs(a[3]), abs(b[3])))
        if rel < SPLIT_GAIN_TIE_RTOL:
            log("  %s: tree 0 equal to (A)'s up to split %d, a near tie "
                "(gains %.9g vs %.9g of terms %.6g, rel %.2g)"
                % (what, i, a[3], b[3], terms[i], rel))
            return
        raise AssertionError("%s: tree 0 split %d %s, (A)'s %s"
                             % (what, i, a, b))
    if len(got) != len(want):
        raise AssertionError("%s: %d splits in tree 0, (A)'s %d"
                             % (what, len(got), len(want)))
    log("  %s: tree 0 equal to (A)'s split for split" % what)


def block_scan_differences(booster, d: int = 2) -> tuple:
    """The split scan of (A)'s root histogram on the card, whole and in
    ``d`` feature blocks (the scans of ``feature`` mode's ranks), alone and
    as a batch of two leaves (a split's children, scanned together): how
    many features' best splits differ bitwise in any field between the
    whole and the blocked scan, alone and batched, of how many.  Same
    histogram, same arithmetic: a difference comes from the tensor's shape
    alone."""
    from lightgbm_tpu_torch.core.histogram import histogram_rows
    from lightgbm_tpu_torch.core.split import (FeatureBest, FeatureInfo,
                                               per_feature_best_combined)
    from lightgbm_tpu_torch.core.tree_learner import fill_gradients
    lr = booster.learner
    n, dev = lr.num_data, booster.device
    score0 = torch.full((n,), booster.objective.boost_from_score(0),
                        dtype=torch.float32, device=dev)
    grad, hess = booster.objective.get_gradients(score0)
    rows = fill_gradients(lr.template, lr.layout, grad, hess)
    hist = histogram_rows(rows, lr.num_bins, 0, n,
                          num_features=lr.num_columns, voff=lr.layout.voff,
                          bpc=lr.layout.bpc, packed=lr.packed)
    F = hist.shape[0]
    c = F // d
    mask = torch.ones(F, dtype=torch.bool, device=dev)
    sg, sh = grad.sum(), hess.sum()
    cnt = torch.tensor(float(n), device=dev)
    counts = []
    for batch in (False, True):
        h, tot = hist, (sg, sh, cnt)
        if batch:
            # two leaves: the root's sums and their halves
            h = torch.stack([hist, hist * 0.5])
            tot = tuple(torch.stack([t, t * 0.5]) for t in tot)
        whole = per_feature_best_combined(h, lr.feat, mask, *tot, lr.params)
        parts = [per_feature_best_combined(
            h[..., i * c:(i + 1) * c, :, :],
            FeatureInfo(*[None if a is None else a[i * c:(i + 1) * c]
                          for a in lr.feat]), mask[i * c:(i + 1) * c],
            *tot, lr.params) for i in range(d)]
        differ = torch.zeros(F, dtype=torch.bool, device=dev)
        for name in FeatureBest._fields:
            w = getattr(whole, name)
            b = torch.cat([getattr(p, name) for p in parts],
                          dim=w.dim() - (2 if name == "cat_bitset" else 1))
            ne = w != b
            if name == "cat_bitset":
                ne = ne.any(-1)
            differ |= ne.reshape(-1, F).any(0)
        counts.append(int(differ.sum()))
    return counts[0], counts[1], F


def first_text_difference(got: str, want: str) -> str:
    """The first line of the trees where two model texts differ."""
    for k, (a, b) in enumerate(zip(tree_blocks(got), tree_blocks(want))):
        for la, lb in zip(a.splitlines(), b.splitlines()):
            if la != lb:
                return "tree %d: %r vs (A)'s %r" % (k, la[:160], lb[:160])
    return "none"


def phase_parallel_nccl(device, data, ds, iters: int, a_text: str) -> dict:
    """Path (V1): the four parallel learners built directly on a one-rank
    NCCL group (the factory would give the serial learner, as the JAX one
    does at d = 1), each trained through ``GBDT`` on (A)'s binned rows:
    every model's trees byte-equal to (A)'s, one root histogram per tree and
    one split pass per split (each over the whole feature window in
    ``feature`` mode), and the comm's calls and bytes per split."""
    import torch.distributed as dist

    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.parallel import (
        DataParallelTreeLearner, FeatureParallelTreeLearner,
        PartitionedDataParallelTreeLearner, VotingParallelTreeLearner)
    label = torch.as_tensor(data[1], device=device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:%d"
                            % free_port(), rank=0, world_size=1)
    out = {"launches": {}, "trees": 0}
    try:
        for cls in (DataParallelTreeLearner, FeatureParallelTreeLearner,
                    VotingParallelTreeLearner,
                    PartitionedDataParallelTreeLearner):
            cfg = Config(objective="binary", num_leaves=255,
                         learning_rate=0.1, max_bin=255, verbosity=-1)
            booster = GBDT(cfg, ds, create_objective("binary", cfg,
                                                     device=device),
                           device=device)
            booster.learner = cls(ds, cfg, device)
            mode = booster.learner.mode
            r = run_iterations(booster, iters, label)
            routes = D.route_launches()["partition"]
            if trees_text(booster.save_model_to_string()) != trees_text(
                    a_text):
                raise AssertionError("(V1) %s: the model differs from (A)'s"
                                     % mode)
            expect_leafwise_launches("V1 " + mode, r)
            if mode == "feature" and routes["feature_window"] != r["splits"]:
                raise AssertionError("(V1) feature: %d windowed split passes "
                                     "of %d" % (routes["feature_window"],
                                                r["splits"]))
            ops = booster.learner.comm.ops
            log("  (V1) %s (%s, %s, 1 rank): trees equal to (A)'s byte for "
                "byte; s/iteration %s; comm per split %s"
                % (cls.__name__, mode, backend,
                   ["%.4f" % v for v in r["iter_s"]],
                   json.dumps(comm_per_split(ops.summary(), r["splits"]))))
            for k, v in r["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            out["trees"] += r["trees"]
            del booster
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def _parallel_rank(rank: int, port: int, n: int, iters: int,
                   out_dir: str, device: str) -> None:
    """One rank of (V2): a gloo group of 2 processes, both on ``device``
    (CUDA device 0 on the card), each binning (A)'s task itself and
    training every run of ``V2_RUNS`` through the factory; results to
    ``<out_dir>/rank<r>.pkl``."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist
    res = {}
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                                % port, rank=rank, world_size=2,
                                timeout=timedelta(seconds=300))
        from lightgbm_tpu_torch import (BinnedDataset, Config, GBDT,
                                        create_objective)
        from lightgbm_tpu_torch import device as D
        from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
        from lightgbm_tpu_torch.metric.binary import weighted_auc
        from lightgbm_tpu_torch.utils.log import Log
        Log.reset_level(Log.level_from_verbosity(-1))
        t0 = time.perf_counter()
        X, y, X_test, y_test = synthetic_task(n)
        ds = BinnedDataset.from_matrix(X, label=y, max_bin=255)
        label = torch.as_tensor(y, device=device)
        res["setup_s"] = time.perf_counter() - t0
        for name, extra in V2_RUNS:
            t0 = time.perf_counter()
            cfg = Config(objective="binary", num_leaves=255,
                         learning_rate=0.1, max_bin=255, verbosity=-1,
                         tree_learner=name.split("_")[0], **extra)
            booster = GBDT(cfg, ds, create_objective("binary", cfg,
                                                     device=device),
                           device=device)
            booster.learner.comm.ops.reset()
            r = run_iterations(booster, iters, label)
            r["routes"] = D.route_launches()["partition"]
            r["comm"] = booster.learner.comm.ops.summary()
            raw = booster.predict(X_test, raw_score=True)
            single = FusedPredictor(booster.models, device=device)(X_test)
            r["predict_equal"] = bool(np.array_equal(raw, single))
            r["auc"] = weighted_auc(y_test, raw, None)
            r["text"] = booster.save_model_to_string()
            r["tree0"] = tree0_sequence(booster)
            r["class"] = type(booster.learner).__name__
            booster._write_snapshot(os.path.join(out_dir, "%s_r%d"
                                                 % (name, rank)))
            r["run_s"] = time.perf_counter() - t0
            res[name] = r
            del booster
            torch.cuda.empty_cache()
        dist.barrier()
        setup = res.pop("setup_s")
        res = {"ok": res, "files": sorted(os.listdir(out_dir)),
               "setup_s": setup}
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fh:
        pickle.dump(res, fh)


def phase_parallel_gloo(device, n: int, iters: int, a: dict,
                        c_losses: list) -> dict:
    """Path (V2): two ranks of a gloo group on the one card (NCCL cannot put
    two ranks on one GPU), where the cross-rank reductions really happen:
    ``tree_learner=data``, ``feature``, ``voting`` (``top_k=20``: every
    feature elected) and ``data`` with ``hist_precision=quantized``.  The
    ranks run under a join deadline and are killed past it."""
    import pickle
    import shutil

    import torch.multiprocessing as mp
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, port, n, iters, PARALLEL_DIR, str(device)))
             for r in range(2)]
    for p in procs:
        p.start()
    end = time.monotonic() + PARALLEL_DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError("(V2) ranks %s still running after %.0f s "
                             "(killed)" % (hung, PARALLEL_DEADLINE_S))
    ranks = []
    for r in range(2):
        with open(os.path.join(PARALLEL_DIR, "rank%d.pkl" % r), "rb") as fh:
            got = pickle.load(fh)
        if "error" in got:
            raise AssertionError("(V2) rank %d failed:\n%s" % (r,
                                                                got["error"]))
        ranks.append(got)
    log("  (V2) 2 ranks (gloo, both on %s): %.1f s, of it each rank's data "
        "and binning %s s"
        % (device, time.perf_counter() - t0,
           ["%.1f" % r["setup_s"] for r in ranks]))
    a_loss, c_loss = a["losses"][iters - 1], c_losses[iters - 1]
    out = {"launches": {}, "trees": 0, "feature_window_launches": 0}
    for name, _ in V2_RUNS:
        r0, r1 = ranks[0]["ok"][name], ranks[1]["ok"][name]
        if r0["text"] != r1["text"]:
            raise AssertionError("(V2) %s: the ranks' models differ" % name)
        loss = r0["losses"][-1]
        quantized = name.endswith("quantized")
        log("  (V2) %s (%s, %.1f s on rank 0): s/iteration %s; train logloss "
            "%s; held-out AUC %.6f; comm per split %s"
            % (name, r0["class"], r0["run_s"],
               ["%.4f" % v for v in r0["iter_s"]],
               ["%.6f" % v for v in r0["losses"]], r0["auc"],
               json.dumps(comm_per_split(r0["comm"], r0["splits"]))))
        for rank, r in enumerate((r0, r1)):
            root = "histogram_int" if quantized else "histogram"
            want = {root: r["trees"], "partition": r["splits"]}
            if r["launches"] != {k: want.get(k, 0) for k in r["launches"]}:
                raise AssertionError("(V2) %s rank %d: launches %s, want %s"
                                     % (name, rank, r["launches"], want))
            windowed = r["routes"]["feature_window"]
            if windowed != (r["splits"] if name == "feature" else 0):
                raise AssertionError("(V2) %s rank %d: %d windowed split "
                                     "passes of %d" % (name, rank, windowed,
                                                       r["splits"]))
            if not r["predict_equal"]:
                raise AssertionError("(V2) %s rank %d: sharded_predict "
                                     "differs from predict" % (name, rank))
            for k, v in r["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            out["trees"] += r["trees"]
            out["feature_window_launches"] += windowed
            log("  (V2) %s rank %d: launches %s, split passes with the "
                "feature window %d" % (name, rank, r["launches"], windowed))
        if name == "feature" and (tree_blocks(r0["text"])
                                  == tree_blocks(a["text"])[:iters]):
            # every rank holds every row and sums nothing across the ranks
            log("  (V2) feature: its %d trees equal to (A)'s first %d byte "
                "for byte" % (iters, iters))
        elif quantized:
            rel = abs(loss - c_loss) / c_loss
            if not rel <= QUANT_LOSS_RTOL:
                raise AssertionError("(V2) %s: train logloss %.6f vs (C)'s "
                                     "%.6f, rel %.3g" % (name, loss, c_loss,
                                                         rel))
            log("  (V2) %s: train logloss within %.3g relative of (C)'s "
                "serial quantized %.6f" % (name, rel, c_loss))
        else:
            if name == "feature":
                # the same histograms, scanned by block: find why
                log("  (V2) feature: the trees differ from (A)'s, first at "
                    "%s; (A)'s root histogram scanned whole and in 2 feature"
                    " blocks on this device: %d (alone) and %d (a batch of "
                    "two leaves) of %d features' best splits differ bitwise"
                    % ((first_text_difference(
                        r0["text"], a["text"]),)
                        + block_scan_differences(a["booster"])))
            expect_tree0_up_to_tie("(V2) " + name, r0["tree0"], a["tree0"],
                                   a["tree0_terms"])
            rel = abs(loss - a_loss) / a_loss
            if not rel <= TRAIN_LOSS_RTOL:
                raise AssertionError("(V2) %s: train logloss %.6f vs (A)'s "
                                     "%.6f, rel %.3g" % (name, loss, a_loss,
                                                         rel))
            log("  (V2) %s: train logloss after %d iterations within %.3g "
                "relative of (A)'s %.6f" % (name, len(r0["losses"]), rel,
                                            a_loss))
    files = ranks[0]["files"]
    for name, _ in V2_RUNS:
        if not any(f.startswith("%s_r0.snapshot_iter_" % name)
                   for f in files):
            raise AssertionError("(V2) %s: the write leader wrote no model "
                                 "file" % name)
    if any("_r1." in f for f in files):
        raise AssertionError("(V2) rank 1 wrote files: %s" % files)
    log("  (V2) only the write leader (rank 0) wrote model files: %d files"
        % len(files))
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    if out["feature_window_launches"] == 0:
        raise AssertionError("(V2) no split pass ran with a feature window")
    return out


# ------------------------------------------------- path (S): CLI from files


CLI_DIR = os.path.join("build", "cli")
CLI_ROWS = 1 << 20                # (A)'s rows
CLI_ITERS = 5
CLI_CHUNK = 65_536
CLI_PARAMS = ["objective=binary", "num_leaves=255", "max_bin=255",
              "metric=auc", "verbosity=-1"]
CONVERT_ROWS = 1000
CONVERT_RTOL = 1e-10
# (config, iterations, windows): test_parity.py's counts and windows
# (:71-165) around the reference LightGBM 2.3.2 CLI's metrics
CLI_EXAMPLES = [
    ("binary_classification", 25, {
        "training auc": 0.02, "valid_1 auc": 0.025,
        "training binary_logloss": 0.04, "valid_1 binary_logloss": 0.04}),
    ("regression", 25, {"training l2": 0.02, "valid_1 l2": 0.02}),
    ("multiclass_classification", 10, {
        "training multi_logloss": 0.06, "valid_1 multi_logloss": 0.08,
        "training auc_mu": 0.03, "valid_1 auc_mu": 0.05}),
    ("lambdarank", 10, {
        "training ndcg@5": 0.04, "valid_1 ndcg@5": 0.08,
        "training ndcg@1": 0.05, "valid_1 ndcg@1": 0.08}),
    ("sparse_binary", 25, {
        "training auc": 0.02, "valid_1 auc": 0.03,
        "training binary_logloss": 0.04, "valid_1 binary_logloss": 0.05}),
]
# one load of a text file in a process of its own: its seconds and its
# resident set sampled every 10 ms during the load, against the one before
# it (getrusage's ru_maxrss would carry the forking parent's high-water
# mark across the exec on Linux); the dataset is written back in binary
LOAD_CHILD = """
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[4])
if sys.argv[5] == "1":
    sys.modules["pandas"] = None
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.loader import DatasetLoader
page = os.sysconf("SC_PAGE_SIZE")
def rss():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * page
cfg = Config(json.loads(sys.argv[2]))
base, peak, done = rss(), [0], threading.Event()
def sample():
    while not done.wait(0.01):
        peak[0] = max(peak[0], rss())
th = threading.Thread(target=sample, daemon=True)
th.start()
t = time.perf_counter()
ds = DatasetLoader(cfg).load_from_file(sys.argv[1])
dt = time.perf_counter() - t
done.set()
th.join()
peak[0] = max(peak[0], rss())
ds.save_binary(sys.argv[3])
print(json.dumps({"seconds": dt, "base": base, "peak": peak[0]}))
"""


def fixed_text(k: np.ndarray) -> bytes:
    """[n, c] int64 values in millionths -> CSV text, each value written as
    ``sDD.DDDDDD`` (the exact decimal, so that every correctly rounded
    parser reads ``k / 1e6``), ``,`` between values and a newline after
    each row."""
    n, c = k.shape
    if n and np.abs(k).max() >= 10 ** 8:
        raise ValueError("value out of the fixed format's range")
    out = np.empty((n, c, 11), np.uint8)
    out[:, :, 0] = np.where(k < 0, ord("-"), ord("+"))
    a = np.abs(k)
    for j, col in enumerate((1, 2, 4, 5, 6, 7, 8, 9)):
        out[:, :, col] = (a // 10 ** (7 - j)) % 10 + ord("0")
    out[:, :, 3] = ord(".")
    out[:, :, 10] = ord(",")
    out[:, -1, 10] = ord("\n")
    return out.tobytes()


def write_fixed_csv(path: str, cols: np.ndarray) -> float:
    """``cols`` [n, c] (f64, already millionths) to ``path`` in blocks;
    returns the seconds taken."""
    t = time.perf_counter()
    with open(path, "wb") as fh:
        for lo in range(0, len(cols), 1 << 17):
            fh.write(fixed_text(np.rint(cols[lo:lo + (1 << 17)] * 1e6)
                                .astype(np.int64)))
    return time.perf_counter() - t


def millionths(a) -> np.ndarray:
    """The values the fixed format writes for ``a``, as f64."""
    return np.rint(np.asarray(a, np.float64) * 1e6) / 1e6


def dataset_digest(ds) -> tuple:
    """What two loads of one file must share byte for byte."""
    mappers = json.dumps([m.to_dict() for m in ds.bin_mappers],
                         sort_keys=True)
    meta = ds.metadata
    return (mappers, ds.binned.dtype.str, ds.binned.shape,
            ds.binned.tobytes(), [list(g) for g in ds.feature_groups],
            np.asarray(meta.label).tobytes(),
            None if meta.weights is None
            else np.asarray(meta.weights).tobytes())


def expect_same_dataset(a, b, what: str) -> None:
    da, db = dataset_digest(a), dataset_digest(b)
    names = ("bin mappers", "store dtype", "store shape", "packed store",
             "EFB groups", "labels", "weights")
    bad = [n for n, x, y in zip(names, da, db) if x != y]
    if bad:
        raise AssertionError("%s: %s differ" % (what, ", ".join(bad)))
    log("  %-52s byte-equal (mappers, store, labels, weights)" % what)


def trees_text(text: str) -> str:
    return text[:text.index("\nparameters:")]


class IterationTimes:
    """Each ``GBDT.train_one_iter``'s wall seconds, ending in a device
    synchronise, while installed (the CLI builds its booster inside)."""

    def __init__(self) -> None:
        from lightgbm_tpu_torch.boosting.gbdt import GBDT
        self.cls, self.real, self.iter_s = GBDT, GBDT.train_one_iter, []

    def __enter__(self):
        rec = self

        def timed_iter(booster, *a, **k):
            t = time.perf_counter()
            out = rec.real(booster, *a, **k)
            torch.cuda.synchronize()
            rec.iter_s.append(time.perf_counter() - t)
            return out
        self.cls.train_one_iter = timed_iter
        return self

    def __exit__(self, *exc) -> None:
        self.cls.train_one_iter = self.real


def run_cli(argv, what: str) -> tuple:
    """``cli.Application(argv).run()`` on the card (what ``cli.main`` runs)
    with the launch counts read around it: (application, launches,
    seconds, iteration seconds)."""
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.cli import Application
    D.reset_launches()
    t = time.perf_counter()
    with IterationTimes() as rec:
        app = Application(argv)
        app.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = D.launches()
    log("  %s: %.2f s wall, launches %s" % (what, wall, counts))
    return app, counts, wall, rec.iter_s


def expect_cli_launches(what: str, booster, counts: dict) -> tuple:
    """The CLI's training went through the root histogram (#1) once per
    tree and the split pass (#3/#4) once per split, and nothing else."""
    trees = len(booster.models)
    splits = sum(t.num_leaves - 1 for t in booster.models)
    want = {"histogram": trees, "partition": splits}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError("(%s): launches %s, want %s"
                             % (what, counts, want))
    return trees, splits


def run_loaders(path: str, params: dict, out_dir: str) -> dict:
    """One-shot, ``data_chunk_rows`` and ``two_round`` loads of ``path``,
    one after another, each in a process of its own: seconds, peak RSS and
    the dataset written back in binary."""
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    root = os.path.dirname(os.path.abspath(__file__))
    modes = {"one-shot": {}, "data_chunk_rows=%d" % CLI_CHUNK:
             {"data_chunk_rows": CLI_CHUNK}, "two_round": {"two_round": True}}
    no_pandas = "pandas" in sys.modules and sys.modules["pandas"] is None
    res = {}
    for i, (name, extra) in enumerate(modes.items()):
        out = os.path.join(out_dir, "load%d.bin" % i)
        proc = subprocess.run(
            [sys.executable, "-c", LOAD_CHILD, path,
             json.dumps(dict(params, **extra)), out, root,
             "1" if no_pandas else "0"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError("%s load failed: %s"
                                 % (name, proc.stderr[-2000:]))
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["ds"] = BinnedDataset.load_binary(out)
        mib = 1 << 20
        log("  %-22s load %.2f s, peak RSS during it %.0f MiB (%.0f MiB "
            "over the %.0f MiB before it)"
            % (name, r["seconds"], r["peak"] / mib,
               (r["peak"] - r["base"]) / mib, r["base"] / mib))
        res[name] = r
    return res


def phase_cli(device, n: int) -> dict:
    """Path (S): the CLI from text files on the card (``cli.py``,
    ``io/loader.py``, ``io/parser.py``, ``model_codegen.py``).  (S1) (A)'s
    Higgs-shaped task written to CSV (values in millionths, exact in
    decimal) with a ``.weight`` side file and a validation file, trained by
    ``task=train``: the loaded dataset byte-equal to ``from_matrix`` of the
    file's values, the model's trees equal to ``lightgbm_tpu_torch.train``'s
    on that matrix, the kernels launched once per tree and split and held
    to their plain versions on the CLI's row store; (S2) the same file
    loaded one-shot, with ``data_chunk_rows`` and ``two_round``, each
    byte-equal to (S1)'s dataset, with its seconds and peak RSS; (S3)
    ``task=predict`` equal to ``Booster.predict`` within the ``%g`` print,
    ``task=convert_model`` built with ``g++`` equal to ``predict`` on 1,000
    rows to rtol 1e-10, ``task=refit`` on the training file; (S4) the
    reference's example configs through the CLI, held to the golden
    metrics' windows."""
    import ctypes
    import shutil

    import lightgbm_tpu_torch as P
    from lightgbm_tpu_torch.metric.binary import weighted_auc
    from lightgbm_tpu_torch.utils.log import Log

    if os.path.isdir(CLI_DIR):
        shutil.rmtree(CLI_DIR)
    os.makedirs(CLI_DIR)
    out = {"launches": {}, "trees": 0, "splits": 0}

    def add(counts, trees, splits):
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out["trees"] += trees
        out["splits"] += splits

    try:
        # ---- (S1) ----
        X, y, X_test, y_test = synthetic_task(n)
        w = np.random.RandomState(11).randint(500_000, 1_500_001,
                                              size=n) / 1e6
        train_f = os.path.join(CLI_DIR, "higgs.train")
        valid_f = os.path.join(CLI_DIR, "higgs.test")
        model_f = os.path.join(CLI_DIR, "model.txt")
        t = time.perf_counter()
        secs = write_fixed_csv(train_f, np.column_stack([y, X]))
        secs += write_fixed_csv(valid_f, np.column_stack([y_test, X_test]))
        secs += write_fixed_csv(train_f + ".weight", w[:, None])
        mb = (os.path.getsize(train_f) + os.path.getsize(valid_f)) / 2 ** 20
        log("  (S1) wrote %d + %d rows x %d columns (%.1f MiB of CSV) and a "
            ".weight file in %.2f s" % (n, len(y_test), X.shape[1] + 1, mb,
                                        secs))
        Xq, Xq_test, wq = millionths(X), millionths(X_test), millionths(w)
        argv = (["task=train", "data=%s" % train_f, "valid=%s" % valid_f,
                 "num_iterations=%d" % CLI_ITERS, "output_model=%s" % model_f]
                + CLI_PARAMS)
        app, counts, wall, iter_s = run_cli(argv, "(S1) task=train")
        booster = app.booster
        trees, splits = expect_cli_launches("S1", booster, counts)
        add(counts, trees, splits)
        out["iter_s"] = iter_s
        med = float(np.median(iter_s))
        log("  (S1) seconds per iteration %s (median %.4f), %d trees, %d "
            "splits" % (["%.4f" % v for v in iter_s], med, trees, splits))
        evals = booster.eval_valid()
        log("  (S1) validation %s" % evals)
        cfg_params = dict(objective="binary", num_leaves=255, max_bin=255,
                          metric="auc", verbosity=-1)
        t = time.perf_counter()
        ref = P.BinnedDataset.from_matrix(Xq, label=y, weight=wq,
                                          max_bin=255)
        log("  (S1) from_matrix of the file's values in %.2f s"
            % (time.perf_counter() - t))
        expect_same_dataset(booster.train_data, ref,
                            "(S1) CLI dataset vs from_matrix")
        if not np.array_equal(booster.train_data.raw_data, Xq):
            raise AssertionError("(S1) the CLI's raw values differ from the "
                                 "file's")
        bst = P.train(cfg_params, P.Dataset(Xq, y, weight=wq,
                                            params=cfg_params),
                      num_boost_round=CLI_ITERS, verbose_eval=False)
        with open(model_f) as fh:
            cli_text = fh.read()
        if trees_text(cli_text) != trees_text(bst.model_to_string()):
            raise AssertionError("(S1) the CLI's trees differ from "
                                 "lightgbm_tpu_torch.train's")
        log("  (S1) the CLI's %d trees equal lightgbm_tpu_torch.train's on "
            "the file's matrix" % trees)
        del bst
        out["times"] = check_path_kernels(booster.learner, "S",
                                          numerical=True)
        train_ds = booster.train_data
        del app, booster
        torch.cuda.empty_cache()

        # ---- (S2) ----
        loads = run_loaders(train_f, {"max_bin": 255, "verbosity": -1},
                            CLI_DIR)
        for name, r in loads.items():
            expect_same_dataset(r["ds"], train_ds,
                                "(S2) %s vs (S1)" % name)
        out["loads"] = {k: {"seconds": v["seconds"],
                            "peak_rss_mib": v["peak"] / (1 << 20),
                            "growth_mib": (v["peak"] - v["base"]) / (1 << 20)}
                        for k, v in loads.items()}
        del loads, train_ds

        # ---- (S3) ----
        result_f = os.path.join(CLI_DIR, "predict.txt")
        _, counts, t_pred, _ = run_cli(
            ["task=predict", "data=%s" % valid_f, "verbosity=-1",
             "input_model=%s" % model_f, "output_result=%s" % result_f],
            "(S3) task=predict")
        s3_counts = [counts]
        got = np.loadtxt(result_f)
        model = P.Booster(model_file=model_f)
        want = model.predict(Xq_test)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        auc = weighted_auc(y_test, want, None)
        log("  (S3) task=predict %d rows in %.2f s: equal to Booster.predict "
            "within the %%g print; held-out AUC %.6f" % (len(got), t_pred,
                                                           auc))
        if not auc > 0.75:
            raise AssertionError("(S3) held-out AUC %.4f" % auc)
        cpp = os.path.join(CLI_DIR, "model.cpp")
        so = os.path.join(CLI_DIR, "model.so")
        t = time.perf_counter()
        _, counts, _, _ = run_cli(
            ["task=convert_model", "input_model=%s" % model_f,
             "convert_model=%s" % cpp, "verbosity=-1"],
            "(S3) task=convert_model")
        s3_counts.append(counts)
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", cpp, "-o", so],
                       check=True)
        lib = ctypes.CDLL(os.path.abspath(so))
        ptr = ctypes.POINTER(ctypes.c_double)
        lib.Predict.argtypes = [ptr, ptr]
        one = np.zeros(1)
        rows = np.ascontiguousarray(Xq_test[:CONVERT_ROWS])
        conv = np.empty(len(rows))
        for i in range(len(rows)):
            lib.Predict(rows[i].ctypes.data_as(ptr), one.ctypes.data_as(ptr))
            conv[i] = one[0]
        np.testing.assert_allclose(conv, model.predict(rows),
                                   rtol=CONVERT_RTOL, atol=0)
        log("  (S3) task=convert_model + g++ in %.2f s: %d rows equal to "
            "predict to rtol %g" % (time.perf_counter() - t, len(rows),
                                    CONVERT_RTOL))
        refit_f = os.path.join(CLI_DIR, "refit.txt")
        _, counts, t_refit, _ = run_cli(
            ["task=refit", "data=%s" % train_f, "input_model=%s" % model_f,
             "output_model=%s" % refit_f] + CLI_PARAMS, "(S3) task=refit")
        s3_counts.append(counts)
        refit = P.Booster(model_file=refit_f)
        for a, b in zip(model._booster.models, refit._booster.models):
            nl = a.num_leaves
            if not (b.num_leaves == nl and np.array_equal(
                    a.split_feature[:nl - 1], b.split_feature[:nl - 1])
                    and np.isfinite(b.leaf_value[:nl]).all()):
                raise AssertionError("(S3) refit changed a tree's shape")
        r_auc = weighted_auc(y_test, refit.predict(Xq_test), None)
        log("  (S3) task=refit on the training file in %.2f s: same trees, "
            "held-out AUC %.6f" % (t_refit, r_auc))
        if not r_auc > 0.75:
            raise AssertionError("(S3) refit's held-out AUC %.4f" % r_auc)
        if any(any(c.values()) for c in s3_counts):
            raise AssertionError("(S3) predict, convert_model and refit "
                                 "launched kernels: %s" % s3_counts)
        del model, refit

        # ---- (S4) ----
        here = os.path.dirname(os.path.abspath(__file__))
        data_dir = os.path.join(here, "tests", "data")
        with open(os.path.join(data_dir, "golden_metrics.json")) as fh:
            golden = json.load(fh)
        out["examples"] = {}
        for name, iters, windows in CLI_EXAMPLES:
            conf_dir = os.path.join(data_dir, name)
            conf = os.path.join(conf_dir, "train.conf")
            params = {}
            with open(conf) as fh:
                for line in fh:
                    line = line.split("#", 1)[0]
                    if "=" in line:
                        k, v = line.split("=", 1)
                        params[k.strip()] = v.strip()
            argv = ["config=%s" % conf,
                    "data=%s" % os.path.join(conf_dir, params["data"]),
                    "valid=%s" % os.path.join(conf_dir,
                                              params["valid_data"]),
                    "num_iterations=%d" % iters, "verbosity=-1",
                    "output_model=%s" % os.path.join(CLI_DIR, name + ".txt")]
            app, counts, wall, _ = run_cli(argv, "(S4) %s" % name)
            trees, splits = expect_cli_launches("S4 " + name, app.booster,
                                                counts)
            add(counts, trees, splits)
            got = {"%s %s" % (d, m): v for d, m, v, _ in
                   app.booster.eval_train() + app.booster.eval_valid()}
            want = golden[name][str(iters)]
            bad = [k for k, tol in windows.items()
                   if not abs(got[k] - want[k]) < tol]
            log("  (S4) %s, %d iterations, %.2f s: %s" % (
                name, iters, wall, ", ".join(
                    "%s %.6f (reference %.6f)" % (k, got[k], want[k])
                    for k in sorted(windows))))
            if bad:
                raise AssertionError("(S4) %s outside the golden windows: %s"
                                     % (name, bad))
            out["examples"][name] = {"seconds": wall, "metrics": got}
            del app
        log("  (S) launches %s over %d trees and %d splits"
            % (out["launches"], out["trees"], out["splits"]))
    finally:
        Log.reset_level(Log.level_from_verbosity(-1))
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    return out


# --------------------------- paths (T) and (U): the C ABI and resilience

CAPI_PARAMS = ("objective=binary num_leaves=255 max_bin=255 "
               "learning_rate=0.1 metric=auc num_iterations=%d verbosity=-1")
CAPI_LEVEL = " tree_grow_mode=level hist_precision=quantized"
CAPI_CSR_ROWS = 1000
RESIL_DIR = os.path.join("build", "resil")
PREEMPT_AT = 2                # (U) SIGTERM after this iteration
WATCHDOG_S = 120.0
RESIL_CLI_ITERS = 30          # long enough for SIGTERM to land mid-run


def capi_params(iters: int, extra: str = "") -> dict:
    """The C parameter string's pairs, as ``train()`` gets them."""
    return dict(tok.split("=", 1) for tok in
                (CAPI_PARAMS % iters + extra).split())


class CLib:
    """``lib_lightgbm_tpu_torch.so`` through ctypes, each call checked."""

    def __init__(self, path: str) -> None:
        import ctypes
        self.ct = ctypes
        self.lib = ctypes.CDLL(path)
        self.lib.LGBM_GetLastError.restype = ctypes.c_char_p

    def __call__(self, name: str, *args) -> None:
        if getattr(self.lib, name)(*args) != 0:
            raise AssertionError("%s: %s" % (
                name, self.lib.LGBM_GetLastError().decode()))

    def ptr(self, a: np.ndarray):
        return a.ctypes.data_as(self.ct.c_void_p)

    def mat(self, X: np.ndarray, label, ref=None):
        ct = self.ct
        h = ct.c_void_p()
        self("LGBM_DatasetCreateFromMat", self.ptr(X), 1,
             ct.c_int32(X.shape[0]), ct.c_int32(X.shape[1]), 1,
             b"max_bin=255", ref, ct.byref(h))
        lab = np.ascontiguousarray(label, dtype=np.float32)
        self("LGBM_DatasetSetField", h, b"label", self.ptr(lab), len(lab), 0)
        return h

    def booster(self, train, params: str, valid=None):
        h = self.ct.c_void_p()
        self("LGBM_BoosterCreate", train, params.encode(), self.ct.byref(h))
        if valid is not None:
            self("LGBM_BoosterAddValidData", h, valid)
        return h

    def iterations(self, h, iters: int) -> list:
        """``iters`` calls of LGBM_BoosterUpdateOneIter, each timed to a
        device synchronise, as (A) times ``train_one_iter``."""
        fin = self.ct.c_int()
        out = []
        for _ in range(iters):
            t = time.perf_counter()
            self("LGBM_BoosterUpdateOneIter", h, self.ct.byref(fin))
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    def model(self, h) -> str:
        """Size-then-fill, as the R glue reads it."""
        ct = self.ct
        n = ct.c_int64()
        self("LGBM_BoosterSaveModelToString", h, 0, -1, ct.c_int64(0),
             ct.byref(n), None)
        buf = ct.create_string_buffer(n.value)
        self("LGBM_BoosterSaveModelToString", h, 0, -1, n, ct.byref(n), buf)
        return buf.value.decode()

    def predict(self, h, X: np.ndarray, ptype: int) -> np.ndarray:
        ct = self.ct
        out = np.zeros(X.shape[0])
        n = ct.c_int64()
        self("LGBM_BoosterPredictForMat", h, self.ptr(X), 1,
             ct.c_int32(X.shape[0]), ct.c_int32(X.shape[1]), 1, ptype, -1,
             b"", ct.byref(n), out.ctypes.data_as(ct.POINTER(ct.c_double)))
        return out

    def predict_csr(self, h, X: np.ndarray) -> np.ndarray:
        ct = self.ct
        indptr = np.arange(0, X.size + 1, X.shape[1], dtype=np.int64)
        indices = np.tile(np.arange(X.shape[1], dtype=np.int32), X.shape[0])
        data = np.ascontiguousarray(X).ravel()
        if not np.all(data != 0):
            raise AssertionError("(T) the CSR rows must have no zeros")
        out = np.zeros(X.shape[0])
        n = ct.c_int64()
        self("LGBM_BoosterPredictForCSR", h, self.ptr(indptr), 3,
             self.ptr(indices), self.ptr(data), 1, ct.c_int64(len(indptr)),
             ct.c_int64(len(data)), ct.c_int64(X.shape[1]), 0, -1, b"",
             ct.byref(n), out.ctypes.data_as(ct.POINTER(ct.c_double)))
        return out

    def free(self, *handles) -> None:
        from lightgbm_tpu_torch import c_api
        for h in handles:
            kind = type(c_api._get(h.value)).__name__
            self("LGBM_BoosterFree" if kind == "_CBooster"
                 else "LGBM_DatasetFree", h)


def gbdt_of(handle):
    """The booster behind a C handle (the library calls this process's
    ``lightgbm_tpu_torch.c_api``)."""
    from lightgbm_tpu_torch import c_api
    return c_api._get(handle.value).booster._booster


def phase_capi(device, data, iters: int) -> dict:
    """Path (T): the C ABI (``lib_lightgbm_tpu_torch.so``, built by
    ``capi_build`` into ``build/capi``) at (A)'s shape, full width, through
    raw ``LGBM_*`` calls in this process: the training rows as f64
    row-major with f32 labels (LGBM_DatasetCreateFromMat +
    LGBM_DatasetSetField), the held-out rows as a validation set binned
    with the training set's mappers, (A)'s parameters, ``iters``
    LGBM_BoosterUpdateOneIter, LGBM_BoosterGetEval, the model string
    (size-then-fill), LGBM_BoosterPredictForMat (normal and raw) and
    LGBM_BoosterPredictForCSR on 1,000 rows.  Held to
    ``lightgbm_tpu_torch.train`` with the same parameters on the same data
    in this run: the model text byte-equal, the predictions equal to the
    last bit, the launches one root histogram per tree and one split pass
    per split.  Then (T2): a second booster on the same C dataset with
    ``tree_grow_mode=level hist_precision=quantized``: its model equal to
    ``train()``'s, launches of the integer histogram (one per tree) and of
    the level pass (one per level)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import capi_build, c_api
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.metric.binary import weighted_auc
    X, y, X_test, y_test = data
    X64 = np.ascontiguousarray(X, dtype=np.float64)
    Xt64 = np.ascontiguousarray(X_test, dtype=np.float64)
    t = time.perf_counter()
    so = capi_build.build()
    build_s = time.perf_counter() - t
    lib = CLib(so)
    log("  library %s (%.2f s to build or find)" % (so, build_s))
    t = time.perf_counter()
    train = lib.mat(X64, y)
    valid = lib.mat(Xt64, y_test, train)
    bin_s = time.perf_counter() - t
    bst = lib.booster(train, CAPI_PARAMS % iters, valid)
    D.reset_launches()
    iter_s = lib.iterations(bst, iters)
    counts = D.launches()
    ct = lib.ct
    auc = np.zeros(1)
    n = ct.c_int()
    lib("LGBM_BoosterGetEval", bst, 1, ct.byref(n),
        auc.ctypes.data_as(ct.POINTER(ct.c_double)))
    text = lib.model(bst)
    prob = lib.predict(bst, Xt64, 0)
    raw = lib.predict(bst, Xt64, 1)
    csr = lib.predict_csr(bst, Xt64[:CAPI_CSR_ROWS])
    gbdt = gbdt_of(bst)
    trees = len(gbdt.models)
    splits = sum(tr.num_leaves - 1 for tr in gbdt.models)
    fallbacks = ct.c_int64(-1)
    lib("LGBM_PredictFallbackCount", ct.byref(fallbacks))
    med = float(np.median(iter_s))
    log("  (T) C ABI: binning (train + validation) %.2f s; iterations %s "
        "(median %.4f s); held-out AUC %.6f (LGBM_BoosterGetEval), %.6f "
        "(from the raw predictions); launches %s"
        % (bin_s, ["%.4f" % s for s in iter_s], med, auc[0],
           weighted_auc(y_test, raw, None), counts))

    # the same training through the Python API, on the same data
    params = capi_params(iters)
    ref_set = lgb.Dataset(X64, label=y, params={"max_bin": "255"})
    ref_valid = lgb.Dataset(Xt64, label=y_test, reference=ref_set)
    with IterationTimes() as rec:
        ref = lgb.train(dict(params), ref_set, num_boost_round=iters,
                        valid_sets=[ref_valid], verbose_eval=False)
    ref_med = float(np.median(rec.iter_s))
    checks = {
        "model text byte-equal": text == ref.model_to_string(),
        "predict equal": np.array_equal(prob, ref.predict(Xt64)),
        "raw predict equal": np.array_equal(
            raw, ref.predict(Xt64, raw_score=True)),
        "CSR predict equal": np.array_equal(
            csr, ref.predict(Xt64[:CAPI_CSR_ROWS])),
        "AUC equal": auc[0] == ref.best_score["valid_0"]["auc"],
        "launches": counts == {k: {"histogram": trees,
                                   "partition": splits}.get(k, 0)
                               for k in counts},
        "no fallback": fallbacks.value == 0,
    }
    log("  (T) train() on the same data: iterations %s (median %.4f s); "
        "C ABI / train() median %.4f" % (["%.4f" % s for s in rec.iter_s],
                                          ref_med, med / ref_med))
    log("  (T) %d trees, %d splits; %s" % (trees, splits, ", ".join(
        "%s %s" % (k, "yes" if v else "NO") for k, v in checks.items())))
    if not all(checks.values()):
        raise AssertionError("(T) the C ABI differs from the Python API: %s"
                             % [k for k, v in checks.items() if not v])
    lib.free(bst)
    del ref
    torch.cuda.empty_cache()

    # (T2) level-wise, quantized, on the same C dataset
    bst2 = lib.booster(train, CAPI_PARAMS % iters + CAPI_LEVEL)
    D.reset_launches()
    fin = ct.c_int()
    iter2_s, levels = [], 0
    for _ in range(iters):
        t = time.perf_counter()
        lib("LGBM_BoosterUpdateOneIter", bst2, ct.byref(fin))
        torch.cuda.synchronize()
        iter2_s.append(time.perf_counter() - t)
        levels += gbdt_of(bst2).last_arrays.levels
    counts2 = D.launches()
    text2 = lib.model(bst2)
    ref2 = lgb.train(capi_params(iters, CAPI_LEVEL), ref_set,
                     num_boost_round=iters, verbose_eval=False)
    trees2 = len(gbdt_of(bst2).models)
    want2 = {"histogram_int": trees2, "partition_level": levels}
    same2 = text2 == ref2.model_to_string()
    log("  (T2) C ABI, level + quantized: iterations %s (median %.4f s); "
        "%d level steps; launches %s; model text %s train()'s"
        % (["%.4f" % s for s in iter2_s], float(np.median(iter2_s)), levels,
           counts2, "equal to" if same2 else "DIFFERENT from"))
    if counts2 != {k: want2.get(k, 0) for k in counts2} or not same2:
        raise AssertionError("(T2) launches %s (want %s), model %s"
                             % (counts2, want2, same2))
    lib.free(bst2, valid, train)
    del ref2, ref_set, ref_valid, X64, Xt64
    torch.cuda.empty_cache()
    if c_api._handles:
        raise AssertionError("(T) handles left: %s" % list(c_api._handles))
    return {"T": dict(launches=counts, trees=trees, splits=splits,
                      iter_s=iter_s, train_iter_s=rec.iter_s,
                      auc=float(auc[0]), bin_s=bin_s, build_s=build_s),
            "T2": dict(launches=counts2, trees=trees2, levels=levels,
                       iter_s=iter2_s),
            "text": text}


def phase_resilience(device, data, iters: int, uninterrupted: str) -> dict:
    """Path (U): preemption and the watchdog on the card.  (U1)
    ``lightgbm_tpu_torch.train`` at (A)'s shape with (T)'s parameters plus
    ``watchdog_timeout_s``, ``preemption_checkpoint=True`` and a checkpoint
    prefix under ``build/``; a callback sends SIGTERM to this process after
    iteration 2: the call raises ``TrainingPreempted`` and the emergency
    checkpoint exists (its write seconds and bytes printed).  (U2) the same
    call again resumes it to ``iters``: the trees byte-equal to (T)'s
    uninterrupted ``train()`` (``uninterrupted``; the parameters footer
    differs by the two keys) and no watchdog stall.  (U3) the CLI on the
    reference's binary example from ``tests/data`` (7,000 x 28) with
    ``preemption_checkpoint=true snapshot_freq=1``: uninterrupted in this
    process; in a child process that this one sends SIGTERM once its first
    checkpoint exists, which must exit 75; and the same command again in
    this process, which resumes and writes the uninterrupted run's
    trees."""
    import glob
    import shutil
    import signal
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch import resilience
    from lightgbm_tpu_torch.checkpoint import list_checkpoints
    X, y, _, _ = data
    shutil.rmtree(RESIL_DIR, ignore_errors=True)
    os.makedirs(RESIL_DIR)
    out = {}
    try:
        # ---- (U1), (U2) ----
        params = dict(capi_params(iters), watchdog_timeout_s=WATCHDOG_S)
        ds = lgb.Dataset(np.ascontiguousarray(X, dtype=np.float64), label=y,
                         params={"max_bin": "255"})
        prefix = os.path.join(RESIL_DIR, "higgs")

        def sigterm_after(env):
            if env.iteration == PREEMPT_AT - 1:
                os.kill(os.getpid(), signal.SIGTERM)

        D.reset_launches()
        t = time.perf_counter()
        try:
            lgb.train(dict(params), ds, num_boost_round=iters,
                      checkpoint_prefix=prefix, preemption_checkpoint=True,
                      callbacks=[sigterm_after], verbose_eval=False)
        except resilience.TrainingPreempted as exc:
            # its fields only: the exception's traceback holds the
            # preempted booster, whose device memory (D) would still see
            pre_it, pre_path, pre_write_s = (exc.iteration,
                                             exc.checkpoint_path,
                                             exc.checkpoint_seconds)
        else:
            raise AssertionError("(U1) SIGTERM did not preempt train()")
        pre_s = time.perf_counter() - t
        ckpt_bytes = os.path.getsize(pre_path)
        log("  (U1) SIGTERM after iteration %d: TrainingPreempted at "
            "iteration %d after %.2f s; emergency checkpoint %s, %d bytes, "
            "written in %.4f s" % (PREEMPT_AT, pre_it, pre_s, pre_path,
                                   ckpt_bytes, pre_write_s))
        if pre_it != PREEMPT_AT or \
                [i for i, _ in list_checkpoints(prefix)] != [PREEMPT_AT]:
            raise AssertionError("(U1) preempted at %d, checkpoints %s"
                                 % (pre_it, list_checkpoints(prefix)))
        if signal.getsignal(signal.SIGTERM) is resilience._on_preempt_signal:
            raise AssertionError("(U1) the SIGTERM handler stayed installed")
        with IterationTimes() as rec:
            resumed = lgb.train(dict(params), ds, num_boost_round=iters,
                                checkpoint_prefix=prefix,
                                preemption_checkpoint=True,
                                verbose_eval=False)
        counts = D.launches()
        same = trees_text(resumed.model_to_string()) == \
            trees_text(uninterrupted)
        stall = resilience.last_stall()
        trees = len(resumed._booster.models)
        splits = sum(tr.num_leaves - 1 for tr in resumed._booster.models)
        log("  (U2) resumed from iteration %d to %d: iterations %s; trees "
            "%s (T)'s uninterrupted train(); watchdog stall %s; launches %s "
            "over both calls" % (pre_it, resumed.current_iteration(),
                                 ["%.4f" % s for s in rec.iter_s],
                                 "equal to" if same else "DIFFERENT from",
                                 stall, counts))
        want = {"histogram": trees, "partition": splits}
        if not same or stall is not None or list_checkpoints(prefix) or \
                counts != {k: want.get(k, 0) for k in counts}:
            raise AssertionError("(U2) resume: same %s, stall %s, launches "
                                 "%s (want %s)" % (same, stall, counts,
                                                   want))
        out.update(launches=counts, trees=trees, splits=splits,
                   ckpt_bytes=ckpt_bytes, ckpt_write_s=pre_write_s,
                   resume_iter_s=rec.iter_s)
        del ds, resumed
        torch.cuda.empty_cache()

        # ---- (U3) the CLI ----
        here = os.path.dirname(os.path.abspath(__file__))
        conf_dir = os.path.join(here, "tests", "data",
                                "binary_classification")

        def argv(model):
            return ["config=%s" % os.path.join(conf_dir, "train.conf"),
                    "data=%s" % os.path.join(conf_dir, "binary.train"),
                    "valid=%s" % os.path.join(conf_dir, "binary.test"),
                    "num_iterations=%d" % RESIL_CLI_ITERS,
                    "preemption_checkpoint=true", "snapshot_freq=1",
                    "verbosity=-1", "output_model=%s" % model]

        ref_model = os.path.join(RESIL_DIR, "cli_ref.txt")
        run_cli(argv(ref_model), "(U3) uninterrupted CLI")
        model = os.path.join(RESIL_DIR, "cli.txt")
        env = dict(os.environ, PYTHONPATH=here)
        t = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch"] + argv(model),
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            first = None
            while child.poll() is None:
                found = glob.glob(glob.escape(model) + ".ckpt_iter_*")
                if found:
                    first = sorted(found)[0]
                    child.send_signal(signal.SIGTERM)
                    break
                time.sleep(0.01)
            log_text, _ = child.communicate(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        child_s = time.perf_counter() - t
        left = list_checkpoints(model)
        log("  (U3) child CLI: SIGTERM once %s existed; exit code %d after "
            "%.2f s; checkpoints left %s"
            % (first, child.returncode, child_s, [i for i, _ in left]))
        if child.returncode != resilience.EXIT_PREEMPTED or not left \
                or os.path.exists(model):
            raise AssertionError("(U3) the child exited %d (want %d), "
                                 "checkpoints %s:\n%s"
                                 % (child.returncode,
                                    resilience.EXIT_PREEMPTED, left,
                                    log_text[-3000:]))
        app, cli_counts, wall, _ = run_cli(argv(model), "(U3) rerun")
        with open(model) as fh, open(ref_model) as gh:
            same_cli = trees_text(fh.read()) == trees_text(gh.read())
        log("  (U3) the rerun resumed from iteration %d and wrote %d "
            "iterations in %.2f s: trees %s the uninterrupted CLI run's; "
            "checkpoints left %s" % (left[0][0], app.booster.iter_, wall,
                                     "equal to" if same_cli
                                     else "DIFFERENT from",
                                     list_checkpoints(model)))
        if not same_cli or list_checkpoints(model):
            raise AssertionError("(U3) the resumed CLI run differs")
        out.update(cli_preempted_at=left[0][0], cli_child_s=child_s)
    finally:
        shutil.rmtree(RESIL_DIR, ignore_errors=True)
    return out


# ---------------------- path (W): telemetry and the serving tier, on the card

SERVE_DIR = os.path.join("build", "serve")
SERVE_ROWS = 262_144          # (W2): rows the clients submit
SERVE_MAX_REQUEST = 4096      # (W2): request sizes 1..4096 rows
SERVE_CLIENTS = 8
SERVE_OUTSTANDING = 4         # requests a client keeps in flight
SERVE_SINGLE_ROWS = 64
SERVE_CLI_ROWS = 20_000       # (W3)
HIGGS_PARAMS = dict(objective="binary", num_leaves=255, learning_rate=0.1,
                    max_bin=255, verbosity=-1)


def http_status(port: int, path: str) -> int:
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as r:
        r.read()
        return r.status


def phase_telemetry_train(device, data, ds, iters: int, a_text: str) -> dict:
    """Path (W1): (A)'s task through ``lightgbm_tpu_torch.train`` with
    ``telemetry_out`` and ``metrics_port`` (a free port): the summary's
    split passes (``tree_kernel_launches``) equal to the kernels' own launch
    counts, every event schema-valid, the summary's device memory peak equal
    to ``torch.cuda.max_memory_allocated``, one scrape of ``/metrics`` and
    ``/healthz`` answering 200 during training, and the trees equal to
    (A)'s (telemetry changes nothing)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch import obs
    X, y, _, _ = data
    os.makedirs(SERVE_DIR, exist_ok=True)
    out_path = os.path.join(SERVE_DIR, "train.jsonl")
    port = free_port()
    codes = {}

    def scrape(env):
        if env.iteration == 1:
            codes.update({p: http_status(port, p)
                          for p in ("/metrics", "/healthz")})

    train = lgb.Dataset(X, y)
    train.handle = ds                    # (A)'s bins and mappers
    obs.launches.reset()
    D.reset_launches()
    t = time.perf_counter()
    booster = lgb.train(dict(HIGGS_PARAMS, telemetry_out=out_path,
                             metrics_port=port), train,
                        num_boost_round=iters, verbose_eval=False,
                        callbacks=[scrape])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = D.launches()
    peak = torch.cuda.max_memory_allocated()
    gbdt = booster._booster
    with open(out_path + ".summary.json") as fh:
        summary = json.load(fh)
    events = obs.read_events(out_path)      # validates every line
    kinds = sorted({e["kind"] for e in events})
    passes = summary["tree_kernel_launch_total"]
    kernel_passes = counts["partition"] + counts["partition_level"]
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    dm_peak = summary.get("devmem", {}).get("peak_bytes_max")
    log("  (W1) train() with telemetry_out and metrics_port=%d: %.2f s, "
        "launches %s" % (port, secs, counts))
    log("  summary: tree_kernel_launches %s, total %d; the kernels' split "
        "passes %d; splits %d" % (summary["tree_kernel_launches"], passes,
                                  kernel_passes, splits))
    log("  %d events of kinds %s, all schema-valid; scrapes %s; devmem "
        "peak %s vs torch.cuda.max_memory_allocated %d" % (
            len(events), kinds, codes, dm_peak, peak))
    if not (passes == kernel_passes == splits and passes > 0):
        raise AssertionError("(W1) the summary's split passes %d, the "
                             "kernels' %d, the trees' splits %d"
                             % (passes, kernel_passes, splits))
    if counts["histogram"] != len(gbdt.models):
        raise AssertionError("(W1) %d root histograms for %d trees"
                             % (counts["histogram"], len(gbdt.models)))
    if codes != {"/metrics": 200, "/healthz": 200}:
        raise AssertionError("(W1) scrapes answered %s" % codes)
    if dm_peak != peak:
        raise AssertionError("(W1) devmem peak %s != max_memory_allocated "
                             "%d" % (dm_peak, peak))
    if trees_text(gbdt.save_model_to_string()) != trees_text(a_text):
        raise AssertionError("(W1) the trees differ from (A)'s")
    if obs.active() is not None:
        raise AssertionError("(W1) train() left its telemetry run open")
    log("  trees equal to (A)'s; the run closed, its summary at %s"
        % (out_path + ".summary.json"))
    return dict(launches=counts, trees=len(gbdt.models), s=secs,
                split_passes=passes, events=len(events), booster=gbdt,
                devmem_peak=dm_peak, summary=summary)


def _serve_requests(n_train: int, n_test: int, seed: int = 0) -> list:
    """(kind, source, start, rows) of the clients' requests: sizes 1..4096
    from a seeded RNG up to ``SERVE_ROWS`` rows, each raw held-out, raw
    training or binned training rows."""
    rng = np.random.RandomState(seed)
    out, total = [], 0
    while total < SERVE_ROWS:
        n = min(int(rng.randint(1, SERVE_MAX_REQUEST + 1)), SERVE_ROWS - total)
        src = ("test", "train", "binned")[rng.randint(3)]
        n = min(n, n_test if src == "test" else n_train)
        hi = (n_test if src == "test" else n_train) - n
        out.append((src, int(rng.randint(0, hi + 1)), n))
        total += n
    return out


def phase_serving(device, data, ds, a_gbdt, texts: dict, profile: bool
                  ) -> dict:
    """Path (W2): the serving tier (``lightgbm_tpu_torch.serve``) on the card
    with (A)'s trees each repeated ``PREDICT_REPEAT`` times (the Higgs
    model's 500 trees) resident as ``higgs``, (C)'s trees registered beside
    it under a residency budget between one and two models' bytes (one
    eviction: ``higgs`` goes, (C) is served and unregistered, and
    ``higgs`` is admitted again by the first request of the traffic), then
    ``SERVE_CLIENTS`` client threads submitting ``SERVE_ROWS`` held-out and
    training rows, raw and binned, in requests of 1-4096 rows, with one
    ``swap`` of ``higgs`` to (B)'s trees (repeated alike) under load (the
    last two fifths of the requests wait for it to return).  Every
    response equal to one ``FusedPredictor`` call over the same rows, of
    the old model or the new one (the new one for every request submitted
    after ``swap`` returned), zero drops, the miss gauge flat outside the
    warm-up and the swap; then ``SERVE_SINGLE_ROWS`` single-row requests
    through the compiled fast path."""
    import threading

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import Config, GBDT
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
    X, _, X_test, _ = data
    bins = ds.binned
    t_phase = time.perf_counter()
    higgs = repeated_model(a_gbdt, PREDICT_REPEAT, device)
    b_src = GBDT(Config(verbosity=-1), device=device)
    b_src.load_model_from_string(texts["B"])
    higgs_b = repeated_model(b_src, PREDICT_REPEAT, device)
    level = GBDT(Config(verbosity=-1), device=device)
    level.load_model_from_string(texts["C"])
    # the residency budget: the higgs model's bytes (raw and binned
    # predictors) plus half of (C)'s, so one fits and both do not
    from lightgbm_tpu_torch.serving import ModelRegistry
    probe = ModelRegistry(budget_mb=0, device=device)
    e = probe.register("h", higgs, layout_ds=ds)
    e.predict(bins[:8], kind="binned")
    e2 = probe.register("c", level, layout_ds=ds)
    e2.predict(bins[:8], kind="binned")
    h_bytes, c_bytes = e.resident_bytes, e2.resident_bytes
    probe.unregister("h")
    probe.unregister("c")
    del probe, e, e2
    budget_mb = (h_bytes + c_bytes / 2.0) / float(1 << 20)
    log("  (W2) resident bytes: higgs %d, (C) %d; budget %.3f MiB"
        % (h_bytes, c_bytes, budget_mb))
    out_path = os.path.join(SERVE_DIR, "serve.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launches()
    srv = lgb.serve({}, params=dict(
        max_batch_wait_us=500, serve_residency_budget_mb=budget_mb,
        telemetry_out=out_path, telemetry_freq=16), device=device)
    results = []
    try:
        srv.register("higgs", higgs, layout_ds=ds)
        srv.predict("higgs", X_test[:64], raw_score=True)      # warm-up
        srv.predict("higgs", bins[:64], binned=True, raw_score=True)
        srv.register("level", level, layout_ds=ds)             # evicts
        want_c = FusedPredictor(level.models, device=device)(X_test[:4096])
        got_c = srv.predict("level", X_test[:4096], raw_score=True)
        want_cb = FusedPredictor(level.models, dataset=ds, kind="binned",
                                 device=device)(bins[:4096])
        got_cb = srv.predict("level", bins[:4096], binned=True,
                             raw_score=True)
        if not (np.array_equal(got_c, want_c)
                and np.array_equal(got_cb, want_cb)):
            raise AssertionError("(W2) (C)'s responses differ from its "
                                 "FusedPredictor")
        srv.registry.unregister("level")
        base = obs.recompile.total()
        requests = _serve_requests(len(X), len(X_test))
        swapped = threading.Event()
        lock = threading.Lock()
        swap_misses = []

        def rows_of(src, lo, n):
            return (X_test if src == "test" else
                    bins if src == "binned" else X)[lo:lo + n]

        # the last two fifths of the requests wait for swap to return, so
        # that the new model serves some whatever the host's speed; the
        # first three fifths keep the server loaded during the swap
        split = len(requests) * 3 // 5

        def client(tid):
            pending = []
            for i in range(tid, len(requests), SERVE_CLIENTS):
                src, lo, n = requests[i]
                if i >= split and not swapped.wait(300):
                    raise AssertionError("(W2) swap did not return")
                after = swapped.is_set()
                t0 = time.perf_counter()
                fut = srv.submit("higgs", rows_of(src, lo, n),
                                 binned=src == "binned", raw_score=True)
                pending.append((i, after, t0, fut))
                if len(pending) >= SERVE_OUTSTANDING:
                    j, aft, t1, f = pending.pop(0)
                    res = f.result(120)
                    with lock:
                        results.append((j, aft, time.perf_counter() - t1,
                                        res))
            for j, aft, t1, f in pending:
                res = f.result(120)
                with lock:
                    results.append((j, aft, time.perf_counter() - t1, res))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_CLIENTS)]
        t_traffic = time.perf_counter()
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        while True:
            with lock:
                done = len(results)
            if done >= len(requests) * 2 // 5:
                break
            if time.monotonic() > deadline:
                raise AssertionError("(W2) %d of %d responses in 300 s"
                                     % (done, len(requests)))
            time.sleep(0.001)
        before = obs.recompile.total()
        t_swap = time.perf_counter()
        srv.swap("higgs", higgs_b, layout_ds=ds)
        swap_s = time.perf_counter() - t_swap
        swap_misses.append(obs.recompile.total() - before)
        swapped.set()
        for th in threads:
            th.join()
        traffic_s = time.perf_counter() - t_traffic
        torch.cuda.synchronize()
        misses = obs.recompile.total() - base
        stats = srv.stats()
        # the single-row fast path on the new generation
        srv.single_row_fast = True
        t_single = time.perf_counter()
        singles = [srv.predict("higgs", X_test[0], raw_score=True)]
        compile_s = time.perf_counter() - t_single   # the chain's build
        t_single = time.perf_counter()
        singles += [srv.predict("higgs", X_test[i], raw_score=True)
                    for i in range(1, SERVE_SINGLE_ROWS)]
        single_s = time.perf_counter() - t_single
        fast = srv.fast_served
        if profile:
            profile_serving(srv, X_test)
    finally:
        srv.close()
    peak = torch.cuda.max_memory_allocated()
    counts = D.launches()
    with open(out_path + ".summary.json") as fh:
        served = json.load(fh)["serving"]
    batch_ev = [e for e in obs.read_events(out_path)
                if e["kind"] == "serve_batch" and not e["fast"]
                and e["model"] == "higgs"]
    dispatch_s = sorted(e["dt_s"] for e in batch_ev)
    # checks: every response against one FusedPredictor call of its rows
    refs = {}
    for name, model in (("old", higgs), ("new", higgs_b)):
        refs[name] = (FusedPredictor(model.models, device=device),
                      FusedPredictor(model.models, dataset=ds, kind="binned",
                                     device=device))
    served_new = 0
    for i, after, _, got in results:
        src, lo, n = requests[i]
        raw_p, bin_p = refs["new"]
        want_new = (bin_p if src == "binned" else raw_p)(rows_of(src, lo, n))
        if np.array_equal(got, want_new):
            served_new += 1
            continue
        if after:
            raise AssertionError("(W2) request %d, submitted after swap "
                                 "returned, differs from the new model" % i)
        raw_p, bin_p = refs["old"]
        if not np.array_equal(got, (bin_p if src == "binned" else raw_p)(
                rows_of(src, lo, n))):
            raise AssertionError("(W2) request %d (%s, %d rows) equals "
                                 "neither generation" % (i, src, n))
    want_single = refs["new"][0](X_test[:SERVE_SINGLE_ROWS])
    if not np.array_equal(np.concatenate(singles), want_single):
        raise AssertionError("(W2) single-row responses differ")
    lat = np.array([r[2] for r in results])
    regs = stats["registry"]
    log("  %d requests, %d rows in %.3f s: %.1f rows/s; request latency "
        "p50 %.3f ms p99 %.3f ms; %d batches, mean %.1f rows a batch"
        % (len(results), SERVE_ROWS, traffic_s, SERVE_ROWS / traffic_s,
           1e3 * float(np.percentile(lat, 50)),
           1e3 * float(np.percentile(lat, 99)), stats["batches"],
           SERVE_ROWS / max(stats["batches"], 1)))
    log("  dispatch wall a batch (serve_batch events, %d batches): median "
        "%.3f ms, max %.3f ms; %.1f rows/s inside the dispatches"
        % (len(batch_ev), 1e3 * dispatch_s[len(dispatch_s) // 2],
           1e3 * dispatch_s[-1],
           sum(e["rows"] for e in batch_ev) / sum(dispatch_s)))
    log("  swap under load in %.3f s (%d misses, its stacking); %d responses"
        " from the new model; dropped %d, failed %d; evictions %d, "
        "re-admissions %d, swaps %d; misses outside the warm-up and the "
        "swap %d" % (swap_s, swap_misses[0], served_new, stats["dropped"],
                     stats["failed"], regs["evictions"], regs["readmits"],
                     regs["swaps"], misses - swap_misses[0]))
    log("  %d single-row requests through the fast path (%d fast): the "
        "first, with compile_single_row of %d trees, %.3f s, the other %d "
        "%.3f ms each; peak device memory %.1f MiB; launches %s; serving "
        "block batches %d, readmits %d"
        % (SERVE_SINGLE_ROWS, fast, len(higgs_b.models), compile_s,
           SERVE_SINGLE_ROWS - 1, 1e3 * single_s / (SERVE_SINGLE_ROWS - 1),
           peak / 2 ** 20, counts, served["batches"], served["readmits"]))
    if stats["dropped"] or stats["failed"] or len(results) != len(requests):
        raise AssertionError("(W2) dropped %d, failed %d, %d of %d answered"
                             % (stats["dropped"], stats["failed"],
                                len(results), len(requests)))
    if (regs["evictions"], regs["readmits"], regs["swaps"]) != (1, 1, 1):
        raise AssertionError("(W2) evictions %d, re-admissions %d, swaps %d"
                             % (regs["evictions"], regs["readmits"],
                                regs["swaps"]))
    late = sum(1 for r in results if r[1])
    if misses != swap_misses[0] or late < len(requests) - split:
        raise AssertionError("(W2) %d misses outside the swap; %d requests "
                             "submitted after it" % (misses - swap_misses[0],
                                                     late))
    if fast != SERVE_SINGLE_ROWS or any(counts.values()):
        raise AssertionError("(W2) fast path %d of %d, launches %s"
                             % (fast, SERVE_SINGLE_ROWS, counts))
    return dict(launches=counts, trees=0, rows=SERVE_ROWS, s=traffic_s,
                rows_per_s=SERVE_ROWS / traffic_s,
                p50_ms=1e3 * float(np.percentile(lat, 50)),
                p99_ms=1e3 * float(np.percentile(lat, 99)),
                requests=len(results), batches=stats["batches"],
                dispatch_median_ms=1e3 * dispatch_s[len(dispatch_s) // 2],
                mean_batch_rows=SERVE_ROWS / max(stats["batches"], 1),
                served_new=served_new, swap_s=swap_s, peak_bytes=peak,
                single_compile_s=compile_s,
                phase_s=time.perf_counter() - t_phase)


def profile_serving(srv, X_test) -> None:
    """16 dispatches of 4096 rows under ``torch.profiler``: the port's
    trace ranges (``serve_dispatch``, ``tree_block_predict``).  The
    profiler records the operators of the thread that started it, so the
    dispatches run here, through the dispatcher's own ``Server._run``."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.obs import annotate
    from lightgbm_tpu_torch.serving.scheduler import _BatchKey
    key = _BatchKey(model="higgs", kind="raw", num_iteration=-1,
                    start_iteration=0, margin=-1.0, freq=10, raw_score=True,
                    contrib=False, precision="exact")
    entry = srv.registry.acquire("higgs")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(16):
                with annotate("serve_dispatch"):
                    srv._run(entry, key, X_test[i * 4096:(i + 1) * 4096],
                             False)
            torch.cuda.synchronize()
    finally:
        srv.registry.release(entry)
    names = ("serve_dispatch", "tree_block_predict")
    events = prof.key_averages()
    for e in events:
        if any(n in e.key for n in names):
            log("  range %-20s calls %3d  cpu %.3f ms  device %.3f ms"
                % (e.key, e.count, e.cpu_time_total / 1e3,
                   e.device_time_total / 1e3))
    log(events.table(sort_by="cpu_time_total", row_limit=12))


def phase_serve_cli(device, data, gbdt) -> dict:
    """Path (W3): CLI ``task=serve`` on a CSV of (A)'s first 20,000
    held-out rows, equal line for line to ``task=predict``'s output (both
    in the f32 regime from 512 rows on)."""
    from lightgbm_tpu_torch import device as D
    from lightgbm_tpu_torch.cli import Application
    _, _, X_test, y_test = data
    n = min(SERVE_CLI_ROWS, len(X_test))
    model = os.path.join(SERVE_DIR, "model.txt")
    gbdt.save_model(model)
    csv = os.path.join(SERVE_DIR, "serve.csv")
    write_fixed_csv(csv, np.column_stack([y_test[:n], X_test[:n]]))
    outs = {}
    D.reset_launches()
    t = time.perf_counter()
    for task in ("predict", "serve"):
        outs[task] = os.path.join(SERVE_DIR, "%s.txt" % task)
        Application(["task=%s" % task, "data=%s" % csv,
                     "input_model=%s" % model,
                     "output_result=%s" % outs[task], "verbosity=-1",
                     "max_batch_wait_us=500"]).run()
    secs = time.perf_counter() - t
    counts = D.launches()
    with open(outs["predict"]) as a, open(outs["serve"]) as b:
        pa, pb = a.read().splitlines(), b.read().splitlines()
    log("  (W3) CLI task=predict and task=serve on %d rows: %d and %d lines,"
        " %d differ; %.2f s; launches %s"
        % (n, len(pa), len(pb), sum(x != y for x, y in zip(pa, pb)), secs,
           counts))
    if not (pa == pb and len(pa) == n):
        raise AssertionError("(W3) task=serve's output differs from "
                             "task=predict's")
    return dict(launches=counts, trees=0, s=secs)


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


# ------------- path (X): the planner, MFU, alerts and captures, the online
# ------------- loop and compaction, on the card

PLAN_DIR = os.path.join("build", "plan")
ONLINE_DIR = os.path.join("build", "online")
TUNE_REPS = 4
ONLINE_BASE_ROWS = 524_288      # (X4): the base model's rows of (A)'s task
ONLINE_BASE_ITERS = 10
ONLINE_WINDOW_ROWS = 131_072    # the other 524,288 rows, 4 windows
ONLINE_WINDOWS = 4
ONLINE_ROUNDS = 5
ONLINE_REFIT_WINDOW = 2         # (X4): the 0-based window refit, not extended
ONLINE_SHIFT = 4.0              # (X4): feature 0 of the last window, shifted
ONLINE_CLIENTS = 8
COMPACT_ROWS = 262_144          # (X5): held-out rows
COMPACT_SERVED_ROWS = 16_384    # (X5): the rows the swap's traffic draws
ALERT_P99_S = 1.0               # (X3): the p99 the swap's first dispatch breaks
ALERT_SWAP_REPEAT = 300         # (X3): (B)'s trees x300 stack in seconds
# (X3): kernels a profiler capture during a train() must name
CAPTURE_KERNELS = ("hist_seg_kernel", "part_count_kernel",
                   "part_scatter_kernel")


def _plan_recorder(booster):
    """Route ``booster``'s learner through split passes that keep what they
    produce: every launch's left counts and the row store the last one
    wrote.  Returns the record."""
    import functools
    from lightgbm_tpu_torch.core import partition as PT
    rec = {"nl": [], "store": None}

    def part(rows, scal, **kw):
        out = PT.partition_hist(rows, scal, **kw)
        rec["nl"].append(out[2])
        rec["store"] = out[0]
        return out

    def level(src, dst, scals, **kw):
        out = PT.partition_hist_level(src, dst, scals, **kw)
        rec["nl"].append(out[1])
        rec["store"] = dst
        return out

    learner = booster.learner
    learner.train = functools.partial(learner.train, part_fn=part,
                                      level_fn=level)
    return rec


def grow_one_tree(ds, extra: dict) -> dict:
    """One iteration of (A)'s settings plus ``extra`` on (A)'s bins, under
    whatever plan is pinned: the model text, the learner's plan, its left
    counts and its final row store (on the host)."""
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    cfg = Config(dict(HIGGS_PARAMS, **extra))
    booster = GBDT(cfg, ds, create_objective("binary", cfg))
    rec = _plan_recorder(booster)
    booster.train_one_iter()
    torch.cuda.synchronize()
    return dict(text=trees_text(booster.save_model_to_string()),
                plan=booster.learner.plan,
                nl=torch.cat([t.reshape(-1) for t in rec["nl"]]).cpu(),
                store=rec["store"].cpu())


def phase_planner(device, data, ds, iters: int, a_text: str,
                  c_text: str) -> dict:
    """(X1): the kernel planner.  ``resolve`` at (A)'s and (C)'s shape
    classes gives the analytic plan (today's constants); ``run_sweep``
    tunes both classes (``TUNE_REPS`` reps, CUDA events) and writes the
    cache, printing each candidate's tree and walk times; under every
    candidate pinned, (A)'s and (C)'s first trees are byte-equal to the
    analytic plan's (model text, left counts of every split pass, the final
    row store) and (A)'s predictions under the walk budgets equal; then
    ``train()`` with ``plan_cache`` set to the cache is byte-equal to (A)
    with provenance ``tuned`` and no fallback, and a corrupt cache gives one
    warning, the counter at 1 and the analytic plan."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import Config, GBDT, create_objective
    from lightgbm_tpu_torch.plan import autotune, planner
    from lightgbm_tpu_torch.plan import cache as plan_cache
    from lightgbm_tpu_torch.plan import state as plan_state
    from lightgbm_tpu_torch.utils.log import Log
    X, y, X_test, _ = data
    os.makedirs(PLAN_DIR, exist_ok=True)
    plan_state.reset()
    plan_cache.reset_fallbacks()
    classes = {}
    for path, extra in (("A", {}), ("C", PATHS["C"][1])):
        cfg = Config(dict(HIGGS_PARAMS, **extra))
        learner = GBDT(cfg, ds, create_objective("binary", cfg)).learner
        sc = learner.plan_shape()
        if learner.plan != planner.analytic_plan(sc):
            raise AssertionError("(X1) resolve at (%s)'s class gave %s"
                                 % (path, learner.plan))
        classes[path] = sc
        log("  (X1) (%s) %s: key %s, analytic plan %s" % (
            path, learner.effective_grow_mode(), planner.plan_key(sc),
            learner.plan))
    cache_path = os.path.join(PLAN_DIR, "plan_cache.json")

    def progress(sc, res):
        for row in res["candidates"]:
            log("  (X1) %s %-12s tree %s s, walk %s s" % (
                res["key"], row["name"],
                "%.6f" % row["train_steady_p50_s"]
                if row.get("train_steady_p50_s") is not None else "-",
                "%.6f" % row["predict_steady_p50_s"]
                if row.get("predict_steady_p50_s") is not None else "-"))
        log("  (X1) %s winner %s, margins %s" % (
            res["key"], res["winner"]["name"], res["margin"]))

    t = time.perf_counter()
    sweep = autotune.run_sweep(list(classes.values()), cache_path=cache_path,
                               reps=TUNE_REPS, device=device,
                               progress=progress)
    tune_s = time.perf_counter() - t
    # every distinct candidate of either class, pinned, on (A) and (C)
    cands = {}
    for sc in classes.values():
        for cand in autotune.candidate_plans(sc):
            cands.setdefault(cand.name, cand.plan)
    ref = {p: grow_one_tree(ds, PATHS[p][1]) for p in ("A", "C")}
    ref_raw = None
    for name, plan in cands.items():
        with plan_state.pinned(plan):
            for p in ("A", "C"):
                got = grow_one_tree(ds, PATHS[p][1])
                if got["plan"].provenance != "pinned":
                    raise AssertionError("(X1) %s not pinned" % name)
                same = (got["text"] == ref[p]["text"]
                        and torch.equal(got["nl"], ref[p]["nl"])
                        and torch.equal(got["store"], ref[p]["store"]))
                if not same:
                    raise AssertionError(
                        "(X1) candidate %s changed (%s)'s tree (text %s, "
                        "left counts %s, row store %s)" % (
                            name, p, got["text"] == ref[p]["text"],
                            torch.equal(got["nl"], ref[p]["nl"]),
                            torch.equal(got["store"], ref[p]["store"])))
            a = GBDT(Config(HIGGS_PARAMS), device=device)
            a.load_model_from_string(a_text)
            raw = a.predict(X_test, raw_score=True)
            if ref_raw is None:
                ref_raw = raw
            elif not np.array_equal(raw, ref_raw):
                raise AssertionError("(X1) candidate %s changed (A)'s "
                                     "predictions" % name)
    log("  (X1) %d candidates pinned: (A)'s and (C)'s trees, %d and %d "
        "left counts and the row stores byte-equal to the analytic plan's; "
        "(A)'s predictions on %d rows equal" % (
            len(cands), ref["A"]["nl"].numel(), ref["C"]["nl"].numel(),
            len(X_test)))
    # the tuned cache through train()
    out_path = os.path.join(PLAN_DIR, "tuned.jsonl")
    train = lgb.Dataset(X, y)
    train.handle = ds
    booster = lgb.train(dict(HIGGS_PARAMS, plan_cache=cache_path,
                             telemetry_out=out_path), train,
                        num_boost_round=iters, verbose_eval=False)
    with open(out_path + ".summary.json") as fh:
        summary = json.load(fh)
    plan = summary.get("plan") or {}
    if trees_text(booster.model_to_string()) != trees_text(a_text):
        raise AssertionError("(X1) train() with the tuned cache differs "
                             "from (A)")
    if (plan.get("provenance"), plan.get("cache_fallbacks")) != ("tuned", 0):
        raise AssertionError("(X1) the summary's plan block %s" % plan)
    tuned = booster._booster.learner.plan
    log("  (X1) train() with plan_cache: trees equal to (A)'s, summary plan "
        "%s, fallbacks %d, the learner's plan %s" % (
            plan["sites"], plan["cache_fallbacks"], tuned))
    # a corrupt cache
    plan_state.reset()
    plan_cache.reset_fallbacks()
    bad = os.path.join(PLAN_DIR, "corrupt.json")
    with open(bad, "w") as fh:
        fh.write("{ not json")
    warned = []
    real_warning = Log.warning

    def counting(msg, *a):
        if "plan cache" in str(msg):
            warned.append(msg)
        real_warning(msg, *a)
    Log.warning = staticmethod(counting)
    try:
        engaged = (plan_state.configure(bad), plan_state.configure(bad))
    finally:
        Log.warning = staticmethod(real_warning)
    sc = classes["A"]
    got = plan_state.resolve(*sc[:3], bpc=sc.bpc, packed=sc.packed,
                             device_kind=sc.device_kind)
    if (engaged != (None, None) or plan_cache.fallback_count() != 2
            or len(warned) != 1 or got != planner.analytic_plan(sc)):
        raise AssertionError("(X1) corrupt cache: engaged %s, fallbacks "
                             "%d, warnings %d, plan %s" % (
                                 engaged, plan_cache.fallback_count(),
                                 len(warned), got))
    log("  (X1) a corrupt cache, engaged twice: one warning, "
        "plan_cache_fallbacks 2, the analytic plan")
    plan_state.reset()
    plan_cache.reset_fallbacks()
    return dict(tune_s=tune_s, sweep=sweep, candidates=len(cands),
                tuned=tuned._asdict())


def phase_mfu(w1: dict) -> dict:
    """(X2): (W1)'s ``train()`` summary carries the cost model's estimate
    over the port's kernels: 0 < ``device_util`` <= 1 and ``est_bytes /
    wall / 3.35e12`` equal to it."""
    s = w1["summary"]
    g = s["gauges"]
    wall = g["train_wall_s"]
    util, mfu = s.get("device_util"), s.get("mfu")
    log("  (X2) (W1)'s summary: wall %.4f s, est_bytes %.6g, est_macs %.6g, "
        "device_util %s, mfu %s" % (wall, g.get("est_bytes", 0),
                                    g.get("est_macs", 0), util, mfu))
    if util is None or not 0 < util <= 1 or mfu is None or not 0 < mfu <= 1:
        raise AssertionError("(X2) device_util %s, mfu %s" % (util, mfu))
    want = g["est_bytes"] / wall / HBM_BYTES_PER_S
    if abs(want - util) > 1e-12 * max(want, 1e-30):
        raise AssertionError("(X2) est_bytes / wall / 3.35e12 = %.9g, "
                             "device_util %.9g" % (want, util))
    return dict(device_util=util, mfu=mfu, est_bytes=g["est_bytes"],
                est_macs=g["est_macs"], wall_s=wall)


def _latency_traffic(srv, name, X, stop, out, seed, binned=None):
    """One client: requests of 1-4096 rows (from a seeded RNG) of the raw
    rows ``X``, or every other one of the row store ``binned``, four in
    flight, until ``stop`` is set; (start, n, t_submit, t_done, response)
    of the raw requests into ``out``."""
    rng = np.random.RandomState(seed)
    pending = []
    k = 0
    while not stop.is_set() or pending:
        while not stop.is_set() and len(pending) < SERVE_OUTSTANDING:
            n = int(rng.randint(1, SERVE_MAX_REQUEST + 1))
            k += 1
            if binned is not None and k % 2:
                lo = int(rng.randint(0, len(binned) - n + 1))
                fut = srv.submit(name, binned[lo:lo + n], binned=True,
                                 raw_score=True)
                pending.append((None, n, time.perf_counter(), fut))
                continue
            lo = int(rng.randint(0, len(X) - n + 1))
            pending.append((lo, n, time.perf_counter(),
                            srv.submit(name, X[lo:lo + n], raw_score=True)))
        lo, n, t0, fut = pending.pop(0)
        res = fut.result(timeout=600)
        if lo is not None:
            out.append((lo, n, t0, time.perf_counter(), res))


def phase_alert_serving(device, data, ds, texts: dict) -> tuple:
    """(X3), the alert: ``serve`` with ``alert_rules`` (a p99 rule on the
    served latency, ``ALERT_P99_S``, fast 2 s and slow 4 s windows) over
    (A)'s trees x100 as ``higgs`` with (A)'s bin layout, warmed (raw and
    binned) before any request; clients send raw held-out rows and binned
    training rows; the swap to (B)'s trees x``ALERT_SWAP_REPEAT`` without
    warm-up makes the first binned dispatch stack them (a Python loop over
    their nodes, on the dispatcher thread) under load, so every request
    in flight waits for it: the rule fires (read from ``/alerts``) and,
    once traffic stops and its samples leave both windows, resolves.
    Returns the numbers, the server (still serving, for (X5)'s swap) and
    its telemetry path."""
    import threading
    import urllib.request
    import lightgbm_tpu_torch as lgb
    X_test = data[2]
    os.makedirs(SERVE_DIR, exist_ok=True)
    out = {}
    # --- a p99 rule that the swap breaks
    rules = os.path.join(SERVE_DIR, "rules.json")
    with open(rules, "w") as fh:
        json.dump([{"name": "serve_p99", "kind": "quantile",
                    "metric": "serve_latency_s_model_*", "quantile": "p99",
                    "max": ALERT_P99_S, "budget": 0.0, "fast_window_s": 2.0,
                    "slow_window_s": 4.0, "severity": "page",
                    "capture": False}], fh)
    port = free_port()
    tele_out = os.path.join(SERVE_DIR, "alerts.jsonl")
    higgs = repeated_model_text(texts["A"], PREDICT_REPEAT, device)
    higgs_b = repeated_model_text(texts["B"], ALERT_SWAP_REPEAT, device)
    srv = lgb.serve({}, dict(HIGGS_PARAMS, telemetry_out=tele_out,
                             metrics_port=port, alert_rules=rules,
                             alert_interval_s=0.1),
                    device=device)
    # stacked before any request: no request waits for it
    srv.register("higgs", higgs, layout_ds=ds).warm()

    def alerts_now():
        with urllib.request.urlopen("http://127.0.0.1:%d/alerts" % port,
                                    timeout=30) as r:
            return json.loads(r.read())

    stop = threading.Event()
    done = []
    store = ds.binned
    clients = [threading.Thread(target=_latency_traffic,
                                args=(srv, "higgs", X_test, stop, done, s,
                                      store))
               for s in range(SERVE_CLIENTS)]
    for c in clients:
        c.start()
    # a short warm traffic: the rule judges the run's cumulative p99, which
    # the requests behind the swap's stacking must move past ALERT_P99_S
    time.sleep(1.0)
    before = alerts_now()
    t_swap = time.perf_counter()
    srv.swap("higgs", higgs_b, layout_ds=ds, warm=False)
    swap_s = time.perf_counter() - t_swap
    fired = None
    deadline = time.time() + 30
    while time.time() < deadline:
        body = alerts_now()
        if body.get("firing"):
            fired = body
            break
        time.sleep(0.1)
    stop.set()
    for c in clients:
        c.join(600)
    lat = np.array([d[3] - d[2] for d in done])
    resolved = None
    deadline = time.time() + 30
    while time.time() < deadline:
        body = alerts_now()
        if body.get("fired_total") and not body.get("firing"):
            resolved = body
            break
        time.sleep(0.1)
    log("  (X3) serve with alert_rules: %d raw requests, p50 %.3f ms, p99 "
        "%.3f ms, max %.3f ms; swap without warm-up %.3f s; /alerts before "
        "%s firing, then %s, after the traffic %s" % (
            len(done), np.percentile(lat, 50) * 1e3,
            np.percentile(lat, 99) * 1e3, lat.max() * 1e3, swap_s,
            before.get("firing"),
            fired and [(s["rule"], s["state"], s["value"])
                       for s in fired["series"]],
            resolved and [(s["rule"], s["state"]) for s in
                          resolved["series"]]))
    if before.get("firing") or fired is None or resolved is None:
        raise AssertionError("(X3) the p99 rule: before %s, fired %s, "
                             "resolved %s" % (before, fired, resolved))
    out["alert"] = dict(requests=len(done),
                        p50_ms=float(np.percentile(lat, 50) * 1e3),
                        p99_ms=float(np.percentile(lat, 99) * 1e3),
                        swap_s=swap_s)
    return out, srv, tele_out


def phase_captures(device, data, ds, iters: int) -> dict:
    """(X3), the captures: ``/debug/profile?seconds=2`` during a
    ``train()`` of (A)'s task writes a Chrome trace naming the port's
    kernels (``CAPTURE_KERNELS``); two forced watchdog stalls fire the
    flight recorder once (the second stall takes no capture)."""
    import threading
    import urllib.request
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs, resilience
    from lightgbm_tpu_torch.obs import profiling
    X, y, _, _ = data
    os.makedirs(SERVE_DIR, exist_ok=True)
    out = {}
    # --- /debug/profile during a train()
    prof_out = os.path.join(SERVE_DIR, "profiled.jsonl")
    prof_port = free_port()
    captured = {}

    def grab(env):
        if env.iteration == 1 and not captured:
            def get():
                with urllib.request.urlopen(
                        "http://127.0.0.1:%d/debug/profile?seconds=2"
                        % prof_port, timeout=120) as r:
                    captured.update(json.loads(r.read()))
            captured["thread"] = threading.Thread(target=get)
            captured["thread"].start()

    train = lgb.Dataset(X, y)
    train.handle = ds
    lgb.train(dict(HIGGS_PARAMS, telemetry_out=prof_out,
                   metrics_port=prof_port), train,
              num_boost_round=iters, verbose_eval=False, callbacks=[grab])
    captured.pop("thread").join(120)
    names = set()
    if captured.get("trace"):
        with open(captured["trace"]) as fh:
            trace = json.load(fh)
        names = {e.get("name", "") for e in trace.get("traceEvents", [])
                 if e.get("cat") == "kernel"}
    ours = sorted({k for k in CAPTURE_KERNELS
                   if any(k in n for n in names)})
    log("  (X3) /debug/profile?seconds=2 during train(): %s, %d kernel "
        "names in the trace, the port's: %s" % (
            captured.get("trace") or captured.get("error"), len(names),
            ours))
    if len(ours) != len(CAPTURE_KERNELS):
        raise AssertionError("(X3) the capture %s names %s" % (captured,
                                                              ours))
    # --- the flight recorder, fired by a forced watchdog stall
    tele = obs.configure(out=os.path.join(SERVE_DIR, "stall.jsonl"),
                         flight_recorder=True)
    stalls = []
    for i in range(2):
        # the watchdog is one-shot: a fresh one for each stall
        resilience.start_watchdog(0.5, abort=False, on_stall=stalls.append)
        try:
            t0 = time.monotonic()
            with resilience.watch("forced_stall", iteration=i):
                while len(stalls) <= i and time.monotonic() - t0 < 120:
                    time.sleep(0.05)
        finally:
            resilience.stop_watchdog()
            resilience.clear_stall()
    st = profiling.state(tele)
    caps = list(st.captures) if st is not None else []
    fired_alerts = tele.counter("alerts_fired").value
    obs.disable()
    log("  (X3) two forced watchdog stalls: %d stall(s), alerts_fired %d, "
        "flight recorder captures %s" % (
            len(stalls), fired_alerts,
            [(c["reason"], c.get("trace") or c.get("error"))
             for c in caps]))
    if (len(stalls) != 2 or fired_alerts != 2 or len(caps) != 1
            or caps[0]["reason"] != "watchdog_stall"
            or not os.path.exists(caps[0].get("trace", ""))):
        raise AssertionError("(X3) flight recorder: stalls %d, alerts %d, "
                             "captures %s" % (len(stalls), fired_alerts,
                                              caps))
    out["capture_kernels"] = ours
    return out


def repeated_model_text(text: str, repeat: int, device):
    """A GBDT on ``device`` holding the trees of model ``text``, each
    repeated ``repeat`` times in order (the Higgs model's size from (A)'s
    5 trees)."""
    from lightgbm_tpu_torch import Config, GBDT
    big = GBDT(Config(HIGGS_PARAMS), device=device)
    big.load_model_from_string(text)
    big.models = [t for t in big.models for _ in range(repeat)]
    big._invalidate_predict_cache()
    return big


def phase_compaction(device, srv, ds, texts: dict, tele_out: str) -> dict:
    """(X5): ``compact_booster`` on the 500-tree Higgs model (``leaf_codes
    = 255``): the measured ``max_score_delta`` on ``COMPACT_ROWS`` held-out
    rows at most the declared bound, the AUC delta and the node and byte
    reductions; the compacted generation swapped into (X3)'s registry under
    load (requests over the first ``COMPACT_SERVED_ROWS`` of those rows),
    its served scores equal to its CPU predictions from the same text
    within the f32 bound of :func:`host_sums` (and counted where equal bit
    for bit).  Closes (X3)'s server, whose summary carries the alert."""
    import threading
    from lightgbm_tpu_torch import Config, GBDT
    from lightgbm_tpu_torch.core.compact import (compact_booster,
                                                 measure_compaction)
    Xh, yh, _, _ = synthetic_task(COMPACT_ROWS, seed=1)
    higgs = repeated_model_text(texts["A"], PREDICT_REPEAT, device)
    t = time.perf_counter()
    gen, st = compact_booster(higgs, leaf_codes=255)
    compact_s = time.perf_counter() - t
    meas = measure_compaction(higgs, gen, Xh, yh)
    log("  (X5) compact_booster(leaf_codes=255) of %d trees in %.2f s: nodes "
        "%d -> %d (%.4f), predictor bytes %d -> %d (%.4f), model text %d -> "
        "%d bytes; on %d held-out rows max_score_delta %.6g (declared bound "
        "%.6g), AUC %.6f -> %.6f (delta %.3g)" % (
            st["trees"], compact_s, st["nodes_in"], st["nodes_out"],
            st["tree_reduction"], st["bytes_in"], st["bytes_out"],
            st["byte_reduction"], st["model_bytes_in"],
            st["model_bytes_out"], meas["rows"], meas["max_score_delta"],
            st["declared_max_score_delta"], meas["auc_in"],
            meas["auc_out"], meas["auc_delta"]))
    if not meas["max_score_delta"] <= st["declared_max_score_delta"]:
        raise AssertionError("(X5) max_score_delta %.6g over the declared "
                             "bound %.6g" % (meas["max_score_delta"],
                                             st["declared_max_score_delta"]))
    # the compacted generation swapped in under load
    stop = threading.Event()
    done = []
    Xs = Xh[:COMPACT_SERVED_ROWS]
    clients = [threading.Thread(target=_latency_traffic,
                                args=(srv, "higgs", Xs, stop, done, 100 + s))
               for s in range(SERVE_CLIENTS)]
    for c in clients:
        c.start()
    time.sleep(1.0)
    t_swap = time.perf_counter()
    srv.swap("higgs", gen, layout_ds=ds)
    swapped = time.perf_counter()
    time.sleep(2.0)
    stop.set()
    for c in clients:
        c.join(600)
    stats = srv.stats()
    srv.close()
    after = [d for d in done if d[2] > swapped]
    # each row once: the CPU predictions and the f32 bound of the rows the
    # responses after the swap carried
    cpu = GBDT(Config(HIGGS_PARAMS), device="cpu")
    cpu.load_model_from_string(gen.save_model_to_string())
    lo_all = np.concatenate([np.arange(lo, lo + n) for lo, n, *_ in after])
    rows, inverse = np.unique(lo_all, return_inverse=True)
    want = cpu.predict(Xs[rows], raw_score=True)
    _, bound = host_sums(gen.models, np.asarray(Xs[rows], np.float32)
                         .astype(np.float64), 1)
    got = np.concatenate([np.asarray(d[4], np.float64).ravel()
                          for d in after])
    err = np.abs(got - want[inverse])
    bound = bound[inverse]
    with open(tele_out + ".summary.json") as fh:
        summary = json.load(fh)
    log("  (X5) swap of the compacted generation under load %.3f s; %d "
        "responses after it: vs the CPU predictions max|diff| %.3g (f32 "
        "bound up to %.3g), %d of %d values equal bit for bit; drops %d; "
        "(X3)'s summary: alerts fired %s" % (
            swapped - t_swap, len(after), float(err.max()),
            float(bound.max()), int((err == 0).sum()), err.size,
            stats["dropped"], summary.get("alerts", {}).get("fired_total")))
    if not after or not (err <= bound[:, 0]).all() or stats["dropped"]:
        raise AssertionError("(X5) served compacted scores: %d responses, "
                             "max|diff| %.3g, drops %d" % (
                                 len(after), float(err.max()),
                                 stats["dropped"]))
    if not summary.get("alerts", {}).get("fired_total"):
        raise AssertionError("(X3) the summary's alerts block %s"
                             % summary.get("alerts"))
    return dict(stats={k: st[k] for k in (
        "trees", "nodes_in", "nodes_out", "tree_reduction", "bytes_in",
        "bytes_out", "byte_reduction", "declared_max_score_delta")},
        measured=meas, compact_s=compact_s, served=len(after),
        bit_equal=int((err == 0).sum()), values=err.size)


def phase_online(device, data) -> dict:
    """(X4): the train-while-serve loop.  The base model is (A)'s task
    trained on the first ``ONLINE_BASE_ROWS`` rows for
    ``ONLINE_BASE_ITERS`` iterations; ``serve_and_train`` serves it to
    ``ONLINE_CLIENTS`` client threads while the other rows come in as
    ``ONLINE_WINDOWS`` windows (``online_min_rows`` = one window,
    ``online_rounds`` = ``ONLINE_ROUNDS``; window ``ONLINE_REFIT_WINDOW``
    refits instead of extending; the last one's feature 0 shifted, served
    before it is ingested, so the drift trigger fires).  Checks: at least
    3 generations, no drop, every response equal to the generation that
    served it (its ``FusedPredictor`` over the rows; a response in flight
    across a publish equals one of the two), every extended generation's
    trees byte-equal to a checkpoint-resume from the same boundary on the
    same window, ``rows_behind`` 0 after each publish; prints p50/p99
    latency, apart and across publishes."""
    import copy
    import threading
    from lightgbm_tpu_torch import (BinnedDataset, Config, GBDT,
                                    create_objective, obs, serve_and_train)
    from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
    X, y, X_test, _ = data
    os.makedirs(ONLINE_DIR, exist_ok=True)
    nb = ONLINE_BASE_ROWS
    t = time.perf_counter()
    base_ds = BinnedDataset.from_matrix(X[:nb], label=y[:nb], max_bin=255)
    cfg = Config(dict(HIGGS_PARAMS, num_iterations=ONLINE_BASE_ITERS))
    booster = GBDT(cfg, base_ds, create_objective("binary", cfg))
    booster.train()
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t
    shifted = X_test.copy()
    shifted[:, 0] += ONLINE_SHIFT
    tele_out = os.path.join(ONLINE_DIR, "online.jsonl")
    ctrl = serve_and_train(
        booster, train_set=base_ds, name="higgs_online",
        params=dict(HIGGS_PARAMS, telemetry_out=tele_out,
                    online_min_rows=ONLINE_WINDOW_ROWS,
                    online_rounds=ONLINE_ROUNDS, online_drift_trigger=True,
                    online_poll_s=0.05),
        device=device)
    # what each cycle did: the boundary checkpoint and window of an
    # extended cycle, and every published generation with its live span
    cycles, gens = [], []
    trainer = ctrl.booster
    real_train = trainer.train
    real_freeze = ctrl._freeze_generation

    def train_from_boundary(snapshot_out=None):
        prefix = os.path.join(ONLINE_DIR, "cycle%d" % len(cycles))
        trainer.save_checkpoint(prefix)
        boundary = trainer.iter_
        real_train(snapshot_out=snapshot_out)
        cycles.append(dict(prefix=prefix, ds=ctrl._last_window_ds,
                           boundary=boundary,
                           target=int(trainer.config.num_iterations),
                           text=trees_text(
                               trainer.save_model_to_string())))

    real_publish = ctrl._publish

    def freeze():
        gen, text = real_freeze()
        gens.append(dict(text=text, t0=time.perf_counter()))
        return gen, text

    def publish():
        real_publish()
        gens[-1]["t1"] = time.perf_counter()      # the swap returned
    trainer.train = train_from_boundary
    ctrl._freeze_generation = freeze
    ctrl._publish = publish
    # the generation published by start(), before the wrappers
    gens.insert(0, dict(text=booster.save_model_to_string(), t0=0.0,
                        t1=0.0))
    stop = threading.Event()
    source = {"rows": X_test}
    done = []

    def client(seed):
        rng = np.random.RandomState(seed)
        pending = []
        while not stop.is_set() or pending:
            while not stop.is_set() and len(pending) < SERVE_OUTSTANDING:
                n = int(rng.randint(1, SERVE_MAX_REQUEST + 1))
                lo = int(rng.randint(0, len(X_test) - n + 1))
                rows = source["rows"]
                pending.append((rows is shifted, lo, n, time.perf_counter(),
                                ctrl.submit(rows[lo:lo + n],
                                            raw_score=True)))
            sh, lo, n, t0, fut = pending.pop(0)
            done.append((sh, lo, n, t0, fut.result(timeout=600),
                         time.perf_counter()))

    threads = [threading.Thread(target=client, args=(200 + s,))
               for s in range(ONLINE_CLIENTS)]
    for th in threads:
        th.start()
    behind_after, triggers = [], []
    t_loop = time.perf_counter()
    try:
        for w in range(ONLINE_WINDOWS):
            lo = nb + w * ONLINE_WINDOW_ROWS
            Xw = X[lo:lo + ONLINE_WINDOW_ROWS].astype(np.float64)
            if w == ONLINE_WINDOWS - 1:
                # shifted traffic reaches the quality monitor first
                source["rows"] = shifted
                Xw = Xw.copy()
                Xw[:, 0] += ONLINE_SHIFT
                time.sleep(2.0)
            ctrl.update_mode = ("refit" if w == ONLINE_REFIT_WINDOW
                                else "extend")
            gen0 = ctrl.generation
            ctrl.ingest(Xw, y[lo:lo + ONLINE_WINDOW_ROWS])
            deadline = time.time() + 600
            while ctrl.generation == gen0 and time.time() < deadline:
                if ctrl.cycle_failures:
                    raise AssertionError("(X4) cycle failed: %s"
                                         % ctrl.last_error)
                time.sleep(0.02)
            behind_after.append(ctrl.buffer.rows_behind())
            triggers.append(ctrl.last_trigger)
            time.sleep(0.5)
    finally:
        stop.set()
        for th in threads:
            th.join(600)
        loop_s = time.perf_counter() - t_loop
        stats = ctrl.stats()
        ctrl.close()
    with open(tele_out + ".summary.json") as fh:
        summary = json.load(fh)
    # every response against the generations live while it was in flight
    preds = []
    for g in gens:
        m = GBDT(Config(HIGGS_PARAMS), device=device)
        m.load_model_from_string(g["text"])
        fp = FusedPredictor(m.models, device=device)
        preds.append((np.asarray(fp(X_test), np.float64).ravel(),
                      np.asarray(fp(shifted), np.float64).ravel()))
    # generation i serves from its freeze until the next swap returns
    ends = [g["t1"] for g in gens[1:]] + [float("inf")]
    wrong, across = 0, []
    for sh, lo, n, t0, res, t1 in done:
        live = [i for i in range(len(gens))
                if gens[i]["t0"] <= t1 and ends[i] >= t0]
        res = np.asarray(res, np.float64).ravel()
        if not any(np.array_equal(res, preds[i][int(sh)][lo:lo + n])
                   for i in live):
            wrong += 1
        if len(live) > 1:
            across.append(t1 - t0)
    lat = np.array([d[5] - d[3] for d in done])
    # each extended generation against checkpoint-resume on its window
    resumed = 0
    for c in cycles:
        fresh = GBDT(copy.copy(trainer.config), c["ds"],
                     create_objective("binary", trainer.config))
        if fresh.resume_from_checkpoint(c["prefix"]) != c["boundary"]:
            raise AssertionError("(X4) checkpoint %s did not restore "
                                 "iteration %d" % (c["prefix"],
                                                   c["boundary"]))
        fresh.config.num_iterations = c["target"]
        fresh.train()
        if trees_text(fresh.save_model_to_string()) != c["text"]:
            raise AssertionError("(X4) the generation extended from "
                                 "iteration %d differs from checkpoint-"
                                 "resume" % c["boundary"])
        resumed += 1
    onl = summary.get("online", {})
    log("  (X4) base model: %d rows, %d iterations in %.2f s; %d windows of "
        "%d rows in %.2f s: triggers %s, rows_behind after each publish "
        "%s, %d generations, %d cycles (%s), %d iterations" % (
            nb, ONLINE_BASE_ITERS, base_s, ONLINE_WINDOWS,
            ONLINE_WINDOW_ROWS, loop_s, triggers, behind_after,
            stats["generation"], stats["cycles"], onl.get("triggers"),
            stats["iterations"]))
    log("  (X4) %d responses (%d shifted), %d not equal to their "
        "generation; latency p50 %.3f ms, p99 %.3f ms; %d in flight across "
        "a publish: p50 %.3f ms, p99 %.3f ms; drops %d; %d extended "
        "generations byte-equal to checkpoint-resume" % (
            len(done), sum(d[0] for d in done), wrong,
            np.percentile(lat, 50) * 1e3, np.percentile(lat, 99) * 1e3,
            len(across), np.percentile(across, 50) * 1e3 if across else 0,
            np.percentile(across, 99) * 1e3 if across else 0,
            stats["serving"]["dropped"], resumed))
    if (stats["generation"] < 3 or stats["serving"]["dropped"] or wrong
            or any(behind_after) or triggers[-1] != "drift"
            or resumed != ONLINE_WINDOWS - 1 or not done):
        raise AssertionError("(X4) generations %d, drops %d, wrong %d, "
                             "rows_behind %s, triggers %s, resumed %d" % (
                                 stats["generation"],
                                 stats["serving"]["dropped"], wrong,
                                 behind_after, triggers, resumed))
    if obs.active() is not None:
        raise AssertionError("(X4) the online run stayed open")
    return dict(generations=stats["generation"], cycles=stats["cycles"],
                triggers=triggers, responses=len(done),
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                across=len(across),
                across_p99_ms=float(np.percentile(across, 99) * 1e3)
                if across else None, resumed=resumed, base_s=base_s,
                loop_s=loop_s)


def phase_path_x(device, data, ds, texts: dict, iters: int,
                 w1: dict) -> dict:
    """Path (X), with the kernels' launch counts set to 0 just before it
    and read just after: (X1)-(X5)."""
    from lightgbm_tpu_torch import device as D
    t = time.perf_counter()
    D.reset_launches()
    secs = {}

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return res

    out = {"X1": timed_phase("X1", phase_planner, device, data, ds, iters,
                             texts["A"], texts["C"])}
    out["X2"] = phase_mfu(w1)
    # the serving run stays the process's telemetry run until (X5) closes
    # its server; the captures open runs of their own after it
    x3, srv, tele_out = timed_phase("X3 alert", phase_alert_serving,
                                    device, data, ds, texts)
    out["X5"] = timed_phase("X5", phase_compaction, device, srv, ds, texts,
                            tele_out)
    x3.update(timed_phase("X3 captures", phase_captures, device, data, ds,
                          iters))
    out["X3"] = x3
    out["X4"] = timed_phase("X4", phase_online, device, data)
    out["seconds"] = secs
    counts = D.launches()
    missing = [k for k in ("histogram", "partition", "histogram_int",
                           "partition_level") if not counts.get(k)]
    log("  (X) took %.1f s (%s); launches %s" % (
        time.perf_counter() - t, ", ".join("%s %.1f s" % kv
                                           for kv in secs.items()), counts))
    if missing:
        raise AssertionError("(X) launched no %s" % missing)
    out["launches"] = counts
    out["trees"] = max(1, counts["histogram"] + counts["histogram_int"])
    out["s"] = time.perf_counter() - t
    return out


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
                     reps: int, quantized: bool = False) -> dict:
    """Times of the single-window split pass (with the integer child
    histogram when ``quantized``) on windows [0, wc) of ``rows`` for each
    wc of ``counts`` (the first one first), each beside its bound, its
    plain version and the window's device-to-device copy of wc * W bytes
    (2 * wc * W bytes read and written: the least data movement of a
    partition, and the copy-back inside the pass); the first size's numbers,
    with the others under ``sizes``."""
    from lightgbm_tpu_torch.core import partition as P
    W = rows.shape[1]
    out = []
    for wc in counts:
        scal = scal_row(0, wc, route, words, 1)
        kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
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
        log("  %ssplit pass F=%d %8d rows: kernel %.4f ms (queued %.4f), "
            "bound %.4f ms (%s), plain %.4f ms, copy of the window %.4f ms "
            "(queued %.4f), no single library call"
            % ("quantized " if quantized else "", F, wc, ms, dev, b_ms, b_by,
               plain, copy, copy_dev))
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
    # root window and child-sized windows (path (F) grows quantized trees
    # leaf-wise)
    route, words = split_routes(B, np.random.RandomState(7))["numerical"]
    out["partition_q"] = split_pass_sizes(rows, voff, F, B, route, words,
                                          (n, 20000, 900), reps=25,
                                          quantized=True)
    del rows
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
    paths, texts = {}, {}
    for path in PATHS:
        paths[path] = phase_main_path(device, data, ds, path, args.iters,
                                      args.profile)
        texts[path] = paths[path]["booster"].save_model_to_string()
        if path != "A":
            del paths[path]["booster"]
        torch.cuda.empty_cache()
    log("  (F) regression on (A)'s features: bagging_fraction=0.8, "
        "bagging_freq=5, feature_fraction=0.9, hist_precision=quantized, "
        "leaf-wise, %d iterations" % args.iters)
    paths["F"] = phase_regression_bagging(device, data, ds, args.iters,
                                          args.profile)
    torch.cuda.empty_cache()
    log("  (G) multiclass softmax (num_class=%d) on (A)'s features, "
        "lightgbm_tpu_torch.train with the held-out rows as a validation set,"
        " %d iterations" % (NUM_CLASS, min(args.iters, MULTICLASS_ITERS)))
    paths["G"] = phase_multiclass(device, data, ds,
                                  min(args.iters, MULTICLASS_ITERS),
                                  args.profile)
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
    log("  (V) the parallel tree learners on (A)'s task, %d iterations: "
        "(V1) each learner on a one-rank NCCL group, (V2) data, feature, "
        "voting and quantized data on 2 gloo ranks" % args.iters)
    a_path = paths["A"]
    a_path["text"] = a_path["booster"].save_model_to_string()
    a_path["tree0"] = tree0_sequence(a_path["booster"])
    a_path["tree0_terms"] = tree0_split_terms(a_path["booster"])
    t = time.perf_counter()
    paths["V1"] = phase_parallel_nccl(device, data, ds, args.iters,
                                      a_path["text"])
    paths["V2"] = phase_parallel_gloo(device, args.rows,
                                      min(args.iters, V2_ITERS), a_path,
                                      paths["C"]["losses"])
    log("  (V) took %.1f s" % (time.perf_counter() - t))
    torch.cuda.empty_cache()
    from lightgbm_tpu_torch import device as D
    log("  (P) prediction on (A)'s data: (A)'s %d trees each repeated %d "
        "times (%d trees)" % (args.iters, PREDICT_REPEAT,
                              args.iters * PREDICT_REPEAT))
    D.reset_launches()
    paths["P"] = phase_predict(device, data, ds, paths["A"]["booster"])
    paths["P"]["launches"] = D.launches()
    torch.cuda.empty_cache()
    log("  (Q) SHAP contributions of (A)'s model: %d held-out rows raw, %d "
        "training rows binned" % (CONTRIB_ROWS, CONTRIB_ROWS))
    D.reset_launches()
    paths["Q"] = phase_contrib(device, data, ds, paths["A"].pop("booster"))
    paths["Q"]["launches"] = D.launches()
    log("  predict and SHAP launched none of the kernels: %s, %s"
        % (paths["P"]["launches"], paths["Q"]["launches"]))
    torch.cuda.empty_cache()
    log("  (R) checkpoint and resume on (A)'s bins")
    paths["R"] = phase_checkpoint(device, data, ds)
    torch.cuda.empty_cache()
    log("  (W) telemetry and the serving tier: (W1) train() of (A)'s task "
        "with telemetry_out and metrics_port, (W2) serving (A)'s trees x%d "
        "to %d client threads with (C)'s resident beside it and a swap to "
        "(B)'s under load, (W3) CLI task=serve" % (PREDICT_REPEAT,
                                                   SERVE_CLIENTS))
    t = time.perf_counter()
    paths["W1"] = phase_telemetry_train(device, data, ds, args.iters,
                                        texts["A"])
    w_gbdt = paths["W1"].pop("booster")
    paths["W2"] = phase_serving(device, data, ds, w_gbdt, texts,
                                args.profile)
    torch.cuda.empty_cache()
    paths["W3"] = phase_serve_cli(device, data, w_gbdt)
    del w_gbdt
    torch.cuda.empty_cache()
    log("  (W) took %.1f s" % (time.perf_counter() - t))
    log("  (X) the kernel planner and autotuner, MFU, alerts and profiler "
        "captures, the online train-while-serve loop (%d + %d x %d rows) "
        "and compaction of (A)'s trees x%d" % (
            ONLINE_BASE_ROWS, ONLINE_WINDOWS, ONLINE_WINDOW_ROWS,
            PREDICT_REPEAT))
    paths["X"] = phase_path_x(device, data, ds, texts, args.iters,
                              paths["W1"])
    torch.cuda.empty_cache()
    del ds
    log("  (T) the C ABI at (A)'s shape through raw LGBM_* calls: %d rows x "
        "28 f64 features, (A)'s parameters, %d iterations" % (args.rows,
                                                               args.iters))
    capi = phase_capi(device, data, args.iters)
    paths["T"], paths["T2"] = capi["T"], capi["T2"]
    log("  (U) preemption and the watchdog: train() at (A)'s shape, "
        "SIGTERM after iteration %d, resumed; the CLI in a child process"
        % PREEMPT_AT)
    paths["U"] = phase_resilience(device, data, args.iters, capi.pop("text"))
    torch.cuda.empty_cache()
    del data
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
           min(args.iters, EXPO_ITERS)))
    paths["J"], expo_sets = phase_expo(device, args.expo_rows,
                                       EXPO_TEST_ROWS,
                                       min(args.iters, EXPO_ITERS),
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
    torch.cuda.empty_cache()
    log("  (S) the CLI from text files: %d rows x 28 features, "
        "max_bin=255, num_leaves=255, %d iterations; the reference's "
        "example configs" % (CLI_ROWS, CLI_ITERS))
    paths["S"] = phase_cli(device, CLI_ROWS)
    torch.cuda.empty_cache()
    log("  median seconds per iteration: %s" % ", ".join(
        "(%s) %.4f" % (p, float(np.median(r["iter_s"])))
        for p, r in paths.items() if "iter_s" in r))

    log("[5] times (CUDA events, median)")
    times = phase_times(device, args.rows)
    times.update(times_widef(device, nw))
    times.update(times_masked(device, 1 << 20))
    reset_launches()

    def launches(kernel, only=None, more=()):
        by_path = {p: r["launches"].get(kernel, 0) for p, r in paths.items()
                   if r["launches"].get(kernel, 0)
                   and (only is None or p in only or p in more)}
        per_tree = {p: v / paths[p]["trees"] for p, v in by_path.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path,
                    launches_per_tree=per_tree)

    kernels_line = {"kernels": [
        dict(name="histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/core/histogram.py:743",
             max_abs_err=hist_err_max,
             **launches("histogram", "ABCGHIJRSTU", ("V1", "V2", "W1",
                                                     "X")),
             groups_root=paths["I"]["times"]["histogram"],
             cli_root=paths["S"]["times"]["histogram"],
             expo_root=paths["J"]["times"]["histogram"],
             **times["histogram"]),
        dict(name="partition", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/core/partition.py:1090",
             also_replaces="lightgbm_tpu/core/partition.py:1130",
             max_abs_err=split_err_max,
             **launches("partition", "ABCFGHIJRSTU", ("V1", "V2", "W1",
                                                      "X")),
             feature_window_launches=paths["V2"]["feature_window_launches"],
             cli_root=paths["S"]["times"]["split"],
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
             quantized_sizes=times["partition_q"]["sizes"],
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
