"""Raw-feature prediction of a tree ensemble in plain torch.

Counterpart of ``lightgbm_tpu/core/predict.py`` (and the reference batch
predictor, src/application/predictor.hpp): the JAX package has no Pallas
kernel here, so neither does the port.  The trees of one class are stacked
once into flat [T, M] node arrays on the device; a block of trees is walked
for a chunk of rows at once, one level per step (the ``StackedTreesPredictor``
traversal vectorized over rows and trees), which gives every row's leaf in
every tree ([n, T] int32, ``Tree::GetLeaf``).

Two regimes, as the JAX package's ``GBDT._raw_predict`` splits them at 512
rows (gbdt.py:1999, :2052-2110):

- **f32** (``dtype=torch.float32``, the JAX device scan, predict.py:192-250):
  rows cast to f32 on the host, numerical thresholds rounded toward -inf in
  f32 (:func:`floor_thresholds_f32`, so ``v <= thr32`` equals ``v <= thr``
  for every f32 ``v``), leaf values cast to f32 and the score an f32 running
  sum in tree order, one add per tree (never a reduction, whose order a
  device may change), cast to f64 at the end;
- **f64** (``dtype=torch.float64``, the host ``StackedTreesPredictor`` and
  per-tree loop): f64 rows and thresholds, the score an f64 sum in tree
  order.

Prediction early stop (prediction_early_stop.cpp:26-65) rides the running
sum: with ``margin >= 0`` a row stops accumulating once ``2 * |score| <
margin`` fails at a multiple of ``round_period`` trees (predict.py:201-204;
the per-tree loop's ``active`` mask, gbdt.py:2099-2110, in the f64 regime).
The bf16 tier carries leaf values and the score in bfloat16, each add
rounded (``_cast_lossy``, predict_fused.py:250-259); routing is the f32
regime's.

A categorical node carries its category bitset in a [T, M, W] word array and
decides as ``decide_raw`` (predict.py:145-175): the category is the integer
part of the value, and a negative, unseen (outside the bitset's words) or NaN
category goes right (tree.h:283-331).  Rows go in chunks of at most
:data:`CHUNK_ROWS` and trees in blocks sized from the active plan's
``walk_temp_bytes`` (``plan/state.py``; 2 GiB in the analytic plan), so the
temporaries stay bounded; the results do not depend on either.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..plan import state as _plan_state
from .tree import K_ZERO_THRESHOLD, Tree

# rows per chunk (the JAX package's top shape bucket, PREDICT_BUCKETS[-1])
CHUNK_ROWS = 524288
# bytes per (row, tree) of a walk step's [rows, trees] temporaries
WALK_BYTES = 96


def floor_thresholds_f32(thr64) -> np.ndarray:
    """f64 thresholds rounded toward -inf in f32, so that ``v <= thr32``
    equals ``v <= thr`` for every f32 input ``v`` (predict.py:86-97)."""
    thr64 = np.asarray(thr64, dtype=np.float64)
    t32 = thr64.astype(np.float32)
    over = t32.astype(np.float64) > thr64
    t32[over] = np.nextafter(t32[over], np.float32(-np.inf))
    return t32


def tree_depth(tree: Tree) -> int:
    """Levels from the root to the deepest leaf (0 for a single leaf)."""
    if tree.num_leaves <= 1:
        return 0
    return int(tree.leaf_depth[:tree.num_leaves].max())


def accumulate(values: Callable[[int, int], torch.Tensor], T: int,
               block: int, n: int, dtype: torch.dtype, device,
               margin: float = -1.0, round_period: int = 10) -> torch.Tensor:
    """[n] running sum over ``T`` trees in tree order, one add per tree in
    ``dtype`` (``score + where(active, value, 0)``, as predict.py:201 and
    predict_fused.py:318); ``values(t0, t1)`` gives the [n, t1 - t0] leaf
    values of a block of trees.  With ``margin >= 0`` a row stops adding once
    ``2 * |score| < margin`` fails after a multiple of ``round_period``
    trees."""
    score = torch.zeros(n, dtype=dtype, device=device)
    active = None
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        vals = values(t0, t1)
        for j in range(t1 - t0):
            v = vals[:, j]
            score = score + (v if active is None
                             else torch.where(active, v, 0.0))
            if margin >= 0 and (t0 + j + 1) % round_period == 0:
                keep = 2.0 * torch.abs(score) < margin
                active = keep if active is None else active & keep
    return score


class _Stacked:
    """One class's trees as flat node arrays on ``device``: children, the
    walk's start node (-1 for a single leaf) and leaf values, with the
    decide of a subclass (raw values here, bins in ``predict_fused``)."""

    def __init__(self, trees: List[Tree], device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.T = T = len(trees)
        self.M = M = max([max(t.num_leaves - 1, 1) for t in trees] + [1])
        self.L = L = max([t.num_leaves for t in trees] + [1])
        self.depths = np.asarray([tree_depth(t) for t in trees], np.int64)
        lc = np.zeros((T, M), np.int32)
        rc = np.zeros((T, M), np.int32)
        lv = np.zeros((T, L), np.float64)
        start = np.zeros(T, np.int32)
        for i, tree in enumerate(trees):
            ni = max(tree.num_leaves - 1, 0)
            if ni == 0:
                start[i] = -1          # single leaf: ~0
            lc[i, :ni] = tree.left_child[:ni]
            rc[i, :ni] = tree.right_child[:ni]
            lv[i, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        self.leaf_value64 = lv
        t = self._t
        self.lc, self.rc, self.start = t(lc).view(-1), t(rc).view(-1), t(start)
        self._lv = {}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def leaf_values(self, dtype: torch.dtype) -> torch.Tensor:
        """[T * L] leaf values in ``dtype``: f64 as the trees hold them, f32
        rounded from f64, bf16 rounded from the f32 values (predict.py:118,
        predict_fused.py:257)."""
        if dtype not in self._lv:
            lv = self.leaf_value64
            if dtype == torch.float64:
                v = self._t(lv)
            else:
                v = self._t(lv.astype(np.float32)).to(dtype)
            self._lv[dtype] = v.view(-1)
        return self._lv[dtype]

    def block_size(self, n: int, per_pair: int = WALK_BYTES) -> int:
        """Trees a block of the walk over ``n`` rows: as many as the active
        plan's ``walk_temp_bytes`` of temporaries hold."""
        budget = _plan_state.walk_temp_bytes()
        return int(max(1, min(self.T, budget // max(n * per_pair, 1))))

    def decide(self, rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        """go_left [n, k] of the rows at the flat node indices ``flat``
        ([n, k], or [k] for every row)."""
        raise NotImplementedError

    def leaves(self, rows: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
        """[n, t1 - t0] int32 leaf of every row in trees t0..t1-1: the walk
        of ``Tree::GetLeaf`` over a block of trees, one level per step."""
        n = rows.shape[0]
        G = t1 - t0
        node = self.start[t0:t1].expand(n, G).clone()
        base = (torch.arange(t0, t1, device=self.device,
                             dtype=torch.int64) * self.M)[None, :]
        for _ in range(int(self.depths[t0:t1].max(initial=0))):
            flat = base + torch.clamp(node, min=0)
            go_left = self.decide(rows, flat)
            nxt = torch.where(go_left, self.lc[flat], self.rc[flat])
            node = torch.where(node >= 0, nxt, node)
        return ~node

    def predict_rows(self, rows: torch.Tensor, dtype: torch.dtype,
                     margin: float = -1.0, round_period: int = 10,
                     want_leaf: bool = False) -> torch.Tensor:
        """[n] scores in ``dtype`` of one chunk of rows already on the
        device (or [n, T] int32 leaves with ``want_leaf``)."""
        n = rows.shape[0]
        block = self.block_size(n)
        if want_leaf:
            return torch.cat([self.leaves(rows, t0, min(self.T, t0 + block))
                              for t0 in range(0, self.T, block)], dim=1)
        lv = self.leaf_values(dtype)
        L = self.L

        def values(t0, t1):
            base = (torch.arange(t0, t1, device=self.device,
                                 dtype=torch.int64) * L)[None, :]
            return lv[base + self.leaves(rows, t0, t1)]

        return accumulate(values, self.T, block, n, dtype, self.device,
                          margin, round_period)

    def rows_to_device(self, X, dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError

    def predict(self, X, dtype: torch.dtype, margin: float = -1.0,
                round_period: int = 10, want_leaf: bool = False,
                acc_dtype: Optional[torch.dtype] = None) -> np.ndarray:
        """[n] f64 scores (or [n, T] int32 leaves) of host rows ``X``, in
        chunks of at most :data:`CHUNK_ROWS` rows; ``dtype`` picks the
        regime of the rows and thresholds, ``acc_dtype`` (default
        ``dtype``) that of the leaf values and the running sum."""
        n = len(X)
        acc = dtype if acc_dtype is None else acc_dtype
        out = (np.zeros((n, self.T), np.int32) if want_leaf
               else np.zeros(n, np.float64))
        if self.T == 0 or n == 0:
            return out
        for lo in range(0, n, CHUNK_ROWS):
            rows = self.rows_to_device(X[lo:lo + CHUNK_ROWS], dtype)
            res = self.predict_rows(rows, acc, margin, round_period,
                                    want_leaf)
            out[lo:lo + len(rows)] = (res.cpu().numpy() if want_leaf else
                                      res.to(torch.float64).cpu().numpy())
        return out


class StackedTrees(_Stacked):
    """One class's trees stacked for raw feature rows: split features,
    thresholds (f64 and floored to f32), missing routing and category
    bitsets per node."""

    def __init__(self, trees: List[Tree], device: DeviceLike = None) -> None:
        super().__init__(trees, device)
        T, M = self.T, self.M
        sf = np.zeros((T, M), np.int64)
        thr = np.zeros((T, M), np.float64)
        thr32 = np.zeros((T, M), np.float32)
        dl = np.zeros((T, M), bool)
        mt = np.zeros((T, M), np.int8)
        ic = np.zeros((T, M), bool)
        W = max([hi - lo for t in trees for lo, hi in
                 zip(t.cat_boundaries[:-1], t.cat_boundaries[1:])] + [0])
        cb = np.zeros((T, M, W), np.int64)
        for i, tree in enumerate(trees):
            ni = max(tree.num_leaves - 1, 0)
            dt = tree.decision_type[:ni].astype(np.int64)
            sf[i, :ni] = tree.split_feature[:ni]
            thr[i, :ni] = tree.threshold[:ni]
            thr32[i, :ni] = floor_thresholds_f32(tree.threshold[:ni])
            dl[i, :ni] = (dt & 2) > 0
            mt[i, :ni] = (dt >> 2) & 3
            ic[i, :ni] = (dt & 1) > 0
            for node in np.flatnonzero(ic[i, :ni]):
                ci = int(tree.threshold[node])
                lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
                cb[i, node, :hi - lo] = tree.cat_threshold[lo:hi]
        t = self._t
        self.sf, self.dl, self.mt = t(sf).view(-1), t(dl).view(-1), \
            t(mt).view(-1)
        self.thr = {torch.float64: t(thr).view(-1),
                    torch.float32: t(thr32).view(-1)}
        self.ic, self.cb, self.W = t(ic).view(-1), t(cb).view(-1), W

    def rows_to_device(self, X, dtype: torch.dtype) -> torch.Tensor:
        """Host rows as a [n, D] ``dtype`` tensor on the device (the cast
        made by numpy, as the JAX package makes it)."""
        if isinstance(X, torch.Tensor):
            X = X.cpu().numpy()
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        return self._t(np.asarray(X, dtype=np_dt))

    def decide(self, rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        n = rows.shape[0]
        idx = self.sf[flat]
        fval = rows.gather(1, idx if idx.dim() == 2 else
                           idx[None, :].expand(n, -1))
        mt = self.mt[flat]
        nan = torch.isnan(fval)
        val = torch.where(nan & (mt != 2), 0.0, fval)
        missing = (((mt == 1) & (torch.abs(val) <= K_ZERO_THRESHOLD))
                   | ((mt == 2) & torch.isnan(val)))
        go_left = torch.where(missing, self.dl[flat],
                              val <= self.thr[rows.dtype][flat])
        if self.W:
            iv = torch.where(nan, 0.0, fval).to(torch.int64)
            wi = iv >> 5
            word = self.cb[flat * self.W + torch.clamp(wi, 0, self.W - 1)]
            cat_left = ((iv >= 0) & (wi < self.W)
                        & (((word >> (iv & 31)) & 1) == 1)
                        & ~(nan & (mt == 2)))
            go_left = torch.where(self.ic[flat], cat_left, go_left)
        return go_left
