"""The booster's cached device predictor, over raw rows or binned rows.

Counterpart of ``lightgbm_tpu/core/predict_fused.py`` (``FusedPredictor``,
:365-521): one class's trees stacked once on the device and reused by every
call; ``GBDT`` caches one per (kind, iteration range, class, model count,
layout, precision), as gbdt.py:2019-2046 does.  Two kinds:

- ``raw``: the f32 regime of :mod:`core.predict` (f32 rows and floored
  thresholds, an f32 running sum in tree order);
- ``binned``: the training-format u8/u16 row store, routed by integer
  compares against thresholds binned on the host
  (``stack_ensemble_binned_host``, :123-188, and ``decide_binned``,
  :191-221: EFB group codes unfolded, categorical nodes by bin bitsets, NaN
  and zero missing routing), the semantics of ``route_binned`` for one tree.
  On training rows it routes as the raw kind does, so the two give the same
  bits.

The bf16 tier (``precision="bf16"``) carries the leaf values and the score in
bfloat16, each add rounded, and routes as the exact tier (``_cast_lossy``,
:250-259).  The TPU's tree blocks sized to VMEM and its compile-bucket
ladder have no counterpart: rows go in chunks of at most
``core.predict.CHUNK_ROWS`` and trees in blocks sized from a byte budget;
neither changes a result.  There is no degraded path: a failure raises.

Telemetry (``obs``): a predictor built for a key its owner (a ``GBDT``, one
resident model of the serving registry) had not built before is the port's
miss (:func:`note_stack`, ``obs.recompile``'s ``predict_stack``), and its
first call carries the stacking seconds into the compile accounting.  With
a run active, every call records ``predict_dispatch_s_bucket_<b>`` and a
``predict`` event (``contrib_*`` and a ``contrib`` event for
contributions), ``b`` being the serving ladder's rung of the call's rows
(:data:`PREDICT_BUCKETS`, predict_fused.py:72 and :97 of the JAX package),
as in predict_fused.py:465-505 and :577-610.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..device import DeviceLike
from ..io.binning import BinType, MissingType
from ..obs import active as _telemetry_active
from ..obs import annotate as _annotate
from ..obs import compile as _compile
from ..obs import recompile as _recompile
from ..plan import planner as _planner
from ..plan import state as _plan_state
from .predict import StackedTrees, _Stacked
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree

# the JAX package's row ladder (predict_fused.py:72), the analytic plan's
# (plan/planner.py).  The port pads nothing and compiles nothing per size:
# the rungs are the serving coalescer's batch sizes and the bucket a call's
# metrics are filed under; a pinned or tuned plan's ladder replaces it
PREDICT_BUCKETS = _planner.PREDICT_BUCKETS


def shape_bucket(n: int) -> int:
    """Smallest rung of the active plan's ladder holding ``n`` rows (the
    top rung past it)."""
    ladder = _plan_state.predict_buckets()
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def note_stack(owner, key: tuple) -> bool:
    """Record the build of a predictor for ``key`` (kind, start, end, class,
    precision, layout id, model count) of ``owner`` (the booster whose trees
    it stacks): a key the owner had not built before is a miss
    (``obs.recompile`` ``predict_stack``).  Returns whether it was one."""
    keys = owner.__dict__.setdefault("_stack_keys", set())
    if key in keys:
        return False
    keys.add(key)
    _recompile.record("predict_stack", "%s:%d-%d:k%d:%s" % key[:5])
    return True


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of every tensor held by ``obj``'s attributes (through dicts,
    lists and tuples, each tensor once): a stack's device footprint."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    if isinstance(obj, torch.Tensor):
        seen.add(id(obj))
        return int(obj.numel() * obj.element_size())
    seen.add(id(obj))
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type) \
            and not isinstance(obj, np.ndarray):
        return sum(tensor_bytes(v, seen) for v in vars(obj).values())
    return 0


class BinnedStackedTrees(_Stacked):
    """One class's trees stacked for the binned row store of ``dataset``'s
    layout: per node its bin column (group), threshold bin, missing routing,
    the feature's bin count, default bin and EFB offset, and a bin bitset
    for a categorical node."""

    def __init__(self, trees: List[Tree], dataset,
                 device: DeviceLike = None) -> None:
        super().__init__(trees, device)
        T, M = self.T, self.M
        W = 0
        if any(t.num_cat > 0 for t in trees):
            cat_bins = [mp.num_bin for mp in dataset.bin_mappers
                        if mp.bin_type == BinType.CATEGORICAL]
            W = -(-max(cat_bins, default=32) // 32)
        col = np.zeros((T, M), np.int64)
        thr = np.zeros((T, M), np.int32)
        dl = np.zeros((T, M), bool)
        mt = np.zeros((T, M), np.int8)
        nb = np.ones((T, M), np.int32)
        db = np.zeros((T, M), np.int32)
        off = np.ones((T, M), np.int32)
        ic = np.zeros((T, M), bool)
        cb = np.zeros((T, M, W), np.int64)
        group_idx = dataset.group_idx
        for i, tree in enumerate(trees):
            for node in range(max(tree.num_leaves - 1, 0)):
                f = int(tree.split_feature[node])
                mapper = dataset.bin_mappers[f]
                j = dataset.inner_feature_map[f]
                col[i, node] = j if group_idx is None else int(group_idx[j])
                off[i, node] = (1 if dataset.bin_offset is None
                                else int(dataset.bin_offset[j]))
                nb[i, node] = int(dataset.num_bin_per_feature[j])
                db[i, node] = int(mapper.default_bin)
                mt[i, node] = int(mapper.missing_type)
                dt = int(tree.decision_type[node])
                dl[i, node] = (dt & K_DEFAULT_LEFT_MASK) != 0
                if dt & K_CATEGORICAL_MASK:
                    ic[i, node] = True
                    ci = int(tree.threshold[node])
                    lo = tree.cat_boundaries[ci]
                    hi = tree.cat_boundaries[ci + 1]
                    for wd in range(lo, hi):
                        word = int(tree.cat_threshold[wd])
                        for j2 in range(32):
                            if (word >> j2) & 1:
                                b = mapper.categorical_2_bin.get(
                                    (wd - lo) * 32 + j2)
                                if b is not None:
                                    cb[i, node, b >> 5] |= 1 << (b & 31)
                else:
                    thr[i, node] = mapper.value_to_bin(
                        float(tree.threshold[node]))
        t = self._t
        self.col, self.thr, self.dl = (t(col).view(-1), t(thr).view(-1),
                                       t(dl).view(-1))
        self.mt, self.nb, self.db = (t(mt).view(-1), t(nb).view(-1),
                                     t(db).view(-1))
        self.off, self.ic = t(off).view(-1), t(ic).view(-1)
        self.cb, self.W = t(cb).view(-1), W

    def rows_to_device(self, X, dtype=None) -> torch.Tensor:
        """The u8/u16 row store as an integer tensor on the device (a device
        tensor is taken as it is)."""
        if isinstance(X, torch.Tensor):
            return X.to(self.device)
        X = np.ascontiguousarray(X)
        if X.dtype not in (np.uint8, np.uint16):
            raise TypeError("binned predictor wants the u8/u16 row store, "
                            "got %s" % X.dtype)
        if X.dtype == np.uint16:
            X = X.astype(np.int32)
        return self._t(X)

    def decide(self, rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        n = rows.shape[0]
        idx = self.col[flat]
        code = rows.gather(1, idx if idx.dim() == 2 else
                           idx[None, :].expand(n, -1)).to(torch.int32)
        off, nb = self.off[flat], self.nb[flat]
        # EFB group code -> feature bin (identity for a singleton, off = 1)
        b = torch.where((code >= off) & (code <= off + nb - 2),
                        code - off + 1, 0)
        mt = self.mt[flat]
        missing = torch.where(mt == int(MissingType.NAN), b == nb - 1,
                              (mt == int(MissingType.ZERO))
                              & (b == self.db[flat]))
        go_left = torch.where(missing, self.dl[flat], b <= self.thr[flat])
        if self.W:
            wi = b >> 5
            word = self.cb[flat * self.W + torch.clamp(wi, 0, self.W - 1)]
            cat_left = (wi < self.W) & (((word >> (b & 31)) & 1) == 1)
            go_left = torch.where(self.ic[flat], cat_left, go_left)
        return go_left


class FusedPredictor:
    """Device predictor of one class's trees, stacked once (``kind`` raw or
    binned, ``precision`` exact or bf16)."""

    def __init__(self, trees: List[Tree], dataset=None, kind: str = "raw",
                 precision: str = "exact", device: DeviceLike = None) -> None:
        if kind not in ("raw", "binned"):
            raise ValueError("kind must be 'raw' or 'binned'")
        if precision not in ("exact", "bf16"):
            raise ValueError("precision must be 'exact' or 'bf16'")
        if kind == "binned" and dataset is None:
            raise ValueError("binned predictor needs the training dataset "
                             "layout (bin mappers + EFB groups)")
        self.precision = precision
        self._trees = list(trees)
        # held so that the id the booster's cache keys on stays this one's
        self.layout_ds = dataset
        t0 = time.perf_counter()
        self.kind = kind
        self.stack = (StackedTrees(trees, device) if kind == "raw"
                      else BinnedStackedTrees(trees, dataset, device))
        # the leaf values of the accumulation dtype, made now so that the
        # footprint (nbytes) does not grow at the first call
        self.acc = torch.bfloat16 if precision == "bf16" else torch.float32
        self.stack.leaf_values(self.acc)
        self.stack_s = time.perf_counter() - t0
        self._contrib: dict = {}
        # (site, bucket label) of this predictor's miss until its first
        # call prices it (compile accounting); None when it was no miss
        self.pending_miss = None

    def nbytes(self) -> int:
        """Bytes of the device tensors this predictor holds (its stack and
        any contribution plans built so far)."""
        return tensor_bytes(self.stack) + tensor_bytes(
            [vars(p) for p in self._contrib.values()])

    def _note_call(self, tele, site: str, n: int, dt: float,
                   miss) -> int:
        """Compile accounting of one call; returns its rung."""
        bucket = shape_bucket(n)
        _compile.note_dispatch(tele, site, bucket,
                               dt + (self.stack_s if miss else 0.0),
                               1 if miss else 0)
        return bucket

    def __call__(self, X, early_stop_margin: float = -1.0,
                 round_period: int = 10, want_leaf: bool = False
                 ) -> np.ndarray:
        """[n] f64 raw scores (or [n, T] int32 leaf indices with
        ``want_leaf``) of raw rows (cast to f32) or binned rows."""
        # a miss is priced by the first call after it, with or without a run
        miss, self.pending_miss = self.pending_miss, None
        tele = _telemetry_active()
        t0 = time.perf_counter() if tele is not None else 0.0
        with _annotate("tree_block_predict"):
            out = self.stack.predict(X, torch.float32, early_stop_margin,
                                     round_period, want_leaf,
                                     acc_dtype=self.acc)
        if tele is not None:
            dt = time.perf_counter() - t0
            bucket = self._note_call(tele, "predict_fused", len(X), dt,
                                     miss)
            tele.histogram("predict_dispatch_s_bucket_%d" % bucket
                           if self.precision == "exact" else
                           "predict_dispatch_bf16_s_bucket_%d"
                           % bucket).observe(dt)
            tele.event("predict", rows=int(len(X)), bucket=int(bucket),
                       store=self.kind, trees=int(len(self._trees)),
                       dt_s=dt, want_leaf=bool(want_leaf),
                       precision=self.precision)
        return out

    def predict_contrib(self, X, ncol: int) -> np.ndarray:
        """[n, ncol] f64 SHAP contributions (last column the expected value)
        by the device TreeSHAP of ``core.predict_contrib``."""
        if self.precision != "exact":
            raise ValueError("pred_contrib has no lossy tier: SHAP "
                             "contributions are exact (f64) only; use a "
                             "precision='exact' predictor")
        from .predict_contrib import ContribPlan
        plan = self._contrib.get(int(ncol))
        if plan is None:
            plan = self._contrib[int(ncol)] = ContribPlan(
                self._trees, int(ncol), self.stack)
        miss, self.pending_miss = self.pending_miss, None
        tele = _telemetry_active()
        t0 = time.perf_counter() if tele is not None else 0.0
        with _annotate("contrib_fused"):
            out = plan(X)
        if tele is not None:
            dt = time.perf_counter() - t0
            bucket = self._note_call(tele, "contrib_fused", len(X), dt,
                                     miss)
            tele.histogram("contrib_latency_s_bucket_%d" % bucket
                           ).observe(dt)
            tele.counter("contrib_calls").inc()
            tele.counter("contrib_rows").inc(int(len(X)))
            tele.event("contrib", rows=int(len(X)), bucket=int(bucket),
                       trees=int(len(self._trees)), dt_s=dt)
        return out
