"""Multi-model residency: many boosters resident under one memory budget.

The counterpart of ``lightgbm_tpu/serving/registry.py`` (:1-754).  A
:class:`ModelRegistry` keeps many models' stacked predictors
(:class:`~..core.predict_fused.FusedPredictor`: one class's trees as device
tensors) resident on the registry's device at once, bounded by a budget.  A
resident model's footprint is the exact byte count of the tensors its
predictors hold (``FusedPredictor.nbytes``), so the budget ledger and the
card agree to the byte.

Residency rules, as in the JAX package:

- **LRU under a budget**: admission evicts least-recently-used residents
  until the newcomer fits.  An evicted model keeps its host trees parked
  and is admitted again on its next request (its keys were built before,
  so ``obs.recompile`` counts nothing: the tensors are copied again);
- **in-flight models never tear**: every dispatch holds a refcount
  (:meth:`ModelRegistry.acquire` / :meth:`~ModelRegistry.release`); an
  eviction or swap that hits a model mid-dispatch only marks it, and its
  tensors are dropped when the last in-flight batch releases;
- **atomic hot-swap** (:meth:`ModelRegistry.swap`): the replacement is
  stacked (and warmed) before the name flips, new arrivals go to it,
  in-flight requests finish on the old one, and nothing is dropped.

The JAX registry also counts degraded-serving fallbacks per model; the port
has no degraded path (a failed launch fails the batch), so that tally is
left out.
"""
from __future__ import annotations

import re
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.predict_fused import PREDICT_BUCKETS, FusedPredictor, note_stack
from ..device import DeviceLike, resolve_device
from ..obs import active as _telemetry_active
from ..utils.log import LightGBMError, Log

DEFAULT_BUDGET_MB = 1024.0

# every live ModelRegistry, for the process-wide residency exposition
# (obs/devmem.check_residency + the /metrics lgbm_tpu_residency_bytes
# gauges); weak so a dropped registry vanishes from the scrape with no
# close() protocol
_REGISTRIES: "weakref.WeakSet" = weakref.WeakSet()
_REG_SEQ = 0
_REG_SEQ_LOCK = threading.Lock()


def residency_snapshot() -> Dict[str, Dict[str, int]]:
    """Accounted-vs-actual resident bytes per model across every live
    registry: ``{model: {"accounted": n, "actual": n}}``.  ``accounted``
    is what the budget ledger charged (admission + counted growth),
    ``actual`` the true stacked-ensemble bytes — the footprint note at
    :class:`ResidentModel` as a scrapeable invariant.  Two registries
    holding one name stay distinct (``name``, ``name#2``) and STABLE:
    registries are walked in creation order (a WeakSet's iteration order
    is not — a same-name collision resolved by set order would let the
    per-model gauges and the warn-once ledger swap registries between
    scrapes)."""
    out: Dict[str, Dict[str, int]] = {}
    for reg in sorted(_REGISTRIES, key=lambda r: r._reg_seq):
        for name, info in reg.residency_stats().items():
            key, n = _safe_name(name), 1
            while key in out:
                n += 1
                key = "%s#%d" % (_safe_name(name), n)
            out[key] = info
    return out


def _safe_name(name: str) -> str:
    """Model name -> metric-name-safe token."""
    return re.sub(r"[^0-9A-Za-z_.-]", "_", str(name))


def _unwrap(booster):
    """Accept a boosting.GBDT or a basic.Booster; return the GBDT."""
    inner = getattr(booster, "_booster", None)
    return inner if inner is not None else booster


def early_stop_allowed(gbdt) -> bool:
    """Whether margin-based prediction early stop is sound for this model —
    the gate ``GBDT._predict_early_stop`` applies to the CONFIG flag,
    applied here to explicit per-request ``pred_early_stop=True`` too."""
    return (max(int(gbdt.num_tree_per_iteration), 1) == 1
            and gbdt.objective is not None
            and not gbdt.objective.need_accurate_prediction)


class ResidentModel:
    """One resident model: its booster plus the cached FusedPredictors.

    Predictors are keyed by (kind, start_iter, end_iter, class, precision)
    — ``GBDT._fused_predictor``'s key space plus the serving tier — built
    on first use on ``device`` and owned here so eviction/swap can drop
    exactly this model's tensors.  The bf16 tier's stack is a separate
    entry, never shared with exact.  ``inflight`` counts dispatches holding
    the entry; ``retired`` / ``evict_pending`` defer the drop until the
    count drains."""

    def __init__(self, name: str, booster, layout_ds=None,
                 registry: Optional["ModelRegistry"] = None,
                 device: DeviceLike = None) -> None:
        self.name = str(name)
        self.device = (registry.device if registry is not None
                       and device is None else resolve_device(device))
        self.gbdt = _unwrap(booster)
        self.layout_ds = (layout_ds if layout_ds is not None
                          else getattr(self.gbdt, "train_data", None))
        self.K = max(int(self.gbdt.num_tree_per_iteration), 1)
        self.total_iter = len(self.gbdt.models) // self.K
        # booster-config early-stop defaults (margin, freq); per-request
        # overrides replace them at submit time
        self.default_early_stop: Tuple[float, int] = \
            self.gbdt._predict_early_stop()
        # the engine's gate for EXPLICIT pred_early_stop=True requests:
        # margin-based truncation is only sound for single-output models
        # whose objective tolerates inaccurate raw scores
        # (predictor.hpp:38-47 NeedAccuratePrediction)
        self.early_stop_allowed = early_stop_allowed(self.gbdt)
        self._registry = registry
        self._preds: Dict[Tuple[str, int, int, int, str],
                          FusedPredictor] = {}
        # the bytes each predictor was last accounted at (a contribution
        # plan grows one after its first pred_contrib request)
        self._pred_bytes: Dict[Tuple[str, int, int, int, str], int] = {}
        self._single: Dict[Tuple[int, int], Any] = {}
        self.inflight = 0
        self.retired = False
        self.evict_pending = False
        # model-generation provenance (obs/quality.py): stamped from the
        # registry's per-name counter under the admit lock, so the
        # generation flips atomically with the name — a request in flight
        # across a swap attributes its drift to the generation that served
        # it.  published_at feeds the freshness gauge when the booster
        # carries no trained-at metadata (loaded models).
        self.generation = 1
        self.published_at = time.time()
        # stack the primary (full-range raw) predictors eagerly: they ARE
        # the admission-time footprint estimate.  resident_bytes is the
        # TRUE footprint; accounted_bytes is what the registry has counted
        # against its budget (admission + counted growth) — drop() gives
        # back exactly the accounted amount, so growth on an
        # already-retired entry can never underflow the budget ledger
        self.resident_bytes = 0
        self.accounted_bytes = 0
        for k in range(self.K):
            self._predictor("raw", 0, self.total_iter, k)

    @property
    def supports_binned(self) -> bool:
        return self.layout_ds is not None

    def _predictor(self, kind: str, start: int, end: int, k: int,
                   precision: str = "exact") -> FusedPredictor:
        key = (kind, start, end, k, precision)
        pred = self._preds.get(key)
        if pred is None:
            sel = self.gbdt.models[start * self.K:end * self.K][k::self.K]
            layout = self.layout_ds if kind == "binned" else None
            pred = FusedPredictor(sel, dataset=layout, kind=kind,
                                  precision=precision, device=self.device)
            # the port's miss (obs.recompile): a key this booster never
            # had stacked; a re-admission restacks known keys, no miss
            if note_stack(self.gbdt, (kind, start, end, k, precision,
                                      id(layout) if layout is not None
                                      else 0, len(self.gbdt.models))):
                pred.pending_miss = True
            self._preds[key] = pred
            self._note_bytes(key)
        return pred

    def _note_bytes(self, key) -> None:
        """Account the growth of predictor ``key``'s tensors (its first
        stacking, or a contribution plan built later)."""
        now = self._preds[key].nbytes()
        grew = now - self._pred_bytes.get(key, 0)
        self._pred_bytes[key] = now
        if grew:
            self.resident_bytes += grew
            if self._registry is not None:
                self._registry._note_growth(self, grew)

    def _resolve_range(self, num_iteration: int,
                       start_iteration: int) -> Tuple[int, int]:
        end = (self.total_iter if num_iteration <= 0
               else min(self.total_iter, start_iteration + num_iteration))
        return int(start_iteration), int(end)

    def _transform(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        """Exactly ``GBDT.predict``'s epilogue: average_output divides by
        the TOTAL trained iteration count, then the objective transform."""
        g = self.gbdt
        if g.average_output:
            raw = raw / max(len(g.models) // self.K, 1)
        if not raw_score and g.objective is not None:
            raw = np.asarray(g.objective.convert_output(raw))
        return raw[0] if self.K == 1 else raw.T

    def predict(self, rows: np.ndarray, kind: str = "raw",
                num_iteration: int = -1, start_iteration: int = 0,
                margin: float = -1.0, freq: int = 10,
                raw_score: bool = False,
                precision: str = "exact") -> np.ndarray:
        """Batched predict through the cached FusedPredictor(s): always the
        f32 regime (or the bf16 tier with ``precision="bf16"``), whatever
        the batch size, one transfer of the scores to the host a class."""
        start, end = self._resolve_range(num_iteration, start_iteration)
        raw = np.zeros((self.K, len(rows)), dtype=np.float64)
        for k in range(self.K):
            raw[k] = self._predictor(kind, start, end, k, precision)(
                rows, early_stop_margin=float(margin),
                round_period=int(freq))
        return self._transform(raw, raw_score)

    def predict_contrib(self, rows: np.ndarray, kind: str = "raw",
                        num_iteration: int = -1,
                        start_iteration: int = 0) -> np.ndarray:
        """SHAP contributions through the cached FusedPredictor(s) — the
        device path-decomposition kernel on the same shape-bucket ladder
        as scores, [N, (F+1)] per class concatenated along axis 1 (no
        objective transform: contributions live in raw-score space)."""
        start, end = self._resolve_range(num_iteration, start_iteration)
        ncol = int(self.gbdt.max_feature_idx) + 2
        outs = []
        for k in range(self.K):
            outs.append(self._predictor(kind, start, end, k).predict_contrib(
                rows, ncol))
            self._note_bytes((kind, start, end, k, "exact"))
        return outs[0] if self.K == 1 else np.concatenate(outs, axis=1)

    def predict_single(self, row: np.ndarray, num_iteration: int = -1,
                       start_iteration: int = 0,
                       raw_score: bool = False) -> np.ndarray:
        """Batch-size-1 fast path: the compiled if/else chain from
        ``model_codegen.compile_single_row`` (the reference's
        ``Tree::ToIfElse`` idea): no device dispatch, bit-equal to the f32
        regime's ``FusedPredictor`` on the same row."""
        start, end = self._resolve_range(num_iteration, start_iteration)
        fn = self._single.get((start, end))
        if fn is None:
            if len(self._single) >= 8:
                # per-request num_iteration sweeps must not grow compiled
                # chains unboundedly (same cap idiom as GBDT._fused_pred)
                self._single.pop(next(iter(self._single)))
            from ..model_codegen import compile_single_row
            fn = compile_single_row(self.gbdt, start_iteration=start,
                                    num_iteration=end - start)
            self._single[(start, end)] = fn
        raw = fn(row).reshape(self.K, 1)
        return self._transform(raw, raw_score)

    def warm(self, buckets=(PREDICT_BUCKETS[0],),
             contrib: bool = False,
             precisions=("exact",)) -> None:
        """Run one zero batch per bucket so the first real request after an
        admission or swap finds its predictors stacked and the card's
        caching allocator holding the blocks a batch of that size needs.
        ``contrib=True`` also builds the contribution plans (a model serving
        explanations must not build them on its first live request);
        ``precisions`` picks the tiers to warm (``("exact", "bf16")`` for a
        model taking both across a swap).  A model with a binned layout
        also gets its binned predictor stacked (the JAX registry warms the
        raw programs only), so binned traffic after a swap adds no miss."""
        n_feat = int(self.gbdt.max_feature_idx) + 1
        store = getattr(self.layout_ds, "binned", None)
        for b in buckets:
            for prec in precisions:
                self.predict(np.zeros((int(b), n_feat), dtype=np.float32),
                             raw_score=True, precision=str(prec))
                if store is not None:
                    self.predict(np.zeros((int(b), store.shape[1]),
                                          dtype=store.dtype),
                                 kind="binned", raw_score=True,
                                 precision=str(prec))
        if contrib:
            for b in buckets:
                self.predict_contrib(
                    np.zeros((int(b), n_feat), dtype=np.float32))
        # plan provenance (registry.py:288-292 of the JAX package): which
        # plan sized the walk and the ladder this warm-up just ran
        tele = _telemetry_active()
        if tele is not None:
            from ..plan import state as _plan_state
            _plan_state.stamp(tele, "serving_warm",
                              _plan_state.current_provenance(),
                              key=str(self.name),
                              buckets=",".join(str(int(b)) for b in buckets),
                              precisions=",".join(str(p)
                                                  for p in precisions))

    def quality_baseline(self):
        """Drift baseline of this resident generation (delegates to the
        booster's cached builder against the serving layout); None when
        the model carries no layout dataset."""
        fn = getattr(self.gbdt, "quality_baseline", None)
        return fn(self.layout_ds) if fn is not None else None

    def drop(self) -> int:
        """Release the device arrays; returns the bytes the registry had
        ACCOUNTED for this entry (what its ledger must give back)."""
        freed = self.accounted_bytes
        self.resident_bytes = 0
        self.accounted_bytes = 0
        self._preds.clear()
        self._pred_bytes.clear()
        self._single.clear()
        return freed


class ModelRegistry:
    """Name -> :class:`ResidentModel` with LRU eviction under a budget.

    ``budget_mb <= 0`` means unlimited.  All mutation happens under one
    re-entrant lock; predictor STACKING for register/swap happens before
    the lock is taken (the flip itself is a dict assignment — atomic
    republish), so traffic on other models never stalls behind a build."""

    def __init__(self, budget_mb: float = DEFAULT_BUDGET_MB,
                 device: DeviceLike = None) -> None:
        # the device every resident predictor lives on (cuda unless the
        # caller passes "cpu"; raises without CUDA)
        self.device = resolve_device(device)
        self.budget_bytes = (int(float(budget_mb) * (1 << 20))
                             if float(budget_mb) > 0 else 0)
        self._lock = threading.RLock()
        # signaled when a re-admission build finishes (see acquire)
        self._changed = threading.Condition(self._lock)
        self._resident: "OrderedDict[str, ResidentModel]" = OrderedDict()
        # evicted models park their host booster (+ layout) here so the
        # next acquire re-admits transparently
        self._parked: Dict[str, Tuple[Any, Any]] = {}
        # re-admissions mid-build: name -> (gbdt, layout).  Stacking runs
        # OUTSIDE the lock; these entries keep the name known meanwhile
        self._building: Dict[str, Tuple[Any, Any]] = {}
        self._bytes = 0
        self.evictions = 0
        self.swaps = 0
        self.readmits = 0
        # model-generation counters (quality-plane provenance): survive
        # eviction/park/re-admission so a readmitted model keeps its
        # generation; swap() bumps under the SAME lock as the name flip
        self._generations: Dict[str, int] = {}
        global _REG_SEQ
        with _REG_SEQ_LOCK:
            _REG_SEQ += 1
            self._reg_seq = _REG_SEQ
        _REGISTRIES.add(self)

    # ---- admission / eviction ----

    def _evict_for(self, needed: int, keep: Optional[str] = None) -> None:
        """Under the lock: mark/evict LRU residents until ``needed`` fits.
        Models mid-dispatch are only MARKED (``evict_pending``) — their
        arrays drop at the final :meth:`release`, so the budget can
        transiently overshoot rather than ever tearing an in-flight
        ensemble."""
        if not self.budget_bytes:
            return
        for name in list(self._resident):
            if self._bytes + needed <= self.budget_bytes:
                break
            if name == keep:
                continue
            entry = self._resident[name]
            if entry.inflight > 0:
                entry.evict_pending = True
                continue
            self._finalize_evict(name, entry)

    def _finalize_evict(self, name: str, entry: ResidentModel) -> None:
        del self._resident[name]
        self._parked[name] = (entry.gbdt, entry.layout_ds)
        self._bytes -= entry.drop()
        entry.retired = True
        self.evictions += 1
        Log.debug("serving: evicted model %r (LRU, budget)", name)
        tele = _telemetry_active()
        if tele is not None:
            tele.counter("serve_evictions").inc()
            tele.event("serve_evict", model=_safe_name(name))

    def _admit_locked(self, entry: ResidentModel) -> None:
        """Under the lock: evict to fit, publish, account.  The generation
        stamp happens HERE — the same lock acquisition that flips the name
        — so baseline+generation switch atomically with the publish and a
        hot-swap never scores new traffic against the old baseline."""
        self._evict_for(entry.resident_bytes, keep=entry.name)
        entry.generation = self._generations.setdefault(entry.name, 1)
        self._resident[entry.name] = entry
        self._resident.move_to_end(entry.name)
        self._bytes += entry.resident_bytes
        entry.accounted_bytes = entry.resident_bytes
        tele = _telemetry_active()
        if tele is not None:
            tele.gauge("serve_resident_models").set(len(self._resident))
            tele.gauge("serve_resident_bytes").set(self._bytes)
            mon = getattr(tele, "quality", None)
            if mon is not None:
                mon.note_generation(
                    _safe_name(entry.name), entry.generation,
                    trained_at=getattr(entry.gbdt, "trained_at", None),
                    published_at=entry.published_at)

    def _note_growth(self, entry: ResidentModel, grew: int) -> None:
        """A resident built a new predictor range: account it and rebalance
        (never evicting the grower itself).  Growth during the entry's own
        CONSTRUCTION is not counted here — admission adds the finished
        ``resident_bytes`` exactly once."""
        with self._lock:
            if entry.retired or self._resident.get(entry.name) is not entry:
                return
            self._bytes += grew
            entry.accounted_bytes += grew
            self._evict_for(0, keep=entry.name)

    # ---- public surface ----

    def register(self, name: str, booster, layout_ds=None) -> ResidentModel:
        """Stack and admit a new model; duplicate names must use
        :meth:`swap` (an explicit republish, never a silent overwrite).
        The name is RESERVED (via the building table) before the stacking
        starts, so two concurrent registers of one name cannot both admit
        — the loser errors, it does not silently overwrite."""
        name = str(name)
        with self._lock:
            if name in self._resident or name in self._parked \
                    or name in self._building:
                raise LightGBMError(
                    "model %r is already registered; use swap() to "
                    "republish it" % name)
            # a fresh register is a NEW generation even when the name was
            # used before (unregister + register is a legal republish that
            # skips swap): reusing the retired number would fold the new
            # model's traffic into the retired generation's drift state
            self._generations[name] = self._generations.get(name, 0) + 1
            self._building[name] = (_unwrap(booster), layout_ds)
        try:
            entry = ResidentModel(name, booster, layout_ds=layout_ds,
                                  registry=self)
        except BaseException:
            with self._changed:
                self._building.pop(name, None)
                self._changed.notify_all()
            raise
        with self._changed:
            if self._building.pop(name, None) is None:
                # unregistered mid-build
                entry.retired = True
                entry.drop()
                self._changed.notify_all()
                raise LightGBMError("model %r was unregistered during its "
                                    "registration" % name)
            # publish under the SAME lock acquisition as the building-pop:
            # a waiter (swap/unregister) woken between the two could
            # otherwise interleave and be clobbered by this admit
            self._admit_locked(entry)
            self._changed.notify_all()
        return entry

    def swap(self, name: str, booster, layout_ds=None,
             warm=True, warm_contrib: bool = False,
             warm_precisions=("exact",)) -> ResidentModel:
        """Atomically republish ``name``: the replacement is fully stacked
        (and bucket-warmed unless ``warm=False``) BEFORE the flip; in-flight
        requests finish on the old ensemble, new arrivals route to the new
        one, and the old predictor entries drop when their refcount drains.
        ``warm`` may be True (smallest bucket), an iterable of bucket
        sizes, or False; ``warm_contrib`` additionally builds the
        pred_contrib plans for the warmed buckets (models serving
        explanation traffic across the swap); ``warm_precisions`` picks
        the tiers warmed before the flip (a model taking mixed
        exact+bf16 traffic wants both, so neither tier stalls)."""
        name = str(name)
        with self._lock:
            if name not in self._resident and name not in self._parked \
                    and name not in self._building:
                raise LightGBMError("cannot swap unknown model %r (register "
                                    "it first)" % name)
        entry = ResidentModel(name, booster, layout_ds=layout_ds,
                              registry=self)
        if warm:
            entry.warm((PREDICT_BUCKETS[0],) if warm is True
                       else tuple(int(b) for b in warm),
                       contrib=warm_contrib,
                       precisions=tuple(warm_precisions))
        with self._changed:
            # a racing re-admission build finishes first: the swap retires
            # whatever generation it published
            while name in self._building:
                self._changed.wait()
            if name not in self._resident and name not in self._parked:
                # unregistered while the replacement was stacking: admitting
                # now would resurrect a name the caller already removed
                # (register/acquire defend the same interleaving)
                entry.retired = True
                entry.drop()
                raise LightGBMError("model %r was unregistered during its "
                                    "swap" % name)
            old = self._resident.pop(name, None)
            self._parked.pop(name, None)
            if old is not None:
                # retire the outgoing generation BEFORE sizing the
                # admission: a drained old entry gives its bytes back now,
                # so a same-size swap under a tight budget does not evict
                # innocent co-residents (an in-flight old keeps its bytes
                # counted — its arrays really are still live)
                old.retired = True
                if old.inflight == 0:
                    self._bytes -= old.drop()
            # bump the generation UNDER the flip lock: in-flight requests
            # keep the old entry's stamp (their drift attributes to the
            # generation that served them), arrivals get the new one
            self._generations[name] = self._generations.get(name, 1) + 1
            self._admit_locked(entry)
            self.swaps += 1
            tele = _telemetry_active()
            if tele is not None:
                tele.counter("serve_swaps").inc()
                tele.event("serve_swap", model=_safe_name(name),
                           generation=int(entry.generation),
                           deferred=bool(old is not None
                                         and old.inflight > 0))
        return entry

    def unregister(self, name: str) -> None:
        with self._changed:
            entry = self._resident.pop(str(name), None)
            self._parked.pop(str(name), None)
            self._building.pop(str(name), None)
            self._changed.notify_all()
            if entry is not None:
                entry.retired = True
                if entry.inflight == 0:
                    self._bytes -= entry.drop()

    def knows(self, name: str) -> bool:
        with self._lock:
            return (str(name) in self._resident
                    or str(name) in self._parked
                    or str(name) in self._building)

    def supports_binned(self, name: str) -> bool:
        with self._lock:
            entry = self._resident.get(str(name))
            if entry is not None:
                return entry.supports_binned
            parked = (self._parked.get(str(name))
                      or self._building.get(str(name)))
            if parked is None:
                raise LightGBMError("unknown model %r" % name)
            gbdt, layout = parked
            return (layout if layout is not None
                    else getattr(gbdt, "train_data", None)) is not None

    def acquire(self, name: str) -> ResidentModel:
        """Pin a model for one dispatch (LRU-touches it; transparently
        re-admits a parked model).  Re-stacking runs OUTSIDE the registry
        lock — the same build-then-flip discipline as register/swap — so
        submits and registry calls for OTHER models never block on the
        lock; a second acquirer of the same parked name waits for the
        first build instead of duplicating it.  (The build still occupies
        the CALLING thread — under the single-dispatcher scheduler a
        re-admission delays the queue for its duration, which is the cost
        of transparent re-admission; size the residency budget so hot
        models stay resident.)  Pair with :meth:`release`."""
        name = str(name)
        with self._changed:
            while True:
                entry = self._resident.get(name)
                if entry is not None:
                    self._resident.move_to_end(name)
                    entry.inflight += 1
                    return entry
                if name in self._building:
                    self._changed.wait()
                    continue
                parked = self._parked.pop(name, None)
                if parked is None:
                    raise LightGBMError("unknown model %r" % name)
                self._building[name] = parked
                break
        try:
            entry = ResidentModel(name, parked[0], layout_ds=parked[1],
                                  registry=self)
        except BaseException:
            with self._changed:
                if self._building.pop(name, None) is not None:
                    # re-park only while the reservation is still ours — a
                    # concurrent unregister() removed the name, and
                    # re-parking would resurrect it (the success path's
                    # zombie check, mirrored)
                    self._parked[name] = parked
                self._changed.notify_all()
            raise
        with self._changed:
            if self._building.pop(name, None) is None:
                # unregistered mid-build: never publish a zombie
                entry.retired = True
                entry.drop()
                self._changed.notify_all()
                raise LightGBMError("unknown model %r" % name)
            self._admit_locked(entry)
            self.readmits += 1
            entry.inflight += 1
            self._changed.notify_all()
            tele = _telemetry_active()
            if tele is not None:
                tele.counter("serve_readmits").inc()
                tele.event("serve_readmit", model=_safe_name(name))
            return entry

    def release(self, entry: ResidentModel) -> None:
        with self._lock:
            entry.inflight -= 1
            if entry.inflight == 0:
                if entry.retired:
                    # swapped-out / unregistered: drop now that the last
                    # in-flight batch finished on it
                    self._bytes -= entry.drop()
                elif entry.evict_pending:
                    # the mark was set under budget pressure at admission
                    # time; only follow through if the registry is STILL
                    # over budget — other evictions may have resolved it,
                    # and this entry just proved itself hot
                    entry.evict_pending = False
                    if self._resident.get(entry.name) is entry \
                            and self.budget_bytes \
                            and self._bytes > self.budget_bytes:
                        self._finalize_evict(entry.name, entry)

    def resident_names(self) -> List[str]:
        with self._lock:
            return list(self._resident)

    def intake_info(self, name: str, binned: bool = False
                    ) -> Tuple[Optional[int], Tuple[float, int], bool]:
        """Everything ``Server.submit`` validates, under ONE lock
        acquisition: (request width or None when not determinable,
        config-default ``(margin, freq)``, explicit-early-stop-allowed).
        Raises for unknown names and for binned requests on a model
        without a layout dataset — the submit hot path pays one registry
        round-trip, not four."""
        name = str(name)
        with self._lock:
            entry = self._resident.get(name)
            if entry is not None:
                gbdt, layout = entry.gbdt, entry.layout_ds
                defaults = entry.default_early_stop
                allowed = entry.early_stop_allowed
            else:
                parked = (self._parked.get(name)
                          or self._building.get(name))
                if parked is None:
                    raise LightGBMError("unknown model %r" % name)
                gbdt, layout = parked
                defaults = gbdt._predict_early_stop()
                allowed = early_stop_allowed(gbdt)
        if layout is None:
            layout = getattr(gbdt, "train_data", None)
        if binned:
            if layout is None:
                raise LightGBMError(
                    "model %r was registered without a binned layout "
                    "dataset; binned requests need one" % name)
            store = getattr(layout, "binned", None)
            width = int(store.shape[1]) if store is not None else None
        else:
            width = int(gbdt.max_feature_idx) + 1
        return width, defaults, allowed

    def residency_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-resident-model accounted-vs-actual bytes (one lock
        round-trip; parked models hold no arrays and are omitted) — the
        source of :func:`residency_snapshot`."""
        with self._lock:
            return {n: {"accounted": int(e.accounted_bytes),
                        "actual": int(e.resident_bytes)}
                    for n, e in self._resident.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_model = {n: {"bytes": e.resident_bytes,
                             "inflight": e.inflight,
                             "evict_pending": e.evict_pending}
                         for n, e in self._resident.items()}
            out = {
                "resident": list(self._resident),
                "parked": sorted(self._parked),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "evictions": self.evictions,
                "swaps": self.swaps,
                "readmits": self.readmits,
                "models": per_model,
            }
        return out
