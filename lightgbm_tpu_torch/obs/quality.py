"""Model-quality plane: per-feature drift, score monitoring, provenance.

The counterpart of ``lightgbm_tpu/obs/quality.py`` (:1-678), host numpy
only, off the dispatch path as in the JAX package.  A served model rots as
traffic drifts from its training distribution; the training path already
keeps the ingredient to see it, each ``BinMapper``'s training bin
occupancy ``cnt_in_bin`` (``io/binning.py``).

- **baselines** (:class:`QualityBaseline`): per-feature training bin
  occupancy, split/gain importance for ranking, and a fingerprint of the
  training score distribution (:class:`ScoreFingerprint`, decile edges
  taken from the training scores on the first baseline build);
- **accumulation** (:class:`QualityMonitor`): the serving scheduler and
  the binned predict path fold served rows' bins into per-model,
  per-generation, per-feature counters, after every future of a batch
  resolved, sampled by ``telemetry_freq`` and row-capped per observation;
- **scoring**: PSI (:func:`psi`) and Jensen-Shannon divergence
  (:func:`js_divergence`) per feature over up to ``DRIFT_GROUPS``
  equal-mass groups, drifted features ranked by importance x PSI, plus the
  served-score reservoir against the training fingerprint;
- **surfacing**: ``lgbm_tpu_drift_psi{model,feature}`` and the other
  per-model gauges on ``/metrics``, a ``quality`` block in the summary,
  ``kind="drift"`` events (every power of two and then every 16th
  observation of a generation).

Every call site gates on ``obs.active() is None`` first: a run with
telemetry off makes no quality-plane call.
"""
from __future__ import annotations

import json
import math
import random
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

# empty-bin smoothing for PSI proportions (an unseen-at-train bin that
# receives traffic must contribute a large, finite term — not infinity)
DRIFT_EPS = 1e-6
# conventional PSI action thresholds: < 0.1 stable, 0.1-0.25 investigate,
# > 0.25 significant shift (retrain candidate)
PSI_WARN = 0.1
PSI_ALERT = 0.25
# /metrics exposition bound: at most this many per-feature drift series
# per model (ranked by importance x PSI) so a wide-F model cannot blow up
# scrape size
DEFAULT_TOP_K = 20
SCORE_BINS = 10
SCORE_RESERVOIR_CAP = 4096
# per-observation row cap (evenly strided sample): bounds the host cost of
# folding one batch regardless of request size
SAMPLE_ROWS_CAP = 16384
# kind="drift" breadcrumb cadence per generation: every power-of-two
# observation (1, 2, 4, 8, ...) and then every Nth — died-run recovery
# reads the LATEST one per (model, generation), so the early doubling
# keeps a short-lived generation's breadcrumb from being its noisy
# first-batch state while long-lived generations stay O(N/16) events
DRIFT_EVENT_EVERY = 16
# PSI comparison granularity: adjacent fine bins aggregate into up to this
# many roughly-equal-baseline-mass groups (the conventional 10-20 PSI
# buckets).  Scoring at max_bin=255 granularity would swamp serving-sized
# samples with empty-fine-bin epsilon terms; the NaN bin keeps its own
# group so a missing-data surge is never diluted.
DRIFT_GROUPS = 16


# ---- divergence scoring ----

def _proportions(counts, eps: float = DRIFT_EPS) -> np.ndarray:
    """Counts -> proportions with empty bins floored at ``eps`` (standard
    PSI practice: zero cells carry a large finite penalty, never inf)."""
    c = np.asarray(counts, dtype=np.float64)
    total = float(c.sum())
    if total <= 0 or len(c) == 0:
        return np.full(max(len(c), 1), 1.0 / max(len(c), 1))
    return np.maximum(c / total, eps)


def psi(expected_counts, actual_counts, eps: float = DRIFT_EPS) -> float:
    """Population Stability Index between two count vectors:
    ``sum((a_i - e_i) * ln(a_i / e_i))`` over eps-floored proportions.
    0 = identical; > 0.25 is the conventional retrain-alert level."""
    e = _proportions(expected_counts, eps)
    a = _proportions(actual_counts, eps)
    if len(e) != len(a):
        raise ValueError("PSI needs equal bin counts (%d vs %d)"
                         % (len(e), len(a)))
    return float(np.sum((a - e) * np.log(a / e)))


def js_divergence(p_counts, q_counts) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two count
    vectors.  Unlike PSI it is bounded and symmetric — the saturation-proof
    companion reading for heavily shifted features."""
    p = np.asarray(p_counts, dtype=np.float64)
    q = np.asarray(q_counts, dtype=np.float64)
    if len(p) != len(q):
        raise ValueError("JS needs equal bin counts (%d vs %d)"
                         % (len(p), len(q)))
    ps, qs = float(p.sum()), float(q.sum())
    if ps <= 0 or qs <= 0:
        return 0.0
    p, q = p / ps, q / qs
    m = 0.5 * (p + q)

    def _kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


def drift_level(value: Optional[float]) -> str:
    """Operator bucket for a PSI value: ok | warn | alert."""
    if value is None:
        return "ok"
    if value > PSI_ALERT:
        return "alert"
    if value > PSI_WARN:
        return "warn"
    return "ok"


# ---- training score fingerprint ----

class ScoreFingerprint:
    """Decile-edge fingerprint of the training score distribution.

    ``edges`` are interior quantile cuts (deciles by default, ties
    collapsed); ``counts`` the training occupancy of the resulting bins.
    Served scores bin by ``searchsorted`` against the same edges, so
    ``psi_of`` is the score-distribution PSI an ops playbook expects."""

    def __init__(self, edges, counts) -> None:
        self.edges = np.asarray(edges, dtype=np.float64)
        self.counts = np.asarray(counts, dtype=np.int64)

    @classmethod
    def from_scores(cls, scores,
                    bins: int = SCORE_BINS) -> Optional["ScoreFingerprint"]:
        s = np.asarray(scores, dtype=np.float64).ravel()
        s = s[np.isfinite(s)]
        if s.size == 0:
            return None
        edges = np.unique(np.quantile(s, np.linspace(0, 1, bins + 1)[1:-1]))
        counts = np.bincount(np.searchsorted(edges, s, side="right"),
                             minlength=len(edges) + 1)
        return cls(edges, counts)

    def bin_scores(self, scores) -> np.ndarray:
        return np.searchsorted(self.edges,
                               np.asarray(scores, dtype=np.float64),
                               side="right")

    def psi_of(self, scores) -> Optional[float]:
        s = np.asarray(scores, dtype=np.float64).ravel()
        s = s[np.isfinite(s)]
        if s.size == 0:
            return None
        actual = np.bincount(self.bin_scores(s),
                             minlength=len(self.counts))
        return psi(self.counts, actual)

    def to_dict(self) -> dict:
        return {"edges": [float(e) for e in self.edges],
                "counts": [int(c) for c in self.counts]}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["ScoreFingerprint"]:
        if not d:
            return None
        return cls(d["edges"], d["counts"])


class _Reservoir:
    """Bounded uniform sample of served scores (Vitter's Algorithm R, the
    same semantics as obs.registry.Histogram's quantile buffer): every
    score ever observed ends resident with equal probability cap/N, so the
    report-time PSI describes the WHOLE serve history, not its head."""

    __slots__ = ("cap", "n", "samples")

    def __init__(self, cap: int = SCORE_RESERVOIR_CAP) -> None:
        self.cap = int(cap)
        self.n = 0
        self.samples: List[float] = []

    def add_many(self, values) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            if not math.isfinite(v):
                continue
            self.n += 1
            if len(self.samples) < self.cap:
                self.samples.append(float(v))
            else:
                j = random.randrange(self.n)
                if j < self.cap:
                    self.samples[j] = float(v)


# ---- baseline ----

def mass_groups(counts, max_groups: int = DRIFT_GROUPS,
                own_last_bin: bool = False):
    """``(groups [num_bin] -> group id, n_groups)``: adjacent bins packed
    greedily into up to ``max_groups`` roughly-equal-mass groups of the
    baseline distribution.  ``own_last_bin`` pins the final bin (the NaN
    bin of a ``MissingType.NAN`` mapper) to its own group so a
    missing-data surge is never diluted into the top value range."""
    c = np.asarray(counts, dtype=np.float64)
    n = len(c)
    last_own = 1 if (own_last_bin and n > 1) else 0
    body = n - last_own
    groups = np.zeros(n, dtype=np.int64)
    if body <= 0:
        return groups, max(n, 1)
    total = float(c[:body].sum())
    k = max(min(int(max_groups) - last_own, body), 1)
    if body <= k or total <= 0:
        groups[:body] = np.arange(body)
        gid = body - 1
    else:
        target = total / k
        acc, gid = 0.0, 0
        for i in range(body):
            if acc >= target and gid < k - 1:
                gid += 1
                acc = 0.0
            groups[i] = gid
            acc += float(c[i])
    if last_own:
        groups[n - 1] = gid + 1
        gid += 1
    return groups, gid + 1


class _FeatureBaseline:
    """One monitored feature: the training occupancy + ranking weight.

    ``groups``/``gcounts`` hold the PSI-bucket aggregation (see
    :func:`mass_groups`); served traffic accumulates at FINE bin
    granularity and aggregates only at scoring time."""

    __slots__ = ("name", "orig_idx", "used_col", "counts", "importance",
                 "mapper", "groups", "gcounts")

    def __init__(self, name, orig_idx, used_col, counts, importance,
                 mapper) -> None:
        self.name = str(name)
        self.orig_idx = int(orig_idx)
        self.used_col = int(used_col)
        self.counts = counts          # int64 [num_bin] or None
        self.importance = float(importance)
        self.mapper = mapper
        self.groups = None
        self.gcounts = None
        if counts is not None:
            from ..io.binning import BinType, MissingType
            own_nan = (mapper is not None
                       and mapper.bin_type == BinType.NUMERICAL
                       and mapper.missing_type == MissingType.NAN)
            self.groups, ng = mass_groups(counts, own_last_bin=own_nan)
            self.gcounts = np.bincount(self.groups, weights=counts,
                                       minlength=ng).astype(np.int64)

    def scored_counts(self, served: np.ndarray) -> np.ndarray:
        """Served fine-bin counts -> PSI-bucket counts."""
        return np.bincount(self.groups, weights=served,
                           minlength=len(self.gcounts)).astype(np.int64)


class QualityBaseline:
    """Everything needed to score one model generation's served traffic:
    per-feature training bin occupancy (from the mappers' ``cnt_in_bin``),
    normalized importance for ranking, the EFB group-unfold layout for
    binned rows, and the training score fingerprints (raw + transformed).

    Host-static: built once per (model, layout) from data the booster and
    dataset already hold; no device work, ever."""

    def __init__(self) -> None:
        self.features: List[_FeatureBaseline] = []
        self.group_idx: Optional[np.ndarray] = None
        self.bin_offset: Optional[np.ndarray] = None
        self.score_raw: Optional[ScoreFingerprint] = None
        self.score_out: Optional[ScoreFingerprint] = None
        self.trained_at: Optional[float] = None

    @classmethod
    def from_model(cls, gbdt, dataset=None) -> Optional["QualityBaseline"]:
        """Build from a booster + its (or a compatible) layout dataset;
        None when no layout is at hand — a model loaded without its
        dataset can be served but not drift-scored."""
        ds = dataset if dataset is not None else getattr(gbdt, "train_data",
                                                         None)
        if ds is None or not getattr(ds, "bin_mappers", None):
            return None
        self = cls()
        used = list(getattr(ds, "used_feature_idx", []))
        names = list(getattr(ds, "feature_names", []) or [])
        gain = split = None
        try:
            gain = np.asarray(gbdt.feature_importance("gain"),
                              dtype=np.float64)
            split = np.asarray(gbdt.feature_importance("split"),
                               dtype=np.float64)
        except Exception:
            pass
        imp = gain if gain is not None and gain.sum() > 0 else split
        if imp is not None and imp.sum() > 0:
            imp = imp / imp.sum()
        for j, i in enumerate(used):
            m = ds.bin_mappers[i]
            counts = getattr(m, "cnt_in_bin", None)
            name = names[i] if i < len(names) else "Column_%d" % i
            w = float(imp[i]) if imp is not None and i < len(imp) else 0.0
            self.features.append(_FeatureBaseline(
                name, i, j,
                np.asarray(counts, dtype=np.int64)
                if counts is not None else None,
                w, m))
        self.group_idx = (np.asarray(ds.group_idx, dtype=np.int64)
                          if ds.group_idx is not None else None)
        self.bin_offset = (np.asarray(ds.bin_offset, dtype=np.int64)
                           if ds.bin_offset is not None else None)
        self.score_raw = getattr(gbdt, "_score_fingerprint_raw", None)
        self.score_out = getattr(gbdt, "_score_fingerprint_out", None)
        self.trained_at = getattr(gbdt, "trained_at", None)
        return self

    def monitorable(self) -> bool:
        return any(f.counts is not None for f in self.features)

    def fold_binned(self, rows: np.ndarray, counts: List[np.ndarray]
                    ) -> None:
        """Fold u8/u16 group-coded rows into per-feature occupancy via the
        EFB unfold (group code ``[off, off+nb-2]`` -> feature bin
        ``1..nb-1``, everything else bin 0 — exactly
        ``Dataset.unbundled_matrix``'s mapping, so the counters see the
        same bins the decide kernel routes on)."""
        for k, f in enumerate(self.features):
            if f.counts is None:
                continue
            j = f.used_col
            col = rows[:, self.group_idx[j]].astype(np.int64) \
                if self.group_idx is not None else rows[:, j].astype(np.int64)
            off = int(self.bin_offset[j]) if self.bin_offset is not None \
                else 1
            nb = len(f.counts)
            bins = np.where((col >= off) & (col <= off + nb - 2),
                            col - off + 1, 0)
            counts[k] += np.bincount(bins, minlength=nb)

    def fold_raw(self, rows: np.ndarray, counts: List[np.ndarray]) -> None:
        """Fold raw f32 feature rows through the training bin mappers —
        the host side of what the binned route got for free (NaN rows land
        in the NaN bin, unseen categories in the last categorical bin,
        both exactly as ``values_to_bins`` routes them)."""
        width = rows.shape[1]
        for k, f in enumerate(self.features):
            if f.counts is None or f.orig_idx >= width:
                continue
            bins = f.mapper.values_to_bins(
                np.asarray(rows[:, f.orig_idx], dtype=np.float64))
            counts[k] += np.bincount(bins, minlength=len(f.counts))


def capture_fingerprints(gbdt) -> None:
    """Stamp the training score fingerprints on the booster — called
    lazily on the first baseline build (``GBDT.quality_baseline``), so a
    run that never monitors pays nothing for them.  Single-output models
    only; multiclass keeps feature drift without the score monitor."""
    try:
        k = max(int(getattr(gbdt, "num_tree_per_iteration", 1)), 1)
        score = getattr(gbdt, "train_score", None)
        n = int(getattr(gbdt, "num_data", 0))
        if score is None or k != 1 or n <= 0:
            return
        raw = (score.detach().to("cpu").numpy() if hasattr(score, "detach")
               else np.asarray(score))[0, :n].astype(np.float64)
        gbdt._score_fingerprint_raw = ScoreFingerprint.from_scores(raw)
        obj = getattr(gbdt, "objective", None)
        if obj is not None:
            out = np.asarray(obj.convert_output(raw))
            gbdt._score_fingerprint_out = ScoreFingerprint.from_scores(out)
    except Exception:  # fingerprinting must never fail a training run
        pass


# ---- monitor ----

class _GenState:
    """Accumulated served-traffic occupancy for one (model, generation)."""

    __slots__ = ("generation", "baseline", "counts", "res_raw", "res_out",
                 "rows", "observations", "ns_spent", "first_ts", "last_ts")

    def __init__(self, generation: int,
                 baseline: Optional[QualityBaseline]) -> None:
        self.generation = int(generation)
        self.baseline = baseline
        self.counts: List[np.ndarray] = (
            [np.zeros(len(f.counts), dtype=np.int64)
             if f.counts is not None else None
             for f in baseline.features] if baseline is not None else [])
        self.res_raw = _Reservoir()
        self.res_out = _Reservoir()
        self.rows = 0
        self.observations = 0
        self.ns_spent = 0.0
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None


class QualityMonitor:
    """Per-model, per-generation drift accumulation for one telemetry run.

    Owned by the active :class:`~.registry.Telemetry` (its ``quality``
    attribute, created by :func:`monitor`); dies with the run, so
    telemetry-off processes never hold one.  All folding is host numpy
    under one lock — the observe sites run after request futures resolve
    (serving) or after the batched dispatch returns (binned predict), so
    the quality plane adds zero device work and zero recompiles."""

    def __init__(self, top_k: int = DEFAULT_TOP_K,
                 sample_cap: int = SAMPLE_ROWS_CAP) -> None:
        self.top_k = max(int(top_k), 1)
        self.sample_cap = max(int(sample_cap), 1)
        self._lock = threading.Lock()
        # name -> {generation -> _GenState}; retired generations keep
        # their counters so a post-swap report still attributes each
        # request's drift to the generation that served it
        self._states: Dict[str, Dict[int, _GenState]] = {}
        # name -> provenance stamped at register/swap time (gauges render
        # even for models that have not seen monitored traffic yet)
        self._provenance: Dict[str, Dict[str, Any]] = {}

    # -- provenance --

    def note_generation(self, name: str, generation: int,
                        trained_at: Optional[float] = None,
                        published_at: Optional[float] = None) -> None:
        with self._lock:
            prev = self._provenance.get(str(name)) or {}
            self._provenance[str(name)] = {
                "generation": int(generation),
                "trained_at": trained_at,
                "published_at": published_at,
                # the online buffer's freshness counters survive the
                # republish (note_freshness refreshes them right after)
                **{k: prev[k] for k in ("rows_behind", "rows_ingested",
                                        "rows_trained") if k in prev},
            }

    def note_freshness(self, name: str,
                       rows_behind: Optional[int] = None,
                       rows_ingested: Optional[int] = None,
                       rows_trained: Optional[int] = None) -> None:
        """The online loop's ingested-vs-trained row counters: the
        ``rows_behind`` gauge beside ``seconds_behind`` (quality.py:475-489
        of the JAX package)."""
        with self._lock:
            prov = self._provenance.setdefault(str(name), {})
            if rows_behind is not None:
                prov["rows_behind"] = int(rows_behind)
            if rows_ingested is not None:
                prov["rows_ingested"] = int(rows_ingested)
            if rows_trained is not None:
                prov["rows_trained"] = int(rows_trained)

    # -- accumulation --

    def observe(self, tele, name: str, gbdt, layout_ds, generation: int,
                rows: np.ndarray, kind: str, scores=None,
                raw_score: bool = False) -> None:
        """Fold one served batch: ``rows`` are the REAL request rows (no
        bucket padding), ``kind`` "binned" (u8/u16 group codes) or "raw"
        (f32 features), ``scores`` the per-row outputs when single-output.
        Row-capped by an even stride; generation attribution rides the
        caller's acquired entry, so a request in flight across a swap
        lands in the generation that actually served it."""
        t0 = time.perf_counter()
        name = str(name)
        rows = np.asarray(rows)
        if rows.ndim != 2 or len(rows) == 0:
            return
        if len(rows) > self.sample_cap:
            rows = rows[::(len(rows) + self.sample_cap - 1)
                        // self.sample_cap]
        with self._lock:
            gens = self._states.setdefault(name, {})
            st = gens.get(int(generation))
            if st is None:
                base = None
                try:
                    base = (gbdt.quality_baseline(layout_ds)
                            if hasattr(gbdt, "quality_baseline")
                            else QualityBaseline.from_model(gbdt, layout_ds))
                except Exception:
                    base = None
                st = gens[int(generation)] = _GenState(int(generation), base)
            now = time.time()
            if st.first_ts is None:
                st.first_ts = now
            st.last_ts = now
            if st.baseline is not None:
                if kind == "binned":
                    st.baseline.fold_binned(rows, st.counts)
                else:
                    st.baseline.fold_raw(rows, st.counts)
            if scores is not None:
                s = np.asarray(scores, dtype=np.float64).ravel()
                if len(s) > 2048:
                    s = s[::(len(s) + 2047) // 2048]
                (st.res_raw if raw_score else st.res_out).add_many(s)
            st.rows += len(rows)
            st.observations += 1
            st.ns_spent += (time.perf_counter() - t0) * 1e9
            n_obs = st.observations
            emit = ((n_obs & (n_obs - 1)) == 0
                    or n_obs % DRIFT_EVENT_EVERY == 0)
            entry = self._render_state(name, st, now) if emit else None
        if emit and tele is not None and entry is not None:
            # the died-run breadcrumb: obs_report rebuilds the quality
            # block from the latest drift event per (model, generation)
            tele.event("drift", model=name,
                       generation=int(entry["generation"]),
                       rows=int(entry["rows"]),
                       score_psi=entry.get("score_psi"),
                       psi_max=entry.get("psi_max"),
                       feature_max=entry.get("feature_max"),
                       level=entry.get("level"),
                       rows_behind=entry.get("rows_behind"),
                       top=json.dumps(entry.get("features", []),
                                      separators=(",", ":")))

    # -- reporting --

    def _render_state(self, name: str, st: _GenState, now: float,
                      top_k: Optional[int] = None) -> Dict[str, Any]:
        """One generation's report entry (caller holds the lock)."""
        k = self.top_k if top_k is None else max(int(top_k), 1)
        feats = []
        psi_max, feature_max = None, None
        if st.baseline is not None:
            for f, served in zip(st.baseline.features, st.counts):
                if f.counts is None or served is None or served.sum() == 0:
                    continue
                agg = f.scored_counts(served)
                p = psi(f.gcounts, agg)
                j = js_divergence(f.gcounts, agg)
                feats.append({"name": f.name, "psi": round(p, 6),
                              "js": round(j, 6),
                              "importance": round(f.importance, 6),
                              "weight": round(f.importance * p, 6)})
                if psi_max is None or p > psi_max:
                    psi_max, feature_max = p, f.name
        feats.sort(key=lambda d: (-d["weight"], -d["psi"], d["name"]))
        score_psi = score_psi_raw = None
        if st.baseline is not None:
            if st.baseline.score_out is not None and st.res_out.samples:
                score_psi = st.baseline.score_out.psi_of(st.res_out.samples)
            if st.baseline.score_raw is not None and st.res_raw.samples:
                score_psi_raw = st.baseline.score_raw.psi_of(
                    st.res_raw.samples)
        if score_psi is None:
            score_psi = score_psi_raw
        prov = self._provenance.get(name, {})
        trained_at = (st.baseline.trained_at if st.baseline is not None
                      else None) or prov.get("trained_at")
        behind = trained_at or prov.get("published_at")
        worst = max([v for v in (psi_max, score_psi) if v is not None],
                    default=None)
        return {
            "generation": st.generation,
            "rows": int(st.rows),
            "observations": int(st.observations),
            "monitored": st.baseline is not None
            and st.baseline.monitorable(),
            "psi_max": None if psi_max is None else round(psi_max, 6),
            "feature_max": feature_max,
            "score_psi": None if score_psi is None else round(score_psi, 6),
            "score_psi_raw": (None if score_psi_raw is None
                              else round(score_psi_raw, 6)),
            "level": drift_level(worst),
            "trained_at": trained_at,
            "seconds_behind": (round(now - behind, 3)
                               if behind is not None else None),
            "rows_behind": prov.get("rows_behind"),
            "overhead_ns_per_row": (round(st.ns_spent / st.rows, 1)
                                    if st.rows else None),
            "features": feats[:k],
        }

    def snapshot(self, top_k: Optional[int] = None) -> Dict[str, Any]:
        """The ``quality`` summary block: per model the CURRENT (highest)
        generation's report, plus every generation's under
        ``generations`` so a swap-under-traffic post-mortem can compare
        the two sides of the flip."""
        now = time.time()
        models: Dict[str, Any] = {}
        gens_out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, gens in sorted(self._states.items()):
                for g in sorted(gens):
                    gens_out.setdefault(name, {})[str(g)] = \
                        self._render_state(name, gens[g], now, top_k=top_k)
                # a COPY: the provenance override below must not
                # relabel the per-generation entry it points at
                models[name] = dict(gens_out[name][str(max(gens))])
            for name, prov in sorted(self._provenance.items()):
                if name not in models:
                    behind = (prov.get("trained_at")
                              or prov.get("published_at"))
                    models[name] = {
                        "generation": prov["generation"], "rows": 0,
                        "observations": 0, "monitored": False,
                        "psi_max": None, "feature_max": None,
                        "score_psi": None, "level": "ok",
                        "trained_at": prov.get("trained_at"),
                        "seconds_behind": (round(now - behind, 3)
                                           if behind is not None
                                           else None),
                        "rows_behind": prov.get("rows_behind"),
                        "overhead_ns_per_row": None, "features": [],
                    }
                else:
                    # the registry's stamp wins for generation +
                    # freshness: it reflects the FLIPPED state even
                    # before the new generation saw monitored traffic
                    models[name]["generation"] = max(
                        models[name]["generation"], prov["generation"])
        if not models:
            return {}
        return {"models": models, "generations": gens_out,
                "thresholds": {"warn": PSI_WARN, "alert": PSI_ALERT}}


_create_lock = threading.Lock()


def monitor(tele, create: bool = False,
            top_k: int = DEFAULT_TOP_K) -> Optional[QualityMonitor]:
    """The quality monitor of telemetry run ``tele`` (None when the run is
    None or has none and ``create`` is False).  The monitor lives on the
    run — ``Telemetry.close`` drops it with everything else.  Creation is
    double-checked under a lock: the serving dispatcher's first sampled
    batch can race a predict-path first observe, and the loser's counters
    must not vanish into a discarded monitor."""
    if tele is None:
        return None
    mon = getattr(tele, "quality", None)
    if mon is None and create:
        with _create_lock:
            mon = getattr(tele, "quality", None)
            if mon is None:
                mon = tele.quality = QualityMonitor(top_k=top_k)
    return mon
