"""Continuous-batching request loop and the :class:`Server` facade.

The counterpart of ``lightgbm_tpu/serving/scheduler.py`` (:1-691).  Single
rows and micro-batches coalesce into the rungs of ``PREDICT_BUCKETS`` (the
JAX package's ladder, predict_fused.py:72): a dispatcher thread opens a
batch with the oldest pending request, absorbs compatible requests until
the batch fills its rung or ``max_batch_wait_us`` expires, and runs ONE
cached ``FusedPredictor`` call on the server's device.  The rungs are only
batch sizes here: the port pads nothing and compiles nothing per size.
Each request's future gets exactly its rows' slice.  Per-request
``num_iteration``/``start_iteration``, ``pred_early_stop``, ``raw_score``,
``pred_contrib``, ``precision`` and raw-vs-binned input are part of the
batch key, so only identically-configured requests share a dispatch.

A row's result does not depend on the batch it rode in: the f32 regime sums
each row's trees in tree order, one add per tree (``core/predict.py``
``accumulate``), so every response is bit-equal to one ``FusedPredictor``
call over the same model range and the same rows.  The server always serves
the f32 regime, whatever a request's size (``Booster.predict`` takes the f64
regime below 512 rows).

The dispatcher thread binds the server's device (``torch.cuda.set_device``)
before its first batch; scores come back to the host once per batch and
class.  A failed dispatch fails its batch's futures and is counted
(``failed``, ``serve_failed``); nothing is retried on another device.
Backpressure, not drops: with ``max_queue_depth`` a saturated queue makes
``submit`` raise :class:`ServingQueueFull`; an accepted request always
completes, with a result or an exception.

``Server(device=...)`` is ``cuda`` unless the caller passes ``"cpu"``, and
raises without CUDA, as every entry point of the port does.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

import torch

from ..core.predict_fused import shape_bucket
from ..device import DeviceLike
from ..obs import active as _telemetry_active
from ..obs import annotate as _annotate
from ..obs import spans as _spans
from ..utils.log import LightGBMError, Log
from .registry import DEFAULT_BUDGET_MB, ModelRegistry, _safe_name

DEFAULT_BATCH_WAIT_US = 200


class ServingQueueFull(LightGBMError):
    """The request queue hit ``max_queue_depth``; the caller should shed
    load or retry — the request was NOT enqueued."""


class ServingClosed(LightGBMError):
    """The server is closed (or closing without drain)."""


class _BatchKey(NamedTuple):
    """Requests sharing every dispatch-relevant knob may share a batch."""
    model: str
    kind: str            # "raw" | "binned"
    num_iteration: int
    start_iteration: int
    margin: float
    freq: int
    raw_score: bool
    contrib: bool        # pred_contrib: [N, F+1] SHAP output — contrib
    #                      and score requests never share a dispatch
    precision: str       # "exact" | "bf16": the serving tier.  Part of
    #                      the key, so exact and lossy requests for the
    #                      same model NEVER coalesce into one dispatch


class _Request:
    __slots__ = ("key", "rows", "n", "future", "t_submit", "t_claim",
                 "fast", "taken")

    def __init__(self, key: _BatchKey, rows: np.ndarray, fast: bool) -> None:
        self.key = key
        self.rows = rows
        self.n = len(rows)
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # stamped when the dispatcher claims the request: queue wait =
        # t_claim - t_submit, the per-request span the telemetry renders
        self.t_claim = self.t_submit
        self.fast = fast
        # claimed by the dispatcher (head pop or same-key absorption); the
        # OTHER structure's stale reference becomes a skipped tombstone
        self.taken = False


class Server:
    """The serving tier: a :class:`~.registry.ModelRegistry` plus the
    continuous-batching dispatcher.

    Construct from a :class:`~..config.Config` (the ``max_batch_wait_us``,
    ``serve_residency_budget_mb`` and ``serve_single_row_fast`` params) or
    override per-instance via keyword arguments; ``engine.serve`` /
    ``Booster.serve`` / CLI ``task=serve`` all build one of these.
    ``device`` is where the resident predictors live (``cuda`` unless the
    caller passes ``"cpu"``; a given ``registry`` brings its own)."""

    def __init__(self, config=None, registry: Optional[ModelRegistry] = None,
                 max_batch_wait_us: Optional[int] = None,
                 single_row_fast: Optional[bool] = None,
                 residency_budget_mb: Optional[float] = None,
                 max_queue_depth: int = 0,
                 owned_telemetry=None,
                 metrics_port: Optional[int] = None,
                 metrics_addr: Optional[str] = None,
                 quality_monitor: Optional[bool] = None,
                 device: DeviceLike = None) -> None:
        # a telemetry run THIS server owns (engine.serve opened it for us):
        # close() finalizes it into <telemetry_out>.summary.json and
        # releases the process-active slot, same ownership rule as
        # engine.train
        self._owned_telemetry = owned_telemetry
        def _cfg(name, default):
            return getattr(config, name, default) if config is not None \
                else default
        self.wait_s = max(int(
            max_batch_wait_us if max_batch_wait_us is not None
            else _cfg("max_batch_wait_us", DEFAULT_BATCH_WAIT_US)), 0) * 1e-6
        self.single_row_fast = bool(
            single_row_fast if single_row_fast is not None
            else _cfg("serve_single_row_fast", False))
        self.max_queue_depth = int(max_queue_depth)
        # quality plane (obs/quality.py): drift/score monitoring over the
        # served traffic, sampled by telemetry_freq; host-only work that
        # runs AFTER every future in a batch has resolved
        self.quality_enabled = bool(
            quality_monitor if quality_monitor is not None
            else _cfg("quality_monitor", True))
        self.quality_top_k = int(_cfg("quality_top_k", 20))
        if self.quality_enabled:
            # eager when a run is already live: register()'s admit stamps
            # generation/freshness provenance into the monitor, so the
            # gauges render BEFORE the model sees monitored traffic.  (A
            # run configured later still gets a monitor lazily at the
            # first sampled observe.)
            tele = _telemetry_active()
            if tele is not None:
                from ..obs import quality as _quality
                _quality.monitor(tele, create=True,
                                 top_k=self.quality_top_k)
        self.registry = registry if registry is not None else ModelRegistry(
            budget_mb=float(residency_budget_mb
                            if residency_budget_mb is not None
                            else _cfg("serve_residency_budget_mb",
                                      DEFAULT_BUDGET_MB)), device=device)
        self.device = self.registry.device
        # FIFO of every queued request, plus a per-batch-key index so batch
        # formation absorbs compatible work in O(1) per pop instead of
        # rescanning the whole backlog (claimed requests tombstone in the
        # other structure; fast-path requests never join the index — they
        # are never absorbed into batches)
        self._pending: "deque[_Request]" = deque()
        self._by_key: Dict[_BatchKey, "deque[_Request]"] = {}
        self._queued = 0
        self._cond = threading.Condition()
        self._closed = False
        # requests popped into the open batch but not yet resolved (the
        # dropped==0 invariant must hold at ANY instant, not just at close)
        self._inflight = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # internal accounting (always on, plain ints — the zero-dropped
        # invariant and tests must be checkable without a telemetry run)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.cancelled = 0
        self.batches = 0
        self.fast_served = 0
        # set when the dispatcher could not make the server's card current
        self._bind_error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lgbm-torch-serve")
        self._thread.start()
        # live-plane wiring: queue depth / draining state feed /healthz
        # (a dict write at construction, never hot-path work), and a
        # metrics_port starts the exporter on the active run when the
        # driver has not already
        from ..obs import exporter as _exporter
        self._health_key = _exporter.register_health_provider(
            "serving", self._health_info)
        try:
            m_port = int(metrics_port if metrics_port is not None
                         else _cfg("metrics_port", 0))
            if m_port > 0:
                tele = _telemetry_active()
                if tele is not None:
                    _exporter.start_exporter(
                        tele, port=m_port,
                        addr=str(metrics_addr
                                 if metrics_addr is not None
                                 else _cfg("metrics_addr", "127.0.0.1")))
                else:
                    Log.warning("metrics_port=%d set but no telemetry run "
                                "is active; the exporter serves the active "
                                "run — set telemetry_out (or obs.configure) "
                                "to enable it", m_port)
        except BaseException:
            # a failed port bind must not leak the dispatcher thread or
            # pin this half-built server in the /healthz provider registry
            self.close(drain=False)
            raise

    # ---- model management (delegates to the registry) ----

    def register(self, name: str, booster, layout_ds=None):
        return self.registry.register(name, booster, layout_ds=layout_ds)

    def swap(self, name: str, booster, layout_ds=None, warm=True,
             warm_contrib: bool = False, warm_precisions=("exact",)):
        return self.registry.swap(name, booster, layout_ds=layout_ds,
                                  warm=warm, warm_contrib=warm_contrib,
                                  warm_precisions=warm_precisions)

    # ---- request intake ----

    def _resolve_early_stop(self, name: str, defaults: Tuple[float, int],
                            allowed: bool, pred_early_stop,
                            margin, freq) -> Tuple[float, int]:
        if pred_early_stop is None and margin is None and freq is None:
            # per-model config default — the same whether the model is
            # resident, parked, or mid-re-admission (eviction must not
            # change request semantics)
            return defaults
        if pred_early_stop is False:
            return -1.0, 10
        # explicit True rides the SAME gate GBDT applies to the config
        # flag: margin truncation on multi-output / accuracy-needing
        # objectives would silently corrupt convert_output
        if not allowed:
            Log.warning("pred_early_stop requested for model %r but its "
                        "objective needs accurate raw scores (or is "
                        "multi-output); serving without early stop", name)
            return -1.0, 10
        # explicit True without margin/freq keeps the booster's CONFIGURED
        # values when it has them (an operator's margin must not silently
        # downgrade to the engine fallback), then 10.0/10
        d_margin, d_freq = defaults
        if margin is None:
            margin = d_margin if d_margin >= 0 else 10.0
        if freq is None:
            freq = d_freq if d_margin >= 0 else 10
        return float(margin), int(freq)

    def submit(self, name: str, rows, *, binned: bool = False,
               raw_score: bool = False, num_iteration: int = -1,
               start_iteration: int = 0, pred_early_stop=None,
               pred_early_stop_margin=None,
               pred_early_stop_freq=None,
               pred_contrib: bool = False,
               precision: str = "exact") -> Future:
        """Enqueue one request (a single row or a micro-batch); returns a
        ``concurrent.futures.Future`` resolving to the same shape/values
        ``GBDT.predict`` (or ``predict_binned``) would produce for exactly
        these rows.  ``pred_contrib=True`` resolves to the model's SHAP
        contributions ([N, F+1] per class) instead of scores — the
        per-request explanations knob: contrib requests coalesce with
        other contrib requests on the same ladder (never with score
        traffic — the batch key carries the flag), and the single-row
        fast path falls back to batched dispatch (the compiled if/else
        chain scores only).

        ``precision="bf16"`` routes the request through the lossy serving
        tier (bf16 leaf values + accumulate; routing bit-exact) whose
        measured error is budget-gated in PERF_BUDGETS.json.  Tiers never
        share a dispatch (the batch key carries the tier), and contrib
        requests have no lossy tier."""
        precision = str(precision)
        if precision not in ("exact", "bf16"):
            raise LightGBMError("precision must be 'exact' or 'bf16', "
                                "got %r" % precision)
        if pred_contrib and precision != "exact":
            raise LightGBMError(
                "pred_contrib has no lossy tier: SHAP contributions are "
                "served exact (f64) only — submit with precision='exact'")
        if binned:
            rows = np.ascontiguousarray(np.asarray(rows))
            if rows.dtype not in (np.uint8, np.uint16):
                raise TypeError("binned requests want the u8/u16 row store, "
                                "got %s" % rows.dtype)
        else:
            rows = np.ascontiguousarray(np.asarray(rows, dtype=np.float32))
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        # one registry round-trip validates the name, the binned layout,
        # and fetches the early-stop defaults
        width, es_defaults, es_allowed = self.registry.intake_info(
            name, binned=binned)
        # reject wrong-width rows at intake: coalesced, a malformed request
        # would fail its whole batch (np.concatenate)
        if width is not None and rows.shape[1] != width:
            raise LightGBMError(
                "model %r expects %d columns per %s row, got %d"
                % (name, width, "binned" if binned else "raw",
                   rows.shape[1]))
        margin, freq = self._resolve_early_stop(
            name, es_defaults, es_allowed, pred_early_stop,
            pred_early_stop_margin, pred_early_stop_freq)
        if pred_contrib:
            # contributions live in raw-score space and accumulate every
            # tree: early stop and the objective transform do not apply.
            # Normalizing them out of the key keeps all contrib requests
            # for one (model, range) in ONE batch population.
            margin, freq, raw_score = -1.0, 10, False
        key = _BatchKey(model=str(name), kind="binned" if binned else "raw",
                        num_iteration=int(num_iteration),
                        start_iteration=int(start_iteration),
                        margin=float(margin), freq=int(freq),
                        raw_score=bool(raw_score),
                        contrib=bool(pred_contrib), precision=precision)
        # the compiled single-row chain is exact-only: a bf16 request must
        # ride the batched lossy tier, never silently upgrade to exact
        fast = (self.single_row_fast and not binned and not pred_contrib
                and precision == "exact" and len(rows) == 1 and margin < 0)
        req = _Request(key, rows, fast)
        with self._cond:
            if self._closed:
                raise ServingClosed("server is closed")
            if self.max_queue_depth > 0 \
                    and self._queued >= self.max_queue_depth:
                self.rejected += 1
                tele = _telemetry_active()
                if tele is not None:
                    tele.counter("serve_rejected").inc()
                    # an event too: a saturated run that dies before
                    # close() must keep its backpressure signal in the
                    # died-run recovery path
                    tele.event("serve_reject", model=_safe_name(str(name)),
                               queue_depth=int(self._queued))
                raise ServingQueueFull(
                    "serving queue saturated (depth %d); shed load or raise "
                    "max_queue_depth" % self.max_queue_depth)
            if self._t_first is None:
                self._t_first = time.perf_counter()
            self.submitted += 1
            self._pending.append(req)
            if not req.fast:
                self._by_key.setdefault(key, deque()).append(req)
            self._queued += 1
            self._cond.notify_all()
        return req.future

    def predict(self, name: str, rows, **kwargs) -> np.ndarray:
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(name, rows, **kwargs).result()

    # ---- dispatcher thread ----

    def _pop_matching(self, key: _BatchKey) -> Optional[_Request]:
        """Under the condition lock: claim the OLDEST pending request with
        ``key`` — O(1) amortized via the per-key index (head-claimed
        tombstones are skipped and discarded)."""
        dq = self._by_key.get(key)
        while dq:
            req = dq.popleft()
            if not dq:
                del self._by_key[key]
            if req.taken:
                continue
            req.taken = True
            req.t_claim = time.perf_counter()
            self._queued -= 1
            self._inflight += 1
            return req
        if dq is not None and not dq:
            self._by_key.pop(key, None)
        return None

    def _bind_device(self) -> None:
        """Make the server's card current on the dispatcher thread, so its
        launches go there whatever device the submitting threads have."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index
                                  if self.device.index is not None
                                  else torch.cuda.current_device())

    def _loop(self) -> None:
        try:
            self._bind_device()
        except Exception as exc:  # every batch fails with it, counted:
            self._bind_error = exc  # the loop must live to resolve them
        while True:
            with self._cond:
                first = None
                while first is None:
                    # discard head tombstones (claimed via the key index)
                    while self._pending and self._pending[0].taken:
                        self._pending.popleft()
                    if self._pending:
                        first = self._pending.popleft()
                    elif self._closed:
                        return  # closed and drained
                    else:
                        self._cond.wait()
                first.taken = True
                first.t_claim = time.perf_counter()
                self._queued -= 1
                self._inflight += 1
                # drain the head's own tombstone (and older ones) from its
                # key deque NOW — a rung-exact request never enters the
                # absorb loops, and a stale _by_key entry would pin the
                # request's rows/result forever
                if not first.fast:
                    dq = self._by_key.get(first.key)
                    while dq and dq[0].taken:
                        dq.popleft()
                    if dq is not None and not dq:
                        del self._by_key[first.key]
            batch = [first]
            nrows = first.n
            if not first.fast and self.wait_s > 0:
                deadline = time.monotonic() + self.wait_s
                target = shape_bucket(nrows)
                while nrows < target:
                    got = None
                    with self._cond:
                        got = self._pop_matching(first.key)
                        if got is None and not self._closed:
                            remaining = deadline - time.monotonic()
                            if remaining > 0:
                                self._cond.wait(remaining)
                                got = self._pop_matching(first.key)
                    if got is not None:
                        batch.append(got)
                        nrows += got.n
                        target = shape_bucket(nrows)
                        continue
                    if self._closed or time.monotonic() >= deadline:
                        break
            elif not first.fast:
                # zero wait: still absorb whatever compatible work is
                # already queued (continuous batching without added latency)
                with self._cond:
                    while nrows < shape_bucket(nrows):
                        got = self._pop_matching(first.key)
                        if got is None:
                            break
                        batch.append(got)
                        nrows += got.n
            try:
                self._dispatch(batch, nrows)
            except Exception as exc:  # dispatcher must survive ANYTHING:
                # a dead loop would strand every future ever submitted
                self._fail([r for r in batch if not r.future.done()], exc)

    def _dispatch(self, batch, nrows: int) -> None:
        # transition every future to RUNNING; a request the caller managed
        # to cancel() first leaves the batch here (counted), so set_result
        # below can never hit a cancelled future and poison its batchmates
        with self._cond:
            live = []
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    live.append(req)
                else:
                    self.cancelled += 1
                    self._inflight -= 1
                    nrows -= req.n
        if not live:
            return
        batch = live
        if self._bind_error is not None:
            self._fail(batch, self._bind_error)
            return
        key = batch[0].key
        fast = batch[0].fast and len(batch) == 1 and nrows == 1
        t0 = time.perf_counter()
        try:
            entry = self.registry.acquire(key.model)
        except Exception as exc:
            self._fail(batch, exc)
            return
        try:
            rows = (batch[0].rows if len(batch) == 1
                    else np.concatenate([r.rows for r in batch]))
            with _annotate("serve_dispatch"):
                out = self._run(entry, key, rows, fast)
        except Exception as exc:  # a failed launch fails the batch, counted
            self._fail(batch, exc)
            return
        finally:
            self.registry.release(entry)
        done = time.perf_counter()
        lo = 0
        for req in batch:
            req.future.set_result(out[lo:lo + req.n])
            lo += req.n
        with self._cond:
            self.batches += 1
            self.completed += len(batch)
            self._inflight -= len(batch)
        self._t_last = done
        tele = _telemetry_active()
        if tele is not None:
            m = _safe_name(key.model)
            tele.counter("serve_requests_model_%s" % m).inc(len(batch))
            tele.counter("serve_rows_model_%s" % m).inc(int(nrows))
            tele.counter("serve_batches").inc()
            if key.contrib:
                # explanations traffic accounting (the obs "contrib"
                # summary block): requests at the scheduler grain; the
                # predictor's own contrib_calls/rows count dispatches
                tele.counter("serve_contrib_requests").inc(len(batch))
            # precision-tier traffic split: counted for every
            # tier so an all-exact run still shows "exact" explicitly —
            # absence of a bf16 line then MEANS no lossy traffic, not
            # missing accounting
            tele.counter("serve_requests_precision_%s"
                         % key.precision).inc(len(batch))
            tele.counter("serve_rows_precision_%s"
                         % key.precision).inc(int(nrows))
            if fast:
                tele.counter("serve_single_row_fast").inc()
            bucket = 1 if fast else shape_bucket(nrows)
            lat = tele.histogram("serve_latency_s_model_%s" % m)
            for req in batch:
                lat.observe(done - req.t_submit)
            tele.histogram("serve_occupancy_model_%s" % m).observe(
                nrows / float(bucket))
            with self._cond:
                depth = self._queued
            tele.histogram("serve_queue_depth").observe(depth)
            # lat_max_s = submit-to-complete of the batch's OLDEST request
            # (queue wait included): the died-run recovery path feeds THIS
            # into the latency histogram, not dispatch-only dt_s which
            # understates exactly when queueing is the failure under study
            tele.event("serve_batch", model=m, requests=len(batch),
                       rows=int(nrows), bucket=int(bucket),
                       fast=bool(fast), contrib=bool(key.contrib),
                       precision=key.precision,
                       dt_s=done - t0,
                       lat_max_s=done - min(r.t_submit for r in batch),
                       queue_depth=int(depth))
            # per-request spans: one trace per request, with its queue
            # wait, coalescing hold and the shared dispatch as children —
            # queue time is visible PER REQUEST, not just as lat_max_s.
            # telemetry_freq doubles as the span sampling rate here (every
            # Nth batch carries lifelines): 4 events per request from the
            # single dispatcher thread would otherwise dominate the
            # serving critical path at high qps.  perf_counter stamps
            # anchor to the wall clock via one pair sampled per batch
            # (spans only need relative alignment)
            if tele.freq > 1 and self.batches % tele.freq:
                return
            # quality plane: fold the batch's REAL rows (no padding) and
            # scores into the drift counters — same telemetry_freq
            # sampling as the spans, host numpy only, after every future
            # in the batch resolved (never on the dispatch critical path).
            # Generation attribution rides the entry acquired for THIS
            # dispatch, so a request in flight across a swap scores
            # against the generation that actually served it.
            if self.quality_enabled:
                from ..obs import quality as _quality
                mon = _quality.monitor(tele, create=True,
                                       top_k=self.quality_top_k)
                mon.observe(tele, m, entry.gbdt, entry.layout_ds,
                            entry.generation, rows, key.kind,
                            scores=(np.asarray(out)
                                    if entry.K == 1 and not key.contrib
                                    else None),
                            raw_score=key.raw_score)
            wall, pc = time.time(), time.perf_counter()

            def w(t: float) -> float:
                return wall - (pc - t)

            for req in batch:
                tid = _spans.new_id()
                root = _spans.record_span(
                    tele, "serve_request", trace_id=tid,
                    t0=w(req.t_submit), dur_s=done - req.t_submit,
                    model=m, rows=int(req.n), fast=bool(fast))
                _spans.record_span(
                    tele, "queue_wait", trace_id=tid, parent_id=root,
                    t0=w(req.t_submit),
                    dur_s=max(req.t_claim - req.t_submit, 0.0))
                _spans.record_span(
                    tele, "coalesce", trace_id=tid, parent_id=root,
                    t0=w(req.t_claim), dur_s=max(t0 - req.t_claim, 0.0))
                _spans.record_span(
                    tele, "dispatch", trace_id=tid, parent_id=root,
                    t0=w(t0), dur_s=done - t0, rows=int(nrows),
                    bucket=int(bucket))

    def _run(self, entry, key: _BatchKey, rows: np.ndarray, fast: bool):
        """One dispatch of a batch's rows on its resident model."""
        if fast:
            self.fast_served += 1
            return entry.predict_single(
                rows[0], num_iteration=key.num_iteration,
                start_iteration=key.start_iteration, raw_score=key.raw_score)
        if key.contrib:
            return entry.predict_contrib(
                rows, kind=key.kind, num_iteration=key.num_iteration,
                start_iteration=key.start_iteration)
        return entry.predict(
            rows, kind=key.kind, num_iteration=key.num_iteration,
            start_iteration=key.start_iteration, margin=key.margin,
            freq=key.freq, raw_score=key.raw_score, precision=key.precision)

    def _fail(self, batch, exc: Exception) -> None:
        if not batch:
            Log.warning("serving dispatch error after completion: %s: %s",
                        type(exc).__name__, exc)
            return
        Log.warning("serving dispatch failed for model %r: %s: %s",
                    batch[0].key.model, type(exc).__name__, exc)
        for req in batch:
            if not req.future.done():
                req.future.set_exception(exc)
        with self._cond:
            self.failed += len(batch)
            self._inflight -= len(batch)
        tele = _telemetry_active()
        if tele is not None:
            tele.counter("serve_failed").inc(len(batch))
            tele.event("serve_fail", model=_safe_name(batch[0].key.model),
                       requests=len(batch),
                       error="%s: %s" % (type(exc).__name__, exc))

    # ---- lifecycle / introspection ----

    def _health_info(self) -> Dict[str, Any]:
        """The /healthz "serving" block: queue + inflight counts and the
        draining flag (set once close() stops intake)."""
        with self._cond:
            return {"queue_depth": self._queued,
                    "inflight": self._inflight,
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "rejected": self.rejected,
                    "draining": self._closed}

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            out = {
                "submitted": self.submitted, "completed": self.completed,
                "failed": self.failed, "rejected": self.rejected,
                "cancelled": self.cancelled,
                "dropped": self.submitted - self.completed - self.failed
                - self.cancelled - self._inflight - self._queued,
                "batches": self.batches, "single_row_fast": self.fast_served,
                "queue_depth": self._queued,
                "max_batch_wait_us": int(self.wait_s * 1e6),
            }
        out["registry"] = self.registry.stats()
        return out

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop intake and shut the dispatcher down.  ``drain=True`` (the
        default) completes every pending request first; ``drain=False``
        fails them with :class:`ServingClosed` — counted, never silent."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._pending:
                    req = self._pending.popleft()
                    if req.taken:
                        continue  # claimed by the dispatcher: it resolves
                    req.taken = True
                    self._queued -= 1
                    if req.future.cancelled():
                        self.cancelled += 1
                        continue
                    req.future.set_exception(
                        ServingClosed("server closed without drain"))
                    self.failed += 1
                self._by_key.clear()
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        from ..obs import exporter as _exporter
        _exporter.unregister_health_provider(self._health_key,
                                             self._health_info)
        tele = _telemetry_active()
        if tele is not None:
            # the never-drop invariant as a gauge (0 on every healthy run,
            # by arithmetic identical to stats()["dropped"])
            with self._cond:
                dropped = (self.submitted - self.completed - self.failed
                           - self.cancelled - self._inflight - self._queued)
            tele.gauge("serve_dropped").set(dropped)
        if tele is not None and self._t_first is not None:
            end = self._t_last if self._t_last is not None \
                else time.perf_counter()
            tele.gauge("serve_wall_s").set(max(end - self._t_first, 0.0))
        # a run engine.serve opened FOR this server (the owned_telemetry
        # constructor arg) is finalized and closed with it
        owned = self._owned_telemetry
        if owned is not None and tele is owned:
            from .. import obs as _obs
            from ..obs.report import finalize_run
            finalize_run(owned)
            _obs.disable()

    def disown_telemetry(self) -> None:
        """Release ownership of the telemetry run without finalizing it —
        for callers unwinding a failed construction (no summary should be
        written for a run that never served)."""
        self._owned_telemetry = None

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
