"""The train-while-serve controller: one process, serving and a trainer loop.

The counterpart of ``lightgbm_tpu/online/controller.py`` (:1-618).  One
:class:`OnlineController` owns a running serving tier
(:class:`~..serving.Server`), a long-lived training booster, a
:class:`~.buffer.RowBuffer` of fresh labeled rows and a
:class:`~.policy.RetrainPolicy`.  A daemon trainer thread waits for a
trigger, then runs one **cycle**:

1. snapshot the newest buffered rows into a window and persist it
   (``<prefix>.online_window.npz``, atomic) so a preempted cycle can be
   replayed from disk;
2. bin the window against the LIVE bin layout
   (``BinnedDataset.from_matrix(reference=base)``: the mappers and the
   bundling never change, so every generation routes identically), with
   the window's own occupancy stamped onto cloned mappers (each
   generation's drift baseline is its training window);
3. continue the ensemble: ``online_update=extend`` trains ``online_rounds``
   more ABSOLUTE iterations through ``GBDT.train`` (the split passes and
   histograms of the card, the preemption poll and ``snapshot_freq``
   checkpoints; the warm-start continuation contract keeps the bagging
   clock on the ensemble, so a continued run equals checkpoint-resume at
   the same boundary), or ``online_update=refit`` re-fits the leaf values
   on the window through the binned router (the structure unchanged);
4. publish: freeze the model through the model text into an immutable
   booster and ``ModelRegistry.swap`` it (warmed before the name flips:
   in-flight requests finish on the old generation, none dropped), then
   commit the freshness counters (``rows_behind`` falls to what arrived
   during the cycle).

On the card the trainer thread binds the booster's card by index (a new
thread starts on card 0, whatever card its creator had) and launches on
that thread's current stream, the default stream the serving dispatcher
uses too: the trainer's kernels and the serving walk are ordered on the
card, and neither needs an event to hand tensors to the other.

Preemption (SIGTERM) rides the training runtime unchanged: the chunk
boundary writes an emergency checkpoint and ``TrainingPreempted`` leaves
the cycle; serving keeps draining, the driver exits ``EXIT_PREEMPTED``
(75), and the rerun rebins the saved window, restores the checkpoint and
publishes the same next generation.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..checkpoint import cleanup_checkpoints, skip_io_failure
from ..io.binning import BinMapper
from ..io.dataset import BinnedDataset
from ..obs import quality as _quality
from ..obs import spans as _spans
from ..serving.registry import _safe_name
from ..utils.log import LightGBMError, Log
from .buffer import RowBuffer
from .policy import RetrainPolicy

WINDOW_SUFFIX = ".online_window.npz"


def _unwrap(booster):
    inner = getattr(booster, "_booster", None)
    return inner if inner is not None else booster


class OnlineController:
    """One serve-and-train process; see the module docstring.

    Use through ``lightgbm_tpu_torch.serve_and_train`` (which builds the
    Server and wires telemetry ownership) or construct directly around an
    existing :class:`~..serving.Server` for tests and embedding."""

    def __init__(self, server, name: str, booster, base_ds=None,
                 config=None, checkpoint_prefix: Optional[str] = None,
                 publish_out: Optional[str] = None, warm=True,
                 start: bool = False) -> None:
        self.server = server
        self.name = str(name)
        self._safe = _safe_name(self.name)
        self.booster = _unwrap(booster)
        # the trainer thread's card, by index (a new thread starts on
        # card 0 whatever device the constructing thread had)
        dev = self.booster.device
        self._device_index = (None if dev.type != "cuda"
                              else dev.index if dev.index is not None
                              else torch.cuda.current_device())
        self.config = config if config is not None else self.booster.config
        self.base_ds = base_ds if base_ds is not None \
            else self.booster.train_data
        if self.base_ds is None:
            raise LightGBMError(
                "online training needs the base dataset (the live bin "
                "layout): pass train_set or a booster with train_data")
        self.checkpoint_prefix = checkpoint_prefix
        self.publish_out = publish_out
        self._warm = warm

        cfg = self.config
        self.rounds = max(int(getattr(cfg, "online_rounds", 10)), 1)
        self.update_mode = str(getattr(cfg, "online_update",
                                       "extend")).lower()
        if self.update_mode not in ("extend", "refit"):
            raise LightGBMError("unknown online_update %r (expected extend "
                                "or refit)" % self.update_mode)
        self.window_rows = max(int(getattr(cfg, "online_window_rows", 0)), 0)
        self.poll_s = float(getattr(cfg, "online_poll_s", 0.25)) or 0.25
        self.policy = RetrainPolicy.from_config(cfg)
        if not self.policy.active():
            Log.warning("online: every retrain trigger is off "
                        "(online_min_rows/online_interval_s/"
                        "online_drift_trigger/freshness SLOs); the trainer "
                        "will only fire on explicit run_cycle()/flush()")
        if str(getattr(cfg, "boosting", "gbdt")) == "dart":
            Log.warning("online: dart's score replay is order-dependent — "
                        "continued generations are model-equivalent, not "
                        "bit-exact vs an uninterrupted run")

        self.buffer = RowBuffer(
            width=int(self.base_ds.num_total_features),
            max_rows=int(getattr(cfg, "online_buffer_rows", 1 << 20)))

        # the trainer booster must carry objective + an absolute iteration
        # clock.  A booster loaded from a file (train_data None / clock at
        # 0 with init trees) is bound to the base layout through the
        # warm-start continuation contract; an in-process trained booster
        # is already aligned.
        if self.booster.objective is None:
            from ..objective import create_objective
            self.booster.objective = create_objective(cfg.objective, cfg,
                                                      self.booster.device)
        needs_bind = (self.booster.train_data is not self.base_ds
                      or (self.booster.num_init_iteration > 0
                          and self.booster.iter_
                          < self.booster.num_init_iteration))
        if needs_bind:
            self.booster.warm_start_continuation(
                None, train_data=self.base_ds,
                objective=self.booster.objective)

        self.generation = 0
        self.cycles = 0
        self.cycle_failures = 0
        self.last_trigger: Optional[str] = None
        self.last_error: Optional[str] = None
        self.preempted = None           # TrainingPreempted once it lands
        self._last_publish_ts = time.time()
        self._state = "idle"
        self._pending: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._done = threading.Event()  # trainer thread exited
        self._force: Optional[str] = None
        self._cycle_lock = threading.Lock()   # run_cycle is not reentrant
        self._thread: Optional[threading.Thread] = None
        self._health_key = None
        self._closed = False
        if start:
            self.start()

    # ---- lifecycle ----

    def start(self) -> "OnlineController":
        """Resume any preempted cycle's window, publish the current model
        as the first live generation, and start the trainer thread."""
        if self._thread is not None:
            return self
        # a previously-published generation on disk warm-starts the
        # trainer past the caller's bootstrap model — "never from scratch"
        if self.publish_out and os.path.exists(self.publish_out):
            try:
                with open(self.publish_out) as fh:
                    text = fh.read()
                loaded = self.booster.warm_start_continuation(
                    text, train_data=self.base_ds,
                    objective=self.booster.objective)
                Log.info("online: warm-started trainer from %s "
                         "(iteration %d)", self.publish_out, loaded)
            except (OSError, LightGBMError) as exc:
                Log.warning("online: cannot warm-start from %s (%s); "
                            "starting from the caller's model",
                            self.publish_out, exc)
        self._pending = self._load_pending_window()
        self._publish()
        from ..obs import exporter as _exporter
        self._health_key = _exporter.register_health_provider(
            "online", self._health_info)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lgbm-tpu-torch-online")
        self._thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the trainer (a cycle in flight completes), then shut the
        serving tier down (draining by default)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        from ..obs import exporter as _exporter
        if self._health_key is not None:
            _exporter.unregister_health_provider(self._health_key,
                                                 self._health_info)
        self.server.close(drain=drain)

    def __enter__(self) -> "OnlineController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- intake ----

    def ingest(self, X, y, weight=None) -> int:
        """Feed fresh labeled rows into the buffer (thread-safe; called
        from the request path, a label-join consumer, or a feed replay).
        Returns rows accepted and wakes the trainer."""
        n = self.buffer.ingest(X, y, weight=weight)
        if n:
            self._note_freshness()
            self._wake.set()
        return n

    def submit(self, rows, **kwargs):
        """Serving passthrough: submit a request against the live model."""
        return self.server.submit(self.name, rows, **kwargs)

    def predict(self, rows, **kwargs):
        return self.server.predict(self.name, rows, **kwargs)

    # ---- trainer loop ----

    def _loop(self) -> None:
        from ..resilience import TrainingPreempted, preemption_requested
        if self._device_index is not None:
            torch.cuda.set_device(self._device_index)

        def _note_failure(what: str, exc: Exception) -> None:
            # serving must survive a failed trainer step: the last good
            # generation keeps serving, the failure is counted + visible
            # on /healthz, and the next trigger retries
            self.cycle_failures += 1
            self.last_error = "%s: %s" % (type(exc).__name__, exc)
            Log.warning("online: %s failed (%s); the live generation "
                        "keeps serving", what, self.last_error)

        try:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                try:
                    self._resume_cycle(pending)
                except TrainingPreempted:
                    raise
                except Exception as exc:  # noqa: BLE001
                    _note_failure("resuming the preempted cycle", exc)
            while not self._stop.is_set():
                self._wake.wait(self.poll_s)
                self._wake.clear()
                if self._stop.is_set():
                    break
                if preemption_requested():
                    # SIGTERM landed OUTSIDE a training chunk (idle, or
                    # mid-swap where the atomic publish completed and the
                    # handler only set the flag): exit through the same
                    # drain -> emergency checkpoint -> TrainingPreempted
                    # sequence as an in-chunk preemption.  The cycle lock
                    # serializes against a concurrent run_cycle, whose
                    # own chunk-boundary poll may consume the flag first.
                    with self._cycle_lock:
                        if preemption_requested():
                            self.booster._preempt_exit(
                                self.checkpoint_prefix)
                try:
                    reason = self._force or self._poll_trigger()
                    self._force = None
                    if reason is None:
                        continue
                    # auto/forced triggers require fresh rows: retraining
                    # on an unchanged window would mint a new generation
                    # of the same model (and a flush could double-fire
                    # behind a just-finished cycle)
                    self.run_cycle(reason, require_fresh=True)
                except TrainingPreempted:
                    raise
                except Exception as exc:  # noqa: BLE001
                    _note_failure("training cycle", exc)
        except TrainingPreempted as exc:
            # the emergency checkpoint is on disk and the window file is
            # retained: the rerun resumes this cycle.  Serving is NOT torn
            # down here — the driver drains it and converts to exit 75.
            self.preempted = exc
            Log.warning("online: trainer preempted at iteration %d; "
                        "serving keeps draining — rerun to resume",
                        exc.iteration)
        finally:
            self._state = "stopped"
            self._done.set()

    def _poll_trigger(self) -> Optional[str]:
        q_entry = None
        tele = obs.active()
        if tele is not None and self.policy.drift_trigger:
            mon = _quality.monitor(tele)
            if mon is not None:
                # the CURRENT generation's OWN drift state, not the
                # top-level models entry: that one falls back to the
                # newest generation that saw traffic (provenance-
                # relabeled), so right after a drift-triggered publish it
                # still shows the RETIRED generation's alert and would
                # re-fire the trainer forever
                snap = mon.snapshot()
                gens = (snap.get("generations") or {}).get(self._safe) or {}
                q_entry = gens.get(str(self.generation))
        return self.policy.reason(self.buffer.rows_behind(),
                                  self._last_publish_ts,
                                  quality_entry=q_entry)

    def trigger(self, reason: str = "manual") -> None:
        """Ask the trainer thread to run one cycle now (non-blocking)."""
        self._force = str(reason)
        self._wake.set()

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until no rows are behind (forcing a final cycle if
        needed) or the trainer died; returns True when fully caught up."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._done.is_set():
            if self.buffer.rows_behind() <= 0:
                return True
            self.trigger("flush")
            time.sleep(min(self.poll_s, 0.05))
        return self.buffer.rows_behind() <= 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait for the trainer thread to exit; re-raises a stored
        TrainingPreempted so drivers can convert it to exit 75."""
        done = self._done.wait(timeout)
        if self.preempted is not None:
            raise self.preempted
        return done

    # ---- the cycle ----

    def run_cycle(self, reason: str = "manual",
                  require_fresh: bool = False) -> bool:
        """One synchronous train-and-publish cycle (the trainer thread's
        unit of work; callable directly in tests/drills).  Returns True
        when a new generation published, False when the window was empty
        (or carried no fresh rows and ``require_fresh`` is set)."""
        with self._cycle_lock:
            X, y, w, taken = self.buffer.window(self.window_rows)
            if len(X) == 0 or (require_fresh and taken <= 0):
                return False
            target = self.booster.iter_ + self.rounds \
                if self.update_mode == "extend" else self.booster.iter_
            meta = {"cycle": self.cycles + 1, "reason": str(reason),
                    "taken": int(taken), "mode": self.update_mode,
                    "target_iterations": int(target),
                    "rows_ingested": int(self.buffer.rows_ingested),
                    "rows_trained": int(self.buffer.rows_trained),
                    "rows_dropped": int(self.buffer.rows_dropped)}
            self._persist_window(X, y, w, meta)
            self._train_and_publish(X, y, w, meta, resumed=False)
            return True

    def _resume_cycle(self, pending: Dict[str, Any]) -> None:
        """Finish a preempted cycle from its persisted window (+ the
        emergency/periodic checkpoint when one validates)."""
        meta = pending["meta"]
        Log.info("online: resuming preempted cycle %d (%s, %d rows)",
                 int(meta.get("cycle", 0)), meta.get("reason"),
                 len(pending["X"]))
        self.buffer.restore_counters(int(meta.get("rows_ingested", 0)),
                                     int(meta.get("rows_trained", 0)),
                                     int(meta.get("rows_dropped", 0)))
        with self._cycle_lock:
            self._train_and_publish(pending["X"], pending["y"],
                                    pending["w"], meta, resumed=True)

    def _train_and_publish(self, X, y, w, meta: Dict[str, Any],
                           resumed: bool) -> None:
        reason = str(meta["reason"])
        self.last_trigger = reason
        t_cycle = time.perf_counter()
        with _spans.span("online_cycle", trigger=reason,
                         rows=int(len(X)), resumed=bool(resumed)):
            self._state = "training"
            t0 = time.perf_counter()
            with _spans.span("online_train", mode=self.update_mode):
                window_ds = self._window_dataset(X, y, w)
                booster = self.booster
                booster.reset_training_data(window_ds, booster.objective)
                restored = 0
                if resumed and self.checkpoint_prefix:
                    # the checkpoint was captured against THIS window (the
                    # fingerprint pins it); absent/corrupt falls through
                    # to a fresh replay of the cycle
                    restored = booster.resume_from_checkpoint(
                        self.checkpoint_prefix)
                if not restored:
                    booster.replay_train_score()
                if self.update_mode == "extend":
                    booster.config.num_iterations = \
                        int(meta["target_iterations"])
                    # the ordinary training loop: chunk-boundary
                    # preemption polls, snapshot_freq checkpoints — a
                    # SIGTERM here raises TrainingPreempted with the
                    # emergency checkpoint already on disk
                    booster.train(snapshot_out=self.checkpoint_prefix)
                else:
                    booster.refit(booster.predict_leaf_index_binned())
                    # refit bypasses GBDT.train's chunks, which stamp the
                    # freshness clock on the extend path
                    booster.trained_at = time.time()
            train_s = time.perf_counter() - t0
            self._state = "publishing"
            t1 = time.perf_counter()
            with _spans.span("online_publish"):
                self._publish()
            publish_s = time.perf_counter() - t1
            # commit: the window's rows are no longer behind, the cycle's
            # durability files are consumed (a rerun must not resume a
            # finished cycle)
            self.buffer.mark_trained(int(meta["taken"]))
            self.cycles += 1
            self._last_publish_ts = time.time()
            self._state = "idle"
            self._cleanup_cycle_files()
        self._note_freshness()
        tele = obs.active()
        if tele is not None:
            behind = self.buffer.rows_behind()
            tele.counter("online_cycles").inc()
            tele.counter("online_trigger_%s" % reason).inc()
            tele.histogram("online_train_s").observe(train_s)
            tele.histogram("online_publish_s").observe(publish_s)
            tele.gauge("online_generation").set(int(self.generation))
            tele.gauge("online_rows_behind").set(int(behind))
            tele.event("online_cycle", cycle=int(self.cycles),
                       trigger=reason, rows=int(len(X)),
                       generation=int(self.generation),
                       iterations=int(self.booster.iter_),
                       mode=self.update_mode, resumed=bool(resumed),
                       dt_s=time.perf_counter() - t_cycle,
                       train_s=train_s, publish_s=publish_s,
                       rows_behind=int(behind))
        Log.info("online: cycle %d (%s) published generation %d "
                 "(%d rows, train %.3fs, publish %.3fs)",
                 self.cycles, reason, self.generation, len(X), train_s,
                 publish_s)

    # ---- window binning ----

    def _window_dataset(self, X, y, w) -> BinnedDataset:
        """Bin a window against the live layout.  Mappers are CLONED and
        stamped with the window's own bin occupancy so each generation's
        drift baseline is its training window: a generation retrained on
        shifted traffic scores that same traffic as quiet (the
        drift-triggered refit comes back clean), while the shared
        bounds/EFB grouping keep routing bit-identical to the base."""
        ds = BinnedDataset.from_matrix(
            np.asarray(X, dtype=np.float64), label=y, weight=w,
            reference=self.base_ds, keep_raw=False)
        mappers = []
        for i, m in enumerate(self.base_ds.bin_mappers):
            m2 = BinMapper.from_dict(m.to_dict())
            if not m.is_trivial:
                bins = m.values_to_bins(np.asarray(X[:, i],
                                                   dtype=np.float64))
                m2.cnt_in_bin = np.bincount(
                    bins, minlength=m.num_bin).astype(np.int64)
            mappers.append(m2)
        ds.bin_mappers = mappers
        self._last_window_ds = ds
        return ds

    # ---- publish ----

    def _freeze_generation(self):
        """The model as an immutable per-generation booster: the text
        round-trip decouples the published ensemble from the trainer's
        ongoing mutation (the registry must never see a model whose tree
        list grows under an in-flight request)."""
        from ..boosting.gbdt import GBDT
        booster = self.booster
        tele = obs.active()
        if tele is not None:
            # score-distribution fingerprints from THIS window's training
            # scores, so the generation's score-PSI baseline is current
            _quality.capture_fingerprints(booster)
        model_str = booster.save_model_to_string()
        gen = GBDT(self.config, device=booster.device)
        gen.load_model_from_string(model_str)
        gen.trained_at = booster.trained_at or time.time()
        gen._score_fingerprint_raw = booster._score_fingerprint_raw
        gen._score_fingerprint_out = booster._score_fingerprint_out
        gen.quality_name = self._safe
        return gen, model_str

    def _publish(self) -> None:
        gen, model_str = self._freeze_generation()
        layout = getattr(self, "_last_window_ds", None) or self.base_ds
        if self.server.registry.knows(self.name):
            entry = self.server.swap(self.name, gen, layout_ds=layout,
                                     warm=self._warm)
        else:
            entry = self.server.register(self.name, gen, layout_ds=layout)
            if self._warm:
                from ..core.predict_fused import PREDICT_BUCKETS
                entry.warm((PREDICT_BUCKETS[0],) if self._warm is True
                           else tuple(int(b) for b in self._warm))
        self.generation = int(entry.generation)
        if self.publish_out:
            # durability of the published line: a restarted process
            # warm-starts from the newest generation instead of the
            # bootstrap model.  Best-effort like every periodic write.
            try:
                from ..utils.file_io import atomic_write
                atomic_write(self.publish_out, model_str)
            except OSError as exc:
                skip_io_failure("online publish %s" % self.publish_out, exc)

    # ---- durability files ----

    def _window_path(self) -> Optional[str]:
        return (self.checkpoint_prefix + WINDOW_SUFFIX
                if self.checkpoint_prefix else None)

    def _persist_window(self, X, y, w, meta: Dict[str, Any]) -> None:
        path = self._window_path()
        if not path:
            return
        from ..utils.file_io import atomic_write
        buf = io.BytesIO()
        np.savez(buf, X=np.asarray(X, dtype=np.float64),
                 y=np.asarray(y, dtype=np.float64),
                 w=(np.asarray(w, dtype=np.float64) if w is not None
                    else np.zeros(0)),
                 meta=np.frombuffer(
                     json.dumps(meta).encode("utf-8"), dtype=np.uint8))
        try:
            atomic_write(path, buf.getvalue())
        except OSError as exc:
            skip_io_failure("online window %s" % path, exc)

    def _load_pending_window(self) -> Optional[Dict[str, Any]]:
        path = self._window_path()
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as fh:
                d = np.load(io.BytesIO(fh.read()), allow_pickle=False)
            meta = json.loads(bytes(d["meta"]).decode("utf-8"))
            w = d["w"]
            return {"X": d["X"], "y": d["y"],
                    "w": w if len(w) else None, "meta": meta}
        except (OSError, ValueError, KeyError) as exc:
            Log.warning("online: pending window %s unreadable (%s); "
                        "starting fresh", path, exc)
            return None

    def _cleanup_cycle_files(self) -> None:
        if not self.checkpoint_prefix:
            return
        cleanup_checkpoints(self.checkpoint_prefix)
        path = self._window_path()
        try:
            if path and os.path.exists(path):
                os.unlink(path)
        except OSError:
            pass

    # ---- observability ----

    def _note_freshness(self) -> None:
        """rows_behind provenance for the quality plane: the gauge next
        to seconds_behind on /metrics and in the summary, fed by the
        buffer's ingested-vs-trained counters."""
        tele = obs.active()
        if tele is None:
            return
        mon = _quality.monitor(tele)
        if mon is not None:
            mon.note_freshness(self._safe,
                               rows_behind=self.buffer.rows_behind(),
                               rows_ingested=self.buffer.rows_ingested,
                               rows_trained=self.buffer.rows_trained)
        tele.gauge("online_rows_behind").set(self.buffer.rows_behind())

    def _health_info(self) -> Dict[str, Any]:
        """The /healthz "online" block: trainer state + freshness."""
        alive = self._thread is not None and self._thread.is_alive()
        out = {"state": self._state, "generation": int(self.generation),
               "cycles": int(self.cycles),
               "rows_behind": int(self.buffer.rows_behind()),
               "trainer_alive": bool(alive),
               "update": self.update_mode}
        if self.cycle_failures:
            out["cycle_failures"] = int(self.cycle_failures)
            out["last_error"] = self.last_error
        if self.preempted is not None:
            out["preempted"] = True
        return out

    def stats(self) -> Dict[str, Any]:
        out = {
            "generation": int(self.generation),
            "cycles": int(self.cycles),
            "cycle_failures": int(self.cycle_failures),
            "last_trigger": self.last_trigger,
            "rows_ingested": int(self.buffer.rows_ingested),
            "rows_trained": int(self.buffer.rows_trained),
            "rows_dropped": int(self.buffer.rows_dropped),
            "rows_behind": int(self.buffer.rows_behind()),
            "iterations": int(self.booster.iter_),
            "update": self.update_mode,
        }
        out["serving"] = self.server.stats()
        return out
