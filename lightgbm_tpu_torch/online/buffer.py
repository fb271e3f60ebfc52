"""Bounded host-side buffer of fresh labeled rows for the online trainer.

The counterpart of ``lightgbm_tpu/online/buffer.py`` (:1-145), host numpy,
the same accounting.

The request path (or an external feed) ``ingest``s raw feature rows with
their labels; the trainer takes a bounded ``window`` of the newest rows
for the next generation and ``mark_trained``s them once that generation
publishes.  Three monotonic counters give the freshness accounting the
quality plane surfaces (``rows_behind = ingested - trained - dropped``):
a row is *behind* from the moment it arrives until the first generation
trained after it publishes — so the gauge resets to (what arrived during
the cycle) on each publish, exactly the freshness-SLO semantics.

The buffer is a sliding history, not a queue: rows consumed into a
window stay resident (up to ``max_rows``) so a drift-triggered retrain
can widen its window beyond the fresh delta, and ``window`` never blocks
ingest for longer than a list append (rows are stored as the ingested
chunks and concatenated only at window time, under a short lock).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError


class RowBuffer:
    """Thread-safe bounded row store with ingested/trained accounting."""

    def __init__(self, width: int, max_rows: int = 1 << 20) -> None:
        self.width = int(width)
        self.max_rows = max(int(max_rows), 1)
        self._lock = threading.Lock()
        self._chunks: List[Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]] = []
        self._buffered = 0
        self.rows_ingested = 0
        self.rows_trained = 0
        # overflow evictions of rows that were never trained: they leave
        # the behind count with the chunk (they can never be trained), and
        # the counter makes the loss visible instead of silent
        self.rows_dropped = 0

    def ingest(self, X, y, weight=None) -> int:
        """Append one chunk of labeled rows; returns rows accepted.
        Overflow evicts the OLDEST chunks (drop-oldest: the freshest data
        is what the next generation needs)."""
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2 or X.shape[1] != self.width:
            raise LightGBMError(
                "online ingest expects [n, %d] feature rows, got shape %r"
                % (self.width, X.shape))
        y = np.ascontiguousarray(np.asarray(y, dtype=np.float64)).ravel()
        if len(y) != len(X):
            raise LightGBMError("online ingest got %d rows but %d labels"
                                % (len(X), len(y)))
        w = None
        if weight is not None:
            w = np.ascontiguousarray(
                np.asarray(weight, dtype=np.float64)).ravel()
            if len(w) != len(X):
                raise LightGBMError("online ingest got %d rows but %d "
                                    "weights" % (len(X), len(w)))
        if len(X) == 0:
            return 0
        truncated = 0
        if len(X) > self.max_rows:
            # a single over-cap chunk keeps its newest tail
            truncated = len(X) - self.max_rows
            X, y = X[-self.max_rows:], y[-self.max_rows:]
            w = w[-self.max_rows:] if w is not None else None
        with self._lock:
            # the truncated head still counts as ingested (then dropped):
            # rows_behind = ingested - trained - dropped stays consistent
            self.rows_ingested += len(X) + truncated
            self.rows_dropped += truncated
            self._chunks.append((X, y, w))
            self._buffered += len(X)
            while self._buffered > self.max_rows and len(self._chunks) > 1:
                old = self._chunks.pop(0)
                self._buffered -= len(old[0])
                # behind rows must still be trainable (resident): evicted
                # rows that never made it into a generation move to
                # rows_dropped so the freshness gauge never over-reports
                behind = (self.rows_ingested - self.rows_trained
                          - self.rows_dropped)
                if behind > self._buffered:
                    self.rows_dropped += behind - self._buffered
        return len(X)

    def rows_behind(self) -> int:
        with self._lock:
            return max(self.rows_ingested - self.rows_trained
                       - self.rows_dropped, 0)

    @property
    def buffered(self) -> int:
        with self._lock:
            return self._buffered

    def window(self, max_rows: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
        """Snapshot the newest ``<= max_rows`` buffered rows (0 = all):
        ``(X, y, weight-or-None, behind)`` where ``behind`` is the
        rows-behind count at snapshot time — pass it to
        :meth:`mark_trained` once the generation built from this window
        publishes (rows arriving between snapshot and publish stay
        behind)."""
        with self._lock:
            chunks = list(self._chunks)
            behind = max(self.rows_ingested - self.rows_trained
                         - self.rows_dropped, 0)
        if not chunks:
            return (np.zeros((0, self.width)), np.zeros(0), None, behind)
        Xs = [c[0] for c in chunks]
        ys = [c[1] for c in chunks]
        has_w = any(c[2] is not None for c in chunks)
        X = np.concatenate(Xs) if len(Xs) > 1 else Xs[0]
        y = np.concatenate(ys) if len(ys) > 1 else ys[0]
        w = None
        if has_w:
            w = np.concatenate([c[2] if c[2] is not None
                                else np.ones(len(c[0])) for c in chunks])
        if max_rows and len(X) > max_rows:
            X, y = X[-max_rows:], y[-max_rows:]
            w = w[-max_rows:] if w is not None else None
        return np.ascontiguousarray(X), np.ascontiguousarray(y), w, behind

    def mark_trained(self, behind: int) -> None:
        """A generation trained from a :meth:`window` snapshot published:
        the ``behind`` rows that snapshot covered are no longer behind."""
        with self._lock:
            self.rows_trained += max(int(behind), 0)

    def restore_counters(self, ingested: int, trained: int,
                         dropped: int) -> None:
        """Resume-path counter restore (the rows themselves died with the
        preempted process; the pending window rides its own .npz)."""
        with self._lock:
            self.rows_ingested = max(int(ingested), self.rows_ingested)
            self.rows_trained = max(int(trained), self.rows_trained)
            self.rows_dropped = max(int(dropped), self.rows_dropped)
