"""Copied from ``lightgbm_tpu/io/metadata.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Per-row training metadata: labels, weights, query boundaries, init scores.

Counterpart of the reference ``Metadata`` (include/LightGBM/dataset.h:41-250,
src/io/metadata.cpp): owns label/weight/group/init_score arrays, converts per-row
query ids into query boundaries, and derives query weights when both weights and
queries are present.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import Log


class Metadata:
    def __init__(self, num_data: int) -> None:
        self.num_data = int(num_data)
        self.label: np.ndarray = np.zeros(num_data, dtype=np.float32)
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal("Length of label (%d) is not same with #data (%d)",
                      len(label), self.num_data)
        self.label = label

    def set_weights(self, weights) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.ascontiguousarray(weights, dtype=np.float32).reshape(-1)
        if len(weights) != self.num_data:
            Log.fatal("Length of weights (%d) is not same with #data (%d)",
                      len(weights), self.num_data)
        self.weights = weights
        self._update_query_weights()

    def set_group(self, group) -> None:
        """``group`` is per-query sizes (Python API convention, metadata.cpp SetQuery)."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        sizes = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if bounds[-1] != self.num_data:
            Log.fatal("Sum of query counts (%d) differs from #data (%d)",
                      bounds[-1], self.num_data)
        self.query_boundaries = bounds
        self._update_query_weights()

    def set_query_ids(self, qids) -> None:
        """Per-row query ids (CLI query-file convention) -> run-length sizes."""
        qids = np.ascontiguousarray(qids).reshape(-1)
        if len(qids) != self.num_data:
            Log.fatal("Length of query ids (%d) is not same with #data (%d)",
                      len(qids), self.num_data)
        change = np.flatnonzero(qids[1:] != qids[:-1]) + 1
        sizes = np.diff(np.concatenate([[0], change, [len(qids)]]))
        self.set_group(sizes)

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        init_score = np.ascontiguousarray(init_score, dtype=np.float64).reshape(-1)
        if len(init_score) % self.num_data != 0:
            Log.fatal("Initial score size (%d) is not a multiple of #data (%d)",
                      len(init_score), self.num_data)
        self.init_score = init_score

    def _update_query_weights(self) -> None:
        """Average row weight per query (metadata.cpp query weight derivation)."""
        if self.weights is None or self.query_boundaries is None:
            self.query_weights = None
            return
        b = self.query_boundaries
        sums = np.add.reduceat(self.weights, b[:-1])
        self.query_weights = (sums / np.maximum(np.diff(b), 1)).astype(np.float32)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def subset(self, indices: np.ndarray) -> "Metadata":
        out = Metadata(len(indices))
        out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            k = len(self.init_score) // self.num_data
            mat = self.init_score.reshape(k, self.num_data)
            out.init_score = mat[:, indices].reshape(-1)
        if self.query_boundaries is not None:
            # subsetting ranked data keeps whole queries only if indices align;
            # mirror the reference by re-deriving query ids per row
            qid = np.searchsorted(self.query_boundaries, indices, side="right") - 1
            out.set_query_ids(qid)
        out._update_query_weights()
        return out
