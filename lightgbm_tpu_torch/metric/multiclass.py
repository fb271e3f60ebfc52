"""Copied from ``lightgbm_tpu/metric/multiclass.py`` for the PyTorch port (which imports
nothing of the JAX package); unchanged but for this note.

Multiclass metrics (src/metric/multiclass_metric.hpp) and AUC-mu."""
from __future__ import annotations

import numpy as np

from .metric import Metric


class _MulticlassMetric(Metric):
    metric_name = ""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = [self.metric_name]
        self.num_class = int(self.config.num_class)
        self.label_int = self.label.astype(np.int64)

    def point_loss(self, label_int, prob):
        raise NotImplementedError

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(self.num_class, -1)
        if objective is not None:
            prob = np.asarray(objective.convert_output(s))
        else:
            e = np.exp(s - s.max(axis=0, keepdims=True))
            prob = e / e.sum(axis=0, keepdims=True)
        return [self._avg(self.point_loss(self.label_int, prob))]


class MultiSoftmaxLoglossMetric(_MulticlassMetric):
    metric_name = "multi_logloss"

    def point_loss(self, label_int, prob):
        p_true = prob[label_int, np.arange(len(label_int))]
        return -np.log(np.maximum(p_true, 1e-15))


class MultiErrorMetric(_MulticlassMetric):
    metric_name = "multi_error"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        k = int(getattr(self.config, "multi_error_top_k", 1))
        self.top_k = max(k, 1)
        if self.top_k > 1:
            self.names = ["multi_error@%d" % self.top_k]

    def point_loss(self, label_int, prob):
        # error when the true class is not within top-k scores
        # (multiclass_metric.hpp top-k rule: count of classes with prob strictly
        #  greater than the true class's must be < k)
        p_true = prob[label_int, np.arange(len(label_int))]
        rank = (prob > p_true[None, :]).sum(axis=0)
        return (rank >= self.top_k).astype(np.float64)


class AucMuMetric(Metric):
    """AUC-mu: average pairwise class separability
    (multiclass extension of AUC; src/metric/multiclass_metric.hpp AucMuMetric,
    Kleiman & Page ICML'19).

    For each class pair (i, j) samples are ranked by their distance from the
    separating hyperplane ``t1 * v . score`` with ``v = W[i] - W[j]`` and
    ``t1 = v[i] - v[j]``, where W is the ``auc_mu_weights`` partition-loss
    matrix (config.cpp:156-183 GetAucMuWeights; default all-ones off the
    diagonal, for which the ranking reduces to score_i - score_j).  Ties
    contribute half, mirroring the reference's sorted sweep
    (multiclass_metric.hpp:246-280).  Like the reference, sample weights are
    NOT consulted — its Eval counts rows only."""
    factor_to_bigger_better = 1.0

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.names = ["auc_mu"]
        self.num_class = int(self.config.num_class)
        self.label_int = self.label.astype(np.int64)
        k = self.num_class
        weights = list(getattr(self.config, "auc_mu_weights", []) or [])
        if weights:
            if len(weights) != k * k:
                from ..utils.log import Log
                Log.fatal("auc_mu_weights must have %d elements, but found %d",
                          k * k, len(weights))
            self.class_weights = np.asarray(weights, dtype=np.float64
                                            ).reshape(k, k)
            off_diag = ~np.eye(k, dtype=bool)
            if (np.abs(self.class_weights[off_diag]) < 1e-35).any():
                from ..utils.log import Log
                Log.fatal("AUC-mu matrix must have non-zero values for "
                          "non-diagonal entries.")
            np.fill_diagonal(self.class_weights, 0.0)
        else:
            self.class_weights = 1.0 - np.eye(k)

    @staticmethod
    def _pair_auc(dist, is_i):
        """S[i][j]/(n_i*n_j): fraction of (i, j) pairs ranked correctly, ties
        half (the reference's sorted sweep, multiclass_metric.hpp:258-280).

        Tie semantics follow the reference exactly: an i compares against the
        ANCHOR of the current j-run (``last_j_dist``) with kEpsilon tolerance,
        not against its own neighbors; exact-equal scores sort class j first
        (the comparator at :250-251)."""
        k_eps = 1e-15
        order = np.lexsort((is_i, dist))
        d = dist[order]
        ii = is_i[order]
        n = d.size
        n_i = float(np.sum(is_i))
        n_j = float(np.sum(~is_i))
        if n_i == 0 or n_j == 0:
            return 1.0  # no rankable pairs; same credit as both-absent
        # j's strictly before each position
        j_before = np.concatenate([[0.0], np.cumsum(~ii)])[:-1]
        close = np.diff(d) < k_eps
        if not close.any():
            # no epsilon-near neighbors: every i credits all j's before it
            return float(np.sum(j_before[ii])) / (n_i * n_j)
        # a >=eps gap between consecutive elements also separates an element
        # from every earlier anchor (anchors only move up), so chained
        # eps-clusters are independent; run the anchored sweep inside each
        total = 0.0
        boundaries = np.flatnonzero(~close) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [n]])
        for s, e in zip(starts, ends):
            if e - s == 1:
                if ii[s]:
                    total += j_before[s]
                continue
            if d[e - 1] - d[s] < k_eps:
                # whole cluster within kEpsilon of its first element: the
                # anchor never resets, so every i credits j_before + half the
                # j's that sorted before it.  Vectorized — iteration 0 has ALL
                # scores tied and would otherwise run an O(n) Python sweep.
                seg_i = ii[s:e]
                cum_j = np.cumsum(~seg_i)
                total += float(np.sum(j_before[s] + 0.5 * cum_j[seg_i]))
                continue
            if e - s < 64:
                # numpy setup costs more than it saves on tiny clusters
                num_j = 0.0
                last_j = None
                num_cur = 0.0
                for t in range(s, e):
                    if ii[t]:
                        if last_j is not None and abs(d[t] - last_j) < k_eps:
                            total += j_before[s] + num_j - 0.5 * num_cur
                        else:
                            total += j_before[s] + num_j
                    else:
                        num_j += 1.0
                        if last_j is not None and abs(d[t] - last_j) < k_eps:
                            num_cur += 1.0
                        else:
                            last_j = d[t]
                            num_cur = 1.0
                continue
            # Anchored sweep, vectorized (the per-element Python loop above
            # was O(n) interpreted work per class pair per eval round and
            # dominated eval on epsilon-chained score clusters).  The only
            # sequential structure is the j-run ANCHOR chain — a new run
            # starts at the first j whose distance is >= kEpsilon past the
            # current anchor — found by a searchsorted chase over the
            # (sorted) j distances, O(#runs * log n); all per-element
            # credits then assign in one shot.
            segd = d[s:e]
            segi = ii[s:e]
            jd = segd[~segi]                       # j distances, ascending
            excl_j = np.concatenate([[0.0], np.cumsum(~segi)])[:-1]
            if jd.size == 0:
                total += float(np.sum(segi)) * j_before[s]
                continue
            run_starts = []                        # index into jd
            nj = jd.size
            a = 0
            while a < nj:
                run_starts.append(a)
                # difference form, NOT searchsorted(jd, jd[a] + k_eps): at
                # |d| >> k_eps the addition absorbs the epsilon entirely,
                # while the loop this replaces compared d[t] - last_j.
                # Galloping window: a full-tail slice per run is quadratic
                # on long anchor chains.
                base = jd[a]
                lo = a + 1
                step = 32
                hi = min(lo + step, nj)
                while hi < nj and jd[hi - 1] - base < k_eps:
                    lo = hi
                    step *= 2
                    hi = min(lo + step, nj)
                a = lo + int(np.searchsorted(jd[lo:hi] - base, k_eps,
                                             side="left"))
            run_starts = np.asarray(run_starts)
            rid_of_j = np.searchsorted(run_starts,
                                       np.arange(jd.size), side="right") - 1
            anchors = jd[run_starts]
            # per position: index of the last j strictly before it (into jd)
            jn = excl_j.astype(np.int64) - 1
            has_j = (jn >= 0) & segi
            jn_c = np.maximum(jn, 0)
            rid = rid_of_j[jn_c]
            # "within kEpsilon of the current run's anchor" — exactly the
            # reference comparison against last_j_dist (:258-280)
            within = has_j & (np.abs(segd - anchors[rid]) < k_eps)
            num_cur = (jn_c + 1 - run_starts[rid]).astype(np.float64)
            credit = j_before[s] + excl_j - np.where(within, 0.5 * num_cur,
                                                     0.0)
            total += float(np.sum(credit[segi]))
        return total / (n_i * n_j)

    def eval(self, score, objective=None):
        s = np.asarray(score, dtype=np.float64).reshape(self.num_class, -1)
        k = self.num_class
        w = self.class_weights
        total = 0.0
        for i in range(k):
            for j in range(i + 1, k):
                sel = (self.label_int == i) | (self.label_int == j)
                if not sel.any():
                    total += 1.0
                    continue
                v = w[i] - w[j]
                t1 = v[i] - v[j]
                dist = t1 * (v @ s[:, sel])
                is_i = self.label_int[sel] == i
                total += self._pair_auc(dist, is_i)
        return [float(2.0 * total / (k * (k - 1)))]
