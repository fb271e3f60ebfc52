"""Raw-feature prediction of a tree ensemble in plain torch.

Counterpart of ``lightgbm_tpu/core/predict.py`` (and the reference batch
predictor, src/application/predictor.hpp): the JAX package has no Pallas
kernel here, so neither does the port.  The trees are stacked once into
[T, M] node arrays on the device and every row walks all trees at once, one
level per step (the ``StackedTreesPredictor`` traversal vectorized over rows
and trees).  Values and thresholds are compared in f64, like the host
``Tree.predict``.  Numerical splits only.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .tree import K_ZERO_THRESHOLD, Tree


class StackedTrees:
    """One class's trees as stacked device arrays."""

    def __init__(self, trees: List[Tree], device: torch.device) -> None:
        if any(t.num_cat > 0 for t in trees):
            raise NotImplementedError("categorical splits are not ported to "
                                      "lightgbm_tpu_torch yet (ROADMAP queue "
                                      "1 item 6)")
        self.T = T = len(trees)
        M = max([max(t.num_leaves - 1, 1) for t in trees] + [1])
        L = max([t.num_leaves for t in trees] + [1])
        self.depth = int(max([(t.leaf_depth[:t.num_leaves].max()
                               if t.num_leaves > 1 else 0) for t in trees]
                             + [0]))
        sf = np.zeros((T, M), np.int64)
        thr = np.zeros((T, M), np.float64)
        dl = np.zeros((T, M), bool)
        mt = np.zeros((T, M), np.int64)
        lc = np.zeros((T, M), np.int64)
        rc = np.zeros((T, M), np.int64)
        lv = np.zeros((T, L), np.float64)
        start = np.zeros(T, np.int64)
        for i, tree in enumerate(trees):
            ni = max(tree.num_leaves - 1, 0)
            if ni == 0:
                start[i] = -1          # single leaf: ~0
            dt = tree.decision_type[:ni].astype(np.int64)
            sf[i, :ni] = tree.split_feature[:ni]
            thr[i, :ni] = tree.threshold[:ni]
            dl[i, :ni] = (dt & 2) > 0
            mt[i, :ni] = (dt >> 2) & 3
            lc[i, :ni] = tree.left_child[:ni]
            rc[i, :ni] = tree.right_child[:ni]
            lv[i, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.sf, self.thr, self.dl, self.mt = t(sf), t(thr), t(dl), t(mt)
        self.lc, self.rc, self.lv, self.start = t(lc), t(rc), t(lv), t(start)
        self.device = device

    def raw_predict(self, X: torch.Tensor) -> torch.Tensor:
        """[n, D] raw features -> [n] f64 summed leaf values."""
        n = X.shape[0]
        if self.T == 0:
            return torch.zeros(n, dtype=torch.float64, device=self.device)
        X = X.to(self.device, torch.float64)
        ti = torch.arange(self.T, device=self.device)[None, :]
        rows = torch.arange(n, device=self.device)[:, None]
        node = self.start[None, :].expand(n, self.T).clone()
        for _ in range(self.depth):
            nd = torch.clamp(node, min=0)
            fval = X[rows, self.sf[ti, nd]]
            mt = self.mt[ti, nd]
            val = torch.where(torch.isnan(fval) & (mt != 2),
                              torch.zeros_like(fval), fval)
            missing = (((mt == 1) & (torch.abs(val) <= K_ZERO_THRESHOLD))
                       | ((mt == 2) & torch.isnan(val)))
            go_left = torch.where(missing, self.dl[ti, nd],
                                  val <= self.thr[ti, nd])
            nxt = torch.where(go_left, self.lc[ti, nd], self.rc[ti, nd])
            node = torch.where(node >= 0, nxt, node)
        return self.lv[ti, ~node].sum(dim=1)
