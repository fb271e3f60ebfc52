"""Copied from ``lightgbm_tpu/core/tree.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Decision-tree model: flat node arrays, prediction, reference-format serialization.

Counterpart of the reference ``Tree`` (include/LightGBM/tree.h, src/io/tree.cpp):
arrays-of-nodes with ``~leaf`` encoding for leaf children, decision_type bit flags
(bit0 categorical, bit1 default-left, bits2-3 missing type — tree.h:19-20,210-229),
numerical/categorical decisions with missing handling (tree.h:240-331), and the
``ToString`` text block format (tree.cpp ``Tree::ToString``) kept key-compatible so
models interoperate with the reference's model files.

Prediction here is vectorized NumPy level-by-level traversal instead of the
reference's per-row recursive descent; the port's batch path runs on the
device in ``core/predict.py``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
K_ZERO_THRESHOLD = 1e-35


def _fmt(x: float) -> str:
    return np.format_float_scientific(x, trim="-") if (
        x != 0 and (abs(x) < 1e-4 or abs(x) >= 1e16)) else repr(float(x))


def _arr_str(arr, fmt=str) -> str:
    return " ".join(fmt(v) for v in arr)


class Tree:
    """Host tree model; built from device arrays or parsed from a model string."""

    def __init__(self, max_leaves: int = 1) -> None:
        m = max(max_leaves, 1)
        self.num_leaves = 1
        self.num_cat = 0
        self.shrinkage = 1.0
        # internal nodes (num_leaves - 1 valid entries)
        self.split_feature_inner = np.zeros(m - 1, dtype=np.int32)
        self.split_feature = np.zeros(m - 1, dtype=np.int32)
        self.split_gain = np.zeros(m - 1, dtype=np.float32)
        self.threshold_in_bin = np.zeros(m - 1, dtype=np.int32)
        self.threshold = np.zeros(m - 1, dtype=np.float64)
        self.decision_type = np.zeros(m - 1, dtype=np.int8)
        self.left_child = np.zeros(m - 1, dtype=np.int32)
        self.right_child = np.zeros(m - 1, dtype=np.int32)
        self.internal_value = np.zeros(m - 1, dtype=np.float64)
        self.internal_weight = np.zeros(m - 1, dtype=np.float64)
        self.internal_count = np.zeros(m - 1, dtype=np.int64)
        # leaves
        self.leaf_value = np.zeros(m, dtype=np.float64)
        self.leaf_weight = np.zeros(m, dtype=np.float64)
        self.leaf_count = np.zeros(m, dtype=np.int64)
        self.leaf_parent = np.full(m, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(m, dtype=np.int32)
        # categorical split storage (bitsets, tree.h cat_boundaries_/cat_threshold_)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []

    # ---- decision_type helpers (tree.h:210-229) ----

    @staticmethod
    def make_decision_type(categorical: bool, default_left: bool,
                           missing_type: int) -> int:
        dt = 0
        if categorical:
            dt |= K_CATEGORICAL_MASK
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (int(missing_type) & 3) << 2
        return dt

    @staticmethod
    def missing_type_of(dt: int) -> int:
        return (int(dt) >> 2) & 3

    # ---- prediction (vectorized NumericalDecision/CategoricalDecision) ----

    def _decide(self, fval: np.ndarray, node: int) -> np.ndarray:
        """Return boolean go_left for rows at `node` given raw feature values."""
        dt = int(self.decision_type[node])
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        mt = self.missing_type_of(dt)
        if dt & K_CATEGORICAL_MASK:
            nan_mask = np.isnan(fval)
            int_fval = np.where(nan_mask, 0.0, fval).astype(np.int64)
            cat_idx = int(self.threshold[node])
            lo = self.cat_boundaries[cat_idx]
            hi = self.cat_boundaries[cat_idx + 1]
            if hi <= lo:
                return np.zeros_like(int_fval, dtype=bool)
            bits = np.asarray(self.cat_threshold[lo:hi], dtype=np.uint64)
            word = int_fval >> 5
            in_range = (int_fval >= 0) & (word < (hi - lo))
            wsafe = np.clip(word, 0, hi - lo - 1)
            bit = ((bits[wsafe] >> (int_fval & 31).astype(np.uint64)) & 1).astype(bool)
            go_left = in_range & bit
            # NaN goes right when the split saw NaNs (tree.h:283-287)
            return np.where(nan_mask & (mt == 2), False, go_left)
        thr = float(self.threshold[node])
        val = np.where(np.isnan(fval) & (mt != 2), 0.0, fval)
        is_missing = ((mt == 1) & (np.abs(val) <= K_ZERO_THRESHOLD)
                      | (mt == 2) & np.isnan(val))
        return np.where(is_missing, default_left, val <= thr)

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        """Vectorized GetLeaf over raw features [N, D] -> leaf index [N]."""
        n = len(X)
        if self.num_leaves == 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)   # >= 0 internal, < 0 ~leaf
        live = np.ones(n, dtype=bool)
        for _ in range(int(self.leaf_depth.max()) + 1 if self.leaf_depth.any()
                       else self.num_leaves):
            live = node >= 0
            if not live.any():
                break
            for nd in np.unique(node[live]):
                rows = np.flatnonzero(node == nd)
                go_left = self._decide(X[rows, self.split_feature[nd]], int(nd))
                node[rows] = np.where(go_left, self.left_child[nd],
                                      self.right_child[nd])
        return (~node).astype(np.int32)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.leaf_value[self.predict_leaf_index(X)]

    # ---- training-side mutation (Tree::Split, tree.h:333-371) ----

    def shrink(self, rate: float) -> None:
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:max(self.num_leaves - 1, 0)] += val

    def set_leaf_output(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = value

    # ---- serialization (tree.cpp Tree::ToString / Tree::LoadTreeFromString) ----

    def to_string(self) -> str:
        nl = self.num_leaves
        ni = max(nl - 1, 0)
        lines = [
            "num_leaves=%d" % nl,
            "num_cat=%d" % self.num_cat,
            "split_feature=" + _arr_str(self.split_feature[:ni]),
            "split_gain=" + _arr_str(self.split_gain[:ni], lambda v: _fmt(float(v))),
            "threshold=" + _arr_str(self.threshold[:ni], lambda v: _fmt(float(v))),
            "decision_type=" + _arr_str(self.decision_type[:ni]),
            "left_child=" + _arr_str(self.left_child[:ni]),
            "right_child=" + _arr_str(self.right_child[:ni]),
            "leaf_value=" + _arr_str(self.leaf_value[:nl], lambda v: _fmt(float(v))),
            "leaf_weight=" + _arr_str(self.leaf_weight[:nl], lambda v: _fmt(float(v))),
            "leaf_count=" + _arr_str(self.leaf_count[:nl]),
            "internal_value=" + _arr_str(self.internal_value[:ni],
                                         lambda v: _fmt(float(v))),
            "internal_weight=" + _arr_str(self.internal_weight[:ni],
                                          lambda v: _fmt(float(v))),
            "internal_count=" + _arr_str(self.internal_count[:ni]),
        ]
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + _arr_str(self.cat_boundaries))
            lines.append("cat_threshold=" + _arr_str(self.cat_threshold))
        lines.append("shrinkage=%s" % _fmt(self.shrinkage))
        return "\n".join(lines) + "\n\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        t = cls(max_leaves=nl)
        t.num_leaves = nl
        t.num_cat = int(kv.get("num_cat", 0))
        t.shrinkage = float(kv.get("shrinkage", 1.0))

        def read(key, dtype, n):
            if n == 0 or key not in kv or not kv[key]:
                return np.zeros(n, dtype=dtype)
            return np.asarray(kv[key].split(), dtype=dtype)

        ni = max(nl - 1, 0)
        t.split_feature = read("split_feature", np.int32, ni)
        t.split_feature_inner = t.split_feature.copy()
        t.split_gain = read("split_gain", np.float32, ni)
        t.threshold = read("threshold", np.float64, ni)
        t.decision_type = read("decision_type", np.int8, ni)
        t.left_child = read("left_child", np.int32, ni)
        t.right_child = read("right_child", np.int32, ni)
        t.leaf_value = read("leaf_value", np.float64, nl)
        t.leaf_weight = read("leaf_weight", np.float64, nl)
        t.leaf_count = read("leaf_count", np.int64, nl)
        t.internal_value = read("internal_value", np.float64, ni)
        t.internal_weight = read("internal_weight", np.float64, ni)
        t.internal_count = read("internal_count", np.int64, ni)
        if t.num_cat > 0:
            t.cat_boundaries = [int(v) for v in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(v) for v in kv["cat_threshold"].split()]
        t._recompute_depths()
        return t

    def _recompute_depths(self) -> None:
        if self.num_leaves <= 1:
            return
        self.leaf_depth = np.zeros(self.num_leaves, dtype=np.int32)
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            for child in (self.left_child[node], self.right_child[node]):
                if child < 0:
                    self.leaf_depth[~child] = d + 1
                else:
                    stack.append((int(child), d + 1))

    def to_json(self) -> dict:
        def node_json(index: int) -> dict:
            if index >= 0:
                dt = int(self.decision_type[index])
                is_cat = bool(dt & K_CATEGORICAL_MASK)
                if is_cat:
                    cat_idx = int(self.threshold[index])
                    lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
                    cats = [i * 32 + j for i in range(hi - lo) for j in range(32)
                            if (self.cat_threshold[lo + i] >> j) & 1]
                    thr = "||".join(str(c) for c in cats)
                else:
                    thr = float(self.threshold[index])
                return {
                    "split_index": index,
                    "split_feature": int(self.split_feature[index]),
                    "split_gain": float(self.split_gain[index]),
                    "threshold": thr,
                    "decision_type": "==" if is_cat else "<=",
                    "default_left": bool(dt & K_DEFAULT_LEFT_MASK),
                    "missing_type": ["None", "Zero", "NaN"][self.missing_type_of(dt)],
                    "internal_value": float(self.internal_value[index]),
                    "internal_weight": float(self.internal_weight[index]),
                    "internal_count": int(self.internal_count[index]),
                    "left_child": node_json(int(self.left_child[index])),
                    "right_child": node_json(int(self.right_child[index])),
                }
            leaf = ~index
            return {
                "leaf_index": leaf,
                "leaf_value": float(self.leaf_value[leaf]),
                "leaf_weight": float(self.leaf_weight[leaf]),
                "leaf_count": int(self.leaf_count[leaf]),
            }

        out = {"num_leaves": int(self.num_leaves), "num_cat": int(self.num_cat),
               "shrinkage": float(self.shrinkage)}
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            out["tree_structure"] = node_json(0)
        return out

    # ---- SHAP contributions (tree.h:133 PredictContrib, src/io/tree.cpp
    # TreeSHAP — the Lundberg & Lee exact tree SHAP algorithm) ----

    def expected_value(self) -> float:
        nl = self.num_leaves
        if nl == 1:
            return float(self.leaf_value[0])
        total = float(self.leaf_count[:nl].sum())
        if total <= 0:
            return float(self.leaf_value[:nl].mean())
        return float((self.leaf_value[:nl] * self.leaf_count[:nl]).sum() / total)

    def _node_count(self, node: int) -> float:
        return float(self.leaf_count[~node] if node < 0
                     else self.internal_count[node])

    def predict_contrib_row(self, x: np.ndarray, phi: np.ndarray) -> None:
        """Add this tree's SHAP values for one row into phi [num_features+1].

        Accumulation order is CANONICAL: expected value first, then leaves
        in index order, then path positions in order.  Each leaf's weights
        are bit-identical to the plain hot-first recursion (a leaf's ops
        depend only on its own root path); only the f64 add order into phi
        is fixed — which is what lets the device path-decomposition kernel
        (core/predict_contrib.py) replay it bit-exactly, where the old
        row-dependent DFS order could not be reproduced."""
        phi[-1] += self.expected_value()
        if self.num_leaves == 1:
            return
        per_leaf = [[] for _ in range(self.num_leaves)]
        self._shap_recurse(x, per_leaf, 0, [], 1.0, 1.0, -1)
        for terms in per_leaf:
            for feat, val in terms:
                phi[feat] += val

    @staticmethod
    def _extend_path(path, pzf, pof, pfi):
        path = [list(p) for p in path] + [[pfi, pzf, pof,
                                           1.0 if len(path) == 0 else 0.0]]
        n = len(path) - 1
        for i in range(n - 1, -1, -1):
            path[i + 1][3] += pof * path[i][3] * (i + 1) / (n + 1)
            path[i][3] = pzf * path[i][3] * (n - i) / (n + 1)
        return path

    @staticmethod
    def _unwind_path(path, path_index):
        n = len(path) - 1
        ofr = path[path_index][2]
        zfr = path[path_index][1]
        next_one_portion = path[n][3]
        out = [list(p) for p in path]
        for i in range(n - 1, -1, -1):
            if ofr != 0:
                tmp = out[i][3]
                out[i][3] = next_one_portion * (n + 1) / ((i + 1) * ofr)
                next_one_portion = tmp - out[i][3] * zfr * (n - i) / (n + 1)
            else:
                out[i][3] = out[i][3] * (n + 1) / (zfr * (n - i))
        # recomputed pweights stay AT THEIR INDEX; only the identity fields
        # (feature, zero/one fractions) shift down past the removed entry —
        # popping the entry itself would also shift the pweights and break
        # the local-accuracy (sum-to-raw-score) property
        for i in range(path_index, n):
            out[i][0] = out[i + 1][0]
            out[i][1] = out[i + 1][1]
            out[i][2] = out[i + 1][2]
        out.pop()
        return out

    @staticmethod
    def _unwound_path_sum(path, path_index):
        n = len(path) - 1
        ofr = path[path_index][2]
        zfr = path[path_index][1]
        next_one_portion = path[n][3]
        total = 0.0
        for i in range(n - 1, -1, -1):
            if ofr != 0:
                tmp = next_one_portion * (n + 1) / ((i + 1) * ofr)
                total += tmp
                next_one_portion = path[i][3] - tmp * zfr * ((n - i) / (n + 1))
            elif zfr != 0:
                total += (path[i][3] / zfr) / ((n - i) / (n + 1))
        return total

    def _shap_recurse(self, x, per_leaf, node, parent_path, pzf, pof, pfi):
        path = self._extend_path(parent_path, pzf, pof, pfi)
        if node < 0:
            leaf = ~node
            for i in range(1, len(path)):
                w = self._unwound_path_sum(path, i)
                el = path[i]
                per_leaf[leaf].append(
                    (el[0], w * (el[2] - el[1]) * self.leaf_value[leaf]))
            return
        go_left = bool(self._decide(np.asarray([x[self.split_feature[node]]]),
                                    node)[0])
        hot = int(self.left_child[node] if go_left else self.right_child[node])
        cold = int(self.right_child[node] if go_left else self.left_child[node])
        hot_zf = self._node_count(hot) / max(self._node_count(node), 1e-300)
        cold_zf = self._node_count(cold) / max(self._node_count(node), 1e-300)
        izf, iof = 1.0, 1.0
        split_f = int(self.split_feature[node])
        path_index = next((i for i, p in enumerate(path) if p[0] == split_f),
                          len(path))
        if path_index != len(path):
            izf = path[path_index][1]
            iof = path[path_index][2]
            path = self._unwind_path(path, path_index)
        self._shap_recurse(x, per_leaf, hot, path, hot_zf * izf, iof, split_f)
        self._shap_recurse(x, per_leaf, cold, path, cold_zf * izf, 0.0,
                           split_f)

    def predict_contrib(self, X: np.ndarray, ncol: int) -> np.ndarray:
        """SHAP values [N, num_features + 1] (last column = expected value)."""
        out = np.zeros((len(X), ncol), dtype=np.float64)
        for r in range(len(X)):
            self.predict_contrib_row(X[r], out[r])
        return out

    # ---- feature importance contributions (boosting.h:229 semantics) ----

    def splits_by_feature(self) -> np.ndarray:
        return self.split_feature[:max(self.num_leaves - 1, 0)]

    def gains_by_feature(self):
        ni = max(self.num_leaves - 1, 0)
        return self.split_feature[:ni], self.split_gain[:ni]
