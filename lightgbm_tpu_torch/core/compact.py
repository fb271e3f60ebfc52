"""Ensemble compaction: lossy distillation of a trained booster.

The counterpart of ``lightgbm_tpu/core/compact.py`` (:1-399), host numpy
over the host trees, the same passes and the same declared bound:

- **leaf-value codebook**: leaves are quantized to a uniform grid over the
  leaf range of their block of trees; a tree's error is at most half the
  block's grid step, and ``declared_max_score_delta`` sums the bound over
  all trees.  The blocks are the JAX package's ``predict_fused.tree_block``
  (predict_fused.py:75-94: a 1 MiB budget of [G, M, L] f32 path matrices,
  at most 64 trees, rebalanced so the last block is not ragged), kept here
  as :func:`tree_block` for this purpose only: the port's walk blocks
  (``_Stacked.block_size``) would give other codebooks, and the compacted
  model would differ from the JAX package's;
- **identical-subtree merging**: after quantization a split whose two
  subtrees route and score every row the same is redundant and collapses
  into one merged subtree (weights and counts summed): exact, nothing
  added to the bound;
- optional **spread pruning** (``prune_frac``) and a **leaf cap**
  (``leaf_cap``), each collapsing whole subtrees to their weighted-mean
  leaf and declaring half the largest collapsed spread.

:func:`compact_booster` mints the result as an immutable generation
through the model-text round trip (the online controller's
``_freeze_generation``), carrying the parent's score fingerprints, so it
``swap``s into a ``ModelRegistry`` like any retrained generation.
:func:`measure_compaction` measures ``max_score_delta`` and the AUC delta
on real rows.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tree import Tree

# default codebook width: 255 codes ≈ the u8 regime minus a reserved slot;
# fine enough that the summed per-tree bound stays small on shrunk leaves,
# coarse enough that sibling leaves actually collide and merge
DEFAULT_LEAF_CODES = 255


# the JAX package's tree-block sizing (predict_fused.py:60-94): path-matrix
# f32 bytes a block, and the most trees a block
BLOCK_BUDGET_BYTES = 1 << 20
BLOCK_MAX = 64


def tree_block(t: int, m: int, l: int,
               budget_bytes: int = BLOCK_BUDGET_BYTES) -> int:
    """Trees a codebook block: the most whose [G, M, L] f32 path matrices
    fit ``budget_bytes`` (at most :data:`BLOCK_MAX`), rebalanced so the
    last block is not ragged (T = 100 at a cap of 32: 4 blocks of 25)."""
    per_tree = max(m * l * 4, 1)
    cap = max(1, min(BLOCK_MAX, int(budget_bytes) // per_tree, max(t, 1)))
    n_blocks = -(-max(t, 1) // cap)
    return -(-max(t, 1) // n_blocks)


# ---- recursive node form (arrays -> nodes -> arrays) ----

def _extract(tree: Tree, signed: int) -> dict:
    """Tree arrays -> recursive node dicts (``~leaf`` child encoding)."""
    if signed < 0:
        i = ~signed
        return {"leaf": True, "value": float(tree.leaf_value[i]),
                "weight": float(tree.leaf_weight[i]),
                "count": int(tree.leaf_count[i])}
    return {"leaf": False,
            "feature": int(tree.split_feature[signed]),
            "threshold": float(tree.threshold[signed]),
            "dt": int(tree.decision_type[signed]),
            "gain": float(tree.split_gain[signed]),
            "value": float(tree.internal_value[signed]),
            "weight": float(tree.internal_weight[signed]),
            "count": int(tree.internal_count[signed]),
            "l": _extract(tree, int(tree.left_child[signed])),
            "r": _extract(tree, int(tree.right_child[signed]))}


def _sig(node: dict):
    """Semantic signature: routing + leaf values, NOT weights/counts —
    two subtrees with equal signatures score every row identically."""
    if node["leaf"]:
        return ("l", np.float64(node["value"]).tobytes())
    return ("s", node["feature"], np.float64(node["threshold"]).tobytes(),
            node["dt"], _sig(node["l"]), _sig(node["r"]))


def _merge_equal(a: dict, b: dict) -> dict:
    """Merge two signature-equal subtrees: identical structure/values,
    weights and counts summed (the collapsed node's population is the
    union of both branches')."""
    if a["leaf"]:
        return {"leaf": True, "value": a["value"],
                "weight": a["weight"] + b["weight"],
                "count": a["count"] + b["count"]}
    out = dict(a)
    out["weight"] = a["weight"] + b["weight"]
    out["count"] = a["count"] + b["count"]
    out["l"] = _merge_equal(a["l"], b["l"])
    out["r"] = _merge_equal(a["r"], b["r"])
    return out


def _collapse(node: dict) -> dict:
    """Bottom-up identical-subtree merge (exact pass)."""
    if node["leaf"]:
        return node
    node = dict(node)
    node["l"] = _collapse(node["l"])
    node["r"] = _collapse(node["r"])
    if _sig(node["l"]) == _sig(node["r"]):
        return _merge_equal(node["l"], node["r"])
    return node


def _prune_spread(node: dict, tol: float) -> dict:
    """Bounded-spread subtree pruning (lossy, declared): any subtree whose
    leaf values span ≤ ``tol`` collapses to one leaf at the weight-weighted
    mean — every row routed into it moves by at most ``tol/2``.  Bottom-up,
    so the largest prunable subtree wins."""
    if node["leaf"]:
        return node
    node = dict(node)
    node["l"] = _prune_spread(node["l"], tol)
    node["r"] = _prune_spread(node["r"], tol)
    lo, hi, vsum, wsum, weight, count = _agg(node)
    if hi - lo <= tol:
        return {"leaf": True, "value": vsum / wsum,
                "weight": weight, "count": count}
    return node


def _agg(nd: dict):
    """(lo, hi, value_sum*w, w_sum, weight, count) over a subtree's leaves."""
    if nd["leaf"]:
        w = max(nd["weight"], 1e-300)
        return (nd["value"], nd["value"], nd["value"] * w, w,
                nd["weight"], nd["count"])
    lo1, hi1, s1, sw1, w1, c1 = _agg(nd["l"])
    lo2, hi2, s2, sw2, w2, c2 = _agg(nd["r"])
    return (min(lo1, lo2), max(hi1, hi2), s1 + s2, sw1 + sw2,
            w1 + w2, c1 + c2)


def _cap_leaves(node: dict, cap: int) -> Tuple[dict, float]:
    """Collapse minimal-spread subtrees until the tree has ≤ ``cap``
    leaves.  Each collapse replaces a whole subtree by its weighted-mean
    leaf; a row lands in at most one collapsed leaf, so the per-tree error
    bound is half the LARGEST spread collapsed (returned).  This is the
    pass that shrinks ``max(num_leaves)`` across the ensemble — i.e. the
    [T, M, L] path matrices every blocked dispatch moves."""
    worst = 0.0
    while _count_leaves(node) > max(int(cap), 1):
        best = None  # (spread, path) — the cheapest whole-subtree collapse

        def scan(nd, path):
            nonlocal best
            if nd["leaf"]:
                return
            lo, hi, _, _, _, _ = _agg(nd)
            spread = hi - lo
            if best is None or spread < best[0]:
                best = (spread, path)
            scan(nd["l"], path + ("l",))
            scan(nd["r"], path + ("r",))

        scan(node, ())
        if best is None:
            break
        spread, path = best
        worst = max(worst, spread)

        def collapse_at(nd, path):
            if not path:
                lo, hi, vsum, wsum, weight, count = _agg(nd)
                return {"leaf": True, "value": vsum / wsum,
                        "weight": weight, "count": count}
            out = dict(nd)
            out[path[0]] = collapse_at(nd[path[0]], path[1:])
            return out

        node = collapse_at(node, path)
    return node, worst


def _quantize(node: dict, codebook: np.ndarray) -> dict:
    if node["leaf"]:
        i = int(np.argmin(np.abs(codebook - node["value"])))
        out = dict(node)
        out["value"] = float(codebook[i])
        return out
    out = dict(node)
    out["l"] = _quantize(node["l"], codebook)
    out["r"] = _quantize(node["r"], codebook)
    return out


def _count_leaves(node: dict) -> int:
    if node["leaf"]:
        return 1
    return _count_leaves(node["l"]) + _count_leaves(node["r"])


def _rebuild(node: dict, template: Tree) -> Tree:
    """Recursive nodes -> a fresh Tree in LightGBM's index discipline
    (pre-order internal numbering, ``~leaf`` children); categorical
    bitset storage is copied wholesale from the template so cat splits
    keep their ``threshold``-as-cat-index indirection valid."""
    nl = _count_leaves(node)
    t = Tree(max_leaves=nl)
    t.num_leaves = nl
    t.num_cat = template.num_cat
    t.shrinkage = template.shrinkage
    t.cat_boundaries = list(template.cat_boundaries)
    t.cat_threshold = list(template.cat_threshold)
    t.cat_boundaries_inner = list(template.cat_boundaries_inner)
    t.cat_threshold_inner = list(template.cat_threshold_inner)
    if nl == 1:
        t.leaf_value[0] = node["value"]
        t.leaf_weight[0] = node["weight"]
        t.leaf_count[0] = node["count"]
        return t
    counters = {"i": 0, "leaf": 0}

    def build(nd: dict, parent: int) -> int:
        if nd["leaf"]:
            j = counters["leaf"]
            counters["leaf"] += 1
            t.leaf_value[j] = nd["value"]
            t.leaf_weight[j] = nd["weight"]
            t.leaf_count[j] = nd["count"]
            t.leaf_parent[j] = parent
            return ~j
        i = counters["i"]
        counters["i"] += 1
        t.split_feature[i] = nd["feature"]
        t.split_feature_inner[i] = nd["feature"]
        t.threshold[i] = nd["threshold"]
        t.decision_type[i] = nd["dt"]
        t.split_gain[i] = nd["gain"]
        t.internal_value[i] = nd["value"]
        t.internal_weight[i] = nd["weight"]
        t.internal_count[i] = nd["count"]
        t.left_child[i] = build(nd["l"], i)
        t.right_child[i] = build(nd["r"], i)
        return i

    build(node, -1)
    t._recompute_depths()
    return t


# ---- the compaction passes ----

def _ensemble_bytes(trees: List[Tree]) -> int:
    """Footprint of the ensemble's raw f32 predictor (the tensors a serving
    registry holds for it, ``FusedPredictor.nbytes``), stacked on the
    host: the denominator of ``byte_reduction``."""
    if not trees:
        return 0
    from .predict_fused import FusedPredictor
    return int(FusedPredictor(trees, device="cpu").nbytes())


def compact_trees(trees: List[Tree], leaf_codes: int = DEFAULT_LEAF_CODES,
                  merge_subtrees: bool = True, prune_frac: float = 0.0,
                  leaf_cap: Optional[int] = None,
                  block_g: Optional[int] = None
                  ) -> Tuple[List[Tree], Dict]:
    """Cap + prune + quantize + merge ``trees``; returns (new_trees, stats).

    Per tree the lossy budget is half the largest collapsed spread
    (``leaf_cap`` / ``prune_frac`` passes — a row lands in at most one
    collapsed leaf) plus half the codebook grid step (leaf quantization);
    ``stats['declared_max_score_delta']`` sums both bounds over all
    trees.  The *measured* delta the gate checks is computed by
    :func:`measure_compaction` on real rows and can only be tighter."""
    if not trees:
        return [], {"trees": 0, "nodes_in": 0, "nodes_out": 0,
                    "tree_reduction": 0.0, "byte_reduction": 0.0,
                    "model_byte_reduction": 0.0,
                    "declared_max_score_delta": 0.0, "leaf_codes": 0}
    m = max(max(t.num_leaves - 1, 1) for t in trees)
    l = max(t.num_leaves for t in trees)
    g = int(block_g) if block_g else tree_block(len(trees), m, l)
    bytes_in = _ensemble_bytes(trees)
    mbytes_in = sum(len(t.to_string()) for t in trees)
    nodes_in = sum(2 * t.num_leaves - 1 for t in trees)
    out: List[Tree] = []
    declared = 0.0
    for lo in range(0, len(trees), g):
        block = trees[lo:lo + g]
        vals = np.concatenate([t.leaf_value[:t.num_leaves] for t in block])
        vmin, vmax = float(vals.min()), float(vals.max())
        tol = max(prune_frac, 0.0) * (vmax - vmin)
        if leaf_codes > 1 and vmax > vmin:
            codebook = np.linspace(vmin, vmax, int(leaf_codes))
            step = (vmax - vmin) / (int(leaf_codes) - 1)
        else:
            codebook = np.asarray([vmin])
            step = 0.0
        for t in block:
            node = _extract(t, 0 if t.num_leaves > 1 else ~0)
            worst = 0.0
            if tol > 0.0:
                node = _prune_spread(node, tol)
                worst = tol
            if leaf_cap is not None:
                node, capped = _cap_leaves(node, int(leaf_cap))
                worst = max(worst, capped)
            node = _quantize(node, codebook)
            if merge_subtrees:
                node = _collapse(node)
            out.append(_rebuild(node, t))
            declared += step / 2.0 + worst / 2.0
    nodes_out = sum(2 * t.num_leaves - 1 for t in out)
    bytes_out = _ensemble_bytes(out)
    mbytes_out = sum(len(t.to_string()) for t in out)
    stats = {
        "trees": len(trees),
        "nodes_in": int(nodes_in), "nodes_out": int(nodes_out),
        "tree_reduction": (1.0 - nodes_out / nodes_in) if nodes_in else 0.0,
        "bytes_in": int(bytes_in), "bytes_out": int(bytes_out),
        "byte_reduction": (1.0 - bytes_out / bytes_in) if bytes_in else 0.0,
        "model_bytes_in": int(mbytes_in), "model_bytes_out": int(mbytes_out),
        "model_byte_reduction": (1.0 - mbytes_out / mbytes_in)
        if mbytes_in else 0.0,
        "declared_max_score_delta": float(declared),
        "leaf_codes": int(leaf_codes), "prune_frac": float(prune_frac),
        "leaf_cap": int(leaf_cap) if leaf_cap is not None else None,
        "block_g": int(g),
        "max_leaves_in": int(l),
        "max_leaves_out": max((t.num_leaves for t in out), default=1),
    }
    return out, stats


def compact_booster(booster, leaf_codes: int = DEFAULT_LEAF_CODES,
                    merge_subtrees: bool = True, prune_frac: float = 0.0,
                    leaf_cap: Optional[int] = None,
                    block_g: Optional[int] = None):
    """Mint a distilled immutable generation from ``booster``.

    Same machinery as ``online.controller._freeze_generation``: the model
    text decouples the distilled booster (on ``booster``'s device) from
    the parent's tree list, the compacted trees replace the copies and
    every stacked-predictor cache is dropped.  Score fingerprints ride
    along, so a registry swap keeps the quality plane's score-PSI
    baseline: a compacted republish behaves like a retrained one."""
    from ..boosting.gbdt import GBDT
    booster = getattr(booster, "_booster", booster)
    gen = GBDT(booster.config, device=booster.device)
    gen.load_model_from_string(booster.save_model_to_string())
    new_trees, stats = compact_trees(gen.models, leaf_codes=leaf_codes,
                                     merge_subtrees=merge_subtrees,
                                     prune_frac=prune_frac,
                                     leaf_cap=leaf_cap, block_g=block_g)
    gen.models = new_trees
    gen._invalidate_predict_cache()
    gen.trained_at = getattr(booster, "trained_at", None) or time.time()
    for attr in ("_score_fingerprint_raw", "_score_fingerprint_out",
                 "quality_name"):
        if getattr(booster, attr, None) is not None:
            setattr(gen, attr, getattr(booster, attr))
    return gen, stats


# ---- measurement (feeds the error-budget gate) ----

def _auc(scores: np.ndarray, y: np.ndarray) -> float:
    """Rank AUC (average tie rank) — no external metric dependency."""
    scores = np.asarray(scores, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64) > 0
    npos = int(y.sum())
    nneg = int(y.size - npos)
    if npos == 0 or nneg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[y].sum() - npos * (npos + 1) / 2.0) / (npos * nneg))


def measure_compaction(booster, gen, X: np.ndarray,
                       y: Optional[np.ndarray] = None) -> Dict:
    """Measured deltas of the distilled generation vs its parent on real
    rows: ``max_score_delta`` over raw scores (at most the declared
    bound) and, with labels, the AUC delta."""
    s_in = np.asarray(booster.predict(X, raw_score=True),
                      dtype=np.float64).reshape(len(X), -1)
    s_out = np.asarray(gen.predict(X, raw_score=True),
                       dtype=np.float64).reshape(len(X), -1)
    rep: Dict = {
        "rows": int(len(X)),
        "max_score_delta": float(np.max(np.abs(s_in - s_out)))
        if len(X) else 0.0,
        "mean_score_delta": float(np.mean(np.abs(s_in - s_out)))
        if len(X) else 0.0,
    }
    if y is not None and s_in.shape[1] == 1:
        auc_in = _auc(s_in[:, 0], y)
        auc_out = _auc(s_out[:, 0], y)
        rep["auc_in"] = auc_in
        rep["auc_out"] = auc_out
        rep["auc_delta"] = abs(auc_in - auc_out)
    return rep
