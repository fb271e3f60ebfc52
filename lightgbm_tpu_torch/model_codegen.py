"""Model -> C++ source (``task=convert_model``).

The counterpart of ``lightgbm_tpu/model_codegen.py`` ``model_to_cpp`` for the
PyTorch port, and of the reference ``GBDT::SaveModelToIfElse`` /
``Tree::ToIfElse`` (src/boosting/gbdt_model_text.cpp:87, src/io/tree.cpp):
each tree becomes a nested if/else chain over the feature values, with the
missing-value and categorical-bitset routing of the port's ``decide``, so a
C++ compiler folds a trained model into a predictor with no dependencies.

The generated code computes what the port's ``predict`` computes from 512
rows on (``core/predict.py``'s f32 regime, the card's path): each row cast
to f32, numerical thresholds floored to f32 (``floor_thresholds_f32``, so
``v <= thr32`` equals ``v <= thr`` for every f32 ``v``), leaf values cast to
f32, and each class's score an f32 running sum in tree order, one add per
tree, widened to f64 at the end.  Every f32 constant is written as a
hexadecimal literal, so the compiled predictor equals ``predict`` to the
last bit of the sum.  ``Predict`` divides by the number of iterations for
``average_output`` (random forest) and applies the binary objective's
sigmoid; other objectives give the raw scores, as the JAX package's
``Predict`` does.

:func:`compile_single_row` (model_codegen.py:120-300 of the JAX package) is
the same if/else idea in-process: each tree becomes a generated Python
function, and one driver sums a class's trees in f32 in tree order, so a
row's raw scores are bit-equal to the f32 regime.  The serving tier takes
it for single-row requests with ``serve_single_row_fast=true``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .core.predict import floor_thresholds_f32
from .core.tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK,
                        K_ZERO_THRESHOLD, Tree)


def _f32(value: float) -> str:
    """An f32 value as an exact C++ float literal."""
    return float(np.float32(value)).hex() + "f"


def _tree_node_code(t: Tree, thr32: np.ndarray, index: int,
                    depth: int) -> str:
    pad = "  " * (depth + 1)
    if index < 0:
        return "%sreturn %s;\n" % (pad, _f32(t.leaf_value[~index]))
    dt = int(t.decision_type[index])
    fval = "arr[%d]" % int(t.split_feature[index])
    missing_type = (dt >> 2) & 3
    code = ""
    if dt & K_CATEGORICAL_MASK:
        ci = int(t.threshold[index])
        lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
        words = ", ".join("0x%08xU" % (int(t.cat_threshold[w]) & 0xFFFFFFFF)
                          for w in range(lo, hi))
        code += ("%sstatic const uint32_t cat_bits_%d[] = {%s};\n"
                 % (pad, index, words))
        cond = ("CategoricalDecision(%s, cat_bits_%d, %d, %d)"
                % (fval, index, hi - lo, missing_type))
    else:
        cond = ("NumericalDecision(%s, %s, %d, %s)"
                % (fval, _f32(thr32[index]), missing_type,
                   "true" if dt & K_DEFAULT_LEFT_MASK else "false"))
    code += "%sif (%s) {\n" % (pad, cond)
    code += _tree_node_code(t, thr32, int(t.left_child[index]), depth + 1)
    code += "%s} else {\n" % pad
    code += _tree_node_code(t, thr32, int(t.right_child[index]), depth + 1)
    code += "%s}\n" % pad
    return code


def _tree_code(t: Tree, i: int) -> str:
    if t.num_leaves <= 1:
        body = "  return %s;\n" % _f32(t.leaf_value[0])
    else:
        thr32 = floor_thresholds_f32(t.threshold[:t.num_leaves - 1])
        body = _tree_node_code(t, thr32, 0, 0)
    return "static float PredictTree%d(const float* arr) {\n%s}\n\n" % (i,
                                                                        body)


_PRELUDE = """\
#include <cmath>
#include <cstdint>

// decide_raw of the port's core/predict.py on f32 values: NaN is 0.0 unless
// the split's missing type is NaN (2); with missing type Zero (1) a value of
// magnitude <= 1e-35 goes to the default side
static inline bool NumericalDecision(float v, float thr, int missing_type,
                                     bool default_left) {
  const bool nan = std::isnan(v);
  if (nan && missing_type != 2) v = 0.0f;
  if ((missing_type == 1 && std::fabs(v) <= 1e-35f) ||
      (missing_type == 2 && nan))
    return default_left;
  return v <= thr;
}

// the category is the value's integer part; NaN goes right under missing
// type NaN and is category 0 otherwise; negative and unseen categories go
// right
static inline bool CategoricalDecision(float v, const uint32_t* bits, int n,
                                       int missing_type) {
  const bool nan = std::isnan(v);
  if (nan && missing_type == 2) return false;
  const long long iv = nan ? 0 : static_cast<long long>(v);
  if (iv < 0 || (iv >> 5) >= n) return false;
  return (bits[iv >> 5] >> (iv & 31)) & 1;
}

"""


def model_to_cpp(booster) -> str:
    """A standalone C++ translation unit for a trained booster:
    ``PredictRaw(const double* features, double* output)`` (K raw scores)
    and ``Predict`` (the converted outputs)."""
    trees: List[Tree] = booster.models
    K = max(int(booster.num_tree_per_iteration), 1)
    parts = ["// Generated by lightgbm_tpu_torch task=convert_model "
             "(reference: GBDT::SaveModelToIfElse)\n", _PRELUDE]
    for i, t in enumerate(trees):
        parts.append(_tree_code(t, i))
    ptrs = ", ".join("PredictTree%d" % i for i in range(len(trees)))
    parts.append("typedef float (*TreeFn)(const float*);\n")
    parts.append("static const TreeFn kTrees[] = {%s};\n" % (ptrs or "0"))
    parts.append("static const int kNumTrees = %d;\n" % len(trees))
    parts.append("static const int kNumClass = %d;\n" % K)
    parts.append("static const int kNumFeatures = %d;\n\n"
                 % (int(booster.max_feature_idx) + 1))
    parts.append(
        "extern \"C\" void PredictRaw(const double* features, "
        "double* output) {\n"
        "  float arr[kNumFeatures > 0 ? kNumFeatures : 1];\n"
        "  for (int j = 0; j < kNumFeatures; ++j)\n"
        "    arr[j] = static_cast<float>(features[j]);\n"
        "  float acc[kNumClass];\n"
        "  for (int k = 0; k < kNumClass; ++k) acc[k] = 0.0f;\n"
        "  for (int i = 0; i < kNumTrees; ++i)\n"
        "    acc[i % kNumClass] = acc[i % kNumClass] + kTrees[i](arr);\n"
        "  for (int k = 0; k < kNumClass; ++k)\n"
        "    output[k] = static_cast<double>(acc[k]);\n}\n")
    convert = ""
    if booster.average_output:
        convert += ("  for (int k = 0; k < kNumClass; ++k) output[k] /= "
                    "%d.0;\n" % max(len(trees) // K, 1))
    if booster.objective is not None and booster.objective.name == "binary":
        convert += ("  output[0] = 1.0 / (1.0 + std::exp(-%r * output[0]));\n"
                    % float(booster.objective.sigmoid))
    parts.append("\nextern \"C\" void Predict(const double* features, "
                 "double* output) {\n  PredictRaw(features, output);\n%s}\n"
                 % convert)
    return "".join(parts)


# ---- single-row serving fast path (Tree::ToIfElse, in-process) ----

# past this tree depth the generated if/else nesting would fight CPython's
# indentation limits; such trees fall back to an iterative traversal closure
# with the identical decide semantics (still bit-exact, just not unrolled)
_MAX_CODEGEN_DEPTH = 60

# the f32 constants the f32 regime's decide compares against (a python
# scalar compared with an f32 tensor is cast to f32)
_Z32 = float(np.float32(K_ZERO_THRESHOLD))


def _f32_thr_floor(thr: float) -> float:
    """The exact f32 threshold the f32 regime compares against (one shared
    rule: ``core.predict.floor_thresholds_f32``)."""
    return float(floor_thresholds_f32([thr])[0])


def _cat_decide(v: float, words, nan_right: bool) -> bool:
    """The categorical decide of ``core.predict.StackedTrees`` on one value:
    NaN routes right when the split saw NaNs (mt==2), else tests category
    0; out-of-range categories route right (pad words are zero)."""
    if v != v:
        if nan_right:
            return False
        iv = 0
    else:
        iv = int(v)
    if iv < 0:
        return False
    wi = iv >> 5
    if wi >= len(words):
        return False
    return bool((words[wi] >> (iv & 31)) & 1)


def _py_node(t: Tree, index: int, depth: int, ti: int, lines: List[str],
             ns: dict) -> None:
    pad = "    " * (depth + 1)
    if index < 0:
        leaf = ~index
        # the f32 leaf value the f32 regime's running sum adds
        lines.append("%sreturn %r" % (pad, float(np.float32(
            t.leaf_value[leaf]))))
        return
    dt = int(t.decision_type[index])
    feat = int(t.split_feature[index])
    lines.append("%sv = r[%d]" % (pad, feat))
    if dt & K_CATEGORICAL_MASK:
        ci = int(t.threshold[index])
        lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
        wname = "_cb_%d_%d" % (ti, index)
        ns[wname] = tuple(int(w) & 0xFFFFFFFF
                          for w in t.cat_threshold[lo:hi])
        mt = (dt >> 2) & 3
        cond = "_cat(v, %s, %r)" % (wname, mt == 2)
    else:
        mt = (dt >> 2) & 3
        dl = bool(dt & K_DEFAULT_LEFT_MASK)
        thr = repr(_f32_thr_floor(float(t.threshold[index])))
        # the f32 regime's decide exactly: NaN folds to 0.0 unless mt==NaN;
        # mt==Zero treats |val| <= kZeroThreshold as missing
        if mt == 0:
            cond = "(0.0 if v != v else v) <= %s" % thr
        elif mt == 1:
            cond = ("(%r if abs(0.0 if v != v else v) <= %r "
                    "else (0.0 if v != v else v) <= %s)" % (dl, _Z32, thr))
        else:
            cond = "(%r if v != v else v <= %s)" % (dl, thr)
    lines.append("%sif %s:" % (pad, cond))
    _py_node(t, int(t.left_child[index]), depth + 1, ti, lines, ns)
    lines.append("%selse:" % pad)
    _py_node(t, int(t.right_child[index]), depth + 1, ti, lines, ns)


def _tree_py_fn(t: Tree, ti: int, ns: dict) -> str:
    """Emit ``_t<ti>(r)`` into ``ns``; returns its name.  Deep trees get an
    iterative closure instead of generated nesting."""
    name = "_t%d" % ti
    if t.num_leaves <= 1:
        ns[name] = (lambda r, _lv=float(np.float32(t.leaf_value[0])): _lv)
        return name
    depth = int(t.leaf_depth[:t.num_leaves].max())
    if depth > _MAX_CODEGEN_DEPTH:
        ns[name] = _tree_iter_fn(t, ti, ns)
        return name
    lines = ["def %s(r):" % name]
    _py_node(t, 0, 0, ti, lines, ns)
    exec(compile("\n".join(lines) + "\n", "<single_row_tree_%d>" % ti,
                 "exec"), ns)
    return name


def _tree_iter_fn(t: Tree, ti: int, ns: dict):
    """Iterative traversal for trees too deep to unroll — the same decide
    per node as the generated code (f32-floored thresholds, the f32
    regime's missing/categorical routing)."""
    ni = max(t.num_leaves - 1, 0)
    sf = t.split_feature[:ni].astype(int)
    dt = t.decision_type[:ni].astype(int)
    mt = (dt >> 2) & 3
    dl = (dt & K_DEFAULT_LEFT_MASK) != 0
    cat = (dt & K_CATEGORICAL_MASK) != 0
    thr = [_f32_thr_floor(float(x)) for x in t.threshold[:ni]]
    words = []
    for node in range(ni):
        if cat[node]:
            ci = int(t.threshold[node])
            lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
            words.append(tuple(int(w) & 0xFFFFFFFF
                               for w in t.cat_threshold[lo:hi]))
        else:
            words.append(())
    lc, rc = t.left_child[:ni].astype(int), t.right_child[:ni].astype(int)
    lv = [float(np.float32(x)) for x in t.leaf_value[:t.num_leaves]]

    def fn(r):
        node = 0
        while node >= 0:
            v = r[sf[node]]
            if cat[node]:
                left = _cat_decide(v, words[node], mt[node] == 2)
            elif mt[node] == 0:
                left = (0.0 if v != v else v) <= thr[node]
            elif mt[node] == 1:
                val = 0.0 if v != v else v
                left = dl[node] if abs(val) <= _Z32 else val <= thr[node]
            else:
                left = dl[node] if v != v else v <= thr[node]
            node = lc[node] if left else rc[node]
        return lv[~node]

    return fn


def compile_single_row(booster, start_iteration: int = 0,
                       num_iteration: int = -1):
    """Compile ``booster``'s trees into one in-process single-row predictor:
    ``fn(row) -> [K] float64 raw scores``, bit-equal to the port's f32
    regime (``core.predict_fused.FusedPredictor``) on the same f32 row:
    the same floored-f32 thresholds, missing and categorical routing, and
    per-tree f32 accumulation order per class (pinned by
    ``tests/test_torch_serving.py``).

    The serving scheduler uses this to bypass batching for batch-size-1
    traffic when ``serve_single_row_fast=true``; categorical values are
    assumed within int32 range (the device decide's own domain)."""
    K = max(int(booster.num_tree_per_iteration), 1)
    total = len(booster.models) // K
    end = (total if num_iteration <= 0
           else min(total, start_iteration + num_iteration))
    sel = booster.models[start_iteration * K:end * K]
    ns: dict = {"_cat": _cat_decide,
                "_r32": lambda x: float(np.float32(x))}
    names = [_tree_py_fn(t, i, ns) for i, t in enumerate(sel)]
    lines = ["def _predict(r):"]
    for k in range(K):
        acc = "s%d" % k
        lines.append("    %s = 0.0" % acc)
        # class k's trees in sel[k::K] order: the f32 regime's per-tree
        # add order, replayed as exact double-rounding-safe f32 adds
        for j in range(k, len(sel), K):
            lines.append("    %s = _r32(%s + %s(r))" % (acc, acc, names[j]))
    lines.append("    return (%s)" % ", ".join(
        "s%d" % k for k in range(K)) if K > 1
        else "    return (s0,)")
    exec(compile("\n".join(lines) + "\n", "<single_row_driver>", "exec"), ns)
    raw_fn = ns["_predict"]

    def predict_one(row) -> np.ndarray:
        r = np.ascontiguousarray(np.asarray(row, dtype=np.float32)).tolist()
        return np.asarray(raw_fn(r), dtype=np.float64)

    predict_one.n_trees = len(sel)
    predict_one.num_class = K
    return predict_one
