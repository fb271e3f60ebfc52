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
``Predict`` does.  The JAX module's in-process single-row predictor
(``compile_single_row``) serves the serving tier, which the port does not
have (ROADMAP queue 1 item 15): it is left out.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .core.predict import floor_thresholds_f32
from .core.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree


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
