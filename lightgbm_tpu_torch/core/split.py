"""Vectorized best-split search over feature histograms (numerical subset).

Counterpart of ``lightgbm_tpu/core/split.py`` (the reference
``FeatureHistogram::FindBestThreshold``, feature_histogram.hpp:84-304,440-680):
every (feature, threshold, direction) candidate of a leaf is evaluated at once
with prefix sums over the bin axis.  Ported: ``SplitParams``, ``FeatureInfo``,
``BestSplit``, ``FeatureBest``, ``calculate_leaf_output``, ``leaf_split_gain*``,
``per_feature_best``, ``reduce_feature_best`` and ``best_split_numerical``.
Categorical scans, monotone constraints and extra-trees are not ported yet.

Semantics kept from the reference (see its module docstring): two directions
only with a missing bin and > 2 bins; MissingType.ZERO excludes the default
bin from both accumulations; MissingType.NAN keeps the last bin out of the
accumulated side; counts estimated from hessians; L1/L2/max_delta_step gain
math; validity by min_data_in_leaf / min_sum_hessian_in_leaf and gain above
the parent's.  Tie-breaking (split.py:24-26): the missing-left scan wins ties,
larger thresholds win ties in the missing-left scan, smaller in the other,
and the smaller feature index wins across features.  Tree equality with the
reference depends on it.

Every function takes an optional leading batch axis on the histogram
(``[..., F, 2, B]``) with leaf totals shaped ``[...]``, so both children of a
split are scanned in one pass.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..io.binning import MissingType

K_EPSILON = 1e-15  # meta.h:51
K_MIN_SCORE = -math.inf


class SplitParams(NamedTuple):
    """Learner hyperparameters of the split scan."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0


class FeatureInfo(NamedTuple):
    """Per-used-feature metadata (tensors [F])."""
    num_bin: torch.Tensor        # i64
    missing_type: torch.Tensor   # i64 (MissingType)
    default_bin: torch.Tensor    # i64
    is_categorical: torch.Tensor  # bool


class BestSplit(NamedTuple):
    """Best split of a leaf (or of each leaf of a batch)."""
    gain: torch.Tensor          # improvement over parent (-inf if none)
    feature: torch.Tensor       # inner feature index
    threshold: torch.Tensor     # bin threshold (left: bin <= threshold)
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor    # f32 (estimated like the reference)
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


class FeatureBest(NamedTuple):
    """Best split of every feature (arrays [..., F])."""
    gain: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1: float):
    if l1 == 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, l1: float, l2: float,
                          max_delta_step: float):
    ret = -threshold_l1(sum_grad, l1) / (sum_hess + l2)
    if max_delta_step > 0.0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def leaf_split_gain_given_output(sum_grad, sum_hess, l1: float, l2: float,
                                 output):
    sg_l1 = threshold_l1(sum_grad, l1)
    return -(2.0 * sg_l1 * output + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1: float, l2: float,
                    max_delta_step: float):
    out = calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return leaf_split_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def _split_gains(gl, hl, gr, hr, p: SplitParams):
    lo = calculate_leaf_output(gl, hl, p.lambda_l1, p.lambda_l2,
                               p.max_delta_step)
    ro = calculate_leaf_output(gr, hr, p.lambda_l1, p.lambda_l2,
                               p.max_delta_step)
    gain = (leaf_split_gain_given_output(gl, hl, p.lambda_l1, p.lambda_l2, lo)
            + leaf_split_gain_given_output(gr, hr, p.lambda_l1, p.lambda_l2,
                                           ro))
    return gain, lo, ro


def per_feature_best(hist: torch.Tensor, feat: FeatureInfo,
                     feature_mask: torch.Tensor, sum_grad, sum_hess,
                     num_data, params: SplitParams) -> FeatureBest:
    """Best numerical split of EACH feature of a leaf.

    hist: [..., F, 2, B] f32; sum_grad/sum_hess/num_data: leaf totals [...]
    (f32 tensors); feature_mask: [F] bool.  Outputs are [..., F]."""
    F, B = hist.shape[-3], hist.shape[-1]
    dev = hist.device
    f32 = torch.float32
    sum_grad = torch.as_tensor(sum_grad, dtype=f32, device=dev)[..., None, None]
    sum_hess = torch.as_tensor(sum_hess, dtype=f32, device=dev)[..., None, None]
    num_data_f = torch.as_tensor(num_data, dtype=f32, device=dev)[..., None, None]
    g = hist[..., 0, :]
    h = hist[..., 1, :]
    total_h = sum_hess + 2 * K_EPSILON        # feature_histogram.hpp:88
    total_g = sum_grad
    cnt_factor = num_data_f / total_h
    c = torch.round(h * cnt_factor)

    nb = feat.num_bin[:, None]                          # [F, 1]
    t = torch.arange(B, device=dev)[None, :]            # [1, B]
    mt = feat.missing_type[:, None]
    is_def = t == feat.default_bin[:, None]

    pre_g = torch.cumsum(g, -1)
    pre_h = torch.cumsum(h, -1)
    pre_c = torch.cumsum(c, -1)
    zero = torch.zeros((), dtype=f32, device=dev)
    pre_g_nz = torch.cumsum(torch.where(is_def, zero, g), -1)
    pre_h_nz = torch.cumsum(torch.where(is_def, zero, h), -1)
    pre_c_nz = torch.cumsum(torch.where(is_def, zero, c), -1)
    last_data = torch.clamp(nb - 2, 0, B - 1).expand(F, 1)

    def tot(a):
        return a[..., -1:]

    def tot_nonan(a):
        return torch.gather(a, -1, last_data.expand(a.shape[:-1] + (1,)))

    has_missing = (mt != int(MissingType.NONE)) & (nb > 2)
    nan_two = has_missing & (mt == int(MissingType.NAN))
    zero_two = has_missing & (mt == int(MissingType.ZERO))
    is_zero_mode = mt == int(MissingType.ZERO)

    # direction 0: missing/default LEFT (reference dir=-1 scan)
    def right0(pre, pre_nz):
        return torch.where(nan_two, tot_nonan(pre) - pre,
                           torch.where(zero_two, tot(pre_nz) - pre_nz,
                                       tot(pre) - pre))
    right_g0 = right0(pre_g, pre_g_nz)
    right_h0 = right0(pre_h, pre_h_nz) + K_EPSILON
    right_c0 = right0(pre_c, pre_c_nz)
    left_g0 = total_g - right_g0
    left_h0 = total_h - right_h0
    left_c0 = num_data_f - right_c0
    valid0 = t <= nb - 2
    valid0 = valid0 & torch.where(nan_two, t <= nb - 3, True)
    valid0 = valid0 & torch.where(zero_two, t != feat.default_bin[:, None] - 1,
                                  True)

    # direction 1: missing/default RIGHT (reference dir=+1 scan)
    left_g1 = torch.where(is_zero_mode, pre_g_nz, pre_g)
    left_h1 = torch.where(is_zero_mode, pre_h_nz, pre_h) + K_EPSILON
    left_c1 = torch.where(is_zero_mode, pre_c_nz, pre_c)
    right_g1 = total_g - left_g1
    right_h1 = total_h - left_h1
    right_c1 = num_data_f - left_c1
    valid1 = has_missing & (t <= nb - 2)
    valid1 = valid1 & torch.where(is_zero_mode, ~is_def, True)

    gain_shift = leaf_split_gain(total_g, total_h, params.lambda_l1,
                                 params.lambda_l2, params.max_delta_step)
    min_gain_shift = gain_shift + params.min_gain_to_split

    fm = (feature_mask & ~feat.is_categorical)[:, None]

    def evaluate(gl, hl, cl, gr, hr, cr, valid):
        ok = (valid & fm
              & (cl >= params.min_data_in_leaf)
              & (cr >= params.min_data_in_leaf)
              & (hl >= params.min_sum_hessian_in_leaf)
              & (hr >= params.min_sum_hessian_in_leaf))
        gain, lo, ro = _split_gains(gl, hl, gr, hr, params)
        ok = ok & (gain > min_gain_shift)
        return torch.where(ok, gain, torch.full_like(gain, K_MIN_SCORE)), lo, ro

    gain0, lo0, ro0 = evaluate(left_g0, left_h0, left_c0,
                               right_g0, right_h0, right_c0, valid0)
    gain1, lo1, ro1 = evaluate(left_g1, left_h1, left_c1,
                               right_g1, right_h1, right_c1, valid1)

    # per-feature argmax with reference tie-breaking (argmax returns the
    # FIRST maximum: flip for "largest t wins" in direction 0)
    idx0 = (B - 1) - torch.argmax(torch.flip(gain0, [-1]), -1, keepdim=True)
    best0 = torch.gather(gain0, -1, idx0)
    idx1 = torch.argmax(gain1, -1, keepdim=True)
    best1 = torch.gather(gain1, -1, idx1)
    use1 = best1 > best0                                   # dir0 wins ties
    feat_gain = torch.where(use1, best1, best0)[..., 0]
    thr = torch.where(use1, idx1, idx0)

    # <= 2 bins with NaN missing: the single scan says default_left = false
    two_bin_nan = (feat.missing_type == int(MissingType.NAN)) & (feat.num_bin <= 2)
    default_left = ~use1[..., 0] & ~two_bin_nan

    def pick(a0, a1):
        a0 = a0.expand(thr.shape[:-1] + (B,))
        a1 = a1.expand(thr.shape[:-1] + (B,))
        return torch.where(use1, torch.gather(a1, -1, thr),
                           torch.gather(a0, -1, thr))[..., 0]

    found = feat_gain > K_MIN_SCORE
    return FeatureBest(
        gain=torch.where(found, feat_gain - min_gain_shift[..., 0],
                         torch.full_like(feat_gain, K_MIN_SCORE)),
        threshold=thr[..., 0],
        default_left=default_left,
        left_sum_grad=pick(left_g0, left_g1),
        left_sum_hess=pick(left_h0, left_h1) - K_EPSILON,
        left_count=pick(left_c0, left_c1),
        right_sum_grad=pick(right_g0, right_g1),
        right_sum_hess=pick(right_h0, right_h1) - K_EPSILON,
        right_count=pick(right_c0, right_c1),
        left_output=pick(lo0, lo1),
        right_output=pick(ro0, ro1),
    )


def reduce_feature_best(fb: FeatureBest) -> BestSplit:
    """Argmax-by-gain across features (last axis); ties go to the smaller
    feature id (split_info.hpp:185 comparators)."""
    best_f = torch.argmax(fb.gain, -1, keepdim=True)   # first max
    fields = {name: torch.gather(getattr(fb, name), -1, best_f)[..., 0]
              for name in FeatureBest._fields}
    return BestSplit(feature=best_f[..., 0], **fields)


def best_split_numerical(hist: torch.Tensor, feat: FeatureInfo,
                         feature_mask: torch.Tensor, sum_grad, sum_hess,
                         num_data, params: SplitParams) -> BestSplit:
    """Best numerical split over all features of one leaf (or a batch)."""
    fb = per_feature_best(hist, feat, feature_mask, sum_grad, sum_hess,
                          num_data, params)
    return reduce_feature_best(fb)
