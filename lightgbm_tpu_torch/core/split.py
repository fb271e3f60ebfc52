"""Vectorized best-split search over feature histograms.

Counterpart of ``lightgbm_tpu/core/split.py`` (the reference
``FeatureHistogram::FindBestThreshold`` family, feature_histogram.hpp:84-304,
440-680): every (feature, threshold, direction) candidate of a leaf is
evaluated at once with prefix sums over the bin axis.  Ported:
``SplitParams``, ``FeatureInfo``, ``BestSplit``, ``FeatureBest``,
``calculate_leaf_output``, ``leaf_split_gain*``, ``per_feature_best`` (with
the monotone ``cmin``/``cmax`` clamp, the ``extra_trees`` threshold draw,
``_extra_trees_mask``, and the one-threshold ``threshold_mask`` of a forced
split), ``per_feature_best_categorical`` (one-hot and the
sorted many-vs-many scan), ``per_feature_best_combined``, ``_split_gains_clamped``,
``reduce_feature_best`` (with the scan's global feature ids), ``sync_best``
(over a process group), ``best_split_numerical`` and ``dequantize_hist``;
``contri_scale``/``apply_feature_contri`` are the JAX learner's ``_apply_contri``
(tree_learner.py:569-580) and :func:`best_split` the learner's ``best_of``
for one serial leaf (or a batch).  All plain torch: the JAX counterparts are
XLA, not Pallas.

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
(``[..., F, 2, B]``) with leaf totals (and monotone bounds) shaped ``[...]``,
so both children of a split are scanned in one pass.  Bitsets are int64
tensors holding 32-bit words (torch has little ``uint32`` support).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..io.binning import MissingType
from .quant import _M32, _mul32

K_EPSILON = 1e-15  # meta.h:51
K_MIN_SCORE = -math.inf


def dequantize_hist(hist: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """Integer-valued quantized histogram ``[..., 2, B]`` -> real sums: the
    grad channel times ``qscale[0]``, the hess channel times ``qscale[1]``
    (split.py:42-53)."""
    return hist * qscale.reshape((1,) * (hist.ndim - 2) + (2, 1))


class SplitParams(NamedTuple):
    """Learner hyperparameters of the split scan."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    # categorical (config.h:600-640)
    max_cat_to_onehot: int = 4
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    min_data_per_group: int = 100
    # one random threshold per (feature, leaf) on numerical features
    extra_trees: bool = False
    extra_seed: int = 6
    # per-feature gain scale in inner-feature order; () is off
    feature_contri: tuple = ()


class FeatureInfo(NamedTuple):
    """Per-used-feature metadata (tensors [F])."""
    num_bin: torch.Tensor        # i64
    missing_type: torch.Tensor   # i64 (MissingType)
    default_bin: torch.Tensor    # i64
    is_categorical: torch.Tensor  # bool
    monotone: Optional[torch.Tensor] = None  # i64 in {-1, 0, 1}
    # EFB bundling: each feature's group column and first group code
    group: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None


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
    cat_bitset: torch.Tensor    # [..., B // 32] bins going left (categorical)


class FeatureBest(NamedTuple):
    """Best split of every feature (arrays [..., F]; the bitset
    [..., F, B // 32])."""
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
    cat_bitset: torch.Tensor


def threshold_l1(s, l1: float):
    if l1 == 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, l1: float, l2,
                          max_delta_step: float):
    """The leaf output; ``l2`` may be a tensor (categorical many-vs-many
    splits add ``cat_l2``, split.py:542)."""
    ret = -threshold_l1(sum_grad, l1) / (sum_hess + l2)
    if max_delta_step > 0.0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def leaf_split_gain_given_output(sum_grad, sum_hess, l1: float, l2, output):
    sg_l1 = threshold_l1(sum_grad, l1)
    return -(2.0 * sg_l1 * output + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1: float, l2: float,
                    max_delta_step: float):
    out = calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return leaf_split_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def _clamp(x, cmin, cmax):
    """``jnp.clip(x, cmin, cmax)`` with bounds shaped like x's leading
    axes."""
    return torch.minimum(torch.maximum(x, cmin), cmax)


def _split_gains_clamped(gl, hl, gr, hr, p: SplitParams, l2, cmin=None,
                         cmax=None):
    """Gain of a candidate and its two outputs, the outputs clamped into the
    leaf's monotone bounds BEFORE the gain (split.py:527-539,
    feature_histogram.hpp:468-527).  Without bounds this is the plain
    L1/L2/max_delta_step gain."""
    lo = calculate_leaf_output(gl, hl, p.lambda_l1, l2, p.max_delta_step)
    ro = calculate_leaf_output(gr, hr, p.lambda_l1, l2, p.max_delta_step)
    if cmin is not None:
        lo = _clamp(lo, cmin, cmax)
        ro = _clamp(ro, cmin, cmax)
    gain = (leaf_split_gain_given_output(gl, hl, p.lambda_l1, l2, lo)
            + leaf_split_gain_given_output(gr, hr, p.lambda_l1, l2, ro))
    return gain, lo, ro


def _avalanche_u32(x: torch.Tensor) -> torch.Tensor:
    """The xxhash-style mixer of split.py:131-138 on int64 holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    return x ^ (x >> 16)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of f32 ``x`` as int64 in [0, 2**32)."""
    return (x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
            & _M32)


def _extra_trees_mask(feat: FeatureInfo, sum_grad, sum_hess, t,
                      params: SplitParams) -> torch.Tensor:
    """One random candidate threshold per (feature, leaf) under
    ``extra_trees`` (split.py:141-165): a stateless hash of (extra_seed,
    feature index, the leaf totals' f32 bits), in int64 masked to 32 bits.
    ``sum_grad``/``sum_hess`` [...] -> mask [..., F, B]."""
    salt = _f32_bits(sum_grad) ^ ((_f32_bits(sum_hess) << 1) & _M32)
    F = feat.num_bin.shape[0]
    fid = torch.arange(F, dtype=torch.int64, device=t.device)
    x = _mul32(fid, 2654435761)
    seed = _mul32(torch.tensor(params.extra_seed & _M32, dtype=torch.int64),
                  0x9E3779B9)
    x = x ^ ((salt[..., None] + seed.to(t.device)) & _M32)
    x = _avalanche_u32(x)
    ncand = torch.clamp(feat.num_bin - 1, min=1).to(torch.int64)
    rbin = torch.remainder(x, ncand)
    return t == rbin[..., None]


def _leaf_totals(hist, sum_grad, sum_hess, num_data):
    f32 = torch.float32
    dev = hist.device
    return (torch.as_tensor(sum_grad, dtype=f32, device=dev),
            torch.as_tensor(sum_hess, dtype=f32, device=dev),
            torch.as_tensor(num_data, dtype=f32, device=dev))


def per_feature_best(hist: torch.Tensor, feat: FeatureInfo,
                     feature_mask: torch.Tensor, sum_grad, sum_hess,
                     num_data, params: SplitParams, cmin=None,
                     cmax=None, threshold_mask=None) -> FeatureBest:
    """Best numerical split of EACH feature of a leaf.

    hist: [..., F, 2, B] f32; sum_grad/sum_hess/num_data: leaf totals [...]
    (f32 tensors); feature_mask: [F] bool; cmin/cmax: the leaf's monotone
    bounds [...] or None.  ``threshold_mask`` [B] bool restricts the
    candidates to the thresholds it holds: the stats of one forced threshold
    (split.py:200-209, feature_histogram.hpp:306 GatherInfoForThreshold),
    which take no ``extra_trees`` draw.  Outputs are [..., F]."""
    F, B = hist.shape[-3], hist.shape[-1]
    dev = hist.device
    f32 = torch.float32
    sg0, sh0, nd0 = _leaf_totals(hist, sum_grad, sum_hess, num_data)
    sum_grad, sum_hess = sg0[..., None, None], sh0[..., None, None]
    num_data_f = nd0[..., None, None]
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

    if threshold_mask is not None:
        valid0 = valid0 & threshold_mask
        valid1 = valid1 & threshold_mask
    elif params.extra_trees:
        et = _extra_trees_mask(feat, sg0, sh0, t, params)
        valid0 = valid0 & et
        valid1 = valid1 & et

    gain_shift = leaf_split_gain(total_g, total_h, params.lambda_l1,
                                 params.lambda_l2, params.max_delta_step)
    min_gain_shift = gain_shift + params.min_gain_to_split

    fm = (feature_mask & ~feat.is_categorical)[:, None]
    bounds = (None, None) if cmin is None else (
        torch.as_tensor(cmin, dtype=f32, device=dev)[..., None, None],
        torch.as_tensor(cmax, dtype=f32, device=dev)[..., None, None])
    mono = (feat.monotone[:, None]
            if cmin is not None and feat.monotone is not None else None)

    def evaluate(gl, hl, cl, gr, hr, cr, valid):
        ok = (valid & fm
              & (cl >= params.min_data_in_leaf)
              & (cr >= params.min_data_in_leaf)
              & (hl >= params.min_sum_hessian_in_leaf)
              & (hr >= params.min_sum_hessian_in_leaf))
        gain, lo, ro = _split_gains_clamped(gl, hl, gr, hr, params,
                                            params.lambda_l2, *bounds)
        if mono is not None:
            ok = ok & ~(((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro)))
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
        cat_bitset=torch.zeros(feat_gain.shape + (B // 32,),
                               dtype=torch.int64, device=dev),
    )


def _bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., B] bool -> [..., B // 32] int64 holding 32-bit words
    (split.py:348)."""
    B = bits.shape[-1]
    w = bits.reshape(bits.shape[:-1] + (B // 32, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (w << shifts).sum(-1)


def per_feature_best_categorical(hist: torch.Tensor, feat: FeatureInfo,
                                 feature_mask: torch.Tensor, sum_grad,
                                 sum_hess, num_data, params: SplitParams,
                                 cmin=None, cmax=None) -> FeatureBest:
    """Best categorical split of each feature (split.py:356-518,
    feature_histogram.hpp:136-304 FindBestThresholdCategorical).

    One-hot mode for features with <= ``max_cat_to_onehot`` bins (one
    category against the rest, the first best one); otherwise the sorted
    many-vs-many scan: bins with count >= ``cat_smooth`` stably sorted by
    grad / (hess + cat_smooth), prefixes scanned from both ends up to
    ``max_cat_threshold`` bins with the ``min_data_per_group`` batching.  The
    scan is a short host loop over positions, each step vectorized over the
    batch, the features and both directions; its sums are the JAX scan's
    sequential f32 sums.  The left bins come back as a bitset."""
    F, B = hist.shape[-3], hist.shape[-1]
    p = params
    dev = hist.device
    f32 = torch.float32
    sg0, sh0, nd0 = _leaf_totals(hist, sum_grad, sum_hess, num_data)
    total_g = sg0[..., None]                               # [..., 1]
    total_h = sh0[..., None] + 2 * K_EPSILON
    num_data_f = nd0[..., None]
    g = hist[..., 0, :]
    h = hist[..., 1, :]
    cnt = torch.round(h * (num_data_f / total_h)[..., None])

    is_full = feat.missing_type == int(MissingType.NONE)
    used_bin = feat.num_bin - 1 + is_full.to(torch.int64)           # [F]
    t = torch.arange(B, device=dev)
    in_range = t < used_bin[:, None]                                 # [F, B]

    gain_shift = leaf_split_gain(total_g, total_h, p.lambda_l1, p.lambda_l2,
                                 p.max_delta_step)
    min_gain_shift = gain_shift + p.min_gain_to_split               # [..., 1]
    use_onehot = feat.num_bin <= p.max_cat_to_onehot                # [F]
    bounds = (None, None) if cmin is None else (
        torch.as_tensor(cmin, dtype=f32, device=dev)[..., None],
        torch.as_tensor(cmax, dtype=f32, device=dev)[..., None])
    bounds_b = (None, None) if cmin is None else (bounds[0][..., None],
                                                  bounds[1][..., None])

    # ---- one-hot: category t vs the rest (:157-189) ----
    te = total_g[..., None]
    he = total_h[..., None]
    other_g = te - g
    other_h = he - h - K_EPSILON
    other_cnt = num_data_f[..., None] - cnt
    ok1 = (in_range & (cnt >= p.min_data_in_leaf)
           & (h >= p.min_sum_hessian_in_leaf)
           & (other_cnt >= p.min_data_in_leaf)
           & (other_h >= p.min_sum_hessian_in_leaf))
    oh_gain, _, _ = _split_gains_clamped(g, h + K_EPSILON, other_g, other_h,
                                         p, p.lambda_l2, *bounds_b)
    oh_gain = torch.where(ok1 & (oh_gain > min_gain_shift[..., None]),
                          oh_gain, torch.full_like(oh_gain, K_MIN_SCORE))
    oh_t = torch.argmax(oh_gain, -1, keepdim=True)                  # first max
    oh_best = torch.gather(oh_gain, -1, oh_t)[..., 0]

    # ---- sorted many-vs-many (:191-268) ----
    l2c = p.lambda_l2 + p.cat_l2
    valid_sort = in_range & (cnt >= p.cat_smooth)
    ctr = g / (h + p.cat_smooth)
    sort_key = torch.where(valid_sort, ctr, torch.full_like(ctr, math.inf))
    order = torch.sort(sort_key, dim=-1, stable=True).indices
    used = valid_sort.sum(-1)                                       # [..., F]
    max_num_cat = torch.clamp((used + 1) // 2, max=p.max_cat_threshold)
    gs = torch.gather(g, -1, order)
    hs = torch.gather(h, -1, order)
    cs = torch.gather(cnt, -1, order)

    # both directions at once: position i reads sorted bin i (forward) or
    # bin max(used - 1 - i, 0) (backward); no step past max_cat_threshold
    # is active.  A direction's active steps are a prefix (i < used, i <
    # max_num_cat, and up to its first break), so its left sums are the
    # running sums of its sequence up to there: summed one step at a time
    # in f32, as the JAX scan adds them, and every other quantity of a step
    # follows from them at once.  Only the min_data_per_group batching
    # (cnt_grp, reset where a group is reached) stays a loop.
    S = min(B, p.max_cat_threshold)
    back = torch.clamp(used[..., None] - 1 - t[:S], min=0)
    seq = [torch.stack([a[..., :S], torch.gather(a, -1, back)])
           for a in (gs, hs, cs)]
    gsd, hsd, csd = seq                                  # [2, ..., F, S]
    lead = gsd.shape[:-1]
    run = [torch.zeros(lead, dtype=f32, device=dev),
           torch.full(lead, K_EPSILON, dtype=f32, device=dev),
           torch.zeros(lead, dtype=f32, device=dev)]
    sums = ([], [], [])
    for i in range(S):
        for k, a in enumerate(seq):
            run[k] = run[k] + a[..., i]
            sums[k].append(run[k])
    sum_lg, sum_lh, left_c = (torch.stack(x, -1) for x in sums)
    tail = (..., None)          # leaf quantities [..., 1] -> [..., 1, 1]
    right_c = num_data_f[tail] - left_c
    sum_rh = total_h[tail] - sum_lh
    cont1 = ((left_c < p.min_data_in_leaf)
             | (sum_lh < p.min_sum_hessian_in_leaf))
    brk = ((right_c < p.min_data_in_leaf)
           | (right_c < p.min_data_per_group)
           | (sum_rh < p.min_sum_hessian_in_leaf))
    in_limit = t[:S] < torch.minimum(used, max_num_cat)[..., None]
    stops = (brk & in_limit).to(torch.int32)
    active = in_limit & ((torch.cumsum(stops, -1) - stops) == 0)
    ok = active & ~cont1 & ~brk
    cnt_grp = torch.zeros(lead, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    reached = []
    for i in range(S):
        cnt_grp = cnt_grp + csd[..., i]
        r = ok[..., i] & (cnt_grp >= p.min_data_per_group)
        reached.append(r)
        cnt_grp = torch.where(r, zero, cnt_grp)
    reached = torch.stack(reached, -1)
    bounds_s = (None, None) if cmin is None else (bounds[0][tail],
                                                  bounds[1][tail])
    gain, _, _ = _split_gains_clamped(sum_lg, sum_lh,
                                      total_g[tail] - sum_lg, sum_rh, p, l2c,
                                      *bounds_s)
    # the JAX scan keeps the first step of the largest gain (strict >)
    gain = torch.where(reached & (gain > min_gain_shift[tail]), gain,
                       torch.full_like(gain, K_MIN_SCORE))
    bgain, bi = gain.max(-1)
    bi = torch.where(bgain > K_MIN_SCORE, bi, torch.full_like(bi, -1))
    use_bwd = bgain[1] > bgain[0]                                   # fwd ties
    so_gain = torch.where(use_bwd, bgain[1], bgain[0])
    so_i = torch.where(use_bwd, bi[1], bi[0])

    # the left sums at the winning prefix (position so_i included)
    pos = t
    in_prefix = torch.where(
        use_bwd[..., None],
        (pos >= torch.clamp(used - 1 - so_i, min=0)[..., None])
        & (pos < used[..., None]),
        pos <= so_i[..., None])
    in_prefix = in_prefix & (so_i[..., None] >= 0)
    so_lg = torch.where(in_prefix, gs, zero).sum(-1)
    so_lh = torch.where(in_prefix, hs, zero).sum(-1) + K_EPSILON
    so_lc = torch.where(in_prefix, cs, zero).sum(-1)

    # ---- one-hot or sorted, per feature ----
    oh = use_onehot
    cat_gain = torch.where(oh, oh_best, so_gain)
    l_g = torch.where(oh, torch.gather(g, -1, oh_t)[..., 0], so_lg)
    l_h = torch.where(oh, torch.gather(h, -1, oh_t)[..., 0] + K_EPSILON, so_lh)
    l_c = torch.where(oh, torch.gather(cnt, -1, oh_t)[..., 0], so_lc)
    eff_l2 = torch.where(oh, torch.tensor(p.lambda_l2, dtype=f32, device=dev),
                         torch.tensor(l2c, dtype=f32, device=dev))
    r_g = total_g - l_g
    r_h = total_h - l_h
    r_c = num_data_f - l_c
    l_out = calculate_leaf_output(l_g, l_h, p.lambda_l1, eff_l2,
                                  p.max_delta_step)
    r_out = calculate_leaf_output(r_g, r_h, p.lambda_l1, eff_l2,
                                  p.max_delta_step)
    if cmin is not None:
        l_out = _clamp(l_out, *bounds)
        r_out = _clamp(r_out, *bounds)

    # left-bin bitsets: one-hot {oh_t}; sorted: the prefix through ``order``
    bits_oh = t == oh_t
    bits_sorted = torch.zeros(in_prefix.shape, dtype=torch.bool, device=dev
                              ).scatter(-1, order, in_prefix)
    bits = torch.where(oh[:, None], bits_oh, bits_sorted)

    found = (cat_gain > K_MIN_SCORE) & feature_mask & feat.is_categorical
    zf = torch.zeros((), dtype=f32, device=dev)
    words = _bits_to_words(bits)
    return FeatureBest(
        gain=torch.where(found, cat_gain - min_gain_shift,
                         torch.full_like(cat_gain, K_MIN_SCORE)),
        threshold=torch.where(oh, oh_t[..., 0], so_i + 1),
        default_left=torch.zeros_like(found),
        left_sum_grad=torch.where(found, l_g, zf),
        left_sum_hess=torch.where(found, l_h - K_EPSILON, zf),
        left_count=torch.where(found, l_c, zf),
        right_sum_grad=torch.where(found, r_g, zf),
        right_sum_hess=torch.where(found, r_h - K_EPSILON, zf),
        right_count=torch.where(found, r_c, zf),
        left_output=l_out,
        right_output=r_out,
        cat_bitset=torch.where(found[..., None], words,
                               torch.zeros_like(words)),
    )


def per_feature_best_combined(hist: torch.Tensor, feat: FeatureInfo,
                              feature_mask: torch.Tensor, sum_grad, sum_hess,
                              num_data, params: SplitParams,
                              any_categorical: bool = True, cmin=None,
                              cmax=None) -> FeatureBest:
    """Numerical and categorical per-feature bests merged by feature type
    (split.py:549-567)."""
    fb_num = per_feature_best(hist, feat, feature_mask, sum_grad, sum_hess,
                              num_data, params, cmin, cmax)
    if not any_categorical:
        return fb_num
    fb_cat = per_feature_best_categorical(hist, feat, feature_mask, sum_grad,
                                          sum_hess, num_data, params, cmin,
                                          cmax)
    is_cat = feat.is_categorical
    return FeatureBest(*[
        torch.where(is_cat[:, None] if name == "cat_bitset" else is_cat,
                    getattr(fb_cat, name), getattr(fb_num, name))
        for name in FeatureBest._fields])


def contri_scale(params: SplitParams, device) -> Optional[torch.Tensor]:
    """``params.feature_contri`` as the [F] f32 scale max(0, c) that
    :func:`apply_feature_contri` takes, or None when it is unset (the JAX
    learner's ``contri``, tree_learner.py:569-570)."""
    if not params.feature_contri:
        return None
    return torch.clamp(torch.tensor(params.feature_contri,
                                    dtype=torch.float32, device=device),
                       min=0.0)


def apply_feature_contri(fb: FeatureBest, contri: Optional[torch.Tensor]
                         ) -> FeatureBest:
    """gain[i] = max(0, feature_contri[i]) * gain[i] before the
    cross-feature argmax (config.h:432-436; the JAX learner's
    ``_apply_contri``, tree_learner.py:569-580).  ``contri`` is
    :func:`contri_scale`'s [F] tensor, or None."""
    if contri is None:
        return fb
    return fb._replace(gain=torch.where(fb.gain > K_MIN_SCORE,
                                        fb.gain * contri, fb.gain))


def reduce_feature_best(fb: FeatureBest,
                        feature_ids: Optional[torch.Tensor] = None
                        ) -> BestSplit:
    """Argmax-by-gain across features (last axis); ties go to the smaller
    feature id (split_info.hpp:185 comparators).  ``feature_ids`` [F] maps
    the scan's positions to global inner feature ids (ascending, so the
    first maximum is the smallest id), as a sharded or elected scan reports
    them (split.py:570-589); None means the positions are the ids."""
    best_f = torch.argmax(fb.gain, -1, keepdim=True)   # first max
    fields = {name: torch.gather(getattr(fb, name), -1, best_f)[..., 0]
              for name in FeatureBest._fields if name != "cat_bitset"}
    W = fb.cat_bitset.shape[-1]
    idx = best_f[..., None].expand(best_f.shape[:-1] + (1, W))
    bits = torch.gather(fb.cat_bitset, -2, idx)[..., 0, :]
    feature = best_f[..., 0]
    if feature_ids is not None:
        feature = feature_ids.to(feature.device)[feature]
    return BestSplit(feature=feature, cat_bitset=bits, **fields)


_SYNC_FIELDS = tuple(f for f in BestSplit._fields if f != "cat_bitset")


def sync_best(best: BestSplit, comm) -> BestSplit:
    """The best of every rank's best split (``SyncUpGlobalBestSplit``,
    parallel_tree_learner.h:190-213; split.py:592-600): the candidates
    (fields [...]) are all-gathered in one f64 payload (f32 values, ids and
    32-bit bitset words are exact in f64), and the largest gain wins, ties
    going to the smaller feature id.  ``comm`` is a
    :class:`lightgbm_tpu_torch.parallel.comm.ProcessComm`."""
    f64 = torch.float64
    packed = torch.cat([torch.stack([getattr(best, f).to(f64)
                                     for f in _SYNC_FIELDS], dim=-1),
                        best.cat_bitset.to(f64)], dim=-1)
    g = comm.all_gather(packed)                     # [d, ..., width]
    gain = g[..., 0]
    feature = g[..., 1]
    top = gain.max(0, keepdim=True).values
    tie = torch.where(gain == top, feature, torch.full_like(feature, 2 ** 31))
    i = torch.argmin(tie, 0, keepdim=True)          # [1, ...]
    won = torch.gather(g, 0, i[..., None].expand((1,) + g.shape[1:]))[0]
    out = {f: won[..., k].to(getattr(best, f).dtype)
           for k, f in enumerate(_SYNC_FIELDS)}
    out["cat_bitset"] = won[..., len(_SYNC_FIELDS):].to(best.cat_bitset.dtype)
    return BestSplit(**out)


def best_split(hist: torch.Tensor, feat: FeatureInfo,
               feature_mask: torch.Tensor, sum_grad, sum_hess, num_data,
               params: SplitParams, *, any_categorical: bool = False,
               cmin=None, cmax=None,
               contri: Optional[torch.Tensor] = None) -> BestSplit:
    """The best split of a leaf (or of each leaf of a batch) over
    per-feature histograms: numerical and categorical scans, the monotone
    bounds, ``feature_contri`` (``contri``, :func:`contri_scale` of
    ``params``, made once a tree by the caller), then the argmax (the serial
    branch of the JAX learner's ``best_of``)."""
    fb = per_feature_best_combined(hist, feat, feature_mask, sum_grad,
                                   sum_hess, num_data, params,
                                   any_categorical, cmin, cmax)
    return reduce_feature_best(apply_feature_contri(fb, contri))


def best_split_numerical(hist: torch.Tensor, feat: FeatureInfo,
                         feature_mask: torch.Tensor, sum_grad, sum_hess,
                         num_data, params: SplitParams) -> BestSplit:
    """Best numerical split over all features of one leaf (or a batch):
    :func:`best_split` with no categorical feature, bound or scale (the name
    of the JAX package's function)."""
    return best_split(hist, feat, feature_mask, sum_grad, sum_hess,
                      num_data, params)
