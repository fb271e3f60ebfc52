"""Leaf-wise (best-first) tree growth over a physically partitioned row store.

Counterpart of ``lightgbm_tpu/core/tree_learner.py`` ``build_tree_partitioned``
and ``SerialTreeLearner`` (the reference ``SerialTreeLearner``,
serial_tree_learner.cpp:150-197), for serial, leaf-wise, numerical, unbundled
growth with exact histograms.  Per split: pick the leaf with the best cached
split, run the fused split pass on its window (route + stable partition +
smaller child's histogram, ``core/partition.py``), derive the sibling's
histogram by subtraction (serial_tree_learner.cpp:347-356), and cache both
children's best splits.

Where the JAX package compiles the whole tree into one ``fori_loop``, growth
here is a host loop over splits with device tensors: the row store, the
per-leaf histogram cache and the split scans live on the device, and each
split brings back one small tensor (the two children's best splits and the
left count) that the host bookkeeping needs.  The tree arrays themselves are
host numpy arrays in f32/i32, so the bookkeeping does the JAX program's f32
arithmetic.

Not ported yet, and refused with ``NotImplementedError``: EFB-bundled
datasets, categorical features, monotone constraints, forced splits, CEGB,
the histogram pool, feature_contri, extra_trees, quantized histograms,
level-wise growth and the parallel learners.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.binning import BinType, MissingType
from ..io.dataset import BinnedDataset
from .histogram import histogram_rows, pad_bins_pow2
from .partition import SCAL_HEAD, partition_hist, scal_missing_code
from .split import (K_MIN_SCORE, BestSplit, FeatureInfo, SplitParams,
                    best_split_numerical)
from .tree import Tree

CHUNK = 4096     # the spare row block past every window (partition.py CHUNK)


class TreeArrays(NamedTuple):
    """Flat tree (L = num_leaves budget; node i valid for i < num_leaves-1).

    Host numpy arrays, except ``row_leaf``: the final leaf of every row, a
    device tensor [N] i64."""
    split_feature: np.ndarray    # [L] i32, inner feature index
    threshold_bin: np.ndarray    # [L] i32
    split_gain: np.ndarray       # [L] f32
    default_left: np.ndarray     # [L] bool
    left_child: np.ndarray       # [L] i32 (~leaf encoding)
    right_child: np.ndarray      # [L] i32
    internal_value: np.ndarray   # [L] f32
    internal_weight: np.ndarray  # [L] f32
    internal_count: np.ndarray   # [L] f32
    leaf_value: np.ndarray       # [L] f32
    leaf_weight: np.ndarray      # [L] f32
    leaf_count: np.ndarray       # [L] f32
    leaf_parent: np.ndarray      # [L] i32
    leaf_depth: np.ndarray       # [L] i32
    num_leaves: int
    row_leaf: Optional[torch.Tensor]


class RowLayout(NamedTuple):
    """Byte layout of the combined row store (tree_learner.py:293-319)."""
    bpc: int          # bytes per bin column (2 for u16 bins)
    nbytes_bins: int  # bin bytes per row
    voff: int         # f32 grad at voff, f32 hess at voff+4, s32 order at voff+8
    W: int            # row width, a multiple of 128


def row_layout(ncols: int, bpc: int) -> RowLayout:
    nbytes = ncols * bpc
    voff = -(-nbytes // 4) * 4
    return RowLayout(bpc, nbytes, voff, -(-(voff + 12) // 128) * 128)


def bin_bytes(binned: np.ndarray) -> np.ndarray:
    """Host [N, C] u8/u16 bins -> [N, C * bpc] u8 (u16 little-endian)."""
    binned = np.ascontiguousarray(binned)
    if binned.dtype == np.uint16:
        return binned.astype("<u2").view(np.uint8).reshape(binned.shape[0], -1)
    return binned.astype(np.uint8)


def row_store_template(bins_u8: np.ndarray, layout: RowLayout,
                       device: torch.device) -> torch.Tensor:
    """[N + CHUNK, W] u8 row store with bins and order bytes filled and the
    grad/hess bytes zero: the bytes of tree_learner.py:370-402 minus the
    per-tree gradients.  The spare CHUNK block past row N holds zero bins and
    the unique order ids N .. N + CHUNK - 1."""
    n = bins_u8.shape[0]
    host = np.zeros((n + CHUNK, layout.W), dtype=np.uint8)
    host[:n, :layout.nbytes_bins] = bins_u8
    order = np.arange(n + CHUNK, dtype="<i4").view(np.uint8).reshape(-1, 4)
    host[:, layout.voff + 8:layout.voff + 12] = order
    return torch.from_numpy(host).to(device)


def fill_gradients(template: torch.Tensor, layout: RowLayout,
                   grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """A fresh row store: ``template`` with the f32 grad/hess bytes of the
    first N rows written at ``voff`` (the spare block keeps zeros)."""
    n = grad.shape[0]
    rows = template.clone()
    gh = torch.stack([grad.to(torch.float32), hess.to(torch.float32)], dim=1)
    rows[:n, layout.voff:layout.voff + 8] = gh.contiguous().view(torch.uint8)
    return rows


def _to_host(best: BestSplit, extra: Optional[torch.Tensor] = None):
    """One device->host transfer of a (batched) BestSplit, f32 exact, plus
    the integers of ``extra`` (exact in f64)."""
    packed = torch.stack([getattr(best, f).to(torch.float64)
                          for f in BestSplit._fields], dim=-1)
    if extra is not None:
        packed = torch.cat([packed.reshape(-1),
                            extra.to(torch.float64).reshape(-1)])
        fetched = packed.cpu().numpy()
        nf = len(BestSplit._fields)
        size = fetched.size - extra.numel()
        return (_unpack(fetched[:size].reshape(-1, nf)),
                fetched[size:].astype(np.int64))
    return _unpack(packed.cpu().numpy())


def _unpack(packed: np.ndarray) -> dict:
    out = {}
    for i, f in enumerate(BestSplit._fields):
        col = packed[..., i]
        if f in ("feature", "threshold"):
            out[f] = col.astype(np.int32)
        elif f == "default_left":
            out[f] = col != 0
        else:
            out[f] = col.astype(np.float32)
    return out


def build_tree_partitioned(rows: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, num_data: int,
                           feature_mask: torch.Tensor, feat: FeatureInfo,
                           feat_host: dict, *, num_leaves: int,
                           max_depth: int, params: SplitParams, num_bins: int,
                           layout: RowLayout, hist_features: int,
                           packed: bool, hist_fn=histogram_rows,
                           part_fn=partition_hist) -> TreeArrays:
    """Grow one tree leaf-wise; ``rows`` is the filled row store (it is
    partitioned in place on the card).  ``feat_host`` holds the per-feature
    ``num_bin``/``missing_type``/``default_bin`` as numpy for the scalar rows.
    ``hist_fn``/``part_fn`` default to the kernel dispatchers; a check may
    pass the plain versions to rebuild the same tree without the kernels.
    """
    n = grad.shape[0]
    L = num_leaves
    B = num_bins
    dev = rows.device
    f32 = np.float32
    hkw = dict(num_features=hist_features, voff=layout.voff, bpc=layout.bpc,
               packed=packed)

    # ---- root ----
    hist = torch.zeros((L, hist_features, 2, B), dtype=torch.float32,
                       device=dev)
    hist[0] = hist_fn(rows, B, 0, n, **hkw)
    sums = torch.stack([grad.sum(), hess.sum()]).to(torch.float32)
    best0 = best_split_numerical(hist[0], feat, feature_mask, sums[0], sums[1],
                                 float(num_data), params)
    root = _to_host(best0)
    sum_g, sum_h = sums.cpu().numpy()

    bests = {k: np.repeat(np.asarray(v)[None], L, axis=0)
             for k, v in root.items()}
    zl = lambda dt=f32: np.zeros(L, dtype=dt)  # noqa: E731
    split_feature, threshold_bin = zl(np.int32), zl(np.int32)
    split_gain, default_left = zl(), zl(bool)
    left_child, right_child = zl(np.int32), zl(np.int32)
    internal_value, internal_weight, internal_count = zl(), zl(), zl()
    leaf_value, leaf_weight, leaf_count = zl(), zl(), zl()
    leaf_parent = np.full(L, -1, dtype=np.int32)
    leaf_depth = zl(np.int32)
    leaf_weight[0] = sum_h
    leaf_count[0] = f32(num_data)
    begin = np.zeros(L, dtype=np.int64)
    wcount = np.zeros(L, dtype=np.int64)
    wcount[0] = n
    nl_leaves = 1
    nw = B // 32

    for k in range(1, L):
        node = k - 1
        gains = np.where(np.arange(L) < nl_leaves, bests["gain"],
                         f32(K_MIN_SCORE))
        if max_depth > 0:
            gains = np.where(leaf_depth < max_depth, gains, f32(K_MIN_SCORE))
        leaf = int(np.argmax(gains))
        if not gains[leaf] > 0.0:
            break
        b = {f: v[leaf] for f, v in bests.items()}
        fid = int(b["feature"])
        wb, wc = int(begin[leaf]), int(wcount[leaf])
        left_smaller = bool(b["left_count"] <= b["right_count"])
        scal = [wb, wc, fid, int(b["threshold"]), int(b["default_left"]),
                scal_missing_code(feat_host["missing_type"][fid]),
                int(feat_host["num_bin"][fid]),
                int(feat_host["default_bin"][fid]), 0, int(left_smaller),
                0, 0] + [0] * nw
        assert len(scal) == SCAL_HEAD + nw
        rows, hist_small, nl_t = part_fn(rows, scal, num_bins=B, **hkw)
        hist_larger = hist[leaf] - hist_small
        if left_smaller:
            hist_left, hist_right = hist_small, hist_larger
        else:
            hist_left, hist_right = hist_larger, hist_small
        hist[leaf] = hist_left
        hist[k] = hist_right

        child_g = torch.tensor([b["left_sum_grad"], b["right_sum_grad"]],
                               dtype=torch.float32, device=dev)
        child_h = torch.tensor([b["left_sum_hess"], b["right_sum_hess"]],
                               dtype=torch.float32, device=dev)
        child_c = torch.tensor([b["left_count"], b["right_count"]],
                               dtype=torch.float32, device=dev)
        child = best_split_numerical(torch.stack([hist_left, hist_right]),
                                     feat, feature_mask, child_g, child_h,
                                     child_c, params)
        fetched, nl_host = _to_host(child, nl_t)
        nl = int(nl_host[0])

        begin[k] = wb + nl
        wcount[leaf] = nl
        wcount[k] = wc - nl
        for f, v in fetched.items():
            bests[f][leaf] = v[0]
            bests[f][k] = v[1]

        # parent child-pointer fixup (tree.h:338-346)
        parent = leaf_parent[leaf]
        if parent >= 0:
            if left_child[parent] == ~leaf:
                left_child[parent] = node
            if right_child[parent] == ~leaf:
                right_child[parent] = node
        split_feature[node] = fid
        threshold_bin[node] = b["threshold"]
        split_gain[node] = b["gain"]
        default_left[node] = b["default_left"]
        left_child[node] = ~leaf
        right_child[node] = ~k
        internal_value[node] = leaf_value[leaf]
        internal_weight[node] = leaf_weight[leaf]
        internal_count[node] = b["left_count"] + b["right_count"]
        leaf_value[leaf] = np.nan_to_num(b["left_output"])
        leaf_value[k] = np.nan_to_num(b["right_output"])
        leaf_weight[leaf] = b["left_sum_hess"]
        leaf_weight[k] = b["right_sum_hess"]
        leaf_count[leaf] = b["left_count"]
        leaf_count[k] = b["right_count"]
        leaf_parent[leaf] = node
        leaf_parent[k] = node
        leaf_depth[k] = leaf_depth[leaf] + 1
        leaf_depth[leaf] += 1
        nl_leaves += 1

    # per-row leaf from the windows and the order bytes: windows tile
    # [0, n) in begin order; the spare block stays past row n
    valid = np.flatnonzero((np.arange(L) < nl_leaves) & (wcount > 0))
    valid = valid[np.argsort(begin[valid], kind="stable")]
    leaf_of_pos = torch.repeat_interleave(
        torch.as_tensor(valid, device=dev),
        torch.as_tensor(wcount[valid], device=dev))
    order = rows[:n, layout.voff + 8:layout.voff + 12].contiguous().view(
        torch.int32).reshape(n).long()
    row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
    row_leaf[order] = leaf_of_pos
    return TreeArrays(
        split_feature=split_feature, threshold_bin=threshold_bin,
        split_gain=split_gain, default_left=default_left,
        left_child=left_child, right_child=right_child,
        internal_value=internal_value, internal_weight=internal_weight,
        internal_count=internal_count, leaf_value=leaf_value,
        leaf_weight=leaf_weight, leaf_count=leaf_count,
        leaf_parent=leaf_parent, leaf_depth=leaf_depth,
        num_leaves=nl_leaves, row_leaf=row_leaf)


def route_binned(bins: torch.Tensor, tree: TreeArrays,
                 feat_host: dict) -> torch.Tensor:
    """Leaf of every binned row [N, F] (numerical splits, unbundled
    columns): Tree::GetLeaf over bins, one level per step."""
    n = bins.shape[0]
    dev = bins.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    m = tree.num_leaves - 1
    sf = tree.split_feature[:m].astype(np.int64)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    sf_d = t(sf)
    thr = t(tree.threshold_bin[:m].astype(np.int64))
    dl = t(tree.default_left[:m])
    lc = t(tree.left_child[:m].astype(np.int64))
    rc = t(tree.right_child[:m].astype(np.int64))
    mt = t(np.asarray(feat_host["missing_type"], np.int64)[sf])
    nb = t(np.asarray(feat_host["num_bin"], np.int64)[sf])
    dbin = t(np.asarray(feat_host["default_bin"], np.int64)[sf])
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    rows_i = torch.arange(n, device=dev)
    for _ in range(int(tree.leaf_depth[:tree.num_leaves].max())):
        nd = torch.clamp(node, min=0)
        col = bins[rows_i, sf_d[nd]].long()
        miss = torch.where(mt[nd] == int(MissingType.NAN), col == nb[nd] - 1,
                           (mt[nd] == int(MissingType.ZERO))
                           & (col == dbin[nd]))
        go_left = torch.where(miss, dl[nd], col <= thr[nd])
        nxt = torch.where(go_left, lc[nd], rc[nd])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def tree_output_binned(bins: torch.Tensor, tree: TreeArrays,
                       feat_host: dict) -> torch.Tensor:
    """Per-row leaf VALUE (f32) of ``tree`` over binned rows."""
    lv = torch.as_tensor(tree.leaf_value, device=bins.device)
    return lv[route_binned(bins, tree, feat_host)]


def tree_from_arrays(arrays: TreeArrays, dataset: BinnedDataset,
                     shrinkage: float = 1.0) -> Tree:
    """Convert tree arrays to a host :class:`Tree` with real thresholds
    (bin thresholds -> values through the BinMappers, Dataset::RealThreshold).
    Numerical splits only."""
    a = arrays
    nl = int(a.num_leaves)
    t = Tree(max_leaves=max(nl, 1))
    t.num_leaves = nl
    ni = max(nl - 1, 0)
    mappers = [dataset.bin_mappers[i] for i in dataset.used_feature_idx]
    for node in range(ni):
        inner = int(a.split_feature[node])
        m = mappers[inner]
        if m.bin_type == BinType.CATEGORICAL:
            raise NotImplementedError("categorical splits are not ported yet "
                                      "(ROADMAP queue 1 item 3)")
        t.split_feature_inner[node] = inner
        t.split_feature[node] = dataset.used_feature_idx[inner]
        t.threshold_in_bin[node] = int(a.threshold_bin[node])
        t.threshold[node] = m.bin_to_value(int(a.threshold_bin[node]))
        t.decision_type[node] = Tree.make_decision_type(
            False, bool(a.default_left[node]), int(m.missing_type))
    t.split_gain[:ni] = a.split_gain[:ni]
    t.left_child[:ni] = a.left_child[:ni]
    t.right_child[:ni] = a.right_child[:ni]
    t.internal_value[:ni] = a.internal_value[:ni]
    t.internal_weight[:ni] = a.internal_weight[:ni]
    t.internal_count[:ni] = np.round(a.internal_count[:ni]).astype(np.int64)
    t.leaf_value[:nl] = a.leaf_value[:nl]
    t.leaf_weight[:nl] = a.leaf_weight[:nl]
    t.leaf_count[:nl] = np.round(a.leaf_count[:nl]).astype(np.int64)
    t.leaf_parent[:nl] = a.leaf_parent[:nl]
    t.leaf_depth[:nl] = a.leaf_depth[:nl]
    if shrinkage != 1.0:
        t.shrink(shrinkage)
    return t


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError("%s is not ported to lightgbm_tpu_torch yet "
                              "(ROADMAP %s)" % (what, item))


class SerialTreeLearner:
    """Owns the device row-store template and per-feature metadata and grows
    one tree per :meth:`train` call."""

    def __init__(self, dataset: BinnedDataset, config,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.dataset = dataset
        self.config = config
        self._check_supported(dataset, config)
        self.num_leaves = int(config.num_leaves)
        self.max_depth = int(config.max_depth)
        self.params = SplitParams(
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            max_delta_step=float(config.max_delta_step),
            min_data_in_leaf=int(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split))
        self.num_data = dataset.num_data
        self.num_bins = pad_bins_pow2(dataset.max_num_bin)
        dev = self.device
        self.feat_host = {
            "num_bin": np.asarray(dataset.num_bin_per_feature, np.int64),
            "missing_type": np.asarray(dataset.missing_types(), np.int64),
            "default_bin": np.asarray(dataset.default_bins(), np.int64)}
        self.feat = FeatureInfo(
            num_bin=torch.as_tensor(self.feat_host["num_bin"], device=dev),
            missing_type=torch.as_tensor(self.feat_host["missing_type"],
                                         device=dev),
            default_bin=torch.as_tensor(self.feat_host["default_bin"],
                                        device=dev),
            is_categorical=torch.as_tensor(dataset.feature_is_categorical(),
                                           device=dev))
        matrix = dataset.binned
        self.num_columns = matrix.shape[1]
        # 4-bit packing (dense_nbits_bin.hpp): two columns per byte
        self.packed = bool(dataset.max_group_bin <= 16 and matrix.shape[1] > 1)
        if self.packed:
            m = np.asarray(matrix, dtype=np.uint8)
            if m.shape[1] % 2:
                m = np.concatenate([m, np.zeros((m.shape[0], 1), np.uint8)], 1)
            bins_u8 = (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)
            bpc = 1
        else:
            bins_u8 = bin_bytes(matrix)
            bpc = 2 if matrix.dtype == np.uint16 else 1
        self.layout = row_layout(bins_u8.shape[1] // bpc, bpc)
        self.template = row_store_template(bins_u8, self.layout, dev)

    @staticmethod
    def _check_supported(dataset: BinnedDataset, config) -> None:
        if dataset.is_bundled:
            _refuse("EFB-bundled datasets (enable_bundle)", "queue 1 item 4")
        if bool(np.asarray(dataset.feature_is_categorical()).any()):
            _refuse("categorical features", "queue 1 item 3")
        if any(int(v) for v in (getattr(config, "monotone_constraints", [])
                                or [])):
            _refuse("monotone constraints", "queue 1 item 3")
        if str(getattr(config, "forcedsplits_filename", "") or ""):
            _refuse("forced splits", "queue 1 item 4")
        if (float(config.cegb_penalty_split) > 0
                or any(config.cegb_penalty_feature_coupled or [])
                or any(config.cegb_penalty_feature_lazy or [])):
            _refuse("CEGB", "queue 1 item 4")
        if float(getattr(config, "histogram_pool_size", -1.0)) > 0:
            _refuse("histogram_pool_size", "queue 1 item 4")
        if list(getattr(config, "feature_contri", []) or []):
            _refuse("feature_contri", "queue 1 item 3")
        if bool(config.extra_trees):
            _refuse("extra_trees", "queue 1 item 3")
        if str(getattr(config, "hist_precision", "exact") or "exact") != "exact":
            _refuse("hist_precision=quantized", "queue 1 item 7")
        if str(getattr(config, "tree_grow_mode", "leaf") or "leaf") != "leaf":
            _refuse("tree_grow_mode=level", "queue 1 item 8")
        if str(getattr(config, "tree_learner", "serial") or "serial") != "serial":
            _refuse("parallel tree learners", "queue 1 item 13")

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              num_data_in_bag: int,
              feature_mask: Optional[torch.Tensor] = None,
              hist_fn=histogram_rows, part_fn=partition_hist) -> TreeArrays:
        """grad/hess: [N] f32 on the learner's device (``hist_fn``/``part_fn``
        as in :func:`build_tree_partitioned`)."""
        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features, dtype=torch.bool,
                                      device=self.device)
        rows = fill_gradients(self.template, self.layout, grad, hess)
        return build_tree_partitioned(
            rows, grad, hess, int(num_data_in_bag), feature_mask, self.feat,
            self.feat_host, num_leaves=self.num_leaves,
            max_depth=self.max_depth, params=self.params,
            num_bins=self.num_bins, layout=self.layout,
            hist_features=self.num_columns, packed=self.packed,
            hist_fn=hist_fn, part_fn=part_fn)
