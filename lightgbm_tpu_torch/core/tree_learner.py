"""Tree growth over a physically partitioned row store.

Counterpart of ``lightgbm_tpu/core/tree_learner.py`` ``build_tree_partitioned``
and ``SerialTreeLearner`` (the reference ``SerialTreeLearner``,
serial_tree_learner.cpp:150-197), for serial, numerical, unbundled growth.
Two growth modes:

- ``tree_grow_mode=leaf`` (best-first): per split, pick the leaf with the
  best cached split, run the fused split pass on its window (route + stable
  partition + smaller child's histogram, ``core/partition.py``), derive the
  sibling's histogram by subtraction (serial_tree_learner.cpp:347-356), and
  cache both children's best splits.
- ``tree_grow_mode=level`` (``level_step``, tree_learner.py:1122-1324):
  per depth, split every leaf of the frontier with a positive gain through
  one level-batched split pass over all their windows and one batched split
  scan over all their children.  A 255-leaf tree takes 8 steps instead of
  254.  The port runs it on the CPU (plain versions) and on the card
  (kernels) alike and never falls back to leaf-wise growth.

``hist_precision=quantized`` (``core/quant.py``) fills the row store with the
iteration's stochastically rounded integer gradients; every histogram is an
exact integer sum, dequantized before it is cached, so the subtraction trick
and the split scan run on real f32 sums.

Where the JAX package compiles the whole tree into one program, growth here
is a host loop with device tensors: the row store, the per-leaf histogram
cache and the split scans live on the device, and each step brings back one
small tensor (the children's best splits and the left counts) that the host
bookkeeping needs.  The tree arrays themselves are host numpy arrays in
f32/i32, so the bookkeeping does the JAX program's f32 arithmetic.

Not ported yet, and refused with ``NotImplementedError``: EFB-bundled
datasets, categorical features, monotone constraints, forced splits, CEGB,
the histogram pool, feature_contri, extra_trees and the parallel learners.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.binning import BinType, MissingType
from ..io.dataset import BinnedDataset
from .histogram import histogram_rows, pad_bins_pow2
from .partition import (SCAL_HEAD, partition_hist, partition_hist_level,
                        scal_missing_code)
from .quant import quantize_gradients
from .split import (K_MIN_SCORE, BestSplit, FeatureInfo, SplitParams,
                    best_split_numerical, dequantize_hist)
from .tree import Tree

CHUNK = 4096     # the spare row block past every window (partition.py CHUNK)


class TreeArrays(NamedTuple):
    """Flat tree (L = num_leaves budget; node i valid for i < num_leaves-1).

    Host numpy arrays, except ``row_leaf``: the final leaf of every row, a
    device tensor [N] i64.  ``host_fetches`` counts the device->host
    transfers the build made, ``levels`` its level steps (0 leaf-wise)."""
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
    host_fetches: int = 0
    levels: int = 0


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


def _to_host(best: BestSplit, extra: torch.Tensor):
    """One device->host transfer of a (batched) BestSplit, f32 exact, plus
    the values of ``extra`` (integers and f32 are exact in f64)."""
    packed = torch.stack([getattr(best, f).to(torch.float64)
                          for f in BestSplit._fields], dim=-1)
    packed = torch.cat([packed.reshape(-1),
                        extra.to(torch.float64).reshape(-1)])
    fetched = packed.cpu().numpy()
    nf = len(BestSplit._fields)
    size = fetched.size - extra.numel()
    return _unpack(fetched[:size].reshape(-1, nf)), fetched[size:]


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


def level_count(num_leaves: int, max_depth: int) -> int:
    """Levels of a ``tree_grow_mode=level`` build (tree_learner.py:1321-1324):
    ``min(max_depth, L - 1)``, else ``ceil(log2 L)``."""
    if max_depth > 0:
        return min(max_depth, num_leaves - 1)
    return max(1, int(np.ceil(np.log2(num_leaves))))


class _Growth:
    """One tree while it grows: the device row store and per-leaf histogram
    cache, and the host bookkeeping in numpy f32/i32 (so it does the JAX
    program's f32 arithmetic).  ``fetches`` counts the device->host
    transfers, ``levels`` the level steps."""

    def __init__(self, rows, grad, hess, num_data, feature_mask, feat,
                 feat_host, *, num_leaves, params, num_bins, layout,
                 hist_features, packed, qscale, hist_fn, part_fn, level_fn):
        n = grad.shape[0]
        L = num_leaves
        B = num_bins
        dev = rows.device
        f32 = np.float32
        self.rows, self.n, self.L, self.B, self.dev = rows, n, L, B, dev
        self.feat, self.feat_host, self.feature_mask = feat, feat_host, \
            feature_mask
        self.params, self.layout, self.qscale = params, layout, qscale
        self.part_fn, self.level_fn = part_fn, level_fn
        self.hkw = dict(num_features=hist_features, voff=layout.voff,
                        bpc=layout.bpc, packed=packed,
                        quantized=qscale is not None)
        self.fetches = 0
        self.levels = 0

        # ---- root ----
        self.hist = torch.zeros((L, hist_features, 2, B), dtype=torch.float32,
                                device=dev)
        self.hist[0] = self._dequant(hist_fn(rows, B, 0, n, **self.hkw))
        if qscale is None:
            sums = torch.stack([grad.sum(), hess.sum()]).to(torch.float32)
        else:
            # the integer sums (exact in f64) times the iteration's scales
            sums = torch.stack([grad.double().sum(), hess.double().sum()]
                               ).float() * qscale
        best0 = best_split_numerical(self.hist[0], feat, feature_mask,
                                     sums[0], sums[1], float(num_data), params)
        root, sums_host = self._fetch(best0, sums)
        sum_h = f32(sums_host[1])

        self.bests = {k: np.repeat(v, L, axis=0) for k, v in root.items()}
        zl = lambda dt=f32: np.zeros(L, dtype=dt)  # noqa: E731
        self.split_feature, self.threshold_bin = zl(np.int32), zl(np.int32)
        self.split_gain, self.default_left = zl(), zl(bool)
        self.left_child, self.right_child = zl(np.int32), zl(np.int32)
        self.internal_value, self.internal_weight = zl(), zl()
        self.internal_count = zl()
        self.leaf_value, self.leaf_weight, self.leaf_count = zl(), zl(), zl()
        self.leaf_parent = np.full(L, -1, dtype=np.int32)
        self.leaf_depth = zl(np.int32)
        self.leaf_weight[0] = sum_h
        self.leaf_count[0] = f32(num_data)
        self.begin = np.zeros(L, dtype=np.int64)
        self.wcount = np.zeros(L, dtype=np.int64)
        self.wcount[0] = n
        self.nl_leaves = 1

    def _dequant(self, hist: torch.Tensor) -> torch.Tensor:
        """Quantized mode: integer sums -> real f32 sums before caching
        (``reduce_hist``, tree_learner.py:490-508); identity otherwise."""
        return hist if self.qscale is None else dequantize_hist(hist,
                                                                self.qscale)

    def _fetch(self, best: BestSplit, extra: torch.Tensor):
        self.fetches += 1
        return _to_host(best, extra)

    def _scal(self, wb, wc, b, left_smaller) -> np.ndarray:
        """Scal rows [G, 12 + B/32] of the splits ``b`` (fields [G])."""
        fh = self.feat_host
        fid = np.asarray(b["feature"], np.int64)
        scal = np.zeros((fid.size, SCAL_HEAD + self.B // 32), dtype=np.int64)
        scal[:, 0] = wb
        scal[:, 1] = wc
        scal[:, 2] = fid
        scal[:, 3] = b["threshold"]
        scal[:, 4] = b["default_left"]
        scal[:, 5] = [scal_missing_code(m) for m in fh["missing_type"][fid]]
        scal[:, 6] = fh["num_bin"][fid]
        scal[:, 7] = fh["default_bin"][fid]
        scal[:, 9] = left_smaller
        return scal

    def _children(self, hist_small, leaf, kid, left_smaller, b):
        """Subtraction trick and the children's best splits, batched over
        the G splits of a step: returns the batched BestSplit over the 2G
        children (all left children first) and caches both histograms."""
        dev = self.dev
        lt = torch.as_tensor(leaf, device=dev)
        kt = torch.as_tensor(kid, device=dev)
        hist_larger = self.hist[lt] - hist_small
        ls = torch.as_tensor(left_smaller, device=dev)[:, None, None, None]
        hist_left = torch.where(ls, hist_small, hist_larger)
        hist_right = torch.where(ls, hist_larger, hist_small)
        self.hist[lt] = hist_left
        self.hist[kt] = hist_right

        def pair(lf, rf):
            return torch.as_tensor(np.concatenate([b[lf], b[rf]]),
                                   dtype=torch.float32, device=dev)
        return best_split_numerical(
            torch.cat([hist_left, hist_right]), self.feat, self.feature_mask,
            pair("left_sum_grad", "right_sum_grad"),
            pair("left_sum_hess", "right_sum_hess"),
            pair("left_count", "right_count"), self.params)

    def _apply(self, leaf, kid, node, b, nl, wb, wc, fetched) -> None:
        """Host bookkeeping of G splits (leaf ``leaf[i]`` -> children
        ``leaf[i]``, ``kid[i]`` at node ``node[i]``), vectorized."""
        G = leaf.size
        # parent child-pointer fixup (tree.h:338-346): siblings of one level
        # fix their common parent through different slots
        parent = self.leaf_parent[leaf].astype(np.int64)
        pidx = np.maximum(parent, 0)
        upd_l = (parent >= 0) & (self.left_child[pidx] == ~leaf)
        upd_r = (parent >= 0) & (self.right_child[pidx] == ~leaf)
        self.left_child[pidx[upd_l]] = node[upd_l]
        self.right_child[pidx[upd_r]] = node[upd_r]
        self.split_feature[node] = b["feature"]
        self.threshold_bin[node] = b["threshold"]
        self.split_gain[node] = b["gain"]
        self.default_left[node] = b["default_left"]
        self.left_child[node] = ~leaf
        self.right_child[node] = ~kid
        self.internal_value[node] = self.leaf_value[leaf]
        self.internal_weight[node] = self.leaf_weight[leaf]
        self.internal_count[node] = b["left_count"] + b["right_count"]
        self.leaf_value[leaf] = np.nan_to_num(b["left_output"])
        self.leaf_value[kid] = np.nan_to_num(b["right_output"])
        self.leaf_weight[leaf] = b["left_sum_hess"]
        self.leaf_weight[kid] = b["right_sum_hess"]
        self.leaf_count[leaf] = b["left_count"]
        self.leaf_count[kid] = b["right_count"]
        self.leaf_parent[leaf] = node
        self.leaf_parent[kid] = node
        depth = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] = depth
        self.leaf_depth[kid] = depth
        self.begin[kid] = wb + nl
        self.wcount[leaf] = nl
        self.wcount[kid] = wc - nl
        for f, v in fetched.items():
            self.bests[f][leaf] = v[:G]
            self.bests[f][kid] = v[G:]
        self.nl_leaves += G

    def split_leaf(self, max_depth: int) -> bool:
        """One leaf-wise step: split the leaf with the best cached gain
        (tree_learner.py:852-1120).  False when no leaf can split."""
        L = self.L
        gains = np.where(np.arange(L) < self.nl_leaves, self.bests["gain"],
                         np.float32(K_MIN_SCORE))
        if max_depth > 0:
            gains = np.where(self.leaf_depth < max_depth, gains,
                             np.float32(K_MIN_SCORE))
        leaf = int(np.argmax(gains))
        if not gains[leaf] > 0.0:
            return False
        return self._split(np.asarray([leaf], np.int64))

    def split_level(self, d: int) -> bool:
        """One level step (``level_step``, tree_learner.py:1122-1309): split
        every depth-``d`` leaf with a positive gain, in ascending id order,
        as far as the leaf budget allows, through one level-batched split
        pass.  False when the level has no such leaf."""
        L = self.L
        ids = np.arange(L)
        gains = np.where(ids < self.nl_leaves, self.bests["gain"],
                         np.float32(K_MIN_SCORE))
        found = np.flatnonzero((self.leaf_depth == d) & (ids < self.nl_leaves)
                               & (gains > 0.0))
        leaf = found[:L - self.nl_leaves].astype(np.int64)
        if leaf.size == 0:
            return False
        self.levels += 1
        return self._split(leaf, level=True)

    def _split(self, leaf: np.ndarray, level: bool = False) -> bool:
        G = leaf.size
        kid = self.nl_leaves + np.arange(G, dtype=np.int64)
        node = kid - 1
        b = {f: v[leaf] for f, v in self.bests.items()}
        wb, wc = self.begin[leaf], self.wcount[leaf]
        left_smaller = b["left_count"] <= b["right_count"]
        scal = self._scal(wb, wc, b, left_smaller)
        if level:
            self.rows, hist_small, nl_t = self.level_fn(
                self.rows, scal, num_bins=self.B, **self.hkw)
        else:
            self.rows, hist_small, nl_t = self.part_fn(
                self.rows, scal[0].tolist(), num_bins=self.B, **self.hkw)
            hist_small = hist_small[None]
        child = self._children(self._dequant(hist_small), leaf, kid,
                               left_smaller, b)
        fetched, nl_host = self._fetch(child, nl_t)
        self._apply(leaf, kid, node, b, nl_host.astype(np.int64), wb, wc,
                    fetched)
        return True

    def arrays(self) -> TreeArrays:
        """The grown tree, with the per-row leaf read from the windows and
        the order bytes: windows tile [0, n) in begin order; the spare block
        stays past row n."""
        L, n, dev, layout = self.L, self.n, self.dev, self.layout
        valid = np.flatnonzero((np.arange(L) < self.nl_leaves)
                               & (self.wcount > 0))
        valid = valid[np.argsort(self.begin[valid], kind="stable")]
        leaf_of_pos = torch.repeat_interleave(
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(self.wcount[valid], device=dev))
        order = self.rows[:n, layout.voff + 8:layout.voff + 12].contiguous(
        ).view(torch.int32).reshape(n).long()
        row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
        row_leaf[order] = leaf_of_pos
        return TreeArrays(
            split_feature=self.split_feature,
            threshold_bin=self.threshold_bin, split_gain=self.split_gain,
            default_left=self.default_left, left_child=self.left_child,
            right_child=self.right_child,
            internal_value=self.internal_value,
            internal_weight=self.internal_weight,
            internal_count=self.internal_count, leaf_value=self.leaf_value,
            leaf_weight=self.leaf_weight, leaf_count=self.leaf_count,
            leaf_parent=self.leaf_parent, leaf_depth=self.leaf_depth,
            num_leaves=self.nl_leaves, row_leaf=row_leaf,
            host_fetches=self.fetches, levels=self.levels)


def build_tree_partitioned(rows: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, num_data: int,
                           feature_mask: torch.Tensor, feat: FeatureInfo,
                           feat_host: dict, *, num_leaves: int,
                           max_depth: int, params: SplitParams, num_bins: int,
                           layout: RowLayout, hist_features: int,
                           packed: bool, grow_mode: str = "leaf",
                           qscale: Optional[torch.Tensor] = None,
                           hist_fn=histogram_rows, part_fn=partition_hist,
                           level_fn=partition_hist_level) -> TreeArrays:
    """Grow one tree; ``rows`` is the filled row store (it is partitioned in
    place on the card).  ``feat_host`` holds the per-feature
    ``num_bin``/``missing_type``/``default_bin`` as numpy for the scalar rows.

    ``grow_mode`` "leaf" splits the best leaf per step; "level" splits a
    whole depth per step (one level-batched split pass and one batched split
    scan per level) and never falls back to leaf-wise growth.  ``qscale``
    (hist_precision=quantized) holds the iteration's (s_g, s_h): grad/hess
    and the row store then carry the quantized integers and every histogram
    is dequantized before it is cached.  ``hist_fn``/``part_fn``/``level_fn``
    default to the kernel dispatchers; a check may pass the plain versions
    to rebuild the same tree without the kernels.
    """
    g = _Growth(rows, grad, hess, num_data, feature_mask, feat, feat_host,
                num_leaves=num_leaves, params=params, num_bins=num_bins,
                layout=layout, hist_features=hist_features, packed=packed,
                qscale=qscale, hist_fn=hist_fn, part_fn=part_fn,
                level_fn=level_fn)
    if grow_mode == "level":
        for d in range(level_count(num_leaves, max_depth)
                       if num_leaves > 1 else 0):
            if not g.split_level(d):
                break
    elif grow_mode == "leaf":
        for _ in range(1, num_leaves):
            if not g.split_leaf(max_depth):
                break
    else:
        raise ValueError("unknown grow_mode %r (leaf or level)" % grow_mode)
    return g.arrays()


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


def arrays_from_tree(tree: Tree, dataset: BinnedDataset) -> TreeArrays:
    """A host tree as routable TreeArrays over ``dataset``'s bins (the
    counterpart of ``GBDT._tree_to_device``): bin thresholds recomputed from
    the real thresholds (a parsed model text carries only those), so a
    loaded tree routes the binned rows as its trained form did.  Numerical
    splits only; leaf values in f32."""
    nl = int(tree.num_leaves)
    ni = max(nl - 1, 0)
    inner = np.zeros(ni, np.int32)
    thr = np.zeros(ni, np.int32)
    for node in range(ni):
        if int(tree.decision_type[node]) & 1:
            raise NotImplementedError("categorical splits are not ported yet "
                                      "(ROADMAP queue 1 item 3)")
        f = int(tree.split_feature[node])
        inner[node] = dataset.inner_feature_map[f]
        thr[node] = dataset.bin_mappers[f].value_to_bin(
            float(tree.threshold[node]))
    f32 = np.float32
    return TreeArrays(
        split_feature=inner, threshold_bin=thr,
        split_gain=np.asarray(tree.split_gain[:ni], f32),
        default_left=(np.asarray(tree.decision_type[:ni]) & 2) > 0,
        left_child=np.asarray(tree.left_child[:ni], np.int32),
        right_child=np.asarray(tree.right_child[:ni], np.int32),
        internal_value=np.asarray(tree.internal_value[:ni], f32),
        internal_weight=np.asarray(tree.internal_weight[:ni], f32),
        internal_count=np.asarray(tree.internal_count[:ni], f32),
        leaf_value=np.asarray(tree.leaf_value[:nl], f32),
        leaf_weight=np.asarray(tree.leaf_weight[:nl], f32),
        leaf_count=np.asarray(tree.leaf_count[:nl], f32),
        leaf_parent=np.asarray(tree.leaf_parent[:nl], np.int32),
        leaf_depth=np.asarray(tree.leaf_depth[:nl], np.int32),
        num_leaves=nl, row_leaf=None)


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
        self.tree_grow_mode = str(getattr(config, "tree_grow_mode", "leaf")
                                  or "leaf")
        self.quantized = str(getattr(config, "hist_precision", "exact")
                             or "exact") == "quantized"
        # the quantization stream is keyed by (seed, iteration, row id)
        self.quant_seed = int(getattr(config, "seed", 0) or 0)
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
        if str(getattr(config, "tree_learner", "serial") or "serial") != "serial":
            _refuse("parallel tree learners", "queue 1 item 13")

    def valid_bins(self, dataset: BinnedDataset) -> torch.Tensor:
        """Binned matrix [N, F] of a validation set (binned with the training
        set's mappers, ``reference=``) on the learner's device, for
        :func:`route_binned` (the JAX learner's ``valid_bins``)."""
        if dataset.is_bundled:
            _refuse("EFB-bundled datasets (enable_bundle)", "queue 1 item 4")
        if dataset.binned.shape[1] != self.num_columns:
            raise ValueError("validation set has %d bin columns, the training "
                             "set %d: bin it with reference= the training set"
                             % (dataset.binned.shape[1], self.num_columns))
        bins = np.ascontiguousarray(dataset.binned)
        if bins.dtype == np.uint16:
            bins = bins.astype(np.int32)
        return torch.from_numpy(bins).to(self.device)

    def level_count(self) -> int:
        """Level steps of a tree_grow_mode=level build (its schedule)."""
        return level_count(self.num_leaves, self.max_depth)

    def launches_per_tree(self) -> int:
        """Split-pass launches one tree makes at most: one per level in
        level mode (whatever the window sizes), L - 1 leaf-wise
        (tree_learner.py:1834-1848)."""
        if self.tree_grow_mode == "level":
            return self.level_count()
        return self.num_leaves - 1

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              num_data_in_bag: int,
              feature_mask: Optional[torch.Tensor] = None, iteration: int = 0,
              hist_fn=histogram_rows, part_fn=partition_hist,
              level_fn=partition_hist_level) -> TreeArrays:
        """grad/hess: [N] f32 on the learner's device.  ``iteration`` keys
        the quantized path's rounding hash (ignored when exact);
        ``hist_fn``/``part_fn``/``level_fn`` as in
        :func:`build_tree_partitioned`."""
        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features, dtype=torch.bool,
                                      device=self.device)
        qscale = None
        if self.quantized:
            rid = torch.arange(grad.shape[0], device=self.device)
            grad, hess, qscale = quantize_gradients(grad, hess, rid,
                                                    int(iteration),
                                                    self.quant_seed)
        rows = fill_gradients(self.template, self.layout, grad, hess)
        return build_tree_partitioned(
            rows, grad, hess, int(num_data_in_bag), feature_mask, self.feat,
            self.feat_host, num_leaves=self.num_leaves,
            max_depth=self.max_depth, params=self.params,
            num_bins=self.num_bins, layout=self.layout,
            hist_features=self.num_columns, packed=self.packed,
            grow_mode=self.tree_grow_mode, qscale=qscale, hist_fn=hist_fn,
            part_fn=part_fn, level_fn=level_fn)
