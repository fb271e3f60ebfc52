"""Tree growth over a physically partitioned row store.

Counterpart of ``lightgbm_tpu/core/tree_learner.py`` ``build_tree_partitioned``,
``Comm`` and ``SerialTreeLearner`` (the reference ``SerialTreeLearner``,
serial_tree_learner.cpp:150-197).
Two growth modes:

- ``tree_grow_mode=leaf`` (best-first): per split, pick the leaf with the
  best cached split, run the fused split pass on its window (route + stable
  partition + smaller child's histogram, ``core/partition.py``), derive the
  sibling's histogram by subtraction (serial_tree_learner.cpp:347-356), and
  cache both children's best splits.  Serial leaf-wise growth runs on the
  device (:class:`_DeviceGrowth`), as the JAX package compiles it into one
  ``fori_loop`` with no host round trip between splits
  (tree_learner.py:9-13, :852-1351): L - 1 steps whose state stays in
  device tensors, the leaf chosen by an ``argmax`` there, the split pass
  reading its window from a scal row in device memory
  (``partition_hist_window``), a step whose leaf cannot split run on an
  empty window with every write dropped, and the tree read back once at
  its end.
- ``tree_grow_mode=level`` (``level_step``, tree_learner.py:1122-1324):
  per depth, split every leaf of the frontier with a positive gain through
  one level-batched split pass over all their windows and one batched split
  scan over all their children.  A 255-leaf tree takes 8 steps instead of
  254.  Every window of one level holds leaves of one depth, so the pass
  reads depth d from row store d % 2 and writes store 1 - d % 2: no row is
  copied back, and a leaf's rows stay in the store of its depth's parity.
  Level growth runs on the device too (:meth:`_DeviceGrowth.level_step`),
  as the JAX build unrolls it: the frontier compacted on the device into
  the level's ``min(2**d, L - 1)`` slots, dead slots on (0, 0) windows
  writing the sink row L, the level pass reading its windows from scal rows
  in device memory and building its block and histogram maps from their
  counts there (``partition_hist_level_window``), and one fetch a tree.
  The port runs it on the CPU (plain versions) and on the card (kernels)
  alike and never falls back to leaf-wise growth.

``hist_precision=quantized`` (``core/quant.py``) fills the row store with the
iteration's stochastically rounded integer gradients; every histogram is an
exact integer sum, dequantized before it is cached, so the subtraction trick
and the split scan run on real f32 sums.

Which build runs when (:func:`grows_on_device`): the device build for
every tree, leaf-wise (forced splits, CEGB, the histogram pool and the
parallel learners' comms included) and level-wise; the host loop
(:class:`_Growth`) only for a check that asks for it (``host_loop``).  The
host loop keeps the row store, the histogram cache and the split scans on
the device, brings back one small tensor a step (the children's best splits
and the left counts) and does the bookkeeping in host numpy f32/i32; the
device build does the same f32 operations in the same order on the device,
and both run their collectives and scans through one :class:`_LeafScan`
(a level's scan over the same padded slots), so both give the same trees
byte for byte.

On an EFB-bundled dataset the row store holds the group columns
(``dataset.binned``) and the histograms, the per-leaf cache among them, are
over groups; each split scan first unpacks them into per-feature histograms
(``unpack_groups``: the JAX learner's ``unpack``, tree_learner.py:427-437,
with the shared bin 0 rebuilt from the leaf totals), and the split passes
unfold the group codes of the split feature (scal ``use_unfold``,
``efb_offset``).  Categorical features split by a bin bitset carried in the
scal row; monotone constraints propagate the leaf bounds ``cmin``/``cmax``
(tree_learner.py:984-997, :1220-1230); ``extra_trees`` and ``feature_contri``
act inside the split scan (``core/split.py``).

Leaf-wise growth also takes the JAX learner's leaf-wise-only options:

- forced splits (``forcedsplits_filename``, ``_load_forced_splits``): a BFS
  schedule of (leaf, feature, threshold bin); the k-th split takes the k-th
  entry while every earlier one applied (``forced_best``,
  tree_learner.py:662-696), gathered from the leaf's cached histogram with
  the candidates restricted to that bin;
- CEGB (``cegb_*``, ``_init_cegb``): each candidate's gain loses the split
  penalty times the leaf's count, the coupled penalty of a feature not yet
  used, and the lazy penalty of the leaf's rows that have not paid the
  feature yet (tree_learner.py:634-647).  The first use of a feature refunds
  its coupled penalty in every leaf's cached per-feature candidates (the
  cache ``fbc``) and promotes those that now win (:998-1040).  The lazy
  paid bits, one per (row, feature), ride in ``ceil(F / 8)`` bytes after
  the order column of the row store, so the split passes move them with
  the rows;
- the histogram pool (``histogram_pool_size`` MB): the per-leaf cache
  becomes K LRU slots, and a parent whose slot was evicted is rebuilt by
  streaming its window through the histogram kernel (:819-835, :940-980).
  It is ignored, with a warning, with forced splits or CEGB.

``tree_grow_mode=level`` with any of them grows leaf-wise, with one warning
(``effective_grow_mode``, tree_learner.py:1780-1808).

The parallel learners (``parallel/learners.py``) grow through the same
:func:`build_tree_partitioned` with a :class:`Comm`: one process per rank of
a ``torch.distributed`` group, each holding a contiguous stripe of the rows
(or, in ``feature`` mode, every row), with the collectives where the JAX
build puts them (``reduce_hist``, tree_learner.py:490-516; ``best_of``,
:582-647; the root sums, :769-773).  Every decision that feeds a collective
comes from replicated data: the chosen leaf (the gains of the synced best
splits), the smaller side (the global counts), the pool's hits and misses
(its slots follow the leaves chosen), the forced-split schedule.  Only the
window offsets and the left counts ``nl`` are the rank's own.  The device
build takes no branch on them at all: each step runs the same collectives,
a pool hit reducing a zero histogram (the JAX comment at :944-949).
Level growth stays serial: under a comm the learner grows leaf-wise with one
warning, as the JAX learner does.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device_async
from ..io.binning import BinType, MissingType
from ..io.dataset import BinnedDataset
from .histogram import histogram_rows, histogram_rows_window, pad_bins_pow2
from .partition import (SCAL_HEAD, level_workspace, part_tile_rows,
                        partition_hist, partition_hist_level,
                        partition_hist_level_window, partition_hist_window,
                        scal_missing_code, window_workspace)
from .quant import quantize_gradients
from .split import (K_MIN_SCORE, BestSplit, FeatureBest, FeatureInfo,
                    SplitParams, apply_feature_contri, best_split,
                    contri_scale, dequantize_hist, per_feature_best,
                    per_feature_best_combined, reduce_feature_best,
                    sync_best)
from .tree import Tree
from ..obs import active as _telemetry_active
from ..obs import launches as _launches
from ..obs import spans as _spans
from ..plan import state as _plan_state
from ..plan.device_specs import current_device_kind
from ..utils.log import Log

CHUNK = 4096     # the spare row block past every window (partition.py CHUNK)


class Comm(NamedTuple):
    """The collective strategy of a parallel tree build (tree_learner.py:
    53-83): ``ops`` is the rank's ``parallel.comm.ProcessComm`` over a group
    of ``num_shards`` ranks, this one ``rank``.  The modes:

    - ``rs``: rows striped; each child's histogram is reduce-scattered over
      the features, so each rank holds and scans the global histograms of
      its F/d block, and the ranks' best splits are all-gathered and the
      best kept (data_parallel_tree_learner.cpp:149-240);
    - ``psum``: rows striped; each child's histogram is all-reduced whole,
      so EFB groups, 4-bit packing, forced splits and CEGB work as serial;
    - ``feature``: every rank holds every row and partitions them alike,
      builds its histograms over its own F/d block only (the split pass's
      feature window) and scans it; only the best splits cross ranks
      (feature_parallel_tree_learner.cpp:33-71);
    - ``voting``: rows striped, histograms local; each rank elects its
      ``top_k`` features by local gain with the minimums scaled by 1/d,
      the votes are all-gathered, and only the ``2 * top_k`` elected
      features' histograms are all-reduced and scanned
      (voting_parallel_tree_learner.cpp:170-366)."""
    ops: object
    mode: str = "psum"
    num_shards: int = 1
    rank: int = 0
    top_k: int = 20


COMM_MODES = ("rs", "psum", "feature", "voting")


class TreeArrays(NamedTuple):
    """Flat tree (L = num_leaves budget; node i valid for i < num_leaves-1).

    Host numpy arrays, except ``row_leaf``: the final leaf of every row, a
    device tensor [N] i64.  ``host_fetches`` counts the device->host
    transfers the build made: one for a tree of the device build (its
    arrays, in one packed transfer at its end; nothing between splits or
    levels), one a split or a level (and one for the root) in the host
    loop.  ``levels`` counts its level steps that split (0 leaf-wise),
    ``split_passes`` its split passes: L - 1 leaf-wise and ``level_count``
    level-wise in the device build (dead steps included), one a split or a
    live level in the host loop.  A device-built tree that the booster has
    not read back yet is a :class:`DeviceTree`."""
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
    cat_bitset: np.ndarray       # [L, B // 32] i64 32-bit words: the bins a
                                 # categorical split sends left
    num_leaves: int
    row_leaf: Optional[torch.Tensor]
    host_fetches: int = 0
    levels: int = 0
    pool_misses: int = 0         # parents rebuilt by the histogram pool
    # lazy CEGB: the paid bits after this tree, [N, ceil(F / 8)] u8 in
    # original row order
    paid_bits: Optional[torch.Tensor] = None
    split_passes: int = 0


class RowLayout(NamedTuple):
    """Byte layout of the combined row store (tree_learner.py:293-319)."""
    bpc: int          # bytes per bin column (2 for u16 bins)
    nbytes_bins: int  # bin bytes per row
    voff: int         # f32 grad at voff, f32 hess at voff+4, s32 order at voff+8
    W: int            # row width, a multiple of 128
    bitbytes: int = 0  # lazy CEGB paid bits at bitoff: bit f % 8 of byte
                       # f // 8 is feature f
    carried: bool = False  # the fused chunk's store: the objective's f32 aux
                           # at aoff and the f32 running score at soff

    @property
    def aoff(self) -> int:
        return self.voff + 12

    @property
    def soff(self) -> int:
        return self.voff + 16

    @property
    def bitoff(self) -> int:
        return self.voff + (20 if self.carried else 12)


def row_layout(ncols: int, bpc: int, bitbytes: int = 0,
               carried: bool = False) -> RowLayout:
    """The layout of ``ncols`` bin columns of ``bpc`` bytes; ``carried``
    adds the aux and score columns after the order (tree_learner.py:
    311-319), so a carried store may be one 128-byte block wider.  Lazy
    CEGB's bits and the carried columns exclude each other (:309-310)."""
    if carried and bitbytes:
        raise ValueError("carried row-store training and lazy CEGB are "
                         "mutually exclusive")
    nbytes = ncols * bpc
    voff = -(-nbytes // 4) * 4
    end = voff + (20 if carried else 12) + bitbytes
    return RowLayout(bpc, nbytes, voff, -(-end // 128) * 128, bitbytes,
                     carried)


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
    rows = template.clone()
    refresh_gradients(rows, layout, grad, hess)
    return rows


def refresh_gradients(rows: torch.Tensor, layout: RowLayout,
                      grad: torch.Tensor, hess: torch.Tensor) -> None:
    """Write the f32 grad/hess bytes of the first N rows of ``rows`` in
    place, in the store's row order (tree_learner.py:357-368): the only
    bytes a carried store's next tree changes before it grows."""
    n = grad.shape[0]
    gh = torch.stack([grad.to(torch.float32), hess.to(torch.float32)], dim=1)
    rows[:n, layout.voff:layout.voff + 8] = gh.contiguous().view(torch.uint8)


def carried_store(template: torch.Tensor, layout: RowLayout,
                  carried: RowLayout, grad: torch.Tensor, hess: torch.Tensor,
                  aux: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """A chunk's first store in the ``carried`` layout, from the plain
    ``template`` (bins and order bytes) in original row order, with the
    grad/hess, aux and score f32 columns of the first N rows
    (tree_learner.py:370-402 with ``extra``); the spare block past row N
    keeps zero values."""
    n = grad.shape[0]
    rows = torch.zeros((template.shape[0], carried.W), dtype=torch.uint8,
                       device=template.device)
    rows[:, :layout.voff + 12] = template[:, :layout.voff + 12]
    refresh_gradients(rows, carried, grad, hess)
    cols = torch.stack([aux.to(torch.float32), score.to(torch.float32)], 1)
    rows[:n, carried.aoff:carried.soff + 4] = cols.contiguous().view(
        torch.uint8)
    return rows


def store_f32(rows: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """The f32 column at byte ``off`` of the first ``n`` rows, as a view
    [n] into the store (writes go to the store)."""
    return rows[:n, off:off + 4].view(torch.float32).reshape(n)


def store_order(rows: torch.Tensor, layout: RowLayout, n: int
                ) -> torch.Tensor:
    """The original row id of each of the first ``n`` store positions (the
    s32 order bytes), i64."""
    return rows[:n, layout.voff + 8:layout.voff + 12].view(
        torch.int32).reshape(n).long()


_SCALAR_FIELDS = tuple(f for f in BestSplit._fields if f != "cat_bitset")


def _pack_best(best: BestSplit) -> torch.Tensor:
    """A (batched) BestSplit as f64 rows [..., 12 + words]: the scalar
    fields in ``_SCALAR_FIELDS`` order, then the bitset words.  The scalars
    are stacked as f32 (the ids and thresholds, below 2**24, and the flags
    are exact there), the 32-bit words in f64."""
    return torch.cat([torch.stack([getattr(best, f) for f in _SCALAR_FIELDS],
                                  dim=-1).double(),
                      best.cat_bitset.double()], dim=-1)


def _to_host(best: BestSplit, extra: torch.Tensor):
    """One device->host transfer of a (batched) BestSplit, f32 exact, plus
    the values of ``extra`` (integers, 32-bit bitset words and f32 are exact
    in f64)."""
    packed = _pack_best(best)
    width = packed.shape[-1]
    packed = torch.cat([packed.reshape(-1),
                        extra.to(torch.float64).reshape(-1)])
    fetched = packed.cpu().numpy()
    size = fetched.size - extra.numel()
    return _unpack(fetched[:size].reshape(-1, width)), fetched[size:]


def _unpack(packed: np.ndarray) -> dict:
    out = {}
    for i, f in enumerate(_SCALAR_FIELDS):
        col = packed[..., i]
        if f in ("feature", "threshold"):
            out[f] = col.astype(np.int32)
        elif f == "default_left":
            out[f] = col != 0
        else:
            out[f] = col.astype(np.float32)
    out["cat_bitset"] = packed[..., len(_SCALAR_FIELDS):].astype(np.int64)
    return out


class SplitScan(NamedTuple):
    """What the split scan of every leaf needs besides its histogram: the
    per-feature metadata and mask, the parameters, whether any feature is
    categorical or monotone, the ``feature_contri`` scale
    (:func:`contri_scale` of the parameters) and, on a bundled dataset, the group-to-feature lanes of
    :func:`unpack_groups` (None otherwise)."""
    feat: FeatureInfo
    feature_mask: torch.Tensor
    params: SplitParams
    categorical: bool = False
    monotone: bool = False
    contri: Optional[torch.Tensor] = None
    lanes: Optional[tuple] = None


def unpack_lanes(dataset: BinnedDataset, num_bins: int, feat_bins: int,
                 device) -> tuple:
    """(lidx [F, Bf] i64, lmask [F, Bf] f32) of a bundled dataset: lane b of
    feature f reads group code ``offset[f] + b - 1`` for the feature's bins
    1 .. nb - 1 and nothing elsewhere (tree_learner.py:1575-1584)."""
    nb = np.asarray(dataset.num_bin_per_feature)
    lanes = np.arange(feat_bins, dtype=np.int64)[None, :]
    lidx = np.clip(np.asarray(dataset.bin_offset, np.int64)[:, None]
                   + lanes - 1, 0, num_bins - 1)
    lmask = ((lanes >= 1) & (lanes < nb[:, None])).astype(np.float32)
    return (torch.as_tensor(lidx, device=device),
            torch.as_tensor(lmask, device=device))


def unpack_groups(hist: torch.Tensor, group: torch.Tensor, lanes: tuple,
                  sum_grad: torch.Tensor, sum_hess: torch.Tensor
                  ) -> torch.Tensor:
    """Group-column histograms [..., G, 2, Bg] -> per-feature [..., F, 2, Bf]
    (``unpack``, tree_learner.py:427-437): each feature's lanes gathered from
    its group, and its bin 0, which the group's other features share, set to
    the leaf totals minus the rest (dataset.h:501 FixHistogram).
    ``sum_grad``/``sum_hess`` are the leaf totals [...]."""
    lidx, lmask = lanes
    hf = hist[..., group, :, :]                          # [..., F, 2, Bg]
    idx = lidx[:, None, :].expand(hf.shape[:-1] + (lidx.shape[1],))
    hf = torch.gather(hf, -1, idx) * lmask[:, None, :]
    rest = hf.sum(-1)                                    # [..., F, 2]
    hf[..., 0, 0] = sum_grad[..., None] - rest[..., 0]
    hf[..., 1, 0] = sum_hess[..., None] - rest[..., 1]
    return hf


def scan_best(sc: SplitScan, hist: torch.Tensor, sum_grad, sum_hess, count,
              cmin=None, cmax=None) -> BestSplit:
    """The serial learner's best splits of leaves (the JAX learner's
    ``best_of`` without CEGB): the group histograms unpacked on a bundled
    dataset, then :func:`best_split` with the monotone bounds (when a
    feature is constrained) and ``feature_contri``.  The totals, counts and
    bounds are f32 tensors [...]."""
    if sc.lanes is not None:
        hist = unpack_groups(hist, sc.feat.group, sc.lanes, sum_grad, sum_hess)
    bounds = dict(cmin=cmin, cmax=cmax) if sc.monotone else {}
    return best_split(hist, sc.feat, sc.feature_mask, sum_grad, sum_hess,
                      count, sc.params, any_categorical=sc.categorical,
                      contri=sc.contri, **bounds)


def scal_table(feat_host: dict) -> np.ndarray:
    """[F, 12] int64: each feature's own entries of a scal row (its column,
    or its group's with ``use_unfold`` and its first group code, the scal
    missing code, ``num_bin``, ``default_bin``, ``is_cat``), 0 at the
    split's entries (the window, threshold, default_left and the
    histogrammed side; tree_learner.py:893-907)."""
    fh = feat_host
    F = len(fh["num_bin"])
    t = np.zeros((F, SCAL_HEAD), dtype=np.int64)
    grouped = fh["group"] is not None
    t[:, 2] = fh["group"] if grouped else np.arange(F)
    t[:, 5] = [scal_missing_code(m) for m in fh["missing_type"]]
    t[:, 6] = fh["num_bin"]
    t[:, 7] = fh["default_bin"]
    t[:, 8] = fh["is_cat"]
    if grouped:
        t[:, 10] = 1
        t[:, 11] = fh["offset"]
    return t


class CegbState(NamedTuple):
    """The CEGB penalties of one tree (``_init_cegb``, tree_learner.py:
    1706-1732, scaled by ``cegb_tradeoff``, over the used features) and the
    state carried between trees: the features split on so far and, for lazy
    penalties, the paid bits of every (row, feature) in original row
    order."""
    split_pen: torch.Tensor            # f32 scalar
    coupled: torch.Tensor              # [F] f32
    lazy: Optional[torch.Tensor]       # [F] f32, None without lazy penalties
    used: np.ndarray                   # [F] bool
    paid: Optional[torch.Tensor]       # [N, ceil(F / 8)] u8 (lazy only)


def pool_slot_count(pool_mb: float, columns: int, num_bins: int) -> int:
    """Histogram pool slots for ``histogram_pool_size`` MB (MiB, as the
    reference's HistogramPool sizes it): one slot holds a leaf's [columns,
    2, num_bins] f32 histogram; at least 2 (tree_learner.py:1612-1634)."""
    slot_bytes = columns * 2 * num_bins * 4
    return max(2, int(pool_mb * 1024 * 1024 // slot_bytes))


def level_count(num_leaves: int, max_depth: int) -> int:
    """Levels of a ``tree_grow_mode=level`` build (tree_learner.py:1321-1324):
    ``min(max_depth, L - 1)``, else ``ceil(log2 L)``."""
    if max_depth > 0:
        return min(max_depth, num_leaves - 1)
    return max(1, int(np.ceil(np.log2(num_leaves))))


def level_slots(num_leaves: int, d: int) -> int:
    """The frontier slots of level ``d`` (``Fcap``, tree_learner.py:
    1131-1132): ``min(2**d, L - 1)``, the most leaves of depth d that can
    split."""
    return min(1 << d, num_leaves - 1)


class _LeafScan:
    """What the two leaf-wise builds share: the root's sums and histogram,
    the collectives of a parallel learner's mode where the JAX build runs
    them (``reduce_hist``, tree_learner.py:490-516; the root sums and the
    lazy counts, :769-773, :932-934) and the best-split scans of leaves
    (``best_of``, :582-647) with CEGB's penalties.  It holds no tree state,
    so the host loop and the device build run the same collectives in the
    same order and the same f32 operations on the same tensors.

    With ``comm`` (a :class:`Comm`) the rank's rows are its store, and the
    histograms it caches hold the rank's F/d block in ``rs`` and
    ``feature`` mode (``cache_features``); ``f0`` is the first histogram
    column (the feature window of ``feature`` mode) and ``shard`` the
    (first, count) of the features the rank scans in ``rs`` and
    ``feature`` mode (tree_learner.py:458-488)."""

    def __init__(self, scan: SplitScan, comm: Optional[Comm],
                 cegb: Optional[CegbState], layout: RowLayout, qscale,
                 num_bins: int, hist_features: int, packed: bool, dev):
        self.scan, self.comm, self.cegb = scan, comm, cegb
        self.layout, self.qscale, self.B, self.dev = (layout, qscale,
                                                      num_bins, dev)
        self.mode = "serial" if comm is None else comm.mode
        F = scan.feat.num_bin.shape[0]
        self.num_features = F
        self.f0, self.shard, self.cache_features = 0, None, hist_features
        if self.mode in ("rs", "feature"):
            d = comm.num_shards
            if F % d or hist_features != F:
                raise ValueError("a feature-sharded scan needs one column per "
                                 "feature, padded to a multiple of the %d "
                                 "ranks (%d features, %d columns)"
                                 % (d, F, hist_features))
            chunk = F // d
            self.shard = (comm.rank * chunk, chunk)
            self.cache_features = chunk
            if self.mode == "feature":
                hist_features, self.f0 = chunk, comm.rank * chunk
            cut = slice(self.shard[0], self.shard[0] + chunk)
            self.scan_c = scan._replace(
                feat=FeatureInfo(*[None if a is None else a[cut]
                                   for a in scan.feat]),
                feature_mask=scan.feature_mask[cut],
                contri=None if scan.contri is None else scan.contri[cut])
            self.ids_c = torch.arange(cut.start, cut.stop, device=dev)
        if self.mode == "voting":
            # the local election scales the leaf minimums by 1/d
            # (voting_parallel_tree_learner.cpp:57-59)
            p, d = scan.params, comm.num_shards
            self.vote_params = p._replace(
                min_data_in_leaf=max(p.min_data_in_leaf // d, 1),
                min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf / d)
        # the rows are striped over the ranks in every mode but feature
        self.striped = comm is not None and self.mode != "feature"
        self.lazy = cegb is not None and cegb.lazy is not None
        self.hkw = dict(num_features=hist_features, voff=layout.voff,
                        bpc=layout.bpc, packed=packed,
                        quantized=qscale is not None)
        # the histogram kernel takes the window as an argument, the split
        # pass as the scal row's trailing element
        self.hist_kw = dict(self.hkw, f_begin=self.f0)

    def root(self, rows, grad, hess, num_data, hist_fn):
        """The root's cached histogram, its (grad, hess) sums [2] f32 (all
        reduced where rows are striped), its in-bag count (a host int, or
        a device scalar from the fused chunk's bag mask: f32 0-d) and, with
        lazy CEGB, the rows that paid each feature [F] f32 (after writing
        the paid bits of earlier trees into ``rows``)."""
        n, dev = grad.shape[0], rows.device
        if self.lazy:
            lo = self.layout.bitoff
            rows[:n, lo:lo + self.layout.bitbytes] = self.cegb.paid
        with _spans.step("split_pass"):
            hist0 = hist_fn(rows, self.B, 0, n, **self.hist_kw)
        hist0 = self.reduce(hist0)
        if self.qscale is None:
            sums = self.psum_rows(torch.stack([grad.sum(), hess.sum()]).to(
                torch.float32))
        else:
            # the integer sums (exact in f64) times the iteration's scales
            sums = self.psum_rows(torch.stack([grad.double().sum(),
                                               hess.double().sum()]))
            sums = sums.float() * self.qscale
        ucnt0 = None
        if self.lazy:
            ucnt0 = self.psum_rows(self.paid_counts(rows[:n]).sum(
                0, dtype=torch.int32)).to(torch.float32)
        count0 = (num_data.to(torch.float32).reshape(())
                  if isinstance(num_data, torch.Tensor)
                  else torch.full((), float(num_data), dtype=torch.float32,
                                  device=dev))
        return hist0, sums, count0, ucnt0

    def psum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks where each holds a stripe of the
        rows."""
        return self.comm.ops.all_reduce_sum(t) if self.striped else t

    def reduce(self, hist: torch.Tensor) -> torch.Tensor:
        """A freshly built histogram [..., F, 2, B] -> what the cache holds
        (``reduce_hist``, tree_learner.py:490-516): reduce-scattered over
        the features (``rs``) or all-reduced (``psum``) across the ranks,
        kept as it is in ``feature`` mode (every row is local) and in
        ``voting`` mode (the histograms stay local); then, when quantized,
        the integer sums dequantized to real f32 sums.

        Quantized histograms cross the ranks as the kernels give them: f32
        integer sums, exact up to 2**24 a bin, as LightGBM reduces its
        integer histograms exactly.  The JAX package casts them to bf16
        first (tree_learner.py:491-508): bf16 keeps 8 significant bits, the
        subtraction trick then takes each larger child from a rounded
        parent, and deep leaves lose their sums; at the Higgs shape on the
        card (1,048,576 rows, 2 ranks) its train log loss rose from 0.5935
        to 0.9079 in the second iteration (PERF.md section 6)."""
        ops = None if self.comm is None else self.comm.ops
        if self.mode == "rs":
            hist = ops.reduce_scatter_features(hist)
        elif self.mode == "psum":
            hist = ops.all_reduce_sum(hist)
        return hist if self.qscale is None else dequantize_hist(hist,
                                                                self.qscale)

    def paid_counts(self, window: torch.Tensor) -> torch.Tensor:
        """[R, F] bools of the rows of ``window`` (row-store rows) that
        paid each feature's lazy cost, unpacked from their bit bytes."""
        lo = self.layout.bitoff
        bits = window[:, lo:lo + self.layout.bitbytes]
        shifts = torch.arange(8, dtype=torch.uint8, device=self.dev)
        return ((bits[..., None] >> shifts) & 1).reshape(
            bits.shape[0], -1)[:, :self.num_features].bool()

    def best(self, hist, sg, sh, count, cmin, cmax, used=None, ucnt=None):
        """Best splits of leaves from their cached (group) histograms, the
        f32 leaf totals and counts [...] and the monotone bounds [...]
        (host or device; read only with a monotone feature): the JAX
        learner's ``best_of`` on the unpacked histograms.  Returns
        (BestSplit, the per-feature candidates with the CEGB penalties, or
        None without CEGB); ``used`` [F] bool holds the features split on
        so far, ``ucnt`` [..., F] the leaves' rows that paid each feature's
        lazy cost.  The growth's one door into the scan: a ``split_scan``
        span."""
        with _spans.step("split_scan"):
            return self._best(hist, sg, sh, count, cmin, cmax, used, ucnt)

    def _best(self, hist, sg, sh, count, cmin, cmax, used, ucnt):
        sc, dev = self.scan, self.dev
        sg = torch.as_tensor(sg, dtype=torch.float32, device=dev)
        sh = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        bounds = {}
        if sc.monotone:
            bounds = dict(cmin=torch.as_tensor(cmin, device=dev),
                          cmax=torch.as_tensor(cmax, device=dev))
        if self.shard is not None or self.mode == "voting":
            return self._parallel_best(hist, sg, sh, count, bounds), None
        if self.cegb is None:
            return scan_best(sc, hist, sg, sh, count, **bounds), None
        if sc.lanes is not None:
            hist = unpack_groups(hist, sc.feat.group, sc.lanes, sg, sh)
        fb = apply_feature_contri(per_feature_best_combined(
            hist, sc.feat, sc.feature_mask, sg, sh, count, sc.params,
            sc.categorical, **bounds), sc.contri)
        # DetlaGain (cost_effective_gradient_boosting.hpp:50-61)
        cg = self.cegb
        cnt = torch.as_tensor(count, dtype=torch.float32, device=dev)[...,
                                                                      None]
        used = torch.as_tensor(used, device=dev)
        penalty = cg.split_pen * cnt + torch.where(
            used, torch.zeros_like(cg.coupled), cg.coupled)
        if cg.lazy is not None:
            penalty = penalty + cg.lazy * torch.clamp(cnt - ucnt, min=0.0)
        fb = fb._replace(gain=torch.where(fb.gain > K_MIN_SCORE,
                                          fb.gain - penalty, fb.gain))
        return reduce_feature_best(fb), fb

    def _parallel_best(self, hist, sg, sh, count, bounds) -> BestSplit:
        """``best_of`` of the ``rs``/``feature`` and ``voting`` modes
        (tree_learner.py:586-627).  ``rs``/``feature``: the scan of the
        rank's F/d block with ``feature_contri`` by global id, then the best
        of the ranks' bests (:func:`sync_best`).  ``voting``: the local scan
        with the scaled minimums elects each rank's ``top_k`` features; the
        ids and their ``gain > K_MIN_SCORE`` flags are all-gathered and
        counted as votes (ties to the lower id); the histograms of the
        ``2 * top_k`` most voted features are all-reduced and scanned.  The
        scan runs over every feature with the others' gains dropped, which
        gives each elected feature the result of a scan of the elected
        ones alone."""
        sc, dev, ops = self.scan, self.dev, self.comm.ops
        f32 = torch.float32
        cnt = torch.as_tensor(count, dtype=f32, device=dev)
        if self.shard is not None:
            c = self.scan_c
            fb = apply_feature_contri(per_feature_best_combined(
                hist, c.feat, c.feature_mask, sg, sh, cnt, sc.params,
                sc.categorical, **bounds), c.contri)
            return sync_best(reduce_feature_best(fb, self.ids_c), ops)
        # every row hits one bin of feature 0: its bins sum to the rank's
        # leaf totals
        local = hist[..., 0, :, :].sum(-1)
        lg, lh = local[..., 0], local[..., 1]
        lcnt = cnt * lh / (sh + 1e-15)
        fb = apply_feature_contri(per_feature_best_combined(
            hist, sc.feat, sc.feature_mask, lg, lh, lcnt, self.vote_params,
            sc.categorical, **bounds), sc.contri)
        F, d = hist.shape[-3], self.comm.num_shards
        k = min(self.comm.top_k, F)
        top_gain, top_ids = torch.topk(fb.gain, k, dim=-1)
        ballots = ops.all_gather(torch.stack(
            [top_ids, (top_gain > K_MIN_SCORE).long()], -1))  # [d, ..., k, 2]
        lead = hist.shape[:-3]
        ids = ballots[..., 0].movedim(0, -2).reshape(lead + (d * k,))
        ok = ballots[..., 1].movedim(0, -2).reshape(lead + (d * k,)).to(f32)
        votes = torch.zeros(lead + (F,), dtype=f32, device=dev)
        votes.scatter_add_(-1, ids, ok)
        key = votes - torch.arange(F, dtype=f32, device=dev) / (F + 1.0)
        elected = torch.sort(torch.topk(key, min(2 * k, F), dim=-1).indices,
                             dim=-1).values
        idx = elected[..., None, None].expand(elected.shape
                                              + hist.shape[-2:])
        he = ops.all_reduce_sum(torch.gather(hist, -3, idx))
        full = torch.zeros_like(hist).scatter_(-3, idx, he)
        fb = apply_feature_contri(per_feature_best_combined(
            full, sc.feat, sc.feature_mask, sg, sh, cnt, sc.params,
            sc.categorical, **bounds), sc.contri)
        won = torch.zeros(lead + (F,), dtype=torch.bool, device=dev)
        won.scatter_(-1, elected, True)
        return reduce_feature_best(fb._replace(gain=torch.where(
            won, fb.gain, torch.full_like(fb.gain, K_MIN_SCORE))))


class _Growth:
    """One tree while it grows in the host loop: the device row store and
    per-leaf histogram cache, and the host bookkeeping in numpy f32/i32 (so
    it does the JAX program's f32 arithmetic), the monotone bounds
    ``cmin``/``cmax`` and the leaf totals ``lsum_g``/``lsum_h`` among it.
    With ``pool_slots`` the cache holds that many LRU slots (``slot_of`` per
    leaf, ``stamps`` per slot); ``forced`` is the forced-split schedule,
    ``cegb`` the tree's CEGB state.  ``fetches`` counts the device->host
    transfers, ``levels`` the level steps, ``misses`` the pool's rebuilt
    parents.  With ``comm`` (a :class:`Comm`) the collectives of its mode
    run where the JAX build runs them (:class:`_LeafScan`)."""

    def __init__(self, rows, grad, hess, num_data, scan: SplitScan,
                 feat_host, *, num_leaves, num_bins, layout, hist_features,
                 packed, qscale, hist_fn, part_fn, level_fn, spare=None,
                 forced=None, cegb: Optional[CegbState] = None,
                 pool_slots: int = 0, comm: Optional[Comm] = None):
        n = grad.shape[0]
        L = num_leaves
        B = num_bins
        dev = rows.device
        f32 = np.float32
        self.rows, self.n, self.L, self.B, self.dev = rows, n, L, B, dev
        # level growth: the leaves of depth d live in stores[d % 2] (the
        # level pass reads one store and writes the other); leaf-wise
        # growth partitions ``rows`` alone
        self.stores = None if spare is None else (rows, spare)
        self.scan, self.feat_host = scan, feat_host
        self.table = scal_table(feat_host)
        self.layout, self.qscale = layout, qscale
        self.hist_fn, self.part_fn, self.level_fn = hist_fn, part_fn, level_fn
        self.sx = sx = _LeafScan(scan, comm, cegb, layout, qscale, B,
                                 hist_features, packed, dev)
        self.mode = sx.mode
        self.hkw, self.hist_kw = sx.hkw, sx.hist_kw
        self.fetches = 0
        self.levels = 0
        self.misses = 0
        self.cmin = np.full(L, -np.inf, dtype=f32)
        self.cmax = np.full(L, np.inf, dtype=f32)
        self.forced, self.force_on = forced, True
        self.cegb = cegb
        self.lazy = sx.lazy
        self.feat_used = None if cegb is None else cegb.used.copy()

        # ---- root ----
        hist0, sums, count0, ucnt0 = sx.root(rows, grad, hess, num_data,
                                             hist_fn)
        self.pool = max(2, min(pool_slots, L)) if pool_slots > 0 else 0
        self.hist = torch.zeros((self.pool or L, sx.cache_features, 2, B),
                                dtype=torch.float32, device=dev)
        self.hist[0] = hist0
        if self.pool:
            self.slot_of = np.full(L, -1, np.int64)
            self.slot_of[0] = 0
            self.stamps = np.full(self.pool, -1, np.int64)
            self.stamps[0] = 0
        best0, fb0 = self._best(hist0, sums[0], sums[1], count0,
                                self.cmin[0], self.cmax[0], ucnt0)
        if fb0 is not None:
            # the per-(leaf, feature) candidates (splits_per_leaf_)
            self.fbc = FeatureBest(*[
                torch.full((L,) + x.shape,
                           K_MIN_SCORE if name == "gain" else 0,
                           dtype=x.dtype, device=dev)
                for name, x in zip(FeatureBest._fields, fb0)])
            for x, v in zip(self.fbc, fb0):
                x[0] = v
        root, sums_host = self._fetch(best0, torch.cat([sums.to(
            torch.float32), count0[None]]))
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
        self.cat_bitset = np.zeros_like(self.bests["cat_bitset"])
        self.leaf_weight[0] = sum_h
        self.leaf_count[0] = f32(sums_host[2])
        self.lsum_g, self.lsum_h = zl(), zl()
        self.lsum_g[0], self.lsum_h[0] = f32(sums_host[0]), sum_h
        self.begin = np.zeros(L, dtype=np.int64)
        self.wcount = np.zeros(L, dtype=np.int64)
        self.wcount[0] = n
        self.nl_leaves = 1

    def _best(self, hist, sum_grad, sum_hess, count, cmin, cmax, ucnt=None):
        """:meth:`_LeafScan.best` with the features split on so far."""
        return self.sx.best(hist, sum_grad, sum_hess, count, cmin, cmax,
                            self.feat_used, ucnt)

    def _fetch(self, best: BestSplit, extra: torch.Tensor):
        self.fetches += 1
        return _to_host(best, extra)

    def _scal(self, wb, wc, b, left_smaller) -> np.ndarray:
        """Scal rows [G, 12 + B/32] of the splits ``b`` (fields [G]): the
        split feature's column (its group's on a bundled dataset, with
        ``use_unfold`` and its first group code), route and bitset words
        (tree_learner.py:890-910)."""
        fid = np.asarray(b["feature"], np.int64)
        # feature mode: the trailing hist_feature_begin (tree_learner.py:
        # 908-912)
        window = int(self.mode == "feature")
        scal = np.zeros((fid.size, SCAL_HEAD + self.B // 32 + window),
                        dtype=np.int64)
        if window:
            scal[:, -1] = self.sx.f0
        scal[:, :SCAL_HEAD] = self.table[fid]
        scal[:, 0] = wb
        scal[:, 1] = wc
        scal[:, 3] = b["threshold"]
        scal[:, 4] = b["default_left"]
        scal[:, 9] = left_smaller
        # the words as the int32 bit patterns the kernels read
        words = b["cat_bitset"]
        words = np.where(words >= 2 ** 31, words - 2 ** 32, words)
        scal[:, SCAL_HEAD:SCAL_HEAD + words.shape[1]] = words
        return scal

    def _bounds(self, leaf, b):
        """Monotone bounds of the children of the splits ``b`` of ``leaf``
        (tree_learner.py:984-997 leaf-wise, :1220-1230 a level): a
        numerical split on a constrained feature bounds each child at the
        mean of the two outputs."""
        pmin, pmax = self.cmin[leaf], self.cmax[leaf]
        if not self.scan.monotone:
            return pmin, pmax, pmin, pmax
        fh = self.feat_host
        fid = np.asarray(b["feature"], np.int64)
        mono = fh["monotone"][fid]
        is_num = ~fh["is_cat"][fid]
        mid = (b["left_output"] + b["right_output"]) * np.float32(0.5)
        lmin = np.where(is_num & (mono < 0), np.maximum(pmin, mid), pmin)
        lmax = np.where(is_num & (mono > 0), np.minimum(pmax, mid), pmax)
        rmin = np.where(is_num & (mono > 0), np.maximum(pmin, mid), pmin)
        rmax = np.where(is_num & (mono < 0), np.minimum(pmax, mid), pmax)
        return lmin, lmax, rmin, rmax

    def _children(self, hist_small, parent, dst_left, dst_right,
                  left_smaller, b, bounds, ucnt=None, slots: int = 0):
        """Subtraction trick and the children's best splits, batched over
        the G splits of a step: the larger child is ``parent`` (the parents'
        histograms [G, ...]) minus the smaller; both are cached at cache
        rows ``dst_left`` / ``dst_right``.  Returns the batched BestSplit
        over the 2G children (all left children first).  ``slots`` > G (a
        level's frontier slots): the scan runs on 2 * ``slots`` children,
        each half padded with zero ones, the shape of the device build's
        scan of its dead slots, so that the two builds' scans are one
        computation."""
        dev = self.dev
        hist_larger = parent - hist_small
        ls = torch.as_tensor(left_smaller, device=dev)[:, None, None, None]
        hist_left = torch.where(ls, hist_small, hist_larger)
        hist_right = torch.where(ls, hist_larger, hist_small)
        self.hist[torch.as_tensor(dst_left, device=dev)] = hist_left
        self.hist[torch.as_tensor(dst_right, device=dev)] = hist_right

        def pair(lf, rf):
            return torch.as_tensor(np.concatenate([b[lf], b[rf]]),
                                   dtype=torch.float32, device=dev)
        lmin, lmax, rmin, rmax = bounds
        G = len(left_smaller)
        pad = max(slots - G, 0)

        def halves(lo, hi, fill=0.0):
            z = torch.full((pad,) + tuple(lo.shape[1:]), fill,
                           dtype=lo.dtype, device=dev)
            return torch.cat([lo, z, hi, z])
        f32 = np.float32
        args = [halves(hist_left, hist_right)]
        for lf, rf in (("left_sum_grad", "right_sum_grad"),
                       ("left_sum_hess", "right_sum_hess"),
                       ("left_count", "right_count")):
            args.append(halves(*(torch.as_tensor(b[f], dtype=torch.float32,
                                                 device=dev)
                                 for f in (lf, rf))))
        for lo, hi, fill in ((lmin, rmin, -np.inf), (lmax, rmax, np.inf)):
            args.append(halves(*(torch.as_tensor(np.asarray(x, f32),
                                                 device=dev)
                                 for x in (lo, hi)), fill)
                        if pad else np.concatenate([lo, hi]))
        best, fb = self._best(*args, ucnt)
        if pad:
            keep = np.r_[0:G, G + pad:2 * G + pad]
            best = BestSplit(*[x[keep] for x in best])
        return best, fb

    def _apply(self, leaf, kid, node, b, nl, wb, wc, fetched,
               bounds) -> None:
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
        self.cat_bitset[node] = b["cat_bitset"]
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
        self.lsum_g[leaf], self.lsum_g[kid] = (b["left_sum_grad"],
                                               b["right_sum_grad"])
        self.lsum_h[leaf], self.lsum_h[kid] = (b["left_sum_hess"],
                                               b["right_sum_hess"])
        self.leaf_parent[leaf] = node
        self.leaf_parent[kid] = node
        depth = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] = depth
        self.leaf_depth[kid] = depth
        lmin, lmax, rmin, rmax = bounds
        self.cmin[leaf], self.cmax[leaf] = lmin, lmax
        self.cmin[kid], self.cmax[kid] = rmin, rmax
        self.begin[kid] = wb + nl
        self.wcount[leaf] = nl
        self.wcount[kid] = wc - nl
        for f, v in fetched.items():
            self.bests[f][leaf] = v[:G]
            self.bests[f][kid] = v[G:]
        self.nl_leaves += G

    def _forced_best(self, k: int) -> dict:
        """The stats of the k-th forced split (``forced_best``,
        tree_learner.py:662-696): the scan of its leaf's cached histogram
        for its feature, restricted to its threshold bin (no feature mask,
        ``feature_contri`` or CEGB penalty), as host fields [1]."""
        fleaf, ffeat, fthr = (int(a[k - 1]) for a in self.forced)
        sc, dev = self.scan, self.dev
        sg, sh = (torch.tensor(float(a[fleaf]), dtype=torch.float32,
                               device=dev)
                  for a in (self.lsum_g, self.lsum_h))
        one = slice(ffeat, ffeat + 1)
        feat1 = FeatureInfo(*[None if a is None else a[one] for a in sc.feat])
        if sc.lanes is not None:
            hist = unpack_groups(self.hist[fleaf], feat1.group,
                                 tuple(x[one] for x in sc.lanes), sg, sh)
        else:
            hist = self.hist[fleaf, one]
        bounds = {}
        if sc.monotone:
            bounds = dict(cmin=self.cmin[fleaf], cmax=self.cmax[fleaf])
        tmask = torch.arange(hist.shape[-1], device=dev) == fthr
        fb = per_feature_best(hist, feat1, torch.ones(1, dtype=torch.bool,
                                                      device=dev),
                              sg, sh, float(self.leaf_count[fleaf]),
                              sc.params, threshold_mask=tmask, **bounds)
        best, _ = self._fetch(reduce_feature_best(fb),
                              torch.zeros(0, device=dev))
        best["feature"][:] = ffeat
        return fleaf, best

    def split_leaf(self, max_depth: int) -> bool:
        """One leaf-wise step: split the leaf with the best cached gain, or
        the next forced split while the schedule holds (tree_learner.py:
        852-1120).  False when no leaf can split."""
        L = self.L
        gains = np.where(np.arange(L) < self.nl_leaves, self.bests["gain"],
                         np.float32(K_MIN_SCORE))
        if max_depth > 0:
            gains = np.where(self.leaf_depth < max_depth, gains,
                             np.float32(K_MIN_SCORE))
        leaf = int(np.argmax(gains))
        ok = bool(gains[leaf] > 0.0)
        b = None
        k = self.nl_leaves
        if self.forced is not None and self.force_on \
                and k <= self.forced[0].size:
            fleaf, fb = self._forced_best(k)
            if fb["gain"][0] > K_MIN_SCORE and (
                    max_depth <= 0 or self.leaf_depth[fleaf] < max_depth):
                leaf, ok, b = fleaf, True, fb
            else:
                # one failed entry invalidates the rest of the schedule
                self.force_on = False
        if not ok:
            return False
        return self._split(np.asarray([leaf], np.int64), b=b)

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
        return self._split(leaf, depth=d)

    def _refund(self, f: int) -> None:
        """The first use of feature ``f`` in this training: its coupled
        penalty is refunded in every leaf's cached candidate for ``f``, and
        a leaf whose refunded candidate beats its cached best takes it
        (UpdateLeafBestSplits, tree_learner.py:998-1040)."""
        fbc = self.fbc
        fbc.gain[:, f] += self.cegb.coupled[f]
        col = BestSplit(feature=torch.full_like(fbc.threshold[:, f], f),
                        **{name: getattr(fbc, name)[:, f]
                           for name in FeatureBest._fields})
        cand, _ = self._fetch(col, torch.zeros(0, device=self.dev))
        old = self.bests["gain"]
        promote = (old > K_MIN_SCORE) & (cand["gain"] > old)
        for name, v in cand.items():
            self.bests[name][promote] = v[promote]

    def _split(self, leaf: np.ndarray, depth: Optional[int] = None,
               b: Optional[dict] = None) -> bool:
        """Split the leaves ``leaf``: leaf-wise (one leaf, ``depth`` None;
        ``b`` a forced split's fields, else the cached bests) or a level of
        depth-``depth`` leaves, from store depth % 2 into the other."""
        G = leaf.size
        kid = self.nl_leaves + np.arange(G, dtype=np.int64)
        node = kid - 1
        if b is None:
            b = {f: v[leaf] for f, v in self.bests.items()}
        wb, wc = self.begin[leaf], self.wcount[leaf]
        left_smaller = b["left_count"] <= b["right_count"]
        scal = self._scal(wb, wc, b, left_smaller)
        if self.cegb is not None:
            f = int(b["feature"][0])
            if not self.feat_used[f]:
                self._refund(f)
                self.feat_used[f] = True
            if self.lazy:
                # every row of the split leaf pays the feature's lazy cost
                col = self.layout.bitoff + f // 8
                self.rows[wb[0]:wb[0] + wc[0], col] |= 1 << (f % 8)
        with _spans.step("split_pass"):
            if depth is not None:
                hist_small, nl_t = self.level_fn(
                    self.stores[depth % 2], self.stores[1 - depth % 2], scal,
                    num_bins=self.B, **self.hkw)
            else:
                self.rows, hist_small, nl_t = self.part_fn(
                    self.rows, scal[0].tolist(), num_bins=self.B, **self.hkw)
                hist_small = hist_small[None]
        # the smaller child is chosen from the replicated global counts, so
        # every rank streams the same child into the collective
        hist_small = self.sx.reduce(hist_small)
        if self.pool:
            parent, dst_l, dst_r = self._pool_slots(int(leaf[0]), int(kid[0]),
                                                    int(wb[0]), int(wc[0]))
        else:
            parent = self.hist[torch.as_tensor(leaf, device=self.dev)]
            dst_l, dst_r = leaf, kid
        ucnt = None
        if self.lazy:
            paid = self.sx.paid_counts(self.rows[wb[0]:wb[0] + wc[0]])
            in_left = (torch.arange(int(wc[0]), device=self.dev)
                       < nl_t.reshape(-1)[0])[:, None]
            used_l = (paid & in_left).sum(0, dtype=torch.int32)
            used_r = paid.sum(0, dtype=torch.int32) - used_l
            ucnt = self.sx.psum_rows(torch.stack([used_l, used_r])).to(
                torch.float32)
        bounds = self._bounds(leaf, b)
        child, child_fb = self._children(
            hist_small, parent, dst_l, dst_r, left_smaller, b, bounds, ucnt,
            0 if depth is None else level_slots(self.L, depth))
        if child_fb is not None:
            for x, v in zip(self.fbc, child_fb):
                x[torch.as_tensor(leaf, device=self.dev)] = v[:G]
                x[torch.as_tensor(kid, device=self.dev)] = v[G:]
        fetched, nl_host = self._fetch(child, nl_t)
        self._apply(leaf, kid, node, b, nl_host.astype(np.int64), wb, wc,
                    fetched, bounds)
        return True

    def _pool_slots(self, leaf: int, kid: int, wb: int, wc: int):
        """The histogram pool's part of a leaf-wise split (tree_learner.py:
        940-980): the parent's histogram [1, ...] from its slot, or rebuilt
        from its window (after the split pass the window still holds exactly
        the parent's rows); the left child keeps the parent's slot (or the
        least recently used one on a miss), the right child evicts the next
        least recently used slot.  Returns (parent, left slot, right
        slot)."""
        ps = int(self.slot_of[leaf])
        if ps >= 0:
            parent = self.hist[ps:ps + 1]
        else:
            self.misses += 1
            with _spans.step("split_pass"):
                parent = self.hist_fn(self.rows, self.B, wb, wc,
                                      **self.hist_kw)
            parent = self.sx.reduce(parent)[None]
        s_l = ps if ps >= 0 else int(np.argmin(self.stamps))
        stamps = self.stamps.copy()
        stamps[s_l] = 2 ** 30
        s_r = int(np.argmin(stamps))
        self.stamps[[s_l, s_r]] = kid
        self.slot_of[(self.slot_of == s_l) | (self.slot_of == s_r)] = -1
        self.slot_of[leaf], self.slot_of[kid] = s_l, s_r
        return parent, np.asarray([s_l]), np.asarray([s_r])

    def _windows(self) -> np.ndarray:
        """The leaves with rows, in the order of their windows, which tile
        [0, n); the spare block stays past row n."""
        valid = np.flatnonzero((np.arange(self.L) < self.nl_leaves)
                               & (self.wcount > 0))
        return valid[np.argsort(self.begin[valid], kind="stable")]

    def _per_position(self, per_leaf: np.ndarray, valid: np.ndarray
                      ) -> torch.Tensor:
        """[n] device tensor: each store position takes its window's value of
        ``per_leaf`` (host counts, so no device read)."""
        return torch.repeat_interleave(
            torch.as_tensor(per_leaf[valid], device=self.dev),
            torch.as_tensor(self.wcount[valid], device=self.dev),
            output_size=self.n)

    def fill_scores(self, score_rate) -> torch.Tensor:
        """The carried store after the tree (tree_learner.py:1337-1351): one
        store that holds every row, its score column plus its leaf's value
        times ``score_rate`` (f32) over each window, as a forward fill with
        no per-row gather.  In level growth a leaf's rows lie in the store
        of its depth's parity, so the windows of the odd-depth leaves are
        first copied into store 0 (the next tree's store)."""
        n, rows = self.n, self.rows
        if self.nl_leaves <= 1:
            return rows         # a root-only tree moved and adds nothing
        valid = self._windows()
        if self.stores is not None:
            spare = self.stores[1]
            odd = self._per_position(self.leaf_depth % 2 == 1, valid)
            rows[:n] = torch.where(odd[:, None], spare[:n], rows[:n])
        lv = self.leaf_value * np.float32(score_rate)
        store_f32(rows, self.layout.soff, n).add_(
            self._per_position(lv, valid))
        return rows

    def arrays(self, carried: bool = False) -> TreeArrays:
        """The grown tree, with the per-row leaf read from the windows and
        the order bytes.  In level growth each position's order bytes are
        read from the store of its leaf's depth parity.  Lazy CEGB's paid
        bits come back in original row order.  ``carried``: ``row_leaf`` is
        empty, as the JAX build returns it (the rows' state stays in the
        permuted store; :meth:`fill_scores`)."""
        n, dev, layout = self.n, self.dev, self.layout
        if carried:
            return self._tree(torch.zeros(0, dtype=torch.int64, device=dev),
                              None)
        valid = self._windows()
        leaf_of_pos = torch.repeat_interleave(
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(self.wcount[valid], device=dev))

        def order_of(rows):
            return rows[:n, layout.voff + 8:layout.voff + 12].contiguous(
            ).view(torch.int32).reshape(n).long()
        if self.stores is None:
            order = order_of(self.rows)
        else:
            odd = torch.repeat_interleave(
                torch.as_tensor(self.leaf_depth[valid] % 2 == 1, device=dev),
                torch.as_tensor(self.wcount[valid], device=dev))
            order = torch.where(odd, order_of(self.stores[1]),
                                order_of(self.stores[0]))
        row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
        row_leaf[order] = leaf_of_pos
        paid = None
        if self.lazy:
            lo = layout.bitoff
            paid = torch.empty((n, layout.bitbytes), dtype=torch.uint8,
                               device=dev)
            paid[order] = self.rows[:n, lo:lo + layout.bitbytes]
        return self._tree(row_leaf, paid)

    def _tree(self, row_leaf, paid) -> TreeArrays:
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
            cat_bitset=self.cat_bitset, num_leaves=self.nl_leaves,
            row_leaf=row_leaf, host_fetches=self.fetches,
            levels=self.levels, pool_misses=self.misses, paid_bits=paid,
            split_passes=(self.levels if self.stores is not None
                          else self.nl_leaves - 1))


# columns of the device build's records: a packed BestSplit (_pack_best),
# then per node and per leaf (_DeviceGrowth)
_B = {f: i for i, f in enumerate(_SCALAR_FIELDS)}
_WORDS = len(_SCALAR_FIELDS)           # the bitset words start here
_NODE_IV, _NODE_WORDS = 4, 7           # node: gain, feature, threshold,
                                       # default_left, internal value, weight,
                                       # count, then the words
_LEAF = ("value", "weight", "count", "parent", "depth")
_PARENT, _DEPTH = _LEAF.index("parent"), _LEAF.index("depth")


class _DeviceGrowth:
    """One tree grown on the device, with no host round trip between
    splits: the JAX build's ``fori_loop`` (``body``, tree_learner.py:
    852-1120), or with ``spare`` (a second row store) its unrolled level
    schedule (:meth:`level_step`, :1122-1324) over the same records.
    Each :meth:`step` picks the leaf of best
    cached gain with an ``argmax`` on the device (masked by ``max_depth``),
    or the next forced split while the schedule holds, builds the split
    pass's scal row there from the learner's per-feature table
    (:func:`scal_table`), runs the split pass on the window that row names
    (``window_fn``, :func:`partition_hist_window`), takes the parent's
    histogram from the cache (or, under the pool, rebuilds it), derives the
    sibling by subtraction and scans both children.  The state lives in
    device tensors with one row per leaf (or node) and a last row, L, that
    a dead step writes instead (the JAX build's masked ``sel``, as its
    level step drops writes at index L): a step whose leaf cannot split
    still runs, on an empty window, and changes nothing.  ``cont`` makes a
    failed step final, as the host loop's ``break`` does.  Every update is
    in place, so one step can be captured in a CUDA graph and replayed.

    The records: ``best`` the leaves' cached best splits
    (:func:`_pack_best` rows, f64), ``node`` [L + 1, 7 + words] f64 (gain,
    feature, threshold, default_left, internal value, weight and count, the
    bitset words), ``leaf`` [L + 1, 5] f64 (``_LEAF``), ``lsum`` [L + 1, 2]
    f32 (the leaves' grad and hess sums), ``child`` [L + 1, 2] i64, ``win``
    [L + 1, 2] i64 (window begin, count), ``cmin``/``cmax`` the monotone
    bounds, ``hist`` the histogram cache.  The f32 bookkeeping is the host
    loop's, in the same order (``internal_count`` as ``left_count +
    right_count``, ``(lo + ro) * 0.5``, ``nan_to_num`` of the outputs), so
    both builds give the same bytes.

    The leaf-wise options (tree_learner.py:634-690, :940-1054):

    - ``forced``: the schedule as device tensors; each step gathers the
      stats of entry ``k`` (``forced_best``, the index clamped to the
      schedule) from its leaf's cached histogram, unpacked from its group
      on bundled data; while ``force_on`` holds and the entry is valid it
      replaces the step's leaf and split (masked selects), and a failed
      entry switches the rest of the schedule off;
    - ``cegb``: the per-(leaf, feature) candidates ``fbc`` [L + 1, F, ...]
      and ``feat_used`` [F] bool; the first use of a feature refunds its
      coupled penalty in every leaf's candidate and promotes those that now
      win, as masked writes; with lazy penalties the split leaf's rows get
      the feature's paid bit and the children's paid counts come from
      masked sums over the store positions, before and after the split pass
      (no kernel, as the JAX build runs lazy CEGB outside its Pallas pass,
      :324);
    - ``pool_slots``: K LRU slots (``slot_of`` [L + 1], ``stamps`` [K]);
      every step launches the parent's rebuild (``rebuild_fn``,
      :func:`histogram_rows_window`) on its window with a count of 0 when
      the parent's slot holds it, so the host takes no branch (the JAX
      ``lax.cond``), and the slots' writes are masked selects: the cache
      stays K slots;
    - ``comm``: the collectives of :class:`_LeafScan`, every rank running
      the same ones in the same order (a pool hit reduces a zero
      histogram).

    Level growth: ``stores`` holds the two row stores, depth d's leaves in
    store d % 2; each level pass (``level_window_fn``,
    :func:`partition_hist_level_window`, on ``level_work``) reads its
    windows from a [fcap, S] scal tensor gathered on the device;
    ``live_levels`` counts the levels that split.

    :meth:`finish` reads the tree back in one transfer."""

    def __init__(self, rows, grad, hess, num_data, scan: SplitScan,
                 table: torch.Tensor, *, num_leaves, max_depth, num_bins,
                 layout, hist_features, packed, qscale, hist_fn, window_fn,
                 work, rebuild_fn=histogram_rows_window, forced=None,
                 cegb: Optional[CegbState] = None, pool_slots: int = 0,
                 comm: Optional[Comm] = None, spare=None, level_work=None,
                 level_window_fn=partition_hist_level_window):
        n = grad.shape[0]
        L = num_leaves
        dev = rows.device
        f32, f64, i64 = torch.float32, torch.float64, torch.int64
        self.rows, self.n, self.L, self.B, self.dev = rows, n, L, num_bins, dev
        # level growth: the leaves of depth d live in stores[d % 2]
        self.stores = None if spare is None else (rows, spare)
        self.level_work, self.level_window_fn = level_work, level_window_fn
        self.ids = torch.arange(L, device=dev)
        self.live_levels = torch.zeros((), dtype=i64, device=dev)
        self.scan, self.table, self.layout = scan, table, layout
        self.max_depth, self.qscale = max_depth, qscale
        self.window_fn, self.rebuild_fn = window_fn, rebuild_fn
        self.work = work
        self.sx = sx = _LeafScan(scan, comm, cegb, layout, qscale, num_bins,
                                 hist_features, packed, dev)
        self.cegb = cegb
        self.feat_used = None if cegb is None else cegb.used.clone()
        self.cmin = torch.full((L + 1,), -np.inf, dtype=f32, device=dev)
        self.cmax = torch.full((L + 1,), np.inf, dtype=f32, device=dev)
        hist0, sums, count0, ucnt0 = sx.root(rows, grad, hess, num_data,
                                             hist_fn)
        best0, fb0 = sx.best(hist0, sums[0], sums[1], count0, self.cmin[0],
                             self.cmax[0], self.feat_used, ucnt0)
        words = best0.cat_bitset.shape[-1]
        # no leaf but the root has a split until its best is cached
        self.best = torch.zeros((L + 1, _WORDS + words), dtype=f64,
                                device=dev)
        self.best[:, _B["gain"]] = K_MIN_SCORE
        self.best[0] = _pack_best(best0)
        self.pool = max(2, min(pool_slots, L)) if pool_slots > 0 else 0
        self.hist = torch.zeros((self.pool or L + 1,) + tuple(hist0.shape),
                                dtype=f32, device=dev)
        self.hist[0] = hist0
        if self.pool:
            self.slot_of = torch.full((L + 1,), -1, dtype=i64, device=dev)
            self.slot_of[0].fill_(0)
            self.stamps = torch.full((self.pool,), -1, dtype=i64, device=dev)
            self.stamps[0].fill_(0)
            self.misses = torch.zeros((), dtype=i64, device=dev)
        self.fbc = None
        if fb0 is not None:
            # the per-(leaf, feature) candidates (splits_per_leaf_)
            self.fbc = FeatureBest(*[
                torch.full((L + 1,) + x.shape,
                           K_MIN_SCORE if name == "gain" else 0,
                           dtype=x.dtype, device=dev)
                for name, x in zip(FeatureBest._fields, fb0)])
            for x, v in zip(self.fbc, fb0):
                x[0] = v
        self.forced = None
        if forced is not None:
            self.forced = tuple(a if isinstance(a, torch.Tensor) else
                                torch.as_tensor(np.asarray(a, np.int64),
                                                device=dev) for a in forced)
            self.force_on = torch.ones((), dtype=torch.bool, device=dev)
        self.node = torch.zeros((L + 1, _NODE_WORDS + words), dtype=f64,
                                device=dev)
        self.leaf = torch.zeros((L + 1, len(_LEAF)), dtype=f64, device=dev)
        self.leaf[:, _PARENT] = -1
        self.leaf[0, 1] = sums[1]           # the root's weight and count
        self.leaf[0, 2] = count0
        self.lsum = torch.zeros((L + 1, 2), dtype=f32, device=dev)
        self.lsum[0] = sums
        self.child = torch.zeros((L + 1, 2), dtype=i64, device=dev)
        self.win = torch.zeros((L + 1, 2), dtype=i64, device=dev)
        # fills, not copies of a host scalar: the whole tree can be captured
        # in a CUDA graph
        self.win[0, 1].fill_(n)
        # the scal row's bitset words past the scan's (a group histogram
        # may be wider than any feature's), and the feature window of a
        # feature-parallel rank (tree_learner.py:908-911)
        self.pad = torch.zeros(num_bins // 32 - words, dtype=i64, device=dev)
        self.fwin = (torch.full((1,), sx.f0, dtype=i64, device=dev)
                     if sx.mode == "feature" else None)
        self.k = torch.ones((), dtype=i64, device=dev)      # this step's kid
        self.leaves = torch.ones((), dtype=i64, device=dev)
        self.cont = torch.ones((), dtype=torch.bool, device=dev)
        self.pair = torch.arange(2, device=dev)
        if sx.lazy:
            # the store positions, the paid-bit bytes, the bits of a byte
            self.pos = torch.arange(n, device=dev)
            self.bytes = torch.arange(layout.bitbytes, device=dev)
            self.shifts = torch.arange(8, dtype=torch.uint8, device=dev)

    def _forced_best(self):
        """The k-th entry of the forced schedule (``forced_best``,
        tree_learner.py:662-690): its leaf [1], its split as a packed best
        row, and whether it applies (0-d bool): the scan of the leaf's
        cached histogram for its feature restricted to its threshold bin
        (no feature mask, ``feature_contri`` or CEGB penalty), valid while
        the schedule holds, inside the schedule, with a split and under
        ``max_depth``.  A failed entry switches the rest off."""
        sc = self.scan
        fl, ff, ft = self.forced
        S = fl.numel()
        k = self.k
        idx = torch.clamp(k - 1, max=S - 1).view(1)
        fleaf, ffeat, fthr = fl[idx], ff[idx], ft[idx]
        sg = self.lsum[fleaf][0, 0]
        sh = self.lsum[fleaf][0, 1]
        cnt = self.leaf[fleaf][0, 2].to(torch.float32)
        feat1 = FeatureInfo(*[None if a is None else a[ffeat]
                              for a in sc.feat])
        if sc.lanes is not None:
            hist = unpack_groups(self.hist[fleaf][0], feat1.group,
                                 tuple(x[ffeat] for x in sc.lanes), sg, sh)
        else:
            hist = self.hist[fleaf][0][ffeat]
        bounds = {}
        if sc.monotone:
            bounds = dict(cmin=self.cmin[fleaf][0], cmax=self.cmax[fleaf][0])
        tmask = torch.arange(hist.shape[-1], device=self.dev) == fthr
        fb = per_feature_best(hist, feat1,
                              torch.ones(1, dtype=torch.bool, device=self.dev),
                              sg, sh, cnt, sc.params, threshold_mask=tmask,
                              **bounds)
        best = reduce_feature_best(fb)._replace(feature=ffeat[0])
        in_sched = k <= S
        valid = in_sched & (best.gain > K_MIN_SCORE) & self.force_on
        if self.max_depth > 0:
            valid = valid & (self.leaf[fleaf][0, _DEPTH] < self.max_depth)
        self.force_on.copy_(self.force_on & (~in_sched | valid))
        return fleaf[0], _pack_best(best), valid

    def step(self, i: Optional[int] = None) -> None:
        """One split, or a dead step (tree_learner.py:852-1120).  Device
        indices are 1-element tensors: indexing with a 0-d CUDA tensor
        would read it back.  ``i``, the step's number (1 .. L - 1, what
        the device counter ``k`` holds), lets the host skip the forced
        entry past the schedule, where it cannot apply; None runs it
        (a step that serves any ``i``, as a captured graph replays it)."""
        L, sc, sx = self.L, self.scan, self.sx
        f32 = torch.float32
        gains = self.best[:L, _B["gain"]]
        if self.max_depth > 0:
            gains = torch.where(self.leaf[:L, _DEPTH] < self.max_depth,
                                gains, K_MIN_SCORE)
        gmax, leaf = gains.max(0)               # the first of the best
        ok = (gmax > 0.0) & self.cont
        b = self.best[leaf.view(1)][0]
        if self.forced is not None and (
                i is None or i <= self.forced[0].numel()):
            fleaf, fbest, fvalid = self._forced_best()
            leaf = torch.where(fvalid, fleaf, leaf)
            ok = torch.where(fvalid, self.cont, ok)
            b = torch.where(fvalid, fbest, b)
        self.cont.copy_(ok)
        k = self.k
        li = leaf.view(1)
        # the rows this step writes: the sink row L on a dead step
        kids = torch.where(ok, torch.stack([leaf, k]), L)
        node_w = torch.where(ok, k - 1, L).view(1)
        w = self.win[li][0] * ok                # (wb, wc); (0, 0) when dead
        left_smaller = b[_B["left_count"]] <= b[_B["right_count"]]
        fid = b[_B["feature"]].long().view(1)
        if sx.lazy:
            inw = (self.pos >= w[0]) & (self.pos < w[0] + w[1])
            self._pay(fid, inw)
        head = self.table[fid][0]
        words = b[_WORDS:].long()
        words = words - ((words >> 31) << 32)  # the int32 bit patterns
        parts = [w, head[2:3], b[2:4].long(), head[5:9],
                 left_smaller.long()[None], head[10:12], words, self.pad]
        if self.fwin is not None:
            parts.append(self.fwin)
        scal = torch.cat(parts).to(torch.int32)
        with _spans.step("split_pass"):
            hist_small, nl = self.window_fn(self.rows, scal, self.work,
                                            num_bins=self.B, **sx.hkw)
        # the smaller child is chosen from the replicated global counts, so
        # every rank streams the same child into the collective
        hist_small = sx.reduce(hist_small)
        if self.pool:
            parent, sl, sr = self._pool_parent(li, w, ok)
        else:
            parent = self.hist[li][0]
        hist_larger = parent - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_larger)
        hist_right = torch.where(left_smaller, hist_larger, hist_small)
        if self.pool:
            for slot, h in ((sl, hist_left), (sr, hist_right)):
                self.hist[slot] = torch.where(ok, h, self.hist[slot][0])[None]
        else:
            self.hist[kids] = torch.stack([hist_left, hist_right])
        nl = nl.reshape(()).long()
        ucnt = self._child_paid(inw, w, nl) if sx.lazy else None
        if self.cegb is not None:
            self._refund(fid, ok)

        bounds = (None, None)
        if sc.monotone:
            # tree_learner.py:984-997
            pmin, pmax = self.cmin[li], self.cmax[li]
            mono = sc.feat.monotone[fid]
            is_num = ~sc.feat.is_categorical[fid]
            out = b[_B["left_output"]:_B["right_output"] + 1].to(f32)
            mid = (out[0] + out[1]) * 0.5
            lo, hi = is_num & (mono < 0), is_num & (mono > 0)
            bounds = (torch.cat([torch.where(lo, torch.maximum(pmin, mid),
                                             pmin),
                                 torch.where(hi, torch.maximum(pmin, mid),
                                             pmin)]),
                      torch.cat([torch.where(hi, torch.minimum(pmax, mid),
                                             pmax),
                                 torch.where(lo, torch.minimum(pmax, mid),
                                             pmax)]))
            self.cmin[kids] = bounds[0]
            self.cmax[kids] = bounds[1]
        # (left, right) of the children's sums and counts
        sg, sh, cnt = (b[_B[f]:_B[f] + 4:3].to(f32)
                       for f in ("left_sum_grad", "left_sum_hess",
                                 "left_count"))
        child, child_fb = sx.best(torch.stack([hist_left, hist_right]), sg,
                                  sh, cnt, *bounds, self.feat_used, ucnt)
        self.best[kids] = _pack_best(child)
        if child_fb is not None:
            for x, v in zip(self.fbc, child_fb):
                x[kids] = v
        self.lsum[kids] = torch.stack([sg, sh], 1)

        # parent child-pointer fixup (tree.h:338-346)
        rec = self.leaf[li][0]
        par = rec[_PARENT].long().view(1)
        pidx = par.clamp(min=0)
        fix = ok & (par >= 0) & (self.child[pidx][0] == ~leaf)
        self.child[torch.where(fix, pidx, L), self.pair] = k - 1
        self.child[node_w] = torch.stack([~leaf, ~k])[None]
        icount = (b[_B["left_count"]].to(f32) + b[_B["right_count"]].to(f32))
        # the node: the split, the leaf's value and weight, the count
        self.node[node_w] = torch.cat([b[:_NODE_IV], rec[:2],
                                       icount.double()[None],
                                       b[_WORDS:]])[None]
        outs = torch.nan_to_num(b[_B["left_output"]:_B["right_output"] + 1]
                                .to(f32)).double()
        self.leaf[kids] = torch.stack([
            outs, sh.double(), cnt.double(), (k - 1).double().expand(2),
            (rec[_DEPTH] + 1).expand(2)], 1)
        # the left child keeps the parent's window start
        self.win[kids] = torch.stack([w[0], nl, w[0] + nl,
                                      w[1] - nl]).reshape(2, 2)
        self.leaves.add_(ok.long())
        self.k.add_(1)

    def _pool_parent(self, li, w, ok):
        """The histogram pool's part of a step (tree_learner.py:940-971):
        the parent's histogram from its slot, or rebuilt from its window
        (after the split pass it still holds exactly the parent's rows) by
        a launch on a window of count 0 when the slot holds it; the misses
        counted; the left child keeps the parent's slot (or the least
        recently used one on a miss), the right child evicts the next least
        recently used; the stamps and the leaves' slots updated where the
        step is live.  Returns (parent, left slot [1], right slot [1])."""
        ps = self.slot_of[li]
        hit = (ps >= 0)[0]
        win = torch.stack([w[0], w[1] * ~hit]).to(torch.int32)
        with _spans.step("split_pass"):
            rebuilt = self.rebuild_fn(self.rows, win, self.work,
                                      num_bins=self.B, **self.sx.hist_kw)
        rebuilt = self.sx.reduce(rebuilt)
        parent = torch.where(hit, self.hist[ps.clamp(min=0)][0], rebuilt)
        self.misses.add_((~hit & ok).long())
        sl = torch.where(hit, ps, torch.argmin(self.stamps).view(1))
        sr = torch.argmin(self.stamps.index_fill(0, sl, 2 ** 30)).view(1)
        stamps = self.stamps.clone()
        stamps[sl] = self.k
        stamps[sr] = self.k
        self.stamps.copy_(torch.where(ok, stamps, self.stamps))
        slot_of = torch.where((self.slot_of == sl) | (self.slot_of == sr),
                              -1, self.slot_of)
        slot_of[li] = sl
        slot_of[self.k.view(1)] = sr
        self.slot_of.copy_(torch.where(ok, slot_of, self.slot_of))
        return parent, sl, sr

    def _pay(self, fid, inw) -> None:
        """Lazy CEGB: every row of the split leaf's window (the positions
        ``inw`` [n] bool) pays feature ``fid``'s cost, its bit set in the
        store before the split pass moves the rows (tree_learner.py:
        728-735)."""
        lo, nb = self.layout.bitoff, self.layout.bitbytes
        byte = torch.where(self.bytes == fid // 8,
                           (torch.ones_like(fid) << (fid % 8)), 0).to(
                               torch.uint8)                      # [nb]
        self.rows[:self.n, lo:lo + nb].bitwise_or_(
            inw[:, None].to(torch.uint8) * byte)

    def _child_paid(self, inw, w, nl) -> torch.Tensor:
        """[2, F] f32: the rows of each child (after the split pass) that
        paid each feature, summed over the ranks (tree_learner.py:749-756,
        :932-934).  The sums are one f32 product of the children's 0/1
        row masks with the rows' 0/1 bits, exact below 2**24 rows, taken
        as int32 as the host loop sums them."""
        n, lo = self.n, self.layout.bitoff
        inl = inw & (self.pos < w[0] + nl)
        masks = torch.stack([inl, inw & ~inl]).to(torch.float32)  # [2, n]
        bits = (self.rows[:n, lo:lo + self.layout.bitbytes, None]
                >> self.shifts) & 1                               # [n, nb, 8]
        paid = bits.reshape(n, -1)[:, :self.sx.num_features]
        counts = torch.mm(masks, paid.to(torch.float32))
        return self.sx.psum_rows(counts.to(torch.int32)).to(torch.float32)

    def _refund(self, fid, ok) -> None:
        """The first use of feature ``fid`` in this training: its coupled
        penalty refunded in every leaf's cached candidate for it, and a
        leaf whose refunded candidate beats its cached best takes it
        (UpdateLeafBestSplits, tree_learner.py:1000-1054), as masked
        writes; then ``fid`` counts as used."""
        fbc = self.fbc
        newly = ok & ~self.feat_used[fid][0]
        col = fbc.gain[:, fid]
        fbc.gain[:, fid] = torch.where(newly, col + self.cegb.coupled[fid],
                                       col)
        cand = _pack_best(BestSplit(
            feature=fid.expand(fbc.gain.shape[0]),
            **{name: getattr(fbc, name)[:, fid][:, 0]
               for name in FeatureBest._fields}))
        old = self.best[:, _B["gain"]]
        promote = newly & (old > K_MIN_SCORE) & (cand[:, _B["gain"]] > old)
        self.best.copy_(torch.where(promote[:, None], cand, self.best))
        self.feat_used.copy_(self.feat_used | (
            (torch.arange(self.feat_used.numel(), device=self.dev) == fid)
            & ok))

    def level_step(self, d: int, fcap: int) -> None:
        """One level (``level_step``, tree_learner.py:1122-1309): every
        depth-``d`` leaf with a positive gain splits, in ascending id order,
        as far as the leaf budget allows, through one level pass from store
        d % 2 into store 1 - d % 2.  The frontier is compacted on the device
        into ``fcap`` slots (a cumsum rank, then a scatter into fcap + 1
        slots whose last takes every leaf past them); a slot past the
        frontier or the budget is dead: its window is (0, 0), the pass moves
        no row for it, and each of its writes goes to the sink row L.  The
        bookkeeping is the host loop's in its order, over the slots: the
        subtraction, the monotone bounds, both children's batched scan, the
        parent child-pointer fix-up (siblings fix one parent through its two
        slots), the node, leaf and window records."""
        L, sc, sx, dev = self.L, self.scan, self.sx, self.dev
        f32 = torch.float32
        gains = self.best[:L, _B["gain"]]
        mask = ((self.leaf[:L, _DEPTH] == d) & (self.ids < self.leaves)
                & (gains > 0.0))
        rank = torch.cumsum(mask.long(), 0) - 1
        found = torch.full((fcap + 1,), L, dtype=torch.int64, device=dev)
        found.scatter_(0, torch.where(mask & (rank < fcap), rank, fcap),
                       self.ids)
        found = found[:fcap]
        r = self.ids[:fcap]
        active = (found < L) & (r < L - self.leaves)
        lsafe = found.clamp(max=L - 1)
        leaf = torch.where(active, found, L)
        kid = torch.where(active, self.leaves + r, L)
        node = torch.where(active, self.leaves - 1 + r, L)
        b = self.best[lsafe]                            # [fcap, 12 + words]
        w = self.win[lsafe] * active[:, None]           # (wb, wc); dead: 0
        left_smaller = b[:, _B["left_count"]] <= b[:, _B["right_count"]]
        fid = b[:, _B["feature"]].long()
        head = self.table[fid]
        words = b[:, _WORDS:].long()
        words = words - ((words >> 31) << 32)  # the int32 bit patterns
        scal = torch.cat([w, head[:, 2:3], b[:, 2:4].long(), head[:, 5:9],
                          left_smaller.long()[:, None], head[:, 10:12], words,
                          self.pad[None].expand(fcap, -1)], 1).to(torch.int32)
        with _spans.step("split_pass"):
            hist_small, nl = self.level_window_fn(
                self.stores[d % 2], self.stores[1 - d % 2], scal,
                self.level_work, num_bins=self.B, **sx.hkw)
        hist_small = sx.reduce(hist_small)
        parent = self.hist[lsafe]
        hist_larger = parent - hist_small
        ls = left_smaller[:, None, None, None]
        hist_left = torch.where(ls, hist_small, hist_larger)
        hist_right = torch.where(ls, hist_larger, hist_small)
        self.hist[leaf] = hist_left
        self.hist[kid] = hist_right

        bounds = (None, None)
        if sc.monotone:
            # tree_learner.py:1220-1230
            pmin, pmax = self.cmin[lsafe], self.cmax[lsafe]
            mono = sc.feat.monotone[fid]
            is_num = ~sc.feat.is_categorical[fid]
            out = b[:, _B["left_output"]:_B["right_output"] + 1].to(f32)
            mid = (out[:, 0] + out[:, 1]) * 0.5
            lo, hi = is_num & (mono < 0), is_num & (mono > 0)
            lmin = torch.where(lo, torch.maximum(pmin, mid), pmin)
            lmax = torch.where(hi, torch.minimum(pmax, mid), pmax)
            rmin = torch.where(hi, torch.maximum(pmin, mid), pmin)
            rmax = torch.where(lo, torch.minimum(pmax, mid), pmax)
            self.cmin[leaf], self.cmax[leaf] = lmin, lmax
            self.cmin[kid], self.cmax[kid] = rmin, rmax
            bounds = (torch.cat([lmin, rmin]), torch.cat([lmax, rmax]))
        # [left children, right children] of the sums and counts
        sg, sh, cnt = (torch.cat([b[:, _B["left_" + f]],
                                  b[:, _B["right_" + f]]]).to(f32)
                       for f in ("sum_grad", "sum_hess", "count"))
        child, _ = sx.best(torch.cat([hist_left, hist_right]), sg, sh, cnt,
                           *bounds)
        packed = _pack_best(child)
        self.best[leaf] = packed[:fcap]
        self.best[kid] = packed[fcap:]
        self.lsum[leaf] = torch.stack([sg[:fcap], sh[:fcap]], 1)
        self.lsum[kid] = torch.stack([sg[fcap:], sh[fcap:]], 1)

        # parent child-pointer fixup (tree_learner.py:1247-1260)
        rec = self.leaf[lsafe]
        par = rec[:, _PARENT].long()
        pidx = par.clamp(min=0)
        upd = (active & (par >= 0))[:, None] & (self.child[pidx]
                                                == ~lsafe[:, None])
        self.child[torch.where(upd[:, 0], pidx, L), 0] = node
        self.child[torch.where(upd[:, 1], pidx, L), 1] = node
        self.child[node] = torch.stack([~lsafe, ~kid], 1)
        icount = (b[:, _B["left_count"]].to(f32)
                  + b[:, _B["right_count"]].to(f32))
        self.node[node] = torch.cat([b[:, :_NODE_IV], rec[:, :2],
                                     icount.double()[:, None],
                                     b[:, _WORDS:]], 1)
        outs = torch.nan_to_num(b[:, _B["left_output"]:_B["right_output"] + 1]
                                .to(f32)).double()
        depth = rec[:, _DEPTH] + 1
        for i, rows_of in enumerate((leaf, kid)):
            half = slice(i * fcap, (i + 1) * fcap)
            self.leaf[rows_of] = torch.stack([
                outs[:, i], sh[half].double(), cnt[half].double(),
                node.double(), depth], 1)
        nl = nl.long()
        # the left child keeps the parent's window start
        self.win[leaf] = torch.stack([w[:, 0], nl], 1)
        self.win[kid] = torch.stack([w[:, 0] + nl, w[:, 1] - nl], 1)
        nact = active.sum()
        self.leaves.add_(nact)
        self.live_levels.add_((nact > 0).long())

    def grow(self) -> None:
        """The tree's L - 1 steps (each a split pass), dead ones included;
        in level growth its ``level_count`` level steps (each a level
        pass), dead ones included, as the JAX schedule unrolls them
        (tree_learner.py:1311-1324)."""
        if self.stores is not None:
            if self.L > 1:
                for d in range(level_count(self.L, self.max_depth)):
                    self.level_step(d, level_slots(self.L, d))
            return
        for i in range(1, self.L):
            self.step(i)

    def finish(self, carried: bool = False, score_rate=None):
        """The grown tree: the per-row leaf from the window marks and a
        forward fill over the store positions (tree_learner.py:1328-1336),
        and with ``carried`` the score column plus each window's leaf value
        times ``score_rate`` instead (:1337-1351; a tree that did not split
        adds nothing).  Lazy CEGB's paid bits come back in original row
        order.  In level growth a leaf's rows lie in the store of its
        depth's parity: each position's order bytes are read from that
        store, and with ``carried`` the odd-depth windows are first copied
        into store 0 (the store returned, the next tree's;
        :meth:`_Growth.fill_scores`).  Then the tree arrays, the pool's
        misses and the levels that split, packed into one record that stays
        on the device.  Returns the :class:`DeviceTree` (``row_leaf`` empty
        when ``carried``), and the store with ``carried``."""
        n, L, dev, layout = self.n, self.L, self.dev, self.layout
        begin, count = self.win[:L, 0], self.win[:L, 1]
        marks = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        marks[torch.where(count > 0, begin, n)] = torch.arange(
            1, L + 1, device=dev)
        marks = marks[:n]
        pos = torch.arange(n, device=dev)
        last = torch.cummax(torch.where(marks > 0, pos, 0), 0).values
        leaf_of_pos = marks[last] - 1
        odd = None
        if self.stores is not None:
            odd = self.leaf[leaf_of_pos, _DEPTH] % 2 == 1
        paid = None
        if carried:
            if odd is not None:
                self.rows[:n] = torch.where(odd[:, None], self.stores[1][:n],
                                            self.rows[:n])
            lv = (self.leaf[:L, 0].to(torch.float32)
                  * float(np.float32(score_rate)))
            store_f32(self.rows, layout.soff, n).add_(torch.where(
                self.leaves > 1, lv[leaf_of_pos], -0.0))
            row_leaf = torch.zeros(0, dtype=torch.int64, device=dev)
        else:
            order = store_order(self.rows, layout, n)
            if odd is not None:
                order = torch.where(odd, store_order(self.stores[1], layout,
                                                     n), order)
            row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
            row_leaf[order] = leaf_of_pos
            if self.sx.lazy:
                lo = layout.bitoff
                paid = torch.empty((n, layout.bitbytes), dtype=torch.uint8,
                                   device=dev)
                paid[order] = self.rows[:n, lo:lo + layout.bitbytes]
        misses = (self.misses if self.pool
                  else torch.zeros((), dtype=torch.int64, device=dev))
        # the packed record, left on the device: read back by
        # DeviceTree.resolve (the tree's one device->host transfer) or with
        # the other pending trees in one transfer by the booster
        record = torch.cat([self.node[:L].reshape(-1),
                            self.leaf[:L].reshape(-1),
                            self.child[:L].double().reshape(-1),
                            torch.stack([self.leaves, misses,
                                         self.live_levels]).double()])
        tree = DeviceTree(record, L, row_leaf, paid,
                          (level_count(L, self.max_depth)
                           if self.stores is not None else L - 1)
                          if L > 1 else 0)
        return (tree, self.rows) if carried else tree


class DeviceTree:
    """A tree of the device build before it is read back (the port's
    counterpart of the JAX build's device ``TreeArrays`` and of
    ``_LazyTreeSlice``, gbdt.py:174-190): the packed record
    :meth:`_DeviceGrowth.finish` writes, [R] f64 on the device (per node
    gain, feature, threshold, default_left, internal value, weight, count
    and the bitset words; per leaf ``_LEAF``; the children; then the
    leaves, the pool's misses and the levels that split), ``num_leaves``
    (a 0-d view into it), ``row_leaf`` (empty for a tree of the carried
    store), lazy CEGB's ``paid_bits`` and the static ``split_passes``.
    Nothing here reads the card: :meth:`resolve` decodes the host
    :class:`TreeArrays` from a host copy of the record, fetching it itself
    when none is given."""

    __slots__ = ("record", "L", "row_leaf", "paid_bits", "split_passes")
    # the one transfer that reads the tree back (TreeArrays.host_fetches):
    # resolve's, or the booster's materialization, which reads every
    # pending tree's record in one transfer
    host_fetches = 1

    def __init__(self, record: torch.Tensor, L: int,
                 row_leaf: Optional[torch.Tensor],
                 paid_bits: Optional[torch.Tensor],
                 split_passes: int) -> None:
        self.record = record
        self.L = L
        self.row_leaf = row_leaf
        self.paid_bits = paid_bits
        self.split_passes = split_passes

    @classmethod
    def from_arrays(cls, a: TreeArrays, device) -> "DeviceTree":
        """A host-loop tree in the device build's record (every field is an
        f32, i32, bool or 32-bit word, so f64 holds it exactly), sent to
        ``device`` without a wait: the booster's asynchronous loop takes a
        tree of either build."""
        f64 = np.float64
        nodes = np.concatenate([
            np.stack([a.split_gain, a.split_feature, a.threshold_bin,
                      a.default_left, a.internal_value, a.internal_weight,
                      a.internal_count], 1).astype(f64),
            np.asarray(a.cat_bitset, f64)], 1)
        leaves = np.stack([a.leaf_value, a.leaf_weight, a.leaf_count,
                           a.leaf_parent, a.leaf_depth], 1).astype(f64)
        child = np.stack([a.left_child, a.right_child], 1).astype(f64)
        record = np.concatenate([nodes.ravel(), leaves.ravel(), child.ravel(),
                                 [a.num_leaves, a.pool_misses, a.levels]])
        return cls(to_device_async(record, device), len(a.leaf_value),
                   a.row_leaf, a.paid_bits, a.split_passes)

    @property
    def num_leaves(self) -> torch.Tensor:
        """The tree's leaf count, a 0-d f64 device tensor."""
        return self.record[-3]

    def _node_width(self) -> int:
        return (self.record.numel() - 3) // self.L - len(_LEAF) - 2

    def leaf_value(self) -> torch.Tensor:
        """[L] f32 leaf values on the device (the host decode's
        ``leaf_value``: the same f64 -> f32 rounding)."""
        L, nw = self.L, self._node_width()
        return self.record[L * nw:L * (nw + len(_LEAF))].view(
            L, len(_LEAF))[:, 0].to(torch.float32)

    def split_features(self) -> torch.Tensor:
        """[L] i64 split features on the device (node i valid for i <
        num_leaves - 1)."""
        return self.record[:self.L * self._node_width()].view(
            self.L, -1)[:, 1].long()

    def resolve(self, host: Optional[np.ndarray] = None) -> TreeArrays:
        """The host :class:`TreeArrays` of ``host``, a host copy of
        ``record`` (fetched here when None; ``host_fetches`` = 1)."""
        if host is None:
            host = self.record.cpu().numpy()
        L = self.L
        nodes, rest = np.split(host, [L * self._node_width()])
        nodes = nodes.reshape(L, -1)
        leaves = rest[:L * len(_LEAF)].reshape(L, -1)
        child = rest[L * len(_LEAF):-3].reshape(L, 2)
        f32, i32 = np.float32, np.int32
        return TreeArrays(
            split_feature=nodes[:, 1].astype(i32),
            threshold_bin=nodes[:, 2].astype(i32),
            split_gain=nodes[:, 0].astype(f32),
            default_left=nodes[:, 3] != 0,
            left_child=child[:, 0].astype(i32),
            right_child=child[:, 1].astype(i32),
            internal_value=nodes[:, 4].astype(f32),
            internal_weight=nodes[:, 5].astype(f32),
            internal_count=nodes[:, 6].astype(f32),
            leaf_value=leaves[:, 0].astype(f32),
            leaf_weight=leaves[:, 1].astype(f32),
            leaf_count=leaves[:, 2].astype(f32),
            leaf_parent=leaves[:, 3].astype(i32),
            leaf_depth=leaves[:, 4].astype(i32),
            cat_bitset=nodes[:, _NODE_WORDS:].astype(np.int64),
            num_leaves=int(host[-3]), row_leaf=self.row_leaf,
            host_fetches=1, levels=int(host[-1]), pool_misses=int(host[-2]),
            paid_bits=self.paid_bits, split_passes=self.split_passes)


def grows_on_device(grow_mode: str) -> bool:
    """Whether :func:`build_tree_partitioned` grows the tree on the device
    (:class:`_DeviceGrowth`): every leaf-wise build, with forced splits,
    CEGB, the histogram pool or a parallel learner's comm or without, and
    every level-wise build."""
    return grow_mode in ("leaf", "level")


def build_tree_partitioned(rows: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, num_data: int,
                           feature_mask: torch.Tensor, feat: FeatureInfo,
                           feat_host: dict, *, num_leaves: int,
                           max_depth: int, params: SplitParams, num_bins: int,
                           layout: RowLayout, hist_features: int,
                           packed: bool, grow_mode: str = "leaf",
                           qscale: Optional[torch.Tensor] = None,
                           hist_fn=histogram_rows, part_fn=partition_hist,
                           level_fn=partition_hist_level,
                           spare: Optional[torch.Tensor] = None,
                           categorical: bool = False, monotone: bool = False,
                           lanes: Optional[tuple] = None,
                           forced: Optional[tuple] = None,
                           cegb: Optional[CegbState] = None,
                           pool_slots: int = 0,
                           comm: Optional[Comm] = None,
                           carried: bool = False, score_rate=None,
                           window_fn=partition_hist_window,
                           table: Optional[torch.Tensor] = None,
                           work=None, host_loop: bool = False,
                           rebuild_fn=histogram_rows_window,
                           level_window_fn=partition_hist_level_window,
                           level_work=None, lazy: bool = False):
    """Grow one tree; ``rows`` is the filled row store (it is partitioned in
    place on the card).  ``num_data`` is the in-bag count, an int or a
    device scalar (read back with the root's sums).  Level growth also
    writes ``spare``, a second store of ``rows``' shape whose contents do
    not matter (required there, unused leaf-wise).  ``feat_host`` holds
    the per-feature ``num_bin``, ``missing_type``, ``default_bin``,
    ``is_cat`` and ``monotone`` as numpy for the scal rows and the
    bookkeeping, and ``group``/``offset`` (None when every feature has its
    own column).

    ``grow_mode`` "leaf" splits the best leaf per step; "level" splits a
    whole depth per step (one level-batched split pass and one batched split
    scan per level) and never falls back to leaf-wise growth.  Leaf-wise
    growth also takes ``forced`` (the schedule of
    ``SerialTreeLearner._load_forced_splits``: leaf, feature and threshold
    bin arrays), ``cegb`` (:class:`CegbState`; with lazy penalties ``rows``
    must have the layout's bit bytes) and ``pool_slots`` (histogram pool
    slots, 0 for one cache row per leaf); level growth refuses them.
    ``qscale`` (hist_precision=quantized) holds the iteration's (s_g, s_h):
    grad/hess and the row store then carry the quantized integers and every
    histogram is dequantized before it is cached.  ``categorical``, ``monotone``
    and ``lanes`` set up the split scan (:class:`SplitScan`).
    ``hist_fn``/``part_fn``/``level_fn`` default to the kernel dispatchers;
    a check may pass the plain versions to rebuild the same tree without the
    kernels.  ``comm`` (:class:`Comm`) grows the tree of one rank of a
    parallel learner, leaf-wise, from its rows ``rows`` (``num_data`` is the
    global count); forced splits and CEGB need the ``psum`` mode, whose
    ranks hold whole histograms.

    ``carried`` (the fused chunk's carried row store, tree_learner.py:
    311-318, :1337-1351): ``layout`` is a carried layout and ``rows`` holds
    the objective's aux and the running score, which the split passes move
    with their rows.  After the tree the score column takes the leaf values
    times ``score_rate`` (:meth:`_Growth.fill_scores`), and the call returns
    (the tree with an empty ``row_leaf``, the store holding every row);
    otherwise it returns the tree alone.  Serial growth only, without lazy
    CEGB.

    Which build runs: every tree grows on the device (:class:`_DeviceGrowth`,
    the JAX build's loop and level schedule), with forced splits, CEGB, the
    pool and a comm as without.  Leaf-wise: L - 1 steps that read nothing
    back, the split passes through ``window_fn``
    (:func:`partition_hist_window` or a plain version) on ``work``
    (:func:`window_workspace` for the store, sized for the split pass's
    histogram columns; None on the CPU), the pool's rebuilt parents through
    ``rebuild_fn`` (:func:`histogram_rows_window` or its plain version) on
    the same ``work``.  Level-wise: the root, then ``level_count`` level
    steps that read nothing back (dead ones included), each one level pass
    through ``level_window_fn`` (:func:`partition_hist_level_window` or its
    plain version) on ``level_work`` (:func:`level_workspace`; None on the
    CPU) from one store into the other.  Both gather the scal rows from
    ``table`` (the device form of :func:`scal_table`) and read the tree back
    once, or with ``lazy`` not at all: the call then returns the
    :class:`DeviceTree` in place of the TreeArrays.  With ``host_loop`` the
    tree grows in the host loop
    (:class:`_Growth`: one read-back a split, ``part_fn``, or a level,
    ``level_fn``): for checks only, which rebuild a device-built tree with
    it.
    """
    if carried and (comm is not None or not layout.carried
                    or (cegb is not None and cegb.lazy is not None)):
        raise ValueError("carried growth needs the serial learner, a carried "
                         "layout and no lazy CEGB")
    if comm is not None:
        if comm.mode not in COMM_MODES:
            raise ValueError("unknown comm mode %r (%s)"
                             % (comm.mode, ", ".join(COMM_MODES)))
        if grow_mode != "leaf":
            raise ValueError("parallel learners grow leaf-wise only")
        if comm.mode != "psum" and (forced is not None or cegb is not None
                                    or lanes is not None):
            raise ValueError("forced splits, CEGB and EFB groups need the "
                             "psum comm mode")
    if grow_mode == "level" and spare is None:
        raise ValueError("level growth needs a second row store (spare)")
    if grow_mode == "level" and (forced is not None or cegb is not None
                                 or pool_slots > 0):
        raise ValueError("forced splits, CEGB and the histogram pool grow "
                         "leaf-wise only")
    if pool_slots > 0 and (forced is not None or cegb is not None):
        raise ValueError("the histogram pool needs the per-leaf cache off: "
                         "forced splits and CEGB read every leaf's "
                         "histogram (tree_learner.py:826-828)")
    scan = SplitScan(feat, feature_mask, params, categorical, monotone,
                     contri_scale(params, feature_mask.device), lanes)
    if not host_loop and grows_on_device(grow_mode):
        level = grow_mode == "level"
        if table is None or (rows.is_cuda
                             and (level_work if level else work) is None):
            raise ValueError("the device build needs the learner's scal "
                             "table and, on the card, its split-pass "
                             "workspace")
        g = _DeviceGrowth(rows, grad, hess, num_data, scan, table,
                          num_leaves=num_leaves, max_depth=max_depth,
                          num_bins=num_bins, layout=layout,
                          hist_features=hist_features, packed=packed,
                          qscale=qscale, hist_fn=hist_fn, window_fn=window_fn,
                          work=work, rebuild_fn=rebuild_fn, forced=forced,
                          cegb=cegb, pool_slots=pool_slots, comm=comm,
                          spare=spare if level else None,
                          level_work=level_work,
                          level_window_fn=level_window_fn)
        g.grow()
        with _spans.span("tree_finish"):
            out = g.finish(carried, score_rate)
        if lazy:
            return out
        if carried:
            return out[0].resolve(), out[1]
        return out.resolve()
    g = _Growth(rows, grad, hess, num_data, scan, feat_host,
                num_leaves=num_leaves, num_bins=num_bins, layout=layout,
                hist_features=hist_features, packed=packed, qscale=qscale,
                hist_fn=hist_fn, part_fn=part_fn, level_fn=level_fn,
                spare=spare, forced=forced, cegb=cegb, pool_slots=pool_slots,
                comm=comm)
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
    if carried:
        return g.arrays(carried=True), g.fill_scores(score_rate)
    return g.arrays()


def route_binned(bins: torch.Tensor, tree: TreeArrays,
                 feat_host: dict) -> torch.Tensor:
    """Leaf of every binned row [N, C]: Tree::GetLeaf over bins, one level
    per step (``route_binned``, tree_learner.py:1474-1510).  On a bundled
    dataset C counts group columns: a node reads its feature's group column
    and unfolds it (``_unfold_bin``, :111-117); a categorical node sends the
    bins of its bitset left (``_route_left``, :125-150)."""
    n = bins.shape[0]
    dev = bins.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    m = tree.num_leaves - 1
    sf = tree.split_feature[:m].astype(np.int64)
    t = lambda a: to_device_async(np.asarray(a), dev)  # noqa: E731
    thr = t(tree.threshold_bin[:m].astype(np.int64))
    dl = t(tree.default_left[:m])
    lc = t(tree.left_child[:m].astype(np.int64))
    rc = t(tree.right_child[:m].astype(np.int64))
    mt = t(np.asarray(feat_host["missing_type"], np.int64)[sf])
    nb = t(np.asarray(feat_host["num_bin"], np.int64)[sf])
    dbin = t(np.asarray(feat_host["default_bin"], np.int64)[sf])
    is_cat = t(np.asarray(feat_host["is_cat"], bool)[sf])
    grouped = feat_host["group"] is not None
    col_d = t(np.asarray(feat_host["group"], np.int64)[sf] if grouped else sf)
    off = t(np.asarray(feat_host["offset"], np.int64)[sf] if grouped
            else np.ones(m, np.int64))
    words = t(np.asarray(tree.cat_bitset[:m], np.int64))       # [M, W]
    W = words.shape[1]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    rows_i = torch.arange(n, device=dev)
    for _ in range(int(tree.leaf_depth[:tree.num_leaves].max())):
        nd = torch.clamp(node, min=0)
        col = bins[rows_i, col_d[nd]].long()
        if grouped:
            o, k = off[nd], nb[nd]
            col = torch.where((col >= o) & (col <= o + k - 2), col - o + 1,
                              torch.zeros_like(col))
        miss = torch.where(mt[nd] == int(MissingType.NAN), col == nb[nd] - 1,
                           (mt[nd] == int(MissingType.ZERO))
                           & (col == dbin[nd]))
        go_left = torch.where(miss, dl[nd], col <= thr[nd])
        if W:
            word = words[nd, torch.clamp(col >> 5, max=W - 1)]
            cat_left = ((word >> (col & 31)) & 1) == 1
            go_left = torch.where(is_cat[nd], cat_left, go_left)
        nxt = torch.where(go_left, lc[nd], rc[nd])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def tree_output_binned(bins: torch.Tensor, tree: TreeArrays,
                       feat_host: dict) -> torch.Tensor:
    """Per-row leaf VALUE (f32) of ``tree`` over binned rows."""
    lv = torch.as_tensor(tree.leaf_value, device=bins.device)
    return lv[route_binned(bins, tree, feat_host)]


def feature_bins(dataset: BinnedDataset) -> int:
    """The per-feature scan width: the bins of the widest feature, padded to
    a power of two (at least 32, so that a bitset is whole words)."""
    return pad_bins_pow2(dataset.max_num_bin)


def arrays_from_tree(tree: Tree, dataset: BinnedDataset) -> TreeArrays:
    """A host tree as routable TreeArrays over ``dataset``'s bins (the
    counterpart of ``GBDT._tree_to_device``, gbdt.py:482-534): bin
    thresholds recomputed from the real thresholds (a parsed model text
    carries only those), and each categorical node's category bitset mapped
    to a bin bitset through the feature's ``categorical_2_bin``
    (:501-516), so a loaded tree routes the binned rows as its trained form
    did.  Leaf values in f32."""
    nl = int(tree.num_leaves)
    ni = max(nl - 1, 0)
    inner = np.zeros(ni, np.int32)
    thr = np.zeros(ni, np.int32)
    bits = np.zeros((ni, feature_bins(dataset) // 32), np.int64)
    for node in range(ni):
        f = int(tree.split_feature[node])
        m = dataset.bin_mappers[f]
        inner[node] = dataset.inner_feature_map[f]
        if int(tree.decision_type[node]) & 1:
            ci = int(tree.threshold[node])
            lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            for w in range(lo, hi):
                word = int(tree.cat_threshold[w])
                for j in range(32):
                    b = m.categorical_2_bin.get((w - lo) * 32 + j)
                    if (word >> j) & 1 and b is not None:
                        bits[node, b >> 5] |= 1 << (b & 31)
        else:
            thr[node] = m.value_to_bin(float(tree.threshold[node]))
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
        cat_bitset=bits, num_leaves=nl, row_leaf=None)


def tree_from_arrays(arrays: TreeArrays, dataset: BinnedDataset,
                     shrinkage: float = 1.0) -> Tree:
    """Convert tree arrays to a host :class:`Tree` with real thresholds
    (bin thresholds -> values through the BinMappers, Dataset::RealThreshold;
    a categorical node's bin bitset -> its category-value bitset,
    tree_learner.py:1972-2025)."""
    a = arrays
    nl = int(a.num_leaves)
    t = Tree(max_leaves=max(nl, 1))
    t.num_leaves = nl
    ni = max(nl - 1, 0)
    mappers = [dataset.bin_mappers[i] for i in dataset.used_feature_idx]
    for node in range(ni):
        inner = int(a.split_feature[node])
        m = mappers[inner]
        is_cat = m.bin_type == BinType.CATEGORICAL
        t.split_feature_inner[node] = inner
        t.split_feature[node] = dataset.used_feature_idx[inner]
        if is_cat:
            # tree.h:83 SplitCategorical; Common::ConstructBitset
            words = np.asarray(a.cat_bitset[node], np.int64)
            bins_set = [b for b in range(words.size * 32)
                        if (int(words[b >> 5]) >> (b & 31)) & 1]
            cats = sorted(int(m.bin_2_categorical[b]) for b in bins_set
                          if b < len(m.bin_2_categorical))
            nw_in = max(bins_set, default=0) // 32 + 1
            t.cat_boundaries_inner.append(t.cat_boundaries_inner[-1] + nw_in)
            t.cat_threshold_inner.extend(int(words[w]) for w in range(nw_in))
            cwords = [0] * (max(cats, default=0) // 32 + 1)
            for c in cats:
                cwords[c >> 5] |= 1 << (c & 31)
            t.threshold_in_bin[node] = t.num_cat
            t.threshold[node] = float(t.num_cat)
            t.cat_boundaries.append(t.cat_boundaries[-1] + len(cwords))
            t.cat_threshold.extend(cwords)
            t.num_cat += 1
        else:
            t.threshold_in_bin[node] = int(a.threshold_bin[node])
            t.threshold[node] = m.bin_to_value(int(a.threshold_bin[node]))
        t.decision_type[node] = Tree.make_decision_type(
            is_cat, bool(a.default_left[node]), int(m.missing_type))
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


class SerialTreeLearner:
    """Owns the device row-store template and per-feature metadata and grows
    one tree per :meth:`train` call.  The ``tree_learner`` key is not read
    here (the JAX class ignores it too): ``parallel.create_tree_learner``
    chooses the learner.  The parallel learners subclass this one through
    the hooks ``_store_matrix``, ``_local_rows``, ``_row_ids`` and
    ``_gather_rows``, and ``comm``."""

    # the parallel learners that shard the scan over features take one
    # column per feature: no EFB groups, no 4-bit packing
    supports_groups = True
    supports_packing = True
    comm: Optional[Comm] = None

    def __init__(self, dataset: BinnedDataset, config,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.dataset = dataset
        self.config = config
        self.num_leaves = int(config.num_leaves)
        self.max_depth = int(config.max_depth)
        self.tree_grow_mode = str(getattr(config, "tree_grow_mode", "leaf")
                                  or "leaf")
        self._grow_mode_warned = False
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
            min_gain_to_split=float(config.min_gain_to_split),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            cat_l2=float(config.cat_l2),
            cat_smooth=float(config.cat_smooth),
            max_cat_threshold=int(config.max_cat_threshold),
            min_data_per_group=int(config.min_data_per_group),
            extra_trees=bool(config.extra_trees),
            extra_seed=int(config.extra_seed),
            feature_contri=self._map_feature_contri(config, dataset))
        self.num_data = dataset.num_data
        dev = self.device
        # monotone_constraints in ORIGINAL feature order -> used features
        mono_cfg = list(getattr(config, "monotone_constraints", []) or [])
        mono = np.zeros(dataset.num_features, dtype=np.int64)
        for j, orig in enumerate(dataset.used_feature_idx):
            if orig < len(mono_cfg):
                mono[j] = int(mono_cfg[orig])
        is_cat = np.asarray(dataset.feature_is_categorical(), bool)
        self.has_categorical = bool(is_cat.any())
        self.has_monotone = bool((mono != 0).any())
        # on a bundled dataset the row store, the histograms and their cache
        # are over group columns; the split scan runs per feature
        self.grouped = bool(dataset.is_bundled and self.supports_groups)
        self.feat_bins = feature_bins(dataset)
        self.num_bins = (pad_bins_pow2(dataset.max_group_bin) if self.grouped
                         else self.feat_bins)
        self.feat_host = {
            "num_bin": np.asarray(dataset.num_bin_per_feature, np.int64),
            "missing_type": np.asarray(dataset.missing_types(), np.int64),
            "default_bin": np.asarray(dataset.default_bins(), np.int64),
            "is_cat": is_cat, "monotone": mono,
            "group": (np.asarray(dataset.group_idx, np.int64)
                      if self.grouped else None),
            "offset": (np.asarray(dataset.bin_offset, np.int64)
                       if self.grouped else None)}
        t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
            a, device=dev)
        fh = self.feat_host
        self.feat = FeatureInfo(
            num_bin=t(fh["num_bin"]), missing_type=t(fh["missing_type"]),
            default_bin=t(fh["default_bin"]), is_categorical=t(is_cat),
            monotone=t(mono), group=t(fh["group"]), offset=t(fh["offset"]))
        self.lanes = (unpack_lanes(dataset, self.num_bins, self.feat_bins,
                                   dev) if self.grouped else None)
        # the device build's per-feature scal entries (scal_table)
        self.scal_table = torch.as_tensor(scal_table(self.feat_host),
                                          device=dev)
        # its split pass's buffers (window_workspace) and, in level growth,
        # its level pass's (level_workspace), kept between trees
        self._window_work = None
        self._level_work = None
        matrix = self._route_matrix(dataset)
        self.num_columns = matrix.shape[1]
        # this process's rows and columns of the row store
        matrix = self._store_matrix(matrix)
        self.hist_columns = matrix.shape[1]
        # 4-bit packing (dense_nbits_bin.hpp): two columns per byte
        self.packed = bool(self.supports_packing
                           and dataset.max_group_bin <= 16
                           and matrix.shape[1] > 1)
        if self.packed:
            m = np.asarray(matrix, dtype=np.uint8)
            if m.shape[1] % 2:
                m = np.concatenate([m, np.zeros((m.shape[0], 1), np.uint8)], 1)
            bins_u8 = (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)
            bpc = 1
        else:
            bins_u8 = bin_bytes(matrix)
            bpc = 2 if matrix.dtype == np.uint16 else 1
        self.forced = self._load_forced_splits(config, dataset)
        self.cegb = self._init_cegb(config, dataset, dev)
        lazy = self.cegb is not None and self.cegb[2] is not None
        F = dataset.num_features
        self.layout = row_layout(bins_u8.shape[1] // bpc, bpc,
                                 -(-F // 8) if lazy else 0)
        # the fused chunk's store: the same bytes plus the aux and score
        # columns (None with lazy CEGB, which the chunk never runs)
        self.carried_layout = (None if lazy else row_layout(
            bins_u8.shape[1] // bpc, bpc, carried=True))
        self.template = row_store_template(bins_u8, self.layout, dev)
        # the dispatch plan every tree of this learner runs under
        # (plan/state.py: pinned > tuned > analytic), resolved once here as
        # tree_learner.py:1755-1770 of the JAX package resolves it
        sc = self.plan_shape()
        self.plan = _plan_state.resolve(
            sc.n_rows, sc.num_features, sc.num_bins, bpc=sc.bpc,
            packed=sc.packed, num_class=sc.num_class,
            device_kind=sc.device_kind, quantized=sc.quantized)
        # level growth's second row store, made at its first tree
        self.spare: Optional[torch.Tensor] = None
        # histogram_pool_size MB -> LRU slots (0: one cache row per leaf)
        pool_mb = float(getattr(config, "histogram_pool_size", -1.0))
        self.hist_pool_slots = 0
        if pool_mb > 0 and (self.forced is not None or self.cegb is not None):
            Log.warning("histogram_pool_size is ignored with forced splits "
                        "or CEGB (their candidate caches need every leaf's "
                        "histogram resident); histogram memory is unbounded")
        elif pool_mb > 0:
            self.hist_pool_slots = pool_slot_count(pool_mb, self.hist_columns,
                                                   self.num_bins)
        # CEGB state kept for the whole training: the features split on
        # (is_feature_used_in_split_) and, for lazy penalties, every
        # (row, feature)'s paid bit in original row order
        # (feature_used_in_data_)
        self.cegb_used = (torch.zeros(F, dtype=torch.bool, device=dev)
                          if self.cegb is not None else None)
        self._forced_dev = None
        self.cegb_paid = (torch.zeros((self.num_data, self.layout.bitbytes),
                                      dtype=torch.uint8, device=dev)
                          if lazy else None)

    @staticmethod
    def _map_feature_contri(config, dataset: BinnedDataset) -> tuple:
        """``feature_contri`` (ORIGINAL feature order, config.h:432-436) ->
        a tuple over the used features, () when unset
        (tree_learner.py:1654-1665)."""
        contri = list(getattr(config, "feature_contri", []) or [])
        if not contri:
            return ()
        out = [1.0] * dataset.num_features
        for j, orig in enumerate(dataset.used_feature_idx):
            if orig < len(contri):
                out[j] = float(contri[orig])
        return tuple(out)

    def _load_forced_splits(self, config, dataset: BinnedDataset):
        """The BFS schedule of ``forcedsplits_filename``
        (tree_learner.py:1666-1704; serial_tree_learner.cpp:458
        ForceSplits): (leaf, inner feature, threshold bin) i32 arrays, the
        k-th entry the k-th split; a right child's leaf is the id its split
        creates.  A missing file gives a warning and no schedule; a
        categorical or unused feature drops the rest of the schedule with a
        warning."""
        fname = str(getattr(config, "forcedsplits_filename", "") or "")
        if not fname:
            return None
        if not os.path.exists(fname):
            Log.warning("Forced splits file %s does not exist", fname)
            return None
        with open(fname) as fh:
            spec = json.load(fh)
        sched = []
        queue = [(spec, 0)]
        while queue and len(sched) < self.num_leaves - 1:
            node, leaf = queue.pop(0)
            orig = int(node.get("feature", -1))
            inner = dataset.inner_feature_map.get(orig)
            if inner is None or \
                    dataset.bin_mappers[orig].bin_type == BinType.CATEGORICAL:
                Log.warning("Forced split on unusable feature %d; dropping "
                            "the rest of the forced-splits schedule", orig)
                break
            thr_bin = int(dataset.bin_mappers[orig].values_to_bins(
                np.asarray([float(node["threshold"])]))[0])
            step = len(sched) + 1
            sched.append((leaf, inner, thr_bin))
            if "left" in node:
                queue.append((node["left"], leaf))
            if "right" in node:
                queue.append((node["right"], step))
        if not sched:
            return None
        arr = np.asarray(sched, dtype=np.int32)
        return arr[:, 0], arr[:, 1], arr[:, 2]

    @staticmethod
    def _init_cegb(config, dataset: BinnedDataset, device):
        """(tradeoff * penalty_split [f32 scalar], tradeoff * coupled [F],
        tradeoff * lazy [F] or None) over the used features when CEGB is on
        (tree_learner.py:1706-1732, cost_effective_gradient_boosting.hpp:
        25-31 IsEnable), else None.  The per-feature lists are in original
        feature order and must cover every feature."""
        tr = float(config.cegb_tradeoff)
        ps = float(config.cegb_penalty_split)
        coupled_cfg = list(config.cegb_penalty_feature_coupled or [])
        lazy_cfg = list(config.cegb_penalty_feature_lazy or [])
        if ps <= 0.0 and not any(coupled_cfg) and not any(lazy_cfg):
            return None
        if coupled_cfg and len(coupled_cfg) != dataset.num_total_features:
            Log.fatal("cegb_penalty_feature_coupled should be the same size "
                      "as feature number.")
        if lazy_cfg and len(lazy_cfg) != dataset.num_total_features:
            Log.fatal("cegb_penalty_feature_lazy should be the same size "
                      "as feature number.")
        coupled = np.zeros(dataset.num_features, dtype=np.float32)
        lazy = np.zeros(dataset.num_features, dtype=np.float32)
        for j, orig in enumerate(dataset.used_feature_idx):
            if orig < len(coupled_cfg):
                coupled[j] = tr * float(coupled_cfg[orig])
            if orig < len(lazy_cfg):
                lazy[j] = tr * float(lazy_cfg[orig])
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return (t(np.float32(tr * ps)), t(coupled),
                t(lazy) if lazy.any() else None)

    def _route_matrix(self, dataset: BinnedDataset) -> np.ndarray:
        """The binned columns the learner routes by: the group columns when
        it takes EFB groups, else one column per feature."""
        if self.grouped or not dataset.is_bundled:
            return dataset.binned
        return dataset.unbundled_matrix()

    def _store_matrix(self, matrix: np.ndarray) -> np.ndarray:
        """The rows and columns of ``matrix`` this learner's row store
        holds: all of them (a parallel learner keeps its rank's stripe and
        pads the features)."""
        return matrix

    def _local_rows(self, t: Optional[torch.Tensor]):
        """This learner's rows of a per-row tensor [N, ...]: all of them."""
        return t

    def _row_ids(self, n: int) -> torch.Tensor:
        """Global ids of the row store's ``n`` rows (the quantization hash's
        key)."""
        return torch.arange(n, device=self.device)

    def _gather_rows(self, t: Optional[torch.Tensor]):
        """A per-row result of this learner's rows -> over all N rows."""
        return t

    def _padded_feature_mask(self, mask: torch.Tensor) -> torch.Tensor:
        return mask

    def effective_grow_mode(self) -> str:
        """The growth mode the builds run (tree_learner.py:1780-1808):
        ``level`` unless a parallel learner's comm, forced splits, CEGB or
        the histogram pool are on, which grow leaf-wise, with one
        warning."""
        if self.tree_grow_mode != "level":
            return "leaf"
        blockers = [name for name, on in (
            ("parallel tree learner", self.comm is not None),
            ("forced splits", self.forced is not None),
            ("CEGB", self.cegb is not None),
            ("histogram_pool_size", self.hist_pool_slots > 0)) if on]
        if not blockers:
            return "level"
        if not self._grow_mode_warned:
            Log.warning("tree_grow_mode=level unavailable (%s); growing "
                        "leaf-wise", "; ".join(blockers))
            self._grow_mode_warned = True
        return "leaf"

    def restore_cegb_state(self, used, paid) -> None:
        """Restore CEGB's state from a checkpoint: the features split on
        ([F] bool) and the lazy paid bits ([num_data, bitbytes] u8 in
        original row order; a JAX checkpoint's padded rows are cut), which
        the next tree writes into its row store."""
        if self.cegb_used is not None and used is not None:
            self.cegb_used = torch.as_tensor(np.array(used, dtype=bool),
                                             device=self.cegb_used.device)
        if self.cegb_paid is not None and paid is not None:
            paid = np.array(np.asarray(paid, dtype=np.uint8)
                            [:self.num_data, :self.cegb_paid.shape[1]])
            self.cegb_paid = torch.as_tensor(paid,
                                             device=self.cegb_paid.device)

    def valid_bins(self, dataset: BinnedDataset) -> torch.Tensor:
        """Binned matrix [N, C] of a validation set (binned with the training
        set's mappers and groups, ``reference=``) on the learner's device,
        for :func:`route_binned` (the JAX learner's ``valid_bins``): its
        group columns on a bundled dataset."""
        bins = self._route_matrix(dataset)
        if bins.shape[1] != self.num_columns:
            raise ValueError("validation set has %d bin columns, the training "
                             "set %d: bin it with reference= the training set"
                             % (bins.shape[1], self.num_columns))
        bins = np.ascontiguousarray(bins)
        if bins.dtype == np.uint16:
            bins = bins.astype(np.int32)
        return torch.from_numpy(bins).to(self.device)

    def plan_shape(self):
        """The kernel planner's shape class of this learner (``plan``):
        its rows, features, kernel bins, row-store packing, classes, card
        and precision."""
        from ..plan.planner import shape_class
        return shape_class(
            self.num_data, int(self.dataset.num_features),
            int(self.num_bins), bpc=self.layout.bpc, packed=self.packed,
            num_class=int(getattr(self.config, "num_class", 1) or 1),
            device_kind=current_device_kind(self.device),
            quantized=self.quantized)

    def row_layout(self, carried: bool = False) -> RowLayout:
        """The byte layout of this learner's row store, or of the fused
        chunk's carried store (``row_layout``, tree_learner.py:1938-1947),
        for the chunk's consumers."""
        return self.carried_layout if carried else self.layout

    def level_count(self) -> int:
        """Level steps of a tree_grow_mode=level build (its schedule)."""
        return level_count(self.num_leaves, self.max_depth)

    def grows_on_device(self) -> bool:
        """Whether this learner's trees grow on the device
        (:func:`grows_on_device` of its growth mode)."""
        return grows_on_device(self.effective_grow_mode())

    def level_classes(self) -> int:
        """Launches a level makes (tree_learner.py:1828-1832): 1.  The
        JAX package launches one kernel a bucket class of its level's
        windows; the port's level pass takes every window of a level in
        one launch, whatever its size."""
        return 1

    def launches_per_tree(self) -> int:
        """Split-pass launches one tree makes at most: levels x classes in
        level mode (whatever the window sizes), L - 1 leaf-wise, exactly
        so in the device build (tree_learner.py:1834-1848)."""
        if self.effective_grow_mode() == "level":
            return self.level_count() * self.level_classes()
        return self.num_leaves - 1

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              num_data_in_bag,
              feature_mask: Optional[torch.Tensor] = None, iteration: int = 0,
              hist_fn=histogram_rows, part_fn=partition_hist,
              level_fn=partition_hist_level, *, carried: bool = False,
              rows_carry: Optional[torch.Tensor] = None, extra=None,
              score_rate=None, window_fn=partition_hist_window,
              host_loop: bool = False, rebuild_fn=histogram_rows_window,
              level_window_fn=partition_hist_level_window,
              lazy: bool = False):
        """grad/hess: [N] f32 on the learner's device.  ``num_data_in_bag``
        is an int or a device scalar.  ``iteration`` keys the quantized
        path's rounding hash (ignored when exact);
        ``hist_fn``/``part_fn``/``level_fn``/``window_fn``/``rebuild_fn``/
        ``level_window_fn`` and ``host_loop`` (checks only) as in
        :func:`build_tree_partitioned`.  Level growth's second row store
        (``spare``) is made at the first level tree and kept.
        With CEGB, the features this tree splits on (and the lazy paid
        bits) carry over to the next call.

        ``carried`` grows on the fused chunk's carried store
        (:meth:`row_layout` ``(carried=True)``; gbdt.py:814-925): with
        ``extra`` = (aux, score), [N] f32 in original row order, the store
        is built from the template (a chunk's first tree); with
        ``rows_carry``, the store the previous tree returned, grad/hess come
        in its permuted row order and only their bytes are rewritten, and
        the quantization hash takes each row's id from the order bytes
        (tree_learner.py:342-347).  Returns (the tree with an empty
        ``row_leaf``, the store after the score fill with ``score_rate``);
        otherwise the tree.

        The tree is host :class:`TreeArrays` after one fetch, or with
        ``lazy`` (the booster's asynchronous loop) the device build's
        :class:`DeviceTree`, nothing read back (a host-loop tree packed
        into one).  The telemetry span reads nothing: its
        ``launches`` and, level-wise, ``levels`` are the static schedule
        (tree_learner.py:1878-1882), and CEGB's used features are updated
        on the device from the tree's record."""
        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features, dtype=torch.bool,
                                      device=self.device)
        feature_mask = self._padded_feature_mask(feature_mask)
        grad, hess = self._local_rows(grad), self._local_rows(hess)
        if carried and (self.carried_layout is None or self.comm is not None
                        or (rows_carry is None) == (extra is None)):
            raise ValueError("carried training needs the serial learner "
                             "without lazy CEGB and one of rows_carry or "
                             "extra")
        layout = self.carried_layout if carried else self.layout
        qscale = None
        if self.quantized:
            # striped ranks quantize with the scales over every rank
            striped = self.comm is not None and self.comm.mode != "feature"
            n = grad.shape[0]
            ids = (store_order(rows_carry, layout, n)
                   if rows_carry is not None else self._row_ids(n))
            with _spans.span("objective"):
                grad, hess, qscale = quantize_gradients(
                    grad, hess, ids, int(iteration),
                    self.quant_seed, self.comm.ops if striped else None)
        if rows_carry is not None:
            rows = rows_carry
            refresh_gradients(rows, layout, grad, hess)
        elif carried:
            rows = carried_store(self.template, self.layout, layout, grad,
                                 hess, *extra)
        else:
            rows = fill_gradients(self.template, self.layout, grad, hess)
        grow_mode = self.effective_grow_mode()
        if grow_mode == "level" and (self.spare is None
                                     or self.spare.shape != rows.shape):
            self.spare = torch.empty_like(rows)
        on_device = not host_loop and self.grows_on_device()
        cegb = None
        if self.cegb is not None:
            # the host loop (checks only) takes the used features as numpy
            cegb = CegbState(*self.cegb, self.cegb_used if on_device
                             else self.cegb_used.cpu().numpy(),
                             self._local_rows(self.cegb_paid))
        with _spans.span("tree_build", timer="TreeLearner::Train",
                         mode=grow_mode) as sp, \
                _plan_state.dispatching(self.plan):
            arrays = self._build(rows, grad, hess, num_data_in_bag,
                                 feature_mask, grow_mode, qscale, hist_fn,
                                 part_fn, level_fn, cegb, layout, carried,
                                 score_rate, window_fn, host_loop,
                                 rebuild_fn, level_window_fn)
            if carried:
                arrays, rows = arrays
            # split passes this tree dispatched (obs/launches.py): L - 1 in
            # the device build, level_count in its level growth, one a split
            # or a level in the host loop (a host-known count either way)
            passes = arrays.split_passes
            if isinstance(sp, _spans.Span):
                sp.fields["launches"] = int(passes)
                if grow_mode == "level":
                    sp.fields.update(levels=self.level_count(),
                                     classes=self.level_classes())
        _launches.record(grow_mode, passes)
        tele = _telemetry_active()
        if tele is not None:
            # which plan the tree dispatched under (gbdt.py:1130-1139 of
            # the JAX package), once a run per (site, key, provenance)
            _plan_state.stamp(tele, "tree_build", self.plan.provenance,
                              key="n%d_b%d" % (int(self.num_data),
                                               int(self.num_bins)),
                              mode=grow_mode)
        if isinstance(arrays, DeviceTree):
            arrays.row_leaf = self._gather_rows(arrays.row_leaf)
            arrays.paid_bits = self._gather_rows(arrays.paid_bits)
        else:
            arrays = arrays._replace(
                row_leaf=self._gather_rows(arrays.row_leaf),
                paid_bits=self._gather_rows(arrays.paid_bits))
        if cegb is not None:
            # tree_learner.py:1930-1937 _update_cegb_used, and the paid bits
            self._update_cegb_used(arrays)
            if arrays.paid_bits is not None:
                self.cegb_paid = arrays.paid_bits
        if not lazy and isinstance(arrays, DeviceTree):
            arrays = arrays.resolve()
        elif lazy and not isinstance(arrays, DeviceTree):
            arrays = DeviceTree.from_arrays(arrays, self.device)
        return (arrays, rows) if carried else arrays

    def _update_cegb_used(self, tree) -> None:
        """Mark the features ``tree`` split on in ``cegb_used`` ([F] bool
        on the device): from the record of a :class:`DeviceTree`, the
        nodes past its leaf count sent to a sink column."""
        used = self.cegb_used
        F = used.shape[0]
        if isinstance(tree, DeviceTree):
            if tree.L < 2:
                return
            feats = tree.split_features()[:tree.L - 1]
            live = (torch.arange(tree.L - 1, device=used.device)
                    < tree.num_leaves.long() - 1)
            flags = torch.zeros(F + 1, dtype=torch.bool, device=used.device)
            flags[torch.where(live, feats, F)] = True
            used |= flags[:F]
            return
        nl = int(tree.num_leaves)
        if nl > 1:
            used[torch.as_tensor(tree.split_feature[:nl - 1].astype(np.int64),
                                 device=used.device)] = True

    def _build(self, rows, grad, hess, num_data_in_bag, feature_mask,
               grow_mode, qscale, hist_fn, part_fn, level_fn, cegb,
               layout, carried, score_rate, window_fn=partition_hist_window,
               host_loop=False, rebuild_fn=histogram_rows_window,
               level_window_fn=partition_hist_level_window):
        if not isinstance(num_data_in_bag, torch.Tensor):
            num_data_in_bag = int(num_data_in_bag)
        # the device build's buffers, made only for a tree that uses them
        on_device = not host_loop and self.grows_on_device()
        forced = self.forced
        if on_device and forced is not None:
            if self._forced_dev is None:
                # the schedule on the device once, not a copy a tree
                self._forced_dev = tuple(
                    torch.as_tensor(np.asarray(a, np.int64),
                                    device=self.device) for a in forced)
            forced = self._forced_dev
        level = grow_mode == "level"
        n = grad.shape[0]
        return build_tree_partitioned(
            rows, grad, hess, num_data_in_bag, feature_mask, self.feat,
            self.feat_host, num_leaves=self.num_leaves,
            max_depth=self.max_depth, params=self.params,
            num_bins=self.num_bins, layout=layout,
            hist_features=self.hist_columns, packed=self.packed,
            grow_mode=grow_mode, qscale=qscale, hist_fn=hist_fn,
            part_fn=part_fn, level_fn=level_fn, spare=self.spare,
            categorical=self.has_categorical, monotone=self.has_monotone,
            lanes=self.lanes, forced=forced, cegb=cegb,
            pool_slots=self.hist_pool_slots, comm=self.comm, carried=carried,
            score_rate=score_rate, window_fn=window_fn,
            table=self.scal_table if on_device else None,
            work=(self.window_work(rows, n) if on_device and not level
                  else None),
            host_loop=host_loop, rebuild_fn=rebuild_fn,
            level_window_fn=level_window_fn,
            level_work=self.level_work(rows, n) if on_device and level
            else None, lazy=True)

    def pass_columns(self) -> int:
        """The histogram columns of this learner's split passes: every
        column of its store (a feature-parallel rank's F/d block, its
        feature window)."""
        return self.hist_columns

    def window_work(self, rows: torch.Tensor, bound: int):
        """The device build's split-pass buffers for windows of up to
        ``bound`` rows of ``rows`` (:func:`window_workspace` over
        :meth:`pass_columns`), which the pool's rebuilds share; made once
        and kept while the store's width, the plan's tile and the
        precision stay; None on the CPU."""
        if not rows.is_cuda:
            return None
        w = self._window_work
        W = rows.shape[1]
        if (w is None or w.bound != bound or w.scratch.shape[1] != W
                or w.quantized != self.quantized
                or w.scratch.device != rows.device
                or w.tile != part_tile_rows(W)):
            w = self._window_work = window_workspace(
                rows, bound, num_features=self.pass_columns(),
                num_bins=self.num_bins, quantized=self.quantized)
        return w

    def level_work(self, rows: torch.Tensor, bound: int):
        """The device build's level-pass buffers for the frontiers of this
        learner's level trees (:func:`level_workspace` for windows of up to
        ``bound`` rows in all, sized for the last level's slots,
        ``level_slots``; a shallower level launches on a part of them);
        made at the first level tree and kept while the store's width, the
        plan's tile and integer fill and the precision stay; None on the
        CPU."""
        if not rows.is_cuda:
            return None
        G = max(level_slots(self.num_leaves, d)
                for d in range(self.level_count()))
        w = self._level_work
        W = rows.shape[1]
        if (w is None or w.n != bound or w.G != G or w.W != W
                or w.quantized != self.quantized
                or w.maps.device != rows.device
                or w.tile != part_tile_rows(W)
                or w.fill != _plan_state.int_fill_blocks()):
            self._level_work = None
            w = self._level_work = level_workspace(
                bound, G, W, self.hist_columns, self.num_bins,
                self.quantized, device=rows.device)
        return w
