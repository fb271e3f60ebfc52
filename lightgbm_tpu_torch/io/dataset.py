"""Copied from ``lightgbm_tpu/io/dataset.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ, and the per-feature
binning of the rows runs on a thread pool (each feature's bins are
independent of the others', so they are the same bytes).

Binned feature matrix resident in device (TPU HBM) memory.

Counterpart of the reference ``Dataset`` (include/LightGBM/dataset.h:330-713,
src/io/dataset.cpp) and the in-memory construction path
``DatasetLoader::CostructFromSampleData`` (src/io/dataset_loader.cpp:572):
sample rows -> per-feature ``BinMapper.find_bin`` -> bulk binning -> one
``[num_data, num_used_features]`` integer matrix.

TPU-first departures from the reference layout:
- No per-feature polymorphic ``Bin`` storage (dense/sparse/4-bit): the learner
  consumes one dense row-major matrix, the layout XLA/Pallas histogram kernels want.
  Sparsity is exploited by bin width (uint8 for <=256 bins) rather than by format.
- Feature bundling (EFB, dataset.cpp:92-290 FindGroups/FastFeatureBundling) is a
  host-side grouping: the device matrix has one column per *group*; group code 0
  means "every bundled feature at its default bin" and feature ``f`` owns codes
  ``[offset_f, offset_f + num_bin_f - 2]`` for its bins ``1..num_bin_f-1``.
  Per-feature histograms are recovered by lane slicing + the FixHistogram
  subtraction (dataset.h:501: default-bin stats = leaf totals - the rest).
  Unbundled features are singleton groups with offset 1, which makes the
  group code equal to the bin — the ungrouped layout is the special case.
- Trivial features (single bin) are dropped from the device matrix and re-inserted
  at prediction time by index mapping, like the reference's used-feature mapping.
"""
from __future__ import annotations

import io
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from . import sample as _sample
from .binning import BinMapper, BinType, MissingType
from .metadata import Metadata
from ..utils.log import Log


def _per_feature(fn: Callable[[int], Any], indices: Sequence[int]) -> list:
    """``[fn(i) for i in indices]`` on a thread pool: numpy's searchsorted
    releases the GIL, so binning 400,000 rows of 200 features runs ~7x
    faster on 8 cores."""
    workers = min(8, os.cpu_count() or 1, max(1, len(indices)))
    if workers == 1:
        return [fn(i) for i in indices]
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, indices))


class BinnedDataset:
    """Host handle for the binned matrix + metadata; device transfer is lazy."""

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_idx: List[int] = []   # original index per used column
        self.inner_feature_map: Dict[int, int] = {}  # original -> used column
        self.binned: Optional[np.ndarray] = None     # [num_data, num_used] uint8/16
        self.num_bin_per_feature: List[int] = []     # per used column
        self.metadata: Metadata = Metadata(0)
        self.feature_names: List[str] = []
        self.raw_data: Optional[np.ndarray] = None   # kept for prediction paths
        # EFB bundling (identity when every group is a singleton)
        self.feature_groups: List[List[int]] = []    # used-col indices per group
        self.group_idx: Optional[np.ndarray] = None  # [F_used] -> group column
        self.bin_offset: Optional[np.ndarray] = None  # [F_used] first group code
        self.num_bin_per_group: List[int] = []
        # (binned, {device: tensor}) of device_view
        self._device_cache = None

    # ---- construction ----

    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None, weight=None, group=None,
                    init_score=None, max_bin: int = 255, min_data_in_bin: int = 3,
                    min_data_in_leaf: int = 20, bin_construct_sample_cnt: int = 200000,
                    categorical_feature: Sequence[int] = (), use_missing: bool = True,
                    zero_as_missing: bool = False, data_random_seed: int = 1,
                    feature_names: Optional[Sequence[str]] = None,
                    forced_bins: Optional[Dict[int, List[float]]] = None,
                    max_bin_by_feature: Optional[Sequence[int]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    keep_raw: bool = True,
                    enable_bundle: bool = True,
                    bin_mappers: Optional[List[BinMapper]] = None
                    ) -> "BinnedDataset":
        data = np.ascontiguousarray(data, dtype=np.float64)
        if data.ndim != 2:
            Log.fatal("Input data must be 2-dimensional")
        self = cls()
        self.num_data, self.num_total_features = data.shape
        if max_bin_by_feature:
            # dataset_loader.cpp:581-586 CHECK_EQ semantics
            if len(max_bin_by_feature) != self.num_total_features:
                Log.fatal("Size of max_bin_by_feature (%d) does not match the "
                          "number of features (%d)", len(max_bin_by_feature),
                          self.num_total_features)
            if min(max_bin_by_feature) < 2:
                Log.fatal("Each entry of max_bin_by_feature must be at least 2")
        self.metadata = Metadata(self.num_data)
        if label is not None:
            self.metadata.set_label(label)
        if weight is not None:
            self.metadata.set_weights(weight)
        if group is not None:
            self.metadata.set_group(group)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        self.feature_names = (list(feature_names) if feature_names is not None
                              else ["Column_%d" % i for i in range(self.num_total_features)])

        schema_adopted = False
        if reference is not None:
            # validation data reuses the training bin mappers
            # (dataset_loader.cpp:230 LoadFromFileAlignWithOtherDataset)
            if reference.num_total_features != self.num_total_features:
                Log.fatal("Validation data has %d features, train data has %d",
                          self.num_total_features, reference.num_total_features)
            self.bin_mappers = reference.bin_mappers
            self.feature_names = reference.feature_names
        elif bin_mappers is not None:
            # injected (e.g. distributed bin finding's allgather-merged set,
            # dataset_loader.cpp:1028)
            if len(bin_mappers) != self.num_total_features:
                Log.fatal("Got %d bin mappers for %d features",
                          len(bin_mappers), self.num_total_features)
            self.bin_mappers = list(bin_mappers)
        else:
            # the round-21 shared schema path: the SAME deterministic sample
            # + freeze the streaming loader uses, so an in-memory load and a
            # chunked/sharded load of identical rows agree byte-for-byte
            idx, keys = _sample.bottom_k_indices(
                self.num_data, bin_construct_sample_cnt, data_random_seed)
            self._adopt_schema(cls.schema_from_sample(
                data[idx], keys, max_bin=max_bin,
                min_data_in_bin=min_data_in_bin,
                min_data_in_leaf=min_data_in_leaf,
                categorical_feature=categorical_feature,
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                feature_names=self.feature_names, forced_bins=forced_bins,
                max_bin_by_feature=max_bin_by_feature,
                enable_bundle=enable_bundle))
            schema_adopted = True

        if not schema_adopted:
            self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                     if not m.is_trivial]
            self.inner_feature_map = {f: j for j, f
                                      in enumerate(self.used_feature_idx)}
            self.num_bin_per_feature = [self.bin_mappers[i].num_bin
                                        for i in self.used_feature_idx]
        col_dtype = (np.uint8 if max(self.num_bin_per_feature, default=2) <= 256
                     else np.uint16)
        cols = _per_feature(
            lambda i: self.bin_mappers[i].values_to_bins(data[:, i])
            .astype(col_dtype), self.used_feature_idx)
        if reference is not None:
            self.feature_groups = [list(g) for g in reference.feature_groups]
            self.group_idx = reference.group_idx
            self.bin_offset = reference.bin_offset
            self.num_bin_per_group = list(reference.num_bin_per_group)
        elif not schema_adopted:
            self.feature_groups = (self._find_groups_from_cols(cols)
                                   if enable_bundle
                                   else [[j] for j in range(len(cols))])
            self._assign_group_layout()
        self.binned = self._bundle_columns(cols)
        if keep_raw:
            self.raw_data = data
        return self

    @classmethod
    def schema_from_sample(cls, sample: np.ndarray,
                           sample_keys: Optional[np.ndarray] = None, *,
                           max_bin: int = 255, min_data_in_bin: int = 3,
                           min_data_in_leaf: int = 20,
                           categorical_feature: Sequence[int] = (),
                           use_missing: bool = True,
                           zero_as_missing: bool = False,
                           feature_names: Optional[Sequence[str]] = None,
                           forced_bins: Optional[Dict[int, List[float]]] = None,
                           max_bin_by_feature: Optional[Sequence[int]] = None,
                           enable_bundle: bool = True) -> "BinnedDataset":
        """Freeze the full dataset *schema* — BinMappers, used-feature set,
        EFB groups, group layout — from the bin-construct sample ALONE
        (``CostructFromSampleData`` minus the bulk binning): the returned
        dataset has zero rows and exists to be adopted by a constructor
        that then materializes the store (``from_matrix``, the streaming
        loader's pass 2, or every rank of a pod after the sample
        allgather).  ``sample`` must be the index-ascending winners of the
        :mod:`sample` hash-priority draw and ``sample_keys`` their aligned
        keys (None = natural order, i.e. the sample IS the whole data),
        so the EFB conflict scan's 64Ki sub-sample is deterministic too."""
        sample = np.ascontiguousarray(sample, dtype=np.float64)
        if sample.ndim != 2:
            Log.fatal("Bin-construct sample must be 2-dimensional")
        self = cls()
        self.num_data = 0
        self.num_total_features = sample.shape[1]
        self.metadata = Metadata(0)
        self.feature_names = (list(feature_names)
                              if feature_names is not None
                              else ["Column_%d" % i
                                    for i in range(sample.shape[1])])
        if max_bin_by_feature:
            if len(max_bin_by_feature) != self.num_total_features:
                Log.fatal("Size of max_bin_by_feature (%d) does not match "
                          "the number of features (%d)",
                          len(max_bin_by_feature), self.num_total_features)
            if min(max_bin_by_feature) < 2:
                Log.fatal("Each entry of max_bin_by_feature must be at least 2")
        total = len(sample)
        cat = set(int(c) for c in categorical_feature)
        self.bin_mappers = []
        columns = np.ascontiguousarray(sample.T)   # a column a feature
        for f in range(self.num_total_features):
            col = columns[f]
            # sparse sampling contract: pass non-zero (plus NaN) values only,
            # zeros are implied by total_sample_cnt (dataset_loader.cpp:819)
            nz = col[(col != 0.0) | np.isnan(col)]
            m = BinMapper()
            fmax = (int(max_bin_by_feature[f]) if max_bin_by_feature
                    else int(max_bin))
            m.find_bin(nz, total, fmax, min_data_in_bin,
                       min_split_data=min_data_in_leaf,
                       bin_type=(BinType.CATEGORICAL if f in cat
                                 else BinType.NUMERICAL),
                       use_missing=use_missing,
                       zero_as_missing=zero_as_missing,
                       forced_upper_bounds=(forced_bins or {}).get(f))
            if m.is_trivial:
                Log.debug("Feature %s is trivial (constant or filtered)",
                          self.feature_names[f] if self.feature_names
                          else str(f))
            self.bin_mappers.append(m)
        self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                 if not m.is_trivial]
        self.inner_feature_map = {f: j for j, f
                                  in enumerate(self.used_feature_idx)}
        self.num_bin_per_feature = [self.bin_mappers[i].num_bin
                                    for i in self.used_feature_idx]
        if enable_bundle and len(self.used_feature_idx) > 1:
            eff = min(total, self._EFB_SAMPLE)
            pos = (_sample.efb_positions(sample_keys, eff)
                   if sample_keys is not None else np.arange(eff))
            active = [np.asarray(self.bin_mappers[i].values_to_bins(
                          sample[pos, i]) != 0)
                      for i in self.used_feature_idx]
            self.feature_groups = self._find_groups(active)
        else:
            self.feature_groups = [[j] for j in
                                   range(len(self.used_feature_idx))]
        self._assign_group_layout()
        self.binned = self._bundle_columns([], num_rows=0)
        return self

    def _adopt_schema(self, schema: "BinnedDataset") -> None:
        """Take another dataset's frozen schema (mappers, used features,
        EFB layout, names) — the receiving constructor only materializes
        rows.  ``reference=`` datasets qualify as schemas too."""
        self.bin_mappers = schema.bin_mappers
        self.feature_names = list(schema.feature_names)
        self.used_feature_idx = list(schema.used_feature_idx)
        self.inner_feature_map = dict(schema.inner_feature_map)
        self.num_bin_per_feature = list(schema.num_bin_per_feature)
        self.feature_groups = [list(g) for g in schema.feature_groups]
        self.group_idx = schema.group_idx
        self.bin_offset = schema.bin_offset
        self.num_bin_per_group = list(schema.num_bin_per_group)

    @classmethod
    def from_row_chunks(cls, chunks_factory: Callable[[], Iterable[np.ndarray]],
                        label=None, weight=None, group=None, init_score=None,
                        max_bin: int = 255, min_data_in_bin: int = 3,
                        min_data_in_leaf: int = 20,
                        bin_construct_sample_cnt: int = 200000,
                        categorical_feature: Sequence[int] = (),
                        use_missing: bool = True,
                        zero_as_missing: bool = False,
                        data_random_seed: int = 1,
                        feature_names: Optional[Sequence[str]] = None,
                        forced_bins: Optional[Dict[int, List[float]]] = None,
                        max_bin_by_feature: Optional[Sequence[int]] = None,
                        reference: Optional["BinnedDataset"] = None,
                        enable_bundle: bool = True) -> "BinnedDataset":
        """Two-pass streaming construction from re-iterable ``[m, F]`` raw
        chunks: pass 1 runs the hash-priority sampler over the chunks and
        freezes the schema (byte-identical to ``from_matrix`` over the
        concatenated rows, by sample determinism); pass 2 re-iterates,
        binning + bundling each chunk straight into the preallocated
        store.  Peak memory is O(chunk + sample + binned store) — the raw
        f64 matrix never exists.  ``chunks_factory`` is called once per
        pass and must yield the same rows both times."""
        smp = _sample.RowSampler(bin_construct_sample_cnt, data_random_seed)
        num_cols = None
        base = 0
        for part in chunks_factory():
            part = np.ascontiguousarray(part, dtype=np.float64)
            if part.ndim != 2:
                Log.fatal("Row chunks must be 2-dimensional")
            if num_cols is None:
                num_cols = part.shape[1]
            elif part.shape[1] != num_cols:
                Log.fatal("Row chunk has %d columns, expected %d",
                          part.shape[1], num_cols)
            smp.observe(np.arange(base, base + len(part), dtype=np.int64),
                        part)
            base += len(part)
        n = base
        _, keys, sample = smp.result()
        if sample is None:
            sample = np.zeros((0, num_cols or 0), dtype=np.float64)
        self = cls()
        self.num_data = n
        self.num_total_features = int(num_cols or 0)
        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        if weight is not None:
            self.metadata.set_weights(weight)
        if group is not None:
            self.metadata.set_group(group)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        if reference is not None:
            if reference.num_total_features != self.num_total_features:
                Log.fatal("Validation data has %d features, train data has %d",
                          self.num_total_features,
                          reference.num_total_features)
            self._adopt_schema(reference)
        else:
            self._adopt_schema(cls.schema_from_sample(
                sample, keys, max_bin=max_bin,
                min_data_in_bin=min_data_in_bin,
                min_data_in_leaf=min_data_in_leaf,
                categorical_feature=categorical_feature,
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                feature_names=feature_names, forced_bins=forced_bins,
                max_bin_by_feature=max_bin_by_feature,
                enable_bundle=enable_bundle))
        out = np.zeros((n, len(self.feature_groups)),
                       dtype=self._bundle_columns([], num_rows=0).dtype)
        pos = 0
        for part in chunks_factory():
            part = np.ascontiguousarray(part, dtype=np.float64)
            out[pos:pos + len(part)] = self.bundle_rows(part)
            pos += len(part)
        if pos != n:
            Log.fatal("Chunk source yielded %d rows on pass 2, %d on pass 1",
                      pos, n)
        self.binned = out
        self.raw_data = None
        return self

    @classmethod
    def from_csr(cls, indptr, indices, values, num_col: int, label=None,
                 weight=None, group=None, init_score=None, max_bin: int = 255,
                 min_data_in_bin: int = 3, min_data_in_leaf: int = 20,
                 bin_construct_sample_cnt: int = 200000,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 data_random_seed: int = 1,
                 feature_names: Optional[Sequence[str]] = None,
                 max_bin_by_feature: Optional[Sequence[int]] = None,
                 enable_bundle: bool = True,
                 reference: Optional["BinnedDataset"] = None,
                 data_chunk_rows: int = 0
                 ) -> "BinnedDataset":
        """Construct from CSR sparse input WITHOUT densifying.

        The counterpart of the reference's sparse path (src/io/
        sparse_bin.hpp, multi_val_sparse_bin.hpp): per-feature nonzero values
        feed bin finding (zeros implied by the total count,
        dataset_loader.cpp:819 contract) and the bin codes scatter straight
        into the EFB-bundled group columns.  Peak host memory is O(nnz) plus
        the bundled [N, num_groups] output; a dense [N, F] float matrix never
        exists.  Numerical features only; ``raw_data`` is not kept (refit and
        raw-value prediction paths need dense input)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        col_idx = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(values, dtype=np.float64)
        self = cls()
        self.num_data = n = int(len(indptr) - 1)
        self.num_total_features = f_total = int(num_col)
        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        if weight is not None:
            self.metadata.set_weights(weight)
        if group is not None:
            self.metadata.set_group(group)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        self.feature_names = (list(feature_names) if feature_names is not None
                              else ["Column_%d" % i for i in range(f_total)])

        # CSR -> CSC in O(nnz): per-nonzero row ids, stably sorted by column
        row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        order = np.argsort(col_idx, kind="stable")
        col_sorted = col_idx[order]
        rows_by_col = row_of[order]
        vals_by_col = vals[order]
        col_start = np.searchsorted(col_sorted, np.arange(f_total + 1))

        # same hash-priority draw as the dense/streaming constructors
        # (identical indices for identical (n, seed) — the loaders' shared
        # sampling discipline since round 21)
        sample_idx, sample_keys = _sample.bottom_k_indices(
            n, bin_construct_sample_cnt, data_random_seed)
        total = len(sample_idx)
        in_sample = np.zeros(n, dtype=bool)
        in_sample[sample_idx] = True

        if reference is not None:
            if reference.num_total_features != f_total:
                Log.fatal("Validation data has %d features, train data has %d",
                          f_total, reference.num_total_features)
            self.bin_mappers = reference.bin_mappers
            self.feature_names = reference.feature_names
        else:
            self.bin_mappers = []
            for f in range(f_total):
                s, e = col_start[f], col_start[f + 1]
                v = vals_by_col[s:e]
                v = v[in_sample[rows_by_col[s:e]]]
                v = v[(v != 0.0) | np.isnan(v)]
                m = BinMapper()
                fmax = (int(max_bin_by_feature[f]) if max_bin_by_feature
                        else int(max_bin))
                m.find_bin(v, total, fmax, min_data_in_bin,
                           min_split_data=min_data_in_leaf,
                           bin_type=BinType.NUMERICAL,
                           use_missing=use_missing,
                           zero_as_missing=zero_as_missing)
                self.bin_mappers.append(m)

        self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                 if not m.is_trivial]
        self.inner_feature_map = {f: j for j, f in
                                  enumerate(self.used_feature_idx)}
        self.num_bin_per_feature = [self.bin_mappers[i].num_bin
                                    for i in self.used_feature_idx]

        # per-used-feature sparse codes (nonzero positions only)
        rows_f: List[np.ndarray] = []
        codes_f: List[np.ndarray] = []
        zero_bin: List[int] = []
        for j, i in enumerate(self.used_feature_idx):
            s, e = col_start[i], col_start[i + 1]
            m = self.bin_mappers[i]
            rows_f.append(rows_by_col[s:e])
            codes_f.append(m.values_to_bins(vals_by_col[s:e]).astype(np.int32))
            zero_bin.append(int(m.values_to_bins(np.zeros(1))[0]))

        if reference is not None:
            self.feature_groups = [list(g) for g in reference.feature_groups]
            self.group_idx = reference.group_idx
            self.bin_offset = reference.bin_offset
            self.num_bin_per_group = list(reference.num_bin_per_group)
        elif enable_bundle:
            # sampled active bitmaps (code != 0) straight from the sparse
            # codes; the 64Ki sub-sample is the bottom-eff-by-key subset —
            # the same rows schema_from_sample's dense scan would use
            samp_pos = np.full(n, -1, dtype=np.int64)
            eff = min(total, self._EFB_SAMPLE)
            efb_rows = sample_idx[_sample.efb_positions(sample_keys, eff)]
            samp_pos[efb_rows] = np.arange(eff)
            active = []
            for j in range(len(self.used_feature_idx)):
                a = np.zeros(eff, dtype=bool)
                pos = samp_pos[rows_f[j][codes_f[j] != 0]]
                a[pos[pos >= 0]] = True
                active.append(a)
            self.feature_groups = self._find_groups(active)
            self._assign_group_layout()
        else:
            self.feature_groups = [[j] for j in
                                   range(len(self.used_feature_idx))]
            self._assign_group_layout()
        max_nb = max(self.num_bin_per_group, default=2)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        out = np.zeros((n, len(self.feature_groups)), dtype=dtype)
        for g, feats in enumerate(self.feature_groups):
            if len(feats) == 1 and zero_bin[feats[0]]:
                out[:, g] = dtype(zero_bin[feats[0]])
        # row-windowed scatter: per-feature nonzeros are row-ascending (the
        # stable CSC sort preserves CSR row order), so each window is a
        # searchsorted slice and ``data_chunk_rows=0`` is the one-window
        # case — byte-identical output by disjointness of the windows
        step = (int(data_chunk_rows) if int(data_chunk_rows or 0) > 0
                else max(n, 1))
        for r0 in range(0, max(n, 1), step):
            r1 = min(r0 + step, n)
            for g, feats in enumerate(self.feature_groups):
                if len(feats) == 1:
                    j = feats[0]
                    lo = np.searchsorted(rows_f[j], r0)
                    hi = np.searchsorted(rows_f[j], r1)
                    out[rows_f[j][lo:hi], g] = codes_f[j][lo:hi].astype(dtype)
                else:
                    for j in feats:  # push order: later features win conflicts
                        lo = np.searchsorted(rows_f[j], r0)
                        hi = np.searchsorted(rows_f[j], r1)
                        c = codes_f[j][lo:hi]
                        r = rows_f[j][lo:hi]
                        nz = c != 0
                        out[r[nz], g] = (self.bin_offset[j]
                                         + c[nz] - 1).astype(dtype)
        self.binned = out
        self.raw_data = None
        return self

    # ---- EFB bundling (dataset.cpp:92-290) ----

    _EFB_SAMPLE = 65536

    def _find_groups_from_cols(self, cols: List[np.ndarray]) -> List[List[int]]:
        nf = len(cols)
        if nf <= 1:
            return [[j] for j in range(nf)]
        n = self.num_data
        if n > self._EFB_SAMPLE:
            rng = np.random.RandomState(1)
            rows = np.sort(rng.choice(n, self._EFB_SAMPLE, replace=False))
        else:
            rows = slice(None)
        active = [np.asarray(c[rows] != 0) for c in cols]
        return self._find_groups(active)

    def _find_groups(self, active: List[np.ndarray]) -> List[List[int]]:
        """Greedy mutually-exclusive feature grouping (FindGroups,
        dataset.cpp:92-215) over per-feature active-row bitmaps (sampled): a
        feature joins the first group whose conflict count stays within the
        budget (total/10000, :104) and at most half the feature's active rows
        (:143); group bin budget 256 (:103).  Tried in both natural and
        active-count order, keeping the fewer groups (FastFeatureBundling
        :215-290).  Only features whose default bin is 0 share the group's 0
        code; others stay singletons."""
        nf = len(active)
        if nf <= 1:
            return [[j] for j in range(nf)]
        counts = [int(a.sum()) for a in active]
        total = active[0].shape[0] if nf else 0
        budget = total // 10000
        bundleable = [
            self.bin_mappers[self.used_feature_idx[j]].default_bin == 0
            and not self.bin_mappers[self.used_feature_idx[j]].is_trivial
            for j in range(nf)]

        def run(order):
            groups: List[List[int]] = []
            marks: List[np.ndarray] = []
            conflict_used: List[int] = []
            bins_used: List[int] = []
            for j in order:
                nb = self.num_bin_per_feature[j]
                placed = False
                if bundleable[j] and counts[j] * 2 <= total:
                    for g in range(len(groups)):
                        if bins_used[g] + nb - 1 > 255:
                            continue
                        rest = budget - conflict_used[g]
                        if rest < 0:
                            continue
                        cnt = int((marks[g] & active[j]).sum())
                        if cnt <= rest and cnt * 2 <= counts[j]:
                            groups[g].append(j)
                            marks[g] |= active[j]
                            conflict_used[g] += cnt
                            bins_used[g] += nb - 1
                            placed = True
                            break
                if not placed:
                    groups.append([j])
                    marks.append(active[j].copy() if bundleable[j]
                                 else np.ones_like(active[j]))
                    conflict_used.append(0)
                    bins_used.append(nb - 1 if bundleable[j] else 256)
            return groups

        natural = run(range(nf))
        by_cnt = run(sorted(range(nf), key=lambda j: -counts[j]))
        groups = by_cnt if len(by_cnt) < len(natural) else natural
        return [sorted(g) for g in groups]

    def _assign_group_layout(self) -> None:
        nf = len(self.num_bin_per_feature)
        self.group_idx = np.zeros(nf, dtype=np.int32)
        self.bin_offset = np.zeros(nf, dtype=np.int32)
        self.num_bin_per_group = []
        for g, feats in enumerate(self.feature_groups):
            off = 1
            for j in feats:
                self.group_idx[j] = g
                self.bin_offset[j] = off
                off += self.num_bin_per_feature[j] - 1
            self.num_bin_per_group.append(off)

    def _bundle_columns(self, cols: List[np.ndarray],
                        num_rows: Optional[int] = None) -> np.ndarray:
        max_nb = max(self.num_bin_per_group, default=2)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        if not cols:
            return np.zeros((num_rows if num_rows is not None
                             else self.num_data, 0), dtype=dtype)
        n = len(cols[0])
        out = np.zeros((n, len(self.feature_groups)), dtype=dtype)
        for g, feats in enumerate(self.feature_groups):
            if len(feats) == 1:
                out[:, g] = cols[feats[0]].astype(dtype)
                continue
            gcol = np.zeros(n, dtype=np.int32)
            for j in feats:   # push order: later features win conflicts
                b = cols[j]
                nz = b != 0
                gcol[nz] = self.bin_offset[j] + b[nz] - 1
            out[:, g] = gcol.astype(dtype)
        return out

    def bundle_rows(self, feats_chunk: np.ndarray) -> np.ndarray:
        """Bin + bundle a [m, F_total] raw-value chunk using this dataset's
        mappers and group layout (the two_round loader's second pass:
        dataset_loader.cpp two_round re-read straight into storage)."""
        col_dtype = (np.uint8 if max(self.num_bin_per_feature, default=2) <= 256
                     else np.uint16)
        cols = [self.bin_mappers[i].values_to_bins(
                    feats_chunk[:, i]).astype(col_dtype)
                for i in self.used_feature_idx]
        return self._bundle_columns(cols, num_rows=len(feats_chunk))

    @property
    def is_bundled(self) -> bool:
        return len(self.feature_groups) < len(self.used_feature_idx)

    def unbundled_matrix(self) -> np.ndarray:
        """Per-feature [N, F_used] bin matrix (for learners that shard over
        features and want one column per feature)."""
        if not self.is_bundled:
            return self.binned
        nf = len(self.used_feature_idx)
        max_nb = max(self.num_bin_per_feature, default=2)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        out = np.zeros((self.num_data, nf), dtype=dtype)
        for j in range(nf):
            col = self.binned[:, self.group_idx[j]].astype(np.int32)
            off = int(self.bin_offset[j])
            nb = self.num_bin_per_feature[j]
            mine = (col >= off) & (col <= off + nb - 2)
            out[mine, j] = (col[mine] - off + 1).astype(dtype)
        return out

    # ---- device view ----

    def device_view(self, device=None):
        """The binned matrix [N, C] on ``device`` (``cuda`` unless the
        caller passes another; dataset.py:639-648 of the JAX package),
        made once a device and kept while ``binned`` is the same array;
        u16 bins come as int32, the dtype the port's routes read."""
        import torch
        from ..device import resolve_device
        dev = resolve_device(device)
        cache = self._device_cache
        if cache is None or cache[0] is not self.binned:
            cache = self._device_cache = (self.binned, {})
        out = cache[1].get(dev)
        if out is None:
            bins = np.ascontiguousarray(self.binned)
            if bins.dtype == np.uint16:
                bins = bins.astype(np.int32)
            out = cache[1][dev] = torch.from_numpy(bins).to(dev)
        return out

    @property
    def num_features(self) -> int:
        return len(self.used_feature_idx)

    @property
    def num_total_bin(self) -> int:
        return int(sum(self.num_bin_per_feature))

    @property
    def max_num_bin(self) -> int:
        return max(self.num_bin_per_feature, default=2)

    @property
    def max_group_bin(self) -> int:
        return max(self.num_bin_per_group or self.num_bin_per_feature,
                   default=2)

    def most_freq_bins(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[i].most_freq_bin
                           for i in self.used_feature_idx], dtype=np.int32)

    def feature_is_categorical(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[i].bin_type == BinType.CATEGORICAL
                           for i in self.used_feature_idx], dtype=bool)

    def missing_types(self) -> np.ndarray:
        return np.asarray([int(self.bin_mappers[i].missing_type)
                           for i in self.used_feature_idx], dtype=np.int32)

    def default_bins(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[i].default_bin
                           for i in self.used_feature_idx], dtype=np.int32)

    # ---- serialization: binary dataset file (dataset.h:473 SaveBinaryFile) ----

    MAGIC = b"LGBMTPU1"

    def save_binary(self, path: str) -> None:
        header = {
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "feature_names": self.feature_names,
            "bin_mappers": [m.to_dict() for m in self.bin_mappers],
            "has_weights": self.metadata.weights is not None,
            "has_group": self.metadata.query_boundaries is not None,
            "has_init_score": self.metadata.init_score is not None,
            "binned_dtype": str(self.binned.dtype),
            "feature_groups": self.feature_groups,
        }
        buf = io.BytesIO()
        buf.write(self.MAGIC)
        hdr = json.dumps(header).encode()
        buf.write(len(hdr).to_bytes(8, "little"))
        buf.write(hdr)
        np.save(buf, self.binned, allow_pickle=False)
        np.save(buf, self.metadata.label, allow_pickle=False)
        if self.metadata.weights is not None:
            np.save(buf, self.metadata.weights, allow_pickle=False)
        if self.metadata.query_boundaries is not None:
            np.save(buf, self.metadata.query_boundaries, allow_pickle=False)
        if self.metadata.init_score is not None:
            np.save(buf, self.metadata.init_score, allow_pickle=False)
        # atomic: a preemption (or ENOSPC) mid-save must never leave a
        # partial store at the destination — same discipline as checkpoints
        from ..utils.file_io import atomic_write
        atomic_write(path, buf.getvalue())
        Log.info("Saved binary dataset to %s", path)

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        with open(path, "rb") as fh:
            magic = fh.read(8)
            if magic != cls.MAGIC:
                Log.fatal("File %s is not a LightGBM-TPU binary dataset", path)
            hdr_len = int.from_bytes(fh.read(8), "little")
            header = json.loads(fh.read(hdr_len).decode())
            self = cls()
            self.num_data = header["num_data"]
            self.num_total_features = header["num_total_features"]
            self.feature_names = header["feature_names"]
            self.bin_mappers = [BinMapper.from_dict(d) for d in header["bin_mappers"]]
            self.binned = np.load(fh, allow_pickle=False)
            self.metadata = Metadata(self.num_data)
            self.metadata.label = np.load(fh, allow_pickle=False)
            if header["has_weights"]:
                self.metadata.weights = np.load(fh, allow_pickle=False)
            if header["has_group"]:
                self.metadata.query_boundaries = np.load(fh, allow_pickle=False)
            if header["has_init_score"]:
                self.metadata.init_score = np.load(fh, allow_pickle=False)
        self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                 if not m.is_trivial]
        self.inner_feature_map = {f: j for j, f in enumerate(self.used_feature_idx)}
        self.num_bin_per_feature = [self.bin_mappers[i].num_bin
                                    for i in self.used_feature_idx]
        self.feature_groups = [list(g) for g in header.get(
            "feature_groups", [[j] for j in range(len(self.used_feature_idx))])]
        self._assign_group_layout()
        self.metadata._update_query_weights()
        return self

    # ---- subsetting (dataset.h CopySubset / bagging-with-subset) ----

    def subset(self, indices: np.ndarray) -> "BinnedDataset":
        out = BinnedDataset()
        out.num_data = len(indices)
        out.num_total_features = self.num_total_features
        out.bin_mappers = self.bin_mappers
        out.used_feature_idx = self.used_feature_idx
        out.inner_feature_map = self.inner_feature_map
        out.num_bin_per_feature = self.num_bin_per_feature
        out.feature_names = self.feature_names
        out.feature_groups = self.feature_groups
        out.group_idx = self.group_idx
        out.bin_offset = self.bin_offset
        out.num_bin_per_group = self.num_bin_per_group
        out.binned = self.binned[indices]
        out.metadata = self.metadata.subset(indices)
        if self.raw_data is not None:
            out.raw_data = self.raw_data[indices]
        return out

    def add_features_from(self, other: "BinnedDataset") -> None:
        """Append another dataset's features (same rows) in place
        (dataset.cpp AddFeaturesFrom / c_api LGBM_DatasetAddFeaturesFrom).
        Appended features keep their own bin mappers; groups become
        singletons (no re-bundling across datasets, like the reference's
        group-level merge)."""
        if other.num_data != self.num_data:
            Log.fatal("Cannot add features from a dataset with %d rows to "
                      "one with %d rows", other.num_data, self.num_data)
        mine = self.unbundled_matrix()
        theirs = other.unbundled_matrix()
        dtype = (np.uint16 if (mine.dtype == np.uint16
                               or theirs.dtype == np.uint16) else np.uint8)
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.feature_names = list(self.feature_names) + list(other.feature_names)
        self.num_total_features += other.num_total_features
        self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                 if not m.is_trivial]
        self.inner_feature_map = {f: j for j, f
                                  in enumerate(self.used_feature_idx)}
        self.num_bin_per_feature = [self.bin_mappers[i].num_bin
                                    for i in self.used_feature_idx]
        merged = np.concatenate([mine.astype(dtype), theirs.astype(dtype)],
                                axis=1)
        self.feature_groups = [[j] for j in range(merged.shape[1])]
        self._assign_group_layout()
        self.binned = merged
        if self.raw_data is not None and other.raw_data is not None:
            self.raw_data = np.concatenate([self.raw_data, other.raw_data],
                                           axis=1)
        else:
            self.raw_data = None

    def feature_infos(self) -> List[str]:
        """Per-original-feature info strings for the model file
        (gbdt_model_text.cpp feature_infos: ``[min:max]`` or category list)."""
        infos = []
        for m in self.bin_mappers:
            if m.is_trivial:
                infos.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                infos.append(":".join(str(c) for c in m.bin_2_categorical))
            else:
                infos.append("[%s:%s]" % (repr(m.min_val), repr(m.max_val)))
        return infos
