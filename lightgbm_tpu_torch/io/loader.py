"""DatasetLoader: text file -> BinnedDataset with config-driven columns.

The counterpart of ``lightgbm_tpu/io/loader.py`` for the PyTorch port (which
imports nothing of the JAX package), and of the reference ``DatasetLoader``
(src/io/dataset_loader.cpp): header handling (SetHeader :31), label/weight/
group columns (by index or ``name:`` prefix), ignore columns, categorical
features, side files (``.weight``/``.query``/``.init``, metadata.cpp), forced
bins, the binary round-trip, validation alignment with the training
dataset's bin mappers (LoadFromFileAlignWithOtherDataset :230), and the
streaming ingest of ``data_chunk_rows`` and ``two_round`` (pass 1 samples raw
lines, pass 2 bins bounded chunks into the packed store).

Distributed loading works through an ``allgather_fn(payload: bytes) ->
List[bytes]``: feature-sharded bin finding, and the striped streaming scan
whose candidate samples ride one allgather.  An injected one (the
``allgather_fn`` attribute of a loader, or the argument of
:func:`find_bin_mappers_distributed`) wins; otherwise, under an initialized
``torch.distributed`` group of more than one process, the default is the
group's bytes allgather (``parallel.comm.ProcessComm.all_gather_bytes``,
the JAX package's ``_default_allgather`` over ``jax.distributed``,
loader.py:109-125).  With neither, ``num_machines > 1`` takes the
single-process branch (one warning, bins from the local rows).  The schema
agreement of the striped scan is ``parallel/distdata.py``'s.  A preemption
flag (``resilience.py``) set during a
streaming load raises ``TrainingPreempted(0)`` between chunks, as in the
JAX loader.  With a telemetry run active the streaming load emits
``ingest`` events (phases ``sample``, ``bin`` per chunk, ``done``), the
``ingest_chunks``/``ingest_rows`` counters, the per-chunk rows/s histogram
and the host RSS high-water (loader.py:431-615 of the JAX package); the
JAX loader's pipeline stall time is not measured by the port's prefetch
and is left out.  Side files, the data file's existence
and the binary check go through ``utils.file_io``, so a registered
``scheme://`` serves them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import sample as _sample
from .dataset import BinnedDataset
from .metadata import Metadata
from .parser import detect_format, parse_file
from .. import resilience
# schema_digest is re-exported: the loader's API names it
from ..parallel.distdata import (pod_info, schema_digest,  # noqa: F401
                                 verify_schema)
from ..utils import file_io
from ..utils.log import Log


def _parse_column_spec(spec: str, names: Optional[List[str]], what: str) -> int:
    """'3' -> 3; 'name:foo' -> index of foo (dataset_loader.cpp:40-78)."""
    if spec == "":
        return -1
    if spec.startswith("name:"):
        name = spec[5:]
        if names is None or name not in names:
            Log.fatal("Could not find %s column %s in data file", what, name)
        return names.index(name)
    return int(spec)


def _parse_multi_column_spec(spec, names: Optional[List[str]]) -> List[int]:
    if spec in ("", None):
        return []
    if isinstance(spec, (list, tuple)):
        return [int(v) for v in spec]
    spec = str(spec)
    if spec.startswith("name:"):
        wanted = spec[5:].split(",")
        if names is None:
            Log.fatal("Cannot use name-based columns without a file header")
        return [names.index(w) for w in wanted if w in names]
    return [int(v) for v in spec.split(",") if v != ""]


def find_bin_mappers_distributed(mat: np.ndarray, rank: int,
                                 num_machines: int, config,
                                 categorical: Sequence[int] = (),
                                 allgather_fn=None, forced_bins=None,
                                 max_bin_by_feature=None) -> List["object"]:
    """Distributed bin finding (dataset_loader.cpp:867-1044): features are
    sharded over machines, each rank finds BinMappers for its shard from its
    LOCAL rows, and an allgather merges the full set (:1028).

    ``allgather_fn(payload: bytes) -> List[bytes]`` supplies the collective —
    the seam the reference exposes as LGBM_NetworkInitWithFunctions; None
    takes the process group's (:func:`_default_allgather`).
    """
    import json as _json

    from .binning import BinMapper, BinType

    nf = mat.shape[1]
    start = nf * rank // num_machines
    end = nf * (rank + 1) // num_machines
    cat = set(int(c) for c in categorical)
    rng = np.random.RandomState(int(config.data_random_seed))
    sample_cnt = int(config.bin_construct_sample_cnt)
    n = mat.shape[0]
    rows = (np.sort(rng.choice(n, sample_cnt, replace=False))
            if n > sample_cnt else np.arange(n))
    local = {}
    for f in range(start, end):
        col = mat[rows, f]
        nz = col[(col != 0.0) | np.isnan(col)]
        m = BinMapper()
        fmax = (int(max_bin_by_feature[f]) if max_bin_by_feature
                else int(config.max_bin))
        m.find_bin(nz, len(rows), fmax,
                   int(config.min_data_in_bin),
                   min_split_data=int(config.min_data_in_leaf),
                   bin_type=(BinType.CATEGORICAL if f in cat
                             else BinType.NUMERICAL),
                   use_missing=bool(config.use_missing),
                   zero_as_missing=bool(config.zero_as_missing),
                   forced_upper_bounds=(forced_bins or {}).get(f))
        local[f] = m.to_dict()
    payload = _json.dumps(local).encode()
    if allgather_fn is None:
        allgather_fn = _default_allgather(num_machines)
    merged: List[Optional[object]] = [None] * nf
    for part in allgather_fn(payload):
        for f_str, d in _json.loads(part.decode()).items():
            merged[int(f_str)] = BinMapper.from_dict(d)
    missing = [f for f, m in enumerate(merged) if m is None]
    if missing:
        Log.fatal("Distributed bin finding left features without mappers: %s",
                  missing[:8])
    return merged


def _default_allgather(num_machines: int):
    """The bytes allgather of the initialized ``torch.distributed`` group
    (loader.py:109-125); the identity of a single machine or a
    single-process run.  NCCL moves the bytes through the current CUDA
    device, gloo through host memory."""
    if num_machines <= 1:
        return lambda payload: [payload]

    def gather(payload: bytes) -> List[bytes]:
        import torch.distributed as dist

        from ..parallel.comm import ProcessComm
        if pod_info()[1] == 1:
            return [payload]
        dev = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
        return ProcessComm(device=dev).all_gather_bytes(payload)

    return gather


def _qid_to_group_sizes(group_col: np.ndarray) -> np.ndarray:
    """Per-row query ids -> group sizes by consecutive runs (metadata.h qid
    semantics: rows of a query are contiguous; ids need not be sorted)."""
    if len(group_col) == 0:
        return np.zeros(0, dtype=np.int32)
    boundaries = np.flatnonzero(np.diff(group_col)) + 1
    edges = np.concatenate([[0], boundaries, [len(group_col)]])
    return np.diff(edges).astype(np.int32)


class _Columns:
    """Resolved column layout in FULL-file coordinates."""

    def __init__(self, label_idx, weight_idx, group_idx, ignore, keep,
                 categorical):
        self.label_idx = label_idx
        self.weight_idx = weight_idx
        self.group_idx = group_idx
        self.ignore = ignore
        self.keep = keep                # kept feature columns (full coords)
        self.categorical = categorical  # positions within ``keep``


def _resolve_columns(cfg, names, full_cols: int,
                     is_libsvm: bool) -> _Columns:
    """Resolve label/weight/group/ignore/categorical specs.

    The label spec indexes the FULL file; every other spec is in
    LABEL-EXCLUDED coordinates — the reference parser renumbers columns after
    erasing the label (dataset_loader.cpp:31-130 SetHeader builds name2idx
    after the erase; parser.hpp applies offset -1 past the label).  For
    LibSVM the leading target is the label and positional specs don't apply
    (parser.hpp LibSVM branch)."""
    if is_libsvm:
        for spec, nm in ((cfg.label_column, "label_column"),
                         (cfg.weight_column, "weight_column"),
                         (cfg.group_column, "group_column"),
                         (cfg.ignore_column, "ignore_column")):
            if str(spec or ""):
                Log.warning("%s is not supported for LibSVM files and will "
                            "be ignored (use the .weight/.query side files)",
                            nm)
        return _Columns(0, -1, -1, set(), list(range(1, full_cols)), [])
    label_idx = _parse_column_spec(str(cfg.label_column) or "0", names,
                                   "label")
    if label_idx < 0:
        label_idx = 0
    names_nolabel = (None if names is None else
                     names[:label_idx] + names[label_idx + 1:])

    def to_full(idx: int) -> int:
        return idx if idx < label_idx else idx + 1

    weight_idx = _parse_column_spec(str(cfg.weight_column), names_nolabel,
                                    "weight")
    group_idx = _parse_column_spec(str(cfg.group_column), names_nolabel,
                                   "group")
    weight_idx = to_full(weight_idx) if weight_idx >= 0 else -1
    group_idx = to_full(group_idx) if group_idx >= 0 else -1
    ignore = {to_full(i) for i in
              _parse_multi_column_spec(cfg.ignore_column, names_nolabel)}
    drop = {label_idx} | ignore
    if weight_idx >= 0:
        drop.add(weight_idx)
    if group_idx >= 0:
        drop.add(group_idx)
    keep = [i for i in range(full_cols) if i not in drop]
    cat_cols = {to_full(i) for i in _parse_multi_column_spec(
        cfg.categorical_feature, names_nolabel)}
    categorical = [j for j, i in enumerate(keep) if i in cat_cols]
    return _Columns(label_idx, weight_idx, group_idx, ignore, keep,
                    categorical)


class DatasetLoader:
    """Config-driven text/binary loading (include/LightGBM/dataset_loader.h)."""

    def __init__(self, config) -> None:
        self.config = config

    def _side_files(self, filename: str, weight, group_col,
                    begin: int, end: int):
        """``.weight``/``.query``/``.init`` side files (metadata.cpp),
        restricted to the rank stripe [begin, end)."""
        weight_file = filename + ".weight"
        if weight is None and file_io.exists(weight_file):
            with file_io.open_file(weight_file) as fh:
                weight = np.loadtxt(fh, dtype=np.float64, ndmin=1)[begin:end]
            Log.info("Reading weights from %s", weight_file)
        group = None
        query_file = filename + ".query"
        if group_col is not None:
            # per-row query ids -> group sizes (metadata.h qids)
            group = _qid_to_group_sizes(group_col)
        elif file_io.exists(query_file):
            with file_io.open_file(query_file) as fh:
                sizes = np.loadtxt(fh, dtype=np.int64, ndmin=1)
            # intersect the query runs with the stripe
            edges = np.concatenate([[0], np.cumsum(sizes)])
            clipped = np.clip(edges, begin, end) - begin
            runs = np.diff(clipped)
            group = runs[runs > 0].astype(np.int32)
            Log.info("Reading query boundaries from %s", query_file)
        init_score = None
        init_file = filename + ".init"
        if file_io.exists(init_file):
            with file_io.open_file(init_file) as fh:
                init_score = np.loadtxt(fh, dtype=np.float64,
                                        ndmin=1)[begin:end]
            Log.info("Reading initial scores from %s", init_file)
        return weight, group, init_score

    def load_from_file(self, filename: str, rank: int = 0,
                       num_machines: int = 1,
                       reference: Optional[BinnedDataset] = None
                       ) -> BinnedDataset:
        cfg = self.config
        if not file_io.exists(filename):
            Log.fatal("Data file %s does not exist", filename)
        if _is_binary_file(filename):
            ds = BinnedDataset.load_binary(filename)
            return ds
        chunk_rows = int(getattr(cfg, "data_chunk_rows", 0) or 0)
        if chunk_rows > 0:
            depth = int(getattr(cfg, "ingest_pipeline_depth", 2) or 2)
            return self._load_streaming(filename, rank, num_machines,
                                        reference, chunk_rows, depth)
        if bool(cfg.two_round):
            return self._load_streaming(filename, rank, num_machines,
                                        reference, int(self._TWO_ROUND_CHUNK),
                                        2)
        header = bool(cfg.header) if cfg.header else None
        is_libsvm = detect_format(filename)[0] == "libsvm"
        if is_libsvm:
            mat, label, names = parse_file(filename, header=header,
                                           label_idx=0)
            full = np.concatenate([label[:, None], mat], axis=1)
        else:
            full, _, names = parse_file(filename, header=header, label_idx=-1)
        cols = _resolve_columns(cfg, names, full.shape[1], is_libsvm)
        label = full[:, cols.label_idx]
        weight = full[:, cols.weight_idx] if cols.weight_idx >= 0 else None
        group_col = full[:, cols.group_idx] if cols.group_idx >= 0 else None
        mat = full[:, cols.keep]
        feat_names = ([names[i] for i in cols.keep]
                      if names is not None else None)

        # distributed loading: contiguous stripe per rank
        # (dataset_loader.cpp:168 pre_partition / sampled partitioning)
        n_total = len(mat)
        begin, end = 0, n_total
        if num_machines > 1 and self.config.pre_partition is False:
            begin = n_total * rank // num_machines
            end = n_total * (rank + 1) // num_machines
            mat = mat[begin:end]
            label = label[begin:end]
            weight = weight[begin:end] if weight is not None else None
            group_col = group_col[begin:end] if group_col is not None else None

        weight, group, init_score = self._side_files(
            filename, weight, group_col, begin, end)

        categorical = cols.categorical
        forced_bins = None
        if getattr(cfg, "forcedbins_filename", ""):
            forced_bins = _load_forced_bins(cfg.forcedbins_filename)
        mappers = None
        if num_machines > 1 and reference is None:
            # feature-sharded bin finding + allgather merge
            # (dataset_loader.cpp:867-1044, allgather at :1028); needs a
            # collective: injected, or a process group's
            if (getattr(self, "allgather_fn", None) is not None
                    or pod_info()[1] > 1):
                mappers = find_bin_mappers_distributed(
                    mat, rank, num_machines, cfg, categorical,
                    allgather_fn=getattr(self, "allgather_fn", None),
                    forced_bins=forced_bins,
                    max_bin_by_feature=(list(cfg.max_bin_by_feature)
                                        if cfg.max_bin_by_feature else None))
            else:
                Log.warning("num_machines=%d with a single-process runtime: "
                            "finding bins locally on this rank's rows",
                            num_machines)
        ds = BinnedDataset.from_matrix(
            mat, label=label, weight=weight, group=group,
            init_score=init_score, max_bin=int(cfg.max_bin),
            min_data_in_bin=int(cfg.min_data_in_bin),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            bin_construct_sample_cnt=int(cfg.bin_construct_sample_cnt),
            categorical_feature=categorical,
            use_missing=bool(cfg.use_missing),
            zero_as_missing=bool(cfg.zero_as_missing),
            data_random_seed=int(cfg.data_random_seed),
            enable_bundle=bool(cfg.enable_bundle),
            feature_names=feat_names, forced_bins=forced_bins,
            max_bin_by_feature=(list(cfg.max_bin_by_feature)
                                if cfg.max_bin_by_feature else None),
            reference=reference, bin_mappers=mappers)
        if num_machines > 1 and cfg.pre_partition is False:
            ds.shard = {"rank": int(rank), "num_machines": int(num_machines),
                        "begin": int(begin), "end": int(end),
                        "num_total": int(n_total)}
        if cfg.save_binary:
            ds.save_binary(filename + ".bin")
        return ds

    # ---- two_round / streaming loading ----
    # dataset_loader.cpp two_round: pass 1 streams the file once, counting
    # rows and reservoir-sampling values for bin finding; pass 2 re-reads the
    # file in bounded chunks and bins each chunk straight into the bundled
    # storage.  Peak memory is the sample + one chunk + the [N, G] binned
    # matrix — the raw [N, F] float matrix never exists.

    _TWO_ROUND_CHUNK = 65536

    @staticmethod
    def _prefetch(iterator, depth: int = 2):
        """Background-thread chunk prefetch, the ``PipelineReader`` role
        (include/LightGBM/utils/pipeline_reader.h:24 double-buffered read):
        the next chunk is read and parsed while the consumer bins the
        current one."""
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        sentinel = object()
        err = []
        dead = threading.Event()

        def put(item) -> None:
            while not dead.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for item in iterator:
                    put(item)
                    if dead.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                err.append(exc)
            finally:
                put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # the consumer abandoned the generator (or raised): stop the
            # worker so the file handle is released
            dead.set()

    def _load_streaming(self, filename: str, rank: int = 0,
                        num_machines: int = 1,
                        reference: Optional[BinnedDataset] = None,
                        chunk_rows: int = 65536,
                        depth: int = 2) -> BinnedDataset:
        """Two-pass streaming construction: the ``two_round`` role
        (dataset_loader.cpp two_round + SampleTextDataFromFile) and the
        ``data_chunk_rows`` path.

        Pass 1 scans raw lines once, keeping the hash-priority bottom-k
        sample (io/sample.py); with an injected allgather each rank scans
        only its stripe and the candidate pools ride one allgather, so
        every rank freezes the same bin mappers as a serial full scan.
        Pass 2 re-reads this rank's stripe in bounded chunks through the
        prefetch pipeline and bins straight into the packed store: the raw
        [N, F] f64 matrix never exists.
        """
        import time

        from .. import obs
        from ..obs import hostmem
        from .parser import count_data_rows, hash_sample_lines, stream_file

        cfg = self.config
        header = bool(cfg.header) if cfg.header else None
        fmt = detect_format(filename)[0]
        sample_cnt = int(cfg.bin_construct_sample_cnt)
        seed = int(cfg.data_random_seed)
        tele = obs.active()

        # ---- pass 1: hash-priority sample + row count + width ----
        t0 = time.perf_counter()
        striped = num_machines > 1 and cfg.pre_partition is False
        allgather = getattr(self, "allgather_fn", None)
        if striped and allgather is None and pod_info()[1] > 1:
            allgather = _default_allgather(num_machines)
        use_collective = striped and allgather is not None
        if use_collective:
            # each rank scans ONLY its stripe; O(sample_cnt) candidates ride
            # one allgather and every rank merges the identical global
            # sample (stripe decomposition of bottom-k, io/sample.py)
            total_rows = count_data_rows(filename, header=header)
            begin = total_rows * rank // num_machines
            end = total_rows * (rank + 1) // num_machines
            idx, keys, smat, scanned, width = hash_sample_lines(
                filename, sample_cnt, seed, header=header,
                skip_rows=begin, max_rows=end - begin, base_index=begin)
            parts = allgather(_sample.encode_payload(
                idx, keys, smat, scanned, width))
            idx, keys, sample, gathered, full_cols = _sample.merge_payloads(
                parts, sample_cnt)
            if gathered != total_rows:
                Log.fatal("sharded ingest: allgathered row count %d does not "
                          "match the counted %d", gathered, total_rows)
        else:
            # no collective available: scan the whole file so stripes of a
            # single-process "pod" still share one global sample
            idx, keys, sample, total_rows, full_cols = hash_sample_lines(
                filename, sample_cnt, seed, header=header)
            begin, end = 0, total_rows
            if striped:
                begin = total_rows * rank // num_machines
                end = total_rows * (rank + 1) // num_machines
        n_kept = end - begin
        Log.info("streaming ingest: sampled %d of %d rows from %s in %.3f s",
                 len(sample), total_rows, filename, time.perf_counter() - t0)
        hostmem.note()
        if tele is not None:
            tele.event("ingest", phase="sample", rows=int(total_rows),
                       sampled=int(len(sample)),
                       dt_s=round(time.perf_counter() - t0, 6))

        # column resolution (full-file coordinates; LibSVM fixes label at 0)
        names = None
        if fmt != "libsvm":
            from .parser import sniff_header
            has_hdr, hdr_names = sniff_header(filename)
            if header is None:
                header = has_hdr
            if header:
                names = hdr_names
        cols = _resolve_columns(cfg, names, full_cols, fmt == "libsvm")
        label_idx, weight_idx, group_idx = (cols.label_idx, cols.weight_idx,
                                            cols.group_idx)
        keep = cols.keep
        feat_names = [names[i] for i in keep] if names is not None else None

        # schema (mappers + EFB groups) frozen from the sample
        forced_bins = None
        if getattr(cfg, "forcedbins_filename", ""):
            forced_bins = _load_forced_bins(cfg.forcedbins_filename)
        if reference is not None:
            schema = reference
            if len(keep) != int(schema.num_total_features):
                Log.fatal("streaming ingest: file has %d feature columns but "
                          "the reference dataset has %d", len(keep),
                          int(schema.num_total_features))
        else:
            schema = BinnedDataset.schema_from_sample(
                sample[:, keep] if len(sample) else np.zeros((0, len(keep))),
                keys,
                max_bin=int(cfg.max_bin),
                min_data_in_bin=int(cfg.min_data_in_bin),
                min_data_in_leaf=int(cfg.min_data_in_leaf),
                categorical_feature=cols.categorical,
                use_missing=bool(cfg.use_missing),
                zero_as_missing=bool(cfg.zero_as_missing),
                feature_names=feat_names, forced_bins=forced_bins,
                max_bin_by_feature=(list(cfg.max_bin_by_feature)
                                    if cfg.max_bin_by_feature else None),
                enable_bundle=bool(cfg.enable_bundle))

        ds = BinnedDataset()
        ds.num_data = n_kept
        ds.num_total_features = len(keep)
        ds.feature_names = (list(schema.feature_names)
                            if schema.feature_names else feat_names)
        ds.bin_mappers = schema.bin_mappers
        ds.used_feature_idx = list(schema.used_feature_idx)
        ds.inner_feature_map = dict(schema.inner_feature_map)
        ds.num_bin_per_feature = list(schema.num_bin_per_feature)
        ds.feature_groups = [list(g) for g in schema.feature_groups]
        ds.group_idx = schema.group_idx
        ds.bin_offset = schema.bin_offset
        ds.num_bin_per_group = list(schema.num_bin_per_group)
        ds.raw_data = None
        if striped:
            ds.shard = {"rank": int(rank), "num_machines": int(num_machines),
                        "begin": int(begin), "end": int(end),
                        "num_total": int(total_rows)}
        if use_collective and reference is None:
            # every rank must have frozen the SAME schema or the learners
            # will exchange histograms over incompatible bin spaces —
            # fail loudly now, not at iteration 40 (ROADMAP pod pin)
            verify_schema(ds, allgather, total_rows=total_rows)

        # ---- pass 2: stream this rank's stripe, bin chunk-by-chunk ----
        max_nb = max(ds.num_bin_per_group, default=2)
        out_dtype = np.uint8 if max_nb <= 256 else np.uint16
        binned = np.zeros((n_kept, len(ds.feature_groups)), dtype=out_dtype)
        label = np.zeros(n_kept, dtype=np.float64)
        weight = (np.zeros(n_kept, dtype=np.float64)
                  if weight_idx >= 0 else None)
        group_col = (np.zeros(n_kept, dtype=np.float64)
                     if group_idx >= 0 else None)

        t1 = time.perf_counter()
        wpos = 0      # write cursor into the kept stripe
        n_chunks = 0
        for part in self._prefetch(
                stream_file(filename, chunk_rows, header,
                            num_cols=(full_cols - 1 if fmt == "libsvm"
                                      else None),
                            skip_rows=begin, max_rows=n_kept),
                depth):
            if resilience.preemption_requested():
                # nothing durable is half-written: the store lives in memory
                # until save_binary's atomic rename after the last chunk
                resilience.clear_preemption()
                raise resilience.TrainingPreempted(0)
            k = part.shape[0]
            tc = time.perf_counter()
            binned[wpos:wpos + k] = ds.bundle_rows(part[:, keep])
            label[wpos:wpos + k] = part[:, label_idx]
            if weight is not None:
                weight[wpos:wpos + k] = part[:, weight_idx]
            if group_col is not None:
                group_col[wpos:wpos + k] = part[:, group_idx]
            wpos += k
            rss = hostmem.note()
            if tele is not None:
                dt = time.perf_counter() - tc
                tele.event("ingest", phase="bin", chunk=n_chunks,
                           rows=int(k), dt_s=round(dt, 6),
                           rss_bytes=int(rss))
                tele.counter("ingest_chunks").inc()
                tele.counter("ingest_rows").inc(int(k))
                tele.histogram("ingest_chunk_rows_per_s").observe(
                    k / dt if dt > 0 else 0.0)
            n_chunks += 1
        if wpos != n_kept:
            Log.fatal("streaming ingest: pass 2 delivered %d rows for a "
                      "stripe of %d (file changed between passes?)",
                      wpos, n_kept)
        ds.binned = binned
        dt2 = time.perf_counter() - t1
        Log.info("streaming ingest: binned %d rows in %.3f s", n_kept, dt2)
        if tele is not None:
            tele.event("ingest", phase="done", chunks=int(n_chunks),
                       rows=int(n_kept), dt_s=round(dt2, 6),
                       rows_per_s=round(n_kept / dt2 if dt2 > 0 else 0.0, 1),
                       rss_high_water=int(hostmem.high_water()))
            tele.gauge("host_rss_high_water_bytes").set(
                float(hostmem.high_water()))

        ds.metadata = Metadata(n_kept)
        ds.metadata.set_label(label)
        weight, group, init_score = self._side_files(
            filename, weight, group_col, begin, end)
        if weight is not None:
            ds.metadata.set_weights(weight)
        if group is not None:
            ds.metadata.set_group(group)
        if init_score is not None:
            ds.metadata.set_init_score(init_score)
        if bool(cfg.save_binary):
            ds.save_binary(filename + ".bin")
            Log.info("Saved binary dataset to %s.bin", filename)
        return ds

    def load_prediction_data(self, filename: str):
        """Features (+names) for task=predict; label column dropped if
        configured (predictor.hpp: parser keeps row shape, label ignored)."""
        cfg = self.config
        header = bool(cfg.header) if cfg.header else None
        feats, _, names = parse_file(filename, header=header, label_idx=-1)
        label_idx = _parse_column_spec(str(cfg.label_column) or "0", names,
                                       "label")
        if 0 <= label_idx < feats.shape[1]:
            feats = np.delete(feats, label_idx, axis=1)
        return feats


def _is_binary_file(path: str) -> bool:
    with file_io.open_file(path, "rb") as fh:
        return fh.read(8) == BinnedDataset.MAGIC


def _load_forced_bins(path: str):
    import json
    if not file_io.exists(path):
        return None
    with file_io.open_file(path) as fh:
        data = json.load(fh)
    return {int(e["feature"]): list(map(float, e["bin_upper_bound"]))
            for e in data}
