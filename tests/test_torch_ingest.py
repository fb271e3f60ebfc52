"""Text-file ingest of the port against the JAX package, on the CPU.

``lightgbm_tpu_torch.io.parser`` and ``io.loader`` against
``lightgbm_tpu.io.parser`` and ``io.loader`` on the same files: format
detection and parsing (CSV, TSV, LibSVM, a header, NA tokens), the
``.weight``/``.query``/``.init`` side files, the one-shot load of the
reference's example files, the streaming loads (``data_chunk_rows`` at
chunk sizes on both sides of a boundary, EFB on and off; ``two_round``)
equal to the one-shot load, two virtual ranks with an injected allgather,
forced bins, categorical columns and the binary round trip.  Every loaded
dataset is byte-equal to the JAX loader's: bin mappers, packed store, EFB
layout, labels, weights, query boundaries, initial scores and raw values.
Every test runs twice: with pandas, and with pandas hidden from both
packages (``sys.modules["pandas"] = None``), where the parsers take their
``np.loadtxt`` and per-token branches, as on a machine without pandas.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io.loader import DatasetLoader as JLoader
from lightgbm_tpu_torch import Dataset
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import loader as ploader
from lightgbm_tpu_torch.io import parser as pparser
from lightgbm_tpu_torch.io.loader import DatasetLoader

DATA = os.path.join(os.path.dirname(__file__), "data")
N_ROWS = 1000


@pytest.fixture(params=["pandas", "no_pandas"])
def pandas_mode(request, monkeypatch):
    if request.param == "no_pandas":
        monkeypatch.setitem(sys.modules, "pandas", None)
    return request.param


def _cfgs(**kw):
    base = dict(max_bin=63, bin_construct_sample_cnt=200, verbosity=-1)
    base.update(kw)
    return Config(dict(base)), JConfig(dict(base))


def load_both(path, reference=None, **kw):
    pc, jc = _cfgs(**kw)
    ref_p, ref_j = reference if reference is not None else (None, None)
    return (DatasetLoader(pc).load_from_file(path, reference=ref_p),
            JLoader(jc).load_from_file(path, reference=ref_j))


def _mappers(ds):
    # a json round trip, so that a NaN bin bound compares equal
    return json.dumps([m.to_dict() for m in ds.bin_mappers], sort_keys=True)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_same_dataset(a, b, raw=True):
    """Byte equality of two loaded datasets (either package's)."""
    assert a.num_data == b.num_data
    assert a.num_total_features == b.num_total_features
    assert _mappers(a) == _mappers(b)
    assert list(a.feature_names) == list(b.feature_names)
    assert [list(g) for g in a.feature_groups] == \
        [list(g) for g in b.feature_groups]
    assert a.binned.dtype == b.binned.dtype
    np.testing.assert_array_equal(a.binned, b.binned)
    for name in ("label", "weights", "query_boundaries", "init_score"):
        _same(getattr(a.metadata, name), getattr(b.metadata, name))
    if raw:
        _same(a.raw_data, b.raw_data)


def _table(n=N_ROWS, seed=3):
    """A dense table with a NaN-holed column and a low-cardinality one."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 6)).round(4)
    x[rng.rand(n) < 0.1, 1] = np.nan
    x[:, 2] = rng.randint(0, 5, size=n)
    y = (x[:, 0] + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)).round(4)
    return x, y


def _write_csv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), fmt="%.6g", delimiter=",")
    return str(path)


# ---- parsing ----


def _write_files(tmp_path):
    X = np.arange(12, dtype=float).reshape(4, 3) / 7.0
    y = np.arange(4, dtype=float)
    tsv = str(tmp_path / "a.tsv")
    with open(tsv, "w") as fh:
        for row, lab in zip(X, y):
            fh.write("%g\t" % lab + "\t".join("%.17g" % v for v in row)
                     + "\n")
    csv = str(tmp_path / "a.csv")
    with open(csv, "w") as fh:
        fh.write("lab,f1,f2,f3\n")
        for row, lab in zip(X, y):
            fh.write("%g," % lab + ",".join(repr(float(v)) for v in row) + "\n")
    na = str(tmp_path / "na.csv")
    with open(na, "w") as fh:
        fh.write("1,NA,2.5,\n0,nan,null,3\n1,N/A,NaN,4.25\n")
    svm = str(tmp_path / "a.svm")
    with open(svm, "w") as fh:
        fh.write("1 0:0.5 2:1.5\n0 1:2.0\n\n1 3:-1e-3\n")
    return {"tsv": tsv, "csv": csv, "na": na, "libsvm": svm}


@pytest.mark.parametrize("kind", ["tsv", "csv", "na", "libsvm"])
def test_parse_file_matches_jax(tmp_path, pandas_mode, kind):
    path = _write_files(tmp_path)[kind]
    assert pparser.detect_format(path) == jparser.detect_format(path)
    want_fmt = {"na": "csv"}.get(kind, kind)
    assert pparser.detect_format(path)[0] == want_fmt
    for label_idx in (0, -1):
        got = pparser.parse_file(path, label_idx=label_idx)
        if kind == "na" and pandas_mode == "no_pandas":
            # the JAX package's np.loadtxt branch refuses NA tokens; the
            # port reads them as the pandas branch does
            continue
        want = jparser.parse_file(path, label_idx=label_idx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    feats, label, names = pparser.parse_file(path, label_idx=0)
    if kind == "csv":
        assert names == ["f1", "f2", "f3"]
    if pandas_mode == "no_pandas" and kind in ("csv", "tsv"):
        # numpy's and Python's float parsers round correctly (pandas' C
        # reader may differ in the last bit)
        np.testing.assert_array_equal(
            feats, np.arange(12, dtype=float).reshape(4, 3) / 7.0)
    if kind == "na":
        nan = np.nan
        np.testing.assert_array_equal(
            feats, [[nan, 2.5, nan], [nan, nan, 3.0], [nan, nan, 4.25]])
        np.testing.assert_array_equal(label, [1, 0, 1])
    if kind == "libsvm":
        np.testing.assert_array_equal(label, [1, 0, 1])
        assert feats.shape == (3, 4)
    assert pparser.sniff_header(path) == jparser.sniff_header(path)


@pytest.mark.parametrize("kind", ["tsv", "csv", "libsvm"])
def test_stream_and_sample_match_jax(tmp_path, pandas_mode, kind):
    path = _write_files(tmp_path)[kind]
    cols = 4 if kind == "libsvm" else None
    for kw in ({}, {"skip_rows": 1, "max_rows": 2}):
        got = list(pparser.stream_file(path, 2, num_cols=cols, **kw))
        want = list(jparser.stream_file(path, 2, num_cols=cols, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert pparser.count_data_rows(path) == jparser.count_data_rows(path)
    for a, b in zip(pparser.hash_sample_lines(path, 2, 5),
                    jparser.hash_sample_lines(path, 2, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pparser.sample_stream(path, 2, 5),
                    jparser.sample_stream(path, 2, 5)):
        np.testing.assert_array_equal(a, b)


# ---- one-shot loads ----


def test_side_files(tmp_path, pandas_mode):
    X = np.random.RandomState(1).normal(size=(100, 3))
    path = _write_csv(tmp_path / "d.train", X, np.zeros(100))
    np.savetxt(path + ".weight", np.full(100, 2.0))
    np.savetxt(path + ".query", np.full(10, 10), fmt="%d")
    np.savetxt(path + ".init", np.linspace(-1, 1, 100))
    got, want = load_both(path)
    assert got.num_data == 100
    assert len(got.metadata.query_boundaries) == 11
    np.testing.assert_array_equal(got.metadata.weights, np.full(100, 2.0))
    assert_same_dataset(got, want)


EXAMPLES = [("binary_classification", "binary.train", {}),
            ("regression", "regression.train", {}),
            ("multiclass_classification", "multiclass.train", {}),
            ("lambdarank", "rank.train", {}),
            ("regression", "regression.train",
             {"forcedbins_filename": os.path.join(DATA, "regression",
                                                  "forced_bins.json")})]


@pytest.mark.parametrize("case", range(len(EXAMPLES)))
def test_example_files_match_jax(pandas_mode, case):
    d, f, kw = EXAMPLES[case]
    path = os.path.join(DATA, d, f)
    got, want = load_both(path, max_bin=255, bin_construct_sample_cnt=200000,
                          **kw)
    assert_same_dataset(got, want)
    valid = path.replace(".train", ".test")
    vgot, vwant = load_both(valid, reference=(got, want), max_bin=255, **kw)
    assert_same_dataset(vgot, vwant)
    pc, jc = _cfgs()
    np.testing.assert_array_equal(
        DatasetLoader(pc).load_prediction_data(valid),
        JLoader(jc).load_prediction_data(valid))


def test_columns_by_name_and_categorical(tmp_path, pandas_mode):
    x, y = _table()
    path = str(tmp_path / "h.csv")
    with open(path, "w") as fh:
        fh.write("y,a,b,c,d,w,q\n")
        for lab, row in zip(y, x):
            fh.write("%.17g," % lab + ",".join("%.17g" % v for v in row) + "\n")
    kw = dict(label_column="name:y", weight_column="name:w",
              group_column="name:q", ignore_column="name:d",
              categorical_feature="name:c")
    got, want = load_both(path, **kw)
    assert got.num_total_features == 3
    assert list(got.feature_names) == ["a", "b", "c"]
    assert_same_dataset(got, want)


def test_binary_round_trip(tmp_path, pandas_mode):
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    got, want = load_both(path, save_binary=True)
    back = DatasetLoader(_cfgs()[0]).load_from_file(path + ".bin")
    assert_same_dataset(back, got, raw=False)
    assert_same_dataset(back, JLoader(_cfgs()[1]).load_from_file(
        path + ".bin"), raw=False)
    # a Dataset on the path loads through the loader too
    ds = Dataset(path + ".bin").construct()
    assert_same_dataset(ds.handle, back, raw=False)


def test_dataset_from_path(tmp_path, pandas_mode):
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    np.savetxt(path + ".weight", np.linspace(0.5, 2, N_ROWS))
    params = dict(max_bin=63, bin_construct_sample_cnt=200, verbosity=-1)
    train = Dataset(path, params=params).construct()
    assert_same_dataset(train.handle, load_both(path)[1])
    np.testing.assert_array_equal(
        train.get_weight(), np.linspace(0.5, 2, N_ROWS).astype(np.float32))
    label = np.arange(N_ROWS, dtype=np.float64)
    relabeled = Dataset(path, label=label, params=params).construct()
    np.testing.assert_array_equal(relabeled.get_label(), label)
    valid = Dataset(path, reference=train, params=params).construct()
    assert _mappers(valid.handle) == _mappers(train.handle)


# ---- streaming loads ----


@pytest.mark.parametrize("chunk_rows", [249, 250, 251])
@pytest.mark.parametrize("bundle", [True, False])
def test_streaming_equals_one_shot(tmp_path, pandas_mode, chunk_rows,
                                   bundle):
    # 250 divides 1000: the exact-boundary, short final chunk and
    # straddling layouts of pass 2
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    mem, _ = load_both(path, enable_bundle=bundle)
    got, want = load_both(path, enable_bundle=bundle,
                          data_chunk_rows=chunk_rows)
    assert got.raw_data is None
    assert_same_dataset(got, mem, raw=False)
    assert_same_dataset(got, want)


@pytest.mark.parametrize("path", [
    os.path.join(DATA, "regression", "regression.train"),
    os.path.join(DATA, "lambdarank", "rank.train")])
def test_two_round_matches_jax(pandas_mode, path, monkeypatch):
    monkeypatch.setattr(DatasetLoader, "_TWO_ROUND_CHUNK", 1024)
    monkeypatch.setattr(JLoader, "_TWO_ROUND_CHUNK", 1024)
    mem, _ = load_both(path, max_bin=255)
    got, want = load_both(path, max_bin=255, two_round=True)
    assert_same_dataset(got, mem, raw=False)
    assert_same_dataset(got, want)


def test_streaming_categorical_column(tmp_path, pandas_mode):
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    mem, _ = load_both(path, categorical_feature="2")
    got, want = load_both(path, categorical_feature="2", data_chunk_rows=333)
    assert_same_dataset(got, mem, raw=False)
    assert_same_dataset(got, want)


class _ThreadGather:
    """An allgather of ranks that run in threads: each round's writes land
    before the first barrier and its reads before the second."""

    def __init__(self, world):
        self.parts = [None] * world
        self.barrier = threading.Barrier(world)

    def for_rank(self, rank):
        def gather(payload):
            self.parts[rank] = payload
            self.barrier.wait()
            out = list(self.parts)
            self.barrier.wait()
            return out
        return gather


def _load_sharded(loader_cls, cfg, path, world=2):
    gather = _ThreadGather(world)
    shards, errs = [None] * world, []

    def run(rank):
        try:
            loader = loader_cls(cfg)
            loader.allgather_fn = gather.for_rank(rank)
            shards[rank] = loader.load_from_file(path, rank, world)
        except BaseException as exc:
            errs.append((rank, exc))
            gather.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return shards


def test_two_virtual_ranks(tmp_path, pandas_mode):
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    pc, jc = _cfgs(data_chunk_rows=170)
    serial = DatasetLoader(pc).load_from_file(path)
    shards = _load_sharded(DatasetLoader, pc, path)
    jshards = _load_sharded(JLoader, jc, path)
    digests = [ploader.schema_digest(s, total_rows=serial.num_data)
               for s in shards]
    assert digests[0] == digests[1] == ploader.schema_digest(serial)
    assert [s.shard["begin"] for s in shards] == [0, N_ROWS // 2]
    for s, j in zip(shards, jshards):
        assert s.shard == j.shard
        assert_same_dataset(s, j)
        assert _mappers(s) == _mappers(serial)
    np.testing.assert_array_equal(
        np.concatenate([s.binned for s in shards]), serial.binned)


def test_feature_sharded_bins_with_injected_allgather(tmp_path, pandas_mode):
    """One-shot load, two ranks: each finds the bins of its half of the
    features and the allgather merges them (dataset_loader.cpp:867-1044)."""
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    pc, jc = _cfgs()
    shards = _load_sharded(DatasetLoader, pc, path)
    jshards = _load_sharded(JLoader, jc, path)
    for s, j in zip(shards, jshards):
        assert_same_dataset(s, j)


def test_machines_without_allgather_bin_locally(tmp_path, pandas_mode):
    """num_machines > 1 and no allgather: one warning, bins from the
    rank's own rows (the JAX package's single-process branch)."""
    x, y = _table()
    path = _write_csv(tmp_path / "t.csv", x, y)
    pc, jc = _cfgs()
    from lightgbm_tpu_torch.utils.log import Log
    seen = []
    level = Log._level
    Log.reset_level(Log.Level.WARNING)
    Log.reset_callback(seen.append)
    try:
        got = DatasetLoader(pc).load_from_file(path, 1, 2)
    finally:
        Log.reset_callback(None)
        Log.reset_level(level)
    assert sum("locally" in m for m in seen) == 1
    assert got.num_data == N_ROWS // 2
    assert_same_dataset(got, JLoader(jc).load_from_file(path, 1, 2))
