"""The parallel learners' comm contract, the split pass's feature window,
``parallel/distdata.py`` and the loader's default allgather.

``tests/test_comm_contract.py`` reads the JAX learners' collectives from the
lowered HLO; the port has no HLO, so the contract is read from the counts
and records of ``parallel.comm.ProcessComm`` on d-rank gloo groups on the CPU
(``tests/torch_parallel_ranks.py``; the ranks never import ``jax``), on
``tests/test_parallel.py``'s problem (F = 11, 63 bins -> B = 64, 15 leaves):

- ``rs`` (``tree_learner=data``): one reduce-scatter of [F_pad, 2, B] into
  [F_pad/d, 2, B] at the root and one per split, one best-split all-gather
  per scan, one all-reduce of the root sums;
- ``feature``: no histogram collective, only the best-split all-gather, and
  every histogram (root and split pass) only F/d wide, from the rank's
  window;
- ``voting``: per scan an all-gather of the ``top_k`` ids and flags and an
  all-reduce of the ``2 * top_k`` elected features' histograms;
- quantized ``rs``: the reduce-scatter payload is the kernels' f32 integer
  sums (the JAX package sends bf16, which loses deep leaves' sums through
  the subtraction trick: ``core/tree_learner.py`` ``_Growth._reduce``).

The split pass's feature window (the scal row's trailing
``hist_feature_begin``) is held, on the plain version, against the JAX
package's ``partition_hist_xla`` histogram restricted to the window (the
rows and ``nl`` equal, the histogram within 1e-6 of its largest bin sum),
and in integer mode against the port's own no-window histogram (equal).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from lightgbm_tpu.core import partition as jax_part
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.core import partition as port_part
from lightgbm_tpu_torch.io.loader import DatasetLoader
from lightgbm_tpu_torch.parallel import distdata
from test_torch_partition import make_rows

DS = (2, 4)
B = 64
_RUNS = {}


def ranks(scenario, d, tmp_path_factory, arg=None):
    key = (scenario, d)
    if key not in _RUNS:
        out = str(tmp_path_factory.mktemp("%s_%d" % (scenario, d)))
        _RUNS[key] = R.spawn(scenario, d, out, out if arg is None else arg)
    return _RUNS[key]


def learner(d, tmp_path_factory, name, prec="exact"):
    return ranks("learners", d, tmp_path_factory)[0][(name, prec)]


def records(rec, kind):
    return [r for r in rec["records"] if r[0] == kind]


def scans(rec) -> int:
    """Split scans of a tree: the root, then one batch of two children per
    split."""
    return rec["num_leaves"]


@pytest.mark.parametrize("d", DS)
def test_rs_reduce_scatters_the_child_histograms(d, tmp_path_factory):
    rec = learner(d, tmp_path_factory, "data")
    fp = 11 + (-11) % d
    splits = rec["num_leaves"] - 1
    rs = records(rec, "reduce_scatter")
    assert len(rs) == 1 + splits
    assert rs[0][1:] == ((fp, 2, B), (fp // d, 2, B), "float32")
    for r in rs[1:]:
        assert r[1:] == ((1, fp, 2, B), (1, fp // d, 2, B), "float32")
    assert rec["bytes"]["reduce_scatter"] == (1 + splits) * fp * 2 * B * 4
    # one best-split all-gather per scan, and the rows' leaves at the end
    ag = records(rec, "all_gather")
    assert len(ag) == scans(rec) + 1
    assert ag[-1][1] == (rec["local_rows"],)
    assert rec["calls"]["all_reduce_sum"] == 1          # the root sums


@pytest.mark.parametrize("d", DS)
def test_rs_quantized_payload_is_f32(d, tmp_path_factory):
    rec = learner(d, tmp_path_factory, "data", "quantized")
    rs = records(rec, "reduce_scatter")
    assert rs and all(r[3] == "float32" for r in rs)
    fp = 11 + (-11) % d
    assert rec["bytes"]["reduce_scatter"] == len(rs) * fp * 2 * B * 4
    # the quantization scales: one max over the ranks
    assert rec["calls"]["all_reduce_max"] == 1


@pytest.mark.parametrize("d", DS)
def test_feature_mode_sends_only_best_splits(d, tmp_path_factory):
    rec = learner(d, tmp_path_factory, "feature")
    assert rec["calls"]["reduce_scatter"] == 0
    assert rec["calls"]["all_reduce_sum"] == 0
    assert rec["calls"]["all_gather"] == scans(rec)
    # each all-gather carries the 13 fields and B/32 bitset words in f64
    assert rec["bytes"]["all_gather"] == sum(
        int(np.prod(r[1])) * 8 for r in records(rec, "all_gather"))


@pytest.mark.parametrize("d", DS)
def test_feature_mode_histograms_are_its_window(d, tmp_path_factory):
    res = ranks("learners", d, tmp_path_factory)
    fp = 11 + (-11) % d
    for rank, r in enumerate(res):
        calls = r[("feature", "recorded")]["kernel_calls"]
        assert calls[0] == ("hist", rank * fp // d, (fp // d, 2, B))
        parts = [c for c in calls if c[0] == "part"]
        assert len(parts) == r[("feature", "recorded")]["num_leaves"] - 1
        for c in parts:
            # the scal row's trailing hist_feature_begin, F/d columns
            assert c[1:] == (rank * fp // d, 12 + B // 32 + 1,
                             (fp // d, 2, B))


@pytest.mark.parametrize("d", DS)
def test_voting_elects_and_sums_2_top_k(d, tmp_path_factory):
    rec = learner(d, tmp_path_factory, "voting")
    top_k = 5
    ag = records(rec, "all_gather")[:-1]      # the last: the rows' leaves
    ar = [r for r in records(rec, "all_reduce_sum") if len(r[1]) >= 3]
    assert len(ag) == len(ar) == scans(rec)
    assert ag[0][1] == (top_k, 2) and ag[0][2] == (d, top_k, 2)
    for r in ag[1:]:
        assert r[1] == (2, top_k, 2)
    assert ar[0][1] == (2 * top_k, 2, B)
    for r in ar[1:]:
        assert r[1] == (2, 2 * top_k, 2, B)


@pytest.mark.parametrize("d", DS)
def test_psum_all_reduces_whole_histograms(d, tmp_path_factory):
    rec = learner(d, tmp_path_factory, "psum")
    ar = [r for r in records(rec, "all_reduce_sum") if len(r[1]) >= 3]
    assert len(ar) == rec["num_leaves"]
    assert ar[0][1] == (11, 2, B)
    assert rec["calls"]["reduce_scatter"] == 0


# ---- the split pass's feature window ----

WINDOW_CASES = [(28, 0, 14), (28, 14, 14), (28, 5, 1), (9, 3, 6)]


@pytest.mark.parametrize("F,f0,fw", WINDOW_CASES)
def test_feature_window_matches_jax_restricted(F, f0, fw):
    rows, voff = make_rows(2500, F, B, seed=3)
    for wb, wc in [(0, 0), (100, 900), (0, 2500), (2499, 1)]:
        head = [wb, wc, 2, B // 3, 1, 1, B, 0, 0, (wb + wc) % 2, 0, 0]
        scal = head + [0] * (B // 32)
        want_rows, want_hist, want_nl = jax_part.partition_hist_xla(
            jnp.asarray(rows), jnp.asarray(scal, jnp.int32), num_features=F,
            num_bins=B, voff=voff)
        got_rows, got_hist, got_nl = port_part.partition_hist(
            torch.from_numpy(rows.copy()), scal + [f0], num_features=fw,
            num_bins=B, voff=voff)
        np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
        assert int(got_nl[0]) == int(want_nl)
        want = np.asarray(want_hist, np.float64)[f0:f0 + fw]
        assert got_hist.shape == want.shape
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got_hist.numpy() - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("F,f0,fw", WINDOW_CASES)
def test_feature_window_integer_equals_no_window(F, f0, fw):
    rows, voff = make_rows(2500, F, B, seed=4)
    gh = np.random.RandomState(5).randint(-127, 128, size=(2500, 2))
    gh[:, 1] = np.abs(gh[:, 1])
    rows[:, voff:voff + 8] = gh.astype("<f4").view(np.uint8)
    scal = [100, 2000, 1, B // 2, 0, 0, B, 0, 0, 1, 0, 0] + [0] * (B // 32)
    kw = dict(num_bins=B, voff=voff, quantized=True)
    r_all, h_all, nl_all = port_part.partition_hist(
        torch.from_numpy(rows.copy()), scal, num_features=F, **kw)
    r_win, h_win, nl_win = port_part.partition_hist(
        torch.from_numpy(rows.copy()), scal + [f0], num_features=fw, **kw)
    assert torch.equal(r_win, r_all) and torch.equal(nl_win, nl_all)
    assert torch.equal(h_win, h_all[f0:f0 + fw])


def test_feature_window_checks():
    rows, voff = make_rows(64, 6, B)
    scal = [0, 10, 0, 3, 0, 0, B, 0, 0, 1, 0, 0] + [0] * (B // 32)
    with pytest.raises(ValueError, match="with the feature window"):
        port_part.partition_hist(torch.from_numpy(rows), scal + [0, 0],
                                 num_features=6, num_bins=B, voff=voff)
    with pytest.raises(ValueError, match="outside the bin columns"):
        port_part.check_feature_window(4, 6, voff, 1, False)
    port_part.check_feature_window(2, 4, voff, 1, False)


# ---- the comm's collectives, distdata, the loader's allgather ----

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    rng = np.random.RandomState(17)
    X = rng.normal(size=(3001, 5)).round(4)
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = (X[:, 0] > 0).astype(float)
    with open(d / "train.csv", "w") as fh:
        for yi, row in zip(y, X):
            fh.write(",".join(["%g" % yi] + ["" if np.isnan(v) else "%g" % v
                                             for v in row]) + "\n")
    return str(d)


def canon(mappers) -> str:
    """Mapper dicts as text (their NaN bin bounds compare equal there)."""
    return json.dumps(mappers, sort_keys=True)


def comm_runs(d, tmp_path_factory, data_dir):
    return ranks("comm_and_data", d, tmp_path_factory, arg=data_dir)


@pytest.mark.parametrize("d", DS)
def test_comm_collectives(d, tmp_path_factory, data_dir):
    res = comm_runs(d, tmp_path_factory, data_dir)
    x = np.arange(6, dtype=np.float32)
    for rank, r in enumerate(res):
        assert r["pod"] == (rank, d)
        np.testing.assert_array_equal(r["sum"], d * x + sum(range(d)))
        np.testing.assert_array_equal(r["max"], x + d - 1)
        h = np.arange(4 * d * 2 * 3, dtype=np.float32).reshape(4 * d, 2, 3)
        full = h * sum(k + 1 for k in range(d))
        np.testing.assert_array_equal(r["rs"], full[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(
            r["gather"], np.repeat(np.arange(d, dtype=np.float32)[:, None],
                                   6, 1)[:, None, :])
        assert r["bytes"] == [b"r%d" % k + b"x" * k for k in range(d)]
        assert r["default_allgather"] == [b"rank%d" % k for k in range(d)]
        assert r["summary"]["all_gather_bytes"]["calls"] == 1
        assert r["default_group"]
        assert r["subgroup_size"] == (1 if rank == 0 else None)


@pytest.mark.parametrize("d", DS)
def test_loader_default_allgather_bins_like_serial(d, tmp_path_factory,
                                                   data_dir):
    """num_machines = d under the group, no injected allgather: the
    feature-sharded bin finding merges every rank's mappers through the
    group's bytes allgather, and they equal a serial load's."""
    res = comm_runs(d, tmp_path_factory, data_dir)
    serial = DatasetLoader(Config(max_bin=63, verbosity=-1)).load_from_file(
        data_dir + "/train.csv")
    want = canon([m.to_dict() for m in serial.bin_mappers])
    for r in res:
        assert canon(r["mappers"]) == want
        assert r["num_data"] == serial.num_data


@pytest.mark.parametrize("d", DS)
def test_streaming_stripes_agree(d, tmp_path_factory, data_dir):
    """The striped streaming scan: each rank bins its stripe, the schema
    digest is agreed over the group, and the stripes' rows are the serial
    streaming load's."""
    res = comm_runs(d, tmp_path_factory, data_dir)
    serial = DatasetLoader(Config(max_bin=63, verbosity=-1,
                                  data_chunk_rows=500)).load_from_file(
        data_dir + "/train.csv")
    total = serial.num_data
    for rank, r in enumerate(res):
        b, e = distdata.stripe_bounds(total, rank, d)
        assert r["stream_shard"] == {"rank": rank, "num_machines": d,
                                     "begin": b, "end": e, "num_total": total}
        assert r["stream_digest"] == res[0]["stream_digest"]
        assert canon(r["stream_mappers"]) == canon(res[0]["stream_mappers"])
    np.testing.assert_array_equal(
        np.concatenate([r["stream_binned"] for r in res]),
        np.asarray(serial.binned))


@pytest.mark.parametrize("d", DS)
def test_schema_mismatch_raises(d, tmp_path_factory, data_dir):
    for r in comm_runs(d, tmp_path_factory, data_dir):
        assert "schema digest mismatch" in r["mismatch"]


def test_stripe_bounds_tile_the_rows():
    for n, d in [(10, 3), (4003, 4), (7, 8), (0, 2)]:
        bounds = [distdata.stripe_bounds(n, r, d) for r in range(d)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert max(e - b for b, e in bounds) - min(e - b for b, e in
                                                   bounds) <= 1


def test_pod_info_without_a_group():
    assert distdata.pod_info() == (0, 1)
    assert distdata.shard_of(object()) is None


def test_schema_digest_matches_the_jax_package(data_dir):
    """One digest for one binned file in both packages (the same mapper CRC,
    group layout and row count)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.loader import DatasetLoader as JLoader
    from lightgbm_tpu.parallel import distdata as jdist
    path = data_dir + "/train.csv"
    port = DatasetLoader(Config(max_bin=63, verbosity=-1)).load_from_file(
        path)
    ref = JLoader(JConfig(max_bin=63, verbosity=-1)).load_from_file(path)
    assert distdata.schema_digest(port) == jdist.schema_digest(ref)
    assert distdata.schema_digest(port, total_rows=9) != \
        distdata.schema_digest(port)


# ---- the kernels' C signatures ----

def _c_params(source: str, fn: str) -> int:
    """Parameters of ``extern "C" int fn(...)`` in a CUDA source."""
    head = 'extern "C" int %s(' % fn
    body = source[source.index(head) + len(head):]
    return len(body[:body.index(")")].split(","))


@pytest.mark.parametrize("library", ["histogram", "partition",
                                     "histogram_int", "partition_level",
                                     "histogram_masked"])
def test_kernel_signatures_match_the_sources(library):
    """The ctypes argument lists (``kernels.SIGNATURES``) have as many
    entries as the C entry points have parameters: a missing one shifts
    every later argument (the split pass's ``f_begin`` is one)."""
    import os

    from lightgbm_tpu_torch import kernels
    path = os.path.join(os.path.dirname(kernels.__file__), os.pardir, "csrc",
                        library + ".cu")
    with open(path) as fh:
        source = fh.read()
    for fn, argtypes in kernels.SIGNATURES[library].items():
        assert _c_params(source, fn) == len(argtypes), fn
