"""The leaf-wise tree build on the device (``core/tree_learner.py``
``_DeviceGrowth``) against the host loop (``_Growth``), the JAX package's
``build_tree_partitioned`` and its own pieces, on the CPU.

The device build is the JAX build's loop: L - 1 steps that keep the tree's
state in tensors, read nothing back between splits, and bring the tree back
in one transfer.  The host loop reads each split's results back and does the
bookkeeping in numpy f32.  Both do the same f32 operations in the same
order, so on the same gradients they must give the same bytes in every
``TreeArrays`` field and the same ``row_leaf`` (and, on the fused chunk's
carried store, the same store; with lazy CEGB the same paid bits; under
the histogram pool the same rebuilt parents).  Every leaf-wise option
grows on the device: forced splits, CEGB (split, coupled, lazy) and the
pool, held to the host loop and to the JAX build; the histogram with its
window in device memory (the pool's rebuild) and the split pass with the
feature window are held, on their plain versions, to the host-window
launches.  Inputs: 3,000 rows made from a numpy seed, 63 bins, 8-31
leaves, one torch thread.
"""
import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.tree_learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu_torch import BinnedDataset, Config
from lightgbm_tpu_torch import device as D
from lightgbm_tpu_torch.convert import dataset_from_arrays
from lightgbm_tpu_torch.core import tree_learner as tl
from lightgbm_tpu_torch.core.partition import (partition_hist,
                                               partition_hist_plain,
                                               partition_hist_window,
                                               partition_hist_window_plain)
from lightgbm_tpu_torch.obs import launches
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import PARAMS as TRAIN_PARAMS
from test_torch_train import leaf_value_tolerance

N = 3000
BASE = dict(num_leaves=31, min_data_in_leaf=5, max_bin=63, verbosity=-1)


def dense(seed=0, f=8):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, f))
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3) + X[:, 2] * X[:, 3]
         + rng.normal(scale=0.1, size=N))
    return X, y


def categorical(seed=1):
    """A 4-category column (one-hot scan at max_cat_to_onehot=4) and a
    12-category one (many-vs-many), skewed so that no two categories have
    equal counts, and two numerical columns."""
    rng = np.random.RandomState(seed)
    c4 = rng.choice(4, size=N, p=[0.4, 0.3, 0.2, 0.1])
    c12 = rng.choice(12, size=N, p=np.sort(rng.dirichlet(np.ones(12)))[::-1])
    num = rng.normal(size=(N, 2))
    y = (1.5 * np.isin(c12, [0, 3, 7]) + 0.7 * (c4 == 2) + num[:, 0]
         - 0.5 * num[:, 1] + rng.normal(scale=0.2, size=N))
    return np.column_stack([c4, c12, num]).astype(np.float64), y


def bundled(seed=2):
    """Three exclusive one-hot blocks of 8 columns (EFB bundles them) and
    two numerical columns, as scipy CSR."""
    rng = np.random.RandomState(seed)
    cols, lv = [], []
    for _ in range(3):
        v = rng.choice(8, size=N, p=np.sort(rng.dirichlet(np.ones(8)))[::-1])
        lv.append(v)
        cols.append(np.eye(8)[v])
    num = rng.normal(size=(N, 2))
    X = np.column_stack(cols + [num])
    y = ((lv[0] % 3 == 0) + 0.5 * (lv[1] > 4) + num[:, 0]
         + rng.normal(scale=0.3, size=N))
    return sps.csr_matrix(X), y


def l2_grads(y):
    return ((-(y - y.mean())).astype(np.float32), np.ones(N, np.float32))


def binary_grads(y):
    p = np.full(N, 0.5)
    yb = (y > np.median(y)).astype(np.float64)
    return ((p - yb).astype(np.float32), (p * (1 - p)).astype(np.float32))


def multiclass_grads(y, k=1, K=3):
    """Class k's softmax gradients at a zero score (LightGBM's hessian
    factor K / (K - 1))."""
    cls = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3]))
    p = np.full(N, 1.0 / K)
    g = p - (cls == k)
    h = K / (K - 1.0) * p * (1 - p)
    return g.astype(np.float32), h.astype(np.float32)


def coupled(seed=6):
    """test_torch_forced_cegb.py's coupled-refund problem: 4 features, the
    label a sine of the first."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, 4)).astype(np.float32)
    y = np.sin(2 * X[:, 0]) * 2 + 0.2 * X[:, 1] + rng.normal(scale=0.2,
                                                             size=N)
    return X, y


# forced-split schedules (BFS JSON, LightGBM's forcedsplits_filename): three
# splits whose third entry cannot split (every row goes left), which
# switches the rest off; three whose third lies at depth 2, under
# max_depth=2; and, on bundled data, a numerical root whose children split
# on one-hot columns that EFB bundled
FORCED_FAIL = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.0},
               "right": {"feature": 2, "threshold": 1e6}}
FORCED_DEPTH = {"feature": 0, "threshold": 0.0,
                "left": {"feature": 1, "threshold": 0.0,
                         "left": {"feature": 2, "threshold": 0.0}}}
FORCED_EFB = {"feature": 24, "threshold": 0.0,
              "left": {"feature": 1, "threshold": 0.0},
              "right": {"feature": 9, "threshold": 0.0}}

CASES = {
    "binary": (dense, binary_grads, {}),
    "l2": (dense, l2_grads, {}),
    "multiclass": (dense, multiclass_grads,
                   dict(objective="multiclass", num_class=3)),
    "quantized": (dense, binary_grads, dict(hist_precision="quantized")),
    "bagging": (dense, l2_grads, {}),
    "monotone": (dense, l2_grads,
                 dict(monotone_constraints=[1, -1, 0, 0, 0, 0, 0, 0])),
    "extra_trees": (dense, l2_grads, dict(extra_trees=True)),
    "onehot": (categorical, l2_grads, dict(categorical_feature=[0])),
    "many_vs_many": (categorical, l2_grads,
                     dict(categorical_feature=[1], max_cat_to_onehot=2)),
    "efb": (bundled, l2_grads, {}),
    "max_depth_3": (dense, l2_grads, dict(max_depth=3)),
    "stops_early": (dense, l2_grads, dict(min_data_in_leaf=400)),
    "two_leaves": (dense, l2_grads, dict(num_leaves=2)),
    "carried": (dense, l2_grads, {}),
    "forced": (dense, l2_grads, dict(forced=FORCED_FAIL)),
    "forced_max_depth": (dense, l2_grads, dict(forced=FORCED_DEPTH,
                                               max_depth=2)),
    "forced_efb": (bundled, l2_grads, dict(forced=FORCED_EFB)),
    "cegb_split": (dense, l2_grads, dict(cegb_penalty_split=0.002)),
    "cegb_coupled": (coupled, l2_grads,
                     dict(num_leaves=15,
                          cegb_penalty_feature_coupled=[3.0] * 4)),
    "cegb_lazy": (dense, l2_grads,
                  dict(cegb_penalty_feature_lazy=[0.05] * 8,
                       cegb_penalty_feature_coupled=[1.0] * 8)),
    "pool": (dense, l2_grads, dict(histogram_pool_size=0.02)),
    "pool_quantized": (dense, binary_grads,
                       dict(histogram_pool_size=0.02,
                            hist_precision="quantized")),
}
# the leaf-wise options that grew in the host loop before the device build
# took them
OPTIONS = ("forced", "forced_max_depth", "forced_efb", "cegb_split",
           "cegb_coupled", "cegb_lazy", "pool", "pool_quantized")


def port_dataset(make, extra):
    X, y = make()
    if sps.issparse(X):
        ds = BinnedDataset.from_csr(X.indptr, X.indices, X.data, X.shape[1],
                                    label=y, max_bin=63)
        assert ds.is_bundled
        return ds, y
    cats = extra.get("categorical_feature", ())
    return BinnedDataset.from_matrix(X, label=y, max_bin=63,
                                     categorical_feature=cats), y


def case_params(name, tmp=None) -> dict:
    """The case's learner parameters; a forced schedule is written to
    ``tmp`` / forced.json."""
    extra = dict(CASES[name][2])
    extra.pop("categorical_feature", None)
    spec = extra.pop("forced", None)
    if spec is not None:
        path = tmp / "forced.json"
        path.write_text(json.dumps(spec))
        extra["forcedsplits_filename"] = str(path)
    return dict(BASE, **extra)


def setup(name, tmp=None):
    make, grads, extra = CASES[name]
    ds, y = port_dataset(make, extra)
    learner = tl.SerialTreeLearner(ds, Config(**case_params(name, tmp)),
                                   device="cpu")
    g, h = (torch.from_numpy(a) for a in grads(y))
    count = N
    if name == "bagging":
        # the fused chunk's in-bag count: a device scalar, never read
        bag = torch.from_numpy(np.random.RandomState(3).uniform(size=N)
                               < 0.7)
        g, h = g * bag, h * bag
        count = bag.sum()
    return ds, learner, g, h, count


def grow(name, learner, g, h, count, **kw):
    if name == "carried":
        rng = np.random.RandomState(4)
        aux, score = (torch.from_numpy(rng.normal(size=N).astype(np.float32))
                      for _ in range(2))
        return learner.train(g, h, count, carried=True, extra=(aux, score),
                             score_rate=0.1, **kw)
    return learner.train(g, h, count, **kw)


HOST_ONLY = ("row_leaf", "host_fetches", "split_passes")


def assert_same_tree(got, want):
    for field in tl.TreeArrays._fields:
        if field in HOST_ONLY + ("paid_bits",):
            continue
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert torch.equal(got.row_leaf, want.row_leaf)
    assert (got.paid_bits is None) == (want.paid_bits is None)
    if got.paid_bits is not None:
        assert torch.equal(got.paid_bits, want.paid_bits)


def _promotions(monkeypatch):
    """Count the leaves whose cached best a coupled refund replaced (a spy
    on ``_DeviceGrowth._refund``)."""
    promoted = []
    refund = tl._DeviceGrowth._refund

    def spy(self, fid, ok):
        before = self.best[:self.L].clone()
        refund(self, fid, ok)
        promoted.append(int((self.best[:self.L] != before).any(1).sum()))
    monkeypatch.setattr(tl._DeviceGrowth, "_refund", spy)
    return promoted


@pytest.mark.parametrize("name", list(CASES))
def test_device_build_equals_host_loop(name, one_thread, tmp_path,
                                       monkeypatch):
    """Byte-equal trees, row_leaf, paid bits, pool misses and (carried)
    store: the device build and the host loop on the same gradients (with
    CEGB, each from a fresh learner, whose state a tree changes)."""
    promoted = _promotions(monkeypatch)
    _, learner, g, h, count = setup(name, tmp_path)
    got = grow(name, learner, g, h, count)
    if learner.cegb is not None:
        learner = setup(name, tmp_path)[1]
    want = grow(name, learner, g, h, count, host_loop=True)
    if name == "carried":
        (got, got_rows), (want, want_rows) = got, want
        assert got.row_leaf.numel() == 0
        assert torch.equal(got_rows, want_rows)
    assert_same_tree(got, want)
    assert got.host_fetches == 1
    assert got.split_passes == learner.num_leaves - 1
    # one a split (and the root), and in the host loop one more a forced
    # entry it scans and a coupled refund
    if learner.forced is not None or learner.cegb is not None:
        assert want.host_fetches > want.num_leaves
    else:
        assert want.host_fetches == want.num_leaves
    if name == "stops_early":
        # the dead steps ran and changed nothing
        assert got.num_leaves < learner.num_leaves - 1
    if name in ("binary", "two_leaves"):
        assert got.num_leaves == learner.num_leaves
    if name.startswith("forced"):
        # the applied entries, then the schedule switched off
        sched = learner.forced
        applied = 3 if name == "forced_efb" else 2
        np.testing.assert_array_equal(got.split_feature[:applied],
                                      sched[1][:applied])
        np.testing.assert_array_equal(got.threshold_bin[:applied],
                                      sched[2][:applied])
        assert got.num_leaves >= 4
    if name == "forced_max_depth":
        assert got.leaf_depth[:got.num_leaves].max() <= 2
    if name == "cegb_coupled":
        assert sum(promoted) > 0
    if name == "cegb_lazy":
        assert got.paid_bits.any()
    if name.startswith("pool"):
        assert learner.hist_pool_slots < learner.num_leaves
        assert got.pool_misses > 0


@pytest.mark.parametrize("name", ["binary", "onehot", "many_vs_many", "efb",
                                  "max_depth_3"])
def test_row_leaf_equals_routing_the_bins(name, one_thread):
    """The per-row leaf from the window marks and the forward fill equals
    routing every row's bins through the tree (``route_binned``)."""
    ds, learner, g, h, count = setup(name)
    arrays = grow(name, learner, g, h, count)
    bins = torch.from_numpy(np.asarray(learner._route_matrix(ds)
                                       ).astype(np.int64))
    assert arrays.num_leaves > 2
    assert torch.equal(tl.route_binned(bins, arrays, learner.feat_host),
                       arrays.row_leaf)


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_device_build_matches_jax_build(precision, one_thread):
    """The device build against the JAX package's build_tree_partitioned
    (its XLA path) on the same bins and gradients: equal splits, leaf counts
    and row_leaf, leaf values within test_torch_train's bound."""
    X, y = dense(seed=5)
    g, h = binary_grads(y)
    params = dict(BASE, hist_precision=precision)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref = JaxLearner(ref_ds, JaxConfig(**params))
    want = jax.tree_util.tree_map(np.asarray, ref.train(
        jnp.asarray(g), jnp.asarray(h), N))
    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y,
        mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    learner = tl.SerialTreeLearner(ds, Config(**params), device="cpu")
    got = learner.train(torch.from_numpy(g), torch.from_numpy(h), N)
    nl = int(want.num_leaves)
    assert got.num_leaves == nl == BASE["num_leaves"]
    for field in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_parent", "leaf_depth"):
        np.testing.assert_array_equal(getattr(got, field)[:nl],
                                      getattr(want, field)[:nl],
                                      err_msg=field)
    np.testing.assert_array_equal(got.leaf_count[:nl], want.leaf_count[:nl])
    np.testing.assert_array_equal(got.row_leaf.numpy(), want.row_leaf[:N])
    # binary gradients (|g| <= 1, h = 1/4), the leaf values shrunk by
    # test_torch_train's learning rate, as its bound takes them
    lr = TRAIN_PARAMS["learning_rate"]
    tree = type("T", (), dict(num_leaves=nl, leaf_value=lr * want.leaf_value,
                              leaf_weight=want.leaf_weight,
                              leaf_depth=want.leaf_depth))
    np.testing.assert_array_less(
        lr * np.abs(got.leaf_value[:nl] - want.leaf_value[:nl]),
        leaf_value_tolerance(tree, N))


WINDOWS = {"root": (0, N), "middle": (700, 1300), "tail": (2950, 50),
           "empty": (1200, 0)}


def scal_row(wb, wc, learner, feature, threshold, left_side, num_bins):
    row = np.zeros(12 + num_bins // 32, np.int64)
    row[:12] = tl.scal_table(learner.feat_host)[feature]
    row[0], row[1], row[3], row[4], row[9] = wb, wc, threshold, 1, left_side
    return row


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_window_pass_equals_host_window_pass(window, precision):
    """The device-window split pass's plain version (the scal row a CPU
    int32 tensor) equals ``partition_hist_plain`` with a host scal row:
    the store, the child histogram and nl; ``wc = 0`` leaves the store as it
    is, with a zero histogram and nl = 0."""
    ds, learner, g, h, _ = setup("l2")
    if precision == "quantized":
        g, h = torch.round(g * 40), torch.round(h * 7)
    rows = tl.fill_gradients(learner.template, learner.layout, g, h)
    wb, wc = WINDOWS[window]
    kw = dict(num_features=learner.hist_columns, num_bins=learner.num_bins,
              voff=learner.layout.voff, quantized=precision == "quantized")
    for feature, threshold, side in ((0, 30, 1), (3, 12, 0)):
        scal = scal_row(wb, wc, learner, feature, threshold, side,
                        learner.num_bins)
        want_rows, want_hist, want_nl = partition_hist_plain(
            rows, scal.tolist(), **kw)
        got_rows = rows.clone()
        got_hist, got_nl = partition_hist_window_plain(
            got_rows, torch.from_numpy(scal).to(torch.int32), **kw)
        assert torch.equal(got_rows, want_rows)
        assert torch.equal(got_hist, want_hist)
        assert torch.equal(got_nl, want_nl)
        # the dispatcher takes the plain version for a CPU tensor
        again = rows.clone()
        hist, nl = partition_hist_window(
            again, torch.from_numpy(scal).to(torch.int32), None, **kw)
        assert torch.equal(again, want_rows) and torch.equal(hist, want_hist)
        if wc == 0:
            assert torch.equal(got_rows, rows) and int(got_nl) == 0
            assert not got_hist.any()
        else:
            assert 0 < int(got_nl) < wc
            # equal to the host-window dispatcher too
            r2, h2, n2 = partition_hist(rows.clone(), scal.tolist(), **kw)
            assert torch.equal(r2, want_rows) and torch.equal(h2, want_hist)


def test_device_build_reads_back_once_a_tree(one_thread):
    """A GBDT's trees through the device build: one device->host transfer
    each, L - 1 split passes each (dead steps included), and the launch
    accounting (obs.launches) records exactly that."""
    from lightgbm_tpu_torch import GBDT, create_objective
    X, y = dense(seed=6)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    cfg = Config(**dict(BASE, objective="regression", min_data_in_leaf=150))
    b = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
             device="cpu")
    fetched, passes = [], []
    real = b.learner.train

    def counted(*a, **k):
        out = real(*a, **k)
        arrays = out[0] if k.get("carried") else out
        fetched.append(arrays.host_fetches)
        passes.append(arrays.split_passes)
        return out
    b.learner.train = counted
    launches.reset()
    for _ in range(3):
        b.train_one_iter()
    L = cfg.num_leaves
    assert fetched == [1, 1, 1] and passes == [L - 1] * 3
    assert launches.counts() == {"leaf": 3 * (L - 1)}
    assert any(t.num_leaves < L for t in b.models)
    # nothing launches on the CPU: the kernels' counters stay 0
    assert D.launches()["partition"] == 0


class _OneRank:
    """A parallel learner's collectives over one rank: each is the
    identity, so a ``psum`` build grows the serial tree."""

    def all_reduce_sum(self, t):
        return t


def _built_on_device(monkeypatch):
    used = []
    real = tl._DeviceGrowth.grow

    def spy(self):
        used.append(True)
        return real(self)
    monkeypatch.setattr(tl._DeviceGrowth, "grow", spy)
    return used


@pytest.mark.parametrize("case", ["forced", "cegb", "pool", "level",
                                  "parallel", "host_loop", "serial"])
def test_which_build_runs(case, monkeypatch, tmp_path, one_thread):
    """Every tree grows on the device, with one read-back a tree:
    serial, forced splits, CEGB, the histogram pool, a parallel learner's
    comm and level growth alike; a serial tree that a check sends to the
    host loop (``host_loop``, one read-back a split) grows there.  Only the
    device build asks the learner for its split-pass workspace (a
    bound-sized store on the card; level growth its level-pass workspace),
    so the host loop holds no such buffer."""
    X, y = dense(seed=7)
    g, h = (torch.from_numpy(a) for a in l2_grads(y))
    extra = {}
    if case == "forced":
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 0, "threshold": 0.0}')
        extra = dict(forcedsplits_filename=str(path))
    elif case == "cegb":
        extra = dict(cegb_penalty_split=0.01)
    elif case == "pool":
        extra = dict(histogram_pool_size=0.01)
    elif case == "level":
        extra = dict(tree_grow_mode="level")
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    learner = tl.SerialTreeLearner(ds, Config(**dict(BASE, **extra)),
                                   device="cpu")
    used = _built_on_device(monkeypatch)
    work = []
    real_work, real_level = learner.window_work, learner.level_work

    def window_work(rows, bound):
        work.append(bound)
        return real_work(rows, bound)

    def level_work(rows, bound):
        work.append(("level", bound))
        return real_level(rows, bound)
    monkeypatch.setattr(learner, "window_work", window_work)
    monkeypatch.setattr(learner, "level_work", level_work)
    if case == "parallel":
        learner.comm = tl.Comm(ops=_OneRank(), mode="psum")
    arrays = learner.train(g, h, N, host_loop=case == "host_loop")
    on_device = case != "host_loop"
    assert bool(used) == on_device
    assert work == ([("level", N)] if case == "level"
                    else [N] if on_device else [])
    if on_device:
        assert arrays.host_fetches == 1
        assert arrays.num_leaves > 2
    else:
        assert arrays.host_fetches >= arrays.num_leaves > 2
    if case == "parallel":
        learner.comm = None
        serial = learner.train(g, h, N)
        assert_same_tree(arrays, serial)


def _jax_tree(ref_ds, params, g, h):
    ref = JaxLearner(ref_ds, JaxConfig(**params))
    return jax.tree_util.tree_map(np.asarray, ref.train(
        jnp.asarray(g), jnp.asarray(h), N))


@pytest.mark.parametrize("name", OPTIONS)
def test_options_match_jax_build(name, tmp_path, one_thread):
    """Forced splits, CEGB and the pool through the device build against
    the JAX package's build_tree_partitioned on the same bins and
    gradients: equal splits, structure, leaf counts and row_leaf, leaf
    values within test_torch_forced_cegb's L2 bound (the quantized pool:
    test_torch_train's bound on binary gradients, as
    test_device_build_matches_jax_build holds them)."""
    from test_torch_forced_cegb import l2_leaf_tolerance
    make, grads, extra = CASES[name]
    X, y = make()
    g, h = grads(y)
    params = case_params(name, tmp_path)
    if sps.issparse(X):
        ref_ds = JaxDataset.from_csr(X.indptr, X.indices, X.data, X.shape[1],
                                     label=y, max_bin=63)
        ds = BinnedDataset.from_csr(X.indptr, X.indices, X.data, X.shape[1],
                                    label=y, max_bin=63)
    else:
        ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
        ds = dataset_from_arrays(
            ref_ds.binned, ref_ds.num_bin_per_feature,
            ref_ds.missing_types(), ref_ds.default_bins(),
            ref_ds.feature_is_categorical(), y,
            mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    want = _jax_tree(ref_ds, params, g, h)
    learner = tl.SerialTreeLearner(ds, Config(**params), device="cpu")
    assert learner.grows_on_device()
    got = learner.train(torch.from_numpy(g), torch.from_numpy(h), N)
    assert got.host_fetches == 1
    nl = int(want.num_leaves)
    assert got.num_leaves == nl > 2
    for field in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_parent", "leaf_depth"):
        np.testing.assert_array_equal(getattr(got, field)[:nl],
                                      getattr(want, field)[:nl],
                                      err_msg=field)
    np.testing.assert_array_equal(got.leaf_count[:nl], want.leaf_count[:nl])
    np.testing.assert_array_equal(got.row_leaf.numpy(), want.row_leaf[:N])
    if grads is binary_grads:
        lr = TRAIN_PARAMS["learning_rate"]
        tree = type("T", (), dict(num_leaves=nl,
                                  leaf_value=lr * want.leaf_value,
                                  leaf_weight=want.leaf_weight,
                                  leaf_depth=want.leaf_depth))
        np.testing.assert_array_less(
            lr * np.abs(got.leaf_value[:nl] - want.leaf_value[:nl]),
            leaf_value_tolerance(tree, N))
    else:
        np.testing.assert_array_less(
            np.abs(got.leaf_value[:nl] - want.leaf_value[:nl]),
            l2_leaf_tolerance(want, N, float(np.abs(g).max()), 1.0))


def test_lazy_cegb_over_three_trees(tmp_path, one_thread):
    """Lazy CEGB over 3 trees, the paid bits and the features used carried
    from tree to tree by the learner: each device-built tree equals the
    host loop's (a second learner's) byte for byte, paid bits included,
    and the bits grow from tree to tree."""
    _, dev_l, g, h, count = setup("cegb_lazy", tmp_path)
    host_l = setup("cegb_lazy", tmp_path)[1]
    paid = []
    for it in range(3):
        scale = 1.0 - 0.25 * it
        got = dev_l.train(g * scale, h, count)
        want = host_l.train(g * scale, h, count, host_loop=True)
        assert_same_tree(got, want)
        assert got.host_fetches == 1
        np.testing.assert_array_equal(dev_l.cegb_used, host_l.cegb_used)
        assert torch.equal(dev_l.cegb_paid, host_l.cegb_paid)
        paid.append(int(sum(((dev_l.cegb_paid >> b) & 1).sum()
                            for b in range(8))))
    assert 0 < paid[0] < paid[1] <= paid[2]


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_histogram_window_equals_histogram_rows(window, precision):
    """The histogram with its window in device memory
    (``histogram_rows_window``): its plain version, and the dispatcher on
    a CPU tensor, equal ``histogram_rows_plain`` on the window the int32
    pair names, bit for bit; a count of 0 gives zeros."""
    from lightgbm_tpu_torch.core.histogram import (
        histogram_rows, histogram_rows_plain, histogram_rows_window,
        histogram_rows_window_plain)
    ds, learner, g, h, _ = setup("l2")
    if precision == "quantized":
        g, h = torch.round(g * 40), torch.round(h * 7)
    rows = tl.fill_gradients(learner.template, learner.layout, g, h)
    wb, wc = WINDOWS[window]
    win = torch.tensor([wb, wc], dtype=torch.int32)
    for f_begin, F in ((0, learner.hist_columns), (2, 4)):
        kw = dict(num_features=F, voff=learner.layout.voff, f_begin=f_begin,
                  quantized=precision == "quantized")
        want = histogram_rows_plain(rows, learner.num_bins, wb, wc, **kw)
        got = histogram_rows_window_plain(rows, win,
                                          num_bins=learner.num_bins, **kw)
        assert torch.equal(got, want)
        assert torch.equal(histogram_rows_window(
            rows, win, None, num_bins=learner.num_bins, **kw), want)
        assert torch.equal(histogram_rows(rows, learner.num_bins, wb, wc,
                                          **kw), want)
        assert bool(want.any()) == (wc > 0)
    with pytest.raises(ValueError, match="outside"):
        histogram_rows_window_plain(
            rows, torch.tensor([rows.shape[0] - 5, 10], dtype=torch.int32),
            num_bins=learner.num_bins, num_features=learner.hist_columns,
            voff=learner.layout.voff)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_window_pass_feature_window(window, precision):
    """The device-window split pass with the feature window (the scal
    row's trailing ``hist_feature_begin``, a feature-parallel rank's F/d
    block): its plain version on an int32 scal tensor equals the
    host-window pass (``partition_hist_plain``, ``partition_hist``) with
    the same row, at the blocks [0, 4) and [4, 8): the store, the child
    histogram over the block and nl."""
    ds, learner, g, h, _ = setup("l2")
    if precision == "quantized":
        g, h = torch.round(g * 40), torch.round(h * 7)
    rows = tl.fill_gradients(learner.template, learner.layout, g, h)
    wb, wc = WINDOWS[window]
    for f_begin in (0, 4):
        kw = dict(num_features=4, num_bins=learner.num_bins,
                  voff=learner.layout.voff,
                  quantized=precision == "quantized")
        for feature, threshold, side in ((0, 30, 1), (5, 12, 0)):
            scal = np.append(scal_row(wb, wc, learner, feature, threshold,
                                      side, learner.num_bins), f_begin)
            want_rows, want_hist, want_nl = partition_hist_plain(
                rows, scal.tolist(), **kw)
            got_rows = rows.clone()
            got_hist, got_nl = partition_hist_window(
                got_rows, torch.from_numpy(scal).to(torch.int32), None, **kw)
            assert torch.equal(got_rows, want_rows)
            assert torch.equal(got_hist, want_hist)
            assert torch.equal(got_nl, want_nl)
            r2, h2, n2 = partition_hist(rows.clone(), scal.tolist(), **kw)
            assert torch.equal(r2, want_rows) and torch.equal(h2, want_hist)
            # the block's columns of the whole histogram
            full = partition_hist_plain(rows, scal[:-1].tolist(),
                                        **dict(kw, num_features=8))[1]
            assert torch.equal(want_hist, full[f_begin:f_begin + 4])
            if wc == 0:
                assert not got_hist.any() and int(got_nl) == 0
