"""The leaf-wise tree build on the device (``core/tree_learner.py``
``_DeviceGrowth``) against the host loop (``_Growth``), the JAX package's
``build_tree_partitioned`` and its own pieces, on the CPU.

The device build is the JAX build's loop: L - 1 steps that keep the tree's
state in tensors, read nothing back between splits, and bring the tree back
in one transfer.  The host loop reads each split's results back and does the
bookkeeping in numpy f32.  Both do the same f32 operations in the same
order, so on the same gradients they must give the same bytes in every
``TreeArrays`` field and the same ``row_leaf`` (and, on the fused chunk's
carried store, the same store).  Inputs: 3,000 rows made from a numpy seed,
63 bins, 8-31 leaves, one torch thread.
"""
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
}


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


def setup(name):
    make, grads, extra = CASES[name]
    ds, y = port_dataset(make, extra)
    params = dict(BASE, **{k: v for k, v in extra.items()
                           if k != "categorical_feature"})
    learner = tl.SerialTreeLearner(ds, Config(**params), device="cpu")
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


@pytest.mark.parametrize("name", list(CASES))
def test_device_build_equals_host_loop(name, one_thread):
    """Byte-equal trees, row_leaf and (carried) store: the device build
    and the host loop on the same gradients."""
    _, learner, g, h, count = setup(name)
    got = grow(name, learner, g, h, count)
    want = grow(name, learner, g, h, count, host_loop=True)
    if name == "carried":
        (got, got_rows), (want, want_rows) = got, want
        assert got.row_leaf.numel() == 0
        assert torch.equal(got_rows, want_rows)
    assert_same_tree(got, want)
    assert got.host_fetches == 1
    assert got.split_passes == learner.num_leaves - 1
    assert want.host_fetches == want.num_leaves
    if name == "stops_early":
        # the dead steps ran and changed nothing
        assert got.num_leaves < learner.num_leaves - 1
    if name in ("binary", "two_leaves"):
        assert got.num_leaves == learner.num_leaves


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
    """Forced splits, CEGB, the histogram pool, level growth and the
    parallel learners grow in the host loop (one read-back a split or a
    level), as does a serial tree that a check sends there (``host_loop``);
    the serial leaf-wise learner grows on the device.  Only the device
    build asks the learner for its split-pass workspace (a bound-sized
    store on the card), so the host loop holds no such buffer."""
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
    real_work = learner.window_work

    def window_work(rows, bound):
        work.append(bound)
        return real_work(rows, bound)
    monkeypatch.setattr(learner, "window_work", window_work)
    if case == "parallel":
        learner.comm = tl.Comm(ops=_OneRank(), mode="psum")
    arrays = learner.train(g, h, N, host_loop=case == "host_loop")
    assert bool(used) == (case == "serial")
    assert work == ([N] if case == "serial" else [])
    if case == "serial":
        assert arrays.host_fetches == 1
    elif case == "level":
        assert arrays.host_fetches == arrays.levels + 1
    else:
        assert arrays.host_fetches >= arrays.num_leaves > 2
    if case == "parallel":
        learner.comm = None
        serial = learner.train(g, h, N)
        assert_same_tree(arrays, serial)
