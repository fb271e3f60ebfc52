"""Level growth on the device (``core/tree_learner.py``
``_DeviceGrowth.level_step``) against the host loop (``_Growth``), the JAX
package's level path and its own pieces, on the CPU.

The device build grows a ``tree_grow_mode=level`` tree as the JAX build
unrolls ``level_step``: the root, then ``level_count`` level steps that
read nothing back (dead ones included), each one level pass through
``partition_hist_level_window`` (its G scal rows a device tensor, its maps
built from the frontier's counts in device memory, ``level_meta_device``
on the CPU), and one fetch a tree.  The host loop reads each level's
results back and does the bookkeeping in numpy f32; both do the same f32
operations in the same order, so on the same gradients they must give the
same bytes in every ``TreeArrays`` field, the same ``row_leaf``, the same
model text and, on the fused chunk's carried store, the same store.
Inputs: 3,000 rows made from a numpy seed, 63 bins, 2-31 leaves, one torch
thread.  The JAX level path runs in Pallas interpret mode under the
``pl.load``/``pl.store`` shim of ``test_torch_level_oracle.py``, set with
``monkeypatch`` and undone after each test.
"""
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax
import jax.numpy as jnp
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.core.tree_learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu_torch import BinnedDataset, Config
from lightgbm_tpu_torch.convert import dataset_from_arrays
from lightgbm_tpu_torch.core import partition as P
from lightgbm_tpu_torch.core import tree_learner as tl
from lightgbm_tpu_torch.obs import launches
from test_torch_device_growth import (BASE, CASES, N, assert_same_tree,
                                      binary_grads, dense, grow,
                                      port_dataset)
from test_torch_level_oracle import _shim_is_undone, _store  # noqa: F401
from test_torch_quant import one_thread  # noqa: F401
from test_torch_train import PARAMS as TRAIN_PARAMS
from test_torch_train import leaf_value_tolerance

LEVEL = dict(tree_grow_mode="level")
# name -> (the test_torch_device_growth case it takes its data, gradients
# and parameters from, the level parameters over them)
LEVEL_CASES = {
    "exact": ("binary", {}),
    "quantized": ("quantized", {}),
    "efb": ("efb", {}),
    "onehot": ("onehot", {}),
    "many_vs_many": ("many_vs_many", {}),
    "monotone": ("monotone", {}),
    "extra_trees": ("extra_trees", {}),
    "max_depth_3": ("max_depth_3", {}),
    "budget_cut": ("l2", dict(num_leaves=20)),
    "stops_early": ("stops_early", {}),
    "two_leaves": ("two_leaves", {}),
    "bagging": ("bagging", {}),
    "carried": ("carried", {}),
    "carried_quantized": ("carried", dict(hist_precision="quantized")),
}


def level_setup(name):
    case, extra = LEVEL_CASES[name]
    make, grads, base = CASES[case]
    ds, y = port_dataset(make, base)
    params = dict(BASE, **dict(base, **extra, **LEVEL))
    params.pop("categorical_feature", None)
    learner = tl.SerialTreeLearner(ds, Config(**params), device="cpu")
    g, h = (torch.from_numpy(a) for a in grads(y))
    count = N
    if case == "bagging":
        bag = torch.from_numpy(np.random.RandomState(3).uniform(size=N)
                               < 0.7)
        g, h, count = g * bag, h * bag, bag.sum()
    return case, ds, learner, g, h, count


def model_text(arrays, ds):
    return tl.tree_from_arrays(arrays, ds).to_string()


@pytest.mark.parametrize("name", list(LEVEL_CASES))
def test_device_level_build_equals_host_loop(name, one_thread):
    """Byte-equal trees, row_leaf, model text and (carried) store: the
    device level build and the host loop on the same gradients; one fetch
    and ``level_count`` level passes a tree, dead levels included."""
    case, ds, learner, g, h, count = level_setup(name)
    assert learner.effective_grow_mode() == "level"
    assert learner.grows_on_device()
    got = grow(case, learner, g, h, count)
    want = grow(case, learner, g, h, count, host_loop=True)
    if case == "carried":
        (got, got_rows), (want, want_rows) = got, want
        assert got.row_leaf.numel() == 0
        assert torch.equal(got_rows, want_rows)
    assert_same_tree(got, want)
    assert model_text(got, ds) == model_text(want, ds)
    assert got.host_fetches == 1
    assert want.host_fetches == want.levels + 1
    assert got.split_passes == learner.level_count()
    L = learner.num_leaves
    if name in ("exact", "quantized", "two_leaves", "budget_cut"):
        assert got.num_leaves == L
    if name == "budget_cut":
        # 1 + 2 + 4 + 8 splits, then the budget takes 4 of depth 4's 16
        assert got.levels == learner.level_count() == 5
        assert np.bincount(got.leaf_depth[:L])[-1] == 8
    if name == "stops_early":
        # the frontier ran out before the schedule: dead levels ran
        assert got.levels < learner.level_count()
    if name == "max_depth_3":
        assert got.leaf_depth[:got.num_leaves].max() == 3


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_one_fetch_and_level_count_passes_a_tree(precision, one_thread,
                                                 monkeypatch):
    """A GBDT's level trees through the device build: one device->host
    transfer each, ``level_count`` level passes each (the calls of the
    device-window level pass, dead levels included), and the launch
    accounting (obs.launches) records exactly that."""
    from lightgbm_tpu_torch import GBDT, create_objective
    X, y = dense(seed=6)
    ds = BinnedDataset.from_matrix(X, label=y, max_bin=63)
    cfg = Config(**dict(BASE, objective="regression", min_data_in_leaf=150,
                        hist_precision=precision, **LEVEL))
    b = GBDT(cfg, ds, create_objective("regression", cfg, device="cpu"),
             device="cpu")
    calls = []
    real_pass = tl.partition_hist_level_window

    def counted_pass(*a, **k):
        calls.append(a[2].shape[0])
        return real_pass(*a, **k)
    # the default of SerialTreeLearner.train was bound at definition
    monkeypatch.setitem(tl.SerialTreeLearner.train.__kwdefaults__,
                        "level_window_fn", counted_pass)
    fetched, passes = [], []
    real = b.learner.train

    def counted(*a, **k):
        out = real(*a, **k)
        fetched.append(out.host_fetches)
        passes.append(out.split_passes)
        return out
    b.learner.train = counted
    launches.reset()
    for _ in range(3):
        b.train_one_iter()
    D = b.learner.level_count()
    assert fetched == [1, 1, 1] and passes == [D] * 3
    assert launches.counts() == {"level": 3 * D}
    # each level's frontier slots: min(2**d, L - 1), dead ones included
    assert calls == [min(1 << d, cfg.num_leaves - 1) for d in range(D)] * 3
    assert any(t.num_leaves < cfg.num_leaves for t in b.models)


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_device_level_build_matches_jax_level_path(precision, one_thread,
                                                   monkeypatch):
    """The device level build against the JAX package's level path (its
    fused Pallas pass in interpret mode, the only way the JAX learner grows
    level-wise) on the same bins and gradients: equal splits, structure,
    leaf counts and row_leaf, leaf values within test_torch_train's
    bound."""
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)
    if precision == "exact":
        monkeypatch.setenv("LIGHTGBM_TPU_EXACT_HIST", "1")
    # the fused path in interpret mode from the learner's construction on,
    # so that it pads its row store to the Pallas chunk
    monkeypatch.setenv("LIGHTGBM_TPU_PALLAS_INTERPRET", "1")
    X, y = dense(seed=5)
    g, h = binary_grads(y)
    params = dict(BASE, num_leaves=15, hist_precision=precision, **LEVEL)
    ref_ds = JaxDataset.from_matrix(X, label=y, max_bin=63)
    ref = JaxLearner(ref_ds, JaxConfig(**params))
    assert ref.use_pallas and ref.pallas_interpret
    assert ref.effective_grow_mode() == "level"
    want = jax.tree_util.tree_map(np.asarray, ref.train(
        jnp.asarray(g), jnp.asarray(h), N))
    ds = dataset_from_arrays(
        ref_ds.binned, ref_ds.num_bin_per_feature, ref_ds.missing_types(),
        ref_ds.default_bins(), ref_ds.feature_is_categorical(), y,
        mapper_state=[m.to_dict() for m in ref_ds.bin_mappers])
    learner = tl.SerialTreeLearner(ds, Config(**params), device="cpu")
    got = learner.train(torch.from_numpy(g), torch.from_numpy(h), N)
    assert got.host_fetches == 1
    nl = int(want.num_leaves)
    assert got.num_leaves == nl == 15
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


# ---- the level pass with its windows in device memory, plain version ----

F, B = 6, 64
S = P.SCAL_HEAD + B // 32


def store(n, seed, *, bpc=1, packed=False, quantized=False):
    """An n-row store of F columns (u8, u16 or nibble-packed) and f32
    grad/hess (integer-valued when quantized), made from a numpy seed."""
    rng = np.random.RandomState(seed)
    lay = tl.row_layout((F + 1) // 2 if packed else F, bpc)
    host = np.zeros((n, lay.W), np.uint8)
    bins = rng.randint(0, 16 if packed else B, size=(n, F))
    if packed:
        bins = np.concatenate([bins, np.zeros((n, F % 2), int)], 1)
        host[:, :lay.nbytes_bins] = bins[:, 0::2] | (bins[:, 1::2] << 4)
    else:
        host[:, :lay.nbytes_bins] = tl.bin_bytes(
            bins.astype(np.uint16 if bpc == 2 else np.uint8))
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    if quantized:
        g, h = np.round(g * 40), np.round(h * 200)
    host[:, lay.voff:lay.voff + 8] = np.stack(
        [g, h], 1).astype(np.float32).view(np.uint8)
    return torch.from_numpy(host), lay.voff


def frontier(n, G, seed, dead=0.25, nb=B):
    """G disjoint windows of a level in a shuffled slot order, a share of
    them dead (wc = 0 at wb = 0, as the device build writes them), with
    random routes: numerical with each missing code, categorical bitsets,
    EFB unfolds."""
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=2 * G, replace=False))
    s = np.zeros((G, S), np.int64)
    for i, slot in enumerate(rng.permutation(G)):
        wb, we = cuts[2 * i], cuts[2 * i + 1]
        if rng.rand() < dead:
            wb = we = 0
        kind = rng.randint(3)
        s[slot, :12] = (wb, we - wb, rng.randint(F), rng.randint(nb),
                        rng.randint(2), rng.randint(3), nb, rng.randint(nb),
                        kind == 1, rng.randint(2), kind == 2,
                        rng.randint(1, 8))
        w = rng.randint(0, 2 ** 32, size=B // 32)
        s[slot, 12:] = np.where(w >= 2 ** 31, w - 2 ** 32, w)
    return s


@pytest.mark.parametrize("layout", ["u8", "u16", "packed"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G", [1, 8, 61])
def test_level_window_plain_equals_level_plain(G, quantized, layout):
    """``partition_hist_level_window_plain`` (no scal row read on the
    host) against ``partition_hist_level_plain`` (G single-window plain
    calls): the destination store byte for byte (rows outside the windows
    as they were), nl and the histograms bit for bit, the source store
    untouched."""
    n = 6000
    src, voff = store(n, G, bpc=2 if layout == "u16" else 1,
                      packed=layout == "packed", quantized=quantized)
    s = frontier(n, G, 100 + G, nb=16 if layout == "packed" else B)
    kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized,
              bpc=2 if layout == "u16" else 1, packed=layout == "packed")
    before = src.clone()
    d1, d2 = torch.full_like(src, 0x5A), torch.full_like(src, 0x5A)
    h1, nl1 = P.partition_hist_level_plain(src, d1, s, **kw)
    h2, nl2 = P.partition_hist_level_window(
        src, d2, torch.as_tensor(s, dtype=torch.int32), **kw)
    assert torch.equal(src, before)
    assert torch.equal(d1, d2)
    assert torch.equal(nl1, nl2)
    assert torch.equal(h1, h2)
    assert (nl2[torch.as_tensor(s[:, 1] == 0)] == 0).all()
    assert not h2[torch.as_tensor(s[:, 1] == 0)].any()


@pytest.mark.parametrize("quantized,int_grid", [
    (False, "device"), (True, "device"), (True, "bound")])
@pytest.mark.parametrize("seed", range(4))
def test_level_meta_device_equals_level_meta(seed, quantized, int_grid):
    """``level_meta_device`` (torch ops over ``scals[:, 1]``, padded to the
    launch's bounds with -1) against ``level_meta``'s host maps on random
    frontiers with dead windows: each window's first block and blocks, the
    block map, the exact segment map (each window's ``_segments``), and
    the integer grid's window rows and block map (``int_hist_grids`` of
    each window's share; "bound": one fixed grid); no map outruns its
    bound."""
    rng = np.random.RandomState(seed)
    n = int(rng.choice([3000, 70000, 1 << 20]))
    G = int(rng.choice([1, 5, 64, 255]))
    W, Fh = 128, int(rng.choice([3, 28, 300]))
    s = frontier(n, min(G, n // 3), seed)
    G = s.shape[0]
    dev = P.level_meta_device(torch.as_tensor(s, dtype=torch.int32), Fh, B,
                              W, bound_rows=n, quantized=quantized,
                              int_grid=int_grid)
    bd = P.level_bounds(n, G, Fh, B, W, quantized, int_grid)
    host = P.level_meta(s.astype(np.int32), Fh, B, W, quantized)
    meta = host.meta[G * S:]
    nb = host.nblk
    np.testing.assert_array_equal(dev.wmeta.numpy().reshape(-1),
                                  meta[:2 * G])
    blk = dev.blkmap.numpy().reshape(-1)
    assert blk.size == 2 * bd.NB
    np.testing.assert_array_equal(blk[:2 * nb], meta[2 * G:2 * G + 2 * nb])
    assert (blk[2 * nb:] == -1).all()
    hmeta = meta[2 * G + 2 * nb:]
    hs = 4 if quantized else 2
    if int_grid == "device":
        np.testing.assert_array_equal(dev.hinfo.numpy().reshape(-1),
                                      hmeta[:hs * G])
        hmap = dev.hmap.numpy().reshape(-1)
        used = hmeta.size - hs * G
        np.testing.assert_array_equal(hmap[:used], hmeta[hs * G:])
        assert (hmap[used:] == -1).all()
    else:
        info = dev.hinfo.numpy()
        live = s[:, 1] > 0
        assert (info[live, 0] == bd.nseg_b).all()
        assert (info[~live, 0] == 0).all()
        assert (info[live, 2] == bd.ft_b).all()
        assert int((dev.hmap >= 0).sum()) == int(live.sum()) * bd.nseg_b * (
            -(-Fh // bd.ft_b))


@pytest.mark.parametrize("seed", range(6))
def test_level_bounds_hold(seed):
    """The launch's bounds (``level_bounds``) hold for any G disjoint
    windows of n rows in all: the tiles, the exact segments and the
    integer grid's blocks of ``level_meta`` never exceed them, and the
    integer grid's tiles never outgrow ``ft_max``."""
    rng = np.random.RandomState(seed)
    for _ in range(200):
        n = int(rng.choice([1000, 65536, 70000, 1 << 20, 11_000_000]))
        G = int(rng.choice([1, 2, 7, 128, 255]))
        Fh = int(rng.choice([1, 8, 28, 2000]))
        Bh = int(rng.choice([16, 64, 256]))
        wc = rng.multinomial(n, rng.dirichlet(np.ones(G) * rng.choice(
            [0.05, 1.0]))).astype(np.int64)
        wc[rng.rand(G) < 0.2] = 0
        s = np.zeros((G, P.SCAL_HEAD + Bh // 32), np.int64)
        s[:, 1] = wc
        for q in (False, True):
            bd = P.level_bounds(n, G, Fh, Bh, 128, q)
            lm = P.level_meta(s, Fh, Bh, 128, q)
            assert lm.nblk <= bd.NB
            if q:
                assert lm.hist.nblocks <= bd.NH
                assert lm.hist.ft_max <= bd.ft_max
            else:
                assert lm.hist.nseg <= bd.NH


def test_level_window_refuses_what_it_cannot_take():
    """The checks the device-window level pass makes on shapes alone: one
    buffer as both stores, stores of two shapes, scal rows of the wrong
    width or type; and the kernel wrapper takes only CUDA tensors."""
    src, voff = store(100, 0)
    kw = dict(num_features=F, num_bins=B, voff=voff)
    s = torch.as_tensor(frontier(100, 2, 0, dead=0.0), dtype=torch.int32)
    with pytest.raises(ValueError, match="two row stores"):
        P.partition_hist_level_window(src, src, s, **kw)
    with pytest.raises(ValueError, match="must match"):
        P.partition_hist_level_window(src, src[:50].clone(), s, **kw)
    with pytest.raises(ValueError, match="int32"):
        P.partition_hist_level_window(src, src.clone(), s.long(), **kw)
    with pytest.raises(ValueError, match="int32"):
        P.partition_hist_level_window(src, src.clone(), s[:, :-1], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        P.partition_hist_level_window_cuda(src, src.clone(), s, **kw)


def test_level_workspace_reckoning():
    """The workspace's bytes at the (B) path's shape (1,048,576 rows, 28
    columns, 256 bins, the last level's 128 slots): the exact partials,
    640 rows of [28, 2, 256] f64, about 73.4 MB; the integer workspace
    holds 128 int64 accumulator rows instead.  Made on the CPU here only to
    count its bytes."""
    n, G, W = 1 << 20, 128, 128
    bd = P.level_bounds(n, G, 28, 256, W)
    assert bd.NH == 512 + 128 and bd.NB == 1024 + 128
    w = P.level_workspace(n, G, W, 28, 256, device="cpu")
    assert w.partial.shape == (640, 28, 2, 256)
    assert abs(w.partial.numel() * 8 / 1e6 - 73.4) < 0.1
    assert w.nbytes() < 74e6
    wq = P.level_workspace(n, G, W, 28, 256, True, device="cpu")
    assert wq.partial.shape == (G, 28, 2, 256) and not wq.partial.any()
