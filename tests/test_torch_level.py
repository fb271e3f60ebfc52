"""Level-batched growth (``tree_grow_mode=level``) in the port, on the CPU.

- The plain ``partition_hist_level`` (``src`` -> ``dst``) equals G
  sequential plain ``partition_hist`` calls and G sequential
  ``partition_hist_xla`` calls (the JAX package's contract for
  ``partition_hist_level_pallas``): the windows of ``dst`` byte-equal to the
  sequential calls' rows, ``src`` and every row of ``dst`` outside the
  windows untouched, left counts equal, histograms equal to the sequential
  port calls and within 1e-6 of max|bin sum| of the XLA ones (summation
  order), exactly equal when quantized; ``wc = 0`` slots write nothing and
  have a zero histogram.  Overlapping windows, windows outside the stores
  and bad store pairs (one buffer, different shapes) are refused.
- Level growth on two stores, which it refuses to grow without (the second
  store is the caller's): a level-grown tree's per-row leaf (read from
  each leaf's store by depth parity) equals ``route_binned``'s leaves on the
  training bins.
- In the complete-tree regime (``max_depth=3``, ``num_leaves=8``) level
  growth performs the same split set as leaf-wise growth, so the scores are
  bit-equal (the JAX package pins the same, tests/test_partition_buckets.py).
- With a leaf budget that cuts a level (``num_leaves=15``, ``max_depth=-1``)
  the tree follows the JAX ``level_step`` rules: the frontier of depth d is
  split in ascending leaf id order, slot r makes node ``num_leaves - 1 + r``
  and kid ``num_leaves + r``, parents' child pointers are fixed up, and every
  leaf's ``leaf_depth`` is its depth in the tree.
- Without CUDA an entry point called without ``device=`` still raises, and
  the kernel wrapper refuses a CPU tensor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core import histogram as jax_hist
from lightgbm_tpu.core import partition as jax_part
from lightgbm_tpu_torch import GBDT, BinnedDataset, Config, create_objective
from lightgbm_tpu_torch import device as port_device
from lightgbm_tpu_torch.core import partition as port_part
from lightgbm_tpu_torch.core import tree_learner as port_tl
from test_torch_partition import make_rows, routes
from test_torch_quant import one_thread, quantized_rows  # noqa: F401

torch.set_num_threads(2)

N, F, B = 3000, 6, 64
S = 12 + B // 32


def scal_rows(windows, seed=0):
    """One scal row per (wb, wc), with the routes of the partition tests
    taken in turn."""
    route_list = list(routes(B, seed).values())
    out = []
    for i, (wb, wc) in enumerate(windows):
        (r, words) = route_list[i % len(route_list)]
        gcol, thr, dleft, mt, nb, dbin, is_cat, unf, eoff = r
        out.append([wb, wc, gcol, thr, dleft, mt, nb, dbin, is_cat, i % 2,
                    unf, eoff] + words)
    return np.asarray(out, dtype=np.int64)


FRONTIERS = {
    "adjacent": [(i * 250, 250) for i in range(12)],
    "unaligned_with_empty": [(3, 997), (1000, 0), (1001, 1), (1013, 1200),
                             (2500, 0), (2213, 0), (2301, 699)],
    "one": [(0, N)],
    "all_empty": [(0, 0), (17, 0)],
}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("frontier", list(FRONTIERS))
def test_level_pass_equals_sequential_calls(frontier, quantized):
    make = quantized_rows if quantized else make_rows
    rows, voff = make(N, F, B, seed=5)
    scals = scal_rows(FRONTIERS[frontier])
    kw = dict(num_features=F, num_bins=B, voff=voff, quantized=quantized)
    src = torch.from_numpy(rows.copy())
    dst = torch.full_like(src, 0xA5)
    got_hist, got_nl = port_part.partition_hist_level(src, dst, scals, **kw)
    assert torch.equal(src, torch.from_numpy(rows))
    inside = torch.zeros(N + 1, dtype=torch.int64)
    for wb, wc in FRONTIERS[frontier]:
        inside[wb] += 1
        inside[wb + wc] -= 1
    inside = (torch.cumsum(inside, 0)[:len(rows)] > 0)[:, None]
    assert bool((dst == 0xA5)[~inside.expand_as(dst)].all())
    got_rows = torch.where(inside, dst, src)
    assert got_hist.shape == (len(scals), F, 2, B)
    assert got_nl.shape == (len(scals),) and got_nl.dtype == torch.int32

    seq_rows = torch.from_numpy(rows.copy())
    xla_rows = jnp.asarray(rows)
    for g, sc in enumerate(scals):
        seq_rows, h, nl = port_part.partition_hist(seq_rows, sc.tolist(), **kw)
        assert torch.equal(got_hist[g], h)
        assert int(got_nl[g]) == int(nl[0])
        xla_rows, xh, xnl = jax_part.partition_hist_xla(
            xla_rows, jnp.asarray(sc, jnp.int32), num_features=F,
            num_bins=B, voff=voff)
        assert int(got_nl[g]) == int(xnl)
        if quantized:
            wb, wc, left = int(sc[0]), int(sc[1]), int(sc[9])
            nlv = int(xnl)
            start, count = (wb, nlv) if left else (wb + nlv, wc - nlv)
            xh = jax_hist.histogram_rows(xla_rows, B, start, count,
                                         num_features=F, voff=voff,
                                         use_pallas=False, quantized=True)
            np.testing.assert_array_equal(got_hist[g].numpy(), np.asarray(xh))
        else:
            want = np.asarray(xh, np.float64)
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got_hist[g].numpy() - want).max() <= 1e-6 * scale
        if int(sc[1]) == 0:
            assert int(got_nl[g]) == 0 and not got_hist[g].any()
    assert torch.equal(got_rows, seq_rows)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(xla_rows))


def test_level_pass_refuses_bad_windows():
    rows, voff = make_rows(N, F, B, seed=6)
    kw = dict(num_features=F, num_bins=B, voff=voff)
    t = torch.from_numpy(rows)
    d = torch.empty_like(t)
    for windows in ([(0, 100), (99, 10)], [(N - 5, 10)], [(-1, 4)]):
        with pytest.raises(ValueError):
            port_part.partition_hist_level(t, d, scal_rows(windows), **kw)
    with pytest.raises(ValueError):      # a scal row of the wrong width
        port_part.partition_hist_level(t, d, np.zeros((2, S + 1), np.int64),
                                       **kw)
    # the CUDA wrapper takes CUDA tensors only: no plain fallback inside it
    with pytest.raises(ValueError):
        port_part.partition_hist_level_cuda(t, d, scal_rows([(0, 10)]), **kw)


@pytest.mark.parametrize("pair", ["same", "view", "overlap", "rows",
                                  "width", "dtype"])
def test_level_pass_refuses_bad_store_pairs(pair):
    """src and dst must be two buffers of one shape and type."""
    rows, voff = make_rows(N, F, B, seed=7)
    t = torch.from_numpy(rows)
    W = t.shape[1]
    d = {"same": lambda: t,
         "view": lambda: t[:],
         "overlap": lambda: t.view(-1)[W:].view(N - 1, W),
         "rows": lambda: torch.empty((N - 1, W), dtype=torch.uint8),
         "width": lambda: torch.empty((N, W + 16), dtype=torch.uint8),
         "dtype": lambda: torch.empty((N, W), dtype=torch.int8)}[pair]()
    src = t[:N - 1] if pair == "overlap" else t
    for quantized in (False, True):
        with pytest.raises(ValueError):
            port_part.partition_hist_level(
                src, d, scal_rows([(0, 100)]), num_features=F, num_bins=B,
                voff=voff, quantized=quantized)


def toy_dataset(n=4096, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] * X[:, 3]
          + rng.normal(scale=0.5, size=n)) > 0).astype(np.float64)
    return BinnedDataset.from_matrix(X, label=y, max_bin=63)


def train(ds, iters=2, **params):
    cfg = Config(objective="binary", learning_rate=0.1, max_bin=63,
                 verbosity=-1, **params)
    booster = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                   device="cpu")
    arrays = []
    for _ in range(iters):
        booster.train_one_iter()
        arrays.append(booster.last_arrays)
    return booster, arrays


@pytest.fixture(scope="module")
def ds(one_thread):
    """The training data; the boosters of this file train with one torch
    thread (``test_torch_quant.one_thread``)."""
    return toy_dataset()


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_complete_tree_level_equals_leaf(ds, precision):
    out = {}
    for mode in ("leaf", "level"):
        out[mode] = train(ds, num_leaves=8, max_depth=3, tree_grow_mode=mode,
                          hist_precision=precision)
    (leaf, leaf_arrays), (level, level_arrays) = out["leaf"], out["level"]
    assert torch.equal(leaf.train_score, level.train_score)
    for a, b in zip(leaf.models, level.models):
        assert a.num_leaves == b.num_leaves == 8
        assert sorted(a.split_feature[:7].tolist()) == \
            sorted(b.split_feature[:7].tolist())
        np.testing.assert_array_equal(np.sort(a.leaf_value[:8]),
                                      np.sort(b.leaf_value[:8]))
    # level mode: 3 level steps a tree; both modes build on the device and
    # read each tree back once
    assert [a.levels for a in level_arrays] == [3, 3]
    assert [a.host_fetches for a in level_arrays] == [1, 1]
    assert [a.host_fetches for a in leaf_arrays] == [1, 1]
    assert level.learner.level_count() == 3
    assert level.learner.launches_per_tree() == 3
    assert leaf.learner.launches_per_tree() == 7


def leftmost_leaf(left_child, node):
    while node >= 0:
        node = int(left_child[node])
    return ~node


@pytest.mark.parametrize("precision", ["exact", "quantized"])
def test_level_rules_with_a_cut_level(ds, precision):
    booster, arrays = train(ds, num_leaves=15, max_depth=-1,
                            tree_grow_mode="level", hist_precision=precision)
    assert booster.learner.level_count() == 4
    for a in arrays:
        L = a.num_leaves
        assert L == 15 and a.levels == 4
        m = L - 1
        lc, rc = a.left_child[:m], a.right_child[:m]
        # depth of every node and leaf, walking from the root
        node_depth = {0: 0}
        leaf_depth = {}
        for k in range(m):
            for c in (int(lc[k]), int(rc[k])):
                if c >= 0:
                    assert c > k              # children are made after parents
                    node_depth[c] = node_depth[k] + 1
                else:
                    leaf_depth[~c] = node_depth[k] + 1
        assert sorted(leaf_depth) == list(range(L))
        np.testing.assert_array_equal(a.leaf_depth[:L],
                                      [leaf_depth[i] for i in range(L)])
        depths = [node_depth[k] for k in range(m)]
        assert depths == sorted(depths)       # breadth-first node order
        # the 4-level schedule of a 15-leaf budget: 1 + 2 + 4 splits, then
        # the budget cuts depth 3 to 7 of its 8 leaves
        assert [depths.count(d) for d in range(4)] == [1, 2, 4, 7]
        for k in range(m):
            # slot r of a level: node num_leaves - 1 + r splits a leaf into
            # itself and kid num_leaves + r = node + 1
            assert leftmost_leaf(lc, int(rc[k])) == k + 1
            # the parent's pointer to the split leaf now points at the node
            if k:
                parent = [p for p in range(k) if k in (lc[p], rc[p])]
                assert len(parent) == 1
        for d in range(4):
            nodes = [k for k in range(m) if depths[k] == d]
            split = [leftmost_leaf(lc, k) for k in nodes]
            assert split == sorted(split)     # ascending leaf ids
        # the cut level skipped the frontier's highest leaf id only
        frontier3 = sorted(i for i in range(8))
        split3 = [leftmost_leaf(lc, k) for k in range(m) if depths[k] == 3]
        assert split3 == frontier3[:7]


@pytest.mark.parametrize("precision", ["exact", "quantized"])
@pytest.mark.parametrize("params", [
    dict(num_leaves=15, max_depth=-1),
    dict(num_leaves=31, max_depth=-1, min_data_in_leaf=150)])
def test_level_row_leaf_equals_route_binned(ds, precision, params):
    """Each position's order bytes come from the store of its leaf's depth
    parity: the per-row leaves equal the tree's own routing of the training
    bins, with leaves at depths of both parities."""
    booster, arrays = train(ds, tree_grow_mode="level",
                            hist_precision=precision, **params)
    for a in arrays:
        L = a.num_leaves
        assert set(a.leaf_depth[:L] % 2) == {0, 1}
        want = port_tl.route_binned(booster.learner.valid_bins(ds), a,
                                    booster.learner.feat_host)
        assert torch.equal(a.row_leaf, want)
        assert bool((torch.bincount(a.row_leaf, minlength=L) > 0).all())
    assert booster.learner.spare is not None


def test_level_growth_needs_a_second_store():
    """Level growth writes a second row store, which the caller owns: the
    tree builder refuses to grow a level tree without one."""
    rows = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="second row store"):
        port_tl.build_tree_partitioned(
            rows, None, None, 8, None, None, {}, num_leaves=4, max_depth=-1,
            params=None, num_bins=32, layout=None, hist_features=1,
            packed=False, grow_mode="level")


def test_cpu_tensors_take_the_plain_versions(ds):
    """On the CPU the wrappers run the plain versions, so no kernel launch
    is counted, in level and quantized mode alike."""
    port_device.reset_launches()
    _, arrays = train(ds, iters=1, num_leaves=8, tree_grow_mode="level",
                      hist_precision="quantized")
    assert arrays[0].levels == 3
    assert not any(port_device.launches().values())


def test_level_mode_without_cuda_raises(ds):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is about its absence")
    cfg = Config(objective="binary", num_leaves=15, verbosity=-1,
                 tree_grow_mode="level", hist_precision="quantized")
    with pytest.raises(RuntimeError, match="CUDA"):
        GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        create_objective("binary", cfg)
