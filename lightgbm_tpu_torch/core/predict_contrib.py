"""SHAP contributions on the device: TreeSHAP by path decomposition, in f64.

Counterpart of ``lightgbm_tpu/core/predict_contrib.py``
(``harvest_contrib_host``, :130-252; ``stack_contrib_blocked``, :280-301;
``contrib_scan``, :304-480), which is XLA in the JAX package (no Pallas
kernel), so the port is plain torch.  Each tree is cut into its root-to-leaf paths on the host: the
per-leaf schedule of the host recursion (``Tree._extend_path``,
``_unwind_path``, ``_unwound_path_sum``, core/tree.py) does not depend on the
row, and neither do its operands (cover ratios, path lengths), so they are
harvested once per (tree, leaf) in f64.  What depends on the row is a hot bit
per path step (did the row go the path's way at that node) and, per step,
the AND of the hot bits of the earlier steps on the same feature.  The device
replays every leaf's schedule for all rows at once, op for op in f64
([rows, trees, leaves] tensors), and adds the terms into phi in the host's
order: per tree, the expected value, then the leaves in index order, then
the path positions in order.  In eager torch every op rounds once, as the
host recursion's do.

Routing is the predictor's own decide (``core.predict`` on f32 rows and
floored thresholds, or the binned decide of ``core.predict_fused``), so raw
and binned contributions are the same bits on training rows.  The
temporaries grow as rows x leaves x depth, so rows go in chunks and trees in
blocks sized from :data:`CONTRIB_BYTES`; neither changes a result.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .tree import Tree

# bytes of [rows, trees, leaves] temporaries one chunk may hold
CONTRIB_BYTES = 4 << 30


class ContribSchedule(NamedTuple):
    """Host-harvested per-(tree, leaf) TreeSHAP op schedules, stacked to
    [T, L, ...]; ``*_os`` index the path step whose hot-bit prefix supplies
    the op's one fraction (-1: the constant 1).  Pad leaves and slots are
    inactive and give exact zeros."""
    depth: np.ndarray       # [T, L] i32 internal nodes on the leaf's path
    path_node: np.ndarray   # [T, L, D] node ids along the path
    path_dir: np.ndarray    # [T, L, D] True: the path goes left
    prev_occ: np.ndarray    # [T, L, D] last earlier step on the same feature
    ext_act: np.ndarray     # [T, L, D+1] bool
    ext_n: np.ndarray       # [T, L, D+1] f64 path length before the extend
    ext_z: np.ndarray       # [T, L, D+1] f64 the extend's zero fraction
    ext_os: np.ndarray      # [T, L, D+1]
    unw_act: np.ndarray     # [T, L, D] bool
    unw_n: np.ndarray       # [T, L, D] f64 length - 1 at the unwind
    unw_z: np.ndarray       # [T, L, D] f64 the unwound entry's zero fraction
    unw_os: np.ndarray      # [T, L, D]
    sum_act: np.ndarray     # [T, L, S] bool
    sum_n: np.ndarray       # [T, L, S] f64 final length - 1
    sum_z: np.ndarray       # [T, L, S] f64
    sum_os: np.ndarray      # [T, L, S]
    leaf_value: np.ndarray  # [T, L] f64
    expected: np.ndarray    # [T] f64 the tree's expected value (phi[-1])
    gather_idx: np.ndarray  # [T, C, R] flat (leaf * S + slot) term per
    #                         (column, rank) in (leaf, slot) order; L * S
    #                         is the zero sentinel


def _leaf_paths(tree: Tree):
    """[(leaf, [(node, go_left), ...])] in leaf index order."""
    if tree.num_leaves == 1:
        return []
    out = {}
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        for child, d in ((tree.left_child[node], True),
                         (tree.right_child[node], False)):
            cpath = path + [(int(node), d)]
            if child < 0:
                out[~int(child)] = cpath
            else:
                stack.append((int(child), cpath))
    return [(leaf, out[leaf]) for leaf in sorted(out)]


def harvest_contrib_host(trees: List[Tree], ncol: int) -> ContribSchedule:
    """Walk every (tree, leaf) path once, simulating the host recursion's
    path bookkeeping in f64 (predict_contrib.py:130-252); ``ncol`` is
    ``max_feature_idx + 2``."""
    t_cnt = len(trees)
    l_dim = max([max(t.num_leaves, 1) for t in trees] + [1])
    per_tree = []
    d_max, s_max, r_max = 0, 0, 0
    for tree in trees:
        leaves = {}
        for leaf, path in _leaf_paths(tree):
            d_max = max(d_max, len(path))
            # the recursion's path entries: (feature, zero fraction, step)
            entries = [(-1, np.float64(1.0), -1)]
            exts = [(True, 0, np.float64(1.0), -1)]
            unws = []
            feats_so_far: List[int] = []
            prev = []
            for k, (node, go_left) in enumerate(path):
                f = int(tree.split_feature[node])
                p_occ = -1
                for j in range(k - 1, -1, -1):
                    if feats_so_far[j] == f:
                        p_occ = j
                        break
                prev.append(p_occ)
                feats_so_far.append(f)
                dup = next((i for i, e in enumerate(entries) if e[0] == f),
                           None)
                izf = np.float64(1.0)
                if dup is not None:
                    ent = entries.pop(dup)
                    izf = ent[1]
                    unws.append((True, len(entries), ent[1], ent[2]))
                else:
                    unws.append((False, 0, np.float64(1.0), -1))
                # the extend into the path's child: its cover ratio times
                # the unwound entry's zero fraction, whether the row runs
                # hot or cold there
                child = (tree.left_child[node] if go_left
                         else tree.right_child[node])
                r = (tree._node_count(int(child))
                     / max(tree._node_count(int(node)), 1e-300))
                z = np.float64(r) * izf
                exts.append((True, len(entries), z, k))
                entries.append((f, z, k))
            sums = [(True, len(entries) - 1, e[1], e[2], e[0])
                    for e in entries[1:]]
            s_max = max(s_max, len(sums))
            leaves[leaf] = (path, prev, exts, unws, sums)
        per_tree.append(leaves)
    T, L, D, S = t_cnt, l_dim, d_max, s_max
    depth = np.zeros((T, L), np.int32)
    p_node = np.zeros((T, L, D), np.int64)
    p_dir = np.zeros((T, L, D), bool)
    p_prev = np.full((T, L, D), -1, np.int64)
    e_act = np.zeros((T, L, D + 1), bool)
    e_n = np.zeros((T, L, D + 1), np.float64)
    e_z = np.zeros((T, L, D + 1), np.float64)
    e_os = np.full((T, L, D + 1), -1, np.int64)
    u_act = np.zeros((T, L, D), bool)
    u_n = np.zeros((T, L, D), np.float64)
    u_z = np.ones((T, L, D), np.float64)
    u_os = np.full((T, L, D), -1, np.int64)
    s_act = np.zeros((T, L, S), bool)
    s_n = np.zeros((T, L, S), np.float64)
    s_z = np.ones((T, L, S), np.float64)
    s_os = np.full((T, L, S), -1, np.int64)
    lv = np.zeros((T, L), np.float64)
    ev = np.zeros((T,), np.float64)
    ranks = [dict() for _ in range(T)]
    for i, tree in enumerate(trees):
        ev[i] = tree.expected_value()
        lv[i, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        for leaf, (path, prev, exts, unws, sums) in per_tree[i].items():
            depth[i, leaf] = len(path)
            for k, (node, go_left) in enumerate(path):
                p_node[i, leaf, k] = node
                p_dir[i, leaf, k] = go_left
                p_prev[i, leaf, k] = prev[k]
            for k, (act, n, z, os_) in enumerate(exts):
                e_act[i, leaf, k], e_n[i, leaf, k] = act, float(n)
                e_z[i, leaf, k], e_os[i, leaf, k] = z, os_
            for k, (act, n, z, os_) in enumerate(unws):
                u_act[i, leaf, k], u_n[i, leaf, k] = act, float(n)
                u_z[i, leaf, k], u_os[i, leaf, k] = z, os_
            for s, (act, n, z, os_, feat) in enumerate(sums):
                s_act[i, leaf, s], s_n[i, leaf, s] = act, float(n)
                s_z[i, leaf, s], s_os[i, leaf, s] = z, os_
                ranks[i].setdefault(int(feat), []).append(int(leaf) * S + s)
        if ranks[i]:
            r_max = max(r_max, max(len(v) for v in ranks[i].values()))
    g_idx = np.full((T, int(ncol), r_max), L * S, np.int64)
    for i in range(T):
        for feat, flat in ranks[i].items():
            g_idx[i, feat, :len(flat)] = flat
    return ContribSchedule(
        depth=depth, path_node=p_node, path_dir=p_dir, prev_occ=p_prev,
        ext_act=e_act, ext_n=e_n, ext_z=e_z, ext_os=e_os,
        unw_act=u_act, unw_n=u_n, unw_z=u_z, unw_os=u_os,
        sum_act=s_act, sum_n=s_n, sum_z=s_z, sum_os=s_os,
        leaf_value=lv, expected=ev, gather_idx=g_idx)


def contrib_block(stack, sc: ContribSchedule, rows: torch.Tensor,
                  t0: int, t1: int, phi: torch.Tensor) -> torch.Tensor:
    """phi [n, C] plus the contributions of trees t0..t1-1 (``sc`` holds
    their device schedules, [G, ...]): the hot bits from the predictor's
    decide, every leaf's op schedule replayed in f64, and the terms added
    in the canonical order (contrib_scan, predict_contrib.py:304-480)."""
    n = rows.shape[0]
    dev = rows.device
    g, l_dim, d = sc.path_node.shape
    p = d + 1
    c = phi.shape[1]
    f64 = torch.float64
    zero = torch.zeros((n, g, l_dim), dtype=f64, device=dev)
    if d:
        M = stack.M
        flat = (torch.arange(t0, t1, device=dev)[:, None] * M
                + torch.arange(M, device=dev)[None, :]).view(-1)
        go_left = stack.decide(rows, flat).view(n, g, M)
        gi = torch.arange(g, device=dev)[:, None, None]
        hot = go_left[:, gi, sc.path_node] == sc.path_dir[None]  # [n,g,L,D]
        live = (torch.arange(d, device=dev)[None, None]
                < sc.depth[..., None])
        hot = hot | ~live[None]
        # opre[..., k]: the AND of the hot bits of the steps j <= k on step
        # k's feature, chained through prev_occ (one gather a step)
        opre = torch.empty((n, g, l_dim, d), dtype=torch.bool, device=dev)
        opre[..., 0] = hot[..., 0]
        for k in range(1, d):
            prev = sc.prev_occ[..., k]
            sel = opre.gather(-1, torch.clamp(prev, 0, k - 1)[None, ..., None]
                              .expand(n, g, l_dim, 1))[..., 0]
            opre[..., k] = hot[..., k] & torch.where(prev[None] < 0, True,
                                                     sel)

    def o_of(os_idx):
        if d == 0:
            return torch.ones((n, g, l_dim), dtype=f64, device=dev)
        sel = opre.gather(-1, torch.clamp(os_idx, 0, d - 1)[None, ..., None]
                          .expand(n, g, l_dim, 1))[..., 0]
        return torch.where(os_idx[None] < 0, True, sel).to(f64)

    # pweights: p tensors [n, g, L], updated by the slot replay (ext_0,
    # unw_0, ext_1, ..., unw_{D-1}, ext_D, then the sums)
    w = [zero for _ in range(p)]
    for k in range(d + 1):
        # extend slot k (Tree._extend_path, op for op)
        act = sc.ext_act[..., k][None]
        n_f = sc.ext_n[..., k][None]
        z = sc.ext_z[..., k][None]
        o = o_of(sc.ext_os[..., k])
        np1 = n_f + 1.0
        init = torch.where(n_f == 0.0, 1.0, 0.0).to(f64)
        for i in range(min(k, p - 1) + 1):
            w[i] = torch.where(act & (n_f == i), init, w[i])
        for i in range(min(k - 1, p - 2), -1, -1):
            act_i = act & (n_f > i)
            t1_ = ((o * w[i]) * (i + 1.0)) / np1
            w[i + 1] = torch.where(act_i, w[i + 1] + t1_, w[i + 1])
            t2_ = ((z * w[i]) * (n_f - i)) / np1
            w[i] = torch.where(act_i, t2_, w[i])
        if k >= d:
            break
        # unwind slot k (Tree._unwind_path)
        act = sc.unw_act[..., k][None]
        n_f = sc.unw_n[..., k][None]
        z = sc.unw_z[..., k][None]
        o = o_of(sc.unw_os[..., k])
        np1 = n_f + 1.0
        hi = min(k, p - 1)
        nxt = w[0]
        for i in range(1, hi + 1):
            nxt = torch.where(n_f == i, w[i], nxt)
        hot_sel = o != 0.0
        for i in range(hi - 1, -1, -1):
            act_i = act & (n_f > i)
            w_hot = (nxt * np1) / ((i + 1.0) * o)
            n_hot = w[i] - (((w_hot * z) * (n_f - i)) / np1)
            w_cold = (w[i] * np1) / (z * (n_f - i))
            w_new = torch.where(hot_sel, w_hot, w_cold)
            nxt = torch.where(act_i & hot_sel, n_hot, nxt)
            w[i] = torch.where(act_i, w_new, w[i])
    # unwound sums (Tree._unwound_path_sum) and the emitted terms
    s_dim = sc.sum_act.shape[2]
    terms = []
    for s in range(s_dim):
        act = sc.sum_act[..., s][None]
        n_f = sc.sum_n[..., s][None]
        z = sc.sum_z[..., s][None]
        o = o_of(sc.sum_os[..., s])
        np1 = n_f + 1.0
        nxt = w[0]
        for i in range(1, p):
            nxt = torch.where(n_f == i, w[i], nxt)
        hot_sel = o != 0.0
        z_ok = z != 0.0
        total = zero
        for j in range(p - 2, -1, -1):
            act_j = act & (n_f > j)
            q = (n_f - j) / np1
            tmp = (nxt * np1) / ((j + 1.0) * o)
            tot_hot = total + tmp
            n_hot = w[j] - ((tmp * z) * q)
            tot_cold = total + (w[j] / z) / q
            new_tot = torch.where(hot_sel, tot_hot,
                                  torch.where(z_ok, tot_cold, total))
            total = torch.where(act_j, new_tot, total)
            nxt = torch.where(act_j & hot_sel, n_hot, nxt)
        terms.append(torch.where(act, (total * (o - z))
                                 * sc.leaf_value[None], 0.0))
    tflat = torch.cat([torch.stack(terms, dim=-1).view(n, g, l_dim * s_dim)
                       if terms else zero[..., :0],
                       torch.zeros((n, g, 1), dtype=f64, device=dev)], dim=-1)
    del terms, w
    # per tree: the expected value, then every column's terms in (leaf,
    # slot) rank order (ordered f64 adds; sentinel ranks add exact zeros),
    # then one add into phi, as the host's ``out += tree.predict_contrib``
    r_dim = sc.gather_idx.shape[2]
    for j in range(g):
        phi_t = torch.zeros((n, c), dtype=f64, device=dev)
        phi_t[:, c - 1] = sc.expected[j]
        tj = tflat[:, j]
        for r in range(r_dim):
            phi_t = phi_t + tj[:, sc.gather_idx[j, :, r]]
        phi = phi + phi_t
    return phi


class ContribPlan:
    """The harvested schedule of one predictor's trees for one phi width,
    on the predictor's device, and its row chunking."""

    def __init__(self, trees: List[Tree], ncol: int, stack) -> None:
        self.stack = stack
        self.ncol = int(ncol)
        self.T = len(trees)
        self._blocks: dict = {}
        self._block_size = 0
        host = harvest_contrib_host(trees, self.ncol) if trees else None
        self.sched = (None if host is None else ContribSchedule(*[
            torch.as_tensor(np.ascontiguousarray(a), device=stack.device)
            for a in host]))
        if host is not None:
            L, D = host.path_node.shape[1], host.path_node.shape[2]
            S = host.sum_act.shape[2]
            # f64 [rows, tree, leaf] tensors alive at once (pweights, terms
            # and their stack, the replay's temporaries) and two bool planes
            self.per_pair = (D + 1 + 2 * S + 16) * L * 8 + 2 * D * L

    def plan(self, n: int):
        """(rows per chunk, trees per block) under :data:`CONTRIB_BYTES`."""
        rows = max(1, min(n, CONTRIB_BYTES // self.per_pair))
        trees = max(1, min(self.T, CONTRIB_BYTES // (rows * self.per_pair)))
        return rows, trees

    def __call__(self, X) -> np.ndarray:
        n = len(X)
        out = np.zeros((n, self.ncol), np.float64)
        if self.T == 0 or n == 0:
            return out
        rows_per, block = self.plan(n)
        if block != self._block_size:
            self._blocks, self._block_size = {}, block
        stack = self.stack
        for lo in range(0, n, rows_per):
            rows = stack.rows_to_device(X[lo:lo + rows_per], torch.float32)
            phi = torch.zeros((rows.shape[0], self.ncol),
                              dtype=torch.float64, device=stack.device)
            for t0 in range(0, self.T, block):
                t1 = min(self.T, t0 + block)
                sc = self._blocks.get(t0)
                if sc is None:
                    sc = self._blocks[t0] = self._block(t0, t1)
                phi = contrib_block(stack, sc, rows, t0, t1, phi)
            out[lo:lo + rows.shape[0]] = phi.cpu().numpy()
        return out

    def _block(self, t0: int, t1: int) -> ContribSchedule:
        """The schedule of trees t0..t1-1, cut to their own depth, sum slots
        and ranks (the term indices renumbered for the cut slots)."""
        sc = ContribSchedule(*[a[t0:t1] for a in self.sched])
        L, S = sc.sum_act.shape[1], sc.sum_act.shape[2]
        d = int(sc.depth.max())
        s = int(sc.sum_act.sum(dim=2).max())
        gidx = sc.gather_idx
        sent = gidx == L * S
        r = int((~sent).sum(dim=2).max()) if gidx.numel() else 0
        gidx = torch.where(sent, L * s,
                           (gidx // max(S, 1)) * s + gidx % max(S, 1))
        return sc._replace(gather_idx=gidx[..., :r],
            path_node=sc.path_node[..., :d], path_dir=sc.path_dir[..., :d],
            prev_occ=sc.prev_occ[..., :d], ext_act=sc.ext_act[..., :d + 1],
            ext_n=sc.ext_n[..., :d + 1], ext_z=sc.ext_z[..., :d + 1],
            ext_os=sc.ext_os[..., :d + 1], unw_act=sc.unw_act[..., :d],
            unw_n=sc.unw_n[..., :d], unw_z=sc.unw_z[..., :d],
            unw_os=sc.unw_os[..., :d], sum_act=sc.sum_act[..., :s],
            sum_n=sc.sum_n[..., :s], sum_z=sc.sum_z[..., :s],
            sum_os=sc.sum_os[..., :s])
