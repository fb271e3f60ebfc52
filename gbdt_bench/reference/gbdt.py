"""Plain reference of gradient-boosted trees as the benchmark's cells train
them, in NumPy and plain PyTorch, f64 unless a caller asks for less.

It follows the published semantics, not the program's code:

- bin boundaries (LightGBM src/io/bin.cpp ``GreedyFindBin``,
  ``FindBinWithZeroAsOneBin`` and ``BinMapper::FindBin``): sorted sample
  values, neighbours within one ULP merged into the larger, an empty zero
  bin at the sign change, count-balanced cuts, each bound the midpoint of
  its two values nudged one ULP up;
- the bin-construct sample: the ``bin_construct_sample_cnt`` rows with the
  smallest splitmix64 keys of ``row id ^ splitmix64(data_random_seed)``;
- binary log loss (binary_objective.hpp): ``g = -y / (1 + exp(y s))``,
  ``h = |g| (1 - |g|)`` with ``y`` in {-1, +1}, starting from
  ``log(p / (1 - p))``;
- quantized gradients: each row's g and h scaled to ``levels`` integer
  steps of ``max|g| / levels`` and ``max h / hess_levels`` and rounded
  down after adding a stateless uniform of (seed, iteration, row id)
  (xxhash32's avalanche over a keyed id, 24 bits kept); the
  hessian takes the reflected uniform; zeros stay zero;
- the split of a leaf (feature_histogram.hpp ``FindBestThreshold`` for
  numerical features without missing values): candidates ``bin <= t``
  left, counts estimated from hessians (``round(h * n / H)`` per bin),
  ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf`` on both sides, the
  gain ``GL^2 / HL + GR^2 / HR`` over the leaf's ``G^2 / H``; a child
  inherits the estimated count of its side as its own;
- leaf-wise growth splits the leaf with the largest gain; level-wise
  growth splits, depth by depth, every leaf of the depth whose gain is
  positive, in ascending leaf id, while the leaf budget lasts, on
  ``ceil(log2 num_leaves)`` levels (the benchmarked package's level mode
  with no ``max_depth``); a split of
  leaf ``l`` at node ``i`` keeps ``l`` on the left and makes leaf ``i + 1``
  on the right;
- the leaf value ``-G / H`` of the leaf's rows, times the learning rate.
"""
from __future__ import annotations

import bisect
import functools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

K_ZERO = 1e-35
K_EPS = 1e-15
# a gain within this share of a leaf's G^2 / H of another is a tie to f32
NOISE = 1e-4
F64 = torch.float64
F32 = torch.float32

# ---------------------------------------------------------------- bins ----

_U = np.uint64


def splitmix64(z: np.ndarray) -> np.ndarray:
    """The splitmix64 finaliser of uint64 ``z`` (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        z = (z + _U(0x9E3779B97F4A7C15)).astype(_U)
        z = ((z ^ (z >> _U(30))) * _U(0xBF58476D1CE4E5B9)).astype(_U)
        z = ((z ^ (z >> _U(27))) * _U(0x94D049BB133111EB)).astype(_U)
        return z ^ (z >> _U(31))


def sample_indices(n: int, count: int, seed: int) -> np.ndarray:
    """Ascending ids of the ``count`` rows with the smallest keys (ties by
    id); every row when ``n <= count``."""
    if n <= count:
        return np.arange(n)
    seed_key = splitmix64(np.array([seed], dtype=_U))[0]
    keys = splitmix64(np.arange(n, dtype=_U) ^ seed_key)
    kth = np.partition(keys, count - 1)[count - 1]
    below = np.flatnonzero(keys < kth)
    at = np.flatnonzero(keys == kth)[:count - len(below)]
    return np.sort(np.concatenate([below, at]))


def distinct_counts(values: np.ndarray, zero_cnt: int,
                    presorted: bool = False):
    """Sorted distinct values and their counts (bin.cpp FindBin): values
    within one ULP of their predecessor join its group, which keeps its
    largest value; zero enters with ``zero_cnt`` where the sign changes (or
    at an end)."""
    v = np.asarray(values, dtype=np.float64)
    if not presorted:
        v = np.sort(v, kind="stable")
    n = len(v)
    if n == 0:
        return np.array([0.0]), np.array([zero_cnt], dtype=np.int64)
    start = np.ones(n, dtype=bool)
    start[1:] = v[1:] > np.nextafter(v[:-1], np.inf)
    starts = np.flatnonzero(start)
    reps = v[np.append(starts[1:], n) - 1]
    cnts = np.diff(np.append(starts, n)).astype(np.int64)
    # a group starting at a sign change gets a zero entry before it
    k = np.flatnonzero((v[starts[1:] - 1] < 0.0) & (v[starts[1:]] > 0.0))
    if len(k):
        reps = np.insert(reps, k[0] + 1, 0.0)
        cnts = np.insert(cnts, k[0] + 1, zero_cnt)
    if v[0] > 0.0 and zero_cnt > 0:
        reps = np.insert(reps, 0, 0.0)
        cnts = np.insert(cnts, 0, zero_cnt)
    if v[-1] < 0.0 and zero_cnt > 0:
        reps = np.append(reps, 0.0)
        cnts = np.append(cnts, zero_cnt)
    return reps, cnts


def _up(x: float) -> float:
    return math.nextafter(x, math.inf)


def greedy_bounds(vals: np.ndarray, cnts: np.ndarray, max_bin: int,
                  total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Count-balanced upper bounds of one value range (GreedyFindBin)."""
    n = len(vals)
    bounds: List[float] = []
    if n == 0:
        return [math.inf]
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += int(cnts[i])
            if cur >= min_data_in_bin:
                val = _up((float(vals[i]) + float(vals[i + 1])) / 2.0)
                if not bounds or val > _up(bounds[-1]):
                    bounds.append(val)
                    cur = 0
        return bounds + [math.inf]
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt // min_data_in_bin)))
    if total_cnt == n:
        # every value once: the cuts depend on (n, max_bin) alone
        cut = np.array(_unit_cuts(n, max_bin), dtype=np.int64)
        return _midpoint_bounds(vals[cut], vals[cut + 1])
    big = cnts >= total_cnt / max_bin
    rest_bins = max_bin - int(big.sum())
    rest_cnt = int(total_cnt - cnts[big].sum())
    mean = rest_cnt / rest_bins
    # the per-value loop, jumping to each cut: the first value from `s` on
    # that is big, or whose count in the bin reaches the mean, or that comes
    # before a big value with half the mean in the bin (Python lists and
    # bisect: a cut costs microseconds)
    csum = np.cumsum(cnts).tolist()
    any_big = bool(big.any())
    csum_small = (np.cumsum(np.where(big, 0, cnts)).tolist() if any_big
                  else csum)
    big_at = np.flatnonzero(big[:n - 1]).tolist()
    pre_big = np.flatnonzero(big[1:]).tolist()

    def first_at_or_after(pos: List[int], s: int) -> int:
        k = bisect.bisect_left(pos, s)
        return pos[k] if k < len(pos) else n

    cuts: List[int] = []
    s, base, base_small = 0, 0, 0
    while s <= n - 2:
        i = max(s, bisect.bisect_left(csum, base + math.ceil(mean)))
        if any_big:
            i = min(i, first_at_or_after(big_at, s))
            half = base + math.ceil(max(1.0, mean * 0.5))
            i = min(i, first_at_or_after(
                pre_big, max(s, bisect.bisect_left(csum, half))))
        if i > n - 2:
            break
        cuts.append(i)
        if len(cuts) >= max_bin - 1:
            break
        rest_cnt -= csum_small[i] - base_small
        if not big[i]:
            rest_bins -= 1
            mean = rest_cnt / rest_bins
        base, base_small, s = csum[i], csum_small[i], i + 1
    cut = np.array(cuts, dtype=np.int64)
    return _midpoint_bounds(vals[cut], vals[cut + 1])


def _midpoint_bounds(upper: np.ndarray, lower: np.ndarray) -> List[float]:
    """Each cut's bound, the midpoint of the values on its two sides one ULP
    up, a bound within one ULP of the one before dropped; then infinity."""
    mids = np.nextafter((upper + lower) / 2.0, np.inf).tolist()
    bounds: List[float] = []
    for val in mids:
        if not bounds or val > _up(bounds[-1]):
            bounds.append(val)
    return bounds + [math.inf]


@functools.lru_cache(maxsize=4096)
def _unit_cuts(n: int, max_bin: int) -> tuple:
    """The cut indices of ``GreedyFindBin`` over ``n`` values seen once
    each (no value is big: a bin's mean is above one)."""
    rest_bins, rest_cnt = max_bin, n
    mean = rest_cnt / rest_bins
    cuts, s = [], 0
    while s <= n - 2:
        i = max(s, s + math.ceil(mean) - 1)
        if i > n - 2:
            break
        cuts.append(i)
        if len(cuts) >= max_bin - 1:
            break
        rest_cnt -= i + 1 - s
        rest_bins -= 1
        mean = rest_cnt / rest_bins
        s = i + 1
    return tuple(cuts)


def zero_as_one_bin(vals: np.ndarray, cnts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Negative values, one bin around zero, positive values
    (FindBinWithZeroAsOneBin); ``vals`` ascending."""
    left_cnt = int(np.searchsorted(vals, -K_ZERO, side="right"))
    right_start = int(np.searchsorted(vals, K_ZERO, side="right"))
    left_cnt_data = int(cnts[:left_cnt].sum())
    cnt_zero = int(cnts[left_cnt:right_start].sum())
    right_cnt_data = int(cnts[right_start:].sum())
    bounds: List[float] = []
    if left_cnt > 0:
        left_max = max(1, int(left_cnt_data / (total_cnt - cnt_zero)
                              * (max_bin - 1)))
        bounds = greedy_bounds(vals[:left_cnt], cnts[:left_cnt], left_max,
                               left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO
    right_max = max_bin - 1 - len(bounds)
    if right_start < len(vals) and right_max > 0:
        right = greedy_bounds(vals[right_start:], cnts[right_start:],
                              right_max, right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO)
        bounds.extend(right)
    else:
        bounds.append(math.inf)
    return bounds


def feature_bounds(column: np.ndarray, max_bin: int,
                   min_data_in_bin: int = 3,
                   presorted: bool = False) -> np.ndarray:
    """Upper bounds of one feature's bins from its sampled values (no
    missing values: the benchmark's data has none)."""
    col = np.asarray(column, dtype=np.float64)
    if np.isnan(col).any():
        raise ValueError("the reference bins data without missing values")
    nz = col[col != 0.0]
    vals, cnts = distinct_counts(nz, len(col) - len(nz), presorted)
    bounds = np.array(zero_as_one_bin(vals, cnts, max_bin, len(col),
                                      min_data_in_bin))
    if len(bounds) <= 1:
        raise ValueError("a constant feature: the benchmark's data has none")
    return bounds


def find_bounds(X_sample, max_bin: int,
                min_data_in_bin: int = 3) -> List[np.ndarray]:
    """Each feature's bin upper bounds from the sampled rows ([m, F], a
    tensor or an array): the columns sorted in one call."""
    S = torch.as_tensor(X_sample).to(F64)
    S = torch.sort(S, dim=0).values.T.contiguous().cpu().numpy()
    return [feature_bounds(S[f], max_bin, min_data_in_bin, presorted=True)
            for f in range(S.shape[0])]


def bin_matrix(X: torch.Tensor, bounds: Sequence[np.ndarray]) -> torch.Tensor:
    """[n, F] bins of raw ``X``: the first bound at or above the value."""
    nb_max = max(len(b) for b in bounds)
    dtype = torch.uint8 if nb_max <= 256 else torch.int16
    out = torch.empty(X.shape, dtype=dtype, device=X.device)
    for f, b in enumerate(bounds):
        bt = torch.as_tensor(b, dtype=F64, device=X.device)
        idx = torch.searchsorted(bt, X[:, f].to(F64))
        out[:, f] = idx.clamp_(max=len(b) - 1).to(dtype)
    return out


# ---------------------------------------------------------- gradients ----

def init_score(y: np.ndarray) -> float:
    """log(p / (1 - p)) of the positive share."""
    p = float((np.asarray(y) > 0).astype(np.float64).mean())
    p = min(max(p, K_EPS), 1.0 - K_EPS)
    return float(np.log(p / (1.0 - p)))


def binary_gradients(score: torch.Tensor, yv: torch.Tensor):
    """g, h of the binary log loss at ``score``, in ``score``'s dtype; ``yv``
    holds -1 and +1 in that dtype."""
    r = -yv / (1.0 + torch.exp(yv * score))
    a = r.abs()
    return r, a * (1.0 - a)


def quant_uniforms(n: int, seed: int, it: int) -> np.ndarray:
    """The stateless f32 uniform in [0, 1) of each row id for iteration
    ``it``: xxhash32's avalanche over the keyed id, its top 24 bits."""
    m = _U(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        x = np.arange(n, dtype=_U) & m
        x ^= _U((int(seed) * 2654435761) & 0xFFFFFFFF)
        x ^= _U(0x7FB5D591)
        x = (x + _U((int(it) * 0x9E3779B9) & 0xFFFFFFFF)) & m
        x ^= x >> _U(16)
        x = (x * _U(2246822519)) & m
        x ^= x >> _U(13)
        x = (x * _U(3266489917)) & m
        x ^= x >> _U(16)
    return ((x >> _U(8)).astype(np.float32) * np.float32(2.0 ** -24))


def quantize(g32: torch.Tensor, h32: torch.Tensor, it: int, seed: int,
             grad_levels: int = 127, hess_levels: int = 255):
    """Integer levels of f32 ``g32``, ``h32`` and their scales: ``(qg, qh,
    s_g, s_h)`` with the real value ``q * s`` (f32 arithmetic)."""
    dev = g32.device
    tiny = torch.tensor(1e-30, dtype=F32, device=dev)
    s_g = torch.maximum(g32.abs().max(), tiny) / grad_levels
    s_h = torch.maximum(h32.max(), tiny) / hess_levels
    u = torch.from_numpy(quant_uniforms(g32.numel(), seed, it)).to(dev)
    u_h = torch.tensor(1.0 - 2.0 ** -24, dtype=F32, device=dev) - u
    qg = torch.clamp(torch.floor(g32 / s_g + u), -grad_levels, grad_levels)
    qh = torch.clamp(torch.floor(h32 / s_h + u_h), 0, hess_levels)
    qg = torch.where(g32 == 0, torch.zeros_like(qg), qg)
    qh = torch.where(h32 == 0, torch.zeros_like(qh), qh)
    return qg, qh, s_g, s_h


# --------------------------------------------------------------- trees ----

@dataclass
class Tree:
    """One tree as the model text holds it: node ``i`` splits on
    ``feature[i]`` at the raw ``threshold[i]`` (``x <= threshold`` goes
    left); a child ``c < 0`` is leaf ``~c``; ``leaf_value`` is the tree's
    output, the learning rate applied (and, in the first tree, the starting
    score added)."""
    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_value: np.ndarray
    leaf_count: Optional[np.ndarray] = None

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_value)

    def split_leaves(self) -> np.ndarray:
        """The leaf each node split: the leftmost leaf below it (a split
        keeps its leaf's id on the left)."""
        out = np.empty(len(self.feature), dtype=np.int64)
        for i in range(len(self.feature)):
            j = i
            while self.left[j] >= 0:
                j = self.left[j]
            out[i] = ~self.left[j]
        return out

    def depths(self) -> np.ndarray:
        """Each leaf's depth."""
        d = np.zeros(self.num_leaves, dtype=np.int64)
        stack = [(0, 0)] if len(self.feature) else []
        while stack:
            node, k = stack.pop()
            for c in (self.left[node], self.right[node]):
                if c < 0:
                    d[~c] = k + 1
                else:
                    stack.append((c, k + 1))
        return d


def route(tree: Tree, X: torch.Tensor) -> torch.Tensor:
    """[n] leaf of each row of raw ``X`` (f64 comparisons)."""
    n = X.shape[0]
    dev = X.device
    if len(tree.feature) == 0:
        return torch.zeros(n, dtype=torch.long, device=dev)
    feat = torch.as_tensor(tree.feature, dtype=torch.long, device=dev)
    thr = torch.as_tensor(tree.threshold, dtype=F64, device=dev)
    left = torch.as_tensor(tree.left, dtype=torch.long, device=dev)
    right = torch.as_tensor(tree.right, dtype=torch.long, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    for _ in range(int(tree.depths().max())):
        inner = node >= 0
        at = node.clamp(min=0)
        x = X.gather(1, feat[at][:, None])[:, 0].to(F64)
        nxt = torch.where(x <= thr[at], left[at], right[at])
        node = torch.where(inner, nxt, node)
    return ~node


def predict(trees: Sequence[Tree], X: torch.Tensor,
            dtype=F64) -> torch.Tensor:
    """Sum of the trees' outputs over raw ``X``, accumulated in ``dtype``."""
    out = torch.zeros(X.shape[0], dtype=dtype, device=X.device)
    for t in trees:
        lv = torch.as_tensor(t.leaf_value, dtype=F64, device=X.device)
        out = out + lv[route(t, X)].to(dtype)
    return out


# -------------------------------------------------------------- growth ----

@dataclass
class Params:
    num_leaves: int = 255
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    level: bool = False


@dataclass
class _Leaf:
    idx: Optional[torch.Tensor]      # row ids (None: every row)
    hist: torch.Tensor               # [2, F, NB] f64
    G: float
    H: float
    nd: float                        # estimated count (the root's: true)
    depth: int
    rows: int
    gain: float = -math.inf          # best improvement
    f: int = -1
    t: int = -1


@dataclass
class Grown:
    """A grown (or followed) tree: its nodes as bin thresholds, each leaf's
    f64 sums and row count, the row ids of each leaf, and, when following,
    how far each of the followed splits fell below this reference's best
    (a share of the best gain; 1 where the reference has no split)."""
    feature: List[int] = field(default_factory=list)
    thr_bin: List[int] = field(default_factory=list)
    left: List[int] = field(default_factory=list)
    right: List[int] = field(default_factory=list)
    G: np.ndarray = None
    H: np.ndarray = None
    rows: np.ndarray = None
    leaf_idx: List[Optional[torch.Tensor]] = None
    gaps: List[float] = field(default_factory=list)

    def values(self, lambda_l2: float = 0.0) -> np.ndarray:
        return -self.G / (self.H + lambda_l2)


class Grower:
    """Tree growth over the bins of one training set, f64 throughout."""

    def __init__(self, X: torch.Tensor, bins: torch.Tensor,
                 bounds: Sequence[np.ndarray], params: Params) -> None:
        self.X, self.bins, self.bounds, self.p = X, bins, bounds, params
        self.n, self.F = bins.shape
        self.NB = max(len(b) for b in bounds)
        dev = bins.device
        self.dev = dev
        self.offs = torch.arange(self.F, device=dev) * self.NB
        nb = torch.as_tensor([len(b) for b in bounds], device=dev)
        t = torch.arange(self.NB, device=dev)
        self.valid = t[None, :] <= nb[:, None] - 2          # [F, NB]

    # ---- histograms and the split scan

    def histogram(self, idx: Optional[torch.Tensor], g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
        """[2, F, NB] f64 sums of g and h by (feature, bin) over rows."""
        F, NB = self.F, self.NB
        out = torch.zeros(2, F * NB, dtype=F64, device=self.dev)
        m = self.n if idx is None else len(idx)
        step = max(1, (1 << 24) // F)
        for s in range(0, m, step):
            e = min(m, s + step)
            r = (torch.arange(s, e, device=self.dev) if idx is None
                 else idx[s:e])
            ids = (self.bins[r].long() + self.offs).reshape(-1)
            vals = torch.stack([g[r], h[r]]).to(F64)[:, :, None]
            out.index_add_(1, ids, vals.expand(2, e - s, F).reshape(2, -1))
        return out.view(2, F, NB)

    def _sides(self, hist, G, H, nd):
        """Left and right sums, estimated counts and the raw improvement
        of every (feature, threshold) candidate of a leaf."""
        p = self.p
        g, h = hist[0], hist[1]
        tot_h = H + 2 * K_EPS
        c = torch.round(h * (nd / tot_h))
        pg, ph, pc = g.cumsum(-1), h.cumsum(-1), c.cumsum(-1)
        rg = pg[:, -1:] - pg
        rh = ph[:, -1:] - ph + K_EPS
        rc = pc[:, -1:] - pc
        lg, lh, lc = G - rg, tot_h - rh, nd - rc
        gain = (lg * lg / (lh + p.lambda_l2) + rg * rg / (rh + p.lambda_l2))
        shift = G * G / (tot_h + p.lambda_l2) + p.min_gain_to_split
        return lg, lh, lc, rg, rh, rc, gain - shift

    def _ok(self, lh, lc, rh, rc, imp):
        p = self.p
        return ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                & (lh >= p.min_sum_hessian_in_leaf)
                & (rh >= p.min_sum_hessian_in_leaf) & (imp > 0))

    def scan(self, leaf: _Leaf) -> None:
        """The leaf's best candidate: the largest improvement; among equal
        ones the largest threshold of a feature, then the first feature."""
        lg, lh, lc, rg, rh, rc, imp = self._sides(leaf.hist, leaf.G, leaf.H,
                                                  leaf.nd)
        ok = self.valid & self._ok(lh, lc, rh, rc, imp)
        imp = torch.where(ok, imp, torch.full_like(imp, -math.inf))
        t = (self.NB - 1) - torch.argmax(torch.flip(imp, [-1]), -1)
        per_f = imp.gather(1, t[:, None])[:, 0]
        f = int(torch.argmax(per_f))
        leaf.gain, leaf.f, leaf.t = float(per_f[f]), f, int(t[f])

    def evaluate(self, leaf: _Leaf, f: int, t: int):
        """(improvement, within the limits, left estimated count, right
        estimated count) of candidate (f, t).  The limits are held at half
        their value: the program estimates counts in f32 along a chain of
        estimates, which can move a count by a few rows."""
        lg, lh, lc, rg, rh, rc, imp = self._sides(
            leaf.hist[:, f:f + 1], leaf.G, leaf.H, leaf.nd)
        lh, lc, rh, rc, imp = (float(a[0, t]) for a in (lh, lc, rh, rc, imp))
        p = self.p
        ok = (t <= len(self.bounds[f]) - 2
              and min(lc, rc) >= 0.5 * p.min_data_in_leaf
              and min(lh, rh) >= 0.5 * p.min_sum_hessian_in_leaf)
        return imp, ok, lc, rc

    @staticmethod
    def noise(leaf: _Leaf) -> float:
        """What f32 rounding in the program's split scan can move a gain
        of this leaf by: ``NOISE`` of its ``G^2 / H`` and best gain."""
        best = leaf.gain if leaf.gain > 0 else 0.0
        return NOISE * (leaf.G * leaf.G / max(leaf.H, K_EPS) + best)

    def _gap(self, leaf: _Leaf, best: float, tau: float, imp: float,
             ok: bool) -> float:
        """How far a split taken at ``leaf`` falls below ``best``, as a
        share of it (of ``tau`` where the best is within rounding of 0); 1
        for a split outside the limits; a split where the reference finds
        no candidate within the limits passes if it gains."""
        if not ok:
            return 1.0
        if best == -math.inf:
            return 0.0 if imp > -self.noise(leaf) else 1.0
        return max(0.0, best - imp) / max(best, tau)

    # ---- growth

    def _root(self, g, h) -> _Leaf:
        hist = self.histogram(None, g, h)
        leaf = _Leaf(None, hist, float(hist[0, 0].sum()),
                     float(hist[1, 0].sum()), float(self.n), 0, self.n)
        self.scan(leaf)
        return leaf

    def _split(self, leaves: List[_Leaf], l: int, f: int, thr: float,
               lc: float, rc: float, g, h) -> None:
        parent = leaves[l]
        x = (self.X[:, f] if parent.idx is None
             else self.X[parent.idx, f]).to(F64)
        go_left = x <= thr
        if parent.idx is None:
            li = torch.nonzero(go_left)[:, 0]
            ri = torch.nonzero(~go_left)[:, 0]
        else:
            li, ri = parent.idx[go_left], parent.idx[~go_left]
        small_left = len(li) <= len(ri)
        small = self.histogram(li if small_left else ri, g, h)
        large = parent.hist - small
        hl, hr = (small, large) if small_left else (large, small)
        kids = []
        for idx, hist, nd in ((li, hl, lc), (ri, hr, rc)):
            kid = _Leaf(idx, hist, float(hist[0, 0].sum()),
                        float(hist[1, 0].sum()), nd, parent.depth + 1,
                        len(idx))
            self.scan(kid)
            kids.append(kid)
        leaves[l] = kids[0]
        leaves.append(kids[1])

    def thr_bin(self, f: int, thr: float) -> int:
        return int(np.searchsorted(self.bounds[f], thr))

    def _level_want(self, leaves: List[_Leaf], depth: int) -> List[int]:
        """The leaves level growth splits at ``depth``: those with a
        positive gain, in ascending id, as far as the budget allows, on the
        first ``ceil(log2 num_leaves)`` levels."""
        if depth >= max(1, math.ceil(math.log2(self.p.num_leaves))):
            return []
        want = [j for j, lf in enumerate(leaves)
                if lf.depth == depth and lf.gain > 0]
        return want[:self.p.num_leaves - len(leaves)]

    def _level_open(self, leaves: List[_Leaf], depth: int) -> dict:
        """A level of a followed level-wise tree: its frontier, the leaves
        whose gain is positive beyond rounding, and its leaf budget."""
        levels = max(1, math.ceil(math.log2(self.p.num_leaves)))
        frontier = [j for j, lf in enumerate(leaves) if lf.depth == depth]
        return {"depth": depth, "frontier": set(frontier),
                "definite": [j for j in frontier
                             if leaves[j].gain > self.noise(leaves[j])],
                "budget": (self.p.num_leaves - len(leaves)
                           if depth < levels else 0),
                "split": [], "last": -1}

    def _level_left(self, level: dict) -> float:
        """1 when a level left a leaf the rule splits: one positive beyond
        rounding, in ascending order within the budget; else 0."""
        split = set(level["split"])
        if len(split) < level["budget"]:
            left = [j for j in level["definite"] if j not in split]
        else:
            left = [j for j in level["definite"]
                    if j < max(split, default=-1) and j not in split]
        return 1.0 if left else 0.0

    def grow(self, g: torch.Tensor, h: torch.Tensor,
             follow: Optional[Tree] = None) -> Grown:
        """One tree on (g, h); with ``follow``, the splits of that tree in
        its order, each measured against this reference's best (gains
        within f32 rounding of each other, or of 0, tie)."""
        p = self.p
        leaves = [self._root(g, h)]
        out = Grown()
        parent_of = {0: None}        # leaf -> (node, side)
        todo = follow.split_leaves() if follow is not None else None
        queue: List[int] = []        # level growth: leaves still to split
        depth = -1
        level: dict = {}             # following level growth: this level
        while len(leaves) < p.num_leaves:
            i = len(out.feature)
            if follow is not None:
                if i >= len(todo):
                    break
                l = int(todo[i])
                f = int(follow.feature[i])
                thr = float(follow.threshold[i])
                t = self.thr_bin(f, thr)
            elif p.level:
                if not queue:
                    depth += 1
                    queue = self._level_want(leaves, depth)
                    if not queue:
                        break
                l = queue.pop(0)
                f, t = leaves[l].f, leaves[l].t
                thr = float(self.bounds[f][t])
            else:
                gains = [lf.gain for lf in leaves]
                l = int(np.argmax(gains))
                if not gains[l] > 0:
                    break
                f, t = leaves[l].f, leaves[l].t
                thr = float(self.bounds[f][t])
            imp, ok, lc, rc = self.evaluate(leaves[l], f, t)
            if follow is not None and p.level:
                if leaves[l].depth != level.get("depth"):
                    if level:
                        out.gaps.append(self._level_left(level))
                    level = self._level_open(leaves, leaves[l].depth)
                rule = (l in level["frontier"] and l > level["last"]
                        and (leaves[l].gain == -math.inf or leaves[l].gain
                             > -self.noise(leaves[l])))
                level["split"].append(l)
                level["last"] = l
                out.gaps.append(self._gap(
                    leaves[l], leaves[l].gain, self.noise(leaves[l]), imp,
                    ok) if rule else 1.0)
            elif follow is not None:
                top = max(leaves, key=lambda lf: lf.gain)
                out.gaps.append(self._gap(leaves[l], top.gain,
                                          self.noise(top), imp, ok))
            # the node, and the pointer that led to the leaf it splits
            out.feature.append(f)
            out.thr_bin.append(t)
            out.left.append(~l)
            out.right.append(~(i + 1))
            par = parent_of[l]
            if par is not None:
                (out.left if par[1] == 0 else out.right)[par[0]] = i
            parent_of[l] = (i, 0)
            parent_of[i + 1] = (i, 1)
            self._split(leaves, l, f, thr, lc, rc, g, h)
        if follow is not None:
            if p.level:
                if level:
                    out.gaps.append(self._level_left(level))
                nxt = self._level_open(leaves, level.get("depth", -1) + 1)
                if nxt["definite"] and nxt["budget"] > 0:
                    out.gaps.append(1.0)   # a level the rule still splits
            elif len(leaves) < p.num_leaves and any(
                    lf.gain > self.noise(lf) for lf in leaves):
                out.gaps.append(1.0)       # stopped with a split left
        out.G = np.array([lf.G for lf in leaves])
        out.H = np.array([lf.H for lf in leaves])
        out.rows = np.array([lf.rows for lf in leaves])
        out.leaf_idx = [lf.idx for lf in leaves]
        return out
