"""The comparison that decides a training cell's ``correct``.

What a trained model is judged on (``Outputs``): the bin bounds it trained
on, its trees as the model text gives them, the number of iterations it was
driven through, its training scores after the last one, and its raw scores
of the held-out rows.  :func:`judge` works everything out again from the
raw rows and labels with the plain reference (``gbdt.py``) and returns one
number a check:

- ``trees_off``: trees in the model against iterations driven (exact);
- ``bins_off``: features whose bounds differ from the reference's (exact);
- ``split_gap``: over every split of the first three trees, how far the
  split taken falls below the best the reference finds there, as a share
  of that best (gains within f32 rounding tie; 1 where the reference would
  not split there, or would split where the tree stopped);
- ``leaf_gap``: over the first three trees, the row-weighted mean of each
  leaf value's distance from the reference's ``-G / H`` of the same rows,
  over the row-weighted mean of the reference's values;
- ``score_gap``: the largest distance of a training score from the sum of
  the model's trees over the raw rows, over the root mean square of those
  sums less the starting score;
- ``pred_gap``: the same for the held-out rows' scores.

The reference follows the model step by step: the gradients behind tree
``k`` come from the scores of the model's own trees ``0 .. k - 1`` over the
raw rows (with the starting score the reference works out itself for tree
0).  The last tree, the window's, is grown again too: ``split_gap_last``
and ``leaf_gap_last`` are the same two numbers over it alone.  A cell holds
those of its numbers that its ``workloads/<cell>.json`` gives a limit; the
others are reported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import gbdt as R

F64, F32 = torch.float64, torch.float32


@dataclass
class Data:
    """The raw rows both sides start from, and the cell's settings."""
    X: torch.Tensor              # [n, F] f32 on the device
    y: np.ndarray                # [n] 0/1
    X_test: torch.Tensor
    params: R.Params
    learning_rate: float
    max_bin: int
    sample_cnt: int
    data_random_seed: int
    quantized: bool
    quant_seed: int
    min_data_in_bin: int = 3
    _bounds: Optional[List[np.ndarray]] = None
    _bins: Optional[torch.Tensor] = None

    @property
    def bounds(self) -> List[np.ndarray]:
        if self._bounds is None:
            idx = R.sample_indices(self.X.shape[0], self.sample_cnt,
                                   self.data_random_seed)
            sample = self.X[torch.as_tensor(idx, device=self.X.device)]
            self._bounds = R.find_bounds(sample, self.max_bin,
                                         self.min_data_in_bin)
        return self._bounds

    @property
    def bins(self) -> torch.Tensor:
        if self._bins is None:
            self._bins = R.bin_matrix(self.X, self.bounds)
        return self._bins

    def grower(self) -> R.Grower:
        return R.Grower(self.X, self.bins, self.bounds, self.params)

    def signs(self, dtype) -> torch.Tensor:
        y = torch.as_tensor(self.y > 0, device=self.X.device)
        one = torch.ones((), dtype=dtype, device=self.X.device)
        return torch.where(y, one, -one)

    def gradients(self, score64: torch.Tensor, score32: torch.Tensor,
                  it: int, levels=(127, 255)):
        """g, h (f64) behind tree ``it``: exact from the f64 scores, or the
        quantized levels of the f32 ones times their scales."""
        if not self.quantized:
            return R.binary_gradients(score64, self.signs(F64))
        g32, h32 = R.binary_gradients(score32, self.signs(F32))
        qg, qh, sg, sh = R.quantize(g32, h32, it, self.quant_seed, *levels)
        return qg.to(F64) * float(sg), qh.to(F64) * float(sh)


@dataclass
class Outputs:
    """What a trained model is judged on."""
    bounds: List[np.ndarray]
    trees: List[R.Tree]
    iterations: int
    train_score: torch.Tensor    # [n]
    pred_test: torch.Tensor      # [n_test]


HELD = 3          # the first trees, whose numbers are held to limits


def checked_trees(n: int) -> List[int]:
    return sorted({k for k in (0, 1, 2, n - 1) if 0 <= k < n})


def _rel_max(a: torch.Tensor, b: torch.Tensor, base: float) -> float:
    d = (a.to(F64) - b.to(F64)).abs().max()
    ref = (b.to(F64) - base).pow(2).mean().sqrt()
    return float(d / ref.clamp(min=1e-300))


def judge(data: Data, out: Outputs) -> Dict[str, float]:
    """The numbers of the comparison (see the module docstring)."""
    init = R.init_score(data.y)
    bounds = data.bounds
    nums: Dict[str, float] = {}
    nums["trees_off"] = float(abs(len(out.trees) - out.iterations))
    nums["bins_off"] = float(abs(len(out.bounds) - len(bounds)) + sum(
        1 for a, b in zip(out.bounds, bounds)
        if len(a) != len(b) or not np.array_equal(a, b)))
    grower = data.grower()
    n = data.X.shape[0]
    dev = data.X.device
    s64 = torch.zeros(n, dtype=F64, device=dev)
    s32 = torch.full((n,), float(np.float32(init)), dtype=F32, device=dev)
    gaps = {"split_gap": 0.0, "leaf_gap": 0.0}
    check = set(checked_trees(len(out.trees)))
    lr = data.learning_rate
    for k, tree in enumerate(out.trees):
        base = init if k == 0 else 0.0
        if k in check:
            before = s64 if k else torch.full_like(s64, init)
            g, h = data.gradients(before, s32, k)
            grown = grower.grow(g, h, follow=tree)
            v_ref = grown.values(data.params.lambda_l2)
            v_out = (tree.leaf_value - base) / lr
            leaf_gap = 1.0
            if len(v_out) == len(v_ref):
                w = grown.rows.astype(np.float64)
                leaf_gap = float((w * np.abs(v_out - v_ref)).sum()
                                 / max((w * np.abs(v_ref)).sum(), 1e-300))
            for sfx in ("" if k < HELD else None,
                        "_last" if k == len(out.trees) - 1 else None):
                if sfx is not None:
                    gaps["split_gap" + sfx] = max(
                        [gaps.get("split_gap" + sfx, 0.0)] + grown.gaps)
                    gaps["leaf_gap" + sfx] = max(
                        gaps.get("leaf_gap" + sfx, 0.0), leaf_gap)
            del grown
        leaf = R.route(tree, data.X)
        s64 += torch.as_tensor(tree.leaf_value, dtype=F64, device=dev)[leaf]
        if data.quantized:
            step = (tree.leaf_value - base).astype(np.float32)
            s32 = s32 + torch.as_tensor(step, device=dev)[leaf]
    nums.update(gaps)
    nums["score_gap"] = _rel_max(out.train_score.to(dev), s64, init)
    p64 = R.predict(out.trees, data.X_test)
    nums["pred_gap"] = _rel_max(out.pred_test.to(dev), p64, init)
    return nums


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number held is there and within its limit (a
    number with no limit is reported, not held)."""
    return all(k in nums and nums[k] <= lim for k, lim in limits.items())


# ------------------------------------------------ the reference in place ----

VARIANTS = ("bf16", "int4", "half", "alter")


def train_reference(data: Data, n_trees: int, variant: str) -> Outputs:
    """The reference trained in the program's place, as a control or a
    fault: ``bf16`` computes every per-row value (gradients, hessians,
    leaf values, scores) in bfloat16; ``int4`` quantizes the gradients to
    7 and 15 levels instead of 127 and 255; ``half`` leaves out every odd
    row's gradients (the mean taken over the rest); ``alter`` negates the
    largest leaf of the second tree where it is produced."""
    if variant not in VARIANTS:
        raise ValueError("unknown variant %r" % variant)
    init = R.init_score(data.y)
    grower = data.grower()
    n = data.X.shape[0]
    dev = data.X.device
    dt = torch.bfloat16 if variant == "bf16" else F32
    score = torch.full((n,), init, dtype=dt, device=dev)
    levels = (7, 15) if variant == "int4" else (127, 255)
    trees = []
    lr32 = np.float32(data.learning_rate)
    for k in range(n_trees):
        g, h = data.gradients(score.to(F64), score.to(F32), k, levels)
        if variant == "bf16":
            g, h = g.bfloat16().to(F64), h.bfloat16().to(F64)
        if variant == "half":
            g, h = g.clone(), h.clone()
            g[1::2] = 0.0
            h[1::2] = 0.0
        grown = grower.grow(g, h)
        v = grown.values(data.params.lambda_l2)
        if variant == "bf16":
            v = torch.as_tensor(v * data.learning_rate).bfloat16().to(
                F64).numpy()
        else:
            v = (v.astype(np.float32) * lr32).astype(np.float64)
        if variant == "alter" and k == 1:
            j = int(np.argmax(grown.rows))
            v[j] = -v[j]
        thr = np.array([data.bounds[f][t] for f, t
                        in zip(grown.feature, grown.thr_bin)])
        trees.append(R.Tree(np.array(grown.feature, dtype=np.int64), thr,
                            np.array(grown.left, dtype=np.int64),
                            np.array(grown.right, dtype=np.int64),
                            v + (init if k == 0 else 0.0)))
        row_leaf = torch.empty(n, dtype=torch.long, device=dev)
        for j, idx in enumerate(grown.leaf_idx):
            if idx is None:
                row_leaf[:] = j
            else:
                row_leaf[idx] = j
        step = torch.as_tensor(v, device=dev).to(dt)
        score = score + step[row_leaf]
        del grown
    return Outputs(bounds=data.bounds, trees=trees, iterations=n_trees,
                   train_score=score,
                   pred_test=R.predict(trees, data.X_test, dtype=dt))
