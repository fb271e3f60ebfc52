"""Learning-to-rank objectives: lambdarank NDCG and rank_xendcg.

Counterpart of ``lightgbm_tpu/objective/rank.py`` (the reference's
src/objective/rank_objective.hpp:23-202 and rank_xendcg_objective.hpp:25-110).
The JAX package computes these in XLA, not Pallas, and so does the port in
plain torch on the objective's device: queries are bucketed by padded size
(powers of two from 8) at ``init``; each bucket is a [Q, S] gather of scores
through a static index matrix, its pairwise lambdas one [Q, S, S] tensor step
(a stable descending ``argsort`` and exact sigmoids, as in the JAX package),
and the results go back to their rows (each row lies in one bucket, so the
write is exact).  ``rank_xendcg``'s per-document gammas are the JAX package's
``jax.random`` stream, computed by :mod:`..utils.prng`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..metric.dcg import DCGCalculator
from ..utils import prng
from ..utils.log import Log
from .base import ObjectiveFunction

# cap on per-bucket [Q, S, S] pair-tensor elements (memory guard)
_PAIR_BUDGET = 1 << 26


def _make_buckets(query_boundaries: np.ndarray, num_data: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Group queries by padded size: [(idx [Q, S] with num_data padding,
    qids [Q]), ...] for S in powers of two."""
    lens = np.diff(query_boundaries)
    sizes = {}
    for q, cnt in enumerate(lens):
        s = 8
        while s < cnt:
            s *= 2
        sizes.setdefault(s, []).append(q)
    out = []
    for s, qids in sorted(sizes.items()):
        qids = np.asarray(qids, dtype=np.int64)
        lo = query_boundaries[qids]
        cnt = lens[qids]
        pos = np.arange(s, dtype=np.int64)[None, :]
        idx = np.where(pos < cnt[:, None], lo[:, None] + pos, num_data)
        out.append((idx.astype(np.int64), qids))
    return out


def lambdarank_bucket(scores: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, inv_max_dcg: torch.Tensor,
                      label_gain: torch.Tensor, discounts: torch.Tensor, *,
                      sigmoid: float, norm: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise lambdas for one size bucket (``_lambdarank_bucket``,
    rank.py:55-104 of the JAX package).

    scores/labels/mask: [Q, S] (pad rows masked); returns (lambda, hess)
    [Q, S] in the bucket's (unsorted) doc order.  Mirrors
    LambdarankNDCG::GetGradientsForOneQuery (rank_objective.hpp:117-168)."""
    s_dim = scores.shape[1]
    neg = torch.where(mask, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(-neg, dim=1, stable=True)
    s = torch.gather(scores, 1, order)
    m = torch.gather(mask, 1, order)
    lab = torch.gather(labels, 1, order)
    gains = label_gain[torch.clamp(lab, 0, label_gain.shape[0] - 1)]
    disc = discounts[:s_dim][None, :]
    cnt = mask.sum(dim=1)
    best = s[:, 0]
    worst = torch.gather(s, 1, torch.clamp(cnt - 1, min=0)[:, None])[:, 0]

    valid = ((lab[:, :, None] > lab[:, None, :])
             & m[:, :, None] & m[:, None, :])
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    ds = torch.where(valid, s[:, :, None] - s[:, None, :], zero)
    dndcg = (torch.abs(gains[:, :, None] - gains[:, None, :])
             * torch.abs(disc[:, :, None] - disc[:, None, :])
             * inv_max_dcg[:, None, None])
    if norm:
        same = (best == worst)[:, None, None]
        dndcg = torch.where(same, dndcg, dndcg / (0.01 + torch.abs(ds)))
    p = 1.0 / (1.0 + torch.exp(sigmoid * ds))
    p_lambda = torch.where(valid, -sigmoid * dndcg * p, zero)
    p_hess = torch.where(valid, sigmoid * sigmoid * dndcg * p * (1.0 - p),
                         zero)
    lam = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
    hes = p_hess.sum(dim=2) + p_hess.sum(dim=1)
    if norm:
        sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
        nf = torch.where(sum_lambdas > 0,
                         torch.log2(1.0 + sum_lambdas)
                         / torch.clamp(sum_lambdas, min=1e-300),
                         torch.ones_like(sum_lambdas))
        lam = lam * nf[:, None]
        hes = hes * nf[:, None]
    # unsort back to the bucket's doc positions
    return (torch.empty_like(lam).scatter_(1, order, lam),
            torch.empty_like(hes).scatter_(1, order, hes))


class LambdarankNDCG(ObjectiveFunction):
    need_accurate_prediction = False
    name = "lambdarank"

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero", self.sigmoid)
        self.norm = bool(config.lambdamart_norm)
        self.optimize_pos_at = int(config.max_position)
        DCGCalculator.init(list(config.label_gain) or None)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("Lambdarank tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        DCGCalculator.check_label(self.label_np)
        inverse_max_dcgs = np.zeros(len(self.query_boundaries) - 1)
        for q in range(len(inverse_max_dcgs)):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            maxdcg = DCGCalculator.cal_max_dcg_at_k(self.optimize_pos_at,
                                                    self.label_np[lo:hi])
            inverse_max_dcgs[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0
        dev = self.device
        self._buckets = []
        label_pad = np.concatenate([self.label_np.astype(np.int64), [0]])
        max_s = 8
        for idx, qids in _make_buckets(self.query_boundaries, num_data):
            s = idx.shape[1]
            max_s = max(max_s, s)
            chunk = max(_PAIR_BUDGET // (s * s), 1)
            for lo in range(0, idx.shape[0], chunk):
                part_idx = idx[lo:lo + chunk]
                self._buckets.append({
                    "idx": torch.as_tensor(part_idx, device=dev),
                    "labels": torch.as_tensor(label_pad[part_idx], device=dev),
                    "mask": torch.as_tensor(part_idx < num_data, device=dev),
                    "inv_max_dcg": torch.as_tensor(
                        inverse_max_dcgs[qids[lo:lo + chunk]].astype(
                            np.float32), device=dev),
                })
        self._label_gain = torch.as_tensor(
            np.asarray(DCGCalculator.label_gain_, dtype=np.float32),
            device=dev)
        disc = np.asarray(DCGCalculator.discount_, dtype=np.float32)
        if max_s > disc.shape[0]:   # queries beyond kMaxPosition positions
            disc = np.concatenate(
                [disc, np.full(max_s - disc.shape[0], disc[-1], np.float32)])
        self._discounts = torch.as_tensor(disc[:max_s], device=dev)

    def get_gradients(self, score):
        score = score.reshape(-1).to(torch.float32)
        score_pad = torch.cat([score, score.new_zeros(1)])
        lam = score.new_zeros(self.num_data + 1)
        hes = score.new_zeros(self.num_data + 1)
        for b in self._buckets:
            bl, bh = lambdarank_bucket(
                score_pad[b["idx"]], b["labels"], b["mask"],
                b["inv_max_dcg"], self._label_gain, self._discounts,
                sigmoid=self.sigmoid, norm=self.norm)
            lam[b["idx"]] = bl
            hes[b["idx"]] = bh
        lam, hes = lam[:self.num_data], hes[:self.num_data]
        if self.weights is not None:
            lam = lam * self.weights
            hes = hes * self.weights
        return lam, hes


def xendcg_bucket(scores: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, gammas: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Listwise XE-NDCG lambdas for one bucket ([Q, S] rows; pads masked;
    ``_xendcg_bucket``, rank.py:187-208 of the JAX package).  Mirrors
    RankXENDCG::GetGradientsForOneQuery (rank_xendcg_objective.hpp:43-110)."""
    f32 = dict(dtype=torch.float32, device=scores.device)
    zero = torch.zeros((), **f32)
    sm = torch.where(mask, scores, torch.tensor(-1e30, **f32))
    e = torch.exp(sm - sm.max(dim=1, keepdim=True).values)
    rho = e / e.sum(dim=1, keepdim=True)
    phi = torch.where(mask, torch.pow(2.0, labels) - gammas, zero)
    sum_labels = phi.sum(dim=1, keepdim=True)
    ok = torch.abs(sum_labels) > 1e-15
    l1 = torch.where(mask, -phi / torch.where(ok, sum_labels,
                                              torch.ones((), **f32)) + rho,
                     zero)
    inv = torch.where(mask, 1.0 / torch.clamp(1.0 - rho, min=1e-15), zero)
    li = l1 * inv
    l2 = li.sum(dim=1, keepdim=True) - li
    rl = rho * l2 * inv
    l3 = rl.sum(dim=1, keepdim=True) - rl
    lam = torch.where(mask & ok, l1 + rho * l2 + rho * l3, zero)
    hes = torch.where(mask & ok, rho * (1.0 - rho), zero)
    single = mask.sum(dim=1, keepdim=True) <= 1
    return torch.where(single, zero, lam), torch.where(single, zero, hes)


class RankXENDCG(ObjectiveFunction):
    """Listwise cross-entropy NDCG surrogate (rank_xendcg_objective.hpp:25-110):
    phi(l, gamma) = 2^l - gamma with per-doc uniform gammas, batched on the
    device.  Call c draws bucket i's gammas from ``fold_in(PRNGKey(
    objective_seed + c), i)``, the JAX package's stream."""
    need_accurate_prediction = False
    name = "rank_xendcg"
    deterministic_gradients = False  # fresh gammas every call (rank.py:210)

    def __init__(self, config, device: DeviceLike = None):
        super().__init__(config, device)
        self._seed = int(getattr(config, "objective_seed", 5))
        self._call = 0

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("RankXENDCG tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        label_pad = np.append(self.label_np, np.float32(0.0)).astype(np.float32)
        dev = self.device
        self._buckets = []
        for idx, _ in _make_buckets(self.query_boundaries, num_data):
            self._buckets.append({
                "idx": torch.as_tensor(idx, device=dev),
                "labels": torch.as_tensor(label_pad[idx], device=dev),
                "mask": torch.as_tensor(idx < num_data, device=dev),
            })

    def gammas(self, call: int, bucket: int) -> torch.Tensor:
        """The per-document gammas of ``bucket`` at gradient call ``call``
        (1 for the first)."""
        key = prng.fold_in(prng.prng_key(self._seed + call), bucket)
        return prng.uniform(key, self._buckets[bucket]["idx"].shape,
                            device=self.device)

    def get_gradients(self, score):
        score = score.reshape(-1).to(torch.float32)
        score_pad = torch.cat([score, score.new_zeros(1)])
        lam = score.new_zeros(self.num_data + 1)
        hes = score.new_zeros(self.num_data + 1)
        self._call += 1
        for i, b in enumerate(self._buckets):
            bl, bh = xendcg_bucket(score_pad[b["idx"]], b["labels"],
                                   b["mask"], self.gammas(self._call, i))
            lam[b["idx"]] = bl
            hes[b["idx"]] = bh
        return lam[:self.num_data], hes[:self.num_data]
