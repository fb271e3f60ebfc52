"""GOSS: gradient-based one-side sampling (src/boosting/goss.hpp:25-185).

Counterpart of ``lightgbm_tpu/boosting/goss.py``.  After ``1 / learning_rate``
iterations without sampling, each iteration keeps the ``top_rate`` fraction
of the rows by ``|grad * hess|`` (summed over the classes), samples
``other_rate`` of the rest and amplifies those by ``(1 - top_rate) /
other_rate``: a row weight (1, the multiplier or 0) folded into grad/hess,
as the reference scales its gradients in place (goss.hpp:117-121).

The order is a stable descending sort on the device (``torch.sort(...,
stable=True)``: ties go to the lower row index, as ``lax.top_k`` and
``np.argsort(-key, kind="stable")`` break them).  The positions of the
sampled rows within the rest come from the booster's sequential
``_bag_rng``, the same ``choice`` call as the JAX package's.  There is one
selection path: a failure in it raises.
With a telemetry run active the selection sets ``goss_top_k`` and
``goss_other_k``, and every ``telemetry_freq``-th iteration emits
``goss_select`` (goss.py:113-123).
"""
from __future__ import annotations

import numpy as np
import torch

from .gbdt import GBDT
from ..obs import active as _telemetry_active
from ..utils.log import Log


def goss_weights(key: torch.Tensor, top_k: int, sampled: np.ndarray,
                 multiply: float) -> torch.Tensor:
    """[N] f32 row weights: 1 for the ``top_k`` largest keys (stable
    descending order), ``multiply`` for the rest's positions ``sampled``
    (indices into the rest of that order), 0 elsewhere (goss.py:57-72)."""
    n = key.shape[0]
    order = torch.sort(key, descending=True, stable=True).indices
    w = torch.zeros(n, dtype=torch.float32, device=key.device)
    w[order[:top_k]] = 1.0
    if len(sampled):
        idx = torch.as_tensor(np.asarray(sampled, np.int64),
                              device=key.device)
        w[order[top_k:][idx]] = float(np.float32(multiply))
    return w


class GOSS(GBDT):
    """Gradient-based one-side sampling on top of :class:`GBDT`."""

    def __init__(self, config, train_data=None, objective=None,
                 device=None, group=None) -> None:
        super().__init__(config, train_data, objective, device=device,
                         group=group)
        if config.top_rate + config.other_rate > 1.0:
            Log.fatal("top_rate + other_rate cannot be larger than 1.0 in "
                      "GOSS")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            Log.fatal("top_rate and other_rate must be positive in GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        Log.info("Using GOSS")
        self._needs_goss = False
        # the last sampled iteration's key [N], row weights [N] and sampled
        # positions, kept for inspection
        self.goss_key = self.goss_weight = self.goss_sampled = None

    def _bagging(self, it: int) -> None:
        """No bag mask; from iteration ``int(1 / learning_rate)`` on, every
        iteration samples (goss.hpp:133-136)."""
        self.bag_mask = None
        self.bag_data_cnt = self.num_data
        self._needs_goss = it >= int(1.0 / self.config.learning_rate)

    def _adjust_gradients_for_bagging(self, grad: torch.Tensor,
                                      hess: torch.Tensor):
        """[K, N] grad/hess times the iteration's GOSS weights
        (goss.py:74-120); ``bag_data_cnt`` becomes the rows kept."""
        if not self._needs_goss:
            return grad, hess
        self._needs_goss = False
        key = torch.abs(grad * hess).sum(dim=0)
        n = self.num_data
        top_k = max(1, int(n * self.config.top_rate))
        other_k = max(1, int(n * self.config.other_rate))
        rest_n = n - top_k
        sampled = self._bag_rng.choice(rest_n, size=min(other_k, rest_n),
                                       replace=False)
        multiply = (n - top_k) / max(other_k, 1)
        self.goss_weight = goss_weights(key, top_k, sampled, multiply)
        self.goss_key, self.goss_sampled = key, sampled
        self.bag_data_cnt = top_k + len(sampled)
        tele = _telemetry_active()
        if tele is not None:
            tele.gauge("goss_top_k").set(top_k)
            tele.gauge("goss_other_k").set(len(sampled))
            if self.iter_ % tele.freq == 0:
                tele.event("goss_select", iteration=int(self.iter_),
                           top_k=int(top_k), other_k=int(len(sampled)),
                           multiplier=float(multiply))
        w = self.goss_weight[None, :]
        return grad * w, hess * w
