"""Device-utilization estimate of a training run, from the port's kernels.

The counterpart of ``lightgbm_tpu/obs/mfu.py`` (:1-139), rewritten for the
kernels the port runs.  The JAX module prices the TPU's one-hot MXU matmuls
(mfu.py:53-91: the factored histogram's MACs, ``2 * TS * W`` per visit); the
port's CUDA kernels do none of that work, so only the parts that come from
the trees alone are kept exactly: the row visits (each internal node's
rows, ``sum(leaf_count * leaf_depth)``) and the smaller children's rows
(mfu.py:74-86).

What the two shares count, for the trees of the timed iterations:

- ``est_bytes``: the device-memory bytes the kernels must move, counted as
  PERF.md section 6's "bound ms" column counts them: each split pass reads
  and writes its window's rows once (``2 * W`` bytes a row of the parent
  window: the row store and its scratch), and each histogram (the root of
  every tree over all rows, the smaller child of every split) reads its
  rows' bin bytes and g/h word in 32-byte sectors and writes its [F, 2, B]
  f32 output;
- ``est_macs``: the histogram accumulations the kernels perform, one a
  (row, feature, statistic): ``2 * F`` a histogram row.  These are f64 adds
  (exact) or int32 adds (quantized) on the CUDA cores.

``device_util = est_bytes / wall / hbm_bw`` and ``mfu = est_macs / wall /
peak_ops``, against the card's row of ``plan/device_specs.py`` (H100 SXM:
3.35 TB/s, 1.7e13 adds/s).  Both are None on a kind with no peaks (the
CPU).  A ``device_util`` above 1 means the byte count is wrong, not that
the card is fast.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..plan.device_specs import current_device_kind, device_peaks


def hist_row_bytes(num_features: int, bpc: int) -> int:
    """Bytes a histogram must read a row: the 32-byte sectors of its bin
    bytes and the one of its f32 grad/hess (chip_smoke.py ``row_bytes``)."""
    return 32 * -(-num_features * bpc // 32) + 32


def tree_work(trees: List) -> Dict[str, float]:
    """The parts of the cost that come from the trees alone: row visits
    (every internal node's rows), the smaller children's rows and the
    number of splits."""
    visits = 0.0
    hist_rows = 0.0
    splits = 0
    for t in trees:
        nl = t.num_leaves
        visits += float(np.sum(t.leaf_count[:nl] * t.leaf_depth[:nl]))
        lc, rc = t.left_child[:nl - 1], t.right_child[:nl - 1]
        cnt = t.internal_count[:nl - 1].astype(np.float64)
        for node in range(nl - 1):
            l = lc[node]
            r = rc[node]
            lcnt = (cnt[l] if l >= 0 else t.leaf_count[~l])
            rcnt = (cnt[r] if r >= 0 else t.leaf_count[~r])
            hist_rows += min(float(lcnt), float(rcnt))
        splits += max(nl - 1, 0)
    return {"row_visits": visits, "hist_rows": hist_rows,
            "splits": float(splits)}


def training_cost_model(trees: List, n_rows: int, iters: int,
                        num_features: int, max_bin: int) -> Dict[str, float]:
    """(bytes, macs) of the kernels that grew ``trees`` on an [n_rows,
    num_features] dataset at ``max_bin``: one root histogram a tree over
    ``n_rows`` rows, one split pass and one smaller-child histogram a
    split."""
    del iters  # one root histogram a tree, whatever the iterations
    bpc = 2 if max_bin > 255 else 1
    F = int(num_features)
    B = 1 << max(int(max_bin), 1).bit_length()
    from ..core.tree_learner import row_layout
    W = row_layout(F, bpc).W
    work = tree_work(trees)
    roots = float(len(trees)) * n_rows
    hist_rows = work["hist_rows"] + roots
    out_bytes = (len(trees) + work["splits"]) * F * 2 * B * 4
    nbytes = (2.0 * W * work["row_visits"]
              + hist_rows * hist_row_bytes(F, bpc) + out_bytes)
    macs = 2.0 * F * hist_rows
    return {"bytes": float(nbytes), "macs": float(macs),
            "row_visits": work["row_visits"], "hist_rows": hist_rows,
            "row_width": float(W)}


def training_utilization(trees: List, n_rows: int, iters: int,
                         num_features: int, max_bin: int, wall_s: float,
                         device_kind: Optional[str] = None) -> Dict:
    """The cost model and its shares of the card's peaks over ``wall_s``;
    ``device_util``/``mfu`` are None on a kind with no peaks."""
    cost = training_cost_model(trees, n_rows, iters, num_features, max_bin)
    peaks = device_peaks(device_kind)
    out = dict(cost)
    out["wall_s"] = float(wall_s)
    if peaks is not None and wall_s > 0:
        out["device_kind"] = peaks["kind"]
        out["device_util"] = cost["bytes"] / wall_s / peaks["bw"]
        out["mfu"] = cost["macs"] / wall_s / peaks["ops"]
    else:
        out["device_kind"] = None
        out["device_util"] = None
        out["mfu"] = None
    return out


def record_training_estimate(tele, gbdt, wall_s: float,
                             iters: Optional[int] = None) -> Optional[Dict]:
    """The estimate of a finished run into ``tele``: the ``mfu``,
    ``device_util``, ``est_bytes`` and ``est_macs`` gauges and one
    ``mfu_estimate`` event.  A run the model cannot price (no trees, no
    training data) records nothing and returns None."""
    models = list(gbdt.models)
    K = max(int(gbdt.num_tree_per_iteration), 1)
    n_iters = iters if iters is not None else len(models) // K
    if n_iters <= 0 or not models or gbdt.train_data is None:
        return None
    trees = models[-n_iters * K:]
    est = training_utilization(
        trees, int(gbdt.num_data), n_iters,
        int(gbdt.train_data.num_features), int(gbdt.config.max_bin), wall_s,
        device_kind=current_device_kind(gbdt.device))
    tele.gauge("est_bytes").set(est["bytes"])
    tele.gauge("est_macs").set(est["macs"])
    if est["mfu"] is not None:
        tele.gauge("mfu").set(est["mfu"])
        tele.gauge("device_util").set(est["device_util"])
    tele.event("mfu_estimate", **{k: v for k, v in est.items()})
    return est
