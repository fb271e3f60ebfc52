"""Parallel tree learners over a ``torch.distributed`` process group.

Counterpart of ``lightgbm_tpu/parallel/learners.py`` (the reference learners
that ``CreateTreeLearner`` makes, src/treelearner/tree_learner.cpp:13-36):

- ``DataParallelTreeLearner`` (``tree_learner=data``, comm mode ``rs``):
  rows striped over the ranks; each child's histogram is reduce-scattered
  over the features and the ranks' best splits are all-gathered
  (data_parallel_tree_learner.cpp:149-240);
- ``PartitionedDataParallelTreeLearner`` (``psum``): rows striped, each
  child's histogram all-reduced whole; it keeps EFB groups, 4-bit packing,
  forced splits and CEGB, and ``data`` with forced splits or CEGB takes it;
- ``FeatureParallelTreeLearner`` (``feature``): every rank holds every row,
  builds and scans only its F/d block of the histograms (the split pass's
  feature window) and the best splits cross the ranks
  (feature_parallel_tree_learner.cpp:33-52);
- ``VotingParallelTreeLearner`` (``voting``): rows striped, histograms
  local, the ``2 * top_k`` most voted features' histograms all-reduced
  (voting_parallel_tree_learner.cpp:170-366).

The JAX learners are one program under ``jax.shard_map`` over a mesh of d
devices; here each rank is a process of a group of d, and every rank is
given the same whole dataset, as the JAX program is.  The rows are padded to
a multiple of d and rank r keeps the contiguous block ``[r n/d, (r+1) n/d)``
of the row store (learners.py:344-350); the quantization hash keys the
global row ids; the features are padded to a multiple of d in ``rs`` and
``feature`` mode (learners.py:352-366, ``feature_pad``).  Each rank grows
the same tree (``core/tree_learner.py``'s invariant: every host decision
that feeds a collective is replicated), and the per-row results (the leaf
of every row, the lazy CEGB bits) are all-gathered over all N rows, so the
boosting layer, replicated on every rank as the JAX controller is one
program, updates the same scores everywhere.

The JAX package keeps a replicated histogram build in ``feature`` mode at
widths where its factored TPU kernel cannot take a feature window
(tree_learner.py:482-488); the port's kernels take the window at every
width, so ``feature`` mode always builds only its block.  The trees are the
same either way.

``sharded_predict`` and ``sharded_predict_contrib`` split the rows over the
ranks, run the port's device predictor on each stripe and all-gather the
result.  There is no degraded single-device fallback (the JAX code's
``note_fallback`` path, learners.py:142-166, :264-282): a failure raises,
and ``resilience.note_fallback`` is never called.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..core.tree_learner import Comm, SerialTreeLearner
from ..device import DeviceLike
from ..utils.log import Log
from .comm import ProcessComm, group_rank, group_size
from .distdata import shard_of


def is_write_leader(group=None) -> bool:
    """True on the process that writes model and checkpoint files: rank 0
    (learners.py:58-68; every rank runs the same training loop, and d
    writers would race on the same paths).  ``group`` is accepted for the
    signature of the JAX function; leadership is the default group's."""
    del group
    return group_rank() == 0


# ---- sharded prediction ----

def _stripe_run(fn, rows, comm: ProcessComm) -> np.ndarray:
    """Rank r's contiguous block of ceil(n / d) rows (the last ones
    zero-padded) through ``fn`` -> [block, ...] f64 numpy; all-gathered in
    rank order and cut to n rows."""
    rows = np.asarray(rows)
    if rows.dtype.kind == "f":
        rows = rows.astype(np.float32, copy=False)
    n, d = rows.shape[0], comm.size
    per = -(-n // d)
    lo = min(comm.rank * per, n)
    block = rows[lo:lo + per]
    if block.shape[0] < per:
        block = np.concatenate([block, np.zeros(
            (per - block.shape[0],) + rows.shape[1:], dtype=rows.dtype)])
    out = torch.as_tensor(np.asarray(fn(block), dtype=np.float64),
                          device=comm.device)
    got = comm.all_gather(out).reshape((d * per,) + tuple(out.shape[1:]))
    return got[:n].cpu().numpy()


def sharded_predict(predictor, rows, comm: ProcessComm, *,
                    early_stop_margin: float = -1.0,
                    round_period: int = 10) -> np.ndarray:
    """[N] f64 raw scores of ``rows`` split over the ranks of ``comm``:
    each rank runs ``predictor`` (a ``core.predict_fused.FusedPredictor``,
    the same on every rank) on its stripe, then one all-gather
    (learners.py:103-186).  Every row is scored as ``predictor(rows)``
    scores it, so the result equals it bit for bit.  With a telemetry run
    active, one ``sharded_predict`` event a call (learners.py:178-181)."""
    from ..obs import active as _telemetry_active
    from ..obs import annotate as _annotate
    tele = _telemetry_active()
    t0 = time.perf_counter() if tele is not None else 0.0
    with _annotate("sharded_predict"):
        out = _stripe_run(lambda b: predictor(b, early_stop_margin,
                                              round_period), rows, comm)
    if tele is not None:
        from ..core.predict_fused import shape_bucket
        n = len(rows)
        tele.event("sharded_predict", rows=int(n),
                   bucket=int(shape_bucket(-(-n // comm.size))),
                   shards=int(comm.size), dt_s=time.perf_counter() - t0,
                   fallback=False)
    return out


def sharded_predict_contrib(predictor, rows, ncol: int,
                            comm: ProcessComm) -> np.ndarray:
    """[N, ncol] f64 SHAP contributions of ``rows`` split over the ranks of
    ``comm`` (learners.py:212-302): each rank runs the device TreeSHAP of
    ``predictor.predict_contrib`` on its stripe, then one all-gather."""
    return _stripe_run(lambda b: predictor.predict_contrib(b, ncol), rows,
                       comm)


# ---- learners ----

class _ParallelTreeLearner(SerialTreeLearner):
    """Shared host side: the rank's stripe of the rows, the features padded
    to a multiple of the ranks, and the all-gather of the per-row results;
    the tree grows through ``core.tree_learner.build_tree_partitioned``
    with this learner's :class:`Comm`."""

    mode = "rs"
    supports_groups = False
    supports_packing = False

    def __init__(self, dataset, config, device: DeviceLike = None,
                 group=None) -> None:
        if shard_of(dataset) is not None:
            raise NotImplementedError(
                "a parallel learner trains from every row on every rank; "
                "training from a rank's stripe of the rows (a dataset "
                "stamped shard) is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP item 13b, a gap of the JAX package)")
        from ..device import resolve_device
        dev = resolve_device(device)
        ops = ProcessComm(group, dev)
        self.num_shards, self.rank = ops.size, ops.rank
        self.comm = Comm(ops=ops, mode=self.mode,
                         num_shards=self.num_shards, rank=self.rank,
                         top_k=int(config.top_k))
        self.feature_pad = 0
        self.padded_rows = 0
        super().__init__(dataset, config, dev)
        if (self.forced is not None or self.cegb is not None) \
                and self.mode != "psum":
            Log.warning("forced splits / CEGB penalties need the full "
                        "histogram block; tree_learner=%s ignores them "
                        "(the psum data-parallel learner applies them)"
                        % self.mode)
            self.forced = None
            self.cegb = None
            self.cegb_used = None
            self.cegb_paid = None
        if self.mode == "feature" and self.hist_pool_slots:
            # the cached blocks are F/d wide: the same histogram_pool_size
            # holds d times the slots (learners.py:326-331)
            self.hist_pool_slots = max(2, self.hist_pool_slots
                                       * self.num_shards)

    @property
    def striped(self) -> bool:
        """True when each rank holds a stripe of the rows (every mode but
        ``feature``)."""
        return self.mode != "feature"

    def _store_matrix(self, matrix: np.ndarray) -> np.ndarray:
        d, r = self.num_shards, self.rank
        if self.mode in ("rs", "feature"):
            self.feature_pad = (-matrix.shape[1]) % d
        if self.feature_pad:
            p = self.feature_pad
            matrix = np.concatenate(
                [matrix, np.zeros((matrix.shape[0], p), matrix.dtype)], 1)
            dev = self.device

            def pad(a, v):
                return torch.cat([a, torch.full((p,), v, dtype=a.dtype,
                                                device=dev)])
            self.feat = self.feat._replace(
                num_bin=pad(self.feat.num_bin, 1),
                missing_type=pad(self.feat.missing_type, 0),
                default_bin=pad(self.feat.default_bin, 0),
                is_categorical=pad(self.feat.is_categorical, False),
                monotone=pad(self.feat.monotone, 0))
            if self.params.feature_contri:
                self.params = self.params._replace(feature_contri=tuple(
                    self.params.feature_contri) + (1.0,) * p)
        if not self.striped:
            return matrix
        self.padded_rows = (-matrix.shape[0]) % d
        if self.padded_rows:
            matrix = np.concatenate([matrix, np.zeros(
                (self.padded_rows, matrix.shape[1]), matrix.dtype)])
        per = matrix.shape[0] // d
        self.local_rows = per
        return np.ascontiguousarray(matrix[r * per:(r + 1) * per])

    def pass_columns(self) -> int:
        """A feature-parallel rank histograms its F/d block (the split
        pass's feature window); the other modes every column."""
        if self.mode == "feature":
            return self.hist_columns // self.num_shards
        return self.hist_columns

    def _padded_feature_mask(self, mask: torch.Tensor) -> torch.Tensor:
        if not self.feature_pad:
            return mask
        return torch.cat([mask, torch.zeros(self.feature_pad, dtype=mask.dtype,
                                            device=mask.device)])

    def _local_rows(self, t):
        if t is None or not self.striped:
            return t
        if self.padded_rows:
            t = torch.cat([t, torch.zeros((self.padded_rows,) + t.shape[1:],
                                          dtype=t.dtype, device=t.device)])
        per = self.local_rows
        return t[self.rank * per:(self.rank + 1) * per]

    def _row_ids(self, n: int) -> torch.Tensor:
        base = self.rank * n if self.striped else 0
        return torch.arange(base, base + n, device=self.device)

    def _gather_rows(self, t):
        if t is None or not self.striped:
            return t
        got = self.comm.ops.all_gather(t)
        return got.reshape((-1,) + tuple(t.shape[1:]))[:self.num_data]


class DataParallelTreeLearner(_ParallelTreeLearner):
    """``tree_learner=data``: rows striped; the smaller child's histogram is
    reduce-scattered over the features, so each rank holds and scans the
    global histograms of its F/d features, then the ranks' best splits are
    all-gathered (SyncUpGlobalBestSplit).  Per split each rank sends
    F * 2 * B * 4 bytes into the reduce-scatter and keeps F/d of them."""
    mode = "rs"


class PartitionedDataParallelTreeLearner(_ParallelTreeLearner):
    """``tree_learner=data`` with whole histograms: rows striped, each
    child's histogram all-reduced; no feature sharding, so EFB group
    columns, 4-bit packing, forced splits and CEGB work as in the serial
    learner."""
    mode = "psum"
    supports_groups = True
    supports_packing = True


class FeatureParallelTreeLearner(_ParallelTreeLearner):
    """``tree_learner=feature``: every rank holds every row and partitions
    them alike, builds the histograms of its own F/d features only (the
    split pass's feature window) and scans them; one all-gather of the best
    splits per scan."""
    mode = "feature"


class VotingParallelTreeLearner(_ParallelTreeLearner):
    """``tree_learner=voting``: rows striped, histograms local; per scan an
    all-gather of each rank's ``top_k`` votes and an all-reduce of the
    ``2 * top_k`` elected features' histograms."""
    mode = "voting"


LEARNERS = {
    "serial": SerialTreeLearner,
    "data": DataParallelTreeLearner,
    "feature": FeatureParallelTreeLearner,
    "voting": VotingParallelTreeLearner,
}


def _needs_whole_histograms(config) -> bool:
    return bool(str(getattr(config, "forcedsplits_filename", "") or "")
                or float(config.cegb_penalty_split) > 0
                or any(config.cegb_penalty_feature_coupled or [])
                or any(config.cegb_penalty_feature_lazy or []))


def create_tree_learner(dataset, config, device: DeviceLike = None,
                        group=None):
    """``TreeLearner::CreateTreeLearner`` (tree_learner.cpp:13-36;
    learners.py:548-573): ``config.tree_learner`` names the learner; an
    unknown name raises; a world size of 1 (or no initialized process
    group) gives the serial learner, as the reference's num_machines=1
    does; ``data`` with forced splits or CEGB gives the psum learner."""
    kind = str(config.tree_learner)
    if kind not in LEARNERS:
        raise ValueError("Unknown tree learner type %s" % kind)
    if kind != "serial" and group_size(group) <= 1:
        kind = "serial"
    if kind == "serial":
        return SerialTreeLearner(dataset, config, device)
    cls = LEARNERS[kind]
    if kind == "data" and _needs_whole_histograms(config):
        cls = PartitionedDataParallelTreeLearner
    return cls(dataset, config, device, group=group)


__all__: List[str] = [
    "DataParallelTreeLearner", "FeatureParallelTreeLearner",
    "PartitionedDataParallelTreeLearner", "VotingParallelTreeLearner",
    "create_tree_learner", "is_write_leader",
    "sharded_predict", "sharded_predict_contrib"]
