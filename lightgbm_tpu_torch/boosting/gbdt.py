"""GBDT training loop (the main path of the port).

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` (the reference ``GBDT``,
src/boosting/gbdt.cpp, gbdt.h): ``__init__``, ``_boost_from_average``,
bagging (``_bagging``: the JAX package's stateless per-row hash, plain and
pos/neg balanced; ``_bag_rng``, the sequential stream GOSS samples from) and
``feature_fraction`` (``_feature_mask``), ``train_one_iter`` (the
asynchronous loop, gbdt.py:196-205 and :655-743, below; with
``gradients``/``hessians`` for a custom objective; the hooks
``_get_gradients`` and ``_adjust_gradients_for_bagging`` that DART and GOSS
override) and ``_train_one_iter_sync`` (one host tree per class and
iteration, for DART and the renewing objectives), the lazy trees
(``models``, ``_materialize_pending``, the stall poll ``_poll_stop``, the
deferred non-finite checks ``_drain_nonfinite_checks``), the leaf
renewal of the percentile objectives (``_renew_tree_output``),
``train_score``, validation sets (``add_valid_data``), the score add of a
host tree (``_add_tree_score_train`` / ``_add_tree_score_valid``, which
DART's drops use), metrics and early stopping (``eval_train``,
``eval_valid``, ``eval_and_check_early_stopping``), the fused
multi-iteration chunk (``train_chunk``, gbdt.py:745-1100: carried row-store
training, ``trees_per_chunk``, the per-chunk non-finite guard
``_guard_chunk_scores`` and its rollback), the loop ``train`` over chunks
with its snapshots (``snapshot_out``), the train state of a checkpoint
(``capture_train_state`` / ``restore_train_state``, gbdt.py:1446-1615, and
``save_checkpoint`` / ``resume_from_checkpoint``), the preemption poll of
``train`` (at chunk boundaries; ``_preempt_exit`` writes the emergency
checkpoint) and the watchdog sections (``watched_iter`` around an
iteration, ``fused_train_chunk`` around a fused chunk),
``rollback_one_iter``, ``refit``, the online loop's warm start
(``warm_start_continuation``), the model surgery of the C API
(``merge_from``, ``shuffle_models``, ``set_leaf_value``), the replay of a
loaded model (``replay_train_score``), every
prediction path (gbdt.py:1999-2343: ``predict`` with its 512-row regimes,
prediction early stop and the bf16 tier, ``predict_leaf_index``,
``predict_contrib``, and their binned forms over a row store), averaged over
the iterations for ``average_output`` (RF), ``feature_importance``, the
host-time scopes of ``utils/timer.py`` (``GBDT::Boosting``,
``GBDT::Bagging``, ``TreeLearner::Train``, ``GBDT::UpdateScore``, as the JAX
package's synchronous path names them; they synchronise nothing) and the
reference-compatible text model (``save_model_to_string`` /
``load_model_from_string``, gbdt_model_text.cpp:271,375).

Scores live on the device: ``train_score`` [K, N] f32 and one [K, N_v] f32
score per validation set, K = ``num_tree_per_iteration`` (the number of
classes for multiclass objectives, else 1).  Each iteration:
boost-from-average (first iteration, added to every score), objective
gradients on the device, the bag mask and feature mask, then per class one
tree from the learner that ``parallel.create_tree_learner`` chose for
``tree_learner`` (the serial one at a world size of 1; ``group`` is the
process group of a parallel learner, as the JAX ``mesh`` is) on the masked
gradients, the tree's leaf values scaled by the learning rate in f32, the
class's train score updated through the tree's ``row_leaf``.

The iteration is asynchronous, as the JAX package's default path is: it
only queues work on the card and reads nothing back.  Its trees stay on the
device (``core/tree_learner.py`` ``DeviceTree``: the device build's packed
record, not yet fetched) as pending entries of the model; the bag count
stays on the device; under ``nan_policy=raise`` its gradients' isfinite
verdict waits on the device.  The host trees are materialized, every
pending tree in one transfer, when something first reads ``models``
(saving, predicting, evaluating, a checkpoint); every ``_poll_freq`` = 16
iterations the stall poll reads every pending leaf count and verdict in one
transfer, raises for a non-finite iteration and trims everything from the
first iteration whose trees could not split, as the synchronous loop would
have stopped there (``train`` polls once more at its end, before a snapshot
and before a preemption's checkpoint; ``engine.train`` drains the verdicts
after its loop).  A validation score takes a tree when it is materialized,
in tree order, through ``route_binned`` on the set's bins: the bytes of
adding it at dispatch, without routing over a tree whose depth the host
does not know; reading a validation set's ``"score"`` settles them.
``host_reads`` counts the loop's device->host reads: 2 polls and 1
materialization for 20 iterations without evaluation.  DART
(``lazy_trees = False``) and the objectives that renew leaf outputs on the
host run the synchronous iteration; RF's own iteration reads its trees as
the JAX package's does.  DART, GOSS and RF subclass this class
(``boosting/dart.py``, ``goss.py``, ``rf.py``; built by
``boosting.create_boosting``).  ``train`` runs chunks of iterations
(``train_chunk``): where the JAX package fuses a chunk into one XLA scan,
the port runs the same iterations as host loops of kernel launches that
leave their trees pending, with one guard verdict read a chunk, and, for a
single-model pointwise objective, with the boosting state carried in the
tree learner's permuted row store (the section "the fused multi-iteration
chunk" below).

Prediction (gbdt.py:1999-2110): from 512 rows on, or in the bf16 tier, a
class's trees go through the cached :class:`FusedPredictor` (f32 rows, f32
thresholds floored, an f32 running sum in tree order); below 512 rows
through the f64 traversal of :class:`StackedTrees`.  Both run on the
booster's device.  Contributions run on the device from 8 rows on, below
that on the host recursion ``Tree.predict_contrib`` (gbdt.py:2128, :2150).
A booster trained by a parallel learner runs on every rank of its group:
its device predictions are split over the ranks (``sharded_predict``,
``sharded_predict_contrib``, gbdt.py:2048-2162), and only the write leader
(rank 0) writes snapshots (gbdt.py:1934-1941).

Telemetry (``obs``): with a run active, :meth:`train` records each chunk
(``_record_chunk_telemetry``, gbdt.py:1101-1170: ``chunk_*`` histograms, a
``train_chunk`` event and span, the quantized path's ``quant_*`` block, a
``devmem`` sample, and for a fused chunk the compile accountant's
``fused_train`` key ``k=<length>``, whose first chunk of a length also
counts in ``obs.recompile``) and the run gauges
``train_rows``/``train_iterations``/``train_wall_s``; evaluation emits
``eval`` events, a non-finite guard trip ``nan_trip`` (``rollback_retry``
for a rolled-back chunk), and the binned predict of an external dataset
feeds the quality plane (``quality_baseline``, gbdt.py:2230-2310).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.predict import StackedTrees
from ..core.predict_fused import FusedPredictor, note_stack
from ..core.quant import _M32, _mul32
from ..core.tree import Tree
from ..core.tree_learner import (DeviceTree, TreeArrays, arrays_from_tree,
                                 route_binned, store_f32, store_order,
                                 tree_from_arrays)
from ..device import DeviceLike, resolve_device, to_device_async
from ..io.dataset import BinnedDataset
from ..metric.metric import Metric, create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..obs import active as _telemetry_active
from ..obs import annotate as _annotate
from ..obs import compile as _compile
from ..obs import devmem as _devmem
from ..obs import recompile as _recompile
from ..obs import spans as _spans
from ..parallel.learners import (create_tree_learner, is_write_leader,
                                 sharded_predict, sharded_predict_contrib)
from ..resilience import (TrainingPreempted, clear_preemption,
                          emergency_checkpoint, preemption_requested, watch)
from ..utils.file_io import atomic_write
from ..utils.log import LightGBMError, Log
from ..utils.timer import FunctionTimer

K_EPSILON = 1e-15
MODEL_VERSION = "v3"


def _bag_uniforms(row_ids: torch.Tensor, seed: int,
                  it_window: int) -> torch.Tensor:
    """Per-row uniforms in [0, 1) as f32 for bagging, keyed by (original row
    id, bagging window): the JAX package's stateless integer hash
    (``_bag_uniforms``, gbdt.py:88-108), bit for bit.  torch has little
    ``uint32`` support, so the hash runs in ``int64`` masked to 32 bits after
    each step (``_mul32`` keeps every product below 2**49); the final
    int -> f32 conversion rounds to nearest even, as XLA's ``uint32 ->
    float32`` does, and the scale is a power of two."""
    x = _mul32(row_ids.to(torch.int64) & _M32, 2654435761)
    x = x ^ (((int(seed) & _M32) + int(it_window) * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def bag_mask_for(row_ids: torch.Tensor, seed: int, it: int, freq: int,
                 frac, host_count: bool = True):
    """(mask f32 0/1, realised count) for iteration ``it``
    (``_bag_mask_for``, gbdt.py:111-122): rows whose uniform of the window
    ``it - it % freq`` is below ``frac`` (a float, or a per-row f32 tensor
    for pos/neg balanced bagging); the count is at least 1.  The mask is
    keyed by the ids, so a permuted ``row_ids`` (the carried store's order
    bytes) gives the same mask permuted.  ``host_count=False`` leaves the
    count on the device, an f32 scalar, so that nothing is read back."""
    u = _bag_uniforms(row_ids, seed, it - it % freq)
    if not isinstance(frac, torch.Tensor):
        # a fill, not a copy of a host scalar (which would wait for the card)
        frac = torch.full((), frac, dtype=torch.float32, device=u.device)
    mask = (u < frac).to(torch.float32)
    count = torch.clamp(mask.sum(dtype=torch.float32), min=1.0)
    return mask, (int(count) if host_count else count)


class _ValidSet(dict):
    """A validation set's entry of ``GBDT.valid_sets``: reading its
    ``"score"`` first adds the trees still queued for the validation scores
    (``GBDT._settle_valid``), so that every reader sees every tree trained
    so far; the booster's own updates go through :func:`_raw_score`."""

    def __init__(self, settle, **fields) -> None:
        super().__init__(**fields)
        self.settle = settle

    def __getitem__(self, key):
        if key == "score":
            self.settle()
        return dict.__getitem__(self, key)


def _raw_score(vs: dict) -> torch.Tensor:
    """A validation set's score tensor as it stands, without settling the
    queued trees (the booster's own reads and writes)."""
    return dict.__getitem__(vs, "score")


class _PendingTree:
    """One tree of the asynchronous loop (the JAX package's ``_pending``
    record, gbdt.py:241-309): the device tree, its class, the
    boost-from-average bias its host tree takes, its learning rate, and,
    once read back, its scaled host arrays."""

    __slots__ = ("dtree", "k", "init", "rate", "arrays")

    def __init__(self, dtree: DeviceTree, k: int, init: float,
                 rate: np.float32) -> None:
        self.dtree, self.k, self.init, self.rate = dtree, k, init, rate
        self.arrays: Optional[TreeArrays] = None

    @property
    def row_leaf(self) -> Optional[torch.Tensor]:
        return self.dtree.row_leaf

    def leaf_output(self) -> torch.Tensor:
        """[L] f32 scaled leaf values on the device: the bytes of the host
        arrays' ``leaf_value * rate``."""
        return self.dtree.leaf_value() * float(self.rate)


def _steps_grouped(step, its: Sequence[int], group: int) -> None:
    """Run ``step(it)`` over the iterations ``its`` in groups of ``group``
    (``trees_per_chunk``; ``_scan_grouped``, gbdt.py:140-172): the whole
    groups first, then the ungrouped tail.  The steps are the same calls in
    the same order whatever the group, so the trees are bit-identical; the
    JAX package unrolls a group into one scan step to share its dispatch,
    while a step here is already a host loop of kernel launches, so the
    group changes no launch."""
    k = len(its)
    g = min(max(int(group), 1), max(k, 1))
    main = (k // g) * g
    blocks = [its[i:i + g] for i in range(0, main, g)] + [[it] for it in
                                                          its[main:]]
    for block in blocks:
        for it in block:
            step(it)


class GBDT:
    """Gradient Boosting Decision Tree (sub-model name "tree", gbdt.h:362).

    ``device`` follows the port's device rule (``lightgbm_tpu_torch.device``):
    ``cuda`` unless the caller passes ``"cpu"``; no silent CPU fallback.
    ``group`` is the ``torch.distributed`` process group of a parallel
    learner (None: the default group, when one is initialized)."""

    average_output = False
    # below these row counts predict takes the f64 traversal and
    # predict_contrib the host recursion (gbdt.py:1999, :2128)
    _DEVICE_PREDICT_MIN_ROWS = 512
    _DEVICE_CONTRIB_MIN_ROWS = 8
    # rollback_one_iter restores the scores the last iteration started
    # from; DART subtracts the last trees instead (its drops changed the
    # scores before the new trees were added)
    keep_rollback_scores = True
    # the host tree takes the f32-scaled leaf values (the JAX package's lazy
    # path); DART sets False: its host trees shrink in f64 and its scores
    # take the f32 products (the JAX package's synchronous path)
    lazy_trees = True
    # the fused chunk (train_chunk); subclasses with per-iteration host
    # logic opt out (gbdt.py:758)
    fuse_iters = True
    # the asynchronous loop's stall poll: every this many iterations
    # (gbdt.py:654)
    _poll_freq = 16
    # the scores and the model length before a chunk describe all that the
    # chunk changed; DART's drops change older trees, so it stops at a
    # non-finite chunk instead of rolling it back (gbdt.py:1273-1276)
    _prechunk_rollback_safe = True

    def __init__(self, config: Config,
                 train_data: Optional[BinnedDataset] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 device: DeviceLike = None, group=None) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.group = group
        # the fused chunk's state and the device->host reads of the
        # asynchronous loop (its polls and materializations)
        self._prechunk = None
        self._valid_queue: List[Tuple[int, _PendingTree]] = []
        self.host_reads = 0
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_init_iteration = 0
        self.train_data: Optional[BinnedDataset] = None
        # quality-plane provenance (obs/quality.py): when the model last
        # trained, and the training score fingerprints, taken lazily on the
        # first drift baseline
        self.trained_at: Optional[float] = None
        self._score_fingerprint_raw = None
        self._score_fingerprint_out = None
        self._quality_baseline_cache = None
        self.objective = objective
        self.num_tree_per_iteration = 1
        self.num_class = int(config.num_class)
        self.shrinkage_rate = float(config.learning_rate)
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.label_idx = 0
        self.last_arrays: Optional[TreeArrays] = None
        # the last iteration's scaled arrays per class, and the scores it
        # started from (rollback_one_iter)
        self._last_iter_arrays: List[Optional[TreeArrays]] = []
        self._pre_iter_scores = None
        self._fused_pred: Dict = {}
        self._stacked_pred = None
        self.valid_sets: List[dict] = []
        self.train_metrics: List[Metric] = []
        # iteration of the best validation score when early stopping ended
        # training (0: it did not)
        self.best_iteration = 0
        self._es_state: Dict = {}
        # the fused chunk: its state before the chunk (resilient nan_policy
        # only), the device verdict of its gradients' finiteness, the chunk
        # lengths run so far, and the read-backs its guard made
        self._chunk_grads_ok: Optional[torch.Tensor] = None
        self._fused_keys = set()
        self._fuse_failed = False
        self._nan_refused_fuse = False
        self._nan_rolled_back_at: Optional[int] = None
        self._chunk_rolled_back = False
        self.chunk_reads = 0
        if train_data is not None:
            self.reset_training_data(train_data, objective)

    @property
    def bag_data_cnt(self) -> int:
        """The rows in the current bag.  A fused chunk leaves it on the
        device; it is read back here, when it is asked for."""
        cnt = self._bag_data_cnt
        if isinstance(cnt, torch.Tensor):
            cnt = self._bag_data_cnt = int(cnt)
        return cnt

    @bag_data_cnt.setter
    def bag_data_cnt(self, value) -> None:
        self._bag_data_cnt = value

    # ---- the asynchronous loop's lazy trees (gbdt.py:241-380) ----
    #
    # An iteration of the lazy path only queues work on the card: the
    # gradients, the tree build, the train score's update.  Its trees stay
    # on the device as ``_pending`` records (a ``None`` in ``_models``) and
    # their leaf counts as ``_nl_handles``; under nan_policy=raise each
    # iteration's isfinite verdict waits in ``_fin_handles``.  Host trees
    # are materialized, every pending tree in one transfer, when something
    # first reads ``models``; the stall poll reads every pending leaf count
    # and verdict in one transfer every ``_poll_freq`` iterations.  The
    # validation scores take a tree when it is materialized, in tree order
    # (``_valid_queue``): the same f32 adds in the same order as adding it
    # at dispatch, without routing the validation bins over a tree whose
    # depth the host does not know.  Reading a validation set's ``"score"``
    # settles them first (``_ValidSet``).  ``host_reads`` counts the loop's
    # device->host reads.

    @property
    def last_arrays(self) -> Optional[TreeArrays]:
        """The scaled arrays of the last tree trained (None when its class
        trained none); a pending tree's are read back here, when asked
        for."""
        a = self._last_arrays
        if isinstance(a, _PendingTree):
            self._resolve_records([a])
            return a.arrays
        return a

    @last_arrays.setter
    def last_arrays(self, value) -> None:
        self._last_arrays = value

    @property
    def models(self) -> List[Tree]:
        """The host trees; materializes the pending device trees first
        (one transfer)."""
        self._settle_valid()
        return self._models

    @models.setter
    def models(self, value) -> None:
        self._invalidate_predict_cache()
        self._models: List[Optional[Tree]] = list(value)
        self._pending: Dict[int, _PendingTree] = {}
        # trees materialized since the last poll, kept so that a stall trim
        # can still take them out of the scores
        self._window: Dict[int, _PendingTree] = {}
        self._nl_handles: List[Tuple[int, int, torch.Tensor]] = []
        self._fin_handles: List[Tuple[int, torch.Tensor]] = []
        self._valid_queue = []
        self._last_poll = 0
        self._prechunk = None

    def _host_read(self, t: torch.Tensor) -> np.ndarray:
        """The asynchronous loop's device->host read, counted in
        ``host_reads``."""
        self.host_reads += 1
        return t.cpu().numpy()

    def _resolve_records(self, recs: Sequence[_PendingTree]) -> None:
        """The scaled host arrays of ``recs`` that lack them, from one
        transfer of their records (``row_leaf`` stays on the device)."""
        todo = [r for r in recs if r.arrays is None]
        if not todo:
            return
        host = self._host_read(torch.cat([r.dtree.record for r in todo]))
        off = 0
        for r in todo:
            size = r.dtree.record.numel()
            a = r.dtree.resolve(host[off:off + size])
            off += size
            # leaf values scaled by the learning rate in f32, as the
            # reference's binary path does before its score update
            r.arrays = a._replace(leaf_value=a.leaf_value * r.rate,
                                  internal_value=a.internal_value * r.rate)

    def _materialize_pending(self) -> None:
        """Every pending tree to a host tree, in one transfer
        (``_materialize_pending``, gbdt.py:278-309), then the validation
        scores of the queued trees, in tree order."""
        idxs = sorted(self._pending)
        recs = [self._pending[i] for i in idxs]
        self._pending = {}
        self._resolve_records(recs)
        for i, r in zip(idxs, recs):
            tree = tree_from_arrays(r.arrays, self.train_data, 1.0)
            if abs(r.init) > K_EPSILON:
                tree.add_bias(r.init)
            self._models[i] = tree
            self._window[i] = r
        queue, self._valid_queue = self._valid_queue, []
        self._resolve_records([r for _, r in queue])
        for _, r in queue:
            self._route_valid(r, 1.0)

    def _route_valid(self, r: _PendingTree, sign: float) -> None:
        """Every validation score of class ``r.k`` plus (``sign`` 1) or
        minus (-1) the tree's scaled leaf values over the set's bins."""
        lv = to_device_async(r.arrays.leaf_value, self.device)
        if sign < 0:
            lv = -lv
        for vs in self.valid_sets:
            _raw_score(vs)[r.k] += lv[route_binned(vs["bins"], r.arrays,
                                                   self.learner.feat_host)]

    def _settle_valid(self) -> None:
        """Materialize the pending trees and add the queued ones to the
        validation scores: before the host trees or a validation score are
        read."""
        if self._valid_queue or self._pending:
            self._materialize_pending()

    def _pending_output(self, r: _PendingTree) -> torch.Tensor:
        """[N] f32: each training row's scaled leaf value of ``r``, from
        its device ``row_leaf``, or routed over the training bins for a tree
        of the carried store."""
        row_leaf = r.row_leaf
        if row_leaf is not None and row_leaf.numel():
            return r.leaf_output()[row_leaf]
        self._resolve_records([r])
        return self._gather_tree_output(r.arrays)

    def _poll_stop(self) -> bool:
        """The deferred stall check (``_poll_stop``, gbdt.py:317-380): one
        read of every pending leaf count and isfinite verdict.  A verdict
        that failed raises, naming the first bad iteration.  When an
        iteration's trees all failed to split, everything from that
        iteration on is trimmed, as the synchronous loop would have stopped
        there: those trees leave the model and the train and validation
        scores, and ``iter_`` goes back to it."""
        self._last_poll = self.iter_
        if not self._nl_handles and not self._fin_handles:
            return False
        with watch("poll_stop", iteration=int(self.iter_)):
            vals = self._host_read(torch.stack(
                [h.to(torch.float64) for _, _, h in self._nl_handles]
                + [f.to(torch.float64) for _, f in self._fin_handles]))
        nls = vals[:len(self._nl_handles)]
        fins = vals[len(self._nl_handles):]
        bad = [it for (it, _), ok in zip(self._fin_handles, fins) if not ok]
        self._fin_handles = []
        if bad:
            self._raise_nonfinite(bad[0])
        if not self._nl_handles:
            return False
        by_iter: Dict[int, List[int]] = {}
        first_idx: Dict[int, int] = {}
        for (it, idx, _), nl in zip(self._nl_handles, nls):
            by_iter.setdefault(it, []).append(int(nl))
            first_idx[it] = min(first_idx.get(it, idx), idx)
        stalled = sorted(it for it, v in by_iter.items() if max(v) <= 1)
        self._nl_handles = []
        if not stalled:
            self._window = {}
            return False
        first = stalled[0]
        cut = first_idx[first]
        trimmed = {i: r for i, r in self._window.items() if i >= cut}
        trimmed.update((i, r) for i, r in self._pending.items() if i >= cut)
        for idx in [i for i in self._pending if i >= cut]:
            self._pending.pop(idx)
        # a queued tree never reached the validation scores
        queued = {i for i, _ in self._valid_queue if i >= cut}
        self._valid_queue = [e for e in self._valid_queue if e[0] < cut]
        # the host arrays that routing needs, in one transfer: the trees
        # to take out of the validation scores and the carried store's
        self._resolve_records([
            r for i, r in sorted(trimmed.items())
            if (self.valid_sets and i not in queued)
            or r.row_leaf is None or not r.row_leaf.numel()])
        for idx in sorted(trimmed):
            r = trimmed[idx]
            self.train_score[r.k] -= self._pending_output(r)
            if self.valid_sets and idx not in queued:
                self._route_valid(r, -1.0)
        del self._models[cut:]
        self._window = {}
        self._last_iter_arrays = []
        self._pre_iter_scores = None
        self.iter_ = first
        self._invalidate_predict_cache()
        Log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")
        return True

    def _drain_nonfinite_checks(self) -> None:
        """Read the pending isfinite verdicts (nan_policy=raise) without
        the stall poll (``_drain_nonfinite_checks``, gbdt.py:1299-1313):
        for loops that do not end in ``train`` (``engine.train``'s update
        loop), and for the trailing iterations after the last poll."""
        if not self._fin_handles:
            return
        fins = self._host_read(torch.stack(
            [f.to(torch.float64) for _, f in self._fin_handles]))
        bad = [it for (it, _), ok in zip(self._fin_handles, fins) if not ok]
        self._fin_handles = []
        if bad:
            self._raise_nonfinite(bad[0])

    @staticmethod
    def _raise_nonfinite(iteration: int) -> None:
        GBDT._nan_trip_telemetry(iteration, "raise", "raise")
        raise LightGBMError(
            "non-finite gradients/hessians/scores at iteration %d "
            "(nan_policy=raise); set nan_policy=skip_iter or clip to "
            "degrade gracefully instead" % iteration)

    # ---- setup ----

    def reset_training_data(self, train_data: BinnedDataset,
                            objective: Optional[ObjectiveFunction]) -> None:
        if objective is not None and objective.device != self.device:
            raise ValueError("objective is on %s, booster on %s"
                             % (objective.device, self.device))
        if self.train_data is not None:
            # the pending trees and the stall poll belong to the old data:
            # settle them against it first
            if self._nl_handles:
                self._poll_stop()
            self._drain_nonfinite_checks()
            self._settle_valid()
            self._window = {}
        cfg = self.config
        self.train_data = train_data
        self.objective = objective
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective else max(1, self.num_class))
        K = self.num_tree_per_iteration
        self.learner = create_tree_learner(train_data, cfg, self.device,
                                           group=self.group)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.train_score = torch.zeros((K, self.num_data), dtype=torch.float32,
                                       device=self.device)
        self._has_init_score = train_data.metadata.init_score is not None
        if self._has_init_score:
            init = np.asarray(train_data.metadata.init_score, dtype=np.float32)
            self.train_score[:] = torch.as_tensor(
                init.reshape(K, self.num_data), device=self.device)
        self.class_need_train = [True] * K
        if self.objective is not None:
            self.objective.init(train_data.metadata, self.num_data)
            if hasattr(self.objective, "class_need_train"):
                self.class_need_train = [self.objective.class_need_train(k)
                                         for k in range(K)]
        self.train_metrics = []
        self._es_state = {}
        # bagging: the stateless hash of the rows' ids (_bag_uniforms);
        # feature_fraction: one draw an iteration from this stream
        self._balanced_frac: Optional[torch.Tensor] = None
        self._row_ids = torch.arange(self.num_data, dtype=torch.int64,
                                     device=self.device)
        self._feat_rng = np.random.RandomState(int(cfg.feature_fraction_seed))
        # the sequential stream GOSS draws its "other" rows from (gbdt.py:
        # 419-422); plain bagging stays on the stateless hash
        self._bag_rng = np.random.RandomState(int(cfg.bagging_seed))
        self.bag_mask: Optional[torch.Tensor] = None
        self.bag_data_cnt = self.num_data
        self._train_bins: Optional[torch.Tensor] = None
        # the chunk's gates may differ for the new data and objective
        self._fused_keys = set()
        self._fuse_failed = False

    def add_train_metrics(self, metrics: Sequence[Metric]) -> None:
        self.train_metrics = list(metrics)
        for m in self.train_metrics:
            m.init(self.train_data.metadata, self.num_data)

    def add_valid_data(self, valid_data: BinnedDataset, name: str,
                       metrics: Optional[Sequence[Metric]] = None) -> None:
        """Attach a validation set (binned with the training set's mappers):
        its bins go to the device, its score starts at its init_score (or 0)
        plus the trees already in the model, replayed in f32 one tree at a
        time as training would have added them."""
        if metrics is None:
            metrics = create_metrics(self.config.metric, self.config)
        for m in metrics:
            m.init(valid_data.metadata, valid_data.num_data)
        K = self.num_tree_per_iteration
        score = torch.zeros((K, valid_data.num_data), dtype=torch.float32,
                            device=self.device)
        if valid_data.metadata.init_score is not None:
            init = np.asarray(valid_data.metadata.init_score, np.float32)
            score[:] = torch.as_tensor(init.reshape(K, valid_data.num_data),
                                       device=self.device)
        vs = _ValidSet(self._settle_valid, name=name, data=valid_data,
                       bins=self.learner.valid_bins(valid_data),
                       metrics=list(metrics), score=score)
        for i, tree in enumerate(self.models):
            self._add_tree_score_valid(tree, i % K, vs)
        self.valid_sets.append(vs)

    def _add_tree_score(self, tree: Tree, bins: torch.Tensor,
                        score: torch.Tensor) -> None:
        """score [N] += the tree's leaf values (f32) over the binned rows."""
        if tree.num_leaves <= 1:
            score += np.float32(tree.leaf_value[0])
            return
        arrays = arrays_from_tree(tree, self.train_data)
        lv = torch.as_tensor(arrays.leaf_value, device=self.device)
        score += lv[route_binned(bins, arrays, self.learner.feat_host)]

    def train_bins(self) -> torch.Tensor:
        """The training set's binned matrix [N, C] on the device, made once
        (``route_bins_matrix``, tree_learner.py:1950-1960): what a host
        tree is routed over when it is added to the train score."""
        if self._train_bins is None:
            self._train_bins = self.learner.valid_bins(self.train_data)
        return self._train_bins

    def _add_tree_score_train(self, tree: Tree, class_id: int) -> None:
        """train_score[class_id] += the host tree's f32 leaf values over the
        training rows (gbdt.py:537-552)."""
        self._add_tree_score(tree, self.train_bins(),
                             self.train_score[class_id])

    def _add_tree_score_valid(self, tree: Tree, class_id: int,
                              vs: dict) -> None:
        """The same for the validation set ``vs`` (gbdt.py:554-563)."""
        self._add_tree_score(tree, vs["bins"], vs["score"][class_id])

    def replay_train_score(self) -> None:
        """train_score += every tree of a loaded model, in f32, one tree at a
        time into its class (the loaded-model replay of
        ``engine.train(init_model=...)``)."""
        if not self.models or self.train_data is None:
            return
        K = self.num_tree_per_iteration
        for i, tree in enumerate(self.models):
            self._add_tree_score_train(tree, i % K)

    # ---- bagging and feature sampling (gbdt.cpp:160-276) ----

    def _balanced_bagging(self) -> bool:
        """pos/neg_bagging_fraction balanced bagging is active (needs
        bagging_freq > 0 and either class fraction below 1; label > 0 marks
        the positive class)."""
        cfg = self.config
        return (cfg.bagging_freq > 0
                and (float(cfg.pos_bagging_fraction) < 1.0
                     or float(cfg.neg_bagging_fraction) < 1.0))

    def _bagging(self, it: int, host_count: bool = True) -> None:
        """A new bag mask every ``bagging_freq`` iterations (gbdt.py:
        583-610): each row an independent Bernoulli draw of the stateless
        hash, at ``bagging_fraction`` or at the row's class fraction
        (``host_count=False``: the count stays on the device)."""
        cfg = self.config
        balanced = self._balanced_bagging()
        plain = cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
        if (balanced or plain) and it % cfg.bagging_freq == 0:
            if balanced:
                if self._balanced_frac is None:
                    label = torch.as_tensor(
                        np.asarray(self.train_data.metadata.label)
                        [:self.num_data] > 0, device=self.device)
                    f32 = dict(dtype=torch.float32, device=self.device)
                    self._balanced_frac = torch.where(
                        label, torch.tensor(cfg.pos_bagging_fraction, **f32),
                        torch.tensor(cfg.neg_bagging_fraction, **f32))
                frac = self._balanced_frac
            else:
                frac = float(cfg.bagging_fraction)
            self.bag_mask, self.bag_data_cnt = bag_mask_for(
                self._row_ids, int(cfg.bagging_seed), int(it),
                int(cfg.bagging_freq), frac, host_count)
        elif self.bag_mask is None:
            self.bag_data_cnt = self.num_data

    def _feature_mask(self) -> Optional[torch.Tensor]:
        """The features one iteration's trees may split on: a draw without
        replacement of round(F * feature_fraction) of them from the
        booster's ``feature_fraction_seed`` stream (gbdt.py:612-621)."""
        ff = float(self.config.feature_fraction)
        nf = self.train_data.num_features
        if ff >= 1.0 or nf <= 1:
            return None
        used = max(1, int(round(nf * ff)))
        chosen = self._feat_rng.choice(nf, size=used, replace=False)
        mask = np.zeros(nf, dtype=bool)
        mask[chosen] = True
        return to_device_async(mask, self.device)

    # ---- boosting (gbdt.cpp:143-158, 322-368) ----

    def _boost_from_average(self, class_id: int,
                            update_scorer: bool = True) -> float:
        """The first iteration's constant score of ``class_id``, added to
        the scores when ``update_scorer`` (RF takes it without adding it)."""
        if (not self._models and not self._has_init_score
                and self.objective is not None):
            if self.config.boost_from_average \
                    or self.train_data.num_features == 0:
                init_score = self.objective.boost_from_score(class_id)
                if abs(init_score) > K_EPSILON:
                    if update_scorer:
                        self._add_constant_score(init_score, class_id)
                    Log.info("Start training from score %f", init_score)
                    return init_score
            elif self.objective.name in ("regression_l1", "quantile", "mape"):
                Log.warning("Disabling boost_from_average in %s may cause the "
                            "slow convergence", self.objective.name)
        return 0.0

    def _add_constant_score(self, value: float, class_id: int) -> None:
        self.train_score[class_id] += value
        for vs in self.valid_sets:
            _raw_score(vs)[class_id] += value

    def _get_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, N] gradients and hessians of the current train scores."""
        if self.num_tree_per_iteration == 1:
            g, h = self.objective.get_gradients(self.train_score[0])
            return g[None, :], h[None, :]
        return self.objective.get_gradients(self.train_score)

    def _lazy_path(self) -> bool:
        """The iteration runs asynchronously (gbdt.py:661-665): not for
        DART (``lazy_trees = False``) or the objectives that renew leaf
        outputs on the host."""
        return self.lazy_trees and not (self.objective is not None and
                                        self.objective.is_renew_tree_output)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration: one tree per class.  ``gradients`` and
        ``hessians`` ([K * N], class-major) replace the objective's, as a
        custom objective's (``Booster.update(fobj=...)``).  Returns True
        when training cannot continue (no splittable leaves).

        The asynchronous iteration (gbdt.py:655-743) reads nothing back:
        its trees stay pending on the device, the bag count stays there,
        its gradients' isfinite verdict waits for the poll (nan_policy
        raise), and every ``_poll_freq`` iterations the stall poll reads
        the leaf counts, trims a stall and returns its verdict.  DART and
        the renewing objectives run :meth:`_train_one_iter_sync`."""
        self.trained_at = time.time()
        if not self._lazy_path():
            return self._train_one_iter_sync(gradients, hessians)
        K = self.num_tree_per_iteration
        self._keep_pre_iter_scores()
        init_scores = [0.0] * K
        if gradients is None or hessians is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            with FunctionTimer("GBDT::Boosting"):
                grad, hess = self._get_gradients()
        else:
            grad, hess = (np.asarray(a, dtype=np.float32).reshape(
                K, self.num_data) for a in (gradients, hessians))
        grad, hess, skip = self._guard_gradients(grad, hess)
        if skip:
            return self._skip_iteration(init_scores)
        if isinstance(grad, np.ndarray):
            grad, hess = (to_device_async(a, self.device)
                          for a in (grad, hess))
        elif self._nan_policy == "raise":
            # the verdict rides the device queue to the next poll
            self._fin_handles.append(
                (self.iter_,
                 torch.isfinite(grad).all() & torch.isfinite(hess).all()))
        return self._grow_iteration(grad, hess, init_scores, lazy=True)

    def _train_one_iter_sync(self, gradients=None, hessians=None) -> bool:
        """The synchronous iteration (``_train_one_iter_sync``,
        gbdt.py:1174-1254): one host tree per class, the gradients checked
        at once, the stop decided this iteration."""
        K = self.num_tree_per_iteration
        self._keep_pre_iter_scores()
        init_scores = [0.0] * K
        if gradients is None or hessians is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            with FunctionTimer("GBDT::Boosting"):
                grad, hess = self._get_gradients()
        else:
            grad, hess = (torch.as_tensor(
                np.asarray(a, dtype=np.float32).reshape(K, self.num_data),
                device=self.device) for a in (gradients, hessians))
        grad, hess, skip = self._guard_gradients(grad, hess, force_check=True)
        if skip:
            return self._skip_iteration(init_scores)
        return self._grow_iteration(grad, hess, init_scores)

    def _grow_iteration(self, grad: torch.Tensor, hess: torch.Tensor,
                        init_scores: List[float], lazy: bool = False,
                        poll: bool = True) -> bool:
        """The rest of an iteration from its [K, N] gradients: bagging, the
        feature mask, one tree per class; True when no tree could split.
        ``lazy`` (the asynchronous loop and the fused chunk) keeps the bag
        count and the trees on the device (:meth:`_commit_lazy`, which
        polls unless ``poll`` is False)."""
        with FunctionTimer("GBDT::Bagging"):
            self._bagging(self.iter_, host_count=not lazy)
            grad, hess = self._adjust_gradients_for_bagging(grad, hess)
        feature_mask = self._feature_mask()

        def tree_of(k: int):
            gk, hk = grad[k], hess[k]
            if self.bag_mask is not None:
                gk = gk * self.bag_mask
                hk = hk * self.bag_mask
            with FunctionTimer("TreeLearner::Train"):
                return self.learner.train(gk, hk, self._bag_data_cnt,
                                          feature_mask, iteration=self.iter_,
                                          lazy=lazy)
        if lazy:
            return self._commit_lazy(tree_of, init_scores, poll)
        return self._commit_iteration(tree_of, init_scores)

    def _commit_lazy(self, tree_of, init_scores: List[float],
                     poll: bool = True) -> bool:
        """The asynchronous commit (gbdt.py:694-743): per class ``k`` the
        device tree ``tree_of(k)`` adds its scaled leaf values to the train
        score through its ``row_leaf`` (a tree of the carried store added
        itself to the store's scores) and waits in ``_pending``; its
        validation scores wait in ``_valid_queue``.  A class that trains no
        tree keeps a constant, as the synchronous commit does.  True only
        when no class trains; a stall shows at the next poll."""
        K = self.num_tree_per_iteration
        self._last_iter_arrays = []
        rate = np.float32(self.shrinkage_rate)
        any_trained = False
        for k in range(K):
            self.last_arrays = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                any_trained = True
                r = self.last_arrays = _PendingTree(tree_of(k), k,
                                                    init_scores[k], rate)
                row_leaf = r.row_leaf
                with FunctionTimer("GBDT::UpdateScore"):
                    if row_leaf is not None and row_leaf.numel():
                        self.train_score[k] += r.leaf_output()[row_leaf]
                    idx = len(self._models)
                    self._models.append(None)
                    self._pending[idx] = r
                    self._nl_handles.append((self.iter_, idx,
                                             r.dtree.num_leaves))
                    if self.valid_sets:
                        self._valid_queue.append((idx, r))
                self._last_iter_arrays.append(r)
                continue
            new_tree = Tree(1)
            if len(self._models) < K:
                output = (self.objective.boost_from_score(k)
                          if (not self.class_need_train[k]
                              and self.objective is not None)
                          else init_scores[k])
                new_tree.leaf_value[0] = output
                if abs(output) > K_EPSILON:
                    self._add_constant_score(output, k)
            self._models.append(new_tree)
            self._last_iter_arrays.append(None)
        self._invalidate_predict_cache()
        if not any_trained:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self.iter_ += 1
        if poll and self.iter_ - self._last_poll >= self._poll_freq:
            return self._poll_stop()
        return False

    def _commit_iteration(self, tree_of, init_scores: List[float]) -> bool:
        """Per class ``k``: the tree ``tree_of(k)`` grows (when the class
        trains), goes into the scores and the model; then the iteration
        ends, or, when no tree split, training stops with the iteration's
        trees taken out again (kept as the model's constant first trees)."""
        K = self.num_tree_per_iteration
        self._last_iter_arrays = []
        should_continue = False
        for k in range(K):
            new_tree = Tree(1)
            self.last_arrays = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                arrays = tree_of(k)
                if arrays.num_leaves > 1:
                    should_continue = True
                    with FunctionTimer("GBDT::UpdateScore"):
                        new_tree = self._grow_scores(arrays, k,
                                                     init_scores[k])
                else:
                    new_tree.leaf_value[0] = init_scores[k]
            elif len(self.models) < K:
                # only once: a class that trains no tree keeps a constant
                output = (self.objective.boost_from_score(k)
                          if (not self.class_need_train[k]
                              and self.objective is not None)
                          else init_scores[k])
                new_tree.leaf_value[0] = output
                if abs(output) > K_EPSILON:
                    self._add_constant_score(output, k)
            self.models.append(new_tree)
            self._last_iter_arrays.append(self.last_arrays)
        self._invalidate_predict_cache()
        if not should_continue:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter_ += 1
        return False

    # ---- non-finite guards (nan_policy, gbdt.py:1259-1443) ----
    #
    # ``raise`` (the default) fails naming the iteration, ``skip_iter``
    # advances the iteration with constant trees, ``clip`` sanitises (NaN ->
    # 0, +-inf -> +-1e35; hessians have no negative clip) and trains on.
    # Under ``raise`` the asynchronous iteration keeps its verdict on the
    # device for the next poll (``_fin_handles``); a resilient policy, the
    # synchronous iteration and a custom objective's host gradients check
    # at once.  A fused chunk checks once, at its end
    # (``_guard_chunk_scores``), and under a resilient policy rolls back to
    # the state before it and runs its iterations again one at a time,
    # where the per-iteration guard can skip or clip the bad one.

    _NAN_CLIP = float(np.float32(1e35))

    @property
    def _nan_policy(self) -> str:
        return str(getattr(self.config, "nan_policy", "raise"))

    def _guard_gradients(self, grad, hess, force_check: bool = False):
        """(grad, hess, skip) of one iteration's [K, N] gradients
        (``_guard_gradients``, gbdt.py:1315-1346).  Host arrays (a custom
        objective's) are always checked on the host.  Device gradients are
        checked, one isfinite reduction read back, under a resilient policy
        or with ``force_check`` (the synchronous iteration); under
        ``raise`` the asynchronous iteration reads nothing here."""
        policy = self._nan_policy
        host = isinstance(grad, np.ndarray)
        if not host and policy == "raise" and not force_check:
            return grad, hess, False
        if host:
            finite = bool(np.isfinite(grad).all() and np.isfinite(hess).all())
        else:
            finite = bool(torch.isfinite(grad).all()
                          & torch.isfinite(hess).all())
        if finite:
            return grad, hess, False
        if policy == "raise":
            self._raise_nonfinite(self.iter_)
        self._nan_trip_telemetry(self.iter_, policy, policy)
        if policy == "skip_iter":
            Log.warning("non-finite gradients/hessians at iteration %d; "
                        "skipping the iteration (nan_policy=skip_iter)",
                        self.iter_)
            return grad, hess, True
        Log.warning("non-finite gradients/hessians at iteration %d; "
                    "clipping (nan_policy=clip)", self.iter_)
        clip = self._NAN_CLIP
        nan_to_num = np.nan_to_num if host else torch.nan_to_num
        grad = nan_to_num(grad, nan=0.0, posinf=clip, neginf=-clip)
        hess = nan_to_num(hess, nan=0.0, posinf=clip, neginf=0.0)
        return grad, hess, False

    @staticmethod
    def _nan_trip_telemetry(iteration: int, policy: str, action: str) -> None:
        """Cold-path accounting of a non-finite guard trip
        (gbdt.py:1283-1292)."""
        tele = _telemetry_active()
        if tele is not None:
            tele.counter("nan_policy_trips").inc()
            if action == "rollback_retry":
                tele.counter("nan_rollback_retries").inc()
            tele.event("nan_trip", iteration=int(iteration), policy=policy,
                       action=action)

    def _chunk_read(self, t: torch.Tensor) -> bool:
        """The fused chunk's own device->host read (its guard's verdict),
        counted in ``chunk_reads``."""
        self.chunk_reads += 1
        return bool(t)

    def _guard_chunk_scores(self) -> bool:
        """The per-chunk non-finite guard (``_guard_chunk_scores``,
        gbdt.py:1366-1422): one reduction over the training scores (and,
        after a fused chunk, the verdict it kept of every iteration's
        gradients, which would otherwise show only as a tree that cannot
        split), read back once.  Returns True when training must stop at
        the restored last good state.  ``raise`` raises.  On a first
        non-finite chunk under a resilient policy the chunk is rolled back
        (``_restore_prechunk``) and its iterations run again one at a time;
        if the same iteration fails again training stops there.  A clean
        chunk after a retry arms the fused path again."""
        self._chunk_rolled_back = False
        ok = torch.isfinite(self.train_score).all()
        if self._chunk_grads_ok is not None:
            ok = ok & self._chunk_grads_ok
            self._chunk_grads_ok = None
        if self._chunk_read(ok):
            self._prechunk = None
            if self._nan_refused_fuse:
                # the retried window was clean: the fault was transient
                self._fuse_failed = False
                self._nan_refused_fuse = False
            return False
        policy = self._nan_policy
        if policy == "raise":
            self._nan_trip_telemetry(self.iter_, policy, "raise")
            raise LightGBMError(
                "non-finite gradients/hessians/scores at iteration %d "
                "(nan_policy=raise); set nan_policy=skip_iter or clip to "
                "degrade gracefully instead" % self.iter_)
        if self._prechunk is None or not self._prechunk_rollback_safe:
            Log.warning("non-finite training scores after iteration %d with "
                        "no clean rollback state; stopping training",
                        self.iter_)
            return True
        self._restore_prechunk()
        self._chunk_rolled_back = True
        if self._nan_rolled_back_at == self.iter_:
            Log.warning("non-finite scores persist at iteration %d after a "
                        "per-iteration retry; stopping training at the last "
                        "good state (nan_policy=%s)", self.iter_, policy)
            return True
        Log.warning("non-finite training scores detected; rolled back to "
                    "iteration %d and retrying per-iteration "
                    "(nan_policy=%s)", self.iter_, policy)
        self._nan_trip_telemetry(self.iter_, policy, "rollback_retry")
        self._nan_rolled_back_at = self.iter_
        self._fuse_failed = True
        self._nan_refused_fuse = True
        return False

    def _restore_prechunk(self) -> None:
        """Put back the state kept when the last chunk began
        (``_restore_prechunk``, gbdt.py:1424-1443): the scores, the model's
        length, the bag and the iteration."""
        (score, vscores, queue, n_models, it, bag_mask,
         bag_cnt) = self._prechunk
        self._prechunk = None
        self.train_score = score
        for vs, v in zip(self.valid_sets, vscores):
            vs["score"] = v
        self._valid_queue = queue
        for idx in [i for i in self._pending if i >= n_models]:
            self._pending.pop(idx)
        del self._models[n_models:]
        self._window = {i: r for i, r in self._window.items()
                        if i < n_models}
        self._nl_handles = [h for h in self._nl_handles if h[1] < n_models]
        self._fin_handles = []
        self.bag_mask = bag_mask
        self.bag_data_cnt = bag_cnt
        self.iter_ = it
        self._pre_iter_scores = None
        self._last_iter_arrays = []
        self._invalidate_predict_cache()

    def _skip_iteration(self, init_scores: Optional[List[float]] = None
                        ) -> bool:
        """nan_policy=skip_iter: one constant tree per class, the scores
        untouched (``_skip_iteration``, gbdt.py:1348-1364).  On the first
        iteration the trees carry the boost-from-average offset, which is
        already in the scores."""
        K = self.num_tree_per_iteration
        first = len(self._models) < K
        for k in range(K):
            tree = Tree(1)
            if init_scores is not None and first:
                tree.leaf_value[0] = init_scores[k]
            self._models.append(tree)
        self._last_iter_arrays = [None] * K
        self._invalidate_predict_cache()
        self.iter_ += 1
        return False

    def _keep_pre_iter_scores(self) -> None:
        """Keep the scores this iteration starts from, for
        ``rollback_one_iter`` (one [K, N] f32 copy and one per validation
        set, with the trees still queued for the validation scores)."""
        self._last_iter_arrays = []
        self._pre_iter_scores = (
            (self.train_score.clone(),
             [_raw_score(vs).clone() for vs in self.valid_sets],
             list(self._valid_queue))
            if self.keep_rollback_scores else None)

    def _adjust_gradients_for_bagging(self, grad: torch.Tensor,
                                      hess: torch.Tensor):
        """[K, N] gradients after the iteration's bagging; GOSS folds its
        row weights in here (gbdt.py:1256)."""
        return grad, hess

    def _grow_scores(self, arrays: TreeArrays, k: int,
                     init_score: float) -> Tree:
        """Add a trained tree of class ``k`` to the train and validation
        scores and return its host tree (leaf values renewed for the
        percentile objectives, then scaled by the learning rate).  A tree of
        the carried store (empty ``row_leaf``) already added itself to the
        store's scores."""
        rate = np.float32(self.shrinkage_rate)
        renewed = self._renew_tree_output(arrays, k)
        if renewed is None and self.lazy_trees:
            # leaf values scaled by the learning rate in f32, as the
            # reference's binary path does before its score update
            scaled = arrays._replace(
                leaf_value=arrays.leaf_value * rate,
                internal_value=arrays.internal_value * rate)
            tree = tree_from_arrays(scaled, self.train_data, 1.0)
            valid_lv = scaled.leaf_value
        else:
            # the JAX package's synchronous path (gbdt.py:1174-1254): the
            # host tree's (renewed) values shrink in f64, the train score
            # takes the f32 products and the validation scores the host
            # tree's values in f32
            tree = tree_from_arrays(arrays, self.train_data, 1.0)
            if renewed is not None:
                tree.leaf_value[:tree.num_leaves] = renewed
                arrays = arrays._replace(leaf_value=renewed.astype(np.float32))
            tree.shrink(self.shrinkage_rate)
            scaled = arrays._replace(leaf_value=arrays.leaf_value * rate)
            valid_lv = tree.leaf_value[:tree.num_leaves].astype(np.float32)
        if arrays.row_leaf.numel():
            lv = torch.as_tensor(scaled.leaf_value, device=self.device)
            self.train_score[k] += lv[arrays.row_leaf]
        vlv = torch.as_tensor(valid_lv, device=self.device)
        for vs in self.valid_sets:
            vs["score"][k] += vlv[route_binned(vs["bins"], scaled,
                                               self.learner.feat_host)]
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.last_arrays = scaled
        return tree

    def _renew_tree_output(self, arrays: TreeArrays,
                           class_id: int) -> Optional[np.ndarray]:
        """Per-leaf output renewal of the percentile objectives
        (serial_tree_learner.cpp:706-744 RenewTreeOutput; gbdt.py:1674-1703
        of the JAX package): each leaf's value becomes the objective's
        percentile of its in-bag rows' residuals (label - score), weighted
        by the MAPE label weights for mape.  Host numpy, so that the values
        equal the JAX package's; None for the other objectives."""
        obj = self.objective
        if obj is None or not obj.is_renew_tree_output:
            return None
        nl = int(arrays.num_leaves)
        row_leaf = arrays.row_leaf.cpu().numpy()
        residual = obj.label_np - self.train_score[class_id].cpu().numpy()
        weights = (obj.label_weight_np if obj.name == "mape"
                   else obj.weights_np)
        rows = np.arange(self.num_data)
        if self.bag_mask is not None:
            rows = rows[self.bag_mask.cpu().numpy() > 0]
        # each leaf's rows in their original order (a stable sort by leaf)
        rows = rows[np.argsort(row_leaf[rows], kind="stable")]
        ends = np.searchsorted(row_leaf[rows], np.arange(nl + 1))
        new_vals = np.asarray(arrays.leaf_value[:nl], np.float64).copy()
        for leaf in range(nl):
            r = rows[ends[leaf]:ends[leaf + 1]]
            if r.size:
                new_vals[leaf] = obj.renew_tree_output(
                    residual[r], None if weights is None else weights[r])
        return new_vals

    # ---- the fused multi-iteration chunk (gbdt.py:745-1100) ----
    #
    # Where an iteration makes no decision on the host (no feature sampling,
    # no leaf renewal, gradients that are a function of the scores, the
    # serial learner), ``train_chunk`` runs k iterations without reading
    # anything back from the device but one guard verdict at the end.  For
    # a single-model pointwise objective
    # without sample weights the chunk carries the objective's per-row value
    # and the running score inside the tree learner's permuted row store
    # (carried row-store training): each tree's gradients come from the
    # store's columns, only their bytes are rewritten, and the tree adds
    # its leaf values to the score column over its windows; the scores go
    # back to original order once, at the chunk's end.  Otherwise
    # (multiclass, sample weights, other objectives) the chunk runs the
    # asynchronous iteration of ``train_one_iter`` without its score
    # copies.  Bagging keys its mask by original row ids, the carried
    # store's order bytes, so every path draws the same bag.
    #
    # The chunk runs all k iterations and leaves their trees pending, as
    # the JAX package leaves its scan's stacked trees (gbdt.py:1071-1098):
    # an iteration that made no split is found by the stall poll, which
    # trims it and everything after it (``_poll_stop``), and the poll runs
    # at the chunk's end once ``_poll_freq`` iterations have passed since
    # the last one.  The JAX traceability probe
    # (``_fuse_failed`` on a trace error, gbdt.py:1036-1046) has no
    # counterpart: every objective of the port is torch, and a Python
    # ``fobj`` trains through ``train_one_iter``.

    def _can_fuse_iters(self) -> bool:
        """The chunk may fuse its iterations (gbdt.py:760-784)."""
        obj = self.objective
        if not (self.fuse_iters and self.lazy_trees and obj is not None
                and not obj.is_renew_tree_output
                and obj.deterministic_gradients):
            return False
        if not self.train_data.num_features or not all(self.class_need_train):
            return False
        if float(self.config.feature_fraction) < 1.0:
            return False
        if self._balanced_bagging():
            # per-class fractions need the labels, which the permuted store
            # does not carry
            return False
        learner = self.learner
        if learner.comm is not None or learner.cegb is not None:
            return False
        return not self._fuse_failed

    def _fused_bag(self):
        """(fraction, freq) when bagging is on (gbdt.py:788-793)."""
        cfg = self.config
        if cfg.bagging_freq > 0 and float(cfg.bagging_fraction) < 1.0:
            return float(cfg.bagging_fraction), int(cfg.bagging_freq)
        return None

    def _trees_per_chunk(self) -> int:
        """``trees_per_chunk`` (gbdt.py:795-799): iterations grouped into
        one step of the chunk (:func:`_steps_grouped`)."""
        return max(1, int(getattr(self.config, "trees_per_chunk", 1) or 1))

    def _can_carry_rows(self) -> bool:
        """Carried row-store training (gbdt.py:801-812): one model per
        iteration, an objective with a carried value (no sample weights)
        and the serial learner."""
        if self.num_tree_per_iteration != 1:
            return False
        if self.objective is None or self.objective.carry_aux() is None:
            return False
        return type(self.learner).__name__ == "SerialTreeLearner"

    def train_chunk(self, num_iters: int) -> bool:
        """Run up to ``num_iters`` iterations (gbdt.py:1003-1099): fused
        when :meth:`_can_fuse_iters` holds, in one watchdog section
        ``fused_train_chunk``, else one ``train_one_iter`` at a time.
        Returns True when training stopped (no more splittable leaves, found
        by the stall poll that ends a fused chunk once ``_poll_freq``
        iterations have passed since the last poll)."""
        if num_iters <= 0:
            return False
        self.trained_at = time.time()
        self._prechunk = None
        if self._nan_policy != "raise":
            # the state the rollback of a non-finite chunk restores; the
            # chunk writes the scores in place, so they are copied
            self._prechunk = (self.train_score.clone(),
                              [_raw_score(vs).clone()
                               for vs in self.valid_sets],
                              list(self._valid_queue), len(self._models),
                              self.iter_, self.bag_mask, self._bag_data_cnt)
        tele = _telemetry_active()
        t0 = time.perf_counter()
        it0 = self.iter_
        if not self._can_fuse_iters():
            stopped = False
            for _ in range(num_iters):
                if self.watched_iter():
                    stopped = True
                    break
            if tele is not None:
                self._record_chunk_telemetry(tele, it0,
                                             time.perf_counter() - t0,
                                             fused=False)
            return stopped
        # the first chunk of each length is the port's counterpart of a new
        # fused program (gbdt.py:1032-1050): a steady run repeats the
        # config-aligned lengths, so the counter stays flat after warm-up
        key = (num_iters, self.shrinkage_rate, self.num_tree_per_iteration,
               len(self.valid_sets))
        first = key not in self._fused_keys
        if first:
            self._fused_keys.add(key)
            _recompile.record("fused_train", "k=%d" % num_iters)
        body = (self._chunk_carried if self._can_carry_rows()
                else self._chunk_plain)
        its = list(range(it0, it0 + num_iters))
        with FunctionTimer("GBDT::TrainChunk"), \
                _annotate("fused_train_chunk"), \
                watch("fused_train_chunk", builds=self.device.type == "cuda",
                      compile_key=int(num_iters), first_iter=int(it0),
                      iters=int(num_iters)):
            body(its)
        self._invalidate_predict_cache()
        if tele is not None:
            self._record_chunk_telemetry(tele, it0, time.perf_counter() - t0,
                                         fused=True,
                                         compile_key="k=%d" % num_iters,
                                         compiles=int(first))
        if self.iter_ - self._last_poll >= self._poll_freq:
            return self._poll_stop()
        return False

    def _note_grads(self, grad: torch.Tensor, hess: torch.Tensor) -> None:
        """Fold one iteration's gradient finiteness into the chunk's verdict
        on the device (read once, by ``_guard_chunk_scores``)."""
        ok = torch.isfinite(grad).all() & torch.isfinite(hess).all()
        prev = self._chunk_grads_ok
        self._chunk_grads_ok = ok if prev is None else prev & ok

    def _chunk_plain(self, its: List[int]) -> None:
        """The plain fused chunk (``_make_fused_train``, gbdt.py:927-1001):
        each iteration as the asynchronous ``train_one_iter`` runs it,
        without its score copies and its poll; the trees and scores equal
        the per-iteration path's bit for bit."""
        K = self.num_tree_per_iteration

        def step(it: int) -> None:
            self._pre_iter_scores = None
            init_scores = [self._boost_from_average(k) for k in range(K)]
            with FunctionTimer("GBDT::Boosting"):
                grad, hess = self._get_gradients()
            self._note_grads(grad, hess)
            self._grow_iteration(grad, hess, init_scores, lazy=True,
                                 poll=False)
        _steps_grouped(step, its, self._trees_per_chunk())

    def _chunk_carried(self, its: List[int]) -> None:
        """The carried chunk (``_make_fused_train_carried``, gbdt.py:
        814-925).  The first tree builds the carried store from the original
        row order with the objective's value and the score; each later tree
        takes its gradients (``pointwise_gradients``) from the store's
        columns in the store's order, and its bag mask from the order
        bytes.  At the end the score column goes back to original order in
        ``train_score``."""
        learner, obj = self.learner, self.objective
        n = self.num_data
        lay = learner.row_layout(carried=True)
        rate = np.float32(self.shrinkage_rate)
        aux = obj.carry_aux().to(torch.float32)
        bag = self._fused_bag()
        seed = int(self.config.bagging_seed)
        store = {}

        def step(it: int) -> None:
            self._pre_iter_scores = None
            init_scores = [self._boost_from_average(0)]
            rows = store.get("rows")
            if rows is None:
                score, auxv, ids = self.train_score[0], aux, self._row_ids
            else:
                score = store_f32(rows, lay.soff, n)
                auxv = store_f32(rows, lay.aoff, n)
                ids = store_order(rows, lay, n) if bag is not None else None
            with FunctionTimer("GBDT::Boosting"):
                g, h = obj.pointwise_gradients(score, auxv)
            self._note_grads(g, h)
            count = n
            with FunctionTimer("GBDT::Bagging"):
                if bag is not None:
                    mask, count = bag_mask_for(ids, seed, it, bag[1], bag[0],
                                               host_count=False)
                    g, h = g * mask, h * mask
            kw = (dict(extra=(aux, score)) if rows is None
                  else dict(rows_carry=rows))

            def tree_of(k: int) -> DeviceTree:
                with FunctionTimer("TreeLearner::Train"):
                    tree, store["rows"] = learner.train(
                        g, h, count, iteration=it, carried=True,
                        score_rate=rate, lazy=True, **kw)
                return tree
            self._commit_lazy(tree_of, init_scores, poll=False)

        _steps_grouped(step, its, self._trees_per_chunk())
        rows = store.get("rows")
        if rows is not None:
            score = torch.zeros(n, dtype=torch.float32, device=self.device)
            score[store_order(rows, lay, n)] = store_f32(rows, lay.soff, n)
            self.train_score = score[None]
        if bag is not None:
            # the bag of the window in progress, in original row order, for
            # an iteration that runs outside a chunk next
            self.bag_mask, self.bag_data_cnt = bag_mask_for(
                self._row_ids, seed, max(self.iter_ - 1, 0), bag[1], bag[0],
                host_count=False)

    def _gather_tree_output(self, arrays: TreeArrays) -> torch.Tensor:
        """[N] f32: each training row's leaf value of ``arrays``
        (gbdt.py:472-480), through its ``row_leaf``, or routed over the
        training bins for a tree of the carried store, whose row_leaf is
        empty."""
        lv = torch.as_tensor(arrays.leaf_value, device=self.device)
        if arrays.row_leaf is None or arrays.row_leaf.numel() == 0:
            return lv[route_binned(self.train_bins(), arrays,
                                   self.learner.feat_host)]
        return lv[arrays.row_leaf]

    # ---- the training loop (gbdt.py:1843-1908) ----

    def train(self, snapshot_out: Optional[str] = None) -> None:
        """Train up to ``num_iterations`` iterations (counting from this
        booster's first; a restored booster goes on from its iteration) in
        chunks (:meth:`train_chunk`), each ending at the next multiple of
        ``metric_freq`` (when anything is evaluated) and of
        ``snapshot_freq``, at most ``chunk_cap`` long: the chunks follow the
        config, not ``snapshot_out``, so a resumed run cuts the iterations
        as the uninterrupted one did (gbdt.py:1859-1864).  After each chunk:
        the non-finite guard, the evaluation and early stopping, the
        preemption poll (so a preempted run stops at a chunk boundary, with
        its emergency checkpoint) and, with ``snapshot_out``, every
        ``snapshot_freq`` iterations the model at
        ``<snapshot_out>.snapshot_iter_<n>`` and a checkpoint beside it
        (gbdt.py:1917-1950)."""
        t_start = time.perf_counter()
        it_start = self.iter_
        total = int(self.config.num_iterations)
        has_eval = bool(self.train_metrics) or bool(self.valid_sets)
        mf = int(self.config.metric_freq)
        sf = int(self.config.snapshot_freq)
        tele = _telemetry_active()
        chunk_cap = int(max(1, min(64, (1 << 31) // max(4 * self.num_data,
                                                          1))))
        while self.iter_ < total:
            it = self.iter_
            nxt = total
            if has_eval and mf > 0:
                nxt = min(nxt, it + mf - it % mf)
            if sf > 0:
                nxt = min(nxt, it + sf - it % sf)
            finished = self.train_chunk(min(nxt - it, chunk_cap))
            if self._guard_chunk_scores():
                break
            if self._chunk_rolled_back:
                continue  # the chunk again, one iteration at a time
            Log.info("%f seconds elapsed, finished iteration %d",
                     time.perf_counter() - t_start, self.iter_)
            if not finished and has_eval and mf > 0 and self.iter_ % mf == 0:
                finished = self.eval_and_check_early_stopping()
            if finished:
                break
            if preemption_requested():
                # polled at the chunk boundary (gbdt.py:1879-1885), after
                # the eval, so the emergency checkpoint holds the same
                # early-stopping state a periodic one would
                self._preempt_exit(snapshot_out)
            if snapshot_out and sf > 0 and self.iter_ % sf == 0:
                # the stall poll first (gbdt.py:1886-1894): a snapshot never
                # holds iterations a later poll would trim; a trim ends
                # training after the snapshot of its state
                finished = bool(self._nl_handles) and self._poll_stop()
                self._write_snapshot(snapshot_out)
                if finished:
                    break
        if self._nl_handles:
            self._poll_stop()   # trims trailing stalled iterations
        elif self._fin_handles:
            self._drain_nonfinite_checks()
        if tele is not None:
            # the run gauges report.summarize folds into row-trees/s; the
            # iterations are this call's (a resumed run's wall covers only
            # this process's work)
            tele.gauge("train_rows").set(int(self.num_data))
            tele.gauge("train_iterations").set(int(self.iter_ - it_start))
            tele.gauge("train_wall_s").set(time.perf_counter() - t_start)

    def _record_chunk_telemetry(self, tele, first_iter: int, dt: float,
                                fused: bool = False, compile_key=None,
                                compiles: int = 0) -> None:
        """One chunk's metrics and events (``_record_chunk_telemetry``,
        gbdt.py:1101-1170); ``dt`` is its host wall.  ``compile_key`` and
        ``compiles`` feed the compile accountant (``obs/compile.py``): the
        first chunk of a length is priced against the ones that follow."""
        iters = self.iter_ - first_iter
        if iters <= 0:
            return
        rows = float(self.num_data) * iters
        rate = rows / dt if dt > 0 else 0.0
        tele.histogram("chunk_dispatch_s").observe(dt)
        tele.histogram("chunk_rows_per_s").observe(rate)
        tele.histogram("chunk_ns_per_row").observe(
            dt / rows * 1e9 if rows else 0.0)
        tele.gauge("bag_data_cnt").set(self.bag_data_cnt)
        tele.event("train_chunk", first_iter=int(first_iter),
                   iters=int(iters), dt_s=dt, rows_per_s=rate,
                   fused=bool(fused), bag_data_cnt=int(self.bag_data_cnt))
        if compile_key is not None:
            _compile.note_dispatch(tele, "fused_train", compile_key, dt,
                                   int(compiles))
        learner = getattr(self, "learner", None)
        if learner is not None and getattr(learner, "quantized", False):
            from ..core.quant import GRAD_LEVELS, HESS_LEVELS
            # the integer kernels read two value rows (grad, hess) a row,
            # the exact ones four (hist_channels of the JAX package)
            tele.counter("quant_chunks").inc()
            tele.counter("quant_iters").inc(int(iters))
            tele.gauge("quant_grad_levels").set(GRAD_LEVELS)
            tele.gauge("quant_hess_levels").set(HESS_LEVELS)
            tele.gauge("quant_hist_channels").set(2)
            tele.event("quant", first_iter=int(first_iter),
                       iters=int(iters), grad_levels=int(GRAD_LEVELS),
                       hess_levels=int(HESS_LEVELS), hist_channels=2,
                       exact_channels=4,
                       collective_dtype=("float32" if getattr(
                           learner, "comm", None) is not None else ""))
        _devmem.sample(tele, phase="train_chunk")
        _spans.record_span(tele, "train_chunk", t0=time.time() - dt,
                           dur_s=dt, trace_id=tele.trace_id,
                           first_iter=int(first_iter), iters=int(iters),
                           fused=bool(fused))

    def watched_iter(self, gradients=None, hessians=None) -> bool:
        """:meth:`train_one_iter` inside a watchdog section (a no-op when
        no watchdog is armed); every entry point's iterations come here."""
        with watch("train_one_iter", builds=self.device.type == "cuda",
                   iteration=int(self.iter_)):
            return self.train_one_iter(gradients, hessians)

    def _preempt_exit(self, snapshot_out: Optional[str]) -> None:
        """The preemption flag is set: settle the stall poll and the
        pending isfinite verdicts, let the queued device work finish, write
        the emergency checkpoint through the ordinary atomic path, consume
        the flag and raise :class:`TrainingPreempted`, which the entry
        points turn into the resumable exit (gbdt.py:1910-1930)."""
        if self._nl_handles:
            self._poll_stop()
        if self._fin_handles:
            self._drain_nonfinite_checks()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        path = seconds = None
        if snapshot_out:
            path, seconds = emergency_checkpoint(self, snapshot_out)
        # handled: a later train() in this process (the in-process resume)
        # starts with a clear flag
        clear_preemption()
        raise TrainingPreempted(int(self.iter_), path,
                                checkpoint_seconds=seconds)

    def _write_snapshot(self, snapshot_out: str) -> None:
        """The model snapshot (gbdt.cpp:291-295) and a checkpoint of the
        train state, both atomic and best effort: a failed write is skipped
        with a warning, and the previous checkpoint stays the resume
        point."""
        from ..checkpoint import save_checkpoint_best_effort
        if not is_write_leader(self.group):
            return
        snap = "%s.snapshot_iter_%d" % (snapshot_out, self.iter_)
        try:
            self.save_model(snap)
        except OSError as exc:
            Log.warning("model snapshot %s failed (%s); training continues",
                        snap, exc)
        save_checkpoint_best_effort(self, snapshot_out)

    # the model's length needs no materialization
    @property
    def num_trees(self) -> int:
        return len(self._models)

    @property
    def current_iteration(self) -> int:
        return len(self._models) // max(self.num_tree_per_iteration, 1)

    # ---- evaluation (gbdt.py:1952-1994) ----

    def _eval(self, name: str, score: torch.Tensor, metrics):
        """[(data name, metric name, value, bigger is better)] of one set."""
        host = score.cpu().numpy()
        return [(name, mname, val, m.factor_to_bigger_better > 0)
                for m in metrics
                for mname, val in zip(m.names, m.eval(host, self.objective))]

    def get_training_score(self) -> torch.Tensor:
        """The [K, N] scores the gradients of this iteration are computed
        from (gbdt.py:648-650 of the JAX package): the train score."""
        return self.train_score

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.get_training_score(),
                          self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        return [r for vs in self.valid_sets
                for r in self._eval(vs["name"], vs["score"], vs["metrics"])]

    def eval_and_check_early_stopping(self) -> bool:
        """Log the metrics; True when a validation metric has not improved
        for ``early_stopping_round`` evaluations' worth of iterations (with
        ``first_metric_only``, only the first metric of each set counts,
        gbdt.cpp OutputMetric).  Records ``best_iteration`` when it stops."""
        tele = _telemetry_active()
        for ds, name, val, _ in self.eval_train():
            Log.info("Iteration:%d, %s %s : %g", self.iter_, ds, name, val)
            if tele is not None:
                tele.event("eval", iteration=int(self.iter_), dataset=ds,
                           metric=name, value=float(val))
        rounds = int(self.config.early_stopping_round)
        first_only = bool(self.config.first_metric_only)
        stop = False
        for vs in self.valid_sets:
            first = None
            for ds, name, val, bigger_better in self._eval(
                    vs["name"], vs["score"], vs["metrics"]):
                Log.info("Iteration:%d, %s %s : %g", self.iter_, ds, name, val)
                if tele is not None:
                    tele.event("eval", iteration=int(self.iter_), dataset=ds,
                               metric=name, value=float(val))
                first = name if first is None else first
                if rounds <= 0 or (first_only and name != first):
                    continue
                cur = val if bigger_better else -val
                best = self._es_state.get((ds, name))
                if best is None or cur > best[0]:
                    self._es_state[(ds, name)] = (cur, self.iter_)
                elif self.iter_ - best[1] >= rounds:
                    Log.info("Early stopping at iteration %d, the best "
                             "iteration round is %d", self.iter_, best[1])
                    self.best_iteration = best[1]
                    stop = True
        return stop

    # ---- prediction (gbdt.py:1999-2343) ----

    def _invalidate_predict_cache(self) -> None:
        """Drop the stacked predictors: a change to the trees (a new tree,
        DART's shrinks, refit, rollback, a loaded model) must not be served
        from stale stacks."""
        self._fused_pred = {}
        self._stacked_pred = None

    def _iteration_range(self, num_iteration: int, start_iteration: int):
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        end = total if num_iteration <= 0 else min(
            total, start_iteration + num_iteration)
        return end, self.models[start_iteration * K:end * K]

    def _predict_early_stop(self) -> Tuple[float, int]:
        """(margin, round period) of prediction early stop; a margin below 0
        turns it off.  Only for one model per iteration and an objective
        that does not need accurate predictions (predictor.hpp:38-47,
        gbdt.py:2001-2012)."""
        if (bool(self.config.pred_early_stop)
                and self.num_tree_per_iteration == 1
                and self.objective is not None
                and not self.objective.need_accurate_prediction):
            return (float(self.config.pred_early_stop_margin),
                    int(self.config.pred_early_stop_freq))
        return -1.0, 10

    def _fused_predictor(self, sel: List[Tree], start: int, end: int,
                         class_id: int, kind: str = "raw", layout_ds=None,
                         precision: str = "exact") -> FusedPredictor:
        """The cached device predictor of one (kind, iteration range, class,
        model count, layout, precision), stacked once (gbdt.py:2019-2046);
        at most 8 are kept."""
        if kind == "binned" and layout_ds is None:
            layout_ds = self.train_data
        key = (kind, start, end, class_id, len(self.models),
               id(layout_ds) if kind == "binned" else 0, precision)
        pred = self._fused_pred.get(key)
        if pred is None:
            if len(self._fused_pred) >= 8:
                self._fused_pred.pop(next(iter(self._fused_pred)))
            pred = FusedPredictor(sel, dataset=layout_ds, kind=kind,
                                  precision=precision, device=self.device)
            if note_stack(self, (kind, start, end, class_id, precision,
                                 key[5], len(self.models))):
                pred.pending_miss = True
            self._fused_pred[key] = pred
        return pred

    def _stacked(self, sel: List[Tree], start: int, end: int):
        """The cached f64-regime stacks of ``sel``, one per class."""
        K = self.num_tree_per_iteration
        key = (start, end, len(self.models))
        if self._stacked_pred is None or self._stacked_pred[0] != key:
            self._stacked_pred = (key, [StackedTrees(sel[k::K], self.device)
                                        for k in range(K)])
        return self._stacked_pred[1]

    def _sharded_comm(self):
        """The process comm of a parallel learner, whose ranks all predict
        together (None for a serial or a loaded booster)."""
        learner = getattr(self, "learner", None)
        comm = getattr(learner, "comm", None)
        return None if comm is None else comm.ops

    def _raw_predict(self, X, num_iteration: int = -1,
                     start_iteration: int = 0,
                     precision: str = "exact") -> np.ndarray:
        """[K, n] f64 raw scores of the iterations [start_iteration,
        start_iteration + num_iteration) (all when ``num_iteration <= 0``):
        the f32 regime from 512 rows on and in the bf16 tier, the f64 regime
        below (gbdt.py:2052-2110)."""
        n = len(X)
        K = self.num_tree_per_iteration
        out = np.zeros((K, n), dtype=np.float64)
        end, sel = self._iteration_range(num_iteration, start_iteration)
        if not sel or n == 0:
            return out
        margin, freq = self._predict_early_stop()
        if n >= self._DEVICE_PREDICT_MIN_ROWS or precision != "exact":
            comm = self._sharded_comm()
            for k in range(K):
                pred = self._fused_predictor(sel[k::K], start_iteration, end,
                                             k, precision=precision)
                out[k] = (pred(X, margin, freq) if comm is None else
                          sharded_predict(pred, X, comm,
                                          early_stop_margin=margin,
                                          round_period=freq))
            return out
        for k, st in enumerate(self._stacked(sel, start_iteration, end)):
            out[k] = st.predict(X, torch.float64, margin, freq)
        return out

    def _convert(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        """[K, n] raw scores -> [n] or [n, K] outputs: averaged over every
        iteration of the model for ``average_output`` (gbdt.py:2119-2121),
        converted by the objective unless ``raw_score``."""
        if self.average_output:
            raw = raw / max(len(self.models) // self.num_tree_per_iteration,
                            1)
        if not raw_score and self.objective is not None:
            raw = np.asarray(self.objective.convert_output(raw))
        return raw[0] if self.num_tree_per_iteration == 1 else raw.T

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                start_iteration: int = 0,
                precision: str = "exact") -> np.ndarray:
        """[n, D] raw features -> [n] scores, or [n, K] for K classes
        (converted by the objective unless ``raw_score``), computed on the
        booster's device; ``precision="bf16"`` carries the leaf values and
        the score in bfloat16."""
        if precision not in ("exact", "bf16"):
            raise ValueError("precision must be 'exact' or 'bf16'")
        return self._convert(self._raw_predict(X, num_iteration,
                                               start_iteration, precision),
                             raw_score)

    def predict_contrib(self, X, num_iteration: int = -1,
                        start_iteration: int = 0) -> np.ndarray:
        """SHAP contributions (tree.h:133 PredictContrib): [n, F + 1] (last
        column the expected value), K classes concatenated along axis 1,
        on f32-cast rows.  From 8 rows on, the device TreeSHAP of
        ``core.predict_contrib``; below, the host recursion
        (gbdt.py:2130-2185, without its fallback: a failure raises)."""
        K = self.num_tree_per_iteration
        end, sel = self._iteration_range(num_iteration, start_iteration)
        n = len(X)
        ncol = self.max_feature_idx + 2
        out = np.zeros((K, n, ncol), dtype=np.float64)
        Xf = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        if sel and n >= self._DEVICE_CONTRIB_MIN_ROWS:
            comm = self._sharded_comm()
            for k in range(K):
                pred = self._fused_predictor(sel[k::K], start_iteration, end,
                                             k)
                out[k] = (pred.predict_contrib(Xf, ncol) if comm is None else
                          sharded_predict_contrib(pred, Xf, ncol, comm))
        else:
            for i, tree in enumerate(sel):
                out[i % K] += tree.predict_contrib(Xf, ncol)
        return out[0] if K == 1 else np.concatenate(out, axis=1)

    def predict_leaf_index(self, X, num_iteration: int = -1) -> np.ndarray:
        """[n, num_models] int32 leaf of every row in every tree of the first
        ``num_iteration`` iterations (gbdt.py:2213): the f32 regime's
        routing from 512 rows on, the f64 one below."""
        K = self.num_tree_per_iteration
        end, sel = self._iteration_range(num_iteration, 0)
        out = np.zeros((len(X), len(sel)), dtype=np.int32)
        if not sel or len(X) == 0:
            return out
        if len(X) >= self._DEVICE_PREDICT_MIN_ROWS:
            for k in range(K):
                out[:, k::K] = self._fused_predictor(sel[k::K], 0, end, k)(
                    X, want_leaf=True)
            return out
        for k, st in enumerate(self._stacked(sel, 0, end)):
            out[:, k::K] = st.predict(X, torch.float64, want_leaf=True)
        return out

    def _binned_rows(self, dataset: Optional[BinnedDataset]):
        """(dataset, its rows, the layout) of a binned predict: the training
        set's rows from the device when it is the training set."""
        ds = dataset if dataset is not None else self.train_data
        if ds is None or ds.binned is None:
            raise ValueError("binned prediction needs a BinnedDataset with "
                             "its row store attached")
        rows = (self.train_bins() if ds is self.train_data
                and self.train_data is not None else ds.binned)
        layout = self.train_data if self.train_data is not None else ds
        return ds, rows, layout

    def raw_predict_binned(self, dataset: Optional[BinnedDataset] = None,
                           num_iteration: int = -1, start_iteration: int = 0,
                           use_early_stop: bool = True) -> np.ndarray:
        """[K, N] raw scores of a binned dataset's row store (the training
        set by default; any set binned with its mappers), routed by integer
        compares: on training rows the same bits as :meth:`predict`'s f32
        regime (gbdt.py:2260)."""
        ds, rows, layout = self._binned_rows(dataset)
        K = self.num_tree_per_iteration
        out = np.zeros((K, ds.num_data), dtype=np.float64)
        end, sel = self._iteration_range(num_iteration, start_iteration)
        if not sel:
            return out
        margin, freq = ((-1.0, 10) if not use_early_stop
                        else self._predict_early_stop())
        for k in range(K):
            out[k] = self._fused_predictor(
                sel[k::K], start_iteration, end, k, kind="binned",
                layout_ds=layout)(rows, margin, freq)
        # quality plane (gbdt.py:2292-2310): an EXTERNAL dataset's bins fold
        # into the drift counters (replays of the training set are drift
        # free by definition); quality_monitor=false switches it off
        tele = _telemetry_active()
        if tele is not None and dataset is not None \
                and ds is not self.train_data \
                and bool(getattr(self.config, "quality_monitor", True)):
            from ..obs import quality as _quality
            mon = _quality.monitor(
                tele, create=True,
                top_k=int(getattr(self.config, "quality_top_k", 20)))
            mon.observe(tele, getattr(self, "quality_name", "model"), self,
                        layout, 1, ds.binned, "binned",
                        scores=out[0] if K == 1 else None, raw_score=True)
        return out

    def quality_baseline(self, layout_ds=None):
        """Drift baseline of this model against ``layout_ds`` (default the
        training data): per-feature training bin occupancy, importance and
        the score fingerprints, cached per (layout, model size)
        (gbdt.py:2230-2258).  None without a layout dataset."""
        from ..obs.quality import QualityBaseline, capture_fingerprints
        ds = layout_ds if layout_ds is not None else self.train_data
        if ds is None:
            return None
        key = len(self.models)
        cached = self._quality_baseline_cache
        if cached is not None and cached[0] is ds and cached[1] == key:
            return cached[2]
        if (self._score_fingerprint_raw is None
                and getattr(self, "train_score", None) is not None):
            # taken here, on the first baseline, not at train end: a run
            # with telemetry off never pays for it
            capture_fingerprints(self)
        base = QualityBaseline.from_model(self, ds)
        self._quality_baseline_cache = (ds, key, base)
        return base

    def predict_binned(self, dataset: Optional[BinnedDataset] = None,
                       raw_score: bool = False, num_iteration: int = -1,
                       start_iteration: int = 0) -> np.ndarray:
        """:meth:`predict` over a binned dataset's row store
        (gbdt.py:2312)."""
        return self._convert(self.raw_predict_binned(
            dataset, num_iteration, start_iteration), raw_score)

    def predict_leaf_index_binned(
            self, dataset: Optional[BinnedDataset] = None,
            num_iteration: int = -1) -> np.ndarray:
        """[N, num_models] leaf indices of a binned row store (the router of
        ``refit``, gbdt.py:2324)."""
        ds, rows, layout = self._binned_rows(dataset)
        K = self.num_tree_per_iteration
        end, sel = self._iteration_range(num_iteration, 0)
        out = np.zeros((ds.num_data, len(sel)), dtype=np.int32)
        for k in range(K if sel else 0):
            out[:, k::K] = self._fused_predictor(
                sel[k::K], 0, end, k, kind="binned", layout_ds=layout)(
                    rows, want_leaf=True)
        return out

    def predict_contrib_binned(self, dataset: Optional[BinnedDataset] = None,
                               num_iteration: int = -1,
                               start_iteration: int = 0) -> np.ndarray:
        """SHAP contributions of a binned row store (gbdt.py:2187): on
        training rows the same bits as :meth:`predict_contrib`."""
        ds, rows, layout = self._binned_rows(dataset)
        K = self.num_tree_per_iteration
        end, sel = self._iteration_range(num_iteration, start_iteration)
        ncol = self.max_feature_idx + 2
        out = np.zeros((K, ds.num_data, ncol), dtype=np.float64)
        for k in range(K if sel else 0):
            out[k] = self._fused_predictor(
                sel[k::K], start_iteration, end, k, kind="binned",
                layout_ds=layout).predict_contrib(rows, ncol)
        return out[0] if K == 1 else np.concatenate(out, axis=1)

    # ---- model surgery (gbdt.cpp:299, :454-470; gbdt.py:1800-1839) ----

    def _drop_rollback_caches(self) -> None:
        """After surgery on the trees: the predictors restack, and a later
        rollback cannot restore or subtract the last iteration."""
        self._invalidate_predict_cache()
        self._pre_iter_scores = None
        self._last_iter_arrays = []

    def merge_from(self, other: "GBDT") -> None:
        """Append ``other``'s trees (c_api.cpp Booster::MergeFrom), deep
        copies, so later leaf surgery on one booster leaves the other as
        it was; the iteration counts add."""
        if other.num_tree_per_iteration != self.num_tree_per_iteration:
            raise ValueError("cannot merge boosters with different "
                             "num_tree_per_iteration")
        import copy
        self.models.extend(copy.deepcopy(t) for t in other.models)
        self.iter_ += other.iter_
        self._drop_rollback_caches()

    def shuffle_models(self, start_iter: int = 0, end_iter: int = -1) -> None:
        """Shuffle the order of the iterations in [start_iter, end_iter),
        each iteration's K trees kept together (gbdt.h ShuffleModels); the
        permutation is ``RandomState(42)``'s, as the JAX package's.
        ``end_iter <= 0`` means the last iteration."""
        models = self.models
        K = self.num_tree_per_iteration
        total_iter = len(models) // K
        start_iter = max(0, start_iter)
        end = total_iter if end_iter <= 0 else min(end_iter, total_iter)
        if end - start_iter <= 1:
            return
        rng = np.random.RandomState(42)
        order = start_iter + rng.permutation(end - start_iter)
        chunk = [models[i * K:(i + 1) * K] for i in range(total_iter)]
        shuffled = chunk[:start_iter] + [chunk[i] for i in order] + chunk[end:]
        self.models = [t for c in shuffled for t in c]
        self._drop_rollback_caches()

    def set_leaf_value(self, tree_idx: int, leaf_idx: int,
                       value: float) -> None:
        """Set one leaf's output (c_api.cpp LGBM_BoosterSetLeafValue)."""
        tree = self.models[tree_idx]
        if not 0 <= leaf_idx < tree.num_leaves:
            raise IndexError("leaf index %d out of range" % leaf_idx)
        tree.leaf_value[leaf_idx] = value
        self._invalidate_predict_cache()

    def rollback_one_iter(self) -> None:
        """Undo the last iteration (gbdt.cpp:454-470): its trees leave the
        model, and the scores go back to those it started from (with the
        trees then still queued for the validation scores, which are added
        now).  Where they were not kept (DART, a fused chunk, or the first
        iteration after a restore) the last trees are taken out of the
        scores as gbdt.py:1705-1732 does, through their ``row_leaf``
        (routed over the training bins for a tree of the carried store, or
        when the arrays are gone); f32 ``(s + v) - v`` need not give back
        ``s``.  The removed trees' stall and isfinite handles go too, so a
        later poll cannot meet them."""
        self._invalidate_predict_cache()
        if self.iter_ <= 0:
            return
        K = self.num_tree_per_iteration
        cut = len(self._models) - K
        if self._pre_iter_scores is not None:
            self.train_score, valid, queue = self._pre_iter_scores
            for vs, score in zip(self.valid_sets, valid):
                vs["score"] = score
            # the last iteration's own trees never need reading back
            for idx in [i for i in self._pending if i >= cut]:
                self._pending.pop(idx)
            self._valid_queue = queue
            self._settle_valid()
        else:
            models = self.models
            for k in range(K):
                tree = models[cut + k]
                tree.shrink(-1.0)
                arrays = (self._last_iter_arrays[k]
                          if k < len(self._last_iter_arrays) else None)
                if isinstance(arrays, _PendingTree):
                    self.train_score[k] -= self._pending_output(arrays)
                elif arrays is not None:
                    self.train_score[k] -= self._gather_tree_output(arrays)
                else:
                    self._add_tree_score_train(tree, k)
                for vs in self.valid_sets:
                    self._add_tree_score_valid(tree, k, vs)
        del self._models[cut:]
        self._window = {i: r for i, r in self._window.items() if i < cut}
        self._nl_handles = [h for h in self._nl_handles if h[1] < cut]
        self.iter_ -= 1
        # the removed iteration's isfinite verdict must not raise later
        self._fin_handles = [h for h in self._fin_handles
                             if h[0] < self.iter_]
        self._pre_iter_scores = None
        self._last_iter_arrays = []

    def refit(self, leaf_preds: np.ndarray) -> None:
        """Refit every tree's leaf values on the training data, keeping the
        structure (gbdt.cpp:299 RefitTree, gbdt.py:1734): the rows routed by
        ``leaf_preds`` [num_data, num_models], each leaf's output from the
        gradient sums at the boosting state so far, blended by
        ``refit_decay_rate``; the train score rebuilt on the way."""
        self._invalidate_predict_cache()
        models = self.models
        leaf_preds = np.asarray(leaf_preds, dtype=np.int32)
        if leaf_preds.ndim != 2 or leaf_preds.shape[0] != self.num_data \
                or leaf_preds.shape[1] != len(models):
            raise ValueError(
                "leaf_preds must be [num_data, num_models] = [%d, %d]"
                % (self.num_data, len(models)))
        K = self.num_tree_per_iteration
        cfg = self.config
        l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        mds = float(cfg.max_delta_step)
        decay = float(cfg.refit_decay_rate)
        score = np.zeros((K, self.num_data), dtype=np.float64)
        if self.train_data.metadata.init_score is not None:
            score[:] = np.asarray(self.train_data.metadata.init_score,
                                  np.float64).reshape(K, self.num_data)
        for it in range(len(models) // K):
            s32 = torch.as_tensor(score.astype(np.float32),
                                  device=self.device)
            g, h = self.objective.get_gradients(s32[0] if K == 1 else s32)
            grad = g.double().cpu().numpy().reshape(K, self.num_data)
            hess = h.double().cpu().numpy().reshape(K, self.num_data)
            for k in range(K):
                i = it * K + k
                tree = models[i]
                lp = leaf_preds[:, i]
                nl = tree.num_leaves
                if lp.max(initial=0) >= nl:
                    raise ValueError("leaf prediction out of range for tree "
                                     "%d" % i)
                sum_g = np.bincount(lp, weights=grad[k], minlength=nl)
                sum_h = (np.bincount(lp, weights=hess[k], minlength=nl)
                         + K_EPSILON)
                sg = np.sign(sum_g) * np.maximum(np.abs(sum_g) - l1, 0.0)
                out = -sg / (sum_h + l2)
                if mds > 0.0:
                    out = np.clip(out, -mds, mds)
                new_vals = (decay * tree.leaf_value[:nl]
                            + (1.0 - decay) * out * tree.shrinkage)
                tree.leaf_value[:nl] = new_vals
                score[k] += new_vals[lp]
        self.train_score = torch.as_tensor(score.astype(np.float32),
                                           device=self.device)
        self._pre_iter_scores = None
        self._last_iter_arrays = []

    # ---- train state of a checkpoint (gbdt.py:1446-1615) ----

    def capture_train_state(self):
        """(meta, arrays, model string): everything later iterations read
        (``checkpoint.py``): the RNG streams, the early-stopping state, the
        f32 scores as binary arrays and CEGB's state, beside the model."""
        from ..checkpoint import dataset_fingerprint, encode_rng_state
        if self._nl_handles:
            # settle the stall poll first (gbdt.py:1455-1462): a stalled
            # trailing iteration captured here would be trimmed by the
            # uninterrupted run's next poll, and the resumed run could
            # never trim below its checkpoint
            self._poll_stop()
        model_str = self.save_model_to_string()
        meta = {
            "boosting": type(self).__name__.lower(),
            "iteration": int(self.iter_),
            "num_data": int(self.num_data),
            "dataset": (dataset_fingerprint(self.train_data)
                        if self.train_data is not None else None),
            "num_init_iteration": int(self.num_init_iteration),
            "shrinkage_rate": float(self.shrinkage_rate),
            "bag_rng": encode_rng_state(self._bag_rng),
            "feat_rng": encode_rng_state(self._feat_rng),
            "es_state": [[ds, name, float(cur), int(it)]
                         for (ds, name), (cur, it)
                         in sorted(self._es_state.items())],
            "valid_names": [vs["name"] for vs in self.valid_sets],
            "params": {k: str(v)
                       for k, v in sorted(self.config.raw_params.items())},
            "extra": self._extra_train_state(),
        }
        arrays = {"train_score": self.train_score.cpu().numpy()}
        for i, vs in enumerate(self.valid_sets):
            arrays["valid_score_%d" % i] = vs["score"].cpu().numpy()
        ln = self.learner
        if ln.cegb_used is not None:
            arrays["cegb_used"] = ln.cegb_used.cpu().numpy()
        if ln.cegb_paid is not None:
            arrays["cegb_paid"] = ln.cegb_paid.cpu().numpy()
        return meta, arrays, model_str

    def restore_train_state(self, meta, arrays, model_str) -> None:
        """Inverse of :meth:`capture_train_state`, on a booster with the
        same training data and validation sets (in the same order) already
        attached; ``train`` then goes on as the checkpointed run would
        have.  A checkpoint of the JAX package loads too: its score rows
        padded past ``num_data`` are cut (its elastic resume,
        gbdt.py:1531-1563)."""
        from ..checkpoint import (CheckpointError, dataset_fingerprint,
                                  decode_rng_state)
        want = type(self).__name__.lower()
        if meta.get("boosting") != want:
            raise CheckpointError(
                "checkpoint was written by boosting=%r, this booster is %r"
                % (meta.get("boosting"), want))
        names = list(meta.get("valid_names", []))
        have = [vs["name"] for vs in self.valid_sets]
        if names != have:
            raise CheckpointError(
                "checkpoint validation sets %r do not match the attached "
                "ones %r: attach the same valid sets in the same order "
                "before restoring" % (names, have))
        saved_fp = meta.get("dataset")
        if saved_fp is not None and self.train_data is not None:
            cur_fp = dataset_fingerprint(self.train_data)
            diff = [k for k in ("num_rows", "num_features", "bin_digest")
                    if saved_fp.get(k) != cur_fp.get(k)]
            if diff:
                raise CheckpointError(
                    "checkpoint was written against a different dataset "
                    "(%s): resume needs the same training data"
                    % ", ".join("%s: %r != %r" % (k, saved_fp.get(k),
                                                  cur_fp.get(k))
                                for k in diff))
        n = self.num_data
        ts = np.asarray(arrays["train_score"])
        K = self.train_score.shape[0]
        if ts.shape != tuple(self.train_score.shape):
            if ts.ndim == 2 and ts.shape[0] == K and ts.shape[1] >= n \
                    and int(meta.get("num_data", -1)) == n:
                ts = ts[:, :n]
            else:
                raise CheckpointError(
                    "checkpoint train_score shape %r does not match this "
                    "dataset's %r: resume needs the same training data"
                    % (ts.shape, tuple(self.train_score.shape)))
        saved_params = meta.get("params")
        if saved_params is not None:
            path_keys = {"output_model", "input_model", "output_result",
                         "config", "task"}
            cur = {k: str(v) for k, v in self.config.raw_params.items()}
            diff = sorted(k for k in set(saved_params) | set(cur)
                          if k not in path_keys
                          and saved_params.get(k) != cur.get(k))
            if diff:
                Log.warning(
                    "resuming a checkpoint whose parameters differ from the "
                    "current run (%s); the resumed model mixes both configs",
                    ", ".join("%s: %r -> %r" % (k, saved_params.get(k),
                                                cur.get(k)) for k in diff))
        self.load_model_from_string(model_str)
        # a resume is the same run going on, not an init_model
        self.iter_ = int(meta["iteration"])
        self.num_init_iteration = int(meta["num_init_iteration"])
        self.shrinkage_rate = float(meta["shrinkage_rate"])
        self._bag_rng.set_state(decode_rng_state(meta["bag_rng"]))
        self._feat_rng.set_state(decode_rng_state(meta["feat_rng"]))
        self._es_state = {(ds, name): (cur, it)
                          for ds, name, cur, it in meta.get("es_state", [])}
        dev = self.device
        self.train_score = torch.as_tensor(
            np.array(ts, dtype=np.float32), device=dev)
        for i, vs in enumerate(self.valid_sets):
            vs["score"] = torch.as_tensor(
                np.array(arrays["valid_score_%d" % i], dtype=np.float32),
                device=dev)
        self.learner.restore_cegb_state(arrays.get("cegb_used"),
                                        arrays.get("cegb_paid"))
        # the bag mask of the window in progress, regenerated by the
        # stateless hash at the window's first iteration
        cfg = self.config
        if cfg.bagging_freq > 0 and (self._balanced_bagging()
                                     or float(cfg.bagging_fraction) < 1.0):
            freq = int(cfg.bagging_freq)
            GBDT._bagging(self, self.iter_ - self.iter_ % freq)
        self._pre_iter_scores = None
        self._last_iter_arrays = []
        self._restore_extra_train_state(meta.get("extra") or {})

    def _extra_train_state(self) -> Dict:
        """Subclass state that must survive a resume (DART and RF add
        theirs)."""
        return {}

    def _restore_extra_train_state(self, extra: Dict) -> None:
        pass

    def save_checkpoint(self, prefix: str, keep: Optional[int] = None) -> str:
        """Write the train state atomically to
        ``<prefix>.ckpt_iter_<iteration>`` (``checkpoint.save_checkpoint``)."""
        from ..checkpoint import save_checkpoint
        return save_checkpoint(self, prefix, keep=keep)

    def resume_from_checkpoint(self, prefix: str) -> int:
        """Restore the newest valid checkpoint of ``prefix`` (a corrupt one
        falls back to an older one); the restored iteration, 0 when there
        is none."""
        from ..checkpoint import restore_checkpoint
        return restore_checkpoint(self, prefix)

    def warm_start_continuation(self, model_str: Optional[str] = None,
                                train_data: Optional[BinnedDataset] = None,
                                objective=None) -> int:
        """Bind this booster to continue a published model: the online
        loop's warm-start contract (gbdt.py:1637-1676 of the JAX package).

        Loads ``model_str`` when given (else keeps the loaded model),
        rebinds to ``train_data`` with the replay of every tree onto the
        training scores, and aligns the iteration clock to the ensemble:
        ``iter_`` goes on ABSOLUTE, so the stateless bagging hash (keyed by
        the iteration) gives the masks the uninterrupted run would have
        used, and ``train`` to ``k + m`` after a publish at ``k`` equals
        the checkpoint-resume path at the same boundary byte for byte.
        Returns the aligned iteration."""
        if model_str is not None:
            self.load_model_from_string(model_str)
        ds = train_data if train_data is not None else self.train_data
        if ds is None:
            raise LightGBMError("warm_start_continuation needs a training "
                                "dataset to bind the continuation to")
        self.reset_training_data(ds, objective if objective is not None
                                 else self.objective)
        self.replay_train_score()
        # align to the ENSEMBLE: a booster trained in this process and
        # rebound to a new window has num_init_iteration 0 but k trees
        self.iter_ = max(int(self.num_init_iteration),
                         len(self.models)
                         // max(self.num_tree_per_iteration, 1))
        return self.iter_

    # ---- model serialization (gbdt_model_text.cpp:271,375) ----

    def sub_model_name(self) -> str:
        return "tree"

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Splits (or summed gains) per original feature over the first
        ``num_iteration`` iterations (c_api.cpp:1573 semantics)."""
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        end = total if num_iteration <= 0 else min(total, num_iteration)
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for t in self.models[:end * K]:
            if importance_type == "split":
                for f in t.splits_by_feature():
                    out[f] += 1
            else:
                feats, gains = t.gains_by_feature()
                for f, g in zip(feats, gains):
                    out[f] += g
        return out

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        lines = [self.sub_model_name(), "version=%s" % MODEL_VERSION,
                 "num_class=%d" % self.num_class,
                 "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
                 "label_index=%d" % self.label_idx,
                 "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            lines.append("objective=%s" % self.objective.to_string())
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))
        K = self.num_tree_per_iteration
        total_iter = len(self.models) // K
        start_iteration = min(max(start_iteration, 0), total_iter)
        num_used = total_iter * K
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * K, num_used)
        start_model = start_iteration * K
        tree_strs = ["Tree=%d\n" % (i - start_model)
                     + self.models[i].to_string() + "\n"
                     for i in range(start_model, num_used)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs) + "end of trees\n"
        imps = self.feature_importance("split", num_iteration)
        pairs = sorted([(int(v), self.feature_names[i])
                        for i, v in enumerate(imps) if v > 0],
                       key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join("%s=%d\n" % (nm, v) for v, nm in pairs)
        body += "\nparameters:\n"
        for k, v in sorted(self.config.raw_params.items()):
            body += "[%s: %s]\n" % (k, v)
        body += "end of parameters\n"
        return body

    def save_model(self, filename: str, start_iteration: int = 0,
                   num_iteration: int = -1) -> None:
        atomic_write(filename,
                     self.save_model_to_string(start_iteration, num_iteration))
        Log.info("Finished writing model to file %s", filename)

    def load_model_from_string(self, text: str) -> None:
        """Parse the text model format; malformed or truncated input raises a
        ``LightGBMError`` naming the failing section."""
        if not text or not text.strip():
            raise LightGBMError("Model file is empty")
        split_at = text.find("\nTree=")
        header = text[:split_at] if split_at >= 0 else text
        rest = text[split_at + 1:] if split_at >= 0 else ""
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        if split_at >= 0 and "end of trees" not in rest:
            raise LightGBMError("Model format error: missing 'end of trees' "
                                "sentinel — the tree section is truncated")
        try:
            self.num_class = int(kv.get("num_class", 1))
            self.num_tree_per_iteration = int(
                kv.get("num_tree_per_iteration", 1))
            self.label_idx = int(kv.get("label_index", 0))
            self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        except ValueError as exc:
            raise LightGBMError("Model format error: unparseable header "
                                "field (%s)" % exc)
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        self.average_output = "average_output" in header.splitlines()
        if "objective" in kv and self.objective is None:
            if self.num_class > 1:
                self.config.num_class = self.num_class
            self.objective = create_objective(kv["objective"].split()[0],
                                              self.config, self.device)
        models = []
        if rest:
            for block in rest.split("end of trees")[0].split("Tree="):
                block = block.strip()
                if not block:
                    continue
                block = block.split("\n", 1)[1] if "\n" in block else ""
                if block.strip():
                    try:
                        models.append(Tree.from_string(block))
                    except (LightGBMError, ValueError, IndexError,
                            KeyError) as exc:
                        raise LightGBMError(
                            "Model format error: Tree=%d is malformed (%s)"
                            % (len(models), exc))
        declared = kv.get("tree_sizes", "").split()
        if declared and len(declared) != len(models):
            raise LightGBMError(
                "Model format error: tree_sizes declares %d trees but %d "
                "were parsed — the tree section is truncated"
                % (len(declared), len(models)))
        K = max(self.num_tree_per_iteration, 1)
        if len(models) % K != 0:
            raise LightGBMError(
                "Model format error: %d trees is not a multiple of "
                "num_tree_per_iteration=%d — the tree section is truncated"
                % (len(models), K))
        self.models = models
        self._invalidate_predict_cache()
        self.num_init_iteration = len(models) // K
        self.iter_ = 0

    @classmethod
    def load_model(cls, filename: str, config: Optional[Config] = None,
                   device: DeviceLike = None) -> "GBDT":
        """A booster holding the model of the text file ``filename``
        (gbdt.py:2506), on ``device``."""
        with open(filename) as fh:
            text = fh.read()
        booster = cls(config or Config(), device=device)
        booster.load_model_from_string(text)
        return booster
