"""The serving tier: continuous batching, multi-model residency, hot swap and
the single-row fast path, on the card.

The counterpart of ``lightgbm_tpu/serving/__init__.py`` (:1-32):

- :class:`~.scheduler.Server`: a dispatcher thread coalesces single rows and
  micro-batches under ``max_batch_wait_us`` into the rungs of
  ``PREDICT_BUCKETS`` and completes one future per request (per-request
  ``num_iteration``/``pred_early_stop``/``raw_score``/``pred_contrib``/
  ``precision``, raw or binned rows, and the single-row bypass through
  ``model_codegen.compile_single_row``);
- :class:`~.registry.ModelRegistry`: many boosters resident under a
  ``serve_residency_budget_mb`` budget, LRU eviction, refcounted in-flight
  protection, transparent re-admission and atomic ``swap``;
- the serving block of the telemetry summary (``obs``): per-model latency,
  occupancy and queue depth, eviction/swap/re-admission counts, with zero
  telemetry calls when no run is active.

Entry points: ``lightgbm_tpu_torch.serve(...)``, ``Booster.serve()`` and
CLI ``task=serve``; the train-while-serve loop (``online``:
``serve_and_train``, ``task=online``) republishes through ``swap``.
"""
from .registry import ModelRegistry, ResidentModel
from .scheduler import Server, ServingClosed, ServingQueueFull

__all__ = ["Server", "ModelRegistry", "ResidentModel", "ServingQueueFull",
           "ServingClosed"]
