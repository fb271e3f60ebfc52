"""Online learning: one process that trains while it serves.

The counterpart of ``lightgbm_tpu/online/__init__.py`` (:1-40).  The
serving tier (``serving``) publishes models, the training runtime
(boosting, checkpoints, resilience) produces them and the quality plane
(``obs/quality.py``) says when the live one has drifted; this package
composes the three:

- :class:`~.buffer.RowBuffer`: a bounded host buffer of fresh labeled rows
  with the ingested-vs-trained counters behind the ``rows_behind`` gauge;
- :class:`~.policy.RetrainPolicy`: when to cut the next generation
  (cadence, drift, the freshness SLO);
- :class:`~.controller.OnlineController`: the trainer loop that bins each
  window against the live layout, extends the ensemble through the
  warm-start continuation (``GBDT.warm_start_continuation``) or refits its
  leaf values, and republishes each generation through
  ``ModelRegistry.swap``.

Entry points: ``lightgbm_tpu_torch.serve_and_train(...)`` and the CLI's
``task=online``.
"""
from .buffer import RowBuffer
from .controller import OnlineController
from .policy import RetrainPolicy

__all__ = ["RowBuffer", "RetrainPolicy", "OnlineController"]
