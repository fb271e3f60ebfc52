"""Boosting factory: the counterpart of ``lightgbm_tpu/boosting/__init__.py``
(src/boosting/boosting.cpp:35-68)."""
from __future__ import annotations

from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF
from ..utils.log import Log


def create_boosting(boosting_type: str, config, dataset=None, objective=None,
                    device=None, group=None) -> GBDT:
    """The booster of ``boosting_type`` (gbdt, dart, goss or rf; the config
    has resolved the aliases) on ``device``; ``group`` is a parallel
    learner's process group (``GBDT``)."""
    table = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}
    cls = table.get(boosting_type)
    if cls is None:
        Log.fatal("Unknown boosting type %s", boosting_type)
    return cls(config, dataset, objective, device=device, group=group)


__all__ = ["GBDT", "DART", "GOSS", "RF", "create_boosting"]
