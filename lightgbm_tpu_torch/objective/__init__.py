"""Objective factory (src/objective/objective_function.cpp:16-52); the port
has the binary objective so far."""
from __future__ import annotations

from ..device import DeviceLike
from .base import ObjectiveFunction
from .binary import BinaryLogloss

_OBJECTIVES = {"binary": BinaryLogloss}


def create_objective(name: str, config,
                     device: DeviceLike = None) -> ObjectiveFunction | None:
    if name == "custom":
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        raise NotImplementedError(
            "objective %r is not ported to lightgbm_tpu_torch yet (ROADMAP "
            "queue 1 item 9); ported: %s" % (name, ", ".join(_OBJECTIVES)))
    return cls(config, device)


__all__ = ["ObjectiveFunction", "BinaryLogloss", "create_objective"]
