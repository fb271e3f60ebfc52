"""Retrain trigger policies for the online controller.

The counterpart of ``lightgbm_tpu/online/policy.py`` (:1-95), the same
triggers and precedence.

Three trigger families, all declared through ``online_*`` params and all
requiring at least one fresh row (retraining on an unchanged window is a
no-op the loop must not spin on):

- **cadence** — ``online_min_rows`` (fire when that many fresh rows
  accumulated) and/or ``online_interval_s`` (fire every T seconds while
  fresh rows exist);
- **drift** — ``online_drift_trigger``: fire when the quality plane's
  per-model drift level reads ``"alert"`` (the
  ``snapshot()["models"][name]["level"]`` hook the quality plane
  documented as the refit trigger), guarded by a minimum observed-row
  count so a noisy first batch cannot thrash the trainer;
- **freshness SLO** — ``online_max_rows_behind`` /
  ``online_max_seconds_behind``: hard caps on how stale the live generation may get regardless of
  cadence.

``reason()`` returns the most actionable trigger name (drift beats
freshness beats cadence) or None; the controller records it as the
cycle's provenance (``online_trigger_<reason>`` counters, ``trigger=``
field on the ``online_cycle`` event).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

# the drift trigger only honors an alert backed by at least this many
# observed rows — PSI noise scales like (groups-1)/rows, and a one-batch
# alert would retrain on noise
DRIFT_MIN_ROWS = 256


class RetrainPolicy:
    """Declarative trigger set; stateless between calls except the clock
    the caller passes in."""

    def __init__(self, min_rows: int = 0, interval_s: float = 0.0,
                 drift_trigger: bool = True,
                 max_rows_behind: int = 0,
                 max_seconds_behind: float = 0.0,
                 drift_min_rows: int = DRIFT_MIN_ROWS) -> None:
        self.min_rows = max(int(min_rows), 0)
        self.interval_s = max(float(interval_s), 0.0)
        self.drift_trigger = bool(drift_trigger)
        self.max_rows_behind = max(int(max_rows_behind), 0)
        self.max_seconds_behind = max(float(max_seconds_behind), 0.0)
        self.drift_min_rows = max(int(drift_min_rows), 1)

    def active(self) -> bool:
        """Whether ANY trigger can ever fire."""
        return bool(self.min_rows or self.interval_s or self.drift_trigger
                    or self.max_rows_behind or self.max_seconds_behind)

    def drift_alert(self, quality_entry: Optional[Dict[str, Any]]) -> bool:
        """The quality plane's hook: the model's current-generation drift level
        reads "alert", with enough observed rows behind it to be signal."""
        if not self.drift_trigger or not quality_entry:
            return False
        return (quality_entry.get("level") == "alert"
                and int(quality_entry.get("rows") or 0)
                >= self.drift_min_rows)

    def reason(self, rows_behind: int, last_publish_ts: float,
               quality_entry: Optional[Dict[str, Any]] = None,
               now: Optional[float] = None) -> Optional[str]:
        """The trigger that should fire now, or None.  Every trigger
        requires fresh rows: a generation retrained on its own window is
        the same generation."""
        if rows_behind <= 0:
            return None
        now = time.time() if now is None else now
        if self.drift_alert(quality_entry):
            return "drift"
        if self.max_rows_behind and rows_behind >= self.max_rows_behind:
            return "freshness_rows"
        if self.max_seconds_behind \
                and now - last_publish_ts >= self.max_seconds_behind:
            return "freshness_seconds"
        if self.min_rows and rows_behind >= self.min_rows:
            return "rows"
        if self.interval_s and now - last_publish_ts >= self.interval_s:
            return "interval"
        return None

    @classmethod
    def from_config(cls, cfg) -> "RetrainPolicy":
        return cls(
            min_rows=int(getattr(cfg, "online_min_rows", 4096)),
            interval_s=float(getattr(cfg, "online_interval_s", 0.0)),
            drift_trigger=bool(getattr(cfg, "online_drift_trigger", True)),
            max_rows_behind=int(getattr(cfg, "online_max_rows_behind", 0)),
            max_seconds_behind=float(
                getattr(cfg, "online_max_seconds_behind", 0.0)))
