# Copy of repro/core/health.py; the port imports nothing of repro.
"""Per-table circuit breakers: closed -> open -> half_open -> quarantined.

The daemon's exponential backoff already spaces out retries of a failing
table, but it never *gives up*: a permanently poisoned table (corrupt log,
revoked credentials, deleted bucket) keeps consuming a probe + a failed
drain every time its window reopens, forever, and holds ``stop(drain=True)``
hostage.  This module adds the classic breaker on top:

* **closed** — healthy; every failure increments a consecutive counter and
  ``failure_threshold`` of them open the breaker.
* **open** — the table is skipped outright (not even probed) until
  ``open_cooldown_s`` passes, then one **half_open** trial is admitted.
* **half_open** — ``half_open_probes`` consecutive successes close the
  breaker (full reset); any failure re-opens it immediately.
* **quarantined** — ``quarantine_after`` consecutive opens without a
  recovery park the table until the (much longer) ``quarantine_cooldown_s``;
  quarantined tables are excluded from drain-stop pending checks so one
  dead table cannot keep the daemon alive.

State transitions are pure functions of the injected clock and the
success/failure record stream — deterministic under ``ManualClock``.  The
tracker snapshots/restores through the daemon checkpoint so a restarted
fleet does not hammer a table that was quarantined before the crash.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from repro_torch.core.config import HealthOptions

__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "QUARANTINED", "TableHealth",
           "HealthTracker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
QUARANTINED = "quarantined"

# admit() verdicts
ALLOW = "allow"
COOLING = "cooling"         # open/quarantined, cooldown still running
PARKED = "parked"           # quarantined (distinct so reports can tell)


@dataclass
class TableHealth:
    """One table's breaker state (all times are injected-clock seconds)."""
    state: str = CLOSED
    consecutive_failures: int = 0
    opens: int = 0              # consecutive opens without a full close
    half_open_successes: int = 0
    retry_at: float = 0.0       # when an open/quarantined table may retry
    total_failures: int = 0     # lifetime counters (telemetry/report)
    total_opens: int = 0

    def as_dict(self) -> dict:
        return {"state": self.state,
                "consecutiveFailures": self.consecutive_failures,
                "opens": self.opens,
                "halfOpenSuccesses": self.half_open_successes,
                "retryAt": self.retry_at,
                "totalFailures": self.total_failures,
                "totalOpens": self.total_opens}

    @staticmethod
    def from_dict(d: dict) -> "TableHealth":
        return TableHealth(
            state=str(d.get("state", CLOSED)),
            consecutive_failures=int(d.get("consecutiveFailures", 0)),
            opens=int(d.get("opens", 0)),
            half_open_successes=int(d.get("halfOpenSuccesses", 0)),
            retry_at=float(d.get("retryAt", 0.0)),
            total_failures=int(d.get("totalFailures", 0)),
            total_opens=int(d.get("totalOpens", 0)))


class HealthTracker:
    """Breaker state for every table the daemon watches (thread-safe)."""

    def __init__(self, opts: HealthOptions | None = None):
        self.opts = opts or HealthOptions()
        self._lock = threading.Lock()
        self._tables: dict[str, TableHealth] = {}

    def _get(self, key: str) -> TableHealth:
        h = self._tables.get(key)
        if h is None:
            h = self._tables[key] = TableHealth()
        return h

    # ------------------------------------------------------------ gate
    def admit(self, key: str, now: float) -> str:
        """May this table take a cycle?  ``ALLOW`` | ``COOLING`` |
        ``PARKED``.  An elapsed cooldown flips open/quarantined to
        half_open and admits the trial."""
        with self._lock:
            h = self._get(key)
            if h.state in (OPEN, QUARANTINED):
                if now >= h.retry_at:
                    h.state = HALF_OPEN
                    h.half_open_successes = 0
                    return ALLOW
                return PARKED if h.state == QUARANTINED else COOLING
            return ALLOW

    # ------------------------------------------------------- record stream
    def record_success(self, key: str) -> None:
        with self._lock:
            h = self._get(key)
            h.consecutive_failures = 0
            if h.state == HALF_OPEN:
                h.half_open_successes += 1
                if h.half_open_successes >= self.opts.half_open_probes:
                    h.state = CLOSED
                    h.opens = 0
            elif h.state == CLOSED:
                h.opens = 0

    def record_failure(self, key: str, now: float) -> None:
        with self._lock:
            h = self._get(key)
            h.consecutive_failures += 1
            h.total_failures += 1
            trip = (h.state == HALF_OPEN or
                    (h.state == CLOSED and h.consecutive_failures >=
                     self.opts.failure_threshold))
            if not trip:
                return
            h.opens += 1
            h.total_opens += 1
            h.consecutive_failures = 0
            if h.opens >= self.opts.quarantine_after:
                h.state = QUARANTINED
                h.retry_at = now + self.opts.quarantine_cooldown_ms / 1000.0
            else:
                h.state = OPEN
                h.retry_at = now + self.opts.open_cooldown_ms / 1000.0

    # ------------------------------------------------------------- queries
    def state(self, key: str) -> str:
        with self._lock:
            h = self._tables.get(key)
            return h.state if h is not None else CLOSED

    def is_quarantined(self, key: str) -> bool:
        return self.state(key) == QUARANTINED

    def states(self) -> dict[str, str]:
        """(table path) -> breaker state, for reports/monitoring (only
        tables that ever left ``closed`` or recorded a failure appear)."""
        with self._lock:
            return {k: h.state for k, h in self._tables.items()
                    if h.state != CLOSED or h.total_failures}

    # -------------------------------------------------------- checkpointing
    def snapshot(self) -> dict:
        with self._lock:
            return {k: h.as_dict() for k, h in self._tables.items()}

    def restore(self, payload: dict) -> None:
        """Install checkpointed breaker states for tables not yet seen
        (live observations made since startup win over the checkpoint)."""
        with self._lock:
            for k, d in (payload or {}).items():
                self._tables.setdefault(k, TableHealth.from_dict(d))
