"""The part of ``repro.control.faults`` the control plane imports: the
health vocabulary and the capped backoff of failed migrations.

The seeded chaos harness (``FaultSpec``/``FaultInjector``) and the
server's crash/rejoin paths are not ported yet: their recovery replays
requests through the resume machinery of preemption.
"""
from __future__ import annotations

import dataclasses

# Instance health (plane-side liveness tracking). alive -> suspect after
# ``suspect_after`` heartbeat-free time units, suspect -> dead after
# ``dead_after``; any heartbeat restores alive (dead -> alive is a rejoin).
HEALTH_ALIVE = "alive"
HEALTH_SUSPECT = "suspect"
HEALTH_DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential backoff for failed migration attempts.

    ``delay(n)`` is how many pump rounds to wait after the n-th failure
    (1-based): base, base*mult, ... capped at ``cap``. After
    ``max_retries`` failures the request is banned from migrating for
    the rest of its life (total attempts <= max_retries + 1)."""
    max_retries: int = 6
    base: float = 1.0
    multiplier: float = 2.0
    cap: float = 32.0

    def delay(self, fails: int) -> float:
        return min(self.base * self.multiplier ** max(fails - 1, 0),
                   self.cap)
