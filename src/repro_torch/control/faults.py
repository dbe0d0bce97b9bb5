"""Deterministic fault model for multi-instance serving — the port's own
copy of ``repro.control.faults`` (framework-free, so it is copied, not
imported; the draws are the reference's bit for bit).

Three pieces, shared by the control plane and the port's
step-synchronous server:

  * :class:`FaultSpec` — a frozen, seeded description of what goes wrong
    in a run: scripted instance crashes/rejoins, per-transfer loss/stall
    probabilities, per-instance slowdown factors. Time points are in the
    caller's clock (server steps); the spec itself is clock-free data.
  * :class:`FaultInjector` — turns the spec into concrete decisions.
    Per-transfer outcomes are keyed by ``hash(seed, req_id, attempt)``,
    not by a sequential RNG draw, so the k-th transfer attempt of request
    r gets the same fate in every backend that starts the same transfers.
  * :class:`BackoffPolicy` — the capped exponential retry schedule the
    control plane applies to failed migrations (receiver refusal, wire
    timeout, receiver death), in pump rounds; after ``max_retries``
    failures the request completes on its source.

The server's crash, redispatch, rejoin and lost-transfer paths
(``repro_torch.serving.server``) drive it; a dead engine's residents
replay through the engine's recompute-resume machinery.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

# Instance health (plane-side liveness tracking; DESIGN.md §Fault
# tolerance). alive -> suspect after ``suspect_after`` heartbeat-free
# time units, suspect -> dead after ``dead_after``; any heartbeat
# restores alive (dead -> alive is a rejoin).
HEALTH_ALIVE = "alive"
HEALTH_SUSPECT = "suspect"
HEALTH_DEAD = "dead"

# FaultInjector per-transfer outcomes
XFER_OK = "ok"
XFER_LOST = "lost"       # never delivers; discovered by the deadline
XFER_STALL = "stall"     # delivers late; the deadline usually fires first


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential backoff for failed migration attempts.

    ``delay(n)`` is how many pump rounds to wait after the n-th failure
    (1-based): base, base*mult, ... capped at ``cap``. After
    ``max_retries`` failures the request is banned from migrating for
    the rest of its life — the strict no-spin bound the regression test
    asserts (total attempts <= max_retries + 1)."""
    max_retries: int = 6
    base: float = 1.0
    multiplier: float = 2.0
    cap: float = 32.0

    def delay(self, fails: int) -> float:
        return min(self.base * self.multiplier ** max(fails - 1, 0),
                   self.cap)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded description of a chaos run (clock-free data; times are in
    the caller's own units — sim seconds or server steps)."""
    seed: int = 0
    # scripted instance deaths/revivals: ((instance_id, at_time), ...)
    crashes: Tuple[Tuple[int, float], ...] = ()
    rejoins: Tuple[Tuple[int, float], ...] = ()
    # correlated (rack-style) failures: ((instance_ids...), at_time) kills
    # every listed instance in the SAME tick — power/switch domains where
    # deaths are not independent. Expanded into per-instance crashes by
    # ``all_crashes``; callers iterate that, never ``crashes`` directly.
    racks: Tuple[Tuple[Tuple[int, ...], float], ...] = ()
    # per-transfer-attempt wire faults
    transfer_loss_p: float = 0.0
    transfer_stall_p: float = 0.0
    # slow-instance degradation: ((instance_id, slowdown_factor >= 1), ...)
    slowdowns: Tuple[Tuple[int, float], ...] = ()

    @property
    def all_crashes(self) -> Tuple[Tuple[int, float], ...]:
        """Per-instance crash schedule with rack events expanded:
        independent ``crashes`` first, then each rack's members in listed
        order (callers that push events in sequence keep a deterministic
        same-tick order)."""
        out = list(self.crashes)
        for ids, t in self.racks:
            out.extend((int(i), float(t)) for i in ids)
        return tuple(out)


def _unit_hash(*vals) -> float:
    """Deterministic uniform [0, 1) from a tuple of values — sha256, not
    Python's randomized ``hash``, so sim and server (and re-runs) agree."""
    h = hashlib.sha256("|".join(str(v) for v in vals).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultInjector:
    """Concrete fault decisions for one run of one backend.

    Both backends construct their own injector from the SAME spec; the
    counter-free hashing keying per-transfer outcomes on (req_id,
    attempt#) makes their decisions identical as long as their transfer
    sequences match — which decision-log parity guarantees."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._attempts: Dict[int, int] = {}     # req_id -> transfers started

    def crash_time(self, instance_id: int) -> Optional[float]:
        for iid, t in self.spec.all_crashes:
            if iid == instance_id:
                return float(t)
        return None

    def rejoin_time(self, instance_id: int) -> Optional[float]:
        for iid, t in self.spec.rejoins:
            if iid == instance_id:
                return float(t)
        return None

    def slowdown(self, instance_id: int) -> float:
        for iid, f in self.spec.slowdowns:
            if iid == instance_id:
                return max(float(f), 1.0)
        return 1.0

    def transfer_event(self, req_id: int) -> str:
        """Fate of request ``req_id``'s next transfer attempt:
        XFER_OK | XFER_LOST | XFER_STALL. Increments the per-request
        attempt counter, so retries re-draw (a lost first attempt does
        not doom every retry unless loss_p == 1)."""
        k = self._attempts.get(req_id, 0)
        self._attempts[req_id] = k + 1
        loss = self.spec.transfer_loss_p
        stall = self.spec.transfer_stall_p
        if loss <= 0.0 and stall <= 0.0:
            return XFER_OK
        u = _unit_hash(self.spec.seed, "xfer", req_id, k)
        if u < loss:
            return XFER_LOST
        if u < loss + stall:
            return XFER_STALL
        return XFER_OK
