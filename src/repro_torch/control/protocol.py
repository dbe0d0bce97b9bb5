"""The port's copy of ``repro.control.protocol``, whole (framework-free).

The control-plane ↔ backend contract.

The :class:`~repro_torch.control.plane.ControlPlane` makes every scheduling
*decision* (where an arrival goes, which request migrates where, where a
stage boundary sits); the backend owns every *mechanism* (queues, KV
movement, clocks). The split is deliberately timing-free: the core never
sleeps, schedules, or measures time — drivers call into it when their
notion of time advances (a discrete event, a synchronous step) and
execute its callbacks with whatever latency their world has.

Backends supply one :class:`InstanceView` per serving instance and one
:class:`ClusterOps` for cluster-wide actions. Request objects are opaque
to the core: it only sees :class:`ReqView` snapshots the backend builds
(identity + lengths) and hands the ``ref`` back unchanged in callbacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Protocol, Tuple, runtime_checkable

# ``ClusterOps.start_migration`` outcomes
MIG_STARTED = "started"      # async transfer in flight; backend will call
                             # ControlPlane.migration_finished(req_id) later
MIG_COMPLETED = "completed"  # synchronous transfer already landed
MIG_FAILED = "failed"        # backend refused (e.g. admission re-check);
                             # the core rolls the negotiation state back


@dataclasses.dataclass(frozen=True)
class ReqView:
    """Point-in-time snapshot of a live request, built by the backend.

    ``ref`` is the backend's own request object — the core treats it as
    an opaque token and passes it back through ``ClusterOps`` calls.

    Prefill progress (chunked-prefill backends): ``ctx_done`` prompt
    tokens are written to cache out of ``ctx_total``. Backends without
    chunked prefill report ``ctx_done == ctx_total`` (the 0/0 default
    also reads as done). A not-yet-done request is live and migratable —
    its KV piece is the ``ctx_done`` written rows, and the receiver
    resumes chunking.
    """
    ref: Any
    req_id: int
    input_len: float
    length: float               # current sequence length
    ctx_done: float = 0.0       # prompt tokens whose KV is written
    ctx_total: float = 0.0      # prompt tokens overall
    # prompt tokens served from the backend's prefix cache (block-aligned,
    # <= ctx_done). Effective — uncached — lengths drive stage routing and
    # queue accounting; migration reservations still use true length,
    # because a migrated shared prefix re-imports as private.
    cached_tokens: float = 0.0
    # SLO service class (repro_torch.sched.slo.SLO_CLASSES). Routing prefers
    # least-queued instances for interactive arrivals, and bid-ask victim
    # selection / receiver queues order by class priority so interactive
    # work is never parked behind batch transfers.
    slo_class: str = "standard"

    @property
    def prefill_done(self) -> bool:
        return self.ctx_done >= self.ctx_total


@runtime_checkable
class InstanceView(Protocol):
    """Read-only window onto one serving instance."""

    id: int

    def load(self) -> float:
        """Scheduling pressure: pinned KV tokens + queued prompt tokens."""
        ...

    def free_tokens(self) -> float:
        """Unpinned KV budget (block-granular where the backend is)."""
        ...

    def used_tokens(self) -> float:
        """KV tokens pinned by running requests."""
        ...

    def queued_tokens(self) -> float:
        """UN-PREFILLED, UNCACHED prompt tokens: whole waiting prompts
        (minus their prefix-cache hit) plus the unwritten remainder of
        requests mid-chunked-prefill. The written part of a partial
        prompt is pinned cache and belongs to ``used_tokens`` — the two
        never count a token twice."""
        ...

    def prefix_digests(self) -> frozenset:
        """Compact advertisement of the instance's prefix cache: the head
        digest (first full block) of every cached chain. Within-stage
        dispatch tie-breaks toward instances advertising an arrival's
        digest; backends without a prefix cache return an empty set."""
        ...

    def requests(self) -> List[ReqView]:
        """Live, migratable requests (backends exclude ones already in a
        backend-level transfer)."""
        ...

    def request_view(self) -> List[Tuple[float, float]]:
        """(input_len, current_len) pairs for boundary refinement."""
        ...

    def has_request(self, ref: Any) -> bool:
        """Is ``ref`` still resident (running, unfinished) here?"""
        ...

    def can_accept(self, ref: Any) -> bool:
        """Admission/flow-control gate: could this instance adopt ``ref``
        right now (slot + memory headroom)? §5: migrations that fail this
        stay on the source."""
        ...

    def all_requests(self) -> List[ReqView]:
        """EVERY resident request — running, waiting, parked — regardless
        of migratability. Dead-instance recovery enumerates these (a
        queued request dies with its instance just as surely as a running
        one). Optional: the core falls back to :meth:`requests` on views
        that predate fault tolerance."""
        ...

    # Optional (resolved via getattr, like the fault-tolerance hooks):
    #
    #   def tiered_digests(self) -> Dict[int, str]
    #
    # Tier-tagged form of :meth:`prefix_digests` for multi-tier KV
    # backends (DESIGN.md §Multi-tier KV): head digest -> "device" |
    # "host". Routing's warm filter prefers device-warm instances (hit
    # is free) over host-warm ones (hit pays a promote price). Views
    # without the hook are treated as all-device, preserving legacy
    # warm-routing bit-for-bit.
    #
    #   def capacity_weight(self) -> float
    #
    # Relative capacity of this instance in homogeneous instance-units
    # (DESIGN.md §Sharded serving): a tp=N tensor-parallel engine returns
    # N — its KV pool is N× deeper and its iteration throughput higher.
    # The control plane divides every load/queue comparison by it and
    # lets one instance satisfy N units of a stage's instance demand.
    # Views without the hook weigh 1.0, preserving legacy behavior
    # bit-for-bit.


@runtime_checkable
class ClusterOps(Protocol):
    """Actions the control plane asks the backend to perform."""

    def dispatch(self, ref: Any, instance_id: int) -> None:
        """Place a new arrival on an instance (routing decision made)."""
        ...

    def start_migration(self, ref: Any, src_id: int, dst_id: int) -> str:
        """Move ``ref``'s KV from ``src_id`` to ``dst_id``. Returns one of
        MIG_STARTED (async; report completion via
        ``ControlPlane.migration_finished``), MIG_COMPLETED (done
        synchronously) or MIG_FAILED (refused; core rolls back)."""
        ...

    def set_boundary(self, stage_idx: int, hi: float) -> None:
        """Observe a refined stage boundary (stage ``stage_idx`` now ends
        at ``hi``). The core owns the authoritative bounds; this hook is
        for backend-side mirrors/telemetry."""
        ...

    # ---- fault tolerance (DESIGN.md §Fault tolerance) --------------------
    # The three hooks below are OPTIONAL: the core resolves them via
    # getattr, and backends that predate fault tolerance simply lose the
    # recovery behaviors (requests on a dead instance are reported failed
    # instead of re-dispatched).

    def redispatch(self, ref: Any, instance_id: int) -> bool:
        """Re-place a request recovered from a dead instance: its KV is
        gone, so the backend must rebuild state by replaying
        ``prompt + generated-so-far`` through (chunked) prefill on
        ``instance_id`` — the same drop-and-recompute machinery
        preemption uses, so the continuation stays bit-identical.
        Returns False when the target cannot replay (e.g. no chunked
        prefill for a mid-decode resume); the core then fails the
        request."""
        ...

    def fail_request(self, ref: Any) -> None:
        """Mark a request permanently failed (retry budget exhausted or
        no healthy replay target): the backend must surface it as
        ``failed`` in its accounting and release any bookkeeping so
        drain loops terminate — a failed request must never hang the
        run."""
        ...

    def instance_down(self, instance_id: int) -> None:
        """The core declared this instance dead. The backend clears the
        carcass (queues, reservations, transfer state) so a later rejoin
        starts from an empty instance. Called after the core snapshots
        the residents it will re-dispatch."""
        ...
