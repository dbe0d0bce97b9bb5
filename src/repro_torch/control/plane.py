"""The port's copy of ``repro.control.plane``, whole: the paper's
decision core is framework-free, and the parity tests hold the port's
decision log to the reference's.

The CascadeInfer scheduling core (paper §3–§5), backend-agnostic.

One `ControlPlane` owns every *decision* the paper's control plane makes:

  * length routing — arrivals go round-robin within the earliest covering
    stage (§3.2; bid-ask governs migrations, not dispatch);
  * growth-triggered inter-stage handover with sender/receiver bid-ask
    negotiation, priority pull loop and starvation backpressure (§4.4);
  * intra-stage rebalancing of overloaded instances (§4.4);
  * boundary refinement — adaptive (§4.3) plus the quantity/memory
    ablations of Fig. 15, with monotone-boundary clipping;
  * §5 flow control — a migration starts only if the receiver can admit
    the request *now*, the source is under its concurrency cap, and (for
    step-synchronous drivers) the per-tick budget allows it; otherwise
    the request stays on the source and is retried.

The core holds no clock and performs no I/O: drivers feed it events
(`submit`, `on_instance_iteration`, timer-driven `balance`/`refine`/
`pump_all`, `migration_finished`) and it calls back through `ClusterOps`
(`dispatch`, `start_migration`, `set_boundary`). The discrete-event
simulator and the real multi-engine server are two such drivers —
they execute identical policy code, so sim-validated behavior carries to
the prototype unchanged (cf. Helix's sim-first methodology).

Every decision is appended to ``decisions`` — the parity tests diff these
logs across drivers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control.bidask import (Bid, MigRequest, ReceiverState,
                                        SenderState, is_overloaded,
                                        select_receiver)
from repro_torch.control.faults import (HEALTH_ALIVE, HEALTH_DEAD,
                                        HEALTH_SUSPECT, BackoffPolicy)
from repro_torch.control.protocol import (MIG_COMPLETED, MIG_FAILED,
                                          MIG_STARTED, ClusterOps,
                                          InstanceView, ReqView)
from repro_torch.control.refinement import (BoundaryRefiner,
                                            memory_based_split,
                                            quantity_based_split)
from repro_torch.core.partition import PipelinePlan
from repro_torch.sched.slo import priority_of

POLICIES = ("cascade", "round-robin", "least-loaded")
REFINEMENTS = ("adaptive", "quantity", "memory", "none")   # Fig. 15
BALANCINGS = ("full", "inter-stage", "rr")                 # Fig. 16

_RR_GLOBAL = -2      # round-robin-policy arrival counter
_RR_HANDOVER = -1    # balancing="rr" handover counter


@dataclasses.dataclass
class ControlConfig:
    policy: str = "cascade"
    refinement: str = "adaptive"
    balancing: str = "full"
    # §5 concurrency control: per-source transfers are serialized by the
    # §4.4 sender state machine (at most one outbound in flight); step-
    # synchronous drivers additionally bound moves per tick (begin_tick()).
    max_migrations_per_tick: int = 0     # 0 = uncapped (async drivers)
    seed: int = 0
    # ---- fault tolerance (DESIGN.md §Fault tolerance) ----
    # liveness thresholds, in the DRIVER's clock (the units it passes to
    # heartbeat/check_liveness: sim seconds, server steps). An instance
    # with no heartbeat for suspect_after units stops receiving new work;
    # after dead_after it is declared dead and its residents recovered.
    suspect_after: float = 3.0
    dead_after: float = 6.0
    # retry schedule for failed migrations (receiver refusal, transfer
    # timeout, receiver death) — measured in pump rounds
    mig_backoff: BackoffPolicy = BackoffPolicy()
    # how many times a request may be re-dispatched off dead instances
    # before it is surfaced as failed instead of retried again
    redispatch_budget: int = 2


@dataclasses.dataclass
class StageState:
    lo: float
    hi: float
    instance_ids: List[int]


class ControlPlane:
    def __init__(self, plan: PipelinePlan, qoe, cfg: ControlConfig,
                 ops: ClusterOps, instances: Sequence[InstanceView]):
        assert cfg.policy in POLICIES, cfg.policy
        assert cfg.refinement in REFINEMENTS, cfg.refinement
        assert cfg.balancing in BALANCINGS, cfg.balancing
        self.cfg = cfg
        self.ops = ops
        self.plan = plan
        self.qoe = qoe
        self.rng = np.random.default_rng(cfg.seed)
        self.instances: Dict[int, InstanceView] = {v.id: v for v in instances}
        self._order = [v.id for v in instances]
        # stage assignment: the plan's stages claim instances in order.
        # Claiming is CAPACITY-WEIGHTED (DESIGN.md §Sharded serving): a
        # tp=N engine advertises capacity_weight N and satisfies N units
        # of a stage's num_instances demand, so a plan solved in
        # homogeneous instance-units maps onto a heterogeneous cluster
        # without re-solving the DP. Uniform weight 1 claims exactly one
        # instance per unit — bit-identical to the legacy slicing — and
        # on weighted clusters the last stage absorbs any remainder.
        weights = {i: self._weight(i) for i in self._order}
        uniform = all(w == 1.0 for w in weights.values())
        self.stages: List[StageState] = []
        self.stage_of_instance: Dict[int, int] = {}
        nxt = 0
        for si, st in enumerate(plan.stages):
            if si == len(plan.stages) - 1 and not uniform:
                ids = self._order[nxt:]
                nxt = len(self._order)
            else:
                ids = []
                acc = 0.0
                while nxt < len(self._order) and acc < st.num_instances:
                    ids.append(self._order[nxt])
                    acc += weights[self._order[nxt]]
                    nxt += 1
            self.stages.append(StageState(st.lo, st.hi, ids))
            for i in ids:
                self.stage_of_instance[i] = si
        if uniform:
            need = sum(st.num_instances for st in plan.stages)
            assert need == len(self._order), \
                f"plan uses {need} instances, backend has {len(self._order)}"
        self.refiners = [BoundaryRefiner(qoe, boundary=s.hi)
                         for s in self.stages[:-1]]
        # negotiation state (§4.4)
        self.senders = {i: SenderState(i) for i in self._order}
        self.receivers = {i: ReceiverState(i) for i in self._order}
        self._pending: Dict[int, Tuple[Any, int]] = {}   # req_id -> (ref, src)
        self._dst_of: Dict[int, int] = {}                # in-flight transfers
        self._rr: Dict[int, int] = {}
        self._tick_started = 0
        # ---- fault tolerance (DESIGN.md §Fault tolerance) ----
        # liveness: driver-clock heartbeats; everything starts alive
        self.health: Dict[int, str] = {i: HEALTH_ALIVE for i in self._order}
        self.last_seen: Dict[int, float] = {}
        # migration backoff: pump rounds are the plane's retry clock
        # (pump_all() advances it — every driver already calls that
        # periodically), so legacy drivers that never heartbeat still get
        # working retries
        self._round = 0
        self._mig_fails: Dict[int, int] = {}         # req_id -> failures
        self._mig_not_before: Dict[int, float] = {}  # req_id -> round
        self._mig_banned: set = set()                # gave up migrating
        self._redispatch_count: Dict[int, int] = {}
        # telemetry
        self.migrations = 0
        self.migrations_by_stage: Dict[Tuple[int, int], int] = {}
        self.retries = 0          # failed migration attempts (backoff'd)
        self.redispatches = 0     # dead-instance recoveries performed
        self.failed_ids: set = set()
        self.decisions: List[Tuple] = []

    # ---- observability ------------------------------------------------------
    def bounds(self) -> List[Tuple[float, float]]:
        return [(s.lo, s.hi) for s in self.stages]

    def pending_ids(self) -> set:
        return set(self._pending)

    def instance_health(self) -> Dict[int, str]:
        return dict(self.health)

    # ---- liveness (DESIGN.md §Fault tolerance) ------------------------------
    def _alive(self, iid: int) -> bool:
        return self.health.get(iid, HEALTH_ALIVE) == HEALTH_ALIVE

    def _weight(self, iid: int) -> float:
        """Capacity weight of an instance (optional InstanceView hook,
        DESIGN.md §Sharded serving): a tp=N engine weighs N — its pool
        is N× deeper and its per-iteration throughput higher, so every
        load comparison normalizes by weight. Views without the hook
        weigh 1.0, keeping legacy clusters bit-identical."""
        fn = getattr(self.instances[iid], "capacity_weight", None)
        w = float(fn()) if callable(fn) else 1.0
        return max(w, 1e-9)

    def heartbeat(self, iid: int, now: float) -> None:
        """Driver-reported proof of life. Any heartbeat restores alive;
        a heartbeat from a DEAD instance is a rejoin — the driver must
        have rebuilt/cleared the instance first (`instance_down` wiped
        the old state), and stage coverage re-expands automatically
        because every health filter recomputes per decision."""
        self.last_seen[iid] = now
        state = self.health.get(iid, HEALTH_ALIVE)
        if state != HEALTH_ALIVE:
            self.health[iid] = HEALTH_ALIVE
            if state == HEALTH_DEAD:
                self.decisions.append(("rejoin", iid))

    def check_liveness(self, now: float) -> None:
        """Transition instances whose heartbeats stopped: alive ->
        suspect (stop routing to it) -> dead (expire its offers, recover
        its residents). Thresholds are ControlConfig.suspect_after /
        dead_after in the driver's clock."""
        for iid in self._order:
            if self.health[iid] == HEALTH_DEAD:
                continue
            seen = self.last_seen.get(iid)
            if seen is None:
                self.last_seen[iid] = now    # first observation
                continue
            dt = now - seen
            if dt >= self.cfg.dead_after:
                self._mark_dead(iid)
            elif dt >= self.cfg.suspect_after \
                    and self.health[iid] == HEALTH_ALIVE:
                self.health[iid] = HEALTH_SUSPECT
                self.decisions.append(("suspect", iid))

    def _healthy_stage(self, si: int) -> Tuple[int, List[int]]:
        """Alive instances serving stage ``si``. A stage whose instances
        are all down folds into its neighbors — later stages first (they
        can hold longer sequences), then earlier — so the length
        partition degrades gracefully instead of black-holing a range.
        Returns (effective_stage, ids); ids is empty only when the whole
        cluster is down."""
        ids = [i for i in self.stages[si].instance_ids if self._alive(i)]
        if ids:
            return si, ids
        for sj in (list(range(si + 1, len(self.stages)))
                   + list(range(si - 1, -1, -1))):
            ids = [i for i in self.stages[sj].instance_ids
                   if self._alive(i)]
            if ids:
                return sj, ids
        return si, []

    # ---- routing (§3.2) -----------------------------------------------------
    def stage_for(self, length: float) -> int:
        for i, s in enumerate(self.stages):
            if length < s.hi:
                return i
        return len(self.stages) - 1

    def route(self, req_id: int, length: float, *,
              cached_tokens: float = 0.0,
              prefix_digest: Optional[int] = None,
              promote_cost_tokens: float = 0.0,
              slo_class: str = "standard") -> int:
        """Pure placement decision for one arrival.

        Cache-aware routing (DESIGN.md §Prefix cache): the length that
        matters is the UNCACHED one — a 30K prompt whose first 28K tokens
        are resident somewhere is a short request, so stage selection uses
        ``length - cached_tokens`` (reservations on the chosen backend
        still cover true length). Within the stage, dispatch tie-breaks
        toward instances advertising the request's prefix-head digest, so
        repeat prefixes land where their blocks already live; the stage RR
        counter advances either way, keeping placement deterministic.

        Tier-aware pricing (DESIGN.md §Multi-tier KV): a hit whose blocks
        were demoted to a host tier is NOT free — ``promote_cost_tokens``
        (the h2d staging price in token units, from
        ``kernels.cost.promote_cost_tokens``) is added back to the
        effective length, so a host-tier hit routes as
        ``uncached_tail + promote_cost``. Within the stage, the warm
        filter prefers device-warm instances over host-warm ones via the
        optional ``tiered_digests()`` view hook.

        SLO-aware dispatch (DESIGN.md §SLO scheduling): interactive
        arrivals pick the least-queued instance of the candidate set —
        their TTFT deadline cannot absorb a deep queue RR might assign —
        while standard/batch keep the RR rotation that spreads prefix
        diversity."""
        alive = [i for i in self._order if self._alive(i)] or self._order
        if self.cfg.policy == "round-robin":
            c = self._rr.get(_RR_GLOBAL, 0)
            self._rr[_RR_GLOBAL] = c + 1
            iid = alive[c % len(alive)]
        elif self.cfg.policy == "least-loaded":
            iid = min(alive,
                      key=lambda i: self.instances[i].load() / self._weight(i))
        else:
            si, ids = self._healthy_stage(
                self.stage_for(max(length - cached_tokens
                                   + promote_cost_tokens, 1.0)))
            if not ids:            # whole cluster down: legacy placement
                ids = self.stages[si].instance_ids
            c = self._rr.get(si, 0)
            self._rr[si] = c + 1
            if prefix_digest is not None:
                dev_warm, host_warm = [], []
                for i in ids:
                    view = self.instances[i]
                    fn = getattr(view, "tiered_digests", None)
                    if fn is not None:
                        tier = fn().get(prefix_digest)
                        if tier == "device":
                            dev_warm.append(i)
                        elif tier is not None:
                            host_warm.append(i)
                    elif prefix_digest in view.prefix_digests():
                        dev_warm.append(i)   # untiered views are all-device
                warm = dev_warm or host_warm
                if warm:
                    ids = warm
            if priority_of(slo_class) == 0 and len(ids) > 1:
                iid = min(ids,
                          key=lambda i: (self.instances[i].queued_tokens()
                                         / self._weight(i), i))
            else:
                iid = ids[c % len(ids)]
        self.decisions.append(("route", req_id, iid))
        return iid

    def submit(self, ref: Any, req_id: int, length: float, *,
               cached_tokens: float = 0.0,
               prefix_digest: Optional[int] = None,
               promote_cost_tokens: float = 0.0,
               slo_class: str = "standard") -> int:
        """Route an arrival and hand it to the backend."""
        iid = self.route(req_id, length, cached_tokens=cached_tokens,
                         prefix_digest=prefix_digest,
                         promote_cost_tokens=promote_cost_tokens,
                         slo_class=slo_class)
        self.ops.dispatch(ref, iid)
        return iid

    # ---- growth-triggered handover (§3.2) -----------------------------------
    def on_instance_iteration(self, inst_id: int) -> None:
        """Offer every request that outgrew its stage to the next stage."""
        if self.cfg.policy != "cascade" or not self._alive(inst_id):
            return                 # a dead instance's view is stale
        si = self.stage_of_instance[inst_id]
        hi = self.stages[si].hi
        if hi == float("inf"):
            return
        for rv in self.instances[inst_id].requests():
            if rv.length >= hi and rv.req_id not in self._pending:
                nxt = min(si + 1, len(self.stages) - 1)
                _, cands = self._healthy_stage(nxt)
                self._offer(inst_id, rv, cands)

    def handover_all(self) -> None:
        for iid in self._order:
            self.on_instance_iteration(iid)

    def begin_tick(self) -> None:
        """Step-synchronous drivers: reset the per-tick migration budget."""
        self._tick_started = 0

    def _tick_ok(self) -> bool:
        return (self.cfg.max_migrations_per_tick <= 0
                or self._tick_started < self.cfg.max_migrations_per_tick)

    # ---- bid-ask negotiation (§4.4) -----------------------------------------
    def _offer(self, src_id: int, rv: ReqView,
               candidate_ids: Sequence[int]) -> None:
        if not self._mig_ready(rv.req_id):
            return                 # banned, or backing off after failures
        sender = self.senders[src_id]
        mig = MigRequest(rv.req_id, int(rv.length), src_id,
                         slo_priority=priority_of(rv.slo_class))
        sender.offer(mig)
        self._pending[rv.req_id] = (rv.ref, src_id)
        cands = [self.instances[i] for i in candidate_ids
                 if i != src_id and self._alive(i)
                 and self.instances[i].can_accept(rv.ref)]
        if self.cfg.balancing == "rr":
            # Fig.-16 ablation: hand over round-robin, no negotiation
            c = self._rr.get(_RR_HANDOVER, 0)
            self._rr[_RR_HANDOVER] = c + 1
            rid = cands[c % len(cands)].id if cands else None
        else:
            bids = [Bid(c.id, c.load() / self._weight(c.id),
                        self.receivers[c.id].earliest_start(),
                        int(self.rng.integers(0, 1 << 30)))
                    for c in cands]
            rid = select_receiver(bids)
        if rid is None:
            sender.drop(mig.req_id)
            self._pending.pop(rv.req_id, None)
            return
        self.receivers[rid].win(mig)
        self._pump(rid)

    # ---- receiver pull loop -------------------------------------------------
    def _sender_busy(self, src_id: int) -> bool:
        return self.senders[src_id].transmitting is not None

    def _pump(self, rid: int) -> None:
        recv = self.receivers[rid]
        self._unwedge(recv)
        if recv.waiting_for is not None:
            # §4.4 starvation: this receiver is committed to the starved
            # request and next_pull stays blocked until it lands — so the
            # pump must try that transfer directly (the sender's
            # starved-first gate admits it as soon as it is free);
            # otherwise sender and receiver deadlock on each other
            req_id = recv.waiting_for
            if not self._mig_ready(req_id):
                return               # blocked AND backing off: wait it out
            mig = recv.take(req_id)          # clears the block
            if mig is None:
                return
            if not self._begin_transfer(mig, rid):
                recv.win(mig)
                recv.waiting_for = req_id    # still blocked: sender busy
            return
        deferred: List[MigRequest] = []      # backoff-gated, re-queued below
        try:
            while True:
                mig, starved = recv.next_pull(self._sender_busy)
                if starved is not None:
                    entry = self._pending.get(starved)
                    if entry is not None:
                        self.senders[entry[1]].mark_starved(starved)
                if mig is None:
                    return
                if not self._mig_ready(mig.req_id):
                    if mig.req_id in self._mig_banned:
                        # retry budget exhausted: cancel the negotiation,
                        # the request completes on its source
                        entry = self._pending.pop(mig.req_id, None)
                        if entry is not None:
                            self.senders[entry[1]].drop(mig.req_id)
                        continue
                    # backing off: skip WITHOUT a starvation fail, try the
                    # next queued offer
                    deferred.append(mig)
                    continue
                if not self._begin_transfer(mig, rid):
                    recv.win(mig)      # put back; retry on next pump
                    return
        finally:
            for m in deferred:
                recv.win(m)

    def pump_all(self) -> None:
        # one pump round = one unit of the migration-backoff clock
        self._round += 1
        for rid in self._order:
            if len(self.receivers[rid]):
                self._pump(rid)

    def _unwedge(self, recv: ReceiverState) -> None:
        """A receiver blocked on a starved request stays blocked until that
        request transfers — but the request may instead have *finished* on
        its source. Drop such stale blocks so the pull loop keeps flowing."""
        req_id = recv.waiting_for
        if req_id is None:
            return
        entry = self._pending.get(req_id)
        if entry is None:
            recv.take(req_id)          # finalized elsewhere: drop the win
            return
        ref, src_id = entry
        if not self.instances[src_id].has_request(ref):
            self.senders[src_id].drop(req_id)
            self._pending.pop(req_id, None)
            recv.take(req_id)

    # ---- migration retry backoff (DESIGN.md §Fault tolerance) ---------------
    def _mig_ready(self, req_id: int) -> bool:
        """May this request attempt (or be offered for) a migration now?
        False while banned or inside its backoff window."""
        if req_id in self._mig_banned:
            return False
        return self._round >= self._mig_not_before.get(req_id, 0)

    def _note_mig_failure(self, req_id: int) -> bool:
        """Record a counted migration failure (receiver refusal, wire
        timeout, receiver death — NOT benign sender-busy / tick-budget
        defers). Returns True when the retry budget is exhausted: the
        request is permanently banned from migrating (it completes on
        its source), which is the strict no-spin bound — total attempts
        are <= max_retries + 1."""
        self.retries += 1
        n = self._mig_fails.get(req_id, 0) + 1
        self._mig_fails[req_id] = n
        pol = self.cfg.mig_backoff
        if n > pol.max_retries:
            self._mig_banned.add(req_id)
            self._mig_not_before.pop(req_id, None)
            self.decisions.append(("mig_giveup", req_id))
            return True
        self._mig_not_before[req_id] = self._round + pol.delay(n)
        return False

    def _cancel_offer(self, req_id: int) -> None:
        """Unwind a live negotiation without penalizing the request."""
        entry = self._pending.pop(req_id, None)
        if entry is not None:
            self.senders[entry[1]].drop(req_id)

    def _begin_transfer(self, mig: MigRequest, dst_id: int) -> bool:
        """Returns True when the pull was consumed (transfer started, the
        offer was stale, or the negotiation was cancelled), False when
        the receiver should retry later."""
        entry = self._pending.get(mig.req_id)
        if entry is None:
            return True                # already finalized elsewhere
        ref, src_id = entry
        src = self.instances[src_id]
        dst = self.instances[dst_id]
        sender = self.senders[src_id]
        if not src.has_request(ref):   # finished before the transfer began
            sender.drop(mig.req_id)
            self._pending.pop(mig.req_id, None)
            return True
        if not sender.can_transmit(mig.req_id):
            return False               # benign defer: no backoff penalty
        if not self._tick_ok():
            return False               # benign defer: budget resets next tick
        # §5 flow control: stay on the source unless the receiver is alive
        # and can admit the request right now. A refusal here is a COUNTED
        # failure (unlike the defers above): retries run through the
        # capped exponential backoff, and past the budget the negotiation
        # is cancelled for good.
        if not self._alive(dst_id) or not dst.can_accept(ref):
            if self._note_mig_failure(mig.req_id):
                self._cancel_offer(mig.req_id)
                return True            # consumed: banned, stays on source
            return False
        sender.begin(mig.req_id)
        self._tick_started += 1
        status = self.ops.start_migration(ref, src_id, dst_id)
        if status == MIG_FAILED:
            sender.abort(mig.req_id)
            self._tick_started -= 1
            if self._note_mig_failure(mig.req_id):
                self._cancel_offer(mig.req_id)
                return True
            return False
        assert status in (MIG_STARTED, MIG_COMPLETED), status
        self.decisions.append(("migrate", mig.req_id, src_id, dst_id))
        self._dst_of[mig.req_id] = dst_id
        if status == MIG_COMPLETED:
            self._finalize(mig.req_id, arrived=True)
        return True

    def migration_finished(self, req_id: int, arrived: bool = True) -> None:
        """Async backends report a transfer's end here: ``arrived`` tells
        whether the request landed on the receiver, or the move was
        dropped because the request finished mid-flight."""
        dst_id = self._finalize(req_id, arrived)
        if dst_id is not None:
            self._pump(dst_id)

    def _finalize(self, req_id: int, arrived: bool) -> Optional[int]:
        dst_id = self._dst_of.pop(req_id, None)
        entry = self._pending.pop(req_id, None)
        if entry is not None:
            src_id = entry[1]
            self.senders[src_id].finish(req_id)
            if dst_id is not None and arrived:
                key = (self.stage_of_instance[src_id],
                       self.stage_of_instance[dst_id])
                self.migrations += 1
                self.migrations_by_stage[key] = \
                    self.migrations_by_stage.get(key, 0) + 1
        if dst_id is not None:
            self.receivers[dst_id].complete(req_id)
        # the negotiation ended: earlier refusal penalties are moot
        self._mig_fails.pop(req_id, None)
        self._mig_not_before.pop(req_id, None)
        return dst_id

    # ---- failure handling (DESIGN.md §Fault tolerance) ----------------------
    def migration_failed(self, req_id: int) -> None:
        """Backend/driver reports that a STARTED transfer will never land
        (wire timeout, lost payload, receiver died mid-flight). Rolls the
        negotiation back so the request survives on its source, applies
        the retry backoff, and wakes the receiver. Idempotent — a late
        timeout racing a completed transfer is a no-op."""
        dst_id = self._dst_of.pop(req_id, None)
        entry = self._pending.pop(req_id, None)
        if entry is None and dst_id is None:
            return                     # already settled elsewhere
        if entry is not None:
            sender = self.senders[entry[1]]
            if sender.transmitting == req_id:
                sender.finish(req_id)  # frees the (serialized) uplink
            else:
                sender.drop(req_id)
        if dst_id is not None:
            self.receivers[dst_id].complete(req_id)
        self.decisions.append(("mig_fail", req_id))
        self._note_mig_failure(req_id)
        if dst_id is not None:
            self._pump(dst_id)

    def _mark_dead(self, iid: int) -> None:
        """Liveness declared this instance dead: fail its in-flight
        transfers, expire its bid-ask offers, reset its negotiation
        state, then recover every resident request."""
        self.health[iid] = HEALTH_DEAD
        self.decisions.append(("dead", iid))
        # in-flight transfers touching the dead instance fail — either
        # endpoint of the wire is gone
        for req_id in [r for r, d in list(self._dst_of.items())
                       if d == iid
                       or self._pending.get(r, (None, None))[1] == iid]:
            self.migration_failed(req_id)
        # won-but-unstarted offers destined HERE return to their senders
        for mig in self.receivers[iid].drain():
            self._cancel_offer(mig.req_id)
        # offers sourced here vanish with the instance, wherever queued
        for req_id in [r for r, (_, s) in list(self._pending.items())
                       if s == iid]:
            self._pending.pop(req_id, None)
            for recv in self.receivers.values():
                recv.take(req_id)
        self.senders[iid] = SenderState(iid)
        self.receivers[iid] = ReceiverState(iid)
        # recover residents: snapshot BEFORE the backend clears the
        # carcass (all_requests when the view has it — queued/parked
        # requests die with their instance just like running ones)
        view = self.instances[iid]
        allreq = getattr(view, "all_requests", None)
        residents = list(allreq() if callable(allreq) else view.requests())
        down = getattr(self.ops, "instance_down", None)
        if callable(down):
            down(iid)
        for rv in residents:
            self._redispatch(rv)

    def _redispatch(self, rv: ReqView) -> None:
        """Recover one resident of a dead instance. Its KV is gone, so
        the backend must replay prompt + generated-so-far on a healthy
        instance (ClusterOps.redispatch). Over the budget — or with no
        healthy target, or a backend without the hook — the request
        surfaces as failed instead of hanging the run."""
        rid = rv.req_id
        # fresh life: migration penalties died with the instance
        self._mig_fails.pop(rid, None)
        self._mig_not_before.pop(rid, None)
        self._mig_banned.discard(rid)
        n = self._redispatch_count.get(rid, 0) + 1
        self._redispatch_count[rid] = n
        redo = getattr(self.ops, "redispatch", None)
        si, ids = self._healthy_stage(self.stage_for(max(rv.length, 1.0)))
        if n > self.cfg.redispatch_budget or not callable(redo) or not ids:
            self._fail(rv)
            return
        c = self._rr.get(si, 0)        # shared stage RR counter: parity-
        self._rr[si] = c + 1           # deterministic across backends
        iid = ids[c % len(ids)]
        self.decisions.append(("redispatch", rid, iid))
        if redo(rv.ref, iid):
            self.redispatches += 1
        else:
            self._fail(rv)             # target cannot replay this request

    def _fail(self, rv: ReqView) -> None:
        self.failed_ids.add(rv.req_id)
        self.decisions.append(("fail", rv.req_id))
        fail = getattr(self.ops, "fail_request", None)
        if callable(fail):
            fail(rv.ref)

    # ---- intra-stage rebalancing (§4.4) -------------------------------------
    def balance(self) -> None:
        if self.cfg.policy != "cascade" or self.cfg.balancing != "full":
            return
        for stage in self.stages:
            ids = [i for i in stage.instance_ids if self._alive(i)]
            if len(ids) < 2:
                continue
            # weight-normalized: a tp=4 engine at 4× the raw tokens of a
            # tp=1 peer is equally loaded, not overloaded
            loads = {i: self.instances[i].load() / self._weight(i)
                     for i in ids}
            for i in ids:
                peers = [l for j, l in loads.items() if j != i]
                if not is_overloaded(loads[i], peers):
                    continue
                cands = [rv for rv in self.instances[i].requests()
                         if rv.req_id not in self._pending]
                if not cands:
                    continue
                # memory-aware AND SLO-aware: among the migratable
                # requests, move the largest KV footprint of the LOWEST
                # service class first (batch before standard before
                # interactive) — rebalancing should never add transfer
                # latency to a tight-deadline request while batch work is
                # available to move
                victim = max(cands, key=lambda rv: (priority_of(rv.slo_class),
                                                    rv.length))
                self._offer(i, victim, [j for j in ids if j != i])

    # ---- boundary refinement (§4.3, Fig. 15) --------------------------------
    def refine(self) -> None:
        if self.cfg.policy != "cascade" or self.cfg.refinement == "none":
            return
        if self.cfg.refinement == "adaptive" and self.qoe is None:
            return
        for bi in range(len(self.stages) - 1):
            own = [rv for i in self.stages[bi].instance_ids
                   if self._alive(i)        # dead views are stale
                   for rv in self.instances[i].request_view()]
            succ = [self.instances[i].request_view()
                    for i in self.stages[bi + 1].instance_ids
                    if self._alive(i)]
            if self.cfg.refinement == "adaptive":
                b = self.refiners[bi].refine(own, succ)
            else:
                merged = own + [r for s in succ for r in s]
                if len(merged) < self.refiners[bi].min_requests:
                    continue
                if self.cfg.refinement == "quantity":
                    b = quantity_based_split(merged)
                else:
                    b = memory_based_split(merged)
                self.refiners[bi].boundary = b
            # keep boundaries monotone across stages
            lo = self.stages[bi].lo
            hi_next = self.stages[bi + 1].hi
            b = max(float(b), lo + 1.0)
            if hi_next != float("inf"):
                b = min(b, hi_next - 1.0)
            self.stages[bi].hi = b
            self.stages[bi + 1].lo = b
            self.decisions.append(("boundary", bi, b))
            self.ops.set_boundary(bi, b)
