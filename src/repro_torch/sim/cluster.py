"""MILS cluster simulator: policies (round-robin / Llumnix-like /
CascadeInfer) over simulated instances with live KV migration — the
port's copy of ``repro.sim.cluster``, whole.

CascadePolicy is a thin *driver* of the backend-agnostic scheduling core
(`repro_torch.control.plane.ControlPlane`): it supplies discrete-event timing,
the cost-model transfer fabric, and `InstanceView`/`ClusterOps` adapters
over simulated instances — every routing/handover/balance/refinement
decision is made by the shared core, the same code the real multi-engine
server (`repro_torch.serving.server.MILSServer`) runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import (MIG_STARTED, XFER_LOST, XFER_OK, XFER_STALL,
                           ControlConfig, ControlPlane, FaultInjector,
                           FaultSpec, ReqView, is_overloaded)
from repro_torch.core.migration import plan_live_migration
from repro_torch.core.partition import PipelinePlan
from repro_torch.core.qoe import QoEModel
from repro_torch.kernels.cost import promote_cost_tokens
from repro_torch.sim.costmodel import (HardwareProfile, decode_rate,
                                 scale_profile_tp)
from repro_torch.sim.events import EventQueue
from repro_torch.sim.instance import Instance, SimRequest
from repro_torch.sim.workload import Request


@dataclasses.dataclass
class ClusterConfig:
    num_instances: int = 16
    capacity_tokens: float = 400_000.0
    # per-instance tensor-parallel ways (DESIGN.md §Sharded serving):
    # None = homogeneous single-chip cluster (bit-identical legacy). A
    # tuple of num_instances entries gives instance i a tp=tps[i] engine:
    # its profile re-shards via scale_profile_tp and its KV capacity is
    # capacity_tokens × tps[i] (capacity_tokens stays PER-DEVICE, exactly
    # like Engine.token_budget).
    tps: Optional[Tuple[int, ...]] = None
    kv_block_size: int = 16            # paged-cache allocation granularity
    # prompt-chunk tokens per mixed iteration (DESIGN.md §Chunked
    # prefill), mirroring serving.Engine's token-budgeted scheduler;
    # None = legacy monolithic prefill-at-admission (the §2.1 baseline)
    prefill_token_budget: Optional[int] = None
    # group-granular prefix-cache mirror (DESIGN.md §Prefix cache);
    # active only for chunked instances on workloads carrying prefix
    # groups, so legacy runs are bit-identical either way
    prefix_cache: bool = True
    # SLO-tiered preemptive scheduling (DESIGN.md §SLO scheduling):
    # deadline-ordered queues + seat/memory preemption of lower classes.
    # Uniform-class traffic with distinct arrivals is FCFS either way.
    preemption: bool = True
    # multi-tier KV (DESIGN.md §Multi-tier KV): host-RAM tier capacity in
    # tokens per instance. 0 = tiering off — idle published prefixes cost
    # nothing and are never demoted (the legacy no-reclaim model,
    # bit-identical).
    host_kv_budget: int = 0
    bandwidth: float = 25e9            # inter-instance KV path
    # hand-off disruption: final stop-and-copy stall + scheduler/alloc
    # coordination on both ends (Llumnix reports tens of ms per migration);
    # the request decodes nowhere during this window.
    migration_pause_s: float = 0.05
    refine_interval: float = 10.0
    balance_interval: float = 2.0
    pump_interval: float = 0.5
    drain_factor: float = 20.0         # max extra sim time to drain
    seed: int = 0
    # ---- fault tolerance (DESIGN.md §Fault tolerance) ----
    # None = fault-free run, bit-identical to the pre-fault simulator (no
    # heartbeat/timeout events exist to perturb event-queue tie ordering)
    faults: Optional[FaultSpec] = None
    # wire deadline for one migration; None = auto (4x the planned copy
    # time + 1s). Deadline events exist only in faulty runs.
    migration_timeout_s: Optional[float] = None
    heartbeat_interval: float = 0.5
    suspect_after_s: float = 3.0
    dead_after_s: float = 6.0
    redispatch_budget: int = 2


class Policy:
    name = "base"

    def attach(self, cluster: "Cluster") -> None:
        self.cluster = cluster

    def route(self, sr: SimRequest, t: float) -> Instance:
        raise NotImplementedError

    def dispatch(self, sr: SimRequest, t: float) -> None:
        self.route(sr, t).enqueue(sr, t)

    def on_iteration_end(self, inst: Instance, t: float) -> None:
        pass

    def timers(self) -> List[Tuple[float, Callable[[float], None]]]:
        return []


class Cluster:
    def __init__(self, profile: HardwareProfile, policy: Policy,
                 cfg: ClusterConfig):
        self.cfg = cfg
        self.profile = profile
        self.events = EventQueue()
        self.rng = np.random.default_rng(cfg.seed)
        tps = cfg.tps
        if tps is not None:
            assert len(tps) == cfg.num_instances, \
                f"tps has {len(tps)} entries for {cfg.num_instances} instances"
        self.instances = [
            Instance(i,
                     scale_profile_tp(profile, tps[i]) if tps else profile,
                     cfg.capacity_tokens * (tps[i] if tps else 1),
                     self.events,
                     block_size=cfg.kv_block_size,
                     prefill_budget=cfg.prefill_token_budget,
                     prefix_cache=cfg.prefix_cache,
                     preemption=cfg.preemption,
                     host_kv_blocks=cfg.host_kv_budget
                     // cfg.kv_block_size)
            for i in range(cfg.num_instances)]
        self.completed: List[SimRequest] = []
        self.injector = (FaultInjector(cfg.faults)
                         if cfg.faults is not None else None)
        if self.injector is not None:
            for inst in self.instances:
                inst.slowdown = self.injector.slowdown(inst.id)
        self.policy = policy
        policy.attach(self)
        for inst in self.instances:
            inst.on_iteration_end = policy.on_iteration_end
            inst.on_request_done = self._on_done

    def _on_done(self, inst: Instance, sr: SimRequest, t: float) -> None:
        self.completed.append(sr)

    def submit(self, req: Request) -> None:
        def arrive():
            sr = SimRequest(req=req, length=req.input_len)
            self.policy.dispatch(sr, self.events.now)
        self.events.push(req.arrival, arrive)

    def _revive(self, inst: Instance) -> None:
        inst.clear_crashed()           # idempotent: rejoin starts empty
        inst.revive(self.events.now)
        inst.kick(self.events.now)

    def run(self, requests: Sequence[Request], duration: float) -> "SimResult":
        for r in requests:
            self.submit(r)
        if self.cfg.faults is not None:
            # scripted chaos: crashes/rejoins are ordinary events.
            # all_crashes expands correlated rack events into the same
            # per-instance schedule, so several instances can die in one
            # tick (deterministic same-tick order: listed order).
            for iid, at in self.cfg.faults.all_crashes:
                self.events.push(
                    at, lambda i=self.instances[iid]: i.crash(self.events.now))
            for iid, at in self.cfg.faults.rejoins:
                self.events.push(
                    at, lambda i=self.instances[iid]: self._revive(i))
        for interval, fn in self.policy.timers():
            self._periodic(interval, fn)
        self.events.run_until(duration)
        # drain: keep going until every submitted request completes (a
        # failed request counts as completed — it must not hang the run)
        t_max = duration * self.cfg.drain_factor
        while (len(self.completed) < len(requests)
               and self.events.now < t_max and len(self.events)):
            self.events.run_until(min(self.events.now + duration, t_max))
        from repro_torch.sim.metrics import SimResult
        plane = getattr(self.policy, "plane", None)
        return SimResult(completed=list(self.completed),
                         duration=self.events.now,
                         num_submitted=len(requests),
                         instances=self.instances,
                         policy_name=self.policy.name,
                         stage_of_instance=getattr(
                             self.policy, "stage_of_instance", None),
                         retries=plane.retries if plane is not None else 0)

    def _periodic(self, interval: float, fn: Callable[[float], None]) -> None:
        def tick():
            fn(self.events.now)
            self.events.push(self.events.now + interval, tick)
        self.events.push(interval, tick)


# --------------------------------------------------------------------------
# Baseline policies
# --------------------------------------------------------------------------
class RoundRobinPolicy(Policy):
    """vLLM/SGLang deployment baseline (§6.1): stateless round-robin LB."""
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def route(self, sr, t):
        inst = self.cluster.instances[self._next % len(self.cluster.instances)]
        self._next += 1
        return inst


class LlumnixLikePolicy(Policy):
    """Length-agnostic load/memory-aware inter-instance scheduling with
    live migration on overload (Llumnix's core heuristics, §2.4)."""
    name = "llumnix-like"

    def __init__(self, migration: bool = True):
        self.migration = migration

    def attach(self, cluster):
        super().attach(cluster)
        self._mover = TransferFabric(cluster)

    def route(self, sr, t):
        # least total load (KV + queued work) — Llumnix routes on load and
        # free memory; queue-blind routing herds onto backlogged instances
        return min(self.cluster.instances, key=lambda i: i.load())

    def timers(self):
        return [(self.cluster.cfg.balance_interval, self._balance)]

    def _balance(self, t):
        if not self.migration:
            return
        insts = self.cluster.instances
        loads = [i.load() for i in insts]
        for inst in insts:
            peers = [l for j, l in enumerate(loads) if j != inst.id]
            if not is_overloaded(inst.load(), peers):
                continue
            target = max(insts, key=lambda i: i.free_tokens())
            if target.id == inst.id:
                continue
            cands = [r for r in inst.running if not r.migrating]
            if not cands:
                continue
            victim = max(cands, key=lambda r: r.length)   # memory-aware
            self._mover.direct_transfer(inst, target, victim, t)


# --------------------------------------------------------------------------
# Transfer fabric: live migration with concurrency + flow control
# --------------------------------------------------------------------------
class TransferFabric:
    """Shared KV-migration machinery (used by Llumnix-like and Cascade)."""

    def __init__(self, cluster: Cluster,
                 kv_bytes_per_token: Optional[float] = None):
        self.cluster = cluster
        self.kv_bytes_per_token = kv_bytes_per_token
        # fault wiring (set by CascadePolicy.attach on faulty runs):
        # injector decides per-attempt wire fates; on_failed(req_id)
        # reports a transfer that will never land (-> plane rollback)
        self.injector: Optional[FaultInjector] = None
        self.on_failed: Optional[Callable[[int], None]] = None

    def direct_transfer(self, src: Instance, dst: Instance,
                        sr: SimRequest, t: float) -> bool:
        """Llumnix path: gate on the receiver's room + source cap, then
        move. (Cascade gates in the control plane and calls ``transfer``.)"""
        if sr.migrating or sr.done:
            return False
        need = dst.block_tokens(sr.length)
        if not src.migrations.can_start(dst.free_tokens() >= need):
            return False
        self.transfer(src, dst, sr, t)
        return True

    def transfer(self, src: Instance, dst: Instance, sr: SimRequest,
                 t: float, on_finish: Optional[Callable] = None) -> None:
        """Start a live migration: multi-round copy timing from the cost
        model, block-granular reservation on the receiver, stop-and-copy
        pause, then adoption. ``on_finish(arrived)`` fires when the
        transfer leaves the wire (before the adoption pause). A
        half-prefilled request ships only its ``ctx_done`` written blocks
        (the receiver resumes chunking — DESIGN.md §Chunked prefill), but
        the receiver-side reservation covers the FULL current length:
        the un-prefilled remainder materializes right after adoption, and
        gating on the written part alone would let the receiver overflow
        (the real engine reserves the worst case at import)."""
        need = dst.block_tokens(sr.length)          # eventual footprint
        ship = dst.block_tokens(sr.kv_len)          # crosses the wire now
        sr.migrating = True
        dst.inbound_reserved += need
        rate = decode_rate([r.length for r in src.running], src.profile)
        kvb = (self.kv_bytes_per_token or src.profile.kv_bytes_per_token
               or 2e5)
        timing = plan_live_migration(ship, rate, kvb,
                                     self.cluster.cfg.bandwidth)
        src.migrations.start(sr.req.req_id, t + timing.total_s)

        pause = self.cluster.cfg.migration_pause_s + timing.stall_s
        # fault machinery (DESIGN.md §Fault tolerance): epoch fences a
        # receiver crash (its reservations were wiped with the carcass),
        # `state` makes delivery and the wire deadline mutually exclusive
        dst_ep = dst.epoch
        state = {"settled": False}

        def release():
            if dst.alive and dst.epoch == dst_ep:
                dst.inbound_reserved -= need

        def finish():
            if state["settled"]:
                return                 # the deadline already rolled back
            state["settled"] = True
            now = self.cluster.events.now
            src.migrations.finish(sr.req.req_id)
            if sr.done or sr not in src.running:
                release()
                sr.migrating = False
                if on_finish:
                    on_finish(False)   # completed mid-flight: drop the move
                return
            if not dst.alive or dst.epoch != dst_ep:
                # receiver died with the payload on the wire: ownership
                # never flipped, the request survives on its source
                sr.migrating = False
                if self.on_failed:
                    self.on_failed(sr.req.req_id)
                return
            src.running.remove(sr)
            src.kick(now)

            def adopt():     # stop-and-copy + scheduler hand-off pause
                now2 = self.cluster.events.now
                if not dst.alive or dst.epoch != dst_ep:
                    # receiver died inside the hand-off pause: bounce the
                    # request back to its source (KV still lives there —
                    # ownership flips only at adoption)
                    sr.migrating = False
                    if self.on_failed:
                        self.on_failed(sr.req.req_id)
                    if src.alive and not sr.done:
                        src.adopt_running(sr, now2)
                    else:
                        # both endpoints gone: unrecoverable
                        sr.failed = True
                        sr.finish_t = now2
                        if sr.first_token_t is None:
                            sr.first_token_t = now2
                        self.cluster.completed.append(sr)
                    return
                dst.inbound_reserved -= need
                sr.migrating = False
                # a migrated shared prefix re-imports as PRIVATE (the
                # wire shipped a plain contiguous copy) — matching
                # Engine.import_request; `need` above covered true length
                sr.cached_tokens = 0
                dst.adopt_running(sr, now2)

            self.cluster.events.push(now + pause, adopt)
            if on_finish:
                on_finish(True)

        inj = self.injector
        if inj is None:                # fault-free: the legacy event shape
            self.cluster.events.push(t + timing.total_s, finish)
            return
        fate = inj.transfer_event(sr.req.req_id)
        timeout = (self.cluster.cfg.migration_timeout_s
                   or timing.total_s * 4.0 + 1.0)

        def deadline():
            if state["settled"]:
                return                 # delivered in time
            state["settled"] = True
            # the payload never landed: free both endpoints' transfer
            # state; the request never left src.running
            src.migrations.finish(sr.req.req_id)
            release()
            sr.migrating = False
            if self.on_failed:
                self.on_failed(sr.req.req_id)

        self.cluster.events.push(t + timeout, deadline)
        if fate == XFER_LOST:
            return                     # vanishes; only the deadline fires
        deliver_at = (t + timeout * 2.0 if fate == XFER_STALL
                      else t + timing.total_s)
        self.cluster.events.push(deliver_at, finish)


# --------------------------------------------------------------------------
# CascadeInfer: discrete-event driver of the shared control plane
# --------------------------------------------------------------------------
class SimInstanceView:
    """`repro_torch.control.protocol.InstanceView` over a simulated instance."""

    def __init__(self, inst: Instance):
        self.inst = inst
        self.id = inst.id

    def load(self) -> float:
        return self.inst.load()

    def free_tokens(self) -> float:
        return self.inst.free_tokens()

    def used_tokens(self) -> float:
        return self.inst.kv_tokens()

    def queued_tokens(self) -> float:
        return self.inst.queued_tokens()

    def capacity_weight(self) -> float:
        """Instance-units this simulated engine counts for (the tp ways
        its profile spans) — the plane's stage claiming and load
        normalization hook (DESIGN.md §Sharded serving)."""
        return float(self.inst.profile.num_devices)

    def requests(self) -> List[ReqView]:
        return [ReqView(sr, sr.req.req_id, float(sr.req.input_len),
                        float(sr.length), ctx_done=float(sr.ctx_done),
                        ctx_total=float(sr.prefill_target_len),
                        cached_tokens=float(sr.cached_tokens),
                        slo_class=sr.req.slo_class)
                for sr in self.inst.running if not sr.migrating]

    def prefix_digests(self) -> frozenset:
        return self.inst.prefix_digests()

    def tiered_digests(self):
        return self.inst.tiered_digests()

    def request_view(self):
        return self.inst.request_view()

    def has_request(self, sr: SimRequest) -> bool:
        return not sr.done and sr in self.inst.running

    def can_accept(self, sr: SimRequest) -> bool:
        return self.inst.free_tokens() >= self.inst.block_tokens(sr.length)

    def all_requests(self) -> List[ReqView]:
        """Every resident — running (even mid-migration), waiting, parked.
        Dead-instance recovery re-dispatches all of them."""
        return [ReqView(sr, sr.req.req_id, float(sr.req.input_len),
                        float(sr.length), ctx_done=float(sr.ctx_done),
                        ctx_total=float(sr.prefill_target_len),
                        cached_tokens=float(sr.cached_tokens),
                        slo_class=sr.req.slo_class)
                for sr in (list(self.inst.running) + list(self.inst.waiting)
                           + list(self.inst.parked))]


class _SimOps:
    """`repro_torch.control.protocol.ClusterOps` over the simulated cluster:
    placements become queue pushes at the current event time, migrations
    become `TransferFabric` live transfers with cost-model timing."""

    def __init__(self, cluster: Cluster, fabric: TransferFabric):
        self.cluster = cluster
        self.fabric = fabric
        self.plane: Optional[ControlPlane] = None   # set after construction

    def dispatch(self, sr: SimRequest, instance_id: int) -> None:
        self.cluster.instances[instance_id].enqueue(sr,
                                                    self.cluster.events.now)

    def start_migration(self, sr: SimRequest, src_id: int,
                        dst_id: int) -> str:
        self.fabric.transfer(
            self.cluster.instances[src_id], self.cluster.instances[dst_id],
            sr, self.cluster.events.now,
            on_finish=lambda arrived: self.plane.migration_finished(
                sr.req.req_id, arrived))
        return MIG_STARTED

    def set_boundary(self, stage_idx: int, hi: float) -> None:
        pass                        # the core's bounds are authoritative

    # ---- fault tolerance (DESIGN.md §Fault tolerance) --------------------
    def redispatch(self, sr: SimRequest, instance_id: int) -> bool:
        """Recover a resident of a dead instance: its KV died, so replay
        prompt + generated-so-far through prefill on ``instance_id`` —
        the same resume math recompute preemption uses, so timing (and,
        on the real engine, tokens) match a never-crashed run."""
        now = self.cluster.events.now
        sr.migrating = False
        sr.redispatches += 1
        if sr.resume_target is None and sr.generated > 0:
            sr.resume_target = max(sr.req.input_len + sr.generated - 1, 1)
        sr.ctx_done = 0
        sr.cached_tokens = 0
        self.cluster.instances[instance_id].enqueue(sr, now)
        return True

    def fail_request(self, sr: SimRequest) -> None:
        now = self.cluster.events.now
        sr.failed = True
        sr.migrating = False
        sr.finish_t = now
        if sr.first_token_t is None:
            sr.first_token_t = now
        # completion (of a sort): the drain loop must terminate
        self.cluster.completed.append(sr)

    def instance_down(self, instance_id: int) -> None:
        self.cluster.instances[instance_id].clear_crashed()


class CascadePolicy(Policy):
    """The paper's system. Ablation knobs:
      refinement ∈ {adaptive, quantity, memory, none}   (Fig. 15)
      balancing  ∈ {full, inter-stage, rr}              (Fig. 16)
      plan layout chain/no-pipeline comes from the plan (Fig. 14)

    All knobs and mechanisms live in the shared `ControlPlane`; this class
    only adapts them to discrete-event time and simulated KV transfers.
    """
    name = "cascade"

    def __init__(self, plan: PipelinePlan, qoe: QoEModel, *,
                 refinement: str = "adaptive", balancing: str = "full",
                 kv_bytes_per_token: Optional[float] = None):
        self.plan = plan
        self.qoe = qoe
        self.refinement = refinement
        self.balancing = balancing
        self.kv_bytes_per_token = kv_bytes_per_token

    def attach(self, cluster):
        super().attach(cluster)
        ccfg = cluster.cfg
        fabric = TransferFabric(cluster, self.kv_bytes_per_token)
        ops = _SimOps(cluster, fabric)
        self.plane = ControlPlane(
            self.plan, self.qoe,
            ControlConfig(policy="cascade", refinement=self.refinement,
                          balancing=self.balancing, seed=ccfg.seed,
                          suspect_after=ccfg.suspect_after_s,
                          dead_after=ccfg.dead_after_s,
                          redispatch_budget=ccfg.redispatch_budget),
            ops=ops, instances=[SimInstanceView(i)
                                for i in cluster.instances])
        ops.plane = self.plane
        fabric.injector = cluster.injector
        fabric.on_failed = self.plane.migration_failed

    @property
    def stage_of_instance(self) -> List[int]:
        return [self.plane.stage_of_instance[i.id]
                for i in self.cluster.instances]

    # ---- driver events ------------------------------------------------------
    def _prefix_hint(self, sr: SimRequest):
        """(digest, best cached tokens, promote price in token units)
        across the cluster — the sim's mirror of MILSServer._prefix_hint
        (group id stands in for the content-derived head digest;
        membership patterns match, which is all routing consumes). Ties
        on cached tokens prefer the cheaper (device-warm) instance, and
        the promote price comes from the SAME pure pricing fn
        (`kernels.cost.promote_cost_tokens`) the server calls, so the
        decision logs stay comparable."""
        if sr.req.prefix_group < 0:
            return None, 0.0, 0.0
        cached, price = 0.0, 0.0
        for i in self.cluster.instances:
            c = float(i.cached_tokens_for(sr))
            p = promote_cost_tokens(i.host_blocks_for(sr), i.block_size)
            if (c, -p) > (cached, -price):
                cached, price = c, p
        digest = sr.req.prefix_group
        return digest, cached, price

    def dispatch(self, sr: SimRequest, t: float) -> None:
        digest, cached, price = self._prefix_hint(sr)
        self.plane.submit(sr, sr.req.req_id, sr.length,
                          cached_tokens=cached, prefix_digest=digest,
                          promote_cost_tokens=price,
                          slo_class=sr.req.slo_class)

    def on_iteration_end(self, inst, t):
        self.plane.on_instance_iteration(inst.id)

    def _heartbeat(self, t):
        """Liveness pulse (faulty runs only — fault-free event queues stay
        byte-identical to the legacy simulator): every live instance
        proves life, then the plane ages the silent ones."""
        for inst in self.cluster.instances:
            if inst.alive:
                self.plane.heartbeat(inst.id, t)
        self.plane.check_liveness(t)

    def timers(self):
        out = [(self.cluster.cfg.pump_interval,
                lambda t: self.plane.pump_all())]
        if self.balancing == "full":
            out.append((self.cluster.cfg.balance_interval,
                        lambda t: self.plane.balance()))
        if self.refinement != "none":
            out.append((self.cluster.cfg.refine_interval,
                        lambda t: self.plane.refine()))
        if self.cluster.cfg.faults is not None:
            out.append((self.cluster.cfg.heartbeat_interval,
                        self._heartbeat))
        return out
