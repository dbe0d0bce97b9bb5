"""Multi-instance serving cluster over the port's torch engines — the port
of ``repro.serving.server``.

N in-process :class:`~repro_torch.serving.engine.Engine` instances serve
one model (one shared weight set; each engine owns only its KV pool),
grouped into length-specialized stages (``PipelinePlan``). Every
scheduling decision — round-robin-within-stage arrival routing (§3.2),
growth-triggered handover with bid-ask negotiation, intra-stage
rebalancing, boundary refinement, §5 flow control — comes from the port's
copy of the backend-agnostic core (:class:`repro_torch.control.plane.
ControlPlane`). This server supplies the mechanisms: step-synchronous
time (every engine advances one continuous-batching iteration per tick)
and live KV migration (export -> import -> evict) between engines.

The serving API is open-loop: ``submit_at(req, step)`` builds an arrival
schedule (e.g. replayed from a ``sim.workload`` trace via
:func:`requests_from_trace`), ``step()``/``run()`` advance it, an optional
``on_token`` callback streams every generated token, and
``run(drain=True)`` keeps stepping until everything submitted finished.

The engines' SLO preemption, host KV tier and int8 pools are set from the
``ServerConfig`` (the reference's defaults: preemption on, no host tier
unless asked). ``ServerConfig.faults`` turns on the seeded fault model:
scripted crashes and rejoins, lost or stalled transfers (reported at a
wire deadline), heartbeats and liveness, and redispatch of a dead
engine's residents, which replay prompt + generated-so-far through the
engines' recompute-resume path. Tensor parallelism is not ported yet.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import (MIG_COMPLETED, MIG_FAILED, MIG_STARTED,
                                 XFER_OK, XFER_STALL, ControlConfig,
                                 ControlPlane, FaultInjector, FaultSpec,
                                 ReqView)
from repro_torch.core.partition import PipelinePlan
from repro_torch.core.qoe import QoEModel
from repro_torch.kernels.cost import promote_cost_tokens
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest, State
from repro_torch.sim.metrics import class_slo_summary, fault_summary
from repro_torch.sim.workload import Request

TokenCallback = Callable[[ServeRequest, int], None]


@dataclasses.dataclass
class ServerConfig:
    policy: str = "cascade"            # cascade | round-robin | least-loaded
    refinement: str = "adaptive"       # adaptive | quantity | memory | none
    balancing: str = "full"            # full | inter-stage | rr
    refine_every: int = 16             # steps
    balance_every: int = 8
    max_migrations_per_step: int = 3   # §5 concurrency cap
    seed: int = 0
    # dense | grid | flat | fused | None = fused
    attn_backend: Optional[str] = None
    kv_dtype: str = "bf16"             # bf16 | int8 (int8: fused or dense)
    # SLO-tiered preemptive scheduling; False keeps FCFS queues. With
    # uniform-class traffic and distinct arrival steps the SLO order is
    # FCFS and nothing preempts.
    preemption: bool = True
    slo_scale: float = 1.0             # paper §6.4 SLO-scale sweep knob
    slo_time_scale: float = 1.0        # engine steps per abstract SLO second
    # host-RAM KV tier capacity in tokens per engine (0 = off; the
    # launcher turns it on)
    host_kv_budget: int = 0
    # ---- fault tolerance: None = fault-free (no heartbeats or liveness)
    faults: Optional[FaultSpec] = None
    suspect_after_steps: int = 3       # heartbeat-free steps -> suspect
    dead_after_steps: int = 6          # -> dead, residents recovered
    migration_timeout_steps: int = 4   # wire deadline for one transfer
    redispatch_budget: int = 2         # dead-engine recoveries per request


def _req_view(r: ServeRequest) -> ReqView:
    return ReqView(r, r.req_id, float(len(r.prompt)), float(r.length),
                   ctx_done=float(r.ctx_done),
                   ctx_total=float(r.prefill_target_len),
                   cached_tokens=float(r.cached_tokens),
                   slo_class=r.slo_class)


class EngineView:
    """``repro_torch.control.protocol.InstanceView`` over a torch engine."""

    def __init__(self, eng: Engine):
        self.eng = eng
        self.id = eng.id

    def load(self) -> float:
        return self.eng.load()

    def free_tokens(self) -> float:
        return float(self.eng.free_tokens())

    def used_tokens(self) -> float:
        return float(self.eng.used_tokens())

    def queued_tokens(self) -> float:
        return float(self.eng.queued_tokens())

    def capacity_weight(self) -> float:
        """Instance-units this engine counts for: its tensor-parallel ways
        (an engine without a ``tp`` weighs 1)."""
        return float(getattr(self.eng, "tp", 1) or 1)

    def requests(self) -> List[ReqView]:
        return [_req_view(r) for r in self.eng.slots if r is not None]

    def all_requests(self) -> List[ReqView]:
        """Every resident — slotted, waiting, parked: dead-engine recovery
        redispatches all of them."""
        reqs = [r for r in self.eng.slots if r is not None]
        reqs += list(self.eng.waiting)
        reqs += [p.req for p in self.eng.parked]
        out, seen = [], set()
        for r in reqs:
            if id(r) not in seen:
                seen.add(id(r))
                out.append(_req_view(r))
        return out

    def prefix_digests(self) -> frozenset:
        return self.eng.prefix_digests()

    def tiered_digests(self):
        """digest -> "device" | "host" for tier-aware warm routing."""
        return self.eng.tiered_digests()

    def request_view(self):
        return self.eng.request_view()

    def has_request(self, req: ServeRequest) -> bool:
        return (req.state is State.RUNNING and req.engine_id == self.id
                and any(r is req for r in self.eng.slots))

    def can_accept(self, req: ServeRequest) -> bool:
        return self.eng.can_accept(req)


class _ServerOps:
    """``repro_torch.control.protocol.ClusterOps`` over the engine pool:
    dispatch is an engine submit, migration a synchronous export ->
    import -> evict of the request's actual KV piece (a copy between two
    pools on the same device)."""

    def __init__(self, server: "MILSServer"):
        self.server = server

    def dispatch(self, req: ServeRequest, instance_id: int) -> None:
        self.server.engines[instance_id].submit(req)

    def start_migration(self, req: ServeRequest, src_id: int,
                        dst_id: int) -> str:
        server = self.server
        if src_id in server.crashed or dst_id in server.crashed:
            return MIG_FAILED      # either endpoint's process is gone
        if server.injector is not None:
            fate = server.injector.transfer_event(req.req_id)
            if fate != XFER_OK:
                # lost/stalled wire: report MIG_STARTED now (the plane logs
                # "migrate") and deliver the failure at the deadline; the
                # request never leaves its source
                horizon = server.cfg.migration_timeout_steps * (
                    2 if fate == XFER_STALL else 1)
                server._doomed.append((server.steps + horizon, req.req_id))
                return MIG_STARTED
        src = server.engines[src_id]
        dst = server.engines[dst_id]
        slot = req.slot
        if slot is None or src.slots[slot] is not req:
            return MIG_FAILED
        _, piece, nbytes = src.export_slot(slot)
        if not dst.import_request(req, piece):
            return MIG_FAILED
        src.evict_slot(slot)
        server.migrated_bytes += nbytes
        return MIG_COMPLETED

    def set_boundary(self, stage_idx: int, hi: float) -> None:
        pass                        # the core's bounds are authoritative

    # ---- fault tolerance -----------------------------------------------------
    def redispatch(self, req: ServeRequest, instance_id: int) -> bool:
        """Recover a resident of a dead engine: its KV died with the
        process, so replay prompt + generated-so-far through chunked
        prefill on ``instance_id`` — the recompute-resume path
        (``Engine._finish_resume``), so the continuation is the one a
        never-crashed run decodes. A mid-decode resume needs a chunking
        engine: a whole-prompt one refuses it."""
        dst = self.server.engines[instance_id]
        req.redispatches += 1
        req.slot = None
        req.engine_id = None
        req.ctx_done = 0
        req.cached_tokens = 0
        if req.generated:
            if not dst.chunked_prefill:
                return False       # a mid-decode resume needs chunking
            req.prefill_target = len(req.prompt) + len(req.generated) - 1
            req.resume_tokens = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated[:-1], np.int32)])
        else:
            req.prefill_target = None
            req.resume_tokens = None
        req.state = State.WAITING
        dst.submit(req)
        return True

    def fail_request(self, req: ServeRequest) -> None:
        req.failed = True
        req.state = State.FINISHED
        req.finish_step = self.server.steps
        # completion of a sort: the drain loop must terminate
        self.server.finished.append(req)

    def instance_down(self, instance_id: int) -> None:
        # replace the carcass with a fresh engine so a later rejoin
        # starts empty (the plane snapshotted the residents already)
        self.server._reset_engine(instance_id)


class MILSServer:
    def __init__(self, model, params, plan: PipelinePlan,
                 qoe: Optional[QoEModel], cfg: ServerConfig, *,
                 max_slots: int = 4, max_seq: int = 256,
                 paged: Optional[bool] = None, block_size: int = 16,
                 device_resident: Optional[bool] = None,
                 attn_backend: Optional[str] = None,
                 prefill_token_budget: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 host_kv_budget: Optional[int] = None,
                 tp: Any = 1, tp_devices: Optional[Sequence[str]] = None,
                 tp_backend: Optional[str] = None,
                 engine_factory: Optional[Callable[[int], Any]] = None,
                 on_token: Optional[TokenCallback] = None):
        """Engines run on the device of ``params`` (every engine shares
        them) unless ``engine_factory(i)`` builds them; constructor
        arguments override the ``ServerConfig``'s. ``tp`` gives every
        engine that many tensor-parallel ranks, or engine i ``tp[i]`` (a
        heterogeneous cluster, e.g. ``(2, 1, 1)``): the control plane
        weighs each engine by its ``tp`` in stage claiming and load
        normalisation. Each ``tp > 1`` engine makes a mesh of its own on
        the first ``tp`` of ``tp_devices`` over ``tp_backend``
        (``launch.mesh.make_tp_mesh``'s defaults when None)."""
        self.cfg = cfg
        self.plan = plan
        self.on_token = on_token
        attn_backend = attn_backend or cfg.attn_backend
        kv_dtype = kv_dtype or cfg.kv_dtype
        host_kv_budget = (cfg.host_kv_budget if host_kv_budget is None
                          else int(host_kv_budget))
        if isinstance(tp, (list, tuple)):
            tps = [int(x) for x in tp]
            if len(tps) != plan.num_instances:
                raise ValueError(f"tp has {len(tps)} entries for "
                                 f"{plan.num_instances} engines")
        else:
            tps = [int(tp)] * plan.num_instances
        self.tps = tps
        if engine_factory is None:
            def engine_factory(i):
                return Engine(i, model, params, max_slots=max_slots,
                              max_seq=max_seq, paged=paged,
                              block_size=block_size,
                              device_resident=device_resident,
                              prefill_token_budget=prefill_token_budget,
                              chunked_prefill=chunked_prefill,
                              prefix_cache=prefix_cache,
                              attn_backend=attn_backend, kv_dtype=kv_dtype,
                              host_kv_budget=host_kv_budget,
                              preemption=cfg.preemption,
                              slo_time_scale=cfg.slo_time_scale,
                              tp=tps[i], tp_devices=(
                                  None if tp_devices is None
                                  else list(tp_devices)[:tps[i]]),
                              tp_backend=tp_backend)
        self._engine_factory = engine_factory
        self.engines = [engine_factory(i)
                        for i in range(plan.num_instances)]
        self.plane = ControlPlane(
            plan, qoe,
            ControlConfig(policy=cfg.policy, refinement=cfg.refinement,
                          balancing=cfg.balancing,
                          max_migrations_per_tick=cfg.max_migrations_per_step,
                          seed=cfg.seed,
                          suspect_after=float(cfg.suspect_after_steps),
                          dead_after=float(cfg.dead_after_steps),
                          redispatch_budget=cfg.redispatch_budget),
            ops=_ServerOps(self),
            instances=[EngineView(e) for e in self.engines])
        self.steps = 0
        self.finished: List[ServeRequest] = []
        self.submitted = 0
        self.migrated_bytes = 0.0
        # ---- fault state ----
        self.injector = (FaultInjector(cfg.faults)
                         if cfg.faults is not None else None)
        self.crashed: Dict[int, int] = {}        # engine id -> crash step
        self.downtime_steps: Dict[int, int] = {}
        self._doomed: List[Tuple[int, int]] = []  # (fail_at_step, req_id)
        # open-loop arrival schedule: (step, seq, request)
        self._schedule: List[Tuple[int, int, ServeRequest]] = []
        self._seq = 0
        self._emitted: Dict[int, int] = {}   # req_id -> tokens streamed

    # ---- observability -------------------------------------------------------
    @property
    def stage_bounds(self) -> List[Tuple[float, float]]:
        return self.plane.bounds()

    @property
    def migrations(self) -> int:
        return self.plane.migrations

    # ---- intake --------------------------------------------------------------
    def _prefix_hint(self, req: ServeRequest):
        """(head_digest, best cached tokens, promote price in token units)
        across the engine pool — the dispatch hint cache-aware routing
        consumes; ties on cached tokens prefer the cheaper instance."""
        digest, cached, price = None, 0.0, 0.0
        for eng in self.engines:
            d, c, promo = eng.prefix_hint(req)
            p = promote_cost_tokens(promo, eng.block_size)
            if d is not None:
                digest = d
            if (float(c), -p) > (cached, -price):
                cached, price = float(c), p
        return digest, cached, price

    def _arrive(self, req: ServeRequest) -> None:
        req.arrival_step = self.steps
        digest, cached, price = self._prefix_hint(req)
        self.plane.submit(req, req.req_id, float(len(req.prompt)),
                          cached_tokens=cached, prefix_digest=digest,
                          promote_cost_tokens=price,
                          slo_class=req.slo_class)

    def submit(self, req: ServeRequest) -> None:
        """Closed-loop submission: the request arrives now."""
        self.submitted += 1
        self._arrive(req)

    def submit_at(self, req: ServeRequest, step: int) -> None:
        """Open-loop submission: the request arrives at ``step``."""
        self.submitted += 1
        heapq.heappush(self._schedule, (int(step), self._seq, req))
        self._seq += 1

    def _release_arrivals(self) -> None:
        while self._schedule and self._schedule[0][0] <= self.steps:
            self._arrive(heapq.heappop(self._schedule)[2])

    # ---- token streaming -----------------------------------------------------
    def _stream(self, reqs: Sequence[ServeRequest]) -> None:
        if self.on_token is None:
            return
        for r in reqs:
            n = self._emitted.get(r.req_id, 0)
            for tok in r.generated[n:]:
                self.on_token(r, tok)
            self._emitted[r.req_id] = len(r.generated)

    # ---- faults -----------------------------------------------------------
    def _crash(self, iid: int) -> None:
        """Scripted hard kill: the engine stops stepping and heartbeating;
        the plane's liveness machinery discovers the death and recovers
        its residents."""
        self.crashed[iid] = self.steps
        self.engines[iid]._faulted = True

    def _reset_engine(self, iid: int) -> None:
        """Swap in a fresh engine (the plane's ``instance_down``, or a
        rejoin): the old process' state is unreachable. The old pool is
        dropped BEFORE the new one is made, so the card never holds two
        full-width pools for one engine slot."""
        old = self.engines[iid]
        old._faulted = True
        old.close()
        fresh = self._engine_factory(iid)
        self.engines[iid] = fresh
        self.plane.instances[iid] = EngineView(fresh)

    def _revive(self, iid: int) -> None:
        self._reset_engine(iid)
        self.crashed.pop(iid, None)
        # the plane learns of the rejoin from the next heartbeat

    def _inject_faults(self) -> None:
        if self.injector is None:
            return
        # all_crashes folds correlated rack events into the per-instance
        # schedule: several engines can die in the same step
        for iid, at in self.cfg.faults.all_crashes:
            if int(at) == self.steps and iid not in self.crashed:
                self._crash(iid)
        for iid, at in self.cfg.faults.rejoins:
            if int(at) == self.steps and iid in self.crashed:
                self._revive(iid)
        # deliver due wire deadlines (lost/stalled transfers)
        due = [r for s, r in self._doomed if s <= self.steps]
        self._doomed = [(s, r) for s, r in self._doomed if s > self.steps]
        for rid in due:
            self.plane.migration_failed(rid)

    def _engine_runs_this_step(self, eng) -> bool:
        if eng.id in self.crashed:
            self.downtime_steps[eng.id] = \
                self.downtime_steps.get(eng.id, 0) + 1
            return False
        if self.injector is not None:
            f = self.injector.slowdown(eng.id)
            if f > 1.0 and self.steps % max(int(round(f)), 1) != 0:
                return False       # slow instance: skips iterations
        return True

    # ---- main loop -----------------------------------------------------------
    def step(self) -> List[ServeRequest]:
        """One tick: arrivals, scripted faults, one iteration of every
        running engine, then the control plane (heartbeats and liveness
        when faults are on, handover, periodic balance and refinement, and
        a pump of deferred offers)."""
        self._release_arrivals()
        self.steps += 1
        self._inject_faults()
        done: List[ServeRequest] = []
        for eng in self.engines:
            if not self._engine_runs_this_step(eng):
                continue
            fin = eng.step()
            done.extend(fin)
            self._stream(eng.active())
            self._stream(fin)
        self.finished.extend(done)
        for r in done:
            self._emitted.pop(r.req_id, None)
        if self.cfg.policy == "cascade":
            self.plane.begin_tick()
            if self.cfg.faults is not None:
                for eng in self.engines:
                    if eng.id not in self.crashed:
                        self.plane.heartbeat(eng.id, float(self.steps))
                self.plane.check_liveness(float(self.steps))
            self.plane.handover_all()
            if self.steps % self.cfg.balance_every == 0:
                self.plane.balance()
            if self.steps % self.cfg.refine_every == 0:
                self.plane.refine()
            # retry offers deferred by §5 flow control / the tick budget
            self.plane.pump_all()
        return done

    def run(self, requests: Sequence[ServeRequest] = (),
            max_steps: int = 2000, drain: bool = True) -> List[ServeRequest]:
        """Drive the arrival schedule (plus any ``requests`` submitted
        now). With ``drain`` (default) keep stepping until every submitted
        request finished, then assert every live engine drained clean."""
        for r in requests:
            self.submit(r)
        while self.steps < max_steps:
            if not self._schedule and (not drain
                                       or len(self.finished)
                                       >= self.submitted):
                break
            self.step()
        if drain and len(self.finished) >= self.submitted:
            for eng in self.engines:
                if eng.id not in self.crashed:
                    eng.check_drained(strict=True)
        return self.finished

    def close(self) -> None:
        """Close every engine (a tensor-parallel one ends its workers)."""
        for eng in self.engines:
            eng.close()

    # ---- metrics -------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        fin = self.finished
        if not fin:
            return {"finished": 0}
        # rejected/failed requests never finished normal service: their
        # timestamps would fake latencies
        served = [r for r in fin if not r.rejected and not r.failed]
        out: Dict[str, float] = {
            "finished": len(fin),
            "steps": self.steps,
            "migrations": self.migrations,
            "migrated_bytes": self.migrated_bytes,
            "tokens_out": int(sum(e.tokens_out for e in self.engines)),
        }
        out.update(fault_summary(
            ((r.rejected, r.failed, r.redispatches) for r in fin),
            retries=self.plane.retries,
            downtime={i: float(s) for i, s in self.downtime_steps.items()
                      if s}))
        for (a, b), n in sorted(self.plane.migrations_by_stage.items()):
            out[f"migrations_s{a}_to_s{b}"] = n
        if served:
            ttft = np.asarray([r.first_token_step - r.arrival_step
                               for r in served], np.float64)
            e2e = np.asarray([r.finish_step - r.arrival_step
                              for r in served], np.float64)
            for name, arr in (("ttft_steps", ttft), ("e2e_steps", e2e)):
                out[f"{name}_mean"] = float(arr.mean())
                for p in (50, 95, 99):
                    out[f"{name}_p{p}"] = float(np.percentile(arr, p))
        entries = []
        for r in served:
            ttft_r = float(r.first_token_step - r.arrival_step)
            tpot_r = (float(r.finish_step - r.first_token_step)
                      / max(len(r.generated) - 1, 1))
            entries.append((r.slo_class, ttft_r, tpot_r, len(r.generated)))
        per = class_slo_summary(entries, float(self.steps),
                                scale=self.cfg.slo_scale,
                                time_scale=self.cfg.slo_time_scale)
        for cls, d in sorted(per.items()):
            out[f"slo_{cls}_attainment"] = d["attainment"]
            out[f"slo_{cls}_goodput_tok_step"] = d["goodput_tok_s"]
            out[f"slo_{cls}_requests"] = d["requests"]
        for k in ("preemptions", "preempt_recomputes", "resumes",
                  "tpot_skipped", "cache_demotions", "cache_drops",
                  "cache_promotions", "promoted_blocks_total"):
            out[k] = sum(getattr(e, k) for e in self.engines)
        return out


def requests_from_trace(trace: Sequence[Request], *, vocab_size: int,
                        steps_per_second: float = 1.0,
                        max_seq: Optional[int] = None,
                        seed: int = 0) -> List[Tuple[ServeRequest, int]]:
    """A ``sim.workload`` trace as (ServeRequest, arrival_step) pairs:
    input_len becomes a random prompt of that length, output_len the
    token budget, arrival times map to steps at ``steps_per_second``;
    ``max_seq`` caps lengths to what the engines hold. Requests of one
    shared-prefix group start with the same literal tokens, so the
    engines' content-hashed prefix cache hits where the groups say."""
    rng = np.random.default_rng(seed)
    prefixes: Dict[int, np.ndarray] = {}
    out = []
    for r in trace:
        plen, new = int(r.input_len), int(r.output_len)
        pg = r.prefix_group
        pfx_len = int(r.prefix_len) if pg >= 0 else 0
        if max_seq is not None:
            plen = max(1, min(plen, max_seq // 2))
            new = max(1, min(new, max_seq - plen - 1))
            pfx_len = min(pfx_len, max(plen - 1, 0))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        if pfx_len > 0:
            if pg not in prefixes:
                # one draw at the group's FULL prefix length: a capped
                # replay still shares the same leading tokens
                prefixes[pg] = rng.integers(
                    0, vocab_size, int(r.prefix_len)).astype(np.int32)
            prompt[:pfx_len] = prefixes[pg][:pfx_len]
        req = ServeRequest(r.req_id, prompt, new)
        req.prefix_group = pg
        req.prefix_len = pfx_len
        req.slo_class = r.slo_class
        out.append((req, int(round(r.arrival * steps_per_second))))
    return out
