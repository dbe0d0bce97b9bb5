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

Not ported yet (they return with the engine's preemption, host tier, int8
KV and tensor parallelism): fault injection and crash recovery, SLO
preemption, the host KV tier, ``kv_dtype`` and ``tp``. ``summary()``
reports none of their counters.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import (MIG_COMPLETED, MIG_FAILED, ControlConfig,
                                 ControlPlane, ReqView)
from repro_torch.core.partition import PipelinePlan
from repro_torch.core.qoe import QoEModel
from repro_torch.kernels.cost import promote_cost_tokens
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest, State
from repro_torch.sim.metrics import class_slo_summary
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
    attn_backend: Optional[str] = None  # flat | fused | None = fused
    slo_scale: float = 1.0             # paper §6.4 SLO-scale sweep knob
    slo_time_scale: float = 1.0        # engine steps per abstract SLO second


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

    def requests(self) -> List[ReqView]:
        return [_req_view(r) for r in self.eng.slots if r is not None]

    def prefix_digests(self) -> frozenset:
        return self.eng.prefix_digests()

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
        src = self.server.engines[src_id]
        dst = self.server.engines[dst_id]
        slot = req.slot
        if slot is None or src.slots[slot] is not req:
            return MIG_FAILED
        _, piece, nbytes = src.export_slot(slot)
        if not dst.import_request(req, piece):
            return MIG_FAILED
        src.evict_slot(slot)
        self.server.migrated_bytes += nbytes
        return MIG_COMPLETED

    def set_boundary(self, stage_idx: int, hi: float) -> None:
        pass                        # the core's bounds are authoritative


class MILSServer:
    def __init__(self, model, params, plan: PipelinePlan,
                 qoe: Optional[QoEModel], cfg: ServerConfig, *,
                 max_slots: int = 4, max_seq: int = 256, block_size: int = 16,
                 attn_backend: Optional[str] = None,
                 prefill_token_budget: Optional[int] = None,
                 engine_factory: Optional[Callable[[int], Any]] = None,
                 on_token: Optional[TokenCallback] = None):
        """Engines run on the device of ``params`` (every engine shares
        them) unless ``engine_factory(i)`` builds them."""
        self.cfg = cfg
        self.plan = plan
        self.on_token = on_token
        attn_backend = attn_backend or cfg.attn_backend
        if engine_factory is None:
            def engine_factory(i):
                return Engine(i, model, params, max_slots=max_slots,
                              max_seq=max_seq, block_size=block_size,
                              prefill_token_budget=prefill_token_budget,
                              attn_backend=attn_backend)
        self.engines = [engine_factory(i)
                        for i in range(plan.num_instances)]
        self.plane = ControlPlane(
            plan, qoe,
            ControlConfig(policy=cfg.policy, refinement=cfg.refinement,
                          balancing=cfg.balancing,
                          max_migrations_per_tick=cfg.max_migrations_per_step,
                          seed=cfg.seed),
            ops=_ServerOps(self),
            instances=[EngineView(e) for e in self.engines])
        self.steps = 0
        self.finished: List[ServeRequest] = []
        self.submitted = 0
        self.migrated_bytes = 0.0
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

    # ---- main loop -----------------------------------------------------------
    def step(self) -> List[ServeRequest]:
        """One tick: arrivals, one iteration of every engine, then the
        control plane (handover, periodic balance and refinement, and a
        pump of deferred offers)."""
        self._release_arrivals()
        self.steps += 1
        done: List[ServeRequest] = []
        for eng in self.engines:
            fin = eng.step()
            done.extend(fin)
            self._stream(eng.active())
            self._stream(fin)
        self.finished.extend(done)
        for r in done:
            self._emitted.pop(r.req_id, None)
        if self.cfg.policy == "cascade":
            self.plane.begin_tick()
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
        request finished, then assert every engine drained clean."""
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
                eng.check_drained(strict=True)
        return self.finished

    # ---- metrics -------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        fin = self.finished
        if not fin:
            return {"finished": 0}
        # rejected requests never finished normal service: their
        # timestamps would fake latencies
        served = [r for r in fin if not r.rejected]
        out: Dict[str, float] = {
            "finished": len(fin),
            "rejected": len(fin) - len(served),
            "steps": self.steps,
            "migrations": self.migrations,
            "migrated_bytes": self.migrated_bytes,
            "tokens_out": int(sum(e.tokens_out for e in self.engines)),
        }
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
