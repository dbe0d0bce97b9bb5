"""Metrics over a simulation run (paper §6.1: TTFT, TPOT, throughput,
SLO attainment; Fig. 16: per-stage output-token CV) — the port's copy of
``repro.sim.metrics``, whole. ``class_slo_summary`` and ``fault_summary``
are also what ``MILSServer.summary`` reports, so the simulator and the
server share one formula each."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.sched.slo import slo_of
from repro_torch.sim.instance import Instance, SimRequest


# --------------------------------------------------------------------------
# SLO attainment & goodput-under-SLO (paper §6.4) — module-level single
# source of truth: `SimResult.slo_attainment`/`slo_summary` AND
# `serving.MILSServer.summary` both call these, so there is exactly ONE
# SLO formula in the codebase. Entries are (slo_class, ttft, tpot,
# output_tokens) in abstract time units; ``time_scale`` converts the spec
# deadlines into the caller's clock (1.0 for the sim, steps-per-unit for
# the server) and ``scale`` is the paper's SLO-scale sweep knob.
# --------------------------------------------------------------------------
def _slo_ok(ttft: float, tpot: float, ttft_slo: float, tpot_slo: float,
            scale: float = 1.0) -> bool:
    return ttft <= scale * ttft_slo and tpot <= scale * tpot_slo


def slo_attainment(entries: Iterable[Tuple[float, float]],
                   ttft_slo: float, tpot_slo: float,
                   scale: float = 1.0) -> float:
    """Fraction of (ttft, tpot) pairs meeting a fixed SLO pair."""
    entries = list(entries)
    if not entries:
        return 0.0
    ok = sum(1 for ttft, tpot in entries
             if _slo_ok(ttft, tpot, ttft_slo, tpot_slo, scale))
    return ok / len(entries)


def class_slo_summary(entries: Iterable[Tuple[str, float, float, int]],
                      duration: float, *, scale: float = 1.0,
                      time_scale: float = 1.0) -> Dict[str, Dict[str, float]]:
    """Per-SLO-class attainment and goodput-under-SLO.

    ``entries`` are (slo_class, ttft, tpot, output_tokens) per served
    request; each class is judged against ITS OWN deadlines
    (repro_torch.sched.slo.SLO_CLASSES, times ``time_scale`` then ``scale``).
    Goodput counts only tokens of requests that met their class SLO —
    the metric the preemptive scheduler is accepted on.
    """
    per: Dict[str, Dict[str, float]] = {}
    for cls, ttft, tpot, out_tokens in entries:
        spec = slo_of(cls)
        d = per.setdefault(spec.name, {"requests": 0, "slo_ok": 0,
                                       "tokens": 0, "goodput_tokens": 0})
        ok = _slo_ok(ttft, tpot, spec.ttft_slo * time_scale,
                     spec.tpot_slo * time_scale, scale)
        d["requests"] += 1
        d["slo_ok"] += int(ok)
        d["tokens"] += int(out_tokens)
        if ok:
            d["goodput_tokens"] += int(out_tokens)
    dur = max(float(duration), 1e-9)
    for d in per.values():
        d["attainment"] = d["slo_ok"] / max(d["requests"], 1)
        d["goodput_tok_s"] = d["goodput_tokens"] / dur
    return per


# --------------------------------------------------------------------------
# Failure accounting (DESIGN.md §Fault tolerance) — module-level single
# source of truth, like class_slo_summary above: `SimResult.fault_summary`
# AND `serving.MILSServer.summary` both call this, so sim and server
# report chaos runs through exactly ONE formula. ``flags`` is one
# (rejected, failed, redispatches) triple per terminal request;
# ``retries`` is the plane's count of backoff'd migration failures;
# ``downtime`` maps instance id -> accumulated down time in the caller's
# clock (sim seconds / server steps).
# --------------------------------------------------------------------------
def fault_summary(flags: Iterable[Tuple[bool, bool, int]], *,
                  retries: int = 0,
                  downtime: Optional[Dict[int, float]] = None
                  ) -> Dict[str, float]:
    rejected = failed = redispatched = 0
    for rej, fail, redisp in flags:
        rejected += int(bool(rej))
        failed += int(bool(fail))
        redispatched += int(redisp > 0)
    out: Dict[str, float] = {
        "rejected": rejected,
        "failed": failed,
        "redispatched": redispatched,
        "retries": int(retries),
    }
    downtime = downtime or {}
    out["downtime_total"] = float(sum(downtime.values()))
    for iid in sorted(downtime):
        out[f"downtime_i{iid}"] = float(downtime[iid])
    return out


@dataclasses.dataclass
class SimResult:
    completed: List[SimRequest]
    duration: float
    num_submitted: int
    instances: List[Instance]
    policy_name: str
    stage_of_instance: Optional[List[int]] = None
    retries: int = 0                 # plane-counted migration retries

    # ---- latency ----------------------------------------------------------
    @property
    def served(self):
        return [r for r in self.completed
                if not r.rejected and not r.failed]

    def _arr(self, fn) -> np.ndarray:
        return np.asarray([fn(r) for r in self.served], np.float64)

    def ttft(self) -> np.ndarray:
        return self._arr(lambda r: r.ttft)

    def tpot(self) -> np.ndarray:
        return self._arr(lambda r: r.tpot)

    def normalized_latency(self) -> np.ndarray:
        return self._arr(lambda r: r.normalized_latency)

    def fault_summary(self) -> Dict[str, float]:
        """Failure accounting for the run (shared formula with the real
        server — see module-level ``fault_summary``)."""
        return fault_summary(
            ((r.rejected, r.failed, r.redispatches) for r in self.completed),
            retries=self.retries,
            downtime={i.id: i.downtime_s(self.duration)
                      for i in self.instances if i.downtime_s(self.duration)})

    def summary(self) -> Dict[str, float]:
        ttft, tpot = self.ttft(), self.tpot()
        nl = self.normalized_latency()
        out = {
            "policy": self.policy_name,
            "completed": len(self.served),
            "submitted": self.num_submitted,
            "ttft_mean": float(ttft.mean()) if len(ttft) else float("nan"),
            "ttft_p95": float(np.percentile(ttft, 95)) if len(ttft) else float("nan"),
            "tpot_mean": float(tpot.mean()) if len(tpot) else float("nan"),
            "tpot_p95": float(np.percentile(tpot, 95)) if len(tpot) else float("nan"),
            "norm_latency_mean": float(nl.mean()) if len(nl) else float("nan"),
            "throughput_tok_s": self.throughput(),
        }
        out.update(self.fault_summary())
        # multi-tier KV traffic (DESIGN.md §Multi-tier KV); getattr keeps
        # pre-tier Instance stand-ins (test doubles) summarizable
        for k in ("cache_demotions", "cache_drops", "cache_promotions",
                  "promoted_blocks_total"):
            out[k] = sum(getattr(i, k, 0) for i in self.instances)
        return out

    # ---- throughput -------------------------------------------------------
    def throughput(self) -> float:
        toks = sum(r.req.output_len for r in self.served)
        return toks / max(self.duration, 1e-9)

    # ---- SLO (paper §6.4) --------------------------------------------------
    def slo_attainment(self, ttft_slo: float, tpot_slo: float,
                       scale: float = 1.0) -> float:
        return slo_attainment(((r.ttft, r.tpot) for r in self.served),
                              ttft_slo, tpot_slo, scale)

    def slo_summary(self, scale: float = 1.0) -> Dict[str, Dict[str, float]]:
        """Per-class SLO attainment + goodput-under-SLO over the run
        (classes judged against their own SLO_CLASSES deadlines)."""
        return class_slo_summary(
            ((r.req.slo_class, r.ttft, r.tpot, r.req.output_len)
             for r in self.served),
            self.duration, scale=scale)

    def preemption_stats(self) -> Dict[str, int]:
        return {
            "preemptions": sum(i.preemptions for i in self.instances),
            "preempt_recomputes": sum(i.preempt_recomputes
                                      for i in self.instances),
            "resumes": sum(i.resumes for i in self.instances),
            "tpot_skipped": sum(getattr(i, "tpot_skipped", 0)
                                for i in self.instances),
        }

    # ---- load balance (paper Fig. 16) ---------------------------------------
    def output_tokens_by_instance(self) -> np.ndarray:
        n = len(self.instances)
        out = np.zeros(n)
        for r in self.completed:
            for iid, cnt in r.tokens_by_instance.items():
                out[iid] += cnt
        return out

    def stage_cv(self) -> List[float]:
        """Coefficient of variation of per-instance output tokens, per stage
        (lower = better balanced). Falls back to one global stage."""
        toks = self.output_tokens_by_instance()
        if self.stage_of_instance is None:
            groups = {0: list(range(len(self.instances)))}
        else:
            groups = {}
            for iid, si in enumerate(self.stage_of_instance):
                groups.setdefault(si, []).append(iid)
        cvs = []
        for si in sorted(groups):
            vals = toks[groups[si]]
            mu = vals.mean()
            cvs.append(float(vals.std() / mu) if mu > 0 else 0.0)
        return cvs
