"""The port's copy of the SLO and failure-accounting formulas of
``repro.sim.metrics`` (framework-free): per-class attainment and
goodput-under-SLO, and the rejected/failed/redispatched/retries/downtime
counts, which ``MILSServer.summary`` reports. SLO entries are
(slo_class, ttft, tpot, output_tokens) in abstract time units;
``time_scale`` converts the spec deadlines into the caller's clock (steps
per unit for the server) and ``scale`` is the paper's SLO-scale sweep
knob (§6.4)."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.sched.slo import slo_of


def _slo_ok(ttft: float, tpot: float, ttft_slo: float, tpot_slo: float,
            scale: float = 1.0) -> bool:
    return ttft <= scale * ttft_slo and tpot <= scale * tpot_slo


def class_slo_summary(entries: Iterable[Tuple[str, float, float, int]],
                      duration: float, *, scale: float = 1.0,
                      time_scale: float = 1.0) -> Dict[str, Dict[str, float]]:
    """Per-SLO-class attainment and goodput-under-SLO: each class is
    judged against ITS OWN deadlines (``SLO_CLASSES``, times
    ``time_scale`` then ``scale``); goodput counts only tokens of requests
    that met their class SLO."""
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


def fault_summary(flags: Iterable[Tuple[bool, bool, int]], *,
                  retries: int = 0,
                  downtime: Optional[Dict[int, float]] = None
                  ) -> Dict[str, float]:
    """Failure accounting of a run: ``flags`` are (rejected, failed,
    redispatches) per finished request; ``retries`` the control plane's
    failed migration attempts; ``downtime`` per-instance time down."""
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
