"""SLO classes and the deadline- and size-aware queue order — the
port's own copy of ``repro.sched.slo`` (framework-free, so it is copied,
not imported).

Three service classes, each with a TTFT and a TPOT deadline in abstract
seconds; the server measures time in steps and converts with a
``slo_time_scale`` (steps per abstract second). The waiting-queue order
is ``queue_key``: strict priority first, then the request's TTFT
deadline (earliest-deadline-first within a class), then size
(shortest-job-first tie-break), then a submission sequence number. With a
uniform class and distinct arrival times this is exact FCFS.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service class: smaller ``priority`` is served first."""
    name: str
    priority: int
    ttft_slo: float      # time-to-first-token budget (abstract seconds)
    tpot_slo: float      # per-output-token budget (abstract seconds)


SLO_CLASSES: Dict[str, SLOSpec] = {
    "interactive": SLOSpec("interactive", 0, ttft_slo=0.5, tpot_slo=0.05),
    "standard": SLOSpec("standard", 1, ttft_slo=2.0, tpot_slo=0.2),
    "batch": SLOSpec("batch", 2, ttft_slo=30.0, tpot_slo=2.0),
}
DEFAULT_CLASS = "standard"


def slo_of(slo_class: str) -> SLOSpec:
    """Spec for a class name; unknown names fall back to ``standard``."""
    return SLO_CLASSES.get(slo_class, SLO_CLASSES[DEFAULT_CLASS])


def priority_of(slo_class: str) -> int:
    return slo_of(slo_class).priority


def queue_key(slo_class: str, arrival: float, size: float, seq: int,
              *, time_scale: float = 1.0,
              promote: int = 0) -> Tuple[int, float, float, int]:
    """Waiting-queue sort key: (priority, TTFT deadline, size, seq).

    ``time_scale`` converts the spec's abstract-seconds budget into the
    caller's clock (1.0 for the sim, steps-per-second for the engine).

    ``promote`` is the starvation/aging guard (DESIGN.md §SLO sched): a
    recompute-preempted request that keeps waiting climbs one priority
    class per promotion step, floored at the top class — so saturated
    high-class traffic can delay but never permanently starve a victim.
    """
    spec = slo_of(slo_class)
    deadline = float(arrival) + spec.ttft_slo * float(time_scale)
    return (max(spec.priority - int(promote), 0), deadline,
            float(size), int(seq))


def aging_promotion(slo_class: str, preempted_at: float, now: float,
                    *, time_scale: float = 1.0) -> int:
    """Starvation guard for recompute-preempted requests: priority
    classes earned by queue age — one per full TTFT budget elapsed since
    the preemption. A just-preempted request keeps its class (promotion
    0, bit-identical short-run behavior); one that has waited a whole
    TTFT budget outranks fresh same-class arrivals, and after enough
    budgets it reaches the top class — so saturated high-class traffic
    can delay but never permanently starve a victim. Shared by the
    engine and the sim so decision logs stay comparable."""
    spec = slo_of(slo_class)
    budget = max(spec.ttft_slo * float(time_scale), 1e-9)
    return int(max(float(now) - float(preempted_at), 0.0) / budget)


def tpot_hopeless(slo_class: str, first_token: float, now: float,
                  total_new_tokens: int, *,
                  time_scale: float = 1.0) -> bool:
    """Has this decode already blown its TPOT deadline beyond recovery?

    True when even finishing the REMAINING tokens instantly could not
    bring the mean per-token latency back under ``tpot_slo``: the time
    already elapsed since the first token exceeds the budget for the
    request's entire output. Such a request is a lost cause for TPOT
    attainment — preempting healthy traffic to serve it buys nothing, so
    admission control skips it as a preemptor (it still runs and
    finishes; it just can't evict others)."""
    spec = slo_of(slo_class)
    budget = spec.tpot_slo * float(time_scale) * max(
        int(total_new_tokens) - 1, 1)
    return (float(now) - float(first_token)) > budget


def insert_sorted(queue: List, item) -> None:
    """Insert ``item`` into ``queue`` keeping it sorted by ``.sched_key``.

    Stable for equal keys (new item goes after existing equals), so a
    uniform-class stream with distinct seq numbers is plain FCFS.
    """
    keys = [q.sched_key for q in queue]
    queue.insert(bisect.bisect_right(keys, item.sched_key), item)


def parse_class_mix(text: str) -> Tuple[Tuple[str, float], ...]:
    """Parse ``"interactive=0.5,standard=0.3,batch=0.2"`` (``:`` also
    accepted as the separator) into normalized (class, weight) pairs.
    Raises on unknown classes or no mass."""
    pairs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        sep = "=" if "=" in part else ":"
        name, _, w = part.partition(sep)
        name = name.strip()
        if name not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {name!r} "
                             f"(known: {sorted(SLO_CLASSES)})")
        pairs.append((name, float(w) if w else 1.0))
    total = sum(w for _, w in pairs)
    if not pairs or total <= 0:
        raise ValueError(f"empty or zero-mass class mix: {text!r}")
    return tuple((n, w / total) for n, w in pairs)


def assign_classes(n: int, mix: Sequence[Tuple[str, float]], rng) -> List[str]:
    """Draw ``n`` class labels i.i.d. from a (class, weight) mix."""
    names = [m[0] for m in mix]
    probs = [m[1] for m in mix]
    total = sum(probs)
    probs = [p / total for p in probs]
    idx = rng.choice(len(names), size=n, p=probs)
    return [names[int(i)] for i in idx]
