"""Workload generation: ShareGPT-shaped length distributions + Poisson
arrivals (paper §6.1).

The real ShareGPT trace is offline-unavailable here; the generator
reproduces its documented shape — a log-normal body of short/medium
dialogue turns with a Pareto long-context tail (paper Fig. 1 skew),
truncated at the 128K context window. Drop in a real trace via
``trace_requests`` if one is available.

The port's copy of ``repro.sim.workload``, whole (framework-free).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAX_CONTEXT = 131_072


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    arrival: float
    input_len: int
    output_len: int
    # shared-prefix identity (DESIGN.md §Prefix cache): requests with the
    # same non-negative ``prefix_group`` share their first ``prefix_len``
    # prompt tokens (a system prompt / earlier conversation turns). -1 =
    # no shared prefix. The simulator's group-granular cache model and the
    # server replay (literal shared tokens) both key on these.
    prefix_group: int = -1
    prefix_len: int = 0
    # SLO service class (repro_torch.sched.slo.SLO_CLASSES): drives queue
    # ordering and preemption eligibility in both sim and real engines.
    slo_class: str = "standard"

    @property
    def final_len(self) -> int:
        return self.input_len + self.output_len


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    rate: float                    # Poisson arrivals/s
    duration: float                # seconds of arrivals
    seed: int = 0
    # log-normal body (ShareGPT-ish medians ~ 700 in / 250 out)
    in_mu: float = 6.3
    in_sigma: float = 1.3
    out_mu: float = 5.3
    out_sigma: float = 1.0
    # Pareto long-context tail
    tail_frac: float = 0.06
    tail_alpha: float = 1.1
    tail_scale: float = 8000.0
    # distribution drift (paper §4.3 motivation): in_mu shifts by drift_mu
    # over the run -> the offline plan goes stale, refinement must adapt
    drift_mu: float = 0.0
    max_context: int = MAX_CONTEXT


def sample_lengths(spec: WorkloadSpec, n: int,
                   rng: np.random.Generator,
                   phase: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    mu = spec.in_mu + (spec.drift_mu * phase if phase is not None else 0.0)
    ins = rng.lognormal(mu, spec.in_sigma, n)
    tail = rng.random(n) < spec.tail_frac
    pareto = spec.tail_scale * (1 + rng.pareto(spec.tail_alpha, n))
    ins = np.where(tail, pareto, ins)
    outs = rng.lognormal(spec.out_mu, spec.out_sigma, n)
    ins = np.clip(ins, 16, spec.max_context - 64).astype(np.int64)
    outs = np.clip(outs, 8, None).astype(np.int64)
    outs = np.minimum(outs, spec.max_context - ins)
    return ins, outs


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    n = max(1, rng.poisson(spec.rate * spec.duration))
    arrivals = np.sort(rng.uniform(0.0, spec.duration, n))
    ins, outs = sample_lengths(spec, n, rng,
                               phase=arrivals / max(spec.duration, 1e-9))
    return [Request(i, float(arrivals[i]), int(ins[i]), int(outs[i]))
            for i in range(n)]


def longtail_spec(rate: float, duration: float, *, seed: int = 0,
                  tail_frac: float = 0.08,
                  max_context: int = MAX_CONTEXT) -> WorkloadSpec:
    """The scenario chunked prefill exists for (paper §2.1 / Fig. 1): a
    log-normal body of ordinary dialogue turns with a heavy 32K–128K
    *prompt* tail — long-context requests whose monolithic prefill would
    freeze a whole instance for seconds. The Pareto tail is scaled so the
    bulk of tail prompts lands in [32K, 128K] (alpha 1.05 ⇒ a 128K-capped
    median around 60K)."""
    return WorkloadSpec(rate=rate, duration=duration, seed=seed,
                        tail_frac=tail_frac, tail_alpha=1.05,
                        tail_scale=32_000.0, max_context=max_context)


def generate_longtail(rate: float, duration: float, *, seed: int = 0,
                      max_context: int = MAX_CONTEXT) -> List[Request]:
    """`generate` over `longtail_spec` — the benchmark entry point
    (`benchmarks/bench_chunked_prefill.py`, fig-6/7 long-context runs)."""
    return generate(longtail_spec(rate, duration, seed=seed,
                                  max_context=max_context))


@dataclasses.dataclass(frozen=True)
class SharedPrefixSpec:
    """Shared-prefix workload (DESIGN.md §Prefix cache): the production
    shape prefix caching exists for — many users hitting a handful of
    long system prompts, plus multi-turn sessions that resend their whole
    history. ``num_groups`` prefix groups with Zipf-ish popularity; each
    request is ``prefix + fresh suffix``. Turn depth models multi-turn
    growth: turn t of a session extends the group prefix by (t-1) *
    ``turn_len`` tokens — later turns share everything the earlier turns
    sent, which is exactly what a radix prefix index exploits."""
    rate: float
    duration: float
    seed: int = 0
    num_groups: int = 4
    prefix_len: int = 1024         # system-prompt tokens per group
    zipf_a: float = 1.5            # group popularity skew
    suffix_mu: float = 5.0         # log-normal fresh-suffix body
    suffix_sigma: float = 0.8
    out_mu: float = 5.3
    out_sigma: float = 1.0
    turns: int = 1                 # max conversation depth per group
    turn_len: int = 256            # tokens a full earlier turn adds
    max_context: int = MAX_CONTEXT


def shared_prefix_spec(rate: float, duration: float, *, seed: int = 0,
                       num_groups: int = 4, prefix_len: int = 1024,
                       turns: int = 1,
                       max_context: int = MAX_CONTEXT) -> SharedPrefixSpec:
    """The scenario the refcounted prefix cache targets (benchmark entry
    point — `benchmarks/bench_prefix_cache.py`, `compare_policies
    (workload="shared_prefix")`)."""
    return SharedPrefixSpec(rate=rate, duration=duration, seed=seed,
                            num_groups=num_groups, prefix_len=prefix_len,
                            turns=turns, max_context=max_context)


def generate_shared_prefix(spec: SharedPrefixSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    n = max(1, rng.poisson(spec.rate * spec.duration))
    arrivals = np.sort(rng.uniform(0.0, spec.duration, n))
    groups = np.minimum(rng.zipf(spec.zipf_a, n) - 1,
                        spec.num_groups - 1).astype(np.int64)
    depth = rng.integers(1, spec.turns + 1, n)
    prefix = spec.prefix_len + (depth - 1) * spec.turn_len
    suffix = np.clip(rng.lognormal(spec.suffix_mu, spec.suffix_sigma, n),
                     16, None).astype(np.int64)
    ins = np.minimum(prefix + suffix, spec.max_context - 64)
    prefix = np.minimum(prefix, ins - 16)     # >= 16 fresh tokens always
    outs = np.clip(rng.lognormal(spec.out_mu, spec.out_sigma, n),
                   8, None).astype(np.int64)
    outs = np.minimum(outs, spec.max_context - ins)
    # multi-turn prefixes nest: group g at depth d is its own sub-group
    # (g, d) — depth-d requests share prefix_len + (d-1)*turn_len tokens
    # with each other AND the shallower turns' prefix, which the sim's
    # group-granular model approximates by the per-(g, d) group
    return [Request(i, float(arrivals[i]), int(ins[i]), int(outs[i]),
                    prefix_group=int(groups[i] * spec.turns + depth[i] - 1),
                    prefix_len=int(prefix[i]))
            for i in range(n)]


def trace_requests(path: str, rate: float, seed: int = 0) -> List[Request]:
    """Load (input_len, output_len) pairs from a CSV trace file and attach
    Poisson arrivals — the hook for a real ShareGPT trace."""
    pairs = np.loadtxt(path, delimiter=",", dtype=np.int64).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, len(pairs))
    t = np.cumsum(gaps)
    return [Request(i, float(t[i]), int(a), int(b))
            for i, (a, b) in enumerate(pairs)]


# --------------------------------------------------------------------------
# Open-loop arrival curves (ROADMAP item 4): diurnal + bursty modulation.
# The production shape FCFS folds under — a sinusoidal daily cycle with
# exponential on/off burst windows stacked on top, sampled open-loop (the
# offered load never waits for the system), via Poisson thinning.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArrivalCurve:
    """Time-varying arrival intensity λ(t) = base · diurnal(t) · burst(t).

    ``diurnal_amp`` modulates a sinusoid with period ``diurnal_period``
    (amplitude 0 = flat); bursts multiply the rate by ``burst_factor``
    inside on/off windows drawn from exponential gap/length clocks.
    """
    base_rate: float               # mean arrivals/s outside bursts
    diurnal_amp: float = 0.5       # in [0, 1): peak/trough swing
    diurnal_period: float = 60.0   # seconds per "day"
    burst_factor: float = 4.0      # rate multiplier inside a burst
    burst_every: float = 20.0      # mean gap between burst starts
    burst_len: float = 2.0         # mean burst duration


def burst_windows(curve: ArrivalCurve, duration: float,
                  rng: np.random.Generator) -> List[Tuple[float, float]]:
    """Sample the on/off burst windows [(start, end), ...] over a run."""
    windows: List[Tuple[float, float]] = []
    if curve.burst_factor <= 1.0 or curve.burst_every <= 0.0:
        return windows
    t = float(rng.exponential(curve.burst_every))
    while t < duration:
        end = t + float(rng.exponential(curve.burst_len))
        windows.append((t, min(end, duration)))
        t = end + float(rng.exponential(curve.burst_every))
    return windows


def rate_at(curve: ArrivalCurve, t: np.ndarray,
            windows: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Vectorized λ(t) over sampled burst windows."""
    t = np.asarray(t, dtype=np.float64)
    lam = curve.base_rate * (
        1.0 + curve.diurnal_amp
        * np.sin(2.0 * np.pi * t / max(curve.diurnal_period, 1e-9)))
    boost = np.zeros_like(t)
    for s, e in windows:
        boost = np.where((t >= s) & (t < e), 1.0, boost)
    return lam * (1.0 + (curve.burst_factor - 1.0) * boost)


def arrival_times(curve: ArrivalCurve, duration: float,
                  rng: np.random.Generator) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Open-loop arrivals from the non-homogeneous Poisson process λ(t),
    via thinning: draw a homogeneous λ_max candidate stream, keep each
    candidate with probability λ(t)/λ_max."""
    windows = burst_windows(curve, duration, rng)
    lam_max = (curve.base_rate * (1.0 + curve.diurnal_amp)
               * max(curve.burst_factor, 1.0))
    n_cand = rng.poisson(lam_max * duration)
    cand = np.sort(rng.uniform(0.0, duration, n_cand))
    keep = rng.random(n_cand) < rate_at(curve, cand, windows) / max(lam_max, 1e-12)
    return cand[keep], windows


@dataclasses.dataclass(frozen=True)
class SLOWorkloadSpec:
    """The million-user-shaped harness trace: open-loop diurnal+bursty
    arrivals, a multi-tenant Zipf shared-prefix population, an SLO class
    mix, and per-class length profiles (interactive = short chat turns;
    batch = long analytic prompts with a 32K–128K Pareto tail)."""
    curve: ArrivalCurve
    duration: float
    seed: int = 0
    # (class, weight) mix; tuple-of-tuples so the spec stays hashable
    class_mix: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.5), ("standard", 0.3), ("batch", 0.2))
    # multi-tenant shared prefixes (system prompts), Zipf popularity
    num_tenants: int = 8
    prefix_len: int = 512
    zipf_a: float = 1.4
    prefix_frac: float = 0.7       # fraction of requests with a tenant prefix
    # per-class (in_mu, in_sigma, out_mu, out_sigma) length profiles
    profiles: Tuple[Tuple[str, float, float, float, float], ...] = (
        ("interactive", 4.5, 0.7, 4.0, 0.7),
        ("standard", 6.0, 1.0, 5.3, 0.9),
        ("batch", 7.5, 1.2, 5.8, 1.0))
    # long-context Pareto tail on batch prompts
    tail_frac: float = 0.10
    tail_alpha: float = 1.05
    tail_scale: float = 32_000.0
    max_context: int = MAX_CONTEXT


def slo_spec(rate: float, duration: float, *, seed: int = 0,
             class_mix: Optional[Tuple[Tuple[str, float], ...]] = None,
             num_tenants: int = 8, prefix_len: int = 512,
             max_context: int = MAX_CONTEXT,
             **curve_kw) -> SLOWorkloadSpec:
    """Convenience constructor (benchmark/harness entry point)."""
    kw = {}
    if class_mix is not None:
        kw["class_mix"] = tuple(class_mix)
    return SLOWorkloadSpec(curve=ArrivalCurve(base_rate=rate, **curve_kw),
                           duration=duration, seed=seed,
                           num_tenants=num_tenants, prefix_len=prefix_len,
                           max_context=max_context, **kw)


def generate_slo(spec: SLOWorkloadSpec) -> List[Request]:
    """Sample the open-loop SLO harness trace."""
    rng = np.random.default_rng(spec.seed)
    arrivals, _ = arrival_times(spec.curve, spec.duration, rng)
    n = len(arrivals)
    if n == 0:
        return []
    mixes = [m[0] for m in spec.class_mix]
    probs = np.array([m[1] for m in spec.class_mix], dtype=np.float64)
    probs /= probs.sum()
    cls_idx = rng.choice(len(mixes), size=n, p=probs)
    profiles = {p[0]: p[1:] for p in spec.profiles}
    ins = np.empty(n, dtype=np.float64)
    outs = np.empty(n, dtype=np.float64)
    for ci, name in enumerate(mixes):
        mask = cls_idx == ci
        m = int(mask.sum())
        if not m:
            continue
        in_mu, in_sig, out_mu, out_sig = profiles.get(
            name, (6.0, 1.0, 5.3, 0.9))
        ins[mask] = rng.lognormal(in_mu, in_sig, m)
        outs[mask] = rng.lognormal(out_mu, out_sig, m)
        if name == "batch" and spec.tail_frac > 0:
            tail = rng.random(m) < spec.tail_frac
            pareto = spec.tail_scale * (1 + rng.pareto(spec.tail_alpha, m))
            sub = ins[mask]
            sub[tail] = pareto[tail]
            ins[mask] = sub
    # multi-tenant Zipf prefixes on a fraction of requests
    tenants = np.minimum(rng.zipf(spec.zipf_a, n) - 1,
                         spec.num_tenants - 1).astype(np.int64)
    has_prefix = rng.random(n) < spec.prefix_frac
    plen = np.where(has_prefix, spec.prefix_len, 0).astype(np.int64)
    ins = np.clip(ins + plen, 16, spec.max_context - 64).astype(np.int64)
    plen = np.minimum(plen, ins - 16)
    outs = np.clip(outs, 4, None).astype(np.int64)
    outs = np.minimum(outs, spec.max_context - ins)
    return [Request(i, float(arrivals[i]), int(ins[i]), int(outs[i]),
                    prefix_group=int(tenants[i]) if plen[i] > 0 else -1,
                    prefix_len=int(plen[i]),
                    slo_class=mixes[int(cls_idx[i])])
            for i in range(n)]
