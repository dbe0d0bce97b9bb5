#!/usr/bin/env python3
"""The H100 cost model against the card: measure the constants of
``repro_torch.kernels.cost.H100`` and hold the model's step times to the
engine's.

    python3 tools/calibrate_h100.py [--json PATH] [--fig2-tax X]

Needs one CUDA card; run it in a process of its own (late in a long
process the profiler has lost kernel records). Its lines start ``phase
15:``, its place in ``chip_smoke.py``'s list of phases; ``--fig2-tax``
takes that script's phase 13 tax.
Llama3.2-3b at full width, bf16, seeded random weights, block size 16,
fused backend, preemption off.

(a) Constants. Host staging: pinned host <-> device copies of 1..32 KV
blocks (16 x 114,688 B each) in one copy, both directions, fitted as
``overhead + bytes / bw``; beside it the engine's own demote path
(``Engine._demote_snapshot``, two leaf copies a block) and a promote-style
packed upload and scatter, per block. Launch overhead: 200 back-to-back
launches of the fused kernel (#1) at a decode step's shapes, queued behind
a sleep kernel so that the host never starves the device; CUDA events over
the launches less 200 x the kernel's device time from ``torch.profiler``,
over 200 (a profile missing one of the 200 launches is taken again, twice
at most). Skip overhead: #1 on the same rows with its pow2 block table one
and two sizes wider (entries that its split plan walks as empty splits),
the time added per padded ``attn_block``-key item per kv head; the
constant is the widest table's, whose added time stands clearest above
the noise.

(b) Steps. Decode-only steps at n in {1, 8, 32} rows x L in {512, 4096}
and 7 x 256 + 1 x 8000 (whole-prompt admission fills the rows), mixed
steps of 8 decode rows at 2048 plus one 256-token chunk at ctx 0 and at
ctx 4096 (chunked engine), and whole-prompt prefill steps at I in {1024,
4096, 8192}. For each: the median device busy time (the sum of the step's
device activity in ``torch.profiler``, between two marker kernels; every
attention launch of the step, layers x forwards, must be recorded, or the
sample is taken again, twice at most in all), the median host wall of
``Engine.step()`` ending in a synchronize (steps not profiled), and the
model's prediction (``sim.costmodel.mixed_iter_time`` / ``prefill_time``
on ``profile_from_config(llama3.2-3b, chip=H100, fused_backend=True)``),
with the relative error against each. ``t_fixed`` is fitted as the
intercept of the least-squares line of busy time on the prediction
without ``t_fixed`` over the points (its slope reported beside it); the
host's dispatch gap (wall - busy) is reported beside it.

(c) Fig. 2: ``heterogeneity_tax`` of 256 x 200 + 256 x 10000 on the
H100 profile, beside the measured tax passed in ``--fig2-tax``.

(d) The QoE fit: ``profile_and_fit`` on the H100 profile, and Fig. 13's
70/30 split: the fitted model's mean relative error against the static
baseline's.

Prints ``phase 15:`` lines and writes every number to ``--json``; exits
non-zero if a point did not run, the profiler lost a point's records
or the launch profile's more than twice or a number is not finite.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BS = 16
N_LAUNCH = 200
DECODE_POINTS = [(n, L) for L in (512, 4096) for n in (1, 8, 32)]
MIXED_BATCH = (7, 256, 8000)         # 7 rows of 256 and one of 8000
MIXED_ROWS, MIXED_LEN, CHUNK = 8, 2048, 256
CHUNK_CTXS = (0, 4096)
PREFILL_LENS = (1024, 4096, 8192)
MAX_SEQ = 8448
WALL_REPS, BUSY_REPS, WARM = 3, 2, 1
RETRIES = 2                 # profiles taken again when records were lost
MARK_CYCLES = 1_000_000     # a marker kernel of ~0.5 ms
# the attention kernels a step of this engine launches, by the name of
# their device function
KERNEL_NAMES = {"fused": "mixed_", "contiguous_prefill": "prefill_tc"}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print("phase 15:", *a, flush=True)


def fit_line(xs, ys):
    """Least-squares (intercept, slope) of ys on xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - slope * mx, slope


def rel(pred, meas):
    return (pred - meas) / meas


# --------------------------------------------------------------------------
# (a) constants
# --------------------------------------------------------------------------
def event_ms(torch, fn, reps):
    """Median of ``reps`` calls of ``fn``, each between two CUDA events."""
    fn()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def staging(torch, np, engine_mod, eng, block_bytes):
    """Host <-> device staging of KV blocks: the single-copy sweep's fit
    and the engine's demote / promote paths per block."""
    pts = []
    for k in (1, 2, 4, 8, 16, 32):
        n = k * block_bytes
        dev = torch.empty(n, dtype=torch.uint8, device="cuda")
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        for direction, fn in (
                ("h2d", lambda: dev.copy_(host, non_blocking=True)),
                ("d2h", lambda: host.copy_(dev, non_blocking=True))):
            pts.append((direction, n, event_ms(torch, fn, 10) / 1e3))
        del dev, host
    fits = {}
    for label, sel in (("both", ("h2d", "d2h")), ("h2d", ("h2d",)),
                       ("d2h", ("d2h",))):
        c, s = fit_line([b for d, b, _ in pts if d in sel],
                        [t for d, b, t in pts if d in sel])
        fits[label] = {"overhead_s": c, "bw": 1.0 / s}
    # the engine's demote: _demote_snapshot per block (an async copy of
    # each leaf into pinned memory, then an event), waited for at the end
    n_blocks = 32
    ids = list(range(n_blocks))
    for _ in range(2):         # warm the pinned host allocator's cache
        pend = [eng._demote_snapshot(b) for b in ids]
        pend[-1].event.synchronize()
        del pend
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = [eng._demote_snapshot(b) for b in ids]
    pend[-1].event.synchronize()
    demote_s = (time.perf_counter() - t0) / n_blocks
    # the engine's promote: the blocks' payloads packed into one pinned
    # buffer, one upload, one scatter into the pool
    from repro_torch.core.migration import scatter_kv_blocks
    payload = [torch.cat([p.leaves[i] for p in pend], dim=1)
               for i in range(len(eng.cache))]
    idx = torch.as_tensor(np.asarray(ids, np.int64))

    def promote():
        host = [idx] + payload
        buf = engine_mod.h2d(torch.cat([t.contiguous().reshape(-1)
                                        .view(torch.uint8) for t in host]),
                             eng.device)
        dev, at = [], 0
        for t in host:
            nb = t.numel() * t.element_size()
            dev.append(buf[at:at + nb].view(t.dtype).view(t.shape))
            at += nb
        scatter_kv_blocks(eng.cache, type(eng.cache)(*dev[1:]), dev[0])

    promote()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    promote()
    torch.cuda.synchronize()
    promote_s = (time.perf_counter() - t0) / n_blocks
    return {"block_bytes": block_bytes, "points": pts, "fit": fits,
            "engine_demote_s_per_block": demote_s,
            "engine_promote_s_per_block": promote_s}


def decode_rows(torch, cfg, B, L, nbt):
    """#1's inputs for ``B`` decode rows over ``L`` cached tokens each
    (llama3.2-3b heads, bf16, BS 16), the block table ``nbt`` wide; its
    entries past a row's blocks point at the last block."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per = -(-L // BS)
    NB = B * per + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    kp, vp = (torch.randn((NB, BS, Hkv, Dh), generator=gen, device="cuda",
                          dtype=torch.float32).to(torch.bfloat16)
              for _ in range(2))
    bt = torch.full((B, nbt), NB - 1, dtype=torch.int32, device="cuda")
    bt[:, :per] = torch.arange(B * per, dtype=torch.int32,
                               device="cuda").view(B, per)
    ctx = torch.full((B,), L - 1, dtype=torch.int32, device="cuda")
    seg = torch.ones((B,), dtype=torch.int32, device="cuda")
    tags = torch.zeros((B,), dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, ctx, seg, tags


def back_to_back_ms(torch, fn, n):
    """Device time of ``n`` back-to-back calls of ``fn`` (ms), and the
    host's time to enqueue them: the calls are queued behind a sleep
    kernel that lasts longer than the enqueueing, so the first runs only
    once all are queued; CUDA events around the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(2 * host_s * 2e9) + 10_000_000   # > 2x host time at 2 GHz
    s0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(cycles)
    s.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enq = time.perf_counter() - t0
    e.record()
    e.synchronize()
    sleep_ms = s0.elapsed_time(s)
    check(enq * 1e3 < sleep_ms, f"the host enqueued {n} calls in "
          f"{enq * 1e3:.3f} ms, longer than the {sleep_ms:.3f} ms sleep")
    return s.elapsed_time(e), host_s


def kernel_events(torch, fn, n, name):
    """Device durations (ms) of the kernels named like ``name`` over ``n``
    calls of ``fn``, from ``torch.profiler``; a marker kernel runs to its
    end inside the session before the first call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]


def launch_and_skip(torch, cfg, tk):
    """#1's per-launch device overhead, and the time its pow2 table
    padding adds per padded item."""
    from repro_torch.kernels.cost import H100
    B, L = 8, 512
    nbt0 = -(-L // BS)
    times = {}
    for nbt in (nbt0, 2 * nbt0, 4 * nbt0):
        args = decode_rows(torch, cfg, B, L, nbt)
        fn = lambda: tk.paged_mixed_attention(*args)  # noqa: E731
        ms, host_s = back_to_back_ms(torch, fn, N_LAUNCH)
        times[nbt] = {"per_call_ms": ms / N_LAUNCH,
                      "host_us_per_call": host_s / N_LAUNCH * 1e6}
        if nbt == nbt0:
            # a profile that lost records is taken again, at most RETRIES
            # times; every launch must be among the one that is used
            for lost in range(RETRIES + 1):
                durs = kernel_events(torch, fn, N_LAUNCH,
                                     KERNEL_NAMES["fused"])
                if len(durs) == N_LAUNCH:
                    break
                log(f"launch overhead: the profiler recorded {len(durs)} "
                    f"of {N_LAUNCH} fused launches; taken again")
            check(len(durs) == N_LAUNCH, f"profiler recorded {len(durs)} of "
                  f"{N_LAUNCH} fused launches in each of {RETRIES + 1} "
                  "profiles")
            times[nbt]["profiles_lost"] = lost
            kern_ms = sum(durs) / len(durs)
            launch_s = (ms - N_LAUNCH * kern_ms) / N_LAUNCH / 1e3
            times[nbt]["kernel_ms"] = kern_ms
        del args
    items = lambda nbt: B * (nbt - nbt0) * BS / H100.attn_block  # noqa: E731
    skips = {nbt: (times[nbt]["per_call_ms"] - times[nbt0]["per_call_ms"])
             / 1e3 / (cfg.num_kv_heads * items(nbt))
             for nbt in times if nbt != nbt0}
    return {"rows": B, "length": L, "table_widths": times,
            "launch_overhead_s": launch_s, "kernel_ms": kern_ms,
            "skip_overhead_s_by_width": skips,
            "skip_overhead_s": skips[4 * nbt0]}


# --------------------------------------------------------------------------
# (b) engine steps
# --------------------------------------------------------------------------
def counts(tk, pk):
    return {"fused": tk.LAUNCHES, "contiguous_prefill": pk.CONTIG_LAUNCHES}


def one_step(torch, engine_mod, tk, pk, eng, profiled):
    """One engine step: (wall s, busy s or None, forwards, launches).
    A profiled step is framed by two marker kernels in the profiler's
    session, and only the device activity between them counts; every
    attention launch of the step must be among it."""
    c0, a0 = counts(tk, pk), engine_mod.ATTN_CALLS
    torch.cuda.synchronize()
    if not profiled:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        busy, wall = None, time.perf_counter() - t0
    else:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            eng.step()
            torch.cuda.synchronize()
            time.sleep(0.02)
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        wall = None
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = sorted((e.time_range.start, e.time_range.end) for e in evs
                       if "spin_kernel" in e.name)
        if len(marks) != 2:
            return None
        evs = [e for e in evs if marks[0][1] <= e.time_range.start
               and e.time_range.end <= marks[1][0]]
        busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6
    fwd = engine_mod.ATTN_CALLS - a0
    launches = {k: v - c0[k] for k, v in counts(tk, pk).items()}
    if profiled and any(sum(KERNEL_NAMES[k] in e.name for e in evs) != n
                        for k, n in launches.items()):
        return None
    return wall, busy, fwd, launches


def measure(torch, engine_mod, tk, pk, cfg, eng, prepare):
    """WARM + WALL_REPS unprofiled + BUSY_REPS profiled samples of the
    step ``prepare()`` sets up (it returns the model's (chunks, decode
    lengths) or ("prefill", I) of that step). A profiled sample whose
    records are incomplete is discarded and taken again, at most
    ``RETRIES`` times in all (counted in ``lost``); more fail."""
    walls, busys, shapes, fwds, lost = [], [], [], [], 0
    i = 0
    while i < WARM + WALL_REPS + BUSY_REPS:
        shape = prepare()
        got = one_step(torch, engine_mod, tk, pk, eng,
                       i >= WARM + WALL_REPS)
        if got is None:
            lost += 1
            check(lost <= RETRIES, "the profiler lost records of "
                  f"{lost} steps of one point")
            continue
        wall, busy, fwd, launches = got
        L = cfg.num_layers
        check(sum(launches.values()) == L * fwd and fwd >= 1,
              f"{launches} launches for {fwd} forwards of {L} layers")
        i += 1
        if i <= WARM:
            continue
        shapes.append(shape)
        fwds.append(fwd)
        (walls if wall is not None else busys).append(wall or busy)
    return {"wall_s": statistics.median(walls),
            "busy_s": statistics.median(busys), "walls_s": walls,
            "busys_s": busys, "shape": shapes[-1], "forwards": fwds,
            "lost": lost}


def requests(np, request_mod, cfg, rng, lens, max_new, first_id):
    return [request_mod.ServeRequest(
        first_id + i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
        max_new) for i, n in enumerate(lens)]


def decode_shape(eng):
    return ([], [len(r.prompt) + len(r.generated) for r in eng.slots
                 if r is not None and not r.prefilling])


def engine_points(torch, np, cfg, model, params, engine_mod, request_mod,
                  tk, pk):
    rng = np.random.default_rng(SEED)
    rid = [0]

    def reqs(lens, max_new):
        out = requests(np, request_mod, cfg, rng, lens, max_new, rid[0])
        rid[0] += len(lens)
        return out

    pts = []
    whole = engine_mod.Engine(0, model, params, max_slots=32,
                              max_seq=MAX_SEQ, token_budget=32 * 4160,
                              chunked_prefill=False, attn_backend="fused",
                              preemption=False)
    staged = staging(torch, np, engine_mod, whole,
                     BS * 2 * cfg.num_kv_heads * cfg.head_dim * 2
                     * cfg.num_layers)
    batches = [(f"decode {n} x {L}", [L] * n) for n, L in DECODE_POINTS]
    n7, short, long_ = MIXED_BATCH
    batches.append((f"decode {n7} x {short} + 1 x {long_}",
                    [short] * n7 + [long_]))
    # the admission step also decodes its rows (two tokens), and every
    # profiled sample taken again costs one more decode step
    steps_needed = WARM + WALL_REPS + BUSY_REPS + RETRIES
    for label, lens in batches:
        rs = reqs(lens, steps_needed + 3)
        for r in rs:
            whole.submit(r)
        whole.step()                       # whole-prompt admission
        check(all(len(r.generated) >= 1 for r in rs),
              f"{label}: not all admitted in one step")
        m = measure(torch, engine_mod, tk, pk, cfg, whole,
                    lambda: decode_shape(whole))
        pts.append(dict(m, label=label, kind="decode"))
        while not all(r.state.name == "FINISHED" for r in rs):
            whole.step()
    for I in PREFILL_LENS:
        def prep(I=I):
            whole.submit(reqs([I], 1)[0])
            return ("prefill", I)
        m = measure(torch, engine_mod, tk, pk, cfg, whole, prep)
        pts.append(dict(m, label=f"prefill {I}", kind="prefill"))
    whole.shutdown()
    del whole
    torch.cuda.empty_cache()

    chunked = engine_mod.Engine(0, model, params, max_slots=16,
                                max_seq=MAX_SEQ, token_budget=32768,
                                attn_backend="fused", preemption=False)
    chunked.prefill_token_budget = MIXED_ROWS * MIXED_LEN
    rows = reqs([MIXED_LEN] * MIXED_ROWS, 64)
    for r in rows:
        chunked.submit(r)
    chunked.step()
    check(all(len(r.generated) >= 1 for r in rows),
          "mixed rows: not all prefilled in one step")
    for ctx in CHUNK_CTXS:
        def prep(ctx=ctx):
            probe = reqs([ctx + CHUNK], 1)[0]
            chunked.submit(probe)
            if ctx:
                chunked.prefill_token_budget = ctx
                chunked.step()             # the probe's first ctx tokens
            chunked.prefill_token_budget = CHUNK
            return ([(CHUNK, ctx)], decode_shape(chunked)[1])
        m = measure(torch, engine_mod, tk, pk, cfg, chunked, prep)
        pts.append(dict(m, label=f"mixed {MIXED_ROWS} x {MIXED_LEN} + "
                        f"chunk {CHUNK} at ctx {ctx}", kind="mixed"))
    del chunked
    torch.cuda.empty_cache()
    return pts, staged


def predict(shape, prof):
    from repro_torch.sim.costmodel import mixed_iter_time, prefill_time
    if shape[0] == "prefill":
        return prefill_time(shape[1], prof)
    return mixed_iter_time(shape[0], shape[1], prof)


# --------------------------------------------------------------------------
def qoe_split(prof):
    """Fig. 13's method on ``prof``: fit on 70% of the profiled samples,
    mean |relative error| on the other 30%, model and static baseline."""
    import numpy as np
    from repro_torch.core.qoe import (fit_qoe, relative_errors,
                                      static_baseline_errors)
    from repro_torch.sim.profiler import profile_and_fit
    model, F, Q = profile_and_fit(prof, horizon_s=8.0, seed=0,
                                  return_samples=True)
    idx = np.random.default_rng(0).permutation(len(Q))
    cut = int(0.7 * len(Q))
    fit_i, val_i = idx[:cut], idx[cut:]
    split = fit_qoe(F[fit_i], Q[fit_i])
    err = np.abs(relative_errors(split, F[val_i], Q[val_i]))
    base = np.abs(static_baseline_errors(F[val_i], Q[val_i]))
    return {"D": [float(d) for d in model.D], "samples": int(len(Q)),
            "model_mean_err": float(err.mean()),
            "model_median_err": float(np.median(err)),
            "static_mean_err": float(base.mean())}


def finite(x):
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--fig2-tax", type=float, default=None)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("calibrate_h100: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import mixed_attention as tk
    from repro_torch.kernels import prefill_attention as pk
    from repro_torch.kernels.cost import (H100, AttnSpec,
                                          h2d_block_time_s,
                                          heterogeneity_tax)
    from repro_torch.models import build_model
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import request as request_mod
    from repro_torch.sim.costmodel import profile_from_config

    cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    const = launch_and_skip(torch, cfg, tk)
    # the engine steps' launches only: the counts set to 0 just before
    tk.LAUNCHES = pk.CONTIG_LAUNCHES = 0
    launches0 = counts(tk, pk)
    pts, staged = engine_points(torch, np, cfg, model, params, engine_mod,
                                request_mod, tk, pk)
    path_launches = {k: v - launches0[k] for k, v in counts(tk, pk).items()}
    for k, n in path_launches.items():
        check(n > 0, f"phase 15 never launched {k}")

    prof = profile_from_config(get_config("llama3.2-3b"), chip=H100,
                               fused_backend=True)
    for p in pts:
        p["pred_s"] = predict(p["shape"], prof)
    # t_fixed: the intercept of the least-squares line of device busy on
    # the prediction without t_fixed, over every point; its slope says how
    # far the card's steps are from the model's other terms
    t_fixed, slope = fit_line([p["pred_s"] - prof.t_fixed for p in pts],
                              [p["busy_s"] for p in pts])
    dec = [p for p in pts if p["kind"] == "decode"]
    dec_fit = fit_line([p["pred_s"] - prof.t_fixed for p in dec],
                       [p["busy_s"] for p in dec])
    dec_mean = statistics.mean(p["busy_s"] - (p["pred_s"] - prof.t_fixed)
                               for p in dec)
    refit = dataclasses.replace(prof, t_fixed=t_fixed)
    gap = statistics.mean(p["wall_s"] - p["busy_s"] for p in pts)
    st = staged["fit"]["both"]
    log(f"host staging: one pinned copy of 1..32 blocks of "
        f"{staged['block_bytes']} B, both directions: "
        f"{st['overhead_s'] * 1e6:.3f} us + bytes / "
        f"{st['bw'] / 1e9:.3f} GB/s (h2d {staged['fit']['h2d']['bw'] / 1e9:.3f}"
        f" GB/s + {staged['fit']['h2d']['overhead_s'] * 1e6:.3f} us, d2h "
        f"{staged['fit']['d2h']['bw'] / 1e9:.3f} GB/s + "
        f"{staged['fit']['d2h']['overhead_s'] * 1e6:.3f} us)")
    blk = staged["block_bytes"]
    log(f"host staging per block: engine demote "
        f"{staged['engine_demote_s_per_block'] * 1e6:.3f} us, engine "
        f"promote {staged['engine_promote_s_per_block'] * 1e6:.3f} us; "
        f"model (committed H100) {h2d_block_time_s(blk) * 1e6:.3f} us, "
        f"model (this fit) {(st['overhead_s'] + blk / st['bw']) * 1e6:.3f} us")
    tw = const["table_widths"]
    log(f"launch overhead: {N_LAUNCH} back-to-back fused launches "
        f"({const['rows']} rows x {const['length']}) "
        f"{tw[min(tw)]['per_call_ms'] * 1e3:.3f} us a call, kernel device "
        f"time {const['kernel_ms'] * 1e3:.3f} us: "
        f"{const['launch_overhead_s'] * 1e6:.3f} us a launch "
        f"(host {tw[min(tw)]['host_us_per_call']:.1f} us a call)")
    log("skip overhead: table width " + ", ".join(
        f"{w}: {t['per_call_ms'] * 1e3:.3f} us" for w, t in tw.items())
        + "; per padded item per kv head " + ", ".join(
        f"{w}: {s * 1e9:.4f} ns" for w, s in
        const["skip_overhead_s_by_width"].items()))
    log(f"t_fixed fit (device busy on the prediction without t_fixed, "
        f"all {len(pts)} points): intercept {t_fixed * 1e3:.4f} ms, slope "
        f"{slope:.4f} (committed H100: {H100.t_fixed_s * 1e3:.4f} ms); "
        f"decode-only points: intercept {dec_fit[0] * 1e3:.4f} ms, slope "
        f"{dec_fit[1]:.4f}, mean residual at slope 1 {dec_mean * 1e3:.4f} "
        f"ms; host dispatch gap (wall - busy) mean {gap * 1e3:.4f} ms")
    log("point | forwards | samples lost | predicted ms (committed H100; this run's "
        "t_fixed) | device busy ms | err vs busy | host wall ms | err vs "
        "wall")
    for p in pts:
        pr = p["pred_s"]
        p["pred_refit_s"] = predict(p["shape"], refit)
        p["err_vs_busy"] = rel(pr, p["busy_s"])
        p["err_vs_wall"] = rel(pr, p["wall_s"])
        log(f"{p['label']} | {p['forwards'][-1]} | {p['lost']} | "
            f"{pr * 1e3:.4f}; "
            f"{p['pred_refit_s'] * 1e3:.4f} | {p['busy_s'] * 1e3:.4f} | "
            f"{p['err_vs_busy']:+.4f} | {p['wall_s'] * 1e3:.4f} | "
            f"{p['err_vs_wall']:+.4f}")
    lens = [200] * 256 + [10000] * 256
    tax = heterogeneity_tax(lens, AttnSpec(cfg.num_heads, cfg.num_kv_heads,
                                           cfg.head_dim, chip=H100))
    log(f"fig 2 200v10000: model tax {tax:.4f} (H100, attn_block "
        f"{H100.attn_block}); measured (phase 13) "
        + (f"{args.fig2_tax:.4f}" if args.fig2_tax is not None
           else "not given"))
    t0 = time.perf_counter()
    q = qoe_split(prof)
    log(f"QoE fit on the H100 profile ({q['samples']} samples, "
        f"{time.perf_counter() - t0:.1f} s): D = {q['D']}; fig 13 70/30 "
        f"split: model mean |rel err| {q['model_mean_err']:.4f} (median "
        f"{q['model_median_err']:.4f}) vs static {q['static_mean_err']:.4f}")
    log(f"launches on this path: {path_launches}")
    out = {"device": torch.cuda.get_device_name(0), "staging": staged,
           "launch_skip": const, "t_fixed_s": t_fixed,
           "t_fixed_slope": slope, "decode_fit": dec_fit,
           "decode_mean_residual_s": dec_mean,
           "host_gap_s": gap, "points": pts, "fig2_tax_model": tax,
           "fig2_tax_measured": args.fig2_tax, "qoe": q,
           "launches": path_launches,
           "seconds": time.perf_counter() - t_start}
    check(finite({k: v for k, v in out.items() if k != "fig2_tax_measured"}),
          "a number of phase 15 is not finite")
    check(len(pts) == len(DECODE_POINTS) + 1 + len(CHUNK_CTXS)
          + len(PREFILL_LENS), "a point did not run")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, default=str))
    log(f"calibration took {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
