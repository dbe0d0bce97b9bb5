#!/usr/bin/env python3
"""Where a step of the port's engine spends its time on the card.

    python3 tools/profile_torch_engine.py [--arch NAME] [--json PATH]

Serves the trace of ``chip_smoke.py`` phase 4 (8 requests with prompts of
16..5897 tokens and 16-32 new tokens, all submitted at once) on a fused
engine of 8 slots, max_seq 8192 and a 32768-token pool, preemption off,
with ``--arch``'s full-width bf16 weights drawn from a seed (llama3.2-3b
by default; qwen3-moe-30b-a3b draws 60.2 GB). The trace is served twice,
on fresh engines with the same weights. Two windows of ``STEPS`` engine
steps are looked at: mixed steps from the point where the longest prompt
reaches ctx 2560, and decode-only steps near the end of the trace. The
first pass times the windows with no profiler ever started in the process
(recording host activity slows the host, and the profiler may stay
attached after it stops); the second profiles each step of the windows
alone with ``torch.profiler`` (CPU and CUDA activity). A profile that
lacks one of the step's ``num_layers`` attention-kernel launches or one
of its MoE ranges (the profiler loses records now and then) is dropped
and the next step of the window is profiled in its place, at most
``MAX_RETAKES`` times in all.

For each window it prints the unprofiled host wall per step, the wall
under the profiler, and for each profiled step its device busy time (the
union of its kernel intervals; the profiler's device-side ranges of
``record_function`` are no kernels), split into the MoE layer (the union
of the kernels inside the device-side ranges of a ``record_function``
put around ``mlp.moe`` for the profiled pass; a dense model has none, an
MoE step's is printed beside its least time), the attention kernel (#1,
the kernels named ``mixed_``) and the rest; then device time by kernel,
largest first. ``--json PATH`` writes these numbers. ``chip_smoke.py``
phase 16 runs it with ``--arch qwen3-moe-30b-a3b`` in a process of its
own (a profiler late in a long process lost kernel records). Needs one
CUDA card: exits non-zero without one, if the trace does not drain or if
the profiler lost records of more than ``MAX_RETAKES`` steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STEPS = 3           # profiled steps a window
MAX_RETAKES = 6     # steps whose profile lost records, in all


def busy_ms(events):
    """Union of the device intervals of ``events`` (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def within(events, spans):
    """The ``events`` whose device interval lies inside one of ``spans``
    (the device-side ranges of a ``record_function``: from its first
    kernel's start to its last kernel's end)."""
    import bisect
    spans = sorted((r.start, r.end) for r in spans)
    starts = [s for s, _ in spans]
    out = []
    for e in events:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            out.append(e)
    return out


def moe_layer_bound_ms(cfg, calls, tokens):
    """(bound ms, "bytes"|"operations") of ``calls`` all-expert MoE layer
    calls over ``tokens`` rows in all: every call reads all E experts'
    weights (bf16) and the f32 router once; every row runs all E experts
    (three D x F products, 2·D·F flops each)."""
    from chip_smoke import bound_of
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    nbytes = calls * (3 * E * D * Fd * 2 + D * E * 4)
    flops = tokens * E * 3 * 2.0 * D * Fd
    return bound_of(nbytes, flops)


def timed(torch, eng, steps):
    """Host wall time of ``steps`` engine steps (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class Profiler:
    """Profiles engine steps one at a time, with a ``moe_layer`` range
    around ``transformer.moe`` while installed; keeps ``STEPS`` complete
    profiles a window."""

    def __init__(self, torch, cfg):
        from repro_torch.models import transformer
        self.torch, self.cfg, self.tr = torch, cfg, transformer
        self.real_moe = transformer.moe
        self.seen = {"calls": 0, "rows": 0}
        self.lost = 0
        self.windows = []

    def install(self):
        from torch.profiler import record_function
        real, seen = self.real_moe, self.seen

        def moe(p, c, x, *args, **kwargs):
            seen["calls"] += 1
            seen["rows"] += x.shape[0] * x.shape[1]
            with record_function("moe_layer"):
                return real(p, c, x, *args, **kwargs)
        self.tr.moe = moe

    def restore(self):
        self.tr.moe = self.real_moe

    def window(self, eng, label):
        """``STEPS`` steps of ``label``'s kind (mixed: a prompt chunk
        advanced), each profiled alone; a step whose profile lost an
        attention launch, or of the other kind, is replaced by the next."""
        from chip_smoke import check
        from torch.profiler import ProfilerActivity, profile
        torch, cfg = self.torch, self.cfg
        want_mixed = label.startswith("mixed")
        samples, kernels, start = [], [], eng.steps
        while len(samples) < STEPS:
            check(eng.steps - start < 4 * STEPS + MAX_RETAKES,
                  f"{label}: {len(samples)} of {STEPS} steps profiled")
            p0 = eng.prefill_tokens_done
            self.seen["calls"] = self.seen["rows"] = 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed(torch, eng, 1)
            if (eng.prefill_tokens_done > p0) != want_mixed:
                continue
            dev = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            kern = [e for e in dev if not e.is_user_annotation]
            spans = [e.time_range for e in dev if e.is_user_annotation
                     and e.name == "moe_layer"]
            attn = [e for e in kern if "mixed_" in e.name]
            if (len(attn) != cfg.num_layers
                    or len(spans) != self.seen["calls"]):
                self.lost += 1
                check(self.lost <= MAX_RETAKES, "the profiler lost records "
                      f"of {self.lost} steps")
                continue
            busy = busy_ms(kern)
            moe_ms = busy_ms(within(kern, spans))
            attn_ms = sum(e.time_range.elapsed_us() for e in attn) / 1e3
            s = {"step": eng.steps, "wall_ms": wall, "busy_ms": busy,
                 "moe_ms": moe_ms, "attention_kernel_ms": attn_ms,
                 "rest_ms": busy - moe_ms - attn_ms, "kernels": len(kern),
                 "moe_calls": self.seen["calls"],
                 "moe_rows": self.seen["rows"]}
            if s["moe_calls"]:
                s["moe_bound_ms"], s["moe_bound_by"] = moe_layer_bound_ms(
                    cfg, s["moe_calls"], s["moe_rows"])
            samples.append(s)
            kernels += kern
        self.windows.append({"label": label, "samples": samples,
                             "kernels": kernels})


def serve(torch, np, model, params, window):
    """Serve the trace on a fresh engine; ``window(eng, label)`` runs each
    window's steps."""
    from chip_smoke import NEW_TOKENS, PROMPTS, SEED, check
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import ServeRequest
    eng = Engine(0, model, params, max_slots=8, max_seq=8192,
                 token_budget=32768, preemption=False)
    rng = np.random.default_rng(SEED)
    reqs = [ServeRequest(i, rng.integers(0, model.cfg.vocab_size, n)
                         .astype(np.int32), m)
            for i, (n, m) in enumerate(zip(PROMPTS, NEW_TOKENS))]
    for r in reqs:
        eng.submit(r)
    longest = reqs[-1]
    while longest.ctx_done < 2560:      # each mixed step: one 256 chunk
        eng.step()
    window(eng, f"mixed steps, longest prompt from ctx {longest.ctx_done}")
    while any(r.prefilling for r in reqs) or len(longest.generated) < 4:
        eng.step()
    window(eng, f"decode-only steps, context from {eng.slot_len.max()}")
    while not all(r.state.name == "FINISHED" for r in reqs):
        check(eng.steps < 2000, "the engine did not drain")
        eng.step()
    eng.check_drained()
    eng.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import SEED
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    print(torch.cuda.get_device_name(0), torch.__version__, args.arch)
    cfg = dataclasses.replace(get_config(args.arch), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    walls = []
    serve(torch, np, model, params,
          lambda eng, label: walls.append(timed(torch, eng, STEPS)))
    prof = Profiler(torch, cfg)
    prof.install()
    try:
        serve(torch, np, model, params, prof.window)
    finally:
        prof.restore()
    out = {"arch": args.arch, "device": torch.cuda.get_device_name(0),
           "steps": STEPS, "lost": prof.lost, "windows": []}
    for w, wall in zip(prof.windows, walls):
        samples, kernels = w["samples"], w["kernels"]
        busy = sum(s["busy_ms"] for s in samples)
        prof_wall = sum(s["wall_ms"] for s in samples)
        by_name = {}
        for e in kernels:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"== {w['label']}: {STEPS} steps, host wall "
              f"{wall / STEPS:.2f} ms/step unprofiled ({prof_wall / STEPS:.2f}"
              f" under the profiler), device busy {busy / STEPS:.2f} ms/step "
              f"({100 * busy / wall:.1f}% of the unprofiled wall), "
              f"{len(kernels) / STEPS:.0f} kernels/step")
        for s in samples:
            moe = (f"MoE {s['moe_ms']:.3f} ({s['moe_calls']} calls over "
                   f"{s['moe_rows']} rows; bound {s['moe_bound_ms']:.3f} ms, "
                   f"{s['moe_bound_by']}) + " if s["moe_calls"] else "")
            print(f"  step {s['step']}: busy {s['busy_ms']:.3f} ms = {moe}"
                  f"attention kernel {s['attention_kernel_ms']:.3f} + rest "
                  f"{s['rest_ms']:.3f}; {s['kernels']} kernels")
        for name, (n, t) in top:
            print(f"  {t / STEPS:9.3f} ms/step  {n / STEPS:6.0f} "
                  f"launches/step  {name[:90]}")
        out["windows"].append({
            "label": w["label"], "wall_ms_per_step": wall / STEPS,
            "profiled_wall_ms_per_step": prof_wall / STEPS,
            "busy_ms_per_step": busy / STEPS, "samples": samples,
            "by_kernel": [{"name": name, "launches_per_step": n / STEPS,
                           "ms_per_step": t / STEPS}
                          for name, (n, t) in top]})
    out["seconds"] = time.perf_counter() - t0
    print(f"{args.arch}: {out['seconds']:.1f} s, {prof.lost} profiles "
          "retaken")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
