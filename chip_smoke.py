#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero before
the last line:

1. the card's name and power limit (``nvidia-smi``);
2. building every kernel of the serving paths from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` each, started together), with the
   compiler's register and spill report;
3. each kernel against its plain PyTorch version on the card at the
   llama3.2-3b shapes of the main paths (f32 within 1e-4, bf16 within
   5e-3), with its time, the plain version's, one PyTorch library call's,
   and the least time the card could take (bytes at 3.35 TB/s or flops at
   989 TFLOP/s bf16): the fused mixed kernel, the flat decode kernel
   (rows over 24, 3300, 650 and 770 tokens and a dead slot) and the
   chunked prefill kernel (chunks of 256 at ctx 2800 and 0, one of 100);
4. a full-width llama3.2-3b engine (bf16, random seeded weights, fused
   backend) serving 8 requests with prompts of 16..5897 tokens, under
   CUDA sync-debug "error" mode: every request finishes with its token
   count, the kernel launches equal layers x attention calls, at most one
   device-to-host transfer per step; then a warm prefix resubmit gives
   the same tokens (in bf16 only where the warm tail chunk and the cold
   final chunk have the same shapes, as this trace arranges);
5. a 2-layer full-width f32 llama3.2-3b on the card and on the CPU, same
   weights: identical greedy streams, and on each a warm resubmit at a
   length where the warm and cold last chunks differ in shape gives the
   cold tokens;
6. the length-aware cluster at full width: ``MILSServer`` with 4 engines
   on the one card (``repro_torch.launch.serve``'s plan, two stages split
   at 2048 tokens), the flat backend, bf16 llama3.2-3b with one shared
   seeded weight set, 16 requests arriving over 8 steps (prompts 16..6000
   tokens, five just below 2048 that cross the boundary while decoding),
   under sync-debug "error": every request finishes, at least 2 live
   migrations, every engine drains clean, each engine step makes at most
   one device-to-host transfer and two attention-bearing forwards, and the
   flat kernels launch on every layer of those forwards;
7. the same cluster, f32, 2 layers, 2 engines, 6 requests, once on the
   card and once on the CPU: identical decision logs and token streams;
8. one JSON line of every kernel, then, last, ``{"ok": true, ...}``.

It needs one CUDA card and fails without one; it imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOPS_PER_S = 989e12          # dense tensor-core bf16, published
SEED = 0


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# Phase 3 helpers
# --------------------------------------------------------------------------
def mixed_case(np, segs, C, H, Hkv, Dh, BS, alias, seed):
    """One mixed iteration in numpy: ("dec", L) is a decode row over L
    cached tokens (L = 0: dead slot), ("ck", ctx, clen) a prefill chunk;
    segments alias[0] and alias[1] share their first alias[2] blocks."""
    rng = np.random.default_rng(seed)
    B = len(segs)
    totals = [(s[1] if s[0] == "dec" else s[1] + s[2]) for s in segs]
    NBT = max(-(-t // BS) for t in totals) + 1
    NB = sum(-(-t // BS) for t in totals) + 3
    perm = rng.permutation(NB)
    k_pool = np.zeros((NB, BS, Hkv, Dh), np.float32)
    v_pool = np.zeros_like(k_pool)
    bt = np.full((B, NBT), NB - 1, np.int32)
    pi = 0
    for s, t in enumerate(totals):
        for j in range(-(-t // BS)):
            if s == alias[1] and j < alias[2]:
                bt[s, j] = bt[alias[0], j]
                continue
            pb = int(perm[pi])
            pi += 1
            bt[s, j] = pb
            k_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
            v_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
    q = rng.normal(0, 1, (B, C, H, Dh)).astype(np.float32)
    ctx = np.asarray([s[1] - 1 if s[0] == "dec" else s[1] for s in segs],
                     np.int32)
    seg = np.asarray([1 if s[0] == "dec" else s[2] for s in segs], np.int32)
    tags = np.asarray([0 if s[0] == "dec" else 1 for s in segs], np.int32)
    return q, k_pool, v_pool, bt, ctx, seg, tags


def attention_work(bt, ctx, seg, tags, BS):
    """(live query rows, (query row, visible key) pairs, distinct K/V pool
    rows read) of one mixed iteration: the work these inputs need."""
    rows = keys = 0
    kv_rows = set()
    for s in range(len(ctx)):
        total = int(ctx[s]) + int(seg[s])
        if total <= 0:
            continue
        for p in range(total):
            kv_rows.add((int(bt[s, p // BS]), p % BS))
        if tags[s] == 0:
            rows += 1
            keys += total
        else:
            rows += int(seg[s])
            keys += sum(int(ctx[s]) + r + 1 for r in range(int(seg[s])))
    return rows, keys, len(kv_rows)


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` from CUDA events around each launch, the
    L2 cache flushed before each one by a 512 MB write, which also keeps
    the device busy while the host enqueues ``fn``: the host's time to
    issue a small call stays out of the measurement."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def phase_kernels(np, torch, F, tk, flush):
    """Kernel vs plain on the card at llama3.2-3b head shapes."""
    H, Hkv, Dh, BS, C = 24, 8, 128, 16, 256
    segs = [("dec", 24), ("ck", 2800, 256), ("dec", 3300), ("dec", 0),
            ("ck", 0, 256), ("dec", 650), ("dec", 770)]
    alias = (5, 6, 10)                 # a shared 160-token prefix
    q, kp, vp, bt, ctx, seg, tags = mixed_case(np, segs, C, H, Hkv, Dh, BS,
                                               alias, SEED)
    dev = torch.device("cuda")
    ints = [torch.from_numpy(a).to(dev) for a in (bt, ctx, seg, tags)]
    res = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        fl = [torch.from_numpy(a).to(dev, dt) for a in (q, kp, vp)]
        out = tk.paged_mixed_attention(*fl, *ints)
        torch.cuda.synchronize()
        ref = tk.paged_mixed_attention_plain(*fl, *ints)
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err), f"{name}: non-finite kernel output")
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        log(f"phase 3: kernel vs plain {name}: max_abs_err={err:.3e} "
            f"(tolerance {tol})")
        res[name] = {"err": err, "inputs": fl}
    fl = res["bf16"]["inputs"]
    kernel_ms = time_ms(torch, lambda: tk.paged_mixed_attention(*fl, *ints),
                        50, flush)
    plain_ms = time_ms(torch, lambda: tk.paged_mixed_attention_plain(
        *fl, *ints), 10, flush)
    # library yardstick: one SDPA over pre-gathered padded K/V, bool mask
    from repro_torch.models.attention import paged_gather
    B, G, S = len(segs), H // Hkv, bt.shape[1] * BS
    kg, vg = (paged_gather(pool, ints[0]).repeat_interleave(G, 2)
              .transpose(1, 2).contiguous() for pool in fl[1:])
    qs = fl[0].transpose(1, 2).contiguous()                 # [B, H, C, Dh]
    r = torch.arange(C, device=dev)[None]
    c_, s_, t_ = (x.long()[:, None] for x in ints[1:])
    limit = torch.where(t_ == 1, torch.minimum(c_ + s_, c_ + r + 1), c_ + s_)
    mask = (torch.arange(S, device=dev)[None, None] < limit[..., None])
    mask = mask[:, None]                                    # [B, 1, C, S]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), 20, flush)
    # least time: each needed byte moved once (live q rows, the K/V rows
    # the totals cover, shared blocks once, the whole output), 4·Dh flops
    # per (query head, visible key)
    rows, keys, kv_rows = attention_work(bt, ctx, seg, tags, BS)
    nbytes = (rows * H * Dh * 2 + kv_rows * Hkv * Dh * 2 * 2
              + B * C * H * Dh * 2 + bt.size * 4 + 3 * B * 4)
    flops = 4.0 * keys * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"phase 3: bf16 kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {
        "max_abs_err": res["bf16"]["err"], "max_abs_err_f32": res["f32"]["err"],
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh, out_rows):
    """(bound ms, "bytes"|"operations", bytes, flops): each needed byte
    moved once (live q rows, the K/V rows the totals cover, shared blocks
    once, ``out_rows`` output rows, tables and lengths), 4*Dh flops per
    (query head, visible key)."""
    rows, keys, kv_rows = attention_work(bt, ctx, seg, tags, BS)
    nbytes = (rows * H * Dh * 2 + kv_rows * Hkv * Dh * 2 * 2
              + out_rows * H * Dh * 2 + bt.size * 4 + 3 * len(ctx) * 4)
    flops = 4.0 * keys * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def hold(torch, name, out, ref, tol):
    """Kernel output vs its plain version; returns the max abs error."""
    err = (out.float() - ref.float()).abs().max().item()
    check(math.isfinite(err), f"{name}: non-finite kernel output")
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    return err


def sdpa_inputs(torch, pools, bt, G):
    """K/V of each row gathered through its table, heads repeated to the
    query heads: [B, H, S, Dh] each (the library call's layout)."""
    from repro_torch.models.attention import paged_gather
    return [paged_gather(p, bt).repeat_interleave(G, 2).transpose(1, 2)
            .contiguous() for p in pools]


def phase_flat_kernels(np, torch, F, dk, pk, flush):
    """The flat pair vs plain at llama3.2-3b heads; times and bounds."""
    from repro_torch.kernels.ops import flat_work_list
    H, Hkv, Dh, BS = 24, 8, 128, 16
    G = H // Hkv
    dev = torch.device("cuda")
    out = {}

    # ---- kernel #2: decode rows over 24, 3300, 650, 770 tokens, a dead
    # slot; rows 2 and 3 share a 160-token prefix
    lens = [24, 3300, 650, 770, 0]
    q4, kp, vp, bt, ctx, seg, tags = mixed_case(
        np, [("dec", n) for n in lens], 1, H, Hkv, Dh, BS, (2, 3, 10), SEED)
    lengths = np.asarray(lens, np.int32)
    real = sum(-(-n // BS) for n in lens)
    num_work = 1 << (real - 1).bit_length()
    ints = [torch.from_numpy(a).to(dev) for a in (bt, lengths)]
    errs = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        fl = [torch.from_numpy(a).to(dev, dt) for a in (q4[:, 0], kp, vp)]
        got = dk.paged_decode_attention_flat(*fl, *ints, num_work=num_work)
        torch.cuda.synchronize()
        errs[name] = hold(torch, f"flat decode {name}", got,
                          dk.paged_decode_attention_flat_plain(*fl, *ints),
                          tol)
        check(not got[-1].float().abs().max().item(), "dead slot not zero")
        log(f"phase 3: flat decode vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol})")
    # the main path builds the work list once per decode forward and
    # hands it to every layer: the kernel is timed as a layer calls it
    work = flat_work_list(ints[1], bt.shape[1], BS, num_work)
    kernel_ms = time_ms(torch, lambda: dk.paged_decode_attention_flat(
        *fl, *ints, num_work=num_work, work_list=work), 50, flush)
    alone_ms = time_ms(torch, lambda: dk.paged_decode_attention_flat(
        *fl, *ints, num_work=num_work), 50, flush)
    plain_ms = time_ms(torch, lambda: dk.paged_decode_attention_flat_plain(
        *fl, *ints), 10, flush)
    kg, vg = sdpa_inputs(torch, fl[1:], ints[0], G)
    S = kg.shape[2]
    mask = (torch.arange(S, device=dev)[None]
            < ints[1].clamp(min=1)[:, None])[:, None, None]   # [B,1,1,S]
    qs = fl[0][:, :, None]                                    # [B,H,1,Dh]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), 20, flush)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(lens))
    log(f"phase 3: flat decode bf16 kernel {kernel_ms:.4f} ms ("
        f"{alone_ms:.4f} ms building its work list in the call), plain "
        f"{plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP;"
        f" {num_work} work items, {real} real)")
    out["decode"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                     errs["f32"], "ms": kernel_ms, "with_work_list_ms":
                     alone_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": by}
    del fl, kg, vg

    # ---- kernel #3: chunks of 256 at ctx 2800 and at ctx 0, one of 100
    # rows (clen < C) at ctx 1000 sharing chunk 0's first 10 blocks
    C = 256
    segs = [("ck", 2800, 256), ("ck", 0, 256), ("ck", 1000, 100)]
    q, kp, vp, bt, ctx, seg, tags = mixed_case(np, segs, C, H, Hkv, Dh, BS,
                                               (0, 2, 10), SEED + 1)
    ints = [torch.from_numpy(a).to(dev) for a in (bt, ctx, seg)]
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        fl = [torch.from_numpy(a).to(dev, dt) for a in (q, kp, vp)]
        got = pk.paged_prefill_attention(*fl, *ints)
        torch.cuda.synchronize()
        errs[name] = hold(torch, f"chunked prefill {name}", got,
                          pk.paged_prefill_attention_plain(*fl, *ints), tol)
        check(not got[2, 100:].float().abs().max().item(),
              "padding rows not zero")
        log(f"phase 3: chunked prefill vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol})")
    kernel_ms = time_ms(torch, lambda: pk.paged_prefill_attention(
        *fl, *ints), 50, flush)
    plain_ms = time_ms(torch, lambda: pk.paged_prefill_attention_plain(
        *fl, *ints), 10, flush)
    kg, vg = sdpa_inputs(torch, fl[1:], ints[0], G)
    S = kg.shape[2]
    r = torch.arange(C, device=dev)[None]
    c_, s_ = (x.long()[:, None] for x in ints[1:])
    limit = torch.minimum(c_ + s_, c_ + r + 1)                # [B, C]
    mask = (torch.arange(S, device=dev)[None, None]
            < limit[..., None])[:, None]                      # [B,1,C,S]
    qs = fl[0].transpose(1, 2).contiguous()                   # [B,H,C,Dh]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), 20, flush)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(segs) * C)
    log(f"phase 3: chunked prefill bf16 kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP)")
    out["prefill"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                      errs["f32"], "ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": by}
    return out


# --------------------------------------------------------------------------
# Phase 4: the full-width engine
# --------------------------------------------------------------------------
PROMPTS = (16, 48, 192, 300, 724, 1280, 2560, 5897)   # 20 chunks + 23·256+9
NEW_TOKENS = (32, 16, 24, 32, 16, 24, 32, 16)


def phase_engine(np, torch, cfg_mod, model_mod, engine_mod, request_mod, tk):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192)
    torch.cuda.synchronize()
    log(f"phase 4: llama3.2-3b bf16 weights + pool ready in "
        f"{time.perf_counter() - t0:.1f} s (pool {eng.num_blocks + 1} "
        f"blocks of {eng.block_size})")
    rng = np.random.default_rng(SEED)
    reqs = [request_mod.ServeRequest(
        i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
        for i, (n, m) in enumerate(zip(PROMPTS, NEW_TOKENS))]

    def drive(reqs):
        for r in reqs:
            eng.submit(r)
        done, step_ms, end_at = [], [], {}
        t_start = time.perf_counter()
        while len(done) < len(reqs):
            check(eng.steps < 2000, "engine did not drain")
            d0 = engine_mod.D2H_CALLS
            a0 = engine_mod.ATTN_CALLS
            g0 = sum(len(r.generated) for r in reqs)
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                done += eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            end_at[eng.steps] = time.perf_counter() - t_start
            d = engine_mod.D2H_CALLS - d0
            check(engine_mod.ATTN_CALLS - a0 == 1,
                  f"step {eng.steps}: {engine_mod.ATTN_CALLS - a0} forwards")
            grew = sum(len(r.generated) for r in reqs) > g0
            check(d == (1 if grew else 0),
                  f"step {eng.steps}: {d} d2h (tokens reached host: {grew})")
        return step_ms, end_at, time.perf_counter() - t_start

    tk.LAUNCHES = 0
    engine_mod.ATTN_CALLS = 0
    engine_mod.D2H_CALLS = 0
    step_ms, end_at, wall = drive(reqs)
    launches, attn_calls = tk.LAUNCHES, engine_mod.ATTN_CALLS
    check(launches == cfg.num_layers * attn_calls,
          f"launches {launches} != {cfg.num_layers} x {attn_calls}")
    check(launches > 0, "the kernel never ran on the main path")
    for r in reqs:
        check(len(r.generated) == r.max_new_tokens and not r.rejected,
              f"request {r.req_id}: {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.req_id}: token out of range")
    ttft_steps = [r.first_token_step for r in reqs]
    ttft_s = [end_at[r.first_token_step] for r in reqs]
    tpot_steps = [(r.finish_step - r.first_token_step)
                  / (len(r.generated) - 1) for r in reqs]
    tpot_s = [(end_at[r.finish_step] - end_at[r.first_token_step])
              / (len(r.generated) - 1) for r in reqs]
    ntok = sum(len(r.generated) for r in reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 4: {len(reqs)} requests drained in {eng.steps} steps, "
        f"{wall:.3f} s; {ntok} tokens, {ntok / wall:.1f} tokens/s; "
        f"launches {launches} = {cfg.num_layers} x {attn_calls} attn calls; "
        f"d2h {engine_mod.D2H_CALLS}; peak memory {peak_gb:.2f} GB")
    log(f"phase 4: step ms mean {sum(step_ms) / len(step_ms):.2f} "
        f"min {min(step_ms):.2f} max {max(step_ms):.2f}")
    log(f"phase 4: TTFT steps {ttft_steps}")
    log(f"phase 4: TTFT s {[round(x, 4) for x in ttft_s]}")
    log(f"phase 4: TPOT steps {[round(x, 3) for x in tpot_steps]}")
    log(f"phase 4: TPOT s {[round(x, 5) for x in tpot_s]}")

    # warm prefix resubmit of the longest prompt. In bf16 the greedy
    # stream is bit-identical only because the cold final chunk (9 tokens
    # at ctx 5888, the step's only chunk) has the warm tail chunk's shapes:
    # cuBLAS may round another row count differently. Phase 5 checks the
    # contract in f32 at shapes that differ.
    cold = reqs[-1]
    warm = request_mod.ServeRequest(100, cold.prompt.copy(),
                                    cold.max_new_tokens)
    work0, cached0 = eng.prefill_work_blocks, eng.cached_prompt_tokens_total
    _, _, warm_wall = drive([warm])
    check(eng.cached_prompt_tokens_total - cached0 > 0, "no prefix hit")
    check(warm.generated == cold.generated,
          f"warm tokens {warm.generated} != cold {cold.generated}")
    log(f"phase 4: warm resubmit of the {len(cold.prompt)}-token prompt: "
        f"{warm.cached_tokens} tokens cached, prefill block-work "
        f"{eng.prefill_work_blocks - work0}, TTFT "
        f"{warm.first_token_step - cold.finish_step} step(s), same tokens, "
        f"{warm_wall:.3f} s")
    eng.check_drained()
    eng.shutdown()
    summary = {
        "steps": eng.steps, "wall_s": wall, "tokens": ntok,
        "tokens_per_s": ntok / wall, "step_ms": step_ms,
        "ttft_steps": ttft_steps, "ttft_s": ttft_s,
        "tpot_steps": tpot_steps, "tpot_s": tpot_s,
        "launches": launches, "attn_calls": attn_calls,
        "peak_memory_gb": peak_gb, "warm_cached_tokens": warm.cached_tokens,
        "warm_wall_s": warm_wall,
    }
    del eng, params
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# Phase 5: the same weights on the card and on the CPU
# --------------------------------------------------------------------------
def phase_devices(np, torch, cfg_mod, model_mod, engine_mod, request_mod):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = model.init(SEED, device="cpu")
    gpu_params = _tree_to(cpu_params, torch.device("cuda"))
    streams = {}
    for name, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = engine_mod.Engine(0, model, params, max_slots=3, max_seq=512,
                                prefill_token_budget=64)
        check(eng.device.type == name, f"engine on {eng.device}")
        rng = np.random.default_rng(SEED + 1)
        reqs = [request_mod.ServeRequest(
            i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate((40, 130, 17))]
        for r in reqs:
            eng.submit(r)
        done = []
        while len(done) < len(reqs):
            check(eng.steps < 200, "engine did not drain")
            done += eng.step()
        # warm resubmit of the 130-token prompt: its cold last chunk was
        # 42 tokens at ctx 88 beside another chunk, the warm tail is 2
        # tokens at ctx 128 alone, so the contract is held at other shapes
        cold = reqs[1]
        warm = request_mod.ServeRequest(9, cold.prompt.copy(), 6)
        eng.submit(warm)
        while not eng.step():
            check(eng.steps < 200, "warm resubmit did not drain")
        check(warm.cached_tokens == 128, f"{warm.cached_tokens} cached")
        check(warm.generated == cold.generated,
              f"{name}: warm {warm.generated} != cold {cold.generated}")
        eng.check_drained()
        streams[name] = [list(r.generated) for r in reqs]
    check(streams["cuda"] == streams["cpu"],
          f"greedy streams differ: cuda {streams['cuda']} "
          f"cpu {streams['cpu']}")
    log(f"phase 5: 2-layer full-width f32 llama3.2-3b, cuda == cpu greedy "
        f"streams {streams['cuda']}; warm resubmit of the 130-token prompt "
        f"(128 cached, unaligned tail) gives the cold tokens on both")


# --------------------------------------------------------------------------
# Phase 6: the length-aware cluster at full width
# --------------------------------------------------------------------------
# (prompt tokens, new tokens, arrival step): the 2048-token stage boundary
# of default_plan(4, 8192) is crossed while decoding by the five prompts of
# 2000..2040 tokens; 3500..6000-token prompts chunk for 14..24 steps
CLUSTER_TRACE = ((16, 32, 0), (2000, 64, 0), (300, 24, 1), (2030, 40, 1),
                 (6000, 16, 2), (120, 48, 2), (2010, 56, 3), (900, 32, 3),
                 (48, 32, 4), (2040, 32, 4), (3500, 16, 5), (700, 24, 5),
                 (1500, 32, 6), (64, 40, 6), (4200, 16, 7), (2020, 48, 7))


def _submit_trace(np, request_mod, srv, trace, vocab, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (n, new, at) in enumerate(trace):
        r = request_mod.ServeRequest(
            i, rng.integers(0, vocab, n).astype(np.int32), new)
        srv.submit_at(r, at)
        reqs.append(r)
    return reqs


def phase_cluster(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
                  server_mod, serve_mod, qoe_mod, tk, dk, pk):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    srv = server_mod.MILSServer(
        model, params, serve_mod.default_plan(4, 8192),
        qoe_mod.QoEModel(np.array(serve_mod.DEFAULT_QOE)),
        server_mod.ServerConfig(policy="cascade", refinement="adaptive",
                                balancing="full", seed=SEED),
        engine_factory=lambda i: engine_mod.Engine(
            i, model, params, max_slots=8, max_seq=8192, token_budget=32768,
            attn_backend="flat"))
    torch.cuda.synchronize()
    e0 = srv.engines[0]
    log(f"phase 6: 4 engines, one bf16 llama3.2-3b weight set, pools of "
        f"{e0.num_blocks + 1} blocks x {e0.block_size} tokens each, ready "
        f"in {time.perf_counter() - t0:.1f} s; stage bounds "
        f"{srv.stage_bounds}")
    reqs = _submit_trace(np, request_mod, srv, CLUSTER_TRACE,
                         cfg.vocab_size, SEED + 2)

    # forwards by kind, and each engine step's transfers and forwards
    kinds = {"prefill": 0, "decode": 0}
    real_attn_call = engine_mod.attn_call

    def attn_call(fn, *a, **k):
        kinds["prefill" if fn is model.prefill_chunk else "decode"] += 1
        return real_attn_call(fn, *a, **k)

    worst = {"d2h": 0, "attn": 0, "both": 0}
    for eng in srv.engines:
        def counted(burst=1, _step=eng.step):
            d0, a0 = engine_mod.D2H_CALLS, engine_mod.ATTN_CALLS
            out = _step(burst)
            d = engine_mod.D2H_CALLS - d0
            a = engine_mod.ATTN_CALLS - a0
            worst["d2h"] = max(worst["d2h"], d)
            worst["attn"] = max(worst["attn"], a)
            worst["both"] += a == 2
            return out
        eng.step = counted

    engine_mod.attn_call = attn_call
    tk.LAUNCHES = dk.LAUNCHES = pk.LAUNCHES = 0
    t_end = {0: 0.0}
    step_ms = []
    t_start = time.perf_counter()
    try:
        while len(srv.finished) < srv.submitted:
            check(srv.steps < 1000, "cluster did not drain")
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                srv.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            t_end[srv.steps] = time.perf_counter() - t_start
    finally:
        engine_mod.attn_call = real_attn_call
    wall = time.perf_counter() - t_start
    launches = {"tk": tk.LAUNCHES, "dk": dk.LAUNCHES, "pk": pk.LAUNCHES}
    for eng in srv.engines:
        eng.check_drained(strict=True)
    L = cfg.num_layers
    check(worst["d2h"] <= 1, f"an engine step made {worst['d2h']} d2h")
    check(worst["attn"] <= 2, f"an engine step made {worst['attn']} "
          "attention-bearing forwards")
    check(launches["dk"] == L * kinds["decode"] > 0,
          f"flat decode launches {launches['dk']} != {L} x "
          f"{kinds['decode']} decode forwards")
    check(launches["pk"] == L * kinds["prefill"] > 0,
          f"chunked prefill launches {launches['pk']} != {L} x "
          f"{kinds['prefill']} prefill forwards")
    check(launches["tk"] == 0, "the flat cluster ran the fused kernel")
    check(srv.migrations >= 2, f"only {srv.migrations} migrations")
    for r in reqs:
        check(len(r.generated) == r.max_new_tokens and not r.rejected,
              f"request {r.req_id}: {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.req_id}: token out of range")
    summ = srv.summary()
    ttft_s = [t_end[r.first_token_step] - t_end[r.arrival_step]
              for r in reqs]
    e2e_s = [t_end[r.finish_step] - t_end[r.arrival_step] for r in reqs]
    pct = {f"{name}_p{p}": float(np.percentile(v, p))
           for name, v in (("ttft_s", ttft_s), ("e2e_s", e2e_s))
           for p in (50, 95, 99)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ntok = summ["tokens_out"]
    log(f"phase 6: {len(reqs)} requests drained in {srv.steps} steps, "
        f"{wall:.3f} s; {ntok} tokens, {ntok / wall:.1f} tokens/s; "
        f"{srv.migrations} migrations ({srv.migrated_bytes / 1e6:.1f} MB "
        f"moved); peak memory {peak_gb:.2f} GB; stage bounds "
        f"{srv.stage_bounds}")
    log("phase 6: migrations by stage pair " + json.dumps(
        {k: v for k, v in summ.items() if k.startswith("migrations_s")}))
    log("phase 6: steps " + json.dumps(
        {k: summ[k] for k in summ if k.startswith(("ttft_steps_p",
                                                   "e2e_steps_p"))}))
    log("phase 6: seconds " + json.dumps(pct))
    log(f"phase 6: server step ms mean {sum(step_ms) / len(step_ms):.2f} "
        f"min {min(step_ms):.2f} max {max(step_ms):.2f}; forwards: "
        f"{kinds['prefill']} prefill, {kinds['decode']} decode "
        f"({worst['both']} engine steps made both); launches: flat decode "
        f"{launches['dk']}, chunked prefill {launches['pk']}, fused "
        f"{launches['tk']}")
    summary = {"steps": srv.steps, "wall_s": wall, "tokens": ntok,
               "tokens_per_s": ntok / wall, "step_ms": step_ms,
               "migrations": srv.migrations,
               "migrated_bytes": srv.migrated_bytes,
               "peak_memory_gb": peak_gb, "launches": launches,
               "forwards": kinds, "summary": summ, **pct,
               "ttft_s": ttft_s, "e2e_s": e2e_s}
    for eng in srv.engines:
        eng.shutdown()
    del srv, params
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# Phase 7: the cluster on the card and on the CPU
# --------------------------------------------------------------------------
# default_plan(2, 512): stage 0 below 128 tokens; four of these requests
# cross it while decoding
DEVICE_TRACE = ((100, 40, 0), (30, 24, 0), (120, 32, 1), (60, 20, 2),
                (90, 48, 3), (20, 16, 4))


def phase_cluster_devices(np, torch, cfg_mod, model_mod, request_mod,
                          server_mod, serve_mod, qoe_mod):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = model.init(SEED, device="cpu")
    runs = {}
    for name, params in (("cuda", _tree_to(cpu_params, torch.device("cuda"))),
                         ("cpu", cpu_params)):
        srv = server_mod.MILSServer(
            model, params, serve_mod.default_plan(2, 512),
            qoe_mod.QoEModel(np.array(serve_mod.DEFAULT_QOE)),
            server_mod.ServerConfig(seed=SEED), max_slots=4, max_seq=512,
            prefill_token_budget=64, attn_backend="flat")
        check(all(e.device.type == name for e in srv.engines),
              f"engines not on {name}")
        reqs = _submit_trace(np, request_mod, srv, DEVICE_TRACE,
                             cfg.vocab_size, SEED + 3)
        srv.run(max_steps=400)              # asserts the engines drained
        check(len(srv.finished) == len(reqs), f"{name}: did not drain")
        runs[name] = (list(srv.plane.decisions),
                      [list(r.generated) for r in reqs], srv.migrations)
    check(runs["cuda"][0] == runs["cpu"][0],
          f"decision logs differ: cuda {runs['cuda'][0]} cpu "
          f"{runs['cpu'][0]}")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"token streams differ: cuda {runs['cuda'][1]} cpu "
          f"{runs['cpu'][1]}")
    check(runs["cuda"][2] > 0, "no migration in the device comparison")
    log(f"phase 7: 2-layer full-width f32 llama3.2-3b cluster of 2 flat "
        f"engines, cuda == cpu: {len(runs['cuda'][0])} decisions "
        f"({runs['cuda'][2]} migrations), identical token streams (first "
        f"tokens {[g[:4] for g in runs['cuda'][1]]})")


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    # f32 comparisons (phases 3 and 5) need full-precision f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F
    from repro_torch import configs as cfg_mod
    from repro_torch.core import qoe as qoe_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import mixed_attention as tk
    from repro_torch.kernels import prefill_attention as pk
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import request as request_mod
    from repro_torch.serving import server as server_mod

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"phase 2: {name}: {line.strip()}")
    log(f"phase 2: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels vs their plain versions
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    kern = phase_kernels(np, torch, F, tk, flush)
    flat = phase_flat_kernels(np, torch, F, dk, pk, flush)
    del flush

    # 4. the engine's main path at full width (fused backend)
    dk.LAUNCHES = pk.LAUNCHES = 0
    eng_summary = phase_engine(np, torch, cfg_mod, model_mod, engine_mod,
                               request_mod, tk)
    check(dk.LAUNCHES == pk.LAUNCHES == 0, "the fused engine ran flat kernels")

    # 5. cuda vs cpu
    phase_devices(np, torch, cfg_mod, model_mod, engine_mod, request_mod)

    # 6. the cluster at full width (flat backend)
    cluster = phase_cluster(np, torch, cfg_mod, model_mod, engine_mod,
                            request_mod, server_mod, serve_mod, qoe_mod, tk,
                            dk, pk)

    # 7. the cluster, cuda vs cpu
    phase_cluster_devices(np, torch, cfg_mod, model_mod, request_mod,
                          server_mod, serve_mod, qoe_mod)

    # 8. results
    kernels = [{
        "name": "paged_mixed_attention", "ok": True, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mixed_attention.cu",
        "replaces": "src/repro/kernels/mixed_attention.py:187",
        "launches": eng_summary["launches"],
        "max_abs_err": kern["max_abs_err"],
        "max_abs_err_f32": kern["max_abs_err_f32"],
        "ms": kern["ms"], "kernel_ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
    }]
    for key, name, src, tpu, launches in (
            ("decode", "paged_decode_attention_flat", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:185",
             cluster["launches"]["dk"]),
            ("prefill", "paged_prefill_attention", "prefill_attention.cu",
             "src/repro/kernels/prefill_attention.py:255",
             cluster["launches"]["pk"])):
        k = flat[key]
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "max_abs_err_f32": k["max_abs_err_f32"], "ms": k["ms"],
            "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels, "engine": eng_summary,
         "cluster": cluster},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
