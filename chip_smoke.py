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
   989 TFLOP/s bf16): the fused mixed kernel, its int8 mode (int8 pool,
   f32 scales; also held to the bf16 kernel on the unquantized pool, per
   live row cos >= 0.999 and max abs <= 0.05), the flat decode kernel
   (rows over 24, 3300, 650 and 770 tokens and a dead slot, which is 0;
   two calls bit-equal; one kernel a call in the profiler), the chunked
   prefill kernel (chunks of 256 at ctx 2800 and 0, one of 100), the grid
   decode kernel at the flat one's rows (also held to the flat kernel's
   output), the contiguous decode kernel padded and ragged at the paper's
   200v10000 setup (batch 512, bf16; f32 on 64 of its rows; the padded
   time no lower than streaming its whole 20.97 GB cache takes), every
   split-KV arrival count back at 0 afterwards, and the
   contiguous causal prefill kernel at B 2, T 4096, lengths 4096/4059;
   every time both from CUDA events and as the device time of the call's
   kernels from ``torch.profiler``, and for #1, #3 and #4 the wrapper's
   host time per call; the fused kernel also on the grid kernel's rows
   with C = 1 (a decode step), beside it; for the kernels redesigned for
   Hopper (the tensor-core fused, chunked paged and contiguous prefill
   kernels of ``tc_walk.cuh``, the split-KV grid, flat and contiguous
   decode kernels of ``split_decode.cuh``), ptxas's registers and spilled
   bytes per
   instance (no spill allowed in a tensor-core kernel), and the count of
   tensor-core instructions (HGMMA, HMMA) in the SASS of each tensor-core
   kernel (``cuobjdump -sass``), whose HGMMA must not be 0; the achieved
   rate (TB/s, TFLOP/s) and share of the bound of #4 and #6; then the
   kernels of phases 16-17 at their configs' head groupings, held and
   timed the same way: the fused kernel on the same segments at
   qwen3-moe-30b-a3b's heads (32 / 4, Dh 64, G 8), the flat pair on the
   same rows at qwen2-vl-7b's (28 / 4, Dh 128, G 7), and #6 (B 2, T 1024)
   and #5 (2 rows over a 1025-row slab through ``kv_rows``) at phase 17
   (c)'s shapes;
4. a full-width llama3.2-3b engine (bf16, random seeded weights, fused
   backend, preemption off) serving 8 requests with prompts of 16..5897
   tokens, under CUDA sync-debug "error" mode: every request finishes
   with its token count, the kernel launches equal layers x attention
   calls, at most one device-to-host transfer per step; then a warm
   prefix resubmit gives the same tokens (in bf16 only where the warm
   tail chunk and the cold final chunk have the same shapes, as this
   trace arranges);
5. a 2-layer full-width f32 llama3.2-3b on the card and on the CPU, same
   weights: identical greedy streams, and on each a warm resubmit at a
   length where the warm and cold last chunks differ in shape gives the
   cold tokens;
6. the length-aware cluster at full width: ``MILSServer`` with 4 engines
   on the one card (``repro_torch.launch.serve``'s plan, two stages split
   at 2048 tokens), the flat backend, preemption off, bf16 llama3.2-3b
   with one shared seeded weight set, 16 requests arriving over 8 steps
   (prompts 16..6000 tokens, five just below 2048 that cross the boundary
   while decoding), under sync-debug "error": every request finishes, at
   least 2 live migrations, every engine drains clean, each engine step
   makes at most one device-to-host transfer and two attention-bearing
   forwards, and the flat kernels launch on every layer of those
   forwards and no other kernel runs;
7. the same cluster, f32, 2 layers, 2 engines, 6 requests, preemption
   off, once on the card and once on the CPU: identical decision logs and
   token streams;
8. the cluster with int8 pools, preemption, the host tier and faults
   on: 4 full-width bf16
   engines on int8 pools (fused backend), SLO preemption over an
   interactive/standard/batch mix, a host KV tier on every engine, engine
   1 crashed and rejoined, 30% of transfers lost; under sync-debug
   "error": at least one park, recompute, demote, promote, handover
   migration, redispatch of a crashed engine's residents, rejoin and
   retried lost transfer; every request finished or failed, live engines
   drain clean, at most one device-to-host transfer per engine step, and
   int8 launches equal layers x fused forwards;
9. the same configuration at 2 layers, f32, on 3 engines, once on the
   card and once on the CPU: identical decision logs, streams and
   summary counters; the parked, recomputed and redispatched requests'
   streams equal those of a run with preemption and faults off;
10. phase 6 on the grid backend: the grid decode kernel launches on every
    layer of every decode forward, the chunked prefill kernel on every
    layer of every chunk forward, no other kernel runs, at most one
    device-to-host transfer per engine step, sync-debug "error" clean;
11. phase 4's trace on a dense engine over an int8 pool (gather + masked
    SDPA in plain PyTorch): no kernel launches, every request finishes;
    its greedy streams against the fused int8 engine's on the same trace:
    where a stream parts, both engines, fed the context up to that token,
    must put both streams' tokens within a few bf16 ulps of their best
    logit;
12. phase 7 on grid engines and phase 5 on a dense engine over an int8
    pool, on the card and on the CPU: identical decision logs and streams;
13. the paper's Fig. 2 through ``kernels.api.decode_attention``: the
    padded and ragged contiguous decode kernels on the mixed batches
    200v10000 (batch 512) and 1000v50000 (batch 128, cut from 512 by the
    card's memory), each held to its plain version and to each other (bit
    for bit), and the padded kernel on a homogeneous batch of the same size
    and total tokens: the heterogeneity tax and the ragged speedup; then
    one causal prefill through ``api.prefill_attention`` held to the
    oracle;
14. the engine's other modes at full width (bf16, preemption off, phase
    4's 8 requests arriving one a step): (a) whole-prompt prefill on the
    paged pool (#6 prefills, the fused kernel decodes), (b) the monolithic
    slab (#6 prefills, #5 padded decodes each live slab row in place), (c)
    the host loop on fused, (d) the prefix cache off; under sync-debug
    "error": one device-to-host transfer a step that brings tokens, the
    mode's attention-bearing forwards, each kernel launched on every layer
    of them and no other; steps, TTFT, TPOT, the largest gap between two
    tokens of a request and ``peak_kv_bytes`` (slab against paged); each
    stream that parts from phase 4's passes phase 11's margin check; #6
    at the long prompt's bucket (B 1, T 8192) and #5 padded on the slab's
    8 rows (through its row map) held to their plain versions and timed
    by CUDA events beside SDPA and their bounds (#5 no faster than
    streaming its rows); then the four modes at 2 layers f32 on the card
    and the CPU: equal streams and counters;
15. not run here, for the script's time limit: the H100 cost model
    against the card is ``tools/calibrate_h100.py --fig2-tax X``, run on
    its own (the constants of ``kernels.cost.H100``, the model's step
    times beside the engine's device busy time and host wall, the QoE
    fit);
16. the MoE family at full width: with under 1 GB left allocated,
    qwen3-moe-30b-a3b's 30.1 B bf16 weights drawn on the card: (a) one
    fused engine (8 slots, max_seq 8192, 32768-token pool,
    preemption off) serving phase 4's requests arriving one a step, under
    sync-debug "error", one d2h a step that brings tokens, one forward a
    step, #1 launches == 48 x forwards and nothing else, TTFT/TPOT (the
    step's device time split into the MoE layer, the attention kernel and
    the rest is ``tools/profile_torch_engine.py --arch``'s, run on its
    own); (b) a 2-engine ``MILSServer`` (16384-token pools, stages [0,
    2048) and [2048, inf)) on phase 6's first 8 requests: drained,
    at least one migration, at most one d2h and one forward an engine
    step, #1 launches == 48 x forwards; (c) 2 layers f32 on the card and
    the CPU: equal greedy streams, ``moe_dense`` within 1e-4; (d) arctic-
    480b reduced (its dense residual FFN) the same way;
17. the VLM family at full width: qwen2-vl-7b's 7.6 B bf16 weights alone
    on the card: (a) a flat
    engine serving phase 4's requests (the checks of (a) above, #2 and #3
    launches == 28 x their forwards); (b) a fused engine refusing the
    config (M-RoPE is RoPE-only on the mixed step); (c) ``Model.prefill``
    of 2 x 1024 tokens with ``synthetic_batch``'s vision embeddings and
    M-RoPE ids into a slab and ``decode_step`` of token 1024 (#6, #5
    through ``kv_rows``) against ``forward_full`` at 1025: the argmax
    equal wherever the margin exceeds 8 bf16 ulps, within 1e-4 at 2
    layers f32; (d) 2 layers f32 on the card and the CPU: the flat
    engine's greedy streams equal, the model-level call within 1e-4;
18. starcoder2-3b with the window of 4096 its published config sets
    (the repo's config leaves it unset), bf16, 6.36 GB of weights alone
    on the card: (a) a slab engine (8 slots of a 4096-slot ring, max_seq
    8192) serving prompts of 16..5897 tokens arriving one a step (the two
    beyond the window take the banded plain path, 4080 + 32 wraps its
    ring), under sync-debug "error": every count, one d2h a step that
    brings tokens, #6 == 30 x the prompts within the window, #5 == 30 x
    the decode forwards and nothing else, ``peak_kv_bytes`` the 8 rings
    (1.007 GB); (b) the trace at a window of 8192 and with none: bit-equal
    streams; (c) 2 layers f32 at W 64 on the card and the CPU: equal
    streams; (d) #5 on the ring's rows and #6 at G 12 (measured with
    phase 3's family rows) and the ptxas report of #5's 16-row tile;
19. rwkv6-7b, bf16, 15 GB of weights drawn slice by slice: (a) a slab
    engine (8 rows of recurrent state) on phase 18's arrivals, under
    sync-debug "error" (every count, one d2h a step, no kernel of the
    port: its recurrence is plain PyTorch), then the 5897-token prompt's
    prefill alone (the chunked WKV); (b) one full-width f32 layer at T
    1024: the chunked WKV within 1e-5 of the sequential one (in f32 and
    in f64); (c) 2 slab engines in one ``MILSServer`` on phase 6's first
    8 requests: at least one migration, each piece 34,078,720 B; (d) 2
    layers f32 on the card and the CPU: equal streams;
20. zamba2-2.7b, bf16, 4.85 GB of weights alone on the card: (a)
    ``Model.prefill`` of B 2 prompts of 1024 and of 4096 tokens (the
    chunked SSD, C 128) and 32 greedy decode steps each: walls, the
    state's bytes a request (SSM 70,778,880 B, conv 1,700,352 B, KV
    92,160 B a cached token), peak memory, and no attention kernel (the
    shared block's Dh 80 takes the plain paths by route); (b) one
    full-width block's SSD in f32 at T 1024: chunked within 1e-5 of
    sequential (also against the sequential form in f64), both timed;
    (c) 6 layers f32 on the card and the CPU: prefill logits (1e-4) and
    8 greedy tokens;
21. whisper-large-v3, bf16, 3.08 GB of weights: (a) the encoder over B 2
    x 1500 stub frames, a 4-token prompt's prefill (#6 == 32 launches)
    and 64 greedy decode steps (#5 == 64 a step, 32 on the self-KV and 32
    on the cross-KV, nothing else): walls, the cross-KV's 245,760,000 B
    a request; #6 (B 2, T 448) and #5 on the self- and cross-KV at G 1
    are measured early, in phase 3's ``family_kernels``; (b) 2 + 2 layers
    f32 on the card and the CPU: streams and logits;
22. training: (a) llama3.2-3b at full width, bf16 params, f32 moments, B 2
    x T 1024 from ``TokenStream``, remat, 8 AdamW steps at lr 3e-4: the
    loss, gradient norm, lr, wall, tokens/s and peak memory a step;
    losses finite and falling; #6 == 8 x 28 x 2 launches (remat runs each
    layer's forward twice; backward differentiates #6's plain version),
    nothing else; (b) 2 layers f32 on the card: the wrapped #6's grads
    against plain autograd, one step, a checkpoint round trip (the step
    against the CPU's: phase 24 (b)'s llama3.2-3b case);
23. tensor-parallel serving on the machine's one card: two ranks (this
    process, the leader, and one ``launch.tp_worker``) on ``cuda:0`` over
    gloo (NCCL puts one rank on a card, so it is not measured); (a)
    llama3.2-3b at full width, bf16, as a tp=2 fused engine on phase 4's
    requests: twice phase 4's blocks at the same per-rank budget, each
    rank's pool leaf with 4 of the 8 kv heads and its share of the
    weights (shipped once from the leader), one d2h a step on the leader
    and none on the worker, #1 == 28 x forwards on each rank and nothing
    else, step time, tokens/s, the collectives' time a step and each
    process' peak memory (all "two ranks on one card; not a TP
    speedup"); its streams against phase 4's, where they part phase 11's
    margin rule on fresh whole-prompt tp=1 and tp=2 engines; (b) 2 layers
    f32: tp=2 on the card == tp=1 on the CPU on flat and grid, each rank
    launching its kernels layers x forwards times; (c) a (1, 2, 1) cluster
    at 2 layers f32 whose stages make every request move tp=1 -> tp=2 ->
    tp=1, its stream the unmigrated engine's; #1 at a rank's 12 / 4 heads
    is measured early, in phase 3's ``family_kernels``;
24. sharded training on the machine's one card: two ranks (this process
    and one ``launch.train_worker``) on ``cuda:0`` over gloo; (a)
    llama3.2-3b at full width, bf16, model 2 (tensor parallelism: 12 / 4
    heads, half the FFN and vocab a rank), phase 22's setting for 2
    steps: loss, gradient norm, wall and tokens/s a step, each rank's
    collectives (count, host seconds) and peak memory (all "two ranks on
    one card; not a speedup"); the ranks' metrics equal, the losses
    within one bf16 ulp of phase 22's first 2, #6 == 2 x 28 x 2 launches
    on each rank and nothing else; #6 at a rank's heads on that batch is
    measured early, in phase 3's ``family_kernels``; (b) 2 layers f32:
    llama3.2-3b at (data 1, model 2), smollm-360m at (2, 1), and rwkv6,
    zamba2 and whisper cut to 2 layers at (1, 2) on their per-leaf plans
    (the mechanism asserted: tensor, per-leaf, tensor): loss, gradient
    norm and params after one step (AdamW at eps 1e-5) == the unsharded
    step on the CPU on the same weights within 1e-5; (c)
    whisper's (1, 2) checkpoint reads back
    bit for bit and equals the unsharded run's;
25. the dry run on the card: llama3.2-3b's programs from
    ``launch.cases.build_case`` at (data 1, model 1), bf16, seeded
    weights, each global batch cut to what the card holds (prefill_32k B
    1 x 32768, decode_32k B 8 against 32768 rows, long_500k B 1 on an
    8192-row ring, train_4k B 1 x 4096, which must fit by the trace's
    reckoning): each traced on the CPU under fake meta tensors
    (``launch.dryrun``: FLOPs, bytes, the roofline priced on the H100),
    then one warm run, 2 runs timed by CUDA events and one profiled: ms,
    t_compute, t_memory, dominant, the roofline's share and the device's
    busy share; outputs finite, #6 == 28 a prefill (56 a train step) and
    #5 == 28 a decode and no other kernel, and the card's counted FLOPs
    and bytes equal to the trace's (1e-9); #6 at B 1, T 32768 (held on
    256 query rows at its start, middle and end) and #5 on the 8 rows and
    on the ring are measured early, in phase 3's ``family_kernels``;
26. the per-leaf partition of a rank's program: smollm-360m at full
    width (32 layers, H 15 / Hkv 5, Dh 64), whose heads divide no model
    axis while every dim the rules split does, at (data 1, model 2) on
    two ranks sharing the card over gloo (this process and one
    ``launch.train_worker``); (a) bf16, seeded weights: a prefill of B 2
    x 2048 (#6 on each rank's 15 one-head (row, head) pairs), a decode of
    B 8 against 4096 rows on the cache split on its head dim (partial
    scores all-reduced in f32, no #5) and a train step of B 2 x 1024
    (remat; the loss on vocab-split logits), each
    ``launch.dryrun.run_rank`` on both ranks: ms by CUDA events (1 run
    after a warm one), each rank's collectives (count, host s) and peak
    memory (all "two ranks on one card; not a speedup"); the collectives
    of a run == ``part_collectives`` (counted from the code) == the (1, 2)
    trace's, #6 == 32 a prefill run and 64 a train step on each rank and
    nothing in a decode, rank 0's counted FLOPs and bytes == its trace's
    (1e-9; the traces run in two processes of their own from the start,
    beside the build); #6 on
    the pairs is measured early, in phase 3's ``family_kernels``; (b) 2
    layers f32: each rank's prefill logits and cache slice, a decode
    step's, and a train step's loss, grad norm and params on the card ==
    the unsharded port on the CPU within 1e-5;
27. the expert-split MoE: qwen3-moe-30b-a3b at full width (the repo's
    config: d 2048, H 32 / Hkv 4 / Dh 64, E 128, K 8, d_ff 768),
    ``moe_impl`` "gshard", at (data 1, model 2) on phase 26's two ranks:
    tensor parallelism, each rank running its 64 experts on its kept
    (token, k) pairs (dispatched by index into [64, G, C, D], combined
    by gather, one f32 all-reduce); (a) 4 layers bf16, seeded weights: a
    prefill of B 2 x 2048, a decode of B 8 against 4096 rows (#5 on each
    rank's 2 kv heads) and a train step of B 2 x 1024 (remat), each
    ``launch.dryrun.run_rank`` with ``cfg=`` on both ranks: ms by CUDA
    events (1 run after a warm one), collectives (count, host s), peak
    memory and launches a rank (all "two ranks on one card; not a
    speedup"); the collectives of a run == ``ep_collectives`` == the
    (1, 2) trace's, none an all-gather of an expert leaf, #6 == 4 a
    prefill run and 8 a train step, #5 == 4 a decode run, rank 0's
    counted FLOPs and bytes == its trace's (1e-9); #6 and #5 at a rank's
    16 / 2 heads on those shapes are measured early, in phase 3's
    ``family_kernels``; (b) 2 layers f32: each rank's prefill logits and
    cache slice, a decode step's, and a train step's loss, grad norm and
    params == the unsharded port (its one-hot ``moe_gshard``) on the card
    within 1e-5, with the dropped (token, k) pairs printed (> 0);
28. the per-leaf forms of rwkv6-7b (2 layers), zamba2-2.7b (one group of
    6 Mamba2 blocks and its shared block) and whisper-large-v3 (2 + 2
    layers) at their published widths, at (data 1, model 2) on phase 26's
    two ranks: rwkv6's WKV on the rank's 32 heads, its channel mix on
    half of F; zamba2's Mamba2 blocks split (projection and conv columns
    joined by all-gathers of activations, the SSD on 40 heads, the gated
    norm's sum of squares all-reduced); whisper's attention on 10 heads,
    its cross K/V cache on 750 of the 1500 frames. (a) bf16, seeded
    weights: a prefill of B 2 x 2048 (whisper: 448 decoder tokens over
    its 1500 frames), a decode of B 8 against 4096 rows and a train step
    of B 2 x 1024, each ``launch.dryrun.run_rank`` with ``cfg=`` on both
    ranks: ms by CUDA events (1 run after a warm one), collectives
    (count, host s), peak memory and launches a rank (all "two ranks on
    one card; not a speedup"); the collectives of a run ==
    ``fam_collectives`` == the (1, 2) trace's, none an all-gather of a
    weight leaf, whisper's #6 == layers a prefill run and 2 x layers a
    train step, #5 == layers a decode run, rank 0's counted FLOPs and
    bytes == its trace's (1e-9); #6 and #5 at a whisper rank's heads on
    those shapes are measured early, in phase 3's ``family_kernels``;
    (b) 2 layers f32, B 4: each rank's prefill logits and state slices, and a
    decode step's, == the unsharded port on the CPU within 1e-5 (the
    train step at those cuts is phase 24 (b)'s);
29. the optimized program's levers (``launch.cases.build_case(
    optimized=True)``) on phase 26's two ranks: (a) smollm-360m (phase
    26's config) at (data 1, model 2): a train step of B 2 x 1024 under
    sequence parallelism (levers seq_parallel, zero1) and a decode of B 8
    against 4096 rows on the sequence-split KV cache (seq_cache: Hkv 5
    does not divide 2; the merge is plain, no #5); (b) qwen3-moe-30b-a3b
    at (data 2, model 1): a decode with 2-D experts (F on the data axis)
    at phase 27's 4 layers, beside the baseline at that layout, and a
    ZeRO-1 train step at 1 layer (at 4 two ranks' state passed the
    card; at 2 the phase passed its 45 s budget); each
    ``launch.dryrun.run_rank(optimized=)``:
    ms, collectives (count, host s), peak memory and #5 / #6 launches a
    rank, the collectives of a run == ``opt_collectives`` == the trace's
    (rel 0), the levers those of the reference's rule, rank 0's FLOPs and
    bytes == its trace's; #6 and #5 at (b)'s rank heads are measured
    early, in phase 3's ``family_kernels``; (c) each lever at 2 layers
    f32 (smollm at (1, 2) and (2, 1), qwen3-moe's decode at (2, 1)):
    optimized == baseline on the same inputs (``launch.dryrun.run_pair``)
    within 1e-5;
30. one JSON line of every kernel (the rows of phases 16-18's, 21's,
    23's, 24's, 25's, 26's, 27's, 28's and 29's shapes added), then,
    last, ``{"ok": true, ...}``.

It needs one CUDA card and fails without one; it imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


class Timed(float):
    """An event time (ms) that also carries ``device``: the device time
    of the kernels of one call, and ``kernels``: how many kernels one call
    launched, from ``torch.profiler``."""
    device: float
    kernels: float


def time_ms(torch, fn, iters, flush, device=False):
    """Mean time of ``fn`` from CUDA events around each launch, the L2
    cache flushed before each one by a 512 MB write, which also keeps the
    device busy while the host enqueues ``fn`` (a call whose host work
    outlasts the flush still shows it). ``device``: also the mean device
    time of the kernels ``fn`` launches per call, from ``torch.profiler``
    over another ``iters`` calls (the flush's fill kernel left out), as a
    :class:`Timed`."""
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
    ms = sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters
    if not device:
        return ms
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = launched = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and "fillfunctor" not in e.key.lower():   # the flush
            total += t
            launched += e.count
    out = Timed(ms)
    out.device = total / iters / 1e3
    out.kernels = launched / iters
    return out


def host_us(torch, fn, n=200):
    """Mean host time of one call of ``fn`` in µs (the wrapper's checks,
    scratch and launch), ``n`` calls issued back to back with no
    synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def measured(kernel_ms, library_ms):
    """A kernel row's times: events and device, the kernel's and the
    library call's."""
    return {"ms": float(kernel_ms), "device_ms": kernel_ms.device,
            "library_device_ms": library_ms.device}


def phase_kernels(np, torch, F, tk, flush, H=24, Hkv=8, Dh=128,
                  label="phase 3"):
    """Kernel vs plain on the card at llama3.2-3b head shapes (or another
    config's ``H``/``Hkv``/``Dh``)."""
    BS, C = 16, 256
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
        log(f"{label}: kernel vs plain {name}: max_abs_err={err:.3e} "
            f"(tolerance {tol})")
        res[name] = {"err": err, "inputs": fl}
    fl = res["bf16"]["inputs"]
    kernel_ms = time_ms(torch, lambda: tk.paged_mixed_attention(*fl, *ints),
                        50, flush, device=True)
    wrapper_us = host_us(torch, lambda: tk.paged_mixed_attention(*fl, *ints))
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
        qs, kg, vg, attn_mask=mask), 20, flush, device=True)
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
    log(f"{label}: fused bf16 wrapper: host {wrapper_us:.1f} us per call")
    log(f"{label}: bf16 kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}), plain {plain_ms:.4f} ms, "
        f"library sdpa {library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound {bound_ms:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {
        "max_abs_err": res["bf16"]["err"], "max_abs_err_f32": res["f32"]["err"],
        **measured(kernel_ms, library_ms), "host_us": wrapper_us,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh, out_rows,
               kv_row_bytes=None):
    """(bound ms, "bytes"|"operations", bytes, flops): each needed byte
    moved once (live q rows, the K/V rows the totals cover, shared blocks
    once, ``out_rows`` output rows, tables and lengths), 4*Dh flops per
    (query head, visible key). ``kv_row_bytes`` is one kv head's K (or V)
    row: 2*Dh in bf16, Dh + 4 in int8 with its f32 scale."""
    rows, keys, kv_rows = attention_work(bt, ctx, seg, tags, BS)
    kv_row_bytes = 2 * Dh if kv_row_bytes is None else kv_row_bytes
    nbytes = (rows * H * Dh * 2 + kv_rows * Hkv * kv_row_bytes * 2
              + out_rows * H * Dh * 2 + bt.size * 4 + 3 * len(ctx) * 4)
    flops = 4.0 * keys * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def phase_int8_kernel(np, torch, F, tk, flush):
    """The int8 mode of the fused kernel at phase 3's segments: vs its
    plain version (f32 and bf16 q), vs the bf16 kernel on the unquantized
    pool (per live row cos >= 0.999, max abs <= 0.05), times and bound."""
    from repro_torch.models.attention import quantize_kv
    H, Hkv, Dh, BS, C = 24, 8, 128, 16, 256
    G = H // Hkv
    segs = [("dec", 24), ("ck", 2800, 256), ("dec", 3300), ("dec", 0),
            ("ck", 0, 256), ("dec", 650), ("dec", 770)]
    q, kp, vp, bt, ctx, seg, tags = mixed_case(np, segs, C, H, Hkv, Dh, BS,
                                               (5, 6, 10), SEED)
    dev = torch.device("cuda")
    ints = [torch.from_numpy(a).to(dev) for a in (bt, ctx, seg, tags)]
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a).to(dev))
                          for a in (kp, vp))
    pools = (kq, vq)
    scales = (ks, vs)
    errs = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        qd = torch.from_numpy(q).to(dev, dt)
        got = tk.paged_mixed_attention(qd, *pools, *ints, *scales)
        torch.cuda.synchronize()
        errs[name] = hold(torch, f"int8 mode {name}", got,
                          tk.paged_mixed_attention_plain(qd, *pools, *ints,
                                                         *scales), tol)
        log(f"phase 3: int8 mode vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol})")
    # against the bf16 kernel on the unquantized pool, every live row
    full = tk.paged_mixed_attention(
        qd, *(torch.from_numpy(a).to(dev, torch.bfloat16) for a in (kp, vp)),
        *ints).float()
    got = got.float()
    worst_cos, worst_abs = 1.0, 0.0
    for i, sg in enumerate(segs):
        if sg == ("dec", 0):
            continue
        n = 1 if sg[0] == "dec" else sg[2]
        a, b = got[i, :n].reshape(n, -1), full[i, :n].reshape(n, -1)
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(
            min=1e-12)
        worst_cos = min(worst_cos, cos.min().item())
        worst_abs = max(worst_abs, (a - b).abs().max().item())
    check(worst_cos >= 0.999 and worst_abs <= 0.05,
          f"int8 mode vs unquantized bf16 kernel: cos {worst_cos}, "
          f"abs {worst_abs}")
    log(f"phase 3: int8 mode vs bf16 kernel on the unquantized pool: "
        f"worst live-row cos {worst_cos:.6f} (>= 0.999), max abs "
        f"{worst_abs:.3e} (<= 0.05)")
    kernel_ms = time_ms(torch, lambda: tk.paged_mixed_attention(
        qd, *pools, *ints, *scales), 50, flush, device=True)
    wrapper_us = host_us(torch, lambda: tk.paged_mixed_attention(
        qd, *pools, *ints, *scales))
    plain_ms = time_ms(torch, lambda: tk.paged_mixed_attention_plain(
        qd, *pools, *ints, *scales), 10, flush)
    # library yardstick: one SDPA on K/V dequantized beforehand (bf16)
    S = bt.shape[1] * BS
    kg, vg = sdpa_inputs(torch, [(p.float() * sc[..., None]).to(
        torch.bfloat16) for p, sc in zip(pools, scales)], ints[0], G)
    qs = qd.transpose(1, 2).contiguous()
    r = torch.arange(C, device=dev)[None]
    c_, s_, t_ = (x.long()[:, None] for x in ints[1:])
    limit = torch.where(t_ == 1, torch.minimum(c_ + s_, c_ + r + 1), c_ + s_)
    mask = (torch.arange(S, device=dev)[None, None]
            < limit[..., None])[:, None]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), 20, flush, device=True)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(segs) * C, kv_row_bytes=Dh + 4)
    log(f"phase 3: fused int8 wrapper: host {wrapper_us:.1f} us per call")
    log(f"phase 3: int8 mode (bf16 q) kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}), plain "
        f"{plain_ms:.4f} ms, library sdpa on pre-dequantized K/V "
        f"{library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound {bound_ms:.4f} ms ({by}: "
        f"{nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP)")
    return {"max_abs_err": errs["bf16"], "max_abs_err_f32": errs["f32"],
            "cos_vs_bf16": worst_cos, "abs_vs_bf16": worst_abs,
            **measured(kernel_ms, library_ms), "host_us": wrapper_us,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by}


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


def phase_flat_kernels(np, torch, F, dk, pk, flush, H=24, Hkv=8, Dh=128,
                       label="phase 3"):
    """The flat pair vs plain at llama3.2-3b heads (or another config's
    ``H``/``Hkv``/``Dh``); times and bounds."""
    from repro_torch.kernels.ops import flat_work_list
    BS = 16
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
        check(torch.equal(dk.paged_decode_attention_flat(
            *fl, *ints, num_work=num_work), got),
            f"flat decode {name}: two calls differ")
        log(f"{label}: flat decode vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol}); dead slot 0, two calls "
            f"bit-equal")
    # the main path builds the work list once per decode forward and
    # hands it to every layer: the kernel is timed as a layer calls it
    work = flat_work_list(ints[1], bt.shape[1], BS, num_work)
    # the profiler can drop kernel records: a count under one kernel a
    # call, which no launched call gives, is a lost measurement and is
    # taken again (at most twice); the check below still wants exactly 1
    for _ in range(3):
        kernel_ms = time_ms(torch, lambda: dk.paged_decode_attention_flat(
            *fl, *ints, num_work=num_work, work_list=work), 50, flush,
            device=True)
        if kernel_ms.kernels >= 1:
            break
        log(f"{label}: the profiler recorded {kernel_ms.kernels:g} flat "
            f"decode kernels a call (records lost): measured again")
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
        qs, kg, vg, attn_mask=mask), 20, flush, device=True)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(lens))
    check(kernel_ms.kernels == 1, f"flat decode launched "
          f"{kernel_ms.kernels} kernels a call in the profiler, not 1")
    log(f"{label}: flat decode bf16 kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}; {kernel_ms.kernels:g} kernel a call) ("
        f"{alone_ms:.4f} ms building its work list in the call), plain "
        f"{plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound "
        f"{bound_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP;"
        f" {num_work} work items, {real} real, {dk.ITEMS_PER_RUN} a run)")
    out["decode"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                     errs["f32"],
                     **measured(kernel_ms, library_ms), "with_work_list_ms":
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
        log(f"{label}: chunked prefill vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol})")
    kernel_ms = time_ms(torch, lambda: pk.paged_prefill_attention(
        *fl, *ints), 50, flush, device=True)
    wrapper_us = host_us(torch, lambda: pk.paged_prefill_attention(
        *fl, *ints))
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
        qs, kg, vg, attn_mask=mask), 20, flush, device=True)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(segs) * C)
    log(f"{label}: chunked prefill wrapper: host {wrapper_us:.1f} us per call")
    log(f"{label}: chunked prefill bf16 kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}), plain "
        f"{plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound "
        f"{bound_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP)")
    out["prefill"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                      errs["f32"],
                      **measured(kernel_ms, library_ms), "host_us": wrapper_us,
                      "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": by}
    return out


def launch_counts(tk, dk, pk):
    """Every kernel's launch count, by name."""
    return {"fused": tk.LAUNCHES, "fused_int8": tk.INT8_LAUNCHES,
            "flat_decode": dk.LAUNCHES, "grid_decode": dk.GRID_LAUNCHES,
            "chunked_prefill": pk.LAUNCHES,
            "contiguous_decode_padded": dk.PADDED_LAUNCHES,
            "contiguous_decode_ragged": dk.RAGGED_LAUNCHES,
            "contiguous_prefill": pk.CONTIG_LAUNCHES}


def zero_counts(tk, dk, pk):
    tk.LAUNCHES = tk.INT8_LAUNCHES = 0
    dk.LAUNCHES = dk.GRID_LAUNCHES = 0
    dk.PADDED_LAUNCHES = dk.RAGGED_LAUNCHES = 0
    pk.LAUNCHES = pk.CONTIG_LAUNCHES = 0


def randn(torch, gen, shape, dtype):
    """Seeded normal values made on the card (the Fig. 2 caches are tens of
    GB: numpy would take minutes)."""
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def contiguous_work(lens, H, Hkv, Dh, out_rows):
    """(bytes, flops) the contiguous decode needs: the K/V rows below each
    length (Σ L_b), q and the output once, 4·Dh flops per (query head,
    visible key)."""
    keys = sum(lens)
    nbytes = (keys * Hkv * Dh * 2 * 2 + 2 * out_rows * H * Dh * 2
              + 4 * len(lens))
    return nbytes, 4.0 * keys * H * Dh


def bound_of(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# kernels redesigned for Hopper whose ptxas report phase 3 carries: the
# tensor-core kernels (fused mixed, chunked paged prefill, contiguous
# prefill; library, kernel) and the split-KV decode kernels (grid, flat,
# contiguous)
TENSOR_CORE = (("mixed_attention", "mixed_tc_kernel"),
               ("prefill_attention", "chunk_tc_kernel"),
               ("contiguous_prefill", "prefill_tc_kernel"))
SPLIT_KV = ("grid_split_kernel", "flat_split_kernel",
            "contiguous_split_kernel")
REDESIGNED = tuple(k for _, k in TENSOR_CORE) + SPLIT_KV


def ptxas_report(text):
    """{kernel label: {"registers": n, "spill_bytes": stores + loads}} from
    ``nvcc -Xptxas -v`` output, for the kernels in ``REDESIGNED``; a label
    is the kernel's name, its element type (the pool's, for the fused
    kernel) and its integer template arguments (head dim; rows of the
    split tile)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            name = m.group(1)
            continue
        base = next((k for k in REDESIGNED if name and k in name), None)
        if base is None:
            continue
        # template arguments: an element type (the pool's where the kernel
        # has one: int8 "a", f32 "f", bf16), then integers
        targs = name[name.index(base) + len(base):].split("EEv")[0]
        ints = re.findall(r"Li(\d+)E", targs + "E")
        elem = ("int8" if targs.startswith("Ia") else
                "f32" if targs.startswith("If") else
                "bf16" if "bfloat16" in name else "f32")
        label = f"{base}<{elem}{''.join(',' + n for n in ints)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(label, {})["spill_bytes"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(label, {})["registers"] = int(m.group(1))
    return out


def tensor_core_count(build, name, kernel):
    """Tensor-core instructions (HGMMA, HMMA) in the SASS of the functions
    of library ``name`` whose name holds ``kernel``, by ``cuobjdump``."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {"HGMMA": 0, "HMMA": 0}
    for section in sass.split("Function : ")[1:]:
        if kernel in section.split("\n", 1)[0]:
            for op in counts:
                counts[op] += len(re.findall(rf"\b{op}\.", section))
    return counts


# the paper's Fig. 2 setups (benchmarks/fig2_heterogeneity.py): batch, short
# length, long length; half the batch at each. 1000v50000 is cut from the
# paper's batch 512 to 128: at 512 its K/V would take 105 GB.
FIG2_SETUPS = (("200v10000", 512, 200, 10000), ("1000v50000", 128, 1000,
                                                  50000))
FIG2_HEADS = (24, 8, 128)          # llama3.2-3b, AttnSpec(24, 8, 128)
FIG2_BLOCK = 512
# the contiguous prefill's shape: B 2, T 4096, row lengths
PREFILL_T, PREFILL_LENS = 4096, (4096, 4059)


def phase_grid_contiguous_kernels(np, torch, F, tk, dk, pk, flush):
    """Phase 3, kernels #4-#6 vs their plain versions; times and bounds:
    the grid decode kernel at #2's rows (also held to #2's output, and
    timed beside the fused kernel on the same rows with C = 1), the
    contiguous decode kernel in both modes at the 200v10000 setup, the
    contiguous prefill kernel at B 2, T 4096."""
    H, Hkv, Dh = FIG2_HEADS
    G = H // Hkv
    dev = torch.device("cuda")
    out = {}

    # ---- #4: grid paged decode, at #2's rows (24, 3300, 650, 770, dead)
    BS = 16
    lens = [24, 3300, 650, 770, 0]
    q4, kp, vp, bt, ctx, seg, tags = mixed_case(
        np, [("dec", n) for n in lens], 1, H, Hkv, Dh, BS, (2, 3, 10), SEED)
    ints = [torch.from_numpy(a).to(dev) for a in (bt, np.asarray(lens,
                                                                 np.int32))]
    errs = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        fl = [torch.from_numpy(a).to(dev, dt) for a in (q4[:, 0], kp, vp)]
        got = dk.paged_decode_attention(*fl, *ints)
        torch.cuda.synchronize()
        errs[name] = hold(torch, f"grid decode {name}", got,
                          dk.paged_decode_attention_plain(*fl, *ints), tol)
        flat_err = hold(torch, f"grid vs flat decode {name}", got,
                        dk.paged_decode_attention_flat(*fl, *ints), tol)
        check(not got[-1].float().abs().max().item(), "dead slot not zero")
        log(f"phase 3: grid decode vs plain {name}: max_abs_err="
            f"{errs[name]:.3e}, vs the flat kernel {flat_err:.3e} "
            f"(tolerance {tol})")
    kernel_ms = time_ms(torch, lambda: dk.paged_decode_attention(*fl, *ints),
                        50, flush, device=True)
    wrapper_us = host_us(torch, lambda: dk.paged_decode_attention(*fl,
                                                                  *ints))
    plain_ms = time_ms(torch, lambda: dk.paged_decode_attention_plain(
        *fl, *ints), 10, flush)
    kg, vg = sdpa_inputs(torch, fl[1:], ints[0], G)
    S = kg.shape[2]
    mask = (torch.arange(S, device=dev)[None]
            < ints[1].clamp(min=1)[:, None])[:, None, None]   # [B,1,1,S]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        fl[0][:, :, None], kg, vg, attn_mask=mask), 20, flush, device=True)
    bound_ms, by, nb, fo = work_bound(bt, ctx, seg, tags, BS, H, Hkv, Dh,
                                      len(lens))
    S, P = dk.grid_split_plan(Hkv, bt.shape[1], BS, dk._sm_count(dev))
    log(f"phase 3: grid decode wrapper: host {wrapper_us:.1f} us per call")
    log(f"phase 3: grid decode bf16 kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}), plain "
        f"{plain_ms:.4f} ms, library sdpa {library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound "
        f"{bound_ms:.4f} ms ({by}: {nb / 1e6:.1f} MB, {fo / 1e9:.2f} GFLOP); "
        f"{nb / kernel_ms / 1e9:.3f} TB/s, {bound_ms / kernel_ms:.1%} of "
        f"the bound; split plan S {S}, P {P}")
    out["grid"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                   errs["f32"],
                   **measured(kernel_ms, library_ms), "host_us": wrapper_us,
                   "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": by, "rate": nb / kernel_ms / 1e9,
                   "rate_unit": "TB/s"}
    # #1 on the same rows, C = 1 (every decode step of the fused engine),
    # beside #4: decode segments (ctx = length - 1, seg 1, tag 0)
    seg_ints = [torch.from_numpy(a).to(dev) for a in (ctx, seg, tags)]
    q1 = fl[0][:, None].contiguous()                          # [B,1,H,Dh]

    def fused():
        return tk.paged_mixed_attention(q1, fl[1], fl[2], ints[0],
                                        *seg_ints)
    got = fused()
    torch.cuda.synchronize()
    fused_err = hold(torch, "fused decode-only bf16", got[:, 0],
                     dk.paged_decode_attention_plain(*fl, *ints), 5e-3)
    fused_ms = time_ms(torch, fused, 50, flush, device=True)
    log(f"phase 3: fused kernel on the same rows (C 1): {fused_ms:.4f} ms "
        f"(device {fused_ms.device:.4f}), {fused_ms / kernel_ms:.2f}x the "
        f"grid kernel's events ({fused_ms.device / kernel_ms.device:.2f}x "
        f"device); max_abs_err vs plain {fused_err:.3e} (tolerance 5e-3)")
    out["fused_decode_only"] = {"ms": float(fused_ms),
                                "device_ms": fused_ms.device,
                                "max_abs_err": fused_err,
                                "vs_grid": fused_ms / kernel_ms,
                                "vs_grid_device":
                                    fused_ms.device / kernel_ms.device}
    del fl, kg, vg, q1

    # ---- #5: contiguous decode, padded and ragged, at 200v10000
    _, B, short, long_ = FIG2_SETUPS[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for mode in ("padded", "ragged"):
        out[mode] = {}
    # f32 on 64 rows of the setup (32 short, 32 long): 5.2 GB of K/V
    half = min(32, B // 2)
    sub = [short] * half + [long_] * half
    q, k, v = (randn(torch, gen, (len(sub), *shape), torch.float32)
               for shape in ((H, Dh), (long_, Hkv, Dh), (long_, Hkv, Dh)))
    lengths = torch.tensor(sub, dtype=torch.int32, device=dev)
    for mode, ragged in (("padded", False), ("ragged", True)):
        got = dk.decode_attention(q, k, v, lengths, block_s=FIG2_BLOCK,
                                  ragged=ragged)
        torch.cuda.synchronize()
        out[mode]["max_abs_err_f32"] = hold(
            torch, f"contiguous decode {mode} f32", got,
            dk.decode_attention_plain(q, k, v, lengths, block_s=FIG2_BLOCK,
                                      ragged=ragged), 1e-4)
    del q, k, v
    torch.cuda.empty_cache()
    # bf16 at the whole setup: 20.97 GB of K/V
    lens = [short] * (B // 2) + [long_] * (B // 2)
    q, k, v = (randn(torch, gen, (B, *shape), torch.bfloat16)
               for shape in ((H, Dh), (long_, Hkv, Dh), (long_, Hkv, Dh)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    nb, fo = contiguous_work(lens, H, Hkv, Dh, B)
    bound_ms, by = bound_of(nb, fo)
    # the padded mode must stream the whole cache: its own floor
    stream_ms = 2 * k.numel() * k.element_size() / HBM_BYTES_PER_S * 1e3
    # library: one SDPA over the caches as they lie, a bool length mask; the
    # G query heads of each kv head ride as its query rows (enable_gqa's
    # function, without expanding K/V threefold past the card's memory)
    mask = (torch.arange(long_, device=dev)[None]
            < lengths[:, None])[:, None, None]                # [B,1,1,S]
    qr = q.reshape(B, Hkv, G, Dh)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)             # [B,Hkv,S,Dh]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qr, kt, vt, attn_mask=mask), 5, flush, device=True)
    for mode, ragged in (("padded", False), ("ragged", True)):
        got = dk.decode_attention(q, k, v, lengths, block_s=FIG2_BLOCK,
                                  ragged=ragged)
        torch.cuda.synchronize()
        err = hold(torch, f"contiguous decode {mode} bf16", got,
                   dk.decode_attention_plain(q, k, v, lengths,
                                             block_s=FIG2_BLOCK,
                                             ragged=ragged), 5e-3)
        kernel_ms = time_ms(torch, lambda: dk.decode_attention(
            q, k, v, lengths, block_s=FIG2_BLOCK, ragged=ragged), 10, flush,
            device=True)
        plain_ms = time_ms(torch, lambda: dk.decode_attention_plain(
            q, k, v, lengths, block_s=FIG2_BLOCK, ragged=ragged), 2, flush)
        if not ragged:
            check(min(kernel_ms, kernel_ms.device) >= stream_ms,
                  f"padded contiguous decode timed at {kernel_ms:.4f} ms "
                  f"(device {kernel_ms.device:.4f}), below the "
                  f"{stream_ms:.4f} ms that streaming its whole cache takes:"
                  f" it skipped blocks")
            out[mode]["stream_bound_ms"] = stream_ms
        log(f"phase 3: contiguous decode {mode} vs plain: max_abs_err "
            f"f32 {out[mode]['max_abs_err_f32']:.3e} ({2 * half} rows), bf16 "
            f"{err:.3e} (tolerances 1e-4, 5e-3); bf16 kernel "
            f"{kernel_ms:.4f} ms (device {kernel_ms.device:.4f}; "
            f"{nb / kernel_ms / 1e9:.3f} TB/s of needed bytes, "
            f"{2 * k.numel() * k.element_size() / kernel_ms / 1e9:.3f} TB/s "
            f"of the whole cache), plain {plain_ms:.4f} ms, library sdpa "
            f"{library_ms:.4f} ms (device {library_ms.device:.4f}), bound "
            f"{bound_ms:.4f} ms ({by}: {nb / 1e9:.3f} GB, "
            f"{fo / 1e9:.2f} GFLOP), padded streaming bound {stream_ms:.4f} "
            f"ms, at B {B}, S {long_}; split plan "
            f"{dk.contiguous_split_plan(B, long_, Hkv, FIG2_BLOCK, dk._sm_count(dev))}")
        out[mode].update({"max_abs_err": err,
                          **measured(kernel_ms, library_ms),
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": by})
    del q, k, v, kt, vt, qr, mask
    torch.cuda.empty_cache()
    stale = {key: int(a.count_nonzero()) for key, a in dk._ARRIVALS.items()
             if a.count_nonzero()}
    check(not stale, f"split-KV arrival counts left non-zero: {stale}")
    log("phase 3: every split-KV arrival count is back at 0")

    # ---- #6: contiguous causal prefill at B 2, T 4096
    T, plens = PREFILL_T, PREFILL_LENS
    errs = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 5e-3)):
        q, k, v = (randn(torch, gen, (2, T, n, Dh), dt) for n in (H, Hkv, Hkv))
        lengths = torch.tensor(plens, dtype=torch.int32, device=dev)
        got = pk.prefill_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        errs[name] = hold(torch, f"contiguous prefill {name}", got,
                          pk.prefill_attention_plain(q, k, v, lengths), tol)
        log(f"phase 3: contiguous prefill vs plain {name}: max_abs_err="
            f"{errs[name]:.3e} (tolerance {tol})")
    kernel_ms = time_ms(torch, lambda: pk.prefill_attention(q, k, v, lengths),
                        10, flush, device=True)
    plain_ms = time_ms(torch, lambda: pk.prefill_attention_plain(
        q, k, v, lengths), 3, flush)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 10, flush, device=True)
    pairs = sum(min(t + 1, n) for n in plens for t in range(T))
    nb = 2 * T * (H + 2 * Hkv + H) * Dh * 2 + 2 * 4
    bound_ms, by = bound_of(nb, 4.0 * pairs * H * Dh)
    flops = 4.0 * pairs * H * Dh
    log(f"phase 3: contiguous prefill bf16 kernel {kernel_ms:.4f} ms (device "
        f"{kernel_ms.device:.4f}), plain "
        f"{plain_ms:.4f} ms, library sdpa (is_causal, enable_gqa) "
        f"{library_ms:.4f} ms (device "
        f"{library_ms.device:.4f}), bound {bound_ms:.4f} ms ({by}: "
        f"{nb / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / kernel_ms:.1%} of the bound")
    out["prefill"] = {"max_abs_err": errs["bf16"], "max_abs_err_f32":
                      errs["f32"],
                      **measured(kernel_ms, library_ms), "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": by, "rate": flops / kernel_ms / 1e9,
                      "rate_unit": "TFLOP/s"}
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
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                            preemption=False)
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
        "streams": [list(r.generated) for r in reqs],
        "num_blocks": eng.num_blocks,
    }
    del eng, params
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# Phase 11: the dense backend on int8 pools, against the fused int8 engine
# --------------------------------------------------------------------------
MARGIN_ULPS = 8


def bf16_ulp(x):
    """The spacing of bf16 numbers at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _first_token_logits(np, torch, dataclasses_mod, model, params,
                        engine_mod, request_mod, tokens, **engine_kw):
    """The first-token logits [V] (f32, on the host) of ``tokens`` as one
    prompt through a fresh engine built with ``engine_kw``: what that
    engine decides after this context (its last chunk's, or its whole
    prompt's, last-position logits)."""
    seen = []

    def spied(fn, logits_at):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.append(out[logits_at][0])
            return out
        return call

    spy = dataclasses_mod.replace(
        model, prefill_chunk=spied(model.prefill_chunk, 0),
        mixed_step=spied(model.mixed_step, 1),
        prefill=spied(model.prefill, 0),
        prefill_bucketed=spied(model.prefill_bucketed, 0))
    eng = engine_mod.Engine(0, spy, params, max_slots=1, max_seq=8192,
                            preemption=False, **engine_kw)
    r = request_mod.ServeRequest(0, np.asarray(tokens, np.int32), 1)
    eng.submit(r)
    while not eng.step():
        check(eng.steps < 200, "margin probe did not finish")
    eng.shutdown()
    return seen[-1].float().cpu()


def phase_dense_int8_engine(np, torch, cfg_mod, model_mod, engine_mod,
                            request_mod, tk, dk, pk):
    """Phase 4's full-width trace on a dense engine over an int8 pool: no
    attention kernel runs, every request finishes, at most one d2h per
    step; its greedy streams against the fused int8 engine's on the same
    trace. Where a stream diverges, each engine is fed the context up to
    that token and must hold both streams' tokens within ``MARGIN_ULPS``
    bf16 ulps of its best logit."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params = model.init(SEED, device="cuda")
    runs = {}
    for backend in ("dense", "fused"):
        eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                                attn_backend=backend, kv_dtype="int8",
                                preemption=False)
        rng = np.random.default_rng(SEED)
        reqs = [request_mod.ServeRequest(
            i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(PROMPTS, NEW_TOKENS))]
        for r in reqs:
            eng.submit(r)
        zero_counts(tk, dk, pk)
        a0 = engine_mod.ATTN_CALLS
        done, worst = [], 0
        t0 = time.perf_counter()
        while len(done) < len(reqs):
            check(eng.steps < 2000, "engine did not drain")
            d0 = engine_mod.D2H_CALLS
            done += eng.step()
            worst = max(worst, engine_mod.D2H_CALLS - d0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards = engine_mod.ATTN_CALLS - a0
        launches = launch_counts(tk, dk, pk)
        check(worst <= 1, f"{backend}: a step made {worst} d2h")
        for r in reqs:
            check(len(r.generated) == r.max_new_tokens and not r.rejected,
                  f"{backend} request {r.req_id}: {len(r.generated)} tokens")
        if backend == "dense":
            check(not any(launches.values()),
                  f"the dense engine launched kernels: {launches}")
        else:
            check(launches["fused_int8"] == cfg.num_layers * forwards > 0,
                  f"int8 launches {launches['fused_int8']} != "
                  f"{cfg.num_layers} x {forwards}")
        eng.check_drained()
        eng.shutdown()
        ntok = sum(len(r.generated) for r in reqs)
        runs[backend] = {"streams": [list(r.generated) for r in reqs],
                         "steps": eng.steps, "wall_s": wall,
                         "forwards": forwards, "tokens_per_s": ntok / wall,
                         "launches": launches}
        log(f"phase 11: {backend} engine on an int8 pool, phase 4's trace: "
            f"{eng.steps} steps, {forwards} attention-bearing forwards, "
            f"{wall:.3f} s, {ntok / wall:.1f} tokens/s; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        del eng
    dense, fused = runs["dense"]["streams"], runs["fused"]["streams"]
    same = sum(a == b for a, b in zip(dense, fused))
    diverged = []
    for i, (a, b) in enumerate(zip(dense, fused)):
        if a == b:
            continue
        j = next(x for x in range(len(a)) if a[x] != b[x])
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in PROMPTS]
        ctx = list(prompts[i]) + a[:j]
        row = {"request": i, "token": j, "dense": a[j], "fused": b[j]}
        for backend in ("dense", "fused"):
            lg = _first_token_logits(np, torch, dataclasses, model, params,
                                     engine_mod, request_mod, ctx,
                                     attn_backend=backend, kv_dtype="int8")
            top2 = torch.topk(lg, 2).values
            top = float(top2[0])
            behind = max(top - float(lg[a[j]]), top - float(lg[b[j]]))
            tol = MARGIN_ULPS * bf16_ulp(top)
            # both streams' tokens must be near-ties of this probe's best:
            # a wrong dense gather or int8 kernel picks tokens far behind
            check(behind <= tol, f"phase 11: request {i} token {j}: the "
                  f"{backend} probe puts a stream's token {behind} behind "
                  f"its best {top} (> {MARGIN_ULPS} bf16 ulps, {tol})")
            row[f"{backend}_top"] = top
            row[f"{backend}_top2_gap"] = float(top2[0] - top2[1])
            row[f"{backend}_gap_between_the_two"] = float(lg[a[j]] - lg[b[j]])
            row[f"{backend}_behind_best"] = behind
            row[f"{backend}_tolerance"] = tol
        diverged.append(row)
    log(f"phase 11: dense int8 vs fused int8 greedy streams: {same}/"
        f"{len(dense)} identical" + (
            "; where they part, each probe has both tokens within "
            f"{MARGIN_ULPS} bf16 ulps of its best; the margins: "
            + json.dumps(diverged) if diverged else ""))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "identical_streams": same, "diverged": diverged}


# --------------------------------------------------------------------------
# Phase 5: the same weights on the card and on the CPU
# --------------------------------------------------------------------------
def phase_devices(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
                  backend="fused", kv_dtype="bf16", label="phase 5"):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = cpu_weights(model)
    gpu_params = _tree_to(cpu_params, torch.device("cuda"))
    streams = {}
    for name, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = engine_mod.Engine(0, model, params, max_slots=3, max_seq=512,
                                prefill_token_budget=64, preemption=False,
                                attn_backend=backend, kv_dtype=kv_dtype)
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
    log(f"{label}: 2-layer full-width f32 llama3.2-3b on {backend} "
        f"({kv_dtype} pool), cuda == cpu greedy "
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
                  server_mod, serve_mod, qoe_mod, tk, dk, pk, backend="flat",
                  label="phase 6"):
    """The full-width cluster on the ``flat`` (phase 6) or ``grid``
    (phase 10) backend: the backend's decode kernel launches on every
    layer of every decode forward, the chunked prefill kernel on every
    layer of every chunk forward, and no other kernel runs."""
    decode_key = {"flat": "flat_decode", "grid": "grid_decode"}[backend]
    gc.collect()
    torch.cuda.empty_cache()
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
                                balancing="full", seed=SEED,
                                preemption=False),
        engine_factory=lambda i: engine_mod.Engine(
            i, model, params, max_slots=8, max_seq=8192, token_budget=32768,
            attn_backend=backend, preemption=False))
    torch.cuda.synchronize()
    e0 = srv.engines[0]
    log(f"{label}: {backend} backend, 4 engines, one bf16 llama3.2-3b "
        f"weight set, pools of "
        f"{e0.num_blocks + 1} blocks x {e0.block_size} tokens each, ready "
        f"in {time.perf_counter() - t0:.1f} s; stage bounds "
        f"{srv.stage_bounds}")
    reqs = _submit_trace(np, request_mod, srv, CLUSTER_TRACE,
                         cfg.vocab_size, SEED + 2)

    # forwards by kind, and each engine step's transfers and forwards
    kinds = {"prefill": 0, "decode": 0}
    real_attn_call = engine_mod.attn_call

    def attn_call(fn, *a, **k):
        # the engine's chunk forward is its device op ``_chunk_forward``
        chunk = fn.__name__ == "_chunk_forward"
        kinds["prefill" if chunk else "decode"] += 1
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
    zero_counts(tk, dk, pk)
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
    launches = launch_counts(tk, dk, pk)
    for eng in srv.engines:
        eng.check_drained(strict=True)
    L = cfg.num_layers
    check(worst["d2h"] <= 1, f"an engine step made {worst['d2h']} d2h")
    check(worst["attn"] <= 2, f"an engine step made {worst['attn']} "
          "attention-bearing forwards")
    check(launches[decode_key] == L * kinds["decode"] > 0,
          f"{backend} decode launches {launches[decode_key]} != {L} x "
          f"{kinds['decode']} decode forwards")
    check(launches["chunked_prefill"] == L * kinds["prefill"] > 0,
          f"chunked prefill launches {launches['chunked_prefill']} != {L} x "
          f"{kinds['prefill']} prefill forwards")
    others = {k: n for k, n in launches.items()
              if n and k not in (decode_key, "chunked_prefill")}
    check(not others, f"the {backend} cluster ran other kernels: {others}")
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
    log(f"{label}: {len(reqs)} requests drained in {srv.steps} steps, "
        f"{wall:.3f} s; {ntok} tokens, {ntok / wall:.1f} tokens/s; "
        f"{srv.migrations} migrations ({srv.migrated_bytes / 1e6:.1f} MB "
        f"moved); peak memory {peak_gb:.2f} GB; stage bounds "
        f"{srv.stage_bounds}")
    log(f"{label}: migrations by stage pair " + json.dumps(
        {k: v for k, v in summ.items() if k.startswith("migrations_s")}))
    log(f"{label}: steps " + json.dumps(
        {k: summ[k] for k in summ if k.startswith(("ttft_steps_p",
                                                   "e2e_steps_p"))}))
    log(f"{label}: seconds " + json.dumps(pct))
    log(f"{label}: server step ms mean {sum(step_ms) / len(step_ms):.2f} "
        f"min {min(step_ms):.2f} max {max(step_ms):.2f}; forwards: "
        f"{kinds['prefill']} prefill, {kinds['decode']} decode "
        f"({worst['both']} engine steps made both); launches: "
        f"{backend} decode {launches[decode_key]}, chunked prefill "
        f"{launches['chunked_prefill']}, any other 0")
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
    gc.collect()       # the counting wrappers hold their engines in a cycle
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
                          server_mod, serve_mod, qoe_mod, backend="flat",
                          label="phase 7"):
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = cpu_weights(model)
    runs = {}
    for name, params in (("cuda", _tree_to(cpu_params, torch.device("cuda"))),
                         ("cpu", cpu_params)):
        srv = server_mod.MILSServer(
            model, params, serve_mod.default_plan(2, 512),
            qoe_mod.QoEModel(np.array(serve_mod.DEFAULT_QOE)),
            server_mod.ServerConfig(seed=SEED, preemption=False),
            max_slots=4, max_seq=512, prefill_token_budget=64,
            attn_backend=backend)
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
    log(f"{label}: 2-layer full-width f32 llama3.2-3b cluster of 2 "
        f"{backend} engines, cuda == cpu: {len(runs['cuda'][0])} decisions "
        f"({runs['cuda'][2]} migrations), identical token streams (first "
        f"tokens {[g[:4] for g in runs['cuda'][1]]})")


# --------------------------------------------------------------------------
# Phases 8 and 9: int8 pools, SLO preemption, the host tier and faults
# --------------------------------------------------------------------------
# (prompt tokens, new tokens, arrival step, SLO class, shared-prefix
# tokens): the prefix is one 1024-token run drawn once, shared by the
# requests that give it. default_plan(4, 8192) splits the stages at 2048
# tokens (engines 0-1 | 2-3).
CHAOS_TRACE = (
    # stage 1: three long batch prompts fill engines 2-3; a long
    # interactive prompt then finds no memory: recompute-preempt
    (3500, 48, 0, "batch", 0), (3600, 40, 0, "batch", 0),
    (3400, 40, 1, "batch", 0),
    # stage 0: a shared-prefix prompt that finishes early (its chain stays
    # cached on its engine), short batch decodes filling the seats, and
    # prompts just below 2048 that cross the boundary while decoding
    (1400, 8, 0, "standard", 1024), (200, 64, 0, "batch", 0),
    (300, 64, 1, "batch", 0), (2000, 64, 1, "standard", 0),
    (150, 64, 2, "batch", 0), (2010, 56, 2, "standard", 0),
    (250, 64, 3, "batch", 0), (120, 64, 3, "batch", 0),
    # interactive arrivals: seats are full in stage 0 (park), memory is
    # short in stage 1 (recompute)
    (90, 16, 12, "interactive", 0), (2600, 16, 34, "interactive", 0),
    (60, 16, 13, "interactive", 0),
    # pressure on the surviving stage-0 engine while engine 1 is down,
    # then the shared prefix again: demote, then promote
    (1900, 24, 22, "standard", 0), (1950, 24, 23, "standard", 0),
    (1800, 24, 24, "standard", 0), (1500, 16, 44, "standard", 1024),
    (2030, 40, 26, "standard", 0), (400, 32, 46, "interactive", 0),
    # a long prompt late in the trace, chunking for 23 steps
    (5900, 16, 50, "standard", 0))
CHAOS_FAULTS = dict(seed=3, crashes=((1, 10),), rejoins=((1, 40),),
                    transfer_loss_p=0.3)
CHAOS_ENGINE = dict(max_slots=4, max_seq=8192, token_budget=8192,
                    attn_backend="fused", kv_dtype="int8",
                    host_kv_budget=4096, preemption=True,
                    slo_time_scale=20.0)


def _chaos_requests(np, request_mod, trace, vocab, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 1024).astype(np.int32)
    out = []
    for i, (n, new, at, cls, pre) in enumerate(trace):
        p = rng.integers(0, vocab, n).astype(np.int32)
        p[:pre] = prefix[:pre]
        r = request_mod.ServeRequest(i, p, new)
        r.slo_class = cls
        out.append((r, at))
    return out


def chaos_server(np, model, params, server_mod, serve_mod, qoe_mod,
                 engine_mod, faults, num_engines, max_seq, engine_kw,
                 made):
    """A ``MILSServer`` with int8 pools, preemption, the host tier and
    faults on (as ``engine_kw`` and ``faults`` set them); every engine it
    makes (the first ones, and the fresh ones a crash or a rejoin swaps
    in) is appended to ``made``."""
    from repro_torch.control.faults import FaultSpec

    def factory(i):
        eng = engine_mod.Engine(i, model, params, **engine_kw)
        made.append(eng)
        return eng

    return server_mod.MILSServer(
        model, params, serve_mod.default_plan(num_engines, max_seq),
        qoe_mod.QoEModel(np.array(serve_mod.DEFAULT_QOE)),
        server_mod.ServerConfig(
            seed=SEED, kv_dtype=engine_kw["kv_dtype"],
            preemption=engine_kw["preemption"],
            host_kv_budget=engine_kw["host_kv_budget"],
            slo_time_scale=engine_kw["slo_time_scale"],
            faults=FaultSpec(**faults) if faults else None),
        engine_factory=factory)


def chaos_events(srv, made):
    """Counts of the events phases 8 and 9 must see, over every engine the
    server ever ran (a crash drops the carcass' counters from the
    summary)."""
    log = srv.plane.decisions
    fails = {d[1] for d in log if d[0] == "mig_fail"}
    retried = {d[1] for i, d in enumerate(log) if d[0] == "migrate"
               and d[1] in fails
               and any(e[0] == "mig_fail" and e[1] == d[1]
                       for e in log[:i])}
    total = {k: sum(getattr(e, k) for e in made)
             for k in ("preemptions", "preempt_recomputes", "resumes",
                       "cache_demotions", "cache_promotions")}
    return {
        "parks": total["preemptions"] - total["preempt_recomputes"],
        "recomputes": total["preempt_recomputes"],
        "resumes": total["resumes"],
        "demotes": total["cache_demotions"],
        "promotes": total["cache_promotions"],
        "handovers": sum(n for (a, b), n in
                         srv.plane.migrations_by_stage.items() if b > a),
        "dead": sum(1 for d in log if d[0] == "dead"),
        "redispatches": sum(1 for d in log if d[0] == "redispatch"),
        "rejoins": sum(1 for d in log if d[0] == "rejoin"),
        "retried_lost_transfers": len(retried),
    }


def phase_chaos_cluster(np, torch, cfg, model_mod, engine_mod, request_mod,
                        server_mod, serve_mod, qoe_mod, tk):
    """Phase 8: the full-width cluster with int8 pools, preemption, the
    host tier and faults on, under sync-debug "error"."""
    model = model_mod.build_model(cfg)
    gc.collect()                    # earlier phases' weights and pools
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    made = []
    srv = chaos_server(np, model, params, server_mod, serve_mod, qoe_mod,
                       engine_mod, CHAOS_FAULTS, 4, 8192, CHAOS_ENGINE,
                       made)
    torch.cuda.synchronize()
    e0 = srv.engines[0]
    kv_tok = e0._bytes_per_block / e0.block_size
    kv_tok_bf16 = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    log(f"phase 8: 4 engines, one bf16 {cfg.name} weight set, int8 pools "
        f"of {e0.num_blocks + 1} blocks x {e0.block_size} tokens, "
        f"{kv_tok:.0f} B of KV per token ({kv_tok_bf16} B in bf16, "
        f"{kv_tok_bf16 / kv_tok:.3f}x), host tier "
        f"{CHAOS_ENGINE['host_kv_budget']} tokens per engine; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = []
    for r, at in _chaos_requests(np, request_mod, CHAOS_TRACE,
                                 cfg.vocab_size, SEED + 5):
        srv.submit_at(r, at)
        reqs.append(r)
    real_step = engine_mod.Engine.step
    worst = {"d2h": 0}

    def counted(self, burst=1):
        d0 = engine_mod.D2H_CALLS
        out = real_step(self, burst)
        worst["d2h"] = max(worst["d2h"], engine_mod.D2H_CALLS - d0)
        return out

    a0 = engine_mod.ATTN_CALLS
    tk.INT8_LAUNCHES = 0
    engine_mod.Engine.step = counted
    t_end = {0: 0.0}
    step_ms = []
    t_start = time.perf_counter()
    try:
        while len(srv.finished) < srv.submitted:
            check(srv.steps < 1500, "cluster did not drain")
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
        engine_mod.Engine.step = real_step
    wall = time.perf_counter() - t_start
    forwards = engine_mod.ATTN_CALLS - a0
    launches = tk.INT8_LAUNCHES
    for eng in srv.engines:
        if eng.id not in srv.crashed:
            eng.check_drained(strict=True)
    # a crashed engine's pool is freed: what stays allocated is the weights
    # and one pool per engine slot (the rejoined engine's, not two)
    from repro_torch.core.migration import kv_bytes
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    pools = sum(kv_bytes(e.cache) for e in srv.engines)
    held = torch.cuda.memory_allocated() - base
    check(held < weights + pools + 256 * 2 ** 20,
          f"{held / 1e9:.2f} GB held after the run: weights "
          f"{weights / 1e9:.2f} GB + 4 pools {pools / 1e9:.2f} GB")
    check(len(made) == 6 and all(e.cache is None for e in made
                                 if e not in srv.engines),
          "a crashed engine kept its pool")
    check(worst["d2h"] <= 1, f"an engine step made {worst['d2h']} d2h")
    check(launches == cfg.num_layers * forwards > 0,
          f"int8 launches {launches} != {cfg.num_layers} x {forwards} "
          "fused forwards")
    for r in reqs:
        check(r.state.name == "FINISHED", f"request {r.req_id} unfinished")
        check(r.failed or len(r.generated) == r.max_new_tokens,
              f"request {r.req_id}: {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.req_id}: token out of range")
    ev = chaos_events(srv, made)
    for k, v in ev.items():
        check(v >= 1, f"phase 8: no {k} ({ev})")
    summ = srv.summary()
    served = [r for r in reqs if not r.failed and not r.rejected]
    ttft_s = [t_end[r.first_token_step] - t_end[r.arrival_step]
              for r in served]
    e2e_s = [t_end[r.finish_step] - t_end[r.arrival_step] for r in served]
    pct = {f"{name}_p{p}": float(np.percentile(v, p))
           for name, v in (("ttft_s", ttft_s), ("e2e_s", e2e_s))
           for p in (50, 95, 99)}
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    ntok = sum(len(r.generated) for r in reqs)
    log(f"phase 8: {len(reqs)} requests ({summ['failed']} failed) drained "
        f"in {srv.steps} steps, {wall:.3f} s; {ntok} tokens, "
        f"{ntok / wall:.1f} tokens/s; {srv.migrations} migrations "
        f"({srv.migrated_bytes / 1e6:.1f} MB moved); peak memory "
        f"{peak_gb:.2f} GB (weights {weights / 1e9:.2f} GB, 4 pools "
        f"{pools / 1e9:.2f} GB; {held / 1e9:.2f} GB held after the run, "
        f"{len(made)} engines made, the 2 replaced ones freed); int8 "
        f"launches {launches} = {cfg.num_layers} x {forwards} fused "
        f"forwards")
    log("phase 8: events " + json.dumps(ev))
    log("phase 8: steps " + json.dumps(
        {k: summ[k] for k in summ if k.startswith(("ttft_steps_p",
                                                   "e2e_steps_p"))}))
    log("phase 8: seconds " + json.dumps(pct))
    log("phase 8: SLO " + json.dumps(
        {k: summ[k] for k in summ if k.startswith("slo_")}))
    log("phase 8: counters " + json.dumps(
        {k: summ[k] for k in ("preemptions", "preempt_recomputes", "resumes",
                              "tpot_skipped", "cache_demotions",
                              "cache_drops", "cache_promotions",
                              "promoted_blocks_total", "rejected", "failed",
                              "redispatched", "retries", "downtime_total")}))
    log(f"phase 8: server step ms mean {sum(step_ms) / len(step_ms):.2f} "
        f"min {min(step_ms):.2f} max {max(step_ms):.2f}")
    summary = {"steps": srv.steps, "wall_s": wall, "tokens": ntok,
               "tokens_per_s": ntok / wall, "step_ms": step_ms,
               "migrations": srv.migrations,
               "migrated_bytes": srv.migrated_bytes,
               "peak_memory_gb": peak_gb, "launches": launches,
               "forwards": forwards, "events": ev, "summary": summ,
               "kv_bytes_per_token": kv_tok,
               "kv_bytes_per_token_bf16": kv_tok_bf16, **pct,
               "ttft_s": ttft_s, "e2e_s": e2e_s,
               "decisions": len(srv.plane.decisions)}
    for eng in srv.engines:
        if eng.id not in srv.crashed:
            eng.shutdown()
    del srv, params, made
    torch.cuda.empty_cache()
    return summary


# phase 9: default_plan(3, 512) splits the stages at 128 tokens (engines
# 0-1 | 2); (prompt, new, arrival, class, shared-prefix tokens)
SMALL_CHAOS_TRACE = (
    (150, 24, 0, "batch", 0), (160, 20, 0, "batch", 0),
    (100, 12, 0, "standard", 64), (40, 30, 0, "batch", 0),
    (50, 30, 1, "batch", 0), (110, 30, 1, "standard", 0),
    (30, 16, 6, "interactive", 0), (170, 12, 9, "interactive", 0),
    (90, 16, 12, "standard", 0), (95, 16, 13, "standard", 0),
    (80, 8, 26, "standard", 64), (20, 12, 28, "interactive", 0))
SMALL_CHAOS_FAULTS = dict(seed=0, crashes=((1, 8),), rejoins=((1, 24),),
                          transfer_loss_p=0.3)
SMALL_CHAOS_ENGINE = dict(max_slots=2, max_seq=512, token_budget=512,
                          prefill_token_budget=64, attn_backend="fused",
                          kv_dtype="int8", host_kv_budget=256,
                          preemption=True, slo_time_scale=8.0)


def phase_chaos_devices(np, torch, cfg, model_mod, engine_mod, request_mod,
                        server_mod, serve_mod, qoe_mod):
    """Phase 9: the phase-8 configuration at 2 layers, f32, 3 engines, on
    the card and on the CPU; then, on the card, the same trace with
    preemption and faults off."""
    model = model_mod.build_model(cfg)
    cpu_params = cpu_weights(model)
    gpu_params = _tree_to(cpu_params, torch.device("cuda"))
    quiet = dict(SMALL_CHAOS_ENGINE, preemption=False)
    runs = {}
    for name, params, faults, kw in (
            ("cuda", gpu_params, SMALL_CHAOS_FAULTS, SMALL_CHAOS_ENGINE),
            ("cpu", cpu_params, SMALL_CHAOS_FAULTS, SMALL_CHAOS_ENGINE),
            ("cuda_undisturbed", gpu_params, None, quiet)):
        made = []
        srv = chaos_server(np, model, params, server_mod, serve_mod,
                           qoe_mod, engine_mod, faults, 3, 512, kw, made)
        want = "cpu" if name == "cpu" else "cuda"
        check(all(e.device.type == want for e in srv.engines),
              f"engines not on {want}")
        reqs = [r for r, _ in _chaos_requests(
            np, request_mod, SMALL_CHAOS_TRACE, cfg.vocab_size, SEED + 6)]
        for r, (_, _, at, _, _) in zip(reqs, SMALL_CHAOS_TRACE):
            srv.submit_at(r, at)
        srv.run(max_steps=800)          # asserts the live engines drained
        check(len(srv.finished) == len(reqs), f"{name}: did not drain")
        summ = srv.summary()
        runs[name] = (list(srv.plane.decisions),
                      [list(r.generated) for r in reqs],
                      {k: v for k, v in summ.items()
                       if not k.startswith(("ttft", "e2e"))},
                      chaos_events(srv, made), reqs)
    cuda, cpu, quiet_run = runs["cuda"], runs["cpu"], runs["cuda_undisturbed"]
    check(cuda[0] == cpu[0], "decision logs differ: cuda "
          f"{cuda[0]} cpu {cpu[0]}")
    check(cuda[1] == cpu[1], f"token streams differ: cuda {cuda[1]} "
          f"cpu {cpu[1]}")
    check(cuda[2] == cpu[2], f"summaries differ: cuda {cuda[2]} "
          f"cpu {cpu[2]}")
    ev = cuda[3]
    for k, v in ev.items():
        check(v >= 1, f"phase 9: no {k} ({ev})")
    reqs = cuda[4]
    disturbed = [i for i, r in enumerate(reqs)
                 if r.preemptions or r.redispatches]
    check(any(reqs[i].redispatches for i in disturbed),
          "no redispatched request")
    same = [i for i in disturbed if cuda[1][i] == quiet_run[1][i]]
    check(same == disturbed, "streams of preempted/redispatched requests "
          f"{disturbed} differ from the undisturbed run at "
          f"{sorted(set(disturbed) - set(same))}")
    others = sum(a == b for a, b in zip(cuda[1], quiet_run[1]))
    log(f"phase 9: 2-layer full-width f32 {cfg.name}, 3 int8 engines with "
        f"preemption, host tier and faults, cuda == cpu: "
        f"{len(cuda[0])} decisions, streams and summary counters "
        f"identical; events {json.dumps(ev)}; the {len(disturbed)} "
        f"preempted or redispatched requests {disturbed} decode their "
        f"undisturbed streams ({others}/{len(reqs)} streams equal in all)")


# --------------------------------------------------------------------------
# Phase 13: the paper's Fig. 2 on the card, through kernels.api
# --------------------------------------------------------------------------
def phase_fig2(torch, api, dk, flush):
    """Padded vs ragged contiguous decode on the paper's mixed-length
    batches, each mode held to its plain version on the same caches, and
    the padded kernel on a homogeneous batch of the same size and total
    tokens (every length the mean, the cache that long): the heterogeneity
    tax (padded mixed / padded homogeneous) and the ragged speedup
    (padded / ragged). Then one causal prefill through
    ``api.prefill_attention`` held to the ``ref`` oracle on its rows below
    each length."""
    H, Hkv, Dh = FIG2_HEADS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    out = {}

    def decode(q, k, v, lengths, ragged):
        return api.decode_attention(q, k, v, lengths, backend="kernel",
                                    ragged=ragged, block_s=FIG2_BLOCK)

    for name, B, short, long_ in FIG2_SETUPS:
        lens = [short] * (B // 2) + [long_] * (B // 2)
        q = randn(torch, gen, (B, H, Dh), torch.bfloat16)
        k, v = (randn(torch, gen, (B, long_, Hkv, Dh), torch.bfloat16)
                for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        pad, rag = decode(q, k, v, lengths, False), decode(q, k, v, lengths,
                                                           True)
        torch.cuda.synchronize()
        err = {mode: hold(torch, f"fig 2 {name} {mode} bf16", got,
                          dk.decode_attention_plain(
                              q, k, v, lengths, block_s=FIG2_BLOCK,
                              ragged=mode == "ragged"), 5e-3)
               for mode, got in (("padded", pad), ("ragged", rag))}
        diff = (pad.float() - rag.float()).abs().max().item()
        check(diff == 0, f"fig 2 {name}: padded and ragged outputs differ "
              f"by {diff} (the padded mode's extra keys must weigh 0)")
        t_pad = time_ms(torch, lambda: decode(q, k, v, lengths, False), 10,
                        flush)
        t_rag = time_ms(torch, lambda: decode(q, k, v, lengths, True), 10,
                        flush)
        kv_gb = 2 * k.numel() * k.element_size() / 1e9
        del k, v, pad, rag
        torch.cuda.empty_cache()
        mean = sum(lens) // len(lens)
        k, v = (randn(torch, gen, (B, mean, Hkv, Dh), torch.bfloat16)
                for _ in range(2))
        homog = torch.full((B,), mean, dtype=torch.int32, device="cuda")
        t_hom = time_ms(torch, lambda: decode(q, k, v, homog, False), 10,
                        flush)
        del k, v
        torch.cuda.empty_cache()
        out[name] = {"batch": B, "lengths": [short, long_], "mean": mean,
                     "kv_gb": kv_gb, "padded_ms": t_pad, "ragged_ms": t_rag,
                     "homogeneous_padded_ms": t_hom, "tax": t_pad / t_hom,
                     "ragged_speedup": t_pad / t_rag,
                     "padded_vs_plain_max_abs": err["padded"],
                     "ragged_vs_plain_max_abs": err["ragged"],
                     "padded_eq_ragged_max_abs": diff}
        log(f"phase 13: fig 2 {name}, batch {B} ({B // 2} x {short} + "
            f"{B // 2} x {long_} tokens, K/V {kv_gb:.2f} GB bf16): padded "
            f"{t_pad:.4f} ms, ragged {t_rag:.4f} ms, homogeneous padded "
            f"(all {mean}) {t_hom:.4f} ms; tax {t_pad / t_hom:.4f}x, "
            f"ragged speedup {t_pad / t_rag:.4f}x; vs plain max abs padded "
            f"{err['padded']:.3e}, ragged {err['ragged']:.3e} (<= 5e-3); "
            f"padded vs ragged max abs {diff:.3e}")
    # causal prefill through the api at #6's shape, against the oracle
    T, plens = PREFILL_T, PREFILL_LENS
    q, k, v = (randn(torch, gen, (2, T, n, Dh), torch.bfloat16)
               for n in (H, Hkv, Hkv))
    lengths = torch.tensor(plens, dtype=torch.int32, device="cuda")
    got = api.prefill_attention(q, k, v, lengths, backend="kernel")
    want = api.prefill_attention(q, k, v, lengths, backend="ref")
    torch.cuda.synchronize()
    err = max((got[b, :n].float() - want[b, :n].float()).abs().max().item()
              for b, n in enumerate(plens))
    check(err <= 5e-3, f"prefill kernel vs the ref oracle: {err}")
    log(f"phase 13: api.prefill_attention(backend='kernel') at B 2, T {T} "
        f"vs backend='ref' on the rows below each length: max abs "
        f"{err:.3e} (<= 5e-3)")
    out["prefill_vs_ref_max_abs"] = err
    return out


# --------------------------------------------------------------------------
# Phase 14: the engine's other modes at full width
# --------------------------------------------------------------------------
# (a) whole-prompt prefill on the paged pool (fused decode), (b) the
# monolithic slab, (c) the host loop on fused, (d) the prefix cache off
ENGINE_MODES = (("whole-prompt", dict(chunked_prefill=False)),
                ("slab", dict(paged=False)),
                ("host-loop", dict(device_resident=False)),
                ("no-prefix-cache", dict(prefix_cache=False)))
MODES_MAX_SEQ = 8192      # phase 4's max_seq: the slab's rows, #6's bucket
MODE_COUNTERS = ("steps", "prefill_tokens_done", "prefill_work_blocks",
                 "peak_kv_bytes", "cached_prompt_tokens_total", "tokens_out")


def _mode_launches_ok(name, cfg, launches, prefills, forwards):
    """The kernels a mode's forwards launch, once a layer each, and no
    other: whole-prompt prefill launches #6; the slab decodes by #5
    padded; every paged forward on fused launches the fused kernel."""
    L = cfg.num_layers
    if name == "whole-prompt":
        want = {"contiguous_prefill": L * prefills,
                "fused": L * (forwards - prefills)}
    elif name == "slab":
        want = {"contiguous_prefill": L * prefills,
                "contiguous_decode_padded": L * (forwards - prefills)}
    else:
        want = {"fused": L * forwards}
    got = {k: v for k, v in launches.items() if v}
    check(got == want and all(want.values()),
          f"phase 14 {name}: launches {got} != {want}")


def _drive_modes_trace(np, torch, engine_mod, eng, reqs):
    """Serve ``reqs``, request i submitted before the engine's step i + 1,
    each step under sync-debug "error": one device-to-host transfer a
    step that brings tokens to the host (none otherwise), and the
    attention-bearing forwards the mode makes (one fused; else one per
    whole prompt or one for the step's chunks, plus one decode). Returns
    per-step wall ms, each request's token arrival (step, s) and its
    submission (step, s), and the forwards."""
    step_ms, seen, sub = [], {r.req_id: [] for r in reqs}, {}
    t0 = time.perf_counter()
    forwards = 0
    while not all(r.state.name == "FINISHED" for r in reqs):
        check(eng.steps < 2000, "engine did not drain")
        for r in reqs:
            if r.req_id == eng.steps and r.req_id not in sub:
                eng.submit(r)
                sub[r.req_id] = (eng.steps, time.perf_counter() - t0)
        d0, a0 = engine_mod.D2H_CALLS, engine_mod.ATTN_CALLS
        gen0 = [len(r.generated) for r in reqs]
        p0 = eng.prefill_tokens_done
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        now = time.perf_counter() - t0
        step_ms.append((time.perf_counter() - t) * 1e3)
        grown = [len(r.generated) - g for r, g in zip(reqs, gen0)]
        for r, n in zip(reqs, grown):
            seen[r.req_id] += [(eng.steps, now)] * n
        d = engine_mod.D2H_CALLS - d0
        check(d == int(sum(grown) > 0),
              f"step {eng.steps}: {d} d2h (tokens grew {sum(grown)})")
        firsts = sum(r.first_token_step == eng.steps and g == 0
                     for r, g in zip(reqs, gen0) if not r.rejected)
        decoded = sum(grown) - firsts > 0
        prompt = ((eng.prefill_tokens_done - p0 > 0)
                  if eng.chunked_prefill else firsts)
        want = (int(prompt or decoded) if eng.fused_mixed
                else int(prompt) + int(decoded))
        a = engine_mod.ATTN_CALLS - a0
        check(a == want, f"step {eng.steps}: {a} forwards, want {want}")
        forwards += a
    return step_ms, seen, sub, forwards


def phase_engine_modes(np, torch, cfg_mod, model_mod, engine_mod,
                       request_mod, tk, dk, pk, ref_streams):
    """Phase 4's requests (arriving one a step) on the four other engine
    modes at full width, bf16, preemption off, each engine freed before
    the next: every request finishes, the launch, transfer and forward
    checks hold, and each stream that parts from phase 4's passes the
    margin check (both engines, fed the context up to the parting token,
    hold both tokens within ``MARGIN_ULPS`` bf16 ulps of their best
    logit). Logs steps, wall, TTFT, TPOT, the largest gap between two
    tokens of a request and ``peak_kv_bytes``."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params = model.init(SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    out = {}
    for name, kw in ENGINE_MODES:
        eng = engine_mod.Engine(0, model, params, max_slots=8,
                                max_seq=MODES_MAX_SEQ, preemption=False,
                                **kw)
        reqs = [request_mod.ServeRequest(i, p.copy(), m)
                for i, (p, m) in enumerate(zip(prompts, NEW_TOKENS))]
        zero_counts(tk, dk, pk)
        step_ms, seen, sub, forwards = _drive_modes_trace(
            np, torch, engine_mod, eng, reqs)
        launches = launch_counts(tk, dk, pk)
        _mode_launches_ok(name, cfg, launches, len(reqs), forwards)
        for r in reqs:
            check(len(r.generated) == r.max_new_tokens and not r.rejected,
                  f"phase 14 {name} request {r.req_id}: "
                  f"{len(r.generated)} tokens")
        eng.check_drained()
        ttft_steps = [seen[r.req_id][0][0] - sub[r.req_id][0]
                      for r in reqs]
        ttft_s = [seen[r.req_id][0][1] - sub[r.req_id][1] for r in reqs]
        tpot_s = [(seen[r.req_id][-1][1] - seen[r.req_id][0][1])
                  / (len(r.generated) - 1) for r in reqs]
        gaps = [(b[1] - a[1], b[0] - a[0], r.req_id, b[0])
                for r in reqs for a, b in zip(seen[r.req_id],
                                              seen[r.req_id][1:])]
        gap_s, gap_steps, gap_req, gap_step = max(gaps)
        wall = sum(step_ms) / 1e3
        res = {"steps": eng.steps, "wall_s": wall, "step_ms": step_ms,
               "ttft_steps": ttft_steps, "ttft_s": ttft_s, "tpot_s": tpot_s,
               "tpot_steps": [(r.finish_step - r.first_token_step)
                              / (len(r.generated) - 1) for r in reqs],
               "max_token_gap_s": gap_s, "max_token_gap_steps": gap_steps,
               "max_token_gap_request": gap_req,
               "max_token_gap_at_step": gap_step,
               "peak_kv_bytes": eng.peak_kv_bytes, "forwards": forwards,
               "launches": {k: v for k, v in launches.items() if v},
               "streams": [list(r.generated) for r in reqs]}
        log(f"phase 14: {name} ({kw}): {eng.steps} steps, {wall:.3f} s of "
            f"steps, {forwards} attention-bearing forwards, launches "
            f"{json.dumps(res['launches'])}; peak_kv_bytes "
            f"{eng.peak_kv_bytes / 1e9:.4f} GB")
        log(f"phase 14: {name}: TTFT steps {ttft_steps}; TTFT s "
            f"{[round(x, 4) for x in ttft_s]}; TPOT s "
            f"{[round(x, 5) for x in tpot_s]}; step ms mean "
            f"{sum(step_ms) / len(step_ms):.2f} max {max(step_ms):.2f}; "
            f"largest gap between two tokens of a request {gap_s:.4f} s "
            f"({gap_steps} step(s); request {gap_req}, at step {gap_step})")
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
        out[name] = res
    # #6 at the long prompt's bucket (B 1, T 8192); #5 on the slab's step
    # with all 8 rows live, query row b reading slab row 7 - b, each at its
    # prompt + half its new tokens
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    out["kernels"] = contiguous_kernels_at(
        torch, cfg, dk, pk, flush, 1, MODES_MAX_SEQ,
        [len(p) + m // 2 for p, m in zip(prompts, NEW_TOKENS)],
        list(range(len(prompts) - 1, -1, -1)), MODES_MAX_SEQ, "phase 14")
    del flush
    paged_peak = out["whole-prompt"]["peak_kv_bytes"]
    slab_peak = out["slab"]["peak_kv_bytes"]
    log(f"phase 14: peak_kv_bytes paged (whole-prompt) {paged_peak:.0f} vs "
        f"slab {slab_peak:.0f}: paged pins {paged_peak / slab_peak:.4f}x")
    # the streams against phase 4's, under the margin check
    margins, probes = {}, {}
    for name, kw in ENGINE_MODES:
        rows = []
        for i, (a, b) in enumerate(zip(out[name]["streams"], ref_streams)):
            if a == b:
                continue
            j = next(x for x in range(min(len(a), len(b))) if a[x] != b[x])
            ctx = list(prompts[i]) + a[:j]
            row = {"request": i, "token": j, "mode": a[j], "phase4": b[j]}
            for who, probe_kw in ((name, kw), ("phase4", {})):
                key = (who, tuple(ctx))
                if key not in probes:
                    probes[key] = _first_token_logits(
                        np, torch, dataclasses, model, params, engine_mod,
                        request_mod, ctx, **probe_kw)
                lg = probes[key]
                top = float(lg.max())
                behind = max(top - float(lg[a[j]]), top - float(lg[b[j]]))
                tol = MARGIN_ULPS * bf16_ulp(top)
                check(behind <= tol, f"phase 14 {name}: request {i} token "
                      f"{j}: the {who} probe puts a stream's token {behind} "
                      f"behind its best {top} (> {MARGIN_ULPS} bf16 ulps)")
                row[f"{who}_behind_best"] = behind
                row[f"{who}_tolerance"] = tol
            rows.append(row)
        margins[name] = rows
        same = len(ref_streams) - len(rows)
        log(f"phase 14: {name} vs phase 4 greedy streams: {same}/"
            f"{len(ref_streams)} identical" + (
                f"; where they part, both probes hold both tokens within "
                f"{MARGIN_ULPS} bf16 ulps: {json.dumps(rows)}"
                if rows else ""))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["margins"] = margins
    out["paged_over_slab_peak_kv"] = paged_peak / slab_peak
    return out


def _prefill_at(torch, pk, gen, B, T, H, Hkv, Dh, G, label, timed, times,
                dev):
    """#6 of ``contiguous_kernels_at``: [B, T, H, Dh] bf16, every row T
    long, held to its plain version and timed beside SDPA."""
    import torch.nn.functional as F
    q, k, v = (randn(torch, gen, (B, T, n, Dh), torch.bfloat16)
               for n in (H, Hkv, Hkv))
    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    err = hold(torch, f"{label} #6", pk.prefill_attention(q, k, v),
               pk.prefill_attention_plain(q, k, v, full), 5e-3)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    row = times(lambda: pk.prefill_attention(q, k, v),
                lambda: pk.prefill_attention_plain(q, k, v, full),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True), 10)
    flops = 4.0 * B * (T * (T + 1) // 2) * H * Dh
    bound_ms, by = bound_of(B * T * (H + 2 * Hkv + H) * Dh * 2, flops)
    out = {"B": B, "T": T, "max_abs_err": err, **row,
           "bound_ms": bound_ms, "bound_by": by,
           "tflops": flops / row["ms"] / 1e9}
    log(f"{label}: #6 at B {B}, T {T}, H {H} / Hkv {Hkv} (G {G}), bf16: "
        f"{row['ms']:.4f} ms{dev(row)} "
        f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain "
        f"{row['plain_ms']:.4f} ms, library sdpa {row['library_ms']:.4f} "
        f"ms{dev(row, 'library_device_ms')}, bound {bound_ms:.4f} ms ({by});"
        f" vs plain max abs {err:.3e}")
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return out


def contiguous_kernels_at(torch, cfg, dk, pk, flush, B, T, lens, rows, S,
                          label, device=False, prefill=True, decode=True):
    """#6 and #5 (padded) at the shapes an engine or a model-level call
    gives them, bf16, ``cfg``'s heads, L2 flushed: #6 on [B, T, H, Dh]
    (every row T long); #5 on ``len(lens)`` query rows over a slab of as
    many rows of ``S`` keys, query row b reading slab row
    ``rows[b]`` through ``kv_rows`` at ``lens[b]`` keys. Each held to its
    plain version (5e-3) and timed beside it, one SDPA call (causal with
    ``enable_gqa``; a bool length mask on the slab's rows, in slab order)
    and its bound, by CUDA events, and with ``device`` also by the
    profiler's device time (phase 14 times by events only: this late in
    the process the profiler was seen to lose kernel records, and #5 then
    read below the time streaming its rows takes). #5 may not be timed
    below streaming its whole slab. ``prefill=False`` leaves #6 out,
    ``decode=False`` #5."""
    import torch.nn.functional as F
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)

    def timed(fn, iters):
        t = time_ms(torch, fn, iters, flush, device=device)
        return ({"ms": float(t), "device_ms": t.device} if device
                else {"ms": t})

    def times(kernel, plain, library, iters):
        row = timed(kernel, iters)
        lib = timed(library, iters)
        row.update(plain_ms=time_ms(torch, plain, 2, flush),
                   library_ms=lib["ms"])
        if device:
            row["library_device_ms"] = lib["device_ms"]
        return row

    def dev(row, key="device_ms"):
        return f" (device {row[key]:.4f})" if device else ""
    out = {}
    if prefill:
        out["prefill"] = _prefill_at(torch, pk, gen, B, T, H, Hkv, Dh, G,
                                     label, timed, times, dev)
    if not decode:
        return out
    R = len(lens)
    q = randn(torch, gen, (R, H, Dh), torch.bfloat16)
    k, v = (randn(torch, gen, (R, S, Hkv, Dh), torch.bfloat16)
            for _ in range(2))
    rows_t = torch.tensor(rows, dtype=torch.int32, device="cuda")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    err = hold(torch, f"{label} #5", dk.decode_attention(
        q, k, v, lengths, kv_rows=rows_t), dk.decode_attention_plain(
        q, k, v, lengths, kv_rows=rows_t), 5e-3)
    # library: the query rows put in slab order, G query heads per kv head
    # as rows
    order = rows_t.long().argsort()
    mask = (torch.arange(S, device="cuda")[None]
            < lengths[order][:, None])[:, None, None]
    qr = q[order].reshape(R, Hkv, G, Dh)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    row = times(lambda: dk.decode_attention(q, k, v, lengths,
                                            kv_rows=rows_t),
                lambda: dk.decode_attention_plain(q, k, v, lengths,
                                                  kv_rows=rows_t),
                lambda: F.scaled_dot_product_attention(
                    qr, kt, vt, attn_mask=mask), 10)
    nb, fo = contiguous_work(lens, H, Hkv, Dh, R)
    bound_ms, by = bound_of(nb, fo)
    stream_ms = 2 * k.numel() * k.element_size() / HBM_BYTES_PER_S * 1e3
    check(row["ms"] >= stream_ms, f"{label}: padded decode on the slab "
          f"timed at {row['ms']:.4f} ms, below the {stream_ms:.4f} ms that "
          f"streaming its rows takes: it skipped blocks")
    out["decode_padded"] = {"rows": R, "S": S, "lengths": list(lens),
                            "max_abs_err": err, **row, "bound_ms": bound_ms,
                            "bound_by": by, "stream_bound_ms": stream_ms}
    log(f"{label}: #5 padded on the slab ({R} rows via kv_rows, S {S}, "
        f"lengths {list(lens)}, H {H} / Hkv {Hkv} (G {G}), bf16): "
        f"{row['ms']:.4f} ms{dev(row)} ("
        f"{2 * k.numel() * k.element_size() / row['ms'] / 1e9:.3f} TB/s of "
        f"the rows it streams), plain {row['plain_ms']:.4f} ms, library "
        f"sdpa {row['library_ms']:.4f} ms{dev(row, 'library_device_ms')}, "
        f"bound {bound_ms:.4f} ms ({by}), streaming bound {stream_ms:.4f} "
        f"ms; vs plain max abs {err:.3e}; x {cfg.num_layers} layers = "
        f"{cfg.num_layers * row['ms']:.3f} ms a decode step")
    del q, k, v, kt, vt, qr, mask
    torch.cuda.empty_cache()
    return out


def phase_engine_modes_devices(np, torch, cfg_mod, model_mod, engine_mod,
                               request_mod):
    """The four modes at 2 layers of full-width llama3.2-3b, f32, on the
    card and on the CPU, same weights: equal greedy streams and
    counters."""
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = cpu_weights(model)
    gpu_params = _tree_to(cpu_params, torch.device("cuda"))
    for name, kw in ENGINE_MODES:
        runs = {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = engine_mod.Engine(0, model, params, max_slots=3,
                                    max_seq=512, prefill_token_budget=64,
                                    preemption=False, **kw)
            check(eng.device.type == dev, f"engine on {eng.device}")
            rng = np.random.default_rng(SEED + 1)
            reqs = [request_mod.ServeRequest(
                i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                for i, n in enumerate((40, 130, 17, 300))]
            for r in reqs:
                eng.submit(r)
            while not all(r.state.name == "FINISHED" for r in reqs):
                check(eng.steps < 200, "engine did not drain")
                eng.step()
            eng.check_drained()
            runs[dev] = ([list(r.generated) for r in reqs],
                         {c: getattr(eng, c) for c in MODE_COUNTERS})
        check(runs["cuda"] == runs["cpu"],
              f"phase 14 {name}: cuda {runs['cuda']} != cpu {runs['cpu']}")
        log(f"phase 14: {name}, 2-layer full-width f32 llama3.2-3b: cuda == "
            f"cpu greedy streams {runs['cuda'][0]} and counters "
            f"{runs['cuda'][1]}")


# --------------------------------------------------------------------------
# Phases 16 and 17: the MoE and VLM decoder families at full width
# --------------------------------------------------------------------------
MOE_ARCH, VLM_ARCH = "qwen3-moe-30b-a3b", "qwen2-vl-7b"
# phases 18-19: starcoder2-3b at the window its published config sets (the
# repo's config leaves it unset), and rwkv6-7b, on phase 4's arrivals
WINDOW_ARCH, RWKV_ARCH = "starcoder2-3b", "rwkv6-7b"
WINDOW = 4096
# 4100 and 5897 exceed the window (the banded path), the rest run #6;
# 4080 + 32 new tokens wraps the ring while decoding
WINDOW_PROMPTS = (16, 300, 1000, 2048, 3000, 4080, 4100, 5897)
WINDOW_NEW = (32, 16, 24, 32, 16, 32, 24, 16)
# (c): 2 layers f32 at W 64: 130 runs the banded path, 60 + 8 wraps
WINDOW_SMALL, WINDOW_SMALL_W = (40, 130, 17, 60), 64
# a request's rwkv6-7b state: S [32, 64, 64, 64] f32 + two [32, 4096] bf16
RWKV_PIECE_BYTES = 32 * (64 * 64 * 64 * 4 + 2 * 4096 * 2)
VLM_SLAB = (2, 1024)        # phase 17 (c): B prompts of T tokens
# phase 17 (c)'s bound on the relative L2 gap between the bf16 slab
# decode's logits and the whole forward's at full depth: on the H100 the
# sound rows read 0.0216 / 0.0225, the decode at the text M-RoPE ids
# 0.953 / 0.968 and the swapped rows 1.418 / 1.441 (PERF.md §6)
VLM_SLAB_GAP = 0.15
SMALL_REQS = (40, 130, 17)  # phase 5's prompts (6 new tokens each)


def decoder_params(cfg):
    """Parameters of a decoder config: embeddings (and an untied
    unembedding), then per layer attention (with QKV biases), two norms
    and the FFN, or the f32 router, E experts and arctic's dense residual
    FFN and its norm."""
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    attn = D * (H + 2 * Hkv) * Dh + H * Dh * D
    attn += (H + 2 * Hkv) * Dh if cfg.qkv_bias else 0
    ffn = 3 * D * cfg.d_ff
    if cfg.num_experts:
        mlp = D * cfg.num_experts + cfg.num_experts * ffn
        mlp += ffn + D if cfg.dense_residual else 0
    else:
        mlp = ffn
    embed = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    return embed + D + cfg.num_layers * (attn + 2 * D + mlp)


def _fresh_card(torch, label):
    """Free what earlier phases left and check that under 1 GB is still
    allocated, so a full-width weight set starts alone on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 1e9, f"{label}: {held / 1e9:.2f} GB still allocated "
          "before the weights are drawn")
    log(f"{label}: {held / 1e9:.3f} GB allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    return held


def _draw_weights(torch, model, label):
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for v in _leaves(params))
    log(f"{label}: {model.cfg.name} weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s: {nbytes / 1e9:.2f} GB "
        f"({sum(v.numel() for v in _leaves(params)) / 1e9:.3f} B "
        f"parameters), peak memory while drawing "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params, nbytes


def _forward_kinds(engine_mod, model):
    """Count the engine's attention-bearing forwards by kind (the chunk
    forward or a whole prompt's, anything else) while installed; returns
    (kinds, restore)."""
    kinds = {"prefill": 0, "decode": 0}
    real = engine_mod.attn_call

    def attn_call(fn, *a, **k):
        prompt = fn.__name__ == "_chunk_forward" or fn is model.prefill
        kinds["prefill" if prompt else "decode"] += 1
        return real(fn, *a, **k)
    engine_mod.attn_call = attn_call

    def restore():
        engine_mod.attn_call = real
    return kinds, restore


def _serve_trace(np, torch, engine_mod, request_mod, tk, dk, pk, eng, model,
                 prompts, label, new_tokens=NEW_TOKENS):
    """Phase 4's requests (``prompts`` with ``new_tokens``), arriving one
    a step, on ``eng`` under sync-debug "error" (``_drive_modes_trace``'s
    checks: one d2h a step that brings tokens, the backend's forwards a
    step); every request finishes with its count. Returns the summary
    (TTFT/TPOT in steps and s, step ms, tokens/s, peak memory, forwards
    by kind, launches)."""
    reqs = [request_mod.ServeRequest(i, p.copy(), m)
            for i, (p, m) in enumerate(zip(prompts, new_tokens))]
    zero_counts(tk, dk, pk)
    kinds, restore = _forward_kinds(engine_mod, model)
    try:
        step_ms, seen, sub, forwards = _drive_modes_trace(
            np, torch, engine_mod, eng, reqs)
    finally:
        restore()
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    for r in reqs:
        check(len(r.generated) == r.max_new_tokens and not r.rejected,
              f"{label}: request {r.req_id}: {len(r.generated)} tokens")
        check(all(0 <= t < model.cfg.vocab_size for t in r.generated),
              f"{label}: request {r.req_id}: token out of range")
    eng.check_drained()
    ttft_steps = [seen[r.req_id][0][0] - sub[r.req_id][0] for r in reqs]
    ttft_s = [seen[r.req_id][0][1] - sub[r.req_id][1] for r in reqs]
    tpot_s = [(seen[r.req_id][-1][1] - seen[r.req_id][0][1])
              / (len(r.generated) - 1) for r in reqs]
    tpot_steps = [(r.finish_step - r.first_token_step)
                  / (len(r.generated) - 1) for r in reqs]
    wall = sum(step_ms) / 1e3
    ntok = sum(len(r.generated) for r in reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: {len(reqs)} requests drained in {eng.steps} steps, "
        f"{wall:.3f} s of steps; {ntok} tokens, {ntok / wall:.1f} tokens/s; "
        f"{forwards} forwards" + ("" if eng.fused_mixed else
                                  f" {json.dumps(kinds)}") +
        f"; launches {json.dumps(launches)}; peak memory {peak_gb:.2f} GB")
    log(f"{label}: step ms mean {sum(step_ms) / len(step_ms):.2f} min "
        f"{min(step_ms):.2f} max {max(step_ms):.2f}; TTFT steps "
        f"{ttft_steps}; TTFT s {[round(x, 4) for x in ttft_s]}; TPOT steps "
        f"{[round(x, 3) for x in tpot_steps]}; TPOT s "
        f"{[round(x, 5) for x in tpot_s]}")
    return {"steps": eng.steps, "wall_s": wall, "tokens": ntok,
            "tokens_per_s": ntok / wall, "step_ms": step_ms,
            "ttft_steps": ttft_steps, "ttft_s": ttft_s,
            "tpot_steps": tpot_steps, "tpot_s": tpot_s,
            "forwards": dict(kinds), "forwards_total": forwards,
            "launches": launches, "peak_memory_gb": peak_gb,
            "streams": [list(r.generated) for r in reqs]}


def _small_requests(np, request_mod, vocab, lens=SMALL_REQS, new=6):
    rng = np.random.default_rng(SEED + 1)
    return [request_mod.ServeRequest(
        i, rng.integers(0, vocab, n).astype(np.int32), new)
        for i, n in enumerate(lens)]


def _engine_devices(np, torch, model, gpu_params, cpu_params, engine_mod,
                    request_mod, label, lens=SMALL_REQS, new=6, **engine_kw):
    """Phase 5's requests (or ``lens`` prompts of ``new`` tokens) on an
    engine on the card and on one on the CPU (``engine_kw``: the backend),
    same weights: equal greedy streams."""
    streams = {}
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = engine_mod.Engine(0, model, params, max_slots=3, max_seq=512,
                                prefill_token_budget=64, preemption=False,
                                **engine_kw)
        check(eng.device.type == dev, f"{label}: engine on {eng.device}")
        reqs = _small_requests(np, request_mod, model.cfg.vocab_size, lens,
                               new)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        while not all(r.state.name == "FINISHED" for r in reqs):
            check(eng.steps < 200, f"{label}: engine did not drain")
            eng.step()
        eng.check_drained()
        streams[dev] = [list(r.generated) for r in reqs]
        log(f"{label}: {dev} engine ({engine_kw}) drained in {eng.steps} "
            f"steps, {time.perf_counter() - t0:.1f} s")
    check(streams["cuda"] == streams["cpu"],
          f"{label}: greedy streams differ: cuda {streams['cuda']} "
          f"cpu {streams['cpu']}")
    return streams["cuda"]


def _two_engine_cluster(np, torch, model, params, engine_mod, request_mod,
                        server_mod, serve_mod, qoe_mod, tk, dk, pk, label,
                        trace=CLUSTER_TRACE, slab=False):
    """A 2-engine ``MILSServer`` (stages [0, 2048) and [2048, inf)),
    engines of ``max_slots 8, max_seq 8192``, preemption off, phase 6's
    requests (``trace``), under sync-debug "error": every request drains,
    at least one migration, each engine step makes at most one d2h. Fused
    engines (``token_budget 16384``): at most one forward a step, #1
    launches == layers x forwards and no other kernel runs. ``slab``
    engines (the host loop; a step prefills each prompt it admits, then
    decodes): no kernel of the port runs, and each migration's piece
    bytes are recorded (``piece_bytes``)."""
    cfg = model.cfg
    engine_kw = dict(max_slots=8, max_seq=8192, preemption=False)
    if not slab:
        engine_kw["token_budget"] = 16384
    srv = server_mod.MILSServer(
        model, params, serve_mod.default_plan(2, 8192),
        qoe_mod.QoEModel(np.array(serve_mod.DEFAULT_QOE)),
        server_mod.ServerConfig(policy="cascade", refinement="adaptive",
                                balancing="full", seed=SEED,
                                preemption=False),
        engine_factory=lambda i: engine_mod.Engine(i, model, params,
                                                   **engine_kw))
    reqs = _submit_trace(np, request_mod, srv, trace, cfg.vocab_size,
                         SEED + 2)
    worst = {"d2h": 0, "attn": 0}
    piece_bytes = []
    for eng in srv.engines:
        check(eng.paged != slab, f"{label}: engine paged={eng.paged}")

        def counted(burst=1, _step=eng.step):
            d0, a0 = engine_mod.D2H_CALLS, engine_mod.ATTN_CALLS
            out = _step(burst)
            worst["d2h"] = max(worst["d2h"], engine_mod.D2H_CALLS - d0)
            worst["attn"] = max(worst["attn"], engine_mod.ATTN_CALLS - a0)
            return out

        def exported(slot, _export=eng.export_slot):
            out = _export(slot)
            piece_bytes.append(out[2])
            return out
        eng.step = counted
        eng.export_slot = exported
    zero_counts(tk, dk, pk)
    a0 = engine_mod.ATTN_CALLS
    t_end = {0: 0.0}
    step_ms = []
    t_start = time.perf_counter()
    while len(srv.finished) < srv.submitted:
        check(srv.steps < 1000, f"{label}: cluster did not drain")
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            srv.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        t_end[srv.steps] = time.perf_counter() - t_start
    wall = time.perf_counter() - t_start
    forwards = engine_mod.ATTN_CALLS - a0
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    for eng in srv.engines:
        eng.check_drained(strict=True)
    check(worst["d2h"] <= 1, f"{label}: an engine step made "
          f"{worst['d2h']} d2h")
    if slab:
        check(not launches, f"{label}: slab engines launched {launches}")
    else:
        check(worst["attn"] <= 1, f"{label}: an engine step made "
              f"{worst['attn']} forwards")
        check(launches == {"fused": cfg.num_layers * forwards} and forwards,
              f"{label}: launches {launches} != {cfg.num_layers} x "
              f"{forwards} fused forwards")
    check(srv.migrations >= 1, f"{label}: no migration")
    for r in reqs:
        check(len(r.generated) == r.max_new_tokens and not r.rejected,
              f"{label}: request {r.req_id}: {len(r.generated)} tokens")
    summ = srv.summary()
    ttft_s = [t_end[r.first_token_step] - t_end[r.arrival_step]
              for r in reqs]
    e2e_s = [t_end[r.finish_step] - t_end[r.arrival_step] for r in reqs]
    pct = {f"{name}_p{p}": float(np.percentile(v, p))
           for name, v in (("ttft_s", ttft_s), ("e2e_s", e2e_s))
           for p in (50, 95, 99)}
    ntok = summ["tokens_out"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: 2 {'slab' if slab else 'fused'} engines, {len(reqs)} "
        f"requests drained in "
        f"{srv.steps} steps, {wall:.3f} s; {ntok} tokens, "
        f"{ntok / wall:.1f} tokens/s; {srv.migrations} migrations "
        f"({srv.migrated_bytes / 1e6:.1f} MB moved); launches "
        f"{json.dumps(launches)}, {forwards} forwards of {cfg.num_layers} "
        f"layers; "
        f"peak memory {peak_gb:.2f} GB; stage bounds {srv.stage_bounds}")
    log(f"{label}: server step ms mean {sum(step_ms) / len(step_ms):.2f} "
        f"max {max(step_ms):.2f}; seconds " + json.dumps(pct))
    out = {"steps": srv.steps, "wall_s": wall, "tokens": ntok,
           "tokens_per_s": ntok / wall, "step_ms": step_ms,
           "migrations": srv.migrations,
           "migrated_bytes": srv.migrated_bytes, "forwards": forwards,
           "most_forwards_an_engine_step": worst["attn"],
           "piece_bytes": piece_bytes,
           "launches": launches, "peak_memory_gb": peak_gb, **pct,
           "ttft_s": ttft_s, "e2e_s": e2e_s}
    for eng in srv.engines:
        eng.shutdown()
    del srv
    gc.collect()        # the counting wrappers hold their engines
    torch.cuda.empty_cache()
    return out


def phase_moe(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
              server_mod, serve_mod, qoe_mod, tk, dk, pk):
    """Phase 16: qwen3-moe-30b-a3b at full width, bf16, alone on the card:
    (a) one fused engine serving phase 4's requests; (b) a 2-engine
    cluster on phase 6's first 8; (c) 2 layers f32 on the card and the
    CPU (engine streams, ``moe_dense``); (d) arctic-480b reduced, the
    same. Where its step's time goes is ``tools/profile_torch_engine.py
    --arch qwen3-moe-30b-a3b``, run on its own."""
    from repro_torch.models import mlp as mlp_mod
    base = cfg_mod.get_config(MOE_ARCH)
    held = _fresh_card(torch, "phase 16")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 16")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]

    # (a) one engine
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                            token_budget=32768, preemption=False)
    check(eng.fused_mixed, "phase 16: the engine is not on fused")
    engine = _serve_trace(np, torch, engine_mod, request_mod, tk, dk, pk,
                          eng, model, prompts, "phase 16 (a)")
    check(engine["launches"] == {"fused": cfg.num_layers
                                 * engine["forwards_total"]},
          f"phase 16 (a): launches {engine['launches']} != "
          f"{cfg.num_layers} x {engine['forwards_total']} fused forwards")
    eng.shutdown()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the 2-engine cluster on phase 6's first 8 requests, on the same
    # weights
    cluster = _two_engine_cluster(np, torch, model, params, engine_mod,
                                  request_mod, server_mod, serve_mod,
                                  qoe_mod, tk, dk, pk, "phase 16 (b)",
                                  trace=CLUSTER_TRACE[:8])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) 2 layers, full width, f32: the card against the CPU
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(base, num_layers=2, dtype=torch.float32)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    cpu2 = _tree_to(gpu2, torch.device("cpu"))
    streams = _engine_devices(np, torch, model2, gpu2, cpu2, engine_mod,
                              request_mod, "phase 16 (c)")
    x = torch.from_numpy(np.random.default_rng(SEED + 16).normal(
        0, 1, (2, 7, cfg2.d_model)).astype(np.float32))
    layer = {k: v[0] for k, v in cpu2["layers"]["moe"].items()}
    y_cpu, aux_cpu = mlp_mod.moe_dense(layer, cfg2, x)
    y_gpu, aux_gpu = mlp_mod.moe_dense(
        _tree_to(layer, torch.device("cuda")), cfg2, x.cuda())
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux_gpu.cpu(), aux_cpu, atol=1e-4, rtol=1e-4)
    moe_err = (y_gpu.cpu() - y_cpu).abs().max().item()
    log(f"phase 16 (c): 2-layer full-width f32 {MOE_ARCH}, cuda == cpu "
        f"greedy streams {streams}; moe_dense cuda vs cpu max abs "
        f"{moe_err:.3e} (1e-4) on |y| <= {y_cpu.abs().max().item():.2f}; "
        f"{time.perf_counter() - t0:.1f} s")
    del gpu2, cpu2, layer
    gc.collect()
    torch.cuda.empty_cache()

    # (d) arctic-480b reduced (its dense residual), the card against the CPU
    acfg = cfg_mod.get_config("arctic-480b").reduced()
    amodel = model_mod.build_model(acfg)
    acpu = amodel.init(SEED, device="cpu")
    arctic = _engine_devices(np, torch, amodel,
                             _tree_to(acpu, torch.device("cuda")), acpu,
                             engine_mod, request_mod, "phase 16 (d)")
    full = decoder_params(cfg_mod.get_config("arctic-480b"))
    log(f"phase 16 (d): arctic-480b reduced (dense residual), cuda == cpu "
        f"greedy streams {arctic}; at full width it holds {full / 1e9:.1f} B "
        f"parameters, {full * 2 / 1e12:.3f} TB in bf16: no single card "
        "holds it")
    return {"held_before_gb": held / 1e9,
            "weights_gb": nbytes / 1e9, "peak_memory_gb": peak_gb,
            "engine": engine, "cluster": cluster,
            "cuda_cpu_streams": streams, "moe_dense_err": moe_err,
            "arctic_streams": arctic}


def family_kernels(np, torch, F, cfg_mod, tk, dk, pk, flush):
    """Phase 3 at the head groupings of phases 16 and 17 (early in the
    process, where the profiler keeps every record): #1 at qwen3-moe-30b-
    a3b's heads (32 / 4 / 64, G 8) on phase 3's segments; #2 and #3 at
    qwen2-vl-7b's (28 / 4 / 128, G 7) on phase 3's rows; #6 and #5 at the
    shapes of phase 17 (c)'s model-level call (B 2 prompts of T 1024; 2
    rows of a 1025-row slab through the identity row map); and, for phase
    18 (d), #6 and #5 at starcoder2-3b's heads (24 / 2 / 128, G 12, the
    largest grouping of any config; #5's 16-row tile instance) on phase
    18 (a)'s shapes. #1 is also held at Dh 128, the published
    Qwen3-30B-A3B's head width (the repo's config leaves head_dim unset,
    so the engine runs Dh 64), and at a tp=2 rank's llama3.2-3b heads
    (12 / 4, phase 23); #6 at those heads on phase 24 (a)'s training
    batch (B 2, T 1024); #6 and #5 at phase 25's shapes
    (:func:`dryrun_kernels`); #6 on phase 26's (row, head) pairs; #6 and
    #5 at a model-parallel rank's qwen3-moe heads (16 / 2 / 64) on phase
    27 (a)'s prefill and decode, and at its whisper heads (10 / 10 / 64)
    on phase 28 (a)'s; #6 and #5 at a data rank's qwen3-moe heads (32 /
    4 / 64) on phase 29 (b)'s train step and decode."""
    moe = cfg_mod.get_config(MOE_ARCH)
    vlm = cfg_mod.get_config(VLM_ARCH)
    out = {"moe": phase_kernels(np, torch, F, tk, flush, H=moe.num_heads,
                                Hkv=moe.num_kv_heads, Dh=moe.head_dim,
                                label=f"phase 3 ({MOE_ARCH}, G 8)")}
    out["moe_dh128"] = phase_kernels(
        np, torch, F, tk, flush, H=moe.num_heads, Hkv=moe.num_kv_heads,
        Dh=128, label=f"phase 3 ({MOE_ARCH}, G 8, published Dh 128)")
    out["flat"] = phase_flat_kernels(np, torch, F, dk, pk, flush,
                                     H=vlm.num_heads, Hkv=vlm.num_kv_heads,
                                     Dh=vlm.head_dim,
                                     label=f"phase 3 ({VLM_ARCH}, G 7)")
    B, T = VLM_SLAB
    out["slab"] = contiguous_kernels_at(
        torch, vlm, dk, pk, flush, B, T, [T + 1] * B, list(range(B)), T + 1,
        f"phase 3 ({VLM_ARCH}, G 7)", device=True)
    # phase 18 (d): #6 on the longest prompt within the window, #5 on the
    # 8 rows of the 4096-slot ring at (a)'s mid-decode lengths (query row
    # b reading ring row 7 - b)
    win = cfg_mod.get_config(WINDOW_ARCH)
    lens = [min(n + m // 2, WINDOW)
            for n, m in zip(WINDOW_PROMPTS, WINDOW_NEW)]
    out["window"] = contiguous_kernels_at(
        torch, win, dk, pk, flush, 1,
        max(n for n in WINDOW_PROMPTS if n <= WINDOW), lens,
        list(range(len(lens) - 1, -1, -1)), WINDOW,
        f"phase 18 (d) ({WINDOW_ARCH}, G 12)", device=True)
    # phase 21: #6 and #5 at whisper-large-v3's heads (20 / 20 / 64, G 1):
    # the decoder prompt at the position table's 448 rows, #5 on the
    # self-KV slab (448 rows, at the last decode step's keys) and on the
    # cross-KV (1500 rows, every key)
    wh = cfg_mod.get_config(WHISPER_ARCH)
    out["whisper"] = contiguous_kernels_at(
        torch, wh, dk, pk, flush, WHISPER_B, wh.max_position,
        [WHISPER_PROMPT + WHISPER_NEW] * WHISPER_B, list(range(WHISPER_B)),
        wh.max_position, f"phase 21 ({WHISPER_ARCH}, G 1, self-KV)",
        device=True)
    out["whisper_cross"] = contiguous_kernels_at(
        torch, wh, dk, pk, flush, WHISPER_B, 0,
        [wh.encoder_seq] * WHISPER_B, list(range(WHISPER_B)),
        wh.encoder_seq, f"phase 21 ({WHISPER_ARCH}, G 1, cross-KV)",
        device=True, prefill=False)
    # phase 23: #1 at a tp=2 rank's heads of llama3.2-3b (12 / 4 / 128,
    # G 3 as the whole model's 24 / 8)
    out["tp_rank"] = phase_kernels(np, torch, F, tk, flush, H=12, Hkv=4,
                                   Dh=128, label="phase 3 (llama3.2-3b, a "
                                   "tp=2 rank, 12 / 4 heads)")
    # phase 24 (a): #6 at a model-parallel rank's heads of llama3.2-3b
    # (12 / 4 / 128) on the training batch, B 2 x T 1024
    llama = cfg_mod.get_config("llama3.2-3b")
    out["train_tp_rank"] = contiguous_kernels_at(
        torch, dataclasses.replace(llama, num_heads=12, num_kv_heads=4),
        dk, pk, flush, TRAIN_B, TRAIN_T, [], [], 0,
        "phase 3 (llama3.2-3b, a model-parallel rank, 12 / 4 heads)",
        device=True, decode=False)["prefill"]
    # phase 25: #6 and #5 at the dry run's llama3.2-3b shapes
    out["dryrun"] = dryrun_kernels(torch, cfg_mod, dk, pk, flush)
    # phase 26 (a): #6 on a model-parallel rank's (row, head) pairs of
    # smollm-360m's prefill (B 2 x 15 heads over 2 ranks: 15 pairs of one
    # head a rank, Dh 64)
    sm = cfg_mod.get_config(PART_ARCH)
    out["pairs"] = contiguous_kernels_at(
        torch, dataclasses.replace(sm, num_heads=1, num_kv_heads=1), dk, pk,
        flush, -(-2 * sm.num_heads // 2), PART_PAIRS_T, [], [], 0,
        f"phase 3 ({PART_ARCH}, a model-parallel rank's (row, head) pairs)",
        device=True, decode=False)["prefill"]
    # phase 27 (a): #6 and #5 at a model-parallel rank's heads of
    # qwen3-moe (16 / 2 / 64): the prefill's B 2 x T 2048, the decode's 8
    # rows of 4096 keys
    (_, pb, pt), (_, db, dt) = EP_CASES[:2]
    out["moe_rank"] = contiguous_kernels_at(
        torch, dataclasses.replace(moe, num_heads=moe.num_heads // 2,
                                   num_kv_heads=moe.num_kv_heads // 2),
        dk, pk, flush, pb, pt, [dt] * db, list(range(db)), dt,
        f"phase 3 ({MOE_ARCH}, a model-parallel rank, 16 / 2 heads)",
        device=True)
    # phase 28 (a): #6 and #5 at a model-parallel rank's heads of whisper
    # (10 / 10 / 64, G 1): the prefill's B 2 x 448 decoder tokens, the
    # decode's 8 rows of 4096 self-KV keys
    (_, pb, _), (_, db, dt) = FAM_CASES[:2]
    out["whisper_rank"] = contiguous_kernels_at(
        torch, dataclasses.replace(wh, num_heads=wh.num_heads // 2,
                                   num_kv_heads=wh.num_kv_heads // 2),
        dk, pk, flush, pb, FAM_WHISPER_PROMPT, [dt] * db, list(range(db)),
        dt, f"phase 3 ({WHISPER_ARCH}, a model-parallel rank, 10 / 10 "
        f"heads)", device=True)
    # phase 29 (b): #6 and #5 at a data rank's heads of qwen3-moe at
    # (data 2, model 1) (32 / 4 / 64, G 8): the train step's one row of
    # 1024 tokens, the decode's 4 rows of 4096 keys
    (_, tb, tt), = OPT_CASES[1][3]
    (_, db, dt), = OPT_CASES[2][3]
    n = OPT_CASES[1][2][0]
    out["moe_data_rank"] = contiguous_kernels_at(
        torch, moe, dk, pk, flush, tb // n, tt, [dt] * (db // n),
        list(range(db // n)), dt,
        f"phase 3 ({MOE_ARCH}, a data rank of (2, 1), 32 / 4 heads)",
        device=True)
    return out


def _vlm_slab_call(torch, model_mod, model, params, B, T, device):
    """``Model.prefill`` of T tokens of ``synthetic_batch(cfg, B, T + 1)``
    (a quarter of them patches: vision embeddings, M-RoPE grid ids) into a
    slab of T + 1 rows, then ``decode_step`` of token T at its M-RoPE ids
    through the identity row map; and ``forward_full`` of all T + 1
    tokens. Returns (decode logits, whole-forward last logits, controls),
    f32; ``controls()`` decodes token T again with one fault each and
    returns their logits: "text_ids" at the default text M-RoPE ids
    (position T on all three streams, not the grid's), "swapped_rows"
    through the reversed row map (each row attends the other prompt)."""
    from repro_torch.models import transformer as transformer_mod
    cfg = model.cfg
    batch = model_mod.synthetic_batch(cfg, B, T + 1, np_seed=SEED,
                                      device=device)
    tokens = batch.pop("tokens")
    pre = {k: (v[:, :T] if k in ("vision_mask", "mrope_positions") else v)
           for k, v in batch.items()}
    _, slab = model.prefill(params, tokens[:, :T], T + 1, **pre)
    pos = torch.full((B,), T, dtype=torch.int32, device=device)
    rows = torch.arange(B, dtype=torch.int32, device=device)
    mrope = batch["mrope_positions"][:, T:T + 1]

    def decode(row_map, **kw):
        # each call writes only position T of its rows, then reads it
        out, _ = model.decode_step(params, slab, tokens[:, T], pos,
                                   rows=row_map, **kw)
        return out.float()
    dec = decode(rows, mrope_positions=mrope)
    ref, _, _ = transformer_mod.forward_full(params, cfg, tokens,
                                             last_only=True, **batch)

    def controls():
        return {"text_ids": decode(rows),
                "swapped_rows": decode(rows.flip(0), mrope_positions=mrope)}
    return dec, ref[:, -1].float(), controls


def logit_gap(dec, ref):
    """Per row, the relative L2 distance ``|dec - ref| / |ref|`` of two
    logit rows (a near-tie at the top does not move it)."""
    return ((dec - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()


def phase_vlm(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
              tk, dk, pk):
    """Phase 17: qwen2-vl-7b at full width, bf16, alone on the card: (a)
    one flat engine serving phase 4's requests; (b) a fused engine
    refusing the config; (c) ``prefill`` and ``decode_step`` on the slab
    with vision extras (B 2, T 1024) against the whole forward at full
    depth bf16 and at 2 layers f32; (d) 2 layers f32 on the card and the
    CPU (the flat engine's streams, the model-level call's logits)."""
    base = cfg_mod.get_config(VLM_ARCH)
    B, T = VLM_SLAB
    held = _fresh_card(torch, "phase 17")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 17")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    L = cfg.num_layers

    # (a) the flat engine
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                            attn_backend="flat", preemption=False)
    engine = _serve_trace(np, torch, engine_mod, request_mod, tk, dk, pk,
                          eng, model, prompts, "phase 17 (a)")
    fw = engine["forwards"]
    check(engine["launches"] == {"flat_decode": L * fw["decode"],
                                 "chunked_prefill": L * fw["prefill"]}
          and fw["decode"] and fw["prefill"],
          f"phase 17 (a): launches {engine['launches']} != {L} x forwards "
          f"{fw}")
    eng.shutdown()
    del eng
    torch.cuda.empty_cache()

    # (b) fused refuses the config, as the reference's engine does
    try:
        engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                          attn_backend="fused", preemption=False)
    except ValueError as e:
        check("RoPE / learned-pos only" in str(e),
              f"phase 17 (b): refused for another reason: {e}")
        refusal = str(e)
    else:
        raise AssertionError("phase 17 (b): a fused engine took the VLM")
    torch.cuda.empty_cache()
    log(f"phase 17 (b): a fused engine refuses {VLM_ARCH} as expected: "
        f"{refusal!r}")

    # (c) the slab with vision extras, full depth bf16: each row's logits
    # within VLM_SLAB_GAP of the whole forward's (relative L2), and each
    # control (the decode row at the text ids, the rows swapped) beyond it
    zero_counts(tk, dk, pk)
    dec, ref, controls = _vlm_slab_call(torch, model_mod, model, params, B,
                                        T, "cuda")
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    check(launches == {"contiguous_prefill": 2 * L,
                       "contiguous_decode_padded": L},
          f"phase 17 (c): launches {launches}")
    check(torch.isfinite(dec).all() and torch.isfinite(ref).all(),
          "phase 17 (c): non-finite logits")
    gap = logit_gap(dec, ref)
    gaps = {name: logit_gap(c, ref)
            for name, c in controls().items()}
    log(f"phase 17 (c): relative L2 gap to the whole forward per row "
        f"{gap} (bound {VLM_SLAB_GAP}); controls {json.dumps(gaps)}")
    check(max(gap) <= VLM_SLAB_GAP, f"phase 17 (c): decode logits {gap} "
          f"from the whole forward's (> {VLM_SLAB_GAP})")
    for name, g in gaps.items():
        check(min(g) > VLM_SLAB_GAP, f"phase 17 (c): the {name} control "
              f"passed the bound: {g} (<= {VLM_SLAB_GAP})")
    margins = []
    for b in range(B):
        top2 = ref[b].topk(2).values
        gap = float(top2[0] - top2[1])
        tol = MARGIN_ULPS * bf16_ulp(float(top2[0]))
        same = int(dec[b].argmax()) == int(ref[b].argmax())
        check(same or gap <= tol, f"phase 17 (c): row {b}: decode argmax "
              f"{int(dec[b].argmax())} != whole forward's "
              f"{int(ref[b].argmax())} at a margin of {gap} (> {tol})")
        margins.append({"row": b, "same_argmax": same, "margin": gap,
                        "tolerance": tol})
    diff = (dec - ref).abs().max().item()
    log(f"phase 17 (c): {VLM_ARCH} bf16, B {B}, T {T} ({T // 4} patches): "
        f"prefill + slab decode vs the whole forward at T + 1: argmax "
        f"{json.dumps(margins)}; max abs logit diff {diff:.4f}; launches "
        f"{json.dumps(launches)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) at 2 layers f32, and (d) the card against the CPU
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(base, num_layers=2, dtype=torch.float32)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    cpu2 = _tree_to(gpu2, torch.device("cpu"))
    dec2, ref2, _ = _vlm_slab_call(torch, model_mod, model2, gpu2, B, T,
                                   "cuda")
    torch.testing.assert_close(dec2, ref2, atol=1e-4, rtol=1e-4)
    err2 = (dec2 - ref2).abs().max().item()
    dec_c, ref_c, _ = _vlm_slab_call(torch, model_mod, model2, cpu2, B, T,
                                     "cpu")
    torch.testing.assert_close(dec2.cpu(), dec_c, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ref2.cpu(), ref_c, atol=1e-4, rtol=1e-4)
    dev_err = (dec2.cpu() - dec_c).abs().max().item()
    log(f"phase 17 (c): 2-layer full-width f32: slab decode vs the whole "
        f"forward max abs {err2:.3e} (1e-4); (d) cuda vs cpu model-level "
        f"call max abs {dev_err:.3e} (1e-4)")
    streams = _engine_devices(np, torch, model2, gpu2, cpu2, engine_mod,
                              request_mod, "phase 17 (d)",
                              attn_backend="flat")
    log(f"phase 17 (d): 2-layer full-width f32 {VLM_ARCH} on flat, cuda == "
        f"cpu greedy streams {streams}; {time.perf_counter() - t0:.1f} s")
    del gpu2, cpu2
    gc.collect()
    torch.cuda.empty_cache()
    return {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
            "peak_memory_gb": peak_gb,
            "engine": engine, "refusal": refusal,
            "slab": {"launches": launches, "margins": margins,
                     "max_abs_logit_diff": diff, "relative_l2_gap": gap,
                     "controls": gaps, "bound": VLM_SLAB_GAP,
                     "f32_err": err2,
                     "cuda_cpu_err": dev_err},
            "cuda_cpu_streams": streams}


def phase_window(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
                 tk, dk, pk, ptxas):
    """Phase 18: starcoder2-3b with its published window of 4096, bf16,
    alone on the card: (a) a slab engine (8 slots of a 4096-slot ring,
    max_seq 8192) serving ``WINDOW_PROMPTS`` arriving one a step, under
    sync-debug "error": every request finishes with its count, one d2h a
    step that brings tokens, #6 == layers x the prompts within the window
    (the two longer ones take the banded plain path), #5 == layers x the
    decode forwards, nothing else launched, ``peak_kv_bytes`` the 8 rings;
    (b) the same trace at a window of 8192 (wider than every sequence)
    and with no window: bit-equal streams; (c) 2 layers f32 at W 64 on
    the card and the CPU: equal greedy streams. (d), #5 and #6 at G 12,
    was measured with phase 3 (``family_kernels``); here the ptxas report
    of #5's instance that G 12 runs."""
    base = cfg_mod.get_config(WINDOW_ARCH)
    held = _fresh_card(torch, "phase 18")
    cfg = dataclasses.replace(base, sliding_window=WINDOW,
                              dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    check(not model.supports_paged, "phase 18: a windowed model has a "
          "paged path")
    params, nbytes = _draw_weights(torch, model, "phase 18")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in WINDOW_PROMPTS]
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    runs = {}
    for name, w in (("window 4096", WINDOW), ("window 8192", 8192),
                    ("no window", 0)):
        m = model_mod.build_model(dataclasses.replace(cfg, sliding_window=w))
        eng = engine_mod.Engine(0, m, params, max_slots=8, max_seq=8192,
                                paged=False, preemption=False)
        check(not (eng.paged or eng.chunked_prefill or eng.device_resident),
              f"phase 18 {name}: not a slab engine")
        rows = eng.cache.k.shape[2]
        res = _serve_trace(np, torch, engine_mod, request_mod, tk, dk, pk,
                           eng, m, prompts, f"phase 18 ({name})",
                           new_tokens=WINDOW_NEW)
        fw = res["forwards"]
        within = sum(n <= (w or 8192) for n in WINDOW_PROMPTS)
        want = {"contiguous_prefill": L * within,
                "contiguous_decode_padded": L * fw["decode"]}
        check(res["launches"] == want and fw["prefill"] == len(prompts),
              f"phase 18 ({name}): launches {res['launches']} != {want} "
              f"(forwards {fw})")
        ring = 8 * L * 2 * rows * Hkv * Dh * 2
        check(eng.peak_kv_bytes == ring, f"phase 18 ({name}): peak_kv_bytes "
              f"{eng.peak_kv_bytes} != 8 slots of {rows} rows ({ring})")
        res.update(rows=rows, peak_kv_bytes=eng.peak_kv_bytes)
        log(f"phase 18 ({name}): {rows}-row slots, peak_kv_bytes "
            f"{eng.peak_kv_bytes / 1e9:.4f} GB")
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
        runs[name] = res
    check(runs["window 8192"]["streams"] == runs["no window"]["streams"],
          "phase 18 (b): a window of 8192 parts from no window")
    same = sum(a == b for a, b in zip(runs["window 4096"]["streams"],
                                      runs["no window"]["streams"]))
    log(f"phase 18 (b): window 8192 == no window, bit for bit, on all "
        f"{len(prompts)} streams; window 4096 equals no window on {same}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) 2 layers, full width, f32, W 64: the card against the CPU
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(base, num_layers=2, dtype=torch.float32,
                               sliding_window=WINDOW_SMALL_W)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    cpu2 = _tree_to(gpu2, torch.device("cpu"))
    streams = _engine_devices(np, torch, model2, gpu2, cpu2, engine_mod,
                              request_mod, "phase 18 (c)", lens=WINDOW_SMALL,
                              new=8)
    log(f"phase 18 (c): 2-layer full-width f32 {WINDOW_ARCH} at W "
        f"{WINDOW_SMALL_W}, prompts {WINDOW_SMALL}: cuda == cpu greedy "
        f"streams {streams}; {time.perf_counter() - t0:.1f} s")
    del gpu2, cpu2
    gc.collect()
    torch.cuda.empty_cache()
    tile = {label: rep for label, rep in ptxas.items()
            if label.startswith("contiguous_split_kernel<bf16,128,16>")}
    log(f"phase 18 (d): #5's instance at G 12 (the 16-row tile): {tile}")
    return {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
            "peak_memory_gb": peak_gb, "runs": runs,
            "window_equals_none": same, "cuda_cpu_streams": streams,
            "ptxas_g12": tile}


def phase_rwkv(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
               server_mod, serve_mod, qoe_mod, tk, dk, pk):
    """Phase 19: rwkv6-7b, bf16, alone on the card: (a) a slab engine (8
    rows of state, max_seq 8192) on phase 18's arrivals, under sync-debug
    "error" (every count, one d2h a step, no kernel of the port), then the
    5897-token prompt's prefill alone; (b) one full-width layer in f32 at
    T 1024: the chunked WKV against the sequential one, and against the
    sequential one run in f64 (1e-5 of the largest magnitude, on y and
    the final S), with the init's decays
    (``decay_w0`` -6) and with ``decay_w0`` spread over [-8, -1], a
    random bonus ``u`` in both; (c) a 2-engine
    cluster on phase 6's first 8 requests: at least one migration, each
    piece the whole state; (d) 2 layers f32 on the card and the CPU."""
    from repro_torch.models import rwkv6
    base = cfg_mod.get_config(RWKV_ARCH)
    held = _fresh_card(torch, "phase 19")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 19")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in WINDOW_PROMPTS]

    # (a) the slab engine
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                            preemption=False)
    check(not (eng.paged or eng.chunked_prefill or eng.device_resident),
          "phase 19: not a slab engine")
    engine = _serve_trace(np, torch, engine_mod, request_mod, tk, dk, pk,
                          eng, model, prompts, "phase 19 (a)",
                          new_tokens=WINDOW_NEW)
    check(not engine["launches"] and engine["forwards"]["prefill"]
          == len(prompts), f"phase 19 (a): launches {engine['launches']}, "
          f"forwards {engine['forwards']}")
    engine["peak_kv_bytes"] = eng.peak_kv_bytes
    check(eng.peak_kv_bytes == 8 * RWKV_PIECE_BYTES,
          f"phase 19 (a): peak_kv_bytes {eng.peak_kv_bytes}")
    eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    long = torch.from_numpy(prompts[-1][None]).cuda()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, long)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    engine["prefill_5897_ms"] = walls
    log(f"phase 19 (a): prefill of the {long.shape[1]}-token prompt alone "
        f"(chunked WKV, C {rwkv6.WKV_CHUNK}): {[round(x, 2) for x in walls]}"
        f" ms (host clock around a synchronised call; the first warm)")
    del long

    # (c) the cluster, on the same weights
    cluster = _two_engine_cluster(np, torch, model, params, engine_mod,
                                  request_mod, server_mod, serve_mod,
                                  qoe_mod, tk, dk, pk, "phase 19 (c)",
                                  trace=CLUSTER_TRACE[:8], slab=True)
    check(cluster["piece_bytes"] and all(
        b == RWKV_PIECE_BYTES for b in cluster["piece_bytes"]),
        f"phase 19 (c): piece bytes {cluster['piece_bytes']} != "
        f"{RWKV_PIECE_BYTES}")
    log(f"phase 19 (c): every migration moved one whole state of "
        f"{RWKV_PIECE_BYTES} B: {cluster['piece_bytes']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one full-width layer, f32, T 1024: chunked against sequential
    cfg1 = dataclasses.replace(base, num_layers=1, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    pl = rwkv6.init_layer(gen, cfg1)
    x = torch.randn((1, 1024, cfg1.d_model), generator=gen, device="cuda")
    u = torch.randn(tuple(pl["bonus_u"].shape), generator=gen,
                    device="cuda")
    S0 = torch.zeros((1,) + tuple(u.shape) + (u.shape[-1],), device="cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    wkv = {"T": 1024, "chunk": rwkv6.WKV_CHUNK}
    for name, w0 in (("init decays", None),
                     ("spread decays", torch.linspace(
                         -8.0, -1.0, cfg1.d_model, device="cuda"))):
        if w0 is not None:
            pl["decay_w0"].copy_(w0)
        r, k, v, lw, _ = rwkv6.wkv_inputs(pl, cfg1, x)
        y_seq, S_seq = rwkv6.wkv_sequential(r, k, v, torch.exp(lw), u, S0)
        y_ch, S_ch = rwkv6.wkv_chunked(r, k, v, lw, u, S0)
        # the sequential form in f64 on the same inputs: how far each f32
        # form lies from the recurrence itself
        y64, S64 = rwkv6.wkv_sequential(*(a.double() for a in (
            r, k, v, torch.exp(lw.double()), u, S0)))

        def rel(a, b):
            return float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
        errs = {"y": rel(y_ch, y_seq), "S": rel(S_ch, S_seq),
                "y_chunked_vs_f64": rel(y_ch, y64),
                "S_chunked_vs_f64": rel(S_ch, S64),
                "y_sequential_vs_f64": rel(y_seq, y64),
                "S_sequential_vs_f64": rel(S_seq, S64)}
        check(all(e <= 1e-5 for n, e in errs.items()
                  if "sequential_vs" not in n),
              f"phase 19 (b) {name}: chunked WKV off the sequential one: "
              f"{errs}")
        seq_ms = time_ms(torch, lambda: rwkv6.wkv_sequential(
            r, k, v, torch.exp(lw), u, S0), 2, flush)
        ch_ms = time_ms(torch, lambda: rwkv6.wkv_chunked(
            r, k, v, lw, u, S0), 5, flush)
        log(f"phase 19 (b) {name}: one full-width layer f32, T 1024, "
            f"log w in [{lw.min().item():.3g}, {lw.max().item():.3g}]: "
            f"chunked WKV (C {rwkv6.WKV_CHUNK}) vs sequential: max |diff|"
            f" / max |ref| y {errs['y']:.3e}, S {errs['S']:.3e} (1e-5); "
            f"vs the sequential form in f64: chunked y "
            f"{errs['y_chunked_vs_f64']:.3e} S "
            f"{errs['S_chunked_vs_f64']:.3e} (1e-5), sequential f32 y "
            f"{errs['y_sequential_vs_f64']:.3e} S "
            f"{errs['S_sequential_vs_f64']:.3e}; "
            f"{ch_ms:.3f} ms vs {seq_ms:.3f} ms (events)")
        wkv[name] = {"rel_err": errs, "chunked_ms": ch_ms,
                     "sequential_ms": seq_ms}
    del pl, x, r, k, v, lw, y_seq, y_ch, y64, S64, flush
    torch.cuda.empty_cache()

    # (d) 2 layers, full width, f32: the card against the CPU
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(base, num_layers=2, dtype=torch.float32)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    cpu2 = _tree_to(gpu2, torch.device("cpu"))
    streams = _engine_devices(np, torch, model2, gpu2, cpu2, engine_mod,
                              request_mod, "phase 19 (d)")
    log(f"phase 19 (d): 2-layer full-width f32 {RWKV_ARCH}, cuda (chunked "
        f"WKV) == cpu (sequential) greedy streams {streams}; "
        f"{time.perf_counter() - t0:.1f} s")
    del gpu2, cpu2
    gc.collect()
    torch.cuda.empty_cache()
    return {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
            "peak_memory_gb": peak_gb, "engine": engine,
            "cluster": cluster, "wkv": wkv, "cuda_cpu_streams": streams}


# phases 20-22: zamba2's hybrid, whisper's encoder-decoder, training
ZAMBA_ARCH, WHISPER_ARCH, TRAIN_ARCH = ("zamba2-2.7b", "whisper-large-v3",
                                        "llama3.2-3b")
ZAMBA_PROMPTS, ZAMBA_NEW = (1024, 4096), 32     # B 2 prompts of each length
# a request's zamba2-2.7b state: the SSD state of 54 blocks (80 heads of
# 64 x 64, f32), their conv state (3 rows of 5248, bf16) and the 9 sites'
# K/V (2 x 32 heads x 80, bf16) per cached token
ZAMBA_SSM_BYTES = 54 * 80 * 64 * 64 * 4
ZAMBA_CONV_BYTES = 54 * 3 * (5120 + 2 * 64) * 2
ZAMBA_KV_BYTES_PER_TOKEN = 9 * 2 * 32 * 80 * 2
ZAMBA_SMALL = (6, 300, 8)   # (d): layers (one site), prompt, greedy tokens
# whisper: B 2 x 1500 stub frames, a 4-token prompt, 64 decode steps, the
# self-KV slab at the 448-row position table
WHISPER_B, WHISPER_PROMPT, WHISPER_NEW = 2, 4, 64
WHISPER_CROSS_BYTES = 32 * 2 * 1500 * 20 * 64 * 2    # a request's
WHISPER_SMALL_NEW = 16
# training: B 2 x T 1024 from the token stream, 8 AdamW steps, remat on
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 2, 1024, 8, 3e-4


def _tree_bytes(tree):
    from repro_torch.core.migration import tree_leaves
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


def _synced_ms(torch, fn):
    """``fn()`` and its wall time in ms on the host clock, the card
    synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _greedy(torch, model, params, logits, cache, start, n, device):
    """``n`` greedy decode steps from ``logits`` at positions ``start``..;
    returns (tokens [n][B], logits of each step [n + 1, B, V] f32 on the
    CPU, per-step host ms)."""
    B = logits.shape[0]
    toks, rows, ms = [], [logits.float().cpu()], []
    for i in range(n):
        tok = logits.argmax(-1)
        toks.append(tok.cpu().tolist())
        pos = torch.full((B,), start + i, dtype=torch.int32, device=device)
        if device == "cuda":
            (logits, cache), t = _synced_ms(torch, lambda: model.decode_step(
                params, cache, tok, pos))
            ms.append(t)
        else:
            logits, cache = model.decode_step(params, cache, tok, pos)
        rows.append(logits.float().cpu())
    return toks, torch.stack(rows), ms


def _cuda_cpu(torch, label, model, gpu, cpu, run, tol=1e-4):
    """``run(params, device) -> (tokens, logits)`` on the card and the CPU,
    same weights: equal tokens, logits within ``tol`` of the largest
    magnitude. Returns the tokens."""
    out = {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        out[dev] = run(params, dev)
        log(f"{label}: {dev} run {time.perf_counter() - t0:.1f} s")
    (ta, la), (tb, lb) = out["cuda"], out["cpu"]
    err = float((la - lb).abs().max() / max(1.0, lb.abs().max().item()))
    check(ta == tb, f"{label}: greedy tokens differ: cuda {ta} cpu {tb}")
    check(err <= tol, f"{label}: logits differ by {err:.3e} of the largest "
          f"(> {tol})")
    return ta, err


def phase_zamba(np, torch, cfg_mod, model_mod, tk, dk, pk):
    """Phase 20: zamba2-2.7b at full width, bf16, seeded weights alone on
    the card: (a) ``Model.prefill`` of B 2 prompts of 1024 and of 4096
    tokens (the chunked SSD) into a state of T + 32 rows, then 32 greedy
    decode steps: walls, the state's bytes per request, peak memory, and
    no attention kernel launched (the shared block's Dh 80 takes the
    plain paths by route); (b) one full-width block's SSD in f32 at T
    1024, chunked against sequential (1e-5 of the largest magnitude, y
    and the final state; also against the sequential form in f64), at the
    init's decays and at Mamba2's spread of A and dt, with both times;
    (c) 6 layers (one shared site) f32 on the card and the CPU: prefill
    logits (1e-4) and 8 greedy tokens."""
    from repro_torch.models import mamba2
    base = cfg_mod.get_config(ZAMBA_ARCH)
    held = _fresh_card(torch, "phase 20")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 20")
    rng = np.random.default_rng(SEED)
    zero_counts(tk, dk, pk)
    runs = {}
    for T in ZAMBA_PROMPTS:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, T)).astype(np.int32)).cuda()
        (logits, state), pre_ms = _synced_ms(torch, lambda: model.prefill(
            params, tokens, T + ZAMBA_NEW))
        check(bool(torch.isfinite(logits.float()).all()),
              f"phase 20: prefill of {T} non-finite")
        toks, rows, step_ms = _greedy(torch, model, params, logits, state, T,
                                      ZAMBA_NEW, "cuda")
        check(bool(torch.isfinite(rows).all()), f"phase 20: decode after {T}"
              " non-finite")
        per_req = {k: _tree_bytes(state[k]) // 2 for k in ("ssm", "conv",
                                                           "kv")}
        want = {"ssm": ZAMBA_SSM_BYTES, "conv": ZAMBA_CONV_BYTES,
                "kv": ZAMBA_KV_BYTES_PER_TOKEN * (T + ZAMBA_NEW)}
        check(per_req == want, f"phase 20: state bytes {per_req} != {want}")
        runs[T] = {"prefill_ms": pre_ms, "decode_step_ms": step_ms,
                   "decode_ms": sum(step_ms), "state_bytes": per_req,
                   "tokens": toks}
        log(f"phase 20 (a): prefill B 2 x {T} (chunked SSD, C "
            f"{mamba2.SSD_CHUNK}) {pre_ms:.1f} ms ({2 * T / pre_ms:.0f} "
            f"tokens/ms); {ZAMBA_NEW} greedy decode steps {sum(step_ms):.1f}"
            f" ms (mean {sum(step_ms) / len(step_ms):.2f} ms, min "
            f"{min(step_ms):.2f}, the first {step_ms[0]:.2f}; host clock "
            f"around synchronised calls); state per request: SSM "
            f"{per_req['ssm']} B, conv {per_req['conv']} B, KV "
            f"{per_req['kv']} B ({ZAMBA_KV_BYTES_PER_TOKEN} B x {T + ZAMBA_NEW}"
            f" rows; {ZAMBA_KV_BYTES_PER_TOKEN * 4096} B at 4096)")
        del logits, state, tokens
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    check(not launches, f"phase 20: Dh {cfg.head_dim} launched {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 20 (a): peak memory {peak_gb:.2f} GB ({nbytes / 1e9:.2f} GB "
        f"of weights); attention launches {launches or 'none'} (Dh "
        f"{cfg.head_dim} is plain by route)")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one full-width block's SSD, f32, T 1024
    cfg1 = dataclasses.replace(base, num_layers=base.attn_every,
                               dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    pl = mamba2.init_mamba_block(gen, cfg1)
    x = torch.randn((1, 1024, cfg1.d_model), generator=gen, device="cuda")
    h = mamba2.rms_norm(x, pl["ln"], cfg1.norm_eps)
    z, xs, Bm, Cm, dt = mamba2._split_proj(cfg1, h @ pl["w_in"])
    d_inner, H, P, N = mamba2.dims(cfg1)
    xs, Bm, Cm = torch.split(mamba2._conv_seq(pl, torch.cat(
        [xs, Bm, Cm], -1)), [d_inner, N, N], dim=-1)
    S0 = torch.zeros((1, H, P, N), device="cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    ssd = {"T": 1024, "chunk": mamba2.SSD_CHUNK}
    for name, A_log, dt_bias in (
            ("init decays", None, None),
            ("spread decays", torch.linspace(-3.0, 2.7, H, device="cuda"),
             torch.linspace(-7.0, -2.0, H, device="cuda"))):
        if A_log is not None:
            pl["A_log"].copy_(A_log)
            pl["dt_bias"].copy_(dt_bias)
        xh, dtf, la = mamba2.ssd_inputs(pl, cfg1, xs, dt)
        ops = (xh, Bm, Cm, dtf, la, S0)
        y_seq, S_seq = mamba2.ssd_sequential(*ops)
        y_ch, S_ch = mamba2.ssd_chunked(*ops)
        y64, S64 = mamba2.ssd_sequential(*(a.double() for a in ops))

        def rel(a, b):
            return float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
        errs = {"y": rel(y_ch, y_seq), "S": rel(S_ch, S_seq),
                "y_chunked_vs_f64": rel(y_ch, y64),
                "S_chunked_vs_f64": rel(S_ch, S64),
                "y_sequential_vs_f64": rel(y_seq, y64),
                "S_sequential_vs_f64": rel(S_seq, S64)}
        check(all(e <= 1e-5 for n, e in errs.items()
                  if "sequential_vs" not in n),
              f"phase 20 (b) {name}: chunked SSD off the sequential one: "
              f"{errs}")
        seq_ms = time_ms(torch, lambda: mamba2.ssd_sequential(*ops), 2,
                         flush)
        ch_ms = time_ms(torch, lambda: mamba2.ssd_chunked(*ops), 5, flush)
        log(f"phase 20 (b) {name}: one full-width block f32, T 1024, log "
            f"decay in [{la.min().item():.3g}, {la.max().item():.3g}]: "
            f"chunked SSD (C {mamba2.SSD_CHUNK}) vs sequential: max |diff| /"
            f" max |ref| y {errs['y']:.3e}, S {errs['S']:.3e} (1e-5); vs the"
            f" sequential form in f64: chunked y {errs['y_chunked_vs_f64']:.3e}"
            f" S {errs['S_chunked_vs_f64']:.3e} (1e-5), sequential f32 y "
            f"{errs['y_sequential_vs_f64']:.3e} S "
            f"{errs['S_sequential_vs_f64']:.3e}; {ch_ms:.3f} ms vs "
            f"{seq_ms:.3f} ms (events)")
        ssd[name] = {"rel_err": errs, "chunked_ms": ch_ms,
                     "sequential_ms": seq_ms}
    del pl, x, h, z, xs, Bm, Cm, dt, xh, dtf, la, y_seq, y_ch, y64, flush
    torch.cuda.empty_cache()

    # (c) 6 layers (one shared site), f32: the card against the CPU
    L, T, n = ZAMBA_SMALL
    cfg6 = dataclasses.replace(base, num_layers=L, dtype=torch.float32)
    model6 = model_mod.build_model(cfg6)
    gpu6 = model6.init(SEED, device="cuda")
    cpu6 = _tree_to(gpu6, torch.device("cpu"))
    prompt = rng.integers(0, cfg6.vocab_size, (1, T)).astype(np.int32)

    def run(params, dev):
        logits, state = model6.prefill(params, torch.from_numpy(prompt).to(
            dev), T + n)
        toks, rows, _ = _greedy(torch, model6, params, logits, state, T, n,
                                dev)
        return toks, rows
    toks, err = _cuda_cpu(torch, "phase 20 (c)", model6, gpu6, cpu6, run)
    log(f"phase 20 (c): {L}-layer full-width f32 {ZAMBA_ARCH}, prompt {T}: "
        f"cuda (chunked SSD) == cpu (sequential) greedy tokens "
        f"{[t[0] for t in toks]}, logits within {err:.3e} of the largest "
        "(1e-4)")
    del gpu6, cpu6
    gc.collect()
    torch.cuda.empty_cache()
    return {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
            "parameters": nbytes / 2, "peak_memory_gb": peak_gb,
            "runs": runs, "launches": launches, "ssd": ssd,
            "cuda_cpu_err": err}


def phase_whisper(np, torch, cfg_mod, model_mod, tk, dk, pk):
    """Phase 21: whisper-large-v3 at full width, bf16, alone on the card:
    (a) the encoder over B 2 x 1500 stub frames, ``Model.prefill`` of a
    4-token decoder prompt into a 448-row self-KV slab (#6 == 32 launches,
    nothing else) and 64 greedy decode steps (#5 == 64 a step: 32 on the
    self-KV, 32 on the cross-KV, counted by the slab they read, nothing
    else); walls, the cross-KV's bytes a request; (b) 2 + 2 layers f32 on
    the card and the CPU: the streams and logits (1e-4)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import whisper
    base = cfg_mod.get_config(WHISPER_ARCH)
    held = _fresh_card(torch, "phase 21")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 21")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    B, P, n = WHISPER_B, WHISPER_PROMPT, WHISPER_NEW
    audio = randn(torch, gen, (B, cfg.encoder_seq, cfg.d_model),
                  torch.bfloat16)
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                              .astype(np.int32)).cuda()
    _, enc_ms = _synced_ms(torch, lambda: whisper.encode(params, cfg, audio))
    zero_counts(tk, dk, pk)
    (logits, cache), pre_ms = _synced_ms(torch, lambda: model.prefill(
        params, prompt, cfg.max_position, audio_embeds=audio))
    after_prefill = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    check(after_prefill == {"contiguous_prefill": cfg.num_layers},
          f"phase 21: prefill launched {after_prefill}")
    by_slab = {}
    real = attn_mod.decode_attention

    def counted(q, k, v, lengths, **kw):
        by_slab[k.shape[1]] = by_slab.get(k.shape[1], 0) + 1
        return real(q, k, v, lengths, **kw)
    attn_mod.decode_attention = counted
    try:
        toks, rows, step_ms = _greedy(torch, model, params, logits, cache, P,
                                      n, "cuda")
    finally:
        attn_mod.decode_attention = real
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    want = {"contiguous_prefill": cfg.num_layers,
            "contiguous_decode_padded": 2 * cfg.num_layers * n}
    check(launches == want, f"phase 21: launches {launches} != {want}")
    check(by_slab == {cfg.max_position: cfg.num_layers * n,
                      cfg.encoder_seq: cfg.num_layers * n},
          f"phase 21: #5 by slab rows {by_slab}")
    check(bool(torch.isfinite(rows).all()), "phase 21: non-finite logits")
    cross = _tree_bytes(cache.cross_kv) // B
    check(cross == WHISPER_CROSS_BYTES, f"phase 21: cross-KV {cross} B")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 21 (a): encode B {B} x {cfg.encoder_seq} frames "
        f"{enc_ms:.1f} ms; prefill (encode + {P}-token prompt) {pre_ms:.1f} "
        f"ms; {n} greedy decode steps {sum(step_ms):.1f} ms (mean "
        f"{sum(step_ms) / n:.2f} ms, min {min(step_ms):.2f}; host clock "
        f"around synchronised calls); cross-KV {cross} B a request; "
        f"launches {json.dumps(launches)} (#5 by slab rows "
        f"{json.dumps(by_slab)}); peak memory {peak_gb:.2f} GB")
    out = {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
           "parameters": nbytes / 2, "encode_ms": enc_ms,
           "prefill_ms": pre_ms, "decode_step_ms": step_ms,
           "decode_ms": sum(step_ms), "cross_kv_bytes": cross,
           "launches": launches, "decode_by_slab": by_slab,
           "peak_memory_gb": peak_gb, "tokens": toks}
    del params, cache, logits, audio
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 2 + 2 layers, f32: the card against the CPU
    cfg2 = dataclasses.replace(base, num_layers=2, encoder_layers=2,
                               dtype=torch.float32)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    cpu2 = _tree_to(gpu2, torch.device("cpu"))
    audio = torch.from_numpy(rng.normal(0, 1, (1, cfg2.encoder_seq,
                                               cfg2.d_model))
                             .astype(np.float32))
    prompt = rng.integers(0, cfg2.vocab_size, (1, P)).astype(np.int32)

    def run(params, dev):
        logits, cache = model2.prefill(
            params, torch.from_numpy(prompt).to(dev), P + WHISPER_SMALL_NEW,
            audio_embeds=audio.to(dev))
        toks, rows, _ = _greedy(torch, model2, params, logits, cache, P,
                                WHISPER_SMALL_NEW, dev)
        return toks, rows
    toks, err = _cuda_cpu(torch, "phase 21 (b)", model2, gpu2, cpu2, run)
    log(f"phase 21 (b): 2 + 2-layer full-width f32 {WHISPER_ARCH}: cuda == "
        f"cpu greedy tokens {[t[0] for t in toks]}, logits within {err:.3e} "
        "of the largest (1e-4)")
    out["cuda_cpu_err"] = err
    del gpu2, cpu2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(np, torch, cfg_mod, model_mod, tk, dk, pk):
    """Phase 22: training. (a) llama3.2-3b at full width, bf16 params,
    f32 moments, B 2 x T 1024 from ``TokenStream``, remat on, 8 AdamW
    steps at lr 3e-4 (warmup 1): per step the loss, gradient norm, lr,
    wall, tokens/s and peak memory; every loss finite and the last below
    the first; #6 launched steps x layers x 2 times (remat runs each
    layer's forward twice), nothing else; (b) 2 layers f32 on the card:
    the wrapped #6's gradients against autograd through its plain version
    (1e-4), one step (finite; the step against the CPU's is phase 24
    (b)'s llama3.2-3b case), a checkpoint of the 2-layer model's attention
    weights and their AdamW state written from the card and read back onto
    it, bit for bit."""
    from repro_torch.kernels import prefill_attention as pk_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.core.migration import tree_leaves
    from repro_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.trainer import batch_to, make_train_step
    base = cfg_mod.get_config(TRAIN_ARCH)
    held = _fresh_card(torch, "phase 22")
    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    model = model_mod.build_model(cfg)
    params, nbytes = _draw_weights(torch, model, "phase 22")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg, remat=True)
    opt_state = init_adamw(params)
    stream = iter(TokenStream(cfg, DataConfig(batch_size=TRAIN_B,
                                              seq_len=TRAIN_T, seed=SEED)))
    zero_counts(tk, dk, pk)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = batch_to(next(stream), "cuda")
        torch.cuda.reset_peak_memory_stats()
        (params, opt_state, m), ms = _synced_ms(
            torch, lambda: step_fn(params, opt_state, batch))
        row = {"step": i + 1, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
               "ms": ms, "tokens_per_s": TRAIN_B * TRAIN_T / ms * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        log(f"phase 22 (a): step {row['step']} loss {row['loss']:.4f} "
            f"grad_norm {row['grad_norm']:.4f} lr {row['lr']:.3e} "
            f"{ms:.1f} ms ({row['tokens_per_s']:.0f} tokens/s, host clock "
            f"around a synchronised step) peak memory "
            f"{row['peak_memory_gb']:.2f} GB")
    launches = {k: v for k, v in launch_counts(tk, dk, pk).items() if v}
    want = {"contiguous_prefill": TRAIN_STEPS * cfg.num_layers * 2}
    check(launches == want, f"phase 22: launches {launches} != {want} "
          "(steps x layers x 2 with remat)")
    losses = [r["loss"] for r in steps]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"phase 22: losses {losses}")
    out = {"held_before_gb": held / 1e9, "weights_gb": nbytes / 1e9,
           "steps": steps, "launches": launches,
           "moments_gb": 2 * sum(p.numel() for p in tree_leaves(params))
           * 4 / 1e9}
    del params, opt_state, m, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 2 layers, f32, on the card: the wrapped #6 against plain
    # autograd, one step, a checkpoint round trip (the step against the
    # CPU's is phase 24 (b)'s llama3.2-3b case, on two ranks)
    cfg2 = dataclasses.replace(base, num_layers=2, dtype=torch.float32)
    model2 = model_mod.build_model(cfg2)
    gpu2 = model2.init(SEED, device="cuda")
    b = batch_to(next(iter(TokenStream(cfg2, DataConfig(
        batch_size=2, seq_len=64, seed=SEED)))), "cuda")
    leaves = [p.requires_grad_() for p in tree_leaves(gpu2)]
    loss, _ = model2.loss(gpu2, b, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    full = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    wrapped = attn_mod.causal_prefill
    attn_mod.causal_prefill = (
        lambda q, k, v: pk_mod.prefill_attention_plain(q, k, v, full))
    try:
        plain_loss, _ = model2.loss(gpu2, b)
        plain = torch.autograd.grad(plain_loss, leaves)
    finally:
        attn_mod.causal_prefill = wrapped
    wrap_err = max(float((g - h).abs().max()
                         / max(h.abs().max().item(), 1e-30))
                   for g, h in zip(grads, plain))
    check(wrap_err <= 1e-4, f"phase 22 (b): wrapped #6 grads off plain "
          f"autograd by {wrap_err:.3e}")
    del grads, plain
    step = make_train_step(model2, opt_cfg, remat=True)
    gpu2, st, m = step(gpu2, init_adamw(gpu2), b)
    la = float(m["loss"])
    check(math.isfinite(la) and _finite(torch, gpu2),
          f"phase 22 (b): the step's loss {la} or params not finite")
    # the attention weights of both layers and their AdamW state (the
    # whole model's would be 8.7 GB on disk)
    path = ROOT / "build" / "phase22_checkpoint.npz"
    tree = {"attn": gpu2["layers"]["attn"],
            "opt": type(st)(st.step, st.mu["layers"]["attn"],
                            st.nu["layers"]["attn"])}
    save_checkpoint(str(path), tree, 1)
    like = {"attn": {k: torch.zeros_like(v) for k, v in tree["attn"].items()},
            "opt": tree["opt"]._replace(step=torch.zeros_like(st.step))}
    back, step_no = load_checkpoint(str(path), like)
    same = all(bool(torch.equal(a, b)) and b.device.type == "cuda"
               for a, b in zip(tree_leaves(tree), tree_leaves(back)))
    ck_bytes = path.stat().st_size
    path.unlink()
    check(step_no == 1 and same, "phase 22 (b): checkpoint round trip "
          "changed a leaf")
    log(f"phase 22 (b): 2-layer full-width f32 {TRAIN_ARCH}, one step on "
        f"the card: loss {la:.6f}; wrapped #6 grads within {wrap_err:.3e} "
        f"of plain autograd (1e-4); checkpoint round trip on the card "
        f"({ck_bytes} B) bit for bit")
    out.update(wrapped_vs_plain_err=wrap_err, checkpoint_bytes=ck_bytes)
    del gpu2, st, back, like, tree
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 23: tensor-parallel serving, two ranks on one card
# --------------------------------------------------------------------------
TP_NOTE = "two ranks on one card; not a TP speedup"
TP_DEVICES = ("cuda:0", "cuda:0")
# the (1, 2, 1) chain: stages [0, 64), [64, 128), [128, inf) of one
# instance-unit each, claimed in order by a tp=1 engine, the tp=2 one (its
# capacity weight 2 covers the unit) and a tp=1 engine; each request
# decodes across both boundaries
TP_CHAIN = (1, 2, 1)
TP_CHAIN_LENS = ((40, 110), (50, 100), (30, 120))


def _tp_shard_bytes(params, tp):
    """Bytes one rank holds of ``params`` under the serving rules."""
    from repro_torch.launch import shardings
    specs = shardings.serving_param_spec_tree(params, tp)
    return sum(a.numel() * a.element_size() // (tp if specs[p] else 1)
               for p, a in shardings.param_leaves(params))


def _probe_logits(np, eng, request_mod, tokens):
    """The first-token logits [V] (f32, on the host) of ``tokens`` as one
    prompt through ``eng`` (drained, whole-prompt prefill): what that
    engine decides after this context. Spies on the leader's model; the
    ranks compute as always."""
    seen = []
    real = eng.model

    def spied(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.append(out[0][0])
            return out
        return call
    eng.model = dataclasses.replace(
        real, prefill_bucketed=spied(real.prefill_bucketed))
    r = request_mod.ServeRequest(0, np.asarray(tokens, np.int32), 1)
    eng.submit(r)
    for _ in range(200):
        if eng.step():
            break
    check(r.state.name == "FINISHED", "phase 23: a margin probe did not "
          "finish")
    eng.model = real
    return seen[-1].float().cpu()


def _tp_margins(np, torch, cfg, model, params, engine_mod, request_mod,
                mesh, streams, ref_streams):
    """Where a tp=2 stream parts from tp=1's: each engine (fresh, on
    whole-prompt prefill: one forward a probe) fed the context up to that
    token must hold both tokens within ``MARGIN_ULPS`` bf16 ulps of its
    best logit (phase 11's rule). Returns the divergence points with
    their margins."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    parted = [i for i, (a, b) in enumerate(zip(streams, ref_streams))
              if a != b]
    if not parted:
        return []
    kw = dict(max_slots=1, max_seq=8192, preemption=False,
              chunked_prefill=False)
    probes = {"tp1": engine_mod.Engine(0, model, params, **kw),
              "tp2": engine_mod.Engine(1, model, params, tp=2, mesh=mesh,
                                       **kw)}
    rows = []
    for i in parted:
        a, b = streams[i], ref_streams[i]
        j = next(x for x in range(len(a)) if a[x] != b[x])
        row = {"request": i, "token": j, "tp2": a[j], "tp1": b[j]}
        for who, eng in probes.items():
            lg = _probe_logits(np, eng, request_mod, list(prompts[i]) + a[:j])
            top2 = torch.topk(lg, 2).values
            top = float(top2[0])
            behind = max(top - float(lg[a[j]]), top - float(lg[b[j]]))
            tol = MARGIN_ULPS * bf16_ulp(top)
            check(behind <= tol, f"phase 23: request {i} token {j}: the "
                  f"{who} probe puts a stream's token {behind} behind its "
                  f"best {top} (> {MARGIN_ULPS} bf16 ulps, {tol})")
            row[f"{who}_top"] = top
            row[f"{who}_top2_gap"] = float(top2[0] - top2[1])
            row[f"{who}_gap_between_the_two"] = float(lg[a[j]] - lg[b[j]])
            row[f"{who}_behind_best"] = behind
            row[f"{who}_tolerance"] = tol
        rows.append(row)
    for eng in probes.values():
        eng.shutdown()
    return rows


def _tp_engine(np, torch, cfg, model, params, engine_mod, request_mod, mesh,
               tk, dk, pk, ref_streams, ref_blocks):
    """Phase 23 (a): the full-width tp=2 fused engine on phase 4's
    requests."""
    t0 = time.perf_counter()
    eng = engine_mod.Engine(0, model, params, max_slots=8, max_seq=8192,
                            preemption=False, tp=2, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.fused_mixed, "phase 23: the tp=2 engine is not on fused")
    L, Hkv = cfg.num_layers, cfg.num_kv_heads
    check(eng.num_blocks == 2 * ref_blocks,
          f"phase 23: {eng.num_blocks} blocks, tp=1 {ref_blocks}")
    leaf = (L, eng.num_blocks + 1, eng.block_size, Hkv // 2, cfg.head_dim)
    worker = mesh.worker_stats()[0]["engines"][eng._tp_key]
    check(all(tuple(a.shape) == leaf for a in eng.cache)
          and all(tuple(s) == leaf for s in worker["pool_shapes"]),
          f"phase 23: pool leaves {[tuple(a.shape) for a in eng.cache]} / "
          f"{worker['pool_shapes']} != {leaf}")
    full = sum(v.numel() * v.element_size() for v in _leaves(params))
    shard = _tp_shard_bytes(params, 2)
    mine = sum(v.numel() * v.element_size() for v in _leaves(eng.params))
    check(mine == shard == worker["param_bytes"],
          f"phase 23: weights a rank {mine} / {worker['param_bytes']} B, "
          f"the rules give {shard}")
    log(f"phase 23 (a): tp=2 fused engine ready in {build_s:.1f} s (each "
        f"worker's weight shard shipped once over the host channel): "
        f"{eng.num_blocks} blocks = 2 x tp=1's {ref_blocks} at the same "
        f"per-rank token budget; each rank's pool leaf {leaf} (Hkv "
        f"{Hkv} / 2), {worker['pool_bytes'] / 1e9:.4f} GB a rank; weights "
        f"{shard / 1e9:.4f} GB a rank = {shard / full:.4f} of "
        f"{full / 1e9:.4f} GB")
    rng = np.random.default_rng(SEED)
    reqs = [request_mod.ServeRequest(
        i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
        for i, (n, m) in enumerate(zip(PROMPTS, NEW_TOKENS))]
    zero_counts(tk, dk, pk)
    mesh.zero_worker_stats()
    engine_mod.ATTN_CALLS = engine_mod.D2H_CALLS = 0
    mesh.coll_calls, mesh.coll_s = 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    for r in reqs:
        eng.submit(r)
    step_ms, end_at, done = [], {}, []
    t_start = time.perf_counter()
    while len(done) < len(reqs):
        check(eng.steps < 2000, "phase 23: the tp=2 engine did not drain")
        d0, a0 = engine_mod.D2H_CALLS, engine_mod.ATTN_CALLS
        g0 = sum(len(r.generated) for r in reqs)
        t = time.perf_counter()
        done += eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        end_at[eng.steps] = time.perf_counter() - t_start
        grew = sum(len(r.generated) for r in reqs) > g0
        check(engine_mod.ATTN_CALLS - a0 == 1, f"phase 23: step "
              f"{eng.steps}: {engine_mod.ATTN_CALLS - a0} forwards")
        check(engine_mod.D2H_CALLS - d0 == (1 if grew else 0),
              f"phase 23: step {eng.steps}: {engine_mod.D2H_CALLS - d0} d2h "
              f"(tokens reached the host: {grew})")
    wall = time.perf_counter() - t_start
    forwards = engine_mod.ATTN_CALLS
    lead = launch_counts(tk, dk, pk)
    work = mesh.worker_stats()[0]
    for who, counts in (("leader", lead), ("worker", work["launches"])):
        check(counts["fused"] == L * forwards > 0,
              f"phase 23: {who} launched #1 {counts['fused']} times, not "
              f"{L} x {forwards}")
        others = {k: n for k, n in counts.items() if n and k != "fused"}
        check(not others, f"phase 23: {who} ran other kernels: {others}")
    check(work["d2h"] == 0 and work["attn_calls"] == forwards,
          f"phase 23: the worker made {work['d2h']} d2h and "
          f"{work['attn_calls']} forwards ({forwards} on the leader)")
    for r in reqs:
        check(len(r.generated) == r.max_new_tokens and not r.rejected,
              f"phase 23: request {r.req_id}: {len(r.generated)} tokens")
    streams = [list(r.generated) for r in reqs]
    ntok = sum(len(s) for s in streams)
    steps = eng.steps
    peak = {"leader": torch.cuda.max_memory_allocated(),
            "worker": work["peak_memory_bytes"]}
    ttft_s = [end_at[r.first_token_step] for r in reqs]
    tpot_s = [(end_at[r.finish_step] - end_at[r.first_token_step])
              / (len(r.generated) - 1) for r in reqs]
    coll = {"leader_calls": mesh.coll_calls, "leader_s": mesh.coll_s,
            "worker_calls": work["coll_calls"], "worker_s": work["coll_s"]}
    log(f"phase 23 (a) [{TP_NOTE}]: {len(reqs)} requests drained in "
        f"{steps} steps, {wall:.3f} s; {ntok} tokens, {ntok / wall:.1f} "
        f"tokens/s; step ms mean {sum(step_ms) / len(step_ms):.2f} min "
        f"{min(step_ms):.2f} max {max(step_ms):.2f}; #1 launches "
        f"{lead['fused']} on the leader, {work['launches']['fused']} on the "
        f"worker = {L} x {forwards} forwards; d2h {engine_mod.D2H_CALLS} on "
        f"the leader, {work['d2h']} on the worker")
    log(f"phase 23 (a) [{TP_NOTE}]: collectives a step: leader "
        f"{mesh.coll_calls / steps:.1f} calls, "
        f"{mesh.coll_s / steps * 1e3:.2f} ms; worker "
        f"{work['coll_calls'] / steps:.1f} calls, "
        f"{work['coll_s'] / steps * 1e3:.2f} ms (host time inside gloo, "
        f"which stages each CUDA tensor through host memory and waits for "
        f"the kernels that produce it); peak memory leader "
        f"{peak['leader'] / 1e9:.2f} GB (the whole weights beside its "
        f"shard), worker {peak['worker'] / 1e9:.2f} GB")
    log(f"phase 23 (a) [{TP_NOTE}]: TTFT s {[round(x, 4) for x in ttft_s]}"
        f"; TPOT s {[round(x, 5) for x in tpot_s]}")
    eng.check_drained()
    eng.shutdown()
    same = sum(a == b for a, b in zip(streams, ref_streams))
    margins = _tp_margins(np, torch, cfg, model, params, engine_mod,
                          request_mod, mesh, streams, ref_streams)
    log(f"phase 23 (a): tp=2 vs tp=1 (phase 4, same card and weights) "
        f"greedy streams: {same}/{len(streams)} identical" + (
            "; where they part, each probe has both tokens within "
            f"{MARGIN_ULPS} bf16 ulps of its best; the margins: "
            + json.dumps(margins) if margins else ""))
    return {"steps": steps, "wall_s": wall, "tokens": ntok,
            "tokens_per_s": ntok / wall, "step_ms": step_ms,
            "ttft_s": ttft_s, "tpot_s": tpot_s, "build_s": build_s,
            "forwards": forwards, "launches": {"leader": lead,
                                               "worker": work["launches"]},
            "collectives": coll, "peak_memory_bytes": peak,
            "num_blocks": eng.num_blocks, "tp1_blocks": ref_blocks,
            "pool_leaf": leaf, "pool_bytes_a_rank": worker["pool_bytes"],
            "weight_bytes_a_rank": shard, "weight_bytes": full,
            "identical_streams": same, "diverged": margins,
            "streams": streams}


def _tp_small(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
              server_mod, mesh, tk, dk, pk):
    """Phase 23 (b): 2 layers f32, tp=2 on the card == tp=1 on the CPU on
    flat and grid; (c) the (1, 2, 1) chain cluster on the card."""
    from repro_torch.core.partition import PipelinePlan, Stage
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              num_layers=2, dtype=torch.float32)
    model = model_mod.build_model(cfg)
    cpu_params = cpu_weights(model)
    gpu_params = _tree_to(cpu_params, torch.device("cuda"))
    kinds = {"flat": ("flat_decode", "chunked_prefill"),
             "grid": ("grid_decode", "chunked_prefill")}
    out = {}
    for backend, names in kinds.items():
        runs = {}
        for dev, params, tp in (("cpu", cpu_params, 1),
                                ("cuda", gpu_params, 2)):
            zero_counts(tk, dk, pk)
            mesh.zero_worker_stats()
            a0 = engine_mod.ATTN_CALLS
            eng = engine_mod.Engine(0, model, params, max_slots=3,
                                    max_seq=512, prefill_token_budget=64,
                                    preemption=False, attn_backend=backend,
                                    tp=tp, mesh=mesh if tp > 1 else None)
            reqs = _small_requests(np, request_mod, cfg.vocab_size)
            for r in reqs:
                eng.submit(r)
            while not all(r.state.name == "FINISHED" for r in reqs):
                check(eng.steps < 200, "phase 23 (b): did not drain")
                eng.step()
            eng.shutdown()
            runs[dev] = [list(r.generated) for r in reqs]
        forwards = engine_mod.ATTN_CALLS - a0
        lead = launch_counts(tk, dk, pk)
        work = mesh.worker_stats()[0]["launches"]
        for who, counts in (("leader", lead), ("worker", work)):
            got = sum(counts[k] for k in names)
            check(got == cfg.num_layers * forwards > 0,
                  f"phase 23 (b) {backend}: {who} launched {got}, not "
                  f"{cfg.num_layers} x {forwards}")
        check(runs["cuda"] == runs["cpu"], f"phase 23 (b) {backend}: tp=2 "
              f"cuda {runs['cuda']} != tp=1 cpu {runs['cpu']}")
        out[backend] = runs["cuda"]
        log(f"phase 23 (b): 2-layer full-width f32 {cfg.name} on "
            f"{backend}: tp=2 on the card == tp=1 on the CPU, greedy "
            f"streams {runs['cuda']}; {cfg.num_layers} x {forwards} "
            f"launches of {names} on each rank")
    # (c) a request decoding across both boundaries moves tp=1 -> tp=2
    # -> tp=1 through the control plane; its stream is the one a single
    # tp=1 engine on the card decodes
    plan = PipelinePlan([Stage(0.0, 64.0, 1), Stage(64.0, 128.0, 1),
                         Stage(128.0, float("inf"), 1)], 0.0)
    kw = dict(max_slots=4, max_seq=512, prefill_token_budget=64,
              preemption=False)

    def factory(i):
        return engine_mod.Engine(i, model, gpu_params, tp=TP_CHAIN[i],
                                 mesh=mesh if TP_CHAIN[i] > 1 else None,
                                 **kw)

    def chain_reqs():
        rng = np.random.default_rng(SEED + 2)
        return [request_mod.ServeRequest(
            i, rng.integers(0, cfg.vocab_size, p).astype(np.int32), n)
            for i, (p, n) in enumerate(TP_CHAIN_LENS)]
    srv = server_mod.MILSServer(
        model, gpu_params, plan, None, server_mod.ServerConfig(
            refinement="none", balancing="rr", seed=SEED, preemption=False),
        tp=TP_CHAIN, engine_factory=factory)
    reqs = chain_reqs()
    for i, r in enumerate(reqs):
        srv.submit_at(r, i)
    t0 = time.perf_counter()
    srv.run(max_steps=600)
    wall = time.perf_counter() - t0
    check([st.instance_ids for st in srv.plane.stages] == [[0], [1], [2]],
          f"phase 23 (c): stages {srv.plane.stages}")
    migs = [d for d in srv.plane.decisions if d[0] == "migrate"]
    for r in reqs:
        hops = [(d[2], d[3]) for d in migs if d[1] == r.req_id]
        check(hops == [(0, 1), (1, 2)],
              f"phase 23 (c): request {r.req_id} moved {hops}")
    srv.close()
    ref = engine_mod.Engine(9, model, gpu_params, **kw)
    alone = chain_reqs()
    for r in alone:
        ref.submit(r)
    while not all(r.state.name == "FINISHED" for r in alone):
        check(ref.steps < 600, "phase 23 (c): the tp=1 engine did not drain")
        ref.step()
    ref.shutdown()
    check([r.generated for r in reqs] == [r.generated for r in alone],
          "phase 23 (c): a migrated stream parts from the unmigrated one")
    log(f"phase 23 (c) [{TP_NOTE}]: a (1, 2, 1) cluster, 2-layer f32: "
        f"each of {len(reqs)} requests moved tp=1 -> tp=2 -> tp=1 "
        f"({len(migs)} migrations, {srv.migrated_bytes / 1e6:.3f} MB), its "
        f"stream the unmigrated tp=1 engine's; {srv.steps} steps, "
        f"{wall:.2f} s")
    out["chain"] = {"migrations": len(migs), "steps": srv.steps,
                    "wall_s": wall, "migrated_bytes": srv.migrated_bytes}
    return out


def phase_tp(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
             server_mod, tk, dk, pk, ref_streams, ref_blocks):
    """Phase 23: tensor-parallel serving on the card's one device, two
    ranks (this process and a ``launch.tp_worker``) on ``cuda:0`` over
    gloo. (a) llama3.2-3b at full width, bf16, as a tp=2 fused engine on
    phase 4's requests: twice the blocks at the same per-rank budget, each
    rank half the pool leaf's heads and its share of the weights, one
    d2h a step on the leader and none on the worker, #1 == layers x
    forwards on each rank and nothing else, the streams against phase 4's
    (where they part, phase 11's margin rule on fresh tp=1 and tp=2
    engines); (b) 2 layers f32: tp=2 on the card == tp=1 on the CPU on
    flat and grid; (c) the (1, 2, 1) chain."""
    from repro_torch.launch import mesh as mesh_mod
    _fresh_card(torch, "phase 23")
    t0 = time.perf_counter()
    mesh = mesh_mod.make_tp_mesh(2, list(TP_DEVICES), "gloo")
    log(f"phase 23: a mesh of 2 ranks on {list(TP_DEVICES)} over "
        f"{mesh.backend} (the worker started and joined in "
        f"{time.perf_counter() - t0:.1f} s); NCCL not measured: the machine "
        f"has {torch.cuda.device_count()} device and NCCL puts one rank on "
        f"a card")
    try:
        cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                                  dtype=torch.bfloat16)
        model = model_mod.build_model(cfg)
        params, _ = _draw_weights(torch, model, "phase 23")
        out = _tp_engine(np, torch, cfg, model, params, engine_mod,
                         request_mod, mesh, tk, dk, pk, ref_streams,
                         ref_blocks)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out.update(_tp_small(np, torch, cfg_mod, model_mod, engine_mod,
                             request_mod, server_mod, mesh, tk, dk, pk))
    finally:
        mesh.close()
    out["backend"] = mesh.backend
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 24: sharded training, two ranks on one card
# --------------------------------------------------------------------------
SHARD_NOTE = "two ranks on one card; not a speedup"
SHARD_STEPS = 2            # (a): phase 22's first 2 steps
# (b): one step. The CPU references are (b)'s critical path, and rwkv6's
# second step is ill-conditioned in exact arithmetic (bonus_u and the state
# start at 0: after one step the first token's WKV output has a variance
# per head of ~3e-8, far below its group norm's eps 1e-5; in f64 a 1e-7
# move of the weights lands 0.224 away in the step-2 grad norm, while step
# 1 stays within 6.1e-6: tools/gather_witness.py). Phase 24 (a) runs 2
# steps against phase 22's
SHARD_SMALL_STEPS = 1
SHARD_TOL = 1e-5           # (b): loss / grad norm relative; params of
                           # max(1, |p|)
# (b) runs AdamW at eps 1e-5: at 1e-8 its first step moves an element by
# lr * g / (|g| + eps), so a gradient element near 1e-7 whose f32 sums
# run in another order moves its parameter up to ~8% of lr apart
# (tests/test_torch_sharded_training.py)
SHARD_EPS = 1e-5
# (b) the families' per-leaf forms at their published widths, cut to 2
# layers (zamba2: a shared-block site every 2 Mamba2 layers; whisper: 2
# encoder and 2 decoder layers); their mechanism is FAM_MECHANISMS's
SHARD_FAMILIES = {"rwkv6-7b": {"num_layers": 2},
                  "zamba2-2.7b": {"num_layers": 2, "attn_every": 2},
                  "whisper-large-v3": {"num_layers": 2, "encoder_layers": 2}}


def _unsharded_steps(torch, model, opt_cfg, data_cfg, steps, device,
                     params=None):
    """The port's unsharded step on ``device`` from ``params`` (default:
    drawn from seed ``SEED`` there): (metrics a step, params)."""
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.trainer import batch_to, make_train_step
    if params is None:
        params = model.init(SEED, device=device)
    opt = init_adamw(params)
    step = make_train_step(model, opt_cfg)
    it = iter(TokenStream(model.cfg, data_cfg))
    hist = []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch_to(next(it), device))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params


def _params_err(got, want):
    """The largest |got - want| over the leaves, each over max(1, its
    largest magnitude), computed where ``want`` lies."""
    return max(float((a.detach().to(b.device) - b.detach()).abs().max())
               / max(1.0, float(b.detach().abs().max()))
               for a, b in zip(_leaves(got), _leaves(want)))


def _metrics_err(hist, ref, keys=("loss", "grad_norm")):
    return max(abs(h[k] - r[k]) / max(abs(r[k]), 1e-30)
               for h, r in zip(hist, ref) for k in keys)


def _shard_big(torch, mesh, cfg_mod, model_mod, pk, phase22):
    """Phase 24 (a): llama3.2-3b at full width, model 2."""
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import ShardedRun, train_sharded
    cfg = dataclasses.replace(cfg_mod.get_config("llama3.2-3b"),
                              dtype=torch.bfloat16)
    run = ShardedRun(cfg, SHARD_STEPS,
                     AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                 total_steps=TRAIN_STEPS),
                     DataConfig(batch_size=TRAIN_B, seq_len=TRAIN_T,
                                seed=SEED),
                     init=SEED, remat=True)
    t0 = time.perf_counter()
    res = mesh.run(train_sharded, run, layout=(1, 2))
    wall = time.perf_counter() - t0
    check([r["mechanism"] for r in res] == ["tensor"] * 2,
          f"phase 24 (a): mechanisms {[r['mechanism'] for r in res]}")
    want = {"contiguous_prefill": SHARD_STEPS * cfg.num_layers * 2}
    for r in res:
        launched = {k: n for k, n in r["launches"].items() if n}
        check(launched == want, f"phase 24 (a): rank {r['rank']} launched "
              f"{launched}, not {want}")
        shapes = r["shard_shapes"]
        check(shapes["layers/attn/wq"][-1] == 12 * cfg.head_dim
              and shapes["layers/attn/wk"][-1] == 4 * cfg.head_dim,
              f"phase 24 (a): rank {r['rank']} attention shard "
              f"{shapes['layers/attn/wq']} / {shapes['layers/attn/wk']}")
        check([{k: h[k] for k in ("loss", "grad_norm", "lr")}
               for h in r["history"]] ==
              [{k: h[k] for k in ("loss", "grad_norm", "lr")}
               for h in res[0]["history"]],
              "phase 24 (a): the ranks' metrics differ")
    hist = res[0]["history"]
    ref = [row["loss"] for row in phase22["steps"][:SHARD_STEPS]]
    gaps = [abs(h["loss"] - x) for h, x in zip(hist, ref)]
    ulps = [bf16_ulp(x) for x in ref]
    check(all(math.isfinite(h["loss"]) for h in hist)
          and all(g <= u for g, u in zip(gaps, ulps)),
          f"phase 24 (a): losses {[h['loss'] for h in hist]} vs phase 22's "
          f"{ref}: gaps {gaps} beyond one bf16 ulp {ulps}")
    for h in hist:
        h["tokens_per_s"] = TRAIN_B * TRAIN_T / h["ms"] * 1e3
        log(f"phase 24 (a) [{SHARD_NOTE}]: step {h['step']} loss "
            f"{h['loss']:.4f} (phase 22 {ref[h['step'] - 1]:.4f}) grad_norm "
            f"{h['grad_norm']:.4f} lr {h['lr']:.3e} {h['ms']:.1f} ms "
            f"({h['tokens_per_s']:.0f} tokens/s, host clock around a "
            f"synchronised step on rank 0)")
    ranks = []
    for r in res:
        calls, secs = r["collectives"]["model (1x2)"]
        ranks.append({"rank": r["rank"], "collectives": calls,
                      "collective_s": secs,
                      "peak_memory_gb": r.get("peak_memory_bytes", 0) / 1e9,
                      "launches": r["launches"]["contiguous_prefill"]})
        log(f"phase 24 (a) [{SHARD_NOTE}]: rank {r['rank']}: {calls} "
            f"collectives in {SHARD_STEPS} steps ({calls / SHARD_STEPS:.0f} "
            f"a step), {secs:.3f} s of host time "
            f"({secs / sum(h['ms'] for h in hist) * 1e3:.1%} of the steps' "
            f"wall), peak memory {ranks[-1]['peak_memory_gb']:.2f} GB, #6 "
            f"{r['launches']['contiguous_prefill']} launches at 12 / 4 "
            f"heads")
    log(f"phase 24 (a) [{SHARD_NOTE}]: {r['why']}; losses within one bf16 "
        f"ulp of phase 22's (gaps {[round(g, 4) for g in gaps]}); the job "
        f"took {wall:.1f} s with the weights' draw")
    return {"steps": hist, "ranks": ranks, "loss_gaps": gaps,
            "phase22_losses": ref, "job_s": wall, "why": res[0]["why"]}


def _shard_small(torch, mesh, cfg_mod, model_mod):
    """Phase 24 (b) and (c): 2 layers f32 sharded on the card == the
    unsharded step on the CPU on the same weights (drawn on the card from
    ``SEED`` by each rank and, for the CPU, once here and copied), all at
    their published widths: llama3.2-3b at (1, 2), smollm-360m at (2, 1)
    and the families' per-leaf forms (``SHARD_FAMILIES``) at (1, 2), for
    ``SHARD_SMALL_STEPS``, each rank's mechanism its plan's
    (``FAM_MECHANISMS``); the sharded run's checkpoint. The CPU steps run
    in a thread of their own while the card runs the sharded jobs (each
    reference needs only its weights, copied first)."""
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import ShardedRun, train_sharded
    opt = AdamWConfig(lr=TRAIN_LR, eps=SHARD_EPS, warmup_steps=1,
                      total_steps=SHARD_SMALL_STEPS)
    data = DataConfig(batch_size=2, seq_len=64, seed=SEED)
    llama, smollm = (dataclasses.replace(cfg_mod.get_config(a), num_layers=2)
                     for a in ("llama3.2-3b", PART_ARCH))
    cases = [(llama, (1, 2), "tensor"), (smollm, (2, 1), "replicated")]
    cases += [(dataclasses.replace(cfg_mod.get_config(a), **cut), (1, 2),
               FAM_MECHANISMS[a]) for a, cut in SHARD_FAMILIES.items()]
    cases = [(dataclasses.replace(c, dtype=torch.float32), layout, mech)
             for c, layout, mech in cases]
    ckpt_name = cases[-1][0].name          # (c): whisper's tree

    def reference(model, weights):
        t0 = time.perf_counter()
        hist, params = _unsharded_steps(torch, model, opt, data,
                                        SHARD_SMALL_STEPS, "cpu",
                                        params=weights)
        return hist, params, time.perf_counter() - t0
    out = {}
    refs = {}
    cpu_pool = ThreadPoolExecutor(max_workers=1)
    for cfg, _, _ in cases:
        model = model_mod.build_model(cfg)
        weights = _tree_to(model.init(SEED, device="cuda"),
                           torch.device("cpu"))
        torch.cuda.empty_cache()
        refs[cfg.name] = cpu_pool.submit(reference, model, weights)
    try:
        for cfg, layout, mech in cases:
            arch = cfg.name
            ckpt = ROOT / "build" / "phase24_checkpoint.npz"
            ckpt.parent.mkdir(exist_ok=True)
            first = arch == ckpt_name
            t0 = time.perf_counter()
            res = mesh.run(train_sharded, ShardedRun(
                cfg, SHARD_SMALL_STEPS, opt, data, init=SEED,
                gather=("params",), ckpt_path=str(ckpt) if first else ""),
                layout=layout)
            job_s = time.perf_counter() - t0
            ref_hist, ref_params, cpu_s = refs.pop(arch).result()
            check([r["mechanism"] for r in res] == [mech] * 2,
                  f"phase 24 (b) {arch} {layout}: {res[0]['mechanism']}")
            check(all(r["device"] == "cuda:0" for r in res),
                  f"phase 24 (b): ranks on {[r['device'] for r in res]}")
            check(res[1]["forbidden_modules"] == [],
                  f"phase 24 (b): the rank imported "
                  f"{res[1]['forbidden_modules']}")
            key = f"{arch} {layout[0]}x{layout[1]}"
            m_err = max(_metrics_err(r["history"], ref_hist) for r in res)
            p_err = _params_err(res[0]["params"], ref_params)
            check(m_err <= SHARD_TOL and p_err <= SHARD_TOL,
                  f"phase 24 (b) {key}: sharded on the card vs unsharded "
                  f"on the CPU: metrics {m_err:.3e}, params {p_err:.3e} "
                  f"(tolerance {SHARD_TOL})")
            launched = {k: n for k, n in res[1]["launches"].items() if n}
            out[key] = {
                "mechanism": mech, "job_s": job_s,
                "cpu_reference_s": cpu_s, "metrics_err": m_err,
                "params_err": p_err, "launches": launched,
                "losses": [h["loss"] for h in res[0]["history"]],
                "grad_norms": [h["grad_norm"] for h in res[0]["history"]]}
            log(f"phase 24 (b) {key} ({mech}, {SHARD_SMALL_STEPS} step f32 on "
                f"{res[0]['device']} x 2): loss "
                f"{[round(h['loss'], 6) for h in res[0]['history']]}, "
                f"grad norm "
                f"{[round(h['grad_norm'], 4) for h in res[0]['history']]} vs "
                f"unsharded on the CPU "
                f"{[round(h['loss'], 6) for h in ref_hist]}, "
                f"{[round(h['grad_norm'], 4) for h in ref_hist]}; metrics "
                f"within {m_err:.2e}, params within {p_err:.2e} "
                f"({SHARD_TOL}); launches on rank 1 {launched}; the job "
                f"{job_s:.1f} s, the CPU steps {cpu_s:.1f} s (beside the "
                f"jobs)")
            if first:
                # (c) the sharded run's checkpoint (the gathered whole tree)
                # against the gathered params bit for bit and the unsharded
                # run's f32 params (what its checkpoint holds) within (b)'s
                # tolerance
                back, step_no = load_checkpoint(str(ckpt), ref_params)
                same = all(bool(torch.equal(a, b)) for a, b in zip(
                    _leaves(back), _leaves(res[0]["params"])))
                c_err = _params_err(back, ref_params)
                nbytes = ckpt.stat().st_size
                ckpt.unlink()
                check(step_no == SHARD_SMALL_STEPS and same
                      and c_err <= SHARD_TOL,
                      f"phase 24 (c): checkpoint step {step_no}, bit-equal to "
                      f"the gathered params {same}, vs the unsharded run's "
                      f"{c_err:.3e}")
                out["checkpoint"] = {"arch": arch, "bytes": nbytes,
                                     "vs_unsharded": c_err}
                log(f"phase 24 (c): the {arch} (1, 2) run's checkpoint "
                    f"({nbytes} B) reads back bit for bit and within "
                    f"{c_err:.2e} of the unsharded run's ({SHARD_TOL})")
            del res, ref_params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        cpu_pool.shutdown(cancel_futures=True)
    return out


def phase_sharded_train(np, torch, cfg_mod, model_mod, pk, phase22):
    """Phase 24: sharded training on the card's one device, two ranks
    (this process and a ``launch.train_worker``) on ``cuda:0`` over gloo.
    (a) llama3.2-3b at full width, model 2 (tensor parallelism): phase
    22's setting for 2 steps; per step the loss, gradient norm, wall and
    tokens/s, per rank the collectives (count, host seconds) and the peak
    memory; the ranks' metrics equal, the losses within one bf16 ulp of
    phase 22's first 2; #6 == 2 x 28 x 2 launches on each rank at its 12
    / 4 heads and no other kernel; (b) 2 layers f32, llama3.2-3b at (1,
    2), smollm-360m at (2, 1), and rwkv6, zamba2 and whisper at (1, 2) on
    their plans (``FAM_MECHANISMS``: every split leaf stays split), all at
    their published widths: loss, grad norm and
    params after ``SHARD_SMALL_STEPS`` (1) == the unsharded step on the
    CPU within 1e-5; (c) whisper's sharded checkpoint == the unsharded
    run's."""
    from repro_torch.launch import mesh as mesh_mod
    _fresh_card(torch, "phase 24")
    t0 = time.perf_counter()
    mesh = mesh_mod.make_train_mesh(2, list(TP_DEVICES), "gloo")
    log(f"phase 24: a training group of 2 ranks on {list(TP_DEVICES)} over "
        f"{mesh.backend} (rank 1 started and joined in "
        f"{time.perf_counter() - t0:.1f} s); NCCL not measured: the machine "
        f"has {torch.cuda.device_count()} device")
    try:
        out = {"big": _shard_big(torch, mesh, cfg_mod, model_mod, pk,
                                 phase22)}
        gc.collect()
        torch.cuda.empty_cache()
        out["small"] = _shard_small(torch, mesh, cfg_mod, model_mod)
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 25: the dry run's llama3.2-3b programs on the card
# --------------------------------------------------------------------------
DRYRUN_ARCH = "llama3.2-3b"
# (shape, the global batch cut to what one card holds at (data 1, model 1))
DRYRUN_CUTS = (("prefill_32k", 1), ("decode_32k", 8), ("long_500k", 1),
               ("train_4k", 1))
DRYRUN_RUNS = 2            # timed by CUDA events after one warm run
# #6 at T 32768 is held on blocks of DRYRUN_ROWS query rows at the start,
# the middle and the end of the prompt, each to atol DRYRUN_TOL_STD x the
# block's own spread (its plain version's std) and rtol DRYRUN_RTOL (one
# bf16 step of the output, where the early rows' outputs are O(1))
DRYRUN_ROWS = 256
DRYRUN_TOL_STD = 0.05
DRYRUN_RTOL = 2.0 ** -7
DRYRUN_REL = 1e-9          # the card's FLOPs and bytes vs the trace's


def _prefill_rows_plain(torch, q, k, v, r0, n):
    """Query rows ``[r0, r0 + n)`` of the causal prefill in plain
    PyTorch, f32, over the keys ``< r0 + n`` they can see
    (``prefill_attention_plain``'s arithmetic on those rows; the whole
    plain version at T 32768 would hold 103 GB of f32 scores)."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    end = r0 + n
    qt = q[:, r0:end].reshape(B, n, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bthgd,bshd->bhgts", qt, k[:, :end].float()) \
        / math.sqrt(Dh)
    qpos = torch.arange(r0, end, device=q.device)[:, None]
    keep = torch.arange(end, device=q.device)[None] <= qpos
    s = torch.where(keep, s, float("-inf"))
    o = torch.einsum("bhgts,bshd->bthgd", torch.softmax(s, -1),
                     v[:, :end].float())
    return o.reshape(B, n, H, Dh).to(q.dtype)


def dryrun_kernels(torch, cfg_mod, dk, pk, flush):
    """Phase 3 at phase 25's shapes, llama3.2-3b's heads (24 / 8 / 128, G
    3), bf16, early in the process: #6 on one 32768-token prompt (held to
    its plain version on ``DRYRUN_ROWS`` query rows at its start, middle
    and end; the plain time given is the last block's; timed beside one
    causal SDPA call), #5 padded on 8 rows of 32768 keys (decode_32k's
    slab) and on one 8192-row ring (long_500k's window)."""
    import torch.nn.functional as F
    llama = cfg_mod.get_config(DRYRUN_ARCH)
    H, Hkv, Dh = llama.num_heads, llama.num_kv_heads, llama.head_dim
    T = 32768
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 25)
    q, k, v = (randn(torch, gen, (1, T, n, Dh), torch.bfloat16)
               for n in (H, Hkv, Hkv))
    got = pk.prefill_attention(q, k, v)
    err, tols = 0.0, []
    for r0 in (0, T // 2, T - DRYRUN_ROWS):
        block = got[:, r0:r0 + DRYRUN_ROWS].float()
        want = _prefill_rows_plain(torch, q, k, v, r0, DRYRUN_ROWS).float()
        tol = DRYRUN_TOL_STD * want.std().item()
        e = (block - want).abs().max().item()
        check(math.isfinite(e), "phase 3 (dry run) #6: non-finite output")
        torch.testing.assert_close(block, want, atol=tol, rtol=DRYRUN_RTOL,
                                   msg=lambda m, r0=r0: f"phase 3 (dry run) "
                                   f"#6 rows {r0}+{DRYRUN_ROWS}: {m}")
        err = max(err, e)
        tols.append({"rows": [r0, r0 + DRYRUN_ROWS], "max_abs_err": e,
                     "atol": tol, "rtol": DRYRUN_RTOL})
    del got, block, want
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    t = time_ms(torch, lambda: pk.prefill_attention(q, k, v), 5, flush,
                device=True)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 5, flush, device=True)
    plain = time_ms(torch, lambda: _prefill_rows_plain(
        torch, q, k, v, T - DRYRUN_ROWS, DRYRUN_ROWS), 2, flush)
    flops = 4.0 * (T * (T + 1) // 2) * H * Dh
    bound_ms, by = bound_of(T * (H + 2 * Hkv + H) * Dh * 2, flops)
    out = {"prefill": {
        "B": 1, "T": T, "max_abs_err": err, "held": tols, "ms": float(t),
        "device_ms": t.device, "plain_ms": plain,
        "plain_rows": DRYRUN_ROWS, "library_ms": float(lib),
        "library_device_ms": lib.device, "bound_ms": bound_ms,
        "bound_by": by, "tflops": flops / float(t) / 1e9}}
    log(f"phase 3 (dry run, {DRYRUN_ARCH}, G 3): #6 at B 1, T {T}, bf16: "
        f"{float(t):.4f} ms (device {t.device:.4f}, "
        f"{flops / float(t) / 1e9:.1f} TFLOP/s), library sdpa "
        f"{float(lib):.4f} ms (device {lib.device:.4f}), bound "
        f"{bound_ms:.4f} ms ({by}); held on query rows "
        + ", ".join(f"{h['rows'][0]}+{DRYRUN_ROWS} (max abs "
                    f"{h['max_abs_err']:.3e}, atol {h['atol']:.3e})"
                    for h in tols)
        + f"; the plain version on the last block {plain:.4f} ms")
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    out["decode"] = contiguous_kernels_at(
        torch, llama, dk, pk, flush, 8, 0, [T] * 8, list(range(8)), T,
        f"phase 3 (dry run, {DRYRUN_ARCH}, G 3, decode_32k)", device=True,
        prefill=False)["decode_padded"]
    W = 8192
    out["ring"] = contiguous_kernels_at(
        torch, llama, dk, pk, flush, 1, 0, [W], [0], W,
        f"phase 3 (dry run, {DRYRUN_ARCH}, G 3, long_500k's ring)",
        device=True, prefill=False)["decode_padded"]
    return out


def _finite(torch, tree):
    """Every float leaf finite, read through one f32 sum a leaf (a NaN or
    an inf anywhere makes it non-finite) so that a 15 GB cache leaf needs
    no leaf-sized temporaries."""
    from repro_torch.core.migration import tree_leaves
    leaves = (tree_leaves(tree) if not isinstance(tree, torch.Tensor)
              else [tree])
    return all(bool(torch.isfinite(a.sum(dtype=torch.float32)))
               for a in leaves if a.is_floating_point())


def _busy_ms(torch, fn):
    """The device time of the kernels one call of ``fn`` launches, from
    ``torch.profiler`` (the profiler's own host cost is not in it)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        total += (e.cuda_time_total if t is None else t) or 0.0
    return total / 1e3


def phase_dryrun(torch):
    """Phase 25: the dry run's llama3.2-3b programs (``launch.cases.
    build_case``) at the layout one card holds, (data 1, model 1), each
    case's global batch cut to ``DRYRUN_CUTS``: the program traced on the
    CPU under fake meta tensors (``launch.dryrun.trace_case``: FLOPs,
    bytes, peak, the roofline priced on ``kernels.cost.H100``), then run
    for real on the card (seeded weights and inputs): one warm run under
    ``FlopCounterMode`` and ``dryrun.Traffic``, ``DRYRUN_RUNS`` timed by
    CUDA events, one under ``torch.profiler`` for the device's busy time.
    Checks: train_4k's reckoned memory (its arguments plus the trace's
    peak) fits the card's free memory; finite outputs; #6 launched 28
    times a prefill (56 a train step: remat) and #5 padded 28 times a
    decode, no other kernel; the card's counted FLOPs and bytes equal the
    trace's within ``DRYRUN_REL``: the trace is the card's program, so
    the roofline is that program's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.api import launch_counts as api_counts
    from repro_torch.kernels.api import zero_launch_counts
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    from repro_torch.launch.mesh import Layout
    _fresh_card(torch, "phase 25")
    one = Layout({"data": 1, "model": 1})
    out = {}
    for shape, B in DRYRUN_CUTS:
        t0 = time.perf_counter()
        sp = cases_mod.SHAPES[shape]
        kind = cases_mod.shape_kind(shape)
        fake = cases_mod.build_case(DRYRUN_ARCH, shape, one, batch=B)
        traced = dryrun_mod.trace_case(fake)
        rl = dryrun_mod.roofline_of(fake, traced, "1x1", one)
        cfg, T = fake.cfg, fake.seq
        S = min(T, cfg.sliding_window) if cfg.sliding_window else T
        trace_s = time.perf_counter() - t0
        free = torch.cuda.mem_get_info()[0]
        need = fake.arg_bytes + traced["temp_bytes"]
        log(f"phase 25 {shape}: global batch {sp['global_batch']} cut to "
            f"{B} (one card, data 1 x model 1), T {T}"
            + (f", a ring of {S} rows" if S != T else "")
            + f"; the rank holds {fake.arg_bytes / 1e9:.2f} GB, its traced "
            f"peak above that {traced['temp_bytes'] / 1e9:.2f} GB "
            f"(reckoned {need / 1e9:.2f} GB of {free / 1e9:.2f} GB free); "
            f"traced on the CPU in {trace_s:.1f} s")
        if kind == "train":
            check(need <= free, f"phase 25 {shape}: reckoned "
                  f"{need / 1e9:.2f} GB, over the card's "
                  f"{free / 1e9:.2f} GB free")
        del fake
        torch.cuda.reset_peak_memory_stats()
        case = cases_mod.build_case(DRYRUN_ARCH, shape, one, batch=B,
                                    device="cuda", seed=SEED)
        torch.cuda.synchronize()
        zero_launch_counts()
        dryrun_mod.warm_caches(case)
        traffic = dryrun_mod.Traffic(dryrun_mod.storages(case.args))
        with FlopCounterMode(display=False) as fc, traffic:
            res = case.fn(*case.args)
        torch.cuda.synchronize()
        check(_finite(torch, res[2] if kind == "train" else res),
              f"phase 25 {shape}: non-finite outputs")
        loss = float(res[2]["loss"]) if kind == "train" else None
        del res
        starts = [torch.cuda.Event(enable_timing=True)
                  for _ in range(DRYRUN_RUNS)]
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(DRYRUN_RUNS)]
        for s_ev, e_ev in zip(starts, ends):
            s_ev.record()
            case.fn(*case.args)
            e_ev.record()
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / \
            DRYRUN_RUNS
        busy = _busy_ms(torch, lambda: case.fn(*case.args))
        peak = torch.cuda.max_memory_allocated()
        counts = {k: n for k, n in api_counts().items() if n}
        runs = 2 + DRYRUN_RUNS
        key = ("contiguous_decode_padded" if kind == "decode"
               else "contiguous_prefill")
        per = cfg.num_layers * (2 if kind == "train" else 1)
        check(counts == {key: per * runs},
              f"phase 25 {shape}: launches {counts}, want {key} == "
              f"{per} x {runs} runs and nothing else")
        card = {"flops": float(fc.get_total_flops()),
                "bytes": traffic.bytes}
        rel = {k: abs(card[k] - traced[k]) / traced[k] for k in card}
        check(max(rel.values()) <= DRYRUN_REL,
              f"phase 25 {shape}: the card's program counted {card}, the "
              f"trace {traced['flops']:.6e} FLOPs, {traced['bytes']:.6e} "
              f"bytes (rel {rel})")
        bound_s = max(rl.t_compute, rl.t_memory, rl.t_collective)
        rec = {"batch": B, "global_batch": sp["global_batch"], "seq": T,
               "slab_rows": S, "ms": ms, "t_compute": rl.t_compute,
               "t_memory": rl.t_memory, "t_collective": rl.t_collective,
               "dominant": rl.dominant,
               "roofline_share": bound_s / (ms / 1e3),
               "busy_ms": busy, "busy_share": busy / ms,
               "flops_analytic": rl.flops_per_chip,
               "flops_traced": traced["flops"], "flops_card": card["flops"],
               "bytes_traced": traced["bytes"], "bytes_card": card["bytes"],
               "card_vs_trace_rel": rel, "traced_ops": traced["ops"],
               "arg_bytes": case.arg_bytes, "temp_bytes": traced["temp_bytes"],
               "peak_memory_bytes": peak, "launches": counts,
               "trace_s": trace_s, "loss": loss}
        out[shape] = rec
        log(f"phase 25 {shape}: {ms:.3f} ms a run (events, {DRYRUN_RUNS} "
            f"runs after a warm one), device busy {busy:.3f} ms of it "
            f"({rec['busy_share']:.3f}, profiler); roofline t_compute "
            f"{rl.t_compute * 1e3:.3f} ms, t_memory {rl.t_memory * 1e3:.3f} "
            f"ms ({traced['bytes'] / 1e9:.2f} GB), dominant {rl.dominant}, "
            f"share of the measured time {rec['roofline_share']:.3f}; FLOPs "
            f"analytic {rl.flops_per_chip:.6e}, traced {traced['flops']:.6e} "
            f"== the card's {card['flops']:.6e}, bytes traced == the card's "
            f"(rel {max(rel.values()):.1e}); {traced['ops']} ops; {key} "
            f"{counts[key]} launches; peak {peak / 1e9:.2f} GB"
            + (f"; loss {loss:.4f}" if loss is not None else ""))
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 26: the per-leaf partition of a rank's program on the card
# --------------------------------------------------------------------------
PART_ARCH = "smollm-360m"     # H 15 / Hkv 5 divide no model axis > 1
# (a): (shape, global batch, sequence) at (data 1, model 2), bf16: a
# prefill of 2 x 2048 (#6 on the rank's (row, head) pairs), a decode of 8
# rows against 4096 (the cache split on its head dim: no #5), a train step
# of 2 x 1024 (remat)
PART_CASES = (("prefill_32k", 2, 2048), ("decode_32k", 8, 4096),
              ("train_4k", 2, 1024))
PART_RUNS = 1              # timed by CUDA events after one warm run
# (b): 2 layers f32 at the same widths: B 2 prompts of 64 tokens into a
# cache of 80 rows, one decode step, one train step, held to the CPU
PART_SMALL_B, PART_SMALL_T, PART_SMALL_CACHE = 2, 64, 80
PART_TOL = 1e-5
PART_PAIRS_T = 2048        # phase 3's row: #6 on a rank's 15 pairs


def part_collectives(L, kind):
    """A rank's collectives on the model group in one run of smollm's
    per-leaf program (every weight block split, the core over (row, head)
    pairs, the decode cache on its head dim), counted from the code of
    ``models/``: a forward layer makes the q / k / v all-gather, the
    pairs' all-gather (a decode: the scores' all-reduce and the head
    dim's all-gather), ``wo``'s all-reduce and the FFN's; the embedding's
    all-reduce and the logits' all-gather close it. A train step's
    backward adds four ``copy_to_tp`` all-reduces a layer (x into the q /
    k / v columns, q / k / v into the core, o into ``wo``'s rows, x into
    the FFN), remat's second forward stops before the FFN's all-reduce
    (nothing saves its output); its loss keeps the logits split on the
    vocabulary (the rows' maxima gathered, the sums of exponentials and
    the gold logits all-reduced, the logits' copy in backward), and the
    global norm's all-reduce ends it."""
    if kind == "prefill":
        return 4 * L + 2
    if kind == "decode":
        return 5 * L + 2
    return (4 + 3 + 4) * L + 1 + 3 + 1 + 1


def _part_trace(arch, shape, B, T, layers=None, dm=(1, 2),
                optimized=False):
    """Rank 0's program of one ``PART_CASES`` case (``arch`` smollm),
    ``EP_CASES`` case (qwen3-moe cut to ``layers``, :func:`ep_config`) or
    ``FAM_CASES`` case (a family cut by ``FAM_CUTS``, :func:`fam_config`)
    at (data, model) ``dm`` (default (1, 2); ``optimized``: with the
    levers, phase 29's ``OPT_CASES``) traced on the CPU under fake meta
    tensors (``launch.dryrun``), in a process of its own
    (:func:`start_part_traces`): its plan, counted FLOPs, bytes, peak,
    collectives (the bytes each all-gather returns, and the shape of any
    whose operand is a weight leaf) and roofline terms, and the trace's
    seconds."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    from repro_torch.launch.mesh import Layout
    t0 = time.perf_counter()
    layout = Layout({"data": dm[0], "model": dm[1]})
    cfg = (fam_config(cases_mod, arch, shape) if arch in FAM_CUTS
           else None if layers is None else ep_config(cases_mod, layers))
    fake = cases_mod.build_case(arch, shape, layout, optimized, batch=B,
                                seq=T, cfg=cfg)
    traced = dryrun_mod.trace_case(fake)
    rl = dryrun_mod.roofline_of(fake, traced, f"{dm[0]}x{dm[1]}", layout)
    return {"mechanism": fake.plan.mechanism,
            "blocks": dict(fake.plan.blocks), "axes": dict(fake.plan.axes),
            "layers": fake.cfg.num_layers, "flops": traced["flops"],
            "bytes": traced["bytes"], "temp_bytes": traced["temp_bytes"],
            "collectives": len(traced["records"]),
            "gathered_bytes": [r["result_bytes"] for r in traced["records"]
                               if r["op"] == "all-gather"],
            "weight_gathers": traced["weight_gathers"],
            "flops_analytic": rl.flops_per_chip, "t_compute": rl.t_compute,
            "t_memory": rl.t_memory, "t_collective": rl.t_collective,
            "dominant": rl.dominant,
            "collective_bytes": rl.collective_bytes_per_chip,
            "levers": list(fake.levers.taken()) if fake.levers else [],
            "trace_s": time.perf_counter() - t0}


def _cpu_only():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def start_part_traces():
    """Phases 26's, 27's and 28's (1, 2) traces (:func:`_part_trace`; CPU
    only, smollm's train step ~40 s) in two spawned processes that see no
    card, and phase 29's in a third, all started before the build so that
    they run beside it (in one queue phase 29's held phases 26-28 up, or
    were not ready by phase 29): (the pools, {key: its pending result},
    the key ``(arch, shape)`` for phases 26-28, ``(arch, shape, (data,
    model), optimized)`` for phase 29), the train steps first."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    pool, levers = ctx.Pool(2, _cpu_only), ctx.Pool(1, _cpu_only)
    jobs = ([(PART_ARCH, shape, B, T, None) for shape, B, T in PART_CASES]
            + [(MOE_ARCH, shape, B, T, EP_LAYERS)
               for shape, B, T in EP_CASES]
            + [(arch, shape, B, T, None) for arch in FAM_CUTS
               for shape, B, T in fam_cases(arch)])
    opt_jobs = [((arch, shape, dm, opt), (arch, shape, B, T, layers, dm,
                                          opt))
                for arch, layers, dm, cases in OPT_CASES
                for shape, B, T in cases for opt in (False, True)
                if opt or (arch, shape) in OPT_BASELINE]
    traces = {job[:2]: pool.apply_async(_part_trace, job)
              for job in sorted(jobs, key=lambda j: j[1] != "train_4k")}
    traces.update({key: levers.apply_async(_part_trace, job)
                   for key, job in sorted(opt_jobs,
                                          key=lambda kj: kj[1][1]
                                          != "train_4k")})
    return (pool, levers), traces


def _part_small(np, torch, cfg_mod, model_mod, mesh):
    """Phase 26 (b): 2 layers f32 of smollm at (data 1, model 2) on the
    card against the unsharded port on the CPU, the same weights (drawn
    on the card from ``SEED``): the prefill's logits and each rank's
    cache slice, a decode step's, and a train step's loss, grad norm and
    params after it."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import ShardedRun, train_sharded
    cfg = dataclasses.replace(cfg_mod.get_config(PART_ARCH), num_layers=2,
                              dtype=torch.float32)
    model = model_mod.build_model(cfg)
    weights = _tree_to(model.init(SEED, device="cuda"), torch.device("cpu"))
    torch.cuda.empty_cache()
    B, T, C = PART_SMALL_B, PART_SMALL_T, PART_SMALL_CACHE
    r = np.random.default_rng(SEED + 26)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T),
                                         dtype=np.int32))
    token = torch.from_numpy(r.integers(0, cfg.vocab_size, (B,),
                                        dtype=np.int32))
    pos = torch.full((B,), T, dtype=torch.int32)
    got = mesh.run(cases_mod.rank_prefill_decode, cfg, SEED, tokens, C,
                   token, pos, layout=(1, 2))
    with torch.no_grad():
        logits, cache = model.prefill(weights, tokens, cache_len=C)
        first = type(cache)(*(a.clone() for a in cache))
        dec, cache = model.decode_step(weights, cache, token, pos)

    def err(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    d = cfg.head_dim // 2
    errs = {}
    for g in got:
        cols = slice(g["rank"] * d, (g["rank"] + 1) * d)
        check(g["mechanism"] == "per-leaf" and tuple(g["cache"].k.shape)
              == (2, B, C, cfg.num_kv_heads, d),
              f"phase 26 (b): rank {g['rank']} {g['mechanism']}, cache "
              f"slice {tuple(g['cache'].k.shape)}")
        e = {"logits": err(g["logits"], logits),
             "decode_logits": err(g["decode_logits"], dec),
             "cache": max(err(a, b[..., cols])
                          for a, b in zip(g["cache"], first)),
             "decode_cache": max(err(a, b[..., cols])
                                 for a, b in zip(g["decode_cache"], cache))}
        errs[g["rank"]] = e
        check(max(e.values()) <= PART_TOL, f"phase 26 (b): rank "
              f"{g['rank']} on the card vs the unsharded CPU model: {e} "
              f"(tolerance {PART_TOL})")
    opt = AdamWConfig(lr=TRAIN_LR, eps=SHARD_EPS, warmup_steps=1,
                      total_steps=1)
    data = DataConfig(batch_size=B, seq_len=T, seed=SEED)
    res = mesh.run(train_sharded, ShardedRun(cfg, 1, opt, data, init=SEED,
                                             gather=("params",)),
                   layout=(1, 2))
    ref_hist, ref_params = _unsharded_steps(torch, model, opt, data, 1,
                                            "cpu", params=weights)
    m_err = max(_metrics_err(g["history"], ref_hist) for g in res)
    p_err = _params_err(res[0]["params"], ref_params)
    check(all(g["mechanism"] == "per-leaf" for g in res)
          and m_err <= PART_TOL and p_err <= PART_TOL,
          f"phase 26 (b): the train step on the card vs the CPU: "
          f"{[g['mechanism'] for g in res]}, metrics {m_err:.3e}, params "
          f"{p_err:.3e} (tolerance {PART_TOL})")
    log(f"phase 26 (b) ({PART_ARCH}, 2 layers f32, (data 1, model 2) on "
        f"the card vs unsharded on the CPU): prefill logits / cache, "
        f"decode logits / cache within "
        + "; ".join(f"rank {k} " + " / ".join(f"{v:.2e}" for v in e.values())
                    for k, e in errs.items())
        + f"; a train step's loss {res[0]['history'][0]['loss']:.6f} (CPU "
        f"{ref_hist[0]['loss']:.6f}), metrics within {m_err:.2e}, params "
        f"within {p_err:.2e} (tolerance {PART_TOL})")
    return {"outputs": errs, "train_metrics_err": m_err,
            "train_params_err": p_err}


def train_group(torch, label):
    """Two training ranks on the card over gloo (this process and one
    ``launch.train_worker``), shared by phases 26 and 27."""
    from repro_torch.launch import mesh as mesh_mod
    _fresh_card(torch, label)
    t0 = time.perf_counter()
    mesh = mesh_mod.make_train_mesh(2, list(TP_DEVICES), "gloo")
    log(f"{label}: a training group of 2 ranks on {list(TP_DEVICES)} over "
        f"{mesh.backend} (rank 1 joined in {time.perf_counter() - t0:.1f} "
        f"s); the (1, 2) traces ran beside the build")
    return mesh


def phase_partition(np, torch, cfg_mod, model_mod, mesh, traces):
    """Phase 26: smollm-360m at full width (32 layers, d 960, H 15 / Hkv
    5, Dh 64) at (data 1, model 2) on two ranks sharing the card over
    gloo, where its heads divide nothing and every split dim divides: the
    per-leaf plan. (a) bf16, seeded weights, ``PART_CASES``: each case's
    program on each rank (``launch.dryrun.run_rank``: one warm run under
    ``FlopCounterMode`` and ``Traffic``, ``PART_RUNS`` runs timed by CUDA
    events), its ms, collectives (count, host s) and peak memory a rank
    (two ranks on one card; not a speedup); the collectives those of
    :func:`part_collectives` and of the (1, 2) trace; #6 == layers a
    prefill run, 2 x layers a train step, nothing in a decode; rank 0's
    counted FLOPs and bytes equal its trace's within ``DRYRUN_REL``
    (``traces``: :func:`start_part_traces`'s pending results). (b) 2
    layers f32 (:func:`_part_small`). ``mesh``: :func:`train_group`'s."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    out = {}
    # the card's runs first, (b) next, and only then the traces they
    # are held to, which by then have had the card's time to finish
    ran = {shape: mesh.run(dryrun_mod.run_rank, PART_ARCH, shape,
                           batch=B, seq=T, seed=SEED, runs=PART_RUNS,
                           layout=(1, 2))
           for shape, B, T in PART_CASES}
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = _part_small(np, torch, cfg_mod, model_mod, mesh)
    for shape, B, T in PART_CASES:
        kind = cases_mod.shape_kind(shape)
        res = ran.pop(shape)
        traced = traces[PART_ARCH, shape].get()
        L = traced["layers"]
        check(traced["mechanism"] == "per-leaf"
              and set(traced["blocks"].values()) == {"split"}
              and traced["axes"] == {"core": "pairs",
                                     "cache": "head_dim"},
              f"phase 26 {shape}: plan {traced['mechanism']} "
              f"{traced['blocks']} {traced['axes']}")
        want = part_collectives(L, kind)
        check(traced["collectives"] == want,
              f"phase 26 {shape}: the trace records "
              f"{traced['collectives']} collectives, the code {want}")
        card = res[0]["warm"]
        rel = {k: abs(card[k] - traced[k]) / traced[k]
               for k in ("flops", "bytes")}
        check(max(rel.values()) <= DRYRUN_REL,
              f"phase 26 {shape}: rank 0 counted {card['flops']:.6e} "
              f"FLOPs, {card['bytes']:.6e} bytes; its trace "
              f"{traced['flops']:.6e}, {traced['bytes']:.6e} (rel {rel})")
        per = {"prefill": {"contiguous_prefill": L},
               "train": {"contiguous_prefill": 2 * L},
               "decode": {}}[kind]
        ranks = []
        for r in res:
            warm = {k: n for k, n in r["warm"]["launches"].items() if n}
            timed = {k: n for k, n in r["launches"].items() if n}
            check(r["warm"]["finite"], f"phase 26 {shape}: rank "
                  f"{r['rank']}: non-finite outputs")
            check(warm == per and timed == {
                k: n * PART_RUNS for k, n in per.items()},
                  f"phase 26 {shape}: rank {r['rank']} launched {warm} "
                  f"warm, {timed} in {PART_RUNS} runs; want {per} a run")
            calls, secs = r["collectives"]["model"]
            check(r["warm"]["collectives"] == {"model": want}
                  and calls == want * PART_RUNS,
                  f"phase 26 {shape}: rank {r['rank']}: "
                  f"{r['warm']['collectives']} warm, {calls} in "
                  f"{PART_RUNS} runs; the code makes {want} a run")
            ms = sum(r["ms"]) / len(r["ms"])
            a_run = {k: n // PART_RUNS for k, n in timed.items()}
            ranks.append({"rank": r["rank"], "ms": r["ms"],
                          "ms_mean": ms, "collectives": want,
                          "collective_s": secs / PART_RUNS,
                          "peak_memory_gb":
                          r.get("peak_memory_bytes", 0) / 1e9,
                          "launches": {k: n + warm.get(k, 0)
                                       for k, n in timed.items()}})
            log(f"phase 26 (a) {shape} [{SHARD_NOTE}]: rank "
                f"{r['rank']} {ms:.2f} ms a run (events, timed after a "
                f"warm run: {', '.join(f'{x:.2f}' for x in r['ms'])}), {want} "
                f"collectives a run on the model group, "
                f"{secs / PART_RUNS * 1e3:.1f} ms of host time, peak "
                f"memory {ranks[-1]['peak_memory_gb']:.2f} GB, "
                f"launches a run {a_run or 'none'}")
        out[shape] = {
            "batch": B, "seq": T, "rank_rows": res[0]["rows"],
            "ranks": ranks, "flops_traced": traced["flops"],
            "flops_card": card["flops"], "bytes_traced": traced["bytes"],
            "bytes_card": card["bytes"], "card_vs_trace_rel": rel,
            "flops_analytic": traced["flops_analytic"],
            "t_compute": traced["t_compute"],
            "t_memory": traced["t_memory"],
            "t_collective": traced["t_collective"],
            "dominant": traced["dominant"],
            "collective_bytes": traced["collective_bytes"],
            "arg_bytes": res[0]["arg_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "trace_s": traced["trace_s"], "note": SHARD_NOTE}
        log(f"phase 26 (a) {shape}: B {B} x T {T}, {res[0]['rows']} "
            f"rows a rank; rank 0 counted {card['flops']:.6e} FLOPs "
            f"(analytic share {traced['flops_analytic']:.6e}) and "
            f"{card['bytes'] / 1e9:.3f} GB == its (1, 2) trace (rel "
            f"{max(rel.values()):.1e}); {want} collectives "
            f"({traced['collective_bytes'] / 1e9:.4f} GB on the wire) "
            f"== the trace's and the code's; traced in "
            f"{traced['trace_s']:.1f} s beside the build")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 27: the expert-split MoE of a rank's program on the card
# --------------------------------------------------------------------------
# (a): qwen3-moe-30b-a3b at full width (the repo's config: d 2048, H 32 /
# Hkv 4 / Dh 64, E 128, K 8, d_ff 768, vocab 151936), moe_impl "gshard",
# cut to 4 layers (3.10 B parameters; 48 layers' experts alone are 58 GB
# of bf16), bf16, at (data 1, model 2): every dim divides, so tensor
# parallelism with 64 experts a rank. (shape, global batch, sequence):
EP_LAYERS = 4
EP_CASES = (("prefill_32k", 2, 2048), ("decode_32k", 8, 4096),
            ("train_4k", 2, 1024))
EP_RUNS = 1                # timed by CUDA events after one warm run
# (b): 2 layers f32 at the same widths: B 2 prompts of 64 tokens into a
# cache of 80 rows, one decode step, one train step, held to the
# unsharded port's one-hot moe_gshard on the card; at cf 1.25 a group of
# 64 tokens fills C = 5 slots an expert (512 pairs over 128 experts), so
# the seeded routing drops pairs
EP_SMALL_LAYERS = 2
EP_SMALL_B, EP_SMALL_T, EP_SMALL_CACHE = 2, 64, 80
EP_TOL = 1e-5


def ep_config(cases_mod, layers, dtype=None):
    """Phase 27's qwen3-moe: the dry run's config (``moe_impl`` "gshard",
    bf16) cut to ``layers``, in ``dtype`` when given."""
    cfg = dataclasses.replace(cases_mod.adjusted_config(MOE_ARCH,
                                                        "train_4k"),
                              num_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def ep_collectives(L, kind):
    """A rank's collectives on the model group in one run of qwen3-moe's
    program at model 2 (tensor parallelism: whole heads a rank, the
    experts split), counted from the code of ``models/``: a forward
    layer makes ``wo``'s all-reduce and the MoE's one f32 all-reduce of
    its combined rows; the embedding's all-reduce and the logits'
    all-gather close it. A train step's backward adds three
    ``copy_to_tp`` all-reduces a layer (x into the q / k / v columns;
    the MoE's rows and its combine weights), remat's second forward
    stops before the MoE's all-reduce (nothing saves its output); its
    loss keeps the logits split on the vocabulary (the rows' maxima
    gathered, the sums of exponentials and the gold logits all-reduced,
    the logits' copy in backward), and the global norm's all-reduce ends
    it."""
    if kind == "train":
        return (2 + 1 + 3) * L + 1 + 3 + 1 + 1
    return 2 * L + 2


def _route_recorder(mlp_mod):
    """Wrap ``mlp._route`` in this process so that each call's top-K
    expert ids are kept (``seen``); ``restore()`` puts it back."""
    real, seen = mlp_mod._route, []

    def route(*a, **k):
        out = real(*a, **k)
        seen.append(out[2].detach())
        return out

    def restore():
        mlp_mod._route = real
    mlp_mod._route = route
    return seen, restore


def _dropped(mlp_mod, cfg, seen, G, S):
    """(token, k) pairs past their expert's capacity over the recorded
    routings of [G, S] tokens at the default capacity factor."""
    K, E = cfg.experts_per_token, cfg.num_experts
    C = max(1, math.ceil(S * K / E * 1.25))
    return sum(int((mlp_mod.gshard_slots(t.reshape(G, S, K), E) >= C)
                   .sum()) for t in seen)


def _ep_small(np, torch, cfg_mod, model_mod, mesh):
    """Phase 27 (b): 2 layers f32 of qwen3-moe at (data 1, model 2) on
    the card against the unsharded port (its one-hot ``moe_gshard``) on
    the card, the same weights (drawn on the card from ``SEED``): the
    prefill's logits and each rank's cache slice (its kv heads), a decode
    step's, and a train step's loss, grad norm and params after it; the
    dropped (token, k) pairs of the prefill and the train step, counted
    from the unsharded run's routing, must be > 0."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import ShardedRun, train_sharded
    cfg = ep_config(cases_mod, EP_SMALL_LAYERS, torch.float32)
    model = model_mod.build_model(cfg)
    B, T, C = EP_SMALL_B, EP_SMALL_T, EP_SMALL_CACHE
    r = np.random.default_rng(SEED + 27)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T),
                                         dtype=np.int32))
    token = torch.from_numpy(r.integers(0, cfg.vocab_size, (B,),
                                        dtype=np.int32))
    pos = torch.full((B,), T, dtype=torch.int32)
    t0 = time.perf_counter()
    got = mesh.run(cases_mod.rank_prefill_decode, cfg, SEED, tokens, C,
                   token, pos, layout=(1, 2))
    opt = AdamWConfig(lr=TRAIN_LR, eps=SHARD_EPS, warmup_steps=1,
                      total_steps=1)
    data = DataConfig(batch_size=B, seq_len=T, seed=SEED)
    res = mesh.run(train_sharded, ShardedRun(cfg, 1, opt, data, init=SEED,
                                             gather=("params",)),
                   layout=(1, 2))
    secs = {"ranks": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    # the unsharded port on the card: the prefill and the decode step
    # first (the train step updates the weights in place)
    weights = model.init(SEED, device="cuda")
    seen, restore = _route_recorder(mlp_mod)
    try:
        with torch.no_grad():
            logits, cache = model.prefill(weights, tokens.cuda(),
                                          cache_len=C)
            first = type(cache)(*(a.clone() for a in cache))
            dec, cache = model.decode_step(weights, cache, token.cuda(),
                                           pos.cuda())
        drops = {"prefill": _dropped(mlp_mod, cfg, seen[:cfg.num_layers],
                                     B, T)}
        seen.clear()
        ref_hist, ref_params = _unsharded_steps(torch, model, opt, data, 1,
                                                "cuda", params=weights)
        drops["train"] = _dropped(mlp_mod, cfg, seen, B, T)
    finally:
        restore()
    secs["unsharded"] = time.perf_counter() - t0 - secs["ranks"]
    check(min(drops.values()) > 0, f"phase 27 (b): dropped (token, k) "
          f"pairs {drops}: the seeded routing must drop some")

    def err(a, b):
        b = b.detach().cpu()
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    h = cfg.num_kv_heads // 2
    errs = {}
    for g in got:
        heads = slice(g["rank"] * h, (g["rank"] + 1) * h)
        check(g["mechanism"] == "tensor" and tuple(g["cache"].k.shape)
              == (cfg.num_layers, B, C, h, cfg.head_dim),
              f"phase 27 (b): rank {g['rank']} {g['mechanism']}, cache "
              f"slice {tuple(g['cache'].k.shape)}")
        e = {"logits": err(g["logits"], logits),
             "decode_logits": err(g["decode_logits"], dec),
             "cache": max(err(a, b[..., heads, :])
                          for a, b in zip(g["cache"], first)),
             "decode_cache": max(err(a, b[..., heads, :])
                                 for a, b in zip(g["decode_cache"], cache))}
        errs[g["rank"]] = e
        check(max(e.values()) <= EP_TOL, f"phase 27 (b): rank {g['rank']} "
              f"vs the unsharded model on the card: {e} (tolerance "
              f"{EP_TOL})")
    del logits, cache, first, dec, weights
    m_err = max(_metrics_err(g["history"], ref_hist) for g in res)
    p_err = _params_err(res[0]["params"], ref_params)
    secs["compare"] = time.perf_counter() - t0 - sum(secs.values())
    check(all(g["mechanism"] == "tensor" and g["plan"]["experts"] == "split"
              for g in res) and m_err <= EP_TOL and p_err <= EP_TOL,
          f"phase 27 (b): the train step vs the unsharded one: "
          f"{[(g['mechanism'], g['plan']) for g in res]}, metrics "
          f"{m_err:.3e}, params {p_err:.3e} (tolerance {EP_TOL})")
    log(f"phase 27 (b) ({MOE_ARCH}, {cfg.num_layers} layers f32, (data 1, "
        f"model 2) vs unsharded, both on the card): prefill logits / "
        f"cache, decode logits / cache within "
        + "; ".join(f"rank {k} " + " / ".join(f"{v:.2e}" for v in e.values())
                    for k, e in errs.items())
        + f"; a train step's loss {res[0]['history'][0]['loss']:.6f} "
        f"(unsharded {ref_hist[0]['loss']:.6f}), metrics within "
        f"{m_err:.2e}, params within {p_err:.2e} (tolerance {EP_TOL}); "
        f"dropped (token, k) pairs: prefill {drops['prefill']} of "
        f"{cfg.num_layers * B * T * cfg.experts_per_token}, train step "
        f"{drops['train']}; the ranks' jobs {secs['ranks']:.1f} s, the "
        f"unsharded runs {secs['unsharded']:.1f} s, the comparisons "
        f"{secs['compare']:.1f} s")
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    return {"outputs": errs, "train_metrics_err": m_err,
            "train_params_err": p_err, "dropped_pairs": drops,
            "seconds": secs}


def phase_expert_parallel(np, torch, cfg_mod, model_mod, mesh, traces):
    """Phase 27: the expert-split MoE. qwen3-moe-30b-a3b at full width
    (the repo's config), ``moe_impl`` "gshard", at (data 1, model 2) on
    two ranks sharing the card over gloo (phase 26's group): tensor
    parallelism, each rank running its 64 experts on its kept (token, k)
    pairs. (a) bf16, ``EP_LAYERS`` layers, seeded weights, ``EP_CASES``:
    each case's program on each rank (``launch.dryrun.run_rank`` with
    ``cfg=``: one warm run under ``FlopCounterMode`` and ``Traffic``,
    ``EP_RUNS`` runs timed by CUDA events), its ms, collectives (count,
    host s), peak memory and launches a rank (two ranks on one card; not
    a speedup); the collectives those of :func:`ep_collectives` and of
    the (1, 2) trace, none an all-gather of an expert leaf; #6 == layers
    a prefill run, 2 x layers a train step, #5 == layers a decode run (on
    the rank's 2 kv heads); rank 0's counted FLOPs and bytes equal its
    trace's within ``DRYRUN_REL``. (b) 2 layers f32
    (:func:`_ep_small`)."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    _fresh_card(torch, "phase 27")
    cfg = ep_config(cases_mod, EP_LAYERS)
    ran = {shape: mesh.run(dryrun_mod.run_rank, MOE_ARCH, shape, batch=B,
                           seq=T, seed=SEED, runs=EP_RUNS, cfg=cfg,
                           layout=(1, 2))
           for shape, B, T in EP_CASES}
    gc.collect()
    torch.cuda.empty_cache()
    out = {"small": _ep_small(np, torch, cfg_mod, model_mod, mesh)}
    # a layer's expert leaf, a rank's share and whole (bf16)
    leaf = cfg.num_experts * cfg.d_model * cfg.d_ff * 2
    for shape, B, T in EP_CASES:
        kind = cases_mod.shape_kind(shape)
        res = ran.pop(shape)
        traced = traces[MOE_ARCH, shape].get()
        L = traced["layers"]
        check(traced["mechanism"] == "tensor"
              and set(traced["blocks"].values()) == {"split"}
              and "experts" in traced["blocks"]
              and traced["axes"] == {"core": "heads", "cache": "kv heads"},
              f"phase 27 {shape}: plan {traced['mechanism']} "
              f"{traced['blocks']} {traced['axes']}")
        want = ep_collectives(L, kind)
        check(traced["collectives"] == want,
              f"phase 27 {shape}: the trace records "
              f"{traced['collectives']} collectives, the code {want}")
        check(not set(traced["gathered_bytes"]) & {leaf / 2, leaf},
              f"phase 27 {shape}: an all-gather of an expert leaf "
              f"({traced['gathered_bytes']})")
        card = res[0]["warm"]
        rel = {k: abs(card[k] - traced[k]) / traced[k]
               for k in ("flops", "bytes")}
        check(max(rel.values()) <= DRYRUN_REL,
              f"phase 27 {shape}: rank 0 counted {card['flops']:.6e} "
              f"FLOPs, {card['bytes']:.6e} bytes; its trace "
              f"{traced['flops']:.6e}, {traced['bytes']:.6e} (rel {rel})")
        per = {"prefill": {"contiguous_prefill": L},
               "train": {"contiguous_prefill": 2 * L},
               "decode": {"contiguous_decode_padded": L}}[kind]
        ranks = []
        for r in res:
            warm = {k: n for k, n in r["warm"]["launches"].items() if n}
            timed = {k: n for k, n in r["launches"].items() if n}
            check(r["warm"]["finite"], f"phase 27 {shape}: rank "
                  f"{r['rank']}: non-finite outputs")
            check(r["plan"]["experts"] == "split"
                  and r["mechanism"] == "tensor",
                  f"phase 27 {shape}: rank {r['rank']} ran {r['mechanism']}"
                  f" {r['plan']}")
            check(warm == per and timed == {
                k: n * EP_RUNS for k, n in per.items()},
                  f"phase 27 {shape}: rank {r['rank']} launched {warm} "
                  f"warm, {timed} in {EP_RUNS} runs; want {per} a run")
            calls, secs = r["collectives"]["model"]
            check(r["warm"]["collectives"] == {"model": want}
                  and calls == want * EP_RUNS,
                  f"phase 27 {shape}: rank {r['rank']}: "
                  f"{r['warm']['collectives']} warm, {calls} in "
                  f"{EP_RUNS} runs; the code makes {want} a run")
            ms = sum(r["ms"]) / len(r["ms"])
            a_run = {k: n // EP_RUNS for k, n in timed.items()}
            ranks.append({"rank": r["rank"], "ms": r["ms"],
                          "ms_mean": ms, "collectives": want,
                          "collective_s": secs / EP_RUNS,
                          "peak_memory_gb":
                          r.get("peak_memory_bytes", 0) / 1e9,
                          "launches": {k: n + warm.get(k, 0)
                                       for k, n in timed.items()}})
            log(f"phase 27 (a) {shape} [{SHARD_NOTE}]: rank {r['rank']} "
                f"{ms:.2f} ms a run (events, timed after a warm run: "
                f"{', '.join(f'{x:.2f}' for x in r['ms'])}), {want} "
                f"collectives a run on the model group, "
                f"{secs / EP_RUNS * 1e3:.1f} ms of host time, peak memory "
                f"{ranks[-1]['peak_memory_gb']:.2f} GB, launches a run "
                f"{a_run}")
        out[shape] = {
            "batch": B, "seq": T, "rank_rows": res[0]["rows"],
            "ranks": ranks, "flops_traced": traced["flops"],
            "flops_card": card["flops"], "bytes_traced": traced["bytes"],
            "bytes_card": card["bytes"], "card_vs_trace_rel": rel,
            "flops_analytic": traced["flops_analytic"],
            "t_compute": traced["t_compute"],
            "t_memory": traced["t_memory"],
            "t_collective": traced["t_collective"],
            "dominant": traced["dominant"],
            "collective_bytes": traced["collective_bytes"],
            "arg_bytes": res[0]["arg_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "trace_s": traced["trace_s"], "note": SHARD_NOTE}
        log(f"phase 27 (a) {shape}: B {B} x T {T}, {res[0]['rows']} rows "
            f"a rank, {L} layers; rank 0 counted {card['flops']:.6e} FLOPs "
            f"(analytic share {traced['flops_analytic']:.6e}) and "
            f"{card['bytes'] / 1e9:.3f} GB == its (1, 2) trace (rel "
            f"{max(rel.values()):.1e}); {want} collectives "
            f"({traced['collective_bytes'] / 1e9:.4f} GB on the wire) == "
            f"the trace's and the code's, no expert leaf gathered; traced "
            f"in {traced['trace_s']:.1f} s beside the build")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 28: the per-leaf forms of rwkv6, zamba2 and whisper on the card
# --------------------------------------------------------------------------
# each family at its published widths, cut in depth: rwkv6-7b 2 layers,
# zamba2 one group of 6 Mamba2 blocks with its shared block, whisper 2
# encoder and 2 decoder layers
FAM_CUTS = {"rwkv6-7b": {"num_layers": 2},
            "zamba2-2.7b": {"num_layers": 6, "attn_every": 6},
            "whisper-large-v3": {"num_layers": 2, "encoder_layers": 2}}
# the mechanism of each at (data 1, model 2): rwkv6 and whisper split
# every block on whole heads; zamba2's Mamba2 cuts miss its heads' edges
FAM_MECHANISMS = {"rwkv6-7b": "tensor", "zamba2-2.7b": "per-leaf",
                  "whisper-large-v3": "tensor"}
# (a): (shape, global batch, sequence) at (data 1, model 2), bf16; a
# whisper prefill runs 448 decoder tokens over its 1500 frames
FAM_CASES = (("prefill_32k", 2, 2048), ("decode_32k", 8, 4096),
             ("train_4k", 2, 1024))
FAM_WHISPER_PROMPT = 448
FAM_RUNS = 1               # timed by CUDA events after one warm run
# (b): 2 layers f32 (phase 24 (b)'s cuts, ``SHARD_FAMILIES``): B 2
# prompts of 64 tokens into a cache of 80 rows, one decode step. B 2 is
# zamba2's attn_every at these cuts: the rule's batch axis is then its
# blocks' dim, so its conv and SSD states lie on the batch rows, which
# its split blocks gather at their use
FAM_SMALL_B, FAM_SMALL_T, FAM_SMALL_CACHE = 2, 64, 80
FAM_TOL = 1e-5


def fam_cases(arch):
    """``FAM_CASES`` of ``arch`` (whisper's prefill at its 448 tokens)."""
    return tuple((shape, B, FAM_WHISPER_PROMPT if arch == WHISPER_ARCH
                  and shape == "prefill_32k" else T)
                 for shape, B, T in FAM_CASES)


def fam_config(cases_mod, arch, shape, dtype=None):
    """Phase 28's config of ``arch``: the dry run's for ``shape`` (bf16;
    whisper's position table extended), cut by ``FAM_CUTS``."""
    cfg = dataclasses.replace(cases_mod.adjusted_config(arch, shape),
                              **FAM_CUTS[arch])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def fam_collectives(arch, cfg, kind, seq):
    """A rank's collectives on the model group in one run of a family's
    program at model 2 (every block split), counted from the code of
    ``models/``. rwkv6: a layer's ``w_o`` all-reduce, its channel mix's
    gate all-gather and all-reduce; a decode step gathers the two
    token-shift leaves once where the rule splits them on D (not where D
    is the cache's length ``seq``, a dim the rule skips: decode_32k cut
    to 4096 rows leaves them whole); a train step reruns each layer (remat),
    adds a ``copy_to_tp`` all-reduce a block and the logits', the
    vocab-parallel loss's three, the global norm's and the sum of the
    shared leaves' gradients. zamba2: a Mamba2 block's projection and
    conv all-gathers, its gated norm's and ``w_out``'s all-reduces (four
    ``copy_to_tp`` all-reduces backward); the shared block's per-leaf
    attention (3) and FFN (1); remat reruns a group but its FFN's
    all-reduce. whisper (tensor parallelism, the cross K/V cache on the
    encoder's frames): an encoder layer's ``wo`` and FFN all-reduces, a
    decoder layer's self, cross and FFN ones (a prefill adds the cross
    K/V heads' gather for the cache; a decode's cross core gathers q and
    merges the frames' shares); the vocab-split embedding's all-reduce
    and the logits' gather close a serving pass."""
    L = cfg.num_layers
    if arch == "rwkv6-7b":
        shift = 2 if cfg.d_model != seq else 0
        return {"prefill": 3 * L + 2, "decode": 3 * L + 2 + shift,
                "train": 8 * L + 7}[kind]
    if arch == "zamba2-2.7b":
        A, G = cfg.attn_every, cfg.num_layers // cfg.attn_every
        per = G * (4 * A + 4)
        return {"prefill": per + 2, "decode": per + 2,
                "train": per + (per - G) + per + 5 + 1 + 1}[kind]
    Le = cfg.encoder_layers
    return {"prefill": 2 * Le + 4 * L + 2, "decode": 5 * L + 2,
            "train": (2 * Le + 3 * L) + 2 * L + (2 * Le + 4 * L) + 5
            + 1}[kind]


def _fam_small(np, torch, cfg_mod, model_mod, mesh):
    """Phase 28 (b): each family at 2 layers f32 (its published widths,
    ``SHARD_FAMILIES``'s cuts) at (data 1, model 2) on the card against
    the unsharded port on the CPU, the same weights (drawn on the card
    from ``SEED``): the prefill's logits and every leaf of each rank's
    state slice (``launch.shardings.cache_shardings``' layout), then a
    decode step's. The train step at these cuts is phase 24 (b)'s."""
    from types import SimpleNamespace

    from repro_torch.core.migration import tree_leaves, tree_map
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch.shardings import cache_shardings, local_shard
    B, T, C = FAM_SMALL_B, FAM_SMALL_T, FAM_SMALL_CACHE
    out = {}

    def err(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    for arch, cut in SHARD_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(cfg_mod.get_config(arch), **cut,
                                  dtype=torch.float32)
        model = model_mod.build_model(cfg)
        weights = _tree_to(model.init(SEED, device="cuda"),
                           torch.device("cpu"))
        torch.cuda.empty_cache()
        r = np.random.default_rng(SEED + 28)
        tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T),
                                             dtype=np.int32))
        token = torch.from_numpy(r.integers(0, cfg.vocab_size, (B,),
                                            dtype=np.int32))
        pos = torch.full((B,), T, dtype=torch.int32)
        extras = {}
        if cfg.family == "encdec":
            extras["audio_embeds"] = torch.from_numpy(r.normal(
                0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        got = mesh.run(cases_mod.rank_prefill_decode, cfg, SEED, tokens, C,
                       token, pos, extras, layout=(1, 2))
        with torch.no_grad():
            logits, cache = model.prefill(weights, tokens, cache_len=C,
                                          **extras)
            first = tree_map(torch.clone, cache)
            dec, cache = model.decode_step(weights, cache, token, pos)
        errs = {}
        for g in got:
            rank = SimpleNamespace(shape={"data": 1, "model": 2},
                                   coords={"data": 0, "model": g["rank"]})
            specs = cache_shardings(first, rank, batch_size=B, cache_seq=C)
            check(g["mechanism"] == FAM_MECHANISMS[arch],
                  f"phase 28 (b) {arch}: rank {g['rank']} ran "
                  f"{g['mechanism']}")
            e = {"logits": err(g["logits"], logits),
                 "decode_logits": err(g["decode_logits"], dec)}
            for key, whole in (("cache", first), ("decode_cache", cache)):
                want = cases_mod._zip_map(lambda a, sp: local_shard(
                    a, sp, rank), whole, specs)
                pairs = list(zip(tree_leaves(g[key]), tree_leaves(want)))
                check(all(a.shape == b.shape for a, b in pairs),
                      f"phase 28 (b) {arch}: rank {g['rank']} {key} "
                      f"shapes {[tuple(a.shape) for a, _ in pairs]} vs "
                      f"{[tuple(b.shape) for _, b in pairs]}")
                e[key] = max(err(a, b) for a, b in pairs)
            errs[g["rank"]] = e
            check(max(e.values()) <= FAM_TOL, f"phase 28 (b) {arch}: rank "
                  f"{g['rank']} on the card vs the unsharded CPU model: "
                  f"{e} (tolerance {FAM_TOL})")
        secs = time.perf_counter() - t0
        out[arch] = {"outputs": errs, "seconds": secs}
        log(f"phase 28 (b) ({arch}, {cut}, f32, (data 1, model 2) on the "
            f"card vs unsharded on the CPU): prefill logits / state, "
            f"decode logits / state within "
            + "; ".join(f"rank {k} " + " / ".join(f"{v:.2e}"
                                                   for v in e.values())
                        for k, e in errs.items())
            + f" (tolerance {FAM_TOL}); {secs:.1f} s")
        del weights, cache, first
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_families(np, torch, cfg_mod, model_mod, mesh, traces):
    """Phase 28: the per-leaf forms of rwkv6-7b, zamba2-2.7b and
    whisper-large-v3 at their published widths cut in depth
    (``FAM_CUTS``), at (data 1, model 2) on phase 26's two ranks sharing
    the card over gloo: every leaf the rules split stays split (rwkv6's
    WKV and zamba2's SSD on the rank's heads, whisper's attention on its
    heads, its cross K/V cache on the encoder's frames). (a) bf16,
    seeded weights, ``fam_cases``: each case's program on each rank
    (``launch.dryrun.run_rank`` with ``cfg=``: one warm run under
    ``FlopCounterMode`` and ``Traffic``, ``FAM_RUNS`` runs timed by CUDA
    events), its ms, collectives (count, host s), peak memory and
    launches a rank (two ranks on one card; not a speedup); the
    collectives those of :func:`fam_collectives` and of the (1, 2) trace,
    none an all-gather of a weight leaf; whisper's #6 == layers a prefill
    run and 2 x layers a train step, #5 == layers a decode run (its
    self-KV; the cross core on the frames is plain), nothing launched by
    rwkv6 or zamba2 (Dh 80); rank 0's counted FLOPs and bytes equal its
    trace's within ``DRYRUN_REL``. (b) 2 layers f32 (:func:`_fam_small`).
    """
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    _fresh_card(torch, "phase 28")
    ran = {}
    for arch in FAM_CUTS:
        for shape, B, T in fam_cases(arch):
            ran[arch, shape] = mesh.run(
                dryrun_mod.run_rank, arch, shape, batch=B, seq=T, seed=SEED,
                runs=FAM_RUNS, cfg=fam_config(cases_mod, arch, shape),
                layout=(1, 2))
        gc.collect()
        torch.cuda.empty_cache()
    out = {"small": _fam_small(np, torch, cfg_mod, model_mod, mesh)}
    for (arch, shape), res in ran.items():
        kind = cases_mod.shape_kind(shape)
        B, T = next((b, t) for sh, b, t in fam_cases(arch) if sh == shape)
        cfg = fam_config(cases_mod, arch, shape)
        traced = traces[arch, shape].get(600)
        L = cfg.num_layers
        label = f"phase 28 {arch} {shape}"
        check(traced["mechanism"] == FAM_MECHANISMS[arch]
              and set(traced["blocks"].values()) == {"split"},
              f"{label}: plan {traced['mechanism']} {traced['blocks']} "
              f"{traced['axes']}")
        want = fam_collectives(arch, cfg, kind, T)
        check(traced["collectives"] == want,
              f"{label}: the trace records {traced['collectives']} "
              f"collectives, the code {want}")
        check(not traced["weight_gathers"],
              f"{label}: all-gathers of weight leaves "
              f"{traced['weight_gathers']}")
        card = res[0]["warm"]
        rel = {k: abs(card[k] - traced[k]) / traced[k]
               for k in ("flops", "bytes")}
        check(max(rel.values()) <= DRYRUN_REL,
              f"{label}: rank 0 counted {card['flops']:.6e} FLOPs, "
              f"{card['bytes']:.6e} bytes; its trace {traced['flops']:.6e}, "
              f"{traced['bytes']:.6e} (rel {rel})")
        per = {}
        if arch == WHISPER_ARCH:
            per = {"prefill": {"contiguous_prefill": L},
                   "train": {"contiguous_prefill": 2 * L},
                   "decode": {"contiguous_decode_padded": L}}[kind]
        ranks = []
        for r in res:
            warm = {k: n for k, n in r["warm"]["launches"].items() if n}
            timed = {k: n for k, n in r["launches"].items() if n}
            check(r["warm"]["finite"], f"{label}: rank {r['rank']}: "
                  f"non-finite outputs")
            check(r["mechanism"] == FAM_MECHANISMS[arch],
                  f"{label}: rank {r['rank']} ran {r['mechanism']}")
            check(warm == per and timed == {
                k: n * FAM_RUNS for k, n in per.items()},
                  f"{label}: rank {r['rank']} launched {warm} warm, "
                  f"{timed} in {FAM_RUNS} runs; want {per} a run")
            calls, secs = r["collectives"]["model"]
            check(r["warm"]["collectives"] == {"model": want}
                  and calls == want * FAM_RUNS,
                  f"{label}: rank {r['rank']}: {r['warm']['collectives']} "
                  f"warm, {calls} in {FAM_RUNS} runs; the code makes "
                  f"{want} a run")
            ms = sum(r["ms"]) / len(r["ms"])
            ranks.append({"rank": r["rank"], "ms": r["ms"],
                          "ms_mean": ms, "collectives": want,
                          "collective_s": secs / FAM_RUNS,
                          "peak_memory_gb":
                          r.get("peak_memory_bytes", 0) / 1e9,
                          "launches": {k: n + warm.get(k, 0)
                                       for k, n in timed.items()}})
            log(f"phase 28 (a) {arch} {shape} [{SHARD_NOTE}]: rank "
                f"{r['rank']} {ms:.2f} ms a run (events, timed after a "
                f"warm run), {want} collectives a run on the model group, "
                f"{secs / FAM_RUNS * 1e3:.1f} ms of host time, peak memory "
                f"{ranks[-1]['peak_memory_gb']:.2f} GB, launches a run "
                f"{per or 'none'}")
        out[f"{arch} {shape}"] = {
            "arch": arch, "shape": shape, "batch": B, "seq": T,
            "layers": L, "rank_rows": res[0]["rows"], "ranks": ranks,
            "mechanism": traced["mechanism"], "axes": traced["axes"],
            "flops_traced": traced["flops"], "flops_card": card["flops"],
            "bytes_traced": traced["bytes"], "bytes_card": card["bytes"],
            "card_vs_trace_rel": rel,
            "flops_analytic": traced["flops_analytic"],
            "t_compute": traced["t_compute"],
            "t_memory": traced["t_memory"],
            "t_collective": traced["t_collective"],
            "dominant": traced["dominant"],
            "collective_bytes": traced["collective_bytes"],
            "arg_bytes": res[0]["arg_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "trace_s": traced["trace_s"], "note": SHARD_NOTE}
        log(f"phase 28 (a) {arch} {shape}: B {B} x T {T}, "
            f"{res[0]['rows']} rows a rank, {L} layers, "
            f"{traced['mechanism']} {traced['axes']}; rank 0 counted "
            f"{card['flops']:.6e} FLOPs (analytic share "
            f"{traced['flops_analytic']:.6e}) and {card['bytes'] / 1e9:.3f} "
            f"GB == its (1, 2) trace (rel {max(rel.values()):.1e}); {want} "
            f"collectives ({traced['collective_bytes'] / 1e9:.4f} GB on the "
            f"wire) == the trace's and the code's, no weight leaf "
            f"gathered; traced in {traced['trace_s']:.1f} s beside the "
            f"build")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 29: the optimized program's levers (build_case(optimized=True)) on
# the card
# --------------------------------------------------------------------------
# (a): smollm-360m at phase 26's config (full width, 32 layers) at (data 1,
# model 2): a train step under sequence parallelism (ZeRO-1 is inert at
# data 1) and a decode whose KV cache lies on the sequence (Hkv 5 does not
# divide 2); (b): qwen3-moe-30b-a3b at (data 2, model 1): a decode with
# 2-D experts (F on the data axis) at phase 27's 4 layers and a ZeRO-1
# train step at 1 (at 4, each rank's 3.1 B parameters, their gradients,
# their ZeRO-1 moments and the reduce-scatter's buffers passed the card's
# 80 GB for two ranks; at 2 its gloo sums of 3.7 GB a run took the phase
# to 48.6 s on the H100, for a budget of 45 s); bf16. (arch, layers cut,
# (data, model), (shape, global batch, sequence)):
OPT_MOE_TRAIN_LAYERS = 1
OPT_CASES = ((PART_ARCH, None, (1, 2), (("train_4k", 2, 1024),
                                        ("decode_32k", 8, 4096))),
             (MOE_ARCH, OPT_MOE_TRAIN_LAYERS, (2, 1),
              (("train_4k", 2, 1024),)),
             (MOE_ARCH, EP_LAYERS, (2, 1), (("decode_32k", 8, 4096),)))
OPT_RUNS = 1               # timed by CUDA events after one warm run
# the cases whose baseline runs beside them at their layout: (a)'s is
# phase 26's; (b)'s train step without ZeRO-1 holds twice its moments
# (f32, a rank's whole tree), which two ranks on one card cannot
OPT_BASELINE = ((MOE_ARCH, "decode_32k"),)
# (c): each lever at 2 layers f32 (published widths): (arch, (data,
# model), shape, global batch, sequence); a decode's cache holds 80 rows
OPT_SMALL = ((PART_ARCH, (1, 2), "train_4k", 2, 64),
             (PART_ARCH, (1, 2), "decode_32k", 2, 80),
             (PART_ARCH, (2, 1), "train_4k", 2, 64),
             (MOE_ARCH, (2, 1), "decode_32k", 4, 80))
OPT_TOL = 1e-5


def opt_collectives(arch, L, kind, optimized):
    """A rank's collectives in one run of phase 29's programs, counted
    from the code of ``models/`` and ``training/``. smollm at (1, 2) (the
    model group): the baseline's (:func:`part_collectives`); sequence
    parallelism adds 6 a layer to a train step (each block's gather and
    reduce-scatter for one all-reduce, forward, backward and in remat's
    second forward, which now gathers the FFN's input too) and 3 (the
    embedding's slice gathers back, the last layer's rows are gathered,
    the norms' gradients all-reduced); a decode on the sequence-split
    cache makes one fewer a layer (the log-sum-exp merge's all-gather for
    the scores' all-reduce and the head dim's all-gather). qwen3-moe at
    (2, 1) (the data group; bf16 weights and the f32 router, one sum a
    dtype): a train step's xent count and metric, the MoE aux statistics
    (2 a layer, twice under remat) and the gradients' all-reduce a dtype,
    which ZeRO-1 makes a reduce-scatter and an all-gather a dtype and the
    norm's all-reduce; a decode makes none, with 2-D experts a gather and
    a reduce-scatter of the dispatched rows a layer."""
    if arch == PART_ARCH:
        base = part_collectives(L, kind)
        if not optimized:
            return base
        return base + {"train": 6 * L + 3, "decode": -L}[kind]
    if kind == "decode":
        return 2 * L if optimized else 0
    return 2 + 4 * L + (2 * 2 + 1 if optimized else 2)


def _opt_config(cases_mod, arch, layers, shape, dtype=None):
    if layers is None:
        cfg = cases_mod.adjusted_config(arch, shape)
        return cfg if dtype is None else dataclasses.replace(cfg,
                                                             dtype=dtype)
    return ep_config(cases_mod, layers, dtype)


def _opt_small(torch, mesh):
    """Phase 29 (c): each lever at 2 layers f32 (published widths) on the
    same ranks (``OPT_SMALL``: sequence parallelism and the
    sequence-split cache at (1, 2), ZeRO-1 and 2-D experts at (2, 1)),
    the baseline and the optimized program on the same inputs
    (``launch.dryrun.run_pair``): a train step's metrics, params and
    moments, a decode's logits and cache slice (the baseline's updated
    cache gathered and cut by the optimized layout) within
    ``OPT_TOL``."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    out = {}
    for arch, dm, shape, B, T in OPT_SMALL:
        cfg = dataclasses.replace(cases_mod.adjusted_config(arch, shape),
                                  num_layers=2, dtype=torch.float32)
        res = mesh.run(dryrun_mod.run_pair, arch, shape, batch=B, seq=T,
                       seed=SEED, cfg=cfg, layout=dm)
        gaps = {}
        for r in res:
            for k, v in r["gaps"].items():
                gaps[k] = max(gaps.get(k, 0.0), v)
        check(res[0]["levers"] and max(gaps.values()) <= OPT_TOL,
              f"phase 29 (c) {arch} {shape} at {dm}: optimized "
              f"({res[0]['levers']}) vs baseline {gaps} (tolerance "
              f"{OPT_TOL})")
        out[f"{arch} {shape} {dm}"] = {"levers": res[0]["levers"],
                                       "gaps": gaps}
        log(f"phase 29 (c) ({arch}, 2 layers f32, {shape} B {B} x T {T}, "
            f"(data, model) {dm}, levers {res[0]['levers']}): optimized "
            f"== baseline within "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f" (tolerance {OPT_TOL})")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_levers(np, torch, mesh, traces, part):
    """Phase 29: the reference's beyond-paper levers in a rank's program
    (``launch.cases.build_case(optimized=True)``) on phase 26's two ranks
    sharing the card over gloo, reshaped per case (``OPT_CASES``). (a) and
    (b) bf16, seeded weights: each program on each rank
    (``launch.dryrun.run_rank(optimized=True)``; (b)'s baseline beside it
    at the same layout where it fits, ``OPT_BASELINE``; (a)'s is phase
    26's), its ms, collectives (count,
    host s), peak memory and #5 / #6 launches a rank (two ranks on one
    card; not a speedup); the levers the rule picks; the collectives equal
    to its trace's (:func:`start_part_traces`) and to
    :func:`opt_collectives`; rank 0's counted FLOPs and bytes equal its
    trace's within ``DRYRUN_REL``. (c) 2 layers f32 (:func:`_opt_small`).
    ``part``: phase 26's results (None: phase 29 alone)."""
    from repro_torch.launch import cases as cases_mod
    from repro_torch.launch import dryrun as dryrun_mod
    _fresh_card(torch, "phase 29")
    # the traces first (a process of their own since the build), so
    # that none shares the host's cores with the ranks' gloo staging
    t0 = time.perf_counter()
    traced_all = {key: traces[key].get(600) for key in traces
                  if len(key) == 4}
    log(f"phase 29: its traces ready after {time.perf_counter() - t0:.1f} "
        f"s more")
    want_levers = {(PART_ARCH, "train_4k"): ["seq_parallel", "zero1"],
                   (PART_ARCH, "decode_32k"): ["seq_cache"],
                   (MOE_ARCH, "train_4k"): ["seq_parallel", "zero1"],
                   (MOE_ARCH, "decode_32k"): ["expert_2d"]}
    ran = {}
    for arch, layers, dm, cases in OPT_CASES:
        for shape, B, T in cases:
            cfg = _opt_config(cases_mod, arch, layers, shape)
            for opt in (False, True) if (arch, shape) in OPT_BASELINE \
                    else (True,):
                ran[arch, shape, opt] = mesh.run(
                    dryrun_mod.run_rank, arch, shape, batch=B, seq=T,
                    seed=SEED, runs=OPT_RUNS, cfg=cfg, optimized=opt,
                    layout=dm)
                gc.collect()
                torch.cuda.empty_cache()
    out = {"small": _opt_small(torch, mesh)}
    for arch, layers, dm, cases in OPT_CASES:
        for shape, B, T in cases:
            kind = cases_mod.shape_kind(shape)
            L = _opt_config(cases_mod, arch, layers, shape).num_layers
            group = "model" if dm[1] > 1 else "data"
            per = {"train": {"contiguous_prefill": 2 * L},
                   "decode": ({} if arch == PART_ARCH
                              else {"contiguous_decode_padded": L})}[kind]
            for opt in (False, True):
                label = (f"phase 29 {arch} {shape} at {dm}"
                         f"{' optimized' if opt else ''}")
                if not opt and (arch, shape) not in OPT_BASELINE:
                    continue
                res = ran.pop((arch, shape, opt))
                traced = traced_all[arch, shape, dm, opt]
                want = opt_collectives(arch, L, kind, opt)
                check(traced["collectives"] == want,
                      f"{label}: the trace records {traced['collectives']} "
                      f"collectives, the code {want}")
                if opt:
                    check(traced["levers"] == want_levers[arch, shape]
                          and all(r["levers"] == traced["levers"]
                                  for r in res),
                          f"{label}: levers {traced['levers']} traced, "
                          f"{[r['levers'] for r in res]} run, want "
                          f"{want_levers[arch, shape]}")
                card = res[0]["warm"]
                rel = {k: abs(card[k] - traced[k]) / traced[k]
                       for k in ("flops", "bytes")}
                check(max(rel.values()) <= DRYRUN_REL,
                      f"{label}: rank 0 counted {card['flops']:.6e} FLOPs, "
                      f"{card['bytes']:.6e} bytes; its trace "
                      f"{traced['flops']:.6e}, {traced['bytes']:.6e} (rel "
                      f"{rel})")
                ranks = []
                for r in res:
                    warm = {k: n for k, n in r["warm"]["launches"].items()
                            if n}
                    timed = {k: n for k, n in r["launches"].items() if n}
                    check(r["warm"]["finite"], f"{label}: rank "
                          f"{r['rank']}: non-finite outputs")
                    check(warm == per and timed == {
                        k: n * OPT_RUNS for k, n in per.items()},
                          f"{label}: rank {r['rank']} launched {warm} "
                          f"warm, {timed} in {OPT_RUNS} runs; want {per}")
                    calls, secs = r["collectives"].get(group, (0, 0.0))
                    check(sum(r["warm"]["collectives"].values()) == want
                          and calls == want * OPT_RUNS,
                          f"{label}: rank {r['rank']}: "
                          f"{r['warm']['collectives']} warm, {calls} in "
                          f"{OPT_RUNS} runs; the code makes {want} a run")
                    ms = sum(r["ms"]) / len(r["ms"])
                    ranks.append({"rank": r["rank"], "ms": r["ms"],
                                  "ms_mean": ms, "collectives": want,
                                  "collective_s": secs / OPT_RUNS,
                                  "peak_memory_gb":
                                  r.get("peak_memory_bytes", 0) / 1e9,
                                  "launches": {k: n + warm.get(k, 0)
                                               for k, n in timed.items()}})
                    log(f"{label} [{SHARD_NOTE}]: rank {r['rank']} "
                        f"{ms:.2f} ms a run (events, timed after a warm "
                        f"run), {want} collectives a run on the {group} "
                        f"group, {secs / OPT_RUNS * 1e3:.1f} ms of host "
                        f"time, peak memory {ranks[-1]['peak_memory_gb']:.2f}"
                        f" GB, launches a run {per or 'none'}")
                out[f"{arch} {shape} {'opt' if opt else 'base'}"] = {
                    "arch": arch, "shape": shape, "layout": dm,
                    "optimized": opt, "levers": traced["levers"],
                    "batch": B, "seq": T, "layers": L,
                    "rank_rows": res[0]["rows"], "ranks": ranks,
                    "flops_traced": traced["flops"],
                    "flops_card": card["flops"],
                    "bytes_traced": traced["bytes"],
                    "bytes_card": card["bytes"], "card_vs_trace_rel": rel,
                    "collective_bytes": traced["collective_bytes"],
                    "arg_bytes": res[0]["arg_bytes"],
                    "temp_bytes": traced["temp_bytes"],
                    "trace_s": traced["trace_s"], "note": SHARD_NOTE}
                log(f"{label}: B {B} x T {T}, {res[0]['rows']} rows a rank, "
                    f"{L} layers, levers {traced['levers']}; rank 0 counted "
                    f"{card['flops']:.6e} FLOPs and {card['bytes'] / 1e9:.3f} "
                    f"GB == its trace (rel {max(rel.values()):.1e}); {want} "
                    f"collectives ({traced['collective_bytes'] / 1e9:.4f} GB "
                    f"on the wire) == the trace's and the code's")
            if dm == (1, 2) and part:   # beside phase 26's baseline
                base = part[shape]["ranks"][0]
                log(f"phase 29 (a) {shape}: optimized "
                    f"{out[f'{arch} {shape} opt']['ranks'][0]['ms_mean']:.2f}"
                    f" ms beside the baseline's {base['ms_mean']:.2f} ms "
                    f"(phase 26), collectives "
                    f"{out[f'{arch} {shape} opt']['ranks'][0]['collectives']}"
                    f" beside {base['collectives']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_rows(fam, moe, vlm, win, whisper):
    """The kernels JSON rows of the families' shapes (#1 at G 8; #2, #3,
    #5, #6 at G 7; #5 and #6 at G 12 and at G 1, #5 on whisper's self-
    and cross-KV; measured by ``family_kernels``), with their launches on
    phases 16, 17, 18 (a) and 21 (a)'s paths."""
    moe_launches = (moe["engine"]["launches"].get("fused", 0)
                    + moe["cluster"]["launches"].get("fused", 0))
    vl = vlm["engine"]["launches"]
    slab = vlm["slab"]["launches"]
    ring = win["runs"]["window 4096"]["launches"]
    rows = []
    for k, name, src, tpu, launches, shape in (
            (fam["moe"], "paged_mixed_attention_g8", "mixed_attention.cu",
             "src/repro/kernels/mixed_attention.py:187", moe_launches,
             f"{MOE_ARCH}: H 32 / Hkv 4 / Dh 64, phase 3's segments"),
            (fam["flat"]["decode"], "paged_decode_attention_flat_g7",
             "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:185",
             vl.get("flat_decode", 0),
             f"{VLM_ARCH}: H 28 / Hkv 4 / Dh 128, phase 3's decode rows"),
            (fam["flat"]["prefill"], "paged_prefill_attention_g7",
             "prefill_attention.cu",
             "src/repro/kernels/prefill_attention.py:255",
             vl.get("chunked_prefill", 0),
             f"{VLM_ARCH}: H 28 / Hkv 4 / Dh 128, phase 3's chunks"),
            (fam["slab"]["decode_padded"],
             "decode_attention_padded_g7", "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             slab.get("contiguous_decode_padded", 0),
             f"{VLM_ARCH}: 2 rows over a 1025-row slab via kv_rows"),
            (fam["slab"]["prefill"], "prefill_attention_g7",
             "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             slab.get("contiguous_prefill", 0),
             f"{VLM_ARCH}: B 2, T 1024"),
            (fam["window"]["decode_padded"],
             "decode_attention_padded_g12", "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             ring.get("contiguous_decode_padded", 0),
             f"{WINDOW_ARCH} (window {WINDOW}): H 24 / Hkv 2 / Dh 128, "
             f"8 rows over the {WINDOW}-slot ring via kv_rows"),
            (fam["window"]["prefill"], "prefill_attention_g12",
             "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             ring.get("contiguous_prefill", 0),
             f"{WINDOW_ARCH}: H 24 / Hkv 2 / Dh 128, B 1, T "
             f"{fam['window']['prefill']['T']}")):
        row = {"name": name, "ok": True, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": tpu, "launches": launches, "shape": shape,
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
               "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
               "library_ms": k["library_ms"],
               "bound_share": k["bound_ms"] / k["ms"]}
        for key in ("max_abs_err_f32", "device_ms", "library_device_ms",
                    "host_us"):
            if key in k:
                row[key] = k[key]
        rows.append(row)
    by_name = {row["name"]: row for row in rows}
    by_name["decode_attention_padded_g12"]["ptxas"] = win["ptxas_g12"]
    wl = whisper["decode_by_slab"]
    for k, name, src, tpu, launches, shape in (
            (fam["whisper"]["prefill"], "prefill_attention_g1",
             "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             whisper["launches"].get("contiguous_prefill", 0),
             f"{WHISPER_ARCH}: H 20 / Hkv 20 / Dh 64, B {WHISPER_B}, T 448"),
            (fam["whisper"]["decode_padded"], "decode_attention_padded_g1",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             wl.get(448, 0),
             f"{WHISPER_ARCH}: self-KV, {WHISPER_B} rows of a 448-row slab "
             f"at {WHISPER_PROMPT + WHISPER_NEW} keys"),
            (fam["whisper_cross"]["decode_padded"],
             "decode_attention_padded_g1_cross", "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291", wl.get(1500, 0),
             f"{WHISPER_ARCH}: cross-KV, {WHISPER_B} rows of 1500 keys, "
             "every key valid")):
        rows.append({"name": name, "ok": True, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": tpu, "launches": launches, "shape": shape,
                     **{key: k[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "device_ms",
                         "library_device_ms") if key in k},
                     "kernel_ms": k["ms"],
                     "bound_share": k["bound_ms"] / k["ms"]})
    d128 = fam["moe_dh128"]       # #1 at the published head width
    rows[0]["dh128"] = {key: d128[key] for key in (
        "max_abs_err", "max_abs_err_f32", "ms", "device_ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "library_device_ms")
        if key in d128}
    return rows


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_to(tree, device, copy=False):
    return {k: (_tree_to(v, device, copy) if isinstance(v, dict)
                else v.detach().to(device, copy=copy))
            for k, v in tree.items()}


# the 2-layer f32 llama3.2-3b that phases 5, 7, 9, 12, 14 and 23 hold on
# the card against the CPU: drawn once from SEED on the CPU (~10 s there)
# and shared, since those phases only read it; main() drops it after 23
_CPU_WEIGHTS = {}


def cpu_weights(model):
    """``model.init(SEED, device="cpu")``, drawn once per config."""
    key = repr(model.cfg)
    if key not in _CPU_WEIGHTS:
        _CPU_WEIGHTS[key] = model.init(SEED, device="cpu")
    return _CPU_WEIGHTS[key]


def progress(t_main, phase):
    """The time since the start after each phase, on stderr, so that a run
    cut at its time limit still shows how far it got."""
    print(f"chip_smoke: phase {phase} done at "
          f"{time.perf_counter() - t_main:.1f} s", file=sys.stderr,
          flush=True)


def main() -> int:
    t_main = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    tracers, traces = start_part_traces()
    try:
        return phases(t_main, np, torch, traces)
    finally:
        for tracer in tracers:
            tracer.terminate()


def phases(t_main, np, torch, traces) -> int:
    """Phases 1-29 (the module's docstring)."""
    # f32 comparisons (phases 3 and 5) need full-precision f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F
    from repro_torch import configs as cfg_mod
    from repro_torch.core import qoe as qoe_mod
    from repro_torch.kernels import api, build
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

    # 2. build every kernel of the paths from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"phase 2: {name}: {line.strip()}")
    log(f"phase 2: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report("\n".join(logs.values()))
    for label, rep in sorted(ptxas.items()):
        log(f"phase 3: ptxas {label}: {rep.get('registers')} registers, "
            f"{rep.get('spill_bytes')} bytes spilled")
    for k in REDESIGNED:
        check(any(label.startswith(k) for label in ptxas),
              f"no ptxas report for {k}")
    # one cuobjdump a library, all at once
    with ThreadPoolExecutor(len(TENSOR_CORE)) as pool:
        tc_ops = dict(zip((k for _, k in TENSOR_CORE), pool.map(
            lambda lk: tensor_core_count(build, *lk), TENSOR_CORE)))
    for lib, kernel in TENSOR_CORE:
        log(f"phase 3: tensor-core instructions in the SASS of {kernel} "
            f"({lib}): {tc_ops[kernel]}")
        check(tc_ops[kernel]["HGMMA"] > 0, f"{kernel} has no HGMMA")
    spilled = {label: rep for label, rep in ptxas.items()
               if rep.get("spill_bytes") and not label.startswith(SPLIT_KV)}
    check(not spilled, f"tensor-core kernels spill: {spilled}")
    progress(t_main, 2)

    # 3. kernels vs their plain versions
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    kern = phase_kernels(np, torch, F, tk, flush)
    int8 = phase_int8_kernel(np, torch, F, tk, flush)
    flat = phase_flat_kernels(np, torch, F, dk, pk, flush)
    more = phase_grid_contiguous_kernels(np, torch, F, tk, dk, pk, flush)
    # the same kernels at the MoE and VLM configs' heads (phases 16-17)
    fam = family_kernels(np, torch, F, cfg_mod, tk, dk, pk, flush)
    progress(t_main, 3)

    # 4. the engine's main path at full width (fused backend)
    zero_counts(tk, dk, pk)
    eng_summary = phase_engine(np, torch, cfg_mod, model_mod, engine_mod,
                               request_mod, tk)
    others = {k: n for k, n in launch_counts(tk, dk, pk).items()
              if n and k != "fused"}
    check(not others, f"the fused engine ran other kernels: {others}")
    progress(t_main, 4)

    # 5. cuda vs cpu
    phase_devices(np, torch, cfg_mod, model_mod, engine_mod, request_mod)
    progress(t_main, 5)

    # 6. the cluster at full width (flat backend)
    cluster = phase_cluster(np, torch, cfg_mod, model_mod, engine_mod,
                            request_mod, server_mod, serve_mod, qoe_mod, tk,
                            dk, pk)
    progress(t_main, 6)

    # 7. the cluster, cuda vs cpu
    phase_cluster_devices(np, torch, cfg_mod, model_mod, request_mod,
                          server_mod, serve_mod, qoe_mod)
    progress(t_main, 7)

    # 8. int8 pools, preemption, the host tier and faults at full width
    llama = cfg_mod.get_config("llama3.2-3b")
    chaos = phase_chaos_cluster(
        np, torch, dataclasses.replace(llama, dtype=torch.bfloat16),
        model_mod, engine_mod, request_mod, server_mod, serve_mod, qoe_mod,
        tk)
    progress(t_main, 8)

    # 9. the same paths, 2 layers f32, cuda vs cpu
    phase_chaos_devices(np, torch, dataclasses.replace(
        llama, num_layers=2, dtype=torch.float32), model_mod, engine_mod,
        request_mod, server_mod, serve_mod, qoe_mod)
    progress(t_main, 9)

    # 10. the cluster at full width on the grid backend
    grid_cluster = phase_cluster(np, torch, cfg_mod, model_mod, engine_mod,
                                 request_mod, server_mod, serve_mod, qoe_mod,
                                 tk, dk, pk, backend="grid",
                                 label="phase 10")
    progress(t_main, 10)

    # 11. the dense backend on int8 pools at full width (no kernel)
    dense_int8 = phase_dense_int8_engine(np, torch, cfg_mod, model_mod,
                                         engine_mod, request_mod, tk, dk, pk)
    progress(t_main, 11)

    # 12. grid cluster and dense + int8 engine, 2 layers f32, cuda vs cpu
    phase_cluster_devices(np, torch, cfg_mod, model_mod, request_mod,
                          server_mod, serve_mod, qoe_mod, backend="grid",
                          label="phase 12")
    phase_devices(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
                  backend="dense", kv_dtype="int8", label="phase 12")
    progress(t_main, 12)

    # 13. the paper's Fig. 2 through kernels.api (the contiguous kernels'
    # main path)
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts(tk, dk, pk)
    fig2 = phase_fig2(torch, api, dk, flush)
    contiguous = launch_counts(tk, dk, pk)
    for key in ("contiguous_decode_padded", "contiguous_decode_ragged",
                "contiguous_prefill"):
        check(contiguous[key] > 0, f"phase 13 never launched {key}")
    del flush
    progress(t_main, 13)

    # 14. the engine's other modes at full width (#6 and #5 serving), and
    # at 2 layers f32 on the card and the CPU
    t14 = time.perf_counter()
    modes = phase_engine_modes(np, torch, cfg_mod, model_mod, engine_mod,
                               request_mod, tk, dk, pk,
                               eng_summary["streams"])
    phase_engine_modes_devices(np, torch, cfg_mod, model_mod, engine_mod,
                               request_mod)
    modes["phase_s"] = time.perf_counter() - t14
    log(f"phase 14: took {modes['phase_s']:.1f} s")
    progress(t_main, 14)

    # 15. the H100 cost model against the card is tools/calibrate_h100.py,
    # run on its own

    # 16. the MoE family: qwen3-moe-30b-a3b at full width, alone on the
    # card (engine, 2-engine cluster), 2 layers f32 and arctic reduced on
    # the card and the CPU
    t16 = time.perf_counter()
    moe = phase_moe(np, torch, cfg_mod, model_mod, engine_mod,
                    request_mod, server_mod, serve_mod, qoe_mod, tk, dk, pk)
    moe["phase_s"] = time.perf_counter() - t16
    log(f"phase 16: took {moe['phase_s']:.1f} s")
    progress(t_main, 16)

    # 17. the VLM family: qwen2-vl-7b at full width (flat engine, fused
    # refusing it, the slab with vision extras), 2 layers f32 on the card
    # and the CPU
    t17 = time.perf_counter()
    vlm = phase_vlm(np, torch, cfg_mod, model_mod, engine_mod,
                    request_mod, tk, dk, pk)
    vlm["phase_s"] = time.perf_counter() - t17
    log(f"phase 17: took {vlm['phase_s']:.1f} s")
    progress(t_main, 17)

    # 18. starcoder2-3b with its 4096-token window: the slab's rings (#6
    # within the window, the banded path beyond it, #5 on the ring), the
    # window wider than every sequence == no window, 2 layers f32 on the
    # card and the CPU
    t18 = time.perf_counter()
    window = phase_window(np, torch, cfg_mod, model_mod, engine_mod,
                          request_mod, tk, dk, pk, ptxas)
    window["phase_s"] = time.perf_counter() - t18
    log(f"phase 18: took {window['phase_s']:.1f} s")
    progress(t_main, 18)

    # 19. rwkv6-7b: the slab's recurrent state, the chunked WKV, a
    # 2-engine cluster migrating whole states, 2 layers f32 on the card
    # and the CPU
    t19 = time.perf_counter()
    rwkv = phase_rwkv(np, torch, cfg_mod, model_mod, engine_mod,
                      request_mod, server_mod, serve_mod, qoe_mod, tk, dk,
                      pk)
    rwkv["phase_s"] = time.perf_counter() - t19
    log(f"phase 19: took {rwkv['phase_s']:.1f} s")
    progress(t_main, 19)

    # 20. zamba2-2.7b: the Mamba2 hybrid at full width (the chunked SSD,
    # the shared block's plain Dh-80 attention), the SSD forms against each
    # other, 6 layers f32 on the card and the CPU
    t20 = time.perf_counter()
    zamba = phase_zamba(np, torch, cfg_mod, model_mod, tk, dk, pk)
    zamba["phase_s"] = time.perf_counter() - t20
    log(f"phase 20: took {zamba['phase_s']:.1f} s")
    progress(t_main, 20)

    # 21. whisper-large-v3: the encoder-decoder at full width (#6 on the
    # decoder prompt, #5 on the self- and cross-KV), 2 + 2 layers f32 on
    # the card and the CPU
    t21 = time.perf_counter()
    whisper = phase_whisper(np, torch, cfg_mod, model_mod, tk, dk, pk)
    whisper["phase_s"] = time.perf_counter() - t21
    log(f"phase 21: took {whisper['phase_s']:.1f} s")
    progress(t_main, 21)

    # 22. training: llama3.2-3b at full width (#6 forward under autograd,
    # remat), 2 layers f32 on the card and the CPU, a checkpoint round trip
    t22 = time.perf_counter()
    training = phase_train(np, torch, cfg_mod, model_mod, tk, dk, pk)
    training["phase_s"] = time.perf_counter() - t22
    log(f"phase 22: took {training['phase_s']:.1f} s")
    progress(t_main, 22)

    # 23. tensor-parallel serving: llama3.2-3b as a tp=2 fused engine, two
    # ranks on the card over gloo; 2 layers f32 tp=2 on the card == tp=1
    # on the CPU; a (1, 2, 1) cluster migrating across the tp sizes
    t23 = time.perf_counter()
    tp = phase_tp(np, torch, cfg_mod, model_mod, engine_mod, request_mod,
                  server_mod, tk, dk, pk, eng_summary["streams"],
                  eng_summary["num_blocks"])
    tp["phase_s"] = time.perf_counter() - t23
    log(f"phase 23: took {tp['phase_s']:.1f} s")

    _CPU_WEIGHTS.clear()               # phase 23 was their last reader
    progress(t_main, 23)

    # 24. sharded training: llama3.2-3b at model 2 on two ranks sharing
    # the card (tensor parallelism, #6 at 12 / 4 heads); 2 layers f32
    # sharded on the card == unsharded on the CPU, the per-leaf forms of the
    # families; the sharded checkpoint
    t24 = time.perf_counter()
    sharded = phase_sharded_train(np, torch, cfg_mod, model_mod, pk,
                                  training)
    sharded["phase_s"] = time.perf_counter() - t24
    log(f"phase 24: took {sharded['phase_s']:.1f} s")
    progress(t_main, 24)

    # 25. the dry run's llama3.2-3b programs on the card against their
    # roofline (#6 and #5 through build_case's programs)
    t25 = time.perf_counter()
    dry = phase_dryrun(torch)
    dry["phase_s"] = time.perf_counter() - t25
    log(f"phase 25: took {dry['phase_s']:.1f} s")
    progress(t_main, 25)

    # 26. the per-leaf partition: smollm-360m at model 2 (heads that do
    # not divide), two ranks sharing the card; 2 layers f32 == the CPU
    t26 = time.perf_counter()
    mesh = train_group(torch, "phases 26-28")
    try:
        part = phase_partition(np, torch, cfg_mod, model_mod, mesh, traces)
        part["phase_s"] = time.perf_counter() - t26
        log(f"phase 26: took {part['phase_s']:.1f} s")
        progress(t_main, 26)

        # 27. the expert-split MoE: qwen3-moe at model 2 (64 experts a
        # rank), on the same two ranks; 2 layers f32 == unsharded
        t27 = time.perf_counter()
        ep = phase_expert_parallel(np, torch, cfg_mod, model_mod, mesh,
                                   traces)
        ep["phase_s"] = time.perf_counter() - t27
        log(f"phase 27: took {ep['phase_s']:.1f} s")
        progress(t_main, 27)

        # 28. the per-leaf forms of rwkv6, zamba2 and whisper at model 2,
        # on the same two ranks; 2 layers f32 == the CPU
        t28 = time.perf_counter()
        families = phase_families(np, torch, cfg_mod, model_mod, mesh,
                                  traces)
        families["phase_s"] = time.perf_counter() - t28
        log(f"phase 28: took {families['phase_s']:.1f} s")
        progress(t_main, 28)

        # 29. the optimized program's levers: smollm at (1, 2) (sequence
        # parallelism, the sequence-split decode cache) and qwen3-moe at
        # (2, 1) (ZeRO-1, 2-D experts), on the same two ranks; 2 layers
        # f32: optimized == baseline
        t29 = time.perf_counter()
        levers = phase_levers(np, torch, mesh, traces, part)
        levers["phase_s"] = time.perf_counter() - t29
        log(f"phase 29: took {levers['phase_s']:.1f} s")
        progress(t_main, 29)
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()

    # 30. results
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
    }, {
        "name": "paged_mixed_attention_int8", "ok": True, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mixed_attention.cu",
        "replaces": "src/repro/kernels/mixed_attention.py:187",
        "launches": chaos["launches"],
        "max_abs_err": int8["max_abs_err"],
        "max_abs_err_f32": int8["max_abs_err_f32"],
        "cos_vs_bf16": int8["cos_vs_bf16"],
        "abs_vs_bf16": int8["abs_vs_bf16"],
        "ms": int8["ms"], "kernel_ms": int8["ms"],
        "plain_ms": int8["plain_ms"], "bound_ms": int8["bound_ms"],
        "bound_by": int8["bound_by"], "library_ms": int8["library_ms"],
    }]
    for k, name, src, tpu, launches in (
            (flat["decode"], "paged_decode_attention_flat",
             "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:185",
             cluster["launches"]["flat_decode"]),
            (flat["prefill"], "paged_prefill_attention",
             "prefill_attention.cu",
             "src/repro/kernels/prefill_attention.py:255",
             cluster["launches"]["chunked_prefill"]),
            (more["grid"], "paged_decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:242",
             grid_cluster["launches"]["grid_decode"]),
            (more["padded"], "decode_attention_padded",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             contiguous["contiguous_decode_padded"]),
            (more["ragged"], "decode_attention_ragged",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             contiguous["contiguous_decode_ragged"]),
            (more["prefill"], "prefill_attention", "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             contiguous["contiguous_prefill"])):
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "max_abs_err_f32": k["max_abs_err_f32"], "ms": k["ms"],
            "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    measured_by = [kern, int8, flat["decode"], flat["prefill"], more["grid"],
                   more["padded"], more["ragged"], more["prefill"]]
    for entry, k in zip(kernels, measured_by):
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        for key in ("device_ms", "library_device_ms", "host_us",
                    "stream_bound_ms"):
            if key in k:
                entry[key] = k[key]
    by_name = {entry["name"]: entry for entry in kernels}
    for name, k in (("paged_decode_attention", more["grid"]),
                    ("prefill_attention", more["prefill"])):
        by_name[name]["rate"] = k["rate"]
        by_name[name]["rate_unit"] = k["rate_unit"]
    for name, prefix in (("paged_mixed_attention", "mixed_tc_kernel"),
                         ("paged_mixed_attention_int8", "mixed_tc_kernel"),
                         ("paged_decode_attention_flat", "flat_split_kernel"),
                         ("paged_prefill_attention", "chunk_tc_kernel"),
                         ("paged_decode_attention", "grid_split_kernel"),
                         ("decode_attention_padded",
                          "contiguous_split_kernel"),
                         ("decode_attention_ragged",
                          "contiguous_split_kernel"),
                         ("prefill_attention", "prefill_tc_kernel")):
        by_name[name]["ptxas"] = {label: rep for label, rep in ptxas.items()
                                  if label.startswith(prefix)}
        if prefix in tc_ops:
            by_name[name]["tensor_core_instructions"] = tc_ops[prefix]
    by_name["paged_mixed_attention"]["decode_only"] = more[
        "fused_decode_only"]
    # #6 and #5 (padded) also serve engines: their launches on phase 14's
    # path, beside phase 13's
    by_name["prefill_attention"]["engine_launches"] = sum(
        modes[m]["launches"].get("contiguous_prefill", 0)
        for m in ("whole-prompt", "slab"))
    by_name["decode_attention_padded"]["engine_launches"] = modes["slab"][
        "launches"]["contiguous_decode_padded"]
    by_name["prefill_attention"]["engine_shape"] = modes["kernels"][
        "prefill"]
    by_name["decode_attention_padded"]["engine_shape"] = modes["kernels"][
        "decode_padded"]
    # #6 also trains: its launches on phase 22's path
    by_name["prefill_attention"]["train_launches"] = training["launches"][
        "contiguous_prefill"]
    # the same kernels at the MoE, VLM, window and whisper configs' heads
    kernels += family_rows(fam, moe, vlm, window, whisper)
    # #1 at a tp=2 rank's heads (12 / 4), launched by both ranks in 23 (a)
    k = fam["tp_rank"]
    kernels.append({
        "name": "paged_mixed_attention_tp2_rank", "ok": True,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mixed_attention.cu",
        "replaces": "src/repro/kernels/mixed_attention.py:187",
        "launches": tp["launches"]["leader"]["fused"],
        "worker_launches": tp["launches"]["worker"]["fused"],
        "shape": "llama3.2-3b at tp=2, a rank: H 12 / Hkv 4 / Dh 128 (G 3), "
                 "phase 3's segments",
        "max_abs_err": k["max_abs_err"],
        "max_abs_err_f32": k["max_abs_err_f32"], "ms": k["ms"],
        "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"], "bound_share": k["bound_ms"] / k["ms"],
        **{key: k[key] for key in ("device_ms", "library_device_ms",
                                   "host_us") if key in k}})
    # #6 at a model-parallel rank's heads (12 / 4), launched by both ranks
    # in 24 (a)
    k = fam["train_tp_rank"]
    ranks = sharded["big"]["ranks"]
    kernels.append({
        "name": "prefill_attention_tp2_rank", "ok": True, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/contiguous_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:125",
        "launches": ranks[0]["launches"],
        "worker_launches": ranks[1]["launches"],
        "shape": "llama3.2-3b at model 2, a rank: H 12 / Hkv 4 / Dh 128 "
                 "(G 3), B 2, T 1024 (phase 24 (a)'s training batch)",
        **{key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms", "tflops")
           if key in k},
        "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    # #6 and #5 at the dry run's shapes, launched by phase 25's programs
    dk_rows = fam["dryrun"]
    for k, name, src, tpu, launches, shape in (
            (dk_rows["prefill"], "prefill_attention_dryrun_32k",
             "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             dry["prefill_32k"]["launches"]["contiguous_prefill"],
             f"{DRYRUN_ARCH}: H 24 / Hkv 8 / Dh 128 (G 3), B 1, T 32768 "
             f"(prefill_32k cut to one row; held on {DRYRUN_ROWS} query "
             f"rows at 0, T/2 and the end; plain_ms on the last block)"),
            (dk_rows["decode"], "decode_attention_padded_dryrun_32k",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             dry["decode_32k"]["launches"]["contiguous_decode_padded"],
             f"{DRYRUN_ARCH}: G 3, 8 rows of 32768 keys (decode_32k cut to "
             f"8 rows)"),
            (dk_rows["ring"], "decode_attention_padded_dryrun_ring",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             dry["long_500k"]["launches"]["contiguous_decode_padded"],
             f"{DRYRUN_ARCH}: G 3, one row over long_500k's 8192-row "
             f"window ring")):
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches, "shape": shape,
            **{key: k[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms", "tflops",
                "stream_bound_ms", "plain_rows") if key in k},
            "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    # #6 on a model-parallel rank's (row, head) pairs, launched by both
    # ranks' prefill and train runs in phase 26 (a)
    k = fam["pairs"]
    pair_launches = [sum(part[shape]["ranks"][i]["launches"].get(
        "contiguous_prefill", 0) for shape in ("prefill_32k", "train_4k"))
        for i in range(2)]
    kernels.append({
        "name": "prefill_attention_pairs", "ok": True, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/contiguous_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:125",
        "launches": pair_launches[0], "worker_launches": pair_launches[1],
        "shape": f"{PART_ARCH} at model 2, a rank: 15 (row, head) pairs of "
                 f"one head, Dh 64, T {PART_PAIRS_T} (phase 26 (a)'s "
                 f"prefill)",
        **{key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms", "tflops")
           if key in k},
        "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    # #6 and #5 at a model-parallel rank's heads of qwen3-moe (16 / 2 /
    # 64, G 8), launched by both ranks' runs in phase 27 (a)
    ek = fam["moe_rank"]
    for k, name, key, shapes, shape in (
            (ek["prefill"], "prefill_attention_moe_rank", "contiguous_prefill",
             ("prefill_32k", "train_4k"),
             f"{MOE_ARCH} at model 2, a rank: H 16 / Hkv 2 / Dh 64 (G 8), "
             f"B 2, T {EP_CASES[0][2]} (phase 27 (a)'s prefill)"),
            (ek["decode_padded"], "decode_attention_padded_moe_rank",
             "contiguous_decode_padded", ("decode_32k",),
             f"{MOE_ARCH} at model 2, a rank: G 8, {EP_CASES[1][1]} rows "
             f"of {EP_CASES[1][2]} keys (phase 27 (a)'s decode)")):
        launches = [sum(ep[sh]["ranks"][i]["launches"].get(key, 0)
                        for sh in shapes) for i in range(2)]
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "contiguous_prefill.cu" if key == "contiguous_prefill"
                else "contiguous_decode.cu"),
            "replaces": ("src/repro/kernels/prefill_attention.py:125"
                         if key == "contiguous_prefill" else
                         "src/repro/kernels/decode_attention.py:291"),
            "launches": launches[0], "worker_launches": launches[1],
            "shape": shape,
            **{kk: k[kk] for kk in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms", "tflops",
                "stream_bound_ms") if kk in k},
            "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    # #6 and #5 at a model-parallel rank's heads of whisper (10 / 10 / 64,
    # G 1), launched by both ranks' runs in phase 28 (a)
    wk = fam["whisper_rank"]
    for k, name, key, shapes, src, tpu, shape in (
            (wk["prefill"], "prefill_attention_whisper_rank",
             "contiguous_prefill", ("prefill_32k", "train_4k"),
             "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             f"{WHISPER_ARCH} at model 2, a rank: H 10 / Hkv 10 / Dh 64 "
             f"(G 1), B 2, T {FAM_WHISPER_PROMPT} (phase 28 (a)'s "
             f"prefill)"),
            (wk["decode_padded"], "decode_attention_padded_whisper_rank",
             "contiguous_decode_padded", ("decode_32k",),
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             f"{WHISPER_ARCH} at model 2, a rank: G 1, {FAM_CASES[1][1]} "
             f"rows of {FAM_CASES[1][2]} self-KV keys (phase 28 (a)'s "
             f"decode)")):
        launches = [sum(families[f"{WHISPER_ARCH} {sh}"]["ranks"][i][
            "launches"].get(key, 0) for sh in shapes) for i in range(2)]
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[0],
            "worker_launches": launches[1], "shape": shape,
            **{kk: k[kk] for kk in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms", "tflops",
                "stream_bound_ms") if kk in k},
            "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    # #6 and #5 at a data rank's heads of qwen3-moe (32 / 4 / 64, G 8)
    # at (2, 1), launched by both ranks' runs in phase 29 (b)
    mk = fam["moe_data_rank"]
    (_, tb, tt), = OPT_CASES[1][3]
    (_, db, dt), = OPT_CASES[2][3]
    for k, name, key, shape_name, src, tpu, shape in (
            (mk["prefill"], "prefill_attention_moe_data_rank",
             "contiguous_prefill", "train_4k", "contiguous_prefill.cu",
             "src/repro/kernels/prefill_attention.py:125",
             f"{MOE_ARCH} at (data 2, model 1), a rank: H 32 / Hkv 4 / Dh "
             f"64 (G 8), B {tb // 2}, T {tt} (phase 29 (b)'s train step)"),
            (mk["decode_padded"], "decode_attention_padded_moe_data_rank",
             "contiguous_decode_padded", "decode_32k",
             "contiguous_decode.cu",
             "src/repro/kernels/decode_attention.py:291",
             f"{MOE_ARCH} at (data 2, model 1), a rank: G 8, {db // 2} rows "
             f"of {dt} keys (phase 29 (b)'s decode)")):
        launches = [sum(levers[f"{MOE_ARCH} {shape_name} {v}"]["ranks"][i][
            "launches"].get(key, 0) for v in ("base", "opt")
            if f"{MOE_ARCH} {shape_name} {v}" in levers) for i in range(2)]
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[0],
            "worker_launches": launches[1], "shape": shape,
            **{kk: k[kk] for kk in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms", "tflops",
                "stream_bound_ms") if kk in k},
            "kernel_ms": k["ms"], "bound_share": k["bound_ms"] / k["ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels, "engine": eng_summary,
         "cluster": cluster, "chaos_cluster": chaos,
         "grid_cluster": grid_cluster, "dense_int8": dense_int8,
         "fig2": fig2, "engine_modes": modes,
         "family_kernels": fam, "moe": moe, "vlm": vlm, "window": window,
         "rwkv": rwkv, "zamba": zamba, "whisper": whisper,
         "training": training, "tp": tp, "sharded_training": sharded,
         "dryrun": dry, "partition": part, "expert_parallel": ep,
         "families": families, "levers": levers},
        indent=1,
        default=str))
    log(f"chip_smoke: phases 1-29 took {time.perf_counter() - t_main:.1f} s")
    # the card again, so that the end of the output names it beside the
    # numbers
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
