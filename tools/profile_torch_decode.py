#!/usr/bin/env python3
"""Where the paged decode kernels' time goes on the card.

    python3 tools/profile_torch_decode.py [--iters 20] [--entries 1,7,208]
        [--items-per-run 4,8,16,32]

Runs the grid decode kernel (splits, merged by the last to finish), the
flat decode kernel
(work list given, as the engine gives it) and one
``scaled_dot_product_attention`` on ``chip_smoke.py`` phase 3's rows (decode
rows over 24, 3300, 650 and 770 tokens and a dead slot; llama3.2-3b heads,
bf16, block size 16). For each it prints the time from CUDA events around
each call with the L2 flushed before it (``chip_smoke.time_ms``), then the
device time of each kernel the call launched from ``torch.profiler`` (mean
per call), so the gap between events and kernels shows. ``--entries``
then times the grid kernel's C entry at other split sizes (P table
entries a split, S = ceil(NBT / P)): how its time scales with the tiles
one block walks. ``--items-per-run`` times the flat kernel at each run
length (``decode_attention.ITEMS_PER_RUN``), in turns forward and back,
events and device time, beside the grid kernel in the same turn. Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--entries", default="")
    ap.add_argument("--items-per-run", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels.ops import flat_work_list
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    H, Hkv, Dh = cs.FIG2_HEADS
    G, BS = H // Hkv, 16
    lens = [24, 3300, 650, 770, 0]
    q4, kp, vp, bt, ctx, seg, tags = cs.mixed_case(
        np, [("dec", n) for n in lens], 1, H, Hkv, Dh, BS, (2, 3, 10),
        cs.SEED)
    dev = torch.device("cuda")
    q, k_pool, v_pool = (torch.from_numpy(a).to(dev, torch.bfloat16)
                         for a in (q4[:, 0], kp, vp))
    bt_t = torch.from_numpy(bt).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    W = int(2 ** np.ceil(np.log2(sum(-(-n // BS) for n in lens))))
    work = flat_work_list(lengths, bt.shape[1], BS, W)
    kg, vg = cs.sdpa_inputs(torch, (k_pool, v_pool), bt_t, G)
    mask = (torch.arange(kg.shape[2], device=dev)[None]
            < lengths.clamp(min=1)[:, None])[:, None, None]
    calls = {
        "grid": lambda: dk.paged_decode_attention(q, k_pool, v_pool, bt_t,
                                                  lengths),
        "flat": lambda: dk.paged_decode_attention_flat(
            q, k_pool, v_pool, bt_t, lengths, num_work=W, work_list=work),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask),
    }
    S, P = dk.grid_split_plan(Hkv, bt.shape[1], BS, dk._sm_count(dev))
    print(f"rows {lens}, NBT {bt.shape[1]}, grid plan S {S}, P {P}")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32, device=dev)
    for name, fn in calls.items():
        ev = cs.time_ms(torch, fn, args.iters, flush)
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t and "fill" not in e.key.lower() and "zero" not in \
                    e.key.lower():
                kernels[e.key[:70]] = t / args.iters / 1e3
        print(f"{name}: events {ev:.4f} ms; device ms per call by kernel "
              f"{kernels}")
    from repro_torch.kernels import build
    fn = build.entry("decode_attention", "repro_paged_decode_attention", 9, 9)
    arrivals = torch.zeros(len(lens) * Hkv, dtype=torch.int32, device=dev)
    NBT = bt.shape[1]
    ref = calls["grid"]()
    for P in (int(x) for x in args.entries.split(",") if x):
        S = -(-NBT // P)
        part_acc = torch.empty(len(lens) * H * S * Dh, device=dev)
        part_ml = torch.empty(len(lens) * H * S * 2, device=dev)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    bt_t.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(),
                    part_ml.data_ptr(), arrivals.data_ptr(), out.data_ptr(),
                    len(lens), H, Hkv,
                    Dh, BS, NBT, S, P, 1, stream)
            assert rc == 0, rc
        call()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        print(f"grid at P {P} (S {S}): events "
              f"{cs.time_ms(torch, call, args.iters, flush):.4f} ms, "
              f"max abs vs the planned split {err:.3e}")
    sweep = [int(x) for x in args.items_per_run.split(",") if x]
    default, base = dk.ITEMS_PER_RUN, calls["flat"]()
    for turn in (sweep, sweep[::-1]):
        for ipr in turn:
            dk.ITEMS_PER_RUN = ipr
            out = calls["flat"]()
            torch.cuda.synchronize()
            err = (out.float() - base.float()).abs().max().item()
            flat = cs.time_ms(torch, calls["flat"], args.iters, flush,
                              device=True)
            grid = cs.time_ms(torch, calls["grid"], args.iters, flush,
                              device=True)
            print(f"flat at ITEMS_PER_RUN {ipr} ({-(-W // ipr)} runs): "
                  f"events {flat:.4f} ms, device {flat.device:.4f}; grid "
                  f"beside it {grid:.4f} / {grid.device:.4f}; max abs vs "
                  f"{default} items a run {err:.3e}")
    dk.ITEMS_PER_RUN = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
