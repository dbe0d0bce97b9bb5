#!/usr/bin/env python3
"""What splitting P into two bf16 parts buys the contiguous prefill kernel.

    python3 tools/profile_torch_prefill_split.py [--T 4096]

The bf16 tensor-core walk of ``csrc/contiguous_prefill.cu`` multiplies
P V twice, once with P rounded to bf16 and once with the remainder
(``TC_WALK_SPLIT_P=1``, the shipped build). This script builds the
source a second time with ``-DTC_WALK_SPLIT_P=0`` (P rounded once,
one product), runs both builds on the inputs of ``chip_smoke.py`` phase 3
(B 2, T 4096, llama3.2-3b heads, lengths 4096/4059, bf16, seeded on the
card), and prints for each: the max abs error against
``prefill_attention_plain``, the number of outputs outside
``atol = rtol = 5e-3`` and the device time (CUDA events, L2 flushed before
each launch, timed in turns: split, single, single, split). Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_variant(build, split: int) -> ctypes.CDLL:
    out = build.BUILD_DIR / "variants" / f"libcontiguous_prefill_split{split}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    f"-DTC_WALK_SPLIT_P={split}", "-o", str(out),
                    str(build.SOURCES["contiguous_prefill"])], check=True)
    fn = ctypes.CDLL(str(out)).repro_contiguous_prefill_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=4096)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import prefill_attention as pk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    H, Hkv, Dh = cs.FIG2_HEADS
    T, lens = args.T, cs.PREFILL_LENS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    q, k, v = (cs.randn(torch, gen, (2, T, n, Dh), torch.bfloat16)
               for n in (H, Hkv, Hkv))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    plain = pk.prefill_attention_plain(q, k, v, lengths).float()
    fns = {s: build_variant(build, s) for s in (1, 0)}
    stream = torch.cuda.current_stream().cuda_stream

    def run(split):
        out = torch.empty_like(q)
        rc = fns[split](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), 2, T, H, Hkv, Dh,
                        1, stream)
        if rc:
            raise RuntimeError(f"launch failed (cudaError {rc})")
        return out

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    times = {1: [], 0: []}
    for split in (1, 0, 0, 1):
        times[split].append(cs.time_ms(torch, lambda: run(split), 10, flush))
    for split, label in ((1, "split P (hi + lo)"), (0, "single bf16 P")):
        got = run(split).float()
        torch.cuda.synchronize()
        err = (got - plain).abs()
        bad = int((err > 5e-3 + 5e-3 * plain.abs()).sum().item())
        print(f"{label}: max_abs_err {err.max().item():.3e}, outside "
              f"5e-3: {bad} of {err.numel()}, ms {times[split]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
