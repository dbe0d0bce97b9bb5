#!/usr/bin/env python3
"""whisper-large-v3's cross K/V cache on a model axis of 2 in its two
layouts, traced on the CPU under fake tensors: what a rank's prefill and
decode step cost when the cache lies on the encoder's frames (the layout
``launch.shardings.cache_shardings`` gives it, which the port follows)
and when it lies on the kv heads (tensor parallelism's own heads).

    PYTHONPATH=src python3 tools/cross_layouts.py
    PYTHONPATH=src python3 tools/cross_layouts.py --layers 32 --json out.json

At ``chip_smoke.py`` phase 28 (a)'s cut by default (2 encoder and 2
decoder layers, bf16; a prefill of B 2 x 448 tokens over the 1500
frames, a decode step of B 8 against 4096 rows), rank 0's program of
each layout through ``launch.cases.build_case`` and ``launch.dryrun.
trace_case``: its collectives on the model group (count and wire bytes,
by op) and its traced FLOPs and bytes. The kv-heads layout is made by
keeping each rank's k / v heads as the cache (the prefill) and by
cutting the decode cache's cross leaves on their kv heads; the
cross-attention then takes its kv-heads path (``attention.
cross_attention_decode`` is told the layout by the cache's shape).
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cases import (adjusted_config, build_case,  # noqa: E402
                                      fake_scope)
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402

ARCH = "whisper-large-v3"


def _kv_heads_cache(case):
    """``case`` with its decode cache's cross K/V cut on the kv heads
    (the rank's half) instead of the frames."""
    params, cache, token, pos = case.args
    L, B, _, _, _ = cache.cross_kv.k.shape
    cfg = case.cfg
    shape = (L, B, cfg.encoder_seq, cfg.num_kv_heads // case.rank.model,
             cfg.head_dim)
    with fake_scope(case.mode):
        k = cache.cross_kv.k.new_zeros(shape)
        v = cache.cross_kv.v.new_zeros(shape)
    cache = cache._replace(cross_kv=KVCache(k, v))
    return dataclasses.replace(case, args=(params, cache, token, pos))


def _summary(traced) -> dict:
    on_model = [r for r in traced["records"]
                if r["name"].startswith("model/")]
    by_op: dict = {}
    for r in on_model:
        n, b = by_op.get(r["op"], (0, 0.0))
        by_op[r["op"]] = (n + 1, b + r["result_bytes"])
    return {"collectives": len(on_model),
            "collective_bytes": sum(b for _, b in by_op.values()),
            "by_op": {op: {"count": n, "bytes": b}
                      for op, (n, b) in sorted(by_op.items())},
            "flops": traced["flops"], "bytes": traced["bytes"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="encoder and decoder layers each")
    ap.add_argument("--prefill", default="2x448",
                    help="prefill batch x decoder tokens")
    ap.add_argument("--decode", default="8x4096",
                    help="decode batch x cache rows")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    layout = Layout({"data": 1, "model": 2})
    out = {"arch": ARCH, "layers": args.layers, "layout": "1x2",
           "rows": []}
    kept = attention.cross_cache_slice
    for shape, spec in (("prefill_32k", args.prefill),
                        ("decode_32k", args.decode)):
        B, T = (int(x) for x in spec.split("x"))
        cfg = dataclasses.replace(adjusted_config(ARCH, shape),
                                  num_layers=args.layers,
                                  encoder_layers=args.layers)
        for where in ("frames", "kv heads"):
            if where == "kv heads" and shape == "prefill_32k":
                # each rank keeps the k / v heads it projected
                attention.cross_cache_slice = (
                    lambda cfg, kv, cache_seq=None: kv)
            try:
                case = build_case(ARCH, shape, layout, cfg=cfg, batch=B,
                                  seq=T)
                if where == "kv heads" and shape == "decode_32k":
                    case = _kv_heads_cache(case)
                row = dict(shape=shape, batch=B, seq=T, cross=where,
                           **_summary(dryrun.trace_case(case)))
            finally:
                attention.cross_cache_slice = kept
            out["rows"].append(row)
            ops = ", ".join(f"{op} {v['count']} ({v['bytes'] / 1e6:.3f} MB)"
                            for op, v in row["by_op"].items())
            print(f"{shape:12s} B {B} x {T}: cross on {where:8s} "
                  f"{row['collectives']} collectives, "
                  f"{row['collective_bytes'] / 1e6:.3f} MB ({ops}); "
                  f"{row['flops'] / 1e9:.3f} GFLOP, "
                  f"{row['bytes'] / 1e9:.3f} GB traced", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
