#!/usr/bin/env python3
"""Witnesses for the sharded training step at a family's published
widths: how far apart runs of the same f32 training steps land when only
the order of their f32 reductions differs, beside a float64 run of the
same function.

    python3 tools/gather_witness.py                     # rwkv6-7b, the card
    python3 tools/gather_witness.py --device cpu --d-model 1024 --d-ff 3584

For ``--arch`` (default rwkv6-7b) cut to ``--layers`` layers, with the
weights drawn once from ``--seed`` on ``--device`` (and copied to the
CPU) and the same ``TokenStream`` batches, it runs ``--steps`` AdamW
steps (lr 3e-4, warmup 1, eps 1e-5, B 2 x T 64: ``chip_smoke.py`` phase
24 (b)'s setting) as:

* ``f64``: the port's unsharded step on the CPU with every tensor in
  float64 (the port's f32 casts lifted for the run): the witness;
* ``f64 chunked``: the same through the card's chunked recurrence
  (rwkv6's WKV, zamba2's SSD);
* ``f64 moved``: the f64 run from weights each moved by one part in
  ``1 / --nudge`` (random signs, about one f32 rounding): how far the
  exact function itself carries a difference of that size;
* ``cpu f32``: the unsharded f32 step on the CPU (phase 24 (b)'s
  reference: the sequential recurrence), and ``cpu f32 chunked``;
* ``card f32 #i``: the unsharded f32 step on ``--device``, ``--repeats``
  times (skipped on the CPU);
* ``sharded #i``: the (data 1, model 2) sharded step, two ranks on
  ``--device`` over gloo, ``--sharded`` times.

Per run it prints each step's loss and gradient norm with their relative
gaps to the f64 run, the params' gap after the last step (the largest
|diff| over max(1, |leaf|), as phase 24 (b) measures it) and, for the
leaves of under ``SMALL_LEAF`` elements, each step's relative gradient
gap to the f64 run; ``--json`` writes it all.
"""
import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, mamba2, rwkv6  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            adamw_update, init_adamw)
from repro_torch.training.trainer import batch_to  # noqa: E402

SMALL_LEAF = 1 << 20           # leaves whose gradients are kept per step
_LIFTED = ("zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
           "empty", "empty_like", "arange")


@contextlib.contextmanager
def float64_everywhere():
    """While open, ``Tensor.float()`` keeps a float64 tensor and the
    factories in ``_LIFTED`` make float64 where asked for float32."""
    saved = {n: getattr(torch, n) for n in _LIFTED}
    as_float = torch.Tensor.float

    def lift(fn):
        def made(*a, **k):
            if k.get("dtype") is torch.float32:
                k["dtype"] = torch.float64
            return fn(*a, **k)
        return made
    for n, fn in saved.items():
        setattr(torch, n, lift(fn))
    torch.Tensor.float = (lambda self, *a, **k: self
                          if self.dtype == torch.float64
                          else as_float(self, *a, **k))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch, n, fn)
        torch.Tensor.float = as_float


@contextlib.contextmanager
def chunked_recurrence(on: bool):
    """While open (``on``), rwkv6's WKV and zamba2's SSD take the chunked
    form the card runs, on any device."""
    if not on:
        yield
        return
    wkv, pick = rwkv6.time_mix_seq, mamba2.default_chunk
    rwkv6.time_mix_seq = functools.partial(wkv, chunk=rwkv6.WKV_CHUNK)
    mamba2.default_chunk = lambda cfg, T, device: cfg.ssm_chunk or \
        mamba2.SSD_CHUNK
    try:
        yield
    finally:
        rwkv6.time_mix_seq, mamba2.default_chunk = wkv, pick


def _paths(tree, prefix=""):
    """(path, leaf) in sorted key order (``tree_leaves``' order)."""
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], p)
        else:
            yield p, tree[k]


def _like(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return {k: _like(tree[k], leaves) for k in sorted(tree)}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def steps(model, params, batches, opt_cfg):
    """The unsharded step (``make_train_step``'s) on ``params`` in place,
    keeping per step the loss, the gradient norm and the small leaves'
    gradients (f64, on the host)."""
    opt = init_adamw(params)
    hist = []
    for batch in batches:
        named = list(_paths(params))
        leaves = [p.requires_grad_() for _, p in named]
        with torch.enable_grad():
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        small = {path: g.detach().double().cpu()
                 for (path, _), g in zip(named, grads)
                 if g.numel() < SMALL_LEAF}
        params, opt, info = adamw_update(opt_cfg, _like(params, iter(grads)),
                                         opt, params)
        hist.append({"loss": float(loss), "grad_norm":
                     float(info["grad_norm"]), "small": small})
    return hist, params


def params_gap(got, want):
    """The largest |got - want| over the leaves, each over max(1, its
    largest magnitude in ``want``)."""
    g, w = dict(_paths(got)), dict(_paths(want))
    return max(float((g[k].detach().double().cpu()
                      - w[k].detach().double().cpu()).abs().max())
               / max(1.0, float(w[k].detach().abs().max())) for k in w)


def report(name, hist, params, ref, ref_params, wall):
    """One run against the f64 run: printed, and returned as a record."""
    rec = {"run": name, "wall_s": wall, "steps": []}
    for i, (h, r) in enumerate(zip(hist, ref), 1):
        row = {"step": i, "loss": h["loss"], "grad_norm": h["grad_norm"],
               "loss_gap": abs(h["loss"] - r["loss"]) / abs(r["loss"]),
               "grad_norm_gap": abs(h["grad_norm"] - r["grad_norm"])
               / abs(r["grad_norm"])}
        if "small" in h:
            row["leaf_grad_gaps"] = {
                k: float((h["small"][k] - g).norm()
                         / max(float(g.norm()), 1e-300))
                for k, g in r["small"].items()}
        rec["steps"].append(row)
        worst = sorted(row.get("leaf_grad_gaps", {}).items(),
                       key=lambda kv: -kv[1])[:3]
        print(f"{name:18s} step {i}: loss {h['loss']:.9f} "
              f"(gap {row['loss_gap']:.2e}) grad norm {h['grad_norm']:.6f} "
              f"(gap {row['grad_norm_gap']:.2e}); leaves parting most "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)
    rec["params_gap"] = params_gap(params, ref_params)
    print(f"{name:18s} params gap {rec['params_gap']:.3e}; {wall:.1f} s",
          flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (a quick CPU check)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="narrower than published (0: the config's)")
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nudge", type=float, default=1e7)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sharded", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    over = {k: v for k, v in (("d_model", args.d_model), ("d_ff", args.d_ff),
                              ("vocab_size", args.vocab)) if v}
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, num_layers=args.layers,
                              dtype=torch.float32, **over)
    opt_cfg = AdamWConfig(lr=3e-4, eps=1e-5, warmup_steps=1,
                          total_steps=args.steps)
    data = DataConfig(batch_size=2, seq_len=64, seed=args.seed)
    it = iter(TokenStream(cfg, data))
    host_batches = [next(it) for _ in range(args.steps)]
    model = build_model(cfg)
    drawn = model.init(args.seed, device=args.device)
    init = _map(drawn, lambda t: t.detach().cpu().clone())
    del drawn
    n = sum(p.numel() for _, p in _paths(init))
    print(f"{cfg.name}: {args.layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps of B 2 x 64, weights from seed {args.seed} "
          f"on {args.device}", flush=True)
    out = {"arch": cfg.name, "layers": args.layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n,
           "device": args.device, "runs": []}
    if args.device.startswith("cuda"):
        out["card"] = torch.cuda.get_device_name(0)

    def keep(rec):
        out["runs"].append(rec)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(out, indent=1))

    def cpu_run(dtype, chunked, moved=False):
        gen = torch.Generator().manual_seed(args.seed + 1)
        params = _map(init, lambda t: t.to(dtype).clone())
        if moved:
            params = _map(params, lambda t: t * (1 + torch.where(
                torch.rand(t.shape, generator=gen) < 0.5, -1.0, 1.0)
                .to(dtype) / args.nudge))
        m = build_model(dataclasses.replace(cfg, dtype=dtype))
        batches = [{k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in batch_to(b, "cpu").items()}
                   for b in host_batches]
        lift = (float64_everywhere() if dtype == torch.float64
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with lift, chunked_recurrence(chunked):
            hist, params = steps(m, params, batches, opt_cfg)
        return hist, params, time.perf_counter() - t0

    ref, ref_params, wall = cpu_run(torch.float64, False)
    keep(report("f64", ref, ref_params, ref, ref_params, wall))
    for name, dtype, chunked, moved in (
            ("f64 chunked", torch.float64, True, False),
            ("f64 moved", torch.float64, False, True),
            ("cpu f32", torch.float32, False, False),
            ("cpu f32 chunked", torch.float32, True, False)):
        hist, params, wall = cpu_run(dtype, chunked, moved)
        keep(report(name, hist, params, ref, ref_params, wall))
        del params
    if args.device != "cpu":
        for i in range(args.repeats):
            params = _map(init, lambda t: t.to(args.device))
            batches = [batch_to(b, args.device) for b in host_batches]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist, params = steps(model, params, batches, opt_cfg)
            torch.cuda.synchronize()
            keep(report(f"card f32 #{i + 1}", hist, params, ref, ref_params,
                        time.perf_counter() - t0))
            del params
            torch.cuda.empty_cache()
    if args.sharded:
        from repro_torch.launch.mesh import make_train_mesh
        from repro_torch.training.trainer import ShardedRun, train_sharded
        dev = "cuda:0" if args.device == "cuda" else args.device
        mesh = make_train_mesh(2, [dev] * 2)
        try:
            for i in range(args.sharded):
                t0 = time.perf_counter()
                res = mesh.run(train_sharded, ShardedRun(
                    cfg, args.steps, opt_cfg, data, init=args.seed,
                    gather=True), layout=(1, 2))
                out["mechanism"] = res[0]["mechanism"]
                keep(report(f"sharded #{i + 1}", res[0]["history"],
                            res[0]["params"], ref, ref_params,
                            time.perf_counter() - t0))
                del res
        finally:
            mesh.close()
    return out


if __name__ == "__main__":
    main()
