"""Multi-pod dry run — the port's counterpart of ``repro.launch.dryrun``:
every (architecture × input shape) on the production layouts, one rank's
program counted and priced on the H100.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out /tmp/dryrun_torch.json [--jobs 4]

**It needs no card.** This entry point runs no kernel and allocates no
device memory, because it is the counterpart of the reference's lowering:
it runs on the CPU wherever it is started, unlike the port's other entry
points, which run on the card unless asked for the CPU.

Where the reference lowers and compiles the global step on 512 forced
host devices, the port traces one rank's program (``launch.cases.
build_case``) once, on fake tensors on the meta device (``FakeTensorMode``:
shapes and dtypes, no storage), under three counting modes:

  * ``FlopCounterMode``: the program's FLOPs -> ``flops_hlo_per_chip``;
  * :class:`Traffic`: every op's operand and result bytes (views and
    allocations that read nothing excluded; gathers and in-place
    scatters by the rows they address), what XLA's "bytes accessed"
    sums -> ``bytes_hlo_per_chip``; and the peak of live bytes above the
    arguments, found through weak references to the storages the ops
    make -> ``temp_bytes_per_chip`` (the counterpart of
    ``temp_size_in_bytes``; it includes the outputs while they are live);
  * the rank's recording groups (``launch.mesh.RecordingCollectives``):
    its collectives, priced by ``launch.roofline.collective_wire_bytes``.

The meta device stands for the card (``models.common.card_device``), so
what is counted is the card's program: the recurrences' chunked forms,
and #5 and #6 as one op each (their operators, ``kernels.ops.LIBRARY``:
a kernel's operands and result, and the FLOPs of the products it needs,
the causal half of a prompt's scores for #6); #6's backward in a train
step is its plain version, as on the card. The counted numbers differ
from the analytic ones by terms that can be named: a decode's traced
FLOPs are ``analytic_flops_global`` less ``2·V·d·B`` (the embedding
lookup, no product), and a prefill's also lack the unembedding of every
token but each row's last and the keys past each query, which the
formula counts in full.

Rows keep the reference's keys (``launch.roofline.Roofline.row`` plus
``status``, ``optimized``, ``output_bytes``); ``t_trace`` (build and
trace) takes the place of ``t_lower`` + ``t_compile``, and ``args/chip``
is printed against the card's 80 GB; ``plan`` and ``plan_axes`` carry
the case's ``training.trainer.Plan`` (each block split or gathered on
the model axis, where the core and the decode cache split), so a row
names what its rank still gathers, and ``weight_gathers`` counts the
all-gathers whose operand is a weight leaf. ``--opt`` traces the
optimized program (``launch.cases.build_case(optimized=True)``: the
reference's beyond-paper levers); its rows carry ``optimized`` true and
``levers``, the names of the levers the case took.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS
from repro_torch.launch.cases import (SHAPES, adjusted_config, build_case,
                                      fake_scope, shape_kind, skip_reason)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (Roofline, analytic_flops_global,
                                         analytic_min_bytes,
                                         collective_wire_bytes, model_flops)
from repro_torch.models.attention import rope_freqs
from repro_torch.models.model import build_model

ASSIGNED = [a for a in ARCHS if a != "llama3.2-3b"]

CARD_BYTES = 80e9                   # the H100's 80 GB of HBM3

# ops that allocate without reading, or alias: no traffic of their own
# (as view ops, and ops that return no tensor, such as ``prim.device``)
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view")
# ops that read (gathers) or write in place (scatters) their first operand
# at indices: the rows addressed move, not the whole tensor, as XLA's
# "bytes accessed" counts a gather and a dynamic-update-slice
_GATHERS = ("embedding", "index", "index_select", "gather")
_SCATTERS = ("index_put_", "index_copy_", "scatter_")


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Traffic(TorchDispatchMode):
    """Counts, over the ops run under it, the bytes each op reads and
    writes (``bytes``: its tensor operands' and results' bytes; view ops,
    allocations that read nothing and ops that return no tensor count
    0; a gather its indices and twice its result, an in-place scatter its
    indices and twice its values) and the peak of the bytes
    held by storages the ops made and that are still alive (``peak``).
    Storages in ``skip`` (the arguments') are not counted. A storage's
    life is followed through a weak reference to it, checked whenever the
    bytes counted as live would set a new peak."""

    def __init__(self, skip=()):
        super().__init__()
        self.bytes = 0.0
        self.ops = 0
        self.skip = set(skip)
        self.live: Dict[int, tuple] = {}
        self.held = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.prim.device.default:
            return out                   # a metadata query: no op
        self.ops += 1
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if outs and not func.is_view and name not in _NO_TRAFFIC:
            rest = sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
            if name in _GATHERS:          # the rows read, then written
                self.bytes += rest + 2 * sum(_nbytes(t) for t in outs)
            elif name in _SCATTERS:       # indices and values read, written
                self.bytes += rest + sum(_nbytes(t) for t in
                                         _tensors(args[-1]))
            else:
                self.bytes += rest + sum(_nbytes(t) for t in
                                         _tensors(args[:1]) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.skip:
                continue
            known = self.live.get(key)
            if known is not None and not known[0].expired():
                continue
            self.live[key] = (StorageWeakRef(st), st.nbytes())
            self.held += st.nbytes()
        if self.held > self.peak:
            self.live = {k: v for k, v in self.live.items()
                         if not v[0].expired()}
            self.held = sum(nb for _, nb in self.live.values())
            self.peak = max(self.peak, self.held)
        return out


def storages(tree) -> set:
    """The storage keys of every tensor of ``tree``."""
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


def warm_caches(case) -> None:
    """Fill the models' caches the case's program reads (the rotary
    frequencies of its head dim, on its device) before a counted run, so
    that no counted run pays for them, in whatever process or thread the
    cache was last cleared (``launch.cases.fake_scope`` clears it)."""
    if case.cfg.num_heads:
        dev = _tensors(case.args)[0].device
        rope_freqs(case.cfg.head_dim, case.cfg.rope_theta, dev)


@contextlib.contextmanager
def weight_gathers(group, params):
    """Within it, each all-gather on ``group`` whose operand is (a view
    of) a leaf of ``params`` appends the operand's shape to the list it
    yields: the weights a rank's program gathers."""
    found = []
    if group is None:
        yield found
        return
    leaves = storages(params)
    inner = group.all_gather

    def all_gather(x, dim=-1):
        if x.untyped_storage()._cdata in leaves:
            found.append(tuple(x.shape))
        return inner(x, dim)
    group.all_gather = all_gather
    try:
        yield found
    finally:
        del group.all_gather


def trace_case(case) -> dict:
    """Run ``case``'s program once under its fake-tensor mode and the
    counting modes. Returns ``flops``, ``bytes`` (operand + result bytes
    of every op), ``temp_bytes`` (the peak of live bytes above the
    arguments), ``output_bytes``, the collective ``records``, the shapes
    of the weight leaves it all-gathers (``weight_gathers``) and the
    number of ``ops``."""
    from torch.utils.flop_counter import FlopCounterMode
    case.rank.records.clear()
    with fake_scope(case.mode):
        warm_caches(case)
        traffic = Traffic(storages(case.args))
        with FlopCounterMode(display=False) as fc, traffic, weight_gathers(
                case.rank.model_group, case.args[0]) as gathered:
            out = case.fn(*case.args)
        seen = set()
        out_bytes = 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                out_bytes += st.nbytes()
    return {"flops": float(fc.get_total_flops()), "bytes": traffic.bytes,
            "temp_bytes": float(traffic.peak), "output_bytes": float(out_bytes),
            "records": list(case.rank.records), "ops": traffic.ops,
            "weight_gathers": gathered}


def roofline_of(case, traced: dict, mesh_name: str, layout) -> Roofline:
    """The roofline of a traced case on ``layout``: compute from the
    analytic FLOPs over the chips, memory from the larger of the traced
    bytes and the analytic floor, the recorded collectives' wire bytes
    (the reference's choice of terms)."""
    chips = 1
    for n in layout.shape.values():
        chips *= n
    cfg, shape = case.cfg, case.shape_name
    floor = analytic_min_bytes(cfg, shape, case.seq, case.batch,
                               dict(layout.shape))
    return Roofline(
        arch=case.arch, shape=shape, mesh=mesh_name,
        flops_per_chip=analytic_flops_global(cfg, shape, case.seq,
                                             case.batch) / chips,
        bytes_per_chip=max(traced["bytes"], floor),
        collective_bytes_per_chip=collective_wire_bytes(traced["records"]),
        num_chips=chips,
        model_flops_global=model_flops(cfg, shape, case.seq, case.batch),
        flops_hlo_per_chip=traced["flops"],
        bytes_hlo_per_chip=traced["bytes"],
        n_collectives=len(traced["records"]),
        temp_bytes_per_chip=traced["temp_bytes"],
        arg_bytes_per_chip=case.arg_bytes)


def run_case(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, optimized: bool = False, *,
             layout=None, **case_kwargs) -> dict:
    """One row: rank 0's program of (arch, shape) on the production
    layout (``layout`` overrides it; ``case_kwargs`` go to
    ``build_case``: ``cfg``, ``seq``, ``batch``) traced and priced;
    ``optimized`` traces the program with the reference's beyond-paper
    levers. A failure is a row of status ``fail``."""
    if layout is None:
        layout = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        mesh_name = "x".join(str(n) for n in layout.shape.values())
    reason = skip_reason(arch, shape_name)
    if reason:
        return dict(arch=arch, shape=shape_name, mesh=mesh_name,
                    status="skipped", reason=reason)
    t0 = time.time()
    try:
        case = build_case(arch, shape_name, layout, optimized,
                          **case_kwargs)
        traced = trace_case(case)
        t_trace = time.time() - t0
        rl = roofline_of(case, traced, mesh_name, layout)
        row = rl.row()
        row.update(status="ok", optimized=optimized, t_trace=t_trace,
                   levers=list(case.levers.taken()) if case.levers else [],
                   output_bytes=traced["output_bytes"],
                   mechanism=case.mechanism,
                   plan=dict(case.plan.blocks),
                   plan_axes=dict(case.plan.axes), rank_rows=case.rows,
                   context_parallel=case.context_parallel,
                   traced_ops=traced["ops"],
                   weight_gathers=len(traced["weight_gathers"]))
        if verbose:
            print(f"[ok{'/opt' if optimized else ''}] {arch:22s} "
                  f"{shape_name:12s} {mesh_name:8s} "
                  f"comp={rl.t_compute:.3e}s mem={rl.t_memory:.3e}s "
                  f"coll={rl.t_collective:.3e}s dom={rl.dominant:10s} "
                  f"args/chip={rl.arg_bytes_per_chip / 1e9:.2f} of "
                  f"{CARD_BYTES / 1e9:.0f} GB "
                  f"temp/chip={rl.temp_bytes_per_chip / 1e9:.2f} GB "
                  f"({case.mechanism}; trace {t_trace:.1f}s)", flush=True)
        return row
    except Exception as e:  # noqa: BLE001 — report, don't abort the sweep
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_name}: {e}", flush=True)
            traceback.print_exc()
        return dict(arch=arch, shape=shape_name, mesh=mesh_name,
                    status="fail", error=f"{type(e).__name__}: {e}")


def _finite(tree) -> bool:
    """Every float tensor of ``tree`` finite (one f32 sum a tensor)."""
    return all(bool(torch.isfinite(t.sum(dtype=torch.float32)))
               for t in _tensors(tree) if t.is_floating_point())


def run_rank(mesh, arch: str, shape_name: str, *, batch: int,
             seq: Optional[int] = None, seed: int = 0, runs: int = 3,
             cfg=None, optimized: bool = False) -> dict:
    """One rank's part of running a case's program for real on a
    ``launch.mesh.TrainMesh`` (every rank runs it: ``mesh.run(run_rank,
    ...)``): ``launch.cases.build_case`` on this rank, its groups real,
    its tensors on its device (weights from ``seed``), at the global
    ``batch`` and ``seq`` (``cfg`` replaces the case's config;
    ``optimized``: the program with the reference's levers). One warm
    run under ``FlopCounterMode`` and :class:`Traffic` (the counts its
    trace at the same layout gives), then ``runs`` runs timed by CUDA
    events on a card (the host clock elsewhere). Returns the rank, its
    mechanism and plan, the warm run's FLOPs, bytes, launches and
    collectives a group, whether its outputs are finite, each timed run's
    ms, the timed runs' launches and collectives a group (count, host
    seconds), and the peak memory (a card)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.api import launch_counts, zero_launch_counts
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    case = build_case(arch, shape_name, mesh, optimized, batch=batch,
                      seq=seq, cfg=cfg, device=dev, seed=seed)
    groups = {axis: g for axis, g in (("model", mesh.model_group),
                                      ("data", mesh.data_group))
              if g is not None}

    def zero():
        zero_launch_counts()
        for g in groups.values():
            g.coll_calls, g.coll_s = 0, 0.0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    sync()
    zero()
    warm_caches(case)
    traffic = Traffic(storages(case.args))
    with FlopCounterMode(display=False) as fc, traffic:
        out = case.fn(*case.args)
    sync()
    warm = {"flops": float(fc.get_total_flops()), "bytes": traffic.bytes,
            "launches": launch_counts(),
            "collectives": {a: g.coll_calls for a, g in groups.items()},
            "finite": _finite(out)}
    del out
    zero()
    ms = []
    for _ in range(runs):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            case.fn(*case.args)
            end.record()
            sync()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            case.fn(*case.args)
            ms.append((time.perf_counter() - t0) * 1e3)
    out = {"rank": mesh.rank, "mechanism": case.mechanism,
           "levers": list(case.levers.taken()) if case.levers else [],
           "plan": dict(case.plan.blocks), "axes": dict(case.plan.axes),
           "rows": case.rows, "warm": warm, "ms": ms,
           "launches": launch_counts(),
           "collectives": {a: (g.coll_calls, g.coll_s)
                           for a, g in groups.items()},
           "arg_bytes": case.arg_bytes}
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap between two tensors over the larger of 1 and
    ``want``'s largest magnitude."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _whole_of(piece: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A cache leaf whole from this rank's ``piece`` of it under ``spec``
    (each split dim all-gathered over its group)."""
    for d, ax in enumerate(spec):
        group = {"model": mesh.model_group, "data": mesh.data_group}.get(ax)
        if group is not None:
            piece = group.all_gather(piece.contiguous(), d)
    return piece


def run_pair(mesh, arch: str, shape_name: str, *, batch: int,
             seq: Optional[int] = None, seed: int = 0, cfg=None) -> dict:
    """One rank's baseline and optimized programs of a case on a
    ``launch.mesh.TrainMesh`` (every rank runs it: ``mesh.run(run_pair,
    ...)``), on the same inputs: the same weights and rows (``seed``), and
    for a decode one whole cache drawn from ``seed`` on the rank's device
    and cut by each program's layout (``launch.shardings.cache_shardings``
    with ``seq_on_model`` the optimized one's). Runs each once and returns
    the optimized program's levers and the largest gap (relative to the
    baseline's largest magnitude, at least 1) of each output: a train
    step's metrics and, on rank 0, its params and moments gathered whole;
    a decode's logits and its cache slice against the baseline's updated
    slices gathered whole and cut by the optimized layout."""
    from repro_torch.launch.cases import _zip_map
    from repro_torch.launch.shardings import cache_shardings, local_shard
    dev = mesh.device
    kind = shape_kind(shape_name)
    T = seq or SHAPES[shape_name]["seq_len"]
    outs, levers = {}, None
    whole = None
    for optimized in (False, True):
        case = build_case(arch, shape_name, mesh, optimized, batch=batch,
                          seq=T, cfg=cfg, device=dev, seed=seed)
        levers = case.levers
        if kind == "train":
            params, opt, m = case.fn(*case.args)
            outs[optimized] = {
                "metrics": {k: v.detach().float().cpu()
                            for k, v in m.items()},
                "params": case.step.gather(params),
                "mu": case.step.gather(opt.mu, True),
                "nu": case.step.gather(opt.nu, True)}
            del case, params, opt, m      # one program's state at a time
            continue
        params, _, token, pos = case.args
        cfg_ = case.cfg
        S = min(T, cfg_.sliding_window) if cfg_.sliding_window else T
        if whole is None:
            whole = build_model(cfg_).init_cache(batch, T, device=dev)
            gen = torch.Generator(device=dev).manual_seed(seed + 29)
            for leaf in tree_leaves(whole):
                leaf.normal_(generator=gen)
        specs = cache_shardings(whole, mesh, batch_size=batch, cache_seq=S,
                                context_parallel=batch == 1,
                                seq_on_model=optimized)
        cache = _zip_map(lambda a, s: local_shard(a, s, mesh).clone(),
                         whole, specs)
        logits, cache = case.fn(params, cache, token, pos)
        outs[optimized] = {"logits": logits, "cache": cache,
                           "specs": specs}
        del case, params
    base, opt = outs[False], outs[True]
    if kind == "train":
        gaps = {"metrics": max(_gap(opt["metrics"][k], v)
                               for k, v in base["metrics"].items())}
        if base["params"] is not None:
            for part in ("params", "mu", "nu"):
                gaps[part] = max(_gap(a, b) for a, b in zip(
                    tree_leaves(opt[part]), tree_leaves(base[part])))
    else:
        updated = _zip_map(lambda a, s: _whole_of(a, s, mesh),
                           base["cache"], base["specs"])
        want = _zip_map(lambda a, s: local_shard(a, s, mesh), updated,
                        opt["specs"])
        gaps = {"logits": _gap(opt["logits"], base["logits"]),
                "cache": max(_gap(a, b) for a, b in zip(
                    tree_leaves(opt["cache"]), tree_leaves(want)))}
    return {"rank": mesh.rank,
            "levers": list(levers.taken()) if levers else [], "gaps": gaps}


def _cost_rank(job) -> int:
    """Longest traces first: the recurrent families' chunk loops, then
    the train steps."""
    arch, shape = job[:2]
    family = adjusted_config(arch, shape).family
    return (0 if family in ("hybrid", "ssm") else 1,
            0 if shape_kind(shape) == "train" else 1)


def run_cases(jobs, n_jobs: int = 1) -> list:
    """:func:`run_case` over ``(arch, shape, multi_pod[, verbose,
    optimized])`` jobs, in their order; with ``n_jobs`` > 1 in that many
    processes (spawned), the longest first."""
    if n_jobs <= 1:
        return [run_case(*job) for job in jobs]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    order = sorted(range(len(jobs)), key=lambda i: _cost_rank(jobs[i]))
    with ProcessPoolExecutor(n_jobs, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {i: pool.submit(run_case, *jobs[i]) for i in order}
        return [futures[i].result() for i in range(len(jobs))]


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Trace one rank's program of every (arch x shape) on "
                    "the production layouts, on the CPU, and price it on "
                    "the H100")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases traced at once, each in a process of its "
                         "own (default 1: one after another, here)")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's beyond-paper sharding levers "
                         "(launch.cases.choose_levers)")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    jobs = [(arch, shape, mp, True, args.opt) for mp in meshes
            for arch in archs for shape in shapes]
    rows = run_cases(jobs, args.jobs)
    ok = sum(1 for r in rows if r["status"] == "ok")
    skip = sum(1 for r in rows if r["status"] == "skipped")
    fail = sum(1 for r in rows if r["status"] == "fail")
    print(f"\n== dry-run: {ok} ok / {skip} skipped / {fail} FAILED "
          f"of {len(rows)} ({time.time() - t0:.1f} s)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print("wrote", args.out)
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
