"""A tensor-parallel worker: ranks 1..N-1 of a ``launch.mesh.TPMesh``.

    python -m repro_torch.launch.tp_worker --rank R --devices D0,D1,... \\
        --backend gloo --port P

``make_tp_mesh`` starts it; nobody else should. It joins the leader's
process group, then runs the commands the leader pickles into its stdin,
in order, until the pipe closes:

* ``("build", key, cfg, engine_kw, meta, matmul)``: receive this rank's
  weight shard (one host tensor per ``(path, shape, dtype)`` of
  ``meta``), move it to the device and build ``Engine(..., tp=N)`` on it
  (its share of the paged pool, its device mirrors);
* ``("call", key, op, args)``: run the engine's device op ``op``
  (``serving.engine._device_op``: a forward, a mirror write, pool rows
  written or read) on this rank's shard; a :class:`PieceShare` argument
  is received first, and a read op's piece goes back to the leader;
* ``("drop", key)``: forget an engine;
* ``("stats",)`` / ``("zero",)``: send the leader this rank's counters
  (:func:`stats`) / set them to 0.

A worker never reads tokens back to the host: it samples the same tokens
as the leader (the logits are all-gathered) and keeps them on the device.
An error ends the process with its traceback on stderr; the leader's
next collective or command then fails.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.api import launch_counts, zero_launch_counts
from repro_torch.launch.mesh import TPMesh, read_commands
from repro_torch.launch.shardings import param_leaves, params_from_leaves
from repro_torch.models.model import build_model
from repro_torch.serving import engine as engine_mod


def stats(mesh: TPMesh, engines: Dict[int, engine_mod.Engine]) -> dict:
    """This rank's counters: the kernel launches, attention-bearing
    forwards and device-to-host token reads since the last ``zero``, the
    forward's collectives (count, host seconds), the loaded modules of
    JAX or its package (none), each engine's pool and weight bytes (and
    the pool's leaf shapes), and on a card the peak memory allocated."""
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "launches": launch_counts(),
           "attn_calls": engine_mod.ATTN_CALLS,
           "d2h": engine_mod.D2H_CALLS,
           "coll_calls": mesh.coll_calls, "coll_s": mesh.coll_s,
           "forbidden_modules": sorted(
               n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "repro")),
           "engines": {key: {
               "pool_shapes": [tuple(a.shape) for a in e.cache],
               "pool_bytes": sum(a.numel() * a.element_size()
                                 for a in e.cache),
               "param_bytes": sum(a.numel() * a.element_size()
                                  for _, a in param_leaves(e.params))}
               for key, e in engines.items() if e.cache is not None}}
    if mesh.device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            mesh.device)
    return out


def zero(mesh: TPMesh) -> None:
    zero_launch_counts()
    engine_mod.ATTN_CALLS = 0
    engine_mod.D2H_CALLS = 0
    mesh.coll_calls = 0
    mesh.coll_s = 0.0
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)


def build(mesh: TPMesh, cfg, engine_kw: dict, meta: List[tuple],
          matmul: dict) -> engine_mod.Engine:
    """This rank's engine: the leader's matmul settings, the weight shard
    received leaf by leaf (host tensors, then the device)."""
    torch.backends.cuda.matmul.allow_tf32 = matmul["tf32"]
    torch.backends.cudnn.allow_tf32 = matmul["cudnn_tf32"]
    torch.set_num_threads(matmul["threads"])
    params = params_from_leaves(
        (path, mesh.recv(shape, dtype, 0).to(mesh.device))
        for path, shape, dtype in meta)
    return engine_mod.Engine(0, build_model(cfg), params, tp=mesh.size,
                             mesh=mesh, **engine_kw)


def call(mesh: TPMesh, eng: engine_mod.Engine, name: str,
         args: tuple) -> None:
    """Run device op ``name`` on this rank's engine, as the leader does:
    attention-bearing forwards through ``attn_call``; a read op's piece
    back to the leader."""
    args = tuple(a.kind(*(mesh.recv(s, d, 0) for s, d in a.leaves))
                 if isinstance(a, engine_mod.PieceShare) else a
                 for a in args)
    fn = getattr(eng, name)
    out = (engine_mod.attn_call(fn, *args) if name in engine_mod.ATTN_OPS
           else fn(*args))
    if getattr(getattr(type(eng), name), "tp_read", False):
        for a in out:
            mesh.send(a, 0)


def serve(mesh: TPMesh, commands) -> None:
    """Run the leader's commands (an iterator of tuples) to their end."""
    engines: Dict[int, engine_mod.Engine] = {}
    zero(mesh)
    for msg in commands:
        kind = msg[0]
        if kind == "build":
            _, key, cfg, engine_kw, meta, matmul = msg
            engines[key] = build(mesh, cfg, engine_kw, meta, matmul)
        elif kind == "call":
            _, key, name, args = msg
            call(mesh, engines[key], name, args)
        elif kind == "drop":
            engines.pop(msg[1], None)
        elif kind == "stats":
            mesh.send_obj(stats(mesh, engines), 0)
        elif kind == "zero":
            zero(mesh)
        else:
            raise ValueError(f"unknown command {kind!r}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--devices", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    device = torch.device(devices[args.rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = TPMesh.join(args.rank, devices, args.backend, args.port)
    with torch.no_grad():
        serve(mesh, read_commands(sys.stdin.buffer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
