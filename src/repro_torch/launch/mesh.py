"""Tensor-parallel process groups for serving — the port's counterpart of
``repro.launch.mesh.make_tp_mesh``.

JAX drives every device of a mesh from one process; PyTorch runs one
process per rank. A tensor-parallel engine's *leader* (rank 0: the
process that owns the ``Engine`` and all of its host state) starts ranks
``1..N-1`` as worker processes, ``python -m repro_torch.launch.tp_worker``
(a fresh interpreter, not a fork: a worker loads nothing its leader had
imported), and joins them in a process group of its own, built on its
own TCP store at a free loopback port, so several meshes coexist in one
process (one per tensor-parallel engine of a heterogeneous cluster).

Three channels connect the ranks:

* **commands**: the leader pickles each command (an op name and host
  values: ints, lists, integer arrays) into every worker's stdin. A
  worker waits for its next command without a timeout and exits when
  the pipe closes, which it does when the leader goes away;
* **host tensors** (weights once, KV pieces on migration and the host
  tier, replies): CPU tensors point to point over a gloo group;
* **activations**: the forward's all-reduces and all-gathers on the
  ranks' devices, over ``backend``: ``"gloo"`` (CPU tensors, or CUDA
  tensors staged through host memory, which lets two ranks share one
  card) or ``"nccl"`` (one rank per card).

Every collective and every point-to-point wait has the mesh's timeout;
a worker that dies breaks its connections, so the leader's next
collective fails instead of hanging. Nothing here runs at import.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import weakref
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# every wait of a mesh: rendezvous, collectives, point-to-point transfers
# (the longest is a worker's weight shard: seconds for 3.2 GB)
TIMEOUT = datetime.timedelta(seconds=300)
_SRC = str(Path(__file__).resolve().parents[2])


def default_devices(tp: int, device_type: str) -> List[str]:
    """One device per rank: ``cuda:0..tp-1``, refused when fewer cards
    are present (list them, e.g. ``cuda:0,cuda:0``, to put ranks on one
    card); the CPU is one device that holds any number of ranks."""
    if device_type == "cpu":
        return ["cpu"] * tp
    n = torch.cuda.device_count()
    if tp > n:
        raise ValueError(f"tp={tp} needs {tp} devices, have {n}; list the "
                         f"devices (e.g. cuda:0,cuda:0) to share one")
    return [f"cuda:{i}" for i in range(tp)]


def _gloo(store, rank: int, size: int):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = TIMEOUT
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(store, rank, size, opts)


class TPMesh:
    """One tensor-parallel group: ``size`` ranks, this process' ``rank``,
    one device string per rank. The leader's instance also holds its
    workers' processes. Built by :func:`make_tp_mesh` (leader) or
    :meth:`join` (a worker)."""

    def __init__(self, rank: int, devices: Sequence[str], backend: str,
                 store, procs=()):
        self.rank = rank
        self.size = len(devices)
        self.devices = list(devices)
        self.device = torch.device(devices[rank])
        self.backend = backend
        self._store = store
        self._host = _gloo(dist.PrefixStore("host", store), rank, self.size)
        if backend == "gloo":
            self._act = self._host
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = TIMEOUT
            self._act = dist.ProcessGroupNCCL(
                dist.PrefixStore("act", store), rank, self.size, opts)
        self._procs = list(procs)
        self._next_key = 0
        self._released: List[int] = []
        # the forward's collectives on this rank: count and host seconds
        # (a gloo collective on CUDA tensors waits for the kernels that
        # produce its input, so the seconds include that wait)
        self.coll_calls = 0
        self.coll_s = 0.0
        if self._procs:
            self._finalizer = weakref.finalize(self, _stop, self._procs)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @classmethod
    def join(cls, rank: int, devices: Sequence[str], backend: str,
             port: int) -> "TPMesh":
        """A worker's end of the leader's mesh at loopback ``port``."""
        store = dist.TCPStore("127.0.0.1", port, len(devices), False,
                              timeout=TIMEOUT)
        return cls(rank, devices, backend, store)

    # ---- the forward's collectives (every rank) -----------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns it."""
        t0 = time.perf_counter()
        self._act.allreduce([x]).wait()
        self.coll_calls += 1
        self.coll_s += time.perf_counter() - t0
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last axis."""
        t0 = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._act.allgather([parts], [x]).wait()
        self.coll_calls += 1
        self.coll_s += time.perf_counter() - t0
        return torch.cat(parts, dim=-1)

    # ---- host tensors, point to point (CPU, gloo) ---------------------------
    def send(self, t: torch.Tensor, dst: int) -> None:
        """``t`` to rank ``dst`` as a host tensor (an empty one moves
        nothing: its receiver knows the shape)."""
        if t.numel():
            self._host.send([t.detach().cpu().contiguous()], dst, 0).wait()

    def recv(self, shape, dtype, src: int) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype)
        if t.numel():
            self._host.recv([t], src, 0).wait()
        return t

    def send_obj(self, obj: Any, dst: int) -> None:
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        self.send(torch.tensor([data.numel()], dtype=torch.int64), dst)
        self.send(data, dst)

    def recv_obj(self, src: int) -> Any:
        n = int(self.recv((1,), torch.int64, src)[0])
        return pickle.loads(self.recv((n,), torch.uint8, src).numpy()
                            .tobytes())

    # ---- the leader's command channel ---------------------------------------
    def new_key(self) -> int:
        """A key naming one engine on this mesh's workers."""
        self._next_key += 1
        return self._next_key

    def release(self, key: int) -> None:
        """Forget engine ``key`` on the workers (sent before the next
        command; safe to call from a finalizer)."""
        self._released.append(key)

    def command(self, msg: tuple) -> None:
        """Send ``msg`` to every worker, after the drops of released
        engines."""
        assert self.is_leader, "only the leader commands"
        while self._released:
            self._write(("drop", self._released.pop()))
        self._write(msg)

    def _write(self, msg: tuple) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        for p in self._procs:
            if p.poll() is not None:
                raise RuntimeError(f"tp worker pid {p.pid} exited with "
                                   f"{p.returncode}")
            p.stdin.write(data)
            p.stdin.flush()

    def worker_stats(self) -> List[dict]:
        """Each worker's counters (``tp_worker.stats``), in rank order."""
        self.command(("stats",))
        return [self.recv_obj(r) for r in range(1, self.size)]

    def zero_worker_stats(self) -> None:
        """Set the workers' counters to 0 (the leader's own are the
        caller's to reset)."""
        self.command(("zero",))

    def close(self) -> None:
        """End the workers (the leader's instance; idempotent)."""
        if self._procs:
            self._finalizer()


def _stop(procs, timeout_s: float = 60.0) -> None:
    """Close each worker's command pipe (a worker exits at its end) and
    wait; one still alive after ``timeout_s`` is killed."""
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def make_tp_mesh(tp: int, devices: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None, *,
                 device_type: str = "cuda") -> TPMesh:
    """The leader's mesh of ``tp`` ranks: rank ``r`` on ``devices[r]``
    (default :func:`default_devices` of ``device_type``; rank 0 is this
    process), the forward's collectives over ``backend`` (default:
    ``"gloo"`` on the CPU, ``"nccl"`` on cards). Starts the ``tp - 1``
    workers and waits until each has joined."""
    if tp < 2:
        raise ValueError(f"a tensor-parallel mesh has >= 2 ranks, not {tp}")
    devices = (list(devices) if devices is not None
               else default_devices(tp, device_type))
    if len(devices) != tp:
        raise ValueError(f"tp={tp} but {len(devices)} devices {devices}")
    backend = backend or ("gloo" if devices[0] == "cpu" else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and len(set(devices)) < tp:
        raise ValueError(f"nccl takes one rank per card, not {devices}: "
                         f"use the gloo backend to share a card")
    store = dist.TCPStore("127.0.0.1", 0, tp, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.tp_worker",
         "--rank", str(r), "--devices", ",".join(devices),
         "--backend", backend, "--port", str(store.port)],
        stdin=subprocess.PIPE, env=env) for r in range(1, tp)]
    try:
        return TPMesh(0, devices, backend, store, procs)
    except BaseException:
        _stop(procs, 5.0)      # the workers of a group that never formed
        raise
