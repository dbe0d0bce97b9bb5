"""Process groups of the port — the counterpart of ``repro.launch.mesh``:
the reference's mesh layouts, a tensor-parallel serving group
(``make_tp_mesh``) and a data × model training group
(``make_train_mesh``).

JAX drives every device of a mesh from one process; PyTorch runs one
process per rank. Rank 0 (the caller's process) starts ranks ``1..N-1``
as fresh interpreters (not forks: a rank loads nothing its starter had
imported) and joins them in a process group of its own, built on its
own TCP store at a free loopback port, so several groups coexist in one
process (one per tensor-parallel engine of a heterogeneous cluster).

**Layouts** (:func:`make_host_mesh`, :func:`make_production_mesh`,
:func:`batch_axes`) start no process: they hold the reference's axis
names and sizes, which the sharding rules (``launch.shardings``) read.

**Serving** (:class:`TPMesh`): the leader (rank 0) owns the ``Engine``
and all of its host state; the workers (``python -m
repro_torch.launch.tp_worker``) wait for its commands. Three channels
connect the ranks:

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

**Training** (:class:`TrainMesh`): ``R = data × model`` ranks, rank
``r = d · model + m``, every rank running the same training loop (SPMD;
``python -m repro_torch.launch.train_worker`` on ranks 1..R-1, each job
pickled to it by rank 0 and its result sent back). One model subgroup
per ``d`` and one data subgroup per ``m`` carry the step's collectives.

Every collective and every point-to-point wait has the group's timeout;
a rank that dies breaks its connections, so its peers' next collective
fails instead of hanging. Nothing here runs at import.
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# every wait of a group: rendezvous, collectives, point-to-point transfers
# (the longest is a worker's weight shard: seconds for 3.2 GB)
TIMEOUT = datetime.timedelta(seconds=300)
_SRC = str(Path(__file__).resolve().parents[2])


# --------------------------------------------------------------------------
# Layouts: the reference's axis names and sizes, no process
# --------------------------------------------------------------------------
class Layout:
    """A mesh's shape without devices: ``shape`` maps each axis name to
    its size, in the reference's order (``("data", "model")`` or
    ``("pod", "data", "model")``)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __repr__(self) -> str:
        return f"Layout({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod:  (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return Layout({"pod": 2, "data": 16, "model": 16})
    return Layout({"data": 16, "model": 16})


def make_host_mesh(model: int = 1, n: Optional[int] = None) -> Layout:
    """(data = n // model, model) over ``n`` devices (default: the cards
    present, or 1), ``model`` clamped to ``n`` as the reference clamps
    it to its device count."""
    if n is None:
        n = max(torch.cuda.device_count(), 1)
    model = min(model, n)
    return Layout({"data": n // model, "model": model})


def batch_axes(mesh) -> Tuple[str, ...]:
    """The (super-)axis the batch shards over: ('pod', 'data') when a pod
    axis exists, else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# --------------------------------------------------------------------------
# Groups of processes
# --------------------------------------------------------------------------
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


def _activation_group(store, rank: int, size: int, backend: str):
    """The process group of a forward's collectives."""
    if backend == "gloo":
        return _gloo(store, rank, size)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = TIMEOUT
    return dist.ProcessGroupNCCL(store, rank, size, opts)


def _check_backend(devices: Sequence[str], backend: Optional[str]) -> str:
    """``backend`` (default: gloo on the CPU or where ranks share a card,
    nccl when each rank has a card of its own), refused where it cannot
    run: nccl takes one rank per card. A card is named with its index
    (a rank process binds to it before it joins)."""
    for d in devices:
        if torch.device(d).type == "cuda" and torch.device(d).index is None:
            raise ValueError(f"device {d!r}: name the card, e.g. cuda:0")
    shared = len(set(devices)) < len(devices)
    backend = backend or ("gloo" if devices[0] == "cpu" or shared
                          else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and shared:
        raise ValueError(f"nccl takes one rank per card, not {devices}: "
                         f"use the gloo backend to share a card")
    return backend


class Collectives:
    """One group's collectives on this rank: ``rank`` and ``size`` within
    the group, a sum and a gather over its ranks, and their count and
    host seconds (a gloo collective on CUDA tensors waits for the kernels
    that produce its input, so the seconds include that wait). A model's
    ``cfg.tp_axis`` holds one."""

    def __init__(self, pg, rank: int, size: int):
        self._act = pg
        self.rank = rank
        self.size = size
        self.coll_calls = 0
        self.coll_s = 0.0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns it."""
        t0 = time.perf_counter()
        self._act.allreduce([x]).wait()
        self.coll_calls += 1
        self.coll_s += time.perf_counter() - t0
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` (default the
        last), in rank order."""
        t0 = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._act.allgather([parts], [x]).wait()
        self.coll_calls += 1
        self.coll_s += time.perf_counter() - t0
        return torch.cat(parts, dim=dim)


class _Ranks:
    """What both kinds of group share: ``size`` ranks, this process'
    ``rank``, one device string per rank, a gloo group for host tensors
    and, on rank 0, the other ranks' processes and their stdin pipes."""

    def __init__(self, rank: int, devices: Sequence[str], backend: str,
                 store, procs=()):
        self.rank = rank
        self.size = len(devices)
        self.devices = list(devices)
        self.device = torch.device(devices[rank])
        self.backend = backend
        self._store = store
        self._host = _gloo(dist.PrefixStore("host", store), rank, self.size)
        self._procs = list(procs)
        if self._procs:
            self._finalizer = weakref.finalize(self, _stop, self._procs)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

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

    def _write(self, msg: tuple) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        for p in self._procs:
            if p.poll() is not None:
                raise RuntimeError(f"rank process pid {p.pid} exited with "
                                   f"{p.returncode}")
            p.stdin.write(data)
            p.stdin.flush()

    def close(self) -> None:
        """End the other ranks' processes (rank 0's instance;
        idempotent)."""
        if self._procs:
            self._finalizer()


class TPMesh(_Ranks, Collectives):
    """One tensor-parallel serving group: ``size`` ranks, this process'
    ``rank``, one device string per rank; its forward collectives are
    :class:`Collectives` over the whole group. The leader's instance also
    holds its workers' processes. Built by :func:`make_tp_mesh` (leader)
    or :meth:`join` (a worker)."""

    def __init__(self, rank: int, devices: Sequence[str], backend: str,
                 store, procs=()):
        _Ranks.__init__(self, rank, devices, backend, store, procs)
        act = (self._host if backend == "gloo" else _activation_group(
            dist.PrefixStore("act", store), rank, self.size, backend))
        Collectives.__init__(self, act, rank, self.size)
        self._next_key = 0
        self._released: List[int] = []

    @classmethod
    def join(cls, rank: int, devices: Sequence[str], backend: str,
             port: int) -> "TPMesh":
        """A worker's end of the leader's mesh at loopback ``port``."""
        store = dist.TCPStore("127.0.0.1", port, len(devices), False,
                              timeout=TIMEOUT)
        return cls(rank, devices, backend, store)

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

    def worker_stats(self) -> List[dict]:
        """Each worker's counters (``tp_worker.stats``), in rank order."""
        self.command(("stats",))
        return [self.recv_obj(r) for r in range(1, self.size)]

    def zero_worker_stats(self) -> None:
        """Set the workers' counters to 0 (the leader's own are the
        caller's to reset)."""
        self.command(("zero",))


class TrainMesh(_Ranks):
    """A data × model training group of ``R = len(devices)`` ranks: rank
    ``r`` is ``(d, m) = divmod(r, model)``. ``model_group`` (the ranks of
    this ``d``; None at model 1) carries tensor parallelism and the
    gathers of split leaves, ``data_group`` (the ranks of this ``m``;
    None at data 1) the gradient sums. :meth:`reshape` switches the
    layout of the same processes (every rank calls it, in the same
    order); each layout's subgroups are built once, over the one store.
    ``shape`` and ``axis_names`` read as a :class:`Layout`'s, so the
    sharding rules take the mesh itself. Rank 0 runs a job on every
    rank with :meth:`run`."""

    def __init__(self, rank: int, devices: Sequence[str], backend: str,
                 store, data: int, model: int, procs=()):
        _Ranks.__init__(self, rank, devices, backend, store, procs)
        self._layouts: Dict[Tuple[int, int], tuple] = {}
        self.axis_names = ("data", "model")
        self.reshape(data, model)

    @classmethod
    def join(cls, rank: int, devices: Sequence[str], backend: str,
             port: int, data: int, model: int) -> "TrainMesh":
        """Rank ``rank``'s end of rank 0's group at loopback ``port``."""
        store = dist.TCPStore("127.0.0.1", port, len(devices), False,
                              timeout=TIMEOUT)
        return cls(rank, devices, backend, store, data, model)

    def reshape(self, data: int, model: int) -> "TrainMesh":
        """Use the (data, model) layout of the same ranks."""
        if data * model != self.size:
            raise ValueError(f"(data {data}, model {model}) does not hold "
                             f"{self.size} ranks")
        d, m = divmod(self.rank, model)
        key = (data, model)
        if key not in self._layouts:
            tag = f"{data}x{model}"
            self._layouts[key] = (
                self._subgroup(f"model/{tag}/{d}", m, model),
                self._subgroup(f"data/{tag}/{m}", d, data))
        self.data, self.model, self.d, self.m = data, model, d, m
        self.model_group, self.data_group = self._layouts[key]
        return self

    def _subgroup(self, name: str, rank: int,
                  size: int) -> Optional[Collectives]:
        if size == 1:
            return None
        store = dist.PrefixStore(name, self._store)
        return Collectives(_activation_group(store, rank, size,
                                             self.backend), rank, size)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis."""
        return {"data": self.d, "model": self.m}

    def groups(self) -> Dict[str, Collectives]:
        """Every subgroup this rank is in, by axis, over every layout
        used so far (their counters)."""
        out: Dict[str, Collectives] = {}
        for (data, model), pair in self._layouts.items():
            for axis, g in zip(("model", "data"), pair):
                if g is not None:
                    out[f"{axis} ({data}x{model})"] = g
        return out

    def run(self, fn: Callable, *args, layout: Optional[Tuple[int, int]]
            = None, **kwargs) -> List[Any]:
        """Run ``fn(mesh, *args, **kwargs)`` on every rank (``fn`` a
        module-level function: the other ranks import it by name), under
        ``layout`` (data, model) when given; returns every rank's result
        in rank order. A failure on this rank ends the other ranks, whose
        collectives would wait for it."""
        assert self.is_leader, "rank 0 starts the jobs"
        self._write(("run", fn.__module__, fn.__qualname__, layout, args,
                     kwargs))
        try:
            mine = run_job(self, fn, layout, args, kwargs)
            return [mine] + [self.recv_obj(r) for r in range(1, self.size)]
        except BaseException:
            self.abort()
            raise

    def abort(self) -> None:
        """Kill the other ranks at once (their state is unknown)."""
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        self.close()


def run_job(mesh: TrainMesh, fn: Callable, layout, args, kwargs):
    """One rank's part of :meth:`TrainMesh.run`."""
    if layout is not None:
        mesh.reshape(*layout)
    return fn(mesh, *args, **kwargs)


def read_commands(stream):
    """The pickled commands of ``stream`` (a rank's stdin) until it
    closes."""
    while True:
        try:
            yield pickle.load(stream)
        except EOFError:
            return


def _stop(procs, timeout_s: float = 60.0) -> None:
    """Close each rank's command pipe (a rank exits at its end) and
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


def _spawn(module: str, devices: Sequence[str], store,
           args: Sequence[str]) -> list:
    """Ranks 1..N-1 as ``python -m module --rank r ...``, stdin piped."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return [subprocess.Popen(
        [sys.executable, "-m", module, "--rank", str(r),
         "--devices", ",".join(devices), "--port", str(store.port),
         *args], stdin=subprocess.PIPE, env=env)
        for r in range(1, len(devices))]


def make_tp_mesh(tp: int, devices: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None, *,
                 device_type: str = "cuda") -> TPMesh:
    """The leader's mesh of ``tp`` ranks: rank ``r`` on ``devices[r]``
    (default :func:`default_devices` of ``device_type``; rank 0 is this
    process), the forward's collectives over ``backend`` (default:
    ``"gloo"`` on the CPU or a shared card, ``"nccl"`` on a card a rank).
    Starts the ``tp - 1``
    workers and waits until each has joined."""
    if tp < 2:
        raise ValueError(f"a tensor-parallel mesh has >= 2 ranks, not {tp}")
    devices = (list(devices) if devices is not None
               else default_devices(tp, device_type))
    if len(devices) != tp:
        raise ValueError(f"tp={tp} but {len(devices)} devices {devices}")
    backend = _check_backend(devices, backend)
    store = dist.TCPStore("127.0.0.1", 0, tp, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    procs = _spawn("repro_torch.launch.tp_worker", devices, store,
                   ["--backend", backend])
    try:
        return TPMesh(0, devices, backend, store, procs)
    except BaseException:
        _stop(procs, 5.0)      # the workers of a group that never formed
        raise


def make_train_mesh(model: int, devices: Sequence[str],
                    backend: Optional[str] = None) -> TrainMesh:
    """Rank 0's training group over ``devices`` (one entry per rank; this
    process is rank 0): ``model`` clamped to ``R = len(devices)`` as the
    reference clamps it, ``data = R // model``; an ``R`` that ``model``
    does not divide is refused. The collectives run over ``backend``
    (default: gloo on the CPU or a shared card, nccl on a card a rank).
    Starts ranks 1..R-1 (``launch.train_worker``) and waits until each
    has joined."""
    devices = list(devices)
    R = len(devices)
    if R < 1:
        raise ValueError("a training group needs a device")
    model = min(model, R)
    if model < 1 or R % model:
        raise ValueError(f"{R} ranks do not split into model groups of "
                         f"{model}")
    backend = _check_backend(devices, backend)
    store = dist.TCPStore("127.0.0.1", 0, R, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    procs = _spawn("repro_torch.launch.train_worker", devices, store,
                   ["--backend", backend, "--data", str(R // model),
                    "--model", str(model)])
    try:
        return TrainMesh(0, devices, backend, store, R // model, model,
                         procs)
    except BaseException:
        _stop(procs, 5.0)
        raise
