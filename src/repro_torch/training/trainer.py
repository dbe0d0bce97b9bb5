"""The training loop — the port of ``repro.training.trainer``:
``Model.loss`` -> ``torch.autograd.grad`` ->
:func:`~repro_torch.training.optimizer.adamw_update`, loss / metric
logging, periodic and final checkpoints; and the sharded step the
reference's ``launch/train.py`` gets from GSPMD, written out per rank of
a ``launch.mesh.TrainMesh`` (:func:`make_sharded_train_step`,
:func:`train_sharded`).

The attention the loss reaches runs forward on its kernel where one
exists (#6, the causal prefill) and differentiates the kernel's plain
version (``models.attention.causal_prefill``); no step reads the device
but the logged steps.

**Sharded training.** GSPMD only changes the layout, so the sharded step
computes the unsharded step's function, up to the order of reductions.
Parameters are laid out by the training rules
(``launch.shardings.param_shardings``) on the mesh's ``model`` axis and
the batch rows on ``data``. Which mechanism runs the model group is
chosen by config (:func:`sharding_mechanism`):

* **tensor parallelism** (dense, MoE and VLM decoders whose heads, kv
  heads, vocab and d_ff, or experts, divide ``model``): the forward runs
  on the shard with ``cfg.tp_axis`` = the model group; its collectives
  are differentiable (``models.common``: all-reduce, copy, all-gather);
* **gather-on-use** (every other family, and decoders whose dims do not
  divide): each step all-gathers every split leaf (forward) and keeps
  the rank's slice of its gradient (backward), then runs the unsharded
  ``Model.loss``.

Under either, the loss takes the data group (``Model.loss(...,
data_group=)``), which makes it each rank's share of the whole batch's;
gradients are summed over the data group, the clip's global norm sums
the split leaves' squares over the model group and counts replicated
leaves once, and AdamW updates the shard in place, its moments shaped
like the shard.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.migration import tree_leaves
from repro_torch.kernels.api import launch_counts, zero_launch_counts
from repro_torch.launch.shardings import (batch_shardings, local_shard,
                                          param_shardings)
from repro_torch.models.common import ModelConfig, all_gather, all_reduce
from repro_torch.models.model import Model, build_model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 20
    ckpt_every: int = 0              # 0 = only at end
    ckpt_path: Optional[str] = None
    remat: bool = False
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """A ``TokenStream`` batch of numpy arrays -> tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back in ``tree``'s dicts."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return {k: _like(tree[k], leaves) for k in sorted(tree)}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    remat: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient with respect to every leaf of
    ``params`` (a leaf the loss does not reach gets zeros), then one AdamW
    update in place. ``metrics``: the loss, the loss's own metrics
    (``xent``, an MoE's ``aux``), ``lr`` and ``grad_norm``, as tensors on
    the device."""
    def train_step(params, opt_state: AdamWState, batch):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = model.loss(params, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        params, opt_state, info = adamw_update(
            opt_cfg, _like(params, iter(grads)), opt_state, params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **info}
        return params, opt_state, metrics
    return train_step


def train(model: Model, params, data: TokenStream,
          cfg: TrainConfig) -> Dict[str, List[float]]:
    """``cfg.steps`` steps on ``data``'s batches, on the device the
    params lie on. Logs (and keeps in the history) the loss, lr and
    gradient norm every ``log_every`` steps and at the last; checkpoints
    every ``ckpt_every`` steps and at the end when ``ckpt_path`` is set.
    Returns the history with the trained ``params``."""
    device = tree_leaves(params)[0].device
    opt_state = init_adamw(params)
    step_fn = make_train_step(model, cfg.opt, cfg.remat)
    history: Dict[str, List[float]] = {"loss": [], "lr": [], "grad_norm": []}
    it = iter(data)
    t0 = time.time()
    for step in range(1, cfg.steps + 1):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_to(next(it), device))
        if step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(m["loss"])
            history["loss"].append(loss)
            history["lr"].append(float(m["lr"]))
            history["grad_norm"].append(float(m["grad_norm"]))
            rate = step / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.3f}  {rate:.2f} it/s")
        if cfg.ckpt_path and cfg.ckpt_every and step % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_path, params, step)
    if cfg.ckpt_path:
        save_checkpoint(cfg.ckpt_path, params, cfg.steps)
    history["params"] = params          # type: ignore[assignment]
    return history


# --------------------------------------------------------------------------
# Sharded training on a data x model TrainMesh
# --------------------------------------------------------------------------
TP_FAMILIES = ("dense", "moe", "vlm")


def sharding_mechanism(cfg: ModelConfig, model: int) -> Tuple[str, str]:
    """``(mechanism, why)`` for ``cfg`` on a model axis of ``model``
    ranks: ``"tensor"`` where the family has a tensor-parallel forward
    and every dim it splits divides ``model``, ``"gather"`` (gather-on-
    use) otherwise, ``"replicated"`` at model 1. From the config only."""
    if model == 1:
        return "replicated", "model 1: every rank holds the whole model"
    if cfg.family not in TP_FAMILIES:
        return "gather", (f"gather-on-use: family {cfg.family} has no "
                          "tensor-parallel forward")
    if cfg.num_experts and cfg.moe_impl != "dense":
        return "gather", (f"gather-on-use: moe_impl {cfg.moe_impl} has no "
                          "expert-split form yet")
    dims = {"heads": cfg.num_heads, "kv heads": cfg.num_kv_heads,
            "vocab": cfg.vocab_size}
    if cfg.num_experts:
        dims["experts"] = cfg.num_experts
    if not cfg.num_experts or cfg.dense_residual:
        dims["d_ff"] = cfg.d_ff
    listed = ", ".join(f"{k} {v}" for k, v in dims.items())
    if any(v % model for v in dims.values()):
        return "gather", (f"gather-on-use: not all of {listed} divide "
                          f"model {model}")
    return "tensor", (f"tensor parallelism: {listed} divide model {model}")


def _sorted_paths(tree, prefix: str = ""):
    """``(path, leaf)`` in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [pl for k in sorted(tree) for pl in _sorted_paths(
        tree[k], f"{prefix}/{k}" if prefix else str(k))]


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    return {k: (_rebuild(v, fn, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict) else
                fn(f"{prefix}/{k}" if prefix else str(k), v))
            for k, v in tree.items()}


def _sum_over(group, tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over ``group`` in place: one collective per dtype
    over the tensors flattened together."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = group.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


class ShardedTrainStep:
    """One rank's training step on a :class:`~repro_torch.launch.mesh.
    TrainMesh`; made by :func:`make_sharded_train_step`. Call it as
    ``make_train_step``'s step: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, with this rank's shard (from
    :meth:`shard`), moments shaped like it (``init_adamw(shard)``) and
    the whole batch (a ``TokenStream`` batch: this rank takes its rows).
    ``metrics`` (``loss``, ``xent``, an MoE's ``aux``, ``lr``,
    ``grad_norm``) are the whole batch's and equal on every rank."""

    def __init__(self, model: Model, opt_cfg: AdamWConfig, mesh,
                 remat: bool = False):
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.remat = remat
        self.mechanism, self.why = sharding_mechanism(model.cfg,
                                                      mesh.model)
        tp = mesh.model_group if self.mechanism == "tensor" else None
        self.model = build_model(dataclasses.replace(model.cfg, tp_axis=tp))
        self.split: Dict[str, int] = {}     # path -> dim split on model

    def shard(self, params) -> Any:
        """This rank's shard of the whole tree ``params`` (any device) on
        the rank's device: split leaves as fresh contiguous tensors,
        whole ones moved (the caller's own where already there)."""
        specs = param_shardings(params, self.mesh)
        self.split = {path: spec.index("model") for path, spec
                      in specs.items() if "model" in spec
                      and self.mesh.model > 1}
        dev = self.mesh.device

        def cut(path, leaf):
            if path in self.split:
                return local_shard(leaf, specs[path], self.mesh).to(
                    dev).clone(memory_format=torch.contiguous_format)
            return leaf.to(dev)
        return _rebuild(params, cut)

    def rows(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a whole batch (numpy arrays or tensors) on
        its device: dim 0 split on the data axis where it divides, the
        whole batch where it does not (every rank's loss is then a
        ``1 / data`` share of the same rows)."""
        batch = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v for k, v in batch.items()}
        specs = batch_shardings(batch, self.mesh)
        return {k: local_shard(v, specs[k], self.mesh).to(self.mesh.device)
                for k, v in batch.items()}

    def _whole(self, params):
        """The whole tree gathered under autograd (gather-on-use)."""
        group = self.mesh.model_group
        return _rebuild(params, lambda path, leaf: all_gather(
            leaf, group, self.split[path]) if path in self.split else leaf)

    def global_norm(self, paths: List[str],
                    grads: List[torch.Tensor]) -> torch.Tensor:
        """The whole model's gradient norm: the split leaves' squares
        summed over the model group, each replicated leaf counted once."""
        dev = grads[0].device
        split = torch.zeros((1,), dtype=torch.float32, device=dev)
        rep = torch.zeros((), dtype=torch.float32, device=dev)
        for path, g in zip(paths, grads):
            sq = torch.sum(torch.square(g.float()))
            if path in self.split:
                split = split + sq
            else:
                rep = rep + sq
        if self.split and self.mesh.model_group is not None:
            split = self.mesh.model_group.all_reduce(split)
        return torch.sqrt(split[0] + rep)

    def __call__(self, params, opt_state: AdamWState, batch):
        local = self.rows(batch)
        paths, leaves = zip(*_sorted_paths(params))
        for p in leaves:
            p.requires_grad_()
        with torch.enable_grad():
            tree = (self._whole(params) if self.mechanism == "gather"
                    else params)
            loss, aux = self.model.loss(tree, local, remat=self.remat,
                                        data_group=self.mesh.data_group)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if self.mesh.data_group is not None:
            _sum_over(self.mesh.data_group, grads)
        gnorm = self.global_norm(list(paths), grads)
        params, opt_state, info = adamw_update(
            self.opt_cfg, _like(params, iter(grads)), opt_state, params,
            gnorm=gnorm)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["xent"] = all_reduce(aux["xent"], self.mesh.data_group)
        whole = aux["xent"] + aux["aux"] if "aux" in aux else aux["xent"]
        return params, opt_state, {"loss": whole, **aux, **info}

    def gather(self, params) -> Optional[Dict[str, Any]]:
        """The whole tree on rank 0 (CPU tensors; None on the other
        ranks): every split leaf all-gathered over the model group (every
        rank takes part), leaf by leaf."""
        group = self.mesh.model_group
        keep = self.mesh.rank == 0

        def one(path, leaf):
            leaf = leaf.detach()
            if path in self.split:
                leaf = group.all_gather(leaf, self.split[path])
            return leaf.cpu().clone() if keep else None
        out = _rebuild(params, one)
        return out if keep else None


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh,
                            remat: bool = False) -> ShardedTrainStep:
    """The sharded counterpart of :func:`make_train_step` on this rank of
    ``mesh`` (every rank makes one and calls it in step). Cut the shard
    with ``step.shard(whole_params)``; ``step.mechanism`` names the
    mechanism (:func:`sharding_mechanism`)."""
    return ShardedTrainStep(model, opt_cfg, mesh, remat)


@dataclasses.dataclass
class ShardedRun:
    """A sharded training job for :func:`train_sharded`. ``init``: a seed
    (every rank draws the same whole tree on its device and keeps its
    shard) or the whole tree as nested
    dicts of numpy arrays. ``log_every``: rank 0 prints the reference
    launcher's line every that many steps and at step 1 (0: never).
    ``gather`` returns the whole trained tree and moments from rank 0;
    ``ckpt_path`` writes the tree there. ``settings`` carries the
    creating process' intra-op threads and TF32 switches
    (:func:`host_settings`) to every rank."""
    cfg: ModelConfig
    steps: int
    opt: AdamWConfig
    data: DataConfig
    init: Any = 0
    remat: bool = False
    log_every: int = 0
    gather: bool = False
    ckpt_path: str = ""
    settings: dict = dataclasses.field(
        default_factory=lambda: host_settings())


def host_settings() -> dict:
    """This process' intra-op threads and cuBLAS / cuDNN TF32 switches,
    which a job's ranks take from the process that made it."""
    return {"threads": torch.get_num_threads(),
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}


def _from_arrays(tree, device):
    return {k: (_from_arrays(v, device) if isinstance(v, dict) else
                torch.from_numpy(np.array(v)).to(device))
            for k, v in tree.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_sharded(mesh, run: ShardedRun) -> dict:
    """One rank's part of a sharded training run (every rank runs it:
    ``mesh.run(train_sharded, run)``). Draws or takes the whole tree,
    keeps the rank's shard, runs ``run.steps`` steps of
    :func:`make_sharded_train_step` on ``TokenStream(run.cfg, run.data)``
    (every rank reads the whole batches and takes its rows). Returns
    this rank's record: the mechanism, per step the metrics and the wall
    (ms, host clock around a synchronised step), the kernels' launches
    and each subgroup's collectives (count, host seconds) over the
    steps, the shard's shapes, the peak memory (a card), and with
    ``gather`` (rank 0) the whole trained tree and its AdamW moments
    (``params``, ``mu``, ``nu``)."""
    torch.set_num_threads(run.settings["threads"])
    torch.backends.cuda.matmul.allow_tf32 = run.settings["tf32"]
    torch.backends.cudnn.allow_tf32 = run.settings["cudnn_tf32"]
    dev = mesh.device
    model = build_model(run.cfg)
    step = make_sharded_train_step(model, run.opt, mesh, run.remat)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if isinstance(run.init, int):
        whole = model.init(run.init, device=dev)
    else:
        whole = _from_arrays(run.init, dev)
    params = step.shard(whole)
    del whole
    opt_state = init_adamw(params)
    stream = iter(TokenStream(run.cfg, run.data))
    zero_launch_counts()
    groups = mesh.groups()
    for g in groups.values():
        g.coll_calls, g.coll_s = 0, 0.0
    history = []
    for i in range(1, run.steps + 1):
        batch = next(stream)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        history.append({"step": i, "ms": ms,
                        **{k: float(v) for k, v in m.items()}})
        if mesh.rank == 0 and run.log_every and (
                i % run.log_every == 0 or i == 1):
            print(f"step {i:4d} loss {history[-1]['loss']:.4f} "
                  f"lr {history[-1]['lr']:.2e}", flush=True)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "device": str(dev), "mechanism": step.mechanism,
           "why": step.why, "history": history,
           "launches": launch_counts(),
           "collectives": {k: (g.coll_calls, g.coll_s)
                           for k, g in groups.items()},
           "shard_shapes": {p: tuple(a.shape)
                            for p, a in _sorted_paths(params)},
           "forbidden_modules": sorted(
               n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "repro"))}
    if dev.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    if run.gather or run.ckpt_path:
        whole = step.gather(params)
        if whole is not None and run.ckpt_path:
            save_checkpoint(run.ckpt_path, whole, run.steps)
        if run.gather:
            moments = [step.gather(t) for t in (opt_state.mu, opt_state.nu)]
            if whole is not None:
                out.update(params=whole, mu=moments[0], nu=moments[1])
    return out
