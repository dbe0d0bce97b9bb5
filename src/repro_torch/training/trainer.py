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
the batch rows on ``data``. How each block runs on the model group is
planned by config (:func:`sharding_mechanism`, a :class:`Plan`):

* **tensor parallelism** (dense, MoE and VLM decoders whose heads, kv
  heads, vocab and d_ff, or experts, divide ``model``): the forward runs
  on the shard with ``cfg.tp_axis`` = the model group; its collectives
  are differentiable (``models.common``: all-reduce, copy, all-gather).
  An MoE runs the rank's E / model experts (``moe_dense`` on every row,
  ``moe_gshard`` on the rank's kept pairs, dispatched by index) and
  all-reduces the combined output once;
* **the per-leaf partition** (those decoders where some dim does not
  divide, which at a model axis of 16 is every one: their heads; and
  the other families' blocks): each block whose split dims divide runs
  split (the experts too, under either MoE), the rest gather their
  split leaves at their use, in their layer; attention projects its
  columns and gathers q / k / v on whole heads, then splits its core
  over (row, head) pairs (``cfg.tp_plan``, ``models.attention``).
  rwkv6 runs its time mix on the rank's whole heads (the WKV recurrence
  head-split, ``models.rwkv6``) and its channel mix on the rank's share
  of F; zamba2 its Mamba2 blocks on the rank's SSD heads
  (``models.mamba2``: the projection's and the conv's cuts miss the
  heads' edges, so each is joined by an all-gather of activations) and
  its shared block as a decoder's; whisper its encoder, decoder and
  cross-attention on the decoders' forms (``models.whisper``).

Under each, the loss takes the data group (``Model.loss(...,
data_group=)``), which makes it each rank's share of the whole batch's;
gradients are summed over the data group, the replicated leaves that a
split block uses on the rank's heads only (``models.model.
shared_leaves``) have their gradients summed over the model group, the
clip's global norm sums the split leaves' squares over the model group
and counts replicated leaves once, and AdamW updates the shard in
place, its moments shaped like the shard. No plan gathers the whole
model: every leaf ``launch.shardings.param_spec`` splits stays split
but where its block's dims do not divide.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.migration import tree_leaves
from repro_torch.kernels.api import launch_counts, zero_launch_counts
from repro_torch.launch.mesh import lever_groups
from repro_torch.launch.shardings import (batch_shardings, local_shard,
                                          param_shardings, zero1_shardings)
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.attention import cross_layout
from repro_torch.models.common import (Levers, ModelConfig, all_reduce,
                                       state_axis)
from repro_torch.models.model import (Model, build_model, seq_norm_leaves,
                                      shared_leaves)
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
class Plan(NamedTuple):
    """How a config runs on a model axis (:func:`sharding_mechanism`).
    ``blocks``: each block's mode on the axis, ``"split"`` (it runs on
    the rank's shard: ``experts`` on the rank's E / model experts) or
    ``"gather"`` (its split leaves are all-gathered at their use, in
    their layer, and it runs whole); empty at model 1. ``axes`` says
    where the split core and decode cache lie: ``core`` on ``"heads"``
    (whole heads a rank) or ``"pairs"`` ((row, head) pairs that cut
    across heads; rwkv6's recurrence: ``"none"``, every head on every
    rank), ``cache`` on ``"kv heads"``, ``"head_dim"`` or ``"none"``
    (whole on every rank; rwkv6's state ``S``: ``"heads"``, ``"K"``; an
    optimized case's ``"seq"``: ``launch.cases``' ``seq_cache`` lever);
    zamba2's ``ssd`` on ``"heads"`` or ``"none"``, whisper's ``cross``
    cache on ``"seq"`` (the encoder's frames), ``"kv heads"``,
    ``"head_dim"`` or ``"none"``."""
    mechanism: str
    why: str
    blocks: Dict[str, str]
    axes: Dict[str, str]


def _weight_dims(cfg: ModelConfig) -> Dict[str, Dict[str, int]]:
    """Each weight block of ``cfg`` and the dims ``launch.shardings.
    param_spec`` splits for its leaves (and, where a block computes on
    whole heads, its head count), in the forward's order."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    vocab = {"vocab": cfg.vocab_size}
    attn = {"H·Dh": H * Dh, "Hkv·Dh": Hkv * Dh}
    if cfg.family == "ssm":
        heads, _ = rwkv6._heads(cfg)
        return {"embed": vocab,
                "tmix": {"D": cfg.d_model, "heads": heads},
                "cmix": {"d_ff": cfg.d_ff, "D": cfg.d_model},
                "unembed": vocab}
    if cfg.family == "hybrid":
        d_inner, Hs, _, _ = mamba2.dims(cfg)
        w = mamba2.split_widths(cfg)
        return {"embed": vocab,
                "mamba": {"w_in": w["w_in"][1], "conv": w["conv_w"][1],
                          "d_inner": d_inner, "heads": Hs},
                "attn": attn, "mlp": {"d_ff": cfg.d_ff}, "unembed": vocab}
    if cfg.family == "encdec":
        return {"embed": vocab, "attn": attn, "cross_attn": attn,
                "mlp": {"d_ff": cfg.d_ff}}
    dims = {"embed": vocab, "attn": attn}
    if not cfg.num_experts or cfg.dense_residual:
        dims["mlp"] = {"d_ff": cfg.d_ff}
    if cfg.num_experts:
        dims["experts"] = {"experts": cfg.num_experts}
    dims["unembed"] = vocab
    return dims


def sharding_mechanism(cfg: ModelConfig, model: int) -> Plan:
    """The :class:`Plan` of ``cfg`` on a model axis of ``model`` ranks,
    from the config only: each weight block split where the dims
    ``launch.shardings.param_spec`` splits for its leaves divide
    ``model`` (:func:`_weight_dims`: ``embed`` / ``unembed`` V; ``attn``
    and whisper's ``cross_attn``, the projections, H·Dh and Hkv·Dh;
    ``mlp`` d_ff; ``experts`` E, under either MoE, each of which has its
    expert-split form; rwkv6's ``tmix`` D and its heads, ``cmix`` F and
    D; zamba2's ``mamba`` its leaves' widths and SSD heads); the
    attention ``core`` always split, over (row, head) pairs; the decode
    ``cache`` split on kv heads where they divide, else on the head dim. rwkv6's recurrence (``core``) and its
    state ``S`` (``cache``) follow ``tmix``. The mechanism:
    ``"tensor"`` where every block splits on whole heads (heads and kv
    heads divide; the serving engine's tensor parallelism; zamba2's
    Mamba2 cuts never do), ``"per-leaf"`` where the blocks differ or the
    heads do not divide, ``"gather"`` where no weight block splits, and
    ``"replicated"`` at model 1."""
    if model == 1:
        return Plan("replicated", "model 1: every rank holds the whole "
                    "model", {}, {})
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dims = _weight_dims(cfg)
    blocks = {b: "split" if all(n % model == 0 for n in d.values())
              else "gather" for b, d in dims.items()}
    weights = list(blocks)
    if cfg.family == "ssm":
        _, K = rwkv6._heads(cfg)
        i = state_axis((dims["tmix"]["heads"], K, K), model)
        blocks["core"] = blocks["tmix"]
        blocks["cache"] = "split" if i == 0 else "gather"
        axes = {"core": "heads" if blocks["tmix"] == "split" else "none",
                "cache": ("heads", "K", "K", "none")[3 if i is None else i]}
        heads = blocks["tmix"] == "split"
        tail = (f"recurrence on {axes['core']} (H {dims['tmix']['heads']}, "
                f"K {K}), state S on {axes['cache']}")
    else:
        heads = H % model == 0 and Hkv % model == 0
        blocks["core"] = "split"
        blocks["cache"] = ("split" if Hkv % model == 0 or Dh % model == 0
                           else "gather")
        axes = {"core": "heads" if H % model == 0 else "pairs",
                "cache": ("kv heads" if Hkv % model == 0 else "head_dim"
                          if Dh % model == 0 else "none")}
        tail = (f"core over {axes['core']} (H {H}), decode cache on "
                f"{axes['cache']} (Hkv {Hkv}, Dh {Dh})")
        if cfg.family == "hybrid":
            heads = False           # the Mamba2 cuts miss the heads' edges
            axes["ssd"] = ("heads" if blocks["mamba"] == "split"
                           else "none")
            tail += f"; SSD on {axes['ssd']}"
        if cfg.family == "encdec":
            axes["cross"] = cross_layout(cfg, model)
            tail += (f"; cross cache on {axes['cross']} (S_enc "
                     f"{cfg.encoder_seq})")
    split = [b for b in weights if blocks[b] == "split"]
    if len(split) == len(weights) and heads:
        mech = "tensor"
    elif not split:
        mech = "gather"
    else:
        mech = "per-leaf"
    listed = "; ".join(f"{b} {blocks[b]} ("
                       + ", ".join(f"{k} {v}" for k, v in d.items()) + ")"
                       for b, d in dims.items())
    name = {"tensor": "tensor parallelism", "per-leaf": "per-leaf "
            "partition", "gather": "gather-on-use"}[mech]
    return Plan(mech, f"{name} at model {model}: {listed}; {tail}", blocks,
                axes)


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


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[int]]:
    """The indices of ``tensors`` grouped by dtype, in first-seen
    order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _scatter_over(group, tensors: List[torch.Tensor],
                  dims: List[int]) -> List[torch.Tensor]:
    """Each tensor summed over ``group``, of which this rank keeps its
    equal piece along its dim in ``dims`` (ZeRO-1's gradient): one
    reduce-scatter per dtype over the tensors laid side by side, each cut
    into the ranks' rows first."""
    n = group.size
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors):
        moved = [tensors[i].movedim(dims[i], 0) for i in idx]
        flat = moved[0].new_empty((n, sum(m.numel() // n for m in moved)))
        o = 0
        for m in moved:             # each leaf into its columns, no copy
            k = m.numel() // n      # between
            flat[:, o:o + k].unflatten(1, (m.shape[0] // n,) + m.shape[
                1:]).copy_(m.unflatten(0, (n, -1)))
            o += k
        mine = group.reduce_scatter(flat, 0)[0]
        del flat
        for i, m, part in zip(idx, moved, mine.split(
                [m.numel() // n for m in moved])):
            out[i] = part.view((m.shape[0] // n,) + m.shape[1:]).movedim(
                0, dims[i])
    return out


def _gather_into(group, pieces: List[torch.Tensor], wholes: List[
        torch.Tensor], dims: List[int]) -> None:
    """Every rank's piece of each tensor joined along its dim in ``dims``
    and written into ``wholes`` (ZeRO-1's parameter rebuild): one
    all-gather per dtype over the pieces laid side by side."""
    n = group.size
    for idx in _by_dtype(pieces):
        moved = [pieces[i].movedim(dims[i], 0) for i in idx]
        flat = group.all_gather(torch.cat([m.reshape(1, -1) for m in moved],
                                          1), 0)
        for i, m, part in zip(idx, moved, flat.split(
                [m.numel() for m in moved], 1)):
            whole = part.reshape((n * m.shape[0],) + m.shape[1:])
            wholes[i].copy_(whole.movedim(0, dims[i]))


class _AxisView:
    """A rank's coordinates on the axes the training rules name, with
    ``data`` the data axis alone (a multi-pod layout folds ``pod × data``
    into one data group; the 2-D experts and ZeRO-1 split on ``data``
    only, as the reference's rules do)."""

    def __init__(self, mesh, data_axis: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": data_axis, "model": mesh.model}
        self.coords = {"data": mesh.d % data_axis, "model": mesh.m}


class ShardedTrainStep:
    """One rank's training step on a :class:`~repro_torch.launch.mesh.
    TrainMesh`; made by :func:`make_sharded_train_step`. Call it as
    ``make_train_step``'s step: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, with this rank's shard (from
    :meth:`shard`), moments shaped like it (``init_adamw(shard)``) and
    the whole batch (a ``TokenStream`` batch: this rank takes its rows).
    ``metrics`` (``loss``, ``xent``, an MoE's ``aux``, ``lr``,
    ``grad_norm``) are the whole batch's and equal on every rank.

    **The levers** (``model.cfg.levers``, ``models.common.Levers``): with
    ``expert_2d`` the expert leaves also split their F on the data axis
    (each rank's gradient of its slice is then every data rank's rows':
    no data sum, its moments its own slice's); with ``zero1`` each
    moment is cut on the dim ``launch.shardings.zero1_shardings`` puts
    ``data`` on, that leaf's gradient is reduce-scattered over the data
    axis in place of the all-reduce, AdamW updates the rank's slice of
    the parameter and one all-gather rebuilds it (leaves with no such dim
    keep the all-reduce); with ``seq_parallel`` the norms a layer applies
    on the rank's T / m rows (``models.model.seq_norm_leaves``) have
    their gradients summed over the model group. On a multi-pod layout
    the data-axis sums also run across the pods."""

    def __init__(self, model: Model, opt_cfg: AdamWConfig, mesh,
                 remat: bool = False):
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.remat = remat
        self.levers = model.cfg.levers or Levers()
        self.plan = sharding_mechanism(model.cfg, mesh.model)
        self.mechanism, self.why = self.plan.mechanism, self.plan.why
        self.data_axis, self.pod = lever_groups(mesh)
        self.view = _AxisView(mesh, 1 if self.data_axis is None
                              else self.data_axis.size)
        # every block runs on the model group (no plan: tensor
        # parallelism on whole heads)
        on_group = bool(self.plan.blocks)
        plan = (self.plan.blocks if on_group and self.mechanism != "tensor"
                else None)
        self.model = build_model(dataclasses.replace(
            model.cfg, tp_axis=mesh.model_group if on_group else None,
            tp_plan=plan, tp_rows=mesh.data,
            tp_data=self.data_axis if self.levers.expert_2d else None))
        self.split: Dict[str, int] = {}     # path -> dim split on model
        self.data_split: Dict[str, int] = {}  # path -> dim split on data
        self.zero1: Dict[str, int] = {}     # path -> its moments' data dim
        # replicated leaves whose rank gradient is its heads' share
        self.shared = (set(shared_leaves(self.model.cfg)) if on_group
                       else set())
        self.seq_norms = re.compile(seq_norm_leaves(self.model.cfg))

    def shard(self, params) -> Any:
        """This rank's shard of the whole tree ``params`` (any device) on
        the rank's device: split leaves as fresh contiguous tensors,
        whole ones moved (the caller's own where already there)."""
        specs = param_shardings(params, self.view,
                                expert_2d=self.levers.expert_2d)
        self.split = {path: spec.index("model") for path, spec
                      in specs.items() if "model" in spec
                      and self.mesh.model > 1}
        n = self.view.shape["data"]
        self.data_split = {path: spec.index("data") for path, spec
                           in specs.items() if "data" in spec and n > 1}
        self.zero1 = {}
        if self.levers.zero1 and n > 1:
            self.zero1 = {path: spec.index("data") for path, spec
                          in zero1_shardings(params, self.view).items()
                          if "data" in spec and path not in self.data_split}
        dev = self.mesh.device

        def cut(path, leaf):
            if path in self.split or path in self.data_split:
                return local_shard(leaf, specs[path], self.view).to(
                    dev).clone(memory_format=torch.contiguous_format)
            return leaf.to(dev)
        return _rebuild(params, cut)

    def _moment_piece(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a shard leaf that its moments cover: its
        ZeRO-1 slice on the data axis (a view), or the leaf."""
        if path not in self.zero1:
            return leaf
        d = self.zero1[path]
        k = leaf.shape[d] // self.view.shape["data"]
        return leaf.narrow(d, self.view.coords["data"] * k, k)

    def init_moments(self, params) -> AdamWState:
        """Zero AdamW moments of this rank's shard ``params``: shaped like
        it, or with ``zero1`` like its slices on the data axis."""
        return init_adamw(_rebuild(params, self._moment_piece))

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

    def _sliced_norm(self, paths: List[str],
                     grads: List[torch.Tensor]) -> torch.Tensor:
        """:meth:`global_norm` where some gradients are the rank's slices
        on the data axis (ZeRO-1, 2-D experts): the squares of the leaves
        split on the model group summed over it, then those of the leaves
        split on the data axis summed over that (each slice counted
        once: the pods hold the same slices)."""
        dev = grads[0].device
        acc = torch.zeros((4,), dtype=torch.float32, device=dev)
        for path, g in zip(paths, grads):
            on_data = path in self.zero1 or path in self.data_split
            i = 2 * (path in self.split) + on_data   # rep, data, model, both
            acc[i] += torch.sum(torch.square(g.float()))
        rep, data, model, both = acc.unbind(0)
        if self.split and self.mesh.model_group is not None:
            model, both = self.mesh.model_group.all_reduce(
                torch.stack([model, both])).unbind(0)
        data, both = self.data_axis.all_reduce(
            torch.stack([data, both])).unbind(0)
        return torch.sqrt(rep + data + model + both)

    def _reduce_sliced(self, paths: List[str],
                       grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The data sums of a step with leaves split on the data axis:
        the whole leaves' gradients all-reduced over the data group as
        without the levers, each ZeRO-1 leaf's reduce-scattered over the
        data axis to the rank's slice (one collective a dtype), a 2-D
        expert leaf's kept (its rows are every data rank's already); on a
        multi-pod layout the slices then summed across the pods."""
        out = list(grads)
        whole = [g for p, g in zip(paths, grads)
                 if p not in self.zero1 and p not in self.data_split]
        if whole:
            _sum_over(self.mesh.data_group, whole)
        z = [i for i, p in enumerate(paths) if p in self.zero1]
        if z:
            parts = _scatter_over(self.data_axis, [grads[i] for i in z],
                                  [self.zero1[paths[i]] for i in z])
            for i, g in zip(z, parts):
                out[i] = g
        across = [g for p, g in zip(paths, out)
                  if p in self.zero1 or p in self.data_split]
        if self.pod is not None and across:
            _sum_over(self.pod, across)
        return out

    def __call__(self, params, opt_state: AdamWState, batch):
        return self.local_step(params, opt_state, self.rows(batch))

    def local_step(self, params, opt_state: AdamWState, local):
        """The step on this rank's rows of the batch (:meth:`rows`)."""
        paths, leaves = zip(*_sorted_paths(params))
        for p in leaves:
            p.requires_grad_()
        with torch.enable_grad():
            loss, aux = self.model.loss(params, local, remat=self.remat,
                                        data_group=self.mesh.data_group)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        sliced = bool(self.zero1 or self.data_split)
        if sliced:
            grads = self._reduce_sliced(list(paths), grads)
        elif self.mesh.data_group is not None:
            _sum_over(self.mesh.data_group, grads)
        shared = [g for path, g in zip(paths, grads)
                  if (path.rsplit("/", 1)[-1] in self.shared
                      or self.seq_norms.match(path))
                  and path not in self.split]
        if shared:
            _sum_over(self.mesh.model_group, shared)
        gnorm = (self._sliced_norm(list(paths), grads) if sliced
                 else self.global_norm(list(paths), grads))
        # AdamW on the slices the moments cover (views of the shard)
        updated, opt_state, info = adamw_update(
            self.opt_cfg, _like(params, iter(grads)), opt_state,
            _rebuild(params, self._moment_piece), gnorm=gnorm)
        if self.zero1:          # every data rank's updated slice, joined
            z = [p for p in paths if p in self.zero1]
            got, full = dict(_sorted_paths(updated)), dict(zip(paths, leaves))
            with torch.no_grad():
                _gather_into(self.data_axis, [got[p] for p in z],
                             [full[p] for p in z], [self.zero1[p] for p in z])
        aux = {k: v.detach() for k, v in aux.items()}
        aux["xent"] = all_reduce(aux["xent"], self.mesh.data_group)
        whole = aux["xent"] + aux["aux"] if "aux" in aux else aux["xent"]
        return params, opt_state, {"loss": whole, **aux, **info}

    def gather(self, params, moments: bool = False
               ) -> Optional[Dict[str, Any]]:
        """The whole tree on rank 0 (CPU tensors; None on the other
        ranks): every split leaf all-gathered over the data axis (2-D
        experts; a moment's ZeRO-1 slice with ``moments``) and the model
        group (every rank takes part), leaf by leaf."""
        group = self.mesh.model_group
        keep = self.mesh.rank == 0

        def one(path, leaf):
            leaf = leaf.detach()
            for dims, on in ((self.zero1, moments), (self.data_split, True)):
                if on and path in dims:
                    leaf = self.data_axis.all_gather(leaf.contiguous(),
                                                     dims[path])
            if path in self.split:
                leaf = group.all_gather(leaf, self.split[path])
            return leaf.cpu().clone() if keep else None
        out = _rebuild(params, one)
        return out if keep else None


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh,
                            remat: bool = False) -> ShardedTrainStep:
    """The sharded counterpart of :func:`make_train_step` on this rank of
    ``mesh`` (every rank makes one and calls it in step). Cut the shard
    with ``step.shard(whole_params)``; ``step.plan`` is its
    :class:`Plan` (:func:`sharding_mechanism`), ``step.mechanism`` the
    plan's mechanism."""
    return ShardedTrainStep(model, opt_cfg, mesh, remat)


@dataclasses.dataclass
class ShardedRun:
    """A sharded training job for :func:`train_sharded`. ``init``: a seed
    (every rank draws the same whole tree on its device and keeps its
    shard) or the whole tree as nested
    dicts of numpy arrays. ``log_every``: rank 0 prints the reference
    launcher's line every that many steps and at step 1 (0: never).
    ``gather`` names what rank 0 returns whole: ``"params"`` (the trained
    tree), ``"mu"``, ``"nu"`` (its AdamW moments); ``ckpt_path`` writes
    the tree there. ``settings`` carries the creating process' intra-op
    threads and TF32 switches (:func:`host_settings`) to every rank."""
    cfg: ModelConfig
    steps: int
    opt: AdamWConfig
    data: DataConfig
    init: Any = 0
    remat: bool = False
    log_every: int = 0
    gather: Tuple[str, ...] = ()
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
    steps, the shard's shapes, the peak memory (a card), and (rank 0)
    each part of ``gather`` whole, under its name."""
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
    opt_state = step.init_moments(params)
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
           "plan": dict(step.plan.blocks), "why": step.why,
           "history": history,
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
        for part in run.gather:
            tree = (whole if part == "params"
                    else step.gather(getattr(opt_state, part), True))
            if tree is not None:
                out[part] = tree
    return out
