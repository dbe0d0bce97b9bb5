"""GSPMD's sharding rules as the port reads them — the port's copy of
``repro.launch.shardings``: the training layout (parameters, ZeRO-1
moments, batches, decode caches) and the serving overrides.

Name-based rules map a parameter's path (``"layers/attn/wq"``) to a
spec: one entry per dim, a mesh axis name (``"model"``, ``"data"``; a
tuple of names for a dim split over several) on the dims that split and
``None`` elsewhere, or ``()`` for a leaf every rank holds whole — the
reference's ``PartitionSpec`` as a tuple. A dim that does not divide
stays whole, as the reference's rules fall back to replication.

Training shards tensor-parallel weights on ``model`` (attention heads,
the FFN dim, the expert axis, the vocab), the batch on ``('pod',
'data')`` and decode caches by size (batch on ``data``; heads, else the
sequence or head_dim, on ``model``). The serving layout is the training
rules' for every dense decoder weight — ``wq``/``wk``/``wv`` and their
biases split the head dim, ``wo`` its H·Dh contraction dim, the FFN's
``w_gate``/``w_up``/``b_up`` split F and ``w_down`` its F contraction
dim, ``embed`` splits V (rows) and ``unembed`` V (columns) — with one
override: the serving engine keeps every MoE expert on every rank and
splits the per-expert F (the router stays whole), so ``moe_dense``
needs one all-reduce after its ``w_down`` contraction. :func:`shard_params`
cuts one rank's serving shard of a param tree, :func:`local_shard` a
leaf's piece on one rank of a training mesh; a KV pool, or a migration
piece, splits on its kv-head axis (:func:`pool_spec_tree`;
:func:`split_pool` and :func:`join_pool` cut it into the ranks' shares
and put them back, so the wire stays the unsharded piece). A mesh here
is anything with the reference mesh's ``shape`` (axis name -> size) and
``axis_names``: a ``launch.mesh.Layout`` or a ``TrainMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.migration import tree_map
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.common import cache_spec

Spec = Tuple[Optional[str], ...]

# (path regex, dim index from the END to shard on "model"; -1: whole)
PARAM_RULES: Sequence[Tuple[str, int]] = (
    (r"(^|/)embed$", 2),                 # [V, D] -> shard V
    (r"(^|/)unembed$", 1),               # [D, V] -> shard V
    (r"moe/router$", -1),                # replicated (tiny, f32)
    (r"moe/w_(gate|up|down)$", 3),       # [L, E, D, F] -> expert parallel
    (r"attn/w[qkv]$", 1),
    (r"attn/b[qkv]$", 1),
    (r"attn/wo$", 2),
    (r"ffn/w_(gate|up)$", 1),
    (r"ffn/b_up$", 1),
    (r"ffn/w_down$", 2),
    # rwkv6
    (r"(^|/)w_[rkvg]$", 1),
    (r"(^|/)w_o$", 2),
    (r"(^|/)cw_[kr]$", 1),
    (r"(^|/)cw_v$", 2),
    # zamba2 mamba blocks
    (r"mamba/w_in$", 1),
    (r"mamba/conv_w$", 1),
    (r"mamba/conv_b$", 1),
    (r"mamba/ln_gate$", 1),
    (r"mamba/w_out$", 2),
)

# the serving engine keeps experts whole and splits the per-expert F
_SERVING_OVERRIDES: Sequence[Tuple[str, int]] = (
    (r"moe/router$", -1),                # replicated
    (r"moe/w_(gate|up)$", 1),            # [L, E, D, F] -> split F
    (r"moe/w_down$", 2),                 # [L, E, F, D] -> split F
)


def _spec(rules, path: str, shape: Tuple[int, ...],
          model_size: int) -> Optional[Spec]:
    """The first matching rule's spec (None: no rule matches)."""
    for pat, dim_from_end in rules:
        if re.search(pat, path):
            if dim_from_end < 0:
                return ()
            d = len(shape) - dim_from_end
            spec: list = [None] * len(shape)
            if 0 <= d < len(shape) and shape[d] % model_size == 0:
                spec[d] = "model"
            return tuple(spec) if any(spec) else ()
    return None


_EXPERTS = r"moe/w_(gate|up|down)$"


def param_spec(path: str, shape: Tuple[int, ...], model_size: int, *,
               expert_2d: bool = False, data_size: int = 0) -> Spec:
    """The training layout's spec of one parameter. ``expert_2d`` also
    splits an expert leaf's FFN dim on ``data`` (where it divides
    ``data_size``): each chip holds E / model experts, F / data wide."""
    spec = _spec(PARAM_RULES, path, shape, model_size)
    if spec is None:
        return ()
    if expert_2d and re.search(_EXPERTS, path):
        out = list(spec) or [None] * len(shape)
        ffn_d = len(shape) - (1 if path.endswith(("w_gate", "w_up"))
                              else 2)
        if (out[ffn_d] is None and data_size
                and shape[ffn_d] % data_size == 0):
            out[ffn_d] = "data"
        spec = tuple(out) if any(a is not None for a in out) else ()
    return spec


def serving_param_spec(path: str, shape: Tuple[int, ...],
                       model_size: int) -> Spec:
    """The spec of one serving parameter under tensor parallelism."""
    spec = _spec(_SERVING_OVERRIDES, path, shape, model_size)
    return param_spec(path, shape, model_size) if spec is None else spec


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def param_shardings(params: Mapping, mesh, *,
                    expert_2d: bool = False) -> Dict[str, Spec]:
    """``{path: spec}`` of a param tree (tensors, or anything with a
    ``shape``) under the training layout on ``mesh``."""
    model_size = mesh.shape["model"]
    data_size = mesh.shape.get("data", 1)
    return {path: param_spec(path, tuple(leaf.shape), model_size,
                             expert_2d=expert_2d, data_size=data_size)
            for path, leaf in _leaves(params)}


def zero1_shardings(params: Mapping, mesh) -> Dict[str, Spec]:
    """ZeRO-1: the spec of each AdamW moment, ``{path: spec}``: the
    parameter's training spec plus its largest still-whole dim that
    ``data`` divides on ``data`` (the largest index among equal sizes,
    as the reference picks)."""
    model_size = mesh.shape["model"]
    data_size = mesh.shape.get("data", 1)
    out = {}
    for path, leaf in _leaves(params):
        shape = tuple(leaf.shape)
        spec = list(param_spec(path, shape, model_size))
        spec += [None] * (len(shape) - len(spec))
        cands = [(dim, i) for i, (dim, ax) in enumerate(zip(shape, spec))
                 if ax is None and dim % data_size == 0
                 and dim >= data_size]
        if cands:
            spec[max(cands)[1]] = "data"
        out[path] = tuple(spec)
    return out


def _axis_size(mesh, ax) -> int:
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= mesh.shape[a]
    return n


def _guard(shape, spec, mesh) -> Spec:
    """Drop split dims that do not divide; a one-axis tuple is written as
    its name, as ``PartitionSpec`` normalises it."""
    return tuple(None if ax is None or dim % _axis_size(mesh, ax) else
                 ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for dim, ax in zip(shape, spec))


def batch_shardings(batch: Mapping, mesh) -> Dict[str, Spec]:
    """``{key: spec}`` of a batch dict: dim 0 (the global batch) on the
    batch axes (:func:`~repro_torch.launch.mesh.batch_axes`), kept whole
    where it does not divide."""
    ba = batch_axes(mesh)
    return {k: _guard(tuple(v.shape),
                      [ba] + [None] * (len(v.shape) - 1), mesh)
            for k, v in batch.items()}


def cache_shardings(cache, mesh, *, batch_size: int, cache_seq: int,
                    context_parallel: bool = False,
                    seq_on_model: bool = False):
    """The spec of each leaf of a decode cache (a ``KVCache``, a state
    dict, a ``WhisperCache``: the same structure, a spec per leaf), by
    the rule of :func:`~repro_torch.models.common.cache_spec`: axes found
    by SIZE, the batch on ``data`` (the sequence with
    ``context_parallel``), ``model`` on the first later dim it divides
    among the heads, the sequence (``seq_on_model`` only) and the last
    (head_dim). The model layer lays a rank's decode state out by the
    same function (``common.state_piece``)."""
    def one(leaf):
        shape = tuple(leaf.shape)
        return _guard(shape, cache_spec(
            shape, batch_size=batch_size, cache_seq=cache_seq,
            data=mesh.shape["data"], model=mesh.shape["model"],
            context_parallel=context_parallel, seq_on_model=seq_on_model),
            mesh)

    return tree_map(one, cache)


def replicated(mesh) -> Spec:
    """The spec of a value every rank holds whole."""
    return ()


def serving_param_spec_tree(params: Mapping, tp: int) -> Dict[str, Spec]:
    """``{path: spec}`` of a serving param tree at ``tp`` ranks."""
    return {path: serving_param_spec(path, tuple(leaf.shape), tp)
            for path, leaf in _leaves(params)}


def pool_spec_tree(pool) -> Tuple[Spec, ...]:
    """The spec of each leaf of a paged KV pool, or of a contiguous KV
    piece: the kv-head axis — dim 3 of ``[L, NB, BS, Hkv, Dh]`` rows and
    of ``[L, NB, BS, Hkv]`` int8 scales — splits; block ids and every
    other axis stay whole, so the allocator, the prefix index and the
    migration wire never see the ranks."""
    specs = []
    for leaf in pool:
        if leaf.dim() < 4:
            raise ValueError(f"pool leaf rank {leaf.dim()} < 4")
        spec = [None] * leaf.dim()
        spec[3] = "model"
        specs.append(tuple(spec))
    return tuple(specs)


def shard_leaf(x: torch.Tensor, spec: Spec, tp: int,
               rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` under ``spec`` (a view; ``x``
    itself for a whole leaf)."""
    for d, ax in enumerate(spec):
        if ax is not None:
            n = x.shape[d] // tp
            return x.narrow(d, rank * n, n)
    return x


def local_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` under ``spec`` on a mesh with
    ``shape`` and ``coords`` (a ``TrainMesh``): each split dim cut by the
    product of its axes' sizes at the rank's combined index (a view;
    ``x`` itself for a whole leaf)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        idx = 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        n = x.shape[d] // _axis_size(mesh, names)
        x = x.narrow(d, idx * n, n)
    return x


def shard_params(params: Mapping, tp: int, rank: int,
                 specs: Optional[Dict[str, Spec]] = None):
    """Rank ``rank``'s shard of a serving param tree, the same nesting:
    split leaves are fresh contiguous tensors on the leaf's device, whole
    leaves the caller's own tensors."""
    specs = specs or serving_param_spec_tree(params, tp)

    def walk(tree: Mapping, prefix: str):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                out[k] = walk(v, path)
            elif specs[path]:
                out[k] = shard_leaf(v, specs[path], tp, rank).clone(
                    memory_format=torch.contiguous_format)
            else:
                out[k] = v
        return out
    return walk(params, "")


def split_pool(pool, tp: int):
    """The ``tp`` ranks' shares of a pool or a piece (each leaf split by
    :func:`pool_spec_tree`), each of the pool's own type (views)."""
    specs = pool_spec_tree(pool)
    return [type(pool)(*(shard_leaf(a, s, tp, r) for a, s in zip(pool, specs)))
            for r in range(tp)]


def join_pool(shares):
    """The ranks' shares (in rank order) as one piece."""
    specs = pool_spec_tree(shares[0])
    return type(shares[0])(*(torch.cat(leaves, dim=s.index("model"))
                             for leaves, s in zip(zip(*shares), specs)))


def param_leaves(params: Mapping):
    """``(path, leaf)`` of every tensor of a param tree, in tree order."""
    return list(_leaves(params))


def params_from_leaves(leaves) -> Dict[str, Any]:
    """The nested tree of ``(path, leaf)`` pairs (:func:`param_leaves`'
    inverse)."""
    out: Dict[str, Any] = {}
    for path, leaf in leaves:
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out
