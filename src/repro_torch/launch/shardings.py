"""Serving tensor-parallel sharding rules — the port's copy of the serving
part of ``repro.launch.shardings``.

Name-based rules map a parameter's path (``"layers/attn/wq"``) to a
spec: one entry per dim, ``"model"`` on the dim that splits over the
tensor-parallel ranks and ``None`` elsewhere, or ``()`` for a leaf every
rank holds whole. A dim that does not divide stays whole (the engine
refuses the dims that must split: heads, kv heads, vocab and ``d_ff``).

The serving layout is the training rules' for every dense decoder weight
— ``wq``/``wk``/``wv`` and their biases split the head dim, ``wo`` its
H·Dh contraction dim, the FFN's ``w_gate``/``w_up``/``b_up`` split F and
``w_down`` its F contraction dim, ``embed`` splits V (rows) and
``unembed`` V (columns) — with one override: the serving engine keeps
every MoE expert on every rank and splits the per-expert F (the router
stays whole), so ``moe_dense`` needs one all-reduce after its
``w_down`` contraction. :func:`shard_params` cuts one rank's shard of a
param tree by these rules; a KV pool, or a migration piece, splits on its
kv-head axis (:func:`pool_spec_tree`; :func:`split_pool` and
:func:`join_pool` cut it into the ranks' shares and put them back, so
the wire stays the unsharded piece).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

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


def param_spec(path: str, shape: Tuple[int, ...], model_size: int) -> Spec:
    """The training layout's spec of one parameter (the reference's
    ``param_spec`` without its 2-D expert option)."""
    spec = _spec(PARAM_RULES, path, shape, model_size)
    return () if spec is None else spec


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
