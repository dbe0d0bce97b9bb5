"""Feed-forward layers: SwiGLU / GELU dense FFN and token-choice MoE — the
port of ``repro.models.mlp``.

Two MoE dispatch implementations, as in the reference:

  * ``dense``  — every token runs every expert, masked combine in f32.
    Exact and dropless; the serving engine's path (``moe_impl`` default).
    It makes no host read: routing, the combine weights and the expert
    products stay on the device, so a step keeps its one transfer.
  * ``gshard`` — capacity-based one-hot dispatch / combine (GShard /
    Switch): tokens past an expert's capacity are dropped with their
    combine weight. On a rank's share of the experts (the training
    layout) it dispatches by index instead (:func:`gshard_cells`): the
    rank's kept (token, k) pairs are gathered into a ``[E/m, G, C, D]``
    buffer, its experts run on it, each pair reads its row back, and one
    f32 all-reduce of ``[G, S, D]`` sums the ranks' shares, as the
    reference's GSPMD program does. No one-hot ``[G, S, E, C]`` tensor.

The router works in f32 whatever the model dtype (its weight is kept f32),
and both return the Switch load-balance auxiliary loss beside the output.

Under serving tensor parallelism (``cfg.tp_axis``) the FFN dim F is the
split axis — every rank holds every expert, F / tp wide, and the whole
router — so each contraction over F is a partial sum, all-reduced once:
after ``w_down`` in :func:`ffn` (a GELU FFN's replicated ``b_down`` adds
after it), and after the f32 combine in the MoE (the combine is linear,
so one reduce of ``[N, D]`` stands for the reference's reduce of every
expert's ``[E, N, D]`` output). The training layout splits the expert
axis E instead (each rank E / tp whole experts, the router whole): both
MoEs see it in the leaf's shape — ``moe_dense`` runs the rank's experts
on every row with their combine weights, ``moe_gshard`` on the rank's
kept pairs — and reduce the same way. In training the replicated inputs
of the rank's products (the rows, the combine weights) enter through
``copy_to_tp``; a block the training mesh's per-leaf plan gathers
(``cfg.tp_plan``: the FFN where F does not divide, the experts where E
does not) all-gathers its split leaves at its use and runs whole. Under
data parallelism
(the ``data_group`` argument of :func:`moe`) the aux loss's expert
fractions and mean probabilities are the whole batch's: sums over the
data group over its token count. With 2-D experts (the ``expert_2d``
lever) each rank also holds only F / d of its experts' FFN dim, split
on the data axis: :func:`_experts` runs its slice on every data rank's
dispatched rows and reduce-scatters the partial down-projection back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ModelConfig, act_fn, all_reduce,
                                       block_in, block_out, copy_to_tp,
                                       dense_init, leaf_at_use,
                                       reduce_scatter, seq_gather,
                                       split_block, unsplit)

# moe_dense's temporaries per tile of tokens (inputs broadcast to every
# expert, the gate/up/down products, the f32 combine): at qwen3-moe's
# widths ~3.7 MB a token, so a tile of ~290 tokens
MOE_TILE_BYTES = 1 << 30


# --------------------------------------------------------------------------
# Dense FFN
# --------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg: ModelConfig,
             num_layers: int | None):
    """Layer-stacked FFN weights ``[L, in, out]`` (``num_layers=None``:
    one layer's, ``[in, out]``)."""
    d, f = cfg.d_model, cfg.d_ff
    L = () if num_layers is None else (num_layers,)
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, L + (d, f), cfg.dtype, fan_in=d),
            "w_up": dense_init(gen, L + (d, f), cfg.dtype, fan_in=d),
            "w_down": dense_init(gen, L + (f, d), cfg.dtype, fan_in=f),
        }
    dev = gen.device
    return {
        "w_up": dense_init(gen, L + (d, f), cfg.dtype, fan_in=d),
        "b_up": torch.zeros(L + (f,), dtype=cfg.dtype, device=dev),
        "w_down": dense_init(gen, L + (f, d), cfg.dtype, fan_in=f),
        "b_down": torch.zeros(L + (d,), dtype=cfg.dtype, device=dev),
    }


# the dim of each FFN leaf that the training layout splits (F)
_FFN_SPLIT = {"w_gate": -1, "w_up": -1, "b_up": -1, "w_down": -2}


def ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN of x [..., D]; under a group, F split (a partial
    product, all-reduced once), or with the plan's ``mlp`` block gathered
    the whole FFN on every rank from its leaves gathered at use."""
    if cfg.tp_axis is not None and not split_block(cfg, "mlp"):
        whole = {k: leaf_at_use(w, cfg, _FFN_SPLIT[k], cfg.d_ff)
                 if k in _FFN_SPLIT else w for k, w in p.items()}
        return ffn(whole, unsplit(cfg), x)
    a = act_fn(cfg.act)
    x = block_in(x, cfg)
    if "w_gate" in p:
        return block_out(
            (a(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"], cfg)
    return block_out(a(x @ p["w_up"] + p["b_up"]) @ p["w_down"], cfg) \
        + p["b_down"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig, num_layers: int):
    """Layer-stacked MoE weights: the f32 router ``[L, D, E]`` and the
    experts ``[L, E, D, F]`` / ``[L, E, F, D]``. The reference draws an
    expert leaf ``[E, D, F]`` with ``fan_in = shape[0]``, which is E, so
    every expert weight has std ``1/sqrt(E)``; the router's is
    ``1/sqrt(D)``."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.num_experts, num_layers
    return {
        "router": dense_init(gen, (L, d, e), torch.float32, fan_in=d),
        "w_gate": dense_init(gen, (L, e, d, f), cfg.dtype, fan_in=e),
        "w_up": dense_init(gen, (L, e, d, f), cfg.dtype, fan_in=e),
        "w_down": dense_init(gen, (L, e, f, d), cfg.dtype, fan_in=e),
    }


def _route(p, cfg: ModelConfig, xf: torch.Tensor, data_group=None):
    """xf [N, D] -> (probs [N, E], topw [N, K], topi [N, K], aux): f32
    router and softmax, the top K in descending order (as ``lax.top_k``),
    renormalised by ``max(sum, 1e-9)``, and the Switch aux loss; with a
    ``data_group`` (xf this rank's rows of a batch split over it) the aux
    loss's statistics are the whole batch's."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1, sorted=True)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # the one-hots summed over K: the K experts of a token are distinct
    chosen = torch.zeros_like(probs).scatter_(1, topi, 1.0)
    if data_group is None:
        frac = chosen.mean(0)                               # tokens/expert
        prob = probs.mean(0)
    else:       # the whole batch's: sums over the data group, its count
        n = chosen.new_full((1,), chosen.shape[0])
        stats = data_group.all_reduce(torch.cat([chosen.sum(0), n]))
        frac = stats[:E] / stats[E]
        prob = all_reduce(probs.sum(0), data_group) / stats[E]
    aux = E * torch.sum(frac * prob) * cfg.router_aux_coef
    return probs, topw, topi, aux


def _experts(p, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: xe [E, ..., D] -> [E, ..., D]. With 2-D
    experts (``cfg.tp_data``, the data-axis group) expert leaves
    narrower than ``d_ff`` are this rank's F / d slice: the rows of dim 1
    (the groups) of every data rank are gathered, the rank's slice runs
    on them, and the partial down-projection is reduce-scattered back, so
    each data rank holds its own rows' sum over F (under autograd the
    gather's backward reduce-scatters and the reduce-scatter's gathers:
    ``common.seq_gather``, ``common.reduce_scatter``). Serving tensor
    parallelism's F split is the caller's to all-reduce."""
    g = cfg.tp_data
    if g is not None and p["w_gate"].shape[-1] < cfg.d_ff:
        return reduce_scatter(_expert_ffn(p, cfg, seq_gather(xe, g, 1)), g,
                              1)
    return _expert_ffn(p, cfg, xe)


def _expert_ffn(p, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    E, D = xe.shape[0], xe.shape[-1]
    x3 = xe.reshape(E, -1, D)
    h = torch.bmm(x3, p["w_gate"])
    u = torch.bmm(x3, p["w_up"])
    y = torch.bmm(a(h) * u, p["w_down"])
    return y.reshape(xe.shape)


def moe_token_tile(cfg: ModelConfig, elem_bytes: int) -> int:
    """Tokens per ``moe_dense`` tile: its temporaries per token are the
    input broadcast to E experts, the gate, up, product and output rows
    (``elem_bytes`` each) and the output in f32 twice (the cast and the
    combine's operand), all E wide; a tile stays within
    ``MOE_TILE_BYTES``. From host shapes only."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    per_token = E * (2 * D * elem_bytes + 3 * Fd * elem_bytes + 8 * D)
    return max(1, MOE_TILE_BYTES // per_token)


def moe_dense(p, cfg: ModelConfig, x: torch.Tensor, data_group=None):
    """Exact dropless MoE by running all experts on all tokens: x [B, T, D]
    -> (out [B, T, D] in x's dtype, aux). The combine is in f32 against
    the top-K weights scattered to ``[N, E]``. Tokens are independent, so
    the token axis runs in tiles of :func:`moe_token_tile` tokens and any
    tiling gives the same output. Expert leaves of fewer than E experts
    are a tensor-parallel rank's share of the expert axis (the training
    layout): rank r's E / tp experts start at ``r * E / tp``."""
    B, T, D = x.shape
    E = cfg.num_experts
    xf = x.reshape(B * T, D)
    _, topw, topi, aux = _route(p, cfg, xf, data_group)
    combine = torch.zeros((B * T, E), dtype=torch.float32,
                          device=x.device).scatter_(1, topi, topw)
    combine = copy_to_tp(combine, cfg)
    xf = copy_to_tp(xf, cfg)
    e_loc = p["w_gate"].shape[-3]
    if e_loc < E:
        e0 = cfg.tp_axis.rank * e_loc
        combine = combine[:, e0:e0 + e_loc]
    tile = moe_token_tile(cfg, x.element_size())
    out = torch.empty((B * T, D), dtype=torch.float32, device=x.device)
    for s in range(0, B * T, tile):
        xs = xf[s:s + tile]
        y = _experts(p, cfg, xs.expand((e_loc,) + xs.shape))   # [E, n, D]
        out[s:s + tile] = torch.einsum("end,ne->nd", y.float(),
                                       combine[s:s + tile])
    return block_out(out.reshape(B, T, D), cfg).to(x.dtype), aux


def gshard_slots(topi: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The slot of each (token, k) pair within its expert, per group:
    topi [G, S, K] -> int32 [G, S, K], the number of the group's earlier
    pairs (in token order, then k) routed to the same expert. The
    exclusive cumsum of the pairs' one-hots, as the reference's, but in
    int32 (exact at any count) and read back by a gather, not a
    product."""
    G, S, K = topi.shape
    idx = topi.reshape(G, S * K, 1)
    onehot = torch.zeros((G, S * K, num_experts), dtype=torch.int32,
                         device=topi.device).scatter_(2, idx, 1)
    seen = torch.cumsum(onehot, dim=1, dtype=torch.int32)   # with itself
    return (seen.gather(2, idx) - 1).reshape(G, S, K)


def gshard_cells(topi: torch.Tensor, slot: torch.Tensor, e0: int,
                 e_loc: int, capacity: int):
    """Where each (token, k) pair of topi / slot [G, S, K] lies in a
    rank's capacity buffer ``[e_loc, G, C]`` of experts ``[e0, e0 +
    e_loc)``: (cell, keep), ``cell`` the flat index of ``(e - e0, g,
    slot)``, ``keep`` whether the pair is the rank's (its expert one of
    the rank's, its slot below C). ``cell`` means something only where
    ``keep`` holds; there no two pairs share a cell (slots are distinct
    within a group's expert)."""
    G = topi.shape[0]
    local = topi - e0
    keep = (local >= 0) & (local < e_loc) & (slot < capacity)
    g = torch.arange(G, device=topi.device).view(G, 1, 1)
    return (local * G + g) * capacity + slot, keep


def _moe_gshard_split(p, cfg: ModelConfig, x: torch.Tensor,
                      topw: torch.Tensor, topi: torch.Tensor,
                      C: int) -> torch.Tensor:
    """GShard on a rank's E / m experts (rank r's start at ``r·E/m``): x
    [G, S, D] -> out [G, S, D] in x's dtype, the rank's share summed over
    the model group. Every rank holds the same rows and routing, so all
    compute the same slots and drops. Dispatch by index: each capacity
    row ``(e - e0, g, c)`` learns its pair's token from one ``index_put_``
    of token ids (each kept pair into its own cell; every other pair
    into a cell of its own past the buffer, so no index repeats), then
    gathers its row (an empty row gathers zeros). Combine by gather:
    each kept pair reads its expert's output row back, weighed in f32,
    summed over k; one f32 all-reduce. The rows and the weights enter
    through ``copy_to_tp`` (their gradients are summed over the
    group)."""
    G, S, D = x.shape
    K = topi.shape[-1]
    e_loc = p["w_gate"].shape[-3]
    n, P = e_loc * G * C, G * S * K            # capacity rows, pairs
    slot = gshard_slots(topi, cfg.num_experts)
    cell, keep = gshard_cells(topi, slot, cfg.tp_axis.rank * e_loc, e_loc,
                              C)
    pair = torch.arange(P, device=x.device)
    dest = torch.where(keep.reshape(P), cell.reshape(P), n + pair)
    token = torch.full((n + P,), G * S, dtype=torch.long, device=x.device)
    token.index_put_((dest,), pair // K)
    xf = copy_to_tp(x.reshape(G * S, D), cfg)
    rows = torch.cat([xf, xf.new_zeros((1, D))])
    xe = rows[token[:n]].view(e_loc, G, C, D)
    y = _experts(p, cfg, xe).reshape(n, D)
    y = torch.cat([y, y.new_zeros((1, D))])     # row n: a dropped pair's
    at = torch.where(keep, cell, n).reshape(G * S, K)
    w = torch.where(keep, copy_to_tp(topw, cfg), 0.0).reshape(G * S, K)
    out = torch.zeros((G * S, D), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + y[at[:, k]].float() * w[:, k, None]
    return block_out(out.reshape(G, S, D), cfg).to(x.dtype)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hots of ``idx`` over ``n`` classes (``[..., n]``), by one
    scatter: the same ops on every device (``F.one_hot`` checks its
    range on the CPU, so a rank's program would count other ops there
    than in its trace)."""
    return torch.zeros(idx.shape + (n,), dtype=torch.float32,
                       device=idx.device).scatter_(-1, idx.long()[..., None],
                                                   1.0)


def moe_gshard(p, cfg: ModelConfig, x: torch.Tensor,
               capacity_factor: float = 1.25, data_group=None):
    """Capacity-based dispatch: x [G, S, D] in G groups; each expert takes
    at most ``C = max(1, ceil(S·K/E·cf))`` (token, k) pairs per group, in
    token order, and drops the rest with their combine weight (GShard).
    Returns (out [G, S, D], aux). Expert leaves of fewer than E experts
    are a rank's share of the expert axis (the training layout): then
    :func:`_moe_gshard_split`; whole ones take the reference's one-hot
    dispatch and combine."""
    G, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(1, math.ceil(S * K / E * capacity_factor))

    xf = x.reshape(G * S, D)
    _, topw, topi, aux = _route(p, cfg, xf, data_group)
    topw = topw.reshape(G, S, K)
    topi = topi.reshape(G, S, K)
    if p["w_gate"].shape[-3] < E:
        return _moe_gshard_split(p, cfg, x, topw, topi, C), aux

    # slot of each (token, k) pair within its expert, per group
    onehot = _one_hot(topi, E)                                   # [G,S,K,E]
    flat = onehot.reshape(G, S * K, E)
    prior = torch.cumsum(flat, dim=1) - flat                # earlier pairs
    slot = torch.einsum("gpe,gpe->gp", prior,
                        flat).reshape(G, S, K).to(torch.int32)

    # combine mask [G,S,E,C]: sum over K of weight * onehot(e) * onehot(slot)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        keep = (slot[..., k] < C).float() * topw[..., k]
        slot_oh = _one_hot(torch.clamp(slot[..., k], max=C - 1),
                           C)                                    # [G,S,C]
        combine = combine + (keep[..., None, None]
                             * onehot[:, :, k, :, None]
                             * slot_oh[:, :, None, :])
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, x)             # [E,G,C,D]
    y = _experts(p, cfg, xe)                                     # [E,G,C,D]
    out = block_out(torch.einsum("egcd,gsec->gsd", y.float(), combine), cfg)
    return out.to(x.dtype), aux


def moe(p, cfg: ModelConfig, x: torch.Tensor, impl: str | None = None,
        data_group=None):
    """The MoE of x [B, T, D] -> (out, aux) by ``impl`` (default
    ``cfg.moe_impl``). With the plan's ``experts`` block gathered (E does
    not divide the model axis) each layer's expert leaves are
    all-gathered on E at their use and every rank runs the whole MoE,
    the router whole."""
    if cfg.tp_axis is not None and not split_block(cfg, "experts"):
        whole = {k: w if k == "router" else
                 leaf_at_use(w, cfg, -3, cfg.num_experts)
                 for k, w in p.items()}
        return moe(whole, unsplit(cfg), x, impl, data_group)
    impl = impl or cfg.moe_impl
    if impl == "dense":
        return moe_dense(p, cfg, x, data_group=data_group)
    if impl == "gshard":
        return moe_gshard(p, cfg, x, data_group=data_group)
    raise ValueError(f"unknown moe impl {impl!r}")
