"""Feed-forward layers: SwiGLU / GELU dense FFN and token-choice MoE — the
port of ``repro.models.mlp``.

Two MoE dispatch implementations, as in the reference:

  * ``dense``  — every token runs every expert, masked combine in f32.
    Exact and dropless; the serving engine's path (``moe_impl`` default).
    It makes no host read: routing, the combine weights and the expert
    products stay on the device, so a step keeps its one transfer.
  * ``gshard`` — capacity-based one-hot dispatch / combine (GShard /
    Switch): tokens past an expert's capacity are dropped with their
    combine weight.

The router works in f32 whatever the model dtype (its weight is kept f32),
and both return the Switch load-balance auxiliary loss beside the output.

Under serving tensor parallelism (``cfg.tp_axis``) the FFN dim F is the
split axis — every rank holds every expert, F / tp wide, and the whole
router — so each contraction over F is a partial sum, all-reduced once:
after ``w_down`` in :func:`ffn` (a GELU FFN's replicated ``b_down`` adds
after it), and after the f32 combine in the MoE (the combine is linear,
so one reduce of ``[N, D]`` stands for the reference's reduce of every
expert's ``[E, N, D]`` output). The training layout splits the expert
axis E instead (each rank E / tp whole experts, the router whole):
``moe_dense`` sees it in the leaf's shape, runs the rank's experts on
every row with their combine weights and reduces the same way. In
training the replicated inputs of the rank's products (the rows, the
combine weights) enter through ``copy_to_tp``. Under data parallelism
(the ``data_group`` argument of :func:`moe`) the aux loss's expert
fractions and mean probabilities are the whole batch's: sums over the
data group over its token count.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, act_fn, all_reduce,
                                       copy_to_tp, dense_init,
                                       psum_if_tp)

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


def ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    x = copy_to_tp(x, cfg)
    if "w_gate" in p:
        return psum_if_tp(
            (a(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"], cfg)
    return psum_if_tp(a(x @ p["w_up"] + p["b_up"]) @ p["w_down"], cfg) \
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
    """Batched expert FFN: xe [E, ..., D] -> [E, ..., D]."""
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
    out = psum_if_tp(out, cfg)
    return out.reshape(B, T, D).to(x.dtype), aux


def moe_gshard(p, cfg: ModelConfig, x: torch.Tensor,
               capacity_factor: float = 1.25, data_group=None):
    """Capacity-based dispatch: x [G, S, D] in G groups; each expert takes
    at most ``C = max(1, ceil(S·K/E·cf))`` (token, k) pairs per group, in
    token order, and drops the rest with their combine weight (GShard).
    Returns (out [G, S, D], aux)."""
    G, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(1, math.ceil(S * K / E * capacity_factor))

    xf = x.reshape(G * S, D)
    _, topw, topi, aux = _route(p, cfg, xf, data_group)
    topw = topw.reshape(G, S, K)
    topi = topi.reshape(G, S, K)

    # slot of each (token, k) pair within its expert, per group
    onehot = F.one_hot(topi, E).float()                          # [G,S,K,E]
    flat = onehot.reshape(G, S * K, E)
    prior = torch.cumsum(flat, dim=1) - flat                # earlier pairs
    slot = torch.einsum("gpe,gpe->gp", prior,
                        flat).reshape(G, S, K).to(torch.int32)

    # combine mask [G,S,E,C]: sum over K of weight * onehot(e) * onehot(slot)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        keep = (slot[..., k] < C).float() * topw[..., k]
        slot_oh = F.one_hot(torch.clamp(slot[..., k], max=C - 1).long(),
                            C).float()                           # [G,S,C]
        combine = combine + (keep[..., None, None]
                             * onehot[:, :, k, :, None]
                             * slot_oh[:, :, None, :])
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, x)             # [E,G,C,D]
    y = _experts(p, cfg, xe)                                     # [E,G,C,D]
    out = psum_if_tp(torch.einsum("egcd,gsec->gsd", y.float(), combine), cfg)
    return out.to(x.dtype), aux


def moe(p, cfg: ModelConfig, x: torch.Tensor, impl: str | None = None,
        data_group=None):
    impl = impl or cfg.moe_impl
    if impl == "dense":
        return moe_dense(p, cfg, x, data_group=data_group)
    if impl == "gshard":
        return moe_gshard(p, cfg, x, data_group=data_group)
    raise ValueError(f"unknown moe impl {impl!r}")
