"""Decoder-only transformer stack (dense GQA, MoE and the VLM backbone) —
the port's subset of ``repro.models.transformer``: the whole-prompt pass,
decode against the monolithic slab, and the paged pool's decode,
chunked-prefill and mixed passes. An MoE block runs ``mlp.moe`` (plus
arctic's dense residual FFN); a VLM places precomputed patch embeddings at
its vision positions and rotates by M-RoPE's three position streams.

Per-layer weights are stacked on a leading ``L`` axis as in the JAX
package; the ``lax.scan`` over layers becomes a Python loop over ``[l]``
slices (views, no copies). The slab ``[L, B, S, Hkv, Dh]`` and the pool
``[L, NB, BS, Hkv, Dh]`` are updated in place, layer by layer. A sliding
window runs the whole-prompt pass and the slab decode (its ring); the
paged passes are full-attention only, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.ops import flat_work_list
from repro_torch.models import attention as attn
from repro_torch.models.attention import (KVCache, layer_pool, make_cache,
                                         make_paged_pool)
from repro_torch.models.common import (ModelConfig, all_gather, copy_to_tp,
                                       dense_init, embed_init, leaf_at_use,
                                       psum_if_tp, rms_norm, seq_block,
                                       seq_layers, seq_slice, split_block,
                                       unsplit)
from repro_torch.models.mlp import ffn, init_ffn, init_moe, moe


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_decoder(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device, drawn directly in the stacked
    layout (no per-layer copies to stack)."""
    d, L = cfg.d_model, cfg.num_layers
    dev, dt = gen.device, cfg.dtype
    att = attn.init_attention(gen, cfg, L)
    layers = {
        "ln_attn": torch.ones((L, d), dtype=dt, device=dev),
        "ln_mlp": torch.ones((L, d), dtype=dt, device=dev),
        "attn": att,
    }
    if cfg.num_experts:
        layers["moe"] = init_moe(gen, cfg, L)
        if cfg.dense_residual:       # arctic: a dense FFN beside the MoE
            layers["ffn"] = init_ffn(gen, cfg, L)
            layers["ln_res"] = torch.ones((L, d), dtype=dt, device=dev)
    else:
        layers["ffn"] = init_ffn(gen, cfg, L)
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt),
        "layers": layers,
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (d, cfg.vocab_size), dt)
    return p


def layer_params(layers, l: int):
    """Layer ``l``'s slice of the stacked weights (views)."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in layers.items()}


# --------------------------------------------------------------------------
# Embedding in/out, MLP half of a block
# --------------------------------------------------------------------------
def embed_tokens(p, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds=None, vision_mask=None) -> torch.Tensor:
    """Token embeddings [B, T, D]; with ``vision_embeds`` [B, P, D] and
    ``vision_mask`` [B, T] bool, the patch embeddings (the VLM's stubbed
    frontend) replace the masked positions, in order. Under tensor
    parallelism each rank holds V / tp consecutive rows: an id outside
    them reads a clamped row that is zeroed, and the all-reduce
    assembles the one real row — exact, since one rank contributes it.
    With the plan's ``embed`` block gathered, the table is gathered at
    its use and every rank looks up whole rows."""
    if cfg.tp_axis is not None and not split_block(cfg, "embed"):
        whole = {"embed": leaf_at_use(p["embed"], cfg, 0, cfg.vocab_size)}
        return embed_tokens(whole, unsplit(cfg), tokens, vision_embeds,
                            vision_mask)
    if cfg.tp_axis is not None:
        vloc = p["embed"].shape[0]
        local = tokens.long() - cfg.tp_axis.rank * vloc
        ok = (local >= 0) & (local < vloc)
        x = F.embedding(torch.clamp(local, 0, vloc - 1), p["embed"])
        x = psum_if_tp(torch.where(ok[..., None], x, torch.zeros_like(x)),
                       cfg)
    else:
        x = F.embedding(tokens.long(), p["embed"])
    if vision_embeds is not None and vision_mask is not None:
        idx = torch.cumsum(vision_mask.to(torch.int32), dim=1) - 1
        idx = torch.clamp(idx, 0, vision_embeds.shape[1] - 1).long()
        gathered = torch.gather(
            vision_embeds, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        x = torch.where(vision_mask[..., None], gathered.to(x.dtype), x)
    return x


def unembed(p, cfg: ModelConfig, x: torch.Tensor,
            gather: bool = True) -> torch.Tensor:
    """Logits [..., V]. Under tensor parallelism each rank computes its
    V / tp columns (tied embeddings split V on dim 0, so the transpose
    lines up) and the all-gather gives every rank the whole vocabulary:
    argmax then runs on each rank and they all hold the same tokens. In
    training ``x`` enters through ``copy_to_tp`` and the gather hands
    each rank its columns' gradient; ``gather=False`` leaves them this
    rank's columns (a vocab-parallel loss,
    ``common.vocab_split_terms``). With the plan's ``unembed`` block
    gathered, the leaf is gathered at its use and applied whole."""
    if cfg.tp_axis is not None and not split_block(cfg, "unembed"):
        V = cfg.vocab_size
        return x @ (leaf_at_use(p["embed"], cfg, 0, V).T
                    if cfg.tie_embeddings
                    else leaf_at_use(p["unembed"], cfg, -1, V))
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    if cfg.tp_axis is None:
        return x @ w
    logits = copy_to_tp(x, cfg) @ w
    return all_gather(logits, cfg.tp_axis) if gather else logits


def _mlp_aux(pl, cfg: ModelConfig, x: torch.Tensor, data_group=None):
    """The block's MLP half: the FFN, or the MoE (``cfg.moe_impl``) plus,
    with ``dense_residual``, a dense FFN on ``rms_norm(x, ln_res)``.
    Returns (out, the MoE's aux loss or None; over ``data_group``'s whole
    batch with one)."""
    h = rms_norm(x, pl["ln_mlp"], cfg.norm_eps)
    if not cfg.num_experts:
        return ffn(pl["ffn"], cfg, h), None
    out, aux = moe(pl["moe"], cfg, h, cfg.moe_impl, data_group)
    if cfg.dense_residual:
        out = out + ffn(pl["ffn"], cfg,
                        rms_norm(x, pl["ln_res"], cfg.norm_eps))
    return out, aux


def _mlp_part(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """:func:`_mlp_aux` without the aux loss: the serving passes ignore
    it, as the reference's do."""
    return _mlp_aux(pl, cfg, x)[0]


# --------------------------------------------------------------------------
# The whole prompt, and decode against the monolithic slab
# --------------------------------------------------------------------------
def block_full(pl, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, mrope_positions=None,
               data_group=None):
    """One layer over a whole sequence. Returns (x, KVCache(k, v), aux)
    with the layer's K/V rows [B, T, Hkv, Dh] and its MoE aux loss (None
    without experts)."""
    h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
    a, (k, v) = attn.attention_prefill(pl["attn"], cfg, h, positions,
                                       mrope_positions=mrope_positions)
    x = x + a
    m, aux = _mlp_aux(pl, cfg, x, data_group)
    return x + m, KVCache(k, v), aux


def block_seq_split(pl, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, mrope_positions=None,
                    data_group=None):
    """:func:`block_full` on this rank's T / m rows of the residual
    stream x [B, T/m, D] (the ``seq_parallel`` lever, Megatron's sequence
    parallelism): each half normalises the rank's rows, runs on the rows
    gathered along T (``common.seq_block``: attention and the FFN enter
    through one copy; the MoE routes the gathered rows, so each group
    keeps its S and its capacities and drops) and adds its output's rows
    of this rank. Returns (x, None, aux): a train pass keeps no cache."""
    eps = cfg.norm_eps

    def attention(h, c):
        return attn.attention_prefill(pl["attn"], c, h, positions,
                                      mrope_positions=mrope_positions)[0]
    x = x + seq_block(attention, rms_norm(x, pl["ln_attn"], eps), cfg,
                      "attn")
    h = rms_norm(x, pl["ln_mlp"], eps)
    if not cfg.num_experts:
        return x + seq_block(lambda hh, c: ffn(pl["ffn"], c, hh), h, cfg,
                             "mlp"), None, None
    m, aux = seq_block(lambda hh, c: moe(pl["moe"], c, hh, c.moe_impl,
                                         data_group), h, cfg, "experts",
                       enters=False)
    if cfg.dense_residual:
        m = m + seq_block(lambda hh, c: ffn(pl["ffn"], c, hh),
                          rms_norm(x, pl["ln_res"], eps), cfg, "mlp")
    return x + m, None, aux


def forward_full(p, cfg: ModelConfig, tokens: torch.Tensor, *,
                 vision_embeds=None, vision_mask=None, mrope_positions=None,
                 return_cache: bool = False, remat: bool = False,
                 last_only: bool = False, last_index=None, data_group=None,
                 gather_logits: bool = True):
    """The train / prefill pass over tokens [B, T] (a VLM's extras: patch
    embeddings placed at ``vision_mask``, M-RoPE ids ``mrope_positions``
    [B, T, 3], by default the text positions on all three streams).
    Returns (logits, cache|None, aux):
    logits [B, T, V], or [B, 1, V] at position ``last_index`` (an int or a
    0-d tensor: the bucketed prefill, whose true last token sits before a
    pow2 padding tail; causality keeps the rows and logits below the true
    length independent of that tail) or at the last position
    (``last_only``); cache leaves [L, B, T, Hkv, Dh] (a rank's slice under
    a group, ``attention.cache_dims``), written layer by
    layer into one buffer (none is made without ``return_cache``); aux
    the MoE aux loss summed over layers, an f32 scalar (0 without
    experts; over ``data_group``'s whole batch with one: the rows are
    this rank's share). ``remat`` recomputes each layer in backward
    (``torch.utils.checkpoint``), the reference's ``jax.checkpoint``.
    ``gather_logits=False`` leaves a vocab-split unembedding's logits
    this rank's columns (:func:`unembed`)."""
    B, T = tokens.shape
    x = embed_tokens(p, cfg, tokens, vision_embeds, vision_mask)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    # the prompt's T rows, every one written below (under a window too:
    # the caller relays them into its ring)
    shape = (cfg.num_layers, B, T) + attn.cache_dims(cfg)
    cache = (KVCache(x.new_empty(shape), x.new_empty(shape))
             if return_cache else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # a train pass keeps its residual stream on this rank's T / m rows
    split = seq_layers(cfg) and not return_cache
    block = block_seq_split if split else block_full
    if split:
        x = seq_slice(x, cfg.tp_axis)

    def layer(x, l):
        return block(layer_params(p["layers"], l), cfg, x, positions,
                     mrope_positions, data_group)
    for l in range(cfg.num_layers):
        x, kv, a = checkpointed(layer, remat, x, l)
        if a is not None:
            aux = aux + a
        if cache is not None:
            cache.k[l].copy_(kv.k)
            cache.v[l].copy_(kv.v)
    if split:
        x = all_gather(x, cfg.tp_axis, 1)
    if last_index is not None:
        if isinstance(last_index, torch.Tensor):
            x = x.index_select(1, last_index.reshape(1).long())
        else:
            x = x[:, last_index:last_index + 1]
    elif last_only:
        x = x[:, -1:]
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x, gather_logits), cache, aux


def checkpointed(fn, remat: bool, *args):
    """``fn(*args)``, or with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant: the weights ``fn`` closes over get their grads): its
    activations are dropped after the forward and recomputed in
    backward."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor, cache: KVCache,
                   pos: torch.Tensor, rows=None, *, mrope_positions=None,
                   seq_group=None):
    """token [B] int; cache leaves [L, B, S, Hkv, Dh] (with ``rows`` [B]
    int32, the slab row of each token: a slab of any number of rows, whose
    live rows decode in place; a sliding window's ring of S = min(seq, W)
    rows takes position p at row p % W); pos [B] int32 tokens already cached;
    ``mrope_positions`` [B, 1, 3] (default ``pos`` on all three streams);
    ``seq_group``: the slab's sequence is split over that group, this
    rank's rows in ``cache`` (``attention.context_parallel_decode``).
    Returns (logits [B, V], cache) — the slab updated in place."""
    x = embed_tokens(p, cfg, token[:, None])
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_decode(pl["attn"], cfg, h, layer_pool(cache, l),
                                     pos, rows=rows,
                                     mrope_positions=mrope_positions,
                                     seq_group=seq_group)
        x = x + a
        x = x + _mlp_part(pl, cfg, x)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
               device="cuda") -> KVCache:
    """The zeroed monolithic slab, leaves [L, batch, seq, Hkv, Dh] (a
    sliding window's ring: ``min(seq, window)`` rows)."""
    return make_cache(cfg, batch, seq, dtype=dtype, device=device,
                      layers=cfg.num_layers)


# --------------------------------------------------------------------------
# Full-stack passes over the paged pool
# --------------------------------------------------------------------------
def forward_decode_paged(p, cfg: ModelConfig, token: torch.Tensor,
                         pool: KVCache, block_tables: torch.Tensor,
                         pos: torch.Tensor, *, attn_backend: str = "fused",
                         attn_num_work=None, mrope_positions=None):
    """token [B] int; pool leaves [L, NB, BS, Hkv, Dh] (a ``KVCache``, or
    an int8 ``QuantKVCache`` on the fused and dense backends); block_tables
    [B, NBT] int32; pos [B] int32 (-1 = dead slot); ``mrope_positions``
    [B, 1, 3] (default ``pos`` on all three streams). Returns
    (logits [B, V], pool) — the pool updated in place. On the ``flat``
    backend the layers share one flat work list."""
    work_list = None
    if attn_backend == "flat":
        B, NBT = block_tables.shape
        work_list = flat_work_list(pos + 1, NBT, pool.k.shape[2],
                                   attn_num_work or B * NBT)
    x = embed_tokens(p, cfg, token[:, None])
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_decode_paged(
            pl["attn"], cfg, h, layer_pool(pool, l), block_tables,
            pos, attn_backend=attn_backend, attn_num_work=attn_num_work,
            attn_work_list=work_list, mrope_positions=mrope_positions)
        x = x + a
        x = x + _mlp_part(pl, cfg, x)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x)[:, 0], pool


def forward_mixed(p, cfg: ModelConfig, dec_token: torch.Tensor,
                  ck_tokens: torch.Tensor, pool: KVCache,
                  bt_dec: torch.Tensor, bt_ck: torch.Tensor,
                  pos: torch.Tensor, ctx_len: torch.Tensor,
                  chunk_len: torch.Tensor, *, attn_backend: str = "fused",
                  attn_num_work=None):
    """One whole MIXED iteration through the stack: the decode batch
    (``dec_token [Bd]``, ``pos [Bd]``, -1 = dead slot) advances one token
    while prompt chunks (``ck_tokens [Bp, C]``, ``ctx_len``/``chunk_len``
    [Bp]) prefill beside it — ONE fused attention launch per layer (two
    on the ``grid`` and ``flat`` backends, none on ``dense``).
    Returns ``(dec_logits [Bd, V], ck_logits [Bp, V], pool)``, ck_logits
    at each chunk's last real position."""
    x_dec = embed_tokens(p, cfg, dec_token[:, None])
    x_ck = embed_tokens(p, cfg, ck_tokens)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        hd = rms_norm(x_dec, pl["ln_attn"], cfg.norm_eps)
        hc = rms_norm(x_ck, pl["ln_attn"], cfg.norm_eps)
        ad, ac, _ = attn.attention_mixed_paged(
            pl["attn"], cfg, hd, hc, layer_pool(pool, l), bt_dec,
            bt_ck, pos, ctx_len, chunk_len, attn_backend=attn_backend,
            attn_num_work=attn_num_work)
        x_dec = x_dec + ad
        x_ck = x_ck + ac
        x_dec = x_dec + _mlp_part(pl, cfg, x_dec)
        x_ck = x_ck + _mlp_part(pl, cfg, x_ck)
    x_dec = rms_norm(x_dec, p["ln_f"], cfg.norm_eps)
    x_ck = rms_norm(_last_real(x_ck, chunk_len), p["ln_f"], cfg.norm_eps)
    return (unembed(p, cfg, x_dec)[:, 0], unembed(p, cfg, x_ck)[:, 0], pool)


def _last_real(x: torch.Tensor, chunk_len: torch.Tensor) -> torch.Tensor:
    """x [B, C, D] -> [B, 1, D] at each chunk's last real row."""
    last = (chunk_len.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, last)


def forward_prefill_chunk(p, cfg: ModelConfig, tokens: torch.Tensor,
                          pool: KVCache, block_tables: torch.Tensor,
                          ctx_len: torch.Tensor, chunk_len: torch.Tensor, *,
                          attn_backend: str = "fused", mrope_positions=None):
    """Prompt chunks through the stack against the paged pool: tokens
    [B, C] int (rows past ``chunk_len`` are padding), block_tables
    [B, NBT], ctx_len / chunk_len [B] int32. Every layer writes the
    chunk's K/V into its pool slice and attends over the written context
    plus the chunk, so chunk-by-chunk calls reproduce the whole prompt's
    cache rows; ``mrope_positions`` [B, C, 3] (default: each token's
    position on all three streams). Returns (logits [B, V] at each
    chunk's last real token, pool) — on a prompt's final chunk, its
    first-token distribution."""
    x = embed_tokens(p, cfg, tokens)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_prefill_chunk_paged(
            pl["attn"], cfg, h, layer_pool(pool, l), block_tables,
            ctx_len, chunk_len, attn_backend=attn_backend,
            mrope_positions=mrope_positions)
        x = x + a
        x = x + _mlp_part(pl, cfg, x)
    x = rms_norm(_last_real(x, chunk_len), p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x)[:, 0], pool


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device="cuda", kv_dtype: str = "bf16"):
    """Global paged KV pool: leaves [L, NB, BS, Hkv, Dh], zeroed
    (``kv_dtype="int8"``: the :class:`~repro_torch.models.attention.
    QuantKVCache` layout, scales [L, NB, BS, Hkv] starting at zero).
    Blocks are owned by requests via the engine's BlockAllocator; the
    model only sees block tables."""
    assert not cfg.sliding_window, "paged cache is full-attention only"
    return make_paged_pool(cfg, num_blocks, block_size, dtype=dtype,
                           device=device, kv_dtype=kv_dtype,
                           layers=cfg.num_layers)
