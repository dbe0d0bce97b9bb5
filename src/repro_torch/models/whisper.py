"""Whisper-large-v3's transformer backbone (encoder-decoder) — the port of
``repro.models.whisper``. [arXiv:2212.04356]

The modality frontend (mel spectrogram + conv feature extractor) is a
stub, as in the reference: the inputs are precomputed frame embeddings
``audio_embeds [B, encoder_seq, d_model]``. Everything after it is here:
the encoder (bidirectional self-attention, learned positions), the
decoder (causal self-attention, cross-attention over the encoder, learned
positions up to ``max_position``), LayerNorms with biases, GELU FFNs with
biases and the unembedding tied to the decoder's embedding.

Attention: the encoder's self-attention and a prompt's cross-attention
run the plain ``_gqa_sdpa`` (the reference computes both in XLA; #6 is
causal only); the decoder's self-attention runs #6 over a prompt and #5
on a decode step, and a decode step's cross-attention runs #5 over the
encoder's K/V (every key valid). Decode keeps the self-attention KV in a
slab that grows by a token a step and the cross-attention KV, computed
once at prefill, fixed; :func:`forward_decode` writes the slab IN PLACE.

On a training mesh's model group (the plan's ``embed``, ``attn``,
``cross_attn`` and ``mlp`` blocks, ``training.trainer.
sharding_mechanism``) every split leaf stays split: the encoder's and
the decoder's attention and cross-attention take ``models.attention``'s
tensor-parallel or per-leaf forms (:func:`~repro_torch.models.attention.
encoder_attention`, ``cross_attention``), the FFNs ``mlp.ffn``'s, the
tied embedding is split on the vocabulary where it divides (the lookup
all-reduced, the logits gathered or kept split into a vocab-parallel
loss) and gathered at its use where it does not. The decode cache is
this rank's slice: the self-KV as the decoders' slab
(``attention.cache_dims``), the cross-KV as ``attention.cross_layout``.

Positions: the decoder's table has ``max_position`` rows (448). JAX clamps
a gather past it; torch does not, so :func:`forward_full` refuses a
longer prompt, and a caller must keep every decode position below it (a
position past the table is an out-of-range index on the device).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache, layer_pool
from repro_torch.models.common import (ModelConfig, all_gather, copy_to_tp,
                                       embed_init, layer_norm, leaf_at_use,
                                       seq_block, seq_layers, seq_slice,
                                       split_block)
from repro_torch.models.mlp import ffn, init_ffn
from repro_torch.models.transformer import (checkpointed, embed_tokens,
                                            layer_params)


def _ln(cfg: ModelConfig, device, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    return {"w": torch.ones(shape, dtype=cfg.dtype, device=device),
            "b": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig,
                   layers: Optional[int] = None):
    """An encoder layer's weights, or with ``layers`` that many stacked."""
    lead = () if layers is None else (layers,)
    return {"ln1": _ln(cfg, gen.device, lead),
            "ln2": _ln(cfg, gen.device, lead),
            "attn": attn.init_attention(gen, cfg, layers),
            "ffn": init_ffn(gen, cfg, layers)}


def init_dec_layer(gen: torch.Generator, cfg: ModelConfig,
                   layers: Optional[int] = None):
    """A decoder layer's weights, or with ``layers`` that many stacked."""
    lead = () if layers is None else (layers,)
    return {"ln1": _ln(cfg, gen.device, lead),
            "ln2": _ln(cfg, gen.device, lead),
            "ln3": _ln(cfg, gen.device, lead),
            "self_attn": attn.init_attention(gen, cfg, layers),
            "cross_attn": attn.init_attention(gen, cfg, layers),
            "ffn": init_ffn(gen, cfg, layers)}


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device, layers stacked on a leading
    axis (``encoder_layers`` and ``num_layers``)."""
    dt, dev = cfg.dtype, gen.device
    return {
        "enc_pos": embed_init(gen, (cfg.encoder_seq, cfg.d_model), dt),
        "enc_layers": init_enc_layer(gen, cfg, cfg.encoder_layers),
        "enc_ln": _ln(cfg, dev),
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "dec_pos": embed_init(gen, (cfg.max_position, cfg.d_model), dt),
        "dec_layers": init_dec_layer(gen, cfg, cfg.num_layers),
        "dec_ln": _ln(cfg, dev),
    }


def _norm(x, ln, cfg):
    return layer_norm(x, ln["w"], ln["b"], cfg.norm_eps)


def encode(p, cfg: ModelConfig, audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds [B, S_enc, D] (the stub frontend's output, cast to
    the weights' dtype) -> the encoder output [B, S_enc, D]."""
    x = audio_embeds.to(p["enc_pos"].dtype) \
        + p["enc_pos"][None, :audio_embeds.shape[1]]
    for l in range(cfg.encoder_layers):
        pl = layer_params(p["enc_layers"], l)
        # bidirectional: no mask, learned positions (no rope)
        x = x + attn.encoder_attention(pl["attn"], cfg,
                                       _norm(x, pl["ln1"], cfg))
        x = x + ffn(pl["ffn"], cfg, _norm(x, pl["ln2"], cfg))
    return _norm(x, p["enc_ln"], cfg)


def logits_of(p, cfg: ModelConfig, x: torch.Tensor,
              gather: bool = True) -> torch.Tensor:
    """The tied logits ``x @ embed.T`` [..., V]: under a group whose plan
    splits ``embed`` each rank's V / n columns (its rows of the table),
    all-gathered, or with ``gather=False`` left split (a vocab-parallel
    loss); with ``embed`` gathered, the table gathered at its use."""
    if cfg.tp_axis is None:
        return x @ p["embed"].T
    if not split_block(cfg, "embed"):
        return x @ leaf_at_use(p["embed"], cfg, 0, cfg.vocab_size).T
    logits = copy_to_tp(x, cfg) @ p["embed"].T
    return all_gather(logits, cfg.tp_axis) if gather else logits


class WhisperCache(NamedTuple):
    self_kv: KVCache      # [L, B, S_dec, Hkv, Dh]
    cross_kv: KVCache     # [L, B, S_enc, Hkv, Dh]


def _dec_block_full(pl, cfg: ModelConfig, x, positions, cross_kv: KVCache):
    h = _norm(x, pl["ln1"], cfg)
    a, (k, v) = attn.attention_prefill(pl["self_attn"], cfg, h, positions)
    x = x + a
    x = x + attn.cross_attention(pl["cross_attn"], cfg, _norm(x, pl["ln2"],
                                                              cfg), cross_kv)
    return x + ffn(pl["ffn"], cfg, _norm(x, pl["ln3"], cfg)), KVCache(k, v)


def _dec_block_seq_split(pl, cfg: ModelConfig, x, positions,
                         cross_kv: KVCache):
    """:func:`_dec_block_full` on this rank's T / m rows of the residual
    stream (the ``seq_parallel`` lever, ``common.seq_block``): each of the
    self-attention, the cross-attention (its queries; the encoder's K/V
    are whole on every rank) and the FFN normalises the rank's rows, runs
    on the rows gathered along T and adds its output's rows of this rank.
    Returns (x, None): a train pass keeps no cache."""
    x = x + seq_block(lambda h, c: attn.attention_prefill(
        pl["self_attn"], c, h, positions)[0], _norm(x, pl["ln1"], cfg), cfg,
        "attn")
    x = x + seq_block(lambda h, c: attn.cross_attention(
        pl["cross_attn"], c, h, cross_kv), _norm(x, pl["ln2"], cfg), cfg,
        "cross_attn")
    return x + seq_block(lambda h, c: ffn(pl["ffn"], c, h),
                         _norm(x, pl["ln3"], cfg), cfg, "mlp"), None


def forward_full(p, cfg: ModelConfig, tokens: torch.Tensor,
                 audio_embeds: torch.Tensor, return_cache: bool = False,
                 remat: bool = False, last_only: bool = False,
                 gather_logits: bool = True, cache_len: Optional[int] = None):
    """The teacher-forced decoder pass over tokens [B, T] (T <=
    ``max_position``) after encoding ``audio_embeds``. Returns (logits
    [B, T, V] or [B, 1, V] with ``last_only``, ``WhisperCache`` of the
    prompt's self-attention KV [L, B, T, ...] and the cross-attention KV
    [L, B, S_enc, ...] or None, aux 0; under a group this rank's slices).
    ``remat`` recomputes each decoder layer in backward;
    ``gather_logits=False`` leaves vocab-split logits this rank's
    columns (:func:`logits_of`); ``cache_len`` (default T) is the decode
    cache's length the cross K/V slice is laid out for
    (``attention.cross_layout``)."""
    B, T = tokens.shape
    if T > p["dec_pos"].shape[0]:
        raise ValueError(f"{T} decoder tokens exceed the "
                         f"{p['dec_pos'].shape[0]}-row position table")
    enc = encode(p, cfg, audio_embeds)
    x = embed_tokens(p, cfg, tokens) + p["dec_pos"][None, :T]
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    # a train pass keeps its residual stream on this rank's T / m rows
    split = seq_layers(cfg) and not return_cache
    block = _dec_block_seq_split if split else _dec_block_full
    if split:
        x = seq_slice(x, cfg.tp_axis)

    def layer(x, l):
        pl = layer_params(p["dec_layers"], l)
        cross_kv = attn.encode_cross_kv(pl["cross_attn"], cfg, enc)
        x, kv = block(pl, cfg, x, positions, cross_kv)
        return x, kv, cross_kv
    selfs, crosses = [], []
    for l in range(cfg.num_layers):
        x, kv, cross_kv = checkpointed(layer, remat, x, l)
        if return_cache:
            selfs.append(kv)
            crosses.append(attn.cross_cache_slice(cfg, cross_kv,
                                                  cache_len or T))
    if split:
        x = all_gather(x, cfg.tp_axis, 1)
    x = _norm(x, p["dec_ln"], cfg)
    if last_only:         # serving prefill needs next-token logits only
        x = x[:, -1:]
    logits = logits_of(p, cfg, x, gather_logits)    # tied to the embedding
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not return_cache:
        return logits, None, aux

    def stack(kvs):
        return KVCache(torch.stack([kv.k for kv in kvs]),
                       torch.stack([kv.v for kv in kvs]))
    return logits, WhisperCache(stack(selfs), stack(crosses)), aux


def init_cache(cfg: ModelConfig, batch: int, dec_seq: int,
               enc_seq: Optional[int] = None, device="cuda",
               dtype=None) -> WhisperCache:
    """Zeroed caches: self [L, batch, dec_seq, Hkv, Dh], cross [L, batch,
    enc_seq (default ``encoder_seq``), Hkv, Dh], in ``dtype`` (default the
    model's)."""
    dt = dtype or cfg.dtype
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def kv(S):
        shape = (L, batch, S, Hkv, Dh)
        return KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))
    return WhisperCache(kv(dec_seq), kv(enc_seq or cfg.encoder_seq))


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor,
                   cache: WhisperCache, pos: torch.Tensor):
    """token [B] int; pos [B] int32 decoder tokens already generated
    (each below ``max_position``). Returns (logits [B, V], cache) with
    the self-attention slab written in place (under a group this rank's
    slices, :func:`forward_full`'s layout)."""
    x = (embed_tokens(p, cfg, token)
         + p["dec_pos"][pos.long()])[:, None]
    for l in range(cfg.num_layers):
        pl = layer_params(p["dec_layers"], l)
        h = _norm(x, pl["ln1"], cfg)
        a, _ = attn.attention_decode(pl["self_attn"], cfg, h,
                                     layer_pool(cache.self_kv, l), pos)
        x = x + a
        x = x + attn.cross_attention_decode(pl["cross_attn"], cfg,
                                            _norm(x, pl["ln2"], cfg),
                                            layer_pool(cache.cross_kv, l))
        x = x + ffn(pl["ffn"], cfg, _norm(x, pl["ln3"], cfg))
    x = _norm(x, p["dec_ln"], cfg)
    return logits_of(p, cfg, x)[:, 0], cache
