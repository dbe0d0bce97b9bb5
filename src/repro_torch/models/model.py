"""Model record over the port's families — the counterpart of
``repro.models.model``, with the entry-point signatures of its serving
paths (tokens are int tensors, not the reference's batch dicts) and its
``loss`` (which takes the reference's batch dict):

    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    loss, metrics = model.loss(params, batch, remat=False)
    logits, cache = model.prefill(params, tokens, cache_len)   # [B, V]
    extras = synthetic_batch(cfg, B, T, device="cuda")  # a family's extras
    logits, cache = model.prefill(params, extras.pop("tokens"), cache_len,
                                  **extras)
    slab = model.init_cache(batch, seq, device="cuda")
    logits, slab = model.decode_step(params, slab, token, pos)
    logits, piece = model.prefill_bucketed(params, tokens, true_len)
    pool = model.init_paged_cache(num_blocks, block_size, device="cuda",
                                  kv_dtype="bf16")   # or "int8"
    logits, pool = model.decode_step_paged(params, pool, token, bt, pos)
    logits, pool = model.prefill_chunk(params, pool, tokens, bt, ctx, clen)
    dec_logits, ck_logits, pool = model.mixed_step(
        params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos, ctx, clen)

Every family of the reference is ported: the decoders — dense, MoE
(``mlp.moe``, arctic's dense residual) and the VLM backbone (vision
merge, M-RoPE) — rwkv6 (``family="ssm"``), zamba2's Mamba2 hybrid
(``"hybrid"``) and whisper's encoder-decoder (``"encdec"``). A VLM's
extras are keyword arguments: ``vision_embeds`` / ``vision_mask`` /
``mrope_positions`` on the whole-prompt entry points, ``mrope_positions``
on the decode and chunk ones (text positions on all three streams by
default); ``mixed_step`` refuses M-RoPE, as the reference's does; whisper
takes ``audio_embeds`` on ``prefill``. A sliding-window decoder keeps its
K/V in a ring of ``min(seq, window)`` rows (position p at row ``p % W``)
and has the whole-prompt entry points only: ``prefill``, ``decode_step``
and ``init_cache``, as in the reference. So have rwkv6, whose cache is
its recurrent state ``{"S", "att_prev", "ffn_prev"}`` (its ``prefill``
ignores ``cache_len``), zamba2 (``{"conv", "ssm", "kv"}``, one KV per
shared-block site) and whisper (``WhisperCache``: the decoder's self-KV
slab and the fixed cross-KV). The paged entry points are ``None`` for
them all.

``loss`` is the reference's: the next-token cross-entropy of
``batch["tokens"]`` (masked by ``loss_mask``), plus an MoE's aux loss summed
over layers; ``(loss, {"xent", "aux"})``. A model whose unembedding (whisper:
its tied embedding) is split on the vocabulary over its group keeps the logits
split into the loss (a vocab-parallel cross-entropy). ``remat`` recomputes each
layer (a zamba2 group) in backward. With a ``data_group`` (data parallelism:
``training.trainer.make_sharded_train_step``) the batch is this rank's rows and
``xent`` this rank's share of the whole batch's, while ``aux`` is the whole
batch's on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models import mamba2, rwkv6, transformer, whisper
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, seq_layers, softmax_xent,
                                       split_block)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # init(rng, device="cuda") -> params; rng is a seed or a torch.Generator
    init: Callable[..., Any]
    # loss(params, batch, remat=False, data_group=None) -> (loss, metrics):
    # batch the reference's dict of tensors ("tokens", "loss_mask", a
    # family's extras), data_group a data-parallel group or None
    loss: Callable[..., Any]
    # prefill(params, tokens [B, T], cache_len=None, **vlm_extras)
    #     -> (last-token logits [B, V], slab [L, B, cache_len or T, ...];
    #         a window's ring of min(cache_len or T, W) rows; rwkv6's or
    #         zamba2's state; whisper's WhisperCache)
    prefill: Callable[..., Any]
    # decode_step(params, slab, token, pos, rows=None,
    #             mrope_positions=None, seq_group=None) -> (logits, slab);
    #     seq_group (decoders, zamba2's sites): the slab's sequence split
    #     over that group, this rank's rows (context parallelism)
    decode_step: Callable[..., Any]
    # init_cache(batch, seq, device="cuda", dtype=None) -> zeroed slab
    init_cache: Callable[..., Any]
    # The paged serving path: full-attention decoders only; None for a
    # sliding window's ring and rwkv6's state, which keep the slab.
    # init_paged_cache(num_blocks, block_size, device="cuda", dtype=None,
    #                  kv_dtype="bf16") -> pool [L, NB, BS, Hkv, Dh]
    #     (kv_dtype "int8": a QuantKVCache with scales [L, NB, BS, Hkv])
    init_paged_cache: Optional[Callable[..., Any]] = None
    # decode_step_paged(params, pool, token, block_tables, pos, *,
    #                   attn_backend, attn_num_work) -> (logits [B, V], pool)
    decode_step_paged: Optional[Callable[..., Any]] = None
    # prefill_chunk(params, pool, tokens, block_tables, ctx_len, chunk_len,
    #               *, attn_backend) -> (last-real-token logits [B, V], pool)
    prefill_chunk: Optional[Callable[..., Any]] = None
    # mixed_step(params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos,
    #            ctx_len, chunk_len, *, attn_backend, attn_num_work)
    #     -> (dec_logits [Bd, V], ck_logits [Bp, V], pool)
    mixed_step: Optional[Callable[..., Any]] = None
    # prefill_bucketed(params, tokens [B, P], true_len, **vlm_extras)
    #     -> (logits [B, V] at position true_len - 1,
    #         prompt piece [L, B, P, Hkv, Dh])
    prefill_bucketed: Optional[Callable[..., Any]] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


def _seeded(rng: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng))
    return gen


def _relay_kv(piece: KVCache, cfg: ModelConfig, cache_len: int) -> KVCache:
    """Prompt-length per-layer KV [L, B, T, Hkv, Dh] -> a zeroed decode
    slab [L, B, W, Hkv, Dh] in the reference's ring layout: ``W =
    min(cache_len, sliding_window)`` with a window, else ``cache_len``;
    positions ``T - take .. T - 1`` (``take = min(T, W)``) at row
    ``position % W``."""
    L, B, T = piece.k.shape[:3]
    W = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
         else cache_len)
    if W == T:
        return piece
    take = min(T, W)
    idx = torch.arange(T - take, T, device=piece.k.device) % W

    def relay(a):
        buf = a.new_zeros((L, B, W) + a.shape[3:])
        buf[:, :, idx] = a[:, :, T - take:]
        return buf

    return KVCache(relay(piece.k), relay(piece.v))


def _xent(logits: torch.Tensor, batch, group=None,
          vocab_group=None) -> torch.Tensor:
    """Next-token cross-entropy: logits at t predict token t + 1, masked
    by ``loss_mask`` at t + 1 when the batch has one; with a data-parallel
    ``group`` this rank's share of the whole batch's mean; with a
    ``vocab_group`` the logits are this rank's vocabulary columns."""
    tokens, mask = batch["tokens"], batch.get("loss_mask")
    return softmax_xent(logits[:, :-1], tokens[:, 1:],
                        None if mask is None else mask[:, 1:],
                        group=group, vocab_group=vocab_group)


def _vocab_group(cfg: ModelConfig, block: str):
    """The group a vocab-split ``block`` keeps its logits split over into
    the loss (None: the logits are whole)."""
    return cfg.tp_axis if split_block(cfg, block) else None


def shared_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """The names of the replicated leaves that a split block of ``cfg``
    uses on this rank's heads only (rwkv6's split time mix, zamba2's
    split Mamba2 blocks): a rank's gradient of each is its heads' share,
    which ``training.trainer`` sums over the model group."""
    if cfg.family == "ssm" and split_block(cfg, "tmix"):
        return rwkv6.TMIX_SHARED
    if cfg.family == "hybrid" and split_block(cfg, "mamba"):
        return mamba2.MAMBA_SHARED
    return ()


# the norms (and a GELU FFN's output bias, added after its reduce-scatter)
# a sequence-parallel layer applies on this rank's T / m rows
_SEQ_NORMS = {"ssm": r"^layers/ln_(att|ffn)$",
              "hybrid": r"^(mamba/ln|shared/(ln_(attn|mlp)|ffn/b_down))$",
              "encdec": r"^dec_layers/(ln[123]/[wb]|ffn/b_down)$"}


def seq_norm_leaves(cfg: ModelConfig) -> str:
    """A pattern of the paths of the replicated leaves that the
    ``seq_parallel`` lever applies on this rank's T / m rows only (each
    layer's norms and a GELU FFN's output bias, ``common.seq_block``): a rank's gradient of each is its
    rows' share, which ``training.trainer`` sums over the model group
    (Megatron's sequence-parallel norm weights); one that matches nothing
    without the lever."""
    if not seq_layers(cfg):
        return r"^$"
    return _SEQ_NORMS.get(cfg.family,
                          r"^layers/(ln_(attn|mlp|res)|ffn/b_down)$")


def _decoder_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        return transformer.init_decoder(_seeded(rng, device), cfg)

    def loss(params, batch, remat: bool = False, data_group=None):
        # a vocab-split unembedding keeps its logits split into the loss
        vocab = cfg.tp_axis if split_block(cfg, "unembed") else None
        logits, _, aux = transformer.forward_full(
            params, cfg, batch["tokens"],
            vision_embeds=batch.get("vision_embeds"),
            vision_mask=batch.get("vision_mask"),
            mrope_positions=batch.get("mrope_positions"), remat=remat,
            data_group=data_group, gather_logits=vocab is None)
        xe = _xent(logits, batch, data_group, vocab)
        return xe + aux, {"xent": xe, "aux": aux}

    def init_paged_cache(num_blocks: int, block_size: int, device="cuda",
                         dtype=None, kv_dtype: str = "bf16"):
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                            dtype=dtype, device=device,
                                            kv_dtype=kv_dtype)

    def decode_step_paged(params, pool, token, block_tables, pos, *,
                          attn_backend="fused", attn_num_work=None,
                          mrope_positions=None):
        return transformer.forward_decode_paged(
            params, cfg, token, pool, block_tables, pos,
            attn_backend=attn_backend, attn_num_work=attn_num_work,
            mrope_positions=mrope_positions)

    def prefill_chunk(params, pool, tokens, block_tables, ctx_len, chunk_len,
                      *, attn_backend="fused", mrope_positions=None):
        return transformer.forward_prefill_chunk(
            params, cfg, tokens, pool, block_tables, ctx_len, chunk_len,
            attn_backend=attn_backend, mrope_positions=mrope_positions)

    def mixed_step(params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos,
                   ctx_len, chunk_len, *, attn_backend="fused",
                   attn_num_work=None):
        return transformer.forward_mixed(
            params, cfg, dec_token, ck_tokens, pool, bt_dec, bt_ck, pos,
            ctx_len, chunk_len, attn_backend=attn_backend,
            attn_num_work=attn_num_work)

    def prefill(params, tokens, cache_len: Optional[int] = None,
                **extras):
        logits, cache, _ = transformer.forward_full(params, cfg, tokens,
                                                    return_cache=True,
                                                    last_only=True, **extras)
        return logits[:, -1], _relay_kv(cache, cfg,
                                        cache_len or tokens.shape[1])

    def decode_step(params, cache, token, pos, rows=None,
                    mrope_positions=None, seq_group=None):
        return transformer.forward_decode(params, cfg, token, cache, pos,
                                          rows=rows,
                                          mrope_positions=mrope_positions,
                                          seq_group=seq_group)

    def init_cache(batch: int, seq: int, device="cuda", dtype=None):
        return transformer.init_cache(cfg, batch, seq, dtype=dtype,
                                      device=device)

    def prefill_bucketed(params, tokens, true_len, **extras):
        logits, cache, _ = transformer.forward_full(
            params, cfg, tokens, return_cache=True, last_index=true_len - 1,
            **extras)
        return logits[:, 0], cache

    if cfg.sliding_window:
        # a ring has no block-table layout: the slab serves it
        return Model(cfg, init, loss, prefill, decode_step, init_cache)
    return Model(cfg, init, loss, prefill, decode_step, init_cache,
                 init_paged_cache=init_paged_cache,
                 decode_step_paged=decode_step_paged,
                 prefill_chunk=prefill_chunk, mixed_step=mixed_step,
                 prefill_bucketed=prefill_bucketed)


def _rwkv_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        return rwkv6.init_model(_seeded(rng, device), cfg)

    def loss(params, batch, remat: bool = False, data_group=None):
        vocab = _vocab_group(cfg, "unembed")
        xe = _xent(rwkv6.forward_full(params, cfg, batch["tokens"],
                                      remat=remat,
                                      gather_logits=vocab is None),
                   batch, data_group, vocab)
        return xe, {"xent": xe}

    def prefill(params, tokens, cache_len: Optional[int] = None):
        return rwkv6.prefill(params, cfg, tokens, cache_len)

    def decode_step(params, cache, token, pos, rows=None):
        return rwkv6.forward_decode(params, cfg, token, cache, pos,
                                    rows=rows)

    def init_cache(batch: int, seq: int, device="cuda", dtype=None):
        return rwkv6.init_state(cfg, batch, device=device, dtype=dtype)

    return Model(cfg, init, loss, prefill, decode_step, init_cache)


def _zamba_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        return mamba2.init_zamba(_seeded(rng, device), cfg)

    def loss(params, batch, remat: bool = False, data_group=None):
        vocab = _vocab_group(cfg, "unembed")
        logits, _, _ = mamba2.forward_full(params, cfg, batch["tokens"],
                                           remat=remat,
                                           gather_logits=vocab is None)
        xe = _xent(logits, batch, data_group, vocab)
        return xe, {"xent": xe}

    def prefill(params, tokens, cache_len: Optional[int] = None):
        return mamba2.prefill(params, cfg, tokens, cache_len)

    def decode_step(params, cache, token, pos, seq_group=None):
        return mamba2.forward_decode(params, cfg, token, cache, pos,
                                     seq_group)

    def init_cache(batch: int, seq: int, device="cuda", dtype=None):
        return mamba2.init_state(cfg, batch, seq, device=device, dtype=dtype)

    return Model(cfg, init, loss, prefill, decode_step, init_cache)


def _whisper_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        return whisper.init_model(_seeded(rng, device), cfg)

    def loss(params, batch, remat: bool = False, data_group=None):
        vocab = _vocab_group(cfg, "embed")
        logits, _, _ = whisper.forward_full(params, cfg, batch["tokens"],
                                            batch["audio_embeds"],
                                            remat=remat,
                                            gather_logits=vocab is None)
        xe = _xent(logits, batch, data_group, vocab)
        return xe, {"xent": xe}

    def prefill(params, tokens, cache_len: Optional[int] = None, *,
                audio_embeds):
        logits, cache, _ = whisper.forward_full(
            params, cfg, tokens, audio_embeds, return_cache=True,
            last_only=True, cache_len=cache_len or tokens.shape[1])
        self_kv = _relay_kv(cache.self_kv, cfg, cache_len or tokens.shape[1])
        return logits[:, -1], whisper.WhisperCache(self_kv, cache.cross_kv)

    def decode_step(params, cache, token, pos):
        return whisper.forward_decode(params, cfg, token, cache, pos)

    def init_cache(batch: int, seq: int, device="cuda", dtype=None):
        return whisper.init_cache(cfg, batch, seq, device=device,
                                  dtype=dtype)

    return Model(cfg, init, loss, prefill, decode_step, init_cache)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_model(cfg)
    if cfg.family == "ssm":
        return _rwkv_model(cfg)
    if cfg.family == "hybrid":
        return _zamba_model(cfg)
    if cfg.family == "encdec":
        return _whisper_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def mrope_grid_positions(batch: int, seq: int, n_patch: int) -> np.ndarray:
    """M-RoPE ids [batch, seq, 3] of a prompt that opens with ``n_patch``
    image patches: the patches share t = 0 on a (h, w) grid of
    ``int(sqrt(n_patch))`` columns; the text after them runs t = h = w =
    1, 2, ... (the reference's ``synthetic_batch`` layout)."""
    tpos = np.zeros((batch, seq, 3), np.int32)
    side = max(1, int(np.sqrt(n_patch)))
    for i in range(n_patch):
        tpos[:, i] = (0, i // side, i % side)
    for i in range(n_patch, seq):
        t = i - n_patch + 1
        tpos[:, i] = (t, t, t)
    return tpos


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int,
                    np_seed: int = 0, device="cuda") -> Dict[str, Any]:
    """A runnable batch with the family's extras, drawn from
    ``np.random.default_rng(np_seed)`` in the reference's order (the same
    numbers): ``tokens`` [batch, seq] int32; whisper adds ``audio_embeds``
    [batch, encoder_seq, D] in ``cfg.dtype``; a VLM adds ``vision_embeds``
    [batch, seq // 4, D] in ``cfg.dtype``, ``vision_mask`` (the first
    seq // 4 positions) and ``mrope_positions``: with ``tokens`` popped,
    the keyword arguments of ``Model.prefill``."""
    r = np.random.default_rng(np_seed)
    out: Dict[str, Any] = {"tokens": torch.from_numpy(
        r.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    ).to(device)}
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.from_numpy(
            r.normal(0, 1, (batch, cfg.encoder_seq, cfg.d_model))).to(
                device=device, dtype=cfg.dtype)
    if cfg.family == "vlm":
        n_patch = max(1, seq // 4)
        vm = np.zeros((batch, seq), bool)
        vm[:, :n_patch] = True
        out["vision_embeds"] = torch.from_numpy(
            r.normal(0, 1, (batch, n_patch, cfg.d_model))).to(
                device=device, dtype=cfg.dtype)
        out["vision_mask"] = torch.from_numpy(vm).to(device)
        out["mrope_positions"] = torch.from_numpy(
            mrope_grid_positions(batch, seq, n_patch)).to(device)
    return out
