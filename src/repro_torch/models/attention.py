"""GQA attention with RoPE — the port's subset of
``repro.models.attention``: whole-prompt prefill (the contiguous causal
prefill kernel; a sliding window longer than the prompt masks nothing,
a prompt longer than the window runs the banded plain path,
:func:`window_attention`), single-token decode against a monolithic KV
slab or a window's ring (the contiguous decode kernel, padded), and the
decode, chunked-prefill and
mixed-iteration paths over the global block pool on the four paged
backends (``dense`` gather + masked SDPA, the ``grid`` and ``flat`` kernel
pairs, the ``fused`` kernel), and the int8 pool (``QuantKVCache``:
quantize-on-write, scales beside the rows), which the ``fused`` kernel and
the ``dense`` path read. RoPE, or Qwen2-VL's three-stream M-RoPE where the
config asks for it, rotates q and k on every path but the mixed step,
which refuses M-RoPE as the reference's does.

Shapes follow the JAX package: activations ``x [B, T, D]``, a slab layer
``[B, S, Hkv, Dh]``, a pool slice ``[NB, BS, Hkv, Dh]`` per layer, block
tables ``[B, NBT]`` int32. Slab and pool writes are IN PLACE
(``index_put_``): a functional copy would duplicate the multi-GB cache per
layer per step, so each function returns the cache it was given, updated.
The paged paths are full-attention only, as in the reference: a window's
ring has no block-table layout.

Whisper's cross-attention reads the encoder's K/V: one decoder token at a
time through the contiguous decode kernel (every key valid), a prompt's
queries in plain PyTorch, as the reference computes both in XLA. A head
dim that no kernel build takes (``KERNEL_HEAD_DIMS``: zamba2's 80) is
routed before any launch: prefill through :func:`window_attention` with a
window of the whole prompt, decode through the plain padded decode.

The causal prefill is differentiable (:func:`causal_prefill`): the loss
path runs the kernel forward and differentiates its plain version.

Under a training mesh's per-leaf plan (``cfg.tp_plan``: heads that do
not divide the model group) the whole-prompt and slab paths keep every
split leaf split: each rank projects its columns of q / k / v, one
all-gather puts whole heads on every rank (RoPE runs on them), the
causal core splits over (row, head) pairs (:func:`_pair_core`, #6 on
one-head pairs), a decode on a slab split on its head dim all-reduces
its partial scores (:func:`head_dim_decode`, no kernel), and ``wo``
takes the rank's rows of the gathered output (:func:`_out_proj`).
Whisper's encoder (:func:`encoder_attention`) and cross-attention take
the same forms with a non-causal core (plain PyTorch on the pairs, as
the one-device path: #6 is causal only); the cross K/V's decode slice
keeps the layout ``launch.shardings.cache_shardings`` gives it
(:func:`cross_layout`: the encoder's frames where they divide the
group, else kv heads, else the head dim), and a decode step attends it
in that layout (:func:`cross_attention_decode`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  paged_decode_attention,
                                                  paged_decode_attention_flat)
from repro_torch.kernels.mixed_attention import paged_mixed_attention
from repro_torch.kernels.ops import KERNEL_HEAD_DIMS, NEG_INF
from repro_torch.kernels.prefill_attention import (paged_prefill_attention,
                                                   prefill_attention,
                                                   prefill_attention_plain)
from repro_torch.models.common import (ModelConfig, all_gather, block_in,
                                       block_out, copy_to_tp, dense_init,
                                       leaf_at_use, psum_if_tp, rank_cols,
                                       split_block, split_dim, state_axis,
                                       state_piece)

# Paged attention backends (the JAX package's four):
#   dense — gather pool[block_tables] + masked SDPA in plain PyTorch: a
#           [B, NBT·BS, Hkv, Dh] copy per layer per step and no kernel; the
#           reference's parity baseline, and it reads int8 pools.
#   grid  — decode by the (request, kv head) grid kernel, prompt chunks by
#           the chunked prefill kernel: a mixed step makes two calls.
#   flat  — decode by the flat work-list kernel, chunks as on grid.
#   fused — one tagged kernel over decode rows and chunks: one call.
PAGED_BACKENDS = ("dense", "grid", "flat", "fused")


def resolve_paged_backend(backend: Optional[str] = None) -> str:
    """The backend to run: an explicit argument wins, else ``fused``."""
    choice = backend or "fused"
    if choice not in PAGED_BACKENDS:
        raise ValueError(f"unknown paged backend {choice!r}; the port has "
                         f"{PAGED_BACKENDS}")
    return choice


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[Dh/2] f32 inverse frequencies, cached per (Dh, theta, device) so a
    decode step does not rebuild them per layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, T, H, Dh]; positions [B, T] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [Dh/2]
    angles = positions[..., None].float() * freqs                # [B, T, Dh/2]
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the Dh/2 frequency slots split into (t, h, w)
    sections, each rotated by its own position stream; the last section
    absorbs the rounding. x [B, T, H, Dh]; positions3 [B, T, 3] (temporal,
    height, width ids; identical streams for pure text)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_freqs(dh, theta, x.device)                      # [half]
    total = sum(sections)
    bounds = []
    start = 0
    for s in sections:
        n = (half * s) // total
        bounds.append((start, start + n))
        start += n
    bounds[-1] = (bounds[-1][0], half)
    pos = positions3.float()                                     # [B, T, 3]
    angles = torch.cat([pos[..., i:i + 1] * freqs[lo:hi]
                        for i, (lo, hi) in enumerate(bounds)], dim=-1)
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rotate(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            positions: torch.Tensor, mrope_positions=None):
    """q, k rotated at ``positions`` [B, T]: M-RoPE where the config uses
    it (``mrope_positions`` [B, T, 3], by default the text positions on
    all three streams, as the reference defaults them), RoPE otherwise,
    nothing with learned positions."""
    if cfg.use_mrope:
        mp = (mrope_positions if mrope_positions is not None
              else positions[..., None].expand(*positions.shape, 3))
        return (apply_mrope(q, mp, cfg.rope_theta),
                apply_mrope(k, mp, cfg.rope_theta))
    if cfg.learned_pos:
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   layers: Optional[int] = None):
    """Attention weights ``wq``/``wk``/``wv``/``wo`` (``x @ W``, fan_in the
    input width) and, with ``qkv_bias``, zero biases; with ``layers``,
    stacked on a leading axis of that many layers, drawn in that layout."""
    d, h, hk, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    dev, dt = gen.device, cfg.dtype
    lead = () if layers is None else (layers,)
    att = {
        "wq": dense_init(gen, lead + (d, h * dh), dt, fan_in=d),
        "wk": dense_init(gen, lead + (d, hk * dh), dt, fan_in=d),
        "wv": dense_init(gen, lead + (d, hk * dh), dt, fan_in=d),
        "wo": dense_init(gen, lead + (h * dh, d), dt, fan_in=h * dh),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", hk), ("bv", hk)):
            att[name] = torch.zeros(lead + (n * dh,), dtype=dt, device=dev)
    return att


def planned(cfg: ModelConfig) -> bool:
    """Whether the attention runs a training mesh's per-leaf plan
    (``cfg.tp_plan``): q / k / v on whole heads on every rank, the core
    split over (row, head) pairs or the cache's head dim."""
    return cfg.tp_axis is not None and cfg.tp_plan is not None


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor):
    if planned(cfg):
        return _project_qkv_whole(p, cfg, x)
    B, T, _ = x.shape
    x = block_in(x, cfg)       # column-parallel under tensor parallelism
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    dh = cfg.head_dim
    return (q.reshape(B, T, -1, dh), k.reshape(B, T, -1, dh),
            v.reshape(B, T, -1, dh))


_QKV = (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))


def _project_qkv_whole(p, cfg: ModelConfig, x: torch.Tensor):
    """q, k, v [B, T, H | Hkv, Dh] on whole heads on every rank under the
    per-leaf plan. With ``attn`` split each rank projects its columns of
    the flattened H·Dh and Hkv·Dh (``wq``/``wk``/``wv`` and their biases
    as ``param_spec`` cuts them, which need not fall on a head's edge),
    and one all-gather of the three joins them; with ``attn`` gathered
    the leaves are gathered and every rank projects them whole. Under
    autograd ``x`` enters the rank's columns through ``copy_to_tp`` and
    the joined q / k / v enter the split core through it too, so each
    gradient is the whole one on every rank."""
    dh = cfg.head_dim
    return _project_whole(p, cfg, x, _QKV, (cfg.num_heads * dh,
                                            cfg.num_kv_heads * dh,
                                            cfg.num_kv_heads * dh))


def _project_whole(p, cfg: ModelConfig, x: torch.Tensor, names, widths,
                   block: str = "attn"):
    """:func:`_project_qkv_whole` for any of the projections ``names``
    (``(weight, bias)`` pairs of ``_QKV``) of ``widths`` columns, of
    ``block`` (``cross_attn`` projects q from the decoder's rows and k /
    v from the encoder's)."""
    B, T, _ = x.shape
    g, dh = cfg.tp_axis, cfg.head_dim
    split = split_block(cfg, block)
    xc = block_in(x, cfg) if split else x
    parts = []
    for (w, b), n in zip(names, widths):
        y = xc @ (p[w] if split else leaf_at_use(p[w], cfg, -1, n))
        if b in p:
            y = y + (p[b] if split else leaf_at_use(p[b], cfg, -1, n))
        parts.append(y)
    qkv = torch.cat(parts, -1)
    if split:        # [B, T, ranks, the rank's q | k | v columns]
        qkv = all_gather(qkv, g, -1).reshape(B, T, g.size, -1)
        sizes = [n // g.size for n in widths]
    else:
        qkv, sizes = qkv[:, :, None], list(widths)
    qkv = copy_to_tp(qkv, cfg)
    return tuple(t.reshape(B, T, -1, dh) for t in qkv.split(sizes, -1))


def _out_proj(p, cfg: ModelConfig, o: torch.Tensor,
              block: str = "attn") -> torch.Tensor:
    """``wo`` on the attention output ``o`` [B, T, H·Dh], whole on every
    rank under the per-leaf plan: with ``block`` split the rank's rows of
    ``wo`` take its columns of ``o`` (a partial product, all-reduced;
    ``o`` enters through ``copy_to_tp``), with it gathered ``wo`` is
    gathered and applied whole."""
    if split_block(cfg, block):
        n = p["wo"].shape[-2]
        o = copy_to_tp(o, cfg).narrow(-1, cfg.tp_axis.rank * n, n)
        return block_out(o @ p["wo"], cfg)
    return o @ leaf_at_use(p["wo"], cfg, -2, cfg.num_heads * cfg.head_dim)


def cache_dims(cfg: ModelConfig):
    """(kv heads, head dim) of this rank's slice of a slab: its kv heads
    under tensor parallelism; under the per-leaf plan the kv heads where
    they divide the group, else the head dim where it does (the layout
    ``launch.shardings.cache_shardings`` gives a decode cache), else the
    whole."""
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    if cfg.tp_axis is None:
        return Hkv, Dh
    m = cfg.tp_axis.size
    if not planned(cfg) or Hkv % m == 0:
        return Hkv // m, Dh
    return (Hkv, Dh // m) if Dh % m == 0 else (Hkv, Dh)


def _cache_slice(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """This rank's slice (:func:`cache_dims`) of whole-head k, v
    [B, T, Hkv, Dh]."""
    hk, d = cache_dims(cfg)
    r = cfg.tp_axis.rank
    if hk < k.shape[2]:
        return k.narrow(2, r * hk, hk), v.narrow(2, r * hk, hk)
    if d < k.shape[3]:
        return k.narrow(3, r * d, d), v.narrow(3, r * d, d)
    return k, v


def _pair_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Causal attention of whole-head q [B, T, H, Dh], k, v [B, T, Hkv,
    Dh] (every rank holds them) split over the model group by (row, head)
    pairs: pair ``i = h·B + b`` (head-major, so where H divides the group
    a rank takes whole heads), ``ceil(B·H / ranks)`` consecutive pairs a
    rank (the last rank's tail repeats the last pair), each pair one head
    over its kv head ``h // G``. The pairs run as a batch of one-head
    prompts through :func:`_prefill_core` (#6 for a kernel head dim) and
    one all-gather returns every pair. With ``causal=False`` (whisper's
    encoder and cross-attention; k, v [B, S, Hkv, Dh] of any S) every
    query sees every key, in plain PyTorch (``_gqa_sdpa``). Returns
    [B, T, H, Dh]."""
    g = cfg.tp_axis
    B, T, H, Dh = q.shape
    G = H // k.shape[2]
    P = B * H
    n = -(-P // g.size)
    i = torch.arange(g.rank * n, (g.rank + 1) * n,
                     device=q.device).clamp(max=P - 1)
    h, b = i // B, i % B
    qp = q[b, :, h][:, :, None]
    kp = k[b, :, h // G][:, :, None]
    vp = v[b, :, h // G][:, :, None]
    core = (_prefill_core(cfg, qp, kp, vp) if causal
            else _gqa_sdpa(qp, kp, vp, None))
    o = all_gather(core, g, 0)[:P]
    return o.reshape(H, B, T, Dh).permute(1, 2, 0, 3)


# --------------------------------------------------------------------------
# Core SDPA (GQA, masked): the dense path, plain PyTorch
# --------------------------------------------------------------------------
def _gqa_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask):
    """q [B,Tq,H,Dh]; k,v [B,S,Hkv,Dh]; mask broadcastable to
    [B, Hkv, G, Tq, S] (5-d; None = attend everything). Scores, softmax and
    both products in f32; the weights round to V's dtype before P·V, as
    the reference's ``w.astype(v.dtype)`` does."""
    B, Tq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, H // Hkv, Dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(Dh)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


# --------------------------------------------------------------------------
# Whole-prompt prefill and decode against the monolithic slab
# --------------------------------------------------------------------------
KV_DTYPES = ("bf16", "int8")


class KVCache(NamedTuple):
    k: torch.Tensor     # slab [(L,) B, S, Hkv, Dh] or pool [(L,) NB, BS, ...]
    v: torch.Tensor


# query rows per tile of the banded window path: its f32 scores hold
# tile x (window + tile) keys per head
WINDOW_TILE = 512


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, tile: Optional[int] = None
                     ) -> torch.Tensor:
    """Banded causal attention over a whole prompt: q [B, T, H, Dh] at
    positions 0..T-1 sees keys ``q - window < k <= q`` of k, v
    [B, T, Hkv, Dh]. Plain PyTorch (``_gqa_sdpa``), ``tile`` query rows at
    a time over the keys their band covers, so the scores stay
    O(tile x (window + tile)) at any T. This is the counterpart of the
    reference's XLA math for a prompt longer than its window (its masked
    SDPA and flash scan with ``window=``): no Hopper kernel takes a lower
    key bound yet, and the contiguous prefill kernel would attend the
    whole causal prefix. ``tile`` defaults to ``WINDOW_TILE``. Returns
    [B, T, H, Dh]."""
    B, T = q.shape[:2]
    tile = tile or WINDOW_TILE
    out = torch.empty_like(q)
    for q0 in range(0, T, tile):
        q1 = min(q0 + tile, T)
        k0 = max(0, q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        out[:, q0:q1] = _gqa_sdpa(q[:, q0:q1], k[:, k0:q1], v[:, k0:q1],
                                  mask[None, None, None])
    return out


class _CausalPrefill(torch.autograd.Function):
    """#6 under autograd: forward runs ``prefill_attention`` (the kernel,
    its plain version for CPU tensors); backward recomputes the plain
    version under autograd from the saved q, k, v and differentiates it.
    The reference trains through XLA and has no backward kernel either; a
    hand-written backward kernel is later work."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return prefill_attention(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need) for t, need in
                       zip(saved, ctx.needs_input_grad[:3]))
            full = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                              device=q.device)
            out = prefill_attention_plain(q, k, v, full)
            wanted = [t for t in (q, k, v) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None
                     for t in (q, k, v))


def causal_prefill(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal attention over a whole prompt (q [B, T, H, Dh], k, v
    [B, T, Hkv, Dh], contiguous) through #6, differentiable: see
    :class:`_CausalPrefill`. Launches the kernel once a forward (again
    when a checkpointed layer recomputes it), never in backward."""
    return _CausalPrefill.apply(q, k, v)


def attention_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, mrope_positions=None):
    """Causal self-attention over a whole prompt: x [B, T, D], positions
    [B, T] = 0..T-1 (``mrope_positions`` [B, T, 3] under M-RoPE). The
    contiguous causal prefill kernel attends (its plain version for CPU
    tensors); the reference's two XLA branches (masked SDPA up to T² =
    2048², the flash scan above) compute this one function. With a
    sliding window W, a prompt of T <= W runs the same kernel (the window
    masks nothing) and a longer one :func:`window_attention`; so does a
    head dim outside ``KERNEL_HEAD_DIMS`` (zamba2's 80), with a window of
    T, checked before any launch. The kernel runs through
    :func:`causal_prefill`, so the loss can differentiate it. Under the
    per-leaf plan the core splits over (row, head) pairs
    (:func:`_pair_core`). Returns (out [B, T, D], (k, v) [B, T, Hkv, Dh]
    after RoPE; under a group this rank's slice, :func:`cache_dims`)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    if planned(cfg):
        out = _pair_core(cfg, q, k, v).reshape(B, T, -1)
        return _out_proj(p, cfg, out), _cache_slice(cfg, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = _prefill_core(cfg, q, k, v)
    return block_out(out.reshape(B, T, -1) @ p["wo"], cfg), (k, v)


def _prefill_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal attention over a whole prompt (contiguous q [B, T, H, Dh],
    k, v [B, T, Hkv, Dh]): the banded plain path beyond a sliding window
    or for a head dim no kernel takes, else #6."""
    T = q.shape[1]
    W = cfg.sliding_window
    if W and T > W:
        return window_attention(q, k, v, W)
    if cfg.head_dim not in KERNEL_HEAD_DIMS:
        # no kernel instance for this head dim: the tiled plain path,
        # whose window of T masks nothing beyond causality
        return window_attention(q, k, v, T)
    return causal_prefill(q, k, v)


def make_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: Optional[torch.dtype] = None, device="cuda",
               layers: Optional[int] = None) -> KVCache:
    """Zeroed monolithic KV slab: [batch, S, Hkv, Dh] for ONE layer, or
    [layers, batch, S, Hkv, Dh]: one row of ``S`` keys per batch slot,
    whatever the slot's request holds. ``S = seq``, or with a sliding
    window the ring ``min(seq, window)``."""
    W = cfg.sliding_window
    S = min(seq, W) if W else seq
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    if layers is not None:
        shape = (layers,) + shape
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache_l: KVCache,
                     pos: torch.Tensor, rows: Optional[torch.Tensor] = None,
                     *, mrope_positions=None, seq_group=None):
    """One token against a slab layer: x [B, 1, D]; pos [B] int32 tokens
    already cached; cache_l [B, S, Hkv, Dh], or with ``rows`` ([B] int32,
    the slab row of each x row) a slab of any number of rows. Writes the
    new token's K/V in place at ``pos`` (``pos % W`` in a window's ring),
    clamped to ``S - 1`` as the reference's ``dynamic_update_slice``
    clamps it, then attends keys ``< min(pos + 1, S)`` through the
    contiguous decode kernel in its padded mode, which streams all S keys
    of each row with a mask, as the reference's masked SDPA does (its
    plain version for CPU tensors). In a ring the valid slots are always
    that prefix: slots 0..pos before it wraps, all W of the last W
    positions after, and attention does not depend on the keys' order
    (RoPE rotated K before it was cached). A head dim outside
    ``KERNEL_HEAD_DIMS`` runs the plain padded decode. With
    ``seq_group`` (a ``launch.mesh.Collectives``) the slab's sequence is
    split over that group, ``cache_l`` holding this rank's consecutive
    rows: context parallelism, :func:`context_parallel_decode`. Under the
    per-leaf plan ``cache_l`` is the rank's slice and the core follows
    its layout (:func:`_planned_decode`; the ``seq_cache`` lever:
    the slab's sequence split over the group). Returns (out [B, 1, D],
    cache_l)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, pos[:, None], mrope_positions)
    W = cfg.sliding_window
    write = torch.remainder(pos, W) if W else pos
    if planned(cfg):
        o = _planned_decode(cfg, q[:, 0], k[:, 0], v[:, 0], cache_l, write,
                            pos, rows, seq_group)
        return _out_proj(p, cfg, o.reshape(B, 1, -1)), cache_l
    o = _slab_core(cfg, q[:, 0], k[:, 0], v[:, 0], cache_l, write, pos,
                   rows, seq_group)
    return psum_if_tp(o.reshape(B, 1, -1) @ p["wo"], cfg), cache_l


def _slab_core(cfg: ModelConfig, q, k, v, cache_l: KVCache, write, pos,
               rows=None, seq_group=None) -> torch.Tensor:
    """The new token's k, v [B, Hkv, Dh] written into the slab layer at
    ``write`` and q [B, H, Dh] attended over it (:func:`attention_decode`
    after the projections). Returns [B, H, Dh]."""
    B = q.shape[0]
    S = cache_l.k.shape[1]
    if seq_group is not None:
        if rows is not None:
            raise ValueError("context-parallel decode takes no row map")
        return context_parallel_decode(q, k, v, cache_l, write, pos,
                                       seq_group)
    slab_row = (torch.arange(B, device=pos.device) if rows is None
                else rows.long())
    idx = (slab_row, torch.clamp(write, max=S - 1).long())
    cache_l.k.index_put_(idx, k.to(cache_l.k.dtype))
    cache_l.v.index_put_(idx, v.to(cache_l.v.dtype))
    lengths = torch.clamp(pos + 1, max=S).to(torch.int32)
    kv_rows = None if rows is None else rows.to(torch.int32)
    return _decode(cfg, q.contiguous(), cache_l.k, cache_l.v, lengths,
                   kv_rows)


def _planned_decode(cfg: ModelConfig, q, k, v, cache_l: KVCache, write,
                    pos, rows=None, seq_group=None) -> torch.Tensor:
    """The decode core under the per-leaf plan, on whole-head q [B, H,
    Dh] and the new token's k, v [B, Hkv, Dh], by the layout of the
    rank's slab layer: split on the head dim, :func:`head_dim_decode`
    (no kernel: plain PyTorch, as the reference's per-chip program is
    XLA's); split on kv heads, the rank's query heads attend its kv
    heads (#5) and one all-gather joins the heads; split on the sequence
    (the ``seq_cache`` lever, ``launch.shardings.cache_shardings(
    seq_on_model=True)``: the rank's S / m consecutive rows of every kv
    head), the owning rank writes the new token and each rank attends its
    keys with every head, the shares merged by log-sum-exp over the group
    (:func:`context_parallel_decode`: plain PyTorch, as the reference's
    pinned-scatter program is XLA's); whole, every rank attends all of
    it. Returns [B, H, Dh]."""
    g = cfg.tp_axis
    hk, d = cache_l.k.shape[-2:]
    if cfg.levers is not None and cfg.levers.seq_cache:
        if (hk, d) != (cfg.num_kv_heads, cfg.head_dim) or (
                seq_group is not None or rows is not None):
            raise ValueError(
                f"a slab split on its sequence over the model group holds "
                f"every kv head whole ({cfg.num_kv_heads} x {cfg.head_dim}, "
                f"not {hk} x {d}) and takes no row map and no data split")
        return context_parallel_decode(q, k, v, cache_l, write, pos, g)
    if d < cfg.head_dim:
        if rows is not None:
            raise ValueError("a slab split on the head dim takes no row "
                             "map")
        return head_dim_decode(q, k, v, cache_l, write, pos, g, seq_group)
    if hk < cfg.num_kv_heads:
        G = q.shape[1] // cfg.num_kv_heads
        h0 = g.rank * hk
        o = _slab_core(cfg, q[:, h0 * G:(h0 + hk) * G], k[:, h0:h0 + hk],
                       v[:, h0:h0 + hk], cache_l, write, pos, rows,
                       seq_group)
        return all_gather(o, g, 1)
    return _slab_core(cfg, q, k, v, cache_l, write, pos, rows, seq_group)


def head_dim_decode(q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, cache_l: KVCache, write, pos,
                    group, seq_group=None) -> torch.Tensor:
    """Decode against a slab split on its head dim over ``group``: this
    rank holds columns ``[rank·d, (rank + 1)·d)`` of every key and value
    (``cache_l`` [B, S, Hkv, d]). It writes its columns of the new
    token's k, v [B, Hkv, Dh] (after RoPE on the whole head) at ``write``
    (clamped to the last row), computes the partial scores of its
    columns of q [B, H, Dh] in f32, all-reduces them once over ``group``,
    then masks keys ``>= min(pos + 1, S)``, weighs them by softmax and
    takes P·v on its columns; one all-gather joins the columns. With
    ``seq_group`` the slab's sequence is also split over that group
    (:func:`context_parallel_decode`'s layout): each shard's weighted
    values merge by log-sum-exp before the columns join. Plain PyTorch:
    no kernel takes a partial head. Returns [B, H, Dh] in q's dtype."""
    B, H, Dh = q.shape
    S, Hkv, d = cache_l.k.shape[1:]
    c0 = group.rank * d
    k_new, v_new = k_new[..., c0:c0 + d], v_new[..., c0:c0 + d]
    if seq_group is None:
        idx = (torch.arange(B, device=pos.device),
               torch.clamp(write, max=S - 1).long())
        cache_l.k.index_put_(idx, k_new.to(cache_l.k.dtype))
        cache_l.v.index_put_(idx, v_new.to(cache_l.v.dtype))
        lengths = torch.clamp(pos + 1, max=S)
    else:
        lengths = _seq_split_write(k_new, v_new, cache_l, write, pos,
                                   seq_group)
    return _head_dim_attend(q, cache_l, lengths, group, seq_group)


def _head_dim_attend(q: torch.Tensor, cache_l: KVCache, lengths, group,
                     seq_group=None) -> torch.Tensor:
    """:func:`head_dim_decode`'s attention after its write: q [B, H, Dh]
    over the keys ``< lengths`` of a slab split on its head dim over
    ``group`` (this rank's columns in ``cache_l`` [B, S, Hkv, d]). Plain
    PyTorch; the partial scores all-reduced once, the columns joined by
    one all-gather. Returns [B, H, Dh] in q's dtype."""
    B, H, Dh = q.shape
    Hkv, d = cache_l.k.shape[2:]
    c0 = group.rank * d
    qg = q[..., c0:c0 + d].reshape(B, Hkv, H // Hkv, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, cache_l.k.float())
    s = group.all_reduce(s) / math.sqrt(Dh)
    out, lse = _weigh_values(s, cache_l.v, lengths)
    if seq_group is not None:
        out = merge_decode_partials(out, lse, seq_group)
    return all_gather(out.to(q.dtype), group, -1)


def _decode(cfg: ModelConfig, q, k, v, lengths, kv_rows=None):
    """The padded contiguous decode: the kernel, or for a head dim outside
    ``KERNEL_HEAD_DIMS`` its plain version, chosen before any launch."""
    fn = (decode_attention if cfg.head_dim in KERNEL_HEAD_DIMS
          else decode_attention_plain)
    return fn(q, k, v, lengths, ragged=False, kv_rows=kv_rows)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor):
    """One rank's share of a decode whose keys are split over ranks, in
    plain PyTorch, f32: q [B, H, Dh] over the keys ``< lengths`` of k, v
    [B, S, Hkv, Dh]. Returns (out [B, H, Dh] f32, the log-sum-exp of the
    scores [B, H] f32). A row with no key here weighs each of its keys
    ``exp(0)`` under masked scores of ``NEG_INF``, so its log-sum-exp is
    ``NEG_INF`` up to rounding and the merge gives it no weight."""
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(Dh)
    return _weigh_values(s, v, lengths)


def _weigh_values(s: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor):
    """Scaled f32 scores s [B, Hkv, G, S] over values v [B, S, Hkv, Dv]:
    keys ``>= lengths`` masked to ``NEG_INF``, weights ``exp(s - max)``.
    Returns (out [B, H, Dv] f32, the scores' log-sum-exp [B, H] f32)."""
    B, Hkv, G, S = s.shape
    keep = (torch.arange(S, device=s.device)
            < lengths.long()[:, None, None, None])
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return ((acc / l).reshape(B, Hkv * G, -1),
            (m + torch.log(l)).reshape(B, Hkv * G))


def merge_decode_partials(out: torch.Tensor, lse: torch.Tensor,
                          group) -> torch.Tensor:
    """The whole decode from every rank's :func:`decode_attention_partial`
    (out [B, H, Dh], lse [B, H], f32): one all-gather of both over
    ``group``, then each rank's output weighed by ``exp(lse - max)``.
    Returns [B, H, Dh] f32."""
    B, H, Dh = out.shape
    both = torch.cat([out.reshape(B, H * Dh), lse], dim=-1)[None]
    parts = group.all_gather(both, 0)              # [ranks, B, H·Dh + H]
    outs = parts[..., :H * Dh].reshape(-1, B, H, Dh)
    lses = parts[..., H * Dh:]
    w = torch.exp(lses - lses.amax(0, keepdim=True))
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


def context_parallel_decode(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cache_l: KVCache,
                            write: torch.Tensor, pos: torch.Tensor,
                            group) -> torch.Tensor:
    """Decode against a slab whose sequence is split over ``group``: this
    rank holds rows ``[rank·S, (rank + 1)·S)`` of the ``S·size``-row slab
    (or ring) in ``cache_l`` [B, S, Hkv, Dh]. The new token's K/V
    (k_new, v_new [B, Hkv, Dh]) land at slab row ``write`` (clamped to the
    last row, as the unsplit decode clamps it) on the rank that owns it;
    each rank attends q [B, H, Dh] over its share of the keys ``<
    min(pos + 1, S·size)`` (:func:`decode_attention_partial`) and the
    shares merge by log-sum-exp (:func:`merge_decode_partials`). The
    reference's ``long_500k`` decode shards the cache's sequence on
    ``data`` this way (GSPMD writes the merge). Returns [B, H, Dh] in
    q's dtype."""
    lengths = _seq_split_write(k_new, v_new, cache_l, write, pos, group)
    out, lse = decode_attention_partial(q, cache_l.k, cache_l.v, lengths)
    return merge_decode_partials(out, lse, group).to(q.dtype)


def _seq_split_write(k_new, v_new, cache_l: KVCache, write, pos,
                     group) -> torch.Tensor:
    """The new token's k_new, v_new [B, Hkv, d] written at slab row
    ``write`` (clamped to the last row) by the rank of ``group`` that
    holds it, of a slab whose sequence is split over ``group`` (this
    rank's consecutive rows in ``cache_l``). Returns the count of this
    rank's rows each query sees, ``min(pos + 1, S·size)`` less its first
    row, clamped to [0, S]."""
    B = k_new.shape[0]
    S = cache_l.k.shape[1]
    lo = group.rank * S
    total = S * group.size
    local = torch.clamp(write, max=total - 1).long() - lo
    own = ((local >= 0) & (local < S))[:, None, None]
    idx = (torch.arange(B, device=pos.device), torch.clamp(local, 0, S - 1))
    for buf, new in ((cache_l.k, k_new), (cache_l.v, v_new)):
        buf.index_put_(idx, torch.where(own, new.to(buf.dtype), buf[idx]))
    return torch.clamp(torch.clamp(pos + 1, max=total) - lo, 0, S)


# --------------------------------------------------------------------------
# The paged pool
# --------------------------------------------------------------------------


class QuantKVCache(NamedTuple):
    """int8 paged block pool (DESIGN.md §Quantized KV blocks): K/V rows are
    symmetric int8 over the head dim with f32 per-(block, position,
    kv-head) scales — (Dh + 4)/(2·Dh) of the bf16 bytes. A tuple of leaves
    like :class:`KVCache`, so the block gather/scatter and migration
    helpers run over it unchanged."""
    k: torch.Tensor        # [(L,) NB, BS, Hkv, Dh] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [(L,) NB, BS, Hkv] f32
    v_scale: torch.Tensor


def layer_pool(pool, l: int):
    """Layer ``l``'s slice of a layer-stacked pool (views)."""
    return type(pool)(*(a[l] for a in pool))


def make_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype: Optional[torch.dtype] = None, device="cuda",
                    kv_dtype: str = "bf16", layers: Optional[int] = None):
    """Zeroed global block pool: [NB, BS, Hkv, Dh] for ONE layer, or
    [layers, NB, BS, Hkv, Dh]. ``kv_dtype="int8"`` gives the quantized
    layout with zero scales, so the garbage block (and any row never
    written) dequantizes to exact zeros."""
    assert kv_dtype in KV_DTYPES, kv_dtype
    shape = (num_blocks, block_size, cfg.num_kv_heads // cfg.tp_size,
             cfg.head_dim)
    if layers is not None:
        shape = (layers,) + shape
    if kv_dtype == "int8":
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the last (head) axis, as the
    reference computes it: ``scale = max(amax_f32 / 127, 1e-8)``, then
    ``round(x_f32 / scale)`` (half to even) clipped to ±127 — a division,
    not a product with the reciprocal, so the int8 values are the
    reference's. Returns ``(int8 values, f32 scales [x.shape[:-1]])``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def scatter_pool(pool_l, blk: torch.Tensor, off: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor):
    """Write new K/V rows into one layer's pool slice at physical
    ``(blk, off)``, in place — quantize-on-write when the pool is int8.
    ``blk``/``off`` are integer tensors of a matching shape S; ``k``/``v``
    are [*S, Hkv, Dh] in compute dtype."""
    idx = (blk.long(), off.long())
    if isinstance(pool_l, QuantKVCache):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pool_l.k.index_put_(idx, kq)
        pool_l.v.index_put_(idx, vq)
        pool_l.k_scale.index_put_(idx, ks)
        pool_l.v_scale.index_put_(idx, vs)
        return pool_l
    pool_l.k.index_put_(idx, k.to(pool_l.k.dtype))
    pool_l.v.index_put_(idx, v.to(pool_l.v.dtype))
    return pool_l


def _pool_scales(pool_l):
    """(k_scale, v_scale) kernel operands — (None, None) for full-width
    pools."""
    if isinstance(pool_l, QuantKVCache):
        return pool_l.k_scale, pool_l.v_scale
    return None, None


def quantize_piece(piece: KVCache) -> QuantKVCache:
    """Contiguous full-precision KV piece (leaves ``[..., Hkv, Dh]``) ->
    its :class:`QuantKVCache` twin, for writing into an int8 pool."""
    kq, ks = quantize_kv(piece.k)
    vq, vs = quantize_kv(piece.v)
    return QuantKVCache(kq, vq, ks, vs)


def dequantize_piece(piece: QuantKVCache, dtype: torch.dtype) -> KVCache:
    """:class:`QuantKVCache` piece -> contiguous full-precision
    :class:`KVCache` in ``dtype`` (product in f32, then cast). Migration
    exports cross this, so the wire stays full-width and bf16 and int8
    engines interoperate."""
    return KVCache(
        (piece.k.float() * piece.k_scale[..., None]).to(dtype),
        (piece.v.float() * piece.v_scale[..., None]).to(dtype))


def _check_kv_backend(pool_l, attn_backend: str) -> None:
    """int8 pools are read by the fused kernel and the dense path; the
    grid and flat kernels take full-width pools only."""
    if isinstance(pool_l, QuantKVCache) and attn_backend in ("grid", "flat"):
        raise ValueError(f"int8 KV pools need the 'fused' or 'dense' "
                         f"backend, got {attn_backend!r}")


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor):
    """pool [NB, BS, Hkv, Dh]; block_tables [B, NBT] -> contiguous
    per-request view [B, NBT*BS, Hkv, Dh] (rows past a request's length
    come from padding entries and must be masked by the caller)."""
    B, NBT = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(B, NBT * pool.shape[1], *pool.shape[2:])


def _gather_dequant(pool_l, block_tables: torch.Tensor):
    """Dense-path gather of a request-contiguous [B, NBT·BS, Hkv, Dh] view,
    dequantized to f32 when the pool is int8."""
    k_seq = paged_gather(pool_l.k, block_tables)
    v_seq = paged_gather(pool_l.v, block_tables)
    if isinstance(pool_l, QuantKVCache):
        ks = paged_gather(pool_l.k_scale, block_tables)      # [B, S, Hkv]
        vs = paged_gather(pool_l.v_scale, block_tables)
        k_seq = k_seq.float() * ks[..., None]
        v_seq = v_seq.float() * vs[..., None]
    return k_seq, v_seq


def _dense_attention(q: torch.Tensor, pool_l, block_tables: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """The dense backend: q [B, T, H, Dh] at global ``positions`` [B, T]
    over its request's gathered rows ``kpos <= position``. Returns
    [B, T, H, Dh]."""
    k_seq, v_seq = _gather_dequant(pool_l, block_tables)
    kpos = torch.arange(k_seq.shape[1], device=q.device)[None, None, :]
    mask = (kpos <= positions[:, :, None])[:, None, None]     # [B,1,1,T,S]
    return _gqa_sdpa(q, k_seq, v_seq, mask)


def _paged_decode(attn_backend: str, q: torch.Tensor, pool_l,
                  block_tables: torch.Tensor, lengths: torch.Tensor,
                  num_work=None, work_list=None) -> torch.Tensor:
    """The decode kernel of the ``grid`` or ``flat`` backend: q [B, H, Dh]
    over keys ``idx < lengths``. Returns [B, H, Dh]."""
    if attn_backend == "grid":
        return paged_decode_attention(q, pool_l.k, pool_l.v, block_tables,
                                      lengths)
    return paged_decode_attention_flat(q, pool_l.k, pool_l.v, block_tables,
                                       lengths, num_work=num_work,
                                       work_list=work_list)


def _table_entry(block_tables: torch.Tensor, pos: torch.Tensor, BS: int):
    """Physical block of logical position ``pos`` per row. Dead rows carry
    ``pos = -1``; the JAX gather wraps that to the table's last column,
    which here is an explicit floor-mod (every entry of a dead row is the
    garbage block, so any column would do)."""
    col = torch.remainder(torch.div(pos, BS, rounding_mode="floor"),
                          block_tables.shape[1])
    return torch.gather(block_tables, 1, col.long())


# --------------------------------------------------------------------------
# Decode, chunked prefill and the mixed iteration
# --------------------------------------------------------------------------
def attention_decode_paged(p, cfg: ModelConfig, x: torch.Tensor,
                           pool_l: KVCache, block_tables: torch.Tensor,
                           pos: torch.Tensor, *, attn_backend: str = "fused",
                           attn_num_work: Optional[int] = None,
                           attn_work_list=None, mrope_positions=None):
    """x [B, 1, D]; pool_l one layer's slice; block_tables [B, NBT] int32;
    pos [B] int32 tokens already cached (-1 = dead slot: its write lands
    in the garbage block and its attention length is 0). Writes the new
    token's K/V, then attends over keys ``<= pos``: the fused kernel with
    all-decode tags (ctx = pos, seg = 1), the grid or flat decode kernel
    (lengths = pos + 1; flat runs ``attn_num_work`` work items, and
    ``attn_work_list`` is their flat work list when the caller built it
    once for all layers), or the dense gather + SDPA. Returns
    (out [B, 1, D], pool_l)."""
    assert not cfg.sliding_window, "paged decode is full-attention only"
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, pos[:, None], mrope_positions)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    blk = _table_entry(block_tables, pos[:, None], BS)[:, 0]
    scatter_pool(pool_l, blk, torch.remainder(pos, BS), k[:, 0], v[:, 0])
    if attn_backend == "fused":
        o = paged_mixed_attention(
            q.contiguous(), pool_l.k, pool_l.v, block_tables, pos,
            torch.ones_like(pos), torch.zeros_like(pos),
            *_pool_scales(pool_l), num_work=attn_num_work)
    elif attn_backend == "dense":
        o = _dense_attention(q, pool_l, block_tables, pos[:, None])
    else:
        o = _paged_decode(attn_backend, q[:, 0].contiguous(), pool_l,
                          block_tables, pos + 1, attn_num_work,
                          attn_work_list)
    return psum_if_tp(o.reshape(B, 1, -1) @ p["wo"], cfg), pool_l


def attention_prefill_chunk_paged(p, cfg: ModelConfig, x: torch.Tensor,
                                  pool_l: KVCache,
                                  block_tables: torch.Tensor,
                                  ctx_len: torch.Tensor,
                                  chunk_len: torch.Tensor, *,
                                  attn_backend: str = "fused",
                                  mrope_positions=None):
    """Chunked prefill against the paged pool: x [B, C, D] — B prompt
    chunks of C tokens (rows past ``chunk_len`` are padding);
    block_tables [B, NBT] covering ``ceil((ctx_len + C)/BS)`` rows (the
    tail on the garbage block); ctx_len / chunk_len [B] int32. Writes the
    chunk's K/V at positions ``ctx..ctx+C-1`` (RoPE at the true
    positions), then attends each query causally over the written context
    and its own chunk: the chunked prefill kernel (``grid`` and ``flat``),
    the fused kernel with all-chunk tags, or the dense gather + SDPA.
    Returns (out [B, C, D], pool_l); rows past ``chunk_len`` are zeros on
    the kernel backends and unspecified on ``dense`` (the caller reads
    only real rows)."""
    assert not cfg.sliding_window, "paged prefill is full-attention only"
    B, C, _ = x.shape
    ctx = ctx_len.to(torch.int32)
    clen = chunk_len.to(torch.int32)
    positions = ctx[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=ctx.device)[None]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    scatter_pool(pool_l, _table_entry(block_tables, positions, BS),
                 torch.remainder(positions, BS), k, v)
    q = q.contiguous()
    if attn_backend == "fused":
        o = paged_mixed_attention(q, pool_l.k, pool_l.v, block_tables, ctx,
                                  clen, torch.ones_like(ctx),
                                  *_pool_scales(pool_l))
    elif attn_backend == "dense":
        o = _dense_attention(q, pool_l, block_tables, positions)
    else:
        o = paged_prefill_attention(q, pool_l.k, pool_l.v, block_tables,
                                    ctx, clen)
    return psum_if_tp(o.reshape(B, C, -1) @ p["wo"], cfg), pool_l


def attention_mixed_paged(p, cfg: ModelConfig, x_dec: torch.Tensor,
                          x_ck: torch.Tensor, pool_l: KVCache,
                          bt_dec: torch.Tensor, bt_ck: torch.Tensor,
                          pos: torch.Tensor, ctx_len: torch.Tensor,
                          chunk_len: torch.Tensor, *,
                          attn_backend: str = "fused",
                          attn_num_work: Optional[int] = None):
    """The attention of a whole mixed iteration: ONE fused launch; on the
    ``grid`` and ``flat`` backends that backend's decode kernel for the
    decode half and the chunked prefill kernel for the chunks
    (``attn_num_work`` is then not taken: flat's decode half runs the
    worst-case bucket); on ``dense`` a gather + SDPA for each half.

    x_dec [Bd, 1, D] — the decode batch (``pos = -1`` marks dead slots);
    x_ck [Bp, C, D] — prompt chunks (rows past ``chunk_len`` are
    padding); bt_dec [Bd, NBT] / bt_ck [Bp, NBT'] block tables, padded to
    a common width here; pos [Bd]; ctx_len / chunk_len [Bp] int32.
    Projection, RoPE and ``wo`` run per half; the attention runs as one
    tagged launch: decode segments (tag 0, ctx = pos, seg = 1), then the
    chunks (tag 1). Returns ``(out_dec [Bd, 1, D], out_ck [Bp, C, D],
    pool_l)``.
    """
    assert not cfg.sliding_window, "paged mixed step is full-attention only"
    assert not cfg.use_mrope, "paged mixed step: RoPE / learned-pos only"
    _check_kv_backend(pool_l, attn_backend)
    Bd = x_dec.shape[0]
    Bp, C, _ = x_ck.shape
    ctx = ctx_len.to(torch.int32)
    clen = chunk_len.to(torch.int32)
    positions = ctx[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=ctx.device)[None]

    qd, kd, vd = _project_qkv(p, cfg, x_dec)
    qc, kc, vc = _project_qkv(p, cfg, x_ck)
    qd, kd = _rotate(cfg, qd, kd, pos[:, None])
    qc, kc = _rotate(cfg, qc, kc, positions)

    BS = pool_l.k.shape[1]
    blk_d = _table_entry(bt_dec, pos[:, None], BS)[:, 0]
    blk_c = _table_entry(bt_ck, positions, BS)
    scatter_pool(pool_l, blk_d, torch.remainder(pos, BS), kd[:, 0], vd[:, 0])
    scatter_pool(pool_l, blk_c, torch.remainder(positions, BS), kc, vc)

    if attn_backend == "dense":
        out_d = _dense_attention(qd, pool_l, bt_dec, pos[:, None])
        out_c = _dense_attention(qc, pool_l, bt_ck, positions)
        return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
                psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)
    if attn_backend != "fused":
        out_d = _paged_decode(attn_backend, qd[:, 0].contiguous(), pool_l,
                              bt_dec, pos + 1)
        out_c = paged_prefill_attention(qc.contiguous(), pool_l.k, pool_l.v,
                                        bt_ck, ctx, clen)
        return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
                psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)
    # decode q rides in row 0 of a chunk-wide tile; tables pad to a common
    # width (padded entries lie past every segment's total: never read)
    NBT = max(bt_dec.shape[1], bt_ck.shape[1])
    pad = torch.nn.functional.pad
    bt_all = torch.cat([pad(bt_dec, (0, NBT - bt_dec.shape[1])),
                        pad(bt_ck, (0, NBT - bt_ck.shape[1]))])
    q_all = torch.cat([pad(qd, (0, 0, 0, 0, 0, C - 1)), qc])
    o = paged_mixed_attention(
        q_all, pool_l.k, pool_l.v, bt_all, torch.cat([pos, ctx]),
        torch.cat([torch.ones_like(pos), clen]),
        torch.cat([torch.zeros_like(pos), torch.ones_like(ctx)]),
        *_pool_scales(pool_l), num_work=attn_num_work)
    out_d, out_c = o[:Bd, :1], o[Bd:]
    return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
            psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)


# --------------------------------------------------------------------------
# Whisper's encoder self-attention and its decoder's cross-attention: K/V
# computed once from the encoder
# --------------------------------------------------------------------------
def encoder_attention(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention over x [B, T, D] (no mask, no
    rotation: whisper's encoder), plain ``_gqa_sdpa`` as the reference's
    XLA. Under tensor parallelism on the rank's heads (``wo``'s rows
    all-reduced); under the per-leaf plan q / k / v on whole heads and
    the core split over (row, head) pairs (:func:`_pair_core`,
    non-causal). Returns [B, T, D]."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if planned(cfg):
        o = _pair_core(cfg, q, k, v, causal=False)
        return _out_proj(p, cfg, o.reshape(B, T, -1))
    o = _gqa_sdpa(q, k, v, None).reshape(B, T, -1)
    return psum_if_tp(o @ p["wo"], cfg)


def _cross_q(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The cross-attention's q [B, T, H | H / n, Dh]: whole heads under
    the per-leaf plan (:func:`_project_whole`), the rank's heads under
    tensor parallelism, all of them without a group."""
    B, T, _ = x.shape
    if planned(cfg):
        return _project_whole(p, cfg, x, _QKV[:1],
                              (cfg.num_heads * cfg.head_dim,),
                              "cross_attn")[0]
    q = block_in(x, cfg) @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(B, T, -1, cfg.head_dim)


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: KVCache) -> torch.Tensor:
    """Decoder queries x [B, T, D] over the encoder's K/V [B, S_enc, Hkv,
    Dh] from :func:`encode_cross_kv` (whole heads under the per-leaf
    plan, the rank's under tensor parallelism), every key visible. One
    token (T = 1) runs the contiguous decode kernel in its padded mode
    with ``lengths = S_enc`` (the plain version for CPU tensors or a head
    dim no kernel takes); a prompt's T queries run the plain
    ``_gqa_sdpa``, as the reference's XLA does: #6 is causal only. Under
    the per-leaf plan the core splits over (row, head) pairs. Returns
    [B, T, D]."""
    B, T, _ = x.shape
    q = _cross_q(p, cfg, x)
    if planned(cfg):
        o = _pair_core(cfg, q, enc_kv.k, enc_kv.v, causal=False)
        return _out_proj(p, cfg, o.reshape(B, T, -1), "cross_attn")
    if T == 1:
        S = enc_kv.k.shape[1]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        out = _decode(cfg, q[:, 0].contiguous(), enc_kv.k, enc_kv.v,
                      lengths)[:, None]
    else:
        out = _gqa_sdpa(q, enc_kv.k, enc_kv.v, None)
    return block_out(out.reshape(B, T, -1) @ p["wo"], cfg)


def encode_cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor) -> KVCache:
    """The encoder output [B, S, D] projected to cross-attention K/V
    [B, S, Hkv, Dh] (with the biases where the layer has them): under
    the per-leaf plan on whole heads on every rank (the rank's columns
    joined by one all-gather, :func:`_project_whole`), under tensor
    parallelism the rank's kv heads."""
    B, S, _ = enc_out.shape
    if planned(cfg):
        n = cfg.num_kv_heads * cfg.head_dim
        return KVCache(*_project_whole(p, cfg, enc_out, _QKV[1:], (n, n),
                                       "cross_attn"))
    x = copy_to_tp(enc_out, cfg)
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    shape = (B, S, -1, cfg.head_dim)
    return KVCache(k.reshape(shape), v.reshape(shape))


CROSS_LAYOUTS = ("seq", "kv heads", "head_dim")


def cross_layout(cfg: ModelConfig, model: Optional[int] = None,
                 cache_seq=None) -> Optional[str]:
    """Where a plan lays a rank's slice of the cross K/V cache
    [L, B, S_enc, Hkv, Dh] on a model group of ``model`` ranks (default
    ``cfg.tp_axis``'s): the first of the encoder's frames
    (``encoder_seq``), the kv heads and the head dim that the group
    divides, by ``common.state_axis`` (the rule of ``launch.shardings.
    cache_shardings``) for a decode cache of ``cache_seq`` rows
    (``"none"``: whole on every rank; None without a group)."""
    if model is None:
        if cfg.tp_axis is None:
            return None
        model = cfg.tp_axis.size
    i = state_axis((cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim),
                   model, cache_seq)
    return "none" if i is None else CROSS_LAYOUTS[i]


def cross_cache_slice(cfg: ModelConfig, kv: KVCache,
                      cache_seq=None) -> KVCache:
    """This rank's slice of :func:`encode_cross_kv`'s K/V [B, S_enc, Hkv,
    Dh] in the layout ``common.state_piece`` gives the cross cache's leaf
    for a decode cache of ``cache_seq`` rows (:func:`cross_layout`).
    Under tensor parallelism a cache split on the frames needs every
    head: one all-gather of the rank's k and v heads first."""
    if cfg.tp_axis is None:
        return kv
    g = cfg.tp_axis
    k, v = kv
    whole = (k.shape[0], cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    local = state_piece(cfg, (1,) + whole, cache_seq, 1)[1:]
    dim = split_dim(local, whole)
    if dim is None:
        return kv
    if not planned(cfg) and dim == 1:
        k, v = g.all_gather(torch.cat([k, v], -1), 2).split(cfg.head_dim,
                                                             -1)
    elif not planned(cfg):
        return kv                       # the rank's kv heads already
    n = local[dim]
    return KVCache(k.narrow(dim, g.rank * n, n).contiguous(),
                   v.narrow(dim, g.rank * n, n).contiguous())


def cross_attention_decode(p, cfg: ModelConfig, x: torch.Tensor,
                           enc_kv: KVCache) -> torch.Tensor:
    """One decoder token x [B, 1, D] over the cross K/V cache ``enc_kv``
    [B, S_enc, Hkv, Dh] (under a group this rank's slice,
    :func:`cross_layout`, told by its shape), every key visible. Without
    a group, or on the rank's kv heads, the contiguous decode kernel (#5,
    padded, ``lengths = S``); on a slice of the head dim the partial
    scores all-reduced (:func:`_head_dim_attend`); on a slice of the
    frames each rank attends its keys and the shares merge by
    log-sum-exp (:func:`merge_decode_partials`). Returns [B, 1, D]."""
    B = x.shape[0]
    if cfg.tp_axis is None:
        return cross_attention(p, cfg, x, enc_kv)
    S, hk, d = enc_kv.k.shape[1:]
    heads = cfg.num_kv_heads // (1 if planned(cfg) else cfg.tp_axis.size)
    layout = ("kv heads" if hk < heads else "head_dim" if d < cfg.head_dim
              else "seq" if S < cfg.encoder_seq else "none")
    g = cfg.tp_axis
    q = _cross_q(p, cfg, x)[:, 0].contiguous()
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if layout == "seq":
        if not planned(cfg):            # every head over the rank's keys
            q = all_gather(q, g, 1)
        out, lse = decode_attention_partial(q, enc_kv.k, enc_kv.v, lengths)
        o = merge_decode_partials(out, lse, g).to(q.dtype)
        if not planned(cfg):
            o = o[:, rank_cols(cfg, cfg.num_heads // g.size)]
    elif layout == "head_dim":
        o = _head_dim_attend(q, enc_kv, lengths, g)
    elif layout == "kv heads":
        hk = enc_kv.k.shape[2]
        G = cfg.num_heads // cfg.num_kv_heads
        h0 = g.rank * hk
        o = all_gather(_decode(cfg, q[:, h0 * G:(h0 + hk) * G].contiguous(),
                               enc_kv.k, enc_kv.v, lengths), g, 1)
    else:           # the rank's heads (tensor parallelism), or whole
        o = _decode(cfg, q, enc_kv.k, enc_kv.v, lengths)
    o = o.reshape(B, 1, -1)
    if planned(cfg):
        return _out_proj(p, cfg, o, "cross_attn")
    return psum_if_tp(o @ p["wo"], cfg)
