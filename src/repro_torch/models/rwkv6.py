"""RWKV-6 "Finch" — the port of ``repro.models.rwkv6``: an attention-free
RNN with data-dependent decay. [arXiv:2404.05892]

Per layer: token-shift mixing (static lerp weights, the reference's
simplification), per-channel decay ``w_t = exp(-exp(w0 + tanh(x A) B))``,
a per-head matrix state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` read as
``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``, a per-head group norm and
the squared-ReLU channel mix. A request's decode state is O(1) in its
length: ``S`` [L, B, H, K, K] in f32 and the two token-shift rows
``att_prev`` / ``ffn_prev`` [L, B, D] in the model's dtype.

Dtypes follow the reference cast for cast: projections and lerps in the
model's dtype, the decay, the recurrence and the group norm in f32, and
the output projection in f32, cast back to the input's dtype.

**On a training mesh's model group** (``cfg.tp_axis``; the plan's
``tmix`` / ``cmix`` / ``embed`` / ``unembed`` blocks, ``training.trainer.
sharding_mechanism``) every leaf ``launch.shardings.param_spec`` splits
stays split. The time mix runs on the rank's heads: ``w_r/k/v/g`` hold
its columns, whole heads (the block splits only where the heads divide
the group), the decay LoRA, ``bonus_u`` and ``ln_x`` are sliced to
them, the recurrence and the per-head group norm are local, and ``w_o``
holds its rows: one all-reduce of the f32 product. The channel mix runs
on the rank's share of F: ``cw_k``'s columns and ``cw_v``'s rows give a
partial ``k @ cw_v`` (all-reduced), ``cw_r``'s columns the rank's
columns of the gate (all-gathered), so the block costs one all-reduce
and one all-gather of ``[.., D]``. Under autograd each block's input
enters through ``copy_to_tp``; the replicated leaves a split time mix
uses on the rank's heads (``TMIX_SHARED``) get the rank's share of their
gradient, which the trainer sums over the group. A block whose dims do
not divide gathers its split leaves at their use and runs whole. The
decode state keeps the reference's layout (``launch.shardings.
cache_shardings``): ``S`` on its heads (where they divide, else its key
dim), ``att_prev`` / ``ffn_prev`` on D; a rank gathers the two rows at
their use (one all-gather a layer) and writes back its slice.

The WKV recurrence has two forms. :func:`wkv_sequential` steps token by
token (the reference's ``lax.scan``). :func:`wkv_chunked` runs chunks of
``WKV_CHUNK`` tokens in matmuls, and is what a prompt on the card runs
(:func:`time_mix_seq` picks by device): a 5897-token prompt stepped one
token at a time would make 5897 x 32 rounds of small launches.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, all_gather, block_in,
                                       block_out, card_device, copy_to_tp,
                                       dense_init, embed_init, leaf_at_use,
                                       psum_if_tp, rank_cols, rms_norm,
                                       seq_block, seq_layers, seq_piece,
                                       seq_slice, split_block, state_in,
                                       state_out, state_piece, unsplit)
from repro_torch.models.transformer import (checkpointed, embed_tokens,
                                            layer_params, unembed)

LORA_R = 32
# Tokens per chunk of the chunked WKV. Its intra-chunk part holds every
# pair (i, j < i) of a chunk with its own decay per key channel, a
# [C, C, K] tensor per head: work and memory grow with T * C * K while the
# scan over chunks takes T / C steps. At C = 64 a 5897-token prompt makes
# 93 scan steps per layer, and the pairwise tensor of one chunk is
# 64 * 64 * 64 f32 = 1 MB per head.
WKV_CHUNK = 64
# the pairwise tensors are built a group of chunks at a time, at most
# this many f32 elements each (256 MB)
WKV_PAIR_ELEMS = 1 << 26


# the replicated leaves a split time mix uses on the rank's heads only:
# a rank's gradient of each is its heads' share (``training.trainer``
# sums it over the model group)
TMIX_SHARED = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_w0",
               "decay_A", "decay_B", "bonus_u", "ln_x")
# each split leaf of a block: the dim ``param_spec`` cuts, the leaf's
# width there (a multiple of D or F)
_TMIX_SPLIT = {"w_r": -1, "w_k": -1, "w_v": -1, "w_g": -1, "w_o": -2}
_CMIX_SPLIT = {"cw_k": -1, "cw_r": -1, "cw_v": -2}


def _heads(cfg: ModelConfig):
    K = cfg.ssm_head_dim or 64
    return cfg.d_model // K, K


def _at_use(pl, cfg: ModelConfig, dims) -> dict:
    """A gathered block's leaves whole: each split one all-gathered at its
    use (``common.leaf_at_use``) to its width, D or F (``cw_k``'s columns,
    ``cw_v``'s rows)."""
    def full(k):
        return cfg.d_ff if k in ("cw_k", "cw_v") else cfg.d_model
    return {k: leaf_at_use(v, cfg, dims[k], full(k)) if k in dims else v
            for k, v in pl.items()}


def _local_heads(pl, cfg: ModelConfig):
    """The time mix's leaves on this rank's heads: under the split
    ``tmix`` block the rank's pieces of the replicated ``decay_w0`` /
    ``decay_B`` columns, ``bonus_u`` rows and ``ln_x`` (the heads of its
    ``w_r`` columns); the leaves themselves otherwise."""
    if not split_block(cfg, "tmix"):
        return pl
    K = _heads(cfg)[1]
    n = pl["w_r"].shape[-1]
    cols, heads = rank_cols(cfg, n), rank_cols(cfg, n // K)
    return dict(pl, decay_w0=pl["decay_w0"][cols],
                decay_B=pl["decay_B"][:, cols], bonus_u=pl["bonus_u"][heads],
                ln_x=pl["ln_x"][cols])


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig,
               layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One layer's weights, or with ``layers`` the weights of that many
    layers stacked on a leading axis, drawn straight into that layout
    (each leaf filled slice by slice in its own dtype,
    ``common._fill_normal``). The reference's leaves, shapes and scales:
    ``dense_init`` on ``fan_in`` = the input width."""
    D, F_, dt, dev = cfg.d_model, cfg.d_ff, cfg.dtype, gen.device
    H, K = _heads(cfg)
    lead = () if layers is None else (layers,)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    def dense(shape, scale=1.0):
        return dense_init(gen, lead + shape, dt, scale=scale,
                          fan_in=shape[0])
    return {
        "ln_att": full((D,), 1.0),
        "ln_ffn": full((D,), 1.0),
        "mu_r": full((D,), 0.5),
        "mu_k": full((D,), 0.5),
        "mu_v": full((D,), 0.5),
        "mu_w": full((D,), 0.5),
        "mu_g": full((D,), 0.5),
        "w_r": dense((D, D)),
        "w_k": dense((D, D)),
        "w_v": dense((D, D)),
        "w_g": dense((D, D)),
        "w_o": dense((D, D)),
        "decay_w0": full((D,), -6.0),
        "decay_A": dense((D, LORA_R)),
        "decay_B": dense((LORA_R, D), scale=0.1),
        "bonus_u": full((H, K), 0.0),
        "ln_x": full((D,), 1.0),
        "mu_ck": full((D,), 0.5),
        "mu_cr": full((D,), 0.5),
        "cw_k": dense((D, F_)),
        "cw_v": dense((F_, D)),
        "cw_r": dense((D, D)),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device: embeddings, the layers stacked
    on ``num_layers``, the final norm and the unembedding."""
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype),
        "layers": init_layer(gen, cfg, cfg.num_layers),
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                           device=gen.device),
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype),
    }


# --------------------------------------------------------------------------
# Pieces of a layer
# --------------------------------------------------------------------------
def _log_decay(pl, xw: torch.Tensor) -> torch.Tensor:
    """``log w = -exp(w0 + tanh(xw A) B)``, f32 (the reference's
    ``_decay`` before its outer ``exp``)."""
    z = pl["decay_w0"].float() + torch.tanh(
        xw.float() @ pl["decay_A"].float()) @ pl["decay_B"].float()
    return -torch.exp(z)


def _decay(pl, xw: torch.Tensor) -> torch.Tensor:
    """The decay ``w = exp(-exp(w0 + tanh(xw A) B))`` in f32."""
    return torch.exp(_log_decay(pl, xw))


def _group_norm(x: torch.Tensor, weight: torch.Tensor, H: int, K: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm on [..., H, K] flattened to [..., D], f32."""
    shp = x.shape
    x = x.reshape(shp[:-1] + (H, K)).float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return x.reshape(shp) * weight.float()


def _shift(x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> the previous token's row (zeros at t = 0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix_step(pl, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor, S: torch.Tensor):
    """One token: x, x_prev [B, D]; S [B, H, K, K] f32 (under the split
    ``tmix`` block the rank's heads). Returns (out [B, D] in x's dtype,
    S')."""
    if cfg.tp_axis is not None and not split_block(cfg, "tmix"):
        return time_mix_step(_at_use(pl, cfg, _TMIX_SPLIT), unsplit(cfg), x,
                             x_prev, S)
    pl = _local_heads(pl, cfg)
    K = _heads(cfg)[1]
    B = x.shape[0]
    H = pl["w_r"].shape[-1] // K

    def lerp(mu):
        return x + (x_prev - x) * mu
    r = (lerp(pl["mu_r"]) @ pl["w_r"]).reshape(B, H, K)
    k = (lerp(pl["mu_k"]) @ pl["w_k"]).reshape(B, H, K)
    v = (lerp(pl["mu_v"]) @ pl["w_v"]).reshape(B, H, K)
    g = F.silu(lerp(pl["mu_g"]) @ pl["w_g"])
    w = _decay(pl, lerp(pl["mu_w"])).reshape(B, H, K)
    rf, kf, vf = r.float(), k.float(), v.float()
    u = pl["bonus_u"].float()
    kv = kf[..., :, None] * vf[..., None, :]                  # [B, H, K, K]
    y = torch.einsum("bhk,bhkv->bhv", rf, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    y = _group_norm(y.reshape(B, H * K), pl["ln_x"], H, K)
    return psum_if_tp((y * g.float()) @ pl["w_o"].float(), cfg).to(
        x.dtype), S


# --------------------------------------------------------------------------
# The WKV recurrence over a sequence
# --------------------------------------------------------------------------
def wkv_sequential(r, k, v, w, u, S0):
    """The recurrence token by token (the reference's scan): r, k, v, w
    [B, T, H, K] f32 (``w`` the decay), u [H, K], S0 [B, H, K, K]. Returns
    (y [B, T, H, K], S after the last token), f32."""
    S = S0
    ys = []
    uu = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + uu * kv))
        S = w[:, t, ..., None] * S + kv
    return torch.stack(ys, 1), S


def wkv_chunked(r, k, v, lw, u, S0, chunk: int = WKV_CHUNK):
    """The same recurrence a chunk of ``chunk`` tokens at a time: r, k, v
    [B, T, H, K] f32, ``lw`` = log of the decay (<= 0), u [H, K], S0
    [B, H, K, K]. Returns (y [B, T, H, K], final S), f32.

    Within a chunk, with ``c_i`` the sum of ``lw`` over the chunk's tokens
    up to i and ``e_i = c_{i-1}`` (0 at the chunk start), every decay is
    ``exp`` of a difference of such sums, so every factor is ``exp(sum of
    log w) <= 1`` and nothing is divided by a cumulative product that
    could underflow:

        y_i = (r_i * exp(e_i)) S_start
              + sum_{j<i} [sum_k r_ik k_jk exp(e_ik - c_jk)] v_j
              + (sum_k r_ik u_k k_ik) v_i
        S_end = exp(c_last) * S_start + sum_j (k_j * exp(c_last - c_j)) v_j^T

    The chunks' own terms run for all chunks at once (batched matmuls; the
    pairwise ``exp(e_i - c_j)`` tensor a group of chunks at a time), then a
    scan over chunks carries S. A tail short of a chunk is padded with
    k = v = r = 0 and lw = 0, which leaves y and S unchanged."""
    B, T, H, K = r.shape
    C = chunk
    N = -(-T // C)
    pad = N * C - T

    def chunks(a):
        a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(B, N, C, H, K).permute(0, 3, 1, 2, 4)  # [B,H,N,C,K]
    r, k, v, lw = (chunks(a) for a in (r, k, v, lw))
    c = lw.cumsum(3)                                  # inclusive sums
    e = F.pad(c[:, :, :, :-1], (0, 0, 1, 0))          # exclusive sums
    last = c[:, :, :, -1:]                            # [B, H, N, 1, K]
    # the bonus on the current token
    y = (r * u[None, :, None, None] * k).sum(-1, keepdim=True) * v
    # earlier tokens of the chunk, a group of chunks at a time (joined by
    # one cat: an in-place add into a view of y would differentiate
    # through as_strided, which a fake tensor and a real one count apart)
    below = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    step = max(1, WKV_PAIR_ELEMS // (B * H * C * C * K))
    pairs = []
    for n0 in range(0, N, step):
        sl = slice(n0, n0 + step)
        diff = e[:, :, sl, :, None] - c[:, :, sl, None]    # [.., C, C, K]
        diff = diff.masked_fill(~below[..., None], -math.inf)
        att = torch.einsum("bhnik,bhnijk->bhnij", r[:, :, sl],
                           k[:, :, sl, None] * torch.exp(diff))
        pairs.append(att @ v[:, :, sl])
    y = y + torch.cat(pairs, 2)
    # each chunk's own contribution to the state it passes on
    delta = (k * torch.exp(last - c)).transpose(-1, -2) @ v   # [B,H,N,K,K]
    carry = torch.exp(last).transpose(-1, -2)                 # [B,H,N,K,1]
    starts = []
    S = S0
    for n in range(N):
        starts.append(S)
        S = carry[:, :, n] * S + delta[:, :, n]
    y = y + (r * torch.exp(e)) @ torch.stack(starts, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, K)[:, :T]
    return y, S


def wkv_inputs(pl, cfg: ModelConfig, x: torch.Tensor, x_prev0=None):
    """The sequence's recurrence inputs: x [B, T, D] -> (r, k, v, log w)
    [B, T, H, K] in f32 and the gate g [B, T, D] in x's dtype, every
    token-shift lerp and projection over the whole sequence at once
    (``x_prev0`` [B, D]: the row before x[:, 0], zeros if None). The
    heads are those of ``pl["w_r"]``'s columns: a rank's under the split
    ``tmix`` block (``pl`` from :func:`_local_heads`)."""
    K = _heads(cfg)[1]
    B, T, D = x.shape
    H = pl["w_r"].shape[-1] // K
    xp = _shift(x)
    if x_prev0 is not None:                   # decode-state handoff
        xp[:, 0] = x_prev0

    def lerp(mu):
        return x + (xp - x) * mu
    r = (lerp(pl["mu_r"]) @ pl["w_r"]).reshape(B, T, H, K)
    k = (lerp(pl["mu_k"]) @ pl["w_k"]).reshape(B, T, H, K)
    v = (lerp(pl["mu_v"]) @ pl["w_v"]).reshape(B, T, H, K)
    g = F.silu(lerp(pl["mu_g"]) @ pl["w_g"])
    lw = _log_decay(pl, lerp(pl["mu_w"])).reshape(B, T, H, K)
    return r.float(), k.float(), v.float(), lw, g


def time_mix_seq(pl, cfg: ModelConfig, x: torch.Tensor, S0=None,
                 x_prev0=None, return_state: bool = False,
                 chunk: Optional[int] = None):
    """A whole sequence: x [B, T, D] -> [B, T, D] in x's dtype. The
    token-shift lerps and every projection run over the whole sequence;
    only the WKV recurrence is sequential, or chunked: ``chunk`` tokens at
    a time (0 = token by token; None = ``WKV_CHUNK`` on the card,
    ``common.card_device``, token by token elsewhere, the reference's
    form). ``S0`` [B, H, K, K] and
    ``x_prev0`` [B, D] continue from a decode state; ``return_state``
    adds (S, the last input row) for the decode that follows. Under the
    split ``tmix`` block ``S0`` and the returned S are the rank's heads
    and the output is whole (``w_o``'s all-reduce); under a gathered one
    the leaves are gathered at their use and every head runs here."""
    if cfg.tp_axis is not None and not split_block(cfg, "tmix"):
        return time_mix_seq(_at_use(pl, cfg, _TMIX_SPLIT), unsplit(cfg), x,
                            S0, x_prev0, return_state, chunk)
    K = _heads(cfg)[1]
    B, T, D = x.shape
    pl = _local_heads(pl, cfg)
    H = pl["w_r"].shape[-1] // K
    rf, kf, vf, lw, g = wkv_inputs(pl, cfg, block_in(x, cfg), x_prev0)
    u = pl["bonus_u"].float()
    if S0 is None:
        S0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    if chunk is None:
        chunk = WKV_CHUNK if card_device(x.device) else 0
    if chunk:
        y, S = wkv_chunked(rf, kf, vf, lw, u, S0, chunk)
    else:
        y, S = wkv_sequential(rf, kf, vf, torch.exp(lw), u, S0)
    y = _group_norm(y.reshape(B, T, H * K), pl["ln_x"], H, K)
    out = block_out((y * g.float()) @ pl["w_o"].float(), cfg).to(x.dtype)
    if return_state:
        return out, S, x[:, -1]
    return out


def channel_mix(pl, cfg: ModelConfig, x: torch.Tensor,
                x_prev: torch.Tensor) -> torch.Tensor:
    """x, x_prev [..., D] (x_prev the token-shifted input). Under the
    split ``cmix`` block the rank's ``cw_k`` columns and ``cw_v`` rows
    give a partial ``k @ cw_v`` (all-reduced) and its ``cw_r`` columns
    its columns of the gate (all-gathered): the two lerps run whole and
    enter the rank's products through one ``copy_to_tp``. A gathered
    block gathers its split leaves at their use."""
    if cfg.tp_axis is not None and not split_block(cfg, "cmix"):
        return channel_mix(_at_use(pl, cfg, _CMIX_SPLIT), unsplit(cfg), x,
                           x_prev)
    xk = x + (x_prev - x) * pl["mu_ck"]
    xr = x + (x_prev - x) * pl["mu_cr"]
    if cfg.tp_axis is None:
        k = torch.square(torch.relu(xk @ pl["cw_k"]))
        return torch.sigmoid(xr @ pl["cw_r"]) * (k @ pl["cw_v"])
    xk, xr = copy_to_tp(torch.stack([xk, xr]), cfg).unbind(0)
    k = torch.square(torch.relu(xk @ pl["cw_k"]))
    gate = all_gather(torch.sigmoid(xr @ pl["cw_r"]), cfg.tp_axis, -1)
    return seq_piece(gate, cfg) * block_out(k @ pl["cw_v"], cfg)


def layer_seq(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
    x = x + time_mix_seq(pl, cfg, h)
    h = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
    return x + channel_mix(pl, cfg, h, _shift(h))


def layer_seq_split(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """:func:`layer_seq` on this rank's T / m rows of the residual stream
    (the ``seq_parallel`` lever, ``common.seq_block``): each mix normalises
    the rank's rows and runs on the rows gathered along T, so the token
    shift sees its neighbours. The time mix's input enters through one
    copy; the channel mix lerps its whole input first, so its gather's
    backward takes the rank's rows, and its gate meets the reduce-scattered
    ``k @ cw_v`` on the rank's rows."""
    x = x + seq_block(lambda h, c: time_mix_seq(pl, c, h),
                      rms_norm(x, pl["ln_att"], cfg.norm_eps), cfg, "tmix")
    return x + seq_block(lambda h, c: channel_mix(pl, c, h, _shift(h)),
                         rms_norm(x, pl["ln_ffn"], cfg.norm_eps), cfg,
                         "cmix", enters=False)


def forward_full(p, cfg: ModelConfig, tokens: torch.Tensor,
                 remat: bool = False,
                 gather_logits: bool = True) -> torch.Tensor:
    """Logits [B, T, V] of tokens [B, T]; ``remat`` recomputes each layer
    in backward. Under a group the vocab-split embedding and unembedding
    of ``transformer`` (``gather_logits=False``: this rank's columns, for
    a vocab-parallel loss)."""
    x = embed_tokens(p, cfg, tokens)
    split = seq_layers(cfg)
    if split:           # the residual stream on this rank's T / m rows
        x = seq_slice(x, cfg.tp_axis)
    layer = layer_seq_split if split else layer_seq
    for l in range(cfg.num_layers):
        x = checkpointed(layer, remat, layer_params(p["layers"], l), cfg, x)
    if split:
        x = all_gather(x, cfg.tp_axis, 1)
    return unembed(p, cfg, rms_norm(x, p["ln_f"], cfg.norm_eps),
                   gather_logits)


# --------------------------------------------------------------------------
# Serving: the O(1) recurrent state
# --------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, device="cuda",
               dtype=None, cache_seq=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state of ``batch`` rows: ``S`` [L, batch, H, K, K]
    f32, ``att_prev`` / ``ffn_prev`` [L, batch, D] in ``dtype`` (default
    the model's); under a group this rank's slice of each
    (:func:`state_shapes`)."""
    S, prev = state_shapes(cfg, batch, cache_seq=cache_seq)
    dt = dtype or cfg.dtype
    return {
        "S": torch.zeros(S, dtype=torch.float32, device=device),
        "att_prev": torch.zeros(prev, dtype=dt, device=device),
        "ffn_prev": torch.zeros(prev, dtype=dt, device=device),
    }


def state_shapes(cfg: ModelConfig, batch: int, whole: bool = False,
                 cache_seq=None):
    """The shapes of ``S`` and of ``att_prev`` / ``ffn_prev`` for
    ``batch`` rows: whole without a group (or with ``whole``), else this
    rank's slice in the layout ``launch.shardings.cache_shardings`` gives
    for a cache of ``cache_seq`` rows (``common.state_piece``: ``S`` on
    its heads where they divide the group, else its first key dim; the
    rows on D)."""
    H, K = _heads(cfg)
    L, D = cfg.num_layers, cfg.d_model
    S, prev = (L, batch, H, K, K), (L, batch, D)
    if whole:
        return S, prev
    return (state_piece(cfg, S, cache_seq, 1),
            state_piece(cfg, prev, cache_seq, 1))


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor, state,
                   pos=None, rows: Optional[torch.Tensor] = None):
    """token [B] int -> (logits [B, V], state). ``state`` is updated IN
    PLACE: its rows 0..B-1, or with ``rows`` ([B] int, the state row of
    each token) those rows of a state of any number of rows, so a serving
    slab's live rows decode where they lie. ``pos`` is ignored: the state
    carries the position. Under a group the state is this rank's slice
    (:func:`state_shapes`): the token-shift leaves are gathered at their use
    (one all-gather each, for every layer at once) and the rank writes back its
    columns; ``S`` is the rank's heads under the split ``tmix`` block (the
    layout the rule gives it), else gathered at its use and written back in its
    layout (``common.state_in`` / ``state_out``)."""
    x = embed_tokens(p, cfg, token)
    idx = None if rows is None else rows.long()
    S_whole, P_whole = state_shapes(cfg, state["S"].shape[1], whole=True)
    S_want = list(S_whole)
    if cfg.tp_axis is not None and split_block(cfg, "tmix"):
        S_want[2] //= cfg.tp_axis.size
    work = {"S": state_in(state["S"], cfg, S_whole, S_want)}
    for n in ("att_prev", "ffn_prev"):
        work[n] = state_in(state[n], cfg, P_whole, P_whole)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        S_l, ap_l, fp_l = (work[n][l] for n in ("S", "att_prev",
                                                 "ffn_prev"))
        if idx is None:
            S, a_prev, f_prev = S_l, ap_l, fp_l
        else:
            S, a_prev, f_prev = (a.index_select(0, idx)
                                 for a in (S_l, ap_l, fp_l))
        h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
        y, S = time_mix_step(pl, cfg, h, a_prev, S)
        x = x + y
        h2 = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
        x = x + channel_mix(pl, cfg, h2, f_prev)
        for dst, src in ((S_l, S), (ap_l, h), (fp_l, h2)):
            if idx is None:
                dst.copy_(src)
            else:
                dst.index_copy_(0, idx, src.to(dst.dtype))
    for n, whole in (("S", S_whole), ("att_prev", P_whole),
                     ("ffn_prev", P_whole)):
        state_out(state[n], work[n], cfg, whole)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x), state


def prefill(p, cfg: ModelConfig, tokens: torch.Tensor, cache_len=None):
    """Run the prompt tokens [B, T]; returns (last-token logits [B, V], the
    decode state). The state's size does not depend on the length, as in
    the reference. Under a group the state is this rank's slice
    (:func:`state_shapes`), laid out for a cache of ``cache_len`` rows
    (default T): the rule that lays a decode state out skips a dim of
    the cache's length."""
    x = embed_tokens(p, cfg, tokens)
    state = init_state(cfg, tokens.shape[0], device=x.device, dtype=x.dtype,
                       cache_seq=cache_len or tokens.shape[1])
    S_whole, P_whole = state_shapes(cfg, tokens.shape[0], whole=True)
    wholes = {"S": S_whole, "att_prev": P_whole, "ffn_prev": P_whole}
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
        y, S, att_prev = time_mix_seq(pl, cfg, h, return_state=True)
        x = x + y
        h2 = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
        x = x + channel_mix(pl, cfg, h2, _shift(h2))
        for name, src in (("S", S), ("att_prev", att_prev),
                          ("ffn_prev", h2[:, -1])):
            state_out(state[name][l], src, cfg, wholes[name][1:])
    x = rms_norm(x[:, -1], p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x), state
