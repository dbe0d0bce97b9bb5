"""Ground-truth hardware cost model for the simulator — the port's copy
of ``repro.sim.costmodel``, priced on a :class:`~repro_torch.kernels.cost.
Chip` (default :data:`~repro_torch.kernels.cost.H100`).

Iteration latency of a simulated instance, derived from the attention
kernels' block model (``repro_torch.kernels.cost``) plus weight-access and
per-token terms:

  decode iteration:  t_weights + n·t_tok + attn(lengths)        (memory-bound)
  prefill:           t_weights share + 2·N·I/peak + I² attention (compute-bound)

``attn(lengths)`` carries the heterogeneity tax: a padded backend pays
ceil(maxL/BS) KV blocks for *every* request. This is the physics that the
QoE model (deliberately) does not see and that CascadeInfer's scheduling
exploits — mirroring the paper's fitted-model vs. real-GPU separation.

``peak``, ``hbm`` and ``t_fixed`` come from the chip; per-model terms
from the arch configs. Every formula keeps the reference's order of
operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.kernels.cost import (H100, AttnSpec, Chip,
                                      allreduce_time_s, decode_attn_time_s,
                                      h2d_block_time_s, kv_bytes_per_elem,
                                      mixed_iter_time_s, prefill_flops)
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    attn_spec: AttnSpec
    params: float                  # parameter count (active for MoE)
    params_total: float            # full parameter count (weight streaming)
    kv_bytes_per_token: float      # all layers, K+V
    num_layers: int
    t_fixed: float = H100.t_fixed_s  # per-iteration framework overhead
    weight_bytes: float = 0.0      # bf16 weights
    peak: float = H100.peak_flops
    hbm: float = H100.hbm_bw
    attn_frac: float = 1.0         # hybrid archs: fraction of layers w/ attn
    ragged_backend: bool = False   # beyond-paper kernel flag
    fused_backend: bool = False    # ONE-launch fused mixed iterations
    kv_dtype: str = "bf16"         # bf16 | int8 block pool
    # tensor parallelism (DESIGN.md §Sharded serving): chips this instance
    # spans. Per-chip terms above are already divided by it; the iteration
    # models add the ring-all-reduce collectives it costs (needs d_model).
    num_devices: int = 1
    d_model: int = 0

    @property
    def chip(self) -> Chip:
        """The chip whose link and host-staging constants price this
        profile's collectives and host-tier copies."""
        return self.attn_spec.chip

    @property
    def t_weights(self) -> float:
        """Weight-streaming floor of one decode iteration (memory-bound)."""
        return self.weight_bytes / self.hbm

    def t_collective(self, n_tokens: float) -> float:
        """Per-iteration tensor-parallel collective time: two psums per
        layer (attention wo + FFN down projections) of an
        [n_tokens, d_model] bf16 activation over the instance's chips.
        Zero at num_devices == 1 — untouched single-chip parity."""
        payload = 2.0 * self.num_layers * float(n_tokens) * self.d_model * 2.0
        return allreduce_time_s(payload, self.num_devices, chip=self.chip)


def profile_from_config(cfg: ModelConfig, *, chip: Chip = H100,
                        tp: int = 1,
                        ragged_backend: bool = False,
                        fused_backend: bool = False,
                        kv_dtype: str = "bf16") -> HardwareProfile:
    """Build a per-instance hardware profile of ``chip`` from a model
    config: the chip gives ``peak``, ``hbm``, ``t_fixed`` and the
    attention spec's block and constants.
    ``tp``: tensor-parallel ways (DESIGN.md §Sharded serving) — divides
    weights + KV per chip AND the attention grid's head counts (each
    shard owns H/tp q heads over Hkv/tp kv heads, so the GQA ratio and
    per-block time are unchanged while the per-chip grid shrinks tp×);
    the iteration models then add the 2-psum/layer collective term.
    ``kv_dtype="int8"`` prices the quantized block pool — per-token KV
    bytes (and so block bytes / capacity) shrink by ``(Dh+4)/(2·Dh)``,
    and every attention DMA term moves the smaller bytes."""
    d, L = cfg.d_model, cfg.num_layers
    if cfg.num_experts:
        ffn_p = 3 * d * cfg.d_ff
        dense_p = ffn_p * (cfg.num_experts + (1 if cfg.dense_residual else 0))
        active_p = ffn_p * (cfg.experts_per_token
                            + (1 if cfg.dense_residual else 0))
    else:
        mult = 3 if cfg.act == "swiglu" else 2
        dense_p = active_p = mult * d * cfg.d_ff
    if cfg.num_heads:
        attn_p = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
            + cfg.num_heads * cfg.head_dim * d
        kv_elem = kv_bytes_per_elem(kv_dtype, cfg.head_dim)
        spec = AttnSpec(max(cfg.num_heads // tp, 1),
                        max(cfg.num_kv_heads // tp, 1), cfg.head_dim,
                        kv_bytes=kv_elem, chip=chip)
        kv_tok = 2 * cfg.num_kv_heads * cfg.head_dim * kv_elem  # K+V
        attn_layers = (L // cfg.attn_every) if cfg.attn_every else L
    else:  # attention-free (rwkv): state is O(1); no per-token KV
        attn_p = 4 * d * d
        spec = AttnSpec(1, 1, 128, chip=chip)
        kv_tok = 0.0
        attn_layers = 0
    embed_p = 2 * cfg.vocab_size * d
    n_total = L * (attn_p + dense_p) + embed_p
    n_active = L * (attn_p + active_p) + embed_p
    return HardwareProfile(
        attn_spec=spec,
        params=n_active / tp,
        params_total=n_total / tp,
        kv_bytes_per_token=kv_tok * attn_layers / tp,
        num_layers=L,
        t_fixed=chip.t_fixed_s,
        weight_bytes=2.0 * n_total / tp,
        peak=chip.peak_flops,
        hbm=chip.hbm_bw,
        attn_frac=attn_layers / max(L, 1),
        ragged_backend=ragged_backend,
        fused_backend=fused_backend,
        kv_dtype=kv_dtype,
        num_devices=tp,
        d_model=d,
    )


def scale_profile_tp(prof: HardwareProfile, tp: int) -> HardwareProfile:
    """Re-shard a single-chip profile across ``tp`` chips (DESIGN.md
    §Sharded serving): per-chip weights/KV shrink tp×, the attention grid
    keeps H/tp q heads over Hkv/tp kv heads (GQA ratio unchanged), and
    ``num_devices`` turns on the collective term. ``tp <= 1`` returns the
    profile unchanged, so homogeneous clusters are bit-identical."""
    if tp <= 1:
        return prof
    spec = prof.attn_spec
    return dataclasses.replace(
        prof,
        attn_spec=dataclasses.replace(
            spec,
            num_q_heads=max(spec.num_q_heads // tp, 1),
            num_kv_heads=max(spec.num_kv_heads // tp, 1)),
        params=prof.params / tp,
        params_total=prof.params_total / tp,
        kv_bytes_per_token=prof.kv_bytes_per_token / tp,
        weight_bytes=prof.weight_bytes / tp,
        num_devices=tp,
    )


def decode_iter_time(lengths: Sequence[int], prof: HardwareProfile) -> float:
    """One continuous-batching decode iteration over ``lengths``."""
    n = len(lengths)
    if n == 0:
        return 0.0
    t_tok = 2.0 * prof.params / prof.peak                 # per-request tensor-core time
    attn_layers = round(prof.num_layers * prof.attn_frac)
    t_attn = (decode_attn_time_s(lengths, prof.attn_spec,
                                 ragged=prof.ragged_backend) * attn_layers
              if attn_layers else 0.0)
    return (prof.t_fixed + prof.t_weights + n * t_tok + t_attn
            + prof.t_collective(n))


def prefill_time(input_len: int, prof: HardwareProfile,
                 cached_tokens: int = 0) -> float:
    """Monolithic prefill iteration for one whole prompt (compute-bound).
    The quadratic attention term comes from the kernel-level chunk mirror
    (``kernels.cost.prefill_chunk_flops`` with the prompt as one chunk ≈
    the old 2·H·Dh·I² causal count) — one formula prices every prefill
    granularity. ``cached_tokens`` prompt tokens served from the prefix
    cache (DESIGN.md §Prefix cache) never run: linear work covers only
    the uncached tail and the attention term is the tail-against-cached-
    context chunk count."""
    cached = min(int(cached_tokens), max(int(input_len) - 1, 0))
    I = float(input_len) - cached
    t_linear = 2.0 * prof.params * I / prof.peak
    attn_layers = round(prof.num_layers * prof.attn_frac)
    t_quad = (prefill_flops(int(input_len), prof.attn_spec, cached)
              * attn_layers / prof.peak)
    return prof.t_fixed + t_linear + t_quad + prof.t_collective(I)


def mixed_iter_time(chunks: Sequence, decode_lengths: Sequence[int],
                    prof: HardwareProfile) -> float:
    """One token-budgeted MIXED iteration (DESIGN.md §Chunked prefill):
    the full decode batch over ``decode_lengths`` advances one token while
    ``chunks`` — (chunk_len, ctx_len) prompt slices — prefill beside it.
    Linear (weight) work scales with decode batch + chunk tokens; the
    attention terms are the kernel mirrors (paged chunked prefill + the
    SAME decode backend ``decode_iter_time`` prices, per
    ``prof.ragged_backend`` — so chunked-vs-monolithic runs differ only
    in prefill scheduling, never in the decode kernel model). This
    replaces the dedicated-prefill-iteration model wherever the instance
    runs the chunked scheduler."""
    n = len(decode_lengths)
    if n == 0 and not chunks:
        return 0.0
    t_tok = 2.0 * prof.params / prof.peak                 # per-request tensor-core time
    chunk_toks = sum(int(c) for c, _ in chunks)
    t_linear = 2.0 * prof.params * chunk_toks / prof.peak
    attn_layers = round(prof.num_layers * prof.attn_frac)
    backend = ("fused" if prof.fused_backend
               else "ragged" if prof.ragged_backend else "padded")
    t_attn = (mixed_iter_time_s(chunks, decode_lengths, prof.attn_spec,
                                decode_backend=backend)
              * attn_layers if attn_layers else 0.0)
    return (prof.t_fixed + prof.t_weights + n * t_tok + t_linear + t_attn
            + prof.t_collective(n + chunk_toks))


def kv_block_bytes(prof: HardwareProfile, block_size: int) -> float:
    """Bytes of one paged-cache block (all layers, K+V) — the allocation
    unit the serving engine's BlockAllocator hands out; capacity planning
    and migration volume accounting are multiples of this."""
    return prof.kv_bytes_per_token * block_size


def promote_time(n_blocks: int, prof: HardwareProfile,
                 block_size: int) -> float:
    """Host→device staging time for ``n_blocks`` promoted KV blocks
    (DESIGN.md §Multi-tier KV): per-block launch overhead + bytes over
    the host staging link — the same ``kernels.cost.h2d_block_time_s``
    the engine's promote pricing uses, applied to this profile's block
    bytes. This is what a host-tier prefix hit costs the admission
    iteration (the truly-uncached tail still prefills on top)."""
    if n_blocks <= 0:
        return 0.0
    return n_blocks * h2d_block_time_s(kv_block_bytes(prof, block_size),
                                       chip=prof.chip)


def demote_time(n_blocks: int, prof: HardwareProfile,
                block_size: int) -> float:
    """Device→host flush time for ``n_blocks`` demoted KV blocks. The
    engine stages demotes asynchronously (the device-side snapshot
    overlaps the running iteration) but the host-side flush still
    occupies the step's wall clock — priced symmetrically to
    :func:`promote_time` over the same staging link."""
    if n_blocks <= 0:
        return 0.0
    return n_blocks * h2d_block_time_s(kv_block_bytes(prof, block_size),
                                       chip=prof.chip)


def capacity_blocks(hbm_bytes_free: float, prof: HardwareProfile,
                    block_size: int) -> int:
    """How many KV blocks fit in the HBM left after weights — the paged
    engine's ``num_blocks`` for a given chip."""
    bb = kv_block_bytes(prof, block_size)
    return int(hbm_bytes_free // max(bb, 1e-9))


def decode_rate(lengths: Sequence[int], prof: HardwareProfile) -> float:
    """Tokens/s one request sees inside the current batch (for live-
    migration round planning)."""
    t = decode_iter_time(lengths, prof)
    return 1.0 / max(t, 1e-9)
