"""Block-level cost model of the port's attention kernels on an NVIDIA
H100 — the port's copy of ``repro.kernels.cost`` with its constants taken
out of the formulas and into a :class:`Chip`.

This is the analytic bridge between the kernels and the rest of the
system: the simulator's ground-truth iteration cost is built from it, the
engine's routing price of host-tier prefix hits and the bucketing policy
of table widths and chunks come from here, and Fig. 2's heterogeneity tax
reads straight off these terms.

Model (per decode iteration, per device):
  padded backend:  blocks(b) = ceil(S_pad / BS) for every request
  ragged backend:  blocks(b) = ceil(L_b / BS) compute + skip-overhead

Each KV block of ``BS = chip.attn_block`` keys costs ``2·BS·Dh·bytes /
hbm_bw`` of memory traffic (K and V) and ``2·2·G·BS·Dh / peak_flops`` of
tensor-core time; decode attention has arithmetic intensity ≈ G, far
below the ridge point, so a block's time is max(bytes, flops) ≈ bytes —
which is why wasted *padded* blocks cost exactly in proportion to their
count.

Every formula keeps the reference's order of operations, so a
:class:`Chip` holding the reference's constants prices every call exactly
as the reference does; :data:`H100` is the port's own chip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# routing price of one host-tier cached token: the h2d copy is ~4x cheaper
# than recomputing the token's prefill, so a host hit is priced as a
# quarter-length prompt tail
PROMOTE_TOKEN_COST = 0.25


@dataclasses.dataclass(frozen=True)
class Chip:
    """The device constants the cost model prices with (frozen, so it
    hashes: ``sim.experiment.fitted_qoe`` caches on it).

    ``peak_flops`` dense bf16 tensor-core FLOP/s; ``hbm_bw`` device memory
    bytes/s; ``link_bw`` bytes/s a direction on the device-to-device link
    that tensor parallelism's all-reduce rides; ``launch_overhead_s`` the
    device time one extra kernel launch adds; ``skip_overhead_s`` the time
    one padding item of a kernel's work list adds per kv head;
    ``host_staging_bw`` and ``staging_overhead_s`` the host-tier copy of
    one KV block (``staging_overhead_s + bytes / host_staging_bw``);
    ``attn_block`` the keys of one block of the attention model;
    ``t_fixed_s`` the per-iteration time outside the priced terms."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    launch_overhead_s: float
    skip_overhead_s: float
    host_staging_bw: float
    staging_overhead_s: float
    attn_block: int
    t_fixed_s: float


# NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power limit (nvidia-smi:
# "NVIDIA H100 80GB HBM3, 700.00 W"). peak_flops, hbm_bw and link_bw are
# published figures; the rest were measured on that card by phase 15 of
# chip_smoke.py (tools/calibrate_h100.py) with llama3.2-3b at full width,
# bf16, block size 16, torch 2.11.0+cu128:
H100 = Chip(
    name="NVIDIA H100 80GB HBM3",
    # published: dense bf16 tensor cores, 989 TFLOP/s (the bound of every
    # kernel in chip_smoke.py phase 3)
    peak_flops=989e12,
    # published: 3.35 TB/s HBM3
    hbm_bw=3.35e12,
    # published: NVLink 4, 900 GB/s both directions together, so 450 GB/s
    # a direction; the card's machine shows one device, so not measured
    link_bw=450e9,
    # measured: 200 back-to-back launches of the fused kernel (#1) on 8
    # decode rows of 512 tokens, queued behind a sleep kernel: CUDA events
    # over the launches (17.028 us a call) less the kernel's device time
    # from torch.profiler (16.108 us), a launch
    launch_overhead_s=9.193e-7,
    # measured: #1 on those rows with its pow2 block table 32 -> 128
    # entries wide (the split plan walks the padding as empty splits):
    # the time added (0.205 us a call) over the padded attn_block-key
    # items per kv head; 32 -> 64 added nothing above the noise
    skip_overhead_s=1.332e-10,
    # measured: one pinned host <-> device copy of 1..32 llama3.2-3b KV
    # blocks (16 x 114,688 B = 1.835 MB each), both directions, least
    # squares of time on bytes: 1 / slope and intercept (h2d 54.88 GB/s,
    # d2h 55.22 GB/s)
    host_staging_bw=55.052e9,
    staging_overhead_s=1.5651e-5,
    # read from the sources: the tensor-core walk's 64-key K/V tile
    # (csrc/tc_walk.cuh kN), the unit of the chunk rows' causal pruning
    # and of the prompt walk; split_decode.cuh's decode rows stream 32-key
    # tiles, which the model's bytes term prices the same per key
    attn_block=64,
    # measured: the intercept of the least-squares line of device busy
    # time (torch.profiler) per engine step on the model's prediction
    # without t_fixed, over phase 15's 12 decode, mixed and prefill steps
    # (slope 1.964); device time only: the host's dispatch gap (30.7 ms a
    # step on average) is not in it
    t_fixed_s=3.3406e-3,
)


def h2d_block_time_s(block_bytes: float, *, chip: Chip = H100) -> float:
    """Wall time to stage ONE KV block across the host link (either
    direction — demote d2h and promote h2d ride the same staging path):
    a per-copy overhead plus the payload at staging bandwidth."""
    return chip.staging_overhead_s + float(block_bytes) / chip.host_staging_bw


def promote_cost_tokens(n_blocks: int, block_size: int) -> float:
    """Token-equivalent ROUTING price of promoting ``n_blocks`` host-tier
    blocks: a host hit is cheaper than recompute but not free, so routing
    charges ``uncached_tail + this`` instead of treating it like a device
    hit. Pure, so the server, the simulator and the reference price a
    hint identically (``Engine.prefix_hint`` reports the host-tier blocks
    of a hit)."""
    return PROMOTE_TOKEN_COST * float(n_blocks) * float(block_size)


def kv_bytes_per_elem(kv_dtype: str, head_dim: int) -> float:
    """Device bytes per stored KV element. int8 carries one f32 scale per
    (position, kv-head) row amortized over the head dim — ``(Dh + 4)/Dh``
    bytes, about 1.94x denser than bf16 at Dh = 128."""
    if kv_dtype == "int8":
        return 1.0 + 4.0 / head_dim
    assert kv_dtype == "bf16", kv_dtype
    return 2.0


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """One attention layer's shape on a chip; ``block_s`` defaults to the
    chip's ``attn_block``."""
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    kv_bytes: float = 2.0      # bf16 cache; kv_bytes_per_elem for int8
    block_s: Optional[int] = None
    chip: Chip = H100

    def __post_init__(self):
        if self.block_s is None:
            object.__setattr__(self, "block_s", self.chip.attn_block)


def block_time_s(spec: AttnSpec) -> float:
    """Time of one (kv-head, kv-block) work item."""
    g = spec.num_q_heads // spec.num_kv_heads
    dma = 2 * spec.block_s * spec.head_dim * spec.kv_bytes / spec.chip.hbm_bw
    mxu = 2 * 2 * g * spec.block_s * spec.head_dim / spec.chip.peak_flops
    return max(dma, mxu)


def padded_blocks(lengths: Sequence[int], block_s: int,
                  pad_to: int | None = None) -> int:
    """Blocks a padded (paper-faithful) backend executes per kv head."""
    if not len(lengths):
        return 0
    s_pad = pad_to if pad_to is not None else max(lengths)
    return len(lengths) * math.ceil(max(s_pad, 1) / block_s)


def ragged_blocks(lengths: Sequence[int], block_s: int) -> int:
    """Compute blocks a ragged backend executes per kv head."""
    return sum(math.ceil(max(l, 1) / block_s) for l in lengths)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (bucketing policy shared by the flat
    work list, the engine's table width, and prefill prompt padding)."""
    p = 1
    while p < n:
        p *= 2
    return p


def flat_grid_blocks(lengths: Sequence[int], block_s: int,
                     bucketed: bool = True) -> int:
    """Work items the work-flattened backend executes per kv head: the
    real Σ_b ceil(L_b/BS) items, padded to a pow2 bucket (padding items
    skip compute but still take a step — ``skip_overhead_s`` — bounded
    at < 2x by the bucketing)."""
    n = ragged_blocks(lengths, block_s)
    return pow2_bucket(n) if (bucketed and n) else n


def decode_attn_time_flat_s(lengths: Sequence[int], spec: AttnSpec) -> float:
    """Decode-attention time of the work-flattened list: unlike a (B, Hkv,
    NBT) grid, no request pays another's block count — the only overhead
    is the pow2 bucket's padding tail."""
    if not len(lengths):
        return 0.0
    comp = ragged_blocks(lengths, spec.block_s)
    skipped = flat_grid_blocks(lengths, spec.block_s) - comp
    return spec.num_kv_heads * (comp * block_time_s(spec)
                                + skipped * spec.chip.skip_overhead_s)


def decode_attn_time_s(lengths: Sequence[int], spec: AttnSpec,
                       ragged: bool = False,
                       pad_to: int | None = None) -> float:
    """Decode-attention time for one iteration over a batch."""
    if not len(lengths):
        return 0.0
    t_blk = block_time_s(spec)
    full = padded_blocks(lengths, spec.block_s, pad_to)
    if not ragged:
        return spec.num_kv_heads * full * t_blk
    comp = ragged_blocks(lengths, spec.block_s)
    skipped = full - comp
    return spec.num_kv_heads * (comp * t_blk
                                + skipped * spec.chip.skip_overhead_s)


# --------------------------------------------------------------------------
# Chunked prefill + mixed iterations — the analytic mirror of the chunked
# prefill kernel and the engine's token-budgeted mixed step; sim/costmodel
# builds its ground truth from these.
# --------------------------------------------------------------------------
def prefill_chunk_blocks(chunk: int, ctx: int, block_s: int) -> int:
    """Blocks (per kv head) the chunked-prefill kernel walks for one
    chunk: every block of the written context plus the chunk itself."""
    return math.ceil(max(ctx + chunk, 1) / block_s)


def prefill_chunk_flops(chunk: int, ctx: int, spec: AttnSpec) -> float:
    """Attention FLOPs of ONE prompt chunk at one layer: score + PV
    products of ``chunk`` queries against the written context plus the
    (block-causally pruned) own chunk. Summing over a prompt's chunks
    recovers the causal whole-prompt count ≈ 2·H·Dh·I², so a single
    chunk=I call prices the monolithic prefill too."""
    own = (chunk + spec.block_s) / 2.0        # causal prune within the chunk
    return 4.0 * spec.num_q_heads * spec.head_dim * chunk * (ctx + own)


def prefill_flops(input_len: int, spec: AttnSpec,
                  cached_tokens: int = 0) -> float:
    """Attention FLOPs one layer spends prefilling a prompt of which
    ``cached_tokens`` leading tokens are already resident in the prefix
    cache: only the uncached tail runs, as one logical chunk attending to
    the cached context plus itself. With ``cached_tokens=0`` this is the
    whole-prompt causal count."""
    cached = min(int(cached_tokens), max(int(input_len) - 1, 0))
    return prefill_chunk_flops(int(input_len) - cached, cached, spec)


def prefill_flops_skipped(input_len: int, cached_tokens: int,
                          spec: AttnSpec) -> float:
    """FLOPs a warm prefill never runs vs. a cold one."""
    return (prefill_flops(input_len, spec)
            - prefill_flops(input_len, spec, cached_tokens))


def prefill_chunk_attn_time_s(chunk: int, ctx: int, spec: AttnSpec) -> float:
    """Time of one chunk's paged-prefill attention: the context blocks'
    bytes (per kv head) vs. the chunk's tensor-core time — compute-bound
    for real chunk sizes, memory-bound when a tiny chunk drags a huge
    context (which is why the engine packs chunks to a budget)."""
    blocks = prefill_chunk_blocks(chunk, ctx, spec.block_s)
    dma = (spec.num_kv_heads * blocks
           * 2 * spec.block_s * spec.head_dim * spec.kv_bytes
           / spec.chip.hbm_bw)
    mxu = prefill_chunk_flops(chunk, ctx, spec) / spec.chip.peak_flops
    return max(dma, mxu)


def fused_grid_items(chunks: Sequence[tuple], decode_lengths: Sequence[int],
                     block_s: int) -> int:
    """Work items (per kv head) of the FUSED mixed-iteration work list:
    pow2 bucket of the decode rows' real blocks PLUS pow2 bucket of the
    chunk blocks (the two halves are bucketed apart, so fusing pays the
    same padding tail as the two kernels it replaces and saves exactly
    the extra launch)."""
    dec = ragged_blocks(decode_lengths, block_s)
    ck = sum(prefill_chunk_blocks(int(c), int(x), block_s)
             for c, x in chunks)
    return ((pow2_bucket(dec) if dec else 0)
            + (pow2_bucket(ck) if ck else 0))


def mixed_iter_time_s(chunks: Sequence[tuple], decode_lengths: Sequence[int],
                      spec: AttnSpec, *,
                      decode_backend: str = "flat") -> float:
    """Attention time of one token-budgeted MIXED iteration: the decode
    batch plus every packed prompt chunk ``(chunk_len, ctx_len)``.
    ``decode_backend`` picks the decode term's kernel model (``fused`` |
    ``flat`` | ``ragged`` | ``padded``).

    ``fused`` prices the single tagged work list: one launch carrying the
    same decode + chunk padding tails the separate kernels pad. The
    separate backends pay the chunk list's own padding tail PLUS the
    extra chunk-batch launch (``chip.launch_overhead_s``)."""
    if decode_backend == "fused":
        comp_dec = ragged_blocks(decode_lengths, spec.block_s)
        comp_ck = sum(prefill_chunk_blocks(int(c), int(x), spec.block_s)
                      for c, x in chunks)
        skipped = max(fused_grid_items(chunks, decode_lengths, spec.block_s)
                      - comp_dec - comp_ck, 0)
        t = spec.num_kv_heads * (comp_dec * block_time_s(spec)
                                 + skipped * spec.chip.skip_overhead_s)
        for chunk, ctx in chunks:
            t += prefill_chunk_attn_time_s(int(chunk), int(ctx), spec)
        return t
    if decode_backend == "flat":
        t = decode_attn_time_flat_s(decode_lengths, spec)
    else:
        t = decode_attn_time_s(decode_lengths, spec,
                               ragged=(decode_backend == "ragged"))
    for chunk, ctx in chunks:
        t += prefill_chunk_attn_time_s(int(chunk), int(ctx), spec)
    if len(chunks):
        ck = sum(prefill_chunk_blocks(int(c), int(x), spec.block_s)
                 for c, x in chunks)
        skipped_ck = pow2_bucket(ck) - ck
        t += (spec.num_kv_heads * skipped_ck * spec.chip.skip_overhead_s
              + spec.chip.launch_overhead_s)  # the separate chunk launch
    return t


def allreduce_time_s(payload_bytes: float, num_devices: int, *,
                     chip: Chip = H100) -> float:
    """Ring all-reduce time over ``num_devices`` devices on the chip's
    link: each moves ``2·(n-1)/n`` of the payload through one link
    (reduce-scatter + all-gather). n <= 1 is free — the tensor-parallel
    cost terms call this unconditionally."""
    n = int(num_devices)
    if n <= 1 or payload_bytes <= 0:
        return 0.0
    return 2.0 * (n - 1) / n * float(payload_bytes) / chip.link_bw


def heterogeneity_tax(lengths: Sequence[int], spec: AttnSpec) -> float:
    """Padded-backend time of a batch over that of a length-homogeneous
    batch with the same total token count (the paper's Fig.-2 metric)."""
    if not len(lengths):
        return 0.0
    hetero = decode_attn_time_s(lengths, spec, ragged=False)
    mean = sum(lengths) / len(lengths)
    homog = decode_attn_time_s([mean] * len(lengths), spec, ragged=False)
    return hetero / max(homog, 1e-12)
