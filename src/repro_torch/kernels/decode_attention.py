"""Decode attention kernels: the ``flat`` and ``grid`` backends' paged
decode, and flash-decode over contiguous caches.

Replaces three TPU kernels of ``repro/kernels/decode_attention.py`` with
CUDA kernels written for Hopper, built and loaded by
:mod:`repro_torch.kernels.build`:

* ``paged_decode_attention_flat`` (``_flat_paged_kernel``) →
  ``csrc/decode_attention.cu``'s flat kernel: the sequential flat work
  list recast for parallel thread blocks (runs of ``ITEMS_PER_RUN``
  consecutive items, a request's parts merged by the last to finish, one
  launch).
* ``paged_decode_attention`` (``_paged_decode_kernel``) → the same
  source's grid kernel: split-KV, each (request, kv head) cut into splits
  of ``P`` table entries (:func:`grid_split_plan`), then merged by the
  last split to finish.
* ``decode_attention`` (``_decode_kernel``) → ``csrc/contiguous_decode.cu``,
  padded or ragged over contiguous ``[B, S, Hkv, Dh]`` caches, split as
  :func:`contiguous_split_plan` says.

All three walk their keys on ``csrc/split_decode.cuh``'s tile: a cp.async
ring of 32-key tiles, f32 math on the CUDA cores.

Each source's header says what bounds it on the card (the bytes of K/V
read) and what its design does about that.

Each wrapper launches its kernel for CUDA tensors — or raises; it never
falls back — and runs its plain PyTorch version (``*_plain``) only for
tensors on the CPU. The contiguous one launches through the operator
``repro_torch::contiguous_decode`` (``kernels.ops.LIBRARY``). Launches
are counted per kernel, one per call: ``LAUNCHES`` (flat),
``GRID_LAUNCHES``, ``PADDED_LAUNCHES`` and ``RAGGED_LAUNCHES``.

Paged semantics (those of ``_flat_paged_kernel`` and
``_paged_decode_kernel``): request ``b`` attends its one query token,
query head ``h`` reading kv head ``h // G``, to keys ``idx < lengths[b]``.
A dead slot (length 0) does no work; the TPU leaves its row unwritten
(flat) or writes zeros (grid), the port writes zeros for both. Table
entries past ``ceil(L_b/BS)`` are never read.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.mixed_attention import paged_mixed_attention_plain
from repro_torch.kernels.ops import (LIBRARY, NEG_INF,
                                     check_paged_operands, flat_work_list)

# kernel launches by this process (CUDA path only)
LAUNCHES = 0          # flat
GRID_LAUNCHES = 0     # grid
PADDED_LAUNCHES = 0   # contiguous, ragged=False
RAGGED_LAUNCHES = 0   # contiguous, ragged=True

# consecutive work items (request, logical block) one thread block walks
ITEMS_PER_RUN = 8
# split plans: blocks one long row alone should give each SM, and the
# fewest keys a split walks (below that a block's set-up outweighs its tiles)
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MIN_KEYS = 64
MAX_SPLITS = 256      # the merge keeps S x G (m, l) in shared memory
TILE_KEYS = 32        # keys of one tile of the split-KV ring
# contiguous decode: blocks of its 3-stage tile one SM holds (bf16, Dh 128,
# G <= 4), the wave its split plan fills
CONTIG_BLOCKS_PER_SM = 4
_MAX_GROUP = 16       # query heads per kv head the kernel's row tile holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_BLOCK = 512   # contiguous decode's default block_s, as the TPU's


def paged_decode_attention_flat(q, k_pool, v_pool, block_tables, lengths,
                                *, num_work: Optional[int] = None,
                                work_list=None):
    """Decode GQA attention over a paged KV pool, by flat work list.

    q            [B, H, Dh]        — one query token per request
    k/v_pool     [NB, BS, Hkv, Dh] — one layer's block pool
    block_tables [B, NBT] int32    — covering ceil(lengths/BS) entries
    lengths      [B] int32         — valid tokens (pos + 1; 0 = dead slot)
    num_work     — static bucket >= Σ_b ceil(lengths_b/BS) work items
                   (None: the worst case B·NBT)
    work_list    — ``flat_work_list(lengths, NBT, BS, num_work)`` when the
                   caller has it: every layer of a decode forward shares
                   one (its ~25 small torch ops cost more host time than
                   the kernel takes on the card); None builds it here
    returns      [B, H, Dh] in q's dtype; dead slots are zeros
    """
    if q.device.type == "cpu":
        return paged_decode_attention_flat_plain(q, k_pool, v_pool,
                                                 block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_flat: no kernel for "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, block_tables, lengths, num_work,
                   work_list)


def _launch(q, k_pool, v_pool, block_tables, lengths, num_work, work_list):
    global LAUNCHES
    name = "paged_decode_attention_flat"
    if q.dim() != 3:
        raise ValueError(f"{name}: q is [B, H, Dh], got {tuple(q.shape)}")
    check_paged_operands(name, q, k_pool, v_pool, block_tables, (lengths,),
                         max_group=_MAX_GROUP)
    B, H, Dh = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    NBT = block_tables.shape[1]
    W = num_work if num_work is not None else B * NBT
    out = torch.empty_like(q)
    if B == 0:
        return out
    if W < 1:
        raise ValueError(f"{name}: num_work {W} < 1")
    if work_list is None:
        work_list = flat_work_list(lengths, NBT, BS, W)
    work_req, work_blk = work_list
    if tuple(work_req.shape) != (W,) or tuple(work_blk.shape) != (W,):
        raise ValueError(f"{name}: work list of {tuple(work_req.shape)} "
                         f"items for num_work {W}")
    # partial acc [W * Hkv * G, Dh] then (m, l) [W * Hkv * G, 2], one buffer
    rows = W * H
    part = torch.empty(rows * (Dh + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.entry("decode_attention", "repro_decode_attention_flat",
                         11, 9)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(),
                work_req.data_ptr(), work_blk.data_ptr(), part.data_ptr(),
                part.data_ptr() + rows * Dh * 4,
                arrival_counts(q.device, stream, B * Hkv).data_ptr(),
                out.data_ptr(), B, H, Hkv, Dh, BS, NBT, W,
                items_per_run(NBT), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed (cudaError {rc})")
    LAUNCHES += 1
    return out


def items_per_run(nbt: int) -> int:
    """Work items a block of the flat kernel walks: ``ITEMS_PER_RUN``, or
    more where a table of ``nbt`` entries would give a request more parts
    (one per run its items touch, at most ``ceil(nbt / ipr) + 1``) than
    the merge holds (``MAX_SPLITS``)."""
    return max(ITEMS_PER_RUN, -(-nbt // (MAX_SPLITS - 1)))


def paged_decode_attention_flat_plain(q, k_pool, v_pool, block_tables,
                                      lengths):
    """The same function in plain PyTorch: each request as a decode
    segment (ctx = length - 1, one row) of the mixed plain version."""
    ones = torch.ones_like(lengths)
    return paged_mixed_attention_plain(
        q[:, None], k_pool, v_pool, block_tables, lengths - ones, ones,
        torch.zeros_like(lengths))[:, 0]


# --------------------------------------------------------------------------
# grid: split-KV over each request's block table
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def grid_split_plan(Hkv: int, NBT: int, BS: int, sms: int,
                    per_sm=SPLIT_BLOCKS_PER_SM):
    """``(S, P)`` of the split-KV decode: split ``s`` of every (request,
    kv head) walks table entries ``[s*P, min((s+1)*P, ceil(L_b/BS)))``.

    Only shapes known on the host enter, never the lengths (they stay on
    the device): a row as long as the table alone gives ``Hkv * S``
    splits, about ``per_sm`` per SM (an int or a ``Fraction``; the grid
    kernel's ``SPLIT_BLOCKS_PER_SM``, the fused kernel's
    ``mixed_attention.FUSED_SPLITS_PER_SM``), and a split walks at least
    ``SPLIT_MIN_KEYS`` keys; ``S <= MAX_SPLITS``. ``S * P >= NBT`` and
    ``(S - 1) * P < NBT``: the splits cover ``[0, NBT)`` once, none of
    them empty."""
    want = max(1, math.ceil(Fraction(per_sm) * sms / Hkv))
    P = max(-(-NBT // min(want, MAX_SPLITS)), -(-SPLIT_MIN_KEYS // BS))
    return -(-NBT // P), P


_SMS = {}              # SM count by device index
# the split-KV merge's arrival counts, one per (row, kv head): zeros made
# once per (device, stream) (arrival_counts)
_ARRIVALS = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def arrival_counts(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` arrival counts of the split-KV merge on ``stream``,
    all 0. One buffer per (device, stream), shared by the flat, grid and
    contiguous decode kernels and the fused kernel's decode rows: each
    call leaves its counts at 0, and calls on one stream run in order."""
    key = (device.index, stream)
    arrivals = _ARRIVALS.get(key)
    if arrivals is None or arrivals.numel() < n:
        arrivals = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _ARRIVALS[key] = arrivals
    return arrivals


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """Decode GQA attention over a paged KV pool on the (request, kv head,
    split) grid — the ``grid`` backend's kernel.

    q            [B, H, Dh]        — one query token per request
    k/v_pool     [NB, BS, Hkv, Dh] — one layer's block pool
    block_tables [B, NBT] int32    — entries past ceil(lengths/BS) are
                                     padding, never read
    lengths      [B] int32         — valid tokens (pos + 1; 0 = dead slot)
    returns      [B, H, Dh] in q's dtype; dead slots are zeros

    One call is one launch (``GRID_LAUNCHES``): every split writes its
    partial softmax state, and the last split of each (request, kv head)
    to finish merges them. The partials are scratch of this call; the
    arrival counts persist per stream and reset themselves.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    global GRID_LAUNCHES
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q is [B, H, Dh], got {tuple(q.shape)}")
    check_paged_operands(name, q, k_pool, v_pool, block_tables, (lengths,),
                         max_group=_MAX_GROUP)
    B, H, Dh = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    NBT = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    S, P = grid_split_plan(Hkv, NBT, BS, _sm_count(q.device))
    rows = B * Hkv * S * (H // Hkv)
    part_acc = torch.empty(rows * Dh, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        arrivals = arrival_counts(q.device, stream, B * Hkv)
        fn = build.entry("decode_attention", "repro_paged_decode_attention",
                         9, 9)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), arrivals.data_ptr(),
                out.data_ptr(), B, H, Hkv, Dh, BS, NBT, S, P,
                _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed (cudaError {rc})")
    GRID_LAUNCHES += 1
    return out


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths):
    """The grid kernel's function in plain PyTorch: the flat kernel's (the
    two differ only in how the work is laid out)."""
    return paged_decode_attention_flat_plain(q, k_pool, v_pool, block_tables,
                                             lengths)


# --------------------------------------------------------------------------
# contiguous caches, padded or ragged
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def contiguous_split_plan(B: int, S: int, Hkv: int, block_s: int,
                          sms: int):
    """``(n, keys)`` of the contiguous decode: split ``s`` of every
    (request, kv head) walks keys ``[s*keys, (s+1)*keys)`` of the
    ``nj*block_s`` (``nj = ceil(S/block_s)``, ``block_s`` clamped to S)
    that the padded mode computes; the ragged mode computes those below
    ``ceil(L_b/block_s)*block_s``, and a split past them does nothing.

    Only shapes enter, never the lengths (they stay on the device).
    Once ``B * Hkv`` blocks fill the ``CONTIG_BLOCKS_PER_SM * sms`` that
    the card holds at once, a (request, kv head) is one split and nothing
    is merged. Fewer rows are cut into as many splits as fit that one
    wave (rounding up would start a second wave of a few blocks, which on
    the card costs more than the splits gain), splits of a multiple of
    ``TILE_KEYS`` keys and at least ``SPLIT_MIN_KEYS``, ``n <=
    MAX_SPLITS``. ``n * keys >= nj*block_s > (n - 1) * keys``: the splits
    cover the padded keys once, none of them empty."""
    total = -(-S // block_s) * block_s
    want = min(MAX_SPLITS, max(1, CONTIG_BLOCKS_PER_SM * sms // (B * Hkv)))
    keys = max(-(-total // want), SPLIT_MIN_KEYS)
    keys = -(-keys // TILE_KEYS) * TILE_KEYS
    return -(-total // keys), keys


def decode_attention(q, k, v, lengths, *, block_s: int = DEFAULT_BLOCK,
                     ragged: bool = False, kv_rows=None):
    """Flash-decode GQA attention over contiguous caches.

    q        [B, H, Dh]      — one query token per request
    k, v     [B, S, Hkv, Dh] — caches padded to S; with ``kv_rows``, any
               number of cache rows [R, S, Hkv, Dh]
    lengths  [B] int32       — valid keys per request
    kv_rows  — None, or [B] int32: query row ``b`` attends cache row
               ``kv_rows[b]`` (the caller keeps each in ``[0, R)``), so a
               serving slab's live rows decode in place, without a gather
    block_s  — keys per block (clamped to S; S is padded with zero rows to
               whole blocks): the unit of work the modes compute or skip
    ragged   — False: every block is computed and masked (the padded
               baseline, cost ∝ B·ceil(S/block_s)); True: blocks that
               start at or past the length are skipped (∝ Σ ceil(L/block_s))
    returns  [B, H, Dh] in q's dtype. A length-0 row is zeros when ragged
    and, as the TPU kernel gives it, the mean of V over the padded rows
    when not.

    A CUDA tensor goes through the operator ``repro_torch::
    contiguous_decode`` (``kernels.ops.LIBRARY``), whose CUDA version
    launches the kernel; so does a fake tensor off the CPU, which gets
    the operator's fake version (a dry run's trace of the card's
    program, on the meta device).
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, block_s=block_s,
                                      ragged=ragged, kv_rows=kv_rows)
    if q.device.type != "cuda" and not isinstance(q, FakeTensor):
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    name = "decode_attention"
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q is [B, H, Dh] and k, v [B, S, Hkv, "
                         f"Dh], got {tuple(q.shape)}, {tuple(k.shape)}")
    B = q.shape[0]
    S = k.shape[1]
    if ((k.shape[0] != B and kv_rows is None) or k.shape[0] < 1 or S < 1
            or block_s < 1):
        raise ValueError(f"{name}: k {tuple(k.shape)} for q "
                         f"{tuple(q.shape)}, block_s {block_s}")
    per_row = (lengths,) if kv_rows is None else (lengths, kv_rows)
    check_paged_operands(name, q, k, v, None, per_row, max_group=_MAX_GROUP)
    return torch.ops.repro_torch.contiguous_decode(q, k, v, lengths, kv_rows,
                                                   block_s, ragged)


def _launch_contiguous(q, k, v, lengths, kv_rows, block_s, ragged):
    """The operator's CUDA version: one launch of the kernel."""
    global PADDED_LAUNCHES, RAGGED_LAUNCHES
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    bs = min(block_s, S)
    n, keys = contiguous_split_plan(B, S, Hkv, bs, _sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        split = (None, None, None)
        if n > 1:
            # partial acc [rows, Dh] then (m, l) [rows, 2] in one buffer,
            # and the stream's arrival counts
            rows = B * n * H
            part = torch.empty(rows * (Dh + 2), dtype=torch.float32,
                               device=q.device)
            split = (part.data_ptr(), part.data_ptr() + rows * Dh * 4,
                     arrival_counts(q.device, stream, B * Hkv).data_ptr())
        fn = build.entry("contiguous_decode",
                         "repro_contiguous_decode_attention", 9, 10)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                None if kv_rows is None else kv_rows.data_ptr(), *split,
                out.data_ptr(), B, S, H, Hkv, Dh, bs, int(ragged), n, keys,
                _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: launch failed "
                           f"(cudaError {rc})")
    if ragged:
        RAGGED_LAUNCHES += 1
    else:
        PADDED_LAUNCHES += 1
    return out


LIBRARY.define("contiguous_decode(Tensor q, Tensor k, Tensor v, "
               "Tensor lengths, Tensor? kv_rows, int block_s, "
               "bool ragged) -> Tensor")
LIBRARY.impl("contiguous_decode", _launch_contiguous, "CUDA")
torch.library.register_fake(
    "repro_torch::contiguous_decode",
    lambda q, k, v, lengths, kv_rows, block_s, ragged: torch.empty_like(q),
    lib=LIBRARY)


@register_flop_formula(torch.ops.repro_torch.contiguous_decode)
def _decode_flops(q_shape, k_shape, v_shape, lengths_shape, kv_rows_shape,
                  block_s, ragged, out_shape=None, **kwargs) -> int:
    """The products of one query token a row over the S cached keys: 4·Dh
    FLOPs per (query head, key). The lengths are data the formula does
    not see, so a ragged launch is counted as padded."""
    B, H, Dh = q_shape
    return 4 * B * H * k_shape[1] * Dh


def decode_attention_plain(q, k, v, lengths, *, block_s: int = DEFAULT_BLOCK,
                           ragged: bool = False, kv_rows=None):
    """The same function in plain PyTorch, the TPU kernel's arithmetic
    written out in f32: scores over the computed keys (every padded row, or
    the blocks below each length), those at or past the length at -1e30,
    each computed key weighted ``exp(s - max)`` — so a row whose every key
    is masked weighs each computed key 1 — and ``acc / l`` (``l = 0 -> 1``).
    Rows go in slices of bounded size, so f32 copies of long caches stay a
    few hundred MB. ``kv_rows`` gathers the cache rows first."""
    if kv_rows is not None:
        k, v = k[kv_rows.long()], v[kv_rows.long()]
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    bs = min(block_s, S)
    Sp = -(-S // bs) * bs
    idx = torch.arange(Sp, device=q.device)
    lengths = lengths.to(torch.int64).clamp(min=0)
    out = torch.empty_like(q)
    step = max(1, (1 << 26) // (S * Hkv * Dh))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        qg = q[sl].reshape(-1, Hkv, G, Dh).float()
        s = torch.einsum("bhgd,bshd->bhgs", qg, k[sl].float()) / math.sqrt(Dh)
        s = torch.nn.functional.pad(s, (0, Sp - S))     # zero rows: score 0
        L = lengths[sl][:, None, None, None]
        s = torch.where(idx < L, s, NEG_INF)
        walked = (idx < -(-L // bs) * bs) if ragged else torch.ones_like(
            s, dtype=torch.bool)
        m = torch.where(walked, s, NEG_INF).amax(-1, keepdim=True)
        p = torch.where(walked, torch.exp(s - m), 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p[..., :S], v[sl].float())
        l = p.sum(-1, keepdim=True)
        out[sl] = (acc / torch.where(l == 0, 1.0, l)).reshape(
            -1, H, Dh).to(q.dtype)
    return out
