"""The public contiguous attention entry points, in torch.

The port's counterpart of ``repro.kernels.ops.decode_attention`` and
``prefill_attention``: each picks the ``kernels/ref.py`` oracle
(``backend="ref"``) or the hand-written kernel (``backend="kernel"``: the
CUDA kernel for CUDA tensors, its plain PyTorch version for CPU tensors,
never one in place of the other).
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import prefill_attention as pk
from repro_torch.kernels import ref

BACKENDS = ("ref", "kernel")


def decode_attention(q, k, v, lengths, *, backend: str = "ref",
                     ragged: bool = False, block_s: int = 512):
    """q [B, H, Dh]; k, v [B, S, Hkv, Dh]; lengths [B] int32 ->
    [B, H, Dh]: the oracle, or the contiguous decode kernel (padded, or
    ``ragged``, in blocks of ``block_s`` keys)."""
    if backend == "ref":
        return ref.decode_attention_ref(q, k, v, lengths)
    if backend == "kernel":
        return dk.decode_attention(q, k, v, lengths, block_s=block_s,
                                   ragged=ragged)
    raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


def prefill_attention(q, k, v, lengths=None, *, backend: str = "ref"):
    """q [B, T, H, Dh]; k, v [B, T, Hkv, Dh]; lengths [B] int32 or None ->
    [B, T, H, Dh], causal: the oracle, or the contiguous prefill kernel.
    The reference's ``block_q``/``block_k`` are TPU tiles that change only
    the order of its sums; the CUDA kernel picks its own, so they are not
    taken here."""
    if backend == "ref":
        return ref.prefill_attention_ref(q, k, v, lengths)
    if backend == "kernel":
        return pk.prefill_attention(q, k, v, lengths)
    raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
