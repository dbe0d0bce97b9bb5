"""Roofline terms of one rank's program — the port's counterpart of
``repro.launch.roofline``, priced on the H100 (``kernels.cost.H100``).

Three terms per (arch × shape × layout), all PER-RANK seconds:

  compute    = FLOPs_per_chip / peak_FLOP/s      (989 TFLOP/s dense bf16)
  memory     = bytes_per_chip / HBM_bw           (3.35 TB/s)
  collective = Σ_ops wire_factor(op) · bytes / link_bw   (450 GB/s)

A layout's model axis of 16 spans two 8-GPU NVLink domains, so part of
its traffic rides the slower link between hosts: ``t_collective`` at
450 GB/s is a lower bound there.

As in the reference, the compute term reads the analytic structural
FLOPs (``analytic_flops_global`` over the chips) and the memory term the
larger of the counted bytes and an analytic floor; the counted numbers
ride beside them (``flops_hlo_per_chip``, ``bytes_hlo_per_chip``). The
port has no compiler and so no HLO: ``launch.dryrun`` counts them by
tracing one rank's program under fake tensors.

**Collectives.** The reference parses them out of the optimized HLO
(``parse_collectives``: XLA's text, its while-body multiplier). The port
has no HLO to parse; its records come from the recording groups of a
traced rank (``launch.mesh.RecordingCollectives``), in the same schema —
``op``, ``name``, ``operand_bytes``, ``result_bytes``, ``mult`` — and
``mult`` is 1, since the port's layers are a Python loop that records a
collective once per layer. :func:`collective_wire_bytes` reads both
unchanged: ring-algorithm wire factors (all-reduce 2×, all-gather counts
its gathered result, reduce-scatter / all-to-all / collective-permute 1×
operand).

MODEL_FLOPS uses 6·N·D for training and 2·N·D for inference forward
passes (N = active params for MoE); the ratio MODEL_FLOPS / analytic
FLOPs flags attention/dispatch/remat overhead beyond the matmul core.
The analytic formulas are the reference's, unchanged, over the port's
copy of its cost profile (``sim.costmodel.profile_from_config``: the
parameter and KV-byte counts do not depend on the chip).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.kernels.cost import H100, Chip

# the chip every term is priced on (published figures, kernels/cost.py)
PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.link_bw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {
    "all-reduce": 2.0,          # ring: reduce-scatter + all-gather
    "all-gather": 1.0,          # counted on its (gathered) result
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_wire_bytes(records: List[Dict]) -> float:
    total = 0.0
    for r in records:
        f = _WIRE_FACTOR[r["op"]]
        base = r["result_bytes"] if r["op"] == "all-gather" \
            else r["operand_bytes"]
        if base == 0.0:
            base = max(r["operand_bytes"], r["result_bytes"])
        total += f * base * r.get("mult", 1)
    return total


# --------------------------------------------------------------------------
# Analytic structural terms (exact formulas; the reference's)
# --------------------------------------------------------------------------
def analytic_flops_global(cfg, shape_name: str, seq: int,
                          batch: int) -> float:
    """Executed FLOPs (global): matmul core + attention + recurrence.
    Matches what the lowered program actually computes — e.g. the flash
    XLA path computes full (non-causal-pruned) T×S score blocks, and MoE
    gshard dispatch einsums are included."""
    from repro_torch.sim.costmodel import profile_from_config
    prof = profile_from_config(cfg)
    N = prof.params                       # active params (incl. embeddings)
    L = cfg.num_layers
    H, Dh = cfg.num_heads, cfg.head_dim
    attn_layers = (L // cfg.attn_every) if cfg.attn_every else L
    fwd_mult = {"train_4k": 3.0, "prefill_32k": 1.0}.get(shape_name, 1.0)

    if shape_name in ("train_4k", "prefill_32k"):
        tokens = batch * seq
        core = 2.0 * N * tokens
        attn = 0.0
        if H:
            # flash XLA path: full T×S QK^T + PV, 2 matmuls, grouped heads
            attn = attn_layers * 4.0 * batch * seq * seq * H * Dh
        if cfg.family == "ssm":           # rwkv recurrence ~6·H·K² / tok
            Hr = cfg.d_model // (cfg.ssm_head_dim or 64)
            K = cfg.ssm_head_dim or 64
            attn += L * 6.0 * tokens * Hr * K * K
        if cfg.family == "hybrid":        # mamba SSD ~5·H·P·N / tok
            d_inner = 2 * cfg.d_model
            Hm = d_inner // cfg.ssm_head_dim
            attn += L * 5.0 * tokens * Hm * cfg.ssm_head_dim * cfg.ssm_state
        if cfg.family == "encdec":        # encoder self-attn + cross KV
            Se = cfg.encoder_seq
            enc_attn = cfg.encoder_layers * 4.0 * batch * Se * Se * H * Dh
            cross = L * 4.0 * batch * seq * Se * H * Dh
            attn += enc_attn + cross
        return fwd_mult * (core + attn)

    # decode: one token per request against a cache
    core = 2.0 * N * batch
    S_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn = 0.0
    if H:
        attn = attn_layers * 4.0 * batch * S_eff * H * Dh
    if cfg.family == "ssm":
        Hr = cfg.d_model // (cfg.ssm_head_dim or 64)
        K = cfg.ssm_head_dim or 64
        attn += L * 6.0 * batch * Hr * K * K
    if cfg.family == "hybrid":
        d_inner = 2 * cfg.d_model
        Hm = d_inner // cfg.ssm_head_dim
        attn += L * 5.0 * batch * Hm * cfg.ssm_head_dim * cfg.ssm_state
    if cfg.family == "encdec":
        attn += L * 4.0 * batch * cfg.encoder_seq * H * Dh   # cross-attn
    return core + attn


def analytic_bytes_per_chip(cfg, shape_name: str, seq: int, batch: int,
                            model_axis: int, data_axis: int) -> float:
    """HBM-traffic floor per chip: weights streamed once per step (or 3×
    for train: fwd read + grad write + opt update r/w ≈ 3 param passes in
    bf16 + f32 opt state r/w), plus KV/activation traffic."""
    from repro_torch.sim.costmodel import profile_from_config
    prof = profile_from_config(cfg)
    w_chip = 2.0 * prof.params_total / model_axis            # bf16 weights
    if shape_name == "train_4k":
        # fwd+bwd weight reads ×2, grad write, adam mu/nu f32 r/w
        opt = 2 * 4.0 * prof.params_total / model_axis
        act = 2.0 * cfg.d_model * batch * seq / data_axis * cfg.num_layers
        return 3 * w_chip + 2 * opt + act
    if shape_name == "prefill_32k":
        act = 2.0 * cfg.d_model * batch * seq / data_axis * cfg.num_layers
        return w_chip + act
    # decode: weights once + full KV cache read (sharded on data × model)
    S_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    kv = prof.kv_bytes_per_token * S_eff * batch   # total, all layers
    return w_chip + kv / (data_axis * model_axis)


def analytic_min_bytes(cfg, shape_name: str, seq: int, batch: int,
                       mesh_shape: Dict[str, int]) -> float:
    model_axis = mesh_shape.get("model", 1)
    data_axis = (mesh_shape.get("data", 1) * mesh_shape.get("pod", 1))
    return analytic_bytes_per_chip(cfg, shape_name, seq, batch,
                                   model_axis, data_axis)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float                 # analytic
    bytes_per_chip: float                 # max(counted, analytic floor)
    collective_bytes_per_chip: float      # the recorded collectives
    num_chips: int
    model_flops_global: float
    flops_hlo_per_chip: float = 0.0       # counted by the fake-tensor trace
    bytes_hlo_per_chip: float = 0.0
    n_collectives: int = 0
    temp_bytes_per_chip: float = 0.0
    arg_bytes_per_chip: float = 0.0
    chip: Chip = dataclasses.field(default=H100, repr=False)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.chip.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL (matmul-core) FLOPs over executed FLOPs — attention,
        MoE dispatch, non-causal flash waste show up here."""
        exec_global = self.flops_per_chip * self.num_chips
        return self.model_flops_global / max(exec_global, 1e-30)

    def row(self) -> Dict:
        return dict(arch=self.arch, shape=self.shape, mesh=self.mesh,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective, dominant=self.dominant,
                    flops_per_chip=self.flops_per_chip,
                    flops_hlo_per_chip=self.flops_hlo_per_chip,
                    bytes_per_chip=self.bytes_per_chip,
                    bytes_hlo_per_chip=self.bytes_hlo_per_chip,
                    coll_bytes_per_chip=self.collective_bytes_per_chip,
                    model_flops=self.model_flops_global,
                    useful_ratio=self.useful_flops_ratio,
                    n_collectives=self.n_collectives,
                    temp_bytes_per_chip=self.temp_bytes_per_chip,
                    arg_bytes_per_chip=self.arg_bytes_per_chip)


def model_flops(cfg, shape_name: str, seq: int, batch: int) -> float:
    """6·N·D train / 2·N·D inference (N = active params, D = tokens)."""
    from repro_torch.sim.costmodel import profile_from_config
    n_active = profile_from_config(cfg).params
    if shape_name == "train_4k":
        return 6.0 * n_active * seq * batch
    if shape_name == "prefill_32k":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch          # decode: one token per request
