"""zamba2-2.7b — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,            # mamba2 blocks
        d_model=2560,
        num_heads=32,             # shared attention block (MHA, kv=32)
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        attn_every=6,             # shared block applied 9 times
        source="[arXiv:2411.15242]",
    )
