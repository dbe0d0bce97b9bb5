"""arctic-480b — 128-expert top-2 MoE with parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,                # per-expert and dense-residual FFN dim
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        dense_residual=True,
        source="[hf:Snowflake/snowflake-arctic-base]",
    )
