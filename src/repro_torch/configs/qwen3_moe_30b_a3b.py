"""qwen3-moe-30b-a3b — 128-expert top-8 MoE. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=768,                 # per-expert FFN dim
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        rope_theta=1_000_000.0,
        source="[hf:Qwen/Qwen3-30B-A3B]",
    )
