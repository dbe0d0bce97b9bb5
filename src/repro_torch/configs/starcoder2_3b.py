"""starcoder2-3b — dense GQA + RoPE code model. [arXiv:2402.19173]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        rope_theta=100_000.0,
        act="gelu",
        source="[arXiv:2402.19173]",
    )
