"""llama3.2-3b — the paper's own evaluation model (§6.1). [arXiv paper]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
        source="[arXiv:2407.21783 / paper §6.1]",
    )
