"""qwen2-vl-7b — VLM backbone with M-RoPE; ViT frontend stubbed.
[arXiv:2409.12191]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        use_mrope=True,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="[arXiv:2409.12191]",
    )
