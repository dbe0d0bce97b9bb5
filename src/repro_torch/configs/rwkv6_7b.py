"""rwkv6-7b "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=0,              # attention-free
        num_kv_heads=0,
        d_ff=14336,
        vocab_size=65536,
        ssm_head_dim=64,          # 64 rwkv heads of dim 64
        ssm_state=64,
        source="[arXiv:2404.05892]",
    )
