"""minitron-8b — width-pruned Nemotron, dense GQA. [arXiv:2407.14679]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        source="[arXiv:2407.14679]",
    )
