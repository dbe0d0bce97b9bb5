"""smollm-360m — llama-arch small model. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        source="[hf:HuggingFaceTB/SmolLM-135M]",
    )
