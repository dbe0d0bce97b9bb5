"""whisper-large-v3 — enc-dec audio backbone, conv frontend stubbed.
[arXiv:2212.04356]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        num_layers=32,            # decoder
        encoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,          # GQA kv=20 (== MHA)
        d_ff=5120,
        vocab_size=51866,
        encoder_seq=1500,         # 30 s audio after conv frontend (stub)
        max_position=448,         # whisper decoder position table
        learned_pos=True,
        act="gelu",
        source="[arXiv:2212.04356]",
    )
