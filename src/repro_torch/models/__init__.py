from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model, build_model, synthetic_batch

__all__ = ["ModelConfig", "Model", "build_model", "synthetic_batch"]
