from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, default_kv_blocks


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


__all__ = ["ModelConfig", "Model", "build_model", "default_kv_blocks"]
