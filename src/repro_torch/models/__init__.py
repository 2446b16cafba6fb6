from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (SHAPE_CASES, Model, ShapeCase,
                                      default_kv_blocks, input_specs)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


__all__ = ["ModelConfig", "Model", "SHAPE_CASES", "ShapeCase", "build_model",
           "default_kv_blocks", "input_specs"]
