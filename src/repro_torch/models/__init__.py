# Model configurations: the schema and the serving/training shape cells (the
# model code itself is still to port).
from repro_torch.models.config import (SHAPES, ModelConfig, MoEConfig,
                                       ShapeConfig, SSMConfig)

__all__ = ["SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig", "SSMConfig"]
