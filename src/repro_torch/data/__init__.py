# The port's copy of repro.data: the deterministic synthetic token stream
# (numpy only, bitwise the reference's).
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
