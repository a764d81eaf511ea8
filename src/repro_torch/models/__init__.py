# LM substrate of the port: decoder-only stacks behind one ModelConfig —
# GQA (local/global windows, softcaps, qk-norm, sandwich norms) and MLA
# attention, dense and MoE FFNs, Mamba-1 SSM layers and their hybrids.
from repro_torch.models.config import (SHAPES, ModelConfig, MoEConfig,
                                       ShapeConfig, SSMConfig)
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import (
    cache_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_fn,
    model_flops,
    param_shapes,
    param_specs,
    prefill_step,
)

__all__ = [
    "SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
    "cache_specs", "decode_step", "forward", "init_cache", "init_params",
    "logits_fn", "model_flops", "param_shapes", "param_specs",
    "params_from_reference", "prefill_step",
]
