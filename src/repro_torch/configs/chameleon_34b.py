"""chameleon-34b [vlm] — early-fusion VQ image+text tokens, qk-norm.

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818].
Backbone only: the VQ image tokenizer frontend is a stub — input_specs()
feeds mixed-modal token ids in [0, 65536).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True, modality="vlm",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=1,
        d_ff=172, vocab_size=256, qk_norm=True, modality="vlm",
        param_dtype="float32", compute_dtype="float32",
    )
