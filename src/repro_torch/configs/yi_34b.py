"""yi-34b [dense] — llama-arch GQA kv=8.

60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000 [arXiv:2403.04652; hf].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        num_layers=3, d_model=56, num_heads=7, num_kv_heads=1,
        d_ff=160, vocab_size=128,
        param_dtype="float32", compute_dtype="float32",
    )
