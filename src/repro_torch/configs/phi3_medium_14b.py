"""phi3-medium-14b [dense] — RoPE SwiGLU GQA kv=10.

40L d_model=5120 40H (kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=224, vocab_size=160,
        param_dtype="float32", compute_dtype="float32",
    )
