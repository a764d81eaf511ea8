"""deepseek-7b [dense] — llama-arch MHA (GQA kv=32).

30L d_model=4096 32H d_ff=11008 vocab=102400 [arXiv:2401.02954; hf].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=172, vocab_size=160,
        param_dtype="float32", compute_dtype="float32",
    )
