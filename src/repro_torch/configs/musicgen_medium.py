"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
Backbone only: the EnCodec frontend is a stub — input_specs() feeds token ids
in [0, 2048) (precomputed frame embeddings enter through the same table).
GELU FFN; RoPE stands in for the original sinusoidal positions (documented
hardware adaptation: one positional scheme across the zoo).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, ffn_type="gelu", modality="audio",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        num_layers=4, d_model=96, num_heads=6, num_kv_heads=6,
        d_ff=384, vocab_size=128, ffn_type="gelu", modality="audio",
        param_dtype="float32", compute_dtype="float32",
    )
