"""gemma2-9b [dense] — local/global alternating attention + logit softcaps.

42L d_model=3584 16H (kv=8, head_dim=256) d_ff=14336 vocab=256000
[arXiv:2408.00118; hf].  GeGLU, sandwich norms, tied embeddings, embed scale,
attn softcap 50, final logit softcap 30, local window 4096.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256_000, ffn_type="geglu",
    window_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_block_norm=True,
    tie_embeddings=True, embed_scale=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=224, vocab_size=256, ffn_type="geglu",
        window_pattern=("local", "global"), local_window=8,
        attn_softcap=50.0, logit_softcap=30.0, post_block_norm=True,
        tie_embeddings=True, embed_scale=True,
        param_dtype="float32", compute_dtype="float32",
    )
