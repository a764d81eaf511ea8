"""arctic-480b [moe] — 128 experts top-2 + dense residual.

35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base].  The dense MLP runs in parallel with
the MoE on every layer (dense_residual).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True, dense_residual_d_ff=4864),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        num_layers=3, d_model=56, num_heads=7, num_kv_heads=1,
        d_ff=112, vocab_size=128,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=112,
                      dense_residual=True, dense_residual_d_ff=112,
                      capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
    )
