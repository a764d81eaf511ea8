"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf].  Attention at layer offset 4 of every 8 (1:7 ratio);
MoE on every 2nd layer (offset 1).  Runs long_500k (sub-quadratic: only 4
full-attention layers, bounded KV).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ssm=SSMConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256, chunk=16),
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336,
                  layer_period=2, layer_offset=1),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=128,
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ssm=SSMConfig(d_inner=128, d_state=8, d_conv=4, dt_rank=8, chunk=4),
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=160,
                      layer_period=2, layer_offset=1, capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
    )
