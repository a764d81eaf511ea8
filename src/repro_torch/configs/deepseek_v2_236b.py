"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared / 160 routed top-6.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400 [arXiv:2405.04434; hf].
MLA: q_lora=1536, kv_lora=512, nope=128, rope=64, v=128.  First layer dense
(d_ff 12288); every other layer MoE with 2 shared experts.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    first_dense_layers=1, first_dense_d_ff=12288,
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  num_shared_experts=2, shared_d_ff=3072),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=192, vocab_size=160,
        attn_type="mla", kv_lora_rank=32, q_lora_rank=48,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        first_dense_layers=1, first_dense_d_ff=192,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=48,
                      num_shared_experts=2, shared_d_ff=96,
                      capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
    )
