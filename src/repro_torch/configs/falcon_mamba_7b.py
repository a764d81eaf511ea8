"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack.

64L d_model=4096 d_inner=8192 ssm_state=16 vocab=65024 [arXiv:2410.05355].
No FFN sub-block (d_ff=0): each layer is norm + mamba mixer + residual.
Falcon-Mamba RMS-normalizes B/C/Δ (bcdt_rms).  Runs long_500k (sub-quadratic).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    block_pattern=("mamba",),
    ssm=SSMConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256,
                  chunk=16, bcdt_rms=True),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        num_layers=4, d_model=64, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=128,
        block_pattern=("mamba",),
        ssm=SSMConfig(d_inner=128, d_state=8, d_conv=4, dt_rank=8,
                      chunk=4, bcdt_rms=True),
        param_dtype="float32", compute_dtype="float32",
    )
