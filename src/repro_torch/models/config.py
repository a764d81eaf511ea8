"""Model configuration schema covering all ten assigned architectures.

PyTorch port's copy of ``repro.models.config`` (pure Python).  One flexible
decoder-only configuration space spans dense GQA transformers, MLA
(DeepSeek-V2), local/global alternation + softcaps (Gemma-2), MoE with shared
experts and dense residual (DeepSeek-V2 / Arctic), Mamba-1 SSM stacks
(Falcon-Mamba), and attention/Mamba hybrid interleaves with periodic MoE
(Jamba).  Layer heterogeneity is expressed as a repeating *pattern* whose
period must divide ``num_layers - first_dense_layers``, so every stage of
the layer stack is structurally identical.

The serving cost model reads :data:`SHAPES` from here.  The parameter
counts (``param_count`` / ``active_param_count`` in the reference) walk the
model's parameter shapes and come with the port of ``models/model.py``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0       # DeepSeek-V2: always-on shared experts
    shared_d_ff: int = 0              # d_ff of the shared-expert MLP
    dense_residual: bool = False      # Arctic: dense MLP in parallel with MoE
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight
    router_z_weight: float = 1e-3
    layer_period: int = 1             # every k-th layer is MoE …
    layer_offset: int = 0             # … starting at this layer index


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0                  # 0 → ceil(d_model/16)
    chunk: int = 16                   # within-chunk parallel width (see mamba.py)
    bcdt_rms: bool = False            # Falcon-Mamba: RMS-normalize B, C, Δ


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer kinds: repeating pattern over layers ('attn' | 'mamba')
    block_pattern: tuple[str, ...] = ("attn",)
    first_dense_layers: int = 0       # leading layers kept out of the scan
                                      # (e.g. DeepSeek-V2's dense first layer)

    # attention
    attn_type: str = "gqa"            # 'gqa' | 'mla'
    head_dim: int = 0                 # 0 → d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False             # Chameleon
    attn_softcap: float | None = None  # Gemma-2: 50.0
    window_pattern: tuple[str, ...] = ("global",)  # 'local'|'global' cycle
    local_window: int = 4096

    # MLA (attn_type == 'mla')
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # FFN
    ffn_type: str = "swiglu"          # 'swiglu' | 'gelu'
    first_dense_d_ff: int = 0         # d_ff for the leading dense layers

    # MoE / SSM sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # embeddings / output
    tie_embeddings: bool = False
    logit_softcap: float | None = None  # Gemma-2: 30.0
    embed_scale: bool = False           # Gemma-2: multiply embed by sqrt(d)
    post_block_norm: bool = False       # Gemma-2 sandwich norms

    # numerics
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # modality frontend stub ([audio]/[vlm]: backbone only — `input_specs()`
    # feeds token ids; precomputed frame/patch embeddings enter via the same
    # embedding table shape)
    modality: str = "text"            # 'text' | 'audio' | 'vlm'

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        scanned = self.num_layers - self.first_dense_layers
        assert scanned % self.period == 0, (
            f"{self.name}: effective period {self.period} must divide "
            f"scanned layers {scanned}")
        if "mamba" in self.block_pattern:
            assert self.ssm is not None, f"{self.name}: mamba blocks need ssm config"

    # ---- derived ----------------------------------------------------------

    @property
    def period(self) -> int:
        """Effective stage period: lcm of block / MoE / window cycles so every
        stage of the layer scan is structurally identical."""
        p = len(self.block_pattern)
        if self.moe is not None:
            p = math.lcm(p, self.moe.layer_period)
        if any(self.layer_kind(i) == "attn"
               for i in range(self.first_dense_layers,
                              self.first_dense_layers + p)):
            p = math.lcm(p, len(self.window_pattern))
        return p

    @property
    def num_stages(self) -> int:
        return (self.num_layers - self.first_dense_layers) // self.period

    def layer_kind(self, layer: int) -> str:
        if layer < self.first_dense_layers:
            return "attn"
        return self.block_pattern[
            (layer - self.first_dense_layers) % len(self.block_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None or layer < self.first_dense_layers:
            return False
        return (layer - self.moe.layer_offset) % self.moe.layer_period == 0 \
            and layer >= self.moe.layer_offset

    def window_kind(self, layer: int) -> str:
        return self.window_pattern[layer % len(self.window_pattern)]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
