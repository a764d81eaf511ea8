"""deepseek-v2-lite [moe] — MLA (kv_lora=512, no q_lora) + 2 shared / 64
routed experts top-6, dropless, YaRN.

27L d_model=2048 16H d_ff=10944 (first layer) expert_d_ff=1408 vocab=102400
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite].  MLA: nope=128,
rope=64, v=128; YaRN on the rope dims (factor 40 over 4096 positions,
beta 32 / 1, mscale = mscale_all_dim = 0.707); softmax gates of the top 6
not renormalised, ``routed_scaling_factor`` 1, no expert capacity.

Not in ``configs.ARCH_IDS`` (the JAX package has no such config to hold it
against).  The benchmark's configuration file names :func:`build` as its
``program_builder``: it carries the settings ``ModelConfig`` has no field
for (``rope_scaling``, ``moe.norm_topk_prob``, ``moe.routed_scaling_factor``)
on :class:`DeepseekV2Config`, read by ``models/attention.py`` and
``models/moe.py``; every other field is the file's.  ``deepseek-v2-236b``
can take the same builder.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import YaRN


@dataclass(frozen=True)
class DeepseekV2Config(ModelConfig):
    """``ModelConfig`` with DeepSeek-V2's routing and rotary settings."""

    rope_scaling: YaRN | None = None
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0


def _yarn(spec: dict | None) -> YaRN | None:
    """A config.json ``rope_scaling`` of ``"type": "yarn"`` as a YaRN."""
    if spec is None:
        return None
    spec = dict(spec)
    kind = spec.pop("type", "yarn")
    if kind != "yarn":
        raise ValueError(f"rope_scaling type {kind!r}: only 'yarn' is "
                         f"supported")
    return YaRN(**spec)


def build(name: str, model: dict) -> DeepseekV2Config:
    """The config of a configuration file's ``model`` dict: ``ModelConfig``'s
    keys as they are, ``moe`` as a ``MoEConfig`` less its
    ``norm_topk_prob`` / ``routed_scaling_factor``, which go on the result
    with ``rope_scaling``."""
    m = copy.deepcopy(model)
    scaling = _yarn(m.pop("rope_scaling", None))
    extra = {}
    if m.get("moe") is not None:
        moe = m.pop("moe")
        for key in ("norm_topk_prob", "routed_scaling_factor"):
            if key in moe:
                extra[key] = moe.pop(key)
        m["moe"] = MoEConfig(**moe)
    for key in ("block_pattern", "window_pattern"):
        if key in m:
            m[key] = tuple(m[key])
    return DeepseekV2Config(name=name, rope_scaling=scaling, **extra, **m)


MODEL = {
    "num_layers": 27, "d_model": 2048, "num_heads": 16, "num_kv_heads": 16,
    "d_ff": 10944, "vocab_size": 102400, "attn_type": "mla",
    "kv_lora_rank": 512, "q_lora_rank": 0, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "first_dense_layers": 1,
    "first_dense_d_ff": 10944, "rope_theta": 10000.0,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "moe": {"num_experts": 64, "top_k": 6, "expert_d_ff": 1408,
            "num_shared_experts": 2, "shared_d_ff": 2816,
            "capacity_factor": None, "norm_topk_prob": False,
            "routed_scaling_factor": 1.0},
    "norm_eps": 1e-6, "param_dtype": "bfloat16", "compute_dtype": "bfloat16",
}

# the smoke model: YaRN whose original context (16 positions) the tests'
# sequences pass, gates not renormalised and scaled, no capacity, 8 experts
# top 2, 2 shared, a dense first layer, no query LoRA
SMOKE = {
    "num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "d_ff": 192, "vocab_size": 160, "attn_type": "mla", "kv_lora_rank": 32,
    "q_lora_rank": 0, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "first_dense_layers": 1, "first_dense_d_ff": 192,
    "rope_theta": 10000.0,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 16,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "moe": {"num_experts": 8, "top_k": 2, "expert_d_ff": 48,
            "num_shared_experts": 2, "shared_d_ff": 96,
            "capacity_factor": None, "norm_topk_prob": False,
            "routed_scaling_factor": 1.5},
    "norm_eps": 1e-6, "param_dtype": "float32", "compute_dtype": "float32",
}

CONFIG = build("deepseek-v2-lite", MODEL)


def smoke() -> DeepseekV2Config:
    return build("deepseek-v2-lite-smoke", SMOKE)
