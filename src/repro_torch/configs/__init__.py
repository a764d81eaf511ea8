# Assigned architectures (public-literature configs): the port's copy of
# repro.configs.  Each module exposes CONFIG (full) and smoke() (reduced,
# CPU-runnable).
from __future__ import annotations

import importlib

ARCH_IDS = [
    "musicgen_medium",
    "deepseek_7b",
    "phi3_medium_14b",
    "gemma2_9b",
    "yi_34b",
    "deepseek_v2_236b",
    "arctic_480b",
    "falcon_mamba_7b",
    "jamba_v0_1_52b",
    "chameleon_34b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({
    "musicgen-medium": "musicgen_medium",
    "deepseek-7b": "deepseek_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma2-9b": "gemma2_9b",
    "yi-34b": "yi_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "arctic-480b": "arctic_480b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "chameleon-34b": "chameleon_34b",
})


def _module(name: str):
    key = _ALIAS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke()


def all_arch_names() -> list[str]:
    return list(ARCH_IDS)
