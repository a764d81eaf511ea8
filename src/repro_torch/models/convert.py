"""Carry a reference parameter tree into the port's model.

``repro.models.init_params`` returns nested dicts: ``embed``, ``lm_head``
(untied only), ``final_norm``, ``first`` (the leading dense layers, a list;
empty but for DeepSeek-V2) and ``stages``, whose leaves carry a leading
``num_stages`` axis (``stages/sub{j}/...``, slot ``j`` of the stage).  Layer
``i`` of the port is ``first[i]`` for ``i < first_dense_layers``, and layer
``first_dense_layers + s * period + j`` is slot ``j`` of stage ``s``, so both
packages compute the same function from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, param_specs


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _reference_state(cfg: ModelConfig, tree: dict) -> dict:
    """The reference tree (nested dicts and lists of numpy arrays) as the
    port's ``state_dict``: parameter name → numpy array."""
    out = {k: np.asarray(tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    first = tree.get("first") or []
    if isinstance(first, dict):         # list levels through an .npz
        first = [first[k] for k in sorted(first, key=int)]
    if len(first) != cfg.first_dense_layers:
        raise ValueError(f"first: {len(first)} layers, the config has "
                         f"{cfg.first_dense_layers}")
    for i, layer in enumerate(first):
        for name, leaf in _flatten(layer, "", {}).items():
            out[f"layers.{i}.{name}"] = leaf
    fd = cfg.first_dense_layers
    for j in range(cfg.period):
        for name, leaf in _flatten(tree["stages"][f"sub{j}"], "", {}).items():
            if leaf.shape[0] != cfg.num_stages:
                raise ValueError(f"stages/sub{j}/{name}: leading axis "
                                 f"{leaf.shape[0]} != {cfg.num_stages} stages")
            for s in range(cfg.num_stages):
                out[f"layers.{fd + s * cfg.period + j}.{name}"] = leaf[s]
    return out


def params_from_reference(cfg: ModelConfig, tree: dict, *,
                          device=None) -> Transformer:
    """The port's model holding the reference tree's values, on ``device``
    (the card unless told otherwise).  Raises unless every parameter of the
    port gets exactly one reference leaf of its shape and dtype."""
    state = _reference_state(cfg, tree)
    model = param_specs(cfg)
    names = {n for n, _ in model.named_parameters()}
    if names != set(state):
        raise ValueError(f"parameter names differ: port only "
                         f"{sorted(names - set(state))}, reference only "
                         f"{sorted(set(state) - names)}")
    model = model.to_empty(device=resolve_device(device))
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = torch.from_numpy(np.ascontiguousarray(state[name]))
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(src.shape)} "
                                 f"{src.dtype}, port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(src)
    return model
