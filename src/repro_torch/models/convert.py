"""Carry a reference parameter tree into the port's model.

``repro.models.init_params`` returns nested dicts: ``embed``, ``lm_head``
(untied only), ``final_norm``, ``first`` (the leading dense layers, a list;
empty but for DeepSeek-V2) and ``stages``, whose leaves carry a leading
``num_stages`` axis (``stages/sub{j}/...``, slot ``j`` of the stage).  Layer
``i`` of the port is ``first[i]`` for ``i < first_dense_layers``, and layer
``first_dense_layers + s * period + j`` is slot ``j`` of stage ``s``, so both
packages compute the same function from the same numbers.

The reference's optimizer state (``repro.optim.init_opt_state``) has the
same tree twice, ``m`` and ``v``, whose int8 leaves are ``{"q", "scale"}``
dicts, and an int32 ``step``; ``opt_state_from_reference`` carries it onto
the port's parameter names the same way, so a run the reference saved can
be continued in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, param_specs
from repro_torch.optim.adamw import _load_moment


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (an ``ml_dtypes`` dtype,
    as ``np.asarray`` of a jax array gives it) keeps its bits."""
    arr = np.asarray(arr)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()           # jax arrays come back read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _reference_state(cfg: ModelConfig, tree: dict) -> dict:
    """The reference tree (nested dicts and lists of numpy arrays) as the
    port's ``state_dict``: parameter name → numpy array."""
    out: dict = {}
    for k in ("embed", "final_norm", "lm_head"):
        if k in tree:
            _flatten(tree[k], f"{k}.", out)
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
            src = _tensor(state[name])
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(src.shape)} "
                                 f"{src.dtype}, port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(src)
    return model


def opt_state_from_reference(cfg: ModelConfig, state: dict, *,
                             device=None) -> dict:
    """The reference's AdamW state (``{"step", "m", "v"}`` over its
    parameter tree) as the port's (``repro_torch.optim``: the same keys
    over the port's parameter names), on ``device`` (the card unless told
    otherwise).  int8 leaves keep their ``{"q", "scale"}`` form, except
    where the port's leaf is 1-D: the reference stacks a stage's 1-D leaves
    (norms, Mamba's vectors) over the stages and so stores their moments in
    int8, while the port keeps 1-D moments in f32, so those are
    dequantized (ROADMAP queue 3).  Raises unless ``m`` and ``v`` each hold
    exactly the port's parameter names."""
    dev = resolve_device(device)
    specs = dict(param_specs(cfg).named_parameters())

    def moments(tree, transform: bool):
        out: dict = {}
        for key, arr in _reference_state(cfg, tree).items():
            base, _, leaf = key.rpartition(".")
            if key not in specs and base in specs and leaf in ("q", "scale"):
                out.setdefault(base, {})[leaf] = _tensor(arr)
            else:
                out[key] = _tensor(arr)
        if set(out) != set(specs):
            raise ValueError(f"moment names differ: port only "
                             f"{sorted(set(specs) - set(out))}, reference "
                             f"only {sorted(set(out) - set(specs))}")
        for name, m in out.items():
            if isinstance(m, dict) and specs[name].dim() < 2:
                out[name] = _load_moment(m, transform)
        return {name: ({k: v.to(dev) for k, v in m.items()}
                       if isinstance(m, dict) else m.to(dev))
                for name, m in out.items()}

    step = torch.as_tensor(np.asarray(state["step"]), dtype=torch.int32)
    return {"step": step.to(dev), "m": moments(state["m"], False),
            "v": moments(state["v"], True)}
