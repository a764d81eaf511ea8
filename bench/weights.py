"""Random weights from ``--seed``, made on the device in a few large calls.

The reference module of a configuration lists every weight with its shape,
dtype and initialisation (``parameters(cfg)``).  The weights of one dtype
live in one flat buffer, ordered so that the weights of one initialisation
lie together: one ``normal_`` draw fills each buffer from a seeded
``torch.Generator`` on the device, then one scale (and shift) per run of
equal initialisation.  The same tensors go to the program and to the
reference.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def make_weights(params: list, seed: int, device) -> dict[str, torch.Tensor]:
    """``params``: [(name, shape, dtype, init)] → {name: tensor}."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for dtype in sorted({p[2] for p in params}):
        leaves = sorted((p for p in params if p[2] == dtype),
                        key=lambda p: repr(p[3]))      # stable: runs of init
        buf = torch.empty(sum(math.prod(p[1]) for p in leaves),
                          dtype=DTYPES[dtype], device=device)
        buf.normal_(generator=gen)
        runs, off = {}, 0
        for name, shape, _, init in leaves:
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape)
            runs[init] = (runs.get(init, (off,))[0], off + n)
            off += n
        for init, (lo, hi) in runs.items():
            _shape_run(buf[lo:hi], init)
    return out


def _shape_run(run: torch.Tensor, init: tuple) -> None:
    """Scale a run of unit normals in place to its initialisation."""
    kind = init[0]
    if kind == "normal":
        run.mul_(init[1])
    elif kind == "normal_about":
        run.mul_(init[2]).add_(init[1])
    elif kind == "log_arange":
        n = init[1]
        rows = run.view(-1, n)
        rows.mul_(0.1).add_(torch.log(torch.arange(
            1, n + 1, dtype=run.dtype, device=run.device)))
    else:
        raise ValueError(f"unknown initialisation {init!r}")
