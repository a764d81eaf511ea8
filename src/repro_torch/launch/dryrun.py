"""Multi-pod dry run: every (arch × shape × mesh) cell's step, on meta tensors.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 512 placeholder host devices and reads XLA's analyses.  The
port runs the cell instead, as rank 0 of the production mesh
(``make_production_mesh``: a ``DeviceMesh`` over a ``fake``-backend world
of 256 or 512 ranks, whose collectives return at once and move nothing):

* the parameters, optimizer state, caches and batch are ``DTensor`` s of
  ``meta`` tensors (shapes and dtypes, no memory), laid out by the port's
  ``param_pspecs`` / ``opt_pspecs`` / ``cache_pspecs`` / ``batch_pspec``;
* the cell's step (``specs.build_step``) runs under its
  ``activation_hint_policy``, as a mesh-backed replica's does;
* ``cost_analysis.CostRecorder`` records it below ``DTensor``: rank 0's
  FLOPs, bytes and collectives (``summarize_step``), the keys that
  ``CostCell.from_dryrun`` reads.

Meta tensors compute nothing on any device, so a cell runs on any machine,
card or not; the time it takes is the host's (``trace_s``).  A fake
world cannot share a process with a real one: run the dry run as a
process of its own.  Artifacts go to ``experiments/artifacts/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, cached
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.dist.hints import sharding_policy
from repro_torch.dist.sharding import (P, activation_hint_policy,
                                       batch_pspec, cache_pspecs, named,
                                       opt_pspecs, param_pspecs,
                                       reshard_tree)
from repro_torch.launch.cost_analysis import (CostRecorder, collective_stats,
                                              summarize_step)
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.launch.specs import (build_step, input_specs,
                                      opt_config_for, runnable_shapes)
from repro_torch.models.config import SHAPES
from repro_torch.models.model import cache_specs, param_shapes, param_specs
from repro_torch.obs import get_logger
from repro_torch.optim.adamw import init_opt_state

log = get_logger("dryrun")

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "artifacts", "dryrun_torch")

__all__ = ["collective_stats", "summarize_step", "dryrun_cell", "trace_cell",
           "cell_path", "run_all"]


# ---------------------------------------------------------------------------


def _stand_in(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor shaped like ``t``."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _params_module(cfg, tree: dict, *, requires_grad: bool):
    """A ``Transformer`` shell holding ``tree``'s tensors as parameters."""
    shell = param_specs(cfg)
    for name, t in tree.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = shell.get_submodule(mod_name) if mod_name else shell
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=requires_grad))
    return shell


def _densify(spec: P, shape, data_axis: str) -> P:
    """``opt_2d``: moments may shard on more axes than their parameters
    (one reshard a step against per-layer weight gathers): the first free
    dim divisible by 16 takes the data axis when the spec lacks it."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries
            for a in (e if isinstance(e, tuple) else (e,)) if a}
    if data_axis in used:
        return spec
    for i, e in enumerate(entries):
        if e is None and shape[i] % 16 == 0:
            entries[i] = data_axis
            return P(*entries)
    return spec


def trace_cell(cfg, shape, mesh=None, ax=None, *, policy_override=None,
               fsdp: bool = True, fsdp_experts_only: bool = False,
               opt_2d: bool = False, cache_seq_shard: bool = False) -> dict:
    """Run ``shape``'s step of ``cfg`` once under the recorder; returns
    ``summarize_step``'s dict plus ``trace_s``.

    The inputs are ``meta`` tensors (shapes and dtypes, no memory, no
    arithmetic); every tensor the step makes from them is one too.  With
    ``mesh`` (and its ``ax``) they are ``DTensor`` s laid out by the port's
    spec trees and the step runs under the hint policy; with ``mesh=None``
    they are plain, as a one-device run of the same step has them."""
    from torch.distributed.tensor.experimental import implicit_replication

    step = build_step(cfg, shape)
    ins = input_specs(cfg, shape)
    train = shape.kind == "train"
    shapes = param_shapes(cfg)
    specs, policy = {}, {}
    ctxs = [] if train else [torch.no_grad()]
    if mesh is not None:
        specs["params"] = param_pspecs(cfg, ax, fsdp=fsdp,
                                       fsdp_experts_only=fsdp_experts_only)
        specs["batch"] = batch_pspec(ax, shape)
        specs["caches"] = cache_pspecs(cfg, ax, shape,
                                       seq_shard=cache_seq_shard)
        policy = dict(policy_override if policy_override is not None else
                      activation_hint_policy(cfg, ax, shape))
        policy["__mesh__"] = mesh
        if shape.kind != "decode":
            # The sequence is sharded at layer boundaries; the projections
            # flatten (batch, sequence), which DTensor before torch 2.13
            # cannot do to a tensor sharded on both.  The gather that GSPMD
            # (and DTensor since, through strided sharding) inserts there
            # goes to the model's sequence-gather site instead.
            policy.setdefault("sublayer_input", P(ax.batch, None, None))
        ctxs.append(implicit_replication())
    if shape.kind != "decode":
        # One query block sweeping every key chunk, as the reference's dry
        # run sweeps them all (its ``differentiable=True`` static loop): the
        # same count, full S x S scores under the causal mask, in S / 512
        # loop trips a layer rather than ~(S / 512)^2 / 2.
        policy.setdefault("__attn_q_chunk__", "full")
    if policy:
        ctxs.append(sharding_policy(policy))

    def place(tree, kind):
        if mesh is None:
            return tree
        return reshard_tree(tree, named(mesh, specs[kind]))

    plain = {n: _stand_in(t) for n, t in param_specs(cfg).named_parameters()}
    params = _params_module(cfg, place(plain, "params"), requires_grad=train)
    tokens = place(_stand_in(ins["tokens"]), "batch")
    if train:
        opt_cfg = opt_config_for(cfg)
        opt = init_opt_state(plain, opt_cfg)
        if mesh is not None:
            o_param = specs["params"]
            if opt_2d:
                o_param = {n: _densify(s, shapes[n], ax.data)
                           for n, s in o_param.items()}
            specs["opt"] = opt_pspecs(o_param, opt_cfg.moment_dtype, ax,
                                      param_shapes=shapes)
            opt = place(opt, "opt")
        args = (params, opt, tokens,
                place(_stand_in(ins["labels"]), "batch"))
    else:
        caches = place({n: torch.zeros(s.shape, dtype=s.dtype, device="meta")
                        for n, s in cache_specs(cfg, shape.global_batch,
                                                shape.seq_len).items()},
                       "caches")
        args = ((params, tokens, caches) if shape.kind == "prefill" else
                (params, caches, tokens, _stand_in(ins["pos"])))
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        rec = stack.enter_context(CostRecorder())
        t0 = time.perf_counter()
        out = step(*args)
        trace_s = time.perf_counter() - t0
    return {**summarize_step(rec.records, args, out),
            "trace_s": round(trace_s, 2)}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                *, policy_override=None, fsdp: bool = True,
                fsdp_experts_only: bool = False,
                opt_2d: bool = False, cache_seq_shard: bool = False,
                verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    summary = trace_cell(cfg, shape, mesh, mesh_axes(multi_pod=multi_pod),
                         policy_override=policy_override, fsdp=fsdp,
                         fsdp_experts_only=fsdp_experts_only, opt_2d=opt_2d,
                         cache_seq_shard=cache_seq_shard)
    out = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "num_devices": math.prod(mesh.mesh.shape),
        "fsdp": fsdp,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        **summary,
    }
    if verbose:
        weighted, mem_info = summary["weighted"], summary["memory"]
        log.info(f"{arch} × {shape_name} × {out['mesh']}: "
                 f"traced OK ({summary['trace_s']:.1f}s, "
                 f"{summary['ops']} ops) "
                 f"flops/dev={weighted['dot_flops_per_device']:.3e} "
                 f"argbytes/dev={mem_info['argument_size_in_bytes']} "
                 f"wwire/dev={weighted['total_wire_bytes_per_device']:.3e}")
    return out


def cell_path(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    mesh = "multi" if multi_pod else "single"
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    return os.path.join(ARTIFACT_DIR, f"{arch}_{shape_name}_{mesh}{suffix}.json")


def _run_and_save(arch, shape_name, multi, **kw) -> dict:
    """One cell, recorded with ``error`` / ``traceback`` if it fails (a
    failing cell is a fault to record, not to skip), written to its
    ``cell_path``."""
    try:
        res = dryrun_cell(arch, shape_name, multi, **kw)
    except Exception as e:
        res = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi else "16x16",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        log.error(f"FAILED {arch} × {shape_name} × "
                  f"{'multi' if multi else 'single'}: {e}")
    with open(cell_path(arch, shape_name, multi), "w") as f:
        json.dump(res, f, indent=1)
    return res


def run_all(archs=None, shapes=None, meshes=("single", "multi"),
            force: bool = False) -> list[dict]:
    results = []
    for arch in (archs or all_arch_names()):
        cfg = get_config(arch)
        for shape_name in (shapes or runnable_shapes(cfg)):
            if shape_name not in runnable_shapes(cfg):
                continue
            for mesh_kind in meshes:
                multi = mesh_kind == "multi"
                path = cell_path(arch, shape_name, multi)
                if os.path.exists(path) and not force:
                    with open(path) as f:
                        results.append(json.load(f))
                    continue
                results.append(_run_and_save(arch, shape_name, multi))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    args = ap.parse_args(argv)

    if args.all:      # every cell on both meshes, as the reference's --all
        res = run_all(archs=[args.arch] if args.arch else None,
                      shapes=[args.shape] if args.shape else None,
                      force=args.force)
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape (or --all)")
        meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
        res = [_run_and_save(args.arch, args.shape, mk == "multi",
                             fsdp=not args.no_fsdp) for mk in meshes]
    failed = [f"{r['arch']} × {r['shape']} × {r['mesh']}" for r in res
              if "error" in r]
    if failed:
        raise SystemExit(f"{len(failed)} cell(s) failed: {failed}")


if __name__ == "__main__":
    main()
