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
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --force --jobs 6   # + a table of the cells
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
                                       batch_pspec, cache_pspecs,
                                       model_axis_size, named, opt_pspecs,
                                       padded_config, param_pspecs,
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
           "cell_path", "all_cells", "run_all", "run_cells", "run_processes",
           "table"]


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
    they are plain, as a one-device run of the same step has them.  Where
    the mesh's model axis does not divide ``cfg``'s heads, the cell runs
    the padded config (``dist.sharding.padded_config``) and counts its
    work, as the reference's compiled HLO does; a batch the batch axes do
    not divide runs replicated over them (``batch_sharded`` False in the
    summary)."""
    from torch.distributed.tensor.experimental import implicit_replication

    m = model_axis_size(mesh, ax)
    step = build_step(cfg, shape, model_axis=m)
    opt_cfg = opt_config_for(cfg)
    # a model axis that does not divide the heads pads them, as GSPMD does:
    # the cell runs (and counts) the padded model
    cfg = padded_config(cfg, m)
    ins = input_specs(cfg, shape)
    train = shape.kind == "train"
    shapes = param_shapes(cfg)
    specs, policy = {}, {}
    ctxs = [] if train else [torch.no_grad()]
    batch_shard = True
    if mesh is not None:
        # a batch its axes do not divide (long_500k's one sequence over 16
        # or 32 ranks) is replicated over them: every rank of the axes
        # runs the one row, the per-rank work of GSPMD's padded batch.  So
        # is a batch of one over axes of one (DTensor will not view a
        # sharded singleton dim away)
        n_batch = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                            for a in ax.batch_tuple
                            if a in mesh.mesh_dim_names)
        batch_shard = (shape.global_batch % n_batch == 0
                       and shape.global_batch > 1)
        specs["params"] = param_pspecs(cfg, ax, fsdp=fsdp,
                                       fsdp_experts_only=fsdp_experts_only)
        specs["batch"] = batch_pspec(ax, shape, batch_shard=batch_shard)
        specs["caches"] = cache_pspecs(cfg, ax, shape,
                                       seq_shard=cache_seq_shard,
                                       batch_shard=batch_shard)
        policy = dict(policy_override if policy_override is not None else
                      activation_hint_policy(cfg, ax, shape,
                                             batch_shard=batch_shard))
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
            "trace_s": round(trace_s, 2), "batch_sharded": batch_shard}


FLOP_SLACK = 1.25


def flop_bounds(cfg, shape, n: int, batch_ranks: int = 1,
                batch_sharded: bool = True) -> tuple[float, float]:
    """(lowest, highest) FLOPs rank 0 of an ``n``-device cell may count for
    ``cfg`` as the cell ran it (heads padded where the model axis does not
    divide them), ``batch_ranks`` the ranks of the batch axes.  A batch
    they do not split runs whole on each of them: its work divides over
    between ``n / batch_ranks`` and ``n`` ranks.

    The forward's matmuls: 2 FLOPs a token for each matrix entry a token
    multiplies (not the looked-up embedding rows, Mamba's elementwise
    ``A_log`` and shift-add ``conv_w``; a prefill unembeds its last token
    only), the routed experts at ``top_k / E`` of their
    parameters from below and on their capacity rows (``G · E · C`` a MoE
    layer: what the dispatch computes, padding included) from above.
    Attention a token and attention layer: ``4 · context · heads ·
    head_dim`` (QK^T and PV over every key; the dry run sweeps them all);
    MLA's absorbed decode ``2 · context · heads · (2 · kv_lora + rope)``,
    its prefill ``2 · context · heads · (nope + rope + v)``; a Mamba layer's
    scan ``2 · d_inner · d_state``.

    Inference: from the matmuls' floor to :data:`FLOP_SLACK` x (matmuls on
    capacity rows + attention).  Train: 3x the floor (forward and
    backward: the 6·N·T of ``model_flops``) to the slack x (4x the matmuls,
    for the forward, remat's second forward and a backward of twice a
    forward, + 5x attention, with the ``differentiable`` q-block remat's
    third forward)."""
    from repro_torch.models.model import param_shapes
    from repro_torch.models.moe import _num_groups, capacity_for
    from repro_torch.models.transformer import layer_plan

    B, S = shape.global_batch, shape.seq_len
    T = B * (1 if shape.kind == "decode" else S)
    head_tokens = B if shape.kind == "prefill" else T
    D, V = cfg.d_model, cfg.vocab_size
    shapes = param_shapes(cfg)
    plan = layer_plan(cfg)
    expert_active = expert_rows_flops = 0
    if cfg.moe is not None:
        E, K = cfg.moe.num_experts, cfg.moe.top_k
        G = _num_groups(T)
        if batch_sharded and G % batch_ranks and T % math.lcm(G,
                                                              batch_ranks) \
                == 0:
            G = math.lcm(G, batch_ranks)
        rows = G * E * capacity_for(cfg, T // G)
        for name, sh in shapes.items():
            if "experts" in name.split("."):
                expert_active += math.prod(sh) * K // E
                expert_rows_flops += 2 * math.prod(sh) // E * rows
    head = D * V
    # the matrices a token multiplies: not the 1-D leaves, Mamba's A_log
    # (elementwise) and conv_w (a depthwise conv of shifted adds), the
    # looked-up embedding rows, the head (above) or the routed experts
    dense = sum(math.prod(sh) for name, sh in shapes.items()
                if len(sh) >= 2 and "experts" not in name.split(".")
                and name.split(".")[-1] not in ("A_log", "conv_w", "embed",
                                                "lm_head"))
    floor = 2 * dense * T + 2 * head * head_tokens + 2 * expert_active * T
    top = 2 * dense * T + 2 * head * head_tokens + expert_rows_flops
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.attn_type == "mla":
        R, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        per = (2 * S * H * (2 * R + rope) if shape.kind == "decode" else
               2 * S * H * (cfg.qk_nope_head_dim + rope + cfg.v_head_dim))
    else:
        per = 4 * S * H * hd
    kinds = [slot["kind"] for slot in plan]
    scan = 2 * cfg.ssm.d_inner * cfg.ssm.d_state if cfg.ssm else 0
    attn = T * (kinds.count("attn") * per + kinds.count("mamba") * scan)
    # a batch the batch axes do not split: between the n ranks (DTensor can
    # still split the contraction of an FSDP-sharded weight) and the
    # n / batch_ranks that split anything else
    few = n if batch_sharded else n // batch_ranks
    if shape.kind != "train":
        return floor / n, FLOP_SLACK * (top + attn) / few
    return 3 * floor / n, FLOP_SLACK * (4 * top + 5 * attn) / few


def cell_bounds(cell: dict) -> tuple[float, float]:
    """:func:`flop_bounds` of a dry-run cell's artifact (its arch, shape,
    mesh, heads run and batch layout)."""
    cfg = padded_config(get_config(cell["arch"]), 16)
    batch_ranks = cell["num_devices"] // 16
    return flop_bounds(cfg, SHAPES[cell["shape"]], cell["num_devices"],
                       batch_ranks, cell.get("batch_sharded", True))


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                *, policy_override=None, fsdp: bool = True,
                fsdp_experts_only: bool = False,
                opt_2d: bool = False, cache_seq_shard: bool = False,
                verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    ax = mesh_axes(multi_pod=multi_pod)
    run = padded_config(cfg, model_axis_size(mesh, ax))
    summary = trace_cell(cfg, shape, mesh, ax,
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
        # the head counts the cell ran (padded where the model axis does
        # not divide them)
        "run_heads": [run.num_heads, run.num_kv_heads],
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


def all_cells(archs=None, shapes=None, meshes=("single", "multi")):
    """(arch, shape, multi) of every cell of the reference's ``--all``:
    each arch × its ``runnable_shapes`` × the meshes."""
    out = []
    for arch in (archs or all_arch_names()):
        cfg = get_config(arch)
        for shape_name in (shapes or runnable_shapes(cfg)):
            if shape_name in runnable_shapes(cfg):
                out.extend((arch, shape_name, m == "multi") for m in meshes)
    return out


def run_all(archs=None, shapes=None, meshes=("single", "multi"),
            force: bool = False, jobs: int | None = None) -> list[dict]:
    """Every cell (:func:`all_cells`) through :func:`run_cells`, ``jobs``
    at a time; cached artifacts are reused unless ``force``."""
    cells = all_cells(archs, shapes, meshes)
    todo = [c for c in cells if force or not os.path.exists(cell_path(*c))]
    run_cells(todo, jobs)
    results = []
    for c in cells:
        with open(cell_path(*c)) as f:
            results.append(json.load(f))
    return results


def run_cells(cells, jobs: int | None = None, *,
              timeout: float | None = None) -> list[dict]:
    """Each ``(arch, shape, multi)`` cell by this module's CLI in a process
    of its own (a fake world needs one), ``jobs`` at a time (the CPU count
    by default), each killed past ``timeout`` seconds; returns the cells'
    artifacts in order, each with its process's wall time as ``wall_s``.
    A process that leaves no artifact gives a cell with an ``error`` (its
    exit code and the tail of its standard error)."""
    import sys

    paths = [cell_path(*c) for c in cells]
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--mesh",
             "multi" if multi else "single"]
            for arch, shape_name, multi in cells]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = []
    for (arch, shape_name, multi), path, (rc, _, err, wall) in zip(
            cells, paths, run_processes(cmds, jobs, timeout=timeout,
                                        env=env)):
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        else:
            res = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if multi else "16x16",
                   "error": f"the cell's process exited {rc} with no "
                            f"artifact: {err[-2000:]}"}
        res["wall_s"] = round(wall, 2)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        log.info(f"{arch} × {shape_name} × {res['mesh']}: "
                 f"{'FAILED' if 'error' in res else 'ok'} in "
                 f"{res['wall_s']} s")
        out.append(res)
    return out


def run_processes(cmds, jobs: int | None = None, *,
                  timeout: float | None = None, env=None, cwd=None) -> list:
    """Run each command (an argument list) as a process, ``jobs`` at a time
    (the CPU count by default); returns each one's ``(exit code, standard
    output, standard error, wall seconds)`` in order.  A process still
    running ``timeout`` seconds after its start is killed (its exit code is
    then the kill's)."""
    import subprocess
    import tempfile

    jobs = max(1, jobs or os.cpu_count() or 1)
    pending, running = list(enumerate(cmds)), {}
    done: dict[int, tuple] = {}
    try:
        while pending or running:
            while pending and len(running) < jobs:
                i, cmd = pending.pop(0)
                so, se = tempfile.TemporaryFile(), tempfile.TemporaryFile()
                proc = subprocess.Popen(cmd, stdout=so, stderr=se, env=env,
                                        cwd=cwd)
                running[proc] = (i, so, se, time.perf_counter())
            time.sleep(0.2)
            for proc, (i, so, se, t0) in list(running.items()):
                if proc.poll() is None:
                    if timeout is None or time.perf_counter() - t0 < timeout:
                        continue
                    proc.kill()
                    proc.wait()
                del running[proc]
                texts = []
                for f in (so, se):
                    f.seek(0)
                    texts.append(f.read().decode(errors="replace"))
                    f.close()
                done[i] = (proc.returncode, *texts, time.perf_counter() - t0)
    finally:
        for proc in running:
            proc.kill()
            proc.wait()
    return [done[i] for i in range(len(cmds))]


def table(results) -> str:
    """A markdown table of the cells, one row an (arch, shape) with its
    16x16 and 2x16x16 cells side by side: rank 0's FLOPs (and their ratio
    to :func:`cell_bounds`' floor, every cell checked against both
    bounds), bytes and wire bytes, the heads run, ``trace_s`` and the
    process's ``wall_s``; a failed cell shows its error."""
    def one(r, key):
        if r is None:
            return ""
        if "error" in r:
            return "error" if key == "flops" else ""
        lo, hi = cell_bounds(r)
        f = r["flops_per_device"]
        return {"flops": f"{f:.4e}{'' if lo <= f <= hi else ' OUT'}",
                "floor": f"{f / lo:.3f}",
                "bytes": f"{r['bytes_accessed_per_device']:.3e}",
                "wire": f"{r['weighted']['total_wire_bytes_per_device']:.3e}",
                "s": f"{r['trace_s']}/{r.get('wall_s', '')}"}[key]

    cells: dict = {}
    for r in results:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    rows = ["| arch | shape | heads | FLOPs/dev 16x16, 2x16x16 | / floor | "
            "bytes/dev | wire bytes/dev | trace_s/wall_s |",
            "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), by in cells.items():
        a, b = by.get("16x16"), by.get("2x16x16")
        ok = next((r for r in (a, b) if r and "error" not in r), None)
        heads = "/".join(map(str, ok.get("run_heads", ()))) if ok else ""
        if ok and not ok.get("batch_sharded", True):
            heads += " (batch whole)"
        pair = [(one(a, k), one(b, k)) for k in ("flops", "floor", "bytes",
                                                "wire", "s")]
        rows.append(f"| {arch} | {shape} | {heads} | "
                    + " | ".join(f"{x}, {y}" for x, y in pair) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--jobs", type=int, default=None,
                    help="--all: cells run at once (default: the CPU count)")
    args = ap.parse_args(argv)

    if args.all:      # every cell on both meshes, as the reference's --all
        res = run_all(archs=[args.arch] if args.arch else None,
                      shapes=[args.shape] if args.shape else None,
                      force=args.force, jobs=args.jobs)
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape (or --all)")
        meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
        res = [_run_and_save(args.arch, args.shape, mk == "multi",
                             fsdp=not args.no_fsdp) for mk in meshes]
    if args.all:
        print(table(res))
    failed = [f"{r['arch']} × {r['shape']} × {r['mesh']}" for r in res
              if "error" in r or not (cell_bounds(r)[0]
                                      <= r["flops_per_device"]
                                      <= cell_bounds(r)[1])]
    if failed:
        raise SystemExit(f"{len(failed)} cell(s) failed: {failed}")


if __name__ == "__main__":
    main()
