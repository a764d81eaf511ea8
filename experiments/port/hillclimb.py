"""Layout hillclimb on the port: run a dry-run cell under a policy / flag
variant, print the three roofline terms next to the baseline cell's.

  PYTHONPATH=src python experiments/port/hillclimb.py <arch> <shape> <variant>

Counterpart of ``experiments/hillclimb.py``: the same twelve variants,
built on ``repro_torch.dist.P`` and ``activation_hint_policy``, each the
keyword arguments of ``repro_torch.launch.dryrun.dryrun_cell`` (a policy
override and the ``fsdp`` / ``fsdp_experts_only`` / ``opt_2d`` /
``cache_seq_shard`` flags).  The cell runs as rank 0 of the 16x16
production mesh over a fake world (``launch.mesh.make_production_mesh``;
no card, no collective moves data).  Results cache under
``experiments/artifacts/dryrun_torch/variants/<arch>_<shape>_single_<variant>.json``
(the artifact names its ``variant``); the baseline is the plain cell of
``python -m repro_torch.launch.dryrun`` (run it first to see ratios).
``launch.dryrun.run_cells`` runs this CLI for its ``(arch, shape, False,
variant)`` cells.

Every variant computes the function of the meshless model; only the
layout, and so the per-device work and traffic, moves.  The roofline
terms divide the cell's per-device FLOPs, bytes and wire bytes by the
NVIDIA H100 SXM5 80GB's datasheet figures at its 700 W power limit: dense
bf16 tensor-core FLOP/s, HBM3 bytes/s and NVLink bytes/s a direction.
They are datasheet figures, not measurements.
"""

from __future__ import annotations

import json
import os
import sys

# NVIDIA H100 SXM5 80GB, 700 W: dense bf16 FLOP/s, HBM3 B/s, NVLink B/s
# a direction (datasheet figures)
PEAK, HBM, LINK = 989e12, 3.35e12, 450e9
CARD = "NVIDIA H100 SXM5 80GB, 700 W (datasheet)"


def terms(d: dict) -> tuple[float, float, float]:
    """Seconds of (compute, memory, collective) a device for a cell."""
    w = d["weighted"]
    return (w["dot_flops_per_device"] / PEAK,
            w["dot_bytes_per_device"] / HBM,
            w["total_wire_bytes_per_device"] / LINK)


def base_policy(cfg, shape, ax) -> dict:
    from repro_torch.dist.sharding import activation_hint_policy

    return dict(activation_hint_policy(cfg, ax, shape))


# ---------------------------------------------------------------------------
# variant registry: name → (description, fn(cfg, shape, ax) -> dryrun kwargs)
# ---------------------------------------------------------------------------

def v_sp_gather(cfg, shape, ax):
    """Megatron-SP: gather activations over 'model' at each sublayer input;
    matmuls then keep weights local (col/row parallel) and the boundary
    constraint reduce-scatters the partial sums."""
    from repro_torch.dist import P

    pol = base_policy(cfg, shape, ax)
    pol["sublayer_input"] = P(ax.batch, None, None)
    return {"policy_override": pol}


def v_no_fsdp(cfg, shape, ax):
    """Replicate params over 'data' (TP-only): kills FSDP weight gathers —
    decode cells are weight-gather-bound; fits when params/16 ≤ HBM."""
    return {"fsdp": False}


def v_sp_and_no_fsdp(cfg, shape, ax):
    kw = v_sp_gather(cfg, shape, ax)
    kw["fsdp"] = False
    return kw


def v_groups_data_only(cfg, shape, ax):
    """MoE dispatch groups over 'data' only (bigger groups, less padding)."""
    from repro_torch.dist import P

    pol = base_policy(cfg, shape, ax)
    pol["moe_groups"] = P(ax.batch, None, None)
    pol["moe_groups4"] = P(ax.batch, None, None, None)
    pol["__moe_groups__"] = shape.global_batch
    return {"policy_override": pol}


def v_qpos_attention(cfg, shape, ax):
    """Attention sharded on QUERY POSITIONS instead of heads: one full-S q
    block with S-over-model sharded queries is padding-free for every
    arch.  K / V are whole along the sequence inside the attention (each
    rank's queries see every key); a decode step's one query cannot split,
    so decode runs in the cache's layout."""
    from repro_torch.dist import P

    pol = base_policy(cfg, shape, ax)
    pol["attn_heads"] = P(ax.batch, ax.model, None, None)   # (B, S, H, hd)
    pol["__attn_q_chunk__"] = "full"
    return {"policy_override": pol}


def v_qpos_sp(cfg, shape, ax):
    from repro_torch.dist import P

    kw = v_qpos_attention(cfg, shape, ax)
    kw["policy_override"]["sublayer_input"] = P(ax.batch, None, None)
    return kw


def v_qpos_kvg(cfg, shape, ax):
    """qpos + gather K/V once per layer (replicated over 'model')."""
    from repro_torch.dist import P

    kw = v_qpos_attention(cfg, shape, ax)
    kw["policy_override"]["attn_kv"] = P(ax.batch, None, None, None)
    return kw


def v_qpos_kvg_sp(cfg, shape, ax):
    from repro_torch.dist import P

    kw = v_qpos_kvg(cfg, shape, ax)
    kw["policy_override"]["sublayer_input"] = P(ax.batch, None, None)
    return kw


def v_qpos_nofsdp(cfg, shape, ax):
    kw = v_qpos_attention(cfg, shape, ax)
    kw["fsdp"] = False
    return kw


def v_qpos_kvg_tponly(cfg, shape, ax):
    """qpos + kv gather + TP-only weights (no FSDP gathers at all); optimizer
    moments stay 2D-sharded (data×model) — one param reshard per step."""
    kw = v_qpos_kvg(cfg, shape, ax)
    kw["fsdp"] = False
    kw["opt_2d"] = True
    return kw


def v_qpos_kvg_expfsdp(cfg, shape, ax):
    """qpos + kvg + FSDP restricted to expert tensors (attention/dense/router
    weights TP-only; experts keep ZeRO-3, which they need to fit)."""
    kw = v_qpos_kvg(cfg, shape, ax)
    kw["fsdp"] = False
    kw["fsdp_experts_only"] = True
    kw["opt_2d"] = True
    return kw


def v_flash_decode(cfg, shape, ax):
    """Flash-decode: KV cache sharded on SEQUENCE over 'model' + TP-only
    weights; each rank attends its key slice and the per-layer collectives
    shrink to (B,H,1)-sized softmax / output partials."""
    from repro_torch.dist import P

    pol = base_policy(cfg, shape, ax)
    pol["attn_heads"] = P(ax.batch, None, None, None)   # q replicated over m
    return {"policy_override": pol, "fsdp": False, "cache_seq_shard": True}


VARIANTS = {
    "sp": ("SP activation gather over model at sublayer inputs", v_sp_gather),
    "nofsdp": ("TP-only params (no FSDP gathers)", v_no_fsdp),
    "sp+nofsdp": ("SP + TP-only", v_sp_and_no_fsdp),
    "moegroups-d": ("MoE groups over data only", v_groups_data_only),
    "qpos": ("attention sharded on query positions (padding-free)",
             v_qpos_attention),
    "qpos+sp": ("qpos attention + SP sublayer inputs", v_qpos_sp),
    "qpos+nofsdp": ("qpos attention + TP-only params", v_qpos_nofsdp),
    "qpos+kvg": ("qpos + one-shot K/V gather per layer", v_qpos_kvg),
    "qpos+kvg+sp": ("qpos + K/V gather + SP inputs", v_qpos_kvg_sp),
    "qpos+kvg+tponly": ("qpos + K/V gather + TP-only weights (2D opt)",
                        v_qpos_kvg_tponly),
    "flashdecode": ("KV cache sharded on sequence + TP-only weights",
                    v_flash_decode),
    "qpos+kvg+expfsdp": ("qpos + kvg + FSDP on experts only",
                         v_qpos_kvg_expfsdp),
}


def variant_kwargs(variant: str, cfg, shape, ax) -> dict:
    """``dryrun_cell`` / ``trace_cell`` keyword arguments of ``variant``
    for a config, a ``ShapeConfig`` and the mesh's ``MeshAxes``.  A variant
    whose knob a cell lacks (MoE groups on a dense model, a query-position
    decode step) runs as the reference's does: the knob is set and changes
    only what the cell has."""
    return VARIANTS[variant][1](cfg, shape, ax)


def applies(variant: str, shape) -> str | None:
    """None where ``variant`` runs on a cell of ``shape``; else why not.
    Flash-decode is a decode step's cache layout: on a prefill or train
    cell its policy asks for queries whole over the model axis, so the
    port runs their attention on every rank of it, where the reference's
    compiler re-splits that attention on heads (its count is the base
    cell's)."""
    if variant == "flashdecode" and shape.kind != "decode":
        return (f"flashdecode applies to decode cells; {shape.name} is a "
                f"{shape.kind} cell")
    return None


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[2] not in VARIANTS:
        raise SystemExit("usage: hillclimb.py <arch> <shape> <variant>; "
                         f"variants: {', '.join(VARIANTS)}")
    arch, shape_name, variant = argv
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_path, dryrun_cell
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.config import SHAPES

    if shape_name not in SHAPES:
        raise SystemExit(f"unknown shape {shape_name!r}; shapes: "
                         f"{', '.join(SHAPES)}")
    why = applies(variant, SHAPES[shape_name])
    if why:
        raise SystemExit(why)
    desc, _ = VARIANTS[variant]
    cfg = get_config(arch)
    base_file = cell_path(arch, shape_name, False)
    base = None
    if os.path.exists(base_file):
        with open(base_file) as f:
            base = json.load(f)
    kw = variant_kwargs(variant, cfg, SHAPES[shape_name], mesh_axes())
    res = dict(dryrun_cell(arch, shape_name, False, verbose=False, **kw),
               variant=variant)
    with open(cell_path(arch, shape_name, False, tag=variant), "w") as f:
        json.dump(res, f, indent=1)

    tc, tm, tx = terms(res)
    print(f"\n=== {arch} × {shape_name} × 16x16 — variant '{variant}' ===")
    print(f"  {desc}")
    print(f"  roofline against the {CARD}: {PEAK:.3g} FLOP/s, "
          f"{HBM:.3g} B/s HBM, {LINK:.3g} B/s link")
    if base and "weighted" in base:
        bc, bm, bx = terms(base)
        print(f"  compute   : {bc*1e3:10.3f} → {tc*1e3:10.3f} ms  "
              f"({tc/bc:5.2f}x)")
        print(f"  memory    : {bm*1e3:10.3f} → {tm*1e3:10.3f} ms  "
              f"({tm/bm:5.2f}x)")
        print(f"  collective: {bx*1e3:10.3f} → {tx*1e3:10.3f} ms  "
              f"({tx/bx if bx else float('inf'):5.2f}x)")
        f0 = bc / max(bc, bm, bx)
        f1 = tc / max(tc, tm, tx)
        print(f"  roofline fraction: {f0:.3f} → {f1:.3f}")
    else:
        print(f"  compute={tc*1e3:.3f}ms memory={tm*1e3:.3f}ms "
              f"collective={tx*1e3:.3f}ms")
    mem = res["memory"]
    temp = mem.get("temp_size_in_bytes")
    print(f"  temp/dev: {'n/a' if temp is None else f'{temp/1e9:.1f} GB'}; "
          f"args/dev: {mem['argument_size_in_bytes']/1e9:.1f} GB")
    return res


if __name__ == "__main__":
    main()
