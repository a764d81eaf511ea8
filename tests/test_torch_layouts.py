"""The dry run's layout variants (``experiments/hillclimb.py`` and its twin
``experiments/port/hillclimb.py``) on the port: every layout computes the
meshless function, and counts what the reference's compiled dry run
counts.

* Numerics.  Smoke deepseek-7b, gemma2-9b (local window, softcap),
  deepseek-v2 (MLA + MoE) and jamba (Mamba / attention / MoE) on a 2x2
  (data, model) mesh of 4 gloo ranks (``_torch_ref.run_ranks``), under
  ``qpos`` (queries split over ``model`` on their positions, K / V whole
  along the sequence inside the attention), ``qpos+kvg`` and
  ``flashdecode`` (the cache split over ``model`` on its sequence, each
  rank's key slice combined by log-sum-exp): the train forward's logits,
  a 16-token prefill into a 24-slot cache (the cache's shards split the
  prompt) and 3 greedy decode steps (positions 16-18, on the second cache
  shard; gemma2's window of 8 reaches back into the first).  The
  reference runs the same layouts on 4 host devices and its meshless run.
* Counts.  The reference's ``dryrun_cell`` on a patched (2, 2) and
  (2, 2, 2) mesh with the smoke configs at the real ``SHAPES`` against the
  port's ``trace_cell`` on ``make_debug_mesh`` of the same shape in a fake
  world of 8, per (arch, shape, variant): ``weighted.dot_flops_per_device``
  equal within ``FLOP_RTOL``.  Wire bytes are reported, not bounded
  (DTensor picks its own collectives), except flash-decode's, held to
  4x the reference's.  On the (2, 2, 2) mesh both sides take the
  variants' batch entries over (pod, data), the multi-pod batch axes.
* The twin runs a variant end to end (``main``) and mirrors the
  reference's twelve variants spec by spec.

Bounds.  Logits within ``atol = rtol = 1e-5`` of the meshless port and of
the reference under the same layout: the sharded partial sums (row-
parallel projections, FSDP contractions, flash-decode's combine) reorder
float32 adds, as GSPMD's do.  Jamba and deepseek-v2 take ``1e-4``
(``TOL``), as in ``test_torch_models.py``: their stacks move past 1e-5
under one float32 rounding of their weights (pinned there by
``test_tolerance_is_of_the_order_of_one_rounding``), and the reference's
own layouts move them 8.6e-5 and 1.2e-5 from its meshless run.  The
fixture's ``gaps.md`` gives each (arch, layout)'s readings (PERF.md §6:
sound runs at most 0.44 of their bound, a flash-decode combine without
its e^(m - M) rescale or a query offset of 0 over 2.2).  Greedy tokens
equal.

``FLOP_RTOL`` is 1e-3.  The dense cells agree exactly.  The gaps inside
it are deepseek-v2's and jamba's small MoE / MLA projections, whose work
DTensor and XLA's partitioner split differently (PERF.md §6, the layouts:
with FSDP, DTensor splits the MLA down-projections and the router over
``model``, where the reference replicates them: 1081344 FLOPs of
1826783232).
"""

import concurrent.futures
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

from _torch_ref import REPO, run_ranks, run_reference

from repro_torch.configs import get_smoke_config
from repro_torch.dist.sharding import padded_config
from repro_torch.launch.dryrun import flop_bounds, run_processes
from repro_torch.models.config import SHAPES

ATOL = RTOL = 1e-5
TOL = {"jamba_v0_1_52b": 1e-4, "deepseek_v2_236b": 1e-4}
FLOP_RTOL = 1e-3

HILLCLIMB = REPO / "experiments" / "port" / "hillclimb.py"


def _twin():
    spec = importlib.util.spec_from_file_location("port_hillclimb",
                                                  HILLCLIMB)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# numerics: 4 gloo ranks on a 2x2 mesh against the meshless port and the
# reference on 4 host devices
# ---------------------------------------------------------------------------

ARCHS = ["deepseek_7b", "gemma2_9b", "deepseek_v2_236b", "jamba_v0_1_52b"]
LAYOUTS = ["qpos", "qpos+kvg", "flashdecode"]
B, S, SMAX, STEPS = 4, 16, 24, 3
OUTPUTS = ["forward", "prefill"] + [f"decode{t}" for t in range(STEPS)]

# the shape whose policy a step runs under: the forward is a train step's
KIND_SHAPE = {"forward": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}

REF_NUMERICS = f'''
import jax, jax.numpy as jnp
sys.path.insert(0, "experiments")
import hillclimb as hc
from repro.configs import get_smoke_config
from repro.dist.hints import sharding_policy
from repro.dist.sharding import (activation_hint_policy, batch_pspec,
                                 cache_pspecs, named, param_pspecs)
from repro.launch.mesh import mesh_axes
from repro.models import decode_step, logits_fn, prefill_step
from repro.models.config import SHAPES, ShapeConfig
from repro.models.model import param_shapes

ARCHS, LAYOUTS, KIND_SHAPE = {ARCHS!r}, {LAYOUTS!r}, {KIND_SHAPE!r}
B, S, SMAX, STEPS = {B}, {S}, {SMAX}, {STEPS}
mesh = jax.make_mesh((2, 2), ("data", "model"))
ax = mesh_axes()
out = {{}}

def run(cfg, params, toks, v, key):
    """forward, prefill, STEPS greedy decode steps; under layout v on the
    mesh, or meshless (v None)."""
    def layout(kind):
        if v is None:
            return None, None, None, False
        kw = hc.VARIANTS[v][1](cfg.name.replace("-smoke", ""),
                               KIND_SHAPE[kind])
        pol = dict(kw.get("policy_override") or activation_hint_policy(
            cfg, ax, SHAPES[KIND_SHAPE[kind]]))
        pol["__mesh__"] = mesh
        p_sh = named(mesh, param_pspecs(cfg, ax, fsdp=kw.get("fsdp", True)))
        return pol, p_sh, named(mesh, batch_pspec(ax)), \\
            kw.get("cache_seq_shard", False)

    def under(pol):
        import contextlib
        st = contextlib.ExitStack()
        if pol is not None:
            st.enter_context(jax.set_mesh(mesh))
            st.enter_context(sharding_policy(pol))
        return st

    pol, p_sh, b_sh, _ = layout("forward")
    ps = params if p_sh is None else jax.device_put(params, p_sh)
    shard = {{}} if p_sh is None else dict(in_shardings=(p_sh, b_sh))
    with under(pol):
        lg, _ = jax.jit(lambda p, t: logits_fn(p, t, cfg), **shard)(ps, toks)
    out[key + "|forward"] = np.asarray(lg)
    pol, p_sh, b_sh, seq = layout("prefill")
    c_sh = None if pol is None else named(mesh, cache_pspecs(
        cfg, ax, ShapeConfig("t", "decode", SMAX, B), seq_shard=seq))
    ps = params if p_sh is None else jax.device_put(params, p_sh)
    shard = {{}} if p_sh is None else dict(in_shardings=(p_sh, b_sh),
                                          out_shardings=(None, c_sh))
    with under(pol):
        lp, caches = jax.jit(lambda p, t: prefill_step(p, t, cfg, SMAX),
                             **shard)(ps, toks)
    out[key + "|prefill"] = np.asarray(lp)
    pol, p_sh, b_sh, _ = layout("decode")
    shard = {{}} if p_sh is None else dict(
        in_shardings=(p_sh, c_sh, b_sh, None), out_shardings=(None, c_sh))
    step = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg),
                   **shard)
    lg, gen = lp, []
    for t in range(STEPS):
        nxt = np.asarray(jnp.argmax(lg, axis=-1)).astype(np.int32)
        gen.append(nxt)
        with under(pol):
            lg, caches = step(ps, caches, nxt[:, None], jnp.int32(S + t))
        out[key + f"|decode{{t}}"] = np.asarray(lg)
    out[key + "|greedy"] = np.stack(gen, 1)

for i, arch in enumerate(ARCHS):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(300 + i)
    params = rand_tree(param_shapes(cfg), rng)
    flat_tree(params, arch, out)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out[arch + "|tokens"] = toks
    run(cfg, params, toks, None, arch + "|plain")
    for v in LAYOUTS:
        run(cfg, params, toks, v, f"{{arch}}|{{v}}")
np.savez(OUT, **out)
'''

PORT_NUMERICS = f'''
import contextlib, importlib.util
from _torch_ref import unflatten
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.dist.hints import sharding_policy
from repro_torch.dist.sharding import (batch_pspec, model_axis_size, named,
                                       pad_params, reshard_tree)
from repro_torch.launch.dryrun import _params_module, step_layout
from repro_torch.launch.mesh import make_debug_mesh, mesh_axes
from repro_torch.models import (decode_step, init_cache, logits_fn,
                                params_from_reference, prefill_step)
from repro_torch.models.config import SHAPES, ShapeConfig

spec = importlib.util.spec_from_file_location("hc", HILLCLIMB)
hc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hc)
ARCHS, LAYOUTS, KIND_SHAPE = {ARCHS!r}, {LAYOUTS!r}, {KIND_SHAPE!r}
B, S, SMAX, STEPS = {B}, {S}, {SMAX}, {STEPS}
ref = dict(np.load(REF))
mesh = make_debug_mesh((2, 2), device="cpu")
ax = mesh_axes()

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def run(cfg, params, toks, v, key):
    def layout(kind):
        """The step's context, parameters, tokens and cache layout."""
        st = contextlib.ExitStack()
        st.enter_context(torch.no_grad())
        if v is None:
            return st, params, toks, None
        name = KIND_SHAPE[kind]
        shape = ShapeConfig(name, SHAPES[name].kind, SMAX, B)
        pol, specs = step_layout(cfg, shape, mesh, ax,
                                 **hc.variant_kwargs(v, cfg, shape, ax))
        st.enter_context(implicit_replication())
        st.enter_context(sharding_policy(pol))
        # a mesh's parameters as a replica places them: Mamba's in_proj
        # columns reordered so each rank's shard holds its u and its z
        tree = pad_params({{n: p.detach() for n, p
                            in params.named_parameters()}}, cfg,
                          model_axis_size(mesh, ax))
        placed = reshard_tree(tree, named(mesh, specs["params"]))
        return (st, _params_module(cfg, placed, requires_grad=False),
                reshard_tree(toks, named(mesh, specs["batch"])),
                named(mesh, specs["caches"]))

    st, p, tk, _ = layout("forward")
    with st:
        lg, _ = logits_fn(p, tk, cfg)
        RESULT[key + "|forward"] = whole(lg).numpy()
    st, p, tk, c_sh = layout("prefill")
    with st:
        caches = init_cache(cfg, B, SMAX, device="cpu")
        if c_sh is not None:
            caches = reshard_tree(caches, c_sh)
        lp, caches = prefill_step(p, tk, cfg, caches=caches)
        RESULT[key + "|prefill"] = whole(lp).numpy()
    st, p, tk, _ = layout("decode")
    lg, gen = whole(lp), []
    with st:
        for t in range(STEPS):
            nxt = lg.argmax(-1).to(torch.int32)
            gen.append(nxt.numpy())
            tok = nxt[:, None]
            if v is not None:
                tok = reshard_tree(tok, named(mesh, batch_pspec(ax)))
            lg, caches = decode_step(p, caches, tok, S + t, cfg)
            lg = whole(lg)
            RESULT[key + f"|decode{{t}}"] = lg.numpy()
    RESULT[key + "|greedy"] = np.stack(gen, 1)

for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = params_from_reference(cfg, unflatten(ref, arch), device="cpu")
    toks = torch.as_tensor(ref[arch + "|tokens"])
    run(cfg, params, toks, None, arch + "|plain")
    for v in LAYOUTS:
        run(cfg, params, toks, v, f"{{arch}}|{{v}}")
'''


# ---------------------------------------------------------------------------
# counts: the reference's compiled dry run against the port's trace
# ---------------------------------------------------------------------------

ALL = ["base", "sp", "nofsdp", "sp+nofsdp", "moegroups-d", "qpos",
       "qpos+sp", "qpos+nofsdp", "qpos+kvg", "qpos+kvg+sp",
       "qpos+kvg+tponly", "flashdecode", "qpos+kvg+expfsdp"]
DECODE = ["base", "nofsdp", "qpos", "flashdecode"]
CELLS = (
    [("deepseek-7b", "decode_32k", v, False) for v in ALL
     if v != "moegroups-d"]
    + [("deepseek-7b", "prefill_32k", v, False)
       for v in ("base", "nofsdp", "qpos", "qpos+sp", "qpos+kvg")]
    + [("deepseek-7b", "train_4k", v, False)
       for v in ("base", "qpos", "qpos+kvg+tponly")]
    + [("deepseek-v2-236b", "decode_32k", v, False)
       for v in DECODE + ["moegroups-d", "qpos+kvg+expfsdp"]]
    + [("arctic-480b", "decode_32k", "flashdecode", False)]
    + [(a, "decode_32k", v, False)
       for a in ("jamba-v0.1-52b", "falcon-mamba-7b")
       for v in ("base", "qpos", "flashdecode")]
    + [("deepseek-7b", "decode_32k", v, True)
       for v in ("base", "qpos", "flashdecode")]
    + [("deepseek-7b", "prefill_32k", v, True) for v in ("base", "qpos+kvg")]
    + [("deepseek-7b", "train_4k", v, True)
       for v in ("base", "qpos+kvg+tponly")]
    + [(a, "decode_32k", v, True)
       for a in ("deepseek-v2-236b", "jamba-v0.1-52b")
       for v in ("base", "flashdecode")]
    + [("falcon-mamba-7b", "decode_32k", "base", True),
       ("arctic-480b", "decode_32k", "flashdecode", True)])
# the reference cannot lay out arctic's one KV head over a model axis of 2
# (its cache's in_shardings must divide the head dim; the port pads)
UNEVEN = [("arctic-480b", "decode_32k", v, m)
          for m in (False, True) for v in ("base", "qpos")]


def _key(cell) -> str:
    arch, shape, v, multi = cell
    return f"{arch}|{shape}|{v}|{'2x2x2' if multi else '2x2'}"


REF_COUNTS = '''
import json
from jax.sharding import PartitionSpec as JP
sys.path.insert(0, "experiments")
import hillclimb as hc
import repro.launch.dryrun as dr
from repro.configs import get_smoke_config
from repro.launch.mesh import mesh_axes

dr.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 2, 2) if multi_pod else (2, 2),
    ("pod", "data", "model") if multi_pod else ("data", "model"))
dr.get_config = get_smoke_config

def kwargs(arch, shape, v, multi):
    """The reference's variant; on the multi-pod mesh its batch entries
    over (pod, data), as the port's twin lays them out there."""
    if v == "base":
        return {}
    hc.mesh_axes = lambda **_: mesh_axes(multi_pod=multi)
    kw = hc.VARIANTS[v][1](arch, shape)
    pol = kw.get("policy_override")
    if multi and pol:
        for site in ("attn_heads", "attn_kv", "sublayer_input",
                     "moe_groups", "moe_groups4"):
            if site in pol and pol[site][0] == "data":
                pol[site] = JP(("pod", "data"), *pol[site][1:])
    return kw

res = {}
for arch, shape, v, multi in CELLS:
    key = f"{arch}|{shape}|{v}|{'2x2x2' if multi else '2x2'}"
    try:
        r = dr.dryrun_cell(arch, shape, multi, verbose=False,
                           **kwargs(arch, shape, v, multi))
        res[key] = [r["weighted"]["dot_flops_per_device"],
                    r["weighted"]["total_wire_bytes_per_device"]]
    except Exception as e:
        res[key] = f"{type(e).__name__}: {str(e)[:300]}"

def spec_json(x):
    if isinstance(x, JP):
        return [list(e) if isinstance(e, tuple) else e for e in x]
    return x

# the reference's variants on deepseek-7b, spec by spec (single pod)
hc.mesh_axes = mesh_axes
twins = {}
for shape in ("decode_32k", "prefill_32k", "train_4k"):
    for v, (_, fn) in hc.VARIANTS.items():
        kw = fn("deepseek-7b", shape)
        if "policy_override" in kw:
            kw["policy_override"] = {k: spec_json(s) for k, s
                                     in kw["policy_override"].items()}
        twins[f"{shape}|{v}"] = kw
np.savez(OUT, res=np.array(json.dumps(res)),
         twins=np.array(json.dumps(twins)))
'''

PORT_COUNTS = '''
import importlib.util, json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import (init_fake_world, make_debug_mesh,
                                     mesh_axes)
from repro_torch.models.config import SHAPES

spec = importlib.util.spec_from_file_location("hc", sys.argv[1])
hc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hc)
init_fake_world(8)
res = {}
for arch, shape, v, multi in json.loads(sys.argv[2]):
    ax = mesh_axes(multi_pod=multi)
    mesh = make_debug_mesh((2, 2, 2) if multi else (2, 2),
                           ("pod", "data", "model") if multi
                           else ("data", "model"), device="cpu")
    cfg = get_smoke_config(arch)
    kw = {} if v == "base" else hc.variant_kwargs(v, cfg, SHAPES[shape], ax)
    r = trace_cell(cfg, SHAPES[shape], mesh, ax, **kw)
    res[f"{arch}|{shape}|{v}|{'2x2x2' if multi else '2x2'}"] = {
        "flops": r["weighted"]["dot_flops_per_device"],
        "wire": r["weighted"]["total_wire_bytes_per_device"],
        "run_heads": r["run_heads"],
        "batch_sharded": r["batch_sharded"]}
print(json.dumps(res))
'''

# the twin's CLI on a smoke config at the 16x16 production mesh
HILLCLIMB_RUN = '''
import runpy, sys
import repro_torch.configs as configs
import repro_torch.launch.dryrun as dryrun
configs.get_config = dryrun.get_config = configs.get_smoke_config
dryrun.ARTIFACT_DIR = sys.argv[1]
sys.argv = ["hillclimb.py", "deepseek-7b", "decode_32k", "flashdecode"]
runpy.run_path(HC, run_name="__main__")
'''


def _port_groups():
    """The port's cells, split into three fake-world processes of about
    equal work (train and prefill cells take seconds each)."""
    cells = CELLS + UNEVEN
    heavy = [c for c in cells if c[1] != "decode_32k"]
    light = [c for c in cells if c[1] == "decode_32k"]
    return [heavy[0::2], heavy[1::2], light]


def count_table(ref: dict, port: dict) -> str:
    """Markdown: each count cell's FLOPs and wire bytes a device, the
    reference's against the port's."""
    rows = ["| cell (smoke) | reference FLOPs / wire B | port FLOPs / wire B "
            "| FLOP gap | wire ratio |", "|---|---|---|---|---|"]
    for c in CELLS + UNEVEN:
        key = _key(c)
        r, p = ref[key], port[key]
        pf, pw = int(p["flops"]), int(p["wire"])
        if isinstance(r, str):
            rows.append(f"| {key} | {r.split(':')[0]} (refused) | "
                        f"{pf} / {pw} | | |")
            continue
        rf, rw = int(r[0]), int(r[1])
        gap = "0" if pf == rf else f"{pf - rf:+d} ({(pf - rf) / rf:+.2e})"
        rows.append(f"| {key} | {rf} / {rw} | {pf} / {pw} | {gap} | "
                    f"{pw / rw:.2f} |")
    return "\n".join(rows) + "\n"


def _gap(a, b) -> tuple[float, float]:
    """The largest ``|a - b|`` over the outputs, and the least ``t`` at
    which ``assert_allclose(a, b, atol=t, rtol=t)`` passes (the largest
    ``|a - b| / (1 + |b|)``)."""
    d = [np.abs(a[o] - b[o]) for o in OUTPUTS]
    t = [x / (1 + np.abs(b[o])) for x, o in zip(d, OUTPUTS)]
    return max(float(x.max()) for x in d), max(float(x.max()) for x in t)


def gap_table(port: dict, ref: dict) -> str:
    """Markdown: each (arch, layout)'s largest logit gap over forward,
    prefill and the decode steps, against the meshless port and against
    the reference's same layout (the reference's own layout against its
    meshless run beside them)."""
    def sub(d, arch, name):
        return {o: d[f"{arch}|{name}|{o}"] for o in OUTPUTS}

    rows = ["| arch | layout | bound | vs meshless port: max abs, least t "
            "| vs reference layout | reference layout vs its meshless |",
            "|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for v in LAYOUTS:
            cols = [_gap(sub(port, arch, v), sub(port, arch, "plain")),
                    _gap(sub(port, arch, v), sub(ref, arch, v)),
                    _gap(sub(ref, arch, v), sub(ref, arch, "plain"))]
            rows.append(f"| {arch} | {v} | {TOL.get(arch, ATOL):g} | "
                        + " | ".join(f"{m:.3e}, {t:.3e}" for m, t in cols)
                        + " |")
    return "\n".join(rows) + "\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything this module compares, started at once: the reference's
    counts (one subprocess on 8 host devices), the port's counts (fake
    worlds) and the twin's CLI, while the numerics run (the reference's
    layouts on 4 host devices, then the port's on 4 gloo ranks, which
    load its parameters).  It writes :func:`count_table` and
    :func:`gap_table` as ``counts.md`` and ``gaps.md`` to its directory
    (``pytest --basetemp DIR``: ``DIR/layouts0/``)."""
    tmp = tmp_path_factory.mktemp("layouts")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    groups = _port_groups()
    cmds = [[sys.executable, "-c", PORT_COUNTS, str(HILLCLIMB),
             json.dumps(g)] for g in groups]
    (tmp / "art").mkdir()
    (tmp / "ranks").mkdir()
    cmds.append([sys.executable, "-c",
                 f"HC = {str(HILLCLIMB)!r}\n" + HILLCLIMB_RUN,
                 str(tmp / "art")])
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        counts = pool.submit(
            run_reference, f"CELLS = {CELLS + UNEVEN!r}\n" + REF_COUNTS,
            tmp / "counts.npz", 900, devices=8, shims=True)
        port = pool.submit(run_processes, cmds, len(cmds), timeout=900,
                           env=env, cwd=REPO)
        ref_num = run_reference(REF_NUMERICS, tmp / "numerics.npz", 900,
                                devices=4, shims=True)
        ranks = run_ranks(f"REF = {str(tmp / 'numerics.npz')!r}\n"
                          f"HILLCLIMB = {str(HILLCLIMB)!r}\n"
                          + PORT_NUMERICS, 4, tmp / "ranks", timeout=600)
        ref_counts, port_out = counts.result(), port.result()
    port_counts = {}
    for rc, out, err, _ in port_out[:len(groups)]:
        assert rc == 0 and out.strip(), err[-4000:]
        port_counts.update(json.loads(out.strip().splitlines()[-1]))
    counts = json.loads(str(ref_counts["res"]))
    # the readings behind the bounds, written before any test holds them
    (tmp / "counts.md").write_text(count_table(counts, port_counts))
    (tmp / "gaps.md").write_text(gap_table(ranks[0], ref_num))
    return {"ref_num": ref_num, "ranks": ranks, "ref_counts": counts,
            "twins": json.loads(str(ref_counts["twins"])),
            "port_counts": port_counts, "cli": port_out[-1],
            "art": tmp / "art", "tables": tmp}


def _tol(arch):
    return dict(atol=TOL.get(arch, ATOL), rtol=TOL.get(arch, RTOL))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_computes_the_meshless_port(arch, layout, runs):
    """Every rank's logits, prefill through three decode steps, within the
    bound of the meshless port's; greedy tokens equal; the ranks agree."""
    ranks = runs["ranks"]
    r = ranks[0]
    for out in OUTPUTS:
        np.testing.assert_allclose(r[f"{arch}|{layout}|{out}"],
                                   r[f"{arch}|plain|{out}"],
                                   err_msg=out, **_tol(arch))
    np.testing.assert_array_equal(r[f"{arch}|{layout}|greedy"],
                                  r[f"{arch}|plain|greedy"])
    for other in ranks[1:]:
        for out in OUTPUTS + ["greedy"]:
            np.testing.assert_array_equal(other[f"{arch}|{layout}|{out}"],
                                          r[f"{arch}|{layout}|{out}"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_computes_the_reference_layout(arch, layout, runs):
    """The port's layout against the reference's same layout on 4 host
    devices: logits within the bound, greedy tokens equal."""
    r, ref = runs["ranks"][0], runs["ref_num"]
    for out in OUTPUTS:
        np.testing.assert_allclose(r[f"{arch}|{layout}|{out}"],
                                   ref[f"{arch}|{layout}|{out}"],
                                   err_msg=out, **_tol(arch))
    np.testing.assert_array_equal(r[f"{arch}|{layout}|greedy"],
                                  ref[f"{arch}|{layout}|greedy"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_reference_layout_computes_its_meshless_function(arch, layout, runs):
    """The reference under the layout against its own meshless run, and
    its meshless run against the port's: what the port is held to is the
    one function both compute."""
    ref, r = runs["ref_num"], runs["ranks"][0]
    for out in OUTPUTS:
        np.testing.assert_allclose(ref[f"{arch}|{layout}|{out}"],
                                   ref[f"{arch}|plain|{out}"],
                                   err_msg=out, **_tol(arch))
        np.testing.assert_allclose(r[f"{arch}|plain|{out}"],
                                   ref[f"{arch}|plain|{out}"],
                                   err_msg=out, **_tol(arch))
    np.testing.assert_array_equal(ref[f"{arch}|{layout}|greedy"],
                                  ref[f"{arch}|plain|greedy"])


@pytest.mark.parametrize("cell", CELLS, ids=[_key(c) for c in CELLS])
def test_dot_flops_equal_the_reference_dry_run(cell, runs):
    key = _key(cell)
    ref = runs["ref_counts"][key]
    port = runs["port_counts"][key]
    assert not isinstance(ref, str), ref
    rel = abs(port["flops"] - ref[0]) / ref[0]
    assert rel <= FLOP_RTOL, (port["flops"], ref[0], rel)
    assert port["wire"] > 0


@pytest.mark.parametrize("cell", UNEVEN, ids=[_key(c) for c in UNEVEN])
def test_uneven_heads_are_the_references_limit_not_the_ports(cell, runs):
    """Arctic's smoke cells whose layout splits its one KV head over a
    model axis of 2: the reference refuses them (its cache's shardings
    must divide the dim); the port runs the padded heads, its count
    inside the config's FLOP bounds."""
    arch, shape, _, multi = cell
    ref = runs["ref_counts"][_key(cell)]
    assert isinstance(ref, str) and "sharding" in ref, ref
    port = runs["port_counts"][_key(cell)]
    cfg = padded_config(get_smoke_config(arch), 2)
    assert port["run_heads"] == [cfg.num_heads, cfg.num_kv_heads] == [8, 2]
    n = 8 if multi else 4
    lo, hi = flop_bounds(cfg, SHAPES[shape], n, n // 2,
                         port["batch_sharded"])
    assert lo <= port["flops"] <= hi


@pytest.mark.parametrize("multi", [False, True], ids=["2x2", "2x2x2"])
def test_flash_decode_moves_softmax_partials_not_the_cache(multi, runs):
    """Flash-decode's collectives are the (B, H, 1)- and (B, H, d)-sized
    partials: the port's wire bytes a device within 4x the reference's
    (gathering the sequence-split cache every layer moved 6600x)."""
    key = _key(("deepseek-7b", "decode_32k", "flashdecode", multi))
    ref = runs["ref_counts"][key][1]
    assert runs["port_counts"][key]["wire"] <= 4 * ref


def test_twin_variants_mirror_the_reference_spec_by_spec(runs):
    twin = _twin()
    from repro_torch.launch.mesh import mesh_axes

    ref = runs["twins"]
    assert sorted(twin.VARIANTS) == sorted({k.split("|")[1] for k in ref})
    cfg = get_smoke_config("deepseek-7b")
    for key, want in ref.items():
        shape, v = key.split("|")
        got = twin.variant_kwargs(v, cfg, SHAPES[shape], mesh_axes())
        if "policy_override" in got:
            got["policy_override"] = {
                k: [list(e) if isinstance(e, tuple) else e for e in s]
                if isinstance(s, tuple) else s
                for k, s in got["policy_override"].items()}
        assert got == want, key


def test_twin_cli_runs_a_variant_end_to_end(runs):
    """``hillclimb.py deepseek-7b decode_32k flashdecode`` (the smoke
    config) on the 16x16 production mesh of a fake world: the three
    roofline terms against the H100's named datasheet figures, temp
    memory "n/a", the artifact under the variant's tag."""
    rc, out, err, _ = runs["cli"]
    assert rc == 0, err[-4000:]
    assert "variant 'flashdecode'" in out
    assert "NVIDIA H100 SXM5 80GB, 700 W (datasheet)" in out
    assert "9.89e+14 FLOP/s" in out and "3.35e+12 B/s HBM" in out
    assert "compute=" in out and "collective=" in out
    assert "temp/dev: n/a" in out
    art = (runs["art"] / "variants"
           / "deepseek-7b_decode_32k_single_flashdecode.json")
    cell = json.loads(art.read_text())
    assert cell["num_devices"] == 256 and cell["fsdp"] is False
    assert cell["variant"] == "flashdecode"


def test_twin_refuses_flash_decode_off_decode_cells():
    twin = _twin()
    with pytest.raises(SystemExit, match="flashdecode applies to decode"):
        twin.main(["deepseek-7b", "train_4k", "flashdecode"])
    with pytest.raises(SystemExit, match="usage"):
        twin.main(["deepseek-7b", "decode_32k", "nosuchvariant"])


def test_tables_hold_every_cell_and_layout(runs):
    """The fixture's tables: a row for each count cell and each (arch,
    layout), every gap finite."""
    counts = (runs["tables"] / "counts.md").read_text().splitlines()
    assert [r.split(" | ")[0][2:] for r in counts[2:]] == \
        [_key(c) for c in CELLS + UNEVEN]
    gaps = (runs["tables"] / "gaps.md").read_text().splitlines()[2:]
    assert [tuple(r.split(" | ")[:2]) for r in gaps] == \
        [(f"| {a}", v) for a in ARCHS for v in LAYOUTS]
    for r in gaps:
        nums = [float(x) for x in re.findall(r"\d\.\d+e[-+]\d+", r)]
        assert len(nums) == 6 and np.isfinite(nums).all(), r


def test_variant_artifacts_stay_out_of_the_registry(tmp_path, monkeypatch):
    """A variant's artifact lies in ``variants/`` below the base cells, so
    ``CostModelRegistry.load_dir`` keys (arch, kind, mesh) to the base
    cell's costs whatever variants ran."""
    from repro_torch.launch import dryrun
    from repro_torch.sched_integration import CostModelRegistry

    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    base = {"arch": "deepseek-7b", "shape": "decode_32k", "mesh": "16x16",
            "flops_per_device": 1.0, "bytes_accessed_per_device": 2.0,
            "collectives": {"total_wire_bytes_per_device": 3.0}}
    for tag, flops in (("", 1.0), ("nofsdp", 5.0), ("qpos", 7.0)):
        path = dryrun.cell_path("deepseek-7b", "decode_32k", False, tag=tag)
        assert (os.path.dirname(path) == str(tmp_path)) == (not tag)
        with open(path, "w") as f:
            json.dump(dict(base, flops_per_device=flops,
                           **({"variant": tag} if tag else {})), f)
    reg = CostModelRegistry()
    assert reg.load_dir(str(tmp_path)) == 1
    assert reg.cell("deepseek-7b", "decode", (16, 16)).flops_per_device == 1.0


def test_run_cells_runs_variant_cells_by_the_twin(tmp_path, monkeypatch):
    """``run_cells`` gives a base cell the dry run's CLI and an ``(arch,
    shape, False, variant)`` cell the twin's, and reads each back from its
    own artifact; a multi-pod variant cell is refused."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    seen = []

    def fake(cmds, jobs, *, timeout=None, env=None):
        seen.extend(cmds)
        for cmd in cmds:
            if cmd[1] == dryrun.HILLCLIMB:
                arch, shape, v = cmd[2:]
                path, res = dryrun.cell_path(arch, shape, False, tag=v), \
                    {"arch": arch, "shape": shape, "variant": v}
            else:
                arch, shape = cmd[cmd.index("--arch") + 1], \
                    cmd[cmd.index("--shape") + 1]
                path, res = dryrun.cell_path(arch, shape, False), \
                    {"arch": arch, "shape": shape}
            with open(path, "w") as f:
                json.dump(dict(res, mesh="16x16"), f)
        return [(0, "", "", 0.5)] * len(cmds)

    monkeypatch.setattr(dryrun, "run_processes", fake)
    out = dryrun.run_cells([("deepseek-7b", "decode_32k", False),
                            ("deepseek-7b", "decode_32k", False, "qpos")])
    assert seen[0][1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert seen[1] == [sys.executable, str(HILLCLIMB), "deepseek-7b",
                       "decode_32k", "qpos"]
    assert "variant" not in out[0] and out[1]["variant"] == "qpos"
    assert out[0]["wall_s"] == out[1]["wall_s"] == 0.5
    with pytest.raises(ValueError, match="single-pod"):
        dryrun.run_cells([("deepseek-7b", "decode_32k", True, "qpos")])
