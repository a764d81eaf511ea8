"""The port's dry run (``launch/{specs,cost_analysis,dryrun}.py``) and
``make_production_mesh``, on the CPU.

* ``input_specs`` gives the shapes and dtypes of the reference's
  ``ShapeDtypeStruct`` s for all ten configs and their runnable shapes
  (the caches in the port's layout: one tensor a leaf name, stacked over
  the layers that have it);
  ``runnable_shapes`` and ``opt_config_for`` equal the reference's (one
  reference subprocess, ``_torch_ref.run_reference``).
* ``collective_stats`` golden values mirror ``test_serve_sharded.py``'s:
  the same result bytes give the same ring wire bytes.
* In a ``fake`` world of 8 ranks (a subprocess: a fake world cannot share
  a process with a real one), every arch's smoke config and every one of
  its runnable shapes (train included) on 1x1, 2x2 and 2x4 meshes: no
  cell fails, rank 0's FLOPs never grow with the mesh (nor its bytes, for
  deepseek-7b's decode and prefill), and the 1x1 mesh counts the FLOPs of
  a one-device run.  The model axis of 4 leaves most smoke configs' heads
  uneven, so those cells run padded heads.
* The recorder counts the same ops, FLOPs and bytes on ``meta`` stand-ins
  as on the real CPU step, at a smoke shape.
* ``make_production_mesh`` builds the reference's shapes and axis names,
  and a production ``dryrun_cell`` artifact (``cell_path``) round-trips
  through ``CostModelRegistry.load_dir``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_ref import REPO, run_reference

from repro_torch.configs import all_arch_names, get_config, get_smoke_config
from repro_torch.dist.hints import sharding_policy
from repro_torch.launch.cost_analysis import (CostRecorder, OpRecord,
                                              collective_stats,
                                              summarize_step)
from repro_torch.launch.dryrun import run_processes, trace_cell
from repro_torch.launch.specs import (input_specs, opt_config_for,
                                      runnable_shapes)
from repro_torch.models import init_params
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.model import decode_step, init_cache, prefill_step

ARCHS = all_arch_names()

SPECS_SCRIPT = """
import json
from repro.configs import all_arch_names, get_config
from repro.launch.specs import input_specs, opt_config_for, runnable_shapes
from repro.models.config import SHAPES

def flat(tree, prefix, out):
    if isinstance(tree, dict):
        tree = {str(k): v for k, v in tree.items()}
    elif isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    else:
        out[prefix] = [list(tree.shape), str(tree.dtype)]
        return out
    for k, v in tree.items():
        flat(v, prefix + '|' + k if prefix else k, out)
    return out

res = {}
for arch in all_arch_names():
    cfg = get_config(arch)
    oc = opt_config_for(cfg)
    shapes = runnable_shapes(cfg)
    res[arch] = {'shapes': shapes,
                 'opt': [oc.learning_rate, oc.weight_decay, oc.moment_dtype],
                 'inputs': {s: flat(input_specs(cfg, SHAPES[s]), '', {})
                            for s in shapes}}
np.savez(OUT, specs=np.array(json.dumps(res)))
"""


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.npz"
    return json.loads(str(run_reference(SPECS_SCRIPT, out)["specs"]))


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}|{k}" if prefix else k, out)
    else:
        assert tree.device.type == "meta"
        out[prefix] = [list(tree.shape), str(tree.dtype).split(".")[-1]]
    return out


def _regroup(ref: dict) -> dict:
    """The reference's cache tree (``first`` layers one by one, then
    ``stages|subJ|mixer`` leaves stacked over the stages) in the port's
    layout: one tensor a leaf name, stacked over every layer that has it,
    the other dims and the dtype unchanged."""
    out, stacked = {}, {}
    for key, (shape, dtype) in ref.items():
        parts = key.split("|")
        if parts[0] != "caches":
            out[key] = [shape, dtype]
            continue
        n, rest = (1, shape) if parts[1] == "first" else (shape[0], shape[1:])
        prev = stacked.setdefault(parts[-1], [0, rest, dtype])
        assert prev[1:] == [rest, dtype], key
        prev[0] += n
    for name, (n, rest, dtype) in stacked.items():
        out[f"caches|{name}"] = [[n, *rest], dtype]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, ref_specs):
    cfg = get_config(arch)
    ref = ref_specs[arch]["inputs"]
    assert sorted(ref) == sorted(runnable_shapes(cfg))
    for shape, want in ref.items():
        got = _flat(input_specs(cfg, SHAPES[shape]), "", {})
        assert got == _regroup(want), shape


@pytest.mark.parametrize("arch", ARCHS)
def test_runnable_shapes_and_opt_config_match_the_reference(arch, ref_specs):
    cfg = get_config(arch)
    ref = ref_specs[arch]
    assert runnable_shapes(cfg) == ref["shapes"]
    oc = opt_config_for(cfg)
    assert [oc.learning_rate, oc.weight_decay, oc.moment_dtype] == ref["opt"]


def test_collective_stats_golden_values():
    """The result bytes of ``test_serve_sharded.py``'s HLO snippet → the same
    ring wire bytes: an all-reduce twice its result, the rest once."""
    recs = [OpRecord("_c10d_functional.all_gather_into_tensor.default", 0.0,
                     160 * 4, 128 * 4, "all-gather"),
            OpRecord("_c10d_functional.all_reduce.default", 0.0,
                     2 * 64 * 8 * 2, 64 * 8 * 2, "all-reduce"),
            OpRecord("_c10d_functional.reduce_scatter_tensor.default", 0.0,
                     80 * 4, 16 * 4, "reduce-scatter"),
            OpRecord("_c10d_functional.all_to_all_single.default", 0.0,
                     2 * (8 * 4 + 4 * 4), 8 * 4 + 4 * 4, "all-to-all"),
            OpRecord("aten.mm.default", 2048.0, 96, 32)]
    got = collective_stats(recs)
    assert got["bytes_by_op"]["all-gather"] == 128 * 4          # result ×1
    assert got["bytes_by_op"]["all-reduce"] == 64 * 8 * 2 * 2   # result ×2
    assert got["bytes_by_op"]["reduce-scatter"] == 16 * 4
    assert got["bytes_by_op"]["all-to-all"] == 8 * 4 + 4 * 4
    assert got["count_by_op"] == {"all-gather": 1, "all-reduce": 1,
                                  "reduce-scatter": 1, "all-to-all": 1}
    assert got["total_wire_bytes_per_device"] == sum(
        got["bytes_by_op"].values())
    empty = collective_stats([OpRecord("aten.mul.Tensor", 0.0, 12, 4)])
    assert empty == {"bytes_by_op": {}, "count_by_op": {},
                     "total_wire_bytes_per_device": 0.0}


def test_summarize_step_has_the_keys_the_cost_model_reads():
    a = torch.ones(4, 8)
    b = torch.ones(8, 2)
    with CostRecorder() as rec:
        c = a @ b
    s = summarize_step(rec.records, (a, b), c)
    assert s["flops_per_device"] == 2 * 4 * 8 * 2
    assert s["bytes_accessed_per_device"] == (32 + 16 + 8) * 4
    assert s["weighted"]["dot_flops_per_device"] == s["flops_per_device"]
    assert s["weighted"]["total_wire_bytes_per_device"] == 0.0
    assert s["memory"]["argument_size_in_bytes"] == 48 * 4
    assert s["memory"]["output_size_in_bytes"] == 8 * 4
    assert s["memory"]["temp_size_in_bytes"] is None
    assert s["ops"] == 1 and s["ops_by_name"] == {"aten.mm.default": 1}


# Smoke shapes of the dry run's kinds: (kind, seq, batch); long_500k keeps
# its batch of one (it splits unevenly over data, as on the 16x16 mesh).
SMOKE_SHAPES = {"train_4k": ("train", 32, 8),
                "prefill_32k": ("prefill", 64, 8),
                "decode_32k": ("decode", 64, 8),
                "long_500k": ("decode", 128, 1)}

SMOKE_CELLS = [(a, s) for a in ARCHS
               for s in runnable_shapes(get_smoke_config(a))]

CELLS_SCRIPT = """
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_debug_mesh, mesh_axes
from repro_torch.models.config import ShapeConfig

init_fake_world(8)
arch, shapes = sys.argv[1], json.loads(sys.argv[2])
cfg = get_smoke_config(arch)
res = {}
for name, (kind, seq, batch) in shapes.items():
    shape = ShapeConfig(name, kind, seq, batch)
    cell = res[name] = {"plain": dryrun.trace_cell(cfg, shape)}
    for ms in ((1, 1), (2, 2), (2, 4)):
        try:
            cell["x".join(map(str, ms))] = dryrun.trace_cell(
                cfg, shape, make_debug_mesh(ms, device="cpu"), mesh_axes())
        except Exception as e:
            cell["x".join(map(str, ms))] = {
                "error": f"{type(e).__name__}: {e}"}
print(json.dumps(res))
"""

FAKE_WORLD_SCRIPT = """
import json, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.sched_integration import CostModelRegistry, Replica

init_fake_world(8)
res = {}
meshes = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    meshes[str(multi)] = [list(m.mesh.shape), list(m.mesh_dim_names),
                          m.device_type, torch.distributed.get_world_size()]
res["meshes"] = meshes
dryrun.ARTIFACT_DIR = sys.argv[1]
cell = dryrun._run_and_save("deepseek-7b", "decode_32k", False)
reg = CostModelRegistry()
res["loaded"] = reg.load_dir(sys.argv[1])
c = reg.cell("deepseek-7b", "decode", (16, 16))
res["cell"] = cell
res["registered"] = [c.tokens_per_step, c.flops_per_device,
                     c.bytes_per_device, c.wire_bytes_per_device]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def smoke_cells():
    """Every smoke cell, one fake-world process an arch, four at a time
    (``launch.dryrun.run_processes``)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-c", CELLS_SCRIPT, arch, json.dumps(
        {s: SMOKE_SHAPES[s] for a, s in SMOKE_CELLS if a == arch})]
        for arch in ARCHS]
    out = {}
    for arch, (rc, stdout, stderr, _) in zip(ARCHS, run_processes(
            cmds, 4, timeout=600, env=env, cwd=REPO)):
        assert rc == 0 and stdout.strip(), stderr[-4000:]
        for shape, cell in json.loads(stdout.strip().splitlines()[-1]).items():
            out[(arch, shape)] = cell
    return out


def test_run_processes_keeps_order_and_kills_past_the_timeout():
    """``run_processes``: results in the commands' order whatever order
    they end in, exit codes and both streams kept, and a process past its
    timeout killed."""
    code = ("import sys, time; time.sleep(float(sys.argv[2])); "
            "print(sys.argv[1]); print('e' + sys.argv[1], file=sys.stderr); "
            "sys.exit(int(sys.argv[1]))")
    cmds = [[sys.executable, "-c", code, str(i), str(d)]
            for i, d in ((0, 1.0), (1, 0.0), (2, 0.5))]
    cmds.append([sys.executable, "-c", "import time; time.sleep(120)"])
    res = run_processes(cmds, 2, timeout=10)
    assert [(rc, o.strip(), e.strip()) for rc, o, e, _ in res[:3]] == [
        (0, "0", "e0"), (1, "1", "e1"), (2, "2", "e2")]
    assert res[3][0] != 0 and 10 <= res[3][3] < 60


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", FAKE_WORLD_SCRIPT,
                           str(tmp)], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, s in SMOKE_CELLS])
def test_per_device_cost_never_grows_with_the_mesh(arch, shape, smoke_cells):
    """Rank 0's FLOPs never grow from 1x1 to 2x2 to 2x4 and drop below the
    one-device count on 2x2.  Bytes are held the same way for deepseek-7b's
    decode and prefill; elsewhere the FSDP weight gathers of a smoke decode
    (their inputs and outputs are counted) can outweigh the halved
    activations (yi's 3.83e6 bytes on 1x1 against 4.05e6 on 2x2)."""
    cells = smoke_cells[(arch, shape)]
    for ms in ("1x1", "2x2", "2x4"):
        assert "error" not in cells[ms], (ms, cells[ms].get("error"))
    one, four, eight = cells["1x1"], cells["2x2"], cells["2x4"]
    assert one["flops_per_device"] == cells["plain"]["flops_per_device"]
    keys = ["flops_per_device"]
    if arch == "deepseek_7b" and shape != "train_4k":
        keys.append("bytes_accessed_per_device")
    for key in keys:
        assert one[key] >= four[key] >= eight[key] > 0, key
    assert four["flops_per_device"] < one["flops_per_device"]
    assert one["collectives"]["total_wire_bytes_per_device"] == 0.0
    assert four["collectives"]["total_wire_bytes_per_device"] > 0.0
    for c in (one, four, eight):
        assert c["memory"]["argument_size_in_bytes"] > 0


def test_production_mesh_shapes_and_axis_names(fake_world):
    assert fake_world["meshes"] == {
        "False": [[16, 16], ["data", "model"], "cuda", 256],
        "True": [[2, 16, 16], ["pod", "data", "model"], "cuda", 512]}


def test_cell_artifact_round_trips_through_the_registry(fake_world):
    cell = fake_world["cell"]
    assert "error" not in cell, cell.get("traceback")
    assert (cell["arch"], cell["shape"], cell["mesh"], cell["num_devices"]) \
        == ("deepseek-7b", "decode_32k", "16x16", 256)
    cfg = get_config("deepseek-7b")
    assert cell["params"] == cfg.param_count() == 6910365696
    assert fake_world["loaded"] == 1
    sc = SHAPES["decode_32k"]
    assert fake_world["registered"] == [
        sc.global_batch, cell["flops_per_device"],
        cell["bytes_accessed_per_device"],
        cell["collectives"]["total_wire_bytes_per_device"]]
    # the weights' products, per device, bound the count from below
    assert cell["flops_per_device"] >= (2 * cfg.active_param_count()
                                        * sc.global_batch / 256)


def _real_counts(cfg, shape):
    torch.manual_seed(0)
    params = init_params(cfg, device="cpu")
    B, S = shape.global_batch, shape.seq_len
    caches = init_cache(cfg, B, S, device="cpu")
    if shape.kind == "decode":
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32)
        args = (params, caches, tokens, torch.tensor(S // 2,
                                                     dtype=torch.int32))
        with torch.no_grad(), CostRecorder() as rec:
            out = decode_step(*args, cfg)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32)
        args = (params, tokens, caches)
        with torch.no_grad(), sharding_policy({"__attn_q_chunk__": "full"}), \
                CostRecorder() as rec:
            out = prefill_step(params, tokens, cfg, caches=caches)
    return summarize_step(rec.records, args, out)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_meta_counts_equal_the_real_step(kind):
    cfg = get_smoke_config("deepseek-7b")
    shape = ShapeConfig("t", kind, 32, 4)
    real = _real_counts(cfg, shape)
    meta = trace_cell(cfg, shape)
    for key in ("flops_per_device", "bytes_accessed_per_device", "ops",
                "ops_by_name"):
        assert meta[key] == real[key], key
    assert meta["memory"] == real["memory"]
    assert np.isfinite(meta["flops_per_device"]) and meta["ops"] > 100
