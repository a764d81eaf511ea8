"""Mesh-backed serve replicas of ``repro_torch.serve`` against
``repro.serve`` (``test_serve_sharded.py``, ``test_elastic_fleet.py`` and
``test_chaos.py``'s engine tests, on the port).

The reference runs once in a subprocess on eight host devices: its
``mesh_backed_fleet`` of ``(1, 1)``, ``(2, 1)`` and ``(2, 2)`` slices of
the deepseek-7b smoke config from ``init_params(jax.random.key(0))``,
greedy generation on every slice and the HEFT_RT front end's ``run_batch``.
The port loads the same parameters in a world of 7 gloo ranks (one a
device of the three slices, ``_torch_ref.run_ranks``) and runs the same.

Bounds.  Greedy tokens bitwise, the front end's counts exactly.  Logits
within ``atol = rtol = 1e-5`` of the meshless engine and of the
reference's slices: the tensor-parallel and FSDP partial sums reorder the
adds of the row-parallel projections (``wo``, ``w_down``) and of every
matmul whose contraction dim is sharded over ``data``, which moves float32
logits by a few ulps (6e-7 at most here), as GSPMD's do.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_ref import REPO, run_ranks, run_reference

ATOL = RTOL = 1e-5

REF_SCRIPT = """
import jax
from repro.configs import get_smoke_config
from repro.models.model import init_params
from repro.serve import HeftFrontEnd, ServeEngine, mesh_backed_fleet

cfg = get_smoke_config('deepseek-7b')
params = init_params(jax.random.key(0), cfg)
fleet = mesh_backed_fleet(cfg, params, [(1, 1), (2, 1), (2, 2)], max_len=64)
out = {}
flat_tree(params, 'p0', out)
rng = np.random.default_rng(0)
prompt = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
out['prompt'] = prompt
out['want'] = ServeEngine(cfg, params, max_len=64).generate(prompt[None], 8)
for i, r in enumerate(fleet):
    out[f'gen{i}'] = r.engine.generate(prompt[None], 8)
    out[f'logits{i}'] = np.asarray(r.engine.start(prompt[None])[0])
reqs = [(rng.integers(0, cfg.vocab_size,
                      rng.integers(8, 32)).astype(np.int32), 6)
        for _ in range(6)]
outs, counts = HeftFrontEnd(fleet).run_batch(reqs)
out['counts'] = np.array([counts[r.name] for r in fleet])
for i, (p, _) in enumerate(reqs):
    out[f'req{i}'] = p
    out[f'out{i}'] = outs[i]
np.savez(OUT, **out)
"""

PORT_CODE = """
from _torch_ref import unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.sched_integration import MappingFabric
from repro_torch.serve import HeftFrontEnd, ServeEngine, mesh_backed_fleet

ref = dict(np.load(REF))
cfg = get_smoke_config('deepseek-7b')
params = params_from_reference(cfg, unflatten(ref, 'p0'), device='cpu')
fleet = mesh_backed_fleet(cfg, params, [(1, 1), (2, 1), (2, 2)], max_len=64,
                          lanes=4, device='cpu')
RESULT['shapes'] = np.array([r.mesh_shape for r in fleet])
plain = ServeEngine(cfg, params, max_len=64, lanes=4)
prompt = ref['prompt']
RESULT['plain'] = plain.generate(prompt[None], 8)
RESULT['plain_logits'] = plain.start(prompt[None])[0].numpy()
for i, r in enumerate(fleet):
    RESULT[f'gen{i}'] = r.engine.generate(prompt[None], 8)
    RESULT[f'logits{i}'] = r.engine.start(prompt[None])[0].numpy()
# the 2x2 replica's leaves are sharded: this rank's shard of each
for name in ('embed', 'layers.0.mixer.wq', 'layers.0.mixer.wo',
             'layers.0.ffn.w_down'):
    p = dict(fleet[2].engine.params.named_parameters())[name]
    RESULT[f'local|{name}'] = np.array(p.to_local().shape)
    RESULT[f'global|{name}'] = np.array(p.shape)

reqs = [(ref[f'req{i}'], 6) for i in range(6)]
outs, counts = HeftFrontEnd(fleet).run_batch(reqs)
RESULT['counts'] = np.array([counts[r.name] for r in fleet])
for i in range(6):
    RESULT[f'out{i}'] = outs[i]

# continuous batching, decisions inside the meshed ticks
cont = [(ref[f'req{i}'], 6) for i in range(6)] + [(prompt, 8)]
fab = MappingFabric(3, backend='fused', device='cpu', device_counters=True)
seqs, stats = HeftFrontEnd(fleet, fabric=fab).run_continuous(
    cont, arrival_ticks=[0, 0, 1, 1, 2, 3, 3], max_batch=4, page_size=16,
    fused=True)
RESULT['cont_ok'] = np.array([np.array_equal(s, plain.generate(p[None], n)[0])
                              for s, (p, n) in zip(seqs, cont)])
RESULT['cont_stats'] = np.array([stats['fused_decisions'],
                                 stats['host_decisions'], stats['allocated'],
                                 stats['freed']])
RESULT['avail'] = np.asarray(fab.avail)

# elastic: (1,1) -> (2,2) -> (2,1) and back off the mesh, then a cache
# migrated mid-generation, and a paged slot moved in flight
m11, m21, m22 = (fleet[0].engine.mesh, fleet[1].engine.mesh,
                 fleet[2].engine.mesh)
want = RESULT['plain']
eng = ServeEngine(cfg, params, max_len=64, lanes=4, mesh=m11)
moves = []
for mesh in (m22, m21):
    eng.reshard(mesh)
    moves.append(eng.mesh_shape == tuple(mesh.mesh.shape)
                 and np.array_equal(eng.generate(prompt[None], 8), want))
logits, caches = eng.start(prompt[None])
toks = []
for i in range(8):
    if i == 4:
        caches = eng.reshard(m22, caches=caches)
    tok = logits.argmax(-1).to(torch.int32).numpy()
    toks.append(tok)
    logits, caches = eng.step(caches, tok[:, None], 12 + i)
moves.append(np.array_equal(np.stack(toks, 1), want[:, 12:]))
eng.reshard(None)
moves.append(eng.mesh_shape is None
             and not hasattr(eng.params.embed, 'to_local')
             and np.array_equal(eng.generate(prompt[None], 8), want))
# the chaos tier's unit: snapshot on (2,1) at step 4, restore onto (2,2)
a = ServeEngine(cfg, params, max_len=64, lanes=4, mesh=m21)
logits, caches = a.start(prompt[None])
toks = []
for i in range(4):
    tok = logits.argmax(-1).to(torch.int32).numpy()
    toks.append(tok)
    logits, caches = a.step(caches, tok[:, None], 12 + i)
snap = a.snapshot_caches(caches)
b = ServeEngine(cfg, params, max_len=64, lanes=4, mesh=m22)
caches = b.restore_caches(snap)
for i in range(4, 8):
    tok = logits.argmax(-1).to(torch.int32).numpy()
    toks.append(tok)
    logits, caches = b.step(caches, tok[:, None], 12 + i)
moves.append(np.array_equal(np.stack(toks, 1), want[:, 12:]))
# paged: admit on (2,1), three ticks, move the live replica to (2,2)
c = fleet[1].engine
slot = c.admit(prompt, 8)
for _ in range(3):
    c.decode_tick()
c.reshard(m22)
fleet[1].sync_mesh_identity()
while not c.finished_slots():
    c.decode_tick()
moves.append(np.array_equal(c.retire(slot), want[0])
             and fleet[1].mesh_shape == (2, 2) and fleet[1].speed == 4.0)
# one request's pages snapshotted on (1,1) after three ticks, restored on
# the (2,2) replica's pool
d, e = fleet[0].engine, fleet[2].engine
slot = d.admit(prompt, 8)
for _ in range(3):
    d.decode_tick()
slot2 = e.restore_pages(d.snapshot_pages(slot))
while not e.finished_slots():
    e.decode_tick()
moves.append(np.array_equal(e.retire(slot2), want[0]))
RESULT['moves'] = np.array(moves)
# a head count the model axis does not divide (chameleon's one KV head
# over 2) raises on every rank
try:
    ServeEngine(get_smoke_config('chameleon_34b'),
                params, max_len=64, mesh=m22)
    RESULT['uneven'] = np.array('no error')
except NotImplementedError as err:
    RESULT['uneven'] = np.array(str(err))
"""

FAMILIES = ["gemma2_9b", "falcon_mamba_7b", "jamba_v0_1_52b",
            "deepseek_v2_236b", "musicgen_medium"]

FAMILY_CODE = """
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

mesh = make_debug_mesh((2, 2), device='cpu')
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device='cpu')
    plain = ServeEngine(cfg, params, max_len=32, lanes=4)
    meshed = ServeEngine(cfg, params, max_len=32, lanes=4, mesh=mesh)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 8).astype(np.int32)
    RESULT[f'{arch}|gen'] = plain.generate(prompt[None], 4)
    RESULT[f'{arch}|mgen'] = meshed.generate(prompt[None], 4)
    RESULT[f'{arch}|logits'] = plain.start(prompt[None])[0].numpy()
    RESULT[f'{arch}|mlogits'] = meshed.start(prompt[None])[0].numpy()
    meshed.start_paged(max_batch=2, page_size=8)
    slot = meshed.admit(prompt, 4)
    while not meshed.finished_slots():
        meshed.decode_tick()
    RESULT[f'{arch}|paged'] = meshed.retire(slot)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "serve.npz"
    return out, run_reference(REF_SCRIPT, out, devices=8)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return run_ranks(f"REF = {str(ref[0])!r}\n" + PORT_CODE, 7, tmp,
                     timeout=300)


def test_sharded_replicas_generate_the_meshless_and_reference_tokens(ref,
                                                                     port):
    _, out = ref
    for r in port:
        assert [tuple(s) for s in r["shapes"]] == [(1, 1), (2, 1), (2, 2)]
        np.testing.assert_array_equal(r["plain"], out["want"])
        for i in range(3):
            np.testing.assert_array_equal(r[f"gen{i}"], r["plain"])
            np.testing.assert_array_equal(r[f"gen{i}"], out[f"gen{i}"])


def test_sharded_logits_within_float32_reordering(ref, port):
    _, out = ref
    for r in port:
        for i in range(3):
            np.testing.assert_allclose(r[f"logits{i}"], r["plain_logits"],
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(r[f"logits{i}"], out[f"logits{i}"],
                                       atol=ATOL, rtol=RTOL)
    # the (1, 1) slice computes exactly what the meshless engine does
    np.testing.assert_array_equal(port[0]["logits0"], port[0]["plain_logits"])


def test_two_by_two_replica_leaves_are_really_sharded(port):
    """Ranks 3-6 hold the (2, 2) slice: every rank keeps a quarter of the
    2-D projections (FSDP over data x TP over model), the ranks outside
    the slice nothing."""
    for rank, r in enumerate(port):
        for name in ("embed", "layers.0.mixer.wq", "layers.0.mixer.wo",
                     "layers.0.ffn.w_down"):
            full = tuple(r[f"global|{name}"])
            local = tuple(r[f"local|{name}"])
            if rank < 3:
                assert np.prod(local) == 0, (rank, name, local)
            else:
                assert local == (full[0] // 2, full[1] // 2), (name, local)


def test_front_end_counts_and_outputs_equal_the_reference(ref, port):
    _, out = ref
    assert list(out["counts"]) == [1, 2, 3]
    for r in port:
        assert list(r["counts"]) == list(out["counts"])
        for i in range(6):
            np.testing.assert_array_equal(r[f"out{i}"], out[f"out{i}"])


def test_continuous_fused_decisions_ride_the_meshed_ticks(port):
    """run_continuous(fused=True) over the three slices: every request is
    bitwise the dense oracle, the decisions are made in the ticks (the
    cold start on the host), pages allocated == freed, and every rank's
    fabric ends with the same T_avail registers."""
    for r in port:
        assert r["cont_ok"].all()
        fused, host, alloc, freed = r["cont_stats"]
        assert fused + host == 7 and fused > 0 and host >= 1
        assert alloc == freed > 0
        np.testing.assert_array_equal(r["avail"], port[0]["avail"])


def test_reshard_across_slices_in_mid_generation_is_token_identical(port):
    """(1,1) → (2,2) → (2,1); a dense cache moved to (2,2) after 4 tokens;
    back off the mesh; a snapshot taken on (2,1) restored on (2,2); a
    paged slot moved in flight with its replica (whose scheduling identity
    follows); one request's pages moved from the (1,1) replica to the
    (2,2) one: every continuation bitwise the uninterrupted run."""
    for r in port:
        assert list(r["moves"]) == [True] * 7, r["moves"]


def test_uneven_head_split_raises(port):
    """ROADMAP queue 1 item 11c: the attention core runs on each rank's
    own heads, so a head count the model axis does not divide raises (the
    reference's GSPMD pads it)."""
    for r in port:
        assert "do not split over a model axis of 2" in str(r["uneven"])


def test_every_block_kind_on_a_two_by_two_mesh(tmp_path):
    """Local windows and softcaps (gemma2), Mamba (d_inner over model,
    the conv / ssm caches written in place on each rank's channels), the
    Mamba / attention / MoE hybrid (experts over model, the dispatch on
    local groups), MLA + MoE (the latent cache replicated, heads over
    model) and the GELU FFN on a (2, 2) mesh of 4 ranks: greedy tokens
    bitwise the meshless engine's, dense and paged, logits within the
    f32 reordering bound."""
    res = run_ranks(f"ARCHS = {FAMILIES!r}\n" + FAMILY_CODE, 4, tmp_path,
                    timeout=300)
    for r in res:
        for arch in FAMILIES:
            np.testing.assert_array_equal(r[f"{arch}|mgen"],
                                          r[f"{arch}|gen"])
            np.testing.assert_array_equal(r[f"{arch}|paged"],
                                          r[f"{arch}|gen"][0])
            np.testing.assert_allclose(r[f"{arch}|mlogits"],
                                       r[f"{arch}|logits"],
                                       atol=ATOL, rtol=RTOL)


def test_sharded_serve_launcher_under_torchrun(tmp_path):
    """``torchrun -m repro_torch.launch.serve --device cpu --sharded
    --mesh-shapes 1x1,2x1,2x2`` (paged, decisions in the ticks; it exits 1
    unless request 0 equals the dense oracle) on 9 ranks, the two left over
    taking replica 0 with ``--reshard-to 2x1`` (exit 1 unless the requests
    come out token-identical again)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "9", "-m", "repro_torch.launch.serve",
           "--device", "cpu", "--sharded", "--mesh-shapes", "1x1,2x1,2x2",
           "--paged", "--fused-scheduler", "--reshard-to", "2x1",
           "--requests", "4", "--new-tokens", "4"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    log = proc.stderr + proc.stdout
    assert "verified token-identical" in log
    assert "post-reshard outputs token-identical" in log
