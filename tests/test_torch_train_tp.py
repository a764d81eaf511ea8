"""Tensor-parallel training of ``repro_torch.train`` on a ``(pod, data,
model)`` mesh (ROADMAP queue 1 item 11b), against the port's single-device
step and ``repro``'s.

* The reference layout: ``test_dist.py::test_sharded_train_step_matches_
  single_device``'s tiny MoE + attention config, AdamW at 1e-3 (clipping
  at a norm of 1), tokens and labels ``(8, 32)``, three steps on 8 gloo
  ranks (``_torch_ref.run_ranks``): a 2x2x2 mesh, and a (2, 1, 4) one,
  whose model axis of 4 pads the config's 2 KV heads by copies.  The
  reference runs its single-device steps once in a subprocess
  (``run_reference``; it needs no ``repro.dist``), and the port loads the
  same parameters.  Three steps, because Adam's first moves every weight
  by ``lr · sign(g)`` whatever the gradient's size; each step's
  ``grad_norm`` is compared too.
* The vocab-parallel cross-entropy (``models.model._vocab_parallel_ce``) on
  model axes of 2 and 4 against the plain chunk.
* The int8 pod reduction on local shards: ranks bitwise equal, within the
  Adam bound of the exact step, one grid a leaf (the whole leaf's absmax).
* ``Trainer`` on (1, 2, 2): a restart bitwise equal to an uninterrupted
  run; its checkpoint restored on a model axis of 4 and without a mesh;
  ``launch.train --mesh-shape 1,2,2`` under ``torchrun``.

Bounds.  The sharded step reorders the f32 sums of the row-parallel
projections, of the FSDP gradient reductions and of the vocab-parallel
softmax, and groups the MoE tokens by the policy's ``__moe_groups__``
(batch x model axis, as the reference's test sets it) where the single
device groups by ``_num_groups``; the capacity factor of 8 drops no token,
so only the order of the expert gradients' sums moves.  Loss and every
parameter within 1e-4 of both single-device steps, the reference test's
bound; loss, ce and grad_norm of every step within 1e-5 relative (a
reordered f32 sum of a few thousand terms moves by ~1e-6 relative).  The
int8 moments' steps are held to the same bounds.  The vocab-parallel CE
reorders the vocab sum of ``exp``, which moves ``lse`` by a few ulps (~5e-7 at the test's ``|lse| ~ 5``) and each
softmax entry ``exp(x - lse)`` by that much relative: its value within
1e-6 relative, its gradient (entries at most 1) within 1e-6.  The int8
step is held to ``2 * lr`` of the exact one, the bound of
``test_torch_train_compress.py`` (a quantized gradient near zero can flip
``m / sqrt(v)``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_ref import REPO, run_ranks, run_reference, unflatten

from repro_torch.models import ModelConfig
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import _reference_state

LR = 1e-3
CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32",
                  moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                                capacity_factor=8.0, layer_period=2,
                                layer_offset=1))

CFG_CODE = """
from repro_torch.models import ModelConfig
from repro_torch.models.config import MoEConfig
cfg = ModelConfig(name='t', num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype='float32', compute_dtype='float32',
                  moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                                capacity_factor=8.0, layer_period=2,
                                layer_offset=1))
"""

STEPS = 3
MESHES = ((2, 2, 2), (2, 1, 4))

REF_SCRIPT = """
import jax, jax.numpy as jnp
from repro.models import ModelConfig, MoEConfig, init_params, loss_fn
from repro.optim import AdamWConfig, adamw_update, init_opt_state

cfg = ModelConfig(name='t', num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype='float32', compute_dtype='float32',
                  moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                                capacity_factor=8.0, layer_period=2,
                                layer_offset=1))
ocfg = AdamWConfig(learning_rate=1e-3)
params = init_params(jax.random.key(0), cfg)
rng = np.random.default_rng(0)
toks = rng.integers(0, 64, (3, 8, 32)).astype(np.int32)
labels = rng.integers(0, 64, (3, 8, 32)).astype(np.int32)

def step(p, o, t, l):
    (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, t, l, cfg)
    p, o, m = adamw_update(g, o, p, ocfg)
    return p, o, loss, m['grad_norm']

out = {'tokens': toks, 'labels': labels}
flat_tree(params, 'p0', out)
p, o = params, init_opt_state(params, ocfg)
losses, norms = [], []
for i in range(3):
    p, o, loss, gn = jax.jit(step)(p, o, toks[i], labels[i])
    losses.append(float(loss))
    norms.append(float(gn))
out['loss'] = np.array(losses)
out['grad_norm'] = np.array(norms)
flat_tree(p, 'p3', out)
np.savez(OUT, **out)
"""

TP_CODE = CFG_CODE + """
import copy
from _torch_ref import unflatten
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.trainer import TrainLayout, make_train_step

ref = dict(np.load(REF))
p0 = params_from_reference(cfg, unflatten(ref, 'p0'), device='cpu')
batches = [{'tokens': torch.from_numpy(ref['tokens'][i]),
            'labels': torch.from_numpy(ref['labels'][i])}
           for i in range(len(ref['loss']))]

def metrics(m):
    return [float(m[k]) for k in ('loss', 'ce', 'grad_norm')]

for dt in ('float32', 'int8'):
    ocfg = AdamWConfig(learning_rate=1e-3, moment_dtype=dt)
    one = copy.deepcopy(p0).requires_grad_(True)
    opt = init_opt_state(dict(one.named_parameters()), ocfg)
    step, got = make_train_step(cfg, ocfg), []
    for b in batches:
        _, opt, _, m = step(one, opt, None, b)
        got.append(metrics(m))
    RESULT[f'one|{dt}|metrics'] = np.array(got)
    for n, p in one.named_parameters():
        RESULT[f'one|{dt}|{n}'] = p.detach().numpy()
    for shape in MESHES:
        tag = 'x'.join(map(str, shape)) + '|' + dt
        mesh = make_debug_mesh(shape, ('pod', 'data', 'model'), device='cpu')
        lay = TrainLayout(cfg, mesh)
        plain = copy.deepcopy(p0)
        params = lay.place_params(plain)
        opt = lay.place_opt(init_opt_state(dict(plain.named_parameters()),
                                           ocfg), dt)
        step, got = make_train_step(cfg, ocfg, pod_axis='pod', mesh=mesh,
                                    layout=lay), []
        for b in batches:
            params, opt, _, m = step(params, opt, None, b)
            got.append(metrics(m))
        RESULT[f'{tag}|metrics'] = np.array(got)
        RESULT[f'{tag}|heads'] = np.array([lay.run_cfg.num_heads,
                                           lay.run_cfg.num_kv_heads])
        RESULT[f'{tag}|local_wk'] = np.array(
            params.layers[0].mixer.wk.to_local().shape)
        for n, p in lay.plain_params(params).items():
            RESULT[f'{tag}|{n}'] = p.numpy()
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "tp.npz"
    return out, run_reference(REF_SCRIPT, out)


@pytest.fixture(scope="module")
def tp(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return run_ranks(f"REF = {str(ref[0])!r}\nMESHES = {MESHES!r}\n"
                     + TP_CODE, 8, tmp, timeout=900)


def _steps_match(ref, tp, shape):
    """Three AdamW steps (lr 1e-3, clipping at a norm of 1) on ``shape``,
    f32 moments: each step's loss, ce and grad_norm within 1e-5 relative
    of the port's single-device steps (and loss and grad_norm of the
    reference's), every parameter after step 3 within 1e-4 of both, every
    rank holding the same values.  With int8 moments: metrics within 1e-5
    relative and parameters within 1e-4 of the single-device int8
    steps."""
    _, out = ref
    ref_named = {n: np.asarray(t) for n, t in
                 _reference_state(CFG, unflatten(out, "p3")).items()}
    tag = "x".join(map(str, shape)) + "|float32"
    m = shape[2]
    kv = 2 if m == 2 else 4                 # KV heads run on the mesh
    for r in tp:
        assert tuple(r[f"{tag}|heads"]) == (4, kv)
        assert tuple(r[f"{tag}|local_wk"]) == (32 // shape[1], kv * 8 // m)
        got, one = r[f"{tag}|metrics"], r["one|float32|metrics"]
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[:, 0], out["loss"], rtol=1e-5)
        np.testing.assert_allclose(got[:, 2], out["grad_norm"], rtol=1e-5)
        names = [k[len(tag) + 1:] for k in r if k.startswith(tag + "|")
                 and k[len(tag) + 1:] in ref_named]
        assert set(names) == set(ref_named)
        for n in names:
            got = r[f"{tag}|{n}"]
            np.testing.assert_array_equal(got, tp[0][f"{tag}|{n}"])
            assert np.abs(got - r[f"one|float32|{n}"]).max() <= 1e-4, n
            assert np.abs(got - ref_named[n]).max() <= 1e-4, n
        tag8 = "x".join(map(str, shape)) + "|int8"
        np.testing.assert_allclose(r[f"{tag8}|metrics"],
                                   r["one|int8|metrics"], rtol=1e-5, atol=0)
        for n in names:
            gap = np.abs(r[f"{tag8}|{n}"] - r[f"one|int8|{n}"]).max()
            assert gap <= 1e-4, (n, gap)


def test_two_by_two_by_two_step_matches_single_device(ref, tp):
    """:func:`_steps_match` on the 2x2x2 mesh: a quarter of each KV
    projection a rank (FSDP over data x heads over model)."""
    _steps_match(ref, tp, (2, 2, 2))


def test_padded_kv_heads_on_a_model_axis_of_four_match_single_device(ref,
                                                                       tp):
    """:func:`_steps_match` on (2, 1, 4): the model axis of 4 pads CFG's 2
    KV heads to 4 by copies (``tie_padded_grads``, ``grad_norm_weights``,
    the padded int8 moments of ``TrainLayout``), one KV head a rank."""
    _steps_match(ref, tp, (2, 1, 4))


CE_CODE = """
from repro_torch.dist.hints import gathered
from repro_torch.dist.sharding import P, named, reshard_tree
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.model import _vocab_parallel_ce

rng = np.random.default_rng(0)
logits = torch.from_numpy(3 * rng.standard_normal((4, 8, 64)).astype(
    np.float32))
labels = torch.from_numpy(rng.integers(0, 64, (4, 8)).astype(np.int64))
x = logits.clone().requires_grad_(True)
plain = torch.sum(torch.logsumexp(x, -1)
                  - torch.gather(x, -1, labels[..., None])[..., 0])
plain.backward()
RESULT['plain'] = np.array(float(plain))
RESULT['plain_grad'] = x.grad.numpy()
for m, shape in ((2, (2, 2)), (4, (1, 4))):
    mesh = make_debug_mesh(shape, device='cpu')
    lt = reshard_tree(logits, named(mesh, P('data', None, 'model')))
    lt.requires_grad_(True)
    lab = reshard_tree(labels, named(mesh, P('data', None)))
    total = gathered(_vocab_parallel_ce(lt, lab))
    total.backward()
    RESULT[f'value{m}'] = np.array(float(total))
    RESULT[f'grad{m}'] = lt.grad.full_tensor().numpy()
    RESULT[f'local{m}'] = np.array(lt.to_local().shape)
"""


def test_vocab_parallel_cross_entropy_value_and_gradient(tmp_path):
    """Σ (logsumexp - gold) of (4, 8, 64) f32 logits split over the vocab
    on model axes of 2 and 4 (and the batch over data): the value and the
    gradient of the plain chunk, each rank holding only its vocab shard."""
    res = run_ranks(CE_CODE, 4, tmp_path, timeout=300)
    for r in res:
        for m in (2, 4):
            assert tuple(r[f"local{m}"])[2] == 64 // m
            np.testing.assert_allclose(r[f"value{m}"], r["plain"], rtol=1e-6)
            np.testing.assert_allclose(r[f"grad{m}"], r["plain_grad"],
                                       atol=1e-6, rtol=0)


COMPRESS_CODE = CFG_CODE + """
import copy
from torch.distributed.tensor import distribute_tensor
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.dist.compression import compressed_psum_mean
from repro_torch.dist.sharding import P, placements_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.trainer import TrainLayout, make_train_step

mesh = make_debug_mesh((2, 1, 2), ('pod', 'data', 'model'), device='cpu')
ocfg = AdamWConfig(learning_rate=1e-3)
batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
    DataConfig(vocab_size=64, seq_len=32, global_batch=8)).batch_at(0).items()}
p0 = init_params(cfg, torch.Generator().manual_seed(0), device='cpu')
lay = TrainLayout(cfg, mesh)
for comp in (False, True):
    plain = copy.deepcopy(p0).requires_grad_(True)
    params = lay.place_params(plain)
    opt = lay.place_opt(init_opt_state(dict(plain.named_parameters()),
                                       ocfg), 'float32')
    step = make_train_step(cfg, ocfg, pod_axis='pod', mesh=mesh, layout=lay,
                           compress_pods=comp)
    res = None
    for _ in range(2):
        params, opt, res, m = step(params, opt, res, batch)
    for n, p in lay.plain_params(params).items():
        RESULT[f'{comp}|{n}'] = p.numpy()
    if comp:
        RESULT['res_shape'] = np.array(res['layers.0.mixer.wq'].shape)

# one grid a leaf: a (2, 6) leaf split over model quantizes as the whole
pod = mesh.get_local_rank('pod')
whole = torch.from_numpy(np.random.default_rng(pod).standard_normal(
    (2, 6)).astype(np.float32))
whole[1, 5] = 40.0 * (pod + 1)           # the leaf's absmax, on one shard
dt = distribute_tensor(whole, mesh, placements_for(mesh, P(None, 'model')),
                       src_data_rank=None)
mean_l, err_l = compressed_psum_mean(
    {'w': dt.to_local()}, mesh.get_group('pod'),
    amax_groups=(mesh.get_group('model'),))
mean_w, err_w = compressed_psum_mean({'w': whole}, mesh.get_group('pod'))
RESULT['grid_mean'] = np.array(torch.equal(
    mean_l['w'], mean_w['w'][:, 3 * mesh.get_local_rank('model'):][:, :3]))
RESULT['grid_err'] = np.array(torch.equal(
    err_l['w'], err_w['w'][:, 3 * mesh.get_local_rank('model'):][:, :3]))
"""


def test_compressed_pod_step_on_local_shards(tmp_path):
    """Two steps on a (2, 1, 2) mesh, exact and int8 pod reductions of the
    ranks' local shards: every rank ends with the same parameters, the
    int8 step within ``2 * lr`` of the exact one, the residual a rank's
    shard ``(1, D, H * hd / 2)``; and a leaf split over ``model``
    quantizes on the whole leaf's grid (mean and residual equal to the
    unsplit leaf's, bit for bit)."""
    res = run_ranks(COMPRESS_CODE, 4, tmp_path, timeout=300)
    for r in res:
        keys = [k for k in r if k.startswith("True|")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k])
            gap = np.abs(r[k] - r["False|" + k[5:]]).max()
            assert gap <= 2 * LR, (k, gap)
        assert tuple(r["res_shape"]) == (1, 32, 16)
        assert bool(r["grid_mean"]) and bool(r["grid_err"])


TRAINER_CODE = CFG_CODE + """
import shutil
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

def mk(d, total, comp, mesh=(1, 2, 2)):
    return Trainer(cfg, AdamWConfig(learning_rate=3e-3, moment_dtype='int8'),
                   DataConfig(vocab_size=64, seq_len=32, global_batch=8),
                   TrainerConfig(total_steps=total, checkpoint_every=2,
                                 checkpoint_dir=f'{TMP}/{d}',
                                 mesh_shape=mesh, compress_pods=comp),
                   device='cpu')

def raw(d, step):
    c = Checkpointer(f'{TMP}/{d}')
    with np.load(f'{c.dir}/step_{step:08d}/arrays.npz') as z:
        return {k: z[k] for k in z.files}

for comp in (False, True):
    try:
        mk(f'a{comp}', 5, comp).run(inject_failure_at=3)
        raise SystemExit('no injected failure?')
    except RuntimeError:
        pass
    ta = mk(f'a{comp}', 5, comp)
    pa, _, _ = ta.run()
    tb = mk(f'b{comp}', 5, comp)
    pb, _, _ = tb.run()
    a, b = ta.layout.plain_params(pa), tb.layout.plain_params(pb)
    for n in a:
        RESULT[f'eq|{comp}|{n}'] = np.array(torch.equal(a[n], b[n]))
    for n, e in (ta.last_residual or {}).items():
        RESULT[f'eq|{comp}|res|{n}'] = np.array(
            torch.equal(e, tb.last_residual[n]))
    # the step-5 checkpoint (model axis 2: nothing pads) restored on a
    # model axis of 4, where CFG's 2 KV heads pad by copies, and saved
    # again: the same whole, unpadded leaves, residual included
    if RANK == 0:
        shutil.copytree(f'{TMP}/a{comp}', f'{TMP}/c{comp}')
    torch.distributed.barrier()
    tc = mk(f'c{comp}', 5, comp, mesh=(1, 1, 4))
    p, o, r, start = tc.init_or_restore()
    RESULT[f'c|{comp}|start'] = np.array(start)
    RESULT[f'c|{comp}|kv'] = np.array(tc.layout.run_cfg.num_kv_heads)
    tc.save(6, p, o, r)
    tc.ckpt.wait()
    torch.distributed.barrier()
    five, six = raw(f'c{comp}', 5), raw(f'c{comp}', 6)
    RESULT[f'c|{comp}|keys'] = np.array(sorted(five) == sorted(six)
                                        and len(five) > 40)
    for k in five:
        RESULT[f'eq|{comp}|c|{k}'] = np.array(
            np.array_equal(five[k], six[k]))
    # and without a mesh: the parameters of the same checkpoint
    if not comp:
        plain = Trainer(cfg, AdamWConfig(learning_rate=3e-3,
                                         moment_dtype='int8'),
                        DataConfig(vocab_size=64, seq_len=32,
                                   global_batch=8),
                        TrainerConfig(total_steps=5,
                                      checkpoint_dir=f'{TMP}/c{comp}'),
                        device='cpu')
        pm, _, _, _ = plain.init_or_restore()
        for n, t in pm.named_parameters():
            RESULT[f'eq|{comp}|meshless|{n}'] = np.array(np.array_equal(
                t.detach().numpy(), six['params/' + n]))
"""


def test_trainer_restart_bitwise_on_a_model_axis(tmp_path):
    """``Trainer`` on (1, 2, 2) with int8 moments, exact and int8 pod
    reductions: crash after 3 of 5 steps, resume from the step-2
    checkpoint, and match the uninterrupted run bit for bit, residual
    included.  The checkpoint is whole and unpadded: restored on a model
    axis of 4 (its KV heads padded by copies) and saved again it holds the
    same bits in every leaf (parameters, int8 moments and their scales,
    the residual), and a meshless Trainer restores its parameters."""
    res = run_ranks(f"TMP = {str(tmp_path)!r}\n" + TRAINER_CODE, 4,
                    tmp_path, timeout=600)
    for r in res:
        for comp in (False, True):
            assert int(r[f"c|{comp}|start"]) == 5
            assert int(r[f"c|{comp}|kv"]) == 4
            assert bool(r[f"c|{comp}|keys"])
        eq = {k: bool(v) for k, v in r.items() if k.startswith("eq|")}
        assert len(eq) > 150 and all(eq.values()), \
            [k for k, v in eq.items() if not v]


def test_launcher_trains_with_a_model_axis_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --device
    cpu --mesh-shape 1,2,2`` trains a few steps tensor-parallel and
    checkpoints the whole parameters."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               REPRO_LOG="INFO")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--device", "cpu", "--mesh-shape", "1,2,2", "--steps", "3",
           "--batch", "8", "--seq", "16", "--ckpt-every", "2",
           "--ckpt-dir", str(tmp_path / "ckpt")]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002",
                                                     "step_00000003"]
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import param_shapes
    import torch
    shapes = param_shapes(get_smoke_config("deepseek-7b"))
    template = {"params": {n: torch.zeros(()) for n in shapes}}
    state = Checkpointer(str(tmp_path / "ckpt")).restore(template,
                                                          device="cpu")
    for n, shape in shapes.items():
        assert tuple(state["params"][n].shape) == shape, n
        assert torch.isfinite(state["params"][n].float()).all(), n
