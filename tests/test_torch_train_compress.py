"""The pod train steps and the compressed-residual Trainer of
``repro_torch.train`` against ``repro.train`` (``test_train_compress.py``
on the port).

The reference runs once a module in a subprocess on four host devices
(``run_reference(devices=4, shims=True)``: its pod path needs the two jax
0.9 shims of ``_torch_ref.JAX09_SHIMS`` there, ROADMAP queue 3), from
``init_params(jax.random.key(0))`` of the smoke config of
``test_train_compress.py``, on ``TokenPipeline`` batch 0.  The port loads
the same parameters and runs as four gloo ranks on a ``(pod, data) = (2,
2)`` mesh (``_torch_ref.run_ranks``).

Bounds.  The exact pod step is a restructured mean of the same gradients:
within 1e-5 of the plain step on the whole batch and of the reference's
exact pod step.  The int8 step is within the reference test's Adam bound,
``2 * lr``, of the plain step (a quantized gradient near zero can flip
``m / sqrt(v)`` by O(1), moving an entry by up to ~lr on the first step);
against the reference's int8 step it is held to 4x what one float32
rounding of the weights (each times ``1 +- 2**-24``, two draws) does to the
port's own int8 step, the bound ``test_torch_train.py`` argues for.  The
ranks' parameters are bitwise equal after every step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_ref import REPO, run_ranks, run_reference, unflatten

from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import ModelConfig
from repro_torch.models.convert import _reference_state, params_from_reference
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step

LR = 3e-3
ROUND_FACTOR = 4.0
CFG = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")

REF_SCRIPT = """
import jax, jax.numpy as jnp
from repro.models import ModelConfig
from repro.optim import AdamWConfig, init_opt_state
from repro.data import DataConfig, TokenPipeline
from repro.models.model import init_params
from repro.train import make_train_step

cfg = ModelConfig(name='t', num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype='float32', compute_dtype='float32')
ocfg = AdamWConfig(learning_rate=3e-3)
params = init_params(jax.random.key(0), cfg)
batch = {k: jnp.asarray(v) for k, v in TokenPipeline(
    DataConfig(vocab_size=64, seq_len=32, global_batch=8)).batch_at(0).items()}
mesh = jax.make_mesh((2, 2), ('pod', 'data'))
exact = jax.jit(make_train_step(cfg, ocfg, pod_axis='pod',
                                compress_pods=False, mesh=mesh))
comp = jax.jit(make_train_step(cfg, ocfg, pod_axis='pod',
                               compress_pods=True, mesh=mesh))
out = {}
flat_tree(params, 'p0', out)
with jax.set_mesh(mesh):
    p, _, _, m_ex = exact(params, init_opt_state(params, ocfg), None, batch)
    flat_tree(p, 'exact', out)
    p, _, res, m_cp = comp(params, init_opt_state(params, ocfg), None, batch)
    flat_tree(p, 'comp', out)
    flat_tree(res, 'res', out)
out['loss'] = np.array([float(m_ex['loss']), float(m_cp['loss'])])
np.savez(OUT, **out)
"""

PORT_CODE = """
from _torch_ref import unflatten
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step

cfg = ModelConfig(name='t', num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype='float32', compute_dtype='float32')
ocfg = AdamWConfig(learning_rate=3e-3)
tree = unflatten(dict(np.load(REF)), 'p0')
batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
    DataConfig(vocab_size=64, seq_len=32, global_batch=8)).batch_at(0).items()}
mesh = make_debug_mesh((2, 2), ('pod', 'data'), device='cpu')
RESULT['coord'] = np.array(mesh.get_coordinate())

def fresh(scale=None):
    m = params_from_reference(cfg, tree, device='cpu')
    if scale is not None:         # one float32 rounding of every weight
        g = torch.Generator().manual_seed(scale)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + (torch.randint(0, 2, p.shape, generator=g) * 2
                            - 1) * 2.0 ** -24)
    return m, init_opt_state(dict(m.named_parameters()), ocfg)

def flat(m):
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}

for kind, comp in (('exact', False), ('comp', True)):
    step = make_train_step(cfg, ocfg, pod_axis='pod', compress_pods=comp,
                           mesh=mesh)
    m, opt = fresh()
    residual = None
    for i in range(2):            # two steps: the residual is carried
        _, opt, residual, met = step(m, opt, residual, batch)
        for n, a in flat(m).items():
            RESULT[f'{kind}{i}|{n}'] = a
        if i == 0:
            RESULT[f'{kind}|loss'] = met['loss'].numpy()
            if comp:
                for n, e in residual.items():
                    RESULT[f'res0|{n}'] = e.numpy().copy()
    if comp:
        for n, e in residual.items():
            RESULT[f'res|{n}'] = e.numpy()
        spread = 0.0
        for seed in (0, 1):
            mr, optr = fresh(seed)
            step(mr, optr, None, batch)
            spread = max(spread, max(
                float(np.abs(a - RESULT[f'comp0|{n}']).max())
                for n, a in flat(mr).items()))
        RESULT['spread'] = np.array(spread)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "pod.npz"
    return out, run_reference(REF_SCRIPT, out, devices=4, shims=True)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return run_ranks(f"REF = {str(ref[0])!r}\n" + PORT_CODE, 4, tmp,
                     timeout=300)


def _plain(ref_out):
    """The port's plain step (whole batch, one process) from the same
    parameters."""
    model = params_from_reference(CFG, unflatten(ref_out, "p0"),
                                  device="cpu")
    ocfg = AdamWConfig(learning_rate=LR)
    opt = init_opt_state(dict(model.named_parameters()), ocfg)
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        DataConfig(vocab_size=64, seq_len=32, global_batch=8)).batch_at(0)
        .items()}
    _, _, _, met = make_train_step(CFG, ocfg)(model, opt, None, batch)
    return ({n: p.detach().numpy() for n, p in model.named_parameters()},
            float(met["loss"]))


def _ref_params(ref_out, prefix):
    return _reference_state(CFG, unflatten(ref_out, prefix))


def _gap(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.abs(got[n] - want[n]).max()) for n in want)


def _rank_params(rank: dict, kind: str) -> dict:
    return {k.split("|", 1)[1]: v for k, v in rank.items()
            if k.startswith(kind + "|")}


def test_ranks_hold_bitwise_equal_parameters_after_every_step(port):
    assert sorted(tuple(r["coord"]) for r in port) == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    for kind in ("exact0", "exact1", "comp0", "comp1"):
        want = _rank_params(port[0], kind)
        assert want
        for r in port[1:]:
            got = _rank_params(r, kind)
            for n in want:
                np.testing.assert_array_equal(got[n], want[n])


def test_exact_pod_step_matches_plain_and_reference(ref, port):
    _, out = ref
    plain, loss = _plain(out)
    got = _rank_params(port[0], "exact0")
    assert _gap(got, plain) < 1e-5
    assert _gap(got, _ref_params(out, "exact")) < 1e-5
    assert abs(float(port[0]["exact|loss"]) - float(out["loss"][0])) < 1e-5
    assert abs(loss - float(out["loss"][0])) < 1e-5


def _ref_residual(out) -> list[dict]:
    """The reference's stacked residual as one port-named dict a pod."""
    tree = unflatten(out, "res")

    def pod_slice(t, p):
        if isinstance(t, dict):
            return {k: pod_slice(v, p) for k, v in t.items()}
        return t[p]

    return [_reference_state(CFG, pod_slice(tree, p)) for p in (0, 1)]


def _ties(port, out) -> dict:
    """Per leaf, the elements where the two packages rounded ``t / scale``
    of one pod to neighbouring integers: there ``t`` sits on a half-step
    tie, so the residuals are ``±scale / 2`` with opposite signs
    (``e_port + e_ref`` ~ 0 while ``e_port - e_ref`` is a whole step)."""
    rows = {int(r["coord"][0]): _rank_params(r, "res0") for r in port}
    want = _ref_residual(out)
    ties = {}
    for n in want[0]:
        mask = np.zeros(want[0][n].shape, dtype=bool)
        for p in (0, 1):
            a, b = rows[p][n][0], want[p][n]
            diff = np.abs(a - b)
            mask |= (diff > 0) & (np.abs(a + b) <= 1e-3 * diff)
        ties[n] = mask
    return ties


def test_compressed_pod_step_within_the_adam_bound(ref, port):
    """Against the plain step: the reference test's 2·lr.  Against the
    reference's int8 step: 4x the one-rounding spread, except at half-step
    ties of the quantizer (``_ties``), where the packages' gradients, equal
    to rounding, quantize to neighbouring integers and Adam's first step
    (``lr * sign``) moves the entry by at most lr.  Ties are rare: the
    quantizer's scale is shared over a stage's layers as in the reference
    (``train.trainer.scale_groups``), without which whole layers would sit
    on another grid."""
    _, out = ref
    plain, _ = _plain(out)
    got = _rank_params(port[0], "comp0")
    assert _gap(got, plain) < 2 * LR
    spread = float(port[0]["spread"])
    assert spread > 0
    want = _ref_params(out, "comp")
    ties = _ties(port, out)
    n_ties = sum(int(m.sum()) for m in ties.values())
    assert n_ties <= 1e-3 * sum(m.size for m in ties.values()), n_ties
    for n in want:
        gap = np.abs(got[n] - want[n])
        assert gap[~ties[n]].max(initial=0.0) <= ROUND_FACTOR * spread, \
            (n, gap[~ties[n]].max(), spread)
        assert gap[ties[n]].max(initial=0.0) <= LR * (1 + 1e-6)
    assert abs(float(port[0]["comp|loss"])
               - float(out["loss"][1])) < 1e-5


def test_residual_rows_are_finite_nonzero_and_per_pod(ref, port):
    """Each rank holds its pod's (1, *shape) row; one pod's data ranks hold
    equal rows, the two pods' differ; after the first step the rows equal
    the reference's stacked residual (its pod axis) to 1e-6 (residuals are
    gradient-sized, <= scale / 2 ~ 1e-4 here, and their gaps come from the
    gradients' rounding, ~1e-7), except at the quantizer's half-step ties
    (``_ties``)."""
    by_pod: dict = {}
    for r in port:
        res = _rank_params(r, "res")
        assert all(np.isfinite(e).all() and e.shape[0] == 1
                   for e in res.values())
        assert any(np.abs(e).max() > 0 for e in res.values())
        pod = int(r["coord"][0])
        if pod in by_pod:
            for n, e in res.items():
                np.testing.assert_array_equal(e, by_pod[pod][n])
        by_pod[pod] = res
    assert any(not np.array_equal(by_pod[0][n], by_pod[1][n])
               for n in by_pod[0])
    _, out = ref
    want = _ref_residual(out)
    ties = _ties(port, out)
    rows = {int(r["coord"][0]): _rank_params(r, "res0") for r in port}
    for p in (0, 1):
        assert set(want[p]) == set(rows[p])
        for n in want[p]:
            gap = np.abs(rows[p][n][0] - want[p][n])[~ties[n]]
            assert gap.max(initial=0.0) <= 1e-6, (p, n, gap.max())


TRAINER_CODE = """
from repro_torch.data import DataConfig
from repro_torch.models import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

cfg = ModelConfig(name='t', num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64,
                  param_dtype='float32', compute_dtype='float32')

def mk(d, total, shape=(2, 2), micro=1, every=3):
    return Trainer(cfg, AdamWConfig(learning_rate=3e-3),
                   DataConfig(vocab_size=64, seq_len=32, global_batch=8),
                   TrainerConfig(total_steps=total, checkpoint_every=every,
                                 checkpoint_dir=f'{TMP}/{d}', mesh_shape=shape,
                                 compress_pods=True, microbatches=micro),
                   device='cpu')
"""


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One world of 4 gloo ranks: the crash-at-5-of-8 restart and the
    uninterrupted run on a (2, 2) mesh, at microbatches 1 and 2 (crash at
    4 of 7), then 4 steps on 4 pods (a (4,) mesh) saved for the pod-count
    reshard."""
    tmp = tmp_path_factory.mktemp("trainer")
    res = run_ranks(f"TMP = {str(tmp)!r}\n" + TRAINER_CODE + """
for micro, total, fail in ((1, 8, 5), (2, 7, 4)):
    try:
        mk(f'a{micro}', total, micro=micro).run(inject_failure_at=fail)
        raise SystemExit('no injected failure?')
    except RuntimeError:
        pass
    ta = mk(f'a{micro}', total, micro=micro); pa, _, _ = ta.run()
    tb = mk(f'b{micro}', total, micro=micro); pb, _, _ = tb.run()
    for (n, a), b in zip(pa.named_parameters(), pb.parameters()):
        RESULT[f'eq|{micro}|{n}'] = np.array(torch.equal(a, b))
    for n in ta.last_residual:
        assert ta.last_residual[n].shape[0] == 2
        RESULT[f'eq|{micro}|res|{n}'] = np.array(
            torch.equal(ta.last_residual[n], tb.last_residual[n]))
tr = mk('pods4', 4, shape=(4,), every=2)
tr.run()
for n, e in tr.last_residual.items():
    RESULT[f'pods4|{n}'] = e.numpy()
""", 4, tmp, timeout=300)
    return tmp, res


def test_compressed_restart_bitwise_identical_to_uninterrupted(trainer_runs):
    """Crash, resume, and match the straight-through run bit for bit:
    parameters AND the residual, at microbatches 1 and 2."""
    _, res = trainer_runs
    for r in res:
        eq = {k: bool(v) for k, v in r.items() if k.startswith("eq|")}
        assert len(eq) > 20 and all(eq.values()), \
            [k for k, v in eq.items() if not v]


def test_pod_count_reshard_preserves_the_applied_correction(trainer_runs):
    """Saved on 4 pods, restored onto 1: the residual becomes the mean of
    the four pods' rows (Σe/n preserved), and training continues."""
    tmp, res = trainer_runs
    one = run_ranks(f"TMP = {str(tmp)!r}\n" + TRAINER_CODE + """
tr = mk('pods4', 6, shape=(1,), every=2)
p, o, r, start = tr.init_or_restore()
RESULT['start'] = np.array(start)
for n, e in r.items():
    RESULT[n] = e.numpy()
_, _, hist = tr.run()
RESULT['hist'] = np.array([s for s, _ in hist])
""", 1, tmp / "one", timeout=300) if (tmp / "one").mkdir() is None else None
    saved = {k.split("|", 1)[1]: v for k, v in res[0].items()
             if k.startswith("pods4|")}
    got = one[0]
    assert int(got["start"]) == 4 and list(got["hist"]) == [6]
    assert saved and all(e.shape[0] == 4 for e in saved.values())
    assert any(np.abs(e).max() > 0 for e in saved.values())
    for n, e in saved.items():
        assert got[n].shape == (1, *e.shape[1:])
        # the correction the next all-reduce folds in: Σe/n, unchanged
        np.testing.assert_allclose(got[n].sum(0) / 1, e.sum(0) / 4,
                                   rtol=1e-6, atol=1e-12)


def test_launcher_trains_pods_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --device
    cpu --mesh-shape 2,2 --compress-pods`` runs a few steps on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               REPRO_LOG="INFO")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--device", "cpu", "--mesh-shape", "2,2", "--compress-pods",
           "--steps", "3", "--batch", "8", "--seq", "16", "--ckpt-every",
           "2", "--ckpt-dir", str(tmp_path / "ckpt")]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002",
                                                     "step_00000003"]
    from repro_torch.checkpoint import Checkpointer
    meta = Checkpointer(str(tmp_path / "ckpt")).read_metadata()
    assert meta["num_pods"] == 2

