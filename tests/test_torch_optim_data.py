"""The port's optimizer, schedules, data pipeline and checkpointer
(``repro_torch.optim`` / ``.data`` / ``.checkpoint``) against the JAX
reference's, in-process on the CPU (these three reference packages import
on jax 0.9; ``repro.models`` / ``repro.train`` do not, see
``test_torch_train.py``).

AdamW: 5 steps from the same parameters and gradients in both packages,
for each moment dtype, with clipping active and inactive and weight decay
on the leaves of two or more dims only.  Parameters and float moments
agree within ``atol = rtol = 1e-6`` (float32 in both; XLA fuses the
update's multiply-adds, so a few entries differ in their last bit).
Stored moments round that float32 value once more, so where it falls
within such a last-bit difference of a rounding boundary the two packages
store neighbouring values: a bfloat16 moment may then differ by one
bfloat16 step (``2**-7`` relative at most), an int8 ``q`` entry (``round(t
/ scale)``) by exactly one step, in at most ``FLIPS`` of the entries; the
int8 scales agree within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefPipeline
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import constant as ref_constant
from repro.optim import init_opt_state as ref_init_opt_state
from repro.optim import inverse_sqrt as ref_inverse_sqrt
from repro.optim import warmup_cosine as ref_warmup_cosine

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.optim import (AdamWConfig, adamw_update, constant,
                               init_opt_state, inverse_sqrt, warmup_cosine)

TOL = 1e-6
FLIPS = 1e-3
SHAPES = {"w": (8, 256), "b": (16,), "stack": (3, 12, 40), "emb": (50, 64)}


# ---------------------------------------------------------------------------
# AdamW against repro.optim
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _assert_moment(got, want):
    if isinstance(want, dict):
        q, wq = got["q"].numpy().astype(int), np.asarray(want["q"], int)
        diff = np.abs(q - wq)
        assert diff.max() <= 1
        assert diff.mean() <= FLIPS, diff.mean()
        np.testing.assert_allclose(got["scale"].numpy(),
                                   np.asarray(want["scale"]), rtol=TOL,
                                   atol=0)
    elif got.dtype == torch.bfloat16:
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        off = g != w
        assert off.mean() <= FLIPS, off.mean()
        assert np.all(np.abs(g - w)[off] <= 2.0 ** -7 * np.abs(w)[off])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_reference_over_five_steps(moment_dtype, clip):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    clip_norm = 1.0 if clip == "active" else 1e3
    kw = dict(weight_decay=0.1, moment_dtype=moment_dtype,
              grad_clip_norm=clip_norm)
    ref_cfg = RefAdamWConfig(learning_rate=ref_warmup_cosine(1e-2, 2, 5), **kw)
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-2, 2, 5), **kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ref_init_opt_state(rp, ref_cfg)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ps = init_opt_state(pp, cfg)
    for _ in range(5):
        g = _tree(rng, scale=0.5)
        rp, rs, rm = ref_adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                      rs, rp, ref_cfg)
        pp, ps, pm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                  ps, pp, cfg)
        for k in SHAPES:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=TOL, atol=TOL)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=TOL)
    assert (float(pm["grad_norm"]) > clip_norm) == (clip == "active")
    assert int(ps["step"]) == int(rs["step"]) == 5
    for which in ("m", "v"):
        for k in SHAPES:
            _assert_moment(ps[which][k], rs[which][k])
    # int8 stores every leaf of two or more dims as q + per-row scales, 1-D
    # leaves in f32; the float modes store every leaf in their dtype
    if moment_dtype == "int8":
        assert set(ps["m"]["w"]) == {"q", "scale"}
        assert ps["m"]["w"]["scale"].shape == (8, 1)
        assert ps["m"]["b"].dtype == torch.float32
    else:
        assert ps["m"]["b"].dtype == getattr(torch, moment_dtype)


def test_adamw_decays_only_leaves_of_two_or_more_dims():
    p = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    cfg = AdamWConfig(learning_rate=0.1, weight_decay=0.5)
    state = init_opt_state(p, cfg)
    p, _, _ = adamw_update({k: torch.zeros_like(v) for k, v in p.items()},
                           state, p, cfg)
    assert torch.all(p["w"] == 0.95) and torch.all(p["b"] == 1.0)


def test_adamw_updates_in_place_and_keeps_param_dtype():
    p = {"w": torch.ones(4, 8, dtype=torch.bfloat16)}
    ptr = p["w"].data_ptr()
    cfg = AdamWConfig(learning_rate=1e-2, moment_dtype="int8")
    state = init_opt_state(p, cfg)
    out, state, _ = adamw_update({"w": torch.full((4, 8), 0.1)}, state, p, cfg)
    assert out["w"].data_ptr() == ptr and out["w"].dtype == torch.bfloat16
    assert state["m"]["w"]["q"].dtype == torch.int8


# the AdamW tests of test_substrates.py, on the port ------------------------

def _adam_ref(p, g, m, v, step, lr, b1, b2, eps, wd):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1 ** step)
    vh = v / (1 - b2 ** step)
    p = p * (1 - lr * wd) - lr * mh / (np.sqrt(vh) + eps)
    return p, m, v


def test_adamw_matches_numpy_f32():
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.normal(0, 1, (8, 16)).astype(np.float32))}
    cfg = AdamWConfig(learning_rate=1e-2, weight_decay=0.1,
                      grad_clip_norm=None)
    state = init_opt_state(p, cfg)
    pn, mn, vn = p["w"].numpy().copy(), np.zeros((8, 16)), np.zeros((8, 16))
    for step in range(1, 4):
        g = rng.normal(0, 1, (8, 16)).astype(np.float32)
        p, state, _ = adamw_update({"w": torch.from_numpy(g)}, state, p, cfg)
        pn, mn, vn = _adam_ref(pn, g, mn, vn, step, 1e-2, 0.9, 0.95, 1e-8, 0.1)
        np.testing.assert_allclose(p["w"].numpy(), pn, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16", "int8"])
def test_adamw_moment_dtypes_converge_similarly(mdt):
    """A quadratic toy: all moment precisions reach a much lower loss."""
    target = torch.from_numpy(
        np.random.default_rng(1).normal(0, 1, (16, 64)).astype(np.float32))
    p = {"w": torch.zeros(16, 64)}
    cfg = AdamWConfig(learning_rate=5e-2, moment_dtype=mdt,
                      grad_clip_norm=None)
    state = init_opt_state(p, cfg)

    def loss(w):
        return torch.mean((w - target) ** 2)

    l0 = float(loss(p["w"]))
    for _ in range(60):
        w = p["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(w), [w])
        p, state, _ = adamw_update({"w": g}, state, p, cfg)
    assert float(loss(p["w"])) < 0.05 * l0, mdt


def test_grad_clipping():
    p = {"w": torch.zeros(4)}
    cfg = AdamWConfig(learning_rate=1.0, grad_clip_norm=1.0)
    state = init_opt_state(p, cfg)
    _, _, metrics = adamw_update({"w": torch.full((4,), 100.0)}, state, p, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (1e-3, 10, 100)),
    ("warmup_cosine", (3e-3, 10, 4)),
    ("inverse_sqrt", (1e-3, 10)),
])
def test_schedules_match_reference_at_every_step(name, args):
    port = {"constant": constant, "warmup_cosine": warmup_cosine,
            "inverse_sqrt": inverse_sqrt}[name](*args)
    ref = {"constant": ref_constant, "warmup_cosine": ref_warmup_cosine,
           "inverse_sqrt": ref_inverse_sqrt}[name](*args)
    for step in range(0, 121):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.asarray(ref(jnp.int32(step)))
        np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=0)


def test_warmup_cosine_schedule():
    f = warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    assert float(f(torch.tensor(5))) == pytest.approx(5e-4)
    assert float(f(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(f(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-2)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(vocab_size=100, seq_len=32, global_batch=4, seed=3),
    dict(vocab_size=102400, seq_len=512, global_batch=4, seed=0),
    dict(vocab_size=50, seq_len=8, global_batch=8, seed=0, zipf_a=1.5),
])
def test_pipeline_bitwise_equal_to_reference(cfg):
    port, ref = TokenPipeline(DataConfig(**cfg)), RefPipeline(
        RefDataConfig(**cfg))
    for step in (0, 1, 7, 1000):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    n = cfg["global_batch"]
    for shards in (1, 2, 4):
        for s in range(shards):
            a, b = port.shard_at(5, s, shards), ref.shard_at(5, s, shards)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert port.shard_at(5, 0, 1)["tokens"].shape[0] == n


def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=4, seed=3)
    a, b = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in [0, 7, 1000]:
        np.testing.assert_array_equal(a.batch_at(step)["tokens"],
                                      b.batch_at(step)["tokens"])
    assert not np.array_equal(a.batch_at(1)["tokens"], a.batch_at(2)["tokens"])


def test_pipeline_shards_partition_global_batch():
    p = TokenPipeline(DataConfig(vocab_size=50, seq_len=8, global_batch=8))
    full = p.batch_at(5)["tokens"]
    parts = [p.shard_at(5, s, 4)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_pipeline_labels_are_learnable():
    b = TokenPipeline(DataConfig(vocab_size=64, seq_len=128,
                                 global_batch=4)).batch_at(0)
    frac = np.mean(b["labels"] == (b["tokens"] + 1) % 64)
    assert frac > 0.2


# ---------------------------------------------------------------------------
# checkpointer (the four of test_substrates.py, then the port's own)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": [torch.ones(4), {"c": torch.zeros(())}]}
    for step in [1, 2, 3]:
        ck.save(step, tree, blocking=True)
    assert ck.available_steps() == [2, 3]
    out = ck.restore(tree, device="cpu")
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"][1]["c"], tree["b"][1]["c"])
    assert ck.read_metadata()["step"] == 3


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(10, {"w": torch.ones(128, 128)})          # async
    ck.wait()
    assert ck.latest_step() == 10


def test_async_save_snapshots_leaves_updated_in_place(tmp_path):
    """The trainer updates its parameters in place while a save is in
    flight: the checkpoint holds the values at ``save()``."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(1 << 20)
    ck.save(1, {"w": w})                  # async
    w.add_(1.0)
    ck.wait()
    assert torch.count_nonzero(ck.restore({"w": w}, device="cpu")["w"]) == 0


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"w": torch.ones(8)}, blocking=True)
    assert all(n.startswith("step_") for n in os.listdir(tmp_path))


def test_int8_opt_state_checkpoint_roundtrip(tmp_path):
    p = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (8, 256)).astype(np.float32)), "b": torch.ones(8)}
    cfg = AdamWConfig(moment_dtype="int8")
    state = init_opt_state(p, cfg)
    _, state, _ = adamw_update({"w": torch.full((8, 256), 0.1),
                                "b": torch.full((8,), 0.1)}, state, p, cfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=True)
    out = ck.restore(state, device="cpu")
    assert out["m"]["w"]["q"].dtype == torch.int8
    assert torch.equal(out["m"]["w"]["q"], state["m"]["w"]["q"])
    assert torch.equal(out["v"]["w"]["scale"], state["v"]["w"]["scale"])
    assert torch.equal(out["m"]["b"], state["m"]["b"])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 1


def test_checkpoint_restore_casts_to_the_template_and_raises_on_a_mesh(
        tmp_path):
    """restore casts every leaf to its template's dtype; a ``None``
    sharding leaves the leaf as restored; a missing directory raises."""
    ck = Checkpointer(str(tmp_path))
    ck.save(4, {"w": torch.arange(6, dtype=torch.float32)}, blocking=True)
    out = ck.restore({"w": torch.zeros(6, dtype=torch.float64)}, device="cpu")
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float64))
    # shardings place leaves on a mesh (tests/test_torch_dist.py); a None
    # leaf stays as it was restored, as in the reference's reshard_tree
    kept = ck.restore({"w": torch.zeros(6)}, device="cpu",
                      shardings={"w": None})
    assert torch.equal(kept["w"], torch.arange(6, dtype=torch.float32))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({}, device="cpu")


def test_checkpoint_restore_takes_the_card_unless_told(tmp_path,
                                                       monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(3)}, blocking=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore({"w": torch.zeros(3)})


def test_bf16_leaves_roundtrip_with_their_dtype_where_the_reference_loses_it(
        tmp_path):
    """ROADMAP queue 3: the reference's ``np.savez`` of a bf16 leaf reads
    back as a raw ``|V2`` array (the bits survive, the dtype does not); the
    port stores the 16-bit patterns with the dtype in ``meta.json`` and
    restores bf16 with equal bits."""
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    ref_ck = RefCheckpointer(str(tmp_path / "ref"))
    ref_leaf = jnp.asarray(x, jnp.bfloat16)
    ref_ck.save(1, {"w": ref_leaf}, blocking=True)
    back = ref_ck.restore({"w": ref_leaf})["w"]
    assert back.dtype == np.dtype("V2")
    np.testing.assert_array_equal(back.view(np.uint16),
                                  np.asarray(ref_leaf).view(np.uint16))

    ck = Checkpointer(str(tmp_path / "port"))
    leaf = torch.from_numpy(x).to(torch.bfloat16)
    ck.save(1, {"w": leaf, "f": torch.ones(2)}, blocking=True)
    meta = json.loads((tmp_path / "port" / "step_00000001" /
                       "meta.json").read_text())
    assert meta["dtypes"] == {"w": "bfloat16", "f": "float32"}
    out = ck.restore({"w": leaf, "f": torch.ones(2)}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), leaf.view(torch.int16))
    # the bits are the reference's too
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy()
                                  .view(np.uint16),
                                  np.asarray(ref_leaf).view(np.uint16))


def test_reference_bf16_arrays_carry_their_bits_into_the_port():
    """``np.asarray`` of a jax bf16 array has numpy's ``ml_dtypes``
    bfloat16 dtype, which ``torch.from_numpy`` refuses; the converter that
    carries reference parameters and optimizer states keeps its bits."""
    from repro_torch.models.convert import _tensor
    x = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    got = _tensor(np.asarray(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16),
                                  np.asarray(x).view(np.uint16))
