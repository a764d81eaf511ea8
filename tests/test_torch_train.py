"""The port's training path (``repro_torch.models.loss_fn`` and its
gradients, remat, ``repro_torch.train``, ``launch/train.py``) against the
JAX reference, on the CPU at the smoke sizes (float32).

The reference runs once for this module, in a subprocess
(``_torch_ref.run_reference``; ``repro.models`` / ``repro.train`` do not
import in the test process on jax 0.9): it draws parameters from
``np.random.default_rng`` on its own ``param_shapes`` and returns them with
``jax.value_and_grad(loss_fn)`` for six smoke configs (B = 2, S = 16) and
one at S = 1024 (two cross-entropy chunks, two attention q blocks), three
``make_train_step`` steps at microbatches 1 and 2, one step with weight
decay, and an int8 optimizer state carried over a step.  The port loads the
same numbers through ``params_from_reference`` /
``opt_state_from_reference``.

Tolerances.  Loss and metrics: ``atol = rtol = 1e-5``.  Gradients: per
leaf, ``|g - g_ref| <= GRAD_TOL * max |g_ref|`` with ``GRAD_TOL = 1e-4``.
Why: one float32 rounding of the weights (each times ``1 +- 2**-24``) moves
the port's own gradients by up to 2.3e-5 of a leaf's largest entry
(deepseek-v2 and jamba; the other configs 1e-6 to 4e-6), and the gaps to
the reference are of that order (at most 1.9e-5, jamba);
``test_grad_tolerance_is_of_the_order_of_one_rounding`` pins that
argument.  After several AdamW steps a fixed tolerance means little: Adam
divides each entry's update by its own gradient scale, so an entry whose
gradient sits within rounding of zero moves by up to ~lr a step in one
package and not the other.  So ``make_train_step`` is held to
``ROUND_FACTOR`` (4) times what one rounding of the weights (two draws)
does to the port's own run: in the metrics, the largest gap relative to
the metric's largest value, over the metrics, steps and entries (plus four
float32 ulps); in the parameters after the last step, the largest gap.
``chip_smoke.py`` holds the card to the same bound against the CPU.

Where the reference disagrees with itself (ROADMAP queue 3): its AdamW
decays "matrices only" and keeps 1-D moments in f32 by a leaf's rank, but
it stacks each stage's leaves over the stages, so its per-layer norms and
Mamba vectors are 2-D there: decayed, and int8 in int8 mode.  The port
applies the rule to its per-layer leaves (no decay, f32 moments for 1-D
leaves), so the parity runs use no weight decay, as the reference's own
microbatch tests do, and ``test_the_reference_decays_its_stacked_1d_
leaves`` pins the difference.
"""

import copy
import json
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_ref import run_reference, unflatten

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import (ModelConfig, MoEConfig, chunked_cross_entropy,
                                forward, init_params, logits_fn, loss_fn,
                                opt_state_from_reference,
                                params_from_reference)
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.convert import _reference_state
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import _load_moment
from repro_torch.train import Trainer, TrainerConfig, make_train_step

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4
ROUND_FACTOR = 4.0
ARCHS = ["deepseek_7b", "gemma2_9b", "falcon_mamba_7b", "jamba_v0_1_52b",
         "deepseek_v2_236b", "musicgen_medium"]
B, S, LONG_S, STEPS = 2, 16, 1024, 3
TINY = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                   num_kv_heads=1, d_ff=64, vocab_size=64,
                   param_dtype="float32", compute_dtype="float32")
TINY_MOE = ModelConfig(name="tm", num_layers=2, d_model=32, num_heads=4,
                       num_kv_heads=2, d_ff=64, vocab_size=64,
                       param_dtype="float32", compute_dtype="float32",
                       moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                                     capacity_factor=8.0, layer_period=2,
                                     layer_offset=1))
TRAIN_CFGS = {"tiny": TINY, "tiny_moe": TINY_MOE}

REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.data import DataConfig, TokenPipeline
from repro.models import ModelConfig, MoEConfig
from repro.models.model import loss_fn, param_shapes
from repro.optim import AdamWConfig, init_opt_state
from repro.train import make_train_step

out = {{}}
vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=3)

def grads_case(tag, cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    params = rand_tree(param_shapes(cfg), rng)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    (loss, met), g = vg(params, jnp.asarray(toks), jnp.asarray(labels), cfg)
    flat_tree(params, f"p:{{tag}}", out)
    flat_tree(g, f"g:{{tag}}", out)
    out[f"{{tag}}|tokens"] = toks
    out[f"{{tag}}|labels"] = labels
    out[f"{{tag}}|loss"] = np.asarray(loss)
    for k, v in met.items():
        out[f"{{tag}}|met|{{k}}"] = np.asarray(v)

for i, arch in enumerate({archs!r}):
    grads_case(arch, get_smoke_config(arch), {B}, {S}, 200 + i)
grads_case("long", get_smoke_config("deepseek_7b"), 1, {long_s}, 300)

# make_train_step, 3 steps, at microbatches 1 and 2 (the configs of
# test_train_compress.py)
TINY = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                   num_kv_heads=1, d_ff=64, vocab_size=64,
                   param_dtype="float32", compute_dtype="float32")
TINY_MOE = ModelConfig(name="tm", num_layers=2, d_model=32, num_heads=4,
                       num_kv_heads=2, d_ff=64, vocab_size=64,
                       param_dtype="float32", compute_dtype="float32",
                       moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                                     capacity_factor=8.0, layer_period=2,
                                     layer_offset=1))
pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=32, global_batch=8))
ocfg = AdamWConfig(learning_rate=1e-3)
for tag, cfg in (("tiny", TINY), ("tiny_moe", TINY_MOE)):
    params0 = rand_tree(param_shapes(cfg), np.random.default_rng(400))
    flat_tree(params0, f"p:{{tag}}", out)
    for micro in (1, 2):
        step = jax.jit(make_train_step(cfg, ocfg, microbatches=micro))
        params = jax.tree.map(jnp.asarray, params0)
        opt = init_opt_state(params, ocfg)
        for s in range({steps}):
            b = {{k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}}
            params, opt, res, met = step(params, opt, None, b)
            assert res is None
            for k, v in met.items():
                out[f"{{tag}}|{{micro}}|{{s}}|{{k}}"] = np.asarray(v)
        flat_tree(params, f"p:{{tag}}:{{micro}}", out)

# one step with weight decay: the reference decays its stacked 1-D leaves
step = jax.jit(make_train_step(TINY, AdamWConfig(learning_rate=1e-3,
                                                 weight_decay=0.1)))
params = jax.tree.map(jnp.asarray, rand_tree(param_shapes(TINY),
                                             np.random.default_rng(400)))
opt = init_opt_state(params, AdamWConfig(weight_decay=0.1))
b = {{k: jnp.asarray(v) for k, v in pipe.batch_at(0).items()}}
params, _, _, _ = step(params, opt, None, b)
flat_tree(params, "p:tiny:wd", out)

# int8 optimizer state after 2 steps, continued one step
cfg = get_smoke_config("deepseek_7b")
ocfg8 = AdamWConfig(learning_rate=1e-3, moment_dtype="int8")
step = jax.jit(make_train_step(cfg, ocfg8))
pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4))
params = jax.tree.map(jnp.asarray,
                      rand_tree(param_shapes(cfg), np.random.default_rng(500)))
opt = init_opt_state(params, ocfg8)
for s in range(3):
    if s == 2:
        flat_tree(params, "p:carry", out)
        flat_tree(opt, "o:carry", out)
    b = {{k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}}
    params, opt, _, met = step(params, opt, None, b)
flat_tree(params, "p:carry:3", out)
flat_tree(opt, "o:carry:3", out)
out["carry|3|loss"] = np.asarray(met["loss"])
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The smoke models' ops are tiny: one CPU thread runs them faster than
    many (and leaves the cores to the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = REF_SCRIPT.format(archs=ARCHS, B=B, S=S, long_s=LONG_S,
                             steps=STEPS)
    return run_reference(code, tmp_path_factory.mktemp("ref") / "train.npz")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _cfg(tag):
    if tag in TRAIN_CFGS:
        return TRAIN_CFGS[tag]
    return get_smoke_config("deepseek_7b" if tag in ("long", "carry")
                            else tag)


def _port(ref, tag, prefix=None):
    return params_from_reference(_cfg(tag), unflatten(ref, prefix or
                                                      f"p:{tag}"),
                                 device="cpu")


def _ref_state(ref, tag, prefix):
    return _reference_state(_cfg(tag), unflatten(ref, prefix))


def _grads(model, tokens, labels, cfg, **kw):
    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    loss, metrics = loss_fn(model, tokens, labels, cfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(names, grads))


def _case(ref, tag):
    cfg = _cfg(tag)
    toks = torch.from_numpy(ref[f"{tag}|tokens"])
    labels = torch.from_numpy(ref[f"{tag}|labels"])
    return cfg, toks, labels


def _rounded(model, seed=0):
    """A copy with every weight times (1 +- 2**-24): one float32 rounding."""
    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -24)
    return out


def _grad_gap(got, want):
    """max over leaves of max |got - want| / max |want|."""
    return max(float((got[n] - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in want)


def _train(model, cfg, micro, opt_cfg=None, steps=STEPS):
    opt_cfg = opt_cfg or AdamWConfig(learning_rate=1e-3)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=32,
                                    global_batch=8))
    step = make_train_step(cfg, opt_cfg, microbatches=micro)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    hist = []
    for s in range(steps):
        model, opt, res, met = step(model, opt, None, pipe.batch_at(s))
        assert res is None
        hist.append(met)
    return model, opt, hist


# ---------------------------------------------------------------------------
# loss_fn and its gradients against jax.value_and_grad(loss_fn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ARCHS + ["long"])
def test_loss_and_grads_match_reference(ref, tag):
    cfg, toks, labels = _case(ref, tag)
    loss, metrics, grads = _grads(_port(ref, tag), toks, labels, cfg)
    np.testing.assert_allclose(float(loss), ref[f"{tag}|loss"], atol=ATOL,
                               rtol=RTOL)
    want_met = {k.split("|")[2]: v for k, v in ref.items()
                if k.startswith(f"{tag}|met|")}
    assert sorted(metrics) == sorted(want_met)
    for k, v in metrics.items():
        if k == "expert_load":
            np.testing.assert_array_equal(v.numpy(), want_met[k])
        else:
            np.testing.assert_allclose(v.numpy(), want_met[k], atol=ATOL,
                                       rtol=RTOL)
    want = {n: torch.from_numpy(g)
            for n, g in _ref_state(ref, tag, f"g:{tag}").items()}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g.dtype == want[n].dtype and g.shape == want[n].shape, n
        bound = GRAD_TOL * float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= bound, n
    if tag == "long":
        assert toks.shape[1] == LONG_S        # 2 CE chunks, 2 q blocks


@pytest.mark.parametrize("tag", ["jamba_v0_1_52b", "deepseek_v2_236b"])
def test_grad_tolerance_is_of_the_order_of_one_rounding(ref, tag):
    """The argument for ``GRAD_TOL``: one float32 rounding of the weights
    moves the port's own gradients by a few 1e-5 of a leaf's largest entry,
    the gap to the reference is within 4x that, and ``GRAD_TOL`` is 4x
    above the floor."""
    cfg, toks, labels = _case(ref, tag)
    model = _port(ref, tag)
    _, _, base = _grads(model, toks, labels, cfg)
    _, _, moved = _grads(_rounded(model), toks, labels, cfg)
    floor = _grad_gap(moved, base)
    want = {n: torch.from_numpy(g)
            for n, g in _ref_state(ref, tag, f"g:{tag}").items()}
    gap = _grad_gap(base, want)
    assert 1e-6 < floor and gap <= 4 * floor, (gap, floor)
    assert GRAD_TOL >= 4 * floor, floor


@pytest.mark.parametrize("tag", ["deepseek_7b", "jamba_v0_1_52b", "long"])
def test_remat_on_and_off_give_bitwise_equal_gradients(ref, tag):
    cfg, toks, labels = _case(ref, tag)
    model = _port(ref, tag)
    l1, m1, g1 = _grads(model, toks, labels, cfg, remat=True)
    l0, m0, g0 = _grads(model, toks, labels, cfg, remat=False)
    assert torch.equal(l1, l0)
    assert sorted(m1) == sorted(m0)
    for k in m1:
        assert torch.equal(m1[k], m0[k]), k
    for n in g1:
        assert torch.equal(g1[n], g0[n]), n


def test_attention_q_block_remat_is_bitwise_the_plain_backward():
    """``differentiable=True`` recomputes each q block in the backward; the
    gradients are bitwise those of the plain loop (3 q blocks, a window
    that skips key chunks)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1536, 4, 8, generator=g)
    k = torch.randn(1, 1536, 2, 8, generator=g)
    v = torch.randn(1, 1536, 2, 8, generator=g)
    out = {}
    for diff in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        y = chunked_causal_attention(*leaves, scale=0.3, attn_cap=50.0,
                                     window=600, differentiable=diff)
        out[diff] = (y.detach(), torch.autograd.grad(y.square().sum(),
                                                      leaves))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_matches_a_plain_cross_entropy():
    cfg = get_smoke_config("gemma2_9b")            # tied head, final softcap
    model = init_params(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn(2, 32, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    from repro_torch.models.model import _unembed
    with torch.no_grad():
        plain = F.cross_entropy(_unembed(model, hidden, cfg).reshape(
            -1, cfg.vocab_size), labels.reshape(-1))
        for chunk in (8, 32, 512):
            got = chunked_cross_entropy(model, hidden, labels, cfg,
                                        chunk=chunk)
            np.testing.assert_allclose(float(got), float(plain), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        chunked_cross_entropy(model, hidden, labels, cfg, chunk=12)


def test_dropped_tokens_get_no_gradient_through_the_dispatch():
    """Tokens that every chosen expert drops (capacity) read the zero row:
    their output and its gradient through the routed path are exactly 0,
    as in the reference, where the drops are sliced away the same way."""
    cfg = ModelConfig(
        name="moe", num_layers=1, d_model=32, num_heads=1, num_kv_heads=1,
        d_ff=64, vocab_size=7, param_dtype="float32", compute_dtype="float32",
        moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=48,
                      capacity_factor=1.25))
    mod = moe_mod.init_moe_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    r = 0.01 * rng.standard_normal((32, 16))
    r[0, 0], r[0, 1] = 5.0, 4.0          # every token to experts 0 then 1
    x = rng.standard_normal((1, 8, 32)).astype(np.float32)
    x[..., 0] = 3.0 + np.abs(x[..., 0])
    with torch.no_grad():
        mod.router.copy_(torch.from_numpy(r.astype(np.float32)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, met = moe_mod.moe_block(mod, xt, cfg)
    assert met["expert_load"].tolist() == [4, 4] + [0] * 14
    (gx,) = torch.autograd.grad(out.sum(), [xt])
    assert torch.count_nonzero(out[0, 4:]) == 0      # tokens 4-7 dropped
    assert torch.count_nonzero(gx[0, 4:]) == 0
    assert torch.count_nonzero(gx[0, :4]) > 0
    # the aux and z losses reach the loss and carry a router gradient
    mod.requires_grad_(True)
    out, met = moe_mod.moe_block(mod, xt, cfg)
    (gr,) = torch.autograd.grad(met["aux_loss"] + met["z_loss"],
                                [mod.router])
    assert torch.count_nonzero(gr) > 0


# ---------------------------------------------------------------------------
# make_train_step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(TRAIN_CFGS))
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(ref, tag, micro):
    cfg = TRAIN_CFGS[tag]
    base = _port(ref, tag)
    model, opt, hist = _train(copy.deepcopy(base), cfg, micro)
    moved = [_train(_rounded(base, seed), cfg, micro) for seed in (0, 1)]
    eps = float(np.finfo(np.float32).eps)
    assert int(opt["step"]) == STEPS
    want = [{k.split("|")[3]: v for k, v in ref.items()
             if k.startswith(f"{tag}|{micro}|{s}|")} for s in range(STEPS)]
    assert all(sorted(hist[s]) == sorted(want[s]) for s in range(STEPS))
    assert "ce" in hist[0]

    def rel_gap(h, base):
        """max over metrics of max |h - base| / max |base|"""
        out = 0.0
        for k in hist[0]:
            a, b = (np.stack([np.asarray(x[s][k]) for s in range(STEPS)])
                    for x in (h, base))
            out = max(out, np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        return out

    gap = rel_gap(hist, want)
    floor = max(rel_gap(h, hist) for _, _, h in moved)
    assert gap <= ROUND_FACTOR * (floor + eps), (gap, floor)
    want = _ref_state(ref, tag, f"p:{tag}:{micro}")
    got = dict(model.named_parameters())
    gap = max(float(np.abs(got[n].detach().numpy() - w).max())
              for n, w in want.items())
    floor = max(float((p.detach() - got[n].detach()).abs().max())
                for m, _, _ in moved for n, p in m.named_parameters())
    assert gap <= ROUND_FACTOR * floor, (gap, floor)


def test_the_reference_decays_its_stacked_1d_leaves(ref):
    """ROADMAP queue 3.  One step with weight decay 0.1 from the same
    parameters: every leaf of two or more dims agrees; each per-layer 1-D
    leaf (stacked over the stages, so 2-D in the reference) is decayed in
    the reference and not in the port, ``ref = port - lr * wd * p0``.  In
    int8 mode the reference stores their moments in int8 too."""
    lr, wd = 1e-3, 0.1
    p0 = _ref_state(ref, "tiny", "p:tiny")
    model, _, _ = _train(_port(ref, "tiny"), TINY, 1,
                         AdamWConfig(learning_rate=lr, weight_decay=wd),
                         steps=1)
    want = _ref_state(ref, "tiny", "p:tiny:wd")
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        if p.dim() >= 2:
            np.testing.assert_allclose(got, want[n], atol=1e-6, rtol=1e-6)
        elif n.startswith("layers."):
            # to two float32 ulps; the decay itself is ~1e-4 * |p0|
            np.testing.assert_allclose(want[n], got - lr * wd * p0[n],
                                       atol=0, rtol=2.5e-7)
            assert np.abs(want[n] - got).max() > 1e-6
        else:                                   # final_norm: top level
            np.testing.assert_allclose(got, want[n], atol=1e-6, rtol=1e-6)
    assert "o:carry|m|stages|sub0|norm_1|q" in ref
    assert ref["o:carry|m|stages|sub0|norm_1|q"].dtype == np.int8


def test_int8_opt_state_carried_from_the_reference(ref):
    """The reference's state after 2 int8 steps, continued one step in both
    packages: parameters and loss agree; q entries of leaves of two or more
    dims may differ by one step where ``t / scale`` sits within rounding of
    a half-integer (at most 1e-3 of them); the 1-D leaves' f32 moments (the
    reference's int8, dequantized) agree within one int8 step."""
    cfg = get_smoke_config("deepseek_7b")
    model = _port(ref, "carry")
    opt = opt_state_from_reference(cfg, unflatten(ref, "o:carry"),
                                   device="cpu")
    assert int(opt["step"]) == 2 and opt["step"].dtype == torch.int32
    assert set(opt["m"]["layers.0.mixer.wq"]) == {"q", "scale"}
    assert opt["m"]["layers.0.norm_1"].dtype == torch.float32
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4))
    step = make_train_step(cfg, AdamWConfig(learning_rate=1e-3,
                                            moment_dtype="int8"))
    model, opt, _, met = step(model, opt, None, pipe.batch_at(2))
    np.testing.assert_allclose(float(met["loss"]), ref["carry|3|loss"],
                               atol=ATOL, rtol=RTOL)
    want = _ref_state(ref, "carry", "p:carry:3")
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6,
                                   rtol=1e-6)
    ref_opt = unflatten(ref, "o:carry:3")
    assert int(ref_opt["step"]) == int(opt["step"]) == 3
    flips = total = 0
    for which, transform in (("m", False), ("v", True)):
        raw = _reference_state(cfg, ref_opt[which])
        for n, got in opt[which].items():
            if isinstance(got, dict):
                d = np.abs(got["q"].numpy().astype(int)
                           - raw[f"{n}.q"].astype(int))
                assert d.max() <= 1, n
                flips, total = flips + int(d.sum()), total + d.size
                np.testing.assert_allclose(got["scale"].numpy(),
                                           raw[f"{n}.scale"], rtol=1e-5)
            elif f"{n}.q" in raw:            # stacked 1-D: int8 there
                q = torch.from_numpy(raw[f"{n}.q"])
                scale = torch.from_numpy(raw[f"{n}.scale"])
                deq = _load_moment({"q": q, "scale": scale}, transform)
                # one int8 step of t: m = t; v = t**2 (signed), so a step
                # of scale in t moves v by scale * (|t| + scale)
                t = q.float() * scale
                step_size = scale * (t.abs() + scale) if transform else scale
                assert bool(((got - deq).abs() <= step_size).all()), n
            else:
                np.testing.assert_allclose(got.numpy(), raw[n], atol=1e-7,
                                           rtol=1e-5)
    assert flips <= 1e-3 * total, (flips, total)


# ---------------------------------------------------------------------------
# the microbatched step (test_train_compress.py, on the port)
# ---------------------------------------------------------------------------

def test_microbatched_step_keeps_ce_metric_and_matches_plain(ref):
    m1, _, h1 = _train(_port(ref, "tiny"), TINY, 1, steps=1)
    m4, _, h4 = _train(_port(ref, "tiny"), TINY, 4, steps=1)
    assert "ce" in h1[0] and "ce" in h4[0]
    assert float(h4[0]["ce"]) == pytest.approx(float(h1[0]["ce"]), rel=1e-4)
    assert float(h4[0]["loss"]) == pytest.approx(float(h1[0]["loss"]),
                                                 rel=1e-4)
    for a, b in zip(m1.parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_microbatched_moe_aux_metrics_accumulated(ref):
    _, _, h1 = _train(_port(ref, "tiny_moe"), TINY_MOE, 1, steps=1)
    _, _, h2 = _train(_port(ref, "tiny_moe"), TINY_MOE, 2, steps=1)
    m1, m2 = h1[0], h2[0]
    for k in ("ce", "aux_loss", "z_loss", "expert_load"):
        assert k in m1 and k in m2, (k, list(m1), list(m2))
    for k in ("ce", "aux_loss", "z_loss"):   # intensive: per-token means
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=5e-2,
                                   atol=1e-3)
    # expert_load is an extensive count: summed across microbatches
    np.testing.assert_allclose(m2["expert_load"].numpy(),
                               m1["expert_load"].numpy(), rtol=0.3)
    assert float(m2["expert_load"].sum()) == float(m1["expert_load"].sum())


def test_microbatches_accumulate_in_f32_buffers(monkeypatch):
    """bf16 parameters: the accumulated gradient is f32, as the reference's
    ``g0``; PyTorch's own ``.grad`` accumulation would round each
    microbatch's sum to bf16."""
    import repro_torch.train.trainer as T
    cfg = TINY.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    seen = {}
    real = T.adamw_update

    def spy(grads, state, params, opt_cfg):
        seen.update({n: g.dtype for n, g in grads.items()})
        return real(grads, state, params, opt_cfg)

    monkeypatch.setattr(T, "adamw_update", spy)
    _train(init_params(cfg, device="cpu"), cfg, 2, steps=1)
    assert set(seen.values()) == {torch.float32}
    seen.clear()
    _train(init_params(cfg, device="cpu"), cfg, 1, steps=1)
    assert seen["embed"] == torch.bfloat16        # one batch: param dtype


def test_pods_and_meshes_wait_for_dist():
    """The pod step needs its mesh (tests/test_torch_train_compress.py runs
    it on gloo ranks); without a pod axis the knobs give the plain step, as
    the reference's do."""
    cfg = AdamWConfig()
    with pytest.raises(ValueError, match="needs the mesh"):
        make_train_step(TINY, cfg, pod_axis="pod")
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        DataConfig(vocab_size=64, seq_len=16, global_batch=2)).batch_at(0)
        .items()}
    outs = []
    for kw in (dict(), dict(compress_pods=True), dict(mesh=object())):
        params = init_params(TINY, device="cpu")
        opt = init_opt_state(dict(params.named_parameters()), cfg)
        step = make_train_step(TINY, cfg, **kw)
        p, _, residual, _ = step(params, opt, None, batch)
        assert residual is None
        outs.append(torch.cat([x.detach().reshape(-1)
                               for x in p.parameters()]))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        make_train_step(TINY, cfg, microbatches=0)
    with pytest.raises(ValueError, match="microbatches"):
        _train(init_params(TINY, device="cpu"), TINY, 3, steps=1)


# ---------------------------------------------------------------------------
# the Trainer (test_substrates.py / test_train_compress.py, on the port)
# ---------------------------------------------------------------------------

def _trainer(tmp, total=10, checkpoint_every=4, batch=4, **kw):
    return Trainer(TINY, AdamWConfig(learning_rate=3e-3),
                   DataConfig(vocab_size=64, seq_len=32, global_batch=batch),
                   TrainerConfig(total_steps=total,
                                 checkpoint_every=checkpoint_every,
                                 checkpoint_dir=tmp, log_every=5, **kw),
                   device="cpu")


def test_trainer_restart_is_bitwise_exact(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure"):
        _trainer(d1).run(inject_failure_at=6)
    p_resumed, o_resumed, _ = _trainer(d1).run()
    p_clean, o_clean, hist = _trainer(d2).run()
    for a, b in zip(p_resumed.parameters(), p_clean.parameters()):
        assert torch.equal(a, b)
    for n in o_clean["m"]:
        assert torch.equal(o_resumed["m"][n], o_clean["m"][n])
        assert torch.equal(o_resumed["v"][n], o_clean["v"][n])
    assert int(o_resumed["step"]) == int(o_clean["step"]) == 10
    # loss actually decreases over training
    assert hist[-1][1] < 4.2


def test_trainer_loss_decreases(tmp_path):
    _, _, hist = _trainer(str(tmp_path), total=30).run()
    assert hist[-1][1] < hist[0][1]


def test_trainer_microbatches_knob_is_wired(tmp_path):
    p1, _, _ = _trainer(str(tmp_path / "a"), total=3, checkpoint_every=10,
                        batch=8, microbatches=1).run()
    p4, _, _ = _trainer(str(tmp_path / "b"), total=3, checkpoint_every=10,
                        batch=8, microbatches=4).run()
    for a, b in zip(p1.parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_trainer_plain_path_residual_none_roundtrip(tmp_path):
    d = str(tmp_path)
    tr = _trainer(d, total=2, checkpoint_every=2, batch=8)
    tr.run()
    assert tr.last_residual is None
    tr2 = _trainer(d, total=4, checkpoint_every=2, batch=8)
    params, opt, residual, start = tr2.init_or_restore()
    assert residual is None and start == 2 and int(opt["step"]) == 2
    assert params.embed.requires_grad


def test_trainer_mesh_and_compress_pods_wait_for_dist(tmp_path):
    """A mesh needs a process group (the pod Trainer runs on gloo ranks in
    tests/test_torch_train_compress.py), and compress_pods needs a mesh, as
    in the reference."""
    with pytest.raises(ValueError, match="process group"):
        _trainer(str(tmp_path), mesh_shape=(2,))
    with pytest.raises(ValueError, match="requires mesh_shape"):
        _trainer(str(tmp_path), compress_pods=True)


def test_trainer_records_step_spans_and_histogram(tmp_path):
    from repro_torch.obs import MetricsRegistry, Tracer
    tracer, metrics = Tracer(), MetricsRegistry()
    tr = Trainer(TINY, AdamWConfig(), DataConfig(vocab_size=64, seq_len=16,
                                                 global_batch=2),
                 TrainerConfig(total_steps=3, checkpoint_dir=str(tmp_path)),
                 tracer=tracer, metrics=metrics, device="cpu")
    _, _, hist = tr.run()
    assert [s for s, _ in hist] == [3]
    assert metrics.histogram("train.step_s").count == 3
    assert len(tracer) == 3


def test_entry_points_take_the_card_unless_told(tmp_path, monkeypatch):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TINY, AdamWConfig(), DataConfig(64, 16, 2),
                TrainerConfig(checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt_state_from_reference(TINY, {})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu_with_a_valid_trace(tmp_path,
                                                       monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import check
    out = tmp_path / "trace.json"
    launch_train.main(["--device", "cpu", "--arch", "deepseek-7b",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every",
                       "2", "--trace", str(out)])
    obj = json.loads(out.read_text())
    assert sum(e.get("name") == "train.step" for e in obj["traceEvents"]) == 4
    monkeypatch.setattr(sys, "argv", ["check", str(out), "--require",
                                      "train.step", "--require-metrics",
                                      "train.step_s"])
    check.main()
    # a mesh runs under torchrun (tests/test_torch_train_compress.py);
    # compress_pods needs a mesh
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flag, match in ((["--mesh-shape", "2,2"], "torchrun"),
                        (["--compress-pods"], "requires mesh_shape")):
        with pytest.raises(ValueError, match=match):
            launch_train.main(["--device", "cpu", "--steps", "1",
                               "--ckpt-dir", str(tmp_path / "x")] + flag)
