"""The port's dense GQA models (``repro_torch.models``) against the JAX
reference, on the CPU at the smoke sizes (float32).

The reference runs once for this module, in a subprocess
(``_torch_ref.run_reference``): it draws each smoke config's parameters from
``np.random.default_rng`` on the reference's own ``param_shapes`` and
returns them with its logits and tokens.  The port loads the same numbers
through ``params_from_reference``, so both compute the same function.

Tolerance for every logit comparison: ``atol = rtol = 1e-5`` (float32 in
both packages, different summation orders).  Greedy tokens must be equal.
"""

import re

import numpy as np
import pytest
import torch

from _torch_ref import run_reference, unflatten

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (ModelConfig, decode_step, init_params,
                                logits_fn, model_flops, param_shapes,
                                params_from_reference, prefill_step)
from repro_torch.models.transformer import NOT_PORTED

ATOL = RTOL = 1e-5
DENSE = ["musicgen_medium", "deepseek_7b", "phi3_medium_14b", "gemma2_9b",
         "yi_34b", "chameleon_34b"]
NOT_YET = ["deepseek_v2_236b", "arctic_480b", "falcon_mamba_7b",
           "jamba_v0_1_52b"]
B, S, S0, STEPS = 2, 16, 8, 8
VEC_POS = [8, 5]          # per-row decode positions after the S0 prefill

REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.models import (ModelConfig, decode_step, init_params, logits_fn,
                          prefill_step)
from repro.models.model import param_shapes

# jitted: one compile per function and config instead of op-by-op dispatch
logits_fn = jax.jit(logits_fn, static_argnums=2)
prefill_step = jax.jit(prefill_step, static_argnums=(2, 3))
decode_step = jax.jit(decode_step, static_argnums=4)
ARCHS = {archs!r}
B, S, S0, STEPS, VEC_POS = {B}, {S}, {S0}, {STEPS}, {vec_pos!r}
out = {{}}
for i, arch in enumerate(ARCHS):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(100 + i)
    params = rand_tree(param_shapes(cfg), rng)
    flat_tree(params, arch, out)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out[f"{{arch}}|tokens"] = toks
    lg, _ = logits_fn(params, jnp.asarray(toks), cfg)
    out[f"{{arch}}|logits"] = np.asarray(lg)
    lp, caches = prefill_step(params, jnp.asarray(toks[:, :S0]), cfg,
                              max_len=S)
    out[f"{{arch}}|prefill"] = np.asarray(lp)
    ld, _ = decode_step(params, caches, jnp.asarray(toks[:, S0:S0 + 1]),
                        jnp.int32(S0), cfg)
    out[f"{{arch}}|decode_scalar"] = np.asarray(ld)
    lv, _ = decode_step(params, caches, jnp.asarray(toks[:, S0:S0 + 1]),
                        jnp.asarray(VEC_POS, jnp.int32), cfg)
    out[f"{{arch}}|decode_vector"] = np.asarray(lv)
    gen = []
    lg_, c = lp, caches
    for t in range(STEPS):
        nxt = jnp.argmax(lg_, axis=-1).astype(jnp.int32)
        gen.append(np.asarray(nxt))
        lg_, c = decode_step(params, c, nxt[:, None], jnp.int32(S0 + t), cfg)
    out[f"{{arch}}|greedy"] = np.stack(gen, axis=1)
    full = get_config(arch)
    out[f"{{arch}}|param_count"] = np.asarray(full.param_count())
    leaves = jax.tree.leaves(jax.eval_shape(
        lambda: init_params(jax.random.key(0), full)))
    out[f"{{arch}}|leaf_sum"] = np.asarray(
        sum(int(np.prod(x.shape)) for x in leaves))

# test_models.py::test_local_window_changes_long_range_attention, with
# parameters from the rng
base = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
            vocab_size=11, param_dtype="float32", compute_dtype="float32")
cfg_local = ModelConfig(name="loc", window_pattern=("local",), local_window=4,
                        **base)
cfg_global = ModelConfig(name="glob", **base)
rng = np.random.default_rng(7)
params = rand_tree(param_shapes(cfg_local), rng)
flat_tree(params, "window", out)
toks = rng.integers(0, 11, (1, 32)).astype(np.int32)
out["window|tokens"] = toks
out["window|local"] = np.asarray(logits_fn(params, jnp.asarray(toks),
                                           cfg_local)[0])
out["window|global"] = np.asarray(logits_fn(params, jnp.asarray(toks),
                                            cfg_global)[0])
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = REF_SCRIPT.format(archs=DENSE, B=B, S=S, S0=S0, STEPS=STEPS,
                             vec_pos=VEC_POS)
    return run_reference(code, tmp_path_factory.mktemp("ref") / "models.npz")


def _port(ref, arch, cfg):
    return params_from_reference(cfg, unflatten(ref, arch), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference(ref, arch):
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    with torch.inference_mode():
        full, metrics = logits_fn(model, toks, cfg)
        last, caches = prefill_step(model, toks[:, :S0], cfg, max_len=S)
    assert metrics == {}
    _close(full, ref[f"{arch}|logits"])
    _close(last, ref[f"{arch}|prefill"])
    assert caches["k"].shape == (cfg.num_layers, B, S, cfg.num_kv_heads,
                                 cfg.head_dim)
    assert torch.count_nonzero(caches["k"][:, :, S0:]) == 0


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_logits_match_reference(ref, arch, kind):
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    pos = S0 if kind == "scalar" else torch.tensor(VEC_POS, dtype=torch.int32)
    with torch.inference_mode():
        _, caches = prefill_step(model, toks[:, :S0], cfg, max_len=S)
        lg, caches = decode_step(model, caches, toks[:, S0:S0 + 1], pos, cfg)
    _close(lg, ref[f"{arch}|decode_{kind}"])
    # the token landed in place, at each row's position
    rows = [S0, S0] if kind == "scalar" else VEC_POS
    for b, p in enumerate(rows):
        assert torch.count_nonzero(caches["k"][:, b, p]) > 0


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_equal_reference(ref, arch):
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    gen = []
    with torch.inference_mode():
        lg, caches = prefill_step(model, toks[:, :S0], cfg, max_len=S)
        for t in range(STEPS):
            nxt = lg.argmax(dim=-1).to(torch.int32)
            gen.append(nxt)
            lg, caches = decode_step(model, caches, nxt[:, None], S0 + t, cfg)
    np.testing.assert_array_equal(torch.stack(gen, 1).numpy(),
                                  ref[f"{arch}|greedy"])


def test_local_window_changes_long_range_attention(ref):
    base = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                d_ff=64, vocab_size=11, param_dtype="float32",
                compute_dtype="float32")
    cfg_local = ModelConfig(name="loc", window_pattern=("local",),
                            local_window=4, **base)
    cfg_global = ModelConfig(name="glob", **base)
    tree = unflatten(ref, "window")
    toks = torch.from_numpy(ref["window|tokens"])
    with torch.inference_mode():
        l_loc = logits_fn(params_from_reference(cfg_local, tree,
                                                device="cpu"), toks,
                          cfg_local)[0]
        l_glob = logits_fn(params_from_reference(cfg_global, tree,
                                                 device="cpu"), toks,
                           cfg_global)[0]
    _close(l_loc, ref["window|local"])
    _close(l_glob, ref["window|global"])
    assert not np.allclose(l_loc[:, -1].numpy(), l_glob[:, -1].numpy(),
                           atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_full_config_param_count_equals_reference(ref, arch):
    """The port counts the reference's parameter leaves exactly.  The
    reference's own ``param_count`` is one more: its tree walk counts the
    empty ``first`` list (no leading dense layers) as a 0-d leaf of one
    parameter (ROADMAP queue 3)."""
    cfg = get_config(arch)
    assert cfg.param_count() == int(ref[f"{arch}|leaf_sum"])
    assert int(ref[f"{arch}|param_count"]) == cfg.param_count() + 1
    assert cfg.active_param_count() == cfg.param_count()
    assert model_flops(cfg, 10, train=False) == 2.0 * cfg.param_count() * 10


@pytest.mark.parametrize("arch", NOT_YET)
def test_unported_blocks_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="item 7b"):
        get_config(arch).param_count()
    with pytest.raises(NotImplementedError, match=re.escape(NOT_PORTED)):
        init_params(get_smoke_config(arch), device="cpu")


def test_params_from_reference_rejects_a_mismatched_tree(ref):
    cfg = get_smoke_config("deepseek_7b")
    tree = unflatten(ref, "deepseek_7b")
    bad = dict(tree, stages={"sub0": dict(tree["stages"]["sub0"],
                                          extra=np.zeros((3, 2), np.float32))})
    with pytest.raises(ValueError, match="reference only"):
        params_from_reference(cfg, bad, device="cpu")
    wq = tree["stages"]["sub0"]["mixer"]["wq"]
    mixer = dict(tree["stages"]["sub0"]["mixer"], wq=wq[:, :, :-1])
    bad = dict(tree, stages={"sub0": dict(tree["stages"]["sub0"],
                                          mixer=mixer)})
    with pytest.raises(ValueError, match="mixer.wq"):
        params_from_reference(cfg, bad, device="cpu")


def test_init_params_is_seeded_and_needs_a_device_or_the_card(monkeypatch):
    cfg = get_smoke_config("gemma2_9b")
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.mixer.wq"], sc["layers.0.mixer.wq"])
    assert set(sa) == set(param_shapes(cfg))
    assert "lm_head" not in sa                  # tied embeddings
    assert sa["final_norm"].dtype == torch.float32
    # the reference's scales: truncated normal / sqrt(fan_in), embed 0.02
    wq = sa["layers.0.mixer.wq"]
    assert float(wq.abs().max()) <= 3.0 / cfg.d_model ** 0.5
    assert abs(float(sa["embed"].std()) - 0.02) < 0.002
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
