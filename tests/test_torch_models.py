"""The port's models (``repro_torch.models``) against the JAX reference, on
the CPU at the smoke sizes (float32), for all ten configurations: the dense
GQA stacks, MLA + MoE (deepseek-v2), MoE with a dense residual (arctic),
Mamba (falcon-mamba) and the Mamba / attention / MoE hybrid (jamba).

The reference runs once for this module, in a subprocess
(``_torch_ref.run_reference``): it draws each smoke config's parameters from
``np.random.default_rng`` on the reference's own ``param_shapes`` and
returns them with its logits, tokens, MoE metrics and routed expert ids.
The port loads the same numbers through ``params_from_reference``, so both
compute the same function.

Tolerance for the logit comparisons: ``atol = rtol = 1e-5`` (float32 in
both packages, different summation orders), except for jamba and
deepseek-v2, where it is ``1e-4`` (``TOL``).  Why: these two stacks
amplify float32 rounding past 1e-5.  Multiplying every weight of the
tests' jamba model by ``1 ± 2**-24`` (one rounding) moves its logits by up
to 2.2e-5 in the port alone (deepseek-v2's: 1.9e-5), past the 1e-5
criterion, and the port's gaps to the reference are of that order (2.5e-5
and 2.9e-5).  ``test_tolerance_is_of_the_order_of_one_rounding`` pins that
argument; 1e-4 stays below the reference's own streaming-vs-batch bound
for Mamba (2e-4, ``test_models.py``).  Greedy tokens must be equal, and
for the MoE configs the routed expert ids are compared, exactly, before
any value.
"""

import numpy as np
import pytest
import torch

from _torch_ref import run_reference, unflatten

from repro_torch.configs import all_arch_names, get_config, get_smoke_config
from repro_torch.models import (ModelConfig, decode_step, init_params,
                                logits_fn, model_flops, param_shapes,
                                params_from_reference, prefill_step)
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import MAMBA_LEAVES, attn_leaves

ATOL = RTOL = 1e-5
TOL = {"jamba_v0_1_52b": 1e-4, "deepseek_v2_236b": 1e-4}
ARCHS = all_arch_names()
MOE = ["deepseek_v2_236b", "arctic_480b", "jamba_v0_1_52b"]
B, S, S0, STEPS = 2, 16, 8, 8
VEC_POS = [8, 5]          # per-row decode positions after the S0 prefill

REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.models import (ModelConfig, decode_step, init_params, logits_fn,
                          prefill_step)
from repro.models.model import param_shapes

# the routed expert ids of every MoE layer, in call order
REC = []
_top_k = jax.lax.top_k
def top_k_rec(x, k):
    v, i = _top_k(x, k)
    jax.debug.callback(lambda a: REC.append(np.asarray(a)), i, ordered=True)
    return v, i
jax.lax.top_k = top_k_rec

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
    REC.clear()
    lg, met = logits_fn(params, jnp.asarray(toks), cfg)
    out[f"{{arch}}|logits"] = np.asarray(lg)
    jax.effects_barrier()
    for k, ids in enumerate(REC):
        out[f"{{arch}}|ids|{{k}}"] = ids
    for k, v in met.items():
        out[f"{{arch}}|met|{{k}}"] = np.asarray(v)
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
    out[f"{{arch}}|active_param_count"] = np.asarray(
        full.active_param_count())
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
    code = REF_SCRIPT.format(archs=ARCHS, B=B, S=S, S0=S0, STEPS=STEPS,
                             vec_pos=VEC_POS)
    return run_reference(code, tmp_path_factory.mktemp("ref") / "models.npz")


def _port(ref, arch, cfg):
    return params_from_reference(cfg, unflatten(ref, arch), device="cpu")


def _close(got, want, arch=None):
    tol = TOL.get(arch, ATOL)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def _ref_ids(ref, arch):
    n = sum(1 for k in ref if k.startswith(f"{arch}|ids|"))
    return [ref[f"{arch}|ids|{k}"] for k in range(n)]


@pytest.fixture
def routed(monkeypatch):
    """The expert ids of every MoE layer the port runs, in call order."""
    calls = []
    route = moe_mod._route

    def record(*args):
        out = route(*args)
        calls.append(out[3].numpy())
        return out

    monkeypatch.setattr(moe_mod, "_route", record)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(ref, arch, routed):
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    with torch.inference_mode():
        full, metrics = logits_fn(model, toks, cfg)
        want_ids = _ref_ids(ref, arch)
        assert len(routed) == len(want_ids) == (
            sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)))
        for got, want in zip(routed, want_ids):
            np.testing.assert_array_equal(got, want)
        last, caches = prefill_step(model, toks[:, :S0], cfg, max_len=S)
    _close(full, ref[f"{arch}|logits"], arch)
    _close(last, ref[f"{arch}|prefill"], arch)
    assert sorted(metrics) == sorted(k.split("|")[2] for k in ref
                                     if k.startswith(f"{arch}|met|"))
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), ref[f"{arch}|met|{k}"],
                                   atol=1e-6, rtol=1e-6)
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if "attn" in kinds:
        k0 = attn_leaves(cfg)[0]
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.num_layers))
        assert caches[k0].shape[:3] == (n_attn, B, S)
        assert torch.count_nonzero(caches[k0][:, :, S0:]) == 0
    if "mamba" in kinds:
        n_m = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.num_layers))
        assert caches["conv"].shape == (n_m, B, cfg.ssm.d_conv - 1,
                                        cfg.ssm.d_inner)
        assert caches["ssm"].shape == (n_m, B, cfg.ssm.d_inner,
                                       cfg.ssm.d_state)
        assert caches["ssm"].dtype == torch.float32
    assert set(caches) == ({*attn_leaves(cfg)} if "attn" in kinds else set()) \
        | ({*MAMBA_LEAVES} if "mamba" in kinds else set())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_logits_match_reference(ref, arch, kind):
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    pos = S0 if kind == "scalar" else torch.tensor(VEC_POS, dtype=torch.int32)
    with torch.inference_mode():
        _, caches = prefill_step(model, toks[:, :S0], cfg, max_len=S)
        before = {k: v.clone() for k, v in caches.items()}
        lg, caches = decode_step(model, caches, toks[:, S0:S0 + 1], pos, cfg)
    _close(lg, ref[f"{arch}|decode_{kind}"], arch)
    # the token landed in place, at each row's position; the state moved
    rows = [S0, S0] if kind == "scalar" else VEC_POS
    if any(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers)):
        k0 = attn_leaves(cfg)[0]
        for b, p in enumerate(rows):
            assert torch.count_nonzero(caches[k0][:, b, p]) > 0
    for name in set(MAMBA_LEAVES) & set(caches):
        assert not torch.equal(caches[name], before[name])


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "deepseek_v2_236b"])
def test_tolerance_is_of_the_order_of_one_rounding(ref, arch):
    """The argument for ``TOL``: the port's gap to the reference is within
    4x what one float32 rounding of the weights (each multiplied by ``1 ±
    2**-24``) does to the port's own logits, and that rounding alone moves
    some logit past the 1e-5 criterion."""
    cfg = get_smoke_config(arch)
    model = _port(ref, arch, cfg)
    toks = torch.from_numpy(ref[f"{arch}|tokens"])
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        base = logits_fn(model, toks, cfg)[0].numpy()
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -24)
        rounded = logits_fn(model, toks, cfg)[0].numpy()
    floor = np.abs(base - rounded).max()
    gap = np.abs(base - ref[f"{arch}|logits"]).max()
    assert gap <= 4 * floor, (gap, floor)
    # one rounding alone breaks the 1e-5 criterion somewhere
    assert (np.abs(base - rounded) > ATOL + RTOL * np.abs(base)).any()


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


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_equals_reference(ref, arch):
    """The port counts the reference's parameter leaves exactly.  The
    reference's own ``param_count`` / ``active_param_count`` are one more
    wherever ``first`` (the leading dense layers) is empty: its tree walk
    counts the empty list as a 0-d leaf of one parameter (ROADMAP queue 3).
    deepseek-v2 has one leading dense layer, and there the reference's
    counts equal the leaves."""
    cfg = get_config(arch)
    extra = 0 if cfg.first_dense_layers else 1
    assert cfg.param_count() == int(ref[f"{arch}|leaf_sum"])
    assert int(ref[f"{arch}|param_count"]) == cfg.param_count() + extra
    assert int(ref[f"{arch}|active_param_count"]) == \
        cfg.active_param_count() + extra
    if cfg.moe is None:
        assert cfg.active_param_count() == cfg.param_count()
    assert model_flops(cfg, 10, train=False) == \
        2.0 * cfg.active_param_count() * 10
    assert model_flops(cfg, 10, active_only=False) == \
        6.0 * cfg.param_count() * 10


def test_full_configs_match_published_sizes():
    """``test_models.py::test_full_configs_match_published_sizes`` on the
    port's counts."""
    expected = {
        "musicgen_medium": 1.37e9, "deepseek_7b": 6.9e9,
        "phi3_medium_14b": 14.7e9, "gemma2_9b": 9.2e9, "yi_34b": 34.4e9,
        "deepseek_v2_236b": 235.7e9, "arctic_480b": 476.9e9,
        "falcon_mamba_7b": 7.3e9, "jamba_v0_1_52b": 51.6e9,
        "chameleon_34b": 34.3e9,
    }
    assert sorted(expected) == sorted(ARCHS)
    for arch, n in expected.items():
        assert get_config(arch).param_count() == pytest.approx(n, rel=0.03), \
            arch


def test_moe_active_params_much_smaller():
    for arch in MOE:
        cfg = get_config(arch)
        assert cfg.active_param_count() < 0.3 * cfg.param_count()


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
    # deepseek-v2's leading dense layer must come as ``first``
    cfg = get_smoke_config("deepseek_v2_236b")
    tree = unflatten(ref, "deepseek_v2_236b")
    with pytest.raises(ValueError, match="first: 0 layers"):
        params_from_reference(cfg, dict(tree, first={}), device="cpu")


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
