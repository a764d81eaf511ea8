"""The port's Mamba and MoE blocks (``repro_torch.models.mamba`` /
``.moe``) on the CPU, in float32: block by block against the JAX reference
on the same inputs, and the reference's own block tests
(``test_models.py``) mirrored on the port.

The reference runs once for this module, in a subprocess
(``_torch_ref.run_reference``), on parameters drawn from
``np.random.default_rng`` on its own shapes.

Tolerances:

* Mamba: ``atol = rtol = 1e-5``.  The port scans a chunk with a doubling
  scan, the reference with ``lax.associative_scan``: the same combine,
  grouped differently, so the two agree to float32 rounding only.
* MoE: the routed expert ids, the kept-token counts (``expert_load``) and
  which tokens were dropped are equal exactly; values within 1e-5.
"""

import numpy as np
import pytest
import torch

from _torch_ref import run_reference, unflatten

from repro_torch.models import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models import mamba as M
from repro_torch.models import moe as E
from repro_torch.models.convert import _flatten

ATOL = RTOL = 1e-5
MAMBA_VARIANTS = {"plain": False, "bcdt_rms": True}
MOE_VARIANTS = {"high_cf": dict(capacity_factor=16.0),
                "drops": dict(capacity_factor=0.5),
                "shared_dense": dict(capacity_factor=2.0,
                                     num_shared_experts=2, shared_d_ff=32,
                                     dense_residual=True,
                                     dense_residual_d_ff=40)}


def _mamba_cfg(chunk, bcdt_rms=False):
    return ModelConfig(
        name="m", num_layers=1, d_model=32, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=7, block_pattern=("mamba",),
        ssm=SSMConfig(d_inner=64, d_state=8, chunk=chunk, dt_rank=4,
                      bcdt_rms=bcdt_rms),
        param_dtype="float32", compute_dtype="float32")


def _moe_cfg(experts=8, k=2, **moe):
    return ModelConfig(
        name="moe", num_layers=1, d_model=32, num_heads=1, num_kv_heads=1,
        d_ff=64, vocab_size=7,
        moe=MoEConfig(num_experts=experts, top_k=k, expert_d_ff=48, **moe),
        param_dtype="float32", compute_dtype="float32")


def _hot_router(cfg, rng):
    """A router that sends every token of ``_hot_tokens`` to experts 0
    then 1: capacity decides who is dropped."""
    r = 0.01 * rng.standard_normal((cfg.d_model, cfg.moe.num_experts))
    r[0, 0], r[0, 1] = 5.0, 4.0
    return r.astype(np.float32)


def _hot_tokens(rng, n, d, sign=1.0):
    """Tokens that ``_hot_router`` sends to experts 0 and 1 (``sign`` -1:
    to any experts but those)."""
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    x[..., 0] = sign * (3.0 + np.abs(x[..., 0]))
    return x


REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.models import ModelConfig, MoEConfig, SSMConfig
from repro.models.mamba import init_mamba_params, mamba_block, selective_scan
from repro.models.moe import init_moe_params, moe_block

REC = []
_top_k = jax.lax.top_k
def top_k_rec(x, k):
    v, i = _top_k(x, k)
    REC.append(np.asarray(i))
    return v, i
jax.lax.top_k = top_k_rec

def shapes(f, cfg):
    return jax.tree.map(lambda l: l.shape,
                        jax.eval_shape(lambda: f(jax.random.key(0), cfg)))

out = {}
for name, rms in MAMBA_VARIANTS.items():
    rng = np.random.default_rng(1)
    cfg = _mamba_cfg(4, rms)
    p = rand_tree(shapes(init_mamba_params, cfg), rng)
    flat_tree(p, f"mamba_{name}", out)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    out[f"data|mamba_{name}|x"] = x
    y, _ = mamba_block(p, jnp.asarray(x), cfg)
    out[f"data|mamba_{name}|y"] = np.asarray(y)
    cache = {"conv": jnp.zeros((2, 3, 64)), "ssm": jnp.zeros((2, 64, 8))}
    y1, cache = mamba_block(p, jnp.asarray(x[:, :8]), cfg, cache=cache)
    ys = [y1]
    for t in range(8, 16):
        yt, cache = mamba_block(p, jnp.asarray(x[:, t:t + 1]), cfg,
                                cache=cache, decode_pos=jnp.int32(t))
        ys.append(yt)
    out[f"data|mamba_{name}|y_stream"] = np.asarray(jnp.concatenate(ys, axis=1))
    out[f"data|mamba_{name}|conv"] = np.asarray(cache["conv"])
    out[f"data|mamba_{name}|ssm"] = np.asarray(cache["ssm"])
    u = rng.standard_normal((2, 32, 64)).astype(np.float32)
    out[f"data|mamba_{name}|u"] = u
    ys16, h16 = selective_scan(p, jnp.asarray(u), _mamba_cfg(16, rms))
    out[f"data|mamba_{name}|scan_y"] = np.asarray(ys16)
    out[f"data|mamba_{name}|scan_h"] = np.asarray(h16)

def run_moe(tag, cfg, p, x):
    flat_tree(p, tag, out)
    out[f"data|{tag}|x"] = x
    REC.clear()
    y, met = moe_block(p, jnp.asarray(x), cfg)
    out[f"data|{tag}|out"] = np.asarray(y)
    out[f"data|{tag}|ids"] = REC[0]
    for k, v in met.items():
        out[f"data|{tag}|met|{k}"] = np.asarray(v)

for name, kw in MOE_VARIANTS.items():
    rng = np.random.default_rng(2)
    cfg = _moe_cfg(**kw)
    p = rand_tree(shapes(init_moe_params, cfg), rng)
    run_moe(f"moe_{name}", cfg, p,
            rng.standard_normal((2, 16, 32)).astype(np.float32))

# exact ties: a zero router makes every probability equal
cfg = _moe_cfg(capacity_factor=2.0)
rng = np.random.default_rng(3)
p = rand_tree(shapes(init_moe_params, cfg), rng)
p["router"] = np.zeros_like(p["router"])
run_moe("moe_tie", cfg, p, rng.standard_normal((1, 4, 32)).astype(np.float32))

# eight tokens all routed to experts 0 and 1 at jamba's capacity factor,
# 16 experts, top-2: four slots an expert, so four tokens are dropped
cfg = _moe_cfg(experts=16, capacity_factor=1.25)
rng = np.random.default_rng(4)
p = rand_tree(shapes(init_moe_params, cfg), rng)
p["router"] = _hot_router(cfg, rng)
run_moe("moe_hot", cfg, p, _hot_tokens(rng, 8, 32))
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import inspect
    helpers = "".join(inspect.getsource(f) for f in (
        _mamba_cfg, _moe_cfg, _hot_router, _hot_tokens))
    code = (f"MAMBA_VARIANTS = {MAMBA_VARIANTS!r}\n"
            f"MOE_VARIANTS = {MOE_VARIANTS!r}\n" + helpers + REF_SCRIPT)
    return run_reference(code, tmp_path_factory.mktemp("ref") / "blocks.npz")


def _load(module, ref, tag):
    """``module`` holding the reference's parameter tree under ``tag``."""
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            _flatten(unflatten(ref, tag), "", {}).items()})
    return module


def _mamba(cfg, ref=None, tag=None):
    mod = M.init_mamba_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    return _load(mod, ref, tag) if ref is not None else mod


def _moe(cfg, ref=None, tag=None):
    mod = E.init_moe_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return _load(mod, ref, tag) if ref is not None else mod


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Mamba against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MAMBA_VARIANTS))
def test_mamba_block_prefill_and_decode_match_reference(ref, name):
    cfg = _mamba_cfg(4, MAMBA_VARIANTS[name])
    tag = f"mamba_{name}"
    mod = _mamba(cfg, ref, tag)
    x = torch.from_numpy(ref[f"data|{tag}|x"])
    with torch.inference_mode():
        y, _ = M.mamba_block(mod, x, cfg)
        cache = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in M.mamba_cache_spec(cfg, 2).items()}
        ys = [M.mamba_block(mod, x[:, :8], cfg, cache=cache)[0]]
        for t in range(8, 16):
            ys.append(M.mamba_block(mod, x[:, t:t + 1], cfg, cache=cache,
                                    decode_pos=t)[0])
    _close(y, ref[f"data|{tag}|y"])
    _close(torch.cat(ys, dim=1), ref[f"data|{tag}|y_stream"])
    _close(cache["conv"], ref[f"data|{tag}|conv"])
    _close(cache["ssm"], ref[f"data|{tag}|ssm"])


@pytest.mark.parametrize("name", sorted(MAMBA_VARIANTS))
def test_selective_scan_matches_reference_over_chunks(ref, name):
    cfg = _mamba_cfg(16, MAMBA_VARIANTS[name])
    tag = f"mamba_{name}"
    mod = _mamba(cfg, ref, tag)
    with torch.inference_mode():
        y, h = M.selective_scan(mod, torch.from_numpy(ref[f"data|{tag}|u"]), cfg)
    _close(y, ref[f"data|{tag}|scan_y"])
    _close(h, ref[f"data|{tag}|scan_h"])


def test_softplus_is_logaddexp_above_torchs_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 25.0, 40.0])
    want = np.logaddexp(x.numpy().astype(np.float64), 0.0)
    np.testing.assert_allclose(M._softplus(x).numpy(), want, rtol=1e-7)
    np.testing.assert_array_equal(M._softplus(x).numpy(),
                                  torch.logaddexp(x, torch.zeros(())).numpy())


def test_prefill_length_must_split_into_chunks():
    """As in the reference (``mamba.py:117``), a prefill of S tokens needs
    S <= chunk or S % chunk == 0; there is no padding."""
    cfg = _mamba_cfg(4)
    mod = _mamba(cfg)
    for S in (1, 3, 4, 8, 12):
        with torch.inference_mode():
            assert M.mamba_block(mod, torch.ones(1, S, 32), cfg)[0].shape \
                == (1, S, 32)
    with pytest.raises(ValueError, match=r"S=6, Q=4"):
        M.mamba_block(mod, torch.ones(1, 6, 32), cfg)


# ---------------------------------------------------------------------------
# test_models.py's Mamba tests, on the port
# ---------------------------------------------------------------------------

def test_mamba_chunked_equals_sequential():
    cfg16, cfg1 = _mamba_cfg(16), _mamba_cfg(1)   # chunk 1: sequential
    mod = _mamba(cfg16)
    u = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        y16, h16 = M.selective_scan(mod, u, cfg16)
        y1, h1 = M.selective_scan(mod, u, cfg1)
    np.testing.assert_allclose(y16.numpy(), y1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h16.numpy(), h1.numpy(), rtol=1e-5, atol=1e-5)


def test_mamba_streaming_equals_batch():
    """Processing a sequence in two halves with carried state == one
    shot."""
    cfg = _mamba_cfg(4)
    mod = _mamba(cfg)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        y_full, _ = M.mamba_block(mod, x, cfg)
        cache = {"conv": torch.zeros(2, 3, 64), "ssm": torch.zeros(2, 64, 8)}
        ys = [M.mamba_block(mod, x[:, :8], cfg, cache=cache)[0]]
        for t in range(8, 16):
            ys.append(M.mamba_block(mod, x[:, t:t + 1], cfg, cache=cache,
                                    decode_pos=t)[0])
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# MoE against the reference
# ---------------------------------------------------------------------------

def _check_moe(ref, tag, cfg):
    mod = _moe(cfg, ref, tag)
    with torch.inference_mode():
        xt = torch.from_numpy(ref[f"data|{tag}|x"])
        G = E._num_groups(xt.shape[0] * xt.shape[1])
        ids = E._route(mod, xt.reshape(G, -1, cfg.d_model), cfg)[3]
        out, met = E.moe_block(mod, xt, cfg)
    np.testing.assert_array_equal(ids.numpy(), ref[f"data|{tag}|ids"])
    np.testing.assert_array_equal(met["expert_load"].numpy(),
                                  ref[f"data|{tag}|met|expert_load"])
    _close(out, ref[f"data|{tag}|out"])
    for k in ("aux_loss", "z_loss"):
        _close(met[k], ref[f"data|{tag}|met|{k}"])
    return out, met


@pytest.mark.parametrize("name", sorted(MOE_VARIANTS))
def test_moe_block_matches_reference(ref, name):
    out, met = _check_moe(ref, f"moe_{name}", _moe_cfg(**MOE_VARIANTS[name]))
    kept = int(met["expert_load"].sum())
    if name == "high_cf":
        assert kept == 2 * 16 * 2
    if name == "drops":
        assert kept < 2 * 16 * 2


def test_moe_ties_go_to_the_lower_expert_as_in_top_k(ref):
    """A zero router gives every expert the same probability: the
    reference's ``lax.top_k`` picks experts 0 and 1 for every token, and so
    does the port."""
    _check_moe(ref, "moe_tie", _moe_cfg(capacity_factor=2.0))
    np.testing.assert_array_equal(ref["data|moe_tie|ids"][..., 0], 0)
    np.testing.assert_array_equal(ref["data|moe_tie|ids"][..., 1], 1)
    # ties among the top experts, not at the front
    probs = torch.tensor([[[0.1, 0.3, 0.1, 0.3, 0.2]]])
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    assert order[0, 0].tolist() == [1, 3, 4, 0, 2]


def test_moe_capacity_drops_match_reference_at_eight_tokens(ref):
    """Eight tokens all routed to experts 0 then 1, at jamba's capacity
    factor (four slots an expert): tokens 4-7 are dropped from both, in the
    port as in the reference."""
    cfg = _moe_cfg(experts=16, capacity_factor=1.25)
    assert E.capacity_for(cfg, 8) == 4
    _, met = _check_moe(ref, "moe_hot", cfg)
    assert met["expert_load"].tolist() == [4, 4] + [0] * 14


# ---------------------------------------------------------------------------
# the capacity contract at decode
# ---------------------------------------------------------------------------

def _hot_moe(experts=16):
    cfg = _moe_cfg(experts=experts, capacity_factor=1.25)
    mod = _moe(cfg)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        mod.router.copy_(torch.from_numpy(_hot_router(cfg, rng)))
    return cfg, mod, rng


def test_moe_four_lanes_never_drop_and_rows_stay_independent():
    """At T <= 4 tokens an expert has ``capacity_for >= 4`` slots and a
    token picks an expert at most once, so nothing is dropped, even when
    every token picks the same experts; a row's output is then bitwise the
    same whatever its batch-mates are."""
    cfg, mod, rng = _hot_moe()
    for T in (1, 2, 3, 4):
        assert E.capacity_for(cfg, T) >= T
    hot = torch.from_numpy(_hot_tokens(rng, 4, 32))
    other = torch.from_numpy(_hot_tokens(rng, 4, 32, sign=-1.0))
    mixed = torch.cat([other[:, :3], hot[:, 3:]], dim=1)
    with torch.inference_mode():
        out_hot, met = E.moe_block(mod, hot, cfg)
        out_mixed, met_mixed = E.moe_block(mod, mixed, cfg)
    assert met["expert_load"].tolist() == [4, 4] + [0] * 14
    assert met_mixed["expert_load"][:2].tolist() == [1, 1]
    # token 3 sits in slot 3 of experts 0 and 1 in one batch, slot 0 in
    # the other: same bits
    assert torch.equal(out_hot[:, 3], out_mixed[:, 3])


def test_moe_eight_lanes_drop_a_token_because_of_its_batch_mates():
    """At eight tokens the same expert has 4 slots: the fifth token routed
    to it is dropped.  A token's output then depends on its neighbours,
    exactly as in the reference (the engine's contract holds paged == dense
    only at 4 lanes or fewer for MoE models)."""
    cfg, mod, rng = _hot_moe()
    hot = torch.from_numpy(_hot_tokens(rng, 8, 32))
    other = torch.from_numpy(_hot_tokens(rng, 8, 32, sign=-1.0))
    calm = torch.cat([other[:, :7], hot[:, 7:]], dim=1)
    with torch.inference_mode():
        out_hot, met_hot = E.moe_block(mod, hot, cfg)
        out_calm, met_calm = E.moe_block(mod, calm, cfg)
    assert met_hot["expert_load"].tolist() == [4, 4] + [0] * 14
    assert met_calm["expert_load"][:2].tolist() == [1, 1]
    assert torch.count_nonzero(out_hot[:, 7]) == 0      # dropped from both
    assert torch.count_nonzero(out_calm[:, 7]) > 0      # kept


# ---------------------------------------------------------------------------
# test_models.py's MoE tests, on the port
# ---------------------------------------------------------------------------

def _moe_x():
    return torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))


def test_moe_no_drops_at_high_capacity():
    cfg = _moe_cfg(capacity_factor=32.0)
    with torch.inference_mode():
        out, metrics = E.moe_block(_moe(cfg), _moe_x(), cfg)
    assert out.shape == (2, 16, 32)
    assert int(metrics["expert_load"].sum()) == 2 * 16 * cfg.moe.top_k


def test_moe_load_conserved_with_drops():
    cfg = _moe_cfg(capacity_factor=0.5)
    with torch.inference_mode():
        out, metrics = E.moe_block(_moe(cfg), _moe_x(), cfg)
    total = int(metrics["expert_load"].sum())
    assert 0 < total <= 2 * 16 * cfg.moe.top_k
    assert bool(torch.isfinite(out).all())


def test_moe_aux_losses_finite_positive():
    cfg = _moe_cfg(capacity_factor=16.0)
    with torch.inference_mode():
        _, metrics = E.moe_block(_moe(cfg), _moe_x(), cfg)
    assert float(metrics["aux_loss"]) > 0
    assert float(metrics["z_loss"]) >= 0
