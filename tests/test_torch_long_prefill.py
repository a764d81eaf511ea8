"""Long prefills against the JAX reference, on the CPU in float32: the
multi-chunk attention (queries and keys in chunks of 512) and the local
window's chunk skip, which the 16-token tests never reach.

Cases (smoke widths, parameters from ``np.random.default_rng``):

* deepseek-7b at S = 1024 (two query chunks, global attention);
* gemma2-9b with ``local_window`` 600 at S = 1024 (the window crosses a
  chunk boundary) and at S = 2048 (query chunk 3 skips key chunk 0);
* deepseek-v2's MLA block prefill at S = 1024 (value heads narrower than
  the query heads).

Bound: ``atol = rtol = 1e-5 * sqrt(S / 16)``, 8e-5 at 1024 and 1.13e-4 at
2048.  The 16-token tests hold 1e-5; here every attention output sums over
up to S keys instead of 16, in chunks rescaled by the online softmax, and
the two packages sum in different orders.  Independent rounding errors
grow as the square root of the number of terms, hence the factor.  On
these inputs the largest gaps were 5.1e-6 (deepseek-7b), 1.5e-5
(gemma2-9b at 1024) and 2.5e-5 (MLA): 1e-5 alone does not hold at this
length.  Logits must also give equal argmaxes.
"""

import math

import numpy as np
import pytest
import torch

from _torch_ref import run_reference, unflatten

from repro_torch.configs import get_smoke_config
from repro_torch.models import logits_fn, params_from_reference
from repro_torch.models import attention as A
from repro_torch.models.convert import _flatten

CASES = {"deepseek_7b_1024": ("deepseek_7b", 1024, {}),
         "gemma2_9b_1024": ("gemma2_9b", 1024, {"local_window": 600}),
         "gemma2_9b_2048": ("gemma2_9b", 2048, {"local_window": 600})}
MLA_S = 1024

REF_SCRIPT = '''
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import logits_fn
from repro.models import attention as A
from repro.models.model import param_shapes

logits_fn = jax.jit(logits_fn, static_argnums=2)
out = {}
for i, (case, (arch, S, kw)) in enumerate(sorted(CASES.items())):
    cfg = get_smoke_config(arch).with_(**kw)
    rng = np.random.default_rng(300 + i)
    params = rand_tree(param_shapes(cfg), rng)
    flat_tree(params, case, out)
    toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    out[f"data|{case}|tokens"] = toks
    out[f"data|{case}|logits"] = np.asarray(
        logits_fn(params, jnp.asarray(toks), cfg)[0])

cfg = get_smoke_config("deepseek_v2_236b")
rng = np.random.default_rng(310)
shapes = jax.tree.map(lambda l: l.shape, jax.eval_shape(
    lambda: A.init_mla_params(jax.random.key(0), cfg)))
p = rand_tree(shapes, rng)
flat_tree(p, "mla", out)
x = rng.standard_normal((2, MLA_S, cfg.d_model)).astype(np.float32)
out["data|mla|x"] = x
y, _ = jax.jit(lambda p, x: A.mla_block(p, x, cfg,
                                        positions=jnp.arange(MLA_S)))(
    p, jnp.asarray(x))
out["data|mla|y"] = np.asarray(y)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = f"CASES = {CASES!r}\nMLA_S = {MLA_S}\n" + REF_SCRIPT
    return run_reference(code, tmp_path_factory.mktemp("ref") / "long.npz")


def _tol(S):
    return 1e-5 * math.sqrt(S / 16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_long_prefill_logits_match_reference(ref, case, monkeypatch):
    arch, S, kw = CASES[case]
    cfg = get_smoke_config(arch).with_(**kw)
    model = params_from_reference(cfg, unflatten(ref, case), device="cpu")
    toks = torch.from_numpy(ref[f"data|{case}|tokens"])
    touched = []
    scores = A._qk_chunk_scores

    def count(qc_, kc_, *args):
        touched.append(kc_.shape[1])
        return scores(qc_, kc_, *args)

    monkeypatch.setattr(A, "_qk_chunk_scores", count)
    with torch.inference_mode():
        got = logits_fn(model, toks, cfg)[0].numpy()
    want = ref[f"data|{case}|logits"]
    np.testing.assert_allclose(got, want, atol=_tol(S), rtol=_tol(S))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # key chunks of 512 each layer touches: the causal triangle, less what
    # the window skips
    n = S // 512
    causal = n * (n + 1) // 2
    windows = [cfg.window_kind(i) for i in range(cfg.num_layers)]
    skipped = sum(max(0, (i * 512 - 600) // 512) for i in range(n))
    want_chunks = sum(causal - (skipped if w == "local" else 0)
                      for w in windows)
    assert len(touched) == want_chunks
    assert (skipped > 0) == (case == "gemma2_9b_2048")


def test_long_mla_prefill_matches_reference(ref):
    cfg = get_smoke_config("deepseek_v2_236b")
    mod = A.init_mla_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _flatten(unflatten(ref, "mla"), "", {}).items()})
    with torch.inference_mode():
        y, _ = A.mla_block(mod, torch.from_numpy(ref["data|mla|x"]), cfg,
                           positions=torch.arange(MLA_S))
    np.testing.assert_allclose(y.numpy(), ref["data|mla|y"],
                               atol=_tol(MLA_S), rtol=_tol(MLA_S))
