"""The plain references agree with themselves, one row against a padded
batch, at a small size; the fp8 control differs from float32.  Every model
reference under ``bench/plainref/`` is tested, found by its file."""

import importlib

import pytest
import torch

from bench.plainref import llama
from bench.plainref.precision import Float32, Fp8
from bench.tests.smoke import references
from bench.weights import make_weights


@pytest.mark.parametrize("name", references())
def test_unbatched_equals_batched(name):
    ref = importlib.import_module(f"bench.plainref.{name}")
    cfg = ref.SMOKE
    w = make_weights(ref.parameters(cfg), 11, "cpu")
    g = torch.Generator().manual_seed(3)
    lens = [9, 17, 4]
    S = max(lens)
    toks = torch.randint(0, cfg["vocab_size"], (len(lens), S), generator=g)
    for b, n in enumerate(lens):
        toks[b, n:] = 0
    prec = Float32()
    batch = ref.hidden(w, toks, cfg, prec)
    for b, n in enumerate(lens):
        one = ref.hidden(w, toks[b:b + 1, :n], cfg, prec)
        torch.testing.assert_close(batch[b, :n], one[0], atol=1e-5,
                                   rtol=1e-5)
    lg = ref.logits(w, batch[:, -1], cfg, prec)
    low = ref.logits(w, ref.hidden(w, toks, cfg, Fp8())[:, -1], cfg, Fp8())
    assert lg.shape == (len(lens), cfg["vocab_size"])
    assert (lg - low).abs().max() > 1e-3


def test_weights_from_the_seed():
    params = llama.parameters(llama.SMOKE)
    a, b = make_weights(params, 5, "cpu"), make_weights(params, 5, "cpu")
    c = make_weights(params, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    d = llama.SMOKE["d_model"]
    assert abs(a["layers.0.mixer.wq"].std().item() - d ** -0.5) < 0.2 * d ** -0.5
    assert abs(a["embed"].std().item() - 0.02) < 0.002
