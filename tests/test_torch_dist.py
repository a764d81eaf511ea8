"""``repro_torch.dist`` against ``repro.dist``: spec trees, the pod
collectives, the residual helpers, ``reshard_tree`` and the hint sites
(``test_dist.py`` / ``test_train_compress.py`` on the port).

The reference's specs come from one subprocess (its ``repro.dist`` does not
import in the test process on jax 0.9), serialized as entry lists.  The
collectives run on gloo ranks of a CPU world (``_torch_ref.run_ranks``)
against the reference's under ``jax.shard_map`` over 2 and 4 host devices,
on the same per-pod inputs drawn from a numpy seed.

Spec trees follow the port's leaves (``dist/sharding.py``): a parameter
is one leaf a layer, so its spec is the reference's stage-stacked spec
without the stack's leading ``None``; the caches stack every layer of a
kind, so theirs keep it, for the reference's leading dense layers too.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import REPO, run_ranks, run_reference

from repro_torch.configs import all_arch_names, get_config
from repro_torch.dist import (MeshAxes, P, activation_hint_policy,
                              cache_pspecs, init_residual, opt_pspecs,
                              param_pspecs, replica_pspecs, reshard_residual,
                              reshard_tree, shard_hint, sharding_policy)
from repro_torch.dist.hints import SITE_INVENTORY, local_call
from repro_torch.launch.mesh import slice_device_pool
from repro_torch.models.config import SHAPES
from repro_torch.models.model import param_shapes

SPEC_SHAPES = ("train_4k", "decode_32k", "long_500k")

SPEC_SCRIPT = """
import json
import jax
from jax.sharding import PartitionSpec
from repro.configs import all_arch_names, get_config
from repro.dist.sharding import (MeshAxes, activation_hint_policy,
                                 cache_pspecs, opt_pspecs, param_pspecs,
                                 replica_pspecs)
from repro.models.config import SHAPES
from repro.models.model import param_specs

def ser(t):
    if isinstance(t, PartitionSpec):
        return {'__spec__': [list(e) if isinstance(e, tuple) else e
                             for e in t]}
    if isinstance(t, dict):
        return {str(k): ser(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [ser(v) for v in t]
    return t

out = {}
for arch in all_arch_names():
    cfg = get_config(arch)
    pod = MeshAxes(pod='pod')
    ps = param_pspecs(cfg, pod)
    d = {'params': ps,
         'params_tp': param_pspecs(cfg, MeshAxes(), fsdp=False),
         'params_ep': param_pspecs(cfg, MeshAxes(), fsdp=False,
                                   fsdp_experts_only=True),
         'opt': opt_pspecs(ps, 'int8', pod, param_shapes=param_specs(cfg)),
         'replica': replica_pspecs(cfg, MeshAxes())}
    for shape in %r:
        sc = SHAPES[shape]
        d['policy|' + shape] = activation_hint_policy(cfg, MeshAxes(), sc)
        d['policy_tp|' + shape] = activation_hint_policy(
            cfg, pod, sc, model_axis_size=16)
        if shape != 'train_4k':
            d['cache|' + shape] = cache_pspecs(cfg, MeshAxes(), sc)
            d['cache_seq|' + shape] = cache_pspecs(cfg, pod, sc,
                                                   seq_shard=True)
    out[arch] = ser(d)
np.savez(OUT, specs=np.array(json.dumps(out)))
""" % (SPEC_SHAPES,)


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.npz"
    return json.loads(str(run_reference(SPEC_SCRIPT, out)["specs"]))


def _spec(entry) -> P:
    return P(*(tuple(e) if isinstance(e, list) else e
               for e in entry["__spec__"]))


def _is_spec(x) -> bool:
    return isinstance(x, dict) and "__spec__" in x


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a serialized reference tree."""
    if _is_spec(tree) or not isinstance(tree, (dict, list)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))


def _param_tree_as_port(cfg, tree) -> dict:
    """A reference parameter-shaped spec tree under the port's names (a
    stage leaf's spec without its stack dim, for every layer of the stack;
    a leaf may be a ``{"q", "scale"}`` pair)."""
    out = {}
    fd, period = cfg.first_dense_layers, cfg.period
    for path, leaf in _leaves(tree):
        sub = ()
        if path[-1] in ("q", "scale") and len(path) > 1 \
                and path[-2] not in ("mixer", "ffn"):
            path, sub = path[:-1], path[-1:]
        if path[0] == "stages":
            j = int(path[1][3:])
            spec = _spec(leaf)
            for s in range(cfg.num_stages):
                name = ".".join(("layers", str(fd + s * period + j))
                                + path[2:])
                out[(name,) + sub] = P(*spec[1:])
        elif path[0] == "first":
            out[(".".join(("layers",) + path[1:]),) + sub] = _spec(leaf)
        else:
            out[(".".join(path),) + sub] = _spec(leaf)
    return out


def _flat_port(tree) -> dict:
    out = {}
    for name, spec in tree.items():
        if isinstance(spec, dict):
            for k, v in spec.items():
                out[(name, k)] = v
        else:
            out[(name,)] = spec
    return out


def _cache_tree_as_port(tree) -> dict:
    """A reference cache spec tree as the port's: one stacked spec a leaf
    name (a leading dense layer's spec gains the stack dim)."""
    out: dict = {}
    for path, leaf in _leaves(tree):
        spec = _spec(leaf)
        if path[0] == "first":
            spec = P(None, *spec)
        prev = out.setdefault(path[-1], spec)
        assert prev == spec, (path, prev, spec)
    return out


def _policy(tree) -> dict:
    return {k: _spec(v) if _is_spec(v) else v for k, v in tree.items()}


@pytest.mark.parametrize("arch", all_arch_names())
def test_spec_trees_equal_the_reference(ref_specs, arch):
    cfg = get_config(arch)
    ref = ref_specs[arch]
    pod = MeshAxes(pod="pod")
    ps = param_pspecs(cfg, pod)
    assert set(ps) == set(param_shapes(cfg))
    for key, got in (("params", ps),
                     ("params_tp", param_pspecs(cfg, MeshAxes(), fsdp=False)),
                     ("params_ep", param_pspecs(cfg, MeshAxes(), fsdp=False,
                                                fsdp_experts_only=True)),
                     ("replica", None)):
        if got is None:
            continue
        want = _param_tree_as_port(cfg, ref[key])
        assert _flat_port(got) == want, key
    rep = replica_pspecs(cfg, MeshAxes())
    assert _flat_port(rep["params"]) == _param_tree_as_port(
        cfg, ref["replica"]["params"])
    assert rep["cache"] == _cache_tree_as_port(ref["replica"]["cache"])
    assert rep["batch"] == _spec(ref["replica"]["batch"])
    assert rep["policy"] == _policy(ref["replica"]["policy"])
    for shape in SPEC_SHAPES:
        sc = SHAPES[shape]
        assert activation_hint_policy(cfg, MeshAxes(), sc) == _policy(
            ref[f"policy|{shape}"])
        assert activation_hint_policy(cfg, pod, sc, model_axis_size=16) \
            == _policy(ref[f"policy_tp|{shape}"])
        if shape != "train_4k":
            assert cache_pspecs(cfg, MeshAxes(), sc) == _cache_tree_as_port(
                ref[f"cache|{shape}"])
            assert cache_pspecs(cfg, pod, sc, seq_shard=True) == \
                _cache_tree_as_port(ref[f"cache_seq|{shape}"])


@pytest.mark.parametrize("arch", ["deepseek_7b", "jamba_v0_1_52b"])
def test_int8_optimizer_specs_equal_the_reference(ref_specs, arch):
    """Moments inherit the parameter spec; int8 leaves of two or more dims
    are ``{"q", "scale"}``.  The reference's stage-stacked 1-D leaves
    (norms, Mamba vectors) are 2-D there and so int8 too, where the port
    keeps their moments f32 (ROADMAP queue 3): those differ, pinned."""
    cfg = get_config(arch)
    pod = MeshAxes(pod="pod")
    shapes = param_shapes(cfg)
    got = opt_pspecs(param_pspecs(cfg, pod), "int8", pod,
                     param_shapes=shapes)
    assert got["step"] == P() and got["m"] == got["v"]
    want = _param_tree_as_port(cfg, ref_specs[arch]["opt"]["m"])
    flat = _flat_port(got["m"])
    one_d = {n for n, s in shapes.items() if len(s) == 1}
    for key, spec in want.items():
        if key[0] in one_d and key[0].startswith("layers."):
            assert flat[(key[0],)] == P()          # f32 moment in the port
        else:
            assert flat[key] == spec, key


def test_shard_hint_is_an_identity_without_a_policy_or_a_dtensor():
    x = torch.arange(6.0).reshape(2, 3)
    assert shard_hint(x, "ffn_hidden") is x
    with sharding_policy({"ffn_hidden": P(None, "model")}):
        assert shard_hint(x, "ffn_hidden") is x            # no mesh
        with sharding_policy({"__mesh__": object(),
                              "ffn_hidden": P(None, "model")}):
            assert shard_hint(x, "ffn_hidden") is x        # plain tensor
            assert shard_hint(x, "attn_heads") is x        # no such site
    assert local_call(lambda a, b: a + b, (x, 1.0), (None, None), None) \
        .equal(x + 1.0)


def _hint_sites(path: Path):
    """The site names of ``shard_hint(x, "name")`` calls in ``path``."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "shard_hint"):
            arg = node.args[1]
            out.append(arg.value if isinstance(arg, ast.Constant)
                       else "<dynamic>")
    return out


def test_the_model_has_the_reference_hint_sites():
    """24 sites at the reference's places, file by file, every one named by
    a string literal (the port's ``hint-drift`` lint rule reads them; the
    embedding's gradient site is in the backward of an autograd function
    in the port), every name in the reference's inventory."""
    ref_src = ast.parse((REPO / "src/repro/dist/hints.py").read_text())
    inv = next(ast.literal_eval(n.value) for n in ast.walk(ref_src)
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "SITE_INVENTORY")
    assert tuple(inv) == SITE_INVENTORY
    total = 0
    for f in ("attention", "ffn", "mamba", "model", "moe", "transformer"):
        want = sorted(_hint_sites(REPO / f"src/repro/models/{f}.py"))
        got = _hint_sites(REPO / f"src/repro_torch/models/{f}.py")
        assert "<dynamic>" not in got, f
        assert sorted(got) == want, f
        assert set(got) <= set(SITE_INVENTORY)
        total += len(got)
    assert total == 24


def test_residual_helpers_equal_the_reference(tmp_path):
    ref = run_reference("""
from repro.dist.compression import init_residual, reshard_residual
rng = np.random.default_rng(3)
tree = {'a': rng.standard_normal((4, 8, 5)).astype(np.float32),
        'b': rng.standard_normal((4, 7)).astype(np.float32)}
out = {f'in|{k}': v for k, v in tree.items()}
for k, v in init_residual({'a': np.zeros((8, 5)), 'b': np.zeros(7)},
                          3).items():
    out[f'init|{k}'] = np.asarray(v)
for n in (4, 1, 2, 3):
    for k, v in reshard_residual(tree, n).items():
        out[f'{n}|{k}'] = np.asarray(v)
np.savez(OUT, **out)
""", tmp_path / "res.npz")
    tree = {k: torch.from_numpy(ref[f"in|{k}"]) for k in ("a", "b")}
    init = init_residual({"a": torch.zeros(8, 5), "b": torch.zeros(7)}, 3)
    for k, v in init.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[f"init|{k}"])
    for n in (4, 1, 2, 3):
        got = reshard_residual(tree, n)
        if n == 4:
            assert all(got[k] is tree[k] for k in tree)   # untouched
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), ref[f"{n}|{k}"])
            # the applied correction Σe/n is preserved
            np.testing.assert_allclose(v.sum(0).numpy() / n,
                                       tree[k].sum(0).numpy() / 4,
                                       rtol=1e-6, atol=1e-7)


COLLECTIVE_SCRIPT = """
import jax
from jax.sharding import PartitionSpec as P
from repro.dist.compression import compressed_psum_mean, psum_mean

rng = np.random.default_rng(7)
out = {}
for n in (2, 4):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ('pod',))
    g = {'a': rng.standard_normal((n, 8, 16)).astype(np.float32),
         'b': (1e-3 * rng.standard_normal((n, 33))).astype(np.float32),
         'z': np.zeros((n, 4, 4), np.float32)}
    e = {'a': (0.01 * rng.standard_normal((n, 8, 16))).astype(np.float32),
         'b': (1e-5 * rng.standard_normal((n, 33))).astype(np.float32),
         'z': np.zeros((n, 4, 4), np.float32)}
    for k in g:
        out[f'{n}|g|{k}'] = g[k]
        out[f'{n}|e|{k}'] = e[k]
    sq = lambda t: jax.tree.map(lambda x: x[0], t)

    def comp(g, e):
        mean, ne = compressed_psum_mean(sq(g), 'pod', sq(e))
        return mean, jax.tree.map(lambda x: x[None], ne)

    def cold(g):
        mean, ne = compressed_psum_mean(sq(g), 'pod', None)
        return mean, jax.tree.map(lambda x: x[None], ne)

    def exact(g):
        return psum_mean(sq(g), 'pod')

    kw = dict(mesh=mesh, axis_names={'pod'}, check_vma=False)
    m, ne = jax.jit(jax.shard_map(comp, in_specs=(P('pod'), P('pod')),
                                  out_specs=(P(), P('pod')), **kw))(g, e)
    mc, nc = jax.jit(jax.shard_map(cold, in_specs=(P('pod'),),
                                   out_specs=(P(), P('pod')), **kw))(g)
    mx = jax.jit(jax.shard_map(exact, in_specs=(P('pod'),), out_specs=P(),
                               **kw))(g)
    for k in g:
        out[f'{n}|mean|{k}'] = np.asarray(m[k])
        out[f'{n}|err|{k}'] = np.asarray(ne[k])
        out[f'{n}|cmean|{k}'] = np.asarray(mc[k])
        out[f'{n}|cerr|{k}'] = np.asarray(nc[k])
        out[f'{n}|exact|{k}'] = np.asarray(mx[k])
np.savez(OUT, **out)
"""

DIST_CODE = """
from repro_torch.dist import (P, compressed_psum_mean, named, psum_mean,
                              reshard_tree, shard_hint, sharding_policy)
from repro_torch.dist.hints import local_call
from repro_torch.dist.sharding import full_value, placements_for
from repro_torch.launch.mesh import make_debug_mesh, slice_device_pool

ref = dict(np.load(REF))
group2 = dist.new_group([0, 1])      # collective: every rank creates it
for n, group in ((2, group2), (4, None)):
    if RANK >= n:
        continue
    take = lambda kind: {k: torch.from_numpy(ref[f'{n}|{kind}|{k}'][RANK])
                         for k in ('a', 'b', 'z')}
    g, e = take('g'), take('e')
    mean, err = compressed_psum_mean(g, group, e)
    cmean, cerr = compressed_psum_mean(g, group, None)
    exact = psum_mean(g, group)
    for k in g:
        RESULT[f'{n}|mean|{k}'] = mean[k].numpy()
        RESULT[f'{n}|err|{k}'] = err[k].numpy()
        RESULT[f'{n}|cmean|{k}'] = cmean[k].numpy()
        RESULT[f'{n}|cerr|{k}'] = cerr[k].numpy()
        RESULT[f'{n}|exact|{k}'] = exact[k].numpy()

# reshard_tree on a (2, 2) mesh and across two disjoint slices
m22 = make_debug_mesh((2, 2), device='cpu')
w = torch.arange(24.0).reshape(4, 6)
b = torch.ones(3)
placed = reshard_tree({'w': w, 'b': b},
                      named(m22, {'w': P('data', 'model'), 'b': None}))
RESULT['b_same'] = np.array(placed['b'] is b)
RESULT['w_local'] = placed['w'].to_local().numpy()
again = reshard_tree(placed, named(m22, {'w': P('data', 'model'),
                                         'b': None}),
                     old_shardings=named(m22, {'w': P('data', 'model'),
                                               'b': None}))
RESULT['w_skip'] = np.array(again['w'] is placed['w'])
tp = reshard_tree(placed, named(m22, {'w': P(None, 'model'), 'b': None}))
RESULT['w_tp'] = tp['w'].to_local().numpy()
ma, mb = slice_device_pool([(2, 1), (1, 2)], device='cpu')
xa = reshard_tree({'w': w}, named(ma, {'w': P('data', None)}))['w']
xb = reshard_tree({'w': xa}, named(mb, {'w': P(None, 'model')}))['w']
RESULT['xb_local'] = xb.to_local().numpy()
RESULT['xb_full'] = full_value(xb).numpy()
try:
    slice_device_pool([(1, 1), (2, 1)], allow_remainder=False, device='cpu')
    RESULT['strict'] = np.array('no error')
except ValueError as err:
    RESULT['strict'] = np.array(str(err))
meshes, spare = slice_device_pool([(1, 1)], return_remainder=True,
                                  device='cpu')
RESULT['spare'] = np.array(spare)

# a hint redistributes a DTensor; local_call works on local shards
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
h = distribute_tensor(torch.arange(16.0).reshape(1, 2, 8), m22,
                      [Replicate(), Replicate()])
with sharding_policy({'__mesh__': m22, 'ffn_hidden': P(None, None, 'model')}):
    hh = shard_hint(h, 'ffn_hidden')
RESULT['hint_place'] = np.array(str(hh.placements))
RESULT['hint_local'] = hh.to_local().numpy()
doubled = local_call(lambda t: t * 2, (hh,), (P(None, None, 'model'),),
                     P(None, None, 'model'))
RESULT['local_call'] = full_value(doubled).numpy()
"""


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    ref = run_reference(COLLECTIVE_SCRIPT, tmp / "coll.npz", devices=4)
    ranks = run_ranks(f"REF = {str(tmp / 'coll.npz')!r}\n" + DIST_CODE, 4,
                      tmp, timeout=300)
    return ref, ranks


def _compress_np(t, *, recip: bool, fma: bool):
    """``compressed_psum_mean`` over the pod rows of ``t`` in numpy, with
    the reference compiler's two rewrites as options: the scale as ``amax
    * (1/127)`` (XLA's algebraic simplifier turns a division by a constant
    into a multiplication by its reciprocal in some programs) and the new
    residual ``t - q * scale`` fused into one rounding (XLA:CPU contracts
    the multiply-subtract into an FMA)."""
    f32 = np.float32
    amax = max(np.abs(t).max(), f32(1e-30))
    scale = f32(amax * f32(1 / 127)) if recip else f32(amax / f32(127))
    q = np.clip(np.round(t / scale), -127, 127).astype(np.int8)
    if fma:
        err = (t.astype(np.float64)
               - q.astype(np.float64) * np.float64(scale)).astype(f32)
    else:
        err = t - q.astype(f32) * scale
    mean = q.astype(np.int32).sum(0).astype(f32) * (scale / f32(len(t)))
    return mean, err, scale


@pytest.mark.parametrize("n", [2, 4])
def test_pod_collectives_equal_the_reference_bitwise(collectives, n):
    """``compressed_psum_mean`` (with a carried residual, and cold) and
    ``psum_mean`` over n gloo ranks against the reference's under
    ``jax.shard_map`` on the same per-pod inputs; leaf ``z`` is all zeros
    (``amax = 0``: the 1e-30 scale floor, zero mean and residual).

    The port computes exactly the module's formula (``_compress_np``
    without rewrites, bitwise).  The reference's compiled programs differ
    from that formula by two named XLA rewrites and nothing else: its
    residual is an FMA (one rounding where the formula has two: up to one
    ulp), and some programs take the scale as ``amax * (1/127)`` (one ulp
    off ``amax / 127``).  Its exact mean over 4 devices adds the pods in
    order, gloo in its ring order: one ulp of the sum apart.  Everything
    else is bitwise equal."""
    ref, ranks = collectives
    f32 = np.float32
    for k in ("a", "b", "z"):
        g, e = ref[f"{n}|g|{k}"], ref[f"{n}|e|{k}"]
        for kind, t in (("", g + e), ("c", g)):
            mean, err, scale = _compress_np(t, recip=False, fma=False)
            for rank in range(n):
                got = ranks[rank]
                np.testing.assert_array_equal(got[f"{n}|{kind}mean|{k}"],
                                              mean)
                np.testing.assert_array_equal(got[f"{n}|{kind}err|{k}"],
                                              err[rank])
            rmean, rerr = ref[f"{n}|{kind}mean|{k}"], ref[f"{n}|{kind}err|{k}"]
            matched = [r for r in (False, True)
                       if np.array_equal(_compress_np(t, recip=r,
                                                      fma=True)[0], rmean)
                       and np.array_equal(_compress_np(t, recip=r,
                                                       fma=True)[1], rerr)]
            assert matched, (n, kind, k)
            rscale = _compress_np(t, recip=matched[0], fma=True)[2]
            assert abs(int(np.float32(rscale).view(np.int32))
                       - int(np.float32(scale).view(np.int32))) <= 1
        seq = g[0].copy()
        for i in range(1, n):
            seq = seq + g[i]
        np.testing.assert_array_equal(ref[f"{n}|exact|{k}"], seq / f32(n))
        ulp = np.spacing(np.abs(g).sum(0).astype(f32)) / f32(n)
        for rank in range(n):
            got = ranks[rank][f"{n}|exact|{k}"]
            assert (np.abs(got - seq / f32(n)) <= ulp).all()
            if n == 2:
                np.testing.assert_array_equal(got, seq / f32(n))
    for kind in ("mean", "err", "cmean"):
        assert not ranks[0][f"{n}|{kind}|z"].any()
    assert np.abs(ranks[0][f"{n}|err|a"]).max() > 0


def test_reshard_tree_places_skips_and_migrates(collectives):
    _, ranks = collectives
    w = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    for rank, r in enumerate(ranks):
        assert bool(r["b_same"]) and bool(r["w_skip"])
        d, m = divmod(rank, 2)               # (data, model) coordinate
        np.testing.assert_array_equal(r["w_local"],
                                      w[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        np.testing.assert_array_equal(r["w_tp"], w[:, 3 * m:3 * m + 3])
        # (2, 1) slice on ranks 0-1 → (1, 2) slice on ranks 2-3
        want = w[:, 3 * (rank - 2):3 * (rank - 1)] if rank >= 2 \
            else np.zeros((0,), np.float32)
        np.testing.assert_array_equal(r["xb_local"].reshape(want.shape),
                                      want)
        np.testing.assert_array_equal(r["xb_full"], w)
        assert "leaving 1 unused" in str(r["strict"])
        assert list(r["spare"]) == [1, 2, 3]
        assert str(r["hint_place"]) == "(Replicate(), Shard(dim=2))"
        np.testing.assert_array_equal(
            r["hint_local"], np.arange(16.0).reshape(1, 2, 8)[..., 4 * m:
                                                              4 * m + 4])
        np.testing.assert_array_equal(
            r["local_call"], 2 * np.arange(16.0).reshape(1, 2, 8))


def test_reshard_tree_leaves_none_targets_and_pools_raise():
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    same = reshard_tree(tree, {"w": None, "b": None})
    assert same["w"] is tree["w"] and same["b"] is tree["b"]
    prefix = reshard_tree({"p": tree}, {"p": None})
    assert prefix["p"]["w"] is tree["w"]
    with pytest.raises(ValueError, match="oversubscribed"):
        slice_device_pool([(1, 1), (2, 1)], devices=[0, 1])


WORLD1_CODE = """
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

mesh = make_debug_mesh((1, 1), device='cpu')
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device='cpu')
    plain = ServeEngine(cfg, params, max_len=32, lanes=4)
    meshed = ServeEngine(cfg, params, max_len=32, lanes=4, mesh=mesh)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 8).astype(np.int32)
    RESULT[f'{arch}|logits'] = plain.start(prompt[None])[0].numpy()
    RESULT[f'{arch}|mlogits'] = meshed.start(prompt[None])[0].numpy()
    RESULT[f'{arch}|gen'] = plain.generate(prompt[None], 4)
    RESULT[f'{arch}|mgen'] = meshed.generate(prompt[None], 4)
    meshed.start_paged(max_batch=2, page_size=8)
    slot = meshed.admit(prompt, 4)
    while not meshed.finished_slots():
        meshed.decode_tick()
    RESULT[f'{arch}|paged'] = meshed.retire(slot)
"""

WORLD1_ARCHS = ["deepseek_7b", "gemma2_9b", "falcon_mamba_7b",
                "jamba_v0_1_52b", "deepseek_v2_236b", "musicgen_medium"]


def test_hint_policy_at_world_size_one_is_bitwise_the_meshless_run(tmp_path):
    """A (1, 1) mesh replica runs every block kind (GQA, local windows and
    softcaps, Mamba, MoE, MLA, GELU) on DTensors under the replica's
    policy through all 24 sites; at world size 1 every hint, placement and
    ``local_call`` is value-preserving, so logits and tokens are bitwise
    the meshless engine's, dense and paged."""
    res = run_ranks(f"ARCHS = {WORLD1_ARCHS!r}\n" + WORLD1_CODE, 1, tmp_path,
                    timeout=300)[0]
    for arch in WORLD1_ARCHS:
        np.testing.assert_array_equal(res[f"{arch}|mlogits"],
                                      res[f"{arch}|logits"])
        np.testing.assert_array_equal(res[f"{arch}|mgen"], res[f"{arch}|gen"])
        np.testing.assert_array_equal(res[f"{arch}|paged"],
                                      res[f"{arch}|gen"][0])


def test_run_reference_defaults_are_unchanged(tmp_path):
    """``run_reference``'s new knobs are opt-in: by default the reference
    sees one host device and jax's own ``make_mesh`` / ``shard_map``, and a
    computation gives the same numbers with the knobs spelled out; with
    them, the device count and the two shims take effect."""
    code = """
import jax
import jax.experimental.shard_map as sm
from repro.configs import get_smoke_config
from repro.models.model import init_params
params = init_params(jax.random.key(0), get_smoke_config('deepseek-7b'))
np.savez(OUT, devices=np.array(jax.device_count()),
         shimmed=np.array(jax.make_mesh.__name__ == '_auto_mesh'
                          and sm.shard_map.__name__ == '_shard_map'),
         embed=np.asarray(params['embed']))
"""
    plain = run_reference(code, tmp_path / "a.npz")
    spelled = run_reference(code, tmp_path / "b.npz", devices=None,
                            shims=False)
    opted = run_reference(code, tmp_path / "c.npz", devices=4, shims=True)
    assert int(plain["devices"]) == 1 and not bool(plain["shimmed"])
    np.testing.assert_array_equal(plain["embed"], spelled["embed"])
    assert int(opted["devices"]) == 4 and bool(opted["shimmed"])
    np.testing.assert_array_equal(plain["embed"], opted["embed"])
