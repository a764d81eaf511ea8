"""File-scope AST rules: host sync in hot functions, sharding axes.

Counterpart of ``repro.analysis.rules_ast``, for a PyTorch program.  Its
``donation-after-use`` and ``retrace-hazard`` rules have no counterpart
here (see the package docstring).

Shared vocabulary:

* ``_dotted(node)`` renders ``Name``/``Attribute`` chains as their source
  spelling (``self.pool.pools``).
* "host-known" names (host-sync rule) are names every one of whose
  assignments inside the function produces a host value (numpy/math/len/
  literal/a tensor's shape/...).  Anything else — parameters, results of
  tensor ops, unpacked tuples — is conservatively treated as possibly
  device-resident.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

# ---------------------------------------------------------------------------
# shared helpers


def _dotted(node) -> str | None:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# Names whose calls build device values: torch (and ``F`` for
# ``torch.nn.functional``), and the reference's jnp / jax, so the rule reads
# a reference-style source the way the reference rule does.
_DEVICE_ROOTS = ("torch", "F", "jnp", "jax")


def _contains_device(node) -> bool:
    """Any ``torch``/``F``/``jnp``/``jax`` reference anywhere in the
    subtree."""
    return any(isinstance(n, ast.Name) and n.id in _DEVICE_ROOTS
               for n in ast.walk(node))


def _root_name(node) -> str | None:
    """Leftmost Name of a Name/Attribute/Subscript chain (``a`` in
    ``a.b[i].c``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _functions(tree):
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


# ---------------------------------------------------------------------------
# host-sync-in-hot-path

_SYNC_BUILTINS = ("float", "bool", "int")
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_HOST_FUNCS = {"len", "range", "sorted", "list", "tuple", "dict", "set",
               "min", "max", "sum", "abs", "int", "float", "bool", "str",
               "enumerate", "zip"}
_HOST_ROOTS = {"np", "numpy", "math"}
# A tensor's metadata lives on the host: reading it never syncs.
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_META_METHODS = {"size", "numel", "dim", "element_size", "stride"}


def _is_meta(e) -> bool:
    """``t.shape``, ``t.shape[0]``, ``t.size(1)``, ``t.numel()``, ..."""
    while isinstance(e, ast.Subscript):
        e = e.value
    if isinstance(e, ast.Attribute):
        return e.attr in _META_ATTRS
    return (isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute)
            and e.func.attr in _META_METHODS)


def _is_host_expr(e, known=frozenset()) -> bool:
    """Conservatively: does this expression produce a host value?  Names in
    ``known`` are host-side, and so is what a sync method returns (the
    copy it made)."""
    if isinstance(e, (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set,
                      ast.ListComp, ast.DictComp, ast.SetComp,
                      ast.GeneratorExp, ast.JoinedStr)):
        return True
    if _is_meta(e):
        return True
    if isinstance(e, (ast.Name, ast.Attribute, ast.Subscript)):
        return _root_name(e) in known
    if isinstance(e, ast.Call):
        f = e.func
        if isinstance(f, ast.Name) and f.id in _HOST_FUNCS:
            return True
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            return True
        root = _root_name(f)
        return root in _HOST_ROOTS
    if isinstance(e, ast.BinOp):
        return _is_host_expr(e.left, known) and _is_host_expr(e.right, known)
    if isinstance(e, ast.UnaryOp):
        return _is_host_expr(e.operand, known)
    return False


def _host_known_names(fn) -> set[str]:
    """Names whose every assignment in ``fn`` is host-producing, to a fixed
    point (``host = buf.numpy()`` makes ``nxt = host[:n]`` host-side)."""
    known: set[str] = set()
    while True:
        produced: dict[str, bool] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                host = _is_host_expr(node.value, known)
                produced[name] = produced.get(name, True) and host
            elif isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Name):
                produced[node.target.id] = (
                    produced.get(node.target.id, True)
                    and _is_host_expr(node.iter, known))
            elif isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Tuple):
                host = _is_host_expr(node.iter, known)
                for e in node.target.elts:
                    if isinstance(e, ast.Name):
                        produced[e.id] = produced.get(e.id, True) and host
        new = {n for n, host in produced.items() if host}
        if new == known:
            return known
        known = new


def _possibly_device(arg, host_known) -> bool:
    if isinstance(arg, ast.Constant):
        return False
    root = _root_name(arg)
    if root is not None and root in host_known:
        return False
    if _is_meta(arg):
        return False
    if root is None and not _contains_device(arg) and _is_host_expr(arg):
        return False
    return True


@rule("host-sync-in-hot-path")
def host_sync_in_hot_path(ctx, path, tree, lines):
    """Inside a hot-registered function (``decode_tick``, ``_tick``,
    ``decision_hw``, ``map_batch``, ``schedule``, ... — see
    ``AnalysisContext.hot_functions`` / ``REPRO_TORCH_LINT_HOT``), a
    blocking device→host synchronization: ``x.item()`` / ``x.cpu()`` /
    ``x.tolist()`` / ``x.numpy()`` or ``float(x)`` / ``bool(x)`` /
    ``int(x)`` on a possibly-device value, ``torch.cuda.synchronize()``,
    or ``np.asarray(<torch expression>)`` (an op dispatched just to be
    copied back).  A tensor's metadata (``.shape``, ``.size()``, ...) is
    host-side.  The sanctioned shape is one packed transfer of what the
    tick computed, marked ``# repro: noqa[host-sync-in-hot-path]`` with
    its reason."""
    rel = ctx.relpath(path)
    for fn in _functions(tree):
        if fn.name not in ctx.hot_functions:
            continue
        host_known = _host_known_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = _dotted(node.func)
            # torch.cuda.synchronize()
            if f in ("torch.cuda.synchronize", "cuda.synchronize"):
                yield Finding(
                    rel, node.lineno, node.col_offset,
                    "host-sync-in-hot-path",
                    f"torch.cuda.synchronize() inside hot function "
                    f"{fn.name!r} stalls the host on the whole device "
                    f"queue every call")
                continue
            # x.item() / x.cpu() / x.tolist() / x.numpy()
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                recv = node.func.value
                root = _root_name(recv)
                if root is not None and root in host_known:
                    continue
                yield Finding(
                    rel, node.lineno, node.col_offset,
                    "host-sync-in-hot-path",
                    f".{node.func.attr}() inside hot function {fn.name!r} "
                    f"blocks on a device value every call")
                continue
            # float(x) / bool(x) / int(x) on a possibly-device value
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _SYNC_BUILTINS and node.args:
                if not _possibly_device(node.args[0], host_known):
                    continue
                yield Finding(
                    rel, node.lineno, node.col_offset,
                    "host-sync-in-hot-path",
                    f"{node.func.id}() on a possibly-device value inside "
                    f"hot function {fn.name!r} — one blocking transfer per "
                    f"call; copy the tick's results back once, packed (or "
                    f"mark the name host-side)")
                continue
            # np.asarray(<torch expression>) — an op dispatched + a sync
            if f in ("np.asarray", "np.array", "numpy.asarray",
                     "numpy.array") and node.args \
                    and _contains_device(node.args[0]):
                yield Finding(
                    rel, node.lineno, node.col_offset,
                    "host-sync-in-hot-path",
                    f"{f}() over a torch expression inside hot function "
                    f"{fn.name!r} dispatches the op just to copy it back "
                    f"and blocks on the transfer — compute it with the "
                    f"tick's outputs and transfer the (small) packed result "
                    f"instead")


# ---------------------------------------------------------------------------
# sharding-axis


def _spec_strings(node):
    """String constants appearing in a ``P(...)`` argument (tuples of axis
    names count — ``P(("pod", "data"), None)``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value, node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _spec_strings(e)


@rule("sharding-axis")
def sharding_axis(ctx, path, tree, lines):
    """Every ``P(...)`` / ``PartitionSpec(...)`` literal outside ``dist/``
    must name only the logical mesh axes (``pod``/``data``/``model``).
    Model and scheduler code consume layouts through named ``shard_hint``
    sites; a stray literal axis name bypasses the policy indirection and
    breaks on any mesh that doesn't spell that axis."""
    rel = ctx.relpath(path)
    if any(part in ctx.axis_exempt_parts for part in Path(rel).parts):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = _dotted(node.func)
        if f is None or not (f == "P" or f.split(".")[-1] == "PartitionSpec"):
            continue
        for s, anchor in (pair for a in node.args
                          for pair in _spec_strings(a)):
            if s not in ctx.axis_names:
                yield Finding(
                    rel, anchor.lineno, anchor.col_offset, "sharding-axis",
                    f"PartitionSpec axis {s!r} is not one of the mesh axes "
                    f"{tuple(sorted(ctx.axis_names))} — outside dist/, "
                    f"specs must use the logical axis names only")
