"""Decode attention from the paged KV pool: CUDA kernel
``csrc/paged_decode_attention.cu`` and its wrapper.

One query a lane against that lane's cached keys and values, read in place
through its row of the page table, up to its own position.  It replaces no
Pallas kernel of the JAX package, whose decode attention is plain ``jnp``
over a dense view; it was added because the paged tick gathered every
lane's whole ``max_len`` into such a view and cast it to float32, which
took most of a long-context tick on the card.  Its bound is the live K / V
bytes.  The design (flash-decode over fixed chunks of slots, partials
merged in chunk order, no atomics) is in the note at the top of the
``.cu`` file.

Its plain version, :func:`paged_decode_attention_ref`, gathers the pages
into the dense view and runs ``models.attention.decode_attention``: the
kernel computes that function, its sums in another order.  The wrapper
launches the kernel on CUDA tensors and runs the plain version only on CPU
tensors; a shape the kernel does not take raises, with no fallback.  The
launch allocates its scratch and output with ``torch.empty`` and neither
allocates nor synchronises inside, so a CUDA graph captures it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = _build.Kernel("paged_decode_attention", "paged_decode_attention.cu", {
    "paged_decode_attention_launch": ([_P] * 9 + [_I] * 8 + [_F] * 2 + [_P],
                                      ctypes.c_int),
})

CHUNK = 256                 # slots a block: csrc/paged_decode_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(q, k_pool, v_pool, table, pos):
    """Validate the operands; returns (lanes, H, KV, hd, page_size,
    pages_per_lane)."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"want q (lanes, H, hd) and pools (pages, page_size, "
                         f"KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}")
    lanes, H, hd = q.shape
    pages, ps, KV, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"k {tuple(k_pool.shape)} and v "
                         f"{tuple(v_pool.shape)} must be (pages, page_size, "
                         f"KV, {hd})")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not share {KV} KV heads")
    if table is None:
        if pages != lanes:
            raise ValueError(f"a contiguous cache needs one page a lane: "
                             f"{pages} pages, {lanes} lanes")
        pp = 1
    else:
        if table.dim() != 2 or table.shape[0] != lanes:
            raise ValueError(f"table must be ({lanes}, pages_per_lane), got "
                             f"{tuple(table.shape)}")
        pp = table.shape[1]
    if pos.shape != (lanes,):
        raise ValueError(f"pos must be ({lanes},), got {tuple(pos.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    named = [("q", q), ("k", k_pool), ("v", v_pool), ("pos", pos)]
    if table is not None:
        named.append(("table", table))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return lanes, H, KV, hd, ps, pp


def paged_decode_attention_ref(q, k_pool, v_pool, table, pos, *, scale,
                               attn_cap, window):
    """The plain version: the lanes' pages gathered into a dense (lanes,
    pages_per_lane * page_size, KV, hd) view (``table`` None: the pools
    are that view already) and ``decode_attention`` over it."""
    from repro_torch.models.attention import decode_attention

    k, v = k_pool, v_pool
    if table is not None:
        rows = table.long()
        k = k_pool[rows].flatten(1, 2)
        v = v_pool[rows].flatten(1, 2)
    return decode_attention(q[:, None], k, v, pos, scale=scale,
                            attn_cap=attn_cap, window=window)[:, 0]


def tolerance(q, k_pool, v_pool, table, pos, *, scale, attn_cap,
              window) -> torch.Tensor:
    """How far, element by element, the kernel's output may lie from the
    plain version's, (lanes, H, hd) float32.

    Both take the same float32 function of the same values, each summing in
    its own order, and round it once to the output's dtype.  So an element
    may differ by one spacing of that dtype at the plain output's size
    (twice that allowed), plus what the two float32 sums can gather: for an
    element whose weighted sum runs over ``n`` live slots, ``(n + hd) ·
    2^-23 · Σ p|v|`` (``n`` roundings of the value sum and the softmax's
    normaliser, ``hd`` of each score's dot product and its exp and tanh, each
    relative to ``Σ p|v|``, the plain version over ``|v|``).  A fault that
    adds or drops one slot moves a lane's element by ``p_j · |v_j - out|``,
    about ``|v| / n``, which is many times that."""
    kw = dict(scale=scale, attn_cap=attn_cap, window=window)
    f32 = torch.float32
    want = paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                      **kw).to(f32)
    mag = paged_decode_attention_ref(q.to(f32), k_pool.to(f32),
                                     v_pool.to(f32).abs(), table, pos, **kw)
    live = pos.to(f32) + 1
    if window is not None:
        live = live.clamp(max=window)
    eps = torch.finfo(q.dtype).eps
    _, exp = torch.frexp(want)
    spacing = torch.ldexp(torch.full_like(want, eps / 2), exp)
    hd = q.shape[-1]
    return (2 * spacing + (live[:, None, None] + hd)
            * torch.finfo(f32).eps * mag)


def planted_faults(pos, max_len: int, kw: dict):
    """The faults :func:`tolerance` must reject, as ``(name, pos, kw)``: the
    operands under which a correct kernel gives the faulty kernel's output.
    A lane's last slot one past or one short (``pos ± 1``), the window one
    wider or narrower, and the soft cap taken before the scale (``scale ·
    cap · tanh(s / cap)`` is ``cap' · tanh(scale · s / cap')`` at ``cap' =
    scale · cap``)."""
    yield "pos+1", (pos + 1).clamp(max=max_len - 1), kw
    yield "pos-1", (pos - 1).clamp(min=0), kw
    if kw["window"] is not None:
        yield "window+1", pos, dict(kw, window=kw["window"] + 1)
        yield "window-1", pos, dict(kw, window=kw["window"] - 1)
    if kw["attn_cap"] is not None:
        yield "cap-before-scale", pos, dict(
            kw, attn_cap=kw["attn_cap"] * kw["scale"])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor | None,
                           pos: torch.Tensor, *, scale: float,
                           attn_cap: float | None,
                           window: int | None) -> torch.Tensor:
    """``q`` (lanes, H, hd) against the pools ``k_pool`` / ``v_pool``
    (pages, page_size, KV, hd), lane ``b`` reading page ``table[b, j]`` for
    its slots ``j * page_size ..``, the slots ``<= pos[b]`` (int32
    (lanes,)) and, under a ``window``, ``> pos[b] - window``.  ``table``
    None reads a contiguous (lanes, max_len, KV, hd) cache, lane ``b`` its
    own rows.  Returns (lanes, H, hd) in q's dtype.  CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    lanes, H, KV, hd, ps, pp = _check_operands(q, k_pool, v_pool, table, pos)
    kw = dict(scale=scale, attn_cap=attn_cap, window=window)
    dev = q.device
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, table, pos, **kw)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{dev}")
    vec_bytes = hd * q.element_size()
    vecs = vec_bytes // 16
    if vec_bytes % 16 or vecs & (vecs - 1) or vecs > 64:
        raise ValueError(f"the kernel reads a head's row in 16-byte vectors, "
                         f"a power of two of them up to 64: hd {hd} of "
                         f"{q.dtype} is {vec_bytes} bytes")
    for name, t in (("q", q), ("k", k_pool), ("v", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nchunk = -(-pp * ps // CHUNK)
    m = torch.empty((lanes, H, nchunk), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    o = torch.empty((lanes, H, nchunk, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = KERNEL.lib().paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if table is None else table.data_ptr(), pos.data_ptr(),
        m.data_ptr(), l.data_ptr(), o.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], lanes, H, KV, hd, ps, pp,
        0 if window is None else int(window), float(scale),
        0.0 if attn_cap is None else float(attn_cap), stream)
    KERNEL.launches += 1
    _build.check_status(KERNEL, status)
    return out
