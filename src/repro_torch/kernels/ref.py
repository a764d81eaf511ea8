"""Plain PyTorch oracles for the HEFT_RT hardware-dataplane kernels.

Counterpart of ``repro.kernels.ref``.  Every CUDA kernel of the port is held
against these (on the card by ``chip_smoke.py``, on the CPU by the tests),
and these are held against :mod:`repro_torch.core.heft_rt` and the JAX
references, so kernel ⇔ software-scheduler equivalence (the paper's Fig. 3
functional verification) is transitive.  Leading dims, where a function
takes them, are independent events.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.heft_rt import eft_assign

NEG_INF = float("-inf")


def oddeven_sort_ref(keys: torch.Tensor, payload: torch.Tensor):
    """Stable descending sort of (keys, payload) over the last dim — what the
    shift-register priority queue computes.  Odd–even transposition with
    strict compares is stable, so a stable descending argsort is the exact
    oracle (NaN keys last, as ``jnp.argsort(-keys, stable=True)``)."""
    order = torch.argsort(-keys.to(torch.float32), dim=-1, stable=True)
    return keys.gather(-1, order), payload.gather(-1, order)


def oddeven_sort_sim(keys: torch.Tensor, payload: torch.Tensor):
    """Step-by-step odd–even transposition (descending, strict swap) on a 1-D
    queue, written with the brick-wall even/odd-plane decomposition of the
    reference's Pallas kernel — an executable spec of its inner loop."""
    D = keys.shape[0]
    if D % 2:
        raise ValueError(f"oddeven_sort_sim needs an even length, got {D}")
    M = D // 2
    ke, ko = keys[0::2].to(torch.float32), keys[1::2].to(torch.float32)
    pe_, po = payload[0::2], payload[1::2]
    for _ in range(M + 1):
        # even phase: compare (2i, 2i+1) == (ke[i], ko[i])
        m = ke < ko
        ke, ko = torch.where(m, ko, ke), torch.where(m, ke, ko)
        pe_, po = torch.where(m, po, pe_), torch.where(m, pe_, po)
        # odd phase: compare (2i+1, 2i+2) == (ko[i], ke[i+1])
        b = torch.roll(ke, -1)
        b[M - 1] = NEG_INF                                # right neighbours
        pb = torch.roll(pe_, -1)
        m = ko < b
        ko_new = torch.where(m, b, ko)
        b_new = torch.where(m, ko, b)
        pb_new = torch.where(m, po, pb)
        po_new = torch.where(m, pb, po)
        ke_new = torch.roll(b_new, 1)
        ke_new[0] = ke[0]
        pe_new = torch.roll(pb_new, 1)
        pe_new[0] = pe_[0]
        ke, ko, pe_, po = ke_new, ko_new, pe_new, po_new
    keys_out = torch.stack([ke, ko], dim=1).reshape(D)
    payload_out = torch.stack([pe_, po], dim=1).reshape(D)
    return keys_out.to(keys.dtype), payload_out


def eft_select_ref(exec_sorted: torch.Tensor, avail: torch.Tensor):
    """PE-handler + EFT-selector feedback loop over a queue already in
    priority order.

    Returns (assignment i32[..., D], start f32[..., D], finish f32[..., D],
    new_avail f32[..., P]).  Rows whose every exec is +inf get assignment -1
    and start/finish +inf, and do not touch the availability registers.
    """
    return eft_assign(exec_sorted, avail)


def heft_fused_ref(avg: torch.Tensor, exec_times: torch.Tensor,
                   avail: torch.Tensor):
    """Full mapping event: stable descending sort by ``avg``, then the EFT
    drain with each row read by QID.  ``exec_times`` is in QUEUE order.

    Returns (order i32, assignment i32, start f32, finish f32, new_avail
    f32) — the plain version of the fused CUDA kernel and the exact mirror
    of :func:`repro_torch.core.heft_rt`.
    """
    D = avg.shape[-1]
    qids = torch.arange(D, dtype=torch.int32, device=avg.device)
    _, order = oddeven_sort_ref(avg, qids.expand(avg.shape))
    idx = order.to(torch.int64)
    exec_sorted = torch.gather(
        exec_times, -2,
        idx[..., None].expand(*idx.shape, exec_times.shape[-1]))
    pes, starts, fins, new_avail = eft_select_ref(exec_sorted, avail)
    return order, pes, starts, fins, new_avail


SMALL_PES = 8      # up to here one thread runs the step (heft_event.cuh)
WARP = 32


def _finish_rank(f) -> int:
    """Ascending rank of a finish by value, -0.0 tied with +0.0 (the wide
    step's warp reduction takes the least; a lane holding a NaN ranks 0)."""
    if np.isnan(f):
        return 0
    u = int(np.float32(f + np.float32(0.0)).view(np.uint32))  # -0.0 -> +0.0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _trees(f, start, lanes):
    """The step's two trees over one thread's finishes (a power of two of
    them): a strict less-than tree carrying (finish, start, lane) — a
    higher half wins only if strictly smaller, so ties go to the lower lane
    and the winner keeps its own bits — and a NaN-propagating min tree.
    Returns (finish, start, lane, min)."""
    v, sv, ix, mn = list(f), list(start), list(lanes), list(f)
    w = 1
    while w < len(v):
        for p in range(0, len(v) - w, 2 * w):
            if v[p + w] < v[p]:
                v[p], sv[p], ix[p] = v[p + w], sv[p + w], ix[p + w]
            mn[p] = (np.float32(np.nan) if np.isnan(mn[p]) or
                     np.isnan(mn[p + w]) else min(mn[p], mn[p + w]))
        w *= 2
    return v[0], sv[0], ix[0], mn[0]


def _small_step(av, row, P):
    """P <= 8: one thread over S = the power of two >= P lanes (pad lanes
    hold register 0 and exec +inf).  The winner is the less-than tree's;
    the step is taken only if the min tree's result is finite (no lane NaN,
    the minimum finite), so a NaN lane needs no index."""
    S = 1 << (P - 1).bit_length()
    start = [np.float32(av[p] if p < P else 0.0) for p in range(S)]
    f = [start[p] + np.float32(row[p]) for p in range(S)]
    bv, bs, bi, mn = _trees(f, start, range(S))
    return (bv, bs, bi) if np.isfinite(mn) else (np.float32(np.inf), None, -1)


def _wide_step(av, row, P):
    """P > 8: one warp, lane l holding lanes l, l + 32, ... (C of them, a
    power of two); each lane runs the two trees over its own lanes and
    ranks 0 if it holds a NaN, else by its best finish.  The warp's least
    rank (a ``redux.sync``), the least lane at that rank (a second one),
    whose finish and start come from its owner; taken if the least rank is
    not 0 and the finish is finite."""
    C = 1 << (-(-P // WARP) - 1).bit_length()
    best = []
    for lane in range(WARP):
        ps = [lane + c * WARP for c in range(C)]
        start = [np.float32(av[p] if p < P else 0.0) for p in ps]
        f = [start[c] + np.float32(row[p] if p < P else np.inf)
             for c, p in enumerate(ps)]
        bv, bs, bi, mn = _trees(f, start, ps)
        best.append((0 if np.isnan(mn) else _finish_rank(bv), bv, bs, bi))
    least = min(b[0] for b in best)
    wi = min(b[3] for b in best if b[0] == least)
    _, bv, bs, _ = best[wi % WARP]
    if least == 0 or not np.isfinite(bv):
        return np.float32(np.inf), None, -1
    return bv, bs, wi


def _staged_drain(ex: np.ndarray, av: np.ndarray, pe_mask, tile: int | None):
    """Phase 2 of the event kernels (``drain_event`` in
    ``csrc/heft_event.cuh``) over ``ex`` f32[D, P], the exec rows already in
    drain order, from the registers ``av`` (updated in place).

    The queue is cut into tiles of ``tile`` positions (the whole queue when
    None, as when it fits in shared memory).  Staging a tile applies the
    mask (+inf in masked and pad lanes, the row stride P rounded up to 4),
    flags the live rows (a lane other than +inf), numbers them by an
    exclusive prefix sum of the flags and copies them, in that order, into
    the staged rows; ``slot`` maps each position to its live row or to
    none.  The drain walks the staged rows with the kernel's step for the
    event's P (:func:`_small_step` up to 8 PEs, :func:`_wide_step` above),
    latches a finite winner into its register and writes one record per
    row; the write-back gives each position its record, or (-1, +inf,
    +inf) if it has none.  Returns (assignment, start, finish) as numpy.
    """
    D, P = ex.shape
    tile = D if tile is None else tile
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    stride = (P + 3) & ~3
    assignment = np.full(D, -1, np.int32)
    start = np.full(D, np.inf, np.float32)
    finish = np.full(D, np.inf, np.float32)
    step = _small_step if P <= SMALL_PES else _wide_step
    with np.errstate(invalid="ignore"):
        for t0 in range(0, D, tile):
            n = min(tile, D - t0)
            rows = np.full((n, stride), np.inf, np.float32)   # by position
            rows[:, :P] = ex[t0:t0 + n]
            if pe_mask is not None:
                rows[:, :P][:, pe_mask.numpy()] = np.inf
            live = (rows != np.inf).any(axis=1)
            slot = np.where(live, np.cumsum(live) - live, -1)  # exclusive
            staged = np.empty((int(live.sum()), stride), np.float32)
            staged[slot[live]] = rows[live]
            records = []
            for row in staged:                         # the drain: live rows
                bv, bs, bi = step(av, row, P)
                if bi >= 0:
                    av[bi] = bv
                records.append((bi, bs, bv))
            for t in np.flatnonzero(live):             # the write-back
                bi, bs, bv = records[slot[t]]
                if bi >= 0:
                    assignment[t0 + t], start[t0 + t] = bi, bs
                    finish[t0 + t] = bv
    return assignment, start, finish


def heft_event_sim(avg: torch.Tensor, exec_times: torch.Tensor,
                   avail: torch.Tensor, pe_mask: torch.Tensor | None = None,
                   *, tile: int | None = None):
    """Step-by-step mirror of the event kernel's phase 2 on one event
    (``event_kernel`` in ``csrc/heft_event.cuh``) — an executable spec, as
    :func:`bitonic_sort_sim` is of its sort: the queue sorted by ``avg``,
    then :func:`_staged_drain` over the exec rows in that order.

    ``avg`` f32[D], ``exec_times`` f32[D, P] in queue order, ``avail``
    f32[P], ``pe_mask`` bool[P] or None.  Returns (order, assignment,
    start, finish, new_avail), equal bit for bit to :func:`heft_fused_ref`
    (and, with a mask, to ``fused_decision.decision_ref``).
    """
    D = exec_times.shape[0]
    qids = torch.arange(D, dtype=torch.int32)
    _, order = oddeven_sort_ref(avg, qids)
    ex = exec_times.to(torch.float32).numpy()[order.numpy()]
    av = avail.to(torch.float32).numpy().copy()
    outs = _staged_drain(ex, av, pe_mask, tile)
    return (order, *(torch.from_numpy(x) for x in (*outs, av)))


def eft_select_sim(exec_sorted: torch.Tensor, avail: torch.Tensor, *,
                   tile: int | None = None):
    """Step-by-step mirror of the ``eft_select`` kernel on one event: the
    staged drain of :func:`heft_event_sim` over rows already in priority
    order (no sort, position t drains row t, no order output).

    ``exec_sorted`` f32[D, P], ``avail`` f32[P].  Returns (assignment,
    start, finish, new_avail), equal bit for bit to :func:`eft_select_ref`.
    """
    ex = exec_sorted.to(torch.float32).numpy()
    av = avail.to(torch.float32).numpy().copy()
    outs = _staged_drain(ex, av, None, tile)
    return tuple(torch.from_numpy(x) for x in (*outs, av))


# ---------------------------------------------------------------------------
# the priority sort's schedule (sort_queue in csrc/heft_event.cuh)
# ---------------------------------------------------------------------------

SORT_CHUNK = 4096     # keys sorted in shared memory at once
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def sort_grain(N: int, threads: int) -> int:
    """Keys a thread holds in ``sort_queue``: N / threads (a chunk's above
    4096 slots), from 2 to 8."""
    return min(max(min(N, SORT_CHUNK) // threads, 2), 8)


def desc_rank(keys: torch.Tensor) -> np.ndarray:
    """The kernel's u32 rank of each key (``desc_rank`` in
    ``heft_event.cuh``): ascending rank is descending key order, NaN after
    -inf, -0.0 with +0.0 (f32, and bf16 / f16 as the f32 they widen to);
    int32 keys by the exact integer order."""
    if keys.dtype == torch.int32:
        u = keys.numpy().view(np.uint32).astype(np.uint64)
        return ~(u ^ 0x80000000) & 0xFFFFFFFF
    f = keys.to(torch.float32).numpy()
    u = (f + np.float32(0.0)).view(np.uint32).astype(np.uint64)  # -0 -> +0
    asc = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(f), 0xFFFFFFFF, ~asc & 0xFFFFFFFF).astype(
        np.uint64)


def _swz(i: np.ndarray) -> np.ndarray:
    """Key i's place in the shared buffer between register phases."""
    return i ^ (((i >> 4) & 7) << 1)


def _pair(a: np.ndarray, b: np.ndarray, up: np.ndarray):
    """order_pair: the smaller key first where ``up``, else the larger."""
    swap = (a > b) == up
    return np.where(swap, b, a), np.where(swap, a, b)


def _buffer_stage(s, n, g0, k, j, swizzled, count):
    """A stage over a buffer, pair by pair (``buffer_stage``)."""
    p = np.arange(n // 2)
    i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
    a, b = (_swz(i), _swz(i | j)) if swizzled else (i, i | j)
    s[a], s[b] = _pair(s[a], s[b], ((g0 | i) & k) == 0)
    count["global" if not swizzled else "shared"] += 1
    count["barriers"] += 1


def _register_stages(v, idx, E, k, up, count):
    """The stages j < min(k, E) of level k within each thread's E keys,
    ``up`` the direction of each key's pair."""
    e = idx % E
    j = min(k, E) // 2
    while j > 0:
        lo = (e & j) == 0
        v = v.copy()
        v[idx[lo]], v[idx[lo] | j] = _pair(v[lo], v[idx[lo] | j], up[lo])
        count["register"] += 1
        j //= 2
    return v


def _bitonic_levels(v, n, g0, k0, k1, E, count):
    """``bitonic_levels``: v holds the keys of the threads, thread t at
    v[t*E : t*E + E] (past n, the padding lanes of warp 0); levels k0..k1
    over n keys with global indices from g0.  Returns v."""
    idx = np.arange(len(v))
    t, e = idx // E, idx % E
    i0 = g0 + t * E
    holders = n // E
    k = k0
    if k0 == 2:                                   # sort_own: levels 2..E
        while k <= E:
            up = ((i0 & E) == 0) if k == E else ((e & k) == 0)
            v = _register_stages(v, idx, E, k, up, count)
            k *= 2
    while k <= k1:
        j = min(k, n) // 2
        if j >= 32 * E:
            s = np.zeros(n, np.uint64)
            s[_swz(idx[:n])] = v[:n]                  # put_keys, swizzled
            count["barriers"] += 1
            while j >= 32 * E:
                _buffer_stage(s, n, g0, k, j, True, count)
                j //= 2
            v = v.copy()
            v[:n] = s[_swz(idx[:n])]                  # get_keys
        while j >= E:                                 # shuffle_stage
            # a holder's partner lane holds keys too
            assert ((t >= holders) | ((t ^ (j // E)) < holders)).all()
            y = v[idx ^ j]       # the same key of lane ^ (j / E)
            keep_min = ((i0 & j) == 0) == ((i0 & k) == 0)
            v = np.where(keep_min == (y < v), y, v)
            count["shuffle"] += 1
            j //= 2
        v = _register_stages(v, idx, E, k, (i0 & k) == 0, count)
        k *= 2
    return v


def bitonic_sort_sim(keys: torch.Tensor, payload: torch.Tensor,
                     threads: int):
    """Step-by-step mirror of ``sort_queue`` (``csrc/heft_event.cuh``) on
    one queue, sorted by a block of ``threads`` threads — an executable
    spec of its schedule, vectorised per stage.

    The composite keys (``desc_rank`` of the key, slot) of the D keys and
    the N - D pads (rank 0xFFFFFFFF) sit E = :func:`sort_grain` a thread.
    Each bitonic stage (k, j) runs where the kernel runs it: j < E within a
    thread, E <= j < 32 E as a shuffle between lanes of a warp, j >= 32 E
    through the swizzled shared buffer behind a barrier; up to 32 E slots,
    one warp (its lanes past the keys hold all-ones padding).  Above 4096
    slots, chunks of 4096 sort first, then each level runs its stages j >=
    4096 as passes over the scratch buffer and the rest chunk by chunk.
    Every compare's direction comes from the key's index in the queue.

    ``keys`` f32, bf16, f16 or i32 [D], ``payload`` i32 [D].  Returns
    (sorted keys, sorted payload, counts): keys and payload gathered from
    the inputs by the sorted slot (equal bit for bit to
    ``oddeven_sort.sort_plain``), and the stages run of each kind with the
    block barriers they took.
    """
    D = keys.shape[0]
    N = 2
    while N < D:
        N *= 2
    E = sort_grain(N, threads)
    n = min(N, SORT_CHUNK)
    if threads & (threads - 1) or not 32 <= threads <= 1024 or \
            threads < n // E:
        raise ValueError(f"{threads} threads cannot sort {N} slots")
    ranks = np.full(N, 0xFFFFFFFF, np.uint64)
    ranks[:D] = desc_rank(keys)
    comp = (ranks << np.uint64(32)) | np.arange(N, dtype=np.uint64)
    count = dict.fromkeys(("register", "shuffle", "shared", "global",
                           "barriers"), 0)
    if N <= SORT_CHUNK:
        v = np.full(max(N, 32 * E), ALL_ONES)       # warp 0's padding lanes
        v[:N] = comp
        buf = _bitonic_levels(v, N, 0, 2, N, E, count)[:N]
        count["barriers"] += 1                         # before the final put
    else:
        buf = np.empty(N, np.uint64)
        for g0 in range(0, N, SORT_CHUNK):
            buf[g0:g0 + SORT_CHUNK] = _bitonic_levels(
                comp[g0:g0 + SORT_CHUNK], SORT_CHUNK, g0, 2, SORT_CHUNK, E,
                count)
        k = 2 * SORT_CHUNK
        while k <= N:
            j = k // 2
            while j >= SORT_CHUNK:
                _buffer_stage(buf, N, 0, k, j, False, count)
                j //= 2
            count["barriers"] += 1
            for g0 in range(0, N, SORT_CHUNK):
                buf[g0:g0 + SORT_CHUNK] = _bitonic_levels(
                    buf[g0:g0 + SORT_CHUNK], SORT_CHUNK, g0, k, k, E, count)
            k *= 2
    count["barriers"] += 1                             # the closing one
    order = torch.from_numpy((buf[:D] & 0xFFFFFFFF).astype(np.int64))
    return keys[order], payload[order], count
