"""Block-paged KV cache pool for continuous batching.

Counterpart of ``repro.serve.paging`` (design note: docs/serving.md).  The
caches of every in-flight request live in one pool of fixed-size pages on
the engine's device, and requests join and leave the running batch between
decode ticks.

Layout
------
The model's caches are one tensor per leaf name, stacked over the layers
that have it (``models/model.py``).  A leaf with a sequence axis (``k`` /
``v``, MLA's ``ckv`` / ``kr``) is paged: its pool re-cuts the batch axis
into ``num_pages + 1`` pages and ``Smax`` into ``page_size``:

    dense (L, B, Smax, KV, hd)  →  pool (L, num_pages + 1, page_size, KV, hd)

The last page (index ``num_pages``) is the *scratch page*: padded lanes and
unreserved page-table entries point at it, so every tick has the same shapes
and stray writes land somewhere harmless.  A state leaf (Mamba's ``conv`` /
``ssm``, no sequence axis) lives in a *state pool* of ``max_batch + 1``
slots, the last being the scratch slot:

    dense (L, B, K-1, d_inner)  →  pool (L, max_batch + 1, K-1, d_inner)

A slot id indexes both the page table and the state pool.  A host page
table (``max_batch + 1`` rows × ``pages_per_slot`` page ids; row
``max_batch`` all scratch) maps each slot onto its pages.  Every page a
request will need is reserved when it is admitted (``ceil((S0 +
new_tokens) / page_size)``), so decode never runs out of pages: exhaustion
gates admission only, and callers queue, never drop.

Decode tick
-----------
A tick gathers the lanes' pages into a dense ``(L, lanes, Smax, ...)`` view
and their state rows by slot id, runs ``decode_step`` with one position per
lane, scatters back the one token each lane wrote to its page and each
lane's new state row to its slot, and takes the argmax on the device; the
host receives the ``(lanes,)`` tokens in one copy.

**K / V read in place.**  On the card (a meshless engine on a ``cuda``
device, as for the graph below) a model that caches ``k`` / ``v`` skips
their gather and scatter: the tick hands ``decode_step`` the pools
themselves with the lanes' page table (``models.attention.PageTable``),
each attention layer writes its new token to its page and
``kernels.paged_decode_attention`` reads each lane's pages in place, up to
its position.  The dense ``generate`` runs the same kernel on its
contiguous cache (one page a lane), so the two stay bitwise equal.  State
leaves and MLA's ``ckv`` / ``kr`` are gathered and scattered as before, and
so are ``k`` / ``v`` on the CPU and on a mesh slice.  ``tick_kv`` counts
the ``paged`` ticks, and holds the last tick's ``live_slots`` (its active
lanes' positions + 1, summed) beside its ``slots`` (lanes x ``max_len``):
their ratio is the share of the old gather the tick still reads.

**Row invariance.**  Every decode step of an engine, paged or dense
(``ServeEngine.generate``), runs at the engine's fixed lane count
``engine.lanes``, padded with scratch lanes.  So every decode matmul has
one shape and takes one kernel, and a row's result does not depend on how
many requests share the tick: each request's tokens are bitwise those of
the dense single-request ``generate``, under any admission interleaving.
(The reference pads to power-of-two buckets instead, to bound JAX
retraces; eager PyTorch has none, and a GEMM's rows are not bitwise
independent of its row count, on the CPU or the card.)  Stale values beyond
a row's position are masked before the softmax, and the pool only ever
holds finite values.

**The fused tick.**  ``decode_tick(sched=(avg, exec_times, fabric))`` with a
``backend="fused"`` :class:`repro_torch.sched_integration.MappingFabric`
also makes that fabric's next HEFT_RT decision: the event is staged through
``fabric.tick_decision_inputs`` and uploaded before the decode step, the
``fused_decision`` kernel runs on the same stream after it, in place on the
fabric's resident ``T_avail`` register (``repro_torch.kernels.decision_hw``),
the device counters accumulate when the fabric has them, and one
device-to-host copy brings back ``pack_tick_outputs(tokens, decision)``;
``fabric.commit_tick_decision`` adopts the decision lanes.

With capacity-dispatched MoE layers, row invariance holds while no token
can be dropped: at 4 lanes or fewer (``models/moe.py``).  Above that a
lane's tokens can depend on its batch-mates' routing, in this runtime as in
the reference's.  Dropless MoE layers (``moe.capacity_factor`` None) drop
nothing at any lane count: there a lane's logits do not depend on its
batch-mates, bitwise for the row-by-row expert product (the CPU, float32)
and the card's grouped GEMM alike (``models/moe.py``; PERF.md, PR 28).

**Routed experts.**  With dropless MoE layers a tick also counts the
distinct experts its active lanes routed to, summed over the layers
(``models/moe.py`` ``distinct_experts``), on the device inside the tick's
work: the count rides after the tokens in the tick's one device-to-host
copy (``tokens | count | decision``) and is ``tick_experts``.  An
admission's first-token copy carries its prefill's distinct experts the
same way (``admit_routes``, with its routed rows).  Other models count
nothing and their copies are as before.

**The graphed tick.**  A meshless engine on the card replays its tick's
device work (gather, ``decode_step``, scatter, argmax) as one CUDA graph
instead of issuing it op by op; the runtime chooses this from what it can
observe (``engine.mesh is None`` and a ``cuda`` device).  Elsewhere (the
CPU, a mesh slice, where ``DTensor`` dispatch and collectives sit inside
the step) the same body runs eagerly.  The graph runs the same kernels on
the same shapes, so its tokens are the eager tick's, bit for bit.  It is
captured on the runtime's first tick (:class:`_TickGraph`) over fixed
buffers: the lanes' inputs, uploaded from a pinned staging buffer, and the
tokens.  It holds the pools and the parameters by address, so
:meth:`PagedRuntime.rebind` (``ServeEngine.reshard``) drops it and a tick
whose pools moved captures again.  The in-tick decision stays eager, on the
same stream after the replay.  ``PagedRuntime.tick_graph`` counts the
``captures``, ``replays`` and ``eager`` ticks.

**Spans.**  With a tracer on the engine, a tick's host time is split into
``tick.upload`` (the lanes' inputs), ``tick.gather``, ``tick.step``,
``tick.scatter`` (with the argmax), ``tick.wait`` (the one D2H copy: the
host blocks there until the device has finished the tick) and
``tick.tokens`` (the host bookkeeping after it); a graphed tick has one
``tick.replay`` in place of gather, step and scatter (and ``tick.capture``
on its first tick), and every tick a ``tick.graph`` counter of the
runtime's ``tick_graph`` counts, a ``tick.kv`` counter of its ``tick_kv``
(and, with dropless MoE layers, a ``moe.experts`` counter of
``tick_experts``).  A fused tick adds its
decision's ``map.inputs`` (staging and upload), ``map.launch`` (kernel,
counters, pack) and ``map.commit``.  An admission is ``admit.prefill``
(with the first token's argmax), ``admit.write`` and ``admit.wait`` (the
first token's D2H).  These are host spans: issue against wait, not device
time.  A copy from pageable host memory waits for the stream, so
``admit.write``, whose page-table row is copied after the prefill is
queued, also holds the host's wait for the prefill on the device.

Pages are also the migration and recovery unit: :meth:`PagedRuntime
.snapshot_slot` captures one request's pages, state rows and decode state
as numpy, and :meth:`PagedRuntime.restore_slot` re-admits it on any engine
with room.

**On a mesh.**  A mesh-backed engine's pools are ``DTensor``s laid out by
``page_pspecs`` (the cache rule with the page axis replicated: KV heads and
Mamba's d_inner over ``model``), and :meth:`PagedRuntime.rebind` places
them again after ``ServeEngine.reshard``.  The pool is made unpadded; on a
slice whose model axis pads the heads its KV heads are padded as the
engine's are (``dist.sharding.pad_caches``), and page snapshots leave it
unpadded again.  The page gather, the token
scatter and the admission write have no ``DTensor`` rule; they index the
page / slot axes, which are never sharded, so they run on each rank's
local shard (``dist.hints.local_call``) in the same layout as the dense
view.  The decode step itself runs on ``DTensor``s under the replica's
policy; its logits are gathered whole before the argmax, and the
``fused_decision`` kernel takes plain local tensors only (its operands and
the fabric's registers are replicated host uploads).  Only the slice's
ranks compute; the packed int32 buffer of the tick goes to the other ranks
of the world by broadcast, which also carries the new ``T_avail``
registers, so every rank's fabric adopts the same decision.
"""

from __future__ import annotations

import functools
import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.dist.hints import gathered, local_call
from repro_torch.dist.sharding import (mesh_root, named, pad_caches,
                                       page_pspecs, reshard_tree, to_plain,
                                       unpad_caches)
from repro_torch.kernels import decision_hw, pack_tick_outputs
from repro_torch.kernels.fused_decision import unpack_decision
from repro_torch.models.attention import PAGES, PageTable
from repro_torch.models.model import cache_specs
from repro_torch.models.moe import (distinct_experts, dropless,
                                    recording_routes)
from repro_torch.obs.device import accumulate_counters
from repro_torch.obs.trace import NULL_SPAN


def phase_span(tracer, name: str, event: int | None = None,
               n: int | None = None):
    """``tracer``'s span ``name``, carrying the mapping event's number
    ``event`` and its request count ``n`` where given; the shared no-op span
    when no tracer is attached (no span object, no argument dict)."""
    if tracer is None:
        return NULL_SPAN
    if event is None:
        return tracer.span(name)
    if n is None:
        return tracer.span(name, event=event)
    return tracer.span(name, event=event, n=n)


def _take_shape(pool, name: str, row) -> tuple:
    """Shape (without the layer axis) of one slot's pages or state row."""
    if name in STATE_LEAVES:
        return tuple(pool.shape[2:])
    return (len(row), *pool.shape[2:])


# Leaf classification by name, as the reference's.
PAGED_LEAVES = frozenset({"k", "v", "ckv", "kr"})
STATE_LEAVES = frozenset({"conv", "ssm"})
# The leaves a tick on the card reads from the pages in place.
KV_LEAVES = frozenset({"k", "v"})

# Eager runs of a tick before its capture (lazy initialisation, such as a
# stream's cuBLAS workspace, must not happen inside a capture).
GRAPH_WARMUP = 3

# One graph memory pool a device, shared by every runtime's tick graph.
# Sharing it is sound because the replicas tick strictly in turn and each
# tick ends in its device-to-host copy before the next begins: a replay may
# overwrite another graph's freed temporaries, or the tokens of a tick that
# has already been read, and nothing else.  Without it each replica would
# keep its own gathered view (8.05 GB at deepseek-7b's width, 8 lanes of
# 2048 slots).
@functools.cache
def _graph_pool(device: torch.device):
    return torch.cuda.graph_pool_handle()


class _TickGraph:
    """The fixed buffers of a runtime's graphed tick, and its CUDA graph.

    ``ints`` is the device copy of the lanes' int32 inputs, filled each tick
    from the pinned ``staging`` buffer (``host`` is its numpy view) without
    a wait: every tick ends in its device-to-host copy, so the staging
    buffer is free again by the next.  ``toks``, the (lanes,) int32 tokens,
    is None until the capture and stays allocated between replays.
    ``ptrs`` are the pools' addresses the graph was captured on.  Off the
    card ``graph`` stays None and each tick calls the captured body on the
    fixed buffers directly."""

    def __init__(self, n: int, device: torch.device, ptrs: tuple):
        self.staging = torch.zeros(n, dtype=torch.int32,
                                   pin_memory=device.type == "cuda")
        self.host = self.staging.numpy()
        self.ints = torch.zeros(n, dtype=torch.int32, device=device)
        self.ptrs = ptrs
        self.graph = None
        self.toks = None


@dataclass
class _Slot:
    """Host-side decode state of one in-flight request."""

    prompt: np.ndarray            # (S0,) int32
    new_tokens: int
    pages: list[int]              # reserved page ids (freed at retire)
    tokens: list[int] = field(default_factory=list)   # generated so far

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.new_tokens

    @property
    def write_pos(self) -> int:
        """Cache position the *next* decode tick writes this slot's current
        token at (= S0 + steps already decoded)."""
        return len(self.prompt) + len(self.tokens) - 1


class PagePool:
    """The page and state pools on ``device`` plus the host page table and
    free lists.

    Allocation bookkeeping only, no model math.  ``num_pages`` defaults to
    full occupancy (``max_batch * pages_per_slot``); set it lower to make
    admission queue.  ``allocated`` / ``freed`` count pages and
    ``slots_allocated`` / ``slots_freed`` slots (each slot holds one state
    row a state leaf), cumulatively; each pair is equal whenever no slot is
    in flight.
    """

    def __init__(self, cfg, max_batch: int, page_size: int, max_len: int,
                 num_pages: int | None = None, *, device):
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len={max_len} must be a multiple of page_size={page_size}")
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = max_len // page_size
        self.num_pages = int(num_pages if num_pages is not None
                             else max_batch * self.pages_per_slot)
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one full "
                f"sequence ({self.pages_per_slot} pages)")
        self.scratch_page = self.num_pages          # index of the scratch page
        self.scratch_slot = self.max_batch          # index of the scratch row
        self.table = np.full((self.max_batch + 1, self.pages_per_slot),
                             self.scratch_page, dtype=np.int32)
        self.free_page_ids: deque[int] = deque(range(self.num_pages))
        self.free_slot_ids: deque[int] = deque(range(self.max_batch))
        self.allocated = 0
        self.freed = 0
        self.slots_allocated = 0
        self.slots_freed = 0
        self.pools = {}
        for name, spec in cache_specs(cfg, 1, max_len).items():
            if name in PAGED_LEAVES:
                L, _, _, *rest = spec.shape
                shape = (L, self.num_pages + 1, self.page_size, *rest)
            elif name in STATE_LEAVES:
                L, _, *rest = spec.shape
                shape = (L, self.max_batch + 1, *rest)
            else:
                raise ValueError(f"unknown cache leaf {name!r}")
            self.pools[name] = torch.zeros(shape, dtype=spec.dtype,
                                           device=device)

    # -- allocation ---------------------------------------------------------

    def pages_needed(self, total_len: int) -> int:
        return math.ceil(total_len / self.page_size)

    def can_admit(self, total_len: int) -> bool:
        return (len(self.free_slot_ids) > 0
                and len(self.free_page_ids) >= self.pages_needed(total_len))

    def reserve(self, total_len: int) -> tuple[int, list[int]]:
        """Claim a slot and ALL pages ``total_len`` will need.  Check
        :meth:`can_admit` first; raises RuntimeError otherwise."""
        n = self.pages_needed(total_len)
        if not self.can_admit(total_len):
            raise RuntimeError(
                f"pool exhausted: need {n} pages / 1 slot, have "
                f"{len(self.free_page_ids)} pages / "
                f"{len(self.free_slot_ids)} slots")
        slot = self.free_slot_ids.popleft()
        pages = [self.free_page_ids.popleft() for _ in range(n)]
        self.allocated += n
        self.slots_allocated += 1
        row = np.full(self.pages_per_slot, self.scratch_page, dtype=np.int32)
        row[:n] = pages
        self.table[slot] = row
        return slot, pages

    def release(self, slot: int, pages: list[int]) -> None:
        self.table[slot] = self.scratch_page
        self.free_page_ids.extend(pages)
        self.free_slot_ids.append(slot)
        self.freed += len(pages)
        self.slots_freed += 1

    @property
    def free_pages(self) -> int:
        return len(self.free_page_ids)

    @property
    def free_slots(self) -> int:
        return len(self.free_slot_ids)


class PagedRuntime:
    """Continuous-batching decode runtime bound to one ``ServeEngine``.

    Built by :meth:`ServeEngine.start_paged`; the engine's ``admit`` /
    ``decode_tick`` / ``retire`` / ``free_pages`` delegate here.  Holds the
    :class:`PagePool` and the per-slot host decode state.  Decode is greedy
    (the bitwise-oracle contract is argmax per row).  ``max_batch`` may not
    exceed the engine's lane count.
    """

    def __init__(self, engine, max_batch: int, page_size: int,
                 num_pages: int | None = None):
        if max_batch > engine.lanes:
            raise ValueError(f"max_batch={max_batch} exceeds the engine's "
                             f"{engine.lanes} decode lanes")
        self.engine = engine
        self.pool = PagePool(engine.cfg, max_batch, page_size, engine.max_len,
                             num_pages=num_pages, device=engine.device)
        self.slots: dict[int, _Slot] = {}
        self.tick_graph = {"captures": 0, "replays": 0, "eager": 0}
        self.tick_kv = {"paged": 0, "live_slots": 0,
                        "slots": engine.lanes * engine.max_len}
        # the routed-expert counts that ride in the last tick's and
        # admission's copy (the module docstring); None where the model
        # counts none
        self._routed = dropless(engine.cfg)
        self.tick_experts: int | None = None
        self.admit_routes: tuple[int, int] | None = None
        self._bind()

    def _bind(self) -> None:
        """Place the pools for the engine's current mesh slice (``page_pspecs``
        layouts); unmeshed they stay plain tensors on its device.  Drops the
        tick graph, and decides afresh the tick's paths."""
        eng = self.engine
        self._set_paths(eng.mesh is None and eng.device.type == "cuda")
        if eng.mesh is None:
            self._specs = dict.fromkeys(self.pool.pools)
            return
        self._specs = page_pspecs(eng.run_cfg, eng.axes)
        self.pool.pools = reshard_tree(
            pad_caches(self.pool.pools, eng.cfg, eng._m),
            named(eng.mesh, self._specs))

    def _set_paths(self, on_card: bool) -> None:
        """The tick's paths, from what the runtime observes: ``on_card`` (a
        meshless engine on a ``cuda`` device) the tick is graphed and, where
        the model caches ``k`` / ``v``, reads them from the pages in place.
        Drops the tick graph.  (The CPU tests pass True to run those paths
        on their plain versions.)"""
        self._graphed = on_card
        self._kv_in_place = on_card and KV_LEAVES <= self.pool.pools.keys()
        self._graph = None

    def rebind(self) -> None:
        """Re-place the pools after ``ServeEngine.reshard`` (which brings
        them whole to every rank first); in-flight slots keep decoding
        token-identically on the new slice."""
        self._bind()

    # -- in-flight API ------------------------------------------------------

    def admit(self, prompt: np.ndarray, new_tokens: int) -> int | None:
        """Prefill + join the running batch.  Returns the slot id, or None
        when the pool cannot hold the request (caller queues, never drops).

        Reserves every page the request will need up front.  The first
        generated token is the prefill logits' argmax, as the dense
        ``generate`` computes it.
        """
        self.admit_routes = None
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        total = len(prompt) + int(new_tokens)
        if total > self.pool.max_len:
            raise ValueError(f"S0+new_tokens={total} exceeds "
                             f"max_len={self.pool.max_len}")
        if new_tokens < 1:
            raise ValueError("new_tokens must be >= 1")
        if not self.pool.can_admit(total):
            return None
        eng = self.engine
        tr = eng.tracer
        first = None
        if not eng._member:
            slot, pages = self.pool.reserve(total)
        else:
            with eng._ctx():
                with phase_span(tr, "admit.prefill"), \
                        recording_routes() as routes:
                    logits, dense = eng._prefill(
                        torch.from_numpy(prompt[None]).to(eng.device))
                    first = gathered(logits)[0].argmax().reshape(1).to(
                        torch.int32)
                    if self._routed:         # + the distinct experts
                        first = torch.cat([first, distinct_experts(
                            routes, None, eng.cfg.moe.num_experts).view(1)])
                with phase_span(tr, "admit.write"):
                    slot, pages = self.pool.reserve(total)
                    pp, ps = self.pool.pages_per_slot, self.pool.page_size
                    row = torch.from_numpy(self.pool.table[slot]).to(
                        eng.device).long()

                    def write(pool, d, name):
                        d = d[:, 0]                       # (L, ...)
                        if name in STATE_LEAVES:
                            pool[:, slot] = d
                        else:
                            pool[:, row] = d.reshape(d.shape[0], pp, ps,
                                                     *d.shape[2:])

                    for name, pool in self.pool.pools.items():
                        spec = self._specs[name]
                        local_call(lambda p, d: write(p, d, name),
                                   (pool, dense[name]), (spec, spec), None)
        with phase_span(tr, "admit.wait"):
            host = eng._publish(first, (2 if self._routed else 1,),
                                torch.int32).cpu().numpy()  # repro: noqa[host-sync-in-hot-path] the first token's one D2H
        first = int(host[0])
        if self._routed:
            rows = len(prompt) * eng.cfg.moe.top_k * len(routes)
            self.admit_routes = (int(host[1]), rows)
        self.slots[slot] = _Slot(prompt=prompt, new_tokens=int(new_tokens),
                                 pages=pages, tokens=[first])
        return slot

    def active_slots(self) -> list[int]:
        """Slots that still need decode ticks (not yet done)."""
        return sorted(s for s, rec in self.slots.items() if not rec.done)

    def finished_slots(self) -> list[int]:
        """Slots whose generation is complete and awaiting :meth:`retire`."""
        return sorted(s for s, rec in self.slots.items() if rec.done)

    def _lane_inputs(self, active: list[int]) -> torch.Tensor:
        """One host→device copy of the tick's int32 inputs: the lanes' page
        table rows, positions, current tokens and slot ids (scratch lanes:
        the scratch row, position 0, token 0, the scratch slot).  A graphed
        tick fills its fixed buffer, from pinned memory without a wait."""
        lanes, pp = self.engine.lanes, self.pool.pages_per_slot
        g = self._graph_buffers() if self._graphed else None
        host = (np.empty(lanes * (pp + 3), dtype=np.int32) if g is None
                else g.host)
        slot_ids = active + [self.pool.scratch_slot] * (lanes - len(active))
        host[:lanes * pp] = self.pool.table[slot_ids].reshape(-1)
        host[lanes * pp:lanes * (pp + 2)] = 0
        for i, s in enumerate(active):
            rec = self.slots[s]
            host[lanes * pp + i] = rec.write_pos
            host[lanes * (pp + 1) + i] = rec.tokens[-1]
        host[lanes * (pp + 2):] = slot_ids
        if g is None:
            return torch.from_numpy(host).to(self.engine.device)
        g.ints.copy_(g.staging, non_blocking=True)
        return g.ints

    def _pool_ptrs(self) -> tuple:
        return tuple(p.data_ptr() for p in self.pool.pools.values())

    def _graph_buffers(self) -> _TickGraph:
        """The tick graph's fixed buffers; new ones (and a capture to come)
        when there are none yet or the pools have moved."""
        ptrs = self._pool_ptrs()
        if self._graph is None or self._graph.ptrs != ptrs:
            n = self.engine.lanes * (self.pool.pages_per_slot + 3)
            self._graph = _TickGraph(n, self.engine.device, ptrs)
        return self._graph

    def _scratch_inputs(self) -> torch.Tensor:
        """Lane inputs with every lane a scratch lane: the capture's warm-up
        runs read and write the scratch page and slot only."""
        lanes, pp = self.engine.lanes, self.pool.pages_per_slot
        host = np.zeros(lanes * (pp + 3), dtype=np.int32)
        host[:lanes * pp] = self.pool.scratch_page
        host[lanes * (pp + 2):] = self.pool.scratch_slot
        return torch.from_numpy(host).to(self.engine.device)

    def _capture(self, g: _TickGraph) -> None:
        """Warm the tick up on scratch lanes, then capture it over ``g``'s
        fixed buffers into the device's shared pool.  A capture error is
        raised, never taken as a cue to run eagerly."""
        scratch = self._scratch_inputs()
        dev = g.ints.device
        if dev.type != "cuda":
            for _ in range(GRAPH_WARMUP):
                self._tick(scratch)
            return
        # a stream of the engine's device (the graph's default capture
        # stream is made once, on whichever device is current then)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self._tick(scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_graph_pool(dev), stream=side):
            g.toks = self._tick(g.ints)
        g.graph = graph

    def _replay(self, g: _TickGraph) -> torch.Tensor:
        """The graphed tick's device work over its fixed buffers (captured
        first on the runtime's first tick) → the (lanes,) int32 tokens."""
        tr = self.engine.tracer
        if g.toks is None:
            with phase_span(tr, "tick.capture"):
                self._capture(g)
            self.tick_graph["captures"] += 1
        with phase_span(tr, "tick.replay"):
            if g.graph is not None:
                g.graph.replay()
            else:
                g.toks = self._tick(g.ints)
        self.tick_graph["replays"] += 1
        return g.toks

    def _upload_event(self, a_p, ex_p) -> tuple[torch.Tensor, torch.Tensor]:
        """One host→device copy of a staged mapping event."""
        flat = np.concatenate([a_p.ravel(), ex_p.ravel()]).astype(np.float32)
        dev = torch.from_numpy(flat).to(self.engine.device)
        return dev[:a_p.size], dev[a_p.size:].view(ex_p.shape)

    def decode_tick(self, sched=None):
        """One decode step for every active slot: gather pages → dense view
        → ``decode_step`` with per-lane positions → scatter the written
        token → argmax on the device.  Returns {slot: new token}.

        ``sched``: optional ``(avg, exec_times, fabric)``, a mapping event
        for a fused-backend ``MappingFabric``; the tick then also makes that
        decision (the ``fused_decision`` kernel, on the same stream, after
        the decode step) and returns ``(tokens, decision)``, ``decision``
        the fabric's ``map_event`` 5-tuple.  Its outputs share the tokens'
        one device-to-host copy.  A fourth element, the event's number,
        goes on the decision's ``map.*`` spans.
        """
        self.tick_experts = None
        active = self.active_slots()
        if not active:
            return {} if sched is None else ({}, None)
        eng = self.engine
        tr = eng.tracer
        lanes = eng.lanes
        if sched is not None:
            avg, exec_times, fab = sched[:3]
            event = sched[3] if len(sched) > 3 else None
            with phase_span(tr, "map.inputs", event):
                (a_p, ex_p, _, avail, mask,
                 counters, p_valid) = fab.tick_decision_inputs(avg,
                                                               exec_times)
        buf = None
        if eng._member:
            with eng._ctx():
                # Uploads first: a copy from pageable host memory waits for
                # the stream, so it must not queue behind the decode step.
                with phase_span(tr, "tick.upload"):
                    ints = self._lane_inputs(active)
                if sched is not None:
                    with phase_span(tr, "map.inputs", event):
                        a_d, ex_d = self._upload_event(a_p, ex_p)
                if self._graphed:
                    toks = self._replay(self._graph)
                else:
                    toks = self._tick(ints)
                    self.tick_graph["eager"] += 1
                self.tick_kv["paged"] += self._kv_in_place
                self.tick_kv["live_slots"] = sum(
                    self.slots[s].write_pos + 1 for s in active)
                if tr is not None:
                    tr.counter("tick.graph", **self.tick_graph)
                    tr.counter("tick.kv", **self.tick_kv)
                if sched is None:
                    buf = toks
                else:
                    with phase_span(tr, "map.launch", event):
                        res = decision_hw(a_d, ex_d, avail, mask,
                                          out_avail=avail)
                        if counters is not None:
                            valid = (torch.arange(len(a_p), device=eng.device)
                                     < len(avg))
                            accumulate_counters(counters, res.assignment,
                                                res.new_avail, valid, p_valid)
                        # The tick's one device→host copy: tokens and
                        # decision.
                        buf = pack_tick_outputs(toks, res)
        head = lanes + (1 if self._routed else 0)   # tokens (and the count)
        width = head + (0 if sched is None else 4 * len(a_p) + len(avail))
        with phase_span(tr, "tick.wait"):
            host = eng._publish(buf, (width,), torch.int32).cpu().numpy()  # repro: noqa[host-sync-in-hot-path] the tick's one packed D2H
        nxt = host[:lanes]
        if self._routed:
            self.tick_experts = int(host[lanes])
            if tr is not None:
                tr.counter("moe.experts", experts=self.tick_experts)
        decision = None
        if sched is not None:
            with phase_span(tr, "map.commit", event):
                if not eng._member:
                    # adopt the slice's decision: its new registers ride in
                    # the buffer, bit for bit
                    _, assignment, _, _, new = unpack_decision(host[head:],
                                                               len(avail))
                    avail.copy_(torch.from_numpy(new).to(avail.device))
                    if counters is not None:
                        valid = torch.arange(len(a_p), device=avail.device) \
                            < len(avg)
                        accumulate_counters(
                            counters, torch.from_numpy(assignment).to(
                                avail.device), avail, valid, p_valid)
                    res_avail = avail
                else:
                    res_avail = res.new_avail
                decision = fab.commit_tick_decision(len(avg), host[head:],
                                                    res_avail, counters)
        with phase_span(tr, "tick.tokens"):
            out = {}
            for i, s in enumerate(active):
                t = int(nxt[i])
                self.slots[s].tokens.append(t)
                out[s] = t
        return out if sched is None else (out, decision)

    def _tick(self, ints: torch.Tensor) -> torch.Tensor:
        """The decode step of a tick from its uploaded int32 inputs: gather
        pages → dense view → ``decode_step`` with per-lane positions →
        scatter the written token and state rows → the (lanes,) argmax,
        followed by the active lanes' distinct routed experts where the
        model has dropless MoE layers.  With ``k`` / ``v`` read in place
        those two leaves are neither gathered nor scattered: ``decode_step``
        gets their pools and the page table.  The body a tick graph
        captures; run eagerly, its phases are spans."""
        eng = self.engine
        tr = None if self._graphed else eng.tracer
        lanes = eng.lanes
        pp, ps = self.pool.pages_per_slot, self.pool.page_size
        table32 = ints[:lanes * pp].view(lanes, pp)
        table = table32.long()
        pos = ints[lanes * pp:lanes * (pp + 1)]
        tok = ints[lanes * (pp + 1):lanes * (pp + 2)].view(lanes, 1)
        slot_ids = ints[lanes * (pp + 2):].long()
        rows = torch.arange(lanes, device=eng.device)
        page = table[rows, (pos // ps).long()]
        off = (pos % ps).long()
        pools = self.pool.pools
        moved = [name for name in pools
                 if not (self._kv_in_place and name in KV_LEAVES)]

        def gather(pool, name):
            if name in STATE_LEAVES:
                return pool[:, slot_ids]
            return pool[:, table].reshape(pool.shape[0], lanes, pp * ps,
                                          *pool.shape[3:])

        with phase_span(tr, "tick.gather"):
            dense = {name: local_call(lambda p: gather(p, name),
                                      (pools[name],), (self._specs[name],),
                                      self._specs[name]) for name in moved}
            if self._kv_in_place:
                dense.update(k=pools["k"], v=pools["v"])
                dense[PAGES] = PageTable(table32, page * ps + off)
        with phase_span(tr, "tick.step"), recording_routes() as routes:
            logits, dense = eng._decode(dense, tok, pos)
        with phase_span(tr, "tick.scatter"):
            def scatter(pool, d, name):
                if name in STATE_LEAVES:
                    # scratch lanes all write the scratch slot: harmless
                    pool[:, slot_ids] = d
                else:
                    pool[:, page, off] = d[:, rows, pos.long()]

            for name in moved:
                spec = self._specs[name]
                local_call(lambda p, d: scatter(p, d, name),
                           (pools[name], dense[name]), (spec, spec), None)
            toks = gathered(logits).argmax(dim=-1).to(torch.int32)
            if not self._routed:
                return toks
            live = slot_ids != self.pool.scratch_slot
            return torch.cat([toks, distinct_experts(
                routes, live, eng.cfg.moe.num_experts).view(1)])

    def retire(self, slot: int) -> np.ndarray:
        """Free the slot's pages and return the full (S0+new_tokens,) ids."""
        rec = self.slots.pop(slot)
        self.pool.release(slot, rec.pages)
        return np.concatenate([rec.prompt,
                               np.asarray(rec.tokens, dtype=np.int32)])

    # -- pages as the migration / recovery unit -----------------------------

    def snapshot_slot(self, slot: int) -> dict:
        """Host snapshot of ONE request: its pages (page-shaped, not the
        dense cache), its state rows and its decode state.  O(request
        length), not O(pool)."""
        rec = self.slots[slot]
        eng = self.engine
        row = torch.from_numpy(self.pool.table[slot]).long()

        def take(pool, name):
            return (pool[:, slot] if name in STATE_LEAVES
                    else pool[:, row.to(pool.device)])

        src = None if eng.mesh is None else mesh_root(eng.mesh)
        pages = {}
        for name, pool in self.pool.pools.items():
            spec = self._specs[name]
            vals = (local_call(lambda p: take(p, name), (pool,), (spec,),
                               spec) if eng._member
                    else torch.empty((pool.shape[0],
                                      *_take_shape(pool, name, row)),
                                     dtype=pool.dtype, device="meta"))
            whole = unpad_caches(to_plain({name: vals}, eng.device, src=src),
                                 eng.cfg, eng._m)
            pages[name] = whole[name].cpu().numpy()
        return {"pages": pages, "prompt": rec.prompt.copy(),
                "new_tokens": rec.new_tokens, "tokens": list(rec.tokens)}

    def restore_slot(self, snap: dict) -> int | None:
        """Re-admit a :meth:`snapshot_slot` request into THIS pool (same or
        another engine).  Returns the new slot id, or None when the pool
        cannot hold it now (caller queues).  Decoding resumes from the last
        committed token, bitwise as if never moved."""
        total = len(snap["prompt"]) + int(snap["new_tokens"])
        if not self.pool.can_admit(total):
            return None
        slot, pages = self.pool.reserve(total)
        eng = self.engine
        row = torch.from_numpy(self.pool.table[slot]).long().to(eng.device)

        def put(pool, vals, name):
            if name in STATE_LEAVES:
                pool[:, slot] = vals
            else:
                pool[:, row] = vals

        for name, pool in self.pool.pools.items():
            vals = torch.from_numpy(np.ascontiguousarray(
                snap["pages"][name])).to(eng.device)
            spec = self._specs[name]
            if spec is not None:
                vals = reshard_tree(pad_caches({name: vals}, eng.cfg, eng._m),
                                    named(eng.mesh, {name: spec}))[name]
            if eng._member:
                local_call(lambda p, v: put(p, v, name), (pool, vals),
                           (spec, spec), None)
        self.slots[slot] = _Slot(prompt=np.asarray(snap["prompt"],
                                                   dtype=np.int32),
                                 new_tokens=int(snap["new_tokens"]),
                                 pages=pages, tokens=list(snap["tokens"]))
        return slot
