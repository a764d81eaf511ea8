"""MappingFabric — batched, device-resident HEFT_RT dispatch pipeline.

PyTorch counterpart of ``repro.sched_integration.fabric``.  Mapping events
are batched through the card instead of one host round-trip each:

* **Bucketed shapes.**  Ready queues are padded to power-of-two buckets
  (``bucket_size``) and the PE axis to a power-of-two ``p_bucket`` with
  ``+inf`` exec columns, exactly as in the reference.  The CUDA kernels are
  shape-generic, so the buckets no longer bound compiled variants; they keep
  the reference's padding semantics (and the tick-fusion staging contract).
  ``grow`` / ``shrink`` / ``remap`` resize the pool mid-stream, carrying the
  committed ``T_avail`` registers bit-exact.
* **Device-resident availability registers.**  ``T_avail`` is one tensor on
  the device, updated in place by the kernel (the reference donates the
  buffer to its jitted dispatch instead).  ``map_event(avail=..,
  update=False)`` never touches it.
* **Backends.**  ``"numpy"`` is the oracle-exact float64 host path used by
  the discrete-event simulators.  ``"torch"`` is the plain eager version,
  allowed on a CPU device only.  ``"cuda"`` runs the fused kernel
  (:func:`repro_torch.kernels.heft_rt_hw`); ``"fused"`` runs the decision
  kernel with a device-resident PE mask and exposes the registers to the
  paged decode tick (:meth:`MappingFabric.tick_decision_inputs`).  On a CPU
  device ``"cuda"`` and ``"fused"`` run their kernels' plain versions
  (``backend_effective`` says ``"cpu-plain"``); on the card they launch the
  kernels, with no fallback.  ``"auto"`` picks numpy on a CPU device and
  cuda on the card; the ``REPRO_TORCH_FABRIC_BACKEND`` environment variable
  overrides it.
* **One transfer each way per event.**  ``map_event`` uploads the padded
  event in one host→device copy and brings the decision back in one packed
  int32 device→host copy (:func:`repro_torch.kernels.pack_tick_outputs`).

Decision fidelity: every backend decides slot-for-slot like the
:func:`repro_torch.core.heft_rt_numpy` oracle provided exec/avg values are
exactly representable in float32 for the device backends (the numpy backend
is exact in float64).  Exec times lie in ``[0, +inf]``; an all-``inf`` row
marks a task no PE supports (assignment -1).  NaN ``avg`` entries sort
behind every finite key and ahead of padding slots.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.heft_rt import ScheduleResult, heft_rt
from repro_torch.kernels import (decision_hw, heft_rt_hw, pack_tick_outputs,
                                 unpack_decision)
from repro_torch.obs.device import (
    COUNTER_NAMES,
    NUM_COUNTERS,
    accumulate_counters,
    accumulate_counters_np,
    counters_dict,
    zero_counters,
)

_INF = float("inf")

BACKENDS = ("numpy", "torch", "cuda", "fused")
ENV_BACKEND = "REPRO_TORCH_FABRIC_BACKEND"


def _env_backend() -> str | None:
    """Validated ``REPRO_TORCH_FABRIC_BACKEND`` value, or None when unset."""
    env = os.environ.get(ENV_BACKEND, "").strip().lower()
    if env and env not in BACKENDS:
        raise ValueError(f"{ENV_BACKEND} must be one of {BACKENDS}, got {env!r}")
    return env or None


def default_backend(device: torch.device) -> str:
    """Resolve ``backend="auto"``: the env knob wins; otherwise numpy on a
    CPU device and the fused kernel (``cuda``) on the card."""
    env = _env_backend()
    if env:
        return env
    return "numpy" if device.type == "cpu" else "cuda"


def pow2_bucket(n: int, min_bucket: int = 1) -> int:
    """Next power of two ≥ ``max(n, min_bucket, 1)``.

    The reference's one bucketing idiom: the fabric's ready-queue/PE
    padding (:meth:`MappingFabric.bucket_size`) and the paged serve
    runtime's active-lane padding share it.
    """
    b = max(int(n), int(min_bucket), 1)
    return 1 << (b - 1).bit_length()


# ---------------------------------------------------------------------------
# Vectorized roofline front-end
# ---------------------------------------------------------------------------

def service_time_matrix(requests, replicas, *, active_params: float) -> np.ndarray:
    """Full (N, P) roofline exec-time matrix in one vectorized op.

    Bitwise-identical to looping ``service_time_s`` over (request, replica)
    pairs: prefill is compute-bound, decode is weight-streaming-bound, and
    the elementwise float64 operations associate exactly as the scalar code.
    """
    prefill = np.array([r.prefill_tokens for r in requests], dtype=np.float64)
    decode = np.array([r.decode_tokens for r in requests], dtype=np.float64)
    compute = np.array([r.compute_tflops for r in replicas], dtype=np.float64) * 1e12
    hbm = np.array([r.hbm_gbps for r in replicas], dtype=np.float64) * 1e9
    with np.errstate(divide="ignore"):
        return ((2.0 * active_params * prefill)[:, None] / compute[None, :]
                + (2.0 * active_params * decode)[:, None] / hbm[None, :])


# ---------------------------------------------------------------------------
# Oracle-exact numpy fast paths (the host side of the fabric)
# ---------------------------------------------------------------------------

def _priority_order_np(avg) -> np.ndarray:
    """Stable descending argsort, exactly as ``heft_rt_numpy`` computes it."""
    key = np.asarray(avg, dtype=np.float64)
    return np.argsort(-key, kind="stable")


def _eft_chain(rows, av):
    """The sequential EFT argmin recurrence over plain Python floats.

    ``rows``: exec times in priority order (list of lists), ``av``: the
    availability registers (mutated in place).  For the handful-of-PEs
    regime the per-step cost of the numpy version is dispatch overhead, so
    the chain runs scalar (same IEEE float64 operations, same first-minimum
    tie-break as ``np.argmin``) — bit-identical decisions.  The single
    implementation shared by :func:`heft_rt_fast` and
    :meth:`MappingFabric.assign`.
    """
    P = len(av)
    assignment, start, finish = [], [], []
    for row in rows:
        best_pe = 0
        best = av[0] + row[0]
        for p in range(1, P):
            f = av[p] + row[p]
            if f < best:
                best, best_pe = f, p
        if best < _INF:  # NaN and +inf both fail this, like np.isfinite
            assignment.append(best_pe)
            start.append(av[best_pe])
            finish.append(best)
            av[best_pe] = best
        else:
            assignment.append(-1)
            start.append(_INF)
            finish.append(_INF)
    return assignment, start, finish


def heft_rt_fast(avg, exec_times, avail):
    """Drop-in twin of :func:`repro_torch.core.heft_rt_numpy`, ~5x faster at small P."""
    ex = np.asarray(exec_times, dtype=np.float64)
    order = _priority_order_np(avg)
    av = np.asarray(avail, dtype=np.float64).tolist()
    assignment, start, finish = _eft_chain(ex[order].tolist(), av)
    return (order, np.array(assignment, dtype=np.int64),
            np.array(start), np.array(finish), np.array(av))


def eft_dispatch_numpy(avg, exec_times, avail, capacity):
    """Early-exit HEFT_RT commit: the runtime simulator's dispatch contract.

    Follows the full priority order + EFT availability chain but only
    *commits* tasks to PEs with free worker-queue capacity, stopping once no
    capacity remains.  Prefix-identical to running :func:`heft_rt_fast` /
    ``heft_rt_numpy`` in full and committing, per PE, the first
    ``capacity[pe]`` tasks assigned to it.
    """
    ex = np.asarray(exec_times, dtype=np.float64)
    order = _priority_order_np(avg)
    av = [float(a) for a in np.asarray(avail, dtype=np.float64)]
    P = len(av)
    cap = [int(c) for c in capacity]
    remaining = sum(cap)
    out: list[tuple[int, int]] = []
    for t in order:
        if remaining == 0:
            break
        row = ex[t].tolist()
        best_pe = 0
        best = av[0] + row[0]
        for p in range(1, P):
            f = av[p] + row[p]
            if f < best:
                best, best_pe = f, p
        if not (best < _INF):
            continue
        av[best_pe] = best
        if cap[best_pe] > 0:
            out.append((int(t), best_pe))
            cap[best_pe] -= 1
            remaining -= 1
    return out


# ---------------------------------------------------------------------------
# The fabric
# ---------------------------------------------------------------------------

class MappingFabric:
    """Persistent HEFT_RT dispatch pipeline with bucketed shapes and
    device-resident availability registers.

    The P axis is *state*: :meth:`grow` / :meth:`shrink` / :meth:`remap`
    resize or relabel the PE pool mid-stream while carrying the committed
    ``T_avail`` registers across the resize.  Device backends pad P to a
    power-of-two bucket with ``+inf`` exec columns.

    Parameters
    ----------
    num_pes:
        Initial number of PEs / replicas (the variable P axis).
    backend:
        ``"numpy"``, ``"torch"`` (CPU device only), ``"cuda"``, ``"fused"``
        or ``"auto"`` (see the module docstring).
    device:
        Where the registers live and the decisions run.  ``None`` means the
        CUDA card and raises without one; pass ``"cpu"`` for the plain path.
    min_bucket / max_bucket:
        Ready queues are padded to the next power of two in
        ``[min_bucket, max_bucket]``; exceeding ``max_bucket`` raises.
    min_pe_bucket:
        Smallest P bucket for the device backends.
    avail:
        Initial availability registers (default zeros).
    tracer / metrics:
        Optional :class:`repro_torch.obs.Tracer` / :class:`repro_torch.obs.
        MetricsRegistry`.  When attached, every ``map_event``/``map_batch``
        records a span plus backend/bucket-labelled latency histograms
        ("fabric.event_s" per event, "fabric.decision_s" per decision), and
        resizes emit instant events.  When ``None`` the dispatch path does
        no observability work.
    device_counters:
        Accumulate scheduler counters (see :mod:`repro_torch.obs.device`) in
        a register tensor on the device, in the same stream as the
        decision; :meth:`drain_counters` reads them on demand.
    """

    def __init__(self, num_pes: int, *, backend: str = "auto", device=None,
                 min_bucket: int = 8, max_bucket: int = 1 << 16,
                 min_pe_bucket: int = 4, avail=None,
                 tracer=None, metrics=None, device_counters: bool = False):
        self.device = resolve_device(device)
        if backend == "auto":
            backend = default_backend(self.device)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"device must be cpu or cuda, got {self.device}")
        if backend == "torch" and self.device.type != "cpu":
            raise ValueError(
                "the plain 'torch' backend runs on a CPU device only; the "
                "card runs the 'cuda' or 'fused' kernels")
        self.num_pes = int(num_pes)
        self.backend = backend
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.min_pe_bucket = int(min_pe_bucket)
        self._events = 0
        self._resizes = 0
        self._tracer = tracer
        self._metrics = metrics
        self._device_counters = bool(device_counters)
        self._counters = None            # device registers / host accumulator
        self._avail = None               # T_avail registers
        self._p_valid = None             # real-lane mask at the P bucket
        self._pe_mask = None             # chaos-tier unreachable-lane mask
        self._mask_dev = None            # fused backend: device mask register
        self._stage_cache = {}           # fused tick staging buffer reuse
        if self._device_counters:
            self._counters = (np.zeros(NUM_COUNTERS) if backend == "numpy"
                              else zero_counters(self.device))
        self.reset(avail)

    @classmethod
    def from_reference_state(cls, state: dict, *, backend: str = "auto",
                             device=None, tracer=None, metrics=None):
        """A port fabric that continues a reference fabric's event stream.

        ``state`` holds the reference ``MappingFabric``'s registers as host
        values: ``avail`` (its ``avail`` property), ``pe_mask`` (bool
        (num_pes,) or None), ``counters`` (``drain_counters(reset=False)``,
        or None when it has none), ``num_pes``, ``min_bucket``,
        ``min_pe_bucket`` and ``max_bucket``.  Registers load bit-exact, so
        the next events decide as the reference would have.
        """
        counters = state.get("counters")
        fab = cls(int(state["num_pes"]), backend=backend, device=device,
                  min_bucket=int(state["min_bucket"]),
                  max_bucket=int(state["max_bucket"]),
                  min_pe_bucket=int(state["min_pe_bucket"]),
                  avail=np.asarray(state["avail"]), tracer=tracer,
                  metrics=metrics, device_counters=counters is not None)
        if state.get("pe_mask") is not None:
            fab.set_pe_mask(state["pe_mask"])
        if counters is not None:
            values = np.array([counters[name] for name in COUNTER_NAMES])
            if fab.backend == "numpy":
                fab._counters[:] = values
            else:
                fab._counters.copy_(torch.from_numpy(values))
        return fab

    @property
    def backend_effective(self) -> str:
        """The path that actually runs: ``"numpy"``; ``"cpu-plain"`` for a
        device backend on a CPU device (the kernels' plain versions); else
        ``"cuda"`` or ``"fused"`` (the kernels on the card)."""
        if self.backend == "numpy":
            return "numpy"
        if self.device.type == "cpu":
            return "cpu-plain"
        return self.backend

    # -- availability registers ---------------------------------------------

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device)

    def reset(self, avail=None) -> None:
        """(Re)load the T_avail registers (host values → device residency).

        Within one P bucket the resident tensor is overwritten in place."""
        a = (np.zeros(self.num_pes) if avail is None
             else np.asarray(avail, dtype=np.float64))
        if a.shape != (self.num_pes,):
            raise ValueError(f"avail must have shape ({self.num_pes},)")
        if self.backend == "numpy":
            self._avail = a.copy()
            return
        # Padded lanes carry +inf exec columns in every event, so they are
        # never selected and their register values are inert.
        padded = torch.from_numpy(self._pad_avail(a))
        if self._avail is not None and self._avail.shape == padded.shape:
            self._avail.copy_(padded)
        else:
            self._avail = padded.to(self.device)
        # Real-lane mask for the counters' T_avail-spread lane.
        self._p_valid = self._to_device(np.arange(self.p_bucket) < self.num_pes)
        if self.backend == "fused":
            # The PE mask is a device register too (padded lanes False —
            # their exec columns are already +inf).
            self._mask_dev = self._to_device(self._pad_mask())

    def _pad_mask(self) -> np.ndarray:
        m = np.zeros(self.p_bucket, dtype=bool)
        if self._pe_mask is not None:
            m[: self.num_pes] = self._pe_mask
        return m

    def _pad_avail(self, a) -> np.ndarray:
        pad = np.zeros(self.p_bucket, dtype=np.float32)
        pad[: self.num_pes] = a
        return pad

    @property
    def avail(self) -> np.ndarray:
        """Current availability registers as host values (logical P only)."""
        if self.backend == "numpy":
            return self._avail[: self.num_pes]
        # a copy: the live registers keep changing in place
        return np.array(self._avail.cpu())[: self.num_pes]

    @property
    def events(self) -> int:
        """Mapping events dispatched through this fabric (single + batched)."""
        return self._events

    @property
    def resizes(self) -> int:
        """Resize events (grow/shrink/remap/resize) applied to the PE pool."""
        return self._resizes

    # -- observability -------------------------------------------------------

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Attach (or replace) the tracer / metrics registry after
        construction."""
        if tracer is not None:
            self._tracer = tracer
        if metrics is not None:
            self._metrics = metrics

    def drain_counters(self, *, reset: bool = True) -> dict[str, float]:
        """Read the scheduler counters (one host transfer).  ``reset``
        zeroes the registers for the next window.  Requires
        ``device_counters=True``."""
        if not self._device_counters:
            raise ValueError(
                "fabric was built without device_counters=True")
        if self.backend == "numpy":
            out = counters_dict(self._counters)
            if reset:
                self._counters[:] = 0.0
        else:
            out = counters_dict(self._counters.cpu().numpy())
            if reset:
                self._counters.zero_()
        return out

    @staticmethod
    def _pow2_label(n: int) -> int:
        """Power-of-two ceiling for histogram bucket labels (the numpy
        backend has no shape buckets)."""
        return 1 << (max(int(n), 1) - 1).bit_length()

    def _note_dispatch(self, kind: str, t0: float, dt: float,
                       n: int, bucket: int) -> None:
        """Record one dispatch's latency into the attached tracer/metrics
        (called only when one is attached)."""
        if self._metrics is not None:
            self._metrics.histogram(
                "fabric.event_s", backend=self.backend,
                bucket=bucket).record(dt)
            if n > 0:
                # the paper's per-decision scheduling latency: one measured
                # event amortized over its decisions
                self._metrics.histogram(
                    "fabric.decision_s", backend=self.backend).record(
                        dt / n, n=n)
        if self._tracer is not None:
            self._tracer.complete(f"fabric.{kind}", t0, dt, n=n,
                                  bucket=bucket, backend=self.backend)

    # -- variable-P resize events -------------------------------------------

    def grow(self, new_p: int, *, avail: float = 0.0) -> None:
        """Extend the PE pool to ``new_p`` lanes; joiners start at ``avail``.
        Existing registers are carried bit-exact."""
        new_p = int(new_p)
        if new_p < self.num_pes:
            raise ValueError(
                f"grow target {new_p} < current num_pes={self.num_pes} "
                f"(use shrink(keep_idx) to drop PEs)")
        joined = np.full(new_p - self.num_pes, float(avail))
        self._set_registers(np.concatenate([self.avail, joined]), new_p)

    def shrink(self, keep_idx) -> None:
        """Drop PEs, keeping (and reordering to) ``keep_idx``; the survivors'
        committed availability is carried bit-exact."""
        keep = np.asarray(keep_idx, dtype=np.int64)
        if keep.ndim != 1 or len(keep) == 0:
            raise ValueError("keep_idx must be a non-empty 1-D index list")
        if len(np.unique(keep)) != len(keep):
            raise ValueError(f"keep_idx has duplicates: {keep.tolist()}")
        if keep.min() < 0 or keep.max() >= self.num_pes:
            raise ValueError(
                f"keep_idx {keep.tolist()} out of range for num_pes="
                f"{self.num_pes}")
        self._set_registers(self.avail[keep], len(keep))

    def remap(self, old_to_new) -> None:
        """Relabel PEs: register at old index ``i`` moves to
        ``old_to_new[i]`` (a permutation of ``range(num_pes)``)."""
        perm = np.asarray(old_to_new, dtype=np.int64)
        if (perm.shape != (self.num_pes,)
                or not np.array_equal(np.sort(perm), np.arange(self.num_pes))):
            raise ValueError(
                f"old_to_new must be a permutation of range({self.num_pes}), "
                f"got {perm.tolist()}")
        new = np.empty(self.num_pes, dtype=np.float64)
        new[perm] = self.avail
        self._set_registers(new, self.num_pes)

    def resize(self, new_p: int) -> None:
        """Grow to ``new_p`` (joiners at 0) or shrink keeping the first
        ``new_p`` lanes — the policy-facing P change."""
        if new_p > self.num_pes:
            self.grow(new_p)
        elif new_p < self.num_pes:
            self.shrink(np.arange(new_p))

    def set_pe_mask(self, mask) -> None:
        """Mask PE lanes out of dispatch (the chaos tier's partition mask).

        ``mask`` is a ``(num_pes,)`` bool array — ``True`` lanes' exec
        columns dispatch as ``+inf`` while their committed ``T_avail``
        registers stay resident; ``None`` clears the mask.  Resizes clear
        the mask (lane indices change meaning).
        """
        if mask is None:
            self._pe_mask = None
        else:
            m = np.asarray(mask, dtype=bool)
            if m.shape != (self.num_pes,):
                raise ValueError(
                    f"pe mask must have shape ({self.num_pes},), got {m.shape}")
            self._pe_mask = m
        if self.backend == "fused":
            self._mask_dev.copy_(torch.from_numpy(self._pad_mask()))

    def _masked(self, exec_times):
        """Apply the PE mask (+inf columns) on the host; the unmasked path
        returns the input untouched.  The fused backend never host-masks:
        its mask register is applied inside the kernel."""
        if self._pe_mask is None or self.backend == "fused":
            return exec_times
        ex = np.array(exec_times, copy=True)
        ex[..., self._pe_mask] = _INF
        return ex

    def _set_registers(self, host_avail, new_p: int) -> None:
        old_p = self.num_pes
        self.num_pes = int(new_p)
        self._resizes += 1
        self._pe_mask = None
        self.reset(host_avail)
        if self._metrics is not None:
            self._metrics.counter("fabric.resizes").inc()
            self._metrics.gauge("fabric.num_pes").set(self.num_pes)
        if self._tracer is not None:
            self._tracer.instant("fabric.resize", old_p=old_p,
                                 new_p=self.num_pes,
                                 p_bucket=self.p_bucket)

    # -- bucketing -----------------------------------------------------------

    def bucket_size(self, n: int) -> int:
        """Next power-of-two bucket ≥ max(n, min_bucket)."""
        b = pow2_bucket(n, self.min_bucket)
        if b > self.max_bucket:
            raise ValueError(f"queue length {n} exceeds max_bucket={self.max_bucket}")
        return b

    @property
    def p_bucket(self) -> int:
        """Power-of-two P bucket the device backends pad the PE axis to."""
        return pow2_bucket(self.num_pes, self.min_pe_bucket)

    def _check_p(self, exec_times) -> None:
        if exec_times.shape[-1] != self.num_pes:
            raise ValueError(
                f"exec_times has {exec_times.shape[-1]} PE columns but the "
                f"fabric's pool is num_pes={self.num_pes} — resize the "
                f"fabric (grow/shrink) before dispatching")

    def _pad_event(self, avg, exec_times):
        """Pad one event to its buckets: sanitized keys, +inf exec (both for
        padded queue slots and padded PE lanes), valid mask."""
        n, P = exec_times.shape
        D = self.bucket_size(n)
        # NaN keys (nanmean of an all-inf row) must sort behind every finite
        # key but ahead of padding; mapping them to -inf keeps that order
        # because the stable sort breaks the tie by slot index (< n).
        a = np.full(D, -_INF, dtype=np.float32)
        a[:n] = np.where(np.isnan(avg), -_INF, np.asarray(avg, dtype=np.float32))
        # Padded PE lanes carry +inf exec: a padded lane never beats a real
        # lane (finite beats inf, and an all-inf row resolves to the first,
        # real, lane, which the finite guard maps to assignment -1).
        ex = np.full((D, self.p_bucket), _INF, dtype=np.float32)
        ex[:n, :P] = exec_times
        valid = np.arange(D) < n
        return a, ex, valid

    # -- dispatch --------------------------------------------------------------

    def _upload(self, *host_parts):
        """One host→device copy of several f32 arrays; returns device views
        shaped like the parts."""
        flat = np.concatenate([np.ravel(p) for p in host_parts]).astype(
            np.float32, copy=False)
        dev = self._to_device(flat)
        views, off = [], 0
        for p in host_parts:
            views.append(dev[off:off + p.size].view(p.shape))
            off += p.size
        return views

    def _needs_valid(self) -> bool:
        """Only the counters and the plain backend read the slot mask (the
        kernels see padding as -inf keys and +inf exec rows)."""
        return self._device_counters or self.backend == "torch"

    def _valid(self, rows: int, n: int, cols: int, d: int) -> torch.Tensor:
        """bool[rows, cols] real-slot mask built on the device."""
        r = torch.arange(rows, device=self.device) < n
        c = torch.arange(cols, device=self.device) < d
        return r[:, None] & c[None, :]

    def _decide(self, a_p, ex_p, av_in, valid, out_avail) -> ScheduleResult:
        """Run one (or a batch of) padded events on the configured backend,
        new registers into ``out_avail``, then fold the counters."""
        if self.backend == "fused":
            res = decision_hw(a_p, ex_p, av_in, self._mask_dev,
                              out_avail=out_avail)
        elif self.backend == "cuda":
            res = heft_rt_hw(a_p, ex_p, av_in, out_avail=out_avail)
        else:   # "torch": the plain version, CPU only
            res = heft_rt(a_p, ex_p, av_in, valid)
            out_avail.copy_(res.new_avail)
            res = res._replace(new_avail=out_avail)
        if self._device_counters:
            accumulate_counters(self._counters, res.assignment,
                                res.new_avail, valid, self._p_valid)
        return res

    # -- mapping events ------------------------------------------------------

    def map_event(self, avg, exec_times, avail=None, *, update: bool | None = None):
        """One HEFT_RT mapping event.

        ``avail=None`` uses (and by default updates) the fabric's resident
        availability registers; passing ``avail`` explicitly leaves the
        registers untouched unless ``update=True``.

        Returns ``(order, assignment, start, finish, new_avail)`` as host
        arrays trimmed to the real queue length — the ``heft_rt_numpy``
        contract, in priority order.
        """
        exec_times = self._masked(np.asarray(exec_times))
        avg = np.asarray(avg)
        self._check_p(exec_times)
        n = exec_times.shape[0]
        use_resident = avail is None
        if update is None:
            update = use_resident
        self._events += 1
        obs_on = self._metrics is not None or self._tracer is not None
        t0 = time.perf_counter() if obs_on else 0.0
        if self.backend == "numpy":
            av_in = self._avail if use_resident else np.asarray(avail)
            out = heft_rt_fast(avg, exec_times, av_in)
            if update:
                self._avail = out[4].copy()
            if self._device_counters:
                accumulate_counters_np(self._counters, out[1], out[4])
            if obs_on:
                self._note_dispatch("map_event", t0,
                                    time.perf_counter() - t0, n,
                                    self._pow2_label(n))
            return out
        a_p, ex_p, _ = self._pad_event(avg, exec_times)
        D = len(a_p)
        if use_resident:
            a_d, ex_d = self._upload(a_p, ex_p)
            av_in = self._avail
            # The resident registers are updated in place by the kernel, or
            # left alone: then the new registers go to a fresh tensor.
            out_avail = self._avail if update else torch.empty_like(av_in)
        else:
            a_d, ex_d, av_in = self._upload(
                a_p, ex_p, self._pad_avail(np.asarray(avail, dtype=np.float64)))
            out_avail = self._avail if update else av_in
        valid = self._valid(1, 1, D, n)[0] if self._needs_valid() else None
        res = self._decide(a_d, ex_d, av_in, valid, out_avail)
        # One device→host copy for the whole decision.
        no_tokens = torch.empty(0, dtype=torch.int32, device=self.device)
        buf = pack_tick_outputs(no_tokens, res).cpu().numpy()  # repro: noqa[host-sync-in-hot-path] the event's one packed D2H
        order, assignment, start, finish, new_avail = unpack_decision(
            buf, self.p_bucket)
        out = (order[:n], assignment[:n], start[:n], finish[:n],
               new_avail[: self.num_pes])
        if obs_on:
            self._note_dispatch("map_event", t0, time.perf_counter() - t0,
                                n, D)
        return out

    def map_batch(self, avg, exec_times, avail) -> ScheduleResult:
        """Batched mapping events: one device dispatch for B independent
        ready queues (the fabric-batched pipeline).

        ``avg``: (B, D), ``exec_times``: (B, D, P), ``avail``: (B, P).
        Returns a device-resident :class:`ScheduleResult` with leading batch
        dimension, trimmed to the input D.  The resident registers are not
        touched.  With the numpy backend this loops the host oracle.
        """
        avg = np.asarray(avg)
        exec_times = self._masked(np.asarray(exec_times))
        avail_np = np.asarray(avail)
        self._check_p(exec_times)
        B, D = avg.shape
        self._events += B
        obs_on = self._metrics is not None or self._tracer is not None
        t0 = time.perf_counter() if obs_on else 0.0
        if self.backend == "numpy":
            outs = [heft_rt_fast(avg[i], exec_times[i], avail_np[i])
                    for i in range(B)]
            out = ScheduleResult(*(np.stack(cols) for cols in zip(*outs)))
            if self._device_counters:
                accumulate_counters_np(self._counters, out.assignment,
                                       out.new_avail)
            if obs_on:
                self._note_dispatch("map_batch", t0,
                                    time.perf_counter() - t0, B * D,
                                    self._pow2_label(D))
            return out
        Db = self.bucket_size(D)
        Bb = self.bucket_size(B)
        Pb = self.p_bucket
        a_p = np.full((Bb, Db), -_INF, dtype=np.float32)
        a_p[:B, :D] = np.where(np.isnan(avg), -_INF, avg)
        ex_p = np.full((Bb, Db, Pb), _INF, dtype=np.float32)
        ex_p[:B, :D, : self.num_pes] = exec_times
        av_p = np.zeros((Bb, Pb), dtype=np.float32)
        av_p[:B, : self.num_pes] = avail_np
        a_d, ex_d, av_d = self._upload(a_p, ex_p, av_p)
        valid = self._valid(Bb, B, Db, D) if self._needs_valid() else None
        res = self._decide(a_d, ex_d, av_d, valid, av_d)
        out = ScheduleResult(res.order[:B, :D], res.assignment[:B, :D],
                             res.start_time[:B, :D], res.finish_time[:B, :D],
                             res.new_avail[:B, : self.num_pes])
        if obs_on:
            self._note_dispatch("map_batch", t0, time.perf_counter() - t0,
                                B * D, Db)
        return out

    # -- consumer-facing contracts ------------------------------------------

    def assign(self, exec_times, avail) -> np.ndarray:
        """Serving-policy contract: ready-order replica assignment (n,).

        ``avg`` is the mean exec time across replicas (the serving
        scheduler's Avg_TID).  (The key must be the *mean*, not the row sum:
        distinct sums can collide into one mean, so tie sets would differ
        from the oracle's.  ``sum/P`` is bitwise ``np.mean`` — same pairwise
        sum, same divide.)
        """
        exec_times = self._masked(np.asarray(exec_times))
        self._check_p(exec_times)
        n, P = exec_times.shape
        if self.backend == "numpy":
            ex = np.asarray(exec_times, dtype=np.float64)
            self._events += 1
            obs_on = self._metrics is not None or self._tracer is not None
            t0 = time.perf_counter() if obs_on else 0.0
            order = np.argsort(-(ex.sum(axis=1) / P), kind="stable")
            av = np.asarray(avail, dtype=np.float64).tolist()
            assignment, _, _ = _eft_chain(ex[order].tolist(), av)
            if self._device_counters:
                accumulate_counters_np(self._counters,
                                       np.asarray(assignment),
                                       np.asarray(av))
            if obs_on:
                self._note_dispatch("assign", t0, time.perf_counter() - t0,
                                    n, self._pow2_label(n))
        else:
            order, assignment, _, _, _ = self.map_event(
                exec_times=exec_times, avg=exec_times.mean(axis=1),
                avail=avail, update=False)
        out = np.empty(n, dtype=np.int64)
        out[order] = assignment
        return out

    def dispatch(self, avg, exec_times, avail, capacity) -> list[tuple[int, int]]:
        """Runtime-simulator contract: early-exit capacity-limited commit.

        Identical decisions to :func:`eft_dispatch_numpy`: the device
        backends run the full mapping event and commit, per PE, the first
        ``capacity[pe]`` tasks in priority order until total capacity is
        exhausted.
        """
        if self.backend == "numpy":
            return eft_dispatch_numpy(avg, self._masked(np.asarray(exec_times)),
                                      avail, capacity)
        order, assignment, _, _, _ = self.map_event(avg, exec_times, avail,
                                                    update=False)
        cap = [int(c) for c in capacity]
        remaining = sum(cap)
        out: list[tuple[int, int]] = []
        for qid, pe in zip(order, assignment):
            if remaining == 0:
                break
            if pe >= 0 and cap[pe] > 0:
                out.append((int(qid), int(pe)))
                cap[pe] -= 1
                remaining -= 1
        return out

    # -- fused-tick register sharing ----------------------------------------
    #
    # The paged decode tick runs the HEFT_RT decision as part of its own
    # step; these two methods are the fabric's side of that contract.  The
    # device registers (T_avail, PE mask, counter file) stay owned by the
    # fabric: the tick borrows them for one dispatch and hands the results
    # back, so resize, set_pe_mask and drain_counters keep working unchanged
    # while decisions ride the tick.

    def tick_decision_inputs(self, avg, exec_times):
        """Stage one mapping event for a fused decode tick.

        Pads ``(avg, exec_times)`` to this fabric's buckets and returns
        ``(a_p, ex_p, valid, avail, mask, counters, p_valid)`` — the padded
        host operands plus the live device registers for the tick to
        consume.  The tick may write ``avail`` (and ``counters``) in place;
        the caller follows up with :meth:`commit_tick_decision` on the
        tick's outputs before the next dispatch.  ``counters``/``p_valid``
        are ``None`` when the fabric was built without
        ``device_counters``.  Fused backend only.
        """
        if self.backend != "fused":
            raise ValueError(
                f"tick fusion requires backend='fused', got {self.backend!r}")
        avg = np.asarray(avg)
        exec_times = np.asarray(exec_times)
        self._check_p(exec_times)
        n, P = exec_times.shape
        D = self.bucket_size(n)
        # Steady-state fast path: the padded staging buffers are reused
        # across ticks; only the live region changes between events of the
        # same shape (the padding was written once by _pad_event).
        cached = self._stage_cache.get((D, self.p_bucket))
        if cached is None or cached[3] != (n, P):
            a_p, ex_p, valid = self._pad_event(avg, exec_times)
            self._stage_cache[(D, self.p_bucket)] = [a_p, ex_p, valid, (n, P)]
        else:
            a_p, ex_p, valid, _ = cached
            a_p[:n] = np.where(np.isnan(avg),
                               -_INF, np.asarray(avg, dtype=np.float32))
            ex_p[:n, :P] = exec_times
        counted = self._device_counters
        return (a_p, ex_p, valid, self._avail, self._mask_dev,
                self._counters if counted else None,
                self._p_valid if counted else None)

    def commit_tick_decision(self, n: int, buf, new_avail, counters=None):
        """Adopt a fused tick's decision outputs back into the fabric.

        ``buf`` is the *host* copy of the tick's packed decision lanes —
        :func:`repro_torch.kernels.pack_tick_outputs`' layout with the token
        prefix already sliced off (``order | assignment | start | finish |
        new_avail`` as raw int32, float lanes bitcast).  ``new_avail`` is
        the tick's register output on the device; it is copied into the
        resident register tensor unless it is that tensor already.
        ``counters``, when given, likewise.  Returns the host-trimmed
        ``(order, assignment, start, finish, new_avail)`` tuple — the
        :meth:`map_event` contract for the ``n`` real queue slots.
        """
        if self.backend != "fused":
            raise ValueError(
                f"tick fusion requires backend='fused', got {self.backend!r}")
        self._events += 1
        if new_avail.data_ptr() != self._avail.data_ptr():
            self._avail.copy_(new_avail)
        if counters is not None and counters.data_ptr() != self._counters.data_ptr():
            self._counters.copy_(counters)
        order, assignment, start, finish, avail = unpack_decision(
            buf, self.p_bucket)
        return (order[:n], assignment[:n], start[:n], finish[:n],
                avail[: self.num_pes])


def make_policy_fabric(backend: str | None = None, *, device=None,
                       tracer=None, metrics=None,
                       device_counters: bool = False):
    """Serving-policy factory backed by a :class:`MappingFabric`.

    The returned policy matches ``policy_heft_rt`` decision-for-decision;
    the fabric is created lazily so one factory works for any fleet size,
    and a fleet-size change mid-stream resizes the live fabric instead of
    rebuilding it.  ``backend=None`` honours ``REPRO_TORCH_FABRIC_BACKEND``
    and is ``"auto"`` otherwise, as :func:`repro_torch.runtime.
    make_dispatch_fabric`: the ``cuda`` kernel on the card (``device=None``
    means the card, and the first mapping event raises without one), the
    float64 numpy host path with ``device="cpu"``.  The fabric is reachable
    afterwards via the policy's ``fabric()`` attribute (None until the first
    mapping event).

    Fidelity caveat: the numpy backend is bit-identical to
    ``policy_heft_rt`` for any float64 inputs; the device backends compute
    in float32, so on the card the policy matches the float32 plain path
    (the ``torch`` backend with ``device="cpu"``) bitwise, and the float64
    oracle only where the service times and registers are exact in f32.
    """
    if backend is None:
        backend = _env_backend() or "auto"
    fab: MappingFabric | None = None

    def policy(exec_times, avail):
        nonlocal fab
        if fab is None:
            fab = MappingFabric(exec_times.shape[1], backend=backend,
                                device=device, tracer=tracer,
                                metrics=metrics,
                                device_counters=device_counters)
        elif fab.num_pes != exec_times.shape[1]:
            # registers are irrelevant here (the policy passes avail
            # explicitly), so the prefix-keeping resize is safe
            fab.resize(exec_times.shape[1])
        return fab.assign(exec_times, avail)

    policy.fabric = lambda: fab
    return policy
