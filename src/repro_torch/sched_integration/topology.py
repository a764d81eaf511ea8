"""Inter-pod network topology: links, contention, and failure domains.

The serving simulator treated every byte move as free — migrations landed
instantly and replicas never contended for wire.  Real fleets are a *graph*:
pods hang off links with finite bandwidth and latency, concurrent transfers
(a replica migration and a gradient collective crossing the same spine link)
contend for the same wire, and links degrade or partition outright.  The
YAFS discrete-event exemplar (SNIPPETS.md §3) models exactly this —
topology + link metrics + ``node_up``/``node_down`` events — and this module
is our deterministic, simulator-grade port of that idea:

* :class:`Topology` — an undirected link graph over named pods.  Each link
  carries bandwidth (GB/s), latency, a FIFO *reservation horizon* (the
  contention model: a transfer occupies every link on its path until it
  finishes, so a second flow sharing a link queues behind the first), a
  degrade factor, a background-utilization fraction (steady collective
  traffic stealing wire), and a down-window (partition).
* :meth:`Topology.transfer_s` — topology-derived time for moving ``nbytes``
  between pods: shortest-hop path, start at the max of the caller's clock
  and every path link's horizon (and past any down-window), duration =
  path latency + bytes over the path's narrowest *effective* bandwidth.
  ``reserve=True`` commits the flow to the links, which is what makes two
  concurrent migrations serialize instead of magically overlapping.
* :meth:`Topology.collective_s` — a ring collective over a pod set: every
  ring hop reserves its pairwise path, so a collective crossing a link a
  migration holds queues behind it (and vice versa) — contention between
  traffic *classes*, not just flows.
* Failure-domain state — :meth:`degrade` / :meth:`set_down` /
  :meth:`restore` are the mutation points the chaos tier's
  ``link_degrade`` / ``link_partition`` :class:`~repro_torch.sched_integration.
  fleet.FailureEvent`s drive; :meth:`reachable` answers "can the gateway
  still dispatch to this pod at time t" for the scheduler's partition mask.

Recovery contract (with ``simulate_serving``): a replica behind a
partitioned path is *masked* (its Exec_TID column dispatches as ``+inf``)
for the window — in-flight work keeps running (its KV is pod-local), only
new admissions divert; when the window closes the column is restored
bit-exact from the same cost model that built it.  Migrations started into
(or across) a down link simply wait the window out: ``transfer_s`` never
drops a flow, it delays it — the same never-silently-dropped accounting the
request path obeys.

Determinism: every method is a pure function of the call sequence — no wall
clock, no RNG — so chaos timelines replay bit-identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

_INF = float("inf")


def link_key(a: str, b: str) -> tuple[str, str]:
    """Canonical (sorted) undirected edge key."""
    return (a, b) if a <= b else (b, a)


def parse_link_target(target: str) -> tuple[str, str]:
    """Parse a failure-event link target ``"a:b"`` into an edge key."""
    parts = target.split(":")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(
            f"link target must be 'podA:podB', got {target!r}")
    return link_key(parts[0], parts[1])


@dataclass
class Link:
    """One undirected inter-pod link and its live state.

    ``gbps`` is the healthy bandwidth in GB/s; the *effective* bandwidth at
    any instant is ``gbps * degrade * (1 - background_util)`` — the degrade
    factor is the chaos tier's ``link_degrade`` knob, the background
    utilization models steady gradient-collective traffic claiming a fixed
    share of the wire.  ``free_at`` is the FIFO reservation horizon
    (contention: flows through this link serialize past it); ``down_until``
    is the partition window's end (``-inf`` when up).
    """

    a: str
    b: str
    gbps: float
    latency_s: float = 0.0
    degrade: float = 1.0
    background_util: float = 0.0
    free_at: float = 0.0
    down_until: float = field(default=-_INF)

    def effective_bps(self) -> float:
        """Bytes/sec the link currently moves (degrade + background load)."""
        return self.gbps * 1e9 * self.degrade * (1.0 - self.background_util)

    def up_at(self, t: float) -> bool:
        return t >= self.down_until


class Topology:
    """Undirected link graph over pods, with per-link contention state.

    ``pod_of`` maps replica names to pod nodes (replicas not listed live
    "nowhere" and are exempt from reachability masking); ``gateway`` names
    the pod requests are dispatched *from* (and params are migrated from) —
    with no gateway set, reachability masking and migration charging are
    disabled and the topology is purely a transfer-time model.
    """

    def __init__(self, *, pod_of: dict[str, str] | None = None,
                 gateway: str | None = None):
        self._links: dict[tuple[str, str], Link] = {}
        self._adj: dict[str, list[str]] = {}
        self.pod_of: dict[str, str] = dict(pod_of or {})
        self.gateway = gateway

    # -- construction --------------------------------------------------------

    def connect(self, a: str, b: str, gbps: float,
                latency_s: float = 0.0) -> Link:
        """Add (or replace) the undirected link between pods ``a`` and
        ``b``."""
        if a == b:
            raise ValueError(f"self-link {a!r}:{b!r}")
        if gbps <= 0:
            raise ValueError(f"link {a}:{b} bandwidth must be > 0, got {gbps}")
        key = link_key(a, b)
        ln = Link(*key, gbps=float(gbps), latency_s=float(latency_s))
        self._links[key] = ln
        self._adj.setdefault(a, [])
        self._adj.setdefault(b, [])
        if b not in self._adj[a]:
            self._adj[a].append(b)
            self._adj[a].sort()
        if a not in self._adj[b]:
            self._adj[b].append(a)
            self._adj[b].sort()
        return ln

    def link(self, a: str, b: str) -> Link:
        key = link_key(a, b)
        if key not in self._links:
            raise KeyError(f"no link {key[0]}:{key[1]} in "
                           f"{sorted(self._links)}")
        return self._links[key]

    @property
    def pods(self) -> list[str]:
        return sorted(self._adj)

    @property
    def links(self) -> list[Link]:
        return [self._links[k] for k in sorted(self._links)]

    # -- failure-domain mutations (driven by FailureEvents) ------------------

    def degrade(self, a: str, b: str, factor: float) -> None:
        """Scale the link's bandwidth by ``factor`` (0 < factor ≤ 1)."""
        if not (0.0 < factor <= 1.0):
            raise ValueError(f"degrade factor must be in (0, 1], got {factor}")
        self.link(a, b).degrade = float(factor)

    def restore(self, a: str, b: str) -> None:
        """Clear a degrade back to the healthy bandwidth."""
        self.link(a, b).degrade = 1.0

    def set_down(self, a: str, b: str, until: float) -> None:
        """Partition the link until time ``until`` (extends, never shrinks,
        an already-open window)."""
        ln = self.link(a, b)
        ln.down_until = max(ln.down_until, float(until))

    def set_background_util(self, a: str, b: str, frac: float) -> None:
        """Claim a steady fraction of the link for background collective
        traffic (0 ≤ frac < 1) — foreground transfers see the remainder."""
        if not (0.0 <= frac < 1.0):
            raise ValueError(
                f"background_util must be in [0, 1), got {frac}")
        self.link(a, b).background_util = float(frac)

    # -- reachability --------------------------------------------------------

    def path(self, a: str, b: str, *, at: float = _INF) -> list[Link] | None:
        """Shortest-hop path as a link list, or None if ``b`` is unreachable
        from ``a`` over links up at time ``at``.  ``at=inf`` routes over the
        full graph ignoring down-windows (every window ends).  Deterministic:
        BFS with name-sorted neighbour expansion."""
        if a == b:
            return []
        if a not in self._adj or b not in self._adj:
            return None
        prev: dict[str, str] = {a: a}
        frontier = [a]
        while frontier:
            nxt = []
            for u in frontier:
                for v in self._adj[u]:
                    if v in prev or not self._links[link_key(u, v)].up_at(at):
                        continue
                    prev[v] = u
                    if v == b:
                        out = []
                        while v != a:
                            out.append(self._links[link_key(prev[v], v)])
                            v = prev[v]
                        return out[::-1]
                    nxt.append(v)
            frontier = nxt
        return None

    def reachable(self, a: str, b: str, *, at: float) -> bool:
        """Is ``b`` reachable from ``a`` over links up at time ``at``?"""
        return self.path(a, b, at=at) is not None

    def replica_reachable(self, name: str, *, at: float) -> bool:
        """Can the gateway dispatch to replica ``name`` at time ``at``?
        Replicas with no pod mapping (or no gateway set) are always
        reachable — topology masking is opt-in per replica."""
        pod = self.pod_of.get(name)
        if pod is None or self.gateway is None:
            return True
        return self.reachable(self.gateway, pod, at=at)

    # -- transfer-time model -------------------------------------------------

    def transfer_s(self, nbytes: float, a: str, b: str, *, at: float = 0.0,
                   reserve: bool = True) -> tuple[float, float]:
        """Topology-derived ``(start, finish)`` for moving ``nbytes`` from
        pod ``a`` to pod ``b``, starting no earlier than ``at``.

        The flow takes the shortest-hop path; its start waits for every path
        link's FIFO horizon (contention with earlier reservations) *and* for
        any down-window covering the start instant (a partition delays the
        flow, never drops it); duration is the summed path latency plus
        bytes over the narrowest effective bandwidth.  ``reserve=True``
        advances every path link's horizon to the finish — later flows
        sharing any of those links queue behind this one.
        """
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        path = self.path(a, b)            # route over the full graph
        if path is None:
            raise ValueError(f"no path {a!r} -> {b!r} in the topology")
        if not path:
            return (at, at)
        start = float(at)
        for ln in path:
            start = max(start, ln.free_at, ln.down_until)
        bps = min(ln.effective_bps() for ln in path)
        dur = sum(ln.latency_s for ln in path) + nbytes / bps
        finish = start + dur
        if reserve:
            for ln in path:
                ln.free_at = finish
        return (start, finish)

    def collective_s(self, nbytes: float, pods, *, at: float = 0.0,
                     reserve: bool = True) -> tuple[float, float]:
        """Ring collective over ``pods``: ``(start, finish)`` of an
        all-reduce moving ``nbytes`` of payload per pod.

        Each ring hop (pod i → pod i+1, wrapping) carries the standard ring
        all-reduce wire volume ``2 * nbytes * (P-1)/P`` and reserves its
        pairwise path, so hops sharing a physical link serialize — and a
        collective crossing a link a migration holds queues behind it.  The
        returned finish is the slowest hop's.
        """
        pods = list(pods)
        if len(pods) < 2:
            return (at, at)
        per_hop = 2.0 * nbytes * (len(pods) - 1) / len(pods)
        start = finish = float(at)
        for i, src in enumerate(pods):
            dst = pods[(i + 1) % len(pods)]
            s, f = self.transfer_s(per_hop, src, dst, at=at, reserve=reserve)
            start = min(start, s) if i else s
            finish = max(finish, f)
        return (start, finish)


def fully_connected(pods, gbps: float, latency_s: float = 0.0, *,
                    pod_of: dict[str, str] | None = None,
                    gateway: str | None = None) -> Topology:
    """Uniform all-to-all topology over ``pods`` — the quick-start fabric
    for tests/benchmarks (every pod pair gets a dedicated link)."""
    topo = Topology(pod_of=pod_of, gateway=gateway)
    pods = list(pods)
    for i, a in enumerate(pods):
        for b in pods[i + 1:]:
            topo.connect(a, b, gbps, latency_s)
    return topo


def spine_topology(pods, gbps: float, latency_s: float = 0.0, *,
                   spine: str = "spine", pod_of: dict[str, str] | None = None,
                   gateway: str | None = None) -> Topology:
    """Star topology: every pod hangs off one shared ``spine`` node — the
    maximally contended fabric (every cross-pod byte shares spine links)."""
    topo = Topology(pod_of=pod_of, gateway=gateway)
    for p in pods:
        topo.connect(p, spine, gbps, latency_s)
    return topo


def migration_bytes(active_params: float) -> float:
    """Wire bytes a replica migration moves: one bf16 copy of the params
    (the unit ``simulate_serving`` charges a topology-backed joiner)."""
    return 2.0 * float(active_params)
