# Copied from src/repro/comms/routing.py; imports rebound to repro_torch.
"""Graph routing over the ISL topology: per-edge link provisioning and
all-pairs relay latencies.

Physically, intra-plane and inter-plane ISLs are different hardware:
the paper provisions intra-plane links at RF-comparable rates (so
FedLEO's gains come from the schedule, not the PHY), while inter-plane
cross-links are optical (Gbps class).  ``ISLPlan`` carries one
``ISLConfig`` per edge type; ``RoutingTable`` turns a topology + plan +
payload into hop/latency matrices that the propagation planner and the
constellation-wide sink scheduler consume.

Latencies are reconstructed from the topology's hop-count decomposition
(``h_intra*t_intra + h_inter*t_inter``) rather than accumulated along
paths, so a topology without inter-plane links yields latencies
bit-identical to the legacy ring arithmetic ``hops * t_hop``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comms.isl import ISLConfig, isl_hop_time
from repro_torch.orbits.constellation import ConstellationConfig, MultiShellConfig
from repro_torch.orbits.topology import (
    ISLTopology,
    TopologyConfig,
    UNREACHABLE,
    get_isl_topology,
)


@dataclasses.dataclass(frozen=True)
class ISLPlan:
    """Per-edge-type link provisioning."""

    intra: ISLConfig = dataclasses.field(default_factory=ISLConfig)
    inter: Optional[ISLConfig] = None    # None -> same as intra

    @property
    def inter_cfg(self) -> ISLConfig:
        return self.inter if self.inter is not None else self.intra

    def hop_times(self, payload_bits: float) -> Tuple[float, float]:
        """(t_intra, t_inter): single-hop exchange time per edge type."""
        return (
            isl_hop_time(self.intra, payload_bits),
            isl_hop_time(self.inter_cfg, payload_bits),
        )


def flood_times(
    latency: np.ndarray,
    sources: Sequence[int],
    t_source: Sequence[float],
    cols: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Earliest receipt per destination when the model floods the graph
    from one or more sources (duplicates dropped — each node keeps the
    earliest copy, ties to the first listed source).

    The single implementation of the flood arithmetic: the ring
    ``broadcast_schedule`` (via ``graph_broadcast_schedule``) and the
    grid ``RoutingTable.broadcast_times`` both consume it.

    Returns (t_recv, pick) over ``cols`` (default: every column of
    ``latency``); pick[i] indexes ``sources``.
    """
    sources = np.asarray(list(sources), dtype=np.intp)
    t_src = np.asarray(list(t_source), dtype=np.float64)
    lat = latency[sources, :] if cols is None else latency[np.ix_(sources, cols)]
    cand = t_src[:, None] + lat                         # (S, n)
    pick = np.argmin(cand, axis=0)                      # first min wins ties
    return cand[pick, np.arange(cand.shape[1])], pick


def relay_arrivals(
    latency: np.ndarray,
    sink: int,
    t_ready: Sequence[float],
    rows: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Arrival time of each node's model at the sink (store-and-forward
    over the min-latency path; every model pays its full path latency —
    no cut-through)."""
    t_ready = np.asarray(list(t_ready), dtype=np.float64)
    col = latency[:, sink] if rows is None else latency[rows, sink]
    return t_ready + col


class RoutingTable:
    """All-pairs ISL routing metrics for one (topology, plan, payload).

    Attributes:
      hops:    (N, N) int total hop count on the min-latency path
               (UNREACHABLE for disconnected pairs).
      latency: (N, N) float relay seconds along the min-latency path
               (inf for disconnected pairs).

    With ``lazy=True`` the (N, N) matrices are not built up front:
    queries that only touch source rows (``broadcast_times``,
    ``submatrix``, ``relay_times`` via the undirected symmetry
    ``latency[:, sink] == latency[sink, :]``) run per-source Dijkstra
    (``ISLTopology.hop_split_rows``) and cache the rows; directly
    reading ``.hops``/``.latency`` materializes the full matrices on
    first access.  The eager default is byte-for-byte the historical
    behavior.
    """

    _LAZY_ATTRS = ("hops_intra", "hops_inter", "hops", "latency")

    def __init__(
        self,
        topology: ISLTopology,
        plan: ISLPlan,
        payload_bits: float,
        lazy: bool = False,
    ):
        self.topology = topology
        self.plan = plan
        self.payload_bits = float(payload_bits)
        t_a, t_b = plan.hop_times(payload_bits)
        self.t_hop_intra, self.t_hop_inter = t_a, t_b
        self.lazy = bool(lazy)
        self._row_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if not self.lazy:
            self._materialize()

    def _materialize(self) -> None:
        t_a, t_b = self.t_hop_intra, self.t_hop_inter
        h_a, h_b = self.topology.hop_split(t_a, t_b)
        self.hops_intra, self.hops_inter = h_a, h_b
        unreachable = h_a == UNREACHABLE
        self.hops = np.where(unreachable, UNREACHABLE, h_a + h_b)
        self.latency = np.where(
            unreachable, np.inf, h_a * t_a + h_b * t_b
        )

    def __getattr__(self, name: str) -> np.ndarray:
        # only reached when normal lookup misses: a lazy table's full
        # matrices materialize on first direct access
        if name in RoutingTable._LAZY_ATTRS:
            self._materialize()
            return getattr(self, name)
        raise AttributeError(name)

    @property
    def materialized(self) -> bool:
        """True once the full (N, N) matrices exist."""
        return "latency" in self.__dict__

    def _row_metrics(
        self, sources: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(hops, latency) rows (S, N) for the given source nodes.

        Eager (or already-materialized) tables slice the full matrices
        — bit-identical to historical behavior; lazy tables run
        per-source Dijkstra and cache each row.
        """
        src = np.asarray(sources, dtype=np.intp)
        if self.materialized:
            return self.hops[src], self.latency[src]
        missing = [int(s) for s in src if int(s) not in self._row_cache]
        if missing:
            r_a, r_b = self.topology.hop_split_rows(
                np.asarray(missing, dtype=np.intp),
                self.t_hop_intra,
                self.t_hop_inter,
            )
            for k, s in enumerate(missing):
                self._row_cache[s] = (r_a[k], r_b[k])
        h_a = np.stack([self._row_cache[int(s)][0] for s in src])
        h_b = np.stack([self._row_cache[int(s)][1] for s in src])
        unreachable = h_a == UNREACHABLE
        hops = np.where(unreachable, UNREACHABLE, h_a + h_b)
        lat = np.where(
            unreachable,
            np.inf,
            h_a * self.t_hop_intra + h_b * self.t_hop_inter,
        )
        return hops, lat

    @property
    def num_nodes(self) -> int:
        return self.topology.num_nodes

    def nodes_of(self, sats: Sequence[Tuple[int, int]]) -> np.ndarray:
        K = self.topology.sats_per_plane
        arr = np.asarray(list(sats), dtype=np.intp).reshape(-1, 2)
        return arr[:, 0] * K + arr[:, 1]

    def submatrix(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hops, latency) restricted to a node subset — paths may still
        transit nodes outside the subset (ISLs are dedicated links; a
        relay through a neighboring plane costs nothing extra here)."""
        nodes = np.asarray(nodes, dtype=np.intp)
        if not self.materialized:
            hops_rows, lat_rows = self._row_metrics(nodes)
            return hops_rows[:, nodes], lat_rows[:, nodes]
        ix = np.ix_(nodes, nodes)
        return self.hops[ix], self.latency[ix]

    # -- flood / relay ---------------------------------------------------------
    def broadcast_times(
        self,
        sources: Sequence[int],
        t_source: Sequence[float],
        nodes: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``flood_times`` over this table's latency matrix.

        Returns (t_recv, hops, source_index) arrays over ``nodes``
        (default: every node).  Unreachable nodes get inf / UNREACHABLE.
        """
        sources = np.asarray(list(sources), dtype=np.intp)
        cols = (
            np.arange(self.num_nodes) if nodes is None
            else np.asarray(nodes, dtype=np.intp)
        )
        hops_rows, lat_rows = self._row_metrics(sources)
        t_recv, pick = flood_times(
            lat_rows, np.arange(sources.size), t_source, cols
        )
        hops = hops_rows[pick, cols]
        return t_recv, hops, pick

    def relay_times(
        self,
        sink: int,
        t_ready: Sequence[float],
        nodes: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """``relay_arrivals`` over this table's latency matrix."""
        rows = (
            np.arange(self.num_nodes) if nodes is None
            else np.asarray(nodes, dtype=np.intp)
        )
        if not self.materialized:
            # undirected graph: latency[:, sink] == latency[sink, :]
            _, lat_sink = self._row_metrics(np.asarray([sink]))
            t_arr = np.asarray(list(t_ready), dtype=np.float64)
            return t_arr + lat_sink[0, rows]
        return relay_arrivals(self.latency, sink, t_ready, rows)


# Node count at which the planners' auto mode switches to lazy
# per-source routing rows: a 40x22 table (880 nodes, ~6 MB of float64
# per matrix) is cheap to materialize, while starlink-gen1 (1584) and
# beyond pay real memory and hop-split time for all-pairs matrices a
# planning round never fully reads.
LAZY_AUTO_NODE_THRESHOLD = 1024


def resolve_lazy_routing(
    constellation: "ConstellationConfig | MultiShellConfig",
    lazy: Optional[bool] = None,
) -> bool:
    """The planners' lazy-routing choice: an explicit ``lazy`` wins;
    None means auto — lazy at mega-scale (>= ``LAZY_AUTO_NODE_THRESHOLD``
    satellites), eager below it.  Lazy and eager tables answer every
    query identically (row-sliced vs. matrix-sliced of the same
    Dijkstra), so the planners' schedules do not depend on the choice
    (equivalence-tested)."""
    if lazy is not None:
        return bool(lazy)
    return constellation.num_satellites >= LAZY_AUTO_NODE_THRESHOLD


# cache hit/miss observers (repro.obs wires TraceRecorder counters in
# here); a listener must never raise and must not call back into
# get_routing_table
_CACHE_LISTENERS: List[Callable[[bool], None]] = []


def on_routing_cache(
    callback: Callable[[bool], None],
) -> Callable[[], None]:
    """Register ``callback(hit)`` to observe every ``get_routing_table``
    lookup (True = LRU cache hit).  Returns an unsubscribe function."""
    _CACHE_LISTENERS.append(callback)

    def unsubscribe() -> None:
        if callback in _CACHE_LISTENERS:
            _CACHE_LISTENERS.remove(callback)

    return unsubscribe


@functools.lru_cache(maxsize=32)
def _routing_table_cached(
    constellation: "ConstellationConfig | MultiShellConfig",
    topology: TopologyConfig,
    plan: ISLPlan,
    payload_bits: float,
    lazy: bool = False,
) -> RoutingTable:
    return RoutingTable(
        get_isl_topology(constellation, topology), plan, payload_bits,
        lazy=lazy,
    )


def get_routing_table(
    constellation: "ConstellationConfig | MultiShellConfig",
    topology: TopologyConfig,
    plan: ISLPlan,
    payload_bits: float,
    lazy: bool = False,
) -> RoutingTable:
    """Cached ``RoutingTable`` per (constellation, topology, plan,
    payload) — every argument is frozen/hashable and the graph is
    static per scenario, so strategies and benchmark arms re-running
    the same topology share one table (and the hop-split computation
    behind it) instead of rebuilding it per run.  The table is
    read-only by convention; callers must not mutate its matrices.
    Registered ``on_routing_cache`` observers see each lookup's
    hit/miss outcome.  ``lazy=True`` defers the (N, N) matrices to
    per-source rows (see ``RoutingTable``) and caches separately from
    the eager table."""
    if not _CACHE_LISTENERS:
        return _routing_table_cached(
            constellation, topology, plan, payload_bits, lazy
        )
    before = _routing_table_cached.cache_info().hits
    table = _routing_table_cached(
        constellation, topology, plan, payload_bits, lazy
    )
    hit = _routing_table_cached.cache_info().hits > before
    for cb in list(_CACHE_LISTENERS):
        cb(hit)
    return table


# back-compat: expose the underlying LRU controls on the public name
get_routing_table.cache_info = _routing_table_cached.cache_info
get_routing_table.cache_clear = _routing_table_cached.cache_clear
