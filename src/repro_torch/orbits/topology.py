# Copied from src/repro/orbits/topology.py; imports rebound to repro_torch.
"""Inter-satellite-link topology: the constellation as a graph.

The paper (§IV-A) confines model propagation to each plane's
bidirectional ISL ring.  Mega-constellation shells additionally carry
*inter-plane* ISLs (optical cross-links), which let one well-placed sink
aggregate for a whole cluster of planes.  This module models the
constellation as a graph over ``L*K`` nodes (node id = plane*K + slot)
with typed edges:

  * ``ring``  — today's topology: each plane a bidirectional ring,
    planes disconnected from each other (the degenerate case).
  * ``grid``  — +Grid: the ring plus a link from every satellite to its
    same-phase neighbor in each adjacent plane.  The slot mapping is
    *phasing-offset aware*: a Walker delta phases plane p by
    ``2*pi*F*p/(K*L)``, so the nearest-phase slot in plane q is
    ``s + round(F*(p - q)/L) mod K``.  ``seam_cut=True`` drops the
    cross-links over the plane L-1 <-> plane 0 seam (counter-rotating
    planes in polar shells cannot sustain optical cross-links).
  * ``motif`` — configurable intra/inter link pattern: arbitrary
    intra-plane slot offsets (e.g. ``(1, 2)`` adds skip rings) and
    inter-plane plane offsets.

All-pairs metrics are computed with a vectorized label-correcting sweep
(batched Bellman-Ford over padded neighbor arrays — one gather + min
per sweep covering every (source, destination) pair at once; no Python
loop over nodes).  Because the graph carries exactly two edge weights
(intra-plane hop time, inter-plane hop time), shortest paths are
returned as *hop-count decompositions* ``(h_intra, h_inter)``: the
latency of a path is reconstructed as ``h_intra*t_intra +
h_inter*t_inter``, which keeps the pure-ring special case bit-identical
to ``ring_hops_matrix(K) * t_hop`` (no float accumulation drift).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.orbits.constellation import (
    R_EARTH,
    ConstellationConfig,
    MultiShellConfig,
)

INTRA, INTER = 0, 1      # edge types
UNREACHABLE = -1         # hop-count sentinel for disconnected pairs

# first-hop selection works on (N, D, block) float64 slabs instead of the
# full (N, D, N) candidate tensor (~3 GB at N=2376, D=4+)
_FIRST_HOP_BLOCK_BYTES = 64e6


def _count_dtype(num_nodes: int) -> "type[np.signedinteger]":
    """Smallest signed dtype holding hop counts (path edges <= N-1).

    int16 up to 2**14 nodes leaves headroom for ``h_a + h_b`` sums;
    beyond that int32.  Quarters the footprint of the four all-pairs
    count matrices at mega-constellation N versus int64.
    """
    return np.int16 if num_nodes <= 2**14 else np.int32


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """ISL graph shape.  ``kind`` picks the preset link pattern; the
    offset tuples override it (``motif`` uses them as-is).

    intra_slot_offsets: in-plane links s -> s+o (mod K) for each offset.
    inter_plane_offsets: cross-plane links p -> p+d (mod L) for each
      offset, with phasing-aware nearest-slot mapping.
    seam_cut: drop inter-plane links that wrap the plane L-1 / plane 0
      seam.
    """

    kind: str = "ring"                                  # ring | grid | motif
    intra_slot_offsets: Optional[Tuple[int, ...]] = None
    inter_plane_offsets: Optional[Tuple[int, ...]] = None
    seam_cut: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ("ring", "grid", "motif"):
            raise ValueError(f"unknown topology kind {self.kind!r}")

    @property
    def resolved_intra_offsets(self) -> Tuple[int, ...]:
        if self.intra_slot_offsets is not None:
            return tuple(self.intra_slot_offsets)
        return (1,)                                     # ring in every preset

    @property
    def resolved_inter_offsets(self) -> Tuple[int, ...]:
        if self.inter_plane_offsets is not None:
            return tuple(self.inter_plane_offsets)
        return () if self.kind == "ring" else (1,)

    @property
    def has_inter_links(self) -> bool:
        return len(self.resolved_inter_offsets) > 0


def phased_slot_shift(
    constellation: ConstellationConfig, plane_from: int, plane_to: int
) -> int:
    """Slot offset of the nearest-phase satellite in ``plane_to``.

    Walker phasing puts slot s of plane p at in-plane phase
    ``(2*pi/K) * (s + F*p/L)``; matching phases across planes gives
    ``s' = s + F*(p - q)/L``, rounded to the nearest integer slot.
    """
    F, L = constellation.phasing_factor, constellation.num_planes
    return int(round(F * (plane_from - plane_to) / L))


def _add_shell_edges(
    edges: Dict[Tuple[int, int], int],
    constellation: ConstellationConfig,
    cfg: TopologyConfig,
    node_offset: int,
) -> None:
    """Add one Walker shell's intra/inter-plane edges into ``edges``,
    with the shell's nodes shifted by ``node_offset`` (0 for a
    single-shell topology; the shell's global block start otherwise)."""
    L, K = constellation.num_planes, constellation.sats_per_plane

    def node(p: int, s: int) -> int:
        return node_offset + p * K + s

    def add(i: int, j: int, kind: int) -> None:
        if i == j:
            return
        key = (min(i, j), max(i, j))
        edges.setdefault(key, kind)

    for off in cfg.resolved_intra_offsets:
        for p in range(L):
            for s in range(K):
                add(node(p, s), node(p, (s + off) % K), INTRA)
    for d in cfg.resolved_inter_offsets:
        for p in range(L):
            q = (p + d) % L
            if q == p:
                continue
            # the signed offset keeps the stepping direction, so the
            # seam test is representation-independent: d=-1 wraps at
            # p=0 exactly where d=+1 wraps at p=L-1
            if cfg.seam_cut and not 0 <= p + d < L:
                continue            # link would wrap the polar seam
            shift = phased_slot_shift(constellation, p, q)
            for s in range(K):
                add(node(p, s), node(q, (s + shift) % K), INTER)


class ISLTopology:
    """The ISL graph of one constellation + topology config.

    Exposes padded neighbor arrays (the vectorized-path substrate), the
    typed adjacency matrix, and cached all-pairs hop matrices.
    """

    def __init__(
        self,
        constellation: "ConstellationConfig | MultiShellConfig",
        config: TopologyConfig = TopologyConfig(),
    ):
        self.constellation = constellation
        self.config = config
        L, K = constellation.num_planes, constellation.sats_per_plane
        self.num_planes, self.sats_per_plane = L, K
        self.num_nodes = L * K

        edges = self._build_edges()
        # typed adjacency: -1 none, INTRA, INTER (symmetric)
        adj = np.full((self.num_nodes, self.num_nodes), -1, dtype=np.int8)
        for (i, j), kind in edges.items():
            # an intra link (same plane) never coincides with an inter
            # link (different planes), so no type conflicts to resolve
            adj[i, j] = kind
            adj[j, i] = kind
        self.adjacency = adj

        # padded neighbor arrays: nbr[i, d] = d-th neighbor of i (self-
        # padded), nbr_type[i, d] = INTRA/INTER or -1 for padding.
        degree = int(np.max(np.sum(adj >= 0, axis=1), initial=0))
        nbr = np.tile(np.arange(self.num_nodes)[:, None], (1, max(degree, 1)))
        nbr_type = np.full_like(nbr, -1, dtype=np.int8)
        for i in range(self.num_nodes):
            js = np.flatnonzero(adj[i] >= 0)
            nbr[i, : js.size] = js
            nbr_type[i, : js.size] = adj[i, js]
        self.neighbors = nbr
        self.neighbor_types = nbr_type

        self._split_cache: Dict[
            Tuple[float, float], Tuple[np.ndarray, np.ndarray]
        ] = {}

    # -- construction ----------------------------------------------------------
    def node(self, plane: int, slot: int) -> int:
        return plane * self.sats_per_plane + slot

    def sat_of(self, node: int) -> Tuple[int, int]:
        return divmod(node, self.sats_per_plane)

    def _build_edges(self) -> Dict[Tuple[int, int], int]:
        edges: Dict[Tuple[int, int], int] = {}
        assert isinstance(self.constellation, ConstellationConfig)
        _add_shell_edges(edges, self.constellation, self.config, 0)
        return edges

    def edges(self, kind: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(i, j) node-index arrays of every undirected edge (i < j)."""
        mask = self.adjacency >= 0 if kind is None else self.adjacency == kind
        i, j = np.nonzero(np.triu(mask, k=1))
        return i, j

    # -- all-pairs metrics -----------------------------------------------------
    def hop_split(
        self, w_intra: float = 1.0, w_inter: float = 1.0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All-pairs shortest paths under per-type edge weights.

        Returns ``(h_intra, h_inter)`` int matrices: the number of intra-
        and inter-plane edges on the minimum-cost path (cost =
        ``h_intra*w_intra + h_inter*w_inter``), or ``UNREACHABLE`` for
        disconnected pairs.  Vectorized label-correcting sweeps: every
        sweep relaxes all (node, destination) pairs through all
        neighbors with one gather + argmin; sweeps stop at a fixed
        point (<= graph diameter iterations).
        """
        key = (float(w_intra), float(w_inter))
        if key in self._split_cache:
            return self._split_cache[key]
        try:
            split = self._hop_split_dijkstra(*key)
        except ImportError:          # no scipy in this environment
            split = self._hop_split_sweeps(*key)
        self._split_cache[key] = split
        return split

    def hop_split_rows(
        self,
        sources: np.ndarray,
        w_intra: float = 1.0,
        w_inter: float = 1.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-source shortest-path decompositions: lazy counterpart of
        :meth:`hop_split`.

        Runs Dijkstra only from ``sources`` and decomposes each
        predecessor chain with per-row pointer doubling, so the working
        set scales with (S, N) instead of (N, N) and the (N, D, N)
        first-hop tensor is never formed.  Returns ``(h_intra, h_inter)``
        of shape (S, N); the unreachable mask matches :meth:`hop_split`
        exactly and ``h_intra*w_intra + h_inter*w_inter`` equals the
        optimal cost (equal-cost paths may decompose differently from
        the all-pairs solver's tie-break).
        """
        src = np.atleast_1d(np.asarray(sources, dtype=np.intp))
        N = self.num_nodes
        ct = _count_dtype(N)
        try:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import dijkstra
        except ImportError:          # no scipy: slice the full solver
            h_a, h_b = self.hop_split(w_intra, w_inter)
            return h_a[src].copy(), h_b[src].copy()

        i, j = np.nonzero(self.adjacency >= 0)          # directed both ways
        w_edge = np.where(
            self.adjacency[i, j] == INTRA, float(w_intra), float(w_inter)
        )
        dist, pred = dijkstra(
            csr_matrix((w_edge, (i, j)), shape=(N, N)),
            directed=False,
            indices=src,
            return_predecessors=True,
        )                                               # (S, N) each
        cols = np.arange(N)[None, :]
        valid = pred >= 0                               # scipy pads -9999
        jmp = np.where(valid, pred, cols).astype(np.int64, copy=False)
        step_type = self.adjacency[jmp, cols]           # edge pred[j] -> j
        step_a = ((step_type == INTRA) & valid).astype(ct)
        h_a, h_b = step_a, ((step_type == INTER) & valid).astype(ct)
        # pointer doubling along predecessor chains, per row
        for _ in range(int(np.ceil(np.log2(max(N, 2)))) + 1):
            h_a = h_a + np.take_along_axis(h_a, jmp, axis=1)
            h_b = h_b + np.take_along_axis(h_b, jmp, axis=1)
            jmp = np.take_along_axis(jmp, jmp, axis=1)
        unreachable = ~np.isfinite(dist)
        h_a = np.where(unreachable, UNREACHABLE, h_a).astype(ct, copy=False)
        h_b = np.where(unreachable, UNREACHABLE, h_b).astype(ct, copy=False)
        return h_a, h_b

    def _hop_split_dijkstra(
        self, w_intra: float, w_inter: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fast path: scipy all-pairs Dijkstra for the distances, then
        one vectorized first-hop selection + pointer-doubling pass to
        decompose every shortest path into (intra, inter) edge counts.
        The counts — not scipy's float-accumulated distances — are the
        returned metric, so the latency reconstruction stays exact.
        """
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra

        N = self.num_nodes
        nbr, ntype = self.neighbors, self.neighbor_types
        i, j = np.nonzero(self.adjacency >= 0)          # directed both ways
        w_edge = np.where(
            self.adjacency[i, j] == INTRA, float(w_intra), float(w_inter)
        )
        dist = dijkstra(
            csr_matrix((w_edge, (i, j)), shape=(N, N)), directed=False
        )

        # first hop of one optimal path per (node, destination): the
        # neighbor minimizing w(step) + dist(neighbor, dest) (argmin =
        # first index, deterministic).  Destination columns are
        # independent, so the (N, D, N) candidate tensor is evaluated in
        # budget-bounded column blocks — bit-identical argmins, bounded
        # transient instead of N*D*N*8 bytes at once.
        ct = _count_dtype(N)
        w_step = np.where(ntype == INTRA, float(w_intra), float(w_inter))
        w_step = np.where(ntype < 0, np.inf, w_step)    # (N, D)
        deg = nbr.shape[1]
        block = max(1, int(_FIRST_HOP_BLOCK_BYTES / max(1, N * deg * 8)))
        d = np.empty((N, N), dtype=np.int32)
        for c0 in range(0, N, block):
            c1 = min(N, c0 + block)
            cand = dist[:, c0:c1][nbr] + w_step[:, :, None]   # (N, D, C)
            d[:, c0:c1] = np.argmin(cand, axis=1)
        rows = np.arange(N)
        nxt = nbr[rows[:, None], d].astype(np.int32, copy=False)
        step_inter = (ntype == INTER)[rows[:, None], d].astype(ct)
        step_a = (1 - step_inter).astype(ct, copy=False)
        # fixpoint at the destination: no further steps, no counts
        nxt[rows, rows] = rows
        step_a[rows, rows] = 0
        step_inter[rows, rows] = 0

        # pointer doubling along the first-hop chains: after t rounds
        # each entry holds the counts of the first 2^t path edges
        h_a, h_b, jmp = step_a, step_inter, nxt
        cols = rows[None, :]
        for _ in range(int(np.ceil(np.log2(max(N, 2)))) + 1):
            h_a = h_a + h_a[jmp, cols]
            h_b = h_b + h_b[jmp, cols]
            jmp = jmp[jmp, cols]

        unreachable = ~np.isfinite(dist)
        h_a = np.where(unreachable, UNREACHABLE, h_a).astype(ct, copy=False)
        h_b = np.where(unreachable, UNREACHABLE, h_b).astype(ct, copy=False)
        np.fill_diagonal(h_a, 0)
        np.fill_diagonal(h_b, 0)
        return h_a, h_b

    def _hop_split_sweeps(
        self, w_intra: float, w_inter: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fallback solver: frontier-restricted label-correcting sweeps
        (pure numpy; converges in max-path-edge-count iterations)."""
        key = (float(w_intra), float(w_inter))
        N = self.num_nodes
        nbr, ntype = self.neighbors, self.neighbor_types
        ct = _count_dtype(N)
        w_step = np.where(ntype == INTRA, float(w_intra), float(w_inter))
        w_step = np.where(ntype < 0, np.inf, w_step)    # (N, D)
        step_inter = (ntype == INTER).astype(ct)        # (N, D)

        h_a = np.full((N, N), UNREACHABLE, dtype=ct)
        h_b = np.full((N, N), UNREACHABLE, dtype=ct)
        np.fill_diagonal(h_a, 0)
        np.fill_diagonal(h_b, 0)
        # cost is always REBUILT from the counts (h_a*w_a + h_b*w_b),
        # never accumulated along paths — the final latency decomposition
        # is exact, and the pure-intra case reproduces hops * t_hop
        # bitwise.  The *relative* EPS margin absorbs the last-ulp gap
        # between a candidate (cost[j] + w) and its recomputed cost
        # ((h+1-split)*w sums) at any cost magnitude, so equal-cost
        # relaxations can't ping-pong forever.
        cost = np.where(h_a >= 0, h_a * key[0] + h_b * key[1], np.inf)
        rows = np.arange(N)
        EPS = 1e-9

        # label-correcting sweeps restricted to the frontier: an entry
        # (i, k) can only improve after some (neighbor-of-i, k) entry
        # improved, so later sweeps touch only the changed columns (the
        # long tail of many-cheap-edge paths) instead of all N
        cols = rows
        while cols.size:
            sub = cost[:, cols]                         # (N, C)
            cand = sub[nbr] + w_step[:, :, None]        # (N, D, C)
            d = np.argmin(cand, axis=1)                 # (N, C)
            best = np.take_along_axis(
                cand, d[:, None, :], axis=1
            )[:, 0, :]
            margin = sub - EPS * np.where(
                np.isfinite(sub), np.maximum(1.0, np.abs(sub)), 0.0
            )
            improve = best < margin
            if not np.any(improve):
                break
            ii, jj = np.nonzero(improve)
            col_idx = cols[jj]
            via = nbr[ii, d[ii, jj]]                    # chosen neighbor
            inter_step = step_inter[ii, d[ii, jj]]
            ha_new = h_a[via, col_idx] + 1 - inter_step
            hb_new = h_b[via, col_idx] + inter_step
            h_a[ii, col_idx] = ha_new
            h_b[ii, col_idx] = hb_new
            cost[ii, col_idx] = ha_new * key[0] + hb_new * key[1]
            cols = cols[np.unique(jj)]

        return h_a, h_b

    def plane_adjacency(self) -> np.ndarray:
        """(L, L) bool: planes joined by at least one inter-plane ISL,
        derived from the built edge set — the single source of the
        offset/seam semantics (cluster formation consumes this, so it
        can never desynchronize from routing)."""
        i, j = self.edges(INTER)
        K = self.sats_per_plane
        adj = np.zeros((self.num_planes, self.num_planes), dtype=bool)
        adj[i // K, j // K] = True
        adj[j // K, i // K] = True
        np.fill_diagonal(adj, False)
        return adj

    def hop_matrix(self) -> np.ndarray:
        """All-pairs ISL hop counts (unit edge weights); UNREACHABLE for
        disconnected pairs.  The ring topology's per-plane blocks equal
        ``ring_hops_matrix(K)`` exactly."""
        h_a, h_b = self.hop_split(1.0, 1.0)
        hops = h_a + h_b
        return np.where(h_a == UNREACHABLE, UNREACHABLE, hops)

    def is_connected(self) -> bool:
        return bool(np.all(self.hop_matrix() >= 0))

    def mean_link_length_m(self, kind: int) -> float:
        """Mean chord length [m] over the edges of one type at t=0 (the
        Walker geometry is rigid, so inter-plane spacing at t=0 is
        representative of the per-link mean over an orbit)."""
        from repro_torch.orbits.constellation import make_walker

        i, j = self.edges(kind)
        if i.size == 0:
            raise ValueError(f"topology has no edges of kind {kind}")
        walker = make_walker(self.constellation)
        K = self.sats_per_plane
        r_i = walker.positions_batch(i // K, i % K, np.zeros(i.size))
        r_j = walker.positions_batch(j // K, j % K, np.zeros(j.size))
        return float(np.mean(np.linalg.norm(r_i - r_j, axis=-1)))


def _earth_clear(pos_a: np.ndarray, pos_b: np.ndarray) -> np.ndarray:
    """(Na, Nb) bool: which segments pos_a[i] -> pos_b[j] clear Earth.

    Closest approach of each chord to the geocenter must stay above
    ``R_EARTH``; endpoints are satellites, so only the interior of the
    segment can graze the sphere.
    """
    d = pos_b[None, :, :] - pos_a[:, None, :]            # (Na, Nb, 3)
    dd = np.einsum("abk,abk->ab", d, d)
    u = -np.einsum("ak,abk->ab", pos_a, d) / np.maximum(dd, 1.0)
    u = np.clip(u, 0.0, 1.0)
    closest = pos_a[:, None, :] + u[..., None] * d
    r_min2 = np.einsum("abk,abk->ab", closest, closest)
    return r_min2 > R_EARTH**2


class MultiShellTopology(ISLTopology):
    """ISL graph stitching several Walker shells into one node space.

    Each shell carries its own intra/inter-plane pattern (the shared
    :class:`TopologyConfig`, applied per shell with that shell's Walker
    phasing); shells are joined by cross-shell ISLs typed ``INTER``.
    Every satellite *proposes* links to its ``cross_links_per_sat``
    nearest cross-shell neighbors that are within
    ``cross_max_range_m`` and have Earth-unobstructed line of sight at
    t=0 (the rigid Walker geometry makes t=0 representative); the union
    of proposals forms the cross-shell edge set.  With a single shell
    the graph degenerates to exactly the :class:`ISLTopology` edge set.
    """

    def __init__(
        self,
        constellation: MultiShellConfig,
        config: TopologyConfig = TopologyConfig(),
    ):
        if not isinstance(constellation, MultiShellConfig):
            raise TypeError(
                f"MultiShellTopology needs a MultiShellConfig, got "
                f"{type(constellation).__name__}"
            )
        super().__init__(constellation, config)

    def _build_edges(self) -> Dict[Tuple[int, int], int]:
        from repro_torch.orbits.constellation import make_walker

        cfg = self.constellation
        assert isinstance(cfg, MultiShellConfig)
        K = self.sats_per_plane
        edges: Dict[Tuple[int, int], int] = {}
        for shell, plane_off in zip(cfg.shells, cfg.plane_offsets):
            _add_shell_edges(edges, shell, self.config, plane_off * K)
        if len(cfg.shells) == 1 or cfg.cross_links_per_sat <= 0:
            return edges

        def add(i: int, j: int, kind: int) -> None:
            if i != j:
                edges.setdefault((min(i, j), max(i, j)), kind)

        walker = make_walker(cfg)
        nodes = np.arange(cfg.num_satellites)
        pos = walker.positions_batch(
            nodes // K, nodes % K, np.zeros(nodes.size)
        )                                                # (N, 3)
        shell_of_node = np.repeat(
            np.concatenate(
                [
                    np.full(s.num_planes, idx, dtype=np.intp)
                    for idx, s in enumerate(cfg.shells)
                ]
            ),
            K,
        )
        kcap = cfg.cross_links_per_sat
        for a in range(len(cfg.shells)):
            for b in range(a + 1, len(cfg.shells)):
                ia = np.flatnonzero(shell_of_node == a)
                ib = np.flatnonzero(shell_of_node == b)
                delta = pos[ib][None, :, :] - pos[ia][:, None, :]
                dist = np.sqrt(np.einsum("abk,abk->ab", delta, delta))
                feasible = (dist <= cfg.cross_max_range_m) & _earth_clear(
                    pos[ia], pos[ib]
                )
                dist = np.where(feasible, dist, np.inf)
                # nearest-first proposals from both sides
                near_b = np.argsort(dist, axis=1)[:, :kcap]   # (Na, kcap)
                for r in range(ia.size):
                    for c in near_b[r]:
                        if np.isfinite(dist[r, c]):
                            add(int(ia[r]), int(ib[c]), INTER)
                near_a = np.argsort(dist, axis=0)[:kcap, :]   # (kcap, Nb)
                for c in range(ib.size):
                    for r in near_a[:, c]:
                        if np.isfinite(dist[r, c]):
                            add(int(ia[r]), int(ib[c]), INTER)
        return edges


@functools.lru_cache(maxsize=16)
def get_isl_topology(
    constellation: "ConstellationConfig | MultiShellConfig",
    config: TopologyConfig,
) -> ISLTopology:
    """Cached ISLTopology (both configs are frozen/hashable): the
    strategy, the presets' link-length derivation and the benchmarks all
    share one graph — and its all-pairs metric cache — per scenario.
    Multi-shell configs dispatch to :class:`MultiShellTopology`."""
    if isinstance(constellation, MultiShellConfig):
        return MultiShellTopology(constellation, config)
    return ISLTopology(constellation, config)


TOPOLOGY_PRESETS: Dict[str, TopologyConfig] = {
    "ring": TopologyConfig(kind="ring"),
    "grid": TopologyConfig(kind="grid"),
    "grid-seam-cut": TopologyConfig(kind="grid", seam_cut=True),
    # skip ring halves the intra-plane diameter; still one plane offset
    "motif-skip2": TopologyConfig(kind="motif", intra_slot_offsets=(1, 2)),
}


def get_topology(name_or_config: "str | TopologyConfig") -> TopologyConfig:
    """Resolve a preset name (or pass a TopologyConfig through)."""
    if isinstance(name_or_config, TopologyConfig):
        return name_or_config
    if name_or_config not in TOPOLOGY_PRESETS:
        raise ValueError(
            f"unknown topology {name_or_config!r}; have "
            f"{sorted(TOPOLOGY_PRESETS)}"
        )
    return TOPOLOGY_PRESETS[name_or_config]
