# Copied from src/repro/core/fedleo.py; imports rebound to repro_torch.
"""FedLEO: the paper's framework (§IV), as a strategy on the engine.

One synchronous round starting at simulated time t:

  1. Per orbit, the GS broadcasts w^t to the first satellite of the
     plane that can complete the download inside a visibility window
     (full uplink bandwidth B, eq. 15).
  2. The model floods the plane's bidirectional ISL ring
     (``broadcast_schedule``, duplicates dropped); each satellite starts
     local training as soon as it receives the model, so training
     processes run concurrently (§IV-A).
  3. After training, every satellite runs the *distributed scheduler*
     (``select_sink``, §IV-B) over shared deterministic state; all agree
     on the per-orbit sink — the first satellite whose upcoming access
     window is long enough for the partial-model exchange, minimizing
     eq. (22).
  4. Trained models relay hop-by-hop to the sink (eq. 21); the sink
     computes the partial global model w_{K_l} (eq. 9) and uploads it —
     with the piggybacked label histograms — during its window (one
     downlink RB, eq. 16).
  5. When the GS holds all L partials it aggregates them (eq. 4, with
     optional non-IID class-coverage weighting) into w^{t+1}.

``FedLEOGrid`` extends the same round structure to an inter-plane ISL
topology (+Grid): planes are grouped into *clusters*, one GS download
seeds a graph flood across each whole cluster, and sink selection runs
constellation-wide so a single well-placed sink collects a cluster of
planes over cross-plane relay and uploads one cluster partial — cutting
GS round-trips when planes outnumber usable windows.

The scheduling logic is factored into pure *planner* functions
(``plan_plane_round`` / ``plan_cluster_round``) so benchmarks can price
round times without running any JAX training; the strategies consume
the planners and add the real learning (local SGD, partial & global
aggregation).  The clock is the Satcom simulation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comms.environment import CommsEnvironment
from repro_torch.comms.isl import ISLConfig, isl_hop_time
from repro_torch.comms.ledger import GSResourceLedger
from repro_torch.comms.link import LinkConfig
from repro_torch.comms.routing import (
    ISLPlan,
    RoutingTable,
    get_routing_table,
    resolve_lazy_routing,
)
from repro_torch.core import aggregation
from repro_torch.core.engine import FLStrategy, SimConfig
from repro_torch.core.fltask import FederatedTask
from repro_torch.core.propagation import ring_hops_matrix
from repro_torch.core.scheduling import ClusterSinkDecision, SinkDecision
from repro_torch.obs import decompose_group_plan
from repro_torch.orbits.constellation import GroundStation, Satellite, WalkerDelta
from repro_torch.orbits.prediction import VisibilityPredictor
from repro_torch.orbits.topology import ISLTopology, get_isl_topology


# --- pure round planners (no learning; benchmarkable stand-alone) -------------
@dataclasses.dataclass(frozen=True)
class PlanePlan:
    """Schedule of one plane's round: source, flood, training, sink."""

    plane: int
    source_slot: int
    t_source: float             # download completes; flood starts
    t_receive: np.ndarray       # (K,) per-slot model receipt
    t_train_done: np.ndarray    # (K,) per-slot training completion
    decision: SinkDecision


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Schedule of one cluster's round under the grid topology."""

    planes: Tuple[int, ...]
    sats: Tuple[Tuple[int, int], ...]   # node order: plane-major, slot
    source: Tuple[int, int]
    t_source: float
    t_receive: np.ndarray       # (n,) per-sat model receipt
    t_train_done: np.ndarray    # (n,)
    decision: ClusterSinkDecision


def _naive_sink_decision(
    env: CommsEnvironment,
    *,
    isl: ISLConfig,
    plane: int,
    t_train_done: Sequence[float],
    payload_bits: float,
) -> Optional[SinkDecision]:
    """Ablation sink: first visitor after training, AW duration NOT
    checked — uploads that do not fit a window retry at the next one
    (the failure mode the paper's scheduler avoids)."""
    K = env.walker.config.sats_per_plane
    t_hop = isl_hop_time(isl, payload_bits)
    t_ready0 = max(t_train_done)
    sink = env.naive_sink_slot(plane, t_ready0)
    if sink is None:
        return None
    t_ready = float(np.max(
        np.asarray(t_train_done, dtype=np.float64)
        + ring_hops_matrix(K)[sink] * t_hop
    ))
    # upload with retries across this sink's windows (per the session's
    # handover policy, raced against a segmented station-switching plan)
    dec = env.plan_upload(Satellite(plane, sink), t_ready, payload_bits)
    if dec is None:
        return None
    return SinkDecision(
        plane=plane, sink_slot=sink, window=dec.window,
        t_models_at_sink=t_ready, t_upload_start=dec.t_start,
        t_upload_done=dec.t_done,
        t_wait=max(0.0, dec.window.t_start - t_ready),
        candidates_considered=1,
        segments=dec.segments,
        payload_bits=float(payload_bits),
    )


def _resolve_env(
    env: Optional[CommsEnvironment],
    walker: Optional[WalkerDelta],
    gs_list: Optional[Sequence[GroundStation]],
    predictor: Optional[VisibilityPredictor],
    link: Optional[LinkConfig],
    ledger: Optional[GSResourceLedger],
    handover: bool,
) -> CommsEnvironment:
    """The planners' session: the one the caller holds (strategies,
    benchmarks), or an ephemeral one assembled from the legacy explicit
    arguments (which also runs the gs-matches-predictor check)."""
    if env is not None:
        return env
    return CommsEnvironment(
        walker=walker, predictor=predictor, link=link,
        ledger=ledger, handover=handover, gs=gs_list,
    )


def plan_plane_round(
    *,
    plane: int,
    t: float,
    payload_bits: float,
    train_times: np.ndarray,
    isl: ISLConfig,
    env: Optional[CommsEnvironment] = None,
    walker: Optional[WalkerDelta] = None,
    gs_list: Optional[Sequence[GroundStation]] = None,
    predictor: Optional[VisibilityPredictor] = None,
    link: Optional[LinkConfig] = None,
    sink_policy: str = "scheduled",
    require_next_download: bool = False,
    ledger: Optional[GSResourceLedger] = None,
    handover: bool = False,
) -> Optional[PlanePlan]:
    """Plan one plane's round (paper §IV steps 1-3) without training:
    GS download -> ring flood -> concurrent training (simulated via
    ``train_times``) -> sink selection.  Returns None when no feasible
    window exists inside the predictor horizon.

    Planning routes through a ``CommsEnvironment`` session — pass one
    via ``env`` (its ledger/handover policy then applies), or the
    legacy explicit ``walker``/``gs_list``/``predictor``/``link``/
    ``ledger``/``handover`` arguments to assemble an ephemeral session.
    The session's ledger prices the sink upload against residual
    per-station RB capacity; the caller books the returned plan
    (``env.commit(plan.decision)``) before planning the next group.
    The GS download is a full-band broadcast of the same global model
    (eq. 15) and is not RB-contended.  The handover policy additionally
    lets the upload split into station-handover segments
    (``SimConfig.gs_handover``)."""
    env = _resolve_env(env, walker, gs_list, predictor, link, ledger,
                       handover)
    K = env.walker.config.sats_per_plane
    dl = env.first_visible_download(plane, t, payload_bits)
    if dl is None:
        return None
    src_slot, t_recv = dl

    t_hop = isl_hop_time(isl, payload_bits)
    t_receive = t_recv + ring_hops_matrix(K)[src_slot] * t_hop
    t_train_done = t_receive + np.asarray(train_times, dtype=np.float64)

    if sink_policy == "scheduled":
        decision = env.select_sink(
            plane=plane, t_train_done=t_train_done,
            payload_bits=payload_bits,
            require_next_download=require_next_download, isl=isl,
        )
    else:
        decision = _naive_sink_decision(
            env, isl=isl, plane=plane, t_train_done=t_train_done,
            payload_bits=payload_bits,
        )
    if decision is None:
        return None
    return PlanePlan(
        plane=plane, source_slot=src_slot, t_source=t_recv,
        t_receive=t_receive, t_train_done=t_train_done, decision=decision,
    )


def plan_cluster_round(
    *,
    routing: RoutingTable,
    planes: Sequence[int],
    t: float,
    payload_bits: float,
    train_times: np.ndarray,
    env: Optional[CommsEnvironment] = None,
    walker: Optional[WalkerDelta] = None,
    gs_list: Optional[Sequence[GroundStation]] = None,
    predictor: Optional[VisibilityPredictor] = None,
    link: Optional[LinkConfig] = None,
    require_next_download: bool = False,
    ledger: Optional[GSResourceLedger] = None,
    handover: bool = False,
) -> Optional[ClusterPlan]:
    """Plan one cluster's round over the ISL graph: a single GS download
    seeds a flood across every plane of the cluster, and one
    constellation-wide sink collects the cluster over cross-plane relay.
    With a single-plane cluster and a ring topology this degenerates to
    ``plan_plane_round`` exactly (bit-identical schedules).  Session
    (``env`` vs legacy explicit arguments), ledger and handover
    semantics as in ``plan_plane_round``: candidate sinks are priced
    against residual station capacity (and may split their upload
    across stations), the caller commits."""
    env = _resolve_env(env, walker, gs_list, predictor, link, ledger,
                       handover)
    K = env.walker.config.sats_per_plane
    sats = [(p, s) for p in planes for s in range(K)]
    nodes = routing.nodes_of(sats)

    dl = env.first_visible_download_sats(sats, t, payload_bits)
    if dl is None:
        return None
    src_i, t_recv = dl

    t_receive, _, _ = routing.broadcast_times(
        [nodes[src_i]], [t_recv], nodes=nodes
    )
    t_train_done = t_receive + np.asarray(train_times, dtype=np.float64)

    _, relay_latency = routing.submatrix(nodes)
    decision = env.select_sink_cluster(
        sats=sats, relay_latency=relay_latency,
        t_train_done=t_train_done, payload_bits=payload_bits,
        require_next_download=require_next_download,
    )
    if decision is None:
        return None
    return ClusterPlan(
        planes=tuple(planes), sats=tuple(sats), source=sats[src_i],
        t_source=t_recv, t_receive=t_receive, t_train_done=t_train_done,
        decision=decision,
    )


def make_clusters(
    num_planes: int, cluster_planes: int
) -> List[Tuple[int, ...]]:
    """Group adjacent planes into clusters of ``cluster_planes`` —
    the *static* grouping (rotation 0), kept as the degenerate case of
    ``form_clusters``."""
    return [
        tuple(range(i, min(i + cluster_planes, num_planes)))
        for i in range(0, num_planes, cluster_planes)
    ]


def _split_connected(
    planes: Sequence[int], adjacency: np.ndarray
) -> List[Tuple[int, ...]]:
    """Split a plane group into its connected components under the
    inter-plane adjacency (a cluster must be able to flood/relay
    internally; a seam-cut or ring topology may disconnect a run)."""
    remaining = sorted(planes)
    comps: List[Tuple[int, ...]] = []
    while remaining:
        seed = remaining.pop(0)
        comp = {seed}
        frontier = [seed]
        while frontier:
            p = frontier.pop()
            linked = [q for q in remaining if adjacency[p, q]]
            for q in linked:
                remaining.remove(q)
                comp.add(q)
                frontier.append(q)
        comps.append(tuple(sorted(comp)))
    return comps


def form_clusters(
    supply: np.ndarray,
    cluster_planes: int,
    *,
    seam_cut: bool = False,
    adjacency: Optional[np.ndarray] = None,
) -> List[Tuple[int, ...]]:
    """Per-round dynamic cluster formation from predicted window supply.

    Planes are partitioned into contiguous runs of at most
    ``cluster_planes``; among the candidate rotations the one whose
    clusters contain the best-served anchor planes wins:

      score(r) = sum over clusters of max(plane supply in cluster),

    i.e. every cluster should hold at least one plane with rich
    upcoming GS-window supply (the cluster sink will sit there).
    Rotations that need more clusters (more GS round-trips) are never
    preferred; ties resolve to the smallest rotation, which makes
    rotation 0 — the static ``make_clusters`` grouping — the
    deterministic fallback under uniform supply.

    ``seam_cut`` forbids runs that wrap the plane L-1 / plane 0 seam
    (clusters are never formed across a cut polar seam).  With an
    ``adjacency`` matrix every run is additionally split into its
    connected components, so a topology without inter-plane links
    (ring) degenerates to single-plane clusters exactly.

    Returns clusters as ascending plane tuples, ordered by first plane.
    """
    supply = np.asarray(supply, dtype=np.float64)
    L = supply.size
    c = max(1, min(int(cluster_planes), L))
    best: Optional[Tuple[Tuple[int, float, int], List[Tuple[int, ...]]]] = None
    for r in range(c if c > 1 else 1):
        if seam_cut:
            seq = list(range(L))
            runs = ([tuple(seq[:r])] if r else []) + [
                tuple(seq[i:i + c]) for i in range(r, L, c)
            ]
        else:
            seq = [(r + i) % L for i in range(L)]
            runs = [tuple(seq[i:i + c]) for i in range(0, L, c)]
        score = float(sum(supply[list(g)].max() for g in runs))
        key = (len(runs), -score, r)
        if best is None or key < best[0]:
            best = (key, runs)
    groups = best[1]
    if adjacency is not None:
        groups = [
            comp for g in groups for comp in _split_connected(g, adjacency)
        ]
    groups = [tuple(sorted(g)) for g in groups]
    groups.sort(key=lambda g: g[0])
    return groups


def supply_driven_clusters(
    predictor: VisibilityPredictor,
    topology: ISLTopology,
    cluster_planes: int,
    t: float,
    lookahead_s: Optional[float] = None,
    ledger: Optional[GSResourceLedger] = None,
) -> List[Tuple[int, ...]]:
    """One round's plane grouping from predicted window supply — THE
    dynamic-formation recipe (``FedLEOGrid``'s default and what the
    contention benchmark prices): supply over the next orbital period,
    ``form_clusters`` with the topology's seam/connectivity.

    With a ``ledger`` the per-station supply is discounted by the
    station's *residual* RB fraction over the lookahead
    (contention-aware formation feedback): window seconds on a station
    already saturated by booked uploads are worth proportionally less,
    so cluster anchors steer toward stations with free capacity.  An
    empty or unlimited ledger leaves the supply untouched — the
    degenerate case is the plain window-supply grouping."""
    if lookahead_s is None:
        lookahead_s = topology.constellation.period_s
    supply = predictor.plane_window_supply(t, t + lookahead_s)
    if ledger is not None:
        supply = supply * ledger.residual_fraction(t, t + lookahead_s)[None, :]
    return form_clusters(
        supply.sum(axis=1), cluster_planes,
        seam_cut=topology.config.seam_cut,
        adjacency=topology.plane_adjacency(),
    )


# --- strategies ---------------------------------------------------------------
class _SyncRoundMixin:
    """Shared synchronous round driver for FedLEO and FedLEOGrid: plan
    each plane group's schedule, run the real local training, aggregate
    the group partial at its sink (eq. 9), then the GS global aggregate
    (eq. 4 + non-IID weighting).  Only the planner and the per-group
    stats differ between the ring and grid variants.

    Groups are planned in order and every chosen sink upload is BOOKED
    on the strategy's resource ledger before the next group plans, so
    later sinks are priced against the residual station capacity —
    several sinks landing on one station's window now compete for its
    resource blocks instead of overlapping for free."""

    def _sync_round(
        self,
        t: float,
        groups: Sequence[Tuple[int, ...]],
        # (group, clients) -> PlanePlan | ClusterPlan | None
        plan_group: Callable[[Tuple[int, ...], List[int]], Optional[Any]],
        # group -> events dict for an infeasible round
        fail_event: Callable[[Tuple[int, ...]], Dict[str, Any]],
        # plan -> stats dict
        group_stats: Callable[[Any], Dict[str, Any]],
        events_key: str,
    ) -> Tuple[Optional[float], Dict[str, Any]]:
        sim, task = self.sim, self.task
        upload_done: List[float] = []
        stats: List[Dict[str, Any]] = []
        partials = []
        group_counts: List[int] = []
        group_hists: List[np.ndarray] = []
        self._round_groups = []

        for group in groups:
            # node-ordered client list (plane-major, slot order) so that
            # client i sits on the group's i-th satellite
            clients = [c for p in group for c in self.plane_clients(p)]
            plan = plan_group(group, clients)
            if plan is None:
                return None, fail_event(group)
            self.env.commit(plan.decision)
            # typed phase decomposition of the committed plan (read-only
            # on the plan: schedules are unaffected)
            self._round_groups.append(decompose_group_plan(plan, t))

            stacked = task.local_train(
                self.global_params, clients, self._next_rng()
            )
            counts = [task.num_samples(c) for c in clients]
            partials.append(
                aggregation.partial_aggregate(
                    stacked, counts, use_kernel=sim.use_kernel
                )
            )
            group_counts.append(int(np.sum(counts)))
            group_hists.append(
                np.sum([task.clients[c].histogram for c in clients], axis=0)
            )
            upload_done.append(plan.decision.t_upload_done)
            stats.append(group_stats(plan))

        self.global_params = aggregation.global_aggregate(
            aggregation.stack_pytrees(partials),
            group_counts,
            histograms=np.stack(group_hists),
            noniid_alpha=sim.noniid_alpha,
            use_kernel=sim.use_kernel,
        )
        return max(upload_done), {events_key: stats}


class FedLEO(_SyncRoundMixin, FLStrategy):
    name = "FedLEO"

    def __init__(self, *args: Any, require_next_download: bool = False,
                 sink_policy: str = "scheduled", **kwargs: Any):
        """sink_policy:
          * "scheduled"     — the paper's distributed scheduler (§IV-B):
            first satellite whose window fits the exchange, minimizing
            eq. (22);
          * "first_visitor" — ablation: next satellite to see the GS,
            window duration ignored (upload retries if it doesn't fit) —
            isolates the contribution of the scheduling component.
        """
        super().__init__(*args, **kwargs)
        self.require_next_download = require_next_download
        assert sink_policy in ("scheduled", "first_visitor")
        self.sink_policy = sink_policy
        if sink_policy != "scheduled":
            self.name = f"FedLEO({sink_policy})"

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        sim, task = self.sim, self.task

        def plan_group(
            group: Tuple[int, ...], clients: List[int]
        ) -> Optional[PlanePlan]:
            (plane,) = group
            return plan_plane_round(
                env=self.env, isl=sim.isl,
                plane=plane, t=t,
                payload_bits=self.group_payload_bits(group),
                train_times=np.array(
                    [self.train_time_s(c) for c in clients]
                ),
                sink_policy=self.sink_policy,
                require_next_download=self.require_next_download,
            )

        def group_stats(plan: PlanePlan) -> Dict[str, Any]:
            d = plan.decision
            return {
                "plane": plan.plane,
                "source_slot": plan.source_slot,
                "t_broadcast_done": plan.t_source,
                "sink_slot": d.sink_slot,
                "t_models_at_sink": d.t_models_at_sink,
                "t_wait_sink": d.t_wait,
                "t_upload_done": d.t_upload_done,
                "handover_legs": len(d.segments),
            }

        return self._sync_round(
            t,
            [(p,) for p in range(sim.constellation.num_planes)],
            plan_group,
            lambda group: {"failed_plane": group[0]},
            group_stats,
            "planes",
        )


class FedLEOGrid(_SyncRoundMixin, FLStrategy):
    """FedLEO over an inter-plane ISL topology (+Grid).

    Planes are grouped into clusters of up to ``cluster_planes``
    adjacent planes — by default re-formed *every round* from the
    predicted window supply (``form_clusters``; seam cuts respected);
    per round each cluster needs only ONE GS download (the flood
    crosses planes over inter-plane ISLs) and ONE upload (the cluster
    sink collects every plane via cross-plane relay) — L /
    cluster_planes GS round-trips instead of L.  With
    ``cluster_planes=1`` and a ring topology this is bit-identical to
    ``FedLEO`` (schedules and sink decisions; equivalence-tested).
    With a resource ledger (``SimConfig.gs_rb_capacity``) cluster sinks
    compete for per-station RBs, which load-balances them across the
    ground segment.
    """

    name = "FedLEO-Grid"

    def __init__(self, task: FederatedTask, sim: SimConfig, *,
                 cluster_planes: Optional[int] = None,
                 dynamic_clusters: bool = True,
                 require_next_download: bool = False,
                 lazy_routing: Optional[bool] = None,
                 env: Optional[CommsEnvironment] = None):
        """``dynamic_clusters`` (default): re-form the plane clusters
        every round from the predicted window supply over the next
        orbital period (``form_clusters``) — clusters are contiguous,
        never cross a cut polar seam, and each contains a well-served
        anchor plane for its sink.  ``False`` keeps the static
        adjacent-plane grouping for every round.  ``lazy_routing=None``
        (auto) defers the all-pairs routing matrices to per-source rows
        at mega-scale (``resolve_lazy_routing``); schedules are
        identical either way."""
        super().__init__(task, sim, env)
        self.require_next_download = require_next_download
        self.topology = get_isl_topology(sim.constellation, sim.topology)
        # routing latencies are prebuilt at the task's uniform payload:
        # per-group pricing (group_payload_bits) covers the sink upload,
        # while relay hop costs stay fleet-wide — rebuilding the table
        # per payload would defeat the routing cache
        self.routing = get_routing_table(
            sim.constellation,
            sim.topology,
            ISLPlan(intra=sim.isl, inter=sim.isl_inter),
            self.payload_bits,
            lazy=resolve_lazy_routing(sim.constellation, lazy_routing),
        )
        L = sim.constellation.num_planes
        if cluster_planes is None:
            cluster_planes = (
                min(4, L) if self.topology.config.has_inter_links else 1
            )
        if cluster_planes > 1 and not self.topology.config.has_inter_links:
            raise ValueError(
                "multi-plane clusters need inter-plane ISLs "
                f"(topology kind={sim.topology.kind!r} has none)"
            )
        self.cluster_planes = cluster_planes
        self.dynamic_clusters = dynamic_clusters
        self.clusters = make_clusters(L, cluster_planes)

    def round_clusters(self, t: float) -> List[Tuple[int, ...]]:
        """This round's plane grouping: the supply-driven dynamic
        partition (discounted by the ledger's residual station
        capacity when contention accounting is on), or the static one
        when ``dynamic_clusters=False``."""
        if not self.dynamic_clusters:
            return self.clusters
        return supply_driven_clusters(
            self.predictor, self.topology, self.cluster_planes, t,
            ledger=self.ledger,
        )

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        sim, task = self.sim, self.task

        def plan_group(
            group: Tuple[int, ...], clients: List[int]
        ) -> Optional[ClusterPlan]:
            return plan_cluster_round(
                env=self.env,
                routing=self.routing, planes=group, t=t,
                payload_bits=self.group_payload_bits(group),
                train_times=np.array(
                    [self.train_time_s(c) for c in clients]
                ),
                require_next_download=self.require_next_download,
            )

        def group_stats(plan: ClusterPlan) -> Dict[str, Any]:
            d = plan.decision
            return {
                "planes": list(plan.planes),
                "source": plan.source,
                "t_broadcast_done": plan.t_source,
                "sink": (d.sink.plane, d.sink.slot),
                "t_models_at_sink": d.t_models_at_sink,
                "t_wait_sink": d.t_wait,
                "t_upload_done": d.t_upload_done,
                "handover_legs": len(d.segments),
            }

        return self._sync_round(
            t,
            self.round_clusters(t),
            plan_group,
            lambda group: {"failed_cluster": group},
            group_stats,
            "clusters",
        )
