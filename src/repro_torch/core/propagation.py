# Copied from src/repro/core/propagation.py; imports rebound to repro_torch.
"""Model propagation over the ISL graph (paper §IV-A, generalized).

Given the satellite(s) that first receive the global model from the GS
(the *sources*), the model floods the ISL topology; each satellite
forwards to its neighbors.  Relaying trained models to the sink works
the same way in reverse.  The paper's intra-plane bidirectional ring is
the degenerate (single-plane) case; with inter-plane cross-links the
same planners flood a whole cluster of planes.

The planner is pure geometry + eq. (20) timing:

  * ``broadcast_schedule``: per-satellite model-receipt time when the
    source floods the ring (hop distance * t_h).  Duplicate receptions
    (two visible satellites, or the two flood fronts meeting) are
    dropped, i.e. each satellite keeps the *earliest* receipt — exactly
    the paper's "simply drop the duplicate".
  * ``relay_schedule``: per-satellite arrival time of its trained model
    at the sink (store-and-forward over `hops` ISL hops, eq. 21); the
    orbit's relay completion is the max arrival.
  * ``graph_broadcast_schedule`` / ``graph_relay_schedule``: the same
    semantics over *arbitrary* hop/latency matrices (e.g. a
    ``RoutingTable`` built from an inter-plane +Grid topology).

All schedules are computed with one batched matrix expression per call
— no per-slot Python loops.  ``ring_hops_matrix`` remains the single
vectorized source of the intra-plane hop metric, and the ring
schedules are exactly the graph schedules evaluated on
``ring_hops_matrix(K) * t_hop``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.comms.isl import ISLConfig, isl_hop_time
from repro_torch.comms.routing import flood_times, relay_arrivals


@dataclasses.dataclass(frozen=True)
class PropagationEvent:
    slot: int               # node: in-plane slot (ring) or graph node id
    t_receive: float
    hops: int
    source_slot: int


def ring_hops(num_slots: int, a: int, b: int) -> int:
    d = abs(a - b) % num_slots
    return min(d, num_slots - d)


def ring_hops_matrix(num_slots: int) -> np.ndarray:
    """hops[a, b] = ring_hops(num_slots, a, b) for every slot pair.

    The single source of truth for the intra-plane ISL hop metric in
    vectorized code; ``repro.orbits.topology.ISLTopology`` reproduces it
    exactly as the per-plane blocks of the ring topology's hop matrix
    (equivalence-tested).
    """
    slots = np.arange(num_slots)
    d = np.abs(slots[:, None] - slots[None, :]) % num_slots
    return np.minimum(d, num_slots - d)


def graph_broadcast_schedule(
    hops: np.ndarray,
    latency: np.ndarray,
    source_nodes: Sequence[int],
    t_source: Sequence[float],
) -> List[PropagationEvent]:
    """Flood the model over an arbitrary ISL graph from one or more
    sources; every node keeps its earliest copy (ties resolve to the
    first listed source).

    Args:
      hops: (N, N) hop-count matrix (UNREACHABLE/-1 for disconnected).
      latency: (N, N) relay seconds between node pairs (inf when
        disconnected).
      source_nodes / t_source: nodes holding the model and when.

    Returns one event per node; unreachable nodes get t_receive=inf.
    """
    src = np.asarray(list(source_nodes), dtype=np.intp)
    n = latency.shape[0]
    t_recv, pick = flood_times(latency, src, t_source)
    h = hops[src[pick], np.arange(n)]
    return [
        PropagationEvent(
            slot=int(k),
            t_receive=float(t_recv[k]),
            hops=int(h[k]),
            source_slot=int(src[pick[k]]),
        )
        for k in range(n)
    ]


def graph_relay_schedule(
    hops: np.ndarray,
    latency: np.ndarray,
    sink_node: int,
    t_ready: Sequence[float],
) -> List[PropagationEvent]:
    """Arrival time of each node's trained model at the sink over the
    graph's min-latency paths (store-and-forward, no cut-through)."""
    t_ready = np.asarray(list(t_ready), dtype=np.float64)
    arrive = relay_arrivals(latency, sink_node, t_ready)
    return [
        PropagationEvent(
            slot=int(k),
            t_receive=float(arrive[k]),
            hops=int(hops[k, sink_node]),
            source_slot=int(k),
        )
        for k in range(t_ready.size)
    ]


def broadcast_schedule(
    num_slots: int,
    source_slots: Sequence[int],
    t_source: Sequence[float],
    payload_bits: float,
    isl: ISLConfig,
) -> List[PropagationEvent]:
    """Flood the global model around the ring from one or more sources.

    Args:
      num_slots: satellites on the plane (K).
      source_slots: slots that received w^t directly from the GS.
      t_source: receipt time at each source (same length).
      payload_bits: z|N| of the model.

    Returns:
      One event per slot with its earliest receipt time (duplicates
      dropped by taking the min over sources/directions).
    """
    t_hop = isl_hop_time(isl, payload_bits)
    hops = ring_hops_matrix(num_slots)
    return graph_broadcast_schedule(
        hops, hops * t_hop, source_slots, t_source
    )


def relay_schedule(
    num_slots: int,
    sink_slot: int,
    t_ready: Sequence[float],
    payload_bits: float,
    isl: ISLConfig,
) -> List[PropagationEvent]:
    """Arrival time of each satellite's trained model at the sink.

    ``t_ready[k]`` is when slot k finishes local training.  Each model is
    store-and-forwarded over ring_hops(k, sink) hops (eq. 21's h * t_h
    term).  We model per-hop pipelining conservatively: every model pays
    its full hop count (no cut-through), matching eq. (21)'s max over
    relaying satellites.
    """
    t_hop = isl_hop_time(isl, payload_bits)
    hops = ring_hops_matrix(num_slots)
    return graph_relay_schedule(hops, hops * t_hop, sink_slot, t_ready)


def relay_completion_time(events: Sequence[PropagationEvent]) -> float:
    """Eq. (21): the orbit's t_h^* — all models collected at the sink."""
    return max(e.t_receive for e in events)
