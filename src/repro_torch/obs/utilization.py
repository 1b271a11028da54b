# Copied from src/repro/obs/utilization.py; imports rebound to repro_torch.
"""Per-station RB-utilization timelines from ledger occupancy / traces.

Two equivalent sources:

  * a live ``GSResourceLedger`` (``ledger_rb_utilization``) — what the
    benchmarks fold into their BENCH rows right after pricing a round,
  * a recorded trace's commit/release events
    (``occupancy_timeline`` / ``trace_rb_utilization``) — what the
    reporter and the Perfetto exporter reconstruct offline.

Utilization is booked RB-seconds over available RB-seconds
(``capacity * span``); stations with unlimited capacity report the raw
booked seconds against a denominator of one RB, which keeps the number
meaningful in the contention-free degenerate case.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from repro_torch.comms.ledger import GSResourceLedger
    from repro_torch.obs.trace import TraceEvent


def ledger_rb_utilization(
    ledger: "GSResourceLedger", t0: float, t1: float
) -> List[float]:
    """Per-station fraction of RB capacity booked over ``[t0, t1]``
    (unlimited stations are normalized to one RB)."""
    span = max(0.0, t1 - t0)
    if span <= 0.0:
        return [0.0] * ledger.num_stations
    out = []
    for i in range(ledger.num_stations):
        cap = float(ledger.capacity[i])
        denom = span * (cap if np.isfinite(cap) else 1.0)
        out.append(ledger.booked_seconds(i, t0, t1) / denom)
    return out


def occupancy_timeline(
    events: Sequence["TraceEvent"],
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Reconstruct each station's RB occupancy step function from a
    trace's ``commit``/``release`` spans.

    Returns ``{gs_index: (times, occupancy)}`` where ``occupancy[i]``
    is the booked-RB count from ``times[i]`` until ``times[i+1]`` —
    the counter rows of the Perfetto export.  A released interval
    cancels its committed booking over the freed span."""
    deltas: Dict[int, List[Tuple[float, int]]] = {}
    for ev in events:
        if ev.kind not in ("commit", "release"):
            continue
        gi = int(ev.track.split("/", 1)[1])
        sign = 1 if ev.kind == "commit" else -1
        deltas.setdefault(gi, []).append((ev.t_start_s, sign))
        deltas.setdefault(gi, []).append((ev.t_end_s, -sign))
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for gi, evs in deltas.items():
        evs.sort()
        times = np.array([t for t, _ in evs], dtype=np.float64)
        occ = np.cumsum([d for _, d in evs])
        # merge coincident timestamps: keep the final occupancy there
        keep = np.ones(times.size, dtype=bool)
        keep[:-1] = times[1:] != times[:-1]
        out[gi] = (times[keep], occ[keep])
    return out


def trace_rb_utilization(
    events: Sequence["TraceEvent"],
    t0: float,
    t1: float,
    capacities: Optional[Sequence[Optional[int]]] = None,
) -> Dict[int, float]:
    """Per-station booked fraction over ``[t0, t1]`` reconstructed from
    trace events — the offline mirror of ``ledger_rb_utilization``.
    ``capacities[gs_index]`` (None = unlimited -> one-RB normalization)
    usually comes from the trace meta's ``rb_capacity``."""
    span = max(0.0, t1 - t0)
    out: Dict[int, float] = {}
    if span <= 0.0:
        return out
    for gi, (times, occ) in occupancy_timeline(events).items():
        edges = np.concatenate([times, [max(t1, times[-1])]])
        widths = (
            np.clip(edges[1:], t0, t1) - np.clip(edges[:-1], t0, t1)
        )
        booked = float(np.sum(widths * occ))
        cap = None
        if capacities is not None and gi < len(capacities):
            cap = capacities[gi]
        out[gi] = booked / (span * (cap if cap else 1))
    return out
