# Copied from src/repro/obs/decomposition.py; imports rebound to repro_torch.
"""Typed per-round phase decomposition (paper §IV-A, eq. 10 -> 12).

The paper's round-latency claim is a *phase* claim: FedLEO collapses
the sequential star schedule into overlapping broadcast / intra-plane
propagation / concurrent training / relay-to-sink / sink-wait / upload
phases.  Until ISSUE 7 the realized phase data lived in untyped
``HistoryPoint.events`` dicts scraped by one benchmark; this module is
the typed replacement:

  ``GroupDecomposition``   one plane's (or cluster's) milestones for
                           one round, with derived phase durations,
  ``RoundDecomposition``   all groups of one round plus the round span,
  ``decompose_group_plan`` builds a GroupDecomposition from a
                           ``PlanePlan`` or ``ClusterPlan`` (duck-typed
                           so this module never imports ``repro.core``).

Milestone semantics: phases are reported as deltas between *round
milestones* (max over the group's satellites), so concurrent per-sat
work overlaps inside them — e.g. ``train_s`` is the time from the last
model receipt to the last training completion, not the per-sat
training duration.  ``sink_wait_s`` splits into the window wait the
scheduler planned for (eq. 22's AW feasibility) and the
contention-queue delay the RB ledger added on top.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# phase name -> (start milestone attr, end milestone attr)
PHASES: Tuple[Tuple[str, str, str], ...] = (
    ("broadcast", "t_round_start", "t_broadcast_done"),
    ("propagate", "t_broadcast_done", "t_propagate_done"),
    ("train", "t_propagate_done", "t_train_done"),
    ("relay", "t_train_done", "t_models_at_sink"),
    ("sink_wait", "t_models_at_sink", "t_upload_start"),
    ("upload", "t_upload_start", "t_upload_done"),
)


@dataclasses.dataclass(frozen=True)
class GroupDecomposition:
    """One plane group's round milestones (absolute simulated seconds)
    and the derived phase durations.  A single-plane ring round has
    ``planes == (p,)``; a grid cluster lists every member plane."""

    planes: Tuple[int, ...]
    source: Tuple[int, int]         # (plane, slot) that received the DL
    sink: Tuple[int, int]           # (plane, slot) that uploads
    gs_index: int                   # station of the (first) upload leg
    t_round_start: float
    t_broadcast_done: float         # GS download at the source completes
    t_propagate_done: float         # last satellite holds the model
    t_train_done: float             # last local training completes
    t_models_at_sink: float         # last model relayed to the sink
    t_upload_start: float
    t_upload_done: float
    window_wait_s: float            # planned wait for the sink's window
    queue_delay_s: float            # RB-contention delay inside the window
    handover_legs: int              # >0: upload segmented across stations

    # -- derived phase durations ----------------------------------------------
    @property
    def broadcast_s(self) -> float:
        return self.t_broadcast_done - self.t_round_start

    @property
    def propagate_s(self) -> float:
        return self.t_propagate_done - self.t_broadcast_done

    @property
    def train_s(self) -> float:
        return self.t_train_done - self.t_propagate_done

    @property
    def relay_s(self) -> float:
        return self.t_models_at_sink - self.t_train_done

    @property
    def sink_wait_s(self) -> float:
        return self.t_upload_start - self.t_models_at_sink

    @property
    def upload_s(self) -> float:
        return self.t_upload_done - self.t_upload_start

    @property
    def round_s(self) -> float:
        return self.t_upload_done - self.t_round_start

    def phase_spans(self) -> List[Tuple[str, float, float]]:
        """(phase, t_start, t_end) triples in round order."""
        return [
            (name, getattr(self, a), getattr(self, b))
            for name, a, b in PHASES
        ]

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["planes"] = list(self.planes)
        d["source"] = list(self.source)
        d["sink"] = list(self.sink)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GroupDecomposition":
        return cls(
            planes=tuple(int(p) for p in d["planes"]),
            source=(int(d["source"][0]), int(d["source"][1])),
            sink=(int(d["sink"][0]), int(d["sink"][1])),
            gs_index=int(d["gs_index"]),
            t_round_start=float(d["t_round_start"]),
            t_broadcast_done=float(d["t_broadcast_done"]),
            t_propagate_done=float(d["t_propagate_done"]),
            t_train_done=float(d["t_train_done"]),
            t_models_at_sink=float(d["t_models_at_sink"]),
            t_upload_start=float(d["t_upload_start"]),
            t_upload_done=float(d["t_upload_done"]),
            window_wait_s=float(d["window_wait_s"]),
            queue_delay_s=float(d["queue_delay_s"]),
            handover_legs=int(d["handover_legs"]),
        )


@dataclasses.dataclass(frozen=True)
class RoundDecomposition:
    """All plane groups of one FL round plus the round span.  Rounds of
    strategies without a group planner (the star baselines, the async
    family) carry an empty ``groups`` tuple — the round span itself is
    still typed and traceable."""

    round_index: int
    t_start: float
    t_end: float
    groups: Tuple[GroupDecomposition, ...] = ()

    @property
    def round_s(self) -> float:
        return self.t_end - self.t_start

    def phase_means(self) -> Dict[str, float]:
        """Mean seconds per phase across the round's groups (empty dict
        for group-less rounds), plus the sink-wait split."""
        return mean_phase_seconds(self.groups)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "round_index": self.round_index,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "groups": [g.as_dict() for g in self.groups],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RoundDecomposition":
        return cls(
            round_index=int(d["round_index"]),
            t_start=float(d["t_start"]),
            t_end=float(d["t_end"]),
            groups=tuple(
                GroupDecomposition.from_dict(g) for g in d["groups"]
            ),
        )


def mean_phase_seconds(
    groups: Sequence[GroupDecomposition],
) -> Dict[str, float]:
    """Mean seconds per phase over ``groups`` — the summary the
    benchmarks fold into their BENCH rows.  Includes the sink-wait
    split (``window_wait_s`` vs ``queue_delay_s``) and the group count."""
    if not groups:
        return {}
    out: Dict[str, float] = {}
    for name, _, _ in PHASES:
        out[f"{name}_s_mean"] = float(
            np.mean([getattr(g, f"{name}_s") for g in groups])
        )
    out["window_wait_s_mean"] = float(
        np.mean([g.window_wait_s for g in groups])
    )
    out["queue_delay_s_mean"] = float(
        np.mean([g.queue_delay_s for g in groups])
    )
    out["round_s_mean"] = float(np.mean([g.round_s for g in groups]))
    out["groups"] = float(len(groups))
    return out


def decompose_group_plan(
    plan: Any, t_round_start: float
) -> GroupDecomposition:
    """Typed decomposition of one planned group round.

    Accepts a ``repro.core.fedleo.PlanePlan`` (decision: SinkDecision)
    or ``ClusterPlan`` (decision: ClusterSinkDecision) — duck-typed on
    their shared milestone fields so ``repro.obs`` never imports
    ``repro.core`` (the engine imports obs, not the reverse).

    ``queue_delay_s`` isolates the contention component of the sink
    wait: time from the later of model-arrival and window-open until
    the upload actually starts — zero without RB competition, positive
    when the ledger pushed the transfer behind other bookings."""
    d = plan.decision
    if hasattr(plan, "planes"):                 # ClusterPlan
        planes = tuple(int(p) for p in plan.planes)
        source = (int(plan.source[0]), int(plan.source[1]))
        sink = (int(d.sink.plane), int(d.sink.slot))
    else:                                       # PlanePlan
        planes = (int(plan.plane),)
        source = (int(plan.plane), int(plan.source_slot))
        sink = (int(plan.plane), int(d.sink_slot))
    segments = tuple(getattr(d, "segments", ()) or ())
    gs_index = (
        int(segments[0].gs_index) if segments
        else int(d.window.gs_index)
    )
    t_upload_start = float(d.t_upload_start)
    t_at_sink = float(d.t_models_at_sink)
    queue_delay_s = max(
        0.0, t_upload_start - max(t_at_sink, float(d.window.t_start))
    )
    return GroupDecomposition(
        planes=planes,
        source=source,
        sink=sink,
        gs_index=gs_index,
        t_round_start=float(t_round_start),
        t_broadcast_done=float(plan.t_source),
        t_propagate_done=float(np.max(plan.t_receive)),
        t_train_done=float(np.max(plan.t_train_done)),
        t_models_at_sink=t_at_sink,
        t_upload_start=t_upload_start,
        t_upload_done=float(d.t_upload_done),
        window_wait_s=float(d.t_wait),
        queue_delay_s=queue_delay_s,
        handover_legs=len(segments),
    )


def round_decomposition(
    round_index: int,
    t_start: float,
    t_end: float,
    groups: Optional[Sequence[GroupDecomposition]] = None,
) -> RoundDecomposition:
    """Assemble one round's decomposition (the engine's per-round call)."""
    return RoundDecomposition(
        round_index=int(round_index),
        t_start=float(t_start),
        t_end=float(t_end),
        groups=tuple(groups or ()),
    )
