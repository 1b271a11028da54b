# Copied from src/repro/obs/trace.py; imports rebound to repro_torch.
"""TraceRecorder: typed, sim-timestamped scheduling events.

The observability substrate of the repo (ISSUE 7): one recorder per
``CommsEnvironment`` session collects every scheduling action as a
typed ``TraceEvent`` on a named *track* —

  plan        ``plan_upload``/``plan_download`` queries and their
              outcome (instant, on the plane's track),
  commit      booked reservation legs (one span per RB leg, on the
              station's track; ``handover_legs`` > 1 marks a
              station-switching upload),
  release /   capacity lifecycle events of the session ledger,
  readmit
  horizon     rolling-horizon extensions of the ``VisibilityPredictor``
              (plus per-method query counters),
  round       one span per FL round with its ``RoundDecomposition``
              and evaluation metrics attached,
  log         the engine's structured verbose round log.

Everything is keyed to the SIMULATED clock — the recorder never reads
wall time (``repro.analysis.lint`` bans it here too; the single
sanctioned wall-clock shim is ``repro.obs._walltime``, used only to
stamp exported trace files with their recording time).

Zero-interference discipline (the PR 6 sanitizer contract): the
recorder only *appends to its own state* and *reads* scheduling
objects; no hook mutates a schedule, a ledger or the predictor, so a
traced run is bit-identical to an untraced one (equivalence-tested in
``tests/test_obs_trace.py``).  When tracing is off every hook site
guards on ``recorder is None`` / dispatches to ``NULL_RECORDER``.
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Tuple,
)

from repro_torch.obs.decomposition import RoundDecomposition

if TYPE_CHECKING:
    from repro_torch.comms.environment import CommsEnvironment, Reservation
    from repro_torch.orbits.constellation import Satellite

TRACE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One sim-timestamped event.  ``t_start_s == t_end_s`` marks an
    instant; a span covers ``[t_start_s, t_end_s]`` (absolute simulated
    seconds).  ``track`` names the timeline the event belongs to
    ("rounds", "plane/3", "gs/0", "predictor", ...) — the Perfetto
    exporter maps tracks to process/thread rows."""

    seq: int
    kind: str
    track: str
    name: str
    t_start_s: float
    t_end_s: float
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t_end_s - self.t_start_s

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "kind": self.kind,
            "track": self.track,
            "name": self.name,
            "t0": self.t_start_s,
            "t1": self.t_end_s,
            "attrs": dict(self.attrs),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TraceEvent":
        return cls(
            seq=int(d["seq"]), kind=str(d["kind"]), track=str(d["track"]),
            name=str(d["name"]), t_start_s=float(d["t0"]),
            t_end_s=float(d["t1"]), attrs=dict(d.get("attrs") or {}),
        )


def _sat_track(plane: int) -> str:
    return f"plane/{plane}"


# interned "predictor.<method>" counter keys (hot-path allocation saver)
_PREDICTOR_KEYS: Dict[str, str] = {}


class TraceRecorder:
    """Collects ``TraceEvent``s and named counters for one scheduling
    session.  Construct directly for ad-hoc use, or let
    ``TraceRecorder.attach(env)`` wire it into a ``CommsEnvironment``
    (plan/commit/release/readmit hooks), its ``VisibilityPredictor``
    (horizon extensions + query counters) and the routing-table cache
    (hit/miss counters)."""

    def __init__(
        self,
        meta: Optional[Mapping[str, Any]] = None,
        job: Optional[str] = None,
    ):
        self.events: List[TraceEvent] = []
        self.counters: Dict[str, int] = {}
        self.meta: Dict[str, Any] = dict(meta or {})
        # multi-tenant job label (``CommsEnvironment.job``): when set,
        # every emitted event carries a ``job`` attr so traces of
        # concurrent sessions merge attributably.  None adds nothing —
        # single-tenant traces stay byte-identical.
        self.job = job
        self._seq = 0
        self._detachers: List[Callable[[], None]] = []

    # -- primitive emitters ----------------------------------------------------
    def span(
        self, kind: str, track: str, name: str,
        t_start_s: float, t_end_s: float, **attrs: Any,
    ) -> None:
        self._seq += 1
        if self.job is not None:
            attrs = {**attrs, "job": self.job}
        self.events.append(TraceEvent(
            self._seq, kind, track, name, float(t_start_s),
            float(t_end_s), attrs,
        ))

    def instant(
        self, kind: str, track: str, name: str, t_s: float, **attrs: Any
    ) -> None:
        self.span(kind, track, name, t_s, t_s, **attrs)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    # -- CommsEnvironment hooks ------------------------------------------------
    def on_plan(
        self,
        direction: str,
        sat: "Satellite",
        t_request_s: float,
        decision: Optional[Any],
    ) -> None:
        """A ``plan_upload``/``plan_download`` query and its outcome
        (``decision=None`` = infeasible inside the horizon)."""
        self.count(f"plan_{direction}")
        attrs: Dict[str, Any] = {
            "plane": int(sat.plane), "slot": int(sat.slot),
            "feasible": decision is not None,
        }
        if decision is not None:
            attrs["t_xfer_start_s"] = float(decision.t_start)
            attrs["t_xfer_done_s"] = float(decision.t_done)
            attrs["legs"] = len(decision.legs)
        self.instant(
            "plan", _sat_track(int(sat.plane)), f"plan-{direction}",
            t_request_s, **attrs,
        )

    def on_commit(self, reservation: "Reservation") -> None:
        """A booked decision: one span per RB leg on the station's
        track.  More than one leg marks a mid-window station handover
        (the segmented upload planner switched stations)."""
        self.count("commit")
        legs = reservation.legs
        if len(legs) > 1:
            self.count("handover_switches", len(legs) - 1)
        for i, (gi, t0, t1) in enumerate(legs):
            self.span(
                "commit", f"gs/{int(gi)}", f"upload r{reservation.rid}",
                t0, t1, rid=reservation.rid, leg=i, legs=len(legs),
            )

    def on_release(
        self,
        reservation: "Reservation",
        freed: Tuple[Tuple[int, float, float], ...],
    ) -> None:
        self.count("release")
        for gi, t0, t1 in freed:
            self.span(
                "release", f"gs/{int(gi)}", f"release r{reservation.rid}",
                t0, t1, rid=reservation.rid,
            )

    def on_readmit(
        self, t_now_s: float, n_pending: int, repriced: int
    ) -> None:
        self.count("readmit_passes")
        self.count("readmit_repriced", repriced)
        self.instant(
            "readmit", "rounds", "readmit", t_now_s,
            pending=n_pending, repriced=repriced,
        )

    # -- VisibilityPredictor hooks ---------------------------------------------
    def on_horizon_extend(
        self, t_built_end_s: float, t_new_end_s: float
    ) -> None:
        self.count("horizon_extensions")
        self.instant(
            "horizon", "predictor", "extend",
            t_built_end_s, t_new_end_s=float(t_new_end_s),
        )

    def on_predictor_query(self, method: str) -> None:
        # hottest hook in the repo (thousands of calls per pricing
        # pass): interned key + inline increment, no f-string per call
        key = _PREDICTOR_KEYS.get(method)
        if key is None:
            key = _PREDICTOR_KEYS[method] = "predictor." + method
        counters = self.counters
        counters[key] = counters.get(key, 0) + 1

    # -- routing-cache hook ----------------------------------------------------
    def on_routing_cache(self, hit: bool) -> None:
        self.count("routing_cache_hits" if hit else "routing_cache_misses")

    # -- engine hooks ----------------------------------------------------------
    def on_round(
        self,
        decomposition: RoundDecomposition,
        metrics: Optional[Mapping[str, float]] = None,
    ) -> None:
        """One FL round: a span on the "rounds" track carrying the full
        typed decomposition, plus per-group phase spans on the group's
        plane track."""
        self.count("rounds")
        d = decomposition
        attrs: Dict[str, Any] = {"decomposition": d.as_dict()}
        if metrics:
            attrs["metrics"] = {k: float(v) for k, v in metrics.items()}
        self.span(
            "round", "rounds", f"round {d.round_index}",
            d.t_start, d.t_end, **attrs,
        )
        for g in d.groups:
            track = _sat_track(g.planes[0])
            label = (
                f"p{g.planes[0]}" if len(g.planes) == 1
                else "c" + "+".join(str(p) for p in g.planes)
            )
            for phase, t0, t1 in g.phase_spans():
                self.span(
                    "phase", track, f"{phase} {label}", t0, t1,
                    round=d.round_index, gs_index=g.gs_index,
                )

    def on_round_log(self, record: Mapping[str, Any]) -> None:
        """The engine's structured verbose round log."""
        self.instant(
            "log", "rounds", "round-log",
            float(record["t_hours"]) * 3600.0, **dict(record),
        )

    # -- session wiring --------------------------------------------------------
    @classmethod
    def attach(cls, env: "CommsEnvironment") -> "TraceRecorder":
        """Create a recorder and wire it into ``env``: the environment's
        plan/commit/release/readmit hook points, its predictor's
        horizon/query hooks, and the module-level routing-cache
        listener.  Station/constellation metadata lands in ``meta``.
        Returns the recorder (also reachable as ``env.recorder``)."""
        from repro_torch.comms import routing

        cfg = env.walker.config
        meta: Dict[str, Any] = {
            "schema": TRACE_SCHEMA_VERSION,
            "num_planes": int(cfg.num_planes),
            "sats_per_plane": int(cfg.sats_per_plane),
            "stations": [g.name for g in env.ground_stations],
        }
        if env.ledger is not None:
            meta["rb_capacity"] = [
                (None if float(c) == float("inf") else int(c))
                for c in env.ledger.capacity
            ]
        if env.job is not None:
            meta["job"] = env.job
        recorder = cls(meta, job=env.job)
        env.recorder = recorder
        env.predictor.recorder = recorder
        recorder._detachers.append(
            routing.on_routing_cache(recorder.on_routing_cache)
        )

        def _detach_env(e: "CommsEnvironment" = env) -> None:
            if e.recorder is recorder:
                e.recorder = None
            if e.predictor.recorder is recorder:
                e.predictor.recorder = None

        recorder._detachers.append(_detach_env)
        return recorder

    def detach(self) -> None:
        """Unhook from everything ``attach`` wired up (idempotent).
        The collected events/counters stay readable."""
        for d in self._detachers:
            d()
        self._detachers = []


class _NullRecorder(TraceRecorder):
    """The disabled recorder: every hook is a no-op and nothing is ever
    stored — the ``SimConfig.trace=False`` path pays one virtual call
    at the few engine-level sites and nothing anywhere else (the
    environment/predictor hooks guard on ``recorder is None`` and are
    never entered)."""

    def span(
        self, kind: str, track: str, name: str,
        t_start_s: float, t_end_s: float, **attrs: Any,
    ) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def on_predictor_query(self, method: str) -> None:
        pass

    def on_round(
        self,
        decomposition: RoundDecomposition,
        metrics: Optional[Mapping[str, float]] = None,
    ) -> None:
        pass

    def detach(self) -> None:
        pass


NULL_RECORDER = _NullRecorder()


# --- structured round logging (the engine's verbose path) ----------------------
def round_log_record(
    strategy: str,
    round_index: int,
    t_hours: float,
    metrics: Mapping[str, float],
) -> Dict[str, Any]:
    """The engine's per-round log as a typed record (what lands in the
    trace; ``format_round_line`` renders it for humans)."""
    return {
        "strategy": strategy,
        "round": int(round_index),
        "t_hours": float(t_hours),
        "accuracy": float(metrics["accuracy"]),
        "loss": float(metrics["loss"]),
    }


def format_round_line(record: Mapping[str, Any]) -> str:
    """Human-readable rendering — byte-identical to the engine's
    historical ``verbose`` print format."""
    return (
        f"[{record['strategy']}] round {record['round']:3d} "
        f"t={record['t_hours']:7.2f}h acc={record['accuracy']:.4f} "
        f"loss={record['loss']:.4f}"
    )
