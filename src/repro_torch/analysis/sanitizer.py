# Copied from src/repro/analysis/sanitizer.py; imports rebound to repro_torch.
"""Runtime schedule sanitizer: the paper's feasibility constraints as
machine-checked invariants over a live ``CommsEnvironment`` session.

Five PRs of scheduler growth left the constraints enforced implicitly
across many code paths; the sanitizer re-derives each one independently
from the committed ``TransferDecision``/``Reservation`` stream, so a
planner bug cannot certify its own schedule:

  * **RB capacity** (eqs. 13-16): no station's concurrent resource-block
    occupancy ever exceeds the ledger capacity ``N`` — checked by an
    interval sweep over the sanitizer's OWN tracking of active legs,
    not by asking the ledger.
  * **Window containment** (eq. 15): every transfer leg lies inside a
    predictor visibility window of its satellite at the leg's tagged
    ``gs_index`` (and download spans inside their broadcast window).
  * **Segment discipline**: segmented (station-handover) uploads are
    time-ordered, non-overlapping, station-switching between
    consecutive legs, positive-payload per leg, inside their recorded
    access windows, and conserve the payload bits end to end.
  * **Reservation hygiene**: every ``commit`` is matched by completion
    or ``release`` — ``finish`` reports reservations still booked
    entirely beyond the end of the simulation (a leaked booking wastes
    capacity forever) unless the strategy declared them as its live
    async queue.
  * **Re-admission monotonicity** (eqs. 21-22 completion races):
    ``CommsEnvironment.readmit`` never makes any queued upload
    complete later than its original booking.

The sanitizer hooks the session at its three choke points — ``commit``
interception, the release path (the same event the ``on_release``
callbacks observe), and ``readmit`` — so it sees exactly the booking
stream the ledger does.  It only *reads* predictor state (never
extends a rolling horizon), so a sanitized run stays bit-identical to
an unsanitized one.

Wiring: ``SimConfig.sanitize`` (on by default — tier-1 tests and the
``--quick`` benchmark smokes run sanitized; the timed benchmark arms
construct their sessions with ``sanitize=False``).  ``strict=True``
(default) raises ``ScheduleViolation`` at the first broken invariant;
``strict=False`` collects violations for ``report()``.
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

if TYPE_CHECKING:                        # no runtime cycle with comms
    from repro_torch.comms.environment import CommsEnvironment, Reservation

Leg = Tuple[int, float, float]           # (gs_index, t_start, t_end)


class ScheduleViolation(AssertionError):
    """A schedule broke one of the paper's feasibility invariants."""


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: which rule, where, and what happened.
    ``job`` attributes the violation to the owning multi-tenant job
    (the session's ``CommsEnvironment.job`` label; None standalone) —
    a leak report over N concurrent sessions names the job that leaked.
    """

    rule: str                            # e.g. "rb-capacity"
    message: str
    rid: Optional[int] = None            # offending reservation, if any
    job: Optional[str] = None            # owning multi-tenant job, if any

    def __str__(self) -> str:
        where = f" (reservation {self.rid})" if self.rid is not None else ""
        owner = f" job={self.job}" if self.job is not None else ""
        return f"[{self.rule}]{where}{owner} {self.message}"


@dataclasses.dataclass
class _TrackedReservation:
    """The sanitizer's own record of one commit."""

    rid: int
    decision: Any
    t_start: float                       # transfer start (absolute s)
    t_done: float                        # transfer completion (absolute s)
    released: bool = False


def _decision_span(decision: Any) -> Tuple[float, float]:
    """(t_start, t_done) of any decision type (``TransferDecision``
    carries them directly; sink decisions as ``t_upload_*``)."""
    if hasattr(decision, "t_upload_start"):
        return (
            float(decision.t_upload_start), float(decision.t_upload_done)
        )
    return float(decision.t_start), float(decision.t_done)


def _decision_sat(decision: Any) -> Tuple[int, int]:
    """(plane, slot) of the transferring satellite: the sink for
    cluster decisions, the plane sink slot for ``SinkDecision``, the
    window's satellite for a plain ``TransferDecision``."""
    sink = getattr(decision, "sink", None)
    if sink is not None:                 # ClusterSinkDecision
        return int(sink.plane), int(sink.slot)
    if hasattr(decision, "sink_slot"):   # SinkDecision
        return int(decision.plane), int(decision.sink_slot)
    w = decision.window
    return int(w.plane), int(w.slot)


def _max_overlap(
    intervals: Iterable[Tuple[float, float]], t0: float, t1: float
) -> int:
    """Maximum concurrency of ``intervals`` over the half-open span
    ``[t0, t1)`` (touching endpoints never count as concurrent)."""
    events: List[Tuple[float, int]] = []
    for a, b in intervals:
        lo, hi = max(a, t0), min(b, t1)
        if hi > lo:
            events.append((lo, 1))
            events.append((hi, -1))
    events.sort()                        # (-1) sorts before (+1) at ties
    cur = best = 0
    for _, delta in events:
        cur += delta
        best = max(best, cur)
    return best


class ScheduleSanitizer:
    """Invariant checker attached to one ``CommsEnvironment`` session.

    The session calls ``observe_commit`` / ``observe_release`` /
    ``observe_readmit`` from its lifecycle methods; a strategy (or
    benchmark) closes the books with ``finish``.  All checks re-derive
    the invariant from first principles — the ledger is never asked to
    certify its own bookings.
    """

    def __init__(
        self,
        env: "CommsEnvironment",
        *,
        strict: bool = True,
        eps: float = 1e-6,
    ):
        self.env = env
        self.strict = bool(strict)
        self.eps = float(eps)
        self.violations: List[Violation] = []
        self._tracked: Dict[int, _TrackedReservation] = {}
        # station -> active (t0, t1, rid) legs, the sanitizer's own
        # occupancy model (released spans are truncated out)
        self._active: Dict[int, List[Tuple[float, float, int]]] = {}

    @classmethod
    def attach(
        cls, env: "CommsEnvironment", *, strict: bool = True
    ) -> "ScheduleSanitizer":
        """Create a sanitizer and install it on the session."""
        san = cls(env, strict=strict)
        env.sanitizer = san
        return san

    # -- reporting -------------------------------------------------------------
    def report(self) -> List[Violation]:
        """Every violation observed so far (empty = clean)."""
        return list(self.violations)

    def _fail(self, rule: str, message: str,
              rid: Optional[int] = None) -> None:
        v = Violation(
            rule=rule, message=message, rid=rid,
            job=getattr(self.env, "job", None),
        )
        self.violations.append(v)
        if self.strict:
            raise ScheduleViolation(str(v))

    # -- commit-time checks ----------------------------------------------------
    def observe_commit(self, reservation: "Reservation") -> None:
        """Validate one committed decision and start tracking it."""
        decision = reservation.decision
        rid = reservation.rid
        if decision is None:
            return                       # bare reservation: nothing to check
        t_start, t_done = _decision_span(decision)
        if t_done < t_start - self.eps:
            self._fail(
                "segment-order",
                f"transfer completes before it starts "
                f"({t_start:.3f} -> {t_done:.3f})",
                rid,
            )
        self._check_segments(decision, rid)
        self._check_containment(decision, reservation.legs, rid)
        self._check_capacity(reservation.legs, rid)
        self._tracked[rid] = _TrackedReservation(
            rid=rid, decision=decision, t_start=t_start, t_done=t_done,
        )

    def _check_segments(self, decision: Any, rid: int) -> None:
        """Segmented-handover discipline: ordered, disjoint,
        station-switching, positive, window-respecting legs that
        conserve the payload bits."""
        segments = tuple(getattr(decision, "segments", ()) or ())
        if not segments:
            return
        prev = None
        for s in segments:
            if s.t_end <= s.t_start + self.eps:
                self._fail(
                    "segment-order",
                    f"leg on station {s.gs_index} has non-positive span "
                    f"[{s.t_start:.3f}, {s.t_end:.3f})",
                    rid,
                )
            if s.bits <= 0:
                self._fail(
                    "payload-conservation",
                    f"leg on station {s.gs_index} delivers "
                    f"{s.bits} bits (must be positive)",
                    rid,
                )
            if not (
                s.window_start - self.eps <= s.t_start
                and s.t_end <= s.window_end + self.eps
            ):
                self._fail(
                    "window-containment",
                    f"leg [{s.t_start:.3f}, {s.t_end:.3f}) lies outside "
                    f"its recorded access window "
                    f"[{s.window_start:.3f}, {s.window_end:.3f}]",
                    rid,
                )
            if prev is not None:
                if s.t_start < prev.t_end - self.eps:
                    self._fail(
                        "segment-order",
                        f"legs overlap: [{prev.t_start:.3f}, "
                        f"{prev.t_end:.3f}) then [{s.t_start:.3f}, "
                        f"{s.t_end:.3f})",
                        rid,
                    )
                if s.gs_index == prev.gs_index:
                    self._fail(
                        "segment-order",
                        f"consecutive legs stay on station {s.gs_index} "
                        "(a handover must switch stations)",
                        rid,
                    )
            prev = s
        payload = getattr(decision, "payload_bits", None)
        if payload is not None:
            total = float(sum(s.bits for s in segments))
            if abs(total - float(payload)) > max(1.0, float(payload)) * 1e-6:
                self._fail(
                    "payload-conservation",
                    f"segmented legs deliver {total:.1f} bits of a "
                    f"{float(payload):.1f}-bit payload",
                    rid,
                )

    def _containment_legs(
        self, decision: Any, legs: Tuple[Leg, ...]
    ) -> Tuple[Leg, ...]:
        """The spans to check against the window table: the booked RB
        legs, or — for download broadcasts, which book nothing — the
        decision span on its window's station."""
        if legs:
            return legs
        w = getattr(decision, "window", None)
        if w is None:
            return ()
        t_start, t_done = _decision_span(decision)
        return ((int(w.gs_index), t_start, t_done),)

    def _check_containment(
        self, decision: Any, legs: Tuple[Leg, ...], rid: int
    ) -> None:
        """Eq. 15: every leg inside a predictor visibility window of
        its satellite at the leg's tagged station."""
        spans = self._containment_legs(decision, legs)
        if not spans:
            return
        plane, slot = _decision_sat(decision)
        rec = self.env.predictor.sat_arrays(plane, slot)
        for gi, t0, t1 in spans:
            ok = False
            if rec is not None:
                m = (
                    (rec["gs_index"] == gi)
                    & (rec["starts"] <= t0 + self.eps)
                    & (rec["ends"] >= t1 - self.eps)
                )
                ok = bool(m.any())
            if not ok:
                self._fail(
                    "window-containment",
                    f"leg [{t0:.3f}, {t1:.3f}) of satellite "
                    f"({plane}, {slot}) lies inside no visibility window "
                    f"of station {gi}",
                    rid,
                )

    def _check_capacity(self, legs: Tuple[Leg, ...], rid: int) -> None:
        """Eqs. 13-16: adding these legs must keep every station's
        concurrent RB occupancy within the ledger capacity.  Legs are
        admitted one at a time so a decision overlapping itself on one
        station is caught too."""
        ledger = self.env.ledger
        # per-station capacity tuple, or None for unlimited/no ledger
        caps = None if ledger is None else ledger.capacity
        for gi, t0, t1 in legs:
            active = self._active.setdefault(int(gi), [])
            if caps is not None:
                cap = float(caps[int(gi)])
                occupancy = 1 + _max_overlap(
                    ((a, b) for a, b, _ in active), float(t0), float(t1)
                )
                if occupancy > cap + 1e-9:
                    self._fail(
                        "rb-capacity",
                        f"station {gi} would run {occupancy} concurrent "
                        f"RBs over [{t0:.3f}, {t1:.3f}) "
                        f"(capacity {cap:g})",
                        rid,
                    )
            active.append((float(t0), float(t1), rid))

    # -- release / readmit hooks -----------------------------------------------
    def observe_release(
        self, reservation: "Reservation", freed: Tuple[Leg, ...]
    ) -> None:
        """Mirror a release: freed spans leave the occupancy model and
        the reservation counts as resolved."""
        rec = self._tracked.get(reservation.rid)
        if rec is not None:
            rec.released = True
        for gi, f0, f1 in freed:
            active = self._active.get(int(gi))
            if active is None:
                continue
            kept: List[Tuple[float, float, int]] = []
            for a, b, rid in active:
                if rid != reservation.rid or b <= f0 or a >= f1:
                    kept.append((a, b, rid))
                    continue
                if a < f0:               # spent head stays booked
                    kept.append((a, f0, rid))
                if b > f1:
                    kept.append((f1, b, rid))
            self._active[int(gi)] = kept

    def observe_readmit(
        self,
        before: Sequence[Tuple[Any, float]],
        after: Sequence[Tuple[Any, float]],
    ) -> None:
        """Eqs. 21-22 monotonicity: re-admission never regresses any
        queued upload's completion (positionally aligned lists)."""
        for (key, t_old), (_key, t_new) in zip(before, after):
            if t_new > t_old + 1e-9:
                self._fail(
                    "readmit-regression",
                    f"re-admission moved upload {key!r} from completion "
                    f"{t_old:.3f} to {t_new:.3f} (later)",
                )

    # -- end of simulation -----------------------------------------------------
    def finish(
        self,
        t_end: float,
        open_rids: FrozenSet[int] = frozenset(),
        check_leaks: bool = True,
    ) -> List[Violation]:
        """Close the books at simulated time ``t_end``.

        A reservation is resolved when it was released or its transfer
        ran (started by ``t_end`` — the booked span is exactly the
        transfer, so a started transfer completes by construction).  A
        booking that never started and was never released leaked
        capacity — unless the strategy declared it as part of its live
        async queue (``open_rids``: uploads legitimately booked beyond
        the end of the simulation).  ``check_leaks=False`` skips the
        leak report (a run abandoned mid-round leaves its final
        half-planned bookings behind by design).  Returns every
        violation recorded over the session.
        """
        if check_leaks:
            for rid, rec in sorted(self._tracked.items()):
                if rec.released or rid in open_rids:
                    continue
                if rec.t_start > t_end + self.eps:
                    self._fail(
                        "reservation-leak",
                        f"booking [{rec.t_start:.3f}, {rec.t_done:.3f}) "
                        f"never started by sim end {t_end:.3f} and was "
                        "never released",
                        rid,
                    )
        return self.report()
