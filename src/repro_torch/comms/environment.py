# Copied from src/repro/comms/environment.py; imports rebound to repro_torch.
"""CommsEnvironment: the scheduling *session* of the simulation.

The paper's scheduler (eqs. 13-22) grew across PRs 1-4 as free
functions in ``core/scheduling.py`` that each re-thread the same
``(walker, predictor, gs, ledger, handover, ...)`` tuple through every
strategy; ``core/baselines.py`` even carried a ``_SELF_LEDGER``
sentinel to guess which ledger a call meant.  Nothing *owned* the
reservations, so nothing could observe a release and re-plan — the
structural blocker for ledger-aware async re-admission (FedSpace,
So et al. 2022; AsyncFLEO, Elmahallawy & Luo 2024: asynchronous LEO FL
hinges on re-pricing queued uploads as link state changes).

``CommsEnvironment`` is the stateful session that owns those parts:

  * the ``VisibilityPredictor`` (access-window table, rolling horizon),
  * the ``GSResourceLedger`` (per-station RB occupancy),
  * the link/ISL budgets and the station-handover policy,

constructed once per simulation (``CommsEnvironment.from_sim``) and
shared by every planning call of a strategy.  The API:

  planning    ``plan_upload`` / ``plan_download`` -> TransferDecision,
              ``select_sink`` / ``select_sink_cluster``,
              ``first_visible_download(_sats)``, ``naive_sink_slot``
  lifecycle   ``commit(decision) -> Reservation``,
              ``release(reservation, at=...)`` — frees the booked RB
              intervals and fires every registered ``on_release``
              callback, and
  events      ``on_release(callback)`` — observe capacity releases;
              ``readmit(pending, t_now)`` — the event-driven async
              re-admission engine built on top of them.

The planners only *read* residual capacity; ``commit`` is the one
booking rule (per-leg intervals for segmented uploads).  All methods
delegate to the same private machinery in ``core/scheduling.py`` that
the legacy free functions now shim, so an environment-planned schedule
is bit-identical to the pre-session scheduler when no release events
fire (equivalence-tested).
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from repro_torch.comms.isl import ISLConfig, isl_hop_time
from repro_torch.comms.ledger import GSResourceLedger
from repro_torch.comms.link import LinkConfig, downlink_time, uplink_time
from repro_torch.orbits.constellation import (
    GroundStation,
    MultiShellWalker,
    Satellite,
    WalkerDelta,
    make_walker,
)
from repro_torch.orbits.prediction import (
    GroundStations,
    VisibilityPredictor,
    as_gs_list,
)
from repro_torch.orbits.visibility import DEFAULT_MEM_BUDGET_MB, VisibilityWindow

if TYPE_CHECKING:
    from repro_torch.analysis.sanitizer import ScheduleSanitizer, Violation
    from repro_torch.core.engine import SimConfig
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.core.scheduling import (
        ClusterSinkDecision,
        HandoverSpec,
        SinkDecision,
    )

_UNSET: Any = object()

# (gs_index, slant_range_m) -> (window seconds needed, transfer seconds)
TransferTime = Callable[[int, float], Tuple[float, float]]
# window predicate: True = exclude this window from the search
SkipWindow = Optional[Callable[[VisibilityWindow], bool]]


def _sched() -> Any:
    """Lazy handle on ``repro.core.scheduling`` (the shared planning
    machinery).  Imported at call time: the core modules import this
    module at their top level, so a module-level import here would be
    circular."""
    from repro_torch.core import scheduling

    return scheduling


# --- typed decisions / reservations -------------------------------------------
Leg = Tuple[int, float, float]          # (gs_index, t_start, t_end)


@dataclasses.dataclass(frozen=True)
class TransferDecision:
    """One planned point-to-point transfer: start, completion, the
    access window it rides (the first leg's window when the upload was
    split across station handovers) and the handover legs (empty for a
    single-window transfer).  ``direction`` is "up" (satellite -> GS,
    RB-contended) or "down" (GS broadcast, never contended)."""

    direction: str
    t_start: float
    t_done: float
    window: VisibilityWindow
    segments: Tuple[Any, ...] = ()      # TransferSegment legs
    payload_bits: Optional[float] = None

    @property
    def legs(self) -> Tuple[Leg, ...]:
        """The RB intervals this transfer occupies when committed —
        one per handover leg, or the single ``[t_start, t_done)`` span.
        Downloads are full-band broadcasts (eq. 15) and occupy none."""
        if self.direction != "up":
            return ()
        if self.segments:
            return tuple(
                (s.gs_index, s.t_start, s.t_end) for s in self.segments
            )
        return ((self.window.gs_index, self.t_start, self.t_done),)


@dataclasses.dataclass
class Reservation:
    """A committed booking: the ledger intervals one decision occupies.
    Handed back to ``release`` to free the capacity again.

    ``bids`` are the per-leg ledger booking ids (None for legs that
    occupied nothing — downloads, no ledger): under multi-tenancy two
    sessions can book IDENTICAL intervals on one shared station, so
    releases are keyed on id, never on interval equality."""

    rid: int
    legs: Tuple[Leg, ...]
    decision: Any = None
    released: bool = False
    bids: Tuple[Optional[int], ...] = ()


@dataclasses.dataclass(frozen=True)
class PendingUpload:
    """One queued (planned + committed, not yet transmitted) upload of
    an asynchronous strategy — the unit ``readmit`` re-prices."""

    key: Any                    # caller's identity (client id, plane, ...)
    sat: Satellite
    t_ready: float              # model ready for upload (absolute s)
    payload_bits: float
    decision: TransferDecision
    reservation: Reservation


def _decision_legs(decision: Any) -> Tuple[Leg, ...]:
    """Booked intervals of any decision type: ``TransferDecision``
    (its ``legs``), or a ``SinkDecision``/``ClusterSinkDecision``
    (per-segment legs, else the single upload span)."""
    if isinstance(decision, TransferDecision):
        return decision.legs
    segments = getattr(decision, "segments", ())
    if segments:
        return tuple((s.gs_index, s.t_start, s.t_end) for s in segments)
    return (
        (
            decision.window.gs_index,
            decision.t_upload_start,
            decision.t_upload_done,
        ),
    )


class CommsEnvironment:
    """Stateful scheduling session: predictor + ledger + link budgets +
    handover policy behind one typed planning/booking API.

    Args:
      walker: the constellation geometry.
      predictor: the access-window table — THE authority on the ground
        segment (every window carries its station's ``gs_index``).
      link: GS link budget (required by the upload/download/sink
        planners; may be None for a bare transfer-planning session).
      isl: intra-plane ISL budget (ring hop metric of ``select_sink``).
      ledger: shared per-station RB occupancy, or None for the
        contention-free degenerate case.
      handover: default mid-window station-handover policy
        (``SimConfig.gs_handover``); per-call override available.
      gs: optional ground station(s) the caller *believes* the session
        covers — validated against the predictor's ground segment (the
        check formerly duplicated at every free-function entry point).
    """

    def __init__(
        self,
        *,
        walker: "WalkerDelta | MultiShellWalker",
        predictor: VisibilityPredictor,
        link: Optional[LinkConfig] = None,
        isl: Optional[ISLConfig] = None,
        ledger: Optional[GSResourceLedger] = None,
        handover: bool = False,
        gs: Optional[GroundStations] = None,
    ):
        if gs is not None:
            assert tuple(as_gs_list(gs)) == predictor.ground_stations, \
                "predictor was built over a different ground segment"
        if ledger is not None and ledger.num_stations != len(
            predictor.ground_stations
        ):
            raise ValueError(
                f"ledger covers {ledger.num_stations} stations, predictor "
                f"{len(predictor.ground_stations)}"
            )
        self.walker = walker
        self.predictor = predictor
        self.link = link
        self.isl = isl
        self.ledger = ledger
        self.handover = bool(handover)
        self._release_listeners: List[Callable] = []
        self._commit_listeners: List[Callable] = []
        self._next_rid = 0
        # multi-tenant job label: set by ``derive(job=...)`` (the
        # JobScheduler's per-job sessions) so the sanitizer and trace
        # recorder can attribute bookings/leaks to the owning job.
        # None for single-tenant sessions — every hook site treats
        # None as "no tag" and stays bit-identical.
        self.job: Optional[str] = None
        # invariant checker (repro.analysis.sanitizer), installed by
        # from_sim/derive(sanitize=True) or ScheduleSanitizer.attach
        self.sanitizer: Optional["ScheduleSanitizer"] = None
        # observability recorder (repro.obs), installed by
        # from_sim(trace=True)/derive(trace=True) or
        # TraceRecorder.attach.  Read-only observer: every hook site
        # guards on None, so the untraced path pays one branch and the
        # traced path stays bit-identical (the recorder never mutates
        # scheduling state).
        self.recorder: Optional["TraceRecorder"] = None

    @classmethod
    def from_sim(cls, sim: "SimConfig",
                 walker: "WalkerDelta | MultiShellWalker | None" = None
                 ) -> "CommsEnvironment":
        """The session of one ``SimConfig``: predictor over the sim's
        ground segment (rolling when ``rolling_horizon_hours`` is set),
        a shared RB ledger when ``gs_rb_capacity`` caps station
        capacity, and the sim's handover policy."""
        if walker is None:
            walker = make_walker(sim.constellation)
        gs_list = list(sim.all_ground_stations)
        max_horizon_s = sim.horizon_hours * 3600.0 * 1.5
        mem_budget_mb = getattr(sim, "mem_budget_mb", DEFAULT_MEM_BUDGET_MB)
        if sim.rolling_horizon_hours is not None:
            predictor = VisibilityPredictor(
                walker,
                gs_list,
                horizon_s=sim.rolling_horizon_hours * 3600.0,
                coarse_step_s=sim.coarse_step_s,
                rolling=True,
                max_horizon_s=max_horizon_s,
                mem_budget_mb=mem_budget_mb,
            )
        else:
            predictor = VisibilityPredictor(
                walker, gs_list, horizon_s=max_horizon_s,
                coarse_step_s=sim.coarse_step_s,
                mem_budget_mb=mem_budget_mb,
            )
        ledger = (
            GSResourceLedger(len(gs_list), sim.gs_rb_capacity)
            if sim.gs_rb_capacity is not None else None
        )
        env = cls(
            walker=walker, predictor=predictor, link=sim.link, isl=sim.isl,
            ledger=ledger, handover=sim.gs_handover, gs=gs_list,
        )
        if getattr(sim, "sanitize", False):
            from repro_torch.analysis.sanitizer import ScheduleSanitizer

            ScheduleSanitizer.attach(env)
        if getattr(sim, "trace", False):
            from repro_torch.obs.trace import TraceRecorder

            TraceRecorder.attach(env)
        return env

    @property
    def ground_stations(self) -> Tuple[GroundStation, ...]:
        return self.predictor.ground_stations

    def derive(self, *, ledger: Any = _UNSET, handover: Any = _UNSET,
               link: Any = _UNSET, isl: Any = _UNSET,
               sanitize: bool = False,
               trace: bool = False,
               job: Optional[str] = None) -> "CommsEnvironment":
        """Sibling session sharing this one's walker/predictor/budgets
        but with its OWN booking state: by default the new session gets
        a fresh, empty ledger of the parent's capacity (no ledger stays
        no ledger), so derived arms never see each other's bookings —
        how benchmarks price the same window table under different
        contention regimes.  Pass ``ledger=...`` to override — the
        multi-tenant JobScheduler passes the SHARED ledger so every
        job's session competes for the same RB pools (booking ids keep
        identical intervals distinguishable).  ``sanitize=True``
        attaches a fresh ``ScheduleSanitizer``; ``trace=True`` a fresh
        ``TraceRecorder`` (detach it before reusing the shared
        predictor untraced); ``job`` labels the session for per-job
        leak attribution and trace tagging."""
        if ledger is _UNSET:
            ledger = (
                GSResourceLedger(self.ledger.num_stations,
                                 self.ledger.capacity)
                if self.ledger is not None else None
            )
        env = CommsEnvironment(
            walker=self.walker,
            predictor=self.predictor,
            link=self.link if link is _UNSET else link,
            isl=self.isl if isl is _UNSET else isl,
            ledger=ledger,
            handover=self.handover if handover is _UNSET else handover,
        )
        env.job = job
        if sanitize:
            from repro_torch.analysis.sanitizer import ScheduleSanitizer

            ScheduleSanitizer.attach(env)
        if trace:
            from repro_torch.obs.trace import TraceRecorder

            TraceRecorder.attach(env)
        return env

    # -- transfer planning -----------------------------------------------------
    def plan_transfer(
        self,
        *,
        sat: Satellite,
        t: float,
        transfer_time: TransferTime,    # (gs_index, distance) -> (need, done)
        skip_window: SkipWindow = None,
        handover_spec: Optional["HandoverSpec"] = None,
        contended: bool = True,
    ) -> Optional[Tuple]:
        """Generic earliest-completing transfer of one satellite after
        ``t`` against this session's window table and (when
        ``contended``) residual RB capacity — the raw tuple surface the
        legacy ``earliest_transfer`` shim exposes.  Prefer
        ``plan_upload``/``plan_download``."""
        S = _sched()
        return S._earliest_transfer_impl(
            walker=self.walker, predictor=self.predictor, sat=sat, t=t,
            transfer_time=transfer_time, skip_window=skip_window,
            ledger=self.ledger if contended else None,
            handover=handover_spec,
        )

    def plan_upload(
        self,
        sat: Satellite,
        t_ready: float,
        payload_bits: float,
        *,
        skip_window: SkipWindow = None,
        handover: Optional[bool] = None,
    ) -> Optional[TransferDecision]:
        """Earliest-completing sink upload (one RB, eq. 16) after
        ``t_ready``: priced against residual station capacity and — per
        the session's handover policy — raced against a segmented
        station-switching plan.  Plan only; ``commit`` books it."""
        S = _sched()
        assert self.link is not None, "session has no GS link budget"
        tt = S.symmetric_transfer(downlink_time, self.link, payload_bits)
        use_handover = self.handover if handover is None else handover
        spec = (
            S.HandoverSpec(self.link, payload_bits) if use_handover else None
        )
        hit = self.plan_transfer(
            sat=sat, t=t_ready, transfer_time=tt, skip_window=skip_window,
            handover_spec=spec,
        )
        if hit is None:
            decision = None
        else:
            if spec is not None:
                t0, t_done, w, segments = hit
            else:
                t0, t_done, w = hit
                segments = ()
            decision = TransferDecision(
                "up", t0, t_done, w, tuple(segments),
                payload_bits=float(payload_bits),
            )
        if self.recorder is not None:
            self.recorder.on_plan("up", sat, t_ready, decision)
        return decision

    def plan_download(
        self,
        sat: Satellite,
        t: float,
        payload_bits: float,
        *,
        skip_window: SkipWindow = None,
    ) -> Optional[TransferDecision]:
        """Earliest-completing global-model download after ``t``: a
        full-band GS broadcast (eq. 15) — never RB-contended, never
        segmented."""
        S = _sched()
        assert self.link is not None, "session has no GS link budget"
        tt = S.symmetric_transfer(uplink_time, self.link, payload_bits)
        hit = self.plan_transfer(
            sat=sat, t=t, transfer_time=tt, skip_window=skip_window,
            contended=False,
        )
        if hit is None:
            decision = None
        else:
            t0, t_done, w = hit
            decision = TransferDecision(
                "down", t0, t_done, w, payload_bits=float(payload_bits)
            )
        if self.recorder is not None:
            self.recorder.on_plan("down", sat, t, decision)
        return decision

    # -- sink selection --------------------------------------------------------
    def select_sink(
        self,
        *,
        plane: int,
        t_train_done: Sequence[float],
        payload_bits: float,
        require_next_download: bool = False,
        isl: Optional[ISLConfig] = None,
        handover: Optional[bool] = None,
    ) -> Optional["SinkDecision"]:
        """Deterministic sink selection for one orbital plane (eqs.
        21-22 with the ring hop metric) — ``SinkDecision`` or None."""
        S = _sched()
        isl = isl if isl is not None else self.isl
        assert isl is not None, "session has no intra-plane ISL budget"
        K = self.walker.config.sats_per_plane
        t_hop = isl_hop_time(isl, payload_bits)
        cd = self.select_sink_cluster(
            sats=[(plane, s) for s in range(K)],
            relay_latency=S.ring_hops_matrix(K) * t_hop,
            t_train_done=t_train_done, payload_bits=payload_bits,
            require_next_download=require_next_download, handover=handover,
        )
        if cd is None:
            return None
        return S.SinkDecision(
            plane=plane,
            sink_slot=cd.sink.slot,
            window=cd.window,
            t_models_at_sink=cd.t_models_at_sink,
            t_upload_start=cd.t_upload_start,
            t_upload_done=cd.t_upload_done,
            t_wait=cd.t_wait,
            candidates_considered=cd.candidates_considered,
            segments=cd.segments,
            payload_bits=cd.payload_bits,
        )

    def select_sink_cluster(
        self,
        *,
        sats: Sequence[Tuple[int, int]],
        relay_latency: np.ndarray,
        t_train_done: Sequence[float],
        payload_bits: float,
        require_next_download: bool = False,
        handover: Optional[bool] = None,
    ) -> Optional["ClusterSinkDecision"]:
        """Constellation-wide sink selection over an arbitrary satellite
        set (eq. 21/22 over a relay-latency matrix) —
        ``ClusterSinkDecision`` or None."""
        S = _sched()
        assert self.link is not None, "session has no GS link budget"
        return S._select_sink_cluster_impl(
            walker=self.walker, predictor=self.predictor, link=self.link,
            sats=sats, relay_latency=relay_latency,
            t_train_done=t_train_done, payload_bits=payload_bits,
            require_next_download=require_next_download, ledger=self.ledger,
            handover=self.handover if handover is None else handover,
        )

    def naive_sink_slot(self, plane: int, t_ready: float) -> Optional[int]:
        """The naive-sink ablation's slot choice (first visitor after
        ``t_ready``, window duration ignored)."""
        return _sched()._naive_sink_slot_impl(self.predictor, plane, t_ready)

    def first_visible_download(
        self, plane: int, t: float, payload_bits: float
    ) -> Optional[tuple]:
        """Earliest (slot, t_received) at which ANY satellite of the
        plane can finish downloading w^t after ``t`` (§IV-A step 1)."""
        K = self.walker.config.sats_per_plane
        return self.first_visible_download_sats(
            [(plane, s) for s in range(K)], t, payload_bits
        )

    def first_visible_download_sats(
        self, sats: Sequence[Tuple[int, int]], t: float, payload_bits: float
    ) -> Optional[tuple]:
        """Earliest (index into ``sats``, t_received) download over an
        arbitrary satellite set (a cluster of planes)."""
        S = _sched()
        assert self.link is not None, "session has no GS link budget"
        return S._first_visible_download_sats_impl(
            walker=self.walker, predictor=self.predictor, link=self.link,
            sats=sats, t=t, payload_bits=payload_bits,
        )

    # -- reservation lifecycle -------------------------------------------------
    def set_rid_base(self, base: int) -> None:
        """Namespace this session's reservation ids from ``base``.
        Concurrent sessions over one shared ledger each count rids from
        0 by default; the multi-tenant scheduler gives every job
        session a disjoint range so merged traces and cross-session
        tooling never conflate two jobs' bookings.  Must be called
        before the first commit."""
        if self._next_rid != 0:
            raise ValueError(
                "rid base must be set before the session's first commit"
            )
        self._next_rid = int(base)

    def commit(self, decision: Any) -> Reservation:
        """Book one chosen decision on the session ledger — each
        handover leg on its own station for exactly the leg span, or
        the single upload interval — and return the ``Reservation``
        that ``release`` takes back.  THE one booking rule; without a
        ledger (or for downloads) the reservation carries its legs but
        occupies nothing."""
        legs = _decision_legs(decision)
        self._next_rid += 1
        reservation = Reservation(
            rid=self._next_rid, legs=legs, decision=decision
        )
        if self.sanitizer is not None:
            # validate BEFORE booking: a strict sanitizer rejects the
            # decision with the ledger untouched
            self.sanitizer.observe_commit(reservation)
        if self.ledger is not None:
            reservation.bids = tuple(
                self.ledger.reserve(gi, t0, t1) for gi, t0, t1 in legs
            )
        if self.recorder is not None:
            # record AFTER booking: a sanitizer-rejected commit leaves
            # no trace event
            self.recorder.on_commit(reservation)
        for cb in list(self._commit_listeners):
            cb(reservation)
        return reservation

    def release(
        self, reservation: Reservation, at: Optional[float] = None
    ) -> Tuple[Leg, ...]:
        """Give a committed reservation's capacity back to the ledger
        and fire every registered ``on_release`` callback with the
        freed intervals.

        ``at=None`` frees every leg in full.  With ``at``, only the
        part from ``at`` on is freed: legs already over keep their
        booking (the RB was truly spent), a straddling leg is truncated
        to ``[t0, at)``.  Double release is a no-op.  Returns the freed
        ``(gs_index, t0, t1)`` intervals."""
        if reservation.released:
            return ()
        freed: List[Leg] = []
        kept: List[Leg] = []
        kept_bids: List[Optional[int]] = []
        # legacy reservations built by hand (tests, external callers)
        # carry no booking ids — fall back to the deprecated
        # interval-matched release for those legs only
        bids: Tuple[Optional[int], ...] = reservation.bids
        if len(bids) != len(reservation.legs):
            bids = (None,) * len(reservation.legs)
        for (gi, t0, t1), bid in zip(reservation.legs, bids):
            if at is not None and t1 <= at:
                kept.append((gi, t0, t1))       # already transmitted
                kept_bids.append(bid)
                continue
            f0 = t0 if at is None else max(t0, at)
            head_bid: Optional[int] = None
            if self.ledger is not None:
                if bid is not None:
                    self.ledger.release_booking(gi, bid)
                else:
                    self.ledger.release(gi, t0, t1)
                if f0 > t0:                     # keep the spent head
                    head_bid = self.ledger.reserve(gi, t0, f0)
            if f0 > t0:
                kept.append((gi, t0, f0))
                kept_bids.append(head_bid)
            freed.append((gi, f0, t1))
        reservation.legs = tuple(kept)
        reservation.bids = tuple(kept_bids)
        reservation.released = True
        if self.sanitizer is not None:
            self.sanitizer.observe_release(reservation, tuple(freed))
        if self.recorder is not None and freed:
            self.recorder.on_release(reservation, tuple(freed))
        if freed and self.ledger is not None:
            for cb in list(self._release_listeners):
                cb(reservation, tuple(freed))
        return tuple(freed)

    def release_before(self, t: float) -> None:
        """Drop bookings that ended at or before ``t`` (the simulated
        clock is monotone; past intervals can never affect a fit).
        Deliberately does NOT fire ``on_release`` — expiring into the
        past frees no *future* capacity to re-plan against."""
        if self.ledger is not None:
            self.ledger.release_before(t)

    def on_release(self, callback: Callable) -> Callable[[], None]:
        """Register ``callback(reservation, freed_legs)`` to run on
        every capacity release; returns an unsubscribe function."""
        self._release_listeners.append(callback)

        def unsubscribe() -> None:
            if callback in self._release_listeners:
                self._release_listeners.remove(callback)

        return unsubscribe

    def on_commit(self, callback: Callable) -> Callable[[], None]:
        """Register ``callback(reservation)`` to run after every
        committed booking; returns an unsubscribe function.  The
        multi-tenant fair scheduler meters each job's consumed
        RB-seconds through this hook."""
        self._commit_listeners.append(callback)

        def unsubscribe() -> None:
            if callback in self._commit_listeners:
                self._commit_listeners.remove(callback)

        return unsubscribe

    # -- event-driven async re-admission --------------------------------------
    def readmit(
        self,
        pending: Sequence[PendingUpload],
        t_now: float,
        policy: str = "monotone",
    ) -> Tuple[List[PendingUpload], int]:
        """Re-admit queued uploads after their reservations release.

        Async strategies book every upload at schedule time — under
        scarce RB capacity a queued upload sits wherever the booking
        order left it, even after an earlier reservation (or handover
        leg) releases the capacity that blocked it.  ``readmit`` runs
        the event-driven repair: in model-ready order, each queued
        upload's own reservation is released, the upload is re-priced
        against everything else still booked (the freed capacity now
        visible), and the new plan is ADOPTED only when it completes
        strictly earlier — otherwise the original booking is restored
        verbatim (its slot is provably still free: only its own
        reservation was out).  Every adoption releases that upload's
        old slot in turn — each release firing the ``on_release`` hooks
        — so improvements cascade; passes repeat until a full pass
        adopts nothing.

        Per-entry monotonicity makes the repair safe by construction:
        no upload ever completes later than its original booking, so
        neither the queued makespan nor any single completion can
        regress (the same adopt-only-if-strictly-better discipline as
        the segmented handover planner).  Uploads already transmitting
        (``t_start <= t_now``) are never touched; with no ledger this
        is a no-op and schedules stay bit-identical.

        ``policy="repack"`` layers a regret-based, swap-accepting
        global re-packer ON TOP of the monotone repair: per-entry
        repair is a local optimum of the admission order, so after it
        dries up the re-packer tries ORDER swaps — for an
        admission-ordered pair, both bookings come out and the later
        entry prices FIRST.  A swap is adopted only when neither new
        completion regresses its post-monotone value (the floor) and
        at least one strictly improves; otherwise both original
        bookings are restored verbatim (their slots are provably still
        free — only those two reservations were out).  Pairs are tried
        in descending combined regret (committed completion minus the
        entry's contention-free ideal — how much contention costs it),
        and every adopted swap re-runs the monotone cascade, so the
        monotone result remains a per-entry floor: no queued completion
        may regress vs. the pure monotone pass.

        Returns ``(updated pending, number of re-priced uploads)``;
        the updated list preserves the input order.
        """
        if policy not in ("monotone", "repack"):
            raise ValueError(f"unknown readmit policy {policy!r}")
        pending = list(pending)
        if self.ledger is None:
            return pending, 0
        before = [(p.key, p.decision.t_done) for p in pending]
        # model-ready order, stable on the original admission order
        order = sorted(
            range(len(pending)), key=lambda i: (pending[i].t_ready, i)
        )
        repriced = 0
        while True:
            improved = True
            while improved:         # adoptions strictly shrink some
                improved = False    # completion: passes terminate
                for i in order:
                    p = pending[i]
                    if p.decision.t_start <= t_now or p.reservation.released:
                        continue
                    self.release(p.reservation)
                    # re-plan from the later of model readiness and NOW
                    # — a queued upload must never be re-priced into a
                    # window that has already elapsed (release_before
                    # may have purged past bookings, leaving
                    # phantom-free history)
                    dec = self.plan_upload(
                        p.sat, max(p.t_ready, t_now), p.payload_bits
                    )
                    if (
                        dec is not None
                        and dec.t_done < p.decision.t_done - 1e-9
                    ):
                        pending[i] = dataclasses.replace(
                            p, decision=dec, reservation=self.commit(dec)
                        )
                        repriced += 1
                        improved = True
                    else:
                        # restore: the earliest completion with its own
                        # slot free again can never be later than that
                        # same slot
                        pending[i] = dataclasses.replace(
                            p, reservation=self.commit(p.decision)
                        )
            if policy != "repack":
                break
            swapped = self._repack_swap_pass(pending, order, t_now)
            repriced += swapped
            if swapped == 0:
                break
        if self.sanitizer is not None:
            self.sanitizer.observe_readmit(
                before, [(p.key, p.decision.t_done) for p in pending]
            )
        if self.recorder is not None:
            self.recorder.on_readmit(t_now, len(pending), repriced)
        return pending, repriced

    def _uncontended_completion(
        self, p: PendingUpload, t_now: float
    ) -> Optional[float]:
        """Contention-free single-window completion of one queued
        upload — the regret baseline: how early it would finish if the
        shared ledger did not exist."""
        S = _sched()
        assert self.link is not None, "session has no GS link budget"
        tt = S.symmetric_transfer(downlink_time, self.link, p.payload_bits)
        hit = self.plan_transfer(
            sat=p.sat, t=max(p.t_ready, t_now), transfer_time=tt,
            contended=False,
        )
        return None if hit is None else float(hit[1])

    def _repack_swap_pass(
        self,
        pending: List[PendingUpload],
        order: Sequence[int],
        t_now: float,
    ) -> int:
        """One sweep of the regret-based swap search (``readmit``'s
        repack policy).  Tries admission-ordered pairs in descending
        combined regret; on the FIRST adopted swap, updates the two
        entries in place and returns the number of re-priced uploads
        (2) so the caller re-runs the monotone cascade.  Returns 0 when
        no swap is admissible (the sweep is dry)."""
        eligible = [
            i for i in order
            if pending[i].decision.t_start > t_now
            and not pending[i].reservation.released
        ]
        if len(eligible) < 2:
            return 0
        regret = {}
        for i in eligible:
            ideal = self._uncontended_completion(pending[i], t_now)
            regret[i] = (
                max(0.0, pending[i].decision.t_done - ideal)
                if ideal is not None else 0.0
            )
        pos = {i: k for k, i in enumerate(eligible)}
        pairs = sorted(
            (
                (a, b)
                for a in eligible for b in eligible
                if pos[a] < pos[b]      # a admitted before b
            ),
            key=lambda ab: (-(regret[ab[0]] + regret[ab[1]]), ab),
        )
        for a, b in pairs:
            if regret[a] <= 1e-9 and regret[b] <= 1e-9:
                continue                # neither entry pays contention
            pa, pb = pending[a], pending[b]
            floor_a, floor_b = pa.decision.t_done, pb.decision.t_done
            self.release(pa.reservation)
            self.release(pb.reservation)
            # swapped admission: the LATER entry prices first
            dec_b = self.plan_upload(
                pb.sat, max(pb.t_ready, t_now), pb.payload_bits
            )
            res_b = self.commit(dec_b) if dec_b is not None else None
            dec_a = (
                self.plan_upload(pa.sat, max(pa.t_ready, t_now),
                                 pa.payload_bits)
                if dec_b is not None else None
            )
            adopt = (
                dec_a is not None and dec_b is not None
                and dec_a.t_done <= floor_a + 1e-9      # monotone floor
                and dec_b.t_done <= floor_b + 1e-9
                and (dec_a.t_done < floor_a - 1e-9
                     or dec_b.t_done < floor_b - 1e-9)
            )
            if adopt:
                pending[b] = dataclasses.replace(
                    pb, decision=dec_b, reservation=res_b
                )
                pending[a] = dataclasses.replace(
                    pa, decision=dec_a, reservation=self.commit(dec_a)
                )
                return 2
            # roll back: free any trial booking, restore the originals
            # verbatim (only these two reservations were out, so their
            # slots are still free)
            if res_b is not None:
                self.release(res_b)
            pending[a] = dataclasses.replace(
                pa, reservation=self.commit(pa.decision)
            )
            pending[b] = dataclasses.replace(
                pb, reservation=self.commit(pb.decision)
            )
        return 0

    def finish_session(
        self,
        t_end: float,
        *,
        open_rids: FrozenSet[int] = frozenset(),
        check_leaks: bool = True,
    ) -> List["Violation"]:
        """Close the sanitizer's books at simulated time ``t_end`` and
        return every violation it recorded (empty when unsanitized or
        clean).  ``open_rids`` exempts reservations a strategy still
        legitimately holds (an async queue booked beyond sim end);
        ``check_leaks=False`` skips the leak report entirely (runs
        abandoned mid-round leave half-planned bookings by design)."""
        if self.sanitizer is None:
            return []
        return self.sanitizer.finish(
            t_end, open_rids=open_rids, check_leaks=check_leaks
        )
