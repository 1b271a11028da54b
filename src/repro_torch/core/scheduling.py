# Copied from src/repro/core/scheduling.py; imports rebound to repro_torch.
"""Distributed sink-satellite scheduling (paper §IV-B).

Every satellite runs ``select_sink`` over the *same* deterministic inputs
(constellation config, GS position, training-completion times, link
parameters) and therefore reaches the same decision without any message
exchange — this is what makes the scheduler distributed.

Selection rule (eqs. 21-22): among candidate sinks C_l on orbit l, pick
the satellite minimizing the orbit's completion time

  T*_sum = t_c^U + t_c^D + t*_wait + t_train(K_l) + t*_h           (22)

subject to the access-window feasibility constraint

  AW(c_opt, GS) >= (time needed to exchange models with the GS),

i.e. the sink's upcoming visibility window must be long enough for the
partial-global-model upload (and next-round download).  Ties (several
candidates with equal completion) resolve to the earliest visitor,
matching "selects the one that will visit the GS the first".

Both schedulers accept a single ``GroundStation`` or a sequence
(multi-GS union semantics: a window against ANY station qualifies, and
the slant range is computed against the window's own station).  Slant
ranges are evaluated in batch — one ``walker.positions_batch`` call per
resolution round covering every candidate of the plane — instead of the
seed's per-candidate-per-window scalar ``position_of`` calls.

Contention (``GSResourceLedger``): every transfer-planning entry point
takes an optional ``ledger`` carrying the per-station resource-block
timeline.  A candidate window is then priced against the *residual*
station capacity — the effective start is pushed past saturated
stretches (``ledger.earliest_fit``) and a window with no free RB room
left is skipped entirely.  The planners only *read* the ledger; the
caller books the chosen transfer with ``reserve_decision`` (or
``ledger.reserve``) so subsequent decisions see it.  ``ledger=None``
(and unlimited capacity) is the degenerate contention-free case,
bit-identical to the pre-ledger planner.

Rolling horizon: when the predictor was built with ``rolling=True``
and a satellite set has NO feasible window inside the built horizon,
the planners extend the horizon chunk-by-chunk and retry instead of
returning None (up to the predictor's ``max_horizon_s``).

Mid-window station handover (``SimConfig.gs_handover``): a sink upload
no longer has to sit on one station for its whole transfer —
``plan_segmented_transfer`` assembles it from capacity-priced legs
across different stations' windows (Razmi et al. 2109.01348 / FedSpace
2202.01267 exploit exactly this overlap), and every upload-pricing
entry point races the segmented plan against the single-window fit.
Consecutive legs must switch stations, and a segmented plan is adopted
only when it strictly beats the single-window completion — so
handover-off, single-GS, and never-splitting runs stay bit-identical
to the unsegmented scheduler.

Session API: the canonical owner of the (predictor, ledger, handover)
state is now ``repro.comms.environment.CommsEnvironment`` — strategies
hold ONE session and plan through its typed methods (``plan_upload``,
``select_sink``, ``commit``/``release``).  The public free functions
below (``earliest_transfer``, ``select_sink``, ``select_sink_cluster``,
``naive_sink_slot``, ``first_visible_download[_sats]``) remain as thin
shims that build an ephemeral session from their explicit arguments
and delegate, so legacy callers and the environment agree bit-for-bit
(golden-tested in ``tests/test_comms_environment.py``).  The private
``*_impl`` functions hold the actual machinery both surfaces share.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.comms.isl import ISLConfig, isl_hop_time
from repro_torch.comms.ledger import GSResourceLedger
from repro_torch.comms.link import (
    LinkConfig,
    downlink_time,
    model_exchange_time,
    propagation_time,
    shannon_rate,
    uplink_time,
)
from repro_torch.core.propagation import ring_hops_matrix
from repro_torch.orbits.constellation import GroundStation, Satellite, WalkerDelta
from repro_torch.orbits.prediction import (
    GroundStations,
    VisibilityPredictor,
)
from repro_torch.orbits.visibility import VisibilityWindow

# (gs_index, slant_range_m) -> (need_s, done_s): the window-feasibility
# requirement and the completion offset of one candidate transfer
TransferTime = Callable[[int, float], Tuple[float, float]]
SkipWindow = Optional[Callable[[VisibilityWindow], bool]]


@dataclasses.dataclass(frozen=True)
class SinkDecision:
    plane: int
    sink_slot: int
    window: VisibilityWindow    # single-window upload, or the first leg's
    t_models_at_sink: float     # all trained models collected (eq. 21)
    t_upload_start: float       # max(window start, models ready)
    t_upload_done: float        # + t_c^D
    t_wait: float               # t*_wait
    candidates_considered: int
    # mid-window station handover: the upload's legs when it was split
    # across stations (empty = the classic single-window transfer)
    segments: Tuple["TransferSegment", ...] = ()
    payload_bits: Optional[float] = None


def _distance_at(
    walker: WalkerDelta, gs: GroundStation, sat: Satellite, t: float
) -> float:
    r_s = walker.position_of(sat, t)
    r_g = gs.eci(np.asarray(t))
    return float(np.linalg.norm(r_s - r_g))


def _slant_ranges(
    walker: WalkerDelta,
    gss: Sequence[GroundStation],
    gs_idx: np.ndarray,
    planes: np.ndarray,
    slots: np.ndarray,
    times: np.ndarray,
) -> np.ndarray:
    """|r_sat - r_gs| for a batch of (window-gs, plane, slot, time)."""
    times = np.asarray(times, dtype=np.float64)
    r_s = walker.positions_batch(planes, slots, times)     # (C, 3)
    r_g = np.empty_like(r_s)
    for gi in np.unique(np.asarray(gs_idx)):
        m = np.asarray(gs_idx) == gi
        r_g[m] = gss[int(gi)].eci(times[m])
    return np.linalg.norm(r_s - r_g, axis=-1)


def _ledger_fit(
    ledger: Optional[GSResourceLedger],
    gs_index: int,
    t0: float,
    window_end: float,
    need: float,
    occupy: float,
) -> Optional[float]:
    """Effective transfer start inside one window: ``t0`` when the
    window's remaining duration covers ``need`` and no ledger is in
    play; otherwise the earliest start with a free RB for the
    ``occupy``-long transmission (still leaving ``need`` of window)."""
    if window_end - t0 < need:
        return None
    if ledger is None:
        return t0
    return ledger.earliest_fit(gs_index, t0, window_end - need, occupy)


def _repriced_fit(
    ledger: Optional[GSResourceLedger],
    walker: WalkerDelta,
    gs: GroundStation,
    sat: Satellite,
    gs_index: int,
    t0: float,
    window_end: float,
    transfer_time: TransferTime,
    need: float,
    done: float,
    max_iters: int = 8,
) -> Tuple[Optional[float], float]:
    """(effective start, completion offset) of one window's transfer.

    The contention-free path prices the transfer once, at the
    window-feasible start ``t0`` (the planner's one-evaluation
    convention).  When the ledger pushes the start later, the slant
    range — and with it the transfer duration — changes, so the
    duration is re-evaluated at the pushed start and the fit re-run
    until it stabilizes (starts move monotonically later, so the loop
    terminates; bounded as a guard).  Without this, a push toward the
    window edge could book a duration computed at a nearer slant range
    and physically overrun the window.
    """
    t_fit = _ledger_fit(ledger, gs_index, t0, window_end, need, done)
    if t_fit is None or t_fit == t0:
        return t_fit, done
    for _ in range(max_iters):
        d = _distance_at(walker, gs, sat, t_fit)
        need, done = transfer_time(gs_index, d)
        if window_end - t_fit < need:
            return None, done       # true duration no longer fits
        nxt = ledger.earliest_fit(
            gs_index, t_fit, window_end - need, done
        )
        if nxt is None or nxt == t_fit:
            return nxt, done
        t_fit = nxt
    return t_fit, done


# --- segmented (handover) transfer planning -----------------------------------
@dataclasses.dataclass(frozen=True)
class TransferSegment:
    """One leg of a segmented sink upload: ``bits`` payload bits
    delivered to station ``gs_index`` over ``[t_start, t_end)`` (one
    RB booked for exactly that span), inside the leg's access window
    ``[window_start, window_end]``."""

    gs_index: int
    t_start: float
    t_end: float
    bits: float
    window_start: float
    window_end: float


@dataclasses.dataclass(frozen=True)
class SegmentedPlan:
    """A sink upload split across station handovers: consecutive legs
    always land on *different* stations (resuming the same station's
    next pass is a retry, not a handover), and the payload bits are
    conserved across legs."""

    segments: Tuple[TransferSegment, ...]

    @property
    def t_start(self) -> float:
        return self.segments[0].t_start

    @property
    def t_done(self) -> float:
        return self.segments[-1].t_end

    @property
    def total_bits(self) -> float:
        return float(sum(s.bits for s in self.segments))

    @property
    def stations(self) -> Tuple[int, ...]:
        return tuple(s.gs_index for s in self.segments)


@dataclasses.dataclass(frozen=True)
class HandoverSpec:
    """What the segmented planner needs to price a sink upload (one RB
    of ``link``, eq. 16) when mid-window station handover is enabled
    (``SimConfig.gs_handover``)."""

    link: LinkConfig
    payload_bits: float
    require_next_download: bool = False


def plan_segmented_transfer(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sat: Satellite,
    t_ready: float,
    link: LinkConfig,
    payload_bits: float,
    ledger: Optional[GSResourceLedger] = None,
    require_next_download: bool = False,
    skip_window: SkipWindow = None,
    max_segments: int = 16,
) -> Optional[SegmentedPlan]:
    """Greedy segmented (handover) plan for one sink upload.

    Instead of pinning the transfer to a single station for its whole
    duration, the upload is assembled from capacity-priced legs across
    *all* stations' windows: each leg transmits from the earliest free
    RB stretch still open (ledger residual capacity, window bounds),
    at the Shannon rate of its own slant range (re-priced per leg, at
    the leg start), paying the per-leg link overhead (propagation +
    processing — a handover re-acquires the link).  A leg that cannot
    finish the payload transmits until its stretch closes and hands
    the remainder over; consecutive legs must switch stations, so with
    a single ground station no multi-leg plan exists and the planner
    degenerates to the single-window transfer (bit-identical
    handover-off behavior).

    Ledger semantics match the single-window planner: the plan only
    *reads* residual capacity; the caller books every leg
    (``reserve_decision``).  ``require_next_download`` demands the
    final leg's window leave room for the next global-model download
    after the upload completes (eq. 22's exchange feasibility).

    Rolling horizon: a plan that ran dry inside the built table, or
    whose legs used a window still clipped at the built boundary (a
    segment straddling the horizon edge), extends the predictor and
    replans rather than silently truncating
    (``VisibilityPredictor.retry_extending``).

    Returns None when no complete plan exists within the horizon (the
    caller falls back to the single-window transfer).
    """
    gss = predictor.ground_stations

    def free_runs(
        gi: int, lo: float, hi: float
    ) -> Tuple[Tuple[float, float], ...]:
        if hi <= lo:
            return ()
        if ledger is None:
            return ((lo, hi),)
        a, b = ledger.free_runs(gi, lo, hi)
        return tuple(zip(a, b))

    def attempt() -> Tuple[Optional[SegmentedPlan], bool]:
        rec = predictor.sat_arrays(sat.plane, sat.slot)
        if rec is None:
            return None, True               # nothing built for this sat yet
        built_end = predictor.built_end if predictor.rolling else np.inf
        starts, ends, gs_idx = rec["starts"], rec["ends"], rec["gs_index"]

        def candidate(
            t: float, last_gs: Optional[int], excl: set
        ) -> Optional[
            Tuple[float, float, float, float, int, int, float, float, float]
        ]:
            """Earliest usable free stretch over all windows after t:
            (fa, fb, ws, we, gi, j, d, t_over, rate), ties resolved to
            the faster station then window order.

            Slant ranges are evaluated in batched rounds — one
            ``_slant_ranges`` call covering every still-active window's
            current free stretch, exactly as ``_resolve_first_fits``
            does — instead of a scalar ``_distance_at`` sweep per
            (window, stretch).  A window whose stretch is too short to
            deliver any bits advances to its next free stretch in the
            following round; a window whose stretch starts after the
            best key so far can never win (its later stretches start
            later still) and drops out.  The winner is the same minimum
            the scalar scan found: windows are start-ordered and the
            key orders on the stretch start first, so evaluating the
            full candidate set changes nothing but the wall time.
            """
            runs = {}                       # window -> its free stretches
            for j in range(starts.size):
                ws, we = float(starts[j]), float(ends[j])
                gi = int(gs_idx[j])
                if we <= t or j in excl:
                    continue
                if last_gs is not None and gi == last_gs:
                    continue                # a handover must switch stations
                if skip_window is not None and skip_window(
                    VisibilityWindow(sat.plane, sat.slot, ws, we, gi)
                ):
                    continue
                fr = free_runs(gi, max(ws, t), we)
                if fr:
                    runs[j] = fr
            best, best_key = None, None
            ptr = {j: 0 for j in runs}
            active = list(runs)             # ascending window order
            while active:
                fas = np.array([runs[j][ptr[j]][0] for j in active])
                gis = np.array([int(gs_idx[j]) for j in active])
                dists = _slant_ranges(
                    walker, gss, gis,
                    np.full(len(active), sat.plane),
                    np.full(len(active), sat.slot), fas,
                )
                nxt = []
                for j, fa, d in zip(active, fas, dists):
                    fa, d = float(fa), float(d)
                    if best_key is not None and fa > best_key[0]:
                        continue            # cannot beat the best stretch
                    fb = runs[j][ptr[j]][1]
                    gi = int(gs_idx[j])
                    t_over = propagation_time(d) + link.processing_delay_s
                    if fb - fa <= t_over:
                        ptr[j] += 1         # too short to deliver any bits
                        if ptr[j] < len(runs[j]):
                            nxt.append(j)   # later stretches start later
                        continue
                    rate = shannon_rate(link, d, link.rb_bandwidth_hz)
                    key = (fa, -rate, gi, j)
                    if best_key is None or key < best_key:
                        best_key, best = key, (
                            fa, fb, float(starts[j]), float(ends[j]),
                            gi, j, d, t_over, rate,
                        )
                active = nxt
            return best

        segments = []
        bits_rem = float(payload_bits)
        t = float(t_ready)
        boundary = False
        while bits_rem > 0 and len(segments) < max_segments:
            excl: set = set()
            last_gs = segments[-1].gs_index if segments else None
            while True:
                best = candidate(t, last_gs, excl)
                if best is None:
                    return None, True       # ran dry: a longer table may help
                fa, fb, ws, we, gi, j, d, t_over, rate = best
                t_done = fa + model_exchange_time(
                    link, bits_rem, d, link.rb_bandwidth_hz
                )
                if t_done <= fb:
                    if (
                        require_next_download
                        and t_done + uplink_time(link, payload_bits, d) > we
                    ):
                        # the payload would finish here but the window
                        # cannot also host the next download: the final
                        # leg must land elsewhere.  A boundary-clipped
                        # window may only LOOK too short — its true end
                        # lies in the next chunk, so the rejection must
                        # force an extension retry (like
                        # _resolve_first_fits' clipped_reject)
                        if we >= built_end:
                            boundary = True
                        excl.add(j)
                        continue
                    segments.append(TransferSegment(gi, fa, t_done, bits_rem,
                                                    ws, we))
                    bits_rem = 0.0
                else:
                    bits = (fb - fa - t_over) * rate
                    segments.append(TransferSegment(gi, fa, fb, bits, ws, we))
                    bits_rem -= bits
                    t = fb
                if we >= built_end:
                    boundary = True         # leg used a boundary-clipped window
                break
        if bits_rem > 0:
            # leg-count cap: more horizon cannot reduce the leg count
            # unless a clipped window truncated a leg
            return None, boundary
        return SegmentedPlan(tuple(segments)), boundary

    return predictor.retry_extending(attempt)


def _better_segmented(
    seg: Optional[SegmentedPlan],
    base_done: Optional[float],
) -> bool:
    """Adopt a segmented plan only when it is a TRUE handover (>= 2
    legs — single-leg plans are by construction never better than the
    single-window search) that strictly beats the single-window
    completion.  Keeps handover-off, single-GS, and contention-free
    runs bit-identical to the unsegmented planner."""
    if seg is None or len(seg.segments) < 2:
        return False
    return base_done is None or seg.t_done < base_done - 1e-9


def _first_fit_transfers(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sats: Sequence[Tuple[int, int]],
    t_ready: np.ndarray,
    transfer_time: TransferTime,
    ledger: Optional[GSResourceLedger] = None,
    handover: Optional[HandoverSpec] = None,
) -> List[Optional[Tuple]]:
    """Per satellite of ``sats`` (arbitrary (plane, slot) pairs — one
    plane's slots, or a whole cluster of planes): (t0, t0 + done_s,
    window_index) of the earliest-completing window after t_ready[i]
    that covers need_s, or None.

    ``need_s`` is the window-feasibility requirement, ``done_s`` the
    offset of the reported completion — they differ when a window must
    also leave room for a follow-up transfer (eq. 22's next-round
    download) that does not delay the completion itself.  With a
    ``ledger``, the start may additionally be pushed past saturated
    stretches of the window's station (residual-capacity pricing), and
    a pushed transfer is re-priced at its actual start
    (``_repriced_fit`` — the slant range moved with the delay).

    With a ``handover`` spec the single-window fits are additionally
    raced against segmented (station-handover) plans
    (``plan_segmented_transfer``) per satellite, and entries become
    4-tuples ``(t0, t_done, VisibilityWindow, segments)`` — the window
    of the first leg, and the leg tuple (empty when the single-window
    transfer won).  A satellite with NO single window long enough may
    still get a segmented plan — that is the infeasible-upload case
    handover rescues.

    When the predictor is rolling-horizon, the horizon is extended
    chunk-by-chunk and resolution retried whenever (a) NO satellite of
    the set has a feasible window, or (b) a window still *clipped at
    the built boundary* was rejected — its true end lies in the next
    chunk, so the rejection cannot be trusted.  Accepted fits are safe
    as-is (a longer window end changes neither the start nor the
    completion), which keeps rolling schedules identical to schedules
    against a prebuilt table.
    """
    sats = list(sats)

    def attempt() -> Tuple[List[Optional[Tuple]], bool]:
        out, clipped_reject = _resolve_first_fits(
            walker=walker, predictor=predictor, sats=sats,
            t_ready=t_ready, transfer_time=transfer_time, ledger=ledger,
        )
        return out, clipped_reject or (sats and all(o is None for o in out))

    out = predictor.retry_extending(attempt)
    if handover is None:
        return out
    # segmented planning may grow a rolling horizon; the single-window
    # fits must then be re-resolved against the SAME (grown) table or
    # a candidate whose only window lay past the old boundary would
    # stay None while its segmented plan exists — re-race until the
    # built horizon is stable so rolling matches a prebuilt table
    while True:
        built_before = predictor.built_end
        segs = [
            plan_segmented_transfer(
                walker=walker, predictor=predictor, sat=Satellite(p, s),
                t_ready=float(t_ready[i]), link=handover.link,
                payload_bits=handover.payload_bits, ledger=ledger,
                require_next_download=handover.require_next_download,
            ) if np.isfinite(t_ready[i]) else None
            for i, (p, s) in enumerate(sats)
        ]
        if predictor.built_end == built_before:
            break
        out = predictor.retry_extending(attempt)
    merged: List[Optional[Tuple]] = []
    for i, (p, s) in enumerate(sats):
        sat = Satellite(p, s)
        base = out[i]
        seg = segs[i]
        if _better_segmented(seg, base[1] if base is not None else None):
            lead = seg.segments[0]
            w = VisibilityWindow(p, s, lead.window_start, lead.window_end,
                                 lead.gs_index)
            merged.append((seg.t_start, seg.t_done, w, seg.segments))
        elif base is not None:
            merged.append((base[0], base[1],
                           predictor.windows_of(sat)[base[2]], ()))
        else:
            merged.append(None)
    return merged


def _resolve_first_fits(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sats: List[Tuple[int, int]],
    t_ready: np.ndarray,
    transfer_time: TransferTime,
    ledger: Optional[GSResourceLedger],
) -> Tuple[List[Optional[Tuple[float, float, int]]], bool]:
    """One batched resolution pass of ``_first_fit_transfers`` against
    the predictor's currently built window table.  Returns (fits,
    clipped_reject) — the flag marks a rejected boundary-clipped window
    (grounds for a rolling-horizon retry).

    Resolution proceeds in rounds: every still-pending slot contributes
    its current candidate window, ALL slant ranges of the round are
    evaluated with one batched positions call, and slots whose window is
    too short (or fully booked) advance to their next window.  With a
    single station the first fitting window in start order is the answer
    (disjoint windows: any later window starts after this one ends, and
    a ledger-delayed start still completes inside the window).  Under a
    multi-GS union, windows of the same satellite may OVERLAP, so after
    the first fit every window starting before that completion is also
    evaluated (a nearer station's overlapping pass can finish earlier);
    windows starting at or after an achieved completion can never beat
    it.
    """
    # the predictor assigned every window's gs_index, so it — not the
    # caller — is the authority on which station a window belongs to
    gss = predictor.ground_stations
    n = len(sats)
    planes_arr = np.array([p for p, _ in sats])
    slots_arr = np.array([s for _, s in sats])
    recs = [predictor.sat_arrays(p, s) for p, s in sats]
    ptrs: List[Optional[int]] = []
    for s, rec in enumerate(recs):
        if rec is None or not np.isfinite(t_ready[s]):
            ptrs.append(None)
            continue
        j = int(np.searchsorted(rec["cummax_end"], t_ready[s], side="right"))
        ptrs.append(j if j < rec["starts"].size else None)

    out: List[Optional[Tuple[float, float, int]]] = [None] * n
    sweeps: List[Tuple[int, int]] = []     # (sat index, overlap-window index)
    built_end = predictor.built_end if predictor.rolling else np.inf
    clipped_reject = False
    pending = [s for s in range(n) if ptrs[s] is not None]
    while pending:
        t0s = np.array(
            [max(recs[s]["starts"][ptrs[s]], t_ready[s]) for s in pending]
        )
        gs_idx = np.array([recs[s]["gs_index"][ptrs[s]] for s in pending])
        dists = _slant_ranges(
            walker, gss, gs_idx,
            planes_arr[pending], slots_arr[pending], t0s,
        )
        nxt = []
        for s, t0, d in zip(pending, t0s, dists):
            rec, j = recs[s], ptrs[s]
            gi = int(rec["gs_index"][j])
            need, done = transfer_time(gi, float(d))
            t_fit, done = _repriced_fit(
                ledger, walker, gss[gi], Satellite(*sats[s]), gi,
                float(t0), float(rec["ends"][j]), transfer_time,
                need, done,
            )
            if t_fit is not None:
                out[s] = (t_fit, t_fit + done, j)
                # multi-GS overlap sweep candidates: any window starting
                # before the achieved completion may still finish earlier
                for k in range(j + 1, rec["starts"].size):
                    if rec["starts"][k] >= out[s][1]:
                        break
                    if rec["ends"][k] > t_ready[s]:
                        sweeps.append((s, k))
                continue
            # window too short (or fully booked) — advance past windows
            # already over
            if rec["ends"][j] == built_end:
                clipped_reject = True
            j += 1
            while j < rec["ends"].size and rec["ends"][j] <= t_ready[s]:
                j += 1
            if j < rec["ends"].size:
                ptrs[s] = j
                nxt.append(s)
        pending = nxt

    if sweeps:
        # evaluate every overlap candidate of every slot in ONE batched
        # slant-range call (in-order processing keeps ties deterministic)
        t0s = np.array(
            [max(recs[s]["starts"][k], t_ready[s]) for s, k in sweeps]
        )
        gs_idx = np.array([recs[s]["gs_index"][k] for s, k in sweeps])
        sweep_sats = np.array([s for s, _ in sweeps])
        dists = _slant_ranges(
            walker, gss, gs_idx,
            planes_arr[sweep_sats], slots_arr[sweep_sats], t0s,
        )
        for (s, k), t0k, dk in zip(sweeps, t0s, dists):
            rec = recs[s]
            gi = int(rec["gs_index"][k])
            need_k, done_k = transfer_time(gi, float(dk))
            t_fit, done_k = _repriced_fit(
                ledger, walker, gss[gi], Satellite(*sats[s]), gi,
                float(t0k), float(rec["ends"][k]), transfer_time,
                need_k, done_k,
            )
            if t_fit is None:
                if rec["ends"][k] == built_end:
                    clipped_reject = True
            elif t_fit + done_k < out[s][1]:
                out[s] = (t_fit, t_fit + done_k, k)
    return out, clipped_reject


def symmetric_transfer(
    time_fn: Callable[[LinkConfig, float, float], float],
    link: LinkConfig,
    payload_bits: float,
) -> TransferTime:
    """transfer_time callback for a single up- or downlink: feasibility
    need and completion offset are the same transfer duration."""
    def tt(_gs_index: int, d: float) -> Tuple[float, float]:
        tc = time_fn(link, payload_bits, d)
        return tc, tc

    return tt


def earliest_transfer(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sat: Satellite,
    t: float,
    transfer_time: TransferTime,
    skip_window: SkipWindow = None,
    ledger: Optional[GSResourceLedger] = None,
    handover: Optional[HandoverSpec] = None,
) -> Optional[Tuple]:
    """Legacy shim over ``CommsEnvironment.plan_transfer``: builds an
    ephemeral session from the explicit (walker, predictor, ledger)
    arguments and delegates.  Same contract as always — (t0, t_done,
    window) or, with a ``handover`` spec, (t0, t_done, window,
    segments) — and bit-identical to the session API (golden-tested).
    New code should hold a ``CommsEnvironment`` and call
    ``plan_upload``/``plan_download``/``plan_transfer`` instead."""
    from repro_torch.comms.environment import CommsEnvironment

    env = CommsEnvironment(
        walker=walker, predictor=predictor,
        link=handover.link if handover is not None else None,
        ledger=ledger, handover=handover is not None,
    )
    return env.plan_transfer(
        sat=sat, t=t, transfer_time=transfer_time,
        skip_window=skip_window, handover_spec=handover,
    )


def _earliest_transfer_impl(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sat: Satellite,
    t: float,
    transfer_time: TransferTime,
    skip_window: SkipWindow = None,
    ledger: Optional[GSResourceLedger] = None,
    handover: Optional[HandoverSpec] = None,
) -> Optional[Tuple]:
    """Earliest-completing feasible transfer of one satellite after t:
    (t0, t_done, window), or None.

    The scalar single-satellite analogue of ``_first_fit_transfers``,
    shared by the baseline retry loops so they price every window
    against its own station (taken from the predictor that tagged the
    windows) and agree with ``select_sink`` on earliest-completion
    semantics under multi-GS union windows (where overlapping windows
    mean the first fit in start order is not necessarily the earliest
    completion).  Ledger and rolling-horizon semantics match
    ``_first_fit_transfers``: windows are priced against residual
    station capacity, and an empty result extends a rolling predictor
    and retries.

    With a ``handover`` spec the single-window search is raced against
    a segmented station-handover plan and the result becomes the
    4-tuple ``(t0, t_done, window, segments)`` (first-leg window;
    ``segments`` empty when the single-window transfer won) — same
    contract as ``_first_fit_transfers``.
    """
    # re-race after any horizon growth: both searches must price the
    # same (final) window table, or a stale single-window miss could
    # hide a transfer the grown table affords (and vice versa)
    while True:
        best = _earliest_single_transfer(
            walker=walker, predictor=predictor, sat=sat, t=t,
            transfer_time=transfer_time, skip_window=skip_window,
            ledger=ledger,
        )
        if handover is None:
            return best
        built_before = predictor.built_end
        seg = plan_segmented_transfer(
            walker=walker, predictor=predictor, sat=sat, t_ready=t,
            link=handover.link, payload_bits=handover.payload_bits,
            ledger=ledger,
            require_next_download=handover.require_next_download,
            skip_window=skip_window,
        )
        if predictor.built_end == built_before:
            break
    if _better_segmented(seg, best[1] if best is not None else None):
        lead = seg.segments[0]
        w = VisibilityWindow(sat.plane, sat.slot, lead.window_start,
                             lead.window_end, lead.gs_index)
        return (seg.t_start, seg.t_done, w, seg.segments)
    if best is None:
        return None
    return (best[0], best[1], best[2], ())


def _earliest_single_transfer(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    sat: Satellite,
    t: float,
    transfer_time: TransferTime,
    skip_window: SkipWindow = None,
    ledger: Optional[GSResourceLedger] = None,
) -> Optional[Tuple[float, float, VisibilityWindow]]:
    """The unsegmented single-window search of ``earliest_transfer``."""
    gss = predictor.ground_stations
    while True:
        built_end = predictor.built_end if predictor.rolling else np.inf
        best: Optional[Tuple[float, float, VisibilityWindow]] = None
        clipped_reject = False
        for w in predictor.windows_of(sat):
            if w.t_end <= t:
                continue
            if best is not None and w.t_start >= best[1]:
                break       # can no longer beat the achieved completion
            if skip_window is not None and skip_window(w):
                continue
            t0 = max(w.t_start, t)
            d = _distance_at(walker, gss[w.gs_index], sat, t0)
            need, done = transfer_time(w.gs_index, d)
            t_fit, done = _repriced_fit(
                ledger, walker, gss[w.gs_index], sat, w.gs_index,
                t0, w.t_end, transfer_time, need, done,
            )
            if t_fit is None:
                if w.t_end == built_end:
                    clipped_reject = True  # true end lies past the horizon
                continue
            if best is None or t_fit + done < best[1]:
                best = (t_fit, t_fit + done, w)
        if best is not None and not clipped_reject:
            # complete a chosen window still clipped at the built
            # boundary (its true end lies in the next chunk) so the
            # reported window matches a prebuilt table's
            if best[2].t_end == built_end and predictor.extend_once():
                continue
            return best
        if not predictor.extend_once():
            return best


def reserve_transfer(
    ledger: Optional[GSResourceLedger],
    gs_index: int,
    t0: float,
    t_done: float,
    segments: Tuple[TransferSegment, ...] = (),
) -> None:
    """Book one chosen upload on the ledger: each handover leg on its
    own station for exactly the leg span (the in-between gaps and the
    other stations' RBs stay free for other uploads), or the single
    ``[t0, t_done)`` interval when the transfer was not segmented.
    THE one booking rule — every strategy and planner routes through
    it.  No-op without a ledger (the contention-free degenerate
    case)."""
    if ledger is None:
        return
    if segments:
        for leg in segments:
            ledger.reserve(leg.gs_index, leg.t_start, leg.t_end)
    else:
        ledger.reserve(gs_index, t0, t_done)


def reserve_decision(
    ledger: Optional[GSResourceLedger],
    decision: Union["SinkDecision", "ClusterSinkDecision"],
) -> None:
    """Book a chosen sink upload (``SinkDecision`` or
    ``ClusterSinkDecision``) on the ledger so later transfer decisions
    are priced against the residual station capacity."""
    reserve_transfer(
        ledger,
        decision.window.gs_index,
        decision.t_upload_start,
        decision.t_upload_done,
        getattr(decision, "segments", ()),
    )


def select_sink(
    *,
    walker: WalkerDelta,
    gs: GroundStations,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    isl: ISLConfig,
    plane: int,
    t_train_done: Sequence[float],
    payload_bits: float,
    require_next_download: bool = False,
    ledger: Optional[GSResourceLedger] = None,
    handover: bool = False,
) -> Optional[SinkDecision]:
    """Deterministic sink selection for one orbital plane.

    Args:
      gs: the ground station(s), part of the scheduler's shared
        deterministic inputs.  With several, any station's window
        qualifies and the exchange is priced against the window's own
        station (per the predictor's gs_index tags — the predictor must
        be built over these same stations).
      t_train_done: per-slot local-training completion times (absolute
        simulation seconds); index = slot on this plane.
      payload_bits: model size z|N|.
      require_next_download: also require room for the next global-model
        download inside the same window (t_c^U + t_c^D).
      ledger: optional shared RB-capacity view; candidate uploads are
        priced against the residual capacity of each window's station.
        The caller books the returned decision (``reserve_decision``).
      handover: allow mid-window station handover — candidate uploads
        may be split into segments across different stations' windows
        (``plan_segmented_transfer``) and eq. 22's completion race runs
        over the segmented plans.  ``False`` (default) is bit-identical
        to the single-window scheduler.

    Returns:
      The SinkDecision, or None if no feasible window exists in the
      predictor's horizon (a rolling predictor extends and retries
      before giving up).

    Legacy shim: delegates to ``CommsEnvironment.select_sink`` (the
    ring is the degenerate graph — eq. 21's hop metric as a relay-
    latency matrix over the one shared cluster scheduler).
    """
    from repro_torch.comms.environment import CommsEnvironment

    env = CommsEnvironment(
        walker=walker, predictor=predictor, link=link, isl=isl,
        ledger=ledger, handover=handover, gs=gs,
    )
    return env.select_sink(
        plane=plane, t_train_done=t_train_done, payload_bits=payload_bits,
        require_next_download=require_next_download,
    )


def first_visible_download(
    *,
    walker: WalkerDelta,
    gs: GroundStations,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    plane: int,
    t: float,
    payload_bits: float,
) -> Optional[tuple]:
    """Earliest (slot, t_received) at which ANY satellite of the plane can
    finish downloading w^t from the GS after time t (§IV-A step 1).

    The GS broadcasts over the full uplink bandwidth; the first visible
    satellite of the plane becomes the propagation source.

    Legacy shim over ``CommsEnvironment.first_visible_download`` (the
    gs-matches-predictor check now lives in the session constructor).
    """
    from repro_torch.comms.environment import CommsEnvironment

    env = CommsEnvironment(
        walker=walker, predictor=predictor, link=link, gs=gs,
    )
    return env.first_visible_download(plane, t, payload_bits)


def first_visible_download_sats(
    *,
    walker: WalkerDelta,
    gs: GroundStations,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    sats: Sequence[Tuple[int, int]],
    t: float,
    payload_bits: float,
    _skip_gs_check: bool = False,
) -> Optional[tuple]:
    """Earliest (index into ``sats``, t_received) at which ANY of the
    listed satellites can finish downloading w^t from the GS after time
    t — ``first_visible_download`` over an arbitrary satellite set (a
    cluster of planes under the grid topology).

    Legacy shim over ``CommsEnvironment.first_visible_download_sats``.
    """
    from repro_torch.comms.environment import CommsEnvironment

    env = CommsEnvironment(
        walker=walker, predictor=predictor, link=link,
        gs=None if _skip_gs_check else gs,
    )
    return env.first_visible_download_sats(sats, t, payload_bits)


def _first_visible_download_sats_impl(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    sats: Sequence[Tuple[int, int]],
    t: float,
    payload_bits: float,
) -> Optional[tuple]:
    """The resolution machinery behind ``first_visible_download_sats``
    (and the session method of the same name)."""
    sats = list(sats)
    fits = _first_fit_transfers(
        walker=walker, predictor=predictor, sats=sats,
        t_ready=np.full(len(sats), float(t)),
        transfer_time=symmetric_transfer(uplink_time, link, payload_bits),
    )

    best_i, best_done = None, None
    for i in range(len(sats)):
        if fits[i] is None:
            continue
        done = fits[i][1]
        if best_done is None or done < best_done:
            best_i, best_done = i, done
    if best_i is None:
        return None
    return best_i, best_done


def naive_sink_slot(
    predictor: VisibilityPredictor, plane: int, t_ready: float
) -> Optional[int]:
    """Legacy shim over ``CommsEnvironment.naive_sink_slot`` with an
    explicit predictor (the session holds no other state this query
    touches); both call the one ``_naive_sink_slot_impl``."""
    return _naive_sink_slot_impl(predictor, plane, t_ready)


def _naive_sink_slot_impl(
    predictor: VisibilityPredictor, plane: int, t_ready: float
) -> Optional[int]:
    """The naive-sink ablation's slot choice: the plane's next visitor
    after t_ready, window duration ignored (earliest effective start,
    ties to the lowest slot).  One batched per-plane sweep instead of K
    scalar ``next_window`` calls.

    A plane with no window left inside the built horizon extends a
    rolling predictor and retries (near the horizon end the plane would
    otherwise silently drop out of the round); only when the horizon
    cannot grow further does it return None.
    """
    def attempt() -> Tuple[Optional[int], bool]:
        starts, _ = predictor.plane_next_window_starts(plane, t_ready)
        eff = np.maximum(starts, t_ready)
        if np.any(np.isfinite(eff)):
            return int(np.argmin(eff)), False
        return None, True

    return predictor.retry_extending(attempt)


@dataclasses.dataclass(frozen=True)
class ClusterSinkDecision:
    """Sink choice for a *cluster* of planes under the grid topology:
    one sink satellite collects every plane's trained models over
    cross-plane ISL relay and uploads the cluster partial in a single
    GS pass."""

    planes: Tuple[int, ...]
    sink: Satellite
    window: VisibilityWindow    # single-window upload, or the first leg's
    t_models_at_sink: float     # all cluster models collected
    t_upload_start: float
    t_upload_done: float
    t_wait: float
    candidates_considered: int
    # mid-window station handover legs (empty = single-window upload)
    segments: Tuple[TransferSegment, ...] = ()
    payload_bits: Optional[float] = None


def select_sink_cluster(
    *,
    walker: WalkerDelta,
    gs: GroundStations,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    sats: Sequence[Tuple[int, int]],
    relay_latency: np.ndarray,
    t_train_done: Sequence[float],
    payload_bits: float,
    require_next_download: bool = False,
    ledger: Optional[GSResourceLedger] = None,
    handover: bool = False,
) -> Optional[ClusterSinkDecision]:
    """Legacy shim over ``CommsEnvironment.select_sink_cluster`` —
    builds an ephemeral session from the explicit arguments (which
    also runs the gs-matches-predictor check) and delegates."""
    from repro_torch.comms.environment import CommsEnvironment

    env = CommsEnvironment(
        walker=walker, predictor=predictor, link=link,
        ledger=ledger, handover=handover, gs=gs,
    )
    return env.select_sink_cluster(
        sats=sats, relay_latency=relay_latency, t_train_done=t_train_done,
        payload_bits=payload_bits,
        require_next_download=require_next_download,
    )


def _select_sink_cluster_impl(
    *,
    walker: WalkerDelta,
    predictor: VisibilityPredictor,
    link: LinkConfig,
    sats: Sequence[Tuple[int, int]],
    relay_latency: np.ndarray,
    t_train_done: Sequence[float],
    payload_bits: float,
    require_next_download: bool = False,
    ledger: Optional[GSResourceLedger] = None,
    handover: bool = False,
) -> Optional[ClusterSinkDecision]:
    """Constellation-wide sink selection over an arbitrary satellite set.

    The eq. (21)/(22) machinery of ``select_sink`` with the ring hop
    metric replaced by a graph relay-latency matrix: candidate c's
    readiness is max_s(t_train_done[s] + relay_latency[c, s]), and the
    feasibility/completion rules are unchanged.  With ``sats`` = one
    plane and ``relay_latency = ring_hops_matrix(K) * t_hop`` this is
    bit-identical to ``select_sink`` (equivalence-tested).  With a
    ``ledger``, every candidate's upload is priced against the residual
    RB capacity of its window's station, so a saturated station loses
    the eq. (22) completion race to a station with free capacity — this
    is what load-balances cluster sinks across stations.  With
    ``handover`` every candidate may also split its upload into
    station-handover segments, so the completion race is priced over
    segmented plans (a candidate with no single long-enough window can
    still win through a split upload).
    """
    sats = list(sats)
    planes = tuple(sorted({p for p, _ in sats}))
    t_ready = np.max(
        np.asarray(t_train_done, dtype=np.float64)[None, :] + relay_latency,
        axis=1,
    )
    spec = (
        HandoverSpec(link, payload_bits, require_next_download)
        if handover else None
    )

    def exchange_time(_gi: int, d: float) -> Tuple[float, float]:
        t_dl = downlink_time(link, payload_bits, d)
        need = t_dl
        if require_next_download:
            need += uplink_time(link, payload_bits, d)
        return need, t_dl

    while True:
        fits = _first_fit_transfers(
            walker=walker, predictor=predictor, sats=sats,
            t_ready=t_ready, transfer_time=exchange_time, ledger=ledger,
            handover=spec,
        )

        best: Optional[ClusterSinkDecision] = None
        considered = 0
        for cand in range(len(sats)):
            if fits[cand] is None:
                continue
            if spec is not None:
                t0, t_done, w, segments = fits[cand]
            else:
                t0, t_done, j = fits[cand]
                w = predictor.windows_of(Satellite(*sats[cand]))[j]
                segments = ()
            considered += 1
            decision = ClusterSinkDecision(
                planes=planes,
                sink=Satellite(*sats[cand]),
                window=w,
                t_models_at_sink=float(t_ready[cand]),
                t_upload_start=t0,
                t_upload_done=t_done,
                t_wait=max(0.0, w.t_start - float(t_ready[cand])),
                candidates_considered=0,
                segments=segments,
                payload_bits=float(payload_bits),
            )
            # minimize completion; tie -> earliest window start
            if (
                best is None
                or decision.t_upload_done < best.t_upload_done - 1e-9
                or (
                    abs(decision.t_upload_done - best.t_upload_done) <= 1e-9
                    and decision.window.t_start < best.window.t_start
                )
            ):
                best = decision

        if best is None:
            return None
        # the chosen window may still be clipped at a rolling horizon's
        # built boundary — complete it so the reported window carries
        # its true end (the schedule itself is already final)
        if (
            predictor.rolling
            and best.window.t_end == predictor.built_end
            and predictor.extend_once()
        ):
            continue
        return dataclasses.replace(best, candidates_considered=considered)
