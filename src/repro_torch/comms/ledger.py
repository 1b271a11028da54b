# Copied from src/repro/comms/ledger.py; imports rebound to repro_torch.
"""Per-station downlink resource-block ledger (contention accounting).

The paper's resource model (§IV-B, eqs. 13-16) gives each ground
station ``N`` downlink resource blocks of bandwidth ``B_D = B / N``:
every sink upload occupies ONE RB for the duration of its transfer.
The seed scheduler priced every transfer as if each station were
private to one satellite — under ``FedLEOGrid`` several cluster sinks
can land uploads on the same station's windows, so concurrent uploads
must now *compete* for the station's RB pool.

``GSResourceLedger`` is that shared capacity view: a per-station
timeline of reserved ``[t0, t1)`` occupancy intervals.  The transfer
planner (``core/scheduling.py``) prices every candidate window against
the *residual* capacity — ``earliest_fit`` returns the earliest start
inside a window at which a free RB exists for the whole transfer — and
the strategy reserves the chosen interval, so later transfer decisions
of the same round (and of later rounds; simulated time is monotone)
see the booked capacity.

Semantics:
  * Only sink *uploads* (satellite -> GS over one RB, eq. 16) reserve
    capacity.  The global-model *download* is a GS broadcast of the
    same ``w^t`` over the full uplink band (eq. 15) — simultaneous
    receivers share one transmission, so it is not RB-contended.
  * Occupancy intervals are half-open ``[t0, t1)``: a transfer may
    start at the exact instant another ends.
  * ``capacity=None`` means unlimited — the contention-free degenerate
    case, bit-identical to the pre-ledger planner (``earliest_fit``
    returns ``lo`` untouched).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


class GSResourceLedger:
    """Per-station resource-block occupancy timeline.

    Args:
      num_stations: stations indexed by the predictor's ``gs_index``.
      capacity: concurrent-RB cap per station — one int for all, a
        per-station sequence, or None for unlimited (contention-free).
    """

    def __init__(
        self,
        num_stations: int,
        capacity: Union[int, Sequence[int], None],
    ):
        self.num_stations = int(num_stations)
        if capacity is None:
            caps: List[float] = [np.inf] * self.num_stations
        elif np.ndim(capacity) == 0:
            caps = [float(capacity)] * self.num_stations
        else:
            caps = [float(c) for c in capacity]
            if len(caps) != self.num_stations:
                raise ValueError(
                    f"{len(caps)} capacities for {self.num_stations} stations"
                )
        if any(c < 1 for c in caps):
            raise ValueError(f"station capacity must be >= 1, got {caps}")
        self.capacity: Tuple[float, ...] = tuple(caps)
        self._starts: List[List[float]] = [[] for _ in range(self.num_stations)]
        self._ends: List[List[float]] = [[] for _ in range(self.num_stations)]
        # parallel booking ids: the identity handle `reserve` returns,
        # unique across the ledger's lifetime (never reused), so two
        # sessions booking IDENTICAL [t0, t1) intervals on one station
        # stay distinguishable at release time
        self._bids: List[List[int]] = [[] for _ in range(self.num_stations)]
        self._next_bid: int = 0
        # busy-run cache per station: the planner calls earliest_fit
        # once per candidate window, but the ledger only changes at
        # reserve()/release_before() — recompute the sweep lazily
        self._busy: List[Optional[Tuple[np.ndarray, np.ndarray]]] = (
            [None] * self.num_stations
        )

    # -- bookkeeping -----------------------------------------------------------
    def reserve(self, gs_index: int, t0: float, t1: float) -> Optional[int]:
        """Book one RB of station ``gs_index`` over ``[t0, t1)``.

        Returns the booking id identifying THIS booking (hand it back to
        ``release_booking``), or None for zero-length reservations,
        which occupy nothing and need no release.
        """
        if t1 < t0:
            raise ValueError(f"reservation ends before it starts: [{t0}, {t1})")
        if t1 > t0:            # zero-length reservations occupy nothing
            bid = self._next_bid
            self._next_bid += 1
            self._starts[gs_index].append(float(t0))
            self._ends[gs_index].append(float(t1))
            self._bids[gs_index].append(bid)
            self._busy[gs_index] = None
            return bid
        return None

    def reservations(self, gs_index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of every booked interval, in booking order."""
        return (
            np.asarray(self._starts[gs_index], dtype=np.float64),
            np.asarray(self._ends[gs_index], dtype=np.float64),
        )

    def num_reserved(self) -> int:
        return sum(len(s) for s in self._starts)

    def release_booking(self, gs_index: int, booking_id: int) -> None:
        """Give the booking identified by ``booking_id`` back to the
        pool — the reservation-release half of the lifecycle
        (``CommsEnvironment.release``): freed capacity is visible to
        every later ``earliest_fit``/``free_runs`` query.

        Ids are unique across the ledger, so concurrent sessions that
        booked identical intervals can only ever release their OWN
        booking.  Raises ValueError when the id is not booked on the
        station (double release / never booked).
        """
        bids = self._bids[gs_index]
        try:
            i = bids.index(booking_id)
        except ValueError:
            raise ValueError(
                f"no booking id {booking_id} to release on station {gs_index}"
            ) from None
        del self._starts[gs_index][i]
        del self._ends[gs_index][i]
        del bids[i]
        self._busy[gs_index] = None

    def release(self, gs_index: int, t0: float, t1: float) -> None:
        """DEPRECATED back-compat shim: release the most recent booking
        exactly matching ``[t0, t1)``.  Interval identity is ambiguous
        under multi-tenancy (two sessions can book identical intervals
        on one station) and brittle to float drift in re-priced legs —
        key releases on the id ``reserve`` returned via
        ``release_booking`` instead.  Zero-length intervals were never
        stored and release as a no-op.
        """
        t0, t1 = float(t0), float(t1)
        if t1 <= t0:
            return
        s, e = self._starts[gs_index], self._ends[gs_index]
        for i in range(len(s) - 1, -1, -1):
            if s[i] == t0 and e[i] == t1:
                self.release_booking(gs_index, self._bids[gs_index][i])
                return
        raise ValueError(
            f"no booking [{t0}, {t1}) to release on station {gs_index}"
        )

    def release_before(self, t: float) -> None:
        """Drop intervals that ended at or before ``t`` (the simulated
        clock is monotone, so past bookings can never affect a fit)."""
        for i in range(self.num_stations):
            keep = [
                (a, b, bid)
                for a, b, bid in zip(
                    self._starts[i], self._ends[i], self._bids[i]
                )
                if b > t
            ]
            self._starts[i] = [a for a, _, _ in keep]
            self._ends[i] = [b for _, b, _ in keep]
            self._bids[i] = [bid for _, _, bid in keep]
            self._busy[i] = None

    # -- capacity queries ------------------------------------------------------
    def occupancy(self, gs_index: int, t: float) -> int:
        """Number of RBs of the station busy at instant ``t``."""
        s, e = self.reservations(gs_index)
        return int(np.count_nonzero((s <= t) & (t < e)))

    def busy_intervals(
        self, gs_index: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Maximal ``[a, b)`` intervals where occupancy >= capacity —
        vectorized sweep over the station's reservation events, cached
        between ledger mutations."""
        cached = self._busy[gs_index]
        if cached is not None:
            return cached
        out = self._busy_sweep(gs_index)
        self._busy[gs_index] = out
        return out

    def _busy_sweep(
        self, gs_index: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        cap = self.capacity[gs_index]
        s, e = self.reservations(gs_index)
        if s.size == 0 or not np.isfinite(cap) or s.size < cap:
            z = np.zeros(0)
            return z, z.copy()
        times = np.concatenate([s, e])
        deltas = np.concatenate(
            [np.ones(s.size, dtype=np.int64), -np.ones(e.size, dtype=np.int64)]
        )
        # ends sort before starts at equal times: half-open [t0, t1)
        order = np.lexsort((deltas, times))
        times, occ = times[order], np.cumsum(deltas[order])
        busy = occ >= cap                   # over segment [times[k], times[k+1])
        prev = np.concatenate([[False], busy[:-1]])
        run_start = np.flatnonzero(busy & ~prev)
        run_end = np.searchsorted(
            np.flatnonzero(~busy), run_start, side="left"
        )
        free_idx = np.flatnonzero(~busy)
        # a busy run ends at the first not-busy event after it; cumsum
        # ends at occupancy 0, so a terminal free event always exists
        a = times[run_start]
        b = times[free_idx[run_end]]
        keep = b > a                        # drop zero-length runs
        return a[keep], b[keep]

    def free_runs(
        self, gs_index: int, lo: float, hi: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Maximal ``[a, b)`` sub-intervals of ``[lo, hi)`` where at
        least one RB of the station is free (occupancy < capacity), in
        time order — the complement of ``busy_intervals`` clipped to
        the query range.  The segmented (handover) transfer planner
        prices candidate upload legs against these stretches.

        Unlimited capacity returns the whole ``[lo, hi)`` untouched
        (the contention-free degenerate case).
        """
        if hi <= lo:
            z = np.zeros(0)
            return z, z.copy()
        a, b = self.busy_intervals(gs_index)
        starts: List[float] = [float(lo)]
        ends: List[float] = []
        for ba, bb in zip(a, b):        # busy runs are sorted, disjoint
            if bb <= lo or ba >= hi:
                continue
            ends.append(float(max(lo, ba)))
            starts.append(float(min(hi, bb)))
        ends.append(float(hi))
        s = np.asarray(starts, dtype=np.float64)
        e = np.asarray(ends, dtype=np.float64)
        keep = e > s
        return s[keep], e[keep]

    def booked_seconds(self, gs_index: int, t0: float, t1: float) -> float:
        """Total reserved RB-seconds of the station overlapping
        ``[t0, t1]`` (concurrent reservations count multiply)."""
        s, e = self.reservations(gs_index)
        if s.size == 0:
            return 0.0
        ov = np.minimum(e, t1) - np.maximum(s, t0)
        return float(np.sum(ov[ov > 0]))

    def residual_fraction(self, t0: float, t1: float) -> np.ndarray:
        """Per-station fraction of RB capacity still unbooked over
        ``[t0, t1]`` — 1.0 for unlimited stations and empty ledgers
        (the degenerate cases), falling toward 0.0 as a station's RB
        pool saturates.  Cluster formation uses this to discount the
        predicted window supply of stations already loaded this round
        (contention-aware formation feedback)."""
        out = np.ones(self.num_stations, dtype=np.float64)
        span = t1 - t0
        if span <= 0:
            return out
        for i in range(self.num_stations):
            cap = self.capacity[i]
            if not np.isfinite(cap):
                continue
            out[i] = max(
                0.0, 1.0 - self.booked_seconds(i, t0, t1) / (cap * span)
            )
        return out

    def earliest_fit(
        self,
        gs_index: int,
        lo: float,
        hi_start: float,
        duration: float,
    ) -> Optional[float]:
        """Earliest ``t0`` in ``[lo, hi_start]`` such that a free RB
        exists over all of ``[t0, t0 + duration)``, or None.

        With unlimited capacity this is exactly ``lo`` (the pre-ledger
        planner's effective start) whenever ``lo <= hi_start``.
        """
        if lo > hi_start:
            return None
        if not np.isfinite(self.capacity[gs_index]):
            return lo
        a, b = self.busy_intervals(gs_index)
        t0 = float(lo)
        for ba, bb in zip(a, b):
            if bb <= t0:
                continue                    # busy run already over
            if ba >= t0 + duration:
                break                       # transfer fits before this run
            t0 = float(bb)                  # push past the saturated run
        return t0 if t0 <= hi_start else None
