# Copied from src/repro/orbits/prediction.py; imports rebound to repro_torch.
"""Visibility prediction service used by the distributed scheduler.

The paper (§IV-B) predicts each satellite's visibility using the method
of Ali et al. [11].  Because every satellite knows the constellation
configuration and the GS position, each can deterministically compute the
same access-window table ``AW(k, GS)`` — this is what makes the sink
selection *distributed without coordination*: all satellites run the same
pure function of shared state and agree on the result.

``VisibilityPredictor`` precomputes windows over a horizon (one
vectorized ``visibility_table`` sweep per ground station) and answers:
  * next_window(sat, t): the first window with t_end > t,
  * next_window_with_duration(sat, t, min_duration): first window after t
    that is long enough (the AW(c_opt, GS) >= T*_sum constraint),
  * wait_time(sat, t): t_wait — time until the satellite next becomes
    visible (0 if currently inside a window).

Multi-GS support: pass a *sequence* of ground stations and the predictor
holds the union of every station's windows (each tagged with its
``gs_index``) — a satellite is schedulable whenever ANY station sees it.
Queries are O(log W) via per-satellite sorted start/cummax-end arrays
instead of the seed's linear scans.

Rolling horizon (``rolling=True``): instead of prebuilding the full
window table over ``1.5x`` the simulation horizon, the predictor builds
an initial chunk of ``horizon_s`` seconds and *extends* it
chunk-by-chunk (``extend_once`` / ``ensure_horizon``) as simulated time
advances — long multi-round runs pay for visibility prediction
incrementally, and the transfer planner extends-and-retries instead of
silently dropping a plane whose next window falls past the built
horizon.  Chunk boundaries are snapped to the coarse scan grid and
boundary-straddling windows are merged, so the incrementally grown
table is *identical* to a prebuilt table over the same range
(equivalence-tested).  ``max_horizon_s`` bounds the growth (a satellite
that never sees any station must not extend forever).
"""
from __future__ import annotations

import math
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

if TYPE_CHECKING:
    from repro_torch.obs.trace import TraceRecorder

from repro_torch.orbits.constellation import (
    GroundStation,
    MultiShellWalker,
    Satellite,
    WalkerDelta,
)
from repro_torch.orbits.visibility import (
    DEFAULT_MEM_BUDGET_MB,
    VisibilityWindow,
    WindowTable,
    visibility_table,
)

GroundStations = Union[GroundStation, Sequence[GroundStation]]


def as_gs_list(gs: GroundStations) -> List[GroundStation]:
    """Normalize a single station or a sequence into a list."""
    if isinstance(gs, GroundStation):
        return [gs]
    return list(gs)


def _merge_at_boundary(
    old: WindowTable, new: WindowTable, t_b: float, K: int
) -> WindowTable:
    """Stitch an extension chunk onto a station's table.

    A satellite visible at the chunk boundary produces a window clipped
    at ``t_b`` in the old table AND a window opening at ``t_b`` in the
    new chunk — the same physical pass.  Both chunks sample the exact
    boundary grid point, so the halves are matched by float equality
    and fused into the single window a prebuilt table would contain
    (this is what keeps the rolling table bit-identical to a prebuilt
    one).  Unmatched rows pass through untouched.
    """
    old_clip = np.flatnonzero(old.t_end == t_b)
    new_open = np.flatnonzero(new.t_start == t_b)
    if old_clip.size == 0 or new_open.size == 0:
        return WindowTable.concatenate([old, new]).sorted_by_start()
    by_sat = {
        int(old.plane[i]) * K + int(old.slot[i]): i for i in old_clip
    }
    t_end = old.t_end.copy()
    drop = np.zeros(len(new), dtype=bool)
    for j in new_open:
        i = by_sat.get(int(new.plane[j]) * K + int(new.slot[j]))
        if i is not None:
            t_end[i] = new.t_end[j]        # fuse the two halves
            drop[j] = True
    merged_old = WindowTable(
        plane=old.plane, slot=old.slot, t_start=old.t_start,
        t_end=t_end, gs_index=old.gs_index,
    )
    return WindowTable.concatenate(
        [merged_old, new.take(np.flatnonzero(~drop))]
    ).sorted_by_start()


class VisibilityPredictor:
    def __init__(
        self,
        walker: "WalkerDelta | MultiShellWalker",
        gs: GroundStations,
        horizon_s: float,
        t0: float = 0.0,
        coarse_step_s: float = 10.0,
        engine: str = "vectorized",
        rolling: bool = False,
        max_horizon_s: Optional[float] = None,
        mem_budget_mb: float = DEFAULT_MEM_BUDGET_MB,
    ):
        """Args:
          gs: one ground station, or a sequence for union-of-windows
            multi-GS scheduling.
          engine: "vectorized" (default) or "reference" — the scalar
            oracle, kept selectable for equivalence tests and benchmarks.
          rolling: build only an initial ``horizon_s`` chunk and let the
            table grow on demand (``extend_once``/``ensure_horizon``);
            requires the vectorized engine and a finite
            ``max_horizon_s`` (a never-visible satellite must not
            trigger unbounded extension).
          max_horizon_s: hard cap on the built horizon, measured from
            ``t0``; only meaningful with ``rolling=True``.
        """
        self.walker = walker
        gss = as_gs_list(gs)
        self.ground_stations: Tuple[GroundStation, ...] = tuple(gss)
        self.gs = gss[0]                       # primary station (back-compat)
        self.t0 = t0
        self.horizon_s = horizon_s
        self.coarse_step_s = coarse_step_s
        self.mem_budget_mb = float(mem_budget_mb)
        self.rolling = bool(rolling)
        if self.rolling:
            if engine != "vectorized":
                raise ValueError("rolling horizon needs the vectorized engine")
            if max_horizon_s is None or not np.isfinite(max_horizon_s):
                raise ValueError("rolling horizon needs a finite max_horizon_s")
            # chunk boundaries sit on the coarse scan grid, so every
            # incremental chunk samples exactly the grid points a
            # prebuilt table would — extension preserves bit-identity
            n = max(1, int(math.ceil(horizon_s / coarse_step_s - 1e-9)))
            self.chunk_s = n * coarse_step_s
            self.max_horizon_s = float(max_horizon_s)
        else:
            self.chunk_s = None
            self.max_horizon_s = None
        self._station_tables: List[WindowTable] = []
        # observability hook (repro.obs.TraceRecorder.attach): horizon
        # extensions + per-method query counters; None = untraced (the
        # query hot path pays one attribute check and nothing else)
        self.recorder: Optional["TraceRecorder"] = None

        if engine == "vectorized":
            end0 = (
                min(t0 + self.chunk_s, t0 + self.max_horizon_s)
                if self.rolling else t0 + horizon_s
            )
            self._station_tables = [
                visibility_table(
                    walker, g, t0, end0,
                    coarse_step_s=coarse_step_s, gs_index=i,
                    mem_budget_mb=self.mem_budget_mb,
                )
                for i, g in enumerate(gss)
            ]
            self._built_end = end0
            self.table = WindowTable.concatenate(
                self._station_tables
            ).sorted_by_start()
        elif engine == "reference":
            from repro_torch.orbits.visibility import visibility_windows_reference

            rows = []
            for i, g in enumerate(gss):
                for w in visibility_windows_reference(
                    walker, g, t0, t0 + horizon_s,
                    coarse_step_s=coarse_step_s,
                ):
                    rows.append((w.plane, w.slot, w.t_start, w.t_end, i))
            arr = np.asarray(rows, dtype=np.float64).reshape(-1, 5)
            self._built_end = t0 + horizon_s
            self.table = WindowTable(
                plane=arr[:, 0].astype(np.int32),
                slot=arr[:, 1].astype(np.int32),
                t_start=arr[:, 2],
                t_end=arr[:, 3],
                gs_index=arr[:, 4].astype(np.int32),
            ).sorted_by_start()
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self._reindex()

    def _reindex(self) -> None:
        """(Re)build the per-satellite query indexes from ``self.table``
        — called at construction and after every horizon extension."""
        # Per-satellite start-sorted slices of the table.  ``_cummax_end``
        # (running max of t_end in start order) makes "first window with
        # t_end > t" a single searchsorted even when multi-GS windows of
        # the same satellite overlap.
        self._by_sat: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        K = self.walker.config.sats_per_plane
        sat_ids = self.table.plane.astype(np.int64) * K + self.table.slot
        order = np.lexsort((self.table.t_start, sat_ids))
        sat_sorted = sat_ids[order]
        uniq, first_idx = np.unique(sat_sorted, return_index=True)
        bounds = list(first_idx) + [len(order)]
        for u, lo, hi in zip(uniq, bounds[:-1], bounds[1:]):
            idx = order[lo:hi]
            starts = self.table.t_start[idx]
            ends = self.table.t_end[idx]
            self._by_sat[(int(u) // K, int(u) % K)] = {
                "idx": idx,
                "starts": starts,
                "ends": ends,
                "cummax_end": np.maximum.accumulate(ends),
                "gs_index": self.table.gs_index[idx],
            }
        self._win_cache: Dict[Tuple[int, int], List[VisibilityWindow]] = {}
        self._plane_pads: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    # -- rolling horizon ---------------------------------------------------------
    @property
    def built_end(self) -> float:
        """End of the currently built window table (absolute seconds)."""
        return self._built_end

    def extend_once(self) -> bool:
        """Grow the window table by one chunk.  Returns False when the
        predictor is not rolling or ``max_horizon_s`` is reached —
        callers use the return value as their retry guard."""
        if not self.rolling:
            return False
        limit = self.t0 + self.max_horizon_s
        if self._built_end >= limit - 1e-6:
            return False
        new_end = min(self._built_end + self.chunk_s, limit)
        if self.recorder is not None:
            self.recorder.on_horizon_extend(self._built_end, new_end)
        for i, g in enumerate(self.ground_stations):
            chunk = visibility_table(
                self.walker, g, self._built_end, new_end,
                coarse_step_s=self.coarse_step_s, gs_index=i,
                mem_budget_mb=self.mem_budget_mb,
            )
            self._station_tables[i] = _merge_at_boundary(
                self._station_tables[i], chunk, self._built_end,
                self.walker.config.sats_per_plane,
            )
        self._built_end = new_end
        self.table = WindowTable.concatenate(
            self._station_tables
        ).sorted_by_start()
        self._reindex()
        return True

    def ensure_horizon(self, t_abs: float) -> bool:
        """Extend until the table covers ``t_abs`` (absolute seconds).
        Returns False if the cap stops growth short of ``t_abs``."""
        while self._built_end < t_abs:
            if not self.extend_once():
                return False
        return True

    def retry_extending(
        self, attempt: "Callable[[], Tuple[object, bool]]"
    ) -> object:
        """Run ``attempt() -> (result, retry)`` against the currently
        built table, growing the horizon one chunk and re-running while
        ``retry`` is truthy — the shared extend-and-retry discipline of
        every scheduling query near the rolling-horizon edge.  A
        planner signals ``retry`` whenever its answer depended on a
        window (or transfer *segment*) clipped at the built boundary —
        the true window end lies in the next chunk, so neither a
        rejection nor a boundary-truncated plan can be trusted.
        Returns the last attempt's result once it is stable or the
        horizon cannot grow (non-rolling predictors never extend)."""
        while True:
            result, retry = attempt()
            if not retry or not self.extend_once():
                return result

    def plane_window_supply(
        self, t0: float, t1: float
    ) -> np.ndarray:
        """(L, num_stations) seconds of predicted access-window overlap
        with ``[t0, t1]`` per (plane, station) — the window-supply
        signal that drives per-round dynamic cluster formation and
        station load-balancing."""
        if self.rolling:
            self.ensure_horizon(t1)        # best effort, capped
        L = self.walker.config.num_planes
        out = np.zeros((L, len(self.ground_stations)))
        ov = (
            np.minimum(self.table.t_end, t1)
            - np.maximum(self.table.t_start, t0)
        )
        m = ov > 0
        np.add.at(out, (self.table.plane[m], self.table.gs_index[m]), ov[m])
        return out

    # -- window access -----------------------------------------------------------
    @property
    def windows(self) -> List[VisibilityWindow]:
        return self.table.to_windows()

    def windows_of(self, sat: Satellite) -> List[VisibilityWindow]:
        if self.recorder is not None:
            self.recorder.on_predictor_query("windows_of")
        key = (sat.plane, sat.slot)
        if key not in self._win_cache:
            rec = self._by_sat.get(key)
            if rec is None:
                self._win_cache[key] = []
            else:
                self._win_cache[key] = [
                    self.table.window(i) for i in rec["idx"]
                ]
        return list(self._win_cache[key])

    def sat_arrays(self, plane: int, slot: int) -> Optional[Dict[str, np.ndarray]]:
        """Raw per-satellite window arrays (starts, ends, cummax_end,
        gs_index) in start order — the batch-query surface used by the
        vectorized scheduler."""
        if self.recorder is not None:
            self.recorder.on_predictor_query("sat_arrays")
        return self._by_sat.get((plane, slot))

    def _window_of(self, key: Tuple[int, int], j: int) -> VisibilityWindow:
        """The satellite's j-th window (start order) as ONE
        ``VisibilityWindow`` — reads the materialized ``windows_of``
        cache when a caller already paid for it, else constructs just
        this window from the table row.  The scalar queries
        (``next_window`` & co) return exactly one window per call, so
        materializing — and copying — the satellite's whole window list
        per query is pure overhead (the predictor_queries regression)."""
        wins = self._win_cache.get(key)
        if wins is not None:
            return wins[j]
        rec = self._by_sat[key]
        return self.table.window(int(rec["idx"][j]))

    def _first_index_ending_after(
        self, key: Tuple[int, int], t: float
    ) -> Optional[int]:
        """Index (in start order) of the first window with t_end > t."""
        rec = self._by_sat.get(key)
        if rec is None:
            return None
        # cummax_end is non-decreasing; the first index where it exceeds
        # t is exactly the first window whose own t_end exceeds t.
        j = int(rec["cummax_end"].searchsorted(t, side="right"))
        if j >= rec["starts"].size:
            return None
        return j

    # -- queries ----------------------------------------------------------------
    def current_window(
        self, sat: Satellite, t: float
    ) -> Optional[VisibilityWindow]:
        """Window containing t, if the satellite is visible right now."""
        if self.recorder is not None:
            self.recorder.on_predictor_query("current_window")
        key = (sat.plane, sat.slot)
        rec = self._by_sat.get(key)
        if rec is None:
            return None
        starts, ends = rec["starts"], rec["ends"]
        i = int(starts.searchsorted(t, side="right")) - 1
        while i >= 0 and rec["cummax_end"][i] >= t:
            if starts[i] <= t <= ends[i]:
                return self._window_of(key, i)
            i -= 1
        return None

    def next_window(
        self, sat: Satellite, t: float
    ) -> Optional[VisibilityWindow]:
        """First window with t_end > t (possibly the one containing t).

        A rolling predictor with no such window inside the built
        horizon extends and retries before giving up (None only once
        ``max_horizon_s`` is exhausted).  A window still clipped at the
        built boundary is completed first — its true end lies in the
        next chunk — so the result matches a prebuilt table."""
        if self.recorder is not None:
            self.recorder.on_predictor_query("next_window")
        key = (sat.plane, sat.slot)
        while True:
            j = self._first_index_ending_after(key, t)
            if j is not None:
                if (
                    self._by_sat[key]["ends"][j] == self._built_end
                    and self.extend_once()
                ):
                    continue               # boundary-clipped: complete it
                return self._window_of(key, j)
            if not self.extend_once():
                return None

    def next_window_with_duration(
        self, sat: Satellite, t: float, min_duration: float
    ) -> Optional[VisibilityWindow]:
        """First window after t whose *remaining* duration >= min_duration.

        This is the paper's sink feasibility constraint
        ``AW(c_opt, GS) >= T*_sum``: the access window must be long enough
        to exchange the partial global model with the GS.  Extends a
        rolling predictor when nothing fits inside the built horizon.
        """
        if self.recorder is not None:
            self.recorder.on_predictor_query("next_window_with_duration")
        key = (sat.plane, sat.slot)
        while True:
            j = self._first_index_ending_after(key, t)
            if j is not None:
                rec = self._by_sat[key]
                starts, ends = rec["starts"], rec["ends"]
                for i in range(j, starts.size):
                    if ends[i] <= t:
                        continue
                    effective_start = max(starts[i], t)
                    if ends[i] - effective_start >= min_duration:
                        if ends[i] == self._built_end and self.extend_once():
                            break          # clipped: complete it first
                        return self._window_of(key, i)
                else:
                    if not self.extend_once():
                        return None
                continue
            if not self.extend_once():
                return None

    def _plane_padded(self, plane: int) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, cummax_end) as (K, W+1) inf-padded matrices — the
        batch surface for one-sweep per-plane window queries."""
        if plane not in self._plane_pads:
            K = self.walker.config.sats_per_plane
            recs = [self._by_sat.get((plane, s)) for s in range(K)]
            width = max(
                (r["starts"].size for r in recs if r is not None), default=0
            )
            starts = np.full((K, width + 1), np.inf)
            cummax = np.full((K, width + 1), np.inf)
            for s, rec in enumerate(recs):
                if rec is None:
                    continue
                w = rec["starts"].size
                starts[s, :w] = rec["starts"]
                cummax[s, :w] = rec["cummax_end"]
            self._plane_pads[plane] = (starts, cummax)
        return self._plane_pads[plane]

    def plane_next_window_starts(
        self, plane: int, t: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """For every slot of a plane at once: (t_start, window index) of
        its first window with t_end > t — the batched equivalent of K
        ``next_window`` calls (one sweep over inf-padded per-plane
        arrays instead of K scalar bisections).  Slots with no such
        window get t_start=inf (their index points at padding).
        """
        if self.recorder is not None:
            self.recorder.on_predictor_query("plane_next_window_starts")
        starts, cummax = self._plane_padded(plane)
        # cummax_end is non-decreasing per row, so the count of entries
        # <= t is exactly searchsorted(..., side="right")
        idx = np.sum(cummax <= t, axis=1)
        return starts[np.arange(starts.shape[0]), idx], idx

    def wait_time(self, sat: Satellite, t: float) -> Optional[float]:
        """t_wait(k): time from t until the satellite is next visible."""
        w = self.next_window(sat, t)
        if w is None:
            return None
        return max(0.0, w.t_start - t)
