# Copied from src/repro/orbits/visibility.py; imports rebound to repro_torch.
"""Satellite-GS visibility: elevation angles, masks, and access windows.

The paper's visibility condition (§III):

  a satellite k is visible from GS g at time t iff the line-of-sight is
  not blocked by the Earth and the elevation angle is at least the GS's
  minimum elevation angle theta_min:

    angle(r_g(t), r_k(t) - r_g(t)) <= pi/2 - theta_min

which is equivalent to  elevation(k, g, t) >= theta_min.

Two implementations of the access-window extraction live here:

  * ``visibility_table`` / ``visibility_windows`` — the vectorized
    engine.  It samples the full (L, K, T) elevation tensor once
    (time-chunked so mega-constellation grids never materialize a
    multi-GB position tensor), finds every rise/set transition with one
    ``np.diff``, and refines ALL crossings of ALL satellites with a
    single batched bisection.  Windows come back as a ``WindowTable`` of
    structured NumPy arrays; ``VisibilityWindow`` dataclasses are thin
    views kept for API compatibility.
  * ``visibility_windows_reference`` — the original per-satellite
    per-crossing scalar loop, kept as the equivalence oracle for tests
    and the baseline for ``benchmarks/constellation_scaling.py``.

Both share the same clamped time grid (``_time_grid``), so a window can
never extend past the requested horizon.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import numpy as np

from repro_torch.orbits.constellation import (
    GroundStation,
    MultiShellWalker,
    WalkerDelta,
)

# Transient memory budget [MB] for the coarse elevation scan.  The scan
# is evaluated in time chunks whose length adapts to the constellation
# size so the per-chunk float64 working set stays under this budget at
# ANY scale (the pre-budget code pinned the chunk length at 2048
# samples, which over-allocated at paper scale and under-utilized —
# then overflowed transients at multi-shell scale).
DEFAULT_MEM_BUDGET_MB = 256.0

# Divisor turning a byte budget into a chunk length.  Measured on the
# 72x22 preset: ``WalkerDelta.elevations_from`` holds ~6.3 concurrently
# live (num_sats, chunk) float64 arrays (theta, trig temporaries, dot,
# |d|^2, sin_el); the rest of the headroom covers what chunking cannot
# shrink — the full-horizon boolean mask, the comparison slice, and the
# per-plane GS projection — so the whole table build (not just one
# chunk) peaks under the budget at 24 h+ horizons.
_SCAN_ARRAYS_PER_SAMPLE = 12
_MIN_CHUNK_T = 16


def scan_chunk_len(num_sats: int, mem_budget_mb: float) -> int:
    """Time-chunk length keeping the elevation scan's transient float64
    working set (~``_SCAN_ARRAYS_PER_SAMPLE`` arrays of shape
    ``(num_sats, chunk)``) under ``mem_budget_mb``.  Never below
    ``_MIN_CHUNK_T`` samples, so a tiny budget degrades to many small
    chunks instead of failing."""
    if mem_budget_mb <= 0:
        raise ValueError(f"mem_budget_mb must be positive, got {mem_budget_mb}")
    bytes_per_sample = max(1, int(num_sats)) * 8 * _SCAN_ARRAYS_PER_SAMPLE
    return max(_MIN_CHUNK_T, int(mem_budget_mb * 1e6 / bytes_per_sample))


def elevation_angle(r_sat: np.ndarray, r_gs: np.ndarray) -> np.ndarray:
    """Elevation of the satellite above the GS's local horizon [rad].

    Args:
      r_sat: (..., 3) satellite ECI positions [m].
      r_gs:  (..., 3) GS ECI positions [m] (broadcastable to r_sat).

    Returns:
      (...) elevation angles [rad]; >= 0 means above the horizon.
    """
    d = r_sat - r_gs
    d_norm = np.linalg.norm(d, axis=-1)
    g_norm = np.linalg.norm(r_gs, axis=-1)
    # sin(elevation) = (d . r_gs_hat) / |d|
    sin_el = np.einsum("...i,...i->...", d, r_gs) / (d_norm * g_norm)
    return np.arcsin(np.clip(sin_el, -1.0, 1.0))


def visibility_mask(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    t: np.ndarray,
    mem_budget_mb: float = DEFAULT_MEM_BUDGET_MB,
) -> np.ndarray:
    """Boolean visibility (L, K, T) of every satellite at every time.

    Evaluated in time chunks sized by ``scan_chunk_len``: the
    ``(L, K, Tc)`` float64 elevation transients are the only large
    intermediates and stay under ``mem_budget_mb`` at any
    constellation scale (the boolean output mask is 1/48th of the
    per-sample transient and is the only full-horizon allocation).
    Chunking only partitions the evaluation grid — every time sample
    is computed identically — so the mask is bit-identical across
    budgets.
    """
    scalar = np.ndim(t) == 0
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    min_el = np.radians(gs.min_elevation_deg)
    L, K = walker.config.num_planes, walker.config.sats_per_plane
    chunk = scan_chunk_len(L * K, mem_budget_mb)
    mask = np.empty((L, K, t.size), dtype=bool)
    for i in range(0, t.size, chunk):
        tc = t[i : i + chunk]
        el = walker.elevations_from(gs, tc)     # (L, K, Tc)
        mask[:, :, i : i + chunk] = el >= min_el
    return mask[:, :, 0] if scalar else mask


def _time_grid(t_start: float, t_end: float, step: float) -> np.ndarray:
    """Coarse scan grid clamped to [t_start, t_end].

    The final sample is exactly t_end (the historical
    ``arange(t_start, t_end + step, step)`` sampled past the horizon, so
    clipped windows could overshoot the requested range).
    """
    if t_end <= t_start:
        raise ValueError(f"empty scan range [{t_start}, {t_end}]")
    n = int(math.floor((t_end - t_start) / step + 1e-9))
    t = t_start + step * np.arange(n + 1, dtype=np.float64)
    if t[-1] < t_end - 1e-9 * max(1.0, abs(t_end)):
        t = np.append(t, t_end)
    else:
        t[-1] = min(t[-1], t_end)
    return t


@dataclasses.dataclass(frozen=True)
class VisibilityWindow:
    """One access window AW(k, GS): [t_start, t_end] of the r-th visit.

    ``gs_index`` identifies which ground station the window belongs to
    when a multi-GS predictor merges window sets (union semantics).
    """

    plane: int
    slot: int
    t_start: float
    t_end: float
    gs_index: int = 0

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    def contains(self, t: float) -> bool:
        return self.t_start <= t <= self.t_end


@dataclasses.dataclass(frozen=True)
class WindowTable:
    """Structured access-window storage: parallel arrays, one row per
    window, sorted by (t_start, plane, slot).

    This is the vectorized engine's native output; ``to_windows`` builds
    the ``VisibilityWindow`` dataclass views for the legacy list API.
    """

    plane: np.ndarray      # (W,) int32
    slot: np.ndarray       # (W,) int32
    t_start: np.ndarray    # (W,) float64
    t_end: np.ndarray      # (W,) float64
    gs_index: np.ndarray   # (W,) int32

    def __len__(self) -> int:
        return int(self.plane.size)

    def window(self, i: int) -> VisibilityWindow:
        return VisibilityWindow(
            plane=int(self.plane[i]),
            slot=int(self.slot[i]),
            t_start=float(self.t_start[i]),
            t_end=float(self.t_end[i]),
            gs_index=int(self.gs_index[i]),
        )

    def to_windows(self) -> List[VisibilityWindow]:
        return [self.window(i) for i in range(len(self))]

    def sorted_by_start(self) -> "WindowTable":
        order = np.lexsort((self.slot, self.plane, self.t_start))
        return self.take(order)

    def take(self, idx: np.ndarray) -> "WindowTable":
        return WindowTable(
            plane=self.plane[idx],
            slot=self.slot[idx],
            t_start=self.t_start[idx],
            t_end=self.t_end[idx],
            gs_index=self.gs_index[idx],
        )

    @staticmethod
    def empty() -> "WindowTable":
        z = np.zeros(0)
        return WindowTable(z.astype(np.int32), z.astype(np.int32),
                           z, z.copy(), z.astype(np.int32))

    @staticmethod
    def concatenate(tables: List["WindowTable"]) -> "WindowTable":
        if not tables:
            return WindowTable.empty()
        return WindowTable(
            plane=np.concatenate([t.plane for t in tables]),
            slot=np.concatenate([t.slot for t in tables]),
            t_start=np.concatenate([t.t_start for t in tables]),
            t_end=np.concatenate([t.t_end for t in tables]),
            gs_index=np.concatenate([t.gs_index for t in tables]),
        )


def _elevation_margin(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    planes: np.ndarray,
    slots: np.ndarray,
    t: np.ndarray,
    min_el: float,
) -> np.ndarray:
    """elevation - theta_min for arbitrary (plane, slot, t) triples."""
    r_s = walker.positions_batch(planes, slots, t)
    r_g = gs.eci(np.asarray(t, dtype=np.float64))
    return elevation_angle(r_s, r_g) - min_el


def _refine_crossings_batched(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    planes: np.ndarray,
    slots: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    rising: bool,
    min_el: float,
    iters: int = 40,
    mem_budget_mb: float = DEFAULT_MEM_BUDGET_MB,
) -> np.ndarray:
    """Bisection of EVERY elevation-threshold crossing simultaneously.

    Identical iteration count and update rule as the scalar
    ``_refine_crossing``, evaluated for all C crossings per step — the
    whole refinement is ``iters`` vectorized elevation evaluations
    instead of ``iters * C`` scalar ones.  Crossings are processed in
    budget-bounded batches (each crossing's bisection is independent,
    so batching is result-invariant): ``positions_batch`` materializes
    several ``(C, 3)`` float64 temporaries per evaluation, which at
    multi-shell scale would otherwise rival the scan transient.
    """
    lo = np.array(lo, dtype=np.float64)
    hi = np.array(hi, dtype=np.float64)
    out = np.empty_like(lo)
    # ~12 live float64 arrays per crossing per evaluation ((C, 3)
    # positions + trig temporaries), vs _SCAN_ARRAYS_PER_SAMPLE flat
    # ones in the scan — reuse the same budget arithmetic scaled by 2
    batch = max(_MIN_CHUNK_T, int(mem_budget_mb * 1e6 / (8 * 12)))
    for b in range(0, lo.size, batch):
        s = slice(b, b + batch)
        blo, bhi = lo[s], hi[s]
        bplanes, bslots = planes[s], slots[s]
        for _ in range(iters):
            mid = 0.5 * (blo + bhi)
            above = (
                _elevation_margin(walker, gs, bplanes, bslots, mid, min_el)
                >= 0.0
            )
            go_hi = above == rising     # crossing is in [lo, mid]
            bhi = np.where(go_hi, mid, bhi)
            blo = np.where(go_hi, blo, mid)
        out[s] = 0.5 * (blo + bhi)
    return out


def visibility_table(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    t_start: float,
    t_end: float,
    coarse_step_s: float = 10.0,
    refine: bool = True,
    gs_index: int = 0,
    mem_budget_mb: float = DEFAULT_MEM_BUDGET_MB,
) -> WindowTable:
    """All access windows of every satellite within [t_start, t_end],
    as a structured ``WindowTable`` (the vectorized engine).

    Coarse grid scan + one batched bisection over every rise/set
    crossing of every satellite (the deterministic analogue of the
    visibility prediction method of Ali et al. [11] used by the paper's
    scheduler, at constellation scale).  ``mem_budget_mb`` bounds the
    transient working set of the scan and the bisection batches; the
    returned table is bit-identical across budgets.
    """
    t = _time_grid(t_start, t_end, coarse_step_s)
    mask = visibility_mask(walker, gs, t, mem_budget_mb=mem_budget_mb)
    min_el = float(np.radians(gs.min_elevation_deg))
    K = walker.config.sats_per_plane

    # Transition extraction on boolean views (rise = below->above,
    # set = above->below): one (L, K, T-1) bool temporary at a time,
    # freed before the next — the historical int8 ``np.diff`` held an
    # int8 copy of the whole mask PLUS the diff output concurrently.
    prev, nxt = mask[:, :, :-1], mask[:, :, 1:]     # views, no copies
    rise = ~prev & nxt
    rise_p, rise_s, rise_i = np.nonzero(rise)
    del rise
    fall = prev & ~nxt
    set_p, set_s, set_i = np.nonzero(fall)
    del fall

    if refine and rise_i.size:
        rise_t = _refine_crossings_batched(
            walker, gs, rise_p, rise_s, t[rise_i], t[rise_i + 1],
            rising=True, min_el=min_el, mem_budget_mb=mem_budget_mb,
        )
    else:
        rise_t = t[rise_i + 1]
    if refine and set_i.size:
        set_t = _refine_crossings_batched(
            walker, gs, set_p, set_s, t[set_i], t[set_i + 1],
            rising=False, min_el=min_el, mem_budget_mb=mem_budget_mb,
        )
    else:
        set_t = t[set_i]

    # windows clipped by the scan range open at t[0] / close at t[-1]
    clip_lo_p, clip_lo_s = np.nonzero(mask[:, :, 0])
    clip_hi_p, clip_hi_s = np.nonzero(mask[:, :, -1])

    start_p = np.concatenate([clip_lo_p, rise_p])
    start_s = np.concatenate([clip_lo_s, rise_s])
    start_t = np.concatenate(
        [np.full(clip_lo_p.size, t[0]), np.asarray(rise_t, dtype=np.float64)]
    )
    end_p = np.concatenate([set_p, clip_hi_p])
    end_s = np.concatenate([set_s, clip_hi_s])
    end_t = np.concatenate(
        [np.asarray(set_t, dtype=np.float64), np.full(clip_hi_p.size, t[-1])]
    )

    # Per satellite the 1-D mask alternates rise/set, so start and end
    # counts match; sorting both sides by (satellite, time) pairs the
    # r-th start with the r-th end of the same satellite.
    start_order = np.lexsort((start_t, start_p * K + start_s))
    end_order = np.lexsort((end_t, end_p * K + end_s))
    sp = start_p[start_order]
    ss = start_s[start_order]
    st = start_t[start_order]
    et = end_t[end_order]

    keep = et > st            # drop degenerate single-sample windows
    table = WindowTable(
        plane=sp[keep].astype(np.int32),
        slot=ss[keep].astype(np.int32),
        t_start=st[keep],
        t_end=et[keep],
        gs_index=np.full(int(np.count_nonzero(keep)), gs_index,
                         dtype=np.int32),
    )
    return table.sorted_by_start()


def visibility_windows(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    t_start: float,
    t_end: float,
    coarse_step_s: float = 10.0,
    refine: bool = True,
    mem_budget_mb: float = DEFAULT_MEM_BUDGET_MB,
) -> List[VisibilityWindow]:
    """Vectorized access-window extraction, legacy list-of-dataclass API.

    Returns windows sorted by t_start.
    """
    return visibility_table(
        walker, gs, t_start, t_end, coarse_step_s=coarse_step_s,
        refine=refine, mem_budget_mb=mem_budget_mb,
    ).to_windows()


# --- scalar reference implementation (equivalence oracle + benchmark baseline) ---
def _refine_crossing(
    f: "Callable[[float], float]",
    lo: float,
    hi: float,
    rising: bool,
    iters: int = 40,
) -> float:
    """Bisection root of the elevation-threshold crossing in [lo, hi]."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = f(mid) >= 0.0
        if above == rising:
            # crossing is in [lo, mid] for rising (f goes -..+), symmetric
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def visibility_windows_reference(
    walker: "WalkerDelta | MultiShellWalker",
    gs: GroundStation,
    t_start: float,
    t_end: float,
    coarse_step_s: float = 10.0,
    refine: bool = True,
) -> List[VisibilityWindow]:
    """The original per-satellite scalar loop (per-crossing bisection).

    Kept as the oracle the vectorized engine is tested against and as
    the baseline of ``benchmarks/constellation_scaling.py``.  Returns
    windows sorted by t_start.
    """
    t = _time_grid(t_start, t_end, coarse_step_s)
    mask = visibility_mask(walker, gs, t)          # (L, K, T)
    min_el = np.radians(gs.min_elevation_deg)

    windows: List[VisibilityWindow] = []
    L, K, T = mask.shape
    for p in range(L):
        for s in range(K):
            m = mask[p, s]
            # transitions: diff +1 = rise between i and i+1; -1 = set
            dm = np.diff(m.astype(np.int8))
            rises = list(np.nonzero(dm == 1)[0])
            sets_ = list(np.nonzero(dm == -1)[0])
            # handle windows clipped by the scan interval
            starts: List[float] = []
            ends: List[float] = []
            sat = walker.satellites[p * K + s]

            def el_fn(tt: float) -> float:
                r_s = walker.position_of(sat, tt)
                r_g = gs.eci(np.asarray(tt))
                return float(elevation_angle(r_s, r_g) - min_el)

            if m[0]:
                starts.append(t[0])
            for i in rises:
                if refine:
                    starts.append(_refine_crossing(el_fn, t[i], t[i + 1], True))
                else:
                    starts.append(t[i + 1])
            for i in sets_:
                if refine:
                    ends.append(_refine_crossing(el_fn, t[i], t[i + 1], False))
                else:
                    ends.append(t[i])
            if m[-1]:
                ends.append(t[-1])
            for a, b in zip(starts, ends):
                if b > a:
                    windows.append(
                        VisibilityWindow(plane=p, slot=s, t_start=a, t_end=b)
                    )
    windows.sort(key=lambda w: w.t_start)
    return windows
