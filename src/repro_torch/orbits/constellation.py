# Copied from src/repro/orbits/constellation.py; imports rebound to repro_torch.
"""Walker-delta LEO constellation geometry.

Implements the system model of FedLEO §III: a constellation ``K`` of
``L`` orbital planes, each with ``K`` equally spaced satellites, every
plane at altitude ``h_l`` with inclination ``alpha_l``.  Satellites move
on circular orbits; the ground station (GS) is fixed on the rotating
Earth.  All positions are computed in an Earth-centered inertial (ECI)
frame, vectorized over a time grid with numpy (the simulator substrate
is host-side; the learning substrate is JAX).

Physical model
--------------
  v_l = sqrt(GM / (R_E + h_l))                       (orbital speed)
  T_l = 2*pi / sqrt(GM) * (R_E + h_l)^(3/2)          (orbital period)

A Walker-delta constellation ``i: T/P/F`` spreads P planes' RAAN evenly
over 2*pi and phases satellites between adjacent planes by
``2*pi*F/(K*P)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

# --- physical constants (SI) -------------------------------------------------
G = 6.674e-11                 # gravitational constant [m^3 kg^-1 s^-2]
M_EARTH = 5.972e24            # Earth mass [kg]
GM = G * M_EARTH              # standard gravitational parameter [m^3 s^-2]
R_EARTH = 6371.0e3            # Earth radius [m] (paper: R_E = 6371 km)
OMEGA_EARTH = 7.2921159e-5    # Earth rotation rate [rad/s]
C_LIGHT = 299_792_458.0       # speed of light [m/s]


def orbital_speed(altitude_m: float) -> float:
    """v_l = sqrt(GM / (R_E + h_l))  [m/s]."""
    return math.sqrt(GM / (R_EARTH + altitude_m))


def orbital_period(altitude_m: float) -> float:
    """T_l = 2*pi/sqrt(GM) * (R_E + h_l)^{3/2}  [s]."""
    return 2.0 * math.pi / math.sqrt(GM) * (R_EARTH + altitude_m) ** 1.5


def _rot_z(angle: np.ndarray) -> np.ndarray:
    """Rotation matrices about z; angle may be an array (..., ) -> (..., 3, 3)."""
    c, s = np.cos(angle), np.sin(angle)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    return np.stack(
        [
            np.stack([c, -s, zeros], axis=-1),
            np.stack([s, c, zeros], axis=-1),
            np.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )


def _rot_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


@dataclasses.dataclass(frozen=True)
class Satellite:
    """Identity of one satellite: plane index and in-plane slot index."""

    plane: int
    slot: int

    @property
    def name(self) -> str:
        return f"ID_{self.plane + 1},{self.slot + 1}"


@dataclasses.dataclass(frozen=True)
class GroundStation:
    """A ground station fixed on the rotating Earth.

    The paper's GS is in Rolla, MO, USA (lat 37.95 N, lon -91.77 E) with a
    minimum elevation angle of 10 degrees.
    """

    lat_deg: float = 37.9485
    lon_deg: float = -91.7715
    alt_m: float = 340.0
    min_elevation_deg: float = 10.0
    name: str = "Rolla-MO"

    def ecef(self) -> np.ndarray:
        """Position in the Earth-fixed frame (spherical Earth)."""
        lat = math.radians(self.lat_deg)
        lon = math.radians(self.lon_deg)
        r = R_EARTH + self.alt_m
        return np.array(
            [
                r * math.cos(lat) * math.cos(lon),
                r * math.cos(lat) * math.sin(lon),
                r * math.sin(lat),
            ]
        )

    def eci(self, t: np.ndarray, gst0: float = 0.0) -> np.ndarray:
        """ECI trajectory r_g(t): Earth-fixed point rotated by OMEGA_EARTH*t.

        Args:
          t: times [s], shape (T,) (or scalar).
          gst0: Greenwich sidereal angle at t=0 [rad].

        Returns:
          (T, 3) (or (3,)) ECI positions [m].
        """
        t = np.asarray(t, dtype=np.float64)
        theta = OMEGA_EARTH * t + gst0
        rot = _rot_z(theta)                      # (T, 3, 3)
        return rot @ self.ecef()


@dataclasses.dataclass(frozen=True)
class ConstellationConfig:
    """Walker-delta constellation parameters (paper §V-A defaults).

    40 satellites evenly on 5 orbits at 1500 km altitude, 80 deg
    inclination.
    """

    num_planes: int = 5
    sats_per_plane: int = 8
    altitude_m: float = 1500.0e3
    inclination_deg: float = 80.0
    phasing_factor: int = 1      # Walker F parameter
    raan_spread: float = 2.0 * math.pi  # delta pattern spreads RAAN over 2*pi

    @property
    def num_satellites(self) -> int:
        return self.num_planes * self.sats_per_plane

    @property
    def period_s(self) -> float:
        return orbital_period(self.altitude_m)

    @property
    def speed_ms(self) -> float:
        return orbital_speed(self.altitude_m)


class WalkerDelta:
    """Deterministic propagator for a Walker-delta constellation.

    Positions are exact closed-form circular-orbit solutions, so the
    "predictability of satellite orbiting patterns" the paper's scheduler
    exploits is available to every satellite by construction.
    """

    def __init__(self, config: ConstellationConfig):
        self.config = config
        L, K = config.num_planes, config.sats_per_plane
        self.radius = R_EARTH + config.altitude_m
        self.mean_motion = 2.0 * math.pi / config.period_s
        inc = math.radians(config.inclination_deg)

        # Per-plane rotation: R_z(RAAN_p) @ R_x(inclination).
        self._plane_rot = np.zeros((L, 3, 3))
        for p in range(L):
            raan = config.raan_spread * p / L
            self._plane_rot[p] = _rot_z(np.array(raan)) @ _rot_x(inc)

        # Initial in-plane phase per (plane, slot): slot spacing + Walker
        # inter-plane phasing  2*pi*F*p/(K*L).
        slots = np.arange(K)
        planes = np.arange(L)
        self._phase0 = (
            2.0 * math.pi * slots[None, :] / K
            + 2.0 * math.pi * config.phasing_factor * planes[:, None] / (K * L)
        )  # (L, K)

    @property
    def satellites(self) -> Sequence[Satellite]:
        return [
            Satellite(plane=p, slot=s)
            for p in range(self.config.num_planes)
            for s in range(self.config.sats_per_plane)
        ]

    def positions(self, t: np.ndarray) -> np.ndarray:
        """ECI positions r_k(t) for every satellite.

        Args:
          t: times [s], shape (T,) or scalar.

        Returns:
          array (L, K, T, 3) of ECI positions [m] (T axis squeezed for
          scalar input).
        """
        t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
        theta = self._phase0[..., None] + self.mean_motion * t_arr  # (L,K,T)
        in_plane = self.radius * np.stack(
            [np.cos(theta), np.sin(theta), np.zeros_like(theta)], axis=-1
        )  # (L, K, T, 3)
        out = np.einsum("pij,pktj->pkti", self._plane_rot, in_plane)
        if np.isscalar(t) or np.ndim(t) == 0:
            out = out[:, :, 0, :]
        return out

    def positions_batch(
        self,
        planes: np.ndarray,
        slots: np.ndarray,
        t: np.ndarray,
    ) -> np.ndarray:
        """ECI positions for arbitrary (plane, slot, time) triples.

        All three arguments broadcast against each other; the result has
        the broadcast shape + (3,).  This is the gather-style evaluation
        the vectorized visibility/scheduling engine uses: one call covers
        every rise/set crossing (or every candidate sink) at once instead
        of K x windows scalar ``position_of`` calls.
        """
        planes = np.asarray(planes, dtype=np.intp)
        slots = np.asarray(slots, dtype=np.intp)
        t = np.asarray(t, dtype=np.float64)
        planes, slots, t = np.broadcast_arrays(planes, slots, t)
        theta = self._phase0[planes, slots] + self.mean_motion * t
        unit = np.stack(
            [np.cos(theta), np.sin(theta), np.zeros_like(theta)], axis=-1
        )
        rot = self._plane_rot[planes]                  # (..., 3, 3)
        return self.radius * np.einsum("...ij,...j->...i", rot, unit)

    def elevations_from(
        self, gs: GroundStation, t: np.ndarray
    ) -> np.ndarray:
        """Elevation (L, K, T) of every satellite above gs's horizon [rad],
        without materializing the (L, K, T, 3) position tensor.

        Every satellite sits at |r_sat| = radius, so only the dot product
        r_sat . r_gs is needed:

          r_sat . r_gs = radius * u(theta) . (R_p^T r_gs)

        with u(theta) the in-plane unit vector — project the GS
        trajectory into each plane frame once (L, T, 3) instead of
        rotating every satellite out (L, K, T, 3).  |d|^2 then follows
        from the law of cosines.  ~5x less memory traffic than the
        positions-based path; lives here so the plane-frame internals
        (_plane_rot, _phase0) stay encapsulated.
        """
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        r_gs = gs.eci(t)                                 # (T, 3)
        g2 = float(np.dot(gs.ecef(), gs.ecef()))         # |r_gs|^2 const
        g_norm = math.sqrt(g2)
        # GS trajectory in each plane frame: R_p^T r_gs -> (L, T, 3)
        g_proj = np.einsum("pji,tj->pti", self._plane_rot, r_gs)
        theta = (
            self._phase0[:, :, None]
            + self.mean_motion * t[None, None, :]
        )                                                # (L, K, T)
        # r_sat . r_gs, with u(theta) = (cos, sin, 0) in the plane frame
        dot = self.radius * (
            np.cos(theta) * g_proj[:, None, :, 0]
            + np.sin(theta) * g_proj[:, None, :, 1]
        )
        d2 = self.radius**2 + g2 - 2.0 * dot             # |r_sat - r_gs|^2
        sin_el = (dot - g2) / (np.sqrt(d2) * g_norm)
        return np.arcsin(np.clip(sin_el, -1.0, 1.0))

    def position_of(self, sat: Satellite, t: np.ndarray) -> np.ndarray:
        """ECI position of one satellite at times t: (T, 3) or (3,)."""
        t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
        theta = self._phase0[sat.plane, sat.slot] + self.mean_motion * t_arr
        in_plane = self.radius * np.stack(
            [np.cos(theta), np.sin(theta), np.zeros_like(theta)], axis=-1
        )
        out = in_plane @ self._plane_rot[sat.plane].T
        if np.isscalar(t) or np.ndim(t) == 0:
            out = out[0]
        return out

    def ring_distance(self, slot_a: int, slot_b: int) -> int:
        """ISL hop count between two in-plane slots on the bidirectional ring."""
        K = self.config.sats_per_plane
        d = abs(slot_a - slot_b) % K
        return min(d, K - d)

    def isl_length_m(self) -> float:
        """Chord length between adjacent satellites in the same plane."""
        K = self.config.sats_per_plane
        return 2.0 * self.radius * math.sin(math.pi / K)


@dataclasses.dataclass(frozen=True)
class MultiShellConfig:
    """Several Walker-delta shells flown as one constellation.

    Planes are numbered globally: shell 0 owns planes
    ``[0, shells[0].num_planes)``, shell 1 the next block, and so on.
    Every shell must share ``sats_per_plane`` so the (plane, slot) grid —
    and everything built on it (visibility tables, ring topologies,
    cluster planners) — stays rectangular.

    ``cross_max_range_m`` bounds the slant range of inter-shell links;
    ``cross_links_per_sat`` caps how many cross-shell neighbours each
    satellite may connect to (nearest-first at t=0).
    """

    shells: tuple[ConstellationConfig, ...]
    cross_max_range_m: float = 1500.0e3
    cross_links_per_sat: int = 1

    def __post_init__(self) -> None:
        if not self.shells:
            raise ValueError("MultiShellConfig needs at least one shell")
        ks = {s.sats_per_plane for s in self.shells}
        if len(ks) != 1:
            raise ValueError(
                f"all shells must share sats_per_plane, got {sorted(ks)}"
            )

    @property
    def num_planes(self) -> int:
        return sum(s.num_planes for s in self.shells)

    @property
    def sats_per_plane(self) -> int:
        return self.shells[0].sats_per_plane

    @property
    def num_satellites(self) -> int:
        return self.num_planes * self.sats_per_plane

    @property
    def altitude_m(self) -> float:
        """Reference altitude (first shell); per-shell values differ."""
        return self.shells[0].altitude_m

    @property
    def period_s(self) -> float:
        """Slowest shell's period — conservative for supply cadences."""
        return max(s.period_s for s in self.shells)

    @property
    def plane_offsets(self) -> tuple[int, ...]:
        """Global plane index where each shell's block starts."""
        offs, acc = [], 0
        for s in self.shells:
            offs.append(acc)
            acc += s.num_planes
        return tuple(offs)

    def shell_of_plane(self, plane: int) -> int:
        """Shell index owning a global plane index."""
        if not 0 <= plane < self.num_planes:
            raise ValueError(f"plane {plane} out of range")
        for i, off in enumerate(self.plane_offsets):
            if plane < off + self.shells[i].num_planes:
                return i
        raise AssertionError("unreachable")


class MultiShellWalker:
    """Propagator for a multi-shell constellation.

    Presents the same surface the scheduling stack consumes from
    :class:`WalkerDelta` — ``config``, ``positions_batch``,
    ``position_of``, ``elevations_from``, ``satellites`` — by
    dispatching on the global plane index to per-shell propagators.
    """

    def __init__(self, config: MultiShellConfig):
        self.config = config
        self._walkers = [WalkerDelta(s) for s in config.shells]
        self._offsets = np.asarray(config.plane_offsets, dtype=np.intp)
        # shell index per global plane, for vectorized dispatch
        self._shell_of = np.concatenate(
            [
                np.full(s.num_planes, i, dtype=np.intp)
                for i, s in enumerate(config.shells)
            ]
        )

    @property
    def satellites(self) -> Sequence[Satellite]:
        return [
            Satellite(plane=p, slot=s)
            for p in range(self.config.num_planes)
            for s in range(self.config.sats_per_plane)
        ]

    def positions_batch(
        self,
        planes: np.ndarray,
        slots: np.ndarray,
        t: np.ndarray,
    ) -> np.ndarray:
        """ECI positions for arbitrary global (plane, slot, time) triples."""
        planes = np.asarray(planes, dtype=np.intp)
        slots = np.asarray(slots, dtype=np.intp)
        t = np.asarray(t, dtype=np.float64)
        planes, slots, t = np.broadcast_arrays(planes, slots, t)
        out = np.empty(planes.shape + (3,), dtype=np.float64)
        shell = self._shell_of[planes]
        for i, w in enumerate(self._walkers):
            sel = shell == i
            if not np.any(sel):
                continue
            out[sel] = w.positions_batch(
                planes[sel] - self._offsets[i], slots[sel], t[sel]
            )
        return out

    def position_of(self, sat: Satellite, t: np.ndarray) -> np.ndarray:
        i = int(self._shell_of[sat.plane])
        local = Satellite(
            plane=sat.plane - int(self._offsets[i]), slot=sat.slot
        )
        return self._walkers[i].position_of(local, t)

    def elevations_from(
        self, gs: GroundStation, t: np.ndarray
    ) -> np.ndarray:
        """Elevation (L_total, K, T) stacked along the global plane axis."""
        return np.concatenate(
            [w.elevations_from(gs, t) for w in self._walkers], axis=0
        )


def make_walker(
    config: "ConstellationConfig | MultiShellConfig",
) -> "WalkerDelta | MultiShellWalker":
    """Propagator factory: dispatch on single- vs multi-shell config."""
    if isinstance(config, MultiShellConfig):
        return MultiShellWalker(config)
    return WalkerDelta(config)
