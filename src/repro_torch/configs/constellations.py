# Copied from src/repro/configs/constellations.py; imports rebound to repro_torch.
"""Constellation + ground-segment presets for scenario scaling.

The paper's experiment uses a 40-satellite Walker delta (5 planes x 8
sats at 1500 km).  The production-scale engine must also cover
mega-constellation shells, so the presets below parameterize the same
``ConstellationConfig`` at Starlink/Kuiper/OneWeb scale (first-shell
public filing parameters; circular-orbit Walker idealization as in
§III's system model).

Ground-segment presets pair the paper's Rolla, MO station with common
high-latitude polar teleport sites so multi-GS (union-of-windows)
scheduling scenarios are one call away.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple, Union

if TYPE_CHECKING:
    from repro_torch.core.engine import SimConfig

from repro_torch.orbits.constellation import (
    ConstellationConfig,
    GroundStation,
    MultiShellConfig,
)
from repro_torch.orbits.topology import TopologyConfig, get_topology

CONSTELLATION_PRESETS: Dict[str, ConstellationConfig] = {
    # the paper's §V-A setup: 40 sats, 5 planes, 1500 km, 80 deg
    "paper-5x8": ConstellationConfig(),
    # mid-size shell for scaling studies
    "walker-12x12": ConstellationConfig(
        num_planes=12, sats_per_plane=12, altitude_m=1200.0e3,
        inclination_deg=70.0, phasing_factor=1,
    ),
    # Starlink shell 2-like: 720 sats in 40 planes at 550 km / 53 deg
    # (the 40x22 scale ISSUE/ROADMAP track for the perf trajectory)
    "starlink-40x22": ConstellationConfig(
        num_planes=40, sats_per_plane=22, altitude_m=550.0e3,
        inclination_deg=53.0, phasing_factor=13,
    ),
    # Starlink gen1 full first shell: 1584 sats in 72 planes at 550 km
    # / 53 deg (the mega-constellation scale target)
    "starlink-gen1": ConstellationConfig(
        num_planes=72, sats_per_plane=22, altitude_m=550.0e3,
        inclination_deg=53.0, phasing_factor=39,
    ),
    # Kuiper first shell-like: 34 planes x 34 sats at 630 km / 51.9 deg
    "kuiper-34x34": ConstellationConfig(
        num_planes=34, sats_per_plane=34, altitude_m=630.0e3,
        inclination_deg=51.9, phasing_factor=11,
    ),
    # OneWeb-like polar shell: 12 planes x 49 sats at 1200 km / 87.9 deg
    "oneweb-12x49": ConstellationConfig(
        num_planes=12, sats_per_plane=49, altitude_m=1200.0e3,
        inclination_deg=87.9, phasing_factor=1,
    ),
}

MULTI_SHELL_PRESETS: Dict[str, MultiShellConfig] = {
    # Starlink gen1 shell + an idealized higher-inclination 570 km shell
    # (Walker idealization of the gen2 "550-ish + 570/70 deg" layering;
    # sats_per_plane kept at 22 so the (plane, slot) grid stays
    # rectangular across shells — 2376 satellites total).
    "starlink-2shell": MultiShellConfig(
        shells=(
            ConstellationConfig(
                num_planes=72, sats_per_plane=22, altitude_m=550.0e3,
                inclination_deg=53.0, phasing_factor=39,
            ),
            ConstellationConfig(
                num_planes=36, sats_per_plane=22, altitude_m=570.0e3,
                inclination_deg=70.0, phasing_factor=5,
            ),
        ),
        cross_max_range_m=1500.0e3,
        cross_links_per_sat=1,
    ),
}

GROUND_STATION_PRESETS: Dict[str, GroundStation] = {
    # the paper's GS (Rolla, MO) — the ConstellationConfig default
    "rolla": GroundStation(),
    # high-latitude teleports: long frequent passes for inclined shells
    "svalbard": GroundStation(
        lat_deg=78.229, lon_deg=15.408, alt_m=450.0,
        min_elevation_deg=10.0, name="Svalbard-NO",
    ),
    "punta-arenas": GroundStation(
        lat_deg=-53.163, lon_deg=-70.917, alt_m=30.0,
        min_elevation_deg=10.0, name="Punta-Arenas-CL",
    ),
    "awarua": GroundStation(
        lat_deg=-46.529, lon_deg=168.381, alt_m=10.0,
        min_elevation_deg=10.0, name="Awarua-NZ",
    ),
    # the ideal-setup pole station used by FedISL/FedSat baselines
    "north-pole": GroundStation(
        lat_deg=89.5, lon_deg=0.0, alt_m=0.0,
        min_elevation_deg=5.0, name="North-Pole",
    ),
}


def get_constellation(
    name: str,
) -> "ConstellationConfig | MultiShellConfig":
    if name in MULTI_SHELL_PRESETS:
        return MULTI_SHELL_PRESETS[name]
    if name not in CONSTELLATION_PRESETS:
        raise ValueError(
            f"unknown constellation {name!r}; have "
            f"{sorted(CONSTELLATION_PRESETS) + sorted(MULTI_SHELL_PRESETS)}"
        )
    return CONSTELLATION_PRESETS[name]


def get_ground_stations(
    names: Sequence[str],
) -> Tuple[GroundStation, ...]:
    out = []
    for n in names:
        if n not in GROUND_STATION_PRESETS:
            raise ValueError(
                f"unknown ground station {n!r}; have "
                f"{sorted(GROUND_STATION_PRESETS)}"
            )
        out.append(GROUND_STATION_PRESETS[n])
    return tuple(out)


# Default ISL topology per constellation shell: mega-constellation
# shells fly optical inter-plane cross-links (+Grid); the paper's small
# setup and the polar OneWeb-like shell keep the intra-plane ring (the
# OneWeb-like shell's near-polar seam makes sustained cross-links at
# the seam infeasible — use "grid-seam-cut" explicitly to model it).
CONSTELLATION_TOPOLOGY: Dict[str, str] = {
    "paper-5x8": "ring",
    "walker-12x12": "grid",
    "starlink-40x22": "grid",
    "starlink-gen1": "grid",
    "kuiper-34x34": "grid",
    "oneweb-12x49": "ring",
    "starlink-2shell": "grid",
}


def make_sim_config(
    constellation: str = "paper-5x8",
    ground_stations: Sequence[str] = ("rolla",),
    topology: Optional[Union[str, TopologyConfig]] = None,
    rb_contention: bool = False,
    handover: bool = False,
    **overrides: object,
) -> "SimConfig":
    """SimConfig from presets: FedLEO and every baseline in
    ``core/baselines.py`` run on any constellation/ground-segment pair.

    ``topology`` opts into the ISL graph layer: a preset name ("ring",
    "grid", "grid-seam-cut", ...), a TopologyConfig, or "auto" for the
    shell's default (``CONSTELLATION_TOPOLOGY``).  When a topology is
    requested, intra- and inter-plane ISL configs are derived from the
    constellation geometry (``ISLConfig.from_constellation``: real
    chord/c propagation delays; FSO rates on inter-plane links).
    Omitting it keeps the legacy paper provisioning untouched.

    ``rb_contention=True`` opts into honest per-station downlink
    resource-block accounting: ``SimConfig.gs_rb_capacity`` is set to
    the link's RB count (eq. 13's N, Table I default 8) so concurrent
    sink uploads on one station compete for its RB pool via the shared
    ``GSResourceLedger``.  The default keeps the contention-free
    degenerate case (``gs_rb_capacity=None`` — bit-identical to the
    pre-ledger scheduler).  Pass ``gs_rb_capacity=...`` directly for a
    non-default cap, or ``rolling_horizon_hours=...`` to grow the
    visibility table incrementally instead of prebuilding 1.5x the
    horizon.

    ``handover=True`` opts into mid-window station handover
    (``SimConfig.gs_handover``): sink uploads may split into segments
    across different stations' overlapping windows instead of pinning
    the whole transfer to one station — meaningful with a multi-GS
    ground segment; with a single station it is bit-identical to the
    unsegmented scheduler.

    Extra keyword arguments override SimConfig fields (horizon_hours,
    coarse_step_s, gs_rb_capacity, rolling_horizon_hours,
    gs_handover, ...).
    """
    from repro_torch.core.engine import SimConfig

    cfg = get_constellation(constellation)
    gss = get_ground_stations(ground_stations)
    kwargs = dict(
        constellation=cfg,
        ground_station=gss[0],
        ground_stations=gss if len(gss) > 1 else (),
    )
    if topology is not None:
        from repro_torch.comms.isl import ISLConfig

        if topology == "auto":
            topology = CONSTELLATION_TOPOLOGY[constellation]
        topo_cfg = get_topology(topology)
        kwargs["topology"] = topo_cfg
        kwargs["isl"] = ISLConfig.from_constellation(cfg, "intra")
        if topo_cfg.has_inter_links:
            kwargs["isl_inter"] = ISLConfig.from_constellation(
                cfg, "inter", topology=topo_cfg
            )
    kwargs.update(overrides)     # explicit overrides win over presets
    if rb_contention and kwargs.get("gs_rb_capacity") is None:
        from repro_torch.comms.link import LinkConfig

        link = kwargs.get("link") or LinkConfig()
        kwargs["gs_rb_capacity"] = link.num_resource_blocks
    if handover:
        kwargs.setdefault("gs_handover", True)
    return SimConfig(**kwargs)
