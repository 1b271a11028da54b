# Copied from src/repro/comms/isl.py; imports rebound to repro_torch.
"""Intra-plane inter-satellite-link (ISL) timing (paper eqs. 20-21).

Each ISL hop h between adjacent satellites is allocated one resource
block of bandwidth B_h, with spectral efficiency beta_h:

  t_h(k, k+1) = z|N| / (B_h beta_h)                                  (20)

and the relay time for a model to reach a sink over h hops is
h * z|N| / (B_h beta_h); the per-orbit relay cost is the max over the
relaying satellites (eq. 21).

Note (paper §IV-A): ISLs are physically FSO (Gbps-Tbps), but the paper
deliberately provisions them at RF-comparable rates so that FedLEO's
gains come from the architecture/schedule, not the PHY — we keep that
choice as the default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Optional, Union

if TYPE_CHECKING:
    from repro_torch.orbits.constellation import ConstellationConfig, MultiShellConfig
    from repro_torch.orbits.topology import ISLTopology, TopologyConfig

# Inter-plane cross-links are optical (FSO): provision them at 1 Gbps
# (250 MHz x 4 bit/s/Hz) instead of the paper's deliberately RF-rate
# intra-plane links — the PHY asymmetry the +Grid topology rides on.
FSO_HOP_BANDWIDTH_HZ = 250.0e6
FSO_SPECTRAL_EFFICIENCY = 4.0


@dataclasses.dataclass(frozen=True)
class ISLConfig:
    hop_bandwidth_hz: float = 125.0e3   # B_h: one RB of B=1 MHz / N=8
    spectral_efficiency: float = 4.0    # beta_h [bit/s/Hz]
    hop_propagation_s: float = 0.0      # chord/c, ~2ms at 1500 km; optional

    @property
    def hop_rate_bps(self) -> float:
        return self.hop_bandwidth_hz * self.spectral_efficiency

    @classmethod
    def from_constellation(
        cls,
        constellation: "ConstellationConfig | MultiShellConfig",
        link_type: str = "intra",
        topology: "Optional[Union[ISLTopology, TopologyConfig]]" = None,
        **overrides: Any,
    ) -> "ISLConfig":
        """ISLConfig with the real chord/c propagation delay for this
        constellation's geometry.

        link_type "intra": adjacent same-plane chord 2*R*sin(pi/K), RF
        provisioning (the paper's Table I rates).  link_type "inter":
        mean cross-plane link length of the (+Grid by default) topology,
        FSO provisioning.  ``overrides`` replace any resulting field.
        """
        from repro_torch.orbits.constellation import C_LIGHT, R_EARTH

        fields: dict = {}
        if link_type == "intra":
            K = constellation.sats_per_plane
            radius = R_EARTH + constellation.altitude_m
            chord_m = 2.0 * radius * math.sin(math.pi / K)
        elif link_type == "inter":
            from repro_torch.orbits.topology import (
                INTER,
                ISLTopology,
                TopologyConfig,
                get_isl_topology,
            )

            topo = (
                topology
                if isinstance(topology, ISLTopology)
                else get_isl_topology(
                    constellation, topology or TopologyConfig(kind="grid")
                )
            )
            chord_m = topo.mean_link_length_m(INTER)
            fields.update(
                hop_bandwidth_hz=FSO_HOP_BANDWIDTH_HZ,
                spectral_efficiency=FSO_SPECTRAL_EFFICIENCY,
            )
        else:
            raise ValueError(f"unknown link_type {link_type!r}")
        fields["hop_propagation_s"] = chord_m / C_LIGHT
        fields.update(overrides)
        return cls(**fields)


def isl_hop_time(cfg: ISLConfig, payload_bits: float) -> float:
    """Eq. (20): single-hop model exchange time between adjacent satellites."""
    return payload_bits / cfg.hop_rate_bps + cfg.hop_propagation_s


def relay_time(cfg: ISLConfig, payload_bits: float, num_hops: int) -> float:
    """Eq. (21) inner term: h-hop store-and-forward relay to the sink."""
    return num_hops * isl_hop_time(cfg, payload_bits)
