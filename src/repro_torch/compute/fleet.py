# Copied from src/repro/compute/fleet.py; imports rebound to repro_torch.
"""FleetComputeModel: the per-satellite compute oracle the engines use.

Resolves a ``SatelliteComputeProfile`` against a constellation into the
two queries the FL engines need:

  seconds_per_sample(plane, slot)  roofline per-sample training cost,
                                   or None — "keep the paper's uniform
                                   c_k / f_k" (the degenerate tier)
  payload_bits(plane, slot)        the arch's real param-count payload,
                                   or None — "keep the task's payload"

``train_time_s`` composes the former with eq. (11)'s structure
(I x n_k x b_k x per-sample cost) so heterogeneous fleets and the
paper's uniform timing share one wall-clock formula.  All satellites of
the degenerate tier (``arch=None``) answer None to both queries, which
is how an all-default profile stays bit-identical to an unset
``SimConfig.compute``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.compute import roofline
from repro_torch.compute.profiles import (
    DEVICE_TIERS,
    SatAssignment,
    SatelliteComputeProfile,
)


class FleetComputeModel:
    """A profile resolved against one constellation's plane count."""

    def __init__(
        self, profile: SatelliteComputeProfile, num_planes: int
    ) -> None:
        self.profile = profile
        self.num_planes = int(num_planes)

    def assignment(self, plane: int, slot: int = 0) -> SatAssignment:
        return self.profile.assignment(plane, slot)

    @property
    def payload_aware(self) -> bool:
        """Whether any satellite's payload may differ from the task's."""
        return self.profile.payload_from_arch

    def seconds_per_sample(
        self, plane: int, slot: int = 0
    ) -> Optional[float]:
        """Per-sample training cost of satellite (plane, slot), or None
        for the degenerate (paper c_k / f_k) tier."""
        a = self.assignment(plane, slot)
        if a.arch is None:
            return None
        p = self.profile
        return roofline.seconds_per_sample(
            a.arch, p.shape, DEVICE_TIERS[a.device],
            mode=p.mode, smoke=p.smoke,
        )

    def train_time_s(
        self,
        plane: int,
        slot: int = 0,
        *,
        local_epochs: int,
        n_batches: int,
        batch_size: int,
    ) -> Optional[float]:
        """Eq. (11) with the roofline per-sample cost:
        I x n_k x b_k x seconds_per_sample.  The caller passes the
        batches/batch-size actually executed (``FederatedTask``'s
        executed-work accounting).  None = degenerate tier."""
        sps = self.seconds_per_sample(plane, slot)
        if sps is None:
            return None
        return float(local_epochs) * n_batches * batch_size * sps

    def payload_bits(self, plane: int, slot: int = 0) -> Optional[float]:
        """The arch-derived payload z|N| of satellite (plane, slot), or
        None — keep the task's uniform payload (always None unless the
        profile opts in via ``payload_from_arch``)."""
        p = self.profile
        if not p.payload_from_arch:
            return None
        a = self.assignment(plane, slot)
        if a.arch is None:
            return None
        return roofline.arch_payload_bits(
            a.arch, bits_per_param=p.bits_per_param, smoke=p.smoke
        )

    def plane_summary(self) -> List[Dict[str, object]]:
        """Per-plane assignment + resolved per-sample cost (benchmark
        display; slot-0 assignment stands in for the plane)."""
        rows: List[Dict[str, object]] = []
        for plane in range(self.num_planes):
            a = self.assignment(plane)
            rows.append({
                "plane": plane,
                "arch": a.arch,
                "device": a.device,
                "seconds_per_sample": self.seconds_per_sample(plane),
            })
        return rows
