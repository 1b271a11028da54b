# Copied from src/repro/compute/__init__.py; imports rebound to repro_torch.
"""Heterogeneous fleet compute: device tiers + roofline step times.

Turns the scheduler into the control plane of a real jax_pallas
training system: each plane (or satellite) carries a device tier
(``DeviceProfile``) and a model architecture from the
``configs/registry`` zoo; ``FleetComputeModel`` resolves per-satellite
train times (roofline over FLOPs/bytes, ``compute.roofline``) and
payload sizes (real param counts) that ``FederatedTask`` and every
engine consult behind ``SimConfig.compute``.  The uniform profile
(every assignment ``arch=None``) is the bit-identical degenerate case
of the paper's eq. (11) constant — equivalence-tested.
"""
from repro_torch.compute.fleet import FleetComputeModel
from repro_torch.compute.profiles import (
    DEVICE_TIERS,
    DeviceProfile,
    SatAssignment,
    SatelliteComputeProfile,
)
from repro_torch.compute.roofline import (
    StepCost,
    arch_payload_bits,
    seconds_per_sample,
    step_cost,
    step_time_s,
)

__all__ = [
    "DEVICE_TIERS",
    "DeviceProfile",
    "FleetComputeModel",
    "SatAssignment",
    "SatelliteComputeProfile",
    "StepCost",
    "arch_payload_bits",
    "seconds_per_sample",
    "step_cost",
    "step_time_s",
]
