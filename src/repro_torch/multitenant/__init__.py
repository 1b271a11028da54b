# Copied from src/repro/multitenant/__init__.py; imports rebound to repro_torch.
"""Multi-tenant FL over one constellation: N concurrent jobs, one
shared per-station RB ledger (eqs. 13-16), admission control, priority
tiers and weighted max-min fairness over RB-seconds.

See ``repro.multitenant.scheduler`` for the full model.
"""
from repro_torch.multitenant.scheduler import (
    FINISHED,
    QUEUED,
    REJECTED,
    RID_STRIDE,
    RUNNING,
    STALLED,
    JobRecord,
    JobScheduler,
    JobSpec,
    RoundRunner,
    projected_demand_rb_s,
    registry_payload_bits,
)

__all__ = [
    "FINISHED",
    "QUEUED",
    "REJECTED",
    "RID_STRIDE",
    "RUNNING",
    "STALLED",
    "JobRecord",
    "JobScheduler",
    "JobSpec",
    "RoundRunner",
    "projected_demand_rb_s",
    "registry_payload_bits",
]
