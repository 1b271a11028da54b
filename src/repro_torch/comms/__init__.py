"""Link-budget and latency models (FedLEO §III-B, §IV-B)."""
from repro_torch.comms.link import (
    LinkConfig,
    free_space_path_loss,
    snr_linear,
    snr_db,
    shannon_rate,
    transmission_time,
    propagation_time,
    model_exchange_time,
    uplink_time,
    downlink_time,
)
from repro_torch.comms.isl import ISLConfig, isl_hop_time, relay_time
from repro_torch.comms.ledger import GSResourceLedger
from repro_torch.comms.routing import ISLPlan, RoutingTable
from repro_torch.comms.environment import (
    CommsEnvironment,
    PendingUpload,
    Reservation,
    TransferDecision,
)

__all__ = [
    "CommsEnvironment",
    "PendingUpload",
    "Reservation",
    "TransferDecision",
    "GSResourceLedger",
    "ISLPlan",
    "RoutingTable",
    "LinkConfig",
    "free_space_path_loss",
    "snr_linear",
    "snr_db",
    "shannon_rate",
    "transmission_time",
    "propagation_time",
    "model_exchange_time",
    "uplink_time",
    "downlink_time",
    "ISLConfig",
    "isl_hop_time",
    "relay_time",
]
