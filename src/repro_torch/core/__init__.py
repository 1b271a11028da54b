"""FedLEO core: model propagation, sink scheduling, aggregation, engines."""
from repro_torch.core.aggregation import (
    global_aggregate,
    noniid_weights,
    partial_aggregate,
    weighted_average,
)
from repro_torch.core.engine import FLStrategy, RunResult, SimConfig
from repro_torch.core.fedleo import (
    FedLEO,
    FedLEOGrid,
    form_clusters,
    make_clusters,
    plan_cluster_round,
    plan_plane_round,
)
from repro_torch.core.fltask import FederatedTask, TrainHyperparams
from repro_torch.core.propagation import (
    broadcast_schedule,
    graph_broadcast_schedule,
    graph_relay_schedule,
    relay_schedule,
)
from repro_torch.core.scheduling import (
    HandoverSpec,
    SegmentedPlan,
    TransferSegment,
    plan_segmented_transfer,
    reserve_decision,
    select_sink,
    select_sink_cluster,
)

__all__ = [
    "FedLEOGrid",
    "HandoverSpec",
    "SegmentedPlan",
    "TransferSegment",
    "form_clusters",
    "make_clusters",
    "plan_segmented_transfer",
    "reserve_decision",
    "plan_cluster_round",
    "plan_plane_round",
    "graph_broadcast_schedule",
    "graph_relay_schedule",
    "select_sink_cluster",
    "global_aggregate",
    "noniid_weights",
    "partial_aggregate",
    "weighted_average",
    "FLStrategy",
    "RunResult",
    "SimConfig",
    "FedLEO",
    "FederatedTask",
    "TrainHyperparams",
    "broadcast_schedule",
    "relay_schedule",
    "select_sink",
]
