"""repro_torch.obs: the observability layer of the scheduling stack.

Typed, sim-timestamped scheduling traces (``TraceRecorder``), the
per-round phase decomposition (``RoundDecomposition``), RB
utilization timelines, JSONL + Perfetto exporters
(``repro_torch.obs.export``) and the CLI reporter
(``python -m repro_torch.obs.report``); copies of the reference's
``repro.obs`` modules.

Enable per run with ``SimConfig(trace=True)``; tracing is
zero-interference — a traced run is bit-identical to an untraced one.
"""
from repro_torch.obs.decomposition import (
    GroupDecomposition,
    RoundDecomposition,
    decompose_group_plan,
    mean_phase_seconds,
    round_decomposition,
)
from repro_torch.obs.trace import (
    NULL_RECORDER,
    TRACE_SCHEMA_VERSION,
    TraceEvent,
    TraceRecorder,
    format_round_line,
    round_log_record,
)
from repro_torch.obs.utilization import ledger_rb_utilization

__all__ = [
    "GroupDecomposition",
    "RoundDecomposition",
    "decompose_group_plan",
    "mean_phase_seconds",
    "round_decomposition",
    "NULL_RECORDER",
    "TRACE_SCHEMA_VERSION",
    "TraceEvent",
    "TraceRecorder",
    "format_round_line",
    "round_log_record",
    "ledger_rb_utilization",
]
