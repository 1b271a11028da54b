# Copied from src/repro/obs/_walltime.py; imports rebound to repro_torch.
"""The ONE sanctioned wall-clock read of the observability layer.

Everything in ``repro.obs`` is keyed to the *simulated* clock — the
repo lint bans wall-clock reads across the sim path (``core``,
``comms``, ``orbits``, and ``obs``) because a wall timestamp inside
recorded events would break the traced-equals-untraced bit-identity
contract.  The single legitimate use is *file provenance*: stamping an
exported trace with when it was recorded.  That read lives here, in
the one module the lint exempts, so any other wall-clock use in
``obs/`` is still a finding.
"""
from __future__ import annotations

import time


def recorded_unix_s() -> float:
    """Wall-clock unix seconds, for trace-file provenance only."""
    return time.time()


def run_id() -> str:
    """A collision-resistant id for one recording/benchmark process —
    wall nanoseconds plus nothing else (no randomness: the sim path
    must stay deterministic; two traces written the same nanosecond do
    not happen in practice)."""
    return f"{time.time_ns():x}"
