"""Correctness tooling over the scheduling stack.

``repro_torch.analysis.sanitizer`` holds the runtime
``ScheduleSanitizer``: it validates every committed
``TransferDecision``/``Reservation`` against the eq. 13-16 RB-capacity
and eq. 15 window-containment invariants while a simulation runs
(``SimConfig.sanitize``).  The reference's static AST lint is not
ported yet.
"""
from repro_torch.analysis.sanitizer import (
    ScheduleSanitizer,
    ScheduleViolation,
    Violation,
)

__all__ = ["ScheduleSanitizer", "ScheduleViolation", "Violation"]
