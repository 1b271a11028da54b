"""Correctness tooling over the scheduling stack.

``repro_torch.analysis.sanitizer`` holds the runtime
``ScheduleSanitizer``: it validates every committed
``TransferDecision``/``Reservation`` against the eq. 13-16 RB-capacity
and eq. 15 window-containment invariants while a simulation runs
(``SimConfig.sanitize``).  ``repro_torch.analysis.lint`` is the static
AST lint over the port's own tree (``python -m repro_torch.analysis.lint``).
"""
from repro_torch.analysis.sanitizer import (
    ScheduleSanitizer,
    ScheduleViolation,
    Violation,
)

__all__ = ["ScheduleSanitizer", "ScheduleViolation", "Violation"]
