"""Small cells for the CPU tests: a cell of BENCHMARK.json with its
configuration cut to a few layers of narrow widths (its family's
``SMALL``), its traffic to short sequences and its limits to this
size's (its family's ``SMALL_LIMITS`` for the traffic kind), run through
the same drivers, reference and check."""
from __future__ import annotations

import copy

from bench import harness

TRAFFIC = {
    "fedleo_train": dict(batch=2, seq_len=48),
    "prefill": dict(batch=2, lengths=[16, 24, 40, 48], checked_prompts=8),
}


def small_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.resolve(name))
    fam = cell.family
    cell.config.update(copy.deepcopy(fam.SMALL))
    cell.config.pop("params", None)
    cell.traffic.update(TRAFFIC[cell.kind])
    cell.limits = {"limits": {k: {"limit": v} for k, v in fam.SMALL_LIMITS[cell.kind].items()}}
    return cell
