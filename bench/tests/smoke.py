"""Small cells for the CPU tests: a cell of BENCHMARK.json with its
configuration cut to a few layers of narrow widths, its traffic to
short sequences and its limits to this size's, run through the same
drivers, reference and check."""
from __future__ import annotations

import copy

from bench import harness

SMALL = {
    "ssm": dict(num_layers=2, d_model=64, vocab_size=96,
                ssm=dict(state_dim=16, head_dim=16, num_groups=1, chunk_size=16,
                         conv_width=4, expand=2)),
}
# Limits at these sizes, set as the cells' are: between the largest
# reading of sound runs (6 seeds, on the CPU) and the smallest of the
# float8 control (6 seeds) or of a fault (3 seeds) that reads above it.
LIMITS = {
    "fedleo_train.mamba2-780m": dict(loss_gap=0.001, grad_gap=0.01, grad_median_gap=0.0012,
                                     change_gap=0.035),
    "prefill.mamba2-780m": dict(served_gap=0.2, logit_err=0.045),
}
TRAFFIC = {
    "fedleo_train": dict(batch=2, seq_len=48),
    "prefill": dict(batch=2, lengths=[16, 24, 40, 48], checked_prompts=8),
}


def small_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.resolve(name))
    cell.config.update(copy.deepcopy(SMALL[cell.config["family"]]))
    cell.config.pop("params", None)
    cell.traffic.update(TRAFFIC[cell.kind])
    cell.limits = {"limits": {k: {"limit": v} for k, v in LIMITS[name].items()}}
    return cell
