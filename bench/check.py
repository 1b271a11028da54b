"""The numbers that decide ``correct``, each worked out from what the
program's timed path produced and what the plain reference gives.

Training (the first ``checked_steps`` local steps, which set-up drives
through the window's own call and feed):

  * ``loss_gap``: the largest gap, in nats, between a replica's loss at a
    step and the reference's.
  * ``grad_gap``: the first gradient as Adam took it, read from the
    program's first moment after one step (m = (1 - b1) g): by the worst
    leaf and replica, the gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf.
  * ``grad_median_gap``: the same gaps of the first gradient, by the
    median leaf (the worst replica): one small leaf's rounding (the SSM
    skip ``D``, in bfloat16 products) sets the worst leaf's gap of a
    sound run, and the median leaf tells a lower precision from it.
  * ``change_gap``: the worst leaf's gap of each leaf's change after the
    checked steps.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move under Adam by rounding alone and are left out.

Prefill (a sample of the window's prompts, drawn from the seed, with one
of the longest among them), each prompt's served token being the greedy
one:

  * ``served_gap``: the widest gap by which a served token's reference
    logit lies below the reference's best.
  * ``logit_err``: the largest gap between the program's and the
    reference's last-position logits, over the reference's largest.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

NEGLIGIBLE_GRAD = 1e-3


def _finite(x: float) -> float:
    """x, or infinity where it is not a number: a gap that cannot be
    read fails every limit."""
    return x if math.isfinite(x) else math.inf


def _leaf_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]],
              leaves, pick=max) -> float:
    """Over the replicas, the largest of ``pick`` (max: the worst leaf;
    median: the median leaf) of each leaf's gap of norms, over the larger
    of the reference's norm of that leaf and of the median leaf."""
    worst = 0.0
    for p, r in zip(prog, ref):
        floor = statistics.median(r[k] for k in leaves)
        gaps = [_finite(abs(p[k] - r[k]) / max(r[k], floor, 1e-30)) for k in leaves]
        worst = max(worst, pick(gaps))
    return worst


def moved_leaves(ref_grad: List[Dict[str, float]]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's on every replica."""
    keep = set(ref_grad[0])
    for g in ref_grad:
        floor = statistics.median(g.values())
        keep &= {k for k, v in g.items() if v >= NEGLIGIBLE_GRAD * floor}
    return sorted(keep)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"loss": [step][replica], "grad_norm": [replica]{leaf},
    "change_norm": [replica]{leaf}}."""
    loss_gap = max(_finite(abs(p - r)) for ps, rs in zip(prog["loss"], ref["loss"])
                   for p, r in zip(ps, rs))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = float("inf")
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"], sorted(ref["grad_norm"][0])),
        "grad_median_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"],
                                     sorted(ref["grad_norm"][0]), statistics.median),
        "change_gap": _leaf_gap(prog["change_norm"], ref["change_norm"],
                                moved_leaves(ref["grad_norm"])),
    }


def prefill_numbers(prog_logits: List[torch.Tensor], ref_logits: List[torch.Tensor]
                    ) -> Dict[str, float]:
    """Each list holds one (prompts, vocab) tensor per block of checked
    prompts."""
    served_gap, logit_err = 0.0, 0.0
    for p, r in zip(prog_logits, ref_logits):
        p, r = p.float(), r.float()
        served = torch.argmax(p, dim=-1, keepdim=True)
        gap = r.max(dim=-1).values - torch.gather(r, -1, served)[:, 0]
        served_gap = max(served_gap, _finite(float(gap.max())))
        err = (p - r).abs().amax(dim=-1) / r.abs().amax(dim=-1)
        logit_err = max(logit_err, _finite(float(err.max())))
    return {"served_gap": served_gap, "logit_err": logit_err}
