"""Plain FedLEO orbit-replica training: the reference that a training
cell's first steps are held to.

R replicas start from the same weights.  Each local step gives every
replica its own batch: the LM loss and its gradient (``model.py``), the
gradient scaled to a global norm of at most ``grad_clip``, and an Adam
step with bias correction.  Every ``tau`` local steps the replicas'
parameters and Adam moments are replaced by their mean weighted by the
replicas' sample counts (the sink's partial aggregate, eq. 9, and the
ground station's global one, eq. 4).  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from bench.reference import model


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    norm = math.sqrt(sum(float(torch.sum(g.double() * g.double())) for g in grads.values()))
    scale = min(1.0, max_norm / norm) if norm > 0 else 1.0
    return {k: g * scale for k, g in grads.items()}


class Replica:
    """One replica's float32 parameters and Adam moments, by leaf path."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = {k: v.clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def adam(self, grads: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
             eps: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            self.params[k] -= lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + eps)


def aggregate(replicas: Sequence[Replica], samples: Sequence[float]) -> None:
    """Every replica's parameters and moments become their weighted mean."""
    w = [s / sum(samples) for s in samples]
    for attr in ("params", "m", "v"):
        for k in getattr(replicas[0], attr):
            mean = sum(wi * getattr(r, attr)[k] for wi, r in zip(w, replicas))
            for r in replicas:
                getattr(r, attr)[k] = mean.clone()


def follow(params: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor], cfg: dict,
           traffic: dict, blocks: model.Blocks, prec=model.exact) -> Dict:
    """The first ``len(batches)`` local steps of R replicas from
    ``params`` (path -> float32 tensor) through the family's ``blocks``;
    batches[t] is (R, b, s) token ids.  Returns each step's loss per
    replica, the first gradient's norm per leaf per replica (after the
    clip, as Adam takes it), the norm of each leaf's change per replica
    after the last step, and the norm of each leaf's first gradient (the
    rule that leaves out leaves moved by rounding alone reads it)."""
    tr = cfg["train"]
    r_count = traffic["replicas"]
    replicas = [Replica(params) for _ in range(r_count)]
    losses: List[List[float]] = []
    grad_norms: List[Dict[str, float]] = []
    for t, batch in enumerate(batches):
        step_losses = []
        for r, rep in enumerate(replicas):
            loss, grads = model.loss_and_grads(model.unflatten(rep.params), batch[r], cfg, blocks,
                                              prec)
            grads = clip_global_norm(grads, traffic["grad_clip"])
            if t == 0:
                grad_norms.append({k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()})
            rep.adam(grads, tr["learning_rate"], tr["adam_b1"], tr["adam_b2"], tr["adam_eps"])
            step_losses.append(float(loss))
            del grads
        losses.append(step_losses)
        if (t + 1) % traffic["tau"] == 0:
            aggregate(replicas, traffic["samples"])
    change = [{k: float(torch.linalg.vector_norm(rep.params[k] - params[k])) for k in params}
              for rep in replicas]
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}
