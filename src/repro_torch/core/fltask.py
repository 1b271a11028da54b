"""FederatedTask: the learning substrate plugged into the FL engines.

The counterpart of ``src/repro/core/fltask.py``.  Wraps a model
(init/apply over dict pytrees), an optimizer and client datasets:

  * ``local_train(params, client_ids, rng)``: I-epoch mini-batch SGD on
    every listed client *in parallel* — parameters stacked over a
    leading client axis, per-client gradients from
    ``torch.func.vmap(torch.func.grad(loss))`` — the "multiple
    concurrent training processes" of §IV-A.
  * ``evaluate(params)``: global-model metrics on a held-out test set.
  * ``train_time_s(client)``: eq. (11) wall-clock model
    t_train = I * n_k * b_k * c_k / f_k  (simulated clock, Table I).
  * ``payload_bits``: z|N| for the comm model.

Tensors live on ``device`` — CUDA unless the caller names another one.
Randomness comes from explicit ``torch.Generator``s on the CPU, so a
seed draws the same weights and sample orders on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.compute.fleet import FleetComputeModel
from repro_torch.data.partition import ClientData, stack_client_arrays
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import apply_updates
from repro_torch.tree import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainHyperparams:
    """Paper Table I (lower part) defaults."""

    local_epochs: int = 100          # I
    learning_rate: float = 0.001     # eta
    batch_size: int = 32             # b_k
    cycles_per_sample: float = 1.0e3  # c_k
    cpu_freq_hz: float = 1.0e9       # f_k
    bits_per_param: int = 32         # z


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; supports (B, C) or (B, H, W, C) logits."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long().unsqueeze(-1))
    return -torch.mean(picked)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


class FederatedTask:
    def __init__(
        self,
        *,
        init_fn: Callable[..., PyTree],
        apply_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
        clients: Sequence[ClientData],
        test_set: Dataset,
        optimizer: Optimizer,
        hp: TrainHyperparams = TrainHyperparams(),
        loss_fn: Callable = cross_entropy_loss,
        rng: Optional[torch.Generator] = None,
        sim_epochs: Optional[int] = None,
        payload_bits_override: Optional[int] = None,
        compute: Optional[FleetComputeModel] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """Args:
          init_fn: rng -> params; called with ``rng`` (default: a CPU
            generator seeded 0) and moved to ``device``.
          sim_epochs: epochs actually executed (defaults to
            hp.local_epochs). The *simulated clock* always charges
            hp.local_epochs via eq. (11).
          payload_bits_override: charge the comm model for this payload
            size z|N| instead of the model's true size.
          compute: heterogeneous fleet compute model (repro_torch.compute)
            — ``train_time_s`` consults it per client before falling back
            to the uniform eq. (11) c_k/f_k constant.  None (default)
            keeps the paper's uniform fleet; ``FLStrategy`` also
            resolves one from ``SimConfig.compute`` without mutating
            the task, so one task can be shared across arms.
          device: where parameters and data live; None means "cuda",
            which raises when no card is present.
        """
        if optimizer.name == "adafactor":
            # local_train updates every client's stacked leaves in one
            # call, which only an elementwise optimizer gets right
            raise ValueError(
                "FederatedTask trains clients stacked on one axis and needs an "
                "elementwise optimizer; adafactor reduces over whole leaves"
            )
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.clients = list(clients)
        self.test_set = test_set
        self.optimizer = optimizer
        self.hp = hp
        self.loss_fn = loss_fn
        self.compute = compute
        self.sim_epochs = sim_epochs if sim_epochs is not None else hp.local_epochs
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        self.global_params = tree_map(
            lambda p: p.to(self.device), init_fn(rng)
        )
        # `is None`, not `or`: an explicit 0-bit override must not fall
        # back to the model's true size
        self._payload_bits = (
            payload_bits_override
            if payload_bits_override is not None
            else nn.param_bits(self.global_params, hp.bits_per_param)
        )

        # stacked per-client data (padded to the largest client)
        x_stack, y_stack, self._counts = stack_client_arrays(self.clients)
        self._x_stack = torch.from_numpy(x_stack).to(self.device)
        self._y_stack = torch.from_numpy(y_stack).long().to(self.device)
        self._test_x = torch.from_numpy(np.asarray(test_set.x)).to(self.device)
        self._test_y = torch.from_numpy(np.asarray(test_set.y)).long().to(self.device)

        def loss(p: PyTree, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
            return self.loss_fn(self.apply_fn(p, xb), yb)

        self._client_grads = torch.func.vmap(torch.func.grad(loss))

    # --- payload & timing ------------------------------------------------------
    @property
    def payload_bits(self) -> int:
        return self._payload_bits

    def num_samples(self, client_id: int) -> int:      # m_k
        return int(self._counts[client_id])

    def executed_batches(self, client_id: int) -> Tuple[int, int]:
        """(n_batches, batch_size) as ``local_train`` executes them: tiny
        clients (m < b_k) fall back to full-batch steps, so the
        simulated clock must charge the samples actually processed —
        not b_k.  For m >= b_k this is exactly eq. (11)'s (m // b_k, b_k)."""
        m = self.num_samples(client_id)
        bsz = min(self.hp.batch_size, max(1, m))
        return max(1, m // bsz), bsz

    def train_time_s(self, client_id: int) -> float:
        """Eq. (11): t_train(k) = I * n_k * b_k * c_k / f_k, charged
        for the batches actually executed.  With a fleet compute model
        attached, c_k / f_k is replaced by the client satellite's
        roofline per-sample cost (degenerate tiers fall through to the
        uniform constant)."""
        hp = self.hp
        n_batches, bsz = self.executed_batches(client_id)
        if self.compute is not None:
            c = self.clients[client_id]
            t = self.compute.train_time_s(
                c.plane, c.slot, local_epochs=hp.local_epochs,
                n_batches=n_batches, batch_size=bsz,
            )
            if t is not None:
                return t
        return (
            hp.local_epochs * n_batches * bsz * hp.cycles_per_sample
        ) / hp.cpu_freq_hz

    # --- local training ---------------------------------------------------------
    def local_train(
        self, params: PyTree, client_ids: Sequence[int], rng: torch.Generator
    ) -> PyTree:
        """Train the given global params on each listed client in parallel:
        ``sim_epochs`` epochs of mini-batch steps over each client's
        (padded) data in a fresh random order per client and epoch.

        Returns stacked params with leading axis len(client_ids).
        """
        hp = self.hp
        ids = torch.as_tensor(list(client_ids), dtype=torch.long, device=self.device)
        c = len(client_ids)
        x, y = self._x_stack[ids], self._y_stack[ids]        # (C, m, ...)
        m = x.shape[1]
        bsz = min(hp.batch_size, m)   # tiny clients: full-batch steps
        n_batches = max(1, m // bsz)
        # one permutation per (client, epoch), drawn on the host generator
        perms = torch.argsort(
            torch.rand((c, self.sim_epochs, m), generator=rng), dim=-1
        ).to(self.device)
        rows = torch.arange(c, device=self.device)[:, None]

        stacked = tree_map(
            lambda p: p.unsqueeze(0).expand((c,) + tuple(p.shape)).clone(), params
        )
        opt_state = self.optimizer.init(stacked)
        for e in range(self.sim_epochs):
            for i in range(n_batches):
                idx = perms[:, e, i * bsz:(i + 1) * bsz]          # (C, bsz)
                g = self._client_grads(stacked, x[rows, idx], y[rows, idx])
                updates, opt_state = self.optimizer.update(g, opt_state, stacked)
                stacked = apply_updates(stacked, updates)
        return stacked

    # --- evaluation ---------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, params: PyTree, max_samples: int = 1024) -> Dict[str, float]:
        x = self._test_x[:max_samples]
        y = self._test_y[:max_samples]
        logits = self.apply_fn(params, x)
        return {
            "loss": float(self.loss_fn(logits, y)),
            "accuracy": float(accuracy(logits, y)),
        }

    # --- client lookup ---------------------------------------------------------------
    def clients_on_plane(self, plane: int) -> List[int]:
        return [i for i, c in enumerate(self.clients) if c.plane == plane]

    def client_histograms(self) -> np.ndarray:
        return np.stack([c.histogram for c in self.clients])
