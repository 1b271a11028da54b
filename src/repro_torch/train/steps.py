"""train_step / serve_step builders for the LLM zoo.

The counterpart of ``src/repro/train/steps.py``:

  * ``TrainState``, ``lm_loss`` and ``make_train_step(model, optimizer)``,
    which returns ``(state, batch) -> (state, metrics)``: gradients by
    ``torch.autograd.grad`` over the flattened parameter leaves, then
    ``clip_by_global_norm``, ``optimizer.update`` and ``apply_updates``,
    all out of place.
  * ``make_init_fn``, ``make_prefill_step``, ``make_serve_step`` and
    ``make_greedy_decode`` (a Python loop in place of ``lax.scan``),
    which run under ``torch.no_grad``.

Batches are dicts:
  LM:      {"tokens": (B, S) int, "extra": optional (B, P, D) modality embeds (vlm)}
  enc-dec: {"tokens": (B, S) int, "source": (B, S_enc, D)}
Decode: token (B, 1) + cache + position.  MoE's load-balance loss is
added to the LM loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.optimizers import apply_updates
from repro_torch.profiling import span
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt_state: PyTree
    step: torch.Tensor


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            num_prefix: int = 0) -> torch.Tensor:
    """Next-token cross-entropy.  logits may include ``num_prefix``
    non-text (vision/audio) positions prepended; they are excluded."""
    if num_prefix:
        logits = logits[:, num_prefix:]
    pred = logits[:, :-1]
    tgt = tokens[:, 1:].to(device=logits.device, dtype=torch.long)
    logp = torch.log_softmax(pred.float(), dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    return -torch.mean(ll)


def make_init_fn(model) -> Callable:
    def init(rng: torch.Generator) -> PyTree:
        return model.init(rng)

    return init


def _forward(model, params, batch: Dict, last_only: bool = False):
    """(logits, aux, number of non-text positions prepended) of ``model``
    on ``batch``, by family."""
    family = model.cfg.family
    if family == "audio":
        logits, aux = model.forward(params, batch["tokens"], batch["source"],
                                    last_only=last_only)
        return logits, aux, 0
    if family == "vlm":
        logits, aux = model.forward(params, batch["tokens"], extra_embeds=batch["extra"],
                                    last_only=last_only)
        return logits, aux, batch["extra"].shape[1]
    logits, aux = model.forward(params, batch["tokens"], last_only=last_only)
    return logits, aux, 0


def _loss_fn(model) -> Callable:
    """(params, batch) -> (total loss, LM loss) of ``model``."""

    def loss_fn(params, batch):
        logits, aux, num_prefix = _forward(model, params, batch)
        loss = lm_loss(logits, batch["tokens"], num_prefix)
        return loss + aux, loss

    return loss_fn


def _value_and_grad(loss_fn: Callable, params: PyTree, batch: Dict):
    """((total, aux), grads) of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them: gradients
    of the first output by ``torch.autograd.grad`` over the flattened
    parameter leaves, zero for a leaf the loss does not reach."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with span("train_step.forward"):
            total, aux = loss_fn(tree_unflatten(treedef, xs), batch)
        with span("train_step.backward", adopt=True):
            gs = torch.autograd.grad(total, xs, allow_unused=True)
    grads = tree_unflatten(treedef, [torch.zeros_like(x) if g is None else g
                                     for g, x in zip(gs, xs)])
    return (total.detach(), aux.detach()), grads


def make_train_step(
    model,
    optimizer: Optimizer,
    grad_clip: Optional[float] = 1.0,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """One optimizer step on one model's state: (state, batch) ->
    (new state, {"loss", "total_loss"}).  The input state is left as it
    is; every leaf of the new one is a new tensor."""
    loss_fn = _loss_fn(model)

    def train_step(state: TrainState, batch: Dict):
        (total, ce), grads = _value_and_grad(loss_fn, state.params, batch)
        with torch.no_grad(), span("train_step.optimizer"):
            if grad_clip is not None:
                grads = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            del grads
            params = apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, {"loss": ce, "total_loss": total}

    return train_step


def make_prefill_step(model) -> Callable:
    """Inference prefill: full-sequence forward, logits for the last
    position only (never materializes the (B, S, V) tensor)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with span("serve.prefill"):
            return _forward(model, params, batch, last_only=True)[0][:, -1, :]

    return prefill_step


def make_serve_step(model) -> Callable:
    """Single-token decode: (params, token, cache, position) ->
    (next_token_logits, new_cache).  The cache's buffers are written in
    place; use the returned cache."""

    @torch.no_grad()
    def serve_step(params, token, cache, position):
        logits, new_cache = model.decode_step(params, token, cache, position)
        return logits[:, -1, :], new_cache

    return serve_step


def make_greedy_decode(model, num_steps: int) -> Callable:
    """Greedy autoregressive loop over serve_step: (params, first_token
    (B, 1), cache, start_pos) -> (tokens (B, num_steps), cache)."""
    serve_step = make_serve_step(model)

    def decode(params, first_token, cache, start_pos):
        token, pos, toks = first_token, int(start_pos), []
        for _ in range(num_steps):
            logits, cache = serve_step(params, token, cache, pos)
            token = torch.argmax(logits, dim=-1, keepdim=True).to(first_token.dtype)
            toks.append(token[:, 0])
            pos += 1
        return torch.stack(toks, dim=1), cache

    return decode
