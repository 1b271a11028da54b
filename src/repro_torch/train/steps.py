"""Serving step builders for the LLM zoo.

The counterpart of the serving half of ``src/repro/train/steps.py``:
``make_init_fn``, ``make_prefill_step``, ``make_serve_step`` and
``make_greedy_decode`` (a Python loop in place of ``lax.scan``).  The
steps run under ``torch.no_grad``.  ``TrainState``, ``lm_loss`` and
``make_train_step`` wait for the training slice.

Batches are dicts: ``{"tokens": (B, S) int}``.  Decode: token (B, 1) +
cache + position.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any


def make_init_fn(model) -> Callable:
    def init(rng: torch.Generator) -> PyTree:
        return model.init(rng)

    return init


def make_prefill_step(model) -> Callable:
    """Inference prefill: full-sequence forward, logits for the last
    position only (never materializes the (B, S, V) tensor)."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        logits, _ = model.forward(params, batch["tokens"], last_only=True)
        return logits[:, -1, :]

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
