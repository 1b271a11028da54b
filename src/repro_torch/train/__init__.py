"""Serving steps for the LLM zoo (training steps are not ported yet)."""
from repro_torch.train.steps import (
    make_greedy_decode,
    make_init_fn,
    make_prefill_step,
    make_serve_step,
)

__all__ = [
    "make_init_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_greedy_decode",
]
