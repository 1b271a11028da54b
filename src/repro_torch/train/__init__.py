"""Training and serving steps for the LLM zoo."""
from repro_torch.train.steps import (
    TrainState,
    lm_loss,
    make_greedy_decode,
    make_init_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.train.fedleo_step import (
    make_fedleo_aggregate,
    make_fedleo_local_step,
)

__all__ = [
    "TrainState",
    "make_init_fn",
    "make_train_step",
    "make_serve_step",
    "lm_loss",
    "make_fedleo_local_step",
    "make_fedleo_aggregate",
    "make_prefill_step",
    "make_greedy_decode",
]
