"""Faults planted in the program's timed path, to show that the check
catches them: each patches a function of the program that the drivers
look up when they run, for the duration of a ``with planted(name)``
block.  ``FAULTS`` lists the faults each traffic kind can have; the
exchange between chips has no place in a one-chip cell, and the
aggregation between replicas stands in for it in training."""
from __future__ import annotations

import contextlib

import torch

FAULTS = {
    "fedleo_train": ("state_unchanged", "half_batch", "no_aggregation", "label_shift"),
    "prefill": ("half_batch", "answer_altered"),
}


def _unshifted_loss(logits, tokens, num_prefix=0):
    """The LM loss against the tokens at the same positions, not the next."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = tokens.to(device=logits.device, dtype=torch.long)
    return -torch.mean(torch.gather(logp, -1, tgt[..., None])[..., 0])


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.train import fedleo_step, steps

    saved = (fedleo_step.make_fedleo_local_step, fedleo_step.make_fedleo_aggregate,
             steps.make_prefill_step, steps.lm_loss)
    make_local, make_agg, make_prefill, _ = saved

    def local_wrapper(alter):
        def make(*args, **kwargs):
            real = make_local(*args, **kwargs)
            return lambda state, batch: alter(real, state, batch)
        return make

    def prefill_wrapper(alter):
        def make(*args, **kwargs):
            real = make_prefill(*args, **kwargs)
            return lambda params, batch: alter(real, params, batch)
        return make

    if name == "state_unchanged":          # a step that returns its state unchanged
        fedleo_step.make_fedleo_local_step = local_wrapper(
            lambda real, state, batch: (state, real(state, batch)[1]))
    elif name == "half_batch":             # half of each batch left out, the mean over the rest
        fedleo_step.make_fedleo_local_step = local_wrapper(
            lambda real, state, batch: real(state, {k: v[:, :, : v.shape[2] // 2]
                                                    for k, v in batch.items()}))

        def half_prefill(real, params, batch):
            t = batch["tokens"]
            out = real(params, {"tokens": t[: t.shape[0] // 2]})
            return torch.cat([out, out])[: t.shape[0]]

        steps.make_prefill_step = prefill_wrapper(half_prefill)
    elif name == "no_aggregation":         # the replicas' exchange left out
        fedleo_step.make_fedleo_aggregate = lambda *a, **k: (lambda state, w, *r, **kw: state)
    elif name == "label_shift":            # every training label altered where it is made
        steps.lm_loss = _unshifted_loss
    elif name == "answer_altered":         # one prompt's answer altered where it is made
        def altered(real, params, batch):
            out = real(params, batch).clone()
            out[0] = torch.roll(out[0], 1)
            return out

        steps.make_prefill_step = prefill_wrapper(altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        (fedleo_step.make_fedleo_local_step, fedleo_step.make_fedleo_aggregate,
         steps.make_prefill_step, steps.lm_loss) = saved
