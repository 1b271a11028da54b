"""Measured calibration for the fleet compute model.

The counterpart of ``src/repro/launch/calibrate.py``: the one place the
compute stack touches the wall clock, timing a real float32 train step
of an arch's SMOKE config.  It lives in ``launch/`` (not ``compute/``)
because the simulation packages read no clock; ``compute.roofline``
calls in here lazily for its "measured" mode and caches the result.

The step runs on the card unless the caller names the CPU: without a
card and without ``device="cpu"`` it raises, and nothing is timed on
the CPU quietly.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.registry import build_model, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.optim import get_optimizer
from repro_torch.train.steps import TrainState, make_train_step


def _smoke_batch(cfg, seq_len: int, global_batch: int, device: torch.device) -> Dict:
    """A synthetic batch matching ``train/steps`` layouts."""
    tokens = torch.zeros((global_batch, seq_len), dtype=torch.int32, device=device)
    batch: Dict = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["extra"] = torch.zeros(
            (global_batch, cfg.vision.num_patches, cfg.d_model),
            dtype=torch.bfloat16, device=device,
        )
    if cfg.family == "audio":
        batch["source"] = torch.zeros(
            (global_batch, cfg.encoder.max_source_len, cfg.d_model),
            dtype=torch.bfloat16, device=device,
        )
    return batch


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_smoke_step_s(
    arch_id: str,
    *,
    seq_len: int = 128,
    global_batch: int = 4,
    iters: int = 3,
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Wall seconds of one smoke-config float32 train step on ``device``
    (None: the card).

    Runs once to warm up (excluded), then takes the minimum over
    ``iters`` runs, each ended by a device synchronise — the minimum is
    the standard noise-robust estimator for a deterministic step."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch_id)
    model = build_model(cfg, dtype=torch.float32, device=dev)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    step = make_train_step(model, opt)
    params = model.init(torch.Generator().manual_seed(0))
    state = TrainState(
        params=params, opt_state=opt.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )
    batch = _smoke_batch(cfg, seq_len, global_batch, dev)
    state, _ = step(state, batch)                   # warm up
    _synchronize(dev)
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        _synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best
