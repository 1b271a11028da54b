"""Training driver: --arch <id> end-to-end LM training on synthetic
token data, with checkpointing and optional FedLEO hierarchical mode.

The counterpart of ``src/repro/launch/train.py``, with the same flags
and one more, ``--device`` (default: CUDA, which raises without a
card).  Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke \\
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --smoke \\
      --fedleo --orbits 2 --tau 2 --steps 4 --device cpu

Checkpoints hold one model's ``TrainState`` and restore into either
mode.  In FedLEO mode a checkpoint is written after an aggregation that
ends a multiple of ``--ckpt-every`` steps, from replica 0, which then
holds the aggregated model (the reference writes none in this mode).
"""
from __future__ import annotations

import argparse
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, build_model, get_config, get_smoke_config
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.optim import get_optimizer
from repro_torch.train.fedleo_step import (
    make_fedleo_aggregate,
    make_fedleo_local_step,
    replicate_for_orbits,
)
from repro_torch.train.steps import TrainState, make_train_step
from repro_torch.tree import tree_map


def _batches(tokens: np.ndarray, batch: int, seq: int,
             rng: np.random.Generator) -> Iterator[dict]:
    n, s = tokens.shape
    assert s >= seq
    while True:
        rows = rng.integers(0, n, size=batch)
        col = rng.integers(0, s - seq + 1)
        yield {"tokens": torch.from_numpy(tokens[rows][:, col: col + seq])}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fedleo", action="store_true",
                    help="hierarchical FedLEO local-SGD training")
    ap.add_argument("--orbits", type=int, default=2)
    ap.add_argument("--tau", type=int, default=5,
                    help="local steps between FedLEO aggregations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> TrainState:
    """Run the driver; returns the final state (stacked over the orbit
    replicas in FedLEO mode)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(
            "train.py drives the LM path; use examples/ for multimodal"
        )
    device = resolve_device(args.device)
    model = build_model(cfg, device=device)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    train_step = make_train_step(model, opt)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))

    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state)
            print(f"[train] restored step {last}")

    ds = make_token_dataset(num_sequences=256, seq_len=args.seq * 2,
                            vocab_size=cfg.vocab_size, seed=args.seed)
    nprng = np.random.default_rng(args.seed)
    batches = _batches(ds.x, args.batch, args.seq, nprng)

    if args.fedleo:
        local_step = make_fedleo_local_step(model, opt)
        aggregate = make_fedleo_aggregate()
        state = replicate_for_orbits(state, args.orbits)
        weights = torch.ones((args.orbits,), device=device)
        t0 = time.time()
        for step_i in range(args.steps):
            rep_batch = {
                "tokens": torch.stack(
                    [next(batches)["tokens"][None] for _ in range(args.orbits)]
                ).to(device)
            }
            state, metrics = local_step(state, rep_batch)
            if (step_i + 1) % args.tau == 0:
                state = aggregate(state, weights)
                tag = " [aggregated]"
                if args.ckpt_dir and (step_i + 1) % args.ckpt_every == 0:
                    save_checkpoint(args.ckpt_dir, step_i + 1,
                                    tree_map(lambda x: x[0], state))
            else:
                tag = ""
            loss = float(torch.mean(metrics["loss"]))
            print(f"[fedleo] step {step_i + 1:4d} loss={loss:.4f}{tag}")
        print(f"[fedleo] {args.steps} steps in {time.time() - t0:.1f}s")
    else:
        t0 = time.time()
        for step_i in range(args.steps):
            batch = {"tokens": next(batches)["tokens"].to(device)}
            state, metrics = train_step(state, batch)
            if (step_i + 1) % 10 == 0 or step_i == 0:
                print(f"[train] step {step_i + 1:4d} "
                      f"loss={float(metrics['loss']):.4f}")
            if args.ckpt_dir and (step_i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step_i + 1, state)
        print(f"[train] {args.steps} steps in {time.time() - t0:.1f}s "
              f"({args.steps / (time.time() - t0):.2f} steps/s)")
    return state


def main(argv: Optional[List[str]] = None) -> None:
    train(parse_args(argv))


if __name__ == "__main__":
    main()
