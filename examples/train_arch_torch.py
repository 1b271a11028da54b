"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps with the FedLEO hierarchical aggregation schedule.

The twin of ``examples/train_arch.py``, written against ``repro_torch``
alone.  Two orbit replicas, stacked on a leading axis, run local steps;
every tau steps the sink/GS weighted aggregation folds them together.
It runs on the card unless ``--device`` names another device; the
printed steps/s are read at the printed steps, where the loss is read
back from the device.

  PYTHONPATH=src python examples/train_arch_torch.py                 # ~100M model
  PYTHONPATH=src python examples/train_arch_torch.py --steps 50      # shorter
  PYTHONPATH=src python examples/train_arch_torch.py --small --steps 20 --device cpu
"""
import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.models.nn import count_params
from repro_torch.optim import get_optimizer
from repro_torch.train.fedleo_step import (
    make_fedleo_aggregate,
    make_fedleo_local_step,
    replicate_for_orbits,
)
from repro_torch.train.steps import TrainState


def hundred_m_config(small: bool = False) -> ArchConfig:
    """~100M-parameter dense LM (gemma-family wiring); ``small`` gives a
    ~25M variant for quick CPU runs."""
    if small:
        return dataclasses.replace(
            get_smoke_config("gemma-7b"),
            num_layers=4, d_model=512, num_heads=8, num_kv_heads=8,
            head_dim=64, d_ff=2048, vocab_size=8192,
            tie_embeddings=False,
        )
    return dataclasses.replace(
        get_smoke_config("gemma-7b"),
        num_layers=8,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=32768,   # ~100M total with untied embeddings
        tie_embeddings=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--orbits", type=int, default=2)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--small", action="store_true",
                    help="~25M variant for quick CPU runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = hundred_m_config(small=args.small)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n = count_params(params)
    print(f"model: {n / 1e6:.1f}M params, {cfg.num_layers}L "
          f"d_model={cfg.d_model}")

    opt = get_optimizer("adam", 3e-4)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))
    R = args.orbits
    state = replicate_for_orbits(state, R)

    ds = make_token_dataset(num_sequences=128, seq_len=args.seq,
                            vocab_size=cfg.vocab_size, seed=0)
    tokens = torch.from_numpy(ds.x)
    rng = np.random.default_rng(0)

    local_step = make_fedleo_local_step(model, opt)
    aggregate = make_fedleo_aggregate()
    weights = torch.ones((R,), device=device)

    t0 = time.time()
    losses = []         # each step's mean loss over the replicas, on the device
    printed = []
    for i in range(args.steps):
        rows = rng.integers(0, len(ds.x), size=(R, args.batch))
        batch = {"tokens": tokens[torch.from_numpy(rows)][:, None].to(device)}
        state, metrics = local_step(state, batch)
        losses.append(torch.mean(metrics["loss"]))
        if (i + 1) % args.tau == 0:
            state = aggregate(state, weights)
        if (i + 1) % 20 == 0:
            recent = float(torch.stack(losses[-20:]).mean().item())
            dt = time.time() - t0
            printed.append((i + 1, recent, (i + 1) / dt))
            print(f"step {i + 1:4d}  loss={recent:.4f}  "
                  f"({(i + 1) / dt:.2f} steps/s)")
    first, last = losses[0].item(), losses[-1].item()
    tail = float(torch.stack(losses[-10:]).mean().item())
    seconds = time.time() - t0
    assert last < first, "no learning progress"
    print(f"done: loss {first:.3f} -> {tail:.3f} "
          f"in {seconds:.0f}s")
    return {"params": n, "steps": args.steps, "first_loss": first, "last_loss": last,
            "tail_loss": tail, "seconds": seconds, "steps_per_s": args.steps / seconds,
            "printed": printed}


if __name__ == "__main__":
    main()
