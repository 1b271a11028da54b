"""Serving on the PyTorch port: batched autoregressive decoding with a
KV cache.

The twin of ``examples/serve_decode.py``, written against
``repro_torch`` alone: a reduced gemma-family model prefills a prompt
batch through the single-token serve step, then decodes greedily, with
the full cache and with the sliding-window cache (long-context mode).
It runs on the card unless ``--device`` names another device.

  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.train.steps import make_serve_step
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("gemma-7b")
    batch, prompt_len, gen_len = 4, 16, 32

    generated = {}
    for window in (None, 8):
        model = build_model(cfg, sliding_window=window, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        serve = make_serve_step(model)

        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
        ).to(device)
        max_len = prompt_len + gen_len
        cache = model.init_cache(batch, max_len)
        cache_bytes = sum(leaf.numel() * leaf.element_size()
                          for leaf in tree_leaves(cache))

        # teacher-forced prefill through the decode path
        for t in range(prompt_len):
            logits, cache = serve(params, prompt[:, t: t + 1], cache, t)
        # greedy generation
        t0 = time.time()
        out = []
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        for t in range(prompt_len, max_len):
            out.append(tok)
            logits, cache = serve(params, tok, cache, t)
            tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        gen = torch.cat(out, dim=1).cpu()      # waits for the last step
        dt = time.time() - t0
        mode = f"sliding-window({window})" if window else "full-cache"
        print(f"[{mode}] cache={cache_bytes / 1e6:.2f} MB  "
              f"generated {tuple(gen.shape)} tokens  "
              f"{batch * gen_len / dt:.1f} tok/s")
        print("  sample:", gen[0, :12].tolist())
        generated[mode] = gen
    return generated


if __name__ == "__main__":
    main()
