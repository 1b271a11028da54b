#!/usr/bin/env python3
"""How far apart bfloat16 rounding puts a served model's prefill and its
decode, and how far each lies from the same weights in float32.

    python3 tools/bf16_gap.py [--out build/bf16_gap/results.jsonl]

For each model (random weights drawn as ``chip_smoke.py`` draws them, 4
prompts of 64 tokens) it takes the logits after the prompt three ways:
prefill through the flash kernel (``attn_impl="pallas"``), prefill
through the plain attention (``"xla"``), and 64 teacher-forced decode
steps against the cache.  Each pair is compared by its largest gap over
the largest logit (``max_rel``), the norm of the gap over the norm of
the logits (``rms_rel``) and the share of equal argmaxes.  Where the
float32 model fits beside the bfloat16 one (seamless-m4t-large-v2 whole,
internvl2-26b cut to 8 layers) the three are also run in float32 and
each bfloat16 path is compared with it.  gemma-7b (28 layers) and
internvl2-26b (48) run in bfloat16 only.  One JSON line per model on
stdout and in ``--out``; the card's name and power limit first.  Needs
one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = (("seamless-m4t-large-v2", None, True), ("internvl2-26b", 8, True),
         ("gemma-7b", None, False), ("internvl2-26b", None, False))
BATCH, PROMPT = 4, 64


def gap(torch, a, b) -> dict:
    a, b = a.float(), b.float()
    d = a - b
    return dict(max_rel=float(d.abs().max() / b.abs().max()), rms_rel=float(d.norm() / b.norm()),
                argmax_equal=float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def three_paths(torch, cfg, params, dtype, prompt, source) -> dict:
    """Logits after the prompt: flash prefill, plain prefill, decode."""
    from repro_torch.configs import build_model
    from repro_torch.train.steps import make_serve_step

    out = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            model = build_model(cfg, attn_impl=impl, dtype=dtype)
            extra = () if source is None else (source.to(dtype),)
            out[impl] = model.forward(params, prompt, *extra, last_only=True)[0][:, -1]
    model = build_model(cfg, attn_impl="pallas", dtype=dtype)
    cache = (model.init_cache(BATCH, PROMPT, dtype=dtype) if source is None
             else model.init_cache(params, source.to(dtype), PROMPT, dtype=dtype))
    step = make_serve_step(model)
    for t in range(PROMPT):
        logits, cache = step(params, prompt[:, t:t + 1], cache, t)
    out["decode"] = logits
    return out


def run_case(torch, dev, arch, layers, with_f32) -> dict:
    from repro_torch.configs import build_model, get_config
    from repro_torch.tree import tree_map

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    source = (None if cfg.encoder is None else
              torch.randn((BATCH, cfg.encoder.max_source_len, cfg.d_model), generator=gen,
                          device=dev))
    params = build_model(cfg, attn_impl="pallas", dtype=torch.bfloat16).init(
        torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    bf = three_paths(torch, cfg, params, torch.bfloat16, prompt, source)
    row = dict(arch=arch, layers=cfg.num_layers, max_abs_logit=float(bf["pallas"].abs().max()),
               bf16_flash_vs_decode=gap(torch, bf["pallas"], bf["decode"]),
               bf16_plain_vs_decode=gap(torch, bf["xla"], bf["decode"]),
               bf16_flash_vs_plain=gap(torch, bf["pallas"], bf["xla"]))
    if with_f32:
        p32 = tree_map(lambda p: p.float(), params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        fp = three_paths(torch, cfg, p32, torch.float32, prompt, source)
        row.update(f32_flash_vs_decode=gap(torch, fp["pallas"], fp["decode"]),
                   bf16_flash_vs_f32=gap(torch, bf["pallas"], fp["pallas"]),
                   bf16_plain_vs_f32=gap(torch, bf["xla"], fp["xla"]),
                   bf16_decode_vs_f32=gap(torch, bf["decode"], fp["decode"]))
        del p32
    else:
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "bf16_gap" / "results.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bf16_gap: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build" / "bf16_gap" / "kernels"))
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        def put(line):
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")

        put({"nvidia_smi": smi})
        for case in CASES:
            put(run_case(torch, dev, *case))
    return 0


if __name__ == "__main__":
    sys.exit(main())
