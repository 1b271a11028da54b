"""Weights made by the benchmark from its seed, in the program's tree layout.

One standard-normal draw fills a flat buffer in the type the weights
are trained or served in, on the generator's device; every leaf is a
view of it, scaled or mapped in place to its own initial distribution
(Mamba2's published ranges for A and dt; 1 plus noise for norm scales).
The same seed gives the same weights, so the plain reference is handed
the same values by drawing them again.

The layout (dict keys, stacked leading axes) is the one the program's
model takes: ``embed``, the family's layers (``bench/families/``),
``ln_final``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import harness

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def seed_for(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams (0 weights, 1
    tokens, 2 length order, 3 the checked sample), from ``--seed``."""
    ss = np.random.SeedSequence(entropy=abs(int(seed)), spawn_key=(stream, int(seed < 0)))
    return int(ss.generate_state(1, dtype=np.uint64)[0]) & ((1 << 63) - 1)


def leaves(cfg: dict) -> List[Leaf]:
    """(path, shape, kind, scale) of every leaf, in draw order."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    return [(("embed", "table"), (v, d), "normal", 0.02), *harness.family(cfg).leaves(cfg),
            (("ln_final", "scale"), (d,), "scale", 0.1)]


def _fill(view: torch.Tensor, kind: str, scale: float) -> None:
    """Map a standard-normal view in place to its leaf's distribution."""
    if kind == "normal":
        view.mul_(scale)
        return
    z = view.float()
    if kind == "scale":
        x = 1.0 + scale * z
    else:
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))          # uniform on (0, 1)
        if kind == "a_log":                                       # A in [-16, -1]
            x = torch.log(1.0 + 15.0 * u)
        elif kind == "dt_bias":                                   # softplus^-1 of dt in [1e-3, 0.1]
            dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
            x = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
    view.copy_(x)


def make(cfg: dict, seed: int, dtype: torch.dtype, device) -> Dict:
    """The configuration's weights for ``seed``: one draw on ``device``
    in ``dtype``, every leaf a view of it."""
    specs = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 0))
    flat = torch.randn((total,), generator=gen, dtype=dtype, device=device)
    tree: Dict = {}
    off = 0
    for path, shape, kind, scale in specs:
        size = math.prod(shape)
        view = flat[off:off + size].view(shape)
        _fill(view, kind, scale)
        off += size
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = view
    return tree
