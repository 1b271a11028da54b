"""Plain PyTorch version of the flash-attention kernel.

The counterpart of ``src/repro/kernels/flash_ref.py``.  The CPU branch
of ``flash_ops`` uses it, and the tests and ``chip_smoke.py`` hold the
CUDA kernel against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(
    q: torch.Tensor,        # (B, S, H, D)
    k: torch.Tensor,        # (B, S, G, D)
    v: torch.Tensor,        # (B, S, G, D)
    causal: bool = True,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA softmax attention in float32 (masked logits -inf), returned
    in ``q.dtype``; the scores scaled by ``scale``, D^-1/2 where None."""
    b, s, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    qf = q.float().reshape(b, s, g, rep, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float())
    logits = logits / math.sqrt(d) if scale is None else logits * scale
    if logit_soft_cap is not None:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
