"""Plain PyTorch Mamba2 layers [arXiv:2405.21060], the reference of the
family ``ssm`` (and of any family whose layers hold Mamba2 blocks).

Float32, imports nothing of the program; the weights in the tree layout
of ``bench/families/ssm.py``.  A Mamba2 block: pre-norm RMSNorm; one
input projection to (z, x, B, C, dt); a causal depthwise conv of width W
over (x, B, C) and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
the SSD scan (``model.ssd_scan``); y + D x, gated by SiLU(z), RMSNorm,
output projection, residual.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator

import torch
import torch.nn.functional as F

from bench.reference.model import exact, layer, rmsnorm, ssd_scan


def mamba_block(p: Dict, x: torch.Tensor, cfg: dict, prec=exact) -> torch.Tensor:
    ssm = cfg["ssm"]
    eps = cfg["rms_norm_eps"]
    d_inner = ssm["expand"] * cfg["d_model"]
    heads = d_inner // ssm["head_dim"]
    gn = ssm["num_groups"] * ssm["state_dim"]
    b, s, _ = x.shape
    u = rmsnorm(x, p["norm"]["scale"], eps)
    zxbcdt = prec(u) @ prec(p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, heads], dim=-1)
    w = p["conv_w"]                                                     # (W, channels)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (w.shape[0] - 1, 0)), w.t()[:, None, :],
                   bias=p["conv_b"], groups=w.shape[1]).transpose(1, 2)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, heads, ssm["head_dim"])
    y = ssd_scan(xh, dt, A, Bm.reshape(b, s, ssm["num_groups"], -1),
                 Cm.reshape(b, s, ssm["num_groups"], -1), ssm["chunk_size"], prec)
    y = (y + p["D"][:, None] * xh).reshape(b, s, d_inner) * F.silu(z)
    y = rmsnorm(y, p["out_norm"]["scale"], eps)
    return x + prec(y) @ prec(p["out_proj"])


def blocks(params: Dict, cfg: dict, prec=exact
           ) -> Iterator[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """The model's Mamba2 blocks in order, each a function of the
    residual stream and the embedding output, which it does not read."""
    for i in range(cfg["num_layers"]):
        yield lambda x, emb, p=layer(params["layers"], i): mamba_block(p, x, cfg, prec)
