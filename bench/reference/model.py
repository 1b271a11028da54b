"""Plain PyTorch forward pass of the benchmark's configurations: what
every family shares.

Written from the papers' equations, in float32, with no kernel, cache or
batching of the program's; it imports nothing of the program.  It takes
the weights in the tree layout of ``bench/weights.py``: the embedding,
then the family's layers, given as ``blocks`` (the ``blocks`` function
of the family's own reference module beside this one, e.g.
``mamba2.py``: each block a function of the residual stream and the
embedding output), then a final RMSNorm and the head tied to the
embedding table.  The SSD scan is here for every family whose layers
hold it: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t,
chunked as the paper's minimal listing [arXiv:2405.21060] (in-chunk
quadratic term, chunk states, and the chunk-to-chunk recurrence by a
segment sum).

``prec`` rounds the operands of every product: ``exact`` (float32) for
the reference, ``fp8`` (per-tensor scaled e4m3, their gradients e5m2)
for the control that stands in for the program in a precision below the
one the configuration states.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator

import torch
import torch.nn.functional as F


# the family's layers: blocks(params, cfg, prec) yields block(x, emb) -> x
Blocks = Callable[..., Iterator[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type under one scale for the whole tensor,
    its largest magnitude mapped to the type's largest value ``top``."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand in e4m3; backward: its gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x as an fp8 product takes its operands: rounded to float8 e4m3
    under one scale for the whole tensor (its largest magnitude maps to
    448), the gradient that flows back to it rounded to e5m2 the same
    way, as fp8 training rounds activations, weights and gradients."""
    return _Fp8.apply(x)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] for i >= j, -inf
    above the diagonal (the stable form: masked sums, no differences)."""
    t = x.shape[-1]
    xx = x[..., None].expand(*x.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=-1)
    sums = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return sums.masked_fill(~keep, -math.inf)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, prec=exact) -> torch.Tensor:
    """y (b, s, h, p) of the SSD recurrence from a zero state.
    x (b, s, h, p), dt (b, s, h), A (h,), Bm and Cm (b, s, g, n).  A
    ragged tail is padded with dt = 0 steps, which change nothing."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    pad = (-s) % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    c = (s + pad) // chunk
    X = prec(x * dt[..., None]).reshape(b, c, chunk, h, p)
    Bh = prec(Bm.repeat_interleave(h // g, dim=2)).reshape(b, c, chunk, h, n)
    Ch = prec(Cm.repeat_interleave(h // g, dim=2)).reshape(b, c, chunk, h, n)
    a = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    a_cum = torch.cumsum(a, dim=-1)

    L = torch.exp(segsum(a))                                           # (b, h, c, l, l)
    cb = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y = torch.einsum("bhcls,bcshp->bclhp", cb * L, X)

    decay = torch.exp(a_cum[..., -1:] - a_cum)                         # (b, h, c, l)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh * decay.permute(0, 2, 3, 1)[..., None], X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))    # (b, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn->bclhp", Ch, states) \
        * torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, c * chunk, h, p)[:, :s]


def layer(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a tree stacked on a leading (L, ...) axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens]


def head(params: Dict, x: torch.Tensor, cfg: dict, prec=exact) -> torch.Tensor:
    """Logits of the final RMSNorm of x through the tied head."""
    x = rmsnorm(x, params["ln_final"]["scale"], cfg["rms_norm_eps"])
    return prec(x) @ prec(params["embed"]["table"]).t()


def last_logits(params: Dict, tokens: torch.Tensor, cfg: dict, blocks: Blocks,
                prec=exact) -> torch.Tensor:
    """(b, vocab) float32 logits of the last position of each row of
    ``tokens`` (b, s); ``params`` float32."""
    with torch.no_grad():
        x = emb = embed(params, tokens)
        for block in blocks(params, cfg, prec):
            x = block(x, emb)
        return head(params, x[:, -1:], cfg, prec)[:, 0]


def as_float32(tree: Dict) -> Dict:
    return {k: as_float32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def leaf_items(tree: Dict, prefix: str = "") -> Iterator:
    """(dotted path, tensor) of every leaf, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of each position's prediction of the next token."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1))


def loss_and_grads(params: Dict, tokens: torch.Tensor, cfg: dict, blocks: Blocks,
                   prec=exact) -> tuple:
    """(loss, {path: gradient}) of the LM loss of one model on ``tokens``
    (b, s), every block recomputed in the backward pass so that a block's
    activations alone are alive at a time."""
    from torch.utils.checkpoint import checkpoint

    names, leaves = zip(*leaf_items(params))
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in leaves]
        p = _rebuild(names, xs)
        x = emb = embed(p, tokens)
        for block in blocks(p, cfg, prec):
            x = checkpoint(block, x, emb, use_reentrant=False)
        loss = lm_loss(head(p, x, cfg, prec), tokens)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), dict(zip(names, grads))


def _rebuild(names, leaves) -> Dict:
    tree: Dict = {}
    for name, leaf in zip(names, leaves):
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    return _rebuild(list(flat), list(flat.values()))
