"""Plain PyTorch Zamba2 layers [arXiv:2411.15242], the reference of the
family ``hybrid``.

Float32, imports nothing of the program; the weights in the tree layout
of ``bench/families/hybrid.py``.  Written from the layer equations of
Hugging Face transformers' ``models/zamba2/modeling_zamba2.py`` (4.57.6)
for the published Zamba2-7B-Instruct configuration, under its key names.
Layer i of ``num_layers``, where i is the j-th of ``hybrid_layer_ids``,
first runs shared block j % ``num_mem_blocks``:

    h = RMSNorm(concat(x, emb))                   (2 d_model wide; emb the embedding output)
    q, k, v = h Wq, h Wk, h Wv                    (heads of attention_head_dim)
    q, k = RoPE(q), RoPE(k)                       (rotate-half, rope_theta)
    a = softmax(q k^T (attention_head_dim / 2)^-1/2, causal) v Wo    (no residual)
    h = RMSNorm(a)
    [g | u] = h [W_gate | W_up] + (h A_j) B_j     (use j's adapter, rank adapter_rank)
    t = ((gelu(g) * u) W_down) L_j                (exact GELU; use j's linear)

and then x + mixer(RMSNorm(x + t)); every other layer x + mixer(RMSNorm(x)).
``mixer`` is ``reference/mamba2.py``'s Mamba2 block without its input
norm and residual, and with the published gated norm over each of the
``num_groups`` B/C groups on its own (``Zamba2RMSNormGated``).

Departures from the published model:
  * dt is not clamped below at ``time_step_min``: Hugging Face's plain
    path clamps it, its CUDA path (the mamba_ssm kernels, with
    ``time_step_limit`` None) does not; this follows the kernels.
  * Everything is float32: the published code casts RoPE's cos and sin
    and each normalised activation back to the weights' type.
  * The work runs in blocks of ``ROWS`` sequences, and attention in
    blocks of ``QUERY_BLOCK`` queries, so that 32 sequences of 4096
    tokens fit on one card beside the float32 weights; every sequence's
    result is that of the whole computation (the fp8 control's
    per-tensor scales are taken per block).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator

import torch
import torch.nn.functional as F

from bench.reference.model import exact, layer, rmsnorm, ssd_scan

ROWS = 4
QUERY_BLOCK = 512


def group_rmsnorm(y: torch.Tensor, scale: torch.Tensor, eps: float, groups: int) -> torch.Tensor:
    """RMSNorm of each of ``groups`` equal groups of the last axis on its
    own (group size d_inner / ngroups); one group is the plain RMSNorm."""
    shape = y.shape
    y = y.reshape(*shape[:-1], groups, shape[-1] // groups)
    return rmsnorm(y, scale.reshape(groups, -1), eps).reshape(shape)


def mixer(p: Dict, u: torch.Tensor, cfg: dict, prec=exact) -> torch.Tensor:
    """The Mamba2 mixer of the block's normalised input ``u``: in_proj,
    the conv and its SiLU, the scan, the skip, the gated norm over each
    group, out_proj."""
    ssm = cfg["ssm"]
    d_inner = ssm["expand"] * cfg["d_model"]
    heads = d_inner // ssm["head_dim"]
    gn = ssm["num_groups"] * ssm["state_dim"]
    b, s, _ = u.shape
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
    y = group_rmsnorm(y, p["out_norm"]["scale"], cfg["rms_norm_eps"], ssm["num_groups"])
    return prec(y) @ prec(p["out_proj"])


def rope_half(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (b, s, heads, d) at positions 0 .. s-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    angles = torch.cat([angles, angles], dim=-1)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * torch.cos(angles) + torch.cat([-x2, x1], dim=-1) * torch.sin(angles)


def attention(p: Dict, h: torch.Tensor, cfg: dict, prec=exact) -> torch.Tensor:
    """Causal multi-head attention of h (b, s, 2 d_model), projected out
    to d_model, by blocks of ``QUERY_BLOCK`` queries."""
    b, s, width = h.shape
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["attention_head_dim"]
    q = (prec(h) @ prec(p["wq"].reshape(width, -1))).reshape(b, s, heads, hd)
    k = (prec(h) @ prec(p["wk"].reshape(width, -1))).reshape(b, s, kv_heads, hd)
    v = (prec(h) @ prec(p["wv"].reshape(width, -1))).reshape(b, s, kv_heads, hd)
    q, k = rope_half(q, cfg["rope_theta"]), rope_half(k, cfg["rope_theta"])
    k = k.repeat_interleave(heads // kv_heads, dim=2)
    v = v.repeat_interleave(heads // kv_heads, dim=2)
    scale = (hd / 2) ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        logits = torch.einsum("bqhd,bkhd->bhqk", prec(q[:, q0:q1]), prec(k[:, :q1])) * scale
        pos = torch.arange(q1, device=h.device)
        visible = pos[q0:q1, None] >= pos[None, :]
        probs = torch.softmax(logits.masked_fill(~visible, -math.inf), dim=-1)
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", prec(probs), prec(v[:, :q1]))
    return prec(out.reshape(b, s, heads * hd)) @ prec(p["wo"].reshape(heads * hd, -1))


def adapted_mlp(p: Dict, adapter: Dict, h: torch.Tensor, prec=exact) -> torch.Tensor:
    """The GeGLU MLP whose gate and up products take the use's adapter."""
    d_ff = p["w_gate"].shape[1]
    delta = prec(prec(h) @ prec(adapter["down"])) @ prec(adapter["up"])
    gate = prec(h) @ prec(p["w_gate"]) + delta[..., :d_ff]
    up = prec(h) @ prec(p["w_up"]) + delta[..., d_ff:]
    return prec(F.gelu(gate) * up) @ prec(p["w_down"])


def shared_block(sp: Dict, up: Dict, x: torch.Tensor, emb: torch.Tensor, cfg: dict,
                 prec=exact) -> torch.Tensor:
    """t, what one use of a shared block adds to its layer's Mamba input."""
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(torch.cat([x, emb], dim=-1), sp["ln_attn"]["scale"], eps)
    h = rmsnorm(attention(sp["attn"], h, cfg, prec), sp["ln_ffn"]["scale"], eps)
    t = adapted_mlp(sp["ffn"], up["adapter"], h, prec)
    return prec(t) @ prec(up["linear"])


def hybrid_layer(mp: Dict, sp, up, x: torch.Tensor, emb: torch.Tensor, cfg: dict,
                 prec=exact) -> torch.Tensor:
    """One layer: the shared block's use first where ``sp`` is given, then
    the Mamba2 block, by blocks of ``ROWS`` sequences."""
    out = []
    for r in range(0, x.shape[0], ROWS):
        xr, er = x[r:r + ROWS], emb[r:r + ROWS]
        u = xr if sp is None else xr + shared_block(sp, up, xr, er, cfg, prec)
        out.append(xr + mixer(mp, rmsnorm(u, mp["norm"]["scale"], cfg["rms_norm_eps"]), cfg,
                              prec))
    return torch.cat(out)


def blocks(params: Dict, cfg: dict, prec=exact
           ) -> Iterator[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """The model's layers in order, each a function of the residual
    stream and the embedding output."""
    uses = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(cfg["num_layers"]):
        sp = up = None
        if i in uses:
            sp = layer(params["shared"], uses[i] % cfg["num_mem_blocks"])
            up = layer(params["uses"], uses[i])
        yield (lambda x, emb, mp=layer(params["mamba"], i), sp=sp, up=up:
               hybrid_layer(mp, sp, up, x, emb, cfg, prec))
