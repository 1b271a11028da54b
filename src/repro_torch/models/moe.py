"""Mixture-of-Experts FFN with capacity-based dispatch.

The counterpart of ``src/repro/models/moe.py``, with the same parameter
layout (``router`` (d, E); ``w_gate``/``w_up`` (E, d, F); ``w_down``
(E, F, d); ``shared/*`` the always-on expert) and the same dispatch, so
that the same tokens land in the same slots and the same ones are
dropped:

  * top-k routing on the float32 softmax of the router logits (the
    product in x's dtype, then cast), gate values renormalised over the
    k choices;
  * per-expert buffers of ``cap = max(1, int(capacity_factor * n * k /
    E))`` slots, the reference's expression truncated the same way;
  * slots by a stable sort of each choice's expert ids (``jnp.argsort``
    is stable; ``torch.argsort`` only with ``stable=True``), ranks from
    ``searchsorted``, a running count over the k choices; a token past
    its expert's capacity is dropped: it adds a zero row to slot
    ``cap - 1`` and takes weight 0 in the combine;
  * the scatter is one out-of-place ``index_add`` over all k choices
    (autograd needs it out of place); every slot takes at most one
    nonzero row and dropped pairs add exact zeros, so the sum is exact
    and equals the reference's k scatters bit for bit;
  * the Shazeer load-balance loss ``router_aux_loss * E * sum(mean(probs)
    * bincount / n)`` in float32.

The expert products are batched matrix products over E (cuBLAS on the
card), as the reference leaves them to XLA outside any Pallas kernel.
Used by llama4-maverick (128 experts top-1, every other layer, a shared
expert) and kimi-k2 (384 experts top-8, a shared expert).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _gelu_tanh, _normal


def init_moe(rng: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> Dict:
    """Parameters drawn on ``rng``'s device, each leaf stored in
    ``dtype`` before the next is drawn."""
    E, Fe = cfg.num_experts, cfg.d_ff_expert
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(Fe)
    params = {
        "router": _normal(rng, (d_model, E), s_in, dtype),
        "w_gate": _normal(rng, (E, d_model, Fe), s_in, dtype),
        "w_up": _normal(rng, (E, d_model, Fe), s_in, dtype),
        "w_down": _normal(rng, (E, Fe, d_model), s_out, dtype),
    }
    if cfg.num_shared_experts > 0:
        Fs = Fe * cfg.num_shared_experts
        params["shared"] = {
            "w_gate": _normal(rng, (d_model, Fs), s_in, dtype),
            "w_up": _normal(rng, (d_model, Fs), s_in, dtype),
            "w_down": _normal(rng, (Fs, d_model), s_out, dtype),
        }
    return params


def capacity(cfg: MoEConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens (the reference's expression)."""
    return max(1, int(cfg.capacity_factor * n * cfg.top_k / cfg.num_experts))


def expert_counts(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Tokens per expert, int64 (E,): ``torch.bincount(idx,
    minlength=E)`` with a shape that does not depend on the data, so
    the count traces under ``FakeTensorMode`` and DTensor (out of place:
    DTensor has no in-place ``scatter_add_`` into a plain tensor)."""
    counts = torch.zeros((num_experts,), dtype=torch.int64, device=idx.device)
    return counts.scatter_add(0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


def route(params: Dict, xt: torch.Tensor, cfg: MoEConfig):
    """Routing and slot assignment of tokens ``xt`` (n, d): (gate values
    (n, k) float32, flat slots [(n,)] * k, valid masks [(n,)] * k, aux
    loss, capacity)."""
    n = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, n)
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                         # (n, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)          # (n, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balance auxiliary loss: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    tokens_per_expert = torch.zeros((E,), dtype=torch.float32, device=xt.device)
    for j in range(k):
        tokens_per_expert = tokens_per_expert + expert_counts(expert_idx[:, j], E).float()
    aux_loss = cfg.router_aux_loss * E * torch.sum(me * (tokens_per_expert / n))

    counts = torch.zeros((E,), dtype=torch.int64, device=xt.device)
    arange_n = torch.arange(n, device=xt.device)
    flats: List[torch.Tensor] = []
    valids: List[torch.Tensor] = []
    for j in range(k):
        idx_j = expert_idx[:, j]
        order = torch.argsort(idx_j, stable=True)
        sorted_e = idx_j[order]
        counts_j = expert_counts(idx_j, E)
        starts = torch.cumsum(counts_j, 0) - counts_j             # (E,) first sorted row
        pos_sorted = arange_n - starts[sorted_e] + counts[sorted_e]
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        counts = counts + counts_j
        valid = pos < cap
        flats.append(idx_j * cap + torch.clamp(pos, max=cap - 1))
        valids.append(valid)
    return gate_vals, flats, valids, aux_loss, cap


def dispatch(xt: torch.Tensor, flats: List[torch.Tensor], valids: List[torch.Tensor],
             num_experts: int, cap: int) -> torch.Tensor:
    """The experts' input buffers (E, cap, d): each valid (token, choice)
    pair's row of ``xt`` in its slot, zeros elsewhere."""
    d, k = xt.shape[1], len(flats)
    buf = torch.zeros((num_experts * cap, d), dtype=xt.dtype, device=xt.device)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    rows = torch.where(torch.cat(valids)[:, None], xt.repeat(k, 1), zero)
    return buf.index_add(0, torch.cat(flats), rows).reshape(num_experts, cap, d)


def combine(ex_out: torch.Tensor, gate_vals: torch.Tensor, flats: List[torch.Tensor],
            valids: List[torch.Tensor]) -> torch.Tensor:
    """Each token's k expert outputs (rows of ``ex_out`` (E*cap, d))
    weighted by its gate values, 0 for a dropped pair, summed in the
    reference's order and dtype."""
    out = torch.zeros((gate_vals.shape[0], ex_out.shape[1]), dtype=ex_out.dtype,
                      device=ex_out.device)
    for j, (flat, valid) in enumerate(zip(flats, valids)):
        w = (gate_vals[:, j] * valid.float()).to(ex_out.dtype)
        out = out + ex_out[flat] * w[:, None]
    return out


def apply_moe(
    params: Dict,
    x: torch.Tensor,
    cfg: MoEConfig,
    activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, float32 aux loss)."""
    act = F.silu if activation == "silu" else _gelu_tanh
    b, s, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(b * s, d)
    gate_vals, flats, valids, aux_loss, cap = route(params, xt, cfg)
    ex_in = dispatch(xt, flats, valids, E, cap)
    gate = act(torch.bmm(ex_in, params["w_gate"].to(xt.dtype)))
    up = torch.bmm(ex_in, params["w_up"].to(xt.dtype))
    ex_out = torch.bmm(gate * up, params["w_down"].to(xt.dtype)).reshape(E * cap, d)
    out = combine(ex_out, gate_vals, flats, valids)

    if "shared" in params:
        sh = params["shared"]
        g = act(xt @ sh["w_gate"].to(xt.dtype))
        u = xt @ sh["w_up"].to(xt.dtype)
        out = out + (g * u) @ sh["w_down"].to(xt.dtype)

    return out.reshape(b, s, d), aux_loss
