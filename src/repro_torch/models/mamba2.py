"""Mamba2: state-space duality (SSD) blocks [arXiv:2405.21060].

The counterpart of ``src/repro/models/mamba2.py``, with the same names,
parameter layouts and dtype behaviour.  The chunked SSD algorithm:

  h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t (x) x_t)
  y_t = C_t . h_t + D x_t

computed chunk-parallel: a within-chunk "attention-like" term (C B^T
masked by the cumulative decay L) plus an across-chunk recurrent state
pass (a loop over chunks).  This plain path is also the oracle
(``kernels/ssd_ref.py``) of the CUDA ``ssd_scan`` kernel; the model
routes through the kernel with ``ssd_impl="pallas"`` (the reference's
name for its kernel path), which on the CPU runs the padded plain
version.

The recurrent (decode) path keeps O(1) state per layer: conv state
(B, W-1, C_conv) + SSM state (B, H, P, N).

``Mamba2Model`` keeps the reference's stacked layout: every leaf of
``params["layers"]`` has a leading ``num_layers`` axis, so reference
weights carry across with ``convert.params_from_numpy`` unchanged; with
``cfg.remat`` and grad mode on, each block is recomputed in the backward
pass.  It runs on CUDA unless the caller asks for the CPU (``device="cpu"``);
``init(rng)`` draws on the generator's device.  ``decode_step`` writes
the SSM states into the cache's buffer in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.tree import tree_map

PyTree = Any


# --- the SSD scan (plain PyTorch; also the kernel oracle) -----------------------------
def segsum(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{k=j+1..i} a[k] for i >= j else -inf.  a: (..., Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., i, j)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H) positive
    A: torch.Tensor,        # (H,) negative
    Bm: torch.Tensor,       # (B, S, G, N)
    Cm: torch.Tensor,       # (B, S, G, N)
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    nc = s // chunk
    rep = h // g  # heads per B/C group

    dtype = x.dtype
    xdt = (x * dt[..., None]).float()                    # dt-weighted input
    a = (dt * A[None, None, :]).float()                  # (B, S, H) log-decay

    # reshape into chunks
    xc = xdt.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h)
    Bc = Bm.float().reshape(b, nc, chunk, g, n)
    Cc = Cm.float().reshape(b, nc, chunk, g, n)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)         # (B,nc,Q,H,N)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)

    # within-chunk (diagonal) term
    L = torch.exp(segsum(ac.movedim(-1, -2)))            # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)  # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)   # (B,nc,Q,H,P)

    # chunk summaries: state contribution of each chunk
    a_cum = torch.cumsum(ac, dim=2)                      # (B,nc,Q,H)
    a_tot = a_cum[:, :, -1, :]                           # (B,nc,H)
    decay_to_end = torch.exp(a_tot[:, :, None, :] - a_cum)   # (B,nc,Q,H)
    chunk_states = torch.einsum(
        "bcqhn,bcqhp->bchpn", Bh, xc * decay_to_end[..., None]
    )                                                    # (B,nc,H,P,N)

    # across-chunk recurrence
    if initial_state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    else:
        state = initial_state.float()
    states_before = []
    for c in range(nc):
        states_before.append(state)                      # state BEFORE chunk c
        state = state * torch.exp(a_tot[:, c])[:, :, None, None] + chunk_states[:, c]
    states_before = torch.stack(states_before, dim=1)    # (B,nc,H,P,N)

    # off-diagonal (carry-in) term
    state_decay = torch.exp(a_cum)                       # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, states_before) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p).to(dtype)
    return y, state


def ssd_decode_step(
    x: torch.Tensor,      # (B, H, P) single token
    dt: torch.Tensor,     # (B, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, G, N)
    Cm: torch.Tensor,     # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[1]
    g = Bm.shape[1]
    rep = h // g
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()   # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
    dA = torch.exp(dt.float() * A[None, :])                # (B,H)
    xdt = (x * dt[..., None]).float()                      # (B,H,P)
    new_state = state * dA[:, :, None, None] + torch.einsum("bhn,bhp->bhpn", Bh, xdt)
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


# --- Mamba2 block -------------------------------------------------------------------
class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_channels)
    ssm: torch.Tensor     # (B, H, P, N)


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nheads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.num_groups * ssm.state_dim
    return d_inner, nheads, ssm.num_groups, ssm.state_dim, conv_ch


def init_mamba_block(rng: torch.Generator, cfg: ArchConfig) -> Dict:
    """float32 parameters of one block, drawn on ``rng``'s device."""
    ssm = cfg.ssm
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = rng.device
    proj_out = 2 * d_inner + 2 * g * n + nheads   # z, x, B, C, dt
    s = 1.0 / math.sqrt(d)
    return {
        "norm": nn.init_rmsnorm(d),
        "in_proj": torch.randn((d, proj_out), generator=rng, device=dev) * s,
        "conv_w": torch.randn((ssm.conv_width, conv_ch), generator=rng, device=dev) * 0.2,
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32)),
        "D": torch.ones((nheads,), dtype=torch.float32),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32),
        "out_norm": nn.init_rmsnorm(d_inner),
        "out_proj": torch.randn((d_inner, d), generator=rng, device=dev)
        * (1.0 / math.sqrt(d_inner)),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, nheads, g, n, _ = _dims(cfg)
    idx = 0
    z = proj[..., idx: idx + d_inner]; idx += d_inner
    xin = proj[..., idx: idx + d_inner]; idx += d_inner
    Bm = proj[..., idx: idx + g * n]; idx += g * n
    Cm = proj[..., idx: idx + g * n]; idx += g * n
    dt = proj[..., idx:]
    return z, xin, Bm, Cm, dt


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, S, C) with width-W taps (W, C).
    Returns the output and the last W-1 inputs (the decode cache's
    tail), both in ``seq.dtype``."""
    width = w.shape[0]
    if prev is None:
        pad = torch.zeros((seq.shape[0], width - 1, seq.shape[2]), dtype=seq.dtype,
                          device=seq.device)
    else:
        pad = prev.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    out = sum(
        full[:, i: i + seq.shape[1], :] * w[i][None, None, :].to(seq.dtype)
        for i in range(width)
    )
    new_prev = full[:, -(width - 1):, :] if width > 1 else pad[:, :0]
    return out + b[None, None, :].to(seq.dtype), new_prev


def apply_mamba_block(
    params: Dict,
    x: torch.Tensor,                      # (B, S, D)
    cfg: ArchConfig,
    cache: Optional[MambaCache] = None,
    ssd_impl: str = "xla",
) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """One pre-norm Mamba2 block.  Prefill (cache=None): the SSD scan
    runs as ``ssd_impl``, "xla" (the plain chunked scan) or "pallas"
    (the CUDA kernel on the card, the padded plain version on the CPU).
    Decode: x is (B, 1, D) and the recurrence steps once from the cache."""
    ssm = cfg.ssm
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    residual = x
    h = nn.apply_rmsnorm(params["norm"], x)
    proj = h @ params["in_proj"].to(h.dtype)
    z, xin, Bm, Cm, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    prev = cache.conv if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], params["conv_b"], prev)
    conv_out = F.silu(conv_out)
    # views into conv_out: the kernel reads them through their strides
    xin = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner: d_inner + g * n]
    Cm = conv_out[..., d_inner + g * n:]

    b, s, _ = x.shape
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    xh = xin.reshape(b, s, nheads, ssm.head_dim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)

    if cache is None:
        if ssd_impl == "pallas":
            from repro_torch.kernels import ssd_ops

            y, final_state = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=ssm.chunk_size)
        else:
            y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(ssm.chunk_size, s))
        new_cache = None
    else:
        y, new_ssm = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], cache.ssm)
        y = y[:, None]
        new_cache = MambaCache(conv=new_conv, ssm=new_ssm)

    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(b, s, d_inner)
    y = y * F.silu(z)
    y = nn.apply_rmsnorm(params["out_norm"], y)
    out = residual + y @ params["out_proj"].to(y.dtype)
    return out, new_cache


def init_mamba_cache(cfg: ArchConfig, batch: int, device=None) -> MambaCache:
    ssm = cfg.ssm
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, ssm.conv_width - 1, conv_ch), dtype=torch.bfloat16,
                         device=device),
        ssm=torch.zeros((batch, nheads, ssm.head_dim, n), dtype=torch.float32,
                        device=device),
    )


def stacked_mamba_cache(cfg: ArchConfig, batch: int, lead: Tuple[int, ...],
                        device=None) -> MambaCache:
    """``init_mamba_cache`` with leading stack axes ``lead``, as the
    reference's ``jax.vmap`` over layers gives."""
    one = init_mamba_cache(cfg, batch, device)
    return MambaCache(*(t.expand(*lead, *t.shape).contiguous() for t in one))


def decode_mamba_stack(layers: PyTree, cache: MambaCache, x: torch.Tensor,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, MambaCache]:
    """One decode step through a stack of Mamba blocks (leading axis of
    ``layers`` and ``cache``).  The SSM states are written into
    ``cache.ssm`` in place; the conv tails come back in x's dtype, as the
    reference's, in a new stacked tensor."""
    convs = []
    for i in range(cache.ssm.shape[0]):
        bp = tree_map(lambda p: p[i], layers)
        x, nc = apply_mamba_block(bp, x, cfg,
                                  cache=MambaCache(conv=cache.conv[i], ssm=cache.ssm[i]))
        cache.ssm[i].copy_(nc.ssm)
        convs.append(nc.conv)
    return x, MambaCache(conv=torch.stack(convs), ssm=cache.ssm)


# --- full Mamba2 model ------------------------------------------------------------------
class Mamba2Model:
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16,
                 ssd_impl: str = "xla",
                 device: Optional[Union[str, torch.device]] = None, **_):
        assert cfg.ssm is not None
        self.cfg = cfg
        self.dtype = dtype
        self.ssd_impl = ssd_impl
        self.device = resolve_device(device)

    def init(self, rng: torch.Generator) -> PyTree:
        """float32 parameters, drawn on ``rng``'s device and placed on
        the model's, the layer stack filled one layer at a time."""
        cfg = self.cfg
        dev = self.device
        params = {
            "embed": tree_map(lambda p: p.to(dev),
                              nn.init_embedding(rng, cfg.vocab_size, cfg.d_model)),
            "layers": nn.init_stacked(rng, lambda r: init_mamba_block(r, cfg),
                                   cfg.num_layers, dev),
            "ln_final": tree_map(lambda p: p.to(dev), nn.init_rmsnorm(cfg.d_model)),
        }
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab_size), generator=rng,
                            device=rng.device) * (1.0 / math.sqrt(cfg.d_model))
            params["lm_head"] = {"w": w.to(dev)}
        return params

    def forward(self, params, tokens, extra_embeds=None, last_only=False):
        """tokens: (B, S) -> (logits (B, S, V), aux_loss 0.0); with
        ``last_only`` the logits of the final position only."""
        if extra_embeds is not None:
            raise NotImplementedError("Mamba2Model takes no extra_embeds")
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        layers = params["layers"]
        for i in range(self.cfg.num_layers):
            x = nn.remat(self.cfg.remat, self._block, x, tree_map(lambda p: p[i], layers))
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), 0.0

    def _block(self, x, bp):
        return apply_mamba_block(bp, x, self.cfg, ssd_impl=self.ssd_impl)[0]

    def _lm_head(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].to(x.dtype).T
        return x @ params["lm_head"]["w"].to(x.dtype)

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        """Stacked ``MambaCache`` (num_layers, ...): conv tails in
        bfloat16 and SSM states in float32, as the reference's, whatever
        ``max_len`` and ``dtype``."""
        return stacked_mamba_cache(self.cfg, batch, (self.cfg.num_layers,), self.device)

    def decode_step(self, params, tokens, cache, position):
        """One token per sequence (B, 1) against the cache ->
        (logits (B, 1, V), new cache)."""
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        x, new_cache = decode_mamba_stack(params["layers"], cache, x, self.cfg)
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), new_cache
