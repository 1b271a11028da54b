"""Transformer building blocks shared by the LLM zoo.

The counterpart of ``src/repro/models/layers.py``, with the same names,
parameter layouts and dtype behaviour.  Functional style: ``init_*``
returns a param dict, ``apply_*`` is a plain function.  Two modes:

  * train/prefill: full-sequence forward, causal (or banded) mask;
  * decode: single-token forward against a KV cache.

Grouped-query attention (GQA) keeps an explicit group axis in the
einsums (no head replication); RoPE rotates interleaved channel pairs
(or, with ``AttentionConfig.rope_half``, the two halves of each head, as
Hugging Face's ``rotate_half``); the scores are scaled by head_dim^-1/2
unless ``AttentionConfig.scale`` says otherwise; the FFN is SwiGLU
(``silu``) or GeGLU (``gelu``, tanh approximation as ``jax.nn.gelu``;
``gelu_exact``, the erf form).  ``attn_impl="pallas"`` sends prefill attention to
the hand-written CUDA kernel through ``kernels.flash_ops``.

Decode writes the new keys and values into the cache's buffers in
place (the reference returns new arrays): the returned ``KVCache``
shares the buffers of the one passed in, which must not be reused.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --- rotary position embeddings -------------------------------------------------
def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0):
    """(max_len, head_dim//2) cos/sin tables."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(max_len)
    freqs = np.outer(t, inv)  # (max_len, hd/2)
    return (torch.from_numpy(np.cos(freqs)).float(),
            torch.from_numpy(np.sin(freqs)).float())


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               half: bool = False):
    """Rotate interleaved pairs of channels (0::2 with 1::2), or with
    ``half`` channel i with i + hd/2.  x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    angles = positions[..., None].float() * inv          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    if half:
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return (x * torch.cat([cos, cos], dim=-1)
                + torch.cat([-x2, x1], dim=-1) * torch.cat([sin, sin], dim=-1))
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    # re-interleave
    return torch.stack([out1, out2], dim=-1).reshape(x.shape)


# --- attention --------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    sliding_window: Optional[int] = None   # None = full attention
    use_rope: bool = True
    logit_soft_cap: Optional[float] = None
    rope_half: bool = False                # rotate halves, not interleaved pairs
    scale: Optional[float] = None          # None = head_dim ** -0.5

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


class KVCache(NamedTuple):
    """Decode cache. k/v: (B, S_max, H_kv, hd); index: int32 write pos.

    For sliding-window attention S_max = window: the cache is a rolling
    ring buffer (index mod window)."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor  # ()

    @staticmethod
    def zeros(batch: int, max_len: int, num_kv: int, head_dim: int,
              dtype: torch.dtype = torch.bfloat16, device=None) -> "KVCache":
        return KVCache(
            k=torch.zeros((batch, max_len, num_kv, head_dim), dtype=dtype, device=device),
            v=torch.zeros((batch, max_len, num_kv, head_dim), dtype=dtype, device=device),
            index=torch.zeros((), dtype=torch.int32, device=device),
        )


def _normal(rng: torch.Generator, shape, scale: float,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A float32 draw on ``rng``'s device times ``scale``, stored in
    ``dtype`` (the float32 draw is freed before the next one)."""
    return torch.randn(shape, generator=rng, device=rng.device).mul_(scale).to(dtype)


def init_attention(rng: torch.Generator, cfg: AttentionConfig,
                   dtype: torch.dtype = torch.float32) -> Dict:
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": _normal(rng, (d, h, hd), s, dtype),
        "wk": _normal(rng, (d, g, hd), s, dtype),
        "wv": _normal(rng, (d, g, hd), s, dtype),
        "wo": _normal(rng, (h, hd, d), s / math.sqrt(h), dtype),
    }


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Sk) boolean allow-mask from absolute positions."""
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def attention_scores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, q_per_kv: int,
    logit_soft_cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query SDPA.  q: (B,Sq,H,hd), k/v: (B,Sk,G,hd), H=G*q_per_kv.

    Logits stay in q's dtype through the scale and the soft-cap, masked
    entries take that dtype's most negative value, the softmax is float32
    and the probabilities go back to q's dtype, as in the reference.
    """
    b, sq, h, hd = q.shape
    g = k.shape[2]
    q = q.reshape(b, sq, g, q_per_kv, hd)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    logits = torch.einsum("bqgph,bkgh->bgpqk", q, k) * scale
    if logit_soft_cap is not None:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
    logits = logits.masked_fill(~mask[:, None, None], torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bgpqk,bkgh->bqgph", probs, v)
    return out.reshape(b, sq, h, hd)


def chunked_attention(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, S, G, hd)
    v: torch.Tensor,            # (B, S, G, hd)
    q_per_kv: int,
    causal: bool = True,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    q_chunk: int = 512,
    k_chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: online softmax over KV
    chunks, never materialising the (S, S) score matrix.  A forward
    loop: the reference's ``jax.checkpoint`` matters only for a
    backward pass."""
    b, s, h, hd = q.shape
    g = k.shape[2]
    # largest chunk <= requested that divides s
    q_chunk = math.gcd(s, min(q_chunk, s))
    k_chunk = math.gcd(s, min(k_chunk, s))
    nq, nk = s // q_chunk, s // k_chunk
    scale = 1.0 / math.sqrt(hd) if scale is None else scale

    # (B, G, P, S, hd) layouts
    qh = q.reshape(b, s, g, q_per_kv, hd).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()              # (B, G, S, hd)
    vh = v.permute(0, 2, 1, 3).float()
    outs = []
    for qi in range(nq):
        qblk = qh[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]      # (B,G,P,Qc,hd)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, g, q_per_kv, q_chunk, 1), -math.inf, device=q.device)
        l = torch.zeros((b, g, q_per_kv, q_chunk, 1), device=q.device)
        acc = torch.zeros((b, g, q_per_kv, q_chunk, hd), device=q.device)
        for ki in range(nk):
            kblk = kh[:, :, ki * k_chunk:(ki + 1) * k_chunk]     # (B,G,Kc,hd)
            vblk = vh[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            s_ = torch.einsum("bgpqh,bgkh->bgpqk", qblk, kblk) * scale
            if logit_soft_cap is not None:
                s_ = logit_soft_cap * torch.tanh(s_ / logit_soft_cap)
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            diff = q_pos[:, None] - k_pos[None, :]
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= diff >= 0
            if window is not None:
                mask &= diff < window
            s_ = s_.masked_fill(~mask, -math.inf)
            m_cur = torch.amax(s_, dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_cur)
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s_ - m_safe)
            p = torch.where(torch.isfinite(s_), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = corr * l + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bgpqk,bgkh->bgpqh", p, vblk)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=3)                     # (B, G, P, S, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype)


def apply_attention(
    params: Dict,
    x: torch.Tensor,
    cfg: AttentionConfig,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full attention layer.  x: (B, S, D).

    Train/prefill: cache=None, positions default to arange(S); the
    attention runs as ``attn_impl``: "xla" (the plain masked product,
    the reference's name for it), "chunked" or "pallas" (the CUDA flash
    kernel on the card, its plain version on the CPU).
    Decode: cache given, x is (B, 1, D), positions = current absolute
    pos; the cache's buffers are written in place.
    """
    b, s, d = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dgk->bsgk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dgk->bsgk", x, params["wv"].to(x.dtype))
    if cfg.use_rope:
        rope = {"half": True} if cfg.rope_half else {}
        q = apply_rope(q, positions, cfg.rope_theta, **rope)
        k = apply_rope(k, positions, cfg.rope_theta, **rope)
    # a scale other than head_dim ** -0.5 is passed on; the default is not,
    # so the dry run's stand-ins for these functions take the same call
    scaled = {} if cfg.scale is None else {"scale": cfg.scale}

    new_cache = None
    if cache is None:
        if attn_impl == "pallas":
            from repro_torch.kernels import flash_ops

            out = flash_ops.flash_attention(
                q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                logit_soft_cap=cfg.logit_soft_cap, **scaled,
            )
        elif attn_impl == "chunked":
            out = chunked_attention(
                q, k, v, cfg.q_per_kv, causal=cfg.causal,
                window=cfg.sliding_window,
                logit_soft_cap=cfg.logit_soft_cap, **scaled,
            )
        else:
            mask = _attn_mask(positions, positions, cfg.causal,
                              cfg.sliding_window)
            out = attention_scores(q, k, v, mask, cfg.q_per_kv,
                                   cfg.logit_soft_cap, **scaled)
    else:
        # decode: write k/v at cache.index (ring buffer for windowed attn),
        # clamped as the reference's dynamic_update_slice clamps its start
        s_max = cache.k.shape[1]
        write_idx = (
            cache.index % s_max if cfg.sliding_window is not None
            else cache.index
        )
        write_idx = torch.clamp(write_idx.long(), 0, s_max - s)
        rows = write_idx + torch.arange(s, device=x.device)
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        new_cache = KVCache(k=cache.k, v=cache.v, index=cache.index + s)
        # absolute positions of cache slots
        slot = torch.arange(s_max, device=x.device)
        if cfg.sliding_window is not None:
            # ring buffer: slot i holds absolute pos = largest p <= index
            # with p % s_max == i
            cur = cache.index + s - 1  # last absolute position written
            abs_pos = cur - torch.remainder(cur - slot, s_max)
            valid = abs_pos >= torch.clamp(cur - s_max + 1, min=0)
        else:
            abs_pos = slot
            valid = slot < (cache.index + s)
        k_pos = abs_pos.expand(b, s_max)
        mask = _attn_mask(positions, k_pos, cfg.causal, cfg.sliding_window)
        mask &= valid[None, None, :]
        out = attention_scores(
            q, cache.k.to(q.dtype), cache.v.to(q.dtype), mask,
            cfg.q_per_kv, cfg.logit_soft_cap, **scaled,
        )

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, new_cache


# --- cross attention (enc-dec) -----------------------------------------------------
def apply_cross_attention(
    params: Dict,
    x: torch.Tensor,
    memory_kv: Tuple[torch.Tensor, torch.Tensor],
    cfg: AttentionConfig,
    memory_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V.

    memory_kv: (k, v) each (B, S_enc, G, hd) — computed once per request
    and cached across decode steps.
    """
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k, v = memory_kv
    s_enc = k.shape[1]
    if memory_mask is None:
        mask = torch.ones((b, s, s_enc), dtype=torch.bool, device=x.device)
    else:
        mask = memory_mask[:, None, :].expand(b, s, s_enc)
    out = attention_scores(q, k.to(q.dtype), v.to(q.dtype), mask, cfg.q_per_kv)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def encode_memory_kv(params: Dict, memory: torch.Tensor, cfg: AttentionConfig):
    """Precompute cross-attention K/V from encoder output (no RoPE)."""
    k = torch.einsum("bsd,dgk->bsgk", memory, params["wk"].to(memory.dtype))
    v = torch.einsum("bsd,dgk->bsgk", memory, params["wv"].to(memory.dtype))
    return k, v


# --- gated FFN ---------------------------------------------------------------------
def init_glu_ffn(rng: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32) -> Dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": _normal(rng, (d_model, d_ff), s_in, dtype),
        "w_up": _normal(rng, (d_model, d_ff), s_in, dtype),
        "w_down": _normal(rng, (d_ff, d_model), s_out, dtype),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact form
    return F.gelu(x, approximate="tanh")


GLU_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "gelu_exact": F.gelu}


def apply_glu_ffn(params: Dict, x: torch.Tensor, activation: str = "silu",
                  adapter: Optional[Dict] = None):
    """SwiGLU ('silu') or GeGLU ('gelu' tanh, 'gelu_exact' erf) feed-forward.
    With ``adapter``, the gate and up products take a low-rank delta:
    [gate | up] = x [W_gate | W_up] + (x A_down) A_up."""
    act = GLU_ACTIVATIONS.get(activation, _gelu_tanh)
    gate = x @ params["w_gate"].to(x.dtype)
    up = x @ params["w_up"].to(x.dtype)
    if adapter is not None:
        delta = (x @ adapter["down"].to(x.dtype)) @ adapter["up"].to(x.dtype)
        gate = gate + delta[..., :gate.shape[-1]]
        up = up + delta[..., gate.shape[-1]:]
    return (act(gate) * up) @ params["w_down"].to(x.dtype)
