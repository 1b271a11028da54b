"""Decoder-only transformer of the LLM zoo (the dense family).

The counterpart of ``Transformer`` in ``src/repro/models/transformer.py``:
pre-norm blocks, GQA attention (``repro_torch.models.layers``),
SwiGLU/GeGLU FFN, RMSNorm, RoPE, an optional tied LM head.

The parameter pytree keeps the reference's stacked layout: every leaf of
``params["layers"]`` has a leading ``num_units`` axis (a unit is one
block, ``"block0"``), as the reference's ``jax.vmap`` init gives, so
reference weights carry across with ``convert.params_from_numpy``
unchanged.  The layers are applied in a Python loop over units
(``scan_layers`` changes nothing); with ``cfg.remat`` and grad mode on,
each unit is recomputed in the backward pass (``nn.remat``), as the
reference wraps each unit in ``jax.checkpoint``.

Three entry points:
  * ``forward(params, tokens, last_only=...)`` — prefill full-sequence
  * ``init_cache(batch, max_len)``             — decode cache pytree
  * ``decode_step(params, tokens, cache, position)`` — one-token serve step

The model runs on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card the default raises.  ``init(rng)``
draws on the generator's device — at full width a CPU draw would take
tens of GB of host memory and minutes, so draw on the card — and
places the parameters on the model's device.  MoE blocks, the VLM stub
and ``EncoderDecoder`` are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models.layers import (
    AttentionConfig,
    KVCache,
    apply_attention,
    apply_glu_ffn,
    init_attention,
    init_glu_ffn,
)
from repro_torch.tree import tree_map

PyTree = Any


def _attn_cfg(cfg: ArchConfig, sliding_window: Optional[int] = None,
              causal: bool = True) -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        causal=causal,
        sliding_window=sliding_window,
        logit_soft_cap=cfg.logit_soft_cap,
    )


class Transformer:
    """Decoder-only transformer (dense)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.bfloat16,
                 sliding_window: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: MoE blocks are not ported yet (ROADMAP §A item 6c)"
            )
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.sliding_window = sliding_window
        self.device = resolve_device(device)
        self.num_units = cfg.num_layers

    # --- init -------------------------------------------------------------------
    def _init_unit(self, rng: torch.Generator) -> Dict:
        cfg = self.cfg
        return {"block0": {
            "ln_attn": nn.init_rmsnorm(cfg.d_model),
            "attn": init_attention(rng, _attn_cfg(cfg)),
            "ln_ffn": nn.init_rmsnorm(cfg.d_model),
            "ffn": init_glu_ffn(rng, cfg.d_model, cfg.d_ff),
        }}

    def init(self, rng: torch.Generator) -> PyTree:
        """float32 parameters, drawn on ``rng``'s device and placed on
        the model's.  The layer stack is filled one unit at a time, so
        the peak is the stack plus one unit."""
        cfg = self.cfg
        dev = self.device
        embed = tree_map(lambda p: p.to(dev), nn.init_embedding(rng, cfg.vocab_size,
                                                                cfg.d_model))
        params = {
            "embed": embed,
            "layers": nn.init_stacked(rng, self._init_unit, self.num_units, dev),
            "ln_final": tree_map(lambda p: p.to(dev), nn.init_rmsnorm(cfg.d_model)),
        }
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab_size), generator=rng,
                            device=rng.device) * (1.0 / cfg.d_model ** 0.5)
            params["lm_head"] = {"w": w.to(dev)}
        return params

    # --- blocks ---------------------------------------------------------------------
    def _apply_block(self, bp: Dict, x, positions, cache=None, window=None):
        cfg = self.cfg
        acfg = _attn_cfg(cfg, sliding_window=window)
        h = nn.apply_rmsnorm(bp["ln_attn"], x)
        attn_out, new_cache = apply_attention(
            bp["attn"], h, acfg, positions=positions, cache=cache,
            attn_impl=self.attn_impl,
        )
        x = x + attn_out
        h = nn.apply_rmsnorm(bp["ln_ffn"], x)
        return x + apply_glu_ffn(bp["ffn"], h, cfg.activation), new_cache

    # --- forward (prefill) ----------------------------------------------------------
    def forward(
        self,
        params: PyTree,
        tokens: torch.Tensor,
        extra_embeds: Optional[torch.Tensor] = None,
        last_only: bool = False,
    ) -> Tuple[torch.Tensor, float]:
        """tokens: (B, S) -> (logits (B, S, V), aux_loss 0.0).

        extra_embeds: the VLM stub's patch embeddings, not ported yet.
        last_only: compute logits for the final position only (prefill
        serving path — avoids materializing the (B, S, V) tensor).
        """
        if extra_embeds is not None:
            raise NotImplementedError("the VLM stub is not ported yet (ROADMAP §A item 6c)")
        tokens = tokens.to(self.device)
        x = nn.apply_embedding(params["embed"], tokens, self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        layers = params["layers"]

        def unit(x, bp):
            return self._apply_block(bp, x, positions, window=self.sliding_window)[0]

        for i in range(self.num_units):
            x = nn.remat(self.cfg.remat, unit, x, tree_map(lambda p: p[i], layers["block0"]))
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), 0.0

    def _lm_head(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].to(x.dtype).T
        return x @ params["lm_head"]["w"].to(x.dtype)

    # --- decode ------------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> PyTree:
        """Cache pytree matching the stacked layer layout: k/v
        (num_units, B, S_max, G, hd), index (num_units,).

        For sliding-window mode the per-layer buffer is window-sized
        (ring buffer)."""
        cfg = self.cfg
        s_max = (
            min(max_len, self.sliding_window)
            if self.sliding_window is not None else max_len
        )
        c = KVCache.zeros(batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim,
                          dtype, self.device)
        n = self.num_units
        return {"block0": KVCache(
            k=c.k.expand(n, *c.k.shape).contiguous(),
            v=c.v.expand(n, *c.v.shape).contiguous(),
            index=torch.zeros((n,), dtype=torch.int32, device=self.device),
        )}

    def prefill_into_cache(self, params, tokens, cache):
        """(Simplified) sequential prefill is exercised via decode_step;
        benchmark prefill uses ``forward``."""
        raise NotImplementedError

    def decode_step(
        self,
        params: PyTree,
        tokens: torch.Tensor,                          # (B, 1)
        cache: PyTree,
        position: Union[int, torch.Tensor],            # absolute position
    ) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence against the cache; writes the cache's
        buffers in place and returns it with its indices advanced."""
        tokens = tokens.to(self.device)
        x = nn.apply_embedding(params["embed"], tokens, self.dtype)
        b = x.shape[0]
        if isinstance(position, torch.Tensor):
            positions = position.to(x.device).long().reshape(1, 1).expand(b, 1)
        else:       # a fill, not a host-to-device copy, on every step
            positions = torch.full((b, 1), int(position), device=x.device)
        layers, stacked = params["layers"]["block0"], cache["block0"]
        indices = []
        for i in range(self.num_units):
            cu = KVCache(k=stacked.k[i], v=stacked.v[i], index=stacked.index[i])
            x, nc = self._apply_block(tree_map(lambda p: p[i], layers), x, positions,
                                      cache=cu, window=self.sliding_window)
            indices.append(nc.index)
        new_cache = {"block0": KVCache(k=stacked.k, v=stacked.v,
                                       index=torch.stack(indices))}
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), new_cache
