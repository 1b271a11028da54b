"""Zamba2-style hybrid: Mamba2 backbone + a SHARED attention block
[arXiv:2411.15242].

The counterpart of ``src/repro/models/hybrid.py``.  One set of
transformer-block weights (attention + MLP) is re-applied at several
depths (every ``hybrid_attn_every`` Mamba layers).  Weights are shared;
activations are not — each application gets its own KV cache slot
during decode.

Layout for L mamba layers with interval g:
  [g mamba] -> shared attn -> [g mamba] -> shared attn -> ... -> remainder

The parameter pytree keeps the reference's two-level stacked layout
(``mamba_full`` leaves lead with ``(n_full, group)``, ``mamba_rem`` with
``(rem,)``), so reference weights carry across with
``convert.params_from_numpy`` unchanged.  The model runs on CUDA unless
the caller asks for the CPU; ``init(rng)`` draws on the generator's
device.  ``decode_step`` writes the SSM states and the keys and values
into the cache's buffers in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models.layers import (
    KVCache,
    apply_attention,
    apply_glu_ffn,
    init_attention,
    init_glu_ffn,
)
from repro_torch.models.mamba2 import (
    MambaCache,
    apply_mamba_block,
    decode_mamba_stack,
    init_mamba_block,
    stacked_mamba_cache,
)
from repro_torch.models.transformer import _attn_cfg
from repro_torch.tree import tree_map

PyTree = Any


class HybridCache(NamedTuple):
    mamba: PyTree            # stacked MambaCache (L, ...)
    attn: PyTree             # list-stacked KVCache per shared-block use


class Zamba2Model:
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "xla", ssd_impl: str = "xla",
                 sliding_window: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None, **_):
        assert cfg.ssm is not None
        self.cfg = cfg
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.sliding_window = sliding_window
        self.device = resolve_device(device)
        g = cfg.hybrid_attn_every
        self.group = g
        self.n_full = cfg.num_layers // g
        self.rem = cfg.num_layers % g
        self.n_attn_uses = self.n_full + (1 if self.rem else 0)

    def init(self, rng: torch.Generator) -> PyTree:
        """float32 parameters, drawn on ``rng``'s device and placed on
        the model's, the Mamba stacks filled one block at a time."""
        cfg = self.cfg
        dev = self.device

        def block(r):
            return init_mamba_block(r, cfg)

        def to_dev(tree):
            return tree_map(lambda p: p.to(dev), tree)

        params = {
            "embed": to_dev(nn.init_embedding(rng, cfg.vocab_size, cfg.d_model)),
            # (n_full, group, ...) stacked mamba blocks
            "mamba_full": nn.init_stacked(
                rng, lambda r: nn.init_stacked(r, block, self.group, dev), self.n_full, dev),
            # one SHARED transformer block
            "shared_attn": to_dev({
                "ln_attn": nn.init_rmsnorm(cfg.d_model),
                "attn": init_attention(rng, _attn_cfg(cfg)),
                "ln_ffn": nn.init_rmsnorm(cfg.d_model),
                "ffn": init_glu_ffn(rng, cfg.d_model, cfg.d_ff),
            }),
            "ln_final": to_dev(nn.init_rmsnorm(cfg.d_model)),
        }
        if self.rem:
            params["mamba_rem"] = nn.init_stacked(rng, block, self.rem, dev)
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab_size), generator=rng,
                            device=rng.device) * (1.0 / math.sqrt(cfg.d_model))
            params["lm_head"] = {"w": w.to(dev)}
        return params

    def _shared_attn(self, sp, x, positions, cache=None):
        acfg = _attn_cfg(self.cfg, sliding_window=self.sliding_window)
        h = nn.apply_rmsnorm(sp["ln_attn"], x)
        a, nc = apply_attention(sp["attn"], h, acfg, positions=positions,
                                cache=cache, attn_impl=self.attn_impl)
        x = x + a
        h = nn.apply_rmsnorm(sp["ln_ffn"], x)
        return x + apply_glu_ffn(sp["ffn"], h, self.cfg.activation), nc

    def _mamba_stack(self, layers, x):
        for i in range(layers["A_log"].shape[0]):
            x, _ = apply_mamba_block(tree_map(lambda p: p[i], layers), x, self.cfg,
                                     ssd_impl=self.ssd_impl)
        return x

    def forward(self, params, tokens, extra_embeds=None, last_only=False):
        """tokens: (B, S) -> (logits (B, S, V), aux_loss 0.0); with
        ``last_only`` the logits of the final position only."""
        if extra_embeds is not None:
            raise NotImplementedError("Zamba2Model takes no extra_embeds")
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for gi in range(self.n_full):
            x = self._mamba_stack(tree_map(lambda p: p[gi], params["mamba_full"]), x)
            x, _ = self._shared_attn(params["shared_attn"], x, positions)
        if self.rem:
            x = self._mamba_stack(params["mamba_rem"], x)
            x, _ = self._shared_attn(params["shared_attn"], x, positions)
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), 0.0

    def _lm_head(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].to(x.dtype).T
        return x @ params["lm_head"]["w"].to(x.dtype)

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        """{"mamba_full": MambaCache (n_full, group, ...), "mamba_rem":
        MambaCache (rem, ...), "attn": KVCache (n_attn_uses, ...)}; the
        attention buffers are window-sized in sliding-window mode."""
        cfg = self.cfg
        s_max = (
            min(max_len, self.sliding_window)
            if self.sliding_window is not None else max_len
        )
        caches: Dict[str, Any] = {"mamba_full": stacked_mamba_cache(
            cfg, batch, (self.n_full, self.group), self.device)}
        if self.rem:
            caches["mamba_rem"] = stacked_mamba_cache(cfg, batch, (self.rem,), self.device)
        c = KVCache.zeros(batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim,
                          dtype, self.device)
        n = self.n_attn_uses
        caches["attn"] = KVCache(
            k=c.k.expand(n, *c.k.shape).contiguous(),
            v=c.v.expand(n, *c.v.shape).contiguous(),
            index=torch.zeros((n,), dtype=torch.int32, device=self.device),
        )
        return caches

    def decode_step(self, params, tokens, cache, position):
        """One token per sequence (B, 1) against the cache ->
        (logits (B, 1, V), new cache)."""
        cfg = self.cfg
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        b = x.shape[0]
        if isinstance(position, torch.Tensor):
            positions = position.to(x.device).long().reshape(1, 1).expand(b, 1)
        else:       # a fill, not a host-to-device copy, on every step
            positions = torch.full((b, 1), int(position), device=x.device)
        attn = cache["attn"]
        indices = []

        def shared(x, use):
            cu = KVCache(k=attn.k[use], v=attn.v[use], index=attn.index[use])
            x, nac = self._shared_attn(params["shared_attn"], x, positions, cache=cu)
            indices.append(nac.index)
            return x

        full = cache["mamba_full"]
        convs = []
        for gi in range(self.n_full):
            x, nmc = decode_mamba_stack(
                tree_map(lambda p: p[gi], params["mamba_full"]),
                MambaCache(conv=full.conv[gi], ssm=full.ssm[gi]), x, cfg)
            convs.append(nmc.conv)
            x = shared(x, gi)
        new_cache: Dict[str, Any] = {
            "mamba_full": MambaCache(conv=torch.stack(convs), ssm=full.ssm)}
        if self.rem:
            x, new_cache["mamba_rem"] = decode_mamba_stack(
                params["mamba_rem"], cache["mamba_rem"], x, cfg)
            x = shared(x, self.n_full)
        new_cache["attn"] = KVCache(k=attn.k, v=attn.v, index=torch.stack(indices))
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), new_cache
