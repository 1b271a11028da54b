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
``convert.params_from_numpy`` unchanged.  With ``cfg.remat`` and grad
mode on, each Mamba block is recomputed in the backward pass, as the
reference checkpoints them (its shared block is not); the shared
block's gradient sums over its uses.  The model runs on CUDA unless
the caller asks for the CPU; ``init(rng)`` draws on the generator's
device.  ``decode_step`` writes the SSM states and the keys and values
into the cache's buffers in place.

``Zamba2SharedBlocksModel`` is the published Zamba2 layout
[arXiv:2411.15242; Hugging Face ``modeling_zamba2.py``], which the JAX
package lacks; ``build_model`` takes it for a configuration with
``hybrid_layer_ids`` (``configs/extended.py``, e.g. zamba2-7b).  Before
each of those Mamba layers one of ``num_mem_blocks`` shared transformer
blocks runs (use j takes block j % num_mem_blocks) on RMSNorm(concat(x,
emb)), emb the embedding output: attention (no residual), RMSNorm, a GLU
MLP whose gate and up product take the use's own low-rank adapter, and
the use's own linear, giving t; that layer's Mamba block then computes
x + mixer(RMSNorm(x + t)).  Layout: ``mamba`` (L, ...) stacked Mamba
blocks, ``shared`` (num_mem_blocks, ...) and ``uses`` (one per hybrid
layer: ``adapter`` down (D, r), up (r, 2 d_ff); ``linear`` (D, D)).  A
KV cache per use.  Spans: ``hybrid.shared`` (attrs ``use``, ``block``)
around ``hybrid.attn``, ``hybrid.mlp``, ``hybrid.linear``; ``mamba.block``
on every Mamba layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.extended import hybrid_layer_ids, rms_norm_eps
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
from repro_torch.models.mamba2 import (
    MambaCache,
    apply_mamba_block,
    decode_mamba_stack,
    init_mamba_block,
    stacked_mamba_cache,
)
from repro_torch.models.transformer import _attn_cfg
from repro_torch.profiling import span
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

    def _mamba_block(self, x, bp):
        return apply_mamba_block(bp, x, self.cfg, ssd_impl=self.ssd_impl)[0]

    def _mamba_stack(self, layers, x):
        for i in range(layers["A_log"].shape[0]):
            x = nn.remat(self.cfg.remat, self._mamba_block, x,
                         tree_map(lambda p: p[i], layers))
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


class Zamba2SharedBlocksModel:
    """The published Zamba2 layout (module docstring)."""

    _lm_head = Zamba2Model._lm_head

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "xla", ssd_impl: str = "xla",
                 sliding_window: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None, **_):
        assert cfg.ssm is not None and hybrid_layer_ids(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.sliding_window = sliding_window
        self.device = resolve_device(device)
        self.eps = rms_norm_eps(cfg)
        self.uses = {layer: j for j, layer in enumerate(hybrid_layer_ids(cfg))}
        self.n_attn_uses = len(self.uses)
        # the published block: rotate-half RoPE, and the scores scaled by
        # (head_dim / 2) ** -0.5, its head_dim being 2 d_model / num_heads
        self.acfg = AttentionConfig(
            d_model=2 * cfg.d_model, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            sliding_window=sliding_window, logit_soft_cap=cfg.logit_soft_cap,
            rope_half=True, scale=(cfg.resolved_head_dim / 2) ** -0.5)

    def init(self, rng: torch.Generator) -> PyTree:
        """float32 parameters, drawn on ``rng``'s device and placed on
        the model's, the stacks filled one entry at a time."""
        cfg = self.cfg
        dev = self.device
        d, r = cfg.d_model, cfg.adapter_rank

        def shared(g):
            attn = init_attention(g, self.acfg)
            h, hd = cfg.num_heads, cfg.resolved_head_dim        # o: 2D-wide input, D out
            attn["wo"] = torch.randn((h, hd, d), generator=g, device=g.device) \
                * (1.0 / math.sqrt(h * hd))
            return {"ln_attn": nn.init_rmsnorm(2 * d), "attn": attn,
                    "ln_ffn": nn.init_rmsnorm(d), "ffn": init_glu_ffn(g, d, cfg.d_ff)}

        def use(g):
            def draw(shape, scale):
                return torch.randn(shape, generator=g, device=g.device) * scale
            return {"adapter": {"down": draw((d, r), 1.0 / math.sqrt(d)),
                                "up": draw((r, 2 * cfg.d_ff), 1.0 / math.sqrt(r))},
                    "linear": draw((d, d), 1.0 / math.sqrt(d))}

        params = {
            "embed": tree_map(lambda p: p.to(dev),
                              nn.init_embedding(rng, cfg.vocab_size, d)),
            "mamba": nn.init_stacked(rng, lambda g: init_mamba_block(g, cfg),
                                     cfg.num_layers, dev),
            "shared": nn.init_stacked(rng, shared, cfg.num_mem_blocks, dev),
            "uses": nn.init_stacked(rng, use, self.n_attn_uses, dev),
            "ln_final": tree_map(lambda p: p.to(dev), nn.init_rmsnorm(d)),
        }
        if not cfg.tie_embeddings:
            w = torch.randn((d, cfg.vocab_size), generator=rng,
                            device=rng.device) * (1.0 / math.sqrt(d))
            params["lm_head"] = {"w": w.to(dev)}
        return params

    def _shared(self, params, use, x, emb, positions, cache=None):
        """Shared block ``use % num_mem_blocks`` at its ``use``: t (B, S, D)
        and the use's new KV cache."""
        block = use % self.cfg.num_mem_blocks
        sp = tree_map(lambda p: p[block], params["shared"])
        up = tree_map(lambda p: p[use], params["uses"])
        with span("hybrid.shared", use=use, block=block):
            with span("hybrid.attn"):
                h = nn.apply_rmsnorm(sp["ln_attn"], torch.cat([x, emb], dim=-1), self.eps)
                a, nc = apply_attention(sp["attn"], h, self.acfg, positions=positions,
                                        cache=cache, attn_impl=self.attn_impl)
            with span("hybrid.mlp"):
                h = nn.apply_rmsnorm(sp["ln_ffn"], a, self.eps)
                t = apply_glu_ffn(sp["ffn"], h, self.cfg.activation, up["adapter"])
            with span("hybrid.linear"):
                t = t @ up["linear"].to(t.dtype)
        return t, nc

    def _layer(self, x, bp, layer, addend):
        with span("mamba.block", layer=layer):
            return apply_mamba_block(bp, x, self.cfg, ssd_impl=self.ssd_impl,
                                     addend=addend)[0]

    def forward(self, params, tokens, extra_embeds=None, last_only=False):
        """tokens: (B, S) -> (logits (B, S, V), aux_loss 0.0); with
        ``last_only`` the logits of the final position only."""
        if extra_embeds is not None:
            raise NotImplementedError("Zamba2SharedBlocksModel takes no extra_embeds")
        x = emb = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for i in range(self.cfg.num_layers):
            t = None
            if i in self.uses:
                t, _ = self._shared(params, self.uses[i], x, emb, positions)
            x = nn.remat(self.cfg.remat, self._layer, x,
                         tree_map(lambda p: p[i], params["mamba"]), i, t)
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x, self.eps)
        return self._lm_head(params, x), 0.0

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        """{"mamba": MambaCache (L, ...), "attn": KVCache (uses, ...)}; the
        attention buffers are window-sized in sliding-window mode."""
        cfg = self.cfg
        s_max = (min(max_len, self.sliding_window)
                 if self.sliding_window is not None else max_len)
        c = KVCache.zeros(batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim,
                          dtype, self.device)
        n = self.n_attn_uses
        return {"mamba": stacked_mamba_cache(cfg, batch, (cfg.num_layers,), self.device),
                "attn": KVCache(k=c.k.expand(n, *c.k.shape).contiguous(),
                                v=c.v.expand(n, *c.v.shape).contiguous(),
                                index=torch.zeros((n,), dtype=torch.int32, device=self.device))}

    def decode_step(self, params, tokens, cache, position):
        """One token per sequence (B, 1) against the cache ->
        (logits (B, 1, V), new cache)."""
        cfg = self.cfg
        x = emb = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        b = x.shape[0]
        if isinstance(position, torch.Tensor):
            positions = position.to(x.device).long().reshape(1, 1).expand(b, 1)
        else:
            positions = torch.full((b, 1), int(position), device=x.device)
        mc, attn = cache["mamba"], cache["attn"]
        convs, indices = [], []
        for i in range(cfg.num_layers):
            extra = {}
            if i in self.uses:
                j = self.uses[i]
                kv = KVCache(k=attn.k[j], v=attn.v[j], index=attn.index[j])
                extra["addend"], nkv = self._shared(params, j, x, emb, positions, cache=kv)
                indices.append(nkv.index)
            x, nc = apply_mamba_block(tree_map(lambda p: p[i], params["mamba"]), x, cfg,
                                      cache=MambaCache(conv=mc.conv[i], ssm=mc.ssm[i]), **extra)
            mc.ssm[i].copy_(nc.ssm)
            convs.append(nc.conv)
        new_cache = {"mamba": MambaCache(conv=torch.stack(convs), ssm=mc.ssm),
                     "attn": KVCache(k=attn.k, v=attn.v, index=torch.stack(indices))}
        x = nn.apply_rmsnorm(params["ln_final"], x, self.eps)
        return self._lm_head(params, x), new_cache
