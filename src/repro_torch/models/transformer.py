"""Decoder-only and encoder-decoder transformers of the LLM zoo (the
dense, moe, vlm and audio families).

The counterpart of ``src/repro/models/transformer.py``: pre-norm blocks,
GQA attention (``repro_torch.models.layers``), SwiGLU/GeGLU FFN or MoE
FFN (``repro_torch.models.moe``), RMSNorm, RoPE, an optional tied LM
head.

The parameter pytree keeps the reference's stacked layout: a unit is
``moe_every`` consecutive blocks ``block0 … block{u-1}``, the last of
which is MoE when ``cfg.moe`` is set (dense: one block), and every leaf
of ``params["layers"]`` has a leading ``num_units`` axis, as the
reference's ``jax.vmap`` init gives, so reference weights carry across
with ``convert.params_from_numpy`` unchanged.  The layers are applied in
a Python loop over units (``scan_layers`` changes nothing); with
``cfg.remat`` and grad mode on, each unit is recomputed in the backward
pass (``nn.remat``), as the reference wraps each unit in
``jax.checkpoint``.  MoE's load-balance loss is summed over units.

Entry points of ``Transformer``:
  * ``forward(params, tokens, extra_embeds=None, last_only=...)`` — the
    full sequence (training, prefill); ``extra_embeds`` (B, P, D) are the
    VLM stub's patch embeddings, prepended (early fusion)
  * ``init_cache(batch, max_len)``             — decode cache pytree
  * ``decode_step(params, tokens, cache, position)`` — one-token serve
    step, text only as the reference's
``EncoderDecoder`` (the audio family) encodes stubbed frame embeddings
with bidirectional self-attention and decodes with causal self-attention
and cross-attention over the encoder's memory; its ``init_cache`` encodes
once and keeps each decoder block's cross keys and values.

Models run on CUDA unless the caller asks for the CPU (``device="cpu"``);
without a card the default raises.  ``init(rng, dtype)`` draws on the
generator's device — at full width a CPU draw would take tens of GB of
host memory and minutes, so draw on the card — and stores each leaf in
``dtype`` (default float32, the reference's) before the next is drawn,
so a full-width bfloat16 tree never has a float32 copy: the peak is the
tree plus one float32 leaf.  Decode writes the caches' buffers in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models.layers import (
    AttentionConfig,
    KVCache,
    _normal,
    apply_attention,
    apply_cross_attention,
    apply_glu_ffn,
    encode_memory_kv,
    init_attention,
    init_glu_ffn,
)
from repro_torch.models.moe import apply_moe, init_moe
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


def _decode_positions(x: torch.Tensor, position: Union[int, torch.Tensor]) -> torch.Tensor:
    b = x.shape[0]
    if isinstance(position, torch.Tensor):
        return position.to(x.device).long().reshape(1, 1).expand(b, 1)
    return torch.full((b, 1), int(position), device=x.device)   # a fill, not a copy


def _unit(layers: PyTree, i: int) -> PyTree:
    return tree_map(lambda p: p[i], layers)


def _stacked_caches(names, num_units: int, batch: int, s_max: int, cfg: ArchConfig,
                    dtype: torch.dtype, device: torch.device) -> Dict[str, KVCache]:
    """One KVCache per block name: k/v (num_units, B, S_max, G, hd),
    index (num_units,)."""
    shape = (num_units, batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {name: KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        index=torch.zeros((num_units,), dtype=torch.int32, device=device),
    ) for name in names}


def _unit_caches(caches: Dict[str, KVCache], i: int) -> Dict[str, KVCache]:
    return {name: KVCache(k=c.k[i], v=c.v[i], index=c.index[i]) for name, c in caches.items()}


class Transformer:
    """Decoder-only transformer (dense or MoE); also hosts the VLM stub."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.bfloat16,
                 sliding_window: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.sliding_window = sliding_window
        self.device = resolve_device(device)
        if cfg.moe is not None:
            if cfg.num_layers % cfg.moe_every:
                raise ValueError(f"{cfg.name}: num_layers must divide by moe_every")
            self.unit_size = cfg.moe_every
            self.num_units = cfg.num_layers // cfg.moe_every
        else:
            self.unit_size = 1
            self.num_units = cfg.num_layers
        self.block_names = [f"block{i}" for i in range(self.unit_size)]

    # --- init -------------------------------------------------------------------
    def _init_block(self, rng: torch.Generator, moe: bool, dtype: torch.dtype) -> Dict:
        cfg = self.cfg
        block = {
            "ln_attn": nn.init_rmsnorm(cfg.d_model, dtype),
            "attn": init_attention(rng, _attn_cfg(cfg), dtype),
            "ln_ffn": nn.init_rmsnorm(cfg.d_model, dtype),
        }
        if moe:
            block["moe"] = init_moe(rng, cfg.d_model, cfg.moe, dtype)
        else:
            block["ffn"] = init_glu_ffn(rng, cfg.d_model, cfg.d_ff, dtype)
        return block

    def _init_unit(self, rng: torch.Generator, dtype: torch.dtype = torch.float32) -> Dict:
        last = self.unit_size - 1
        return {name: self._init_block(rng, self.cfg.moe is not None and i == last, dtype)
                for i, name in enumerate(self.block_names)}

    def init(self, rng: torch.Generator, dtype: torch.dtype = torch.float32) -> PyTree:
        """Parameters stored in ``dtype``, drawn on ``rng``'s device and
        placed on the model's.  The layer stack is filled one unit at a
        time, so the peak is the stack plus one unit."""
        cfg = self.cfg
        dev = self.device
        params = {
            "embed": tree_map(lambda p: p.to(dev),
                              nn.init_embedding(rng, cfg.vocab_size, cfg.d_model, dtype)),
            "layers": nn.init_stacked(rng, lambda r: self._init_unit(r, dtype),
                                      self.num_units, dev),
            "ln_final": tree_map(lambda p: p.to(dev), nn.init_rmsnorm(cfg.d_model, dtype)),
        }
        if not cfg.tie_embeddings:
            w = _normal(rng, (cfg.d_model, cfg.vocab_size), 1.0 / cfg.d_model ** 0.5, dtype)
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
        if "moe" in bp:
            ffn_out, aux = apply_moe(bp["moe"], h, cfg.moe, cfg.activation)
        else:
            ffn_out, aux = apply_glu_ffn(bp["ffn"], h, cfg.activation), 0.0
        return x + ffn_out, new_cache, aux

    def _apply_unit(self, up: Dict, x, positions, caches=None, window=None):
        """The unit's blocks in order: (x, new caches by block or None,
        the unit's aux loss)."""
        new_caches = {}
        aux_total = 0.0
        for name in self.block_names:
            c = caches[name] if caches is not None else None
            x, nc, aux = self._apply_block(up[name], x, positions, cache=c, window=window)
            aux_total = aux_total + aux
            if nc is not None:
                new_caches[name] = nc
        return x, (new_caches if caches is not None else None), aux_total

    # --- forward (train / prefill) --------------------------------------------------
    def forward(
        self,
        params: PyTree,
        tokens: torch.Tensor,
        extra_embeds: Optional[torch.Tensor] = None,
        last_only: bool = False,
    ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
        """tokens: (B, S) -> (logits (B, S_total, V), aux_loss).

        extra_embeds (B, P, D): VLM patch embeddings, cast to the model's
        dtype and prepended (early fusion); positions run over P + S and
        the logits cover the fused sequence.  aux_loss: MoE's
        load-balance loss summed over units (float32), 0.0 without MoE.
        last_only: compute logits for the final position only (prefill
        serving path — avoids materializing the (B, S, V) tensor).
        """
        tokens = tokens.to(self.device)
        x = nn.apply_embedding(params["embed"], tokens, self.dtype)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(device=self.device, dtype=self.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        def unit(x, up):
            y, _, aux = self._apply_unit(up, x, positions, window=self.sliding_window)
            return y, aux

        aux = 0.0
        for i in range(self.num_units):
            x, a = nn.remat(self.cfg.remat, unit, x, _unit(params["layers"], i))
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), aux

    def _lm_head(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].to(x.dtype).T
        return x @ params["lm_head"]["w"].to(x.dtype)

    # --- decode ------------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> PyTree:
        """Cache pytree matching the stacked layer layout, one KVCache
        per block of a unit: k/v (num_units, B, S_max, G, hd), index
        (num_units,).

        For sliding-window mode the per-layer buffer is window-sized
        (ring buffer)."""
        s_max = (
            min(max_len, self.sliding_window)
            if self.sliding_window is not None else max_len
        )
        return _stacked_caches(self.block_names, self.num_units, batch, s_max, self.cfg,
                               dtype, self.device)

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
        positions = _decode_positions(x, position)
        indices = {name: [] for name in cache}
        for i in range(self.num_units):
            x, ncs, _ = self._apply_unit(_unit(params["layers"], i), x, positions,
                                         caches=_unit_caches(cache, i),
                                         window=self.sliding_window)
            for name, nc in ncs.items():
                indices[name].append(nc.index)
        new_cache = {name: KVCache(k=c.k, v=c.v, index=torch.stack(indices[name]))
                     for name, c in cache.items()}
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return self._lm_head(params, x), new_cache


# --- encoder-decoder (audio: seamless-m4t) ------------------------------------------------
class EncDecCache(NamedTuple):
    self_cache: PyTree          # one KVCache per decoder block name, stacked over units
    cross_kv: PyTree            # per decoder block name: (k, v) (num_units, B, S_enc, G, hd)


class EncoderDecoder:
    """Enc-dec transformer; the audio frontend is stubbed to frame
    embeddings (B, S_enc, D) per the multimodal carve-out.

    The encoder's bidirectional self-attention and the decoder's causal
    self-attention in ``forward`` run as ``attn_impl`` (the flash kernel
    with "pallas"); decode's self-attention takes the cache path and
    cross-attention the plain product, as in the reference."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.bfloat16,
                 sliding_window: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: EncoderDecoder needs cfg.encoder")
        self.cfg = cfg
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.sliding_window = sliding_window
        self.dec = Transformer(cfg, attn_impl=attn_impl, dtype=dtype,
                               sliding_window=sliding_window, device=device)
        self.device = self.dec.device

    # --- init -------------------------------------------------------------------
    def _init_enc_block(self, rng: torch.Generator, dtype: torch.dtype) -> Dict:
        cfg = self.cfg
        return {
            "ln_attn": nn.init_rmsnorm(cfg.d_model, dtype),
            "attn": init_attention(rng, _attn_cfg(cfg, causal=False), dtype),
            "ln_ffn": nn.init_rmsnorm(cfg.d_model, dtype),
            "ffn": init_glu_ffn(rng, cfg.d_model, cfg.d_ff, dtype),
        }

    def _init_dec_unit(self, rng: torch.Generator, dtype: torch.dtype) -> Dict:
        cfg = self.cfg
        unit = self.dec._init_unit(rng, dtype)
        for name in self.dec.block_names:
            unit[name]["ln_cross"] = nn.init_rmsnorm(cfg.d_model, dtype)
            unit[name]["cross"] = init_attention(rng, _attn_cfg(cfg), dtype)
        return unit

    def init(self, rng: torch.Generator, dtype: torch.dtype = torch.float32) -> PyTree:
        """Parameters stored in ``dtype``, drawn on ``rng``'s device and
        placed on the model's, the stacks filled one layer at a time."""
        cfg = self.cfg
        dev = self.device

        def to_dev(tree):
            return tree_map(lambda p: p.to(dev), tree)

        params = {
            "embed": to_dev(nn.init_embedding(rng, cfg.vocab_size, cfg.d_model, dtype)),
            "enc_layers": nn.init_stacked(rng, lambda r: self._init_enc_block(r, dtype),
                                          cfg.encoder.num_layers, dev),
            "ln_enc": to_dev(nn.init_rmsnorm(cfg.d_model, dtype)),
            "dec_layers": nn.init_stacked(rng, lambda r: self._init_dec_unit(r, dtype),
                                          self.dec.num_units, dev),
            "ln_final": to_dev(nn.init_rmsnorm(cfg.d_model, dtype)),
        }
        w = _normal(rng, (cfg.d_model, cfg.vocab_size), 1.0 / cfg.d_model ** 0.5, dtype)
        params["lm_head"] = {"w": w.to(dev)}
        return params

    # --- encoder ----------------------------------------------------------------------
    def encode(self, params, source_embeds: torch.Tensor) -> torch.Tensor:
        """source_embeds: stubbed frames (B, S_enc, D) -> memory (B, S_enc, D)."""
        cfg = self.cfg
        x = source_embeds.to(device=self.device, dtype=self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        acfg = _attn_cfg(cfg, causal=False)

        def block(x, bp):
            h = nn.apply_rmsnorm(bp["ln_attn"], x)
            a, _ = apply_attention(bp["attn"], h, acfg, positions=positions,
                                   attn_impl=self.attn_impl)
            x = x + a
            h = nn.apply_rmsnorm(bp["ln_ffn"], x)
            return x + apply_glu_ffn(bp["ffn"], h, cfg.activation)

        for i in range(cfg.encoder.num_layers):
            x = nn.remat(cfg.remat, block, x, _unit(params["enc_layers"], i))
        return nn.apply_rmsnorm(params["ln_enc"], x)

    # --- decoder ----------------------------------------------------------------------
    def _dec_unit(self, up, x, positions, memory_or_kv, caches=None,
                  precomputed_kv: bool = False):
        cfg = self.cfg
        acfg = _attn_cfg(cfg, sliding_window=self.sliding_window)
        new_caches = {}
        for name in self.dec.block_names:
            bp = up[name]
            h = nn.apply_rmsnorm(bp["ln_attn"], x)
            c = caches[name] if caches is not None else None
            a, nc = apply_attention(bp["attn"], h, acfg, positions=positions,
                                    cache=c, attn_impl=self.attn_impl)
            x = x + a
            if nc is not None:
                new_caches[name] = nc
            h = nn.apply_rmsnorm(bp["ln_cross"], x)
            kv = (memory_or_kv[name] if precomputed_kv
                  else encode_memory_kv(bp["cross"], memory_or_kv, acfg))
            x = x + apply_cross_attention(bp["cross"], h, kv, acfg)
            h = nn.apply_rmsnorm(bp["ln_ffn"], x)
            x = x + apply_glu_ffn(bp["ffn"], h, cfg.activation)
        return x, (new_caches if caches is not None else None)

    def forward(self, params, tokens, source_embeds, last_only: bool = False):
        """Teacher-forced forward: (B, S_dec) tokens + (B, S_enc, D)
        frames -> (logits (B, S_dec, V), 0.0)."""
        memory = self.encode(params, source_embeds)
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        def unit(x, up):
            return self._dec_unit(up, x, positions, memory)[0]

        for i in range(self.dec.num_units):
            x = nn.remat(self.cfg.remat, unit, x, _unit(params["dec_layers"], i))
        if last_only:
            x = x[:, -1:]
        x = nn.apply_rmsnorm(params["ln_final"], x)
        return x @ params["lm_head"]["w"].to(x.dtype), 0.0

    def init_cache(self, params, source_embeds: torch.Tensor, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> EncDecCache:
        """Encode once; precompute every decoder block's cross K/V,
        stacked over units; allocate the self-attention cache."""
        cfg = self.cfg
        memory = self.encode(params, source_embeds)
        acfg = _attn_cfg(cfg)
        kvs = {name: ([], []) for name in self.dec.block_names}
        for i in range(self.dec.num_units):
            up = _unit(params["dec_layers"], i)
            for name in self.dec.block_names:
                k, v = encode_memory_kv(up[name]["cross"], memory, acfg)
                kvs[name][0].append(k)
                kvs[name][1].append(v)
        cross_kv = {name: (torch.stack(ks), torch.stack(vs)) for name, (ks, vs) in kvs.items()}
        s_max = (
            min(max_len, self.sliding_window)
            if self.sliding_window is not None else max_len
        )
        self_cache = _stacked_caches(self.dec.block_names, self.dec.num_units,
                                     source_embeds.shape[0], s_max, cfg, dtype, self.device)
        return EncDecCache(self_cache=self_cache, cross_kv=cross_kv)

    def decode_step(self, params, tokens, cache: EncDecCache,
                    position: Union[int, torch.Tensor]):
        """One token per sequence (B, 1) against the cache -> (logits
        (B, 1, V), new cache); the self cache's buffers are written in
        place."""
        x = nn.apply_embedding(params["embed"], tokens.to(self.device), self.dtype)
        positions = _decode_positions(x, position)
        self_cache = cache.self_cache
        indices = {name: [] for name in self_cache}
        for i in range(self.dec.num_units):
            kv = {name: (k[i], v[i]) for name, (k, v) in cache.cross_kv.items()}
            x, ncs = self._dec_unit(_unit(params["dec_layers"], i), x, positions, kv,
                                    caches=_unit_caches(self_cache, i), precomputed_kv=True)
            for name, nc in ncs.items():
                indices[name].append(nc.index)
        new_self = {name: KVCache(k=c.k, v=c.v, index=torch.stack(indices[name]))
                    for name, c in self_cache.items()}
        x = nn.apply_rmsnorm(params["ln_final"], x)
        logits = x @ params["lm_head"]["w"].to(x.dtype)
        return logits, EncDecCache(self_cache=new_self, cross_kv=cache.cross_kv)
