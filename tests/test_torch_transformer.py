"""The port's LLM layers, transformer and serving steps against the JAX
package, on the CPU.

Weights come from the reference's own ``init`` and are carried across
with ``convert.params_from_numpy``; inputs are numpy arrays from a seed.
float32 throughout, except one bfloat16 forward per architecture.
Tolerances: 1e-5 for single layers, 1e-4 for whole models and the
serving loop (float32, summation order only), 3e-2 in bfloat16 (the
reference's own, ``tests/test_archs.py``).  ``attn_impl="pallas"`` runs
the reference's Pallas kernel in interpret mode and the port's plain
version of its CUDA kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as ref_layers
from repro.models import nn as ref_nn
from repro.train.steps import make_serve_step as ref_make_serve_step
from repro_torch.configs import ARCH_IDS, build_model, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers, nn
from repro_torch.train.steps import make_greedy_decode, make_prefill_step, make_serve_step

F32 = 1e-5


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_cfgs(window=None, cap=None):
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
              sliding_window=window, logit_soft_cap=cap)
    return ref_layers.AttentionConfig(**kw), layers.AttentionConfig(**kw)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 24, 4, 32)
    pos = np.stack([np.arange(24), np.arange(100, 124)]).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, F32)
    cos, sin = layers.rope_frequencies(32, 16)
    rcos, rsin = ref_layers.rope_frequencies(32, 16)
    _close(cos, rcos, F32)
    _close(sin, rsin, F32)


@pytest.mark.parametrize("window,cap", [(None, None), (16, None), (None, 20.0)])
def test_attention_scores_and_chunked_match_reference(window, cap):
    rng = np.random.default_rng(1)
    b, s, h, g, d = 2, 64, 4, 2, 32
    q, k, v = _randn(rng, b, s, h, d), _randn(rng, b, s, g, d), _randn(rng, b, s, g, d)
    pos = np.broadcast_to(np.arange(s), (b, s))
    ref_mask = ref_layers._attn_mask(jnp.asarray(pos), jnp.asarray(pos), True, window)
    mask = layers._attn_mask(torch.from_numpy(pos.copy()), torch.from_numpy(pos.copy()),
                             True, window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = ref_layers.attention_scores(jq, jk, jv, ref_mask, h // g, cap)
    _close(layers.attention_scores(tq, tk, tv, mask, h // g, cap), want, F32)
    want_c = ref_layers.chunked_attention(jq, jk, jv, h // g, True, window, cap,
                                          q_chunk=16, k_chunk=32)
    got_c = layers.chunked_attention(tq, tk, tv, h // g, True, window, cap,
                                     q_chunk=16, k_chunk=32)
    _close(got_c, want_c, F32)
    _close(got_c, want, 2e-5)     # chunked vs dense: the reference's tolerance


@pytest.mark.parametrize("attn_impl", ["xla", "pallas", "chunked"])
@pytest.mark.parametrize("window", [None, 32])
def test_apply_attention_matches_reference(attn_impl, window):
    ref_cfg, cfg = _attn_cfgs(window)
    rp = ref_layers.init_attention(jax.random.PRNGKey(2), ref_cfg)
    x = _randn(np.random.default_rng(2), 2, 128, 64)
    want, _ = ref_layers.apply_attention(rp, jnp.asarray(x), ref_cfg, attn_impl=attn_impl)
    got, cache = layers.apply_attention(_port(rp), torch.from_numpy(x), cfg,
                                        attn_impl=attn_impl)
    assert cache is None
    _close(got, want, 1e-4)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_reference(window):
    """Ten single-token steps against a cache (a ring buffer of 4 slots
    with the window, so it wraps twice): outputs and cache contents."""
    ref_cfg, cfg = _attn_cfgs(window)
    rp = ref_layers.init_attention(jax.random.PRNGKey(3), ref_cfg)
    pp = _port(rp)
    steps, b = 10, 2
    s_max = window or steps
    xs = _randn(np.random.default_rng(3), steps, b, 1, 64)
    rc = ref_layers.KVCache.zeros(b, s_max, 2, 32, jnp.float32)
    pc = layers.KVCache.zeros(b, s_max, 2, 32, torch.float32, "cpu")
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        want, rc = ref_layers.apply_attention(rp, jnp.asarray(xs[t]), ref_cfg,
                                              positions=jnp.asarray(pos), cache=rc)
        got, pc = layers.apply_attention(pp, torch.from_numpy(xs[t]), cfg,
                                         positions=torch.from_numpy(pos), cache=pc)
        _close(got, want, F32)
    assert int(pc.index) == int(rc.index) == steps
    _close(pc.k, rc.k, F32)
    _close(pc.v, rc.v, F32)


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_glu_ffn_matches_reference(activation):
    rp = ref_layers.init_glu_ffn(jax.random.PRNGKey(4), 64, 192)
    x = _randn(np.random.default_rng(4), 2, 8, 64)
    want = ref_layers.apply_glu_ffn(rp, jnp.asarray(x), activation)
    _close(layers.apply_glu_ffn(_port(rp), torch.from_numpy(x), activation), want, F32)


def test_rmsnorm_and_embedding_match_reference():
    rng = np.random.default_rng(5)
    x = _randn(rng, 2, 8, 64, scale=3.0)
    scale = {"scale": jnp.asarray(_randn(rng, 64))}
    _close(nn.apply_rmsnorm(_port(scale), torch.from_numpy(x)),
           ref_nn.apply_rmsnorm(scale, jnp.asarray(x)), F32)
    # bfloat16 input: normalised in float32, returned in bfloat16
    xb = nn.apply_rmsnorm(_port(scale), torch.from_numpy(x).bfloat16())
    assert xb.dtype == torch.bfloat16
    _close(xb, ref_nn.apply_rmsnorm(scale, jnp.asarray(x, jnp.bfloat16)), 3e-2)
    table = ref_nn.init_embedding(jax.random.PRNGKey(5), 100, 64)
    tokens = rng.integers(0, 100, (2, 8)).astype(np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = nn.apply_embedding(_port(table), torch.from_numpy(tokens).long(), tdt)
        assert got.dtype == tdt
        _close(got, ref_nn.apply_embedding(table, jnp.asarray(tokens), jdt), 0.0)


def _models(arch, dtype, window=None, attn_impl="pallas"):
    jdt, tdt = dtype
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    ref = ref_build_model(rcfg, attn_impl=attn_impl, dtype=jdt, sliding_window=window)
    port = build_model(cfg, attn_impl=attn_impl, dtype=tdt, sliding_window=window,
                       device="cpu")
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, port, rp, _port(rp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-7b", "phi3-medium-14b"])
def test_transformer_forward_matches_reference(arch, dtype):
    """Prefill logits through the flash path (interpret-mode Pallas in
    the reference, the kernel's plain version in the port)."""
    dt = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref, port, rp, pp = _models(arch, dt)
    tokens = np.random.default_rng(6).integers(0, port.cfg.vocab_size, (2, 128))
    want, _ = ref.forward(rp, jnp.asarray(tokens, jnp.int32))
    got, aux = port.forward(pp, torch.from_numpy(tokens))
    assert got.dtype == dt[1] and aux == 0.0
    # bfloat16: 3e-2 of the largest logit.  The reference's own two
    # attention paths ("xla", "pallas") differ by 0.072 on phi3's logits
    # (largest 4.8) in bfloat16, so an absolute 3e-2 holds neither.
    tol = 1e-4 if dtype == "float32" else 3e-2 * float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want, tol)
    last = make_prefill_step(port)(pp, {"tokens": torch.from_numpy(tokens)})
    _close(last, np.asarray(want[:, -1], np.float32), tol)


DENSE = [a for a in ARCH_IDS if get_smoke_config(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE)
def test_port_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the full-sequence forward logits
    (cache correctness), as ``tests/test_archs.py`` holds the reference."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    full, _ = model.forward(params, tokens)
    cache = model.init_cache(1, 8)
    outs = []
    for t in range(8):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache, t)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.float().numpy(), 3e-2)


def test_unported_families_raise():
    unported = [a for a in ARCH_IDS
                if get_smoke_config(a).family not in ("dense", "ssm", "hybrid")]
    assert {get_smoke_config(a).family for a in unported} == {"moe", "vlm", "audio"}
    for arch in unported:
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(get_smoke_config(arch), device="cpu")


@pytest.mark.parametrize("window", [None, 8])
def test_serving_loop_matches_reference(window):
    """``examples/serve_decode.py`` at the smoke config in float32: the
    reference's prompt and greedy tokens teacher-forced through the
    port's serve step give the same logits at every step, and the
    port's own greedy decode picks the same tokens."""
    batch, prompt_len, gen_len = 4, 16, 32
    dt = (jnp.float32, torch.float32)
    ref, port, rp, pp = _models("gemma-7b", dt, window=window, attn_impl="xla")
    serve = jax.jit(ref_make_serve_step(ref))
    prompt = np.random.default_rng(0).integers(0, port.cfg.vocab_size,
                                               (batch, prompt_len)).astype(np.int32)
    max_len = prompt_len + gen_len
    cache = ref.init_cache(batch, max_len, jnp.float32)
    ref_logits, inputs = [], []
    for t in range(prompt_len):
        logits, cache = serve(rp, jnp.asarray(prompt[:, t:t + 1]), cache,
                              jnp.asarray(t, jnp.int32))
        ref_logits.append(np.asarray(logits))
        inputs.append(prompt[:, t:t + 1])
    gen = []
    tok = np.array(jnp.argmax(logits, axis=-1, keepdims=True), np.int32)
    for t in range(prompt_len, max_len):
        gen.append(tok)
        inputs.append(tok)
        logits, cache = serve(rp, jnp.asarray(tok), cache, jnp.asarray(t, jnp.int32))
        ref_logits.append(np.asarray(logits))
        tok = np.array(jnp.argmax(logits, axis=-1, keepdims=True), np.int32)
    ref_gen = np.concatenate(gen, axis=1)

    step = make_serve_step(port)
    pc = port.init_cache(batch, max_len, torch.float32)
    s_max = min(max_len, window) if window else max_len
    assert pc["block0"].k.shape == (port.num_units, batch, s_max, 4, 64)
    for t, tok_t in enumerate(inputs):
        logits, pc = step(pp, torch.from_numpy(tok_t).long(), pc, t)
        _close(logits, ref_logits[t], 1e-4)

    pc = port.init_cache(batch, max_len, torch.float32)
    for t in range(prompt_len):
        logits, pc = step(pp, torch.from_numpy(prompt[:, t:t + 1]).long(), pc, t)
    first = torch.argmax(logits, dim=-1, keepdim=True)
    toks, pc = make_greedy_decode(port, gen_len - 1)(pp, first, pc, prompt_len)
    np.testing.assert_array_equal(
        torch.cat([first, toks], dim=1).numpy(), ref_gen)
    assert pc["block0"].index.tolist() == [max_len - 1] * port.num_units
