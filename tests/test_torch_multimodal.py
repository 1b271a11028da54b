"""The port's VLM stub and encoder-decoder against the JAX package, and
every architecture's train and serve steps, on the CPU.

Weights come from the reference's own ``init`` and carry across with
``convert.params_from_numpy``; tokens, patch and frame embeddings are
numpy arrays from a seed.  ``attn_impl="pallas"`` runs the reference's
Pallas kernel in interpret mode and the port's plain version of its CUDA
kernel (non-causal in the encoder).  Tolerances:

  * cross-attention and its memory K/V: 1e-5 (float32, one layer);
  * whole models in float32: 1e-4 of the largest logit (encoder memory,
    logits, cross K/V); in bfloat16: 3e-2 of it (the rule of
    ``tests/test_torch_transformer.py``);
  * loss: rtol 1e-5; gradients: 1e-5 of the largest gradient.

The twins of ``tests/test_archs.py::test_train_step`` and
``::test_serve_step`` hold the port to the same checks over every
architecture: a fresh model's loss near ln V, parameters moved, one step
counted; three greedy decode steps of finite logits.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as ref_layers
from repro.train import steps as jsteps
from repro_torch.configs import ARCH_IDS, build_model, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers
from repro_torch.models.transformer import EncDecCache, EncoderDecoder
from repro_torch.optim import get_optimizer
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

VLM, AUDIO = "internvl2-26b", "seamless-m4t-large-v2"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 64                  # tests/test_archs.py's batch and sequence
S_ENC = 32


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _models(arch, dtype="float32", attn_impl="pallas"):
    jdt, tdt = DTYPES[dtype]
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    ref = ref_build_model(rcfg, attn_impl=attn_impl, dtype=jdt)
    port = build_model(cfg, attn_impl=attn_impl, dtype=tdt, device="cpu")
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, port, rp, _port(rp)


def _tol(want, dtype):
    return 1e-4 * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())) \
        if dtype == "float32" else 3e-2 * float(np.abs(np.asarray(want, np.float32)).max())


# --- cross-attention ---------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_and_memory_kv_match_reference(masked):
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=32)
    rcfg, cfg = ref_layers.AttentionConfig(**kw), layers.AttentionConfig(**kw)
    rp = ref_layers.init_attention(jax.random.PRNGKey(1), rcfg)
    pp = _port(rp)
    rng = np.random.default_rng(1)
    memory, x = _randn(rng, 2, 24, 64), _randn(rng, 2, 5, 64)
    rk, rv = ref_layers.encode_memory_kv(rp, jnp.asarray(memory), rcfg)
    k, v = layers.encode_memory_kv(pp, torch.from_numpy(memory), cfg)
    _close(k, rk, 1e-5)
    _close(v, rv, 1e-5)
    mask = rng.random((2, 24)) < 0.7 if masked else None
    want = ref_layers.apply_cross_attention(
        rp, jnp.asarray(x), (rk, rv), rcfg, None if mask is None else jnp.asarray(mask))
    got = layers.apply_cross_attention(
        pp, torch.from_numpy(x), (k, v), cfg, None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 5, 64)
    _close(got, want, 1e-5)


# --- the VLM stub --------------------------------------------------------------------
def _vlm_inputs(cfg, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tokens, _randn(rng, B, cfg.vision.num_patches, cfg.d_model)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vlm_forward_matches_reference(dtype):
    """Patch embeddings prepended: logits over the fused P + S sequence."""
    ref, port, rp, pp = _models(VLM, dtype)
    tokens, extra = _vlm_inputs(port.cfg)
    p = port.cfg.vision.num_patches
    want, _ = ref.forward(rp, jnp.asarray(tokens), extra_embeds=jnp.asarray(extra))
    got, aux = port.forward(pp, torch.from_numpy(tokens), extra_embeds=torch.from_numpy(extra))
    assert got.shape == (B, p + S, port.cfg.vocab_size) and aux == 0.0
    tol = _tol(want, dtype)
    _close(got, want, tol)
    last = tsteps.make_prefill_step(port)(
        pp, {"tokens": torch.from_numpy(tokens), "extra": torch.from_numpy(extra)})
    _close(last, np.asarray(want[:, -1], np.float32), tol)


def test_vlm_decode_is_text_only_as_the_reference():
    """Decode steps (text only) against the reference's, step by step."""
    ref, port, rp, pp = _models(VLM, attn_impl="xla")
    tokens, _ = _vlm_inputs(port.cfg)
    rc, pc = ref.init_cache(B, 6, jnp.float32), port.init_cache(B, 6, torch.float32)
    step = jax.jit(ref.decode_step)
    for t in range(6):
        want, rc = step(rp, jnp.asarray(tokens[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        got, pc = port.decode_step(pp, torch.from_numpy(tokens[:, t:t + 1]), pc, t)
        _close(got, want, 1e-4)
    with pytest.raises(NotImplementedError):
        port.prefill_into_cache(pp, tokens, pc)


# --- the encoder-decoder --------------------------------------------------------------
def _audio_inputs(cfg, seed=7, s_dec=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, s_dec)).astype(np.int32),
            _randn(rng, B, S_ENC, cfg.d_model))


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encdec_encode_and_forward_match_reference(dtype, attn_impl):
    """Bidirectional encoder (the flash path non-causal with "pallas"),
    teacher-forced decoder with cross-attention."""
    ref, port, rp, pp = _models(AUDIO, dtype, attn_impl)
    assert isinstance(port, EncoderDecoder)
    tokens, source = _audio_inputs(port.cfg)
    want_mem = ref.encode(rp, jnp.asarray(source))
    got_mem = port.encode(pp, torch.from_numpy(source))
    assert got_mem.dtype == DTYPES[dtype][1]
    _close(got_mem, want_mem, _tol(want_mem, dtype))
    want, _ = ref.forward(rp, jnp.asarray(tokens), jnp.asarray(source))
    got, aux = port.forward(pp, torch.from_numpy(tokens), torch.from_numpy(source))
    assert got.shape == (B, tokens.shape[1], port.cfg.vocab_size) and aux == 0.0
    tol = _tol(want, dtype)
    _close(got, want, tol)
    last = tsteps.make_prefill_step(port)(
        pp, {"tokens": torch.from_numpy(tokens), "source": torch.from_numpy(source)})
    _close(last, np.asarray(want[:, -1], np.float32), tol)


def test_encdec_init_cache_and_decode_match_reference():
    """``init_cache`` encodes once (cross K/V per decoder block, stacked
    over units); three ``decode_step`` calls against the reference's."""
    ref, port, rp, pp = _models(AUDIO, attn_impl="xla")
    tokens, source = _audio_inputs(port.cfg)
    rc = ref.init_cache(rp, jnp.asarray(source), max_len=8, dtype=jnp.float32)
    pc = port.init_cache(pp, torch.from_numpy(source), max_len=8, dtype=torch.float32)
    assert isinstance(pc, EncDecCache)
    for name, (k, v) in pc.cross_kv.items():
        rk, rv = rc.cross_kv[name]
        assert k.shape == rk.shape == (port.dec.num_units, B, S_ENC, 4, 32)
        _close(k, rk, 1e-4)
        _close(v, rv, 1e-4)
    assert pc.self_cache["block0"].k.shape == rc.self_cache["block0"].k.shape
    step = jax.jit(ref.decode_step)
    for t in range(3):
        want, rc = step(rp, jnp.asarray(tokens[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        got, pc = port.decode_step(pp, torch.from_numpy(tokens[:, t:t + 1]), pc, t)
        _close(got, want, 1e-4)
    assert pc.self_cache["block0"].index.tolist() == [3] * port.dec.num_units
    _close(pc.self_cache["block0"].k, rc.self_cache["block0"].k, 1e-5)


def test_encdec_decode_matches_forward():
    """Teacher-forced decode reproduces the teacher-forced forward's
    logits at every position (cache correctness), in float32."""
    cfg = get_smoke_config(AUDIO)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens, source = (torch.from_numpy(a) for a in _audio_inputs(cfg, s_dec=8))
    full, _ = model.forward(params, tokens, source)
    cache = model.init_cache(params, source, max_len=8, dtype=torch.float32)
    outs = []
    for t in range(8):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache, t)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), 1e-4 * float(full.abs().max()))


# --- loss and gradients ---------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_gradients_match_reference(arch):
    """lm_loss over the text positions (the patches excluded) and the
    gradients of every leaf, against ``jax.value_and_grad``."""
    ref, port, rp, pp = _models(arch, attn_impl="xla")
    if arch == VLM:
        tokens, extra = _vlm_inputs(port.cfg, seed=1)
        jbatch = {"tokens": jnp.asarray(tokens), "extra": jnp.asarray(extra)}
        tbatch = {"tokens": torch.from_numpy(tokens), "extra": torch.from_numpy(extra)}
    else:
        tokens, source = _audio_inputs(port.cfg, seed=1)
        jbatch = {"tokens": jnp.asarray(tokens), "source": jnp.asarray(source)}
        tbatch = {"tokens": torch.from_numpy(tokens), "source": torch.from_numpy(source)}

    def ref_loss(p):
        if arch == VLM:
            logits, aux = ref.forward(p, jbatch["tokens"], extra_embeds=jbatch["extra"])
            n = jbatch["extra"].shape[1]
        else:
            logits, aux = ref.forward(p, jbatch["tokens"], jbatch["source"])
            n = 0
        loss = jsteps.lm_loss(logits, jbatch["tokens"], n)
        return loss + aux, loss

    (r_total, r_ce), r_grads = jax.value_and_grad(ref_loss, has_aux=True)(rp)
    (t_total, t_ce), t_grads = tsteps._value_and_grad(tsteps._loss_fn(port), pp, tbatch)
    assert float(t_ce) == pytest.approx(float(r_ce), rel=1e-5)
    assert float(t_total) == pytest.approx(float(r_total), rel=1e-5)
    g_leaves, w_leaves = tree_leaves(t_grads), jax.tree_util.tree_leaves(r_grads)
    assert len(g_leaves) == len(w_leaves)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale)


# --- twins of tests/test_archs.py ---------------------------------------------------------
def _batch(cfg, rng):
    """As tests/test_archs.py builds it: tokens, and bfloat16 patch or
    frame embeddings for the vlm and audio families."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        batch["extra"] = torch.from_numpy(
            rng.standard_normal((B, cfg.vision.num_patches, cfg.d_model))).bfloat16()
    if cfg.family == "audio":
        batch["source"] = torch.from_numpy(rng.standard_normal((B, 32, cfg.d_model))).bfloat16()
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    state = tsteps.TrainState(params=params, opt_state=opt.init(params),
                              step=torch.zeros((), dtype=torch.int32))
    state2, metrics = tsteps.make_train_step(model, opt)(
        state, _batch(cfg, np.random.default_rng(sum(map(ord, arch)))))
    loss = float(metrics["loss"])
    assert math.isfinite(loss)
    assert abs(loss - math.log(cfg.vocab_size)) < 1.5       # a fresh model's LM loss
    delta = sum(float((a - b).abs().sum()) for a, b in zip(tree_leaves(state2.params),
                                                           tree_leaves(state.params)))
    assert delta > 0.0
    assert int(state2.step) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_step(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.family == "audio":
        src = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 32, cfg.d_model)))
        cache = model.init_cache(params, src.bfloat16(), max_len=32)
    else:
        cache = model.init_cache(B, 32)
    serve = tsteps.make_serve_step(model)
    tok = torch.zeros((B, 1), dtype=torch.long)
    for pos in range(3):
        logits, cache = serve(params, tok, cache, pos)
        assert logits.shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        tok = torch.argmax(logits, dim=-1, keepdim=True)


def test_every_family_inits_in_a_storage_dtype():
    """``init(rng, dtype)`` stores each leaf in ``dtype`` as drawn: the
    same values as a float32 init cast afterwards."""
    for arch in (VLM, AUDIO, "gemma-7b"):
        model = build_model(get_smoke_config(arch), device="cpu")
        p32 = model.init(torch.Generator().manual_seed(4))
        p16 = model.init(torch.Generator().manual_seed(4), dtype=torch.bfloat16)
        for a, b in zip(tree_leaves(p32), tree_leaves(p16)):
            assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
            assert torch.equal(a.bfloat16(), b)


def test_driver_trains_a_moe_model(capsys):
    """``launch/train.py`` drives the moe family as the reference's driver
    does, and refuses vlm and audio with its message."""
    from repro_torch.launch import train as tdriver

    state = tdriver.train(tdriver.parse_args(
        ["--arch", "llama4-maverick-400b-a17b", "--smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--device", "cpu"]))
    assert int(state.step) == 2
    out = capsys.readouterr().out
    assert "[train] step    1" in out and "2 steps in" in out
    for arch in (VLM, AUDIO):
        with pytest.raises(SystemExit, match="LM path"):
            tdriver.train(tdriver.parse_args(["--arch", arch, "--smoke", "--device", "cpu"]))
