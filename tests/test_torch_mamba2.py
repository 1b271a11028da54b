"""The port's Mamba2 block, ``Mamba2Model`` and ``Zamba2Model`` against
the JAX package, on the CPU.

Weights come from the reference's own ``init`` and are carried across
with ``convert.params_from_numpy``; tokens and activations are numpy
arrays from a seed.  ``ssd_impl="pallas"`` runs the reference's Pallas
kernel in interpret mode and the port's padded plain scan (the CPU
branch of its CUDA kernel's dispatch); zamba2's shared attention runs
``attn_impl="pallas"`` the same way.  Tolerances: 1e-4 for float32
logits and single blocks (summation order only); in bfloat16 3e-2 of
the largest logit, as for the dense models (``test_torch_transformer``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import mamba2 as ref_mamba2
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba2
from repro_torch.train.steps import make_prefill_step, make_serve_step

F32 = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ["mamba2-780m", "zamba2-1.2b"]


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _models(arch, dtype, ssd_impl="pallas"):
    jdt, tdt = DTYPES[dtype]
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    kw = dict(attn_impl="pallas", ssd_impl=ssd_impl)
    ref = ref_build_model(rcfg, dtype=jdt, **kw)
    port = build_model(cfg, dtype=tdt, device="cpu", **kw)
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, port, rp, _port(rp)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ssd_impl", ["xla", "pallas"])
def test_mamba_block_matches_reference(ssd_impl, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = get_smoke_config("mamba2-780m")
    rp = ref_mamba2.init_mamba_block(jax.random.PRNGKey(1), ref_smoke_config("mamba2-780m"))
    x = (np.random.default_rng(1).standard_normal((2, 64, cfg.d_model))).astype(np.float32)
    want, _ = ref_mamba2.apply_mamba_block(rp, jnp.asarray(x, jdt),
                                           ref_smoke_config("mamba2-780m"), ssd_impl=ssd_impl)
    got, cache = mamba2.apply_mamba_block(_port(rp), torch.from_numpy(x).to(tdt), cfg,
                                          ssd_impl=ssd_impl)
    assert cache is None and got.dtype == tdt
    tol = F32 if dtype == "float32" else 3e-2 * float(np.abs(_np(want)).max())
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ssd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_matches_reference(arch, ssd_impl, dtype):
    ref, port, rp, pp = _models(arch, dtype, ssd_impl)
    tokens = np.random.default_rng(6).integers(0, port.cfg.vocab_size, (2, 64))
    want, _ = ref.forward(rp, jnp.asarray(tokens, jnp.int32))
    got, aux = port.forward(pp, torch.from_numpy(tokens))
    assert got.dtype == DTYPES[dtype][1] and aux == 0.0
    tol = F32 if dtype == "float32" else 3e-2 * float(np.abs(_np(want)).max())
    _close(got, want, tol)
    last = make_prefill_step(port)(pp, {"tokens": torch.from_numpy(tokens)})
    _close(last, _np(want)[:, -1], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """Twelve float32 decode steps from an empty cache: logits at every
    step and the caches' SSM states at the end."""
    ref, port, rp, pp = _models(arch, "float32")
    batch, steps = 2, 12
    tokens = np.random.default_rng(8).integers(0, port.cfg.vocab_size, (batch, steps))
    rc = ref.init_cache(batch, steps, jnp.float32)
    pc = port.init_cache(batch, steps, torch.float32)
    step = make_serve_step(port)
    for t in range(steps):
        want, rc = ref.decode_step(rp, jnp.asarray(tokens[:, t:t + 1], jnp.int32), rc,
                                   jnp.asarray(t, jnp.int32))
        got, pc = step(pp, torch.from_numpy(tokens[:, t:t + 1]), pc, t)
        _close(got, _np(want)[:, -1], F32)
    if arch == "mamba2-780m":
        _close(pc.ssm, rc.ssm, F32)
        _close(pc.conv, rc.conv, F32)
    else:
        _close(pc["mamba_full"].ssm, rc["mamba_full"].ssm, F32)
        _close(pc["attn"].k, rc["attn"].k, F32)
        assert pc["attn"].index.tolist() == [steps] * port.n_attn_uses


@pytest.mark.parametrize("seq", [32, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_forward(arch, seq):
    """Teacher-forced decode reproduces the full-sequence forward logits
    (cache correctness) in float32, at S = 40 too, which the smoke
    configs' chunk of 32 does not divide (the padded scan)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, attn_impl="pallas", ssd_impl="pallas",
                        dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, seq)))
    full, _ = model.forward(params, tokens)
    cache = model.init_cache(2, seq, torch.float32)
    outs = []
    for t in range(seq):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache, t)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full, F32)


def test_full_configs_build_on_the_cpu_with_the_reference_layout():
    """The full-size configs build on the CPU when asked (no weights
    drawn), and the smoke models' parameters carry the reference's
    stacked layout leaf for leaf."""
    from repro_torch.configs import get_config

    for arch in ARCHS:
        model = build_model(get_config(arch), ssd_impl="pallas", device="cpu")
        assert model.device.type == "cpu" and model.ssd_impl == "pallas"
        _, port, rp, pp = _models(arch, "float32")
        mine = port.init(torch.Generator().manual_seed(0))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == want
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), pp) == want
