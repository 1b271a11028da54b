"""The port's flash attention against the JAX package's, on the CPU.

The port's dispatch (``flash_ops``, which on CPU tensors runs the plain
version) and its plain version (``flash_ref``) are held against the
reference's Pallas kernel (``repro.kernels.flash_ops``, interpret mode
on the CPU; its oracle for ragged S) and its oracle
(``flash_attention_ref``), on the same numpy inputs.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-3 in float32, 3e-2 in
bfloat16.  The CUDA kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

The rounding scheme of the bfloat16 tensor-core kernel is emulated here
in float32: P = exp(s - m) reaches the second product as two bf16 parts,
hi + lo, and the card's limit (1e-5 of the largest output plus half a
bf16 ulp of each value) holds; a single bf16 rounding of P breaks it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_ops as ref_ops
from repro.kernels.flash_ref import flash_attention_ref as ref_oracle
from repro_torch.kernels import flash_ops
from repro_torch.kernels.flash_ref import flash_attention_ref

# (b, s, h, g, d, causal, window, soft_cap)
CASES = {
    "gqa": (1, 128, 4, 2, 32, True, None, None),
    "gqa-wide": (2, 256, 8, 2, 64, True, None, None),
    "window": (1, 128, 4, 4, 32, True, 64, None),
    "mqa-bidirectional": (1, 256, 4, 1, 32, False, None, None),
    "mha-d128": (2, 128, 2, 2, 128, True, None, None),
    "ragged-s100": (1, 100, 4, 2, 32, True, None, None),
    "soft-cap": (1, 128, 2, 2, 32, True, None, 20.0),
    "bidirectional-window": (1, 128, 4, 2, 32, False, 64, None),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(b, s, h, g, d, scale):
    rng = np.random.default_rng(s + h)
    return [rng.standard_normal(shape).astype(np.float32) * scale
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d))]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_reference(case, dtype):
    b, s, h, g, d, causal, window, cap = CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, g, d, 1.0 if cap else 0.5)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    kw = dict(causal=causal, window=window, logit_soft_cap=cap)

    want_kernel = _f32(ref_ops.flash_attention(jq, jk, jv, **kw))
    want_oracle = _f32(ref_oracle(jq, jk, jv, **kw))
    got_ops = flash_ops.flash_attention(tq, tk, tv, **kw)
    got_ref = flash_attention_ref(tq, tk, tv, **kw)
    assert got_ops.dtype == tdt and got_ops.shape == (b, s, h, d)
    np.testing.assert_allclose(_f32(got_ops), want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_ref), want_oracle, rtol=tol, atol=tol)


def test_flash_ops_refuses_other_devices():
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no flash-attention path"):
        flash_ops.flash_attention(q, q, q)


# --- the bfloat16 kernel's rounding of P ---------------------------------------------
# the limit the card holds the bf16 kernel to (chip_smoke.py, test_torch_kernels_cuda.py)
CARD_REL, CARD_HALF_ULP = 1e-5, 2.0 ** -8
ROUNDING_SCALES = {"flat": 0.5, "peaked": 2.0}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate_tc_kernel(q, k, v, split: bool, block_k: int = 64):
    """The tensor-core kernel's arithmetic in float32, causal: an online
    softmax over key tiles of ``block_k``, P = exp(s - m) summed in float32
    and fed to P V as bf16 hi + lo (``split``) or bf16 alone, the products
    of bf16 values accumulated in float32, the output rounded once."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf, vf = (t.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3) for t in (k, v))
    scores = torch.einsum("bqhd,bhkd->bhqk", q, kf) / math.sqrt(d)
    pos = torch.arange(s)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = torch.zeros((b, h, s, d))
    m = torch.full((b, h, s), float("-inf"))
    l = torch.zeros((b, h, s))
    for k0 in range(0, s, block_k):
        tile = scores[..., k0:k0 + block_k]
        m_new = torch.maximum(m, tile.amax(-1))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(tile - m_use[..., None])
        l = l * corr + p.sum(-1)
        hi = _bf16(p)
        pv = hi @ vf[:, :, k0:k0 + block_k]
        if split:
            pv = pv + _bf16(p - hi) @ vf[:, :, k0:k0 + block_k]
        out = out * corr[..., None] + pv
        m = m_new
    return _bf16(out / l[..., None]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("inputs", list(ROUNDING_SCALES))
@pytest.mark.parametrize("d", [64, 256])
def test_bf16_kernel_rounding_of_p_meets_the_card_limit(d, inputs):
    """P split into bf16 hi + lo keeps every element within the card's
    limit of the float32 plain version on the same bf16 input values; one
    bf16 rounding of P does not (the reason for the split)."""
    arrays = _inputs(1, 512, 4, 2, d, ROUNDING_SCALES[inputs])
    q, k, v = (_bf16(torch.from_numpy(a)) for a in arrays)
    want = flash_attention_ref(q, k, v, causal=True)
    allowed = CARD_REL * float(want.abs().max()) + CARD_HALF_ULP * want.abs()
    split = (_emulate_tc_kernel(q, k, v, split=True) - want).abs()
    single = (_emulate_tc_kernel(q, k, v, split=False) - want).abs()
    assert bool((split <= allowed).all()), float((split / allowed).max())
    assert not bool((single <= allowed).all())
    assert float((single / allowed).max()) > 10.0
