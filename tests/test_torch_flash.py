"""The port's flash attention against the JAX package's, on the CPU.

The port's dispatch (``flash_ops``, which on CPU tensors runs the plain
version) and its plain version (``flash_ref``) are held against the
reference's Pallas kernel (``repro.kernels.flash_ops``, interpret mode
on the CPU; its oracle for ragged S) and its oracle
(``flash_attention_ref``), on the same numpy inputs.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-3 in float32, 3e-2 in
bfloat16.  The CUDA kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
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
