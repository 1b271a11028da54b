"""The port's SSD scan against the JAX package's, on the CPU.

The port's dispatch (``ssd_ops``, which on CPU tensors runs the padded
plain chunked scan) and its plain versions (``ssd_ref``, ``ssd_naive``)
are held against the reference's Pallas kernel (``ssd_scan`` in
interpret mode), its chunked oracle (``ssd_ref``, ``ssd_chunked``) and
its ground truth (``ssd_naive``), on the same numpy inputs, over the
four cases of ``tests/test_kernels.py``.  Tolerances: 2e-3 in float32
(the reference's own); in bfloat16 3e-2, the reference's bfloat16
tolerance for flash, since it states none for SSD (one bfloat16 ulp of
an output near 4 is 1.6e-2).  The CUDA kernel itself is checked on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_scan as ref_scan
from repro.kernels.ssd_ref import ssd_naive as ref_naive
from repro.kernels.ssd_ref import ssd_ref as ref_oracle
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ssd_ops
from repro_torch.kernels.ssd_ref import ssd_naive, ssd_ref, ssd_steps
from repro_torch.models import mamba2

# (b, s, h, p, g, n, chunk): tests/test_kernels.py::test_ssd_sweep
CASES = {
    "p8-n8": (1, 64, 2, 8, 1, 8, 16),
    "grouped-g2": (2, 128, 4, 16, 2, 8, 32),
    "grouped-g4": (1, 256, 4, 32, 4, 16, 64),
    "one-chunk": (1, 128, 8, 16, 1, 32, 128),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
F32 = 2e-3


def _inputs(b, s, h, p, g, n, seed=None):
    """The reference tests' input scales: x, B, C ~ N(0, 0.25),
    dt in [0.1, 0.6], A in [-0.6, -0.1]."""
    rng = np.random.default_rng(s + n if seed is None else seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32)
    A = -(rng.random(h) * 0.5 + 0.1).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax(arrays, dtype=jnp.float32):
    x, dt, A, Bm, Cm = arrays
    return (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype))


def _torch(arrays, dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_ssd_matches_reference(case, dtype):
    b, s, h, p, g, n, chunk = CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, p, g, n)
    jin, tin = _jax(arrays, jdt), _torch(arrays, tdt)

    want_kernel = _f32(ref_scan(*jin, chunk=chunk, interpret=True))
    want_oracle = _f32(ref_oracle(*jin, chunk=chunk))
    truth = _f32(ref_naive(*jin))
    got_ops, state = ssd_ops.ssd(*tin, chunk=chunk)
    got_ref = ssd_ref(*tin, chunk=chunk)
    got_naive = ssd_naive(*tin)
    assert got_ops.dtype == tdt and got_ops.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    np.testing.assert_allclose(_f32(got_ops), want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_ref), want_oracle, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_naive), truth, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_ops), truth, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_final_state_and_initial_state_match_reference(case):
    """The final state, from zeros and from a given initial state,
    against the reference's ``ssd_chunked``."""
    b, s, h, p, g, n, chunk = CASES[case]
    arrays = _inputs(b, s, h, p, g, n)
    init = (np.random.default_rng(7).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    for initial in (None, init):
        y_want, s_want = ref_mamba2.ssd_chunked(
            *_jax(arrays), chunk=chunk,
            initial_state=None if initial is None else jnp.asarray(initial))
        y_got, s_got = ssd_ops.ssd(
            *_torch(arrays), chunk=chunk,
            initial_state=None if initial is None else torch.from_numpy(initial))
        np.testing.assert_allclose(_f32(y_got), _f32(y_want), rtol=F32, atol=F32)
        np.testing.assert_allclose(_f32(s_got), _f32(s_want), rtol=F32, atol=F32)


@pytest.mark.parametrize("split", [37, 64, 99])
def test_ragged_halves_chained_through_initial_state(split):
    """S = 100 with chunk 32 (no chunk divides either half): the padded
    plain scan over [0, split) and then [split, 100) from its final
    state equals the reference's naive recurrence over the whole, and
    the last state equals the reference's chunked scan's."""
    b, s, h, p, g, n, chunk = 2, 100, 4, 16, 2, 8, 32
    arrays = _inputs(b, s, h, p, g, n, seed=split)
    x, dt, A, Bm, Cm = _torch(arrays)
    y1, s1 = ssd_ops.ssd(x[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split],
                         chunk=chunk)
    y2, s2 = ssd_ops.ssd(x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:],
                         chunk=chunk, initial_state=s1)
    truth = _f32(ref_naive(*_jax(arrays)))
    np.testing.assert_allclose(_f32(torch.cat([y1, y2], dim=1)), truth, rtol=F32, atol=F32)
    _, s_want = ref_mamba2.ssd_chunked(*_jax(arrays), chunk=25)
    np.testing.assert_allclose(_f32(s2), _f32(s_want), rtol=F32, atol=F32)
    # the steps from the same initial state end in the same state
    _, s_steps = ssd_steps(x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:], s1)
    np.testing.assert_allclose(_f32(s_steps), _f32(s_want), rtol=F32, atol=F32)


def test_segsum_matches_reference():
    a = np.random.default_rng(3).standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(ref_mamba2.segsum(jnp.asarray(a)))
    got = mamba2.segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_ssd_decode_step_matches_reference():
    """Twelve single steps from a random state, grouped heads."""
    b, s, h, p, g, n = 2, 12, 4, 8, 2, 16
    arrays = _inputs(b, s, h, p, g, n, seed=5)
    jx, jdt, jA, jB, jC = _jax(arrays)
    tx, tdt, tA, tB, tC = _torch(arrays)
    init = (np.random.default_rng(6).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    js, ts = jnp.asarray(init), torch.from_numpy(init)
    for t in range(s):
        jy, js = ref_mamba2.ssd_decode_step(jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], js)
        ty, ts = mamba2.ssd_decode_step(tx[:, t], tdt[:, t], tA, tB[:, t], tC[:, t], ts)
        np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(ts), _f32(js), rtol=1e-5, atol=1e-5)


def test_ssd_ops_refuses_other_devices():
    x = torch.empty((1, 8, 2, 8), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    bc = torch.empty((1, 8, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no SSD path"):
        ssd_ops.ssd(x, dt, torch.empty((2,), device="meta"), bc, bc, chunk=4)
