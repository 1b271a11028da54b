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
from repro_torch.kernels.ssd_ref import (ssd_naive, ssd_padded, ssd_ref, ssd_rounding_limit,
                                        ssd_steps)
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


# --- the rounding scheme of the bfloat16 tensor-core kernel ---------------------------
# (b, s, h, p, g, n, initial state): mamba2's head at S = 512, and a ragged S
# (no 64-step tile divides it) from an initial state at zamba2's N
ROUNDING_SHAPES = {"s512": (1, 512, 8, 64, 1, 128, False),
                   "ragged-s300-init": (1, 300, 8, 64, 1, 64, True)}
ROUNDED_OPERANDS = ("scores", "state", "xw")
KERNEL_TILE = 64          # the tensor-core kernel's chunk, csrc/ssd.cu kTcTile


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _parts(v: torch.Tensor, split: bool):
    """The bf16 parts an operand enters its products as: hi = bf16(v) and
    lo = bf16(v - hi), or hi alone when rounded once."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _emulate_tc_kernel(x, dt, A, Bm, Cm, init, split=ROUNDED_OPERANDS):
    """The tensor-core kernel's arithmetic in float32: 64-step chunks; the
    masked scores S' = C B^T o L o dt_j, the carried state and the weighted
    input x w (w = dt exp(c_last - c)) each enter their products as the bf16
    parts of ``_parts`` (split for the operands named in ``split``, rounded
    once for the others); products of bf16 values accumulate in float32 and
    y is rounded to bf16 once.  Returns (y, final state)."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    rep = h // Bm.shape[2]
    pad = -s % KERNEL_TILE
    x, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    xh = x.permute(0, 2, 1, 3)                                       # (b, h, S, p)
    bh, ch = (t.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3) for t in (Bm, Cm))
    dth = dt.permute(0, 2, 1)                                        # (b, h, S)
    state = (torch.zeros((b, h, p, n)) if init is None else init.clone())
    mask = torch.tril(torch.ones((KERNEL_TILE, KERNEL_TILE), dtype=torch.bool))
    ys = []
    for t0 in range(0, s + pad, KERNEL_TILE):
        sl = slice(t0, t0 + KERNEL_TILE)
        xc, bc, cc, dc = xh[:, :, sl], bh[:, :, sl], ch[:, :, sl], dth[:, :, sl]
        cum = torch.cumsum(dc * A[None, :, None], dim=-1)             # (b, h, Q)
        decay = torch.exp(cum[..., :, None] - cum[..., None, :]).masked_fill(~mask, 0.0)
        scores = (cc @ bc.transpose(-1, -2)) * decay * dc[..., None, :]
        yo = sum(cc @ part.transpose(-1, -2) for part in _parts(state, "state" in split))
        yd = sum(part @ xc for part in _parts(scores, "scores" in split))
        ys.append(_bf16(torch.exp(cum)[..., None] * yo + yd))
        w = dc * torch.exp(cum[..., -1:] - cum)
        xw = xc * w[..., None]
        state = torch.exp(cum[..., -1])[..., None, None] * state + sum(
            part.transpose(-1, -2) @ bc for part in _parts(xw, "xw" in split))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]
    return y, state


def _rounding_inputs(shape, scale):
    """bf16-valued x, B, C (as the model hands them over), float32 dt and
    A at the tests' or the model's scale, and an optional initial state."""
    b, s, h, p, g, n, with_init = shape
    rng = np.random.default_rng(s + n)
    x, B, C = (_bf16(torch.from_numpy((rng.standard_normal(shp) * 0.5).astype(np.float32)))
               for shp in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    if scale == "tests":
        dt = torch.from_numpy((rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32))
        A = -torch.from_numpy((rng.random(h) * 0.5 + 0.1).astype(np.float32))
    else:
        dt = torch.nn.functional.softplus(
            torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)))
        A = -torch.linspace(1.0, 16.0, h)
    init = (torch.from_numpy((rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32))
            if with_init else None)
    return x, dt, A, B, C, init


def _within_card_limit(y, state, x, dt, A, Bm, Cm, init):
    """The card's test (``assert_ssd_close`` in tests/test_torch_kernels_cuda.py):
    y within ``ssd_rounding_limit`` plus half a bf16 ulp of each value of
    the float32 chunked scan, the state within the limit."""
    y_want, s_want = ssd_padded(x, dt, A, Bm, Cm, 128, init)
    y_lim, s_lim = ssd_rounding_limit(x, dt, A, Bm, Cm, 128, init)
    y_lim = y_lim + 2.0 ** -8 * y_want.abs()
    return (bool(((y - y_want).abs() <= y_lim).all()),
            bool(((state - s_want).abs() <= s_lim).all()))


@pytest.mark.parametrize("shape", list(ROUNDING_SHAPES))
@pytest.mark.parametrize("scale", ["tests", "model"])
def test_bf16_kernel_rounding_meets_the_card_limit(scale, shape):
    """S', the state and x w each split into bf16 hi + lo keep y and the
    final state within the card's float32 limit of the plain chunked scan
    on the same input values, at both input scales."""
    args = _rounding_inputs(ROUNDING_SHAPES[shape], scale)
    y, state = _emulate_tc_kernel(*args)
    assert _within_card_limit(y, state, *args) == (True, True)


@pytest.mark.parametrize("shape", list(ROUNDING_SHAPES))
@pytest.mark.parametrize("rounded", ROUNDED_OPERANDS)
def test_rounding_one_operand_once_misses_the_card_limit(rounded, shape):
    """Rounding any one of the three float32 operands to bf16 once, the
    other two split, breaks the limit at the tests' scale: why each split
    is there."""
    args = _rounding_inputs(ROUNDING_SHAPES[shape], "tests")
    split = tuple(op for op in ROUNDED_OPERANDS if op != rounded)
    y, state = _emulate_tc_kernel(*args, split=split)
    assert _within_card_limit(y, state, *args) != (True, True)
