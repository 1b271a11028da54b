"""Plain PyTorch versions of the SSD kernel.

The counterpart of ``src/repro/kernels/ssd_ref.py``: ``ssd_ref`` is the
model's chunked scan, ``ssd_naive`` the O(S) per-step recurrence that is
the ground truth for both (``ssd_steps``: the same recurrence from
an initial state, with the state it ends in).  The CPU branch of ``ssd_ops`` runs the
chunked scan, and the tests and ``chip_smoke.py`` hold the CUDA kernel
against these; nothing on the CUDA path uses them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.mamba2 import ssd_chunked, ssd_decode_step

# the kernels' tile, in steps (csrc/ssd.cu kTile and kTcTile)
KERNEL_TILE = 64


def ssd_ref(x, dt, A, Bm, Cm, chunk: int = 128):
    y, _ = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    return y


def ssd_naive(x, dt, A, Bm, Cm):
    """O(S) sequential recurrence — ground truth for both implementations."""
    return ssd_steps(x, dt, A, Bm, Cm)[0]


def ssd_steps(x, dt, A, Bm, Cm, initial_state: Optional[torch.Tensor] = None):
    """S steps of ``ssd_decode_step`` from ``initial_state`` (zeros when
    None): (y (B,S,H,P) in x's dtype, the float32 state after step S)."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(x[:, t].float(), dt[:, t], A, Bm[:, t], Cm[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_padded(x, dt, A, Bm, Cm, chunk: int = 128,
               initial_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan at any S: a ragged tail is padded up to a
    multiple of the chunk with dt = 0, x = 0 and B = C = 0, which is
    exact (a padded step multiplies the state by exp(0) = 1 and adds 0),
    and the padded rows of y are cut off.  Returns (y, final_state)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return y[:, :s], final_state


def ssd_rounding_limit(x, dt, A, Bm, Cm, chunk: int = 128,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element limits (for y, for the final state) within which two
    float32 evaluations of the scan on the same input values may differ
    by rounding alone, as the CUDA kernel and this plain version do.

    The scan run on |x|, |B|, |C| and |initial_state| gives, at every
    element, the sum of the absolute values of the terms that make it.
    Relative to that: float32 rounding of sums of up to N + Q terms,
    N + Q units of 2^-24; and the decays exp(cumsum a_i - cumsum a_j),
    whose exponents come from prefix sums as large as M = the largest
    |sum of a| over a chunk (or the kernel's 64-step tile), each rounding
    of which is worth up to 2 M units: 16 M units allows the two
    versions four such roundings each.  With the model's own A (down to
    -16) and dt from softplus, M reaches the hundreds, so the limit is
    near 1e-3 of the magnitude there, and near 6e-5 at the tests' scale
    (dt in [0.1, 0.6], A in [-0.6, -0.1])."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    q = max(min(chunk, s), KERNEL_TILE)
    a = (dt * A[None, None, :]).float()
    a = F.pad(a, (0, 0, 0, -s % q)).reshape(b, -1, q, h)
    m = float(a.sum(dim=2).abs().max())
    gamma = 2.0 ** -24 * (n + q + 16.0 * max(m, 1.0))
    y_abs, s_abs = ssd_padded(
        x.float().abs(), dt, A, Bm.float().abs(), Cm.float().abs(), chunk,
        None if initial_state is None else initial_state.abs())
    return gamma * y_abs, gamma * s_abs
