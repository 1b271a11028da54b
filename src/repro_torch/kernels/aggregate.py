"""CUDA kernel: weighted model aggregation (FedLEO eqs. 4/9).

``aggregate_leaves(xs, w)`` computes out_i[n] = sum_k w[k] * x_i[k, n]
for a list of (K, n_i) leaves (a stacked parameter leaf reshaped as a
view, rows any distance apart, each row contiguous), accumulating in
fp32 and writing each leaf's own dtype (float32 or bfloat16, mixed
freely).  It launches ``csrc/aggregate.cu`` (the port of the Pallas
kernel ``src/repro/kernels/aggregate.py::aggregate_flat``) on the
current CUDA stream: one launch for a tree of up to ``MAX_LEAVES``
non-empty leaves, reading every leaf where it lies (no concatenation).
The library is built with ``nvcc`` at first use (``kernels/build.py``).
The kernel is bound by bytes: it moves (K + 1) * n_i * itemsize bytes
per leaf.

``aggregate_flat(x, w)`` is the one-leaf call of the same kernel on a
contiguous (K, N) stream.

``plan`` is the pure-Python planner behind the launch: it classifies
each leaf by the widest access its rows allow (16 bytes where they are
16-byte aligned; 8, 4 or 2 otherwise), lays fixed tiles over
the leaves' joint index space and splits the list into launches of at
most ``MAX_LEAVES`` leaves; ``pack`` writes a launch's leaf table, which
the kernel takes by value as its parameter.

The wrappers take CUDA tensors only and raise on anything the kernel
does not take; the plain versions are ``aggregate_ref.aggregate_leaves_ref``
and ``aggregate_ref.aggregate_flat_ref``.  ``aggregate_flat.launches``
counts the kernel's launches by either entry.
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build

# the kernel's layout (csrc/aggregate.cu): threads a block, 16-byte units a
# thread takes per row, bytes of one row a tile covers, leaves a table holds
THREADS = 256
VECS = 2
TILE_BYTES = THREADS * VECS * 16
MAX_LEAVES = 816
# the device kernel, as a profiler names it, and the dtypes it takes
KERNEL = "aggregate_leaves_kernel"
DTYPES = (torch.float32, torch.bfloat16)
_HEADER = struct.Struct("<Qii")        # w, K, num_leaves
_LEAF = struct.Struct("<QQqqii")       # x, out, n, stride, tile0, flags
_BF16, _VEC_SHIFT = 1, 1               # flags: bfloat16, log2 of the access bytes
_lib: dict = {}


class LeafSpec(NamedTuple):
    """What the planner needs of one leaf: the addresses of its input's
    row 0 and of its output, its columns, its row stride in elements,
    its element size and whether it is bfloat16."""

    x: int
    out: int
    n: int
    stride: int
    itemsize: int
    bf16: bool

    @property
    def vec_bytes(self) -> int:
        """The widest access (16, 8, 4 or 2 bytes, at least one element)
        that every row start of the input and the output is aligned to:
        16 for rows on 16-byte boundaries."""
        bits = self.x | self.out | self.n * self.itemsize | self.stride * self.itemsize
        for vb in (16, 8, 4):
            if bits % vb == 0:
                return vb
        return self.itemsize

    @property
    def tile_elems(self) -> int:
        return TILE_BYTES // self.itemsize


class Launch(NamedTuple):
    """One launch: the indices of its leaves in the planned list, each
    leaf's first tile, and the number of tiles (the grid)."""

    leaves: Tuple[int, ...]
    tile0: Tuple[int, ...]
    tiles: int


def plan(specs: Sequence[LeafSpec], max_leaves: int = MAX_LEAVES) -> List[Launch]:
    """Tiles over the leaves in order, ceil(n_i / tile_elems) each, and as
    few launches as ``max_leaves`` leaves a launch allow.  Empty leaves
    get no tile and no table entry."""
    launches: List[Launch] = []
    leaves: List[int] = []
    tile0: List[int] = []
    tiles = 0
    for i, s in enumerate(specs):
        if s.n == 0:
            continue
        if len(leaves) == max_leaves:
            launches.append(Launch(tuple(leaves), tuple(tile0), tiles))
            leaves, tile0, tiles = [], [], 0
        leaves.append(i)
        tile0.append(tiles)
        tiles += -(-s.n // s.tile_elems)
    if leaves:
        launches.append(Launch(tuple(leaves), tuple(tile0), tiles))
    return launches


def pack(launch: Launch, specs: Sequence[LeafSpec], w_ptr: int, k: int) -> bytes:
    """The launch's table as the kernel takes it (``Table`` in
    ``csrc/aggregate.cu``): header, then one entry per leaf."""
    fields = [w_ptr, k, len(launch.leaves)]
    for i, t0 in zip(launch.leaves, launch.tile0):
        s = specs[i]
        flags = (_BF16 if s.bf16 else 0) | (s.vec_bytes.bit_length() - 1) << _VEC_SHIFT
        fields += (s.x, s.out, s.n, s.stride, t0, flags)
    return struct.pack(_HEADER.format + _LEAF.format[1:] * len(launch.leaves), *fields)


def _library():
    lib = _lib.get("lib")
    if lib is None:
        lib = build.load("aggregate")
        lib.aggregate_leaves.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        lib.aggregate_leaves.restype = ctypes.c_int
        lib.aggregate_error_string.argtypes = [ctypes.c_int]
        lib.aggregate_error_string.restype = ctypes.c_char_p
        layout = (lib.aggregate_tile_bytes(), lib.aggregate_max_leaves())
        if layout != (TILE_BYTES, MAX_LEAVES):
            raise RuntimeError(
                f"csrc/aggregate.cu has tiles of {layout[0]} bytes and tables of "
                f"{layout[1]} leaves; the planner has {TILE_BYTES} and {MAX_LEAVES}"
            )
        _lib["lib"] = lib
    return lib


def _check_leaves(xs: Sequence[torch.Tensor], w: torch.Tensor) -> None:
    if w.device.type != "cuda":
        raise ValueError(
            f"aggregate_leaves runs on CUDA tensors, got w on {w.device}; "
            "the plain version is aggregate_ref.aggregate_leaves_ref"
        )
    if w.dtype != torch.float32 or w.dim() != 1 or not w.is_contiguous():
        raise ValueError(
            f"w must be a contiguous float32 (K,) vector, got {w.dtype} {tuple(w.shape)}"
        )
    k = w.shape[0]
    if not 1 <= k < 2**31:
        raise ValueError(f"K must be in [1, 2^31), got {k}")
    for i, x in enumerate(xs):
        if x.device != w.device:
            raise ValueError(
                f"leaf {i} on {x.device}, w on {w.device}: aggregate_leaves runs on "
                "CUDA tensors of one device"
            )
        if x.dtype not in DTYPES:
            raise TypeError(f"aggregate_leaves takes float32 or bfloat16, leaf {i} is {x.dtype}")
        if x.dim() != 2 or x.shape[0] != k:
            raise ValueError(f"leaf {i} must be ({k}, n), got {tuple(x.shape)}")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"leaf {i}'s rows must be contiguous, got strides {x.stride()}")


def aggregate_leaves(xs: Sequence[torch.Tensor], w: torch.Tensor) -> List[torch.Tensor]:
    """Weighted sum over the leading axis of each (K, n_i) CUDA leaf;
    returns one (n_i,) tensor per leaf in its dtype, from as few launches
    as the leaf table allows (one for up to ``MAX_LEAVES`` leaves)."""
    _check_leaves(xs, w)
    k = w.shape[0]
    outs = [torch.empty((x.shape[1],), dtype=x.dtype, device=x.device) for x in xs]
    specs = [LeafSpec(x.data_ptr(), o.data_ptr(), x.shape[1], x.stride(0),
                      x.element_size(), x.dtype == torch.bfloat16)
             for x, o in zip(xs, outs)]
    launches = plan(specs)
    if not launches:
        return outs
    lib = _library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for launch in launches:
            err = lib.aggregate_leaves(pack(launch, specs, w.data_ptr(), k), launch.tiles, stream)
            if err != 0:
                msg = lib.aggregate_error_string(err).decode()
                raise RuntimeError(f"aggregate_leaves launch failed: {msg} ({err})")
            aggregate_flat.launches += 1
    return outs


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"aggregate_flat runs on CUDA tensors, got x on {x.device}; "
            "the plain version is aggregate_ref.aggregate_flat_ref"
        )
    if x.dtype not in DTYPES:
        raise TypeError(f"aggregate_flat takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] < 2**31:
        raise ValueError(f"x must be (K, N) with 1 <= K < 2^31, got {tuple(x.shape)}")
    if w.dtype != torch.float32 or w.shape != (x.shape[0],):
        raise ValueError(
            f"w must be float32 of shape ({x.shape[0]},), got "
            f"{w.dtype} {tuple(w.shape)}"
        )
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def aggregate_flat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the leading axis of a (K, N) CUDA tensor;
    returns (N,) in ``x.dtype``."""
    _check(x, w)
    return aggregate_leaves([x], w)[0]


aggregate_flat.launches = 0   # type: ignore[attr-defined]
