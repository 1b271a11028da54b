// Weighted model aggregation (FedLEO eqs. 4 and 9) for Hopper (sm_90a), one
// launch over a whole list of leaves.
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py::aggregate_flat
// (body _aggregate_kernel).  For each leaf i, a row-major (K, n_i) matrix x_i
// whose rows are `stride_i` elements apart (a stacked parameter leaf seen as a
// view), it computes
//
//     out_i[n] = sum_k w[k] * x_i[k, n]        0 <= n < n_i, 0 <= k < K
//
// with w a (K,) float32 vector on the device.  Each output element starts from
// acc = 0 and takes acc = fmaf(w[k], x[k, n], acc) for k = 0 .. K-1 in order,
// then one rounding to the leaf's type (float or bfloat16; one launch may mix
// them).  The TPU kernel took one (K, N) stream, so its caller concatenated the
// leaves first: a full extra read and write of the stream.  Here the leaves are
// read where they lie and each output is written where the caller wants it.
//
// Bound: bytes.  Each input element is read once and each output written once,
// (K + 1) * sizeof(T) bytes for 2K flops per output element: below one flop per
// byte, against the card's ~20 float32 flops per byte.  Tensor cores have
// nothing to offer a weighted sum over K <= 8 rows.  What the design does:
//
//  * 16-byte loads and stores (4 float or 8 bfloat16) on every leaf whose rows
//    are 16-byte aligned: x, out, n_i * sizeof(T) and the row stride in bytes
//    all multiples of 16.  A leaf aligned only to 8 or 4 bytes (one (K, N)
//    stream with N * sizeof(T) not a multiple of 16, whose odd rows then start
//    off 16 bytes) takes 8- or 4-byte accesses, and a bfloat16 leaf aligned to
//    2 bytes single elements; in the paper's CNN only the 10-element fc2 bias
//    (40 bytes a row) is not 16-byte aligned.  Every access width covers the
//    same 32 bytes of a row per thread, neighbouring threads on neighbouring
//    bytes.
//  * All K row loads of a thread's accesses are issued before the FMA chain,
//    with K a template parameter for 1..8 (above 8, in groups of 8 rows), so a
//    thread keeps 32 K bytes of loads in flight: 256 B at K = 8, tens of KB
//    per SM, what DRAM's latency (about 1 us at 3.35 TB/s, ~25 KB per SM)
//    asks for.
//  * Fixed tiles of kTileBytes per row over the joint index space of all leaves,
//    one block per tile and the grid sized to the tiles (no grid-stride tail).
//    A block finds its leaf by a binary search of the leaves' first tiles.
//  * The leaf table travels by value as a __grid_constant__ kernel parameter
//    (CUDA 12.1 and later allow 32,764 bytes on Hopper): no device allocation
//    and no host-to-device copy.  A table of kSmallCap leaves (1.3 KB) serves
//    every tree up to that size; larger trees take tables of kLargeCap leaves,
//    as few launches as that allows (the wrapper plans them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;                         // 16-byte units a thread takes per row
constexpr int kTileBytes = kThreads * kVecs * 16;  // bytes of one row a tile covers
constexpr int kGroup = 8;                        // rows loaded ahead of their FMAs, K > 8
constexpr int kSmallCap = 32;
constexpr int kLargeCap = 816;
constexpr int kBf16 = 1;                         // Leaf::flags: bit 0, and log2 of
constexpr int kVecShift = 1;                     // the access bytes from bit 1

// One leaf; the layout is packed by kernels/aggregate.py (struct "<QQqqii").
struct Leaf {
  const void* x;      // row 0 of the (K, n) input
  void* out;          // (n,) output, the input's type
  long long n;        // columns
  long long stride;   // elements from one row to the next
  int tile0;          // the leaf's first tile in the launch
  int flags;          // kBf16 | log2(access bytes) << kVecShift
};
static_assert(sizeof(Leaf) == 40, "Leaf is packed as <QQqqii by kernels/aggregate.py");

template <int CAP>
struct Table {
  const float* w;     // (K,) float32 weights
  int K;
  int num_leaves;
  Leaf leaf[CAP];     // tile0 ascending, leaf 0 starting at tile 0
};
static_assert(offsetof(Table<1>, leaf) == 16, "Table header is packed as <Qii");
static_assert(sizeof(Table<kLargeCap>) <= 32764, "kernel parameters are at most 32,764 bytes");

// One access of VB bytes of a row: 16, 8 or 4 bytes of float or bfloat16, or
// one 2-byte bfloat16.
template <int VB> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<4> { using type = uint32_t; };
template <> struct Bits<2> { using type = unsigned short; };

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const uint2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

// element i of an access, widened exactly to float
template <typename T, int VB>
__device__ __forceinline__ float elem(const typename Bits<VB>::type& v, int i) {
  if constexpr (VB == 2) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(v, i));
  } else {
    const uint32_t u = word(v, i / 2);    // element 2j is the low half of word j
    return __uint_as_float(i % 2 ? (u & 0xffff0000u) : (u << 16));
  }
}

// VB / sizeof(T) floats, each rounded once to T (to nearest even, as torch's
// cast), as one access
template <typename T, int VB>
__device__ __forceinline__ typename Bits<VB>::type pack(const float* a) {
  if constexpr (VB == 2) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a[0]));
  } else {
    constexpr int W = VB / 4;
    uint32_t u[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 4) {
        u[i] = __float_as_uint(a[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    if constexpr (VB == 16) return make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (VB == 8) return make_uint2(u[0], u[1]);
    else return u[0];
  }
}

// The tile of a leaf from element `base`, in accesses of VB bytes: thread t
// takes the accesses q = 0 .. NV-1 at base + (q * kThreads + t) * EV, so that
// neighbouring threads touch neighbouring bytes.  KT = K (1..8): every row of
// a group of accesses is loaded before the first FMA.  KT = 0: K rows in
// groups of kGroup, each group loaded before its FMAs.  Either way each
// element sums k = 0 .. K-1 in order.  A group holds at most 32 bytes of a
// row a thread (only 2-byte accesses need two groups), which bounds the
// registers the loads in flight take: 8 K of them.
template <typename T, int KT, int VB>
__device__ __forceinline__ void vector_tile(const Leaf& L, const float* __restrict__ w, int K,
                                            long long base) {
  using V = typename Bits<VB>::type;
  constexpr int EV = VB / static_cast<int>(sizeof(T));    // elements an access
  constexpr int NV = kTileBytes / kThreads / VB;          // accesses a thread, per row
  constexpr int WORDS = VB < 4 ? 1 : VB / 4;              // registers an access
  constexpr int NG = NV < 8 / WORDS ? NV : 8 / WORDS;     // accesses a group
  constexpr int G = KT > 0 ? KT : kGroup;
  static_assert(NV % NG == 0, "groups split a thread's accesses evenly");
  const T* __restrict__ x = static_cast<const T*>(L.x);
  T* __restrict__ out = static_cast<T*>(L.out);
  const long long n = L.n, stride = L.stride;
  const int k_end = KT > 0 ? KT : K;
#pragma unroll
  for (int q0 = 0; q0 < NV; q0 += NG) {
    long long e[NG];
    float acc[NG][EV];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      e[j] = base + (static_cast<long long>(q0 + j) * kThreads + threadIdx.x) * EV;
#pragma unroll
      for (int i = 0; i < EV; ++i) acc[j][i] = 0.0f;
    }
    for (int k0 = 0; k0 < k_end; k0 += G) {
      V v[NG][G];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (e[j] < n) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (KT > 0 || k0 + g < K)
              v[j][g] = __ldg(reinterpret_cast<const V*>(x + (k0 + g) * stride + e[j]));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (KT > 0 || k0 + g < K) {
          const float wk = __ldg(w + k0 + g);
#pragma unroll
          for (int j = 0; j < NG; ++j)
#pragma unroll
            for (int i = 0; i < EV; ++i)
              acc[j][i] = fmaf(wk, elem<T, VB>(v[j][g], i), acc[j][i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (e[j] < n) *reinterpret_cast<V*>(out + e[j]) = pack<T, VB>(acc[j]);
  }
}

template <typename T, int KT>
__device__ __forceinline__ void tile_of(const Leaf& L, const float* w, int K, long long t) {
  const long long base = t * (kTileBytes / static_cast<long long>(sizeof(T)));
  const int vb = 1 << (L.flags >> kVecShift);
  if (vb == 16)
    vector_tile<T, KT, 16>(L, w, K, base);
  else if (vb == 8)
    vector_tile<T, KT, 8>(L, w, K, base);
  else if (sizeof(T) == 4 || vb == 4)
    vector_tile<T, KT, 4>(L, w, K, base);
  else if constexpr (sizeof(T) == 2)
    vector_tile<T, KT, 2>(L, w, K, base);
}

template <int KT, int CAP>
__global__ void __launch_bounds__(kThreads)
aggregate_leaves_kernel(const __grid_constant__ Table<CAP> table) {
  // this block's leaf: the last whose first tile is at or before blockIdx.x
  const int tile = static_cast<int>(blockIdx.x);
  int lo = 0, hi = table.num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = table.leaf[lo];
  const long long t = tile - L.tile0;
  if (L.flags & kBf16)
    tile_of<__nv_bfloat16, KT>(L, table.w, table.K, t);
  else
    tile_of<float, KT>(L, table.w, table.K, t);
}

template <int KT, int CAP>
cudaError_t launch_table(const void* packed, int num_leaves, int grid, cudaStream_t stream) {
  Table<CAP> table;
  memcpy(&table, packed, offsetof(Table<CAP>, leaf) + num_leaves * sizeof(Leaf));
  aggregate_leaves_kernel<KT, CAP><<<grid, kThreads, 0, stream>>>(table);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_k(const void* packed, int num_leaves, int grid, cudaStream_t stream) {
  if (num_leaves <= kSmallCap) return launch_table<KT, kSmallCap>(packed, num_leaves, grid, stream);
  return launch_table<KT, kLargeCap>(packed, num_leaves, grid, stream);
}

}  // namespace

extern "C" {

// One launch over the packed table `packed` (header "<Qii": w, K, num_leaves;
// then num_leaves leaves "<QQqqii"), `grid` tiles, on `stream`.
int aggregate_leaves(const void* packed, int grid, void* stream) {
  int K, num_leaves;
  memcpy(&K, static_cast<const char*>(packed) + 8, sizeof(int));
  memcpy(&num_leaves, static_cast<const char*>(packed) + 12, sizeof(int));
  if (K < 1 || num_leaves < 1 || num_leaves > kLargeCap || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K) {
    case 1: err = launch_k<1>(packed, num_leaves, grid, s); break;
    case 2: err = launch_k<2>(packed, num_leaves, grid, s); break;
    case 3: err = launch_k<3>(packed, num_leaves, grid, s); break;
    case 4: err = launch_k<4>(packed, num_leaves, grid, s); break;
    case 5: err = launch_k<5>(packed, num_leaves, grid, s); break;
    case 6: err = launch_k<6>(packed, num_leaves, grid, s); break;
    case 7: err = launch_k<7>(packed, num_leaves, grid, s); break;
    case 8: err = launch_k<8>(packed, num_leaves, grid, s); break;
    default: err = launch_k<0>(packed, num_leaves, grid, s); break;
  }
  return static_cast<int>(err);
}

// The layout the planner in kernels/aggregate.py must follow.
int aggregate_tile_bytes(void) { return kTileBytes; }
int aggregate_max_leaves(void) { return kLargeCap; }

const char* aggregate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
