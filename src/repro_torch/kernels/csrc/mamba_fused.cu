// The Mamba2 block's elementwise chains on the prefill path, fused, for
// Hopper (sm_90a): two kernels, each reading its inputs once, in place through
// their strides, computing in float32 registers and rounding once, as it
// stores.
//
// Neither replaces a TPU kernel: the reference leaves these chains to XLA,
// which fuses elementwise work on its own.  In the port they ran as PyTorch's
// elementwise kernels, one pass over device memory per operation: ~2.5 s of a
// 3.22 s prefill call of 128 x 2048 tokens of mamba2-780m on an H100, against
// 0.25 s for the scan (PERF.md §5).  Both kernels are bound by bytes (a few
// operations per element), so what they do about the bound is move each byte
// once: 16-byte loads and stores, neighbouring threads on neighbouring bytes,
// every input read once (the conv's window of 3 earlier rows aside), no
// intermediate in device memory.  N below is batch x sequence, 262,144 at the
// benchmark's prefill shape.
//
// K4 causal_conv_silu_kernel.  For x (B, S, C), read through its batch and
// sequence strides (the x|B|C columns of the in_proj output: rows 6,448
// elements apart at mamba2-780m, starting 3,072 in), taps w (4, C) (the conv
// width of every configuration) and bias (C,), it writes the contiguous
// (B, S, C)
//
//     out[b, t, c] = silu(bias[c] + sum_i w[i, c] x[b, t - 3 + i, c])
//
// with x read as zero before t = 0 of each sequence (the zero history of a
// prefill).  It replaces two concatenations, 4 strided multiplies, 4 adds, a
// bias add and a SiLU, each a pass over N x C.  Bound at mamba2-780m's
// prefill shape: N C (2 + 2) bytes = 3.49 GB, 1.04 ms at 3.35 TB/s.  Design:
// a thread takes 8 channels (16 bytes of bf16) for a run of kRun positions of
// one sequence, so no run crosses a sequence boundary; it walks the run with a
// window of the last 3 raw rows in registers, loading kStep rows at once
// (each input row is read once, the 3 rows before a run's start a second
// time: 3 in 64); the taps and bias stay in float32 registers.  Consecutive
// threads take consecutive 16 bytes of a row.
//
// K5 gated_rmsnorm_kernel.  For rows y (B, S, E) and, optionally, the skip x
// (B, S, E) with its per-head weight D (H,), head h covering E / H columns,
// and the gate z (B, S, E), each read through its own strides, it writes the
// contiguous (B, S, E)
//
//     t = (y + D[c / (E / H)] x) * silu(z),    out = t rsqrt(mean(t^2) + eps) scale
//
// the mean taken over each of G groups of E / G columns on its own (the
// published Mamba2 norm, RMSNormGated with group_size = d_inner / ngroups; G
// = 1, the whole row, for one group and for the input norm), the skip and the
// gate left out where their pointers are null: with neither, it is the
// block's input RMSNorm.  One block of up to 128 threads takes one group of
// one row, each thread up to kMaxVecs 16-byte vectors of it, issues every load
// of the row before any arithmetic, keeps t in float32 registers, and sums t^2
// with warp shuffles and one shared-memory step.  Bound at mamba2-780m's
// prefill shape: gated, N E (2 + 2 + 2 + 2) bytes at E = 3,072, 6.44 GB, 1.92
// ms; as the input norm, N E (2 + 2) at E = 1,536, 1.61 GB, 0.48 ms.  It
// replaces a strided multiply, an add, a strided SiLU, a multiply and the six
// float32 passes of the norm (upcast, square, mean, two scalings, downcast).
//
// Both take float32 or bfloat16 activations; the taps, bias and D come in the
// activations' type (as the plain chain rounds them), the norm's scale in
// float32 (the plain norm multiplies by it in float32).  Rows start on 16-byte
// boundaries and widths are whole 16-byte vectors; the wrapper
// (kernels/mamba_fused.py) checks both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConvThreads = 256;
constexpr int kRun = 64;          // positions of one sequence a conv thread walks
constexpr int kStep = 4;          // rows a conv thread loads at once
constexpr int kWidth = 4;         // conv taps
constexpr int kNormThreads = 128; // most threads on one normalised row
constexpr int kMaxVecs = 8;       // most 16-byte vectors of a row a thread holds

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float scalar(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // element 2i in the low half of word i (little-endian)
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[kN]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(uint32_t));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float scalar(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// --- K4 -------------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
causal_conv_silu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out, int S, int C,
                        long long sb, long long ss, int runs, long long items) {
  using P = Pack<T>;
  constexpr int kN = P::kN;
  const long long item = static_cast<long long>(blockIdx.x) * kConvThreads + threadIdx.x;
  if (item >= items) return;
  const int cvec = C / kN;
  const int c0 = static_cast<int>(item % cvec) * kN;
  const long long run = item / cvec;
  const long long b = run / runs;
  const int t0 = static_cast<int>(run % runs) * kRun;
  const int t1 = min(t0 + kRun, S);

  float wt[kWidth][kN], bs[kN];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) P::unpack(load16(w + i * C + c0), wt[i]);
  P::unpack(load16(bias + c0), bs);

  const T* xr = x + b * sb + c0;
  T* orow = out + b * S * C + c0;
  uint4 win[kWidth - 1 + kStep];  // raw rows t - 3 .. t + kStep - 1
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) {
    const int t = t0 - (kWidth - 1) + j;
    win[j] = t >= 0 ? load16(xr + t * ss) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int t = t0; t < t1; t += kStep) {
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      if (t + u < t1) win[kWidth - 1 + u] = load16(xr + (t + u) * ss);
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      if (t + u < t1) {
        float acc[kN];
#pragma unroll
        for (int c = 0; c < kN; ++c) acc[c] = 0.0f;
#pragma unroll
        for (int i = 0; i < kWidth; ++i) {
          float v[kN];
          P::unpack(win[u + i], v);
#pragma unroll
          for (int c = 0; c < kN; ++c) acc[c] = fmaf(wt[i][c], v[c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kN; ++c) acc[c] = silu(acc[c] + bs[c]);
        store16(orow + static_cast<long long>(t + u) * C, P::pack(acc));
      }
    }
#pragma unroll
    for (int j = 0; j < kWidth - 1; ++j) win[j] = win[kStep + j];
  }
}

template <typename T>
int run_conv(const void* x, const void* w, const void* bias, void* out, int B, int S, int C,
             int W, long long sb, long long ss, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || C % Pack<T>::kN != 0 || W != kWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (S + kRun - 1) / kRun;
  const long long items = static_cast<long long>(B) * runs * (C / Pack<T>::kN);
  const long long blocks = (items + kConvThreads - 1) / kConvThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  causal_conv_silu_kernel<T><<<static_cast<unsigned>(blocks), kConvThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), S, C, sb, ss, runs, items);
  return static_cast<int>(cudaGetLastError());
}

// --- K5 -------------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(kNormThreads)
gated_rmsnorm_kernel(const T* __restrict__ y, const T* __restrict__ x,
                     const T* __restrict__ D, const T* __restrict__ z,
                     const float* __restrict__ scale, T* __restrict__ out, int S,
                     int G, int E, int hcols, float eps, long long y_sb, long long y_ss,
                     long long x_sb, long long x_ss, long long z_sb, long long z_ss) {
  using P = Pack<T>;
  constexpr int kN = P::kN;
  // block: group g of row (b, s); E is the group's width, col0 its first column
  const long long row = blockIdx.x;
  const int col0 = static_cast<int>(row % G) * E;
  const long long b = row / G / S, s = row / G % S;
  const T* yr = y + b * y_sb + s * y_ss + col0;
  const T* xr = x != nullptr ? x + b * x_sb + s * x_ss + col0 : nullptr;
  const T* zr = z != nullptr ? z + b * z_sb + s * z_ss + col0 : nullptr;

  uint4 ry[V], rx[V], rz[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c0 = (threadIdx.x + k * blockDim.x) * kN;
    if (c0 < E) {
      ry[k] = load16(yr + c0);
      if (xr != nullptr) rx[k] = load16(xr + c0);
      if (zr != nullptr) rz[k] = load16(zr + c0);
    }
  }

  float t[V][kN];
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c0 = (threadIdx.x + k * blockDim.x) * kN;
    if (c0 < E) {
      P::unpack(ry[k], t[k]);
      if (xr != nullptr) {
        float v[kN];
        P::unpack(rx[k], v);
        const float d = P::scalar(D[(col0 + c0) / hcols]);   // a vector lies in one head
#pragma unroll
        for (int c = 0; c < kN; ++c) t[k][c] = fmaf(d, v[c], t[k][c]);
      }
      if (zr != nullptr) {
        float v[kN];
        P::unpack(rz[k], v);
#pragma unroll
        for (int c = 0; c < kN; ++c) t[k][c] *= silu(v[c]);
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) sq = fmaf(t[k][c], t[k][c], sq);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  __shared__ float part[kNormThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = sq;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) total += part[i];
  const float inv = rsqrtf(total / static_cast<float>(E) + eps);

  T* orow = out + row * E;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c0 = (threadIdx.x + k * blockDim.x) * kN;
    if (c0 < E) {
      float sc[kN];
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(scale + col0 + c0) + q);
        sc[4 * q] = f.x;
        sc[4 * q + 1] = f.y;
        sc[4 * q + 2] = f.z;
        sc[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) t[k][c] = t[k][c] * inv * sc[c];
      store16(orow + c0, P::pack(t[k]));
    }
  }
}

template <typename T, int V>
cudaError_t launch_norm(const T* y, const T* x, const T* D, const T* z, const float* scale,
                        T* out, long long rows, int S, int G, int E, int hcols,
                        float eps, long long y_sb, long long y_ss, long long x_sb,
                        long long x_ss, long long z_sb, long long z_ss, int threads,
                        cudaStream_t stream) {
  gated_rmsnorm_kernel<T, V><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      y, x, D, z, scale, out, S, G, E, hcols, eps, y_sb, y_ss, x_sb, x_ss, z_sb, z_ss);
  return cudaGetLastError();
}

template <typename T>
int run_norm(const void* y, const void* x, const void* D, const void* z, const void* scale,
             void* out, int B, int S, int E, int H, int G, float eps, long long y_sb,
             long long y_ss, long long x_sb, long long x_ss, long long z_sb, long long z_ss,
             void* stream) {
  constexpr int kN = Pack<T>::kN;
  // one block a group of a row
  const long long rows = static_cast<long long>(B) * S * G;
  if (B <= 0 || S <= 0 || E <= 0 || G <= 0 || E % G != 0 || (E / G) % kN != 0 ||
      rows > 0x7fffffffLL || (x == nullptr) != (D == nullptr) ||
      (D != nullptr && (H <= 0 || E % H != 0 || (E / H) % kN != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = E / G / kN;
  const int vecs = (nvec + kNormThreads - 1) / kNormThreads;      // per thread
  const int threads = ((nvec + vecs - 1) / vecs + 31) / 32 * 32;
  const int hcols = D != nullptr ? E / H : E;
  const T* yt = static_cast<const T*>(y);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(D);
  const T* zt = static_cast<const T*>(z);
  const float* sct = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NORM_CASE(V)                                                                      \
  case V:                                                                                 \
    return static_cast<int>(launch_norm<T, V>(yt, xt, dt, zt, sct, ot, rows, S, G,           \
                                              E / G, hcols, eps, y_sb, y_ss, x_sb, x_ss,     \
                                              z_sb, z_ss, threads, st));
  switch (vecs) {
    NORM_CASE(1) NORM_CASE(2) NORM_CASE(3) NORM_CASE(4)
    NORM_CASE(5) NORM_CASE(6) NORM_CASE(7) NORM_CASE(kMaxVecs)
  }
#undef NORM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CONV_ARGS                                                                         \
  const void *x, const void *w, const void *bias, void *out, int B, int S, int C, int W,  \
      long long sb, long long ss, void *stream
#define CONV_PASS x, w, bias, out, B, S, C, W, sb, ss, stream
#define NORM_ARGS                                                                         \
  const void *y, const void *x, const void *D, const void *z, const void *scale,          \
      void *out, int B, int S, int E, int H, int G, float eps, long long y_sb,            \
      long long y_ss, long long x_sb, long long x_ss, long long z_sb, long long z_ss,     \
      void *stream
#define NORM_PASS                                                                         \
  y, x, D, z, scale, out, B, S, E, H, G, eps, y_sb, y_ss, x_sb, x_ss, z_sb, z_ss,         \
      stream

extern "C" {

int causal_conv_silu_f32(CONV_ARGS) { return run_conv<float>(CONV_PASS); }
int causal_conv_silu_bf16(CONV_ARGS) { return run_conv<__nv_bfloat16>(CONV_PASS); }
int gated_rmsnorm_f32(NORM_ARGS) { return run_norm<float>(NORM_PASS); }
int gated_rmsnorm_bf16(NORM_ARGS) { return run_norm<__nv_bfloat16>(NORM_PASS); }

const char* mamba_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
