// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py::flash_attention
// (body _flash_kernel).  For q (B, S, H, D) and k, v (B, S, G, D), H % G == 0,
// query head h reads key/value head h / (H / G) (no replication of K or V):
//
//     s[q, k] = (q . k) / sqrt(D), then cap * tanh(s / cap) with a soft cap
//     visible  = (!causal || q >= k) && (!window || q - k < window) && k < S
//     out[q]   = sum_k softmax_k(s[q, :] over visible k) * v[k]
//
// in float32 (scores, running max, denominator, accumulator), written in the
// inputs' type (float or bfloat16).  The tensors are read in place through
// their batch, sequence and head strides; the last axis is contiguous.
//
// Bound: at the serving shapes (S in the thousands, D = 256) the work is
// 4 * D operations per visible (q, k) pair against 2 * D elements of q and o
// per row, far above the card's operations-per-byte balance, so the bound is
// the arithmetic.  This first kernel does that arithmetic on the CUDA cores
// in float32 (fused multiply-adds), not on the tensor cores: simple and right
// first, with wgmma, TMA and warp specialisation left for a later change.
//
// Design:
//   * One block of 256 threads (16 x 16) per (64-row q tile, head, batch).
//     Blocks run in no order; a loop over kv tiles inside the block takes the
//     place of the TPU kernel's sequential kv grid axis.  Under a causal mask
//     the longest q tiles are launched first.
//   * The q tile and each K and V tile are staged in shared memory as 32-bit
//     words (one float or two bfloat16), rows padded by one word so that the
//     16 threads of a half-warp reading 16 rows hit 16 different banks.
//   * Thread (ty, tx) owns q rows ty + 16 i (i < 4), score columns
//     tx + 16 j and output words tx + 16 w.  Row maxima and sums are reduced
//     over the 16 tx lanes with warp shuffles; each thread keeps the running
//     max and denominator of its four rows.
//   * kv tiles wholly outside the causal / window band are skipped, not
//     streamed.  Masked scores are -inf, with the max guarded so a row that
//     has seen no visible key yet adds nothing (the TPU kernel's finite -1e30
//     gives the same result wherever a row has a visible key, and every row
//     has one: its own position).
//   * Any S: rows and keys past S are zero-filled in shared memory, masked,
//     and not written.  No padding copy and no fallback.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;   // q rows per thread

struct Params {
  int B, S, H, G;
  long long q_sb, q_ss, q_sh;         // element strides of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  int window;                         // 0: no window
  float soft_cap;                     // 0: no cap
  float scale;
};

template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kElems = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static uint32_t pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kElems = 2;
  // the element at the lower address is the low half (little endian)
  __device__ __forceinline__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pack(const float* v) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);  // round to nearest even
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// rows [s0, s0 + rows) of one head into shared memory, row stride W + 1 words;
// rows at or past S are zero
template <int W>
__device__ __forceinline__ void load_tile(uint32_t* dst, int rows, const uint32_t* base,
                                          long long row_words, int s0, int S) {
  for (int idx = threadIdx.x; idx < rows * W; idx += kThreads) {
    const int r = idx / W;
    const int w = idx - r * W;
    const int s = s0 + r;
    dst[r * (W + 1) + w] = s < S ? __ldg(base + s * row_words + w) : 0u;
  }
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int E = Word<T>::kElems;
  constexpr int W = D / E;            // words per row
  constexpr int SW = W + 1;           // padded row stride in shared memory
  constexpr int CJ = BK / 16;         // score columns per thread
  constexpr int OW = W / 16;          // output words per thread and row
  constexpr int PS = BK + 1;          // padded row stride of the probabilities
  constexpr int WB = sizeof(uint32_t) / sizeof(T);

  extern __shared__ uint32_t smem[];
  uint32_t* Qs = smem;
  uint32_t* Ks = Qs + kBlockQ * SW;
  uint32_t* Vs = Ks + BK * SW;
  float* Ps = reinterpret_cast<float*>(Vs + BK * SW);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int q0 = qt * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const uint32_t* qb = reinterpret_cast<const uint32_t*>(q + b * p.q_sb + h * p.q_sh);
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k + b * p.k_sb + g * p.k_sh);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + b * p.v_sb + g * p.v_sh);
  load_tile<W>(Qs, kBlockQ, qb, p.q_ss / WB, q0, p.S);

  float acc[kRows][OW * E];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OW * E; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that hold a visible key for some row of this q tile
  const int q_last = min(q0 + kBlockQ, p.S) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int kt_end = (k_end + BK - 1) / BK;

  for (int kt = k_begin / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // the previous tile is no longer read
    load_tile<W>(Ks, BK, kb, p.k_ss / WB, k0, p.S);
    load_tile<W>(Vs, BK, vb, p.v_ss / WB, k0, p.S);
    __syncthreads();

    float s[kRows][CJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      float qv[kRows][E], kv[CJ][E];
#pragma unroll
      for (int i = 0; i < kRows; ++i) Word<T>::unpack(Qs[(ty + 16 * i) * SW + w], qv[i]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) Word<T>::unpack(Ks[(tx + 16 * j) * SW + w], kv[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
        const bool visible = kpos < p.S && (!p.causal || qpos >= kpos) &&
                             (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = visible ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);   // 0 while the row has seen nothing
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OW * E; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < CJ; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jw = 0; jw < OW; ++jw) {
        float vv[E];
        Word<T>::unpack(Vs[c * SW + tx + 16 * jw], vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][jw * E + e] = fmaf(pv[i], vv[e], acc[i][jw * E + e]);
      }
    }
  }

  // o is contiguous (B, S, H, D)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + ((static_cast<long long>(b) * p.S + qpos) * p.H + h) * D);
#pragma unroll
    for (int jw = 0; jw < OW; ++jw) {
      float vals[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vals[e] = acc[i][jw * E + e] * inv;
      orow[tx + 16 * jw] = Word<T>::pack(vals);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, const Params& p,
                   cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;       // keeps a float32 D=256 block in 140 KB
  constexpr int SW = D / Word<T>::kElems + 1;
  constexpr int smem = ((kBlockQ + 2 * BK) * SW + kBlockQ * (BK + 1)) * 4;
  auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
        int G, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
        int causal, int window, float soft_cap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, soft_cap, 1.0f / sqrtf(static_cast<float>(D))};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<T, 32>(qt, kt, vt, ot, p, st); break;
    case 64: err = launch<T, 64>(qt, kt, vt, ot, p, st); break;
    case 128: err = launch<T, 128>(qt, kt, vt, ot, p, st); break;
    case 256: err = launch<T, 256>(qt, kt, vt, ot, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define FLASH_ARGS                                                                   \
  const void *q, const void *k, const void *v, void *o, int B, int S, int H, int G,  \
      int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,         \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, \
      int causal, int window, float soft_cap, void *stream
#define FLASH_PASS                                                                   \
  q, k, v, o, B, S, H, G, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   \
      causal, window, soft_cap, stream

int flash_attention_f32(FLASH_ARGS) { return run<float>(FLASH_PASS); }

int flash_attention_bf16(FLASH_ARGS) { return run<__nv_bfloat16>(FLASH_PASS); }

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
