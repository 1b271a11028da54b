// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd_scan (body
// _ssd_kernel).  For x (B, S, H, P), dt (B, S, H), A (H,) and B, C (B, S, G, N),
// H % G == 0, head h reading the B/C group h / (H / G), it computes the
// recurrence
//
//     state_t = exp(dt_t A_h) state_{t-1} + (x_t dt_t) (x) B_t     (P x N)
//     y_t     = state_t . C_t
//
// chunk by chunk, as the TPU kernel does: within a tile of Q steps, with
// a = dt A and c = cumsum a over the tile,
//
//     y     = (C B^T o L)(x dt) + exp(c) o (C state^T),  L[i][j] = exp(c_i - c_j), i >= j
//     state = exp(c_last) state + (x dt o exp(c_last - c))^T B
//
// All arithmetic is float32; x, B and C are float or bfloat16, dt, A and the
// states float32; y is written in x's type.  Unlike the TPU kernel, it takes an
// initial state (or zeros) and writes the final state (B, H, P, N), so one
// launch gives both.  x, dt, B and C are read in place through their batch,
// sequence and head (group) strides (the last axis is contiguous): in the
// model they are views into the convolution's output, whose rows are wider
// than H * P.
//
// Bound: at mamba2-780m's prefill shape the four products of a 128-step chunk
// do 2Q^2 N + 2Q^2 P + 4QPN operations for 2(P + 2N) + 4 bytes of input and
// output per step and head in bfloat16, about 290 operations a byte: at the
// card's balance point, so bytes and operations bound it about equally
// (0.034 ms against 0.033 ms).  This first kernel does the products on the
// CUDA cores in float32 (fused multiply-adds from shared memory), not on the
// tensor cores: simple and right first, with mma/wgmma, sharing C B^T across
// the heads of a group, and TMA left for a later change.
//
// Design:
//   * One block of 256 threads per (head, batch).  Blocks run in no order, so
//     the block walks the sequence itself, tile after tile, and keeps the
//     (P, N) state in shared memory from one tile to the next: this loop takes
//     the place of the TPU kernel's sequential chunk axis and its VMEM state.
//   * The tile is kTile = 64 steps, whatever chunk the caller names: the scan's
//     result does not depend on the chunking beyond rounding, a 64-step tile
//     keeps the block's float32 tiles in 133 KB of shared memory at N = 128
//     (a 128-step tile would need about 256 KB, more than a block may have),
//     and it halves the largest |cumsum a| that a decay is taken from.
//   * Per tile: dt, x dt, B and C are staged in shared memory (rows padded by
//     one word, so 16 threads reading 16 rows hit 16 banks), warp 0 takes the
//     prefix sum of a with shuffles, then three passes: the masked scores
//     C B^T o L (Q x Q), y (Q x P) from the scores and the carried state, and
//     the state update (P x N).  Thread (ty, tx) owns rows ty + 16 i and
//     columns tx + 16 j of each output tile.
//   * Any S: steps at or past S load as zeros (dt = 0: decay 1, no input), so
//     they leave the state as it is, and their rows of y are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRows = kTile / 16;     // rows of a tile each thread owns
constexpr int kMaxN = 128;

struct Params {
  int B, S, H, G, N;
  long long x_sb, x_ss, x_sh;         // element strides of batch, seq, head
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int has_init;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, Params p) {
  constexpr int CP = (P + 15) / 16;   // columns of y each thread owns
  constexpr int XS = P;               // row stride of x dt (column reads are contiguous)
  constexpr int SS = kTile + 1;       // padded row stride of the scores
  const int N = p.N;
  const int NS = N + 1;               // padded row stride of B, C and the state

  extern __shared__ float smem[];
  float* Bs = smem;                   // (kTile, NS)
  float* Cs = Bs + kTile * NS;        // (kTile, NS)
  float* St = Cs + kTile * NS;        // (P, NS), the carried state
  float* Xs = St + P * NS;            // (kTile, XS), x dt
  float* Ss = Xs + kTile * XS;        // (kTile, SS), masked scores
  float* as = Ss + kTile * SS;        // a = dt A
  float* cum = as + kTile;            // cumsum a within the tile
  float* ecum = cum + kTile;          // exp(cum)
  float* wend = ecum + kTile;         // exp(cum_last - cum)
  float* dts = wend + kTile;          // dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float a_h = A[h];

  const T* xb = x + b * p.x_sb + h * p.x_sh;
  const float* dtb = dt + b * p.dt_sb + h * p.dt_sh;
  const T* bb = Bm + b * p.b_sb + g * p.b_sg;
  const T* cb = Cm + b * p.c_sb + g * p.c_sg;
  const long long state_off = (static_cast<long long>(b) * p.H + h) * P * N;

  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int pi = idx / N, n = idx - pi * N;
    St[pi * NS + n] = p.has_init ? init[state_off + idx] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += kTile) {
    __syncthreads();                  // the previous tile is no longer read
    for (int t = tid; t < kTile; t += kThreads) {
      const int s = t0 + t;
      const float d = s < p.S ? dtb[s * p.dt_ss] : 0.f;
      dts[t] = d;
      as[t] = d * a_h;
    }
    for (int idx = tid; idx < kTile * N; idx += kThreads) {
      const int t = idx / N, n = idx - t * N;
      const int s = t0 + t;
      const bool in = s < p.S;
      Bs[t * NS + n] = in ? to_f32(bb[s * p.b_ss + n]) : 0.f;
      Cs[t * NS + n] = in ? to_f32(cb[s * p.c_ss + n]) : 0.f;
    }
    __syncthreads();                  // dt is staged
    for (int idx = tid; idx < kTile * P; idx += kThreads) {
      const int t = idx / P, pi = idx - t * P;
      const int s = t0 + t;
      Xs[t * XS + pi] = s < p.S ? to_f32(xb[s * p.x_ss + pi]) * dts[t] : 0.f;
    }
    if (tid < 32) {                   // prefix sum of a over the tile, two steps a lane
      const float a0 = as[2 * tid], a1 = as[2 * tid + 1];
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);   // the earlier lanes' sum
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0;
      const float c1 = c0 + a1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      wend[2 * tid] = expf(last - c0);
      wend[2 * tid + 1] = expf(last - c1);
    }
    __syncthreads();

    // 1. scores[i][j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j, else 0
    {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRows], bv[4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          Ss[i * SS + j] = i >= j ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y[i][p] = sum_j scores[i][j] xdt[j][p] + exp(cum_i) (C_i . state_p)
    {
      float yd[kRows][CP], yo[kRows][CP];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) yd[r][c] = yo[r][c] = 0.f;
      const bool col_ok = tx < P;     // P = 8 leaves half the columns idle
      if (col_ok) {
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float sv[kRows], xv[CP];
#pragma unroll
          for (int r = 0; r < kRows; ++r) sv[r] = Ss[(ty + 16 * r) * SS + j];
#pragma unroll
          for (int c = 0; c < CP; ++c) xv[c] = Xs[j * XS + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < CP; ++c) yd[r][c] = fmaf(sv[r], xv[c], yd[r][c]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kRows], sv[CP];
#pragma unroll
          for (int r = 0; r < kRows; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
          for (int c = 0; c < CP; ++c) sv[c] = St[(tx + 16 * c) * NS + n];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < CP; ++c) yo[r][c] = fmaf(cv[r], sv[c], yo[r][c]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = ty + 16 * r;
          const int s = t0 + i;
          if (s >= p.S) continue;
          T* yrow = y + ((static_cast<long long>(b) * p.S + s) * p.H + h) * P;
#pragma unroll
          for (int c = 0; c < CP; ++c)
            store(yrow + tx + 16 * c, yd[r][c] + ecum[i] * yo[r][c]);
        }
      }
    }
    __syncthreads();                  // every read of the old state is done

    // 3. state[p][n] = exp(cum_last) state[p][n] + sum_q xdt[q][p] exp(cum_last - cum_q) B[q][n]
    {
      const float decay = ecum[kTile - 1];
      for (int idx = tid; idx < P * N; idx += kThreads) {
        const int pi = idx / N, n = idx - pi * N;
        float acc = 0.f;
#pragma unroll 8
        for (int q = 0; q < kTile; ++q)
          acc = fmaf(Xs[q * XS + pi] * wend[q], Bs[q * NS + n], acc);
        St[pi * NS + n] = fmaf(decay, St[pi * NS + n], acc);
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int pi = idx / N, n = idx - pi * N;
    final_state[state_off + idx] = St[pi * NS + n];
  }
}

template <typename T, int P>
cudaError_t launch(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
                   const float* init, T* y, float* fin, const Params& p, cudaStream_t stream) {
  const int NS = p.N + 1;
  const size_t smem =
      sizeof(float) * (2 * kTile * NS + P * NS + kTile * P + kTile * (kTile + 1) + 5 * kTile);
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, init, y, fin, p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
        const void* init, void* y, void* fin, int B, int S, int H, int G, int P, int N,
        long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
        long long dt_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,
        long long c_ss, long long c_sg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, N, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, init != nullptr};
  const T* xt = static_cast<const T*>(x);
  const float* dtt = static_cast<const float*>(dt);
  const float* At = static_cast<const float*>(A);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* it = static_cast<const float*>(init);
  T* yt = static_cast<T*>(y);
  float* ft = static_cast<float*>(fin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (P) {
    case 8: err = launch<T, 8>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
    case 16: err = launch<T, 16>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
    case 32: err = launch<T, 32>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
    case 64: err = launch<T, 64>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define SSD_ARGS                                                                        \
  const void *x, const void *dt, const void *A, const void *Bm, const void *Cm,         \
      const void *init, void *y, void *fin, int B, int S, int H, int G, int P, int N,   \
      long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, \
      long long dt_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,  \
      long long c_ss, long long c_sg, void *stream
#define SSD_PASS                                                                        \
  x, dt, A, Bm, Cm, init, y, fin, B, S, H, G, P, N, x_sb, x_ss, x_sh, dt_sb, dt_ss,     \
      dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, stream

int ssd_scan_f32(SSD_ARGS) { return run<float>(SSD_PASS); }

int ssd_scan_bf16(SSD_ARGS) { return run<__nv_bfloat16>(SSD_PASS); }

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
