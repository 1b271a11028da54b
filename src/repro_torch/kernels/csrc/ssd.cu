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
// chunk by chunk, as the TPU kernel does: within a tile of Q = 64 steps, with
// a = dt A and c = cumsum a over the tile,
//
//     y     = (C B^T o L)(x dt) + exp(c) o (C state^T),  L[i][j] = exp(c_i - c_j), i >= j
//     state = exp(c_last) state + (x dt o exp(c_last - c))^T B
//
// dt, A and the states are float32; y is written in x's type.  Unlike the TPU
// kernel, it takes an initial state (or zeros) and writes the float32 final
// state (B, H, P, N), so one launch gives both.  x, dt, B and C are read in
// place through their batch, sequence and head (group) strides (the last axis
// is contiguous): in the model they are views into the convolution's output,
// whose rows are wider than H * P.  Any S: steps at or past S read as zeros
// (dt = 0: decay 1, no input), so they leave the state as it is, and their
// rows of y are not written.  The tile is 64 steps whatever chunk the caller
// names: the result does not depend on the chunking beyond rounding.
//
// Bound: at mamba2-780m's prefill shape the four products of a 128-step chunk
// do 2Q^2 N + 2Q^2 P + 4QPN operations for 2(P + 2N) + 4 bytes of input and
// output per step and head in bfloat16, about 290 operations a byte: at the
// card's balance point, so bytes and operations bound it about equally
// (0.034 ms against 0.033 ms).  What the kernel has to beat is the chain of
// chunks: each chunk's products need the state the previous one left.
//
// bfloat16 (serving): ssd_scan_tc_kernel, all four products on the tensor cores.
//   * One warpgroup (128 threads) per (32 columns of P, head, batch).  The
//     state's rows are independent (y[:, p] and state[p, :] depend on x[:, p]
//     alone), so the head dimension is split across blocks, which walk the
//     chunks with no hand-off between them: 2 H B blocks at P = 64 (384 at
//     mamba2's prefill, 96 at B = 1), where one block per head would leave
//     the SMs idle at B = 1.  The price is C B^T o L once per slice.  This
//     was taken over chunk-parallel passes, which hand the state from chunk
//     to chunk through global memory and order the blocks by flags.
//   * G = C B^T is wgmma m64n64k16 with C (K-major A) and the B tile (K-major
//     B) read from shared memory, as Q K^T in flash.cu.  In registers it takes
//     L and the column factor dt_j, one ex2 an element of exp2((c_i - c_j)
//     log2 e) (never exp(c_i) exp(-c_j): at the model's scale the prefix sums
//     reach the hundreds and exp(-c_j) overflows), and becomes the A fragment
//     S' of the next product.
//   * y = exp(c_i) (C state^T) + S' x in two float32 accumulators: C state^T
//     with the state's parts as the MN-major B operand, S' x with S' from
//     registers and the x tile as the MN-major B operand (m64n32k16); y is
//     rounded to bf16 once, as it is stored.
//   * The state update takes M = N (64 or 128 rows, so P's 32 columns are not
//     padding): state^T = exp(c_last) state^T + B^T (x w), B^T the MN-major A
//     read from the B tile, w_t = dt_t exp(c_last - c_t) folded into x (B is
//     shared by the heads of a group, x is this head's).  The state stays in
//     float32 registers, the accumulator of this product, from the first
//     chunk to the last.
//   * Three operands are float32 values: S', the state and x w.  Rounding any
//     one of them to bf16 once breaks the float32 limit the kernel is held to
//     (tests/test_torch_ssd.py emulates each), so each enters its products as
//     two bf16 parts, hi = bf16(v) and lo = bf16(v - hi), accumulated into one
//     float32 sum: S' in registers, the state and x w written to shared memory
//     in the 64-byte swizzle.  That is twice the tensor work of one rounding,
//     the kernel's cost and not the bound's.
//   * Copies are TMA: one thread issues the x (32 columns, 64-byte swizzle), B
//     and C (64-column blocks, 128-byte swizzle) boxes of a chunk into a
//     two-stage ring with full/empty mbarriers, so the next chunk lands while
//     this one computes; rows past S and columns past P or N are zero-filled.
//     dt (4 bytes a step) comes through plain loads one chunk ahead, and warp 0
//     takes the prefix sum of a with shuffles.  Two block barriers a chunk.
//   * P in {8, 16, 32} and N < 64 (the smoke configs) run the same code on
//     zero-padded tiles.  Rows start on 16-byte boundaries (strides a multiple
//     of 8 elements), as TMA requires.
//   * Budget at N = 128: 2 stages x (x 4 KB + B 16 KB + C 16 KB) + the state's
//     hi and lo 16 KB + x w's hi and lo 8 KB + 1 KB for alignment = 97 KB of
//     dynamic shared memory (at N = 64: 57 KB) and 2 KB static (the prefix
//     sums, double-buffered), so two blocks share an SM.  Registers per thread
//     (ptxas): 168 at N = 128, 142 at N <= 64, no spills.
//
// float32 (agreement checks): ssd_scan_kernel, the arithmetic on the CUDA cores
//   in float32 FMAs, since no tensor-core format keeps float32 to the limit
//   without splitting every operand.
//   * One block of 256 threads per (head, batch).  Blocks run in no order, so
//     the block walks the sequence itself, tile after tile, and keeps the
//     (P, N) state in shared memory from one tile to the next: this loop takes
//     the place of the TPU kernel's sequential chunk axis and its VMEM state.
//   * The float32 tiles need 133 KB of shared memory at N = 128.
//   * Per tile: dt, x dt, B and C are staged in shared memory (rows padded by
//     one word, so 16 threads reading 16 rows hit 16 banks), warp 0 takes the
//     prefix sum of a with shuffles, then three passes: the masked scores
//     C B^T o L (Q x Q), y (Q x P) from the scores and the carried state, and
//     the state update (P x N).  Thread (ty, tx) owns rows ty + 16 i and
//     columns tx + 16 j of each output tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// --- float32: the CUDA-core kernel ----------------------------------------------------

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
  int P;
  int x_slots, b_slots, c_slots;      // bf16: tensor-map dimensions of (seq, head, batch)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// --- bfloat16: the tensor-core kernel -------------------------------------------------

constexpr int kTcTile = 64;           // steps per chunk: wgmma's M
constexpr int kTcSlice = 32;          // columns of P per block
constexpr int kTcThreads = 128;       // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Thread t owns, in every accumulator, rows 16 (t / 32) + t % 32 / 4 (+ 8) of
// the 64 and columns 8 j + 2 (t % 4) (+ 1): register 4 j + e holds
// row + 8 (e / 2), column + e % 2.  The state accumulator st[m] holds rows
// n = 64 m + row of state^T (this slice's 32 columns of P).
template <int NB>                     // 64-column blocks of B and C: 1 (N <= 64) or 2 (N <= 128)
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ init,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ final_state, Params p) {
  constexpr int Q = kTcTile;
  constexpr int KS = 4 * NB;                        // depth-16 steps over N
  constexpr int X_BYTES = Q * kSwizzleRow64;        // x tile (Q x 32)
  constexpr int BC_BYTES = NB * Q * kSwizzleRow;    // B or C tile (Q x 64 NB)
  constexpr int STAGE_BYTES = X_BYTES + 2 * BC_BYTES;
  constexpr int ST_BYTES = NB * 64 * kSwizzleRow64; // one part of state^T (64 NB x 32)

  // full[2]: a stage has landed; empty[2]: all 4 warps are done with it
  __shared__ __align__(8) uint64_t bars[4];
  // per step of a chunk, double-buffered: c, exp(c), w = dt exp(c_last - c), dt
  __shared__ __align__(8) float cum_s[2][Q], ecum_s[2][Q], w_s[2][Q], dt_s[2][Q];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // stage s: x, B, C; then the state's hi and lo, then x w's hi and lo
  const uint32_t st_hi = base + 2 * STAGE_BYTES;
  const uint32_t st_lo = st_hi + ST_BYTES;
  const uint32_t xw_hi = st_lo + ST_BYTES;
  const uint32_t xw_lo = xw_hi + X_BYTES;
  const uint32_t full = smem_addr(&bars[0]);
  const uint32_t empty = smem_addr(&bars[2]);

  const int p0 = blockIdx.x * kTcSlice;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const int T = (p.S + Q - 1) / Q;
  const float a_h = A[h];
  const float* dtb = dt + b * p.dt_sb + h * p.dt_sh;
  const long long state_off = (static_cast<long long>(b) * p.H + h) * p.P * p.N;

  const bool producer = tid == 0;
  auto load = [&](int i) {
    const int stage = i & 1;
    const uint32_t xs = base + stage * STAGE_BYTES;
    mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
    tma_box(xs, &tx, p.x_slots, p0, i * Q, h, b, full + 8 * stage);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      tma_box(xs + X_BYTES + cb * Q * kSwizzleRow, &tb, p.b_slots, cb * 64, i * Q, g, b,
              full + 8 * stage);
      tma_box(xs + X_BYTES + BC_BYTES + cb * Q * kSwizzleRow, &tc, p.c_slots, cb * 64, i * Q, g, b,
              full + 8 * stage);
    }
  };
  // warp 0: dt of chunk i, two steps a lane
  auto load_dt = [&](int i, float (&d)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = i * Q + 2 * lane + e;
      d[e] = s < p.S ? dtb[s * p.dt_ss] : 0.f;
    }
  };
  // the state's bf16 parts, hi = bf16(v) and lo = bf16(v - hi), as state^T
  // (rows n, 32 columns of P) in the 64-byte swizzle: the B operand of C state^T
  float st[NB][16];
  auto write_state = [&]() {
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v0 = st[m][4 * j + 2 * r], v1 = st[m][4 * j + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
          const uint32_t off = tile64_offset(64 * m + row + 8 * r, j) + 2 * col;
          *reinterpret_cast<__nv_bfloat162*>(smem + (st_hi - base) + off) = hi;
          *reinterpret_cast<__nv_bfloat162*>(smem + (st_lo - base) + off) = lo;
        }
  };

#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = 64 * m + row + 8 * ((e >> 1) & 1);
      const int pp = p0 + 8 * (e >> 2) + col + (e & 1);
      st[m][e] = p.has_init && n < p.N && pp < p.P ? init[state_off + pp * p.N + n] : 0.f;
    }
  write_state();
  fence_proxy_async();
  float d_next[2];
  if (warp == 0) load_dt(0, d_next);
  if (producer) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(empty, 4);
    mbar_init(empty + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    load(0);
    if (T > 1) load(1);
  }

  for (int t = 0; t < T; ++t) {
    const int stage = t & 1;
    const int buf = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const uint32_t xs = base + stage * STAGE_BYTES;
    const uint32_t bs = xs + X_BYTES;
    const uint32_t cs = bs + BC_BYTES;

    if (warp == 0) {                  // prefix sum of a over the chunk
      const float d0 = d_next[0], d1 = d_next[1];
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);   // the earlier lanes' sum
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0;
      const float c1 = c0 + a1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      *reinterpret_cast<float2*>(&cum_s[buf][2 * lane]) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(&ecum_s[buf][2 * lane]) = make_float2(expf(c0), expf(c1));
      *reinterpret_cast<float2*>(&w_s[buf][2 * lane]) =
          make_float2(d0 * expf(last - c0), d1 * expf(last - c1));
      *reinterpret_cast<float2*>(&dt_s[buf][2 * lane]) = make_float2(d0, d1);
      if (t + 1 < T) load_dt(t + 1, d_next);
    }
    __syncthreads();                  // the prefix sums and this chunk's state are in place
    mbar_wait(full + 8 * stage, parity);

    // C state^T (yo) and G = C B^T on the tensor cores
    float yo[16], gs[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t da = wgmma_desc(cs + (kk / 4) * (Q * kSwizzleRow) + (kk % 4) * 32, 0,
                                     8 * kSwizzleRow);
      wgmma_ss_n32<0, 1>(yo, da, wgmma_desc(st_hi + kk * 16 * kSwizzleRow64, ST_BYTES,
                                            8 * kSwizzleRow64, kLayout64B), kk > 0);
      wgmma_ss_n32<0, 1>(yo, da, wgmma_desc(st_lo + kk * 16 * kSwizzleRow64, ST_BYTES,
                                            8 * kSwizzleRow64, kLayout64B), 1);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * (Q * kSwizzleRow) + (kk % 4) * 32;
      wgmma_ss_n64(gs, wgmma_desc(cs + off, 0, 8 * kSwizzleRow), wgmma_desc(bs + off, 0, 8 * kSwizzleRow),
                   kk > 0);
    }
    wgmma_commit();

    // x w in two bf16 parts, while the products run
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kTcThreads;           // 16-byte chunk idx % 4 of row idx / 4
      const int r = idx >> 2;
      const uint32_t off = tile64_offset(r, idx & 3);
      const uint4 raw_x = *reinterpret_cast<const uint4*>(smem + (xs - base) + off);
      const float w = w_s[buf][r];
      const uint32_t xin[4] = {raw_x.x, raw_x.y, raw_x.z, raw_x.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xin[k]));
        const float v0 = v.x * w, v1 = v.y * w;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(v0 - __low2float(h2), v1 - __high2float(h2));
        hi[k] = bf16x2_bits(h2);
        lo[k] = bf16x2_bits(l2);
      }
      *reinterpret_cast<uint4*>(smem + (xw_hi - base) + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(smem + (xw_lo - base) + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(yo);
    fence_regs(gs);

    // S' = G o L o dt_j in registers, as the A fragments (hi, lo) of S' x:
    // registers 0-3 of depth step kk = (row, j 0-7), (row + 8, j 0-7),
    // (row, j 8-15), (row + 8, j 8-15) of columns 16 kk ..
    uint32_t s_hi[4][4], s_lo[4][4];
    const float ci[2] = {cum_s[buf][row], cum_s[buf][row + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 8 * j + col;
      const float2 cj = *reinterpret_cast<const float2*>(&cum_s[buf][c0]);
      const float2 dj = *reinterpret_cast<const float2*>(&dt_s[buf][c0]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row + 8 * r;
        const float v0 = i >= c0 ? gs[4 * j + 2 * r] * exp2_approx((ci[r] - cj.x) * kLog2e) * dj.x : 0.f;
        const float v1 =
            i >= c0 + 1 ? gs[4 * j + 2 * r + 1] * exp2_approx((ci[r] - cj.y) * kLog2e) * dj.y : 0.f;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(v0 - __low2float(h2), v1 - __high2float(h2));
        s_hi[j / 2][(j & 1) * 2 + r] = bf16x2_bits(h2);
        s_lo[j / 2][(j & 1) * 2 + r] = bf16x2_bits(l2);
      }
    }
    __syncthreads();                  // x w is in place; no warp reads the old state any more

    // state^T = exp(c_last) state^T + B^T (x w), and yd = S' x
    const float decay = ecum_s[buf][Q - 1];
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) st[m][e] *= decay;
    float yd[16];
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(st[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint64_t da = wgmma_desc(bs + m * (Q * kSwizzleRow) + kk * 16 * kSwizzleRow,
                                       Q * kSwizzleRow, 8 * kSwizzleRow);
        wgmma_ss_n32<1, 1>(st[m], da, wgmma_desc(xw_hi + kk * 16 * kSwizzleRow64, X_BYTES,
                                                 8 * kSwizzleRow64, kLayout64B), 1);
        wgmma_ss_n32<1, 1>(st[m], da, wgmma_desc(xw_lo + kk * 16 * kSwizzleRow64, X_BYTES,
                                                 8 * kSwizzleRow64, kLayout64B), 1);
      }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint64_t db =
          wgmma_desc(xs + kk * 16 * kSwizzleRow64, X_BYTES, 8 * kSwizzleRow64, kLayout64B);
      wgmma_rs_n32(yd, s_hi[kk], db, kk > 0);
      wgmma_rs_n32(yd, s_lo[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(st[m]);
    fence_regs(yd);

    // y = exp(c_i) (C state^T) + S' x, rounded once; y is contiguous (B, S, H, P)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      const int s = t * Q + i;
      if (s >= p.S) continue;
      const float ei = ecum_s[buf][i];
      __nv_bfloat16* yrow = y + ((static_cast<long long>(b) * p.S + s) * p.H + h) * p.P + p0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = 8 * j + col;
        if (p0 + pp < p.P)
          *reinterpret_cast<__nv_bfloat162*>(yrow + pp) = __floats2bfloat162_rn(
              fmaf(ei, yo[4 * j + 2 * r], yd[4 * j + 2 * r]),
              fmaf(ei, yo[4 * j + 2 * r + 1], yd[4 * j + 2 * r + 1]));
      }
    }
    write_state();                    // read by the next chunk, after its first barrier
    fence_proxy_async();

    // this warp is done with the stage; the producer refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (producer && t + 2 < T) {
      mbar_wait(empty + 8 * stage, parity);
      load(t + 2);
    }
  }

#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = 64 * m + row + 8 * ((e >> 1) & 1);
      const int pp = p0 + 8 * (e >> 2) + col + (e & 1);
      if (n < p.N && pp < p.P) final_state[state_off + pp * p.N + n] = st[m][e];
    }
}

template <int NB>
cudaError_t launch_tc(const __nv_bfloat16* x, const float* dt, const float* A,
                      const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, const float* init,
                      __nv_bfloat16* y, float* fin, const Params& params, cudaStream_t stream) {
  constexpr int X_BYTES = kTcTile * kSwizzleRow64;
  constexpr int BC_BYTES = NB * kTcTile * kSwizzleRow;
  // two stages of x, B and C; the state's and x w's hi and lo; 1 KB to align to 1024 bytes
  constexpr int smem = 2 * (X_BYTES + 2 * BC_BYTES) + 2 * NB * 64 * kSwizzleRow64 + 2 * X_BYTES + 1024;
  Params p = params;
  const long long strides[] = {p.x_sb, p.x_ss, p.x_sh, p.b_sb, p.b_ss,
                               p.b_sg, p.c_sb, p.c_ss, p.c_sg};
  for (long long s : strides)
    if (s % 8) return cudaErrorMisalignedAddress;           // rows on 16 bytes
  for (const void* ptr : {static_cast<const void*>(x), static_cast<const void*>(Bm),
                          static_cast<const void*>(Cm)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap tx, tb, tc;
  cudaError_t err = make_map(&tx, &p.x_slots, x, p.P, p.S, p.H, p.B, p.x_ss, p.x_sh, p.x_sb,
                             kTcTile, kTcSlice, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = make_map(&tb, &p.b_slots, Bm, p.N, p.S, p.G, p.B, p.b_ss, p.b_sg, p.b_sb, kTcTile);
  if (err == cudaSuccess)
    err = make_map(&tc, &p.c_slots, Cm, p.N, p.S, p.G, p.B, p.c_ss, p.c_sg, p.c_sb, kTcTile);
  if (err != cudaSuccess) return err;
  auto kernel = ssd_scan_tc_kernel<NB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + kTcSlice - 1) / kTcSlice, p.H, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(tx, tb, tc, dt, A, init, y, fin, p);
  return cudaGetLastError();
}

#define SSD_ARGS                                                                        \
  const void *x, const void *dt, const void *A, const void *Bm, const void *Cm,         \
      const void *init, void *y, void *fin, int B, int S, int H, int G, int P, int N,   \
      long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, \
      long long dt_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb,  \
      long long c_ss, long long c_sg, void *stream
#define SSD_PASS                                                                        \
  x, dt, A, Bm, Cm, init, y, fin, B, S, H, G, P, N, x_sb, x_ss, x_sh, dt_sb, dt_ss,     \
      dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, stream

template <typename T>
int run(SSD_ARGS) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, N, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, init != nullptr, P, 0, 0, 0};
  const T* xt = static_cast<const T*>(x);
  const float* dtt = static_cast<const float*>(dt);
  const float* At = static_cast<const float*>(A);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* it = static_cast<const float*>(init);
  T* yt = static_cast<T*>(y);
  float* ft = static_cast<float*>(fin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (P == 8 || P == 16 || P == 32 || P == 64)
      err = N <= 64 ? launch_tc<1>(xt, dtt, At, bt, ct, it, yt, ft, p, st)
                    : launch_tc<2>(xt, dtt, At, bt, ct, it, yt, ft, p, st);
  } else {
    switch (P) {
      case 8: err = launch<T, 8>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
      case 16: err = launch<T, 16>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
      case 32: err = launch<T, 32>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
      case 64: err = launch<T, 64>(xt, dtt, At, bt, ct, it, yt, ft, p, st); break;
    }
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// float32 on the CUDA cores (ssd_scan_kernel)
int ssd_scan_f32(SSD_ARGS) { return run<float>(SSD_PASS); }

// bfloat16 on the tensor cores (ssd_scan_tc_kernel)
int ssd_scan_bf16(SSD_ARGS) { return run<__nv_bfloat16>(SSD_PASS); }

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
