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
// inputs' type.  The tensors are read in place through their batch, sequence
// and head strides; the last axis is contiguous.  Any S: rows and keys past S
// are zero-filled in shared memory, masked, and not written.  No padding copy
// and no fallback.  Both kernels skip kv tiles wholly outside the causal /
// window band and launch the longest causal q tiles first.  Masked scores are
// -inf, with the max guarded so a row that has seen no visible key yet adds
// nothing (the TPU kernel's finite -1e30 gives the same result wherever a row
// has a visible key, and every row has one: its own position).
//
// Bound: at the serving shapes (S in the thousands, D = 64 to 256) the work is
// 4 * D operations per visible (q, k) pair against 2 * D elements of q and o
// per row, far above the card's operations-per-byte balance, so the bound is
// the arithmetic: in bfloat16, the tensor cores' 989 TFLOP/s.  What holds
// the bf16 kernel back from it is the softmax between the two products (the
// exponentials and bf16 conversions run on pipes slower than the FMAs),
// which the tensor cores wait on while a warpgroup runs it.
//
// bfloat16 (serving): flash_fwd_tc_kernel, both products on the tensor cores.
//   * One block of two warpgroups (256 threads) per (128-row q tile, head,
//     batch); each warpgroup owns 64 q rows and loops over 64-key tiles on
//     its own, so one's softmax can run while the other multiplies.
//   * S = Q K^T is wgmma m64n64k16 with Q and the K tile read from shared
//     memory (both K-major); O += P V is wgmma m64nDk16 with P in registers
//     and the V tile read from shared memory as the MN-major operand, so
//     neither K nor V is transposed.
//   * S never leaves registers: the accumulator fragment is soft-capped,
//     masked and exponentiated in place (one FMA and one ex2 an element,
//     the scale folded in), its row max reduced over the four lanes that
//     share a row, and it becomes the A fragment of the second product
//     directly.  Only tiles that cross the diagonal, the window edge or S pay
//     for the mask; O is rescaled only when a row's max moved.
//   * P = exp(S - m) is float32 and the denominator sums it in float32.  A
//     single rounding of P to bf16 (what FlashAttention does) moves the
//     output by up to ~60x the float32 limit the kernel is held to, so P goes
//     in as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), both
//     accumulated into the same float32 O: the float32 result for 1.5x the
//     tensor work of one split (tests/test_torch_flash.py emulates both).
//   * Copies are TMA: one thread issues Q once and K and V through a
//     two-stage ring whose mbarriers track arrival (full) and release by all
//     eight warps (empty), so the next tile lands while this one computes.
//     TMA writes the 128-byte swizzle that wgmma reads (and that keeps the
//     epilogue's shared-memory traffic conflict-free), and zero-fills rows
//     past S and the columns past D where D is not a multiple of 64 (D = 32
//     runs in one 64-wide box, D = 112 in two: the tiles are 128 wide).
//   * Rows start on 16-byte boundaries (strides a multiple of 8 elements), as
//     TMA requires.  At D = 256 the block holds Q 64 KB + 2 stages of K and V
//     128 KB of the 227 KB; at D <= 64 two blocks share an SM.
//
// float32 (agreement checks): flash_fwd_kernel, the arithmetic on the CUDA
//   cores in float32 FMAs, since no tensor-core format keeps float32 to 1e-5
//   of the largest output (TF32 keeps about three decimal digits).
//   * One block of 256 threads (16 x 16) per (64-row q tile, head, batch).
//   * The q tile and each K and V tile are staged in shared memory as 32-bit
//     words, rows padded by one word so that the 16 threads of a half-warp
//     reading 16 rows hit 16 different banks.
//   * Thread (ty, tx) owns q rows ty + 16 i (i < 4), score columns
//     tx + 16 j and output words tx + 16 w.  Row maxima and sums are reduced
//     over the 16 tx lanes with warp shuffles; each thread keeps the running
//     max and denominator of its four rows.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  int B, S, H, G;
  long long q_sb, q_ss, q_sh;         // element strides of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  int window;                         // 0: no window
  float soft_cap;                     // 0: no cap
  float scale;
  int q_slots, k_slots, v_slots;      // bf16: tensor-map dimensions of (seq, head, batch)
};

// --- float32: the CUDA-core kernel ----------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;   // q rows per thread

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

// --- bfloat16: the tensor-core kernel -------------------------------------------------

constexpr int kTcBlockQ = 128;        // two warpgroups of 64 q rows
constexpr int kTcBlockK = 64;         // keys per K/V tile
constexpr int kTcThreads = 256;
constexpr int kEpilogueBarrier = 1;   // + the warpgroup (a named barrier; 0 is __syncthreads)

// Thread t of warpgroup w owns, in every 64-wide accumulator, rows
// 16 (t / 32 % 4) + t % 32 / 4 (+ 8) of the warpgroup's 64 and columns
// 8 j + 2 (t % 4) (+ 1): register 4 j + e holds row + 8 (e / 2), column + e % 2.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)   // two blocks an SM at D <= 64
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                    Params p) {
  constexpr int DP = (D + 63) / 64 * 64;       // shared tiles and products are whole 64-wide boxes
  constexpr int BQ = kTcBlockQ;
  constexpr int BK = kTcBlockK;
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;
  constexpr int OREG = DP / 2;                 // accumulator floats a thread holds for O
  constexpr float kNegInf = -INFINITY;
  constexpr float kLog2e = 1.4426950408889634f;

  // full[2]: a K/V stage has landed; empty[2]: all 8 warps are done with it
  __shared__ __align__(8) uint64_t bars[5];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle is a function of the address bits, so tiles start on 1024 bytes
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t Qs = base;                    // then K stages 0, 1 and V stages 0, 1
  const uint32_t Ks = base + Q_BYTES;
  const uint32_t Vs = base + Q_BYTES + 2 * KV_BYTES;
  const uint32_t full = smem_addr(&bars[0]);
  const uint32_t empty = smem_addr(&bars[2]);
  const uint32_t q_full = smem_addr(&bars[4]);

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int q0 = qt * BQ;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row_in_wg = 16 * (threadIdx.x / 32 % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int wq0 = q0 + 64 * wg;                // this warpgroup's first and last row
  const int wq1 = min(wq0 + 63, p.S - 1);
  int qpos[2];
  qpos[0] = wq0 + row_in_wg;
  qpos[1] = qpos[0] + 8;

  // kv tiles that hold a visible key for some row of this q tile
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  // One thread issues every copy: Q once, then K and V tile i + 2 as soon as
  // all eight warps are done with tile i, whose stage it takes.
  const bool producer = threadIdx.x == 128;
  auto load_kv = [&](int i) {
    const int stage = i & 1;
    const int k0 = (kt_begin + i) * BK;
    mbar_expect_tx(full + 8 * stage, 2 * KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < DP / 64; ++cb) {
      tma_box(Ks + stage * KV_BYTES + cb * BK * kSwizzleRow, &tk, p.k_slots, cb * 64, k0, g, b,
              full + 8 * stage);
      tma_box(Vs + stage * KV_BYTES + cb * BK * kSwizzleRow, &tv, p.v_slots, cb * 64, k0, g, b,
              full + 8 * stage);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(empty, 8);
    mbar_init(empty + 8, 8);
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < DP / 64; ++cb)
      tma_box(Qs + cb * BQ * kSwizzleRow, &tq, p.q_slots, cb * 64, q0, h, b, q_full);
    load_kv(0);
    if (kt_begin + 1 < kt_end) load_kv(1);
  }

  float acc[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) acc[i] = 0.f;
  // the running max m is kept in the units of the (capped) scores x, and
  // exp(scale (s - m)) or, with a soft cap, exp(x - m) is 2^(c x - c m)
  const bool capped = p.soft_cap > 0.f;
  const float c = capped ? kLog2e : p.scale * kLog2e;
  const float cap_in = capped ? p.scale / p.soft_cap : 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                     // this thread's part of the row sums

  mbar_wait(q_full, 0);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int i = kt - kt_begin;
    const int stage = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int k0 = kt * BK;
    mbar_wait(full + 8 * stage, parity);

    const bool live = wq0 < p.S && !(p.causal && k0 > wq1) &&
                      !(p.window > 0 && wq0 - (k0 + BK - 1) >= p.window);
    if (live) {
      // S = Q K^T on the tensor cores: DP / 16 products of depth 16
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns into the 128-byte row
        const uint64_t da = wgmma_desc(Qs + (kk / 4) * (BQ * kSwizzleRow) + wg * 64 * kSwizzleRow + off,
                                       0, 8 * kSwizzleRow);
        const uint64_t db = wgmma_desc(Ks + stage * KV_BYTES + (kk / 4) * (BK * kSwizzleRow) + off,
                                       0, 8 * kSwizzleRow);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // soft-cap and mask in place; masks only on edge tiles
      const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > wq0) ||
                        (p.window > 0 && wq1 - k0 >= p.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = s[4 * j + e];
          if (capped) x = p.soft_cap * tanhf(x * cap_in);
          if (edge) {
            const int kpos = k0 + 8 * j + col + (e & 1);
            const bool visible = kpos < p.S && (!p.causal || qpos[r] >= kpos) &&
                                 (p.window <= 0 || qpos[r] - kpos < p.window);
            x = visible ? x : kNegInf;
          }
          s[4 * j + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float cm[2], corr[2];
      bool moved = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // c m rounded once (never fused), so that a rescale cancels exactly the
        // factor 2^-cm the earlier tiles were taken with; 0 while the row has seen nothing
        cm[r] = m_new == kNegInf ? 0.f : __fmul_rn(c, m_new);
        corr[r] = m_new == m[r] ? 1.f : exp2_approx(__fmul_rn(c, m[r]) - cm[r]);
        moved = moved || m_new != m[r];
        m[r] = m_new;
      }

      // P = exp(S - m) in float32, summed in float32, handed to the second
      // product as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi)
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = e >> 1;
          const float p0 = exp2_approx(fmaf(s[4 * j + e], c, -cm[r]));
          const float p1 = exp2_approx(fmaf(s[4 * j + e + 1], c, -cm[r]));
          sum[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi));
          // A fragment of keys 16 kk ..: registers 0-3 = (row, k 0-7), (row + 8, k 0-7),
          // (row, k 8-15), (row + 8, k 8-15)
          const int reg = (j & 1) * 2 + r;
          p_hi[j / 2][reg] = bf16x2_bits(hi);
          p_lo[j / 2][reg] = bf16x2_bits(lo);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
      if (__any_sync(0xffffffffu, moved)) {    // most tiles of a long row move no max
#pragma unroll
        for (int r = 0; r < OREG; ++r) acc[r] *= corr[(r >> 1) & 1];
      }

      // O += P V on the tensor cores; V is the MN-major operand
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = wgmma_desc(Vs + stage * KV_BYTES + kk * 16 * kSwizzleRow,
                                       BK * kSwizzleRow, 8 * kSwizzleRow);
        wgmma_pv<DP>(acc, p_hi[kk], db);
        wgmma_pv<DP>(acc, p_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }

    // this warp is done with the stage; the producer refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (producer && kt + 2 < kt_end) {
      mbar_wait(empty + 8 * stage, parity);
      load_kv(i + 2);
    }
  }

  // O / l, rounded once to bf16, staged through this warpgroup's rows of the
  // Q tile (which only it reads) so that the stores to o are whole 16-byte
  // chunks of rows; o is contiguous (B, S, H, D)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    inv[r] = tot > 0.f ? 1.f / tot : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int cc = 8 * j + col;
      if (cc < D) {
        const int row = 64 * wg + row_in_wg + 8 * r;
        const uint32_t off = tile_offset<BQ>(row, cc / 8) + (cc % 8) * 2;
        *reinterpret_cast<__nv_bfloat162*>(smem + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
  if (wg == 0)
    named_sync<kEpilogueBarrier, 128>();
  else
    named_sync<kEpilogueBarrier + 1, 128>();
  constexpr int CH = D / 8;
  static_assert(64 * CH % 128 == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int i = 0; i < 64 * CH / 128; ++i) {
    const int idx = threadIdx.x % 128 + i * 128;
    const int row = 64 * wg + idx / CH;
    const int cc = idx % CH;
    const int s = q0 + row;
    if (s < p.S) {
      const uint4 val = *reinterpret_cast<const uint4*>(smem + tile_offset<BQ>(row, cc));
      *reinterpret_cast<uint4*>(o + ((static_cast<long long>(b) * p.S + s) * p.H + h) * D + cc * 8) = val;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, const Params& p,
                   cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;       // keeps a D=256 block in 140 KB
  constexpr int SW = D + 1;
  constexpr int smem = ((kBlockQ + 2 * BK) * SW + kBlockQ * (BK + 1)) * 4;
  auto kernel = flash_fwd_kernel<float, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, p);
  return cudaGetLastError();
}


template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, const Params& params, cudaStream_t stream) {
  constexpr int DP = (D + 63) / 64 * 64;
  // Q, two stages of K and V, and 1 KB to align the tiles to 1024 bytes
  constexpr int smem = (kTcBlockQ + 4 * kTcBlockK) * DP * 2 + 1024;
  Params p = params;
  const long long strides[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss,
                               p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  for (long long st : strides)
    if (st % 8) return cudaErrorMisalignedAddress;          // rows on 16 bytes
  for (const void* ptr : {static_cast<const void*>(q), static_cast<const void*>(k),
                          static_cast<const void*>(v), static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, &p.q_slots, q, D, p.S, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                             kTcBlockQ);
  if (err == cudaSuccess)
    err = make_map(&tk, &p.k_slots, k, D, p.S, p.G, p.B, p.k_ss, p.k_sh, p.k_sb, kTcBlockK);
  if (err == cudaSuccess)
    err = make_map(&tv, &p.v_slots, v, D, p.S, p.G, p.B, p.v_ss, p.v_sh, p.v_sb, kTcBlockK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tc_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kTcBlockQ - 1) / kTcBlockQ, p.H, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, o, p);
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
    case 32: err = launch<32>(qt, kt, vt, ot, p, st); break;
    case 64: err = launch<64>(qt, kt, vt, ot, p, st); break;
    case 112: err = launch<112>(qt, kt, vt, ot, p, st); break;
    case 128: err = launch<128>(qt, kt, vt, ot, p, st); break;
    case 256: err = launch<256>(qt, kt, vt, ot, p, st); break;
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

// float32 on the CUDA cores (flash_fwd_kernel)
int flash_attention_f32(FLASH_ARGS) { return run<float>(FLASH_PASS); }

// bfloat16 on the tensor cores (flash_fwd_tc_kernel)
int flash_attention_bf16(FLASH_ARGS) { return run<__nv_bfloat16>(FLASH_PASS); }

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
