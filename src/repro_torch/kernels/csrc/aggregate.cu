// Weighted model aggregation (FedLEO eqs. 4 and 9) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py::aggregate_flat
// (body _aggregate_kernel).  It computes
//
//     out[n] = sum_k w[k] * x[k, n]        0 <= n < N, 0 <= k < K
//
// over a contiguous row-major (K, N) stream of K stacked, flattened parameter
// vectors, with w a (K,) float32 vector on the device.  The sum is kept in
// float32 and written in x's type (float or bfloat16).
//
// Bound: memory.  Each element of x is read once and each output written
// once, (K + 1) * N * sizeof(T) bytes for 2 * K * N flops, far below the
// card's flops-per-byte balance.  The design is the simple one: one thread
// per output element inside a grid-stride loop over N (64-bit index: N
// exceeds 2^31 for the large model configurations), an inner loop over K,
// neighbouring threads reading neighbouring n so every load of a warp is
// coalesced, and a bound check for the ragged tail (no padding of N to a
// block multiple, unlike the TPU kernel).
//
// Left for later: 16-byte vector loads (4 floats or 8 bfloat16 per thread),
// and a multi-tensor launch over per-leaf pointers that would drop the
// torch.cat copy aggregate_ops makes to build the (K, N) stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ out, int K, long long N) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    float acc = 0.0f;
    const T* col = x + n;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      acc = fmaf(__ldg(w + k), load_f32(col + static_cast<long long>(k) * N), acc);
    }
    store(out + n, acc);
  }
}

template <typename T>
cudaError_t launch(const T* x, const float* w, T* out, int K, long long N,
                   cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  aggregate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, w, out, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int aggregate_flat_f32(const void* x, const void* w, void* out, int K,
                       long long N, void* stream) {
  return static_cast<int>(launch(static_cast<const float*>(x),
                                 static_cast<const float*>(w),
                                 static_cast<float*>(out), K, N,
                                 static_cast<cudaStream_t>(stream)));
}

int aggregate_flat_bf16(const void* x, const void* w, void* out, int K,
                        long long N, void* stream) {
  return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const float*>(w),
                                 static_cast<__nv_bfloat16*>(out), K, N,
                                 static_cast<cudaStream_t>(stream)));
}

const char* aggregate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
