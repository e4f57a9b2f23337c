// Elementwise chain probe: the per-instruction issue rates of the card.
//
// Replaces the Pallas TPU kernel knowledgegraphembedding_tpu/utils/
// vpu_probe.py::_timed_chain's inner `kern`, which applies a K-link
// elementwise chain, unrolled at trace time, to one VMEM-resident
// f32[2048, 128] block. Timing the chain at several K and taking the slope
// per link cancels the load, the store, the loop and the launch, and leaves
// the issue time of the link's instructions (ops/chain_probe.py,
// utils/vpu_probe.py::op_rate).
//
// The six links, each link j with a constant that cycles with j % 3,
// computed in double as the Python expressions of the JAX package are and
// rounded once to f32, as JAX's weak typing rounds them:
//
//   alu        fabsf(z - c) + 0.1f                       c = 0.25 + 0.01 m
//   mul_add    z * 0.99f + c                             c = 0.01 + 0.001 m
//   guard_mix  z > c ? fmaxf(z, 1e-30f) * 0.999f : 0.123f  c = 0.01 m
//   rsqrt      rsqrtf((z + 0.3f) + c)                    c = 0.01 m
//   sin        sinf((z + 0.7f) + c)                      c = 0.01 m
//   sqrt       sqrtf((z + 0.3f) + c)                     c = 0.01 m
//
// (m = j % 3). The rsqrt, sin and sqrt links add their two constants one
// after the other, as the JAX lambdas `z + 0.3 + 0.01 * (j % 3)` do.
//
// Design. One thread per element: it loads its element into a register
// once, applies the K links `reps` times (the outer loop is the counterpart
// of the JAX fori_loop over reps, inside one launch, so a launch runs for
// milliseconds rather than microseconds), and stores once. Everything lives
// in registers: no shared memory, no spills (the ptxas report is kept
// beside the library; sinf's rarely taken large-argument path has a small
// stack frame of its own). A chain is one dependent sequence per thread,
// so the card issues at its rate only with enough warps resident to hide
// the latency of each link: 256 threads a block, 1,024 blocks for the
// 262,144 elements, which the launch checks fit in one wave (8 blocks, 64
// warps, per SM on an H100). The TPU kernel's single live vector register
// and VMEM block have no other counterpart.
//
// Bound on an H100 SXM: instruction issue. Each SM issues 4 warp
// instructions a clock (128 thread instructions) and 16 MUFU results a
// clock; the bytes (1 MB in, 1 MB out) are noise beside K * reps links.
//
// Build without -use_fast_math: alu, guard_mix and sqrt then round exactly
// as the plain PyTorch version (ops/chain_probe.py::chain_ref) does;
// mul_add contracts to one FFMA and rsqrt is the approximate MUFU.RSQ, so
// those two (and sinf's polynomial) agree with it to a stated tolerance.

#include <cuda_runtime.h>
#include <math.h>

namespace chain_probe {

constexpr int kThreads = 256;

enum LinkCode { kAlu = 0, kMulAdd = 1, kGuardMix = 2, kRsqrt = 3, kSin = 4, kSqrt = 5 };

// Link<L>::c(m) is the double expression rounded once to f32; m is a
// compile-time constant in every unrolled link, so it folds
template <int LINK>
struct Link;

__device__ __forceinline__ float hundredths(int m) { return (float)(0.01 * m); }

template <>
struct Link<kAlu> {
  __device__ __forceinline__ static float c(int m) { return (float)(0.25 + 0.01 * m); }
  __device__ __forceinline__ static float apply(float z, float c) { return fabsf(z - c) + 0.1f; }
};

template <>
struct Link<kMulAdd> {
  __device__ __forceinline__ static float c(int m) { return (float)(0.01 + 0.001 * m); }
  __device__ __forceinline__ static float apply(float z, float c) { return z * 0.99f + c; }
};

template <>
struct Link<kGuardMix> {
  __device__ __forceinline__ static float c(int m) { return hundredths(m); }
  __device__ __forceinline__ static float apply(float z, float c) {
    return z > c ? fmaxf(z, 1e-30f) * 0.999f : 0.123f;
  }
};

template <>
struct Link<kRsqrt> {
  __device__ __forceinline__ static float c(int m) { return hundredths(m); }
  __device__ __forceinline__ static float apply(float z, float c) { return rsqrtf((z + 0.3f) + c); }
};

template <>
struct Link<kSin> {
  __device__ __forceinline__ static float c(int m) { return hundredths(m); }
  __device__ __forceinline__ static float apply(float z, float c) { return sinf((z + 0.7f) + c); }
};

template <>
struct Link<kSqrt> {
  __device__ __forceinline__ static float c(int m) { return hundredths(m); }
  __device__ __forceinline__ static float apply(float z, float c) { return sqrtf((z + 0.3f) + c); }
};

// links 0 .. K-1, fully unrolled
template <int LINK, int K>
__device__ __forceinline__ float run_chain(float z) {
#pragma unroll
  for (int j = 0; j < K; ++j) z = Link<LINK>::apply(z, Link<LINK>::c(j % 3));
  return z;
}

template <int LINK, int K>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ z, const float* __restrict__ w,
             float* __restrict__ out, int n, int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // w is an operand as in the TPU kernel; none of the six links reads it
  (void)w;
  float x = z[i];
#pragma unroll 1
  for (int r = 0; r < reps; ++r) x = run_chain<LINK, K>(x);
  out[i] = x;
}

template <int LINK, int K>
cudaError_t launch(const float* z, const float* w, float* out, int n, int reps,
                   int device, cudaStream_t stream, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                      chain_kernel<LINK, K>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (out == nullptr) return cudaSuccess;  // occupancy query only
  const int blocks = (n + kThreads - 1) / kThreads;
  chain_kernel<LINK, K><<<blocks, kThreads, 0, stream>>>(z, w, out, n, reps);
  return cudaGetLastError();
}

template <int LINK>
cudaError_t launch_k(int K, const float* z, const float* w, float* out, int n, int reps,
                     int device, cudaStream_t s, int* bps) {
  switch (K) {
    case 1: return launch<LINK, 1>(z, w, out, n, reps, device, s, bps);
    case 8: return launch<LINK, 8>(z, w, out, n, reps, device, s, bps);
    case 16: return launch<LINK, 16>(z, w, out, n, reps, device, s, bps);
    case 32: return launch<LINK, 32>(z, w, out, n, reps, device, s, bps);
    case 64: return launch<LINK, 64>(z, w, out, n, reps, device, s, bps);
    case 128: return launch<LINK, 128>(z, w, out, n, reps, device, s, bps);
    case 256: return launch<LINK, 256>(z, w, out, n, reps, device, s, bps);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace chain_probe

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// link: 0 alu, 1 mul_add, 2 guard_mix, 3 rsqrt, 4 sin, 5 sqrt; K one of 1,
// 8, 16, 32, 64, 128, 256 (K=1 is for checking the kernel's data flow: the
// rsqrt and sin links contract, so a long chain ends at a fixed point
// whatever its input was). Writes the kernel's resident blocks per SM to
// *blocks_per_sm; with out == nullptr it launches nothing (an occupancy
// query). Launches on `stream` and does not synchronise.
extern "C" int chain_probe_launch(int link, int K, const float* z, const float* w,
                                  float* out, int n, int reps, int device, void* stream,
                                  int* blocks_per_sm) {
  using namespace chain_probe;
  if (n < 0 || reps < 0 || blocks_per_sm == nullptr) return (int)cudaErrorInvalidValue;
  if (out != nullptr && n == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (link) {
    case kAlu: return (int)launch_k<kAlu>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    case kMulAdd: return (int)launch_k<kMulAdd>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    case kGuardMix:
      return (int)launch_k<kGuardMix>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    case kRsqrt: return (int)launch_k<kRsqrt>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    case kSin: return (int)launch_k<kSin>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    case kSqrt: return (int)launch_k<kSqrt>(K, z, w, out, n, reps, device, s, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Error text for a code returned above.
extern "C" const char* chain_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
