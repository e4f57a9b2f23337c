// RotatE's negative scores against gathered rows, and their gradients.
//
// Replaces no TPU kernel: the JAX package's train step is XLA's fusion of the
// same chain. It was written for the port's first bottleneck, the train
// step's elementwise chain (models/scorers.py::rotate on [B, n, 2d] rows
// gathered by ent[neg]), which builds each intermediate at full size in
// device memory and walks back over them in autograd's backward.
//
// With q[b] the per-row query (tail-batch h∘r, head-batch conj(r)∘t; re | im
// halves of `half` elements each, computed by the wrapper) and x the gathered
// row table[neg[b, j]]:
//
//   score[b, j] = gamma - sum_k sqrt(max(re_k^2 + im_k^2, 1e-30)),
//   (re, im) = q[b] - x.
//
// The backward of one element is the chain's, rounding for rounding:
// s = -g / (2 mag), d re = 2 (s re) (twice the product, as autograd adds the
// two sides of re * re), d im likewise, and 0 where the clamp holds
// (sq < 1e-30). q receives +d, the gathered row -d.
//
// Floor and bound on an H100 SXM, at the main path's B 1024, n 256, d 1000
// (E 14,541): the function needs the 116 MB table once a pass, and its
// instructions set its floor: off the SASS, 11 FP32 and 1 MUFU an element
// in the forward and 24 and 2 in each backward pass, 0.094 and 0.20 ms at
// 33.5e12 issue slots a second (the bytes, 0.04-0.07 ms at 3.35 TB/s). What
// bounds this design is the bytes of the gathered rows: every pass reads
// each of the B n rows, 2.1 GB, most of it from the 50 MB L2 (0.63 ms had
// it all come from HBM). The design reads each gathered row once a pass,
// straight from the table, and keeps nothing of [B, n, 2d] size. Design:
//  - Forward: a warp scores one gathered row at a time, its lanes reading
//    16-byte vectors of the row straight from the table by index (no
//    [B, n, 2d] buffer; the loads skip L1, which keeps q[b]), and reduces
//    its score in a fixed order: each lane's vectors in order, then a
//    butterfly over the lanes. Blocks are (batch row, slice of negatives).
//  - Backward, pass 1 (d q): a block per batch row and slice of the width;
//    each thread owns one vector of the width and adds its terms over the n
//    gathered rows in order, the row indices and -g staged in shared memory.
//  - Backward, pass 2 (d table): the B n occurrences are sorted by entity
//    (stable, by the wrapper), run offsets found by binary search
//    (rotate_score_offsets), and a block per entity reads its row once,
//    recomputes each occurrence's terms from q[b] (8 MB at the main path,
//    held in L2) and writes its gradient row, zeros where it has none.
//    No float atomics: every sum has one order, so gradients repeat bit for
//    bit, and nothing is read on the host, so the launches capture in a
//    CUDA graph.
//
// Arithmetic is IEEE f32 without contraction (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so every element rounds as the plain
// PyTorch chain rounds it; only the order of the sums over k and over the
// occurrences differs. An index outside [0, E) gives a NaN score and no
// gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;  // gathered rows a forward warp scores, at most
constexpr float kFloor = 1e-30f;

template <typename V> struct Width;
template <> struct Width<float> { static constexpr int value = 1; };
template <> struct Width<float4> { static constexpr int value = 4; };

__device__ __forceinline__ float lane(const float& v, int) { return v; }
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_lane(float& v, int, float x) { v = x; }
__device__ __forceinline__ void set_lane(float4& v, int i, float x) {
  if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x; else v.w = x;
}
template <typename V> __device__ __forceinline__ V zero() {
  V v;
#pragma unroll
  for (int i = 0; i < Width<V>::value; ++i) set_lane(v, i, 0.f);
  return v;
}

// A gathered row's vector: read-only, and kept out of L1.
__device__ __forceinline__ float load_row(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 load_row(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// The chain's squared modulus of q - x, and the clamped magnitude.
__device__ __forceinline__ float squared(float qr, float qi, float xr, float xi, float& re,
                                         float& im) {
  re = __fsub_rn(qr, xr);
  im = __fsub_rn(qi, xi);
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}
__device__ __forceinline__ float clamped_sqrt(float sq) {
  return __fsqrt_rn(sq < kFloor ? kFloor : sq);  // NaN passes, as torch.clamp's
}

// d score / d q of one element, scaled by the upstream gradient: ng = -g.
__device__ __forceinline__ void element_grad(float qr, float qi, float xr, float xi, float ng,
                                             float& gr, float& gi) {
  float re, im;
  const float sq = squared(qr, qi, xr, xi, re, im);
  const float s = sq >= kFloor ? __fdiv_rn(ng, __fmul_rn(2.f, clamped_sqrt(sq))) : 0.f;
  const float tr = __fmul_rn(s, re), ti = __fmul_rn(s, im);
  gr = __fadd_rn(tr, tr);
  gi = __fadd_rn(ti, ti);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    score_forward(const float* __restrict__ q, const float* __restrict__ table,
                  const int* __restrict__ neg, float* __restrict__ out, int n, int half, int E,
                  float gamma) {
  constexpr int W = Width<V>::value;
  const int hv = half / W;
  const int b = blockIdx.x;
  const int l = threadIdx.x & 31;
  const V* qre = reinterpret_cast<const V*>(q + (size_t)b * 2 * half);
  const V* qim = qre + hv;
  for (int j = blockIdx.y * kWarps + (threadIdx.x >> 5); j < n; j += gridDim.y * kWarps) {
    const int e = __ldg(neg + (size_t)b * n + j);
    float acc = __int_as_float(0x7fc00000);  // NaN for a row outside the table
    if (e >= 0 && e < E) {
      const V* xre = reinterpret_cast<const V*>(table + (size_t)e * 2 * half);
      const V* xim = xre + hv;
      acc = 0.f;
#pragma unroll 4
      for (int k = l; k < hv; k += 32) {
        const V a = __ldg(qre + k), c = __ldg(qim + k);
        const V x = load_row(xre + k), y = load_row(xim + k);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          float re, im;
          const float sq = squared(lane(a, i), lane(c, i), lane(x, i), lane(y, i), re, im);
          acc = __fadd_rn(acc, clamped_sqrt(sq));
        }
      }
      acc = warp_sum(acc);
    }
    if (l == 0) out[(size_t)b * n + j] = __fsub_rn(gamma, acc);
  }
}

// Pass 1: grad_q[b] = sum over j of the element terms, j in order.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    score_grad_query(const float* __restrict__ q, const float* __restrict__ table,
                     const int* __restrict__ neg, const float* __restrict__ grad,
                     float* __restrict__ grad_q, int n, int half, int E) {
  constexpr int W = Width<V>::value;
  __shared__ int s_e[kThreads];
  __shared__ float s_ng[kThreads];
  const int hv = half / W;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const V* qre = reinterpret_cast<const V*>(q + (size_t)b * 2 * half);
  const V* qim = qre + hv;
  for (int k0 = blockIdx.y * kThreads; k0 < hv; k0 += gridDim.y * kThreads) {
    const int k = k0 + t;
    const bool on = k < hv;
    const V a = on ? __ldg(qre + k) : zero<V>(), c = on ? __ldg(qim + k) : zero<V>();
    V ar = zero<V>(), ai = zero<V>();
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int m = min(kThreads, n - j0);
      __syncthreads();  // the last tile is read
      if (t < m) {
        s_e[t] = neg[(size_t)b * n + j0 + t];
        s_ng[t] = -grad[(size_t)b * n + j0 + t];
      }
      __syncthreads();
      if (on) {
#pragma unroll 4
        for (int jj = 0; jj < m; ++jj) {
          const int e = s_e[jj];
          if (e < 0 || e >= E) continue;
          const V* xre = reinterpret_cast<const V*>(table + (size_t)e * 2 * half);
          const V x = load_row(xre + k), y = load_row(xre + hv + k);
          const float ng = s_ng[jj];
#pragma unroll
          for (int i = 0; i < W; ++i) {
            float gr, gi;
            element_grad(lane(a, i), lane(c, i), lane(x, i), lane(y, i), ng, gr, gi);
            set_lane(ar, i, __fadd_rn(lane(ar, i), gr));
            set_lane(ai, i, __fadd_rn(lane(ai, i), gi));
          }
        }
      }
    }
    if (on) {
      V* out = reinterpret_cast<V*>(grad_q + (size_t)b * 2 * half);
      out[k] = ar;
      out[hv + k] = ai;
    }
  }
}

// offsets[e] = the first sorted position whose key is >= e, for e in [0, E].
__global__ void run_offsets(const int* __restrict__ keys, int M, int E, int* __restrict__ offsets) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > E) return;
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < e) lo = mid + 1; else hi = mid;
  }
  offsets[e] = lo;
}

// Pass 2: grad_table[e] = - sum of the element terms of e's occurrences, in
// the sorted order (ascending b n + j).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    score_grad_table(const float* __restrict__ q, const float* __restrict__ table,
                     const long long* __restrict__ order, const int* __restrict__ offsets,
                     const float* __restrict__ grad, float* __restrict__ grad_table, int n,
                     int half) {
  constexpr int W = Width<V>::value;
  __shared__ int s_b[kThreads];
  __shared__ float s_ng[kThreads];
  const int hv = half / W;
  const int e = blockIdx.x;
  const int t = threadIdx.x;
  const int lo = offsets[e], hi = offsets[e + 1];
  const V* xre = reinterpret_cast<const V*>(table + (size_t)e * 2 * half);
  for (int k0 = blockIdx.y * kThreads; k0 < hv; k0 += gridDim.y * kThreads) {
    const int k = k0 + t;
    const bool on = k < hv;
    const V x = on ? load_row(xre + k) : zero<V>(), y = on ? load_row(xre + hv + k) : zero<V>();
    V ar = zero<V>(), ai = zero<V>();
    for (int p0 = lo; p0 < hi; p0 += kThreads) {
      const int m = min(kThreads, hi - p0);
      __syncthreads();
      if (t < m) {
        const int o = (int)order[p0 + t];  // B n < 2^31: a 32-bit division
        s_b[t] = o / n;
        s_ng[t] = -grad[o];
      }
      __syncthreads();
      if (on) {
        // by 2: unrolled by 4, the calls to the root's and the division's
        // slow paths made the float4 instantiation spill
#pragma unroll 2
        for (int jj = 0; jj < m; ++jj) {
          const V* qre = reinterpret_cast<const V*>(q + (size_t)s_b[jj] * 2 * half);
          const V a = __ldg(qre + k), c = __ldg(qre + hv + k);
          const float ng = s_ng[jj];
#pragma unroll
          for (int i = 0; i < W; ++i) {
            float gr, gi;
            element_grad(lane(a, i), lane(c, i), lane(x, i), lane(y, i), ng, gr, gi);
            set_lane(ar, i, __fsub_rn(lane(ar, i), gr));
            set_lane(ai, i, __fsub_rn(lane(ai, i), gi));
          }
        }
      }
    }
    if (on) {
      V* out = reinterpret_cast<V*>(grad_table + (size_t)e * 2 * half);
      out[k] = ar;
      out[hv + k] = ai;
    }
  }
}

bool vec4(int half, const void* a, const void* b) {
  return half % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// Blocks along the width: one thread a vector.
unsigned width_blocks(int hv) {
  const int g = (hv + kThreads - 1) / kThreads;
  return (unsigned)(g < 65535 ? g : 65535);
}

}  // namespace

// Each entry point checks its shapes, launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success). q and table
// are f32 rows of re | im halves of `half` elements: q [B, 2 half], table
// [E, 2 half]; neg i32 [B, n]; grad f32 [B, n], the upstream gradient of
// the scores.

// out f32 [B, n].
extern "C" int rotate_score_forward(const float* q, const float* table, const int* neg,
                                    float* out, int B, int n, int half, int E, float gamma,
                                    void* stream) {
  if (B <= 0 || n <= 0 || half <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  const int gy = (n + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
  const dim3 grid((unsigned)B, (unsigned)(gy < 65535 ? gy : 65535));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4(half, q, table))
    score_forward<float4><<<grid, kThreads, 0, s>>>(q, table, neg, out, n, half, E, gamma);
  else
    score_forward<float><<<grid, kThreads, 0, s>>>(q, table, neg, out, n, half, E, gamma);
  return (int)cudaGetLastError();
}

// grad_q f32 [B, 2 half].
extern "C" int rotate_score_grad_query(const float* q, const float* table, const int* neg,
                                       const float* grad, float* grad_q, int B, int n,
                                       int half, int E, void* stream) {
  if (B <= 0 || n <= 0 || half <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4(half, q, table) && reinterpret_cast<uintptr_t>(grad_q) % 16 == 0)
    score_grad_query<float4><<<dim3((unsigned)B, width_blocks(half / 4)), kThreads, 0, s>>>(
        q, table, neg, grad, grad_q, n, half, E);
  else
    score_grad_query<float><<<dim3((unsigned)B, width_blocks(half)), kThreads, 0, s>>>(
        q, table, neg, grad, grad_q, n, half, E);
  return (int)cudaGetLastError();
}

// keys i32 [M], sorted ascending; offsets i32 [E + 1].
extern "C" int rotate_score_offsets(const int* keys, int M, int E, int* offsets, void* stream) {
  if (M <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  run_offsets<<<(unsigned)(E / kThreads + 1), kThreads, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(keys, M, E, offsets);
  return (int)cudaGetLastError();
}

// order i64 [B n]: the positions b n + j sorted by entity, stably; offsets
// from rotate_score_offsets; grad_table f32 [E, 2 half], every row written.
extern "C" int rotate_score_grad_table(const float* q, const float* table,
                                       const long long* order, const int* offsets,
                                       const float* grad, float* grad_table, int n, int half,
                                       int E, void* stream) {
  if (n <= 0 || half <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4(half, q, table) && reinterpret_cast<uintptr_t>(grad_table) % 16 == 0)
    score_grad_table<float4><<<dim3((unsigned)E, width_blocks(half / 4)), kThreads, 0, s>>>(
        q, table, order, offsets, grad, grad_table, n, half);
  else
    score_grad_table<float><<<dim3((unsigned)E, width_blocks(half)), kThreads, 0, s>>>(
        q, table, order, offsets, grad, grad_table, n, half);
  return (int)cudaGetLastError();
}

// Error text for a code returned above.
extern "C" const char* rotate_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
