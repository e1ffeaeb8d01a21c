// Fused fixed-iteration unbalanced Sinkhorn for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel in the JAX package's ops/sinkhorn_pallas.py
// (sinkhorn_unbalanced_pallas / _kernel). For each problem of a batch:
//
//     Kmat = exp(-C / eps)                                   (N, K)
//     n_iters times:  u = (a / (Kmat v + 1e-12))^ua
//                     v = (b / (Kmat^T u + 1e-12))^vb
//     out  = diag(u) Kmat diag(v)
//
// with ua = 1 / (1 + tau_a / eps) and vb = 1 / (1 + tau_b / eps) computed
// by the caller. Zero-mass rows (a_i = 0) give u_i = 0 and an exactly zero
// output row.
//
// What bounds it on this card: at the main path's shape (N = 1024, K = 8,
// 50 iterations, f64) the whole problem is 64 KiB of cost — nothing for
// the memory system. The time goes to launch latency and to the 50
// dependent block-wide column reductions (Kmat^T u), each a warp-shuffle
// tree plus two __syncthreads. The design answers that: ONE launch runs
// every iteration; each thread keeps the exp(-C/eps) values of its rows in
// registers (computed once, never re-read from memory); v lives in shared
// memory. One thread block per problem means a single problem occupies one
// SM of 132 — batching hypotheses or GN rounds into the grid (the leading
// batch axis is already here) is the way to fill the card, left to later
// work.
//
// Determinism: the column sums reduce in a fixed order (shuffle tree within
// each warp, then warps in index order by one thread per column) with no
// atomics, so repeated runs are bit-identical.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dev_pow(double x, double y) { return pow(x, y); }

// KMAX: compile-time bound on K (columns beyond K are zero-padded in
// registers). RMAX: rows per thread, N <= kThreads * RMAX.
template <typename T, int KMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const T* __restrict__ cost, const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, int N, int K, T eps, T ua, T vb, int n_iters) {
  const size_t prob = blockIdx.x;
  cost += prob * (size_t)N * K;
  out += prob * (size_t)N * K;
  a += prob * (size_t)N;
  b += prob * (size_t)K;

  __shared__ T v_sh[KMAX];
  __shared__ T part[kWarps][KMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T tiny = T(1e-12);

  T km[RMAX][KMAX];
  T a_row[RMAX];
  T u[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int i = tid + r * kThreads;
    const bool row_ok = i < N;
    a_row[r] = row_ok ? a[i] : T(0);
    u[r] = T(1);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      km[r][k] = (row_ok && k < K) ? dev_exp(-cost[(size_t)i * K + k] / eps) : T(0);
    }
  }
  const T b_col = tid < K ? b[tid] : T(0);
  if (tid < KMAX) v_sh[tid] = tid < K ? T(1) : T(0);
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    T col[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) col[k] = T(0);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      T kv = T(0);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) kv += km[r][k] * v_sh[k];
      u[r] = dev_pow(a_row[r] / (kv + tiny), ua);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) col[k] += km[r][k] * u[r];
    }
    // column sums: shuffle tree inside each warp, then warps in order
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) col[k] += __shfl_down_sync(0xffffffffu, col[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) part[warp][k] = col[k];
    }
    __syncthreads();
    if (tid < K) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][tid];
      v_sh[tid] = dev_pow(b_col / (s + tiny), vb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int i = tid + r * kThreads;
    if (i < N) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) out[(size_t)i * K + k] = (u[r] * km[r][k]) * v_sh[k];
      }
    }
  }
}

template <typename T, int KMAX>
cudaError_t launch_k(const T* cost, const T* a, const T* b, T* out, int B, int N, int K,
                     double eps, double ua, double vb, int n_iters, cudaStream_t stream) {
  const int rows = (N + kThreads - 1) / kThreads;
  const dim3 grid(B), block(kThreads);
  const T e = T(eps), pu = T(ua), pv = T(vb);
  if (rows <= 1) {
    sinkhorn_kernel<T, KMAX, 1><<<grid, block, 0, stream>>>(cost, a, b, out, N, K, e, pu, pv, n_iters);
  } else if (rows <= 2) {
    sinkhorn_kernel<T, KMAX, 2><<<grid, block, 0, stream>>>(cost, a, b, out, N, K, e, pu, pv, n_iters);
  } else if (rows <= 4) {
    sinkhorn_kernel<T, KMAX, 4><<<grid, block, 0, stream>>>(cost, a, b, out, N, K, e, pu, pv, n_iters);
  } else if (rows <= 8) {
    sinkhorn_kernel<T, KMAX, 8><<<grid, block, 0, stream>>>(cost, a, b, out, N, K, e, pu, pv, n_iters);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* cost, const void* a, const void* b, void* out, int B, int N, int K,
           double eps, double ua, double vb, int n_iters, void* stream) {
  if (B < 1 || N < 1 || K < 1 || K > 32 || N > 8 * kThreads || n_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const T* c = static_cast<const T*>(cost);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = K <= 8 ? launch_k<T, 8>(c, pa, pb, po, B, N, K, eps, ua, vb, n_iters, s)
                           : launch_k<T, 32>(c, pa, pb, po, B, N, K, eps, ua, vb, n_iters, s);
  return (int)err;
}

}  // namespace

extern "C" {

int gcslam_sinkhorn_f32(const void* cost, const void* a, const void* b, void* out, int B, int N,
                        int K, double eps, double ua, double vb, int n_iters, void* stream) {
  return launch<float>(cost, a, b, out, B, N, K, eps, ua, vb, n_iters, stream);
}

int gcslam_sinkhorn_f64(const void* cost, const void* a, const void* b, void* out, int B, int N,
                        int K, double eps, double ua, double vb, int n_iters, void* stream) {
  return launch<double>(cost, a, b, out, B, N, K, eps, ua, vb, n_iters, stream);
}

}  // extern "C"
