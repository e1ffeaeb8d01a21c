// Fused fixed-iteration unbalanced Sinkhorn for NVIDIA Hopper (sm_90a):
// one thread-block cluster per problem.
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
// What bounds it on this card: at the main path's shapes (N = 1024 or 1536,
// K = 8, 50 iterations, f64) the problem is 139-209 KB and ~2 MFLOP —
// nothing for the memory system or the FP64 pipes. The time is the latency
// of 50 dependent iterations, each a row update (N power functions) and a
// column reduction over all N rows (Kmat^T u) whose result every row needs.
//
// Design:
// - The rows of one problem are split over a cluster of CL <= 8 blocks
//   (the portable maximum), one row per thread, so the N row updates run
//   on CL SMs. The launcher picks CL from N (layout() below); the grid is
//   B x CL blocks. Each thread keeps its row's exp(-C/eps) in registers,
//   computed once.
// - The row update is u = exp(ua (log a - log(Kv + 1e-12))) with log a taken
//   once per row (a log and an exp in place of a divide and a pow); zero-mass
//   rows are flagged and give exactly 0.
// - Column sums: each warp reduces its K <= 8 columns with a transpose-reduce
//   (9 shuffles in place of 8 trees of 5) and pushes them through
//   distributed shared memory into every block of the cluster (a (rank,
//   warp, column) slot each, double-buffered by iteration parity). ONE
//   cluster barrier per iteration (barrier.cluster arrive.release /
//   wait.acquire); then every warp of every block sums the cluster's
//   partials from its own block's copy in the same fixed order, so all
//   blocks get bit-identical v with no second barrier and no block-wide
//   serial tail. Pushing (remote stores before the barrier) in place of
//   pulling (remote loads after it) overlaps the cross-SM traffic with the
//   barrier. The parity buffer makes the next iteration's writes safe:
//   a block writes buffer it & 1 again only after the barrier of iteration
//   it + 1, which every block reaches after its reads of iteration it. A
//   first arrive/wait pair makes sure every block of the cluster runs
//   before any remote store reaches it.
// - No atomics: repeat runs are bit-identical.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success). gcslam_sinkhorn_layout reports
// the cluster size and block width the launcher picks for N rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kRowsPerBlock = 128;  // target rows per block before the cluster is full
constexpr int kMaxThreads = 256;    // one row per thread: N <= 8 x 256
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }

// (num / den)^p = exp(p (log num - log den)) for num > 0; exactly 0 for
// num = 0, as pow(0, p > 0).
template <typename T>
__device__ __forceinline__ T power_ratio(bool num_zero, T log_num, T den, T p) {
  return num_zero ? T(0) : dev_exp(p * (log_num - dev_log(den)));
}

// Sums each of the KMAX columns over the warp. While a lane holds w > 1
// columns it swaps half of them with the lane `off` away and adds (KMAX = 8:
// 4 + 2 + 1 shuffles); then butterfly steps finish the sum (2 more). Lane l
// returns the warp's sum of column l / (32 / KMAX); lanes that share a
// column hold bit-identical values (a + b == b + a).
template <typename T, int KMAX>
__device__ __forceinline__ T warp_column_sums(T (&col)[KMAX], int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int off = 16 >> s;
    const int w = KMAX >> s;  // columns still held
    if (w > 1) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int j = 0; j < w / 2; ++j) {
        const T keep = upper ? col[j + w / 2] : col[j];
        const T send = upper ? col[j] : col[j + w / 2];
        col[j] = keep + __shfl_xor_sync(kFull, send, off);
      }
    } else {
      col[0] += __shfl_xor_sync(kFull, col[0], off);
    }
  }
  return col[0];
}

// The cluster barrier, split: arrive.release orders this thread's earlier
// (remote) stores before the other blocks' wait.acquire returns.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// KMAX: compile-time bound on K (columns beyond K are zero in registers).
template <typename T, int KMAX>
__global__ void __launch_bounds__(kMaxThreads)
sinkhorn_kernel(const T* __restrict__ cost, const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, int N, int K, int rows_per_block, T eps, T ua, T vb,
                int n_iters) {
  constexpr int kLanesPerCol = 32 / KMAX;
  constexpr int kRanksPerGroup = (kMaxCluster + kLanesPerCol - 1) / kLanesPerCol;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const size_t prob = blockIdx.x / cl;
  cost += prob * (size_t)N * K;
  out += prob * (size_t)N * K;
  a += prob * (size_t)N;
  b += prob * (size_t)K;

  // the cluster's per-(rank, warp) column partials, double-buffered by
  // iteration parity; every block holds its own copy
  __shared__ T part[2][kMaxCluster][kMaxWarps][KMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const T tiny = T(1e-12);

  const int i = rank * rows_per_block + tid;  // this thread's row
  const bool row_ok = tid < rows_per_block && i < N;
  T km[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    km[k] = (row_ok && k < K) ? dev_exp(-cost[(size_t)i * K + k] / eps) : T(0);
  }
  const T a_i = row_ok ? a[i] : T(0);
  const bool a_zero = a_i == T(0);
  const T log_a = dev_log(a_i);

  // v's column update: lane (col, grp) = (lane % KMAX, lane / KMAX)
  const int col = lane % KMAX;
  const int grp = lane / KMAX;
  const T b_k = col < K ? b[col] : T(0);
  const bool b_zero = b_k == T(0);
  const T log_b = dev_log(b_k);

  T v[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) v[k] = k < K ? T(1) : T(0);
  T u = T(1);
  // every block of the cluster runs before the first remote store
  cluster_arrive();
  cluster_wait();

  for (int it = 0; it < n_iters; ++it) {
    T kv = T(0);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) kv += km[k] * v[k];
    u = power_ratio(a_zero, log_a, kv + tiny, ua);

    T c[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) c[k] = km[k] * u;
    const T warp_sum = warp_column_sums<T, KMAX>(c, lane);
    // push: of the lanes that hold a column, lane j stores it into ranks
    // j, j + 32/KMAX, ...
    const int par = it & 1;
    T* slot = &part[par][rank][warp][lane / kLanesPerCol];
#pragma unroll
    for (int rr = 0; rr < kRanksPerGroup; ++rr) {
      const int r = lane % kLanesPerCol + rr * kLanesPerCol;
      if (r < cl) *cluster.map_shared_rank(slot, r) = warp_sum;
    }
    cluster_arrive();
    cluster_wait();

    // column `col` over the cluster: lane group g sums ranks g, g + 32/KMAX,
    // ... (each rank's warps in order), then a butterfly over the groups —
    // one fixed order, the same in every warp of every block. The loads are
    // unconditional (slots past the cluster or the block width are read and
    // add 0), so all of them are in flight at once.
    T s = T(0);
#pragma unroll
    for (int rr = 0; rr < kRanksPerGroup; ++rr) {
      const int r = grp + rr * kLanesPerCol;
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w) {
        const T x = part[par][r][w][col];
        s += (r < cl && w < warps) ? x : T(0);
      }
    }
#pragma unroll
    for (int off = KMAX; off < 32; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
    const T v_col = power_ratio(b_zero, log_b, s + tiny, vb);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) v[k] = __shfl_sync(kFull, v_col, k);
  }

  if (row_ok) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) out[(size_t)i * K + k] = (u * km[k]) * v[k];
    }
  }
}

// Blocks per cluster: the smallest power of two (<= 8) that leaves each at
// most 128 rows; then rows spread evenly, one per thread, in whole warps.
void layout(int N, int* cl, int* rows_per_block, int* threads) {
  int c = 1;
  while (c < kMaxCluster && c * kRowsPerBlock < N) c <<= 1;
  *cl = c;
  *rows_per_block = (N + c - 1) / c;
  *threads = 32 * ((*rows_per_block + 31) / 32);
}

template <typename T, int KMAX>
cudaError_t launch_k(const T* cost, const T* a, const T* b, T* out, int B, int N, int K,
                     double eps, double ua, double vb, int n_iters, cudaStream_t stream) {
  int cl, rows, threads;
  layout(N, &cl, &rows, &threads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(B * cl));
  config.blockDim = dim3((unsigned)threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, sinkhorn_kernel<T, KMAX>, cost, a, b, out, N, K, rows, T(eps),
                            T(ua), T(vb), n_iters);
}

template <typename T>
int launch(const void* cost, const void* a, const void* b, void* out, int B, int N, int K,
           double eps, double ua, double vb, int n_iters, void* stream) {
  if (B < 1 || B > INT_MAX / kMaxCluster || N < 1 || K < 1 || K > 32 ||
      N > kMaxCluster * kMaxThreads || n_iters < 0) {
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

int gcslam_sinkhorn_layout(int N, int* cluster, int* threads) {
  if (N < 1 || N > kMaxCluster * kMaxThreads) return (int)cudaErrorInvalidValue;
  int rows;
  layout(N, cluster, &rows, threads);
  return 0;
}

}  // extern "C"
