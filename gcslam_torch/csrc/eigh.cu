// Batched symmetric eigendecompositions for NVIDIA Hopper (sm_90a).
//
// Neither replaces a Pallas kernel. They replace jnp code that XLA fuses
// into one program in the JAX package, and that eager PyTorch runs as
// chains of small launches or as library calls that synchronize with the
// host:
//
//  - eigh3_kernel: the 3 x 3 cyclic Jacobi of the JAX package's
//    ops/linalg.py:160 (eigh_3x3, "~18 fused VPU steps"). The port's plain
//    version (ops/eigh.eigh3_reference, the chain of ops/linalg's
//    _jacobi_rot_3x3) is ~38 launches a rotation, 18 rotations a call.
//    One thread per matrix keeps A, V and the rotation in registers and
//    does the chain's arithmetic in its order: symmetrize, scale by
//    max|A|, 6 sweeps over (0,1), (0,2), (1,2) of A <- sym(J^T A J),
//    V <- V J with the full 3 x 3 products (their zero terms add exact
//    zeros, and a NaN spreads as it does through the products), rescale,
//    then the rank-based stable ordering of ops/linalg.eigh_3x3. Built with
//    --fmad=false, each rotation is the plain chain's IEEE operations; the
//    plain chain's 3 x 3 products go to cuBLAS, which may fuse and order
//    its sums otherwise, so the two agree to a few ulp.
//  - eigh_sym_kernel: a symmetric eigendecomposition of n x n for n <= 32
//    (the step's 6 x 6 and 22 x 22), replacing torch.linalg.eigh /
//    eigvalsh (cuSOLVER, whose info check synchronizes with the host)
//    where the JAX package calls jnp.linalg.eigh (ops/linalg.py:45,
//    models/scan_step.py:593). One CTA of 512 threads per matrix, A and V
//    in shared memory, the round-robin pairs of a sweep in a table there;
//    instances with n fixed at compile time for the step's 6 and 22.
//    Fixed parallel-ordered Jacobi: each sweep is n' - 1
//    rounds (n' = n rounded up to even) of the round-robin ("circle")
//    pairing, whose n'/2 disjoint rotations per round commute; a round is
//    the pairs' rotations (a thread each), one pass over rows p, q of A
//    (a thread per (pair, column)) and one over columns p, q of A and V (a
//    thread per (pair, row)), with the rotated pair's off-diagonal entry
//    set to 0: 3 barriers a round.
//    The rotation is eigh3's formula and guards; the input is symmetrized
//    and scaled by max|A|, the eigenvalues come out ascending by the same
//    rank ordering. No early exit and no info: kSymSweeps sweeps (the
//    mirror of ops/eigh.EIGH_SYM_SWEEPS), and a NaN input gives NaN out. Built with
//    --fmad=false, it performs the operations of its plain version
//    (ops/eigh.eigh_sym_reference) in the same order.
//
// What bounds them on this card: the bytes are 8 x (n^2 in + n + n^2 out)
// a matrix; the work is ~1.5k FLOPs a 3 x 3 matrix and ~9 n^3 a sweep
// for eigh_sym. Both are far below the card's rates at the step's batches
// (1 to 8192 matrices of 3 x 3, 1 to 7 of 6 x 6 or 22 x 22): what bounds
// them in practice is latency, a chain of dependent divisions and square
// roots (eigh3) and 3 barriers a round over 21 rounds a sweep at 22 x 22
// (eigh_sym). The design removes launches and host syncs, the step's
// bottleneck, not device time.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads3 = 128;  // eigh3: matrices per block
constexpr int kMaxN = 32;       // eigh_sym: the largest n
constexpr int kSymThreads = 512;  // eigh_sym: threads of a matrix's CTA (one column pass at n = 22)
constexpr int kSymSweeps = 15;    // eigh_sym: sweeps (ops/eigh.EIGH_SYM_SWEEPS, from its convergence check)

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// NaN-propagating max (torch.amax's semantics)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The rotation zeroing A[p, q] (ops/eigh._rotation): J[p, p] = J[q, q] = c,
// J[p, q] = s, J[q, p] = -s; `small` leaves J the identity.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s, bool& small) {
  const T d = aqq - app;
  const T r = dsqrt(d * d + T(4.0) * apq * apq);
  small = fabs(apq) <= T(1e-24) * (fabs(app) + fabs(aqq) + T(1e-30));
  const T sgn = d >= T(0) ? T(1) : T(-1);
  const T t = small ? T(0) : sgn * T(2.0) * apq / (fabs(d) + r + T(1e-300));
  c = T(1) / dsqrt(T(1) + t * t);
  s = t * c;
}

// out = x @ y for 3 x 3, each sum over k in order
template <typename T>
__device__ __forceinline__ void mm3(const T x[9], const T y[9], T out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = x[3 * i] * y[j] + x[3 * i + 1] * y[3 + j] + x[3 * i + 2] * y[6 + j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads3)
eigh3_kernel(const T* __restrict__ M, T* __restrict__ lam_out, T* __restrict__ vec_out, long long n_mat) {
  const long long b = blockIdx.x * (long long)kThreads3 + threadIdx.x;
  if (b >= n_mat) return;
  const T* m = M + 9 * b;
  T A[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[3 * i + j] = T(0.5) * (m[3 * i + j] + m[3 * j + i]);
  T scale = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) scale = nanmax(scale, T(fabs(A[k])));
  const T scale_safe = scale > T(0) ? scale : T(1);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    A[k] = A[k] / scale_safe;
    V[k] = (k % 4 == 0) ? T(1) : T(0);
  }
  for (int sweep = 0; sweep < 6; ++sweep) {
#pragma unroll
    for (int rot = 0; rot < 3; ++rot) {
      const int p = rot == 2 ? 1 : 0;
      const int q = rot == 0 ? 1 : 2;
      T c, s;
      bool small;
      rotation(A[4 * p], A[4 * q], A[3 * p + q], c, s, small);
      T J[9], Jt[9], X[9], Y[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) J[k] = (k % 4 == 0) ? T(1) : T(0);
      J[4 * p] = c;
      J[4 * q] = c;
      J[3 * p + q] = s;
      J[3 * q + p] = -s;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Jt[3 * i + j] = J[3 * j + i];
      mm3(Jt, A, X);
      mm3(X, J, Y);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) A[3 * i + j] = T(0.5) * (Y[3 * i + j] + Y[3 * j + i]);
      mm3(V, J, X);
#pragma unroll
      for (int k = 0; k < 9; ++k) V[k] = X[k];
    }
  }
  T lam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) lam[i] = A[4 * i] * scale_safe;
  int rank[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rank[i] = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) rank[i] += (lam[j] < lam[i]) || (lam[j] == lam[i] && j < i);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int o = 0;  // argmax of (rank == k): the first such index, else 0
#pragma unroll
    for (int i = 2; i >= 0; --i)
      if (rank[i] == k) o = i;
    lam_out[3 * b + k] = lam[o];
#pragma unroll
    for (int r = 0; r < 3; ++r) vec_out[9 * b + 3 * r + k] = V[3 * r + o];
  }
}

// Player at position `pos` of round `r` in the circle pairing of m players.
__device__ __forceinline__ int circle(int pos, int r, int m) { return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1); }

// NT > 0: n fixed at compile time (the step's 6 and 22: constant index
// arithmetic, unrolled passes); NT == 0: any n <= kMaxN from n_arg.
template <typename T, int NT>
__global__ void __launch_bounds__(kSymThreads)
eigh_sym_kernel(const T* __restrict__ M, T* __restrict__ lam_out, T* __restrict__ vec_out, int n_arg) {
  __shared__ T A[kMaxN][kMaxN + 1];
  __shared__ T V[kMaxN][kMaxN + 1];
  __shared__ T cs[kMaxN / 2][2];
  __shared__ unsigned char pq[kMaxN - 1][kMaxN / 2][2];  // (p, q) of every pair of every round of a sweep
  __shared__ bool rotated[kMaxN / 2];
  __shared__ T warp_max[kSymThreads / 32];
  __shared__ T lam[kMaxN];
  __shared__ int rank[kMaxN];
  __shared__ int order[kMaxN];
  const int n = NT > 0 ? NT : n_arg;
  const int tid = threadIdx.x;
  const int nn = n * n;
  const T* m = M + (size_t)blockIdx.x * nn;
  const int players = n + (n & 1);
  const int pairs = players / 2;
  const int items = pairs * n;  // (pair, row or column) updates of a pass

  for (int e = tid; e < (players - 1) * pairs; e += kSymThreads) {
    const int r = e / pairs, k = e % pairs;
    const int a = circle(k, r, players), b = circle(players - 1 - k, r, players);
    pq[r][k][0] = (unsigned char)(a < b ? a : b);
    pq[r][k][1] = (unsigned char)(a < b ? b : a);
  }
  T local_max = T(0);
  for (int e = tid; e < nn; e += kSymThreads) {
    const int i = e / n, j = e % n;
    const T a = T(0.5) * (m[i * n + j] + m[j * n + i]);
    A[i][j] = a;
    V[i][j] = i == j ? T(1) : T(0);
    local_max = nanmax(local_max, T(fabs(a)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local_max = nanmax(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if (tid % 32 == 0) warp_max[tid / 32] = local_max;
  __syncthreads();
  T scale = T(0);
#pragma unroll
  for (int w = 0; w < kSymThreads / 32; ++w) scale = nanmax(scale, warp_max[w]);
  const T scale_safe = scale > T(0) ? scale : T(1);
  for (int e = tid; e < nn; e += kSymThreads) A[e / n][e % n] = A[e / n][e % n] / scale_safe;
  __syncthreads();

  for (int sweep = 0; sweep < kSymSweeps; ++sweep) {
    for (int r = 0; r < players - 1; ++r) {
      if (tid < pairs) {
        const int p = pq[r][tid][0], q = pq[r][tid][1];
        bool small = true;  // the odd-n dummy pair (q == n) does not rotate
        if (q < n) {
          T c, s;
          rotation(A[p][p], A[q][q], A[p][q], c, s, small);
          cs[tid][0] = c;
          cs[tid][1] = s;
        }
        rotated[tid] = !small;
      }
      __syncthreads();
      for (int t = tid; t < items; t += kSymThreads) {  // rows p, q of J^T A
        const int k = t / n, j = t % n;
        const int p = pq[r][k][0], q = pq[r][k][1];
        if (q >= n) continue;
        const T c = cs[k][0], s = cs[k][1];
        const T x = A[p][j], y = A[q][j];
        A[p][j] = c * x - s * y;
        A[q][j] = s * x + c * y;
      }
      __syncthreads();
      for (int t = tid; t < 2 * items; t += kSymThreads) {  // columns p, q of (J^T A) J, then of V J
        const bool on_v = t >= items;
        const int u = on_v ? t - items : t;
        const int k = u / n, i = u % n;
        const int p = pq[r][k][0], q = pq[r][k][1];
        if (q >= n) continue;
        const T c = cs[k][0], s = cs[k][1];
        if (on_v) {
          const T x = V[i][p], y = V[i][q];
          V[i][p] = c * x - s * y;
          V[i][q] = s * x + c * y;
        } else {
          const T x = A[i][p], y = A[i][q];
          A[i][p] = (rotated[k] && i == q) ? T(0) : c * x - s * y;
          A[i][q] = (rotated[k] && i == p) ? T(0) : s * x + c * y;
        }
      }
      __syncthreads();
    }
  }

  if (tid < n) lam[tid] = A[tid][tid] * scale_safe;
  __syncthreads();
  if (tid < n) {
    int rk = 0;
    for (int j = 0; j < n; ++j) rk += (lam[j] < lam[tid]) || (lam[j] == lam[tid] && j < tid);
    rank[tid] = rk;
  }
  __syncthreads();
  if (tid < n) {
    int o = 0;  // argmax of (rank == k): the first such index, else 0
    for (int i = n - 1; i >= 0; --i)
      if (rank[i] == tid) o = i;
    order[tid] = o;
  }
  __syncthreads();
  const size_t base = (size_t)blockIdx.x;
  if (tid < n) lam_out[base * n + tid] = lam[order[tid]];
  for (int e = tid; e < nn; e += kSymThreads) vec_out[base * nn + e] = V[e / n][order[e % n]];
}

template <typename T>
int launch_eigh3(const void* M, void* lam, void* vec, long long n_mat, void* stream) {
  if (n_mat <= 0) return 0;
  const long long blocks = (n_mat + kThreads3 - 1) / kThreads3;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  eigh3_kernel<T><<<(unsigned)blocks, kThreads3, 0, (cudaStream_t)stream>>>(
      (const T*)M, (T*)lam, (T*)vec, n_mat);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_eigh_sym(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  if (n_mat <= 0) return 0;
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_mat), block(kSymThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 6)
    eigh_sym_kernel<T, 6><<<grid, block, 0, st>>>((const T*)M, (T*)lam, (T*)vec, n);
  else if (n == 22)
    eigh_sym_kernel<T, 22><<<grid, block, 0, st>>>((const T*)M, (T*)lam, (T*)vec, n);
  else
    eigh_sym_kernel<T, 0><<<grid, block, 0, st>>>((const T*)M, (T*)lam, (T*)vec, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcslam_eigh3_f32(const void* M, void* lam, void* vec, long long n_mat, void* stream) {
  return launch_eigh3<float>(M, lam, vec, n_mat, stream);
}

extern "C" int gcslam_eigh3_f64(const void* M, void* lam, void* vec, long long n_mat, void* stream) {
  return launch_eigh3<double>(M, lam, vec, n_mat, stream);
}

extern "C" int gcslam_eigh_sym_f32(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  return launch_eigh_sym<float>(M, lam, vec, n_mat, n, stream);
}

extern "C" int gcslam_eigh_sym_f64(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  return launch_eigh_sym<double>(M, lam, vec, n_mat, n, stream);
}
