// Batched symmetric eigendecompositions for NVIDIA Hopper (sm_90a).
//
// Neither replaces a Pallas kernel. They replace jnp code that XLA fuses
// into one program in the JAX package, and that eager PyTorch runs as
// chains of small launches or as library calls that synchronize with the
// host:
//
//  - eigh3_kernel<T, kPsd>: the 3 x 3 cyclic Jacobi of the JAX package's
//    ops/linalg.py:160 (eigh_3x3, "~18 fused VPU steps"). The port's plain
//    version (ops/eigh.eigh3_reference, the chain of ops/linalg's
//    _jacobi_rot_3x3) is ~38 launches a rotation, 18 rotations a call.
//    One thread per matrix keeps A's six entries, V and the rotation in
//    registers and does the chain's arithmetic in its order: symmetrize,
//    scale by max|A|, 6 sweeps over (0,1), (0,2), (1,2) of
//    A <- sym(J^T A J), V <- V J, rescale, then the rank-based stable
//    ordering of ops/linalg.eigh_3x3. A rotation touches rows and columns
//    p, q of A and columns p, q of V alone (rotate_a, rotate_v): the terms
//    of the full 3 x 3 products that it leaves out add exact zeros, so the
//    result is the full products' to the bit but for the sign of a zero.
//    Its square roots and divisions are skipped where the `small` guard
//    discards them (rotation3: the later sweeps of a converged matrix).
//    The block's 128 matrices are read into shared memory and their
//    outputs written back with consecutive threads on consecutive words.
//    kPsd (gcslam::psd3, ops/eigh.psd3) fuses linalg.domain_projection_psd
//    for n = 3 into the same thread after the chain: M_sym, the floor
//    max(lambda, eps) (NaN kept), M_psd = V diag(vals) V^T summed over k in
//    order, and the six certificate fields, the JAX package's
//    ops/linalg.py:33 through its eigh_3x3 route, one launch where the
//    plain composition is eigh3 and 15 more kernels. Built with
//    --fmad=false, each rotation is the plain chain's IEEE operations; the
//    plain chain's 3 x 3 products and reconstruction go to cuBLAS, and its
//    norms are torch reductions, which may fuse and order their sums
//    otherwise, so the two agree to a few ulp.
//  - eigh_sym_kernel: a symmetric eigendecomposition of n x n for n <= 32
//    (the step's 6 x 6 and 22 x 22), replacing torch.linalg.eigh /
//    eigvalsh (cuSOLVER, whose info check synchronizes with the host)
//    where the JAX package calls jnp.linalg.eigh (ops/linalg.py:45,
//    models/scan_step.py:593). Fixed parallel-ordered Jacobi: each sweep is
//    n' - 1 rounds (n' = n rounded up to even) of the round-robin
//    ("circle") pairing, whose n'/2 disjoint rotations a round commute. The
//    rotation is eigh3's formula and guards, and a rotated pair's
//    off-diagonal entry is set to 0. The input is symmetrized and scaled by
//    max|A|, and the eigenvalues come out ascending by the same rank
//    ordering. No early exit and no info: kSymSweeps sweeps (the mirror of
//    ops/eigh.EIGH_SYM_SWEEPS), and a NaN input gives NaN out.
//    One CTA per matrix, of three kinds of warp:
//      * the block warps: A_{r+1} = J_r^T A_r J_r in 2 x 2 blocks. The block
//        of rows {p, q} of pair k and columns {p', q'} of pair k' depends
//        only on the same block of A_r and on the (c, s) of k and k'. A
//        thread per block (121 at 22 x 22) rotates its rows, then its
//        columns, and writes the other of two buffers of A;
//      * the rotation warp, a lane per pair: round r + 1's (c, s) computed
//        during round r from registers alone. The three entries of A_{r+1}
//        its pair needs (two diagonal, one off-diagonal) come from three
//        2 x 2 blocks of A_r, loaded in round r - 1, and round r's (c, s),
//        shuffled from the lanes that computed them, by the block warps'
//        operations; then the rotation. Its one wait a round is a named
//        barrier halfway through its chain (A_{r+1} and V written), after
//        which it loads its blocks of A_{r+1}; it publishes (c, s) on a
//        second named barrier without waiting. (c, s) are double-buffered;
//      * the V warps: V <- V J_r, read only at the end. At n = 6 and 22 one
//        warp keeps V in registers, a lane per row, a sweep's pairs
//        unrolled into constant indices; at other n, a thread per two
//        (pair, row) items of V in shared memory.
//    The pair tables (kRounds6, kRounds22, else circle()) and each rotation
//    lane's indices sit in shared memory, the indices loaded two rounds
//    ahead. Built with --fmad=false, every entry gets the IEEE operations of
//    the plain version (ops/eigh.eigh_sym_reference) in its order, so the
//    two are equal to the bit; tests/test_torch_eigh.py runs this round's
//    design in plain torch against the plain version on the CPU.
//
// What bounds them on this card: the bytes are 8 x (n^2 in + n + n^2 out)
// a matrix (psd3: 9 in, 15 out); the work is ~1.5k FLOPs a 3 x 3 matrix
// (psd3 ~140 more) and ~9 n^3 a sweep for eigh_sym. Both are far below the
// card's rates at the step's batches (1 to 8192 matrices of 3 x 3, 1 to 7
// of 6 x 6 or 22 x 22): latency bounds both. eigh3 is one thread's chain
// of dependent divisions and square roots; eigh3_chain_kernel runs that
// chain alone (its floor), and empty_kernel times the fixed cost of a
// launch. eigh_sym is kSymSweeps x (n' - 1) rounds (315 at 22 x 22)
// of one dependent chain on the rotation warp: the three entries, two
// square roots and two divisions, then the shuffles that hand (c, s) to the
// next round. eigh_sym_chain_kernel runs that chain alone in one thread
// (registers only, no barrier, no shuffle), the floor a round can reach;
// chip_smoke.py phase 2 times it beside the kernel. The design removes
// launches and host syncs (the step's bottleneck), then the passes,
// barriers and shared-memory loads that stood between two rotations.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads3 = 128;  // eigh3: matrices per block
constexpr int kSweeps3 = 6;     // eigh3: sweeps (ops/eigh.EIGH3_SWEEPS)
constexpr int kMaxN = 32;       // eigh_sym: the largest n
constexpr int kSymSweeps = 15;  // eigh_sym: sweeps (ops/eigh.EIGH_SYM_SWEEPS, from its convergence check)

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// NaN-propagating max (torch.amax's semantics)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// NaN-propagating min (torch.amin's semantics)
template <typename T>
__device__ __forceinline__ T nanmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// The rotation zeroing A[p, q] (ops/eigh._rotation): J[p, p] = J[q, q] = c,
// J[p, q] = s, J[q, p] = -s; `small` leaves J the identity. In two halves:
// t = tan(theta), then (c, s) from t.
template <typename T>
__device__ __forceinline__ T rotation_t(T app, T aqq, T apq, bool& small) {
  const T d = aqq - app;
  const T r = dsqrt(d * d + T(4.0) * apq * apq);
  small = fabs(apq) <= T(1e-24) * (fabs(app) + fabs(aqq) + T(1e-30));
  const T sgn = d >= T(0) ? T(1) : T(-1);
  return small ? T(0) : sgn * T(2.0) * apq / (fabs(d) + r + T(1e-300));
}

template <typename T>
__device__ __forceinline__ void rotation_cs(T t, T& c, T& s) {
  c = T(1) / dsqrt(T(1) + t * t);
  s = t * c;
}

template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s, bool& small) {
  rotation_cs(rotation_t(app, aqq, apq, small), c, s);
}

// eigh3's rotation: rotation()'s (c, s) and guards, with the square roots
// and divisions skipped where `small` discards them: t = 0 gives
// c = 1 / sqrt(1 + 0 * 0) = 1 and s = 0 * 1 = 0 exactly. A converged 3 x 3
// Jacobi's later rotations are all `small`, so this takes most of its
// chain's square roots and divisions (some on subnormal operands) off.
template <typename T>
__device__ __forceinline__ void rotation3(T app, T aqq, T apq, T& c, T& s) {
  if (fabs(apq) <= T(1e-24) * (fabs(app) + fabs(aqq) + T(1e-30))) {
    c = T(1);
    s = T(0);
  } else {
    bool small;
    rotation(app, aqq, apq, c, s, small);
  }
}

// The sparse rotation of a symmetric 3 x 3 A zeroing A[p][q] (r the third
// index), on its entries app, aqq, apq, apr = A[p][r], aqr = A[q][r]: the
// non-zero terms of X = J^T A and Y = X J in their order, then
// A <- 0.5 (Y + Y^T). A is exactly symmetric, so Y[p][r] == Y[r][p] and
// 0.5 (y + y) == y (|y| <= 3 after the scaling): the diagonal and the r
// column take Y's entry itself; A[r][r] does not change.
template <typename T>
__device__ __forceinline__ void rotate_a(T& app, T& aqq, T& apq, T& apr, T& aqr, T c, T s) {
  const T xpp = c * app - s * apq, xpq = c * apq - s * aqq;
  const T xqp = s * app + c * apq, xqq = s * apq + c * aqq;
  app = c * xpp - s * xpq;
  aqq = s * xqp + c * xqq;
  apq = T(0.5) * ((s * xpp + c * xpq) + (c * xqp - s * xqq));
  const T npr = c * apr - s * aqr;
  aqr = s * apr + c * aqr;
  apr = npr;
}

// V <- V J for the rotation of (P, Q): columns P and Q of V, the non-zero
// terms of the product in their order.
template <int P, int Q, typename T>
__device__ __forceinline__ void rotate_v(T V[9], T c, T s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T x = V[3 * i + P], y = V[3 * i + Q];
    V[3 * i + P] = c * x - s * y;
    V[3 * i + Q] = s * x + c * y;
  }
}

// x[o] for o in {0, 1, 2}, by selects (no local-memory indexing)
template <typename T>
__device__ __forceinline__ T pick3(T x0, T x1, T x2, int o) {
  return o == 0 ? x0 : (o == 1 ? x1 : x2);
}

// A = sym(m) as its six entries a = (a00, a11, a22, a01, a02, a12), scaled
// by max|A| (1 if that is 0 or NaN); returns the scale.
template <typename T>
__device__ __forceinline__ T sym_scaled3(const T m[9], T a[6]) {
  a[0] = T(0.5) * (m[0] + m[0]), a[1] = T(0.5) * (m[4] + m[4]), a[2] = T(0.5) * (m[8] + m[8]);
  a[3] = T(0.5) * (m[1] + m[3]), a[4] = T(0.5) * (m[2] + m[6]), a[5] = T(0.5) * (m[5] + m[7]);
  T scale = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) scale = nanmax(scale, T(fabs(a[k])));
  const T sc = scale > T(0) ? scale : T(1);
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = a[k] / sc;
  return sc;
}

// eigh3's kSweeps3 sweeps over (0, 1), (0, 2), (1, 2) on a (sym_scaled3's
// order) and, with kV, on V.
template <typename T, bool kV>
__device__ __forceinline__ void sweeps3(T a[6], T V[9]) {
  for (int sweep = 0; sweep < kSweeps3; ++sweep) {
    T c, s;
    rotation3(a[0], a[1], a[3], c, s);
    rotate_a(a[0], a[1], a[3], a[4], a[5], c, s);
    if constexpr (kV) rotate_v<0, 1>(V, c, s);
    rotation3(a[0], a[2], a[4], c, s);
    rotate_a(a[0], a[2], a[4], a[3], a[5], c, s);
    if constexpr (kV) rotate_v<0, 2>(V, c, s);
    rotation3(a[1], a[2], a[5], c, s);
    rotate_a(a[1], a[2], a[5], a[3], a[4], c, s);
    if constexpr (kV) rotate_v<1, 2>(V, c, s);
  }
}

// eigh3 / psd3 of the block's kThreads3 matrices: loads and stores go
// through shared memory, consecutive threads on consecutive words; each
// thread then runs one matrix's chain in registers. kPsd: after the chain,
// linalg.domain_projection_psd's result for n = 3 (gcslam::psd3): out9 gets
// M_psd, out_small the six PsdCert fields; else out9 the eigenvectors and
// out_small the eigenvalues.
template <typename T, bool kPsd>
__global__ void __launch_bounds__(kThreads3)
eigh3_kernel(const T* __restrict__ M, T* __restrict__ out9, T* __restrict__ out_small, long long n_mat, T eps,
             T null_below) {
  constexpr int kSmall = kPsd ? 6 : 3;  // out_small's values a matrix
  __shared__ T tile[kThreads3 * 9];
  __shared__ T tile_small[kThreads3 * kSmall];
  const long long first = (long long)blockIdx.x * kThreads3;
  const int here = (int)(n_mat - first < kThreads3 ? n_mat - first : kThreads3);
  const int tid = threadIdx.x;
  for (int e = tid; e < 9 * here; e += kThreads3) tile[e] = M[9 * first + e];
  __syncthreads();
  T o9[9], os[kSmall];
  if (tid < here) {
    T m[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = tile[9 * tid + k];
    // psd3: M_sym = sym(M), on which the projection calls eigh3, which
    // symmetrizes once more
    T ms[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) ms[3 * i + j] = kPsd ? T(0.5) * (m[3 * i + j] + m[3 * j + i]) : m[3 * i + j];
    T a[6], V[9];
    const T sc = sym_scaled3(ms, a);
#pragma unroll
    for (int k = 0; k < 9; ++k) V[k] = (k % 4 == 0) ? T(1) : T(0);
    sweeps3<T, true>(a, V);
    const T lam[3] = {a[0] * sc, a[1] * sc, a[2] * sc};
    int rank[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rank[i] = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j) rank[i] += (lam[j] < lam[i]) || (lam[j] == lam[i] && j < i);
    }
    T w[3], U[9];  // eigenvalues ascending, eigenvectors as columns
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int o = 0;  // argmax of (rank == k): the first such index, else 0
#pragma unroll
      for (int i = 2; i >= 0; --i)
        if (rank[i] == k) o = i;
      w[k] = pick3(lam[0], lam[1], lam[2], o);
#pragma unroll
      for (int r = 0; r < 3; ++r) U[3 * r + k] = pick3(V[3 * r], V[3 * r + 1], V[3 * r + 2], o);
    }
    if constexpr (kPsd) {
      T vals[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) vals[k] = nanmax(w[k], eps);  // torch.clamp / jnp.maximum: NaN stays
      T sym_sq = T(0), proj_sq = T(0);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // M_psd = (V * vals) V^T, summed over k in order
          T acc = (U[3 * i] * vals[0]) * U[3 * j];
          acc = acc + (U[3 * i + 1] * vals[1]) * U[3 * j + 1];
          acc = acc + (U[3 * i + 2] * vals[2]) * U[3 * j + 2];
          o9[3 * i + j] = acc;
          const T ds = ms[3 * i + j] - m[3 * i + j], dp = acc - ms[3 * i + j];
          sym_sq = sym_sq + ds * ds;
          proj_sq = proj_sq + dp * dp;
        }
      const T lo = nanmin(nanmin(vals[0], vals[1]), vals[2]);
      const T hi = nanmax(nanmax(vals[0], vals[1]), vals[2]);
      os[0] = dsqrt(proj_sq);
      os[1] = dsqrt(sym_sq);
      os[2] = lo;
      os[3] = hi;
      os[4] = hi / lo;
      os[5] = T(int(vals[0] < null_below) + int(vals[1] < null_below) + int(vals[2] < null_below));
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) o9[k] = U[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) os[k] = w[k];
    }
  }
  __syncthreads();  // every thread has read its matrix out of `tile`
  if (tid < here) {
#pragma unroll
    for (int k = 0; k < 9; ++k) tile[9 * tid + k] = o9[k];
#pragma unroll
    for (int k = 0; k < kSmall; ++k) tile_small[kSmall * tid + k] = os[k];
  }
  __syncthreads();
  for (int e = tid; e < 9 * here; e += kThreads3) out9[9 * first + e] = tile[e];
  for (int e = tid; e < kSmall * here; e += kThreads3) out_small[kSmall * first + e] = tile_small[e];
}

// Player at position `pos` of round `r` in the circle pairing of m players.
__device__ __forceinline__ int circle(int pos, int r, int m) { return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1); }

// The round-robin pairs (p, q) of every round of a sweep at the step's n = 6
// and 22: ops/eigh.round_robin(n), which tests/test_torch_eigh.py reads
// these tables to compare with. Other n take the same pairing from circle().
__constant__ unsigned char kRounds6[5][3][2] = {
    {{0, 5}, {1, 4}, {2, 3}},
    {{0, 1}, {2, 5}, {3, 4}},
    {{0, 2}, {1, 3}, {4, 5}},
    {{0, 3}, {2, 4}, {1, 5}},
    {{0, 4}, {3, 5}, {1, 2}},
};
__constant__ unsigned char kRounds22[21][11][2] = {
    {{0, 21}, {1, 20}, {2, 19}, {3, 18}, {4, 17}, {5, 16}, {6, 15}, {7, 14}, {8, 13}, {9, 12}, {10, 11}},
    {{0, 1}, {2, 21}, {3, 20}, {4, 19}, {5, 18}, {6, 17}, {7, 16}, {8, 15}, {9, 14}, {10, 13}, {11, 12}},
    {{0, 2}, {1, 3}, {4, 21}, {5, 20}, {6, 19}, {7, 18}, {8, 17}, {9, 16}, {10, 15}, {11, 14}, {12, 13}},
    {{0, 3}, {2, 4}, {1, 5}, {6, 21}, {7, 20}, {8, 19}, {9, 18}, {10, 17}, {11, 16}, {12, 15}, {13, 14}},
    {{0, 4}, {3, 5}, {2, 6}, {1, 7}, {8, 21}, {9, 20}, {10, 19}, {11, 18}, {12, 17}, {13, 16}, {14, 15}},
    {{0, 5}, {4, 6}, {3, 7}, {2, 8}, {1, 9}, {10, 21}, {11, 20}, {12, 19}, {13, 18}, {14, 17}, {15, 16}},
    {{0, 6}, {5, 7}, {4, 8}, {3, 9}, {2, 10}, {1, 11}, {12, 21}, {13, 20}, {14, 19}, {15, 18}, {16, 17}},
    {{0, 7}, {6, 8}, {5, 9}, {4, 10}, {3, 11}, {2, 12}, {1, 13}, {14, 21}, {15, 20}, {16, 19}, {17, 18}},
    {{0, 8}, {7, 9}, {6, 10}, {5, 11}, {4, 12}, {3, 13}, {2, 14}, {1, 15}, {16, 21}, {17, 20}, {18, 19}},
    {{0, 9}, {8, 10}, {7, 11}, {6, 12}, {5, 13}, {4, 14}, {3, 15}, {2, 16}, {1, 17}, {18, 21}, {19, 20}},
    {{0, 10}, {9, 11}, {8, 12}, {7, 13}, {6, 14}, {5, 15}, {4, 16}, {3, 17}, {2, 18}, {1, 19}, {20, 21}},
    {{0, 11}, {10, 12}, {9, 13}, {8, 14}, {7, 15}, {6, 16}, {5, 17}, {4, 18}, {3, 19}, {2, 20}, {1, 21}},
    {{0, 12}, {11, 13}, {10, 14}, {9, 15}, {8, 16}, {7, 17}, {6, 18}, {5, 19}, {4, 20}, {3, 21}, {1, 2}},
    {{0, 13}, {12, 14}, {11, 15}, {10, 16}, {9, 17}, {8, 18}, {7, 19}, {6, 20}, {5, 21}, {1, 4}, {2, 3}},
    {{0, 14}, {13, 15}, {12, 16}, {11, 17}, {10, 18}, {9, 19}, {8, 20}, {7, 21}, {1, 6}, {2, 5}, {3, 4}},
    {{0, 15}, {14, 16}, {13, 17}, {12, 18}, {11, 19}, {10, 20}, {9, 21}, {1, 8}, {2, 7}, {3, 6}, {4, 5}},
    {{0, 16}, {15, 17}, {14, 18}, {13, 19}, {12, 20}, {11, 21}, {1, 10}, {2, 9}, {3, 8}, {4, 7}, {5, 6}},
    {{0, 17}, {16, 18}, {15, 19}, {14, 20}, {13, 21}, {1, 12}, {2, 11}, {3, 10}, {4, 9}, {5, 8}, {6, 7}},
    {{0, 18}, {17, 19}, {16, 20}, {15, 21}, {1, 14}, {2, 13}, {3, 12}, {4, 11}, {5, 10}, {6, 9}, {7, 8}},
    {{0, 19}, {18, 20}, {17, 21}, {1, 16}, {2, 15}, {3, 14}, {4, 13}, {5, 12}, {6, 11}, {7, 10}, {8, 9}},
    {{0, 20}, {19, 21}, {1, 18}, {2, 17}, {3, 16}, {4, 15}, {5, 14}, {6, 13}, {7, 12}, {8, 11}, {9, 10}},
};

// The shape of an eigh_sym instance: NT > 0 fixes n at compile time (the
// step's 6 and 22: constant extents, no odd-n dummy pair, V in registers);
// NT == 0 takes any n <= kMaxN. The CTA is the rotation warp (a lane per
// pair), the V warps (NT > 0: one, a lane per row of V; NT == 0: a thread
// per two (pair, row) items of V in shared memory) and the block warps (a
// thread per 2 x 2 block of A).
template <int NT>
struct SymShape {
  static_assert(NT == 0 || NT == 6 || NT == 22, "kRounds tables exist for n = 6 and 22");
  static constexpr int kN = NT > 0 ? NT : kMaxN;
  static constexpr int kLd = kN + 1;  // row stride of A and V in shared memory
  static constexpr int kPairs = (kN + 1) / 2;
  static constexpr int kRounds = 2 * kPairs - 1;
  static constexpr bool kEven = NT > 0;  // 6 and 22: every pair rotates
  static constexpr int kVWarps = NT > 0 ? 1 : (kPairs * kN + 63) / 64;
  static constexpr int kBlockWarps = (kPairs * kPairs + 31) / 32;
  static constexpr int kThreads = 32 * (1 + kVWarps + kBlockWarps);
};

template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
};
template <>
struct Pair2<double> {
  using type = double2;
};

// The rounds' two named barriers (0 is __syncthreads). kPublished: the
// rotation warp arrives once it has stored round g + 1's (c, s), and the
// block and V warps wait on it before round g + 1. kWritten: the block and
// V warps arrive once round g's A_{g+1} and V are written, and the rotation
// warp waits on it halfway through its chain, before it loads from A_{g+1}.
constexpr int kPublished = 1, kWritten = 2;

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// bar_sync placed after `after` is computed
__device__ __forceinline__ void bar_sync_after(int id, int count, double after) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count), "d"(after) : "memory");
}
__device__ __forceinline__ void bar_sync_after(int id, int count, float after) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count), "f"(after) : "memory");
}

// Pair k of round r, p < q (q == n: the odd-n dummy pair, which does not rotate).
template <int NT>
__device__ __forceinline__ void round_pair(int r, int k, int players, int& p, int& q) {
  int a, b;
  if constexpr (NT == 6) {
    a = kRounds6[r][k][0];
    b = kRounds6[r][k][1];
  } else if constexpr (NT == 22) {
    a = kRounds22[r][k][0];
    b = kRounds22[r][k][1];
  } else {
    a = circle(k, r, players);
    b = circle(players - 1 - k, r, players);
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// What rotation lane k' needs in round r to compute the rotation of round
// r + 1: its pair (p', q') of round r + 1 lies in pairs k1 = (p1, q1) and
// k2 = (p2, q2) of round r, p' on side1 of k1 and q' on side2 of k2 (0: the
// p side, 1: the q side). `sides`: side1 | side2 << 1 | (q' < n) << 2.
struct alignas(8) RotIdx {
  unsigned char k1, k2, p1, q1, p2, q2, sides;
};

// Entry (i, j) of A_{r+1} = J^T A J for row i on side si of pair (pi, qi)
// and column j on side sj of pair (pj, qj) of round r, as the block warps
// compute it, from a = A[pi][pj], b = A[pi][qj], c = A[qi][pj],
// d = A[qi][qj]: row i of J^T A at columns pj and qj, then column j of the
// product with J. c x - s y equals c x + (-s) y to the bit, so a side picks
// (u, v) = (c, -s) or (s, c) without a branch. A dummy pair does not
// rotate; `zero`: (i, j) is the off-diagonal entry of a rotated pair.
template <typename T>
__device__ __forceinline__ T block_entry(T a, T b, T c, T d, bool row_rot, int si, T ci, T s_i, bool col_rot, int sj,
                                         T cj, T s_j, bool zero) {
  const T ui = si ? s_i : ci, vi = si ? ci : -s_i;
  const T x = row_rot ? ui * a + vi * c : a;
  if (!col_rot) return x;
  const T y = row_rot ? ui * b + vi * d : b;
  const T uj = sj ? s_j : cj, vj = sj ? cj : -s_j;
  return zero ? T(0) : uj * x + vj * y;
}

// The three 2 x 2 blocks of A (rows and columns {p1, q1} and {p2, q2}) a
// rotation lane reads: (k1, k1), (k2, k2) and (k1, k2) of `ri`.
template <typename T, int LD>
__device__ __forceinline__ void load_blocks(const T (*A)[LD], const RotIdx& ri, T x11[4], T x22[4], T x12[4]) {
  x11[0] = A[ri.p1][ri.p1], x11[1] = A[ri.p1][ri.q1], x11[2] = A[ri.q1][ri.p1], x11[3] = A[ri.q1][ri.q1];
  x22[0] = A[ri.p2][ri.p2], x22[1] = A[ri.p2][ri.q2], x22[2] = A[ri.q2][ri.p2], x22[3] = A[ri.q2][ri.q2];
  x12[0] = A[ri.p1][ri.p2], x12[1] = A[ri.p1][ri.q2], x12[2] = A[ri.q1][ri.p2], x12[3] = A[ri.q1][ri.q2];
}

template <typename T, int NT>
__global__ void __launch_bounds__(SymShape<NT>::kThreads)
eigh_sym_kernel(const T* __restrict__ M, T* __restrict__ lam_out, T* __restrict__ vec_out, int n_arg) {
  using S = SymShape<NT>;
  using T2 = typename Pair2<T>::type;
  constexpr int kAll = S::kThreads;
  __shared__ T A[2][S::kN][S::kLd];  // A_g and A_{g+1}
  __shared__ T V[S::kN][S::kLd];
  __shared__ T2 cs[2][32];  // (c, s) of rounds g and g + 1, a slot per lane of the rotation warp
  __shared__ bool rotated[2][32];
  __shared__ uchar2 pq[S::kRounds][S::kPairs];       // (p, q) of every pair of every round of a sweep
  __shared__ unsigned char slot[S::kRounds][S::kN];  // 2 k + side of index x in round r
  __shared__ RotIdx rot_idx[S::kRounds][S::kPairs];
  __shared__ T warp_max[S::kThreads / 32];
  __shared__ T lam[S::kN];
  __shared__ int rank[S::kN];
  __shared__ int order[S::kN];
  const int n = NT > 0 ? NT : n_arg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nn = n * n;
  const T* m = M + (size_t)blockIdx.x * nn;
  const int players = n + (n & 1);
  const int pairs = players / 2;
  const int rounds = players - 1;

  for (int e = tid; e < rounds * pairs; e += kAll) {
    const int r = e / pairs, k = e % pairs;
    int p, q;
    round_pair<NT>(r, k, players, p, q);
    pq[r][k] = make_uchar2((unsigned char)p, (unsigned char)q);
    slot[r][p] = (unsigned char)(2 * k);
    if (q < n) slot[r][q] = (unsigned char)(2 * k + 1);
  }
  T local_max = T(0);
  for (int e = tid; e < nn; e += kAll) {
    const int i = e / n, j = e % n;
    const T a = T(0.5) * (m[i * n + j] + m[j * n + i]);
    A[0][i][j] = a;
    V[i][j] = i == j ? T(1) : T(0);
    local_max = nanmax(local_max, T(fabs(a)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local_max = nanmax(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if (lane == 0) warp_max[warp] = local_max;
  __syncthreads();
  T scale = T(0);
#pragma unroll
  for (int w = 0; w < S::kThreads / 32; ++w) scale = nanmax(scale, warp_max[w]);
  const T scale_safe = scale > T(0) ? scale : T(1);
  for (int e = tid; e < nn; e += kAll) A[0][e / n][e % n] = A[0][e / n][e % n] / scale_safe;
  for (int e = tid; e < rounds * pairs; e += kAll) {
    const int r = e / pairs, k = e % pairs;
    const uchar2 next = pq[r + 1 == rounds ? 0 : r + 1][k];
    const int s1 = slot[r][next.x], s2 = next.y < n ? slot[r][next.y] : s1;  // the dummy pair's is never read
    const uchar2 a = pq[r][s1 >> 1], b = pq[r][s2 >> 1];
    rot_idx[r][k] = RotIdx{(unsigned char)(s1 >> 1), (unsigned char)(s2 >> 1), a.x, a.y, b.x, b.y,
                           (unsigned char)((s1 & 1) | (s2 & 1) << 1 | (next.y < n) << 2)};
  }
  __syncthreads();

  // The rounds: in round g the rotation warp computes round g + 1's (c, s),
  // the block warps A_{g+1} and the V warps V J_g, from round g's buffers.
  const int total = kSymSweeps * rounds;
  if (warp == 0) {
    // Every lane runs the chain, so that the warp never diverges: lanes past
    // the pairs repeat lane 0's work into slots of their own that nothing reads.
    const unsigned all = 0xffffffffu;
    const int me = lane < pairs ? lane : 0;
    T c, s;
    bool small;
    {  // round 0's rotations, from A_0 itself
      const uchar2 pr = pq[0][me];
      rotation(A[0][pr.x][pr.x], A[0][pr.y][pr.y], A[0][pr.x][pr.y], c, s, small);
      cs[0][lane] = T2{c, s};
      rotated[0][lane] = pr.y < n && !small;  // the odd-n dummy pair (q == n) does not rotate
    }
    RotIdx ri = rot_idx[0][me], ahead = rot_idx[rounds > 1 ? 1 : 0][me];
    T x11[4], x22[4], x12[4];
    load_blocks(A[0], ri, x11, x22, x12);
    T c1 = __shfl_sync(all, c, ri.k1), s1 = __shfl_sync(all, s, ri.k1);
    T c2 = __shfl_sync(all, c, ri.k2), s2 = __shfl_sync(all, s, ri.k2);
    bool rot1 = S::kEven ? false : __shfl_sync(all, (int)(rotated[0][lane]), ri.k1) != 0;
    __syncthreads();  // round 0's (c, s) published
    int cur = 0, r = 0;
    for (int g = 0; g + 1 < total; ++g) {  // round g computes round g + 1's rotations
      const int r1 = r + 1 == rounds ? 0 : r + 1, r2 = r1 + 1 == rounds ? 0 : r1 + 1;
      const RotIdx ahead2 = rot_idx[r2][me];  // round g + 2's indices, used in round g + 1
      const bool rot_1 = S::kEven || ri.q1 < n, rot_2 = S::kEven || ri.q2 < n;
      const int side1 = ri.sides & 1, side2 = (ri.sides >> 1) & 1;
      // n <= 2 only: the pair of round g + 1 was a pair of round g
      const bool zero = !S::kEven && ri.k1 == ri.k2 && side1 != side2 && rot1;
      const T app = block_entry(x11[0], x11[1], x11[2], x11[3], rot_1, side1, c1, s1, rot_1, side1, c1, s1, false);
      const T aqq = block_entry(x22[0], x22[1], x22[2], x22[3], rot_2, side2, c2, s2, rot_2, side2, c2, s2, false);
      const T apq = block_entry(x12[0], x12[1], x12[2], x12[3], rot_1, side1, c1, s1, rot_2, side2, c2, s2, zero);
      const T t = rotation_t(app, aqq, apq, small);
      bar_sync_after(kWritten, kAll, t);  // A_{g+1} written, round g's (c, s) read
      load_blocks(A[cur ^ 1], ahead, x11, x22, x12);
      rotation_cs(t, c, s);
      const bool rot = (ri.sides >> 2) && !small;  // bit 2: a real pair (not the odd-n dummy)
      cs[cur ^ 1][lane] = T2{c, s};
      rotated[cur ^ 1][lane] = rot;
      bar_arrive(kPublished, kAll);
      c1 = __shfl_sync(all, c, ahead.k1), s1 = __shfl_sync(all, s, ahead.k1);
      c2 = __shfl_sync(all, c, ahead.k2), s2 = __shfl_sync(all, s, ahead.k2);
      if constexpr (!S::kEven) rot1 = __shfl_sync(all, (int)rot, ahead.k1) != 0;
      ri = ahead;
      ahead = ahead2;
      cur ^= 1;
      r = r1;
    }
    bar_sync(kWritten, kAll);  // the last round's A and V
  } else {
    __syncthreads();  // round 0's (c, s) published
    if (warp <= S::kVWarps) {
      if constexpr (NT > 0) {
        // V J in registers, lane i holding row i of V: a sweep's rounds
        // unrolled, so every pair (circle()'s, as kRounds lists them) is a
        // constant index.
        T v[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) v[j] = j == lane ? T(1) : T(0);
        int cur = 0;
        for (int sweep = 0; sweep < kSymSweeps; ++sweep) {
#pragma unroll
          for (int r = 0; r < NT - 1; ++r) {
            if (sweep > 0 || r > 0) bar_sync(kPublished, kAll);
#pragma unroll
            for (int k = 0; k < NT / 2; ++k) {
              const int a = circle(k, r, NT), b = circle(NT - 1 - k, r, NT);
              const int p = a < b ? a : b, q = a < b ? b : a;
              const T2 w = cs[cur][k];
              const T x = v[p], y = v[q];
              v[p] = w.x * x - w.y * y;
              v[q] = w.y * x + w.x * y;
            }
            bar_arrive(kWritten, kAll);
            cur ^= 1;
          }
        }
        if (lane < n)
#pragma unroll
          for (int j = 0; j < NT; ++j) V[lane][j] = v[j];
      } else {  // columns p, q of V J in shared memory, in place: V is read only at the end
        int cur = 0, r = 0;
        for (int g = 0; g < total; ++g) {
          if (g > 0) bar_sync(kPublished, kAll);
          for (int u = tid - 32; u < pairs * n; u += 32 * S::kVWarps) {
            const int k = u / n, i = u - k * n;
            const uchar2 pr = pq[r][k];
            if (pr.y < n) {
              const T2 w = cs[cur][k];
              const T x = V[i][pr.x], y = V[i][pr.y];
              V[i][pr.x] = w.x * x - w.y * y;
              V[i][pr.y] = w.y * x + w.x * y;
            }
          }
          bar_arrive(kWritten, kAll);
          cur ^= 1;
          r = r + 1 == rounds ? 0 : r + 1;
        }
      }
    } else {  // block (k, l): rows {p, q} of pair k, columns {p', q'} of pair l
      const int t = tid - 32 * (1 + S::kVWarps);
      const int k = t / S::kPairs, l = t - k * S::kPairs;  // NT == 0: blocks of kPairs x kPairs, those in range work
      const bool mine = k < pairs && l < pairs;
      int cur = 0, r = 0;
      for (int g = 0; g < total; ++g) {
        if (g > 0) bar_sync(kPublished, kAll);
        if (mine) {
          const uchar2 rk = pq[r][k], rl = pq[r][l];
          const int p = rk.x, q = rk.y, pc = rl.x, qc = rl.y;
          const bool row_rot = S::kEven || q < n, col_rot = S::kEven || qc < n;
          const T(*Ac)[S::kLd] = A[cur];
          T(*An)[S::kLd] = A[cur ^ 1];
          T a = Ac[p][pc];
          T b = col_rot ? Ac[p][qc] : T(0);
          T c = row_rot ? Ac[q][pc] : T(0);
          T d = row_rot && col_rot ? Ac[q][qc] : T(0);
          if (row_rot) {  // rows p, q of J^T A
            const T2 w = cs[cur][k];
            const T a1 = w.x * a - w.y * c, c1 = w.y * a + w.x * c;
            const T b1 = w.x * b - w.y * d, d1 = w.y * b + w.x * d;
            a = a1, b = b1, c = c1, d = d1;
          }
          if (col_rot) {  // then columns p', q' of (J^T A) J
            const T2 w = cs[cur][l];
            const T a2 = w.x * a - w.y * b, b2 = w.y * a + w.x * b;
            const T c2 = w.x * c - w.y * d, d2 = w.y * c + w.x * d;
            a = a2, b = b2, c = c2, d = d2;
          }
          if (k == l && rotated[cur][k]) b = c = T(0);
          An[p][pc] = a;
          if (col_rot) An[p][qc] = b;
          if (row_rot) An[q][pc] = c;
          if (row_rot && col_rot) An[q][qc] = d;
        }
        bar_arrive(kWritten, kAll);
        cur ^= 1;
        r = r + 1 == rounds ? 0 : r + 1;
      }
    }
  }
  __syncthreads();

  const int fin = total & 1;  // the buffer of the last A
  if (tid < n) lam[tid] = A[fin][tid][tid] * scale_safe;
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
  for (int e = tid; e < nn; e += kAll) vec_out[base * nn + e] = V[e / n][order[e % n]];
}

// The latency floor of an eigh_sym round (chip_smoke.py phase 2): the
// rotation lane's chain alone, round after dependent round, in one thread,
// with A in registers and no barrier. Each round recomputes the three
// entries of the next pair (0, 3) from the 4 x 4 block `blk` (pairs (0, 1)
// and (2, 3)) and the last round's (c, s), then takes the rotation; `out`
// gets the last (c, s). Its plain version is ops/eigh.sym_chain_reference.
template <typename T>
__global__ void eigh_sym_chain_kernel(const T* __restrict__ blk, T* __restrict__ out, int n_rounds) {
  T a[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = blk[e];
  T c = T(1), s = T(0);
  for (int g = 0; g < n_rounds; ++g) {
    const T app = block_entry(a[0], a[1], a[4], a[5], true, 0, c, s, true, 0, c, s, false);
    const T aqq = block_entry(a[10], a[11], a[14], a[15], true, 1, c, s, true, 1, c, s, false);
    const T apq = block_entry(a[2], a[3], a[6], a[7], true, 0, c, s, true, 1, c, s, false);
    bool small;
    rotation(app, aqq, apq, c, s, small);
  }
  out[0] = c;
  out[1] = s;
}

// The latency floor of eigh3 (chip_smoke.py phase 2): the dependent chain
// of its 18 rotations in one thread, registers only, on one matrix M: the
// symmetrization and scaling, then per rotation (c, s) and the sparse update
// of A (rotate_a), whose entries the next rotation reads. No V, no
// ordering, no batch. `out` gets the scaled diagonal of the last A; its
// plain version is ops/eigh.eigh3_chain_reference.
template <typename T>
__global__ void eigh3_chain_kernel(const T* __restrict__ M, T* __restrict__ out) {
  T m[9], a[6];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = M[k];
  sym_scaled3(m, a);
  sweeps3<T, false>(a, nullptr);
  out[0] = a[0];
  out[1] = a[1];
  out[2] = a[2];
}

// A kernel that does nothing, launched as one thread: the fixed cost of a
// launch of this library on the card (chip_smoke.py phase 2).
__global__ void empty_kernel() {}

template <typename T, bool kPsd>
int launch_eigh3(const void* M, void* out9, void* out_small, long long n_mat, double eps, double null_below,
                 void* stream) {
  if (n_mat <= 0) return 0;
  const long long blocks = (n_mat + kThreads3 - 1) / kThreads3;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  eigh3_kernel<T, kPsd><<<(unsigned)blocks, kThreads3, 0, (cudaStream_t)stream>>>(
      (const T*)M, (T*)out9, (T*)out_small, n_mat, (T)eps, (T)null_below);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
void launch_sym(const T* M, T* lam, T* vec, int n_mat, int n, cudaStream_t st) {
  eigh_sym_kernel<T, NT><<<n_mat, SymShape<NT>::kThreads, 0, st>>>(M, lam, vec, n);
}

template <typename T>
int launch_eigh_sym(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  if (n_mat <= 0) return 0;
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 6)
    launch_sym<T, 6>((const T*)M, (T*)lam, (T*)vec, n_mat, n, st);
  else if (n == 22)
    launch_sym<T, 22>((const T*)M, (T*)lam, (T*)vec, n_mat, n, st);
  else
    launch_sym<T, 0>((const T*)M, (T*)lam, (T*)vec, n_mat, n, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym_chain(const void* blk, void* out, int n_rounds, void* stream) {
  eigh_sym_chain_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>((const T*)blk, (T*)out, n_rounds);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_eigh3_chain(const void* M, void* out, void* stream) {
  eigh3_chain_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>((const T*)M, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcslam_eigh3_chain_f32(const void* M, void* out, void* stream) {
  return launch_eigh3_chain<float>(M, out, stream);
}

extern "C" int gcslam_eigh3_chain_f64(const void* M, void* out, void* stream) {
  return launch_eigh3_chain<double>(M, out, stream);
}

extern "C" int gcslam_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int gcslam_eigh3_f32(const void* M, void* lam, void* vec, long long n_mat, void* stream) {
  return launch_eigh3<float, false>(M, vec, lam, n_mat, 0.0, 0.0, stream);
}

extern "C" int gcslam_eigh3_f64(const void* M, void* lam, void* vec, long long n_mat, void* stream) {
  return launch_eigh3<double, false>(M, vec, lam, n_mat, 0.0, 0.0, stream);
}

// psd3: M_psd (n_mat, 3, 3) and the certificate (n_mat, 6) of
// domain_projection_psd(M, eps); null_below = 10 eps (near_null_count)
extern "C" int gcslam_psd3_f32(const void* M, void* M_psd, void* cert, long long n_mat, double eps,
                               double null_below, void* stream) {
  return launch_eigh3<float, true>(M, M_psd, cert, n_mat, eps, null_below, stream);
}

extern "C" int gcslam_psd3_f64(const void* M, void* M_psd, void* cert, long long n_mat, double eps,
                               double null_below, void* stream) {
  return launch_eigh3<double, true>(M, M_psd, cert, n_mat, eps, null_below, stream);
}

extern "C" int gcslam_eigh_sym_f32(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  return launch_eigh_sym<float>(M, lam, vec, n_mat, n, stream);
}

extern "C" int gcslam_eigh_sym_f64(const void* M, void* lam, void* vec, int n_mat, int n, void* stream) {
  return launch_eigh_sym<double>(M, lam, vec, n_mat, n, stream);
}

extern "C" int gcslam_eigh_sym_chain_f32(const void* blk, void* out, int n_rounds, void* stream) {
  return launch_sym_chain<float>(blk, out, n_rounds, stream);
}

extern "C" int gcslam_eigh_sym_chain_f64(const void* blk, void* out, int n_rounds, void* stream) {
  return launch_sym_chain<double>(blk, out, n_rounds, stream);
}
