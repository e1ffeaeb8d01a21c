// The SO(3) / SE(3) maps and the 3 x 3 inverse of the scan step, one launch
// a call, for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel. It replaces the jnp maps of the JAX
// package's ops/se3.py (so3_exp, so3_log, se3_exp, se3_log, se3_compose,
// se3_inverse, se3_relative, skew) and ops/linalg.py (inv3x3), which XLA
// fuses into the step's one program on the TPU. Eager PyTorch runs each call
// of the port's plain versions (gcslam_torch/ops/se3.py, ops/linalg.py) as
// 17-195 kernels: an eye, stacks of stacks, a batched 3 x 3 product, the
// `where`s, sin / cos / atan2 and a softmax, each a launch, at batches of 1
// to 8192 elements. A flagship scan makes 78 such calls, ~5,100 of the
// captured step's ~12,000 kernels.
//
// What bounds it on this card: launch latency. An element reads at most 12
// numbers and writes at most 9, and does a few hundred operations (sin, cos,
// atan2 and divisions among them), so even the largest call, (8192, 6),
// moves under 1 MB: far below the card's bytes and operations for a few
// microseconds of kernel. The design answers with one launch a call:
// lie_kernel<T, kOp> runs one thread per element of the call's broadcast
// batch, with every intermediate in registers, and sizes the grid from the
// batch, so one design serves (3,) and (8192, 6). Each input is read
// through its strides (a broadcast operand has stride 0 and costs no copy);
// the output is contiguous, allocated by the caller.
//
// The same work as the plain version, in one documented order: each
// element performs the plain version's IEEE operations. Composites stay
// composite (se3_relative is se3_compose(se3_inverse(b), a), se3_log takes
// so3_log(so3_exp(rotvec))), the three so3_log branches keep their
// thresholds and the softmax axis weighting, and every `where` computes
// both sides' values. Every dot product of three terms (the entries of the
// 3 x 3 products, the squared norms) is a chain of fused multiply-adds over
// k = 0, 1, 2, fma(x2, y2, fma(x1, y1, x0 y0)), written out (dot3); every
// other sum of three is summed left to right (sum3); --fmad=false keeps
// the compiler from contracting anything else. The plain version's
// reductions and products run in the orders that torch and cuBLAS choose
// for the shape, so an output that passes through one may part from it in
// the last bits (skew and inv3x3, elementwise there too, are its outputs to
// the bit); tests/test_torch_cuda.py holds the rest within 2e-15 (double)
// and 1e-6 (float) of the output's largest entry. A Python float of the
// plain version enters as T(x); `x / t` with a tensor t as (T(1) / t) * x,
// which is how Tensor.__rtruediv__ spells it; and inv3x3's signed
// determinant floor, which torch.where of two Python floats makes in
// float32, through float.
//
// C interface (ctypes): pointers and the stream as void*, the layout as an
// array of long long, returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDims = 8;  // batch dims a call (ops/se3.MAX_DIMS)
constexpr double kSmallAngle = 1e-7;  // ops/se3.SMALL_ANGLE
constexpr double kSmallAngle2 = kSmallAngle * kSmallAngle;  // SMALL_ANGLE**2
constexpr double kNearPiSin = 1e-5;
constexpr double kVinvEps = 1e-12;

// The op codes: their order is ops/se3.OPS
enum Op : int { kSo3Exp, kSo3Log, kSe3Exp, kSe3Log, kSe3Compose, kSe3Inverse, kSe3Relative, kSkew, kInv3x3 };

// The call's layout, from the meta array: the broadcast batch's sizes, each
// input's strides over it (0 where it broadcasts), and each input's strides
// over its own trailing dims (a vector: [stride, 0]; a 3 x 3: [row, column]).
struct Layout {
  long long size[kMaxDims];
  long long a_stride[kMaxDims];
  long long b_stride[kMaxDims];
  long long a_inner[2];
  long long b_inner[2];
  int ndim;
};

__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }

// torch.clamp / clamp_min: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return is_nan(x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return is_nan(x) ? x : (x < lo ? lo : x);
}

// NaN-propagating max (torch.amax, softmax's row max)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return a > b ? a : b;
}

// the entry (k / 3, k % 3) of the identity, as torch.eye holds it
template <typename T>
__device__ __forceinline__ T eye(int k) {
  return (k % 4 == 0) ? T(1) : T(0);
}

// skew(v): [[0, -z, y], [z, 0, -x], [-y, x, 0]]
template <typename T>
__device__ __forceinline__ void skew(const T v[3], T K[9]) {
  K[0] = T(0);  K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2];  K[4] = T(0);  K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0];  K[8] = T(0);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// x0 + x1 + x2, left to right
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return (x0 + x1) + x2;
}

// x . y, a chain of fused multiply-adds over k
template <typename T>
__device__ __forceinline__ T dot3(T x0, T x1, T x2, T y0, T y1, T y2) {
  return fma_rn(x2, y2, fma_rn(x1, y1, x0 * y0));
}

template <typename T>
__device__ __forceinline__ T sum_sq3(const T v[3]) {
  return dot3(v[0], v[1], v[2], v[0], v[1], v[2]);
}

// C = A B
template <typename T>
__device__ __forceinline__ void matmul3(const T A[9], const T B[9], T C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = dot3(A[3 * i], A[3 * i + 1], A[3 * i + 2], B[j], B[3 + j], B[6 + j]);
    }
  }
}

// y = A x
template <typename T>
__device__ __forceinline__ void matvec3(const T A[9], const T x[3], T y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = dot3(A[3 * i], A[3 * i + 1], A[3 * i + 2], x[0], x[1], x[2]);
  }
}

// so3_exp: Rodrigues, R = (I + A K) + B K^2
template <typename T>
__device__ void so3_exp(const T w[3], T R[9]) {
  const T theta_sq = sum_sq3(w);
  const T theta = m_sqrt(theta_sq);
  T K[9], K2[9];
  skew(w, K);
  matmul3(K, K, K2);
  const bool small = theta < T(kSmallAngle);
  const T safe_t = small ? T(1) : theta;
  const T safe_t2 = theta_sq < T(kSmallAngle2) ? T(1) : theta_sq;
  const T sin_over_t = m_sin(safe_t) / safe_t;
  const T one_minus_cos_over_t2 = (T(1) - m_cos(safe_t)) / safe_t2;
  const T A = small ? T(1) : sin_over_t;
  const T B = small ? T(0.5) : one_minus_cos_over_t2;
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = (eye<T>(k) + A * K[k]) + B * K2[k];
}

// so3_log: the small-angle / generic / near-pi blend, the near-pi axis a
// softmax(50 diag)-weighted column of (S - c I) / (1 - c)
template <typename T>
__device__ void so3_log(const T R[9], T out[3]) {
  const T tr = sum3(R[0], R[4], R[8]);
  const T cos_theta = clamp(T(0.5) * (tr - T(1)), T(-1), T(1));
  T vex[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
#pragma unroll
  for (int i = 0; i < 3; ++i) vex[i] = T(0.5) * vex[i];
  const T sin_theta = m_sqrt(sum_sq3(vex));
  const T theta = m_atan2(sin_theta, cos_theta);

  const T safe_sin = sin_theta < T(kSmallAngle) ? T(1) : sin_theta;
  const T ratio = theta / safe_sin;

  const T one_minus_c = clamp_min(T(1) - cos_theta, T(kSmallAngle));
  T outer[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * i + j;
      const T s_sym = T(0.5) * (R[k] + R[3 * j + i]);
      outer[k] = (s_sym - cos_theta * eye<T>(k)) / one_minus_c;
    }
  }
  T x[3] = {T(50) * outer[0], T(50) * outer[4], T(50) * outer[8]};
  const T x_max = nanmax(nanmax(x[0], x[1]), x[2]);
  T w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = m_exp(x[i] - x_max);
  const T w_sum = sum3(w[0], w[1], w[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = w[i] / w_sum;
  T axis[3];
  matvec3(outer, w, axis);
  const T axis_norm = m_sqrt(sum_sq3(axis));
  const T safe_norm = axis_norm < T(kSmallAngle) ? T(1) : axis_norm;
#pragma unroll
  for (int i = 0; i < 3; ++i) axis[i] = axis[i] / safe_norm;
  const T dot = dot3(axis[0], axis[1], axis[2], vex[0], vex[1], vex[2]);
  const T sign = dot >= T(0) ? T(1) : T(-1);

  const bool is_small = theta < T(kSmallAngle);
  const bool is_near_pi = (cos_theta < T(0)) && (sin_theta < T(kNearPiSin));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T omega_pi = (axis[i] * sign) * theta;
    const T omega_general = ratio * vex[i];
    out[i] = is_small ? vex[i] : (is_near_pi ? omega_pi : omega_general);
  }
}

// se3_V: (I + B K) + C K^2, with B, C of _BC_coeffs
template <typename T>
__device__ void se3_V(const T phi[3], T V[9]) {
  const T theta_sq = sum_sq3(phi);
  const T theta = m_sqrt(theta_sq);
  T K[9], K2[9];
  skew(phi, K);
  const bool small = theta < T(kSmallAngle);
  const T safe_t = small ? T(1) : theta;
  const T safe_t2 = theta_sq < T(kSmallAngle2) ? T(1) : theta_sq;
  const T safe_t3 = safe_t2 * safe_t;
  const T B_small = T(0.5) - theta_sq / T(24);
  const T B_gen = (T(1) - m_cos(safe_t)) / safe_t2;
  const T C_small = T(1.0 / 6.0) - theta_sq / T(120);
  const T C_gen = (safe_t - m_sin(safe_t)) / safe_t3;
  const T B = small ? B_small : B_gen;
  const T C = small ? C_small : C_gen;
  matmul3(K, K, K2);
#pragma unroll
  for (int k = 0; k < 9; ++k) V[k] = (eye<T>(k) + B * K[k]) + C * K2[k];
}

// se3_V_inv: (I - 0.5 K) + D K^2
template <typename T>
__device__ void se3_V_inv(const T phi[3], T Vi[9]) {
  const T theta_sq = sum_sq3(phi);
  const T theta = m_sqrt(theta_sq);
  T K[9], K2[9];
  skew(phi, K);
  const bool small = theta < T(kSmallAngle);
  const T safe_t = small ? T(1) : theta;
  const T safe_t2 = theta_sq < T(kSmallAngle2) ? T(1) : theta_sq;
  const T denom = (T(2) * safe_t) * m_sin(safe_t) + T(kVinvEps);
  const T D_small = T(1.0 / 12.0) + theta_sq / T(720);
  const T D_gen = T(1) / safe_t2 - (T(1) + m_cos(safe_t)) / denom;
  const T D = small ? D_small : D_gen;
  matmul3(K, K, K2);
#pragma unroll
  for (int k = 0; k < 9; ++k) Vi[k] = (eye<T>(k) - T(0.5) * K[k]) + D * K2[k];
}

// se3_exp: [V(phi) rho, phi]
template <typename T>
__device__ void se3_exp(const T xi[6], T out[6]) {
  T V[9];
  se3_V(xi + 3, V);
  matvec3(V, xi, out);
#pragma unroll
  for (int i = 3; i < 6; ++i) out[i] = xi[i];
}

// se3_log: phi = so3_log(so3_exp(rotvec)), [V_inv(phi) t, phi]
template <typename T>
__device__ void se3_log(const T pose[6], T out[6]) {
  T R[9], Vi[9];
  so3_exp(pose + 3, R);
  so3_log(R, out + 3);
  se3_V_inv(out + 3, Vi);
  matvec3(Vi, pose, out);
}

// se3_compose: [t_a + R_a t_b, so3_log(R_a R_b)]
template <typename T>
__device__ void se3_compose(const T a[6], const T b[6], T out[6]) {
  T Ra[9], Rb[9], RaRb[9], Rt[3];
  so3_exp(a + 3, Ra);
  so3_exp(b + 3, Rb);
  matvec3(Ra, b, Rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = a[i] + Rt[i];
  matmul3(Ra, Rb, RaRb);
  so3_log(RaRb, out + 3);
}

// se3_inverse: R_inv = so3_exp(rotvec)^T, [-(R_inv t), so3_log(R_inv)]
template <typename T>
__device__ void se3_inverse(const T a[6], T out[6]) {
  T R[9], Ri[9], t[3];
  so3_exp(a + 3, R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
  }
  matvec3(Ri, a, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = -t[i];
  so3_log(Ri, out + 3);
}

// inv3x3: the scale-normalized adjugate inverse of linalg.inv3x3, with the
// +eps I lift and the sign-preserving determinant floor
template <typename T>
__device__ void inv3x3(const T M_in[9], T eps, T out[9]) {
  T s = m_abs(M_in[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) s = nanmax(s, m_abs(M_in[k]));
  s = s > T(0) ? s : T(1);
  const double eps_rel_d = 32.0 * (sizeof(T) == 4 ? 1.1920928955078125e-07 : 2.220446049250313e-16);
  const double floor_d = eps_rel_d * eps_rel_d * eps_rel_d > 1e-30 ? eps_rel_d * eps_rel_d * eps_rel_d : 1e-30;
  const T lift = (T(1) / s) * eps + T(eps_rel_d);
  T M[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) M[k] = M_in[k] / s + lift * eye<T>(k);
  const T a = M[0], b = M[1], c = M[2];
  const T d = M[3], e = M[4], f = M[5];
  const T g = M[6], h = M[7], i = M[8];
  const T A = e * i - f * h;
  const T B = -(d * i - f * g);
  const T Cc = d * h - e * g;
  const T D = -(b * i - c * h);
  const T E = a * i - c * g;
  const T F = -(a * h - b * g);
  const T G = b * f - c * e;
  const T H = -(a * f - c * d);
  const T Ii = a * e - b * d;
  const T det = (a * A + b * B) + c * Cc;
  // torch.where(det >= 0, 1.0, -1.0) is float32, and so its product with the floor
  const T sgn_floor = T(det >= T(0) ? float(floor_d) : -float(floor_d));
  const T inv_det = T(1) / (m_abs(det) > T(floor_d) ? det : sgn_floor);
  const T q = inv_det / s;
  const T adjT[9] = {A, D, G, B, E, H, Cc, F, Ii};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = adjT[k] * q;
}

// each op's trailing sizes: input, second input (0: none), output
template <int kOp> struct Shape;
template <> struct Shape<kSo3Exp> { static constexpr int a = 3, b = 0, out = 9; };
template <> struct Shape<kSo3Log> { static constexpr int a = 9, b = 0, out = 3; };
template <> struct Shape<kSe3Exp> { static constexpr int a = 6, b = 0, out = 6; };
template <> struct Shape<kSe3Log> { static constexpr int a = 6, b = 0, out = 6; };
template <> struct Shape<kSe3Compose> { static constexpr int a = 6, b = 6, out = 6; };
template <> struct Shape<kSe3Inverse> { static constexpr int a = 6, b = 0, out = 6; };
template <> struct Shape<kSe3Relative> { static constexpr int a = 6, b = 6, out = 6; };
template <> struct Shape<kSkew> { static constexpr int a = 3, b = 0, out = 9; };
template <> struct Shape<kInv3x3> { static constexpr int a = 9, b = 0, out = 9; };

// an input element's n entries (3 x 3 for n = 9) through its strides
template <typename T, int n>
__device__ __forceinline__ void load(const T* base, const long long inner[2], T x[n]) {
  if constexpr (n == 9) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) x[3 * i + j] = base[i * inner[0] + j * inner[1]];
    }
  } else {
#pragma unroll
    for (int k = 0; k < n; ++k) x[k] = base[k * inner[0]];
  }
}

// One thread per element of the broadcast batch.
template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads) lie_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                       T* __restrict__ out, long long n, Layout L, double eps) {
  using S = Shape<kOp>;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  long long rest = idx, off_a = 0, off_b = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < L.ndim) {
      const long long q = rest / L.size[d];
      const long long k = rest - q * L.size[d];
      off_a += k * L.a_stride[d];
      off_b += k * L.b_stride[d];
      rest = q;
    }
  }
  T x[S::a], y[S::b > 0 ? S::b : 1], z[S::out];
  load<T, S::a>(a + off_a, L.a_inner, x);
  if constexpr (S::b > 0) load<T, S::b>(b + off_b, L.b_inner, y);
  if constexpr (kOp == kSo3Exp) so3_exp(x, z);
  else if constexpr (kOp == kSo3Log) so3_log(x, z);
  else if constexpr (kOp == kSe3Exp) se3_exp(x, z);
  else if constexpr (kOp == kSe3Log) se3_log(x, z);
  else if constexpr (kOp == kSe3Compose) se3_compose(x, y, z);
  else if constexpr (kOp == kSe3Inverse) se3_inverse(x, z);
  else if constexpr (kOp == kSe3Relative) {
    T inv_b[6];
    se3_inverse(y, inv_b);
    se3_compose(inv_b, x, z);
  }
  else if constexpr (kOp == kSkew) skew(x, z);
  else inv3x3(x, T(eps), z);
  T* o = out + idx * S::out;
#pragma unroll
  for (int k = 0; k < S::out; ++k) o[k] = z[k];
}

template <typename T, int kOp>
int launch_op(const void* a, const void* b, void* out, long long n, const Layout& L, double eps,
              cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  lie_kernel<T, kOp><<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)a, (const T*)b, (T*)out, n, L, eps);
  return (int)cudaGetLastError();
}

// meta: size[kMaxDims], a_stride[kMaxDims], b_stride[kMaxDims], a_inner[2], b_inner[2]
template <typename T>
int launch_lie(int op, const void* a, const void* b, void* out, long long n, const long long* meta, int ndim,
               double eps, void* stream) {
  if (ndim < 0 || ndim > kMaxDims || n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Layout L;
  for (int d = 0; d < kMaxDims; ++d) {
    L.size[d] = meta[d];
    L.a_stride[d] = meta[kMaxDims + d];
    L.b_stride[d] = meta[2 * kMaxDims + d];
  }
  for (int k = 0; k < 2; ++k) {
    L.a_inner[k] = meta[3 * kMaxDims + k];
    L.b_inner[k] = meta[3 * kMaxDims + 2 + k];
  }
  L.ndim = ndim;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kSo3Exp: return launch_op<T, kSo3Exp>(a, b, out, n, L, eps, st);
    case kSo3Log: return launch_op<T, kSo3Log>(a, b, out, n, L, eps, st);
    case kSe3Exp: return launch_op<T, kSe3Exp>(a, b, out, n, L, eps, st);
    case kSe3Log: return launch_op<T, kSe3Log>(a, b, out, n, L, eps, st);
    case kSe3Compose: return launch_op<T, kSe3Compose>(a, b, out, n, L, eps, st);
    case kSe3Inverse: return launch_op<T, kSe3Inverse>(a, b, out, n, L, eps, st);
    case kSe3Relative: return launch_op<T, kSe3Relative>(a, b, out, n, L, eps, st);
    case kSkew: return launch_op<T, kSkew>(a, b, out, n, L, eps, st);
    case kInv3x3: return launch_op<T, kInv3x3>(a, b, out, n, L, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gcslam_lie_f32(int op, const void* a, const void* b, void* out, long long n, const long long* meta,
                              int ndim, double eps, void* stream) {
  return launch_lie<float>(op, a, b, out, n, meta, ndim, eps, stream);
}

extern "C" int gcslam_lie_f64(int op, const void* a, const void* b, void* out, long long n, const long long* meta,
                              int ndim, double eps, void* stream) {
  return launch_lie<double>(op, a, b, out, n, meta, ndim, eps, stream);
}
