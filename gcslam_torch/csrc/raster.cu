// Tiled front-to-back Gaussian-splat compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel in the JAX package's
// outputs/rendering_pallas.py:128 (render_splats_pallas / _raster_kernel).
// Input: P splats already projected and sorted front to back
// (outputs/rendering.prepare_screen_splats): centre (u0, v0), inverse 2-D
// covariance (a, b, c), colour, opacity alpha, depth z and clip radius.
// For every pixel (x, y), with du = x - u0 and dv = y - v0, in splat order:
//
//     q = -0.5 (a du du + 2b du dv + c dv dv)
//     w = (q > log_clip ? exp(q) : 0) * alpha
//     rgb += w T col;   depth += w T z;   T *= 1 - w        (T starts at 1)
//
// and it writes rgb (H, W, 3), depth (H, W) and T (H, W); the caller clips
// rgb and divides depth by the coverage max(1 - T, 1e-6).
//
// Design: one block of 16 x 16 threads per 16 x 16 pixel tile, one thread
// per pixel, its rgb/depth/T accumulators in registers. The splats pass
// through shared memory in chunks of 256 (one load per thread), in order.
// Each splat is tested once against the tile: it is skipped when its clip
// radius r = sqrt(-2 log_clip lambda_max) (+1 px for rounding) puts every
// pixel of the tile outside the ellipse where q > log_clip, i.e. where
// w = 0 exactly. The test reads the same shared values in every thread, so
// the branch is uniform across the block. Skipping a w = 0 splat leaves
// rgb, depth and T bit-for-bit as they were, so the result does not depend
// on the tile size (the TPU kernel's 3-sigma box skips nonzero weights out
// to 4 sigma at log_clip = -8, and so does depend on it). Built with
// --fmad=false, each pixel performs the same IEEE operations in the same
// order as the plain PyTorch compositor, so the two agree to the last bit
// up to expf. No atomics: repeat renders are bit-equal. No early exit on
// low transmittance (the reference has none).
//
// What bounds it on this card: the bytes are P x 11 x 4 in and
// H x W x 5 x 4 out (1.7 MB at P = 4096, 320 x 240: ~0.5 us at 3.35 TB/s);
// the arithmetic is ~20 FLOPs and one expf per (pixel, splat) pair inside
// the clip radius, against 67 TFLOP/s f32. In practice neither: every
// block walks the whole sorted list (P tile tests per block) and the
// per-pixel loop is a chain of dependent multiply-adds on T, so it is
// bound by that latency and by the P x tiles test work; binning splats to
// tiles first (a sort by tile key) is the way past it, left to later work.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = kThreads;  // splats staged per pass, one per thread

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ u0, const float* __restrict__ v0,
              const float* __restrict__ inv2, const float* __restrict__ rgb,
              const float* __restrict__ alpha, const float* __restrict__ z,
              const float* __restrict__ radius, int P, int H, int W, float log_clip,
              float* __restrict__ rgb_out, float* __restrict__ depth_out,
              float* __restrict__ trans_out) {
  __shared__ float s_u[kChunk], s_v[kChunk], s_a[kChunk], s_b2[kChunk], s_c[kChunk];
  __shared__ float s_r[kChunk], s_g[kChunk], s_bl[kChunk], s_alpha[kChunk], s_z[kChunk];
  __shared__ float s_rad[kChunk];

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  // pixel-coordinate box of this tile
  const float x0 = (float)(blockIdx.x * kTile), x1 = x0 + (float)(kTile - 1);
  const float y0 = (float)(blockIdx.y * kTile), y1 = y0 + (float)(kTile - 1);
  const float us = (float)x, vs = (float)y;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, T = 1.f;

  for (int base = 0; base < P; base += kChunk) {
    const int n = min(kChunk, P - base);
    __syncthreads();  // the previous chunk is consumed
    if (tid < n) {
      const int p = base + tid;
      s_u[tid] = u0[p];
      s_v[tid] = v0[p];
      s_a[tid] = inv2[3 * p];
      s_b2[tid] = 2.f * inv2[3 * p + 1];
      s_c[tid] = inv2[3 * p + 2];
      s_r[tid] = rgb[3 * p];
      s_g[tid] = rgb[3 * p + 1];
      s_bl[tid] = rgb[3 * p + 2];
      s_alpha[tid] = alpha[p];
      s_z[tid] = z[p];
      s_rad[tid] = radius[p];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float su = s_u[i], sv = s_v[i], r = s_rad[i], al = s_alpha[i];
      // tile test: uniform across the block
      if (!(al > 0.f) || su + r < x0 || su - r > x1 || sv + r < y0 || sv - r > y1) continue;
      const float du = us - su;
      const float dv = vs - sv;
      const float q = -0.5f * (s_a[i] * du * du + s_b2[i] * du * dv + s_c[i] * dv * dv);
      const float w = (q > log_clip ? expf(q) : 0.f) * al;
      const float contrib = w * T;
      acc_r = acc_r + contrib * s_r[i];
      acc_g = acc_g + contrib * s_g[i];
      acc_b = acc_b + contrib * s_bl[i];
      acc_d = acc_d + contrib * s_z[i];
      T = T * (1.f - w);
    }
  }
  if (x < W && y < H) {
    const size_t pix = (size_t)y * W + x;
    rgb_out[3 * pix] = acc_r;
    rgb_out[3 * pix + 1] = acc_g;
    rgb_out[3 * pix + 2] = acc_b;
    depth_out[pix] = acc_d;
    trans_out[pix] = T;
  }
}

}  // namespace

extern "C" int gcslam_raster_f32(const void* u0, const void* v0, const void* inv2, const void* rgb,
                                 const void* alpha, const void* z, const void* radius, int P, int H,
                                 int W, float log_clip, void* rgb_out, void* depth_out,
                                 void* trans_out, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const dim3 block(kTile, kTile);
  raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u0), static_cast<const float*>(v0), static_cast<const float*>(inv2),
      static_cast<const float*>(rgb), static_cast<const float*>(alpha), static_cast<const float*>(z),
      static_cast<const float*>(radius), P, H, W, log_clip, static_cast<float*>(rgb_out),
      static_cast<float*>(depth_out), static_cast<float*>(trans_out));
  return static_cast<int>(cudaGetLastError());
}
