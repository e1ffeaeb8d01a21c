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
// per pixel, its rgb/depth/T accumulators in registers. The splats are
// taken in chunks of 256, in order, and for each chunk:
//   1. each thread tests its own splat against the tile: skipped when its
//      clip radius r = sqrt(-2 log_clip lambda_max) (+1 px for rounding)
//      puts every pixel of the tile outside the ellipse where q > log_clip,
//      i.e. where w = 0 exactly, or when alpha <= 0;
//   2. an ordered compaction (each hit's rank among its warp's hits by
//      __ballot_sync / __popc, plus the hit counts of the warps before it)
//      gives every hit its slot in shared memory, in splat order, and the
//      hitting thread stages the splat's parameters there;
//   3. every thread composites the chunk's hits in that order; a warp
//      skips the exp and the accumulation of a splat where none of its 32
//      pixels has q > log_clip (about half of the (warp, splat) pairs at
//      P = 4096).
// So a thread makes P / 256 tile tests in place of P, and the composite
// loop runs only over the splats that touch the tile. Skipping a w = 0
// splat leaves rgb, depth and T bit-for-bit as they were (colour and depth
// are finite), so the result does not depend on the tile size (the TPU
// kernel's 3-sigma box skips nonzero weights out to 4 sigma at
// log_clip = -8, and so does depend on it). Built with --fmad=false, each
// pixel performs the same IEEE operations in the same order as the plain
// PyTorch compositor, so the two agree to the last bit up to expf. One
// launch, no atomics: repeat renders are bit-equal. No global sort by tile
// key (as 3D Gaussian Splatting bins its splats): at P = 4096 and a few
// hundred tiles the per-block test of every splat is cheap, and a sort
// would add launches and a library sort. No early exit on low
// transmittance (the reference has none).
//
// What bounds it on this card: the bytes are P x 11 x 4 in and
// H x W x 5 x 4 out (1.7 MB at P = 4096, 320 x 240: ~0.5 us at 3.35 TB/s);
// the arithmetic is ~20 FLOPs and one expf per (pixel, splat) pair inside
// the clip radius, against 67 TFLOP/s f32. In practice it is bound by
// instruction throughput in the composite loop: the clip-radius box of a tile
// holds ~2.5x the pairs with w > 0 (45.8M against 18.1M at P = 4096,
// 320 x 240), each ~30-40 instructions, and 300 tiles over 132 SMs leave
// some SMs three tiles and others two.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // splats tested per pass, one per thread

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ u0, const float* __restrict__ v0,
              const float* __restrict__ inv2, const float* __restrict__ rgb,
              const float* __restrict__ alpha, const float* __restrict__ z,
              const float* __restrict__ radius, int P, int H, int W, float log_clip,
              float* __restrict__ rgb_out, float* __restrict__ depth_out,
              float* __restrict__ trans_out) {
  // the chunk's hits, compacted in splat order
  __shared__ float4 s_geo[kChunk];  // u0, v0, a, 2b
  __shared__ float4 s_col[kChunk];  // c, r, g, b
  __shared__ float2 s_az[kChunk];   // alpha, z
  __shared__ int s_count[kWarps];   // hits per warp

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  // pixel-coordinate box of this tile
  const float x0 = (float)(blockIdx.x * kTile), x1 = x0 + (float)(kTile - 1);
  const float y0 = (float)(blockIdx.y * kTile), y1 = y0 + (float)(kTile - 1);
  const float us = (float)x, vs = (float)y;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, T = 1.f;

  for (int base = 0; base < P; base += kChunk) {
    // 1. this thread's splat against the tile
    const int p = base + tid;
    bool hit = false;
    float su = 0.f, sv = 0.f, al = 0.f;
    if (p < P) {
      su = u0[p];
      sv = v0[p];
      al = alpha[p];
      const float r = radius[p];
      hit = !(!(al > 0.f) || su + r < x0 || su - r > x1 || sv + r < y0 || sv - r > y1);
    }
    // 2. ordered compaction: rank among the warp's hits + the warps before
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();  // counts written; the previous chunk's hits consumed
    int slot = __popc(ballot & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      slot += w < warp ? c : 0;
      n += c;
    }
    if (hit) {
      s_geo[slot] = make_float4(su, sv, inv2[3 * p], 2.f * inv2[3 * p + 1]);
      s_col[slot] = make_float4(inv2[3 * p + 2], rgb[3 * p], rgb[3 * p + 1], rgb[3 * p + 2]);
      s_az[slot] = make_float2(al, z[p]);
    }
    __syncthreads();  // hits staged; every count read
    // 3. composite the hits in splat order
    for (int i = 0; i < n; ++i) {
      const float4 g = s_geo[i];
      const float4 c = s_col[i];
      const float2 az = s_az[i];
      const float du = us - g.x;
      const float dv = vs - g.y;
      const float q = -0.5f * (g.z * du * du + g.w * du * dv + c.x * dv * dv);
      // a warp none of whose pixels has q > log_clip gets w = 0 from this
      // splat everywhere: nothing would change, so skip the rest
      if (!__any_sync(0xffffffffu, q > log_clip)) continue;
      const float w = (q > log_clip ? expf(q) : 0.f) * az.x;
      const float contrib = w * T;
      acc_r = acc_r + contrib * c.y;
      acc_g = acc_g + contrib * c.z;
      acc_b = acc_b + contrib * c.w;
      acc_d = acc_d + contrib * az.y;
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
