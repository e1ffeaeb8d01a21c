// The stage clock of the captured step (utils/profiling.StageClock) for
// NVIDIA Hopper (sm_90a).
//
// A graph replay's kernels carry no host range, so the step's stages are
// timed on the device: each stage mark of scan_step records one launch of
// stage_stamp_kernel into the graph, between the stage's kernels and the
// previous stage's. One thread reads the device's nanosecond clock
// (%globaltimer, shared by every SM) and adds the time since the last stamp
// to the totals, which stay on the device until the host reads them:
//
//   clock[0 .. n_stages)   nanoseconds in each stage, summed over the steps;
//   clock[n_stages]        the steps that reached their end mark;
//   clock[n_stages + 1]    nanoseconds from one step's end mark to the next
//                          step's first mark within one runner call;
//   clock[n_stages + 2]    the last stamp;
//   clock[n_stages + 3]    1 until the first mark of a runner call (the
//                          host sets it once a call), so the time between
//                          calls is not counted;
//   clock[n_stages + 4]    the open stage (the last mark).
//
// Mark 0 starts a step (stage 0), mark k in [1, n_stages) ends the open
// stage and starts stage k (a stage whose code a configuration skips is
// left out, and reads 0), and mark n_stages ends the step. Stream order
// puts each stamp after every kernel launched before it, and the next
// kernel after it. The host mirror of this arithmetic, for the CPU, is
// utils/profiling._accumulate.

#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(long long* clock, int mark, int n_stages) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  long long* scans = clock + n_stages;
  long long* between = scans + 1;
  long long* last = scans + 2;
  long long* first = scans + 3;
  long long* open = scans + 4;
  if (mark == 0) {
    if (*first == 0) *between += t - *last;
    *first = 0;
  } else {
    clock[*open] += t - *last;
  }
  if (mark == n_stages) *scans += 1;
  *open = mark;
  *last = t;
}

}  // namespace

extern "C" int gcslam_stage_stamp(void* clock, int mark, int n_stages, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<long long*>(clock), mark, n_stages);
  return (int)cudaGetLastError();
}
