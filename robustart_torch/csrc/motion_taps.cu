// Motion blur as a per-image list of weighted, edge-clamped taps, for
// Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_motion.py::motion_taps_pallas (the
// Pallas TPU kernel, pl.pallas_call at :114), which motion_blur (C = 3) and
// snow's layer (C = 1) run once per image. For a batch img (B, H, W, C) f32
// and per-image tap rows dy, dx (B, T) int32 and wt (B, T) f32:
//
//   out[b, i, j, :] = sum_t wt[b, t] * img[b, clamp(i + dy[b, t]), clamp(j + dx[b, t]), :]
//
// summed in tap order from 0 with f32 accumulation; clamp is to [0, H-1]
// and [0, W-1] (edge replicate). The rows come from the (angles, T) table of
// robustart_tpu/ops/pallas_motion.py::_angle_tap_table, picked on the device
// by each image's angle index; rows are zero-padded to a common T, and a
// zero-weight tap adds an exact 0.
//
// Design: the TPU kernel brings the angle's taps in as scalars and rolls an
// aligned VMEM window for each; here one thread computes one output pixel
// for all C channels, the block's tap row sits in shared memory (one block
// serves one image), and each tap is a gather that neighbouring threads
// share through L1. T <= 21 at every severity of the two corruptions.
//
// Bound: memory. Each pixel's least traffic is its C floats read once and
// written once; the 2·T flops per channel stay far under the card's rate.
//
// Every float step is a _rn intrinsic so that nvcc contracts no multiply and
// add into one FMA: the plain PyTorch version (robustart_torch/ops/motion.py)
// rounds after each step and must see the same numbers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

template <int C>
__global__ void __launch_bounds__(kThreads)
motion_taps_kernel(const float* __restrict__ img, const int* __restrict__ dy,
                   const int* __restrict__ dx, const float* __restrict__ wt,
                   float* __restrict__ out, int h, int w, int taps) {
  __shared__ int s_dy[kMaxTaps];
  __shared__ int s_dx[kMaxTaps];
  __shared__ float s_wt[kMaxTaps];
  const int64_t b = blockIdx.y;
  for (int t = threadIdx.x; t < taps; t += kThreads) {
    s_dy[t] = dy[b * taps + t];
    s_dx[t] = dx[b * taps + t];
    s_wt[t] = wt[b * taps + t];
  }
  __syncthreads();

  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int i = static_cast<int>(pix / w), j = static_cast<int>(pix % w);
  const float* base = img + b * hw * C;

  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int yy = min(max(i + s_dy[t], 0), h - 1);
    const int xx = min(max(j + s_dx[t], 0), w - 1);
    const float wv = s_wt[t];
    const float* src = base + (static_cast<int64_t>(yy) * w + xx) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wv, __ldg(src + ch)));
  }
  float* dst = out + (b * hw + pix) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = acc[ch];
}

}  // namespace

// img/out (B, H, W, C) f32 with C in {1, 3}; dy, dx (B, T) int32; wt (B, T)
// f32; all contiguous, T <= 64. Returns the cudaError_t of the launch (0 on
// success). Argument checks are the Python wrapper's job.
extern "C" int motion_taps_launch(const void* img, const void* dy, const void* dx,
                                  const void* wt, void* out, long long batch, int h, int w,
                                  int c, int taps, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || taps < 0 || taps > kMaxTaps || (c != 1 && c != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(img);
  const auto* y = static_cast<const int*>(dy);
  const auto* x = static_cast<const int*>(dx);
  const auto* t = static_cast<const float*>(wt);
  auto* o = static_cast<float*>(out);
  if (c == 1) {
    motion_taps_kernel<1><<<grid, kThreads, 0, s>>>(i, y, x, t, o, h, w, taps);
  } else {
    motion_taps_kernel<3><<<grid, kThreads, 0, s>>>(i, y, x, t, o, h, w, taps);
  }
  return static_cast<int>(cudaGetLastError());
}
