// Two designs of the motion taps (K3) without shared-memory boxes, for
// scripts/probe_torch_motion.py to time beside the port's kernel
// (robustart_torch/csrc/motion_taps.cu). The port does not use them.
//
// Both compute the port's sum (tap order from 0, a _rn multiply and a _rn
// add a tap and channel, edge clamps), so both are bitwise against the
// plain version:
//
// - motion_direct32_launch: a thread a pixel, as the parent kernel, with a
//   (32 x 8) block over a 2-D grid of (columns, rows, images), so no
//   division, and 32-bit offsets within an image;
// - motion_floats_launch: a thread a float of a row (pixel x channel), 128
//   of a row a block, so that a tap's warp load is 128 contiguous bytes
//   wherever the clamp does not bite.
//
// Both take the parent's entry arguments and refuse a batch above 65535
// (the grid's z) and images past 32-bit offsets.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ void load_taps(const int* dy, const int* dx, const float* wt, int taps,
                                          int b, int tid, int threads, int* s_dy, int* s_dx,
                                          float* s_wt) {
  for (int t = tid; t < taps; t += threads) {
    s_dy[t] = dy[b * taps + t];
    s_dx[t] = dx[b * taps + t];
    s_wt[t] = wt[b * taps + t];
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(256)
direct32_kernel(const float* __restrict__ img, const int* __restrict__ dy,
                const int* __restrict__ dx, const float* __restrict__ wt, float* __restrict__ out,
                int h, int w, int taps) {
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps];
  __shared__ float s_wt[kMaxTaps];
  const int b = blockIdx.z;
  load_taps(dy, dx, wt, taps, b, threadIdx.y * 32 + threadIdx.x, 256, s_dy, s_dx, s_wt);
  const int i = blockIdx.y * 8 + threadIdx.y, j = blockIdx.x * 32 + threadIdx.x;
  if (i >= h || j >= w) return;
  const float* base = img + static_cast<int64_t>(b) * h * w * C;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int yy = clampi(i + s_dy[t], 0, h - 1), xx = clampi(j + s_dx[t], 0, w - 1);
    const float wv = s_wt[t];
    const float* src = base + (yy * w + xx) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wv, __ldg(src + ch)));
  }
  float* dst = out + static_cast<int64_t>(b) * h * w * C + (i * w + j) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = acc[ch];
}

template <int C>
__global__ void __launch_bounds__(128)
floats_kernel(const float* __restrict__ img, const int* __restrict__ dy,
              const int* __restrict__ dx, const float* __restrict__ wt, float* __restrict__ out,
              int h, int w, int taps) {
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps];
  __shared__ float s_wt[kMaxTaps];
  const int b = blockIdx.z;
  load_taps(dy, dx, wt, taps, b, threadIdx.x, 128, s_dy, s_dx, s_wt);
  const int f = blockIdx.x * 128 + threadIdx.x, i = blockIdx.y;
  if (f >= w * C) return;
  const int j = f / C, ch = f - j * C;
  const float* base = img + static_cast<int64_t>(b) * h * w * C + ch;
  float acc = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int yy = clampi(i + s_dy[t], 0, h - 1), xx = clampi(j + s_dx[t], 0, w - 1);
    acc = __fadd_rn(acc, __fmul_rn(s_wt[t], __ldg(base + (yy * w + xx) * C)));
  }
  out[static_cast<int64_t>(b) * h * w * C + i * w * C + f] = acc;
}

bool refused(long long batch, int h, int w, int c, int taps) {
  return batch > 65535 || h > 65535 || taps < 0 || taps > kMaxTaps || (c != 1 && c != 3) ||
         static_cast<int64_t>(h) * w * c > INT_MAX;
}

}  // namespace

extern "C" int motion_direct32_launch(const void* img, const void* dy, const void* dx,
                                      const void* wt, void* out, long long batch, int h, int w,
                                      int c, int taps, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (refused(batch, h, w, c, taps)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, static_cast<unsigned>(batch)), block(32, 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto *i = static_cast<const float*>(img), *t = static_cast<const float*>(wt);
  const auto *y = static_cast<const int*>(dy), *x = static_cast<const int*>(dx);
  auto* o = static_cast<float*>(out);
  if (c == 1) direct32_kernel<1><<<grid, block, 0, s>>>(i, y, x, t, o, h, w, taps);
  else direct32_kernel<3><<<grid, block, 0, s>>>(i, y, x, t, o, h, w, taps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int motion_floats_launch(const void* img, const void* dy, const void* dx,
                                    const void* wt, void* out, long long batch, int h, int w,
                                    int c, int taps, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (refused(batch, h, w, c, taps)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w * c + 127) / 128, h, static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto *i = static_cast<const float*>(img), *t = static_cast<const float*>(wt);
  const auto *y = static_cast<const int*>(dy), *x = static_cast<const int*>(dx);
  auto* o = static_cast<float*>(out);
  if (c == 1) floats_kernel<1><<<grid, 128, 0, s>>>(i, y, x, t, o, h, w, taps);
  else floats_kernel<3><<<grid, 128, 0, s>>>(i, y, x, t, o, h, w, taps);
  return static_cast<int>(cudaGetLastError());
}
