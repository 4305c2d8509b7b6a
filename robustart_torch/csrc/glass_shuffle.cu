// One glass_blur shuffle pass, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_motion.py::glass_shuffle_pallas (the
// Pallas TPU kernel, pl.pallas_call at :219). For a batch x (B, H, W, C) f32
// and per-pixel codes code (B, H, W) uint8, with code = (a+d)·2d + (b+d) and
// a, b in [-d, d):
//
//   out[n, i, j, :] = x[n, i + a, j + b, :]   where d < i < H-d and d < j < W-d
//   out[n, i, j, :] = x[n, i, j, :]           elsewhere
//
// (the interior is strict, as in robustart_tpu/noise/corruptions/
// jax_kernels.py::glass_blur :253-255). glass_blur runs 1-3 passes; pass k
// reads what pass k-1 wrote, so each pass is one launch.
//
// Design: the TPU kernel selects among (2d)^2 rolled copies of a VMEM
// window with one mask each; here one thread per output pixel decodes its
// code and copies one neighbour's C floats. The code is one byte (d <= 4, so
// code < 64), a quarter of the int32 code's bytes. A source row or column is
// clamped into the image, which changes nothing for a valid code and keeps a
// bad one from reading outside the batch.
//
// Bound: memory: the image read once, the code read once, the output
// written once. The copy is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
glass_shuffle_kernel(const float* __restrict__ x, const uint8_t* __restrict__ code,
                     float* __restrict__ out, int h, int w, int d, int c_dyn) {
  const int c = C > 0 ? C : c_dyn;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int64_t b = blockIdx.y;
  const int i = static_cast<int>(pix / w), j = static_cast<int>(pix % w);
  int si = i, sj = j;
  if (i > d && i < h - d && j > d && j < w - d) {
    const int k = code[b * hw + pix];
    si = min(max(i + k / (2 * d) - d, 0), h - 1);
    sj = min(max(j + k % (2 * d) - d, 0), w - 1);
  }
  const float* src = x + (b * hw + static_cast<int64_t>(si) * w + sj) * c;
  float* dst = out + (b * hw + pix) * c;
#pragma unroll
  for (int ch = 0; ch < c; ++ch) dst[ch] = __ldg(src + ch);
}

}  // namespace

// x/out (B, H, W, C) f32, code (B, H, W) uint8, all contiguous; d >= 1.
// Returns the cudaError_t of the launch (0 on success). Argument checks are
// the Python wrapper's job.
extern "C" int glass_shuffle_launch(const void* x, const void* code, void* out,
                                    long long batch, int h, int w, int c, int d,
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || c <= 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const float*>(x);
  const auto* k = static_cast<const uint8_t*>(code);
  auto* o = static_cast<float*>(out);
  if (c == 3) {
    glass_shuffle_kernel<3><<<grid, kThreads, 0, s>>>(xi, k, o, h, w, d, c);
  } else {
    glass_shuffle_kernel<0><<<grid, kThreads, 0, s>>>(xi, k, o, h, w, d, c);
  }
  return static_cast<int>(cudaGetLastError());
}
