// Bilinear warp with scipy 'reflect' border, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_warp.py::warp_banded_pallas (the Pallas
// TPU kernel, pl.pallas_call at :172), which elastic_transform runs twice per
// image. For a batch img (B, H, W, C) f32 and sample coordinates
// cy, cx (B, H, W) f32:
//
//   y0 = floor(cy), x0 = floor(cx), fy = cy - y0, fx = cx - x0
//   top = img[r(y0),   r(x0)] * (1 - fx) + img[r(y0),   r(x0+1)] * fx
//   bot = img[r(y0+1), r(x0)] * (1 - fx) + img[r(y0+1), r(x0+1)] * fx
//   out = top * (1 - fy) + bot * fy
//
// with r the scipy 'reflect' index map of period 2n (d c b a | a b c d |
// d c b a), for any overhang. That is the gather form of
// robustart_tpu/ops/image.py::map_coordinates_bilinear_reflect (:615-638),
// in its order of operations.
//
// Design: the TPU kernel keeps the image in VMEM and walks a band of
// offsets with rolls and masked selects, because a gather is slow there and
// Mosaic wants aligned slices; its symmetric pad holds only for an overhang
// up to min(H, W) and it needs a static band. On Hopper a gather from L1/L2
// is cheap, so this kernel is direct: one thread per output pixel, the four
// corners of all C channels gathered, no band and no padding. It serves every
// severity, including those for which the TPU had no finite band.
//
// Bound: memory. Each pixel reads its two coordinates (8 bytes), writes C
// floats and gathers 4·C floats that neighbouring threads share through the
// caches, so the least traffic is the image once, the coordinates once and
// the output once.
//
// Every float step is a _rn intrinsic so that nvcc contracts no multiply and
// add into one FMA: the plain PyTorch version (robustart_torch/ops/warp.py)
// rounds after each step and must see the same numbers.
//
// Binding: a plain C entry point (warp_bilinear_launch) that the Python
// wrapper calls through ctypes; it launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect(int idx, int n) {
  const int period = 2 * n;
  int m = idx % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

// C > 0: the channel count at compile time (the loop unrolls); 0: c_dyn
template <int C>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ img, const float* __restrict__ cy,
                     const float* __restrict__ cx, float* __restrict__ out, int h, int w,
                     int c_dyn) {
  const int c = C > 0 ? C : c_dyn;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int64_t b = blockIdx.y;
  const int64_t p = b * hw + pix;

  const float y = cy[p], x = cx[p];
  const float y0 = floorf(y), x0 = floorf(x);
  const float fy = __fsub_rn(y, y0), fx = __fsub_rn(x, x0);
  const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
  const int y0i = static_cast<int>(y0), x0i = static_cast<int>(x0);
  const int r0 = reflect(y0i, h), r1 = reflect(y0i + 1, h);
  const int c0 = reflect(x0i, w), c1 = reflect(x0i + 1, w);

  const float* base = img + b * hw * c;
  const float* pa = base + (static_cast<int64_t>(r0) * w + c0) * c;
  const float* pb = base + (static_cast<int64_t>(r0) * w + c1) * c;
  const float* pc = base + (static_cast<int64_t>(r1) * w + c0) * c;
  const float* pd = base + (static_cast<int64_t>(r1) * w + c1) * c;
  float* dst = out + p * c;
#pragma unroll
  for (int ch = 0; ch < c; ++ch) {
    const float top = __fadd_rn(__fmul_rn(__ldg(pa + ch), gx), __fmul_rn(__ldg(pb + ch), fx));
    const float bot = __fadd_rn(__fmul_rn(__ldg(pc + ch), gx), __fmul_rn(__ldg(pd + ch), fx));
    dst[ch] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  }
}

}  // namespace

// img (B, H, W, C), cy/cx (B, H, W), out (B, H, W, C); all f32, contiguous.
// Returns the cudaError_t of the launch (0 on success). Argument checks
// (device, dtype, contiguity, shapes) are the Python wrapper's job.
extern "C" int warp_bilinear_launch(const void* img, const void* cy, const void* cx, void* out,
                                    long long batch, int h, int w, int c, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(img);
  const auto* y = static_cast<const float*>(cy);
  const auto* x = static_cast<const float*>(cx);
  auto* o = static_cast<float*>(out);
  switch (c) {
    case 1: warp_bilinear_kernel<1><<<grid, kThreads, 0, s>>>(i, y, x, o, h, w, c); break;
    case 3: warp_bilinear_kernel<3><<<grid, kThreads, 0, s>>>(i, y, x, o, h, w, c); break;
    default: warp_bilinear_kernel<0><<<grid, kThreads, 0, s>>>(i, y, x, o, h, w, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}
