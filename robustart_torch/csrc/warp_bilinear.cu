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
// Bound: memory. The least traffic is the image in once, the two coordinate
// maps in once and the image out once (205.5 MB at B = 128, 224^2, C = 3).
//
// Design. The TPU kernel keeps the whole image in VMEM and walks a band of
// offsets with rolls and masked selects, because Mosaic has no fast gather.
// On Hopper a gather that L1 and L2 serve is cheap, so this kernel is
// direct: no band and no padding, WARP_PIXELS (3) pixels a thread, 256
// apart, so that each coordinate load of a warp is 128 contiguous bytes.
// A thread loads its pixels' coordinates, then gathers the four corners of
// all C channels of every pixel and blends them, then stores: its pixels'
// gathers are in flight together, and at 32 registers 64 warps an SM hide
// the rest of their latency. On elastic_transform's smooth fields
// neighbouring lanes read neighbouring corners, which L1 serves. 'reflect'
// divides only for an index outside [-n, 2n), and offsets within an image
// are 32-bit where H · W · C allows. Measured (scripts/probe_torch_warp.py,
// PERF.md): 3 pixels a thread beat 1, 2, 4 and 8; a design that stages each
// output tile's source box in shared memory (scripts/probe_warp_tile.cu)
// is slower on elastic's coordinates, where its phases run one after
// another in each block.
//
// Every float step is a _rn intrinsic so that nvcc contracts no multiply and
// add into one FMA: the plain PyTorch version (robustart_torch/ops/warp.py)
// rounds after each step and sees the same numbers, bit for bit.
//
// Binding: a plain C entry point (warp_bilinear_launch) that the Python
// wrapper calls through ctypes; it launches on the caller's stream and
// returns cudaGetLastError() of the launch.
//
// Built with -DWARP_PROBE_FLOOR (scripts/probe_torch_warp.py builds such a
// copy apart; the port never does), the kernel only reads the coordinates
// and writes cy + cx to every channel through the same stores: the memory
// floor of the design. -DWARP_PIXELS=n sets the pixels a thread (the probe
// times other counts; ops/warp.py::warp_plan mirrors the default).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef WARP_PIXELS
#define WARP_PIXELS 3
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = WARP_PIXELS;
constexpr int kBlockPixels = kThreads * kPixels;

// scipy 'reflect' of period 2n; a run-time division only outside [-n, 2n)
__device__ __forceinline__ int reflect(int idx, int n) {
  if (static_cast<unsigned>(idx) < static_cast<unsigned>(n)) return idx;
  if (idx < 0 && idx >= -n) return -1 - idx;
  if (idx >= n && idx - n < n) return 2 * n - 1 - idx;
  const int period = 2 * n;
  int m = idx % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

// one output value from its four corners, in the plain version's order
__device__ __forceinline__ float blend(float a, float b, float c, float d, float fx, float gx,
                                       float fy, float gy) {
  const float top = __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx));
  const float bot = __fadd_rn(__fmul_rn(c, gx), __fmul_rn(d, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// C > 0: the channel count at compile time (the loop unrolls); 0: c_dyn.
// I: the type of an offset within one image (int where H · W · C fits).
template <int C, typename I>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ img, const float* __restrict__ cy,
                     const float* __restrict__ cx, float* __restrict__ out, int h, int w,
                     int c_dyn) {
  const int c = C > 0 ? C : c_dyn;
  const I hw = static_cast<I>(h) * w;
  const int64_t b = blockIdx.y;
  const float* ys = cy + b * hw;
  const float* xs = cx + b * hw;
  const float* base = img + b * hw * c;
  float* dst0 = out + b * hw * c;
  const I first = static_cast<I>(blockIdx.x) * kBlockPixels + static_cast<I>(threadIdx.x);

  float vy[kPixels], vx[kPixels];
  bool valid[kPixels];
#pragma unroll
  for (int i = 0; i < kPixels; ++i) {
    const I pix = first + i * kThreads;
    valid[i] = pix < hw;
    vy[i] = valid[i] ? __ldg(ys + pix) : 0.0f;
    vx[i] = valid[i] ? __ldg(xs + pix) : 0.0f;
  }
  // all pixels' corners are loaded and blended before the first store, so
  // that a thread keeps its pixels' loads in flight together (C known at
  // compile time; any other C stores as it goes)
  constexpr int kC = C > 0 ? C : 1;
  float res[kPixels][kC];
#pragma unroll
  for (int i = 0; i < kPixels; ++i) {
    if (!valid[i]) continue;
    float* dst = dst0 + (first + i * kThreads) * c;
#ifdef WARP_PROBE_FLOOR
    const float v = __fadd_rn(vy[i], vx[i]);
    if (C > 0) {
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) res[i][ch] = v;
    } else {
      for (int ch = 0; ch < c; ++ch) dst[ch] = v;
    }
#else
    const float y0 = floorf(vy[i]), x0 = floorf(vx[i]);
    const float fy = __fsub_rn(vy[i], y0), fx = __fsub_rn(vx[i], x0);
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    const int y0i = static_cast<int>(y0), x0i = static_cast<int>(x0);
    const I r0 = static_cast<I>(reflect(y0i, h)) * w;
    const I r1 = static_cast<I>(reflect(y0i + 1, h)) * w;
    const I c0 = reflect(x0i, w), c1 = reflect(x0i + 1, w);
    const float* pa = base + (r0 + c0) * c;
    const float* pb = base + (r0 + c1) * c;
    const float* pc = base + (r1 + c0) * c;
    const float* pd = base + (r1 + c1) * c;
    if (C > 0) {
#pragma unroll
      for (int ch = 0; ch < kC; ++ch)
        res[i][ch] = blend(__ldg(pa + ch), __ldg(pb + ch), __ldg(pc + ch), __ldg(pd + ch), fx, gx,
                           fy, gy);
    } else {
      for (int ch = 0; ch < c; ++ch)
        dst[ch] = blend(__ldg(pa + ch), __ldg(pb + ch), __ldg(pc + ch), __ldg(pd + ch), fx, gx,
                        fy, gy);
    }
#endif
  }
  if (C > 0) {
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      if (!valid[i]) continue;
      float* dst = dst0 + (first + i * kThreads) * C;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) dst[ch] = res[i][ch];
    }
  }
}

template <typename I>
void launch(const float* img, const float* cy, const float* cx, float* out, long long batch,
            int h, int w, int c, cudaStream_t s) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kBlockPixels - 1) / kBlockPixels),
                  static_cast<unsigned>(batch));
  switch (c) {
    case 1: warp_bilinear_kernel<1, I><<<grid, kThreads, 0, s>>>(img, cy, cx, out, h, w, c); break;
    case 3: warp_bilinear_kernel<3, I><<<grid, kThreads, 0, s>>>(img, cy, cx, out, h, w, c); break;
    default: warp_bilinear_kernel<0, I><<<grid, kThreads, 0, s>>>(img, cy, cx, out, h, w, c); break;
  }
}

}  // namespace

// img (B, H, W, C), cy/cx (B, H, W), out (B, H, W, C); all f32, contiguous.
// Returns the cudaError_t of the launch (0 on success). Argument checks
// (device, dtype, contiguity, shapes) are the Python wrapper's job;
// ops/warp.py::warp_plan mirrors the launch's grid.
extern "C" int warp_bilinear_launch(const void* img, const void* cy, const void* cx, void* out,
                                    long long batch, int h, int w, int c, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(img);
  const auto* y = static_cast<const float*>(cy);
  const auto* x = static_cast<const float*>(cx);
  auto* o = static_cast<float*>(out);
  // the last offset a thread forms is below (H · W + 256 · WARP_PIXELS) · C
  if ((static_cast<int64_t>(h) * w + kBlockPixels) * c <= INT_MAX)
    launch<int>(i, y, x, o, batch, h, w, c, s);
  else
    launch<int64_t>(i, y, x, o, batch, h, w, c, s);
  return static_cast<int>(cudaGetLastError());
}
