// ConvNeXt's depthwise 7×7 convolution + bias + LayerNorm, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_convnext.py::dwconv_ln_pallas (K11, the
// Pallas TPU kernel, pl.pallas_call at :84; kernel body :57-75). For x
// (N, H, W, C) NHWC in the working type T (bf16 or f32), per pixel:
//
//   y   = sum over the 49 taps of x[i + di - 3, j + dj - 3, c] · w[di, dj, c]
//         (f32, zero padding of 3, no padded copy) + b[c]
//   mu  = mean_c(y);  var = mean_c((y - mu)²)          two passes, as :71-72
//   out = T((y - mu) · rsqrt(var + eps) · gamma + beta)
//
// with f32 weights, bias, gamma and beta (the Pallas kernel casts its
// parameters to f32 and accumulates in f32; the JAX package's XLA reference
// instead rounds the convolution's output to x's type, pallas_convnext.py:
// 43-49, which this kernel does not follow).
//
// Design. The TPU kernel holds one padded image (up to 62 × 62 × 128) in
// VMEM and shifts it 49 times. Here a block takes one output row of one
// image with all C channels, one thread a channel (C ≤ 1024, a multiple of
// 32), so that the block holds whole pixels for the LayerNorm. A thread walks
// the row in segments of 8 pixels: for each of the 7 input rows it loads the
// 14 values the segment's taps need into registers and does 56 FMAs; the 49
// weights of its channel come from the L1 cache, the same for every block.
// The statistics of the 8 pixels are block reductions over the channels
// (warp shuffles, then one partial a warp through shared memory). A warp's
// loads are 32 neighbouring channels of one pixel: 64 bytes in bf16, 128 in
// f32. The accumulation order is di-outer (the Pallas kernel's is dj-outer):
// the two differ by f32 rounding only.
//
// Bound: at ConvNeXt-B's first stage (128 × 56 × 56 × 128) the convolution
// is 2.5 G multiply-adds (5.0 GFLOP) for 205 MB in bf16: about 25 FLOP a
// byte, above the 20 the H100's CUDA cores do per byte of device memory
// (67 TFLOP/s f32 over 3.35 TB/s), so the f32 FMAs bound it, narrowly.
//
// Binding: a plain C entry point (dwconv_ln_launch) called through ctypes;
// it launches on the caller's stream and returns the cudaError_t of the
// launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int J = 8;  // output pixels a thread holds at once
constexpr int kMaxC = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

struct Args {
  const void* x;      // (N, H, W, C) T
  const float* w;     // (49, C): tap di·7 + dj, then channel
  const float* b;     // (C,)
  const float* gamma; // (C,)
  const float* beta;  // (C,)
  void* out;          // (N, H, W, C) T
  int h, w_, c;
  float eps;
};

// sums over the block's channels of v[0..J-1], one per pixel, into total
// (red: scratch of one partial per warp and pixel)
__device__ __forceinline__ void block_sums(float (&v)[J], float (*red)[J], float* total,
                                           int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    float s = v[jj];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][jj] = s;
  }
  __syncthreads();
  if (threadIdx.x < J) {
    float s = 0.0f;
    for (int wi = 0; wi < c / 32; ++wi) s += red[wi][threadIdx.x];
    total[threadIdx.x] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxC) dwconv_ln_kernel(Args a) {
  __shared__ float red[kMaxC / 32][J];
  __shared__ float s_sum[J];
  const int c = threadIdx.x, C = a.c, H = a.h, W = a.w_;
  const int64_t img = blockIdx.x / H;
  const int i = blockIdx.x % H;
  const T* x = static_cast<const T*>(a.x) + img * H * W * C + c;
  T* out = static_cast<T*>(a.out) + (img * H + i) * W * C + c;
  const float bias = a.b[c], g = a.gamma[c], bt = a.beta[c];
  const float inv_c = 1.0f / static_cast<float>(C);

  for (int j0 = 0; j0 < W; j0 += J) {
    float acc[J];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[jj] = 0.0f;
    for (int di = 0; di < 7; ++di) {
      const int r = i + di - 3;
      if (r < 0 || r >= H) continue;  // zero rows add nothing
      float win[J + 6];
#pragma unroll
      for (int u = 0; u < J + 6; ++u) {
        const int col = j0 + u - 3;
        win[u] = col >= 0 && col < W ? to_f(x[(static_cast<int64_t>(r) * W + col) * C]) : 0.0f;
      }
#pragma unroll
      for (int dj = 0; dj < 7; ++dj) {
        const float wt = a.w[(di * 7 + dj) * C + c];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) acc[jj] = fmaf(win[jj + dj], wt, acc[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[jj] = __fadd_rn(acc[jj], bias);

    // two-pass statistics over the channels of each of the J pixels
    block_sums(acc, red, s_sum, C);
    float d[J];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) d[jj] = __fsub_rn(acc[jj], s_sum[jj] * inv_c);
    float sq[J];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) sq[jj] = __fmul_rn(d[jj], d[jj]);
    block_sums(sq, red, s_sum, C);  // rewrites s_sum after a barrier every thread reaches
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      if (j0 + jj >= W) break;
      const float rstd = rsqrtf(__fadd_rn(s_sum[jj] * inv_c, a.eps));
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(d[jj], rstd), g), bt);
      out[static_cast<int64_t>(j0 + jj) * C] = from_f<T>(y);
    }
  }
}

}  // namespace

// x, out (n, h, w, c) contiguous of one type (dtype 0 = f32, 1 = bf16);
// weights (49, c) f32, tap di·7 + dj first; bias, gamma, beta (c,) f32;
// c a multiple of 32, at most 1024. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int dwconv_ln_launch(const void* x, const void* w, const void* b, const void* gamma,
                                const void* beta, void* out, int n, int h, int w_, int c,
                                float eps, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w_ <= 0) return 0;
  if (c <= 0 || c % 32 || c > kMaxC || static_cast<long long>(n) * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, static_cast<const float*>(w), static_cast<const float*>(b),
               static_cast<const float*>(gamma), static_cast<const float*>(beta), out,
               h, w_, c, eps};
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n * h);
  if (dtype == 1) {
    dwconv_ln_kernel<bf16><<<grid, c, 0, s>>>(a);
  } else if (dtype == 0) {
    dwconv_ln_kernel<float><<<grid, c, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
