// Capped chamfer distance propagation, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_motion.py::chamfer_pallas (the Pallas
// TPU kernel, pl.pallas_call at :278), the distance transform of spatter's
// water mask (robustart_tpu/noise/corruptions/jax_kernels.py::
// _chamfer_distance :458). For maps dist0 (B, H, W) f32, `iters` Jacobi
// rounds of
//
//   d'[i, j] = min(cap, d[i, j], min_k (d[i + dy_k, j + dx_k] + w_k))
//
// over the 16 offsets of the 5x5 chamfer mask (weights 1, sqrt 2, sqrt 5),
// where a neighbour outside the image contributes `cap`. Each round reads
// the previous round's map whole. min is exact, and each add sees the same
// f32 operands as the plain version, so the result is bitwise the same.
//
// Design: one launch per round, one thread per pixel, ping-ponging between
// the output and a scratch map so that the last round writes the output.
// The TPU kernel holds one whole map in VMEM for all rounds; a block here
// has no room for that, and a halo of 2·iters rows and columns would redo
// much of the work near each tile's edge. The weights come from the host as
// the float32 values of 1, sqrt(2) and sqrt(5).
//
// Bound: instruction issue: 16 (add, min) pairs per pixel per round against
// 8 bytes per pixel per round, which L2 mostly serves at B = 128, 224^2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chamfer_round_kernel(const float* __restrict__ src, float* __restrict__ dst, int h, int w,
                     float cap, float w0, float w1, float w2) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int i = static_cast<int>(pix / w), j = static_cast<int>(pix % w);
  const float* map = src + static_cast<int64_t>(blockIdx.y) * hw;
  // the offsets in the order of jax_kernels._CHAMFER_OFFSETS: 4 at weight
  // w0, 4 at w1, 8 at w2; the loop unrolls, so every index is a constant
  const int dys[16] = {0, 0, 1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 2, 2, -2, -2};
  const int dxs[16] = {1, -1, 0, 0, 1, -1, 1, -1, 2, -2, 2, -2, 1, -1, 1, -1};
  float best = map[pix];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int y = i + dys[k], x = j + dxs[k];
    const float wk = k < 4 ? w0 : (k < 8 ? w1 : w2);
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const float cand =
        inside ? __fadd_rn(__ldg(map + static_cast<int64_t>(y) * w + x), wk) : cap;
    best = fminf(best, cand);
  }
  dst[static_cast<int64_t>(blockIdx.y) * hw + pix] = fminf(best, cap);
}

}  // namespace

// dist0, out, scratch (B, H, W) f32, contiguous and distinct; iters >= 1.
// Launches `iters` rounds; the last writes `out`. Returns the first
// cudaError_t of a launch (0 on success).
extern "C" int chamfer_launch(const void* dist0, void* out, void* scratch, long long batch,
                              int h, int w, float cap, float w0, float w1, float w2, int iters,
                              void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(dist0);
  for (int r = 0; r < iters; ++r) {
    // the round that writes `out` is the last: rounds alternate backwards
    float* dst = static_cast<float*>((iters - 1 - r) % 2 == 0 ? out : scratch);
    chamfer_round_kernel<<<grid, kThreads, 0, s>>>(src, dst, h, w, cap, w0, w1, w2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
