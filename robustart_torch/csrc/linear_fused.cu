// Fused linear layer y = epilogue(prologue(x) · Wᵀ), for Hopper (sm_90a).
//
// The product of the transformer block kernels K6 and K7:
//
// - robustart_tpu/ops/pallas_attention.py::window_block_pallas (K6, the
//   Pallas TPU kernel, pl.pallas_call at :628) runs as (a) this kernel with
//   the LayerNorm prologue and the packed q/k/v weights, (b) the attention
//   core (attention_core.cu), (c) this kernel with the proj weights and the
//   residual epilogue;
// - robustart_tpu/ops/pallas_mlp.py::mlp_pallas (K7, pl.pallas_call at :200)
//   runs as (a) fc1 with the LayerNorm prologue (ViT, Swin) or none
//   (ConvNeXt) and the GELU epilogue, (b) fc2 with the bias, ConvNeXt's
//   layer-scale gamma and the residual (the raw pre-norm x, or ConvNeXt's
//   separate shortcut).
//
// For x (M, K) and W (N, K) in nn.Linear's (out, in) layout, both in the
// working type T (bf16 or f32):
//
//   a   = ln ? T((x - mu) * rsqrt(var + eps) * ln_w + ln_b) : x    per row
//         mu = E[x], var = E[x²] - mu², f32 statistics over all K
//   acc = a · Wᵀ                                     f32 accumulators
//   y   = acc + bias;  y = gelu ? gelu_erf(y) : y;             (f32)
//   y   = gamma ? y * gamma : y;  y = residual ? y + residual : y
//   out = T(y)                                       one cast
//
// which is the order of pallas_attention.py::_ln_f32 (:304-309) and of the
// epilogues of :415-421 and pallas_mlp.py:112-140 ((acc + b2)·gamma +
// shortcut, :80-86). GELU is the exact erf
// form (erff). The TPU kernel computes erf with the polynomial of
// Abramowitz & Stegun 7.1.26 (pallas_mlp.py:32-41, |error| ≤ 1.5e-7)
// because Mosaic lowers no erf; its XLA reference uses the exact erf, and so
// does this kernel.
//
// Design. The TPU kernels keep a whole 197×768 image and all the block's
// weights (about 16 MB) in VMEM and chain the products there; an SM has
// 227 KB of shared memory, so this first version is one tiled product per
// step and the intermediates (q/k/v, the attention output, K7's hidden
// 25,216 × 3072 bf16 = 155 MB at B = 128) go through device memory. Keeping
// them on-chip is later work.
//
// - bf16: tensor cores through nvcuda::wmma (16×16×16, f32 accumulators).
//   A 128×128 output tile per block of 8 warps, each warp 64×32; K steps of
//   32 staged through registers (the next tile's loads are in flight while
//   the current one multiplies).
// - f32: CUDA-core FMA, never TF32: a 128×128 tile per block of 256 threads,
//   8×8 outputs a thread, K steps of 8.
// - LayerNorm prologue: each block first takes the f32 statistics of its
//   128 rows over the whole K, then normalizes every A tile as it stages it
//   into shared memory and casts it to T, as the JAX code does before its
//   product. Every LN step is a _rn intrinsic (no contraction into an FMA),
//   so the bf16 cast sees the plain version's numbers.
// - Ragged M and N: rows and columns past the edge load as zero and never
//   store. K must be a multiple of 32 (768, 3072, 192 here).
//
// Bound: operations. At B = 128, ViT-B's q/k/v product is 89 GFLOP for
// 39 MB of input and output: far above the H100's 295 FLOP a byte in bf16.
//
// Binding: a plain C entry point (linear_fused_launch) called through
// ctypes; it launches on the caller's stream and returns the cudaError_t of
// the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128;

struct Params {
  const void* x;         // (M, K) T
  const void* w;         // (N, K) T
  const float* bias;     // (N,)
  const void* residual;  // (M, N) T or null
  const float* gamma;    // (N,) or null: no layer-scale
  const float* ln_w;     // (K,) or null: no prologue
  const float* ln_b;     // (K,)
  float eps;
  void* out;             // (M, N) T
  int64_t m;
  int n, k, gelu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752440f));
}

// f32 mean and 1/sqrt(var + eps) of rows row0 .. row0 + BM - 1 over all K
template <typename T>
__device__ void row_stats(const Params& p, int64_t row0, float* s_mu, float* s_rstd) {
  const T* x = static_cast<const T*>(p.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int64_t gr = row0 + r;
    float sum = 0.0f, sq = 0.0f;
    if (gr < p.m) {
      const T* row = x + gr * p.k;
      for (int c = lane; c < p.k; c += 32) {
        const float v = to_f(row[c]);
        sum += v;
        sq = fmaf(v, v, sq);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      const float mu = sum / static_cast<float>(p.k);
      const float var = __fsub_rn(sq / static_cast<float>(p.k), __fmul_rn(mu, mu));
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(__fadd_rn(var, p.eps));
    }
  }
}

__device__ __forceinline__ float ln_apply(float v, float mu, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), w), b);
}

// the epilogue of one output element
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, int64_t r, int c, float acc) {
  float y = __fadd_rn(acc, p.bias[c]);
  if (p.gelu) y = gelu_erf(y);
  if (p.gamma) y = __fmul_rn(y, p.gamma[c]);
  const int64_t idx = r * p.n + c;
  if (p.residual) y = __fadd_rn(y, to_f(static_cast<const T*>(p.residual)[idx]));
  static_cast<T*>(p.out)[idx] = from_f<T>(y);
}

// ---------------------------------------------------------------- bf16 --
constexpr int HBK = 32, HLDS = HBK + 8;  // padded rows: 80 bytes

template <bool LN>
__global__ void __launch_bounds__(kThreads) linear_bf16_kernel(Params p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 sA[BM * HLDS];
  __shared__ __align__(128) bf16 sB[BN * HLDS];
  __shared__ __align__(128) float sC[kThreads / 32][16 * 16];
  __shared__ float s_mu[BM], s_rstd[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm·64, cols wn·32
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);

  if (LN) {
    row_stats<bf16>(p, row0, s_mu, s_rstd);
    __syncthreads();
  }

  // a tile is BM (or BN) rows × 32 values = 512 vectors of 8; two a thread
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, r = v >> 2, kc = (v & 3) * 8;
      const int64_t gr = row0 + r;
      const int gn = col0 + r;
      ra[i] = gr < p.m ? *reinterpret_cast<const uint4*>(x + gr * p.k + k0 + kc)
                       : make_uint4(0, 0, 0, 0);
      rb[i] = gn < p.n ? *reinterpret_cast<const uint4*>(w + static_cast<int64_t>(gn) * p.k + k0 + kc)
                       : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, r = v >> 2, kc = (v & 3) * 8;
      uint4 a = ra[i];
      if (LN && row0 + r < p.m) {
        bf16* e = reinterpret_cast<bf16*>(&a);
        const float mu = s_mu[r], rs = s_rstd[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kk = k0 + kc + j;
          e[j] = __float2bfloat16_rn(ln_apply(__bfloat162float(e[j]), mu, rs, p.ln_w[kk], p.ln_b[kk]));
        }
      }
      *reinterpret_cast<uint4*>(&sA[r * HLDS + kc]) = a;
      *reinterpret_cast<uint4*>(&sB[r * HLDS + kc]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  for (int k0 = 0; k0 < p.k; k0 += HBK) {
    stage(k0);
    __syncthreads();
    if (k0 + HBK < p.k) load(k0 + HBK);  // in flight while this tile multiplies
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 64 + i * 16) * HLDS + kk, HLDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + (wn * 32 + j * 16) * HLDS + kk, HLDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16×16 accumulator through the warp's own scratch
  float* scratch = sC[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t gr = row0 + wm * 64 + i * 16 + e / 16;
        const int gc = col0 + wn * 32 + j * 16 + e % 16;
        if (gr < p.m && gc < p.n) store_out<bf16>(p, gr, gc, scratch[e]);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- f32 --
constexpr int FBK = 8, FLD = BM + 4;

template <bool LN>
__global__ void __launch_bounds__(kThreads) linear_f32_kernel(Params p) {
  __shared__ __align__(16) float sA[FBK][FLD];  // k-major: a column of A a row
  __shared__ __align__(16) float sB[FBK][FLD];
  __shared__ float s_mu[BM], s_rstd[BM];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  if (LN) {
    row_stats<float>(p, row0, s_mu, s_rstd);
    __syncthreads();
  }

  // a tile is 128 rows × 8 values = 256 float4: one a thread
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  float4 ra, rb;
  auto load = [&](int k0) {
    const int64_t gr = row0 + lr;
    const int gn = col0 + lr;
    ra = gr < p.m ? *reinterpret_cast<const float4*>(x + gr * p.k + k0 + lk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = gn < p.n ? *reinterpret_cast<const float4*>(w + static_cast<int64_t>(gn) * p.k + k0 + lk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stage = [&](int k0) {
    float a[4] = {ra.x, ra.y, ra.z, ra.w};
    const float b[4] = {rb.x, rb.y, rb.z, rb.w};
    if (LN && row0 + lr < p.m) {
      const float mu = s_mu[lr], rs = s_rstd[lr];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = ln_apply(a[j], mu, rs, p.ln_w[k0 + lk + j], p.ln_b[k0 + lk + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sA[lk + j][lr] = a[j];
      sB[lk + j][lr] = b[j];
    }
  };

  // this thread's rows: ty·4 + {0..3} and 64 + ty·4 + {0..3}; columns alike
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < p.k; k0 += FBK) {
    stage(k0);
    __syncthreads();
    if (k0 + FBK < p.k) load(k0 + FBK);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < p.n) store_out<float>(p, gr, gc, acc[i][j]);
    }
  }
}

}  // namespace

// x (M, K), w (N, K), residual (M, N) or null, out (M, N): one type,
// contiguous, x and w 16-byte aligned; bias (N,) f32; gamma (N,) f32 or null
// (no layer-scale); ln_w/ln_b (K,) f32 or null (no prologue); dtype 0 = f32,
// 1 = bf16; K a multiple of 32. Returns
// the cudaError_t of the launch (0 on success). Argument checks (device, dtype,
// contiguity, shapes) are the Python wrapper's job.
extern "C" int linear_fused_launch(const void* x, const void* w, const void* bias,
                                   const void* residual, const void* gamma,
                                   const void* ln_w, const void* ln_b,
                                   float eps, void* out, long long m, int n, int k, int gelu,
                                   int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 32 != 0 || (m + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x, w, static_cast<const float*>(bias), residual, static_cast<const float*>(gamma),
           static_cast<const float*>(ln_w),
           static_cast<const float*>(ln_b), eps, out, m, n, k, gelu};
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN), static_cast<unsigned>((m + BM - 1) / BM));
  const auto s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_w != nullptr;
  if (dtype == 1) {
    if (ln) linear_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else linear_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    if (ln) linear_f32_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else linear_f32_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
