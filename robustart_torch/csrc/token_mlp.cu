// Token-mixing MLP of MLP-Mixer (kernel K10), for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_mlp.py::token_mlp_pallas (the Pallas TPU
// kernel, pl.pallas_call at :461). For x (B, T, C) in the working type T_
// (bf16 or f32), W1 (H, T) and W2 (T, H) in nn.Linear's (out, in) layout and
// in T_, f32 biases b1 (H,) and b2 (T,):
//
//   x^[b,t,c] = ln ? T_((x - mu_t) * rsqrt(var_t + eps) * ln_w[c] + ln_b[c]) : x
//               mu_t = E_c[x], var_t = E_c[x^2] - mu_t^2, f32, over all C
//   u[b,c,h]  = sum_t x^[b,t,c] * W1[h,t] + b1[h]          f32 accumulators
//   a[b,c,h]  = T_(act(u))                                 (activation.cuh)
//   y[b,t,c]  = sum_h a[b,c,h] * W2[t,h] + b2[t]            (b2 by token)
//   out       = T_(y + residual[b,t,c])                      residual: the raw
//               pre-norm x, a separate shortcut, or none; one cast
//
// in the order of pallas_mlp.py::_token_mlp_kernel (:392-428). The
// activation is one of the four of pallas_mlp.py::_act_fn; GELU is the
// exact erf form (erff); the TPU kernel computes erf with the polynomial of
// Abramowitz & Stegun 7.1.26 (pallas_mlp.py:32-41, |error| <= 1.5e-7)
// because Mosaic lowers no erf, and its XLA reference uses the exact erf.
//
// Design. The TPU kernel holds one image's (T, C) tile and both weight
// matrices in VMEM and contracts over the token axis there, so neither the
// (B, C, T) transpose nor the (B, C, H) hidden reaches HBM. Here one block
// owns (image b, 64 channels):
//
// - the LayerNorm statistics of the image's T tokens over all C, taken by
//   the block itself (the image's rows stay in L2 for its C/64 blocks);
// - the (T, 64) tile of x^, normalized and cast as it is staged, in shared
//   memory, with T padded to a multiple of 16 by exact zeros;
// - for each chunk of 64 hidden units: W1's and W2's chunks staged into
//   shared memory, u = x^T * W1 chunk (64 x 64), bias and activation in f32, cast,
//   into shared memory, and y (T x 64) += W2 chunk * a^T, y held in
//   registers across the chunks;
// - the epilogue: + b2[t], + the residual, one cast, one store.
//
// The transpose and the hidden never leave the SM. bf16 runs on the tensor
// cores through nvcuda::wmma (16x16x16, f32 accumulators); f32 runs on CUDA
// cores with FMA, never TF32. Every LayerNorm and epilogue step is a _rn
// intrinsic (no contraction into an FMA), so the casts see the plain
// version's numbers.
//
// Bound: operations. At Mixer-B/16 (B = 128, T = 196, C = 768, H = 384) the
// two products are 4*B*C*T*H = 29.6 GFLOP against 77 MB of x in and out.
//
// Binding: a plain C entry point (token_mlp_launch) called through ctypes;
// it launches on the caller's stream and returns the cudaError_t of the
// launch. T <= 256.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int CC = 64;          // channels a block
constexpr int HC = 64;          // hidden units a step
constexpr int kMaxTokens = 256;
constexpr int kMaxTiles = kMaxTokens / 16 * (CC / 16) / kWarps;  // y tiles a warp

struct Params {
  const void* x;         // (B, T, C) T_
  const void* w1;        // (H, T) T_
  const float* b1;       // (H,)
  const void* w2;        // (T, H) T_
  const float* b2;       // (T,)
  const void* residual;  // (B, T, C) T_ or null
  const float* ln_w;     // (C,) or null: no prologue
  const float* ln_b;     // (C,)
  float eps;
  void* out;             // (B, T, C) T_
  int t, c, h, act;      // act: an activation.cuh code
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// f32 mean and 1/sqrt(var + eps) of each of the image's tokens over all C
template <typename T>
__device__ void token_stats(const Params& p, const T* xb, float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < p.t; t += kWarps) {
    const T* row = xb + static_cast<int64_t>(t) * p.c;
    float sum = 0.0f, sq = 0.0f;
    for (int c = lane; c < p.c; c += 32) {
      const float v = to_f(row[c]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      const float mu = sum / static_cast<float>(p.c);
      const float var = __fsub_rn(sq / static_cast<float>(p.c), __fmul_rn(mu, mu));
      s_mu[t] = mu;
      s_rstd[t] = rsqrtf(__fadd_rn(var, p.eps));
    }
  }
}

// stage the (Tp, 64) tile of x^ into xs[t * ld + c], zeros past T and C
template <typename T, bool LN>
__device__ void stage_x(const Params& p, const T* xb, int c0, int tp, T* xs, int ld,
                        const float* s_mu, const float* s_rstd) {
  for (int e = threadIdx.x; e < tp * CC; e += kThreads) {
    const int t = e / CC, cc = e % CC, c = c0 + cc;
    float v = 0.0f;
    if (t < p.t && c < p.c) {
      v = to_f(xb[static_cast<int64_t>(t) * p.c + c]);
      if (LN) v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, s_mu[t]), s_rstd[t]), p.ln_w[c]),
                            p.ln_b[c]);
    }
    xs[t * ld + cc] = from_f<T>(v);
  }
}

// the epilogue of one output element
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, int64_t base, int t, int c, float acc) {
  float y = __fadd_rn(acc, p.b2[t]);
  const int64_t idx = base + static_cast<int64_t>(t) * p.c + c;
  if (p.residual) y = __fadd_rn(y, to_f(static_cast<const T*>(p.residual)[idx]));
  static_cast<T*>(p.out)[idx] = from_f<T>(y);
}

// ---------------------------------------------------------------- bf16 --
// shared memory: xs [t][c] (ld 72), w1s [h][t] (ld Tp + 8), w2s [t][h]
// (ld 72), hs [c][h] (ld 72), a 16x16 f32 scratch a warp
constexpr int LDC = CC + 8;

struct Bf16Layout {
  int xs, w1s, w2s, hs, scratch, stats, total;
  __host__ __device__ explicit Bf16Layout(int tp) {
    xs = 0;
    w1s = xs + align128(tp * LDC * 2);
    w2s = w1s + align128(HC * (tp + 8) * 2);
    hs = w2s + align128(tp * LDC * 2);
    scratch = hs + align128(CC * LDC * 2);
    stats = scratch + kWarps * 256 * 4;
    total = stats + 2 * kMaxTokens * 4;
  }
};

template <bool LN>
__global__ void __launch_bounds__(kThreads) token_mlp_bf16_kernel(Params p, int tp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L(tp);
  float* s_mu = reinterpret_cast<float*>(smem + L.stats);
  float* s_rstd = s_mu + kMaxTokens;
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1s);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2s);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 256;
  const int ldw1 = tp + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * CC;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * p.t * p.c;
  const bf16* xb = static_cast<const bf16*>(p.x) + base;
  const bf16* w1 = static_cast<const bf16*>(p.w1);
  const bf16* w2 = static_cast<const bf16*>(p.w2);

  if (LN) {
    token_stats<bf16>(p, xb, s_mu, s_rstd);
    __syncthreads();
  }
  stage_x<bf16, LN>(p, xb, c0, tp, xs, LDC, s_mu, s_rstd);

  const int n_tiles = tp / 16 * (CC / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y[kMaxTiles];
#pragma unroll
  for (int s = 0; s < kMaxTiles; ++s) wmma::fill_fragment(y[s], 0.0f);

  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int h0 = 0; h0 < p.h; h0 += HC) {
    // W1's chunk as [h][t], W2's as [t][h]; zeros past T and H
    for (int e = tid; e < HC * tp; e += kThreads) {
      const int hh = e / tp, t = e % tp, h = h0 + hh;
      w1s[hh * ldw1 + t] = (h < p.h && t < p.t) ? w1[static_cast<int64_t>(h) * p.t + t] : zero;
    }
    for (int e = tid; e < tp * HC; e += kThreads) {
      const int t = e / HC, hh = e % HC, h = h0 + hh;
      w2s[t * LDC + hh] = (h < p.h && t < p.t) ? w2[static_cast<int64_t>(t) * p.h + h] : zero;
    }
    __syncthreads();

    // u (64 channels x 64 hidden) = x^T * W1 chunk: warp w takes channel
    // tile w / 2 and hidden tiles (w % 2) * 2 + {0, 1}
    {
      const int ct = warp / 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> u[2];
      wmma::fill_fragment(u[0], 0.0f);
      wmma::fill_fragment(u[1], 0.0f);
      for (int k = 0; k < tp; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, xs + k * LDC + ct * 16, LDC);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, w1s + ((warp % 2) * 2 + j) * 16 * ldw1 + k, ldw1);
          wmma::mma_sync(u[j], fa, fb, u[j]);
        }
      }
      // + b1, the activation, cast: hs[c][h]
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ht = (warp % 2) * 2 + j;
        wmma::store_matrix_sync(scratch, u[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int cc = ct * 16 + e / 16, hh = ht * 16 + e % 16, h = h0 + hh;
          const float v = h < p.h ? act_apply(p.act, __fadd_rn(scratch[e], p.b1[h])) : 0.0f;
          hs[cc * LDC + hh] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // y (Tp tokens x 64 channels) += W2 chunk * a^T: warp w takes the tiles
    // w, w + 8, ...
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s) {
      const int i = warp + kWarps * s;
      if (i < n_tiles) {
        const int rt = i / (CC / 16), ct = i % (CC / 16);
#pragma unroll
        for (int k = 0; k < HC; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, w2s + rt * 16 * LDC + k, LDC);
          wmma::load_matrix_sync(fb, hs + ct * 16 * LDC + k, LDC);
          wmma::mma_sync(y[s], fa, fb, y[s]);
        }
      }
    }
    __syncthreads();
  }

  // + b2[t], + residual, one cast
#pragma unroll
  for (int s = 0; s < kMaxTiles; ++s) {
    const int i = warp + kWarps * s;
    if (i < n_tiles) {
      const int rt = i / (CC / 16), ct = i % (CC / 16);
      wmma::store_matrix_sync(scratch, y[s], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = rt * 16 + e / 16, c = c0 + ct * 16 + e % 16;
        if (t < p.t && c < p.c) store_out<bf16>(p, base, t, c, scratch[e]);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- f32 --
// shared memory: xs [t][c], w1s [t][h], hs [h][c] (ld 68), w2s [h][t]
// (ld Tp + 4): every product reads its operands k-major
constexpr int LDF = CC + 4;

struct F32Layout {
  int xs, w1s, w2s, hs, stats, total;
  __host__ __device__ explicit F32Layout(int tp) {
    xs = 0;
    w1s = xs + align128(tp * LDF * 4);
    w2s = w1s + align128(tp * LDF * 4);
    hs = w2s + align128(HC * (tp + 4) * 4);
    stats = hs + align128(HC * LDF * 4);
    total = stats + 2 * kMaxTokens * 4;
  }
};

template <bool LN>
__global__ void __launch_bounds__(kThreads) token_mlp_f32_kernel(Params p, int tp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L(tp);
  float* s_mu = reinterpret_cast<float*>(smem + L.stats);
  float* s_rstd = s_mu + kMaxTokens;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* w1s = reinterpret_cast<float*>(smem + L.w1s);
  float* w2s = reinterpret_cast<float*>(smem + L.w2s);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  const int ldw2 = tp + 4;

  const int tid = threadIdx.x, tc = tid % 16, tr = tid / 16;
  const int c0 = blockIdx.x * CC;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * p.t * p.c;
  const float* xb = static_cast<const float*>(p.x) + base;
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);

  if (LN) {
    token_stats<float>(p, xb, s_mu, s_rstd);
    __syncthreads();
  }
  stage_x<float, LN>(p, xb, c0, tp, xs, LDF, s_mu, s_rstd);

  // this thread's outputs: channels tc * 4 + {0..3}; in y the tokens
  // tr + 16 i
  float y[kMaxTokens / 16][4];
#pragma unroll
  for (int i = 0; i < kMaxTokens / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) y[i][j] = 0.0f;

  for (int h0 = 0; h0 < p.h; h0 += HC) {
    for (int e = tid; e < tp * HC; e += kThreads) {
      const int t = e / HC, hh = e % HC, h = h0 + hh;
      w1s[t * LDF + hh] = (h < p.h && t < p.t) ? w1[static_cast<int64_t>(h) * p.t + t] : 0.0f;
    }
    for (int e = tid; e < HC * tp; e += kThreads) {
      const int hh = e / tp, t = e % tp, h = h0 + hh;
      w2s[hh * ldw2 + t] = (h < p.h && t < p.t) ? w2[static_cast<int64_t>(t) * p.h + h] : 0.0f;
    }
    __syncthreads();

    // u: channels tc * 4 + i, hidden units tr * 4 + j
    float u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u[i][j] = 0.0f;
    for (int t = 0; t < p.t; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[t * LDF + tc * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&w1s[t * LDF + tr * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = fmaf(av[i], bv[j], u[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = tr * 4 + j, h = h0 + hh;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hs[hh * LDF + tc * 4 + i] = h < p.h ? act_apply(p.act, __fadd_rn(u[i][j], p.b1[h])) : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int hh = 0; hh < HC; ++hh) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[hh * LDF + tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < kMaxTokens / 16; ++i) {
        if (i * 16 < tp) {
          const float w = w2s[hh * ldw2 + tr + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[i][j] = fmaf(w, av[j], y[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxTokens / 16; ++i) {
    const int t = tr + 16 * i;
    if (t >= p.t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c < p.c) store_out<float>(p, base, t, c, y[i][j]);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int bytes, cudaStream_t s, const Params& p, int tp) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(p, tp);
  return cudaGetLastError();
}

}  // namespace

// x, residual, out (B, T, C), w1 (H, T), w2 (T, H): one type, contiguous;
// b1 (H,), b2 (T,) f32; residual null for none (pass x itself for the raw
// pre-norm residual); ln_w/ln_b (C,) f32 or null (no prologue); dtype 0 =
// f32, 1 = bf16; act an activation.cuh code; T <= 256. Returns the cudaError_t of the launch (0 on
// success). Argument checks (device, dtype, contiguity, shapes) are the
// Python wrapper's job.
extern "C" int token_mlp_launch(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* residual, const void* ln_w,
                                const void* ln_b, float eps, void* out, int batch, int t, int c,
                                int h, int act, int dtype, void* stream) {
  if (batch <= 0 || c <= 0) return 0;
  if (t <= 0 || t > kMaxTokens || h <= 0 || batch > 65535 || act < kActNone || act > kActRelu) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                 residual, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                 eps, out, t, c, h, act};
  const int tp = (t + 15) / 16 * 16;
  const dim3 grid(static_cast<unsigned>((c + CC - 1) / CC), static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_w != nullptr;
  if (dtype == 1) {
    const int bytes = Bf16Layout(tp).total;
    return static_cast<int>(ln ? launch(token_mlp_bf16_kernel<true>, grid, bytes, s, p, tp)
                               : launch(token_mlp_bf16_kernel<false>, grid, bytes, s, p, tp));
  }
  if (dtype == 0) {
    const int bytes = F32Layout(tp).total;
    return static_cast<int>(ln ? launch(token_mlp_f32_kernel<true>, grid, bytes, s, p, tp)
                               : launch(token_mlp_f32_kernel<false>, grid, bytes, s, p, tp));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
