// Attention core softmax(Q·Kᵀ·scale + bias + mask)·V per (image or window,
// head), for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of robustart_tpu/ops/pallas_attention.py:
// mha_pallas (K8, pl.pallas_call at :52), window_mha_pallas (K9, Swin's
// window attention, :203) and step (b) of window_block_pallas (K6, :628;
// steps (a) and (c) are linear_fused.cu). For one image or window b, one
// head h and a block of 64 query rows:
//
//   s   = (T(q_h · q_scale) · k_hᵀ) · s_scale       f32 products
//   s   = round_scores ? f32(T(s)) : s
//   s   = s + bias[h] + mask[b % nW]                  f32, each optional
//   p   = exp(s - max_row(s)) / sum_row(...)          f32
//   out = T(T(p) · v_h)                               f32 accumulators, one cast
//
// The three JAX forms differ only in where q is scaled and what is rounded:
//
// - K8 and K9 (their Pallas kernels, :26-40 and :125-153) scale q in f32
//   and keep f32 scores: the wrapper passes q_scale = 1, s_scale = 1/√D in
//   bf16 (the tensor cores take q as it is; scaling the f32 product instead
//   differs only by f32 rounding) and q_scale = 1/√D, s_scale = 1 in f32.
// - K6's reference, which its VJP and tests take as the definition
//   (:336-343), casts q·scale to the working type before the product and
//   the scores after it, then adds the f32 bias and mask: q_scale = 1/√D,
//   s_scale = 1, round_scores = 1. At D = 64 the scale is 1/8 and the first
//   cast is exact; at Swin's D = 32 it is not, so q·scale is rounded to bf16
//   as it is staged into shared memory.
//
// Swin's relative-position bias is (H, N, N) f32 and its shift mask (nW, N,
// N) f32; windows are image-major as window_partition orders them, so
// window b takes mask b % nW.
//
// Design. The TPU kernels hold a whole head (197 × 64 for ViT, 49 × 32 for a
// Swin window) and its score matrix in VMEM per program. Here a block of 8
// warps takes 64 query rows and the head's full K and V (N ≤ 256 keys) in
// shared memory, computes the scores into shared memory, takes the softmax
// one row per warp, and multiplies by V. Nothing N×N reaches device memory.
//
// - bf16: tensor cores (nvcuda::wmma 16×16×16, f32 accumulators) for Q·Kᵀ
//   and P·V. Keys are padded to a multiple of 16 (197 → 208, 49 → 64) with
//   zero rows; the softmax reads only the N real columns and writes P = 0 in
//   the padded ones, so padding adds exact zeros to P·V. Query rows past N
//   are computed on zeros and never stored.
// - f32: CUDA-core FMA, never TF32; K is held with a row pitch of D + 1
//   floats so a warp's 32 keys fall in 32 banks.
//
// The head width D is a template parameter, 32 (Swin) or 64 (ViT, DeiT).
// Q, K and V are read through a token stride and a batch stride, the head at
// column h·D: K8 and K9 pass (B, N, H, D) tensors, K6 the packed (B, N, 3,
// H, D) output of its q/k/v product with no copy. The output is (B, N, H, D).
//
// Bound: at ViT-B's shape (B = 128, N = 197, 12 heads) the core is 15 GFLOP
// for 116 MB of q, k, v and output, about 130 FLOP a byte: below the
// H100's 295 in bf16, so memory bounds it. A Swin window (N = 49, D = 32)
// is about 25 FLOP a byte: memory-bound further still.
//
// Binding: a plain C entry point (attention_core_launch) called through
// ctypes; it launches on the caller's stream and returns the cudaError_t of
// the launch.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int BQ = 64;
constexpr int kMaxN = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* bias;  // (H, N, N) or null
  const float* mask;  // (nW, N, N) or null
  int n, heads, num_windows;
  long long tok_in, batch_in, tok_out, batch_out;
  float q_scale, s_scale;
};

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// shared-memory layout of the bf16 kernel for np padded keys and head width d
// (bf16 rows padded by 8 values: 80 bytes at d = 32, 144 at d = 64)
struct Bf16Layout {
  size_t q, k, v, s, p, c, total;
  __host__ __device__ Bf16Layout(int np, int d) {
    const int ldh = d + 8;
    q = 0;
    k = q + align128(sizeof(bf16) * BQ * ldh);
    v = k + align128(sizeof(bf16) * np * ldh);
    s = v + align128(sizeof(bf16) * np * ldh);
    p = s + align128(sizeof(float) * BQ * (np + 4));
    c = p + align128(sizeof(bf16) * BQ * (np + 8));
    total = c + sizeof(float) * kWarps * 256;
  }
};

__host__ __device__ constexpr size_t f32_smem(int n, int d) {
  return sizeof(float) * (BQ * d + n * (d + 1) + n * d + BQ * n);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// softmax of the real score rows (query q0 + r < n) r = warp, warp + 8, ...
// over the n real columns, in place in f32 (s has row pitch lds); bias and
// mask are this head's and this window's (N, N) planes or null
template <bool ROUND>
__device__ void softmax_rows(float* s, int lds, int n, int q0, float s_scale,
                             const float* bias, const float* mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ && q0 + r < n; r += kWarps) {
    float* row = s + r * lds;
    const int64_t off = static_cast<int64_t>(q0 + r) * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      float x = row[j] * s_scale;
      if (ROUND) x = __bfloat162float(__float2bfloat16_rn(x));
      if (bias) x += bias[off + j];
      if (mask) x += mask[off + j];
      row[j] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = row[j] / sum;
  }
}

// this block's (image or window, head) and its bias and mask planes
struct Where {
  int b, h;
  const float* bias;
  const float* mask;
  __device__ explicit Where(const Args& a) {
    b = blockIdx.x / a.heads;
    h = blockIdx.x % a.heads;
    const int64_t nn = static_cast<int64_t>(a.n) * a.n;
    bias = a.bias ? a.bias + h * nn : nullptr;
    mask = a.mask ? a.mask + (b % a.num_windows) * nn : nullptr;
  }
};

template <int D, bool ROUND>
__global__ void __launch_bounds__(kThreads) attention_bf16_kernel(Args a, int np) {
  using namespace nvcuda;
  constexpr int LDH = D + 8, VEC = D / 8;  // 16-byte vectors a row
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L(np, D);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  const int lds = np + 4, ldp = np + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n;
  const Where at(a);
  const int q0 = blockIdx.y * BQ;
  const int64_t head = static_cast<int64_t>(at.b) * a.batch_in + at.h * D;
  const bf16* qg = static_cast<const bf16*>(a.q) + head;
  const bf16* kg = static_cast<const bf16*>(a.k) + head;
  const bf16* vg = static_cast<const bf16*>(a.v) + head;

  // rows of D values = D / 8 vectors of 16 bytes; rows past n load as zero;
  // q is scaled by q_scale and rounded to bf16 (exact at q_scale = 1)
  for (int i = tid; i < BQ * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const int t = q0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t < n) {
      u = *reinterpret_cast<const uint4*>(qg + t * a.tok_in + c);
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * a.q_scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDH + c) = u;
  }
  for (int i = tid; i < np * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const bool in = r < n;
    *reinterpret_cast<uint4*>(sK + r * LDH + c) =
        in ? *reinterpret_cast<const uint4*>(kg + r * a.tok_in + c) : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sV + r * LDH + c) =
        in ? *reinterpret_cast<const uint4*>(vg + r * a.tok_in + c) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // S = Q·Kᵀ: (BQ / 16) × (np / 16) tiles over the warps
  const int tn = np / 16;
  for (int t = warp; t < (BQ / 16) * tn; t += kWarps) {
    const int mi = t / tn, nj = t % tn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sQ + mi * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(fb, sK + nj * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sS + mi * 16 * lds + nj * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  softmax_rows<ROUND>(sS, lds, n, q0, a.s_scale, at.bias, at.mask);
  for (int r = warp; r < BQ; r += kWarps) {
    const bool real = q0 + r < n;
    for (int j = lane; j < np; j += 32) {
      sP[r * ldp + j] = __float2bfloat16_rn(real && j < n ? sS[r * lds + j] : 0.0f);
    }
  }
  __syncthreads();

  // O = P·V: (BQ / 16) × (D / 16) tiles over the warps
  float* scratch = reinterpret_cast<float*>(smem + L.c) + warp * 256;
  bf16* og = static_cast<bf16*>(a.out) + static_cast<int64_t>(at.b) * a.batch_out + at.h * D;
  for (int t = warp; t < (BQ / 16) * (D / 16); t += kWarps) {
    const int mi = t / (D / 16), nj = t % (D / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < np; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sP + mi * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, sV + kk * LDH + nj * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int t_row = q0 + mi * 16 + e / 16;
      if (t_row < n) og[t_row * a.tok_out + nj * 16 + e % 16] = __float2bfloat16_rn(scratch[e]);
    }
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_f32_kernel(Args a) {
  constexpr int DL = D / 32;  // output columns a lane
  extern __shared__ __align__(16) float fsm[];
  const int n = a.n;
  float* sQ = fsm;                 // BQ × D
  float* sK = sQ + BQ * D;         // n × (D + 1)
  float* sV = sK + n * (D + 1);    // n × D
  float* sS = sV + n * D;          // BQ × n
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Where at(a);
  const int q0 = blockIdx.y * BQ;
  const int64_t head = static_cast<int64_t>(at.b) * a.batch_in + at.h * D;
  const float* qg = static_cast<const float*>(a.q) + head;
  const float* kg = static_cast<const float*>(a.k) + head;
  const float* vg = static_cast<const float*>(a.v) + head;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    sQ[i] = t < n ? qg[t * a.tok_in + c] * a.q_scale : 0.0f;
  }
  for (int i = tid; i < n * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sK[r * (D + 1) + c] = kg[r * a.tok_in + c];
    sV[i] = vg[r * a.tok_in + c];
  }
  __syncthreads();

  // scores: warp w computes rows w·8 .. w·8 + 7
  const int r0 = warp * 8;
  for (int j = lane; j < n; j += 32) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kv = sK[j * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(sQ[(r0 + i) * D + d], kv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sS[(r0 + i) * n + j] = acc[i];
  }
  __syncthreads();
  softmax_rows<false>(sS, n, n, q0, a.s_scale, at.bias, at.mask);  // rows w, w + 8, ...
  __syncthreads();

  float o[8][DL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DL; ++c) o[i][c] = 0.0f;
  for (int j = 0; j < n; ++j) {
    float vv[DL];
#pragma unroll
    for (int c = 0; c < DL; ++c) vv[c] = sV[j * D + lane + 32 * c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float pv = sS[(r0 + i) * n + j];
#pragma unroll
      for (int c = 0; c < DL; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
    }
  }
  float* og = static_cast<float*>(a.out) + static_cast<int64_t>(at.b) * a.batch_out + at.h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + r0 + i;
    if (t < n) {
#pragma unroll
      for (int c = 0; c < DL; ++c) og[t * a.tok_out + lane + 32 * c] = o[i][c];
    }
  }
}

template <typename K, typename... X>
cudaError_t launch(K kernel, dim3 grid, size_t bytes, cudaStream_t s, X... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Args& a, dim3 grid, int round_scores, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    const int np = (a.n + 15) / 16 * 16;
    const size_t bytes = Bf16Layout(np, D).total;
    return round_scores ? launch(attention_bf16_kernel<D, true>, grid, bytes, s, a, np)
                        : launch(attention_bf16_kernel<D, false>, grid, bytes, s, a, np);
  }
  if (dtype == 0) return launch(attention_f32_kernel<D>, grid, f32_smem(a.n, D), s, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: element (b, t, h, d) at b·batch_in + t·tok_in + h·head_dim + d;
// out: b·batch_out + t·tok_out + h·head_dim + d; one type (dtype 0 = f32,
// 1 = bf16), 16-byte aligned rows; n ≤ 256 tokens, head_dim 32 or 64.
// bias (heads, n, n) f32 or null; mask (num_windows, n, n) f32 or null,
// window b taking plane b % num_windows. q is scaled by q_scale (and, in
// bf16, rounded) before the product, the scores by s_scale after it;
// round_scores = 1 rounds the scores to the working type before the bias
// (K6's definition). Returns the cudaError_t of the launch (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k, const void* v, void* out,
                                     const void* bias, const void* mask, int batch, int n,
                                     int heads, int head_dim, int num_windows, long long tok_in,
                                     long long batch_in, long long tok_out, long long batch_out,
                                     float q_scale, float s_scale, int round_scores, int dtype,
                                     void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN || heads <= 0 || num_windows <= 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, static_cast<const float*>(bias), static_cast<const float*>(mask),
               n, heads, num_windows, tok_in, batch_in, tok_out, batch_out, q_scale, s_scale};
  const dim3 grid(static_cast<unsigned>(batch * heads), static_cast<unsigned>((n + BQ - 1) / BQ));
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 32) {
    err = dispatch<32>(a, grid, round_scores, dtype, s);
  } else if (head_dim == 64) {
    err = dispatch<64>(a, grid, round_scores, dtype, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
