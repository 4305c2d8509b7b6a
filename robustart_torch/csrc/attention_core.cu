// Attention core softmax(Q·scale·Kᵀ)·V per (image, head), for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_attention.py::mha_pallas (K8, the Pallas
// TPU kernel, pl.pallas_call at :52) and is step (b) of window_block_pallas
// (K6, :628; steps (a) and (c) are linear_fused.cu). For one image b, one
// head h and a block of 64 query rows:
//
//   s   = (q_h · k_hᵀ) · scale                  f32 (D = 64, scale = 1/8)
//   s   = round_scores ? f32(T(s)) : s
//   p   = exp(s - max_row(s)) / sum_row(...)     f32, as :26-40
//   out = T(T(p) · v_h)                          f32 accumulators, one cast
//
// D = 64 is fixed by the models here (ViT-B/16, ViT-B/32, DeiT), so scale is
// 1/8, a power of two: q·scale rounds to the same value in any type, and
// scaling the f32 product instead of q is exact. That makes the two JAX
// forms one kernel: K8's Pallas kernel scales q in f32 and keeps the scores
// in f32 (round_scores = 0); K6's reference, which its VJP and tests take as
// the definition (pallas_attention.py:336), casts q·scale to the working
// type and its einsum returns scores in the working type (round_scores = 1,
// which is a no-op in f32).
//
// Design. The TPU kernel holds a whole (197, 64) head and its 197×197 score
// matrix in VMEM per program. Here a block of 8 warps takes 64 query rows
// and the head's full K and V (N ≤ 256 keys) in shared memory, computes the
// scores into shared memory, takes the softmax one row per warp, and
// multiplies by V. Nothing N×N reaches device memory.
//
// - bf16: tensor cores (nvcuda::wmma 16×16×16, f32 accumulators) for Q·Kᵀ
//   and P·V. Keys are padded to a multiple of 16 (197 → 208) with zero
//   rows; the softmax reads only the N real columns and writes P = 0 in the
//   padded ones, so padding adds exact zeros to P·V. Query rows past N are
//   computed on zeros and never stored.
// - f32: CUDA-core FMA, never TF32; K is held with a row pitch of 65 floats
//   so a warp's 32 keys fall in 32 banks.
//
// Q, K and V are read through a token stride and a batch stride, the head at
// column h·64: K8 passes (B, N, H, D) tensors, K6 the packed (B, N, 3, H, D)
// output of its q/k/v product with no copy. The output is (B, N, H, D).
//
// Bound: at ViT-B's shape (B = 128, N = 197, 12 heads) the core is 15 GFLOP
// for 116 MB of q, k, v and output, about 130 FLOP a byte: below the
// H100's 295 in bf16, so memory bounds it alone; inside K6 the q/k/v and
// proj products (119 GFLOP) set the pace.
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
constexpr int D = 64, BQ = 64, LDH = D + 8;  // bf16 rows padded to 144 bytes
constexpr int kMaxN = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int n, heads;
  long long tok_in, batch_in, tok_out, batch_out;
  float scale;
};

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// shared-memory layout of the bf16 kernel for np padded keys
struct Bf16Layout {
  size_t q, k, v, s, p, c, total;
  __host__ __device__ explicit Bf16Layout(int np) {
    q = 0;
    k = q + align128(sizeof(bf16) * BQ * LDH);
    v = k + align128(sizeof(bf16) * np * LDH);
    s = v + align128(sizeof(bf16) * np * LDH);
    p = s + align128(sizeof(float) * BQ * (np + 4));
    c = p + align128(sizeof(bf16) * BQ * (np + 8));
    total = c + sizeof(float) * kWarps * 256;
  }
};

__host__ __device__ constexpr size_t f32_smem(int n) {
  return sizeof(float) * (BQ * D + n * (D + 1) + n * D + BQ * n);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// softmax of score rows r = warp, warp + 8, ... over the n real columns,
// in place in f32 (s has row pitch lds)
template <bool ROUND>
__device__ void softmax_rows(float* s, int lds, int n, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kWarps) {
    float* row = s + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      float x = row[j] * scale;
      if (ROUND) x = __bfloat162float(__float2bfloat16_rn(x));
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

template <bool ROUND>
__global__ void __launch_bounds__(kThreads) attention_bf16_kernel(Args a, int np) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L(np);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  const int lds = np + 4, ldp = np + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * BQ;
  const int64_t head = static_cast<int64_t>(b) * a.batch_in + h * D;
  const bf16* qg = static_cast<const bf16*>(a.q) + head;
  const bf16* kg = static_cast<const bf16*>(a.k) + head;
  const bf16* vg = static_cast<const bf16*>(a.v) + head;

  // rows of 64 values = 8 vectors of 16 bytes; rows past n load as zero
  for (int i = tid; i < BQ * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int t = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * LDH + c) =
        t < n ? *reinterpret_cast<const uint4*>(qg + t * a.tok_in + c) : make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < np * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
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

  softmax_rows<ROUND>(sS, lds, n, a.scale);
  for (int r = warp; r < BQ; r += kWarps) {
    for (int j = lane; j < np; j += 32) {
      sP[r * ldp + j] = j < n ? __float2bfloat16_rn(sS[r * lds + j]) : __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  // O = P·V: (BQ / 16) × (D / 16) tiles, two a warp
  float* scratch = reinterpret_cast<float*>(smem + L.c) + warp * 256;
  bf16* og = static_cast<bf16*>(a.out) + static_cast<int64_t>(b) * a.batch_out + h * D;
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

__global__ void __launch_bounds__(kThreads) attention_f32_kernel(Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int n = a.n;
  float* sQ = fsm;                 // BQ × D
  float* sK = sQ + BQ * D;         // n × (D + 1)
  float* sV = sK + n * (D + 1);    // n × D
  float* sS = sV + n * D;          // BQ × n
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * BQ;
  const int64_t head = static_cast<int64_t>(b) * a.batch_in + h * D;
  const float* qg = static_cast<const float*>(a.q) + head;
  const float* kg = static_cast<const float*>(a.k) + head;
  const float* vg = static_cast<const float*>(a.v) + head;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    sQ[i] = t < n ? qg[t * a.tok_in + c] : 0.0f;
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
  softmax_rows<false>(sS, n, n, a.scale);  // warp w takes rows w, w + 8, ...
  __syncthreads();

  float o[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float v0 = sV[j * D + lane], v1 = sV[j * D + lane + 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float pv = sS[(r0 + i) * n + j];
      o[i][0] = fmaf(pv, v0, o[i][0]);
      o[i][1] = fmaf(pv, v1, o[i][1]);
    }
  }
  float* og = static_cast<float*>(a.out) + static_cast<int64_t>(b) * a.batch_out + h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + r0 + i;
    if (t < n) {
      og[t * a.tok_out + lane] = o[i][0];
      og[t * a.tok_out + lane + 32] = o[i][1];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// q, k, v: element (b, t, h, d) at b·batch_in + t·tok_in + h·64 + d; out:
// b·batch_out + t·tok_out + h·64 + d; one type (dtype 0 = f32, 1 = bf16),
// 16-byte aligned rows; n ≤ 256 tokens, head dim 64. round_scores = 1
// rounds the scaled scores to the working type before the softmax (K6's
// definition). Returns the cudaError_t of the launch (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k, const void* v, void* out,
                                     int batch, int n, int heads, long long tok_in,
                                     long long batch_in, long long tok_out, long long batch_out,
                                     float scale, int round_scores, int dtype, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN || heads <= 0 || static_cast<long long>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, n, heads, tok_in, batch_in, tok_out, batch_out, scale};
  const dim3 grid(static_cast<unsigned>((n + BQ - 1) / BQ), static_cast<unsigned>(batch * heads));
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const int np = (n + 15) / 16 * 16;
    const size_t bytes = Bf16Layout(np).total;
    if (round_scores) {
      err = allow_smem(attention_bf16_kernel<true>, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      attention_bf16_kernel<true><<<grid, kThreads, bytes, s>>>(a, np);
    } else {
      err = allow_smem(attention_bf16_kernel<false>, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      attention_bf16_kernel<false><<<grid, kThreads, bytes, s>>>(a, np);
    }
  } else if (dtype == 0) {
    const size_t bytes = f32_smem(n);
    err = allow_smem(attention_f32_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_f32_kernel<<<grid, kThreads, bytes, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
