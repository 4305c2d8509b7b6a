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
// activation is one of the four of pallas_mlp.py::_act_fn; GELU's erf is the
// TPU kernel's polynomial (Abramowitz & Stegun 7.1.26, pallas_mlp.py:32-41,
// |error| <= 1.5e-7; activation.cuh says why). Every LayerNorm and epilogue
// step is a _rn intrinsic (no contraction into an FMA), so the casts see the
// plain version's numbers.
//
// The TPU kernel holds one image's (T, C) tile and both weight matrices in
// VMEM and contracts over the token axis there, so neither the (B, C, T)
// transpose nor the (B, C, H) hidden reaches HBM. Here neither does either.
//
// Bound: operations. At Mixer-B/16 (B = 128, T = 196, C = 768, H = 384) the
// two products are 4*B*C*T*H = 29.6 GFLOP against 77 MB of x in and out.
//
// Design (bf16, the main path): two launches.
//
// 1. token_stats_bf16_kernel: mu and rstd of every (b, t) row over all C
//    into an (B*T, 2) f32 scratch, one warp a row, x read once.
// 2. token_mlp_bf16_kernel: one block owns (image b, 128 channels): two
//    warpgroups of 64 channels each and nothing else, 256 threads, so that
//    a thread may hold 255 registers (yT alone takes Tp / 2; at 288 or 384
//    threads, a producer warp or warpgroup beside them, ptxas compiled
//    every thread to 168 registers, setmaxnreg or not, and serialized the
//    products).
//    - The weights come packed by the wrapper (ops/mlp.py::
//      pack_token_weights): W1 as (Hp, Tp) and W2 as (Tp, Hp), zero-padded,
//      Tp = T rounded up to a compiled width (64, 128, 208 or 256: the
//      second product's N, a wgmma immediate), Hp = H rounded up to 64.
//      For each chunk of 64 hidden units, W1's chunk (64 x Tp, in K blocks
//      of 64 tokens) and W2's (Tp x 64) come by TMA, in the 128-byte
//      swizzle, into two rings of mbarriers (2 stages of W1, each with
//      b1's 64 floats beside it, zero past H; up to 4 stages of W2). There
//      is no producer warp: the last of the 8 warps to release a stage (a
//      count in shared memory) issues its refill, W1's after the chunk's
//      activation, W2's after its second product. b2 is staged once.
//    - Each consumer loads its (Tp x 64) tile of x once with plain loads
//      (16-byte vectors where C % 8 == 0, else element by element; rows
//      past T and channels past C are zeros), normalizes it with the
//      statistics (the _rn chain of the f32 kernel's stage_x) and stores
//      x^ in the 128-byte swizzle, token rows of 128 bytes: that is A of
//      the first product in wgmma's M-major (transposed) form.
//    - First product, per chunk: u (64 channels x 64 hidden) = x^T *
//      W1 chunk^T, Tp / 16 wgmma m64n64k16, A and B from shared memory.
//      + b1, the activation in f32, one cast to bf16, in registers: the
//      accumulator's fragment is the A operand of the next product as it
//      stands (as flash attention reuses P).
//    - Second product: y^T (64 channels x Tp) += a * W2 chunk^T, four
//      wgmma m64nTpk16 with A from registers; y^T stays in registers
//      across all chunks (Tp / 2 f32 a thread).
//    - Each warpgroup issues chunk k's second product and chunk k + 1's
//      first together and waits for both, then computes chunk k + 1's
//      activation. The two run in step; taking turns at the tensor cores
//      (ping-pong) was slower.
//    - Epilogue: the raw residual tile comes into the x^ tile's place once
//      the last first product has read it; + b2[t] and the residual in
//      f32, one cast, in place; then 16-byte stores, clipped at T and C.
//
// Design (f32), for checks only and off the main path: one launch on CUDA
// cores with FMA, never TF32. One block owns (image b, 64 channels): the
// LN statistics of the image's tokens taken by the block itself, the
// (T, 64) tile of x^ staged and normalized in shared memory, and for each
// chunk of 64 hidden units W1's and W2's chunks staged beside it, u and
// its activation, and y (T x 64) += W2 chunk * a^T held in registers.
//
// Binding: plain C entry points called through ctypes; each launches on
// the caller's stream and returns the cudaError_t of its launches. T <= 256.
// cuTensorMapEncodeTiled is a driver function and is reached through
// cudaGetDriverEntryPoint, so nothing links against libcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int CC = 64;          // channels a block (f32)
constexpr int HC = 64;          // hidden units a step
constexpr int kMaxTokens = 256;

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
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ---------------------------------------------------------------- bf16 --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts 2^24 polls (a load that never lands) traps, so that a fault ends
// the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0 along the rows, c1 across them) of `map` into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO). K-major (W1's and W2's chunks): a
// row holds 64 K values. M-major (x^, A of the first product, transposed
// in the instruction): a row holds the 64 channels of one token, the K
// index; its 64 values are one swizzle atom wide, so LBO is unused in both.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// a barrier of `count` threads (a multiple of 32) other than __syncthreads'
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (64 × 64, f32) += A (64 × 16, smem, M-major: the tokens' rows of x^) ·
// B (16 × 64, smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ta(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 × N, f32) += A (64 × 16, bf16, registers: each warp its 16 rows in
// mma.sync's m16n8k16 A layout) · B (16 × N, smem, K-major); N = Tp
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<208>(float (&d)[104], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kTokChannels = 128;  // channels a block: two consumer warpgroups of 64
constexpr int kTokHidden = 64;     // hidden units a chunk
// Two warpgroups and nothing else, so that ptxas may give each thread 255
// registers: yT alone is Tp / 2 of them. At 288 or 384 threads (a producer
// warp or warpgroup beside them) it compiled every thread to 168, with
// setmaxnreg or without, and serialized the products.
constexpr int kTokThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take (227 KB)
constexpr int kStatWarps = 8;

// The shared memory of the fused kernel at Tp = TP: both consumers' x^
// tiles (TP token rows of 64 channels, 128 bytes a row), then the two
// rings, W1's chunks (64 hidden rows in K blocks of 64 tokens; past Tp
// TMA fills zeros; kStages1 of them) and W2's (TP token rows of 64 hidden
// units; as many as fit, up to 4), b1's chunk for each of W1's stages (64
// floats, zeros past H; it comes with W1's chunk), then each stage's
// mbarrier and release count, and b2 (Tp floats, zeros past T). Every tile
// starts on 1024 bytes, the period of the swizzle.
template <int TP>
struct TokShape {
  static_assert(TP % 16 == 0 && TP <= kMaxTokens, "Tp: a multiple of 16 up to 256");
  static constexpr int kKBlocks = (TP + 63) / 64;
  static constexpr int kXBytes = TP * 128;
  static constexpr int kW1Bytes = kKBlocks * 64 * 128;
  static constexpr int kW2Bytes = TP * 128;
  static constexpr int kStages1 = 2;
  // each ring's barriers and counts, at most 4 stages
  static constexpr int kMetaBytes = 2 * 4 * (8 + 4);
  static constexpr int kFit2 =
      (kSmemLimit - 1024 - kMetaBytes - TP * 4 - 2 * kXBytes - kStages1 * (kW1Bytes + 256)) /
      kW2Bytes;
  static constexpr int kStages2 = kFit2 < 4 ? kFit2 : 4;
  static_assert(kStages2 >= 2, "two stages of W2's ring fit");
  static constexpr int kSmem = 1024 + 2 * kXBytes + kStages1 * kW1Bytes + kStages2 * kW2Bytes +
                               kStages1 * 256 + kMetaBytes + TP * 4;
  // the residual's rows in flight at a time (a divisor of TP / 16)
  static constexpr int kResGroup = TP / 16 <= 13 ? TP / 16 : TP / 32;
};

struct TokArgs {
  const bf16* x;          // (B, T, C)
  const float* b1;        // (H,)
  const float* b2;        // (T,)
  const bf16* residual;   // (B, T, C) or null
  const float* ln_w;      // (C,) or null: no prologue
  const float* ln_b;      // (C,)
  const float2* stats;    // (B·T,) mu and rstd, where ln_w
  bf16* out;              // (B, T, C)
  int t, c, h, chunks, act;
  bool vec;               // 16-byte loads and stores: C % 8 == 0, pointers aligned
};

// byte offset of the 16-byte chunk q (channels 8q .. 8q + 7) of token row t
// in a consumer's tile: TMA's 128-byte swizzle
__device__ __forceinline__ int tile_at(int t, int q) { return t * 128 + ((q ^ (t & 7)) << 4); }

// the LayerNorm of one value, each step rounded on its own
__device__ __forceinline__ float ln_apply(float v, float mu, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), w), b);
}

// mu and rstd of every row of x (rows × c) over its c values, one warp a
// row, in the arithmetic of the f32 kernel's token_stats: f32 sums of v and
// v·v (an FMA), mu = sum / C, var = E[x²] − mu², rstd = rsqrt(var + eps).
// VEC: C % 8 == 0 and x 16-byte aligned, 16-byte loads.
template <bool VEC>
__global__ void __launch_bounds__(32 * kStatWarps)
    token_stats_bf16_kernel(const bf16* __restrict__ x, float eps, float2* __restrict__ stats,
                            int64_t rows, int c) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kStatWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + row * c;
  float sum = 0.0f, sq = 0.0f;
  if (VEC) {
#pragma unroll 4
    for (int v = lane; v < c / 8; v += 32) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + v);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        sum += f;
        sq = fmaf(f, f, sq);
      }
    }
  } else {
    for (int i = lane; i < c; i += 32) {
      const float f = __bfloat162float(xr[i]);
      sum += f;
      sq = fmaf(f, f, sq);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  if (lane == 0) {
    const float mu = sum / static_cast<float>(c);
    const float var = __fsub_rn(sq / static_cast<float>(c), __fmul_rn(mu, mu));
    stats[row] = make_float2(mu, rsqrtf(__fadd_rn(var, eps)));
  }
}

// A consumer's tile of `src` (image rows row0 .., channels c0 .. c0 + 63),
// rows [0, TP), into `tile` in the swizzle: thread wl takes the 8 channels
// c0 + 8·(wl % 8) of rows wl / 8 + 16·i, GROUP rows' loads in flight at a
// time. With `ln` the values are normalized (the statistics of each row,
// ln_w and ln_b of each channel) and cast. Rows past T and channels past C
// are zeros.
template <int TP, int GROUP>
__device__ __forceinline__ void stage_tile(const TokArgs& p, const bf16* __restrict__ src,
                                           int64_t row0, int c0, unsigned char* tile, bool ln,
                                           int wl) {
  const int q = wl % 8, c = c0 + 8 * q;
  float w[8], b[8];
  if (ln) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = c + j < p.c ? p.ln_w[c + j] : 0.0f;
      b[j] = c + j < p.c ? p.ln_b[c + j] : 0.0f;
    }
  }
  static_assert((TP / 16) % GROUP == 0, "GROUP divides the rows a thread stages");
#pragma unroll
  for (int i0 = 0; i0 < TP / 16; i0 += GROUP) {
    uint4 v[GROUP];
    float2 s[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int t = wl / 8 + 16 * (i0 + i);
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      s[i] = make_float2(0.0f, 0.0f);
      if (t < p.t) {
        const bf16* row = src + (row0 + t) * p.c;
        if (p.vec) {
          if (c < p.c) v[i] = __ldg(reinterpret_cast<const uint4*>(row + c));
        } else {
          bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < p.c) e[j] = row[c + j];
          }
        }
        if (ln) s[i] = p.stats[row0 + t];
      }
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int t = wl / 8 + 16 * (i0 + i);
      if (ln && t < p.t) {
        bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          e[j] = __float2bfloat16_rn(
              c + j < p.c ? ln_apply(__bfloat162float(e[j]), s[i].x, s[i].y, w[j], b[j]) : 0.0f);
        }
      }
      *reinterpret_cast<uint4*>(tile + tile_at(t, q)) = v[i];
    }
  }
}

// a = bf16(act(u + b1)) as the A fragments of the second product: u's
// column blocks 2·ks and 2·ks + 1 (8 hidden units each) are k-step ks's,
// rows g and g + 8, in mma.sync's m16n8k16 A layout, so the accumulator's
// registers are the operand as they stand
template <int ACT>
__device__ __forceinline__ void hidden(const float (&u)[32], const float (&bias)[16],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j8 = 2 * ks + r / 2, i = 4 * j8 + 2 * (r % 2);
      __nv_bfloat162 h2 = __floats2bfloat162_rn(act_apply(ACT, __fadd_rn(u[i], bias[2 * j8])),
                                                act_apply(ACT, __fadd_rn(u[i + 1], bias[2 * j8 + 1])));
      a[ks][r] = *reinterpret_cast<uint32_t*>(&h2);
    }
  }
}

// Warp `lane`'s part in releasing stage s of a ring after its products have
// read chunk k there: the last of the 8 consumer warps to release it (its
// count's 8th arrival) refills it with chunk k + stages, by TMA. The fences
// order each warp's finished reads before the count and the count before
// the refill.
__device__ __forceinline__ bool last_release(uint32_t* count, int lane) {
  bool last = false;
  if (lane == 0) {
    __threadfence_block();
    last = atomicAdd(count, 1u) % 8 == 7;
    __threadfence_block();
  }
  return last;
}

// W1's chunk k into a stage, and b1's (64 floats) into the stage's slot
template <int TP>
__device__ __forceinline__ void load_w1(unsigned char* dst, const CUtensorMap* map, float* bias,
                                        const CUtensorMap* map_b1, int k, uint64_t* full) {
  mbar_expect_tx(full, TokShape<TP>::kW1Bytes + 256);
  for (int kb = 0; kb < TokShape<TP>::kKBlocks; ++kb) {
    tma_load(dst + kb * 8192, map, kb * 64, k * kTokHidden, full);
  }
  tma_load(bias, map_b1, k * kTokHidden, 0, full);
}

template <int TP>
__device__ __forceinline__ void load_w2(unsigned char* dst, const CUtensorMap* map, int k,
                                        uint64_t* full) {
  mbar_expect_tx(full, TokShape<TP>::kW2Bytes);
  tma_load(dst, map, k * kTokHidden, 0, full);
}

template <int TP>
__global__ void __launch_bounds__(kTokThreads, 1)
    token_mlp_bf16_kernel(const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2,
                          const __grid_constant__ CUtensorMap map_b1, TokArgs p) {
  using S = TokShape<TP>;
  constexpr int kS1 = S::kStages1, kS2 = S::kStages2;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from smem_raw, so that the compiler still knows
  // the tiles are shared memory (LDS and STS, not generic loads and stores)
  unsigned char* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sw1 = sx + 2 * S::kXBytes;    // kS1 W1 chunks
  unsigned char* sw2 = sw1 + kS1 * S::kW1Bytes;  // kS2 W2 chunks
  float* sb1 = reinterpret_cast<float*>(sw2 + kS2 * S::kW2Bytes);  // kS1 chunks of b1
  uint64_t* full1 = reinterpret_cast<uint64_t*>(sb1 + kS1 * kTokHidden);
  uint64_t* full2 = full1 + kS1;
  uint32_t* count1 = reinterpret_cast<uint32_t*>(full2 + kS2);
  uint32_t* count2 = count1 + kS1;
  float* sb2 = reinterpret_cast<float*>(count2 + 4);  // after count2's 4 slots
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Chunk k (hidden units 64k ..) sits in W1's stage k % kS1 at phase
  // (k / kS1) % 2 and in W2's stage k % kS2 at phase (k / kS2) % 2. Every
  // consumer warp reads every chunk, and a stage is refilled only once all
  // 8 have released it, so no warp runs a phase ahead of another.
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS1; ++s) {
      mbar_init(full1 + s, 1);
      count1[s] = 0;
    }
    for (int s = 0; s < kS2; ++s) {
      mbar_init(full2 + s, 1);
      count2[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kS1 && k < p.chunks; ++k) {
      load_w1<TP>(sw1 + k * S::kW1Bytes, &map_w1, sb1 + k * kTokHidden, &map_b1, k, full1 + k);
    }
    for (int k = 0; k < kS2 && k < p.chunks; ++k) load_w2<TP>(sw2 + k * S::kW2Bytes, &map_w2, k, full2 + k);
  }
  for (int t = threadIdx.x; t < TP; t += kTokThreads) sb2[t] = t < p.t ? p.b2[t] : 0.0f;
  __syncthreads();

  const int wg = warp / 4, wl = threadIdx.x % 128, wq = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = blockIdx.x * kTokChannels + wg * 64;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * p.t;
  unsigned char* tile = sx + wg * S::kXBytes;

  // x^ once: the first product's A, read through the generic proxy's
  // stores by wgmma (the async proxy)
  stage_tile<TP, TP / 16>(p, p.x, row0, c0, tile, p.ln_w != nullptr, wl);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg, 128);

  // y^T: y[4j + 2·h8 + e] is channel c0 + 16·wq + g + 8·h8, token 8j + 2·t4 + e
  float y[TP / 2];
#pragma unroll
  for (int e = 0; e < TP / 2; ++e) y[e] = 0.0f;
  const uint64_t da = smem_desc(tile);
  uint32_t a[4][4];

  // Chunk k's first product into u: u[4j + 2·h8 + e] is channel row
  // g + 8·h8, hidden unit 64k + 8j + 2·t4 + e. Always one commit, empty
  // past the last chunk, so that the waits below count alike every time.
  auto first = [&](int k, float(&u)[32]) {
    if (k < p.chunks) {
      const int s1 = k % kS1;
#pragma unroll
      for (int e = 0; e < 32; ++e) u[e] = 0.0f;
      mbar_wait(full1 + s1, (k / kS1) & 1);
      // the descriptors are made here, each just before its product:
      // hoisted out of the loop they would hold 2 registers each throughout
      uint64_t da_k = da;
      asm volatile("" : "+l"(da_k));
      wgmma_fence();
      const uint64_t db1 = smem_desc(sw1 + s1 * S::kW1Bytes);
#pragma unroll
      for (int j = 0; j < TP / 16; ++j) {
        // 16 token rows (2048 bytes) of x^ a step; W1's K block j / 4, + 32
        // bytes a step within it
        wgmma_m64n64k16_ta(u, da_k + 128 * j, db1 + 512 * (j / 4) + 2 * (j % 4));
      }
    }
    wgmma_commit();
  };
  // Chunk k's W1 stage and b1 slot have been read for the last time (its
  // first product has finished, its activation has read b1): release them.
  auto release_w1 = [&](int k) {
    const int s1 = k % kS1;
    if (last_release(count1 + s1, lane) && k + kS1 < p.chunks) {
      load_w1<TP>(sw1 + s1 * S::kW1Bytes, &map_w1, sb1 + s1 * kTokHidden, &map_b1, k + kS1,
                  full1 + s1);
    }
  };
  // Chunk k's hidden: a = bf16(act(u + b1)), b1 of this thread's 16 hidden
  // units from the slot that came with the chunk's W1
  auto activate = [&](int k, const float(&u)[32]) {
    const float* slot = sb1 + (k % kS1) * kTokHidden;
    float bias[16];
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const float2 b = *reinterpret_cast<const float2*>(slot + 8 * j8 + 2 * t4);
      bias[2 * j8] = b.x;
      bias[2 * j8 + 1] = b.y;
    }
    switch (p.act) {
      case kActGelu: hidden<kActGelu>(u, bias, a); break;
      case kActGeluTanh: hidden<kActGeluTanh>(u, bias, a); break;
      case kActQuickGelu: hidden<kActQuickGelu>(u, bias, a); break;
      case kActRelu: hidden<kActRelu>(u, bias, a); break;
      default: hidden<kActNone>(u, bias, a); break;
    }
  };
  // Chunk k's second product into y, a the A operand.
  auto second = [&](int k) {
    const int s2 = k % kS2;
    mbar_wait(full2 + s2, (k / kS2) & 1);
    wgmma_fence();
    uint64_t db2 = smem_desc(sw2 + s2 * S::kW2Bytes);
    asm volatile("" : "+l"(db2));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<TP>(y, a[ks], db2 + 2 * ks);  // + 32 bytes of K
    wgmma_commit();
  };
  // Chunk k's second product has finished: release its W2 stage.
  auto second_done = [&](int k) {
    const int s2 = k % kS2;
    if (last_release(count2 + s2, lane) && k + kS2 < p.chunks) {
      load_w2<TP>(sw2 + s2 * S::kW2Bytes, &map_w2, k + kS2, full2 + s2);
    }
  };
  // Chunk by chunk: the activation of chunk k, then its second product and
  // chunk k + 1's first issued together and awaited together. The two
  // warpgroups run in step (taking turns at the tensor cores, ping-pong,
  // was 23% slower: scripts/probe_torch_token_mlp.py). One u serves every
  // chunk: chunk k's activation has read it before chunk k + 1's first
  // product is issued into it.
  float u[32];
  first(0, u);
  wgmma_wait<0>();
  for (int k = 0; k < p.chunks; ++k) {
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_operand(u[e]);
    activate(k, u);
    release_w1(k);
    second(k);
    first(k + 1, u);
    if (k == p.chunks - 1) {
      // Every warp has waited for its last first product (in the last
      // iteration, or before the loop): the tile is free, and the
      // residual's raw tile takes its place while the last second product
      // runs.
      named_sync(1 + wg, 128);
      if (p.residual) stage_tile<TP, S::kResGroup>(p, p.residual, row0, c0, tile, false, wl);
    }
    wgmma_wait<0>();  // P2(k) and P1(k + 1)
    second_done(k);
  }

#pragma unroll
  for (int e = 0; e < TP / 2; ++e) fence_operand(y[e]);
  named_sync(1 + wg, 128);  // the residual's tile is in

  // + b2[t], + the residual in f32, one cast, in place in the tile: 16
  // tokens at a time, their residuals all loaded before any result is
  // stored (a store through the generic pointer keeps the compiler from
  // moving a later load above it)
  bf16* const cells = reinterpret_cast<bf16*>(tile);
#pragma unroll
  for (int j0 = 0; j0 < TP / 8; j0 += 2) {
    int at[2][2][2];
    float r[2][2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const int t = 8 * (j0 + jj) + 2 * t4 + e, cl = 16 * wq + g + 8 * h8;
          at[jj][e][h8] = tile_at(t, cl / 8) / 2 + cl % 8;
          r[jj][e][h8] = p.residual ? __bfloat162float(cells[at[jj][e][h8]]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bt = sb2[8 * (j0 + jj) + 2 * t4 + e];
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          float v = __fadd_rn(y[4 * (j0 + jj) + 2 * h8 + e], bt);
          if (p.residual) v = __fadd_rn(v, r[jj][e][h8]);
          cells[at[jj][e][h8]] = __float2bfloat16_rn(v);
        }
      }
    }
  }
  named_sync(1 + wg, 128);

  // the tile out, token rows past T and channels past C clipped
  const int q = wl % 8, c = c0 + 8 * q;
#pragma unroll 4
  for (int i = 0; i < TP / 16; ++i) {
    const int t = wl / 8 + 16 * i;
    if (t >= p.t) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + tile_at(t, q));
    bf16* dst = p.out + (row0 + t) * p.c + c;
    if (p.vec) {
      if (c < p.c) *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (c + jj < p.c) dst[jj] = e[jj];
      }
    }
  }
}

// ------------------------------------------------------------- the host --
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// the tensor map of a row-major (rows, cols) bf16 matrix, boxes of box_rows
// × 64 columns (128 bytes) in the 128-byte swizzle; loads zero-fill past
// the edges
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor map of the f32 vector b1 (h,) as one row, boxes of 64; loads
// zero-fill past H (the row stride is never used, and is a multiple of 16)
bool bias_map(CUtensorMap* map, const float* ptr, int h) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(h), 1};
  const cuuint64_t strides[1] = {(static_cast<cuuint64_t>(h) * sizeof(float) + 15) / 16 * 16};
  const cuuint32_t box[2] = {kTokHidden, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TP>
cudaError_t launch_fused(const void* w1p, const void* w2p, int hp, const TokArgs& p, int batch,
                         cudaStream_t s) {
  using Sh = TokShape<TP>;
  CUtensorMap m1, m2, mb1;
  if (!tensor_map(&m1, w1p, hp, TP, kTokHidden) || !tensor_map(&m2, w2p, TP, hp, TP) ||
      !bias_map(&mb1, p.b1, p.h)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      token_mlp_bf16_kernel<TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.c + kTokChannels - 1) / kTokChannels),
                  static_cast<unsigned>(batch));
  token_mlp_bf16_kernel<TP><<<grid, kTokThreads, Sh::kSmem, s>>>(m1, m2, mb1, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The f32 path. x, residual, out (B, T, C), w1 (H, T), w2 (T, H): f32,
// contiguous; b1 (H,), b2 (T,) f32; residual null for none (pass x itself
// for the raw pre-norm residual); ln_w/ln_b (C,) f32 or null (no
// prologue); act an activation.cuh code; T <= 256. One launch on the CUDA
// cores (bf16 runs token_stats_launch then token_mlp_bf16_launch). Returns
// the cudaError_t of the launch (0 on success). Argument checks (device,
// dtype, contiguity, shapes) are the Python wrapper's job.
extern "C" int token_mlp_f32_launch(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* residual,
                                    const void* ln_w, const void* ln_b, float eps, void* out,
                                    int batch, int t, int c, int h, int act, void* stream) {
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
  const int bytes = F32Layout(tp).total;
  return static_cast<int>(ln_w != nullptr
                              ? launch(token_mlp_f32_kernel<true>, grid, bytes, s, p, tp)
                              : launch(token_mlp_f32_kernel<false>, grid, bytes, s, p, tp));
}

// bf16 launch 1: stats (rows,) float2 = (mu, rstd) of each row of x (rows ×
// c, bf16, contiguous) over its c values. Returns the cudaError_t of the
// launch.
extern "C" int token_stats_launch(const void* x, float eps, void* stats, long long rows, int c,
                                  void* stream) {
  if (rows <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((rows + kStatWarps - 1) / kStatWarps);
  const auto kernel = c % 8 == 0 && aligned16(x) ? token_stats_bf16_kernel<true>
                                                 : token_stats_bf16_kernel<false>;
  kernel<<<blocks, 32 * kStatWarps, 0, s>>>(static_cast<const bf16*>(x), eps,
                                            static_cast<float2*>(stats), rows, c);
  return static_cast<int>(cudaGetLastError());
}

// bf16 launch 2, the fused MLP: x, residual, out (B, T, C) bf16, contiguous;
// w1p (hp, tp) and w2p (tp, hp) bf16, the packed weights (ops/mlp.py::
// pack_token_weights: zero past T and H) and b1 (H,) f32, 16-byte aligned
// (TMA reads them); b2 (T,) f32; residual null for none; ln_w/ln_b (C,)
// f32 and stats (B·T,) float2 from token_stats_launch, or all three null
// (no prologue); tp one of 64, 128, 208, 256 and at least T; hp a multiple
// of 64 and at least H; act an activation.cuh code. Returns the
// cudaError_t of the launch.
extern "C" int token_mlp_bf16_launch(const void* x, const void* w1p, const void* b1,
                                     const void* w2p, const void* b2, const void* residual,
                                     const void* ln_w, const void* ln_b, const void* stats,
                                     void* out, int batch, int t, int c, int h, int tp, int hp,
                                     int act, void* stream) {
  if (batch <= 0 || c <= 0) return 0;
  if (t <= 0 || t > tp || h <= 0 || hp < h || hp % kTokHidden != 0 || batch > 65535 ||
      act < kActNone || act > kActRelu || (ln_w != nullptr && (ln_b == nullptr || stats == nullptr)) ||
      !aligned16(w1p) || !aligned16(w2p) || !aligned16(b1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = c % 8 == 0 && aligned16(x) && aligned16(out) &&
                   (residual == nullptr || aligned16(residual));
  const TokArgs p{static_cast<const bf16*>(x), static_cast<const float*>(b1),
                  static_cast<const float*>(b2), static_cast<const bf16*>(residual),
                  static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                  static_cast<const float2*>(stats), static_cast<bf16*>(out),
                  t, c, h, hp / kTokHidden, act, vec};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tp) {
    case 64: return static_cast<int>(launch_fused<64>(w1p, w2p, hp, p, batch, s));
    case 128: return static_cast<int>(launch_fused<128>(w1p, w2p, hp, p, batch, s));
    case 208: return static_cast<int>(launch_fused<208>(w1p, w2p, hp, p, batch, s));
    case 256: return static_cast<int>(launch_fused<256>(w1p, w2p, hp, p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers a thread and shared memory a block of one kernel: which 0 = the
// bf16 statistics pass, 1-4 = the fused bf16 kernel at Tp 64, 128, 208,
// 256, 5 = the f32 kernel with the LN prologue; returns a cudaError_t
extern "C" int token_mlp_resources(int which, int* regs, int* smem_bytes) {
  const void* fns[] = {reinterpret_cast<const void*>(token_stats_bf16_kernel<true>),
                       reinterpret_cast<const void*>(token_mlp_bf16_kernel<64>),
                       reinterpret_cast<const void*>(token_mlp_bf16_kernel<128>),
                       reinterpret_cast<const void*>(token_mlp_bf16_kernel<208>),
                       reinterpret_cast<const void*>(token_mlp_bf16_kernel<256>),
                       reinterpret_cast<const void*>(token_mlp_f32_kernel<true>)};
  const int dynamic[] = {0, TokShape<64>::kSmem, TokShape<128>::kSmem, TokShape<208>::kSmem,
                         TokShape<256>::kSmem, 0};
  if (which < 0 || which > 5) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes) + dynamic[which];
  return 0;
}
