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
//   (ConvNeXt) and the activation epilogue, (b) fc2 with the bias,
//   ConvNeXt's layer-scale gamma and the residual (the raw pre-norm x, or
//   ConvNeXt's separate shortcut).
//
// For x (M, K) and W (N, K) in nn.Linear's (out, in) layout, both in the
// working type T (bf16 or f32):
//
//   a   = ln ? T((x - mu) * rsqrt(var + eps) * ln_w + ln_b) : x    per row
//         mu = E[x], var = E[x²] - mu², f32 statistics over all K
//   acc = a · Wᵀ                                     f32 accumulators
//   y   = act(acc + bias)                            (f32; activation.cuh)
//   y   = gamma ? y * gamma : y;  y = residual ? y + residual : y
//   out = T(y)                                       one cast
//
// which is the order of pallas_attention.py::_ln_f32 (:304-309) and of the
// epilogues of :415-421 and pallas_mlp.py:112-140 ((acc + b2)·gamma +
// shortcut, :80-86). One more epilogue form, bf16 only, serves the dense
// block (K12, dense_block.cu): kScaleRelu, out = T(relu(acc·scale + shift))
// per column, a folded BatchNorm then ReLU in the order of
// pallas_densenet.py::_block_kernel (:104), with scale in gamma's place
// and shift in bias's; no residual and no prologue. The activations are the four of pallas_mlp.py::_act_fn
// (gelu, gelu_tanh, quick_gelu, relu); gelu's erf is the TPU kernel's, the
// polynomial of Abramowitz & Stegun 7.1.26 (pallas_mlp.py:32-41, |error| ≤
// 1.5e-7), where the XLA reference and the plain version take the exact erf
// (activation.cuh says why).
//
// Bound: operations. At B = 128, ViT-B's fc1 is 119 GFLOP for 199 MB of
// input and output, 600 FLOP a byte: far above the H100's 295 in bf16, so
// the product has to run near the tensor cores' rate.
//
// Design (bf16), the shape of the hopper-kernels guide §1:
//
// - 128 × 128 output tiles, K in steps of 64 (128 bytes of bf16, one
//   swizzle row). A persistent grid of one block an SM walks the tiles
//   (N fastest, so the blocks at work share A's rows and all of W in L2).
// - A ring of 4 stages of (A, B) tiles, 32 KB a stage, in shared memory.
//   One producer thread (warp 8's first) keeps it full across tiles: it
//   waits for a stage to be free (its "empty" mbarrier), arms its "full"
//   mbarrier with the stage's 32,768 bytes and issues two TMA loads
//   (cp.async.bulk.tensor, 128-byte swizzle). The tensor maps are built on
//   the host for each call; TMA zero-fills what falls past M, N or K, so a
//   ragged edge needs no branch in the loop.
// - Two consumer warpgroups (warps 0-3 and 4-7) take the block's tiles in
//   turn, ping-pong: each holds a whole 128 × 128 f32 tile in registers
//   (two m64n128 halves), and while one runs its epilogue the other's
//   products keep the tensor cores busy; their products take turns in the
//   order of the tiles (a pair of mbarriers). Each stage is eight
//   wgmma.mma_async m64n128k16 (bf16 in, A and B read from shared memory
//   through descriptors whose 128-byte swizzle matches the TMA box). One
//   group stays in flight: a stage is released to the producer once the
//   group after it is issued and its own group has completed.
// - The epilogue works from the accumulator registers: + bias, the
//   activation, · gamma, + the residual in f32, one cast, into the
//   consumer's own bf16 staging in shared memory (two TMA boxes of 128 × 64
//   in the 128-byte swizzle), then two TMA stores, which clip at the ragged
//   M and N. The residual tile comes into that staging by TMA while the
//   products run. The epilogue has no branch, so the compiler interleaves
//   many elements' activations: with one warp a scheduler it is latency-
//   bound, and a branch a column kept GELU's cost about three times as
//   high. Every step but the activation is a _rn intrinsic (no contraction
//   into an FMA), in the plain version's order.
// - The LayerNorm prologue is a pass of its own before the product: TMA
//   cannot normalise, so one warp a row writes T(LN(x)) (f32 statistics,
//   _rn steps, the row held in registers) to a scratch buffer that the
//   wrapper allocates, and the product reads that. The reference casts LN
//   to T before its product too, so the numbers are the same; the pass
//   moves 2·M·K·2 bytes (77 MB at ViT-B's 25,216 × 768).
// - Registers: a consumer thread holds 128 accumulators and, in the
//   epilogue, enough activations in flight to keep its one warp a
//   scheduler issuing; setmaxnreg takes the producer warpgroup (one thread
//   of which issues the loads) down to 40 a thread and the consumers up to
//   232.
//
// Design (f32), for checks only and off the main path: CUDA-core FMA, never
// TF32: a 128×128 tile per block of 256 threads, 8×8 outputs a thread, K
// steps of 8, the LayerNorm applied to each A tile as it is staged.
//
// K must be a multiple of 8, and in bf16 N too: TMA needs 16-byte row
// strides (and the f32 kernel loads 16-byte vectors). M is any, and N in
// f32.
//
// The LayerNorm pass is also an entry of its own (layer_norm_launch, any K,
// either type): the token-mixing MLP (K10) runs it over C before its route
// over this product at more than 256 tokens (ops/mlp.py::token_mlp).
//
// Binding: plain C entry points (linear_fused_launch, layer_norm_launch,
// linear_fused_resources) called through ctypes; a launch runs on the
// caller's stream and returns the cudaError_t of the launch. The wrapper
// (ops/linear.py::gemm_plan) gives the boxes and the tiles; the launch
// refuses any that are not this file's. cuTensorMapEncodeTiled is a driver
// function and is reached through cudaGetDriverEntryPoint, so nothing links
// against libcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the dense block's epilogue form (bf16): not an activation of activation.cuh
constexpr int kScaleRelu = 5;

__device__ __forceinline__ float ln_apply(float v, float mu, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), w), b);
}

__device__ __forceinline__ float ln_rstd(float sum, float sq, int k, float eps, float* mu) {
  *mu = sum / static_cast<float>(k);
  const float var = __fsub_rn(sq / static_cast<float>(k), __fmul_rn(*mu, *mu));
  return rsqrtf(__fadd_rn(var, eps));
}


// ------------------------------------------------------ bf16 LN prologue --
constexpr int kLnWarps = 8;

// xn = T(LN(x)) row by row, one warp a row; K a multiple of 8. V > 0: the
// row (K ≤ 256·V) is loaded once into registers, all its loads in flight
// together; V = 0: any K, the row read twice.
template <int V>
__global__ void __launch_bounds__(32 * kLnWarps)
    layer_norm_bf16_kernel(const bf16* x, const float* ln_w, const float* ln_b, float eps,
                           bf16* xn, int64_t m, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const bf16* xr = x + row * k;
  bf16* outr = xn + row * k;
  constexpr int R = V > 0 ? V : 1;
  uint4 u[R];
  float sum = 0.0f, sq = 0.0f;
  auto accumulate = [&](const uint4& v) {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      sum += f;
      sq = fmaf(f, f, sq);
    }
  };
  if (V > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = (lane + 32 * i) * 8;
      u[i] = c < k ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) accumulate(u[i]);
  } else {
    for (int c = lane * 8; c < k; c += 256) accumulate(*reinterpret_cast<const uint4*>(xr + c));
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  float mu;
  const float rstd = ln_rstd(sum, sq, k, eps, &mu);
  auto apply = [&](uint4 v, int c) {  // ln_w, ln_b: 16-byte aligned
    bf16* e = reinterpret_cast<bf16*>(&v);
    const float4 w4[2] = {*reinterpret_cast<const float4*>(ln_w + c),
                          *reinterpret_cast<const float4*>(ln_w + c + 4)};
    const float4 b4[2] = {*reinterpret_cast<const float4*>(ln_b + c),
                          *reinterpret_cast<const float4*>(ln_b + c + 4)};
    const float* wv = reinterpret_cast<const float*>(w4);
    const float* bv = reinterpret_cast<const float*>(b4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e[j] = __float2bfloat16_rn(ln_apply(__bfloat162float(e[j]), mu, rstd, wv[j], bv[j]));
    }
    *reinterpret_cast<uint4*>(outr + c) = v;
  };
  if (V > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c < k) apply(u[i], c);
    }
  } else {
    for (int c = lane * 8; c < k; c += 256) apply(*reinterpret_cast<const uint4*>(xr + c), c);
  }
}

// xn = T(LN(x)) for any K and either type, one warp a row, the row read
// twice with scalar loads: the f32 pass, and the bf16 one where K % 8 != 0
// or a row is not on 16 bytes (the token MLP's route over the product,
// ops/mlp.py::token_mlp, normalizes over C before it transposes)
template <typename T>
__device__ __forceinline__ float ln_load(const T* p) { return static_cast<float>(*p); }
template <>
__device__ __forceinline__ float ln_load<bf16>(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void ln_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void ln_store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
    layer_norm_rows_kernel(const T* x, const float* ln_w, const float* ln_b, float eps, T* xn,
                           int64_t m, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + row * k;
  T* outr = xn + row * k;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < k; c += 32) {
    const float f = ln_load(xr + c);
    sum += f;
    sq = fmaf(f, f, sq);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  float mu;
  const float rstd = ln_rstd(sum, sq, k, eps, &mu);
  for (int c = lane; c < k; c += 32) {
    ln_store(outr + c, ln_apply(ln_load(xr + c), mu, rstd, ln_w[c], ln_b[c]));
  }
}

// the LN pass of either type into xn: the bf16 kernel that holds the row in
// registers where K % 8 == 0 and x, xn, ln_w, ln_b lie on 16 bytes, else
// the scalar one
cudaError_t layer_norm_pass(const void* x, const float* ln_w, const float* ln_b, float eps,
                            void* xn, int64_t m, int k, int dtype, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((m + kLnWarps - 1) / kLnWarps);
  const bool vec = k % 8 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xn) |
                                   reinterpret_cast<uintptr_t>(ln_w) |
                                   reinterpret_cast<uintptr_t>(ln_b)) % 16 == 0;
  if (dtype == 1 && vec) {
    const auto ln = k <= 256 ? layer_norm_bf16_kernel<1>
                  : k <= 512 ? layer_norm_bf16_kernel<2>
                  : k <= 1024 ? layer_norm_bf16_kernel<4>
                              : layer_norm_bf16_kernel<0>;
    ln<<<blocks, 32 * kLnWarps, 0, s>>>(static_cast<const bf16*>(x), ln_w, ln_b, eps,
                                        static_cast<bf16*>(xn), m, k);
  } else if (dtype == 1) {
    layer_norm_rows_kernel<bf16><<<blocks, 32 * kLnWarps, 0, s>>>(
        static_cast<const bf16*>(x), ln_w, ln_b, eps, static_cast<bf16*>(xn), m, k);
  } else {
    layer_norm_rows_kernel<float><<<blocks, 32 * kLnWarps, 0, s>>>(
        static_cast<const float*>(x), ln_w, ln_b, eps, static_cast<float*>(xn), m, k);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 GEMM --
constexpr int GM = 128, GN = 128, GK = 64;  // output tile and K step
constexpr int kStages = 4;                  // (A, B) tiles in the ring
constexpr int kConsumers = 2;               // warpgroups, each on its own tiles
// the consumers' warpgroups and the producer's (one thread of which issues
// the loads); setmaxnreg moves the producer's registers to the consumers
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "the register file holds the warpgroups' shares");
constexpr int kTileA = GM * GK, kTileB = GN * GK;  // elements
constexpr uint32_t kStageBytes = sizeof(bf16) * (kTileA + kTileB);
// a consumer's bf16 staging of its output tile (and of the residual tile),
// two TMA boxes of 128 × 64 in the 128-byte swizzle
constexpr size_t kEpiBytes = sizeof(bf16) * GM * GN;
// the ring, the two stagings, the ring's 2 × kStages mbarriers and the
// consumers' two each, and 1 KB to align the ring to the 1024 bytes of the
// swizzle pattern
constexpr size_t kGemmSmem = kStages * kStageBytes + kConsumers * kEpiBytes +
                             (2 * kStages + 2 * kConsumers) * sizeof(uint64_t) + 1024;
static_assert(kGemmSmem <= 227 * 1024, "the ring and stagings exceed an SM's shared memory");

struct GemmArgs {
  const float* bias;     // (N,)
  const bf16* residual;  // (M, N) or null
  const float* gamma;    // (N,) or null
  bf16* out;             // (M, N)
  int m, n, k;
  int tiles_n, tiles;    // output tiles along N, and in all
};

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

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0 along K, c1 along rows) of `map` into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO unused for this layout
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

// d (64 × 128, f32) += A (64 × 16, smem) · B (16 × 128, smem), both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// the output tile `tile` of a consumer: (row, column) of its corner
__device__ __forceinline__ int2 tile_origin(const GemmArgs& p, int tile) {
  return make_int2((tile / p.tiles_n) * GM, (tile % p.tiles_n) * GN);
}

// TMA store of the box at `src` to (c0 along N, c1 along rows) of `map`;
// TMA clips what falls past M or N
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// element (r, c) of an output staging: two boxes of 128 rows × 64 columns
// (128 bytes a row), each in TMA's 128-byte swizzle (16-byte chunk q of
// row r at chunk q ^ (r % 8))
__device__ __forceinline__ int staged(int r, int c) {
  return (c / 64) * (GM * 64) + r * 64 + ((((c % 64) / 8) ^ (r % 8)) * 8) + (c % 8);
}

// A consumer's epilogue of its tile, from the accumulator registers into
// the staging (which holds the residual tile where RES): y = act(acc +
// bias) · gamma (+ residual), f32, one cast; for kScaleRelu y = relu(acc ·
// gamma + bias), a separate instantiation, so that the other forms compile
// as they did. Branch-free, so that the compiler interleaves the
// activations of many elements: the columns past N of a ragged tile read
// the last bias and gamma (TMA clips them on the store), and a missing
// gamma multiplies by 1, which is exact.
template <int ACT, bool RES>
__device__ __forceinline__ void epilogue_tile(const GemmArgs& p, float (&acc)[2][GN / 2],
                                              bf16* stage, int n0, int lrow, int t4) {
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    const int cl = j * 8 + 2 * t4, c = min(n0 + cl, p.n - 2);  // N % 8 = 0: c even
    const float2 b = *reinterpret_cast<const float2*>(p.bias + c);
    const float2 gm = p.gamma ? *reinterpret_cast<const float2*>(p.gamma + c) : make_float2(1.0f, 1.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        __nv_bfloat162* slot =
            reinterpret_cast<__nv_bfloat162*>(stage + staged(h * 64 + lrow + 8 * h8, cl));
        const float a0 = acc[h][4 * j + 2 * h8], a1 = acc[h][4 * j + 2 * h8 + 1];
        float y0, y1;
        if constexpr (ACT == kScaleRelu) {
          y0 = fmaxf(__fadd_rn(__fmul_rn(a0, gm.x), b.x), 0.0f);
          y1 = fmaxf(__fadd_rn(__fmul_rn(a1, gm.y), b.y), 0.0f);
        } else {
          y0 = __fmul_rn(act_apply(ACT, __fadd_rn(a0, b.x)), gm.x);
          y1 = __fmul_rn(act_apply(ACT, __fadd_rn(a1, b.y)), gm.y);
        }
        if (RES) {
          const __nv_bfloat162 rv = *slot;
          y0 = __fadd_rn(y0, __bfloat162float(rv.x));
          y1 = __fadd_rn(y1, __bfloat162float(rv.y));
        }
        *slot = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_res,
                     const __grid_constant__ CUtensorMap map_out, GemmArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uintptr_t base = (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023};
  bf16* sA = reinterpret_cast<bf16*>(base);  // kStages × (GM × GK), swizzled
  bf16* sB = sA + kStages * kTileA;          // kStages × (GN × GK), swizzled
  bf16* sEpi = sB + kStages * kTileB;        // kConsumers × (GM × GN), swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(sEpi + kConsumers * GM * GN);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;    // turn[w]: consumer w may start its next products
  uint64_t* res_in = turn + kConsumers;  // res_in[w]: consumer w's residual tile is in
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = (p.k + GK - 1) / GK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // the 4 warps of the one consumer of a stage
    }
    for (int w = 0; w < kConsumers; ++w) {
      mbar_init(turn + w, 4);
      mbar_init(res_in + w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ...; its i-th tile goes
  // to consumer i % 2, and the k-th stage of that tile is the ring's
  // (i·ksteps + k)-th load: slot seq % kStages, phase (seq / kStages) % 2.
  if (warp >= 4 * kConsumers) {  // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      uint32_t seq = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int2 at = tile_origin(p, tile);
        for (int ks = 0; ks < ksteps; ++ks, ++seq) {
          const int s = seq % kStages;
          mbar_wait(empty + s, ((seq / kStages) & 1) ^ 1);  // a fresh barrier passes parity 1
          mbar_expect_tx(full + s, kStageBytes);
          tma_load(sA + s * kTileA, &map_a, ks * GK, at.x, full + s);
          tma_load(sB + s * kTileB, &map_b, ks * GK, at.y, full + s);
        }
      }
    }
    return;
  }

  // A consumer warpgroup takes every other tile of the block: while one
  // runs its epilogue the other's products keep the tensor cores busy. Their
  // products take turns, in the order of the tiles (consumer 1's t-th after
  // consumer 0's t-th, consumer 0's t-th after consumer 1's (t-1)-th), so
  // the ring is read in the order it is filled and no wait on a stage can
  // mistake a phase two uses old for the one it waits for.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, wl = threadIdx.x % 128;
  const int g = lane / 4, t4 = lane % 4, lrow = (warp % 4) * 16 + g;
  bf16* stage = sEpi + wg * GM * GN;
  int i = wg;
  uint32_t t = 0;  // this consumer's tiles so far
  for (int tile = blockIdx.x + wg * gridDim.x; tile < p.tiles;
       tile += kConsumers * gridDim.x, i += kConsumers, ++t) {
    const int2 at = tile_origin(p, tile);
    if (wl == 0) {
      // the staging is free once the last tile's stores have read it; then
      // the residual tile comes into it by TMA while the products run
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (p.residual) {
        mbar_expect_tx(res_in + wg, sizeof(bf16) * GM * GN);
        for (int b = 0; b < GN / 64; ++b)
          tma_load(stage + b * GM * 64, &map_res, at.y + b * 64, at.x, res_in + wg);
      }
    }
    // consumer 0 waits for phase t - 1 of its turn (a fresh barrier passes
    // parity 1), consumer 1 for phase t
    mbar_wait(turn + wg, (t & 1) ^ (wg == 0 ? 1 : 0));
    // two row halves of 64, each m64n128: acc[h] holds rows h·64 + lrow
    // and + 8, columns 8j + 2t and + 1 (4j .. 4j + 3)
    float acc[2][GN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < GN / 2; ++e) acc[h][e] = 0.0f;
    uint32_t seq = static_cast<uint32_t>(i) * ksteps;
    int prev = 0;
    for (int ks = 0; ks < ksteps; ++ks, ++seq) {
      const int s = seq % kStages;
      mbar_wait(full + s, (seq / kStages) & 1);
      wgmma_fence();
      const uint64_t db = smem_desc(sB + s * kTileB);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t da = smem_desc(sA + s * kTileA + h * 64 * GK);
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk) {
          wgmma_m64n128k16(acc[h], da + 2 * kk, db + 2 * kk);  // + 32 bytes along K
        }
      }
      wgmma_commit();
      // the other consumer's products may queue behind the last ones here
      if (ks == ksteps - 1 && lane == 0) mbar_arrive(turn + (1 - wg));
      wgmma_wait<1>();  // the previous stage's products are done
      if (ks > 0 && lane == 0) mbar_arrive(empty + prev);
      prev = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < GN / 2; ++e) fence_operand(acc[h][e]);

    // The epilogue from the registers: + bias, the activation, · gamma,
    // + the residual (from the staging) in f32, one cast, into the staging
    // in place; then TMA stores the tile.
    named_sync(1 + wg, 128);  // the staging is free (or holds the residual)
    if (p.residual) {
      mbar_wait(res_in + wg, t & 1);
      epilogue_tile<ACT, true>(p, acc, stage, at.y, lrow, t4);
    } else {
      epilogue_tile<ACT, false>(p, acc, stage, at.y, lrow, t4);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
    named_sync(1 + wg, 128);
    if (wl == 0) {
      for (int b = 0; b < GN / 64; ++b) tma_store(&map_out, stage + b * GM * 64, at.y + b * 64, at.x);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (wl == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- f32 --
constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128;
constexpr int FBK = 8, FLD = BM + 4;

struct Params {
  const float* x;         // (M, K)
  const float* w;         // (N, K)
  const float* bias;      // (N,)
  const float* residual;  // (M, N) or null
  const float* gamma;     // (N,) or null: no layer-scale
  const float* ln_w;      // (K,) or null: no prologue
  const float* ln_b;      // (K,)
  float eps;
  float* out;             // (M, N)
  int64_t m;
  int n, k, act;
};

// f32 mean and 1/sqrt(var + eps) of rows row0 .. row0 + BM - 1 over all K
__device__ void row_stats(const Params& p, int64_t row0, float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int64_t gr = row0 + r;
    float sum = 0.0f, sq = 0.0f;
    if (gr < p.m) {
      const float* row = p.x + gr * p.k;
      for (int c = lane; c < p.k; c += 32) {
        const float v = row[c];
        sum += v;
        sq = fmaf(v, v, sq);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) s_rstd[r] = ln_rstd(sum, sq, p.k, p.eps, &s_mu[r]);
  }
}

// one output element, act(acc + bias) · gamma + residual, every step but
// the activation a _rn one (out of line: the activation's code once, not
// 64 times)
__device__ __noinline__ void store_f32(const Params& p, int64_t idx, int c, float acc) {
  float y = act_apply(p.act, __fadd_rn(acc, p.bias[c]));
  if (p.gamma) y = __fmul_rn(y, p.gamma[c]);
  if (p.residual) y = __fadd_rn(y, p.residual[idx]);
  p.out[idx] = y;
}

template <bool LN>
__global__ void __launch_bounds__(kThreads) linear_f32_kernel(Params p) {
  __shared__ __align__(16) float sA[FBK][FLD];  // k-major: a column of A a row
  __shared__ __align__(16) float sB[FBK][FLD];
  __shared__ float s_mu[BM], s_rstd[BM];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;

  if (LN) {
    row_stats(p, row0, s_mu, s_rstd);
    __syncthreads();
  }

  // a tile is 128 rows × 8 values = 256 float4: one a thread
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  float4 ra, rb;
  auto load = [&](int k0) {
    const int64_t gr = row0 + lr;
    const int gn = col0 + lr;
    ra = gr < p.m ? *reinterpret_cast<const float4*>(p.x + gr * p.k + k0 + lk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = gn < p.n ? *reinterpret_cast<const float4*>(p.w + static_cast<int64_t>(gn) * p.k + k0 + lk)
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
      if (gc < p.n) store_f32(p, gr * p.n + gc, gc, acc[i][j]);
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

// the tensor map of a row-major (rows, k) bf16 matrix, boxes of box_rows ×
// box_k (box_k · 2 = 128 bytes) with the 128-byte swizzle; loads zero-fill
// past the edges, stores clip there
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int k, int box_k, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ACT>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mr,
                        const CUtensorMap& mo, const GemmArgs& g, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = g.tiles < sms ? g.tiles : sms;  // persistent: one block an SM
  gemm_bf16_kernel<ACT><<<blocks, kGemmThreads, kGemmSmem, s>>>(ma, mb, mr, mo, g);
  return cudaGetLastError();
}

cudaError_t dispatch_gemm(int act, const CUtensorMap& ma, const CUtensorMap& mb,
                          const CUtensorMap& mr, const CUtensorMap& mo, const GemmArgs& g,
                          cudaStream_t s) {
  switch (act) {
    case kActNone: return launch_gemm<kActNone>(ma, mb, mr, mo, g, s);
    case kActGelu: return launch_gemm<kActGelu>(ma, mb, mr, mo, g, s);
    case kActGeluTanh: return launch_gemm<kActGeluTanh>(ma, mb, mr, mo, g, s);
    case kActQuickGelu: return launch_gemm<kActQuickGelu>(ma, mb, mr, mo, g, s);
    case kActRelu: return launch_gemm<kActRelu>(ma, mb, mr, mo, g, s);
    case kScaleRelu: return launch_gemm<kScaleRelu>(ma, mb, mr, mo, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K), w (N, K), residual (M, N) or null, out (M, N): one type,
// contiguous, 16-byte aligned; bias (N,) f32; gamma (N,) f32 or null (no
// layer-scale); ln_w/ln_b (K,) f32 or null (no prologue); act an
// activation.cuh code, or kScaleRelu (5: bf16, gamma the scale, bias the
// shift, no residual or prologue); dtype 0 = f32, 1 = bf16; K (and, in bf16, N) a
// multiple of 8, for TMA's 16-byte rows. xn: an
// (M, K) bf16 scratch for the LayerNorm pass (bf16 with a prologue only).
// box_k × box_rows is the TMA box of A and W (64 × 128) and tiles_n ×
// tiles_m the 128 × 128 output tiles, as ops/linear.py::gemm_plan gives
// them; any other is refused. bf16 runs a persistent grid of one block an
// SM over the tiles, f32 one block a tile. Returns the cudaError_t of the
// launch (0 on success). Argument checks (device, dtype, contiguity,
// shapes) are the Python wrapper's job.
extern "C" int linear_fused_launch(const void* x, const void* w, const void* bias,
                                   const void* residual, const void* gamma, const void* ln_w,
                                   const void* ln_b, float eps, void* out, void* xn, long long m,
                                   int n, int k, int act, int dtype, int box_k, int box_rows,
                                   int tiles_n, int tiles_m, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (act == kScaleRelu && (dtype != 1 || gamma == nullptr || residual != nullptr ||
                            ln_w != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0 || k % 8 != 0 || act < kActNone || act > kScaleRelu || box_k != GK ||
      box_rows != GM || GM != BM || GN != BN || tiles_n != (n + GN - 1) / GN ||
      static_cast<long long>(tiles_m) != (m + GM - 1) / GM || tiles_m > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(tiles_m));
    Params p{static_cast<const float*>(x), static_cast<const float*>(w),
             static_cast<const float*>(bias), static_cast<const float*>(residual),
             static_cast<const float*>(gamma), static_cast<const float*>(ln_w),
             static_cast<const float*>(ln_b), eps, static_cast<float*>(out), m, n, k, act};
    if (ln_w != nullptr) linear_f32_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else linear_f32_kernel<false><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* a = x;
  if (ln_w != nullptr) {
    if (xn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        layer_norm_pass(x, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), eps,
                        xn, m, k, dtype, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    a = xn;
  }
  // A and W in K steps; the residual (or, standing in for none, the output)
  // and the output in boxes of 64 columns
  CUtensorMap ma, mb, mr, mo;
  if (!tensor_map(&ma, a, m, k, GK, GM) || !tensor_map(&mb, w, n, k, GK, GN) ||
      !tensor_map(&mr, residual ? residual : out, m, n, 64, GM) ||
      !tensor_map(&mo, out, m, n, 64, GM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemmArgs g{static_cast<const float*>(bias), static_cast<const bf16*>(residual),
                   static_cast<const float*>(gamma), static_cast<bf16*>(out),
                   static_cast<int>(m), n, k, tiles_n, tiles_n * tiles_m};
  return static_cast<int>(dispatch_gemm(act, ma, mb, mr, mo, g, s));
}

// xn = T(LN(x)) row by row for x, xn (M, K) of one type (dtype 0 = f32,
// 1 = bf16), ln_w/ln_b (K,) f32, any K: the LayerNorm pass on its own.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int layer_norm_launch(const void* x, const void* ln_w, const void* ln_b, float eps,
                                 void* xn, long long m, int k, int dtype, void* stream) {
  if (m <= 0) return 0;
  if (k <= 0 || (dtype != 0 && dtype != 1) || (m + kLnWarps - 1) / kLnWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(layer_norm_pass(x, static_cast<const float*>(ln_w),
                                          static_cast<const float*>(ln_b), eps, xn, m, k, dtype,
                                          static_cast<cudaStream_t>(stream)));
}

// registers a thread and dynamic shared memory a block of the product
// kernel of `dtype` (bf16: the GEMM with the exact GELU); returns a
// cudaError_t
extern "C" int linear_fused_resources(int dtype, int* regs, int* smem_bytes) {
  const void* fn = dtype == 1 ? reinterpret_cast<const void*>(gemm_bf16_kernel<kActGelu>)
                 : dtype == 0 ? reinterpret_cast<const void*>(linear_f32_kernel<true>)
                              : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(dtype == 1 ? kGemmSmem : attr.sharedSizeBytes);
  return 0;
}
