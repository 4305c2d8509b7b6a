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
//   p   = exp(s - max_row(s))                         f32
//   out = T((T(p) · v_h) / sum_row(p))                f32 accumulators, one cast
//
// (the JAX kernels and the plain version cast the normalised p instead:
// see "Rounding" below).
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
// Bound: bytes. At ViT-B's shape (B = 128, N = 197, 12 heads of 64) the
// core is 15 GFLOP for 116 MB of q, k, v and output, about 130 FLOP a byte,
// and a Swin window (N = 49, D = 32) about 25: both below the H100's ~295
// in bf16. So the design aims at keeping every key tile's loads and
// products short and many blocks in flight, not at the tensor cores' peak.
//
// Design (bf16). A block of 4 warps takes one (image or window, head) and 64
// query rows, 16 rows a warp, and walks the keys in tiles of 64, any N. Q
// sits in registers as mma.sync.m16n8k16 A fragments for the whole block.
// K and V tiles come through a two-slot cp.async ring in shared memory, a
// tile's load issued a step before it is used; 16-byte rows that fall past
// N or past the head width load as zeros. Scores and P never touch shared
// memory: they stay in the f32 accumulator fragments, and P·V takes its A
// fragment straight from them (the FlashAttention-2 layout). The softmax is
// online, in one pass: each tile's new row max rescales the running sum
// and output, and O accumulates in registers until one division at the
// end. Shared memory is Q + 2 × (K + V), 46 KB at D = 64; the registers
// are capped so that four blocks share an SM there.
//
// The softmax's own instructions (not the products) are what a memory-bound
// core spends its issue slots on, so each score costs a few: exp is one
// ex2.approx of s·log2e - m·log2e (its 2^-22 relative error is far below
// the bf16 rounding of p that follows), a tile that lies wholly below N
// takes no per-score mask, groups of 16 keys past N are skipped in both
// products, and a warp whose 16 rows lie past N only loads.
//
// Rounding. The reference casts the normalised p to bf16; a one-pass
// softmax casts the unnormalised exp(s - m_running) and divides at the end.
// Keeping the reference's rounding point takes two passes over the key
// tiles (the row max and sum first, then the normalised p), about 1.5× the
// time; the one-pass form's outputs stay within one bf16 ulp of max|ref|
// of the plain version on every shape chip_smoke.py checks (PERF.md §6
// gives the largest errors), so it is the one taken.
//
// Keys past N are -inf before the max and give p = 0; query rows past N are
// computed on zeros, read no bias or mask, and are never stored. The head
// width D is a template parameter, 32, 64 or 128; a narrower D that is a
// multiple of 8 (80, say) is zero-padded to the next one as it loads,
// which adds exact zeros to Q·Kᵀ, and the padded output columns are never
// stored.
//
// f32, for checks only and not tuned: CUDA-core FMA, never TF32; 8 warps of
// 8 query rows, the same key tiles, two passes (the row max and sum, then
// the normalised p, the reference's rounding point), one tile of K (row
// pitch D + 1, so a warp's 32 keys fall in 32 banks), V and P in shared
// memory.
//
// Q, K and V are read through a token stride and a batch stride, the head at
// column h·D: K8 and K9 pass (B, N, H, D) tensors, K6 the packed (B, N, 3,
// H, D) output of its q/k/v product with no copy. The output is (B, N, H, D).
//
// Binding: a plain C entry point (attention_core_launch) called through
// ctypes; it launches on the caller's stream and returns the cudaError_t of
// the launch. The Python wrapper (ops/attention.py::core_plan) picks the
// padded head width and the number of query blocks.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;   // query rows a block
constexpr int BKV = 64;  // keys a tile (bf16)
constexpr int FKV = 64;  // keys a tile (f32)
constexpr int kWarps = 4, kThreads = 32 * kWarps;  // bf16: 16 query rows a warp
constexpr int kF32Threads = 256;                   // f32: 8 query rows a warp
constexpr int kAhead = 1;                          // steps a tile's load is issued ahead
constexpr int kSlots = kAhead + 1;                 // K (and V) tiles in the ring
static_assert(BQ == BKV, "Q loads as one tile");

// bf16 blocks an SM the registers are capped for: at D = 64 four (128
// registers; ptxas takes 150 uncapped, which fits three), elsewhere as ptxas
// takes them (D = 32 fits four as it is, D = 128 needs its 220)
__host__ __device__ constexpr int blocks_per_sm(int dp) { return dp == 64 ? 4 : 1; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* bias;  // (H, N, N) or null
  const float* mask;  // (nW, N, N) or null
  int n, d, heads, num_windows;
  long long tok_in, batch_in, tok_out, batch_out;
  float q_scale, s_scale;
};

// shared memory of the bf16 kernel at padded head width dp: Q and a ring of
// kSlots K and kSlots V tiles, rows of dp + 8 values (16 bytes apart mod
// 128, so ldmatrix's eight rows fall in distinct banks)
__host__ __device__ constexpr size_t bf16_smem(int dp) {
  return sizeof(bf16) * static_cast<size_t>(BQ + 2 * kSlots * BKV) * (dp + 8);
}

// shared memory of the f32 kernel: Q, one K tile (pitch dp + 1), one V tile
// and the P tile
__host__ __device__ constexpr size_t f32_smem(int dp) {
  return sizeof(float) * static_cast<size_t>(BQ * dp + FKV * (dp + 1) + FKV * dp + BQ * FKV);
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

// one score as the reference forms it, from the raw f32 product: the scale,
// K6's rounding, then the bias and mask of (query row, key col); -inf for a
// key past N; rows past N read no plane
template <bool ROUND>
__device__ __forceinline__ float finish_score(float raw, int row, int col, int n, float s_scale,
                                              const Where& at) {
  if (col >= n) return -INFINITY;
  float x = raw * s_scale;
  if (ROUND) x = __bfloat162float(__float2bfloat16_rn(x));
  if (row < n) {
    const int64_t off = static_cast<int64_t>(row) * n + col;
    if (at.bias) x += at.bias[off];
    if (at.mask) x += at.mask[off];
  }
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zeros where !in (src unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a · b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// load rows row0 .. row0 + 63 (token stride tok) of a head's (N, d) slab
// into a (64, dp) tile of pitch dp + 8; zeros past N and past d
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n, int d,
                                          long long tok) {
  constexpr int VEC = DP / 8, LD = DP + 8;
  for (int i = threadIdx.x; i < BKV * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8, t = row0 + r;
    const bool in = t < n && c < d;
    cp16(dst + r * LD + c, in ? src + t * tok + c : src, in);
  }
}

template <int DP, bool ROUND>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(DP)) attention_bf16_kernel(Args a) {
  constexpr int LD = DP + 8, TILE = BKV * LD, KD = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // BQ × LD
  bf16* sK = sQ + BQ * LD;                   // kSlots tiles
  bf16* sV = sK + kSlots * TILE;             // kSlots tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n = a.n, d = a.d;
  const Where at(a);
  const int q0 = blockIdx.y * BQ;
  const int nt = (n + BKV - 1) / BKV;  // key tiles
  const int64_t head = static_cast<int64_t>(at.b) * a.batch_in + static_cast<int64_t>(at.h) * d;
  const bf16* qg = static_cast<const bf16*>(a.q) + head;
  const bf16* kg = static_cast<const bf16*>(a.k) + head;
  const bf16* vg = static_cast<const bf16*>(a.v) + head;

  // Step j takes key tile j, its K and V loaded kAhead steps before it, one
  // cp.async group a step, into slot j % kSlots of a ring; the load that
  // next takes a slot is issued only after the step that read it has passed
  // its closing barrier.
  auto issue = [&](int j) {
    if (j < nt) {
      load_tile<DP>(sK + (j % kSlots) * TILE, kg, j * BKV, n, d, a.tok_in);
      load_tile<DP>(sV + (j % kSlots) * TILE, vg, j * BKV, n, d, a.tok_in);
    }
    cp_commit();
  };

  // Q with step 0's group; q_scale ≠ 1 (K6) scales and rounds it in place
  load_tile<DP>(sQ, qg, q0, n, d, a.tok_in);
  for (int j = 0; j < kAhead; ++j) issue(j);

  uint32_t qf[KD][4];
  float s[BKV / 8][4];
  float o[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  // per row (rw and rw + 8): the running max m and this thread's part of
  // the running sum l, both rescaled as m grows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int rw = q0 + warp * 16 + g;
  // a warp whose 16 rows all lie past N only loads and waits
  const bool live = q0 + warp * 16 < n;
  const bool planes = at.bias != nullptr || at.mask != nullptr;

  for (int j = 0; j < nt; ++j) {
    issue(j + kAhead);
    cp_wait<kAhead>();
    __syncthreads();
    if (j == 0 && a.q_scale != 1.0f) {
      for (int i = tid; i < BQ * (DP / 8); i += kThreads) {
        bf16* e = sQ + (i / (DP / 8)) * LD + (i % (DP / 8)) * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c) e[c] = __float2bfloat16_rn(__bfloat162float(e[c]) * a.q_scale);
      }
      __syncthreads();
    }
    const int key0 = j * BKV;
    if (live) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[kk], sQ + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
      // s = Q · Kᵀ over this tile: 8 n8 tiles of keys, two per ldmatrix;
      // groups of 16 keys past N are skipped (their scores become -inf)
      const bf16* kt = sK + (j % kSlots) * TILE;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < BKV / 16; ++jj) {
        if (key0 + jj * 16 >= n) continue;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, kt + (jj * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8);
          mma(s[2 * jj], qf[kk], b[0], b[1]);
          mma(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }
      }
      if (!ROUND && !planes && key0 + BKV <= n) {
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] *= a.s_scale;
      } else {
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
          const int col = key0 + i * 8 + 2 * t4;
          s[i][0] = finish_score<ROUND>(s[i][0], rw, col, n, a.s_scale, at);
          s[i][1] = finish_score<ROUND>(s[i][1], rw, col + 1, n, a.s_scale, at);
          s[i][2] = finish_score<ROUND>(s[i][2], rw + 8, col, n, a.s_scale, at);
          s[i][3] = finish_score<ROUND>(s[i][3], rw + 8, col + 1, n, a.s_scale, at);
        }
      }
      // the online softmax of each row (rw: h = 0, rw + 8: h = 1): the new
      // row max (over the 4 lanes of a row), the old sum and output
      // rescaled to it, p = exp(s - m) in f32 in place of s
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * h], s[i][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx), ml = mn * kLog2e;
        const float alpha = ex2((m[h] - mn) * kLog2e);
        m[h] = mn;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
          s[i][2 * h] = ex2(fmaf(s[i][2 * h], kLog2e, -ml));
          s[i][2 * h + 1] = ex2(fmaf(s[i][2 * h + 1], kLog2e, -ml));
          sum += s[i][2 * h] + s[i][2 * h + 1];
        }
        l[h] = l[h] * alpha + sum;
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          o[i][2 * h] *= alpha;
          o[i][2 * h + 1] *= alpha;
        }
      }
      // o += T(p) · V for each 16 keys that hold one below N
      const bf16* vt = sV + (j % kSlots) * TILE;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        if (key0 + kk * 16 >= n) continue;
        const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < DP / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dd * 16 +
                           (lane / 16) * 8);
          mma(o[2 * dd], pf, b[0], b[1]);
          mma(o[2 * dd + 1], pf, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // out = T(o / l), l summed over the 4 lanes of a row
  bf16* og = static_cast<bf16*>(a.out) + static_cast<int64_t>(at.b) * a.batch_out +
             static_cast<int64_t>(at.h) * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / sum;
    const int row = rw + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(og + row * a.tok_out + col) =
            pack_bf16(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads) attention_f32_kernel(Args a) {
  constexpr int DL = DP / 32;  // output columns a lane
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                   // BQ × DP
  float* sK = sQ + BQ * DP;          // FKV × (DP + 1)
  float* sV = sK + FKV * (DP + 1);   // FKV × DP
  float* sP = sV + FKV * DP;         // BQ × FKV
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n, d = a.d;
  const Where at(a);
  const int q0 = blockIdx.y * BQ, r0 = warp * 8;  // this warp's rows r0 .. r0 + 7
  const int nt = (n + FKV - 1) / FKV;
  const int64_t head = static_cast<int64_t>(at.b) * a.batch_in + static_cast<int64_t>(at.h) * d;
  const float* qg = static_cast<const float*>(a.q) + head;
  const float* kg = static_cast<const float*>(a.k) + head;
  const float* vg = static_cast<const float*>(a.v) + head;

  for (int i = tid; i < BQ * DP; i += kF32Threads) {
    const int r = i / DP, c = i % DP, t = q0 + r;
    sQ[i] = t < n && c < d ? qg[t * a.tok_in + c] * a.q_scale : 0.0f;
  }
  float m[8], l[8], o[8][DL];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) o[i][c] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < nt; ++kt) {
      const int key0 = kt * FKV;
      __syncthreads();  // the previous tile is consumed (and sQ written)
      for (int i = tid; i < FKV * DP; i += kF32Threads) {
        const int r = i / DP, c = i % DP, t = key0 + r;
        const bool in = t < n && c < d;
        sK[r * (DP + 1) + c] = in ? kg[t * a.tok_in + c] : 0.0f;
        if (pass == 1) sV[i] = in ? vg[t * a.tok_in + c] : 0.0f;
      }
      __syncthreads();
      // scores of rows r0 .. r0 + 7 at keys lane and lane + 32
      float sc[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = 0.0f;
      for (int dd = 0; dd < d; ++dd) {
        const float k0 = sK[lane * (DP + 1) + dd], k1 = sK[(lane + 32) * (DP + 1) + dd];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float qv = sQ[(r0 + i) * DP + dd];
          sc[i][0] = fmaf(qv, k0, sc[i][0]);
          sc[i][1] = fmaf(qv, k1, sc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = q0 + r0 + i;
        const float x0 = finish_score<false>(sc[i][0], row, key0 + lane, n, a.s_scale, at);
        const float x1 = finish_score<false>(sc[i][1], row, key0 + lane + 32, n, a.s_scale, at);
        if (pass == 0) {
          const float mn = fmaxf(m[i], warp_max(fmaxf(x0, x1)));
          l[i] = l[i] * expf(m[i] - mn) + warp_sum(expf(x0 - mn) + expf(x1 - mn));
          m[i] = mn;
        } else {
          sP[(r0 + i) * FKV + lane] = expf(x0 - m[i]) / l[i];
          sP[(r0 + i) * FKV + lane + 32] = expf(x1 - m[i]) / l[i];
        }
      }
      if (pass == 1) {
        __syncwarp();
        for (int j = 0; j < FKV; ++j) {
          float vv[DL];
#pragma unroll
          for (int c = 0; c < DL; ++c) vv[c] = sV[j * DP + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float pv = sP[(r0 + i) * FKV + j];
#pragma unroll
            for (int c = 0; c < DL; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
          }
        }
      }
    }
  }
  float* og = static_cast<float*>(a.out) + static_cast<int64_t>(at.b) * a.batch_out +
              static_cast<int64_t>(at.h) * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + r0 + i;
    if (t >= n) continue;
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) og[t * a.tok_out + col] = o[i][c];
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t bytes, cudaStream_t s, const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch(const Args& a, dim3 grid, int round_scores, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    return round_scores
               ? launch(attention_bf16_kernel<DP, true>, grid, kThreads, bf16_smem(DP), s, a)
               : launch(attention_bf16_kernel<DP, false>, grid, kThreads, bf16_smem(DP), s, a);
  }
  if (dtype == 0) return launch(attention_f32_kernel<DP>, grid, kF32Threads, f32_smem(DP), s, a);
  return cudaErrorInvalidValue;
}

// the kernel that (dp, dtype, round_scores) selects, or null
const void* kernel_of(int dp, int dtype, int round_scores) {
#define ATTN_PICK(DP)                                                                           \
  if (dp == DP) {                                                                               \
    if (dtype == 0) return reinterpret_cast<const void*>(attention_f32_kernel<DP>);             \
    return round_scores ? reinterpret_cast<const void*>(attention_bf16_kernel<DP, true>)        \
                        : reinterpret_cast<const void*>(attention_bf16_kernel<DP, false>);      \
  }
  ATTN_PICK(32)
  ATTN_PICK(64)
  ATTN_PICK(128)
#undef ATTN_PICK
  return nullptr;
}

}  // namespace

// q, k, v: element (b, t, h, c) at b·batch_in + t·tok_in + h·head_dim + c;
// out: b·batch_out + t·tok_out + h·head_dim + c; one type (dtype 0 = f32,
// 1 = bf16), 16-byte aligned rows; any n ≥ 1; head_dim a multiple of 8 up
// to head_dim_padded, which is 32, 64 or 128 (the smallest that holds it);
// query_tiles = ceil(n / 64), the grid's second axis (both as
// ops/attention.py::core_plan gives them; any other is refused).
// bias (heads, n, n) f32 or null; mask (num_windows, n, n) f32 or null,
// window b taking plane b % num_windows. q is scaled by q_scale (and, in
// bf16, rounded) before the product, the scores by s_scale after it;
// round_scores = 1 rounds the scores to the working type before the bias
// (K6's definition). Returns the cudaError_t of the launch (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k, const void* v, void* out,
                                     const void* bias, const void* mask, int batch, int n,
                                     int heads, int head_dim, int head_dim_padded,
                                     int query_tiles, int num_windows, long long tok_in,
                                     long long batch_in, long long tok_out, long long batch_out,
                                     float q_scale, float s_scale, int round_scores, int dtype,
                                     void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int dp = head_dim_padded;
  if (heads <= 0 || num_windows <= 0 || head_dim <= 0 || head_dim % 8 || head_dim > dp ||
      (dp > 32 && head_dim <= dp / 2) || kernel_of(dp, dtype, round_scores) == nullptr ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL || query_tiles != (n + BQ - 1) / BQ ||
      query_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, static_cast<const float*>(bias), static_cast<const float*>(mask),
               n, head_dim, heads, num_windows, tok_in, batch_in, tok_out, batch_out,
               q_scale, s_scale};
  const dim3 grid(static_cast<unsigned>(batch * heads), static_cast<unsigned>(query_tiles));
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dp == 32) err = dispatch<32>(a, grid, round_scores, dtype, s);
  if (dp == 64) err = dispatch<64>(a, grid, round_scores, dtype, s);
  if (dp == 128) err = dispatch<128>(a, grid, round_scores, dtype, s);
  return static_cast<int>(err);
}

// registers a thread and dynamic shared memory a block of the kernel that
// (head_dim_padded, dtype, round_scores) selects; returns a cudaError_t
extern "C" int attention_core_resources(int head_dim_padded, int dtype, int round_scores,
                                        int* regs, int* smem_bytes) {
  const void* fn = kernel_of(head_dim_padded, dtype, round_scores);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(dtype == 0 ? f32_smem(head_dim_padded)
                                            : bf16_smem(head_dim_padded));
  return 0;
}
