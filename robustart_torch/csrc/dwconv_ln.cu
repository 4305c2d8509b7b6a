// ConvNeXt's depthwise 7×7 convolution + bias + LayerNorm, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_convnext.py::dwconv_ln_pallas (K11, the
// Pallas TPU kernel, pl.pallas_call at :84; kernel body :57-75). For x
// (N, H, W, C) NHWC in the working type T (bf16 or f32), per pixel:
//
//   y   = sum over the 49 taps of x[i + di - 3, j + dj - 3, c] · w[c, di, dj]
//         (f32, zero padding of 3) + b[c]
//   mu  = mean_c(y);  var = mean_c((y - mu)²)          two passes, as :71-72
//   out = T((y - mu) · rsqrt(var + eps) · gamma + beta)
//
// with f32 weights, bias, gamma and beta (the Pallas kernel casts its
// parameters to f32 and accumulates in f32; the JAX package's XLA reference
// instead rounds the convolution's output to x's type, pallas_convnext.py:
// 43-49, which this kernel does not follow). The weights are read in
// nn.Conv2d's (C, 1, 7, 7) layout, a channel's 49 taps contiguous.
//
// Bound: the f32 FMAs. At ConvNeXt-B's first stage (128 × 56 × 56 × 128)
// the taps that land inside the image are 2.4 G multiply-adds for 205 MB in
// bf16, about 23 FLOP a byte, above the 20 the H100's CUDA cores do per
// byte of device memory (67 TFLOP/s f32 over 3.35 TB/s). So the design
// spends its instruction slots on FMAs and keeps loads, conversions and the
// LayerNorm's reductions few beside them.
//
// Design. A block owns one image, a band of output rows (at most 28, even),
// a tile of 7·G output columns and the channels of a pixel: all C where
// C ≤ 512, else half of them, the two halves in the two blocks of a cluster
// that add their LayerNorm sums through distributed shared memory. A
// thread owns two neighbouring channels (a bf16x2 word, or a float2) of one
// column group g < G and computes a 2 × 7 patch of output pixels (two rows,
// seven columns) at a time:
//
// - Staging. The band's input rows with their 3-row and 3-column halos come
//   once each from device memory by TMA over a 4-D tensor map of (C, W, H,
//   N), whose out-of-bounds fill is the zero padding, into a ring of 10 rows
//   in shared memory (8 where the f32 ring would not fit), laid out
//   [256-byte box of channels][column][channels]: a warp's 32 pairs of one
//   column are 128 contiguous bytes, and a thread's 13 window columns are a
//   box apart (loads at immediate offsets). Lane 0 of each warp issues its
//   share of a row's boxes; the rows of the patch after next are in flight
//   while one is computed; rows outside the image are neither loaded nor
//   read. The k-th row a slot takes completes its mbarrier's phase k.
// - Convolution. The thread's 49 × 2 weights sit in registers, read once a
//   block from nn.Conv2d's layout through the ring's space. Each of the
//   patch's 8 input rows is read once from shared memory, 13 words, each
//   used for up to 7 × 2 outputs of each channel: 104 loads for 1,372 FMAs
//   a patch (one load per 13 FMAs).
// - LayerNorm. The 14 pixel sums (padded to 16) are reduced over the 16 or
//   32 lanes of a warp that hold one column group by a transposing
//   butterfly (15 or 16 shuffles for 16 pixels, each lane ending with one
//   pixel), the lane groups' partials meet in shared memory after a block
//   barrier, and each lane's pixel total (where the channels are split,
//   its block's sum pushed into the peer's shared memory with st.async on
//   the peer's mbarrier, the two added in rank order) goes back to its
//   lanes through shared memory. The second pass works on the
//   register-held accumulators (y − mu) and reads nothing again. Two
//   barriers a patch; the ring's loads are issued between them.
//
// The accumulation order is di-outer within a row pair (the Pallas kernel's
// is dj-outer): the two differ by f32 rounding only. The arithmetic of the
// plan (cluster, band, groups, tiles, ring, boxes, shared bytes, grid) is
// robustart_torch/ops/convnext.py::dwconv_plan, which the wrapper passes in.
//
// Binding: a plain C entry point (dwconv_ln_launch) called through ctypes;
// it launches on the caller's stream and returns the cudaError_t of the
// launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kS = 7;        // output columns a thread holds
constexpr int kRows = 2;     // output rows a thread holds
constexpr int kPix = 16;     // kRows · kS = 14 pixels, padded to 16 for the butterfly
constexpr int kThreads = 256;
constexpr int kBox = 256;    // bytes of channels a TMA box holds at one column
constexpr int kMaxSmem = 232448;  // bytes a block may have on sm_90

// a staged pair of channels: bf16x2 as one 32-bit word (channel c in the low
// half), f32 as a float2
template <int kBf16> struct Pair;
template <> struct Pair<1> {
  using T = bf16;
  using word = uint32_t;
  static __device__ __forceinline__ float2 load(const word* p) {
    const uint32_t v = *p;
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ void store(T* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <> struct Pair<0> {
  using T = float;
  using word = float2;
  static __device__ __forceinline__ float2 load(const word* p) { return *p; }
  static __device__ __forceinline__ void store(T* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

struct Args {
  const float* w;      // (C, 1, 7, 7)
  const float* b;      // (C,)
  const float* gamma;  // (C,)
  const float* beta;   // (C,)
  void* out;           // (N, H, W, C) T
  int n, h, w_, c;
  int c0;       // channels of a cluster's first block; the second takes c − c0
  int pairs;    // channel pairs of a column group's threads (c0 / 2)
  int lanes;    // lanes of a warp that hold one column group's pixels (16 or 32)
  int groups;   // G: column groups of 7 outputs a block
  int tiles;    // column tiles of 7·G outputs
  int band;     // output rows a block (even)
  int bands;
  int cluster;  // blocks that share a pixel's channels (1 or 2)
  int ring;     // staged input rows (8 or 10)
  int boxes;    // TMA boxes of kBox bytes of channels a staged row: c0 · size / kBox, rounded up
  float eps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
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

// TMA: the box at (channel, column, row, image) of `map` into `dst`; what
// lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int ch, int col,
                                         int row, int img, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ch), "r"(col), "r"(row), "r"(img),
      "r"(smem_u32(bar))
      : "memory");
}

// the address in the shared memory of the cluster's block `rank` of what
// `p` addresses in this block's
__device__ __forceinline__ uint32_t peer_u32(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// v into the peer block's shared memory at `dst`, counted on its mbarrier
// `bar` (both cluster addresses) as 4 bytes of its transaction
__device__ __forceinline__ void push_to_peer(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// one step of the transposing butterfly: of the 2n values, the lanes whose
// `mask` bit is clear keep the first n and send the last n, the others the
// reverse; each adds what its partner sent to what it kept
template <int kN>
__device__ __forceinline__ void scatter(float (&v)[kPix], unsigned wmask, int mask, bool upper) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float send = upper ? v[k] : v[k + kN];
    const float keep = upper ? v[k + kN] : v[k];
    v[k] = keep + __shfl_xor_sync(wmask, send, mask);
  }
}

template <int kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    dwconv_ln_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  using P = Pair<kBf16>;
  using T = typename P::T;
  using word = typename P::word;
  constexpr int kBoxPairs = kBox / static_cast<int>(sizeof(word));  // channel pairs a box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);

  const int K = a.cluster, H = a.h, W = a.w_, C = a.c, G = a.groups;
  int bx = blockIdx.x;
  const int rank = bx % K;
  bx /= K;
  const int tile = bx % a.tiles;
  bx /= a.tiles;
  const int band = bx % a.bands;
  const int img = bx / a.bands;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / a.pairs, cp = tid % a.pairs;
  const int own_pairs = (rank == 0 ? a.c0 : C - a.c0) / 2;
  const bool active = cp < own_pairs;  // the cluster's second block may hold fewer channels
  const int cstart = rank * a.c0;
  const int c = cstart + 2 * cp;       // the first of the thread's two channels
  const int i0 = band * a.band, i1 = min(i0 + a.band, H);
  const int rlo = max(0, i0 - 3), rhi = min(H, i1 + 3);  // input rows the band reads
  const int col0 = tile * G * kS;                        // the tile's first output column
  const int ncols = G * kS + 6;                          // staged columns

  // shared memory: the ring [ring][boxes][ncols][kBox bytes] and its
  // mbarriers, the mbarriers of the peer's sums (one a pass), the
  // butterflies' partials [2 passes][G][16 pixels][pairs / lanes], each
  // lane group's pixel totals [2][threads / lanes][16] and the peer's sums
  // [2][G][16]
  const int slot_bytes = a.boxes * ncols * kBox;
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ring * slot_bytes);
  uint64_t* inbox_bar = full + a.ring;
  const int np = a.pairs / a.lanes;
  float* red = reinterpret_cast<float*>(inbox_bar + 2);
  float* tot = red + 2 * G * kPix * np;
  float* inbox = tot + 2 * (blockDim.x / a.lanes) * kPix;

  // the block's weights, (own channels, 49) as they lie in device memory,
  // through the ring's space in 16-byte pieces; then each thread's 98 into
  // registers (lanes 98 words apart: two-way bank conflicts, once a block)
  if (tid == 0) {
    for (int s = 0; s < a.ring; ++s) mbar_init(full + s, 1);
    mbar_init(inbox_bar, 1);
    mbar_init(inbox_bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    float* ws = reinterpret_cast<float*>(smem);
    const float* src = a.w + static_cast<int64_t>(cstart) * 49;
    for (int q = tid; q < own_pairs * 2 * 49 / 4; q += blockDim.x) {
      cp_async16(ws + 4 * q, src + 4 * q);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  float2 wt[49];
  {
    const float* ws = reinterpret_cast<const float*>(smem) + 2 * cp * 49;
#pragma unroll
    for (int k = 0; k < 49; ++k) {
      wt[k] = active ? make_float2(ws[k], ws[49 + k]) : make_float2(0.f, 0.f);
    }
  }
  const float2 bias = active ? make_float2(a.b[c], a.b[c + 1]) : make_float2(0.f, 0.f);
  const float2 gm = active ? make_float2(a.gamma[c], a.gamma[c + 1]) : make_float2(0.f, 0.f);
  const float2 bt = active ? make_float2(a.beta[c], a.beta[c + 1]) : make_float2(0.f, 0.f);
  // the ring takes the weights' space; where the channels are split, the
  // peer's mbarriers are ready before anything is pushed to them
  if (K == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }

  // input row r into its ring slot, one TMA box a kBox bytes of channels,
  // columns col0 − 3 ... col0 + 7·G + 2 (zeros outside the image); lane 0
  // of each warp issues its share of the boxes, so that no warp carries them
  // all. The k-th row a slot takes completes its mbarrier's phase k.
  const int warp = tid >> 5, nwarps = (static_cast<int>(blockDim.x) + 31) >> 5;
  auto stage = [&](int r) {
    if (r < rlo || r >= rhi) return;
    const int s = r % a.ring;
    if (tid == 0) mbar_expect_tx(full + s, slot_bytes);
    if (lane != 0) return;
    for (int bi = warp; bi < a.boxes; bi += nwarps) {
      tma_load(ring + s * slot_bytes + bi * ncols * kBox, &map, cstart + bi * kBoxPairs * 2,
               col0 - 3, r, img, full + s);
    }
  };
  auto ready = [&](int r) { mbar_wait(full + r % a.ring, ((r - rlo) / a.ring) & 1); };
  const int ahead = (a.ring - 8) / 2;  // iterations of rows in flight beyond the next (0 or 1)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the weights' use
  for (int r = rlo; r < i0 + 5 + 2 * ahead; ++r) stage(r);

  // the butterfly's lanes: the warp's existing lanes, the lane's pixel after
  // the scatter, the lane group within the column group and within the block
  const int wlanes = min(32, static_cast<int>(blockDim.x) - (tid & ~31));
  const unsigned wmask = wlanes == 32 ? 0xffffffffu : (1u << wlanes) - 1u;
  const int L = a.lanes, sub = L / 16;
  const int pix = (lane & (L - 1)) / sub;
  const int grp = cp / L, gslot = tid / L;
  const float inv_c = 1.0f / static_cast<float>(C);
  int phase = 0;  // patches done: the parity of the inboxes' mbarriers

  // f(sum over the pixel's C channels of v[k]) into s[k], k < 16, f taken
  // once a pixel by the lane that holds its total; `between()` runs right
  // after the barrier (the ring's next loads)
  auto pixel_sums = [&](float (&v)[kPix], int pass, float (&s)[kPix], auto f, auto between) {
    const int m = L / 2;
    scatter<8>(v, wmask, m, lane & m);
    scatter<4>(v, wmask, m / 2, lane & (m / 2));
    scatter<2>(v, wmask, m / 4, lane & (m / 4));
    scatter<1>(v, wmask, m / 8, lane & (m / 8));
    if (L == 32) v[0] += __shfl_xor_sync(wmask, v[0], 1);
    float* rp = red + pass * G * kPix * np + (g * kPix + pix) * np;
    if ((lane & (sub - 1)) == 0) rp[grp] = v[0];
    __syncthreads();
    between();
    float total = 0.0f;
    for (int q = 0; q < np; ++q) total += rp[q];
    if (K == 2) {
      // the block's sum of each pixel goes to the peer's inbox, one lane a
      // pixel, counted on the peer's mbarrier of this pass; the peer's
      // arrives in this block's. The same sums in the same order in both.
      float* mine_in = inbox + (pass * G + g) * kPix + pix;
      if (grp == 0 && (lane & (sub - 1)) == 0) {
        push_to_peer(peer_u32(mine_in, rank ^ 1), total, peer_u32(inbox_bar + pass, rank ^ 1));
      }
      if (tid == 0) mbar_expect_tx(inbox_bar + pass, G * kPix * 4);
      mbar_wait(inbox_bar + pass, phase & 1);
      const float other = *mine_in;
      total = rank == 0 ? total + other : other + total;
    }
    float* tp = tot + (pass * (blockDim.x / L) + gslot) * kPix;
    tp[pix] = f(total);
    __syncwarp(wmask);
#pragma unroll
    for (int k = 0; k < kPix; k += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(tp + k);
      s[k] = q4.x, s[k + 1] = q4.y, s[k + 2] = q4.z, s[k + 3] = q4.w;
    }
  };

  const unsigned char* mine = ring + (cp / kBoxPairs) * ncols * kBox +
                              (cp % kBoxPairs) * static_cast<int>(sizeof(word)) + g * kS * kBox;
  T* out = static_cast<T*>(a.out) + static_cast<int64_t>(img) * H * W * C + c;
  for (int i = i0; i < i1; i += kRows) {
    float2 acc[kRows][kS];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
      for (int j = 0; j < kS; ++j) acc[rr][j] = make_float2(0.f, 0.f);
    }
    // input row i − 3 + t feeds output row i through tap row t and row i + 1
    // through tap row t − 1; rows up to i + 2 were waited for by the
    // previous patch
    if (active) {
      for (int r = i == i0 ? rlo : i + 3; r < min(rhi, i + 5); ++r) ready(r);
      const int s0 = (i - 3 + a.ring) % a.ring;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = i - 3 + t;
        if (r < rlo || r >= rhi) continue;
        const int st = s0 + t >= a.ring ? s0 + t - a.ring : s0 + t;
        const unsigned char* rp = mine + st * slot_bytes;
#pragma unroll
        for (int u = 0; u < kS + 6; ++u) {
          const float2 v = P::load(reinterpret_cast<const word*>(rp + u * kBox));
#pragma unroll
          for (int dj = 0; dj < 7; ++dj) {
            const int j = u - dj;
            if (j < 0 || j >= kS) continue;
            if (t < 7) {
              const float2 wv = wt[t * 7 + dj];
              acc[0][j].x = fmaf(v.x, wv.x, acc[0][j].x);
              acc[0][j].y = fmaf(v.y, wv.y, acc[0][j].y);
            }
            if (t > 0) {
              const float2 wv = wt[(t - 1) * 7 + dj];
              acc[1][j].x = fmaf(v.x, wv.x, acc[1][j].x);
              acc[1][j].y = fmaf(v.y, wv.y, acc[1][j].y);
            }
          }
        }
      }
    }
    float v[kPix], s[kPix];
#pragma unroll
    for (int k = 0; k < kRows * kS; ++k) {
      float2& y = acc[k / kS][k % kS];
      y.x = __fadd_rn(y.x, bias.x);
      y.y = __fadd_rn(y.y, bias.y);
      v[k] = __fadd_rn(y.x, y.y);
    }
    v[14] = v[15] = 0.0f;
    // pass 1, the mean; once every thread is past the convolution, the
    // ring's slots of rows i − 3 and i − 2 take rows i + 5 + 2·ahead and
    // i + 6 + 2·ahead
    pixel_sums(v, 0, s, [&](float sum) { return sum * inv_c; }, [&] {
      stage(i + 5 + 2 * ahead);
      stage(i + 6 + 2 * ahead);
    });
#pragma unroll
    for (int k = 0; k < kRows * kS; ++k) {
      float2& y = acc[k / kS][k % kS];
      y.x = __fsub_rn(y.x, s[k]);
      y.y = __fsub_rn(y.y, s[k]);
      v[k] = active ? __fadd_rn(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)) : 0.0f;
    }
    v[14] = v[15] = 0.0f;
    // pass 2, the variance, into rsqrt(var + eps)
    pixel_sums(v, 1, s, [&](float sum) { return rsqrtf(__fadd_rn(sum * inv_c, a.eps)); },
               [] {});
    ++phase;
    if (!active) continue;
#pragma unroll
    for (int k = 0; k < kRows * kS; ++k) {
      const int row = i + k / kS, col = col0 + g * kS + k % kS;
      if (row >= i1 || col >= W) continue;
      const float2 d = acc[k / kS][k % kS];
      P::store(out + (static_cast<int64_t>(row) * W + col) * C,
               fmaf(__fmul_rn(d.x, s[k]), gm.x, bt.x), fmaf(__fmul_rn(d.y, s[k]), gm.y, bt.y));
    }
  }
  if (K == 2) cg::this_cluster().sync();  // no block leaves while its peer may push to it
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

}  // namespace

// x, out (n, h, w, c) contiguous of one type (dtype 0 = f32, 1 = bf16), x
// on 16 bytes; w (c, 1, 7, 7) f32 on 16 bytes; bias, gamma, beta (c,) f32;
// the plan of ops/convnext.py::dwconv_plan: c0, pairs, lanes, groups,
// tiles, band, bands, cluster, ring, boxes and the dynamic shared bytes.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dwconv_ln_launch(const void* x, const void* w, const void* b, const void* gamma,
                                const void* beta, void* out, int n, int h, int w_, int c, int c0,
                                int pairs, int lanes, int groups, int tiles, int band, int bands,
                                int cluster, int ring, int boxes, int smem_bytes, float eps,
                                int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w_ <= 0) return 0;
  const long long threads = static_cast<long long>(groups) * pairs;
  const long long grid = static_cast<long long>(cluster) * tiles * bands * n;
  const int size = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || c <= 0 || c % 32 || (cluster != 1 && cluster != 2) ||
      (lanes != 16 && lanes != 32) || pairs <= 0 || pairs % lanes || threads > kThreads ||
      (ring != 8 && ring != 10) || band <= 0 || band % kRows || 2 * pairs != c0 ||
      (cluster == 1 ? c0 != c : c0 >= c || c - c0 > c0) || boxes * kBox < c0 * size ||
      groups * kS + 6 > 256 || smem_bytes > kMaxSmem || grid > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x as (C, W, H, N), boxes of kBox bytes of channels × the 7·G + 6 staged
  // columns of one row of one image
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w_),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * size,
                                 static_cast<cuuint64_t>(c) * size * w_,
                                 static_cast<cuuint64_t>(c) * size * w_ * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox / size),
                             static_cast<cuuint32_t>(groups * kS + 6), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(w), static_cast<const float*>(b),
               static_cast<const float*>(gamma), static_cast<const float*>(beta),
               out, n, h, w_, c, c0, pairs, lanes, groups, tiles, band, bands, cluster, ring,
               boxes, eps};
  void (*kernel)(CUtensorMap, Args) = dtype == 1 ? dwconv_ln_kernel<1> : dwconv_ln_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
