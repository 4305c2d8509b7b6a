// A DenseNet dense block (kernel K12), for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_densenet.py::dense_block_pallas (the
// Pallas TPU kernel, pl.pallas_call at :141). For the block buffer buf
// (B, H, W, Ctot), layer li reads its first c = c0 + li·g channels and
// writes the g new ones at offset c, in the working type T (bf16 or f32):
//
//   a1  = T(relu(buf[..., :c] * g1 + b1))                  f32, folded BN1
//   t   = a1 . W1                    (c -> mid, 1x1)       f32 sums
//   t2  = T(relu(t * g2 + b2))                              f32, folded BN2
//   out = T(conv3x3(zero-padded t2, W2))  (mid -> g)       f32 sums, one cast
//   buf[..., c:c+g] = out
//
// in the order of pallas_densenet.py::_block_kernel (:86-118), each multiply
// and add rounded on its own (_rn intrinsics: no contraction into an FMA).
// W2 is the layer's (9·mid, g) slice of the packed matrix, tap-major
// (ky, kx, m) rows; g1, b1 (c,), g2, b2 (mid,) in f32. The TPU kernel keeps
// the block's whole (M, Ctot) buffer in VMEM; on the H100 one image of
// DenseNet-121's first block is 1.6 MB against 227 KB of shared memory, so
// the buffer lives in device memory, preallocated at the block's final
// width, and each layer writes its g channels in place.
//
// bf16 (the main path): three launches a layer, M = B·H·W pixel rows.
//
// 1. bn_relu_bf16_kernel, a pass: a1 = T(relu(x·g1 + b1)) of the c channels
//    of every pixel (rows Ctot apart) into an (M, c) scratch, a 16-byte
//    vector a thread (c % 8 = 0).
// 2. The 1x1 on linear_fused.cu's product (TMA, an mbarrier ring, wgmma
//    m64n128k16, persistent ping-pong consumers, TMA stores) with its
//    kScaleRelu epilogue: t2 = T(relu(acc·g2 + b2)) into an (M, mid)
//    scratch. W1 goes in as the layer's (mid, c) transpose. The wrapper
//    (ops/densenet.py) makes that launch; this file has the other two.
// 3. conv3x3_bf16_kernel, an implicit GEMM: out (M × g) = Σ over the 9 taps
//    of t2 shifted by (dy − 1, dx − 1) · W2[tap], M in tiles of 64 pixels
//    (flattened (b, y, x), so a tile crosses rows and images), N = g ≤ 32,
//    K = 9·mid. A persistent grid of two blocks an SM, each of one
//    warpgroup; a block keeps the layer's W2ᵀ (9 taps × 32 × 128 bf16,
//    72 KB, laid out by the wrapper in the 128-byte swizzle's order) in
//    shared memory for the whole launch. For each tile and each tap row dy,
//    cp.async brings the 66 pixel rows of t2 from (tile start + (dy − 1)·W
//    − 1) into one of 2 stages (rows padded to mid + 8 values, so
//    ldmatrix's 8 rows fall on distinct banks) while the other is in use;
//    the three taps dx of that row are views of one stage shifted by dx
//    rows. Rows outside [0, M) are zero-filled (src-size 0). Each warp
//    brings its 16 rows of a tap into registers with ldmatrix and zeroes the
//    rows whose neighbour falls outside the image (the 3x3's zero padding: a
//    stage row is padding for one pixel's tap and not for another's, so it
//    cannot be zeroed in shared memory); the warpgroup issues wgmma
//    m64n32k16 with A from registers and W2ᵀ from shared memory; f32 sums,
//    one cast, bf16 pairs stored straight into buf. (mma.sync from
//    ldmatrix, with W2 read from shared memory by every warp, and 128-pixel
//    tiles at one block an SM were slower: PERF.md.)
//
// Bound. The function's bound is by operations (the 1x1s and 3x3s: 266
// GFLOP in DenseNet-121's first block at B = 128, 0.33 ms). This design
// also moves a1 and t2 through device memory: per layer about
// 2·M·(3c + 2.1·mid + g) bytes (the pass's read and write, the product's
// read of a1 and write of t2, the 3x3's read of t2 with its halo, and the
// g new channels), 9.6 GB a DenseNet-121 forward at B = 128: a byte floor
// of 2.86 ms at 3.35 TB/s against the 0.78 ms operations bound. So the
// kernels here are kept simple and bandwidth-shaped: 16-byte accesses,
// asynchronous copies a tap row ahead, W2 resident. The 3x3's tap rows
// are re-read from L2 (3 × 66 rows a 64-pixel tile), and each is read
// from shared memory once for each of its 3 taps.
//
// f32 (checks only, off the main path): one launch a layer on CUDA cores
// with FMA, never TF32. One block of 8 warps owns an 8x8 tile of output
// pixels of one image: t2 of its 10x10 halo into shared memory (BN1 and
// ReLU applied as each 32-channel K chunk is staged, W1's (c, mid) chunk
// beside it; halo pixels outside the image are zeros of t2), then the 9
// tap products against W2 staged one tap at a time.
//
// Binding: plain C entry points called through ctypes; each launches on the
// caller's stream and returns the cudaError_t of the launch. Argument
// checks (device, dtype, contiguity, shapes, alignment) are the Python
// wrapper's job.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAXMID = 128, MAXG = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// relu(v * s + b), the multiply and the add each rounded
__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.0f);
}

// ------------------------------------------------------- bf16: BN1-ReLU --
constexpr int kPassThreads = 256;

// a1[p, k] = T(relu(buf[p, k] · g1[k] + b1[k])) for k < c, one 16-byte
// vector (8 channels) a thread; vectors = M · c / 8 < 2^31
__global__ void __launch_bounds__(kPassThreads)
    bn_relu_bf16_kernel(const bf16* __restrict__ buf, const float* __restrict__ g1,
                        const float* __restrict__ b1, bf16* __restrict__ a1, uint32_t vectors,
                        uint32_t row_vectors, int ctot, int c) {
  const uint32_t v = blockIdx.x * kPassThreads + threadIdx.x;
  if (v >= vectors) return;
  const uint32_t row = v / row_vectors;
  const int k = static_cast<int>(v - row * row_vectors) * 8;
  uint4 u = *reinterpret_cast<const uint4*>(buf + static_cast<int64_t>(row) * ctot + k);
  const float4 s4[2] = {*reinterpret_cast<const float4*>(g1 + k),
                        *reinterpret_cast<const float4*>(g1 + k + 4)};
  const float4 t4[2] = {*reinterpret_cast<const float4*>(b1 + k),
                        *reinterpret_cast<const float4*>(b1 + k + 4)};
  const float* sv = reinterpret_cast<const float*>(s4);
  const float* tv = reinterpret_cast<const float*>(t4);
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = __float2bfloat16_rn(affine_relu(__bfloat162float(e[j]), sv[j], tv[j]));
  }
  *reinterpret_cast<uint4*>(a1 + static_cast<int64_t>(row) * c + k) = u;
}

// ------------------------------------------------------------ bf16: 3x3 --
constexpr int TM = 64;                     // output pixels a tile
constexpr int kConvThreads = 128;          // one warpgroup: 64 pixels × 32 channels
constexpr int kConvBlocks = 2;             // blocks an SM
constexpr int kConvStages = 2;             // tap rows in flight
constexpr int AROWS = TM + 2;              // a tap row: the tile and one pixel either side
constexpr int NB = MAXG;                   // W2ᵀ's rows: the output channels, padded to 32

// shared memory of the 3x3 at bottleneck width MID: W2ᵀ, 9 taps of KH
// K-halves of NB rows × 128 bytes in the 128-byte swizzle (4 KB each, on
// 1024 bytes), then the stages of AROWS pixel rows of MID + 8 values, and
// 1 KB to align W2ᵀ to the swizzle pattern
template <int MID>
struct ConvShape {
  static constexpr int KH = (MID + 63) / 64, LDA = MID + 8;
  static constexpr size_t w_bytes = size_t{9} * KH * NB * 128;
  static constexpr size_t a_bytes = sizeof(bf16) * AROWS * LDA;
  static constexpr size_t smem = 1024 + w_bytes + kConvStages * a_bytes;
};
static_assert(ConvShape<MAXMID>::smem * kConvBlocks <= 227 * 1024,
              "W2 and the stages of the blocks of an SM exceed its shared memory");

struct ConvArgs {
  const bf16* t2;   // (M, mid)
  const bf16* w2t;  // (9, KH, 32, 64): W2ᵀ of each tap, the shared-memory order
  bf16* out;        // buf + c: pixel rows ctot apart
  int m, h, w, ctot, g, tiles;
};

// 16 bytes from global to shared memory, asynchronously; zeros where !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (as linear_fused.cu's)
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

// d (64 × 32, f32) += A (64 × 16, bf16, registers: each warp its 16 rows in
// mma.sync's m16n8k16 A layout) · B (16 × 32, bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the taps (bit dy·3 + dx) of pixel row `pix` whose neighbour lies inside
// its image; none past M
__device__ __forceinline__ uint32_t tap_mask(const ConvArgs& p, int pix) {
  if (pix >= p.m) return 0;
  const int x = pix % p.w, y = (pix / p.w) % p.h;
  const uint32_t rows = (y > 0 ? 1u : 0u) | 2u | (y < p.h - 1 ? 4u : 0u);
  const uint32_t cols = (x > 0 ? 1u : 0u) | 2u | (x < p.w - 1 ? 4u : 0u);
  uint32_t mask = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (((rows >> (t / 3)) & (cols >> (t % 3)) & 1u) != 0) mask |= 1u << t;
  }
  return mask;
}

// One tap's products of a warpgroup: its warp's 16 pixel rows of the stage,
// shifted by dx, from ldmatrix into registers, the rows whose tap is padding
// zeroed, then MID / 16 wgmma against the tap's W2ᵀ.
template <int MID>
__device__ __forceinline__ void tap_products(float (&acc)[16], uint32_t (&af)[MID / 16][4],
                                             const bf16* rows, const unsigned char* wt,
                                             bool keep0, bool keep8) {
  constexpr int LDA = ConvShape<MID>::LDA;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < MID / 16; ++ks) {
    ldmatrix_x4(af[ks], rows + (lane % 16) * LDA + ks * 16 + (lane / 16) * 8);
    if (!keep0) af[ks][0] = af[ks][2] = 0u;  // row gq
    if (!keep8) af[ks][1] = af[ks][3] = 0u;  // row gq + 8
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < MID / 16; ++ks) {
    // K-half ks / 4 of the tap, + 32 bytes a step of 16 within it
    wgmma_m64n32k16_rs(acc, af[ks], smem_desc(wt + (ks / 4) * NB * 128) + 2 * (ks % 4));
  }
  wgmma_commit();
}

// Work item j of a block: its tile blockIdx.x + (j / 3)·gridDim.x and tap
// row dy = j % 3, whose AROWS pixel rows start at tile·TM + (dy − 1)·W − 1.
template <int MID>
__global__ void __launch_bounds__(kConvThreads, kConvBlocks) conv3x3_bf16_kernel(ConvArgs p) {
  using S = ConvShape<MID>;
  constexpr int LDA = S::LDA, CH = MID / 8;  // a stage's row stride; 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sW = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* sA = reinterpret_cast<bf16*>(sW + S::w_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first pixel row
  const int gq = lane / 4, t4 = lane % 4;
  const int items = 3 * ((p.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);

  // W2ᵀ once, each row's 16-byte chunk q at q ^ (row % 8); it lands with
  // the first stage
  for (int e = threadIdx.x; e < 9 * S::KH * NB * 8; e += kConvThreads) {
    const int row = e / 8, q = e % 8;
    cp_async16(sW + row * 128 + ((q ^ (row % 8)) * 16), p.w2t + static_cast<int64_t>(e) * 8,
               true);
  }
  auto load = [&](int j) {
    const int tile = blockIdx.x + (j / 3) * gridDim.x;
    const int first = tile * TM + (j % 3 - 1) * p.w - 1;
    bf16* dst = sA + (j % kConvStages) * AROWS * LDA;
    for (int e = threadIdx.x; e < AROWS * CH; e += kConvThreads) {
      const int r = e / CH, ch = e % CH, q = first + r;
      const bool in = q >= 0 && q < p.m;
      cp_async16(dst + r * LDA + ch * 8, p.t2 + (in ? static_cast<int64_t>(q) * MID + ch * 8 : 0),
                 in);
    }
  };
#pragma unroll
  for (int s = 0; s < kConvStages - 1; ++s) {
    if (s < items) load(s);
    cp_async_commit();
  }

  // the accumulators: acc[4n + 2·h8 + e] is pixel row row0 + gq + 8·h8,
  // channel 8n + 2·t4 + e
  float acc[16];
  uint32_t af[2][MID / 16][4];
  uint32_t taps[2];
  for (int j = 0; j < items; ++j) {
    cp_async_wait<kConvStages - 2>();  // item j (and W2ᵀ) landed
    if (j == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // W2ᵀ for wgmma
    __syncthreads();                   // ... for every thread; item j − 1's stage is free
    if (j + kConvStages - 1 < items) load(j + kConvStages - 1);
    cp_async_commit();

    const int dy = j % 3;
    const int p0 = (blockIdx.x + (j / 3) * gridDim.x) * TM;
    if (dy == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) taps[h8] = tap_mask(p, p0 + row0 + gq + 8 * h8);
    }
    const bf16* a = sA + (j % kConvStages) * AROWS * LDA + row0 * LDA;
    const unsigned char* wt = sW + (dy * 3) * S::KH * NB * 128;
    // the three taps dx of this row, on alternate register sets: a set is
    // loaded again only after the products that read it are done (keeping
    // the products in flight into the next row makes ptxas wait for them
    // all the same)
    tap_products<MID>(acc, af[0], a, wt, taps[0] >> (dy * 3) & 1u, taps[1] >> (dy * 3) & 1u);
    tap_products<MID>(acc, af[1], a + LDA, wt + S::KH * NB * 128,
                      taps[0] >> (dy * 3 + 1) & 1u, taps[1] >> (dy * 3 + 1) & 1u);
    wgmma_wait<1>();
    tap_products<MID>(acc, af[0], a + 2 * LDA, wt + 2 * S::KH * NB * 128,
                      taps[0] >> (dy * 3 + 2) & 1u, taps[1] >> (dy * 3 + 2) & 1u);
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 16; ++e) fence_operand(acc[e]);
    if (dy == 2) {  // the tile's g new channels, one cast
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int pix = p0 + row0 + gq + 8 * h8;
        if (pix >= p.m) continue;
        bf16* dst = p.out + static_cast<int64_t>(pix) * p.ctot + 2 * t4;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n * 8 < p.g) {
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
                __floats2bfloat162_rn(acc[4 * n + 2 * h8], acc[4 * n + 2 * h8 + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------------------- f32 --
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int TILE = 8;                 // output pixels a side
constexpr int HALO = TILE + 2;          // 10
constexpr int NP = HALO * HALO;         // 100 halo pixels
constexpr int NPP = 112;                // padded to a multiple of the 8 warps
constexpr int KC = 32;                  // input channels a step

struct Params {
  float* buf;         // (B, H, W, ctot)
  const float* g1;    // (c,)
  const float* b1;    // (c,)
  const float* w1;    // (c, mid)
  const float* g2;    // (mid,)
  const float* b2;    // (mid,)
  const float* w2;    // (9 * mid, g)
  int h, w, ctot, c, mid, g, tiles_x;
};

struct Tile {
  int64_t img;  // element offset of the image in buf
  int y0, x0;   // the output tile's first row and column
  __device__ Tile(const Params& p) {
    img = static_cast<int64_t>(blockIdx.y) * p.h * p.w * p.ctot;
    y0 = (blockIdx.x / p.tiles_x) * TILE;
    x0 = (blockIdx.x % p.tiles_x) * TILE;
  }
  // halo pixel q (< NP): inside the image, and its element offset
  __device__ bool inside(const Params& p, int q, int64_t* at) const {
    const int y = y0 - 1 + q / HALO, x = x0 - 1 + q % HALO;
    if (q >= NP || y < 0 || y >= p.h || x < 0 || x >= p.w) return false;
    *at = img + (static_cast<int64_t>(y) * p.w + x) * p.ctot;
    return true;
  }
};

// shared memory: a1s [k][q] and w1s [k][m] (k-major for the 1x1), t2s [q][m],
// w2s [m][n]
__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
struct F32Layout {
  static constexpr int a1s = 0;
  static constexpr int w1s = a1s + align128(KC * NPP * 4);
  static constexpr int t2s = w1s + align128(KC * MAXMID * 4);
  static constexpr int w2s = t2s + align128(NP * MAXMID * 4);
  static constexpr int total = w2s + align128(MAXMID * MAXG * 4);
};

__global__ void __launch_bounds__(kThreads) dense_layer_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Lay = F32Layout;
  float* a1s = reinterpret_cast<float*>(smem + Lay::a1s);
  float* w1s = reinterpret_cast<float*>(smem + Lay::w1s);
  float* t2s = reinterpret_cast<float*>(smem + Lay::t2s);
  float* w2s = reinterpret_cast<float*>(smem + Lay::w2s);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Tile tile(p);

  // the 1x1: this thread's halo rows warp + 8 i, columns lane * 4 + j
  float t[NPP / kWarps][4];
#pragma unroll
  for (int i = 0; i < NPP / kWarps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.0f;
  for (int k0 = 0; k0 < p.c; k0 += KC) {
    // a1 of input channels k0 .. k0 + KC - 1 (zeros outside the image and
    // past c) and W1's rows k0 .. k0 + KC - 1 (zeros past c and mid)
    for (int e = tid; e < NPP * KC; e += kThreads) {
      const int q = e / KC, kk = e % KC, k = k0 + kk;
      int64_t at;
      float v = 0.0f;
      if (k < p.c && tile.inside(p, q, &at)) v = affine_relu(p.buf[at + k], p.g1[k], p.b1[k]);
      a1s[kk * NPP + q] = v;
    }
    for (int e = tid; e < KC * MAXMID; e += kThreads) {
      const int kk = e / MAXMID, m = e % MAXMID, k = k0 + kk;
      w1s[kk * MAXMID + m] = (k < p.c && m < p.mid) ? p.w1[static_cast<int64_t>(k) * p.mid + m]
                                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&w1s[kk * MAXMID + lane * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < NPP / kWarps; ++i) {
        const float a = a1s[kk * NPP + warp + kWarps * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] = fmaf(a, bv[j], t[i][j]);
      }
    }
    __syncthreads();
  }
  // t2 = relu(t * g2 + b2), zeros outside the image (the 3x3's padding)
#pragma unroll
  for (int i = 0; i < NPP / kWarps; ++i) {
    const int q = warp + kWarps * i;
    if (q >= NP) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = lane * 4 + j;
      int64_t at;
      t2s[q * MAXMID + m] =
          (m < p.mid && tile.inside(p, q, &at)) ? affine_relu(t[i][j], p.g2[m], p.b2[m]) : 0.0f;
    }
  }

  // the 3x3: output row `warp`, its 8 pixels, channel `lane`
  float acc[TILE];
#pragma unroll
  for (int x = 0; x < TILE; ++x) acc[x] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // t2s complete; the last tap's w2s read
    for (int e = tid; e < MAXMID * MAXG; e += kThreads) {
      const int m = e / MAXG, n = e % MAXG;
      w2s[m * MAXG + n] = (m < p.mid && n < p.g)
                              ? p.w2[(static_cast<int64_t>(tap) * p.mid + m) * p.g + n]
                              : 0.0f;
    }
    __syncthreads();
    const float* rows = t2s + ((warp + tap / 3) * HALO + tap % 3) * MAXMID;
    for (int m = 0; m < p.mid; ++m) {
      const float wv = w2s[m * MAXG + lane];
#pragma unroll
      for (int x = 0; x < TILE; ++x) acc[x] = fmaf(rows[x * MAXMID + m], wv, acc[x]);
    }
  }
#pragma unroll
  for (int x = 0; x < TILE; ++x) {
    const int y = tile.y0 + warp, xx = tile.x0 + x;
    if (y < p.h && xx < p.w && lane < p.g) {
      p.buf[tile.img + (static_cast<int64_t>(y) * p.w + xx) * p.ctot + p.c + lane] = acc[x];
    }
  }
}

// ---------------------------------------------------------------- host --
template <int MID>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t s) {
  constexpr int bytes = static_cast<int>(ConvShape<MID>::smem);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bf16_kernel<MID>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // persistent: kConvBlocks blocks an SM
  const int blocks = a.tiles < kConvBlocks * sms ? a.tiles : kConvBlocks * sms;
  conv3x3_bf16_kernel<MID><<<blocks, kConvThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// BN1-ReLU pass of one bf16 layer: buf (M, ctot) pixel rows, its first c
// channels; g1, b1 (c,) f32; a1 (M, c) bf16 out. c and ctot multiples of 8,
// every pointer 16-byte aligned, M·c/8 < 2^31. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int dense_bn_relu_launch(const void* buf, const void* g1, const void* b1, void* a1,
                                    long long m, int ctot, int c, void* stream) {
  if (m <= 0) return 0;
  const long long vectors = m * (c / 8);
  if (c <= 0 || c % 8 != 0 || ctot % 8 != 0 || c > ctot || vectors >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((vectors + kPassThreads - 1) / kPassThreads);
  bn_relu_bf16_kernel<<<blocks, kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(buf), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<bf16*>(a1), static_cast<uint32_t>(vectors),
      static_cast<uint32_t>(c / 8), ctot, c);
  return static_cast<int>(cudaGetLastError());
}

// 3x3 of one bf16 layer: t2 (M, mid) of images (H, W), w2t W2ᵀ of the
// layer as ops/densenet.py::pack_w2t lays it out ((9, ⌈mid/64⌉, 32, 64),
// the output channels past g and the K past mid zero), out = buf + c (pixel
// rows ctot apart; 4-byte aligned); mid a multiple of 16 up to 128, g a
// multiple of 8 up to 32, M < 2^31; tiles = ⌈M / 128⌉, as
// ops/densenet.py::block_plan gives it (any other is refused). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dense_conv3x3_launch(const void* t2, const void* w2t, void* out, long long m,
                                    int h, int w, int ctot, int mid, int g, int tiles,
                                    void* stream) {
  if (m <= 0) return 0;
  if (h <= 0 || w <= 0 || m % (static_cast<long long>(h) * w) != 0 || m >= (1ll << 31) ||
      g <= 0 || g > MAXG || g % 8 != 0 || ctot % 2 != 0 || mid <= 0 || mid > MAXMID ||
      mid % 16 != 0 || static_cast<long long>(tiles) != (m + TM - 1) / TM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvArgs a{static_cast<const bf16*>(t2), static_cast<const bf16*>(w2t),
                   static_cast<bf16*>(out), static_cast<int>(m), h, w, ctot, g, tiles};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mid / 16) {
    case 1: return static_cast<int>(launch_conv<16>(a, s));
    case 2: return static_cast<int>(launch_conv<32>(a, s));
    case 3: return static_cast<int>(launch_conv<48>(a, s));
    case 4: return static_cast<int>(launch_conv<64>(a, s));
    case 5: return static_cast<int>(launch_conv<80>(a, s));
    case 6: return static_cast<int>(launch_conv<96>(a, s));
    case 7: return static_cast<int>(launch_conv<112>(a, s));
    default: return static_cast<int>(launch_conv<128>(a, s));
  }
}

// One f32 layer: buf (B, H, W, ctot), w1 (c, mid), w2 (9 * mid, g): f32,
// contiguous; g1, b1 (c,), g2, b2 (mid,); the layer reads channels [0, c)
// of buf and writes [c, c + g); mid <= 128, g <= 32. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dense_layer_f32_launch(void* buf, const void* g1, const void* b1, const void* w1,
                                      const void* g2, const void* b2, const void* w2, int batch,
                                      int h, int w, int ctot, int c, int mid, int g,
                                      void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (c <= 0 || mid <= 0 || mid > MAXMID || g <= 0 || g > MAXG || c + g > ctot ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + TILE - 1) / TILE, tiles_y = (h + TILE - 1) / TILE;
  const Params p{static_cast<float*>(buf), static_cast<const float*>(g1),
                 static_cast<const float*>(b1), static_cast<const float*>(w1),
                 static_cast<const float*>(g2), static_cast<const float*>(b2),
                 static_cast<const float*>(w2), h, w, ctot, c, mid, g, tiles_x};
  cudaError_t err = cudaFuncSetAttribute(dense_layer_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F32Layout::total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(batch));
  dense_layer_f32_kernel<<<grid, kThreads, F32Layout::total, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// registers a thread and dynamic shared memory a block of kernel `which`:
// 0 the BN1-ReLU pass, 1 the 3x3 at mid 128, 2 the f32 layer; returns a
// cudaError_t
extern "C" int dense_block_resources(int which, int* regs, int* smem_bytes) {
  const void* fn = which == 0   ? reinterpret_cast<const void*>(bn_relu_bf16_kernel)
                   : which == 1 ? reinterpret_cast<const void*>(conv3x3_bf16_kernel<MAXMID>)
                   : which == 2 ? reinterpret_cast<const void*>(dense_layer_f32_kernel)
                                : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = which == 1 ? static_cast<int>(ConvShape<MAXMID>::smem)
                : which == 2 ? F32Layout::total
                             : static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
