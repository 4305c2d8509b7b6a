// One layer of a DenseNet dense block (kernel K12), for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_densenet.py::dense_block_pallas (the
// Pallas TPU kernel, pl.pallas_call at :141), one launch per layer. For the
// block buffer buf (B, H, W, Ctot) in the working type T_ (bf16 or f32),
// layer li reads its first c channels and writes the g new ones at offset c:
//
//   a1  = T_(relu(buf[..., :c] * g1 + b1))                 f32, folded BN1
//   t   = a1 . W1                    (c -> mid, 1x1)       f32 accumulators
//   t2  = T_(relu(t * g2 + b2))                             f32, folded BN2
//   out = T_(conv3x3(zero-padded t2, W2))  (mid -> g)       f32 accumulators
//   buf[..., c:c+g] = out
//
// in the order of pallas_densenet.py::_block_kernel (:86-124), each multiply
// and add rounded on its own (_rn intrinsics: no contraction into an FMA).
// W1 is the layer's (c, mid) slice of the packed (S, mid) matrix, W2 its
// (9*mid, g) slice, tap-major (ky, kx, m) rows; g1, b1 (c,), g2, b2 (mid,)
// in f32.
//
// Design. The TPU kernel keeps the block's whole (M, c0 + L*g) buffer in
// VMEM; on the H100 one image of DenseNet-121's first block is 1.6 MB
// against 227 KB of shared memory. So the buffer lives in device memory,
// preallocated for the block's final width, and each layer writes its g
// channels in place: a strided 32-channel store, not the whole-buffer
// rewrite XLA made of it on the TPU. What the TPU kernel keeps out of HBM
// still stays on the chip: the (M, mid) bottleneck t2. One block of 8 warps
// owns an 8x8 tile of output pixels of one image:
//
// - t2 of the 10x10 halo tile (100 pixels x mid <= 128, padded to 112 rows)
//   into shared memory: BN1 and ReLU applied as each 32-channel K chunk of
//   the input is staged, W1's chunk staged beside it; pixels of the halo
//   outside the image are zeros of t2 (the 3x3's padding), not
//   relu(bn2(...)) of a padded input;
// - the 9 tap products against W2, staged one tap (mid x g) at a time;
//   warp w owns output row w, its 8 pixels x g channels;
// - the store of the g new channels.
//
// The halo's 1x1 work is recomputed: 100/64 = 1.56x. bf16 runs on the
// tensor cores through nvcuda::wmma: the 1x1 as 16x16x16 fragments, the
// 3x3 as 8x32x16 fragments whose 8 rows are 8 neighbouring pixels of one
// halo row (so every tap's A tile is a plain strided view of t2). f32 runs
// on CUDA cores with FMA, never TF32.
//
// Bound: operations. DenseNet-121's first block at B = 128 is 266 GFLOP
// (89 in the 1x1s, 178 in the 3x3s) against 0.5 GB of buffer in and out.
//
// Binding: a plain C entry point (dense_layer_launch) called through
// ctypes; it launches on the caller's stream and returns the cudaError_t of
// the launch. mid <= 128, g <= 32.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int TILE = 8;                 // output pixels a side
constexpr int HALO = TILE + 2;          // 10
constexpr int NP = HALO * HALO;         // 100 halo pixels
constexpr int NPP = 112;                // padded to 7 tiles of 16
constexpr int KC = 32;                  // input channels a step
constexpr int MAXMID = 128, MAXG = 32;

struct Params {
  void* buf;           // (B, H, W, ctot) T_
  const float* g1;     // (c,)
  const float* b1;     // (c,)
  const void* w1;      // (c, mid) T_
  const float* g2;     // (mid,)
  const float* b2;     // (mid,)
  const void* w2;      // (9 * mid, g) T_
  int h, w, ctot, c, mid, g, tiles_x;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// relu(v * s + b), the multiply and the add each rounded
__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.0f);
}

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

// stage a1 of input channels k0 .. k0 + KC - 1 for the 112 halo rows
// (zeros outside the image and past c) at a1s[q * sq + kk * sk]
template <typename T>
__device__ void stage_a1(const Params& p, const Tile& tile, int k0, T* a1s, int sq, int sk) {
  const T* buf = static_cast<const T*>(p.buf);
  for (int e = threadIdx.x; e < NPP * KC; e += kThreads) {
    const int q = e / KC, kk = e % KC, k = k0 + kk;
    int64_t at;
    float v = 0.0f;
    if (k < p.c && tile.inside(p, q, &at)) v = affine_relu(to_f(buf[at + k]), p.g1[k], p.b1[k]);
    a1s[q * sq + kk * sk] = from_f<T>(v);
  }
}

// stage W1 rows k0 .. k0 + KC - 1 as w1s[kk * ld + m], zeros past c and mid
template <typename T>
__device__ void stage_w1(const Params& p, int k0, T* w1s, int ld) {
  const T* w1 = static_cast<const T*>(p.w1);
  for (int e = threadIdx.x; e < KC * MAXMID; e += kThreads) {
    const int kk = e / MAXMID, m = e % MAXMID, k = k0 + kk;
    w1s[kk * ld + m] = (k < p.c && m < p.mid) ? w1[static_cast<int64_t>(k) * p.mid + m]
                                               : from_f<T>(0.0f);
  }
}

// stage tap `tap` of W2 as w2s[m * ld + n], zeros past mid and g
template <typename T>
__device__ void stage_w2(const Params& p, int tap, T* w2s, int ld) {
  const T* w2 = static_cast<const T*>(p.w2);
  for (int e = threadIdx.x; e < MAXMID * MAXG; e += kThreads) {
    const int m = e / MAXG, n = e % MAXG;
    w2s[m * ld + n] = (m < p.mid && n < p.g)
                          ? w2[(static_cast<int64_t>(tap) * p.mid + m) * p.g + n]
                          : from_f<T>(0.0f);
  }
}

// t2 of halo pixel q, channel m, from its f32 1x1 sum
__device__ __forceinline__ float t2_of(const Params& p, const Tile& tile, int q, int m,
                                       float acc) {
  int64_t at;
  if (m >= p.mid || !tile.inside(p, q, &at)) return 0.0f;
  return affine_relu(acc, p.g2[m], p.b2[m]);
}

// the new channel n of output pixel (row r, column x) of the tile
template <typename T>
__device__ __forceinline__ void store_new(const Params& p, const Tile& tile, int r, int x, int n,
                                          float acc) {
  const int y = tile.y0 + r, xx = tile.x0 + x;
  if (y < p.h && xx < p.w && n < p.g) {
    static_cast<T*>(p.buf)[tile.img + (static_cast<int64_t>(y) * p.w + xx) * p.ctot + p.c + n] =
        from_f<T>(acc);
  }
}

// ---------------------------------------------------------------- bf16 --
// shared memory: a1s [q][k] (ld 40), w1s [k][m] (ld 136), t2s [q][m] (ld 144:
// 288 bytes, so every pixel's row starts on 32 bytes for the 8-row tap
// tiles), w2s [m][n] (ld 40), a 16x16 f32 scratch a warp
constexpr int LDA = KC + 8, LDM = MAXMID + 8, LDT = MAXMID + 16, LDN = MAXG + 8;

struct Bf16Layout {
  static constexpr int a1s = 0;
  static constexpr int w1s = a1s + align128(NPP * LDA * 2);
  static constexpr int t2s = w1s + align128(KC * LDM * 2);
  static constexpr int w2s = t2s + align128(NPP * LDT * 2);
  static constexpr int scratch = w2s + align128(MAXMID * LDN * 2);
  static constexpr int total = scratch + kWarps * 256 * 4;
};

__global__ void __launch_bounds__(kThreads) dense_layer_bf16_kernel(Params p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  using Lay = Bf16Layout;
  bf16* a1s = reinterpret_cast<bf16*>(smem + Lay::a1s);
  bf16* w1s = reinterpret_cast<bf16*>(smem + Lay::w1s);
  bf16* t2s = reinterpret_cast<bf16*>(smem + Lay::t2s);
  bf16* w2s = reinterpret_cast<bf16*>(smem + Lay::w2s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + Lay::scratch) + warp * 256;
  const Tile tile(p);

  // the 1x1: t (112 halo rows x 128) = a1 . W1; warp w takes the columns
  // w * 16 .. w * 16 + 15, all 7 row tiles
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> t[NPP / 16];
#pragma unroll
  for (int r = 0; r < NPP / 16; ++r) wmma::fill_fragment(t[r], 0.0f);
  for (int k0 = 0; k0 < p.c; k0 += KC) {
    stage_a1<bf16>(p, tile, k0, a1s, LDA, 1);
    stage_w1<bf16>(p, k0, w1s, LDM);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, w1s + kk * LDM + warp * 16, LDM);
#pragma unroll
      for (int r = 0; r < NPP / 16; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a1s + r * 16 * LDA + kk, LDA);
        wmma::mma_sync(t[r], fa, fb, t[r]);
      }
    }
    __syncthreads();
  }
  // t2 = T_(relu(t * g2 + b2)), zeros outside the image
#pragma unroll
  for (int r = 0; r < NPP / 16; ++r) {
    wmma::store_matrix_sync(scratch, t[r], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int q = r * 16 + e / 16, m = warp * 16 + e % 16;
      t2s[q * LDT + m] = __float2bfloat16_rn(t2_of(p, tile, q, m, scratch[e]));
    }
    __syncwarp();
  }

  // the 3x3: warp w's output row, 8 pixels x 32 channels, over 9 taps x mid
  wmma::fragment<wmma::accumulator, 8, 32, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  const int mid16 = (p.mid + 15) / 16 * 16;
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // t2s complete; the last tap's w2s read
    stage_w2<bf16>(p, tap, w2s, LDN);
    __syncthreads();
    const bf16* rows = t2s + ((warp + tap / 3) * HALO + tap % 3) * LDT;
    for (int k = 0; k < mid16; k += 16) {
      wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, rows + k, LDT);
      wmma::load_matrix_sync(fb, w2s + k * LDN, LDN);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  wmma::store_matrix_sync(scratch, acc, MAXG, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < TILE * MAXG; e += 32) store_new<bf16>(p, tile, warp, e / MAXG, e % MAXG,
                                                                 scratch[e]);
}

// ----------------------------------------------------------------- f32 --
// shared memory: a1s [k][q] and w1s [k][m] (k-major for the 1x1), t2s [q][m],
// w2s [m][n]
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
    stage_a1<float>(p, tile, k0, a1s, 1, NPP);
    stage_w1<float>(p, k0, w1s, MAXMID);
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
#pragma unroll
  for (int i = 0; i < NPP / kWarps; ++i) {
    const int q = warp + kWarps * i;
    if (q >= NP) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = lane * 4 + j;
      t2s[q * MAXMID + m] = t2_of(p, tile, q, m, t[i][j]);
    }
  }

  // the 3x3: output row `warp`, its 8 pixels, channel `lane`
  float acc[TILE];
#pragma unroll
  for (int x = 0; x < TILE; ++x) acc[x] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();
    stage_w2<float>(p, tap, w2s, MAXG);
    __syncthreads();
    const float* rows = t2s + ((warp + tap / 3) * HALO + tap % 3) * MAXMID;
    for (int m = 0; m < p.mid; ++m) {
      const float wv = w2s[m * MAXG + lane];
#pragma unroll
      for (int x = 0; x < TILE; ++x) acc[x] = fmaf(rows[x * MAXMID + m], wv, acc[x]);
    }
  }
#pragma unroll
  for (int x = 0; x < TILE; ++x) store_new<float>(p, tile, warp, x, lane, acc[x]);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int bytes, cudaStream_t s, const Params& p) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// buf (B, H, W, ctot), w1 (c, mid), w2 (9 * mid, g): one type, contiguous;
// g1, b1 (c,), g2, b2 (mid,) f32; the layer reads channels [0, c) of buf and
// writes [c, c + g); dtype 0 = f32, 1 = bf16; mid <= 128, g <= 32. Returns
// the cudaError_t of the launch (0 on success). Argument checks (device,
// dtype, contiguity, shapes) are the Python wrapper's job.
extern "C" int dense_layer_launch(void* buf, const void* g1, const void* b1, const void* w1,
                                  const void* g2, const void* b2, const void* w2, int batch,
                                  int h, int w, int ctot, int c, int mid, int g, int dtype,
                                  void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (c <= 0 || mid <= 0 || mid > MAXMID || g <= 0 || g > MAXG || c + g > ctot ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + TILE - 1) / TILE, tiles_y = (h + TILE - 1) / TILE;
  const Params p{buf, static_cast<const float*>(g1), static_cast<const float*>(b1), w1,
                 static_cast<const float*>(g2), static_cast<const float*>(b2), w2,
                 h, w, ctot, c, mid, g, tiles_x};
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(launch(dense_layer_bf16_kernel, grid, Bf16Layout::total,
                                                 s, p));
  if (dtype == 0) return static_cast<int>(launch(dense_layer_f32_kernel, grid, F32Layout::total,
                                                 s, p));
  return static_cast<int>(cudaErrorInvalidValue);
}
