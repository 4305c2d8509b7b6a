// A tile-staged design of the bilinear warp (K2) for Hopper (sm_90a), NOT
// the port's kernel: scripts/probe_torch_warp.py builds it apart under
// build/probe_kernels/ and times it beside the port's kernel
// (robustart_torch/csrc/warp_bilinear.cu) and the port's earlier one, so
// that PERF.md's figures for it come from a committed script. It computes
// what the port's kernel computes, bit for bit (the same 'reflect', the same
// _rn steps), for C = 1 and 3 only.
//
// Design. The TPU kernel keeps the whole image in VMEM and walks a band of
// offsets with rolls and masked selects, because Mosaic has no fast gather.
// On Hopper the question is coalescing and latency instead. elastic_
// transform's displacement fields are smooth, so the source pixels of an
// output tile lie in a box little larger than the tile (1.10-1.53 times its
// area at severities 3-5). So (warp_tile_kernel, C = 1 and 3, one launch a
// call):
//
// - a block of 256 threads owns one output tile of TH × 32 pixels (TH = 8 ·
//   ROWS) of one image; lane l of warp v takes column l of rows v, v + 8, ...
//   Each thread loads all its pixels' coordinates at once (a warp reads 128
//   contiguous bytes a row), and the block reduces min and max of their
//   floors (warp reductions, then shared memory);
// - box route, where the box rows [ymin, ymax + 1] × columns [xmin, xmax +
//   1] of the unreflected coordinates fits the shared-memory budget
//   (box_bytes, an argument): the block fills it, element
//   (y, x, ch) from image row r(y), column r(x). Where the box's columns lie
//   inside the image, each row is one contiguous segment, copied by the copy
//   engine (cp.async.bulk on an mbarrier, one thread a row, widened to
//   16-byte bounds where W · C % 4 == 0); other boxes come a warp a row by
//   4-byte cp.async copies, all in flight at once, and only overhanging
//   columns reflect one by one. Then each pixel reads its corners from
//   shared memory: neighbouring lanes read neighbouring pixels, 3 words
//   apart at C = 3, which no two lanes of a warp share a bank for;
// - gather route, where the box exceeds the budget (far overhangs, random
//   displacements): the same threads gather the corners from global memory;
// - either route keeps its results in registers, stages the tile through
//   the same shared memory and stores it row by row as 16-byte stores where
//   W · C % 4 == 0 and the output starts on 16 bytes, else 4-byte stores.
// The route is chosen per tile inside the kernel; both compute each value
// with the same steps. 'reflect' divides only for an index outside [-n, 2n).
// Across the fill a thread keeps only its raw coordinates (the floors are
// taken again where they are used), so 64 registers allow 4 blocks an SM.
//
// Measured (scripts/probe_torch_warp.py, PERF.md): a tile's life is its
// phases one after another (the coordinates' round trip, the box's, then
// the sampling and stores), about 3.5 tiles an SM at a time. At elastic's
// coordinates this is slower than a thread a pixel (48 warps an SM, the
// re-read corners served by L1), and faster on i.i.d. displacements, where
// every tile gathers: so the port keeps a thread a pixel.
//
// Every float step is a _rn intrinsic so that nvcc contracts no multiply and
// add into one FMA: the plain PyTorch version (robustart_torch/ops/warp.py)
// rounds after each step and sees the same numbers, bit for bit.
//
// Binding: a plain C entry point (warp_bilinear_launch) that the probe
// calls through ctypes; it launches on the caller's stream and
// returns cudaGetLastError() of the launch.
//
// Built with -DWARP_PROBE_ROUTES (scripts/probe_torch_warp.py builds such a
// copy apart; the port never does), each tile adds itself to its route's
// count and, on the box route, its box's area, in a buffer that
// warp_bilinear_launch takes before the stream. Built with
// -DWARP_PROBE_FLOOR, the tile kernel only reads the coordinates and writes
// cy + cx to every channel through the same staging and stores: the memory
// floor of the design. With -DWARP_PROBE_GATHER every tile gathers; with
// -DWARP_PROBE_NO_BULK every box comes by 4-byte cp.async copies; with
// -DWARP_PROBE_STAMPS each block records %globaltimer stamps of its phases,
// behind a block barrier each, in a buffer warp_bilinear_launch takes
// before the stream; -DWARP_MIN_BLOCKS=n compiles the tile kernel for n
// blocks an SM.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// blocks an SM the tile kernel is compiled for (its register cap)
#ifndef WARP_MIN_BLOCKS
#define WARP_MIN_BLOCKS 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;  // a warp's lanes, one output column each
// a block's 227 KB of shared memory less the tile kernel's static 136 bytes
// (the extent's reduction and the mbarrier), rounded to 256
constexpr int kMaxBox = 227 * 1024 - 256;

// scipy 'reflect' of period 2n; a run-time division only outside [-n, 2n)
__device__ __forceinline__ int reflect(int idx, int n) {
  if (static_cast<unsigned>(idx) < static_cast<unsigned>(n)) return idx;
  if (idx < 0 && idx >= -n) return -1 - idx;
  if (idx >= n && idx - n < n) return 2 * n - 1 - idx;
  const int period = 2 * n;
  int m = idx % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

// a 4-byte asynchronous copy from global to shared memory (no register,
// no wait: a warp issues a whole box before the first value lands)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one row of a box by the copy engine: `bytes` (a multiple of 16) from
// `src` to `dst` (both on 16 bytes), counted on the mbarrier `bar`
__device__ __forceinline__ void copy_bulk(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait until the mbarrier's phase of `parity` has completed; a wait that outlasts
// 2^24 polls (a copy that never lands) traps, so that a fault ends the
// launch with an error instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
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

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one output value from its four corners, in the plain version's order
__device__ __forceinline__ float blend(float a, float b, float c, float d, float fx, float gx,
                                       float fy, float gy) {
  const float top = __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx));
  const float bot = __fadd_rn(__fmul_rn(c, gx), __fmul_rn(d, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

struct Args {
  const float* img;
  const float* cy;
  const float* cx;
  float* out;
  int h, w;
  int tiles_x;      // tiles along W
  int tiles_img;    // tiles of an image
  long long tiles;  // tiles of the batch
  int box_cap;      // floats of shared memory for the box (and the staging)
  int vec;          // out rows on 16 bytes: W · C % 4 == 0 and out on 16 bytes
  int vec16;        // img rows on 16 bytes: W · C % 4 == 0 and img on 16 bytes
#ifdef WARP_PROBE_ROUTES
  unsigned long long* counts;  // tiles on the box route, on the gather route, box areas
#endif
#ifdef WARP_PROBE_STAMPS
  unsigned long long* stamps;  // (tiles, kStamps): start, extent, box, sampled, stored,
                               // %smid
#endif
};

constexpr int kStamps = 6;

// one pixel's sample point: floors, fractions and their complements
struct Point {
  int y0, x0;
  float fy, fx, gy, gx;
};

__device__ __forceinline__ Point point(float vy, float vx) {
  const float ry = floorf(vy), rx = floorf(vx);
  Point p;
  p.fy = __fsub_rn(vy, ry);
  p.fx = __fsub_rn(vx, rx);
  p.gy = __fsub_rn(1.0f, p.fy);
  p.gx = __fsub_rn(1.0f, p.fx);
  p.y0 = static_cast<int>(ry);
  p.x0 = static_cast<int>(rx);
  return p;
}

// C: channels (1 or 3); ROWS: rows a thread, the tile is (8 · ROWS) × 32.
// Across the box's fill a thread keeps only its raw coordinates: the floors
// and fractions are taken again where they are used, so that the registers
// allow WARP_MIN_BLOCKS blocks an SM.
template <int C, int ROWS>
__global__ void __launch_bounds__(kThreads, WARP_MIN_BLOCKS)
warp_tile_kernel(const Args a) {
  extern __shared__ __align__(16) float box[];
  __shared__ int red[4][kWarps];
  __shared__ uint64_t bar;  // the box's row copies, where they go by the copy engine
  constexpr int kTileH = ROWS * kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t b = t / a.tiles_img;
  const int rem = static_cast<int>(t - b * a.tiles_img);
  const int ty = rem / a.tiles_x;
  const int x0t = (rem - ty * a.tiles_x) * kTileW, y0t = ty * kTileH;
  const int x = x0t + lane;
  const int64_t hw = static_cast<int64_t>(a.h) * a.w;
  const float* img = a.img + b * hw * C;
  float* out = a.out + b * hw * C;
#ifdef WARP_PROBE_STAMPS
  unsigned long long* stamps = a.stamps + t * kStamps;
#endif
  auto stamp = [&](int k) {
#ifdef WARP_PROBE_STAMPS
    __syncthreads();
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (threadIdx.x == 0) stamps[k] = now;
#endif
  };
  stamp(0);
  if (threadIdx.x == 0) {  // before the extent's barrier, so before any copy
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar)) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // (a) coordinates (all loads in flight before the first use) and the
  // block's extent of their floors
  float vy[ROWS], vx[ROWS];
  bool valid[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0t + warp + i * kWarps;
    valid[i] = x < a.w && y < a.h;
    const int64_t p = b * hw + static_cast<int64_t>(valid[i] ? y : 0) * a.w + (valid[i] ? x : 0);
    vy[i] = __ldg(a.cy + p);
    vx[i] = __ldg(a.cx + p);
  }
  int ymn = INT_MAX, ymx = INT_MIN, xmn = INT_MAX, xmx = INT_MIN;
#ifndef WARP_PROBE_FLOOR
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!valid[i]) continue;
    const int fy0 = static_cast<int>(floorf(vy[i])), fx0 = static_cast<int>(floorf(vx[i]));
    ymn = min(ymn, fy0);
    ymx = max(ymx, fy0);
    xmn = min(xmn, fx0);
    xmx = max(xmx, fx0);
  }
#endif
  float res[ROWS][C];
#ifdef WARP_PROBE_FLOOR
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int ch = 0; ch < C; ++ch) res[i][ch] = __fadd_rn(vy[i], vx[i]);
#else
  ymn = __reduce_min_sync(0xffffffffu, ymn);
  ymx = __reduce_max_sync(0xffffffffu, ymx);
  xmn = __reduce_min_sync(0xffffffffu, xmn);
  xmx = __reduce_max_sync(0xffffffffu, xmx);
  if (lane == 0) {
    red[0][warp] = ymn;
    red[1][warp] = ymx;
    red[2][warp] = xmn;
    red[3][warp] = xmx;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    ymn = min(ymn, red[0][v]);
    ymx = max(ymx, red[1][v]);
    xmn = min(xmn, red[2][v]);
    xmx = max(xmx, red[3][v]);
  }
  stamp(1);
  // the box holds rows ymin .. ymax + 1 and columns xmin .. xmax + 1; every
  // tile has a valid pixel, so ymn <= ymx and xmn <= xmx
  const long long by = static_cast<long long>(ymx) - ymn + 2;
  const long long bx = static_cast<long long>(xmx) - xmn + 2;
#ifdef WARP_PROBE_GATHER
  const bool boxed = false;
#else
  const bool boxed = by <= a.box_cap && bx <= a.box_cap && by * bx * C <= a.box_cap;
#endif
#ifdef WARP_PROBE_ROUTES
  if (threadIdx.x == 0) {
    atomicAdd(a.counts + (boxed ? 0 : 1), 1ull);
    if (boxed) atomicAdd(a.counts + 2, static_cast<unsigned long long>(by * bx));
  }
#endif

  if (boxed) {
    // (b) the box route: fill, then sample from shared memory. A box whose
    // columns lie inside the image, where W · C % 4 == 0, comes row by row
    // through the copy engine (cp.async.bulk, one thread a row), each row
    // widened to 16-byte bounds in both memories (still inside the image
    // row) and `shift` floats before the box's first column; any other box
    // comes a warp a row by 4-byte cp.async copies, all in flight at once.
    int bxc = static_cast<int>(bx) * C, shift = 0;
    const int nby = static_cast<int>(by);
    const bool cols_inside = xmn >= 0 && xmx + 1 < a.w;
    const int s0 = xmn * C, stride = (((xmx + 2) * C + 3) & ~3) - (s0 & ~3);
#ifdef WARP_PROBE_NO_BULK
    const bool bulk = false;
#else
    const bool bulk = a.vec16 && cols_inside && nby * stride <= a.box_cap;
#endif
    if (bulk) {
      bxc = stride;
      shift = s0 & 3;
      if (threadIdx.x == 0) bar_expect(&bar, static_cast<uint32_t>(nby * stride * 4));
      for (int r = threadIdx.x; r < nby; r += kThreads)
        copy_bulk(box + r * stride,
                  img + static_cast<int64_t>(reflect(ymn + r, a.h)) * a.w * C + (s0 & ~3),
                  static_cast<uint32_t>(stride * 4), &bar);
      bar_wait(&bar, 0);
    }
    for (int r = bulk ? nby : warp; r < nby; r += kWarps) {
      const float* src = img + static_cast<int64_t>(reflect(ymn + r, a.h)) * a.w * C;
      float* dst = box + r * bxc;
      if (cols_inside) {
        src += static_cast<int64_t>(xmn) * C;
        for (int k = lane; k < bxc; k += 32) copy_async(dst + k, src + k);
      } else {
        for (int k = lane; k < bxc; k += 32) {
          const int q = k / C, ch = k - q * C;
          copy_async(dst + k, src + static_cast<int64_t>(reflect(xmn + q, a.w)) * C + ch);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    stamp(2);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (!valid[i]) continue;
      const Point q = point(vy[i], vx[i]);
      const float* p = box + (q.y0 - ymn) * bxc + shift + (q.x0 - xmn) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        res[i][ch] = blend(p[ch], p[C + ch], p[bxc + ch], p[bxc + C + ch], q.fx, q.gx, q.fy, q.gy);
    }
  } else {
    // (c) the gather route: the corners from global memory
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (!valid[i]) continue;
      const Point q = point(vy[i], vx[i]);
      const int r0 = reflect(q.y0, a.h), r1 = reflect(q.y0 + 1, a.h);
      const int c0 = reflect(q.x0, a.w), c1 = reflect(q.x0 + 1, a.w);
      const float* pa = img + (static_cast<int64_t>(r0) * a.w + c0) * C;
      const float* pb = img + (static_cast<int64_t>(r0) * a.w + c1) * C;
      const float* pc = img + (static_cast<int64_t>(r1) * a.w + c0) * C;
      const float* pd = img + (static_cast<int64_t>(r1) * a.w + c1) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        res[i][ch] = blend(__ldg(pa + ch), __ldg(pb + ch), __ldg(pc + ch), __ldg(pd + ch),
                           q.fx, q.gx, q.fy, q.gy);
    }
  }
#endif

  // (d) stage the tile in shared memory, then store it row by row
  __syncthreads();  // every read of the box is done
  stamp(3);
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int ch = 0; ch < C; ++ch) box[((warp + i * kWarps) * kTileW + lane) * C + ch] = res[i][ch];
  __syncthreads();
  const int ncols = min(kTileW, a.w - x0t), nrows = min(kTileH, a.h - y0t);
  float* dst = out + (static_cast<int64_t>(y0t) * a.w + x0t) * C;
  const int64_t row = static_cast<int64_t>(a.w) * C;
  if (ncols == kTileW && a.vec) {
    constexpr int kQ = kTileW * C / 4;  // 16-byte pieces of a row
    for (int e = threadIdx.x; e < nrows * kQ; e += kThreads) {
      const int r = e / kQ, q = e - r * kQ;
      reinterpret_cast<float4*>(dst + r * row)[q] = reinterpret_cast<const float4*>(box)[e];
    }
  } else {
    const int n = ncols * C;
    for (int e = threadIdx.x; e < nrows * n; e += kThreads) {
      const int r = e / n, k = e - r * n;
      dst[r * row + k] = box[r * kTileW * C + k];
    }
  }
  stamp(4);
#ifdef WARP_PROBE_STAMPS
  if (threadIdx.x == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[kStamps - 1] = sm;
  }
#endif
}

template <int C, int ROWS>
int launch_tile(const Args& a, int box_bytes, cudaStream_t s) {
  auto* kernel = warp_tile_kernel<C, ROWS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, box_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch to report
    return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(a.tiles), kThreads, box_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (B, H, W, C), cy/cx (B, H, W), out (B, H, W, C); all f32, contiguous.
// C = 1 and 3 only, with tiles of tile_h (16 or 32) × 32 pixels and
// box_bytes of shared memory a block (a multiple of 16, at least the tile's
// staging of tile_h · 32 · C floats, at most 227 KB). Returns the
// cudaError_t of the launch (0 on success); the probe checks the arguments.
extern "C" int warp_bilinear_launch(const void* img, const void* cy, const void* cx, void* out,
                                    long long batch, int h, int w, int c, int tile_h,
                                    int box_bytes,
#ifdef WARP_PROBE_ROUTES
                                    void* counts,
#endif
#ifdef WARP_PROBE_STAMPS
                                    void* stamps,
#endif
                                    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (c != 1 && c != 3) return static_cast<int>(cudaErrorInvalidValue);
  if ((tile_h != 16 && tile_h != 32) || box_bytes % 16 || box_bytes > kMaxBox ||
      box_bytes < tile_h * kTileW * c * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long tiles_img = static_cast<long long>(tiles_x) * ((h + tile_h - 1) / tile_h);
  if (tiles_img * batch > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(img), static_cast<const float*>(cy),
         static_cast<const float*>(cx), static_cast<float*>(out), h, w, tiles_x,
         static_cast<int>(tiles_img), tiles_img * batch, box_bytes / 4,
         static_cast<long long>(w) * c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0,
         static_cast<long long>(w) * c % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0};
#ifdef WARP_PROBE_ROUTES
  a.counts = static_cast<unsigned long long*>(counts);
#endif
#ifdef WARP_PROBE_STAMPS
  a.stamps = static_cast<unsigned long long*>(stamps);
#endif
  if (c == 1) return tile_h == 16 ? launch_tile<1, 2>(a, box_bytes, s)
                                  : launch_tile<1, 4>(a, box_bytes, s);
  return tile_h == 16 ? launch_tile<3, 2>(a, box_bytes, s) : launch_tile<3, 4>(a, box_bytes, s);
}
