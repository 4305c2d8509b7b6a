// Motion blur as a per-image list of weighted, edge-clamped taps, for
// Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_motion.py::motion_taps_pallas (the
// Pallas TPU kernel, pl.pallas_call at :114), which motion_blur (C = 3) and
// snow's layer (C = 1) run once per image. For a batch img (B, H, W, C) f32
// and per-image tap rows dy, dx (B, T) int32 and wt (B, T) f32:
//
//   out[b, i, j, :] = sum_t wt[b, t] * img[b, clamp(i + dy[b, t]), clamp(j + dx[b, t]), :]
//
// summed in tap order from 0 with f32 accumulation; clamp is to [0, H-1]
// and [0, W-1] (edge replicate). The rows come from the (angles, T) table of
// robustart_torch/ops/motion.py::angle_tap_table, picked on the device by
// each image's angle index; rows are zero-padded to a common T, and a
// zero-weight tap adds an exact 0.
//
// Bound: memory (the image read once and written once, 154 MB at B = 128,
// 224^2, C = 3). But the taps read each source pixel T times, 21 taps x 3
// channels at motion_blur's severity 5. Gathered from L1 at a 12-byte pixel
// stride, those reads cost at least 3 L1 wavefronts a channel and tap for a
// warp, which held a thread-a-pixel kernel at 28% of the byte bound. From a
// box in shared memory they cost one, so this design's floors are the
// shared reads (4 · C bytes a pixel and tap) and the box traffic from L2.
//
// Design. The TPU kernel rolls an edge-padded VMEM window for each tap.
// Here the output is cut into 32 x 32 tiles (ops/motion.py::motion_plan
// mirrors the grid), and a persistent block of 256 threads walks a
// contiguous run of them, image by image, tile row by tile row. For each
// image it meets, warp 0 loads the tap row, clamps dy to [-H, H] and dx to
// [-W, W] (every pixel's index then clamps alike), reduces their least and
// greatest values and writes each tap's offset into a tile's source box and
// its weight to shared memory. The box is the tile widened by the spans of
// dy and dx: rows [r0 + min dy, r0 + 31 + max dy] x columns [c0 + min dx,
// c0 + 31 + max dx], in unclamped coordinates, channel-interleaved as the
// image is, filled through the clamp (element (y, x, ch) is
// img[clamp(y), clamp(x), ch]), which gives every tap the value a per-tap
// clamp would. Two boxes alternate: the next tile's is in flight while the
// taps of this one run. Its rows start `shift` floats early, on 16 bytes
// (where W · C % 4 == 0), and it comes by the copy engine where it can, so
// that the fill takes no load slot from the taps:
//   - a box inside the image: one tensor copy (cp.async.bulk.tensor of the
//     launch's box, which holds every image's; on an mbarrier);
//   - a box whose rows clamp: 16-byte cp.async, each row from its clamped
//     source row;
//   - a box whose columns clamp: 4-byte cp.async through the clamp.
// A thread sums 4 pixels of one column, rows 8 apart: per tap one broadcast
// load of (offset, weight), then C shared loads, C multiplies and C adds a
// pixel, with no clamp and no 64-bit arithmetic. A warp's loads of one
// channel are 32 consecutive pixels of a box row, 32 distinct banks at C =
// 1 and 3 (gcd(3, 32) = 1), one wavefront each. An image whose box exceeds
// the launch's budget (a tap row of far offsets; none on the path) gathers
// from global memory with the clamps instead: the route is chosen per
// image, inside the kernel. Measured (scripts/probe_torch_motion.py,
// PERF.md): a block a tile, and each fill without the tensor copy, were
// slower; so were 32 x 64 tiles, tiles strided over the blocks, output rows
// staged for the copy engine and a bulk copy a row (copies of the kernel
// not kept).
//
// Every float step is a _rn intrinsic so that nvcc contracts no multiply and
// add into one FMA: the plain PyTorch version (robustart_torch/ops/motion.py)
// rounds after each step and sees the same numbers, bit for bit.
//
// Binding: a plain C entry point (motion_taps_launch) that the Python
// wrapper calls through ctypes; it launches on the caller's stream and
// returns cudaGetLastError() of the launch.
//
// Probe builds (scripts/probe_torch_motion.py builds them apart; the port
// never does): -DMOTION_PROBE_ROUTES adds a counts argument (box tiles,
// gathering tiles, box floats filled); -DMOTION_PROBE_SKIP_FILL,
// _SKIP_TAPS and _SKIP_STORES leave out the boxes' fill, the taps (each
// pixel takes its box element) and the stores, as the probe's split;
// -DMOTION_PROBE_TILE_BLOCKS launches a block a tile;
// -DMOTION_PROBE_NO_TENSOR fills no box by the tensor copy, and
// -DMOTION_PROBE_NO_ALIGN every box by 4-byte cp.async.

#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;
constexpr int kTileH = 32;  // ops/motion.py: MOTION_TILE
constexpr int kTileW = 32;  // a warp's lanes are the tile's columns
constexpr int kRows = kTileH / (kThreads / 32);  // pixels a thread, 8 rows apart
// the most dynamic shared memory a block may take (two boxes), less the
// static arrays; a box is a multiple of 128 bytes, the tensor copy's unit
constexpr int kMaxBoxesBytes = 232448 - 4096;
// blocks an SM that ptxas must leave registers for: 4 at C = 3 (64
// registers a thread; two boxes at severity 5 leave room for 3), 6 at C = 1
// (40); ops/motion.py: MOTION_MIN_BLOCKS
template <int C> constexpr int kMinBlocks = C == 1 ? 6 : 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts 2^24 polls (a copy that never lands) traps, so that a fault ends
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

// a tile's place: image n, tile row ty, tile column tx
struct Tile {
  int n, ty, tx;
  __device__ __forceinline__ Tile next(int tiles_y, int tiles_x) const {
    Tile t = *this;
    if (++t.tx == tiles_x) {
      t.tx = 0;
      if (++t.ty == tiles_y) t.ty = 0, ++t.n;
    }
    return t;
  }
};

// per image, in one of two sets: the clamped offsets, (box offset, weight
// bits) of each tap, and the box (least dy, least dx, columns, rows or 0
// where the image gathers, row pitch in floats, whether the launch's
// tensor-map box holds it)
struct Taps {
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  int2 tap[kMaxTaps];
  int box[6];
};

// C: channels (1 or 3). I: the type of an offset within one image (int
// where H · W · C fits).
template <int C, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>)
motion_taps_kernel(const float* __restrict__ img, const int* __restrict__ dy,
                   const int* __restrict__ dx, const float* __restrict__ wt,
                   float* __restrict__ out, int h, int w, int taps, int tiles_y, int tiles_x,
                   int total, int box_floats, bool aligned,
                   const __grid_constant__ CUtensorMap map, int map_rows, int map_pitch
#ifdef MOTION_PROBE_ROUTES
                   , unsigned long long* counts
#endif
) {
  extern __shared__ __align__(128) float s_boxes[];  // two boxes of box_floats
  __shared__ Taps s_taps[2];
  __shared__ uint64_t s_bar[2];  // a box's tensor copy lands on its mbarrier
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = tiles_y * tiles_x;
  // this block's run of tiles [first, last) of the B · tiles, in order
  const int first = static_cast<int>(static_cast<int64_t>(blockIdx.x) * total / gridDim.x);
  const int last = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * total / gridDim.x);

  // warp 0: image n's tap row into set q: offsets clamped to [-H, H] x
  // [-W, W], their extent, the box and each tap's offset in it
  auto load_taps = [&](int n, int q) {
    Taps& s = s_taps[q];
    int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN;
    const int64_t row = static_cast<int64_t>(n) * taps;
    for (int t = lane; t < taps; t += 32) {
      const int y = clampi(dy[row + t], -h, h), x = clampi(dx[row + t], -w, w);
      s.dy[t] = y;
      s.dx[t] = x;
      lo_y = min(lo_y, y), hi_y = max(hi_y, y), lo_x = min(lo_x, x), hi_x = max(hi_x, x);
    }
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    if (taps == 0) lo_y = hi_y = lo_x = hi_x = 0;
    // a row of the box: cols · C floats after a shift of up to 3 floats (a
    // tile's own, fill's choice), the pitch a multiple of 4 floats: the
    // tensor map's where its box holds the image's, else the image's own
    const int rows = kTileH + hi_y - lo_y, cols = kTileW + hi_x - lo_x;
    const bool mapped = map_rows > 0 && rows <= map_rows && cols * C + 3 <= map_pitch;
    const int pitch = mapped ? map_pitch : (cols * C + 6) & ~3;
    const bool boxed = static_cast<int64_t>(rows) * pitch <= box_floats;
    for (int t = lane; t < taps; t += 32)
      s.tap[t] = make_int2(boxed ? (s.dy[t] - lo_y) * pitch + (s.dx[t] - lo_x) * C : 0,
                           __float_as_int(wt[row + t]));
    if (lane == 0) {
      s.box[0] = lo_y, s.box[1] = lo_x, s.box[2] = cols, s.box[3] = boxed ? rows : 0;
      s.box[4] = pitch, s.box[5] = mapped;
    }
  };

  // every thread: issue the fill of tile p's box (tap set `set`) into box
  // buffer q; box element (row, col) of cols · C floats, at row · pitch +
  // shift + col, is img[n, clamp(y0 + row), clamp(x0 + col / C), col % C].
  // Returns the tile's shift times 2, plus 1 where the box comes by the
  // tensor copy (on s_bar[q]).
  auto fill = [&](const Tile& p, int set, int q) -> int {
    const Taps& s = s_taps[set];
    const int rows = s.box[3];
#ifdef MOTION_PROBE_ROUTES
    if (threadIdx.x == 0) {
      atomicAdd(counts + (rows ? 0 : 1), 1ull);
      atomicAdd(counts + 2, static_cast<unsigned long long>(rows) * s.box[2] * C);
    }
#endif
#ifdef MOTION_PROBE_SKIP_FILL
    return 0;
#endif
    if (rows == 0) return 0;
    const int y0 = p.ty * kTileH + s.box[0], x0 = p.tx * kTileW + s.box[1];
    const int cols = s.box[2], pitch = s.box[4];
    const float* base = img + static_cast<int64_t>(p.n) * h * w * C;
    float* box = s_boxes + q * box_floats;
    const bool inside_x = x0 >= 0 && x0 + cols <= w;
    // a row's 16-byte-aligned superset starts `shift` floats before it
    const int shift = aligned ? (x0 * C) & 3 : 0;
    if (s.box[5] && inside_x && y0 >= 0 && y0 + rows <= h) {
      // the whole box in one tensor copy from x0 · C - shift (a copy from
      // an unaligned column never completes); rows and columns past the
      // ones the image needs may fall outside the tensor and come as zeros
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_u32(s_bar + q)),
                     "r"(static_cast<uint32_t>(map_rows * map_pitch * 4))
                     : "memory");
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(box)),
            "l"(reinterpret_cast<uint64_t>(&map)), "r"(x0 * C - shift), "r"(y0), "r"(p.n),
            "r"(smem_u32(s_bar + q))
            : "memory");
      }
      return 2 * shift + 1;
    }
    if (inside_x && aligned) {
      // rows of pitch floats from x0 · C - shift, inside the image row
      // since W · C % 4 == 0, by 16-byte copies
      const int quads = pitch / 4, chunks = rows * quads;
      for (int k = threadIdx.x; k < chunks; k += kThreads) {
        const int r = k / quads, f = 4 * (k - r * quads);
        const float* src =
            base + (static_cast<I>(clampi(y0 + r, 0, h - 1)) * w + x0) * C - shift + f;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(box + r * pitch + f)),
                     "l"(src));
      }
      return 2 * shift;
    }
    // 4-byte copies, through the column clamp where the box overhangs
    for (int r = warp; r < rows; r += kThreads / 32) {
      const I src_row = static_cast<I>(clampi(y0 + r, 0, h - 1)) * w;
      const uint32_t dst = smem_u32(box + r * pitch + shift);
      for (int f = lane; f < cols * C; f += 32) {
        const int px = f / C, ch = f - px * C;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4u * f),
                     "l"(base + (src_row + clampi(x0 + px, 0, w - 1)) * C + ch));
      }
    }
    return 2 * shift;
  };

  if (first >= last) return;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(s_bar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Tile cur;
  cur.n = first / tiles;
  cur.ty = (first - cur.n * tiles) / tiles_x;
  cur.tx = first - cur.n * tiles - cur.ty * tiles_x;
  // tile i uses box buffer i & 1 and the tap set of its image (sets
  // alternate from image to image); the next tile's box is in flight while
  // this one's taps run
  int set = 0;
  if (warp == 0) load_taps(cur.n, set);
  __syncthreads();
  uint32_t parity = 0;  // bit b: the phase of s_bar[b] the next tensor copy completes
  int fill_cur = fill(cur, set, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = first, q = 0; i < last; ++i, q ^= 1) {
    const Tile nxt = cur.next(tiles_y, tiles_x);
    int nset = set;
    int fill_nxt = 0;
    if (i + 1 < last) {
      if (nxt.n != cur.n) {
        nset = set ^ 1;
        if (warp == 0) load_taps(nxt.n, nset);
        __syncthreads();
      }
      fill_nxt = fill(nxt, nset, q ^ 1);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // this tile's box has landed: its cp.async copies, then its tensor copy
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    if (fill_cur & 1) {
      mbar_wait(s_bar + q, (parity >> q) & 1);
      parity ^= 1u << q;
    }
    __syncthreads();

    const Taps& s = s_taps[set];
    const int r0 = cur.ty * kTileH, c0 = cur.tx * kTileW;
    const int64_t image = static_cast<int64_t>(cur.n) * h * w * C;
    float acc[kRows][C];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[k][ch] = 0.0f;
    if (s.box[3]) {
      // the box route; a pixel outside the image reads the box's clamped
      // copy of the edge and is not stored
      const float* box = s_boxes + q * box_floats;
      int off[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        off[k] = (warp + 8 * k) * s.box[4] + fill_cur / 2 + lane * C;
#ifdef MOTION_PROBE_SKIP_TAPS
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[k][ch] = box[off[k] + ch];
#else
      for (int t = 0; t < taps; ++t) {
        const int2 tap = s.tap[t];
        const float wv = __int_as_float(tap.y);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float* src = box + off[k] + tap.x;
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            acc[k][ch] = __fadd_rn(acc[k][ch], __fmul_rn(wv, src[ch]));
        }
      }
#endif
    } else {
      // the gathering route: the per-tap clamps, from global memory
      const float* base = img + image;
      const int j = c0 + lane;
      for (int t = 0; t < taps; ++t) {
        const float wv = __int_as_float(s.tap[t].y);
        const I xx = clampi(j + s.dx[t], 0, w - 1);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const I yy = clampi(r0 + warp + 8 * k + s.dy[t], 0, h - 1);
          const float* src = base + (yy * w + xx) * C;
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            acc[k][ch] = __fadd_rn(acc[k][ch], __fmul_rn(wv, __ldg(src + ch)));
        }
      }
    }

    float* dst = out + image;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + warp + 8 * k, c = c0 + lane;
      if (r >= h || c >= w) continue;
#ifdef MOTION_PROBE_SKIP_STORES
      if (acc[k][0] != -1.25e-38f) continue;  // never taken: the sums stay live
#endif
      float* p = dst + (static_cast<I>(r) * w + c) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) p[ch] = acc[k][ch];
    }
    __syncthreads();  // every thread is done with this box and tap set
    cur = nxt;
    set = nset;
    fill_cur = fill_nxt;
  }
}

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

template <int C, typename I>
int launch(const float* img, const int* dy, const int* dx, const float* wt, float* out,
           long long batch, int h, int w, int taps, int box_bytes, int blocks, int map_rows,
           int map_pitch,

#ifdef MOTION_PROBE_ROUTES
           unsigned long long* counts,
#endif
           cudaStream_t s) {
  const int tiles_y = (h + kTileH - 1) / kTileH, tiles_x = (w + kTileW - 1) / kTileW;
  const long long total = static_cast<long long>(tiles_y) * tiles_x * batch;
#ifdef MOTION_PROBE_TILE_BLOCKS
  blocks = static_cast<int>(min(total, static_cast<long long>(INT_MAX)));
#endif
  if (total > INT_MAX || blocks <= 0 || blocks > total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = motion_taps_kernel<C, I>;
  // past 48 KB of static and dynamic shared memory a kernel must opt in;
  // once an instance, at the most it may take
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBoxesBytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  // the copy engine's rows need 16-byte alignment: every image row starts
  // on it where W · C % 4 == 0 and the image does
#ifdef MOTION_PROBE_NO_ALIGN
  const bool aligned = false;
#else
  const bool aligned = (static_cast<int64_t>(w) * C) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(img) % 16 == 0;
#endif
  // the image as a tensor (W · C floats, H, B) whose box is map_rows rows
  // of map_pitch floats, where the plan gives one and the rows are aligned
  CUtensorMap map = {};
#ifdef MOTION_PROBE_NO_TENSOR
  map_rows = 0;
#endif
  if (!aligned || map_rows * map_pitch * 4 > box_bytes || map_pitch % 4 || map_pitch > 256 ||
      map_rows > 256)
    map_rows = 0;
  if (map_rows > 0) {
    const EncodeTiled encode = encoder();
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w) * C, static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * C * 4,
                                   static_cast<cuuint64_t>(w) * C * 4 * h};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(map_pitch),
                               static_cast<cuuint32_t>(map_rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode == nullptr ||
        encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(img), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, kThreads, 2 * box_bytes, s>>>(img, dy, dx, wt, out, h, w, taps, tiles_y,
                                                 tiles_x, static_cast<int>(total), box_bytes / 4,
                                                 aligned, map, map_rows, map_pitch
#ifdef MOTION_PROBE_ROUTES
                                        , counts
#endif
  );
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img/out (B, H, W, C) f32 with C in {1, 3}; dy, dx (B, T) int32; wt (B, T)
// f32; all contiguous, T <= 64; box_bytes the shared memory of one tile's
// box, a multiple of 128, blocks the persistent grid, and map_rows and
// map_pitch the tensor copy's box, 0 for none (ops/motion.py::
// motion_plan). Returns the cudaError_t of the launch (0 on success).
// Argument checks are the Python wrapper's job.
extern "C" int motion_taps_launch(const void* img, const void* dy, const void* dx,
                                  const void* wt, void* out, long long batch, int h, int w,
                                  int c, int taps, int box_bytes, int blocks, int map_rows,
                                  int map_pitch,
#ifdef MOTION_PROBE_ROUTES
                                  void* counts,
#endif
                                  void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (taps < 0 || taps > kMaxTaps || (c != 1 && c != 3) || box_bytes < 0 || box_bytes % 128 ||
      2 * box_bytes > kMaxBoxesBytes || h > (1 << 29) || w > (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(img);
  const auto* y = static_cast<const int*>(dy);
  const auto* x = static_cast<const int*>(dx);
  const auto* t = static_cast<const float*>(wt);
  auto* o = static_cast<float*>(out);
#ifdef MOTION_PROBE_ROUTES
  auto* n = static_cast<unsigned long long*>(counts);
#define MOTION_COUNTS n,
#else
#define MOTION_COUNTS
#endif
  // the last offset formed within an image is below (H · W + 32 · 33) · C
  const bool small = (static_cast<int64_t>(h) * w + 32 * 33) * c <= INT_MAX;
  if (c == 1) {
    return small ? launch<1, int>(i, y, x, t, o, batch, h, w, taps, box_bytes, blocks, map_rows,
                                  map_pitch, MOTION_COUNTS s)
                 : launch<1, int64_t>(i, y, x, t, o, batch, h, w, taps, box_bytes, blocks, map_rows,
                                      map_pitch, MOTION_COUNTS s);
  }
  return small ? launch<3, int>(i, y, x, t, o, batch, h, w, taps, box_bytes, blocks, map_rows,
                                map_pitch, MOTION_COUNTS s)
               : launch<3, int64_t>(i, y, x, t, o, batch, h, w, taps, box_bytes, blocks, map_rows,
                                    map_pitch, MOTION_COUNTS s);
#undef MOTION_COUNTS
}
