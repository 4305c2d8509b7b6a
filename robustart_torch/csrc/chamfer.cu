// Capped chamfer distance propagation, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_motion.py::chamfer_pallas (the Pallas
// TPU kernel, pl.pallas_call at :278), the distance transform of spatter's
// water mask (robustart_tpu/noise/corruptions/jax_kernels.py::
// _chamfer_distance :458). For maps dist0 (B, H, W) f32, `iters` Jacobi
// rounds of
//
//   d'[i, j] = min(cap, d[i, j], min_k (d[i + dy_k, j + dx_k] + w_k))
//
// over the 16 offsets of the 5x5 chamfer mask (weights 1, sqrt 2, sqrt 5),
// where a neighbour outside the image contributes `cap`. Each round reads
// the previous round's map whole. The weights come from the host as the
// float32 values of 1, sqrt(2) and sqrt(5). The result is bitwise the plain
// version's (ops/motion.py::chamfer_reference).
//
// Bound: operations. Per pixel and round the function takes 16 candidates
// and the centre; the map is read once and written once a call (51 MB at
// B = 128, 224^2), which at 3.35 TB/s is a fifth of the f32 instruction
// time of 12 rounds.
//
// Two routes, chosen by shape in ops/motion.py::chamfer_plan:
//
// 1. The cluster route, one launch a call (chamfer_cluster_kernel). A
//    cluster of n ∈ {1, 2, 4, 8} blocks holds one image: each block a band
//    of ceil(H / n) rows, plus 2 halo rows above and below and `cap`
//    columns on both sides, in two ping-pong f32 buffers in shared memory
//    (at 224^2: n = 2, 2 · 116 rows × 232 columns × 4 B = 215,296 B). The
//    band is read from device memory once (cp.async) and the last round is
//    written to it straight from registers, so a call moves the map in and
//    out once instead of once a round. A round:
//    - each thread computes 4 adjacent columns down a strip of kStrip rows
//      from a window of 5 rows × 8 columns in registers that slides down
//      the strip (an 8-byte, a 16-byte and an 8-byte shared load a row);
//    - the 16 candidates fall in three weight classes, and since rounding
//      x + w to nearest is monotone in x, fl(min_S d + w) = min_S fl(d + w)
//      exactly: each class takes the minimum of its neighbours, then one
//      __fadd_rn of that neighbour and its weight. The pair minima
//      min(d[i-1][c], d[i+1][c]) and min(d[i-2][c], d[i+2][c]) serve the
//      4 columns together. 3 adds and 13.5 mins a pixel, against the plain
//      version's 16 adds and 17 mins, and the same bits;
//    - the block syncs; then each block pushes its first two and last two
//      rows into its neighbours' halo rows of the buffer just written, with
//      st.async on the neighbour's mbarrier (16 bytes a store), and waits on
//      its own mbarrier for theirs. A block pushes round r's rows only after
//      its own round r, and it received the neighbour's round r-1 rows
//      before that, which the neighbour sent after its round r-1 read the
//      buffer now written: so no row is overwritten before it is read, with
//      no cluster barrier a round.
//    Rows past H and columns past W stay `cap` in both buffers and are never
//    written. The plain version offers cap + w_k from outside the image; the
//    final min(·, cap) makes that `cap`, so the bits are the same.
// 2. The round route (chamfer_round_kernel), for maps whose band does not
//    fit a cluster of 8 (about 465^2 and above): one launch a round, one
//    thread a pixel; the caller ping-pongs between the output and a scratch
//    map so that the last round writes the output. The kernel of the port's
//    first slice, kept as it was.
//
// Binding: plain C entry points (chamfer_round_launch, one round;
// chamfer_cluster_launch, one call) called through ctypes; each makes one
// launch on the caller's stream and returns its cudaError_t.
//
// Built with -DCHAMFER_STAMPS (scripts/probe_torch_chamfer.py builds such a
// copy apart; the port never does), the cluster kernel also records
// %globaltimer stamps of each block, behind a block barrier each, and
// chamfer_cluster_launch takes their buffer before the stream.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chamfer_round_kernel(const float* __restrict__ src, float* __restrict__ dst, int h, int w,
                     float cap, float w0, float w1, float w2) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int i = static_cast<int>(pix / w), j = static_cast<int>(pix % w);
  const float* map = src + static_cast<int64_t>(blockIdx.y) * hw;
  // the offsets in the order of jax_kernels._CHAMFER_OFFSETS: 4 at weight
  // w0, 4 at w1, 8 at w2; the loop unrolls, so every index is a constant
  const int dys[16] = {0, 0, 1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 2, 2, -2, -2};
  const int dxs[16] = {1, -1, 0, 0, 1, -1, 1, -1, 2, -2, 2, -2, 1, -1, 1, -1};
  float best = map[pix];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int y = i + dys[k], x = j + dxs[k];
    const float wk = k < 4 ? w0 : (k < 8 ? w1 : w2);
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const float cand =
        inside ? __fadd_rn(__ldg(map + static_cast<int64_t>(y) * w + x), wk) : cap;
    best = fminf(best, cand);
  }
  dst[static_cast<int64_t>(blockIdx.y) * hw + pix] = fminf(best, cap);
}

// ------------------------------------------------------ the cluster route --
constexpr int kStrip = 14;       // output rows a thread computes a round
constexpr int kMaxThreads = 512;
constexpr int kPad = 4;          // buffer columns left of the image (2 read; data on 16 bytes)
constexpr int kMaxSmem = 232448; // bytes a block may have on sm_90

struct Args {
  const float* dist0;  // (B, H, W)
  float* out;          // (B, H, W)
  int h, w;
  int band;    // rows a block computes (the last block may have fewer)
  int wp;      // floats a buffer row: kPad + 4 · groups + 4
  int groups;  // column groups of 4
  int strips;  // strips of kStrip rows a band
  int iters;
  int vec;     // dist0 and out rows on 16 bytes: W % 4 == 0, both bases aligned
  float cap, w0, w1, w2;
#ifdef CHAMFER_STAMPS
  unsigned long long* stamps;  // (B · n, 2·iters + 3): start, loaded, each round's
                               // compute and exchange, %smid
#endif
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
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
// outlasts 2^24 polls (a push that never lands) traps, so that a fault ends
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

// the address in the shared memory of the cluster's block `rank` of what
// `p` addresses in this block's
__device__ __forceinline__ uint32_t peer_u32(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// v into a peer block's shared memory at `dst`, counted on its mbarrier
// `bar` (both cluster addresses) as 16 bytes of its transaction
__device__ __forceinline__ void push_to_peer(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// buffer row `q`'s 8 columns of image columns c0 - 2 ... c0 + 5
__device__ __forceinline__ void load_row(const float* row, float (&v)[8]) {
  const float2 a = *reinterpret_cast<const float2*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 2);
  const float2 c = *reinterpret_cast<const float2*>(row + 6);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = b.z; v[5] = b.w; v[6] = c.x; v[7] = c.y;
}

__global__ void __launch_bounds__(kMaxThreads, 1) chamfer_cluster_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int rows_buf = a.band + 4;
  const int buf_floats = rows_buf * a.wp;  // buffer 1 follows buffer 0
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 2 * buf_floats);
  const int n = static_cast<int>(gridDim.x);  // the cluster's blocks: the image's bands
  const int rank = static_cast<int>(blockIdx.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int r0 = rank * a.band;  // the band's first image row
  const int rows = max(0, min(a.band, a.h - r0));
  const int64_t hw = static_cast<int64_t>(a.h) * a.w;
  const float* src_img = a.dist0 + static_cast<int64_t>(blockIdx.y) * hw;
  float* out_img = a.out + static_cast<int64_t>(blockIdx.y) * hw;
#ifdef CHAMFER_STAMPS
  const int nst = 2 * a.iters + 3;
  unsigned long long* stamps = a.stamps + (static_cast<int64_t>(blockIdx.y) * n + rank) * nst;
#endif
  auto stamp = [&](int k) {
#ifdef CHAMFER_STAMPS
    __syncthreads();
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (tid == 0) stamps[k] = t;
#endif
  };
  stamp(0);

  // buffer row q is image row r0 - 2 + q and buffer column c image column
  // c - kPad; what lies outside the image is cap in both buffers. The band
  // and its halo rows come into buffer 0 by cp.async; buffer 1 starts cap.
  const int units = a.wp / 4;
  const float4 cap4 = make_float4(a.cap, a.cap, a.cap, a.cap);
  for (int u = tid; u < rows_buf * units; u += blockDim.x) {
    const int q = u / units, ic = 4 * (u % units) - kPad;
    const int ir = r0 - 2 + q;
    reinterpret_cast<float4*>(smem + buf_floats)[u] = cap4;
    float* dst = smem + 4 * u;
    const bool row_in = ir >= 0 && ir < a.h;
    const float* src = src_img + static_cast<int64_t>(ir) * a.w + ic;
    if (a.vec && row_in && ic >= 0 && ic + 4 <= a.w) {
      cp_async16(dst, src);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (row_in && ic + e >= 0 && ic + e < a.w) {
        cp_async4(dst + e, src + e);
      } else {
        dst[e] = a.cap;
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peers' buffers and mbarriers are ready before anything is pushed
  if (n > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  stamp(1);

  const int items = a.groups * a.strips;
  for (int r = 0; r < a.iters; ++r) {
    const float* s = smem + (r & 1) * buf_floats;
    float* d = smem + ((r & 1) ^ 1) * buf_floats;
    const bool last = r == a.iters - 1;
    for (int item = tid; item < items; item += blockDim.x) {
      const int c0 = 4 * (item % a.groups);  // image column of the thread's first pixel
      const int q0 = 2 + (item / a.groups) * kStrip;
      const int q1 = min(q0 + kStrip, 2 + rows);
      if (q0 >= q1) continue;
      // window rows q - 2 ... q + 2 at ring slots k % 5 ... (k + 4) % 5
      const float* col = s + c0 + kPad - 2;
      float win[5][8];
#pragma unroll
      for (int t = 0; t < 4; ++t) load_row(col + (q0 - 2 + t) * a.wp, win[t]);
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        const int q = q0 + k;
        if (q >= q1) break;
        load_row(col + (q + 2) * a.wp, win[(k + 4) % 5]);
        const float(&up2)[8] = win[k % 5];
        const float(&up1)[8] = win[(k + 1) % 5];
        const float(&mid)[8] = win[(k + 2) % 5];
        const float(&dn1)[8] = win[(k + 3) % 5];
        const float(&dn2)[8] = win[(k + 4) % 5];
        float v1[8], v2[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v1[e] = fminf(up1[e], dn1[e]);
#pragma unroll
        for (int e = 1; e < 7; ++e) v2[e] = fminf(up2[e], dn2[e]);
        float o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int x = p + 2;
          // weight w0: (0, ±1), (±1, 0); w1: (±1, ±1); w2: (±1, ±2), (±2, ±1)
          const float m0 = fminf(fminf(mid[x - 1], mid[x + 1]), v1[x]);
          const float m1 = fminf(v1[x - 1], v1[x + 1]);
          const float m2 = fminf(fminf(v1[x - 2], v1[x + 2]), fminf(v2[x - 1], v2[x + 1]));
          const float cand = fminf(fminf(__fadd_rn(m0, a.w0), __fadd_rn(m1, a.w1)),
                                   __fadd_rn(m2, a.w2));
          o[p] = c0 + p < a.w ? fminf(fminf(mid[x], a.cap), cand) : a.cap;
        }
        if (!last) {
          *reinterpret_cast<float4*>(d + q * a.wp + c0 + kPad) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
          float* g = out_img + static_cast<int64_t>(r0 - 2 + q) * a.w + c0;
          if (a.vec && c0 + 4 <= a.w) {
            *reinterpret_cast<float4*>(g) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              if (c0 + p < a.w) g[p] = o[p];
            }
          }
        }
      }
    }
    stamp(2 + 2 * r);
    if (last) break;
    __syncthreads();
    if (n == 1) continue;
    // the first two rows up into the upper block's bottom halo (its rows
    // band + 2, band + 3), the last two down into the lower block's top
    // halo (its rows 0, 1), counted on the peer's mbarrier of buffer d
    const int j = (r & 1) ^ 1;
    const int per = 2 * units;  // 16-byte units of two rows
    if (tid == 0) {
      const int peers = (rank > 0) + (rank < n - 1);
      mbar_expect_tx(bar + j, static_cast<uint32_t>(peers * per * 16));
    }
    for (int u = tid; u < 2 * per; u += blockDim.x) {
      const bool down = u >= per;
      const int peer = down ? rank + 1 : rank - 1;
      if (peer < 0 || peer >= n) continue;
      const int v = 4 * (down ? u - per : u);
      const int from = (down ? a.band : 2) * a.wp + v;
      const int to = (down ? 0 : a.band + 2) * a.wp + v;
      push_to_peer(peer_u32(d + to, static_cast<uint32_t>(peer)),
                   *reinterpret_cast<const float4*>(d + from),
                   peer_u32(bar + j, static_cast<uint32_t>(peer)));
    }
    mbar_wait(bar + j, static_cast<uint32_t>((r >> 1) & 1));
    stamp(3 + 2 * r);
  }
#ifdef CHAMFER_STAMPS
  if (tid == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[nst - 1] = sm;
  }
#endif
  // every push into this block was awaited above, so no block leaves while
  // a peer may still write to it
}

}  // namespace

// One round of the round route: dst (B, H, W) f32 from src, contiguous and
// distinct. Returns the cudaError_t of the launch (0 on success).
extern "C" int chamfer_round_launch(const void* src, void* dst, long long batch, int h, int w,
                                    float cap, float w0, float w1, float w2, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  chamfer_round_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), h, w, cap, w0, w1, w2);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route, one launch. dist0, out (B, H, W) f32, contiguous and
// distinct; the plan of ops/motion.py::chamfer_plan: cluster n, band, wp,
// groups, strips, threads and the dynamic shared bytes, any other refused.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chamfer_cluster_launch(const void* dist0, void* out, long long batch, int h, int w,
                                      float cap, float w0, float w1, float w2, int iters,
                                      int cluster, int band, int wp, int groups, int strips,
                                      int threads, int smem_bytes,
#ifdef CHAMFER_STAMPS
                                      void* stamps,
#endif
                                      void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const long long need = 2LL * (band + 4) * wp * 4 + 16;
  if (batch > 65535 || iters < 1 || (cluster != 1 && cluster != 2 && cluster != 4 &&
                                     cluster != 8) ||
      band < 1 || (cluster > 1 && band < 2) || static_cast<long long>(band) * cluster < h ||
      groups != (w + 3) / 4 || wp != kPad + 4 * groups + 4 ||
      strips != (band + kStrip - 1) / kStrip || threads < 32 || threads > kMaxThreads ||
      threads % 32 || smem_bytes != need || smem_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(dist0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Args a{static_cast<const float*>(dist0), static_cast<float*>(out), h, w, band, wp, groups,
         strips, iters, vec ? 1 : 0, cap, w0, w1, w2};
#ifdef CHAMFER_STAMPS
  a.stamps = static_cast<unsigned long long*>(stamps);
#endif
  cudaError_t err = cudaFuncSetAttribute(chamfer_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(batch));
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
  err = cudaLaunchKernelEx(&cfg, chamfer_cluster_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
