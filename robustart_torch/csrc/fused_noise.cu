// Fused noise corruption + uint8 requantize + normalize, for Hopper (sm_90a).
//
// Replaces robustart_tpu/ops/pallas_noise.py::fused_noise_normalize (the
// Pallas TPU kernel, pl.pallas_call at :141). Per element of a (B, H, W, 3)
// uint8 batch:
//
//   x = u8 * (1/255)
//   x = noise(x)            gaussian | speckle | impulse | shot (Gaussian approx.)
//   k = floor(clip(x, 0, 1) * 255)
//   out = (k * (1/255) - mean[c]) / std[c]      c = flat index mod 3  (f32 / bf16)
//       | k - 128                               (int8, the int8 stem grid)
//
// Random numbers: Philox4x32-10 keyed on (seed, image index) and counted on
// the element-pair index inside the image; one call yields the two words of
// element 2p (x, y) and of element 2p+1 (z, w). Uniforms take the top 24
// bits plus half a step, so a uniform is never 0; normals are Box-Muller's
// cos branch of the two words. Keying on the image index (and not on
// seed + image, as the TPU kernel seeds its programs) keeps the streams of
// consecutive seeds apart.
//
// Bound: memory. Each element reads 1 byte and writes 1-4 bytes; the
// arithmetic (half a Philox call, logf, cosf, sqrtf) stays in registers. The
// design does one pass: four consecutive elements per thread, loaded as one
// uchar4 and stored as one vector where the image size allows it, a scalar
// tail otherwise (no lane-multiple requirement as on the TPU).
//
// Every float step is written with the _rn intrinsics so that nvcc does not
// contract a multiply and an add into one FMA: the plain PyTorch version in
// robustart_torch/ops/noise.py rounds after each step and must see the same
// numbers. The file is built without --use_fast_math for the same reason.
//
// Binding: a plain C entry point (fused_noise_launch) that the Python
// wrapper calls through ctypes; it launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

enum Noise : int { kGaussian = 0, kSpeckle = 1, kImpulse = 2, kShot = 3 };
enum OutKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

struct Params {
  float sigma;
  float lo;  // impulse: u < lo -> 0
  float hi;  // impulse: u > hi -> 1
  float mean[3];
  float std[3];
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  // (bits >> 8) * 2^-24 is exact, so the add is the only rounding
  return __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__device__ __forceinline__ float box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = uniform24(w1), u2 = uniform24(w2);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

template <int NOISE>
__device__ __forceinline__ float corrupt(float x, uint32_t w1, uint32_t w2, const Params& p) {
  if (NOISE == kGaussian) {
    return __fadd_rn(x, __fmul_rn(p.sigma, box_muller(w1, w2)));
  } else if (NOISE == kSpeckle) {
    return __fadd_rn(x, __fmul_rn(x, __fmul_rn(p.sigma, box_muller(w1, w2))));
  } else if (NOISE == kImpulse) {
    const float u = uniform24(w1);
    x = u < p.lo ? 0.0f : x;
    return u > p.hi ? 1.0f : x;
  } else {  // shot: Gaussian approximation of Poisson(x*c)/c, std sqrt(x/c)
    const float s = sqrtf(__fdiv_rn(fmaxf(x, 0.0f), p.sigma));
    return __fadd_rn(x, __fmul_rn(s, box_muller(w1, w2)));
  }
}

template <int NOISE>
__device__ __forceinline__ float level(uint8_t v, uint32_t w1, uint32_t w2, const Params& p) {
  float x = __fmul_rn(static_cast<float>(v), 0.003921568859368563f);  // f32(1/255)
  x = corrupt<NOISE>(x, w1, w2, p);
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  return floorf(__fmul_rn(x, 255.0f));
}

template <int OUT>
struct Store;

template <>
struct Store<kF32> {
  using T = float;
  static __device__ __forceinline__ T conv(float k, int c, const Params& p) {
    // selects, not p.mean[c]: a dynamic index into the parameter struct
    // would spill it to local memory
    const float m = c == 0 ? p.mean[0] : (c == 1 ? p.mean[1] : p.mean[2]);
    const float s = c == 0 ? p.std[0] : (c == 1 ? p.std[1] : p.std[2]);
    return __fdiv_rn(__fsub_rn(__fmul_rn(k, 0.003921568859368563f), m), s);
  }
  static __device__ __forceinline__ void vec(T* o, const T (&v)[4]) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Store<kBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T conv(float k, int c, const Params& p) {
    return __float2bfloat16_rn(Store<kF32>::conv(k, c, p));
  }
  static __device__ __forceinline__ void vec(T* o, const T (&v)[4]) {
    __nv_bfloat162 a, b;
    a.x = v[0]; a.y = v[1];
    b.x = v[2]; b.y = v[3];
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&a);
    packed.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(o) = packed;
  }
};

template <>
struct Store<kInt8> {
  using T = int8_t;
  static __device__ __forceinline__ T conv(float k, int, const Params&) {
    return static_cast<int8_t>(static_cast<int>(k) - 128);
  }
  static __device__ __forceinline__ void vec(T* o, const T (&v)[4]) {
    *reinterpret_cast<char4*>(o) = make_char4(v[0], v[1], v[2], v[3]);
  }
};

// grid: (ceil(n / (kThreads * kPerThread)), B); n = H * W * 3 per image.
// VEC: n % 4 == 0 and both base pointers aligned, so every thread's four
// elements are one aligned vector.
template <int NOISE, int OUT, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_noise_kernel(const uint8_t* __restrict__ in, typename Store<OUT>::T* __restrict__ out,
                   int64_t n, uint32_t seed, Params p) {
  using S = Store<OUT>;
  const uint32_t img = blockIdx.y;
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (e0 >= n) return;
  const uint8_t* src = in + static_cast<int64_t>(img) * n;
  typename S::T* dst = out + static_cast<int64_t>(img) * n;

  // e0 is even: elements e0, e0+1 share pair e0/2; e0+2, e0+3 pair e0/2+1
  const uint32_t pair = static_cast<uint32_t>(e0 >> 1);
  const uint4 r0 = philox4x32_10(make_uint4(pair, 0u, 0u, 0u), seed, img);
  const uint4 r1 = philox4x32_10(make_uint4(pair + 1u, 0u, 0u, 0u), seed, img);
  const uint32_t w1[4] = {r0.x, r0.z, r1.x, r1.z};
  const uint32_t w2[4] = {r0.y, r0.w, r1.y, r1.w};
  const int c0 = static_cast<int>(e0 % 3);

  if (VEC) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(src + e0);
    const uint8_t u8[4] = {v.x, v.y, v.z, v.w};
    typename S::T o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (c0 + j) % 3;
      o[j] = S::conv(level<NOISE>(u8[j], w1[j], w2[j], p), c, p);
    }
    S::vec(dst + e0, o);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = e0 + j;
      if (e < n) {
        const int c = (c0 + j) % 3;
        dst[e] = S::conv(level<NOISE>(src[e], w1[j], w2[j], p), c, p);
      }
    }
  }
}

template <int NOISE, int OUT>
void launch_typed(const void* in, void* out, int64_t batch, int64_t n, uint32_t seed,
                  const Params& p, bool vec, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid(static_cast<unsigned>((n + kThreads * kPerThread - 1) / (kThreads * kPerThread)),
                  static_cast<unsigned>(batch));
  using T = typename Store<OUT>::T;
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<T*>(out);
  if (vec) {
    fused_noise_kernel<NOISE, OUT, true><<<grid, block, 0, stream>>>(src, dst, n, seed, p);
  } else {
    fused_noise_kernel<NOISE, OUT, false><<<grid, block, 0, stream>>>(src, dst, n, seed, p);
  }
}

template <int NOISE>
void launch_noise(int out_kind, const void* in, void* out, int64_t batch, int64_t n,
                  uint32_t seed, const Params& p, bool vec, cudaStream_t stream) {
  switch (out_kind) {
    case kF32: launch_typed<NOISE, kF32>(in, out, batch, n, seed, p, vec, stream); break;
    case kBF16: launch_typed<NOISE, kBF16>(in, out, batch, n, seed, p, vec, stream); break;
    default: launch_typed<NOISE, kInt8>(in, out, batch, n, seed, p, vec, stream); break;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Argument checks
// (device, dtype, contiguity, sizes) are the Python wrapper's job.
extern "C" int fused_noise_launch(const void* in, void* out, long long batch, long long n,
                                  unsigned int seed, int noise, int out_kind, float sigma,
                                  float lo, float hi, float m0, float m1, float m2,
                                  float s0, float s1, float s2, int vec, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535 || noise < 0 || noise > 3 || out_kind < 0 || out_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{sigma, lo, hi, {m0, m1, m2}, {s0, s1, s2}};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  switch (noise) {
    case kGaussian: launch_noise<kGaussian>(out_kind, in, out, batch, n, seed, p, v, s); break;
    case kSpeckle: launch_noise<kSpeckle>(out_kind, in, out, batch, n, seed, p, v, s); break;
    case kImpulse: launch_noise<kImpulse>(out_kind, in, out, batch, n, seed, p, v, s); break;
    default: launch_noise<kShot>(out_kind, in, out, batch, n, seed, p, v, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
