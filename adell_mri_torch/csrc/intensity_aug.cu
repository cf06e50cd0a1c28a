// Fused intensity augmentation: gamma contrast, scale/shift and Gaussian or
// Rician noise in one pass over a batch of volumes, per-sample parameters.
//
// Replaces adell_mri_tpu/ops/pallas/intensity.py:_batch_kernel (K3, from
// fused_intensity_aug_batch) and, as its B=1 call, :_kernel (K2, from
// fused_intensity_aug). Per element of sample b, with par[b] = (lo, hi,
// gamma, scale, shift, sigma):
//
//   span = max(hi - lo, 1e-6)
//   y    = (max((x - lo) / span, 1e-6) ^ gamma) * span + lo
//   y    = y * scale + shift
//   y    = y + sigma * n1                           (Gaussian), or
//   y    = sqrt((y + sigma*n1)^2 + (sigma*n2)^2)     (Rician, sigma > 0 only)
//
// Where a sample's sigma is 0 its noise is skipped altogether, so a Rician
// magnitude never rectifies the negative voxels of a sample whose noise
// gate did not fire (as the TPU kernel's where(sigma > 0, ...)).
//
// Noise: Philox4x32-10 written into the kernel, counter = (element/4 as
// two words, sample, draw), key = the 64-bit seed the wrapper passes in
// device memory, so there is no generator state to set up and no host sync
// to read a seed. One Philox call gives 4 uniforms ((bits >> 9) | 1.0f,
// minus 1) = two Box-Muller pairs = 4 normals for 4 consecutive elements;
// Rician takes a second call (draw 1) for n2. u1 is clamped at 1e-12; a
// pair is sqrt(-2 ln u1) (cos, sin)(2 pi u2). The plain version
// (ops/kernels/intensity.py) draws the same stream, so the two agree
// element by element.
//
// What bounds it on the H100: one read and one write of the batch. At the
// flagship batch (4 x 128x128x32, 2,097,152 elements) that is 8.4 MB in
// bf16 and 16.8 MB in f32: 2.5 us and 5.0 us at 3.35 TB/s. What bounds it
// in fact, with noise on, is the instruction stream: a Rician element
// takes two normals (half a Philox call, 40 integer multiplies and xors)
// and seven special functions (log and exp for gamma; log, sqrt, sin, cos
// of its Box-Muller pair; the magnitude's sqrt). The design keeps that
// stream short:
// - a 2D grid: blockIdx.y is the sample, blockIdx.x walks the sample's
//   chunks of THREADS 16-byte vectors, one a thread; all index arithmetic
//   is 32-bit and no division by a runtime count is left in the loop;
// - the sample's parameters and the Philox key schedule are read or
//   computed once per thread (one 16-byte vector a thread and iteration
//   timed faster, cold, than two);
// - Philox's products are 32x32->64 (IMAD.WIDE.U32), ten rounds.
// The special functions take two forms, chosen by the output type. bf16
// takes them on the MUFU pipe (lg2/ex2/sqrt/sin/cos.approx.ftz in PTX, a
// reciprocal for the division, and near u1 = 1 a series for -ln u1, where
// lg2's absolute error would swamp the value): they cut the Rician loop's
// instructions by more than half (tools/sass_loop.py), within the plain
// version's tolerances, and move an output by at most one bf16 ulp where
// its f32 value lies at a rounding boundary. f32 keeps the exact forms
// (expf, logf, sqrtf, sincospif and an IEEE division, as written below),
// so its output is the same, bit for bit, as that of this kernel's first,
// grid-stride version: phase 22 of chip_smoke.py trains the GP CatNet in
// f32 for two updates, and from data that differ in the last bits that
// training can end with activations so large that its predictions move
// past the phase's 1e-3 check under rounding-level changes of the input.
//
// C interface (loaded with ctypes): each launcher enqueues one kernel on the
// given stream and returns cudaGetLastError() (cudaErrorInvalidValue for a
// sample of 2^31 elements or more, or more than 65535 samples).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// blocks an SM the grid aims for; a block walks its sample's chunks
constexpr int BLOCKS_PER_SM = 8;
constexpr int ROUNDS = 10;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float LN2 = 0.693147182f;
constexpr float TWO_PI = 6.28318548f, THREE_PI = 9.42477796f;
// below this 1 - u1, -ln(u1) takes the series
constexpr float SERIES_BELOW = 1.0f / 64.0f;

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sin_approx(float x) {
  float y;
  asm("sin.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_approx(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the key schedule, computed once per thread
struct PhiloxKey {
  uint32_t k0[ROUNDS], k1[ROUNDS];
};

__device__ __forceinline__ PhiloxKey philox_key(unsigned long long seed) {
  PhiloxKey key;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    key.k0[r] = (uint32_t)seed + (uint32_t)r * PHILOX_W0;
    key.k1[r] = (uint32_t)(seed >> 32) + (uint32_t)r * PHILOX_W1;
  }
  return key;
}

// Philox4x32-10 of the counter (c0, 0, c2, c3)
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c2, uint32_t c3,
                                        const PhiloxKey& key) {
  uint32_t c1 = 0u;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned long long p0 = (unsigned long long)PHILOX_M0 * c0;
    const unsigned long long p1 = (unsigned long long)PHILOX_M1 * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ key.k0[r];
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ key.k1[r];
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// uint32 -> 1 + u in [1, 2) through the mantissa; u is the uniform in
// [0, 1) of _uniform_from_bits
__device__ __forceinline__ float one_plus_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u);
}

// sqrt(-2 ln u1) for u1 in [1e-12, 1 - 2^-23] on the MUFU pipe:
// lg2.approx where 1 - u1 is at least 1/64, else -2 ln(1 - w) = 2w + w^2
// + 2w^3/3 + w^4/2 (relative error below 2e-8; w = 1 - u1 is exact there)
__device__ __forceinline__ float box_muller_radius_mufu(float u1) {
  const float w = 1.0f - u1;
  const float series =
      w * fmaf(w, fmaf(w, fmaf(w, 0.5f, 2.0f / 3.0f), 1.0f), 2.0f);
  return sqrt_approx(w < SERIES_BELOW ? series
                                      : -2.0f * LN2 * lg2_approx(u1));
}

// 4 standard normals from one Philox call (two Box-Muller pairs), the
// special functions on the MUFU pipe or in their exact forms
template <bool MUFU>
__device__ __forceinline__ void normals4(uint32_t group, uint32_t sample,
                                         uint32_t draw, const PhiloxKey& key,
                                         float n[4]) {
  const uint4 r = philox(group, sample, draw, key);
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float u1 = fmaxf(one_plus_uniform(bits[2 * p]) - 1.0f, 1e-12f);
    if (MUFU) {
      // 2 pi u2 - pi = 2 pi (1 + u2) - 3 pi, in [-pi, pi) where sin/cos
      // .approx hold 2^-21; the pair (cos, sin) of 2 pi u2 is minus that
      const float rad = box_muller_radius_mufu(u1);
      const float angle = fmaf(one_plus_uniform(bits[2 * p + 1]), TWO_PI,
                               -THREE_PI);
      n[2 * p] = -rad * cos_approx(angle);
      n[2 * p + 1] = -rad * sin_approx(angle);
    } else {
      const float u2 = one_plus_uniform(bits[2 * p + 1]) - 1.0f;
      const float rad = sqrtf(-2.0f * logf(u1));
      float s, c;
      sincospif(2.0f * u2, &s, &c);
      n[2 * p] = rad * c;
      n[2 * p + 1] = rad * s;
    }
  }
}

// ((x - lo) / span clamped at 1e-6) ^ gamma
template <bool MUFU>
__device__ __forceinline__ float unit_pow(float x, float lo, float span,
                                          float inv_span, float gamma) {
  if (MUFU) {
    const float unit = fmaxf((x - lo) * inv_span, 1e-6f);
    return ex2_approx(gamma * lg2_approx(unit));
  }
  const float unit = fmaxf((x - lo) / span, 1e-6f);
  return expf(gamma * logf(unit));
}

// the Rician magnitude sqrt(a^2 + c^2)
template <bool MUFU>
__device__ __forceinline__ float magnitude(float a, float c) {
  return MUFU ? sqrt_approx(a * a + c * c) : sqrtf(a * a + c * c);
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool MUFU = false;  // exact special functions
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool MUFU = true;  // special functions on MUFU
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static Raw pack(const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

// x, out: [gridDim.y, vecs] 16-byte vectors; par: [gridDim.y, 6] f32;
// seed: one 64-bit key in device memory.
template <typename T, bool NOISE, bool RICIAN>
__global__ void __launch_bounds__(THREADS)
    intensity_aug_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ par,
                         const unsigned long long* __restrict__ seed,
                         int vecs) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int GROUPS = V::N / 4;  // Philox calls a vector and draw
  const int b = blockIdx.y;
  const float* p = par + 6 * b;
  const float lo = p[0], gamma = p[2], scale = p[3], shift = p[4],
              sigma = p[5];
  const float span = fmaxf(p[1] - lo, 1e-6f);
  const float inv_span = 1.0f / span;
  PhiloxKey key;
  if (NOISE) key = philox_key(*seed);
  const size_t base = (size_t)b * (size_t)vecs;
  const Raw* xin = reinterpret_cast<const Raw*>(x) + base;
  Raw* o = reinterpret_cast<Raw*>(out) + base;
  const int stride = gridDim.x * THREADS;
  int v = blockIdx.x * THREADS + threadIdx.x;
  Raw raw = v < vecs ? __ldg(xin + v) : Raw{};
#pragma unroll 1
  for (; v < vecs; v += stride) {
    float f[V::N];
    V::unpack(raw, f);
#pragma unroll
    for (int i = 0; i < V::N; ++i)
      f[i] = (unit_pow<V::MUFU>(f[i], lo, span, inv_span, gamma) * span +
              lo) * scale + shift;
    if (NOISE && sigma > 0.0f) {
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) {
        const uint32_t group = (uint32_t)(v * GROUPS + q);
        float n1[4];
        normals4<V::MUFU>(group, (uint32_t)b, 0u, key, n1);
        if (RICIAN) {
          float n2[4];
          normals4<V::MUFU>(group, (uint32_t)b, 1u, key, n2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = f[4 * q + i] + sigma * n1[i];
            const float c = sigma * n2[i];
            f[4 * q + i] = magnitude<V::MUFU>(a, c);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) f[4 * q + i] += sigma * n1[i];
        }
      }
    }
    o[v] = V::pack(f);
    const int next = v + stride;
    raw = next < vecs ? __ldg(xin + next) : Raw{};
  }
}

template <typename T>
int launch(const void* x, void* out, const void* par, const void* seed, int B,
           long long n, int noise, int rician, int n_sm, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < Vec<T>::N || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int vecs = (int)(n / Vec<T>::N);
  const int chunks = (vecs + THREADS - 1) / THREADS;
  // BLOCKS_PER_SM blocks an SM over the whole grid; a block loops over
  // the chunks its x index strides to
  const int cap = (n_sm * BLOCKS_PER_SM + B - 1) / B;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), (unsigned)B);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* pp = static_cast<const float*>(par);
  const auto* sp = static_cast<const unsigned long long*>(seed);
  if (!noise)
    intensity_aug_kernel<T, false, false><<<grid, THREADS, 0, st>>>(
        xp, op, pp, sp, vecs);
  else if (rician)
    intensity_aug_kernel<T, true, true><<<grid, THREADS, 0, st>>>(
        xp, op, pp, sp, vecs);
  else
    intensity_aug_kernel<T, true, false><<<grid, THREADS, 0, st>>>(
        xp, op, pp, sp, vecs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adell_intensity_aug_bf16(const void* x, void* out,
                                        const void* par, const void* seed,
                                        int B, long long n, int noise,
                                        int rician, int n_sm, void* stream) {
  return launch<__nv_bfloat16>(x, out, par, seed, B, n, noise, rician, n_sm,
                               stream);
}

extern "C" int adell_intensity_aug_f32(const void* x, void* out,
                                       const void* par, const void* seed,
                                       int B, long long n, int noise,
                                       int rician, int n_sm, void* stream) {
  return launch<float>(x, out, par, seed, B, n, noise, rician, n_sm, stream);
}
