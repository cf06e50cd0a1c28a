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
// Noise: Philox4x32-10 written into the kernel, counter = (voxel/4 as two
// words, sample, draw), key = the 64-bit seed the wrapper passes in device
// memory, so there is no generator state to set up and no host sync to
// read a seed. One Philox call gives 4 uniforms = two Box-Muller pairs =
// 4 normals for 4 consecutive elements; Rician takes a second call (draw 1)
// for n2. u1 is clamped at 1e-12 before the log, as _normal_pair does.
//
// What bounds it on the H100: one read and one write of the batch. At the
// flagship batch (4 x 128x128x32, 2,097,152 elements) that is 8.4 MB in
// bf16 and 16.8 MB in f32: 2.5 us and 5.0 us at 3.35 TB/s. The arithmetic
// is about 30 f32 operations per element (two of them log/exp for gamma,
// and per Rician element one log, one sqrt and one sincos for Box-Muller,
// one sqrt for the magnitude) plus about 50 integer operations for the
// Philox rounds: well under the bytes at the card's f32 rate, though the
// special-function and integer pipes come within a factor of two of it.
// The design: a grid-stride loop, 16-byte vector loads and stores (8 bf16
// or 4 f32 per thread), parameters read once per element group from a
// [B, 6] f32 array, f32 arithmetic, output in the input dtype.
//
// C interface (loaded with ctypes): each launcher enqueues one kernel on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Philox4 {
  uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  Philox4 out;
  out.v[0] = c0;
  out.v[1] = c1;
  out.v[2] = c2;
  out.v[3] = c3;
  return out;
}

// uint32 -> uniform in [0, 1) through the mantissa, as _uniform_from_bits
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// 4 standard normals from one Philox call (two Box-Muller pairs)
__device__ __forceinline__ void normals4(uint32_t group_lo, uint32_t group_hi,
                                         uint32_t sample, uint32_t draw,
                                         uint32_t k0, uint32_t k1,
                                         float n[4]) {
  Philox4 r = philox4x32_10(group_lo, group_hi, sample, draw, k0, k1);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float u1 = fmaxf(uniform01(r.v[2 * p]), 1e-12f);
    float u2 = uniform01(r.v[2 * p + 1]);
    float rad = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincospif(2.0f * u2, &s, &c);
    n[2 * p] = rad * c;
    n[2 * p + 1] = rad * s;
  }
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
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

// x, out: [B, n] contiguous, n a multiple of Vec<T>::N; par: [B, 6] f32;
// seed: one 64-bit key in device memory.
template <typename T, bool NOISE, bool RICIAN>
__global__ void __launch_bounds__(THREADS)
    intensity_aug_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ par,
                         const unsigned long long* __restrict__ seed, int B,
                         long long n) {
  using V = Vec<T>;
  const long long vecs_per_sample = n / V::N;
  const long long total = vecs_per_sample * B;
  uint32_t k0 = 0, k1 = 0;
  if (NOISE) {
    unsigned long long s = *seed;
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const auto* xin = reinterpret_cast<const typename V::Raw*>(x);
  auto* o = reinterpret_cast<typename V::Raw*>(out);
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < total;
       v += (long long)gridDim.x * THREADS) {
    const int b = (int)(v / vecs_per_sample);
    const long long first = (v - (long long)b * vecs_per_sample) * V::N;
    const float* p = par + 6 * b;
    const float lo = p[0], hi = p[1], gamma = p[2], scale = p[3],
                shift = p[4], sigma = p[5];
    const float span = fmaxf(hi - lo, 1e-6f);
    float f[V::N];
    V::unpack(xin[v], f);
#pragma unroll
    for (int i = 0; i < V::N; ++i) {
      float unit = fmaxf((f[i] - lo) / span, 1e-6f);
      unit = expf(gamma * logf(unit));
      f[i] = (unit * span + lo) * scale + shift;
    }
    if (NOISE && sigma > 0.0f) {
#pragma unroll
      for (int q = 0; q < V::N / 4; ++q) {
        const unsigned long long group = (unsigned long long)(first / 4 + q);
        float n1[4];
        normals4((uint32_t)group, (uint32_t)(group >> 32), (uint32_t)b, 0u, k0,
                 k1, n1);
        if (RICIAN) {
          float n2[4];
          normals4((uint32_t)group, (uint32_t)(group >> 32), (uint32_t)b, 1u,
                   k0, k1, n2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = f[4 * q + i] + sigma * n1[i];
            float c = sigma * n2[i];
            f[4 * q + i] = sqrtf(a * a + c * c);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) f[4 * q + i] += sigma * n1[i];
        }
      }
    }
    o[v] = V::pack(f);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* par, const void* seed, int B,
           long long n, int noise, int rician, int n_sm, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long total = (long long)B * (n / Vec<T>::N);
  long long blocks = (total + THREADS - 1) / THREADS;
  const long long cap = (long long)n_sm * 8;  // 8 resident blocks per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* pp = static_cast<const float*>(par);
  const auto* sp = static_cast<const unsigned long long*>(seed);
  dim3 grid((unsigned)blocks);
  if (!noise)
    intensity_aug_kernel<T, false, false><<<grid, THREADS, 0, st>>>(xp, op, pp, sp, B, n);
  else if (rician)
    intensity_aug_kernel<T, true, true><<<grid, THREADS, 0, st>>>(xp, op, pp, sp, B, n);
  else
    intensity_aug_kernel<T, true, false><<<grid, THREADS, 0, st>>>(xp, op, pp, sp, B, n);
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
