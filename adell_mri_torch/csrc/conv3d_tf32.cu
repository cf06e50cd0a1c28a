// 3x3x3 stride-1 SAME 3D convolution forward in f32, channels-last, for
// Hopper: three TF32 tensor-core products per f32 product (3xTF32).
//
// Replaces adell_mri_tpu/ops/pallas/conv.py:_kernel (the TPU's implicit-GEMM
// conv) for f32 inputs, the type the CLI trains and serves in unless told
// otherwise (--precision defaults to 32). Same function:
//
//   out[b,z,y,x,co] = bias[co] + sum_{tap,ci} x[b,z+dz,y+dy,x+dx,ci] * w[tap,ci,co]
//
// with f32 sums, as the TPU kernel's jnp.dot(..., preferred_element_type=
// f32). The input gradient (dx) is the same function of the cotangent and
// the flipped, channel-swapped weight, so it launches the same kernel.
//
// What bounds it on the H100: operations. f32 outside the tensor cores runs
// at 67 TFLOP/s; the 29 f32 convs of a U-Net window batch (B=4, 128x128x32)
// do about 1300 GFLOP, 19.4 ms at that rate. The tensor cores multiply TF32
// (a 10-bit mantissa) at 494.7 TFLOP/s, and one TF32 pass keeps only about
// three decimal digits (3e-4 of the output scale). 3xTF32 keeps f32's:
// each f32 operand v is split into big = tf32(v) and small = tf32(v - big),
// and a * b is taken as small_a big_b + big_a small_b + big_a big_b (the
// dropped small_a small_b is 2^-22 of the product), three TF32 products at
// 494.7 / 3 = 165 TFLOP/s: 7.9 ms for the same 1300 GFLOP.
//
// conv3d_wgmma_tf32x3_kernel (Cin a multiple of 8, Cout of 8, not narrow)
// is conv3d_wgmma_bf16_kernel's design (csrc/conv3d_igemm.cu) carried over
// byte for byte where it can be:
//   - a block owns a BOX of output voxels (64 a warpgroup; the wrapper picks
//     it with plan_box within the limits adell_conv3d_wgmma_tf32x3_limits
//     gives) and loads its input HALO of one channel chunk once, with
//     zero-filling 16-byte cp.async copies. f32 chunks of 8, 16 or 32
//     channels are halo rows of 32, 64 or 128 bytes (padded by 16), the
//     bf16 kernel's rows of 16, 32 and 64 channels; the 27 taps read their
//     shifted rows from shared memory;
//   - the A operand of a tap, 16 rows by 8 channels a warp, comes from the
//     same ldmatrix.x4 as bf16's 16 x 16: a k-step of 8 f32 is the 32 bytes
//     of 16 bf16, and the four 8 x 8 b16 matrices give lane l the f32 values
//     (l/4, l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4) of its
//     warp's rows, which is wgmma m64nNk8's TF32 A fragment;
//   - each A value is split in registers right after the load, both halves
//     rounded explicitly with cvt.rna.tf32.f32 (nothing is left to how the
//     tensor core reads the low 13 bits);
//   - TF32 wgmma reads B K-major only, so the wrapper prepares the weight
//     once a call as [2, 27, Cout_pad, Cin] f32: big and small, each
//     rounded to TF32, Cout padded to whole N blocks with zeros. A tap's
//     slab is N rows of the chunk's channels, a swizzled K-major tile
//     (wgmma.cuh's Tile of 2 CK bf16 widths; N = 16, 32 or 64 a block, a
//     wider Cout in several blocks), streamed with the next chunk's halo
//     through a cp.async ring whose stages hold G taps' big and small slabs
//     (G * CK * N >= TAP_WORK products, G at most 9 taps, so that a
//     chunk's halo is never loaded late or over the one in use);
//   - a k-step is three `wgmma` m64nNk8 .tf32 products into the same
//     register sums, small * big and big * small first, then big * big;
//     each tap's products are one group, waited for one tap later, and the
//     first and last turns are fixed by unrolling, so that ptxas does not
//     serialize the products;
//   - the tensor cores' own f32 sums drop low bits at every product they
//     add, so their error grows with the number of products a sum takes
//     (on the H100, one sum a channel chunk, 27 taps, came to 0.94 of the
//     1e-5 bound at the flagship's widths, nine taps to 0.51). So the
//     tensor cores sum nine taps (a plane of the 3x3x3 stencil) at a time,
//     and each such sum is added to an f32 register sum rounded to
//     nearest; the pipeline drains at each add, which tune_conv could not
//     tell from the drain every 27;
//   - the epilogue adds the bias in f32 and stores f32; no atomics, so a
//     run gives the same bits every time.
//
// C interface (loaded with ctypes): the launcher enqueues one kernel on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {
namespace tf32 {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
// Two warpgroups a block (64 output voxels each), a weight ring of four
// stages, and at least 512 products (G * CK * NB) a ring stage before a
// barrier is paid for it: on the H100, one warpgroup, three stages and 256
// or 1024 products were each slower or no faster (PERF.md).
constexpr int THREADS = 256;
constexpr int VOXELS = 128;  // output voxels a block
constexpr int STAGES = 4;
constexpr int TAP_WORK = 512;
// halo rows of the box the ring must leave room for, twice: a 4x4x8 box
// (6 x 6 x 10), the smallest halo of 128 voxels
constexpr int MIN_HALO_ROWS = 360;
// Taps whose products one tensor-core sum takes before it is added to the
// f32 register sums: the tensor cores' f32 sums drop low bits at each
// product they add, so their error grows with the products a sum takes.
constexpr int SUM_TAPS = 9;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The launch's geometry: the volume, the box a block owns and its halo.
struct Geometry {
  int D, H, W, Cin, Cout;
  int cout_pad;        // rows of the prepared weight: Cout in whole N blocks
  int tz, ty, tx;      // box
  int nbz, nby, nbx;   // boxes along each axis
  int hy, hx;          // halo extents along y and x (ty + 2, tx + 2)
  int halo_rows;       // (tz + 2) * hy * hx
  int n_chunks;        // Cin / CK
};

// Shared memory of the kernel for a channel chunk CK and an N
// block NB. A tap's weight is two slabs (big and small) of NB rows of CK
// f32. A ring stage holds G taps, G the fewest of 1, 3 and 9 whose
// products G * CK * NB reach TAP_WORK (nine taps of the smallest pair, 8 x
// 16, are 1152): a chunk then has at least three ring steps, more than the
// STAGES - 2 the ring loads ahead, and the next chunk's halo goes with the
// load of its first step, so a chunk of fewer steps would have its halo
// loaded late, or into the buffer the chunk before it still reads. The
// ring must leave room for two halo buffers of MIN_HALO_ROWS rows.
template <int CK, int NB>
struct Plan {
  static constexpr int ROW_BYTES = 4 * CK + 16;  // halo row, padded
  static constexpr int G = CK * NB >= TAP_WORK       ? 1
                           : 3 * CK * NB >= TAP_WORK ? 3
                                                     : 9;
  static constexpr int SLAB = NB * CK * 4;     // big or small rows of a tap
  static constexpr int TAP_BYTES = 2 * SLAB;
  static constexpr int STEPS = 27 / G;         // ring steps a chunk
  static_assert(G * CK * NB >= TAP_WORK, "a stage's products");
  static_assert(STEPS >= STAGES - 2, "a chunk must outlast the ring's lead");
  static constexpr int STAGE_BYTES = round_up(G * TAP_BYTES, 1024);
  static_assert(STAGES * STAGE_BYTES +
                        2 * round_up(MIN_HALO_ROWS * ROW_BYTES, 128) + 1024 <=
                    MAX_SMEM,
                "the ring and two halo buffers of a 4x4x8 box must fit");

  static int smem(int halo_rows, int n_chunks) {
    const int bufs = n_chunks > 1 ? 2 : 1;
    return STAGES * STAGE_BYTES + bufs * round_up(halo_rows * ROW_BYTES, 128) +
           1024;
  }
  // the most halo rows whose buffers fit beside the ring
  static int max_halo_rows(int n_chunks) {
    const int bufs = n_chunks > 1 ? 2 : 1;
    const int room = (MAX_SMEM - smem(0, n_chunks)) / bufs / 128 * 128;
    return room / ROW_BYTES;
  }
};

// v, hidden from the optimizer: the fully unrolled tap loop would otherwise
// keep 27 per-tap offsets live across the chunk loop.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// d (+)= A B for one k-step of 8 channels of one tap: the three TF32
// products, B the tap's K-major big and small slabs at shared address slab;
// with fresh, the first overwrites d.
template <int CK, int NB>
__device__ __forceinline__ void tap_products(float (&d)[NB / 2],
                                             const uint32_t (&big)[4],
                                             const uint32_t (&small)[4],
                                             uint32_t slab, int kk,
                                             bool fresh) {
  using namespace hopper;
  using T = Tile<2 * CK>;  // rows of 4 CK bytes
  const uint32_t k_off = kk * 32;
  const uint64_t b_big = T::desc(slab + k_off);
  const uint64_t b_small = T::desc(slab + Plan<CK, NB>::SLAB + k_off);
  wgmma_tf32(d, small, b_big, fresh ? 0 : 1);
  wgmma_tf32(d, big, b_small, 1);
  wgmma_tf32(d, big, b_big, 1);
}

template <int CK, int NB>
__global__ void __launch_bounds__(THREADS)
    conv3d_wgmma_tf32x3_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, Geometry s) {
  using namespace hopper;
  using P = Plan<CK, NB>;
  using T = Tile<2 * CK>;
  constexpr int NTH = THREADS, G = P::G;
  constexpr int KSTEPS = CK / 8;
  constexpr int CPR = CK / 4;  // 16-byte chunks of a halo or weight row
  constexpr int W_COPIES = G * 2 * NB * CPR;  // of a ring step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sW = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sHalo = sW + STAGES * P::STAGE_BYTES;
  const uint32_t halo_bytes = round_up(s.halo_rows * P::ROW_BYTES, 128);

  const int tid = threadIdx.x, lane = tid % 32;
  const int wrow = tid / 128 * 64 + (tid % 128) / 32 * 16;  // warp's 1st row
  int blk = blockIdx.x;
  const int x0 = blk % s.nbx * s.tx;
  blk /= s.nbx;
  const int y0 = blk % s.nby * s.ty;
  blk /= s.nby;
  const int z0 = blk % s.nbz * s.tz;
  const int b = blk / s.nbz;
  const int n0 = blockIdx.y * NB;
  const int cin = s.Cin, cout = s.Cout;
  const size_t vol = (size_t)s.D * s.H * s.W;
  // the small half of the prepared weight follows the big one
  const float* w_small = w + (size_t)27 * s.cout_pad * cin;

  // Chunk c of the halo: row (hz, hy, hx) is voxel (z0 + hz - 1, ...).
  auto load_halo = [&](int c, uint32_t buf) {
    const float* xc = x + (size_t)b * vol * cin + c * CK;
    for (int i = tid; i < s.halo_rows * CPR; i += NTH) {
      const int row = i / CPR, ch = i % CPR;
      const int hx = row % s.hx, t2 = row / s.hx;
      const int hy = t2 % s.hy, hz = t2 / s.hy;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool ok = (unsigned)gz < (unsigned)s.D &&
                      (unsigned)gy < (unsigned)s.H &&
                      (unsigned)gx < (unsigned)s.W;
      const size_t v = ok ? ((size_t)gz * s.H + gy) * s.W + gx : 0;
      cp_async_16(buf + row * P::ROW_BYTES + ch * 16, xc + v * cin + ch * 4,
                  ok);
    }
  };
  // Big and small weight rows n0 .. n0 + NB - 1 of taps t0 .. t0 + G - 1 of
  // chunk c; zeros when !live (a step past the end, which no product reads).
  auto load_w = [&](int c, int t0, uint32_t st, bool live) {
#pragma unroll
    for (int i0 = 0; i0 < W_COPIES; i0 += NTH) {
      const int i = i0 + opaque(tid);
      if (W_COPIES % NTH == 0 || i < W_COPIES) {
        const int j = i % CPR, r = i / CPR % NB;
        const int part = i / (CPR * NB) % 2, g = i / (2 * CPR * NB);
        const size_t row = (size_t)(t0 + g) * opaque(s.cout_pad) + n0 + r;
        const float* src = part ? w_small : w;
        cp_async_16(st + g * P::TAP_BYTES + part * P::SLAB + T::offset(r, j),
                    src + (live ? row * cin + c * CK + j * 4 : 0), live);
      }
    }
  };

  // this lane's ldmatrix row (of its warp's 16) and its halo address
  const int arow = wrow + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int vz = arow / (s.ty * s.tx), vy = arow / s.tx % s.ty;
  const int vx = arow % s.tx;
  const uint32_t a_off =
      (((vz + 1) * s.hy + vy + 1) * s.hx + vx + 1) * P::ROW_BYTES +
      (lane >> 4) * 16;
  const int plane = s.hy * s.hx * P::ROW_BYTES, line = s.hx * P::ROW_BYTES;

  int load_stage = 0, use_stage = 0;
  auto next = [](int st) { return st + 1 == STAGES ? 0 : st + 1; };
  // prologue: the first chunk's halo and the first STAGES - 2 steps
  load_halo(0, sHalo);
#pragma unroll
  for (int u = 0; u < STAGES - 2; ++u) {
    const int c = u / P::STEPS, t0 = u % P::STEPS * G;
    load_w(c, t0, sW + load_stage * P::STAGE_BYTES, c < s.n_chunks);
    load_stage = next(load_stage);
    cp_async_commit();
  }

  // the f32 sums, rounded to nearest, and the tensor cores' sum of the
  // current SUM_TAPS taps, added to them when its products are done
  float acc[NB / 2], part[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // a tap's A fragments, big and small, alternating between two sets
  uint32_t big[2][KSTEPS][4], small[2][KSTEPS][4];

  for (int c = 0; c < s.n_chunks; ++c) {
    const uint32_t halo = sHalo + (c & 1) * halo_bytes + a_off;
#pragma unroll
    for (int j = 0; j < P::STEPS; ++j) {
      // step c * STEPS + j has landed; every thread is done with step - 2
      cp_async_wait<STAGES - 3>();
      fence_async_proxy();
      __syncthreads();
      const int ahead = j + STAGES - 2;  // the step loaded now
      const int lc = c + ahead / P::STEPS, lj = ahead % P::STEPS;
      const bool live = lc < s.n_chunks;
      if (lj == 0 && live) load_halo(lc, sHalo + (lc & 1) * halo_bytes);
      load_w(lc, lj * G, sW + load_stage * P::STAGE_BYTES, live);
      load_stage = next(load_stage);
      cp_async_commit();
      const uint32_t st = sW + use_stage * P::STAGE_BYTES;
      use_stage = next(use_stage);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int t = j * G + g;
        const int shift = (t / 9 - 1) * opaque(plane) +
                          (t / 3 % 3 - 1) * opaque(line) +
                          (t % 3 - 1) * P::ROW_BYTES;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t raw[4];
          ldmatrix_x4(raw, halo + shift + kk * 32);
          split(raw, big[t & 1][kk], small[t & 1][kk]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          tap_products<CK, NB>(part, big[t & 1][kk], small[t & 1][kk],
                               st + g * P::TAP_BYTES, kk,
                               t % SUM_TAPS == 0 && kk == 0);
        wg_commit();
        if (t % SUM_TAPS == SUM_TAPS - 1) {
          wg_wait<0>();
          reg_fence(part);
#pragma unroll
          for (int i = 0; i < NB / 2; ++i) acc[i] += part[i];
        } else {
          wg_wait<1>();
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows 16 w + lane / 4 and that + 8 of the warp's accumulator
  const int r_lo = wrow + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const int oz = z0 + r / (s.ty * s.tx), oy = y0 + r / s.tx % s.ty;
    const int ox = x0 + r % s.tx;
    if (oz >= s.D || oy >= s.H || ox >= s.W) continue;
    float* o = out + ((size_t)b * vol + ((size_t)oz * s.H + oy) * s.W + ox) *
                         cout;
#pragma unroll
    for (int q = 0; q < NB / 8; ++q) {
      const int col = n0 + 8 * q + 2 * (lane % 4);
      if (col >= cout) continue;
      float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if (bias != nullptr) {
        v0 += bias[col];
        v1 += bias[col + 1];
      }
      *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
    }
  }
}

template <int CK, int NB>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           const Geometry& s, cudaStream_t st) {
  using P = Plan<CK, NB>;
  auto kernel = conv3d_wgmma_tf32x3_kernel<CK, NB>;
  const int smem = P::smem(s.halo_rows, s.n_chunks);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((unsigned)B * s.nbz * s.nby * s.nbx, s.cout_pad / NB);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

template <int CK, int NB>
int limits_of(int n_chunks, int cout, int* out) {
  out[0] = VOXELS;
  out[1] = Plan<CK, NB>::max_halo_rows(n_chunks);
  out[2] = round_up(cout, NB);
  return 0;
}

// The channel chunk of the halo (the largest of 32, 16, 8 that divides
// Cin) and the N block (Cout padded to 16, 32 or 64; a wider Cout takes
// several blocks of 64, which fill the small levels' grids better than
// blocks of 128 and keep the sums, the A fragments and their split within
// the registers).
int chunk_of(int Cin) { return Cin % 32 == 0 ? 32 : Cin % 16 == 0 ? 16 : 8; }
int n_block_of(int Cout) { return Cout <= 16 ? 16 : Cout <= 32 ? 32 : 64; }

// The (CK, NB) pairs the kernel is built for.
#define ADELL_TF32_DISPATCH(CK, NB, CALL)                  \
  switch (CK * 1000 + NB) {                                \
    case 8016: return CALL(8, 16);                         \
    case 8032: return CALL(8, 32);                         \
    case 8064: return CALL(8, 64);                         \
    case 16016: return CALL(16, 16);                       \
    case 16032: return CALL(16, 32);                       \
    case 16064: return CALL(16, 64);                       \
    case 32016: return CALL(32, 16);                       \
    case 32032: return CALL(32, 32);                       \
    case 32064: return CALL(32, 64);                       \
    default: return (int)cudaErrorInvalidValue;            \
  }

// Whether Cin -> Cout is the kernel's: both multiples of 8 (so never a
// narrow conv, which has a side of at most 4 channels).
bool takes(int cin, int cout) {
  return cin >= 8 && cin % 8 == 0 && cout >= 8 && cout % 8 == 0;
}

}  // namespace tf32
}  // namespace

// The 3xTF32 kernel (f32, Cin and Cout multiples of 8): x [B,D,H,W,Cin], w
// the prepared weight [2, 27, Cout_pad, Cin] (big then small, rounded to
// TF32, Cout_pad as adell_conv3d_wgmma_tf32x3_limits gives it), bias [Cout]
// or null, out [B,D,H,W,Cout]; the box (tz, ty, tx) comes from the wrapper
// (ops/kernels/conv.py: plan_box) within those limits.
extern "C" int adell_conv3d_wgmma_tf32x3(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int D, int H, int W, int Cin,
                                         int Cout, int tz, int ty, int tx,
                                         void* stream) {
  using tf32::Geometry;
  if (tz < 1 || ty < 1 || tx < 1 ||
      tz * ty * tx != tf32::VOXELS || !tf32::takes(Cin, Cout))
    return (int)cudaErrorInvalidValue;
  const int ck = tf32::chunk_of(Cin), nb = tf32::n_block_of(Cout);
  Geometry s;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.cout_pad = tf32::round_up(Cout, nb);
  s.tz = tz;
  s.ty = ty;
  s.tx = tx;
  s.nbz = (D + tz - 1) / tz;
  s.nby = (H + ty - 1) / ty;
  s.nbx = (W + tx - 1) / tx;
  s.hy = ty + 2;
  s.hx = tx + 2;
  s.halo_rows = (tz + 2) * s.hy * s.hx;
  s.n_chunks = Cin / ck;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define ADELL_TF32_LAUNCH(CK, NB) \
  tf32::launch<CK, NB>(x, w, bias, out, B, s, st)
  ADELL_TF32_DISPATCH(ck, nb, ADELL_TF32_LAUNCH)
#undef ADELL_TF32_LAUNCH
}

// What the wrapper needs for Cin -> Cout: out[0], the output voxels of a box
// (128); out[1], the most halo rows that fit in shared memory
// beside the weight ring; out[2], Cout_pad, the rows of the prepared
// weight (Cout in whole N blocks).
extern "C" int adell_conv3d_wgmma_tf32x3_limits(int Cin, int Cout, int* out) {
  if (!tf32::takes(Cin, Cout)) return (int)cudaErrorInvalidValue;
  const int ck = tf32::chunk_of(Cin), nb = tf32::n_block_of(Cout);
#define ADELL_TF32_LIMITS(CK, NB) \
  tf32::limits_of<CK, NB>(Cin / CK, Cout, out)
  ADELL_TF32_DISPATCH(ck, nb, ADELL_TF32_LIMITS)
#undef ADELL_TF32_LIMITS
}
