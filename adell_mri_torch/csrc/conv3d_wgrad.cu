// Weight gradient (dW) of the 3x3x3 stride-1 SAME 3D convolution,
// channels-last, bf16, for Hopper.
//
// Replaces the dW half of adell_mri_tpu/ops/conv.py:170 _conv3d_im2col_bwd,
// the custom VJP of K1 (adell_mri_tpu/ops/pallas/conv.py:60 _kernel), which
// XLA computes outside Pallas as one product of the recomputed patch tensor
// and the cotangent. Same function:
//
//   dW[tap, ci, co] = sum_{b,z,y,x} x[b, z+dz-1, y+dy-1, x+dx-1, ci] * g[b, z, y, x, co]
//
// zero outside the volume (the SAME border), exact bf16 products summed in
// f32 and rounded once to bf16, as preferred_element_type=f32 does there.
// Unlike eager PyTorch's patch tensor ([V, 27 Cin], 27x the input: 7.5 GB at
// 64 channels on the U-Net's top level), nothing of size V x 27 Cin reaches
// device memory.
//
// What bounds it on the H100: operations. dW does 2 V 27 Cin Cout FLOP on
// V (Cin + Cout) input elements: at 32->32, 128x128x32, B=4 that is 116
// GFLOP on 268 MB (430 FLOP/byte, the card's ridge is 295), 0.117 ms at 989
// TFLOP/s. As in the forward, the input rows of the 27 taps are the same
// rows shifted, so reuse across taps decides the speed; and the operand that
// is not reused (A, the shifted input) goes through shared memory once per
// product, 2 KB per m64nNk16, which at N = 16 or 32 bounds the products
// before the tensor cores do.
//
// conv3d_wgrad_bf16_kernel (bf16, Cin a multiple of 16, Cout of 8, Cout <=
// 256) is the forward's box and halo with the GEMM turned around; two
// warpgroups a block:
//   - D[M, N] += A[M, K] B[K, N] with M = (tap, ci) rows of dW, N = Cout
//     and K = voxels: at Cout = 32 the other orientation would fill half of
//     wgmma's 64 rows (the JAX code transposes for the same reason);
//   - a block owns every (tap, ci) row of one channel chunk (CK of 16, 32
//     or 64 channels, 27 CK rows in 64-row tiles: a tile spans 4, 2 or 1
//     taps), T tiles a warpgroup, and an N block of Cout (16, 32 or 64), and
//     walks a contiguous range of boxes of 256 voxels, the box chosen by the
//     wrapper (ops/kernels/conv.py:plan_box, as for the forward) within the
//     halo that adell_conv3d_wgrad_limits reports (boxes of 128 voxels were
//     10 % slower, their halo being 2.8 times the box against 2.3): the
//     voxels are split S ways across blocks. The chunk is
//     the widest whose sums the block's registers hold (N block 16: 64
//     channels, 32: 32, 64: 16), because the halo, loaded once a box for
//     every row of the chunk, is the larger load: blocks that shared a
//     chunk's rows would each load every box's halo (at 64->64 a 64-channel
//     chunk in groups of two tiles loads it 14 times, 31 FLOP a loaded
//     byte, and is bound by the loads);
//   - for each box it loads the input halo of its chunk, (tz+2)(ty+2)(tx+2)
//     rows with zero-filling 16-byte cp.async (rows padded by 16 bytes, so
//     eight consecutive rows fall on distinct banks), and the box's
//     cotangent tile [256 voxels, N], MN-major and swizzled as wgmma reads
//     it; rows of ragged boxes outside the volume are zeros, so they add
//     nothing;
//   - A, 16 (tap, ci) rows by 16 voxels a warp, goes to registers with
//     ldmatrix.trans at per-lane addresses (the voxel's halo row shifted by
//     the warp's tap, plus its channel offset): the forward's per-lane trick
//     with voxel and channel swapped. B is the cotangent tile, read through
//     a descriptor, shared by every tile of the block;
//   - sums stay in registers (N / 2 f32 a thread a tile, at most
//     ADELL_WGRAD_ACC = 128); each 4 products (k-steps) of a tile are one
//     wgmma group, waited for one group later, so the next group's ldmatrix
//     runs while they are in flight; the turns are unrolled so that the
//     groups in flight never depend on a branch (ptxas would serialize every
//     wgmma);
//   - with two stages the next box's halo and cotangent tile load into the
//     other buffer while this box multiplies (with three, the next two);
//   - each (M group, N block, split) block writes its f32 partial [rows,
//     Cout] to a workspace [S, 27 Cin, Cout]; conv3d_wgrad_reduce_kernel sums
//     the S partials in a fixed order and rounds once. No atomics, so the
//     bf16 result has the same bits every run.
// S is the fewest splits that give ADELL_WGRAD_WAVES blocks an SM, at most
// one a box; the workspace is small next to a patch tensor (at 64->64, B=4,
// 128x128x32, S = 66: 29 MB).
//
// C interface (loaded with ctypes): adell_conv3d_wgrad_limits gives what
// the wrapper needs to pick the box, adell_conv3d_wgrad_plan reports the
// decomposition for a box (the CPU tests emulate it), and
// adell_conv3d_wgrad_bf16 enqueues both kernels on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

// Tuning knobs (tools/tune_conv.py builds the variants): warpgroups a block,
// buffers of the box loads (1: synchronous; 2 or 3: the next boxes load
// while this one multiplies), accumulator registers a thread (at N / 2 a
// tile) and the blocks an SM the voxel split aims for.
#ifndef ADELL_WGRAD_WARPGROUPS
#define ADELL_WGRAD_WARPGROUPS 2
#endif
#ifndef ADELL_WGRAD_STAGES
#define ADELL_WGRAD_STAGES 2
#endif
#ifndef ADELL_WGRAD_ACC
#define ADELL_WGRAD_ACC 128
#endif
#ifndef ADELL_WGRAD_WAVES
#define ADELL_WGRAD_WAVES 2
#endif

namespace {
namespace wgrad {

constexpr int VOX = 256;             // voxels of a box
constexpr int KSTEPS = VOX / 16;     // k-steps of 16 voxels
constexpr int GK = 4;                // k-steps of one wgmma group
constexpr int GROUPS = KSTEPS / GK;  // groups a tile a box
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
constexpr int NWG = ADELL_WGRAD_WARPGROUPS;
constexpr int STAGES = ADELL_WGRAD_STAGES;
static_assert(NWG == 1 || NWG == 2, "one or two warpgroups");
static_assert(STAGES >= 1 && STAGES <= 3, "one to three box buffers");

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// 64-row tiles of a chunk's 27 ck rows, and the tiles a warpgroup takes:
// its share of them where ADELL_WGRAD_ACC accumulator registers hold that
// many, else as many as they hold (at least one).
__host__ __device__ constexpr int chunk_tiles(int ck) {
  return (27 * ck + 63) / 64;
}
__host__ __device__ constexpr int tiles_of(int ck, int nb) {
  const int share = (chunk_tiles(ck) + NWG - 1) / NWG;
  const int fit = ADELL_WGRAD_ACC / (nb / 2);
  return fit < 1 ? 1 : fit < share ? fit : share;
}

template <int CK, int NB>
struct Plan {
  static constexpr int THREADS = 128 * NWG;
  static constexpr int T = tiles_of(CK, NB);
  static constexpr int ROW_BYTES = 2 * CK + 16;  // halo row, padded
  static constexpr int G_BYTES = VOX * NB * 2;   // cotangent tile
  static_assert(NB == 16 || NB == 32 || NB == 64, "one swizzle atom wide");
};

// The launch's geometry.
struct Geometry {
  int D, H, W, Cin, Cout;
  int tz, ty, tx;     // box
  int nbz, nby, nbx;  // boxes along each axis
  int hy, hx;         // halo extents along y and x
  int halo_rows;      // (tz + 2) * hy * hx
  int boxes;          // boxes of the batch
  int splits;         // S: voxel ranges, one a block along z
  int groups;         // groups of NWG * T tiles a chunk
};

// v, hidden from the optimizer, so that per-tile offsets are added where
// they are used and not hoisted out of the box loop into registers.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <int CK, int NB>
__global__ void __launch_bounds__(Plan<CK, NB>::THREADS)
    conv3d_wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ g,
                             float* __restrict__ ws, Geometry s) {
  using namespace hopper;
  using P = Plan<CK, NB>;
  using TB = Tile<NB>;
  constexpr int T = P::T, NTH = P::THREADS;
  constexpr int CPR = CK / 8;      // 16-byte chunks of a halo row
  constexpr int WCH = NB / 8;      // 16-byte chunks of a cotangent row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t stage_bytes =
      P::G_BYTES + round_up(s.halo_rows * P::ROW_BYTES, 1024);

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = tid % 128 / 32;
  const int c = blockIdx.x / s.groups, grp = blockIdx.x % s.groups;
  const int n0 = blockIdx.y * NB;
  const int split = blockIdx.z;
  const int box0 = (int)((long long)split * s.boxes / s.splits);
  const int box1 = (int)((long long)(split + 1) * s.boxes / s.splits);
  const int cin = s.Cin, cout = s.Cout;
  const size_t vol = (size_t)s.D * s.H * s.W;

  // Box `box` of the batch into the stage at shared address st: its
  // cotangent tile first, the chunk's input halo after it.
  auto load_box = [&](int box, uint32_t st) {
    int r = box;
    const int x0 = r % s.nbx * s.tx;
    r /= s.nbx;
    const int y0 = r % s.nby * s.ty;
    r /= s.nby;
    const int z0 = r % s.nbz * s.tz;
    const int b = r / s.nbz;
    const __nv_bfloat16* gb = g + (size_t)b * vol * cout;
#pragma unroll
    for (int i0 = 0; i0 < VOX * WCH; i0 += NTH) {
      const int i = i0 + tid;
      if (VOX * WCH % NTH == 0 || i < VOX * WCH) {
        const int v = i / WCH, j = i % WCH;
        const int gz = z0 + v / (s.ty * s.tx), gy = y0 + v / s.tx % s.ty;
        const int gx = x0 + v % s.tx, col = n0 + j * 8;
        const bool ok =
            gz < s.D && gy < s.H && gx < s.W && col < cout;
        const size_t off =
            ok ? (((size_t)gz * s.H + gy) * s.W + gx) * cout + col : 0;
        cp_async_16(st + TB::offset(v, j), gb + off, ok);
      }
    }
    const __nv_bfloat16* xc = x + (size_t)b * vol * cin + c * CK;
    const uint32_t halo = st + P::G_BYTES;
    for (int i = tid; i < s.halo_rows * CPR; i += NTH) {
      const int row = i / CPR, ch = i % CPR;
      const int hx = row % s.hx, t2 = row / s.hx;
      const int hy = t2 % s.hy, hz = t2 / s.hy;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool ok = (unsigned)gz < (unsigned)s.D &&
                      (unsigned)gy < (unsigned)s.H &&
                      (unsigned)gx < (unsigned)s.W;
      const size_t v = ok ? ((size_t)gz * s.H + gy) * s.W + gx : 0;
      cp_async_16(halo + row * P::ROW_BYTES + ch * 16, xc + v * cin + ch * 8,
                  ok);
    }
  };

  // This lane's ldmatrix row: voxel (lane % 8) + 8 (lane / 16) of a k-step,
  // channel half (lane / 8) % 2; its halo offset at tap (0, 0, 0).
  uint32_t row_off[KSTEPS];
  {
    const int lv = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int v = kk * 16 + lv;
      const int vz = v / (s.ty * s.tx), vy = v / s.tx % s.ty, vx = v % s.tx;
      row_off[kk] = ((vz * s.hy + vy) * s.hx + vx) * P::ROW_BYTES +
                    ((lane >> 3) & 1) * 16;
    }
  }
  // The warp's 16 rows of each tile: one tap (a tile's rows past the
  // chunk's 27 CK read tap 26 and are not stored) and 16 channels.
  const int tile0 = (grp * NWG + wg) * T;
  uint32_t toff[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int r = (tile0 + t) * 64 + warp * 16;
    const int tap = r / CK < 27 ? r / CK : 26;
    toff[t] = ((tap / 9 * s.hy + tap / 3 % 3) * s.hx + tap % 3) *
                  P::ROW_BYTES +
              r % CK * 2;
  }

  float acc[T][NB / 2];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[t][i] = 0.f;
  uint32_t a[2][GK][4];

  // With STAGES > 1, box k loads into buffer k % STAGES, STAGES - 1 boxes
  // ahead of the one that multiplies; one commit group a box (empty past
  // the last).
  const int nbox = box1 - box0;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nbox) load_box(box0 + k, base + k * stage_bytes);
    cp_async_commit();
  }
  for (int i = 0; i < nbox; ++i) {
    const uint32_t st = base + (i % STAGES) * stage_bytes;
    if (STAGES == 1) {
      __syncthreads();  // every warpgroup is done with the box before
      load_box(box0 + i, st);
      cp_async_commit();
    }
    // box i has landed; every warpgroup is done with box i - 1, whose
    // buffer box i + STAGES - 1 loads into
    cp_async_wait<(STAGES > 1 ? STAGES - 2 : 0)>();
    fence_async_proxy();
    __syncthreads();
    if (STAGES > 1) {
      const int k = i + STAGES - 1;
      if (k < nbox) load_box(box0 + k, base + (k % STAGES) * stage_bytes);
      cp_async_commit();
    }
    const uint32_t halo = st + P::G_BYTES;
    // group u: tile u / GROUPS, k-steps GK (u % GROUPS) ..
#pragma unroll
    for (int u = 0; u < GROUPS * T; ++u) {
      const int t = u / GROUPS, k0 = u % GROUPS * GK;
      const uint32_t at = halo + opaque(toff[t]);
#pragma unroll
      for (int k = 0; k < GK; ++k)
        ldmatrix_x4_trans(a[u & 1][k], at + row_off[k0 + k]);
      wg_fence();
#pragma unroll
      for (int k = 0; k < GK; ++k)
        wgmma_rs_mn(acc[t], a[u & 1][k],
                    TB::desc(st + (k0 + k) * 16 * TB::ROW_BYTES));
      wg_commit();
      if (u == GROUPS * T - 1)
        wg_wait<0>();
      else
        wg_wait<1>();
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int t = 0; t < T; ++t) reg_fence(acc[t]);

  // rows 16 warp + lane / 4 and that + 8 of each tile
  float* wsp = ws + (size_t)split * 27 * cin * cout;
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (tile0 + t) * 64 + warp * 16 + lane / 4 + 8 * h;
      const int tap = r / CK;
      if (tap >= 27) continue;
      float* o = wsp + ((size_t)tap * cin + c * CK + r % CK) * cout;
#pragma unroll
      for (int q = 0; q < NB / 8; ++q) {
        const int col = n0 + 8 * q + 2 * (lane % 4);
        if (col >= cout) continue;
        *reinterpret_cast<float2*>(o + col) =
            make_float2(acc[t][4 * q + 2 * h], acc[t][4 * q + 2 * h + 1]);
      }
    }
  }
}

// out[i] = bf16(sum over s of ws[s][i]), s in order: four elements a thread.
__global__ void __launch_bounds__(256)
    conv3d_wgrad_reduce_kernel(const float* __restrict__ ws,
                               __nv_bfloat16* __restrict__ out, int n,
                               int splits) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 sum = *reinterpret_cast<const float4*>(ws + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v =
        *reinterpret_cast<const float4*>(ws + (size_t)sp * n + i);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  *reinterpret_cast<uint2*>(out + i) = make_uint2(
      hopper::pack_bf16(sum.x, sum.y), hopper::pack_bf16(sum.z, sum.w));
}

// The N block (Cout padded to 16, 32 or 64; a wider Cout takes several
// blocks of 64) and the channel chunk of the halo: the largest of 64, 32,
// 16 that divides Cin and whose tiles a warpgroup's registers hold, so that
// a block takes all 27 taps of its chunk and loads each box's halo once
// (else 16).
int n_block_of(int Cout) { return Cout <= 16 ? 16 : Cout <= 32 ? 32 : 64; }
int chunk_of(int Cin, int nb) {
  for (int ck = 64; ck > 16; ck /= 2)
    if (Cin % ck == 0 &&
        tiles_of(ck, nb) * NWG >= chunk_tiles(ck))
      return ck;
  return 16;
}

// The most halo rows of a box of a chunk of ck channels that fit beside the
// cotangent tile of an N block of nb in each of the STAGES buffers.
int max_halo_rows(int ck, int nb) {
  const int room = ((MAX_SMEM - 1024) / STAGES - VOX * nb * 2) / 1024 * 1024;
  return room / (2 * ck + 16);
}

// The classes the kernel takes (in bf16): Cin a multiple of 16, Cout of 8
// and at most 256.
bool takes(int Cin, int Cout) {
  return Cin >= 16 && Cin % 16 == 0 && Cout >= 8 && Cout % 8 == 0 &&
         Cout <= 256;
}

// The launch's decomposition with the box (tz, ty, tx); false for a shape
// outside the kernel's set or a box that is not VOX voxels or whose halo
// does not fit. out (13): box z, y, x; CK; NB; T; warpgroups; tiles a
// chunk; groups a chunk; N blocks; S; boxes; shared-memory bytes.
bool plan_of(int B, int D, int H, int W, int Cin, int Cout, int tz, int ty,
             int tx, int n_sm, Geometry& s, int* out) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || n_sm < 1 || !takes(Cin, Cout) ||
      tz < 1 || ty < 1 || tx < 1 || tz * ty * tx != VOX)
    return false;
  const int nb = n_block_of(Cout), ck = chunk_of(Cin, nb);
  const int t = tiles_of(ck, nb);
  const int row_bytes = 2 * ck + 16, g_bytes = VOX * nb * 2;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.tz = tz;
  s.ty = ty;
  s.tx = tx;
  s.nbz = (D + s.tz - 1) / s.tz;
  s.nby = (H + s.ty - 1) / s.ty;
  s.nbx = (W + s.tx - 1) / s.tx;
  s.hy = s.ty + 2;
  s.hx = s.tx + 2;
  s.halo_rows = (s.tz + 2) * s.hy * s.hx;
  if (s.halo_rows > max_halo_rows(ck, nb)) return false;
  const long long boxes = (long long)B * s.nbz * s.nby * s.nbx;
  if (boxes >= (1LL << 31)) return false;
  s.boxes = (int)boxes;
  const int tiles = chunk_tiles(ck);
  s.groups = (tiles + NWG * t - 1) / (NWG * t);
  const int n_blocks = (Cout + nb - 1) / nb;
  const int blocks = Cin / ck * s.groups * n_blocks;
  int splits = (ADELL_WGRAD_WAVES * n_sm + blocks - 1) / blocks;
  splits = splits < 1 ? 1 : splits > s.boxes ? s.boxes : splits;
  if (splits > 65535) return false;
  s.splits = splits;
  const int smem =
      STAGES * (g_bytes + round_up(s.halo_rows * row_bytes, 1024)) + 1024;
  const int vals[13] = {s.tz, s.ty, s.tx, ck, nb, t, NWG, tiles, s.groups,
                        n_blocks, splits, s.boxes, smem};
  for (int i = 0; i < 13; ++i) out[i] = vals[i];
  return true;
}

template <int CK, int NB>
int launch(const void* x, const void* g, void* ws, void* out,
           const Geometry& s, int smem, cudaStream_t st) {
  using P = Plan<CK, NB>;
  auto kernel = conv3d_wgrad_bf16_kernel<CK, NB>;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((unsigned)(s.Cin / CK * s.groups),
            (unsigned)((s.Cout + NB - 1) / NB), (unsigned)s.splits);
  kernel<<<grid, P::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(ws), s);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int n = 27 * s.Cin * s.Cout;
  conv3d_wgrad_reduce_kernel<<<(n / 4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), n,
      s.splits);
  return (int)cudaGetLastError();
}

// The (CK, NB) pairs the kernel is built for.
#define ADELL_WGRAD_DISPATCH(CK, NB, CALL)                 \
  switch (CK * 1000 + NB) {                                \
    case 16016: return CALL(16, 16);                       \
    case 16032: return CALL(16, 32);                       \
    case 16064: return CALL(16, 64);                       \
    case 32016: return CALL(32, 16);                       \
    case 32032: return CALL(32, 32);                       \
    case 32064: return CALL(32, 64);                       \
    case 64016: return CALL(64, 16);                       \
    case 64032: return CALL(64, 32);                       \
    case 64064: return CALL(64, 64);                       \
    default: return (int)cudaErrorInvalidValue;            \
  }

}  // namespace wgrad
}  // namespace

// What the wrapper needs to pick a box for Cin -> Cout: out[0], the voxels
// of a box; out[1], the most halo rows that fit in shared memory beside the
// cotangent tiles. cudaErrorInvalidValue outside the kernel's set (bf16,
// Cin a multiple of 16, Cout of 8, Cout <= 256).
extern "C" int adell_conv3d_wgrad_limits(int Cin, int Cout, int* out) {
  if (!wgrad::takes(Cin, Cout)) return (int)cudaErrorInvalidValue;
  const int nb = wgrad::n_block_of(Cout);
  out[0] = wgrad::VOX;
  out[1] = wgrad::max_halo_rows(wgrad::chunk_of(Cin, nb), nb);
  return 0;
}

// The decomposition of dW for x [B,D,H,W,Cin] and g [B,D,H,W,Cout] in boxes
// of (tz, ty, tx) on a card of n_sm SMs (13 values, see plan_of);
// cudaErrorInvalidValue outside the kernel's set or for a box outside the
// limits.
extern "C" int adell_conv3d_wgrad_plan(int B, int D, int H, int W, int Cin,
                                       int Cout, int tz, int ty, int tx,
                                       int n_sm, int* out) {
  wgrad::Geometry s;
  return wgrad::plan_of(B, D, H, W, Cin, Cout, tz, ty, tx, n_sm, s, out)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// dW [3,3,3,Cin,Cout] bf16 of x and g, both bf16 channels-last, in boxes of
// (tz, ty, tx); ws holds S x 27 Cin x Cout floats (S from
// adell_conv3d_wgrad_plan with the same arguments).
extern "C" int adell_conv3d_wgrad_bf16(const void* x, const void* g,
                                       void* ws, void* out, int B, int D,
                                       int H, int W, int Cin, int Cout,
                                       int tz, int ty, int tx, int n_sm,
                                       void* stream) {
  wgrad::Geometry s;
  int plan[13];
  if (!wgrad::plan_of(B, D, H, W, Cin, Cout, tz, ty, tx, n_sm, s, plan))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = plan[12];
#define ADELL_WGRAD_LAUNCH(CK, NB) \
  wgrad::launch<CK, NB>(x, g, ws, out, s, smem, st)
  ADELL_WGRAD_DISPATCH(plan[3], plan[4], ADELL_WGRAD_LAUNCH)
#undef ADELL_WGRAD_LAUNCH
}
