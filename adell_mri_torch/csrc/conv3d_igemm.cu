// 3x3x3 stride-1 SAME 3D convolution forward, channels-last, for Hopper.
//
// Replaces adell_mri_tpu/ops/pallas/conv.py:_kernel (the TPU's implicit-GEMM
// conv, called from conv3d_pallas_raw). Same function:
//
//   out[b,z,y,x,co] = bias[co] + sum_{tap,ci} x[b,z+dz,y+dy,x+dx,ci] * w[tap,ci,co]
//
// a GEMM with M = B*D*H*W output voxels, N = Cout and K = 27*Cin, k = tap*Cin
// + ci, the row-major flattening of the weight [3,3,3,Cin,Cout]. As on the
// TPU, the [M, K] patch matrix never exists in device memory. The input
// gradient (dx) is the same function of the cotangent and the flipped,
// channel-swapped weight, so it launches the same kernels.
//
// What bounds it on the H100: operations. At the flagship's widths the convs
// do 2*Cin*Cout FLOP per voxel and tap; the 32->32 conv at B=4, 128x128x32
// does 116 GFLOP on 268 MB (430 FLOP/byte, the card's ridge is 295), and the
// 1306 GFLOP of a window batch need 1.32 ms at 989 TFLOP/s. Only the Cin=1
// stems are bound by bytes. A conv that reloads its shifted input rows for
// every tap does only Cout FLOP per byte it loads: at Cout = 32 the tensor
// cores at half rate would need about 15 TB/s from L2, at Cout = 16 about 30.
// So reuse across taps, not the GEMM, decides the speed.
//
// conv3d_wgmma_bf16_kernel (bf16, Cin a multiple of 16, Cout of 8; the main
// path's convs but the Cin=1 stems) is built for that:
//   - a block owns a BOX of output voxels, (tz, ty, tx) with tz*ty*tx = 64
//     per warpgroup (4x4x8 at the U-Net's 32-wide levels); the wrapper picks
//     it from (D, H, W), and ragged boxes at the volume's edges are computed
//     and not stored;
//   - the block loads the box's input HALO, (tz+2)(ty+2)(tx+2) voxel rows of
//     one channel chunk (16, 32 or 64 channels), once, with 16-byte cp.async
//     copies that zero-fill rows outside the volume (the SAME border is data,
//     never a skipped product). The 27 taps read their shifted rows from
//     shared memory: 360 halo rows serve 27 x 128 tap rows (9.6x less load
//     traffic than a gather per tap). Halo rows are padded by 16 bytes, so
//     eight consecutive rows fall on distinct banks;
//   - the A operand of a tap, 16 output rows by 16 channels a warp, goes to
//     registers with ldmatrix at each row's shifted address (a per-lane
//     address takes any row mapping, which a descriptor over a shifted tile
//     cannot), and `wgmma` m64nNk16 takes A from registers and B, the tap's
//     weight rows, from shared memory MN-major (tnspB), as the weight lies;
//     sums stay in registers, N is the whole (padded) Cout of the block
//     (16, 32, 64 or 128, one m64n128k16 product; Cout = 256 is two N
//     blocks, which tune_conv measured 2.8x faster than one of 256);
//   - weight slabs of G taps (G*Cin_chunk*N >= 2048, so a barrier is paid
//     for enough products) stream through a ring of cp.async stages, and
//     with more than one channel chunk the halo is double-buffered: the next
//     chunk's halo loads while this one multiplies. The ring's lead caps G
//     (Plan), so that halo is never loaded late or over the one in use;
//   - a thread's halo row, box voxel and output offsets are computed once;
//     in the loop a tap's shift is an add of constants, nothing is divided;
//   - each tap's products are one group, waited for one tap later, so a
//     tap's ldmatrix and the ring's barrier run while the previous tap's
//     products are in flight; A registers alternate between two sets. First
//     and last turns are fixed by unrolling, so the groups in flight never
//     depend on a branch (ptxas would serialize every wgmma);
//   - the epilogue adds the bias in f32 to the register sums and rounds once
//     to bf16, as the plain version does.
//
// conv3d_narrow_kernel (bf16 and f32, min(Cin, Cout) <= 4 and max(Cin,
// Cout) <= 64: the Cin = 1 stems 1->1, 1->32 and UNETR's 1->16, the Cout = 1
// dx 32->1, multi-sequence stems such as 3->32 and their dx) is bound by
// bytes: at Cin = 1 a conv does 27*Cout FLOP per input element, and 1->32 at
// B=4, 128x128x32 moves 138 MB (41 us at 3.35 TB/s) for 3.62 GFLOP. A GEMM
// pads these shapes (K = 27 to 32, N = 1 to 8 or 32) and gathers each patch
// element apart. This kernel reads each input byte once from device memory
// and writes each output byte once:
//   - a block owns a box of NZ x ty x 32 output voxels; a lane owns one x, a
//     warp one y, a thread NZ = 4 voxels along z and COT output channels (1,
//     4 or 8; warps of the same voxels take the other channel slices);
//   - the box's input halo, zero outside the volume, goes to shared memory
//     once per vector of CIV channels (1, 4, or 16 bytes), in the input type;
//     the weight, 27*Cin*Cout f32 values (27 KB at most), stays there for the
//     block and a warp reads one address of it at a time (a broadcast);
//   - a thread reads the NZ + 2 halo rows of each (dy, dx) column once and
//     uses them for the three dz taps; lanes read neighbouring rows;
//   - sums are exact products in f32 registers, bias added and rounded once,
//     as in the plain version; no atomics, so bf16 outputs are the same bits
//     every run; outputs of 4 or 8 channels leave as 8- or 16-byte stores.
// It multiplies with f32 FMA, not mma.sync: 1->32, 32->1 and 1->16 each do
// 3.62 GFLOP, 54 us at 67 TFLOP/s, within 1.3x of their 41-43 us bytes
// bound; one template then serves bf16 and f32 with the same arithmetic, and
// nothing is padded to a tensor-core tile (N = Cout = 1 would be 8).
//
// conv3d_igemm_bf16_kernel (the first design: a gathered patch tile, WMMA
// 16x16x16, synchronous loads) keeps the bf16 convs neither Hopper kernel
// takes (Cin 5 to 15 and the like); conv3d_igemm_f32_kernel, the same
// design in plain f32 FMA, the f32 convs that neither the narrow kernel
// nor the 3xTF32 one (csrc/conv3d_tf32.cu) takes (a width that is not a
// multiple of 8).
//
// C interface (loaded with ctypes): each launcher enqueues one kernel on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma.cuh"

using namespace nvcuda;

namespace {

struct ConvShape {
  int D, H, W, Cin, Cout, K;
  long long M;
};

// Decomposes output voxel m into its (z, y, x) coordinates.
__device__ __forceinline__ void voxel_zyx(long long m, const ConvShape& s,
                                          int& z, int& y, int& x) {
  x = (int)(m % s.W);
  long long t = m / s.W;
  y = (int)(t % s.H);
  z = (int)((t / s.H) % s.D);
}

// Input element offset of (voxel m, reduction index k), or -1 where the tap
// reads the zero border. Voxel m of the output is voxel m of the input, so
// a tap is a constant shift of the flat voxel index.
__device__ __forceinline__ long long patch_offset(long long m, int z, int y,
                                                  int x, int k,
                                                  const ConvShape& s) {
  int tap = k / s.Cin;
  int ci = k - tap * s.Cin;
  int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
  int zz = z + dz, yy = y + dy, xx = x + dx;
  if (zz < 0 || zz >= s.D || yy < 0 || yy >= s.H || xx < 0 || xx >= s.W)
    return -1;
  long long shift = ((long long)dz * s.H + dy) * s.W + dx;
  return (m + shift) * s.Cin + ci;
}

// ---------------------------------------------------------------- bf16 ---

constexpr int BM = 128;      // output voxels per block
constexpr int BK = 32;       // reduction slice per step
constexpr int THREADS = 256; // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8; // padded rows keep WMMA pointers 32-byte aligned

template <int BN>
struct Bf16Smem {
  static constexpr int B_LD = BN + 8;
  static constexpr int C_LD = BN + 4;
  static constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * 2;
  static constexpr int C_BYTES = BM * C_LD * 4;
  static constexpr int BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

template <int BN>
__global__ void __launch_bounds__(THREADS)
    conv3d_igemm_bf16_kernel(const __nv_bfloat16* __restrict__ xin,
                             const __nv_bfloat16* __restrict__ wmat,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, ConvShape s) {
  using Smem = Bf16Smem<BN>;
  constexpr int B_LD = Smem::B_LD;
  constexpr int C_LD = Smem::C_LD;
  constexpr int FRAG_N = BN / 32;  // 16-wide fragments per warp along N
  __shared__ __align__(128) unsigned char smem[Smem::BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * A_LD;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int warp_m = warp % 4, warp_n = warp / 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // each thread gathers 8 consecutive k of two fixed tile rows
  const int kg = t % (BK / 8);
  long long am[2];
  int az[2], ay[2], ax[2];
  bool arow_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int row = t / (BK / 8) + i * (THREADS / (BK / 8));
    am[i] = m0 + row;
    arow_ok[i] = am[i] < s.M;
    voxel_zyx(arow_ok[i] ? am[i] : 0, s, az[i], ay[i], ax[i]);
  }
  const bool cin_vec = (s.Cin % 8) == 0;
  const bool cout_vec = (s.Cout % 8) == 0;
  const unsigned short* xraw = reinterpret_cast<const unsigned short*>(xin);
  const unsigned short* wraw = reinterpret_cast<const unsigned short*>(wmat);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FRAG_N];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    // ---- patch tile [BM, BK] ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int row = t / (BK / 8) + i * (THREADS / (BK / 8));
      uint4* dst = reinterpret_cast<uint4*>(As + row * A_LD + kg * 8);
      int k = k0 + kg * 8;
      if (cin_vec) {
        // 8 k of one tap: contiguous channels of one voxel
        uint4 v = make_uint4(0, 0, 0, 0);
        if (arow_ok[i] && k < s.K) {
          long long off = patch_offset(am[i], az[i], ay[i], ax[i], k, s);
          if (off >= 0) v = *reinterpret_cast<const uint4*>(xraw + off);
        }
        *dst = v;
      } else {
        __align__(16) unsigned short vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          vals[j] = 0;
          if (arow_ok[i] && k + j < s.K) {
            long long off =
                patch_offset(am[i], az[i], ay[i], ax[i], k + j, s);
            if (off >= 0) vals[j] = xraw[off];
          }
        }
        *dst = *reinterpret_cast<uint4*>(vals);
      }
    }
    // ---- weight tile [BK, BN] ----
    for (int g = t; g < BK * (BN / 8); g += THREADS) {
      int kr = g / (BN / 8), ng = g % (BN / 8);
      int k = k0 + kr, n = n0 + ng * 8;
      uint4* dst = reinterpret_cast<uint4*>(Bs + kr * B_LD + ng * 8);
      if (cout_vec) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < s.K && n < s.Cout)
          v = *reinterpret_cast<const uint4*>(wraw + (long long)k * s.Cout +
                                              n);
        *dst = v;
      } else {
        __align__(16) unsigned short vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vals[j] = (k < s.K && n + j < s.Cout)
                        ? wraw[(long long)k * s.Cout + n + j]
                        : (unsigned short)0;
        *dst = *reinterpret_cast<uint4*>(vals);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[FRAG_N];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (warp_m * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::load_matrix_sync(
            b[j], Bs + kk * B_LD + warp_n * (BN / 2) + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: f32 tile in shared memory, bias, round once ----
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * C_LD + warp_n * (BN / 2) + j * 16,
          acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = t; idx < BM * BN; idx += THREADS) {
    int row = idx / BN, col = idx % BN;
    long long m = m0 + row;
    int n = n0 + col;
    if (m < s.M && n < s.Cout) {
      float v = Cs[row * C_LD + col];
      if (bias != nullptr) v += __bfloat162float(bias[n]);
      out[m * s.Cout + n] = __float2bfloat16_rn(v);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int FBM = 64, FBN = 64, FBK = 16;  // 256 threads, 4x4 per thread

__global__ void __launch_bounds__(THREADS)
    conv3d_igemm_f32_kernel(const float* __restrict__ xin,
                            const float* __restrict__ wmat,
                            const float* __restrict__ bias,
                            float* __restrict__ out, ConvShape s) {
  __shared__ float As[FBK][FBM + 4];  // transposed: k-major
  __shared__ float Bs[FBK][FBN + 4];
  const int t = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  // A: thread gathers k = t % 16 of rows t/16 + 16*i
  const int akk = t % FBK;
  long long am[4];
  int az[4], ay[4], ax[4];
  bool arow_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    am[i] = m0 + t / FBK + 16 * i;
    arow_ok[i] = am[i] < s.M;
    voxel_zyx(arow_ok[i] ? am[i] : 0, s, az[i], ay[i], ax[i]);
  }
  const int ty = t / 16, tx = t % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < s.K; k0 += FBK) {
    const int k = k0 + akk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (arow_ok[i] && k < s.K) {
        long long off = patch_offset(am[i], az[i], ay[i], ax[i], k, s);
        if (off >= 0) v = xin[off];
      }
      As[akk][t / FBK + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = t + i * THREADS;
      int kr = idx / FBN, n = n0 + idx % FBN;
      int kw = k0 + kr;
      Bs[kr][idx % FBN] =
          (kw < s.K && n < s.Cout) ? wmat[(long long)kw * s.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long m = m0 + ty * 4 + i;
    if (m >= s.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < s.Cout)
        out[m * s.Cout + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

// --------------------------------------------------------- bf16, Hopper ---

// Tuning knobs (tools/tune_conv.py builds the variants): warpgroups a block
// (64 output voxels each), weight ring stages, and the products a ring stage
// must hold (G * CK * NB) before a barrier is paid for it.
#ifndef ADELL_CONV_WARPGROUPS
#define ADELL_CONV_WARPGROUPS 2
#endif
#ifndef ADELL_CONV_STAGES
#define ADELL_CONV_STAGES 4
#endif
#ifndef ADELL_CONV_TAP_WORK
#define ADELL_CONV_TAP_WORK 2048
#endif

namespace box {

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The launch's geometry: the volume, the box a block owns and its halo.
struct Geometry {
  int D, H, W, Cin, Cout;
  int tz, ty, tx;      // box
  int nbz, nby, nbx;   // boxes along each axis
  int hy, hx;          // halo extents along y and x (ty + 2, tx + 2)
  int halo_rows;       // (tz + 2) * hy * hx
  int n_chunks;        // Cin / CK
};

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have

// Shared memory and threads of the kernel for a channel chunk CK and an N
// block NB. Weight slabs of G taps fill a ring stage; G is the fewest taps
// (of 1, 3, 9, 27) whose products G * CK * NB reach ADELL_CONV_TAP_WORK
// (2048) a barrier, but no more than leaves a chunk STAGES - 2 ring steps:
// the ring loads that far ahead, and the next chunk's halo goes with the
// load of its first step, so a chunk of fewer steps would have its halo
// loaded late, or into the buffer the chunk before it still reads.
template <int CK, int NB>
struct Plan {
  static constexpr int NWG = ADELL_CONV_WARPGROUPS;
  static constexpr int STAGES = ADELL_CONV_STAGES;
  static_assert(STAGES >= 3, "a stage in use, one in flight, one loading");
  static_assert(NWG == 1 || NWG == 2, "one or two warpgroups");
  static constexpr int THREADS = 128 * NWG;
  static constexpr int VOXELS = 64 * NWG;  // output voxels a block (its box)
  static constexpr int ROW_BYTES = 2 * CK + 16;  // halo row, padded
  static constexpr int WORK = ADELL_CONV_TAP_WORK;
  static constexpr int G_WORK = CK * NB >= WORK       ? 1
                                : 3 * CK * NB >= WORK ? 3
                                : 9 * CK * NB >= WORK ? 9
                                                      : 27;
  static constexpr int AHEAD = STAGES - 2;     // ring steps loaded ahead
  static constexpr int G_RING = 27 / AHEAD >= 27 ? 27
                                : 27 / AHEAD >= 9 ? 9
                                : 27 / AHEAD >= 3 ? 3
                                                  : 1;
  static constexpr int G = G_WORK < G_RING ? G_WORK : G_RING;
  static constexpr int STEPS = 27 / G;         // ring steps a chunk
  static_assert(STEPS >= AHEAD, "a chunk must outlast the ring's lead");
  static constexpr int NT = NB > 64 ? 64 : NB; // width of a weight atom
  static constexpr int SLAB = CK * NB * 2;     // one tap's weight rows
  static constexpr int STAGE_BYTES = round_up(G * SLAB, 1024);
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
// keep 27 per-tap offsets (shared and device addresses) live across the
// chunk loop, about 100 registers and spills; recomputing one is an add or
// two.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// d (+)= A B for one k-step of one tap: N = NB from the tap's MN-major
// weight slab at shared address slab (CK rows of each 64-wide atom).
template <int CK, int NB>
__device__ __forceinline__ void tap_product(float (&d)[NB / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t slab, int kk) {
  using namespace hopper;
  using T = Tile<(NB > 64 ? 64 : NB)>;
  const uint32_t k_off = kk * 16 * T::ROW_BYTES;
  if constexpr (NB <= 64)
    wgmma_rs_mn(d, a, T::desc(slab + k_off));
  else  // two 64-wide atoms, CK rows apart
    wgmma_rs_mn(d, a, T::desc(slab + k_off, CK * T::ROW_BYTES));
}

template <int CK, int NB>
__global__ void __launch_bounds__(Plan<CK, NB>::THREADS)
    conv3d_wgmma_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, Geometry s) {
  using namespace hopper;
  using P = Plan<CK, NB>;
  using T = Tile<P::NT>;
  constexpr int NTH = P::THREADS, G = P::G, STAGES = P::STAGES;
  constexpr int KSTEPS = CK / 16;
  constexpr int CPR = CK / 8;   // 16-byte chunks of a halo row
  constexpr int WCH = NB / 8;   // 16-byte chunks of a weight row
  constexpr int ACH = P::NT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sW = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sHalo = sW + STAGES * P::STAGE_BYTES;
  const uint32_t halo_bytes = box::round_up(s.halo_rows * P::ROW_BYTES, 128);

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

  // Chunk c of the halo: row (hz, hy, hx) is voxel (z0 + hz - 1, ...).
  auto load_halo = [&](int c, uint32_t buf) {
    const __nv_bfloat16* xc = x + (size_t)b * vol * cin + c * CK;
    for (int i = tid; i < s.halo_rows * CPR; i += NTH) {
      const int row = i / CPR, ch = i % CPR;
      const int hx = row % s.hx, t2 = row / s.hx;
      const int hy = t2 % s.hy, hz = t2 / s.hy;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool ok = (unsigned)gz < (unsigned)s.D &&
                      (unsigned)gy < (unsigned)s.H &&
                      (unsigned)gx < (unsigned)s.W;
      const size_t v = ok ? ((size_t)gz * s.H + gy) * s.W + gx : 0;
      cp_async_16(buf + row * P::ROW_BYTES + ch * 16, xc + v * cin + ch * 8,
                  ok);
    }
  };
  // Weight rows of taps t0 .. t0 + G - 1 of chunk c; zeros when !live (a
  // step past the end, which no product reads) and past Cout.
  auto load_w = [&](int c, int t0, uint32_t st, bool live) {
#pragma unroll
    for (int i0 = 0; i0 < G * CK * WCH; i0 += NTH) {
      // recomputed each step: hoisted, these offsets took the registers
      // that N = 128 at 64 channels needs
      const int i = i0 + opaque(tid);
      if (G * CK * WCH % NTH == 0 || i < G * CK * WCH) {
        const int g = i / (CK * WCH), r = i / WCH % CK, j = i % WCH;
        const int col = n0 + j * 8;
        const bool ok = live && col < cout;
        const size_t row = (size_t)(t0 + g) * opaque(cin) + c * CK + r;
        cp_async_16(st + g * P::SLAB + j / ACH * CK * T::ROW_BYTES +
                        T::offset(r, j % ACH),
                    w + (ok ? row * cout + col : 0), ok);
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

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][KSTEPS][4];

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
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(a[t & 1][kk], halo + shift + kk * 32);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          tap_product<CK, NB>(acc, a[t & 1][kk], st + g * P::SLAB, kk);
        wg_commit();
        if (t == 26)
          wg_wait<0>();
        else
          wg_wait<1>();
      }
    }
  }
  cp_async_wait<0>();
  reg_fence(acc);

  // rows 16 w + lane / 4 and that + 8 of the warp's accumulator
  const int r_lo = wrow + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const int oz = z0 + r / (s.ty * s.tx), oy = y0 + r / s.tx % s.ty;
    const int ox = x0 + r % s.tx;
    if (oz >= s.D || oy >= s.H || ox >= s.W) continue;
    __nv_bfloat16* o =
        out + ((size_t)b * vol + ((size_t)oz * s.H + oy) * s.W + ox) * cout;
#pragma unroll
    for (int q = 0; q < NB / 8; ++q) {
      const int col = n0 + 8 * q + 2 * (lane % 4);
      if (col >= cout) continue;
      float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if (bias != nullptr) {
        v0 += __bfloat162float(bias[col]);
        v1 += __bfloat162float(bias[col + 1]);
      }
      *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(v0, v1);
    }
  }
}

template <int CK, int NB>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           const Geometry& s, cudaStream_t st) {
  using P = Plan<CK, NB>;
  auto kernel = conv3d_wgmma_bf16_kernel<CK, NB>;
  const int smem = P::smem(s.halo_rows, s.n_chunks);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((unsigned)B * s.nbz * s.nby * s.nbx, (s.Cout + NB - 1) / NB);
  kernel<<<grid, P::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), s);
  return (int)cudaGetLastError();
}

template <int CK, int NB>
int limits_of(int n_chunks, int* out) {
  out[0] = Plan<CK, NB>::VOXELS;
  out[1] = Plan<CK, NB>::max_halo_rows(n_chunks);
  return 0;
}

// The channel chunk of the halo (the largest of 64, 32, 16 that divides
// Cin) and the N block (Cout padded to 16, 32, 64 or 128; a wider Cout
// takes several blocks of 128).
int chunk_of(int Cin) { return Cin % 64 == 0 ? 64 : Cin % 32 == 0 ? 32 : 16; }
int n_block_of(int Cout) {
  return Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
}

// The (CK, NB) pairs the kernel is built for.
#define ADELL_CONV_DISPATCH(CK, NB, CALL)                  \
  switch (CK * 1000 + NB) {                                \
    case 16016: return CALL(16, 16);                       \
    case 16032: return CALL(16, 32);                       \
    case 16064: return CALL(16, 64);                       \
    case 16128: return CALL(16, 128);                      \
    case 32016: return CALL(32, 16);                       \
    case 32032: return CALL(32, 32);                       \
    case 32064: return CALL(32, 64);                       \
    case 32128: return CALL(32, 128);                      \
    case 64016: return CALL(64, 16);                       \
    case 64032: return CALL(64, 32);                       \
    case 64064: return CALL(64, 64);                       \
    case 64128: return CALL(64, 128);                      \
    default: return (int)cudaErrorInvalidValue;            \
  }

}  // namespace box

// ------------------------------------------------------- narrow, Hopper ---

namespace narrow {

constexpr int TX = 32;      // output voxels of a warp along x, one a lane
// Output voxels of a thread along z. tune_conv measured 8 no faster than 4
// (the weight loads it halves do not bound the kernel).
constexpr int NZ = 4;
// Blocks an SM holds at once, a register cap of 128: tune_conv measured 2
// about 10 % faster than 1 on every narrow class.
constexpr int MIN_BLOCKS = 2;
constexpr int HX = TX + 2;  // halo extent along x
constexpr int MAX_CH = 64;  // the wider side of a narrow conv
constexpr int MAX_NARROW = 4;

// Whether Cin -> Cout is a narrow conv: one side of at most 4 channels, the
// other of at most 64.
__host__ __device__ constexpr bool takes(int cin, int cout) {
  return cin >= 1 && cout >= 1 && (cin < cout ? cin : cout) <= MAX_NARROW &&
         (cin > cout ? cin : cout) <= MAX_CH;
}

// Element access of the two types, on their raw bits.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using raw = uint16_t;
  __device__ __forceinline__ static float f32(uint16_t v) {
    return __uint_as_float((uint32_t)v << 16);  // exact
  }
  __device__ __forceinline__ static uint16_t round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Elem<float> {
  using raw = uint32_t;
  __device__ __forceinline__ static float f32(uint32_t v) {
    return __uint_as_float(v);
  }
  __device__ __forceinline__ static uint32_t round(float v) {
    return __float_as_uint(v);
  }
};

// One load or store of BYTES bytes.
template <int BYTES>
struct Word;
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

// A word's 32-bit parts, and a word from them (no type punning: the
// optimizer may keep either side in registers).
__device__ __forceinline__ uint32_t part(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t part(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t part(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename V>
__device__ __forceinline__ V make_word(const uint32_t* u);
template <>
__device__ __forceinline__ uint32_t make_word<uint32_t>(const uint32_t* u) {
  return u[0];
}
template <>
__device__ __forceinline__ uint2 make_word<uint2>(const uint32_t* u) {
  return make_uint2(u[0], u[1]);
}
template <>
__device__ __forceinline__ uint4 make_word<uint4>(const uint32_t* u) {
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// N raw elements (N * size a power of two, at most 16 bytes) as one word.
template <int N, typename R>
__device__ __forceinline__ typename Word<N * (int)sizeof(R)>::type word_of(
    const R* e) {
  constexpr int BYTES = N * (int)sizeof(R);
  if constexpr (BYTES == 2) {
    return e[0];
  } else {
    uint32_t u[BYTES / 4];
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      if constexpr (sizeof(R) == 4)
        u[i] = (uint32_t)e[i];
      else
        u[i] = (uint32_t)e[2 * i] | (uint32_t)e[2 * i + 1] << 16;
    }
    return make_word<typename Word<BYTES>::type>(u);
  }
}

// Stores N raw elements as words of at most 16 bytes (dst aligned to them).
template <int N, typename R>
__device__ __forceinline__ void store_raw(R* dst, const R (&e)[N]) {
  constexpr int BYTES = N * (int)sizeof(R);
  constexpr int WB = BYTES > 16 ? 16 : BYTES;  // bytes a store
  constexpr int EPS = WB / (int)sizeof(R);     // elements a store
  using V = typename Word<WB>::type;
#pragma unroll
  for (int p = 0; p < N / EPS; ++p)
    reinterpret_cast<V*>(dst)[p] = word_of<EPS>(e + p * EPS);
}

// N elements of T, one word of shared memory, as floats (exact).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const typename Elem<T>::raw* src,
                                         float (&f)[N]) {
  using R = typename Elem<T>::raw;
  constexpr int BYTES = N * (int)sizeof(R);
  if constexpr (BYTES == 2) {
    f[0] = Elem<T>::f32(*src);
  } else {
    const auto w = *reinterpret_cast<const typename Word<BYTES>::type*>(src);
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      const uint32_t u = part(w, i);
      if constexpr (sizeof(R) == 4) {
        f[i] = __uint_as_float(u);
      } else {
        f[2 * i] = __uint_as_float(u << 16);
        f[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    }
  }
}

// N floats of shared memory (16-byte aligned where N >= 4).
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  }
}

// The launch's geometry. A block is cs x TX x ty threads, the channel slice
// (which COT output channels) fastest, then x, then y, so that a warp's
// stores cover whole output rows side by side; a thread owns NZ voxels
// along z of one (y, x). The box is NZ x ty x TX voxels.
struct Shape {
  int D, H, W, Cin, Cout;
  int cin_s;   // Cin padded to whole vectors of CIV channels
  int cout_p;  // Cout padded to whole slices of COT channels
  int ty, cs;  // warp rows, channel slices
  int nbz, nby, nbx, boxes;
};

// Halo vectors a thread loads for one box and chunk (the most of any plan:
// a box of 8 warp rows over 256 threads).
constexpr int PREFETCH = ((NZ + 2) * 10 * HX + 255) / 256;

// out = bias + sum over taps and channels of x * w, channels-last, SAME
// zeros, exact products summed in f32 registers, rounded once. A block
// walks boxes (box += gridDim.x) and, in each, the input channels CIV at a
// time. The weight (f32, zero past Cin and Cout) is loaded to shared memory
// once a block. The halo of a (box, chunk) step is double-buffered: a
// thread issues the loads of its share of the next step's halo into
// registers before it computes this step, and stores them to the other
// buffer after, so device-memory latency hides behind the taps. Each thread
// reads its (NZ + 2) halo rows of a (dy, dx) column once for the three dz
// taps. Lanes read neighbouring rows (no bank conflicts) and a warp reads
// one weight address at a time (a broadcast).
template <typename T, int CIV, int COT>
__global__ void __launch_bounds__(256, MIN_BLOCKS)
    conv3d_narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ out,
                         Shape s) {
  using E = Elem<T>;
  using R = typename E::raw;
  using V = typename Word<CIV * (int)sizeof(R)>::type;  // one halo vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wn = 27 * s.cin_s * s.cout_p;
  const int hy = s.ty + 2;
  const int rows = (NZ + 2) * hy * HX;
  const int plane = hy * HX;
  float* ws = reinterpret_cast<float*>(smem_raw);  // [27][cin_s][cout_p]
  R* halo0 = reinterpret_cast<R*>(smem_raw + box::round_up(wn * 4, 16));
  R* halo1 = halo0 + box::round_up(rows * CIV, 8);
  const R* xr = reinterpret_cast<const R*>(x);
  const R* wr = reinterpret_cast<const R*>(w);

  const int tid = threadIdx.x, nth = blockDim.x;
  const int slice = tid % s.cs, lane = tid / s.cs % TX;
  const int wy = tid / s.cs / TX;
  const size_t vol = (size_t)s.D * s.H * s.W;
  const bool whole = s.Cin % CIV == 0;  // vectors lie whole in memory
  const int chunks = s.cin_s / CIV;

  if (s.cin_s == s.Cin && s.cout_p == s.Cout) {
    for (int i = tid; i < wn; i += nth) ws[i] = E::f32(wr[i]);
  } else {
    for (int i = tid; i < wn; i += nth) {
      const int co = i % s.cout_p, r = i / s.cout_p;
      const int ci = r % s.cin_s, tap = r / s.cin_s;
      ws[i] = ci < s.Cin && co < s.Cout
                  ? E::f32(wr[((size_t)tap * s.Cin + ci) * s.Cout + co])
                  : 0.f;
    }
  }
  // halo row r is (hz, hy, hx) = (r / plane, r / HX % hy, r % HX); the
  // quotient by plane is taken from a float reciprocal, exact for r below
  // 2^16 (a halo has at most a few thousand rows)
  const float inv_plane = 1.f / (float)plane;

  int b = 0, z0 = 0, y0 = 0, x0 = 0;  // the box being computed
  auto locate = [&](int bx, int& bb, int& zz, int& yy, int& xx) {
    xx = bx % s.nbx * TX;
    bx /= s.nbx;
    yy = bx % s.nby * s.ty;
    bx /= s.nby;
    zz = bx % s.nbz * NZ;
    bb = bx / s.nbz;
  };
  // the halo vectors of (box bx, channels c0 ..) this thread loads
  V pf[PREFETCH];
  auto fetch = [&](int bx, int c0) {
    int bb, zz, yy, xx;
    locate(bx, bb, zz, yy, xx);
    const R* xb = xr + (size_t)bb * vol * s.Cin + c0;
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k) {
      const int r = tid + k * nth;
      if (r >= rows) break;
      const int hz = (int)(((float)r + 0.5f) * inv_plane);
      const int rem = r - hz * plane;
      const int gz = zz + hz - 1;
      const int gy = yy + rem / HX - 1;
      const int gx = xx + rem % HX - 1;
      const bool ok = (unsigned)gz < (unsigned)s.D &&
                      (unsigned)gy < (unsigned)s.H &&
                      (unsigned)gx < (unsigned)s.W;
      const R* src =
          xb + (ok ? ((size_t)gz * s.H + gy) * s.W + gx : 0) * s.Cin;
      if (ok && whole) {
        pf[k] = *reinterpret_cast<const V*>(src);
      } else {
        R v[CIV];
#pragma unroll
        for (int c = 0; c < CIV; ++c)
          v[c] = ok && c0 + c < s.Cin ? src[c] : (R)0;
        pf[k] = word_of<CIV>(v);
      }
    }
  };
  auto put = [&](R* buf) {
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k) {
      const int r = tid + k * nth;
      if (r >= rows) break;
      *reinterpret_cast<V*>(buf + (size_t)r * CIV) = pf[k];
    }
  };

  int bx = blockIdx.x, chunk = 0;
  if (bx >= s.boxes) return;
  fetch(bx, 0);
  put(halo0);
  __syncthreads();
  locate(bx, b, z0, y0, x0);
  const int co0 = slice * COT;
  float acc[NZ][COT];
#pragma unroll
  for (int n = 0; n < NZ; ++n)
#pragma unroll
    for (int j = 0; j < COT; ++j) acc[n][j] = 0.f;
  R* cur = halo0;
  R* other = halo1;

  while (true) {
    // the next step of this block: the next chunk, or the next box's first
    const bool last = chunk + 1 == chunks;
    const int nbx = last ? bx + gridDim.x : bx;
    const int nchunk = last ? 0 : chunk + 1;
    const bool more = nbx < s.boxes;
    if (more) fetch(nbx, nchunk * CIV);

    // hidden from the optimizer, so the 27 tap offsets are not hoisted out
    // of the step loop into registers
    const int tap_stride = box::opaque(s.cin_s * s.cout_p);
    const float* wc = ws + chunk * CIV * s.cout_p + co0;
    const R* hb = cur + (size_t)(wy * HX + lane) * CIV;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float h[NZ + 2][CIV];
#pragma unroll
        for (int k = 0; k < NZ + 2; ++k)
          load_f32<T>(hb + (size_t)(k * plane + dy * HX + dx) * CIV, h[k]);
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const float* wt = wc + (dz * 9 + dy * 3 + dx) * tap_stride;
          if constexpr (COT == 1) {
            // one output channel: the CIV weights of the tap lie side by side
            float wv[CIV];
            load_floats(wt, wv);
#pragma unroll
            for (int c = 0; c < CIV; ++c)
#pragma unroll
              for (int n = 0; n < NZ; ++n)
                acc[n][0] = fmaf(h[n + dz][c], wv[c], acc[n][0]);
          } else {
#pragma unroll
            for (int c = 0; c < CIV; ++c) {
              float wv[COT];
              load_floats(wt + c * s.cout_p, wv);
#pragma unroll
              for (int n = 0; n < NZ; ++n)
#pragma unroll
                for (int j = 0; j < COT; ++j)
                  acc[n][j] = fmaf(h[n + dz][c], wv[j], acc[n][j]);
            }
          }
        }
      }
    }

    if (last) {
      const int ox = x0 + lane, oy = y0 + wy;
      if (ox < s.W && oy < s.H) {
        float bv[COT];
#pragma unroll
        for (int j = 0; j < COT; ++j) {
          const int co = co0 + j;
          bv[j] = bias != nullptr && co < s.Cout
                      ? E::f32(reinterpret_cast<const R*>(bias)[co])
                      : 0.f;
        }
        R* ob = reinterpret_cast<R*>(out) +
                ((size_t)b * vol + (size_t)oy * s.W + ox) * s.Cout + co0;
        const bool full = s.Cout % COT == 0;  // whole, aligned vectors
#pragma unroll
        for (int n = 0; n < NZ; ++n) {
          const int oz = z0 + n;
          if (oz >= s.D) break;
          R v[COT];
#pragma unroll
          for (int j = 0; j < COT; ++j) v[j] = E::round(acc[n][j] + bv[j]);
          R* o = ob + (size_t)oz * s.H * s.W * s.Cout;
          if (full) {
            store_raw(o, v);
          } else {
#pragma unroll
            for (int j = 0; j < COT; ++j)
              if (co0 + j < s.Cout) o[j] = v[j];
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NZ; ++n)
#pragma unroll
        for (int j = 0; j < COT; ++j) acc[n][j] = 0.f;
    }
    if (!more) break;
    put(other);
    __syncthreads();  // the next step's halo is in; this one is read
    R* t = cur;
    cur = other;
    other = t;
    bx = nbx;
    chunk = nchunk;
    if (last) locate(bx, b, z0, y0, x0);
  }
}

// The decomposition for Cin -> Cout in elements of `esize` bytes: channels
// a halo vector (1 at Cin = 1, 4 up to Cin = 4, then 16 bytes), output
// channels a thread (1, 4 up to Cout = 4, then 8), channel slices, warp rows
// (8 warps a block where the slices allow), and the shared memory: the
// weight and two halo buffers.
struct Plan {
  int civ, cot, cs, ty, cin_s, cout_p, threads, smem;
};

inline Plan plan_of(int esize, int Cin, int Cout) {
  Plan p;
  p.civ = Cin == 1 ? 1 : Cin <= 4 ? 4 : 16 / esize;
  p.cot = Cout == 1 ? 1 : Cout <= 4 ? 4 : 8;
  p.cs = (Cout + p.cot - 1) / p.cot;
  p.ty = p.cs >= 8 ? 1 : 8 / p.cs;
  p.cin_s = box::round_up(Cin, p.civ);
  p.cout_p = p.cot == 1 ? 1 : p.cs * p.cot;
  p.threads = TX * p.ty * p.cs;
  const int rows = (NZ + 2) * (p.ty + 2) * HX;
  p.smem = box::round_up(27 * p.cin_s * p.cout_p * 4, 16) +
           2 * box::round_up(rows * p.civ, 8) * esize;
  return p;
}

// One block a box up to as many as fit on the card at once; each walks its
// boxes from there.
template <typename T, int CIV, int COT>
int launch(const void* x, const void* w, const void* bias, void* out,
           const Shape& s, const Plan& p, cudaStream_t st) {
  auto kernel = conv3d_narrow_kernel<T, CIV, COT>;
  const int rows = (NZ + 2) * (p.ty + 2) * HX;
  if (rows > PREFETCH * p.threads) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, p.threads, p.smem)) != cudaSuccess)
    return (int)rc;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(s.boxes < cap ? s.boxes : cap);
  kernel<<<blocks, p.threads, p.smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_narrow(const void* x, const void* w, const void* bias, void* out,
                  int B, int D, int H, int W, int Cin, int Cout,
                  cudaStream_t st) {
  if (!takes(Cin, Cout) || B < 1 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of((int)sizeof(T), Cin, Cout);
  Shape s;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.cin_s = p.cin_s;
  s.cout_p = p.cout_p;
  s.ty = p.ty;
  s.cs = p.cs;
  s.nbz = (D + NZ - 1) / NZ;
  s.nby = (H + p.ty - 1) / p.ty;
  s.nbx = (W + TX - 1) / TX;
  const long long boxes = (long long)B * s.nbz * s.nby * s.nbx;
  if (boxes >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  s.boxes = (int)boxes;
  switch (p.civ * 100 + p.cot) {
    case 101: return launch<T, 1, 1>(x, w, bias, out, s, p, st);
    case 104: return launch<T, 1, 4>(x, w, bias, out, s, p, st);
    case 108: return launch<T, 1, 8>(x, w, bias, out, s, p, st);
    case 401: return launch<T, 4, 1>(x, w, bias, out, s, p, st);
    case 404: return launch<T, 4, 4>(x, w, bias, out, s, p, st);
    case 408: return launch<T, 4, 8>(x, w, bias, out, s, p, st);
    case 801:
    case 804:
      // 16-byte vectors of eight channels: bf16 only
      if constexpr (sizeof(T) == 2) {
        if (p.cot == 1) return launch<T, 8, 1>(x, w, bias, out, s, p, st);
        return launch<T, 8, 4>(x, w, bias, out, s, p, st);
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

int plan_narrow(int esize, int Cin, int Cout, int* out) {
  if (!takes(Cin, Cout)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(esize, Cin, Cout);
  out[0] = NZ;
  out[1] = p.ty;
  out[2] = TX;
  out[3] = p.cot;
  out[4] = p.cs;
  out[5] = p.civ;
  return 0;
}

}  // namespace narrow

ConvShape make_shape(int B, int D, int H, int W, int Cin, int Cout) {
  ConvShape s;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.K = 27 * Cin;
  s.M = (long long)B * D * H * W;
  return s;
}

}  // namespace

extern "C" int adell_conv3d_igemm_bf16(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int D, int H, int W, int Cin, int Cout,
                                       void* stream) {
  ConvShape s = make_shape(B, D, H, W, Cin, Cout);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  unsigned gx = (unsigned)((s.M + BM - 1) / BM);
  if (Cout <= 32) {
    dim3 grid(gx, (Cout + 31) / 32);
    conv3d_igemm_bf16_kernel<32><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, s);
  } else {
    dim3 grid(gx, (Cout + 63) / 64);
    conv3d_igemm_bf16_kernel<64><<<grid, THREADS, 0, st>>>(xp, wp, bp, op, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int adell_conv3d_igemm_f32(const void* x, const void* w,
                                      const void* bias, void* out, int B,
                                      int D, int H, int W, int Cin, int Cout,
                                      void* stream) {
  ConvShape s = make_shape(B, D, H, W, Cin, Cout);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((s.M + FBM - 1) / FBM), (Cout + FBN - 1) / FBN);
  conv3d_igemm_f32_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

// The narrow kernel (min(Cin, Cout) <= 4, max(Cin, Cout) <= 64; bf16 and
// f32): cudaErrorInvalidValue outside that set.
extern "C" int adell_conv3d_narrow_bf16(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int D, int H, int W, int Cin,
                                        int Cout, void* stream) {
  return narrow::launch_narrow<__nv_bfloat16>(
      x, w, bias, out, B, D, H, W, Cin, Cout,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int adell_conv3d_narrow_f32(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int D, int H, int W, int Cin, int Cout,
                                       void* stream) {
  return narrow::launch_narrow<float>(x, w, bias, out, B, D, H, W, Cin, Cout,
                                      reinterpret_cast<cudaStream_t>(stream));
}

// The narrow kernel's decomposition of Cin -> Cout: out[0..2], the box (z,
// y, x voxels); out[3], output channels a thread; out[4], threads sharing a
// voxel (channel slices); out[5], input channels a halo vector.
extern "C" int adell_conv3d_narrow_plan_bf16(int Cin, int Cout, int* out) {
  return narrow::plan_narrow(2, Cin, Cout, out);
}

extern "C" int adell_conv3d_narrow_plan_f32(int Cin, int Cout, int* out) {
  return narrow::plan_narrow(4, Cin, Cout, out);
}

// The Hopper kernel (bf16, Cin a multiple of 16, Cout of 8): the box
// (tz, ty, tx) comes from the wrapper (ops/kernels/conv.py: plan_box), within
// the limits that adell_conv3d_wgmma_limits gives.
extern "C" int adell_conv3d_wgmma_bf16(const void* x, const void* w,
                                       const void* bias, void* out, int B,
                                       int D, int H, int W, int Cin, int Cout,
                                       int tz, int ty, int tx, void* stream) {
  using box::Geometry;
  if (tz < 1 || ty < 1 || tx < 1 ||
      tz * ty * tx != 64 * ADELL_CONV_WARPGROUPS || Cin % 16 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  const int ck = box::chunk_of(Cin), nb = box::n_block_of(Cout);
  Geometry s;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
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
#define ADELL_CONV_LAUNCH(CK, NB) \
  box::launch<CK, NB>(x, w, bias, out, B, s, st)
  ADELL_CONV_DISPATCH(ck, nb, ADELL_CONV_LAUNCH)
#undef ADELL_CONV_LAUNCH
}

// What the wrapper needs to pick a box for Cin -> Cout: out[0], the output
// voxels of a box (64 a warpgroup); out[1], the most halo rows that fit in
// shared memory beside the weight ring.
extern "C" int adell_conv3d_wgmma_limits(int Cin, int Cout, int* out) {
  if (Cin < 16 || Cin % 16 || Cout < 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  const int ck = box::chunk_of(Cin), nb = box::n_block_of(Cout);
#define ADELL_CONV_LIMITS(CK, NB) box::limits_of<CK, NB>(Cin / CK, out)
  ADELL_CONV_DISPATCH(ck, nb, ADELL_CONV_LIMITS)
#undef ADELL_CONV_LIMITS
}
