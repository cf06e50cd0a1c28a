// Blockwise (flash) softmax attention for Hopper: forward, dQ and dK/dV.
//
// Replaces the four TPU kernels of adell_mri_tpu/ops/pallas/attention.py:
//   flash_fwd_{bf16,tf32x3}_kernel  <- _flash_kernel_vmem and _flash_kernel
//                                      (one function: the VMEM-resident
//                                      variant only worked around a TPU
//                                      compile-service fault)
//   flash_bwd_dq_{bf16,tf32x3}_kernel  <- _bwd_dq_kernel
//   flash_bwd_dkv_{bf16,tf32x3}_kernel <- _bwd_dkv_kernel
//
// q [BH, Nq, D], k and v [BH, Nkv, D], contiguous; Nq may differ from Nkv; no
// mask, no causal option. Same arithmetic as the Pallas bodies: the products
// run in the input type with f32 sums, the softmax statistics stay f32, and p
// and ds are rounded to the input type before their second product.
//
//   forward: s = q k^T * scale; running max m, p = exp(s - m), running sum l,
//            acc = acc * alpha + p v; out = acc / max(l, 1e-30); returns m, l
//   dQ:      p = exp(s - L), dp = dO v^T, ds = p (dp - delta) scale, dq += ds k
//   dK/dV:   dv += p^T dO, dk += ds^T q
//
// The TPU kernels walk KV (or Q) along a sequential grid axis and carry their
// sums in scratch from one grid step to the next. Blocks on this card run in
// any order, so here a block owns 64-row tiles of its output, one a
// warpgroup (query rows for the forward and dQ, key rows for dK/dV), and
// loops over the other
// sequence inside the block. Every output element has one owner: no atomics,
// and the result is the same from run to run. The kernels mask their own
// ragged last tiles: rows past the end are loaded as zeros, score columns
// past Nkv give p = 0, rows past the end are not written.
//
// What bounds them on the H100: operations. At [1, 8, 2048, 64] in bf16 the
// forward does 8.6 GFLOP on 8.5 MB (about 1000 FLOP per byte, the card's
// ridge is 295), so the tensor cores bound it (8.7 us at 989 TFLOP/s); dQ
// does 1.5x and dK/dV 2x that work on the same bytes. None of them writes
// the N x N matrix to device memory.
//
// The bf16 kernels (flash_fwd_bf16_kernel, flash_bwd_dq_bf16_kernel,
// flash_bwd_dkv_bf16_kernel) are built on what only this card has
// (wgmma.cuh):
//   - products are warpgroup `wgmma` m64nNk16 with the f32 sums in registers.
//     The register layout is documented, so a thread knows its rows: the
//     forward's row maximum and row sum are two shuffles inside a quad, the
//     running output is rescaled in its own registers, and p (ds) is rounded
//     to bf16 and handed to the second product as its A operand straight from
//     registers. Scores, p, ds and the accumulators never touch shared memory;
//   - dK/dV computes the transposed tiles, s^T = k q^T and dp^T = v dO^T, so
//     that its accumulator rows are the block's own key rows: p^T and ds^T
//     are elementwise (lse and delta belong to columns and come from a small
//     shared array), nothing is reduced, and dK, dV stay in registers for the
//     whole loop;
//   - what never changes inside a block is read once: the forward holds its
//     64 query rows in registers as the A operand of q k^T, dQ its Q and dO
//     rows as the A operands of q k^T and dO v^T (and lse, delta of its rows),
//     dK/dV keeps its K and V tiles in shared memory for the whole loop;
//   - the tiles that stream (K, V in the forward and dQ; Q, dO, lse, delta in
//     dK/dV)
//     arrive through a ring of shared-memory stages (3 and 4) filled by
//     cp.async, in the 128-byte (64-byte at head dim 32) swizzle that wgmma's
//     descriptors name, so the next tiles load while this one multiplies.
//     One block barrier a tile is all that is left;
//   - in the forward p v of tile u - 1 runs while the exponentials of tile u
//     are taken; the copy code has a branch-free path for whole tiles and
//     addresses computed once a thread (it was half of the loop);
//   - exp is one ex2 with scale * log2(e) folded into the argument (the
//     wrapper refuses a scale that is not positive).
// What ptxas allows shaped the loops: it serializes every wgmma of a kernel
// (a note in the build log, no error) when the groups committed depend on a
// branch, so first and last turns are peeled; and it ends a wgmma stage, by
// placing the wait there, at the first branch or warp shuffle after it, so
// only straight-line arithmetic can overlap a product: the row maxima, which
// shuffle, run with nothing in flight. What is left to a later change: q k^T
// of the next tile does not overlap the softmax of this one (only the other
// warpgroups of the SM fill that gap: four blocks of one warpgroup fit);
// two warpgroups that alternate under named barriers, a producer warp with
// TMA and a persistent grid are the known answers.
//
// dQ is the product the others are not: it needs no reduction across
// threads (lse and delta are known per row, so p = exp2(s c - lse') and ds =
// p (dp - delta) scale are straight-line arithmetic), so ptxas has no
// shuffle at which to end a stage. Its turn u starts q k^T and dO v^T of
// tile u, then dq += ds k of tile u - 1 (ds from registers, K MN-major from
// the same ring tile that served q k^T K-major), waits for the first group
// only, and takes p and ds of tile u while ds k runs. K and V tiles stay in
// the ring one turn longer for that, so the ring has at least 3 stages.
// Each dq element has one owner (no atomics; a fused dQ + dK/dV kernel
// would need them). What bounds it now: three products on the tensor cores
// and one barrier a tile, as in the forward.
//
// In f32 (the CLI's default precision), all three are 3xTF32 `wgmma`
// kernels (flash_fwd_tf32x3_kernel, flash_bwd_dq_tf32x3_kernel,
// flash_bwd_dkv_tf32x3_kernel), each fed by flash_tf32x3_image_kernel; their
// section says how and why.
//
// C interface (loaded with ctypes): each launcher enqueues its kernels (the
// f32 ones the preparation kernel first) on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float NEG = -1e30f;

// ------------------------------------------------------ forward, bf16 ---

// Tuning knobs (tools/tune_attention.py builds the variants): warpgroups a
// block and ring stages of each Hopper kernel.
#ifndef ADELL_FWD_WARPGROUPS
#define ADELL_FWD_WARPGROUPS 1
#endif
#ifndef ADELL_FWD_STAGES
#define ADELL_FWD_STAGES 3
#endif
#ifndef ADELL_DQ_WARPGROUPS
#define ADELL_DQ_WARPGROUPS 1
#endif
#ifndef ADELL_DQ_STAGES
#define ADELL_DQ_STAGES 3
#endif
#ifndef ADELL_DKV_WARPGROUPS
#define ADELL_DKV_WARPGROUPS 1
#endif
#ifndef ADELL_DKV_STAGES
#define ADELL_DKV_STAGES 4
#endif

// A block is NWG warpgroups, each owning 64 query rows, which it keeps in
// registers as the A operand of q k^T; K and V tiles of 64 rows stream
// through a ring of STAGES stages that all of the block's threads fill.
// Shared memory: the ring.
template <int D>
struct FwdPlan {
  static constexpr int NWG = ADELL_FWD_WARPGROUPS;
  static constexpr int STAGES = ADELL_FWD_STAGES;
  static_assert(STAGES >= 2, "a stage in use and one in flight");
  static constexpr int THREADS = 128 * NWG;
  static constexpr int ROWS = 64 * NWG;  // query rows per block
  static constexpr int STAGE_BYTES = 2 * hopper::Tile<D>::BYTES;
  // 1024 more: the kernel rounds its base up to the swizzle's alignment
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

// The online softmax of one 64 x N score tile held in registers (R = N / 2
// a thread: 64 x 64 in bf16, 64 x 32 in the 3xTF32 forward), in two halves.
// The first takes the new running maximum m (in units of s, the raw q k^T)
// and returns in a_lo, a_hi what the rows' earlier sums must be scaled by;
// it shuffles inside the quad, and ptxas ends a wgmma stage at a shuffle,
// so no product may be in flight here. c = scale * log2(e) > 0; with
// MASKED, columns from valid_cols on count as minus infinity (the
// sequence's last tile).
template <bool MASKED, int R>
__device__ __forceinline__ void softmax_max(float (&s)[R], float c,
                                            int valid_cols, int col0,
                                            float& m_lo, float& m_hi,
                                            float& a_lo, float& a_hi) {
  using namespace hopper;
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if ((i / 4) * 8 + col0 + (i % 2) >= valid_cols) s[i] = NEG;
  }
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((i / 2) % 2)
      mx_hi = fmaxf(mx_hi, s[i]);
    else
      mx_lo = fmaxf(mx_lo, s[i]);
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  a_lo = exp2_approx((m_lo - mx_lo) * c);
  a_hi = exp2_approx((m_hi - mx_hi) * c);
  m_lo = mx_lo;
  m_hi = mx_hi;
}

// The second half: s becomes p = exp(scale (s - m)) and l takes this
// thread's share of the row sums. Plain arithmetic, which may run while a
// product of other registers is in flight.
template <int R>
__device__ __forceinline__ void softmax_exp(float (&s)[R], float c,
                                            float m_lo, float m_hi,
                                            float a_lo, float a_hi,
                                            float& l_lo, float& l_hi) {
  using namespace hopper;
  const float off_lo = -m_lo * c, off_hi = -m_hi * c;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((i / 2) % 2) {
      s[i] = exp2_approx(fmaf(s[i], c, off_hi));
      sum_hi += s[i];
    } else {
      s[i] = exp2_approx(fmaf(s[i], c, off_lo));
      sum_lo += s[i];
    }
  }
  l_lo = l_lo * a_lo + sum_lo;
  l_hi = l_hi * a_hi + sum_hi;
}

// p of a score tile, rounded to bf16, as the A operand of p v.
__device__ __forceinline__ void pack_tile(uint32_t (&pa)[4][4],
                                          const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// The ring moves in steps: step u holds K tile u and V tile u - 1, which is
// what one turn of the loop consumes: q k^T of tile u, its row maxima, then
// p v of tile u - 1, which runs while the exponentials of tile u are taken.
template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::THREADS)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          int n_q, int n_kv, float scale) {
  using namespace hopper;
  using P = FwdPlan<D>;
  using T = Tile<D>;
  constexpr int NT = P::THREADS, STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sKV = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  // this thread's accumulator rows (of the warpgroup's 64) and first column
  const int row_lo = (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int bh = blockIdx.y, q0 = blockIdx.x * P::ROWS;
  const __nv_bfloat16* qb = q + (size_t)bh * n_q * D;
  const __nv_bfloat16* kb = k + (size_t)bh * n_kv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * n_kv * D;
  const int n_tiles = (n_kv + 63) / 64;

  const TileLoader<D, NT> loader(tid);
  // steps are loaded, and used, in order: two stage counters walk the ring
  int load_stage = 0, use_stage = 0;
  // one group per step, empty past the end, so that the wait counts groups
  auto load_step = [&](int u) {
    if (u <= n_tiles) {
      const uint32_t st = sKV + load_stage * P::STAGE_BYTES;
      if (u < n_tiles) loader.load(st, kb, u * 64, n_kv);
      if (u > 0) loader.load(st + T::BYTES, vb, (u - 1) * 64, n_kv);
    }
    load_stage = load_stage + 1 == STAGES ? 0 : load_stage + 1;
    cp_async_commit();
  };
  // Step u has landed for every thread, and every warpgroup is done with
  // step u - 1, whose stage the next load overwrites.
  auto step_ready = [&](int u) {
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    load_step(u + STAGES - 1);
    const uint32_t st = sKV + use_stage * P::STAGE_BYTES;
    use_stage = use_stage + 1 == STAGES ? 0 : use_stage + 1;
    return st;
  };
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) load_step(u);

  // this thread's part of its warpgroup's 64 query rows, as the A operand
  // of the D / 16 k-steps of q k^T; rows past the end are zeros
  const int r_lo = q0 + wg * 64 + row_lo, r_hi = r_lo + 8;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r % 2 ? r_hi : r_lo;
      const int col = 16 * kk + 8 * (r / 2) + col0;
      qa[kk][r] = row < n_q ? *reinterpret_cast<const uint32_t*>(
                                  qb + (size_t)row * D + col)
                            : 0u;
    }
  auto start_qk = [&](float(&s)[32], uint32_t st) {
    const uint64_t desc_k = T::desc(st);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64(s, qa[kk], desc_k + kk * T::K_STEP, kk > 0);
    wg_commit();
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running maximum of q k^T and this thread's share of the running sum,
  // for rows row_lo (lo) and row_lo + 8 (hi)
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;
  const float c = scale * LOG2E;
  float s[32];
  uint32_t pa[4][4];

  auto start_pv = [&](uint32_t st) {
    const uint64_t desc_v = T::desc(st + T::BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(o, pa[kk], desc_v + kk * T::MN_STEP);
    wg_commit();
  };

  // One turn. The exponentials hide p v; q k^T is waited for at once,
  // because the maxima that follow it shuffle.
  auto turn = [&](int u, auto first, auto masked) {
    const uint32_t st = step_ready(u);
    wg_fence();
    start_qk(s, st);
    wg_wait<0>();
    reg_fence(s);
    softmax_max<decltype(masked)::value>(s, c, n_kv - u * 64, col0, m_lo,
                                         m_hi, a_lo, a_hi);
    if (!decltype(first)::value) {
      wg_fence();
      start_pv(st);
    }
    softmax_exp(s, c, m_lo, m_hi, a_lo, a_hi, l_lo, l_hi);
    if (!decltype(first)::value) {
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pa);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i / 2) % 2 ? a_hi : a_lo;
    }
    pack_tile(pa, s);
  };
  // only the last tile is masked; the first has no p v to start
  if (n_tiles == 1) {
    turn(0, std::true_type{}, std::true_type{});
  } else {
    turn(0, std::true_type{}, std::false_type{});
    for (int u = 1; u < n_tiles - 1; ++u)
      turn(u, std::false_type{}, std::false_type{});
    turn(n_tiles - 1, std::false_type{}, std::true_type{});
  }
  {
    const uint32_t st = step_ready(n_tiles);
    wg_fence();
    start_pv(st);
    wg_wait<0>();
    reg_fence(o);
  }
  cp_async_wait<0>();

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (lane % 4 == 0) {
    if (r_lo < n_q) {
      m_out[(size_t)bh * n_q + r_lo] = m_lo * scale;
      l_out[(size_t)bh * n_q + r_lo] = l_lo;
    }
    if (r_hi < n_q) {
      m_out[(size_t)bh * n_q + r_hi] = m_hi * scale;
      l_out[(size_t)bh * n_q + r_hi] = l_hi;
    }
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = out + (size_t)bh * n_q * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_q)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * D + col) =
          pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (r_hi < n_q)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * D + col) =
          pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}


// ----------------------------------------------------------- dQ, bf16 ---

// A block is NWG warpgroups, each owning 64 query rows, whose Q and dO it
// keeps in registers as the A operands of q k^T and dO v^T; K and V tiles of
// 64 rows stream through a ring of STAGES stages. A tile stays in the ring
// one turn longer than in the forward: ds k of tile u runs in turn u + 1.
template <int D>
struct DqPlan {
  static constexpr int NWG = ADELL_DQ_WARPGROUPS;
  static constexpr int STAGES = ADELL_DQ_STAGES;
  static_assert(STAGES >= 3, "tiles u - 1 and u in use, one loading");
  static constexpr int THREADS = 128 * NWG;
  static constexpr int ROWS = 64 * NWG;  // query rows per block
  static constexpr int STAGE_BYTES = 2 * hopper::Tile<D>::BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

// Turn u: q k^T and dO v^T of tile u (one group), then dq += ds k of tile
// u - 1 (a second group), which runs while p and ds of tile u are taken:
// p = exp(s scale - lse) and ds = p (dp - delta) scale need no reduction
// across threads, so nothing but straight-line arithmetic stands between
// the products. The same K tile serves q k^T K-major and ds k MN-major.
template <int D>
__global__ void __launch_bounds__(DqPlan<D>::THREADS)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int n_q,
                             int n_kv, float scale) {
  using namespace hopper;
  using P = DqPlan<D>;
  using T = Tile<D>;
  constexpr int NT = P::THREADS, STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sKV = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row_lo = (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int bh = blockIdx.y, q0 = blockIdx.x * P::ROWS;
  const __nv_bfloat16* qb = q + (size_t)bh * n_q * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * n_q * D;
  const __nv_bfloat16* kb = k + (size_t)bh * n_kv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * n_kv * D;
  const int n_tiles = (n_kv + 63) / 64;

  const TileLoader<D, NT> loader(tid);
  int load_stage = 0, use_stage = 0;
  // one group per tile, empty past the end, so that the waits count groups
  auto load_tile = [&](int u) {
    if (u < n_tiles) {
      const uint32_t st = sKV + load_stage * P::STAGE_BYTES;
      loader.load(st, kb, u * 64, n_kv);
      loader.load(st + T::BYTES, vb, u * 64, n_kv);
    }
    load_stage = load_stage + 1 == STAGES ? 0 : load_stage + 1;
    cp_async_commit();
  };
  // Tile u has landed for every thread, and every warpgroup is done with
  // tile u - 2, whose stage the next load overwrites.
  auto tile_ready = [&](int u) {
    cp_async_wait<STAGES - 3>();
    fence_async_proxy();
    __syncthreads();
    load_tile(u + STAGES - 2);
    const uint32_t st = sKV + use_stage * P::STAGE_BYTES;
    use_stage = use_stage + 1 == STAGES ? 0 : use_stage + 1;
    return st;
  };
#pragma unroll
  for (int u = 0; u < STAGES - 2; ++u) load_tile(u);

  // this thread's part of its warpgroup's 64 rows of Q and dO, as A
  // operands; rows past the end are zeros, with lse = delta = 0 there
  const int r_lo = q0 + wg * 64 + row_lo, r_hi = r_lo + 8;
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r % 2 ? r_hi : r_lo;
      const size_t off = (size_t)row * D + 16 * kk + 8 * (r / 2) + col0;
      qa[kk][r] =
          row < n_q ? *reinterpret_cast<const uint32_t*>(qb + off) : 0u;
      da[kk][r] =
          row < n_q ? *reinterpret_cast<const uint32_t*>(dob + off) : 0u;
    }
  const float* lse_b = lse + (size_t)bh * n_q;
  const float* delta_b = delta + (size_t)bh * n_q;
  const float lse_lo = r_lo < n_q ? lse_b[r_lo] * LOG2E : 0.f;
  const float lse_hi = r_hi < n_q ? lse_b[r_hi] * LOG2E : 0.f;
  const float del_lo = r_lo < n_q ? delta_b[r_lo] : 0.f;
  const float del_hi = r_hi < n_q ? delta_b[r_hi] : 0.f;
  const float c = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t dsa[4][4];

  auto start_s_dp = [&](uint32_t st) {
    const uint64_t desc_k = T::desc(st), desc_v = T::desc(st + T::BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64(s, qa[kk], desc_k + kk * T::K_STEP, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64(dp, da[kk], desc_v + kk * T::K_STEP, kk > 0);
    wg_commit();
  };
  auto start_dq = [&](uint32_t st_prev) {
    const uint64_t desc_k = T::desc(st_prev);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc, dsa[kk], desc_k + kk * T::MN_STEP);
    wg_commit();
  };
  // ds of a tile in place of dp, from the f32 sums; with MASKED, columns
  // from valid_cols on are zeros (the sequence's last tile)
  auto take_ds = [&](int valid_cols, auto masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i / 2) % 2;
      const float p = exp2_approx(fmaf(s[i], c, -(hi ? lse_hi : lse_lo)));
      float ds = p * (dp[i] - (hi ? del_hi : del_lo)) * scale;
      if (decltype(masked)::value && (i / 4) * 8 + col0 + (i % 2) >= valid_cols)
        ds = 0.f;
      dp[i] = ds;
    }
  };
  auto pack_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
  };

  // One turn; the first has no ds k to start, only the last is masked.
  uint32_t st_prev = 0;
  auto turn = [&](int u, auto first, auto masked) {
    const uint32_t st = tile_ready(u);
    wg_fence();
    start_s_dp(st);
    if (!decltype(first)::value) start_dq(st_prev);
    if (decltype(first)::value)
      wg_wait<0>();
    else
      wg_wait<1>();
    reg_fence(s);
    reg_fence(dp);
    take_ds(n_kv - u * 64, masked);
    if (!decltype(first)::value) {
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(dsa);
    }
    pack_ds();
    st_prev = st;
  };
  if (n_tiles == 1) {
    turn(0, std::true_type{}, std::true_type{});
  } else {
    turn(0, std::true_type{}, std::false_type{});
    for (int u = 1; u < n_tiles - 1; ++u)
      turn(u, std::false_type{}, std::false_type{});
    turn(n_tiles - 1, std::false_type{}, std::true_type{});
  }
  wg_fence();
  start_dq(st_prev);
  wg_wait<0>();
  reg_fence(acc);
  cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + (size_t)bh * n_q * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_q)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_lo * D + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r_hi < n_q)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_hi * D + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// -------------------------------------------------------- dK/dV, bf16 ---

// A block is NWG warpgroups, each owning 64 key rows whose K and V tiles
// stay in shared memory; Q, dO, lse and delta tiles of 64 query rows stream
// through the ring. Shared memory: K tiles, V tiles, the ring's Q and dO
// tiles, then the ring's lse and delta rows.
template <int D>
struct DkvPlan {
  static constexpr int NWG = ADELL_DKV_WARPGROUPS;
  static constexpr int STAGES = ADELL_DKV_STAGES;
  static_assert(STAGES >= 2, "a stage in use and one in flight");
  static constexpr int THREADS = 128 * NWG;
  static constexpr int ROWS = 64 * NWG;  // key rows per block
  static constexpr int STAGE_BYTES = 2 * hopper::Tile<D>::BYTES;
  static constexpr int ROW_STAGE_BYTES = 2 * 64 * 4;  // lse and delta
  static constexpr int SMEM = 2 * NWG * hopper::Tile<D>::BYTES +
                              STAGES * (STAGE_BYTES + ROW_STAGE_BYTES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DkvPlan<D>::THREADS)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int n_q,
                              int n_kv, float scale) {
  using namespace hopper;
  using P = DkvPlan<D>;
  using T = Tile<D>;
  constexpr int NT = P::THREADS, STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + P::NWG * T::BYTES;
  const uint32_t sQdO = sV + P::NWG * T::BYTES;
  const uint32_t sRows = sQdO + STAGES * P::STAGE_BYTES;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row_lo = (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int bh = blockIdx.y, kv0 = blockIdx.x * P::ROWS;
  const __nv_bfloat16* qb = q + (size_t)bh * n_q * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * n_q * D;
  const float* lse_b = lse + (size_t)bh * n_q;
  const float* delta_b = delta + (size_t)bh * n_q;
  const int n_tiles = (n_q + 63) / 64;

  const TileLoader<D, NT> loader(tid);
  auto load_q = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % STAGES, r0 = t * 64;
      const uint32_t st = sQdO + stage * P::STAGE_BYTES;
      loader.load(st, qb, r0, n_q);
      loader.load(st + T::BYTES, dob, r0, n_q);
      // 64 lse and 64 delta values; zeros past the end, which keep p and ds
      // finite there (the zero rows of Q and dO then add nothing)
      if (tid < 128) {
        const int r = tid % 64;
        const bool ok = r0 + r < n_q;
        const float* src = (tid < 64 ? lse_b : delta_b) + (ok ? r0 + r : 0);
        cp_async_4(sRows + stage * P::ROW_STAGE_BYTES + tid * 4, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int w = 0; w < P::NWG; ++w) {
    loader.load(sK + w * T::BYTES, k + (size_t)bh * n_kv * D, kv0 + w * 64,
                n_kv);
    loader.load(sV + w * T::BYTES, v + (size_t)bh * n_kv * D, kv0 + w * 64,
                n_kv);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_q(t);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float c = scale * LOG2E;
  const uint64_t desc_k = T::desc(sK + wg * T::BYTES);
  const uint64_t desc_v = T::desc(sV + wg * T::BYTES);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    load_q(t + STAGES - 1);
    const int stage = t % STAGES;
    const uint32_t st = sQdO + stage * P::STAGE_BYTES;
    const uint64_t desc_q = T::desc(st), desc_do = T::desc(st + T::BYTES);
    const float* lse_s = rows + stage * (P::ROW_STAGE_BYTES / 4);
    const float* delta_s = lse_s + 64;

    // s^T = k q^T and dp^T = v dO^T: rows are this warpgroup's key rows,
    // columns the tile's query rows
    float st_acc[32], dpt_acc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st_acc, desc_k + kk * T::K_STEP, desc_q + kk * T::K_STEP,
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt_acc, desc_v + kk * T::K_STEP, desc_do + kk * T::K_STEP,
                   kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(st_acc);
    reg_fence(dpt_acc);

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale, in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
      const float2 de =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float lse_c = (e % 2 ? ls.y : ls.x) * LOG2E;
        const float delta_c = e % 2 ? de.y : de.x;
        const float p = exp2_approx(fmaf(st_acc[i], c, -lse_c));
        st_acc[i] = p;
        dpt_acc[i] = p * (dpt_acc[i] - delta_c) * scale;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] =
            pack_bf16(st_acc[8 * kk + 2 * r], st_acc[8 * kk + 2 * r + 1]);
        dsa[kk][r] =
            pack_bf16(dpt_acc[8 * kk + 2 * r], dpt_acc[8 * kk + 2 * r + 1]);
      }
    // dv += p^T dO and dk += ds^T q: the contraction runs down the tiles' rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dv_acc, pa[kk], desc_do + kk * T::MN_STEP);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dk_acc, dsa[kk], desc_q + kk * T::MN_STEP);
    wg_commit();
    wg_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
  }
  cp_async_wait<0>();

  const int r_lo = kv0 + wg * 64 + row_lo, r_hi = r_lo + 8;
  __nv_bfloat16* dkb = dk + (size_t)bh * n_kv * D;
  __nv_bfloat16* dvb = dv + (size_t)bh * n_kv * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_kv) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)r_lo * D + col) =
          pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)r_lo * D + col) =
          pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (r_hi < n_kv) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)r_hi * D + col) =
          pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)r_hi * D + col) =
          pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// ---------------------------------- forward, dQ and dK/dV, f32 (3xTF32) ---

// The f32 kernels on the tensor cores: each f32 product is three TF32
// `wgmma` products (3xTF32, as csrc/conv3d_tf32.cu): an operand v is split
// into big = tf32(v) and small = tf32(v - big), and a b is taken as small_a
// big_b + big_a small_b + big_a big_b. What the bf16 kernels do cannot be
// carried over as it is, for three reasons, and the design answers each:
//
//   - TF32 `wgmma` reads B K-major only (A from registers, or K-major from
//     shared memory). p v (forward) and ds k (dQ) contract over key rows,
//     p^T dO and ds^T q (dK/dV) over query rows, so their B operands are
//     the streamed tiles transposed: V^T, K^T, dO^T and Q^T. Of the two ways
//     out, a transposed copy
//     of each such tile and products swapped so that the tile becomes a
//     register A operand, the copy is taken: the swap would move p or ds,
//     big and small, through shared memory instead (as many bytes a tile,
//     written and read by the threads rather than copied), and at head dim
//     32 its A would have 32 rows of wgmma's 64.
//   - The B operands are activations, split anew every call. A small
//     preparation kernel (flash_tf32x3_image_kernel) writes, for each
//     streamed tile of 32 rows, an IMAGE of the bytes that one ring stage
//     holds: every panel big then small, already rounded to TF32 with
//     cvt.rna (as the conv prepares its weight), in the 128-byte swizzle,
//     rows past the sequence's end zero. The main kernel copies an image
//     with plain 16-byte cp.async, no index arithmetic and no masks; its
//     threads split only the A operands, in registers.
//   - The f32 sums of a product are not the next product's A fragment:
//     a thread's sums are columns 2t and 2t + 1 of each group of 8, the
//     TF32 A fragment takes k = t and t + 4 (t = lane % 4). A sum does not
//     care about the order of its terms, so the image stores each group of
//     8 rows of a transposed tile permuted (position p holds row 2p for p <
//     4, row 2 (p - 4) + 1 for p >= 4), and A fragment register r of k-step
//     j is sum register 4 j + (0, 2, 1, 3)[r]: no shuffle.
//
// Shared memory and registers bound the shapes. A panel (one operand of a
// streamed tile, 32 rows by D or D rows by 32) is 128 D bytes, big and
// small twice that: a forward stage (K, V^T) is 32 KB at D = 64, a dQ stage
// (K, V, K^T) 48 KB, a dK/dV stage (Q, dO, Q^T, dO^T and 32 lse and delta
// values) 65 KB. Stream tiles of 32 rows (not 64) keep the score tiles at
// 16 registers a thread and three (forward, dQ) or two (dK/dV) stages in
// shared memory. The fixed operands (the forward's query rows;
// dQ: the block's Q and dO rows; dK/dV: its K and V rows) are A operands:
// they stay raw in shared memory (rows padded by 4 f32, so that ldmatrix
// meets no bank conflict) and are split per k-step after an ldmatrix, as
// the conv splits its A. Each k-step's products are one commit group, and
// the next k-step's fragments are prepared while it runs (two buffers,
// wait<1>), so that no more than two k-steps' split fragments are live. A
// block is two warpgroups of 64 output rows that share the ring.
//
// The tensor cores' own f32 sums drop low bits at each product they add
// (as the conv found), so dq, dk and dv are summed in the tensor cores over
// SUM_TILES stream tiles (64 rows) at a time, and each such sum is added to
// f32 register sums rounded to nearest. The forward's output sums are
// rescaled by the online softmax every tile, so each tile's p v is a fresh
// tensor-core sum: acc = acc alpha + part, in f32 registers.
//
// What bounds them on the H100: operations, at the 3xTF32 rate (494.7 / 3
// TFLOP/s): at [2, 8, 2048, 64] the forward does 17.2 GFLOP (0.104 ms), dQ
// 25.8 (0.156 ms), dK/dV 34.4 (0.208 ms). The images add about 2x
// (forward), 3x (dQ) and 4x (dK/dV) the bytes of the tiles they are made
// from, read once and written once by the preparation kernel, then read
// from L2 by every block of the head.
namespace tf32x3 {

constexpr int NWG = 2;              // warpgroups a block
constexpr int THREADS = 128 * NWG;  // of the main kernels
constexpr int ROWS = 64 * NWG;      // output rows a block
constexpr int TILE = 32;            // rows of a streamed tile
constexpr int PREP_THREADS = 256;
// Stream tiles a tensor-core sum of dq, dk and dv takes before it is added
// to the f32 register sums: on the H100, sums of all 64 tiles at 2048
// tokens came to about 0.2 of the 1e-4 bound, of 2 or 1 tile to 0.05, in
// the same time within 1.4 % (PERF.md).
constexpr int SUM_TILES = 2;

// The bytes of a streamed tile's image, by kernel, and the shared memory
// of each kernel: the ring of images, then the raw A operands (one in the
// forward, two in the backward).
template <int D>
struct Plan {
  static_assert(D == 32 || D == 64, "head dims 32 and 64");
  static constexpr int PANEL = 128 * D;  // big or small half of a panel
  static constexpr int SUB = TILE * 128;  // a 32-row sub-tile of a panel
  // forward: K (32 rows by D), V^T (D rows by 32)
  static constexpr int FWD_IMAGE = 2 * 2 * PANEL;
  // dQ: K and V (32 rows by D), K^T (D rows by 32)
  static constexpr int DQ_IMAGE = 3 * 2 * PANEL;
  // dK/dV: Q and dO, Q^T and dO^T, then lse and delta of the 32 rows
  static constexpr int DKV_ROWS_AT = 4 * 2 * PANEL;
  static constexpr int DKV_IMAGE = DKV_ROWS_AT + 1024;
  // the forward's stages: 2 to 5 gave the same time within 1 % on the
  // H100 (PERF.md), every block of a head reading the same images from L2
  static constexpr int FWD_STAGES = 3;
  static constexpr int DQ_STAGES = 3;
  static constexpr int DKV_STAGES = 2;
  static constexpr int LDA = D + 4;  // f32 a row of a raw A operand
  static constexpr int A_BYTES = ROWS * LDA * 4;
  // 1024 more: the kernel rounds its base up to the swizzle's alignment
  static constexpr int FWD_SMEM = FWD_STAGES * FWD_IMAGE + A_BYTES + 1024;
  static constexpr int DQ_SMEM = DQ_STAGES * DQ_IMAGE + 2 * A_BYTES + 1024;
  static constexpr int DKV_SMEM = DKV_STAGES * DKV_IMAGE + 2 * A_BYTES + 1024;
  static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 &&
                    DKV_SMEM <= 232448,
                "shared memory");
};

// Writes the image of each 32-row tile of the streamed operands a and b
// ([BH, n, D] f32): kind 0 (dQ: a = K, b = V) panels a, b, a^T; kind 1
// (dK/dV: a = Q, b = dO) panels a, b, a^T, b^T, then lse and delta; kind 2
// (forward: a = K, b = V) panels a, b^T. Grid (tiles, BH). A panel is its big half then its small half; a half is
// sub-tiles of 32 (natural) or D (transposed) rows of 128 bytes whose
// 16-byte chunks are swizzled (chunk c of row r at c ^ (r % 8)). Rows past
// n are zeros.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    flash_tf32x3_image_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ image, int n, int kind) {
  using namespace hopper;
  using P = Plan<D>;
  constexpr int CHUNKS = P::PANEL / 16;  // 16-byte chunks of a half
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int row0 = tile * TILE;
  const int bytes = kind == 0   ? P::DQ_IMAGE
                    : kind == 1 ? P::DKV_IMAGE
                                : P::FWD_IMAGE;
  unsigned char* out = reinterpret_cast<unsigned char*>(image) +
                       ((size_t)bh * gridDim.x + tile) * bytes;
  const float* src_a = a + (size_t)bh * n * D;
  const float* src_b = b + (size_t)bh * n * D;
  const int panels = kind == 0 ? 3 : kind == 1 ? 4 : 2;
  for (int i = threadIdx.x; i < panels * CHUNKS; i += PREP_THREADS) {
    const int panel = i / CHUNKS, ci = i % CHUNKS;
    const float* src = panel % 2 ? src_b : src_a;
    float v[4];
    if (kind == 2 ? panel == 0 : panel < 2) {
      // natural: sub-tile ci / 256 holds columns 32 (ci / 256) .. + 31
      const int r = ci % 256 / 8, c = (ci % 8) ^ (r & 7);
      const int row = row0 + r, d = 32 * (ci / 256) + 4 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = row < n ? src[(size_t)row * D + d + e] : 0.f;
    } else {
      // transposed: row d, positions 4 c .. 4 c + 3 of the stream rows,
      // permuted inside each group of 8
      const int d = ci / 8, c = (ci % 8) ^ (d & 7);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (c / 2) + 2 * e + c % 2;
        v[e] = row < n ? src[(size_t)row * D + d] : 0.f;
      }
    }
    float hb[4], hs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hb[e] = __uint_as_float(to_tf32(v[e]));
      hs[e] = __uint_as_float(to_tf32(v[e] - hb[e]));
    }
    unsigned char* dst = out + panel * 2 * P::PANEL + ci * 16;
    *reinterpret_cast<float4*>(dst) = make_float4(hb[0], hb[1], hb[2], hb[3]);
    *reinterpret_cast<float4*>(dst + P::PANEL) =
        make_float4(hs[0], hs[1], hs[2], hs[3]);
  }
  // 32 lse, 32 delta and zeros to the end of the image
  static_assert(PREP_THREADS * 4 == P::DKV_IMAGE - P::DKV_ROWS_AT, "rows");
  if (kind == 1) {
    const int r = threadIdx.x % TILE, row = row0 + r;
    const float* rows = threadIdx.x < TILE ? lse : delta;
    reinterpret_cast<float*>(out + P::DKV_ROWS_AT)[threadIdx.x] =
        threadIdx.x < 2 * TILE && row < n ? rows[(size_t)bh * n + row]
                                          : 0.f;
  }
}

// Copies rows row0 .. row0 + ROWS - 1 of a [n_rows, D] matrix into a raw A
// operand (rows of LDA f32); rows past n_rows become zeros.
template <int D>
__device__ __forceinline__ void load_raw(uint32_t dst, const float* g,
                                         int row0, int n_rows) {
  using namespace hopper;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + (r * Plan<D>::LDA + c * 4) * 4,
                ok ? g + (size_t)(row0 + r) * D + c * 4 : g, ok);
  }
}

// Starts the copy of an image into a ring stage, one group.
__device__ __forceinline__ void load_image(uint32_t dst, const float* src,
                                           int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    hopper::cp_async_16(dst + 16 * i, src + 4 * i);
}

// The A fragment of k-step j of a product that takes 64 x 32 sums (s or dp
// of one warpgroup, 16 registers a thread) as its A operand: register r is
// sum 4 j + (0, 2, 1, 3)[r], which the image's row permutation matches.
__device__ __forceinline__ void sums_fragment(const float (&x)[16], int j,
                                              uint32_t (&a)[4]) {
  a[0] = __float_as_uint(x[4 * j]);
  a[1] = __float_as_uint(x[4 * j + 2]);
  a[2] = __float_as_uint(x[4 * j + 1]);
  a[3] = __float_as_uint(x[4 * j + 3]);
}

// d (+)= A B for one k-step: the three TF32 products, B the big and small
// halves of a panel at shared addresses b_big and b_big + PANEL; with fresh
// the first overwrites d.
template <int PANEL, int R>
__device__ __forceinline__ void products3(float (&d)[R],
                                          const uint32_t (&big)[4],
                                          const uint32_t (&small)[4],
                                          uint32_t b_big, bool fresh) {
  using namespace hopper;
  using T = Tile<64>;  // 128-byte rows: 32 f32 of the contraction
  wgmma_tf32(d, small, T::desc(b_big), fresh ? 0 : 1);
  wgmma_tf32(d, big, T::desc(b_big + PANEL), 1);
  wgmma_tf32(d, big, T::desc(b_big), 1);
}

// Turn u: the forward's part of stream tile u (32 key rows). s = q k^T
// against the K panel (k-steps of 8 along D, each one group), the online
// softmax of s in registers (row maxima by two quad shuffles, as in the
// bf16 forward), then p v against the V^T panel (k-steps of 8 key rows)
// into a fresh tensor-core sum, which the rescaled f32 register sums take.
// Every group is waited for within the turn, so the next turn may
// overwrite the stage of this one, and no commit group depends on a branch.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ image,
                            float* __restrict__ out, float* __restrict__ m_out,
                            float* __restrict__ l_out, int n_q, int n_kv,
                            float scale) {
  using namespace hopper;
  using P = Plan<D>;
  constexpr int STAGES = P::FWD_STAGES, KS = D / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sImg = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = sImg + STAGES * P::FWD_IMAGE;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int wrow = wg * 64 + (tid % 128) / 32 * 16;  // warp's first row
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int n_tiles = (n_kv + TILE - 1) / TILE;
  const float* img = image + (size_t)bh * n_tiles * (P::FWD_IMAGE / 4);

  // the first group: the block's query rows and the first image
  load_raw<D>(sQ, q + (size_t)bh * n_q * D, q0, n_q);
  auto load_tile = [&](int u) {
    if (u < n_tiles)
      load_image(sImg + u % STAGES * P::FWD_IMAGE,
                 img + (size_t)u * (P::FWD_IMAGE / 4), P::FWD_IMAGE);
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) load_tile(u);

  // this lane's ldmatrix row of its warp's 16 and half of a k-step
  const uint32_t a_off =
      (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * P::LDA * 4 +
      (lane >> 4) * 16;
  const int r_lo = q0 + wrow + lane / 4, r_hi = r_lo + 8;
  const int col0 = (lane % 4) * 2;
  const float c = scale * LOG2E;

  // f32 sums rounded to nearest, and the tensor cores' sum of one tile
  float acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running maximum of q k^T (unscaled) and this thread's share of the
  // running sum, for rows r_lo (lo) and r_hi (hi)
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;
  float s[16];
  uint32_t big[2][4], small[2][4];  // [buffer][register]

  for (int u = 0; u < n_tiles; ++u) {
    // tile u has landed for every thread, and every warpgroup is done with
    // tile u - 1, whose stage the next load overwrites
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    load_tile(u + STAGES - 1);
    const uint32_t st = sImg + u % STAGES * P::FWD_IMAGE;

    // s: panel K (0), k-step kk of sub-tile kk / 4
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      const int bf = kk & 1;
      ldmatrix_x4(raw, sQ + a_off + kk * 32);
      split(raw, big[bf], small[bf]);
      wg_fence();
      products3<P::PANEL>(s, big[bf], small[bf],
                          st + kk / 4 * P::SUB + kk % 4 * 32, kk == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(s);

    // the bf16 forward's online softmax; key columns past n_kv (the last
    // tile's zero rows) count as minus infinity, a select in every turn
    float a_lo, a_hi;
    softmax_max<true>(s, c, n_kv - u * TILE, col0, m_lo, m_hi, a_lo, a_hi);
    softmax_exp(s, c, m_lo, m_hi, a_lo, a_hi, l_lo, l_hi);

    // part = p v: panel V^T (1), k-step j of 8 key rows
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      uint32_t raw[4];
      const int bf = j & 1;
      sums_fragment(s, j, raw);
      split(raw, big[bf], small[bf]);
      wg_fence();
      products3<P::PANEL>(part, big[bf], small[bf],
                          st + 2 * P::PANEL + j * 32, j == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], (i / 2) % 2 ? a_hi : a_lo, part[i]);
  }
  cp_async_wait<0>();

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (lane % 4 == 0) {
    if (r_lo < n_q) {
      m_out[(size_t)bh * n_q + r_lo] = m_lo * scale;
      l_out[(size_t)bh * n_q + r_lo] = l_lo;
    }
    if (r_hi < n_q) {
      m_out[(size_t)bh * n_q + r_hi] = m_hi * scale;
      l_out[(size_t)bh * n_q + r_hi] = l_hi;
    }
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  float* ob = out + (size_t)bh * n_q * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_q)
      *reinterpret_cast<float2*>(ob + (size_t)r_lo * D + col) =
          make_float2(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
    if (r_hi < n_q)
      *reinterpret_cast<float2*>(ob + (size_t)r_hi * D + col) =
          make_float2(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
  }
}

// Turn u: dq's part of stream tile u (32 key rows). s = q k^T and dp = dO
// v^T (k-steps of 8 along D, each one group), p and ds from them, then dq
// += ds k against K^T (k-steps of 8 key rows). Every group is waited for
// within the turn, so the next turn may overwrite the stage of this one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ image,
                               float* __restrict__ dq, int n_q, int n_kv,
                               float scale) {
  using namespace hopper;
  using P = Plan<D>;
  constexpr int STAGES = P::DQ_STAGES, KS = D / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sImg = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = sImg + STAGES * P::DQ_IMAGE;
  const uint32_t sDo = sQ + P::A_BYTES;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int wrow = wg * 64 + (tid % 128) / 32 * 16;  // warp's first row
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int n_tiles = (n_kv + TILE - 1) / TILE;
  const float* img = image + (size_t)bh * n_tiles * (P::DQ_IMAGE / 4);

  // the first group: the block's Q and dO rows and the first image
  load_raw<D>(sQ, q + (size_t)bh * n_q * D, q0, n_q);
  load_raw<D>(sDo, dout + (size_t)bh * n_q * D, q0, n_q);
  auto load_tile = [&](int u) {
    if (u < n_tiles)
      load_image(sImg + u % STAGES * P::DQ_IMAGE,
                 img + (size_t)u * (P::DQ_IMAGE / 4), P::DQ_IMAGE);
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) load_tile(u);

  // this lane's ldmatrix row of its warp's 16 and half of a k-step
  const uint32_t a_off =
      (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * P::LDA * 4 +
      (lane >> 4) * 16;
  const int r_lo = q0 + wrow + lane / 4, r_hi = r_lo + 8;
  const int col0 = (lane % 4) * 2;
  const float* lse_b = lse + (size_t)bh * n_q;
  const float* delta_b = delta + (size_t)bh * n_q;
  const float lse_lo = r_lo < n_q ? lse_b[r_lo] * LOG2E : 0.f;
  const float lse_hi = r_hi < n_q ? lse_b[r_hi] * LOG2E : 0.f;
  const float del_lo = r_lo < n_q ? delta_b[r_lo] : 0.f;
  const float del_hi = r_hi < n_q ? delta_b[r_hi] : 0.f;
  const float c = scale * LOG2E;

  // f32 sums rounded to nearest, and the tensor cores' sum of the current
  // SUM_TILES tiles
  float acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[16], dp[16];
  uint32_t big[2][2][4], small[2][2][4];  // [buffer][operand][register]

  for (int u = 0; u < n_tiles; ++u) {
    // tile u has landed for every thread, and every warpgroup is done with
    // tile u - 1, whose stage the next load overwrites
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    load_tile(u + STAGES - 1);
    const uint32_t st = sImg + u % STAGES * P::DQ_IMAGE;

    // s and dp: panels K (0) and V (1), k-step kk of sub-tile kk / 4
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      const int bf = kk & 1;
      ldmatrix_x4(raw, sQ + a_off + kk * 32);
      split(raw, big[bf][0], small[bf][0]);
      ldmatrix_x4(raw, sDo + a_off + kk * 32);
      split(raw, big[bf][1], small[bf][1]);
      const uint32_t k_off = kk / 4 * P::SUB + kk % 4 * 32;
      wg_fence();
      products3<P::PANEL>(s, big[bf][0], small[bf][0], st + k_off, kk == 0);
      products3<P::PANEL>(dp, big[bf][1], small[bf][1],
                          st + 2 * P::PANEL + k_off, kk == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // ds in place of dp; key columns past n_kv (the last tile) are zeros
    const int valid = n_kv - u * TILE;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool hi = (i / 2) % 2;
      const float p = exp2_approx(fmaf(s[i], c, -(hi ? lse_hi : lse_lo)));
      const float ds = p * (dp[i] - (hi ? del_hi : del_lo)) * scale;
      dp[i] = (i / 4) * 8 + col0 + (i % 2) < valid ? ds : 0.f;
    }

    // dq += ds k: panel K^T (2), k-step j of 8 key rows
    const bool fresh = u % SUM_TILES == 0;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      uint32_t raw[4];
      const int bf = j & 1;
      sums_fragment(dp, j, raw);
      split(raw, big[bf][0], small[bf][0]);
      wg_fence();
      products3<P::PANEL>(part, big[bf][0], small[bf][0],
                          st + 4 * P::PANEL + j * 32, fresh && j == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(part);
    if (u % SUM_TILES == SUM_TILES - 1 || u == n_tiles - 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  float* dqb = dq + (size_t)bh * n_q * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_q)
      *reinterpret_cast<float2*>(dqb + (size_t)r_lo * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r_hi < n_q)
      *reinterpret_cast<float2*>(dqb + (size_t)r_hi * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Turn t: dk's and dv's part of stream tile t (32 query rows). The
// transposed scores s^T = k q^T and dp^T = v dO^T, whose rows are the
// block's key rows, give p^T and ds^T elementwise (lse and delta belong to
// columns and come with the image), then dv += p^T dO against dO^T and dk
// += ds^T q against Q^T.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ image,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int n_q, int n_kv,
                                float scale) {
  using namespace hopper;
  using P = Plan<D>;
  constexpr int STAGES = P::DKV_STAGES, KS = D / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t sImg = (raw_base + 1023u) & ~1023u;
  const uint32_t sK = sImg + STAGES * P::DKV_IMAGE;
  const uint32_t sV = sK + P::A_BYTES;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int wrow = wg * 64 + (tid % 128) / 32 * 16;
  const int bh = blockIdx.y, kv0 = blockIdx.x * ROWS;
  const int n_tiles = (n_q + TILE - 1) / TILE;
  const float* img = image + (size_t)bh * n_tiles * (P::DKV_IMAGE / 4);

  load_raw<D>(sK, k + (size_t)bh * n_kv * D, kv0, n_kv);
  load_raw<D>(sV, v + (size_t)bh * n_kv * D, kv0, n_kv);
  auto load_tile = [&](int t) {
    if (t < n_tiles)
      load_image(sImg + t % STAGES * P::DKV_IMAGE,
                 img + (size_t)t * (P::DKV_IMAGE / 4), P::DKV_IMAGE);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  const uint32_t a_off =
      (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * P::LDA * 4 +
      (lane >> 4) * 16;
  const int col0 = (lane % 4) * 2;
  const float c = scale * LOG2E;

  float dk_acc[D / 2], dv_acc[D / 2], dk_part[D / 2], dv_part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st_acc[16], dpt_acc[16];
  uint32_t big[2][2][4], small[2][2][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    load_tile(t + STAGES - 1);
    const uint32_t st = sImg + t % STAGES * P::DKV_IMAGE;

    // s^T and dp^T: panels Q (0) and dO (1)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      const int bf = kk & 1;
      ldmatrix_x4(raw, sK + a_off + kk * 32);
      split(raw, big[bf][0], small[bf][0]);
      ldmatrix_x4(raw, sV + a_off + kk * 32);
      split(raw, big[bf][1], small[bf][1]);
      const uint32_t k_off = kk / 4 * P::SUB + kk % 4 * 32;
      wg_fence();
      products3<P::PANEL>(st_acc, big[bf][0], small[bf][0], st + k_off,
                          kk == 0);
      products3<P::PANEL>(dpt_acc, big[bf][1], small[bf][1],
                          st + 2 * P::PANEL + k_off, kk == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(st_acc);
    reg_fence(dpt_acc);

    // p^T and ds^T in place; query columns past n_q have zero rows of Q and
    // dO and lse = delta = 0, so p = 1 and ds = 0 there and they add nothing
    const float* rows = reinterpret_cast<const float*>(
        smem_raw + (st + P::DKV_ROWS_AT - raw_base));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(rows + 8 * j + col0);
      const float2 de =
          *reinterpret_cast<const float2*>(rows + TILE + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float p = exp2_approx(
            fmaf(st_acc[i], c, -(e % 2 ? ls.y : ls.x) * LOG2E));
        st_acc[i] = p;
        dpt_acc[i] = p * (dpt_acc[i] - (e % 2 ? de.y : de.x)) * scale;
      }
    }

    // dv += p^T dO against dO^T (3), dk += ds^T q against Q^T (2)
    const bool fresh = t % SUM_TILES == 0;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      uint32_t raw[4];
      const int bf = j & 1;
      sums_fragment(st_acc, j, raw);
      split(raw, big[bf][0], small[bf][0]);
      sums_fragment(dpt_acc, j, raw);
      split(raw, big[bf][1], small[bf][1]);
      wg_fence();
      products3<P::PANEL>(dv_part, big[bf][0], small[bf][0],
                          st + 6 * P::PANEL + j * 32, fresh && j == 0);
      products3<P::PANEL>(dk_part, big[bf][1], small[bf][1],
                          st + 4 * P::PANEL + j * 32, fresh && j == 0);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(dk_part);
    reg_fence(dv_part);
    if (t % SUM_TILES == SUM_TILES - 1 || t == n_tiles - 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk_acc[i] += dk_part[i];
        dv_acc[i] += dv_part[i];
      }
    }
  }
  cp_async_wait<0>();

  const int r_lo = kv0 + wrow + lane / 4, r_hi = r_lo + 8;
  float* dkb = dk + (size_t)bh * n_kv * D;
  float* dvb = dv + (size_t)bh * n_kv * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r_lo < n_kv) {
      *reinterpret_cast<float2*>(dkb + (size_t)r_lo * D + col) =
          make_float2(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dvb + (size_t)r_lo * D + col) =
          make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (r_hi < n_kv) {
      *reinterpret_cast<float2*>(dkb + (size_t)r_hi * D + col) =
          make_float2(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<float2*>(dvb + (size_t)r_hi * D + col) =
          make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

}  // namespace tf32x3


// ----------------------------------------------------------- launchers ---

// Grid, block and shared memory of each kernel: the bf16 kernels, or for
// f32 the 3xTF32 ones.
template <typename T, int D>
struct Launch {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  using F = tf32x3::Plan<D>;
  static constexpr int FWD_ROWS = BF16 ? FwdPlan<D>::ROWS : tf32x3::ROWS;
  static constexpr int FWD_THREADS = BF16 ? FwdPlan<D>::THREADS : tf32x3::THREADS;
  static constexpr int FWD_SMEM = BF16 ? FwdPlan<D>::SMEM : F::FWD_SMEM;
  static constexpr int DQ_ROWS = BF16 ? DqPlan<D>::ROWS : tf32x3::ROWS;
  static constexpr int DQ_THREADS = BF16 ? DqPlan<D>::THREADS : tf32x3::THREADS;
  static constexpr int DQ_SMEM = BF16 ? DqPlan<D>::SMEM : F::DQ_SMEM;
  static constexpr int DKV_ROWS = BF16 ? DkvPlan<D>::ROWS : tf32x3::ROWS;
  static constexpr int DKV_THREADS = BF16 ? DkvPlan<D>::THREADS : tf32x3::THREADS;
  static constexpr int DKV_SMEM = BF16 ? DkvPlan<D>::SMEM : F::DKV_SMEM;
  // rows of a streamed tile, and bytes of its image (f32 only)
  static constexpr int TILE = BF16 ? 64 : tf32x3::TILE;
  static constexpr int FWD_IMAGE = BF16 ? 0 : F::FWD_IMAGE;
  static constexpr int DQ_IMAGE = BF16 ? 0 : F::DQ_IMAGE;
  static constexpr int DKV_IMAGE = BF16 ? 0 : F::DKV_IMAGE;
};

// The images of the 3xTF32 kernels (kind 0, dQ: a = K, b = V, n = Nkv;
// kind 1, dK/dV: a = Q, b = dO, n = Nq, with lse and delta; kind 2,
// forward: a = K, b = V, n = Nkv) into image, which holds BH * ceil(n /
// 32) of them.
template <int D>
int launch_image(int kind, const void* a, const void* b, const void* lse,
                 const void* delta, void* image, int bh, int n,
                 cudaStream_t st) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  dim3 grid((n + tf32x3::TILE - 1) / tf32x3::TILE, bh);
  tf32x3::flash_tf32x3_image_kernel<D>
      <<<grid, tf32x3::PREP_THREADS, 0, st>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(image), n, kind);
  return (int)cudaGetLastError();
}

// A kernel's attribute and launch, for the two families of each kernel.
template <typename K, typename... Args>
int launch_with(K kernel, dim3 grid, int threads, int smem, cudaStream_t st,
                Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The forward; image: the f32 kernel's workspace (unused in bf16), BH *
// ceil(Nkv / 32) images of K and V, written here before the kernel reads
// them.
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* m, void* l, void* image, int bh, int n_q, int n_kv,
               float scale, cudaStream_t st) {
  using L = Launch<T, D>;
  dim3 grid((n_q + L::FWD_ROWS - 1) / L::FWD_ROWS, bh);
  if constexpr (L::BF16) {
    return launch_with(
        flash_fwd_bf16_kernel<D>, grid, L::FWD_THREADS, L::FWD_SMEM, st,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(m), static_cast<float*>(l), n_q, n_kv, scale);
  } else {
    const int rc = launch_image<D>(2, k, v, nullptr, nullptr, image, bh, n_kv,
                                   st);
    if (rc != 0) return rc;
    return launch_with(
        tf32x3::flash_fwd_tf32x3_kernel<D>, grid, L::FWD_THREADS,
        L::FWD_SMEM, st, static_cast<const float*>(q),
        static_cast<const float*>(image), static_cast<float*>(out),
        static_cast<float*>(m), static_cast<float*>(l), n_q, n_kv, scale);
  }
}

// dQ; image: the f32 kernel's workspace (unused in bf16), BH * ceil(Nkv /
// 32) images of K and V, written here before the kernel reads them.
template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* image,
              int bh, int n_q, int n_kv, float scale, cudaStream_t st) {
  using L = Launch<T, D>;
  dim3 grid((n_q + L::DQ_ROWS - 1) / L::DQ_ROWS, bh);
  if constexpr (L::BF16) {
    return launch_with(
        flash_bwd_dq_bf16_kernel<D>, grid, L::DQ_THREADS, L::DQ_SMEM, st,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), n_q, n_kv, scale);
  } else {
    const int rc = launch_image<D>(0, k, v, nullptr, nullptr, image, bh, n_kv,
                                   st);
    if (rc != 0) return rc;
    return launch_with(
        tf32x3::flash_bwd_dq_tf32x3_kernel<D>, grid, L::DQ_THREADS,
        L::DQ_SMEM, st, static_cast<const float*>(q),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(image),
        static_cast<float*>(dq), n_q, n_kv, scale);
  }
}

// dK/dV; image as for dQ, of Q, dO, lse and delta (BH * ceil(Nq / 32)).
template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* image, int bh, int n_q, int n_kv, float scale,
               cudaStream_t st) {
  using L = Launch<T, D>;
  dim3 grid((n_kv + L::DKV_ROWS - 1) / L::DKV_ROWS, bh);
  if constexpr (L::BF16) {
    return launch_with(
        flash_bwd_dkv_bf16_kernel<D>, grid, L::DKV_THREADS, L::DKV_SMEM, st,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv, scale);
  } else {
    const int rc = launch_image<D>(1, q, dout, lse, delta, image, bh, n_q, st);
    if (rc != 0) return rc;
    return launch_with(
        tf32x3::flash_bwd_dkv_tf32x3_kernel<D>, grid, L::DKV_THREADS,
        L::DKV_SMEM, st, static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(image),
        static_cast<float*>(dk), static_cast<float*>(dv), n_q, n_kv, scale);
  }
}

// out[0..4]: rows of the output a block owns, threads a block, bytes of
// dynamic shared memory, rows of a streamed tile and bytes of its image (0:
// the kernel takes none), of kernel kind (0 forward, 1 dQ, 2 dK/dV).
template <typename T, int D>
int plan_of(int kind, int* out) {
  using L = Launch<T, D>;
  const int plans[3][5] = {
      {L::FWD_ROWS, L::FWD_THREADS, L::FWD_SMEM, L::TILE, L::FWD_IMAGE},
      {L::DQ_ROWS, L::DQ_THREADS, L::DQ_SMEM, L::TILE, L::DQ_IMAGE},
      {L::DKV_ROWS, L::DKV_THREADS, L::DKV_SMEM, L::TILE, L::DKV_IMAGE},
  };
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) out[i] = plans[kind][i];
  return 0;
}

// The head dims the kernels are built for; the wrapper refuses the rest.
#define ADELL_DISPATCH_HEAD_DIM(D, CALL32, CALL64) \
  switch (D) {                                     \
    case 32:                                       \
      return CALL32;                               \
    case 64:                                       \
      return CALL64;                               \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* out, void* m,
        void* l, void* image, int bh, int n_q, int n_kv, int d, float scale,
        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d,
      (launch_fwd<T, 32>(q, k, v, out, m, l, image, bh, n_q, n_kv, scale,
                         st)),
      (launch_fwd<T, 64>(q, k, v, out, m, l, image, bh, n_q, n_kv, scale,
                         st)))
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* image, int bh,
           int n_q, int n_kv, int d, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d,
      (launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, image, bh, n_q, n_kv,
                        scale, st)),
      (launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, image, bh, n_q, n_kv,
                        scale, st)))
}

template <typename T>
int plan(int kind, int d, int* out) {
  ADELL_DISPATCH_HEAD_DIM(d, (plan_of<T, 32>(kind, out)),
                          (plan_of<T, 64>(kind, out)))
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            void* image, int bh, int n_q, int n_kv, int d, float scale,
            void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d,
      (launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, image, bh, n_q,
                         n_kv, scale, st)),
      (launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, image, bh, n_q,
                         n_kv, scale, st)))
}

}  // namespace

// image: the f32 kernels' workspace, BH * ceil(Nkv / 32) (forward, dQ) or
// BH * ceil(Nq / 32) (dK/dV) images of adell_flash_plan_f32's size; null
// in bf16.
#define ADELL_FLASH_ENTRY_POINTS(SUFFIX, T)                                   \
  extern "C" int adell_flash_fwd_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* out, void* m,        \
      void* l, void* image, int bh, int n_q, int n_kv, int d, float scale,    \
      void* stream) {                                                         \
    return fwd<T>(q, k, v, out, m, l, image, bh, n_q, n_kv, d, scale,         \
                  stream);                                                    \
  }                                                                           \
  extern "C" int adell_flash_bwd_dq_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, void* image, int bh,      \
      int n_q, int n_kv, int d, float scale, void* stream) {                  \
    return bwd_dq<T>(q, k, v, dout, lse, delta, dq, image, bh, n_q, n_kv, d,  \
                     scale, stream);                                          \
  }                                                                           \
  extern "C" int adell_flash_bwd_dkv_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, void* image,    \
      int bh, int n_q, int n_kv, int d, float scale, void* stream) {          \
    return bwd_dkv<T>(q, k, v, dout, lse, delta, dk, dv, image, bh, n_q,      \
                      n_kv, d, scale, stream);                                \
  }                                                                           \
  extern "C" int adell_flash_plan_##SUFFIX(int kind, int d, int* out) {       \
    return plan<T>(kind, d, out);                                             \
  }

ADELL_FLASH_ENTRY_POINTS(bf16, __nv_bfloat16)
ADELL_FLASH_ENTRY_POINTS(f32, float)

// The 3xTF32 kernels' preparation alone, for tests: kind 0 (dQ) and 2
// (forward) write the images of a = K and b = V (n = Nkv), kind 1 (dK/dV)
// those of a = Q, b = dO, lse and delta (n = Nq), BH * ceil(n / 32) of
// them.
extern "C" int adell_flash_image_f32(int kind, const void* a, const void* b,
                                     const void* lse, const void* delta,
                                     void* image, int bh, int n, int d,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d, (launch_image<32>(kind, a, b, lse, delta, image, bh, n, st)),
      (launch_image<64>(kind, a, b, lse, delta, image, bh, n, st)))
}
