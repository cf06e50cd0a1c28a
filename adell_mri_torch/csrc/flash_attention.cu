// Blockwise (flash) softmax attention for Hopper: forward, dQ and dK/dV.
//
// Replaces the four TPU kernels of adell_mri_tpu/ops/pallas/attention.py:
//   flash_fwd_kernel     <- _flash_kernel_vmem and _flash_kernel (one function:
//                           the VMEM-resident variant only worked around a TPU
//                           compile-service fault)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel
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
// any order, so here a block owns one 64-row tile of its output (query rows
// for the forward and dQ, key rows for dK/dV) and loops over the other
// sequence inside the block. Every output element has one owner: no atomics,
// and the result is the same from run to run. The kernels mask their own
// ragged last tiles: rows past the end are loaded as zeros, score columns
// past Nkv give p = 0, rows past the end are not written.
//
// What bounds them on the H100: operations. At [1, 8, 2048, 64] in bf16 the
// forward does 8.6 GFLOP on 8.5 MB (about 1000 FLOP per byte, the card's
// ridge is 295), so the tensor cores bound it (8.7 us at 989 TFLOP/s); dQ
// does 1.5x and dK/dV 2x that work on the same bytes. The design feeds the
// tensor cores (bf16 WMMA 16x16x16, f32 accumulators) and never writes the
// N x N matrix to device memory: scores, p and ds live in shared memory.
// It is the simple version: the accumulators sit in shared memory between
// tiles (WMMA's register layout is opaque, and the row rescale needs rows),
// loads do not overlap the products (no cp.async, TMA or wgmma), and the
// products wait at block barriers. That is where the gap to the bound is.
//
// The f32 path is plain FMA on the same tiles (no TF32), for exact
// comparisons and f32 training.
//
// C interface (loaded with ctypes): each launcher enqueues one kernel on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key/value rows per tile
constexpr int THREADS = 128;  // 4 warps; two threads share a score row
constexpr int NWARPS = THREADS / 32;
constexpr int CPAD = 4;  // f32 tiles: rows stay 16-byte multiples for WMMA
constexpr float NEG = -1e30f;

static_assert(THREADS == 2 * BQ, "two threads per score row");

// Row padding of the tiles held in the input type: bf16 rows must stay
// 16-byte multiples for WMMA and the vector loads; an odd f32 row length
// spreads a column over all banks.
template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int V = 8;
};
template <>
struct Pad<float> {
  static constexpr int V = 1;
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Hands out 128-byte aligned pieces of the block's dynamic shared memory.
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += round128(n * (int)sizeof(U));
    return r;
  }
};

// Copies ROWS rows of D values, starting at row0 of a [n_rows, D] matrix,
// into a shared tile with row length ld; rows past n_rows become zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* tile, int ld, const T* g,
                                          int row0, int n_rows) {
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
      int r = idx / CH, c = (idx % CH) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < n_rows)
        v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(tile + r * ld + c) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
      int r = idx / D, c = idx % D;
      tile[r * ld + c] =
          (row0 + r < n_rows) ? g[(size_t)(row0 + r) * D + c] : T(0);
    }
  }
}

// Writes the first rows (< n_rows - row0) of an f32 shared tile to a
// [n_rows, D] matrix, each row divided by row_div[r] when given.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_tile(T* g, int row0, int n_rows,
                                           const float* tile, int ld,
                                           const float* row_div) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    int r = idx / D, c = idx % D;
    if (row0 + r < n_rows) {
      float v = tile[r * ld + c];
      if (row_div != nullptr) v = v / row_div[r];
      g[(size_t)(row0 + r) * D + c] = from_f<T>(v);
    }
  }
}

__device__ __forceinline__ void zero_tile(float* tile, int n) {
  for (int idx = threadIdx.x; idx < n; idx += THREADS) tile[idx] = 0.f;
}

// C[M, N] (+)= A[M, K] B[K, N] on tiles in shared memory, by the whole block.
// TA: A is stored transposed (A(i, k) at A[k * lda + i]); TB likewise
// (B(k, j) at B[j * ldb + k]). ACC adds to what C holds.
// bf16: each warp takes 16x16 tiles of C through the tensor cores.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void tile_mma(float* C, int ldc,
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb) {
  using LA = typename std::conditional<TA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major,
                                       wmma::row_major>::type;
  constexpr int TN = N / 16, TILES = (M / 16) * TN;
  const int warp = threadIdx.x / 32;
  for (int tile = warp; tile < TILES; tile += NWARPS) {
    const int i0 = (tile / TN) * 16, j0 = (tile % TN) * 16;
    float* cp = C + i0 * ldc + j0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, TA ? A + k0 * lda + i0 : A + i0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(b, TB ? B + j0 * ldb + k0 : B + k0 * ldb + j0,
                             ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// f32: one FMA chain per element of C.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void tile_mma(float* C, int ldc, const float* A,
                                         int lda, const float* B, int ldb) {
  for (int idx = threadIdx.x; idx < M * N; idx += THREADS) {
    const int i = idx / N, j = idx % N;
    float acc = ACC ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = fmaf(TA ? A[k * lda + i] : A[i * lda + k],
                 TB ? B[j * ldb + k] : B[k * ldb + j], acc);
    C[i * ldc + j] = acc;
  }
}

// Shared-memory layout of each kernel, in one place for the kernel (which
// carves it) and the launcher (which asks for its size).
template <typename T, int D>
struct Layout {
  static constexpr int LD = D + Pad<T>::V;    // q, k, v, dO tiles
  static constexpr int PLD = BK + Pad<T>::V;  // p, ds tiles (input type)
  static constexpr int SLD = BK + CPAD;       // score tiles (f32)
  static constexpr int OLD = D + CPAD;        // accumulators (f32)
  static constexpr int IN_TILE = round128(BQ * LD * (int)sizeof(T));
  static constexpr int P_TILE = round128(BQ * PLD * (int)sizeof(T));
  static constexpr int S_TILE = round128(BQ * SLD * 4);
  static constexpr int O_TILE = round128(BQ * OLD * 4);
  static constexpr int ROW = round128(BQ * 4);
  static constexpr int FWD = 3 * IN_TILE + S_TILE + P_TILE + O_TILE + ROW;
  static constexpr int DQ = 4 * IN_TILE + 2 * S_TILE + P_TILE + O_TILE;
  static constexpr int DKV = 4 * IN_TILE + 2 * S_TILE + 2 * P_TILE + 2 * O_TILE;
};
static_assert(BQ == BK, "the layout sizes Q-side and KV-side tiles alike");

// ------------------------------------------------------------- forward ---

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int n_q, int n_kv, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  T* Qs = carve.take<T>(BQ * L::LD);
  T* Ks = carve.take<T>(BK * L::LD);
  T* Vs = carve.take<T>(BK * L::LD);
  float* Ss = carve.take<float>(BQ * L::SLD);
  T* Ps = carve.take<T>(BQ * L::PLD);
  float* Os = carve.take<float>(BQ * L::OLD);
  float* Ls = carve.take<float>(BQ);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * n_q * D;
  const T* kb = k + (size_t)bh * n_kv * D;
  const T* vb = v + (size_t)bh * n_kv * D;

  load_tile<T, D, BQ>(Qs, L::LD, qb, q0, n_q);
  zero_tile(Os, BQ * L::OLD);

  // two neighbouring threads own one score row, columns interleaved
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  float m_run = NEG, l_run = 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += BK) {
    load_tile<T, D, BK>(Ks, L::LD, kb, kv0, n_kv);
    load_tile<T, D, BK>(Vs, L::LD, vb, kv0, n_kv);
    __syncthreads();
    tile_mma<BQ, BK, D, false, true, false>(Ss, L::SLD, Qs, L::LD, Ks, L::LD);
    __syncthreads();

    float* srow = Ss + row * L::SLD;
    float mx = NEG;
    for (int c = half; c < BK; c += 2) {
      float s = (kv0 + c < n_kv) ? srow[c] * scale : NEG;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    for (int c = half; c < BK; c += 2) {
      float p = expf(srow[c] - m_new);
      sum += p;
      Ps[row * L::PLD + c] = from_f<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    for (int c = half; c < D; c += 2) Os[row * L::OLD + c] *= alpha;
    __syncthreads();

    tile_mma<BQ, D, BK, false, false, true>(Os, L::OLD, Ps, L::PLD, Vs,
                                            L::LD);
    __syncthreads();
  }

  if (half == 0) {
    Ls[row] = fmaxf(l_run, 1e-30f);
    if (q0 + row < n_q) {
      m_out[(size_t)bh * n_q + q0 + row] = m_run;
      l_out[(size_t)bh * n_q + q0 + row] = l_run;
    }
  }
  __syncthreads();
  store_tile<T, D, BQ>(out + (size_t)bh * n_q * D, q0, n_q, Os, L::OLD, Ls);
}

// ------------------------------------------------------------------ dQ ---

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int n_q, int n_kv, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  T* Qs = carve.take<T>(BQ * L::LD);
  T* dOs = carve.take<T>(BQ * L::LD);
  T* Ks = carve.take<T>(BK * L::LD);
  T* Vs = carve.take<T>(BK * L::LD);
  float* Ss = carve.take<float>(BQ * L::SLD);
  float* dPs = carve.take<float>(BQ * L::SLD);
  T* dSs = carve.take<T>(BQ * L::PLD);
  float* dQs = carve.take<float>(BQ * L::OLD);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + (size_t)bh * n_kv * D;
  const T* vb = v + (size_t)bh * n_kv * D;

  load_tile<T, D, BQ>(Qs, L::LD, q + (size_t)bh * n_q * D, q0, n_q);
  load_tile<T, D, BQ>(dOs, L::LD, dout + (size_t)bh * n_q * D, q0, n_q);
  zero_tile(dQs, BQ * L::OLD);

  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool row_ok = q0 + row < n_q;
  const float lse_r = row_ok ? lse[(size_t)bh * n_q + q0 + row] : 0.f;
  const float delta_r = row_ok ? delta[(size_t)bh * n_q + q0 + row] : 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += BK) {
    load_tile<T, D, BK>(Ks, L::LD, kb, kv0, n_kv);
    load_tile<T, D, BK>(Vs, L::LD, vb, kv0, n_kv);
    __syncthreads();
    tile_mma<BQ, BK, D, false, true, false>(Ss, L::SLD, Qs, L::LD, Ks, L::LD);
    tile_mma<BQ, BK, D, false, true, false>(dPs, L::SLD, dOs, L::LD, Vs,
                                            L::LD);
    __syncthreads();
    for (int c = half; c < BK; c += 2) {
      float ds = 0.f;
      if (row_ok && kv0 + c < n_kv) {
        float p = expf(Ss[row * L::SLD + c] * scale - lse_r);
        ds = p * (dPs[row * L::SLD + c] - delta_r) * scale;
      }
      dSs[row * L::PLD + c] = from_f<T>(ds);
    }
    __syncthreads();
    tile_mma<BQ, D, BK, false, false, true>(dQs, L::OLD, dSs, L::PLD, Ks,
                                            L::LD);
    __syncthreads();
  }
  store_tile<T, D, BQ>(dq + (size_t)bh * n_q * D, q0, n_q, dQs, L::OLD,
                       nullptr);
}

// --------------------------------------------------------------- dK/dV ---

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int n_q, int n_kv, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver carve{smem};
  T* Ks = carve.take<T>(BK * L::LD);
  T* Vs = carve.take<T>(BK * L::LD);
  T* Qs = carve.take<T>(BQ * L::LD);
  T* dOs = carve.take<T>(BQ * L::LD);
  float* Ss = carve.take<float>(BQ * L::SLD);
  float* dPs = carve.take<float>(BQ * L::SLD);
  T* Ps = carve.take<T>(BQ * L::PLD);
  T* dSs = carve.take<T>(BQ * L::PLD);
  float* dKs = carve.take<float>(BK * L::OLD);
  float* dVs = carve.take<float>(BK * L::OLD);

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * BK;
  const T* qb = q + (size_t)bh * n_q * D;
  const T* dob = dout + (size_t)bh * n_q * D;

  load_tile<T, D, BK>(Ks, L::LD, k + (size_t)bh * n_kv * D, kv0, n_kv);
  load_tile<T, D, BK>(Vs, L::LD, v + (size_t)bh * n_kv * D, kv0, n_kv);
  zero_tile(dKs, BK * L::OLD);
  zero_tile(dVs, BK * L::OLD);

  const int row = threadIdx.x / 2, half = threadIdx.x % 2;

  for (int q0 = 0; q0 < n_q; q0 += BQ) {
    load_tile<T, D, BQ>(Qs, L::LD, qb, q0, n_q);
    load_tile<T, D, BQ>(dOs, L::LD, dob, q0, n_q);
    __syncthreads();
    tile_mma<BQ, BK, D, false, true, false>(Ss, L::SLD, Qs, L::LD, Ks, L::LD);
    tile_mma<BQ, BK, D, false, true, false>(dPs, L::SLD, dOs, L::LD, Vs,
                                            L::LD);
    __syncthreads();
    const bool row_ok = q0 + row < n_q;
    const float lse_r = row_ok ? lse[(size_t)bh * n_q + q0 + row] : 0.f;
    const float delta_r = row_ok ? delta[(size_t)bh * n_q + q0 + row] : 0.f;
    for (int c = half; c < BK; c += 2) {
      float p = 0.f, ds = 0.f;
      if (row_ok && kv0 + c < n_kv) {
        p = expf(Ss[row * L::SLD + c] * scale - lse_r);
        ds = p * (dPs[row * L::SLD + c] - delta_r) * scale;
      }
      Ps[row * L::PLD + c] = from_f<T>(p);
      dSs[row * L::PLD + c] = from_f<T>(ds);
    }
    __syncthreads();
    // dv += p^T dO and dk += ds^T q: the tiles hold p and ds as [q, kv]
    tile_mma<BK, D, BQ, true, false, true>(dVs, L::OLD, Ps, L::PLD, dOs,
                                           L::LD);
    tile_mma<BK, D, BQ, true, false, true>(dKs, L::OLD, dSs, L::PLD, Qs,
                                           L::LD);
    __syncthreads();
  }
  store_tile<T, D, BK>(dk + (size_t)bh * n_kv * D, kv0, n_kv, dKs, L::OLD,
                       nullptr);
  store_tile<T, D, BK>(dv + (size_t)bh * n_kv * D, kv0, n_kv, dVs, L::OLD,
                       nullptr);
}

// ----------------------------------------------------------- launchers ---

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* m, void* l, int bh, int n_q, int n_kv, float scale,
               cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr int bytes = Layout<T, D>::FWD;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((n_q + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(m),
      static_cast<float*>(l), n_q, n_kv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int n_q,
              int n_kv, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr int bytes = Layout<T, D>::DQ;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((n_q + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n_q, n_kv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int n_q, int n_kv, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  constexpr int bytes = Layout<T, D>::DKV;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((n_kv + BK - 1) / BK, bh);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv, scale);
  return (int)cudaGetLastError();
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
        void* l, int bh, int n_q, int n_kv, int d, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d, (launch_fwd<T, 32>(q, k, v, out, m, l, bh, n_q, n_kv, scale, st)),
      (launch_fwd<T, 64>(q, k, v, out, m, l, bh, n_q, n_kv, scale, st)))
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int n_q,
           int n_kv, int d, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d,
      (launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, n_q, n_kv, scale,
                        st)),
      (launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, n_q, n_kv, scale,
                        st)))
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int n_q, int n_kv, int d, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ADELL_DISPATCH_HEAD_DIM(
      d,
      (launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, n_q, n_kv,
                         scale, st)),
      (launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, n_q, n_kv,
                         scale, st)))
}

}  // namespace

#define ADELL_FLASH_ENTRY_POINTS(SUFFIX, T)                                   \
  extern "C" int adell_flash_fwd_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* out, void* m,        \
      void* l, int bh, int n_q, int n_kv, int d, float scale, void* stream) { \
    return fwd<T>(q, k, v, out, m, l, bh, n_q, n_kv, d, scale, stream);       \
  }                                                                           \
  extern "C" int adell_flash_bwd_dq_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, int bh, int n_q,          \
      int n_kv, int d, float scale, void* stream) {                           \
    return bwd_dq<T>(q, k, v, dout, lse, delta, dq, bh, n_q, n_kv, d, scale,  \
                     stream);                                                 \
  }                                                                           \
  extern "C" int adell_flash_bwd_dkv_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int bh,         \
      int n_q, int n_kv, int d, float scale, void* stream) {                  \
    return bwd_dkv<T>(q, k, v, dout, lse, delta, dk, dv, bh, n_q, n_kv, d,    \
                      scale, stream);                                         \
  }

ADELL_FLASH_ENTRY_POINTS(bf16, __nv_bfloat16)
ADELL_FLASH_ENTRY_POINTS(f32, float)
