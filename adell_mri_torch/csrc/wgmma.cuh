// Hopper (sm_90a) building blocks of the port's wgmma kernels (attention in
// bf16 and 3xTF32, conv forward and dx in bf16 and 3xTF32, wgrad): swizzled
// 64-row tiles in
// shared memory, asynchronous copies into them, the matrix
// descriptors that `wgmma` reads them through, and the warpgroup products
// themselves as inline PTX.
//
// A tile is 64 rows of D bf16 values (D = 64: 128-byte rows, D = 32: 64-byte
// rows, D = 16: 32-byte rows), rows back to back, with the 16-byte chunks of
// each row permuted by the swizzle the descriptor names (128-byte rows:
// chunk ^ (row % 8); 64-byte rows: chunk ^ ((row / 2) % 4); 32-byte rows:
// chunk ^ ((row / 4) % 2)). The swizzle is a function of the shared
// address, so a tile starts at a multiple of 1024 bytes. One tile serves both
// operand forms:
//   K-major  (the contraction runs along a row): a k-step of 16 values is 32
//            bytes further along the row;
//   MN-major (the contraction runs down the rows, `tnspB` = 1): a k-step is 16
//            rows further down.
// In both, the stride between groups of 8 rows is 8 rows' bytes.
//
// Register layout of a 64 x N f32 accumulator (N / 2 registers a thread):
// warp w of the warpgroup holds rows 16 w .. 16 w + 15; register i of lane l
// is row 16 w + l / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (l % 4) +
// i % 2. A quad (4 lanes) holds a whole row pair, and the bf16 pairs of
// registers 8 kk .. 8 kk + 7 are the A operand of k-step kk of a following
// product, which is how p and ds go from one product into the next without
// leaving registers.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------- asynchronous copies ---

// 16 bytes from device to shared memory; zeros when !valid (src is not read
// then, but must be an address inside the tensor).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// The same without the zero fill, for tiles that lie wholly inside.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's ordinary shared-memory writes (cp.async's among them)
// before later reads by wgmma, which go through the asynchronous proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- tiles ---

template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64, "rows of 32, 64 or 128 bytes");
  static constexpr int ROW_BYTES = 2 * D;
  static constexpr int BYTES = 64 * ROW_BYTES;
  static constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  // descriptor units (16 bytes) per k-step of 16
  static constexpr int K_STEP = 2;           // K-major: 32 bytes along the row
  static constexpr int MN_STEP = ROW_BYTES;  // MN-major: 16 rows down

  // Byte offset of chunk c of row r. Rows may run past 64: tiles stacked back
  // to back continue the pattern.
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    const int x = D == 64 ? (r & 7) : D == 32 ? ((r >> 1) & 3) : ((r >> 2) & 1);
    return r * ROW_BYTES + ((c ^ x) << 4);
  }

  // Matrix descriptor of the tile at shared address addr (1024-aligned):
  // start address, leading offset, stride between 8-row groups, swizzle
  // mode (1: 128 B, 2: 64 B, 3: 32 B). The leading offset is unused by a
  // layout one swizzle atom wide (1); an MN-major operand two atoms wide
  // (n128 from two 128-byte tiles) reads its second atom lbo bytes on.
  __device__ __forceinline__ static uint64_t desc(uint32_t addr,
                                                  uint32_t lbo = 16) {
    constexpr uint64_t sbo = (8 * ROW_BYTES) >> 4;
    constexpr uint64_t mode = D == 64 ? 1 : D == 32 ? 2 : 3;
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
           (sbo << 32) | (mode << 62);
  }
};

// One thread's share of copying 64-row tiles, NT threads to a tile: a pass
// copies NT / CHUNKS rows, and a thread's chunk column and swizzle term are
// the same in every pass, so its addresses are computed once.
template <int D, int NT>
struct TileLoader {
  using T = Tile<D>;
  static constexpr int ROWS_PER_PASS = NT / T::CHUNKS;
  static_assert(NT % T::CHUNKS == 0 && ROWS_PER_PASS % 8 == 0 &&
                    64 % ROWS_PER_PASS == 0,
                "whole passes that keep the swizzle term");
  static constexpr int PASSES = 64 / ROWS_PER_PASS;
  int r0;         // this thread's row in the first pass
  uint32_t soff;  // its byte offset in the tile
  int goff;       // its element offset from the tile's first row

  __device__ __forceinline__ explicit TileLoader(int tid)
      : r0(tid / T::CHUNKS),
        soff(T::offset(tid / T::CHUNKS, tid % T::CHUNKS)),
        goff(tid / T::CHUNKS * D + tid % T::CHUNKS * 8) {}

  // Starts the copy of rows row0 .. row0 + 63 of the [n_rows, D] matrix g
  // into the tile at shared address tile; rows past n_rows become zeros.
  __device__ __forceinline__ void load(uint32_t tile, const __nv_bfloat16* g,
                                       int row0, int n_rows) const {
    const __nv_bfloat16* src = g + (size_t)row0 * D + goff;
    const uint32_t dst = tile + soff;
    if (row0 + 64 <= n_rows) {  // the common case: no row to mask
#pragma unroll
      for (int i = 0; i < PASSES; ++i)
        cp_async_16(dst + i * ROWS_PER_PASS * T::ROW_BYTES,
                    src + i * ROWS_PER_PASS * D);
    } else {
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const bool ok = row0 + r0 + i * ROWS_PER_PASS < n_rows;
        cp_async_16(dst + i * ROWS_PER_PASS * T::ROW_BYTES,
                    ok ? src + i * ROWS_PER_PASS * D : g, ok);
      }
    }
  }
};

// ---------------------------------------------------------------- wgmma ---

// Before the first product of a batch: orders the warpgroup's earlier
// register and shared-memory accesses before the products' own.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of an accumulator across the point
// where its asynchronous products were waited for.
template <int R>
__device__ __forceinline__ void reg_fence(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// The same for the A operand of products that read it from registers.
template <int K>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// Four 8 x 8 bf16 matrices from shared memory into the A-operand registers
// of one k-step: lane l names the 16-byte row (l % 8) + 8 ((l / 8) % 2) of
// its warp's 16 rows, half l / 16 of the step's 16 values. Each lane's
// address is its own, so the rows may lie anywhere.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// The same with each 8 x 8 matrix transposed on the way: lane l names the
// 16-byte row of matrix l / 8, and a thread receives the elements of the
// transposed matrices. An A operand whose rows (M) lie contiguous in shared
// memory and whose k runs down the rows reads this way: matrix i holds rows
// 8 (i % 2) .. + 7 and k 8 (i / 2) .. + 7 of the warp's 16 x 16 step.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

#define ADELL_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major tiles in shared
// memory; acc == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8), ADELL_ACC8(d, 16),
        ADELL_ACC8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T: A from registers (four bf16 pairs
// a thread), B a K-major tile in shared memory; acc == 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8), ADELL_ACC8(d, 16),
        ADELL_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (four bf16 pairs a
// thread), B an MN-major tile in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8), ADELL_ACC8(d, 16),
        ADELL_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], as above.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 16] += A[64 x 16] B[16 x 16], as above (32-byte rows).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: B two 64-column MN-major atoms of
// 128-byte rows, the second lbo bytes after the first (Tile<64>::desc's
// lbo).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8), ADELL_ACC8(d, 16),
        ADELL_ACC8(d, 24), ADELL_ACC8(d, 32), ADELL_ACC8(d, 40),
        ADELL_ACC8(d, 48), ADELL_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// TF32 products, d[64 x N] (+)= A[64 x 8] B[N x 8]^T: A from registers
// (four TF32 values a thread, in f32's format: rows l / 4 and l / 4 + 8 of
// the warp's 16, k l % 4 and l % 4 + 4, the fragment ldmatrix_x4 loads from
// 32 bytes of f32 rows), B a K-major tile in shared memory (TF32 has no
// MN-major form); acc == 0 overwrites d. N = 16, 32 and 64 by the
// accumulator's size.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : ADELL_ACC8(d, 0), ADELL_ACC8(d, 8), ADELL_ACC8(d, 16),
        ADELL_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

// ------------------------------------------------------------ arithmetic ---

// 2^x in one instruction (relative error 2^-22; 0 for very negative x).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cvt.rna.tf32.f32: v rounded to TF32 (nearest, ties away from zero), in
// f32's format with the low 13 bits zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The 3xTF32 split of an A fragment a (four f32 a thread, as bits): big =
// tf32(v) and small = tf32(v - big), whose products small_a big_b + big_a
// small_b + big_a big_b keep f32's accuracy (the dropped small_a small_b is
// 2^-22 of the product).
__device__ __forceinline__ void split(const uint32_t (&a)[4],
                                      uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __uint_as_float(a[i]);
    big[i] = to_tf32(v);
    small[i] = to_tf32(v - __uint_as_float(big[i]));
  }
}

// Two floats rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hopper
