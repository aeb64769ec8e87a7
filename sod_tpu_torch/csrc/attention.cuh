// Softmax attention over one (image, head) for 64 query rows, bf16 in and
// out: the forward device code of K2 (csrc/flash_attention.cu, q/k/v as
// [B, H, N, d]) and, through vit_block.cuh's packed-qkv launch, of K1, K3's
// forward, K5 and K8 (q/k/v inside a packed [B, N, 3D] row).
//
// Rounding points of the Pallas kernels (sod_tpu/ops/fused_block.py
// `_kernel`, sod_tpu/ops/flash_attention.py `_fwd_kernel`):
//   s = (q.k^T in f32) * scale; keys >= n_real or masked -> -1e30
//   p = exp(s - max) / sum in f32, rounded to bf16 only after normalising
//   o = bf16(p_bf16 . v accumulated in f32)
// Two passes over the keys keep that order: pass 1 the row max and sum
// (online rescaling), pass 2 normalised p times v, so q.k^T is computed
// twice (6 N^2 d operations where one pass would need 4).  An online softmax
// in one pass would round unnormalised p instead.
//
// What bounds it on this card: operations.  At the train shape (N 785, d 64)
// an (image, head) moves ~0.4 MB and does ~0.24 GFLOP, far above the card's
// ~295 operations per byte, so the time goes where the tensor cores wait:
// for operands, for the softmax arithmetic between the two products, for
// shared-memory round trips.  The design keeps them fed:
//   * one warpgroup (4 warps, 128 threads) per 64 q rows, products on
//     `wgmma.mma_async` (m64nNk16).  s = q.k^T takes both operands from
//     shared memory through matrix descriptors (the Q tile is loaded once
//     and read in place for every key tile); o += p.v takes p from
//     registers and the V tile as the transposed B operand.
//   * score tiles stay in registers.  Warp w owns q rows 16w..16w+15; lane
//     (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 8j + 2t
//     and 8j + 2t + 1 of every 8-key block j of the 64 x 64 accumulator.
//     Mask, max, sum, exp and the cast of p to bf16 run on that layout (row
//     reductions are two quad shuffles), and the accumulator's layout is the
//     A operand's, so bf16 p feeds the second product as it stands: nothing
//     of a score tile crosses shared memory.
//   * copies in flight.  K and V tiles arrive through a ring of two stages
//     filled with `cp.async` 16-byte copies; the loads of tile j + 1 are
//     started before the products of tile j, with one `__syncthreads()` per
//     tile.  Each thread writes the swizzled address itself, so any row
//     stride works (the packed qkv rows of K1 too).
//   * shared-memory tiles are what the descriptors want: rows of 128 bytes
//     (64 bytes at d 32; two 64-column panels at d 128), 16-byte chunks
//     XOR-swizzled by the row (the 128- and 64-byte swizzle modes), tiles on
//     1024-byte boundaries.  One layout serves a tile as the K-major operand
//     (q.k^T) and as the transposed one (p.v).
//   * the key mask and the `key < n_real` test are read once per tile: 64
//     threads ballot them into two words of shared memory beside the tile; a
//     tile whose keys are all valid skips the masking.
//   * one `ex2` per element per pass: exp(s * scale - m) is
//     ex2(s * (scale * log2 e) - m * log2 e), a multiply-add and the
//     special-function unit; the division is one reciprocal per row.
//   * tiles wholly at or beyond n_real, and tiles whose keys are all masked,
//     are skipped: their p is exactly zero.
//   * five blocks fit an SM at d 64 (96 registers a thread, 42 KB of shared
//     memory): the 624 blocks of the train shape are one wave on 132 SMs, and
//     one block's softmax overlaps another's products.
// A product is started, committed and waited for before its accumulators are
// read; a block does not overlap its own softmax with its own products.
// Rows at or beyond `n_rows` are not in memory: their loads write zeros and
// their stores are skipped, so any N works.  A row whose keys are all masked
// has no defined result (callers keep one valid key, the CLS token).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sod {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;          // 4 warps: one warpgroup
constexpr int AQ = 64;                // attention q rows per block (16 per warp)
constexpr int AK = 64;                // attention keys per tile

// ---------------------------------------------------------------------------
// 64-row shared-memory tiles and cp.async
// ---------------------------------------------------------------------------

// bytes of a 64 x HD bf16 tile
template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return 64u * HD * 2u; }

// Byte offset of the 16-byte chunk `c` (columns 8c..8c+7) of row `r` in a
// 64 x HD tile: panels of min(HD, 64) columns, rows of 128 (64) bytes, the
// chunk index XORed with bits 7.. of the linear offset.
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
    constexpr int CPR = (HD < 64 ? HD : 64) / 8;      // chunks per panel row
    const uint32_t lin = (uint32_t)r * (CPR * 16) + (uint32_t)(c % CPR) * 16;
    return (uint32_t)(c / CPR) * (64u * CPR * 16) + (lin ^ (((lin >> 7) & (CPR - 1)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the swizzle patterns are functions of the shared address: tiles start on
// 1024-byte boundaries (the *_smem_bytes() sizes leave room for this)
constexpr size_t TILE_ALIGN = 1024;
__device__ __forceinline__ unsigned char* align_tiles(unsigned char* smem) {
    return smem + ((TILE_ALIGN - (smem_u32(smem) & (TILE_ALIGN - 1))) & (TILE_ALIGN - 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for this thread's copies and orders its shared-memory writes before
// the tensor cores' reads of them (which go through the async proxy)
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + 64) of a row-major bf16 matrix with HD columns and `stride`
// elements between rows, into the tile at shared address `dst`, as cp.async
// copies the caller commits; rows >= n_rows are written as zeros.  Thread t
// copies chunk t % (HD / 8) of rows t / (HD / 8) + k * (THREADS / (HD / 8)):
// the row step is a multiple of 8 (of 32 at d 32), so the swizzle of its
// chunk is the same in every row and the addresses step by constants.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          size_t stride, int r0, int n_rows) {
    constexpr int C = HD / 8, STEP = THREADS / C, ROW_BYTES = (HD < 64 ? HD : 64) * 2;
    const int row = threadIdx.x / C, c = threadIdx.x % C;
    const uint32_t d0 = dst + tile_off<HD>(row, c);
    const bf16* s0 = src + (size_t)(r0 + row) * stride + c * 8;
#pragma unroll
    for (int k = 0; k < 64 / STEP; ++k) {
        const uint32_t d = d0 + k * STEP * ROW_BYTES;
        if (r0 + row + k * STEP < n_rows)
            cp_async16(d, s0 + (size_t)(k * STEP) * stride);
        else
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(d), "r"(0) : "memory");
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// wgmma: the warpgroup's 64 x N products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of the accumulators across the
// asynchronous product's start and wait
template <int NB>
__device__ __forceinline__ void acc_fence(float (&acc)[NB][4]) {
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[jb][e])::"memory");
}

// Matrix descriptor of a tile (1024-byte aligned): 128-byte swizzle (64-byte
// at d 32), 8-row groups 8 rows apart, 64-column panels a tile's 64 rows
// apart (read only by the transposed operand at d 128)
template <int HD>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    constexpr uint64_t RB = (HD < 64 ? HD : 64) * 2;
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | (((64 * RB) >> 4) << 16) | (((8 * RB) >> 4) << 32)
           | ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

// d[64 x N] += a[64 x 16] . B[16 x N]: a is this warp's A fragment in
// registers, B a tile read through its descriptor as the transposed operand
// (its rows are contracted).  The operands after the descriptor: the
// predicate "accumulate into d", the signs of a and B, "B is transposed".
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[64 x 16]^T, both operands 16-column steps of
// tiles read through their descriptors, neither transposed; accumulate == 0
// overwrites d with the product
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T from two descriptors, neither
// transposed (wgmma_ss_n64's twin, twice the width)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate = 1) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Starts acc[64 x 64] += A[64 x HD] . T[64 x HD]^T for the warpgroup: the
// rows of tile `a` are the output rows (warp w holds rows 16w..16w+15 of
// acc), the rows of tile `b` the output columns, their columns are
// contracted.  The caller commits and waits (mma_wait).
template <int HD>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], uint32_t a, uint32_t b) {
    const uint64_t desc_a = tile_desc<HD>(a), desc_b = tile_desc<HD>(b);
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        const uint64_t off = (uint64_t)(((ks / 4) * 8192 + (ks % 4) * 32) >> 4);
        wgmma_ss_n64(acc, desc_a + off, desc_b + off);
    }
    wgmma_commit();
}

// Starts acc[64 x HD] += P[64 x 64] . T[64 x HD]: the tile's rows are
// contracted (p.v, ds.k, p^T.do, ds^T.q), so it is the transposed B operand;
// p holds this warp's A fragments of the four 16-column steps.
template <int HD>
__device__ __forceinline__ void mma_nn(float (&acc)[HD / 8][4], const uint32_t (&p)[4][4],
                                       uint32_t tile) {
    constexpr int RB = (HD < 64 ? HD : 64) * 2;
    const uint64_t desc = tile_desc<HD>(tile);
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        const uint64_t d = desc + (uint64_t)((ks * 16 * RB) >> 4);
        if constexpr (HD == 32) wgmma_rs_n32(acc, p[ks], d);
        else if constexpr (HD == 64) wgmma_rs_n64(acc, p[ks], d);
        else wgmma_rs_n128(acc, p[ks], d);
    }
    wgmma_commit();
}

// waits for every product started so far; `acc` is then safe to read
template <int NB>
__device__ __forceinline__ void mma_wait(float (&acc)[NB][4]) {
    wgmma_wait();
    acc_fence(acc);
}

// a 16 x 64 accumulator tile rounded to bf16 as the A fragments of mma_nn
__device__ __forceinline__ void pack_a(uint32_t (&p)[4][4], const float (&s)[8][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        p[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
        p[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
        p[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        p[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
    }
}

// 2^x on the special-function unit; exp(s * scale - m) is computed as
// exp2_fast(s * (scale * log2 e) - m * log2 e), one multiply-add and one
// `ex2` per element
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_fast(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// This warp's 16 x HD accumulators, rounded to bf16, to rows row0 + 16w.. of
// a global matrix (rows >= n_rows skipped), staged through the warp's own
// rows of the tile at `stage` for 16-byte stores.  The bf16 values stay in
// the tile (column sums are taken from them).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4], unsigned char* stage,
                                           bf16* __restrict__ out, size_t stride, int row0,
                                           int n_rows, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    __syncwarp();
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
        *reinterpret_cast<uint32_t*>(stage + tile_off<HD>(warp * 16 + g, jb) + t * 4) =
            pack_bf16(acc[jb][0], acc[jb][1]);
        *reinterpret_cast<uint32_t*>(stage + tile_off<HD>(warp * 16 + g + 8, jb) + t * 4) =
            pack_bf16(acc[jb][2], acc[jb][3]);
    }
    __syncwarp();
    constexpr int C = HD / 8;
#pragma unroll
    for (int i = lane; i < 16 * C; i += 32) {
        const int r = warp * 16 + i / C, c = i % C;
        if (row0 + r < n_rows)
            *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * stride + c * 8) =
                *reinterpret_cast<const uint4*>(stage + tile_off<HD>(r, c));
    }
}

// Q tile, two stages of (K tile, V tile), two stages of two key-validity words
template <int HD>
constexpr size_t attention_smem_bytes() {
    return TILE_ALIGN + (size_t)5 * tile_bytes<HD>() + 4 * sizeof(uint32_t);
}

// q, k, v: row 0 of this (image, head), `stride` elements between rows;
// o likewise with `stride_o`.  Computes rows [q0, q0 + 64).  mask: [n_rows]
// uint8 (nonzero = valid key) or NULL.  m_out / l_out (or NULL): each row's
// max logit and sum of exp(s - max), the backward's residuals.
template <int HD>
__device__ __forceinline__ void attention_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    size_t stride, const uint8_t* __restrict__ mask, bf16* __restrict__ o, size_t stride_o,
    float* __restrict__ m_out, float* __restrict__ l_out, int q0, int n_rows, int n_real,
    float scale, unsigned char* smem) {
    constexpr uint32_t TB = tile_bytes<HD>();
    smem = align_tiles(smem);
    const uint32_t sQ = smem_u32(smem), sK = sQ + TB, sV = sK + 2 * TB;
    uint32_t* kvalid = reinterpret_cast<uint32_t*>(smem + 5 * TB);      // [stage][2]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_keys = n_real < n_rows ? n_real : n_rows;
    const int T = (n_keys + AK - 1) / AK, J = 2 * T;     // jobs: pass 1 tiles, pass 2 tiles

    // copies of job `job` into stage job % 2: its K tile, in pass 2 its V
    // tile, and the validity of its 64 keys
    auto fetch = [&](int job) {
        const int st = job & 1, k0 = (job < T ? job : job - T) * AK;
        load_tile<HD>(sK + st * TB, k, stride, k0, n_rows);
        if (job >= T) load_tile<HD>(sV + st * TB, v, stride, k0, n_rows);
        if (threadIdx.x < 64) {
            const int key = k0 + threadIdx.x;
            const bool ok = key < n_real && (mask == nullptr || mask[key] != 0);
            const uint32_t bits = __ballot_sync(0xffffffffu, ok);
            if (lane == 0) kvalid[st * 2 + warp] = bits;
        }
        cp_async_commit();
    };

    load_tile<HD>(sQ, q, stride, q0, n_rows);
    fetch(0);

    float acc[HD / 8][4];
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jb][e] = 0.f;
    // per row (g and g + 8): running max of s, sum of exp, and for pass 2 the
    // reciprocal sum and the max in ex2's units
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
    float mc_run[2] = {0.f, 0.f};
    const float c2 = scale * LOG2E;

    for (int j = 0; j < J; ++j) {
        cp_async_wait_all();
        __syncthreads();             // job j has landed; stage (j + 1) % 2 is free
        if (j + 1 < J) fetch(j + 1);
        const int st = j & 1;
        // s holds q.k^T; the logit is s * scale, and c2 = scale * log2 e.  A
        // masked key's s becomes -1e30; a tile with no valid key adds exactly
        // zero to every sum and is skipped.
        const uint32_t w0 = kvalid[st * 2], w1 = kvalid[st * 2 + 1];
        if (j == T) {
            // pass 1 is over: each row's reciprocal sum and its max in ex2's units
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                inv_l[h] = 1.f / l_run[h];
                mc_run[h] = m_run[h] * c2;
            }
        }
        if ((w0 | w1) == 0u) continue;

        float s[8][4];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jb][e] = 0.f;
        mma_nt<HD>(s, sQ, sK + st * TB);
        mma_wait(s);

        if ((w0 & w1) != 0xffffffffu) {
#pragma unroll
            for (int jb = 0; jb < 8; ++jb) {
                const uint32_t bits = (jb < 4 ? w0 : w1) >> (8 * (jb & 3) + 2 * t);
                if (!(bits & 1u)) s[jb][0] = s[jb][2] = -1e30f;
                if (!(bits & 2u)) s[jb][1] = s[jb][3] = -1e30f;
            }
        }

        if (j < T) {
            // pass 1: row max (of s: scale > 0) and sum of exp(logit - max
            // logit), rescaled online
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float t_max = -INFINITY;
#pragma unroll
                for (int jb = 0; jb < 8; ++jb)
                    t_max = fmaxf(t_max, fmaxf(s[jb][2 * h], s[jb][2 * h + 1]));
                const float m_new = fmaxf(m_run[h], quad_max(t_max)), mc = m_new * c2;
                float t_sum = 0.f;
#pragma unroll
                for (int jb = 0; jb < 8; ++jb)
                    t_sum += exp2_fast(fmaf(s[jb][2 * h], c2, -mc))
                             + exp2_fast(fmaf(s[jb][2 * h + 1], c2, -mc));
                l_run[h] = l_run[h] * exp2_fast((m_run[h] - m_new) * c2) + quad_sum(t_sum);
                m_run[h] = m_new;
            }
        } else {
            // pass 2: p = exp(logit - max logit) / sum, rounded to bf16, times v
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[jb][e] = exp2_fast(fmaf(s[jb][e], c2, -mc_run[e >> 1])) * inv_l[e >> 1];
            uint32_t p[4][4];
            pack_a(p, s);
            mma_nn<HD>(acc, p, sV + st * TB);
            mma_wait(acc);
        }
    }

    // the Q tile is read no more: each warp's 16 rows of it stage its output
    __syncthreads();
    store_rows<HD>(acc, smem, o, stride_o, q0, n_rows, warp, lane);
    if (m_out != nullptr && t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + warp * 16 + g + 8 * h;
            if (row < n_rows) {
                m_out[row] = m_run[h] * scale;
                l_out[row] = l_run[h];
            }
        }
    }
}

}  // namespace sod
