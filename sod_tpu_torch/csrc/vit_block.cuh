// Device code of the ViT block kernels, shared by K1 (csrc/fused_block.cu),
// K3 and K5 (csrc/fused_attn.cu), K4 (csrc/fused_mlp.cu) and K8
// (csrc/fused_block_int8.cu):
//   * gemm_kernel: every product of the block, forward and backward, in
//     three operand layouts (enum Layout):
//       NT  C[M, N] = A[M, K] . W[N, K]^T, W in torch's (out, in) layout,
//           with an optional LayerNorm of A's rows: the forward projections;
//       NN  C[M, N] = A[M, K] . W[K, N], the weight untransposed (g . W):
//           the backward's input gradients, with the GELU-gradient epilogue;
//       TN  C[M, N] = A[K, M]^T . B[K, N], contracting the rows: the weight
//           gradients, the rows split over blocks into f32 partials that
//           reduce_partials_kernel sums in a fixed order (two stages, no
//           atomics: runs agree bit for bit);
//   * gemm_s8_kernel: K8's four projections, s8 x s8 -> s32 on the same
//     machinery (NT, producer warp, TMA ring, swizzled descriptors), with
//     the row quantisers in its prologue and K8's f32 epilogues;
//   * attention_kernel: per-head softmax attention over a packed qkv
//     [B, N, 3D] row layout (attention.cuh's two-pass device code);
// and, for the backward chains of K3 and K4:
//   * ln_rows_kernel: h = bf16(LayerNorm(x)), the forward's arithmetic;
//   * ln_bwd_kernel: LayerNorm backward + residual, with per-block partial
//     column sums for the LayerNorm and bias gradients.
//
// What bounds gemm_kernel on this card: at d 384 each form moves about as
// many bytes (A, W, residual and output, once each: 22.9 MB for K1's QKV at
// B=8) as the card streams in the time its tensor cores take for the products
// (6.3 GFLOP there): the bytes bound is 1.0-1.4x the operations bound, so
// neither may wait for the other.  The design keeps both in flight:
//   * `wgmma.mma_async` m64n128k16 (m64n64k16 for 64-column tiles), both
//     operands from 128-byte-swizzled shared memory through descriptors;
//     tiles of 128 x 128 (two consumer warpgroups sharing each W tile),
//     64 x 128 or 64 x 64, and the column tiles per block, planned per shape
//     (gemm_plan) so that the grid fills the SMs;
//   * the layouts differ only in which operand is read K-major and which
//     MN-major: a K-major tile is [rows][64 k] in 128-byte rows, an MN-major
//     one [64 k][64 columns] panels in 128-byte rows (W in NN and TN, A in
//     TN), read by the same descriptors with wgmma's transpose bits set and
//     16-row steps along k.  Every stage holds the same bytes in each layout;
//   * a producer warp keeps a ring of 64-deep stages filled by TMA (one
//     instruction a tile or 64-column panel, the hardware writes the swizzle
//     and zero-fills rows and columns out of bounds), each stage's arrival
//     and release counted on mbarriers: up to 7 stages in flight while the
//     consumers' products run;
//   * LayerNorm once per row panel: the block loads its rows over all of K
//     once, normalises them in place (one warp a row, 16-byte groups a
//     lane; ln_row_stats, the statistics of every LayerNorm here) and keeps
//     the panel in shared memory for the products of every column tile;
//     only W streams.  A projection without LN keeps its panel too at
//     K <= 384, else streams A beside W;
//   * the epilogue (bias, GELU, residual, the GELU gradient and its column
//     sums) on the accumulators' registers, bias and residuals loaded ahead
//     in groups, bf16 or f32 pairs stored straight to device memory, while
//     the next tile's loads land.  K4's GELU gradient recomputes its f32
//     hidden as a second product on the same tile (h . W1^T + b1 beside
//     dy . W2), so the [rows, 4d] f32 hidden never goes to device memory;
//   * TN: the contracted rows are cut into splits (gemm_tn_plan, a function
//     of the shape alone) so that tiles x splits fill one wave.
// The attention's products are attention.cuh's (wgmma on register-resident
// score tiles).
//
// Shape contract (checked by the Python wrappers): rows M % 64 == 0,
// N % 64 == 0, K % 32 == 0 (K <= 1024 with LayerNorm; TN: K % 64 == 0),
// attention rows per image % 64 == 0, head dim in {32, 64, 128}, 16-byte
// aligned contiguous tensors.  gemm_kernel also takes M % 128 == 64 in its
// 128-row tiles.
#pragma once

#include <cudaTypedefs.h>   // CUtensorMap, PFN_cuTensorMapEncodeTiled

#include <algorithm>
#include <type_traits>

#include "attention.cuh"

namespace sod {

// Epilogues: v = the f32 accumulator, b = bias (bf16; f32 in FBIAS_BF16),
// res = residual.
//   BIAS_BF16: bf16(v + b)                  GELU_BF16: bf16(tanh-GELU(v + b))
//   RES_F32:   f32((x0 + v) + b), x0 bf16   RES_BF16:  bf16((x1 + v) + b), x1 f32
//   RESB_BF16: bf16((x + v) + b), x bf16
//   BIAS_F32:  f32(v + b)
//   FBIAS_BF16: bf16(v + b) with b f32 (ops/layers.py `linear`: the f32 bias
//       added to the f32 product, one rounding)
//   GELU_SAVE_BF16: GELU_BF16, and bf16(v + b) (the pre-GELU hidden) to out2
// and without a bias (the backward):
//   BF16: bf16(v)                           F32: f32(v)
//   DGELU_BF16: a = res, the kept bf16 pre-GELU hidden; da = v * gelu'(a);
//       bf16(da) to out, bf16(gelu(a)) to out2, and the column sums of the f32
//       da over each 64 rows to colsum[M / 64][N]
//   DGELU_RC: DGELU_BF16 with a = f32(A2 . W2^T + b) recomputed in the same
//       kernel, a second product on the same tile (A2 [M][K], W2 [N][K]: K4's
//       h and W1, b its fc1 bias), the f32 hidden never stored
enum Epilogue { EPI_BIAS_BF16 = 0, EPI_GELU_BF16 = 1, EPI_RES_F32 = 2, EPI_RES_BF16 = 3,
                EPI_RESB_BF16 = 4, EPI_BIAS_F32 = 5, EPI_GELU_SAVE_BF16 = 6, EPI_BF16 = 7,
                EPI_F32 = 8, EPI_DGELU_BF16 = 9, EPI_DGELU_RC = 10, EPI_FBIAS_BF16 = 11 };

// Operand layouts of C[M, N] = sum over k of A(m, k) B(k, n), as stored
enum Layout { L_NT = 0,      // A [M][K], B [N][K]
              L_NN = 1,      // A [M][K], B [K][N]
              L_TN = 2 };    // A [K][M], B [K][N]

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

constexpr float GELU_C0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float GELU_C1 = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float h) {
    return 0.5f * h * (1.f + tanhf(GELU_C0 * (h + GELU_C1 * (h * h * h))));
}

// gelu_tanh(h) and its derivative d/dh (sod_tpu/ops/fused_mlp.py
// `_gelu_tanh_grad`) from one tanh: the same arithmetic as gelu_tanh
__device__ __forceinline__ void gelu_tanh_and_grad(float h, float& gelu, float& grad) {
    const float t = tanhf(GELU_C0 * (h + GELU_C1 * (h * h * h)));
    const float dh = GELU_C0 * (1.f + 3.f * GELU_C1 * (h * h));
    gelu = 0.5f * h * (1.f + t);
    grad = 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * dh;
}

// ---------------------------------------------------------------------------
// gemm_kernel: bf16 x bf16 with f32 accumulation on wgmma
// ---------------------------------------------------------------------------

constexpr int GK = 64;            // k per ring stage: one 128-byte swizzled row of bf16
// The epilogue's class for shared memory and the plan: 0 none, 1 the GELU
// gradient reading its hidden (column-sum scratch), 2 recomputing it (two
// products: two panels or A stages, two W tiles a stage)
__host__ __device__ constexpr int epi_kind(int epi) {
    return epi == EPI_DGELU_RC ? 2 : epi == EPI_DGELU_BF16 ? 1 : 0;
}
// ring stages: a kept panel leaves room for more of the (W only) stages; two
// products a stage take twice the bytes
__host__ __device__ constexpr int gemm_stages(bool panel, int kind = 0) {
    return kind == 2 ? 3 : panel ? 8 : 6;
}
constexpr int LN_MAX_DIM = 1024;  // LN forms take K <= 1024 (ops/fused_block.py MAX_DIM)
constexpr int LN_G = LN_MAX_DIM / 256;   // 8-element groups of a row per lane, at most

// LayerNorm statistics of one row by one warp, the one routine of every
// kernel's LayerNorm (gemm_kernel's panel, ln_rows_kernel, ln_bwd_kernel and
// K8's quantiser: the backward sees the forward's h and statistics bit for
// bit): lane l holds the row's 8-element groups l + 32 j in v[j] (groups at
// or beyond K / 8 are absent), sums them in that order, then across the warp.
// f32, two-pass variance; returns the mean and 1 / sqrt(var + eps).  NG, the
// groups a lane can hold, only sizes v: at K <= 256 NG the groups j >= NG
// are absent anyway, so every NG gives the same arithmetic.
template <int NG = LN_G>
__device__ __forceinline__ void ln_row_stats(const float (&v)[NG][8], int lane, int K, float eps,
                                             float& mean, float& rstd) {
    const int G = K / 8;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j)
        if (lane + 32 * j < G)
#pragma unroll
            for (int e = 0; e < 8; ++e) s = __fadd_rn(s, v[j][e]);
    mean = __fdiv_rn(warp_sum(s), (float)K);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j)
        if (lane + 32 * j < G)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float d = __fsub_rn(v[j][e], mean);
                q = __fmaf_rn(d, d, q);
            }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)K), eps));
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

// bf16((x - mean) * rstd * w + b) of one group: w8, b8 the LN parameters
__device__ __forceinline__ uint4 ln_group_apply(const float (&x)[8], float mean, float rstd,
                                                const uint4& w8, const uint4& b8) {
    float w[8], b[8], y[8];
    unpack_bf16x8(w8, w);
    unpack_bf16x8(b8, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __fmaf_rn(__fmul_rn(__fsub_rn(x[e], mean), rstd), w[e], b[e]);
    return make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                      pack_bf16(y[6], y[7]));
}

// group g (8 elements) of a bf16 or f32 row, as f32
__device__ __forceinline__ void load_group(const bf16* row, int g, float (&v)[8]) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 8 * g), v);
}
__device__ __forceinline__ void load_group(const float* row, int g, float (&v)[8]) {
    const float4 lo = *reinterpret_cast<const float4*>(row + 8 * g);
    const float4 hi = *reinterpret_cast<const float4*>(row + 8 * g + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// ln_row_stats of a bf16 or f32 row of K <= LN_MAX_DIM values in device memory
template <typename InT, typename = std::enable_if_t<!std::is_array<InT>::value>>
__device__ __forceinline__ void ln_row_stats(const InT* __restrict__ row, int lane, int K,
                                             float eps, float& mean, float& rstd) {
    float v[LN_G][8];
#pragma unroll
    for (int j = 0; j < LN_G; ++j)
        if (lane + 32 * j < K / 8) load_group(row, lane + 32 * j, v[j]);
    ln_row_stats(v, lane, K, eps, mean, rstd);
}

// ---------------------------------------------------------------------------
// TMA and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the producer's arrival, announcing `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}
// an arrival where `pred` holds, the predicate inside the instruction: no
// branch, so no divergent path around the products for ptxas to serialise
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
        "}\n" ::"r"(bar), "r"((int)pred) : "memory");
}
// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n"
        "}\n" ::"r"(bar), "r"(parity) : "memory");
}
// the box at (column c0, row r0) of a 2-D tensor map into shared memory at
// dst, its bytes completing on the barrier; rows and columns out of the
// tensor's bounds arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(c0), "r"(r0), "r"(bar) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x BNT] (+)= A[64 x 16] . B[16 x BNT], both operands through
// descriptors; TA / TB: the operand is stored MN-major (wgmma's transpose
// bits); accumulate == 0 overwrites d with the product
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64t(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128t(float (&d)[16][4], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
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
        "%64, %65, p, 1, 1, %67, %68;\n"
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
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int BNT, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BNT / 8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    if constexpr (BNT == 64) wgmma_ss_n64t<TA, TB>(d, desc_a, desc_b, accumulate);
    else wgmma_ss_n128t<TA, TB>(d, desc_a, desc_b, accumulate);
}

// The LN forms' A panel: the block's BMT rows over all of K, normalised once
// and kept for every k step, as ceil(K / 64) swizzled sub-panels of BMT
// 128-byte rows.  bf16 rows arrived raw by TMA (columns beyond K as zeros)
// and are normalised in place; f32 rows are read here, two at a time per
// warp, and the columns beyond K are zeroed.  Warp w of NW normalises rows
// w, w + NW, ...
template <typename InT, int BMT, int NT>
__device__ __forceinline__ void ln_panel(const InT* __restrict__ a, const bf16* __restrict__ ln_w,
                                         const bf16* __restrict__ ln_b, float eps, int m0, int M,
                                         int K, uint32_t panel) {
    constexpr int NW = NT / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, G = K / 8;
    uint4 w8[LN_G], b8[LN_G];
#pragma unroll
    for (int j = 0; j < LN_G; ++j)
        if (lane + 32 * j < G) {
            w8[j] = *reinterpret_cast<const uint4*>(ln_w + 8 * (lane + 32 * j));
            b8[j] = *reinterpret_cast<const uint4*>(ln_b + 8 * (lane + 32 * j));
        }
    auto addr = [&](int r, int g) {
        return panel + (uint32_t)(g >> 3) * (BMT * 128) + tile_off<64>(r, g & 7);
    };
    if (sizeof(InT) == 4 && K % 64) {
        const int tail = 8 - (K % 64) / 8;                  // chunks of the last sub-panel
        for (int i = threadIdx.x; i < BMT * tail; i += NT)
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                         ::"r"(addr(i / tail, G + i % tail)), "r"(0) : "memory");
    }
#pragma unroll 1
    for (int r = warp; r < BMT; r += 2 * NW) {
        const int rr[2] = {r, r + NW};
        float v[2][LN_G][8];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < LN_G; ++j) {
                const int g = lane + 32 * j;
                if (g < G && m0 + rr[i] < M) {
                    if constexpr (sizeof(InT) == 2) {
                        uint4 u;
                        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                                     : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                                     : "r"(addr(rr[i], g)));
                        unpack_bf16x8(u, v[i][j]);
                    } else {
                        load_group(a + (size_t)(m0 + rr[i]) * K, g, v[i][j]);
                    }
                }
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (m0 + rr[i] >= M) continue;          // zeros stay; no row is stored
            float mean, rstd;
            ln_row_stats(v[i], lane, K, eps, mean, rstd);
#pragma unroll
            for (int j = 0; j < LN_G; ++j) {
                const int g = lane + 32 * j;
                if (g < G) {
                    const uint4 y = ln_group_apply(v[i][j], mean, rstd, w8[j], b8[j]);
                    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                                 ::"r"(addr(rr[i], g)), "r"(y.x), "r"(y.y), "r"(y.z), "r"(y.w)
                                 : "memory");
                }
            }
        }
    }
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__host__ __device__ constexpr bool epi_has_bias(int epi) {
    return epi <= EPI_GELU_SAVE_BF16 || epi == EPI_DGELU_RC || epi == EPI_FBIAS_BF16;
}
__host__ __device__ constexpr bool epi_dgelu(int epi) { return epi_kind(epi) != 0; }
// the epilogue reads a second [M, N] input (`res`): a residual or the kept hidden
__host__ __device__ constexpr bool epi_reads_res(int epi) {
    return epi == EPI_RES_F32 || epi == EPI_RES_BF16 || epi == EPI_RESB_BF16 || epi == EPI_DGELU_BF16;
}

// the pair of `res` at element o as f32 (an f32 tensor for RES_BF16, else bf16)
template <int EPI>
__device__ __forceinline__ float2 load_res(const void* __restrict__ res, size_t o) {
    if (EPI == EPI_RES_BF16)
        return __ldg(reinterpret_cast<const float2*>(reinterpret_cast<const float*>(res) + o));
    return bf16x2_to_float2(
        __ldg(reinterpret_cast<const unsigned int*>(reinterpret_cast<const bf16*>(res) + o)));
}

// the bias pair at column c as f32 (an f32 bias for FBIAS_BF16, else bf16)
template <int EPI>
__device__ __forceinline__ float2 load_bias(const void* __restrict__ bias, int c) {
    if (EPI == EPI_FBIAS_BF16)
        return __ldg(reinterpret_cast<const float2*>(reinterpret_cast<const float*>(bias) + c));
    return bf16x2_to_float2(
        __ldg(reinterpret_cast<const unsigned int*>(reinterpret_cast<const bf16*>(bias) + c)));
}

// Epilogue of two neighbouring columns (col, col + 1) of one row, in
// registers: v the f32 accumulators, b the bias, x the pair of `res` (read
// by the RES and DGELU forms); o = row * N + col.  DGELU leaves the f32 da
// in v for the column sums.
template <int EPI>
__device__ __forceinline__ void epilogue_pair(float& v0, float& v1, float2 b, float2 x, size_t o,
                                              void* __restrict__ out, void* __restrict__ out2) {
    if (EPI == EPI_BIAS_BF16 || EPI == EPI_FBIAS_BF16) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) = pack_bf16(v0 + b.x, v1 + b.y);
    } else if (EPI == EPI_GELU_BF16 || EPI == EPI_GELU_SAVE_BF16) {
        const float h0 = v0 + b.x, h1 = v1 + b.y;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) =
            pack_bf16(gelu_tanh(h0), gelu_tanh(h1));
        if (EPI == EPI_GELU_SAVE_BF16)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out2) + o) = pack_bf16(h0, h1);
    } else if (EPI == EPI_BIAS_F32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0 + b.x, v1 + b.y);
    } else if (EPI == EPI_RES_F32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) =
            make_float2((x.x + v0) + b.x, (x.y + v1) + b.y);
    } else if (EPI == EPI_RES_BF16 || EPI == EPI_RESB_BF16) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) =
            pack_bf16((x.x + v0) + b.x, (x.y + v1) + b.y);
    } else if (EPI == EPI_BF16) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
    } else if (EPI == EPI_F32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0, v1);
    } else {                                                        // DGELU
        float g0, g1, d0, d1;
        gelu_tanh_and_grad(x.x, g0, d0);
        gelu_tanh_and_grad(x.y, g1, d1);
        v0 *= d0;
        v1 *= d1;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out2) + o) = pack_bf16(g0, g1);
    }
}

// bytes of the DGELU epilogues' column-sum scratch: [WG][4 warps][BNT] f32
__host__ __device__ constexpr uint32_t colsum_bytes(int wg, int bn) { return wg * 4 * bn * 4; }

// One block computes `tiles` column tiles of BMT x BNT, one after another,
// for one row panel of BMT = 64 WG rows: WG consumer warpgroups of 64 rows
// each (sharing every W tile) and one producer warp.  grid = (ceil(N / BNT /
// tiles), ceil(M / BMT), splits): the column blocks of one row panel run side
// by side, so A comes from device memory about once; TN's blocks z contract
// rows [z k_split, (z + 1) k_split) into the f32 partial out[z][M][N].
// Shared memory (1024-byte aligned):
//   PANEL: A panel [ceil(K / 64)][BMT][128 B], then STAGES W stages
//          [BNT][128 B].  The block's rows over all of K, loaded once (and
//          with LN normalised once) and read in place by every product of
//          every column tile; only W streams.  LN forms always take it.
//   else:  STAGES W stages, then STAGES A stages [BMT][128 B].
//   then the mbarriers: full[STAGES], empty[STAGES], panel; then, for the
//   DGELU epilogues, the column-sum scratch.
// DGELU_RC's second product doubles each: the A2 panel after A's (or each A
// stage followed by its A2 stage), each W stage followed by its W2 tile.
// A stage of an MN-major operand (W in NN and TN, A in TN) holds the same
// bytes as panels of [64 k][64 columns], 8 KB apart: the descriptor's
// leading offset.
// The producer walks the jobs (column tile, 64-deep k step) in order: it
// waits until a stage is empty and starts its TMA loads (128-byte swizzle:
// the layout the descriptors read), which complete on the stage's full
// barrier.  The consumers wait for a job's stage to be full, start its four
// wgmma k16 (eight with a second product) and release the previous job's
// stage once those products are done, so up to STAGES - 1 loads and two
// product groups are in flight; after a tile's last k step they wait for its
// products and run the epilogue on the accumulators while the next tile's
// loads land.  Rows >= M arrive as zeros and are never stored.
template <int EPI, bool LN, typename InT, int WG, int BNT, bool PANEL, int LAY>
__global__ void __launch_bounds__(128 * WG + 32)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_a2, const __grid_constant__ CUtensorMap map_w2,
            const InT* __restrict__ a_in, const bf16* __restrict__ ln_w,
            const bf16* __restrict__ ln_b, float eps, const void* __restrict__ bias,
            const void* __restrict__ res, void* __restrict__ out, void* __restrict__ out2,
            float* __restrict__ colsum, int M, int N, int K, int tiles, int k_split) {
    constexpr bool DUAL = EPI == EPI_DGELU_RC;
    static_assert(PANEL || !LN, "the LayerNorm forms keep their row panel");
    static_assert(LAY == L_NT || !LN, "LayerNorm only in the forward layout");
    static_assert(LAY != L_TN || !PANEL, "the row-contracting layout streams both operands");
    static_assert(!DUAL || LAY == L_NN, "the recomputing GELU gradient is an NN product");
    constexpr int STAGES = gemm_stages(PANEL, epi_kind(EPI)), NC = 128 * WG, BMT = 64 * WG;
    constexpr uint32_t WB = BNT * 128, AB = BMT * 128;     // bytes of one W / A tile
    constexpr uint32_t WS = DUAL ? 2 * WB : WB, AS = DUAL ? 2 * AB : AB;   // ... of a stage
    constexpr uint32_t PB = 64 * 128;                      // one 64 x 64 MN-major panel
    constexpr bool TMA_PANEL = PANEL && sizeof(InT) == 2;
    constexpr int TA = LAY == L_TN, TB = LAY != L_NT;      // MN-major operands
    // descriptor steps of one k16: 32 bytes along a K-major row, 16 rows of
    // 128 bytes down an MN-major panel (in the descriptor's 16-byte units)
    constexpr uint64_t SA = TA ? 128 : 2, SB = TB ? 128 : 2;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* const base = align_tiles(smem_raw);
    const uint32_t s0 = smem_u32(base);
    const int k0 = LAY == L_TN ? blockIdx.z * k_split : 0;
    const int nk = ((LAY == L_TN ? min(k_split, K - k0) : K) + GK - 1) / GK;
    const int nk_panel = (K + GK - 1) / GK;
    const uint32_t sW = PANEL ? s0 + (DUAL ? 2 : 1) * nk_panel * AB : s0;
    const uint32_t sA = PANEL ? s0 : s0 + STAGES * WS;
    const uint32_t full = sW + STAGES * WS + (PANEL ? 0 : STAGES * AS), empty = full + 8 * STAGES,
                   panel_bar = empty + 8 * STAGES;
    const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.y * BMT, ct0 = blockIdx.x * tiles;
    const int n_tiles = min(tiles, N / BNT - ct0), n_jobs = n_tiles * nk;
    if (LAY == L_TN) out = reinterpret_cast<float*>(out) + (size_t)blockIdx.z * M * N;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * WG);       // one arrival per consumer warp
        }
        mbar_init(panel_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp_id == 4 * WG) {
        // the producer
        if (lane == 0) {
            if (TMA_PANEL) {
                mbar_expect_tx(panel_bar, (DUAL ? 2 : 1) * nk * AB);
                for (int kt = 0; kt < nk; ++kt) {
                    tma_load_2d(sA + kt * AB, &map_a, kt * GK, m0, panel_bar);
                    if (DUAL) tma_load_2d(sA + (nk + kt) * AB, &map_a2, kt * GK, m0, panel_bar);
                }
            }
            for (int j = 0, tile = 0, kt = 0; j < n_jobs; ++j) {
                const int st = j % STAGES, n0 = (ct0 + tile) * BNT, kk = k0 + kt * GK;
                const uint32_t bar = full + 8 * st;
                if (j >= STAGES) mbar_wait(empty + 8 * st, ((j / STAGES) - 1) & 1);
                mbar_expect_tx(bar, PANEL ? WS : WS + AS);
                if (LAY == L_NT) {
                    tma_load_2d(sW + st * WS, &map_w, kk, n0, bar);
                } else {
                    for (int p = 0; p < BNT / 64; ++p)
                        tma_load_2d(sW + st * WS + p * PB, &map_w, n0 + 64 * p, kk, bar);
                }
                if (DUAL) tma_load_2d(sW + st * WS + WB, &map_w2, kk, n0, bar);
                if (!PANEL) {
                    if (LAY == L_TN) {
                        for (int p = 0; p < WG; ++p)
                            tma_load_2d(sA + st * AS + p * PB, &map_a, m0 + 64 * p, kk, bar);
                    } else {
                        tma_load_2d(sA + st * AS, &map_a, kk, m0, bar);
                    }
                    if (DUAL) tma_load_2d(sA + st * AS + AB, &map_a2, kk, m0, bar);
                }
                if (++kt == nk) {
                    kt = 0;
                    ++tile;
                }
            }
        }
        return;
    }

    if constexpr (LN) {
        if constexpr (TMA_PANEL) mbar_wait(panel_bar, 0);
        ln_panel<InT, BMT, NC>(a_in, ln_w, ln_b, eps, m0, M, K, s0);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");     // the consumers only
    } else if constexpr (TMA_PANEL) {
        mbar_wait(panel_bar, 0);
    }

    // Only wgmma writes the accumulators and no product sits on a divergent
    // path (else ptxas serialises the products): a tile's first k16 step
    // overwrites them, lane 0 of each consumer warp arrives on the empty
    // barriers through a predicate inside the instruction, and the first k
    // step of a tile is peeled, so that each later one releases its
    // predecessor's stage unconditionally.
    float acc[BNT / 8][4];
    float acc2[DUAL ? BNT / 8 : 1][4];              // DUAL: the recomputed hidden's product
    const int wg = tid >> 7, warp = warp_id & 3, g = lane >> 2, t = lane & 3;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
    const uint32_t a_wg = sA + wg * 64 * 128;       // K-major rows, or this WG's MN-major panel
    auto mma = [&](int j, int kt, bool first) {
        const int st = j % STAGES;
        mbar_wait(full + 8 * st, (j / STAGES) & 1);
        const uint64_t da = tile_desc<64>(PANEL ? a_wg + kt * AB : a_wg + st * AS);
        const uint64_t db = tile_desc<64>(sW + st * WS);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < GK / 16; ++ks)
            wgmma_ss<BNT, TA, TB>(acc, da + ks * SA, db + ks * SB, !first || ks > 0);
        if constexpr (DUAL) {
            const uint64_t da2 = tile_desc<64>(PANEL ? a_wg + (nk + kt) * AB : a_wg + st * AS + AB);
            const uint64_t db2 = tile_desc<64>(sW + st * WS + WB);
#pragma unroll
            for (int ks = 0; ks < GK / 16; ++ks)
                wgmma_ss<BNT, 0, 0>(acc2, da2 + ks * 2, db2 + ks * 2, !first || ks > 0);
        }
        wgmma_commit();
    };
    // DGELU_BF16's kept hidden of the whole tile, loaded before its products
    // so that the loads land while they run (rows >= M read row M - 1 and
    // are never stored)
    constexpr bool PRE = EPI == EPI_DGELU_BF16;
    float2 xp[PRE ? BNT / 8 : 1][2];
    for (int tile = 0, j = 0; tile < n_tiles; ++tile) {
        if constexpr (PRE) {
            const int n0 = (ct0 + tile) * BNT;
#pragma unroll
            for (int i = 0; i < BNT / 8; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xp[i][h] = load_res<EPI>(res, (size_t)min(row0 + 8 * h, M - 1) * N + n0
                                                      + 8 * i + 2 * t);
        }
        mma(j++, 0, true);
        for (int kt = 1; kt < nk; ++kt, ++j) {
            mma(j, kt, false);
            wgmma_wait_pending<1>();
            mbar_arrive_if(empty + 8 * ((j - 1) % STAGES), lane == 0);
        }
        // the tile's bias, loaded while its last products run
        const int n0 = (ct0 + tile) * BNT;
        float2 bv[BNT / 8];
#pragma unroll
        for (int i = 0; i < BNT / 8; ++i)
            bv[i] = epi_has_bias(EPI) ? load_bias<EPI>(bias, n0 + 8 * i + 2 * t)
                                      : make_float2(0.f, 0.f);
        wgmma_wait_pending<0>();
        mbar_arrive_if(empty + 8 * ((j - 1) % STAGES), lane == 0);
        acc_fence(acc);
        if constexpr (DUAL) acc_fence(acc2);
        // the epilogue on the accumulators: warp w of warpgroup wg holds rows
        // 64 wg + 16 w + g and + 8, columns 8 i + 2 t and + 1.  Residuals are
        // loaded EC column blocks at a time, all in flight together.
        constexpr int EC = 4;
#pragma unroll
        for (int i0 = 0; i0 < BNT / 8; i0 += EC) {
            float2 xv[EC][2];
#pragma unroll
            for (int i = 0; i < EC; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + 8 * h;
                    if constexpr (DUAL)          // the hidden a = f32(h . W1^T + b1)
                        xv[i][h] = make_float2(acc2[i0 + i][2 * h] + bv[i0 + i].x,
                                               acc2[i0 + i][2 * h + 1] + bv[i0 + i].y);
                    else if constexpr (PRE)
                        xv[i][h] = xp[i0 + i][h];
                    else
                        xv[i][h] = epi_reads_res(EPI) && row < M
                            ? load_res<EPI>(res, (size_t)row * N + n0 + 8 * (i0 + i) + 2 * t)
                            : make_float2(0.f, 0.f);
                }
#pragma unroll
            for (int i = 0; i < EC; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + 8 * h, col = n0 + 8 * (i0 + i) + 2 * t;
                    if (row < M)
                        epilogue_pair<EPI>(acc[i0 + i][2 * h], acc[i0 + i][2 * h + 1], bv[i0 + i],
                                           xv[i][h], (size_t)row * N + col, out, out2);
                }
        }
        if constexpr (epi_dgelu(EPI)) {
            // the column sums of the f32 da over this warpgroup's 64 rows
            // (rows >= M hold zeros), in a fixed order: a thread's two rows,
            // the eight row groups of a warp by shuffles, the four warps in
            // order, to colsum[panel of 64 rows][N]
            float* cs = reinterpret_cast<float*>(base + (panel_bar + 8 - s0 + 15) / 16 * 16)
                        + wg * 4 * BNT;
#pragma unroll
            for (int i = 0; i < BNT / 8; ++i) {
                float c0 = acc[i][0] + acc[i][2], c1 = acc[i][1] + acc[i][3];
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
                    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
                }
                if (g == 0) {
                    cs[warp * BNT + 8 * i + 2 * t] = c0;
                    cs[warp * BNT + 8 * i + 2 * t + 1] = c1;
                }
            }
            asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
            const int c = tid & 127, panel = blockIdx.y * WG + wg;
            if (c < BNT && panel * 64 < M)
                colsum[(size_t)panel * N + n0 + c] =
                    ((cs[c] + cs[BNT + c]) + cs[2 * BNT + c]) + cs[3 * BNT + c];
            asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        }
        acc_fence(acc);
        if constexpr (DUAL) acc_fence(acc2);
    }
}

// One block per (64 q rows, head, image) over qkv [B, N, 3D] -> out [B, N, D]
// (device code in attention.cuh, shared with the K2 forward).  m, l: each
// row's softmax max and sum, f32 [B, H, N], the backward's residuals, or NULL.
template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ key_mask,
                 bf16* __restrict__ out, float* __restrict__ m, float* __restrict__ l,
                 int N, int D, int n_real, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t row3 = (size_t)3 * D;
    const bf16* base = qkv + (size_t)b * N * row3 + h * HD;
    const size_t stat = ((size_t)b * gridDim.y + h) * N;      // m, l: [B, H, N] or NULL
    attention_block<HD>(base, base + D, base + 2 * D, row3,
                        key_mask ? key_mask + (size_t)b * N : nullptr,
                        out + (size_t)b * N * D + h * HD, D, m ? m + stat : nullptr,
                        m ? l + stat : nullptr, blockIdx.x * AQ, N, n_real, scale, smem);
}

// Configurations of gemm_kernel: warpgroups (64 rows each), columns, and
// whether A's row panel is kept (PANEL) or streamed beside W.
struct GemmConfig { int wg, bn; bool panel; };
constexpr int GEMM_CONFIGS = 6;
constexpr GemmConfig GEMM_CONFIG[GEMM_CONFIGS] = {
    {2, 128, true}, {1, 128, true}, {1, 64, true},
    {2, 128, false}, {1, 128, false}, {1, 64, false}};
constexpr size_t GEMM_SMEM_MAX = 232448;      // dynamic shared memory of one block

inline int sm_count() {
    static const int n = [] {
        int dev = 0, v = 132;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
        return v;
    }();
    return n;
}

// kind: epi_kind of the epilogue (its column-sum scratch, its second product)
inline size_t gemm_smem(const GemmConfig& c, int K, int kind) {
    const size_t rows = 64 * c.wg, nk = (K + GK - 1) / GK, stages = gemm_stages(c.panel, kind);
    const size_t two = kind == 2 ? 2 : 1;
    return TILE_ALIGN + two * (c.panel ? nk * rows * 128 + stages * c.bn * 128
                                       : stages * (rows + c.bn) * 128)
           + (2 * stages + 1) * 8                        // the mbarriers
           + (kind ? 16 + colsum_bytes(c.wg, c.bn) : 0);
}

inline bool gemm_config_fits(int i, bool ln, int N, int K, int kind = 0) {
    if (i < 0 || i >= GEMM_CONFIGS) return false;
    const GemmConfig& c = GEMM_CONFIG[i];
    return (c.panel || !ln) && N % c.bn == 0 && gemm_smem(c, K, kind) <= GEMM_SMEM_MAX;
}

// config: an index of GEMM_CONFIG; tiles: column tiles per block; split: the
// contracted rows per block of a TN product (0: all of them)
struct GemmPlan { int config, tiles, split; };

// The configuration and column tiles per block for an NT or NN shape, a rule
// read off the times of every configuration and split at K1's, K3's and K4's
// shapes on an H100 (chip_smoke.py phase 3 prints each shape's plan;
// tools/gemm_sweep.py times the others).  A's row panel is kept with LN and
// at K <= 384, else streamed beside W.  Tiles:
//   * the GELU gradient (kind 1, 2), whose epilogue does more than its
//     products: 64 x 64 (kind 1) or 64 x 128 (kind 2: two products a tile),
//     the columns cut into as many groups as give the grid three blocks an
//     SM (kind 1: three sit on an SM at once, one's products beside
//     another's epilogue; kind 2 fills an SM's shared memory alone: three
//     waves of shorter blocks measured faster than one or two longer);
//   * a form without LN with a wave of 128-row panels or more: 128 x 128
//     streamed, one a block;
//   * 128 x 128 where there are sms / 4 panels of 128 rows, the tile fits
//     and its column tiles split evenly over the column groups one wave
//     holds beside the panels (or the panels alone fill a wave);
//   * else 64 x 128 where there are sms / 4 panels of 64 rows and it fits,
//     else 64 x 64.
// The columns are cut into as many groups as one wave holds beside the row
// panels (at least one): the tiles per block.
inline GemmPlan gemm_plan(bool ln, int M, int N, int K, int kind = 0) {
    const int sms = sm_count(), p128 = (M + 127) / 128, p64 = (M + 63) / 64;
    const bool panel = ln || K <= 384;
    auto groups = [&](int n_ct, int panels) {
        return std::min(n_ct, std::max(1, sms / panels));
    };
    auto fits = [&](int i) { return gemm_config_fits(i, ln, N, K, kind); };
    if (kind) {
        int c = kind == 1 ? (panel ? 2 : 5) : (panel ? 1 : 4);
        if (!fits(c)) c = panel ? 2 : 5;
        if (!fits(c)) return {-1, 1, 0};
        const int n_ct = N / GEMM_CONFIG[c].bn;
        const int g = std::min(n_ct, std::max(1, (3 * sms + p64 - 1) / p64));
        return {c, (n_ct + g - 1) / g, 0};
    }
    if (!ln && p128 >= sms && fits(3)) return {3, 1, 0};
    const int c128 = panel ? 0 : 3;
    if (p128 >= sms / 4 && fits(c128)) {
        const int n_ct = N / 128, g = groups(n_ct, p128);
        if (p128 >= sms || n_ct % g == 0) return {c128, (n_ct + g - 1) / g, 0};
    }
    int c = panel ? 1 : 4;                                          // 64 x 128
    if (p64 < sms / 4 || !fits(c)) c = panel ? 2 : 5;               // 64 x 64
    if (!fits(c)) return {-1, 1, 0};
    const int n_ct = N / GEMM_CONFIG[c].bn, g = groups(n_ct, p64);
    return {c, (n_ct + g - 1) / g, 0};
}

// The configuration and row split of a TN product C[M, N] over K contracted
// rows, read off the same sweep: streamed tiles, one a block, the rows cut
// into as many splits of a multiple of 64 rows as one wave holds beside the
// tiles (at least one); 128 x 128 unless its splits would hold fewer than
// 1024 rows (16 k steps), then 64 x 128 (64 x 64 where N takes no 128-column
// tiles).  A function of the shape alone, so runs agree bit for bit.
inline GemmPlan gemm_tn_plan(int M, int N, int K) {
    const int sms = sm_count();
    auto split_of = [&](int c) {
        const GemmConfig& cfg = GEMM_CONFIG[c];
        const int tiles = ((M + 64 * cfg.wg - 1) / (64 * cfg.wg)) * (N / cfg.bn);
        const int want = std::max(1, std::min(sms / tiles, K / GK));
        return ((K + want - 1) / want + GK - 1) / GK * GK;
    };
    if (N % 128) return {5, 1, split_of(5)};
    const int s = split_of(3);
    if (s >= 16 * GK || s >= K) return {3, 1, s};
    return {4, 1, split_of(4)};
}

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
    static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                             &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
            p = nullptr;
        return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }();
    return fn;
}

// The tensor map of a row-major bf16 (s8: int8 codes) [rows, cols] matrix,
// read in boxes of 128 bytes of columns (64 bf16, 128 codes; swizzled as the
// descriptors expect) x box_rows rows
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                                   int box_rows, bool s8 = false) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t elem_bytes = s8 ? 1 : sizeof(bf16);
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, const_cast<void*>(ptr), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major bf16 or f32 [rows, cols] matrix read in
// unswizzled boxes of box_cols elements x box_rows rows: gemm_s8_kernel's
// prologue jobs, whose rows the consumers read in place
inline cudaError_t make_rows_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                                 int box_rows, int elem_bytes, int box_cols) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, elem[2] = {1, 1};
    const CUresult r = encode(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              2, const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The operands of one gemm_kernel launch: C[M, N] over K.  a, w: the product
// (LN parameters for the LN forms); bias; res: the residual or kept hidden;
// out, out2; colsum: the DGELU column partials; a2, w2: DGELU_RC's second
// product (K4's h [M][K] and W1 [N][K]).
struct GemmArgs {
    const void *a, *ln_w, *ln_b, *w, *bias, *res;
    void *out, *out2, *colsum;
    const void *a2, *w2;
    float eps;
    int M, N, K;
};

template <int EPI, bool LN, typename InT, int WG, int BNT, bool PANEL, int LAY>
cudaError_t launch_gemm_config(const GemmArgs& g, GemmPlan p, cudaStream_t stream) {
    // a runtime call first: on a thread with no current context yet (the
    // autograd engine's device thread, when its first work is this launch)
    // it makes the device's primary context current, which
    // cuTensorMapEncodeTiled needs
    const size_t smem = gemm_smem(GemmConfig{WG, BNT, PANEL}, g.K, epi_kind(EPI));
    auto kernel = gemm_kernel<EPI, LN, InT, WG, BNT, PANEL, LAY>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    CUtensorMap map_a{}, map_w{}, map_a2{}, map_w2{};
    if (LAY == L_NT) {
        err = make_tensor_map(&map_w, g.w, g.N, g.K, BNT);
        if (err == cudaSuccess && sizeof(InT) == 2) err = make_tensor_map(&map_a, g.a, g.M, g.K, 64 * WG);
    } else {
        err = make_tensor_map(&map_w, g.w, g.K, g.N, 64);
        if (err == cudaSuccess)
            err = LAY == L_TN ? make_tensor_map(&map_a, g.a, g.K, g.M, 64)
                              : make_tensor_map(&map_a, g.a, g.M, g.K, 64 * WG);
    }
    if (EPI == EPI_DGELU_RC) {
        if (err == cudaSuccess) err = make_tensor_map(&map_a2, g.a2, g.M, g.K, 64 * WG);
        if (err == cudaSuccess) err = make_tensor_map(&map_w2, g.w2, g.N, g.K, BNT);
    }
    if (err != cudaSuccess) return err;
    const int groups = (g.N / BNT + p.tiles - 1) / p.tiles;
    const int splits = LAY == L_TN ? (g.K + p.split - 1) / p.split : 1;
    kernel<<<dim3(groups, (g.M + 64 * WG - 1) / (64 * WG), splits), 128 * WG + 32, smem, stream>>>(
        map_a, map_w, map_a2, map_w2, static_cast<const InT*>(g.a),
        static_cast<const bf16*>(g.ln_w), static_cast<const bf16*>(g.ln_b), g.eps,
        g.bias, g.res, g.out, g.out2, static_cast<float*>(g.colsum),
        g.M, g.N, g.K, p.tiles, p.split);
    return cudaGetLastError();
}

// The plan of every gemm_kernel launch of a layout
template <int LAY>
inline GemmPlan plan_for(bool ln, int M, int N, int K, int kind) {
    const GemmPlan p = LAY == L_TN ? gemm_tn_plan(M, N, K) : gemm_plan(ln, M, N, K, kind);
    return p;
}

// C[M, N] in layout LAY on the caller's stream, in the configuration the
// plan picks for the shape
template <int EPI, bool LN, typename InT, int LAY>
cudaError_t launch_gemm_layout(const GemmArgs& g, cudaStream_t stream) {
    const GemmPlan p = plan_for<LAY>(LN, g.M, g.N, g.K, epi_kind(EPI));
#define SOD_GEMM_CASE(i, WG, BNT, PANEL)                                                      \
    case i:                                                                                 \
        if constexpr ((PANEL || !LN) && !(PANEL && LAY == L_TN))                            \
            return launch_gemm_config<EPI, LN, InT, WG, BNT, PANEL, LAY>(g, p, stream);     \
        return cudaErrorInvalidValue;
    switch (p.config) {
        SOD_GEMM_CASE(0, 2, 128, true)
        SOD_GEMM_CASE(1, 1, 128, true)
        SOD_GEMM_CASE(2, 1, 64, true)
        SOD_GEMM_CASE(3, 2, 128, false)
        SOD_GEMM_CASE(4, 1, 128, false)
        SOD_GEMM_CASE(5, 1, 64, false)
        default: return cudaErrorInvalidValue;
    }
#undef SOD_GEMM_CASE
}

// C[M, N] = epilogue(A . W^T) on the caller's stream (the forward, NT)
template <int EPI, bool LN, typename InT>
cudaError_t launch_gemm(const void* a, const void* ln_w, const void* ln_b, float eps,
                        const void* w, const void* bias, const void* res, void* out,
                        int M, int N, int K, cudaStream_t stream, void* out2 = nullptr) {
    return launch_gemm_layout<EPI, LN, InT, L_NT>(
        GemmArgs{a, ln_w, ln_b, w, bias, res, out, out2, nullptr, nullptr, nullptr, eps, M, N, K},
        stream);
}

// C[M, N] = A[M, K] . W[K, N] (NN; W a torch (out, in) weight used
// untransposed), epilogue EPI_BF16 or EPI_F32
template <int EPI>
cudaError_t launch_gemm_nn(const void* a, const void* w, void* out, int M, int N, int K,
                           cudaStream_t stream) {
    return launch_gemm_layout<EPI, false, bf16, L_NN>(
        GemmArgs{a, nullptr, nullptr, w, nullptr, nullptr, out, nullptr, nullptr, nullptr,
                 nullptr, 0.f, M, N, K}, stream);
}

// K4's GELU gradient, NN: da = (dy[M, K] . W2[K, N]) * gelu'(a) with a the
// kept bf16 hidden `a_kept` [M, N], or (a_kept NULL) a = f32(h[M, K] . W1^T +
// b1) recomputed in the kernel (W1 [N, K]); bf16 da to `da`, bf16 gelu(a) to
// `gel`, the column sums of the f32 da per 64 rows to colsum [M / 64][N] f32
inline cudaError_t launch_gemm_dgelu(const void* dy, const void* w2, const void* a_kept,
                                     const void* h, const void* w1, const void* b1, void* da,
                                     void* gel, void* colsum, int M, int N, int K,
                                     cudaStream_t stream) {
    if (a_kept != nullptr)
        return launch_gemm_layout<EPI_DGELU_BF16, false, bf16, L_NN>(
            GemmArgs{dy, nullptr, nullptr, w2, nullptr, a_kept, da, gel, colsum, nullptr,
                     nullptr, 0.f, M, N, K}, stream);
    return launch_gemm_layout<EPI_DGELU_RC, false, bf16, L_NN>(
        GemmArgs{dy, nullptr, nullptr, w2, b1, nullptr, da, gel, colsum, h, w1, 0.f, M, N, K},
        stream);
}

// f32 floats of a TN product's partials: [splits][KA][NB], none for one split
inline size_t gemm_tn_part_floats(int M, int KA, int NB) {
    const GemmPlan p = plan_for<L_TN>(false, KA, NB, M, 0);
    const int splits = (M + p.split - 1) / p.split;
    return splits > 1 ? (size_t)splits * KA * NB : 0;
}

// out[e] = the sum of part[p][e] over p in a fixed order (runs agree bit for
// bit), one thread an element, the parts in order: for few parts over many
// elements (the TN products' row splits)
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ part, int n_parts, size_t n,
                       float* __restrict__ out) {
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= n) return;
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * n + e];
    out[e] = s;
}

// ... and for many parts over few elements (column sums per row block): a
// block sums 32 elements, warp c the parts c, c + 8, ... in order (eight
// loads of each thread in flight), then warp 0 the eight sums in order
__global__ void __launch_bounds__(256)
reduce_partials_wide_kernel(const float* __restrict__ part, int n_parts, size_t n,
                            float* __restrict__ out) {
    __shared__ float sums[8][32];
    const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
    const size_t e = (size_t)blockIdx.x * 32 + lane;
    float s = 0.f;
    if (e < n) {
#pragma unroll 8
        for (int p = c; p < n_parts; p += 8) s += __ldg(part + (size_t)p * n + e);
    }
    sums[c][lane] = s;
    __syncthreads();
    if (c == 0 && e < n) {
        float t = sums[0][lane];
#pragma unroll
        for (int i = 1; i < 8; ++i) t += sums[i][lane];
        out[e] = t;
    }
}

// the second stage of every reduction over rows; the kernel by the number
// of parts (measured on an H100: each is faster on its side of 32 parts)
inline cudaError_t launch_reduce(const void* part, int n_parts, size_t n, void* out,
                                 cudaStream_t stream) {
    if (n_parts >= 32)
        reduce_partials_wide_kernel<<<(unsigned)((n + 31) / 32), 256, 0, stream>>>(
            static_cast<const float*>(part), n_parts, n, static_cast<float*>(out));
    else
        reduce_partials_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            static_cast<const float*>(part), n_parts, n, static_cast<float*>(out));
    return cudaGetLastError();
}

// C[KA, NB] = A[M, KA]^T . B[M, NB] in f32 (TN): partials over the plan's
// row splits into `part` (gemm_tn_part_floats of f32 scratch; unused for one
// split), then their sum.
inline cudaError_t launch_gemm_tn(const void* a, const void* b, void* part, void* out, int M,
                                  int KA, int NB, cudaStream_t stream) {
    const GemmPlan p = plan_for<L_TN>(false, KA, NB, M, 0);
    const int splits = (M + p.split - 1) / p.split;
    cudaError_t err = launch_gemm_layout<EPI_F32, false, bf16, L_TN>(
        GemmArgs{a, nullptr, nullptr, b, nullptr, nullptr, splits > 1 ? part : out, nullptr,
                 nullptr, nullptr, nullptr, 0.f, KA, NB, M}, stream);
    if (err != cudaSuccess || splits == 1) return err;
    return launch_reduce(part, splits, (size_t)KA * NB, out, stream);
}

template <int HD>
cudaError_t launch_attention_hd(const void* qkv, const void* key_mask, void* out, void* m, void* l,
                                int batch, int N, int D, int n_real, float scale,
                                cudaStream_t stream) {
    const size_t smem = attention_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attention_kernel<HD><<<dim3(N / AQ, D / HD, batch), THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(key_mask),
        static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), N, D, n_real,
        scale);
    return cudaGetLastError();
}

// attention at head dim D / n_heads (32, 64 or 128); m, l: f32 [B, H, N] or NULL
inline cudaError_t launch_attention(const void* qkv, const void* key_mask, void* out, int batch,
                                    int N, int D, int n_heads, int n_real, float scale,
                                    cudaStream_t stream, void* m = nullptr, void* l = nullptr) {
    switch (D / n_heads) {
        case 32: return launch_attention_hd<32>(qkv, key_mask, out, m, l, batch, N, D, n_real, scale, stream);
        case 64: return launch_attention_hd<64>(qkv, key_mask, out, m, l, batch, N, D, n_real, scale, stream);
        case 128: return launch_attention_hd<128>(qkv, key_mask, out, m, l, batch, N, D, n_real, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// gemm_s8_kernel: K8's products, s8 x s8 with s32 accumulation on wgmma
// ---------------------------------------------------------------------------

constexpr int QK = 128;           // codes of K per ring stage: one 128-byte swizzled row
constexpr int QG_MAX_STAGES = 8;  // ring stages of W, at most (a power of two)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// 0.5 h (1 + tanh(c0 (h + c1 h^3))) with every step rounded
__device__ __forceinline__ float gelu_tanh_rn(float h) {
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float t = tanhf(__fmul_rn(GELU_C0, __fadd_rn(h, __fmul_rn(GELU_C1, h3))));
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, t));
}

// K8's row quantiser: s = max(amax, 1e-8) / 127, q = clip(rint(v / s), +-127)
__device__ __forceinline__ float quant_scale(float amax) {
    return __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
}
// The codes of 8 values, clip(rint(v / sc), +-127), packed little-endian
// into two words, without a division: with rc = RN(1 / sc) (__frcp_rn),
// q0 = RN(v rc) lies within an ulp of v / sc, the remainder v - sc q0 is
// exact in one FMA, and RN(q0 + r rc) is the correctly rounded quotient
// __fdiv_rn(v, sc) (Markstein's theorem: CUDA's own division, less its
// branch for operands out of range, which these are not: sc >= 1e-8 / 127
// and |v / sc| <= 127.5, and a subnormal v codes as 0 either way).  Rounding
// is one add: for |q| < 2^22, q + 1.5 * 2^23 rounds to the integer nearest q
// (ties to even, rint's rule) and holds it, two's complement, in its low
// mantissa bits, the code's byte; clamping before rounding gives the same
// code as after (+-127 are integers).  Six full-rate instructions a value on
// one straight path, bit for bit the codes of clip(rint(__fdiv_rn(v, sc))).
constexpr float ROUND_MAGIC = 12582912.f;          // 1.5 * 2^23
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float sc, float rc) {
    uint32_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const float q0 = __fmul_rn(v[e], rc);
        const float q = __fmaf_rn(__fmaf_rn(-sc, q0, v[e]), rc, q0);
        c[e] = __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), ROUND_MAGIC));
    }
    return make_uint2(__byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
                      __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
}

// LayerNorm of one 8-element group with f32 parameters (w, b: the group's
// 8 of each), every step rounded: ((v - mean) * rstd) * w + b
__device__ __forceinline__ void ln_group_f32(float (&v)[8], float mean, float rstd,
                                             const float (&w)[8], const float (&b)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
        v[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), w[e]), b[e]);
}

// Where an s8 product's A codes come from (its prologue):
//   QP_CODES:    int8 codes [M][K] by TMA, their row scales from device memory
//   QP_LN_BF16:  bf16 rows, LayerNorm (f32 parameters), quantised
//   QP_BF16:     bf16 rows quantised
//   QP_LN_F32:   f32 rows, LayerNorm, quantised
//   QP_F32_PART: f32 rows quantised, each row's amax the max of its maxima
//                per 64 columns that the producing epilogue wrote
enum QPrologue { QP_CODES = 0, QP_LN_BF16 = 1, QP_BF16 = 2, QP_LN_F32 = 3, QP_F32_PART = 4 };
// Epilogues: v = f32(acc) * row_scale * col_scale, b = bias (f32).
//   Q_BIAS_BF16: bf16(v + b)                Q_RES_F32: f32((x0 + v) + b), x0 bf16
//   Q_GELU_F32:  f32(tanh-GELU(v + b)), and the row maxima of its |value| per
//                64 columns to out_part [M][N / 64]
//   Q_RES_BF16:  bf16((x1 + v) + b), x1 f32
enum QEpilogue { Q_BIAS_BF16 = 0, Q_RES_F32 = 1, Q_GELU_F32 = 2, Q_RES_BF16 = 3 };

// The operands of one gemm_s8_kernel launch: C[M, N] = A[M, K] . W[N, K]^T
struct QGemmArgs {
    const void* a;              // the codes (QP_CODES) or the rows to quantise
    const float* row_scale;     // QP_CODES: the codes' row scales [M]
    const float *ln_w, *ln_b;   // LN forms: [K] f32
    const float* amax_part;     // QP_F32_PART: [M][K / 64]
    const void* w;              // int8 [N][K]
    const float *col_scale, *bias;   // [N] f32
    const void* res;            // Q_RES_*: [M][N]
    void* out;                  // [M][N]
    float* out_part;            // Q_GELU_F32: [M][N / 64]
    int8_t* q_out;              // the quantising prologues, or NULL: the codes [M][K]
    float* s_out;               //   ... and their row scales [M]
    float eps;
    int M, N, K;
};

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[8][4], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[16][4], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int BNT>
__device__ __forceinline__ void wgmma_s8(int (&d)[BNT / 8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    if constexpr (BNT == 64) wgmma_s8_n64(d, desc_a, desc_b, accumulate);
    else wgmma_s8_n128(d, desc_a, desc_b, accumulate);
}

template <int NB>
__device__ __forceinline__ void acc_fence(int (&acc)[NB][4]) {
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[jb][e])::"memory");
}

// offset of the 8 codes of group g (columns 8g..8g+7) of row r in a panel of
// BMT rows: sub-panel g / 16 of [BMT][128 B], swizzled as tile_off (a
// function of the address: the panel starts on a 1024-byte boundary)
template <int BMT>
__device__ __forceinline__ uint32_t code_off(int r, int g) {
    return (uint32_t)(g >> 4) * (BMT * 128) + tile_off<64>(r, (g >> 1) & 7) + 8 * (g & 1);
}

// bytes of one element of the rows a prologue quantises (0: codes by TMA),
// and of the rows its jobs hold whole (0: none)
__host__ __device__ constexpr int qpro_elem(int pro) {
    return pro == QP_CODES ? 0 : pro == QP_LN_BF16 || pro == QP_BF16 ? 2 : 4;
}
__host__ __device__ constexpr int qpro_row_elem(int pro) {
    return pro == QP_F32_PART ? 0 : qpro_elem(pro);
}
// rows of one prologue job: the largest power of two of whole rows of K
// elements that fits a W stage of BNT 128-byte rows, at most BMT (0: none).
// QP_F32_PART's jobs are column chunks of all BMT rows instead (its scales
// are known first): qpart_job_cols columns a job.
__host__ __device__ constexpr int qpro_job_rows(int elem, int K, int bnt, int bmt) {
    int r = bmt;
    while (r > 0 && (size_t)r * K * elem > (size_t)bnt * 128) r >>= 1;
    return r;
}
__host__ __device__ constexpr int qpart_job_cols(int bnt, int bmt) { return bnt * 128 / (bmt * 4); }

// The prologue's shared-memory reads and writes are plain C++ accesses; the
// fence before the products hands the panel to the tensor cores' proxy.

// the 8 values of group g (columns 8g..8g+7) of row k in a prologue job:
// K / 64 boxes of [R rows][64 elements] as the TMA lands them
template <int ELEM>
__device__ __forceinline__ void job_group(const unsigned char* job, int R, int k, int g,
                                          float (&v)[8]) {
    const unsigned char* a = job + (((g >> 3) * R + k) * 64 + (g & 7) * 8) * ELEM;
    if constexpr (ELEM == 2) {
        unpack_bf16x8(*reinterpret_cast<const uint4*>(a), v);
    } else {
        const float4 lo = reinterpret_cast<const float4*>(a)[0];
        const float4 hi = reinterpret_cast<const float4*>(a)[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
}

// group g's codes into the panel, and to the scratch row where kept
template <int BMT>
__device__ __forceinline__ void put_codes(const float (&v)[8], float sc, float rc,
                                          unsigned char* panel, int r, int g, int8_t* keep_row) {
    const uint2 c = quant8(v, sc, rc);
    *reinterpret_cast<uint2*>(panel + code_off<BMT>(r, g)) = c;
    if (keep_row) *reinterpret_cast<uint2*>(keep_row + 8 * g) = c;
}

// QP_F32_PART: the row scales of the block's BMT rows from the producing
// epilogue's maxima, before any row arrives: two of the NT = 2 BMT consumer
// threads a row, each taking every other maximum, all loads in flight at once
template <int BMT>
__device__ __forceinline__ void part_scales(const QGemmArgs& p, int m0, float* rs, bool keep) {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = m0 + r, NP = p.K / 64;
    float m = 0.f;
    if (row < p.M)
        for (int c = half; c < NP; c += 2) m = fmaxf(m, p.amax_part[(size_t)row * NP + c]);
    const float sc = quant_scale(fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1)));
    if (half == 0) {
        rs[r] = sc;                                      // rows >= M: never stored
        rs[BMT + r] = __frcp_rn(sc);                     // the reciprocals, after the scales
        if (keep && row < p.M) p.s_out[row] = sc;
    }
}

// QP_F32_PART's prologue job i at shared address `job`: columns [i C, (i +
// 1) C) of all BMT rows as one box [BMT][C], every consumer thread
// quantising its own groups into the swizzled s8 panel, the scales known.
template <int BMT, int NT>
__device__ __forceinline__ void quant_cols_job(const QGemmArgs& p, int m0, unsigned char* panel,
                                               const float* rs, const unsigned char* job, int C,
                                               int i, bool keep) {
    const int CG = C / 8, K = p.K;                         // groups of a row in the job
    for (int it = threadIdx.x; it < BMT * CG; it += NT) {
        const int r = it / CG, gi = it % CG, row = m0 + r;
        if (row >= p.M) continue;
        float v[8];
        const float4* a = reinterpret_cast<const float4*>(job + (r * C + 8 * gi) * 4);
        const float4 lo = a[0], hi = a[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        put_codes<BMT>(v, rs[r], rs[BMT + r], panel, r, i * CG + gi,
                       keep ? p.q_out + (size_t)row * K : nullptr);
    }
}

// The LN and bf16 prologues: one row of the block's panel (r; `job` holds
// it as row k of R) quantised by a quarter warp, 8 lanes, so that a warp
// takes four rows at once and their reductions share three shuffles.  Lane
// l of the quarter holds the row's groups g = l + 8 i.  The LayerNorm
// statistics are ln_row_stats' bit for bit: there lane v of a warp sums its
// groups v, v + 32, ... in order and the warp adds the 32 sums in a
// butterfly (xor 16, 8, 4, 2, 1); here lane l keeps the four sums of v = l,
// l + 8, l + 16, l + 24 (its groups i with i % 4 = 0..3), takes the xor-16
// and xor-8 steps in registers (their partners are its own) and the xor 4,
// 2, 1 steps by shuffles within the quarter.  The passes (sums, squares,
// amax, codes) are rolled loops of four groups that read the row again from
// shared memory.
template <int PRO, int BMT>
__device__ __forceinline__ void quant_row_quarter(const QGemmArgs& p, int m0, unsigned char* panel,
                                                  float* rs, const unsigned char* job, int R,
                                                  int k, int r, bool keep) {
    constexpr int ELEM = qpro_elem(PRO);
    constexpr bool LN = PRO == QP_LN_BF16 || PRO == QP_LN_F32;
    const int l = threadIdx.x & 7, K = p.K, NGL = K / 64, row = m0 + r;  // NGL: groups a lane
    auto quarter_sum = [](const float (&s)[4]) {            // warp_sum's butterfly
        float u = __fadd_rn(__fadd_rn(s[0], s[2]), __fadd_rn(s[1], s[3]));
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
        return u;
    };
    // the row's value at group i of this lane, LayerNorm applied where asked
    float mean = 0.f, rstd = 1.f;
    auto value = [&](int i, float (&v)[8]) {
        job_group<ELEM>(job, R, k, l + 8 * i, v);
        if constexpr (LN) {
            float w[8], b[8];
            load_group(p.ln_w, l + 8 * i, w);
            load_group(p.ln_b, l + 8 * i, b);
            ln_group_f32(v, mean, rstd, w, b);
        }
    };
    if constexpr (LN) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int i0 = 0; i0 < NGL; i0 += 4)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (i0 + u < NGL) {
                    float v[8];
                    job_group<ELEM>(job, R, k, l + 8 * (i0 + u), v);
#pragma unroll
                    for (int e = 0; e < 8; ++e) s[u] = __fadd_rn(s[u], v[e]);
                }
        const float mu = __fdiv_rn(quarter_sum(s), (float)K);
        float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int i0 = 0; i0 < NGL; i0 += 4)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (i0 + u < NGL) {
                    float v[8];
                    job_group<ELEM>(job, R, k, l + 8 * (i0 + u), v);
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const float d = __fsub_rn(v[e], mu);
                        q[u] = __fmaf_rn(d, d, q[u]);
                    }
                }
        mean = mu;
        rstd = rsqrtf(__fadd_rn(__fdiv_rn(quarter_sum(q), (float)K), p.eps));
    }
    float amax = 0.f;
#pragma unroll 1
    for (int i0 = 0; i0 < NGL; i0 += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u < NGL) {
                float v[8];
                value(i0 + u, v);
#pragma unroll
                for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
            }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = quant_scale(amax), rc = __frcp_rn(sc);
    if (row >= p.M) return;                                 // rows >= M are never stored
    int8_t* keep_row = keep ? p.q_out + (size_t)row * K : nullptr;
#pragma unroll 1
    for (int i0 = 0; i0 < NGL; i0 += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u < NGL) {
                float v[8];
                value(i0 + u, v);
                put_codes<BMT>(v, sc, rc, panel, r, l + 8 * (i0 + u), keep_row);
            }
    if (l == 0) {
        rs[r] = sc;
        if (keep) p.s_out[row] = sc;
    }
}

// the pair of `res` at element o as f32 (f32 for Q_RES_BF16, else bf16)
template <int EPI>
__device__ __forceinline__ float2 q_load_res(const void* __restrict__ res, size_t o) {
    if (EPI == Q_RES_BF16)
        return __ldg(reinterpret_cast<const float2*>(reinterpret_cast<const float*>(res) + o));
    return bf16x2_to_float2(
        __ldg(reinterpret_cast<const unsigned int*>(reinterpret_cast<const bf16*>(res) + o)));
}

// K8's epilogue of two neighbouring columns of one row: v the dequantised
// products, b the bias, x the residual pair; o = row * N + col.  Returns the
// stored f32 values in v (Q_GELU_F32's row maxima read them).
template <int EPI>
__device__ __forceinline__ void q_epilogue_pair(float& v0, float& v1, float2 b, float2 x, size_t o,
                                                void* __restrict__ out) {
    if (EPI == Q_BIAS_BF16) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) =
            pack_bf16(__fadd_rn(v0, b.x), __fadd_rn(v1, b.y));
    } else if (EPI == Q_RES_F32) {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) =
            make_float2(__fadd_rn(__fadd_rn(x.x, v0), b.x), __fadd_rn(__fadd_rn(x.y, v1), b.y));
    } else if (EPI == Q_GELU_F32) {
        v0 = gelu_tanh_rn(__fadd_rn(v0, b.x));
        v1 = gelu_tanh_rn(__fadd_rn(v1, b.y));
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0, v1);
    } else {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) =
            pack_bf16(__fadd_rn(__fadd_rn(x.x, v0), b.x), __fadd_rn(__fadd_rn(x.y, v1), b.y));
    }
}

// bytes of gemm_s8_kernel's shared memory: the A panel of ceil(K / 128)
// sub-panels, `stages` W stages, the row scales and their reciprocals, the
// mbarriers
__host__ __device__ constexpr size_t qgemm_panel_bytes(int wg, int K) {
    return (size_t)((K + QK - 1) / QK) * 64 * wg * 128;
}
__host__ __device__ constexpr size_t qgemm_smem(int wg, int bn, int K, int stages) {
    return TILE_ALIGN + qgemm_panel_bytes(wg, K) + (size_t)stages * bn * 128 + 64 * wg * 8
           + (2 * QG_MAX_STAGES + 1) * 8;
}

// One block computes `tiles` column tiles of BMT x BNT, one after another,
// for one row panel of BMT = 64 WG rows: WG consumer warpgroups of 64 rows
// each (sharing every W tile) and one producer warp, as gemm_kernel's NT
// form with its panel kept.  grid = (ceil(N / BNT / tiles), ceil(M / BMT)).
// Integer wgmma has no transpose bits: both operands are K-major, the codes
// [M][K] and the weights in torch's (out, in) layout [N][K].  A 128-byte
// swizzled row holds 128 codes, so a ring stage is 128 deep (four k32
// products, the descriptor moving 32 bytes each, as a bf16 k16 step does).
// Shared memory (1024-byte aligned): the A panel [ceil(K / 128)][BMT][128 B],
// then 2^lg_stages W stages [BNT][128 B], the row scales [BMT] f32 and
// (QP_F32_PART) their reciprocals [BMT], the mbarriers full[8], empty[8],
// panel.  The prologue fills the panel once: by TMA for QP_CODES; else the
// producer streams the block's raw rows through the ring ahead of the W
// tiles, as jobs of R whole rows (qpro_job_rows: K / 64 TMA boxes of [R][64]
// a job, rows >= M as zeros; QP_F32_PART: column chunks of all BMT rows, one
// box a job, its scales from the maxima first, part_scales), and the
// consumers quantise each job into the panel as it lands (a quarter warp a
// row, quant_row_quarter; quant_cols_job) and release its stage, so the
// rows arrive at the memory's rate and the W ring starts as the last job is
// taken.  Products and ring as gemm_kernel's; the epilogue
// dequantises the accumulators in registers, f32(acc) * row scale * column
// scale, and applies K8's epilogue, the bias and column scales loaded while
// the tile's last products run.
template <int EPI, int PRO, int WG, int BNT>
__global__ void __launch_bounds__(128 * WG + 32)
gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const QGemmArgs p, int tiles, int lg_stages) {
    constexpr int NC = 128 * WG, BMT = 64 * WG;
    constexpr uint32_t WB = BNT * 128, AB = BMT * 128;     // bytes of one W tile / A sub-panel
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* const base = align_tiles(smem_raw);
    const uint32_t s0 = smem_u32(base);
    const int M = p.M, N = p.N, K = p.K, stages = 1 << lg_stages;
    const int nk = (K + QK - 1) / QK;
    const uint32_t sW = s0 + nk * AB;
    float* const rs = reinterpret_cast<float*>(base + nk * AB + stages * WB);
    const uint32_t full = smem_u32(rs + 2 * BMT), empty = full + 8 * QG_MAX_STAGES,
                   panel_bar = empty + 8 * QG_MAX_STAGES;
    const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.y * BMT, ct0 = blockIdx.x * tiles;
    const int n_tiles = min(tiles, N / BNT - ct0);
    constexpr int ELEM = qpro_elem(PRO);
    // a prologue job: R rows (QP_F32_PART: R columns); the jobs, then the W jobs
    const int R = PRO == QP_F32_PART ? qpart_job_cols(BNT, BMT) : qpro_job_rows(ELEM, K, BNT, BMT);
    const int n_pro = PRO == QP_CODES ? 0 : PRO == QP_F32_PART ? K / R : BMT / R;
    const int n_jobs = n_pro + n_tiles * nk;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * WG);       // one arrival per consumer warp
        }
        mbar_init(panel_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp_id == 4 * WG) {
        // the producer
        if (lane == 0) {
            if (PRO == QP_CODES) {
                mbar_expect_tx(panel_bar, nk * AB);
                for (int kt = 0; kt < nk; ++kt) tma_load_2d(s0 + kt * AB, &map_a, kt * QK, m0, panel_bar);
            }
            for (int j = 0, tile = 0, kt = 0; j < n_jobs; ++j) {
                const int st = j & (stages - 1);
                const uint32_t bar = full + 8 * st;
                if (j >= stages) mbar_wait(empty + 8 * st, ((j >> lg_stages) - 1) & 1);
                if (j < n_pro && PRO == QP_F32_PART) {
                    mbar_expect_tx(bar, WB);
                    tma_load_2d(sW + st * WB, &map_a, j * R, m0, bar);
                    continue;
                }
                if (j < n_pro) {
                    mbar_expect_tx(bar, R * K * ELEM);
                    for (int b = 0; b < K / 64; ++b)
                        tma_load_2d(sW + st * WB + b * R * 64 * ELEM, &map_a, 64 * b, m0 + j * R, bar);
                    continue;
                }
                mbar_expect_tx(bar, WB);
                tma_load_2d(sW + st * WB, &map_w, kt * QK, (ct0 + tile) * BNT, bar);
                if (++kt == nk) {
                    kt = 0;
                    ++tile;
                }
            }
        }
        return;
    }

    const int wg = tid >> 7, warp = warp_id & 3, g = lane >> 2, t = lane & 3;
    const int r_loc = wg * 64 + warp * 16 + g, row0 = m0 + r_loc;
    float rsc[2];
    if constexpr (PRO == QP_CODES) {
        mbar_wait(panel_bar, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) rsc[h] = row0 + 8 * h < M ? p.row_scale[row0 + 8 * h] : 0.f;
    } else {
        const bool keep = p.q_out != nullptr && blockIdx.x == 0;
        if constexpr (PRO == QP_F32_PART) {
            part_scales<BMT>(p, m0, rs, keep);
            asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");   // rs, before any job
            for (int j = 0; j < n_pro; ++j) {
                const int st = j & (stages - 1);
                mbar_wait(full + 8 * st, (j >> lg_stages) & 1);
                quant_cols_job<BMT, NC>(p, m0, base, rs, base + (sW - s0) + st * WB, R, j, keep);
                __syncwarp();
                mbar_arrive_if(empty + 8 * st, lane == 0);
            }
        } else {
            // the row jobs J at a time, so that every quarter warp has a row
            // (J <= stages: the plan's rule), 4 NC / 32 rows a pass
            const int J = max(1, (NC / 8) / R);
            for (int j0 = 0; j0 < n_pro; j0 += J) {
                for (int j = j0; j < j0 + J; ++j)
                    mbar_wait(full + 8 * (j & (stages - 1)), (j >> lg_stages) & 1);
                for (int t = warp_id * 4 + (lane >> 3); t < J * R; t += NC / 8) {
                    const int j = j0 + t / R;
                    quant_row_quarter<PRO, BMT>(p, m0, base, rs,
                                                base + (sW - s0) + (j & (stages - 1)) * WB, R,
                                                t % R, j * R + t % R, keep);
                }
                __syncwarp();
                for (int j = j0; j < j0 + J; ++j)
                    mbar_arrive_if(empty + 8 * (j & (stages - 1)), lane == 0);
            }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");     // the consumers only
#pragma unroll
        for (int h = 0; h < 2; ++h) rsc[h] = rs[r_loc + 8 * h];
    }

    // As gemm_kernel: only wgmma writes the accumulators, the first k step of
    // a tile is peeled, arrivals are predicated inside the instruction.
    int acc[BNT / 8][4];
    const uint32_t a_wg = s0 + wg * 64 * 128;
    auto mma = [&](int j, int kt, bool first) {
        const int st = j & (stages - 1);
        mbar_wait(full + 8 * st, (j >> lg_stages) & 1);
        const uint64_t da = tile_desc<64>(a_wg + kt * AB);
        const uint64_t db = tile_desc<64>(sW + st * WB);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < QK / 32; ++ks)
            wgmma_s8<BNT>(acc, da + ks * 2, db + ks * 2, !first || ks > 0);
        wgmma_commit();
    };
    constexpr bool RES = EPI == Q_RES_F32 || EPI == Q_RES_BF16;
    for (int tile = 0, j = n_pro; tile < n_tiles; ++tile) {
        mma(j++, 0, true);
        for (int kt = 1; kt < nk; ++kt, ++j) {
            mma(j, kt, false);
            wgmma_wait_pending<1>();
            mbar_arrive_if(empty + 8 * ((j - 1) & (stages - 1)), lane == 0);
        }
        // the tile's bias and column scales, loaded while its last products run
        const int n0 = (ct0 + tile) * BNT;
        float2 bv[BNT / 8], cs[BNT / 8];
#pragma unroll
        for (int i = 0; i < BNT / 8; ++i) {
            bv[i] = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * i + 2 * t));
            cs[i] = __ldg(reinterpret_cast<const float2*>(p.col_scale + n0 + 8 * i + 2 * t));
        }
        wgmma_wait_pending<0>();
        mbar_arrive_if(empty + 8 * ((j - 1) & (stages - 1)), lane == 0);
        acc_fence(acc);
        // warp w of warpgroup wg holds rows 64 wg + 16 w + g and + 8, columns
        // 8 i + 2 t and + 1; residuals loaded EC column blocks at a time
        constexpr int EC = 4;
        float pm[2][BNT / 64];                       // Q_GELU_F32: |value| maxima
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < BNT / 64; ++q) pm[h][q] = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < BNT / 8; i0 += EC) {
            float2 xv[EC][2];
#pragma unroll
            for (int i = 0; i < EC; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + 8 * h;
                    xv[i][h] = RES && row < M
                        ? q_load_res<EPI>(p.res, (size_t)row * N + n0 + 8 * (i0 + i) + 2 * t)
                        : make_float2(0.f, 0.f);
                }
#pragma unroll
            for (int i = 0; i < EC; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + 8 * h, col = n0 + 8 * (i0 + i) + 2 * t;
                    // |acc| can pass 2^24: the conversion rounds to nearest
                    float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i0 + i][2 * h]), rsc[h]),
                                         cs[i0 + i].x);
                    float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i0 + i][2 * h + 1]), rsc[h]),
                                         cs[i0 + i].y);
                    if (row < M) q_epilogue_pair<EPI>(v0, v1, bv[i0 + i], xv[i][h], (size_t)row * N + col, p.out);
                    if (EPI == Q_GELU_F32)
                        pm[h][(i0 + i) / 8] = fmaxf(pm[h][(i0 + i) / 8], fmaxf(fabsf(v0), fabsf(v1)));
                }
        }
        if constexpr (EPI == Q_GELU_F32) {
            // the row maxima per 64 columns: the quad's four threads hold a
            // row's 64 columns of a group (max is order-free: exact)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int q = 0; q < BNT / 64; ++q) {
                    float m = pm[h][q];
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                    const int row = row0 + 8 * h;
                    if (t == 0 && row < M) p.out_part[(size_t)row * (N / 64) + n0 / 64 + q] = m;
                }
        }
        acc_fence(acc);
    }
}

// Configurations of gemm_s8_kernel: warpgroups (64 rows each) and columns;
// the A panel is always kept (its codes exist only in shared memory)
struct QGemmConfig { int wg, bn; };
constexpr int QGEMM_CONFIGS = 3;
constexpr QGemmConfig QGEMM_CONFIG[QGEMM_CONFIGS] = {{2, 128}, {1, 128}, {1, 64}};

// log2 of the W stages that fit beside the panel (at most 8, at least 2), or -1
inline int qgemm_lg_stages(const QGemmConfig& c, int K) {
    for (int lg = 3; lg >= 1; --lg)
        if (qgemm_smem(c.wg, c.bn, K, 1 << lg) <= GEMM_SMEM_MAX) return lg;
    return -1;
}

// config: an index of QGEMM_CONFIG (-1: none fits); tiles: column tiles per
// block; lg_stages: log2 of the W ring's stages
struct QGemmPlan { int config, tiles, lg_stages; };

// The plan of an s8 product whose prologue holds whole A rows of `row_elem`
// bytes an element in a W stage (its row jobs; 0: none), gemm_plan's rule for
// the kept-panel forms (ops/fused_block_int8.py s8_plan mirrors it).  A
// configuration fits where N takes its column tiles, two W stages fit beside
// its panel, a W stage holds a whole A row and the ring holds the jobs that
// give every quarter warp a row (4 rows a consumer warp).  128 x 128 where
// there are
// sms / 4 panels of 128 rows, the tile fits and its column tiles split evenly
// over the column groups one wave holds beside the panels (or the panels
// alone fill a wave); else 64 x 128 where there are sms / 4 panels of 64
// rows and it fits, else 64 x 64 (64 x 128 where a 64-column stage holds no
// A row).  The columns are cut into as many groups as one wave holds beside
// the row panels (at least one).
inline QGemmPlan qgemm_plan(int M, int N, int K, int row_elem) {
    const int sms = sm_count(), p128 = (M + 127) / 128, p64 = (M + 63) / 64;
    auto fits = [&](int i) {
        const QGemmConfig& c = QGEMM_CONFIG[i];
        const int rows = row_elem ? qpro_job_rows(row_elem, K, c.bn, 64 * c.wg) : 0;
        return N % c.bn == 0 && qgemm_lg_stages(c, K) > 0
               && (row_elem == 0
                   || (rows > 0 && (rows << qgemm_lg_stages(c, K)) >= 16 * c.wg));
    };
    auto groups = [&](int n_ct, int panels) { return std::min(n_ct, std::max(1, sms / panels)); };
    if (p128 >= sms / 4 && fits(0)) {
        const int n_ct = N / 128, gr = groups(n_ct, p128);
        if (p128 >= sms || n_ct % gr == 0)
            return {0, (n_ct + gr - 1) / gr, qgemm_lg_stages(QGEMM_CONFIG[0], K)};
    }
    int c = 1;
    if (p64 < sms / 4 || !fits(c)) c = 2;
    if (!fits(c)) c = 1;                       // a W stage too small for an A row
    if (!fits(c)) return {-1, 1, 0};
    const int n_ct = N / QGEMM_CONFIG[c].bn, gr = groups(n_ct, p64);
    return {c, (n_ct + gr - 1) / gr, qgemm_lg_stages(QGEMM_CONFIG[c], K)};
}

template <int EPI, int PRO, int WG, int BNT>
cudaError_t launch_qgemm_config(const QGemmArgs& a, QGemmPlan pl, cudaStream_t stream) {
    CUtensorMap map_a{}, map_w{};
    cudaError_t err = make_tensor_map(&map_w, a.w, a.N, a.K, BNT, true);
    if (err == cudaSuccess)
        err = PRO == QP_CODES
            ? make_tensor_map(&map_a, a.a, a.M, a.K, 64 * WG, true)
            : PRO == QP_F32_PART
            ? make_rows_map(&map_a, a.a, a.M, a.K, 64 * WG, 4, qpart_job_cols(BNT, 64 * WG))
            : make_rows_map(&map_a, a.a, a.M, a.K,
                            qpro_job_rows(qpro_elem(PRO), a.K, BNT, 64 * WG), qpro_elem(PRO), 64);
    if (err != cudaSuccess) return err;
    const size_t smem = qgemm_smem(WG, BNT, a.K, 1 << pl.lg_stages);
    auto kernel = gemm_s8_kernel<EPI, PRO, WG, BNT>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int groups = (a.N / BNT + pl.tiles - 1) / pl.tiles;
    kernel<<<dim3(groups, (a.M + 64 * WG - 1) / (64 * WG)), 128 * WG + 32, smem, stream>>>(
        map_a, map_w, a, pl.tiles, pl.lg_stages);
    return cudaGetLastError();
}

// C[M, N] = epilogue(dequantised A . W^T) on the caller's stream, A's codes
// from the prologue PRO, in the configuration the plan picks for the shape
template <int EPI, int PRO>
cudaError_t launch_qgemm(const QGemmArgs& a, cudaStream_t stream) {
    const QGemmPlan pl = qgemm_plan(a.M, a.N, a.K, qpro_row_elem(PRO));
    switch (pl.config) {
        case 0: return launch_qgemm_config<EPI, PRO, 2, 128>(a, pl, stream);
        case 1: return launch_qgemm_config<EPI, PRO, 1, 128>(a, pl, stream);
        case 2: return launch_qgemm_config<EPI, PRO, 1, 64>(a, pl, stream);
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// LayerNorm rows of the backward chains (K3 and K4)
// ---------------------------------------------------------------------------

// h[M, K] = bf16(LayerNorm(x[M, K])), one warp per row: the arithmetic of
// gemm_kernel's LN panel (ln_row_stats and ln_group_apply on the same lane
// groups), so the backward sees the forward's h bit for bit.  grid = M / 4.
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w,
               const bf16* __restrict__ ln_b, float eps, bf16* __restrict__ h, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, G = K / 8;
    const size_t r = (size_t)blockIdx.x * (THREADS / 32) + warp;
    const bf16* row = x + r * K;
    float v[LN_G][8];
#pragma unroll
    for (int j = 0; j < LN_G; ++j)
        if (lane + 32 * j < G) load_group(row, lane + 32 * j, v[j]);
    float mean, rstd;
    ln_row_stats(v, lane, K, eps, mean, rstd);
#pragma unroll
    for (int j = 0; j < LN_G; ++j) {
        const int g = lane + 32 * j;
        if (g < G)
            *reinterpret_cast<uint4*>(h + r * K + 8 * g) = ln_group_apply(
                v[j], mean, rstd, *reinterpret_cast<const uint4*>(ln_w + 8 * g),
                *reinterpret_cast<const uint4*>(ln_b + 8 * g));
    }
}

// LayerNorm backward + residual, one warp a row (rows warp, warp + 8, ... of
// the block's LNB_ROWS), lane l holding the row's 8-element groups l + 32 j
// in registers (NG of them at most, K <= 256 NG) as ln_row_stats reads them;
// x, dh and g are each read once:
//   mean, inv = ln_row_stats (the forward's, bit for bit)
//   xhat = (x - mean) * inv; dxhat = dh * ln_w
//   dx = bf16(g + inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
// Each warp adds dh * xhat (the LayerNorm scale's gradient), dh (its bias's)
// and g (the output bias's: dbproj or db2) of its rows into its own
// shared-memory columns, each lane its own groups as float4 (no two lanes
// share a bank line); then the block sums its warps in order into
// part[blockIdx.x][3][K].  x, g: bf16 [M, K]; dh: f32 [M, K].
constexpr int LNB_WARPS = 8, LNB_ROWS = 32;
template <int NG>
constexpr size_t ln_bwd_smem() { return (size_t)LNB_WARPS * 3 * NG * 2 * 32 * sizeof(float4); }

template <int NG>
__global__ void __launch_bounds__(LNB_WARPS * 32, NG <= 2 ? 4 : 6 - NG)   // <= 64 registers at d 512
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dh,
              const bf16* __restrict__ g, const bf16* __restrict__ ln_w, float eps,
              bf16* __restrict__ dx, float* __restrict__ part, int M, int K) {
    extern __shared__ float4 acc4[];        // [warp][3][NG][2][32 lanes]
    constexpr int PER_WARP = 3 * NG * 2 * 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, G = K / 8;
    float4* mine = acc4 + warp * PER_WARP + lane;
#pragma unroll
    for (int i = 0; i < 3 * NG * 2; ++i) mine[32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);

    const int r_end = min(M, (int)(blockIdx.x + 1) * LNB_ROWS);
#pragma unroll 1
    for (int r = blockIdx.x * LNB_ROWS + warp; r < r_end; r += LNB_WARPS) {
        const size_t o = (size_t)r * K;
        float v[NG][8], d[NG][8];
#pragma unroll
        for (int j = 0; j < NG; ++j)
            if (lane + 32 * j < G) {
                load_group(x + o, lane + 32 * j, v[j]);
                load_group(dh + o, lane + 32 * j, d[j]);
            }
        float mean, inv;
        ln_row_stats<NG>(v, lane, K, eps, mean, inv);
        // pass 1: xhat in place of x, the scale's and bias's column sums
        // (dh * xhat, dh), then dxhat = dh * ln_w in place of dh.  Packed
        // bf16 pairs (ln_w here, g below) are widened one pair at a time.
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < NG; ++j)
            if (lane + 32 * j < G) {
                const uint4 w8 = *reinterpret_cast<const uint4*>(ln_w + 8 * (lane + 32 * j));
                const uint32_t w2[4] = {w8.x, w8.y, w8.z, w8.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) v[j][e] = (v[j][e] - mean) * inv;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float4* a = mine + 32 * (j * 2 + h);
                    const int e = 4 * h;
                    float4 t = a[0];
                    t.x += d[j][e] * v[j][e]; t.y += d[j][e + 1] * v[j][e + 1];
                    t.z += d[j][e + 2] * v[j][e + 2]; t.w += d[j][e + 3] * v[j][e + 3];
                    a[0] = t;
                    t = a[32 * 2 * NG];
                    t.x += d[j][e]; t.y += d[j][e + 1]; t.z += d[j][e + 2]; t.w += d[j][e + 3];
                    a[32 * 2 * NG] = t;
                }
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float2 w = bf16x2_to_float2(w2[e / 2]);
                    d[j][e] *= e % 2 ? w.y : w.x;                     // dxhat
                    s1 += d[j][e];
                    s2 += d[j][e] * v[j][e];
                }
            }
        const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
        // pass 2: dx, and the output bias's column sums (g)
#pragma unroll
        for (int j = 0; j < NG; ++j) {
            const int gi = lane + 32 * j;
            if (gi >= G) continue;
            const uint4 g8 = *reinterpret_cast<const uint4*>(g + o + 8 * gi);
            const uint32_t g2[4] = {g8.x, g8.y, g8.z, g8.w};
            uint32_t y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float2 gv = bf16x2_to_float2(g2[q]);
                y[q] = pack_bf16(gv.x + inv * (d[j][2 * q] - m1 - v[j][2 * q] * m2),
                                 gv.y + inv * (d[j][2 * q + 1] - m1 - v[j][2 * q + 1] * m2));
            }
            *reinterpret_cast<uint4*>(dx + o + 8 * gi) = make_uint4(y[0], y[1], y[2], y[3]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float4* a = mine + 32 * (j * 2 + h) + 32 * 4 * NG;
                const float2 lo = bf16x2_to_float2(g2[2 * h]), hi = bf16x2_to_float2(g2[2 * h + 1]);
                float4 t = *a;
                t.x += lo.x; t.y += lo.y; t.z += hi.x; t.w += hi.y;
                *a = t;
            }
        }
    }
    __syncthreads();
    // entry i = ((q * NG + j) * 2 + h) * 32 + l: columns 8 (l + 32 j) + 4 h .. + 3 of sum q
    for (int i = threadIdx.x; i < PER_WARP; i += LNB_WARPS * 32) {
        const int l = i & 31, h = (i >> 5) & 1, j = (i >> 6) % NG, q = (i >> 6) / NG;
        if (l + 32 * j >= G) continue;
        float4 s = acc4[i];
#pragma unroll
        for (int w = 1; w < LNB_WARPS; ++w) {
            const float4 u = acc4[w * PER_WARP + i];
            s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
        }
        *reinterpret_cast<float4*>(part + ((size_t)blockIdx.x * 3 + q) * K + 8 * (l + 32 * j) + 4 * h) = s;
    }
}

inline int ln_bwd_blocks(int M) { return (M + LNB_ROWS - 1) / LNB_ROWS; }

inline cudaError_t launch_ln_rows(const void* x, const void* ln_w, const void* ln_b, float eps,
                                  void* h, int M, int K, cudaStream_t stream) {
    ln_rows_kernel<<<M / (THREADS / 32), THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
        static_cast<const bf16*>(ln_b), eps, static_cast<bf16*>(h), K);
    return cudaGetLastError();
}

template <int NG>
cudaError_t launch_ln_bwd_ng(const void* x, const void* dh, const void* g, const void* ln_w,
                             float eps, void* dx, void* part, int M, int K, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<NG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)ln_bwd_smem<NG>());
    if (err != cudaSuccess) return err;
    ln_bwd_kernel<NG><<<ln_bwd_blocks(M), LNB_WARPS * 32, ln_bwd_smem<NG>(), stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dh), static_cast<const bf16*>(g),
        static_cast<const bf16*>(ln_w), eps, static_cast<bf16*>(dx), static_cast<float*>(part),
        M, K);
    return cudaGetLastError();
}

// dx and out3 = [dLN scale, dLN bias, d(output bias)] (f32 [3][K]); part:
// [ln_bwd_blocks(M)][3][K] f32 scratch
inline cudaError_t launch_ln_bwd(const void* x, const void* dh, const void* g, const void* ln_w,
                                 float eps, void* dx, void* part, void* out3, int M, int K,
                                 cudaStream_t stream) {
    cudaError_t err;
    switch ((K + 255) / 256) {
        case 1: err = launch_ln_bwd_ng<1>(x, dh, g, ln_w, eps, dx, part, M, K, stream); break;
        case 2: err = launch_ln_bwd_ng<2>(x, dh, g, ln_w, eps, dx, part, M, K, stream); break;
        case 3: err = launch_ln_bwd_ng<3>(x, dh, g, ln_w, eps, dx, part, M, K, stream); break;
        case 4: err = launch_ln_bwd_ng<4>(x, dh, g, ln_w, eps, dx, part, M, K, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    return launch_reduce(part, ln_bwd_blocks(M), (size_t)3 * K, out3, stream);
}

}  // namespace sod
