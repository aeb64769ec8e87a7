// Device code of the ViT block kernels, shared by K1 (csrc/fused_block.cu),
// K3 and K5 (csrc/fused_attn.cu) and K4 (csrc/fused_mlp.cu):
//   * gemm_kernel: C[M, N] = A[M, K] . W[N, K]^T with an optional LayerNorm
//     of A's rows and a fused epilogue, the forward projections;
//   * attention_kernel: per-head softmax attention over a packed qkv
//     [B, N, 3D] row layout (attention.cuh's two-pass device code);
// and, for the backward kernels of K3 and K4:
//   * ln_rows_kernel: h = bf16(LayerNorm(x)), the forward's arithmetic;
//   * gemm_nn_kernel: C[M, N] = A[M, K] . W[K, N], the second operand not
//     transposed (g . W with W in torch's (out, in) layout), with the
//     GELU-gradient epilogue;
//   * gemm_tn_kernel: C[KA, NB] = A[M, KA]^T . B[M, NB], contracting over
//     the rows (the weight gradients), rows split over blocks into f32
//     partials that reduce_partials_kernel sums in a fixed order (two
//     stages, no atomics: runs agree bit for bit);
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
//   * a producer warp keeps a ring of 64-deep stages filled by TMA (one
//     instruction a tile, the hardware writes the swizzle and zero-fills rows
//     and columns out of bounds), each stage's arrival and release counted on
//     mbarriers: up to 7 stages in flight while the consumers' products run;
//   * LayerNorm once per row panel: the block loads its rows over all of K
//     once, normalises them in place (one warp a row, 16-byte groups a
//     lane; ln_row_stats, the statistics of every LayerNorm here) and keeps
//     the panel in shared memory for the products of every column tile;
//     only W streams.  A projection without LN keeps its panel too at
//     K <= 384, else streams A beside W;
//   * the epilogue (bias, GELU, residual) on the accumulators' registers,
//     bias and residuals loaded ahead in groups, bf16 or f32 pairs stored
//     straight to device memory, while the next tile's loads land.
// gemm_nn_kernel and gemm_tn_kernel are nvcuda::wmma 16x16x16 bf16 with f32
// accumulators on padded shared-memory tiles (BM x BN x BK); the attention's
// products are attention.cuh's (wgmma on register-resident score tiles).
//
// Shape contract (checked by the Python wrappers): rows M % 64 == 0,
// N % 64 == 0, K % 32 == 0 (K <= 1024 with LayerNorm), attention rows per
// image % 64 == 0, head dim in {32, 64, 128}, 16-byte aligned contiguous
// tensors.  gemm_kernel also takes M % 128 == 64 in its 128-row tiles.
#pragma once

#include <mma.h>

#include <cudaTypedefs.h>   // CUtensorMap, PFN_cuTensorMapEncodeTiled

#include <algorithm>

#include "attention.cuh"

namespace sod {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;   // the wmma kernels' tiles (and K8's)
constexpr int APAD = 8;               // bf16 row pad: ldm % 8 == 0, spreads banks
constexpr int CPAD = 4;               // f32 row pad: ldm % 4 == 0

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Epilogues: v = the f32 accumulator, b = bias (bf16), res = residual.
//   BIAS_BF16: bf16(v + b)                  GELU_BF16: bf16(tanh-GELU(v + b))
//   RES_F32:   f32((x0 + v) + b), x0 bf16   RES_BF16:  bf16((x1 + v) + b), x1 f32
//   RESB_BF16: bf16((x + v) + b), x bf16
//   BIAS_F32:  f32(v + b)
//   GELU_SAVE_BF16: GELU_BF16, and bf16(v + b) (the pre-GELU hidden) to out2
enum Epilogue { EPI_BIAS_BF16 = 0, EPI_GELU_BF16 = 1, EPI_RES_F32 = 2, EPI_RES_BF16 = 3,
                EPI_RESB_BF16 = 4, EPI_BIAS_F32 = 5, EPI_GELU_SAVE_BF16 = 6 };

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

// d/dh of gelu_tanh (sod_tpu/ops/fused_mlp.py `_gelu_tanh_grad`)
__device__ __forceinline__ float gelu_tanh_grad(float h) {
    const float t = tanhf(GELU_C0 * (h + GELU_C1 * (h * h * h)));
    const float dh = GELU_C0 * (1.f + 3.f * GELU_C1 * (h * h));
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * dh;
}

// ---------------------------------------------------------------------------
// The forward GEMM: C[M, N] = epilogue(A[M, K] . W[N, K]^T), W in torch's
// (out, in) layout, bf16 x bf16 with f32 accumulation on wgmma
// ---------------------------------------------------------------------------

constexpr int GK = 64;            // k per ring stage: one 128-byte swizzled row of bf16
// ring stages: a kept panel leaves room for more of the (W only) stages
__host__ __device__ constexpr int gemm_stages(bool panel) { return panel ? 8 : 6; }
constexpr int LN_MAX_DIM = 1024;  // LN forms take K <= 1024 (ops/fused_block.py MAX_DIM)
constexpr int LN_G = LN_MAX_DIM / 256;   // 8-element groups of a row per lane, at most

// LayerNorm statistics of one row by one warp, the one routine of every
// kernel's LayerNorm (gemm_kernel's panel, ln_rows_kernel, ln_bwd_kernel and
// K8's quantiser: the backward sees the forward's h and statistics bit for
// bit): lane l holds the row's 8-element groups l + 32 j in v[j] (groups at
// or beyond K / 8 are absent), sums them in that order, then across the warp.
// f32, two-pass variance; returns the mean and 1 / sqrt(var + eps).
__device__ __forceinline__ void ln_row_stats(const float (&v)[LN_G][8], int lane, int K, float eps,
                                             float& mean, float& rstd) {
    const int G = K / 8;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LN_G; ++j)
        if (lane + 32 * j < G)
#pragma unroll
            for (int e = 0; e < 8; ++e) s = __fadd_rn(s, v[j][e]);
    mean = __fdiv_rn(warp_sum(s), (float)K);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < LN_G; ++j)
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
template <typename InT>
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

template <int BNT>
__device__ __forceinline__ void wgmma_ss(float (&d)[BNT / 8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    if constexpr (BNT == 64) wgmma_ss_n64(d, desc_a, desc_b, accumulate);
    else wgmma_ss_n128(d, desc_a, desc_b, accumulate);
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

__host__ __device__ constexpr bool epi_reads_res(int epi) {
    return epi == EPI_RES_F32 || epi == EPI_RES_BF16 || epi == EPI_RESB_BF16;
}

// the residual pair at element o as f32 (f32 for RES_BF16, else bf16)
template <int EPI>
__device__ __forceinline__ float2 load_res(const void* __restrict__ res, size_t o) {
    if (EPI == EPI_RES_BF16)
        return __ldg(reinterpret_cast<const float2*>(reinterpret_cast<const float*>(res) + o));
    return bf16x2_to_float2(
        __ldg(reinterpret_cast<const unsigned int*>(reinterpret_cast<const bf16*>(res) + o)));
}

// Epilogue of two neighbouring columns (col, col + 1) of one row, in
// registers: v the f32 accumulators, b the bias, x the residual (read by the
// RES forms); o = row * N + col.
template <int EPI>
__device__ __forceinline__ void epilogue_pair(float v0, float v1, float2 b, float2 x, size_t o,
                                              void* __restrict__ out, void* __restrict__ out2) {
    if (EPI == EPI_BIAS_BF16) {
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
    } else {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) =
            pack_bf16((x.x + v0) + b.x, (x.y + v1) + b.y);
    }
}

// One block computes `tiles` column tiles of BMT x BNT, one after another,
// for one row panel of BMT = 64 WG rows: WG consumer warpgroups of 64 rows
// each (sharing every W tile) and one producer warp.  grid = (ceil(N / BNT /
// tiles), ceil(M / BMT)): the column blocks of one row panel run side by
// side, so A comes from device memory about once.  Shared memory (1024-byte
// aligned):
//   PANEL: A panel [ceil(K / 64)][BMT][128 B], then STAGES W stages
//          [BNT][128 B].  The block's rows over all of K, loaded once (and
//          with LN normalised once) and read in place by every product of
//          every column tile; only W streams.  LN forms always take it.
//   else:  STAGES W stages, then STAGES A stages [BMT][128 B].
//   then the mbarriers: full[STAGES], empty[STAGES], panel.
// The producer walks the jobs (column tile, 64-deep k step) in order: it
// waits until a stage is empty and starts its TMA loads (128-byte swizzle:
// the layout the descriptors read), which complete on the stage's full
// barrier.  The consumers wait for a job's stage to be full, start its four
// wgmma k16 and release the previous job's stage once those products are
// done, so up to STAGES - 1 loads and two product groups are in flight; after
// a tile's last k step they wait for its products and run the epilogue on the
// accumulators while the next tile's loads land.  Rows >= M arrive as zeros
// and are never stored.
template <int EPI, bool LN, typename InT, int WG, int BNT, bool PANEL>
__global__ void __launch_bounds__(128 * WG + 32)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const InT* __restrict__ a_in, const bf16* __restrict__ ln_w,
            const bf16* __restrict__ ln_b, float eps, const bf16* __restrict__ bias,
            const void* __restrict__ res, void* __restrict__ out, void* __restrict__ out2,
            int M, int N, int K, int tiles) {
    static_assert(PANEL || !LN, "the LayerNorm forms keep their row panel");
    constexpr int STAGES = gemm_stages(PANEL), NC = 128 * WG, BMT = 64 * WG;
    constexpr uint32_t WB = BNT * 128, AB = BMT * 128;     // bytes of one W / A stage
    constexpr bool TMA_PANEL = PANEL && sizeof(InT) == 2;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t s0 = smem_u32(align_tiles(smem_raw));
    const int nk = (K + GK - 1) / GK;
    const uint32_t sW = PANEL ? s0 + nk * AB : s0;
    const uint32_t sA = PANEL ? s0 : s0 + STAGES * WB;
    const uint32_t full = sW + STAGES * WB + (PANEL ? 0 : STAGES * AB), empty = full + 8 * STAGES,
                   panel_bar = empty + 8 * STAGES;
    const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.y * BMT, ct0 = blockIdx.x * tiles;
    const int n_tiles = min(tiles, N / BNT - ct0), n_jobs = n_tiles * nk;

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
                mbar_expect_tx(panel_bar, nk * AB);
                for (int kt = 0; kt < nk; ++kt) tma_load_2d(sA + kt * AB, &map_a, kt * GK, m0, panel_bar);
            }
            for (int j = 0, tile = 0, kt = 0; j < n_jobs; ++j) {
                const int st = j % STAGES, n0 = (ct0 + tile) * BNT;
                if (j >= STAGES) mbar_wait(empty + 8 * st, ((j / STAGES) - 1) & 1);
                mbar_expect_tx(full + 8 * st, PANEL ? WB : WB + AB);
                tma_load_2d(sW + st * WB, &map_w, kt * GK, n0, full + 8 * st);
                if (!PANEL) tma_load_2d(sA + st * AB, &map_a, kt * GK, m0, full + 8 * st);
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
    const int wg = tid >> 7, warp = warp_id & 3, g = lane >> 2, t = lane & 3;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
    const uint32_t a_wg = sA + wg * 64 * 128;
    auto mma = [&](int j, int kt, bool first) {
        const int st = j % STAGES;
        mbar_wait(full + 8 * st, (j / STAGES) & 1);
        const uint64_t da = tile_desc<64>(PANEL ? a_wg + kt * AB : a_wg + st * AB);
        const uint64_t db = tile_desc<64>(sW + st * WB);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < GK / 16; ++ks)
            wgmma_ss<BNT>(acc, da + (uint64_t)(ks * 2), db + (uint64_t)(ks * 2), !first || ks > 0);
        wgmma_commit();
    };
    for (int tile = 0, j = 0; tile < n_tiles; ++tile) {
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
            bv[i] = bf16x2_to_float2(
                __ldg(reinterpret_cast<const unsigned int*>(bias + n0 + 8 * i + 2 * t)));
        wgmma_wait_pending<0>();
        mbar_arrive_if(empty + 8 * ((j - 1) % STAGES), lane == 0);
        acc_fence(acc);
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
        acc_fence(acc);
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

// Configurations of the forward GEMM: warpgroups (64 rows each), columns,
// and whether A's row panel is kept (PANEL) or streamed beside W.
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

inline size_t gemm_smem(const GemmConfig& c, int K) {
    const size_t rows = 64 * c.wg, nk = (K + GK - 1) / GK, stages = gemm_stages(c.panel);
    return TILE_ALIGN + (c.panel ? nk * rows * 128 + stages * c.bn * 128
                                 : stages * (rows + c.bn) * 128)
           + (2 * stages + 1) * 8;                       // the mbarriers
}

inline bool gemm_config_fits(int i, bool ln, int N, int K) {
    if (i < 0 || i >= GEMM_CONFIGS) return false;
    const GemmConfig& c = GEMM_CONFIG[i];
    return (c.panel || !ln) && N % c.bn == 0 && gemm_smem(c, K) <= GEMM_SMEM_MAX;
}

struct GemmPlan { int config, tiles; };

// The configuration and column tiles per block for a shape, a rule read off
// the times of every configuration and split at K1's and K4's shapes on an
// H100 (chip_smoke.py phase 3 prints each shape's plan).  A's row panel is
// kept with LN and at K <= 384, else streamed beside W.  Tiles:
//   * a form without LN with a wave of 128-row panels or more: 128 x 128
//     streamed, one a block;
//   * 128 x 128 where there are sms / 4 panels of 128 rows, the tile fits
//     and its column tiles split evenly over the column groups one wave
//     holds beside the panels (or the panels alone fill a wave);
//   * else 64 x 128 where there are sms / 4 panels of 64 rows and it fits,
//     else 64 x 64.
// The columns are cut into as many groups as one wave holds beside the row
// panels (at least one): the tiles per block.
inline GemmPlan gemm_plan(bool ln, int M, int N, int K) {
    const int sms = sm_count(), p128 = (M + 127) / 128, p64 = (M + 63) / 64;
    const bool panel = ln || K <= 384;
    auto groups = [&](int n_ct, int panels) {
        return std::min(n_ct, std::max(1, sms / panels));
    };
    if (!ln && p128 >= sms && gemm_config_fits(3, ln, N, K)) return {3, 1};
    const int c128 = panel ? 0 : 3;
    if (p128 >= sms / 4 && gemm_config_fits(c128, ln, N, K)) {
        const int n_ct = N / 128, g = groups(n_ct, p128);
        if (p128 >= sms || n_ct % g == 0) return {c128, (n_ct + g - 1) / g};
    }
    int c = panel ? 1 : 4;                                          // 64 x 128
    if (p64 < sms / 4 || !gemm_config_fits(c, ln, N, K)) c = panel ? 2 : 5;   // 64 x 64
    if (!gemm_config_fits(c, ln, N, K)) return {-1, 1};
    const int n_ct = N / GEMM_CONFIG[c].bn, g = groups(n_ct, p64);
    return {c, (n_ct + g - 1) / g};
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

// The tensor map of a row-major bf16 [rows, cols] matrix, read in boxes of
// 64 columns (128 bytes, swizzled as the descriptors expect) x box_rows rows
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                                   int box_rows) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
    const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)box_rows}, elem[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int EPI, bool LN, typename InT, int WG, int BNT, bool PANEL>
cudaError_t launch_gemm_config(const void* a, const void* ln_w, const void* ln_b, float eps,
                               const void* w, const void* bias, const void* res, void* out,
                               int M, int N, int K, int tiles, cudaStream_t stream, void* out2) {
    CUtensorMap map_a{}, map_w{};
    cudaError_t err = make_tensor_map(&map_w, w, N, K, BNT);
    if (err == cudaSuccess && sizeof(InT) == 2) err = make_tensor_map(&map_a, a, M, K, 64 * WG);
    if (err != cudaSuccess) return err;
    const size_t smem = gemm_smem(GemmConfig{WG, BNT, PANEL}, K);
    auto kernel = gemm_kernel<EPI, LN, InT, WG, BNT, PANEL>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int groups = (N / BNT + tiles - 1) / tiles;
    kernel<<<dim3(groups, (M + 64 * WG - 1) / (64 * WG)), 128 * WG + 32, smem, stream>>>(
        map_a, map_w, static_cast<const InT*>(a), static_cast<const bf16*>(ln_w),
        static_cast<const bf16*>(ln_b), eps, static_cast<const bf16*>(bias), res, out, out2, M, N,
        K, tiles);
    return cudaGetLastError();
}

// C[M, N] = epilogue(A . W^T) on the caller's stream, in the configuration
// gemm_plan picks for the shape.
template <int EPI, bool LN, typename InT>
cudaError_t launch_gemm(const void* a, const void* ln_w, const void* ln_b, float eps,
                        const void* w, const void* bias, const void* res, void* out,
                        int M, int N, int K, cudaStream_t stream, void* out2 = nullptr) {
    const GemmPlan p = gemm_plan(LN, M, N, K);
    if (p.config < 0) return cudaErrorInvalidValue;
#define SOD_GEMM_CASE(i, WG, BNT, PANEL)                                                      \
    case i:                                                                                 \
        if constexpr (PANEL || !LN)                                                         \
            return launch_gemm_config<EPI, LN, InT, WG, BNT, PANEL>(                        \
                a, ln_w, ln_b, eps, w, bias, res, out, M, N, K, p.tiles, stream, out2);     \
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
// Device code of the backward kernels (K3 and K4)
// ---------------------------------------------------------------------------

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;

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

// Epilogues of gemm_nn_kernel: v = the f32 accumulator.
//   NN_BF16: bf16(v)            NN_F32: f32(v)
//   NN_DGELU: a = the pre-GELU hidden (f32 when A_F32, else the saved bf16);
//             da = v * gelu'(a); bf16(da) to out, bf16(gelu(a)) to out2, and
//             the tile's column sums of the f32 da to colsum[blockIdx.x][N]
enum EpilogueNN { NN_BF16 = 0, NN_F32 = 1, NN_DGELU = 2 };

// C[M, N] = A[M, K] . W[K, N], both row-major bf16: W is a torch Linear
// weight (out, in) = (K, N) used untransposed, i.e. g . W.
// grid = (M / BM, N / BN); each warp owns a 32x32 quarter of the tile.
template <int EPI, bool A_F32>
__global__ void __launch_bounds__(THREADS)
gemm_nn_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
               const void* __restrict__ pre, void* __restrict__ out, void* __restrict__ out2,
               float* __restrict__ colsum, int N, int K) {
    __shared__ __align__(128) bf16 As[BM * (BK + APAD)];
    __shared__ __align__(128) bf16 Ws[BK * (BN + APAD)];
    __shared__ __align__(128) float Cs[BM * (BN + CPAD)];
    constexpr int lda = BK + APAD, ldw = BN + APAD, ldc = BN + CPAD;

    const int tid = threadIdx.x, warp = tid >> 5;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BM * BK / 8; i += THREADS) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            copy16(&As[r * lda + c], &a[(size_t)(m0 + r) * K + k0 + c]);
        }
        for (int i = tid; i < BK * BN / 8; i += THREADS) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            copy16(&Ws[r * ldw + c], &w[(size_t)(k0 + r) * N + n0 + c]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA fa[2];
            FragB fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * lda + kk, lda);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Ws + kk * ldw + wn + j * 16, ldw);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm + i * 16) * ldc + wn + j * 16, acc[i][j], ldc,
                                    wmma::mem_row_major);
    __syncthreads();

    for (int i = tid; i < BM * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const size_t o = (size_t)(m0 + r) * N + n0 + c;
        const float v = Cs[r * ldc + c];
        if (EPI == NN_BF16) {
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(v);
        } else if (EPI == NN_F32) {
            reinterpret_cast<float*>(out)[o] = v;
        } else {
            const float h = A_F32 ? reinterpret_cast<const float*>(pre)[o]
                                  : __bfloat162float(reinterpret_cast<const bf16*>(pre)[o]);
            const float da = v * gelu_tanh_grad(h);
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(da);
            reinterpret_cast<bf16*>(out2)[o] = __float2bfloat16(gelu_tanh(h));
            Cs[r * ldc + c] = da;
        }
    }
    if (EPI == NN_DGELU) {
        __syncthreads();
        if (tid < BN) {
            float s = 0.f;
            for (int r = 0; r < BM; ++r) s += Cs[r * ldc + tid];
            colsum[(size_t)blockIdx.x * N + n0 + tid] = s;
        }
    }
}

// Partials of C[KA, NB] = A[M, KA]^T . B[M, NB] (A, B row-major bf16): block
// (i, j, s) contracts rows [s * rows_per_split, (s + 1) * rows_per_split) (cut
// at M) of A's columns [64 i, 64 i + 64) against B's columns [64 j, 64 j + 64)
// and writes the f32 tile to part[s][KA][NB].  grid = (KA / 64, NB / 64, S).
__global__ void __launch_bounds__(THREADS)
gemm_tn_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ part,
               int M, int KA, int NB, int rows_per_split) {
    __shared__ __align__(128) bf16 As[BK * (BM + APAD)];
    __shared__ __align__(128) bf16 Bs[BK * (BN + APAD)];
    constexpr int lda = BM + APAD, ldb = BN + APAD;

    const int tid = threadIdx.x, warp = tid >> 5;
    const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int r_begin = blockIdx.z * rows_per_split;
    const int r_end = min(M, r_begin + rows_per_split);

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int r0 = r_begin; r0 < r_end; r0 += BK) {
        for (int i = tid; i < BK * BM / 8; i += THREADS) {
            const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
            copy16(&As[r * lda + c], &a[(size_t)(r0 + r) * KA + i0 + c]);
            copy16(&Bs[r * ldb + c], &b[(size_t)(r0 + r) * NB + j0 + c]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragAt fa[2];
            FragB fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + kk * lda + wm + i * 16, lda);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Bs + kk * ldb + wn + j * 16, ldb);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* tile = part + (size_t)blockIdx.z * KA * NB;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(tile + (size_t)(i0 + wm + i * 16) * NB + j0 + wn + j * 16,
                                    acc[i][j], NB, wmma::mem_row_major);
}

// out[e] = sum over s, in order, of part[s][e]: the second stage of every
// reduction over rows.  grid = ceil(n / THREADS).
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ part, int n_parts, size_t n,
                       float* __restrict__ out) {
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= n) return;
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * n + e];
    out[e] = s;
}

// LayerNorm backward + residual for 64 rows (16 per warp, one after another),
// mean and inv from ln_row_stats (the forward's, bit for bit):
//   xhat = (x - mean) * inv; dxhat = dh * ln_w
//   dx = bf16(g + inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
// and this block's column sums over its rows, to part[blockIdx.x][3][K]:
// dh * xhat (the LayerNorm scale's gradient), dh (its bias's), g (the output
// bias's: dbproj or db2).  x, g: bf16 [M, K]; dh: f32 [M, K].
// grid = M / 64; dynamic shared memory 4 * 3 * K floats.
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dh,
              const bf16* __restrict__ g, const bf16* __restrict__ ln_w, float eps,
              bf16* __restrict__ dx, float* __restrict__ part, int K) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* acc = reinterpret_cast<float*>(smem);             // [4 warps][3][K]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* mine = acc + (size_t)warp * 3 * K;
    for (int c = lane; c < 3 * K; c += 32) mine[c] = 0.f;

    for (int rr = 0; rr < 16; ++rr) {
        const size_t r = (size_t)blockIdx.x * 64 + warp * 16 + rr;
        const bf16* xr = x + r * K;
        const float* dhr = dh + r * K;
        const bf16* gr = g + r * K;
        float mean, inv;
        ln_row_stats(xr, lane, K, eps, mean, inv);
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < K; c += 32) {
            const float xhat = (to_f32(xr[c]) - mean) * inv;
            const float dxhat = dhr[c] * __bfloat162float(ln_w[c]);
            s1 += dxhat;
            s2 += dxhat * xhat;
        }
        const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
        for (int c = lane; c < K; c += 32) {
            const float xhat = (to_f32(xr[c]) - mean) * inv;
            const float d = dhr[c];
            const float dxhat = d * __bfloat162float(ln_w[c]);
            const float gv = __bfloat162float(gr[c]);
            dx[r * K + c] = __float2bfloat16(gv + inv * (dxhat - m1 - xhat * m2));
            mine[c] += d * xhat;
            mine[K + c] += d;
            mine[2 * K + c] += gv;
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 3 * K; c += THREADS)
        part[(size_t)blockIdx.x * 3 * K + c] =
            ((acc[c] + acc[3 * K + c]) + acc[6 * K + c]) + acc[9 * K + c];
}

inline cudaError_t launch_ln_rows(const void* x, const void* ln_w, const void* ln_b, float eps,
                                  void* h, int M, int K, cudaStream_t stream) {
    ln_rows_kernel<<<M / (THREADS / 32), THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
        static_cast<const bf16*>(ln_b), eps, static_cast<bf16*>(h), K);
    return cudaGetLastError();
}

template <int EPI, bool A_F32>
cudaError_t launch_gemm_nn(const void* a, const void* w, const void* pre, void* out, void* out2,
                           void* colsum, int M, int N, int K, cudaStream_t stream) {
    gemm_nn_kernel<EPI, A_F32><<<dim3(M / BM, N / BN), THREADS, 0, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), pre, out, out2,
        static_cast<float*>(colsum), N, K);
    return cudaGetLastError();
}

inline cudaError_t launch_reduce(const void* part, int n_parts, size_t n, void* out,
                                 cudaStream_t stream) {
    reduce_partials_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        static_cast<const float*>(part), n_parts, n, static_cast<float*>(out));
    return cudaGetLastError();
}

// C[KA, NB] = A[M, KA]^T . B[M, NB] in f32: partials over row splits into
// `part` ([ceil(M / rows_per_split)][KA][NB] f32 scratch), then their sum.
inline cudaError_t launch_gemm_tn(const void* a, const void* b, void* part, void* out, int M,
                                  int KA, int NB, int rows_per_split, cudaStream_t stream) {
    const int splits = (M + rows_per_split - 1) / rows_per_split;
    gemm_tn_kernel<<<dim3(KA / BM, NB / BN, splits), THREADS, 0, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(part), M,
        KA, NB, rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_reduce(part, splits, (size_t)KA * NB, out, stream);
}

// dx and out3 = [dLN scale, dLN bias, d(output bias)] (f32 [3][K]); part:
// [M / 64][3][K] f32 scratch
inline cudaError_t launch_ln_bwd(const void* x, const void* dh, const void* g, const void* ln_w,
                                 float eps, void* dx, void* part, void* out3, int M, int K,
                                 cudaStream_t stream) {
    ln_bwd_kernel<<<M / 64, THREADS, (size_t)4 * 3 * K * sizeof(float), stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dh), static_cast<const bf16*>(g),
        static_cast<const bf16*>(ln_w), eps, static_cast<bf16*>(dx), static_cast<float*>(part), K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_reduce(part, M / 64, (size_t)3 * K, out3, stream);
}

}  // namespace sod
