// Backward of softmax attention over one (image, head), bf16 in and out,
// shared by the K2 backward (csrc/flash_attention.cu, q/k/v as
// [B, H, N, d]) and the K3 backward (csrc/fused_attn.cu, q/k/v inside a
// packed qkv row, gradients into a packed dqkv row).
//
// Rounding points of the Pallas kernels (sod_tpu/ops/flash_attention.py
// `_bwd_kernel`, sod_tpu/ops/fused_attn.py `_bwd_kernel`):
//   p  = exp(s - max) / sum in f32 (recomputed from the forward's row max
//        and sum), keys >= n_real -> -1e30, p = 0
//   dv = bf16(p)^T.do, dp = do.v^T (f32),
//   ds = p * (dp - sum_j(dp * p)) * scale (f32, scale inside),
//   dq = bf16(bf16(ds).k), dk = bf16(ds)^T.q, dk and dv accumulated in f32
//   over all q rows and rounded to bf16 once.
//
// What bounds it on this card: operations, as the forward (attention.cuh,
// whose tiles, copies and register layout this file uses).  The Pallas
// kernel holds the [N, N] slabs of one (image, head) in VMEM and runs five
// products; here every [N, N] product is tiled 64 x 64 and recomputed from q,
// k and the forward's row max and sum, with no atomics and no workspace of
// partial gradients (f32 dq partials per key tile would move ~125 MB each
// way at the train shape), so a block owns its output rows and runs agree bit
// for bit.  That costs nine tile products against the Pallas kernel's five:
//   dq     64 query rows, 5 products.  Pass 1 over the key tiles recomputes
//          s = q.k^T and dp = do.v^T and sums D_i = sum_j p_ij dp_ij in f32
//          (the Pallas kernels' sum(dp * p); rowsum(do * o) would differ, o
//          having been rounded to bf16).  Pass 2 recomputes both, forms
//          bf16(ds) in the accumulators' registers and accumulates
//          dq += bf16(ds).k from them; it writes D for the other launch;
//   dk, dv 64 key rows, 4 products, looping over the q tiles.  It computes
//          the transposed tiles s^T = k.q^T and dp^T = v.do^T directly, so
//          bf16(p^T) and bf16(ds^T) are A operands in registers for
//          dv += bf16(p^T).do and dk += bf16(ds^T).q, whose B operands are
//          the do and q tiles read as transposed operands.
// All products are `wgmma.mma_async` of one warpgroup.  s and dp take both
// operands from shared memory through descriptors, the block's own tiles (q
// and do, or k and v) loaded once and read in place; they are started
// together and waited for once.  No score or dp tile crosses shared memory:
// p costs one multiply-add, one `ex2` and one multiply by the row's
// reciprocal sum on the accumulators' registers, and bf16 ds (p^T, ds^T)
// feeds the next product from registers.  The other operand's tiles arrive
// through a two-stage cp.async ring, one `__syncthreads()` per tile.  Four dq
// blocks and three dk/dv blocks fit an SM at d 64.
// Rows at or beyond `n_rows` are not in memory: they read as zeros (so
// padded q rows carry zero do) and are never written.
//
// Column sums for a bias gradient (K3's dbqkv): where `colsum` pointers are
// given, each warp also writes the sums over its 16 rows of the bf16-rounded
// dq, and of the f32 dk and dv before rounding
// (sod_tpu/ops/fused_attn.py:269,277-282), into row (tile row / 16) of a
// partial buffer that a later launch reduces.
#pragma once

#include "attention.cuh"

namespace sod {

// Q, dO and two stages of (K, V)
template <int HD>
constexpr size_t dq_smem_bytes() {
    return TILE_ALIGN + (size_t)6 * tile_bytes<HD>();
}

// dq and D for query rows [q0, q0 + 64).  q, k, v: row 0 of this (image,
// head), `stride` elements between rows; dout / dq likewise with their own
// strides; m, l, dsum: this (image, head)'s [n_rows] statistics.
template <int HD>
__device__ __forceinline__ void attention_bwd_dq_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    size_t stride, const bf16* __restrict__ dout, size_t stride_do,
    const float* __restrict__ m, const float* __restrict__ l, float* __restrict__ dsum,
    bf16* __restrict__ dq, size_t stride_dq, float* __restrict__ colsum, size_t stride_cs,
    int q0, int n_rows, int n_real, float scale, unsigned char* smem) {
    constexpr uint32_t TB = tile_bytes<HD>();
    smem = align_tiles(smem);
    const uint32_t sQ = smem_u32(smem), sdO = sQ + TB, sK = sdO + TB, sV = sK + 2 * TB;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_keys = n_real < n_rows ? n_real : n_rows;
    const int T = (n_keys + AK - 1) / AK, J = 2 * T;     // jobs: pass 1 tiles, pass 2 tiles

    float m_i[2], il_i[2], d_i[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = q0 + warp * 16 + g + 8 * h;
        m_i[h] = row < n_rows ? m[row] * LOG2E : 0.f;    // in ex2's units
        il_i[h] = row < n_rows ? 1.f / l[row] : 0.f;     // p = 0 on rows not in memory
    }
    const float c2 = scale * LOG2E;

    auto fetch = [&](int job) {
        const int st = job & 1, k0 = (job < T ? job : job - T) * AK;
        load_tile<HD>(sK + st * TB, k, stride, k0, n_rows);
        load_tile<HD>(sV + st * TB, v, stride, k0, n_rows);
        cp_async_commit();
    };

    load_tile<HD>(sQ, q, stride, q0, n_rows);
    load_tile<HD>(sdO, dout, stride_do, q0, n_rows);
    fetch(0);

    float acc[HD / 8][4];
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jb][e] = 0.f;

    for (int j = 0; j < J; ++j) {
        cp_async_wait_all();
        __syncthreads();             // job j has landed; stage (j + 1) % 2 is free
        if (j + 1 < J) fetch(j + 1);
        const int st = j & 1, k0 = (j < T ? j : j - T) * AK;

        // this warp's 16 rows against the key tile: s = q.k^T, dp = do.v^T
        float s[8][4], dp[8][4];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jb][e] = dp[jb][e] = 0.f;
        mma_nt<HD>(s, sQ, sK + st * TB);
        mma_nt<HD>(dp, sdO, sV + st * TB);
        mma_wait(s);
        mma_wait(dp);

        // the forward's normalised p (f32), from its row max and sum
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[jb][e] = exp2_fast(fmaf(s[jb][e], c2, -m_i[e >> 1])) * il_i[e >> 1];
        if (k0 + AK > n_real) {
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + 8 * jb + 2 * t + (e & 1) >= n_real) s[jb][e] = 0.f;
        }

        if (j < T) {
            // pass 1: D_i = sum_j p_ij dp_ij
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
#pragma unroll
                for (int e = 0; e < 4; ++e) d_i[e >> 1] += s[jb][e] * dp[jb][e];
            if (j == T - 1) {
                d_i[0] = quad_sum(d_i[0]);
                d_i[1] = quad_sum(d_i[1]);
            }
        } else {
            // pass 2: dq += bf16(p * (dp - D) * scale) . k
#pragma unroll
            for (int jb = 0; jb < 8; ++jb)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[jb][e] = s[jb][e] * (dp[jb][e] - d_i[e >> 1]) * scale;
            uint32_t ds[4][4];
            pack_a(ds, s);
            mma_nn<HD>(acc, ds, sK + st * TB);
            mma_wait(acc);
        }
    }

    // the Q tile is read no more: each warp's 16 rows of it stage its dq
    __syncthreads();
    store_rows<HD>(acc, smem, dq, stride_dq, q0, n_rows, warp, lane);
    if (colsum != nullptr) {
        __syncwarp();
        for (int c = lane; c < HD; c += 32) {
            float sum = 0.f;
            for (int rr = 0; rr < 16; ++rr)
                sum += __bfloat162float(*reinterpret_cast<const bf16*>(
                    smem + tile_off<HD>(warp * 16 + rr, c / 8) + (c % 8) * 2));
            colsum[(size_t)(q0 / 16 + warp) * stride_cs + c] = sum;
        }
    }
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + warp * 16 + g + 8 * h;
            if (row < n_rows) dsum[row] = d_i[h];
        }
    }
}

// K, V, two stages of (Q, dO) and two stages of the q tile's max, 1 / sum, D
template <int HD>
constexpr size_t dkdv_smem_bytes() {
    return TILE_ALIGN + (size_t)6 * tile_bytes<HD>() + (size_t)2 * 3 * AQ * sizeof(float);
}

// dk and dv for key rows [k0, k0 + 64); arguments as for the dq block, dk
// and dv sharing `stride_dkv`, their column sums sharing `stride_cs`.
template <int HD>
__device__ __forceinline__ void attention_bwd_dkdv_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    size_t stride, const bf16* __restrict__ dout, size_t stride_do,
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, size_t stride_dkv,
    float* __restrict__ colsum_k, float* __restrict__ colsum_v, size_t stride_cs,
    int k0, int n_rows, int n_real, float scale, unsigned char* smem) {
    constexpr uint32_t TB = tile_bytes<HD>();
    smem = align_tiles(smem);
    const uint32_t sK = smem_u32(smem), sV = sK + TB, sQ = sV + TB, sdO = sQ + 2 * TB;
    float* stats = reinterpret_cast<float*>(smem + 6 * TB);      // [stage][m, 1 / l, D][64]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int J = (n_rows + AQ - 1) / AQ;                // q tiles
    const float c2 = scale * LOG2E;
    const bool key_ok[2] = {k0 + warp * 16 + g < n_real, k0 + warp * 16 + g + 8 < n_real};

    auto fetch = [&](int job) {
        const int st = job & 1, q0 = job * AQ;
        load_tile<HD>(sQ + st * TB, q, stride, q0, n_rows);
        load_tile<HD>(sdO + st * TB, dout, stride_do, q0, n_rows);
        if (threadIdx.x < AQ) {
            const int row = q0 + threadIdx.x;
            const bool ok = row < n_rows;
            float* s3 = stats + st * 3 * AQ + threadIdx.x;
            s3[0] = ok ? m[row] * LOG2E : 0.f;           // in ex2's units
            s3[AQ] = ok ? 1.f / l[row] : 0.f;            // p = 0 on rows not in memory
            s3[2 * AQ] = ok ? dsum[row] : 0.f;
        }
        cp_async_commit();
    };

    load_tile<HD>(sK, k, stride, k0, n_rows);
    load_tile<HD>(sV, v, stride, k0, n_rows);
    fetch(0);

    float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[jb][e] = acc_v[jb][e] = 0.f;

    for (int j = 0; j < J; ++j) {
        cp_async_wait_all();
        __syncthreads();             // job j has landed; stage (j + 1) % 2 is free
        if (j + 1 < J) fetch(j + 1);
        const int st = j & 1;
        const float* s3 = stats + st * 3 * AQ;

        // this warp's 16 keys against the q tile: s^T = k.q^T, dp^T = v.do^T
        float s[8][4], dp[8][4];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jb][e] = dp[jb][e] = 0.f;
        mma_nt<HD>(s, sK, sQ + st * TB);
        mma_nt<HD>(dp, sV, sdO + st * TB);
        mma_wait(s);
        mma_wait(dp);

        // p^T into s, ds^T into dp
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
            const float2 mq = *reinterpret_cast<const float2*>(s3 + 8 * jb + 2 * t);
            const float2 ilq = *reinterpret_cast<const float2*>(s3 + AQ + 8 * jb + 2 * t);
            const float2 dq_ = *reinterpret_cast<const float2*>(s3 + 2 * AQ + 8 * jb + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float mm = e & 1 ? mq.y : mq.x, il = e & 1 ? ilq.y : ilq.x;
                const float dd = e & 1 ? dq_.y : dq_.x;
                const float p = key_ok[e >> 1] ? exp2_fast(fmaf(s[jb][e], c2, -mm)) * il : 0.f;
                s[jb][e] = p;
                dp[jb][e] = p * (dp[jb][e] - dd) * scale;
            }
        }
        uint32_t pa[4][4];
        pack_a(pa, s);
        uint32_t dsa[4][4];
        pack_a(dsa, dp);
        mma_nn<HD>(acc_v, pa, sdO + st * TB);
        mma_nn<HD>(acc_k, dsa, sQ + st * TB);
        mma_wait(acc_v);
        mma_wait(acc_k);
    }

    // the K and V tiles are read no more: each warp's 16 rows of them stage
    // its dk and dv
    __syncthreads();
    auto write = [&](const float (&acc)[HD / 8][4], unsigned char* stage, bf16* out,
                     float* colsum) {
        store_rows<HD>(acc, stage, out, stride_dkv, k0, n_rows, warp, lane);
        if (colsum != nullptr) {
            // f32 sums over the warp's 16 rows: rows g and g + 8 of this
            // lane, then over the eight lanes that share t
#pragma unroll
            for (int jb = 0; jb < HD / 8; ++jb)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float sum = acc[jb][e] + acc[jb][e + 2];
                    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
                    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
                    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
                    if (g == 0)
                        colsum[(size_t)(k0 / 16 + warp) * stride_cs + 8 * jb + 2 * t + e] = sum;
                }
        }
    };
    write(acc_v, smem + TB, dv, colsum_v);
    write(acc_k, smem, dk, colsum_k);
}

}  // namespace sod
