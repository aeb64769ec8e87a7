// Softmax attention over one (image, head) for 64 query rows, bf16 in and
// out, shared by K1 (csrc/fused_block.cu, q/k/v inside a packed qkv row) and
// the K2 forward (csrc/flash_attention.cu, q/k/v as [B, H, N, d]).
//
// Rounding points of the Pallas kernels (sod_tpu/ops/fused_block.py
// `_kernel`, sod_tpu/ops/flash_attention.py `_fwd_kernel`):
//   s = (q.k^T in f32) * scale; keys >= n_real or masked -> -1e30
//   p = exp(s - max) / sum in f32, rounded to bf16 only after normalising
//   o = bf16(p_bf16 . v accumulated in f32)
// Two passes over the keys keep that order: pass 1 the row max and sum
// (online rescaling), pass 2 normalised p times v.  An online softmax in one
// pass would round unnormalised p instead.
//
// Layout: warp w owns q rows 16w..16w+15; lane pair (2r, 2r+1) owns row r's
// softmax statistics, each lane half of a 64-key tile.  Rows at or beyond
// `n_rows` are not in memory: their loads read zeros and their stores are
// skipped, so any N works.  A row whose keys are all masked has no defined
// result (callers keep one valid key, the CLS token).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace sod {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;          // 4 warps
constexpr int APAD = 8;               // bf16 row pad: ldm % 8 == 0, spreads banks
constexpr int CPAD = 4;               // f32 row pad: ldm % 4 == 0
constexpr int AQ = 64;                // attention q rows per block (16 per warp)
constexpr int AK = 64;                // attention keys per tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// rows [r0, r0 + rows) of a row-major bf16 matrix with HD columns and
// `stride` elements between rows, into shared memory with leading dim ld;
// rows >= n_rows are written as zeros
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                          int r0, int n_rows, int rows) {
    for (int i = threadIdx.x; i < rows * HD / 8; i += THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        if (r0 + r < n_rows)
            copy16(dst + r * ld + c, src + (size_t)(r0 + r) * stride + c);
        else
            *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
    }
}

template <int HD>
constexpr size_t attention_smem_bytes() {
    return (size_t)(AQ + 2 * AK) * (HD + APAD) * sizeof(bf16)
           + (size_t)4 * 16 * (AK + CPAD) * sizeof(float)
           + (size_t)4 * 16 * (AK + APAD) * sizeof(bf16)
           + (size_t)4 * 16 * (HD + CPAD) * sizeof(float);
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
    constexpr int ldq = HD + APAD, lds = AK + CPAD, ldp = AK + APAD, ldo = HD + CPAD;
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + AQ * ldq;
    bf16* Vs = Ks + AK * ldq;
    float* Ss = reinterpret_cast<float*>(Vs + AK * ldq);
    bf16* Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * lds);
    float* Os = reinterpret_cast<float*>(Ps + 4 * 16 * ldp);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* Sw = Ss + warp * 16 * lds;
    bf16* Pw = Ps + warp * 16 * ldp;
    float* Ow = Os + warp * 16 * ldo;
    const int r = lane >> 1, half = (lane & 1) * 32;

    load_rows<HD>(Qs, ldq, q, stride, q0, n_rows, AQ);

    // S tile (16 q rows x 64 keys) of this warp into Sw
    auto scores = [&]() {
#pragma unroll
        for (int j = 0; j < AK / 16; ++j) {
            FragC s;
            wmma::fill_fragment(s, 0.f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                FragA fa;
                FragBt fb;
                wmma::load_matrix_sync(fa, Qs + warp * 16 * ldq + kk, ldq);
                wmma::load_matrix_sync(fb, Ks + j * 16 * ldq + kk, ldq);
                wmma::mma_sync(s, fa, fb, s);
            }
            wmma::store_matrix_sync(Sw + j * 16, s, lds, wmma::mem_row_major);
        }
        __syncwarp();
    };
    auto logit = [&](int k0, int col) {
        const int key = k0 + col;
        const bool ok = key < n_real && (mask == nullptr || mask[key] != 0);
        return ok ? Sw[r * lds + col] * scale : -1e30f;
    };

    // pass 1: row max and sum of exp(s - max)
    float m_run = -INFINITY, l_run = 0.f;
    for (int k0 = 0; k0 < n_rows; k0 += AK) {
        load_rows<HD>(Ks, ldq, k, stride, k0, n_rows, AK);
        __syncthreads();
        scores();
        float t_max = -INFINITY;
        for (int c = 0; c < 32; ++c) t_max = fmaxf(t_max, logit(k0, half + c));
        t_max = fmaxf(t_max, __shfl_xor_sync(0xffffffffu, t_max, 1));
        const float m_new = fmaxf(m_run, t_max);
        float t_sum = 0.f;
        for (int c = 0; c < 32; ++c) t_sum += expf(logit(k0, half + c) - m_new);
        t_sum += __shfl_xor_sync(0xffffffffu, t_sum, 1);
        l_run = l_run * expf(m_run - m_new) + t_sum;
        m_run = m_new;
        __syncthreads();
    }

    // pass 2: p = exp(s - max) / sum, rounded to bf16, times v
    FragC acc[HD / 16];
#pragma unroll
    for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int k0 = 0; k0 < n_rows; k0 += AK) {
        load_rows<HD>(Ks, ldq, k, stride, k0, n_rows, AK);
        load_rows<HD>(Vs, ldq, v, stride, k0, n_rows, AK);
        __syncthreads();
        scores();
        for (int c = 0; c < 32; ++c)
            Pw[r * ldp + half + c] = __float2bfloat16(expf(logit(k0, half + c) - m_run) / l_run);
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < AK; kk += 16) {
            FragA fp;
            wmma::load_matrix_sync(fp, Pw + kk, ldp);
#pragma unroll
            for (int f = 0; f < HD / 16; ++f) {
                FragB fv;
                wmma::load_matrix_sync(fv, Vs + kk * ldq + f * 16, ldq);
                wmma::mma_sync(acc[f], fp, fv, acc[f]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int f = 0; f < HD / 16; ++f)
        wmma::store_matrix_sync(Ow + f * 16, acc[f], ldo, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
        const int rr = i / HD, c = i % HD;
        const int row = q0 + warp * 16 + rr;
        if (row < n_rows) o[(size_t)row * stride_o + c] = __float2bfloat16(Ow[rr * ldo + c]);
    }
    const int row = q0 + warp * 16 + r;
    if (m_out != nullptr && (lane & 1) == 0 && row < n_rows) {
        m_out[row] = m_run;
        l_out[row] = l_run;
    }
}

}  // namespace sod
