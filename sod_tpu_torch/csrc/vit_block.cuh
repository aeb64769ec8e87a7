// Device code of the ViT block kernels, shared by K1 (csrc/fused_block.cu),
// K3 and K5 (csrc/fused_attn.cu) and K4 (csrc/fused_mlp.cu):
//   * gemm_kernel: C[M, N] = A[M, K] . W[N, K]^T with an optional LayerNorm
//     fused into the A load and a fused epilogue;
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
// Every GEMM here is nvcuda::wmma 16x16x16 bf16 with f32 accumulators on
// shared-memory tiles (no cuBLAS); the attention's products are attention.cuh's
// (wgmma on register-resident score tiles).
//
// Shape contract (checked by the Python wrappers): rows M % 64 == 0,
// N % 64 == 0, K % 32 == 0, attention rows per image % 64 == 0, head dim in
// {32, 64, 128}, 16-byte aligned contiguous tensors.  No edge masking is
// needed under it.
#pragma once

#include <mma.h>

#include "attention.cuh"

namespace sod {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int APAD = 8;               // bf16 row pad: ldm % 8 == 0, spreads banks
constexpr int CPAD = 4;               // f32 row pad: ldm % 4 == 0

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
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

// LayerNorm statistics of one row of K values by one warp, in f32 with a
// two-pass variance: the row's mean and 1 / sqrt(var + eps)
template <typename InT>
__device__ __forceinline__ void ln_stats(const InT* __restrict__ row, int K, float eps, int lane,
                                         float& mean, float& rstd) {
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += to_f32(row[c]);
    mean = warp_sum(s) / K;
    float v = 0.f;
    for (int c = lane; c < K; c += 32) {
        const float d = to_f32(row[c]) - mean;
        v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / K + eps);
}

// W is the torch Linear layout (out, in), which is exactly wmma's col-major
// B operand.  LN: A is LayerNorm(a_in) computed per row in f32 (two-pass
// variance), rounded to bf16 and held for the whole K in shared memory.
// grid = (M / BM, N / BN); each warp owns a 32x32 quarter of the tile.
template <int EPI, bool LN, typename InT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const InT* __restrict__ a_in, const bf16* __restrict__ ln_w,
            const bf16* __restrict__ ln_b, float eps,
            const bf16* __restrict__ w, const bf16* __restrict__ bias,
            const void* __restrict__ res, void* __restrict__ out, void* __restrict__ out2,
            int N, int K) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int lda = LN ? K + APAD : BK + APAD;
    constexpr int ldw = BK + APAD, ldc = BN + CPAD;
    bf16* As = reinterpret_cast<bf16*>(smem);
    bf16* Ws = As + BM * lda;
    float* Cs = reinterpret_cast<float*>(Ws + BN * ldw);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    if (LN) {
        for (int r = warp; r < BM; r += THREADS / 32) {
            const InT* row = a_in + (size_t)(m0 + r) * K;
            float mean, rstd;
            ln_stats(row, K, eps, lane, mean, rstd);
            for (int c = lane; c < K; c += 32) {
                const float y = (to_f32(row[c]) - mean) * rstd * __bfloat162float(ln_w[c])
                                + __bfloat162float(ln_b[c]);
                As[r * lda + c] = __float2bfloat16(y);
            }
        }
    }

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BN * BK / 8; i += THREADS) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            copy16(&Ws[r * ldw + c], &w[(size_t)(n0 + r) * K + k0 + c]);
        }
        if (!LN) {
            const bf16* a = reinterpret_cast<const bf16*>(a_in);
            for (int i = tid; i < BM * BK / 8; i += THREADS) {
                const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
                copy16(&As[r * lda + c], &a[(size_t)(m0 + r) * K + k0 + c]);
            }
        }
        __syncthreads();
        const int ka = LN ? k0 : 0;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA fa[2];
            FragBt fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * lda + ka + kk, lda);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Ws + (wn + j * 16) * ldw + kk, ldw);
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
        const float b = __bfloat162float(bias[n0 + c]);
        if (EPI == EPI_BIAS_BF16) {
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(v + b);
        } else if (EPI == EPI_GELU_BF16 || EPI == EPI_GELU_SAVE_BF16) {
            const float h = v + b;
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(gelu_tanh(h));
            if (EPI == EPI_GELU_SAVE_BF16) reinterpret_cast<bf16*>(out2)[o] = __float2bfloat16(h);
        } else if (EPI == EPI_BIAS_F32) {
            reinterpret_cast<float*>(out)[o] = v + b;
        } else if (EPI == EPI_RES_F32) {
            const float x0 = __bfloat162float(reinterpret_cast<const bf16*>(res)[o]);
            reinterpret_cast<float*>(out)[o] = (x0 + v) + b;
        } else if (EPI == EPI_RES_BF16) {
            const float x1 = reinterpret_cast<const float*>(res)[o];
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16((x1 + v) + b);
        } else {
            const float x = __bfloat162float(reinterpret_cast<const bf16*>(res)[o]);
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16((x + v) + b);
        }
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

inline size_t gemm_smem(bool ln, int K) {
    return (size_t)BM * (ln ? K + APAD : BK + APAD) * sizeof(bf16)
           + (size_t)BN * (BK + APAD) * sizeof(bf16) + (size_t)BM * (BN + CPAD) * sizeof(float);
}

template <int EPI, bool LN, typename InT>
cudaError_t launch_gemm(const void* a, const void* ln_w, const void* ln_b, float eps,
                        const void* w, const void* bias, const void* res, void* out,
                        int M, int N, int K, cudaStream_t stream, void* out2 = nullptr) {
    const size_t smem = gemm_smem(LN, K);
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI, LN, InT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gemm_kernel<EPI, LN, InT><<<dim3(M / BM, N / BN), THREADS, smem, stream>>>(
        static_cast<const InT*>(a), static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
        eps, static_cast<const bf16*>(w), static_cast<const bf16*>(bias), res, out, out2, N, K);
    return cudaGetLastError();
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
// gemm_kernel's fused LayerNorm, so the backward sees the forward's h.
// grid = M / 4.
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w,
               const bf16* __restrict__ ln_b, float eps, bf16* __restrict__ h, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t r = (size_t)blockIdx.x * (THREADS / 32) + warp;
    const bf16* row = x + r * K;
    float mean, rstd;
    ln_stats(row, K, eps, lane, mean, rstd);
    for (int c = lane; c < K; c += 32) {
        const float y = (to_f32(row[c]) - mean) * rstd * __bfloat162float(ln_w[c])
                        + __bfloat162float(ln_b[c]);
        h[r * K + c] = __float2bfloat16(y);
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

// LayerNorm backward + residual for 64 rows (16 per warp, one after another):
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
        ln_stats(xr, K, eps, lane, mean, inv);
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
