// Device code of the ViT block kernels, shared by K1 (csrc/fused_block.cu),
// K5 (csrc/fused_attn.cu) and the K4 forward (csrc/fused_mlp.cu):
//   * gemm_kernel: C[M, N] = A[M, K] . W[N, K]^T with an optional LayerNorm
//     fused into the A load and a fused epilogue;
//   * attention_kernel: per-head softmax attention over a packed qkv
//     [B, N, 3D] row layout (attention.cuh's two-pass device code).
// Every matmul is nvcuda::wmma 16x16x16 bf16 with f32 accumulators on
// shared-memory tiles (no cuBLAS).
//
// Shape contract (checked by the Python wrappers): rows M % 64 == 0,
// N % 64 == 0, K % 32 == 0, attention rows per image % 64 == 0, head dim in
// {32, 64, 128}, 16-byte aligned contiguous tensors.  No edge masking is
// needed under it.
#pragma once

#include "attention.cuh"

namespace sod {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;

// Epilogues: v = the f32 accumulator, b = bias (bf16), res = residual.
//   BIAS_BF16: bf16(v + b)                  GELU_BF16: bf16(tanh-GELU(v + b))
//   RES_F32:   f32((x0 + v) + b), x0 bf16   RES_BF16:  bf16((x1 + v) + b), x1 f32
//   RESB_BF16: bf16((x + v) + b), x bf16
enum Epilogue { EPI_BIAS_BF16 = 0, EPI_GELU_BF16 = 1, EPI_RES_F32 = 2, EPI_RES_BF16 = 3,
                EPI_RESB_BF16 = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
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
            const void* __restrict__ res, void* __restrict__ out,
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
            float s = 0.f;
            for (int c = lane; c < K; c += 32) s += to_f32(row[c]);
            const float mean = warp_sum(s) / K;
            float v = 0.f;
            for (int c = lane; c < K; c += 32) {
                const float d = to_f32(row[c]) - mean;
                v += d * d;
            }
            const float rstd = rsqrtf(warp_sum(v) / K + eps);
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
        } else if (EPI == EPI_GELU_BF16) {
            const float h = v + b;
            const float g = 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * (h * h * h))));
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(g);
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
// (device code in attention.cuh, shared with the K2 forward).
template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ key_mask,
                 bf16* __restrict__ out, int N, int D, int n_real, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t row3 = (size_t)3 * D;
    const bf16* base = qkv + (size_t)b * N * row3 + h * HD;
    attention_block<HD>(base, base + D, base + 2 * D, row3,
                        key_mask ? key_mask + (size_t)b * N : nullptr,
                        out + (size_t)b * N * D + h * HD, D, nullptr, nullptr,
                        blockIdx.x * AQ, N, n_real, scale, smem);
}

inline size_t gemm_smem(bool ln, int K) {
    return (size_t)BM * (ln ? K + APAD : BK + APAD) * sizeof(bf16)
           + (size_t)BN * (BK + APAD) * sizeof(bf16) + (size_t)BM * (BN + CPAD) * sizeof(float);
}

template <int EPI, bool LN, typename InT>
cudaError_t launch_gemm(const void* a, const void* ln_w, const void* ln_b, float eps,
                        const void* w, const void* bias, const void* res, void* out,
                        int M, int N, int K, cudaStream_t stream) {
    const size_t smem = gemm_smem(LN, K);
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI, LN, InT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gemm_kernel<EPI, LN, InT><<<dim3(M / BM, N / BN), THREADS, smem, stream>>>(
        static_cast<const InT*>(a), static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
        eps, static_cast<const bf16*>(w), static_cast<const bf16*>(bias), res, out, N, K);
    return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention_hd(const void* qkv, const void* key_mask, void* out, int batch,
                                int N, int D, int n_real, float scale, cudaStream_t stream) {
    const size_t smem = attention_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attention_kernel<HD><<<dim3(N / AQ, D / HD, batch), THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(key_mask),
        static_cast<bf16*>(out), N, D, n_real, scale);
    return cudaGetLastError();
}

// attention at head dim D / n_heads (32, 64 or 128)
inline cudaError_t launch_attention(const void* qkv, const void* key_mask, void* out, int batch,
                                    int N, int D, int n_heads, int n_real, float scale,
                                    cudaStream_t stream) {
    switch (D / n_heads) {
        case 32: return launch_attention_hd<32>(qkv, key_mask, out, batch, N, D, n_real, scale, stream);
        case 64: return launch_attention_hd<64>(qkv, key_mask, out, batch, N, D, n_real, scale, stream);
        case 128: return launch_attention_hd<128>(qkv, key_mask, out, batch, N, D, n_real, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace sod
