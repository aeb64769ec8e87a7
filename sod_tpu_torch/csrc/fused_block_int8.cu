// Int8 (W8A8) pre-norm ViT encoder block for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel K8: sod_tpu/ops/fused_block_int8.py `_kernel`
// and `_masked_kernel` (entry `fused_vit_block_int8`).  It is the bf16 block
// of csrc/fused_block.cu with the four projections as s8 x s8 -> s32
// tensor-core products.  Same math and the same rounding points as K8:
//   x0 = f32(x); h = LN1(x0) in f32 (not rounded to bf16)
//   quantise rows: s = max(max|h|, 1e-8) / 127, q = clip(rint(h / s), +-127)
//   qdot(h, W) = f32(q . Wq in s32) * s[row] * Ws[col]        (in that order)
//   qkv = bf16(qdot(h, Wqkv) + b); attention exactly as the bf16 block's
//   x1 = (x0 + qdot(f32(attn), Wproj)) + bproj                (f32, never rounded)
//   hid = tanh-GELU(qdot(LN2(x1), Wfc1) + b1) in f32, quantised per row over
//         all its columns
//   out = bf16((x1 + qdot(hid, Wfc2)) + b2)
// LayerNorm parameters, biases and scales are f32; weights are int8 codes in
// torch's (out, in) layout, which is the K-major B operand the product wants.
// Every f32 step that feeds a quantiser is written with the non-contracting
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn), so no FMA moves a value
// across a .5 boundary that the plain version rounds the other way.
//
// What bounds it on this card: as the bf16 block, the products (4.4 GFLOP per
// image at ViT-S) against a few MB of tokens and weights: operations, at the
// int8 tensor-core rate for the projections and the bf16 rate for attention.
// The TPU kernel keeps one image's block in 100 MiB of VMEM; an SM has 227 KB,
// so this is a chain of nine launches on the caller's stream with the
// intermediates in device scratch that the wrapper allocates:
//   (a) LN1 + row quantise -> codes q1 [M, d], row scales
//   (b) s8 GEMM, epilogue * scales + bias -> bf16 qkv
//   (c) attention (vit_block.cuh's launch, unchanged)
//   (d) row quantise of the bf16 attention output -> q2
//   (e) s8 GEMM, + bias + x0 -> f32 x1
//   (f) LN2 + row quantise -> q3
//   (g) s8 GEMM, + bias, tanh-GELU -> f32 hidden [M, hidden]
//   (h) row quantise of the hidden -> q4 (a GEMM tile sees 64 of a row's
//       columns, so the row's amax needs the whole row in memory first; a
//       bf16 scratch would move the codes)
//   (i) s8 GEMM, + bias + x1 -> bf16 out
// The product is nvcuda::wmma 16x16x16 with signed char operands and int
// accumulators on shared-memory tiles (no cuBLAS); operand tiles sit in
// shared memory as 16-code-wide k slabs with 32-byte rows, so every fragment
// pointer is 32-byte aligned.  wgmma, TMA and fusing the quantisers into the
// neighbouring launches are later work.
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad with
// n_pad % 128 == 0, d % 64 == 0, hidden % 64 == 0, head dim in {32, 64, 128},
// 16-byte aligned contiguous tensors.  No edge masking is needed under it.
// Padded rows are zeros: LayerNorm gives its bias, amax has its floor.

#include "vit_block.cuh"

using namespace sod;   // launch_attention, ln_row_stats, warp helpers, tile sizes

namespace {

typedef signed char s8;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major> FragQA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::col_major> FragQB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragQC;

constexpr int QK = 64;          // codes of K per tile step
constexpr int SLABS = QK / 16;  // 16-code-wide k slabs per step
constexpr int SLAB_LD = 32;     // bytes per slab row: 16 codes + 16 pad

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// the value a row quantiser sees at column c: the input, or LayerNorm of it
// as ((x - mean) * rstd) * w + b with every step rounded
template <bool LN, typename InT>
__device__ __forceinline__ float row_value(const InT* __restrict__ row, int c, float mean,
                                           float rstd, const float* __restrict__ ln_w,
                                           const float* __restrict__ ln_b) {
    const float v = to_f32(row[c]);
    if (!LN) return v;
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), ln_w[c]), ln_b[c]);
}

// q[M, K], s[M] = per-row symmetric int8 of in[M, K] (LN: of LayerNorm(in)),
// one warp per row.  grid = M / 4.
template <bool LN, typename InT>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const InT* __restrict__ in, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, float eps, s8* __restrict__ q,
                  float* __restrict__ s, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t r = (size_t)blockIdx.x * (THREADS / 32) + warp;
    const InT* row = in + r * K;
    float mean = 0.f, rstd = 0.f;
    if (LN) ln_row_stats(row, lane, K, eps, mean, rstd);
    float amax = 0.f;
    for (int c = lane; c < K; c += 32)
        amax = fmaxf(amax, fabsf(row_value<LN>(row, c, mean, rstd, ln_w, ln_b)));
    amax = warp_max(amax);
    const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
    for (int c = lane; c < K; c += 32) {
        float t = rintf(__fdiv_rn(row_value<LN>(row, c, mean, rstd, ln_w, ln_b), sc));
        t = fminf(fmaxf(t, -127.f), 127.f);
        q[r * K + c] = (s8)(int)t;
    }
    if (lane == 0) s[r] = sc;
}

// 0.5 h (1 + tanh(c0 (h + c1 h^3))) with every step rounded
__device__ __forceinline__ float gelu_tanh_rn(float h) {
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float t = tanhf(__fmul_rn(GELU_C0, __fadd_rn(h, __fmul_rn(GELU_C1, h3))));
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, t));
}

// Epilogues: v = f32(acc) * row_scale * col_scale, b = bias (f32).
//   Q_BIAS_BF16: bf16(v + b)                Q_RES_F32: f32((x0 + v) + b), x0 bf16
//   Q_GELU_F32:  f32(tanh-GELU(v + b))      Q_RES_BF16: bf16((x1 + v) + b), x1 f32
enum QEpilogue { Q_BIAS_BF16 = 0, Q_RES_F32 = 1, Q_GELU_F32 = 2, Q_RES_BF16 = 3 };

// C[M, N] = A[M, K] . W[N, K]^T, s8 x s8 -> s32, then the epilogue.
// grid = (M / BM, N / BN); each warp owns a 32x32 quarter of the tile.
template <int EPI>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const s8* __restrict__ a, const float* __restrict__ row_scale,
             const s8* __restrict__ w, const float* __restrict__ col_scale,
             const float* __restrict__ bias, const void* __restrict__ res,
             void* __restrict__ out, int N, int K) {
    __shared__ __align__(128) s8 As[SLABS * BM * SLAB_LD];
    __shared__ __align__(128) s8 Ws[SLABS * BN * SLAB_LD];
    __shared__ __align__(128) int Cs[BM * (BN + CPAD)];
    constexpr int ldc = BN + CPAD;

    const int tid = threadIdx.x, warp = tid >> 5;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    FragQC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

    for (int k0 = 0; k0 < K; k0 += QK) {
        // 16 bytes a thread: row r's slab c of both tiles
        for (int i = tid; i < BM * SLABS; i += THREADS) {
            const int r = i / SLABS, c = i % SLABS;
            *reinterpret_cast<uint4*>(&As[(c * BM + r) * SLAB_LD]) =
                *reinterpret_cast<const uint4*>(&a[(size_t)(m0 + r) * K + k0 + c * 16]);
            *reinterpret_cast<uint4*>(&Ws[(c * BN + r) * SLAB_LD]) =
                *reinterpret_cast<const uint4*>(&w[(size_t)(n0 + r) * K + k0 + c * 16]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < SLABS; ++kk) {
            FragQA fa[2];
            FragQB fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + (kk * BM + wm + i * 16) * SLAB_LD, SLAB_LD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Ws + (kk * BN + wn + j * 16) * SLAB_LD, SLAB_LD);
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
        // |acc| can pass 2^24: the conversion rounds to nearest
        const float v = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * ldc + c]), row_scale[m0 + r]),
                                  col_scale[n0 + c]);
        const float b = bias[n0 + c];
        if (EPI == Q_BIAS_BF16) {
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(__fadd_rn(v, b));
        } else if (EPI == Q_RES_F32) {
            const float x0 = __bfloat162float(reinterpret_cast<const bf16*>(res)[o]);
            reinterpret_cast<float*>(out)[o] = __fadd_rn(__fadd_rn(x0, v), b);
        } else if (EPI == Q_GELU_F32) {
            reinterpret_cast<float*>(out)[o] = gelu_tanh_rn(__fadd_rn(v, b));
        } else {
            const float x1 = reinterpret_cast<const float*>(res)[o];
            reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(__fadd_rn(__fadd_rn(x1, v), b));
        }
    }
}

template <bool LN, typename InT>
cudaError_t launch_quant_rows(const void* in, const void* ln_w, const void* ln_b, float eps,
                              void* q, void* s, int M, int K, cudaStream_t stream) {
    quant_rows_kernel<LN, InT><<<M / (THREADS / 32), THREADS, 0, stream>>>(
        static_cast<const InT*>(in), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), eps, static_cast<s8*>(q), static_cast<float*>(s), K);
    return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_qgemm(const void* a, const void* row_scale, const void* w,
                         const void* col_scale, const void* bias, const void* res, void* out,
                         int M, int N, int K, cudaStream_t stream) {
    qgemm_kernel<EPI><<<dim3(M / BM, N / BN), THREADS, 0, stream>>>(
        static_cast<const s8*>(a), static_cast<const float*>(row_scale),
        static_cast<const s8*>(w), static_cast<const float*>(col_scale),
        static_cast<const float*>(bias), res, out, N, K);
    return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success) from the first launch that failed.
// key_mask: [batch, n_pad] uint8 (nonzero = valid key) or NULL.
// Scratch: codes q1, q2, q3 [M, d] and q4 [M, hidden] int8, scales [4, M] f32
// (the row scales of q1..q4), qkv [M, 3d] bf16, attn [M, d] bf16, x1 [M, d]
// f32, hid [M, hidden] f32.
extern "C" int sod_fused_vit_block_int8(
    const void* x, const void* ln1_w, const void* ln1_b,
    const void* qkv_q, const void* qkv_s, const void* qkv_b,
    const void* proj_q, const void* proj_s, const void* proj_b,
    const void* ln2_w, const void* ln2_b,
    const void* fc1_q, const void* fc1_s, const void* fc1_b,
    const void* fc2_q, const void* fc2_s, const void* fc2_b,
    const void* key_mask, void* q1, void* q2, void* q3, void* q4, void* scales,
    void* qkv, void* attn, void* x1, void* hid, void* out,
    int batch, int n_pad, int dim, int n_heads, int hidden, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    float* s1 = static_cast<float*>(scales);
    float *s2 = s1 + M, *s3 = s2 + M, *s4 = s3 + M;
    cudaError_t err = launch_quant_rows<true, bf16>(x, ln1_w, ln1_b, eps, q1, s1, M, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_qgemm<Q_BIAS_BF16>(q1, s1, qkv_q, qkv_s, qkv_b, nullptr, qkv, M, 3 * dim, dim,
                                    stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention(qkv, key_mask, attn, batch, n_pad, dim, n_heads, n_real, scale, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_quant_rows<false, bf16>(attn, nullptr, nullptr, 0.f, q2, s2, M, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_qgemm<Q_RES_F32>(q2, s2, proj_q, proj_s, proj_b, x, x1, M, dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_quant_rows<true, float>(x1, ln2_w, ln2_b, eps, q3, s3, M, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_qgemm<Q_GELU_F32>(q3, s3, fc1_q, fc1_s, fc1_b, nullptr, hid, M, hidden, dim,
                                   stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_quant_rows<false, float>(hid, nullptr, nullptr, 0.f, q4, s4, M, hidden, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_qgemm<Q_RES_BF16>(q4, s4, fc2_q, fc2_s, fc2_b, x1, out, M, dim, hidden, stream);
    return (int)err;
}

// The chain's row quantiser alone on f32 rows h [M, K] (M % 4 == 0).
extern "C" int sod_quant_rows_f32(const void* h, void* q, void* s, int M, int K,
                                  void* stream_ptr) {
    return (int)launch_quant_rows<false, float>(h, nullptr, nullptr, 0.f, q, s, M, K,
                                                static_cast<cudaStream_t>(stream_ptr));
}

// The chain's product alone with the QKV epilogue:
// out[M, N] = bf16(f32(q[M, K] . wq[N, K]^T) * row_scale * ws + bias).
extern "C" int sod_qgemm_bias_bf16(const void* q, const void* row_scale, const void* wq,
                                   const void* ws, const void* bias, void* out, int M, int N,
                                   int K, void* stream_ptr) {
    return (int)launch_qgemm<Q_BIAS_BF16>(q, row_scale, wq, ws, bias, nullptr, out, M, N, K,
                                          static_cast<cudaStream_t>(stream_ptr));
}
