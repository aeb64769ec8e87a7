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
// What bounds it on this card: bytes.  The s8 tensor cores run at twice the
// bf16 rate (1,979 TOPS), so at ViT-S (d 384, hidden 1536) every projection
// moves more bytes than its products take time: at B=8 (7168 rows) QKV 22.5
// MB, proj 22 MB, fc1 56 MB and fc2 61 MB, most of it the f32 residual x1
// and the f32 hidden that K8's rounding points keep; the attention between
// them is bound by its bf16 products.  The TPU kernel keeps one image's block
// in 100 MiB of VMEM; an SM has 227 KB, so this is a chain of five launches
// on the caller's stream, the intermediates in device scratch that the
// wrapper allocates, and the design spends no launch and no pass over memory
// on anything but the products:
//   (a) QKV:  LN1 + row quantise in the prologue, s8 product, + bias -> bf16 qkv
//   (b) attention (vit_block.cuh's launch, the bf16 block's)
//   (c) proj: row quantise of the bf16 attention output, s8 product,
//             + bias + x0 -> f32 x1
//   (d) fc1:  LN2 + row quantise, s8 product, + bias, tanh-GELU -> f32 hidden,
//             and each row's max |hidden| per 64 columns ([M][hidden / 64])
//   (e) fc2:  the hidden quantised per row with its amax the max of (d)'s
//             maxima (max is order-free: the scale is the whole row's, bit
//             for bit), s8 product, + bias + x1 -> bf16 out
// Each product is vit_block.cuh's gemm_s8_kernel: `wgmma ... .s32.s8.s8`
// from 128-byte-swizzled shared memory (128 codes a row, 128-deep ring
// stages), W streamed by a producer warp's TMA ring on mbarriers.  Its
// prologue is the row quantiser: the producer streams the block's raw rows
// through the same ring ahead of W (whole rows a job; fc2's hidden as column
// chunks, its scales known first), and the consumers (a quarter warp a
// row) take LayerNorm where asked, find each row's amax and write the codes
// straight into the swizzled panel that every column tile reads, so the
// quantisers cost no launch and no pass over memory.  A code is rint of the
// correctly rounded quotient v / s computed without a division (quant8:
// the same code as rint(__fdiv_rn(v, s)) in six full-rate instructions; the
// division's rare branch, not its arithmetic, tripled the prologue).  The
// epilogue dequantises the s32 accumulators in registers, f32(acc) * row
// scale * column scale, and applies the bias, GELU or residual there.  The
// codes and row scales reach device memory only when the caller asks for
// them (scratch), from the first column block of each row panel.
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad with
// n_pad % 128 == 0, d % 64 == 0 up to 768, hidden % 64 == 0, head dim in
// {32, 64, 128}, 16-byte aligned contiguous tensors.  Padded rows are zeros:
// LayerNorm gives its bias, amax has its floor.

#include "vit_block.cuh"

using namespace sod;   // gemm_s8_kernel, launch_attention, ln_row_stats, warp helpers

namespace {

// q[M, K], s[M] = per-row symmetric int8 of f32 rows h[M, K], one warp per
// row (the quantiser alone; the chain's quantisers are gemm_s8_kernel's
// prologues, on the same arithmetic).  grid = M / 4.
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const float* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                  int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t r = (size_t)blockIdx.x * (THREADS / 32) + warp;
    const float* row = h + r * K;
    float amax = 0.f;
    for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(row[c]));
    const float sc = quant_scale(warp_max(amax)), rc = __frcp_rn(sc);
    for (int g = lane; g < K / 8; g += 32) {
        float v[8];
        load_group(row, g, v);
        *reinterpret_cast<uint2*>(q + r * K + 8 * g) = quant8(v, sc, rc);
    }
    if (lane == 0) s[r] = sc;
}

QGemmArgs qargs(const void* a, const void* ln_w, const void* ln_b, const void* w,
                const void* ws, const void* bias, const void* res, void* out, void* q_out,
                void* s_out, float eps, int M, int N, int K) {
    QGemmArgs g{};
    g.a = a;
    g.ln_w = static_cast<const float*>(ln_w);
    g.ln_b = static_cast<const float*>(ln_b);
    g.w = w;
    g.col_scale = static_cast<const float*>(ws);
    g.bias = static_cast<const float*>(bias);
    g.res = res;
    g.out = out;
    g.q_out = static_cast<int8_t*>(q_out);
    g.s_out = static_cast<float*>(s_out);
    g.eps = eps;
    g.M = M;
    g.N = N;
    g.K = K;
    return g;
}

}  // namespace

// Returns a cudaError_t (0 on success) from the first launch that failed.
// key_mask: [batch, n_pad] uint8 (nonzero = valid key) or NULL.
// Scratch: qkv [M, 3d] bf16, attn [M, d] bf16, x1 [M, d] f32, hid [M, hidden]
// f32, part [M, hidden / 64] f32 (the hidden's row maxima per 64 columns);
// q1..q4 (codes [M, d] x 3, [M, hidden]) and scales [4, M] f32 (their row
// scales) are written where not NULL.
extern "C" int sod_fused_vit_block_int8(
    const void* x, const void* ln1_w, const void* ln1_b,
    const void* qkv_q, const void* qkv_s, const void* qkv_b,
    const void* proj_q, const void* proj_s, const void* proj_b,
    const void* ln2_w, const void* ln2_b,
    const void* fc1_q, const void* fc1_s, const void* fc1_b,
    const void* fc2_q, const void* fc2_s, const void* fc2_b,
    const void* key_mask, void* q1, void* q2, void* q3, void* q4, void* scales,
    void* qkv, void* attn, void* x1, void* hid, void* part, void* out,
    int batch, int n_pad, int dim, int n_heads, int hidden, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    float* s1 = static_cast<float*>(scales);
    float *s2 = s1 ? s1 + M : nullptr, *s3 = s1 ? s1 + 2 * M : nullptr, *s4 = s1 ? s1 + 3 * M : nullptr;
    cudaError_t err = launch_qgemm<Q_BIAS_BF16, QP_LN_BF16>(
        qargs(x, ln1_w, ln1_b, qkv_q, qkv_s, qkv_b, nullptr, qkv, q1, s1, eps, M, 3 * dim, dim),
        stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention(qkv, key_mask, attn, batch, n_pad, dim, n_heads, n_real, scale, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_qgemm<Q_RES_F32, QP_BF16>(
        qargs(attn, nullptr, nullptr, proj_q, proj_s, proj_b, x, x1, q2, s2, eps, M, dim, dim),
        stream);
    if (err != cudaSuccess) return (int)err;
    QGemmArgs fc1 = qargs(x1, ln2_w, ln2_b, fc1_q, fc1_s, fc1_b, nullptr, hid, q3, s3, eps, M,
                          hidden, dim);
    fc1.out_part = static_cast<float*>(part);
    err = launch_qgemm<Q_GELU_F32, QP_LN_F32>(fc1, stream);
    if (err != cudaSuccess) return (int)err;
    QGemmArgs fc2 = qargs(hid, nullptr, nullptr, fc2_q, fc2_s, fc2_b, x1, out, q4, s4, eps, M,
                          dim, hidden);
    fc2.amax_part = static_cast<const float*>(part);
    return (int)launch_qgemm<Q_RES_BF16, QP_F32_PART>(fc2, stream);
}

// One of the chain's products alone (timing and checks), C[M, N] over K:
// form 0 = QKV (LN of bf16 rows, quantised; + bias -> bf16), 1 = proj (bf16
// rows quantised; + bias + bf16 residual -> f32), 2 = fc1 (LN of f32 rows,
// quantised; + bias, tanh-GELU -> f32, row maxima per 64 columns to part
// [M][N / 64]), 3 = fc2 (f32 rows quantised with the amax of part [M][K /
// 64]; + bias + f32 residual -> bf16).  The codes and row scales go to q_out
// and s_out where not NULL.  Returns a cudaError_t.
extern "C" int sod_qgemm(int form, const void* a, const void* ln_w, const void* ln_b,
                         const void* wq, const void* ws, const void* bias, const void* res,
                         void* part, void* out, void* q_out, void* s_out, int M, int N, int K,
                         float eps, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    QGemmArgs g = qargs(a, ln_w, ln_b, wq, ws, bias, res, out, q_out, s_out, eps, M, N, K);
    switch (form) {
        case 0: return (int)launch_qgemm<Q_BIAS_BF16, QP_LN_BF16>(g, stream);
        case 1: return (int)launch_qgemm<Q_RES_F32, QP_BF16>(g, stream);
        case 2: g.out_part = static_cast<float*>(part);
                return (int)launch_qgemm<Q_GELU_F32, QP_LN_F32>(g, stream);
        case 3: g.amax_part = static_cast<const float*>(part);
                return (int)launch_qgemm<Q_RES_BF16, QP_F32_PART>(g, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The plan of an s8 product C[M, N] over K whose prologue holds whole A
// rows of `row_elem` bytes an element (0: none; qpro_row_elem): plan[0] the
// configuration (an index of QGEMM_CONFIG, -1 if none fits), plan[1] the
// column tiles per block, plan[2] log2 of the W ring's stages.
extern "C" void sod_qgemm_plan(int M, int N, int K, int row_elem, int* plan) {
    const QGemmPlan p = qgemm_plan(M, N, K, row_elem);
    plan[0] = p.config;
    plan[1] = p.tiles;
    plan[2] = p.lg_stages;
}

// The chain's row quantiser alone on f32 rows h [M, K] (M % 4 == 0).
extern "C" int sod_quant_rows_f32(const void* h, void* q, void* s, int M, int K,
                                  void* stream_ptr) {
    quant_rows_kernel<<<M / (THREADS / 32), THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const float*>(h), static_cast<int8_t*>(q), static_cast<float*>(s), K);
    return (int)cudaGetLastError();
}

// The chain's product alone on given codes, with the QKV epilogue:
// out[M, N] = bf16(f32(q[M, K] . wq[N, K]^T) * row_scale * ws + bias).
extern "C" int sod_qgemm_bias_bf16(const void* q, const void* row_scale, const void* wq,
                                   const void* ws, const void* bias, void* out, int M, int N,
                                   int K, void* stream_ptr) {
    QGemmArgs g = qargs(q, nullptr, nullptr, wq, ws, bias, nullptr, out, nullptr, nullptr, 0.f,
                        M, N, K);
    g.row_scale = static_cast<const float*>(row_scale);
    return (int)launch_qgemm<Q_BIAS_BF16, QP_CODES>(g, static_cast<cudaStream_t>(stream_ptr));
}
