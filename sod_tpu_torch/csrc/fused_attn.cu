// Attention half of a ViT block for Hopper (sm_90a): x + proj(MHSA(LN1(x))).
// Two groups of entries: the gridded inference forward K5 (any token count,
// the canvas evaluation encoder), described first, and the training pair K3
// (forward and backward, below).
//
// K5 replaces the Pallas TPU kernel: sod_tpu/ops/fused_attn.py
// `_ln_qkv_kernel`, `_attn_proj_kernel` and `_attn_proj_masked_kernel`
// (launched by `_fwd_pallas_large`; entry `fused_ln_attn_infer`).  Same
// math and the same rounding points:
//   x0 = f32(x); h = bf16(LN1(x0)); qkv = bf16(h.Wqkv + b)      (bf16 in HBM)
//   per head: s = (q.k^T in f32) * hd^-1/2, keys >= n_real or masked -> -1e30,
//             p = exp(s - max) / sum in f32, o = bf16(bf16(p).v)
//   out = bf16((x0 + o.Wproj) + bproj)
// K5 differs from K1 in two rounding points: qkv is written bf16 between
// its two Pallas kernels, and the output x1 is rounded to bf16 (K1 keeps x1
// in f32 for its MLP half).  The TPU's q-chunk of 512 rows against the
// image's whole K/V slab is a VMEM tiling choice; here every block takes 64
// q rows against all keys, as K1's attention does.
//
// What bounds it on this card: at the canvas shape (B 16, 2501 tokens padded
// to 2560, d 384, 6 heads) attention is ~2 x 2560^2 x 384 x 2 FLOP per image
// (~10 GFLOP), the projections ~3 GFLOP, against ~40 MB of activations:
// tensor-core bound.  The design is the plain correct one, three launches
// on the caller's stream, all device code shared with K1 (vit_block.cuh):
//   (a) LN1 fused into the A-operand load of a tiled bf16 GEMM, + bias -> qkv
//   (b) attention, one block per (64 q rows, head, image), two passes over
//       the keys (row max and sum, then normalised p in bf16 times v)
//   (c) proj GEMM + bias + residual -> bf16 out
// The GEMMs are vit_block.cuh's gemm_kernel (wgmma from swizzled shared
// memory fed by a TMA ring, LN1 once per row panel, register epilogues); the
// attention's products are wgmma on register-resident score tiles
// (attention.cuh).
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad
// with n_pad % 128 == 0, d % 64 == 0, head dim in {32, 64, 128}, 16-byte
// aligned contiguous tensors.

#include "attention_bwd.cuh"
#include "vit_block.cuh"

using namespace sod;

// Returns a cudaError_t (0 on success) from the first launch that failed.
// key_mask: [batch, n_pad] uint8 (nonzero = valid key) or NULL.
// Scratch: qkv [M, 3d] bf16, attn [M, d] bf16.  out: [M, d] bf16.
extern "C" int sod_fused_ln_attn_infer(
    const void* x, const void* ln_w, const void* ln_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* key_mask, void* qkv, void* attn,
    void* out, int batch, int n_pad, int dim, int n_heads, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    cudaError_t err = launch_gemm<EPI_BIAS_BF16, true, bf16>(
        x, ln_w, ln_b, eps, w_qkv, b_qkv, nullptr, qkv, M, 3 * dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention(qkv, key_mask, attn, batch, n_pad, dim, n_heads, n_real, scale, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RESB_BF16, false, bf16>(
        attn, nullptr, nullptr, 0.f, w_proj, b_proj, x, out, M, dim, dim, stream);
    return (int)err;
}

// ---------------------------------------------------------------------------
// K3: the training attention half, forward and backward.
//
// Replaces the Pallas TPU kernels of sod_tpu/ops/fused_attn.py: `_fwd_kernel`,
// `_fwd_kernel_save`, `_fwd_kernel_save_attn` (launched by `_fwd_pallas`) and
// `_bwd_kernel`, `_bwd_kernel_saved`, `_bwd_kernel_attn` (launched by
// `_bwd_pallas`); entry `fused_ln_attn`.  Same math, same rounding points:
//   forward  K5's (h = bf16(LN(x)), qkv = bf16(h.Wqkv + b), p normalised in
//            f32 then bf16, bf16 head outputs, bf16((x + attn.Wproj) + b)),
//            keys >= n_real masked with -1e30, no other key mask
//   backward gc = bf16(g); dattn = bf16(gc.Wproj^T); per head p recomputed,
//            dv = bf16(p)^T.do, dp = do.v^T, ds = p (dp - sum dp p) scale,
//            dq = bf16(bf16(ds).k), dk = bf16(ds)^T.q; dq, bf16(dk), bf16(dv)
//            packed into dqkv; dbqkv = column sums of the bf16 dq and of the
//            f32 dk, dv; dWproj = attn^T.gc, dWqkv = h^T.dqkv (f32);
//            dh = dqkv.Wqkv^T (f32); LayerNorm backward + residual -> bf16 dx;
//            dLN scale = sum dh xhat, dLN bias = sum dh, dbproj = sum g.
//
// What bounds it on this card: the TPU programs hold one image's x, qkv, the
// [N, N] f32 score slabs and every weight in VMEM and sum the weight
// gradients image after image on one core.  An SM has 227 KB, and blocks run
// in no order, so each program becomes a chain of launches with qkv, the
// attention output, dattn, dqkv and dh passing through device memory (L2 for
// most of it at the train shape: 16.5 MB of qkv), and every sum over rows is
// two stages, per-block f32 partials then one fixed-order reduce: no
// atomics, so two runs agree bit for bit; against the TPU's image-by-image
// order the sums differ by f32 rounding.  The work is ~18 GFLOP forward and
// ~50 GFLOP backward per block at B 8, 896 tokens, d 384 against ~25 MB /
// ~40 MB of compulsory traffic: tensor-core bound by a wide margin.
//
// Because qkv and the attention output pass through device memory anyway,
// the three forward variants are one chain: the save mode decides which of
// its buffers the caller keeps (qkv, or the attention output, or neither),
// and the backward recomputes whatever was not kept.  The forward also
// writes each row's softmax max and sum (f32 [B, H, N], 170 KB at the train
// shape), which every backward variant reads, as K2's does.
//   forward  (a) LN-fused QKV GEMM -> bf16 qkv  (b) two-pass attention ->
//            bf16 attn, m, l  (c) proj GEMM + residual -> bf16 out
//   backward (a) LN rows -> bf16 h  (b) QKV GEMM again unless qkv was kept
//            (c) attention again unless attn was kept  (d) dattn GEMM (NN:
//            W not transposed)  (e) dq launch, dk/dv launch (attention_bwd.cuh,
//            K2's device code over the packed layout)  (f) dWproj, dWqkv:
//            row-contracting GEMMs (TN), rows split per shape + reduce
//            (g) dh GEMM (NN)  (h) LayerNorm backward + column partials
//            (i) reduces.  Every product is vit_block.cuh's gemm_kernel
//            (wgmma fed by a TMA ring) in the layout named.
// ---------------------------------------------------------------------------

namespace {

// Attention backward over the packed layout: qkv [B, N, 3D], dattn [B, N, D],
// m / l / dsum [B, H, N] -> dqkv [B, N, 3D] and the per-16-row column sums
// colsum [B * N / 16, 3D] (bf16-rounded dq, f32 dk and dv).  One block per
// (64 rows, head, image); keys >= n_real are masked.
template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                   const float* __restrict__ m, const float* __restrict__ l,
                   float* __restrict__ dsum, bf16* __restrict__ dqkv, float* __restrict__ colsum,
                   int N, int D, int n_real, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t row3 = (size_t)3 * D;
    const size_t base = (size_t)b * N * row3 + h * HD;
    const size_t stat = ((size_t)b * gridDim.y + h) * N;
    attention_bwd_dq_block<HD>(
        qkv + base, qkv + base + D, qkv + base + 2 * D, row3,
        dattn + (size_t)b * N * D + h * HD, D, m + stat, l + stat, dsum + stat,
        dqkv + base, row3, colsum + (size_t)b * (N / 16) * row3 + h * HD, row3,
        blockIdx.x * AQ, N, n_real, scale, smem);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ dsum, bf16* __restrict__ dqkv,
                     float* __restrict__ colsum, int N, int D, int n_real, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t row3 = (size_t)3 * D;
    const size_t base = (size_t)b * N * row3 + h * HD;
    const size_t stat = ((size_t)b * gridDim.y + h) * N;
    float* cs = colsum + (size_t)b * (N / 16) * row3 + h * HD;
    attention_bwd_dkdv_block<HD>(
        qkv + base, qkv + base + D, qkv + base + 2 * D, row3,
        dattn + (size_t)b * N * D + h * HD, D, m + stat, l + stat, dsum + stat,
        dqkv + base + D, dqkv + base + 2 * D, row3, cs + D, cs + 2 * D, row3,
        blockIdx.x * AK, N, n_real, scale, smem);
}

template <int HD>
cudaError_t launch_attention_bwd_hd(const void* qkv, const void* dattn, const void* m,
                                    const void* l, void* dsum, void* dqkv, void* colsum,
                                    int batch, int N, int D, int n_real, float scale,
                                    cudaStream_t stream) {
    const dim3 grid(N / 64, D / HD, batch);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dq_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    attn_bwd_dq_kernel<HD><<<grid, THREADS, dq_smem_bytes<HD>(), stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dattn),
        static_cast<const float*>(m), static_cast<const float*>(l), static_cast<float*>(dsum),
        static_cast<bf16*>(dqkv), static_cast<float*>(colsum), N, D, n_real, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    attn_bwd_dkdv_kernel<HD><<<grid, THREADS, dkdv_smem_bytes<HD>(), stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dattn),
        static_cast<const float*>(m), static_cast<const float*>(l),
        static_cast<const float*>(dsum), static_cast<bf16*>(dqkv), static_cast<float*>(colsum),
        N, D, n_real, scale);
    return cudaGetLastError();
}

// attention backward at head dim D / n_heads (32, 64 or 128)
inline cudaError_t launch_attention_bwd(const void* qkv, const void* dattn, const void* m,
                                        const void* l, void* dsum, void* dqkv, void* colsum,
                                        int batch, int N, int D, int n_heads, int n_real,
                                        float scale, cudaStream_t stream) {
    switch (D / n_heads) {
        case 32: return launch_attention_bwd_hd<32>(qkv, dattn, m, l, dsum, dqkv, colsum, batch, N, D, n_real, scale, stream);
        case 64: return launch_attention_bwd_hd<64>(qkv, dattn, m, l, dsum, dqkv, colsum, batch, N, D, n_real, scale, stream);
        case 128: return launch_attention_bwd_hd<128>(qkv, dattn, m, l, dsum, dqkv, colsum, batch, N, D, n_real, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Forward.  Returns a cudaError_t (0 on success) from the first launch that
// failed.  Outputs: qkv [M, 3d] bf16, attn [M, d] bf16, m, l [batch, heads,
// n_pad] f32, out [M, d] bf16.
extern "C" int sod_fused_ln_attn_train_fwd(
    const void* x, const void* ln_w, const void* ln_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, void* qkv, void* attn, void* m, void* l, void* out,
    int batch, int n_pad, int dim, int n_heads, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    cudaError_t err = launch_gemm<EPI_BIAS_BF16, true, bf16>(
        x, ln_w, ln_b, eps, w_qkv, b_qkv, nullptr, qkv, M, 3 * dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention(qkv, nullptr, attn, batch, n_pad, dim, n_heads, n_real, scale, stream,
                           m, l);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RESB_BF16, false, bf16>(
        attn, nullptr, nullptr, 0.f, w_proj, b_proj, x, out, M, dim, dim, stream);
    return (int)err;
}

// Backward.  x, g: [M, d] bf16 (g zero on padded rows).  qkv_saved /
// attn_saved: 1 when the buffer holds the forward's values, 0 when it is
// scratch to recompute into.  m, l: the forward's statistics.  Scratch: h
// [M, d] bf16, dattn [M, d] bf16, dsum [batch, heads, n_pad] f32, dqkv
// [M, 3d] bf16, dh [M, d] f32, colsum [M / 16, 3d] f32, part_w and part_ln
// f32 of the sizes sod_fused_ln_attn_bwd_scratch gives.  Outputs: dx [M, d]
// bf16; f32 dw_qkv [3d, d], db_qkv [3d], dw_proj [d, d] (torch (out, in)
// layout) and dln3 [3, d] = dLN scale, dLN bias, db_proj.
extern "C" int sod_fused_ln_attn_bwd(
    const void* x, const void* g, const void* ln_w, const void* ln_b, const void* w_qkv,
    const void* b_qkv, const void* w_proj, void* qkv, int qkv_saved, void* attn, int attn_saved,
    void* m, void* l, void* h, void* dattn, void* dsum, void* dqkv, void* dh, void* colsum,
    void* part_w, void* part_ln, void* dx, void* dw_qkv, void* db_qkv, void* dw_proj, void* dln3,
    int batch, int n_pad, int dim, int n_heads, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    cudaError_t err = launch_ln_rows(x, ln_w, ln_b, eps, h, M, dim, stream);
    if (err != cudaSuccess) return (int)err;
    if (!qkv_saved) {
        err = launch_gemm<EPI_BIAS_BF16, false, bf16>(
            h, nullptr, nullptr, 0.f, w_qkv, b_qkv, nullptr, qkv, M, 3 * dim, dim, stream);
        if (err != cudaSuccess) return (int)err;
    }
    if (!attn_saved) {
        err = launch_attention(qkv, nullptr, attn, batch, n_pad, dim, n_heads, n_real, scale,
                               stream, m, l);
        if (err != cudaSuccess) return (int)err;
    }
    err = launch_gemm_nn<EPI_BF16>(g, w_proj, dattn, M, dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention_bwd(qkv, dattn, m, l, dsum, dqkv, colsum, batch, n_pad, dim, n_heads,
                               n_real, scale, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_reduce(colsum, M / 16, (size_t)3 * dim, db_qkv, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_tn(g, attn, part_w, dw_proj, M, dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_tn(dqkv, h, part_w, dw_qkv, M, 3 * dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_nn<EPI_F32>(dqkv, w_qkv, dh, M, dim, 3 * dim, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_ln_bwd(x, dh, g, ln_w, eps, dx, part_ln, dln3, M, dim, stream);
}

// f32 floats of the backward's partial buffers at M rows of width dim:
// floats[0] part_w (the weight gradients' row splits), floats[1] part_ln
extern "C" void sod_fused_ln_attn_bwd_scratch(int M, int dim, long long* floats) {
    floats[0] = (long long)std::max(gemm_tn_part_floats(M, dim, dim),
                                    gemm_tn_part_floats(M, 3 * dim, dim));
    floats[1] = (long long)ln_bwd_blocks(M) * 3 * dim;
}
