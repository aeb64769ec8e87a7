// Whole pre-norm ViT encoder block for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel K1: sod_tpu/ops/fused_block.py `_kernel`
// and `_masked_kernel` (entry `fused_vit_block`).  Same math and the same
// rounding points:
//   x0 = f32(x); h = bf16(LN1(x0)); qkv = bf16(h.Wqkv + b)
//   per head: s = (q.k^T in f32) * hd^-1/2, keys >= n_real or masked -> -1e30,
//             p = exp(s - max) / sum in f32, o = bf16(bf16(p).v)
//   x1 = x0 + o.Wproj + bproj                 (f32, never rounded)
//   hid = bf16(tanh-GELU(bf16(LN2(x1)).Wfc1 + b1))
//   out = bf16(x1 + hid.Wfc2 + b2)
// Weights, biases and LN parameters arrive bf16 (the TPU kernel casts every
// weight to bf16); products are bf16 x bf16 with f32 accumulation.
//
// What bounds it on this card: the TPU kernel keeps one image's whole block
// (~12 MB at ViT-S) in 100 MiB of VMEM.  An H100 SM has 227 KB of shared
// memory, so the block cannot stay on chip; at ViT-S (n_pad 896, d 384) a
// block is ~4.4 GFLOP per image against ~6 MB of activations and weights,
// well above the card's ~295 FLOP/byte ridge, so it is tensor-core bound
// once the intermediates stream through L2 (50 MB holds all of them).
// The design is the plain correct one: five launches on the caller's stream,
// with intermediates in device scratch the wrapper allocates:
//   (a) LN1 fused into the A-operand load of a tiled bf16 GEMM, + bias -> qkv
//   (b) attention, one block per (q tile of 64 rows, head, image), two
//       passes over the keys: row max and sum first, then normalised p in
//       bf16 times v (an online softmax would round unnormalised p instead);
//       the device code is attention.cuh, shared with the K2 forward
//       (the GEMM and the packed-qkv attention launch are vit_block.cuh,
//       shared with K5 and the K4 forward)
//   (c) proj GEMM + bias + residual -> f32 x1
//   (d) LN2 fused into the A load of the fc1 GEMM, + bias, tanh-GELU -> bf16
//   (e) fc2 GEMM + bias + residual -> bf16 out
// The GEMMs are vit_block.cuh's gemm_kernel (no cuBLAS): wgmma from
// swizzled shared memory fed by a TMA ring that a producer warp keeps full,
// LN1 and LN2 computed once per row panel and kept in shared memory for all
// of K, the epilogues on the accumulators' registers; the tile and the
// column tiles per block are planned per shape (gemm_plan: at B=8, M 7168,
// 64-row panels for QKV and proj, 128-row ones for fc1, streamed 64 x 128
// tiles for fc2; 64 x 64 tiles at B=1).  The attention's products are wgmma
// on register-resident score tiles fed by a cp.async ring (attention.cuh).
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad
// with n_pad % 128 == 0, d % 64 == 0, hidden % 64 == 0, head dim in
// {32, 64, 128}, 16-byte aligned contiguous tensors.  No edge masking is
// needed under it.
//
// The library also launches gemm_kernel alone for ops/gemm.py: its forward
// forms (sod_gemm), the backward products of K3 and K4 (sod_gemm_nn,
// sod_gemm_tn) and their LayerNorm backward (sod_ln_bwd), with the plans
// they take (sod_gemm_plan).  The same three products carry ops/layers.py's
// bf16 `linear` on the card, forward and backward (ops/gemm.py `linear_tc`).

#include "vit_block.cuh"

using namespace sod;   // gemm_kernel, attention_kernel and their launchers

// Returns a cudaError_t (0 on success) from the first launch that failed.
// key_mask: [batch, n_pad] uint8 (nonzero = valid key) or NULL.
// Scratch: qkv [M, 3d] bf16, attn [M, d] bf16, x1 [M, d] f32, hid [M, hidden] bf16.
extern "C" int sod_fused_vit_block(
    const void* x, const void* ln1_w, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_w, const void* ln2_b,
    const void* w_fc1, const void* b_fc1, const void* w_fc2, const void* b_fc2,
    const void* key_mask, void* qkv, void* attn, void* x1, void* hid, void* out,
    int batch, int n_pad, int dim, int n_heads, int hidden, int n_real, float eps, float scale,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = batch * n_pad;
    cudaError_t err = launch_gemm<EPI_BIAS_BF16, true, bf16>(
        x, ln1_w, ln1_b, eps, w_qkv, b_qkv, nullptr, qkv, M, 3 * dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention(qkv, key_mask, attn, batch, n_pad, dim, n_heads, n_real, scale, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RES_F32, false, bf16>(
        attn, nullptr, nullptr, 0.f, w_proj, b_proj, x, x1, M, dim, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_GELU_BF16, true, float>(
        x1, ln2_w, ln2_b, eps, w_fc1, b_fc1, nullptr, hid, M, hidden, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RES_BF16, false, bf16>(
        hid, nullptr, nullptr, 0.f, w_fc2, b_fc2, x1, out, M, dim, hidden, stream);
    return (int)err;
}

// One forward GEMM alone (timing and checks; form 4 is also every bf16
// linear of the unfused model on the card): form 0 = LN of
// bf16 rows + bias -> bf16 (QKV), 1 = + bias + bf16 residual -> f32 (proj),
// 2 = LN of f32 rows + bias, tanh-GELU -> bf16 (fc1), 3 = + bias + f32
// residual -> bf16 (fc2), 4 = + f32 bias -> bf16 (ops/layers.py `linear`;
// no LN, no residual).  Returns a cudaError_t.
extern "C" int sod_gemm(int form, const void* a, const void* ln_w, const void* ln_b,
                        const void* w, const void* bias, const void* res, void* out, int M,
                        int N, int K, float eps, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (form) {
        case 0: return (int)launch_gemm<EPI_BIAS_BF16, true, bf16>(
            a, ln_w, ln_b, eps, w, bias, nullptr, out, M, N, K, stream);
        case 1: return (int)launch_gemm<EPI_RES_F32, false, bf16>(
            a, nullptr, nullptr, 0.f, w, bias, res, out, M, N, K, stream);
        case 2: return (int)launch_gemm<EPI_GELU_BF16, true, float>(
            a, ln_w, ln_b, eps, w, bias, nullptr, out, M, N, K, stream);
        case 3: return (int)launch_gemm<EPI_RES_BF16, false, bf16>(
            a, nullptr, nullptr, 0.f, w, bias, res, out, M, N, K, stream);
        case 4: return (int)launch_gemm<EPI_FBIAS_BF16, false, bf16>(
            a, nullptr, nullptr, 0.f, w, bias, nullptr, out, M, N, K, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One backward product of K3 and K4 alone (timing and checks), NN: C[M, N]
// = A[M, K] . W[K, N].  form 0 -> bf16 out, 1 -> f32 out, 2 = the GELU
// gradient with the kept bf16 hidden `pre` [M, N], 3 = with the hidden
// recomputed as f32(h . w1^T + b1) (h [M, K], w1 [N, K], b1 [N] bf16): bf16
// da to out, bf16 gel to out2, the column sums of the f32 da per 64 rows to
// part [M / 64][N] and their sum to colsum [N].  Returns a cudaError_t.
extern "C" int sod_gemm_nn(int form, const void* a, const void* w, const void* pre,
                           const void* h, const void* w1, const void* b1, void* out, void* out2,
                           void* part, void* colsum, int M, int N, int K, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err;
    switch (form) {
        case 0: return (int)launch_gemm_nn<EPI_BF16>(a, w, out, M, N, K, stream);
        case 1: return (int)launch_gemm_nn<EPI_F32>(a, w, out, M, N, K, stream);
        case 2: err = launch_gemm_dgelu(a, w, pre, nullptr, nullptr, nullptr, out, out2, part, M,
                                        N, K, stream); break;
        case 3: err = launch_gemm_dgelu(a, w, nullptr, h, w1, b1, out, out2, part, M, N, K,
                                        stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)launch_reduce(part, M / 64, (size_t)N, colsum, stream);
}

// The row-contracting product alone: out [KA, NB] f32 = A[M, KA]^T . B[M, NB];
// part: sod_gemm_tn_part_floats f32 of scratch.  Returns a cudaError_t.
extern "C" int sod_gemm_tn(const void* a, const void* b, void* part, void* out, int M, int KA,
                           int NB, void* stream_ptr) {
    return (int)launch_gemm_tn(a, b, part, out, M, KA, NB, static_cast<cudaStream_t>(stream_ptr));
}

extern "C" long long sod_gemm_tn_part_floats(int M, int KA, int NB) {
    return (long long)gemm_tn_part_floats(M, KA, NB);
}

// The LayerNorm backward of K3 and K4 alone: dx [M, K] bf16 and out3 =
// [dLN scale, dLN bias, column sums of g] f32 [3][K]; part:
// sod_ln_bwd_part_floats f32 of scratch.  Returns a cudaError_t.
extern "C" int sod_ln_bwd(const void* x, const void* dh, const void* g, const void* ln_w,
                          float eps, void* dx, void* part, void* out3, int M, int K,
                          void* stream_ptr) {
    return (int)launch_ln_bwd(x, dh, g, ln_w, eps, dx, part, out3, M, K,
                              static_cast<cudaStream_t>(stream_ptr));
}

extern "C" long long sod_ln_bwd_part_floats(int M, int K) {
    return (long long)ln_bwd_blocks(M) * 3 * K;
}

// The plan of a gemm_kernel launch (layout 0 NT, 1 NN, 2 TN; kind: 0, or the
// GELU gradient reading its kept hidden 1, recomputing it 2): plan[0] the
// configuration (an index of GEMM_CONFIG), plan[1] the column tiles per
// block, plan[2] the rows per split (TN).
extern "C" void sod_gemm_plan(int layout, int ln, int M, int N, int K, int kind, int* plan) {
    const GemmPlan p = layout == L_TN ? plan_for<L_TN>(false, M, N, K, 0)
                                      : plan_for<L_NN>(ln != 0, M, N, K, kind);
    plan[0] = p.config;
    plan[1] = p.tiles;
    plan[2] = p.split;
}
