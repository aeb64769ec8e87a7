// MLP half of a ViT block for Hopper (sm_90a), forward and backward, at any
// row count: x + fc2(tanh-GELU(fc1(LN(x)))) on bf16 rows.
//
// Replaces the Pallas TPU kernels K4 of sod_tpu/ops/fused_mlp.py: `_kernel`
// and `_kernel_save` (launched by `_rows_pallas`), `_bwd_kernel` and
// `_bwd_kernel_saved` (launched by `_bwd_pallas`); entry `fused_ln_mlp`.
// Same math and the same rounding points:
//   forward  x0 = f32(x); h = bf16(LN(x0)); a = h.W1 + b1 (f32);
//            hid = bf16(tanh-GELU(a)); out = bf16((x0 + hid.W2) + b2);
//            `_kernel_save` also writes bf16(a)
//   backward dyc = bf16(dy); gel = bf16(tanh-GELU(a)); dW2 = gel^T.dyc;
//            db2 = sum dy; dg = dyc.W2^T; da = dg * gelu'(a) (f32);
//            dW1 = h^T.bf16(da); db1 = sum da (f32, before rounding);
//            dh = bf16(da).W1^T; LayerNorm backward + residual -> bf16 dx.
//            `a` is the f32 recompute h.W1 + b1 in `_bwd_kernel` and the
//            bf16-rounded saved hidden in `_bwd_kernel_saved`, both for gel
//            and for gelu'.
// K4 differs from K1's MLP half in its input (bf16 x, where K1 reads its f32
// x1).
//
// What bounds it on this card: 4 x d x 4d FLOP per row (1.2 MFLOP at d 384)
// against ~1.5 KB of bf16 in and out per row: tensor-core bound, as long as
// the [rows, 4d] bf16 hidden streams through L2.  The TPU kernel keeps the
// hidden of a row chunk in VMEM; here it goes to device scratch between two
// launches, with K1's device code (vit_block.cuh):
//   (a) LN fused into the A load of the fc1 GEMM, + bias, tanh-GELU -> bf16
//   (b) fc2 GEMM + bias + residual -> bf16 out
// vit_block.cuh's gemm_kernel: wgmma fed by a TMA ring, the LN panel of each
// 128 (or 64) rows normalised once and kept for all of K, register
// epilogues; keeping the hidden on chip is later work.
// The backward (12 d hidden FLOP per row recomputing, 8 saved, against the
// same few KB per row) is tensor-core bound too.  The TPU kernel sums the
// weight gradients over its sequential row-chunk grid; blocks here run in no
// order, so every sum over rows is two stages (f32 partials per block or per
// row split, then one fixed-order reduce; no atomics, runs agree bit for
// bit).  The chain, every product vit_block.cuh's gemm_kernel (wgmma fed by
// a TMA ring) in the layout named:
//   (a) LN rows -> bf16 h
//   (b) dg GEMM (NN: W2 not transposed) with the GELU-gradient epilogue ->
//       bf16 da, bf16 gel, column partials of the f32 da per 64 rows; when
//       the hidden was not kept, the same kernel recomputes it, a second
//       product h . W1^T + b1 on the same tile in f32 registers, never stored
//   (c) dW2, dW1: row-contracting GEMMs (TN), rows split per shape + reduce
//   (d) dh GEMM (NN) -> f32  (e) LayerNorm backward + column partials
//   (f) reduces
//
// Shape contract (checked by the Python wrapper): rows % 64 == 0,
// d % 64 == 0, hidden % 64 == 0, 16-byte aligned contiguous tensors.

#include "vit_block.cuh"

using namespace sod;

// Returns a cudaError_t (0 on success) from the first launch that failed.
// Scratch: hid [rows, hidden] bf16.  out: [rows, d] bf16.  a_save: NULL, or
// [rows, hidden] bf16 for the pre-GELU hidden (`_kernel_save`).
extern "C" int sod_fused_ln_mlp(
    const void* x, const void* ln_w, const void* ln_b, const void* w_fc1, const void* b_fc1,
    const void* w_fc2, const void* b_fc2, void* hid, void* a_save, void* out, int rows, int dim,
    int hidden, float eps, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = a_save != nullptr
        ? launch_gemm<EPI_GELU_SAVE_BF16, true, bf16>(
              x, ln_w, ln_b, eps, w_fc1, b_fc1, nullptr, hid, rows, hidden, dim, stream, a_save)
        : launch_gemm<EPI_GELU_BF16, true, bf16>(
              x, ln_w, ln_b, eps, w_fc1, b_fc1, nullptr, hid, rows, hidden, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RESB_BF16, false, bf16>(
        hid, nullptr, nullptr, 0.f, w_fc2, b_fc2, x, out, rows, dim, hidden, stream);
    return (int)err;
}

// Backward.  x, dy: [rows, d] bf16.  a_saved: the forward's bf16 pre-GELU
// hidden [rows, hidden], or NULL to recompute it in f32 inside the GELU
// gradient's product.  Scratch: h [rows, d] bf16, da, gel [rows, hidden]
// bf16, dh [rows, d] f32, part_b1 [rows / 64, hidden] f32, part_w and part_ln
// f32 of the sizes sod_fused_ln_mlp_bwd_scratch gives.  Outputs: dx [rows, d]
// bf16; f32 dw_fc1 [hidden, d], db_fc1 [hidden], dw_fc2 [d, hidden] (torch
// (out, in) layout) and dln3 [3, d] = dLN scale, dLN bias, db_fc2.
extern "C" int sod_fused_ln_mlp_bwd(
    const void* x, const void* dy, const void* a_saved, const void* ln_w, const void* ln_b,
    const void* w_fc1, const void* b_fc1, const void* w_fc2, void* h, void* da, void* gel,
    void* dh, void* part_b1, void* part_w, void* part_ln, void* dx, void* dw_fc1, void* db_fc1,
    void* dw_fc2, void* dln3, int rows, int dim, int hidden, float eps, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = launch_ln_rows(x, ln_w, ln_b, eps, h, rows, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_dgelu(dy, w_fc2, a_saved, h, w_fc1, b_fc1, da, gel, part_b1, rows, hidden,
                            dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_reduce(part_b1, rows / 64, (size_t)hidden, db_fc1, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_tn(dy, gel, part_w, dw_fc2, rows, dim, hidden, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_tn(da, h, part_w, dw_fc1, rows, hidden, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm_nn<EPI_F32>(da, w_fc1, dh, rows, dim, hidden, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_ln_bwd(x, dh, dy, ln_w, eps, dx, part_ln, dln3, rows, dim, stream);
}

// f32 floats of the backward's partial buffers at `rows` rows: floats[0]
// part_w (the weight gradients' row splits), floats[1] part_ln
extern "C" void sod_fused_ln_mlp_bwd_scratch(int rows, int dim, int hidden, long long* floats) {
    floats[0] = (long long)std::max(gemm_tn_part_floats(rows, dim, hidden),
                                    gemm_tn_part_floats(rows, hidden, dim));
    floats[1] = (long long)ln_bwd_blocks(rows) * 3 * dim;
}
