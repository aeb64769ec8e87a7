// MLP half of a ViT block for Hopper (sm_90a), forward only, at any row
// count: x + fc2(tanh-GELU(fc1(LN(x)))) on bf16 rows.
//
// Replaces the forward of the Pallas TPU kernel K4: sod_tpu/ops/fused_mlp.py
// `_kernel` (launched by `_rows_pallas`; entry `fused_ln_mlp`).  Same math
// and the same rounding points:
//   x0 = f32(x); h = bf16(LN(x0)); hid = bf16(tanh-GELU(h.W1 + b1))
//   out = bf16((x0 + hid.W2) + b2)
// K4 differs from K1's MLP half in its input (bf16 x, where K1 reads its f32
// x1).  `_kernel_save` (which also streams the pre-GELU hidden) and the
// backward kernels serve training only and are not ported here.
//
// What bounds it on this card: 4 x d x 4d FLOP per row (1.2 MFLOP at d 384)
// against ~1.5 KB of bf16 in and out per row: tensor-core bound, as long as
// the [rows, 4d] bf16 hidden streams through L2.  The TPU kernel keeps the
// hidden of a row chunk in VMEM; here it goes to device scratch between two
// launches, with K1's device code (vit_block.cuh):
//   (a) LN fused into the A load of the fc1 GEMM, + bias, tanh-GELU -> bf16
//   (b) fc2 GEMM + bias + residual -> bf16 out
// wmma bf16 with f32 accumulation; keeping the hidden on chip is later work.
//
// Shape contract (checked by the Python wrapper): rows % 64 == 0,
// d % 64 == 0, hidden % 64 == 0, 16-byte aligned contiguous tensors.

#include "vit_block.cuh"

using namespace sod;

// Returns a cudaError_t (0 on success) from the first launch that failed.
// Scratch: hid [rows, hidden] bf16.  out: [rows, d] bf16.
extern "C" int sod_fused_ln_mlp(
    const void* x, const void* ln_w, const void* ln_b, const void* w_fc1, const void* b_fc1,
    const void* w_fc2, const void* b_fc2, void* hid, void* out, int rows, int dim, int hidden,
    float eps, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = launch_gemm<EPI_GELU_BF16, true, bf16>(
        x, ln_w, ln_b, eps, w_fc1, b_fc1, nullptr, hid, rows, hidden, dim, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<EPI_RESB_BF16, false, bf16>(
        hid, nullptr, nullptr, 0.f, w_fc2, b_fc2, x, out, rows, dim, hidden, stream);
    return (int)err;
}
