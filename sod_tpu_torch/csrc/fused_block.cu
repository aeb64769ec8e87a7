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
// Every GEMM is nvcuda::wmma 16x16x16 bf16 with f32 accumulators on
// shared-memory tiles (no cuBLAS); wgmma/TMA pipelining for them is later
// work.  The attention's products are wgmma on register-resident score tiles
// fed by a cp.async ring (attention.cuh).
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad
// with n_pad % 128 == 0, d % 64 == 0, hidden % 64 == 0, head dim in
// {32, 64, 128}, 16-byte aligned contiguous tensors.  No edge masking is
// needed under it.

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
