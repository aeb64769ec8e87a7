// Gridded attention half of a ViT block for Hopper (sm_90a), inference only,
// at any token count: the canvas evaluation encoder.
//
// Replaces the Pallas TPU kernel K5: sod_tpu/ops/fused_attn.py
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
// wmma bf16 with f32 accumulation from shared memory; wgmma/TMA and a
// one-pass attention are later work.
//
// Shape contract (checked by the Python wrapper): rows M = batch * n_pad
// with n_pad % 128 == 0, d % 64 == 0, head dim in {32, 64, 128}, 16-byte
// aligned contiguous tensors.

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
