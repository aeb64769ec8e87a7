// Flash attention K2 for Hopper (sm_90a): softmax(q.k^T * scale).v over
// q, k, v [B, H, N, d] bf16, forward (optional [B, N] key mask) and backward.
//
// Replaces the Pallas TPU kernels of sod_tpu/ops/flash_attention.py:
// `_fwd_kernel` and `_fwd_kernel_masked` (in `_flash_forward`) and
// `_bwd_kernel` (in `_flash_backward`).  Same rounding points:
//   forward  s = (q.k^T in f32) * scale, keys >= N or masked -> -1e30,
//            p = exp(s - max) / sum in f32, o = bf16(bf16(p).v)
//   backward dv = bf16(bf16(p)^T.do), dp = do.v^T (f32),
//            ds = p * (dp - sum_j(dp * p)) * scale (f32, scale inside),
//            dq = bf16(bf16(ds).k), dk = bf16(bf16(ds)^T.q)
// do arrives bf16 (the Pallas wrapper casts it, flash_attention.py:198).
//
// What bounds it on this card: operations.  The Pallas backward keeps four
// f32 [N, N] slabs of one (image, head) in VMEM; at N = 785 (896 padded) that
// is 3.2 MB each against 227 KB of shared memory per block, so nothing
// [N, N] stays on chip.  Per (image, head) the work is ~10 N^2 d flops
// against ~7 N d bf16 of traffic: compute bound on the tensor cores.  The
// design tiles every [N, N] product into 64 x 64 tiles recomputed from q, k
// and the forward's per-row max and sum, and needs no atomics (a block owns
// its output rows, so runs agree bit for bit).  Three launches:
//   forward  one block per (64 q rows, image x head): the two-pass softmax
//            of attention.cuh (shared with K1, K3, K5 and K8), also writing
//            each row's max and sum (f32 [B, H, N]) as the backward's
//            residuals;
//   dq       one block per (64 q rows, image x head): pass 1 sums
//            D_i = sum_j p_ij dp_ij, pass 2 accumulates dq += bf16(ds).k and
//            writes D (five tile products);
//   dk, dv   one block per (64 key rows, image x head), looping over the q
//            tiles on the transposed tiles s^T and dp^T (four tile products).
// In all three one warpgroup owns 64 rows (a warp 16 of them); score and dp
// tiles stay in the `wgmma.mma_async` accumulators' registers, where the
// softmax arithmetic runs and from which bf16 p and ds feed the next product
// as A operands; the other operand's tiles arrive through a two-stage
// `cp.async` ring into swizzled shared memory that the tensor cores read
// through matrix descriptors.  attention.cuh and attention_bwd.cuh (shared
// with the K3 backward) hold the device code and say what each choice is
// for.  Launch bounds ask for 5, 4 and 3 blocks an SM at head dims up to 64.
// Rows at or beyond N read as zeros (so padded q rows carry zero
// do) and are never written; padded keys get -1e30, p = 0.  Shape contract
// (checked by the Python wrapper): contiguous 16-byte aligned tensors, head
// dim 32, 64 or 128, any N >= 1.

#include "attention_bwd.cuh"

namespace {

using namespace sod;

template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 5 : 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
                 bf16* __restrict__ o, float* __restrict__ m, float* __restrict__ l,
                 int H, int N, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int bh = blockIdx.y;
    const size_t off = (size_t)bh * N * HD;
    attention_block<HD>(q + off, k + off, v + off, HD,
                        key_mask ? key_mask + (size_t)(bh / H) * N : nullptr,
                        o + off, HD, m + (size_t)bh * N, l + (size_t)bh * N,
                        blockIdx.x * AQ, N, N, scale, smem);
}

// dq and D for 64 query rows of one (image, head) (device code in
// attention_bwd.cuh, shared with the K3 backward)
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    float* __restrict__ dsum, bf16* __restrict__ dq, int N, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int bh = blockIdx.y;
    const size_t off = (size_t)bh * N * HD, soff = (size_t)bh * N;
    attention_bwd_dq_block<HD>(q + off, k + off, v + off, HD, dout + off, HD, m + soff, l + soff,
                               dsum + soff, dq + off, HD, nullptr, 0, blockIdx.x * AQ, N, N,
                               scale, smem);
}

// dk and dv for 64 key rows of one (image, head)
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : 2)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int N, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int bh = blockIdx.y;
    const size_t off = (size_t)bh * N * HD, soff = (size_t)bh * N;
    attention_bwd_dkdv_block<HD>(q + off, k + off, v + off, HD, dout + off, HD, m + soff,
                                 l + soff, dsum + soff, dk + off, dv + off, HD, nullptr, nullptr,
                                 0, blockIdx.x * AK, N, N, scale, smem);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
cudaError_t forward(const void* q, const void* k, const void* v, const void* key_mask, void* o,
                    void* m, void* l, int B, int H, int N, float scale, cudaStream_t stream) {
    const size_t smem = attention_smem_bytes<HD>();
    cudaError_t err = set_smem(flash_fwd_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<HD><<<dim3((N + AQ - 1) / AQ, B * H), THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(key_mask), static_cast<bf16*>(o), static_cast<float*>(m),
        static_cast<float*>(l), H, N, scale);
    return cudaGetLastError();
}

template <int HD>
cudaError_t backward(const void* q, const void* k, const void* v, const void* dout,
                     const void* m, const void* l, void* dsum, void* dq, void* dk, void* dv,
                     int B, int H, int N, float scale, cudaStream_t stream) {
    const dim3 grid((N + 63) / 64, B * H);
    cudaError_t err = set_smem(flash_bwd_dq_kernel<HD>, dq_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<HD><<<grid, THREADS, dq_smem_bytes<HD>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<float*>(dsum), static_cast<bf16*>(dq), N, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = set_smem(flash_bwd_dkdv_kernel<HD>, dkdv_smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<HD><<<grid, THREADS, dkdv_smem_bytes<HD>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(dsum), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), N, scale);
    return cudaGetLastError();
}

}  // namespace

// All entries return a cudaError_t (0 on success).  q, k, v, o, do, dq, dk,
// dv: [B, H, N, head_dim] bf16; m, l, dsum: [B, H, N] f32; key_mask:
// [B, N] uint8 (nonzero = valid key) or NULL.
extern "C" int sod_flash_forward(const void* q, const void* k, const void* v,
                                 const void* key_mask, void* o, void* m, void* l, int B, int H,
                                 int N, int head_dim, float scale, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (head_dim) {
        case 32: return (int)forward<32>(q, k, v, key_mask, o, m, l, B, H, N, scale, stream);
        case 64: return (int)forward<64>(q, k, v, key_mask, o, m, l, B, H, N, scale, stream);
        case 128: return (int)forward<128>(q, k, v, key_mask, o, m, l, B, H, N, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dsum: scratch for D_i, written by the dq launch, read by the dk/dv launch.
extern "C" int sod_flash_backward(const void* q, const void* k, const void* v, const void* dout,
                                  const void* m, const void* l, void* dsum, void* dq, void* dk,
                                  void* dv, int B, int H, int N, int head_dim, float scale,
                                  void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (head_dim) {
        case 32: return (int)backward<32>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, H, N, scale, stream);
        case 64: return (int)backward<64>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, H, N, scale, stream);
        case 128: return (int)backward<128>(q, k, v, dout, m, l, dsum, dq, dk, dv, B, H, N, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
