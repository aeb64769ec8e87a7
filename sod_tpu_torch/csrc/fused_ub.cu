// Upper-bound selection counts for Hopper (sm_90a): for each (image, query)
//   up    = bilinear upsample of the low-res mask to the canvas (W axis
//           first, then H, f32)
//   inter = |{up > 0.5} AND gt|,  cnt = |{up > 0.5}|   inside the valid rectangle
//
// Replaces the Pallas TPU kernel K7: sod_tpu/ops/fused_ub.py `_ub_kernel`
// (launched by `_ub_pallas`; entry `ub_inter_cnt`).  The TPU kernel runs the
// upsample as two dense MXU matmuls against the interpolation matrices
// (ops.resize._resize_matrix).  A bilinear matrix has at most two nonzero
// taps per row, so here each output pixel reads its (at most) 2 x 2 source
// values and the taps' weights, which the host takes from the matrices
// themselves (edge rows whose taps merged carry the merged weight):
//   y_k = low[r_k, c_0] * wc_0 + low[r_k, c_1] * wc_1     (k = 0, 1)
//   up  = wr_0 * y_0 + wr_1 * y_1
// each product and sum rounded once (no FMA contraction), the terms in the
// matrices' column order.  A matmul's zero terms add nothing, but its FMA
// contraction and term order are its own, so a value within an ulp or so
// of 0.5 may land on the other side here than in a matmul (the Pallas
// kernel's docstring says the same of its own matmul order).
//
// What bounds it on this card: per (image, query) the low-res mask (40 KB
// at 100 x 100) is read once into shared memory, and the canvas-size GT
// (640 KB at 400 x 400 f32) once from L2 per query; ~10 flops per canvas
// pixel.  The [B, Q, H, W] upsampled stack is never written.  One block per
// (image, query); counts go through warp reductions and shared atomics, and
// thread 0 writes the two totals.
//
// Shape contract (checked by the Python wrapper): low [B, Q, h0, w0] f32,
// gt [B, H, W] f32, rowv [B, H] and colv [B, W] uint8, taps [H, 2] and
// [W, 2] (int32 indices, f32 weights), h0 * w0 * 4 bytes of shared memory
// available, contiguous tensors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float tap2(float a, float wa, float b, float wb) {
    return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// grid = (Q, B); dynamic shared memory: h0 * w0 floats
__global__ void __launch_bounds__(THREADS)
ub_count_kernel(const float* __restrict__ low, const float* __restrict__ gt,
                const uint8_t* __restrict__ rowv, const uint8_t* __restrict__ colv,
                const int* __restrict__ r_idx, const float* __restrict__ r_w,
                const int* __restrict__ c_idx, const float* __restrict__ c_w,
                float* __restrict__ inter, float* __restrict__ cnt, int Q, int h0, int w0,
                int H, int W) {
    extern __shared__ float lows[];
    __shared__ unsigned tot[2];
    const int q = blockIdx.x, b = blockIdx.y;
    const float* src = low + ((size_t)b * Q + q) * h0 * w0;
    for (int i = threadIdx.x; i < h0 * w0; i += THREADS) lows[i] = src[i];
    if (threadIdx.x < 2) tot[threadIdx.x] = 0u;
    __syncthreads();

    const float* g = gt + (size_t)b * H * W;
    const uint8_t* rv = rowv + (size_t)b * H;
    const uint8_t* cv = colv + (size_t)b * W;
    unsigned n_inter = 0u, n_cnt = 0u;
    for (int i = threadIdx.x; i < H * W; i += THREADS) {
        const int r = i / W, c = i % W;
        if (!rv[r] || !cv[c]) continue;
        const int c0 = c_idx[2 * c], c1 = c_idx[2 * c + 1];
        const float wc0 = c_w[2 * c], wc1 = c_w[2 * c + 1];
        const float* l0 = lows + r_idx[2 * r] * w0;
        const float* l1 = lows + r_idx[2 * r + 1] * w0;
        const float y0 = tap2(l0[c0], wc0, l0[c1], wc1);
        const float y1 = tap2(l1[c0], wc0, l1[c1], wc1);
        const float up = tap2(r_w[2 * r], y0, r_w[2 * r + 1], y1);
        if (up > 0.5f) {
            ++n_cnt;
            if (g[i] > 0.f) ++n_inter;
        }
    }
    n_inter = __reduce_add_sync(0xffffffffu, n_inter);
    n_cnt = __reduce_add_sync(0xffffffffu, n_cnt);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(&tot[0], n_inter);
        atomicAdd(&tot[1], n_cnt);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        inter[(size_t)b * Q + q] = (float)tot[0];
        cnt[(size_t)b * Q + q] = (float)tot[1];
    }
}

}  // namespace

// Returns a cudaError_t (0 on success).  inter, cnt: [B, Q] f32.
extern "C" int sod_ub_inter_cnt(const void* low, const void* gt, const void* rowv,
                                const void* colv, const void* r_idx, const void* r_w,
                                const void* c_idx, const void* c_w, void* inter, void* cnt,
                                int batch, int n_q, int h0, int w0, int H, int W,
                                void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int smem = h0 * w0 * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ub_count_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ub_count_kernel<<<dim3(n_q, batch), THREADS, smem, stream>>>(
        static_cast<const float*>(low), static_cast<const float*>(gt),
        static_cast<const uint8_t*>(rowv), static_cast<const uint8_t*>(colv),
        static_cast<const int*>(r_idx), static_cast<const float*>(r_w),
        static_cast<const int*>(c_idx), static_cast<const float*>(c_w),
        static_cast<float*>(inter), static_cast<float*>(cnt), n_q, h0, w0, H, W);
    return (int)cudaGetLastError();
}
