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
// themselves (edge rows whose taps merged carry the merged weight, and a
// second tap of weight 0 on the same index):
//   y_k = low[r_k, c_0] * wc_0 + low[r_k, c_1] * wc_1     (k = 0, 1)
//   up  = wr_0 * y_0 + wr_1 * y_1
// each product and sum rounded once (no FMA contraction), the terms in the
// matrices' column order.  A matmul's zero terms add nothing, but its FMA
// contraction and term order are its own, so a value within an ulp or so
// of 0.5 may land on the other side here than in a matmul (the Pallas
// kernel's docstring says the same of its own matmul order).
//
// What bounds it on this card: bytes, by far.  Per image the canvas GT (640
// KB at 400 x 400 f32) is read once and the 20 low-res masks (40 KB each at
// 100 x 100); ~10 flops per canvas pixel and query, which the f32 units
// take about as long as the GT takes to stream.  The [B, Q, H, W] upsampled
// stack is never written.  The design keeps every pixel's work to its H
// pass and reads the GT once:
//   * one block per (image, band of BAND_ROWS canvas rows) does all Q
//     queries.  Once per band it packs the band's GT and valid rectangle
//     into bit masks (a ballot over 32 neighbouring columns) and loads the
//     band's row taps and all column taps into shared memory;
//   * two queries at a time, their low rows the band's taps touch (the band
//     plan, made on the host once per shape: about BAND_ROWS / 4 + 2 at x4)
//     arriving in shared memory by cp.async, the next pair's copies in
//     flight while this one is counted; the W pass runs once for them,
//     y[q][lr][c] in shared memory; the H pass per pixel is two shared loads and three
//     flops, and a warp ballots `up > 0.5` over 32 columns and adds
//     popc(pred & valid & gt) and popc(pred & valid); no integer division
//     per pixel.  Rows and 32-column words outside the valid rectangle, and
//     the W pass of columns no row of the band needs, are skipped (the
//     valid share of a canvas is the images' own);
//   * the counts are integers, so their order cannot change them: each
//     band's per-query counts go to part[B][bands][Q][2], and a second
//     launch sums the bands in order and writes the f32 [B, Q] counts.
//
// Shape contract (checked by the Python wrapper): low [B, Q, h0, w0] f32,
// gt [B, H, W] f32, rowv [B, H] and colv [B, W] uint8, taps [H, 2] and
// [W, 2] (int32 indices, f32 weights), the band plan [bands, 2] int32
// (first low row, low rows), ub_smem_bytes of shared memory, contiguous
// tensors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;

__device__ __forceinline__ float tap2(float a, float wa, float b, float wb) {
    return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// a canvas row's two taps, indices relative to its band's first low row
struct RowTap { int i0, i1; float w0, w1; };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// shared memory of a block: row taps [R], column taps [W] (indices, then
// weights), y [2 queries][max_lr][W], GT and valid bits [R][ceil(W / 32)]
// each, the columns valid in any row [ceil(W / 32)], the counts [Q][2], two
// pairs of buffers of low rows [max_lr][w0]
inline size_t ub_smem_bytes(int R, int W, int max_lr, int Q, int w0) {
    const size_t words = (size_t)R * ((W + 31) / 32);
    return align16(R * sizeof(RowTap)) + align16(W * 8) + align16(W * 8) +
           2 * align16((size_t)max_lr * W * 4) + 2 * align16(words * 4) +
           align16((size_t)((W + 31) / 32) * 4) + align16((size_t)Q * 8) +
           4 * align16((size_t)max_lr * w0 * 4);
}

// this thread's share of `n` floats from src to shared dst, as cp.async
// copies it commits
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
    for (int i = threadIdx.x; i < n; i += THREADS)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     ::"r"((uint32_t)__cvta_generic_to_shared(dst + i)), "l"(src + i) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid = (bands, B)
__global__ void __launch_bounds__(THREADS)
ub_band_kernel(const float* __restrict__ low, const float* __restrict__ gt,
               const uint8_t* __restrict__ rowv, const uint8_t* __restrict__ colv,
               const int* __restrict__ r_idx, const float* __restrict__ r_w,
               const int* __restrict__ c_idx, const float* __restrict__ c_w,
               const int* __restrict__ plan, unsigned* __restrict__ part, int Q, int h0,
               int w0, int H, int W, int R, int max_lr) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int band = blockIdx.x, b = blockIdx.y, n_bands = gridDim.x;
    const int r0 = band * R, nr = min(R, H - r0), WW = (W + 31) / 32;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    RowTap* rt = reinterpret_cast<RowTap*>(smem);
    int2* ci = reinterpret_cast<int2*>(smem + align16(R * sizeof(RowTap)));
    float2* cw = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(ci) + align16(W * 8));
    float* y = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(cw) + align16(W * 8));
    const int y_stride = (int)(align16((size_t)max_lr * W * 4) / 4);   // y of the second query
    unsigned* vbits = reinterpret_cast<unsigned*>(y + 2 * y_stride);
    unsigned* gbits = vbits + align16((size_t)R * WW * 4) / 4;
    unsigned* cols = gbits + align16((size_t)R * WW * 4) / 4;
    unsigned* counts = cols + align16((size_t)WW * 4) / 4;
    float* lows = reinterpret_cast<float*>(counts + align16((size_t)Q * 8) / 4);
    const int lows_stride = (int)(align16((size_t)max_lr * w0 * 4) / 4);
    const int lo = plan[2 * band], n_lr = plan[2 * band + 1];
    const float* src = low + ((size_t)b * Q * h0 + lo) * w0;      // query 0's low rows
    const size_t q_step = (size_t)h0 * w0;
    copy_floats(lows, src, n_lr * w0);
    if (Q > 1) copy_floats(lows + lows_stride, src + q_step, n_lr * w0);

    for (int c = tid; c < W; c += THREADS) {
        ci[c] = reinterpret_cast<const int2*>(c_idx)[c];
        cw[c] = reinterpret_cast<const float2*>(c_w)[c];
    }
    for (int r = tid; r < nr; r += THREADS)
        rt[r] = RowTap{r_idx[2 * (r0 + r)] - lo, r_idx[2 * (r0 + r) + 1] - lo, r_w[2 * (r0 + r)],
                       r_w[2 * (r0 + r) + 1]};
    for (int i = tid; i < 2 * Q; i += THREADS) counts[i] = 0u;
    for (int i = tid; i < WW; i += THREADS) cols[i] = 0u;
    __syncthreads();
    // the band's valid rectangle and GT as bits, a warp a row, 16 words'
    // loads in flight at a time
    const uint8_t* cv = colv + (size_t)b * W;
    for (int r = warp; r < nr; r += WARPS) {
        const bool rv = rowv[(size_t)b * H + r0 + r] != 0;
        const float* g = gt + ((size_t)b * H + r0 + r) * W;
        for (int wd0 = 0; wd0 < WW; wd0 += 16) {
            bool v[16], gp[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const int c = 32 * (wd0 + k) + lane;
                v[k] = rv && c < W && cv[c] != 0;
                gp[k] = v[k] && g[c] > 0.f;
            }
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const unsigned vb = __ballot_sync(0xffffffffu, v[k]);
                const unsigned gb = __ballot_sync(0xffffffffu, gp[k]);
                if (lane == 0 && wd0 + k < WW) {
                    vbits[r * WW + wd0 + k] = vb;
                    gbits[r * WW + wd0 + k] = gb;
                    if (vb) atomicOr(&cols[wd0 + k], vb);
                }
            }
        }
    }

    for (int q = 0; q < Q; q += 2) {
        // this pair's low rows landed (and the last H pass is done with y);
        // the next pair's start to arrive
        const bool two = q + 1 < Q;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        const float* lq = lows + ((q >> 1) & 1) * 2 * lows_stride;
        float* ln = lows + (((q >> 1) + 1) & 1) * 2 * lows_stride;
        if (q + 2 < Q) copy_floats(ln, src + (q + 2) * q_step, n_lr * w0);
        if (q + 3 < Q) copy_floats(ln + lows_stride, src + (q + 3) * q_step, n_lr * w0);
        // the W pass over the low rows the band's taps touch, a thread a
        // column, its taps in registers, both queries
        for (int c = tid; c < W; c += THREADS) {
            if (!((cols[c >> 5] >> (c & 31)) & 1u)) continue;     // no row needs y here
            const int2 i = ci[c];
            const float2 w = cw[c];
#pragma unroll 2
            for (int lr = 0; lr < n_lr; ++lr) {
                const float* l = lq + lr * w0;
                y[lr * W + c] = tap2(l[i.x], w.x, l[i.y], w.y);
                if (two) y[y_stride + lr * W + c] = tap2(l[lows_stride + i.x], w.x,
                                                         l[lows_stride + i.y], w.y);
            }
        }
        __syncthreads();
        // the H pass, a warp a row, 32 columns a ballot, four words of both
        // queries at a time
        unsigned n_inter[2] = {0u, 0u}, n_cnt[2] = {0u, 0u};
        for (int r = warp; r < nr; r += WARPS) {
            const RowTap t = rt[r];
            const float* y0 = y + t.i0 * W;
            const float* y1 = y + t.i1 * W;
            for (int wd0 = 0; wd0 < WW; wd0 += 4) {
                unsigned vb[4], any = 0u;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    vb[u] = wd0 + u < WW ? vbits[r * WW + wd0 + u] : 0u;
                    any |= vb[u];
                }
                if (!any) continue;                      // no valid pixel in these 128 columns
                float up[2][4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int c = 32 * (wd0 + u) + lane;
                    const bool in = c < W;
                    up[0][u] = in ? tap2(t.w0, y0[c], t.w1, y1[c]) : 0.f;
                    up[1][u] = in && two ? tap2(t.w0, y0[y_stride + c], t.w1, y1[y_stride + c])
                                         : 0.f;
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const unsigned gb = vb[u] ? gbits[r * WW + wd0 + u] : 0u;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const unsigned hit = __ballot_sync(0xffffffffu, up[e][u] > 0.5f) & vb[u];
                        n_inter[e] += __popc(hit & gb);
                        n_cnt[e] += __popc(hit);
                    }
                }
            }
        }
        if (lane == 0) {
            atomicAdd(&counts[2 * q], n_inter[0]);
            atomicAdd(&counts[2 * q + 1], n_cnt[0]);
            if (two) {
                atomicAdd(&counts[2 * q + 2], n_inter[1]);
                atomicAdd(&counts[2 * q + 3], n_cnt[1]);
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * Q; i += THREADS)
        part[((size_t)b * n_bands + band) * 2 * Q + i] = counts[i];
}

// inter, cnt [B, Q] f32 = the bands' counts summed in order; grid = B
__global__ void __launch_bounds__(THREADS)
ub_sum_kernel(const unsigned* __restrict__ part, int n_bands, int Q, float* __restrict__ inter,
              float* __restrict__ cnt) {
    const int b = blockIdx.x;
    for (int i = threadIdx.x; i < 2 * Q; i += THREADS) {
        unsigned s = 0u;
        for (int band = 0; band < n_bands; ++band) s += part[((size_t)b * n_bands + band) * 2 * Q + i];
        (i & 1 ? cnt : inter)[(size_t)b * Q + i / 2] = (float)s;
    }
}

}  // namespace

// Returns a cudaError_t (0 on success).  plan: [bands, 2] int32 (first low
// row, low rows) for bands of `rows` canvas rows; part: [B, bands, Q, 2]
// uint32 scratch; inter, cnt: [B, Q] f32.
extern "C" int sod_ub_inter_cnt(const void* low, const void* gt, const void* rowv,
                                const void* colv, const void* r_idx, const void* r_w,
                                const void* c_idx, const void* c_w, const void* plan, void* part,
                                void* inter, void* cnt, int batch, int n_q, int h0, int w0, int H,
                                int W, int rows, int max_lr, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int n_bands = (H + rows - 1) / rows;
    const size_t smem = ub_smem_bytes(rows, W, max_lr, n_q, w0);
    cudaError_t err = cudaFuncSetAttribute(ub_band_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ub_band_kernel<<<dim3(n_bands, batch), THREADS, smem, stream>>>(
        static_cast<const float*>(low), static_cast<const float*>(gt),
        static_cast<const uint8_t*>(rowv), static_cast<const uint8_t*>(colv),
        static_cast<const int*>(r_idx), static_cast<const float*>(r_w),
        static_cast<const int*>(c_idx), static_cast<const float*>(c_w),
        static_cast<const int*>(plan), static_cast<unsigned*>(part), n_q, h0, w0, H, W, rows,
        max_lr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ub_sum_kernel<<<batch, THREADS, 0, stream>>>(static_cast<const unsigned*>(part), n_bands, n_q,
                                                 static_cast<float*>(inter),
                                                 static_cast<float*>(cnt));
    return (int)cudaGetLastError();
}
