// F-max threshold-sweep counts for Hopper (sm_90a): for each (image, mask)
//   tp[t]  = |{pred > thr[t]} AND gt|,  cnt[t] = |{pred > thr[t]}|
// for t < n_thr, inside the valid rectangle.  thr is an increasing f32 table
// from the host (the one sod_tpu's compiled sweep compares against, see
// sod_tpu_torch/ops/fsweep.py).
//
// Replaces the Pallas TPU kernel K6: sod_tpu/ops/fsweep.py `_sweep_kernel`
// (launched by `_tp_cnt_pallas`; entry `fmax_tp_cnt`).  The TPU has no
// scatter, so its kernel compares every pixel with all 255 thresholds
// (2 x 255 compares per pixel on the VPU).  The thresholds are monotone, so
// a pixel exceeds exactly a prefix of them: here each pixel computes
//   k = #{t : pred > thr[t]}
// once (an estimate from pred * n_thr, corrected with exact compares against
// the table, so k is exact and NaN counts nowhere), adds one to
// bin k of a shared-memory histogram (and of the tp histogram where gt > 0),
// and the block adds its histograms to global counts with integer atomics
// (exact and independent of order).  A second launch takes the suffix sums
// cnt[t] = sum_{j > t} hist[j] and writes them as f32 (integer-exact below
// 2^24 pixels).  Pixels outside rowv x colv count nowhere: the TPU kernel's
// -1 sentinel.
//
// What bounds it on this card: one read of each mask pixel (4 B) and of the
// gt and validity masks, ~20 MB at the canvas shape (B 16, 2 masks,
// 400 x 400): memory and shared-atomic bound, a few tens of microseconds.
//
// Shape contract (checked by the Python wrapper): masks [B, M, H, W] f32,
// gt [B, H, W] f32, rowv [B, H] and colv [B, W] uint8, thr [n_thr] f32,
// n_thr <= 256, contiguous tensors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;               // mask rows per block
constexpr int MAX_THR = 256;

// #{t < n_thr : p > thr[t]} for the increasing table thr
__device__ __forceinline__ int exceed_count(float p, const float* thr, int n_thr) {
    const float e = p * (float)n_thr;
    int k = e > 0.f ? (int)fminf(ceilf(e), (float)n_thr) : 0;   // NaN -> 0
    while (k < n_thr && p > thr[k]) ++k;
    while (k > 0 && !(p > thr[k - 1])) --k;
    return k;
}

// grid = (ceil(H / ROWS), M, B); hist: [B, M, 2, n_thr + 1] uint32 (cnt, tp)
__global__ void __launch_bounds__(THREADS)
sweep_hist_kernel(const float* __restrict__ masks, const float* __restrict__ gt,
                  const uint8_t* __restrict__ rowv, const uint8_t* __restrict__ colv,
                  const float* __restrict__ thr_g, unsigned* __restrict__ hist, int M,
                  int H, int W, int n_thr) {
    __shared__ float thr[MAX_THR];
    __shared__ unsigned h_cnt[MAX_THR + 1], h_tp[MAX_THR + 1];
    const int b = blockIdx.z, m = blockIdx.y;
    for (int t = threadIdx.x; t <= n_thr; t += THREADS) {
        if (t < n_thr) thr[t] = thr_g[t];
        h_cnt[t] = 0u;
        h_tp[t] = 0u;
    }
    __syncthreads();

    const int r0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, H - r0);
    const float* pm = masks + ((size_t)b * M + m) * H * W;
    const float* g = gt + (size_t)b * H * W;
    const uint8_t* rv = rowv + (size_t)b * H;
    const uint8_t* cv = colv + (size_t)b * W;
    for (int i = threadIdx.x; i < rows * W; i += THREADS) {
        const int r = r0 + i / W, c = i % W;
        if (!rv[r] || !cv[c]) continue;
        const size_t o = (size_t)r * W + c;
        const int k = exceed_count(pm[o], thr, n_thr);
        atomicAdd(&h_cnt[k], 1u);
        if (g[o] > 0.f) atomicAdd(&h_tp[k], 1u);
    }
    __syncthreads();

    unsigned* out = hist + ((size_t)b * M + m) * 2 * (n_thr + 1);
    for (int t = threadIdx.x; t <= n_thr; t += THREADS) {
        if (h_cnt[t]) atomicAdd(&out[t], h_cnt[t]);
        if (h_tp[t]) atomicAdd(&out[n_thr + 1 + t], h_tp[t]);
    }
}

// one block per (image, mask): cnt[t] = sum_{j > t} hist_cnt[j], tp likewise
__global__ void __launch_bounds__(THREADS)
sweep_finish_kernel(const unsigned* __restrict__ hist, float* __restrict__ tp,
                    float* __restrict__ cnt, int n_thr) {
    __shared__ unsigned h[2 * (MAX_THR + 1)];
    const size_t bm = blockIdx.x;
    const unsigned* src = hist + bm * 2 * (n_thr + 1);
    for (int i = threadIdx.x; i < 2 * (n_thr + 1); i += THREADS) h[i] = src[i];
    __syncthreads();
    for (int t = threadIdx.x; t < n_thr; t += THREADS) {
        unsigned c = 0u, p = 0u;
        for (int j = t + 1; j <= n_thr; ++j) {
            c += h[j];
            p += h[n_thr + 1 + j];
        }
        cnt[bm * n_thr + t] = (float)c;
        tp[bm * n_thr + t] = (float)p;
    }
}

}  // namespace

// Returns a cudaError_t (0 on success) from the first call that failed.
// thr: [n_thr] f32, increasing.  Scratch: hist [B, M, 2, n_thr + 1] 32-bit.
// tp, cnt: [B, M, n_thr] f32.
extern "C" int sod_fmax_tp_cnt(const void* masks, const void* gt, const void* rowv,
                               const void* colv, const void* thr, void* hist, void* tp,
                               void* cnt, int batch, int n_masks, int H, int W, int n_thr,
                               void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (n_thr < 1 || n_thr > MAX_THR) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        hist, 0, (size_t)batch * n_masks * 2 * (n_thr + 1) * sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    sweep_hist_kernel<<<dim3((H + ROWS - 1) / ROWS, n_masks, batch), THREADS, 0, stream>>>(
        static_cast<const float*>(masks), static_cast<const float*>(gt),
        static_cast<const uint8_t*>(rowv), static_cast<const uint8_t*>(colv),
        static_cast<const float*>(thr), static_cast<unsigned*>(hist), n_masks, H, W, n_thr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sweep_finish_kernel<<<batch * n_masks, THREADS, 0, stream>>>(
        static_cast<const unsigned*>(hist), static_cast<float*>(tp), static_cast<float*>(cnt),
        n_thr);
    return (int)cudaGetLastError();
}
