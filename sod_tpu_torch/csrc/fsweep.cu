// F-max threshold-sweep counts for Hopper (sm_90a): for each (image, mask)
//   tp[t]  = |{pred > thr[t]} AND gt|,  cnt[t] = |{pred > thr[t]}|
// for t < n_thr, inside the valid rectangle.  thr[t] = t * inv in f32 with
// inv = f32(1 / n_thr) from the host: the table sod_tpu's compiled sweep
// compares against (sod_tpu_torch/ops/fsweep.py builds it with the same
// products), computed here instead of read.
//
// Replaces the Pallas TPU kernel K6: sod_tpu/ops/fsweep.py `_sweep_kernel`
// (launched by `_tp_cnt_pallas`; entry `fmax_tp_cnt`).  The TPU has no
// scatter, so its kernel compares every pixel with all 255 thresholds
// (2 x 255 compares per pixel on the VPU).  The thresholds are monotone, so
// a pixel exceeds exactly a prefix of them: here each pixel computes
//   k = #{t : pred > thr[t]}
// once (an estimate from pred * n_thr, corrected with exact compares against
// the table, so k is exact and NaN counts nowhere) and adds one to bin k of
// a histogram, and cnt[t] = sum_{j > t} hist[j] (tp likewise, over the
// pixels where gt > 0).  Bin 0 (a pixel above no threshold) adds to no count
// and is never stored.  Pixels outside rowv x colv count nowhere: the TPU
// kernel's -1 sentinel.
//
// What bounds it on this card: bytes.  One read of each mask pixel, of the
// gt and of the validity masks, ~20 MB at the canvas shape (B 16, 2 masks,
// 400 x 400): ~6 us at 3.35 TB/s.  The design keeps everything else off that
// path, in ONE launch per call:
//   * a block (16 warps) takes a band of rows of one image with all M
//     masks, so the gt is read once for them (the TPU kernel keeps M inside
//     its program too).  The band's valid rows (rowv) are one run of 16-byte
//     items (4-byte ones when W % 4 != 0), cut into a contiguous range per
//     warp; rows that rowv marks invalid are skipped whole.  Each lane keeps
//     its next two steps in flight with cp.async into its warp's ring in
//     shared memory, so a warp never waits on one load at a time, and the
//     bands are planned so that every block of a call is resident at once;
//   * a step of a warp finds all its pixels' bins first, then its runs,
//     then does its shared atomics, so nothing waits behind an atomic;
//   * the histograms are shared by pairs of warps in shared memory, and a
//     warp adds once per run of neighbouring lanes in one bin (a shuffle
//     finds the runs' first lanes, a ballot their ends): the run's first
//     lane adds the run's length (cnt, low 16 bits) and its lanes inside
//     the gt (tp, high 16 bits) with one shared atomic.  Neighbouring pixels
//     of a smooth mask share a bin, so they do not serialise on one
//     address; pixels of a noisy one fall into different bins.  A histogram
//     copy counts fewer than 65536 pixels of a band (the host's band plan
//     keeps to that);
//   * each block writes its band's histograms, summed over its warps, to
//     part[b][band] (every bin, so nothing needs clearing) and takes a ticket
//     on the image's counter; the block that takes the last ticket sums the
//     image's bands (at most 32: the band plan), takes the suffix sums as
//     block-wide scans and writes tp and cnt as f32 (integer-exact below 2^24
//     pixels), then sets the counter back to 0 for the next call.  The
//     counts are integers, so the order in which blocks finish cannot change
//     them.
//
// Shape contract (checked by the Python wrapper): masks [B, M, H, W] f32,
// gt [B, H, W] f32, rowv [B, H] and colv [B, W] one byte each (bool or
// uint8, nonzero = valid), inv = f32(1 / n_thr), 1 <= n_thr <= 256, 1 <= M <=
// MAX_MASKS, contiguous tensors; scratch part [B, bands, 2 M, NB] and
// counters [B] 32-bit, the counters zero before the first call.  Calls that
// share one scratch run in stream order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512, WARPS = THREADS / 32;
constexpr int HISTS = WARPS / 2;       // histogram copies: one per pair of warps
constexpr int STAGES = 3;              // steps of a warp in flight (cp.async ring)
constexpr int NB = 256;                // stored bins: k = 1..n_thr at k - 1
constexpr int MAX_MASKS = 4;
constexpr unsigned FULL = 0xffffffffu;

// #{t < n_thr : p > thr[t]} for the table thr[t] = t * inv, inv = f32(1 /
// n_thr) (ops/fsweep.py's table, the same products here).  ceil(p * n_thr)
// is within one of it: the f32 roundings of p * n_thr and of the table move
// a value by far less than the thresholds' spacing, so one exact compare
// each way corrects it.  NaN -> 0.
__device__ __forceinline__ int exceed_count(float p, float inv, int n_thr) {
    const float e = p * (float)n_thr;
    int k = e > 0.f ? (int)fminf(ceilf(e), (float)n_thr) : 0;
    k += k < n_thr && p > __fmul_rn((float)k, inv);
    k -= k > 0 && !(p > __fmul_rn((float)(k - 1), inv));
    return k;
}

// A run of neighbouring lanes in one bin (lane i holds a pixel left of lane
// i + 1's) adds once, from its first lane: the run's lanes (cnt, low 16
// bits) and its lanes inside the gt (tp, high 16 bits).  Returns the packed
// increment for a run's first lane with k > 0, else 0.
__device__ __forceinline__ unsigned run_increment(int k, unsigned gt_bits, int lane) {
    const int k_left = __shfl_up_sync(FULL, k, 1);
    const bool head = lane == 0 || k != k_left;
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned later = heads & ((FULL << lane) << 1);
    const unsigned run = (FULL << lane) & ((later & (0u - later)) - 1u);
    return head && k > 0 ? __popc(run) + ((unsigned)__popc(run & gt_bits) << 16) : 0u;
}

// suffix sums s[t] = sum_{i >= t} v[i] over each half of the block (256
// threads, warps 0-7 and 8-15)
__device__ __forceinline__ unsigned half_suffix_sum(unsigned v, unsigned* wsum) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_down_sync(FULL, v, off);
        if (lane + off < 32) v += y;
    }
    if (lane == 0) wsum[warp] = v;                 // the warp's total
    __syncthreads();
    for (int w = warp + 1; w < (warp | 7) + 1; ++w) v += wsum[w];
    __syncthreads();                               // wsum is reused
    return v;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory of a block: the warps' cp.async rings [WARPS][STAGES][1 + M]
// [32 E] f32 (gt, then the masks), the histograms [HISTS][M][NB], the
// warps' valid-row lists [WARPS][band_rows]
template <int M, int E>
__host__ __device__ inline size_t ring_floats() { return (size_t)STAGES * (1 + M) * 32 * E; }

template <int M, int E>
inline size_t sweep_smem_bytes(int band_rows) {
    return ((size_t)WARPS * ring_floats<M, E>() + (size_t)HISTS * M * NB +
            (size_t)WARPS * band_rows) * 4;
}

// grid = (bands, B), THREADS threads; dynamic shared memory: sweep_smem_bytes
template <int M, int E>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ masks, const float* __restrict__ gt,
             const uint8_t* __restrict__ rowv, const uint8_t* __restrict__ colv,
             float inv, unsigned* __restrict__ part,
             unsigned* __restrict__ counters, float* __restrict__ tp,
             float* __restrict__ cnt, int H, int W, int n_thr, int band_rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last;
    __shared__ unsigned wsum[WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int band = blockIdx.x, bands = gridDim.x, b = blockIdx.y;
    const int r0 = band * band_rows, r1 = min(H, r0 + band_rows);
    float* ring = reinterpret_cast<float*>(smem) + warp * ring_floats<M, E>();
    unsigned* hist = reinterpret_cast<unsigned*>(smem) + WARPS * ring_floats<M, E>();
    unsigned* wh = hist + (warp >> 1) * M * NB;
    int* rows = reinterpret_cast<int*>(hist + HISTS * M * NB) + warp * band_rows;

    // each warp lists the band's valid rows itself (no wait on another warp)
    int n_rows = 0;
    for (int r = r0; r < r1; r += 32) {
        const bool ok = r + lane < r1 && rowv[(size_t)b * H + r + lane] != 0;
        const unsigned bal = __ballot_sync(FULL, ok);
        if (ok) rows[n_rows + __popc(bal & ((1u << lane) - 1u))] = r + lane;
        n_rows += __popc(bal);
    }
    __syncwarp();

    // the band's valid rows as one run of items (E pixels each), cut into
    // WARPS contiguous ranges; a step of a warp takes 32 consecutive items.
    // Each lane copies its own items into its warp's ring, STAGES - 1 steps
    // ahead of the one it counts, and reads back only what it copied.
    const int w_items = W / E;
    const int total = n_rows * w_items;
    const int per = (total + WARPS - 1) / WARPS;
    const int begin = warp * per, end = min(total, begin + per);
    const int steps = end > begin ? (end - begin + 31) / 32 : 0;
    const size_t plane = (size_t)H * W;
    const float* g_img = gt + (size_t)b * plane;
    const float* m_img = masks + (size_t)b * M * plane;
    const uint8_t* cv = colv + (size_t)b * W;
    int ri = (begin + lane) / w_items, ci = (begin + lane) - ri * w_items;   // copy cursor
    int c_count = ci;                                                         // count cursor
    auto prefetch = [&](int j) {
        if (j < steps && begin + lane + 32 * j < end) {
            const size_t o = (size_t)rows[ri] * W + E * ci;
            float* st = ring + (size_t)(j % STAGES) * (1 + M) * 32 * E + lane * E;
            cp_async(st, g_img + o, 4 * E);
#pragma unroll
            for (int m = 0; m < M; ++m) cp_async(st + (1 + m) * 32 * E, m_img + m * plane + o, 4 * E);
        }
        for (ci += 32; ci >= w_items; ci -= w_items) ++ri;
        cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) prefetch(j);

    for (int i = tid; i < HISTS * M * NB; i += THREADS) hist[i] = 0u;
    __syncthreads();

    for (int it = 0; it < steps; ++it) {
        prefetch(it + STAGES - 1);
        cp_async_wait<STAGES - 1>();                  // this lane's step `it` has landed
        const bool in = begin + lane + 32 * it < end;
        const float* st = ring + (size_t)(it % STAGES) * (1 + M) * 32 * E + lane * E;
        float g[E], p[M][E];
        bool v[E];
        if (E == 4) {
            const float4 gv = *reinterpret_cast<const float4*>(st);
            g[0] = gv.x; g[1] = gv.y; g[2] = gv.z; g[3] = gv.w;
#pragma unroll
            for (int m = 0; m < M; ++m) {
                const float4 pv = *reinterpret_cast<const float4*>(st + (1 + m) * 32 * E);
                p[m][0] = pv.x; p[m][1] = pv.y; p[m][2] = pv.z; p[m][3] = pv.w;
            }
            const uint32_t w = in ? __ldg(reinterpret_cast<const uint32_t*>(cv + E * c_count)) : 0u;
#pragma unroll
            for (int e = 0; e < E; ++e) v[e] = (w >> (8 * e)) & 0xffu;
        } else {
            g[0] = st[0];
#pragma unroll
            for (int m = 0; m < M; ++m) p[m][0] = st[(1 + m) * 32];
            v[0] = in && __ldg(cv + c_count) != 0;
        }
        for (c_count += 32; c_count >= w_items; c_count -= w_items) {}

        // the step's bins first, then its runs, then its shared atomics, so
        // that independent work is not ordered behind the atomics
        int k[M][E];
        unsigned gb[E], inc[M][E];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int e = 0; e < E; ++e) k[m][e] = v[e] ? exceed_count(p[m][e], inv, n_thr) : 0;
#pragma unroll
        for (int e = 0; e < E; ++e) gb[e] = __ballot_sync(FULL, v[e] && g[e] > 0.f);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int e = 0; e < E; ++e) inc[m][e] = run_increment(k[m][e], gb[e], lane);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int e = 0; e < E; ++e)
                if (inc[m][e]) atomicAdd(&wh[m * NB + k[m][e] - 1], inc[m][e]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // the band's histograms, summed over the warps: [2 M][NB], cnt then tp
    unsigned* mine = part + ((size_t)b * bands + band) * 2 * M * NB;
    for (int i = tid; i < M * NB; i += THREADS) {
        unsigned c = 0u, t = 0u;
#pragma unroll
        for (int h = 0; h < HISTS; ++h) {
            const unsigned x = hist[h * M * NB + i];
            c += x & 0xffffu;
            t += x >> 16;
        }
        const int m = i / NB, j = i - m * NB;
        mine[(2 * m) * NB + j] = c;
        mine[(2 * m + 1) * NB + j] = t;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&counters[b], 1u) == (unsigned)(bands - 1);
    __syncthreads();
    if (!last) return;

    // the image's last block: the first half of the threads sums the cnt
    // series of every band, the second half the tp series (bin t = tid % NB),
    // then suffix sums and the f32 counts
    __threadfence();
    const int half = tid / NB, t = tid % NB;
    const unsigned* img = part + (size_t)b * bands * 2 * M * NB + half * NB + t;
    unsigned acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0u;
#pragma unroll 8
    for (int q = 0; q < bands; ++q)
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] += __ldcg(&img[((size_t)q * 2 * M + 2 * m) * NB]);
    float* out = (half ? tp : cnt) + (size_t)b * M * n_thr;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const unsigned v = half_suffix_sum(acc[m], wsum);
        if (t < n_thr) out[m * n_thr + t] = (float)v;
    }
    if (tid == 0) counters[b] = 0u;
}

template <int M, int E>
cudaError_t launch(const void* masks, const void* gt, const void* rowv, const void* colv,
                   float inv, void* part, void* counters, void* tp, void* cnt, int batch,
                   int H, int W, int n_thr, int band_rows, cudaStream_t stream) {
    const size_t smem = sweep_smem_bytes<M, E>(band_rows);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            sweep_kernel<M, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((H + band_rows - 1) / band_rows, batch);
    sweep_kernel<M, E><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(masks), static_cast<const float*>(gt),
        static_cast<const uint8_t*>(rowv), static_cast<const uint8_t*>(colv),
        inv, static_cast<unsigned*>(part),
        static_cast<unsigned*>(counters), static_cast<float*>(tp), static_cast<float*>(cnt), H,
        W, n_thr, band_rows);
    return cudaGetLastError();
}

template <int E>
cudaError_t launch_m(int n_masks, const void* masks, const void* gt, const void* rowv,
                     const void* colv, float inv, void* part, void* counters, void* tp,
                     void* cnt, int batch, int H, int W, int n_thr, int band_rows,
                     cudaStream_t stream) {
#define SOD_SWEEP_M(MM)                                                                    \
    case MM:                                                                               \
        return launch<MM, E>(masks, gt, rowv, colv, inv, part, counters, tp, cnt, batch, H, \
                               W, n_thr, band_rows, stream);
    switch (n_masks) {
        SOD_SWEEP_M(1)
        SOD_SWEEP_M(2)
        SOD_SWEEP_M(3)
        SOD_SWEEP_M(4)
    }
#undef SOD_SWEEP_M
    return cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 on success).  One launch: grid (ceil(H /
// band_rows), batch).  vec: the rows may be read as float4 (W % 4 == 0 and
// masks, gt 16-byte aligned).  part: [batch, bands, 2 n_masks, 256] 32-bit
// (any contents), counters [batch] 32-bit (zero; left zero).
// tp, cnt: [batch, n_masks, n_thr] f32.
extern "C" int sod_fmax_tp_cnt(const void* masks, const void* gt, const void* rowv,
                               const void* colv, float inv, void* part, void* counters,
                               void* tp, void* cnt, int batch, int n_masks, int H, int W,
                               int n_thr, int band_rows, int vec, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (n_thr < 1 || n_thr > NB || n_masks < 1 || n_masks > MAX_MASKS || band_rows < 1 ||
        (size_t)band_rows * (W + 3) > (size_t)HISTS * 65000)
        return (int)cudaErrorInvalidValue;
    return (int)(vec ? launch_m<4>(n_masks, masks, gt, rowv, colv, inv, part, counters, tp,
                                      cnt, batch, H, W, n_thr, band_rows, stream)
                     : launch_m<1>(n_masks, masks, gt, rowv, colv, inv, part, counters, tp,
                                       cnt, batch, H, W, n_thr, band_rows, stream));
}
