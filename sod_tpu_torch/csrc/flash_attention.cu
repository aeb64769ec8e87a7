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
// What bounds it on this card: the Pallas backward keeps four f32 [N, N]
// slabs of one (image, head) in VMEM; at N = 785 (896 padded) that is 3.2 MB
// each against 227 KB of shared memory per block, so nothing [N, N] stays on
// chip.  Per (image, head) the work is ~10 N^2 d flops against ~7 N d bf16
// of traffic: compute bound on the tensor cores.  The design tiles every
// [N, N] product into 64 x 64 tiles recomputed from q, k and the forward's
// per-row max and sum, and needs no atomics:
//   forward  one block per (64 q rows, image x head), the two-pass softmax
//            of attention.cuh (shared with K1), also writing each row's max
//            and sum (f32 [B, H, N]) as the backward's residuals;
//   dq       one block per (64 q rows, image x head).  Pass 1 over the key
//            tiles recomputes p and dp and sums D_i = sum_j p_ij dp_ij in f32
//            (the Pallas kernel's sum(dp * p); rowsum(do * o) would differ,
//            o having been rounded to bf16).  Pass 2 accumulates
//            dq += bf16(ds).k and writes D;
//   dk, dv   one block per (64 key rows, image x head), looping over the q
//            tiles.  It computes the transposed tiles s^T = k.q^T and
//            dp^T = v.do^T directly, so p^T and ds^T land row-major in
//            shared memory and feed dv += bf16(p^T).do and
//            dk += bf16(ds^T).q without transposed fragment loads.
// Rows at or beyond N read as zeros (so padded q rows carry zero do) and are
// never written; padded keys get -1e30, p = 0.  Matmuls are nvcuda::wmma
// 16x16x16 bf16 with f32 accumulators; cp.async, TMA and wgmma are later
// work.  Shape contract (checked by the Python wrapper): contiguous 16-byte
// aligned tensors, head dim 32, 64 or 128, any N >= 1.

#include "attention.cuh"

using namespace nvcuda;

namespace {

using namespace sod;

template <int HD>
__global__ void __launch_bounds__(THREADS)
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

template <int HD>
constexpr size_t dq_smem_bytes() {
    return (size_t)4 * 64 * (HD + APAD) * sizeof(bf16)      // Q, dO, K, V tiles
           + (size_t)2 * 64 * (AK + CPAD) * sizeof(float)   // S, dP per warp
           + (size_t)64 * (AK + APAD) * sizeof(bf16)        // bf16(ds) per warp
           + (size_t)64 * (HD + CPAD) * sizeof(float);      // dq staging
}

// dq and D for 64 query rows of one (image, head)
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    float* __restrict__ dsum, bf16* __restrict__ dq, int N, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int ldq = HD + APAD, lds = AK + CPAD, ldp = AK + APAD, ldo = HD + CPAD;
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* dOs = Qs + AQ * ldq;
    bf16* Ks = dOs + AQ * ldq;
    bf16* Vs = Ks + AK * ldq;
    float* Ss = reinterpret_cast<float*>(Vs + AK * ldq);
    float* DPs = Ss + 4 * 16 * lds;
    bf16* DSs = reinterpret_cast<bf16*>(DPs + 4 * 16 * lds);
    float* Os = reinterpret_cast<float*>(DSs + 4 * 16 * ldp);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * AQ, bh = blockIdx.y;
    const size_t off = (size_t)bh * N * HD;
    float* Sw = Ss + warp * 16 * lds;
    float* DPw = DPs + warp * 16 * lds;
    bf16* DSw = DSs + warp * 16 * ldp;
    float* Ow = Os + warp * 16 * ldo;
    const int r = lane >> 1, half = (lane & 1) * 32;
    const int row = q0 + warp * 16 + r;
    const bool row_ok = row < N;
    const float m_i = row_ok ? m[(size_t)bh * N + row] : 0.f;
    const float l_i = row_ok ? l[(size_t)bh * N + row] : 1.f;

    load_rows<HD>(Qs, ldq, q + off, HD, q0, N, AQ);
    load_rows<HD>(dOs, ldq, dout + off, HD, q0, N, AQ);

    // this warp's 16 rows against one key tile: S = q.k^T -> Sw, dP = do.v^T -> DPw
    auto tiles = [&]() {
#pragma unroll
        for (int j = 0; j < AK / 16; ++j) {
            FragC s, dp;
            wmma::fill_fragment(s, 0.f);
            wmma::fill_fragment(dp, 0.f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                FragA fa;
                FragBt fb;
                wmma::load_matrix_sync(fa, Qs + warp * 16 * ldq + kk, ldq);
                wmma::load_matrix_sync(fb, Ks + j * 16 * ldq + kk, ldq);
                wmma::mma_sync(s, fa, fb, s);
                wmma::load_matrix_sync(fa, dOs + warp * 16 * ldq + kk, ldq);
                wmma::load_matrix_sync(fb, Vs + j * 16 * ldq + kk, ldq);
                wmma::mma_sync(dp, fa, fb, dp);
            }
            wmma::store_matrix_sync(Sw + j * 16, s, lds, wmma::mem_row_major);
            wmma::store_matrix_sync(DPw + j * 16, dp, lds, wmma::mem_row_major);
        }
        __syncwarp();
    };
    // the forward's normalised p (f32), recomputed from its row max and sum
    auto prob = [&](int k0, int col) {
        const float s = k0 + col < N ? Sw[r * lds + col] * scale : -1e30f;
        return row_ok ? expf(s - m_i) / l_i : 0.f;
    };

    // pass 1: D_i = sum_j p_ij dp_ij
    float d_i = 0.f;
    for (int k0 = 0; k0 < N; k0 += AK) {
        load_rows<HD>(Ks, ldq, k + off, HD, k0, N, AK);
        load_rows<HD>(Vs, ldq, v + off, HD, k0, N, AK);
        __syncthreads();
        tiles();
        for (int c = 0; c < 32; ++c) d_i += DPw[r * lds + half + c] * prob(k0, half + c);
        __syncthreads();
    }
    d_i += __shfl_xor_sync(0xffffffffu, d_i, 1);

    // pass 2: dq += bf16(p * (dp - D) * scale) . k
    FragC acc[HD / 16];
#pragma unroll
    for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int k0 = 0; k0 < N; k0 += AK) {
        load_rows<HD>(Ks, ldq, k + off, HD, k0, N, AK);
        load_rows<HD>(Vs, ldq, v + off, HD, k0, N, AK);
        __syncthreads();
        tiles();
        for (int c = 0; c < 32; ++c) {
            const float p = prob(k0, half + c);
            DSw[r * ldp + half + c] = __float2bfloat16(p * (DPw[r * lds + half + c] - d_i) * scale);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < AK; kk += 16) {
            FragA fds;
            wmma::load_matrix_sync(fds, DSw + kk, ldp);
#pragma unroll
            for (int f = 0; f < HD / 16; ++f) {
                FragB fk;
                wmma::load_matrix_sync(fk, Ks + kk * ldq + f * 16, ldq);
                wmma::mma_sync(acc[f], fds, fk, acc[f]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int f = 0; f < HD / 16; ++f)
        wmma::store_matrix_sync(Ow + f * 16, acc[f], ldo, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
        const int rr = i / HD, c = i % HD;
        if (q0 + warp * 16 + rr < N)
            dq[off + (size_t)(q0 + warp * 16 + rr) * HD + c] = __float2bfloat16(Ow[rr * ldo + c]);
    }
    if ((lane & 1) == 0 && row_ok) dsum[(size_t)bh * N + row] = d_i;
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
    return (size_t)4 * 64 * (HD + APAD) * sizeof(bf16)      // K, V, Q, dO tiles
           + (size_t)3 * 64 * sizeof(float)                 // m, l, D of the q tile
           + (size_t)2 * 64 * (AQ + CPAD) * sizeof(float)   // S^T, dP^T per warp
           + (size_t)2 * 64 * (AQ + APAD) * sizeof(bf16)    // bf16 p^T, ds^T per warp
           + (size_t)64 * (HD + CPAD) * sizeof(float);      // dk / dv staging
}

// dk and dv for 64 key rows of one (image, head)
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int N, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int ldq = HD + APAD, lds = AQ + CPAD, ldp = AQ + APAD, ldo = HD + CPAD;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + AK * ldq;
    bf16* Qs = Vs + AK * ldq;
    bf16* dOs = Qs + AQ * ldq;
    float* Ms = reinterpret_cast<float*>(dOs + AQ * ldq);
    float* Ls = Ms + AQ;
    float* Ds = Ls + AQ;
    float* Ss = Ds + AQ;
    float* DPs = Ss + 4 * 16 * lds;
    bf16* Ps = reinterpret_cast<bf16*>(DPs + 4 * 16 * lds);
    bf16* DSs = Ps + 4 * 16 * ldp;
    float* Os = reinterpret_cast<float*>(DSs + 4 * 16 * ldp);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int k0 = blockIdx.x * AK, bh = blockIdx.y;
    const size_t off = (size_t)bh * N * HD, soff = (size_t)bh * N;
    float* Sw = Ss + warp * 16 * lds;
    float* DPw = DPs + warp * 16 * lds;
    bf16* Pw = Ps + warp * 16 * ldp;
    bf16* DSw = DSs + warp * 16 * ldp;
    float* Ow = Os + warp * 16 * ldo;
    const int r = lane >> 1, half = (lane & 1) * 32;
    const bool key_ok = k0 + warp * 16 + r < N;

    load_rows<HD>(Ks, ldq, k + off, HD, k0, N, AK);
    load_rows<HD>(Vs, ldq, v + off, HD, k0, N, AK);

    FragC acc_k[HD / 16], acc_v[HD / 16];
#pragma unroll
    for (int f = 0; f < HD / 16; ++f) {
        wmma::fill_fragment(acc_k[f], 0.f);
        wmma::fill_fragment(acc_v[f], 0.f);
    }

    for (int q0 = 0; q0 < N; q0 += AQ) {
        load_rows<HD>(Qs, ldq, q + off, HD, q0, N, AQ);
        load_rows<HD>(dOs, ldq, dout + off, HD, q0, N, AQ);
        for (int i = threadIdx.x; i < AQ; i += THREADS) {
            const bool ok = q0 + i < N;
            Ms[i] = ok ? m[soff + q0 + i] : 0.f;
            Ls[i] = ok ? l[soff + q0 + i] : 1.f;
            Ds[i] = ok ? dsum[soff + q0 + i] : 0.f;
        }
        __syncthreads();

        // this warp's 16 keys against the q tile: S^T = k.q^T, dP^T = v.do^T
#pragma unroll
        for (int j = 0; j < AQ / 16; ++j) {
            FragC s, dp;
            wmma::fill_fragment(s, 0.f);
            wmma::fill_fragment(dp, 0.f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                FragA fa;
                FragBt fb;
                wmma::load_matrix_sync(fa, Ks + warp * 16 * ldq + kk, ldq);
                wmma::load_matrix_sync(fb, Qs + j * 16 * ldq + kk, ldq);
                wmma::mma_sync(s, fa, fb, s);
                wmma::load_matrix_sync(fa, Vs + warp * 16 * ldq + kk, ldq);
                wmma::load_matrix_sync(fb, dOs + j * 16 * ldq + kk, ldq);
                wmma::mma_sync(dp, fa, fb, dp);
            }
            wmma::store_matrix_sync(Sw + j * 16, s, lds, wmma::mem_row_major);
            wmma::store_matrix_sync(DPw + j * 16, dp, lds, wmma::mem_row_major);
        }
        __syncwarp();
        for (int c = 0; c < 32; ++c) {
            const int qi = half + c;
            const float s = key_ok ? Sw[r * lds + qi] * scale : -1e30f;
            const float p = q0 + qi < N ? expf(s - Ms[qi]) / Ls[qi] : 0.f;
            Pw[r * ldp + qi] = __float2bfloat16(p);
            DSw[r * ldp + qi] = __float2bfloat16(p * (DPw[r * lds + qi] - Ds[qi]) * scale);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < AQ; kk += 16) {
            FragA fp, fds;
            wmma::load_matrix_sync(fp, Pw + kk, ldp);
            wmma::load_matrix_sync(fds, DSw + kk, ldp);
#pragma unroll
            for (int f = 0; f < HD / 16; ++f) {
                FragB fb;
                wmma::load_matrix_sync(fb, dOs + kk * ldq + f * 16, ldq);
                wmma::mma_sync(acc_v[f], fp, fb, acc_v[f]);
                wmma::load_matrix_sync(fb, Qs + kk * ldq + f * 16, ldq);
                wmma::mma_sync(acc_k[f], fds, fb, acc_k[f]);
            }
        }
        __syncthreads();
    }

    auto write = [&](FragC* acc, bf16* out) {
#pragma unroll
        for (int f = 0; f < HD / 16; ++f)
            wmma::store_matrix_sync(Ow + f * 16, acc[f], ldo, wmma::mem_row_major);
        __syncwarp();
        for (int i = lane; i < 16 * HD; i += 32) {
            const int rr = i / HD, c = i % HD;
            if (k0 + warp * 16 + rr < N)
                out[off + (size_t)(k0 + warp * 16 + rr) * HD + c] = __float2bfloat16(Ow[rr * ldo + c]);
        }
        __syncwarp();
    };
    write(acc_v, dv);
    write(acc_k, dk);
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
