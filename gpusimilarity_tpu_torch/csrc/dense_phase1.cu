// Phase 1 of the dense (word-planar) similarity scan, for Hopper (sm_90a).
//
// Replaces gpusimilarity_tpu/ops/pallas_scan.py::_phase1_kernel. The store
// holds each library row's wf packed words planar, words[i][col] for word i,
// column stride 1 and row stride ld. For a batch of b queries it computes
//   * block_max[q][j]: the best Tanimoto or Tversky score over columns
//     [j*block, (j+1)*block) (-inf for columns >= n_valid), and
//   * counts[q]: the number of valid columns scoring >= cutoffs[q].
// In popless mode (pops == NULL) each column's popcount is recomputed from
// the words the thread already holds.
//
// Selection block width. The engine scans with block = 256 columns, the
// TPU kernel's 32768/128. At 1.02B rows, B = 32 and k_fetch = 2048 that is
// 510 MB of block maxima and 524,288 columns rescored per query in phase 2;
// a 2048-column block would cut the maxima to 64 MB but send 4.2M columns
// per query through the plain-tensor rescore, 8x the phase-2 bytes and
// ops, which at B = 32 would cost about as much as the scan itself. The
// width is an argument (a power of two up to the 256-thread block), so the
// tests can use the JAX tests' block of 4.
//
// What bounds it. Per column it reads wf words (4 B each) and, unless
// popless, a 2-byte popcount: 34 B per row at wf = 8. At b = 1 that is
// about 1 popc per 4.25 bytes, so bytes bound it. Every query re-uses the
// words in registers, so at b = 32 it is bound by integer instruction
// throughput: wf ANDs, popcs and adds, a correctly rounded divide, a ballot
// and a warp max per query and column.
//
// Design: one thread per library column. A thread loads its column's wf
// words once (neighbouring threads read neighbouring words of one plane
// row, so every load is coalesced) and loops over the queries, whose words,
// popcounts and cutoffs sit in shared memory. Block maxima come from warp
// shuffles inside a warp and, for blocks wider than a warp, a per-warp
// maximum in shared memory reduced after one barrier. The >= cutoff count
// is a warp ballot, summed per thread block in shared memory and added to
// the 64-bit total with one integer atomic per query and block; integer
// addition is order-free, so the counts are deterministic.
//
// Bit-exactness with the plain PyTorch version (ops/dense_phase1.py): every
// float op is an explicitly rounded intrinsic (no FMA contraction, no
// fast-math divide), in the plain version's operation order. Build without
// --use_fast_math.
//
// Not carried over from the TPU kernel: the sequential grid's carried count
// scratch (GPU blocks run in any order), the 128-lane count accumulator,
// the VMEM chunking and the Mosaic int16 -> int32 cast hop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MAXW, bool TVERSKY, bool POPLESS>
__global__ void __launch_bounds__(kThreads) dense_phase1_kernel(
    const uint32_t* __restrict__ words,    // (wf, ld) planar, n columns read
    const int16_t* __restrict__ pops,      // (n,) column popcounts, or NULL
    const uint32_t* __restrict__ queries,  // (b, wf)
    const int32_t* __restrict__ qpops,     // (b,)
    const float* __restrict__ cutoffs,     // (b,)
    const float* __restrict__ alpha_beta,  // (2,) Tversky weights
    float* __restrict__ block_max,         // (b, n / block) out
    unsigned long long* __restrict__ counts,  // (b,) out, zeroed by the caller
    long long n, long long ld, int wf, int b, int block, long long n_valid) {
    extern __shared__ uint32_t smem[];
    uint32_t* s_q = smem;                                  // b * wf
    float* s_qpop = reinterpret_cast<float*>(s_q + b * wf);  // b
    float* s_cut = s_qpop + b;                             // b
    int* s_cnt = reinterpret_cast<int*>(s_cut + b);         // b
    float* s_wmax = reinterpret_cast<float*>(s_cnt + b);   // b * kWarps

    for (int i = threadIdx.x; i < b * wf; i += kThreads) s_q[i] = queries[i];
    for (int i = threadIdx.x; i < b; i += kThreads) {
        s_qpop[i] = (float)qpops[i];
        s_cut[i] = cutoffs[i];
        s_cnt[i] = 0;
    }
    __syncthreads();

    const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool in_array = col < n;
    const bool valid = in_array && col < n_valid;
    uint32_t w[MAXW];
    int dpop = 0;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
        w[i] = (i < wf && in_array) ? __ldg(words + (size_t)i * (size_t)ld + col)
                                    : 0u;
        if (POPLESS) dpop += __popc(w[i]);
    }
    if (!POPLESS && in_array) dpop = __ldg(pops + col);
    const float pop = (float)dpop;
    const float alpha = alpha_beta[0];
    const float beta = alpha_beta[1];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int group = block < 32 ? block : 32;  // lanes reduced by shuffles
    const long long n_blocks = n / block;

    for (int q = 0; q < b; ++q) {
        const uint32_t* qw = s_q + q * wf;
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < MAXW; ++i) {
            if (i < wf) cnt += __popc(w[i] & qw[i]);
        }
        const float cf = (float)cnt;
        const float qpop = s_qpop[q];
        float denom;
        float s;
        if (TVERSKY) {
            denom = __fadd_rn(
                __fadd_rn(__fmul_rn(alpha, __fsub_rn(qpop, cf)),
                          __fmul_rn(beta, __fsub_rn(pop, cf))),
                cf);
            s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1e-30f)) : 0.f;
        } else {
            denom = __fsub_rn(__fadd_rn(qpop, pop), cf);
            s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1.f)) : 0.f;
        }
        if (cf == denom && denom > 0.f) s = 1.f;  // self-match pin
        if (!valid) s = -INFINITY;

        const unsigned hits = __ballot_sync(0xffffffffu, s >= s_cut[q]);
        if (lane == 0 && hits) atomicAdd(s_cnt + q, __popc(hits));

        for (int off = 1; off < group; off <<= 1) {
            s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
        }
        if (block <= 32) {
            if (in_array && (lane & (block - 1)) == 0) {
                block_max[(size_t)q * (size_t)n_blocks + col / block] = s;
            }
        } else if (lane == 0) {
            s_wmax[q * kWarps + warp] = s;
        }
    }
    __syncthreads();

    if (block > 32) {
        // per-warp maxima -> one maximum per selection block in this tile
        const int warps_per_block = block / 32;
        const int groups = kThreads / block;
        for (int i = threadIdx.x; i < b * groups; i += kThreads) {
            const int q = i / groups;
            const int g = i % groups;
            float m = -INFINITY;
            for (int k = 0; k < warps_per_block; ++k) {
                m = fmaxf(m, s_wmax[q * kWarps + g * warps_per_block + k]);
            }
            const long long j = (long long)blockIdx.x * groups + g;
            if (j < n_blocks) block_max[(size_t)q * (size_t)n_blocks + j] = m;
        }
    }
    for (int q = threadIdx.x; q < b; q += kThreads) {
        if (s_cnt[q]) atomicAdd(counts + q, (unsigned long long)s_cnt[q]);
    }
}

template <int MAXW>
cudaError_t launch(const void* words, const void* pops, const void* queries,
                   const void* qpops, const void* cutoffs,
                   const void* alpha_beta, void* block_max, void* counts,
                   long long n, long long ld, int wf, int b, int block,
                   long long n_valid, bool tversky, cudaStream_t stream) {
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    const size_t smem =
        (size_t)b * wf * sizeof(uint32_t) + (size_t)b * 3 * sizeof(float) +
        (size_t)b * kWarps * sizeof(float);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    const bool popless = pops == nullptr;
    void (*kernel)(const uint32_t*, const int16_t*, const uint32_t*,
                   const int32_t*, const float*, const float*, float*,
                   unsigned long long*, long long, long long, int, int, int,
                   long long);
    if (tversky) {
        kernel = popless ? dense_phase1_kernel<MAXW, true, true>
                         : dense_phase1_kernel<MAXW, true, false>;
    } else {
        kernel = popless ? dense_phase1_kernel<MAXW, false, true>
                         : dense_phase1_kernel<MAXW, false, false>;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(words), static_cast<const int16_t*>(pops),
        static_cast<const uint32_t*>(queries),
        static_cast<const int32_t*>(qpops), static_cast<const float*>(cutoffs),
        static_cast<const float*>(alpha_beta), static_cast<float*>(block_max),
        static_cast<unsigned long long*>(counts), n, ld, wf, b, block, n_valid);
    return cudaGetLastError();
}

}  // namespace

// Launches phase 1 on `stream` for b queries of wf words over the first n
// columns of a planar store with row stride ld; pops may be NULL (popless).
// block must be a power of two up to 256 that divides n. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gpusim_dense_phase1(
    const void* words, const void* pops, const void* queries,
    const void* qpops, const void* cutoffs, const void* alpha_beta,
    void* block_max, void* counts, long long n, long long ld, int wf, int b,
    int block, long long n_valid, int tversky, void* stream) {
    if (n <= 0 || ld < n || wf <= 0 || wf > 64 || b <= 0 || block <= 0 ||
        block > kThreads || (block & (block - 1)) || n % block ||
        (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool tv = tversky != 0;
#define GPUSIM_CASE(MAXW)                                                    \
    return (int)launch<MAXW>(words, pops, queries, qpops, cutoffs,           \
                             alpha_beta, block_max, counts, n, ld, wf, b,    \
                             block, n_valid, tv, s);
    if (wf <= 8) {
        GPUSIM_CASE(8)
    } else if (wf <= 16) {
        GPUSIM_CASE(16)
    } else if (wf <= 32) {
        GPUSIM_CASE(32)
    } else {
        GPUSIM_CASE(64)
    }
#undef GPUSIM_CASE
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
