// Phase 1 of the bit-sliced ("bitplane") similarity scan, for Hopper (sm_90a).
//
// Replaces gpusimilarity_tpu/ops/pallas_bitplane.py::_batched_kernel. For a
// batch of B queries, each given as its P set-bit plane indices (padded with
// the sentinel index bitcount, which selects the all-zero last plane), it
// computes for every 32-column word w of the library
//   * colmax[q][w]: the best Tanimoto or Tversky score over the word's 32
//     columns (-inf for columns >= n_valid), and
//   * counts[q]: the number of valid columns scoring >= cutoffs[q].
// The block maxima the selection layer needs are reduced from colmax outside
// the kernel, as the JAX wrapper does.
//
// What bounds it: bytes. Per query and word it reads P plane words (4 B
// each) and the 32 column popcounts (64 B of int16), and writes one float:
// about P*4 + 68 bytes per 32 columns, against a few hundred integer ops.
// The design reads each plane word once per query: one thread owns one word
// of one query, neighbouring threads own neighbouring words, so every plane
// read and the popcount read are coalesced. The query's plane indices sit in
// shared memory. Intersection counts are kept bit-sliced in NB registers
// (ripple-carry adds of each plane word), so no per-column counter array
// exists. Grid blocks run in any order, so the >=cutoff count is reduced per
// block (warp shuffles) and added with one integer atomic per block: integer
// addition is order-free, the result deterministic.
//
// Bit-exactness with the plain PyTorch version (ops/bitplane_phase1.py): all
// float arithmetic uses explicitly rounded intrinsics (no FMA contraction,
// no fast-math divide), in the same operation order as the plain version.
// Build without --use_fast_math.
//
// Not carried over from the TPU kernel: manual DMA double-buffering, the
// shared DMA semaphore, the (8, 128)-tile sub-row interleave and pops3
// layout, packed byte/16-bit count fields, and the integer running-max
// branch for cutoff <= 0 (here every column is divided; the result is the
// same bits).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

union PopWord {
    int4 vec[4];
    int16_t pop[32];
};

template <int NB, bool TVERSKY>
__global__ void __launch_bounds__(kThreads) bitplane_phase1_kernel(
    const uint32_t* __restrict__ planes,     // (bitcount + 1, m), last plane zero
    const int16_t* __restrict__ pops,        // (32 * m,) column popcounts
    const int32_t* __restrict__ plane_idx,   // (b, p) plane lists
    const int32_t* __restrict__ qpops,       // (b,) query popcounts
    const float* __restrict__ cutoffs,       // (b,)
    const float* __restrict__ alpha_beta,    // (2,) Tversky weights
    float* __restrict__ colmax,              // (b, m) out
    int32_t* __restrict__ counts,            // (b,) out, zeroed by the caller
    long long m, int p, long long n_valid) {
    extern __shared__ int32_t s_idx[];
    __shared__ int32_t s_warp[kThreads / 32];

    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < p; i += kThreads) {
        s_idx[i] = plane_idx[(long long)q * p + i];
    }
    __syncthreads();

    const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
    int count = 0;
    if (w < m) {
        // bit-sliced counters: lane-bit b of c[j] is bit j of column b's count
        uint32_t c[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) c[j] = 0u;
#pragma unroll 4
        for (int i = 0; i < p; ++i) {
            uint32_t carry = __ldg(planes + (size_t)s_idx[i] * (size_t)m + w);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const uint32_t t = c[j] & carry;
                c[j] ^= carry;
                carry = t;
            }
        }

        PopWord pw;
        const int4* pv = reinterpret_cast<const int4*>(pops + 32 * w);
#pragma unroll
        for (int v = 0; v < 4; ++v) pw.vec[v] = __ldg(pv + v);

        const float qpop = (float)qpops[q];
        const float cutoff = cutoffs[q];
        const float alpha = alpha_beta[0];
        const float beta = alpha_beta[1];
        const long long col0 = 32 * w;
        float best = -INFINITY;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
            int cnt = 0;
#pragma unroll
            for (int j = 0; j < NB; ++j) cnt |= (int)((c[j] >> b) & 1u) << j;
            const float cf = (float)cnt;
            const float pop = (float)pw.pop[b];
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
            if (col0 + b >= n_valid) s = -INFINITY;
            best = fmaxf(best, s);
            count += s >= cutoff ? 1 : 0;
        }
        colmax[(size_t)q * (size_t)m + w] = best;
    }

    // block-wide count: warp shuffles, then one atomic per block
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        count += __shfl_down_sync(0xffffffffu, count, off);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = count;
    __syncthreads();
    if (warp == 0) {
        count = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            count += __shfl_down_sync(0xffffffffu, count, off);
        }
        if (lane == 0 && count != 0) atomicAdd(counts + q, count);
    }
}

template <int NB>
cudaError_t launch(const void* planes, const void* pops, const void* plane_idx,
                   const void* qpops, const void* cutoffs,
                   const void* alpha_beta, void* colmax, void* counts,
                   long long m, int b, int p, long long n_valid, bool tversky,
                   cudaStream_t stream) {
    const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)b);
    const size_t smem = (size_t)p * sizeof(int32_t);
    auto* kernel = tversky ? bitplane_phase1_kernel<NB, true>
                           : bitplane_phase1_kernel<NB, false>;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(planes), static_cast<const int16_t*>(pops),
        static_cast<const int32_t*>(plane_idx),
        static_cast<const int32_t*>(qpops), static_cast<const float*>(cutoffs),
        static_cast<const float*>(alpha_beta), static_cast<float*>(colmax),
        static_cast<int32_t*>(counts), m, p, n_valid);
    return cudaGetLastError();
}

}  // namespace

// Launches phase 1 on `stream` for b queries of p plane indices over m plane
// words; returns the cudaError_t of the launch (0 on success). p may be up to
// 4095 (counts need at most 12 bits).
extern "C" int gpusim_bitplane_phase1(
    const void* planes, const void* pops, const void* plane_idx,
    const void* qpops, const void* cutoffs, const void* alpha_beta,
    void* colmax, void* counts, long long m, int b, int p, long long n_valid,
    int tversky, void* stream) {
    if (m <= 0 || b <= 0 || b > 65535 || p <= 0 ||
        (m + kThreads - 1) / kThreads > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    int nb = 0;
    while ((1 << nb) <= p) ++nb;  // a count reaches p: bit_length(p) bits
    if (nb < 5) nb = 5;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool tv = tversky != 0;
#define GPUSIM_CASE(NB)                                                      \
    case NB:                                                                 \
        return (int)launch<NB>(planes, pops, plane_idx, qpops, cutoffs,      \
                               alpha_beta, colmax, counts, m, b, p, n_valid, \
                               tv, s);
    switch (nb) {
        GPUSIM_CASE(5)
        GPUSIM_CASE(6)
        GPUSIM_CASE(7)
        GPUSIM_CASE(8)
        GPUSIM_CASE(9)
        GPUSIM_CASE(10)
        GPUSIM_CASE(11)
        GPUSIM_CASE(12)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef GPUSIM_CASE
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
