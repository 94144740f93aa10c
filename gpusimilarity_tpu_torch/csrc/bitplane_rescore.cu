// Selection stage 3 of the bit-sliced ("bitplane") search, for Hopper
// (sm_90a): the exact scores of the 32 columns of each selected plane word.
//
// Replaces no Pallas kernel. The JAX package writes this stage as jnp ops
// (gpusimilarity_tpu/parallel/sharded.py, per_query_wordsel: the gather of
// the query's plane words at the selected words, their bits summed, the
// scores), which XLA fuses into a few device programs. Run eagerly, the same
// chain (ops/bitplane.wallace_popcount_planes, counters_to_counts, the
// popcount gather, ops/scan.similarity_from_counts) is about 225 tiny
// PyTorch launches a pass around a kernel 1 of 0.4 ms, and the host's time
// to issue them is most of the pass. This kernel is the whole stage in one
// launch.
//
// For query q and selected word w = w_sel[q][j] it writes, for every lane
// i < 32, column c = 32 * w + i:
//   * scores[q][32 * j + i]: the query's Tanimoto or Tversky score against
//     column c, -inf for c >= n_valid, with the bits of the plain version's
//     similarity_from_counts (phase1_epilogue.cuh's explicitly rounded
//     tanimoto_score / tversky_score);
//   * cols[q][32 * j + i] = c, the column order the lowest-index top-k after
//     it takes as its tie-break.
//
// What bounds it. The work is B x kw x P four-byte gathers (one plane word
// for each entry of the query's plane list at each selected word, from
// planes that lie far apart) and the 32 popcounts of each word: a few
// thousand loads at B = 1 and k = 20, a few hundred thousand at B = 32 and
// k = 128. Both are latency, not bandwidth: at B = 32, k = 128 and 64 planes
// the bytes are 1 MB, 0.3 us at 3.35 TB/s. So one launch, and as many loads
// in flight as the shape gives.
//
// Design. One warp per (query, selected word); lane i owns column i. The
// warp walks the plane list 32 entries at a time: lane l loads the plane
// word of entry p0 + l (an index outside [0, n_planes) reads nothing), the
// warp's ballot names the lanes that hold a non-zero word (the sentinel
// plane, padding and empty words add nothing to any count, so skipping them
// changes no count), and each such word is broadcast by a shuffle and adds
// its bit i to lane i's count. Integer counts are exact in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase1_epilogue.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;
// the longest plane list taken, as kernel 1 (KERNEL_MAX_PLANES)
constexpr int kMaxPlanes = 4095;

template <bool kTversky>
__global__ void __launch_bounds__(kThreads) bitplane_rescore_kernel(
    const uint32_t* __restrict__ planes, const int16_t* __restrict__ pops,
    const int32_t* __restrict__ plane_idx, const int32_t* __restrict__ qpops,
    const long long* __restrict__ w_sel, float* __restrict__ scores,
    long long* __restrict__ cols, long long m, int n_planes, int p, int kw,
    long long pairs, long long n_valid, float alpha, float beta) {
    const long long pair =
        (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (pair >= pairs) return;  // the whole warp leaves together
    const int lane = threadIdx.x & 31;
    const long long q = pair / kw;
    const long long w = w_sel[pair];
    // a word outside the planes reads nothing and scores -inf
    const bool word_ok = w >= 0 && w < m;
    const int32_t* list = plane_idx + q * p;
    unsigned count = 0;
    if (word_ok) {
        for (int p0 = 0; p0 < p; p0 += 32) {
            uint32_t word = 0;
            if (p0 + lane < p) {
                const int plane = list[p0 + lane];
                if ((unsigned)plane < (unsigned)n_planes) {
                    word = __ldg(planes + (long long)plane * m + w);
                }
            }
            unsigned live = __ballot_sync(kFullMask, word != 0u);
            while (live) {  // uniform: every lane holds the same ballot
                const int src = __ffs(live) - 1;
                live &= live - 1;
                count += (__shfl_sync(kFullMask, word, src) >> lane) & 1u;
            }
        }
    }
    const long long col = 32 * w + lane;
    float s = -INFINITY;
    if (word_ok && col < n_valid) {
        const float cf = (float)count;
        const float qf = (float)qpops[q];
        const float pf = (float)pops[col];
        s = kTversky ? gpusim::tversky_score(cf, qf, pf, alpha, beta)
                     : gpusim::tanimoto_score(cf, qf, pf);
    }
    scores[32 * pair + lane] = s;
    cols[32 * pair + lane] = col;
}

}  // namespace

// Launches stage 3 on `stream` for b queries of p plane indices (int32,
// b x p) and kw selected words each (int64, b x kw), over m plane words of
// n_planes planes (int32, n_planes x m; the last one zero) and their 32 * m
// int16 popcounts; writes scores (f32) and cols (int64), b x 32 * kw each.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gpusim_bitplane_rescore(
    const void* planes, const void* pops, const void* plane_idx,
    const void* qpops, const void* w_sel, void* scores, void* cols,
    long long m, int n_planes, int b, int p, int kw, long long n_valid,
    int tversky, float alpha, float beta, void* stream) {
    if (m <= 0 || n_planes < 1 || b <= 0 || p <= 0 || p > kMaxPlanes ||
        kw <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const long long pairs = (long long)b * kw;
    const long long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    auto* kernel = tversky ? bitplane_rescore_kernel<true>
                           : bitplane_rescore_kernel<false>;
    // launched on the thread's current device: the Python wrapper makes
    // that the tensors' device
    kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<const int16_t*>(pops),
        static_cast<const int32_t*>(plane_idx),
        static_cast<const int32_t*>(qpops),
        static_cast<const long long*>(w_sel), static_cast<float*>(scores),
        static_cast<long long*>(cols), m, n_planes, p, kw, pairs, n_valid,
        alpha, beta);
    return (int)cudaGetLastError();
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
