// Score arithmetic shared by the phase-1 kernels (dense_phase1.cu,
// bitplane_phase1.cu, mxu_phase1.cu), for Hopper (sm_90a).
//
// The plain PyTorch versions divide once per (query, column):
//   Tanimoto  s = c / max(qpop + pop - c, 1)   (0 when the denominator is 0)
//   Tversky   s = c / (alpha*(qpop - c) + beta*(pop - c) + c)
// with c == denominator > 0 pinned to 1.0, one rounded float op at a time.
// Every float op here is an explicitly rounded intrinsic in that order (no
// FMA contraction, no fast-math divide), so a score has the plain version's
// bits. Build without --use_fast_math.
//
// For Tanimoto the kernels avoid the divide per column, by two facts about a
// correctly rounded divide (it is monotone):
//   * the maximum of fl(c_i / d_i) over a block is fl of the largest
//     rational c_i / d_i, which integer cross-multiplication finds exactly
//     (c <= 2048, d <= 4096: products below 2^23). RationalMax keeps the
//     incumbent (num, den); one divide per block turns it into the score;
//   * for a fixed query and column popcount, fl(c / (qpop + pop - c)) is
//     non-decreasing in c, so "score >= cutoff" is "c >= cmin[pop]" for a
//     table built once per launch with the very divide above
//     (build_cmin_table): the counts are the plain version's by construction.
//   * the score depends on (c, pop) only through the rational c / d with
//     d = max(qpop, 1) + pop - c, so among the fractions with denominators up
//     to the largest d there is a smallest one, P / Q, whose rounded value
//     reaches the cutoff, and "score >= cutoff" is "c * Q >= P * d" for every
//     pop at once (tanimoto_threshold): one pair of integers per query where
//     the table needs bits + 1 entries.
// All three rest on c <= min(qpop, pop), which holds whenever qpop and pop are
// the popcounts of the words that were intersected.
//
// The TPU kernel's own form of the first fact is
// gpusimilarity_tpu/ops/pallas_bitplane.py::score_rational.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gpusim {

// table entry of a (query, pop) pair that no count can satisfy
constexpr uint16_t kNever = 0xFFFF;

__device__ __forceinline__ float tanimoto_score(float cf, float qpop, float pop) {
    const float denom = __fsub_rn(__fadd_rn(qpop, pop), cf);
    float s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1.f)) : 0.f;
    if (cf == denom && denom > 0.f) s = 1.f;  // self-match pin
    return s;
}

__device__ __forceinline__ float tversky_score(float cf, float qpop, float pop,
                                               float alpha, float beta) {
    const float denom = __fadd_rn(
        __fadd_rn(__fmul_rn(alpha, __fsub_rn(qpop, cf)),
                  __fmul_rn(beta, __fsub_rn(pop, cf))),
        cf);
    float s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1e-30f)) : 0.f;
    if (cf == denom && denom > 0.f) s = 1.f;  // self-match pin
    return s;
}

// Running maximum of rationals c / den, den >= 1. num == -1 means "no valid
// column yet" and loses to every c >= 0; an invalid column is offered with a
// negative c (-1, or a packed field whose sign bit marks it; down to -2^15,
// products still inside int32) and never displaces a valid incumbent.
struct RationalMax {
    int num;
    int den;
    __device__ __forceinline__ void reset() { num = -1; den = 1; }
    __device__ __forceinline__ void offer(int c, int d) {
        if (c * den > num * d) { num = c; den = d; }
    }
    // the block's score: the plain version's bits, -inf for no valid column
    __device__ __forceinline__ float score() const {
        if (num < 0) return -INFINITY;
        if (num == den) return 1.f;
        return __fdiv_rn((float)num, (float)den);
    }
};

// Tanimoto denominator of a count, as the incumbent stores it. The plain
// version's max(qpop + pop - c, 1) differs from qpop + pop - c only when all
// three are 0, and a query with no set bits scores 0 over any denominator; so
// with qden = max(qpop, 1), hoisted out of the column loop, qden + pop - c is
// at least 1 and gives every score the plain version's bits.
__device__ __forceinline__ int tanimoto_qden(int qpop) { return max(qpop, 1); }
__device__ __forceinline__ int tanimoto_den(int qden, int pop, int c) {
    return qden + pop - c;
}

// The smallest c in [0, min(qpop, pop)] with tanimoto_score(c) >= cutoff, or
// kNever. Binary search over the monotone predicate; a cutoff <= 0 gives 0
// (every score is >= 0) and a NaN cutoff kNever.
__device__ inline uint16_t tanimoto_cmin(int qpop, int pop, float cutoff) {
    if (cutoff <= 0.f) return 0;
    const int cmax = min(qpop, pop);
    const float qf = (float)qpop;
    const float pf = (float)pop;
    int lo = 0;
    int hi = cmax + 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tanimoto_score((float)mid, qf, pf) >= cutoff) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo > cmax ? kNever : (uint16_t)lo;
}

// Fills table[q * stride + pop] = tanimoto_cmin(qpops[q], pop, cutoffs[q]) for
// q < nq and pop <= bits, and kNever elsewhere in the rows x stride table, with
// all threads of the block; the caller synchronises before it reads.
__device__ inline void build_cmin_table(uint16_t* table, int rows, int stride,
                                        int bits, const int32_t* qpops,
                                        const float* cutoffs, int nq) {
    for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
        const int q = i / stride;
        const int pop = i - q * stride;
        table[i] = (q < nq && pop <= bits)
                       ? tanimoto_cmin(qpops[q], pop, cutoffs[q])
                       : kNever;
    }
}

// "score >= cutoff" as "c * q >= p * d" (see the header). p = 1, q = 0 is
// satisfied by no count, p = 0, q = 1 by every one.
struct RationalThreshold {
    int p;
    int q;
    __device__ __forceinline__ void set_never() { p = 1; q = 0; }
};

// The smallest fraction c / d, 0 <= c <= d, 1 <= d <= max_den (at most 2048:
// the products stay in int32), with fl(c / d) >= cutoff; every thread of the
// block calls it with the same arguments and gets the same result. blockDim.x
// is a power of two and s_num, s_den hold blockDim.x ints of shared memory.
// Per denominator a binary search over the monotone rounded divide, then the
// minimum by cross-multiplication. A cutoff <= 0 gives 0 / 1 and a NaN cutoff
// or one above 1 "never".
__device__ inline RationalThreshold tanimoto_threshold(float cutoff, int max_den,
                                                       int* s_num, int* s_den) {
    RationalThreshold th;
    if (cutoff <= 0.f) {
        th.p = 0;
        th.q = 1;
        return th;
    }
    // a / b < c / d for b, d >= 0 (a zero denominator is +infinity, as a
    // numerator of 1 over it): a * d < c * b
    int bn = 1;
    int bd = 0;
    for (int d = 1 + (int)threadIdx.x; d <= max_den; d += blockDim.x) {
        const float df = (float)d;
        int lo = 0;
        int hi = d + 1;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__fdiv_rn((float)mid, df) >= cutoff) {
                hi = mid;
            } else {
                lo = mid + 1;
            }
        }
        if (lo <= d && lo * bd < bn * d) {
            bn = lo;
            bd = d;
        }
    }
    s_num[threadIdx.x] = bn;
    s_den[threadIdx.x] = bd;
    __syncthreads();
    for (int step = blockDim.x >> 1; step > 0; step >>= 1) {
        if ((int)threadIdx.x < step) {
            const int on = s_num[threadIdx.x + step];
            const int od = s_den[threadIdx.x + step];
            if (on * s_den[threadIdx.x] < s_num[threadIdx.x] * od) {
                s_num[threadIdx.x] = on;
                s_den[threadIdx.x] = od;
            }
        }
        __syncthreads();
    }
    th.p = s_num[0];
    th.q = s_den[0];
    return th;
}

// A table index from a stored popcount: a value outside [0, bits] (no
// consistent store has one) reads the last entry instead of other memory.
__device__ __forceinline__ int table_pop(int pop, int bits) {
    return (int)min((unsigned)pop, (unsigned)bits);
}

}  // namespace gpusim
