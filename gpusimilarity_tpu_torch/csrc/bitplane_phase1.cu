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
// What bounds it. Per query and word it reads one 4-byte plane word for each
// bit the query sets (30-60 for a Morgan fingerprint, not the P of its
// bucket) and the 32 column popcounts (64 B of int16), and writes one float.
// The planes of a batch are 20 GB at 113M rows and B = 32 if every query
// reads its own (6 ms at 3.35 TB/s); the integer work is what the first
// version of this kernel lost its time to: a ripple-carry add of every
// bucket entry through every counter bit (3 x NB ops a plane), a bit-by-bit
// rebuild of each column's count (3 x NB ops a column) and a correctly
// rounded divide per column, about 2,700 instruction slots per (query, word).
//
// Design.
//   * One thread owns four adjacent plane words and reads each plane with one
//     16-byte ld.global.nc (L1 no-allocate, so the popcounts stay cached),
//     eight planes in flight per thread.
//   * Only the query's real entries are read: a small set-up kernel compacts
//     every plane list once (entries equal to the sentinel select the zero
//     plane and add nothing), 16 bits an index, and builds the query's count
//     table; each block copies its query's row into shared memory.
//   * Planes are summed by a carry-save (Harley-Seal) tree: eight planes fold
//     into the ones/twos/fours counters through seven full adders (two lop3
//     each) and one carry into the counters above, about 2.75 ops a plane
//     and word. The bit-sliced counters are the ones the plain version's
//     ops/bitplane.wallace_popcount_planes produces.
//   * Counts come out as packed fields, 8 bits while the bucket is below 128
//     and 16 above: one shift and mask per counter rebuilds 4 (or 2) columns
//     at once, as the TPU kernel does; the field's spare top bit carries
//     "column >= n_valid", so an invalid column reads as a negative count,
//     never counts and never wins a maximum.
//   * Tanimoto scores stay integer (phase1_epilogue.cuh): a running rational
//     maximum per word with one divide at its end, and c >= cmin[pop] from a
//     per-query table for the count; a query whose cutoff is <= 0 counts its
//     valid columns and looks nothing up. Tversky keeps the rounded float
//     score per column.
//   * One block scores one query over one 1024-word tile, and the grid
//     orders blocks queries fastest, so the blocks resident at one time are
//     every query of the batch over a few neighbouring tiles (8 at B = 32 and
//     two blocks an SM). Plane lists are sorted, so the queries that set a
//     plane read its tile at about the same time and all but the first find
//     it in L2, as they find the tile's popcounts: device memory sees each
//     plane of the batch about once, which is the kernel's byte bound.
//   * The >= cutoff count is reduced by warp shuffles, a shared-memory atomic
//     per warp and one integer atomic per block: integer addition is
//     order-free, the result deterministic.
//
// Not carried over from the TPU kernel: manual DMA double-buffering, the
// shared DMA semaphore, the (8, 128)-tile sub-row interleave and the pops3
// layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase1_epilogue.cuh"

namespace {

using gpusim::RationalMax;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kTileWords = kThreads * kWordsPerThread;
constexpr int kGroup = 8;  // planes per carry-save round
// shared memory a block may take for its list and table (two blocks an SM)
constexpr int kSmemBudget = 96 * 1024;

struct Words4 {
    uint32_t v[kWordsPerThread];
};

__device__ __forceinline__ Words4 load_plane(const uint32_t* p) {
    Words4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3])
                 : "l"(p));
    return r;
}

// full adder on three words: l = a ^ b ^ c, h = majority (two lop3)
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
    const uint32_t u = a ^ b;
    h = (a & b) | (u & c);
    l = u ^ c;
}

// Adds eight plane words into bit-sliced counters c[0..NB): seven full adders
// fold them into c[0], c[1], c[2] and one carry of weight 8 that ripples up.
template <int NB>
__device__ __forceinline__ void add8(uint32_t (&c)[NB], const uint32_t (&p)[kGroup]) {
    uint32_t t2a, t2b, t4a, t4b, t8;
    csa(t2a, c[0], c[0], p[0], p[1]);
    csa(t2b, c[0], c[0], p[2], p[3]);
    csa(t4a, c[1], c[1], t2a, t2b);
    csa(t2a, c[0], c[0], p[4], p[5]);
    csa(t2b, c[0], c[0], p[6], p[7]);
    csa(t4b, c[1], c[1], t2a, t2b);
    csa(t8, c[2], c[2], t4a, t4b);
#pragma unroll
    for (int j = 3; j < NB; ++j) {
        const uint32_t carry = c[j] & t8;
        c[j] ^= t8;
        t8 = carry;
    }
}

// per-field layout of the packed counts
template <int NB>
struct Fields {
    static constexpr int kBits = NB <= 7 ? 8 : 16;   // field width; top bit = invalid
    static constexpr int kPer = 32 / kBits;          // columns rebuilt at once
    // bit j of every field
    __host__ __device__ static constexpr uint32_t mask(int j) {
        uint32_t m = 0;
        for (int o = 0; o < 32; o += kBits) m |= 1u << (j + o);
        return m;
    }
};

// field k of x, sign-extended: one byte permute (prmt's selector bit 3
// replicates the chosen byte's sign; the __byte_perm intrinsic masks it off)
template <int BITS>
__device__ __forceinline__ int field(uint32_t x, int k) {
    const uint32_t sel = BITS == 8 ? 0x8880u | (0x1111u * (uint32_t)k)
                                   : (k == 0 ? 0x9910u : 0xBB32u);
    int r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(sel));
    return r;
}

// How a query's hits are counted: by its table, as its valid columns (cutoff
// <= 0: every score is >= 0), or by the float score (Tversky).
enum CountMode { kTable = 0, kAllValid = 1 };

// Scores one word's 32 columns from its bit-sliced counters cw: returns the
// word's maximum and adds its hits to `count`.
template <int NB, bool TVERSKY, int MODE>
__device__ __forceinline__ float score_word(
    const uint32_t (&cw)[NB], const int16_t* __restrict__ pops_w, uint32_t invalid,
    int qpop, float cutoff, float alpha, float beta, const uint16_t* cmin,
    int bitcount, int& count) {
    using F = Fields<NB>;
    // the word's 32 popcounts, 16 packed pairs
    uint32_t pp[16];
    const int4* pv = reinterpret_cast<const int4*>(pops_w);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
        const int4 x = __ldg(pv + v);
        pp[4 * v] = (uint32_t)x.x;
        pp[4 * v + 1] = (uint32_t)x.y;
        pp[4 * v + 2] = (uint32_t)x.z;
        pp[4 * v + 3] = (uint32_t)x.w;
    }
    RationalMax best;
    best.reset();
    float fbest = -INFINITY;
    const float qf = (float)qpop;
    const int qden = gpusim::tanimoto_qden(qpop);
#pragma unroll
    for (int bsel = 0; bsel < F::kBits; ++bsel) {
        // columns bsel, bsel + kBits, ...: one shift and mask per counter
        uint32_t merged = 0u;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const uint32_t moved = bsel >= j ? cw[j] >> (bsel - j) : cw[j] << (j - bsel);
            merged |= moved & F::mask(j);
        }
        {
            constexpr int top = F::kBits - 1;
            const uint32_t moved =
                bsel >= top ? invalid >> (bsel - top) : invalid << (top - bsel);
            merged |= moved & F::mask(top);
        }
#pragma unroll
        for (int k = 0; k < F::kPer; ++k) {
            const int col = bsel + k * F::kBits;
            const int c = field<F::kBits>(merged, k);  // negative: invalid column
            const uint32_t pair = pp[col >> 1];
            const int pop = (col & 1) ? (int)(pair >> 16) : (int)(pair & 0xFFFFu);
            if (TVERSKY) {
                const float s =
                    c < 0 ? -INFINITY
                          : gpusim::tversky_score((float)c, qf, (float)pop, alpha, beta);
                fbest = fmaxf(fbest, s);
                count += s >= cutoff ? 1 : 0;
            } else {
                best.offer(c, gpusim::tanimoto_den(qden, pop, c));
                if (MODE == kTable) {
                    count += c >= (int)cmin[gpusim::table_pop(pop, bitcount)] ? 1 : 0;
                }
            }
        }
    }
    return TVERSKY ? fbest : best.score();
}

// Per-query set-up, one block a query: the plane list compacted (entries
// equal to the sentinel dropped, order kept) and, for a Tanimoto query with a
// cutoff above 0, its cmin table. Rows of `lists` are list_stride entries, the
// list first and the table after it at table_offset.
__global__ void __launch_bounds__(kThreads) bitplane_setup_kernel(
    const int32_t* __restrict__ plane_idx, const int32_t* __restrict__ qpops,
    const float* __restrict__ cutoffs, uint16_t* __restrict__ lists,
    int32_t* __restrict__ lens, int p, int n_planes, int list_stride,
    int table_offset, int tversky) {
    const int q = blockIdx.x;
    const int bitcount = n_planes - 1;  // also the sentinel index
    uint16_t* row = lists + (size_t)q * list_stride;
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const int32_t* src = plane_idx + (size_t)q * p;
        int len = 0;
        for (int i0 = 0; i0 < p; i0 += 32) {
            const int i = i0 + lane;
            const int v = i < p ? src[i] : bitcount;
            const bool keep = v >= 0 && v < bitcount;
            const unsigned mask = __ballot_sync(0xffffffffu, keep);
            if (keep) row[len + __popc(mask & ((1u << lane) - 1u))] = (uint16_t)v;
            len += __popc(mask);
        }
        if (lane == 0) lens[q] = len;
    }
    if (!tversky && !(cutoffs[q] <= 0.f)) {
        gpusim::build_cmin_table(row + table_offset, 1, list_stride - table_offset,
                                 bitcount, qpops + q, cutoffs + q, 1);
    }
}

template <int NB, bool TVERSKY>
__global__ void __launch_bounds__(kThreads, 2) bitplane_phase1_kernel(
    const uint32_t* __restrict__ planes,     // (n_planes, m), last plane zero
    const int16_t* __restrict__ pops,        // (32 * m,) column popcounts
    const uint16_t* __restrict__ lists,      // (b, list_stride) from the set-up
    const int32_t* __restrict__ lens,        // (b,) compacted list lengths
    const int32_t* __restrict__ qpops,       // (b,) query popcounts
    const float* __restrict__ cutoffs,       // (b,)
    const float* __restrict__ alpha_beta,    // (2,) Tversky weights
    float* __restrict__ colmax,              // (b, m) out
    int32_t* __restrict__ counts,            // (b,) out, zeroed by the caller
    long long m, int b, int n_planes, long long n_valid, int list_stride,
    int table_offset) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_cnt;
    uint16_t* s_idx = reinterpret_cast<uint16_t*>(smem);  // the list, then the table
    const uint16_t* s_cmin = s_idx + table_offset;
    const int bitcount = n_planes - 1;

    // blocks are (tile, query) pairs, queries fastest
    const int q = blockIdx.x % b;
    const long long tile = blockIdx.x / b;
    const int lane = threadIdx.x & 31;
    const int qpop = qpops[q];
    const float cutoff = cutoffs[q];
    const bool all_valid = !TVERSKY && cutoff <= 0.f;
    const int len = lens[q];
    {
        // the list (rounded up to whole words) and, when it is used, the table
        const uint32_t* src = reinterpret_cast<const uint32_t*>(lists + (size_t)q * list_stride);
        uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
        const int words = (TVERSKY || all_valid) ? (len + 1) / 2 : list_stride / 2;
        for (int i = threadIdx.x; i < words; i += kThreads) dst[i] = src[i];
        if (threadIdx.x == 0) s_cnt = 0;
    }
    __syncthreads();
    const float alpha = alpha_beta[0];
    const float beta = alpha_beta[1];

    int count = 0;
    const long long w0 = tile * kTileWords + (long long)threadIdx.x * kWordsPerThread;
    if (w0 < m) {  // m is a multiple of 4: all four words or none
        // bit-sliced counters: lane-bit i of c[k][j] is bit j of the count of
        // column 32 * (w0 + k) + i
        uint32_t c[kWordsPerThread][NB];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) {
#pragma unroll
            for (int j = 0; j < NB; ++j) c[k][j] = 0u;
        }
        const uint32_t* base = planes + w0;
        for (int i = 0; i < len; i += kGroup) {
            Words4 pl[kGroup];
#pragma unroll
            for (int e = 0; e < kGroup; ++e) {
                if (i + e < len) {
                    pl[e] = load_plane(base + (size_t)s_idx[i + e] * (size_t)m);
                } else {
#pragma unroll
                    for (int k = 0; k < kWordsPerThread; ++k) pl[e].v[k] = 0u;
                }
            }
#pragma unroll
            for (int k = 0; k < kWordsPerThread; ++k) {
                uint32_t pw[kGroup];
#pragma unroll
                for (int e = 0; e < kGroup; ++e) pw[e] = pl[e].v[k];
                add8<NB>(c[k], pw);
            }
        }

        float out[kWordsPerThread];
#pragma unroll 1
        for (int k = 0; k < kWordsPerThread; ++k) {
            uint32_t cw[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                cw[j] = k == 0 ? c[0][j] : k == 1 ? c[1][j]
                      : k == 2 ? c[2][j] : c[3][j];
            }
            const long long col0 = 32 * (w0 + k);
            const long long left = n_valid - col0;  // valid columns of the word
            const uint32_t invalid =
                left >= 32 ? 0u : left <= 0 ? 0xffffffffu : ~((1u << (int)left) - 1u);
            float s;
            if (all_valid) {
                s = score_word<NB, TVERSKY, kAllValid>(
                    cw, pops + col0, invalid, qpop, cutoff, alpha, beta, s_cmin,
                    bitcount, count);
                count += left >= 32 ? 32 : left <= 0 ? 0 : (int)left;
            } else {
                s = score_word<NB, TVERSKY, kTable>(
                    cw, pops + col0, invalid, qpop, cutoff, alpha, beta, s_cmin,
                    bitcount, count);
            }
            if (k == 0) out[0] = s;
            if (k == 1) out[1] = s;
            if (k == 2) out[2] = s;
            if (k == 3) out[3] = s;
        }
        *reinterpret_cast<float4*>(colmax + (size_t)q * (size_t)m + w0) =
            make_float4(out[0], out[1], out[2], out[3]);
    }

    // the block's count: warp shuffles, a shared-memory atomic per warp, one
    // atomic per block
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        count += __shfl_down_sync(0xffffffffu, count, off);
    }
    if (lane == 0 && count) atomicAdd(&s_cnt, count);
    __syncthreads();
    if (threadIdx.x == 0 && s_cnt) atomicAdd(counts + q, s_cnt);
}

// entries of a scratch row: the list (p, even) and the Tanimoto table
// (bitcount + 1, even)
__host__ __device__ constexpr int list_entries(int p) { return (p + 1) & ~1; }
__host__ __device__ constexpr int table_entries(int n_planes) { return (n_planes + 1) & ~1; }

template <int NB>
cudaError_t launch(const void* planes, const void* pops, const void* plane_idx,
                   const void* qpops, const void* cutoffs,
                   const void* alpha_beta, void* colmax, void* counts,
                   void* lists, void* lens, long long m, int b, int p,
                   int n_planes, long long n_valid, bool tversky,
                   cudaStream_t stream) {
    const int table_offset = list_entries(p);
    const int list_stride = table_offset + (tversky ? 0 : table_entries(n_planes));
    const size_t smem = (size_t)list_stride * 2;
    const long long n_tiles = (m + kTileWords - 1) / kTileWords;
    if (smem > (size_t)kSmemBudget || n_tiles * b > 0x7fffffffLL) {
        return cudaErrorInvalidValue;
    }
    bitplane_setup_kernel<<<b, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(plane_idx), static_cast<const int32_t*>(qpops),
        static_cast<const float*>(cutoffs), static_cast<uint16_t*>(lists),
        static_cast<int32_t*>(lens), p, n_planes, list_stride, table_offset,
        (int)tversky);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto* kernel = tversky ? bitplane_phase1_kernel<NB, true>
                           : bitplane_phase1_kernel<NB, false>;
    // The attribute and the launch below apply to the thread's current
    // device; the Python wrapper makes that the tensors' device.
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(n_tiles * b), kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(planes), static_cast<const int16_t*>(pops),
        static_cast<const uint16_t*>(lists), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(qpops), static_cast<const float*>(cutoffs),
        static_cast<const float*>(alpha_beta), static_cast<float*>(colmax),
        static_cast<int32_t*>(counts), m, b, n_planes, n_valid, list_stride,
        table_offset);
    return cudaGetLastError();
}

}  // namespace

// The 16-bit entries of one query's row of the `lists` scratch: its plane list
// and, unless tversky, its cmin table.
extern "C" int gpusim_bitplane_scratch_entries(int p, int n_planes, int tversky) {
    return list_entries(p) + (tversky ? 0 : table_entries(n_planes));
}

// Launches phase 1 on `stream` for b queries of p plane indices over m plane
// words of n_planes planes (the last one zero); returns the cudaError_t of
// the launch (0 on success). p may be up to 4095 (counts need at most 12
// bits); m must be a multiple of 4 and planes, pops and colmax 16-byte
// aligned. `lists` is scratch of b rows of gpusim_bitplane_scratch_entries
// 16-bit entries (4-byte aligned) and `lens` scratch of b int32.
extern "C" int gpusim_bitplane_phase1(
    const void* planes, const void* pops, const void* plane_idx,
    const void* qpops, const void* cutoffs, const void* alpha_beta,
    void* colmax, void* counts, void* lists, void* lens, long long m, int b,
    int p, int n_planes, long long n_valid, int tversky, void* stream) {
    if (m <= 0 || m % kWordsPerThread || b <= 0 || p <= 0 || n_planes < 1 ||
        n_planes > 65536 || reinterpret_cast<uintptr_t>(planes) % 16 ||
        reinterpret_cast<uintptr_t>(pops) % 16 ||
        reinterpret_cast<uintptr_t>(colmax) % 16 ||
        reinterpret_cast<uintptr_t>(lists) % 4) {
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
                               alpha_beta, colmax, counts, lists, lens, m,   \
                               b, p, n_planes, n_valid, tv, s);
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
