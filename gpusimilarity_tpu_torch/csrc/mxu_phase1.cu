// Phase 1 of the dense scan as a tensor-core matrix product with each library
// tile staged once for the whole query batch, for Hopper (sm_90a).
//
// Replaces gpusimilarity_tpu/ops/pallas_mxu.py::_kernel. The store holds
// each 1024-bit library row as 32 packed words, planar: words[w][col] for
// word w, column stride 1 and row stride ld; pops[col] is the row's
// popcount (int16, the dense store's own array). For a batch of b <= 128
// queries given as their unpacked bits qbits[q][k] (int8, word-major:
// k = w*32 + bit) the intersection count is the product
//   common[q][col] = sum_k qbits[q][k] * bit(words[k / 32][col], k % 32),
// after which the kernel computes, as the dense kernel does,
//   * block_max[q][j]: the best Tanimoto or Tversky score over columns
//     [j*block, (j+1)*block) (-inf where offset + col >= n_valid), and
//   * counts[q]: the number of valid columns scoring >= cutoffs[q].
//
// What the TPU kernel bets on, and what carries over. The TPU multiplies
// int8 or bf16 matrices only, so its kernel unpacks every library word into
// 32 lanes before the product and wins by paying that unpack once per column
// for the whole batch. This card multiplies packed bits directly
// (mma.sync.m16n8k256.b1.b1.s32.and.popc, measured at 9.2e15 bit operations
// a second, tools/probe_b1.py), so the unpack is gone: the unpacked queries
// are packed back into 32 words each by a set-up kernel, once per launch,
// and the library words go into the product as they lie in the store. What
// survives is the bet itself: ONE pass over the store for up to 128 queries,
// where the dense kernel (dense_phase1.cu) takes 32 queries a pass.
//
// What bounds it, at 113,335,291 rows on an H100 SXM (3.35 TB/s): it reads
// 130 B per row (128 B of words, 2 B of popcount), 14.73 GB, 4.40 ms; the
// binary product is 2 * b * 1024 bit operations per row, 0.025 ms * b, 3.2 ms
// at b = 128: bytes bound it at every batch it takes. What holds it above
// that is the score, about 12 operations per (query, column) (measured with
// the scoring taken out, 128 queries cost 1.9 times a single one; with it,
// 2.8 times: PERF.md), so the design's care goes into which pipe they use.
//
// Design.
//   Set-up kernel (one block per query row, rows padded to whole 16-row m
//   tiles with zero queries that are never written out): packs qbits into
//   words and stores them in A-fragment order, so the main kernel reads the
//   four registers of a fragment with one 16-byte shared-memory load; and
//   turns the query's cutoff into a rational threshold (below). Both go to a
//   scratch buffer the caller allocates.
//   Staging: a persistent grid, one block of 16 warps per SM, walks tiles of
//   32 words x 256 columns. A ring of shared-memory stages (33 KB each: the
//   words with the plane stride padded by 8 words so a fragment load's 32
//   lanes fall in 32 banks, then the tile's popcounts; 6 stages, all that
//   fit) is filled with 16-byte cp.async five tiles ahead, by all threads;
//   one __syncthreads() per tile publishes the arrived tile, frees the stage
//   one back and hands over the previous tile's maxima. A tile that is ragged
//   (the last), or any tile of a store whose addresses are not 16-byte
//   aligned (base, ld % 4, pops), takes plain loads with zero fill.
//   Product: warp w owns columns 16w..16w+15 of the tile, two n8 tiles. Its B
//   fragments are words[8*ks + t][col + g] and words[8*ks + t + 4][col + g]
//   (g = lane / 4, t = lane % 4), loaded once per tile; then every m tile of
//   the batch (up to 8) runs its four k steps against them, so a stage is
//   read once for all queries before it is released. The accumulators start
//   at the bits of the float 2^23, so a finished count c reads, as a float,
//   2^23 + c: no conversion per count.
//   Epilogue, Tanimoto, in float32 and exact (every value an integer below
//   2^24): the integer pipe runs at half the float pipe's rate and would bind.
//   A thread takes the largest c / d of its four columns by a knock-out of
//   cross-multiplications (RationalMax's compare of phase1_epilogue.cuh, in
//   floats), divides once, and raises the running maximum of its (query,
//   selection block) in shared memory with an atomic max on the score's bits,
//   which order as ints because scores are >= 0; the tile after, one thread
//   per (query, block) writes the maximum out and resets it. (A first version
//   wrote (num, den) per thread and merged 64 of them per query and tile with
//   shuffles: the merge alone was a quarter of a single query's time.) A
//   column that is not valid carries NaN as its popcount, which fails every
//   compare: no select per (query, column). Tversky keeps the rounded float
//   score per column (its weights are floats).
//   The count test at 128 queries. The dense kernel tests c >= cmin[pop]
//   from a (bits + 1)-entry table per query: 262 KB for 128 queries of 1024
//   bits, more than a block's shared memory. Here a query has ONE threshold
//   instead: the score is fl(c / d) with d = max(qpop, 1) + pop - c, the
//   rounded divide is monotone, and d <= 2048, so among the fractions with
//   denominators up to 2048 there is a smallest one, P / Q, whose rounded
//   value reaches the cutoff, and fl(c / d) >= cutoff exactly when
//   c * Q >= P * d, that is c * (P + Q) >= P * pop + P * max(qpop, 1): a
//   multiply, a multiply-add, a compare and an add. The set-up kernel finds
//   P / Q with the plain version's divide (a binary search per denominator, a
//   minimum by cross-multiplication), so the counts are the plain version's
//   by construction; ops/epilogue.tanimoto_threshold is the same in plain
//   PyTorch and tests/test_torch_epilogue.py holds it to the per-column
//   divide.
//   Counts stay in registers for the launch and end in a shuffle reduce, a
//   shared-memory atomic per warp and one 64-bit atomic per block and query:
//   order-free, so deterministic.
//
// Not the route here: wgmma. Its b1 operands must lie K-major in shared
// memory (a column's 1024 bits contiguous), and the planar store is the other
// way round (a column's words lie ld apart); no TMA box turns one into the
// other, and a transposing copy would be the unpack again. mma.sync's rate
// already puts the product under the bytes (3.2 against 4.4 ms at b = 128).
//
// Tried on the card and taken out (PERF.md has the times): for the count,
// the per-query cutoff table read from device memory through L1 (1.3 times
// the time at 128 queries) and one float divide per (query, column) (2.7
// times); issuing the next m tile's products before this one is scored, and
// splitting a single m tile's k steps over independent accumulators (no
// change: the compiler and 16 warps already overlap them); the int8 and bf16
// products of the first version of this kernel, whose unpack was the whole
// of its time. int8_mxu of the Python wrapper therefore selects nothing here.
//
// Not carried over from the TPU kernel: the unpack, the int8/bf16 choice,
// the sequential grid's carried count scratch and its 128-lane accumulator,
// the (8, 128) output tiling and the qmeta packing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase1_epilogue.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 2;                         // n8 tiles per warp
constexpr int kWarpCols = 8 * kNT;             // 16 columns per warp
constexpr int kTileCols = kWarps * kWarpCols;  // 256 columns per tile
constexpr int kMinBlock = 64;
constexpr int kMaxQueries = 128;  // queries per launch
constexpr int kWords = 32;        // 1024-bit rows
constexpr int kBits = 32 * kWords;
constexpr int kKS = kWords / 8;   // k steps of 256 bits
constexpr int kStages = 6;  // the ring: all that fit at 128 queries
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPlanePad = 8;      // words added to the shared-memory plane stride
constexpr int kStride = kTileCols + kPlanePad;
constexpr int kStageBytes = kWords * kStride * 4 + kTileCols * 2;
constexpr int kMaxGroups = kTileCols / kMinBlock;  // selection blocks of a tile
constexpr int kMetaInts = 4;  // per query, as floats: max(qpop, 1), P + Q, P, P * max(qpop, 1)
// 2^23 as float bits: an accumulator that starts here holds the float 2^23 + c
constexpr int kBiasBits = 0x4B000000;
constexpr float kBias = 8388608.f;
// the bits of -inf: as an int below the bits of every score (scores are >= 0)
constexpr int kNoScore = (int)0xFF800000u;

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// words of scratch the set-up kernel fills for `rows` padded query rows: the
// A fragments, then the per-query numbers
__host__ __device__ constexpr int scratch_words(int rows) {
    return rows * kWords + rows * kMetaInts;
}

// One block per padded query row. frag: [m tile][k step][lane][4] words, the
// register a[2 * half + hh] of lane 4 * g + t being word 8 * ks + t + 4 * half
// of query 16 * mt + 8 * hh + g. meta: kMetaInts floats (their bits) per row.
__global__ void __launch_bounds__(256) mxu_setup_kernel(
    const int8_t* __restrict__ qbits, const int32_t* __restrict__ qpops,
    const float* __restrict__ cutoffs, int b, int tversky,
    int32_t* __restrict__ scratch) {
    const int q = blockIdx.x;
    const int rows = gridDim.x;
    uint32_t* frag = reinterpret_cast<uint32_t*>(scratch);
    int32_t* meta = scratch + rows * kWords + q * kMetaInts;
    if (threadIdx.x < kWords) {
        const int w = threadIdx.x;
        uint32_t word = 0u;
        if (q < b) {
            const int8_t* src = qbits + (size_t)q * kBits + w * 32;
            for (int i = 0; i < 32; ++i) word |= (uint32_t)(src[i] & 1) << i;
        }
        const int mt = q >> 4, hh = (q >> 3) & 1, g = q & 7;
        const int ks = w >> 3, half = (w >> 2) & 1, t = w & 3;
        frag[(((mt * kKS + ks) * 32) + 4 * g + t) * 4 + 2 * half + hh] = word;
    }
    const int qden = gpusim::tanimoto_qden(q < b ? qpops[q] : 0);
    __shared__ int s_num[256];
    __shared__ int s_den[256];
    gpusim::RationalThreshold th;
    th.set_never();
    if (q < b && !tversky) {
        th = gpusim::tanimoto_threshold(cutoffs[q], qden + kBits, s_num, s_den);
    }
    if (threadIdx.x == 0) {
        // as floats: the main kernel scores in float32, exactly (see there)
        meta[0] = __float_as_int((float)qden);
        meta[1] = __float_as_int((float)(th.p + th.q));
        meta[2] = __float_as_int((float)th.p);
        meta[3] = __float_as_int((float)(th.p * qden));
    }
}

// shared memory beside the stages: the A fragments, two buffers of running
// maxima, the per-query numbers, Tversky floats and counts
template <int MT>
constexpr int fixed_smem_bytes() {
    return MT * 16 * kWords * 4 + 2 * kMaxGroups * MT * 16 * 4 +
           MT * 16 * (kMetaInts * 4 + 8 + 8);
}

template <int MT>
constexpr size_t smem_bytes() {
    return (size_t)kStages * kStageBytes + fixed_smem_bytes<MT>();
}
static_assert(smem_bytes<kMaxQueries / 16>() <= kMaxSmem, "the ring must fit");

// MT m tiles of 16 query rows; HR = 1 when only rows 0..7 of the single m
// tile hold queries (b <= 8), else 2
template <int MT, int HR, bool TVERSKY>
__global__ void __launch_bounds__(kThreads, 1) mxu_phase1_kernel(
    const uint32_t* __restrict__ words,    // (32, ld) planar, n columns read
    const int16_t* __restrict__ pops,      // (n,) column popcounts
    const int32_t* __restrict__ scratch,   // the set-up kernel's output
    const int32_t* __restrict__ qpops,     // (b,)
    const float* __restrict__ cutoffs,     // (b,)
    const float* __restrict__ alpha_beta,  // (2,) Tversky weights
    float* __restrict__ block_max,         // (b, n / block) out
    unsigned long long* __restrict__ counts,  // (b,) out, zeroed by the caller
    long long n, long long ld, int b, int block, long long n_valid,
    long long offset, int aligned16) {
    constexpr int kRows = MT * 16;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_stages = smem;
    uint4* s_a = reinterpret_cast<uint4*>(smem + kStages * kStageBytes);
    int32_t* s_best = reinterpret_cast<int32_t*>(s_a + MT * kKS * 32);
    float4* s_meta = reinterpret_cast<float4*>(s_best + 2 * kMaxGroups * kRows);
    float2* s_tv = reinterpret_cast<float2*>(s_meta + kRows);  // (qpop, cutoff)
    unsigned long long* s_cnt = reinterpret_cast<unsigned long long*>(s_tv + kRows);

    for (int i = threadIdx.x; i < MT * kKS * 32; i += kThreads) {
        s_a[i] = reinterpret_cast<const uint4*>(scratch)[i];
    }
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
        s_meta[i] = reinterpret_cast<const float4*>(scratch + kRows * kWords)[i];
        // a padded row counts nothing
        s_tv[i] = i < b ? make_float2((float)qpops[i], cutoffs[i])
                        : make_float2(0.f, INFINITY);
        s_cnt[i] = 0ull;
    }
    for (int i = threadIdx.x; i < 2 * kMaxGroups * kRows; i += kThreads) {
        s_best[i] = kNoScore;
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;  // mma groupID
    const int t = lane & 3;   // mma threadID_in_group
    const float alpha = alpha_beta[0];
    const float beta = alpha_beta[1];
    const long long n_tiles = (n + kTileCols - 1) / kTileCols;
    const long long n_blocks = n / block;
    // columns below `limit` exist and are valid
    const long long valid_cols = n_valid - offset;
    const long long limit = valid_cols < n ? valid_cols : n;
    const long long my_tiles =
        blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

    // copy tile `i` of this block into its stage: 16-byte cp.async when every
    // address is 16-byte aligned and the tile lies inside the array, else
    // plain loads with the columns past n zero-filled
    auto stage_in = [&](long long i) {
        if (i < my_tiles) {
            const long long c0 = (blockIdx.x + i * gridDim.x) * kTileCols;
            unsigned char* st = s_stages + (size_t)(i % kStages) * kStageBytes;
            uint32_t* sw = reinterpret_cast<uint32_t*>(st);
            int16_t* sp = reinterpret_cast<int16_t*>(sw + kWords * kStride);
            if (aligned16 && c0 + kTileCols <= n) {
                constexpr int kChunks = kTileCols / 4;  // 16-byte chunks of a plane run
                for (int j = threadIdx.x; j < kWords * kChunks; j += kThreads) {
                    const int r = j / kChunks;
                    const int ch = j - r * kChunks;
                    cp_async16(sw + r * kStride + 4 * ch,
                               words + (size_t)r * (size_t)ld + c0 + 4 * ch);
                }
                if (threadIdx.x < kTileCols / 8) {
                    cp_async16(sp + 8 * threadIdx.x, pops + c0 + 8 * threadIdx.x);
                }
            } else {
                for (int j = threadIdx.x; j < kWords * kTileCols; j += kThreads) {
                    const int r = j / kTileCols;
                    const int c = j - r * kTileCols;
                    sw[r * kStride + c] =
                        c0 + c < n ? __ldg(words + (size_t)r * (size_t)ld + c0 + c) : 0u;
                }
                for (int c = threadIdx.x; c < kTileCols; c += kThreads) {
                    sp[c] = c0 + c < n ? __ldg(pops + c0 + c) : (int16_t)0;
                }
            }
        }
        cp_async_commit();
    };

    // the maxima of tile `i`, one per (query, selection block of the tile),
    // written out and reset for the tile after next
    const int groups = kTileCols / block;
    const int block_shift = __ffs(block) - 1;
    auto write_out = [&](long long i) {
        int32_t* sb = s_best + (i & 1) * kMaxGroups * kRows;
        const long long tile = blockIdx.x + i * gridDim.x;
        for (int j = threadIdx.x; j < kRows * groups; j += kThreads) {
            const int q = j % kRows;
            const int gi = j / kRows;
            const int v = sb[gi * kRows + q];
            sb[gi * kRows + q] = kNoScore;
            const long long jb = tile * groups + gi;
            if (q < b && jb < n_blocks) {
                block_max[(size_t)q * (size_t)n_blocks + jb] = __int_as_float(v);
            }
        }
    };

    // counts as floats: exact while a thread counts fewer than 2^24 columns
    // a query, and it sees 4 columns of each of its block's tiles
    float cnt[MT][HR];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < HR; ++h) cnt[mt][h] = 0.f;

    for (int i = 0; i < kStages - 1; ++i) stage_in(i);
    for (long long i = 0; i < my_tiles; ++i) {
        cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
        // tile i is whole; every warp is done with tile i - 1: its stage is
        // free and its maxima are complete (the first pass also publishes the
        // prologue's shared memory)
        __syncthreads();
        stage_in(i + kStages - 1);
        if (i > 0) write_out(i - 1);

        const long long c0 = (blockIdx.x + i * gridDim.x) * kTileCols;
        const unsigned char* st = s_stages + (size_t)(i % kStages) * kStageBytes;
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(st) + warp * kWarpCols;
        const int16_t* sp =
            reinterpret_cast<const int16_t*>(st + kWords * kStride * 4) + warp * kWarpCols;
        // this warp's selection block of the tile
        int32_t* sb = s_best + (i & 1) * kMaxGroups * kRows +
                      ((warp * kWarpCols) >> block_shift) * kRows;

        uint32_t bf[kNT][kKS][2];
        // this thread's accumulator columns, 8 * nt + 2 * t + e: the popcount
        // as a float and 2^23 more, both NaN for a column that is not valid
        float popf[kNT][2];
        float popb[kNT][2];
        bool valid[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int ks = 0; ks < kKS; ++ks) {
                bf[nt][ks][0] = sw[(8 * ks + t) * kStride + 8 * nt + g];
                bf[nt][ks][1] = sw[(8 * ks + t + 4) * kStride + 8 * nt + g];
            }
            const uint32_t pp = *reinterpret_cast<const uint32_t*>(sp + 8 * nt + 2 * t);
            const long long left = limit - (c0 + warp * kWarpCols + 8 * nt + 2 * t);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                valid[nt][e] = e < left;
                popf[nt][e] = valid[nt][e] ? (float)(e ? pp >> 16 : pp & 0xFFFFu) : NAN;
                popb[nt][e] = popf[nt][e] + kBias;
            }
        }

#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            // the accumulators start at the bits of 2^23, so after the product
            // they are, read as floats, 2^23 + c: no conversion per count
            int d[kNT][4];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) d[nt][e] = kBiasBits;
#pragma unroll
            for (int ks = 0; ks < kKS; ++ks) {
                const uint4 a = s_a[(mt * kKS + ks) * 32 + lane];
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) mma_b1(d[nt], a, bf[nt][ks][0], bf[nt][ks][1]);
            }
#pragma unroll
            for (int h = 0; h < HR; ++h) {
                const int q = mt * 16 + h * 8 + g;
                if (TVERSKY) {
                    const float2 qc = s_tv[q];
                    float best = -INFINITY;
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            float s = gpusim::tversky_score(
                                __int_as_float(d[nt][2 * h + e]) - kBias, qc.x,
                                popf[nt][e], alpha, beta);
                            if (!valid[nt][e]) s = -INFINITY;
                            best = fmaxf(best, s);
                            cnt[mt][h] += s >= qc.y ? 1.f : 0.f;
                        }
                    if (best >= 0.f) atomicMax(sb + q, __float_as_int(best));
                } else {
                    // Tanimoto in float32, exactly: c <= 1024, d <= 2048 and
                    // the threshold's P, P + Q <= 4096 are integers whose
                    // products and sums stay below 2^24. The float pipe takes
                    // the multiplies the integer pipe would be bound by.
                    const float4 m = s_meta[q];  // qden, P + Q, P, P * qden
                    float c[2 * kNT];
                    float den[2 * kNT];
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float x = __int_as_float(d[nt][2 * h + e]);  // 2^23 + c
                            c[2 * nt + e] = x - kBias;
                            den[2 * nt + e] = (popb[nt][e] - x) + m.x;  // NaN when not valid
                            // c * (P + Q) >= P * pop + P * qden, false on NaN
                            cnt[mt][h] += c[2 * nt + e] * m.y >= fmaf(m.z, popf[nt][e], m.w)
                                              ? 1.f : 0.f;
                        }
                    // the largest c / den of the four columns, as a knock-out:
                    // the later column wins when c' * den > c * den' (false
                    // when it is not valid; valid columns come first)
                    static_assert(kNT == 2, "the knock-out below is for four columns");
                    const bool w01 = c[1] * den[0] > c[0] * den[1];
                    const bool w23 = c[3] * den[2] > c[2] * den[3];
                    const float ca = w01 ? c[1] : c[0], da = w01 ? den[1] : den[0];
                    const float cb = w23 ? c[3] : c[2], db = w23 ? den[3] : den[2];
                    const bool wb = cb * da > ca * db;
                    const float cw = wb ? cb : ca, dw = wb ? db : da;
                    // one divide for the thread's four columns (monotone: the
                    // largest c / den has the largest rounded score; c == den
                    // divides to 1.0), then a maximum of the scores' bits, which
                    // order as ints; nothing when no column was valid
                    // (a zero numerator would send the divide down its slow
                    // path, for the whole warp: 0 / d is 0 without dividing)
                    if (dw == dw) {
                        const float s = __fdiv_rn(cw > 0.f ? cw : dw, dw);
                        atomicMax(sb + q, __float_as_int(cw > 0.f ? s : 0.f));
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (my_tiles > 0) write_out(my_tiles - 1);

    // counts: the group's four lanes, then the block, then one atomic a query
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < HR; ++h) {
            int c = (int)cnt[mt][h];
            c += __shfl_xor_sync(0xffffffffu, c, 1);
            c += __shfl_xor_sync(0xffffffffu, c, 2);
            if (t == 0 && c) {
                atomicAdd(s_cnt + mt * 16 + h * 8 + g, (unsigned long long)c);
            }
        }
    __syncthreads();
    for (int q = threadIdx.x; q < b; q += kThreads) {
        if (s_cnt[q]) atomicAdd(counts + q, s_cnt[q]);
    }
}

struct Args {
    const uint32_t* words;
    const int16_t* pops;
    const int32_t* scratch;
    const int32_t* qpops;
    const float* cutoffs;
    const float* alpha_beta;
    float* block_max;
    unsigned long long* counts;
    long long n, ld;
    int b, block;
    long long n_valid, offset;
    bool tversky;
    cudaStream_t stream;
};

// The current device's SM count, cached per device: a process may serve
// shards on several cards (a benign race: every writer stores the same value).
int sm_count() {
    constexpr int kMaxDevices = 64;
    static int cached[kMaxDevices] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    const bool cache = dev >= 0 && dev < kMaxDevices;
    if (cache && cached[dev] > 0) return cached[dev];
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    if (cache) cached[dev] = n;
    return n;
}

template <int MT, int HR>
cudaError_t launch(const Args& a) {
    auto* kernel = a.tversky ? mxu_phase1_kernel<MT, HR, true>
                             : mxu_phase1_kernel<MT, HR, false>;
    constexpr size_t smem = smem_bytes<MT>();
    // The attribute and the launch below apply to the thread's current
    // device; the Python wrapper makes that the tensors' device.
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long tiles = (a.n + kTileCols - 1) / kTileCols;
    const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
    const int aligned16 = reinterpret_cast<uintptr_t>(a.words) % 16 == 0 &&
                          a.ld % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(a.pops) % 16 == 0;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        a.words, a.pops, a.scratch, a.qpops, a.cutoffs, a.alpha_beta, a.block_max,
        a.counts, a.n, a.ld, a.b, a.block, a.n_valid, a.offset, aligned16);
    return cudaGetLastError();
}

}  // namespace

// int32 words of scratch a launch for b queries needs.
extern "C" int gpusim_mxu_scratch_words(int b) {
    return scratch_words((b + 15) / 16 * 16);
}

// Launches phase 1 on `stream` for b <= 128 queries over the first n columns
// of a planar 32-word store with row stride ld. block must be a power of two
// from 64 to 256 that divides n; scratch must hold gpusim_mxu_scratch_words(b)
// int32 words, 16-byte aligned. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int gpusim_mxu_phase1(
    const void* words, const void* pops, const void* qbits, const void* qpops,
    const void* cutoffs, const void* alpha_beta, void* block_max, void* counts,
    void* scratch, long long n, long long ld, int b, int block,
    long long n_valid, long long offset, int tversky, void* stream) {
    if (n <= 0 || ld < n || b <= 0 || b > kMaxQueries || block < kMinBlock ||
        block > kTileCols || (block & (block - 1)) || n % block ||
        reinterpret_cast<uintptr_t>(scratch) % 16) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int mt = (b + 15) / 16;
    mxu_setup_kernel<<<16 * mt, 256, 0, s>>>(
        static_cast<const int8_t*>(qbits), static_cast<const int32_t*>(qpops),
        static_cast<const float*>(cutoffs), b, tversky,
        static_cast<int32_t*>(scratch));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Args a = {
        static_cast<const uint32_t*>(words), static_cast<const int16_t*>(pops),
        static_cast<const int32_t*>(scratch), static_cast<const int32_t*>(qpops),
        static_cast<const float*>(cutoffs), static_cast<const float*>(alpha_beta),
        static_cast<float*>(block_max), static_cast<unsigned long long*>(counts),
        n, ld, b, block, n_valid, offset, tversky != 0, s};
    switch (mt) {
        case 1: return (int)(b <= 8 ? launch<1, 1>(a) : launch<1, 2>(a));
        case 2: return (int)launch<2, 2>(a);
        case 3: return (int)launch<3, 2>(a);
        case 4: return (int)launch<4, 2>(a);
        case 5: return (int)launch<5, 2>(a);
        case 6: return (int)launch<6, 2>(a);
        case 7: return (int)launch<7, 2>(a);
        default: return (int)launch<8, 2>(a);
    }
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
