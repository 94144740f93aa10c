// Phase 1 of the dense scan as a tensor-core matrix product, for Hopper
// (sm_90a).
//
// Replaces gpusimilarity_tpu/ops/pallas_mxu.py::_kernel. The store holds
// each 1024-bit library row as 32 packed words, planar: words[w][col] for
// word w, column stride 1 and row stride ld; pops[col] is the row's
// popcount (int16, the dense store's own array). For a batch of b queries
// given as their unpacked bits qbits[q][k] (int8, word-major: k = w*32 + bit)
// the intersection count is the product
//   common[q][col] = sum_k qbits[q][k] * bit(words[k / 32][col], k % 32),
// after which the kernel computes, as the dense kernel does,
//   * block_max[q][j]: the best Tanimoto or Tversky score over columns
//     [j*block, (j+1)*block) (-inf where offset + col >= n_valid), and
//   * counts[q]: the number of columns scoring >= cutoffs[q].
//
// The bet of the TPU kernel carries over: each library tile is unpacked
// ONCE per thread block into tensor-core fragments and multiplied against
// all b query rows, so the unpack is paid once per column whatever the
// batch, while the popcount kernel (dense_phase1.cu) pays its integer work
// per query and column.
//
// What bounds it, at 113,335,291 rows on an H100 SXM (3.35 TB/s, 1,979 int8
// TOP/s, 989 bf16 TFLOP/s at 700 W): it reads 130 B per row (128 B of words,
// 2 B of popcount), 14.73 GB, so 4.40 ms by bytes; the product is
// 2 * b * 1024 operations per row, 3.75 ms at b = 32 and 15.0 ms at b = 128
// in int8 (twice that in bf16). Bytes bound it up to b ~ 37, operations
// above. This version is written to be right, not fast: mma.sync (not
// wgmma), one shared-memory tile without TMA or cp.async double buffering,
// and every 4 (int8) or 2 (bf16) bits of a packed word are expanded into
// fragment lanes with integer multiplies.
//
// Design. A thread block of 8 warps owns 256 consecutive columns at a time
// (a persistent grid walks the column tiles), each warp 32 columns = four
// n8 tiles. The queries' bits sit in shared memory, padded with zero rows to
// a multiple of 16 (the mma M); padded rows are never written out. The
// tile's 32 x 256 packed words are first copied to shared memory with
// coalesced loads, all in flight together, so the k loop waits on device
// memory once per tile rather than once per word. For each packed word w
// (one k32 step in int8, two k16 steps in bf16) a thread reads word w of
// its fragment columns (the four threads of a group read the same word) and
// expands its nibble or bit pair straight into the B fragment:
//   int8  m16n8k32 s8*s8->s32: 4 bits -> 4 int8 lanes, ((x & 0xF) *
//         0x00204081) & 0x01010101;
//   bf16  m16n8k16 bf16*bf16->f32: 2 bits -> 2 bf16 lanes of 0 or 1.0.
// The A fragments (query bits) are read from shared memory for every m16
// tile and reused across the warp's four n8 tiles. Counts of integers up to
// 1024 are exact in both accumulators, so both modes give the same bits.
//
// Scoring runs on the accumulator fragments in the plain version's order
// (ops/mxu_phase1.py, ops/scan.similarity_from_counts) with explicitly
// rounded intrinsics only (no FMA contraction, no fast-math divide); build
// without --use_fast_math. The >= cutoff count is a shuffle reduce within
// each group of four lanes, a shared-memory atomic per query, and one
// integer atomicAdd per query and block at the end: order-free, so
// deterministic. A block maximum is a shuffle max within each n8 tile, then
// one shared-memory step across the warps its block spans (2 to 8).
//
// Not carried over from the TPU kernel: the sequential grid's carried count
// scratch and its 128-lane accumulator, the (8, 128) output tiling and the
// qmeta packing of query popcounts and cutoffs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;                        // n8 tiles per warp
constexpr int kWarpCols = 8 * kNT;            // 32 columns per warp
constexpr int kTileCols = kWarps * kWarpCols;  // 256 columns per block step
constexpr int kMinBlock = 2 * kWarpCols;         // selection blocks span >= 2 warps
constexpr int kMaxQueries = 128;              // queries per launch
constexpr int kBits = 1024;
constexpr int kWords = kBits / 32;
// shared-memory bytes per query row: 1024 bits + 16, so the 32 lanes of a
// fragment load fall in 32 different banks
constexpr int kQStride = kBits + 16;

__device__ __forceinline__ uint32_t expand4_s8(uint32_t nibble) {
    return (nibble * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t expand2_bf16(uint32_t two) {
    return ((two & 1u) | ((two & 2u) << 15)) * 0x3F80u;  // bf16 1.0 = 0x3F80
}

// two int8 query values -> two bf16 lanes (exact: |v| <= 128 needs 8 bits)
__device__ __forceinline__ uint32_t bf16x2_from_s8x2(const int8_t* p) {
    return (__float_as_uint((float)p[0]) >> 16) |
           (__float_as_uint((float)p[1]) & 0xFFFF0000u);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT>
constexpr size_t smem_bytes() {
    // the word tile, query bits, then popcounts, cutoffs, counts and
    // per-warp maxima
    return (size_t)kWords * kTileCols * 4 + (size_t)MT * 16 * kQStride +
           (size_t)MT * 16 * 3 * 4 + (size_t)MT * 16 * kWarps * 4;
}

template <int MT, bool BF16, bool TVERSKY>
__global__ void __launch_bounds__(kThreads, 1) mxu_phase1_kernel(
    const uint32_t* __restrict__ words,    // (32, ld) planar, n columns read
    const int16_t* __restrict__ pops,      // (n,) column popcounts
    const int8_t* __restrict__ qbits,      // (b, 1024) word-major query bits
    const int32_t* __restrict__ qpops,     // (b,)
    const float* __restrict__ cutoffs,     // (b,)
    const float* __restrict__ alpha_beta,  // (2,) Tversky weights
    float* __restrict__ block_max,         // (b, n / block) out
    unsigned long long* __restrict__ counts,  // (b,) out, zeroed by the caller
    long long n, long long ld, int b, int block, long long n_valid,
    long long offset) {
    using Acc = typename std::conditional<BF16, float, int>::type;
    constexpr int kRows = MT * 16;
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_tile = reinterpret_cast<uint32_t*>(smem);  // kWords x kTileCols
    int8_t* s_q = reinterpret_cast<int8_t*>(s_tile + kWords * kTileCols);
    float* s_qpop = reinterpret_cast<float*>(s_q + kRows * kQStride);
    float* s_cut = s_qpop + kRows;
    unsigned* s_cnt = reinterpret_cast<unsigned*>(s_cut + kRows);
    float* s_wmax = reinterpret_cast<float*>(s_cnt + kRows);  // kRows x kWarps

    for (int i = threadIdx.x; i < kRows * (kBits / 4); i += kThreads) {
        const int r = i / (kBits / 4);
        const int c = i % (kBits / 4);
        const uint32_t v =
            r < b ? __ldg(reinterpret_cast<const uint32_t*>(qbits) +
                          (size_t)r * (kBits / 4) + c)
                  : 0u;
        reinterpret_cast<uint32_t*>(s_q + r * kQStride)[c] = v;
    }
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
        s_qpop[i] = i < b ? (float)qpops[i] : 0.f;
        s_cut[i] = i < b ? cutoffs[i] : INFINITY;  // a padded row counts nothing
        s_cnt[i] = 0u;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;  // mma groupID
    const int t = lane & 3;   // mma threadID_in_group
    const float alpha = alpha_beta[0];
    const float beta = alpha_beta[1];
    const long long n_tiles = (n + kTileCols - 1) / kTileCols;
    const long long n_blocks = n / block;
    const int rows_out = b < kRows ? b : kRows;

    static_assert(kThreads == kTileCols, "one thread per tile column");
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long base = tile * kTileCols;
        const long long col0 = base + (long long)warp * kWarpCols;
        __syncthreads();  // the previous tile's reads of s_tile are done
        {
            const long long c = base + threadIdx.x;
            const uint32_t* src = words + c;
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
                s_tile[w * kTileCols + threadIdx.x] =
                    c < n ? __ldg(src + (size_t)w * (size_t)ld) : 0u;
            }
        }
        __syncthreads();
        Acc acc[MT][kNT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll 1
        for (int w = 0; w < kWords; ++w) {
            uint32_t x[kNT];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
                x[nt] = s_tile[w * kTileCols + warp * kWarpCols + nt * 8 + g];
            }
            if constexpr (!BF16) {
                uint32_t b0[kNT], b1[kNT];
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                    b0[nt] = expand4_s8((x[nt] >> (4 * t)) & 0xFu);
                    b1[nt] = expand4_s8((x[nt] >> (16 + 4 * t)) & 0xFu);
                }
                const int8_t* qa = s_q + g * kQStride + w * 32 + 4 * t;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int8_t* q = qa + mt * 16 * kQStride;
                    const uint32_t a[4] = {
                        *reinterpret_cast<const uint32_t*>(q),
                        *reinterpret_cast<const uint32_t*>(q + 8 * kQStride),
                        *reinterpret_cast<const uint32_t*>(q + 16),
                        *reinterpret_cast<const uint32_t*>(q + 8 * kQStride + 16)};
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) {
                        mma_s8(acc[mt][nt], a, b0[nt], b1[nt]);
                    }
                }
            } else {
#pragma unroll
                for (int h = 0; h < 2; ++h) {  // bits 0-15, then 16-31
                    uint32_t b0[kNT], b1[kNT];
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) {
                        const uint32_t v = x[nt] >> (16 * h + 2 * t);
                        b0[nt] = expand2_bf16(v & 3u);
                        b1[nt] = expand2_bf16((v >> 8) & 3u);
                    }
                    const int8_t* qa = s_q + g * kQStride + w * 32 + 16 * h + 2 * t;
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        const int8_t* q = qa + mt * 16 * kQStride;
                        const uint32_t a[4] = {
                            bf16x2_from_s8x2(q), bf16x2_from_s8x2(q + 8 * kQStride),
                            bf16x2_from_s8x2(q + 8),
                            bf16x2_from_s8x2(q + 8 * kQStride + 8)};
#pragma unroll
                        for (int nt = 0; nt < kNT; ++nt) {
                            mma_bf16(acc[mt][nt], a, b0[nt], b1[nt]);
                        }
                    }
                }
            }
        }

        // this thread's accumulator columns: col0 + nt*8 + 2t + e
        float pop[kNT][2];
        bool in_array[kNT][2];
        bool valid[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const long long c = col0 + nt * 8 + 2 * t + e;
                in_array[nt][e] = c < n;
                valid[nt][e] = c < n && offset + c < n_valid;
                pop[nt][e] = c < n ? (float)__ldg(pops + c) : 0.f;
            }

#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {  // rows g, then g + 8
                const int r = mt * 16 + g + 8 * hf;
                const float qpop = s_qpop[r];
                const float cut = s_cut[r];
                int cnt = 0;
                float m[kNT];
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                    m[nt] = -INFINITY;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float cf = (float)acc[mt][nt][2 * hf + e];
                        const float dp = pop[nt][e];
                        float denom;
                        float s;
                        if (TVERSKY) {
                            denom = __fadd_rn(
                                __fadd_rn(__fmul_rn(alpha, __fsub_rn(qpop, cf)),
                                          __fmul_rn(beta, __fsub_rn(dp, cf))),
                                cf);
                            s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1e-30f)) : 0.f;
                        } else {
                            denom = __fsub_rn(__fadd_rn(qpop, dp), cf);
                            s = denom > 0.f ? __fdiv_rn(cf, fmaxf(denom, 1.f)) : 0.f;
                        }
                        if (cf == denom && denom > 0.f) s = 1.f;  // self-match pin
                        if (!valid[nt][e]) s = -INFINITY;
                        if (in_array[nt][e] && s >= cut) ++cnt;
                        m[nt] = fmaxf(m[nt], s);
                    }
                    // the group's four lanes hold the n8 tile's 8 columns
                    m[nt] = fmaxf(m[nt], __shfl_xor_sync(0xffffffffu, m[nt], 1));
                    m[nt] = fmaxf(m[nt], __shfl_xor_sync(0xffffffffu, m[nt], 2));
                }
                cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
                cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
                if (t == 0) {
                    if (cnt) atomicAdd(s_cnt + r, (unsigned)cnt);
                    float run = m[0];
#pragma unroll
                    for (int nt = 1; nt < kNT; ++nt) run = fmaxf(run, m[nt]);
                    s_wmax[r * kWarps + warp] = run;
                }
            }

        // per-warp maxima -> one maximum per selection block of the tile
        __syncthreads();
        const int warps_per_block = block / kWarpCols;
        const int groups = kTileCols / block;
        for (int i = threadIdx.x; i < rows_out * groups; i += kThreads) {
            const int q = i / groups;
            const int gi = i % groups;
            float mm = -INFINITY;
            for (int k = 0; k < warps_per_block; ++k) {
                mm = fmaxf(mm, s_wmax[q * kWarps + gi * warps_per_block + k]);
            }
            const long long j = tile * groups + gi;
            if (j < n_blocks) block_max[(size_t)q * (size_t)n_blocks + j] = mm;
        }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < rows_out; q += kThreads) {
        if (s_cnt[q]) atomicAdd(counts + q, (unsigned long long)s_cnt[q]);
    }
}

template <int MT, bool BF16, bool TVERSKY>
cudaError_t launch(const void* words, const void* pops, const void* qbits,
                   const void* qpops, const void* cutoffs,
                   const void* alpha_beta, void* block_max, void* counts,
                   long long n, long long ld, int b, int block,
                   long long n_valid, long long offset, cudaStream_t stream) {
    auto kernel = mxu_phase1_kernel<MT, BF16, TVERSKY>;
    constexpr size_t smem = smem_bytes<MT>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int device = 0;
    int sms = 0;
    int per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess) {
        return err;
    }
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
        return err;
    }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long tiles = (n + kTileCols - 1) / kTileCols;
    const long long resident = (long long)sms * per_sm;
    const dim3 grid((unsigned)(tiles < resident ? tiles : resident));
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(words), static_cast<const int16_t*>(pops),
        static_cast<const int8_t*>(qbits), static_cast<const int32_t*>(qpops),
        static_cast<const float*>(cutoffs), static_cast<const float*>(alpha_beta),
        static_cast<float*>(block_max), static_cast<unsigned long long*>(counts),
        n, ld, b, block, n_valid, offset);
    return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mt(bool bf16, bool tversky, const void* words,
                      const void* pops, const void* qbits, const void* qpops,
                      const void* cutoffs, const void* alpha_beta,
                      void* block_max, void* counts, long long n, long long ld,
                      int b, int block, long long n_valid, long long offset,
                      cudaStream_t s) {
#define GPUSIM_ARGS                                                          \
    words, pops, qbits, qpops, cutoffs, alpha_beta, block_max, counts, n, ld, \
        b, block, n_valid, offset, s
    if (bf16) {
        return tversky ? launch<MT, true, true>(GPUSIM_ARGS)
                       : launch<MT, true, false>(GPUSIM_ARGS);
    }
    return tversky ? launch<MT, false, true>(GPUSIM_ARGS)
                   : launch<MT, false, false>(GPUSIM_ARGS);
#undef GPUSIM_ARGS
}

}  // namespace

// Launches phase 1 on `stream` for b <= 128 queries over the first n columns
// of a planar 32-word store with row stride ld. qbits must be 4-byte
// aligned; block must be a power of two from 64 to 256 that divides n.
// int8_mxu selects int8 (else bf16) tensor-core products. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gpusim_mxu_phase1(
    const void* words, const void* pops, const void* qbits, const void* qpops,
    const void* cutoffs, const void* alpha_beta, void* block_max, void* counts,
    long long n, long long ld, int b, int block, long long n_valid,
    long long offset, int tversky, int int8_mxu, void* stream) {
    if (n <= 0 || ld < n || b <= 0 || b > kMaxQueries || block < kMinBlock ||
        block > kTileCols || (block & (block - 1)) || n % block ||
        reinterpret_cast<uintptr_t>(qbits) % 4) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool bf16 = int8_mxu == 0;
    const bool tv = tversky != 0;
#define GPUSIM_CASE(MT)                                                      \
    return (int)launch_mt<MT>(bf16, tv, words, pops, qbits, qpops, cutoffs,  \
                              alpha_beta, block_max, counts, n, ld, b, block, \
                              n_valid, offset, s);
    if (b <= 16) {
        GPUSIM_CASE(1)
    } else if (b <= 32) {
        GPUSIM_CASE(2)
    } else if (b <= 64) {
        GPUSIM_CASE(4)
    } else {
        GPUSIM_CASE(8)
    }
#undef GPUSIM_CASE
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
