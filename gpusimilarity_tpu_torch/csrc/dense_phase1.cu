// Phase 1 of the dense (word-planar) similarity scan, for Hopper (sm_90a).
//
// Replaces gpusimilarity_tpu/ops/pallas_scan.py::_phase1_kernel. The store
// holds each library row's wf packed words planar, words[i][col] for word i,
// column stride 1 and row stride ld. For a batch of b queries it computes
//   * block_max[q][j]: the best Tanimoto or Tversky score over columns
//     [j*block, (j+1)*block) (-inf for columns >= n_valid), and
//   * counts[q]: the number of valid columns scoring >= cutoffs[q].
// In popless mode (pops == NULL) each column's popcount is recomputed from
// its words.
//
// Selection block width. The engine scans with block = 256 columns, the
// TPU kernel's 32768/128. At 1.02B rows, B = 32 and k_fetch = 2048 that is
// 510 MB of block maxima and 524,288 columns rescored per query in phase 2;
// a 2048-column block would cut the maxima to 64 MB but send 4.2M columns
// per query through the plain-tensor rescore, 8x the phase-2 bytes and
// ops, which at B = 32 would cost about as much as the scan itself. The
// width is an argument (a power of two, 8 to 256: a block is whole 8-column
// tiles of the product), so the tests can use narrow blocks.
//
// What bounds it. Per column it reads wf words (4 B each) and, unless
// popless, a 2-byte popcount: 34 B per row at wf = 8, 10.4 ms at 1.02B rows
// on an H100 (3.35 TB/s). The work per (query, column) is one 32*wf-bit
// AND-popcount and one score. As scalar code that is wf popc (a quarter-rate
// instruction on sm_90: 4.1e12 a second measured, tools/probe_b1.py), a
// convert, a correctly rounded divide (1.9e12 a second), a ballot and five
// shuffles, which held the first version of this kernel at 14x its byte
// bound at b = 32. The card's binary tensor-core product does the
// AND-popcount outright: mma.sync.m16n8k256.b1.b1.s32.and.popc, 16 queries
// x 8 columns x 256 bits an instruction, measured at 9.2e15 bit operations a
// second (1.8 ms for b = 32 at 1.02B rows of 256 bits). What is left is the
// score, so the epilogue is integer (phase1_epilogue.cuh): no divide,
// convert, ballot or shuffle per (query, column) for Tanimoto.
//
// The product. A fold-4 row is 256 bits, one k step. With g = lane >> 2 and
// t = lane & 3 the B fragment of an 8-column tile at col0 is
// words[8*ks + t][col0 + g] and
// words[8*ks + t + 4][col0 + g] of the planar store as it is (no transpose,
// no second copy); the A fragment is the same two words of queries g and
// g + 8, loaded once per thread for the whole launch; D holds queries g and
// g + 8 at columns col0 + 2t and col0 + 2t + 1. wf = 16/32/64 are 2/4/8
// accumulating k steps, a wf that is no multiple of 8 pads k with zero words,
// and a batch that is no multiple of 16 pads with zero queries whose outputs
// are never written. At most 32 queries (two m tiles) run per launch of the
// kernel; the C entry point walks a larger batch in slices (the cutoff table
// of a slice has to fit in shared memory beside the stages).
//   Staging: a persistent grid, one block per SM; each WARP owns whole
//   selection blocks and walks them in sub-tiles of 1024 words (wf planes x
//   128 columns at wf = 8), which it copies itself into its own two
//   shared-memory stages with 16-byte cp.async, the next sub-tile in flight
//   while this one is multiplied and scored. A warp synchronises with no
//   other warp. Global reads are whole 512-byte runs of a plane; the plane
//   stride in shared memory is padded by 8 words so the 32 lanes of a
//   fragment load fall in 32 banks.
//   Epilogue: per query it holds, a thread keeps the running rational
//   maximum (num, den) of its columns across the selection block and the
//   four lanes of a group merge once per block (two shuffles of two words),
//   then one divide per (query, block). The >= cutoff test is c >= cmin[pop]
//   from a per-query table in shared memory, built in the kernel's prologue
//   with the plain version's divide; the count stays in a register for the
//   whole launch and ends in one shuffle reduce, one shared-memory atomic per
//   warp and one 64-bit atomic per block and query: order-free, so
//   deterministic. Tversky keeps the rounded float score per column (its
//   weights are floats) but gains the product and the per-block reduce.
//   Popless: the warp counts each staged column's bits once per sub-tile.
//
// b <= 8 scores only rows 0..7 of the single m tile; that reads faster at
// b = 1 than one thread per column with wf popc, the kernel's first version.
//
// Not carried over from the TPU kernel: the sequential grid's carried count
// scratch (GPU blocks run in any order), the 128-lane count accumulator,
// the VMEM chunking and the Mosaic int16 -> int32 cast hop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase1_epilogue.cuh"

namespace {

using gpusim::RationalMax;

struct Args {
    const uint32_t* words;
    const int16_t* pops;
    const uint32_t* queries;
    const int32_t* qpops;
    const float* cutoffs;
    const float* alpha_beta;
    float* block_max;
    unsigned long long* counts;
    long long n, ld;
    int wf, b, block;
    long long n_valid;
    bool tversky;
    cudaStream_t stream;
};

constexpr int kStageWords = 1024;  // payload words of one stage: 8*KS planes x SC columns
constexpr int kPlanePad = 8;       // words added to the shared-memory plane stride
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// bytes of one stage: the padded word tile, then the columns' popcounts
template <int KS>
__host__ __device__ constexpr int stage_bytes() {
    constexpr int sc = kStageWords / (8 * KS);
    return 8 * KS * (sc + kPlanePad) * 4 + sc * 2;
}

// shared-memory row stride of the cutoff table, in entries: bits + 1, even
__host__ __device__ constexpr int table_stride(int wf) { return (32 * wf + 2) & ~1; }

// KS k steps of 256 bits, MT m tiles of 16 query rows, HR = 1 when only rows
// 0..7 of the (single) m tile hold queries (b <= 8), else 2
template <int KS, int MT, int HR, bool TVERSKY, bool POPLESS>
__global__ void __launch_bounds__(512, 1) dense_phase1_mma_kernel(
    const uint32_t* __restrict__ words, const int16_t* __restrict__ pops,
    const uint32_t* __restrict__ queries, const int32_t* __restrict__ qpops,
    const float* __restrict__ cutoffs, const float* __restrict__ alpha_beta,
    float* __restrict__ block_max, unsigned long long* __restrict__ counts,
    long long n, long long ld, int wf, int b, int block, long long n_valid,
    int aligned16) {
    constexpr int kRows = 16 * MT;             // query rows of the product
    constexpr int kPlanes = 8 * KS;            // k words, wf padded up
    constexpr int SC = kStageWords / kPlanes;  // columns of a sub-tile
    constexpr int kStride = SC + kPlanePad;    // shared-memory plane stride, words
    constexpr int kStage = stage_bytes<KS>();

    extern __shared__ __align__(16) unsigned char smem[];
    const int bits = 32 * wf;
    const int ts = table_stride(wf);
    const int table_bytes = TVERSKY ? 0 : ((kRows * ts * 2 + 15) & ~15);
    uint16_t* s_cmin = reinterpret_cast<uint16_t*>(smem);
    unsigned long long* s_cnt =
        reinterpret_cast<unsigned long long*>(smem + table_bytes);  // kRows
    unsigned char* s_stages = smem + table_bytes + kRows * 8;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    unsigned char* my_stages = s_stages + (size_t)warp * 2 * kStage;

    // zero both stages once: planes >= wf and the pad stay zero for the launch
    for (int i = lane; i < 2 * kStage / 4; i += 32) {
        reinterpret_cast<uint32_t*>(my_stages)[i] = 0u;
    }
    if (!TVERSKY) {
        gpusim::build_cmin_table(s_cmin, kRows, ts, bits, qpops, cutoffs, b);
    }
    for (int i = threadIdx.x; i < kRows; i += blockDim.x) s_cnt[i] = 0ull;

    // A fragments and the metadata of the queries this thread scores:
    // rows g and g + 8 of every m tile
    uint32_t a[MT][KS][4];
    int qpop_i[MT][2];
    int qden[MT][2];  // max(qpop, 1), the Tanimoto denominator's query term
    float qpop_f[MT][2];
    float cut[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = mt * 16 + h * 8 + g;
            qpop_i[mt][h] = q < b ? qpops[q] : 0;
            qpop_f[mt][h] = (float)qpop_i[mt][h];
            qden[mt][h] = gpusim::tanimoto_qden(qpop_i[mt][h]);
            cut[mt][h] = q < b ? cutoffs[q] : INFINITY;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int w = ks * 8 + t + 4 * half;
                    a[mt][ks][2 * half + h] =
                        (q < b && w < wf) ? queries[(size_t)q * wf + w] : 0u;
                }
            }
        }
    }
    const float alpha = alpha_beta[0];
    const float beta = alpha_beta[1];
    __syncthreads();

    // this warp's work: units of max(block, SC) columns, round-robin over
    // every warp of the grid, each unit a run of SC-column sub-tiles
    const long long unit_cols = block > SC ? block : SC;
    const int subs_per_unit = (int)(unit_cols / SC);
    const long long n_units = (n + unit_cols - 1) / unit_cols;
    const long long gw = (long long)blockIdx.x * n_warps + warp;
    const long long total_warps = (long long)gridDim.x * n_warps;
    const long long my_units =
        gw < n_units ? (n_units - gw + total_warps - 1) / total_warps : 0;
    const long long total = my_units * subs_per_unit;
    const long long n_blocks = n / block;
    const int block_shift = __ffs(block) - 1;

    // the sub-tiles of this warp in order: each call gives the next one's
    // first column
    long long walk_unit = gw;
    int walk_sub = 0;
    auto next_col0 = [&]() {
        const long long c0 = walk_unit * unit_cols + (long long)walk_sub * SC;
        if (++walk_sub == subs_per_unit) {
            walk_sub = 0;
            walk_unit += total_warps;
        }
        return c0;
    };

    // copy the sub-tile at c0 into stage `buf`: 16-byte cp.async when every
    // address is 16-byte aligned and the sub-tile lies inside the array, else
    // plain loads with the columns past n zero-filled
    auto stage_in = [&](long long c0, int buf) {
        uint32_t* sw = reinterpret_cast<uint32_t*>(my_stages + (size_t)buf * kStage);
        int16_t* sp = reinterpret_cast<int16_t*>(sw + kPlanes * kStride);
        if (c0 < n) {
            if (aligned16 && c0 + SC <= n) {
                constexpr int kChunks = SC / 4;  // 16-byte chunks of one plane run
                for (int i = lane; i < wf * kChunks; i += 32) {
                    const int r = i / kChunks;
                    const int ch = i - r * kChunks;
                    cp_async16(sw + r * kStride + 4 * ch,
                               words + (size_t)r * (size_t)ld + c0 + 4 * ch);
                }
                if (!POPLESS && lane < SC / 8) {
                    cp_async16(sp + 8 * lane, pops + c0 + 8 * lane);
                }
            } else {
                for (int i = lane; i < wf * SC; i += 32) {
                    const int r = i / SC;
                    const int c = i - r * SC;
                    sw[r * kStride + c] =
                        c0 + c < n ? __ldg(words + (size_t)r * (size_t)ld + c0 + c) : 0u;
                }
                if (!POPLESS) {
                    for (int c = lane; c < SC; c += 32) {
                        sp[c] = c0 + c < n ? __ldg(pops + c0 + c) : (int16_t)0;
                    }
                }
            }
        }
        cp_async_commit();
    };

    // running maxima per query row and per column of the thread's pair (two
    // independent chains), merged when a selection block ends
    RationalMax best[MT][HR][2];
    float fbest[MT][HR][2];
    int cnt[MT][HR];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < HR; ++h) {
            cnt[mt][h] = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                best[mt][h][e].reset();
                fbest[mt][h][e] = -INFINITY;
            }
        }
    }

    long long c0_next = 0;
    if (total > 0) {
        c0_next = next_col0();
        stage_in(c0_next, 0);
    }
    for (long long i = 0; i < total; ++i) {
        const int buf = (int)(i & 1);
        const long long c0 = c0_next;
        if (i + 1 < total) {
            c0_next = next_col0();
            stage_in(c0_next, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncwarp();
        const uint32_t* sw =
            reinterpret_cast<const uint32_t*>(my_stages + (size_t)buf * kStage);
        int16_t* sp = reinterpret_cast<int16_t*>(
            my_stages + (size_t)buf * kStage + kPlanes * kStride * 4);
        if (POPLESS) {
            for (int c = lane; c < SC; c += 32) {
                int p = 0;
                for (int r = 0; r < wf; ++r) p += __popc(sw[r * kStride + c]);
                sp[c] = (int16_t)p;
            }
            __syncwarp();
        }

        const long long tiles_left = (n - c0) >> 3;  // n is a multiple of 8
        const int nt_end = tiles_left < SC / 8 ? (int)tiles_left : SC / 8;
#pragma unroll 2
        for (int nt = 0; nt < nt_end; ++nt) {
            const long long col0 = c0 + 8 * nt;
            int d[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) d[mt][e] = 0;
            }
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const uint32_t b0 = sw[(8 * ks + t) * kStride + 8 * nt + g];
                const uint32_t b1 = sw[(8 * ks + t + 4) * kStride + 8 * nt + g];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_b1(d[mt], a[mt][ks], b0, b1);
            }
            // popcounts of this thread's two columns, col0 + 2t and + 2t + 1
            const uint32_t pp = *reinterpret_cast<const uint32_t*>(sp + 8 * nt + 2 * t);
            const int pop[2] = {(int)(pp & 0xFFFFu), (int)(pp >> 16)};
            const long long left = n_valid - (col0 + 2 * t);  // valid iff e < left
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool valid = e < left;
                if (TVERSKY) {
                    const float pf = (float)pop[e];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                        for (int h = 0; h < HR; ++h) {
                            float s = gpusim::tversky_score(
                                (float)d[mt][2 * h + e], qpop_f[mt][h], pf, alpha, beta);
                            if (!valid) s = -INFINITY;
                            fbest[mt][h][e] = fmaxf(fbest[mt][h][e], s);
                            cnt[mt][h] += s >= cut[mt][h] ? 1 : 0;
                        }
                    }
                } else {
                    const uint16_t* cmin = s_cmin + gpusim::table_pop(pop[e], bits);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                        for (int h = 0; h < HR; ++h) {
                            const int c = valid ? d[mt][2 * h + e] : -1;
                            best[mt][h][e].offer(
                                c, gpusim::tanimoto_den(qden[mt][h], pop[e],
                                                        d[mt][2 * h + e]));
                            cnt[mt][h] += c >= (int)cmin[(mt * 16 + h * 8 + g) * ts] ? 1 : 0;
                        }
                    }
                }
            }

            if (((col0 + 8) & (block - 1)) == 0) {
                // a selection block ends: merge the thread's two columns and
                // the group's four lanes, divide once, write
                const long long j = col0 >> block_shift;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                    for (int h = 0; h < HR; ++h) {
                        float s;
                        if (TVERSKY) {
                            s = fmaxf(fbest[mt][h][0], fbest[mt][h][1]);
                            s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 1));
                            s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 2));
                            fbest[mt][h][0] = fbest[mt][h][1] = -INFINITY;
                        } else {
                            RationalMax& r = best[mt][h][0];
                            r.offer(best[mt][h][1].num, best[mt][h][1].den);
#pragma unroll
                            for (int off = 1; off <= 2; off <<= 1) {
                                const int on = __shfl_xor_sync(0xffffffffu, r.num, off);
                                const int od = __shfl_xor_sync(0xffffffffu, r.den, off);
                                r.offer(on, od);
                            }
                            s = r.score();
                            r.reset();
                            best[mt][h][1].reset();
                        }
                        const int q = mt * 16 + h * 8 + g;
                        if (t == 0 && q < b) {
                            block_max[(size_t)q * (size_t)n_blocks + j] = s;
                        }
                    }
                }
            }
        }
        __syncwarp();  // every lane is done with this stage before it is refilled
    }

    // counts: the group's four lanes, then the block, then one atomic a query
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < HR; ++h) {
            int c = cnt[mt][h];
            c += __shfl_xor_sync(0xffffffffu, c, 1);
            c += __shfl_xor_sync(0xffffffffu, c, 2);
            if (t == 0 && c) {
                atomicAdd(s_cnt + mt * 16 + h * 8 + g, (unsigned long long)c);
            }
        }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < b; q += blockDim.x) {
        if (s_cnt[q]) atomicAdd(counts + q, s_cnt[q]);
    }
}

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

template <int KS, int MT, int HR>
cudaError_t launch_mma(const Args& a) {
    constexpr int SC = kStageWords / (8 * KS);
    // 16 warps a block where the stages leave room, 8 for the wide stores
    const int n_warps = KS <= 2 ? 16 : 8;
    const size_t table = a.tversky ? 0 : (((size_t)16 * MT * table_stride(a.wf) * 2 + 15) & ~(size_t)15);
    const size_t smem = table + 16 * MT * 8 + (size_t)n_warps * 2 * stage_bytes<KS>();
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    const bool popless = a.pops == nullptr;
    auto* kernel = dense_phase1_mma_kernel<KS, MT, HR, false, false>;
    if (a.tversky) {
        kernel = popless ? dense_phase1_mma_kernel<KS, MT, HR, true, true>
                         : dense_phase1_mma_kernel<KS, MT, HR, true, false>;
    } else if (popless) {
        kernel = dense_phase1_mma_kernel<KS, MT, HR, false, true>;
    }
    // The attribute and the launch below apply to the thread's current
    // device; the Python wrapper makes that the tensors' device.
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long unit_cols = a.block > SC ? a.block : SC;
    const long long n_units = (a.n + unit_cols - 1) / unit_cols;
    const long long want = (n_units + n_warps - 1) / n_warps;
    const int grid = (int)(want < sm_count() ? want : sm_count());
    const int aligned16 =
        reinterpret_cast<uintptr_t>(a.words) % 16 == 0 && a.ld % 4 == 0 &&
        (popless || reinterpret_cast<uintptr_t>(a.pops) % 16 == 0);
    kernel<<<grid, 32 * n_warps, smem, a.stream>>>(
        a.words, a.pops, a.queries, a.qpops, a.cutoffs, a.alpha_beta, a.block_max,
        a.counts, a.n, a.ld, a.wf, a.b, a.block, a.n_valid, aligned16);
    return cudaGetLastError();
}

template <int KS>
cudaError_t launch_mma_slices(Args a, int max_queries) {
    // the kernel takes at most max_queries queries: walk the batch in slices
    // (block_max rows keep their stride n / block, so a slice is an offset)
    const int b = a.b;
    const long long n_blocks = a.n / a.block;
    for (int q0 = 0; q0 < b; q0 += max_queries) {
        Args s = a;
        s.b = b - q0 < max_queries ? b - q0 : max_queries;
        s.queries = a.queries + (size_t)q0 * a.wf;
        s.qpops = a.qpops + q0;
        s.cutoffs = a.cutoffs + q0;
        s.block_max = a.block_max + (size_t)q0 * (size_t)n_blocks;
        s.counts = a.counts + q0;
        cudaError_t err;
        if (s.b <= 8) {
            err = launch_mma<KS, 1, 1>(s);
        } else if (KS == 8 || s.b <= 16) {
            err = launch_mma<KS, 1, 2>(s);
        } else {
            err = launch_mma<KS, KS == 8 ? 1 : 2, 2>(s);
        }
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// The queries one launch takes at rows of wf words: 32, and 16 at 2048-bit
// rows, where a 32-query cutoff table would not fit beside the stages.
// ops/dense_phase1.py counts launches with the same numbers
// (KERNEL_MAX_QUERIES, KERNEL_MAX_QUERIES_WIDE) and checks them against
// gpusim_dense_phase1_max_queries.
int max_queries(int wf) { return wf <= 32 ? 32 : 16; }

cudaError_t launch_mma_any(const Args& a) {
    const int mq = max_queries(a.wf);
    if (a.wf <= 8) return launch_mma_slices<1>(a, mq);
    if (a.wf <= 16) return launch_mma_slices<2>(a, mq);
    if (a.wf <= 32) return launch_mma_slices<4>(a, mq);
    return launch_mma_slices<8>(a, mq);
}

}  // namespace

// The queries one kernel launch takes at rows of wf words; a batch of b
// queries is ceil(b / this) launches.
extern "C" int gpusim_dense_phase1_max_queries(int wf) { return max_queries(wf); }

// Launches phase 1 on `stream` for b queries of wf words over the first n
// columns of a planar store with row stride ld; pops may be NULL (popless).
// block must be a power of two, 8 to 256, that divides n. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gpusim_dense_phase1(
    const void* words, const void* pops, const void* queries,
    const void* qpops, const void* cutoffs, const void* alpha_beta,
    void* block_max, void* counts, long long n, long long ld, int wf, int b,
    int block, long long n_valid, int tversky, void* stream) {
    if (n <= 0 || ld < n || wf <= 0 || wf > 64 || b <= 0 || block < 8 ||
        block > 256 || (block & (block - 1)) || n % block) {
        return (int)cudaErrorInvalidValue;
    }
    const Args a = {
        static_cast<const uint32_t*>(words), static_cast<const int16_t*>(pops),
        static_cast<const uint32_t*>(queries), static_cast<const int32_t*>(qpops),
        static_cast<const float*>(cutoffs), static_cast<const float*>(alpha_beta),
        static_cast<float*>(block_max), static_cast<unsigned long long*>(counts),
        n, ld, wf, b, block, n_valid, tversky != 0,
        static_cast<cudaStream_t>(stream)};
    return (int)launch_mma_any(a);
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
