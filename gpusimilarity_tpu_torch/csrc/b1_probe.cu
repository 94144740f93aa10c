// Instruction rates the data sheet does not give, for Hopper (sm_90a).
//
// The phase-1 kernels are bound by how fast the card executes a handful of
// integer instructions, and the H100's data sheet lists a rate for none of
// them. Each loop below keeps independent chains of one instruction in
// registers, so the time of a launch over its instruction count is that
// instruction's rate with every SM busy:
//   0  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (the binary
//      tensor-core product: 16 x 8 AND-popcounts over 256 bits)
//   1  popc.b32
//   2  lop3.b32 (one three-input logic op: a carry-save adder is two)
//   3  mad.lo.s32
//   4  div.rn.f32 (the correctly rounded divide of the scores)
// tools/probe_b1.py times the launches and prints the rates; the kernels'
// bounds (tools/probe_mxu.py) use the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int WHAT>
__global__ void __launch_bounds__(256) rate_kernel(long long iters,
                                                   uint32_t seed,
                                                   uint32_t* __restrict__ out) {
    const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t x[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = seed * (tid + 1) + 0x9E3779B9u * c;
    uint32_t acc = 0;
    if (WHAT == 0) {
        int d[kChains][4];
        uint32_t a[4] = {x[0], x[1], x[2], x[3]};
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
#pragma unroll
            for (int i = 0; i < 4; ++i) d[c][i] = 0;
        }
        for (long long it = 0; it < iters; ++it) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) mma_b1(d[c], a, x[c], x[(c + 1) % kChains]);
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc += (uint32_t)d[c][i];
        }
    } else if (WHAT == 4) {
        float f[kChains];
#pragma unroll
        for (int c = 0; c < kChains; ++c) f[c] = (float)(x[c] & 1023u) + 1.f;
        const float den = (float)(seed & 7u) + 1.0009765625f;
        for (long long it = 0; it < iters; ++it) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) f[c] = __fdiv_rn(f[c], den) + 1.f;
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) acc += __float_as_uint(f[c]);
    } else {
        const uint32_t k = seed | 1u;
        for (long long it = 0; it < iters; ++it) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
                if (WHAT == 1) {
                    // popc, then one add to keep the chain from folding
                    asm volatile("popc.b32 %0, %1;" : "=r"(x[c]) : "r"(x[c] + k));
                } else if (WHAT == 2) {
                    asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                                 : "+r"(x[c]) : "r"(k), "r"((uint32_t)it));
                } else {
                    asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                                 : "+r"(x[c]) : "r"(k), "r"((uint32_t)it));
                }
            }
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) acc += x[c];
    }
    if (acc == 0x12345678u) out[0] = acc;  // keeps the loops alive
}

}  // namespace

// Launches `blocks` blocks of 256 threads, each thread running `iters`
// rounds of 8 independent instructions of kind `what`. Instructions per
// launch: blocks * 256 * iters * 8 per thread (the mma is one instruction
// per warp: blocks * 8 * iters * 8). Kind 1 runs one add beside each popc.
extern "C" int gpusim_b1_probe(int what, long long iters, int blocks,
                               void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint32_t* o = static_cast<uint32_t*>(out);
    switch (what) {
        case 0: rate_kernel<0><<<blocks, 256, 0, s>>>(iters, 12345u, o); break;
        case 1: rate_kernel<1><<<blocks, 256, 0, s>>>(iters, 12345u, o); break;
        case 2: rate_kernel<2><<<blocks, 256, 0, s>>>(iters, 12345u, o); break;
        case 3: rate_kernel<3><<<blocks, 256, 0, s>>>(iters, 12345u, o); break;
        case 4: rate_kernel<4><<<blocks, 256, 0, s>>>(iters, 12345u, o); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* gpusim_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
