// The rates that bound the MLP kernels' products (csrc/mlp_towers.cu), measured by
// scripts/mlp_kernel_split.py --rates: mma.sync.m16n8k8 TF32 with float32
// accumulators issued back to back (8 independent accumulators a warp), the same
// with each B fragment split into TF32 hi and lo first (cvt.rna, sub, cvt.rna: the
// kernels' split at load), and float32 FFMA (16 independent chains a thread).
// The split three ways, bit for bit the same hi and lo: cvt.rna.tf32.f32; the same
// rounding on the integer view ((bits + 0x1000) & ~0x1fff, an IADD and a LOP3); and
// that for hi with lo left unrounded (the tensor cores read a TF32 operand's top 19
// bits). Each kernel runs `iters` rounds; the caller times it with CUDA events.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t rna_bits(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 8 mma a round, independent accumulators; kSplit: the B operand split a round first,
// 1 by cvt.rna, 2 by the integer rounding, 3 by it for hi alone
template <int kSplit>
__global__ void mma_kernel(float* out, int iters, float seed) {
    float acc[8][4] = {};
    uint32_t a[4];
    for (int i = 0; i < 4; ++i) a[i] = tf32(seed + threadIdx.x + i);
    float b = seed * threadIdx.x;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint32_t b0 = __float_as_uint(b + j), b1 = __float_as_uint(b - j);
            const float x0 = b + j;
            if (kSplit == 1) {
                b0 = tf32(x0);
                b1 = tf32(x0 - __uint_as_float(b0));
            } else if (kSplit == 2) {
                b0 = rna_bits(x0);
                b1 = rna_bits(x0 - __uint_as_float(b0));
            } else if (kSplit == 3) {
                b0 = rna_bits(x0);
                b1 = __float_as_uint(x0 - __uint_as_float(b0));
            }
            mma(acc[j], a, b0, b1);
        }
        b += 1.0f;
    }
    float s = 0.0f;
    for (int j = 0; j < 8; ++j)
        for (int e = 0; e < 4; ++e) s += acc[j][e];
    if (s == 1234.5f) out[threadIdx.x] = s;
}

// 16 independent FFMA chains a thread, 16 FFMA a round
__global__ void ffma_kernel(float* out, int iters, float seed) {
    float acc[16];
    for (int j = 0; j < 16; ++j) acc[j] = seed + j;
    const float m = 1.0f + seed * 1e-7f, c = seed;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = __fmaf_rn(acc[j], m, c);
    }
    float s = 0.0f;
    for (int j = 0; j < 16; ++j) s += acc[j];
    if (s == 1234.5f) out[threadIdx.x] = s;
}

}  // namespace

// kind 0: mma, 1: mma with the B split by cvt.rna, 2: FFMA, 3: the split on the
// integer view, 4: hi alone rounded; blocks of `threads`. Returns a cudaError_t.
extern "C" int rate_launch(int kind, int blocks, int threads, int iters, float* out,
                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0) mma_kernel<0><<<blocks, threads, 0, s>>>(out, iters, 1.0f);
    if (kind == 1) mma_kernel<1><<<blocks, threads, 0, s>>>(out, iters, 1.0f);
    if (kind == 2) ffma_kernel<<<blocks, threads, 0, s>>>(out, iters, 1.0f);
    if (kind == 3) mma_kernel<2><<<blocks, threads, 0, s>>>(out, iters, 1.0f);
    if (kind == 4) mma_kernel<3><<<blocks, threads, 0, s>>>(out, iters, 1.0f);
    return (int)cudaGetLastError();
}
