// Row staging for K1 (raycast_walls.cu) and K2 (progress_collision.cu), for
// NVIDIA Hopper (sm_90a).
//
// Each block serves one row. One thread issues 1-D bulk asynchronous copies
// (cp.async.bulk, the TMA's plain-copy form) of the row's fields into shared
// memory; they report their bytes to one mbarrier, which the block waits on once.
// No registers carry the data, and the block's warps load their own inputs while
// the row arrives. The other blocks resident on the SM overlap one block's copy
// with their compute: a block stages one row and is done, so its buffer is
// written once and no generic access ever precedes the copy into it.
//
// A bulk copy needs a 16-byte-aligned source and destination and a size that is a
// multiple of 16. A row of n floats starts 16-byte-aligned only when the field's
// base and n * row are, so each field of a row is copied in three parts: the
// head up to the first 16-byte boundary and the tail after the last one by
// ordinary loads of one warp's lanes, the aligned middle by one bulk copy.
// Element i of the row lands at stage_field + shift + i, where shift (0-3) is the
// source's offset from 16 bytes in floats, so that the middle is aligned on both
// sides. The head and tail become visible to the block at its next barrier.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace row_stage {

// floats the stage reserves per field: n floats at a shift of up to 3, rounded to
// 16 bytes (ops/_cuda.py:_field_capacity)
__host__ __device__ inline int field_capacity(int n) { return ((n + 3) / 4) * 4 + 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int shift_of(const float* src) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// one thread, before any other thread touches the barrier; the block then syncs
__device__ __forceinline__ void init_barrier(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// every thread of the block: until the row's copies have landed (the barrier's
// first phase, parity 0, completes)
__device__ __forceinline__ void wait_barrier(uint64_t* bar) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr) : "memory");
    }
}

// Called by the threads of one warp: row `row` (n floats) of each of the
// `num_fields` fields into the stage at `dst` (field f at dst + f * cap, cap at
// least field_capacity(n)), completing on `bar`. The warp's lanes copy the heads
// and tails; lane 0 issues the bulk copies.
__device__ __forceinline__ void stage_row(float* dst, const float* const* fields,
                                          int num_fields, size_t row, int n, int cap,
                                          uint64_t* bar) {
    const int lane = threadIdx.x & 31;
    uint32_t bytes = 0;
    for (int f = 0; f < num_fields; ++f) {
        const float* src = fields[f] + row * (size_t)n;
        const int shift = shift_of(src);
        const int head = min((4 - shift) & 3, n);
        const int mid = ((n - head) / 4) * 4;
        float* out = dst + f * cap + shift;
        bytes += 4u * mid;
        for (int i = lane; i < n - mid; i += 32) {
            const int e = i < head ? i : i + mid;
            out[e] = src[e];
        }
    }
    if (lane != 0) return;
    const uint32_t bar_addr = smem_addr(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar_addr), "r"(bytes) : "memory");
    for (int f = 0; f < num_fields; ++f) {
        const float* src = fields[f] + row * (size_t)n;
        const int shift = shift_of(src);
        const int head = min((4 - shift) & 3, n);
        const int mid = ((n - head) / 4) * 4;
        if (mid == 0) continue;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(dst + f * cap + shift + head)), "l"(src + head),
               "r"(4u * mid), "r"(bar_addr)
            : "memory");
    }
}

// the row a block stages: row_ids[row] where the caller reads a resident pool by
// row ids (the capacity layouts), else the block's own row
__device__ __forceinline__ size_t source_row(const int* row_ids, size_t row) {
    return row_ids ? static_cast<size_t>(row_ids[row]) : row;
}

// where element 0 of row `row` of a field sits in its stage
__device__ __forceinline__ const float* staged(const float* stage_field, const float* field,
                                               size_t row, int n) {
    return stage_field + shift_of(field + row * (size_t)n);
}

// Host side: lets `kernel` take `smem` bytes of dynamic shared memory where that is
// over the default 48 KB (the launch plan has checked it against the 227 KB a
// block may take). The main paths' rows need 4-18 KB and never call the runtime.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace row_stage
