// K7: sort-free pseudorandom permutations of [0, n), for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's mixbits_permutation, self_play_racing_tpu/ops/prng.py,
// which XLA fuses on the TPU. Same bijection: for n = 2^k, with mask = n - 1 and
// shift = max(1, k / 2), four rounds of
//   x = (x * (a | 1) + c) & mask      (odd multiplier: a bijection mod 2^k)
//   x = x ^ (x >> shift)              (triangular xorshift: a bijection)
// in uint32 arithmetic, which wraps natively here. The round constants (a, c) come
// from the host, eight per permutation, so one launch builds every epoch's (and
// every shard's) permutation, and the plain PyTorch version and the JAX package can
// be fed the same constants.
//
// Bound on an H100 SXM: at the main path's shapes (10 epochs x 16,384 block units)
// it writes 655 KB of int32 and reads 320 B of constants, about 0.2 us at
// 3.35 TB/s; its 15 integer operations per index are nothing. A launch costs more
// than that, so the kernel is launch-bound whatever its form.
//
// Design: one thread per output index over all permutations; the constants are
// read through the read-only cache (every thread of a permutation reads the same
// eight), and the stores are coalesced.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mixbits_permutation_kernel(
        const long long* __restrict__ consts, int* __restrict__ out,
        long long total, int log2_n) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const long long perm = idx >> log2_n;
    const uint32_t mask = (uint32_t)((1ull << log2_n) - 1ull);
    const int shift = log2_n / 2 > 1 ? log2_n / 2 : 1;
    uint32_t x = (uint32_t)idx & mask;
    const long long* c = consts + perm * 2 * kRounds;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const uint32_t a = (uint32_t)__ldg(c + 2 * r) | 1u;
        const uint32_t b = (uint32_t)__ldg(c + 2 * r + 1);
        x = (x * a + b) & mask;
        x = x ^ (x >> shift);
    }
    out[idx] = (int)x;
}

}  // namespace

// consts [num_perms, 8] int64 holding uint32 values; out [num_perms, 2^log2_n]
// int32. Returns a cudaError_t (0 on success).
extern "C" int mixbits_permutation_i32(const long long* consts, int* out, int num_perms,
                                       int log2_n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)num_perms << log2_n;
    if (total == 0) return 0;
    const long long blocks = (total + kThreads - 1) / kThreads;
    mixbits_permutation_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        consts, out, total, log2_n);
    return (int)cudaGetLastError();
}

extern "C" const char* mixbits_permutation_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
