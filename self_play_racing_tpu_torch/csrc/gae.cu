// K6: generalized advantage estimation, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's reverse scan, self_play_racing_tpu/ops/gae.py
// (compute_gae), which XLA compiles into a loop on the TPU. Same semantics and the
// same floating-point order as the plain PyTorch version (ops/gae.py): for each env
// n, walking t = T-1 .. 0 with nt the nonterminal flag of step t (1 - next_done for
// the last step, 1 - dones[t + 1] otherwise) and v_next the value after step t,
//   delta = (r[t] + (g * nt) * v_next) - v[t]
//   adv   = delta + (gl * nt) * adv_next
//   ret   = adv + v[t]
// with g = f32(gamma) and gl = f32(gamma * lam) rounded on the host. Compiled with
// -fmad=false, so no product and sum contract into an FMA: the kernel's results
// are bitwise those of the plain version. The recurrence stays sequential per env,
// in the reference's order (the JAX package rejected an associative scan, which
// reassociates the sums).
//
// Bound on an H100 SXM (3.35 TB/s): at the main path's shapes (T = 256, N = 4096)
// it must read rewards, values (f32) and dones (bytes) and write advantages and
// returns (f32), 17 bytes per sample, 17.8 MB, about 5.3 us. Its 9 f32 operations
// per sample are nothing against 67 TFLOP/s. It is bound by bytes.
//
// Design: the previous kernel ran one thread per env in blocks of 32 threads,
// about one warp per SM at N = 4096, each keeping 16 steps of its own env in
// registers: far fewer bytes in flight than HBM needs. Here one block serves a
// tile of 16 envs and walks time downwards in chunks of 32 steps, its warps
// split into producers (4 warps) and a consumer (1 warp):
//   - the producers keep the next 3 chunks of rewards, values and dones in
//     flight in a ring of 4 shared-memory stages with 4-byte cp.async, issued from
//     t = T-1 downwards so the carry starts as soon as the last chunk lands (any
//     row alignment, so any N: the dones as each row's whole 4-byte words, a
//     row's unaligned head and tail bytes by plain loads); then they form the
//     chunk's deltas and factors c = gl * nt in parallel, in the plain version's
//     order, into one of two buffers, with the values the returns need;
//   - the consumer walks running = delta + c * running over a buffer, one lane
//     an env, and writes adv[t] and ret[t] = running + v[t] straight to global
//     memory, coalesced across the tile, while the producers load and form the
//     next chunk. Named barriers (full and empty, one pair a buffer) hand the
//     buffers over, so neither side waits for the other's latency.
// An earlier design of this kernel, in which all warps loaded and formed each
// chunk and one walked it, behind three block-wide barriers a chunk, took about
// 14 us at [256, 4096]: its phases ran one after another in every chunk (PERF.md,
// Findings). A tile of 16 envs puts two blocks on most SMs at N = 4096 and fits
// the ring and both buffers in 31 KB of static shared memory. T = 1, a ragged N
// (the last tile masked) and few envs over many steps (one block walking its ring
// down a long column) take the same path.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;       // envs a block
constexpr int kChunk = 32;      // time steps a stage holds
constexpr int kStages = 4;      // the ring: 3 chunks in flight while one is formed
constexpr int kProducers = 8 * kTile;        // 4 warps
constexpr int kThreads = kProducers + 32;    // and the consumer's warp
constexpr int kPer = kChunk * kTile / kProducers;  // a producer's samples a chunk
constexpr int kRowThreads = kProducers / kChunk;   // producers a row of dones
static_assert(kRowThreads * 4 == kTile, "a row of dones as whole words, one a thread");
// named barriers (0 is __syncthreads, unused): the producers among themselves,
// then full and empty for each of the two buffers
constexpr int kProducerBar = 1, kFullBar = 2, kEmptyBar = 4;

struct Stage {
    float r[kStages][kChunk][kTile];
    float v[kStages][kChunk][kTile];
    // dones, row i's bytes at [shift + e] with shift the row's source address
    // mod 4, so that its whole words land 4-byte-aligned (dones_shift)
    unsigned char d[kStages][kChunk][kTile + 4];
    float delta[2][kChunk][kTile];  // the buffers the consumer walks
    float c[2][kChunk][kTile];
    float val[2][kChunk][kTile];
    float next_v[2][kTile];         // value and done of the step after the chunk,
    unsigned char next_d[2][kTile];  // by the chunk's parity
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(addr), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most kStages - 1 of this thread's groups are in flight: its oldest, the
// chunk about to be formed, has landed
__device__ __forceinline__ void cp_async_wait_chunk() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// wait at barrier `id` until `n` threads have arrived or waited there
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// arrive at barrier `id` without waiting; this thread's writes before it are
// visible to the threads that wait there
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ int dones_shift(const unsigned char* row) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3);
}

__global__ void __launch_bounds__(kThreads) compute_gae_kernel(
        const float* __restrict__ rewards, const unsigned char* __restrict__ dones,
        const float* __restrict__ values, const float* __restrict__ next_value,
        const unsigned char* __restrict__ next_done, float* __restrict__ adv,
        float* __restrict__ ret, int num_steps, int num_envs, float g, float gl) {
    __shared__ __align__(16) Stage s;
    const int tid = threadIdx.x;
    const int e0 = blockIdx.x * kTile;
    const int T = num_steps;
    const int N = num_envs;
    const int len = min(kTile, N - e0);  // the tile's envs
    const int chunks = (T + kChunk - 1) / kChunk;

    if (tid >= kProducers) {  // the consumer: the carry, one lane an env
        const int e = tid - kProducers;
        float running = 0.0f;
        for (int k = 0; k < chunks; ++k) {
            const int hi = T - 1 - k * kChunk;
            const int b = k & 1;
            bar_sync(kFullBar + b, kThreads);  // chunk k's buffer is formed
            if (e < len) {
                const int rows = min(kChunk, hi + 1);
                float* a_out = adv + (size_t)hi * N + e0 + e;
                float* r_out = ret + (size_t)hi * N + e0 + e;
#pragma unroll 8
                for (int i = 0; i < rows; ++i) {
                    running = s.delta[b][i][e] + s.c[b][i][e] * running;
                    a_out[-(ptrdiff_t)i * N] = running;
                    r_out[-(ptrdiff_t)i * N] = running + s.val[b][i][e];
                }
            }
            if (k + 2 < chunks) bar_arrive(kEmptyBar + b, kThreads);  // for chunk k+2
        }
        return;
    }

    // the producers: sample j of this thread in a chunk is row i (time hi - i),
    // env e of the tile
    auto row_of = [&](int j) { return (tid + j * kProducers) / kTile; };
    auto env_of = [&](int j) { return (tid + j * kProducers) % kTile; };
    auto dones_row = [&](int t) { return dones + (size_t)t * N + e0; };
    // chunk k (rows from t = T-1 - 32k down) into its stage
    auto issue = [&](int k) {
        if (k < chunks) {
            const int hi = T - 1 - k * kChunk;
            const int st = k % kStages;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                const int i = row_of(j), e = env_of(j);
                const int t = hi - i;
                if (t >= 0 && e < len) {
                    const size_t at = (size_t)t * N + e0 + e;
                    cp_async4(&s.r[st][i][e], rewards + at);
                    cp_async4(&s.v[st][i][e], values + at);
                }
            }
            const int i = tid / kRowThreads, w = tid % kRowThreads;
            const int t = hi - i;
            if (t >= 0) {
                const unsigned char* src = dones_row(t);
                const int shift = dones_shift(src);
                const int head = min((4 - shift) & 3, len);
                const int words = (len - head) / 4;
                unsigned char* dst = &s.d[st][i][shift];
                if (w < words) cp_async4(dst + head + 4 * w, src + head + 4 * w);
                if (w == 0)
                    for (int c = 0; c < head; ++c) dst[c] = __ldg(src + c);
                if (w == kRowThreads - 1)
                    for (int c = head + 4 * words; c < len; ++c) dst[c] = __ldg(src + c);
            }
        }
        cp_async_commit();  // an empty group past the last chunk keeps the count
    };

    if (tid < kTile) {  // the step after T-1
        const int n = e0 + tid;
        s.next_v[0][tid] = n < N ? next_value[n] : 0.0f;
        s.next_d[0][tid] = n < N ? next_done[n] : 0;
    }
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    for (int k = 0; k < chunks; ++k) {
        const int hi = T - 1 - k * kChunk;
        const int st = k % kStages;
        const int b = k & 1;
        bar_sync(kProducerBar, kProducers);  // chunk k-1's stage is no longer read
        issue(k + kStages - 1);              // into chunk k-1's stage
        cp_async_wait_chunk();               // this thread's copies of chunk k have landed
        bar_sync(kProducerBar, kProducers);  // and every producer's
        if (k >= 2) bar_sync(kEmptyBar + b, kThreads);  // chunk k-2's buffer is walked

        auto done_at = [&](int i, int e) {
            return s.d[st][i][dones_shift(dones_row(hi - i)) + e];
        };
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int i = row_of(j), e = env_of(j);
            if (hi - i < 0 || e >= len) continue;
            const float v = s.v[st][i][e];
            const float v_next = i == 0 ? s.next_v[b][e] : s.v[st][i - 1][e];
            const unsigned char d_next = i == 0 ? s.next_d[b][e] : done_at(i - 1, e);
            const float nt = 1.0f - (float)d_next;
            s.delta[b][i][e] = (s.r[st][i][e] + (g * nt) * v_next) - v;
            s.c[b][i][e] = gl * nt;
            s.val[b][i][e] = v;
            if (i == kChunk - 1) {  // the step after the next chunk
                s.next_v[b ^ 1][e] = v;
                s.next_d[b ^ 1][e] = done_at(i, e);
            }
        }
        bar_arrive(kFullBar + b, kThreads);  // chunk k's buffer is formed
    }
}

}  // namespace

// rewards, values [num_steps, num_envs] f32; dones [num_steps, num_envs] bytes
// (0/1); next_value [num_envs] f32; next_done [num_envs] bytes; adv, ret
// [num_steps, num_envs] f32. Returns a cudaError_t (0 on success).
extern "C" int compute_gae_f32(
        const float* rewards, const unsigned char* dones, const float* values,
        const float* next_value, const unsigned char* next_done, float* adv,
        float* ret, int num_steps, int num_envs, float g, float gl, int device,
        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_envs == 0 || num_steps == 0) return 0;
    const int blocks = (num_envs + kTile - 1) / kTile;
    compute_gae_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        rewards, dones, values, next_value, next_done, adv, ret, num_steps, num_envs, g,
        gl);
    return (int)cudaGetLastError();
}

extern "C" const char* gae_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
