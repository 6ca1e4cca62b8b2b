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
// are bitwise those of the plain version.
//
// Bound on an H100 SXM (3.35 TB/s): at the main path's shapes (T = 256, N = 4096)
// it must read rewards, values (f32) and dones (bytes) and write advantages and
// returns (f32), 17 bytes per sample, 17.8 MB, about 5.3 us. Its 7 f32 operations
// per sample are nothing against 67 TFLOP/s. It is bound by bytes.
//
// Design: one thread per env, the recurrence walked sequentially in the reference's
// order. With 4096 envs that is about one warp per SM, so the loads, and not the
// arithmetic, are on the critical path. They do not depend on the carry: each
// thread loads a chunk of U timesteps into registers one chunk ahead of the chunk
// it computes, so one memory latency is paid per U steps and overlaps the compute.
// Consecutive threads read consecutive envs, so each warp's loads are coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 32;

__device__ __forceinline__ void load_chunk(
        const float* __restrict__ rewards, const unsigned char* __restrict__ dones,
        const float* __restrict__ values, int hi, int n, int num_envs,
        float* r, float* v, unsigned char* d) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
        const int t = hi - j;
        if (t >= 0) {
            const size_t i = (size_t)t * num_envs + n;
            r[j] = __ldg(rewards + i);
            v[j] = __ldg(values + i);
            d[j] = __ldg(dones + i);
        } else {
            r[j] = 0.0f;
            v[j] = 0.0f;
            d[j] = 0;
        }
    }
}

__global__ void __launch_bounds__(kThreads) compute_gae_kernel(
        const float* __restrict__ rewards, const unsigned char* __restrict__ dones,
        const float* __restrict__ values, const float* __restrict__ next_value,
        const unsigned char* __restrict__ next_done, float* __restrict__ adv,
        float* __restrict__ ret, int num_steps, int num_envs, float g, float gl) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= num_envs) return;
    float running = 0.0f;
    float v_next = next_value[n];
    float nt = 1.0f - (float)next_done[n];

    float cr[kChunk], cv[kChunk];
    unsigned char cd[kChunk];
    load_chunk(rewards, dones, values, num_steps - 1, n, num_envs, cr, cv, cd);
    for (int hi = num_steps - 1; hi >= 0; hi -= kChunk) {
        float nr[kChunk], nv[kChunk];
        unsigned char nd[kChunk];
        load_chunk(rewards, dones, values, hi - kChunk, n, num_envs, nr, nv, nd);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
            const int t = hi - j;
            if (t >= 0) {
                const float delta = (cr[j] + (g * nt) * v_next) - cv[j];
                running = delta + (gl * nt) * running;
                const size_t i = (size_t)t * num_envs + n;
                adv[i] = running;
                ret[i] = running + cv[j];
                v_next = cv[j];
                nt = 1.0f - (float)cd[j];
            }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
            cr[j] = nr[j];
            cv[j] = nv[j];
            cd[j] = nd[j];
        }
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
    const int blocks = (num_envs + kThreads - 1) / kThreads;
    compute_gae_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        rewards, dones, values, next_value, next_done, adv, ret, num_steps, num_envs,
        g, gl);
    return (int)cudaGetLastError();
}

extern "C" const char* gae_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
