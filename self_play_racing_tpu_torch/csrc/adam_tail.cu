// The PPO minibatch step's tail after the global norm, for NVIDIA Hopper (sm_90a):
// the KL exit's masks, the clip by global norm, Adam, the learning-rate step, the
// masked in-place write of the parameters and moments, the stats row and the
// loop's counters, in one launch.
//
// Replaces optax.clip_by_global_norm and optax.scale_by_adam (the JAX package's
// make_optimizer, self_play_racing_tpu/agent/ppo.py:117), optax.apply_updates and
// the jnp.where masks of its minibatch body (ppo.py:318-325), which XLA fuses on
// the TPU into the minibatch step's one program. In PyTorch the same work is about
// 85 launches over the 12 parameter tensors (self_play_racing_tpu_torch/ops/
// minibatch.py:adam_tail_plain: the _foreach ops, a where per tensor and moment,
// the stats row and the counters).
//
// Per element, in optax's order and rounded as PyTorch's float32 _foreach ops round
// (Python scalars to float32; IEEE divides and square root, __fdiv_rn and
// __fsqrt_rn; no FMA contraction):
//   g   = g_norm < max_norm ? g : (g / g_norm) * max_norm
//   mu' = g * (1 - b1) + mu * b1
//   nu' = (g * g) * (1 - b2) + nu * b2
//   u   = (mu' / bc1) / (sqrt(nu' / bc2) + eps)
//   p'  = p + u * (-lr)
// with bc1, bc2 the bias corrections at the loop's applied count (rows of
// bias_correction_table's tables on the card). p, mu and nu take the new values
// only where the step applies: the loop is active (no earlier exit) and
// approx_kl <= kl_target. Row i of the stats table takes the six stats, applied and
// active (zeros where not active); then i += 1, applied += apply, stop |= active &
// trig. g_norm's reductions stay PyTorch's: their order sets its bits.
//
// The kernel reads the loop's counters and writes them, so it runs as one block:
// thread 0 reads the counters and the scalars before a barrier, every thread
// updates its elements, and thread 0 writes the counters after a second barrier.
// At hidden (64, 64) the step moves 11,075 floats (read p, g, mu, nu, write three:
// 310 KB, ~0.1 us at 3.35 TB/s): a launch costs more, so the kernel is
// launch-bound whatever its form. A thread takes four elements at a time, their
// loads issued before any arithmetic, so one block's memory latency overlaps.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTensors = 32;
constexpr int kBatch = 4;
constexpr int kStatCols = 8;

struct Tensors {
    float* p[kMaxTensors];
    const float* g[kMaxTensors];
    float* mu[kMaxTensors];
    float* nu[kMaxTensors];
    long long start[kMaxTensors + 1];  // element offsets: tensor t is [start[t], start[t+1])
    int count;
};

struct Loop {
    const float* g_norm;      // 0-d
    const float* stat[6];     // loss, pg_loss, v_loss, entropy, approx_kl, clip_frac
    const float* bc1;         // [bc_rows]
    const float* bc2;         // [bc_rows]
    const float* lr;          // 0-d
    long long* i;             // [1]
    long long* applied;       // [1]
    unsigned char* stop;      // 0-d bool
    float* stats;             // [stats_rows, 8]
    long long bc_rows, stats_rows;
    float max_norm, kl_target, b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ float adam_element(float p, float g, float* mu, float* nu,
                                              const Loop& l, bool below, float g_norm,
                                              float bc1, float bc2, float neg_lr) {
    const float gc = below ? g : __fmul_rn(__fdiv_rn(g, g_norm), l.max_norm);
    const float m = __fadd_rn(__fmul_rn(gc, l.one_minus_b1), __fmul_rn(*mu, l.b1));
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(gc, gc), l.one_minus_b2),
                              __fmul_rn(*nu, l.b2));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), l.eps);
    const float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
    *mu = m;
    *nu = v;
    return __fadd_rn(p, __fmul_rn(u, neg_lr));
}

__global__ void __launch_bounds__(kThreads) adam_tail_kernel(Tensors t, Loop l) {
    __shared__ long long s_i, s_applied;
    __shared__ int s_flags;  // bit 0 apply, bit 1 active, bit 2 trig, bit 3 below
    __shared__ float s_g_norm, s_bc1, s_bc2, s_neg_lr;
    __shared__ long long s_start[kMaxTensors + 1];
    const int tid = threadIdx.x;
    for (int k = tid; k <= t.count; k += blockDim.x) s_start[k] = t.start[k];
    if (tid == 0) {
        // every scalar read before the first store (a store might alias a later
        // load and serialize the round trips), the bias corrections after the count
        const long long i = *l.i, applied = *l.applied;
        const bool stop = *l.stop != 0;
        float stat[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) stat[k] = *l.stat[k];
        const float g_norm = *l.g_norm, lr = *l.lr;
        const bool trig = stat[4] > l.kl_target;
        const bool active = !stop, apply = active && !trig;
        if (apply && (applied < 0 || applied >= l.bc_rows)) __trap();  // as index_select
        const float bc1 = apply ? l.bc1[applied] : 0.0f;
        const float bc2 = apply ? l.bc2[applied] : 0.0f;
        if (i >= 0 && i < l.stats_rows) {
            float* row = l.stats + i * kStatCols;
#pragma unroll
            for (int k = 0; k < 6; ++k) row[k] = active ? stat[k] : 0.0f;
            row[6] = apply ? 1.0f : 0.0f;
            row[7] = active ? 1.0f : 0.0f;
        }
        s_i = i;
        s_applied = applied;
        s_flags = (apply ? 1 : 0) | (active ? 2 : 0) | (trig ? 4 : 0)
                  | (g_norm < l.max_norm ? 8 : 0);
        s_g_norm = g_norm;
        s_bc1 = bc1;
        s_bc2 = bc2;
        s_neg_lr = -lr;
    }
    __syncthreads();
    const int flags = s_flags;
    if (flags & 1) {
        const bool below = (flags & 8) != 0;
        const float g_norm = s_g_norm, bc1 = s_bc1, bc2 = s_bc2, neg_lr = s_neg_lr;
        const long long total = s_start[t.count];
        int tensor = 0;
        for (long long base = (long long)tid; base < total;
             base += (long long)kBatch * blockDim.x) {
            // kBatch elements at a stride of the block: their loads first
            float p[kBatch], g[kBatch], mu[kBatch], nu[kBatch];
            int which[kBatch];
            long long at[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const long long e = base + (long long)b * blockDim.x;
                which[b] = -1;
                if (e < total) {
                    while (e >= s_start[tensor + 1]) ++tensor;
                    which[b] = tensor;
                    at[b] = e - s_start[tensor];
                    p[b] = t.p[tensor][at[b]];
                    g[b] = t.g[tensor][at[b]];
                    mu[b] = t.mu[tensor][at[b]];
                    nu[b] = t.nu[tensor][at[b]];
                }
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                if (which[b] < 0) continue;
                const int k = which[b];
                const float pn = adam_element(p[b], g[b], &mu[b], &nu[b], l, below, g_norm,
                                              bc1, bc2, neg_lr);
                t.p[k][at[b]] = pn;
                t.mu[k][at[b]] = mu[b];
                t.nu[k][at[b]] = nu[b];
            }
        }
    }
    __syncthreads();
    if (tid == 0) {
        const bool active = (flags & 2) != 0, trig = (flags & 4) != 0;
        *l.i = s_i + 1;
        *l.applied = s_applied + (flags & 1);
        *l.stop = (!active || (active && trig)) ? 1 : 0;
    }
}

constexpr int kLoopPtrs = 14;   // g_norm, 6 stats, bc1, bc2, lr, i, applied, stop, stats
constexpr int kLoopConsts = 7;  // max_norm, kl_target, b1, 1 - b1, b2, 1 - b2, eps

}  // namespace

// tensors: 4 pointers a tensor (parameter, gradient, mu, nu; float32, contiguous),
// sizes: each tensor's element count; loop: the kLoopPtrs pointers in Loop's order;
// consts: the kLoopConsts float32 constants in Loop's order. Returns a cudaError_t.
extern "C" int adam_tail_f32(void* const* tensors, const long long* sizes, int num_tensors,
                             void* const* loop, int num_loop, const float* consts,
                             int num_consts, long long bc_rows, long long stats_rows,
                             int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_tensors < 1 || num_tensors > kMaxTensors || num_loop != kLoopPtrs
            || num_consts != kLoopConsts)
        return (int)cudaErrorInvalidValue;
    Tensors t;
    t.count = num_tensors;
    t.start[0] = 0;
    for (int k = 0; k < num_tensors; ++k) {
        if (sizes[k] < 0) return (int)cudaErrorInvalidValue;
        t.p[k] = static_cast<float*>(tensors[4 * k]);
        t.g[k] = static_cast<const float*>(tensors[4 * k + 1]);
        t.mu[k] = static_cast<float*>(tensors[4 * k + 2]);
        t.nu[k] = static_cast<float*>(tensors[4 * k + 3]);
        t.start[k + 1] = t.start[k] + sizes[k];
    }
    Loop l;
    l.g_norm = static_cast<const float*>(loop[0]);
    for (int k = 0; k < 6; ++k) l.stat[k] = static_cast<const float*>(loop[1 + k]);
    l.bc1 = static_cast<const float*>(loop[7]);
    l.bc2 = static_cast<const float*>(loop[8]);
    l.lr = static_cast<const float*>(loop[9]);
    l.i = static_cast<long long*>(loop[10]);
    l.applied = static_cast<long long*>(loop[11]);
    l.stop = static_cast<unsigned char*>(loop[12]);
    l.stats = static_cast<float*>(loop[13]);
    l.bc_rows = bc_rows;
    l.stats_rows = stats_rows;
    l.max_norm = consts[0];
    l.kl_target = consts[1];
    l.b1 = consts[2];
    l.one_minus_b1 = consts[3];
    l.b2 = consts[4];
    l.one_minus_b2 = consts[5];
    l.eps = consts[6];
    adam_tail_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(t, l);
    return (int)cudaGetLastError();
}

extern "C" const char* adam_tail_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
