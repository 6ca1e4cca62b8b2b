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
// Bound on an H100 SXM: at hidden (64, 64) the step moves 11,075 floats (read p, g,
// mu, nu, write three: 310 KB, ~0.09 us at 3.35 TB/s). What a launch takes beyond the
// launch itself is its chain of dependent memory round trips and the per-element
// arithmetic (four IEEE divides and a square root in a dependent chain): one block
// of 1024 threads took ~12 us on an H100, as one cluster of 16 blocks ~4.3 us. The
// design:
// - one thread block cluster (cudaLaunchKernelEx with a cluster dimension) of
//   kCluster blocks of kThreads, each block a contiguous share of the flat element
//   range (on an H100 at 11,075 floats, 16 blocks took 4.3 us, 8 4.8-5.8, 4 5.7-6.4, 2
//   7.9-9.0; 256, 512 and 1024 threads a block within 0.1 us of each other, 128
//   slower: PERF.md section 6);
//   every thread issues the loads of its first kBatch elements at entry, before any
//   scalar is known, finding each element's tensor by a binary search over the
//   offsets in shared memory;
// - thread 0 of every block reads the counters, the stats, g_norm and lr at once,
//   then the bias corrections at the applied count;
// - the loop's counters are read by every block and written by the cluster's rank 0
//   alone, after a cluster barrier (barrier.cluster arrive/wait) that every block
//   arrives at once its thread 0 has read them. Nothing in device memory orders the
//   blocks, so a CUDA graph replays the launch as it is. Only rank 0 writes the
//   stats row.
// One cluster takes any element count (a block loops over its share), but its
// arithmetic runs on at most 16 SMs: at 16 blocks of 256 a launch took 8.2 us at
// hidden (128, 128) (38,531 floats) against 4.2 us at (64, 64), and 73 us at (512,
// 512), against a 4.6 us byte bound. So from some tens of thousands of parameters a
// grid of clusters, with the counters written by a second launch, would be the faster
// shape (PERF.md section 6). The repo trains hidden (64, 64) (configs/base.py); its
// tensor-parallel towers of 128 put about half of (128, 128) on each model rank.
#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 16;  // above 8 blocks: a non-portable cluster size
constexpr int kThreads = 256;
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

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// the tensor that holds flat element e: the last k < count with start[k] <= e
__device__ __forceinline__ int tensor_of(const long long* start, int count, long long e) {
    int lo = 0, hi = count;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (start[mid] <= e) lo = mid; else hi = mid;
    }
    return lo;
}

// kBatch elements at a stride of the block from base, below end: their loads
struct Batch {
    float p[kBatch], g[kBatch], mu[kBatch], nu[kBatch];
    int which[kBatch];
    long long at[kBatch];
};

__device__ __forceinline__ void load_batch(const Tensors& t, const long long* start,
                                           long long base, long long end, Batch& b) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
        const long long e = base + (long long)k * kThreads;
        b.which[k] = -1;
        if (e < end) {
            const int w = tensor_of(start, t.count, e);
            b.which[k] = w;
            b.at[k] = e - start[w];
            b.p[k] = t.p[w][b.at[k]];
            b.g[k] = t.g[w][b.at[k]];
            b.mu[k] = t.mu[w][b.at[k]];
            b.nu[k] = t.nu[w][b.at[k]];
        }
    }
}

__device__ __forceinline__ void apply_batch(const Tensors& t, const Loop& l, Batch& b,
                                            bool below, float g_norm, float bc1, float bc2,
                                            float neg_lr) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
        if (b.which[k] < 0) continue;
        const int w = b.which[k];
        const float pn = adam_element(b.p[k], b.g[k], &b.mu[k], &b.nu[k], l, below, g_norm,
                                      bc1, bc2, neg_lr);
        t.p[w][b.at[k]] = pn;
        t.mu[w][b.at[k]] = b.mu[k];
        t.nu[w][b.at[k]] = b.nu[k];
    }
}

__global__ void __launch_bounds__(kThreads) adam_tail_kernel(Tensors t, Loop l) {
    __shared__ long long s_start[kMaxTensors + 1];
    __shared__ int s_flags;  // bit 0 apply, bit 1 active, bit 2 trig, bit 3 below
    __shared__ float s_g_norm, s_bc1, s_bc2, s_neg_lr;
    const int tid = threadIdx.x;
    const unsigned rank = cluster_rank();
    // thread 0's scalar loads go out first, all at once; nothing is stored before
    // every one of them is read (a store might alias a later load)
    long long i = 0, applied = 0;
    unsigned char stop = 0;
    float stat[6], g_norm = 0.0f, lr = 0.0f;
    if (tid == 0) {
        i = *l.i;
        applied = *l.applied;
        stop = *l.stop;
#pragma unroll
        for (int k = 0; k < 6; ++k) stat[k] = *l.stat[k];
        g_norm = *l.g_norm;
        lr = *l.lr;
    }
    for (int k = tid; k <= t.count; k += kThreads) s_start[k] = t.start[k];
    __syncthreads();

    // this block's share of the flat element range, its first batch loaded at once
    const long long total = s_start[t.count];
    const long long share = (total + kCluster - 1) / kCluster;
    const long long lo = share * rank;
    const long long hi = lo + share < total ? lo + share : total;
    Batch b;
    load_batch(t, s_start, lo + tid, hi, b);

    if (tid == 0) {
        const bool trig = stat[4] > l.kl_target;
        const bool active = stop == 0, apply = active && !trig;
        if (apply && (applied < 0 || applied >= l.bc_rows)) __trap();  // as index_select
        const float bc1 = apply ? l.bc1[applied] : 0.0f;
        const float bc2 = apply ? l.bc2[applied] : 0.0f;
        if (rank == 0 && i >= 0 && i < l.stats_rows) {
            float* row = l.stats + i * kStatCols;
#pragma unroll
            for (int k = 0; k < 6; ++k) row[k] = active ? stat[k] : 0.0f;
            row[6] = apply ? 1.0f : 0.0f;
            row[7] = active ? 1.0f : 0.0f;
        }
        s_flags = (apply ? 1 : 0) | (active ? 2 : 0) | (trig ? 4 : 0)
                  | (g_norm < l.max_norm ? 8 : 0);
        s_g_norm = g_norm;
        s_bc1 = bc1;
        s_bc2 = bc2;
        s_neg_lr = -lr;
    }
    __syncthreads();
    // this block has read the counters: rank 0 may overwrite them once every block
    // has arrived
    asm volatile("barrier.cluster.arrive;" ::: "memory");
    const int flags = s_flags;
    if (flags & 1) {
        const bool below = (flags & 8) != 0;
        const float gn = s_g_norm, bc1 = s_bc1, bc2 = s_bc2, neg_lr = s_neg_lr;
        apply_batch(t, l, b, below, gn, bc1, bc2, neg_lr);
        for (long long base = lo + tid + (long long)kBatch * kThreads; base < hi;
             base += (long long)kBatch * kThreads) {
            load_batch(t, s_start, base, hi, b);
            apply_batch(t, l, b, below, gn, bc1, bc2, neg_lr);
        }
    }
    asm volatile("barrier.cluster.wait;" ::: "memory");
    if (rank == 0 && tid == 0) {
        const bool active = (flags & 2) != 0, trig = (flags & 4) != 0;
        *l.i = i + 1;
        *l.applied = applied + (flags & 1);
        *l.stop = (!active || trig) ? 1 : 0;
    }
}

constexpr int kLoopPtrs = 14;   // g_norm, 6 stats, bc1, bc2, lr, i, applied, stop, stats
constexpr int kLoopConsts = 7;  // max_norm, kl_target, b1, 1 - b1, b2, 1 - b2, eps

// once per device: the kernel allowed the non-portable cluster size
cudaError_t allow_cluster(int device) {
    static bool allowed[64] = {};
    if (device >= 0 && device < 64 && allowed[device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        adam_tail_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && device >= 0 && device < 64) allowed[device] = true;
    return err;
}

}  // namespace

// tensors: 4 pointers a tensor (parameter, gradient, mu, nu; float32, contiguous),
// sizes: each tensor's element count; loop: the kLoopPtrs pointers in Loop's order;
// consts: the kLoopConsts float32 constants in Loop's order. One cluster of kCluster
// blocks. Returns a cudaError_t.
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
    err = allow_cluster(device);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, adam_tail_kernel, t, l);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* adam_tail_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
