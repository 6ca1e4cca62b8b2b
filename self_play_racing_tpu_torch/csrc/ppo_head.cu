// The PPO loss head and its backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the per-row part of the JAX package's _ppo_loss
// (self_play_racing_tpu/agent/ppo.py:189, with normal_log_prob,
// self_play_racing_tpu/models/actor_critic.py:86) and of its gradient under
// jax.value_and_grad (ppo.py:313), which XLA fuses on the TPU into the minibatch
// step's one program, the minibatch's gather included. In PyTorch the same work is
// ~35 elementwise launches forward and about as many in autograd's backward
// (self_play_racing_tpu_torch/ops/minibatch.py:ppo_head_plain), and four gathers;
// here it is one launch each way.
//
// Forward, per row: the Normal log-prob of the action under (mu, exp(log_std)),
// log_ratio against the old log-prob, ratio = exp(log_ratio), the advantage
// normalized by the given moments, max(pg1, pg2) of the clipped surrogate,
// max((v - R)^2, (v_clip - R)^2) of the clipped value loss, and the clip flag; it
// writes -log_ratio, the two maxima and the flag. The means over the rows, the
// entropy and the loss scalar stay PyTorch's reductions.
//
// Backward, per row: from the upstream gradients of the two maxima (what autograd
// hands the head: the means' backward), d/d mu and d/d v in the order of
// operations of autograd's own backward on the card, so that every bit is the
// plain composition's: maximum's tie rule (grad * 0.5 to each side, 0 to the
// smaller), clamp's inclusive bounds, pow's grad * (2 * x), exp's grad * result,
// div's grad / other, sum's expand, sub's and neg's signs. The forward
// intermediates are recomputed from the inputs, as the forward formed them.
//
// The unit index: given unit ids (the minibatch's shuffle units), the actions,
// old log-probs, returns and old values are read where the rollout holds them,
// [units, block, ...] (agent/ppo.py:shard_blocks): minibatch row r is unit
// ids[r / block], offset r % block. mu, v and the advantages are [n] by row.
//
// Bitwise the PyTorch composition on the card: float constants rounded to float32
// as PyTorch rounds a Python scalar, IEEE divides (__fdiv_rn), expf as PyTorch's
// exp kernel calls it, no FMA contraction (-fmad=false: PyTorch's elementwise
// kernels round each operation), the NaN rules of clamp and maximum, and the sum
// over the two action dims as its reduction forms it ((a + b) + 0: -0 sums to +0).
//
// Bound on an H100 SXM: at 65,536 rows the forward reads 9 floats a row and writes
// 4 (3.4 MB, ~1.0 us at 3.35 TB/s), the backward reads 11 and writes 3 (3.7 MB,
// ~1.1 us); ~60 and ~50 float32 operations a row are nothing beside that. So a
// launch is its memory round trips and each row's chain of IEEE divides over the
// launch floor. A thread takes a row, in blocks of kThreads; its loads are issued
// before any arithmetic, and the per-launch constants (2 exp(2 log_std), the std plus
// its epsilon) are formed while they are in flight. On an H100 two and four rows a
// thread, with 8- and 16-byte vector loads and a grid sized to the SMs, took 0.2-1.5
// us longer at 65,536 and 16,384 rows: their fewer warps hide less of each row's chain
// (PERF.md section 6).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct HeadArgs {
    const float* mu;      // [n, 2]
    const float* v;       // [n]
    const float* action;  // [n, 2], or [units, block, 2] through the unit index
    const float* old_lp;  // [n], or [units, block]
    const float* adv;     // [n]
    const float* ret;     // [n], or [units, block]
    const float* val;     // [n], or [units, block]
    const float* log_std; // [2]
    const float* mean;    // 0-d: the advantages' mean
    const float* std;     // 0-d: their unbiased std
    const long long* unit_ids;  // [n / block] or null: the rows are the fields' own
    long long n, block, units;
    float lo, hi;         // 1 - clip_coef, 1 + clip_coef
    float neg_clip, clip; // -clip_coef, clip_coef
    float half_log_2pi;   // 0.5 * log(2 pi)
    float adv_eps;        // 1e-8
};

// torch.clamp(x, lo, hi) on the card: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    if (isnan(x)) return x;
    return fminf(fmaxf(x, lo), hi);
}

// torch.maximum on the card: NaN from either side
__device__ __forceinline__ float max_nan(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
}

// where the unit-indexed fields hold minibatch row r
__device__ __forceinline__ long long source_row(const HeadArgs& a, long long r) {
    if (a.unit_ids == nullptr) return r;
    const long long u = a.unit_ids[r / a.block];
    if (u < 0 || u >= a.units) __trap();  // as index_select
    return u * a.block + r % a.block;
}

// A row's inputs and the launch's constants: 2 exp(2 log_std_j), log_std_j, the
// advantages' mean and std + eps.
struct Inputs {
    float mu[2], act[2], v, old_lp, adv, ret, val;
    float den[2], ls[2], mean, std_eps;
};

// Row r's loads, then the constants formed while they are in flight.
__device__ __forceinline__ Inputs load_row(const HeadArgs& a, long long r) {
    Inputs x;
    x.ls[0] = a.log_std[0];
    x.ls[1] = a.log_std[1];
    x.mean = *a.mean;
    x.std_eps = *a.std;
    x.mu[0] = a.mu[2 * r];
    x.mu[1] = a.mu[2 * r + 1];
    x.v = a.v[r];
    x.adv = a.adv[r];
    const long long s = source_row(a, r);
    x.act[0] = a.action[2 * s];
    x.act[1] = a.action[2 * s + 1];
    x.old_lp = a.old_lp[s];
    x.ret = a.ret[s];
    x.val = a.val[s];
    // var = exp(2.0 * log_std), den = 2.0 * var
#pragma unroll
    for (int j = 0; j < 2; ++j) x.den[j] = 2.0f * expf(2.0f * x.ls[j]);
    x.std_eps = __fadd_rn(x.std_eps, a.adv_eps);
    return x;
}

// What the forward forms for one row, kept for the backward.
struct Row {
    float d[2];
    float ratio, nadv, pg1, pg2;
    float dv, e1, e2, s1, s2;
    float neg_log_ratio, pg_max, v_max, clipped;
};

__device__ __forceinline__ Row head_row(const HeadArgs& a, const Inputs& x) {
    Row r;
    float lp2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        // -((action - mu) ** 2) / (2.0 * var) - log_std - c
        r.d[j] = __fsub_rn(x.act[j], x.mu[j]);
        const float q = __fdiv_rn(-__fmul_rn(r.d[j], r.d[j]), x.den[j]);
        lp2[j] = __fsub_rn(__fsub_rn(q, x.ls[j]), a.half_log_2pi);
    }
    const float lp = __fadd_rn(__fadd_rn(lp2[0], lp2[1]), 0.0f);
    const float log_ratio = __fsub_rn(lp, x.old_lp);
    r.ratio = expf(log_ratio);
    r.neg_log_ratio = -log_ratio;
    const float adv = __fdiv_rn(__fsub_rn(x.adv, x.mean), x.std_eps);
    r.nadv = -adv;
    r.pg1 = __fmul_rn(r.nadv, r.ratio);
    r.pg2 = __fmul_rn(r.nadv, clamp_nan(r.ratio, a.lo, a.hi));
    r.pg_max = max_nan(r.pg1, r.pg2);
    r.dv = __fsub_rn(x.v, x.val);
    const float v_clip = __fadd_rn(x.val, clamp_nan(r.dv, a.neg_clip, a.clip));
    r.e1 = __fsub_rn(x.v, x.ret);
    r.e2 = __fsub_rn(v_clip, x.ret);
    r.s1 = __fmul_rn(r.e1, r.e1);
    r.s2 = __fmul_rn(r.e2, r.e2);
    r.v_max = max_nan(r.s1, r.s2);
    r.clipped = fabsf(__fsub_rn(r.ratio, 1.0f)) > a.clip ? 1.0f : 0.0f;
    return r;
}

__global__ void __launch_bounds__(kThreads) ppo_head_forward_kernel(
        HeadArgs a, float* __restrict__ neg_log_ratio, float* __restrict__ pg_max,
        float* __restrict__ v_max, float* __restrict__ clipped) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    const Row r = head_row(a, load_row(a, i));
    neg_log_ratio[i] = r.neg_log_ratio;
    pg_max[i] = r.pg_max;
    v_max[i] = r.v_max;
    clipped[i] = r.clipped;
}

// autograd's backward of torch.maximum(x, y): where(x == y, grad / 2, grad), then
// 0 where x is the smaller (for x) or the larger (for y)
__device__ __forceinline__ void max_backward(float x, float y, float g, float* gx, float* gy) {
    const float h = x == y ? __fmul_rn(g, 0.5f) : g;
    *gx = x < y ? 0.0f : h;
    *gy = x > y ? 0.0f : h;
}

__global__ void __launch_bounds__(kThreads) ppo_head_backward_kernel(
        HeadArgs a, const float* __restrict__ g_pg, long long pg_stride,
        const float* __restrict__ g_vm, long long vm_stride, float* __restrict__ g_mu,
        float* __restrict__ g_v) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    // an absent upstream gradient is autograd's materialized zeros
    const float gp = g_pg ? g_pg[i * pg_stride] : 0.0f;
    const float gv = g_vm ? g_vm[i * vm_stride] : 0.0f;
    const Inputs x = load_row(a, i);
    const Row r = head_row(a, x);

    // the policy side: pg1 = nadv * ratio, pg2 = nadv * clamp(ratio, lo, hi)
    float g1, g2;
    max_backward(r.pg1, r.pg2, gp, &g1, &g2);
    const float g_ratio_pg1 = __fmul_rn(g1, r.nadv);
    const float g_clamped = __fmul_rn(g2, r.nadv);
    const float g_ratio_pg2 = (r.ratio >= a.lo && r.ratio <= a.hi) ? g_clamped : 0.0f;
    const float g_ratio = __fadd_rn(g_ratio_pg1, g_ratio_pg2);
    const float g_log_ratio = __fmul_rn(g_ratio, r.ratio);  // exp: grad * result
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        // lp = sum_j ((-(d * d) / den - log_std) - c), d = action - mu
        const float g_neg_sq = __fdiv_rn(g_log_ratio, x.den[j]);
        const float g_sq = -g_neg_sq;
        const float g_d = __fmul_rn(g_sq, __fmul_rn(r.d[j], 2.0f));
        g_mu[2 * i + j] = -g_d;
    }

    // the value side: v_max = max((v - R)^2, (val + clamp(v - val) - R)^2)
    float gs1, gs2;
    max_backward(r.s1, r.s2, gv, &gs1, &gs2);
    const float g_e1 = __fmul_rn(gs1, __fmul_rn(r.e1, 2.0f));
    const float g_e2 = __fmul_rn(gs2, __fmul_rn(r.e2, 2.0f));
    const float g_dv = (r.dv >= a.neg_clip && r.dv <= a.clip) ? g_e2 : 0.0f;
    g_v[i] = __fadd_rn(g_e1, g_dv);
}

constexpr int kInputs = 11;  // HeadArgs' pointers, the unit ids last (null for none)
constexpr int kConsts = 6;

// the arguments, or false where they are not valid
bool head_args(const void* const* ptrs, const float* consts, long long n, long long block,
               long long units, HeadArgs* out) {
    HeadArgs a;
    a.mu = static_cast<const float*>(ptrs[0]);
    a.v = static_cast<const float*>(ptrs[1]);
    a.action = static_cast<const float*>(ptrs[2]);
    a.old_lp = static_cast<const float*>(ptrs[3]);
    a.adv = static_cast<const float*>(ptrs[4]);
    a.ret = static_cast<const float*>(ptrs[5]);
    a.val = static_cast<const float*>(ptrs[6]);
    a.log_std = static_cast<const float*>(ptrs[7]);
    a.mean = static_cast<const float*>(ptrs[8]);
    a.std = static_cast<const float*>(ptrs[9]);
    a.unit_ids = static_cast<const long long*>(ptrs[10]);
    a.n = n;
    a.block = block;
    a.units = units;
    a.lo = consts[0];
    a.hi = consts[1];
    a.neg_clip = consts[2];
    a.clip = consts[3];
    a.half_log_2pi = consts[4];
    a.adv_eps = consts[5];
    if (a.unit_ids != nullptr && (block < 1 || n % block != 0 || units < 1)) return false;
    *out = a;
    return true;
}

unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// ptrs: the kInputs inputs in HeadArgs' order (float32, contiguous; the unit ids
// int64 or null); consts: the kConsts float32 constants in HeadArgs' order; out:
// -log_ratio, max(pg1, pg2), max of the value losses, the clip flag ([n] float32
// each); block and units: the unit-indexed fields' [units, block] (ignored without
// ids). Returns a cudaError_t.
extern "C" int ppo_head_forward_f32(const void* const* ptrs, int num_ptrs,
                                    const float* consts, int num_consts, float* const* out,
                                    long long n, long long block, long long units,
                                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    HeadArgs a;
    if (num_ptrs != kInputs || num_consts != kConsts || n < 0
            || !head_args(ptrs, consts, n, block, units, &a))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    ppo_head_forward_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, out[0], out[1], out[2], out[3]);
    return (int)cudaGetLastError();
}

// The backward: the forward's inputs, the upstream gradients of max(pg1, pg2) and of
// the value maximum (each [n] at stride 1, or stride 0 for an expanded one; null for
// none), out d/d mu [n, 2] and d/d v [n]; the rest as the forward's.
extern "C" int ppo_head_backward_f32(const void* const* ptrs, int num_ptrs,
                                     const float* consts, int num_consts, const float* g_pg,
                                     long long pg_stride, const float* g_vm,
                                     long long vm_stride, float* g_mu, float* g_v,
                                     long long n, long long block, long long units,
                                     int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    HeadArgs a;
    if (num_ptrs != kInputs || num_consts != kConsts || n < 0
            || (pg_stride != 0 && pg_stride != 1) || (vm_stride != 0 && vm_stride != 1)
            || !head_args(ptrs, consts, n, block, units, &a))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    ppo_head_backward_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, g_pg, pg_stride, g_vm, vm_stride, g_mu, g_v);
    return (int)cudaGetLastError();
}

extern "C" const char* ppo_head_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
