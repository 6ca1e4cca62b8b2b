// The PPO loss head and its backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the per-row part of the JAX package's _ppo_loss
// (self_play_racing_tpu/agent/ppo.py:189, with normal_log_prob,
// self_play_racing_tpu/models/actor_critic.py:86) and of its gradient under
// jax.value_and_grad (ppo.py:313), which XLA fuses on the TPU into the minibatch
// step's one program. In PyTorch the same work is ~35 elementwise launches forward
// and about as many in autograd's backward (self_play_racing_tpu_torch/ops/
// minibatch.py:ppo_head_plain); here it is one launch each way.
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
// Bitwise the PyTorch composition on the card: float constants rounded to float32
// as PyTorch rounds a Python scalar, IEEE divides (__fdiv_rn), expf as PyTorch's
// exp kernel calls it, no FMA contraction (-fmad=false: PyTorch's elementwise
// kernels round each operation), the NaN rules of clamp and maximum, and the sum
// over the two action dims as its reduction forms it ((a + b) + 0: -0 sums to +0).
//
// Bound on an H100 SXM: at 65,536 rows the forward reads 9 floats a row and writes
// 4 (3.4 MB, ~1.0 us at 3.35 TB/s), the backward reads 11 and writes 3 (3.7 MB,
// ~1.1 us); ~60 and ~50 float32 operations a row are nothing beside that. The
// design is the plain one: a thread a row, coalesced loads and stores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct HeadArgs {
    const float* mu;      // [n, 2]
    const float* v;       // [n]
    const float* action;  // [n, 2]
    const float* old_lp;  // [n]
    const float* adv;     // [n]
    const float* ret;     // [n]
    const float* val;     // [n]
    const float* log_std; // [2]
    const float* mean;    // 0-d: the advantages' mean
    const float* std;     // 0-d: their unbiased std
    long long n;
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

// What the forward forms for one row, kept for the backward.
struct Row {
    float d[2], den[2];
    float ratio, nadv, pg1, pg2;
    float dv, e1, e2, s1, s2;
    float neg_log_ratio, pg_max, v_max, clipped;
};

__device__ __forceinline__ Row head_row(const HeadArgs& a, long long i) {
    Row r;
    float lp2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const float ls = a.log_std[j];
        // var = exp(2.0 * log_std); -((action - mu) ** 2) / (2.0 * var) - log_std - c
        r.den[j] = 2.0f * expf(2.0f * ls);
        r.d[j] = __fsub_rn(a.action[2 * i + j], a.mu[2 * i + j]);
        const float q = __fdiv_rn(-__fmul_rn(r.d[j], r.d[j]), r.den[j]);
        lp2[j] = __fsub_rn(__fsub_rn(q, ls), a.half_log_2pi);
    }
    const float lp = __fadd_rn(__fadd_rn(lp2[0], lp2[1]), 0.0f);
    const float log_ratio = __fsub_rn(lp, a.old_lp[i]);
    r.ratio = expf(log_ratio);
    r.neg_log_ratio = -log_ratio;
    const float adv = __fdiv_rn(__fsub_rn(a.adv[i], *a.mean), __fadd_rn(*a.std, a.adv_eps));
    r.nadv = -adv;
    r.pg1 = __fmul_rn(r.nadv, r.ratio);
    r.pg2 = __fmul_rn(r.nadv, clamp_nan(r.ratio, a.lo, a.hi));
    r.pg_max = max_nan(r.pg1, r.pg2);
    const float v = a.v[i], val = a.val[i], ret = a.ret[i];
    r.dv = __fsub_rn(v, val);
    const float v_clip = __fadd_rn(val, clamp_nan(r.dv, a.neg_clip, a.clip));
    r.e1 = __fsub_rn(v, ret);
    r.e2 = __fsub_rn(v_clip, ret);
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
    const Row r = head_row(a, i);
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
    const Row r = head_row(a, i);
    // an absent upstream gradient is autograd's materialized zeros
    const float gp = g_pg ? g_pg[i * pg_stride] : 0.0f;
    const float gv = g_vm ? g_vm[i * vm_stride] : 0.0f;

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
        const float g_neg_sq = __fdiv_rn(g_log_ratio, r.den[j]);
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

HeadArgs head_args(const float* const* ptrs, const float* consts, long long n) {
    HeadArgs a;
    a.mu = ptrs[0];
    a.v = ptrs[1];
    a.action = ptrs[2];
    a.old_lp = ptrs[3];
    a.adv = ptrs[4];
    a.ret = ptrs[5];
    a.val = ptrs[6];
    a.log_std = ptrs[7];
    a.mean = ptrs[8];
    a.std = ptrs[9];
    a.n = n;
    a.lo = consts[0];
    a.hi = consts[1];
    a.neg_clip = consts[2];
    a.clip = consts[3];
    a.half_log_2pi = consts[4];
    a.adv_eps = consts[5];
    return a;
}

constexpr int kInputs = 10;
constexpr int kConsts = 6;

}  // namespace

// ptrs: the kInputs inputs in HeadArgs' order (float32, contiguous); consts: the
// kConsts float32 constants in HeadArgs' order; out: -log_ratio, max(pg1, pg2),
// max of the value losses, the clip flag ([n] float32 each). Returns a cudaError_t.
extern "C" int ppo_head_forward_f32(const float* const* ptrs, int num_ptrs,
                                    const float* consts, int num_consts, float* const* out,
                                    long long n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kInputs || num_consts != kConsts || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const HeadArgs a = head_args(ptrs, consts, n);
    const long long blocks = (n + kThreads - 1) / kThreads;
    ppo_head_forward_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, out[0], out[1], out[2], out[3]);
    return (int)cudaGetLastError();
}

// The backward: the forward's inputs, the upstream gradients of max(pg1, pg2) and of
// the value maximum (each [n] at stride 1, or stride 0 for an expanded one; null for
// none), out d/d mu [n, 2] and d/d v [n].
extern "C" int ppo_head_backward_f32(const float* const* ptrs, int num_ptrs,
                                     const float* consts, int num_consts, const float* g_pg,
                                     long long pg_stride, const float* g_vm,
                                     long long vm_stride, float* g_mu, float* g_v,
                                     long long n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kInputs || num_consts != kConsts || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const HeadArgs a = head_args(ptrs, consts, n);
    const long long blocks = (n + kThreads - 1) / kThreads;
    ppo_head_backward_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, g_pg, pg_stride, g_vm, vm_stride, g_mu, g_v);
    return (int)cudaGetLastError();
}

extern "C" const char* ppo_head_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
