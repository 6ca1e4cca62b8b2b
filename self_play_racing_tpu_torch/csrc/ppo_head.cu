// The PPO loss head and its backward, and the advantages' moments of every minibatch,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's _ppo_loss (self_play_racing_tpu/agent/ppo.py:189, with
// normal_log_prob, self_play_racing_tpu/models/actor_critic.py:86) around the MLPs:
// the per-row work, the advantages' mean and std(ddof=1) (:195-196), the five means,
// the entropy and the loss's sum (:193-212), and its gradient under
// jax.value_and_grad (:313). XLA fuses all of it on the TPU into the minibatch step's
// one program, the minibatch's gather included. In PyTorch the same work is ~35
// elementwise launches forward, six means, a std and about as many launches in
// autograd's backward (self_play_racing_tpu_torch/ops/minibatch.py:
// ppo_head_loss_plain, advantage_moments_plain);
// here the forward is one launch, the backward one, and the moments of an update's
// every minibatch one more.
//
// Forward, per row: the Normal log-prob of the action under (mu, exp(log_std)),
// log_ratio against the old log-prob, ratio = exp(log_ratio), the advantage
// normalized by row `at` of the moments table, max(pg1, pg2) of the clipped
// surrogate, max((v - R)^2, (v_clip - R)^2) of the clipped value loss, and the clip
// flag. Then the sums: each block adds its rows' -log_ratio, max(pg1, pg2), value
// maximum and flag in float64, each warp by a shuffle tree and the warps in order,
// and writes the four to scratch; the last block to take a ticket (__threadfence,
// then atomicInc, which wraps the counter back to 0; no float atomics) adds the
// blocks' partials, thread t those of blocks t, t + 128, ... in order, then the
// block's tree as above. So every sum is a function of the inputs alone, run to run
// and graphed or eager. That block forms approx_kl, pg_loss, v_loss = 0.5 * mean,
// the entropy (0.5 + 0.5 log 2 pi + log_std).sum(), clip_frac and loss = pg_loss +
// ent_coef * -entropy + vf_coef * v_loss in _ppo_loss's order, and writes the loss
// and the six stats (STAT_NAMES[:6]). A mean is its float64 sum over n, rounded once
// to float32; clip_frac, an integer count below 2^24, is count * (1 / n) in float32,
// bitwise torch's float32 mean on the card.
//
// Backward, per row: from the loss's upstream gradient g, the two maxima's upstream
// gradients as autograd forms them for the composition on the card (the means'
// backward divides by a CPU scalar as a product with its float32 reciprocal):
// g * (1 / n) and ((g * vf_coef) * 0.5) * (1 / n). Then d/d mu and d/d v in the
// order of operations of autograd's own backward on the card, so that every bit is
// the plain composition's: maximum's tie rule (grad * 0.5 to each side, 0 to the
// smaller), clamp's inclusive bounds, pow's grad * (2 * x), exp's grad * result,
// div's grad / other, sum's expand, sub's and neg's signs. The forward
// intermediates are recomputed from the inputs, as the forward formed them.
//
// The moments (advantage_moments_f32): a cluster of 8 blocks of 256 threads a
// minibatch (1280 blocks an update at 160 minibatches: the SMs' work evens out, where a
// block a minibatch left some SMs two), the cluster's thread g its flat rows g, g + 2048,
// ... (row r unit ids[r / block], offset r % block, stepped without a division: a
// warp's loads coalesce within a unit), eight loaded before they are added, in one
// pass: in float64, the sums of d and d * d for d the row's deviation from the
// minibatch's first row, each by the block's fixed tree and the cluster's blocks in rank
// order (distributed shared memory); mean = shift + S / n, var = (Q - S^2 / n) / (n - 1)
// (the shift keeps the difference's cancellation far below float32's rounding), each
// rounded once to float32 (n = 1: NaN, as std(correction=1)).
//
// The unit index: given unit ids (the minibatch's shuffle units), the actions, old
// log-probs, advantages, returns and old values are read where the rollout holds
// them, [units, block, ...] (agent/ppo.py:shard_blocks): minibatch row r is unit
// ids[r / block], offset r % block. mu and v are [n] by row.
//
// Bitwise the PyTorch composition on the card in every per-row value and gradient:
// float constants rounded to float32 as PyTorch rounds a Python scalar, IEEE
// divides (__fdiv_rn), expf as PyTorch's exp kernel calls it, no FMA contraction
// (-fmad=false: PyTorch's elementwise kernels round each operation), the NaN rules of
// clamp and maximum, and the sum over the two action dims as its reduction forms it
// ((a + b) + 0: -0 sums to +0). The sums are not torch's (its float32 tree): they are
// held within a stated tolerance of the float64 sums (ops/minibatch.py).
//
// Bound on an H100 SXM: at 65,536 rows the forward reads 9 floats a row and writes 7
// floats in all (2.4 MB, ~0.7 us at 3.35 TB/s), the backward reads 9 and writes 3
// (3.1 MB, ~0.9 us); ~60 and ~50 float32 operations a row are nothing beside that.
// The moments read each minibatch's rows once from the L2 (160 x 65,536 floats an
// update, 4.2 MB of distinct rows, ~1.25 us by row id); their float64 work (~4
// operations a row at 34 TFLOP/s) is ~1.2 us more. So a launch is its memory round
// trips and each row's chain of IEEE divides over the launch floor, and the
// forward's sums add one block's tail after the ticket. A thread takes a row, in
// blocks of kThreads; its loads are issued before any arithmetic, and the per-launch
// constants (2 exp(2 log_std), the std plus its epsilon) are formed while they are in
// flight.
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "normal_lp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the forward's sums: -log_ratio, max(pg1, pg2), the value maximum, the clip flag
constexpr int kSums = 4;
// the moments: a cluster of kMomentCluster blocks of kMomentThreads a minibatch, and the
// rows a thread loads before it adds them (in order)
constexpr int kMomentCluster = 8;
constexpr int kMomentThreads = 256;
constexpr int kMomentWarps = kMomentThreads / 32;
constexpr int kMomentUnroll = 8;

struct HeadArgs {
    const float* mu;      // [n, 2]
    const float* v;       // [n]
    const float* action;  // [n, 2], or [units, block, 2] through the unit index
    const float* old_lp;  // [n], or [units, block]
    const float* adv;     // [n], or [units, block]
    const float* ret;     // [n], or [units, block]
    const float* val;     // [n], or [units, block]
    const float* log_std; // [2]
    const float* moments; // [moment_rows, 2]: each minibatch's advantage mean and std
    const long long* at;  // [1]: the moments' row of this minibatch
    const long long* unit_ids;  // [n / block] or null: the rows are the fields' own
    long long n, block, units, moment_rows;
    float lo, hi;         // 1 - clip_coef, 1 + clip_coef
    float neg_clip, clip; // -clip_coef, clip_coef
    float half_log_2pi;   // 0.5 * log(2 pi)
    float adv_eps;        // 1e-8
    float entropy_c;      // 0.5 + 0.5 * log(2 pi)
    float ent_coef, vf_coef;
    float inv_n;          // 1 / n in float32, as the card's mean and its backward take it
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

// A row's inputs and the launch's constants: 2 exp(2 log_std_j), log_std_j, the
// advantages' mean and std + eps.
struct Inputs {
    float mu[2], act[2], v, old_lp, adv, ret, val;
    float den[2], ls[2], mean, std_eps;
};

// Row r's loads, then the constants formed while they are in flight: first every load
// whose address is known (log_std, the moments' row index, mu, v, the unit id), then
// one check of the two indices, then the loads through them (a trap between two loads
// would keep the second from issuing before the first returned).
__device__ __forceinline__ Inputs load_row(const HeadArgs& a, long long r) {
    Inputs x;
    x.ls[0] = a.log_std[0];
    x.ls[1] = a.log_std[1];
    const long long m = *a.at;
    x.mu[0] = a.mu[2 * r];
    x.mu[1] = a.mu[2 * r + 1];
    x.v = a.v[r];
    const bool by_id = a.unit_ids != nullptr;
    const long long u = by_id ? a.unit_ids[r / a.block] : 0;
    if (m < 0 || m >= a.moment_rows || (by_id && (u < 0 || u >= a.units)))
        __trap();  // as index_select
    // where the unit-indexed fields hold minibatch row r
    const long long s = by_id ? u * a.block + r % a.block : r;
    x.mean = a.moments[2 * m];
    x.std_eps = a.moments[2 * m + 1];
    x.adv = a.adv[s];
    x.act[0] = a.action[2 * s];
    x.act[1] = a.action[2 * s + 1];
    x.old_lp = a.old_lp[s];
    x.ret = a.ret[s];
    x.val = a.val[s];
    // var = exp(2.0 * log_std), den = 2.0 * var
#pragma unroll
    for (int j = 0; j < 2; ++j) x.den[j] = normal_lp::denominator(x.ls[j]);
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
        // -((action - mu) ** 2) / (2.0 * var) - log_std - c (normal_lp.cuh)
        r.d[j] = __fsub_rn(x.act[j], x.mu[j]);
        lp2[j] = normal_lp::term(r.d[j], x.den[j], x.ls[j], a.half_log_2pi);
    }
    const float lp = normal_lp::sum2(lp2[0], lp2[1]);
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

// the warp's values summed by a shuffle tree (offsets 16, 8, 4, 2, 1): lane 0's is
// the warp's sum
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// kSums values of each thread summed over the block: each warp's by warp_sum, then
// the warps' sums in order by thread 0, into total (valid in thread 0). Ends with
// the block synchronized, `scratch` free again.
__device__ __forceinline__ void block_sums(double (&v)[kSums], double (&scratch)[kSums][kWarps],
                                           double (&total)[kSums]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
        const double w = warp_sum(v[k]);
        if (lane == 0) scratch[k][warp] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
            double t = scratch[k][0];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) t += scratch[k][w];
            total[k] = t;
        }
    }
    __syncthreads();
}

// The loss, its stats and the four sums' partials (partial [blocks, kSums] float64,
// ticket the card's counter, 0 before and after the launch).
__global__ void __launch_bounds__(kThreads) ppo_head_forward_kernel(
        HeadArgs a, double* __restrict__ partial, unsigned int* __restrict__ ticket,
        float* __restrict__ loss, float* __restrict__ stats) {
    __shared__ double scratch[kSums][kWarps];
    __shared__ bool last;
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    double v[kSums] = {0.0, 0.0, 0.0, 0.0}, total[kSums];
    if (i < a.n) {
        const Row r = head_row(a, load_row(a, i));
        v[0] = r.neg_log_ratio;
        v[1] = r.pg_max;
        v[2] = r.v_max;
        v[3] = r.clipped;
    }
    block_sums(v, scratch, total);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) partial[blockIdx.x * kSums + k] = total[k];
        __threadfence();  // the partials are visible before the ticket is taken
        last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the last block: every other block's partials are in the L2 (read past the L1),
    // a block's four in two 16-byte loads, issued ahead of the adds
    __threadfence();
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = 0.0;
#pragma unroll 4
    for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
        const double2* p = reinterpret_cast<const double2*>(partial + b * kSums);
        const double2 p01 = __ldcg(p), p23 = __ldcg(p + 1);
        v[0] += p01.x;
        v[1] += p01.y;
        v[2] += p23.x;
        v[3] += p23.y;
    }
    block_sums(v, scratch, total);
    if (threadIdx.x != 0) return;
    const double n = (double)a.n;
    const float approx_kl = (float)(total[0] / n);
    const float pg_loss = (float)(total[1] / n);
    const float v_loss = __fmul_rn((float)(total[2] / n), 0.5f);
    const float entropy = normal_lp::sum2(__fadd_rn(a.log_std[0], a.entropy_c),
                                          __fadd_rn(a.log_std[1], a.entropy_c));
    const float clip_frac = __fmul_rn((float)total[3], a.inv_n);
    const float l = __fadd_rn(__fadd_rn(pg_loss, __fmul_rn(-entropy, a.ent_coef)),
                              __fmul_rn(v_loss, a.vf_coef));
    *loss = l;
    stats[0] = l;
    stats[1] = pg_loss;
    stats[2] = v_loss;
    stats[3] = entropy;
    stats[4] = approx_kl;
    stats[5] = clip_frac;
}

// autograd's backward of torch.maximum(x, y): where(x == y, grad / 2, grad), then
// 0 where x is the smaller (for x) or the larger (for y)
__device__ __forceinline__ void max_backward(float x, float y, float g, float* gx, float* gy) {
    const float h = x == y ? __fmul_rn(g, 0.5f) : g;
    *gx = x < y ? 0.0f : h;
    *gy = x > y ? 0.0f : h;
}

__global__ void __launch_bounds__(kThreads) ppo_head_backward_kernel(
        HeadArgs a, const float* __restrict__ g_loss, float* __restrict__ g_mu,
        float* __restrict__ g_v) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    const Inputs x = load_row(a, i);
    // the maxima's upstream gradients, as the means' and products' backward form them
    const float g = *g_loss;
    const float gp = __fmul_rn(g, a.inv_n);
    const float gv = __fmul_rn(__fmul_rn(__fmul_rn(g, a.vf_coef), 0.5f), a.inv_n);
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

// Minibatch m's moments, by a cluster of kMomentCluster blocks (cluster m of the grid).
// Its n flat rows (row r is unit ids[r / block], offset r % block of adv [units, block])
// are taken by the cluster's threads g = rank * kMomentThreads + t in a stride of the
// cluster's G threads: rows g, g + G, ... in order, kMomentUnroll loaded before they
// are added, in float64, as deviations d from the minibatch's first row (the shift):
// the sum of d and of d * d. Each block sums its threads' by the block's tree (each
// warp's by warp_sum, the warps' in order), then rank 0 the blocks' in rank order from
// the others' shared memory; mean = shift + S / n, var = (Q - S * S / n) / (n - 1).
__global__ void __cluster_dims__(kMomentCluster, 1, 1) __launch_bounds__(kMomentThreads)
advantage_moments_kernel(const float* __restrict__ adv, const long long* __restrict__ index,
                         float* __restrict__ table, long long ids_per_row, long long block,
                         long long units) {
    __shared__ double scratch[2][kMomentWarps];
    __shared__ double partial[2];
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const unsigned m = blockIdx.x / kMomentCluster;
    const long long* ids = index + (long long)m * ids_per_row;
    const unsigned n = (unsigned)(ids_per_row * block), bl = (unsigned)block;
    constexpr unsigned G = kMomentCluster * kMomentThreads;
    const long long first = ids[0];
    // the cluster's thread g: row g's unit slot k and offset o, and a stride's steps
    const unsigned g = rank * kMomentThreads + threadIdx.x;
    unsigned k = g / bl, o = g - k * bl;
    const unsigned dk = G / bl, dof = G - dk * bl;
    if (first < 0 || first >= units) __trap();  // as index_select
    const double shift = (double)adv[first * block];
    double s = 0.0, q = 0.0;
    for (unsigned r0 = g; r0 < n; r0 += G * kMomentUnroll) {
        // the ids first, then one check of them all, then the rows: a trap between two
        // loads would keep the second from issuing before the first returned
        long long u[kMomentUnroll];
        unsigned off[kMomentUnroll];
#pragma unroll
        for (int j = 0; j < kMomentUnroll; ++j) {
            u[j] = r0 + j * G < n ? ids[k] : 0;
            off[j] = o;
            o += dof;
            k += dk;
            if (o >= bl) {
                o -= bl;
                ++k;
            }
        }
        bool bad = false;
#pragma unroll
        for (int j = 0; j < kMomentUnroll; ++j) bad |= u[j] < 0 || u[j] >= units;
        if (bad) __trap();  // as index_select
        float x[kMomentUnroll];
#pragma unroll
        for (int j = 0; j < kMomentUnroll; ++j)
            x[j] = r0 + j * G < n ? adv[u[j] * block + off[j]] : 0.0f;
#pragma unroll
        for (int j = 0; j < kMomentUnroll; ++j) {
            if (r0 + j * G >= n) break;
            const double d = (double)x[j] - shift;
            s += d;
            q += d * d;
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
        scratch[0][warp] = s;
        scratch[1][warp] = q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double bs = scratch[0][0], bq = scratch[1][0];
#pragma unroll
        for (int w = 1; w < kMomentWarps; ++w) {
            bs += scratch[0][w];
            bq += scratch[1][w];
        }
        partial[0] = bs;
        partial[1] = bq;
    }
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
        double S = 0.0, Q = 0.0;
#pragma unroll
        for (int c = 0; c < kMomentCluster; ++c) {
            const double* p = cluster.map_shared_rank(partial, c);
            S += p[0];
            Q += p[1];
        }
        const double var = (Q - S * S / (double)n) / (double)(n - 1);
        table[2 * m] = (float)(shift + S / (double)n);
        table[2 * m + 1] = (float)sqrt(var < 0.0 ? 0.0 : var);  // NaN (n = 1) stays
    }
    cluster.sync();  // every block's partial stays until rank 0 has read it
}

constexpr int kInputs = 11;  // HeadArgs' pointers, the unit ids last (null for none)
constexpr int kConsts = 9;

// the arguments, or false where they are not valid
bool head_args(const void* const* ptrs, const float* consts, long long n, long long block,
               long long units, long long moment_rows, HeadArgs* out) {
    HeadArgs a;
    a.mu = static_cast<const float*>(ptrs[0]);
    a.v = static_cast<const float*>(ptrs[1]);
    a.action = static_cast<const float*>(ptrs[2]);
    a.old_lp = static_cast<const float*>(ptrs[3]);
    a.adv = static_cast<const float*>(ptrs[4]);
    a.ret = static_cast<const float*>(ptrs[5]);
    a.val = static_cast<const float*>(ptrs[6]);
    a.log_std = static_cast<const float*>(ptrs[7]);
    a.moments = static_cast<const float*>(ptrs[8]);
    a.at = static_cast<const long long*>(ptrs[9]);
    a.unit_ids = static_cast<const long long*>(ptrs[10]);
    a.n = n;
    a.block = block;
    a.units = units;
    a.moment_rows = moment_rows;
    a.lo = consts[0];
    a.hi = consts[1];
    a.neg_clip = consts[2];
    a.clip = consts[3];
    a.half_log_2pi = consts[4];
    a.adv_eps = consts[5];
    a.entropy_c = consts[6];
    a.ent_coef = consts[7];
    a.vf_coef = consts[8];
    a.inv_n = 1.0f / (float)n;  // as the card's mean: a float32 quotient of float32(n)
    if (n < 1 || moment_rows < 1) return false;
    if (a.unit_ids != nullptr && (block < 1 || n % block != 0 || units < 1)) return false;
    *out = a;
    return true;
}

unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// The head's partial sums' scratch: float64 values the forward takes at n rows.
extern "C" long long ppo_head_partials(long long n) { return (long long)blocks_for(n) * kSums; }

// ptrs: the kInputs pointers in HeadArgs' order (float32, contiguous; the moments
// [moment_rows, 2], the row `at` int64 [1], the unit ids int64 or null); consts: the
// kConsts float32 constants in HeadArgs' order; partial: ppo_head_partials(n)
// float64 of scratch; ticket: a uint32 counter, 0 (and left 0); out: the loss (one
// float32) and the six stats; block and units: the unit-indexed fields' [units,
// block] (ignored without ids). Returns a cudaError_t.
extern "C" int ppo_head_forward_f32(const void* const* ptrs, int num_ptrs,
                                    const float* consts, int num_consts, double* partial,
                                    unsigned int* ticket, float* loss, float* stats,
                                    long long n, long long block, long long units,
                                    long long moment_rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    HeadArgs a;
    if (num_ptrs != kInputs || num_consts != kConsts
            || !head_args(ptrs, consts, n, block, units, moment_rows, &a))
        return (int)cudaErrorInvalidValue;
    ppo_head_forward_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, partial, ticket, loss, stats);
    return (int)cudaGetLastError();
}

// The backward: the forward's inputs, the loss's upstream gradient (one float32), out
// d/d mu [n, 2] and d/d v [n]; the rest as the forward's.
extern "C" int ppo_head_backward_f32(const void* const* ptrs, int num_ptrs,
                                     const float* consts, int num_consts, const float* g_loss,
                                     float* g_mu, float* g_v, long long n, long long block,
                                     long long units, long long moment_rows, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    HeadArgs a;
    if (num_ptrs != kInputs || num_consts != kConsts || g_loss == nullptr
            || !head_args(ptrs, consts, n, block, units, moment_rows, &a))
        return (int)cudaErrorInvalidValue;
    ppo_head_backward_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, g_loss, g_mu, g_v);
    return (int)cudaGetLastError();
}

// Every minibatch's advantage mean and unbiased std: adv [units, block] float32,
// index [rows, ids_per_row] int64 unit ids, out table [rows, 2] float32.
extern "C" int advantage_moments_f32(const float* adv, const long long* index, float* table,
                                     long long rows, long long ids_per_row, long long block,
                                     long long units, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    // a minibatch's rows index in 32 bits, past its last one by a pass's stride
    const long long stride = (long long)kMomentCluster * kMomentThreads * kMomentUnroll;
    if (rows < 0 || rows > 0x7fffffffLL / kMomentCluster || ids_per_row < 1 || block < 1
            || units < 1 || ids_per_row * block > 0x7fffffffLL - stride)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    advantage_moments_kernel<<<(unsigned int)(rows * kMomentCluster), kMomentThreads, 0,
                               (cudaStream_t)stream>>>(adv, index, table, ids_per_row, block,
                                                       units);
    return (int)cudaGetLastError();
}

extern "C" const char* ppo_head_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
