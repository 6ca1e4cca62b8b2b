// The rollout step's policy, for NVIDIA Hopper (sm_90a): the learner's sample written
// straight into the rollout buffers (policy_act_f32), and the frozen pool opponents'
// actions (pool_act_f32).
//
// Replaces the policy part of the JAX package's rollout step, which XLA fuses into the
// rollout program on the TPU: one_step's normaliser and sample_action
// (self_play_racing_tpu/agent/ppo.py:354, :362; models/actor_critic.py:99 and, greedy,
// :118; envs/normalize.py:49) and the opponents' actions (envs/selfplay.py:53
// opponent_actions, :109 opponent_actions_all_seats). In PyTorch the same work is
// about 35 launches a learner step (the normaliser, the noise row's index_select, six
// cuBLAS GEMMs with their bias adds and tanh, the sample's and log-prob's elementwise
// chain, four index_copy_ into the buffers) and about 25 an opponent step (a batched
// GEMM a layer over the pool, the gather by index, the uniform action, the select,
// the cat with the learner's action).
//
// policy_act_f32: whole towers obs -> H1 -> H2 -> {2, 1} (the critic may be absent)
// on a tile of rows a block. The block stages both towers in 16-byte cp.async copies
// (mlp_tower.cuh's stage_first_layer and stage_later_layers) in two commit groups,
// the first layers with the tile's observations, then the rest; the observations
// are copied as they are, then normalised in shared memory where a normaliser is
// given, ((obs - mean) / sqrt(var + eps)) clamped to +-clip, in envs/normalize.py's
// order, each normalised row also written to its place in the rollout's obs buffer.
// Layer 1 runs while the second group is in flight. Groups of warps, (actor, critic)
// x the tile's 16-row fragments, each run one fragment through one tower
// (mlp_tower.cuh's GroupTower: the warps split each hidden layer's n-tiles, h1 and
// h2 pass through the group's shared tile, one warp runs the last layer), so that
// the three-layer chain of mma.sync products is spread over the SM's four
// schedulers. A tile of 32 rows and four warps a fragment while the blocks fit one
// an SM; beyond that (several blocks an SM, where the issue of the products and
// tanh, not their latency, sets the time) 64 rows and a warp a fragment, which stage
// the towers once for twice the rows. Each output element is summed in
// mlp_forward_f32's order, so a row's mu and v are bitwise that kernel's on the
// same row. The actor's lanes then form the sample, clamp(mu + exp(log_std) *
// noise, -1, 1), with noise row t of [T, n, 2] (t read on the card), and its
// log-prob with normal_lp.cuh (ppo_head.cu's code), and write row t of the actions,
// log-probs and values; with no noise the action is mu (greedy) and no log-prob is
// written. So the rollout's log-prob is bitwise the one the first minibatch
// recomputes: approx_kl and clip_frac come out exactly 0 there.
//
// pool_act_f32: the members' actor towers on env-major rows: row r is car off + r %
// seats of env r / seats of obs [envs, cars, d]. A row's member is the env's entry of
// an [envs] index, a one-entry index (one member for all) or, in seat mode, the car
// itself. A block owns kPoolRange consecutive rows and one member (a grid of ranges x
// the members present): it takes, in row order, the range's rows of its member whose
// use_policy holds (a ballot and popc a warp, the warps' counts added in order), packs
// them into 16-row fragments, and gathers their observations into its tile; a block
// with no such row returns before it stages anything. So each row's tower runs once,
// under its own member, and no tower runs for a row whose use_policy is False, which
// the same block gives its uniform action, maximum(low, u * (high - low) + low). A
// row's fragment position does not change its bits (a row's products depend on that
// row alone). Eight warps, two a fragment (GroupTower), run the packed fragments in
// waves of one a group; with 128 rows a range, a pool of 5 per env fills about one
// wave and one member on 80% of the envs two (a range of 256 or four warps were
// slower at 4096 rows, scripts/policy_kernel_split.py). Registers for two blocks an
// SM at (64, 64). Each member's frozen normaliser applies where the pool carries
// one; the sample takes that member's exp(log_std). Given the learner's action, the first
// member's block of each range writes it to car 0, so the multi env's action needs no
// cat. Staging all P towers in one block would split a warp's m16 fragment across
// members.
//
// Everything after the towers is float32 in PyTorch's order of operations on the
// card (-fmad=false, IEEE divides and square roots, expf, the NaN rules of clamp and
// maximum): bitwise the composition applied to the kernels' own mu. The towers' sums
// run in another order than cuBLAS's: mu and v are held to the composition within
// chip_smoke.py phase p's tolerance (phase q).
//
// Bounds on an H100 SXM at 4096 rows and (19, 64, 64), the products as 3xTF32 at 495
// TFLOP/s: policy_act both towers, 10,816 multiply-adds a row, 0.54 us; pool_act one
// member's actor, 5,440 a row, 0.27 us; the bytes (observations, buffers, noise,
// weights) are under 1 MB, ~0.3 us. Both are far under the launch floor (~1.5 us): a
// launch is its latency, the staging of the towers and the chain of three layers.
// scripts/policy_kernel_split.py splits the time by the `// split:` stops below.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_tower.cuh"
#include "normal_lp.cuh"

namespace {

using namespace mlp_tower;

constexpr int kTower = 6;       // a tower's tensors: w1 b1 w2 b2 w3 b3
// policy_act's tiles: rows a block and warps on one fragment of one tower; a block
// runs (actor, critic) x its fragments. The narrow tile while the blocks fit one an
// SM, the wide one (where its block fits) when they outnumber the SMs: then a block
// stages the towers for twice the rows, a warp a fragment.
constexpr int kActRows = 32;
constexpr int kActSplit = 4;
constexpr int kActWideRows = 64;
constexpr int kActWideSplit = 1;
template <int rows, int split>
__host__ __device__ constexpr int act_threads() { return 32 * 2 * (rows / 16) * split; }
constexpr int kPoolRange = 128;  // pool_act's rows a block
constexpr int kPoolWarps = 8;
constexpr int kPoolSplit = 2;    // pool_act's warps on one fragment
constexpr int kPoolMinBlocks = 2;  // pool_act's blocks an SM at (64, 64): registers for two
constexpr int kPoolThreads = 32 * kPoolWarps;
constexpr int kPoolGroups = kPoolWarps / kPoolSplit;
constexpr int kPoolWave = 16 * kPoolGroups;  // pool_act's packed rows staged at once
constexpr int kActPtrs = 6 + 2 * kTower + 5;
constexpr int kPoolPtrs = 1 + kTower + 9;
static_assert(kPoolRange % 16 == 0 && kPoolWarps % kPoolSplit == 0, "pool_act's shape");

// torch.clamp on the card: NaN passes through
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

// Rows r of a launch at their places in an [envs, cars, ...] array: car off + r %
// seats of env r / seats.
struct Rows {
    long long seats, cars, off;
    __device__ __forceinline__ long long place(long long r) const {
        return (r / seats) * cars + off + r % seats;
    }
};

// envs/normalize.py:apply of feature c: (o - m) / sqrt(v + eps), clamped to +-clip
__device__ __forceinline__ float normalised(float value, const float* mean, const float* var,
                                            int c, float eps, float clip) {
    const float scale = __fsqrt_rn(__fadd_rn(var[c], eps));
    return clamp_nan(__fdiv_rn(__fsub_rn(value, mean[c]), scale), -clip, clip);
}

// A normaliser's mean and var [d] into mv [2][xs], a float a copy: part of the
// caller's commit group with the observations. The observations are copied as they
// are (every load in flight at once) and normalised in shared memory once they land.
template <int threads>
__device__ __forceinline__ void stage_norm(const float* mean, const float* var, int d, int xs,
                                           float* mv) {
    for (int c = threadIdx.x; c < d; c += threads) {
        cp_async4(mv + c, mean + c, true);
        cp_async4(mv + xs + c, var + c, true);
    }
}

// The sample of one row: clamp(mu + exp(log_std) * noise, -1, 1) a dimension, and
// its log-prob under (mu, exp(log_std)) in normal_lp.cuh's order.
__device__ __forceinline__ void sample(const float (&mu)[2], const float* log_std,
                                       const float* noise, float half_log_2pi,
                                       float (&act)[2], float* lp) {
    float terms[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const float ls = log_std[j];
        act[j] = clamp_nan(__fadd_rn(mu[j], __fmul_rn(expf(ls), noise[j])), -1.0f, 1.0f);
        terms[j] = normal_lp::term(__fsub_rn(act[j], mu[j]), normal_lp::denominator(ls), ls,
                                   half_log_2pi);
    }
    *lp = normal_lp::sum2(terms[0], terms[1]);
}

// ------------------------------------------------------------------ policy_act

struct ActArgs {
    const float* obs;          // [n, d] at a row stride
    const long long* t;        // [1]: the buffers' row (null: row 0)
    const float* noise;        // [steps, n, 2], row t (null: greedy, the action is mu)
    const float* mean;         // [d] (null: no normaliser)
    const float* var;          // [d]
    const float* log_std;      // [2] (with noise)
    const float* w[2 * kTower];  // the actor's six tensors, the critic's (null: none)
    float* action;             // [n, 2] (null: not written)
    float* obs_rows;           // [steps, n, d], row t: the normalised rows (null: not)
    float* action_rows;        // [steps, n, 2], row t (null: not)
    float* logprob_rows;       // [steps, n], row t (null: not; needs noise)
    float* value_rows;         // [steps, n], row t (null: not; needs the critic)
    long long n, steps, stride;
    int d;
    float eps, clip, half_log_2pi;
};

// The tile's observations, rows [row0, row0 + rows) of obs at a row stride, into
// x [rows][xs] as they are (features from d and rows from n zero-filled), and the
// normaliser into mv: the first commit group's, in flight with the towers' copies.
template <int rows, int threads>
__device__ __forceinline__ void stage_obs(const ActArgs& a, int xs, long long row0, float* x,
                                          float* mv) {
    for (int e = threadIdx.x; e < rows * xs; e += threads) {
        const int r = e / xs, c = e - r * xs;
        const bool valid = row0 + r < a.n && c < a.d;
        cp_async4(x + e, valid ? a.obs + (row0 + r) * a.stride + c : a.obs, valid);
    }
    if (a.mean != nullptr) stage_norm<threads>(a.mean, a.var, a.d, xs, mv);
}

// Once the tile has landed: its rows normalised in place where a normaliser is given,
// and each row (normalised or not) written to out [n, d] (null: not).
template <int rows, int threads>
__device__ __forceinline__ void finish_obs(const ActArgs& a, int xs, long long row0, float* x,
                                           const float* mv, float* out) {
    for (int e = threadIdx.x; e < rows * xs; e += threads) {
        const int r = e / xs, c = e - r * xs;
        const long long row = row0 + r;
        if (row < a.n && c < a.d) {
            float value = x[e];
            if (a.mean != nullptr) {
                value = normalised(value, mv, mv + xs, c, a.eps, a.clip);
                x[e] = value;
            }
            if (out != nullptr) out[row * a.d + c] = value;
        }
    }
}

template <int H1, int H2, int rows, int split>
__host__ __device__ int act_floats(int d) {
    const Layout<H1, H2> L(d);
    // both towers, the tile, the normaliser's mean and var, the groups' tiles
    return 2 * L.tower + rows * L.xs + 2 * L.xs
        + 2 * (rows / 16) * GroupTower<H1, H2, split>::floats;
}

template <int H1, int H2, int rows, int split>
__global__ void __launch_bounds__(act_threads<rows, split>()) policy_act_kernel(ActArgs a) {
    using Group = GroupTower<H1, H2, split>;
    constexpr int threads = act_threads<rows, split>(), frags = rows / 16;
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const Layout<H1, H2> L(a.d);
    const bool critic = a.w[kTower] != nullptr;
    float* x = s + 2 * L.tower;
    float* mv = x + rows * L.xs;
    const long long row0 = (long long)blockIdx.x * rows;
    // two commit groups: both towers' first layers and the tile, then the rest
    stage_first_layer<H1, H2, threads>(L, a.w, s);
    if (critic) stage_first_layer<H1, H2, threads>(L, a.w + kTower, s + L.tower);
    stage_obs<rows, threads>(a, L.xs, row0, x, mv);
    cp_async_commit();
    stage_later_layers<H1, H2, threads>(L, a.w, s, 2);
    if (critic) stage_later_layers<H1, H2, threads>(L, a.w + kTower, s + L.tower, 1);
    cp_async_commit();
    const long long t = a.t == nullptr ? 0 : *a.t;
    if (t < 0 || t >= a.steps) __trap();  // as index_select and index_copy_
    cp_async_wait<1>();
    __syncthreads();
    if (a.mean != nullptr || a.obs_rows != nullptr) {
        finish_obs<rows, threads>(a, L.xs, row0, x, mv,
                                  a.obs_rows == nullptr ? nullptr : a.obs_rows + t * a.n * a.d);
        __syncthreads();
    }
    // split: act staged { cp_async_wait<0>(); return; }
    // groups [0, frags) the actor, [frags, 2 frags) the critic, fragment f on the
    // tile's rows [16 f, 16 f + 16)
    const int warp = threadIdx.x >> 5, group = warp / split;
    const int tower = group / frags, frag = group - tower * frags;
    const bool active = (tower == 0 || critic) && row0 + 16 * frag < a.n;
    const Lane l(threadIdx.x & 31);
    Group gt(mv + 2 * L.xs + group * Group::floats, warp % split, 1 + group);
    const float* T = s + tower * L.tower;
    if (active) gt.first(L, T, x + 16 * frag * L.xs, false, l);
    // split: act layer1 { if (active) sink(gt.h1); return; }
    cp_async_wait<0>();
    __syncthreads();
    float y0[2], y1[2];
    if (!active || !gt.rest(L, T, 2 - tower, y0, y1, l)) return;
    // split: act towers { sink(y0, y1); return; }
    // lane t 0 writes row g, lane 1 row g + 8 (every lane of the row holds its sums)
    const long long r = row0 + 16 * frag + (l.t == 0 ? l.g : l.g + 8);
    if (l.t >= 2 || r >= a.n) return;
    const long long at = t * a.n + r;
    const float mu[2] = {l.t == 0 ? y0[0] : y1[0], l.t == 0 ? y0[1] : y1[1]};
    if (tower == 1) {
        if (a.value_rows != nullptr) a.value_rows[at] = mu[0];
        return;
    }
    float act[2] = {mu[0], mu[1]};
    if (a.noise != nullptr) {
        float lp;
        sample(mu, a.log_std, a.noise + 2 * at, a.half_log_2pi, act, &lp);
        if (a.logprob_rows != nullptr) a.logprob_rows[at] = lp;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        if (a.action != nullptr) a.action[2 * r + j] = act[j];
        if (a.action_rows != nullptr) a.action_rows[2 * at + j] = act[j];
    }
}

// ------------------------------------------------------------------ pool_act

enum MemberKind { kSeat = 0, kPerEnv = 1, kOne = 2 };

struct PoolArgs {
    const float* obs;          // [envs, seats, d] at an env stride of env_stride floats
    const float* w[kTower];    // the members' actor tensors, stacked [P, ...]
    const float* log_std;      // [P, 2] (with noise)
    const float* mean;         // [P, d] (null: no normaliser)
    const float* var;          // [P, d]
    const void* member;        // [envs] or [1], int32 or int64 (seat mode: null)
    const float* noise;        // [rows, 2] (null: greedy)
    const float* uniforms;     // [rows, 2] (null: no random actions)
    const bool* use_policy;    // [envs] or [1] (with uniforms)
    const float* first;        // [envs, 2]: car 0's action (null: not written)
    float* out;                // [envs, cars, 2] at the rows' places
    Rows map;                  // the rows' places in out
    long long rows, env_stride;
    int d, members, kind, member64, use_per_env;
    float eps, clip, low[2], high[2];
};

__device__ __forceinline__ int member_at(const PoolArgs& a, long long i) {
    const long long m = a.member64 ? static_cast<const long long*>(a.member)[i]
                                   : static_cast<const int*>(a.member)[i];
    if (m < 0 || m >= a.members) __trap();  // as the gather by index
    return (int)m;
}

// The block's rows of member p: of rows r0 + i (i < kPoolRange, r < rows), those whose
// member is p and whose use_policy holds, their offsets i into list and their
// observations' offsets in obs into bases, in row order (a ballot a warp, the warps'
// counts added in warp order); returns how many. On the way, each of member p's rows
// whose use_policy is False gets its uniform action, and, where the learner's action
// is given, the grid's first member's block writes car 0 of each env that starts in
// its range.
__device__ __forceinline__ int pack_rows(const PoolArgs& a, int p, long long r0, int* list,
                                         long long* bases, int* counts) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int total = 0;
    for (int base = 0; base < kPoolRange; base += kPoolThreads) {
        const int i = base + threadIdx.x;
        const long long r = r0 + i;
        bool take = false;
        long long obs_at = 0;
        if (i < kPoolRange && r < a.rows) {
            const long long env = r / a.map.seats, seat = r - env * a.map.seats;
            const long long place = env * a.map.cars + a.map.off + seat;
            const bool use = a.uniforms == nullptr || a.use_policy[a.use_per_env ? env : 0];
            // the row's member: the one index, the env's entry, or (seat mode) its car
            const int mine = a.kind == kOne ? p
                : a.kind == kPerEnv ? member_at(a, env) : (int)(a.map.off + seat);
            if (a.first != nullptr && blockIdx.y == 0 && seat == 0) {
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    a.out[2 * env * a.map.cars + j] = a.first[2 * env + j];
            }
            if (mine == p) {
                take = use;
                obs_at = env * a.env_stride + seat * a.d;
                if (!take) {
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const float u = __fmul_rn(a.uniforms[2 * r + j],
                                                  __fsub_rn(a.high[j], a.low[j]));
                        a.out[2 * place + j] = max_nan(a.low[j], __fadd_rn(u, a.low[j]));
                    }
                }
            }
        }
        const unsigned mask = __ballot_sync(0xffffffffu, take);
        if (lane == 0) counts[warp] = __popc(mask);
        __syncthreads();
        int at = total;
#pragma unroll
        for (int v = 0; v < kPoolWarps; ++v) {
            if (v < warp) at += counts[v];
            total += counts[v];
        }
        if (take) {
            at += __popc(mask & ((1u << lane) - 1u));
            list[at] = i;
            bases[at] = obs_at;
        }
        __syncthreads();
    }
    return total;
}

// Packed rows [0, count) (at most a wave) into x [kPoolWave][xs] as they are, packed
// row j from obs + bases[j] (features from d and the last fragment's rows from count
// zero-filled): cp.async copies, a float each, the caller's commit group.
__device__ __forceinline__ void gather_obs(const PoolArgs& a, const long long* bases, int count,
                                           int xs, float* x) {
    const int rows = round_up(count, 16);
    for (int e = threadIdx.x; e < rows * xs; e += kPoolThreads) {
        const int j = e / xs, c = e - j * xs;
        const bool valid = j < count && c < a.d;
        cp_async4(x + e, valid ? a.obs + bases[j] + c : a.obs, valid);
    }
}

// Once the wave has landed: its rows [0, count) normalised in place by mv [2][xs]
__device__ __forceinline__ void normalise_obs(const PoolArgs& a, int count, int xs,
                                              const float* mv, float* x) {
    for (int e = threadIdx.x; e < count * xs; e += kPoolThreads) {
        const int j = e / xs, c = e - j * xs;
        if (c < a.d) x[e] = normalised(x[e], mv, mv + xs, c, a.eps, a.clip);
    }
}

template <int H1, int H2>
__host__ __device__ int pool_floats(int d) {
    const Layout<H1, H2> L(d);
    // the tower, a wave's tile, the normaliser's mean and var, the groups' activation
    // tiles, then the range's packed rows' observation offsets (int64) and offsets,
    // and the warps' counts
    return L.tower + kPoolWave * L.xs + 2 * L.xs
        + kPoolGroups * GroupTower<H1, H2, kPoolSplit>::floats + 3 * kPoolRange + kPoolWarps;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kPoolThreads, H1 == 64 ? kPoolMinBlocks : 1)
    pool_act_kernel(PoolArgs a) {
    using Group = GroupTower<H1, H2, kPoolSplit>;
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const Layout<H1, H2> L(a.d);
    float* x = s + L.tower;
    float* mv = x + kPoolWave * L.xs;
    float* tiles = mv + 2 * L.xs;
    long long* bases = reinterpret_cast<long long*>(tiles + kPoolGroups * Group::floats);
    int* list = reinterpret_cast<int*>(bases + kPoolRange);
    const int p = a.kind == kOne ? member_at(a, 0) : (int)blockIdx.y;
    const long long r0 = (long long)blockIdx.x * kPoolRange;
    const int count = pack_rows(a, p, r0, list, bases, list + kPoolRange);
    // split: pool packed { if (count == 12345) a.out[0] = 0.0f; return; }
    if (count == 0) return;
    const long long sizes[kTower] = {(long long)a.d * H1, H1, H1 * H2, H2, 2 * H2, 2};
    const float* w[kTower];
#pragma unroll
    for (int i = 0; i < kTower; ++i) w[i] = a.w[i] + p * sizes[i];
    // two commit groups: the first layer, the normaliser and the first wave's rows,
    // then the rest
    stage_first_layer<H1, H2, kPoolThreads>(L, w, s);
    if (a.mean != nullptr)
        stage_norm<kPoolThreads>(a.mean + (long long)p * a.d, a.var + (long long)p * a.d, a.d,
                                 L.xs, mv);
    gather_obs(a, bases, min(count, kPoolWave), L.xs, x);
    cp_async_commit();
    stage_later_layers<H1, H2, kPoolThreads>(L, w, s, 2);
    cp_async_commit();
    // split: pool staged { cp_async_wait<0>(); return; }
    const int warp = threadIdx.x >> 5, group = warp / kPoolSplit;
    const int frags = (count + 15) / 16;
    const Lane l(threadIdx.x & 31);
    Group gt(tiles + group * Group::floats, warp % kPoolSplit, 1 + group);
    // waves of a fragment a group: the first wave's layer 1 runs while the towers'
    // later layers are in flight
    for (int f0 = 0; f0 < frags; f0 += kPoolGroups) {
        const int rows = min(count - 16 * f0, kPoolWave);
        if (f0 == 0) {
            cp_async_wait<1>();
        } else {
            __syncthreads();  // the last wave is done with x and the tiles
            gather_obs(a, bases + 16 * f0, rows, L.xs, x);
            cp_async_commit();
            cp_async_wait<0>();
        }
        __syncthreads();
        if (a.mean != nullptr) {
            normalise_obs(a, rows, L.xs, mv, x);
            __syncthreads();
        }
        const int f = f0 + group;
        if (f < frags) gt.first(L, s, x + 16 * group * L.xs, false, l);
        if (f0 == 0) {
            cp_async_wait<0>();
            __syncthreads();
        } else if (f < frags) {
            gt.sync();
        }
        // split: pool layer1 { if (f < frags) sink(gt.h1); continue; }
        float y0[2], y1[2];
        if (f >= frags || !gt.rest(L, s, 2, y0, y1, l)) continue;
        const int j = 16 * f + (l.t == 0 ? l.g : l.g + 8);
        if (l.t < 2 && j < count) {
            const long long r = r0 + list[j], place = a.map.place(r);
            const float mu[2] = {l.t == 0 ? y0[0] : y1[0], l.t == 0 ? y0[1] : y1[1]};
            float act[2] = {mu[0], mu[1]};
            if (a.noise != nullptr) {
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    act[k] = clamp_nan(__fadd_rn(mu[k], __fmul_rn(expf(a.log_std[2 * p + k]),
                                                                  a.noise[2 * r + k])),
                                       -1.0f, 1.0f);
                }
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) a.out[2 * place + k] = act[k];
        }
    }
}

// ------------------------------------------------------------------ launches

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    return bytes > 48 * 1024
        ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
        : cudaSuccess;
}

// the instantiated hidden widths (h1, h2): ops/_cuda.py:MLP_HIDDEN
#define POLICY_HIDDEN(X) X(64, 64) X(128, 128)

// the shared bytes a block of policy_act (pool 0) or pool_act (1) takes at (d, h1,
// h2), 0 where it does not: widths not instantiated, d < 1, over a block's memory
long long shared_bytes(int pool, int d, int h1, int h2) {
    if (d < 1) return 0;
#define POLICY_BYTES(w1, w2)                                                          \
    if (h1 == w1 && h2 == w2) {                                                       \
        const long long b = 4LL * (pool ? pool_floats<w1, w2>(d)                      \
                                        : act_floats<w1, w2, kActRows, kActSplit>(d));   \
        return b <= kMaxSharedBytes ? b : 0;                                          \
    }
    POLICY_HIDDEN(POLICY_BYTES)
#undef POLICY_BYTES
    return 0;
}

}  // namespace

// The shared bytes a block of policy_act_f32 (pool 0) or pool_act_f32 (pool 1) takes
// at towers obs_dim -> h1 -> h2, or 0 where the kernel does not take them.
extern "C" int policy_shared_bytes(int pool, int obs_dim, int h1, int h2) {
    return (int)shared_bytes(pool, obs_dim, h1, h2);
}

// The rows a block of policy_act_f32 and of pool_act_f32 (its range) takes.
extern "C" int policy_rows_per_block(int pool) { return pool ? kPoolRange : kActRows; }

// policy_act: ptrs the kActPtrs pointers in ActArgs' order (obs, t, noise, mean,
// var, log_std, the 12 tower tensors, action, obs_rows, action_rows, logprob_rows,
// value_rows; float32, the t int64; null where absent), n rows of obs at a row
// stride of stride floats, steps the buffers' rows, consts (eps, clip, 0.5 log 2 pi).
// Returns a cudaError_t.
extern "C" int policy_act_f32(const void* const* ptrs, int num_ptrs, long long n,
                              long long steps, long long stride, int obs_dim, int h1,
                              int h2, const float* consts, int num_consts, int device,
                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kActPtrs || num_consts != 3 || n < 0 || steps < 1 || stride < obs_dim
            || shared_bytes(0, obs_dim, h1, h2) == 0 || (n + kActRows - 1) / kActRows > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    ActArgs a;
    a.obs = static_cast<const float*>(ptrs[0]);
    a.t = static_cast<const long long*>(ptrs[1]);
    a.noise = static_cast<const float*>(ptrs[2]);
    a.mean = static_cast<const float*>(ptrs[3]);
    a.var = static_cast<const float*>(ptrs[4]);
    a.log_std = static_cast<const float*>(ptrs[5]);
    for (int i = 0; i < 2 * kTower; ++i) a.w[i] = static_cast<const float*>(ptrs[6 + i]);
    float* out[5];
    for (int i = 0; i < 5; ++i)
        out[i] = static_cast<float*>(const_cast<void*>(ptrs[6 + 2 * kTower + i]));
    a.action = out[0];
    a.obs_rows = out[1];
    a.action_rows = out[2];
    a.logprob_rows = out[3];
    a.value_rows = out[4];
    a.n = n;
    a.steps = steps;
    a.stride = stride;
    a.d = obs_dim;
    a.eps = consts[0];
    a.clip = consts[1];
    a.half_log_2pi = consts[2];
    bool actor = true, critic = true, none = true;
    for (int i = 0; i < kTower; ++i) {
        actor = actor && a.w[i] != nullptr;
        critic = critic && a.w[kTower + i] != nullptr;
        none = none && a.w[kTower + i] == nullptr;
    }
    if (!actor || a.obs == nullptr || (!critic && !none) || (a.mean == nullptr) != (a.var == nullptr)
            || (a.noise != nullptr && a.log_std == nullptr)
            || (a.logprob_rows != nullptr && a.noise == nullptr)
            || (a.value_rows != nullptr && !critic)
            || (a.action == nullptr && a.action_rows == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const bool wide = (n + kActRows - 1) / kActRows > sms;
#define POLICY_TILE(w1, w2, rows, split)                                              \
    {                                                                                 \
        const long long bytes = 4LL * act_floats<w1, w2, rows, split>(obs_dim);       \
        err = allow_smem(policy_act_kernel<w1, w2, rows, split>, bytes);              \
        if (err != cudaSuccess) return (int)err;                                      \
        const unsigned blocks = (unsigned)((n + rows - 1) / rows);                     \
        constexpr int threads = act_threads<rows, split>();                           \
        policy_act_kernel<w1, w2, rows, split><<<blocks, threads, bytes, (cudaStream_t)stream>>>(a); \
        return (int)cudaGetLastError();                                               \
    }
    // the wide tile where the blocks outnumber the SMs and its block fits (64-wide
    // towers), else the narrow one
    if (h1 == 64 && h2 == 64 && wide && 4LL * act_floats<64, 64, kActWideRows, kActWideSplit>(
            obs_dim) <= kMaxSharedBytes)
        POLICY_TILE(64, 64, kActWideRows, kActWideSplit)
#define POLICY_LAUNCH(w1, w2) \
    if (h1 == w1 && h2 == w2) POLICY_TILE(w1, w2, kActRows, kActSplit)
    POLICY_HIDDEN(POLICY_LAUNCH)
#undef POLICY_LAUNCH
#undef POLICY_TILE
    return (int)cudaErrorInvalidValue;
}

// pool_act: ptrs the kPoolPtrs pointers in PoolArgs' order (obs, the 6 stacked actor
// tensors, log_std, mean, var, member, noise, uniforms, use_policy, first, out; null
// where absent), rows env-major (seat r % seats of env r / seats of obs [envs, seats,
// d] at an env stride of env_stride floats, written to car off + r % seats of out
// [envs, cars, 2]), members P, kind 0 seat (the car is the member), 1 an [envs] index, 2 a
// one-entry index, member64 the index's width (int64 1, int32 0), use_per_env the
// use_policy's length (1: [envs], 0: [1]); consts (eps, clip, low0, low1, high0,
// high1). Returns a cudaError_t.
extern "C" int pool_act_f32(const void* const* ptrs, int num_ptrs, long long rows,
                            long long seats, long long cars, long long off,
                            long long env_stride, int members,
                            int kind, int member64, int use_per_env, int obs_dim, int h1,
                            int h2, const float* consts, int num_consts, int device,
                            void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kPoolPtrs || num_consts != 6 || rows < 0 || seats < 1 || cars < 1
            || off < 0 || off + seats > cars || env_stride < seats * obs_dim
            || members < 1 || members > 65535
            || kind < kSeat || kind > kOne || shared_bytes(1, obs_dim, h1, h2) == 0
            || (rows + kPoolRange - 1) / kPoolRange > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    PoolArgs a;
    a.obs = static_cast<const float*>(ptrs[0]);
    for (int i = 0; i < kTower; ++i) a.w[i] = static_cast<const float*>(ptrs[1 + i]);
    a.log_std = static_cast<const float*>(ptrs[7]);
    a.mean = static_cast<const float*>(ptrs[8]);
    a.var = static_cast<const float*>(ptrs[9]);
    a.member = ptrs[10];
    a.noise = static_cast<const float*>(ptrs[11]);
    a.uniforms = static_cast<const float*>(ptrs[12]);
    a.use_policy = static_cast<const bool*>(ptrs[13]);
    a.first = static_cast<const float*>(ptrs[14]);
    a.out = static_cast<float*>(const_cast<void*>(ptrs[15]));
    a.map = Rows{seats, cars, off};
    a.rows = rows;
    a.env_stride = env_stride;
    a.d = obs_dim;
    a.members = members;
    a.kind = kind;
    a.member64 = member64;
    a.use_per_env = use_per_env;
    a.eps = consts[0];
    a.clip = consts[1];
    a.low[0] = consts[2];
    a.low[1] = consts[3];
    a.high[0] = consts[4];
    a.high[1] = consts[5];
    bool actor = a.obs != nullptr && a.out != nullptr;
    for (int i = 0; i < kTower; ++i) actor = actor && a.w[i] != nullptr;
    if (!actor || (a.mean == nullptr) != (a.var == nullptr)
            || (a.noise != nullptr && a.log_std == nullptr)
            || (kind == kSeat) != (a.member == nullptr) || (kind == kSeat && members != cars)
            || (a.uniforms != nullptr && a.use_policy == nullptr)
            || (a.first != nullptr && off != 1))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const long long bytes = shared_bytes(1, obs_dim, h1, h2);
    const dim3 grid((unsigned)((rows + kPoolRange - 1) / kPoolRange),
                    kind == kOne ? 1u : (unsigned)members);
#define POOL_LAUNCH(w1, w2)                                                           \
    if (h1 == w1 && h2 == w2) {                                                       \
        err = allow_smem(pool_act_kernel<w1, w2>, bytes);                             \
        if (err != cudaSuccess) return (int)err;                                      \
        pool_act_kernel<w1, w2><<<grid, kPoolThreads, bytes, (cudaStream_t)stream>>>(a); \
        return (int)cudaGetLastError();                                               \
    }
    POLICY_HIDDEN(POOL_LAUNCH)
#undef POOL_LAUNCH
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* policy_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
