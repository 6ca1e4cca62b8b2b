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
// on a tile of 32 rows a block: the block stages both towers (mlp_tower.cuh's
// stage_tower) and the tile's observations, normalised on the way where a normaliser
// is given, ((obs - mean) / sqrt(var + eps)) clamped to +-clip, in
// envs/normalize.py's order, each normalised row also written to its place in the
// rollout's obs buffer. Warps 0-1 run the actor on 16 rows each, warps 2-3 the
// critic, with mlp_tower.cuh's layer1, layer2 and last_layer: the code that
// mlp_forward_f32 runs, so a row's mu and v are bitwise that kernel's on the same
// row. The actor's lanes then form the sample, clamp(mu + exp(log_std) * noise,
// -1, 1), with noise row t of [T, n, 2] (t read on the card), and its log-prob
// with normal_lp.cuh (ppo_head.cu's code), and write row t of the actions,
// log-probs and values; with no noise the action is mu (greedy) and no log-prob is
// written. So the rollout's log-prob is bitwise the one the first minibatch
// recomputes: approx_kl and clip_frac come out exactly 0 there.
//
// pool_act_f32: one member's actor tower a block, on a grid of 64-row tiles x the
// members present, rows env-major: row r is car off + r % seats of env r / seats of
// obs [envs, cars, d]. A row's member is the env's entry of an [envs] index (all P
// members present; a block writes only its member's rows), a one-entry index (one
// member present) or, in seat mode, the car itself. Each member's frozen normaliser
// applies where the pool carries one; the sample takes that member's exp(log_std).
// Then, with uniforms, the random action maximum(low, u * (high - low) + low) and
// the use_policy select, and the action goes to its car's place in out [envs, cars,
// 2]; given the learner's action, the tile's first seat's blocks of member 0 write
// it to car 0, so the multi env's action needs no cat. Staging all P towers in one
// block would split a warp's m16 fragment across members.
//
// Everything after the towers is float32 in PyTorch's order of operations on the
// card (-fmad=false, IEEE divides and square roots, expf, the NaN rules of clamp and
// maximum): bitwise the composition applied to the kernels' own mu. The towers' sums
// run in another order than cuBLAS's: mu and v are held to the composition within
// chip_smoke.py phase p's tolerance (phase q).
//
// Bounds on an H100 SXM at 4096 rows and (19, 64, 64), the products as 3xTF32 at 495
// TFLOP/s: policy_act both towers, 10,816 multiply-adds a row, 0.54 us; pool_act one
// member's actor, 5,440 a row, 0.27 us (a pool of 5 per env computes 5 times that);
// the bytes (observations, buffers, noise, weights) are under 1 MB, ~0.3 us. Both
// are far under the launch floor (~1.7 us): a launch is its latency, the staging of
// the towers and the chain of three layers a warp. At 4096 rows policy_act runs 128
// blocks (of the card's 132 SMs) with each warp on one tower, the shorter chain.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_tower.cuh"
#include "normal_lp.cuh"

namespace {

using namespace mlp_tower;

constexpr int kTower = 6;       // a tower's tensors: w1 b1 w2 b2 w3 b3
constexpr int kActRows = 32;    // policy_act's rows a block: two warps a tower
constexpr int kActPtrs = 6 + 2 * kTower + 5;
constexpr int kPoolPtrs = 1 + kTower + 9;

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

// The tile's observations, rows [row0, row0 + rows), into x [rows][xs]: row r read at
// obs + (r / seats) * env_stride + (r % seats) * d (seat r % seats of env r / seats),
// normalised where mean is given ((o - m) / sqrt(v + eps), clamped to +-clip),
// features from d and rows from n zero; each normalised row also written to out
// [n, d] (null: not). Loads while the towers' copies are in flight.
__device__ __forceinline__ void stage_obs(const float* obs, long long seats,
                                          long long env_stride, long long n, int d, int xs,
                                          int rows, long long row0, const float* mean,
                                          const float* var, float eps, float clip,
                                          float* x, float* out) {
    for (int e = threadIdx.x; e < rows * xs; e += kThreads) {
        const int r = e / xs, c = e - r * xs;
        const long long row = row0 + r;
        float value = 0.0f;
        if (row < n && c < d) {
            value = obs[(row / seats) * env_stride + (row % seats) * d + c];
            if (mean != nullptr) {
                const float scale = __fsqrt_rn(__fadd_rn(var[c], eps));
                value = clamp_nan(__fdiv_rn(__fsub_rn(value, mean[c]), scale), -clip, clip);
            }
            if (out != nullptr) out[row * d + c] = value;
        }
        x[e] = value;
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

// A warp's tower over its 16 rows of x: (y0, y1) the outputs of rows g and g + 8.
template <int H1, int H2>
__device__ __forceinline__ void warp_tower(const Layout<H1, H2>& L, const float* T,
                                           const float* x, int O, float (&y0)[2],
                                           float (&y1)[2], const Lane& l) {
    float h1[H1 / 8][4], h2[H2 / 8][4];
    layer1(L, T, x, h1, l);
    layer2(L, T, h1, h2, l);
    last_layer<H2>(T + L.w3, T + L.b3, h2, O, y0, y1, l);
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

template <int H1, int H2>
__host__ __device__ int act_floats(int d) {
    const Layout<H1, H2> L(d);
    return 2 * L.tower + kActRows * L.xs;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) policy_act_kernel(ActArgs a) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const Layout<H1, H2> L(a.d);
    const bool critic = a.w[kTower] != nullptr;
    float* x = s + 2 * L.tower;
    stage_tower(L, a.w, s, 2);
    if (critic) stage_tower(L, a.w + kTower, s + L.tower, 1);
    const long long t = a.t == nullptr ? 0 : *a.t;
    if (t < 0 || t >= a.steps) __trap();  // as index_select and index_copy_
    const long long row0 = (long long)blockIdx.x * kActRows;
    stage_obs(a.obs, 1, a.stride, a.n, a.d, L.xs, kActRows, row0, a.mean, a.var,
              a.eps, a.clip, x, a.obs_rows == nullptr ? nullptr : a.obs_rows + t * a.n * a.d);
    cp_async_wait_all();
    __syncthreads();
    const int warp = threadIdx.x >> 5, tower = warp >> 1;  // warps 0-1 actor, 2-3 critic
    if (tower == 1 && !critic) return;
    const Lane l(threadIdx.x & 31);
    float y0[2], y1[2];
    warp_tower(L, s + tower * L.tower, x + 16 * (warp & 1) * L.xs, 2 - tower, y0, y1, l);
    // lane t 0 writes row g, lane 1 row g + 8 (every lane of the row holds its sums)
    const long long r = row0 + 16 * (warp & 1) + (l.t == 0 ? l.g : l.g + 8);
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

template <int H1, int H2>
__host__ __device__ int pool_floats(int d) {
    const Layout<H1, H2> L(d);
    return L.tower + kRows * L.xs;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) pool_act_kernel(PoolArgs a) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const Layout<H1, H2> L(a.d);
    const int p = a.kind == kOne ? member_at(a, 0) : (int)blockIdx.y;
    const long long sizes[kTower] = {(long long)a.d * H1, H1, H1 * H2, H2, 2 * H2, 2};
    const float* w[kTower];
#pragma unroll
    for (int i = 0; i < kTower; ++i) w[i] = a.w[i] + p * sizes[i];
    float* x = s + L.tower;
    stage_tower(L, w, s, 2);
    const long long row0 = (long long)blockIdx.x * kRows;
    stage_obs(a.obs, a.map.seats, a.env_stride, a.rows, a.d, L.xs, kRows, row0,
              a.mean == nullptr ? nullptr : a.mean + (long long)p * a.d,
              a.var == nullptr ? nullptr : a.var + (long long)p * a.d, a.eps, a.clip, x,
              nullptr);
    cp_async_wait_all();
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const Lane l(threadIdx.x & 31);
    float y0[2], y1[2];
    warp_tower(L, s, x + 16 * warp * L.xs, 2, y0, y1, l);
    const long long r = row0 + 16 * warp + (l.t == 0 ? l.g : l.g + 8);
    if (l.t >= 2 || r >= a.rows) return;
    const long long env = r / a.map.seats, place = a.map.place(r);
    if (a.first != nullptr && blockIdx.y == 0 && r % a.map.seats == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) a.out[2 * env * a.map.cars + j] = a.first[2 * env + j];
    }
    // the row's member: the one index, the env's entry, or (seat mode) its car
    const int mine = a.kind == kOne ? p
        : a.kind == kPerEnv ? member_at(a, env) : (int)(place - env * a.map.cars);
    if (mine != p) return;
    const float mu[2] = {l.t == 0 ? y0[0] : y1[0], l.t == 0 ? y0[1] : y1[1]};
    float act[2] = {mu[0], mu[1]};
    if (a.noise != nullptr) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            act[j] = clamp_nan(__fadd_rn(mu[j], __fmul_rn(expf(a.log_std[2 * p + j]),
                                                          a.noise[2 * r + j])), -1.0f, 1.0f);
        }
    }
    if (a.uniforms != nullptr && !a.use_policy[a.use_per_env ? env : 0]) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float u = __fmul_rn(a.uniforms[2 * r + j], __fsub_rn(a.high[j], a.low[j]));
            act[j] = max_nan(a.low[j], __fadd_rn(u, a.low[j]));
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) a.out[2 * place + j] = act[j];
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
        const long long b = 4LL * (pool ? pool_floats<w1, w2>(d) : act_floats<w1, w2>(d)); \
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

// The rows a block of policy_act_f32 and of pool_act_f32.
extern "C" int policy_rows_per_block(int pool) { return pool ? kRows : kActRows; }

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
    const long long bytes = shared_bytes(0, obs_dim, h1, h2);
    const unsigned blocks = (unsigned)((n + kActRows - 1) / kActRows);
#define POLICY_LAUNCH(w1, w2)                                                         \
    if (h1 == w1 && h2 == w2) {                                                       \
        err = allow_smem(policy_act_kernel<w1, w2>, bytes);                           \
        if (err != cudaSuccess) return (int)err;                                      \
        policy_act_kernel<w1, w2><<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(a); \
        return (int)cudaGetLastError();                                               \
    }
    POLICY_HIDDEN(POLICY_LAUNCH)
#undef POLICY_LAUNCH
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
            || (rows + kRows - 1) / kRows > 0x7fffffffLL)
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
    const dim3 grid((unsigned)((rows + kRows - 1) / kRows), kind == kOne ? 1u : (unsigned)members);
#define POOL_LAUNCH(w1, w2)                                                           \
    if (h1 == w1 && h2 == w2) {                                                       \
        err = allow_smem(pool_act_kernel<w1, w2>, bytes);                             \
        if (err != cudaSuccess) return (int)err;                                      \
        pool_act_kernel<w1, w2><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(a);  \
        return (int)cudaGetLastError();                                               \
    }
    POLICY_HIDDEN(POOL_LAUNCH)
#undef POOL_LAUNCH
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* policy_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
