// The rollout step's policy on the general route: towers of any depth (1 to 7 hidden
// layers) and width (1 to 1024, obs_dim 1 to 1024), for NVIDIA Hopper (sm_90a): the
// learner's sample written straight into the rollout buffers (policy_general_act_f32,
// kernel A) and the frozen pool opponents' actions (policy_general_pool_f32, kernel
// B), for the towers that policy.cu's compiled kernels (three layers at (64, 64) and
// (128, 128)) do not take.
//
// Replaces the policy part of the JAX package's rollout step, which XLA fuses into the
// rollout program on the TPU: one_step's normaliser and sample_action
// (self_play_racing_tpu/agent/ppo.py:354, :362; models/actor_critic.py:99 and, greedy,
// :118; envs/normalize.py:49) and the opponents' actions (envs/selfplay.py:53
// opponent_actions, :109 opponent_actions_all_seats). In PyTorch the same work is a
// chain of cuBLAS GEMMs, bias adds, tanh and elementwise launches.
//
// Both kernels run their towers through mlp_stream.cuh's tower_forward, the per-
// element routine of mlp_general.cu's forward: a row's mu and v are bitwise that
// kernel's on the same row (so the first minibatch of an update recomputes the
// rollout's log-prob bitwise, and approx_kl and clip_frac come out exactly 0 there).
//
// Kernel A: a block a tile of the plan's rows. It copies the tile's observations,
// normalises them in shared memory where a normaliser is given (envs/normalize.py's
// order) and writes each to row t of the rollout's obs buffer, runs the actor's
// layers, stages the tile again for the critic's, then a thread a row forms the
// sample, clamp(mu + exp(log_std) * noise, -1, 1) with noise row t (t read on the
// card), its log-prob with normal_lp.cuh (ppo_head.cu's code), and writes row t of
// the actions, log-probs and values; with no noise the action is mu (greedy).
//
// Kernel B: policy.cu's packing: a block owns kPoolRange rows and one
// member, takes in row order that member's rows whose use_policy holds (a ballot a
// warp), and gives the others their uniform action; the packed rows go through the
// member's actor tower in waves of the plan's rows. Each row's tower runs once, under
// its own member; a row's place in a wave does not change its bits.
//
// Everything after the towers is float32 in PyTorch's order of operations
// (-fmad=false, IEEE divides and square roots, expf, the NaN rules of clamp and
// maximum): bitwise the composition applied to the kernels' own mu.
//
// Bounds on an H100 SXM at 4096 rows and (19, 256, 256), 3xTF32 at 495 TFLOP/s:
// kernel A both towers, 141,568 multiply-adds a row, 7.0 us; kernel B one member's
// actor, 70,912 a row, 3.5 us; the bytes are a few MB.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_stream.cuh"
#include "normal_lp.cuh"

namespace {

using namespace mlp_stream;

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

// envs/normalize.py:apply of feature c: (o - m) / sqrt(v + eps), clamped to +-clip
__device__ __forceinline__ float normalised(float value, const float* mean, const float* var,
                                            int c, float eps, float clip) {
    const float scale = __fsqrt_rn(__fadd_rn(var[c], eps));
    return clamp_nan(__fdiv_rn(__fsub_rn(value, mean[c]), scale), -clip, clip);
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

// A tower's layers: weights and biases (the critic's null where absent).
struct Tower {
    const float* w[kMaxLayers];
    const float* b[kMaxLayers];
};

// ------------------------------------------------------------------ kernel A

struct ActArgs {
    const float* obs;          // [n, d] at a row stride
    const long long* t;        // [1]: the buffers' row (null: row 0)
    const float* noise;        // [steps, n, 2], row t (null: greedy, the action is mu)
    const float* mean;         // [d] (null: no normaliser)
    const float* var;          // [d]
    const float* log_std;      // [2] (with noise)
    Tower tower[2];            // the actor, the critic (w[0] null: none)
    float* action;             // [n, 2] (null: not written)
    float* obs_rows;           // [steps, n, d], row t: the normalised rows (null: not)
    float* action_rows;        // [steps, n, 2], row t (null: not)
    float* logprob_rows;       // [steps, n], row t (null: not; needs noise)
    float* value_rows;         // [steps, n], row t (null: not; needs the critic)
    long long n, steps, stride;
    float eps, clip, half_log_2pi;
};

__global__ void __launch_bounds__(kMaxThreads) general_act_kernel(ActArgs a, Shape S, Plan p) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    float* a0 = s;
    float* a1 = a0 + p.rows * p.stride;
    float* chunk = a1 + p.rows * p.stride;
    float* y = chunk + kStages * p.chunk;
    float* mv = y + round_up(3 * p.rows, 4);
    const int d = S.dims[0];
    const long long row0 = (long long)blockIdx.x * p.rows;
    const long long t = a.t == nullptr ? 0 : *a.t;
    if (t < 0 || t >= a.steps) __trap();  // as index_select and index_copy_
    if (a.mean != nullptr) {
        for (int c = threadIdx.x; c < d; c += blockDim.x) {
            mv[c] = a.mean[c];
            mv[p.stride + c] = a.var[c];
        }
    }
    const bool critic = a.tower[1].w[0] != nullptr;
    for (int tw = 0; tw < (critic ? 2 : 1); ++tw) {
        stage_rows(a0, p.stride, p.rows, d, [&](int r) {
            return row0 + r < a.n ? a.obs + (row0 + r) * a.stride : nullptr;
        });
        __syncthreads();
        float* out = tw == 0 && a.obs_rows != nullptr ? a.obs_rows + t * a.n * d : nullptr;
        if (a.mean != nullptr || out != nullptr) {
            for (int e = threadIdx.x; e < p.rows * d; e += blockDim.x) {
                const int r = e / d, c = e - r * d;
                const long long row = row0 + r;
                if (row < a.n) {
                    float value = a0[r * p.stride + c];
                    if (a.mean != nullptr) {
                        value = normalised(value, mv, mv + p.stride, c, a.eps, a.clip);
                        a0[r * p.stride + c] = value;
                    }
                    if (out != nullptr) out[row * d + c] = value;
                }
            }
            __syncthreads();
        }
        tower_forward(p, S, a.tower[tw].w, a.tower[tw].b, 2 - tw, a0, a1, chunk, y, 2 * tw);
    }
    // split: act towers { return; }
    for (int r = threadIdx.x; r < p.rows; r += blockDim.x) {
        const long long row = row0 + r;
        if (row >= a.n) continue;
        const long long at = t * a.n + row;
        const float mu[2] = {y[3 * r], y[3 * r + 1]};
        if (critic && a.value_rows != nullptr) a.value_rows[at] = y[3 * r + 2];
        float act[2] = {mu[0], mu[1]};
        if (a.noise != nullptr) {
            float lp;
            sample(mu, a.log_std, a.noise + 2 * at, a.half_log_2pi, act, &lp);
            if (a.logprob_rows != nullptr) a.logprob_rows[at] = lp;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            if (a.action != nullptr) a.action[2 * row + j] = act[j];
            if (a.action_rows != nullptr) a.action_rows[2 * at + j] = act[j];
        }
    }
}

// ------------------------------------------------------------------ kernel B

enum MemberKind { kSeat = 0, kPerEnv = 1, kOne = 2 };

// Rows r of a launch at their places in an [envs, cars, ...] array: car off + r %
// seats of env r / seats.
struct RowMap {
    long long seats, cars, off;
    __device__ __forceinline__ long long place(long long r) const {
        return (r / seats) * cars + off + r % seats;
    }
};

struct PoolArgs {
    const float* obs;          // [envs, seats, d] at an env stride of env_stride floats
    Tower tower;               // the members' actor tensors, stacked [P, ...]
    const float* log_std;      // [P, 2] (with noise)
    const float* mean;         // [P, d] (null: no normaliser)
    const float* var;          // [P, d]
    const void* member;        // [envs] or [1], int32 or int64 (seat mode: null)
    const float* noise;        // [rows, 2] (null: greedy)
    const float* uniforms;     // [rows, 2] (null: no random actions)
    const bool* use_policy;    // [envs] or [1] (with uniforms)
    const float* first;        // [envs, 2]: car 0's action (null: not written)
    float* out;                // [envs, cars, 2] at the rows' places
    RowMap map;                // the rows' places in out
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

// policy.cu's pack_rows: of rows r0 + i (i < kPoolRange, r < rows), those whose
// member is p and whose use_policy holds, their offsets i into list and their
// observations' offsets into bases, in row order (a ballot a warp, the warps' counts
// added in warp order); returns how many. On the way each of member p's rows whose
// use_policy is False gets its uniform action, and, where the learner's action is
// given, the grid's first member's block writes car 0 of each env in its range.
__device__ __forceinline__ int pack_rows(const PoolArgs& a, int p, long long r0, int* list,
                                         long long* bases, int* counts) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int total = 0;
    for (int base = 0; base < kPoolRange; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const long long r = r0 + i;
        bool take = false;
        long long obs_at = 0;
        if (i < kPoolRange && r < a.rows) {
            const long long env = r / a.map.seats, seat = r - env * a.map.seats;
            const long long place = env * a.map.cars + a.map.off + seat;
            const bool use = a.uniforms == nullptr || a.use_policy[a.use_per_env ? env : 0];
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
        for (int v = 0; v < (int)(blockDim.x >> 5); ++v) {
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

__global__ void __launch_bounds__(kMaxThreads) general_pool_kernel(PoolArgs a, Shape S, Plan p) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    float* a0 = s;
    float* a1 = a0 + p.rows * p.stride;
    float* chunk = a1 + p.rows * p.stride;
    float* y = chunk + kStages * p.chunk;
    float* mv = y + round_up(3 * p.rows, 4);
    long long* bases = reinterpret_cast<long long*>(mv + 2 * p.stride);
    int* list = reinterpret_cast<int*>(bases + kPoolRange);
    int* counts = list + kPoolRange;
    const int m = a.kind == kOne ? member_at(a, 0) : (int)blockIdx.y;
    const long long r0 = (long long)blockIdx.x * kPoolRange;
    const int count = pack_rows(a, m, r0, list, bases, counts);
    if (count == 0) return;
    // the member's layers in the stacked tensors
    Tower tw;
    for (int l = 0; l <= S.hidden; ++l) {
        const long long out = l < S.hidden ? S.dims[l + 1] : 2;
        tw.w[l] = a.tower.w[l] + m * (long long)S.dims[l] * out;
        tw.b[l] = a.tower.b[l] + m * out;
    }
    if (a.mean != nullptr) {
        for (int c = threadIdx.x; c < a.d; c += blockDim.x) {
            mv[c] = a.mean[(long long)m * a.d + c];
            mv[p.stride + c] = a.var[(long long)m * a.d + c];
        }
    }
    for (int f0 = 0; f0 < count; f0 += p.rows) {
        const int wave = min(count - f0, p.rows);
        stage_rows(a0, p.stride, p.rows, a.d,
                   [&](int r) { return r < wave ? a.obs + bases[f0 + r] : nullptr; });
        __syncthreads();
        if (a.mean != nullptr) {
            for (int e = threadIdx.x; e < wave * a.d; e += blockDim.x) {
                const int r = e / a.d, c = e - r * a.d;
                a0[r * p.stride + c] = normalised(a0[r * p.stride + c], mv, mv + p.stride, c,
                                                  a.eps, a.clip);
            }
            __syncthreads();
        }
        tower_forward(p, S, tw.w, tw.b, 2, a0, a1, chunk, y, 0);
        for (int r = threadIdx.x; r < wave; r += blockDim.x) {
            const long long row = r0 + list[f0 + r], place = a.map.place(row);
            float act[2] = {y[3 * r], y[3 * r + 1]};
            if (a.noise != nullptr) {
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    act[k] = clamp_nan(__fadd_rn(act[k], __fmul_rn(expf(a.log_std[2 * m + k]),
                                                                   a.noise[2 * row + k])),
                                       -1.0f, 1.0f);
                }
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) a.out[2 * place + k] = act[k];
        }
        __syncthreads();
    }
}

// ------------------------------------------------------------------ launches

// a tower's 2 (L + 1) pointers from ptrs; all null or none: false where mixed
bool tower_of(const void* const* ptrs, int L, Tower* t, bool* present) {
    int given = 0;
    for (int l = 0; l <= L; ++l) {
        t->w[l] = static_cast<const float*>(ptrs[2 * l]);
        t->b[l] = static_cast<const float*>(ptrs[2 * l + 1]);
        given += (t->w[l] != nullptr) + (t->b[l] != nullptr);
    }
    *present = given > 0;
    return given == 0 || given == 2 * (L + 1);
}

}  // namespace

// The plan of kernel A (kind 1) or kernel B (kind 2) at towers dims (obs_dim, the
// hidden widths) into out[8]: the block's warps, the tile's rows, the activation
// tiles' row stride, the warps on a fragment, the n-tiles a warp, a pass's columns, a
// chunk's floats and the shared bytes. Returns a cudaError_t.
extern "C" int policy_general_plan(int kind, const int* dims, int num_dims, long long* out) {
    Shape s;
    if ((kind != kAct && kind != kPool) || !shape_of(dims, num_dims, &s))
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(kind, s);
    if (p.rows == 0) return (int)cudaErrorInvalidValue;
    const long long v[8] = {p.warps, p.rows, p.stride, p.groups, p.tiles, p.cols, p.chunk,
                            p.shared_bytes};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
}

// Kernel A: ptrs the obs, t, noise, mean, var, log_std, the actor's 2 (L + 1) tensors,
// the critic's (null: none), then action, obs_rows, action_rows, logprob_rows,
// value_rows (float32, the t int64; null where absent); n rows of obs at a row
// stride of stride floats, steps the buffers' rows, dims the towers' (obs_dim,
// hidden widths), consts (eps, clip, 0.5 log 2 pi). Returns a cudaError_t.
extern "C" int policy_general_act_f32(const void* const* ptrs, int num_ptrs, long long n,
                                      long long steps, long long stride, const int* dims,
                                      int num_dims, const float* consts, int num_consts,
                                      int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape S;
    if (!shape_of(dims, num_dims, &S)) return (int)cudaErrorInvalidValue;
    const int L = S.hidden, per = 2 * (L + 1);
    const Plan p = make_plan(kAct, S);
    if (num_ptrs != 6 + 2 * per + 5 || num_consts != 3 || n < 0 || steps < 1
            || stride < S.dims[0] || p.rows == 0 || (n + p.rows - 1) / p.rows > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    ActArgs a;
    a.obs = static_cast<const float*>(ptrs[0]);
    a.t = static_cast<const long long*>(ptrs[1]);
    a.noise = static_cast<const float*>(ptrs[2]);
    a.mean = static_cast<const float*>(ptrs[3]);
    a.var = static_cast<const float*>(ptrs[4]);
    a.log_std = static_cast<const float*>(ptrs[5]);
    bool actor, critic;
    if (!tower_of(ptrs + 6, L, &a.tower[0], &actor)
            || !tower_of(ptrs + 6 + per, L, &a.tower[1], &critic))
        return (int)cudaErrorInvalidValue;
    float* out[5];
    for (int i = 0; i < 5; ++i)
        out[i] = static_cast<float*>(const_cast<void*>(ptrs[6 + 2 * per + i]));
    a.action = out[0];
    a.obs_rows = out[1];
    a.action_rows = out[2];
    a.logprob_rows = out[3];
    a.value_rows = out[4];
    a.n = n;
    a.steps = steps;
    a.stride = stride;
    a.eps = consts[0];
    a.clip = consts[1];
    a.half_log_2pi = consts[2];
    if (!actor || a.obs == nullptr || (a.mean == nullptr) != (a.var == nullptr)
            || (a.noise != nullptr && a.log_std == nullptr)
            || (a.logprob_rows != nullptr && a.noise == nullptr)
            || (a.value_rows != nullptr && !critic)
            || (a.action == nullptr && a.action_rows == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    err = allow_smem(general_act_kernel, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    general_act_kernel<<<(unsigned)((n + p.rows - 1) / p.rows), 32 * p.warps, p.shared_bytes,
                         (cudaStream_t)stream>>>(a, S, p);
    return (int)cudaGetLastError();
}

// Kernel B: ptrs the obs, the actor's 2 (L + 1) stacked tensors [P, ...], log_std,
// mean, var, member, noise, uniforms, use_policy, first, out (null where absent);
// the rest as policy.cu's pool_act_f32, dims the towers' (obs_dim, hidden widths).
// Returns a cudaError_t.
extern "C" int policy_general_pool_f32(const void* const* ptrs, int num_ptrs, long long rows,
                                       long long seats, long long cars, long long off,
                                       long long env_stride, int members, int kind,
                                       int member64, int use_per_env, const int* dims,
                                       int num_dims, const float* consts, int num_consts,
                                       int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape S;
    if (!shape_of(dims, num_dims, &S)) return (int)cudaErrorInvalidValue;
    const int L = S.hidden, per = 2 * (L + 1);
    const Plan p = make_plan(kPool, S);
    const int d = S.dims[0];
    if (num_ptrs != 1 + per + 9 || num_consts != 6 || rows < 0 || seats < 1 || cars < 1
            || off < 0 || off + seats > cars || env_stride < seats * d
            || members < 1 || members > 65535 || kind < kSeat || kind > kOne || p.rows == 0
            || (rows + kPoolRange - 1) / kPoolRange > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    PoolArgs a;
    a.obs = static_cast<const float*>(ptrs[0]);
    bool actor;
    if (!tower_of(ptrs + 1, L, &a.tower, &actor)) return (int)cudaErrorInvalidValue;
    const void* const* rest = ptrs + 1 + per;
    a.log_std = static_cast<const float*>(rest[0]);
    a.mean = static_cast<const float*>(rest[1]);
    a.var = static_cast<const float*>(rest[2]);
    a.member = rest[3];
    a.noise = static_cast<const float*>(rest[4]);
    a.uniforms = static_cast<const float*>(rest[5]);
    a.use_policy = static_cast<const bool*>(rest[6]);
    a.first = static_cast<const float*>(rest[7]);
    a.out = static_cast<float*>(const_cast<void*>(rest[8]));
    a.map = RowMap{seats, cars, off};
    a.rows = rows;
    a.env_stride = env_stride;
    a.d = d;
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
    if (!actor || a.obs == nullptr || a.out == nullptr || (a.mean == nullptr) != (a.var == nullptr)
            || (a.noise != nullptr && a.log_std == nullptr)
            || (kind == kSeat) != (a.member == nullptr) || (kind == kSeat && members != cars)
            || (a.uniforms != nullptr && a.use_policy == nullptr)
            || (a.first != nullptr && off != 1))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    err = allow_smem(general_pool_kernel, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((rows + kPoolRange - 1) / kPoolRange),
                    kind == kOne ? 1u : (unsigned)members);
    general_pool_kernel<<<grid, 32 * p.warps, p.shared_bytes, (cudaStream_t)stream>>>(a, S, p);
    return (int)cudaGetLastError();
}

extern "C" const char* policy_general_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
