// NEXT_STEP autoreset in the envs' transition kernels, for NVIDIA Hopper (sm_90a):
// shared by single_transition.cu and multi_transition.cu and by
// car_step_and_query.cu's multi_transition_small_f32.
//
// Replaces, in the tail of the transition launch, the rest of the JAX package's
// vector step (self_play_racing_tpu/envs/vector.py:57: the reset of the rows that
// ended, the per-row merge, the reset info, the masks and the episode statistics),
// the rollout step's reward, done and episode rows (self_play_racing_tpu/agent/
// ppo.py:373-385) and self-play's PFSP counts (self_play_racing_tpu/agent/
// self_play.py:65), which XLA fuses into the rollout's one program on the TPU and the
// port ran as ~70 PyTorch launches around the transition. Bitwise it is what the port's
// composition computes (envs/vector.py:autoreset, the envs' reset_state and
// info_from_state, agent/ppo.py:rollout_step's rows, envs/multi.py:pfsp_counts):
//   - a row whose pending_reset is set writes the fresh state (the start pose, on the
//     multi-car env's grid x = start_x + start_nx * ((float(slot) - center) *
//     spacing), each product and sum rounded as PyTorch's separate launches round
//     them; zeros; every flag False) and the fresh state's info (speed sqrt(0*0+0*0),
//     progress 0, reward 0), its reward 0 and its flags False;
//   - every row: done = terminated | truncated, the running return + reward (seat 0's
//     on the multi-car env), the length + !reset, the record, the stats zeroed at
//     done and the next pending_reset = done & !reset;
//   - inside a rollout (t given), row t of the [T, N] reward, done_entering,
//     ep_return, ep_length and ep_mask buffers and t + 1;
//   - with a pool (extra given, the multi-car env), each slot's wins and games: a
//     row's thread adds 1 to the slot's int32 count where its episode ended against a
//     policy opponent (and won: placement 1 on seat 0); the launch's last block, found
//     by a ticket, adds each count, converted to float once, into extra in slot order
//     and leaves the counts and the ticket 0 for the next launch. A step's count is
//     at most N, so float(count) is the composition's float32 sum of 0/1 values and
//     the add into extra the same single rounding as its add_.
// Null pointers select the plain transition (Args::on false).
#pragma once

#include <cuda_runtime.h>

namespace autoreset {

// the pointers an entry takes after its own, in this order (null pending: the plain
// transition), ops/_cuda.py:AUTORESET_PTRS
constexpr int kPtrs = 27;

// what the autoreset reads and writes; [N] each unless said, bools as 0/1 bytes
struct Args {
    const unsigned char* pending;  // the rows that reset this step
    const float* ep_return;        // the running return
    const int* ep_length;          // and length
    const float *start_x, *start_y, *start_angle;  // the track's start pose
    const float *start_nx, *start_ny;              // its start normal (multi-car)
    const long long* slot;         // [N, A] each car's grid slot (multi-car)
    unsigned char* done;
    unsigned char* pending_out;
    float* record_return;
    int* record_length;
    float* stats_return;
    int* stats_length;
    const long long* t;            // [1] the rollout's row (null: no rows written)
    long long* t_next;             // [1] t + 1
    const unsigned char* entering;  // the done flags entering the step
    float* reward_rows;            // [T, N] each
    unsigned char* done_entering_rows;
    float* ep_return_rows;
    int* ep_length_rows;
    unsigned char* ep_mask_rows;
    const void* idx;               // the opponent slot: int32 or int64, [N] or one
    const unsigned char* use_policy;  // [N] or one
    float* extra;                  // [2P]: wins, then games (null: no pool)
    int* counts;                   // [2P + 1]: the launch's counts, then its ticket
    long long steps;               // T
    int pool;                      // P
    bool idx_per_env, idx_wide, use_per_env;
    float grid_center, grid_spacing;
    bool on;                       // the autoreset mode
};

// pfsp_mode's bits (ops/_cuda.py:PFSP_*)
constexpr int kIdxPerEnv = 1, kIdxWide = 2, kUsePerEnv = 4;

// Args from the entry's pointers (kPtrs of them at ptrs) and integers; false where
// they are not what the kernels take (a mode half given).
inline bool parse(void* const* ptrs, long long steps, int pool, int pfsp_mode, float center,
                  float spacing, Args& a) {
    int i = 0;
    auto f = [&]() { return static_cast<const float*>(ptrs[i++]); };
    auto b = [&]() { return static_cast<const unsigned char*>(ptrs[i++]); };
    auto n = [&]() { return static_cast<const int*>(ptrs[i++]); };
    a.pending = b();
    a.ep_return = f();
    a.ep_length = n();
    a.start_x = f();
    a.start_y = f();
    a.start_angle = f();
    a.start_nx = f();
    a.start_ny = f();
    a.slot = static_cast<const long long*>(ptrs[i++]);
    a.done = static_cast<unsigned char*>(ptrs[i++]);
    a.pending_out = static_cast<unsigned char*>(ptrs[i++]);
    a.record_return = static_cast<float*>(ptrs[i++]);
    a.record_length = static_cast<int*>(ptrs[i++]);
    a.stats_return = static_cast<float*>(ptrs[i++]);
    a.stats_length = static_cast<int*>(ptrs[i++]);
    a.t = static_cast<const long long*>(ptrs[i++]);
    a.t_next = static_cast<long long*>(ptrs[i++]);
    a.entering = b();
    a.reward_rows = static_cast<float*>(ptrs[i++]);
    a.done_entering_rows = static_cast<unsigned char*>(ptrs[i++]);
    a.ep_return_rows = static_cast<float*>(ptrs[i++]);
    a.ep_length_rows = static_cast<int*>(ptrs[i++]);
    a.ep_mask_rows = static_cast<unsigned char*>(ptrs[i++]);
    a.idx = ptrs[i++];
    a.use_policy = b();
    a.extra = static_cast<float*>(ptrs[i++]);
    a.counts = static_cast<int*>(ptrs[i++]);
    a.steps = steps;
    a.pool = pool;
    a.idx_per_env = (pfsp_mode & kIdxPerEnv) != 0;
    a.idx_wide = (pfsp_mode & kIdxWide) != 0;
    a.use_per_env = (pfsp_mode & kUsePerEnv) != 0;
    a.grid_center = center;
    a.grid_spacing = spacing;
    a.on = a.pending != nullptr;
    if (!a.on) {
        // the plain transition takes none of them
        for (int k = 0; k < kPtrs; ++k) {
            if (ptrs[k]) return false;
        }
        return true;
    }
    const bool state = a.ep_return && a.ep_length && a.start_x && a.start_y && a.start_angle &&
                       a.done && a.pending_out && a.record_return && a.record_length &&
                       a.stats_return && a.stats_length;
    const bool rows = a.t && a.t_next && a.entering && a.reward_rows && a.done_entering_rows &&
                      a.ep_return_rows && a.ep_length_rows && a.ep_mask_rows && steps >= 1;
    const bool no_rows = !(a.t || a.t_next || a.entering || a.reward_rows ||
                           a.done_entering_rows || a.ep_return_rows || a.ep_length_rows ||
                           a.ep_mask_rows);
    const bool pfsp = a.idx && a.use_policy && a.extra && a.counts && pool >= 1;
    const bool no_pfsp = !(a.idx || a.use_policy || a.extra || a.counts);
    return state && (rows || no_rows) && (pfsp || no_pfsp);
}

__device__ __forceinline__ bool resets(const Args& a, size_t row) {
    return a.on && a.pending[row] != 0;
}

// car `car`'s place on the start grid of row `row` (the multi-car env's reset_state:
// offset = (float(slot) - center) * spacing, then start + normal * offset, each a
// launch of its own there)
__device__ __forceinline__ void grid_pose(const Args& a, size_t row, size_t car, float& x,
                                          float& y) {
    const float offset = __fmul_rn(__fsub_rn((float)a.slot[car], a.grid_center),
                                   a.grid_spacing);
    x = __fadd_rn(a.start_x[row], __fmul_rn(a.start_nx[row], offset));
    y = __fadd_rn(a.start_y[row], __fmul_rn(a.start_ny[row], offset));
}

// The multi-car env's fresh car `car` of row `row` (multi.py:reset_state and
// info_from_state), over what the transition wrote there: the grid pose, zeros,
// every flag False, finished_step and placement 0, and the info's speed, progress and
// reward 0. `out` is the kernel's TailOut.
template <class Out>
__device__ __forceinline__ void fresh_car(const Args& a, size_t row, size_t car, float* nx,
                                          float* ny, float* nang, float* nvx, float* nvy,
                                          const Out& out) {
    float x, y;
    grid_pose(a, row, car, x, y);
    nx[car] = x;
    ny[car] = y;
    nang[car] = a.start_angle[row];
    nvx[car] = 0.0f;
    nvy[car] = 0.0f;
    out.progress[car] = 0.0f;
    out.last_steering[car] = 0.0f;
    out.crashed[car] = 0;
    out.finished[car] = 0;
    out.cp25[car] = 0;
    out.cp50[car] = 0;
    out.cp75[car] = 0;
    out.has_crashed[car] = 0;
    out.finished_step[car] = 0;
    out.placement[car] = 0;
    out.reward[car] = 0.0f;
    out.speed[car] = 0.0f;
    out.info_progress[car] = 0.0f;
}

// What a row's part reads of the running episode, loaded where the kernel reads its
// other inputs
struct RowIn {
    float ep_return;
    int ep_length;
    bool entering;
};

__device__ __forceinline__ RowIn row_in(const Args& a, size_t row) {
    if (!a.on) return RowIn{0.0f, 0, false};
    return RowIn{a.ep_return[row], a.ep_length[row], a.t ? a.entering[row] != 0 : false};
}

// The row's part, by one thread a row: `reward` the row's (seat 0's) reward after the
// reset's 0, `terminated` and `truncated` its flags after the reset's mask, `won` its
// placement 1 on seat 0; N the launch's rows. Returns done.
__device__ __forceinline__ bool row_tail(const Args& a, size_t row, size_t N, const RowIn& in,
                                         bool reset, float reward, bool terminated,
                                         bool truncated, bool won) {
    const bool done = terminated || truncated;
    const float ret = in.ep_return + reward;
    const int len = in.ep_length + (reset ? 0 : 1);
    a.done[row] = done;
    a.pending_out[row] = done && !reset;
    a.record_return[row] = ret;
    a.record_length[row] = len;
    a.stats_return[row] = done ? 0.0f : ret;
    a.stats_length[row] = done ? 0 : len;
    if (a.t) {
        const long long t = *a.t;
        if (t < 0 || t >= a.steps) __trap();  // as index_copy_
        const size_t at = (size_t)t * N + row;
        a.reward_rows[at] = reward;
        a.done_entering_rows[at] = in.entering;
        a.ep_return_rows[at] = done ? ret : 0.0f;
        a.ep_length_rows[at] = done ? len : 0;
        a.ep_mask_rows[at] = done;
        if (row == 0) *a.t_next = t + 1;
    }
    if (a.extra) {
        const bool use = a.use_policy[a.use_per_env ? row : 0] != 0;
        const size_t k = a.idx_per_env ? row : 0;
        const long long s = a.idx_wide ? static_cast<const long long*>(a.idx)[k]
                                       : (long long)static_cast<const int*>(a.idx)[k];
        if (done && use && s >= 0 && s < a.pool) {
            atomicAdd(&a.counts[a.pool + s], 1);
            if (won) atomicAdd(&a.counts[s], 1);
        }
    }
    return done;
}

// By every thread of every block, last in the kernel: the launch's last block adds
// the counts into extra, in slot order, and zeroes them and the ticket.
__device__ __forceinline__ void pfsp_finish(const Args& a) {
    if (!a.on || !a.extra) return;
    __shared__ int last;
    __threadfence();  // this thread's counts before the block's ticket
    __syncthreads();
    if (threadIdx.x == 0) {
        last = atomicAdd(&a.counts[2 * a.pool], 1) == (int)(gridDim.x - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int s = threadIdx.x; s < 2 * a.pool; s += blockDim.x) {
        a.extra[s] = a.extra[s] + (float)atomicExch(&a.counts[s], 0);
    }
    if (threadIdx.x == 0) a.counts[2 * a.pool] = 0;
}

}  // namespace autoreset
