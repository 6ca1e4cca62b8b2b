// The multi-car env's transition, for NVIDIA Hopper (sm_90a): each car's dynamics
// step (K5), its corners and track query (K2), the separating-axis test of every
// pair of the row's cars (K4) with its velocity response, and the reward,
// checkpoint, finish, crash, termination and placement tail, in one launch.
//
// Replaces the JAX package's transition (self_play_racing_tpu/envs/multi.py:
// transition, with ops/dynamics.py: car_update and ops/geometry.py: car_corners,
// progress_and_collision and rectangles_intersect), which XLA fuses on the TPU.
// Bitwise it is what the narrow kernel car_step_and_query (with the pair test) and
// PyTorch around it compute (envs/multi.py:transition_plain): car_step.cuh's step
// and corners, the first-index nearest waypoint of the centre and the four corners
// (progress = idx / n_wp, one IEEE divide; a corner outside when |projection| >
// track_width), rect_sat.cuh's pair test and the ladder, then the tail in the
// source's order, every constant rounded as PyTorch rounds a Python scalar and
// XLA's divisions by constants as products with the float32 reciprocals the caller
// rounds (_numerics.py:div_const). Built with -fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the search, 11 operations a
// query-waypoint pair over the real waypoints (about 330 of 512 on the canonical
// pool: 0.37 GFLOP at 4096 x 2 cars, 5.5 us), against the rows' positions (17 MB
// gathered, 5 us; the pool's 16 rows by id) and ~80 bytes a car of state.
//
// What held the first version (car_step_and_query.cu:multi_transition_small_f32,
// which the env still launches on few rows, where it is faster) back, and what
// this one does about it:
//   - it ran one block an env row and one warp a car, so all 32 lanes of a car's
//     warp stepped the car, formed its corners, tested its pairs and ran its reward
//     on one lane; at 64 registers an SM held 16 such blocks, two waves at 4096 x 2.
//     Here a block serves `rows_per_block` env rows: the step, the pair test and the
//     tail run a thread a car, and only the search runs a warp a car;
//   - the search visited all W padded waypoints: here [0, n_wp), and the padding
//     only where it could win (waypoint_search.cuh), bitwise the full search;
//   - the block waited on its barriers once per env row; here once per block of rows;
//   - the search's per-row scalars (the waypoint count, the width) are read while the
//     rows arrive, not after the search.
// The winners' normals are read from device memory by the four lanes that project,
// after a bulk prefetch of the rows' normals into the L2: staging them too would
// double the stage and halve the blocks an SM holds.
//
// With the autoreset's pointers (autoreset.cuh) the last phase also runs the vector
// step's NEXT_STEP autoreset: the cars of a row whose pending_reset is set are
// written again as the fresh state on the start grid (after the barrier that orders
// them behind the phases that wrote the stepped car) with their info, reward 0 and
// the row's flags False; the row's first car's thread its done, seat 0's episode
// statistics and record, inside a rollout row t of the rollout's buffers, and with a
// pool the PFSP counts. Null pointers: the plain transition, as before.
//
// Split points for scripts/env_kernel_split.py, which builds this source with an
// early return at one of them: "split: staged", "split: searched", "split: paired".
#include <cuda_runtime.h>

#include "autoreset.cuh"
#include "car_step.cuh"
#include "rect_sat.cuh"
#include "row_stage.cuh"
#include "waypoint_search.cuh"

namespace {

constexpr int kQueries = waypoint_search::kQueries;  // the centre and the four corners
constexpr int kMaxThreads = 256;
constexpr int kMaxRowsPerBlock = 32;  // ops/_cuda.py:TRANSITION_MAX_ROWS_PER_BLOCK
// After the staged positions (two fields of field_capacity(W) floats a row), a car's
// words, field-major [k][C] over the block's C cars: its queries' x and y (the
// stepped centre and four corners), the stepped vx and vy, the raw progress, the
// placement score and the reward before the winner bonus, then as ints the wall
// hit, finished and crashed (ops/_cuda.py:TRANSITION_WORDS_PER_CAR); then a row's
// words: its waypoint count and its track width.
constexpr int kQx = 0, kQy = kQx + kQueries, kVx = kQy + kQueries, kVy = kVx + 1,
              kProgress = kVy + 1, kScore = kProgress + 1, kReward = kScore + 1,
              kOutside = kReward + 1, kFinished = kOutside + 1, kCrashed = kFinished + 1,
              kCarWords = kCrashed + 1;
constexpr int kCount = 0, kWidth = 1, kRowWords = 2;

// The multi-car env's state fields the tail reads and writes ([rows * A] each;
// steps, terminated and truncated [rows]; bools as 0/1 bytes).
struct TailIn {
    const float* action;  // [rows * A, 2], clipped here
    const float* progress;
    const float* last_progress;
    const unsigned char* finished;
    const unsigned char* cp25;
    const unsigned char* cp50;
    const unsigned char* cp75;
    const unsigned char* has_crashed;
    const int* finished_step;
    const int* steps;
};

struct TailOut {
    float* progress;  // also the new last_progress
    float* last_steering;
    unsigned char* crashed;
    unsigned char* finished;
    unsigned char* cp25;
    unsigned char* cp50;
    unsigned char* cp75;
    unsigned char* has_crashed;
    int* steps;
    int* finished_step;
    int* placement;
    float* reward;
    unsigned char* terminated;
    unsigned char* truncated;
    float* speed;          // info["speed"]
    float* info_progress;  // info["progress"]: 1 for a finished car
};

// The reward constants, rounded to float32 by the caller; inv_max_speed and
// inv_time_bonus_divisor are the rounded reciprocals of _numerics.div_const.
struct TailSpec {
    float progress_scale, speed_scale, inv_max_speed, checkpoint_bonus, finish_bonus,
        time_bonus_base, inv_time_bonus_divisor, crash_penalty, neg_touch_penalty,
        winner_bonus;
    int max_steps;
};

struct Params {
    const float *x, *y, *angle, *vx, *vy;
    const unsigned char* crashed;
    const float *wp_x, *wp_y, *nrm_x, *nrm_y;
    const int* row_ids;
    const int* n_wp;
    const float* track_width;
    float *nx, *ny, *nang, *nvx, *nvy;
    int rows, cars_per_row, num_waypoints, rows_per_block;
    car_step::Spec k;
    float half_length, half_width, collision_scale;
    TailIn tin;
    TailOut tout;
    TailSpec ts;
    autoreset::Args ar;
};

// torch.clamp on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Python's float constants as PyTorch compares a float32 tensor with them: the
// double rounded to float32
constexpr float kLapHigh = static_cast<float>(0.9);
constexpr float kLapLow = static_cast<float>(0.1);
constexpr float kCp25Lo = static_cast<float>(0.25), kCp25Hi = static_cast<float>(0.35);
constexpr float kCp50Lo = static_cast<float>(0.50), kCp50Hi = static_cast<float>(0.60);
constexpr float kCp75Lo = static_cast<float>(0.75), kCp75Hi = static_cast<float>(0.85);

template <bool kPairs>
__global__ void __launch_bounds__(kMaxThreads) multi_transition_kernel(Params p) {
    extern __shared__ __align__(16) float stage[];
    __shared__ uint64_t bars[kMaxRowsPerBlock];
    const int W = p.num_waypoints;
    const int A = p.cars_per_row;
    const int cap = row_stage::field_capacity(W);
    const int first = blockIdx.x * p.rows_per_block;
    const int E = min(p.rows_per_block, p.rows - first);  // the block's env rows
    const int C = E * A;                                  // and cars
    const size_t row0 = first;
    const size_t car0 = row0 * A;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const float* positions[2] = {p.wp_x, p.wp_y};
    float* cars = stage + p.rows_per_block * 2 * cap;           // [kCarWords][C]
    float* rows = cars + kCarWords * p.rows_per_block * A;      // [E][kRowWords]
    const int CS = p.rows_per_block * A;                        // a car word's stride
    // the work while the rows arrive goes to the block's last threads first, so that
    // warp 0, which issues the copies, takes it last
    const int back = blockDim.x - 1 - threadIdx.x;
    auto word = [&](int k, int c) -> float& { return cars[k * CS + c]; };
    auto flag = [&](int k, int c) -> int& { return reinterpret_cast<int*>(cars)[k * CS + c]; };
    auto flagged = [](float* base, int i) -> int& { return reinterpret_cast<int*>(base)[i]; };

    __shared__ int srcs[kMaxRowsPerBlock];  // the waypoint row each env row stages
    if (threadIdx.x < E) row_stage::init_barrier(&bars[threadIdx.x]);
    __syncthreads();
    if (warp == 0) {
        // lane e reads env row e's waypoint row, for the copies and for later phases
        const int lane_src = lane < E ? (int)row_stage::source_row(p.row_ids, row0 + lane) : 0;
        if (lane < E) srcs[lane] = lane_src;
        for (int e = 0; e < E; ++e) {
            const size_t src = __shfl_sync(0xffffffffu, lane_src, e);
            row_stage::stage_row(stage + e * 2 * cap, positions, 2, src, W, cap, &bars[e]);
            // the normals are read at the winners only: the rows' 16-byte-aligned
            // middles into the L2 ahead of them
            if (lane < 2) {
                const float* row_n = (lane == 0 ? p.nrm_x : p.nrm_y) + src * W;
                const uintptr_t lo = (reinterpret_cast<uintptr_t>(row_n) + 15) & ~uintptr_t(15);
                const uintptr_t hi = reinterpret_cast<uintptr_t>(row_n + W) & ~uintptr_t(15);
                if (hi > lo) {
                    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                                 :: "l"(lo), "r"(static_cast<uint32_t>(hi - lo)) : "memory");
                }
            }
        }
    }
    // while the rows arrive, a thread a row: its count and width; a thread a car: the
    // step and the corners (the queries)
    for (int e = back; e < E; e += blockDim.x) {
        flagged(rows, e * kRowWords + kCount) = p.n_wp[row0 + e];
        rows[e * kRowWords + kWidth] = p.track_width[row0 + e];
    }
    for (int c = back; c < C; c += blockDim.x) {
        const size_t car = car0 + c;
        const float steer = clamp(p.tin.action[2 * car], -1.0f, 1.0f);
        const float thr = clamp((p.tin.action[2 * car + 1] + 1.0f) * 0.5f, 0.0f, 1.0f);
        const car_step::Car s = car_step::step({p.x[car], p.y[car], p.angle[car], p.vx[car],
                                                p.vy[car]}, p.crashed[car], steer, thr, p.k);
        float cx[4], cy[4];
        car_step::corners(s.x, s.y, s.angle, p.half_length, p.half_width, cx, cy);
        p.nx[car] = s.x;
        p.ny[car] = s.y;
        p.nang[car] = s.angle;
        word(kQx, c) = s.x;
        word(kQy, c) = s.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            word(kQx + 1 + i, c) = cx[i];
            word(kQy + 1 + i, c) = cy[i];
        }
        word(kVx, c) = s.vx;
        word(kVy, c) = s.vy;
    }
    for (int e = 0; e < E; ++e) row_stage::wait_barrier(&bars[e]);
    __syncthreads();  // the rows (and their thread-copied parts) and the queries are in
    // split: staged
    // the track query, a warp a car
    for (int c = warp; c < C; c += warps) {
        const int e = c / A;
        const size_t src = srcs[e];
        const float* s_wx = row_stage::staged(stage + e * 2 * cap, p.wp_x, src, W);
        const float* s_wy = row_stage::staged(stage + e * 2 * cap + cap, p.wp_y, src, W);
        const int count = flagged(rows, e * kRowWords + kCount);
        const int m = min(max(count, 0), W);
        float qx[kQueries], qy[kQueries];
#pragma unroll
        for (int t = 0; t < kQueries; ++t) {
            qx[t] = word(kQx + t, c);
            qy[t] = word(kQy + t, c);
        }
        // the padding's box, by every warp whose car is in the row
        const waypoint_search::Box box = waypoint_search::box_of(s_wx, s_wy, m, W, lane);
        int best[kQueries];
        waypoint_search::search(s_wx, s_wy, m, W, box, lane, qx, qy, best);
        // lane t forms query t's projection on its winner's normal
        int i = best[0];
        float px = qx[0], py = qy[0];
#pragma unroll
        for (int t = 1; t < kQueries; ++t) {
            i = lane == t ? best[t] : i;
            px = lane == t ? qx[t] : px;
            py = lane == t ? qy[t] : py;
        }
        bool outside = false;
        if (lane > 0 && lane < kQueries && i < W) {
            // i < W: there is no winner only where every d^2 is NaN or overflows
            const float ddx = px - s_wx[i];
            const float ddy = py - s_wy[i];
            const float proj = ddx * p.nrm_x[src * W + i] + ddy * p.nrm_y[src * W + i];
            outside = fabsf(proj) > rows[e * kRowWords + kWidth];
        }
        outside = __any_sync(0xffffffffu, outside);
        if (lane == 0) {
            word(kProgress, c) = __fdiv_rn((float)best[0], (float)count);  // the raw progress
            flag(kOutside, c) = outside;
        }
    }
    __syncthreads();  // every car's raw progress and wall hit
    // split: searched
    // a thread a car: the pair test and the ladder, then the reward
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int e = c / A;
        const int a = c - e * A;
        const size_t row = row0 + e;
        const size_t car = car0 + c;
        int hits = 0;
        if constexpr (kPairs) {
            auto rect = [&](int b) {
                rect_sat::Rect r;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    r.x[k] = word(kQx + 1 + k, b);
                    r.y[k] = word(kQy + 1 + k, b);
                }
                return r;
            };
            const rect_sat::Rect ra = rect(c);
            for (int b = 0; b < A; ++b) {
                hits += b != a && rect_sat::intersect(ra, rect(e * A + b));
            }
        }
        // the env's ladder: the same factor once per touching partner
        float wx = word(kVx, c);
        float wy = word(kVy, c);
        for (int h = 0; h < hits; ++h) {
            wx = wx * p.collision_scale;
            wy = wy * p.collision_scale;
        }
        p.nvx[car] = wx;
        p.nvy[car] = wy;
        // split: paired
        // car a's reward up to the winner bonus, its new flags and its score
        const TailIn& in = p.tin;
        const TailSpec& ts = p.ts;
        const int steps = in.steps[row] + 1;
        const bool was_crashed = p.crashed[car];
        const float pr = was_crashed ? in.progress[car] : word(kProgress, c);
        const bool now_crashed = was_crashed || flag(kOutside, c) != 0;
        const float lp = in.last_progress[car];
        float delta = pr - lp;
        delta = (lp > kLapHigh && pr < kLapLow) ? (1.0f - lp) + pr : delta;
        delta = (lp < kLapLow && pr > kLapHigh) ? -((1.0f - pr) + lp) : delta;
        float reward = delta * ts.progress_scale;

        const float speed = __fsqrt_rn(wx * wx + wy * wy);
        const float ratio = clamp(speed * ts.inv_max_speed, 0.0f, 1.0f);
        reward = reward + ((!now_crashed && delta > 0.0f) ? ratio * ts.speed_scale : 0.0f);

        const bool hit25 = !in.cp25[car] && pr >= kCp25Lo && pr < kCp25Hi;
        const bool cp25 = in.cp25[car] || hit25;
        const bool hit50 = cp25 && !in.cp50[car] && pr >= kCp50Lo && pr < kCp50Hi;
        const bool cp50 = in.cp50[car] || hit50;
        const bool hit75 = cp50 && !in.cp75[car] && pr >= kCp75Lo && pr < kCp75Hi;
        const bool cp75 = in.cp75[car] || hit75;
        reward = reward + ts.checkpoint_bonus * (float)(hit25 || hit50 || hit75);

        const bool fin_now = cp25 && cp50 && cp75 && lp > kLapHigh && pr < kLapLow &&
                             delta > 0.0f;
        const bool finished = in.finished[car] || fin_now;
        const int finished_step = fin_now ? steps : in.finished_step[car];
        float time_bonus = ts.time_bonus_base - (float)steps * ts.inv_time_bonus_divisor;
        time_bonus = time_bonus < 0.0f ? 0.0f : time_bonus;  // clamp_min: NaN passes
        reward = reward + (fin_now ? ts.finish_bonus + time_bonus : 0.0f);

        const bool crash_now = now_crashed && !in.has_crashed[car];
        reward = reward - (crash_now ? ts.crash_penalty : 0.0f);
        // the touch penalty: -touch * hits with partners, the env's zeros alone
        reward = reward + (kPairs ? (float)hits * ts.neg_touch_penalty : 0.0f);

        const float fs = (float)(finished_step != 0 ? finished_step : 10000);
        const float score = (((float)finished * 10000.0f + pr * 100.0f) +
                             (float)(!now_crashed) * 10.0f) + __fdiv_rn(1.0f, fs);
        word(kScore, c) = score;
        word(kReward, c) = reward;
        flag(kFinished, c) = finished;
        flag(kCrashed, c) = now_crashed;

        const TailOut& out = p.tout;
        out.progress[car] = pr;
        out.last_steering[car] = clamp(in.action[2 * car], -1.0f, 1.0f);
        out.crashed[car] = now_crashed;
        out.finished[car] = finished;
        out.cp25[car] = cp25;
        out.cp50[car] = cp50;
        out.cp75[car] = cp75;
        out.has_crashed[car] = in.has_crashed[car] || crash_now;
        out.finished_step[car] = finished_step;
        out.speed[car] = speed;
        out.info_progress[car] = finished ? 1.0f : pr;
    }
    __syncthreads();  // every car's score and flags
    // a thread a car: the row's termination (the row's first car writes it) and the
    // car's place, 1 + the cars that beat it (a higher score, or an equal score from
    // a higher seat)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int e = c / A;
        const int a = c - e * A;
        const size_t row = row0 + e;
        bool any_finished = false, all_crashed = true;
        for (int b = e * A; b < e * A + A; ++b) {
            any_finished = any_finished || flag(kFinished, b) != 0;
            all_crashed = all_crashed && flag(kCrashed, b) != 0;
        }
        const int steps = p.tin.steps[row] + 1;
        const bool terminated = any_finished || all_crashed;
        const bool truncated = steps >= p.ts.max_steps;
        const bool done = terminated || truncated;
        const bool reset = autoreset::resets(p.ar, row);
        if (a == 0) {
            p.tout.steps[row] = reset ? 0 : steps;
            p.tout.terminated[row] = terminated && !reset;
            p.tout.truncated[row] = truncated && !reset;
        }
        const float sa = word(kScore, c);
        int beaten = 0;
        for (int b = 0; b < A; ++b) {
            const float sb = word(kScore, e * A + b);
            beaten += (sa < sb) || (sa == sb && a < b);
        }
        const int place = 1 + beaten;
        const int placement = done ? place : 0;
        const float reward = word(kReward, c) + ((done && place == 1) ? p.ts.winner_bonus : 0.0f);
        if (reset) {
            autoreset::fresh_car(p.ar, row, car0 + c, p.nx, p.ny, p.nang, p.nvx, p.nvy, p.tout);
        } else {
            p.tout.placement[car0 + c] = placement;
            p.tout.reward[car0 + c] = reward;
        }
        if (a == 0 && p.ar.on) {
            autoreset::row_tail(p.ar, row, p.rows, autoreset::row_in(p.ar, row), reset,
                                reset ? 0.0f : reward, terminated && !reset,
                                truncated && !reset, !reset && placement == 1);
        }
    }
    autoreset::pfsp_finish(p.ar);
}

}  // namespace

// The multi-car env's whole transition: rows env rows of cars_per_row cars, one
// block each, the pair test run when pairs != 0 (the env runs it with more than one
// car). ptrs holds kTransitionPtrs device pointers in this order: the inputs x, y,
// angle, vx, vy, crashed, action ([rows * A, 2]), wp_x, wp_y, nrm_x, nrm_y, row_ids
// (null: row i), n_wp, track_width, progress, last_progress, finished, cp25, cp50,
// cp75, has_crashed, finished_step, steps; then the outputs nx, ny, nang, nvx, nvy,
// progress, last_steering, crashed, finished, cp25, cp50, cp75, has_crashed, steps,
// finished_step, placement, reward, terminated, truncated, speed, info_progress; then
// autoreset.cuh's kPtrs (all null: the plain transition), with `steps` the rollout's
// rows, `pool` the PFSP slots and `pfsp_mode` autoreset.cuh's bits. consts holds
// kTransitionConsts float32 values: K5's eight, the half length and width,
// collision_scale, then TailSpec's ten floats in its order, then the start grid's
// center and spacing (the autoreset's). One block of
// `threads` threads a `rows_per_block` env rows and `smem` bytes of dynamic shared
// memory: the launch plan, ops/_cuda.py:multi_transition_plan. Returns a
// cudaError_t (0 on success).
constexpr int kTransitionPtrs = 44 + autoreset::kPtrs;
constexpr int kTransitionConsts = 23;

extern "C" int multi_transition_f32(void* const* ptrs, int num_ptrs, const float* consts,
                                    int num_consts, int rows, int cars_per_row,
                                    int num_waypoints, int threads, int smem, int pairs,
                                    int max_steps, int rows_per_block, int steps, int pool,
                                    int pfsp_mode, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kTransitionPtrs || num_consts != kTransitionConsts)
        return (int)cudaErrorInvalidValue;
    if (rows == 0 || cars_per_row == 0) return 0;
    if (cars_per_row < 0 || num_waypoints < 1 || threads % 32 != 0 || threads > kMaxThreads
            || rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock)
        return (int)cudaErrorInvalidValue;
    int i = 0;
    auto f = [&]() { return static_cast<const float*>(ptrs[i++]); };
    auto b = [&]() { return static_cast<const unsigned char*>(ptrs[i++]); };
    auto n = [&]() { return static_cast<const int*>(ptrs[i++]); };
    auto fo = [&]() { return static_cast<float*>(ptrs[i++]); };
    auto bo = [&]() { return static_cast<unsigned char*>(ptrs[i++]); };
    auto no = [&]() { return static_cast<int*>(ptrs[i++]); };
    Params p;
    p.x = f();
    p.y = f();
    p.angle = f();
    p.vx = f();
    p.vy = f();
    p.crashed = b();
    p.tin.action = f();
    p.wp_x = f();
    p.wp_y = f();
    p.nrm_x = f();
    p.nrm_y = f();
    p.row_ids = n();
    p.n_wp = n();
    p.track_width = f();
    p.tin.progress = f();
    p.tin.last_progress = f();
    p.tin.finished = b();
    p.tin.cp25 = b();
    p.tin.cp50 = b();
    p.tin.cp75 = b();
    p.tin.has_crashed = b();
    p.tin.finished_step = n();
    p.tin.steps = n();
    p.nx = fo();
    p.ny = fo();
    p.nang = fo();
    p.nvx = fo();
    p.nvy = fo();
    p.tout.progress = fo();
    p.tout.last_steering = fo();
    p.tout.crashed = bo();
    p.tout.finished = bo();
    p.tout.cp25 = bo();
    p.tout.cp50 = bo();
    p.tout.cp75 = bo();
    p.tout.has_crashed = bo();
    p.tout.steps = no();
    p.tout.finished_step = no();
    p.tout.placement = no();
    p.tout.reward = fo();
    p.tout.terminated = bo();
    p.tout.truncated = bo();
    p.tout.speed = fo();
    p.tout.info_progress = fo();
    p.rows = rows;
    p.cars_per_row = cars_per_row;
    p.num_waypoints = num_waypoints;
    p.rows_per_block = rows_per_block;
    p.k = car_step::Spec{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
                         consts[6], consts[7]};
    p.half_length = consts[8];
    p.half_width = consts[9];
    p.collision_scale = consts[10];
    p.ts = TailSpec{consts[11], consts[12], consts[13], consts[14], consts[15], consts[16],
                    consts[17], consts[18], consts[19], consts[20], max_steps};
    if (!autoreset::parse(ptrs + i, steps, pool, pfsp_mode, consts[21], consts[22], p.ar)
            || (p.ar.on && !(p.ar.start_nx && p.ar.start_ny && p.ar.slot)))
        return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
        // the dynamic shared memory and the static (under 1 KB) over the default 48 KB
        cudaError_t e = cudaSuccess;
        if (smem + 1024 > 48 * 1024) {
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        }
        if (e != cudaSuccess) return e;
        const int blocks = (rows + rows_per_block - 1) / rows_per_block;
        kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
        return cudaGetLastError();
    };
    err = pairs ? launch(multi_transition_kernel<true>) : launch(multi_transition_kernel<false>);
    return (int)err;
}

extern "C" const char* multi_transition_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
