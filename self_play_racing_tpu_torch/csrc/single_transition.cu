// The single-car env's transition, for NVIDIA Hopper (sm_90a): each car's dynamics
// step (K5), its corners and track query (K2), and the reward, checkpoint, speed,
// crash, finish and termination tail, in one launch.
//
// Replaces the JAX package's transition (self_play_racing_tpu/envs/single.py:
// transition, with ops/dynamics.py: car_update and ops/geometry.py: car_corners and
// progress_and_collision), which XLA fuses on the TPU. Bitwise it is what the narrow
// kernel car_step_and_query and PyTorch around it compute (envs/single.py:
// transition_plain): the actions clipped raw (steering to [-1, 1], throttle to
// [0, 1]), car_step.cuh's step and corners, the first-index nearest waypoint of the
// centre and the four corners (progress = idx / n_wp, one IEEE divide; a corner
// outside when |projection| > track_width), then the tail in the source's order:
// the crashed car's progress frozen, the lap wraps, delta * progress_scale, the
// chained checkpoints' bonus, speed * (1 / max_speed) clamped times the speed
// weight while progressing, the crash penalty on every crashed step, the finish
// bonus and the time bonus as two adds. Every constant is rounded as PyTorch rounds
// a Python scalar against a float32 tensor, and XLA's divisions by constants are
// products with the float32 reciprocals the caller rounds (_numerics.py:div_const).
// The speed weight is read from the card where the caller gives a tensor (the
// trainer's anneal writes it between the replays of a captured rollout), else it
// is the config's constant. Built with -fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the search, 11 operations a
// query-waypoint pair over the rows' real waypoints (about 330 of 512 on the
// canonical pool: 74 MFLOP at 4096 cars, 1.1 us), against the rows' positions (17
// MB gathered, 5 us; the pool's 16 rows by id, 0.07 MB) and ~70 bytes a car of
// state and outputs (chip_smoke.py: single_step_bound).
//
// With the autoreset's pointers (autoreset.cuh) the tail also runs the vector step's
// NEXT_STEP autoreset: a row whose pending_reset is set writes the fresh state (the
// track's start pose and zeros) and its info, reward 0 and its flags False; every
// row its done, episode statistics and record, and inside a rollout its row t of
// the rollout's buffers. Null pointers: the plain transition, as before.
//
// Two kernels, the same step, search and tail (so the same bits):
//   - single_transition_kernel, a block (one warp) a row, the one the env launches on
//     per-env rows and on few rows: every lane steps the car (the same values on each)
//     while the row arrives, the warp searches, lane 0 runs the tail;
//   - single_transition_rows_kernel, for the tiled layout only (env i reads pool row
//     i % T for the row period T > 0): `rows_per_block` env rows a block, T apart, which
//     read one pool row. Warp 0 stages that row once with bulk copies; while it
//     arrives, one warp steps the block's cars, a thread a car, and puts their queries
//     and what their tails read in shared memory; then the block's warps run the
//     track query a warp a car on the one staged row; then the stepping thread runs
//     its car's tail. A car's step and tail take a thread's issue slots, not a warp's.
//     On an H100 it was 1.1-4.3 us faster than a warp a row at 2048-8192 tiled rows
//     (PERF.md), so the env launches it on the tiled layout from
//     ops/_cuda.py:SINGLE_TRANSITION_ROWS_FROM rows.
// The search is waypoint_search.cuh's over [0, n_wp), and the padding only where its
// box could win.
//
// Split points for scripts/env_kernel_split.py, which builds this source with an
// early return at one of them: "split: rows staged", "split: rows stepped",
// "split: rows searched" (single_transition_rows_kernel) and "split: staged", "split:
// stepped", "split: searched" (single_transition_kernel).
#include <cuda_runtime.h>

#include "autoreset.cuh"
#include "car_step.cuh"
#include "row_stage.cuh"
#include "waypoint_search.cuh"

namespace {

constexpr int kQueries = waypoint_search::kQueries;  // the centre and the four corners
constexpr int kMaxThreads = 256;
constexpr int kMaxRowsPerBlock = 32;  // ops/_cuda.py:SINGLE_TRANSITION_MAX_ROWS_PER_BLOCK
// After a block's staged row, its cars' words, field-major [k][P] over the block's
// P rows (ops/_cuda.py:SINGLE_TRANSITION_WORDS_PER_CAR): the queries' x and y; as ints
// the winner of the centre and the wall hit; what the tail reads, put there by the
// stepping thread while the row arrives: the stepped car, the clipped steering, the
// old progress, last progress and speed weight, as ints the steps, the row's
// waypoint count and the flags (crashed, finished, cp25, cp50, cp75 and the
// autoreset's pending_reset as bits 0-5); then the autoreset's inputs: the start
// pose, the running return, as ints the running length and the entering done flag.
constexpr int kQx = 0, kQy = kQx + kQueries, kBest = kQy + kQueries, kOutside = kBest + 1,
              kCarX = kOutside + 1, kCarY = kCarX + 1, kCarAngle = kCarY + 1,
              kCarVx = kCarAngle + 1, kCarVy = kCarVx + 1, kSteer = kCarVy + 1,
              kProgress = kSteer + 1, kLastProgress = kProgress + 1,
              kSpeedWeight = kLastProgress + 1, kSteps = kSpeedWeight + 1, kCount = kSteps + 1,
              kFlags = kCount + 1, kStartX = kFlags + 1, kStartY = kStartX + 1,
              kStartAngle = kStartY + 1, kEpReturn = kStartAngle + 1, kEpLength = kEpReturn + 1,
              kEntering = kEpLength + 1, kCarWords = kEntering + 1;

// The reward constants, rounded to float32 by the caller; inv_max_speed and
// inv_time_bonus_divisor are the rounded reciprocals of _numerics.div_const, and
// speed_weight the config's, used where no speed-weight tensor is given.
struct TailSpec {
    float progress_scale, checkpoint_bonus, inv_max_speed, speed_weight, crash_penalty,
        finish_bonus, time_bonus_base, inv_time_bonus_divisor;
    int max_steps;
};

// The single-car env's state fields ([rows] each; bools as 0/1 bytes), the action
// [rows, action_stride] (columns 0 and 1 read) and the speed weight (one float, or
// null).
struct Params {
    const float *x, *y, *angle, *vx, *vy;
    const unsigned char* crashed;
    const float* action;
    const float *wp_x, *wp_y, *nrm_x, *nrm_y;
    const int* row_ids;
    const int* n_wp;
    const float* track_width;
    const float *progress, *last_progress;
    const unsigned char *finished, *cp25, *cp50, *cp75;
    const int* steps;
    const float* speed_weight;
    float *nx, *ny, *nang, *nvx, *nvy, *progress_out, *last_steering;
    unsigned char *crashed_out, *finished_out, *cp25_out, *cp50_out, *cp75_out;
    int* steps_out;
    float* reward;
    unsigned char *terminated, *truncated;
    float *speed, *info_progress, *delta;
    int rows, num_waypoints, action_stride, rows_per_block, row_period;
    car_step::Spec k;
    float half_length, half_width;
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

// The normals are read at the winners only: lanes 0 and 1 bring row `src`'s
// 16-byte-aligned middles into the L2 ahead of them.
__device__ __forceinline__ void prefetch_normals(const Params& p, size_t src, int lane) {
    const int W = p.num_waypoints;
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

// Car i's clipped action and step, and its queries: the stepped centre and corners.
struct Stepped {
    car_step::Car s;
    float steer;
    bool was_crashed;
};

__device__ __forceinline__ Stepped step_car(const Params& p, size_t i, float (&qx)[kQueries],
                                            float (&qy)[kQueries]) {
    const float* a = p.action + i * (size_t)p.action_stride;
    const float steer = clamp(a[0], -1.0f, 1.0f);
    const float thr = clamp(a[1], 0.0f, 1.0f);
    const bool was_crashed = p.crashed[i];
    const car_step::Car s = car_step::step({p.x[i], p.y[i], p.angle[i], p.vx[i], p.vy[i]},
                                           was_crashed, steer, thr, p.k);
    float cx[4], cy[4];
    car_step::corners(s.x, s.y, s.angle, p.half_length, p.half_width, cx, cy);
    qx[0] = s.x;
    qy[0] = s.y;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        qx[1 + t] = cx[t];
        qy[1 + t] = cy[t];
    }
    return Stepped{s, steer, was_crashed};
}

// By a warp: the queries' winners over the row staged at `stage` (waypoint row
// `src`, `count` real waypoints), and whether a corner lies outside the track (lane
// t projects query t on its winner's normal). Returns the centre's winner, on every
// lane.
__device__ __forceinline__ int query_row(const Params& p, const float* stage, int cap,
                                         size_t src, int count, float width, int lane,
                                         const float (&qx)[kQueries],
                                         const float (&qy)[kQueries], bool& outside) {
    const int W = p.num_waypoints;
    const float* s_wx = row_stage::staged(stage, p.wp_x, src, W);
    const float* s_wy = row_stage::staged(stage + cap, p.wp_y, src, W);
    const int m = min(max(count, 0), W);
    const waypoint_search::Box box = waypoint_search::box_of(s_wx, s_wy, m, W, lane);
    int best[kQueries];
    waypoint_search::search(s_wx, s_wy, m, W, box, lane, qx, qy, best);
    int w = best[0];
    float px = qx[0], py = qy[0];
#pragma unroll
    for (int t = 1; t < kQueries; ++t) {
        w = lane == t ? best[t] : w;
        px = lane == t ? qx[t] : px;
        py = lane == t ? qy[t] : py;
    }
    bool out = false;
    if (lane > 0 && lane < kQueries && w < W) {
        // w < W: there is no winner only where every d^2 is NaN or overflows
        const float ddx = px - s_wx[w];
        const float ddy = py - s_wy[w];
        const float proj = ddx * p.nrm_x[src * W + w] + ddy * p.nrm_y[src * W + w];
        out = fabsf(proj) > width;
    }
    outside = __any_sync(0xffffffffu, out);
    return best[0];
}

// Car i's state that the tail reads beside its step, and the autoreset's: whether
// the row resets, the start pose and the running episode.
struct TailIn {
    float progress, last_progress, speed_weight;
    int steps;
    bool finished, cp25, cp50, cp75;
    bool reset;
    float start_x, start_y, start_angle;
    autoreset::RowIn row;
};

__device__ __forceinline__ TailIn tail_in(const Params& p, size_t i) {
    const bool on = p.ar.on;
    return TailIn{p.progress[i], p.last_progress[i],
                  p.speed_weight ? *p.speed_weight : p.ts.speed_weight, p.steps[i],
                  p.finished[i] != 0, p.cp25[i] != 0, p.cp50[i] != 0, p.cp75[i] != 0,
                  autoreset::resets(p.ar, i), on ? p.ar.start_x[i] : 0.0f,
                  on ? p.ar.start_y[i] : 0.0f, on ? p.ar.start_angle[i] : 0.0f,
                  autoreset::row_in(p.ar, i)};
}

// One thread: car i's tail from its step and state, its centre's winner best0 over
// `count` waypoints and its wall hit, and every output.
__device__ __forceinline__ void tail(const Params& p, size_t i, const Stepped& st,
                                     const TailIn& in, int best0, int count, bool outside) {
    const TailSpec& ts = p.ts;
    const car_step::Car& s = st.s;
    const bool was_crashed = st.was_crashed;
    const int steps = in.steps + 1;
    const float pr = was_crashed ? in.progress : __fdiv_rn((float)best0, (float)count);
    const bool crashed = was_crashed || outside;
    const float lp = in.last_progress;
    float delta = pr - lp;
    delta = (lp > kLapHigh && pr < kLapLow) ? (1.0f - lp) + pr : delta;
    delta = (lp < kLapLow && pr > kLapHigh) ? -((1.0f - pr) + lp) : delta;
    float reward = delta * ts.progress_scale;

    const bool hit25 = !in.cp25 && pr >= kCp25Lo && pr < kCp25Hi;
    const bool cp25 = in.cp25 || hit25;
    const bool hit50 = cp25 && !in.cp50 && pr >= kCp50Lo && pr < kCp50Hi;
    const bool cp50 = in.cp50 || hit50;
    const bool hit75 = cp50 && !in.cp75 && pr >= kCp75Lo && pr < kCp75Hi;
    const bool cp75 = in.cp75 || hit75;
    reward = reward + ts.checkpoint_bonus * (float)(hit25 || hit50 || hit75);

    const float speed = __fsqrt_rn(s.vx * s.vx + s.vy * s.vy);
    const float ratio = clamp(speed * ts.inv_max_speed, 0.0f, 1.0f);
    reward = (!crashed && delta > 0.0f) ? reward + ratio * in.speed_weight : reward;
    reward = crashed ? reward - ts.crash_penalty : reward;

    const bool fin_now = cp25 && cp50 && cp75 && lp > kLapHigh && pr < kLapLow &&
                         delta > 0.0f;
    const bool finished = in.finished || fin_now;
    float time_bonus = ts.time_bonus_base - (float)steps * ts.inv_time_bonus_divisor;
    time_bonus = time_bonus < 0.0f ? 0.0f : time_bonus;  // clamp_min: NaN passes
    reward = fin_now ? reward + ts.finish_bonus : reward;
    reward = fin_now ? reward + time_bonus : reward;

    if (in.reset) {
        // the autoreset: the fresh state (single.py:reset_state), its info
        // (info_from_state: speed sqrt(0 * 0 + 0 * 0), progress 0, reward and delta
        // 0), reward 0 and the flags False
        p.nx[i] = in.start_x;
        p.ny[i] = in.start_y;
        p.nang[i] = in.start_angle;
        p.nvx[i] = 0.0f;
        p.nvy[i] = 0.0f;
        p.last_steering[i] = 0.0f;
        p.progress_out[i] = 0.0f;
        p.crashed_out[i] = 0;
        p.finished_out[i] = 0;
        p.cp25_out[i] = 0;
        p.cp50_out[i] = 0;
        p.cp75_out[i] = 0;
        p.steps_out[i] = 0;
        p.reward[i] = 0.0f;
        p.terminated[i] = 0;
        p.truncated[i] = 0;
        p.speed[i] = 0.0f;
        p.info_progress[i] = 0.0f;
        p.delta[i] = 0.0f;
        autoreset::row_tail(p.ar, i, p.rows, in.row, true, 0.0f, false, false, false);
        return;
    }
    p.nx[i] = s.x;
    p.ny[i] = s.y;
    p.nang[i] = s.angle;
    p.nvx[i] = s.vx;
    p.nvy[i] = s.vy;
    p.last_steering[i] = st.steer;
    p.progress_out[i] = pr;
    p.crashed_out[i] = crashed;
    p.finished_out[i] = finished;
    p.cp25_out[i] = cp25;
    p.cp50_out[i] = cp50;
    p.cp75_out[i] = cp75;
    p.steps_out[i] = steps;
    p.reward[i] = reward;
    p.terminated[i] = crashed || finished;
    p.truncated[i] = steps >= ts.max_steps;
    p.speed[i] = speed;
    p.info_progress[i] = finished ? 1.0f : pr;
    p.delta[i] = delta;
    if (p.ar.on) {
        autoreset::row_tail(p.ar, i, p.rows, in.row, false, reward, crashed || finished,
                            steps >= ts.max_steps, false);
    }
}

// The env rows block b serves, P = rows_per_block (at most 32) of them, one car each:
// rows r + (c*P + q)*T with r = b % T and c = b / T for the row period T > 0 (on the
// tiled layout env i reads pool row i % T), which read one pool row there.
struct BlockRows {
    size_t first, stride;
    int count;
    __device__ BlockRows(const Params& p) {
        const int P = p.rows_per_block, T = p.row_period, b = blockIdx.x;
        first = (size_t)(b % T) + (size_t)(b / T) * P * T;
        stride = T;
        count = min(P, (p.rows - b % T + T - 1) / T - (b / T) * P);
    }
    __device__ size_t operator()(int q) const { return first + q * stride; }
};

__global__ void __launch_bounds__(kMaxThreads) single_transition_rows_kernel(Params p) {
    extern __shared__ __align__(16) float smem[];  // the row's x and y, then the cars' words
    __shared__ uint64_t bar;                       // the row's copies
    const int W = p.num_waypoints;
    const int cap = row_stage::field_capacity(W);
    const int P = p.rows_per_block;
    const BlockRows env(p);
    const int E = env.count;  // the block's rows
    if (E <= 0) return;       // the whole block: a residue with fewer rows
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    float* words = smem + 2 * cap;  // [kCarWords][P]
    int* iwords = reinterpret_cast<int*>(words);
    const float* positions[2] = {p.wp_x, p.wp_y};
    const size_t src = row_stage::source_row(p.row_ids, env(0));  // every car's waypoint row
    if (threadIdx.x == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    if (warp == 0) {
        // one staged row for rows that must share it: other ids are a caller's error
        const bool same = lane >= E || row_stage::source_row(p.row_ids, env(lane)) == src;
        if (!__all_sync(0xffffffffu, same)) __trap();
        row_stage::stage_row(smem, positions, 2, src, W, cap, &bar);
        prefetch_normals(p, src, lane);
    }
    // split: rows staged
    // while the row arrives, the last warp, a thread a car: the clipped action, the
    // step and the queries
    const int stepper = warps - 1;
    auto word = [&](int k, int c) -> float& { return words[k * P + c]; };
    auto iword = [&](int k, int c) -> int& { return iwords[k * P + c]; };
    if (warp == stepper && lane < E) {
        const size_t i = env(lane);
        float qx[kQueries], qy[kQueries];
        const Stepped st = step_car(p, i, qx, qy);
        const TailIn in = tail_in(p, i);
#pragma unroll
        for (int t = 0; t < kQueries; ++t) {
            word(kQx + t, lane) = qx[t];
            word(kQy + t, lane) = qy[t];
        }
        word(kCarX, lane) = st.s.x;
        word(kCarY, lane) = st.s.y;
        word(kCarAngle, lane) = st.s.angle;
        word(kCarVx, lane) = st.s.vx;
        word(kCarVy, lane) = st.s.vy;
        word(kSteer, lane) = st.steer;
        word(kProgress, lane) = in.progress;
        word(kLastProgress, lane) = in.last_progress;
        word(kSpeedWeight, lane) = in.speed_weight;
        iword(kSteps, lane) = in.steps;
        iword(kCount, lane) = p.n_wp[i];
        iword(kFlags, lane) = st.was_crashed | in.finished << 1 | in.cp25 << 2 | in.cp50 << 3
                              | in.cp75 << 4 | in.reset << 5;
        word(kStartX, lane) = in.start_x;
        word(kStartY, lane) = in.start_y;
        word(kStartAngle, lane) = in.start_angle;
        word(kEpReturn, lane) = in.row.ep_return;
        iword(kEpLength, lane) = in.row.ep_length;
        iword(kEntering, lane) = in.row.entering;
    }
    __syncthreads();  // every car's queries, and the row's lane-copied head and tail
    // split: rows stepped
    // the track query, a warp a car, once the row's bulk part is in
    row_stage::wait_barrier(&bar);
    for (int c = warp; c < E; c += warps) {
        const size_t i = env(c);
        const int count = iword(kCount, c);
        const float width = p.track_width[i];
        float qx[kQueries], qy[kQueries];
#pragma unroll
        for (int t = 0; t < kQueries; ++t) {
            qx[t] = words[(kQx + t) * P + c];
            qy[t] = words[(kQy + t) * P + c];
        }
        bool outside;
        const int best0 = query_row(p, smem, cap, src, count, width, lane, qx, qy, outside);
        if (lane == 0) {
            iword(kBest, c) = best0;
            iword(kOutside, c) = outside;
        }
    }
    __syncthreads();  // every car's winner and wall hit
    // split: rows searched
    if (warp == stepper && lane < E) {
        const int flags = iword(kFlags, lane);
        const Stepped st{{word(kCarX, lane), word(kCarY, lane), word(kCarAngle, lane),
                          word(kCarVx, lane), word(kCarVy, lane)},
                         word(kSteer, lane), (flags & 1) != 0};
        const TailIn in{word(kProgress, lane), word(kLastProgress, lane),
                        word(kSpeedWeight, lane), iword(kSteps, lane), (flags & 2) != 0,
                        (flags & 4) != 0, (flags & 8) != 0, (flags & 16) != 0,
                        (flags & 32) != 0, word(kStartX, lane), word(kStartY, lane),
                        word(kStartAngle, lane),
                        autoreset::RowIn{word(kEpReturn, lane), iword(kEpLength, lane),
                                         iword(kEntering, lane) != 0}};
        tail(p, env(lane), st, in, iword(kBest, lane), iword(kCount, lane),
             iword(kOutside, lane) != 0);
    }
}

// A block (one warp) a row.
__global__ void __launch_bounds__(32) single_transition_kernel(Params p) {
    extern __shared__ __align__(16) float stage[];  // the row's x and y positions
    __shared__ uint64_t bar;
    const int W = p.num_waypoints;
    const int cap = row_stage::field_capacity(W);
    const size_t i = blockIdx.x;
    const size_t src = row_stage::source_row(p.row_ids, i);  // the waypoint row staged
    const int lane = threadIdx.x;
    const float* positions[2] = {p.wp_x, p.wp_y};

    if (lane == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    row_stage::stage_row(stage, positions, 2, src, W, cap, &bar);
    prefetch_normals(p, src, lane);
    // split: staged
    // while the row arrives, on every lane: the clipped action, the step and the
    // corners (the queries)
    float qx[kQueries], qy[kQueries];
    const Stepped st = step_car(p, i, qx, qy);
    const int count = p.n_wp[i];
    const float width = p.track_width[i];
    row_stage::wait_barrier(&bar);
    __syncthreads();  // the row (and its thread-copied parts) is in
    // split: stepped

    // the track query, by the warp
    bool outside;
    const int best0 = query_row(p, stage, cap, src, count, width, lane, qx, qy, outside);
    // split: searched
    if (lane != 0) return;
    tail(p, i, st, tail_in(p, i), best0, count, outside);
}

// The single-car env's whole transition: rows cars, one env row each. ptrs holds
// kSinglePtrs device pointers in this order: the inputs x, y, angle, vx, vy, crashed,
// action ([rows, action_stride], columns 0 and 1), wp_x, wp_y, nrm_x, nrm_y, row_ids
// (null: row i), n_wp, track_width, progress, last_progress, finished, cp25, cp50,
// cp75, steps, speed_weight (one float, or null for the constant); then the outputs
// nx, ny, nang, nvx, nvy, progress, last_steering, crashed, finished, cp25, cp50, cp75,
// steps, reward, terminated, truncated, speed, info_progress, progress_delta; then
// autoreset.cuh's kPtrs (all null: the plain transition; start_nx, start_ny, the
// grid slots and the pool's four null), with `steps` the rollout's rows. consts
// holds kSingleConsts float32 values: K5's eight, the half length and width, then
// TailSpec's eight floats in its order. Returns a cudaError_t (0 on success).
constexpr int kSinglePtrs = 41 + autoreset::kPtrs;
constexpr int kSingleConsts = 18;

// Params from the entries' arguments; false where they are not what the kernels take.
bool params_of(void* const* ptrs, int num_ptrs, const float* consts, int num_consts,
               int rows, int num_waypoints, int max_steps, int action_stride,
               int rows_per_block, int steps, Params& p) {
    if (num_ptrs != kSinglePtrs || num_consts != kSingleConsts || rows < 0
            || num_waypoints < 1 || action_stride < 2)
        return false;
    int i = 0;
    auto f = [&]() { return static_cast<const float*>(ptrs[i++]); };
    auto b = [&]() { return static_cast<const unsigned char*>(ptrs[i++]); };
    auto n = [&]() { return static_cast<const int*>(ptrs[i++]); };
    auto fo = [&]() { return static_cast<float*>(ptrs[i++]); };
    auto bo = [&]() { return static_cast<unsigned char*>(ptrs[i++]); };
    auto no = [&]() { return static_cast<int*>(ptrs[i++]); };
    p.x = f();
    p.y = f();
    p.angle = f();
    p.vx = f();
    p.vy = f();
    p.crashed = b();
    p.action = f();
    p.wp_x = f();
    p.wp_y = f();
    p.nrm_x = f();
    p.nrm_y = f();
    p.row_ids = n();
    p.n_wp = n();
    p.track_width = f();
    p.progress = f();
    p.last_progress = f();
    p.finished = b();
    p.cp25 = b();
    p.cp50 = b();
    p.cp75 = b();
    p.steps = n();
    p.speed_weight = f();
    p.nx = fo();
    p.ny = fo();
    p.nang = fo();
    p.nvx = fo();
    p.nvy = fo();
    p.progress_out = fo();
    p.last_steering = fo();
    p.crashed_out = bo();
    p.finished_out = bo();
    p.cp25_out = bo();
    p.cp50_out = bo();
    p.cp75_out = bo();
    p.steps_out = no();
    p.reward = fo();
    p.terminated = bo();
    p.truncated = bo();
    p.speed = fo();
    p.info_progress = fo();
    p.delta = fo();
    // the single-car env has no grid and no pool
    if (!autoreset::parse(ptrs + i, steps, 0, 0, 0.0f, 0.0f, p.ar) || p.ar.start_nx
            || p.ar.start_ny || p.ar.slot || p.ar.extra)
        return false;
    p.rows = rows;
    p.num_waypoints = num_waypoints;
    p.action_stride = action_stride;
    p.rows_per_block = rows_per_block;
    p.row_period = 0;
    p.k = car_step::Spec{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
                         consts[6], consts[7]};
    p.half_length = consts[8];
    p.half_width = consts[9];
    p.ts = TailSpec{consts[10], consts[11], consts[12], consts[13], consts[14], consts[15],
                    consts[16], consts[17], max_steps};
    return true;
}

}  // namespace

// The same on the tiled layout: rows_per_block env rows a block (at most 32) of
// `threads` threads (a multiple of 32, at most 256), `smem` bytes of dynamic shared
// memory: the one staged row's two fields of field_capacity(num_waypoints) floats each
// and kCarWords words a row; the launch plan, ops/_cuda.py:single_transition_rows_plan.
// row_period T > 0 gives a block rows T apart (BlockRows), which must read one pool
// row (env i reads row i % T); a block whose rows do not traps.
extern "C" int single_transition_rows_f32(void* const* ptrs, int num_ptrs,
                                          const float* consts, int num_consts, int rows,
                                          int num_waypoints, int threads, int smem,
                                          int max_steps, int action_stride,
                                          int rows_per_block, int row_period, int steps,
                                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Params p;
    if (!params_of(ptrs, num_ptrs, consts, num_consts, rows, num_waypoints, max_steps,
                   action_stride, rows_per_block, steps, p)
            || threads % 32 != 0 || threads < 32 || threads > kMaxThreads
            || rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock || row_period < 1)
        return (int)cudaErrorInvalidValue;
    p.row_period = row_period;
    if (rows == 0) return 0;
    // the dynamic shared memory and the static (under 1 KB) over the default 48 KB
    if (smem + 1024 > 48 * 1024) {
        err = cudaFuncSetAttribute(single_transition_rows_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_residue = (rows + row_period - 1) / row_period;
    const int blocks = row_period * ((per_residue + rows_per_block - 1) / rows_per_block);
    single_transition_rows_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// A block (one warp) a row, `smem` bytes of dynamic shared memory for the row's two
// position fields (ops/_cuda.py:single_transition_plan).
extern "C" int single_transition_f32(void* const* ptrs, int num_ptrs, const float* consts,
                                     int num_consts, int rows, int num_waypoints, int smem,
                                     int max_steps, int action_stride, int steps, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Params p;
    if (!params_of(ptrs, num_ptrs, consts, num_consts, rows, num_waypoints, max_steps,
                   action_stride, 1, steps, p))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    // the dynamic shared memory and the static (under 1 KB) over the default 48 KB
    if (smem + 1024 > 48 * 1024) {
        err = cudaFuncSetAttribute(single_transition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    single_transition_kernel<<<rows, 32, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" const char* single_transition_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
