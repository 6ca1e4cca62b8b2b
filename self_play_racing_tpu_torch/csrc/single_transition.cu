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
// Design: multi_transition.cu's at one car a row, without the pair test, and a block
// (one warp) a row, as car_step_and_query runs: the warp stages the row's waypoint
// positions with bulk copies (row_stage.cuh) and prefetches its normals into the L2;
// while the row arrives every lane clips the action, steps the car and forms its
// corners (the same values on each lane); then the warp runs the search over
// [0, n_wp) and the padding only where its box could win (waypoint_search.cuh); then
// lane 0 runs the tail and writes every output. Timed against 8 rows a block (a warp
// a car), it was as fast or faster at 16 to 4096 rows, gathered and by row id
// (PERF.md, the single_transition row).
#include <cuda_runtime.h>

#include "car_step.cuh"
#include "row_stage.cuh"
#include "waypoint_search.cuh"

namespace {

constexpr int kQueries = waypoint_search::kQueries;  // the centre and the four corners

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
    int num_waypoints, action_stride;
    car_step::Spec k;
    float half_length, half_width;
    TailSpec ts;
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
    // the normals are read at the winners only: the row's 16-byte-aligned middles
    // into the L2 ahead of them
    if (lane < 2) {
        const float* row_n = (lane == 0 ? p.nrm_x : p.nrm_y) + src * W;
        const uintptr_t lo = (reinterpret_cast<uintptr_t>(row_n) + 15) & ~uintptr_t(15);
        const uintptr_t hi = reinterpret_cast<uintptr_t>(row_n + W) & ~uintptr_t(15);
        if (hi > lo) {
            asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                         :: "l"(lo), "r"(static_cast<uint32_t>(hi - lo)) : "memory");
        }
    }
    // while the row arrives, on every lane: the clipped action, the step and the
    // corners (the queries)
    const float* a = p.action + i * (size_t)p.action_stride;
    const float steer = clamp(a[0], -1.0f, 1.0f);
    const float thr = clamp(a[1], 0.0f, 1.0f);
    const bool was_crashed = p.crashed[i];
    const car_step::Car s = car_step::step({p.x[i], p.y[i], p.angle[i], p.vx[i], p.vy[i]},
                                           was_crashed, steer, thr, p.k);
    float qx[kQueries], qy[kQueries];
    {
        float cx[4], cy[4];
        car_step::corners(s.x, s.y, s.angle, p.half_length, p.half_width, cx, cy);
        qx[0] = s.x;
        qy[0] = s.y;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            qx[1 + t] = cx[t];
            qy[1 + t] = cy[t];
        }
    }
    const int count = p.n_wp[i];
    const float width = p.track_width[i];
    row_stage::wait_barrier(&bar);
    __syncthreads();  // the row (and its thread-copied parts) is in

    // the track query, by the warp
    const float* s_wx = row_stage::staged(stage, p.wp_x, src, W);
    const float* s_wy = row_stage::staged(stage + cap, p.wp_y, src, W);
    const int m = min(max(count, 0), W);
    const waypoint_search::Box box = waypoint_search::box_of(s_wx, s_wy, m, W, lane);
    int best[kQueries];
    waypoint_search::search(s_wx, s_wy, m, W, box, lane, qx, qy, best);
    // lane t forms query t's projection on its winner's normal
    int w = best[0];
    float px = qx[0], py = qy[0];
#pragma unroll
    for (int t = 1; t < kQueries; ++t) {
        w = lane == t ? best[t] : w;
        px = lane == t ? qx[t] : px;
        py = lane == t ? qy[t] : py;
    }
    bool outside = false;
    if (lane > 0 && lane < kQueries && w < W) {
        // w < W: there is no winner only where every d^2 is NaN or overflows
        const float ddx = px - s_wx[w];
        const float ddy = py - s_wy[w];
        const float proj = ddx * p.nrm_x[src * W + w] + ddy * p.nrm_y[src * W + w];
        outside = fabsf(proj) > width;
    }
    outside = __any_sync(0xffffffffu, outside);
    if (lane != 0) return;

    // lane 0: the tail
    const TailSpec& ts = p.ts;
    const int steps = p.steps[i] + 1;
    const float pr = was_crashed ? p.progress[i] : __fdiv_rn((float)best[0], (float)count);
    const bool crashed = was_crashed || outside;
    const float lp = p.last_progress[i];
    float delta = pr - lp;
    delta = (lp > kLapHigh && pr < kLapLow) ? (1.0f - lp) + pr : delta;
    delta = (lp < kLapLow && pr > kLapHigh) ? -((1.0f - pr) + lp) : delta;
    float reward = delta * ts.progress_scale;

    const bool hit25 = !p.cp25[i] && pr >= kCp25Lo && pr < kCp25Hi;
    const bool cp25 = p.cp25[i] || hit25;
    const bool hit50 = cp25 && !p.cp50[i] && pr >= kCp50Lo && pr < kCp50Hi;
    const bool cp50 = p.cp50[i] || hit50;
    const bool hit75 = cp50 && !p.cp75[i] && pr >= kCp75Lo && pr < kCp75Hi;
    const bool cp75 = p.cp75[i] || hit75;
    reward = reward + ts.checkpoint_bonus * (float)(hit25 || hit50 || hit75);

    const float speed = __fsqrt_rn(s.vx * s.vx + s.vy * s.vy);
    const float ratio = clamp(speed * ts.inv_max_speed, 0.0f, 1.0f);
    const float sw = p.speed_weight ? *p.speed_weight : ts.speed_weight;
    reward = (!crashed && delta > 0.0f) ? reward + ratio * sw : reward;
    reward = crashed ? reward - ts.crash_penalty : reward;

    const bool fin_now = cp25 && cp50 && cp75 && lp > kLapHigh && pr < kLapLow &&
                         delta > 0.0f;
    const bool finished = p.finished[i] || fin_now;
    float time_bonus = ts.time_bonus_base - (float)steps * ts.inv_time_bonus_divisor;
    time_bonus = time_bonus < 0.0f ? 0.0f : time_bonus;  // clamp_min: NaN passes
    reward = fin_now ? reward + ts.finish_bonus : reward;
    reward = fin_now ? reward + time_bonus : reward;

    p.nx[i] = s.x;
    p.ny[i] = s.y;
    p.nang[i] = s.angle;
    p.nvx[i] = s.vx;
    p.nvy[i] = s.vy;
    p.last_steering[i] = steer;
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
}

}  // namespace

// The single-car env's whole transition: rows cars, one env row each, a block (one
// warp) a row. ptrs holds kSinglePtrs device pointers in this order: the inputs
// x, y, angle, vx, vy, crashed, action ([rows, action_stride], columns 0 and 1),
// wp_x, wp_y, nrm_x, nrm_y, row_ids (null: row i), n_wp, track_width, progress,
// last_progress, finished, cp25, cp50, cp75, steps, speed_weight (one float, or
// null for the constant); then the outputs nx, ny, nang, nvx, nvy, progress,
// last_steering, crashed, finished, cp25, cp50, cp75, steps, reward, terminated,
// truncated, speed, info_progress, progress_delta. consts holds kSingleConsts
// float32 values: K5's eight, the half length and width, then TailSpec's eight
// floats in its order. `smem` bytes of dynamic shared memory a block: the launch plan,
// ops/_cuda.py:single_transition_plan. Returns a cudaError_t (0 on success).
constexpr int kSinglePtrs = 41;
constexpr int kSingleConsts = 18;

extern "C" int single_transition_f32(void* const* ptrs, int num_ptrs, const float* consts,
                                     int num_consts, int rows, int num_waypoints,
                                     int smem, int max_steps, int action_stride, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kSinglePtrs || num_consts != kSingleConsts) return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    if (rows < 0 || num_waypoints < 1 || action_stride < 2) return (int)cudaErrorInvalidValue;
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
    p.num_waypoints = num_waypoints;
    p.action_stride = action_stride;
    p.k = car_step::Spec{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
                         consts[6], consts[7]};
    p.half_length = consts[8];
    p.half_width = consts[9];
    p.ts = TailSpec{consts[10], consts[11], consts[12], consts[13], consts[14], consts[15],
                    consts[16], consts[17], max_steps};
    // the dynamic shared memory and the static (under 1 KB) over the default 48 KB
    if (smem + 1024 > 48 * 1024) {
        err = cudaFuncSetAttribute(single_transition_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    single_transition_kernel<<<rows, 32, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" const char* single_transition_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
