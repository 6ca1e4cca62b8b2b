// The envs' transition kernel, for NVIDIA Hopper (sm_90a): each car's dynamics step
// (K5), its corners and its track query (K2), in one launch; in the multi-car env's
// instantiation also K4, the separating-axis test of every pair of a row's cars,
// and its velocity response.
//
// Replaces, on the envs' path, the JAX package's car dynamics and track query
// (self_play_racing_tpu/ops/dynamics.py: car_update, then
// self_play_racing_tpu/ops/geometry.py: car_corners and progress_and_collision, as
// envs/single.py and envs/multi.py compose them) and the multi-car env's contact
// response (self_play_racing_tpu/envs/multi.py: rectangles_intersect over the
// [N, A, A] pairs, the diagonal masked, num_hits, and the ladder that scales a
// car's velocity once per partner it touches), which XLA fuses on the TPU.
// Bitwise, it is what the port's K5 kernel, PyTorch's car_corners and K2 kernel
// (and then K4, the mask, the sum and the ladder) compute one after another: the
// step of car_step.cuh, the corners of car_step.cuh from the new pose (cosf/sinf,
// as PyTorch's CUDA cos/sin), and the search of track_query.cuh with the centre
// and the four corners as its queries, then
//   progress = idx(centre) / n_wp   (one IEEE divide),
//   hit_wall = any corner with |projection| > track_width;
// with the pair test, num_hits = the cars b != a whose rectangle intersects a's
// (rect_sat.cuh, a's axes first), and the stepped vx, vy multiplied by
// collision_scale num_hits times, crashed cars included.
// Built with -fmad=false, so every product and sum rounds as PyTorch's.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play shapes (4096
// waypoint rows x 512 padded waypoints, 2 cars a row) the search reads the rows'
// two position fields, 17 MB, about 5 us; the step's fields are 0.4 MB and the
// pair test's 4 axes x 36 operations a pair are nothing beside them. It is bound
// by bytes, as K2.
//
// Design: K2's launch (ops/_cuda.py:car_step_query_plan), one block per waypoint
// row staged by bulk copies (row_stage.cuh), one warp per car of the row, with the
// step in the warp that already holds the car. K5 alone was a launch and nothing
// else, and its outputs were read back by ~10 PyTorch launches that formed the
// corners for K2. Here every lane of the car's warp steps the car and forms its
// corners in registers (the first car's while the row arrives), which are K2's
// queries; lane 0 writes the new state, the corners (the multi-car env's reward
// reads them), the progress and the wall hit. The waypoint count and the track
// width are read once per row.
// K4 was a launch and ~10 elementwise launches around it. With the pair test
// (kPairs, where one block is one env's row of cars), lane 0 of each car's warp
// also puts the car's corners, from the registers of its queries, and its stepped
// velocity into shared memory beside the staged row; after one barrier lane b of
// car a's warp tests the pair (a, b) (b in strides of 32), a ballot counts the
// partners, and lane 0 applies the ladder and writes the velocity and num_hits.
// With row ids (the capacity layouts) block b stages pool row row_ids[b] and reads
// its normals there; the cars, the waypoint count and the width stay env b's.
//
// The multi-car env's whole transition (kTail, entry multi_transition_small_f32,
// which the env launches below ops/_cuda.py:TRANSITION_SMALL_BELOW rows): the
// same block also runs the rest of the JAX package's transition
// (self_play_racing_tpu/envs/multi.py: transition, from the actions' clip to the
// placement), which XLA fuses into the step program on the TPU and which the port
// ran as ~100 elementwise launches of [N, A] around this kernel. Lane 0 of each
// car's warp leaves the car's raw progress, wall hit, partner count and final
// velocity in shared memory; after a barrier thread a runs car a's reward in the
// source's order (progress, speed, checkpoints, finish with its time bonus, the
// one-time crash penalty, the touch penalty) and its placement score; after a
// second barrier every thread reads the row's flags (terminated, truncated) and
// the scores (each car's place by the pairwise rule, the higher seat winning exact
// ties) and adds the winner bonus. Bitwise the PyTorch composition
// (envs/multi.py:transition_plain) on the card: every sum in the source's order,
// the speed's sqrt and the score's 1/fs as IEEE, XLA's divisions by constants as
// products with the float32 reciprocals the caller rounds
// (_numerics.py:div_const), and the comparisons against the constants rounded to
// float32 as PyTorch rounds a Python scalar. The epilogue reads and writes ~40
// bytes a car beside the 17 MB of waypoint rows, so the bound stays K2's. With the
// autoreset's pointers (autoreset.cuh) the last phase also runs the vector step's
// NEXT_STEP autoreset, as multi_transition.cu's does: a resetting row's cars written
// again as the fresh state, thread 0 the row's done, seat 0's episode statistics, the
// rollout's row t and the PFSP counts.
#include <cuda_runtime.h>

#include "autoreset.cuh"
#include "car_step.cuh"
#include "rect_sat.cuh"
#include "row_stage.cuh"
#include "track_query.cuh"

namespace {

constexpr int kFields = 2;  // the staged fields: wp_x, wp_y
constexpr int kQueries = track_query::kQueries;  // the centre and the four corners
constexpr int kMaxThreads = 256;
// The pair test keeps 10 floats a car in shared memory after the staged row,
// field-major ([10][A], so lane b's reads are consecutive): the four corners' x,
// their y, then the stepped vx, vy (ops/_cuda.py:PAIR_FLOATS_PER_CAR).
constexpr int kPairFloats = 10;
// The tail keeps 9 words a car after those, field-major: 5 floats (the raw
// progress, the final vx and vy, the placement score and the reward before the
// winner bonus), then 4 ints (the wall hit, the partner count, finished and
// crashed) (ops/_cuda.py:TAIL_WORDS_PER_CAR).
constexpr int kTailFloats = 5;

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

template <bool kPairs, bool kTail>
__global__ void __launch_bounds__(kMaxThreads) car_step_and_query_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ angle, const float* __restrict__ vx,
        const float* __restrict__ vy, const unsigned char* __restrict__ crashed,
        const float* __restrict__ steering, const float* __restrict__ throttle,
        const float* __restrict__ wp_x, const float* __restrict__ wp_y,
        const float* __restrict__ nrm_x, const float* __restrict__ nrm_y,
        const int* __restrict__ row_ids, const int* __restrict__ n_wp,
        const float* __restrict__ track_width,
        float* __restrict__ nx, float* __restrict__ ny, float* __restrict__ nang,
        float* __restrict__ nvx, float* __restrict__ nvy, float* __restrict__ ccx,
        float* __restrict__ ccy, float* __restrict__ progress,
        unsigned char* __restrict__ hit_wall, int* __restrict__ num_hits,
        int cars_per_row, int num_waypoints, car_step::Spec k, float half_length,
        float half_width, float collision_scale, TailIn tin, TailOut tout, TailSpec ts,
        autoreset::Args ar) {
    extern __shared__ __align__(16) float stage[];
    __shared__ uint64_t bar;
    const int W = num_waypoints;
    const int cap = row_stage::field_capacity(W);
    const size_t row = blockIdx.x;
    const size_t src = row_stage::source_row(row_ids, row);  // the waypoint row staged
    const float* fields[kFields] = {wp_x, wp_y};

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    if (threadIdx.x == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    if (warp == 0) row_stage::stage_row(stage, fields, kFields, src, W, cap, &bar);

    // the warp's car stepped, its centre and corners the queries
    car_step::Car c;
    float qx[kQueries], qy[kQueries];
    auto step_car = [&](size_t car) {
        float steer, thr;
        if constexpr (kTail) {
            steer = clamp(tin.action[2 * car], -1.0f, 1.0f);
            thr = clamp((tin.action[2 * car + 1] + 1.0f) * 0.5f, 0.0f, 1.0f);
        } else {
            steer = steering[car];
            thr = throttle[car];
        }
        c = car_step::step({x[car], y[car], angle[car], vx[car], vy[car]}, crashed[car],
                           steer, thr, k);
        float cx[4], cy[4];
        car_step::corners(c.x, c.y, c.angle, half_length, half_width, cx, cy);
        qx[0] = c.x;
        qy[0] = c.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            qx[1 + i] = cx[i];
            qy[1 + i] = cy[i];
        }
    };
    // the first car's step runs while the row is still arriving
    if (warp < cars_per_row) step_car(row * cars_per_row + warp);
    const int count = n_wp[row];
    const float width = track_width[row];
    row_stage::wait_barrier(&bar);
    __syncthreads();  // the row (and its thread-copied parts) is in
    const float* s_wx = row_stage::staged(stage, wp_x, src, W);
    const float* s_wy = row_stage::staged(stage + cap, wp_y, src, W);
    const float* row_nx = nrm_x + src * W;
    const float* row_ny = nrm_y + src * W;
    const int A = cars_per_row;
    float* s_tail = stage + kFields * cap + (kPairs ? kPairFloats * A : 0);
    int* s_flags = reinterpret_cast<int*>(s_tail + kTailFloats * A);

    for (int a = warp; a < cars_per_row; a += warps) {
        const size_t car = row * cars_per_row + a;
        if (a != warp) step_car(car);
        int best0;
        const bool outside = track_query::search(s_wx, s_wy, row_nx, row_ny, W, lane, qx, qy,
                                                 0, kQueries, width, best0);
        if (lane == 0) {
            nx[car] = c.x;
            ny[car] = c.y;
            nang[car] = c.angle;
            if constexpr (!kPairs) {
                nvx[car] = c.vx;
                nvy[car] = c.vy;
            }
            const float raw_progress = __fdiv_rn((float)best0, (float)count);
            if constexpr (kTail) {
                s_tail[a] = raw_progress;
                s_flags[a] = outside;
                if constexpr (!kPairs) {
                    s_tail[A + a] = c.vx;
                    s_tail[2 * A + a] = c.vy;
                    s_flags[A + a] = 0;
                }
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    ccx[4 * car + i] = qx[1 + i];
                    ccy[4 * car + i] = qy[1 + i];
                }
                progress[car] = raw_progress;
                hit_wall[car] = (unsigned char)outside;
            }
            if constexpr (kPairs) {
                float* s_car = stage + kFields * cap + a;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    s_car[i * cars_per_row] = qx[1 + i];
                    s_car[(4 + i) * cars_per_row] = qy[1 + i];
                }
                s_car[8 * cars_per_row] = c.vx;
                s_car[9 * cars_per_row] = c.vy;
            }
        }
    }
    if constexpr (kPairs) {
        __syncthreads();  // every car's corners and velocity are in
        const float* s_cars = stage + kFields * cap;
        auto rect = [&](int b) {
            rect_sat::Rect r;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                r.x[i] = s_cars[i * cars_per_row + b];
                r.y[i] = s_cars[(4 + i) * cars_per_row + b];
            }
            return r;
        };
        for (int a = warp; a < cars_per_row; a += warps) {
            const rect_sat::Rect ra = rect(a);
            int hits = 0;
            for (int b0 = 0; b0 < cars_per_row; b0 += 32) {
                const int b = b0 + lane;
                const bool hit = b < cars_per_row && b != a && rect_sat::intersect(ra, rect(b));
                hits += __popc(__ballot_sync(0xffffffffu, hit));
            }
            if (lane == 0) {
                const size_t car = row * cars_per_row + a;
                float wx = s_cars[8 * cars_per_row + a];
                float wy = s_cars[9 * cars_per_row + a];
                // the env's ladder: the same factor once per touching partner
                for (int m = 0; m < hits; ++m) {
                    wx = wx * collision_scale;
                    wy = wy * collision_scale;
                }
                nvx[car] = wx;
                nvy[car] = wy;
                if constexpr (kTail) {
                    s_tail[A + a] = wx;
                    s_tail[2 * A + a] = wy;
                    s_flags[A + a] = hits;
                } else {
                    num_hits[car] = hits;
                }
            }
        }
    }
    if constexpr (kTail) {
        __syncthreads();  // every car's raw progress, wall hit, partners and velocity
        const int steps = tin.steps[row] + 1;
        // car a's reward up to the winner bonus, its new flags and its score
        for (int a = threadIdx.x; a < A; a += blockDim.x) {
            const size_t car = row * A + a;
            const bool was_crashed = crashed[car];
            const float p = was_crashed ? tin.progress[car] : s_tail[a];
            const bool now_crashed = was_crashed || s_flags[a] != 0;
            const float lp = tin.last_progress[car];
            float delta = p - lp;
            delta = (lp > kLapHigh && p < kLapLow) ? (1.0f - lp) + p : delta;
            delta = (lp < kLapLow && p > kLapHigh) ? -((1.0f - p) + lp) : delta;
            float reward = delta * ts.progress_scale;

            const float wx = s_tail[A + a];
            const float wy = s_tail[2 * A + a];
            const float speed = __fsqrt_rn(wx * wx + wy * wy);
            const float ratio = clamp(speed * ts.inv_max_speed, 0.0f, 1.0f);
            reward = reward + ((!now_crashed && delta > 0.0f) ? ratio * ts.speed_scale : 0.0f);

            const bool hit25 = !tin.cp25[car] && p >= kCp25Lo && p < kCp25Hi;
            const bool cp25 = tin.cp25[car] || hit25;
            const bool hit50 = cp25 && !tin.cp50[car] && p >= kCp50Lo && p < kCp50Hi;
            const bool cp50 = tin.cp50[car] || hit50;
            const bool hit75 = cp50 && !tin.cp75[car] && p >= kCp75Lo && p < kCp75Hi;
            const bool cp75 = tin.cp75[car] || hit75;
            reward = reward + ts.checkpoint_bonus * (float)(hit25 || hit50 || hit75);

            const bool fin_now = cp25 && cp50 && cp75 && lp > kLapHigh && p < kLapLow &&
                                 delta > 0.0f;
            const bool finished = tin.finished[car] || fin_now;
            const int finished_step = fin_now ? steps : tin.finished_step[car];
            float time_bonus = ts.time_bonus_base - (float)steps * ts.inv_time_bonus_divisor;
            time_bonus = time_bonus < 0.0f ? 0.0f : time_bonus;  // clamp_min: NaN passes
            reward = reward + (fin_now ? ts.finish_bonus + time_bonus : 0.0f);

            const bool crash_now = now_crashed && !tin.has_crashed[car];
            reward = reward - (crash_now ? ts.crash_penalty : 0.0f);
            // the touch penalty: -touch * hits with partners, the env's zeros alone
            reward = reward + (kPairs ? (float)s_flags[A + a] * ts.neg_touch_penalty : 0.0f);

            const float fs = (float)(finished_step != 0 ? finished_step : 10000);
            const float score = (((float)finished * 10000.0f + p * 100.0f) +
                                 (float)(!now_crashed) * 10.0f) + __fdiv_rn(1.0f, fs);
            s_tail[3 * A + a] = score;
            s_tail[4 * A + a] = reward;
            s_flags[2 * A + a] = finished;
            s_flags[3 * A + a] = now_crashed;

            tout.progress[car] = p;
            tout.last_steering[car] = clamp(tin.action[2 * car], -1.0f, 1.0f);
            tout.crashed[car] = now_crashed;
            tout.finished[car] = finished;
            tout.cp25[car] = cp25;
            tout.cp50[car] = cp50;
            tout.cp75[car] = cp75;
            tout.has_crashed[car] = tin.has_crashed[car] || crash_now;
            tout.finished_step[car] = finished_step;
            tout.speed[car] = speed;
            tout.info_progress[car] = finished ? 1.0f : p;
        }
        __syncthreads();  // every car's score and flags
        bool any_finished = false, all_crashed = true;
        for (int b = 0; b < A; ++b) {
            any_finished = any_finished || s_flags[2 * A + b] != 0;
            all_crashed = all_crashed && s_flags[3 * A + b] != 0;
        }
        const bool terminated = any_finished || all_crashed;
        const bool truncated = steps >= ts.max_steps;
        const bool done = terminated || truncated;
        const bool reset = autoreset::resets(ar, row);
        if (threadIdx.x == 0) {
            tout.steps[row] = reset ? 0 : steps;
            tout.terminated[row] = terminated && !reset;
            tout.truncated[row] = truncated && !reset;
        }
        // car a's place: 1 + the cars that beat it (a higher score, or an equal
        // score from a higher seat)
        for (int a = threadIdx.x; a < A; a += blockDim.x) {
            const size_t car = row * A + a;
            const float sa = s_tail[3 * A + a];
            int beaten = 0;
            for (int b = 0; b < A; ++b) {
                const float sb = s_tail[3 * A + b];
                beaten += (sa < sb) || (sa == sb && a < b);
            }
            const int place = 1 + beaten;
            const int placement = done ? place : 0;
            const float reward =
                s_tail[4 * A + a] + ((done && place == 1) ? ts.winner_bonus : 0.0f);
            if (reset) {
                autoreset::fresh_car(ar, row, car, nx, ny, nang, nvx, nvy, tout);
            } else {
                tout.placement[car] = placement;
                tout.reward[car] = reward;
            }
            if (a == 0 && ar.on) {
                autoreset::row_tail(ar, row, gridDim.x, autoreset::row_in(ar, row), reset,
                                    reset ? 0.0f : reward, terminated && !reset,
                                    truncated && !reset, !reset && placement == 1);
            }
        }
        autoreset::pfsp_finish(ar);
    }
}

}  // namespace

// rows waypoint rows of cars_per_row cars each; the car fields [rows *
// cars_per_row] (crashed as 0/1 bytes), the corners ccx, ccy [rows * cars_per_row,
// 4], progress f32 and hit_wall bytes [rows * cars_per_row]; n_wp (int32) and
// track_width [rows]; row i of cars reads waypoint row row_ids[i] (row i where
// row_ids is null) of the waypoint fields [*, num_waypoints]. The constants are
// rounded to float32 by the caller. With num_hits (int32 [rows * cars_per_row])
// not null, the row's cars are one env's and the kernel also runs the pair test
// and scales nvx, nvy by collision_scale once per partner. One block of `threads`
// threads per row and `smem` bytes of dynamic shared memory for the staged row
// (and the pair test's cars): the launch plan, ops/_cuda.py:car_step_query_plan.
// Returns a cudaError_t (0 on success).
extern "C" int car_step_and_query_f32(
        const float* x, const float* y, const float* angle, const float* vx,
        const float* vy, const unsigned char* crashed, const float* steering,
        const float* throttle, const float* wp_x, const float* wp_y,
        const float* nrm_x, const float* nrm_y, const int* row_ids, const int* n_wp,
        const float* track_width, float* nx, float* ny, float* nang, float* nvx,
        float* nvy, float* ccx, float* ccy, float* progress, unsigned char* hit_wall,
        int* num_hits, int rows, int cars_per_row, int num_waypoints, int threads,
        int smem, float steering_speed, float acceleration, float drag,
        float lateral_friction, float grip, float max_speed, float dt, float two_pi,
        float half_length, float half_width, float collision_scale, int device,
        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || cars_per_row == 0) return 0;
    if (cars_per_row < 0 || num_waypoints < 1 || threads % 32 != 0 || threads > kMaxThreads)
        return (int)cudaErrorInvalidValue;
    const car_step::Spec k{steering_speed, acceleration, drag, lateral_friction, grip,
                           max_speed, dt, two_pi};
    auto launch = [&](auto kernel) {
        cudaError_t e = row_stage::allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
            x, y, angle, vx, vy, crashed, steering, throttle, wp_x, wp_y, nrm_x, nrm_y,
            row_ids, n_wp, track_width, nx, ny, nang, nvx, nvy, ccx, ccy, progress, hit_wall,
            num_hits, cars_per_row, num_waypoints, k, half_length, half_width,
            collision_scale, TailIn{}, TailOut{}, TailSpec{}, autoreset::Args{});
        return cudaGetLastError();
    };
    err = num_hits ? launch(car_step_and_query_kernel<true, false>)
                   : launch(car_step_and_query_kernel<false, false>);
    return (int)err;
}

// The multi-car env's whole transition (kTail): rows env rows of cars_per_row cars,
// one block each, the pair test run when pairs != 0 (the env runs it with more
// than one car). ptrs holds kTransitionPtrs device pointers in this order: the
// inputs x, y, angle, vx, vy, crashed, action ([rows * A, 2]), wp_x, wp_y, nrm_x,
// nrm_y, row_ids (null: row i), n_wp, track_width, progress, last_progress,
// finished, cp25, cp50, cp75, has_crashed, finished_step, steps; then the outputs
// nx, ny, nang, nvx, nvy, progress, last_steering, crashed, finished, cp25, cp50,
// cp75, has_crashed, steps, finished_step, placement, reward, terminated, truncated,
// speed, info_progress; then autoreset.cuh's kPtrs (all null: the plain transition),
// with `steps`, `pool` and `pfsp_mode` as multi_transition_f32 takes them. consts
// holds kTransitionConsts float32 values: K5's eight, the half length and width,
// collision_scale, then TailSpec's ten floats in its order, then the start grid's
// center and spacing. The launch plan: ops/_cuda.py:car_step_query_plan(...,
// tail=True).
constexpr int kTransitionPtrs = 44 + autoreset::kPtrs;
constexpr int kTransitionConsts = 23;

extern "C" int multi_transition_small_f32(void* const* ptrs, int num_ptrs, const float* consts,
                                    int num_consts, int rows, int cars_per_row,
                                    int num_waypoints, int threads, int smem, int pairs,
                                    int max_steps, int steps, int pool, int pfsp_mode,
                                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (num_ptrs != kTransitionPtrs || num_consts != kTransitionConsts)
        return (int)cudaErrorInvalidValue;
    if (rows == 0 || cars_per_row == 0) return 0;
    if (cars_per_row < 0 || num_waypoints < 1 || threads % 32 != 0 || threads > kMaxThreads)
        return (int)cudaErrorInvalidValue;
    int i = 0;
    auto f = [&]() { return static_cast<const float*>(ptrs[i++]); };
    auto b = [&]() { return static_cast<const unsigned char*>(ptrs[i++]); };
    auto n = [&]() { return static_cast<const int*>(ptrs[i++]); };
    const float *x = f(), *y = f(), *angle = f(), *vx = f(), *vy = f();
    const unsigned char* crashed = b();
    const float* action = f();
    const float *wp_x = f(), *wp_y = f(), *nrm_x = f(), *nrm_y = f();
    const int *row_ids = n(), *n_wp = n();
    const float* track_width = f();
    TailIn tin;
    tin.action = action;
    tin.progress = f();
    tin.last_progress = f();
    tin.finished = b();
    tin.cp25 = b();
    tin.cp50 = b();
    tin.cp75 = b();
    tin.has_crashed = b();
    tin.finished_step = n();
    tin.steps = n();
    auto fo = [&]() { return static_cast<float*>(ptrs[i++]); };
    auto bo = [&]() { return static_cast<unsigned char*>(ptrs[i++]); };
    auto no = [&]() { return static_cast<int*>(ptrs[i++]); };
    float *nx = fo(), *ny = fo(), *nang = fo(), *nvx = fo(), *nvy = fo();
    TailOut tout;
    tout.progress = fo();
    tout.last_steering = fo();
    tout.crashed = bo();
    tout.finished = bo();
    tout.cp25 = bo();
    tout.cp50 = bo();
    tout.cp75 = bo();
    tout.has_crashed = bo();
    tout.steps = no();
    tout.finished_step = no();
    tout.placement = no();
    tout.reward = fo();
    tout.terminated = bo();
    tout.truncated = bo();
    tout.speed = fo();
    tout.info_progress = fo();
    const car_step::Spec k{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5],
                           consts[6], consts[7]};
    const float half_length = consts[8], half_width = consts[9], collision_scale = consts[10];
    const TailSpec ts{consts[11], consts[12], consts[13], consts[14], consts[15], consts[16],
                      consts[17], consts[18], consts[19], consts[20], max_steps};
    autoreset::Args ar;
    if (!autoreset::parse(ptrs + i, steps, pool, pfsp_mode, consts[21], consts[22], ar)
            || (ar.on && !(ar.start_nx && ar.start_ny && ar.slot)))
        return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
        cudaError_t e = row_stage::allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
            x, y, angle, vx, vy, crashed, nullptr, nullptr, wp_x, wp_y, nrm_x, nrm_y,
            row_ids, n_wp, track_width, nx, ny, nang, nvx, nvy, nullptr, nullptr, nullptr,
            nullptr, nullptr, cars_per_row, num_waypoints, k, half_length, half_width,
            collision_scale, tin, tout, ts, ar);
        return cudaGetLastError();
    };
    err = pairs ? launch(car_step_and_query_kernel<true, true>)
                : launch(car_step_and_query_kernel<false, true>);
    return (int)err;
}

extern "C" const char* car_step_and_query_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
