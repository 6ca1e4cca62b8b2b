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
#include <cuda_runtime.h>

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

template <bool kPairs>
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
        float half_width, float collision_scale) {
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
        c = car_step::step({x[car], y[car], angle[car], vx[car], vy[car]}, crashed[car],
                           steering[car], throttle[car], k);
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
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ccx[4 * car + i] = qx[1 + i];
                ccy[4 * car + i] = qy[1 + i];
            }
            progress[car] = __fdiv_rn((float)best0, (float)count);
            hit_wall[car] = (unsigned char)outside;
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
                num_hits[car] = hits;
            }
        }
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
            collision_scale);
        return cudaGetLastError();
    };
    err = num_hits ? launch(car_step_and_query_kernel<true>)
                   : launch(car_step_and_query_kernel<false>);
    return (int)err;
}

extern "C" const char* car_step_and_query_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
