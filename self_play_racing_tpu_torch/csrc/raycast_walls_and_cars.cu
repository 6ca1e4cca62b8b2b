// The multi-car env's sensing, for NVIDIA Hopper (sm_90a): every car's rays against
// the walls of its env row (K1) and against the cars of the row (K3), their
// minimum, in one launch.
//
// Replaces, on the multi-car env's path, the JAX package's wall raycast and car
// raycast (self_play_racing_tpu/ops/geometry.py: raycast_walls and raycast_cars,
// with car_corners and jnp.minimum, as envs/multi.py composes them), which XLA
// fuses on the TPU. Bitwise, it is what the port's K1 and K3 kernels compute from
// the rays and corners that PyTorch forms:
//   world = angle + rel                  (one f32 add)
//   ray   = (x, y) + t (cosf(world), sinf(world))
//   wall  = K1's fold over the row's segments (wall_fold.cuh), unclamped hits
//   car   = K3's edge loop over the row's cars (car_hits.cuh), clamped to max_dist
//   out   = torch.minimum(wall, car): NaN when either is NaN, else fminf.
// cosf/sinf without fast math are what PyTorch's CUDA cos/sin call, and the
// corners are car_step.cuh's, in car_corners' order; built with -fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play shapes (4096
// env rows x 2 cars x 11 rays against 896 padded segments and 2 cars) the wall
// fold is 2.10 GFLOP (26 operations a ray-segment pair), about 31 us, against 73 MB
// of segment rows, about 22 us; the car pass adds ~20 operations a ray and edge.
// It is bound by operations, and in practice by the fold's issue rate, as K1.
//
// Design: K1's self-play launch, with the car pass in the block that already holds
// the row and the rays. What the separate launches cost was not their arithmetic
// but the launches and the ~20 PyTorch launches that built their inputs (the four
// [N, A, R] ray tensors and two copies of each, the corners); here the rays are
// formed in registers and the cars in shared memory.
//   - one block per env row (ops/_cuda.py:raycast_walls_and_cars_plan): the row's
//     segment fields staged by bulk copies (row_stage.cuh), as K1; the row's A cars
//     beside them in shared memory (corners, edge vectors, centres: 18 floats a
//     car), each formed by one thread from (x, y, angle);
//   - a warp takes R rays of the row at a time, as K1: lane t < R forms ray t from
//     (x, y, angle, rel) and the warp broadcasts the R rays to every lane, so each
//     cosf/sinf runs once; then K1's fold;
//   - after the fold lane 0 holds the group's R winners; lane t takes ray t's by a
//     shuffle, divides, and runs K3's edge loop for its ray (8 edges at 2 cars).
//     It forms its ray again from (x, y, angle, rel) instead of keeping it through
//     the fold: the fold's registers set how many blocks an SM holds;
//   - with row ids (the capacity layouts) block b stages pool row row_ids[b]; the
//     cars and rays stay env b's.
//
// The multi-car env's whole observation (kObs, entry multi_observe_small_f32,
// which the env launches below ops/_cuda.py:OBSERVE_SMALL_BELOW rows): the same
// block writes the f32 row [A, obs_dim] that the JAX package's observe
// (self_play_racing_tpu/envs/multi.py: observe) returns, which XLA fuses on the
// TPU and which the port ran as ~50 launches around this kernel: each ray's
// distance, clamped to the range where the config asks, times the float32
// reciprocal of the range (_numerics.py:div_const); then per car v_fwd and v_lat
// (its velocity in its frame times the reciprocal of max_speed, clamped to +-1),
// the constant 0 and last_steering; then per other seat in seat order the relative
// position in the car's frame over the env's max_track_distance (an IEEE divide)
// and the relative velocity over max_speed, each clamped to +-1. Thread p of the
// block takes the car pair (p / A, p % A), the diagonal being the car's own four
// features, while the row's segments arrive. cos/sin of the heading are cosf/sinf
// as above; the sums in the source's order, built with -fmad=false, so the row is
// bitwise the PyTorch composition (envs/multi.py:observe_plain) on the card. The
// epilogue reads 24 bytes a car and writes 4 * obs_dim (76 at A = 2): ~0.7 MB at
// the self-play shapes beside the kernel's 2.1 GFLOP, so its bound stays the fold's.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "car_hits.cuh"
#include "car_step.cuh"
#include "row_stage.cuh"
#include "wall_fold.cuh"

namespace {

constexpr int kFields = wall_fold::kFields;
constexpr int kMaxThreads = 256;

// ray r of env row `row` (car r / num_sensors, sensor r % num_sensors)
__device__ __forceinline__ void ray_of(const float* x, const float* y, const float* angle,
                                       const float* rel, size_t row, int num_cars,
                                       int num_sensors, int r, float& ox, float& oy,
                                       float& dx, float& dy) {
    const int a = r / num_sensors;
    const size_t i = row * num_cars + a;
    ox = x[i];
    oy = y[i];
    const float world = angle[i] + rel[r - a * num_sensors];
    dx = cosf(world);
    dy = sinf(world);
}

// torch.clamp(v, -1, 1) on the card: NaN passes
__device__ __forceinline__ float clamp_unit(float v) {
    return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// The observation's inputs beyond the poses (kObs): the velocities and
// last_steering [rows * A], max_track_distance [rows], and the float32
// reciprocals of the sensor range and max_speed.
struct ObsIn {
    const float* vx;
    const float* vy;
    const float* last_steering;
    const float* max_track_distance;
    float inv_range;
    float inv_max_speed;
    int clamp_range;
    int cars;  // 0: no car pass, each ray its wall hit (the single-car env's rays)
};

template <int R, bool kObs>
__global__ void __launch_bounds__(kMaxThreads) raycast_walls_and_cars_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ angle, const float* __restrict__ rel,
        const float* __restrict__ seg_sx, const float* __restrict__ seg_sy,
        const float* __restrict__ seg_vx, const float* __restrict__ seg_vy,
        const float* __restrict__ seg_c, const int* __restrict__ row_ids,
        float* __restrict__ out, int num_cars,
        int num_sensors, int num_segments, float half_length, float half_width,
        float max_dist, ObsIn obs) {
    extern __shared__ __align__(16) float stage[];
    __shared__ uint64_t bar;
    const int S = num_segments;
    const int L = (S + 31) / 32;
    const int cap = row_stage::field_capacity(32 * L);  // room for the padding past S
    const size_t row = blockIdx.x;
    const size_t src = row_stage::source_row(row_ids, row);  // the segment row staged
    const float* fields[kFields] = {seg_sx, seg_sy, seg_vx, seg_vy, seg_c};
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int rays_per_row = num_cars * num_sensors;
    const int groups = (rays_per_row + R - 1) / R;

    if (threadIdx.x == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    if (warp == 0) row_stage::stage_row(stage, fields, kFields, src, S, cap, &bar);

    // the row's cars, beside the staged walls
    const car_hits::Cars cars = car_hits::layout(stage + kFields * cap, num_cars);
    for (int a = threadIdx.x; a < num_cars; a += blockDim.x) {
        const size_t i = row * num_cars + a;
        float cx[4], cy[4];
        car_step::corners(x[i], y[i], angle[i], half_length, half_width, cx, cy);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            cars.sx[4 * a + e] = cx[e];
            cars.sy[4 * a + e] = cy[e];
            cars.vx[4 * a + e] = cx[(e + 1) & 3] - cx[e];
            cars.vy[4 * a + e] = cy[(e + 1) & 3] - cy[e];
        }
        cars.x[a] = x[i];
        cars.y[a] = y[i];
    }
    // the observation's kinematic and opponent columns, while the row arrives
    const int obs_dim = num_sensors + 4 * num_cars;  // R + 4 + 4 (A - 1)
    if constexpr (kObs) {
        const int A = num_cars;
        for (int p = threadIdx.x; p < A * A; p += blockDim.x) {
            const int i = p / A;
            const int j = p - i * A;
            const size_t ci = row * A + i;
            float* o = out + ci * obs_dim + num_sensors;
            const float ca = cosf(angle[ci]);
            const float sa = sinf(angle[ci]);
            if (i == j) {
                const float vx = obs.vx[ci], vy = obs.vy[ci];
                o[0] = clamp_unit((vx * ca + vy * sa) * obs.inv_max_speed);
                o[1] = clamp_unit((-vx * sa + vy * ca) * obs.inv_max_speed);
                o[2] = 0.0f;  // the reference's angular velocity, never written
                o[3] = obs.last_steering[ci];
            } else {
                const size_t cj = row * A + j;
                const float rx = x[cj] - x[ci], ry = y[cj] - y[ci];
                const float rvx = obs.vx[cj] - obs.vx[ci], rvy = obs.vy[cj] - obs.vy[ci];
                const float td = obs.max_track_distance[row];
                float* q = o + 4 + 4 * (j < i ? j : j - 1);
                q[0] = clamp_unit(__fdiv_rn(rx * ca + ry * sa, td));
                q[1] = clamp_unit(__fdiv_rn(-rx * sa + ry * ca, td));
                q[2] = clamp_unit((rvx * ca + rvy * sa) * obs.inv_max_speed);
                q[3] = clamp_unit((-rvx * sa + rvy * ca) * obs.inv_max_speed);
            }
        }
    }

    // group g's rays g*R .. g*R + R-1 (the last ray repeated past the row's end),
    // as K1 loads them: lane t < R forms ray t, and the warp broadcasts them
    float rox[R], roy[R], rdx[R], rdy[R], u[R];
    auto load_rays = [&](int g) {
        float ox, oy, dx, dy;
        ray_of(x, y, angle, rel, row, num_cars, num_sensors,
               min(g * R + min(lane, R - 1), rays_per_row - 1), ox, oy, dx, dy);
#pragma unroll
        for (int t = 0; t < R; ++t) {
            rox[t] = __shfl_sync(0xffffffffu, ox, t);
            roy[t] = __shfl_sync(0xffffffffu, oy, t);
            rdx[t] = __shfl_sync(0xffffffffu, dx, t);
            rdy[t] = __shfl_sync(0xffffffffu, dy, t);
            u[t] = rox[t] * rdy[t] - roy[t] * rdx[t];
        }
    };
    if (warp < groups) load_rays(warp);  // in flight while the row arrives

    row_stage::wait_barrier(&bar);
    const float* rs[kFields];
    wall_fold::staged_fields(stage, fields, kFields, src, S, L, cap, rs);
    __syncthreads();  // the walls, their padding and the cars are in

    for (int g = warp; g < groups; g += warps) {
        if (g != warp) load_rays(g);
        float pa[R], pd[R];
        wall_fold::fold<R>(rs[0], rs[1], rs[2], rs[3], rs[4], true, L, lane, rox, roy, rdx,
                           rdy, u, pa, pd);
        // lane t < R takes ray t's wall winner from lane 0, then its car pass
        float wa = 0.0f, wd = 1.0f;
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const float qa = __shfl_sync(0xffffffffu, pa[t], 0);
            const float qd = __shfl_sync(0xffffffffu, pd[t], 0);
            wa = lane == t ? qa : wa;
            wd = lane == t ? qd : wd;
        }
        const int r = g * R + lane;
        if (lane < R && r < rays_per_row) {
            float ox, oy, dx, dy;
            ray_of(x, y, angle, rel, row, num_cars, num_sensors, r, ox, oy, dx, dy);
            const float wall = wall_fold::distance(wa, wd, max_dist);
            float d = wall;
            if (!kObs || obs.cars) {
                const float car = car_hits::nearest(cars, ox, oy, dx, dy, max_dist);
                // torch.minimum(wall, car) on the card: the first NaN, else fminf
                d = wall != wall ? wall : (car != car ? car : fminf(wall, car));
            }
            if constexpr (kObs) {
                // torch.clamp_max(d, range) keeps a NaN; then div_const(d, range)
                if (obs.clamp_range) d = d > max_dist ? max_dist : d;
                const int a = r / num_sensors;
                out[(row * num_cars + a) * obs_dim + (r - a * num_sensors)] = d * obs.inv_range;
            } else {
                out[row * rays_per_row + r] = d;
            }
        }
    }
}

template <int R, bool kObs>
int launch(const float* x, const float* y, const float* angle, const float* rel,
           const float* sx, const float* sy, const float* vx, const float* vy,
           const float* c, const int* row_ids, float* out, int rows, int num_cars,
           int num_sensors,
           int num_segments, float half_length, float half_width, float max_dist,
           int threads, int smem, cudaStream_t stream, ObsIn obs) {
    auto kernel = raycast_walls_and_cars_kernel<R, kObs>;
    const cudaError_t err = row_stage::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, threads, smem, stream>>>(x, y, angle, rel, sx, sy, vx, vy, c, row_ids, out,
                                            num_cars, num_sensors, num_segments,
                                            half_length, half_width, max_dist, obs);
    return (int)cudaGetLastError();
}

template <bool kObs>
int launch_rays(const float* x, const float* y, const float* angle, const float* rel,
                const float* seg_sx, const float* seg_sy, const float* seg_vx,
                const float* seg_vy, const float* seg_c, const int* row_ids, float* out,
                int rows, int num_cars, int num_sensors, int num_segments,
                float half_length, float half_width, float max_dist, int threads, int smem,
                int rays_per_lane, void* stream, ObsIn obs) {
    if (rows == 0 || num_cars == 0 || num_sensors == 0) return 0;
    if (threads % 32 != 0 || threads > kMaxThreads || num_segments < 1 || num_cars < 0
            || num_sensors < 0 || seg_c == nullptr)
        return (int)cudaErrorInvalidValue;
    const auto st = (cudaStream_t)stream;
#define RWC_LAUNCH(R) \
    case R: return launch<R, kObs>(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c, \
                                   row_ids, out, rows, num_cars, num_sensors, num_segments, \
                                   half_length, half_width, max_dist, threads, smem, st, obs)
    switch (rays_per_lane) {
        RWC_LAUNCH(1);
        RWC_LAUNCH(2);
        RWC_LAUNCH(3);
        RWC_LAUNCH(4);
        RWC_LAUNCH(6);
        RWC_LAUNCH(8);
        RWC_LAUNCH(11);
        default: return (int)cudaErrorInvalidValue;
    }
#undef RWC_LAUNCH
}

}  // namespace

// rows env rows of num_cars cars: poses x, y, angle [rows * num_cars], sensor
// angles rel [num_sensors], out [rows * num_cars * num_sensors]; env row i sees
// segment row row_ids[i] (row i where row_ids is null), row j of the segment
// fields being [j*S, (j+1)*S), seg_c = vy*sx - vx*sy among them. One block
// of `threads` threads per row, `smem` bytes of dynamic shared memory for the
// staged row and its cars, `rays_per_lane` rays a lane: the launch plan,
// ops/_cuda.py:raycast_walls_and_cars_plan. Returns a cudaError_t (0 on success).
extern "C" int raycast_walls_and_cars_f32(
        const float* x, const float* y, const float* angle, const float* rel,
        const float* seg_sx, const float* seg_sy, const float* seg_vx,
        const float* seg_vy, const float* seg_c, const int* row_ids, float* out,
        int rows, int num_cars, int num_sensors, int num_segments,
        float half_length, float half_width, float max_dist,
        int threads, int smem, int rays_per_lane, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return launch_rays<false>(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c, row_ids,
                              out, rows, num_cars, num_sensors, num_segments, half_length,
                              half_width, max_dist, threads, smem, rays_per_lane, stream,
                              ObsIn{});
}

// The multi-car env's observation (kObs): as raycast_walls_and_cars_f32, with the
// velocities vx, vy and last_steering [rows * num_cars], max_track_distance
// [rows], and obs [rows * num_cars * (num_sensors + 4 * num_cars)] in place of
// out; inv_range and inv_max_speed the float32 reciprocals of max_dist and the
// car's max_speed; clamp_range != 0 clamps each ray to max_dist first. cars == 0
// leaves out the car pass and the minimum (multi_observe.cu's single-car rays).
extern "C" int multi_observe_small_f32(
        const float* x, const float* y, const float* angle, const float* vx,
        const float* vy, const float* last_steering, const float* max_track_distance,
        const float* rel, const float* seg_sx, const float* seg_sy, const float* seg_vx,
        const float* seg_vy, const float* seg_c, const int* row_ids, float* obs,
        int rows, int num_cars, int num_sensors, int num_segments,
        float half_length, float half_width, float max_dist, float inv_range,
        float inv_max_speed, int clamp_range, int threads, int smem, int rays_per_lane,
        int cars, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (vx == nullptr || vy == nullptr || last_steering == nullptr
            || max_track_distance == nullptr)
        return (int)cudaErrorInvalidValue;
    const ObsIn in{vx, vy, last_steering, max_track_distance, inv_range, inv_max_speed,
                   clamp_range, cars};
    return launch_rays<true>(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c, row_ids,
                             obs, rows, num_cars, num_sensors, num_segments, half_length,
                             half_width, max_dist, threads, smem, rays_per_lane, stream, in);
}

extern "C" const char* raycast_walls_and_cars_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
