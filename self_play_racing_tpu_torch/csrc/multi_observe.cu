// The multi-car env's observation, for NVIDIA Hopper (sm_90a): every car's rays
// against the walls of its env row (K1) and the row's cars (K3), their minimum, and
// the rest of the [A, obs_dim] row, in one launch.
//
// Replaces the JAX package's observe (self_play_racing_tpu/envs/multi.py: observe,
// with ops/geometry.py: raycast_walls and raycast_cars), which XLA fuses on the TPU.
// Bitwise it is what the narrow kernel raycast_walls_and_cars and PyTorch around it
// compute (envs/multi.py:observe_plain): the rays formed from (x, y, angle + rel)
// with cosf/sinf (PyTorch's CUDA cos/sin), K1's fold in its reduction shape
// (wall_fold.cuh), K3's edge loop (car_hits.cuh), torch.minimum, the clamp to the
// range and the float32 reciprocal of the range; then per car v_fwd, v_lat, 0 and
// last_steering, and per other seat the relative position over max_track_distance
// (an IEEE divide) and the relative velocity over max_speed, clamped to +-1. Built
// with -fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the wall fold, 26 operations a
// ray-segment pair, counted over the rows' real segments (663.75 of 896 on the
// canonical pool: 1.56 GFLOP at 4096 rows x 22 rays, about 23 us), against 73 MB of
// gathered segment rows (22 us) or the pool's 16 rows by id. Bound by operations.
//
// What held the first version (raycast_walls_and_cars.cu:multi_observe_small_f32,
// which the env still launches on few rows, where it is faster) back, and what
// this one does about it (run_fold.cuh):
//   - the fold ran on padding: lane j folded run j to its end whatever the row's
//     real extent, so a row of 660 real segments kept 24 of 32 lanes busy for all
//     28 steps. Here the block stages `rows_per_block` rows, finds each row's real
//     extent E, and lays the (ray group, run) items of its rows that E leaves over
//     its lanes one after another: run j of a row folds [j*L, min((j+1)*L, E)),
//     with L = ceil(S/32) as before, so the pairs a near-tie compares are the same;
//   - the cross term was formed for every ray: where each of the plan's ray groups
//     is one car's rays (ops/_cuda.py:groups_are_cars), cn and |cn| are formed once
//     a segment a group;
//   - the 32 run results of a ray combine in shared memory, one thread a ray, in
//     the shuffle tree's order;
//   - the car pass ran after the fold, on 11 of 32 lanes, serially over the cars:
//     here it runs while the rows arrive, one thread a (ray, car), and the thread
//     that combines a ray's runs takes the cars' minima in car order.
// The rays are formed once (a thread a ray, into a table in shared memory) while
// the rows arrive, as are the cars' corners and the observation's kinematic and
// opponent columns (a thread a car pair). Where a block's threads fold one item
// each, the run results go where the staged rows were, so that an SM holds more
// blocks.
//
// Split points for scripts/env_kernel_split.py, which builds this source with an
// early return at one of them: "split: staged", "split: folded", "split: walls".
#include <cuda_runtime.h>
#include <math_constants.h>

#include "car_hits.cuh"
#include "car_step.cuh"
#include "row_stage.cuh"
#include "run_fold.cuh"
#include "wall_fold.cuh"

namespace {

constexpr int kFields = wall_fold::kFields;
constexpr int kMaxThreads = 256;
constexpr int kMaxRowsPerBlock = 8;  // ops/_cuda.py:OBSERVE_MAX_ROWS_PER_BLOCK
constexpr int kRayFloats = 5;        // a ray's ox, oy, dx, dy, u in the ray table

struct Params {
    const float* x;
    const float* y;
    const float* angle;
    const float* vx;
    const float* vy;
    const float* last_steering;
    const float* max_track_distance;
    const float* rel;
    const float* seg[kFields];  // sx, sy, vx, vy, c
    const int* row_ids;
    float* obs;
    int rows, num_cars, num_sensors, num_segments, rows_per_block;
    int overlay;  // the run results take the staged rows' place (one item a thread)
    float half_length, half_width, max_dist, inv_range, inv_max_speed;
    int clamp_range;
    int cars;  // 0: no car pass, each ray its wall hit (the single-car env's rays)
    // 0: block b serves env rows b*P + q; T > 0: rows r + (c*P + q)*T with r = b % T
    // and c = b / T, which all read one segment row (the tiled layout: env i reads
    // pool row i % T), staged once
    int row_period;
};

// torch.clamp(v, -1, 1) on the card: NaN passes
__device__ __forceinline__ float clamp_unit(float v) {
    return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// The dynamic shared memory of a block, in floats from its start (the launch plan,
// ops/_cuda.py:_observe_shape, sizes it the same way): the staged rows' five fields
// (P rows', or one row where the block's rows share it), the P rows' ray table (slots
// = groups * R a row), cars (18 floats a car) and (ray, car) minima, then the run
// results (a then d, kRunStride a slot) unless they take the staged rows' place once
// the fold is done (p.overlay).
struct Layout {
    int P, A, cap, slots, rays, stages;
    __device__ Layout(const Params& p, int R, bool shared) {
        P = p.rows_per_block;
        A = p.num_cars;
        cap = row_stage::field_capacity(p.num_segments);
        rays = p.num_cars * p.num_sensors;
        slots = ((rays + R - 1) / R) * R;
        stages = shared ? 1 : P;
    }
    __device__ float* stage(float* s, int q) const {
        return s + (stages == 1 ? 0 : q) * kFields * cap;
    }
    __device__ float* ray_table(float* s) const { return s + stages * kFields * cap; }
    __device__ float* cars(float* s) const { return ray_table(s) + P * slots * kRayFloats; }
    __device__ float* car_t(float* s) const {
        return cars(s) + P * car_hits::kFloatsPerCar * A;
    }
    __device__ float* run_a(float* s) const { return car_t(s) + P * rays * A; }
};

// Block b serves P = rows_per_block env rows: b*P + q, or (kShared) rows a row period
// apart, which share one staged row (Params::row_period).
template <int R, bool kCarGroups, bool kShared>
__global__ void __launch_bounds__(kMaxThreads) multi_observe_kernel(Params p) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t bars[kMaxRowsPerBlock];  // a row's copies
    __shared__ int extent[kMaxRowsPerBlock];     // each row's real extent E
    __shared__ int row_runs[kMaxRowsPerBlock];   // its runs that E leaves: ceil(E / L)
    __shared__ int field_at[kMaxRowsPerBlock * kFields];  // where each staged field starts
    const int A = p.num_cars;
    const int ns = p.num_sensors;
    const int S = p.num_segments;
    const int L = (S + 31) / 32;
    const Layout lay(p, R, kShared);
    const int rays = lay.rays;
    const int slots = lay.slots;
    const int groups = slots / R;
    size_t row0;  // the block's first env row
    int P;        // and its rows
    if constexpr (kShared) {
        const int T = p.row_period;
        const int blk = blockIdx.x;
        row0 = (size_t)(blk % T) + (size_t)(blk / T) * p.rows_per_block * T;
        P = min(p.rows_per_block, (p.rows - blk % T + T - 1) / T - (blk / T) * p.rows_per_block);
        if (P <= 0) return;  // the whole block: a residue with fewer rows
    } else {
        const int first = blockIdx.x * p.rows_per_block;
        P = min(p.rows_per_block, p.rows - first);
        row0 = first;
    }
    const int staged_rows = kShared ? 1 : P;
    auto row_of = [&](int q) { return kShared ? row0 + (size_t)q * p.row_period : row0 + q; };
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int obs_dim = ns + 4 * A;  // R + 4 + 4 (A - 1)
    // the work while the rows arrive goes to the block's last threads first, so that
    // warp 0, which issues the copies, takes it last
    const int back = blockDim.x - 1 - threadIdx.x;
    float* table = lay.ray_table(smem);
    float* car_base = lay.cars(smem);
    float* car_t = lay.car_t(smem);

    __shared__ int srcs[kMaxRowsPerBlock];  // the segment row each env row stages
    if (threadIdx.x < staged_rows) row_stage::init_barrier(&bars[threadIdx.x]);
    __syncthreads();
    if (warp == 0) {
        // lane q reads env row q's segment row, for the copies and for later phases
        const int lane_src = lane < P ? (int)row_stage::source_row(p.row_ids, row_of(lane)) : 0;
        if (lane < P) srcs[lane] = lane_src;
        if constexpr (kShared) {
            // one staged row for rows that must share it: other ids are a caller's error
            const int src0 = __shfl_sync(0xffffffffu, lane_src, 0);
            if (!__all_sync(0xffffffffu, lane >= P || lane_src == src0)) __trap();
        }
        for (int q = 0; q < staged_rows; ++q) {
            row_stage::stage_row(lay.stage(smem, q), p.seg, kFields,
                                 __shfl_sync(0xffffffffu, lane_src, q), S, lay.cap, &bars[q]);
        }
    }

    // while the rows arrive: the ray table, the cars, the kinematic and opponent columns
    for (int k = back; k < P * slots; k += blockDim.x) {
        const int q = k / slots;
        const int r = min(k - q * slots, rays - 1);  // the last ray repeated past the row
        const int a = r / ns;
        const size_t i = row_of(q) * A + a;
        const float ox = p.x[i], oy = p.y[i];
        const float world = p.angle[i] + p.rel[r - a * ns];
        const float dx = cosf(world);
        const float dy = sinf(world);
        float* t = table + k * kRayFloats;
        t[0] = ox;
        t[1] = oy;
        t[2] = dx;
        t[3] = dy;
        t[4] = ox * dy - oy * dx;
    }
    for (int k = back; k < (p.cars ? P * A : 0); k += blockDim.x) {
        const int q = k / A;
        const int a = k - q * A;
        const car_hits::Cars cars =
            car_hits::layout(car_base + q * car_hits::kFloatsPerCar * A, A);
        const size_t i = row_of(q) * A + a;
        float cx[4], cy[4];
        car_step::corners(p.x[i], p.y[i], p.angle[i], p.half_length, p.half_width, cx, cy);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            cars.sx[4 * a + e] = cx[e];
            cars.sy[4 * a + e] = cy[e];
            cars.vx[4 * a + e] = cx[(e + 1) & 3] - cx[e];
            cars.vy[4 * a + e] = cy[(e + 1) & 3] - cy[e];
        }
        cars.x[a] = p.x[i];
        cars.y[a] = p.y[i];
    }
    for (int k = back; k < P * A * A; k += blockDim.x) {
        const int q = k / (A * A);
        const int ij = k - q * A * A;
        const int i = ij / A;
        const int j = ij - i * A;
        const size_t row = row_of(q);
        const size_t ci = row * A + i;
        float* o = p.obs + ci * obs_dim + ns;
        const float ca = cosf(p.angle[ci]);
        const float sa = sinf(p.angle[ci]);
        if (i == j) {
            const float vx = p.vx[ci], vy = p.vy[ci];
            o[0] = clamp_unit((vx * ca + vy * sa) * p.inv_max_speed);
            o[1] = clamp_unit((-vx * sa + vy * ca) * p.inv_max_speed);
            o[2] = 0.0f;  // the reference's angular velocity, never written
            o[3] = p.last_steering[ci];
        } else {
            const size_t cj = row * A + j;
            const float rx = p.x[cj] - p.x[ci], ry = p.y[cj] - p.y[ci];
            const float rvx = p.vx[cj] - p.vx[ci], rvy = p.vy[cj] - p.vy[ci];
            const float td = p.max_track_distance[row];
            float* o4 = o + 4 + 4 * (j < i ? j : j - 1);
            o4[0] = clamp_unit(__fdiv_rn(rx * ca + ry * sa, td));
            o4[1] = clamp_unit(__fdiv_rn(-rx * sa + ry * ca, td));
            o4[2] = clamp_unit((rvx * ca + rvy * sa) * p.inv_max_speed);
            o4[3] = clamp_unit((-rvx * sa + rvy * ca) * p.inv_max_speed);
        }
    }

    __syncthreads();  // the ray table and the cars are in
    // the car pass, a thread a (ray, car), while the rows still arrive
    for (int k = back; k < (p.cars ? P * rays * A : 0); k += blockDim.x) {
        const int qr = k / A;
        const int b = k - qr * A;
        const int q = qr / rays;
        const float* t = table + (q * slots + (qr - q * rays)) * kRayFloats;
        const car_hits::Cars cars =
            car_hits::layout(car_base + q * car_hits::kFloatsPerCar * A, A);
        car_t[k] = run_fold::car_tmin(cars, b, t[0], t[1], t[2], t[3]);
    }
    for (int q = 0; q < staged_rows; ++q) row_stage::wait_barrier(&bars[q]);
    __syncthreads();  // the rows (with their thread-copied parts) and the car pass are in
    // split: staged
    for (int k = threadIdx.x; k < P * kFields; k += blockDim.x) {
        const int q = k / kFields;
        const int f = k - q * kFields;
        const float* field = row_stage::staged(lay.stage(smem, q) + f * lay.cap, p.seg[f],
                                               srcs[q], S);
        field_at[k] = (int)(field - smem);
    }
    if (warp < P) {
        const size_t src = srcs[warp];
        const float* stage = lay.stage(smem, warp);
        const float* vx_row = row_stage::staged(stage + 2 * lay.cap, p.seg[2], src, S);
        const float* vy_row = row_stage::staged(stage + 3 * lay.cap, p.seg[3], src, S);
        const int e = run_fold::real_extent(vx_row, vy_row, S, lane);
        if (lane == 0) {
            extent[warp] = e;
            row_runs[warp] = (e + L - 1) / L;
        }
    }
    __syncthreads();

    // the items of the group's rows: (row q, run j, group g), g fastest, run j of
    // row q only where j * L < extent[q]
    // (with p.overlay a thread folds one item at most, and its results replace the
    // rows once every fold is done)
    int items = 0;
    for (int q = 0; q < P; ++q) items += row_runs[q] * groups;
    float* res_a = p.overlay ? smem : lay.run_a(smem);
    float* res_d = res_a + P * slots * run_fold::kRunStride;
    float pa[R], pd[R];
    int base = -1;
    auto store_runs = [&](int at) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
            res_a[at + s * run_fold::kRunStride] = pa[s];
            res_d[at + s * run_fold::kRunStride] = pd[s];
        }
    };
    for (int k = threadIdx.x; k < items; k += blockDim.x) {
        int q = 0, i = k;
        while (i >= row_runs[q] * groups) i -= row_runs[q++] * groups;
        const int j = i / groups;
        const int gr = i - j * groups;
        const float* t = table + (q * slots + gr * R) * kRayFloats;
        float rox[R], roy[R], rdx[R], rdy[R], u[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
            rox[s] = t[s * kRayFloats];
            roy[s] = t[s * kRayFloats + 1];
            rdx[s] = t[s * kRayFloats + 2];
            rdy[s] = t[s * kRayFloats + 3];
            u[s] = t[s * kRayFloats + 4];
        }
        const int* at = field_at + q * kFields;
        const int begin = j * L;
        const int end = min(begin + L, extent[q]);
        run_fold::fold_run<R, kCarGroups>(smem + at[0], smem + at[1], smem + at[2],
                                          smem + at[3], smem + at[4], begin, end, rox, roy,
                                          rdx, rdy, u, pa, pd);
        base = (q * slots + gr * R) * run_fold::kRunStride + j;
        if (!p.overlay) store_runs(base);
    }
    if (p.overlay) {
        __syncthreads();  // every fold has read the rows: the results take their place
        if (base >= 0) store_runs(base);
    }
    __syncthreads();  // every run's result is in
    // split: folded

    // a thread a ray: its wall winner over the runs, its cars' minimum, the column
    for (int k = threadIdx.x; k < P * rays; k += blockDim.x) {
        const int q = k / rays;
        const int r = k - q * rays;
        const int at = (q * slots + r) * run_fold::kRunStride;
        float wa, wd;
        run_fold::combine_runs(res_a + at, res_d + at, row_runs[q], wa, wd);
        const float w = wall_fold::distance(wa, wd, p.max_dist);
        // split: walls
        float d = w;
        if (p.cars) {
            const float car = run_fold::cars_nearest(car_t + k * A, A, p.max_dist);
            // torch.minimum(wall, car) on the card: the first NaN, else fminf
            d = w != w ? w : (car != car ? car : fminf(w, car));
        }
        // torch.clamp_max(d, range) keeps a NaN; then div_const(d, range)
        if (p.clamp_range) d = d > p.max_dist ? p.max_dist : d;
        const int a = r / ns;
        p.obs[(row_of(q) * A + a) * obs_dim + (r - a * ns)] = d * p.inv_range;
    }
}

// whether each group of R rays (the last ray repeated past the row's) is one car's
// rays alone (ops/_cuda.py:groups_are_cars)
bool groups_are_cars(int num_cars, int num_sensors, int R) {
    const int rays = num_cars * num_sensors;
    for (int g = 0; g < rays; g += R) {
        if (g / num_sensors != (min(g + R, rays) - 1) / num_sensors) return false;
    }
    return true;
}

template <int R>
int launch(const Params& p, int per_car, int threads, int smem, cudaStream_t stream) {
    // a shared staged row only for one car's rays a row (the single-car env)
    auto kernel = p.row_period ? multi_observe_kernel<R, true, true>
                               : per_car ? multi_observe_kernel<R, true, false>
                                         : multi_observe_kernel<R, false, false>;
    // the dynamic shared memory and the static (under 1 KB) over the default 48 KB
    cudaError_t err = cudaSuccess;
    if (smem + 1024 > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err != cudaSuccess) return (int)err;
    const int T = p.row_period;
    const int per_residue = T ? (p.rows + T - 1) / T : p.rows;
    const int blocks = (T ? T : 1) * ((per_residue + p.rows_per_block - 1) / p.rows_per_block);
    kernel<<<blocks, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// The multi-car env's observation: rows env rows of num_cars cars; the poses x, y,
// angle, the velocities vx, vy and last_steering [rows * num_cars],
// max_track_distance [rows], sensor angles rel [num_sensors], obs [rows * num_cars *
// (num_sensors + 4 * num_cars)]; env row i sees segment row row_ids[i] (row i where
// row_ids is null), row j of the segment fields being [j*S, (j+1)*S), seg_c = vy*sx
// - vx*sy among them. inv_range and inv_max_speed are the float32 reciprocals of
// max_dist and the car's max_speed; clamp_range != 0 clamps each ray to max_dist
// first. One block of `threads` threads a `rows_per_block` rows, `smem` bytes of
// dynamic shared memory, `rays_per_lane` rays an item, each group one car's rays
// where per_car != 0, the run results over the staged rows where overlay != 0 (the
// plan has made sure that a thread folds one item at most and that they fit): the
// launch plan, ops/_cuda.py:multi_observe_plan. cars == 0 leaves out the car pass and
// the minimum, so that each ray is its wall hit alone, unclamped unless clamp_range
// says so: the single-car env's observation (envs/single.py:observe), at one car a
// row, whose rays see no car, launched as ops/_cuda.py:single_observe_plan says (a
// row's rays in several groups, each one car's). row_period T > 0 gives a block env
// rows T apart, which must read one segment row (the tiled layout, env i reading row
// i % T): it is staged once (the launch traps otherwise). Returns a cudaError_t (0 on success).
extern "C" int multi_observe_f32(
        const float* x, const float* y, const float* angle, const float* vx,
        const float* vy, const float* last_steering, const float* max_track_distance,
        const float* rel, const float* seg_sx, const float* seg_sy, const float* seg_vx,
        const float* seg_vy, const float* seg_c, const int* row_ids, float* obs,
        int rows, int num_cars, int num_sensors, int num_segments,
        float half_length, float half_width, float max_dist, float inv_range,
        float inv_max_speed, int clamp_range, int threads, int smem, int rays_per_lane,
        int per_car, int rows_per_block, int overlay, int cars, int row_period, int device,
        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || num_cars == 0 || num_sensors == 0) return 0;
    if (threads % 32 != 0 || threads > kMaxThreads || num_segments < 1 || num_cars < 0
            || num_sensors < 0 || rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock
            || threads < 32 * rows_per_block || seg_c == nullptr || vx == nullptr
            || vy == nullptr || last_steering == nullptr || max_track_distance == nullptr
            || (per_car && !groups_are_cars(num_cars, num_sensors, rays_per_lane))
            || row_period < 0 || (row_period > 0 && !per_car))
        return (int)cudaErrorInvalidValue;
    const Params p{x, y, angle, vx, vy, last_steering, max_track_distance, rel,
                   {seg_sx, seg_sy, seg_vx, seg_vy, seg_c}, row_ids, obs, rows, num_cars,
                   num_sensors, num_segments, rows_per_block, overlay, half_length,
                   half_width, max_dist, inv_range, inv_max_speed, clamp_range, cars,
                   row_period};
    const auto st = (cudaStream_t)stream;
    switch (rays_per_lane) {
        case 1: return launch<1>(p, per_car, threads, smem, st);
        case 2: return launch<2>(p, per_car, threads, smem, st);
        case 3: return launch<3>(p, per_car, threads, smem, st);
        case 4: return launch<4>(p, per_car, threads, smem, st);
        case 6: return launch<6>(p, per_car, threads, smem, st);
        case 8: return launch<8>(p, per_car, threads, smem, st);
        case 11: return launch<11>(p, per_car, threads, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* multi_observe_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
