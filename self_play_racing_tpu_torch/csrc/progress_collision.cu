// K2: track progress and corner collision per car, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's fused track query,
// self_play_racing_tpu/ops/geometry.py (progress_and_collision), which XLA fuses on
// the TPU. The search and projection are in track_query.cuh; then
//   progress = idx(centre) / n_wp   (one IEEE divide),
//   crashed  = any corner with |projection| > track_width.
// The corners come in as inputs (computed with cos/sin outside), so the kernel is
// free of transcendentals and rounds exactly as the plain PyTorch version. The
// envs do not launch this kernel: they run the same search after the car's step,
// in car_step_and_query.cu. It stays as the counterpart of the JAX function.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the main path's shapes
// (4096 waypoint rows x 512 padded waypoints, 1 or 2 cars of 5 queries per row)
// the search reads the two position fields of every row, 2 x 512 x 4 B x 4096 =
// 17 MB, and of the normals only the two at each corner's winner; about 5 us of
// bytes, against 11 operations per query-waypoint pair (0.12 GFLOP a car per
// row), about 2 us. It is bound by bytes, so a row must cross from device memory
// once and enough rows must be in flight to cover the memory's latency.
//
// Design: one block per waypoint row (grid = rows), and every car of the row is
// served from one staging of the row's positions, made by bulk asynchronous
// copies (row_stage.cuh). A block needs 4 KB, so an SM holds 32 rows at once, the
// most blocks it takes, and their copies overlap each other's searches. One warp
// per car keeps its queries (centre + corners, up to kQueries at a time) in
// registers (track_query.cuh). Compiled with -fmad=false so products and sums
// round as PyTorch's.
#include <cuda_runtime.h>

#include "row_stage.cuh"
#include "track_query.cuh"

namespace {

constexpr int kFields = 2;   // the staged fields: wp_x, wp_y
constexpr int kQueries = track_query::kQueries;
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads) progress_and_collision_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ cx, const float* __restrict__ cy,
        const float* __restrict__ wp_x, const float* __restrict__ wp_y,
        const float* __restrict__ nrm_x, const float* __restrict__ nrm_y,
        const int* __restrict__ n_wp, const float* __restrict__ track_width,
        float* __restrict__ progress, unsigned char* __restrict__ crashed,
        int cars_per_row, int num_corners, int num_waypoints) {
    extern __shared__ __align__(16) float stage[];
    __shared__ uint64_t bar;
    const int W = num_waypoints;
    const int cap = row_stage::field_capacity(W);
    const size_t row = blockIdx.x;
    const float* fields[kFields] = {wp_x, wp_y};

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    if (threadIdx.x == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    if (warp == 0) row_stage::stage_row(stage, fields, kFields, row, W, cap, &bar);

    const int queries = 1 + num_corners;
    float qx[kQueries], qy[kQueries], width = 0.0f;
    int count = 1;
    // a warp's queries q0 .. q0 + kQueries - 1 of a car (the last repeated past the
    // end), with the car's waypoint count and track width
    auto load_queries = [&](size_t car, int q0) {
#pragma unroll
        for (int t = 0; t < kQueries; ++t) {
            const int q = min(q0 + t, queries - 1);  // 0 = centre, 1.. = corners
            qx[t] = q == 0 ? x[car] : cx[car * num_corners + q - 1];
            qy[t] = q == 0 ? y[car] : cy[car * num_corners + q - 1];
        }
        count = n_wp[car];
        width = track_width[car];
    };
    // the first car's queries travel while the row is still arriving
    if (warp < cars_per_row) load_queries(row * cars_per_row + warp, 0);
    row_stage::wait_barrier(&bar);
    __syncthreads();  // the row (and its thread-copied parts) is in
    const float* s_wx = row_stage::staged(stage, wp_x, row, W);
    const float* s_wy = row_stage::staged(stage + cap, wp_y, row, W);
    const float* row_nx = nrm_x + row * W;
    const float* row_ny = nrm_y + row * W;

    for (int a = warp; a < cars_per_row; a += warps) {
        const size_t car = row * cars_per_row + a;
        bool hit_wall = false;
        for (int q0 = 0; q0 < queries; q0 += kQueries) {
            if (a != warp || q0 != 0) load_queries(car, q0);
            int best0;
            hit_wall |= track_query::search(s_wx, s_wy, row_nx, row_ny, W, lane, qx, qy, q0,
                                            queries, width, best0);
            if (q0 == 0 && lane == 0) {
                progress[car] = __fdiv_rn((float)best0, (float)count);
            }
        }
        if (lane == 0) crashed[car] = (unsigned char)hit_wall;
    }
}

}  // namespace

// rows waypoint rows of cars_per_row cars each; centres x, y [rows * cars_per_row];
// corners cx, cy [rows * cars_per_row, num_corners]; waypoint fields [rows,
// num_waypoints]; n_wp, track_width [rows * cars_per_row]; progress f32 and crashed
// bytes (0/1) [rows * cars_per_row]. One block of `threads` threads per row and
// `smem` bytes of dynamic shared memory for the staged row: the launch plan,
// ops/_cuda.py:progress_collision_plan. Returns a cudaError_t (0 on success).
extern "C" int progress_and_collision_f32(
        const float* x, const float* y, const float* cx, const float* cy,
        const float* wp_x, const float* wp_y, const float* nrm_x,
        const float* nrm_y, const int* n_wp, const float* track_width,
        float* progress, unsigned char* crashed,
        int rows, int cars_per_row, int num_corners, int num_waypoints,
        int threads, int smem, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || cars_per_row == 0) return 0;
    if (cars_per_row < 0 || num_corners < 0 || num_waypoints < 1
            || threads % 32 != 0 || threads > kMaxThreads)
        return (int)cudaErrorInvalidValue;
    err = row_stage::allow_smem(progress_and_collision_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    progress_and_collision_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
        x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width, progress, crashed,
        cars_per_row, num_corners, num_waypoints);
    return (int)cudaGetLastError();
}

extern "C" const char* progress_collision_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
