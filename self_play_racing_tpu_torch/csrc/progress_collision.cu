// K2: track progress and corner collision per car, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's fused track query,
// self_play_racing_tpu/ops/geometry.py (progress_and_collision), which XLA fuses on
// the TPU. Same semantics: for the car centre and each corner, the first-index
// argmin of d^2 over the row's waypoints (strict less; ties go to the lower index),
// carrying the projection of (query - waypoint) on that waypoint's normal; then
//   progress = idx(centre) / n_wp   (one IEEE divide),
//   crashed  = any corner with |projection| > track_width.
// Padding waypoints sit at 1e8 and never win: d^2 ~ 2e16 stays finite in f32.
// The corners come in as inputs (computed with cos/sin outside), so the kernel is
// free of transcendentals and rounds exactly as the plain PyTorch version.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the main path's shapes
// (4096 cars x 5 queries x 512 padded waypoints, four f32 waypoint fields per row)
// the kernel must read 4 x 512 x 4 B x 4096 = 34 MB, about 10 us, against about
// 0.12 GFLOP (11 operations per query-waypoint pair), about 2 us. It is
// memory-bound.
//
// Design: one block per car, one warp per query (centre + corners). The block
// stages its row's four waypoint fields in shared memory once and its queries
// share them, so device memory is read once per car. Lanes take waypoints
// lane, lane+32, ... in index order; the warp then reduces on the pair (d^2, idx),
// a total order, so the shuffle tree gives the exact first-index argmin whatever
// its shape. Compiled with -fmad=false so products and sums round as PyTorch's.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void progress_and_collision_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ cx, const float* __restrict__ cy,
        const float* __restrict__ wp_x, const float* __restrict__ wp_y,
        const float* __restrict__ nrm_x, const float* __restrict__ nrm_y,
        const int* __restrict__ n_wp, const float* __restrict__ track_width,
        float* __restrict__ progress, unsigned char* __restrict__ crashed,
        int num_corners, int num_waypoints) {
    extern __shared__ float smem[];
    __shared__ int s_crashed;
    const int W = num_waypoints;
    float* s_wx = smem;
    float* s_wy = smem + W;
    float* s_nx = smem + 2 * W;
    float* s_ny = smem + 3 * W;

    const size_t row = blockIdx.x;
    const size_t base = row * (size_t)W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        s_wx[i] = wp_x[base + i];
        s_wy[i] = wp_y[base + i];
        s_nx[i] = nrm_x[base + i];
        s_ny[i] = nrm_y[base + i];
    }
    if (threadIdx.x == 0) s_crashed = 0;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int q = threadIdx.x >> 5;  // 0 = centre, 1.. = corners
    const float qx = q == 0 ? x[row] : cx[row * num_corners + q - 1];
    const float qy = q == 0 ? y[row] : cy[row * num_corners + q - 1];

    float best_d2 = CUDART_INF_F;
    int best_i = INT_MAX;
    float best_p = 0.0f;
    for (int w = lane; w < W; w += 32) {
        const float ddx = qx - s_wx[w];
        const float ddy = qy - s_wy[w];
        const float d2 = ddx * ddx + ddy * ddy;
        if (d2 < best_d2) {
            best_d2 = d2;
            best_i = w;
            best_p = ddx * s_nx[w] + ddy * s_ny[w];
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_down_sync(0xffffffffu, best_d2, o);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
        const float op = __shfl_down_sync(0xffffffffu, best_p, o);
        if (od < best_d2 || (od == best_d2 && oi < best_i)) {
            best_d2 = od;
            best_i = oi;
            best_p = op;
        }
    }
    if (lane == 0) {
        if (q == 0) {
            progress[row] = __fdiv_rn((float)best_i, (float)n_wp[row]);
        } else if (fabsf(best_p) > track_width[row]) {
            atomicOr(&s_crashed, 1);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) crashed[row] = (unsigned char)s_crashed;
}

}  // namespace

// rows cars; centres x, y [rows]; corners cx, cy [rows, num_corners]; waypoint
// fields [rows, num_waypoints]; n_wp, track_width [rows]; progress [rows] f32,
// crashed [rows] bytes (0/1). Returns a cudaError_t (0 on success).
extern "C" int progress_and_collision_f32(
        const float* x, const float* y, const float* cx, const float* cy,
        const float* wp_x, const float* wp_y, const float* nrm_x,
        const float* nrm_y, const int* n_wp, const float* track_width,
        float* progress, unsigned char* crashed,
        int rows, int num_corners, int num_waypoints, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0) return 0;
    const size_t smem = 4 * (size_t)num_waypoints * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(progress_and_collision_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    progress_and_collision_kernel<<<rows, 32 * (1 + num_corners), smem,
                                    (cudaStream_t)stream>>>(
        x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width, progress,
        crashed, num_corners, num_waypoints);
    return (int)cudaGetLastError();
}

extern "C" const char* progress_collision_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
