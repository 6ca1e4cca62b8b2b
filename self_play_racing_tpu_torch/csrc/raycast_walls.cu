// K1: nearest wall hit per ray, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's raycast reduction, self_play_racing_tpu/ops/geometry.py
// (raycast_walls + _ratio_min_reducer), which XLA fuses on the TPU. The semantics
// and the per-ray fold (a run of segments a lane, then a shuffle tree) are in
// wall_fold.cuh; the multi-car env runs the same fold in raycast_walls_and_cars.cu.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the single-car path's
// shapes (4096 env rows x 11 rays x 896 padded segments, five f32 segment fields per
// row) the kernel must read 5 x 896 x 4 B x 4096 = 73 MB, about 22 us, against
// 26 f32 operations per ray-segment pair (1.05 GFLOP), about 16 us; the self-play
// path casts 22 rays per row against the same rows: 2.10 GFLOP, about 31 us, bound
// by operations. Tensor cores cannot take the work: each pair is ~15 products and
// sums rounded one by one (built with -fmad=false, so that K1 rounds as PyTorch's
// eager ops round), and TF32 wgmma would round the inputs and fuse the sums, which
// breaks bitwise agreement with the plain version. So the floor is the CUDA cores'
// issue rate: the fold's inner loop is 261 instructions a step of 11 rays, 23.7 a
// pair (10 FMUL, 5 FADD, 5 FSETP, 2 FSEL a pair, then the step's 5 loads and loop
// counters shared by the 11 rays; cuobjdump -sass).
//
// Design:
//   - one block per row (grid = rows). Its fields are staged once by bulk copies
//     (row_stage.cuh), and every ray of the row (22 on the self-play path) is
//     folded from that one staging; the rays travel into registers while the row
//     arrives;
//   - each lane keeps R rays (origin, direction, u and the running (pa, pd)) in
//     registers, so each segment read from shared memory serves R rays; a warp
//     takes R rays of the row at a time; the fold has no branch;
//   - lane j reads word j*L + k of the staged row at step k: gcd(L, 32) lanes
//     share a bank (4 at S = 896, 32 at S = 1024), and the R rays share each
//     read, so the conflict costs little. A lane-major copy of the row (the
//     transpose that removes the conflict) doubles a block's shared memory and
//     measured slower at S = 896 and at S = 1024 (PERF.md, Findings);
//   - with row ids (the capacity layouts, envs/track.py) block b stages pool row
//     row_ids[b] instead of row b: many blocks read the same few rows, which the
//     L2 then serves; a null pointer is row b, the gathered layout's code path;
//   - at S = 896 a block needs 18 KB, so an SM holds 12 rows at once. The
//     kernel's time follows the warps an SM holds more than anything else, so a
//     block keeps one buffer: the other blocks of the SM overlap each block's
//     copy. Persistent blocks that walk rows, with one buffer or with a second
//     that prefetches the next row, measured slower (PERF.md, Findings).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_stage.cuh"
#include "wall_fold.cuh"

namespace {

constexpr int kFields = wall_fold::kFields;
constexpr int kMaxThreads = 256;

// a warp folds R rays of the row at a time (wall_fold::fold)
template <int R>
__global__ void __launch_bounds__(kMaxThreads) raycast_walls_kernel(
        const float* __restrict__ ox, const float* __restrict__ oy,
        const float* __restrict__ dx, const float* __restrict__ dy,
        const float* __restrict__ seg_sx, const float* __restrict__ seg_sy,
        const float* __restrict__ seg_vx, const float* __restrict__ seg_vy,
        const float* __restrict__ seg_c, const int* __restrict__ row_ids,
        float* __restrict__ out, int rays_per_row, int num_segments, float max_dist) {
    extern __shared__ __align__(16) float stage[];
    __shared__ uint64_t bar;
    const int S = num_segments;
    const int L = (S + 31) / 32;
    const int cap = row_stage::field_capacity(32 * L);  // room for the padding past S
    const size_t row = blockIdx.x;
    const size_t src = row_stage::source_row(row_ids, row);  // the segment row staged
    const float* fields[kFields] = {seg_sx, seg_sy, seg_vx, seg_vy, seg_c};
    const bool with_c = seg_c != nullptr;
    const int num_fields = with_c ? 5 : 4;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int groups = (rays_per_row + R - 1) / R;

    if (threadIdx.x == 0) row_stage::init_barrier(&bar);
    __syncthreads();
    if (warp == 0) row_stage::stage_row(stage, fields, num_fields, src, S, cap, &bar);

    float rox[R], roy[R], rdx[R], rdy[R], u[R];
    auto load_rays = [&](int g) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const size_t r = row * rays_per_row + min(g * R + t, rays_per_row - 1);
            rox[t] = ox[r];
            roy[t] = oy[r];
            rdx[t] = dx[r];
            rdy[t] = dy[r];
            u[t] = rox[t] * rdy[t] - roy[t] * rdx[t];
        }
    };
    if (warp < groups) load_rays(warp);  // in flight while the row arrives

    row_stage::wait_barrier(&bar);
    const float* rs[kFields];
    wall_fold::staged_fields(stage, fields, num_fields, src, S, L, cap, rs);
    __syncthreads();  // the row, its thread-copied parts and its padding are in

    for (int g = warp; g < groups; g += warps) {
        if (g != warp) load_rays(g);
        float pa[R], pd[R];
        wall_fold::fold<R>(rs[0], rs[1], rs[2], rs[3], rs[4], with_c, L, lane, rox, roy, rdx,
                           rdy, u, pa, pd);
        if (lane == 0) {
#pragma unroll
            for (int t = 0; t < R; ++t) {
                if (g * R + t < rays_per_row) {
                    out[row * rays_per_row + g * R + t] =
                        wall_fold::distance(pa[t], pd[t], max_dist);
                }
            }
        }
    }
}

template <int R>
int launch(const float* ox, const float* oy, const float* dx, const float* dy,
           const float* sx, const float* sy, const float* vx, const float* vy,
           const float* c, const int* row_ids, float* out, int rows, int rays_per_row,
           int num_segments, float max_dist, int threads, int smem, cudaStream_t stream) {
    auto kernel = raycast_walls_kernel<R>;
    const cudaError_t err = row_stage::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, threads, smem, stream>>>(ox, oy, dx, dy, sx, sy, vx, vy, c, row_ids,
                                            out, rays_per_row, num_segments, max_dist);
    return (int)cudaGetLastError();
}

}  // namespace

// rows x rays_per_row rays; row i of the segment fields is [i*S, (i+1)*S), and ray
// row i sees segment row row_ids[i] (row i where row_ids is null; the ids lie in
// the fields' rows, as the caller checked once when it built them).
// seg_c may be null: the kernel then forms c = vy*sx - vx*sy itself. One block of
// `threads` threads per row, `smem` bytes of dynamic shared memory for the staged
// row and `rays_per_lane` rays a lane: the launch plan,
// ops/_cuda.py:raycast_walls_plan. Returns a cudaError_t (0 on success).
extern "C" int raycast_walls_f32(
        const float* ox, const float* oy, const float* dx, const float* dy,
        const float* seg_sx, const float* seg_sy, const float* seg_vx,
        const float* seg_vy, const float* seg_c, const int* row_ids, float* out,
        int rows, int rays_per_row, int num_segments, float max_dist,
        int threads, int smem, int rays_per_lane, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || rays_per_row == 0) return 0;
    if (threads % 32 != 0 || threads > kMaxThreads || num_segments < 1)
        return (int)cudaErrorInvalidValue;
    const auto st = (cudaStream_t)stream;
#define K1_LAUNCH(R) \
    case R: return launch<R>(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, seg_c, row_ids, out, \
                             rows, rays_per_row, num_segments, max_dist, threads, smem, st)
    switch (rays_per_lane) {
        K1_LAUNCH(1);
        K1_LAUNCH(2);
        K1_LAUNCH(3);
        K1_LAUNCH(4);
        K1_LAUNCH(6);
        K1_LAUNCH(8);
        K1_LAUNCH(11);
        default: return (int)cudaErrorInvalidValue;
    }
#undef K1_LAUNCH
}

extern "C" const char* raycast_walls_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
