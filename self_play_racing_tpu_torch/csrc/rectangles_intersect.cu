// K4: separating-axis test between every pair of cars of a row, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the JAX package's rectangle SAT test, self_play_racing_tpu/ops/geometry.py
// (rectangles_intersect), which the multi-car env calls over all [envs, A, A]
// pairs and XLA fuses on the TPU. Same semantics for the pair (a, b):
//   - axes: the normals (-ey, ex) of a's edges 0->1 and 1->2, then b's;
//   - each car's 4 corners projected on each axis as axx*x + axy*y (two products
//     and a sum, unfused);
//   - a gap on an axis is max(pa) < min(pb) or max(pb) < min(pa), strictly;
//   - the cars intersect when no axis has a gap.
// Output pairs[p, a, b] as 0/1 bytes, the diagonal included (a car against itself
// intersects); the env masks it. The test's semantics: rect_sat.cuh.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play path's shapes
// (4096 env rows x 2 x 2 pairs) it reads 0.26 MB of corners and writes 16 KB: under
// 0.1 us, and the 4 axes x 34 operations per pair are less still. It is bound by
// its launch.
//
// Design: one thread per (row, a, b) pair; the corners are read from global
// memory (each is read by 2A threads, which L1 serves). The test itself is
// rect_sat.cuh, which the envs' transition kernel (car_step_and_query.cu) runs on
// the corners it forms; the env's path launches that kernel and not this one.
#include <cuda_runtime.h>

#include "rect_sat.cuh"

namespace {

__global__ void rectangles_intersect_kernel(
        const float* __restrict__ cx, const float* __restrict__ cy,
        unsigned char* __restrict__ pairs, size_t num_pairs, int num_cars) {
    const size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (k >= num_pairs) return;
    const size_t A = num_cars;
    const size_t row = k / (A * A);
    const size_t a = (k / A) % A;
    const size_t b = k % A;
    const rect_sat::Rect ra = rect_sat::load_rect(cx, cy, (row * A + a) * 4);
    const rect_sat::Rect rb = rect_sat::load_rect(cx, cy, (row * A + b) * 4);
    pairs[k] = rect_sat::intersect(ra, rb) ? 1 : 0;
}

}  // namespace

// rows x num_cars cars with corners cx, cy [rows, num_cars, 4]; pairs [rows,
// num_cars, num_cars] bytes (0/1). Returns a cudaError_t (0 on success).
extern "C" int rectangles_intersect_u8(
        const float* cx, const float* cy, unsigned char* pairs, int rows,
        int num_cars, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t num_pairs = (size_t)rows * num_cars * num_cars;
    if (num_pairs == 0) return 0;
    const int threads = 256;
    const size_t blocks = (num_pairs + threads - 1) / threads;
    rectangles_intersect_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(cx, cy, pairs, num_pairs,
                                                          num_cars);
    return (int)cudaGetLastError();
}

extern "C" const char* rectangles_intersect_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
