// K3: nearest hit of each ray against the edges of the cars of its row, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX package's car raycast, self_play_racing_tpu/ops/geometry.py
// (raycast_cars), which XLA fuses on the TPU. The semantics and the per-ray edge
// loop are in car_hits.cuh. The multi-car env does not launch this kernel: it runs
// the same loop as the car pass of raycast_walls_and_cars.cu. It stays as the
// counterpart of the JAX function.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play path's shapes
// (4096 env rows x 2 cars x 11 rays, against the 2 cars of the row) the kernel must
// read the ray origins and directions (1.4 MB), the corners and centres (0.3 MB)
// and write 0.4 MB: about 0.6 us. The arithmetic (8 edges x ~25 operations per
// ray) is about 0.3 us. It is bound by bytes, and at this size by its launch.
//
// Design: one block per env row, one thread per ray of the row. The block stages
// the row's A cars (corners, edge vectors and centres, 18 floats a car) in shared
// memory once; every ray of the row reads them from there. Compiled with
// -fmad=false, and with __fdiv_rn/__fsqrt_rn, so every operation rounds as
// PyTorch's eager ops round it.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "car_hits.cuh"

namespace {

__global__ void raycast_cars_kernel(
        const float* __restrict__ ox, const float* __restrict__ oy,
        const float* __restrict__ dx, const float* __restrict__ dy,
        const float* __restrict__ car_cx, const float* __restrict__ car_cy,
        const float* __restrict__ car_x, const float* __restrict__ car_y,
        float* __restrict__ out, int rays_per_row, int num_cars, float max_dist) {
    extern __shared__ float smem[];
    const int E = 4 * num_cars;  // edges of the row
    const car_hits::Cars cars = car_hits::layout(smem, num_cars);

    const size_t row = blockIdx.x;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        const size_t c = row * (size_t)E + e;
        const size_t next = row * (size_t)E + (e & ~3) + ((e + 1) & 3);
        const float sx = car_cx[c];
        const float sy = car_cy[c];
        cars.sx[e] = sx;
        cars.sy[e] = sy;
        cars.vx[e] = car_cx[next] - sx;
        cars.vy[e] = car_cy[next] - sy;
    }
    for (int a = threadIdx.x; a < num_cars; a += blockDim.x) {
        cars.x[a] = car_x[row * (size_t)num_cars + a];
        cars.y[a] = car_y[row * (size_t)num_cars + a];
    }
    __syncthreads();

    const int ray = blockIdx.y * blockDim.x + threadIdx.x;
    if (ray >= rays_per_row) return;
    const size_t r = row * (size_t)rays_per_row + ray;
    out[r] = car_hits::nearest(cars, ox[r], oy[r], dx[r], dy[r], max_dist);
}

}  // namespace

// rows x rays_per_row rays (ox, oy, dx, dy, out); row i's cars are corners
// car_cx, car_cy [i, num_cars, 4] and centres car_x, car_y [i, num_cars].
// Returns a cudaError_t (0 on success).
extern "C" int raycast_cars_f32(
        const float* ox, const float* oy, const float* dx, const float* dy,
        const float* car_cx, const float* car_cy, const float* car_x,
        const float* car_y, float* out, int rows, int rays_per_row, int num_cars,
        float max_dist, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || rays_per_row == 0) return 0;
    if (num_cars < 1) return (int)cudaErrorInvalidValue;
    int threads = ((rays_per_row + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const dim3 grid(rows, (rays_per_row + threads - 1) / threads);
    const size_t smem = car_hits::kFloatsPerCar * (size_t)num_cars * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(raycast_cars_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    raycast_cars_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, out, rays_per_row, num_cars,
        max_dist);
    return (int)cudaGetLastError();
}

extern "C" const char* raycast_cars_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
