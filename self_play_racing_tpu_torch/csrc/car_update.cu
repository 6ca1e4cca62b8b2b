// K5: one kinematic dynamics step per car, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's car dynamics, self_play_racing_tpu/ops/dynamics.py
// (car_update), elementwise work that XLA fuses on the TPU. The semantics and the
// per-car step are in car_step.cuh. The envs do not launch this kernel: they run
// the same step inside the track query's block (car_step_and_query.cu). It stays as
// the counterpart of the JAX function.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play path's shapes
// (4096 x 2 cars) it reads 7 f32 fields and a bool and writes 5 f32 fields, 0.39 MB:
// about 0.1 us, against ~40 operations and two transcendentals per car. It is bound
// by its launch; what it saves is the ~40 elementwise launches of the plain version.
//
// Design: one thread per car, every intermediate in registers. Compiled with
// -fmad=false so every product and sum rounds as PyTorch's eager ops round them.
#include <cuda_runtime.h>

#include "car_step.cuh"

namespace {

__global__ void car_update_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ angle, const float* __restrict__ vx,
        const float* __restrict__ vy, const unsigned char* __restrict__ crashed,
        const float* __restrict__ steering, const float* __restrict__ throttle,
        float* __restrict__ nx, float* __restrict__ ny, float* __restrict__ nang,
        float* __restrict__ nvx, float* __restrict__ nvy, size_t n, car_step::Spec k) {
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const car_step::Car c = car_step::step({x[i], y[i], angle[i], vx[i], vy[i]},
                                           crashed[i], steering[i], throttle[i], k);
    nx[i] = c.x;
    ny[i] = c.y;
    nang[i] = c.angle;
    nvx[i] = c.vx;
    nvy[i] = c.vy;
}

}  // namespace

// n cars, every field [n] (crashed as 0/1 bytes); the constants are rounded to
// float32 by the caller. Returns a cudaError_t (0 on success).
extern "C" int car_update_f32(
        const float* x, const float* y, const float* angle, const float* vx,
        const float* vy, const unsigned char* crashed, const float* steering,
        const float* throttle, float* nx, float* ny, float* nang, float* nvx,
        float* nvy, int n, float steering_speed, float acceleration, float drag,
        float lateral_friction, float grip, float max_speed, float dt, float two_pi,
        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return 0;
    const car_step::Spec k{steering_speed, acceleration, drag, lateral_friction, grip,
                           max_speed, dt, two_pi};
    const int threads = 256;
    car_update_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        x, y, angle, vx, vy, crashed, steering, throttle, nx, ny, nang, nvx, nvy,
        (size_t)n, k);
    return (int)cudaGetLastError();
}

extern "C" const char* car_update_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
