// K5: one kinematic dynamics step per car, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's car dynamics, self_play_racing_tpu/ops/dynamics.py
// (car_update), elementwise work that XLA fuses on the TPU. Same semantics, in the
// reference's operation order:
//   ang   = mod(angle + (steering * steering_speed) * dt, 2*pi)   (fmod, then the
//           divisor's sign, as torch.remainder and jnp.mod compute it)
//   v_fwd = ((vx*cos + vy*sin) + (throttle * acceleration) * dt) * drag
//   v_lat = ((vx*(-sin) + vy*cos) * lateral_friction) * grip
//   v     = (v_fwd*cos - v_lat*sin, v_fwd*sin + v_lat*cos), rescaled by
//           max_speed / |v| (one IEEE division) when |v| > max_speed strictly
//   x, y  += v * dt
// A crashed car keeps its old x, y, angle, vx, vy. The constants arrive rounded to
// float32, as PyTorch rounds a Python scalar against a float32 tensor; cosf/sinf
// (without fast math) are what PyTorch's CUDA cos/sin call, and sqrt and the
// division round as IEEE (__fsqrt_rn, __fdiv_rn).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the self-play path's shapes
// (4096 x 2 cars) it reads 7 f32 fields and a bool and writes 5 f32 fields, 0.39 MB:
// about 0.1 us, against ~40 operations and two transcendentals per car. It is bound
// by its launch; what it saves is the ~40 elementwise launches of the plain version.
//
// Design: one thread per car, every intermediate in registers. Compiled with
// -fmad=false so every product and sum rounds as PyTorch's eager ops round them.
#include <cuda_runtime.h>

namespace {

struct Spec {
    float steering_speed, acceleration, drag, lateral_friction, grip, max_speed, dt,
        two_pi;
};

__global__ void car_update_kernel(
        const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ angle, const float* __restrict__ vx,
        const float* __restrict__ vy, const unsigned char* __restrict__ crashed,
        const float* __restrict__ steering, const float* __restrict__ throttle,
        float* __restrict__ nx, float* __restrict__ ny, float* __restrict__ nang,
        float* __restrict__ nvx, float* __restrict__ nvy, size_t n, Spec k) {
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x0 = x[i], y0 = y[i], a0 = angle[i], vx0 = vx[i], vy0 = vy[i];
    if (crashed[i]) {
        nx[i] = x0;
        ny[i] = y0;
        nang[i] = a0;
        nvx[i] = vx0;
        nvy[i] = vy0;
        return;
    }
    float ang = fmodf(a0 + (steering[i] * k.steering_speed) * k.dt, k.two_pi);
    if (ang != 0.0f && ((k.two_pi < 0.0f) != (ang < 0.0f))) ang += k.two_pi;
    const float ca = cosf(ang);
    const float sa = sinf(ang);

    float v_fwd = vx0 * ca + vy0 * sa;
    float v_lat = vx0 * (-sa) + vy0 * ca;
    v_fwd = (v_fwd + (throttle[i] * k.acceleration) * k.dt) * k.drag;
    v_lat = (v_lat * k.lateral_friction) * k.grip;

    float wx = v_fwd * ca - v_lat * sa;
    float wy = v_fwd * sa + v_lat * ca;
    const float speed = __fsqrt_rn(wx * wx + wy * wy);
    if (speed > k.max_speed) {
        const float scale = __fdiv_rn(k.max_speed, speed);
        wx = wx * scale;
        wy = wy * scale;
    }
    nx[i] = x0 + wx * k.dt;
    ny[i] = y0 + wy * k.dt;
    nang[i] = ang;
    nvx[i] = wx;
    nvy[i] = wy;
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
    const Spec k{steering_speed, acceleration, drag, lateral_friction, grip, max_speed,
                 dt, two_pi};
    const int threads = 256;
    car_update_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        x, y, angle, vx, vy, crashed, steering, throttle, nx, ny, nang, nvx, nvy,
        (size_t)n, k);
    return (int)cudaGetLastError();
}

extern "C" const char* car_update_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
