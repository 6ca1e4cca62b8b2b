// K5's per-car dynamics step and the car's corners, for NVIDIA Hopper (sm_90a): the
// device code of car_update.cu, shared with car_step_and_query.cu (which steps the
// car and forms its corners in registers before its track query) and
// raycast_walls_and_cars.cu (which forms the cars' corners for its car pass).
//
// The step (the JAX package's car_update, self_play_racing_tpu/ops/dynamics.py), in
// the reference's operation order:
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
// The corners (the port's car_corners, ops/geometry.py), FL(+l,+w), FR(+l,-w),
// RR(-l,-w), RL(-l,+w):
//   cx = (x + cos*lx) - sin*ly,  cy = (y + sin*lx) + cos*ly.
// Built with -fmad=false, both round as PyTorch's eager ops round them.
#pragma once

#include <cuda_runtime.h>

namespace car_step {

struct Spec {
    float steering_speed, acceleration, drag, lateral_friction, grip, max_speed, dt,
        two_pi;
};

struct Car {
    float x, y, angle, vx, vy;
};

__device__ __forceinline__ Car step(const Car& c, bool crashed, float steering,
                                    float throttle, const Spec& k) {
    if (crashed) return c;
    float ang = fmodf(c.angle + (steering * k.steering_speed) * k.dt, k.two_pi);
    if (ang != 0.0f && ((k.two_pi < 0.0f) != (ang < 0.0f))) ang += k.two_pi;
    const float ca = cosf(ang);
    const float sa = sinf(ang);

    float v_fwd = c.vx * ca + c.vy * sa;
    float v_lat = c.vx * (-sa) + c.vy * ca;
    v_fwd = (v_fwd + (throttle * k.acceleration) * k.dt) * k.drag;
    v_lat = (v_lat * k.lateral_friction) * k.grip;

    float wx = v_fwd * ca - v_lat * sa;
    float wy = v_fwd * sa + v_lat * ca;
    const float speed = __fsqrt_rn(wx * wx + wy * wy);
    if (speed > k.max_speed) {
        const float scale = __fdiv_rn(k.max_speed, speed);
        wx = wx * scale;
        wy = wy * scale;
    }
    return Car{c.x + wx * k.dt, c.y + wy * k.dt, ang, wx, wy};
}

__device__ __forceinline__ void corners(float x, float y, float angle, float half_length,
                                        float half_width, float (&cx)[4], float (&cy)[4]) {
    const float ca = cosf(angle);
    const float sa = sinf(angle);
    const float lx[4] = {half_length, half_length, -half_length, -half_length};
    const float ly[4] = {half_width, -half_width, -half_width, half_width};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        cx[i] = (x + ca * lx[i]) - sa * ly[i];
        cy[i] = (y + sa * lx[i]) + ca * ly[i];
    }
}

}  // namespace car_step
