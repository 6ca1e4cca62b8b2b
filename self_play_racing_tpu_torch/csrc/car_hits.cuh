// K3's per-ray edge loop, for NVIDIA Hopper (sm_90a): the device code of
// raycast_cars.cu, shared with raycast_walls_and_cars.cu, which runs it as the car
// pass of its self-play launch.
//
// Semantics (the JAX package's raycast_cars, self_play_racing_tpu/ops/geometry.py),
// per ray:
//   - a car whose centre lies within 0.5 of the ray origin is skipped
//     (sqrt(dx^2 + dy^2) < 0.5, the square root rounded as IEEE);
//   - edge i of a car runs from corner i to corner (i+1) % 4;
//   - dotp = vx*(-dy) + vy*dx; an edge is a candidate when |dotp| >= 1e-10;
//   - t = (vx*v1y - vy*v1x) / dotp and s = (v1x*v3x + v1y*v3y) / dotp, two IEEE
//     divisions, with v1 = origin - edge start and v3 = (-dy, dx);
//   - a hit is t >= 0 and 0 <= s <= 1; the result is min(max_dist, least t), and
//     max_dist where no edge is hit.
// The least t is a plain min, exact in any order.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace car_hits {

constexpr float kParallelEps = 1e-10f;
constexpr float kSkipRadius = 0.5f;
constexpr int kFloatsPerCar = 18;  // 4 corners, 4 edge vectors (x and y), the centre

// A row's cars as a block stages them in shared memory: edge e = 4a + i of car a
// starts at (sx[e], sy[e]) and runs along (vx[e], vy[e]); car a's centre is
// (x[a], y[a]).
struct Cars {
    float* sx;
    float* sy;
    float* vx;
    float* vy;
    float* x;
    float* y;
    int num;
};

// the layout of `num` cars in kFloatsPerCar * num floats from `base`
__device__ __forceinline__ Cars layout(float* base, int num) {
    const int E = 4 * num;
    return Cars{base, base + E, base + 2 * E, base + 3 * E, base + 4 * E,
                base + 4 * E + num, num};
}

// the ray (ox, oy) + t (dx, dy) against every edge of the cars
__device__ __forceinline__ float nearest(const Cars& cars, float rox, float roy, float dx,
                                         float dy, float max_dist) {
    const float v3x = -dy;
    const float v3y = dx;
    float tmin = CUDART_INF_F;
    for (int a = 0; a < cars.num; ++a) {
        const float cdx = cars.x[a] - rox;
        const float cdy = cars.y[a] - roy;
        if (__fsqrt_rn(cdx * cdx + cdy * cdy) < kSkipRadius) continue;
        for (int e = 4 * a; e < 4 * a + 4; ++e) {
            const float vx = cars.vx[e];
            const float vy = cars.vy[e];
            const float dotp = vx * v3x + vy * v3y;
            if (!(fabsf(dotp) >= kParallelEps)) continue;
            const float v1x = rox - cars.sx[e];
            const float v1y = roy - cars.sy[e];
            const float t = __fdiv_rn(vx * v1y - vy * v1x, dotp);
            const float s = __fdiv_rn(v1x * v3x + v1y * v3y, dotp);
            if (t >= 0.0f && s >= 0.0f && s <= 1.0f && t < tmin) tmin = t;
        }
    }
    const float d = isinf(tmin) ? max_dist : tmin;
    return d < max_dist ? d : max_dist;
}

}  // namespace car_hits
