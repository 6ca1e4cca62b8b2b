// K2's row search and projection, for NVIDIA Hopper (sm_90a): the device code of
// progress_collision.cu, shared with car_step_and_query.cu, which runs the same
// search on the car it has just stepped.
//
// Semantics (the JAX package's progress_and_collision,
// self_play_racing_tpu/ops/geometry.py): for the car centre and each corner, the
// first-index argmin of d^2 over the row's waypoints (strict less; ties go to the
// lower index), carrying the projection of (query - waypoint) on that waypoint's
// normal; a corner with |projection| > track_width is outside the track. Padding
// waypoints sit at 1e8 and never win: d^2 ~ 2e16 stays finite in f32.
//
// One warp serves one car, its queries in registers, so each waypoint read from
// shared memory serves all of them; lanes take waypoints lane, lane+32, ...
// (consecutive words: no bank conflicts), the last partial chunk held at d^2 = inf
// so that the warp stays converged. The warp reduces each query on the pair (d^2,
// idx), a total order, so the butterfly gives every lane the exact first-index
// argmin whatever its shape; lane t then forms query t's projection from the same
// staged position and the winner's normal, read from device memory, in the same
// operations as the plain version, so it is bitwise the one that version gathers.
#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace track_query {

constexpr int kQueries = 5;  // queries a lane holds at once: centre + 4 corners

// Queries q0 .. q0 + kQueries - 1 of a car (query 0 the centre, 1.. the corners;
// past `queries` the slots repeat the last), every lane holding all of them,
// against the W waypoints staged at s_wx, s_wy whose normals are row_nx, row_ny.
// Returns, on every lane, whether a corner of these queries lies outside `width`,
// and sets best0 to the winner of query slot 0.
__device__ __forceinline__ bool search(const float* s_wx, const float* s_wy,
                                       const float* row_nx, const float* row_ny, int W,
                                       int lane, const float (&qx)[kQueries],
                                       const float (&qy)[kQueries], int q0, int queries,
                                       float width, int& best0) {
    float best_d2[kQueries];
    int best_i[kQueries];
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
        best_d2[t] = CUDART_INF_F;
        best_i[t] = INT_MAX;
    }
    // whole chunks of 32 waypoints, then the last chunk with the lanes past
    // W held at d^2 = inf, so that the warp stays converged
    auto visit = [&](int w, bool valid) {
        const float wx = s_wx[valid ? w : 0];
        const float wy = s_wy[valid ? w : 0];
#pragma unroll
        for (int t = 0; t < kQueries; ++t) {
            const float ddx = qx[t] - wx;
            const float ddy = qy[t] - wy;
            const float d2 = valid ? ddx * ddx + ddy * ddy : CUDART_INF_F;
            const bool take = d2 < best_d2[t];
            best_d2[t] = take ? d2 : best_d2[t];
            best_i[t] = take ? w : best_i[t];
        }
    };
    const int whole = W & ~31;
#pragma unroll 4
    for (int w0 = 0; w0 < whole; w0 += 32) visit(w0 + lane, true);
    if (whole < W) visit(whole + lane, whole + lane < W);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, best_d2[t], o);
            const int oi = __shfl_xor_sync(0xffffffffu, best_i[t], o);
            if (od < best_d2[t] || (od == best_d2[t] && oi < best_i[t])) {
                best_d2[t] = od;
                best_i[t] = oi;
            }
        }
    }
    // every lane holds every query's winner; lane t forms the projection
    // of query q0 + t, in parallel
    int i = best_i[0];
    float px = qx[0], py = qy[0];
#pragma unroll
    for (int t = 1; t < kQueries; ++t) {
        i = lane == t ? best_i[t] : i;
        px = lane == t ? qx[t] : px;
        py = lane == t ? qy[t] : py;
    }
    const int q = q0 + lane;
    bool outside = false;
    if (lane < kQueries && q < queries && q > 0 && i < W) {
        // i < W: there is no winner only where every d^2 is NaN
        const float ddx = px - s_wx[i];
        const float ddy = py - s_wy[i];
        const float p = ddx * row_nx[i] + ddy * row_ny[i];
        outside = fabsf(p) > width;
    }
    best0 = best_i[0];
    return __any_sync(0xffffffffu, outside);
}

}  // namespace track_query
