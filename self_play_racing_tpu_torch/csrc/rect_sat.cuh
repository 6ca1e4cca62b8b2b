// K4's separating-axis test of two cars' rectangles, for NVIDIA Hopper (sm_90a): the
// device code of rectangles_intersect.cu, shared with car_step_and_query.cu, which
// runs the same test on the corners it has just formed for every pair of a row's
// cars.
//
// Semantics (the JAX package's rectangles_intersect,
// self_play_racing_tpu/ops/geometry.py) for the pair (a, b):
//   - axes: the normals (-ey, ex) of a's edges 0->1 and 1->2, then b's;
//   - each car's 4 corners projected on each axis as axx*x + axy*y (two products
//     and a sum, unfused: built with -fmad=false);
//   - a gap on an axis is max(pa) < min(pb) or max(pb) < min(pa), strictly;
//   - the cars intersect when no axis has a gap.
#pragma once

#include <cuda_runtime.h>

namespace rect_sat {

struct Rect {
    float x[4];
    float y[4];
};

__device__ __forceinline__ Rect load_rect(const float* __restrict__ cx,
                                          const float* __restrict__ cy, size_t base) {
    Rect r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        r.x[c] = cx[base + c];
        r.y[c] = cy[base + c];
    }
    return r;
}

// true when the projections of a and b on the axis (axx, axy) have a strict gap
__device__ __forceinline__ bool gap_on(const Rect& a, const Rect& b, float axx,
                                       float axy) {
    float amin = axx * a.x[0] + axy * a.y[0];
    float amax = amin;
    float bmin = axx * b.x[0] + axy * b.y[0];
    float bmax = bmin;
#pragma unroll
    for (int c = 1; c < 4; ++c) {
        const float pa = axx * a.x[c] + axy * a.y[c];
        const float pb = axx * b.x[c] + axy * b.y[c];
        amin = fminf(amin, pa);
        amax = fmaxf(amax, pa);
        bmin = fminf(bmin, pb);
        bmax = fmaxf(bmax, pb);
    }
    return amax < bmin || bmax < amin;
}

// true when a and b intersect. a's edge normals, then b's: edge e -> e+1, normal
// (-ey, ex); every axis is tested (no early exit), so the work does not depend on
// the data
__device__ __forceinline__ bool intersect(const Rect& ra, const Rect& rb) {
    bool gap = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        gap |= gap_on(ra, rb, -(ra.y[e + 1] - ra.y[e]), ra.x[e + 1] - ra.x[e]);
        gap |= gap_on(ra, rb, -(rb.y[e + 1] - rb.y[e]), rb.x[e + 1] - rb.x[e]);
    }
    return !gap;
}

}  // namespace rect_sat
