// The multi-car transition's track query, redesigned for NVIDIA Hopper (sm_90a):
// the device code of multi_transition.cu. Bitwise it finds what track_query.cuh's
// search finds over all W padded waypoints; it searches the row's real waypoints
// [0, m) first and the padding [m, W) only where the padding could win.
//
// The winner of a query is the first-index argmin of d^2 = dx*dx + dy*dy (a strict
// less; a NaN or an overflowed d^2 never wins): the least (d^2, index) in a total
// order, so any split of the waypoints into ranges, merged on that order, gives the
// same winner. Padding waypoints sit far away (1e8 in the pool builders, but the
// kernel assumes nothing about them): the warp bounds them by their box, and the
// least d^2 a query could reach in it, formed with the search's own subtractions and
// products (rounding is monotone, so no padding waypoint's d^2 is below it). A real
// winner at most that bound keeps its place (a padding tie loses on the index);
// otherwise (a query far off the track, a NaN, a row without real waypoints) the
// warp also searches [m, W) and merges.
#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace waypoint_search {

constexpr int kQueries = 5;  // queries a lane holds at once: centre + 4 corners

// The box of waypoints [lo, hi) staged at s_wx, s_wy, on every lane (fminf and
// fmaxf pass over NaN coordinates, whose d^2 never wins; an empty range gives the
// empty box, inf to -inf).
struct Box {
    float x0, x1, y0, y1;
};

__device__ __forceinline__ Box box_of(const float* s_wx, const float* s_wy, int lo, int hi,
                                      int lane) {
    Box b{CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F};
    for (int w = lo + lane; w < hi; w += 32) {
        b.x0 = fminf(b.x0, s_wx[w]);
        b.x1 = fmaxf(b.x1, s_wx[w]);
        b.y0 = fminf(b.y0, s_wy[w]);
        b.y1 = fmaxf(b.y1, s_wy[w]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        b.x0 = fminf(b.x0, __shfl_xor_sync(0xffffffffu, b.x0, o));
        b.x1 = fmaxf(b.x1, __shfl_xor_sync(0xffffffffu, b.x1, o));
        b.y0 = fminf(b.y0, __shfl_xor_sync(0xffffffffu, b.y0, o));
        b.y1 = fmaxf(b.y1, __shfl_xor_sync(0xffffffffu, b.y1, o));
    }
    return b;
}

// At most the d^2 the search forms from (qx, qy) to any waypoint in the box: per
// axis the gap qx - x1 or x0 - qx where the query lies outside (each at most the
// |qx - wx| the search rounds, as rounding is monotone), else 0; inf for the
// empty box; 0 for a NaN query, which then always searches the padding.
__device__ __forceinline__ float box_d2(const Box& b, float qx, float qy) {
    const float gx = fmaxf(fmaxf(b.x0 - qx, qx - b.x1), 0.0f);
    const float gy = fmaxf(fmaxf(b.y0 - qy, qy - b.y1), 0.0f);
    return gx * gx + gy * gy;
}

// Folds waypoints [lo, hi) into each lane's (best_d2, best_i) for the queries every
// lane holds: lane l visits lo + l, lo + l + 32, ..., in order, with
// track_query::search's operations and strict less (whole chunks of 32, then the
// last chunk with the lanes past hi held at d^2 = inf, so that the warp stays
// converged).
__device__ __forceinline__ void visit(const float* s_wx, const float* s_wy, int lo, int hi,
                                      int lane, const float (&qx)[kQueries],
                                      const float (&qy)[kQueries], float (&best_d2)[kQueries],
                                      int (&best_i)[kQueries]) {
    auto step = [&](int w, bool valid) {
        const float wx = s_wx[valid ? w : lo];
        const float wy = s_wy[valid ? w : lo];
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
    const int whole = lo + ((hi - lo) & ~31);
#pragma unroll 4
    for (int w0 = lo; w0 < whole; w0 += 32) step(w0 + lane, true);
    if (whole < hi) step(whole + lane, whole + lane < hi);
}

// every lane ends with each query's least (d^2, index) over the warp's lanes
__device__ __forceinline__ void reduce(float (&best_d2)[kQueries], int (&best_i)[kQueries]) {
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
}

// Each query's winner over the W staged waypoints, on every lane (INT_MAX where no
// d^2 is finite), searching the real ones [0, m) and the padding [m, W) only where
// its box could hold a winner.
__device__ __forceinline__ void search(const float* s_wx, const float* s_wy, int m, int W,
                                       const Box& padding, int lane,
                                       const float (&qx)[kQueries],
                                       const float (&qy)[kQueries], int (&best_i)[kQueries]) {
    float best_d2[kQueries];
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
        best_d2[t] = CUDART_INF_F;
        best_i[t] = INT_MAX;
    }
    visit(s_wx, s_wy, 0, m, lane, qx, qy, best_d2, best_i);
    reduce(best_d2, best_i);
    bool padding_may_win = false;  // the same on every lane
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
        padding_may_win |= !(best_d2[t] <= box_d2(padding, qx[t], qy[t]));
    }
    if (padding_may_win) {
        visit(s_wx, s_wy, m, W, lane, qx, qy, best_d2, best_i);
        reduce(best_d2, best_i);
    }
}

}  // namespace waypoint_search
