// The multi-car observation's sensing, redesigned for NVIDIA Hopper (sm_90a): the
// device code of multi_observe.cu. Bitwise it computes what wall_fold.cuh's fold and
// car_hits.cuh's nearest compute; it reshapes who computes what.
//
// K1's reduction shape is the contract (wall_fold.cuh:14-18): per ray, run j folds
// segments [j*L, (j+1)*L) in index order, L = ceil(S/32), and the 32 runs combine as
// a balanced tree (neighbours at distance 1, 2, 4, 8, 16, left before right). Here:
//   - a run stops at the row's real extent E, one past its last segment with a
//     nonzero direction: a segment of zero direction never takes (its |dotp| is 0
//     or NaN, never > 1e-10), so the steps skipped leave the fold as it was, and a
//     run wholly past E is the identity (inf, 1) of ratio_min;
//   - a (ray group, run) pair is one item, and the block's lanes take the items of
//     its rows one after another, so that no lane folds padding;
//   - when a group is one car's rays (they share the car's position as origin),
//     the cross term cn = oy*vx - ox*vy + c and |cn| are formed once a segment for
//     the group, as the JAX package writes it (ray-independent), in the same
//     operations as each ray formed them;
//   - the 32 run results of a ray meet in shared memory and one thread combines
//     them in the tree's order;
//   - the car pass puts each (ray, car) on a lane: a car's four edges in order with
//     nearest's strict t < tmin, then the cars' minima in car order with the same
//     strict <, which keeps the first of equal values (so -0.0 and +0.0 come out
//     as nearest gives them).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "car_hits.cuh"
#include "wall_fold.cuh"

namespace run_fold {

constexpr int kRuns = 32;
// a ray's run results are kRuns floats at a stride of kRunStride, so that the
// threads of consecutive rays read distinct banks when they combine them
constexpr int kRunStride = kRuns + 1;

// one past the last segment of the staged row (S floats of vx, vy) whose direction
// is not zero, found by the calling warp from the row's end; 0 for a row of padding
__device__ __forceinline__ int real_extent(const float* vx, const float* vy, int S, int lane) {
    for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
        const int i = base + lane;
        const bool real = i < S && (vx[i] != 0.0f || vy[i] != 0.0f);
        const unsigned mask = __ballot_sync(0xffffffffu, real);
        if (mask) return base + 32 - __clz(mask);
    }
    return 0;
}

// Run steps [begin, end) of the staged fields for R rays: wall_fold::fold's step,
// in its operations and order. kCarOrigin: every ray starts at (ox[0], oy[0]) (one
// car's rays), and cn, |cn| are formed once a segment.
template <int R, bool kCarOrigin>
__device__ __forceinline__ void fold_run(
        const float* sx_row, const float* sy_row, const float* vx_row, const float* vy_row,
        const float* c_row, int begin, int end, const float (&rox)[R], const float (&roy)[R],
        const float (&rdx)[R], const float (&rdy)[R], const float (&u)[R], float (&pa)[R],
        float (&pd)[R]) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
        pa[t] = CUDART_INF_F;
        pd[t] = 1.0f;
    }
#pragma unroll 2
    for (int i = begin; i < end; ++i) {
        const float sx = sx_row[i];
        const float sy = sy_row[i];
        const float vx = vx_row[i];
        const float vy = vy_row[i];
        const float c = c_row[i];
        float cn_car = 0.0f;
        if constexpr (kCarOrigin) cn_car = roy[0] * vx - rox[0] * vy + c;
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const float cn = kCarOrigin ? cn_car : roy[t] * vx - rox[t] * vy + c;
            const float dotp = vy * rdx[t] - vx * rdy[t];
            const float sn = sx * rdy[t] - sy * rdx[t] - u[t];
            const float d = fabsf(dotp);
            const float q_by_p = fabsf(cn) * pd[t];
            const float p_by_q = pa[t] * d;
            const bool take = (d > wall_fold::kParallelEps) & (cn * dotp >= 0.0f)
                              & (sn * dotp >= 0.0f) & (fabsf(sn) <= d)
                              & (q_by_p < p_by_q);
            pa[t] = take ? fabsf(cn) : pa[t];
            pd[t] = take ? d : pd[t];
        }
    }
}

// The winner of runs [j0, j0 + N) of a ray in the shuffle tree's order
// (wall_fold::fold's offsets 1, 2, 4, 8, 16, left before right): run j < runs at
// ra[j], rd[j], the runs from `runs` on the identity (inf, 1). Recursion keeps the
// tree in registers, its indices constant once inlined.
template <int N>
struct RunTree {
    __device__ __forceinline__ static void fold(const float* ra, const float* rd, int j0,
                                                int runs, float& pa, float& pd) {
        float qa, qd;
        RunTree<N / 2>::fold(ra, rd, j0, runs, pa, pd);
        RunTree<N / 2>::fold(ra, rd, j0 + N / 2, runs, qa, qd);
        wall_fold::ratio_min(pa, pd, qa, qd);
    }
};

template <>
struct RunTree<1> {
    __device__ __forceinline__ static void fold(const float* ra, const float* rd, int j,
                                                int runs, float& pa, float& pd) {
        pa = j < runs ? ra[j] : CUDART_INF_F;
        pd = j < runs ? rd[j] : 1.0f;
    }
};

// a ray's winner over its 32 runs
__device__ __forceinline__ void combine_runs(const float* ra, const float* rd, int runs,
                                             float& pa, float& pd) {
    RunTree<kRuns>::fold(ra, rd, 0, runs, pa, pd);
}

// The least hit t of the ray (ox, oy) + t (dx, dy) on car a's four edges, in
// car_hits::nearest's operations and edge order (inf where the car is skipped or
// no edge is hit).
__device__ __forceinline__ float car_tmin(const car_hits::Cars& cars, int a, float rox,
                                          float roy, float dx, float dy) {
    const float v3x = -dy;
    const float v3y = dx;
    float tmin = CUDART_INF_F;
    const float cdx = cars.x[a] - rox;
    const float cdy = cars.y[a] - roy;
    if (__fsqrt_rn(cdx * cdx + cdy * cdy) < car_hits::kSkipRadius) return tmin;
#pragma unroll
    for (int e = 4 * a; e < 4 * a + 4; ++e) {
        const float vx = cars.vx[e];
        const float vy = cars.vy[e];
        const float dotp = vx * v3x + vy * v3y;
        if (!(fabsf(dotp) >= car_hits::kParallelEps)) continue;
        const float v1x = rox - cars.sx[e];
        const float v1y = roy - cars.sy[e];
        const float t = __fdiv_rn(vx * v1y - vy * v1x, dotp);
        const float s = __fdiv_rn(v1x * v3x + v1y * v3y, dotp);
        if (t >= 0.0f && s >= 0.0f && s <= 1.0f && t < tmin) tmin = t;
    }
    return tmin;
}

// nearest's result from the cars' minima (car_tmin for cars 0 .. num-1, num_cars
// floats from t): the first strict minimum in car order, clamped to max_dist
__device__ __forceinline__ float cars_nearest(const float* t, int num_cars, float max_dist) {
    float tmin = CUDART_INF_F;
    for (int a = 0; a < num_cars; ++a) tmin = t[a] < tmin ? t[a] : tmin;
    const float d = isinf(tmin) ? max_dist : tmin;
    return d < max_dist ? d : max_dist;
}

}  // namespace run_fold
