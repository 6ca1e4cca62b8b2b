// K1's per-ray fold over a staged segment row, for NVIDIA Hopper (sm_90a): the
// device code of raycast_walls.cu, shared with raycast_walls_and_cars.cu, which
// runs the same fold in its self-play launch.
//
// Semantics (the JAX package's raycast_walls, self_play_racing_tpu/ops/geometry.py):
//   - hit test: |dotp| > 1e-10, cn*dotp >= 0, sn*dotp >= 0, |sn| <= |dotp|;
//   - the winner is the least ratio |cn|/|dotp|, compared without dividing:
//     q beats p only on a strict qa*pd < pa*qd, so ties keep the earlier segment;
//   - a miss carries (inf, d); padding rows have d exactly 0, and their
//     inf*0 = NaN products compare false and lose;
//   - one IEEE divide on the winner; max_dist only when that ratio is inf (a hit
//     beyond max_dist is returned unclamped).
//
// Reduction shape (the kernels' contract, unchanged since the first K1): per ray,
// lane j of a warp folds the contiguous run [j*L, (j+1)*L) of segments in index
// order, L = ceil(S/32); the 32 runs combine through a shuffle tree (offsets 1, 2,
// 4, 8, 16, left before right). The comparator is not a total order, so this
// shape fixes every result bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_stage.cuh"

namespace wall_fold {

constexpr float kParallelEps = 1e-10f;
constexpr int kFields = 5;  // sx, sy, vx, vy, c

// Once the row's copies have landed (row_stage::wait_barrier): where each field of
// row `row` sits in the stage (field f at stage + f * cap), with zero direction
// written past S, so that every lane takes L steps: such padding loses every
// comparison. The block syncs before the fold reads them.
__device__ __forceinline__ void staged_fields(float* stage, const float* const* fields,
                                              int num_fields, size_t row, int S, int L,
                                              int cap, const float* (&rs)[kFields]) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
        rs[f] = row_stage::staged(stage + f * cap, fields[f], row, S);
    }
    for (int i = S + threadIdx.x; i < 32 * L; i += blockDim.x) {
        for (int f = 0; f < num_fields; ++f) const_cast<float*>(rs[f])[i] = 0.0f;
    }
}

__device__ __forceinline__ void ratio_min(float& pa, float& pd, float qa, float qd) {
    const bool take_q = qa * pd < pa * qd;
    pa = take_q ? qa : pa;
    pd = take_q ? qd : pd;
}

// The R rays a warp holds (every lane the same R) against the staged row, whose
// fields sx, sy, vx, vy (and c, when with_c) hold 32 * L floats, zero direction
// past S. Lane j folds the run [j*L, (j+1)*L), reading word j*L + k of each field
// at step k: gcd(L, 32) lanes share a bank (4 at S = 896), and the R rays of a
// lane share each read. Lane 0 ends with each ray's winner (pa[t], pd[t]) over
// all 32 runs in index order; the other lanes hold partial folds.
template <int R>
__device__ __forceinline__ void fold(
        const float* sx_row, const float* sy_row, const float* vx_row,
        const float* vy_row, const float* c_row, bool with_c, int L, int lane,
        const float (&rox)[R], const float (&roy)[R], const float (&rdx)[R],
        const float (&rdy)[R], const float (&u)[R], float (&pa)[R], float (&pd)[R]) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
        pa[t] = CUDART_INF_F;
        pd[t] = 1.0f;
    }
    for (int k = 0; k < L; ++k) {
        const int i = lane * L + k;
        const float sx = sx_row[i];
        const float sy = sy_row[i];
        const float vx = vx_row[i];
        const float vy = vy_row[i];
        const float c = with_c ? c_row[i] : vy * sx - vx * sy;
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const float cn = roy[t] * vx - rox[t] * vy + c;
            const float dotp = vy * rdx[t] - vx * rdy[t];
            const float sn = sx * rdy[t] - sy * rdx[t] - u[t];
            const float d = fabsf(dotp);
            // ratio_min(pa, pd, hit ? |cn| : inf, d): a miss never wins, as
            // inf * pd = inf (pd > 0: only hits, with d > 1e-10, are taken).
            // Every product is formed and the tests joined with & (not &&),
            // so the loop has no branch.
            const float q_by_p = fabsf(cn) * pd[t];
            const float p_by_q = pa[t] * d;
            const bool take = (d > kParallelEps) & (cn * dotp >= 0.0f)
                              & (sn * dotp >= 0.0f) & (fabsf(sn) <= d)
                              & (q_by_p < p_by_q);
            pa[t] = take ? fabsf(cn) : pa[t];
            pd[t] = take ? d : pd[t];
        }
    }
    // lane i (a multiple of 2*o) holds runs [i, i+o) and takes [i+o, i+2o) as
    // its right operand; lane 0 ends with all 32 runs in index order
    __syncwarp();
#pragma unroll
    for (int t = 0; t < R; ++t) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float qa = __shfl_down_sync(0xffffffffu, pa[t], o);
            const float qd = __shfl_down_sync(0xffffffffu, pd[t], o);
            ratio_min(pa[t], pd[t], qa, qd);
        }
    }
}

// the hit distance of a ray's winner: one IEEE divide, max_dist for a miss
__device__ __forceinline__ float distance(float pa, float pd, float max_dist) {
    const float d = __fdiv_rn(pa, pd);
    return isinf(d) ? max_dist : d;
}

}  // namespace wall_fold
