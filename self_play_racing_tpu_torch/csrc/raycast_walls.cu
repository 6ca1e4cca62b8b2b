// K1: nearest wall hit per ray, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's raycast reduction, self_play_racing_tpu/ops/geometry.py
// (raycast_walls + _ratio_min_reducer), which XLA fuses on the TPU. Same semantics:
//   - hit test: |dotp| > 1e-10, cn*dotp >= 0, sn*dotp >= 0, |sn| <= |dotp|;
//   - the winner is the least ratio |cn|/|dotp|, compared without dividing:
//     q beats p only on a strict qa*pd < pa*qd, so ties keep the earlier segment;
//   - a miss carries (inf, d); padding rows have d exactly 0, and their
//     inf*0 = NaN products compare false and lose;
//   - one IEEE divide on the winner; max_dist only when that ratio is inf (a hit
//     beyond max_dist is returned unclamped).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): at the main path's shapes
// (4096 env rows x 11 rays x 896 padded segments, five f32 segment fields per row)
// the kernel must read 5 x 896 x 4 B x 4096 = 73 MB, about 22 us, against about
// 1.05 GFLOP of f32 work (26 operations per ray-segment pair), about 16 us. It is
// memory-bound.
//
// Design: one block per env row. The block stages the row's five segment fields
// (20 B per segment, 18 KB at S = 896) in shared memory once, and every ray of the
// row reads them from there, so device memory is read once per row. One warp per
// ray: lane j folds the contiguous run [j*L, (j+1)*L) of segments in index order,
// then the 32 runs combine pairwise left before right (offsets 1, 2, 4, 8, 16),
// ties keeping the left. With a consistent comparator this is the reference's
// sequential fold; it can differ from it only where two ratios tie to within the
// rounding of the cross products. Compiled with -fmad=false so every product and
// sum rounds as PyTorch's eager ops round them.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kParallelEps = 1e-10f;
constexpr int kMaxRaysPerBlock = 16;

__device__ __forceinline__ void ratio_min(float& pa, float& pd, float qa, float qd) {
    const bool take_q = qa * pd < pa * qd;
    pa = take_q ? qa : pa;
    pd = take_q ? qd : pd;
}

__global__ void raycast_walls_kernel(
        const float* __restrict__ ox, const float* __restrict__ oy,
        const float* __restrict__ dx, const float* __restrict__ dy,
        const float* __restrict__ seg_sx, const float* __restrict__ seg_sy,
        const float* __restrict__ seg_vx, const float* __restrict__ seg_vy,
        const float* __restrict__ seg_c, float* __restrict__ out,
        int rays_per_row, int num_segments, float max_dist) {
    extern __shared__ float smem[];
    const int S = num_segments;
    float* s_sx = smem;
    float* s_sy = smem + S;
    float* s_vx = smem + 2 * S;
    float* s_vy = smem + 3 * S;
    float* s_c = smem + 4 * S;

    const size_t row = blockIdx.x;
    const size_t base = row * (size_t)S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
        const float sx = seg_sx[base + i];
        const float sy = seg_sy[base + i];
        const float vx = seg_vx[base + i];
        const float vy = seg_vy[base + i];
        s_sx[i] = sx;
        s_sy[i] = sy;
        s_vx[i] = vx;
        s_vy[i] = vy;
        s_c[i] = seg_c != nullptr ? seg_c[base + i] : vy * sx - vx * sy;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int ray = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (ray >= rays_per_row) return;  // whole warps only; no barrier follows
    const size_t r = row * (size_t)rays_per_row + ray;
    const float rox = ox[r];
    const float roy = oy[r];
    const float rdx = dx[r];
    const float rdy = dy[r];
    const float u = rox * rdy - roy * rdx;

    const int run = (S + 31) / 32;
    const int lo = min(lane * run, S);
    const int hi = min(lo + run, S);
    float pa = CUDART_INF_F;
    float pd = 1.0f;
    for (int s = lo; s < hi; ++s) {
        const float vx = s_vx[s];
        const float vy = s_vy[s];
        const float cn = roy * vx - rox * vy + s_c[s];
        const float dotp = vy * rdx - vx * rdy;
        const float sn = s_sx[s] * rdy - s_sy[s] * rdx - u;
        const float d = fabsf(dotp);
        const bool hit = (d > kParallelEps) && (cn * dotp >= 0.0f)
                         && (sn * dotp >= 0.0f) && (fabsf(sn) <= d);
        ratio_min(pa, pd, hit ? fabsf(cn) : CUDART_INF_F, d);
    }
    // lane i (a multiple of 2*o) holds runs [i, i+o) and takes [i+o, i+2o) as
    // its right operand; lane 0 ends with all 32 runs in index order
    for (int o = 1; o < 32; o <<= 1) {
        const float qa = __shfl_down_sync(0xffffffffu, pa, o);
        const float qd = __shfl_down_sync(0xffffffffu, pd, o);
        ratio_min(pa, pd, qa, qd);
    }
    if (lane == 0) {
        const float t = __fdiv_rn(pa, pd);
        out[r] = isinf(t) ? max_dist : t;
    }
}

}  // namespace

// rows x rays_per_row rays; row i of the five segment fields is [i*S, (i+1)*S).
// seg_c may be null: the kernel then forms c = vy*sx - vx*sy itself.
// Returns a cudaError_t (0 on success).
extern "C" int raycast_walls_f32(
        const float* ox, const float* oy, const float* dx, const float* dy,
        const float* seg_sx, const float* seg_sy, const float* seg_vx,
        const float* seg_vy, const float* seg_c, float* out,
        int rows, int rays_per_row, int num_segments, float max_dist,
        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0 || rays_per_row == 0) return 0;
    const int rays_per_block =
        rays_per_row < kMaxRaysPerBlock ? rays_per_row : kMaxRaysPerBlock;
    const dim3 grid(rows, (rays_per_row + rays_per_block - 1) / rays_per_block);
    const size_t smem = 5 * (size_t)num_segments * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(raycast_walls_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    raycast_walls_kernel<<<grid, 32 * rays_per_block, smem, (cudaStream_t)stream>>>(
        ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, seg_c, out,
        rays_per_row, num_segments, max_dist);
    return (int)cudaGetLastError();
}

extern "C" const char* raycast_walls_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
