// The MLP kernels' other design, for scripts/mlp_save_vs_recompute.py: the forward
// also writes each tile's h1 and h2 of both towers to device memory, and the
// backward reads them there in place of recomputing the tile's forward. Built beside
// the port's csrc/mlp_towers.cu, whose device code it shares (included whole), for
// towers (64, 64), rows read in place (no unit index). Nothing in the port calls it.
#include "../self_play_racing_tpu_torch/csrc/mlp_towers.cu"

namespace {

constexpr int kH = 64;
// floats of one tower's saved h1 and h2 for a tile: [2 kH][kRows]
constexpr long long kSavedTile = 2LL * kH * kRows;

__device__ __forceinline__ float* saved_tile(float* saved) {
    return saved + ((long long)blockIdx.x * 2 + blockIdx.y) * kSavedTile;
}

// Row r's h1 and h2 (a1 and a2 lie one after the other in shared memory) to the
// saved buffer, or back: thread r moves row r, a feature's 128 rows coalesced.
template <int O, bool kStore>
__device__ __forceinline__ void move_activations(const Layout<kH, kH, O>& L, float* s,
                                                 float* tile) {
    const int r = threadIdx.x;
#pragma unroll 8
    for (int f = 0; f < 2 * kH; ++f) {
        float* sp = s + L.a1 + f * kStride + r;
        if (kStore) {
            tile[f * kRows + r] = *sp;
        } else {
            *sp = tile[f * kRows + r];
        }
    }
}

template <int O, bool kTanhOut>
__device__ void tower_forward_saving(const Args& a, const float* const* w, float* s,
                                     float* out, float* saved, long long row0) {
    const Layout<kH, kH, O> L(a.d);
    stage(a, L, w, s, row0);
    __syncthreads();
    hidden_forward(L, s);
    move_activations<O, true>(L, s, saved_tile(saved));
    const int r = threadIdx.x;
    float y[O];
    last_layer<kH, kH, O, kTanhOut>(L, s, r, y);
    if (row0 + r < a.n) {
#pragma unroll
        for (int o = 0; o < O; ++o) out[(row0 + r) * O + o] = y[o];
    }
}

template <int O, bool kTanhOut>
__device__ void tower_backward_saved(const Args& a, const float* const* w,
                                     const float* g_out, float* s, float* part,
                                     float* saved, long long row0) {
    const Layout<kH, kH, O> L(a.d);
    float g3[O];
    upstream(a, g_out, row0, g3);
    stage(a, L, w, s, row0);
    move_activations<O, false>(L, s, saved_tile(saved));
    __syncthreads();
    tower_gradients<kH, kH, O, kTanhOut>(L, g3, s, part);
}

__global__ void __launch_bounds__(kThreads) forward_saving_kernel(Args a, float* mu, float* v,
                                                                  float* saved) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const long long row0 = (long long)blockIdx.x * kRows;
    if (blockIdx.y == 0) {
        tower_forward_saving<2, true>(a, a.w, s, mu, saved, row0);
    } else {
        tower_forward_saving<1, false>(a, a.w + 6, s, v, saved, row0);
    }
}

__global__ void __launch_bounds__(kThreads) backward_saved_kernel(
        Args a, const float* g_mu, const float* g_v, float* partial, float* saved) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const long long row0 = (long long)blockIdx.x * kRows;
    float* part = partial + (long long)blockIdx.x * partial_floats<kH, kH>(a.d);
    if (blockIdx.y == 0) {
        tower_backward_saved<2, true>(a, a.w, g_mu, s, part, saved, row0);
    } else {
        tower_backward_saved<1, false>(a, a.w + 6, g_v, s, part + Layout<kH, kH, 2>(a.d).size,
                                       saved, row0);
    }
}

}  // namespace

// The floats of the saved activations at n rows: [tiles, 2 towers, 2 kH, kRows].
extern "C" long long mlp_saved_floats(long long n) { return tiles_for(n) * 2 * kSavedTile; }

// mlp_forward_f32's arguments (no unit ids, towers (64, 64)), and the saved buffer.
extern "C" int mlp_forward_saving_f32(const void* const* ptrs, int num_ptrs, long long n,
                                      int obs_dim, float* saved, void* stream) {
    Args a;
    if (num_ptrs != kInputs + 2 || ptrs[1] != nullptr || n < 1 ||
        !mlp_args(ptrs, n, 0, 0, obs_dim, kH, kH, &a))
        return (int)cudaErrorInvalidValue;
    const long long smem = shared_bytes<kH, kH>(obs_dim);
    cudaError_t err = allow_smem(forward_saving_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    forward_saving_kernel<<<dim3((unsigned)tiles_for(n), 2), kThreads, smem,
                            (cudaStream_t)stream>>>(
        a, static_cast<float*>(const_cast<void*>(ptrs[kInputs])),
        static_cast<float*>(const_cast<void*>(ptrs[kInputs + 1])), saved);
    return (int)cudaGetLastError();
}

// mlp_backward_f32's arguments (no unit ids, towers (64, 64)), and the saved buffer.
extern "C" int mlp_backward_saved_f32(const void* const* ptrs, int num_ptrs, long long n,
                                      int obs_dim, float* saved, void* stream) {
    Args a;
    if (num_ptrs != kInputs + 3 || ptrs[1] != nullptr || n < 1 ||
        !mlp_args(ptrs, n, 0, 0, obs_dim, kH, kH, &a))
        return (int)cudaErrorInvalidValue;
    const long long smem = shared_bytes<kH, kH>(obs_dim);
    cudaError_t err = allow_smem(backward_saved_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    backward_saved_kernel<<<dim3((unsigned)tiles_for(n), 2), kThreads, smem,
                            (cudaStream_t)stream>>>(
        a, static_cast<const float*>(ptrs[kInputs]),
        static_cast<const float*>(ptrs[kInputs + 1]),
        static_cast<float*>(const_cast<void*>(ptrs[kInputs + 2])), saved);
    return (int)cudaGetLastError();
}
