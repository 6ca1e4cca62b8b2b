// The actor's and critic's MLPs of the PPO minibatch step, forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's _mlp (self_play_racing_tpu/models/actor_critic.py:68)
// for actor_mu and critic_value inside _ppo_loss, and its gradient under
// jax.value_and_grad (self_play_racing_tpu/agent/ppo.py:313), which XLA compiles
// with the loss into the minibatch step's one program on the TPU. In PyTorch the
// same work is a cuBLAS GEMM, a bias add and a tanh a layer forward and
// tanh_backward, two GEMMs and a bias sum a layer backward (about 17 and 22
// launches a minibatch), each [n, hidden] activation making several round trips
// through device memory (self_play_racing_tpu_torch/models/actor_critic.py:_mlp).
//
// Towers: actor obs -> H1 -> H2 -> 2 with tanh after every layer, the last too;
// critic obs -> H1 -> H2 -> 1 with no tanh after the last. Weights are (in, out), a
// layer is x @ w + b.
//
// mlp_forward_f32: one launch, grid (tiles, 2): block (t, 0) runs the actor on rows
// [128 t, 128 t + 128), block (t, 1) the critic. A block stages its tower's weights
// and biases and the tile's observations (feature-major) in shared memory; each
// hidden layer is a product of the tile's activations and the shared weights in
// which a thread holds 4 rows x 8 columns in registers (3 16-byte shared loads to 32
// FMAs), then the bias and tanh, the activations staying in shared memory. Only mu
// [n, 2] and v [n] are written.
//
// mlp_backward_f32: one launch on the same grid. From d mu and d v (ppo_head's
// backward) a block recomputes its tile's forward (saving h1 and h2 of both towers
// would write and read 64 MiB at 65,536 rows; recomputing costs 10,816 of a row's
// 30,016 MACs), forms the tanh' products and the upper layers' input gradients
// (g3 = d out * (1 - out^2) for the actor, d v for the critic; g2 = (g3 W3^T) *
// (1 - h2^2); g1 = (g2 W2^T) * (1 - h1^2)) in place of the activations, and the
// tile's weight and bias gradients (x^T g1, h1^T g2, h2^T g3 and the row sums), a
// thread 4 x 8 of them over the tile's rows in order, which it writes as the
// tile's partial. No input gradient of the observations, no float atomics.
//
// mlp_grad_reduce_f32: out[p] = the sum of partial[t][p] over the tiles t: 8 groups
// of consecutive tiles, each summed in tile order, then the 8 group sums in order.
// The tiles, and so every sum's order, are a function of n alone (never of the
// card's SM count): equal inputs give equal bits, eager and in a CUDA graph. The
// partials and the output are flat in model.parameters() order (actor w1, b1, w2,
// b2, w3, b3, then the critic's), so the 12 gradients are views of the output.
//
// Every sum is a full float32 FFMA (__fmaf_rn: the build's -fmad=false contracts
// nothing else), no TF32, as torch.backends.cuda.matmul.allow_tf32 is False for the
// composition this replaces. A row's outputs depend on that row alone, in an order
// fixed by the kernel, so the forward is row-invariant. The sums run in another
// order than cuBLAS's: the kernels are held to the plain composition within a
// stated tolerance (chip_smoke.py phase p), not bitwise.
//
// The unit index: given unit ids (the minibatch's shuffle units), the observations
// are the rollout's units [units, block, obs_dim] (agent/ppo.py:shard_blocks) and
// minibatch row r is unit ids[r / block], offset r % block, read in place.
//
// Shapes: obs_dim is a run-time argument (every agent and sensor count); the hidden
// widths (h1, h2) are compile-time, (64, 64) and (128, 128) (MLP_HIDDEN below).
// A block's shared memory holds the tower's parameters and the tile's x, h1, h2:
// mlp_shared_bytes says whether an (obs_dim, h1, h2) fits the H100's 227 KB (at
// (64, 64) up to obs_dim 184, at (128, 128) up to 27).
//
// Bound on an H100 SXM at 65,536 rows of 19 inputs, towers (64, 64): the forward
// 10,816 MACs a row, the backward 19,200 (every weight gradient, the input
// gradients of the upper four layers): 3.9 GFLOP a minibatch, 59 us at 67 TFLOP/s
// of float32 FFMA; the bytes (the observations, mu, v, d mu, d v, the weights and
// gradients) ~15 MB, ~5 us. So both are bound by operations. What the design does
// about it: the products run from registers against shared memory (a 16-byte
// broadcast of the weights and one of the activations per 4 x 8 FMAs), no
// activation leaves the SM, and the weight gradients go out once a tile. The
// backward recomputes the forward (its 10,816 MACs a row, ~21 us at the bound) in
// place of reading saved activations (64 MiB written and read at 65,536 rows):
// scripts/mlp_save_vs_recompute.py times both designs.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;          // rows a tile: a block's
constexpr int kThreads = 128;       // the row-wise steps: a thread a row
constexpr int kStride = kRows + 4;  // floats between two features of a tile in shared memory
constexpr int kParams = 12;         // the towers' tensors in model.parameters() order
constexpr int kGroups = 8;          // the reduce's groups of consecutive tiles
constexpr int kReduceLanes = 32;    // parameters a reduce block
constexpr int kMaxSharedBytes = 232448;  // a block's shared memory on an H100

struct Args {
    const float* obs;            // [n, d], or [units, block, d] through the unit index
    const long long* unit_ids;   // [n / block] or null: the rows are obs's own
    const float* w[kParams];     // actor w1 b1 w2 b2 w3 b3, critic w1 b1 w2 b2 w3 b3
    long long n, block, units;
    int d;                       // obs_dim
};

// One tower's parameters, in model.parameters() order, as a block stages them and
// as a partial holds them; and the block's shared memory (floats): the parameters,
// then the tile's x [dp][kStride], a1 [H1][kStride], a2 [H2][kStride] and g3
// [O][kStride], features padded to dp = d rounded up to 4 with zero rows.
template <int H1, int H2, int O>
struct Layout {
    static_assert(H1 % 64 == 0 && H2 % 64 == 0, "the products' tasks assume widths of 64k");
    int d, dp, w1, b1, w2, b2, w3, b3, size, x, a1, a2, g3, floats;
    __host__ __device__ explicit Layout(int obs_dim)
        : d(obs_dim), dp((obs_dim + 3) / 4 * 4), w1(0), b1(obs_dim * H1), w2(b1 + H1),
          b2(w2 + H1 * H2), w3(b2 + H2), b3(w3 + H2 * O), size(b3 + O),
          x((size + 3) / 4 * 4), a1(x + dp * kStride), a2(a1 + H1 * kStride),
          g3(a2 + H2 * kStride), floats(g3 + O * kStride) {}
};

// the block's shared memory: the actor's layout, the larger of the two towers'
template <int H1, int H2>
long long shared_bytes(int obs_dim) { return 4LL * Layout<H1, H2, 2>(obs_dim).floats; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 make4(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
}

// where the observations hold minibatch row r
__device__ __forceinline__ long long source_row(const Args& a, long long r) {
    if (a.unit_ids == nullptr) return r;
    const long long u = a.unit_ids[r / a.block];
    if (u < 0 || u >= a.units) __trap();  // as index_select
    return u * a.block + r % a.block;
}

// The tower's six tensors into shared memory, and the tile's observations as [dp]
// features of kRows rows (rows past n and features past d zero): thread r reads row r.
template <int H1, int H2, int O>
__device__ void stage(const Args& a, const Layout<H1, H2, O>& L, const float* const* w,
                      float* s, long long row0) {
    const int offsets[6] = {L.w1, L.b1, L.w2, L.b2, L.w3, L.b3};
    const int sizes[6] = {L.d * H1, H1, H1 * H2, H2, H2 * O, O};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        for (int e = threadIdx.x; e < sizes[i]; e += kThreads) s[offsets[i] + e] = w[i][e];
    }
    float* x = s + L.x;
    const int r = threadIdx.x;
    const long long row = row0 + r;
    const float* src = row < a.n ? a.obs + source_row(a, row) * L.d : nullptr;
    for (int d = 0; d < L.dp; ++d) x[d * kStride + r] = (src && d < L.d) ? src[d] : 0.0f;
}

// C[r][c] = sum over k < K of A[k][r] B[k][c] for the tile's rows r and c < N: A the
// tile's K features [K][kStride], B [K][N] row-major (a weight). A task is 4 rows
// (lane) x 8 columns (warp, then every 4th); epi(r0, c0, acc) takes the sums.
template <int N, class Epi>
__device__ __forceinline__ void tile_times(const float* A, const float* B, int K, Epi epi) {
    constexpr int kTasks = (kRows / 4) * (N / 8);
    for (int t = threadIdx.x; t < kTasks; t += kThreads) {
        const int r0 = 4 * (t % (kRows / 4)), c0 = 8 * (t / (kRows / 4));
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            const float4 av = ld4(A + k * kStride + r0);
            const float4 b0 = ld4(B + k * N + c0), b1 = ld4(B + k * N + c0 + 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float ai = at(av, i);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = __fmaf_rn(ai, at(b0, j), acc[i][j]);
                    acc[i][j + 4] = __fmaf_rn(ai, at(b1, j), acc[i][j + 4]);
                }
            }
        }
        epi(r0, c0, acc);
    }
}

// C[r][c] = sum over k < K of A[k][r] W[c][k]: as tile_times with the weight W [N][K]
// read transposed (the backward's g2 W2^T), four k a step.
template <int K, int N, class Epi>
__device__ __forceinline__ void tile_times_transposed(const float* A, const float* W, Epi epi) {
    constexpr int kTasks = (kRows / 4) * (N / 8);
    for (int t = threadIdx.x; t < kTasks; t += kThreads) {
        const int r0 = 4 * (t % (kRows / 4)), c0 = 8 * (t / (kRows / 4));
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        for (int k = 0; k < K; k += 4) {
            float4 av[4], wv[8];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) av[kk] = ld4(A + (k + kk) * kStride + r0);
#pragma unroll
            for (int j = 0; j < 8; ++j) wv[j] = ld4(W + (c0 + j) * K + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = __fmaf_rn(at(av[kk], i), at(wv[j], kk), acc[i][j]);
        }
        epi(r0, c0, acc);
    }
}

// dst[j * N + c] = sum over the tile's rows r (in order) of A[j][r] B[c][r], for j < M
// (A's rows padded with zeros to MP, a multiple of 4) and c < N: a weight's gradient
// over the tile. A task is 4 j x 8 c, the c strided by N / 8 so that the 8 threads of
// a quarter warp read 8 bank groups of B.
template <int N>
__device__ __forceinline__ void rows_dot(const float* A, const float* B, int M, int MP,
                                         float* dst) {
    constexpr int kG = N / 8;
    const int tasks = (MP / 4) * kG;
    for (int t = threadIdx.x; t < tasks; t += kThreads) {
        const int cg = t % kG, j0 = 4 * (t / kG);
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        for (int r = 0; r < kRows; r += 4) {
            float4 av[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = ld4(A + (j0 + i) * kStride + r);
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = ld4(B + (cg + j * kG) * kStride + r);
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = __fmaf_rn(at(av[i], rr), at(bv[j], rr), acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (j0 + i >= M) break;
#pragma unroll
            for (int j = 0; j < 8; ++j) dst[(j0 + i) * N + cg + j * kG] = acc[i][j];
        }
    }
}

// dst[c] = sum over the tile's rows (in order) of B[c][r], c < N: a bias's gradient.
template <int N>
__device__ __forceinline__ void row_sums(const float* B, float* dst) {
    for (int c = threadIdx.x; c < N; c += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < kRows; r += 4) {
            const float4 b = ld4(B + c * kStride + r);
            s += b.x;
            s += b.y;
            s += b.z;
            s += b.w;
        }
        dst[c] = s;
    }
}

// The hidden layers on the staged tile: a1 = tanh(x W1 + b1), a2 = tanh(a1 W2 + b2).
template <int H1, int H2, int O>
__device__ __forceinline__ void hidden_forward(const Layout<H1, H2, O>& L, float* s) {
    const float* W = s;
    float* a1 = s + L.a1;
    float* a2 = s + L.a2;
    tile_times<H1>(s + L.x, W + L.w1, L.d, [&](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float b = W[L.b1 + c0 + j];
            float h[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) h[i] = tanhf(acc[i][j] + b);
            st4(a1 + (c0 + j) * kStride + r0, make4(h));
        }
    });
    __syncthreads();
    tile_times<H2>(a1, W + L.w2, H1, [&](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float b = W[L.b2 + c0 + j];
            float h[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) h[i] = tanhf(acc[i][j] + b);
            st4(a2 + (c0 + j) * kStride + r0, make4(h));
        }
    });
    __syncthreads();
}

// Row r's last layer: z[o] = sum over k of a2[k][r] W3[k][o] + b3[o], then tanh
// where kTanhOut.
template <int H1, int H2, int O, bool kTanhOut>
__device__ __forceinline__ void last_layer(const Layout<H1, H2, O>& L, const float* s, int r,
                                           float (&out)[O]) {
    const float* a2 = s + L.a2;
    float z[O];
#pragma unroll
    for (int o = 0; o < O; ++o) z[o] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < H2; ++k) {
        const float h = a2[k * kStride + r];
#pragma unroll
        for (int o = 0; o < O; ++o) z[o] = __fmaf_rn(h, s[L.w3 + k * O + o], z[o]);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) {
        const float y = z[o] + s[L.b3 + o];
        out[o] = kTanhOut ? tanhf(y) : y;
    }
}

template <int H1, int H2, int O, bool kTanhOut>
__device__ __forceinline__ void tower_forward(const Args& a, const float* const* w, float* s,
                                              float* out, long long row0) {
    const Layout<H1, H2, O> L(a.d);
    stage(a, L, w, s, row0);
    __syncthreads();
    hidden_forward(L, s);
    const int r = threadIdx.x;
    float y[O];
    last_layer<H1, H2, O, kTanhOut>(L, s, r, y);
    if (row0 + r < a.n) {
#pragma unroll
        for (int o = 0; o < O; ++o) out[(row0 + r) * O + o] = y[o];
    }
}

// Row r's upstream gradient d out (zero past n), read before the tile's forward.
template <int O>
__device__ __forceinline__ void upstream(const Args& a, const float* g_out, long long row0,
                                         float (&g3)[O]) {
    const long long row = row0 + threadIdx.x;
#pragma unroll
    for (int o = 0; o < O; ++o) g3[o] = row < a.n ? g_out[row * O + o] : 0.0f;
}

// The tile's weight and bias gradients from its staged x, a1 and a2 and each row's
// upstream gradient g3, into the tile's partial.
template <int H1, int H2, int O, bool kTanhOut>
__device__ __forceinline__ void tower_gradients(const Layout<H1, H2, O>& L, float (&g3)[O],
                                                float* s, float* part) {
    const float* W = s;
    float* a1 = s + L.a1;
    float* a2 = s + L.a2;
    float* g3s = s + L.g3;
    const int r = threadIdx.x;
    // g3 = d out * (1 - out^2) through the actor's tanh (autograd's tanh_backward),
    // d v as it is for the critic
    float y[O];
    last_layer<H1, H2, O, kTanhOut>(L, s, r, y);
#pragma unroll
    for (int o = 0; o < O; ++o) {
        if (kTanhOut) g3[o] = g3[o] * (1.0f - y[o] * y[o]);
        g3s[o * kStride + r] = g3[o];
    }
    __syncthreads();
    // W3's and b3's gradients: h2^T g3 and the sum of g3
    for (int t = threadIdx.x; t < H2 * O + O; t += kThreads) {
        float acc = 0.0f;
        if (t < H2 * O) {
            const int k = t / O, o = t % O;
            for (int i = 0; i < kRows; i += 4) {
                const float4 h = ld4(a2 + k * kStride + i), g = ld4(g3s + o * kStride + i);
                acc = __fmaf_rn(h.x, g.x, acc);
                acc = __fmaf_rn(h.y, g.y, acc);
                acc = __fmaf_rn(h.z, g.z, acc);
                acc = __fmaf_rn(h.w, g.w, acc);
            }
            part[L.w3 + t] = acc;
        } else {
            const int o = t - H2 * O;
            for (int i = 0; i < kRows; i += 4) {
                const float4 g = ld4(g3s + o * kStride + i);
                acc += g.x;
                acc += g.y;
                acc += g.z;
                acc += g.w;
            }
            part[L.b3 + o] = acc;
        }
    }
    __syncthreads();
    // g2 = (g3 W3^T) * (1 - h2^2), in place of row r's h2
#pragma unroll 4
    for (int k = 0; k < H2; ++k) {
        const float h = a2[k * kStride + r];
        float d = g3[0] * W[L.w3 + k * O];
#pragma unroll
        for (int o = 1; o < O; ++o) d = __fmaf_rn(g3[o], W[L.w3 + k * O + o], d);
        a2[k * kStride + r] = d * (1.0f - h * h);
    }
    __syncthreads();
    // W2's and b2's gradients: h1^T g2 and the sum of g2
    rows_dot<H2>(a1, a2, H1, H1, part + L.w2);
    row_sums<H2>(a2, part + L.b2);
    __syncthreads();
    // g1 = (g2 W2^T) * (1 - h1^2), each task in place of the h1 it reads
    tile_times_transposed<H2, H1>(a2, W + L.w2, [&](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float* p = a1 + (c0 + j) * kStride + r0;
            const float4 h = ld4(p);
            float g[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) g[i] = acc[i][j] * (1.0f - at(h, i) * at(h, i));
            st4(p, make4(g));
        }
    });
    __syncthreads();
    // W1's and b1's gradients: x^T g1 and the sum of g1
    rows_dot<H1>(s + L.x, a1, L.d, L.dp, part + L.w1);
    row_sums<H1>(a1, part + L.b1);
}

template <int H1, int H2, int O, bool kTanhOut>
__device__ __forceinline__ void tower_backward(const Args& a, const float* const* w,
                                               const float* g_out, float* s, float* part,
                                               long long row0) {
    const Layout<H1, H2, O> L(a.d);
    float g3[O];
    upstream(a, g_out, row0, g3);
    stage(a, L, w, s, row0);
    __syncthreads();
    hidden_forward(L, s);
    tower_gradients<H1, H2, O, kTanhOut>(L, g3, s, part);
}

// a tile's partial: both towers' parameters, the actor's first
template <int H1, int H2>
__device__ __forceinline__ int partial_floats(int d) {
    return Layout<H1, H2, 2>(d).size + Layout<H1, H2, 1>(d).size;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) mlp_forward_kernel(Args a, float* __restrict__ mu,
                                                               float* __restrict__ v) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const long long row0 = (long long)blockIdx.x * kRows;
    if (blockIdx.y == 0) {
        tower_forward<H1, H2, 2, true>(a, a.w, s, mu, row0);
    } else {
        tower_forward<H1, H2, 1, false>(a, a.w + 6, s, v, row0);
    }
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) mlp_backward_kernel(
        Args a, const float* __restrict__ g_mu, const float* __restrict__ g_v,
        float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const long long row0 = (long long)blockIdx.x * kRows;
    float* part = partial + (long long)blockIdx.x * partial_floats<H1, H2>(a.d);
    if (blockIdx.y == 0) {
        tower_backward<H1, H2, 2, true>(a, a.w, g_mu, s, part, row0);
    } else {
        tower_backward<H1, H2, 1, false>(a, a.w + 6, g_v, s,
                                         part + Layout<H1, H2, 2>(a.d).size, row0);
    }
}

// out[p] = sum over t of partial[t * params + p]: group g of kGroups sums its
// consecutive tiles in order, then the group sums in order.
__global__ void __launch_bounds__(kGroups * kReduceLanes) mlp_grad_reduce_kernel(
        const float* __restrict__ partial, float* __restrict__ out, long long tiles,
        long long params) {
    __shared__ float sums[kGroups][kReduceLanes];
    const int lane = threadIdx.x, g = threadIdx.y;
    const long long p = (long long)blockIdx.x * kReduceLanes + lane;
    const long long per = (tiles + kGroups - 1) / kGroups;
    const long long t0 = g * per, t1 = t0 + per < tiles ? t0 + per : tiles;
    float s = 0.0f;
    if (p < params) {
#pragma unroll 8
        for (long long t = t0; t < t1; ++t) s += partial[t * params + p];
    }
    sums[g][lane] = s;
    __syncthreads();
    if (g == 0 && p < params) {
        float total = sums[0][lane];
#pragma unroll
        for (int i = 1; i < kGroups; ++i) total += sums[i][lane];
        out[p] = total;
    }
}

long long tiles_for(long long n) { return (n + kRows - 1) / kRows; }

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    return bytes > 48 * 1024
        ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
        : cudaSuccess;
}

template <int H1, int H2>
int forward_launch(const Args& a, float* mu, float* v, cudaStream_t stream) {
    const long long smem = shared_bytes<H1, H2>(a.d);
    cudaError_t err = allow_smem(mlp_forward_kernel<H1, H2>, smem);
    if (err != cudaSuccess) return (int)err;
    mlp_forward_kernel<H1, H2><<<dim3((unsigned)tiles_for(a.n), 2), kThreads, smem, stream>>>(
        a, mu, v);
    return (int)cudaGetLastError();
}

template <int H1, int H2>
int backward_launch(const Args& a, const float* g_mu, const float* g_v, float* partial,
                    cudaStream_t stream) {
    const long long smem = shared_bytes<H1, H2>(a.d);
    cudaError_t err = allow_smem(mlp_backward_kernel<H1, H2>, smem);
    if (err != cudaSuccess) return (int)err;
    mlp_backward_kernel<H1, H2><<<dim3((unsigned)tiles_for(a.n), 2), kThreads, smem, stream>>>(
        a, g_mu, g_v, partial);
    return (int)cudaGetLastError();
}

// the instantiated hidden widths (h1, h2): ops/_cuda.py:MLP_HIDDEN
#define MLP_HIDDEN(X) X(64, 64) X(128, 128)

// the block's shared bytes at (obs_dim, h1, h2), or 0 where the kernels do not
// take it: widths not instantiated, obs_dim < 1, or more than a block may hold
long long takes(int obs_dim, int h1, int h2) {
    if (obs_dim < 1) return 0;
#define MLP_TAKES(w1, w2)                                                        \
    if (h1 == w1 && h2 == w2) {                                                  \
        const long long bytes = shared_bytes<w1, w2>(obs_dim);                    \
        return bytes <= kMaxSharedBytes ? bytes : 0;                              \
    }
    MLP_HIDDEN(MLP_TAKES)
#undef MLP_TAKES
    return 0;
}

constexpr int kInputs = 2 + kParams;  // obs, unit ids, the 12 parameters

// the arguments, or false where they are not valid
bool mlp_args(const void* const* ptrs, long long n, long long block, long long units,
              int obs_dim, int h1, int h2, Args* out) {
    Args a;
    a.obs = static_cast<const float*>(ptrs[0]);
    a.unit_ids = static_cast<const long long*>(ptrs[1]);
    for (int i = 0; i < kParams; ++i) a.w[i] = static_cast<const float*>(ptrs[2 + i]);
    a.n = n;
    a.block = block;
    a.units = units;
    a.d = obs_dim;
    if (takes(obs_dim, h1, h2) == 0) return false;
    if (n < 0 || (n > 0 && tiles_for(n) > 0x7fffffffLL)) return false;
    if (a.unit_ids != nullptr && (block < 1 || n % block != 0 || units < 1)) return false;
    *out = a;
    return true;
}

}  // namespace

// The block's shared bytes for (obs_dim, h1, h2), or 0 where the kernels below do
// not take it (hidden widths other than MLP_HIDDEN, or a block's memory exceeded).
extern "C" int mlp_shared_bytes(int obs_dim, int h1, int h2) {
    return (int)takes(obs_dim, h1, h2);
}

// The forward: ptrs the obs (float32 contiguous), the unit ids (int64, or null) and
// the 12 parameters in model.parameters() order, then mu [n, 2] and v [n] out;
// block and units: the observations' [units, block] with ids (ignored without).
// (obs_dim, h1, h2) one that mlp_shared_bytes takes. Returns a cudaError_t.
extern "C" int mlp_forward_f32(const void* const* ptrs, int num_ptrs, long long n,
                               long long block, long long units, int obs_dim, int h1,
                               int h2, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Args a;
    if (num_ptrs != kInputs + 2 || !mlp_args(ptrs, n, block, units, obs_dim, h1, h2, &a))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    float* mu = static_cast<float*>(const_cast<void*>(ptrs[kInputs]));
    float* v = static_cast<float*>(const_cast<void*>(ptrs[kInputs + 1]));
#define MLP_FORWARD(w1, w2) \
    if (h1 == w1 && h2 == w2) return forward_launch<w1, w2>(a, mu, v, (cudaStream_t)stream);
    MLP_HIDDEN(MLP_FORWARD)
#undef MLP_FORWARD
    return (int)cudaErrorInvalidValue;
}

// The backward: ptrs as the forward's inputs, then d mu [n, 2] and d v [n]
// (contiguous) and the partials [tiles(n), params] out, params the 12 tensors'
// elements. Returns a cudaError_t.
extern "C" int mlp_backward_f32(const void* const* ptrs, int num_ptrs, long long n,
                                long long block, long long units, int obs_dim, int h1,
                                int h2, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Args a;
    if (num_ptrs != kInputs + 3 || !mlp_args(ptrs, n, block, units, obs_dim, h1, h2, &a))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const float* g_mu = static_cast<const float*>(ptrs[kInputs]);
    const float* g_v = static_cast<const float*>(ptrs[kInputs + 1]);
    float* partial = static_cast<float*>(const_cast<void*>(ptrs[kInputs + 2]));
#define MLP_BACKWARD(w1, w2)                                                      \
    if (h1 == w1 && h2 == w2)                                                     \
        return backward_launch<w1, w2>(a, g_mu, g_v, partial, (cudaStream_t)stream);
    MLP_HIDDEN(MLP_BACKWARD)
#undef MLP_BACKWARD
    return (int)cudaErrorInvalidValue;
}

// The rows a tile of the two kernels above: partials are [ceil(n / this), params].
extern "C" int mlp_rows_per_tile() { return kRows; }

// out[p] (params floats) = the sum over tiles of partial[t][p], in the order above.
extern "C" int mlp_grad_reduce_f32(const float* partial, float* out, long long tiles,
                                   long long params, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (tiles < 1 || params < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (params + kReduceLanes - 1) / kReduceLanes;
    mlp_grad_reduce_kernel<<<(unsigned)blocks, dim3(kReduceLanes, kGroups), 0,
                             (cudaStream_t)stream>>>(partial, out, tiles, params);
    return (int)cudaGetLastError();
}

extern "C" const char* mlp_towers_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
