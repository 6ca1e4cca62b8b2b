// The actor's and critic's MLPs of the PPO minibatch step on the general route:
// towers of any depth (1 to 7 hidden layers) and width (1 to 1024, obs_dim 1 to
// 1024), forward and backward, for NVIDIA Hopper (sm_90a), their products on the
// tensor cores in 3xTF32 (mma.sync.m16n8k8).
//
// Replaces the JAX package's _mlp (self_play_racing_tpu/models/actor_critic.py:68)
// for actor_mu and critic_value inside _ppo_loss, and its gradient under
// jax.value_and_grad (self_play_racing_tpu/agent/ppo.py:313), for the towers that
// the compiled route (mlp_towers.cu: three layers at (64, 64) and (128, 128)) does
// not take. In PyTorch the same work is a cuBLAS GEMM, a bias add and a tanh a layer
// forward, and autograd's two GEMMs, tanh_backward and a bias sum a layer backward.
//
// Bounds on an H100 SXM at 65,536 rows of 19 inputs, towers (256, 256): both towers
// 141,568 multiply-adds a row forward, 273,408 of the backward's own (every weight
// gradient, the input gradients of all but the first layer) and the forward it
// recomputes; as 3xTF32 at 495 TFLOP/s 112 us forward, 217 + 112 us backward. The
// bytes they must move (observations, mu, v, the weights, the partials) are a few
// MB: bound by operations. mma.sync reaches ~211 TFLOP/s on this card
// (scripts/mma_tf32_rate.cu), so ~2.3x those floors is what this design can approach.
//
// Layer-major: both entries run the minibatch a layer at a time, each layer one
// launch over the whole card, the activations in device scratch between launches. A
// (256, 256) weight (256 KB) does not fit a block; streaming every weight through
// shared memory for each tile of 32 or 64 rows ran the products at a third of
// mma.sync's rate, and a weight gradient summed a tile at a time on a partial row in
// device memory made 35% of the backward. Here a block's tile is 128 x 128 outputs (8
// warps of 32 x 64), each staged chunk (16 deep, a ring of three) feeds 48 mma.sync a
// warp, a weight gradient's block sums its chunk of 512 rows (or more) in registers
// and writes once, and the output tile leaves through shared memory in 16-byte
// stores. The rows go in slabs of the scratch budget's rows (one slab at (19, 256,
// 256) and 65,536 rows). A kernel a job kind (layer_kernel<kLayer | kGprop | kWgrad>),
// so that each has its own registers.
//
// The products: C[m][n] = the sum over k of A[m][k] B[k][n], each element's k-steps
// of 8 in order from k = 0, each k-step's three TF32 products lo*hi, hi*lo, hi*hi
// from zero on the tensor cores, then one float32 add rounded to nearest onto the
// element's sum (mlp_stream.cuh's mma3: the tensor cores' own accumulation drifts
// over a long k, and a weight gradient sums thousands of rows). So a forward element
// is mlp_stream.cuh's per-tile sequence exactly, whatever the tile: mu and v are
// bitwise what the general policy kernels (policy_general.cu) give the row. The
// weights are split into TF32 hi/lo once a call (split_kernel) and staged as (hi, lo)
// pairs; the activations are split where a warp loads them.
//
// mlp_general_forward_f32, a slab: split_kernel, then a layer launch a hidden layer
// (both towers: tanh(x W + b), the observations read through the unit ids for the
// first), then rows_kernel (a warp a row: the narrow layer, lane l its features l,
// l + 32, ... by fmaf in order, the butterfly, the bias, tanh for the actor) writes
// mu and v. With `keep` (the minibatch step's forward, where the backward's scratch
// is one slab) every hidden layer's activations and the split weights stay in the
// backward's scratch, which the backward then reads (`saved`) instead of computing
// them again.
//
// mlp_general_backward_f32, a slab: the forward's launches with every hidden layer's
// activations kept (unless saved), rows_kernel's backward mode (the narrow layer
// again, g3 = the upstream gradient through the actor's tanh, and G_L = (g3 W^T) (1 -
// h^2)), then two launches a layer l from the top: the weight gradient H_{l-1}^T G_l
// (a kWgrad job: its blocks a 128 x 128 tile of the gradient over a chunk of
// chunk_rows rows, the bias sums in float64 over the same rows, each into the chunk's
// partial row; at the top also the narrow layer's H_L^T g3), then G_{l-1} = G_l W_l^T
// (1 - h^2) for the layer below (a kGprop job). One partial row a chunk of the
// minibatch's rows, at most 128; then general_grad_reduce_f32 (below) sums them and
// forms the global norm. Every sum's order is a function of the shape and n: equal
// inputs give equal bits, eager and in a CUDA graph, kept or computed again; no
// float atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_stream.cuh"

namespace {

using namespace mlp_stream;
using mlp_tower::FragA;
using mlp_tower::FragB;

constexpr int kBM = 128;                   // a tile's rows (m)
constexpr int kBN = 128;                   // a tile's columns (n)
constexpr int kBK = 16;                    // the contraction of a staged chunk: two k-steps
constexpr int kRing = 3;                   // staged chunks: two in flight ahead of the one read
constexpr int kFM = 2;                     // a warp's m16 fragments: 32 rows
constexpr int kFN = 8;                     // a warp's n8 tiles: 64 columns
constexpr int kWarpsM = kBM / (16 * kFM);  // a layer launch's block: 4 (m) x 2 (n) warps
constexpr int kWarpsN = kBN / (8 * kFN);
constexpr int kWarps = kWarpsM * kWarpsN;
constexpr int kThreads = 32 * kWarps;
// blocks an SM, so 128 registers a thread: a few bytes spill (4-18), and one block of 8
// warps an SM without spills (204 registers) was 20-25% slower on an H100
constexpr int kMinBlocks = 2;
constexpr int kRowWarps = 8;               // rows_kernel: a warp a row
constexpr int kRowBlocks = 528;            // rows_kernel's blocks a tower at most: with
                                           // both, 8 blocks an SM
constexpr int kMinChunkRows = 512;         // the rows a partial row sums, at least
constexpr int kMaxPartialRows = 128;       // partial rows, at most
constexpr long long kScratchBudget = 1LL << 28;  // a call's scratch floats, about
constexpr int kMaxJobs = 4;                // jobs a layer launch
constexpr int kSplitBlocks = 264;          // split_kernel's blocks a tower
constexpr int kGroups = 8;                 // the reduce's groups of consecutive rows
constexpr int kReduceLanes = 32;           // parameters a reduce block

// A staged chunk's tiles (floats), each laid so that a warp's fragment loads fall on
// 32 banks: A by rows [kBM][kAK] (k contiguous); B a split weight by contraction
// [kBK][kBNs] or by column [kBN][kBKs], (hi, lo) pairs. A weight gradient's chunk
// (wgrad_tile) lays its rows of H and G by contraction at the tile's widths + 8.
constexpr int kAK = kBK + 4;
constexpr int kBNs = 2 * kBN + 8;
constexpr int kBKs = 2 * kBK + 8;
constexpr int kAFloats = kBM * kAK;
constexpr int kBFloats = kBN * kBKs > kBK * kBNs ? kBN * kBKs : kBK * kBNs;
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kLayerSharedBytes = 4 * kRing * kStageFloats;  // 92,160: two blocks an SM
static_assert(kWarps * 16 * kFM * (8 * kFN + 8) <= kRing * kStageFloats
                  && 8 * (kBM + kBN + 16) <= kStageFloats,
              "the output tile's regions fit the ring, a weight gradient's 8 rows a slot");

// A job's products: a hidden layer's tanh(A W + b) (A the previous layer's
// activations or the observations); g W^T (1 - h^2) for the layer below; a weight
// gradient H^T G over a chunk's rows with its bias sums (the narrow layer's too, G
// then g3).
enum JobKind { kLayer = 0, kGprop = 1, kWgrad = 2 };

// Both towers: the shape, and each tower's weights and biases a layer (the actor's
// 2 outputs, the critic's 1).
struct Net {
    Shape s;
    const float* w[2][kMaxLayers];
    const float* b[2][kMaxLayers];
};

struct Rows {
    const float* obs;           // [n, d], or [units, block, d] through the unit ids
    const long long* unit_ids;  // [n / block] or null
    long long n, block, units;
    int d;
};

// where the observations hold minibatch row r (null past n)
__device__ __forceinline__ const float* row_at(const Rows& a, long long r) {
    if (r >= a.n) return nullptr;
    if (a.unit_ids == nullptr) return a.obs + r * a.d;
    const long long u = a.unit_ids[r / a.block];
    if (u < 0 || u >= a.units) __trap();  // as index_select
    return a.obs + (u * a.block + r % a.block) * a.d;
}

// One job of a layer launch: C [M][N] over the contraction K (kWgrad: over a chunk's
// rows, K unused). a: A's rows at lda floats (null: the observations), or kWgrad's
// H; b: a split weight [K][2 round_up(N, 2)] (kLayer), [N][2 round_up(K, 2)]
// (kGprop), or G's rows at ldb (kWgrad; the narrow layer's g3 [rows][4]); out at ldo (the
// slab's rows) or, for the gradients, the partials' first row's place of the weight
// (bias_out: of the bias). tiles_n tiles across, tiles_mn a part, tiles in all.
struct Job {
    int kind, M, N, K, tiles_n, tiles_mn, tiles;
    const float* a;
    long long lda;
    const float* b;
    long long ldb;
    const float* bias;
    const float* h;
    long long ldh;
    float* out;
    long long ldo;
    float* bias_out;
};

// A layer launch: its jobs (blocks [first[j], first[j + 1]) job j's), the slab's rows
// [row0, row0 + rows) of the minibatch, and the partial rows: a part a chunk of
// chunk_rows slab rows, the slab's first part row part0, part_stride floats a row.
struct Launch {
    Job job[kMaxJobs];
    int first[kMaxJobs + 1];
    int jobs, rows, chunk_rows;
    Rows obs;
    long long row0, part0, part_stride;
};

// row i of the slab in a rows operand: a's own, or the observations' (a null);
// null past the slab
__device__ __forceinline__ const float* rows_at(const Launch& L, const float* a, long long lda,
                                                int i) {
    if (i >= L.rows) return nullptr;
    return a != nullptr ? a + i * lda : row_at(L.obs, L.row0 + i);
}

__device__ __forceinline__ bool wide_rows(const float* a, long long lda) {
    return mlp_tower::aligned16(a) && (lda & 3) == 0;
}

// `lines` lines of (4 << shift) floats into dst (line stride ls): line i from src(i)
// (null: zeros), its floats [0, valid) real and the rest zero; 16 bytes a copy where
// the lines are 16-byte aligned (`wide`) and a group lies whole in [0, valid), 16
// bytes of zeros where none of it does (`any`: a 16-byte aligned address that is not
// read), else a float a copy. Only the first `lines_read` lines and `width_read`
// floats (a multiple of 4), what the tile's active warps read, are staged. The caller
// commits.
__host__ __device__ constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }

template <class Src>
__device__ __forceinline__ void stage_lines(float* dst, int ls, int lines, int shift, Src src,
                                            int valid, bool wide, const float* any,
                                            int lines_read, int width_read) {
    for (int e = threadIdx.x; e < lines << shift; e += kThreads) {
        const int line = e >> shift, c = 4 * (e & ((1 << shift) - 1));
        if (line >= lines_read || c >= width_read) continue;
        const float* s = src(line);
        float* d = dst + line * ls + c;
        if (s == nullptr || c >= valid) {
            mlp_tower::cp_async16(d, any, false);
        } else if (wide && c + 4 <= valid) {
            mlp_tower::cp_async16(d, s + c, true);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const bool ok = c + q < valid;
                mlp_tower::cp_async4(d + q, ok ? s + c + q : any, ok);
            }
        }
    }
}

// the split script's variant without the split: hi the raw bits, lo zero
__device__ __forceinline__ FragA raw_a(float a0, float a1, float a2, float a3) {
    return {{__float_as_uint(a0), __float_as_uint(a1), __float_as_uint(a2), __float_as_uint(a3)},
            {0u, 0u, 0u, 0u}};
}
__device__ __forceinline__ FragB raw_b(float b0, float b1) {
    return {{__float_as_uint(b0), __float_as_uint(b1)}, {0u, 0u}};
}
// an A fragment's TF32 hi/lo (mlp_tower.cuh's split, as the per-tile routine's)
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
    // split: any no_split return raw_a(a0, a1, a2, a3);
    return mlp_tower::frag_a(a0, a1, a2, a3);
}
__device__ __forceinline__ FragB split_b(float b0, float b1) {
    // split: any no_split return raw_b(b0, b1);
    return mlp_tower::frag_b(b0, b1);
}
// a pre-split (hi, lo) pair's B fragment: rows t and t + 4 at p0, p1
__device__ __forceinline__ FragB pair_b(const float* p0, const float* p1) {
    const float2 x = *reinterpret_cast<const float2*>(p0);
    const float2 y = *reinterpret_cast<const float2*>(p1);
    return {{__float_as_uint(x.x), __float_as_uint(y.x)},
            {__float_as_uint(x.y), __float_as_uint(y.y)}};
}

// One k-step (k kl .. kl + 7 of the staged chunk) of a warp's 32 x 64 outputs; la and
// lb the A and B tiles' line strides.
template <int kKind>
__device__ __forceinline__ void k_step(const float* As, const float* Bs, int la, int lb, int kl,
                                       int wm, int wn, int g, int t, float (&acc)[kFM][kFN][4]) {
    FragA fa[kFM];
#pragma unroll
    for (int f = 0; f < kFM; ++f) {
        const int ra = wm + 16 * f + g, rb = ra + 8;
        fa[f] = kKind == kWgrad
            ? split_a(As[(kl + t) * la + ra], As[(kl + t) * la + rb],
                      As[(kl + t + 4) * la + ra], As[(kl + t + 4) * la + rb])
            : split_a(As[ra * la + kl + t], As[rb * la + kl + t], As[ra * la + kl + t + 4],
                      As[rb * la + kl + t + 4]);
    }
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
        const int n = wn + 8 * j + g;
        FragB fb;
        if (kKind == kLayer)
            fb = pair_b(Bs + (kl + t) * lb + 2 * n, Bs + (kl + t + 4) * lb + 2 * n);
        else if (kKind == kGprop)
            fb = pair_b(Bs + n * lb + 2 * (kl + t), Bs + n * lb + 2 * (kl + t + 4));
        else
            fb = split_b(Bs[(kl + t) * lb + n], Bs[(kl + t + 4) * lb + n]);
#pragma unroll
        for (int f = 0; f < kFM; ++f) mma3(acc[f][j], fa[f], fb);
    }
}

// The block's outputs out (rows x cols at line stride ld) from the warps' sums: each
// group gk of warps' in its region of the ring (rows of ls floats, wm_n 32-row warps
// down), every warp done with the ring; the groups' sums added in order, then
// kLayer's tanh(v + b) or kGprop's v (1 - h^2); 16 bytes a store where the row allows.
template <int kKind>
__device__ __forceinline__ void store_tile(const Job& J, int m0, int n0, int rows, int cols,
                                           float* out, long long ld, float* ring, int wm_n,
                                           int wn_n, int kg, int gk, int wm, int wn, bool active,
                                           const float (&acc)[kFM][kFN][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int ls = 8 * kFN * wn_n + 8, region = 16 * kFM * wm_n * ls;
    __syncthreads();
    if (active) {
        float* cs = ring + gk * region;
#pragma unroll
        for (int f = 0; f < kFM; ++f)
#pragma unroll
            for (int j = 0; j < kFN; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<float2*>(cs + (wm + 16 * f + g + 8 * h) * ls + wn + 8 * j
                                               + 2 * t) =
                        make_float2(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
    }
    __syncthreads();
    const bool wide = wide_rows(out, ld);
    const int groups = (cols + 3) / 4;
    for (int e = threadIdx.x; e < rows * groups; e += kThreads) {
        const int r = e / groups, c = 4 * (e - r * groups);
        float v[4];
        *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(ring + r * ls + c);
        for (int k = 1; k < kg; ++k) {
            const float4 w = *reinterpret_cast<const float4*>(ring + k * region + r * ls + c);
            v[0] += w.x;
            v[1] += w.y;
            v[2] += w.z;
            v[3] += w.w;
        }
        const int q_end = cols - c < 4 ? cols - c : 4;
        if (kKind == kLayer) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q < q_end) v[q] = tanhf(v[q] + J.bias[n0 + c + q]);
        } else if (kKind == kGprop) {
            const float* hr = J.h + (m0 + r) * J.ldh + n0 + c;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q < q_end) v[q] *= 1.0f - hr[q] * hr[q];
        }
        float* o = out + r * ld + c;
        if (wide && q_end == 4) {
            *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(v);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q < q_end) o[q] = v[q];
        }
    }
}

__device__ __forceinline__ void zero(float (&acc)[kFM][kFN][4]) {
#pragma unroll
    for (int f = 0; f < kFM; ++f)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.0f;
}

// A kLayer or kGprop block's tile (tm, tn) over the contraction K, the warps 4 (m) x 2
// (n) of 32 x 64, through a ring of kRing staged chunks of kBK (one commit group each,
// one barrier a chunk). A warp whose rows or columns all lie past the real ones skips
// the products, and what no active warp reads is not staged.
template <int kKind>
__device__ void layer_tile(const Launch& L, const Job& J, int tm, int tn, float* ring) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = kBM * tm, n0 = kBN * tn;
    const int wm = 16 * kFM * (warp / kWarpsN), wn = 8 * kFN * (warp % kWarpsN);
    const int chunks = (J.K + kBK - 1) / kBK;
    const bool active = m0 + wm < J.M && n0 + wn < J.N;
    const int m_read = min(kBM, round_up(J.M - m0, 16 * kFM));
    const int n_read = min(kBN, round_up(J.N - n0, 8 * kFN));
    const bool a_wide = J.a != nullptr ? wide_rows(J.a, J.lda) : wide_rows(L.obs.obs, L.obs.d);
    const bool b_wide = wide_rows(J.b, J.ldb);
    constexpr int la = kAK, lb = kKind == kLayer ? kBNs : kBKs;
    auto stage = [&](int c) {
        if (c < chunks) {
            float* As = ring + (c % kRing) * kStageFloats;
            float* Bs = As + kAFloats;
            const int k0 = c * kBK;
            // A: the tile's rows m0.., their k0..; B: the weight's rows k0.. and columns
            // n0.. (kLayer) or rows n0.. and columns k0.. (kGprop), (hi, lo) pairs
            stage_lines(As, la, kBM, log2i(kBK / 4), [&](int i) {
                const float* r = m0 + i < J.M ? rows_at(L, J.a, J.lda, m0 + i) : nullptr;
                return r != nullptr ? r + k0 : nullptr;
            }, J.K - k0, a_wide, J.b, m_read, kBK);
            if (kKind == kLayer)
                stage_lines(Bs, lb, kBK, log2i(2 * kBN / 4), [&](int i) {
                    return k0 + i < J.K ? J.b + (k0 + i) * J.ldb + 2 * n0 : nullptr;
                }, 2 * (J.N - n0), b_wide, J.b, kBK, 2 * n_read);
            else
                stage_lines(Bs, lb, kBN, log2i(2 * kBK / 4), [&](int i) {
                    return n0 + i < J.N ? J.b + (n0 + i) * J.ldb + 2 * k0 : nullptr;
                }, 2 * (J.K - k0), b_wide, J.b, n_read, 2 * kBK);
        }
        mlp_tower::cp_async_commit();
    };
    float acc[kFM][kFN][4];
    zero(acc);
#pragma unroll
    for (int c = 0; c < kRing - 1; ++c) stage(c);
    for (int c = 0; c < chunks; ++c) {
        mlp_tower::cp_async_wait<kRing - 2>();  // chunk c has landed
        __syncthreads();  // every thread's copies of it; every warp done with chunk c - 1
        stage(c + kRing - 1);  // into chunk c - 1's slot
        const float* As = ring + (c % kRing) * kStageFloats;
        const float* Bs = As + kAFloats;
        if (active) {
            k_step<kKind>(As, Bs, la, lb, 0, wm, wn, g, t, acc);
            if (J.K - c * kBK > 8) k_step<kKind>(As, Bs, la, lb, 8, wm, wn, g, t, acc);
        }
    }
    store_tile<kKind>(J, m0, n0, min(kBM, J.M - m0), min(kBN, J.N - n0), J.out + m0 * J.ldo + n0,
                      J.ldo, ring, kWarpsM, kWarpsN, 1, 0, wm, wn, active, acc);
}

// A kWgrad block's tile (tm, tn) of H^T G over part `part`'s rows into the part's
// partial row, with the bias sums. Its rows a staged chunk as many as the ring's slot
// holds at the tile's widths (up to 64: a narrow layer's gradient stages 64 rows a
// chunk, a 128 x 128 tile 24), its warps the tile's 32 x 64 pieces, wm_n x wn_n, and
// the kg = kWarps / (wm_n wn_n) groups of them each the same outputs over every kg-th
// k-step (group gk from k-step gk), the groups' sums added in order at the end: so a
// narrow tile keeps every warp busy and few chunks in flight cover its rows. The
// bias sums: a thread a column of the tiles at m0 = 0, its rows in order in float64.
__device__ void wgrad_tile(const Launch& L, const Job& J, int tm, int tn, int part, float* ring) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = kBM * tm, n0 = kBN * tn;
    const int rows = min(kBM, J.M - m0), cols = min(kBN, J.N - n0);
    int wm_n = kWarpsM, wn_n = kWarpsN;
    while (wm_n > 1 && (wm_n / 2) * 16 * kFM >= rows) wm_n /= 2;
    while (wn_n > 1 && (wn_n / 2) * 8 * kFN >= cols) wn_n /= 2;
    const int kg = kWarps / (wm_n * wn_n), gk = warp / (wm_n * wn_n);
    const int wq = warp - gk * wm_n * wn_n;
    const int wm = 16 * kFM * (wq / wn_n), wn = 8 * kFN * (wq % wn_n);
    // the staged widths (powers of 2) and line strides, the rows a chunk
    const int m_read = 16 * kFM * wm_n, n_read = 8 * kFN * wn_n;
    const int la = m_read + 8, lb = n_read + 8;
    int ck = kStageFloats / (la + lb) / 8 * 8;
    ck = ck < 64 ? ck : 64;
    const int kbeg = part * L.chunk_rows, kend = min(kbeg + L.chunk_rows, L.rows);
    const int chunks = (kend - kbeg + ck - 1) / ck;
    const bool a_wide = J.a != nullptr ? wide_rows(J.a, J.lda) : wide_rows(L.obs.obs, L.obs.d);
    const bool b_wide = wide_rows(J.b, J.ldb);
    const int a_shift = __ffs(m_read / 4) - 1, b_shift = __ffs(n_read / 4) - 1;
    auto stage = [&](int c) {
        if (c < chunks) {
            float* As = ring + (c % kRing) * kStageFloats;
            float* Bs = As + ck * la;
            const int k0 = kbeg + c * ck;
            // A: rows k0.. of H, its features m0..; B: rows k0.. of G, columns n0..
            stage_lines(As, la, ck, a_shift, [&](int i) {
                const float* r = k0 + i < kend ? rows_at(L, J.a, J.lda, k0 + i) : nullptr;
                return r != nullptr ? r + m0 : nullptr;
            }, J.M - m0, a_wide, J.b, ck, m_read);
            stage_lines(Bs, lb, ck, b_shift, [&](int i) {
                return k0 + i < kend ? J.b + (k0 + i) * J.ldb + n0 : nullptr;
            }, J.N - n0, b_wide, J.b, ck, n_read);
        }
        mlp_tower::cp_async_commit();
    };
    float acc[kFM][kFN][4];
    zero(acc);
    const bool bias_sums = tm == 0 && (int)threadIdx.x < cols;
    double bsum = 0.0;
#pragma unroll
    for (int c = 0; c < kRing - 1; ++c) stage(c);
    for (int c = 0; c < chunks; ++c) {
        mlp_tower::cp_async_wait<kRing - 2>();  // chunk c has landed
        __syncthreads();  // every thread's copies of it; every warp done with chunk c - 1
        stage(c + kRing - 1);  // into chunk c - 1's slot
        const float* As = ring + (c % kRing) * kStageFloats;
        const float* Bs = As + ck * la;
        const int steps = (min(ck, kend - kbeg - c * ck) + 7) / 8;
        // the chunk's k-steps of group gk: global k-step c ck / 8 + ks = gk mod kg
        for (int ks = (gk - c * (ck / 8) % kg + kg) % kg; ks < steps; ks += kg)
            k_step<kWgrad>(As, Bs, la, lb, 8 * ks, wm, wn, g, t, acc);
        if (bias_sums)
            for (int i = 0; i < ck; ++i) bsum += (double)Bs[i * lb + threadIdx.x];
    }
    const long long row = (L.part0 + part) * L.part_stride;
    if (bias_sums) J.bias_out[row + n0 + threadIdx.x] = (float)bsum;
    store_tile<kWgrad>(J, m0, n0, rows, cols, J.out + row + (long long)m0 * J.N + n0, J.N, ring,
                       wm_n, wn_n, kg, gk, wm, wn, true, acc);
}

// A layer launch: every job of one kind, a kernel a kind so that each has its own
// registers.
template <int kKind>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    layer_kernel(const __grid_constant__ Launch L) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    int j = 0;
    while (j + 1 < L.jobs && (int)blockIdx.x >= L.first[j + 1]) ++j;
    const Job& J = L.job[j];
    const int t = blockIdx.x - L.first[j];
    const int part = t / J.tiles_mn, mn = t - part * J.tiles_mn;
    const int tm = mn / J.tiles_n, tn = mn - tm * J.tiles_n;
    if constexpr (kKind == kWgrad)
        wgrad_tile(L, J, tm, tn, part, ring);
    else
        layer_tile<kKind>(L, J, tm, tn, ring);
}

// Each tower's hidden weights as (hi, lo) TF32 pairs: out[l] [K][2 round_up(N, 2)],
// zero past N.
struct SplitArgs {
    const float* w[2][kMaxHidden];
    float* out[2][kMaxHidden];
    int K[kMaxHidden], N[kMaxHidden];
    int layers;
};

__global__ void __launch_bounds__(kThreads) split_kernel(const __grid_constant__ SplitArgs A) {
    const int tw = blockIdx.y;
    for (int l = 0; l < A.layers; ++l) {
        const int N = A.N[l], Np = round_up(N, 2);
        const long long count = (long long)A.K[l] * Np;
        for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < count;
             e += (long long)gridDim.x * kThreads) {
            const long long k = e / Np;
            const int c = (int)(e - k * Np);
            uint32_t hi = 0u, lo = 0u;
            if (c < N) mlp_tower::split(A.w[tw][l][k * N + c], hi, lo);
            reinterpret_cast<uint2*>(A.out[tw][l])[e] = make_uint2(hi, lo);
        }
    }
}

// The narrow layer of the slab's rows, a warp a row, both towers (blockIdx.y): the
// forward writes mu and v; the backward g3 [rows][4] (zero past the outputs) and G_L.
struct RowArgs {
    const float* h[2];  // each tower's last hidden layer [rows][ldh]
    const float* w[2];  // the narrow layer [K][O]
    const float* b[2];
    long long ldh, row0, ldg;
    int K, rows, backward;
    float* mu;
    float* v;
    const float* g_mu;
    const float* g_v;
    float* g3[2];
    float* gl[2];       // G_L [rows][ldg]
};

// row i of tower tw (O outputs): the narrow layer, then the forward's mu or v, or the
// backward's g3 and G_L; a warp's
__device__ __forceinline__ void narrow_row(const RowArgs& A, int tw, int O, int i, int lane) {
    const float* x = A.h[tw] + i * A.ldh;
    const float* w = A.w[tw];
    const long long row = A.row0 + i;
    float y[2] = {0.0f, 0.0f};
    for (int o = 0; o < O; ++o) {
        float z = 0.0f;
        for (int k = lane; k < A.K; k += 32) z = __fmaf_rn(x[k], w[k * O + o], z);
        z = mlp_tower::lanes_sum(z, 1, 16) + A.b[tw][o];
        y[o] = O == 2 ? tanhf(z) : z;
    }
    if (!A.backward) {
        if (lane == 0) {
            if (tw == 0) {
                A.mu[2 * row] = y[0];
                A.mu[2 * row + 1] = y[1];
            } else {
                A.v[row] = y[0];
            }
        }
        return;
    }
    // g3 through the actor's tanh (autograd's tanh_backward), d v as it is
    float g0, g1 = 0.0f;
    if (tw == 0) {
        g0 = A.g_mu[2 * row] * (1.0f - y[0] * y[0]);
        g1 = A.g_mu[2 * row + 1] * (1.0f - y[1] * y[1]);
    } else {
        g0 = A.g_v[row];
    }
    if (lane < 4) A.g3[tw][4 * i + lane] = lane == 0 ? g0 : lane == 1 ? g1 : 0.0f;
    float* gl = A.gl[tw] + i * A.ldg;
    for (int k = lane; k < A.K; k += 32) {
        float d = g0 * w[k * O];
        if (O == 2) d = __fmaf_rn(g1, w[k * O + 1], d);
        const float h = x[k];
        gl[k] = d * (1.0f - h * h);
    }
}

// a warp a row, the warps striding over the rows (a grid of at most kRowBlocks)
__global__ void __launch_bounds__(32 * kRowWarps) rows_kernel(const __grid_constant__ RowArgs A) {
    const int tw = blockIdx.y, lane = threadIdx.x & 31;
    for (int i = blockIdx.x * kRowWarps + (threadIdx.x >> 5); i < A.rows;
         i += gridDim.x * kRowWarps)
        narrow_row(A, tw, tw == 0 ? 2 : 1, i, lane);
}

// mlp_towers.cu's mlp_grad_reduce in its blocks and order (out[p] = the sum over the
// rows of partial[r][p]: 8 groups of consecutive rows, each in order, then the group
// sums in order; each block of 32 parameters its squares over its lanes into
// block_sq; the last block to take a ticket forms the norm), but the norm's last step
// in float64: the last block's threads each sum a contiguous share of the blocks'
// squares in order, then thread 0 the shares in order. At (19, 1024, 1024) a float32
// sum of the 65,000 blocks' squares one after another came 2.4e-5 from the float64
// norm on an H100, past phase p's 1e-5 (the compiled route's 347 blocks stay with
// mlp_towers.cu).
// norm null: the sums alone; out null: the norm alone (the norm-only mode, one row).
__global__ void __launch_bounds__(kGroups * kReduceLanes) general_grad_reduce_kernel(
        const float* __restrict__ partial, float* __restrict__ out, long long rows,
        long long params, float* __restrict__ block_sq, unsigned int* __restrict__ ticket,
        float* __restrict__ norm) {
    __shared__ float sums[kGroups][kReduceLanes];
    __shared__ double shares[kGroups * kReduceLanes];
    __shared__ bool last;
    const int lane = threadIdx.x, g = threadIdx.y;
    const long long p = (long long)blockIdx.x * kReduceLanes + lane;
    const long long per = (rows + kGroups - 1) / kGroups;
    const long long t0 = g * per, t1 = t0 + per < rows ? t0 + per : rows;
    float s = 0.0f;
    if (p < params) {
#pragma unroll 8
        for (long long t = t0; t < t1; ++t) s += partial[t * params + p];
    }
    sums[g][lane] = s;
    __syncthreads();
    if (g == 0) {
        float total = sums[0][lane];
#pragma unroll
        for (int i = 1; i < kGroups; ++i) total += sums[i][lane];
        if (p < params && out != nullptr) out[p] = total;
        if (norm != nullptr) {
            float sq = p < params ? total * total : 0.0f;
#pragma unroll
            for (int o = kReduceLanes / 2; o > 0; o >>= 1)
                sq += __shfl_down_sync(0xffffffffu, sq, o);
            if (lane == 0) {
                block_sq[blockIdx.x] = sq;
                __threadfence();  // the square is visible before the ticket is taken
                last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
            }
        }
    }
    if (norm == nullptr) return;
    __syncthreads();
    if (!last) return;
    // the last block: every other block's square is in the L2 (read past the L1)
    __threadfence();
    const int tid = g * kReduceLanes + lane;
    constexpr int kThreadsR = kGroups * kReduceLanes;
    const unsigned n = gridDim.x, share = (n + kThreadsR - 1) / kThreadsR;
    const unsigned b0 = tid * share, b1 = b0 + share < n ? b0 + share : n;
    double mine = 0.0;
    for (unsigned b = b0; b < b1; ++b) mine += (double)__ldcg(block_sq + b);
    shares[tid] = mine;
    __syncthreads();
    if (tid == 0) {
        double total = 0.0;
        for (int i = 0; i < kThreadsR; ++i) total += shares[i];
        *norm = (float)sqrt(total);
    }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
long long round_up_ll(long long a, long long b) { return ceil_div(a, b) * b; }

// A call's geometry at n rows: the rows a partial row sums (the backward) and the
// partial rows, the slab's rows, the scratch floats, and where each buffer lies in
// the scratch: each tower's split weights, then a slab's activations (the forward two
// buffers a tower in turn; the backward every hidden layer's), the backward's two G
// buffers and g3 a tower. Row strides round the widths up to 4 floats (16 bytes).
struct Geometry {
    long long chunk_rows, partial_rows, slab_rows, slabs, scratch_floats;
    long long split_at[2][kMaxHidden], act_at[2][kMaxHidden], g_at[2][2], g3_at[2];
    long long ld[kMaxHidden + 1], ldg;
};

Geometry geometry(int kind, const Shape& s, long long n) {
    Geometry G{};
    const int L = s.hidden;
    const bool backward = kind == kBackward;
    G.chunk_rows = n > 0 ? round_up_ll(ceil_div(n, kMaxPartialRows), kBK) : 0;
    if (G.chunk_rows < kMinChunkRows) G.chunk_rows = kMinChunkRows;
    G.partial_rows = ceil_div(n, G.chunk_rows);
    long long widest = 0, acts = 0;
    for (int l = 1; l <= L; ++l) {
        G.ld[l] = round_up_ll(s.dims[l], 4);
        widest = G.ld[l] > widest ? G.ld[l] : widest;
        acts += G.ld[l];
    }
    G.ldg = widest;
    long long at = 0;
    for (int tw = 0; tw < 2; ++tw)
        for (int l = 0; l < L; ++l) {
            G.split_at[tw][l] = at;
            at += (long long)s.dims[l] * 2 * round_up_ll(s.dims[l + 1], 2);
        }
    const long long split = at;
    const long long per_row = backward ? 2 * (acts + 2 * widest + 4) : 2 * 2 * widest;
    const long long unit = backward ? G.chunk_rows : kBM;
    long long slab = (kScratchBudget - split) / per_row / unit * unit;
    slab = slab > unit ? slab : unit;
    G.slab_rows = n > 0 ? (slab < round_up_ll(n, unit) ? slab : round_up_ll(n, unit)) : 0;
    G.slabs = G.slab_rows > 0 ? ceil_div(n, G.slab_rows) : 0;
    for (int tw = 0; tw < 2; ++tw) {
        if (backward) {
            for (int l = 1; l <= L; ++l) {
                G.act_at[tw][l - 1] = at;
                at += G.slab_rows * G.ld[l];
            }
            for (int q = 0; q < 2; ++q) {
                G.g_at[tw][q] = at;
                at += G.slab_rows * G.ldg;
            }
            G.g3_at[tw] = at;
            at += G.slab_rows * 4;
        } else {
            for (int q = 0; q < 2; ++q) {
                G.act_at[tw][q] = at;
                at += G.slab_rows * G.ldg;
            }
        }
    }
    G.scratch_floats = at;
    return G;
}

constexpr int kHeader = 2;  // obs, unit ids

// The arguments from ptrs (obs, unit ids, then both towers' 4 (L + 1) tensors), or
// false where they are not valid.
bool net_args(const void* const* ptrs, int num_ptrs, int extra, long long n, long long block,
              long long units, const int* dims, int num_dims, Net* net, Rows* rows) {
    if (!shape_of(dims, num_dims, &net->s)) return false;
    const int L = net->s.hidden, per = 2 * (L + 1);
    if (num_ptrs != kHeader + 2 * per + extra) return false;
    for (int tw = 0; tw < 2; ++tw) {
        for (int l = 0; l <= L; ++l) {
            net->w[tw][l] = static_cast<const float*>(ptrs[kHeader + tw * per + 2 * l]);
            net->b[tw][l] = static_cast<const float*>(ptrs[kHeader + tw * per + 2 * l + 1]);
            if (net->w[tw][l] == nullptr || net->b[tw][l] == nullptr) return false;
        }
    }
    rows->obs = static_cast<const float*>(ptrs[0]);
    rows->unit_ids = static_cast<const long long*>(ptrs[1]);
    rows->n = n;
    rows->block = block;
    rows->units = units;
    rows->d = net->s.dims[0];
    if (rows->obs == nullptr || n < 0) return false;
    if (rows->unit_ids != nullptr && (block < 1 || n % block != 0 || units < 1)) return false;
    return true;
}

// Job builders: the tiles over the slab's rows (M) or a weight's rows (kWgrad).
Job tiled(Job J, int parts) {
    J.tiles_n = (int)ceil_div(J.N, kBN);
    J.tiles_mn = (int)ceil_div(J.M, kBM) * J.tiles_n;
    J.tiles = J.tiles_mn * parts;
    return J;
}

// hidden layer l (1-based) of tower tw: tanh(A W_l + b_l) into out [rows][ldo]
Job layer_job(const Net& net, const Geometry& G, float* scratch, int tw, int l, int rows,
              const float* a, long long lda, float* out, long long ldo) {
    Job J{};
    J.kind = kLayer;
    J.M = rows;
    J.N = net.s.dims[l];
    J.K = net.s.dims[l - 1];
    J.a = a;
    J.lda = lda;
    J.b = scratch + G.split_at[tw][l - 1];
    J.ldb = 2 * round_up_ll(J.N, 2);
    J.bias = net.b[tw][l - 1];
    J.out = out;
    J.ldo = ldo;
    return tiled(J, 1);
}

// A launch of the jobs of one kind (kind: kLayer, kGprop or kWgrad)
int launch_jobs(Launch& L, int kind, cudaStream_t stream) {
    int blocks = 0;
    for (int j = 0; j < L.jobs; ++j) {
        L.first[j] = blocks;
        blocks += L.job[j].tiles;
    }
    L.first[L.jobs] = blocks;
    if (blocks == 0) return 0;
    if (kind == kLayer)
        layer_kernel<kLayer><<<blocks, kThreads, kLayerSharedBytes, stream>>>(L);
    else if (kind == kGprop)
        layer_kernel<kGprop><<<blocks, kThreads, kLayerSharedBytes, stream>>>(L);
    else
        layer_kernel<kWgrad><<<blocks, kThreads, kLayerSharedBytes, stream>>>(L);
    return (int)cudaGetLastError();
}

// the three kernels' dynamic shared memory past 48 KB
cudaError_t allow_layer_smem() {
    cudaError_t err = allow_smem(layer_kernel<kLayer>, kLayerSharedBytes);
    if (err == cudaSuccess) err = allow_smem(layer_kernel<kGprop>, kLayerSharedBytes);
    if (err == cudaSuccess) err = allow_smem(layer_kernel<kWgrad>, kLayerSharedBytes);
    return err;
}

int launch_split(const Net& net, const Geometry& G, float* scratch, cudaStream_t stream) {
    SplitArgs A{};
    A.layers = net.s.hidden;
    for (int tw = 0; tw < 2; ++tw)
        for (int l = 0; l < net.s.hidden; ++l) {
            A.w[tw][l] = net.w[tw][l];
            A.out[tw][l] = scratch + G.split_at[tw][l];
            A.K[l] = net.s.dims[l];
            A.N[l] = net.s.dims[l + 1];
        }
    split_kernel<<<dim3(kSplitBlocks, 2), kThreads, 0, stream>>>(A);
    return (int)cudaGetLastError();
}

int launch_rows(RowArgs& A, cudaStream_t stream) {
    const long long blocks = ceil_div(A.rows, kRowWarps);
    rows_kernel<<<dim3((unsigned)(blocks < kRowBlocks ? blocks : kRowBlocks), 2), 32 * kRowWarps,
                  0, stream>>>(A);
    return (int)cudaGetLastError();
}

Launch slab_launch(const Rows& obs, long long row0, int rows, const Geometry& G,
                   long long params) {
    Launch L{};
    L.obs = obs;
    L.row0 = row0;
    L.rows = rows;
    L.chunk_rows = (int)G.chunk_rows;
    L.part0 = row0 / G.chunk_rows;
    L.part_stride = params;
    return L;
}

// The hidden layers 1 .. upto of the slab's rows, a launch a layer (both towers):
// every layer's activations at its own place (`all`: the backward's layout) or in the
// two buffers in turn.
int hidden_layers(const Net& net, const Rows& obs, const Geometry& G, float* scratch,
                  long long row0, int rows, bool all, int upto, cudaStream_t stream) {
    auto at = [&](int tw, int l) { return scratch + G.act_at[tw][all ? l - 1 : (l - 1) % 2]; };
    auto ld = [&](int l) { return all ? G.ld[l] : G.ldg; };
    for (int l = 1; l <= upto; ++l) {
        Launch L = slab_launch(obs, row0, rows, G, 0);
        L.jobs = 2;
        for (int tw = 0; tw < 2; ++tw)
            L.job[tw] = layer_job(net, G, scratch, tw, l, rows, l == 1 ? nullptr : at(tw, l - 1),
                                  ld(l - 1), at(tw, l), ld(l));
        const int err = launch_jobs(L, kLayer, stream);
        if (err) return err;
    }
    return 0;
}

// the forward's slabs: the hidden layers, then the narrow rows (mu and v); `keep`: the
// backward's layout, so that it reads them instead of computing them again
int forward(const Net& net, const Rows& obs, const Geometry& G, float* scratch, float* mu,
            float* v, bool keep, cudaStream_t stream) {
    const int L_ = net.s.hidden;
    int upto = L_;
    bool narrow = true;
    // split: forward layer1 upto = 1, narrow = false;
    // split: forward layer2 upto = 2, narrow = false;
    // split: forward layer3 upto = 3, narrow = false;
    upto = upto < L_ ? upto : L_;
    for (long long row0 = 0; row0 < obs.n; row0 += G.slab_rows) {
        const int rows = (int)(obs.n - row0 < G.slab_rows ? obs.n - row0 : G.slab_rows);
        int err = hidden_layers(net, obs, G, scratch, row0, rows, keep, upto, stream);
        if (err) return err;
        if (!narrow) continue;
        RowArgs A{};
        for (int tw = 0; tw < 2; ++tw) {
            A.h[tw] = scratch + G.act_at[tw][keep ? L_ - 1 : (L_ - 1) % 2];
            A.w[tw] = net.w[tw][L_];
            A.b[tw] = net.b[tw][L_];
        }
        A.ldh = keep ? G.ld[L_] : G.ldg;
        A.row0 = row0;
        A.K = net.s.dims[L_];
        A.rows = rows;
        A.mu = mu;
        A.v = v;
        err = launch_rows(A, stream);
        if (err) return err;
    }
    return 0;
}

// the backward's slabs: the hidden layers with every activation kept (unless `saved`:
// the forward kept them, one slab), the narrow rows' backward, then a launch a layer
// from the top
int backward(const Net& net, const Rows& obs, const Geometry& G, float* scratch,
             const float* g_mu, const float* g_v, float* partial, bool saved,
             cudaStream_t stream) {
    const Shape& S = net.s;
    const int L_ = S.hidden;
    const long long actor = tower_params(S, 2), params = actor + tower_params(S, 1);
    // each tensor's place in a partial row
    long long w_at[2][kMaxLayers], b_at[2][kMaxLayers];
    for (int tw = 0; tw < 2; ++tw) {
        long long at = tw ? actor : 0;
        for (int l = 0; l <= L_; ++l) {
            const int out = l < L_ ? S.dims[l + 1] : 2 - tw;
            w_at[tw][l] = at;
            at += (long long)S.dims[l] * out;
            b_at[tw][l] = at;
            at += out;
        }
    }
    bool with_dw = true, with_gprop = true;
    // split: backward no_dw with_dw = false;
    // split: backward no_gprop with_gprop = false;
    auto act = [&](int tw, int l) { return scratch + G.act_at[tw][l - 1]; };
    auto gbuf = [&](int tw, int l) { return scratch + G.g_at[tw][l % 2]; };
    for (long long row0 = 0; row0 < obs.n; row0 += G.slab_rows) {
        const int rows = (int)(obs.n - row0 < G.slab_rows ? obs.n - row0 : G.slab_rows);
        const int parts = (int)ceil_div(rows, G.chunk_rows);
        if (!saved) {
            const int err = hidden_layers(net, obs, G, scratch, row0, rows, true, L_, stream);
            if (err) return err;
        }
        RowArgs A{};
        for (int tw = 0; tw < 2; ++tw) {
            A.h[tw] = act(tw, L_);
            A.w[tw] = net.w[tw][L_];
            A.b[tw] = net.b[tw][L_];
            A.g3[tw] = scratch + G.g3_at[tw];
            A.gl[tw] = gbuf(tw, L_);
        }
        A.ldh = G.ld[L_];
        A.ldg = G.ldg;
        A.row0 = row0;
        A.K = S.dims[L_];
        A.rows = rows;
        A.backward = 1;
        A.g_mu = g_mu;
        A.g_v = g_v;
        int err = launch_rows(A, stream);
        if (err) return err;
        // split: backward top continue;
        // two launches a hidden layer l from the top: W_l's gradient (and, in the first,
        // the narrow layer's), and G_{l-1} for the next
        for (int l = L_; l >= 1; --l) {
            Launch L = slab_launch(obs, row0, rows, G, params);
            for (int tw = 0; tw < 2 && with_dw; ++tw) {
                if (l == L_) {
                    // the narrow layer's: H_L^T g3
                    Job J{};
                    J.kind = kWgrad;
                    J.M = S.dims[L_];
                    J.N = 2 - tw;
                    J.a = act(tw, L_);
                    J.lda = G.ld[L_];
                    J.b = scratch + G.g3_at[tw];
                    J.ldb = 4;
                    J.out = partial + w_at[tw][L_];
                    J.bias_out = partial + b_at[tw][L_];
                    L.job[L.jobs++] = tiled(J, parts);
                }
                Job J{};
                J.kind = kWgrad;
                J.M = S.dims[l - 1];
                J.N = S.dims[l];
                J.a = l == 1 ? nullptr : act(tw, l - 1);
                J.lda = G.ld[l - 1];
                J.b = gbuf(tw, l);
                J.ldb = G.ldg;
                J.out = partial + w_at[tw][l - 1];
                J.bias_out = partial + b_at[tw][l - 1];
                L.job[L.jobs++] = tiled(J, parts);
            }
            err = launch_jobs(L, kWgrad, stream);
            if (err) return err;
            L.jobs = 0;
            for (int tw = 0; tw < 2 && with_gprop && l > 1; ++tw) {
                Job J{};
                J.kind = kGprop;
                J.M = rows;
                J.N = S.dims[l - 1];
                J.K = S.dims[l];
                J.a = gbuf(tw, l);
                J.lda = G.ldg;
                J.b = scratch + G.split_at[tw][l - 1];
                J.ldb = 2 * round_up_ll(J.K, 2);
                J.h = act(tw, l - 1);
                J.ldh = G.ld[l - 1];
                J.out = gbuf(tw, l - 1);
                J.ldo = G.ldg;
                L.job[L.jobs++] = tiled(J, 1);
            }
            err = launch_jobs(L, kGprop, stream);
            if (err) return err;
        }
    }
    return 0;
}

}  // namespace

// The geometry of the forward (kind 0) or the backward (kind 3) at n rows of towers
// dims[0] -> dims[1] -> ... -> dims[num_dims - 1] into out[10]: a layer launch's
// threads, a tile's rows, columns and contraction chunk, the rows a partial row sums,
// the partial rows, a slab's rows, the slabs, the scratch floats and a layer launch's
// shared bytes. Returns a cudaError_t (invalid where the route does not take them).
extern "C" int mlp_general_gemm_plan(int kind, long long n, const int* dims, int num_dims,
                                     long long* out) {
    Shape s;
    if ((kind != kForward && kind != kBackward) || n < 0 || !shape_of(dims, num_dims, &s))
        return (int)cudaErrorInvalidValue;
    const Geometry G = geometry(kind, s, n);
    const long long v[10] = {kThreads, kBM, kBN, kBK, G.chunk_rows, G.partial_rows, G.slab_rows,
                             G.slabs, G.scratch_floats, kLayerSharedBytes};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
}

// The rows of the backward's partials at n rows: a row a chunk of the rows; -1 where
// the towers are not taken.
extern "C" int mlp_general_partial_rows(long long n, const int* dims, int num_dims) {
    Shape s;
    if (n < 0 || !shape_of(dims, num_dims, &s)) return -1;
    return (int)geometry(kBackward, s, n).partial_rows;
}

// The forward: ptrs the obs (float32 contiguous), the unit ids (int64, or null), both
// towers' 4 (L + 1) tensors in model.parameters() order, then mu [n, 2] and v [n]
// out and the scratch; block and units the observations' [units, block] with ids;
// dims the towers' (obs_dim, hidden widths); scratch_floats the scratch's allocated
// floats, invalid under the plan's; keep: the backward's plan (one slab, else
// invalid), every hidden layer's activations and the split weights left in the
// scratch for mlp_general_backward_f32(..., saved = 1). Returns a cudaError_t.
extern "C" int mlp_general_forward_f32(const void* const* ptrs, int num_ptrs, long long n,
                                       long long block, long long units, const int* dims,
                                       int num_dims, long long scratch_floats, int keep,
                                       int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Net net;
    Rows a;
    if (!net_args(ptrs, num_ptrs, 3, n, block, units, dims, num_dims, &net, &a))
        return (int)cudaErrorInvalidValue;
    const Geometry G = geometry(keep ? kBackward : kForward, net.s, n);
    float* mu = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 3]));
    float* v = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 2]));
    float* scratch = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 1]));
    if (mu == nullptr || v == nullptr || scratch == nullptr || scratch_floats < G.scratch_floats
            || (keep && G.slabs > 1) || ceil_div(G.slab_rows, kBM) * 8 > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    err = allow_layer_smem();
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    const int e = launch_split(net, G, scratch, s);
    if (e) return e;
    // split: forward split_weights return 0;
    return forward(net, a, G, scratch, mu, v, keep != 0, s);
}

// The backward: ptrs as the forward's inputs, then d mu [n, 2] and d v [n]
// (contiguous), the partials [mlp_general_partial_rows(n), params] out, and the
// scratch. partial_rows and partial_cols are the partials' allocated shape and
// scratch_floats the scratch's allocated floats: invalid unless the shape is the
// plan's exactly (the reduce sums every row) and the scratch holds what the plan
// writes. saved: the scratch holds what the forward kept of these inputs (keep = 1;
// one slab, else invalid), so the hidden layers are not computed again. Every partial
// row is written. Returns a cudaError_t.
extern "C" int mlp_general_backward_f32(const void* const* ptrs, int num_ptrs, long long n,
                                        long long block, long long units, const int* dims,
                                        int num_dims, long long partial_rows,
                                        long long partial_cols, long long scratch_floats,
                                        int saved, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Net net;
    Rows a;
    if (!net_args(ptrs, num_ptrs, 4, n, block, units, dims, num_dims, &net, &a))
        return (int)cudaErrorInvalidValue;
    const Geometry G = geometry(kBackward, net.s, n);
    const float* g_mu = static_cast<const float*>(ptrs[num_ptrs - 4]);
    const float* g_v = static_cast<const float*>(ptrs[num_ptrs - 3]);
    float* partial = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 2]));
    float* scratch = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 1]));
    if (g_mu == nullptr || g_v == nullptr || partial == nullptr || scratch == nullptr
            || partial_rows != G.partial_rows
            || partial_cols != tower_params(net.s, 2) + tower_params(net.s, 1)
            || scratch_floats < G.scratch_floats || (saved && G.slabs > 1)
            || ceil_div(G.slab_rows, kBM) * 8 * 2 * 2 > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    err = allow_layer_smem();
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    if (!saved) {
        const int e = launch_split(net, G, scratch, s);
        if (e) return e;
    }
    return backward(net, a, G, scratch, g_mu, g_v, partial, saved != 0, s);
}

// The reduce (general_grad_reduce_kernel): out[p] (params floats) = the sum over the
// rows of partial[r][p]; with norm, *norm = the global norm of what it sums, block_sq
// (params / 32 rounded up floats) its scratch and ticket one unsigned int, 0 before
// the launch and left 0 after it, which no other launch may use while this one runs;
// out null: the norm alone of partial's one row (the norm-only mode). Returns a
// cudaError_t.
extern "C" int general_grad_reduce_f32(const float* partial, float* out, float* norm,
                                       float* block_sq, unsigned int* ticket, long long rows,
                                       long long params, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (params + kReduceLanes - 1) / kReduceLanes;
    if (rows < 1 || params < 1 || blocks > 0x7fffffffLL || (out == nullptr && norm == nullptr)
            || (norm != nullptr && (block_sq == nullptr || ticket == nullptr)))
        return (int)cudaErrorInvalidValue;
    general_grad_reduce_kernel<<<(unsigned)blocks, dim3(kReduceLanes, kGroups), 0,
                                 (cudaStream_t)stream>>>(partial, out, rows, params, block_sq,
                                                         ticket, norm);
    return (int)cudaGetLastError();
}

extern "C" const char* mlp_general_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
