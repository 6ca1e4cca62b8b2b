// The actor's and critic's MLPs of the PPO minibatch step, forward and backward,
// for NVIDIA Hopper (sm_90a), their products on the tensor cores.
//
// Replaces the JAX package's _mlp (self_play_racing_tpu/models/actor_critic.py:68)
// for actor_mu and critic_value inside _ppo_loss, and its gradient under
// jax.value_and_grad (self_play_racing_tpu/agent/ppo.py:313), which XLA compiles
// with the loss into the minibatch step's one program on the TPU. In PyTorch the
// same work is a cuBLAS GEMM, a bias add and a tanh a layer forward and
// tanh_backward, two GEMMs and a bias sum a layer backward (about 17 and 22
// launches a minibatch; self_play_racing_tpu_torch/models/actor_critic.py:_mlp).
//
// Towers: actor obs -> H1 -> H2 -> 2 with tanh after every layer, the last too;
// critic obs -> H1 -> H2 -> 1 with no tanh after the last. Weights are (in, out), a
// layer is x @ w + b.
//
// Bounds on an H100 SXM at 65,536 rows of 19 inputs, towers (64, 64): the forward
// 10,816 multiply-adds a row, the backward 19,200 of its own (every weight gradient,
// the input gradients of the upper two layers a tower) and the 10,816 of the forward
// it recomputes. As float32 FFMA at 67 TFLOP/s: 21.16 us forward, 37.56 + 21.16
// backward. As error-compensated 3xTF32 on the tensor cores (3 products a
// multiply-add at 495 TFLOP/s): 8.59 and 15.25 + 8.59 us. The bytes (observations,
// mu, v, their gradients, the weights, the partials) are a few MB: bound by
// operations either way. What the card gives these products (scripts/mma_tf32_rate.cu):
// mma.sync.m16n8k8 TF32 back to back runs at ~211 TFLOP/s with 8 warps an SM (~218
// with 16), not 495 (that rate needs wgmma), so 3xTF32 tops out near 70 TFLOP/s of
// float32 work, about FFMA's; each operand's split costs as much again unless it is
// cheap (cvt.rna a B fragment an mma: 70 TFLOP/s; the same rounding on the integer
// view: 113).
//
// What held the FFMA design before this one back (scripts/mlp_kernel_split.py, its
// split on the card): FFMA products fed from shared memory, each ~3x its share of the
// FFMA bound (the 64 -> 64 layer 34 us of the forward's 67.5, the recomputed forward
// 47 of the backward's 159), and every one of 1024 blocks a tower restaging its
// weights (14 us forward, 16 backward).
//
// What this design does:
// - Every hidden-layer product and weight gradient is mma.sync.m16n8k8 in TF32 with
//   float32 accumulators, each float32 operand split into hi = cvt.rna.tf32(x) and
//   lo = cvt.rna.tf32(x - hi) (x - hi is exact; the rounding done on the integer
//   view, the same bits at 1.6x the rate of the conversion instruction), each
//   product accumulated as lo*hi, hi*lo, then hi*hi (CUTLASS's OpMultiplyAddFastF32
//   order): float32-accurate, as the composition this replaces is
//   (torch.backends.cuda.matmul.allow_tf32 False). Plain TF32 or tanh.approx would
//   leave chip_smoke.py phase p's tolerance; tanhf stays.
// - A warp owns 16 rows of a 64-row tile (an m16 tile) through a tower's forward: the
//   layer's accumulator (columns 2t, 2t+1 of each 8) is the next layer's A fragment
//   once the weight's rows are read in the order 2t, 2t+1 within each 8 (so k = t,
//   t + 4 of the fragment are features 2t, 2t + 1), so activations stay in registers
//   and the forward has no block barrier but the tile's.
// - The narrow steps (the ->2 and ->1 layers, g3 W3^T, h2^T g3 and the bias sums) are
//   float32 FFMA over a warp's lanes, summed over the lanes by a shuffle tree in a
//   fixed order.
// - A fixed grid (kForwardBlocks, kBackwardBlocks a tower: constants, never the
//   card's SM count) walks the tiles, t = blockIdx.x + k gridDim.x: a block stages its
//   weights once with cp.async (swizzled so that both the forward's and the transposed
//   reads are free of bank conflicts) and prefetches the next tile's observations
//   while it computes this one. The forward runs both towers on one staged tile, so
//   the observations are read once; one body of code serves both towers (their output
//   count at run time), which keeps the kernels within the instruction cache. The
//   weights are staged as float32 and split at load: split copies would not fit
//   beside the tiles (the backward needs W2 both ways; at (64, 64) the forward's
//   three blocks an SM would drop to two).
// - The backward runs a tower a block: the tile's forward recomputed, g3, g2 =
//   (g3 W3^T)(1 - h2^2) and g1 = (g2 W2^T)(1 - h1^2) in registers, h1, g2 and then g1
//   through shared memory for the weight gradients h1^T g2 and x^T g1, whose K is the
//   tile's rows in order. Each block accumulates its tiles in order and writes one
//   partial row a block: in shared memory where that keeps two blocks an SM ((64,
//   64) to 40 inputs), else in its row of the partials (in device memory, the same
//   sums in the same order) where that keeps two (to 96 inputs), else where it fits.
//   Two blocks an SM in the partial row beat one in shared memory (35 and 43 inputs);
//   three in the partial row lose to two in shared memory (19 inputs).
//
// mlp_grad_reduce_f32: out[p] = the sum of partial[b][p] over the backward's blocks
// b: 8 groups of consecutive rows, each summed in order, then the 8 group sums in
// order. The rows, the tiles of each and every sum's order are a function of n
// alone: equal inputs give equal bits, eager and in a CUDA graph; no float atomics.
//
// mlp_grad_reduce_norm_f32 is the same launch that also writes the global norm of
// what it sums, sqrt(sum over p of out[p]^2), optax.global_norm of the 12 gradients
// (self_play_racing_tpu/agent/ppo.py:121, clip_by_global_norm, which XLA fuses into
// the update program on the TPU; in PyTorch a _foreach_mul, 12 sums, a stack, a sum
// and a sqrt: 16 launches a minibatch step). Its work is its launch: 11,075
// parameters of 128 rows that the backward has just written to the L2, so what it
// is held to is its launch floor. The design keeps the norm inside that launch:
// - each block of 32 parameters squares its sums and adds them over its lanes by a
//   shuffle tree (lane l takes l + 16, then l + 8, l + 4, l + 2, l + 1): one float
//   a block, written to block_sq;
// - the block that finishes last, found by a ticket (__threadfence, then one
//   integer atomicInc on a counter), sums those floats one after another in
//   block-index order and writes sqrtf of the total. That order holds whatever
//   order the blocks finish in, so the norm's bits are a function of the input
//   alone; no float atomics;
// - atomicInc wraps the counter back to 0 at the last ticket, so it is 0 after
//   every launch and a replayed CUDA graph needs no memset node.
// With out null and one row (the norm-only mode) the launch gives the norm of a
// flat gradient already summed, in the same blocks and order: over equal flats the
// two modes give equal bits (x + 0.0f is x, and the square of -0.0f is +0.0f).
// The partials and the output are flat in model.parameters() order (actor w1, b1, w2,
// b2, w3, b3, then the critic's), so the 12 gradients are views of the output. A
// row's outputs depend on that row alone, in an order fixed by the kernel, so the
// forward is row-invariant. The sums run in another order than cuBLAS's: the kernels
// are held to the plain composition within a stated tolerance (chip_smoke.py phase
// p), not bitwise.
//
// The unit index: given unit ids (the minibatch's shuffle units), the observations
// are the rollout's units [units, block, obs_dim] (agent/ppo.py:shard_blocks) and
// minibatch row r is unit ids[r / block], offset r % block, read in place.
//
// Shapes: obs_dim is a run-time argument; the hidden widths (h1, h2) are
// compile-time, (64, 64) and (128, 128) (MLP_HIDDEN below). mlp_shared_bytes says
// whether an (obs_dim, h1, h2) fits the H100's 227 KB a block.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_tower.cuh"

namespace {

using namespace mlp_tower;

constexpr int kForwardBlocks = 384;      // the forward's grid
constexpr int kBackwardBlocks = 128;     // the backward's blocks a tower: partial rows
constexpr int kParams = 12;              // the towers' tensors in model.parameters() order
constexpr int kGroups = 8;               // the reduce's groups of consecutive rows
constexpr int kReduceLanes = 32;         // parameters a reduce block
// the backward's blocks an SM that its layout keeps where one does (timed:
// scripts/mlp_backward_plans.py)
constexpr int kBackwardBlocksPerSm = 2;

struct Args {
    const float* obs;            // [n, d], or [units, block, d] through the unit index
    const long long* unit_ids;   // [n / block] or null: the rows are obs's own
    const float* w[kParams];     // actor w1 b1 w2 b2 w3 b3, critic w1 b1 w2 b2 w3 b3
    long long n, block, units;
    int d;                       // obs_dim
};

// The kernels' choices at obs_dim: the x tiles (2 to prefetch the next tile, else 1)
// and whether the backward accumulates in shared memory. The forward takes the first
// that fits a block; the backward the first, in the order (shared memory, 2 tiles),
// (shared, 1), (partial row, 2), (partial row, 1), that keeps kBackwardBlocksPerSm
// blocks an SM, else the first that fits a block. Bytes 0 where none fits.
struct Plan {
    int forward_nbuf, backward_nbuf;
    bool acc_shared;
    long long forward_bytes, backward_bytes;
};

template <int H1, int H2>
Plan plan(int obs_dim) {
    const Layout<H1, H2> L(obs_dim);
    Plan p{0, 0, false, 0, 0};
    for (int nbuf = 2; nbuf >= 1 && !p.forward_nbuf; --nbuf) {
        if (4LL * L.forward_floats(nbuf) <= kMaxSharedBytes) {
            p.forward_nbuf = nbuf;
            p.forward_bytes = 4LL * L.forward_floats(nbuf);
        }
    }
    for (int blocks = kBackwardBlocksPerSm; blocks >= 1 && !p.backward_nbuf; --blocks) {
        const long long limit = kSmSharedBytes / blocks - kBlockReservedBytes;
        for (int shared = 1; shared >= 0 && !p.backward_nbuf; --shared) {
            for (int nbuf = 2; nbuf >= 1 && !p.backward_nbuf; --nbuf) {
                if (4LL * L.backward_floats(nbuf, shared) <= limit) {
                    p.backward_nbuf = nbuf;
                    p.acc_shared = shared;
                    p.backward_bytes = 4LL * L.backward_floats(nbuf, shared);
                }
            }
        }
    }
    return p;
}

// ------------------------------------------------------------------------- staging

// where the observations hold minibatch row r
__device__ __forceinline__ long long source_row(const Args& a, long long r) {
    if (a.unit_ids == nullptr) return r;
    const long long u = a.unit_ids[r / a.block];
    if (u < 0 || u >= a.units) __trap();  // as index_select
    return u * a.block + r % a.block;
}

// the tile of rows [row0, row0 + kRows) into x [kRows][xs] with cp.async, a warp a
// row and a lane a feature; rows past n are zero-filled (features from d are zeroed
// once, zero_x). Lane j first finds where the warp's row j lies (one unit id read a
// lane, all in flight together), the row loop takes it by shuffle.
__device__ __forceinline__ void stage_x(const Args& a, float* x, int xs, long long row0) {
    constexpr int kRowsPerWarp = kRows / kWarps;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long mine = row0 + warp + kWarps * (lane % kRowsPerWarp);
    const long long from = mine < a.n ? source_row(a, mine) : -1;
    for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = warp + kWarps * j;
        const long long src_row = __shfl_sync(0xffffffffu, from, j);
        const bool valid = src_row >= 0;
        const float* src = a.obs + (valid ? src_row * a.d : 0);
        for (int c = lane; c < a.d; c += 32) cp_async4(x + r * xs + c, src + (valid ? c : 0), valid);
    }
    cp_async_commit();
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) mlp_forward_kernel(Args a, int nbuf,
                                                               float* __restrict__ mu,
                                                               float* __restrict__ v) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const Layout<H1, H2> L(a.d);
    const Lane l(threadIdx.x & 31);
    const int warp = threadIdx.x >> 5;
    const long long tiles = (a.n + kRows - 1) / kRows;
    float* xb = s + 2 * L.tower;
    zero_x(xb, nbuf, L.d, L.xs);
    stage_tower(L, a.w, s, 2);
    stage_tower(L, a.w + 6, s + L.tower, 1);
    long long tile = blockIdx.x;
    if (tile < tiles) stage_x(a, xb, L.xs, tile * kRows);
    for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
        cp_async_wait_all();
        __syncthreads();
        const float* x = xb + (nbuf == 2 ? (k & 1) * L.xtile : 0);
        const long long next = tile + gridDim.x;
        if (nbuf == 2 && next < tiles) stage_x(a, xb + ((k + 1) & 1) * L.xtile, L.xs, next * kRows);
        // split: forward staged { if (threadIdx.x == 0) mu[0] = x[1]; continue; }
        const float* xw = x + 16 * warp * L.xs;
        const long long row = tile * kRows + 16 * warp;
        // the actor (2 outputs, mu), then the critic (1, v): one body of code
#pragma unroll 1
        for (int tw = 0; tw < 2; ++tw)
            tower_forward(L, s + tw * L.tower, xw, 2 - tw, tw ? v : mu, row, a.n, l);
        if (nbuf == 1 && next < tiles) {
            __syncthreads();
            stage_x(a, xb, L.xs, next * kRows);
        }
    }
}

// ----------------------------------------------------------------- the backward

// Where a block's gradients accumulate over its tiles: shared memory (the
// accumulator rows padded to a stride of 8 mod 32) or its partial row, and where
// each tensor starts and its row stride.
struct Acc {
    float *w1, *b1, *w2, *b2, *w3, *b3;
    int s1, s2;
};

// dst[m][n] += the sum over the tile's rows r, in steps of 8 in order, of A[r][m]
// B[r][n], for the 16 m from m0 below m_valid and the 8 NJ n from n0: A [kRows][sa]
// and B [kRows][sb] in shared memory (strides 8 mod 32), dst generic (row stride ds).
template <int NJ>
__device__ __forceinline__ void rows_dot(const float* A, int sa, const float* B, int sb, int m0,
                                         int n0, int m_valid, float* dst, int ds,
                                         const Lane& l) {
    float acc[NJ][4];
    const int m_lo = m0 + l.g, m_hi = m_lo + 8;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int c = n0 + 8 * j + 2 * l.t;
        acc[j][0] = m_lo < m_valid ? dst[m_lo * ds + c] : 0.0f;
        acc[j][1] = m_lo < m_valid ? dst[m_lo * ds + c + 1] : 0.0f;
        acc[j][2] = m_hi < m_valid ? dst[m_hi * ds + c] : 0.0f;
        acc[j][3] = m_hi < m_valid ? dst[m_hi * ds + c + 1] : 0.0f;
    }
#pragma unroll 2
    for (int ks = 0; ks < kRows / 8; ++ks) {
        const float* ar = A + (8 * ks + l.t) * sa + m0 + l.g;
        const float* br = B + (8 * ks + l.t) * sb + n0 + l.g;
        const FragA fa = frag_a(ar[0], ar[8], ar[4 * sa], ar[4 * sa + 8]);
        FragB fb[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) fb[j] = frag_b(br[8 * j], br[4 * sb + 8 * j]);
        mma3(acc, 0, fa, fb);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int c = n0 + 8 * j + 2 * l.t;
        if (m_lo < m_valid) {
            dst[m_lo * ds + c] = acc[j][0];
            dst[m_lo * ds + c + 1] = acc[j][1];
        }
        if (m_hi < m_valid) {
            dst[m_hi * ds + c] = acc[j][2];
            dst[m_hi * ds + c + 1] = acc[j][3];
        }
    }
}

// The column sums over this warp's 16 rows of the columns a lane holds (rows g and
// g + 8, then over g by the butterfly), written by the lanes of g = 0.
template <int NJ>
__device__ __forceinline__ void column_sums(const float (&v)[NJ][4], float* dst, const Lane& l) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float s = lanes_sum(v[j][e] + v[j][2 + e], 4, 16);
            if (l.g == 0) dst[8 * j + 2 * l.t + e] = s;
        }
    }
}

// W3's and b3's gradients over a warp's 16 rows into dst [H2 O | O]: h2^T g3 and
// the sum of g3 (rows g and g + 8 a lane, then the butterfly over g)
template <int H2>
__device__ __forceinline__ void w3_sums(const float (&h2)[H2 / 8][4], const float (&g0)[2],
                                        const float (&g1)[2], int O, float* dst, const Lane& l) {
#pragma unroll 1
    for (int o = 0; o < O; ++o) {
        const float a0 = o ? g0[1] : g0[0], a1 = o ? g1[1] : g1[0];
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = __fmaf_rn(h2[j][2 + e], a1, h2[j][e] * a0);
                const float sum = lanes_sum(p, 4, 16);
                if (l.g == 0) dst[(8 * j + 2 * l.t + e) * O + o] = sum;
            }
        }
        const float sum = lanes_sum(a0 + a1, 4, 16);
        if (l.g == 0 && l.t == 0) dst[H2 * O + o] = sum;
    }
}

// One tower's backward over the block's tiles (see the note at the top), into its
// share of the block's partial row.
template <int H1, int H2>
__device__ __forceinline__ void tower_backward(const Args& a, int nbuf, bool acc_shared, int O,
                                               const float* g_out, float* part, float* s) {
    const Layout<H1, H2> L(a.d);
    const Lane l(threadIdx.x & 31);
    const int warp = threadIdx.x >> 5;
    const float* const* w = a.w + (O == 2 ? 0 : 6);  // the actor's tensors, or the critic's
    const long long tiles = (a.n + kRows - 1) / kRows;
    float* xb = s + L.tower;
    float* act = xb + nbuf * L.xtile;  // h1, then g1: [kRows][H1 + 8]
    float* grad = act + L.act();       // g2: [kRows][H2 + 8]
    float* narrow = grad + L.grad();   // a warp's [b1 H1 | b2 H2 | w3 H2 O | b3 O]
    const int kNarrow = H1 + H2 + H2 * O + O;
    const int size1 = a.d * H1, size = size1 + H1 + H1 * H2 + H2 + H2 * O + O;
    Acc acc;
    if (acc_shared) {
        float* base = narrow + L.narrow();
        acc.w1 = base + L.acc_w1();
        acc.b1 = base + L.acc_b1();
        acc.w2 = base + L.acc_w2();
        acc.b2 = base + L.acc_b2();
        acc.s1 = H1 + 8;
        acc.s2 = H2 + 8;
        for (int e = threadIdx.x; e < L.acc(); e += kThreads) base[e] = 0.0f;
    } else {
        acc.w1 = part;
        acc.b1 = part + size1;
        acc.w2 = acc.b1 + H1;
        acc.b2 = acc.w2 + H1 * H2;
        acc.s1 = H1;
        acc.s2 = H2;
        for (int e = threadIdx.x; e < size; e += kThreads) part[e] = 0.0f;
    }
    // w3 and b3 follow b2 as in the partial row
    acc.w3 = acc.b2 + H2;
    acc.b3 = acc.w3 + H2 * O;
    zero_x(xb, nbuf, L.d, L.xs);
    stage_tower(L, w, s, O);
    long long tile = blockIdx.x;
    if (tile < tiles) stage_x(a, xb, L.xs, tile * kRows);
    for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
        cp_async_wait_all();
        __syncthreads();
        const float* x = xb + (nbuf == 2 ? (k & 1) * L.xtile : 0);
        const long long next = tile + gridDim.x;
        if (nbuf == 2 && next < tiles) stage_x(a, xb + ((k + 1) & 1) * L.xtile, L.xs, next * kRows);
        // split: backward staged { if (threadIdx.x == 0) part[0] = x[1]; continue; }
        const long long row = tile * kRows + 16 * warp;
        float* act_w = act + 16 * warp * (H1 + 8);
        float* mine = narrow + warp * kNarrow;
        // the warp's 16 rows: the forward again, h1 to shared memory
        float h1[H1 / 8][4], v2[H2 / 8][4];
        layer1(L, s, x + 16 * warp * L.xs, h1, l);
        store_rows<H1 / 8, H1 + 8>(act_w, h1, l);
        layer2(L, s, h1, v2, l);
        // split: backward recompute { sink(v2, part); continue; }
        // g3 = d out * (1 - out^2) through the actor's tanh (autograd's
        // tanh_backward), d v as it is for the critic; rows past n zero
        float y0[2], y1[2], g0[2] = {0.0f, 0.0f}, g1[2] = {0.0f, 0.0f};
        last_layer<H2>(s + L.w3, s + L.b3, v2, O, y0, y1, l);
        const long long r0 = row + l.g, r1 = r0 + 8;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
            if (o < O) {
                g0[o] = r0 < a.n ? g_out[r0 * O + o] : 0.0f;
                g1[o] = r1 < a.n ? g_out[r1 * O + o] : 0.0f;
            }
            if (O == 2) {
                g0[o] = g0[o] * (1.0f - y0[o] * y0[o]);
                g1[o] = g1[o] * (1.0f - y1[o] * y1[o]);
            }
        }
        // W3's and b3's gradients over the warp's rows: h2^T g3 and the sum of g3
        // split: backward no_narrow {} else
        w3_sums<H2>(v2, g0, g1, O, mine + H1 + H2, l);
        // split: backward g3_w3 { sink(v2, part); continue; }
        // g2 = (g3 W3^T) * (1 - h2^2), in place of h2; its column sums (b2's gradient)
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float* w3 = s + L.w3 + (8 * j + 2 * l.t + e) * O;
                float d0 = g0[0] * w3[0], d1 = g1[0] * w3[0];
                if (O == 2) {
                    d0 = __fmaf_rn(g0[1], w3[1], d0);
                    d1 = __fmaf_rn(g1[1], w3[1], d1);
                }
                v2[j][e] = d0 * (1.0f - v2[j][e] * v2[j][e]);
                v2[j][2 + e] = d1 * (1.0f - v2[j][2 + e] * v2[j][2 + e]);
            }
        }
        // split: backward no_narrow {} else
        column_sums(v2, mine + H1, l);
        store_rows<H2 / 8, H2 + 8>(grad + 16 * warp * (H2 + 8), v2, l);
        // g1 = (g2 W2^T) * (1 - h1^2), h1 read back from this warp's rows; its column
        // sums (b1's gradient)
        zero(h1);
        // split: backward no_g1 {} else
        times_transposed<H1, H2>(h1, v2, s + L.w2, l);
#pragma unroll
        for (int j = 0; j < H1 / 8; ++j) {
            const float2 p =
                *reinterpret_cast<const float2*>(act_w + l.g * (H1 + 8) + 8 * j + 2 * l.t);
            const float2 q = *reinterpret_cast<const float2*>(act_w + (l.g + 8) * (H1 + 8) +
                                                              8 * j + 2 * l.t);
            h1[j][0] = h1[j][0] * (1.0f - p.x * p.x);
            h1[j][1] = h1[j][1] * (1.0f - p.y * p.y);
            h1[j][2] = h1[j][2] * (1.0f - q.x * q.x);
            h1[j][3] = h1[j][3] * (1.0f - q.y * q.y);
        }
        // split: backward no_narrow {} else
        column_sums(h1, mine, l);
        // split: backward g1 { sink(h1, part); continue; }
        __syncthreads();
        // W2's gradient: h1^T g2 over the tile's rows, units of 16 x 64 over the warps
        // split: backward no_dw {} else
        for (int u = warp; u < (H1 / 16) * (H2 / 64); u += kWarps) {
            rows_dot<8>(act, H1 + 8, grad, H2 + 8, 16 * (u % (H1 / 16)), 64 * (u / (H1 / 16)),
                        H1, acc.w2, acc.s2, l);
        }
        __syncthreads();
        // split: backward w2_grad { sink(h1, part); continue; }
        // g1 in place of h1; the warps' narrow sums into the gradients, in warp order
        store_rows<H1 / 8, H1 + 8>(act_w, h1, l);
        for (int e = threadIdx.x; e < kNarrow; e += kThreads) {
            float sum = narrow[e];
#pragma unroll
            for (int i = 1; i < kWarps; ++i) sum += narrow[i * kNarrow + e];
            float* dst = e < H1 ? acc.b1 + e : acc.b2 + (e - H1);  // b2, w3, b3 in a row
            *dst += sum;
        }
        __syncthreads();
        // W1's gradient: x^T g1 over the tile's rows (x's features to d, in 16s), units
        // of 16 x 32 so that every warp takes one at 16 to 32 inputs
        const int m_tiles = (L.d + 15) / 16;
        // split: backward no_dw {} else
        for (int u = warp; u < m_tiles * (H1 / 32); u += kWarps) {
            rows_dot<4>(x, L.xs, act, H1 + 8, 16 * (u % m_tiles), 32 * (u / m_tiles), L.d,
                        acc.w1, acc.s1, l);
        }
        if (nbuf == 1 && next < tiles) {
            __syncthreads();
            stage_x(a, xb, L.xs, next * kRows);
        }
    }
    // the block's gradients, accumulated in shared memory, to its partial row
    if (acc_shared) {
        __syncthreads();
        for (int e = threadIdx.x; e < size; e += kThreads) {
            float value;
            if (e < size1) {
                value = acc.w1[(e / H1) * acc.s1 + e % H1];
            } else if (e < size1 + H1) {
                value = acc.b1[e - size1];
            } else if (e < size1 + H1 + H1 * H2) {
                const int i = e - size1 - H1;
                value = acc.w2[(i / H2) * acc.s2 + i % H2];
            } else {
                value = acc.b2[e - size1 - H1 - H1 * H2];
            }
            part[e] = value;
        }
    }
}

// a tower's parameters (the actor's first in a partial row)
template <int H1, int H2>
__host__ __device__ long long tower_params(int d, int o) {
    return (long long)d * H1 + H1 + H1 * H2 + H2 + H2 * o + o;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) mlp_backward_kernel(
        Args a, int nbuf, int acc_shared, const float* __restrict__ g_mu,
        const float* __restrict__ g_v, float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const long long actor = tower_params<H1, H2>(a.d, 2);
    float* part = partial + blockIdx.x * (actor + tower_params<H1, H2>(a.d, 1));
    // the actor (2 outputs) or the critic (1): one body of code
    const bool critic = blockIdx.y == 1;
    tower_backward<H1, H2>(a, nbuf, acc_shared, critic ? 1 : 2, critic ? g_v : g_mu,
                           critic ? part + actor : part, s);
}

// out[p] = sum over r of partial[r * params + p]: group g of kGroups sums its
// consecutive rows in order, then the group sums in order (out null: not written).
// With norm: each block's squares of its sums, over its lanes by the shuffle tree,
// into block_sq[block]; the last block to take a ticket writes *norm = sqrtf of the
// blocks' squares summed in block-index order (the file's head says why). The
// counter behind the ticket is 0 before and after every launch.
__global__ void __launch_bounds__(kGroups * kReduceLanes) mlp_grad_reduce_kernel(
        const float* __restrict__ partial, float* __restrict__ out, long long rows,
        long long params, float* __restrict__ block_sq, unsigned int* __restrict__ ticket,
        float* __restrict__ norm) {
    __shared__ float sums[kGroups][kReduceLanes];
    __shared__ float stage[kGroups * kReduceLanes];
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
    float total = 0.0f;
    for (unsigned b0 = 0; b0 < gridDim.x; b0 += kGroups * kReduceLanes) {
        if (b0 + tid < gridDim.x) stage[tid] = __ldcg(block_sq + b0 + tid);
        __syncthreads();
        if (tid == 0) {
            const unsigned m = gridDim.x - b0 < kGroups * kReduceLanes
                ? gridDim.x - b0 : kGroups * kReduceLanes;
            for (unsigned i = 0; i < m; ++i) total += stage[i];
        }
        __syncthreads();
    }
    if (tid == 0) *norm = sqrtf(total);
}

long long tiles_for(long long n) { return (n + kRows - 1) / kRows; }
long long forward_blocks(long long n) { return tiles_for(n) < kForwardBlocks ? tiles_for(n) : kForwardBlocks; }
long long backward_blocks(long long n) {
    return tiles_for(n) < kBackwardBlocks ? tiles_for(n) : kBackwardBlocks;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    return bytes > 48 * 1024
        ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
        : cudaSuccess;
}

template <int H1, int H2>
int forward_launch(const Args& a, float* mu, float* v, cudaStream_t stream) {
    const Plan p = plan<H1, H2>(a.d);
    cudaError_t err = allow_smem(mlp_forward_kernel<H1, H2>, p.forward_bytes);
    if (err != cudaSuccess) return (int)err;
    mlp_forward_kernel<H1, H2><<<(unsigned)forward_blocks(a.n), kThreads, p.forward_bytes,
                                 stream>>>(a, p.forward_nbuf, mu, v);
    return (int)cudaGetLastError();
}

template <int H1, int H2>
int backward_launch(const Args& a, const float* g_mu, const float* g_v, float* partial,
                    cudaStream_t stream) {
    const Plan p = plan<H1, H2>(a.d);
    cudaError_t err = allow_smem(mlp_backward_kernel<H1, H2>, p.backward_bytes);
    if (err != cudaSuccess) return (int)err;
    mlp_backward_kernel<H1, H2><<<dim3((unsigned)backward_blocks(a.n), 2), kThreads,
                                  p.backward_bytes, stream>>>(a, p.backward_nbuf, p.acc_shared,
                                                              g_mu, g_v, partial);
    return (int)cudaGetLastError();
}

// the instantiated hidden widths (h1, h2): ops/_cuda.py:MLP_HIDDEN
#define MLP_HIDDEN(X) X(64, 64) X(128, 128)

// the least shared bytes a block of either kernel needs at (obs_dim, h1, h2) (one x
// tile; the backward's gradients in its partial row), or 0 where they do not take
// it: widths not instantiated, obs_dim < 1, or more than a block holds
long long takes(int obs_dim, int h1, int h2) {
    if (obs_dim < 1) return 0;
#define MLP_TAKES(w1, w2)                                                         \
    if (h1 == w1 && h2 == w2) {                                                   \
        const Layout<w1, w2> L(obs_dim);                                          \
        const long long f = 4LL * L.forward_floats(1), b = 4LL * L.backward_floats(1, false); \
        const long long least = f > b ? f : b;                                    \
        return least <= kMaxSharedBytes ? least : 0;                              \
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

// The least shared bytes a block of either kernel needs for (obs_dim, h1, h2), or 0
// where the kernels below do not take it (hidden widths other than MLP_HIDDEN, or a
// block's memory exceeded).
extern "C" int mlp_shared_bytes(int obs_dim, int h1, int h2) {
    return (int)takes(obs_dim, h1, h2);
}

// The launches' plan for (obs_dim, h1, h2) into out[5]: the forward's x tiles and
// shared bytes, the backward's x tiles and shared bytes, and 1 where the backward
// accumulates in shared memory (0: in its partial row). Returns a cudaError_t.
extern "C" int mlp_launch_plan(int obs_dim, int h1, int h2, long long* out) {
    if (takes(obs_dim, h1, h2) == 0) return (int)cudaErrorInvalidValue;
#define MLP_PLAN(w1, w2)                                                          \
    if (h1 == w1 && h2 == w2) {                                                   \
        const Plan p = plan<w1, w2>(obs_dim);                                     \
        const long long v[5] = {p.forward_nbuf, p.forward_bytes, p.backward_nbuf, \
                                p.backward_bytes, p.acc_shared ? 1 : 0};          \
        for (int i = 0; i < 5; ++i) out[i] = v[i];                                \
    }
    MLP_HIDDEN(MLP_PLAN)
#undef MLP_PLAN
    return 0;
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
// (contiguous) and the partials [mlp_partial_rows(n), params] out, params the 12
// tensors' elements. Returns a cudaError_t.
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

// The blocks an SM holds of the forward (backward 0) or the backward (1) at
// (obs_dim, h1, h2), from the occupancy calculator; negative for a cudaError_t, 0
// where the kernels do not take the shape.
extern "C" int mlp_blocks_per_sm(int obs_dim, int h1, int h2, int backward) {
    if (takes(obs_dim, h1, h2) == 0) return 0;
    int blocks = 0;
    cudaError_t err = cudaErrorInvalidValue;
#define MLP_OCCUPANCY(w1, w2)                                                              \
    if (h1 == w1 && h2 == w2) {                                                            \
        const Plan p = plan<w1, w2>(obs_dim);                                              \
        if (backward) {                                                                    \
            err = allow_smem(mlp_backward_kernel<w1, w2>, p.backward_bytes);               \
            if (err == cudaSuccess)                                                        \
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                       \
                    &blocks, mlp_backward_kernel<w1, w2>, kThreads, p.backward_bytes);     \
        } else {                                                                           \
            err = allow_smem(mlp_forward_kernel<w1, w2>, p.forward_bytes);                 \
            if (err == cudaSuccess)                                                        \
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                       \
                    &blocks, mlp_forward_kernel<w1, w2>, kThreads, p.forward_bytes);       \
        }                                                                                  \
    }
    MLP_HIDDEN(MLP_OCCUPANCY)
#undef MLP_OCCUPANCY
    return err == cudaSuccess ? blocks : -(int)err;
}

// The rows a tile of the two kernels above, and the rows of the backward's partials
// at n rows (a row a block of each tower: the fixed grid's, fewer below it).
extern "C" int mlp_rows_per_tile() { return kRows; }
extern "C" int mlp_partial_rows(long long n) { return (int)backward_blocks(n); }

static long long reduce_blocks(long long params) {
    return (params + kReduceLanes - 1) / kReduceLanes;
}

static int reduce_launch(const float* partial, float* out, long long rows,
                         long long params, float* block_sq, unsigned int* ticket,
                         float* norm, int device, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows < 1 || params < 1 || reduce_blocks(params) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    mlp_grad_reduce_kernel<<<(unsigned)reduce_blocks(params), dim3(kReduceLanes, kGroups),
                             0, stream>>>(partial, out, rows, params, block_sq, ticket,
                                          norm);
    return (int)cudaGetLastError();
}

// out[p] (params floats) = the sum over the rows of partial[r][p], in the order above.
extern "C" int mlp_grad_reduce_f32(const float* partial, float* out, long long rows,
                                   long long params, int device, void* stream) {
    if (out == nullptr) return (int)cudaErrorInvalidValue;
    return reduce_launch(partial, out, rows, params, nullptr, nullptr, nullptr, device,
                         (cudaStream_t)stream);
}

// The same launch with the norm of out: *norm (one float) = sqrt of the sum over p of
// out[p]^2, in the order above; block_sq mlp_grad_norm_blocks(params) floats of
// scratch; ticket one unsigned int, 0 before the launch and left 0 after it, which
// no other launch may use while this one runs. With out null the launch writes the
// norm alone (the norm-only mode: partial the flat gradient, one row).
extern "C" int mlp_grad_reduce_norm_f32(const float* partial, float* out, float* norm,
                                        float* block_sq, unsigned int* ticket,
                                        long long rows, long long params, int device,
                                        void* stream) {
    if (norm == nullptr || block_sq == nullptr || ticket == nullptr)
        return (int)cudaErrorInvalidValue;
    return reduce_launch(partial, out, rows, params, block_sq, ticket, norm, device,
                         (cudaStream_t)stream);
}

// The reduce's blocks (and so the norm's squares) at params parameters, -1 past an
// int.
extern "C" int mlp_grad_norm_blocks(long long params) {
    return reduce_blocks(params) > 0x7fffffffLL ? -1 : (int)reduce_blocks(params);
}

extern "C" const char* mlp_towers_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
