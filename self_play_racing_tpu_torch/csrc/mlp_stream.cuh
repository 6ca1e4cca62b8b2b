// The actor's and critic's towers of any depth and width on the tensor cores, for
// NVIDIA Hopper (sm_90a): the general route's per-tile forward, run by the rollout's
// general policy kernels (policy_general.cu), and the shapes and the 3xTF32 k-step
// (mma3) that the minibatch step's layer-major kernels (mlp_general.cu) share with
// it, so that a row's mu and v come out of one per-element sequence, bit for bit,
// wherever they run.
//
// The compiled route (mlp_tower.cuh: three layers at (64, 64) and (128, 128), the
// whole tower staged in a block and the activations in a warp's registers) cannot
// hold a wider tower: a 256 x 256 weight alone is 256 KB, over a block's 227 KB. So
// here a tile of rows flows through the layers one at a time, its activations in a
// shared tile [rows][stride], and each layer's weight streams through shared memory
// in chunks of kChunkRows rows (cp.async, a ring of kStages).
//
// A hidden layer's element (r, c) = tanh(sum over k < round_up(K, 8) of x[r][k]
// w[k][c] + b[c]) is summed by mma.sync.m16n8k8 in error-compensated 3xTF32
// (mlp_tower.cuh's split and order: lo*hi, hi*lo, then hi*hi an 8-deep k-step, from
// zero), each k-step's sum added in order from k = 0 to one float32 accumulator that
// lives across the chunks (mma3 below says why). The chunk size, the tile's rows, the
// column passes and the warp that holds the element change nothing of that sequence,
// and an element of row r reads row r alone: so the bits depend on the row and the
// weights alone (row-invariant), and the forward, kernel A and kernel B give equal
// bits for a row. Widths that are
// not a multiple of 8 are padded with zeros in shared memory (the staged weight's
// rows and columns past the tensor, the input features past K, the bias past N:
// tanh(0) = 0 in the padded columns), and padded columns are never written out.
// The narrow last layer (the actor's 2 outputs, the critic's 1) is a warp a row:
// lane l its features l, l + 32, ... by fmaf in order, the butterfly over the lanes
// (xor 1, 2, 4, 8, 16), then the bias; tanh for the actor.
//
// Limits: 1 to kMaxHidden hidden layers, widths and obs_dim 1 to kMaxWidth.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_tower.cuh"

namespace mlp_stream {

using mlp_tower::FragA;
using mlp_tower::FragB;
using mlp_tower::round_up;

constexpr int kMaxWarps = 16;                 // a block's warps at most (the plans take 8)
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxHidden = 7;                 // hidden layers a tower
constexpr int kMaxLayers = kMaxHidden + 1;    // and the narrow last layer
constexpr int kMaxWidth = 1024;               // a hidden width or obs_dim
constexpr int kMaxTiles = 8;                  // n-tiles a warp holds in a column pass
constexpr int kChunkRows = 16;                // weight rows a staged chunk: two k-steps
constexpr int kStages = 3;                    // the chunks' ring: two in flight ahead
constexpr int kPoolRange = 128;               // kernel B's rows a block
constexpr int kTileMax = 64;                  // tile rows: kTileMax, then halves to 16
constexpr int kSmSharedBytes = mlp_tower::kSmSharedBytes;
constexpr int kBlockReservedBytes = mlp_tower::kBlockReservedBytes;
constexpr int kMaxSharedBytes = mlp_tower::kMaxSharedBytes;
constexpr int kTwoBlockBytes = kSmSharedBytes / 2 - kBlockReservedBytes;

// the general route's kernels: the minibatch forward and backward (mlp_general.cu),
// kernels A and B (policy_general.cu, on the plans below)
enum Kind { kForward = 0, kAct = 1, kPool = 2, kBackward = 3 };

// A tower's shape: obs_dim and the hidden widths (the outputs are the caller's).
struct Shape {
    int hidden;                  // hidden layers, 1 to kMaxHidden
    int dims[kMaxHidden + 1];    // dims[0] = obs_dim, dims[1 .. hidden] the widths
};

__host__ __device__ inline int widest(const Shape& s) {
    int w = 0;
    for (int i = 0; i <= s.hidden; ++i) w = s.dims[i] > w ? s.dims[i] : w;
    return w;
}

__host__ __device__ inline bool valid_shape(const Shape& s) {
    if (s.hidden < 1 || s.hidden > kMaxHidden) return false;
    for (int i = 0; i <= s.hidden; ++i)
        if (s.dims[i] < 1 || s.dims[i] > kMaxWidth) return false;
    return true;
}

// the shape (obs_dim, hidden widths) of dims[num_dims], false where the route does
// not take it
__host__ __device__ inline bool shape_of(const int* dims, int num_dims, Shape* s) {
    if (dims == nullptr || num_dims < 2 || num_dims > kMaxHidden + 1) return false;
    s->hidden = num_dims - 1;
    for (int i = 0; i < num_dims; ++i) s->dims[i] = dims[i];
    return valid_shape(*s);
}

// a tower's parameters with `outputs` outputs, in model.parameters() order
__host__ __device__ inline long long tower_params(const Shape& s, int outputs) {
    long long p = 0;
    for (int l = 0; l <= s.hidden; ++l) {
        const long long out = l < s.hidden ? s.dims[l + 1] : outputs;
        p += (long long)s.dims[l] * out + out;
    }
    return p;
}

// Kernel A's or B's launch plan at a shape: the block's warps, the tile's rows (16 a
// fragment), the activation tiles' row stride (the widest width to 32, and 4: rows 4
// banks apart), the warps on a fragment, the n-tiles a warp holds, a column pass's
// columns (warps on a fragment x n-tiles a warp x 8), the floats of one staged chunk
// (kStages of them) and the shared bytes.
struct Plan {
    int warps, rows, frags, stride, groups, tiles, cols, chunk;
    long long shared_bytes;
};

__host__ __device__ inline int forward_chunk(int cols) {
    return kChunkRows * (round_up(cols, 32) + 8);
}

// the floats a kind needs besides the activation tiles and chunks
__host__ __device__ inline int extra_floats(int kind, int rows, int stride) {
    const int y = round_up(3 * rows, 4);  // the rows' (mu0, mu1, v) or (g0, g1, -)
    if (kind == kAct) return y + 2 * stride;
    if (kind == kPool) return y + 2 * stride + round_up(3 * kPoolRange + kMaxWarps, 4);
    return y;
}

// 8 warps a block (for kernels A and B at 4096 rows, 16 were slower on an H100: the
// n-tiles a warp too few)
__host__ __device__ inline Plan plan_at(int kind, const Shape& s, int rows, int max_tiles) {
    Plan p;
    p.warps = kMaxWarps / 2;
    p.rows = rows;
    p.frags = rows / 16;
    p.stride = round_up(widest(s), 32) + 4;
    p.groups = p.warps / p.frags;
    const int ntiles = (widest(s) + 7) / 8;
    const int per = (ntiles + p.groups - 1) / p.groups;
    p.tiles = per < max_tiles ? per : max_tiles;
    p.cols = 8 * p.groups * p.tiles;
    p.chunk = forward_chunk(p.cols);
    // two activation tiles
    const long long floats = (long long)kStages * p.chunk + extra_floats(kind, rows, p.stride)
        + 2LL * rows * p.stride;
    p.shared_bytes = 4 * floats;
    return p;
}

// Kernel A's or B's plan at `s`, the first that fits, by the most n-tiles a warp (8,
// 4, 2, 1: the mma.sync products between two barriers), then the most rows a tile
// (64, 32, 16: the rows each staged chunk serves): first within room for two blocks
// an SM (a rollout step's few thousand rows, so that more blocks share the card),
// then within a block's memory. rows 0: not taken.
__host__ __device__ inline Plan make_plan(int kind, const Shape& s) {
    Plan none{};
    if ((kind != kAct && kind != kPool) || !valid_shape(s)) return none;
    for (int limit = 0; limit < 2; ++limit) {
        const long long bytes = limit == 0 ? kTwoBlockBytes : kMaxSharedBytes;
        for (int tiles = kMaxTiles; tiles >= 1; tiles /= 2)
            for (int rows = kTileMax; rows >= 16; rows /= 2) {
                const Plan p = plan_at(kind, s, rows, tiles);
                if (p.shared_bytes <= bytes) return p;
            }
    }
    return none;
}

// a kernel's dynamic shared memory past the default 48 KB (host side, at launch)
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
    return bytes > 48 * 1024
        ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
        : cudaSuccess;
}

// ------------------------------------------------------------------ the products

// acc += one k-step's 3xTF32 product A B: the three products lo*hi, hi*lo, hi*hi
// summed on the tensor cores from zero, then added to acc by a float32 add (rounded
// to nearest). The tensor cores' own float32 accumulation does not round to nearest,
// and over a long k it drifts: accumulated there across k-steps, the forward's mu at
// (19, 1024, 1024) came 1.4e-5 from the plain composition on an H100, past phase p's
// 1e-5 bound (chip_smoke.py phase s). So no sum runs longer than one k-step there.
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a, const FragB& b) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mlp_tower::mma(d, a.lo, b.hi);
    mlp_tower::mma(d, a.hi, b.lo);
    mlp_tower::mma(d, a.hi, b.hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// A chunk's copies: the weight w [K][N]'s rows [k0, k0 + kChunkRows) and columns
// [c0, c0 + cols) at chunk[kr][round_up(cols, 32) + 8]; zero where past the tensor.
// Four consecutive floats a copy: 16 bytes where all four lie in the tensor and the
// source is 16-byte aligned (w aligned and N a multiple of 4; c0 and cols are
// multiples of 4), else a float a copy. A thread's groups are stepped without a
// division. The caller commits.
__device__ __forceinline__ void stage_chunk(float* chunk, const float* w, int K, int N, int k0,
                                            int c0, int cols) {
    const bool wide = mlp_tower::aligned16(w) && (N & 3) == 0;
    // groups of 4 a line: a chunk row of cols
    const int per_line = cols / 4;
    const int lines = kChunkRows;
    const int ls = round_up(cols, 32) + 8;
    const int threads = blockDim.x;
    const int step_lines = threads / per_line, step_groups = threads - step_lines * per_line;
    int line = threadIdx.x / per_line, g = threadIdx.x - line * per_line;
    for (; line < lines;) {
        // w's row and first column of the group
        const int row = k0 + line;
        const int col = c0 + 4 * g;
        float* dst = chunk + line * ls + 4 * g;
        const bool in_rows = row < K;
        if (wide && in_rows && col + 3 < N) {
            mlp_tower::cp_async16(dst, w + (long long)row * N + col, true);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool valid = in_rows && col + e < N;
                mlp_tower::cp_async4(dst + e, valid ? w + (long long)row * N + col + e : w, valid);
            }
        }
        line += step_lines;
        g += step_groups;
        if (g >= per_line) {
            g -= per_line;
            ++line;
        }
    }
}

// One streamed product over the tile: out[r][c] for c < round_up(cols_out, 8) =
// tanh(acc + b[c]) (b 0 past cols_out), acc the sum over k < round_up(contract, 8) of
// in[r][k] w[k][c], w [contract][cols_out]. in, out: [rows][stride] tiles in shared
// memory; chunk: kStages slots of p.chunk floats in shared memory. The chunks go in
// column passes of p.cols, each pass its contraction's chunks in order, kStages - 1 in
// flight while one is read. Every thread of the block calls it; it returns after a
// barrier, with out whole.
__device__ void stream_product(const Plan& p, const float* in, float* out, const float* w,
                               const float* b, int contract, int cols_out, float* chunk) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int frag = warp / p.groups, grp = warp - frag * p.groups;
    const int kp = round_up(contract, 8), np = round_up(cols_out, 8);
    const int chunks = (kp + kChunkRows - 1) / kChunkRows;
    const int passes = (np + p.cols - 1) / p.cols;
    const int total = passes * chunks;
    const int cs = round_up(p.cols, 32) + 8;
    const int r0 = 16 * frag + g, r1 = r0 + 8;
    const float* ar0 = in + r0 * p.stride;
    const float* ar1 = in + r1 * p.stride;
    float acc[kMaxTiles][4];
    // the ring: chunk j in slot j % kStages, kStages - 1 in flight ahead of the one
    // read; one commit group a chunk (empty past the last), one barrier a chunk
    auto stage = [&](int j) {
        if (j < total) {
            const int pj = j / chunks, cj = j - pj * chunks;
            stage_chunk(chunk + (j % kStages) * p.chunk, w, contract, cols_out, cj * kChunkRows,
                        pj * p.cols, p.cols);
        }
        mlp_tower::cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) stage(j);
    for (int i = 0; i < total; ++i) {
        const int pass = i / chunks, c = i - pass * chunks;
        mlp_tower::cp_async_wait<kStages - 2>();  // chunk i has landed
        __syncthreads();  // every thread's copies of it; every warp done with chunk i - 1
        stage(i + kStages - 1);  // into chunk i - 1's slot
        const float* ch = chunk + (i % kStages) * p.chunk;
        const int col0 = pass * p.cols + 8 * grp * p.tiles;  // the warp's first column
        if (c == 0) {
#pragma unroll
            for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
        }
        const int left = kp - c * kChunkRows;
        const int ksteps = (left < kChunkRows ? left : kChunkRows) / 8;
        for (int ks = 0; ks < ksteps; ++ks) {
            const int k = c * kChunkRows + 8 * ks + t, kl = 8 * ks + t;
            const FragA fa = mlp_tower::frag_a(ar0[k], ar1[k], ar0[k + 4], ar1[k + 4]);
#pragma unroll
            for (int j = 0; j < kMaxTiles; ++j) {
                const int n = col0 + 8 * j;
                if (j < p.tiles && n < np) {
                    const int nl = n - pass * p.cols + g;
                    const FragB fb = mlp_tower::frag_b(ch[kl * cs + nl], ch[(kl + 4) * cs + nl]);
                    mma3(acc[j], fa, fb);
                }
            }
        }
        if (c == chunks - 1) {
#pragma unroll
            for (int j = 0; j < kMaxTiles; ++j) {
                const int n = col0 + 8 * j + 2 * t;
                if (j < p.tiles && n < np) {
                    float v[4];
                    const float b0 = n < cols_out ? b[n] : 0.0f;
                    const float b1 = n + 1 < cols_out ? b[n + 1] : 0.0f;
                    v[0] = tanhf(acc[j][0] + b0);
                    v[1] = tanhf(acc[j][1] + b1);
                    v[2] = tanhf(acc[j][2] + b0);
                    v[3] = tanhf(acc[j][3] + b1);
                    out[r0 * p.stride + n] = v[0];
                    out[r0 * p.stride + n + 1] = v[1];
                    out[r1 * p.stride + n] = v[2];
                    out[r1 * p.stride + n + 1] = v[3];
                }
            }
        }
    }
    __syncthreads();  // out whole; the ring's slots free for the next product
}

// The narrow last layer of the tile's rows: y[r * 3 + slot + o] (o < outputs) = the
// sum over k < K of in[r][k] w[k][o], lane l its features l, l + 32, ... by fmaf in
// order, then the butterfly over the lanes and + b[o]; tanh where `bounded` (the
// actor). A warp a row; no barrier.
__device__ __forceinline__ void narrow_layer(const Plan& p, const float* in, int K, int outputs,
                                             const float* w, const float* b, bool bounded,
                                             float* y, int slot) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < p.rows; r += p.warps) {
        const float* x = in + r * p.stride;
        for (int o = 0; o < outputs; ++o) {
            float z = 0.0f;
            for (int k = lane; k < K; k += 32) z = __fmaf_rn(x[k], w[k * outputs + o], z);
            z = mlp_tower::lanes_sum(z, 1, 16) + b[o];
            if (lane == 0) y[r * 3 + slot + o] = bounded ? tanhf(z) : z;
        }
    }
}

// One tower's forward of the tile in a0 ([rows][stride], features past obs_dim zero
// to round_up(obs_dim, 8)): the hidden layers through a0 and a1 in turn (a0 is
// overwritten from the second), then the narrow layer into y's slot. Ends on a
// barrier.
__device__ __forceinline__ void tower_forward(const Plan& p, const Shape& s, const float* const* w,
                                              const float* const* b, int outputs, float* a0,
                                              float* a1, float* chunk, float* y, int slot) {
    float* in = a0;
    float* out = a1;
    for (int l = 0; l < s.hidden; ++l) {
        stream_product(p, in, out, w[l], b[l], s.dims[l], s.dims[l + 1], chunk);
        float* next = out;
        out = in;
        in = next;
    }
    narrow_layer(p, in, s.dims[s.hidden], outputs, w[s.hidden], b[s.hidden], outputs == 2, y, slot);
    __syncthreads();
}

// rows [0, rows) of a tile into x [rows][stride]: features c < round_up(d, 8), from
// row_at(r) (a row's first float, null for none) and zero past d or where null.
// Plain loads and stores; the caller's barrier.
template <class RowAt>
__device__ __forceinline__ void stage_rows(float* x, int stride, int rows, int d, RowAt row_at) {
    const int dk = round_up(d, 8);
    for (int e = threadIdx.x; e < rows * dk; e += blockDim.x) {
        const int r = e / dk, c = e - r * dk;
        const float* src = row_at(r);
        x[r * stride + c] = src != nullptr && c < d ? src[c] : 0.0f;
    }
}

}  // namespace mlp_stream
