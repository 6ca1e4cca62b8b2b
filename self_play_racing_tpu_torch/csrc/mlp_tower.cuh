// The forward body of the actor's and critic's MLP towers on the tensor cores, for
// NVIDIA Hopper (sm_90a): shared by the minibatch step's kernels (mlp_towers.cu) and
// the rollout's policy kernels (policy.cu), so that a row's mu and v come out of
// the same device code, bit for bit, wherever it runs.
//
// What is here (mlp_towers.cu's head says why each is as it is): the block shape,
// the shared-memory layout of a tower and an observation tile (Layout), the
// weights' swizzle, the error-compensated 3xTF32 mma.sync product, the staging of
// a tower with cp.async, and a warp's forward of 16 rows: layer1, layer2 and
// last_layer (tower_forward writes the result). A row's outputs depend on that
// row alone, in an order fixed by this code, whatever block or launch it is in.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mlp_tower {

constexpr int kWarps = 4;                // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;       // rows a tile: 16 a warp, an m16 tile
constexpr int kSmSharedBytes = 233472;     // an SM's shared memory on an H100
constexpr int kBlockReservedBytes = 1024;  // of it, what the runtime keeps a block
constexpr int kMaxSharedBytes = kSmSharedBytes - kBlockReservedBytes;  // a block's

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory, in floats. A tower's parameters: w1 [dk][H1] and w2 [H1][H2] (each
// row swizzled, swz), b1, b2, w3 [H2][2] and b3 [2] (the critic uses one column);
// the tile's observations x [kRows][xs], features zero from d, xs d rounded up to 16
// (the backward's x^T g1 reads 16 features at a time) and 8 more: 8 mod 16, so that
// the rows' banks lie 8 or 24 apart and the forward's pairs (rows g, 2t) and the
// backward's columns (rows t, column g) fall on 32 different banks.
// Backward: the activations a [kRows][H1 + 8] (h1, then g1) and g [kRows][H2 + 8]
// (g2), the warps' narrow sums, and the gradients accumulated over the block's tiles
// (w1 [d][H1 + 8], b1, w2 [H1][H2 + 8], b2, w3 [H2][2], b3) where they fit.
template <int H1, int H2>
struct Layout {
    static_assert(H1 % 64 == 0 && H2 % 64 == 0, "the units of the products assume 64k");
    int d, dk, xs, w1, b1, w2, b2, w3, b3, tower, xtile;
    __host__ __device__ explicit Layout(int obs_dim)
        : d(obs_dim), dk(round_up(obs_dim, 8)),
          xs(round_up(obs_dim, 16) + 8),
          w1(0), b1(dk * H1), w2(b1 + H1), b2(w2 + H1 * H2), w3(b2 + H2), b3(w3 + 2 * H2),
          tower(round_up(b3 + 2, 4)), xtile(kRows * xs) {}
    // the forward: both towers, then nbuf x tiles
    __host__ __device__ int forward_floats(int nbuf) const { return 2 * tower + nbuf * xtile; }
    // the backward's regions after the tower and the x tiles
    __host__ __device__ int act() const { return kRows * (H1 + 8); }
    __host__ __device__ int grad() const { return kRows * (H2 + 8); }
    __host__ __device__ int narrow() const { return round_up(kWarps * (H1 + 3 * H2 + 2), 4); }
    __host__ __device__ int acc_w1() const { return 0; }
    __host__ __device__ int acc_b1() const { return d * (H1 + 8); }
    __host__ __device__ int acc_w2() const { return acc_b1() + H1; }
    __host__ __device__ int acc_b2() const { return acc_w2() + H1 * (H2 + 8); }
    __host__ __device__ int acc_w3() const { return acc_b2() + H2; }
    __host__ __device__ int acc_b3() const { return acc_w3() + 2 * H2; }
    __host__ __device__ int acc() const { return round_up(acc_b3() + 2, 4); }
    __host__ __device__ int backward_floats(int nbuf, bool acc_shared) const {
        return tower + nbuf * xtile + act() + grad() + narrow() + (acc_shared ? acc() : 0);
    }
};

// element (k, n) of a weight [K][N] (N a multiple of 32) at k * N + swz(k, n): the
// column's bits 3-4 XOR a key of the row, so that the forward's reads (rows 2t, 2t+1
// of 8, columns g of 8) and the backward's transposed pairs (row g, columns 2t, 2t+1)
// each fall on 32 different banks
__host__ __device__ __forceinline__ int row_key(int k) { return ((k >> 1) ^ k) & 3; }
__device__ __forceinline__ int swz(int k, int n) { return n ^ (row_key(k) << 3); }

// ------------------------------------------------------------------ the 3xTF32 product

// cvt.rna.tf32.f32 on the integer view: the nearest 10-bit mantissa, ties away from
// zero (half of the 13 dropped bits added to the magnitude, then cut); bit for bit the
// instruction's result, on the integer pipes at 1.6x its rate as the split runs here
// (scripts/mma_tf32_rate.cu)
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an A fragment (rows g, g + 8, k t, t + 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)) or a B fragment (k t, t + 4 of column g), each float32 as hi + lo
struct FragA {
    uint32_t hi[4], lo[4];
};
struct FragB {
    uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
    FragA f;
    split(a0, f.hi[0], f.lo[0]);
    split(a1, f.hi[1], f.lo[1]);
    split(a2, f.hi[2], f.lo[2]);
    split(a3, f.hi[3], f.lo[3]);
    return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
    FragB f;
    split(b0, f.hi[0], f.lo[0]);
    split(b1, f.hi[1], f.lo[1]);
    return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[c0 + j] += A B_j for j < NB: lo*hi, hi*lo, then hi*hi, each pass over the
// n-tiles so that the three products of one accumulator are not back to back
template <int NJ, int NB>
__device__ __forceinline__ void mma3(float (&acc)[NJ][4], int c0, const FragA& a,
                                     const FragB (&b)[NB]) {
#pragma unroll
    for (int j = 0; j < NB; ++j) mma(acc[c0 + j], a.lo, b[j].hi);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma(acc[c0 + j], a.hi, b[j].lo);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma(acc[c0 + j], a.hi, b[j].hi);
}

// A lane's place in the fragments and its swizzle offsets: column n = 8 j + g of row
// 8 kk + 2 t (+ 1) is at 8 (j & ~3) + off0[j & 3] (off1); the transposed pair
// (row 8 j + g, columns 8 kk + 2 t, + 1) at 8 (kk & ~3) + offt[kk & 3].
struct Lane {
    int g, t, off0[4], off1[4], offt[4];
    __device__ explicit Lane(int lane) : g(lane >> 2), t(lane & 3) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            off0[q] = 8 * (q ^ row_key(2 * t)) + g;
            off1[q] = 8 * (q ^ row_key(2 * t + 1)) + g;
            offt[q] = 8 * (q ^ row_key(g)) + 2 * t;
        }
    }
};

template <int N>
__device__ __forceinline__ FragB weight_b(const float* W, int kk, int j, const Lane& l) {
    const float* r0 = W + (8 * kk + 2 * l.t) * N + 8 * (j & ~3);
    return frag_b(r0[l.off0[j & 3]], r0[N + l.off1[j & 3]]);
}

// acc[j] (the warp's 16 rows, n-tiles j < N / 8) += A times the weight W [K][N]
// (swizzled) on its rows 8 kk .. 8 kk + 7, A's k t and t + 4 being rows 2t and 2t + 1
template <int N>
__device__ __forceinline__ void times_weight(float (&acc)[N / 8][4], const FragA& a,
                                             const float* W, int kk, const Lane& l) {
    constexpr int kChunk = 8;  // n-tiles whose B fragments are held at once
#pragma unroll
    for (int c = 0; c < N / 8; c += kChunk) {
        FragB b[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) b[j] = weight_b<N>(W, kk, c + j, l);
        mma3(acc, c, a, b);
    }
}

// acc[j] += G times W^T, W [N][K] swizzled: on K's rows 8 kk .. 8 kk + 7 (A's k t,
// t + 4 being columns 2t, 2t + 1 of W), the pair read at once
template <int N, int K>
__device__ __forceinline__ void times_weight_t(float (&acc)[N / 8][4], const FragA& a,
                                               const float* W, int kk, const Lane& l) {
    constexpr int kChunk = 8;
#pragma unroll
    for (int c = 0; c < N / 8; c += kChunk) {
        FragB b[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
            const float2 p = *reinterpret_cast<const float2*>(
                W + (8 * (c + j) + l.g) * K + 8 * (kk & ~3) + l.offt[kk & 3]);
            b[j] = frag_b(p.x, p.y);
        }
        mma3(acc, c, a, b);
    }
}

// an accumulator of n-tile kk as the next product's A fragment (k t = column 2t,
// k t + 4 = column 2t + 1)
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
    return frag_a(c[0], c[2], c[1], c[3]);
}

// acc += G W^T over all of K (G the warp's accumulators of [16][K], W [N][K])
template <int N, int K>
__device__ __forceinline__ void times_transposed(float (&acc)[N / 8][4], const float (&g)[K / 8][4],
                                                 const float* W, const Lane& l) {
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) times_weight_t<N, K>(acc, acc_as_a(g[kk]), W, kk, l);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// acc = tanh(acc + b) (the bias of columns 8 j + 2t, + 1)
template <int NJ>
__device__ __forceinline__ void bias_tanh(float (&acc)[NJ][4], const float* b, const Lane& l) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * l.t);
        // split: any no_tanh { acc[j][0] += bb.x; acc[j][1] += bb.y; acc[j][2] += bb.x; acc[j][3] += bb.y; continue; }
        acc[j][0] = tanhf(acc[j][0] + bb.x);
        acc[j][1] = tanhf(acc[j][1] + bb.y);
        acc[j][2] = tanhf(acc[j][2] + bb.x);
        acc[j][3] = tanhf(acc[j][3] + bb.y);
    }
}

// the sum over the lanes whose bits `mask` differ, by a butterfly in a fixed order:
// every lane of the group holds the same bits
__device__ __forceinline__ float lanes_sum(float v, int from, int to) {
#pragma unroll
    for (int m = from; m <= to; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// the activations' rows of this warp (16 of them) in a shared tile [kRows][S]
template <int NJ, int S>
__device__ __forceinline__ void store_rows(float* tile, const float (&v)[NJ][4], const Lane& l) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<float2*>(tile + l.g * S + 8 * j + 2 * l.t) = make_float2(v[j][0], v[j][1]);
        *reinterpret_cast<float2*>(tile + (l.g + 8) * S + 8 * j + 2 * l.t) =
            make_float2(v[j][2], v[j][3]);
    }
}

// ------------------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void zero_x(float* x, int nbuf, int d, int xs) {
    const int pad = xs - d;
    for (int e = threadIdx.x; e < nbuf * kRows * pad; e += kThreads) {
        const int r = e / pad;
        x[r * xs + d + (e - r * pad)] = 0.0f;
    }
}

// a weight [K][N] (k_real rows given, the rest to k zero) into shared memory,
// swizzled, with cp.async (the copies in flight together; cp_async_wait_all)
template <int N>
__device__ __forceinline__ void stage_weight(float* dst, const float* w, int k_real, int k) {
    for (int e = threadIdx.x; e < k * N; e += kThreads) {
        const int r = e / N, c = e % N;
        cp_async4(dst + r * N + swz(r, c), w + (r < k_real ? e : 0), r < k_real);
    }
}

__device__ __forceinline__ void stage_plain(float* dst, const float* w, int count) {
    for (int e = threadIdx.x; e < count; e += kThreads) cp_async4(dst + e, w + e, true);
}

template <int H1, int H2>
__device__ __forceinline__ void stage_tower(const Layout<H1, H2>& L, const float* const* w,
                                            float* s, int O) {
    stage_weight<H1>(s + L.w1, w[0], L.d, L.dk);
    stage_plain(s + L.b1, w[1], H1);
    stage_weight<H2>(s + L.w2, w[2], H1, H1);
    stage_plain(s + L.b2, w[3], H2);
    stage_plain(s + L.w3, w[4], H2 * O);
    stage_plain(s + L.b3, w[5], O);
    cp_async_commit();
}

// --------------------------------------------- wide staging (the policy kernels)

// 16 bytes (zero-filled where !valid); the source 16-byte aligned. Through L1 (.ca),
// as cp_async4: the blocks that share an SM read the same towers.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
}
// wait until at most `pending` of this thread's newest commit groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}
__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// stage_weight's layout by `threads` threads, 4 floats a copy where the source is
// 16-byte aligned: swz moves bits 3-4 of the column, so 4 columns from a multiple of
// 4 stay contiguous and in order; an unaligned source (a view into a flat buffer, a
// stacked member's odd offset) a float a copy
template <int N, int threads>
__device__ __forceinline__ void stage_weight_wide(float* dst, const float* w, int k_real, int k) {
    if (aligned16(w)) {
        for (int e = threadIdx.x; e < k * (N / 4); e += threads) {
            const int r = e / (N / 4), c = 4 * (e - r * (N / 4));
            cp_async16(dst + r * N + swz(r, c), w + (r < k_real ? r * N + c : 0), r < k_real);
        }
    } else {
        for (int e = threadIdx.x; e < k * N; e += threads) {
            const int r = e / N, c = e - r * N;
            cp_async4(dst + r * N + swz(r, c), w + (r < k_real ? e : 0), r < k_real);
        }
    }
}

// count floats to a 16-byte aligned dst, 4 a copy where the source is aligned
template <int threads>
__device__ __forceinline__ void stage_plain_wide(float* dst, const float* w, int count) {
    const int wide = aligned16(w) ? count / 4 : 0;
    for (int e = threadIdx.x; e < wide; e += threads) cp_async16(dst + 4 * e, w + 4 * e, true);
    for (int e = 4 * wide + threadIdx.x; e < count; e += threads) cp_async4(dst + e, w + e, true);
}

// A tower in stage_tower's layout in two parts, each the caller's commit group: the
// first layer (w1, b1), then the rest (w2, b2, w3, b3), so that layer1 can run while
// the rest is in flight.
template <int H1, int H2, int threads>
__device__ __forceinline__ void stage_first_layer(const Layout<H1, H2>& L, const float* const* w,
                                                  float* s) {
    stage_weight_wide<H1, threads>(s + L.w1, w[0], L.d, L.dk);
    stage_plain_wide<threads>(s + L.b1, w[1], H1);
}
template <int H1, int H2, int threads>
__device__ __forceinline__ void stage_later_layers(const Layout<H1, H2>& L, const float* const* w,
                                                   float* s, int O) {
    stage_weight_wide<H2, threads>(s + L.w2, w[2], H1, H1);
    stage_plain_wide<threads>(s + L.b2, w[3], H2);
    stage_plain_wide<threads>(s + L.w3, w[4], H2 * O);
    stage_plain_wide<threads>(s + L.b3, w[5], O);
}

// ------------------------------------------------------------------ a warp's forward

// The hidden layers of this warp's 16 rows x (stride xs): h1 = tanh(x W1 + b1),
// h2 = tanh(h1 W2 + b2), both as accumulators.
template <int H1, int H2>
__device__ __forceinline__ void layer1(const Layout<H1, H2>& L, const float* T, const float* x,
                                       float (&h1)[H1 / 8][4], const Lane& l) {
    zero(h1);
    for (int kk = 0; kk < L.dk / 8; ++kk) {
        const float2 p = *reinterpret_cast<const float2*>(x + l.g * L.xs + 8 * kk + 2 * l.t);
        const float2 q = *reinterpret_cast<const float2*>(x + (l.g + 8) * L.xs + 8 * kk + 2 * l.t);
        times_weight<H1>(h1, frag_a(p.x, q.x, p.y, q.y), T + L.w1, kk, l);
    }
    bias_tanh(h1, T + L.b1, l);
}

template <int H1, int H2>
__device__ __forceinline__ void layer2(const Layout<H1, H2>& L, const float* T,
                                       const float (&h1)[H1 / 8][4], float (&h2)[H2 / 8][4],
                                       const Lane& l) {
    zero(h2);
#pragma unroll
    for (int kk = 0; kk < H1 / 8; ++kk) times_weight<H2>(h2, acc_as_a(h1[kk]), T + L.w2, kk, l);
    bias_tanh(h2, T + L.b2, l);
}

// The last layer of rows g and g + 8: z[o] = h2 W3 + b3 for o < O (1 or 2), each
// lane its columns 8 j + 2t, + 1 in order, then the 4 lanes of the row summed; tanh
// for the actor's (O = 2).
template <int H2>
__device__ __forceinline__ void last_layer(const float* w3, const float* b3,
                                           const float (&h2)[H2 / 8][4], int O, float (&y0)[2],
                                           float (&y1)[2], const Lane& l) {
    float z[4];  // rows g and g + 8, outputs 0 and 1
#pragma unroll
    for (int o = 0; o < 2; ++o) {
        float z0 = 0.0f, z1 = 0.0f;
        if (o < O) {
#pragma unroll
            for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float w = w3[(8 * j + 2 * l.t + e) * O + o];
                    z0 = __fmaf_rn(h2[j][e], w, z0);
                    z1 = __fmaf_rn(h2[j][2 + e], w, z1);
                }
            }
        }
        z0 = lanes_sum(z0, 1, 2);
        z1 = lanes_sum(z1, 1, 2);
        z[o] = o < O ? z0 + b3[o] : 0.0f;
        z[2 + o] = o < O ? z1 + b3[o] : 0.0f;
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
        y0[o] = O == 2 ? tanhf(z[o]) : z[o];
        y1[o] = O == 2 ? tanhf(z[2 + o]) : z[2 + o];
    }
}

// One tower's forward of this warp's 16 rows (O outputs: the actor's 2, the critic's
// 1), written to out [n, O].
template <int H1, int H2>
__device__ __forceinline__ void tower_forward(const Layout<H1, H2>& L, const float* T,
                                              const float* x, int O, float* out, long long row,
                                              long long n, const Lane& l) {
    float h1[H1 / 8][4], h2[H2 / 8][4];
    layer1(L, T, x, h1, l);
    // split: forward layer1 { sink(h1, out); return; }
    layer2(L, T, h1, h2, l);
    // split: forward layer2 { sink(h2, out); return; }
    float y0[2], y1[2];
    last_layer<H2>(T + L.w3, T + L.b3, h2, O, y0, y1, l);
    const long long r = row + (l.t == 0 ? l.g : l.g + 8);
    if (l.t < 2 && r < n) {
#pragma unroll
        for (int o = 0; o < 2; ++o)
            if (o < O) out[r * O + o] = l.t == 0 ? y0[o] : y1[o];
    }
}

// ------------------------------------------- a fragment by a group of warps (policy.cu)

// n-tiles [c0, c0 + NT) of times_weight, c0 known at run time: the same B fragments
// (weight_b's addresses, the offsets formed from the lane's keys), each accumulator's
// products in the same order
template <int N, int NT>
__device__ __forceinline__ void times_weight_cols(float (&acc)[NT][4], const FragA& a,
                                                  const float* W, int kk, int c0, const Lane& l) {
    constexpr int kChunk = NT < 8 ? NT : 8;
    const float* r0 = W + (8 * kk + 2 * l.t) * N;
    const int k0 = row_key(2 * l.t), k1 = row_key(2 * l.t + 1);
#pragma unroll
    for (int c = 0; c < NT; c += kChunk) {
        FragB b[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
            const int n = c0 + c + j, base = 8 * (n & ~3) + l.g;
            b[j] = frag_b(r0[base + 8 * ((n & 3) ^ k0)], r0[N + base + 8 * ((n & 3) ^ k1)]);
        }
        mma3(acc, c, a, b);
    }
}

// rows g and g + 8 of a tile (row stride S) at columns 8 kk + 2t, + 1 as an A
// fragment: layer1's read of x, and acc_as_a of the accumulator store_rows wrote there
__device__ __forceinline__ FragA rows_as_a(const float* tile, int S, int kk, const Lane& l) {
    const float2 p = *reinterpret_cast<const float2*>(tile + l.g * S + 8 * kk + 2 * l.t);
    const float2 q = *reinterpret_cast<const float2*>(tile + (l.g + 8) * S + 8 * kk + 2 * l.t);
    return frag_a(p.x, q.x, p.y, q.y);
}

// a named barrier of `threads` (whole warps, each converged first: bar.sync is aligned)
__device__ __forceinline__ void bar_sync(int id, int threads) {
    __syncwarp();
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One 16-row fragment through one tower by a group of S warps, this warp the group's
// w-th, the group's named barrier `bar`: each warp takes n-tiles [w NT, (w + 1) NT) of
// both hidden layers (layer1's and layer2's products, each element summed over k in
// their order), h1 and then h2 pass through the group's tile t [16][max(H1, H2) + 8],
// and warp 0 reads all of h2 back in the register layout for last_layer. So the
// outputs are tower_forward's bits. At S = 1, layer1, layer2 and last_layer as they
// are, the activations in registers.
template <int H1, int H2, int S>
struct GroupTower {
    static_assert(H1 % (8 * S) == 0 && H2 % (8 * S) == 0, "n-tiles a warp");
    static constexpr int NT1 = H1 / 8 / S, NT2 = H2 / 8 / S;
    static constexpr int stride = (H1 > H2 ? H1 : H2) + 8;
    static constexpr int floats = S == 1 ? 0 : 16 * stride;
    float h1[NT1][4];
    float* t;
    int w, bar;
    __device__ GroupTower(float* tile, int warp_in_group, int barrier)
        : t(tile), w(warp_in_group), bar(barrier) {}

    __device__ __forceinline__ void sync() const {
        if constexpr (S > 1) bar_sync(bar, 32 * S);
    }

    // layer 1 of the 16 rows of x (stride L.xs); `reuse`: the tile may still be read
    // (the group's previous fragment). The group's h1 is whole after the group's
    // barrier (sync(), or the block's).
    __device__ __forceinline__ void first(const Layout<H1, H2>& L, const float* T,
                                          const float* x, bool reuse, const Lane& l) {
        zero(h1);
        for (int kk = 0; kk < L.dk / 8; ++kk)
            times_weight_cols<H1, NT1>(h1, rows_as_a(x, L.xs, kk, l), T + L.w1, kk, w * NT1, l);
        bias_tanh(h1, T + L.b1 + 8 * w * NT1, l);
        if constexpr (S > 1) {
            if (reuse) sync();
            store_rows<NT1, stride>(t + 8 * w * NT1, h1, l);
        }
    }

    // layer 2 and the last layer (O outputs): true on the warp that holds (y0, y1),
    // rows g and g + 8
    __device__ __forceinline__ bool rest(const Layout<H1, H2>& L, const float* T, int O,
                                         float (&y0)[2], float (&y1)[2], const Lane& l) {
        float h2[H2 / 8][4];
        if constexpr (S == 1) {
            layer2(L, T, h1, h2, l);
            // split: tower layer2 { sink(h2); return false; }
        } else {
            float part[NT2][4];
            zero(part);
#pragma unroll
            for (int kk = 0; kk < H1 / 8; ++kk)
                times_weight_cols<H2, NT2>(part, rows_as_a(t, stride, kk, l), T + L.w2, kk,
                                           w * NT2, l);
            bias_tanh(part, T + L.b2 + 8 * w * NT2, l);
            // split: tower layer2 { sink(part); return false; }
            sync();  // every warp has read h1
            store_rows<NT2, stride>(t + 8 * w * NT2, part, l);
            sync();
            if (w != 0) return false;
#pragma unroll
            for (int j = 0; j < H2 / 8; ++j) {
                const float2 p = *reinterpret_cast<const float2*>(t + l.g * stride + 8 * j + 2 * l.t);
                const float2 q =
                    *reinterpret_cast<const float2*>(t + (l.g + 8) * stride + 8 * j + 2 * l.t);
                h2[j][0] = p.x;
                h2[j][1] = p.y;
                h2[j][2] = q.x;
                h2[j][3] = q.y;
            }
        }
        last_layer<H2>(T + L.w3, T + L.b3, h2, O, y0, y1, l);
        return true;
    }
};

}  // namespace mlp_tower
