// The actor's and critic's MLPs of the PPO minibatch step on the general route:
// towers of any depth (1 to 7 hidden layers) and width (1 to 1024, obs_dim 1 to
// 1024), forward and backward, for NVIDIA Hopper (sm_90a), their products on the
// tensor cores in 3xTF32 (mlp_stream.cuh).
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
// bytes (observations, mu, v, the weights, the partials) are a few MB: bound by
// operations. mma.sync reaches ~211 TFLOP/s on this card (scripts/mma_tf32_rate.cu),
// so ~2.3x those floors is what this design can approach.
//
// mlp_general_forward_f32: a fixed grid of kForwardBlocks walks the tiles (the plan's
// rows: 64, 32 or 16, as the widest width leaves room); a block stages a tile's
// observations (through the unit ids where given), runs the actor's layers, stages
// the tile again and runs the critic's (a third tile would not fit at width 1024),
// each layer's weight streamed through shared memory in chunks. A row's outputs are
// stream_product's and narrow_layer's per-element sums: row-invariant, and bitwise
// what the general policy kernels give the row.
//
// mlp_general_backward_f32: a fixed grid of (kBackwardBlocks, 2), a tower a block,
// each block its tiles t = blockIdx.x + k gridDim.x in order: the forward again with
// every layer's activations kept (shared memory where they fit, else the block's
// device scratch), g through the narrow layer, then a layer at a time down: the
// weight gradient x^T g and the bias sums added on the block's partial row in
// device memory (each element its rows in order), and g W^T (1 - x^2) for the layer
// below through the streamed product, the weight's chunks read transposed. One
// partial row a block, [blocks, params] in model.parameters() order; then
// general_grad_reduce_f32, mlp_towers.cu's reduce with the norm's last step in
// float64 (below), sums them and forms the global norm.
// Every sum's order is a function of the shape and n: equal inputs give equal bits,
// eager and in a CUDA graph; no float atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_stream.cuh"

namespace {

using namespace mlp_stream;

constexpr int kForwardBlocks = 264;   // the forward's grid
constexpr int kBackwardBlocks = 128;  // the backward's blocks a tower: partial rows
constexpr int kGroups = 8;            // the reduce's groups of consecutive rows
constexpr int kReduceLanes = 32;      // parameters a reduce block

// Both towers: the shape, and each tower's weights and biases a layer (the actor's
// 2 outputs, the critic's 1; the critic null where absent).
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

__global__ void __launch_bounds__(kMaxThreads) general_forward_kernel(Net net, Rows a, Plan p,
                                                                   float* __restrict__ mu,
                                                                   float* __restrict__ v) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    float* a0 = s;
    float* a1 = a0 + p.rows * p.stride;
    float* chunk = a1 + p.rows * p.stride;
    float* y = chunk + kStages * p.chunk;
    const long long tiles = (a.n + p.rows - 1) / p.rows;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long row0 = tile * p.rows;
        // the actor (2 outputs, mu), then the critic (1, v)
        for (int tw = 0; tw < 2; ++tw) {
            stage_rows(a0, p.stride, p.rows, a.d, [&](int r) { return row_at(a, row0 + r); });
            __syncthreads();
            tower_forward(p, net.s, net.w[tw], net.b[tw], 2 - tw, a0, a1, chunk, y, 2 * tw);
        }
        for (int r = threadIdx.x; r < p.rows; r += blockDim.x) {
            const long long row = row0 + r;
            if (row < a.n) {
                mu[2 * row] = y[3 * r];
                mu[2 * row + 1] = y[3 * r + 1];
                v[row] = y[3 * r + 2];
            }
        }
        __syncthreads();
    }
}

// One tower's backward over the block's tiles into its partial row `part` (the
// tower's parameters in order), g_out [n, outputs] the upstream gradient.
__device__ void tower_backward(const Net& net, int tower, const Rows& a, const Plan& p,
                               const float* g_out, float* part, float* acts, float* chunk,
                               float* y) {
    const Shape& S = net.s;
    const int L = S.hidden, O = tower == 0 ? 2 : 1;
    const float* const* w = net.w[tower];
    const float* const* b = net.b[tower];
    const long long tile_floats = (long long)p.rows * p.stride;
    // act[l] (l <= L): x and the hidden layers' activations; then two gradient tiles
    float* act[kMaxLayers];
    for (int l = 0; l <= L; ++l) act[l] = acts + l * tile_floats;
    float* grads[2] = {acts + (L + 1) * tile_floats, acts + (L + 2) * tile_floats};
    // each tensor's place in the partial row
    long long w_at[kMaxLayers], b_at[kMaxLayers], at = 0;
    for (int l = 0; l <= L; ++l) {
        const int out = l < L ? S.dims[l + 1] : O;
        w_at[l] = at;
        at += (long long)S.dims[l] * out;
        b_at[l] = at;
        at += out;
    }
    for (long long e = threadIdx.x; e < at; e += blockDim.x) part[e] = 0.0f;
    __syncthreads();
    const long long tiles = (a.n + p.rows - 1) / p.rows;
    const int K = S.dims[L], kp = round_up(K, 8);
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long row0 = tile * p.rows;
        stage_rows(act[0], p.stride, p.rows, a.d, [&](int r) { return row_at(a, row0 + r); });
        __syncthreads();
        // the forward again, every layer's activations kept
        for (int l = 0; l < L; ++l)
            stream_product<false>(p, act[l], act[l + 1], nullptr, w[l], b[l], S.dims[l],
                                  S.dims[l + 1], chunk);
        narrow_layer(p, act[L], K, O, w[L], b[L], O == 2, y, 0);
        __syncthreads();
        // g3 = d out (1 - out^2) through the actor's tanh (autograd's tanh_backward), d v
        // as it is for the critic; rows past n zero
        for (int e = threadIdx.x; e < p.rows * O; e += blockDim.x) {
            const int r = e / O, o = e - r * O;
            const long long row = row0 + r;
            const float g = row < a.n ? g_out[row * O + o] : 0.0f;
            const float out = y[3 * r + o];
            y[3 * r + o] = O == 2 ? g * (1.0f - out * out) : g;
        }
        __syncthreads();
        // the last layer's weight and bias gradients: each element the tile's rows in
        // order in float64 (the products of two floats exact), then one float32 add
        for (int e = threadIdx.x; e < K * O; e += blockDim.x) {
            const int k = e / O, o = e - k * O;
            double s = 0.0;
            for (int r = 0; r < p.rows; ++r)
                s += (double)act[L][r * p.stride + k] * (double)y[3 * r + o];
            part[w_at[L] + e] += (float)s;
        }
        for (int o = threadIdx.x; o < O; o += blockDim.x) {
            double s = 0.0;
            for (int r = 0; r < p.rows; ++r) s += (double)y[3 * r + o];
            part[b_at[L] + o] += (float)s;
        }
        // g = (g3 W^T) (1 - h^2) into the first gradient tile, zero past K
        float* cur = grads[0];
        float* other = grads[1];
        for (int e = threadIdx.x; e < p.rows * kp; e += blockDim.x) {
            const int r = e / kp, k = e - r * kp;
            float value = 0.0f;
            if (k < K) {
                float d = y[3 * r] * w[L][k * O];
                if (O == 2) d = __fmaf_rn(y[3 * r + 1], w[L][k * O + 1], d);
                const float h = act[L][r * p.stride + k];
                value = d * (1.0f - h * h);
            }
            cur[r * p.stride + k] = value;
        }
        __syncthreads();
        // a hidden layer at a time, from the top
        for (int l = L - 1; l >= 0; --l) {
            weight_grad(p, act[l], cur, S.dims[l], S.dims[l + 1], part + w_at[l]);
            bias_grad(p, cur, S.dims[l + 1], part + b_at[l]);
            if (l > 0) {
                stream_product<true>(p, cur, other, act[l], w[l], nullptr, S.dims[l + 1],
                                     S.dims[l], chunk);
                float* next = other;
                other = cur;
                cur = next;
            }
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kMaxThreads) general_backward_kernel(
        Net net, Rows a, Plan p, const float* __restrict__ g_mu, const float* __restrict__ g_v,
        float* __restrict__ partial, float* __restrict__ scratch) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    float* chunk = s;
    float* y = chunk + kStages * p.chunk;
    float* acts = y + round_up(3 * p.rows, 4);
    const int tower = blockIdx.y;
    if (p.acts_global)
        acts = scratch + ((long long)blockIdx.x * 2 + tower) * p.scratch_floats;
    const long long actor = tower_params(net.s, 2);
    float* part = partial + blockIdx.x * (actor + tower_params(net.s, 1)) + (tower ? actor : 0);
    tower_backward(net, tower, a, p, tower ? g_v : g_mu, part, acts, chunk, y);
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

long long tiles_for(long long n, int rows) { return (n + rows - 1) / rows; }

long long backward_blocks(long long n, int rows) {
    return tiles_for(n, rows) < kBackwardBlocks ? tiles_for(n, rows) : kBackwardBlocks;
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

}  // namespace

// The plan of the kind (0 the forward, 1 policy_act, 2 pool_act, 3 the backward) at
// towers dims[0] -> dims[1] -> ... -> dims[num_dims - 1] into out[10]: the block's
// warps, the tile's rows, the activation tiles' row stride, the warps on a fragment, the n-tiles a warp, a
// pass's columns, a chunk's floats, 1 where the backward's activations are in its
// device scratch, the shared bytes, the scratch floats a block. Returns a
// cudaError_t (invalid where the route does not take the towers).
extern "C" int mlp_general_plan(int kind, const int* dims, int num_dims, long long* out) {
    Shape s;
    if (kind < kForward || kind > kBackward || !shape_of(dims, num_dims, &s))
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(kind, s);
    if (p.rows == 0) return (int)cudaErrorInvalidValue;
    const long long v[10] = {p.warps, p.rows, p.stride, p.groups, p.tiles, p.cols, p.chunk,
                             p.acts_global, p.shared_bytes, p.scratch_floats};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
}

// The rows of the backward's partials at n rows: a row a block of its fixed grid,
// fewer where there are fewer tiles; -1 where the towers are not taken.
extern "C" int mlp_general_partial_rows(long long n, const int* dims, int num_dims) {
    Shape s;
    if (!shape_of(dims, num_dims, &s)) return -1;
    const Plan p = make_plan(kBackward, s);
    return p.rows == 0 ? -1 : (int)backward_blocks(n, p.rows);
}

// The forward: ptrs the obs (float32 contiguous), the unit ids (int64, or null), both
// towers' 4 (L + 1) tensors in model.parameters() order, then mu [n, 2] and v [n]
// out; block and units the observations' [units, block] with ids; dims the towers'
// (obs_dim, hidden widths). Returns a cudaError_t.
extern "C" int mlp_general_forward_f32(const void* const* ptrs, int num_ptrs, long long n,
                                       long long block, long long units, const int* dims,
                                       int num_dims, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Net net;
    Rows a;
    if (!net_args(ptrs, num_ptrs, 2, n, block, units, dims, num_dims, &net, &a))
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(kForward, net.s);
    if (p.rows == 0 || tiles_for(n, p.rows) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    float* mu = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 2]));
    float* v = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 1]));
    err = allow_smem(general_forward_kernel, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = tiles_for(n, p.rows);
    general_forward_kernel<<<(unsigned)(tiles < kForwardBlocks ? tiles : kForwardBlocks),
                             32 * p.warps, p.shared_bytes, (cudaStream_t)stream>>>(net, a, p, mu,
                                                                                   v);
    return (int)cudaGetLastError();
}

// The backward: ptrs as the forward's inputs, then d mu [n, 2] and d v [n]
// (contiguous), the partials [mlp_general_partial_rows(n), params] out, and the
// scratch (the plan's scratch floats x partial rows x 2; null where the plan keeps the
// activations in shared memory). partial_rows and partial_cols are the partials'
// allocated shape and scratch_floats the scratch's allocated floats: invalid unless
// the shape is the plan's exactly (the reduce sums every row) and the scratch holds
// what the plan writes. Returns a cudaError_t.
extern "C" int mlp_general_backward_f32(const void* const* ptrs, int num_ptrs, long long n,
                                        long long block, long long units, const int* dims,
                                        int num_dims, long long partial_rows,
                                        long long partial_cols, long long scratch_floats,
                                        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Net net;
    Rows a;
    if (!net_args(ptrs, num_ptrs, 4, n, block, units, dims, num_dims, &net, &a))
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(kBackward, net.s);
    if (p.rows == 0 || tiles_for(n, p.rows) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const float* g_mu = static_cast<const float*>(ptrs[num_ptrs - 4]);
    const float* g_v = static_cast<const float*>(ptrs[num_ptrs - 3]);
    float* partial = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 2]));
    float* scratch = static_cast<float*>(const_cast<void*>(ptrs[num_ptrs - 1]));
    const long long blocks = backward_blocks(n, p.rows);
    if (g_mu == nullptr || g_v == nullptr || partial == nullptr || partial_rows != blocks
            || partial_cols != tower_params(net.s, 2) + tower_params(net.s, 1)
            || (p.acts_global && (scratch == nullptr
                                  || scratch_floats < blocks * 2 * p.scratch_floats)))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    err = allow_smem(general_backward_kernel, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    general_backward_kernel<<<dim3((unsigned)blocks, 2), 32 * p.warps,
                              p.shared_bytes, (cudaStream_t)stream>>>(net, a, p, g_mu, g_v,
                                                                      partial, scratch);
    return (int)cudaGetLastError();
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
