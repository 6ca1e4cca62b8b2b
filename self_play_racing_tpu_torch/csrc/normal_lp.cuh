// The Normal log-prob of a two-dimensional action, for NVIDIA Hopper (sm_90a): shared
// by the PPO loss head (ppo_head.cu) and the rollout's policy kernels (policy.cu), so
// that the rollout's log-prob and the one the minibatch recomputes from the same mu
// come out of the same operations, bit for bit.
//
// The PyTorch composition it is bitwise (models/actor_critic.py:normal_log_prob, the
// JAX package's self_play_racing_tpu/models/actor_critic.py:86) on the card, with no
// FMA contraction (-fmad=false):
//   var = exp(2.0 * log_std); lp = -((action - mu) ** 2) / (2.0 * var) - log_std - c
//   lp.sum(-1)
// expf as PyTorch's exp kernel calls it, pow(d, 2) as d * d, an IEEE divide, c =
// 0.5 * log(2 pi) rounded to float32 as PyTorch rounds the Python scalar, and the sum
// over the two dims as its reduction forms it ((a + b) + 0: -0 sums to +0).
#pragma once

#include <cuda_runtime.h>

namespace normal_lp {

// 2.0 * exp(2.0 * log_std): a dimension's denominator, once a launch or a row
__device__ __forceinline__ float denominator(float log_std) {
    return 2.0f * expf(2.0f * log_std);
}

// a dimension's term ((-(d * d) / den - log_std) - c), d = action - mu
__device__ __forceinline__ float term(float d, float den, float log_std, float c) {
    const float q = __fdiv_rn(-__fmul_rn(d, d), den);
    return __fsub_rn(__fsub_rn(q, log_std), c);
}

// the sum over the two dimensions
__device__ __forceinline__ float sum2(float a, float b) {
    return __fadd_rn(__fadd_rn(a, b), 0.0f);
}

}  // namespace normal_lp
