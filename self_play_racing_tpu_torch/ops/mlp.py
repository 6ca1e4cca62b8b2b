"""The PPO minibatch step's actor and critic MLPs, forward and backward, as
hand-written kernels (``csrc/mlp_towers.cu``).

The JAX package runs ``_mlp`` (``self_play_racing_tpu/models/actor_critic.py:68``)
for the actor's mean and the critic's value inside ``_ppo_loss``, and its gradient
under ``jax.value_and_grad`` (``self_play_racing_tpu/agent/ppo.py:313``), as part of
the minibatch step's one XLA program on the TPU. In PyTorch ``_mlp`` is a cuBLAS GEMM,
a bias add and a tanh a layer, and autograd's backward of each.

- ``actor_critic_mlp`` dispatches on the parameters' layout and the device of
  ``obs``: a tensor-parallel rank's ``ShardedParams`` (``params.tp`` set) and a CPU
  tensor take ``actor_critic_mlp_plain`` (the rows gathered through the unit ids,
  then ``net.actor_mu`` and ``net.critic_value``, autograd for the gradient; on a
  rank, the Megatron composition of ``models/actor_critic.py``, since the kernels
  take whole towers), a CUDA tensor of whole towers ``MLPTowers``, a ``torch.autograd.Function`` whose forward is one launch of
  ``mlp_forward_f32`` (both towers) and whose backward is two, ``mlp_backward_f32``
  (each block of a fixed grid its 64-row tiles' weight and bias gradients, the tiles'
  forward recomputed, one partial row a block) and ``mlp_grad_reduce_f32`` (the rows
  summed in a fixed order into one flat buffer whose views the gradients are).
  Their products run on the tensor cores in error-compensated 3xTF32 (float32
  accurate). The kernels read the observations through the minibatch's unit ids in
  place. They sum in another order than cuBLAS, so they are held to the plain
  composition within a stated tolerance (chip_smoke.py phase p), not bitwise; equal
  inputs give equal bits, eager and in a CUDA graph, and the forward is
  row-invariant.
- The kernels take whole towers obs_dim -> hidden -> {2, 1} by one of two routes
  (``_cuda.mlp_route``). The compiled route (``csrc/mlp_towers.cu``, above): three
  layers with (h1, h2) in ``_cuda.MLP_HIDDEN`` and an obs_dim that fits a block's
  shared memory (``_cuda.mlp_takes``) and the policy kernels'. The general route
  (``csrc/mlp_general.cu``): every other tower of 1 to
  ``_cuda.MLP_MAX_HIDDEN_LAYERS`` hidden layers, widths and obs_dim 1 to
  ``_cuda.MLP_MAX_WIDTH``; layer-major, each layer one launch over the whole card
  (128 x 128 tiles of 3xTF32 products), the activations in device scratch between
  launches (``_cuda.general_scratch``); the backward (every hidden layer's
  activations as the forward kept them where they fit a slab, else computed again,
  then launches a layer from the top: the weight and bias
  gradients of a chunk of rows into that chunk's partial row, and g W^T (1 - h^2)
  for the layer below) writes partial rows, which its own reduce sums (the compiled
  reduce's blocks and order; the norm's last step in float64). The general forward
  and backward are each one call of their entry, which launches the split weights'
  kernel and a kernel a layer. A CUDA tensor neither
  takes (not float32, not contiguous, another shape, past the limits) raises; there
  is no fallback to the plain version.
- The global norm of the gradients (``optax.clip_by_global_norm``'s, which XLA
  fuses into the update program on the TPU) comes out of the same reduce launch:
  given ``norm`` (a 0-d float32 on the card), the backward's ``mlp_grad_reduce``
  writes sqrt(sum of squares) of the flat gradient into it (each block of 32
  parameters its squares over its lanes, the last block the blocks' in index order;
  ``csrc/mlp_towers.cu``). ``grad_norm`` is the same kernel's norm-only mode over a
  flat gradient already summed (a group's all-reduced one), in the same blocks and
  order: over equal flats the two give equal bits. Their plain version is
  ``grad_norm_plain`` (``agent/ppo.py:global_norm``'s composition), held to within
  chip_smoke.py phase p's tolerance.
- ``mlp_forward_launches``, ``mlp_backward_launches``, ``mlp_grad_reduce_launches``
  and ``mlp_grad_norm_launches`` (the norm-only mode) count the compiled route's
  kernel launches, ``mlp_general_forward_launches``, ``mlp_general_backward_launches``,
  ``mlp_general_grad_reduce_launches`` and ``mlp_general_grad_norm_launches`` the
  general route's (``csrc/mlp_general.cu``'s reduce: the compiled one's blocks and
  order, the norm's last step in float64) (plain integers, incremented only where a
  kernel launched).
"""
from __future__ import annotations

import torch

from . import _cuda
from .geometry import _on_cuda
from .minibatch import _check_cuda, gather_units
from ..models import actor_critic as net

mlp_forward_launches = 0
mlp_backward_launches = 0
mlp_grad_reduce_launches = 0
mlp_grad_norm_launches = 0
mlp_general_forward_launches = 0
mlp_general_backward_launches = 0
mlp_general_grad_reduce_launches = 0
mlp_general_grad_norm_launches = 0


def actor_critic_mlp(params, obs, unit_ids=None, norm=None):
    """(mu [n, 2], v [n]): the actor's tanh-bounded mean and the critic's value of the
    parameter dict ``params`` (whole towers, ``{"actor": [(w, b)] * (L + 1), "critic": ...}``,
    weights (in, out)) on ``obs`` [n, obs_dim]; with ``unit_ids`` (int64 [n / block],
    the minibatch's shuffle units) ``obs`` is the rollout's units [units, block,
    obs_dim] and row r is unit ``unit_ids[r // block]``, offset ``r % block``: the
    kernels read it there, the plain version gathers it first. Differentiable in the
    parameters (not in ``obs``). A tensor-parallel rank's sharded parameters take the
    plain version on any device. ``norm`` (kernels only: a 0-d float32 on the card)
    receives the global norm of the gradients when the backward runs."""
    if getattr(params, "tp", None) is not None or not _on_cuda(obs, "actor_critic_mlp"):
        if norm is not None:
            raise ValueError("actor_critic_mlp: the norm comes out of the kernels' backward; "
                             "the plain version has none (take ppo.global_norm)")
        return actor_critic_mlp_plain(params, obs, unit_ids)
    leaves = [t for tower in ("actor", "critic") for layer in params[tower] for t in layer]
    dims = _check_towers(obs, unit_ids, leaves)
    return MLPTowers.apply(obs, unit_ids, dims, norm, *leaves)


def actor_critic_mlp_plain(params, obs, unit_ids=None):
    """Plain PyTorch ``actor_critic_mlp``: with ``unit_ids`` the rows gathered
    (``gather_units``), then ``net.actor_mu`` and ``net.critic_value``."""
    if unit_ids is not None:
        obs = gather_units(obs, unit_ids)
    return net.actor_mu(params, obs), net.critic_value(params, obs)


def tower_shapes(leaves, outputs: int, stacked: int = 0):
    """(obs_dim, *hidden) of one tower's 2 (L + 1) tensors with ``outputs`` outputs
    (weights (in, out), each with a leading axis of ``stacked`` P > 0 where given), or
    None where they are not such a tower."""
    shapes = [tuple(t.shape) for t in leaves]
    lead = (stacked,) if stacked else ()
    if len(shapes) < 4 or len(shapes) % 2 or len(shapes[0]) != 2 + bool(stacked):
        return None
    dims = [shapes[0][-2]] + [s[-1] for s in shapes[0::2]]
    want = []
    for i in range(len(dims) - 1):
        want += [lead + (dims[i], dims[i + 1]), lead + (dims[i + 1],)]
    if shapes != want or dims[-1] != outputs:
        return None
    return tuple(dims[:-1])


def _check_towers(obs, unit_ids, leaves) -> tuple:
    """The (obs_dim, *hidden) of whole towers the kernels take (``_cuda.mlp_route``'s
    compiled or general route), or a raise."""
    dev = obs.device
    _check_cuda("actor_critic_mlp", dev, [obs] + leaves)
    half = len(leaves) // 2
    dims = tower_shapes(leaves[:half], 2)
    if dims is None or tower_shapes(leaves[half:], 1) != dims:
        raise ValueError(f"actor_critic_mlp: the kernels take whole towers, an actor of 2 "
                         f"and a critic of 1 outputs, each obs_dim -> hidden -> outputs with "
                         f"the same hidden widths; got tensors "
                         f"{[tuple(t.shape) for t in leaves]}")
    _cuda.mlp_route(dims[0], dims[1:])  # raises past the general route's limits
    d = dims[0]
    if unit_ids is None:
        if obs.ndim != 2 or obs.shape[1] != d:
            raise ValueError(f"actor_critic_mlp: obs {tuple(obs.shape)}, expected [n, {d}]")
    else:
        _check_cuda("actor_critic_mlp", dev, (unit_ids,), torch.int64)
        if obs.ndim != 3 or obs.shape[2] != d or unit_ids.ndim != 1:
            raise ValueError(f"actor_critic_mlp: obs {tuple(obs.shape)} and unit ids "
                             f"{tuple(unit_ids.shape)}, expected [units, block, {d}] and [ids]")
    return dims


def _rows(obs, unit_ids) -> int:
    return obs.shape[0] if unit_ids is None else unit_ids.shape[0] * obs.shape[1]


def _check_norm(norm, obs) -> None:
    """``norm``: None, or a 0-d float32 tensor on ``obs``'s device."""
    if norm is None:
        return
    if norm.device != obs.device or norm.dtype != torch.float32 or norm.ndim != 0:
        raise ValueError(f"MLPTowers: the norm is a 0-d float32 on {obs.device}; got "
                         f"{tuple(norm.shape)} {norm.dtype} on {norm.device}")


class MLPTowers(torch.autograd.Function):
    """``actor_critic_mlp`` on the card: the forward one launch of
    ``csrc/mlp_towers.cu:mlp_forward_f32`` (the compiled route) or one call of
    ``csrc/mlp_general.cu:mlp_general_forward_f32`` (the general route,
    ``_cuda.mlp_route``), the backward one of that route's backward and one of
    ``mlp_grad_reduce_f32``, which return the gradients of the 4 (L + 1) parameter
    tensors as views of one flat buffer (none for the observations); with ``norm``
    the reduce is ``mlp_grad_reduce_norm_f32`` and also writes the flat gradient's
    global norm into it."""

    @staticmethod
    def forward(ctx, obs, unit_ids, dims, norm, *leaves):
        global mlp_forward_launches, mlp_general_forward_launches
        _check_norm(norm, obs)
        n = _rows(obs, unit_ids)
        general = _cuda.mlp_route(dims[0], dims[1:]) == "general"
        mu = torch.empty((n, 2), dtype=obs.dtype, device=obs.device)
        v = torch.empty((n,), dtype=obs.dtype, device=obs.device)
        # the general forward keeps its activations for the backward where they fit
        keep = general and n > 0 and any(ctx.needs_input_grad[4:]) \
            and _cuda.general_keeps(n, dims)
        ctx.scratch = _cuda.general_scratch(n, dims, obs.device) if keep else None
        if n:
            with torch.cuda.device(obs.device):
                if general:
                    _cuda.launch_mlp_general_forward(obs, unit_ids, leaves, mu, v, n, dims,
                                                     ctx.scratch, keep)
                    mlp_general_forward_launches += 1
                else:
                    _cuda.launch_mlp_forward(obs, unit_ids, leaves, mu, v, n, dims)
                    mlp_forward_launches += 1
        ctx.save_for_backward(obs, unit_ids, *leaves)
        ctx.dims, ctx.norm, ctx.general = dims, norm, general
        return mu, v

    @staticmethod
    def backward(ctx, g_mu, g_v):
        global mlp_backward_launches, mlp_general_backward_launches, mlp_grad_reduce_launches
        global mlp_general_grad_reduce_launches
        obs, unit_ids, *leaves = ctx.saved_tensors
        n = _rows(obs, unit_ids)
        if n == 0:
            if ctx.norm is not None:
                ctx.norm.zero_()
            return (None,) * 4 + tuple(torch.zeros_like(t) for t in leaves)
        total = sum(t.numel() for t in leaves)
        rows = (_cuda.general_partial_rows(n, ctx.dims) if ctx.general
                else _cuda.mlp_partial_rows(n))
        partial = torch.empty((rows, total), dtype=obs.dtype, device=obs.device)
        flat = torch.empty((total,), dtype=obs.dtype, device=obs.device)
        g_mu, g_v = g_mu.contiguous(), g_v.contiguous()
        _check_cuda("actor_critic_mlp backward", obs.device, (g_mu, g_v))
        with torch.cuda.device(obs.device):
            if ctx.general:
                _cuda.launch_mlp_general_backward(obs, unit_ids, leaves, g_mu, g_v, partial, n,
                                                  ctx.dims, ctx.scratch, ctx.scratch is not None)
                mlp_general_backward_launches += 1
                _cuda.launch_general_grad_reduce(partial, flat, ctx.norm)
                mlp_general_grad_reduce_launches += 1
            else:
                _cuda.launch_mlp_backward(obs, unit_ids, leaves, g_mu, g_v, partial, n,
                                          ctx.dims)
                mlp_backward_launches += 1
                _cuda.launch_mlp_grad_reduce(partial, flat, ctx.norm)
                mlp_grad_reduce_launches += 1
        grads, at = [], 0
        for t in leaves:
            grads.append(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
        return (None,) * 4 + tuple(grads)


def grad_norm(flat, params=None):
    """The global norm (0-d) of the flat gradient ``flat`` [params], float32: on the
    card one launch of the norm-only mode of the reduce of the route that the towers
    take (``_cuda.mlp_route`` of ``params``, the 4 (L + 1) tensors in
    ``model.parameters()`` order whose gradient ``flat`` is; None: the compiled
    route's), bitwise the norm that that route's fused reduce gives of an equal flat;
    on the CPU ``grad_norm_plain``."""
    global mlp_grad_norm_launches, mlp_general_grad_norm_launches
    if not _on_cuda(flat, "grad_norm"):
        return grad_norm_plain(flat)
    _check_cuda("grad_norm", flat.device, (flat,))
    if flat.ndim != 1 or flat.numel() == 0:
        raise ValueError(f"grad_norm: a flat gradient [params], got {tuple(flat.shape)}")
    general = False
    if params is not None:
        params = list(params)
        dims = tower_shapes(params[:len(params) // 2], 2)
        if dims is None or sum(t.numel() for t in params) != flat.numel():
            raise ValueError(f"grad_norm: params are not whole towers of {flat.numel()} "
                             f"parameters: {[tuple(t.shape) for t in params]}")
        general = _cuda.mlp_route(dims[0], dims[1:]) == "general"
    norm = torch.empty((), dtype=flat.dtype, device=flat.device)
    with torch.cuda.device(flat.device):
        if general:
            _cuda.launch_general_grad_reduce(flat.view(1, -1), None, norm)
            mlp_general_grad_norm_launches += 1
        else:
            _cuda.launch_mlp_grad_norm(flat, norm)
            mlp_grad_norm_launches += 1
    return norm


def grad_norm_plain(flat):
    """Plain PyTorch ``grad_norm``: ``agent/ppo.py:global_norm``'s composition on one
    tensor, sqrt(sum(flat * flat))."""
    return torch.stack([torch.sum(flat * flat)]).sum().sqrt()
