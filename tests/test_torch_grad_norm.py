"""The minibatch step's global norm as the MLP backward's reduce gives it
(``csrc/mlp_towers.cu``: ``mlp_grad_reduce_norm_f32``), on the CPU.

On the card the norm of the 12 gradients comes out of the reduce launch that sums the
backward's blocks (``ppo.norm_route``: "fused"), or out of the same kernel's
norm-only mode over a group's all-reduced flat ("norm-only"); the CPU and a
tensor-parallel rank keep ``ppo.global_norm`` ("composition"). The card's side is
held in chip_smoke.py phase p and ``tests/test_torch_cuda_kernels.py``. Here:

- a numpy transcription of the kernel's order (``reduce_order``: the blocks' rows in
  8 groups of consecutive rows, each summed in order, then the groups in order;
  ``norm_order``: each block of 32 parameters' squares over its lanes by the
  shuffle tree, then the blocks' squares one after another in block-index order,
  then the square root), in float32 at towers (15, 16, 16) and (19, 64, 64) and a
  few hundred rows from a seed, on the blocks' partial rows of
  ``test_torch_mlp_kernels.kernel_order``: the flat bitwise ``kernel_order``'s
  gradients, the norm within phase p's rule (max(1e-5 x the float64 norm of the
  same flat, 8 x ``ppo.global_norm``'s own distance from it)) and within the same
  rule of ``optax.global_norm`` of the JAX gradients; the norm-only mode over that
  flat bitwise the fused norm;
- the route: ``minibatch_step`` calls ``global_norm`` once a minibatch step on the
  CPU and on a tensor-parallel layout, and ``norm_route`` sends a card without a
  group to the fused norm and one with a group to the norm-only mode;
- ``MLPTowers`` refuses a norm on another device, of another dtype or not 0-d
  before any launch, and the plain route refuses a norm at all.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from test_torch_dist_workers import group_of_one
from test_torch_mlp_kernels import _jax_mlp, kernel_order
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.models import actor_critic as net
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import mlp as mlpops
from self_play_racing_tpu_torch.parallel import mesh as pmesh

# (obs_dim, hidden, rows): narrow towers and train scale's width at a few hundred rows
CASES = [(15, (16, 16), 300), (19, (64, 64), 257), (19, (64, 64), 640)]
GROUPS = 8  # the reduce's groups of consecutive rows (csrc/mlp_towers.cu: kGroups)


def reduce_order(partial: np.ndarray) -> np.ndarray:
    """The sum over the rows of ``partial`` [rows, params] (float32) as the kernel
    takes it: group g of 8 sums its consecutive rows in order from zero, then the
    group sums in order."""
    rows = partial.shape[0]
    per = -(-rows // GROUPS)
    sums = []
    for g in range(GROUPS):
        s = np.zeros(partial.shape[1], np.float32)
        for t in range(g * per, min(g * per + per, rows)):
            s = s + partial[t]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def norm_order(flat: np.ndarray) -> np.float32:
    """The norm of ``flat`` (float32) as the kernel takes it: blocks of
    ``_cuda.MLP_REDUCE_LANES`` parameters (the last padded with zeros), each lane's
    square, the lanes by the shuffle tree (lane l takes l + 16, then l + 8, 4, 2, 1),
    the blocks' squares one after another in block-index order, then sqrt."""
    lanes = _cuda.MLP_REDUCE_LANES
    blocks = _cuda.mlp_grad_norm_blocks(flat.size)
    sq = np.zeros(blocks * lanes, np.float32)
    sq[:flat.size] = flat * flat
    sq = sq.reshape(blocks, lanes)
    o = lanes // 2
    while o:
        sq[:, :o] = sq[:, :o] + sq[:, o:2 * o]
        o //= 2
    total = np.float32(0.0)
    for b in sq[:, 0]:
        total = np.float32(total + b)
    return np.sqrt(total)


def _within_rule(norm: float, ref: float, composition: float) -> bool:
    """Phase p's rule for the norm: within max(1e-5 x ``ref``, 8 x the composition's
    distance from ``ref``)."""
    bound = max(chip_smoke.MLP_REL_FLOOR * ref,
                chip_smoke.MLP_CONTROL_FACTOR * abs(composition - ref))
    return abs(norm - ref) <= bound


@pytest.mark.parametrize("obs_dim,hidden,rows", CASES)
def test_transcription_gives_kernel_orders_flat_and_a_norm_within_tolerance(obs_dim, hidden,
                                                                             rows):
    case = chip_smoke.mlp_case(obs_dim, hidden, rows, seed=7 * rows + obs_dim)
    params, _, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    partials = []
    with torch.no_grad():
        grads = kernel_order(params, obs, g_mu, g_v, partials=partials)[2:]
    partial = torch.cat(partials, dim=1).numpy()
    assert partial.shape == (_cuda.mlp_partial_rows(rows), sum(g.numel() for g in grads))
    flat = reduce_order(partial)
    want = torch.cat([g.reshape(-1) for g in grads]).numpy()
    assert flat.tobytes() == want.tobytes()

    norm = float(norm_order(flat))
    # the kernel's rule: the float64 norm of the same flat, global_norm's distance
    n64 = float(np.sqrt(np.sum(flat.astype(np.float64) ** 2)))
    views = [torch.from_numpy(x.copy()) for x in np.split(flat, np.cumsum(
        [g.numel() for g in grads])[:-1])]
    assert _within_rule(norm, n64, float(tppo.global_norm(views)))
    # JAX's gradients of the same towers, their optax.global_norm in float64 and the
    # composition's float32 norm of its float32 ones
    j64 = _jax_mlp(*_jax_args(chip_smoke.mlp_case(obs_dim, hidden, rows, 7 * rows + obs_dim,
                                                  dtype=np.float64)))[2:]
    j32 = _jax_mlp(*_jax_args(case))[2:]
    ref = float(optax.global_norm(j64))
    composition = float(tppo.global_norm([torch.from_numpy(np.asarray(g)) for g in j32]))
    assert _within_rule(norm, ref, composition)
    # the norm-only mode over the flat: one row, the same blocks and order
    assert norm_order(reduce_order(flat[None])).tobytes() == norm_order(flat).tobytes()


def _jax_args(case):
    p = {t: [tuple(jnp.asarray(a) for a in layer) for layer in layers]
         for t, layers in case["params"].items()}
    return (p,) + tuple(jnp.asarray(case[k]) for k in ("obs", "g_mu", "g_v"))


def test_transcription_of_the_norm_is_the_lane_tree_then_the_blocks():
    """``norm_order`` on 33 parameters (two blocks) whose squares are 1.0 in lane 0
    of each block and 2^-24 in the first block's other 31 lanes: the tree adds lane 16's
    2^-24 to lane 0's 1.0 first, which rounds it away (a tie to even), and then 2^-23,
    2^-22, 2^-21 and 2^-20 (lanes 8, 4, 2, 1, each the sum of its subtree) exactly:
    1 + 15 x 2^-23, then the second block's 1.0 after it."""
    flat = np.full(33, 2.0 ** -12, np.float32)
    flat[0] = flat[32] = 1.0
    first = np.float32(1.0 + 15 * 2.0 ** -23)
    assert norm_order(flat) == np.sqrt(np.float32(first + np.float32(1.0)))
    assert _cuda.mlp_grad_norm_blocks(33) == 2 and _cuda.mlp_grad_norm_blocks(32) == 1


def test_grad_norm_on_the_cpu_is_the_composition():
    """``mlpops.grad_norm`` on a CPU tensor is its plain version, bitwise
    ``ppo.global_norm`` of one tensor, and launches nothing."""
    flat = torch.from_numpy(np.random.default_rng(3).normal(size=1000).astype(np.float32))
    before = mlpops.mlp_grad_norm_launches
    got = mlpops.grad_norm(flat)
    assert chip_smoke.same_bits(got, tppo.global_norm([flat]))
    assert chip_smoke.same_bits(got, mlpops.grad_norm_plain(flat))
    assert mlpops.mlp_grad_norm_launches == before


def test_norm_route():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    tp = net.TensorParallel({}, None, 2, 0)
    mesh = types.SimpleNamespace(world=2)
    assert tppo.norm_route(cuda, None, None) == "fused"
    assert tppo.norm_route(cuda, mesh, None) == "norm-only"
    assert tppo.norm_route(cuda, mesh, tp) == "composition"
    assert tppo.norm_route(cuda, None, tp) == "composition"
    assert tppo.norm_route(cpu, None, None) == "composition"
    assert tppo.norm_route(cpu, mesh, None) == "composition"


def _counted_global_norm(monkeypatch):
    calls = []
    composition = tppo.global_norm

    def counted(grads, tp=None):
        calls.append(tp)
        return composition(grads, tp)

    monkeypatch.setattr(tppo, "global_norm", counted)
    return calls


def _steps(cfg, model, inputs, opt_state, steps):
    mu = [m.clone() for m in opt_state.mu]
    nu = [v.clone() for v in opt_state.nu]
    loop = tppo.MinibatchLoop.zeros(inputs[3].shape[0], torch.device("cpu"))
    for _ in range(steps):
        tppo.minibatch_step(cfg, model, *inputs, mu, nu, loop)
    return loop


def test_minibatch_step_on_the_cpu_calls_global_norm_once(monkeypatch):
    cfg = base_config(num_envs=16, num_steps=16, num_minibatches=4, update_epochs=1)
    train, inputs = chip_smoke.minibatch_inputs(cfg, torch.device("cpu"))
    calls = _counted_global_norm(monkeypatch)
    loop = _steps(cfg, train.model, inputs, train.opt_state, 4)
    assert calls == [None] * 4 and int(loop.i) == 4


def test_minibatch_step_on_a_tensor_parallel_layout_calls_global_norm_once(monkeypatch):
    """A model holding a tensor-parallel layout (a group of one, towers split as
    ``param_shardings`` splits them over two ranks) takes the composition with its
    layout, once a minibatch step."""
    cfg = base_config(num_envs=16, num_steps=16, num_minibatches=4, update_epochs=1)
    train, inputs = chip_smoke.minibatch_inputs(cfg, torch.device("cpu"))
    calls = _counted_global_norm(monkeypatch)
    with group_of_one():
        params = train.model.params()
        dims = pmesh.param_shardings(params, types.SimpleNamespace(shape={"model": 2}))
        tp = net.TensorParallel(dims, dist.group.WORLD, 1, 0)
        model = net.ActorCritic(params, train.model.log_std, tensor_parallel=tp)
        _steps(cfg, model, inputs, train.opt_state, 4)
    assert calls == [tp] * 4


def test_mlp_towers_refuse_a_norm_they_cannot_write():
    """``MLPTowers`` checks the norm before it launches anything: on another device
    than the observations, of another dtype or not 0-d, it raises; the plain route
    has no norm to give and raises too."""
    case = chip_smoke.mlp_case(19, (64, 64), 64, seed=1)
    params, leaves, obs, _, _ = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    before = chip_smoke.mlp_counts()
    for norm in (torch.empty((), device="meta"), torch.empty((), dtype=torch.float64),
                 torch.empty((1,))):
        with pytest.raises(ValueError, match="norm"):
            mlpops.MLPTowers.apply(obs, None, (19, 64, 64), norm, *leaves)
    with pytest.raises(ValueError, match="norm"):
        mlpops.actor_critic_mlp(params, obs, None, torch.empty(()))
    assert chip_smoke.mlp_counts() == before
