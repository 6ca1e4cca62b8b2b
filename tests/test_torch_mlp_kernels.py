"""The minibatch step's actor and critic MLPs (``ops/mlp.py``) against the JAX
package, and a transcription of the kernels' order against the plain version, on
the CPU.

On the card ``actor_critic_mlp`` is one launch forward and two backward
(``csrc/mlp_towers.cu``), held to the plain composition there within the stated
tolerance of chip_smoke.py phase p (``tests/test_torch_cuda_kernels.py``). Here:

- the plain route under autograd (mu, v and the 12 parameter gradients from given
  upstream gradients of mu and v) against jitted JAX ``actor_mu`` and
  ``critic_value`` (``_mlp``) under ``jax.value_and_grad``, params in JAX's layout on
  both sides, at obs 15 and 19 x towers (64, 64) and (128, 128) and 1, 127 and 4097
  rows. float64: within 1e-13 of each tensor's scale (tanh rounds apart in XLA's and
  PyTorch's CPU math in the last bit). float32: within 2e-5 of each tensor's scale
  (the products and the sums over up to 4097 rows run in other orders, and XLA's CPU
  jit contracts them into FMAs);
- the unit-id read (the rollout's units [units, block, obs_dim] through the
  minibatch's unit ids, repeats and all) bitwise the plain route on the gathered
  rows, gradients too;
- a PyTorch transcription of the kernels' order (each 128-row tile's forward, its
  weight and bias gradients from the backward kernel's formulas, then the tiles
  summed in 8 groups of consecutive tiles and the groups in order) within phase p's
  tolerance of the plain version (``chip_smoke.mlp_bounds``: max(1e-5 of the
  tensor's scale, 8 x the plain composition's own distance with the rows in two
  halves)): it catches a transposed weight, the actor's final tanh or the critic's
  missing one before the card does;
- what the kernels take and refuse, checked on CPU tensors (``_check_towers``: any
  obs_dim that fits a block's shared memory with hidden widths in
  ``_cuda.MLP_HIDDEN``; float64, non-contiguous, other widths refused) and the tile
  count.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from self_play_racing_tpu.models import actor_critic as jnet
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import minibatch as mbops
from self_play_racing_tpu_torch.ops import mlp as mlpops

SHAPES = [(15, (64, 64)), (19, (64, 64)), (15, (128, 128)), (19, (128, 128))]
ROWS = [1, 127, 4097]
# of each tensor's largest |value|
TOL = {np.float64: 1e-13, np.float32: 2e-5}


@functools.partial(jax.jit)
def _jax_mlp(params, obs, g_mu, g_v):
    def f(p):
        mu, v = jnet.actor_mu(p, obs), jnet.critic_value(p, obs)
        return jnp.sum(mu * g_mu) + jnp.sum(v * g_v), (mu, v)

    (_, (mu, v)), grads = jax.value_and_grad(f, has_aux=True)(params)
    return [mu, v] + [g for tower in ("actor", "critic") for layer in grads[tower]
                      for g in layer]


def _jax_case(case):
    params = {t: [tuple(jnp.asarray(a) for a in layer) for layer in layers]
              for t, layers in case["params"].items()}
    return [np.asarray(x) for x in _jax_mlp(params, *(jnp.asarray(case[k])
                                                      for k in ("obs", "g_mu", "g_v")))]


def _assert_scaled(got, want, tol, what=""):
    for name, g, w in zip(chip_smoke.MLP_OUTPUTS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        scale = max(np.abs(w).max(), np.finfo(np.float32).tiny)
        assert np.abs(g - w).max() <= tol * scale, (what, name, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("obs_dim,hidden", SHAPES)
def test_plain_route_matches_jax(obs_dim, hidden, rows, dtype):
    """``actor_critic_mlp`` on CPU tensors (the plain route) and its autograd
    against JAX's ``_mlp`` under ``value_and_grad``: mu, v and every gradient."""
    case = chip_smoke.mlp_case(obs_dim, hidden, rows, seed=rows + obs_dim, dtype=dtype)
    got = chip_smoke.mlp_run(mlpops.actor_critic_mlp,
                             *chip_smoke.mlp_tensors(case, torch.device("cpu")))
    assert got[0].dtype == torch.from_numpy(case["obs"]).dtype
    _assert_scaled([t.numpy() for t in got], _jax_case(case), TOL[dtype])


@pytest.mark.parametrize("block,ids", [(16, [9, 3, 60, 3, 17, 0, 41, 22]), (1, [5, 5, 0]),
                                       (7, [2])])
def test_unit_ids_read_the_gathered_rows(block, ids):
    """Through the unit ids (the rollout's units in place, repeats included) mu, v
    and the gradients are bitwise the plain route on the gathered rows."""
    n_units = 64
    case = chip_smoke.mlp_case(19, (64, 64), n_units * block, seed=block)
    params, leaves, obs, _, _ = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    units = obs.reshape(n_units, block, -1)
    unit_ids = torch.tensor(ids, dtype=torch.int64)
    n = len(ids) * block
    g = torch.Generator().manual_seed(block)
    g_mu, g_v = torch.randn((n, 2), generator=g), torch.randn((n,), generator=g)
    got = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, units, g_mu, g_v,
                             unit_ids)
    gathered = mbops.gather_units(units, unit_ids)
    want = chip_smoke.mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, gathered,
                              g_mu, g_v)
    assert torch.equal(gathered, obs.reshape(n_units, block, -1)[unit_ids].reshape(n, -1))
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got, want))


def kernel_order(params, obs, g_mu, g_v, tile=_cuda.MLP_ROWS_PER_TILE, groups=8):
    """The kernels' order in PyTorch (``csrc/mlp_towers.cu``): each tile of ``tile``
    rows through both towers, its weight and bias gradients from the backward
    kernel's formulas (g3 = d mu * (1 - mu^2) through the actor's tanh, d v for the
    critic; g2 = (g3 W3^T) * (1 - h2^2); g1 = (g2 W2^T) * (1 - h1^2); x^T g1, h1^T g2,
    h2^T g3 and the row sums), then the tiles' gradients summed in ``groups`` groups of
    consecutive tiles, each in tile order from zero, and the group sums in order.
    Returns [mu, v, the 12 gradients]."""
    n = obs.shape[0]
    tiles = -(-n // tile)
    parts, outs = [], {"actor": [], "critic": []}
    for t in range(tiles):
        x = obs[t * tile:(t + 1) * tile]
        part = []
        for tower, g_out, final_tanh in (("actor", g_mu, True), ("critic", g_v[:, None], False)):
            (w1, b1), (w2, b2), (w3, b3) = params[tower]
            h1 = torch.tanh(x @ w1 + b1)
            h2 = torch.tanh(h1 @ w2 + b2)
            z = h2 @ w3 + b3
            y = torch.tanh(z) if final_tanh else z
            g = g_out[t * tile:(t + 1) * tile]
            g3 = g * (1 - y * y) if final_tanh else g
            g2 = (g3 @ w3.T) * (1 - h2 * h2)
            g1 = (g2 @ w2.T) * (1 - h1 * h1)
            part += [x.T @ g1, g1.sum(0), h1.T @ g2, g2.sum(0), h2.T @ g3, g3.sum(0)]
            outs[tower].append(y)
        parts.append(part)
    per = -(-tiles // groups)
    grads = []
    for i in range(len(parts[0])):
        sums = []
        for k in range(groups):
            s = torch.zeros_like(parts[0][i])
            for part in parts[k * per:(k + 1) * per]:
                s = s + part[i]
            sums.append(s)
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        grads.append(total)
    return [torch.cat(outs["actor"]), torch.cat(outs["critic"])[:, 0]] + grads


@pytest.mark.parametrize("rows", [1, 127, 4097])
@pytest.mark.parametrize("obs_dim,hidden", SHAPES)
def test_kernel_order_is_the_plain_version_within_phase_p_tolerance(obs_dim, hidden, rows):
    """The transcription of the kernels' tiles and reduce in float32 against the
    plain composition and its autograd: every tensor within ``chip_smoke.mlp_bounds``
    (max(1e-5 of its scale, 8 x the two-halves control))."""
    case = chip_smoke.mlp_case(obs_dim, hidden, rows, seed=3 * rows + obs_dim)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    want = chip_smoke.mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs, g_mu, g_v)
    bounds = chip_smoke.mlp_bounds(want, chip_smoke.mlp_control(params, leaves, obs, g_mu,
                                                                g_v))
    with torch.no_grad():
        got = kernel_order(params, obs, g_mu, g_v)
    errs = chip_smoke.mlp_errors(got, want)
    assert all(e <= b for e, b in zip(errs, bounds)), \
        [(name, e, b) for name, e, b in zip(chip_smoke.MLP_OUTPUTS, errs, bounds) if e > b]


@pytest.mark.parametrize("mistake", ["w2 transposed", "actor without its final tanh",
                                     "critic with a final tanh"])
def test_kernel_order_mistakes_break_the_tolerance(mistake, monkeypatch):
    """The transcription with one of the mistakes the tolerance must catch falls
    outside it: the check is not too loose to see them."""
    case = chip_smoke.mlp_case(19, (64, 64), 300, seed=11)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    want = chip_smoke.mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs, g_mu, g_v)
    bounds = chip_smoke.mlp_bounds(want, chip_smoke.mlp_control(params, leaves, obs, g_mu,
                                                                g_v))
    with torch.no_grad():
        wrong = {t: [tuple(x.detach().clone() for x in layer) for layer in ls]
                 for t, ls in params.items()}
        if mistake == "w2 transposed":
            for t in wrong:
                wrong[t][1] = (wrong[t][1][0].T.contiguous(), wrong[t][1][1])
            got = kernel_order(wrong, obs, g_mu, g_v)
        else:
            real_tanh = torch.tanh
            calls = {"n": 0}

            def tanh(x):  # the towers' tanh calls a tile: actor 3, then critic 2
                calls["n"] += 1
                k = (calls["n"] - 1) % 5
                if mistake == "actor without its final tanh" and k == 2:
                    return x
                return real_tanh(x)

            monkeypatch.setattr(torch, "tanh", tanh)
            got = kernel_order(params, obs, g_mu, g_v)
            monkeypatch.setattr(torch, "tanh", real_tanh)
            if mistake == "critic with a final tanh":
                got[1] = torch.tanh(got[1])
    errs = chip_smoke.mlp_errors(got, want)
    assert any(e > b for e, b in zip(errs, bounds))


def test_tiles_and_the_instantiated_towers():
    """The backward's partials have a row a 128-row tile; the kernels are built for
    towers (64, 64) (every config's default) and (128, 128) (chip_smoke.py phase
    j's), obs_dim a run-time argument: at (64, 64) every single-car sensor count and
    self-play at 1 to 8 cars of 11 sensors (11 + 4 x cars inputs) fit a block's
    shared memory, to obs_dim 184; at (128, 128) to 27."""
    assert [_cuda.mlp_tiles(n) for n in (1, 127, 128, 129, 4097, 65_536)] == \
        [1, 1, 1, 2, 33, 512]
    assert _cuda.MLP_HIDDEN == ((64, 64), (128, 128))
    assert _cuda.mlp_max_obs_dim(64, 64) == 184 and _cuda.mlp_max_obs_dim(128, 128) == 27
    assert _cuda.mlp_shared_bytes(19, 64, 64) == 101_488
    assert _cuda.mlp_shared_bytes(19, 128, 128) == 224_112
    assert all(_cuda.mlp_takes(11 + 4 * cars, 64, 64) for cars in range(1, 9))
    assert not _cuda.mlp_takes(19, 64, 32) and not _cuda.mlp_takes(0, 64, 64)
    assert chip_smoke.mlp_macs(19, 64, 64) == (10_816, 19_200)


def _leaves(obs_dim, hidden, dtype=torch.float32):
    case = chip_smoke.mlp_case(obs_dim, hidden, 8, seed=0)
    params, leaves, obs, _, _ = chip_smoke.mlp_tensors(case, torch.device("cpu"), dtype)
    return params, leaves, obs


@pytest.mark.parametrize("obs_dim,hidden", SHAPES + [
    (1, (64, 64)), (11, (64, 64)), (23, (64, 64)), (43, (64, 64)), (184, (64, 64)),
    (27, (128, 128))])
def test_check_takes_the_instantiated_towers(obs_dim, hidden):
    _, leaves, obs = _leaves(obs_dim, hidden)
    assert mlpops._check_towers(obs, None, leaves) == (obs_dim,) + hidden
    units = obs.reshape(2, 4, obs_dim)
    assert mlpops._check_towers(units, torch.tensor([1, 0]), leaves) == (obs_dim,) + hidden


@pytest.mark.parametrize("what", ["float64", "non-contiguous obs", "towers (19, 64, 32)",
                                  "obs 28 at (128, 128)", "obs 185", "towers (19, 96, 96)",
                                  "a third hidden layer", "int32 unit ids",
                                  "obs [n, d] with unit ids", "obs 11 against towers of 19"])
def test_check_refuses_what_the_kernels_do_not_take(what):
    """What a CUDA tensor would raise on, before any launch (``_check_towers`` on CPU
    tensors; on the card ``tests/test_torch_cuda_kernels.py`` and phase p)."""
    params, leaves, obs = _leaves(19, (64, 64))
    ids = None
    if what == "float64":
        _, leaves, obs = _leaves(19, (64, 64), torch.float64)
    elif what == "non-contiguous obs":
        obs = obs.t().contiguous().t()
    elif what == "towers (19, 64, 32)":
        _, leaves, obs = _leaves(19, (64, 32))
    elif what == "obs 28 at (128, 128)":
        _, leaves, obs = _leaves(28, (128, 128))
    elif what == "obs 185":
        _, leaves, obs = _leaves(185, (64, 64))
    elif what == "towers (19, 96, 96)":
        _, leaves, obs = _leaves(19, (96, 96))
    elif what == "obs 11 against towers of 19":
        obs = _leaves(11, (64, 64))[2]
    elif what == "a third hidden layer":
        _, leaves, obs = _leaves(19, (64, 64, 64))
    elif what == "int32 unit ids":
        obs, ids = obs.reshape(2, 4, 19), torch.tensor([0, 1], dtype=torch.int32)
    else:
        ids = torch.tensor([0, 1])
    with pytest.raises((TypeError, ValueError)):
        mlpops._check_towers(obs, ids, leaves)
