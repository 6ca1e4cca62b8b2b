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
- a PyTorch transcription of the kernels' order (``kernel_order``: the products in
  3xTF32 as the tensor cores take them, the operands split as ``cvt.rna`` splits them
  on their int32 view, the narrow sums over the lanes in the kernel's shuffle tree,
  each 64-row tile's weight and bias gradients accumulated by its block of the fixed
  grid in tile order, then the blocks' rows summed in 8 groups of consecutive rows
  and the groups in order) within phase p's tolerance of the plain version
  (``chip_smoke.mlp_bounds``: max(1e-5 of the tensor's scale, 8 x the plain
  composition's own distance with the rows in two halves)): it catches a transposed
  weight, the actor's final tanh or the critic's missing one, one TF32 product in
  place of three, and weights without their low part, before the card does; and
  the split itself (low 13 bits zero, ties away from zero, hi + lo within 2^-22);
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


def tf32(x):
    """``cvt.rna.tf32.f32`` on the int32 view: round to the nearest 10-bit mantissa,
    ties away from zero (the magnitude's bits plus half of the dropped 13, then
    cut)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """A float32 tensor as TF32 (hi, lo): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma3(acc, a, b, products=3, weight_lo=True, b_is_weight=False):
    """``acc`` + ``a`` @ ``b`` over one step of 8 k as the kernels issue it: a and b
    split, the products lo*hi, hi*lo and hi*hi in that order, each step's 8 products
    summed exactly onto the float32 accumulator (float64 here, one rounding).
    ``products=1`` keeps hi*hi alone, ``weight_lo=False`` drops b's low part where b
    is a weight: the mistakes the tolerance must catch."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    if products == 1:
        terms = terms[2:]
    elif b_is_weight and not weight_lo:
        terms = [terms[0], terms[2]]
    for p, q in terms:
        acc = (acc.double() + p.double() @ q.double()).float()
    return acc


def product(a, b, acc=None, **kw):
    """``acc`` (zero) + ``a`` [M, K] @ ``b`` [K, N] in steps of 8 k in order (K padded
    with zeros to 8s)."""
    k = a.shape[1]
    pad = -k % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    acc = torch.zeros((a.shape[0], b.shape[1])) if acc is None else acc
    for k0 in range(0, k + pad, 8):
        acc = mma3(acc, a[:, k0:k0 + 8], b[k0:k0 + 8], **kw)
    return acc


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def butterfly(p):
    """The sum over the last axis of 8 (a warp's g) by the shuffle tree: pairs g, g^1,
    then g^2, then g^4."""
    for m in (1, 2, 4):
        idx = torch.arange(8) ^ m
        p = p + p[..., idx]
    return p[..., 0]


def last_layer(h2, w3):
    """z = h2 W3 as the kernel's lanes sum it: lane t chains its columns 8 j + 2t, + 1
    in order by FMA, then (z0 + z1) + (z2 + z3)."""
    rows, h = h2.shape
    cols = h2.reshape(rows, h // 8, 4, 2)
    w = w3.reshape(h // 8, 4, 2, -1)
    z = torch.zeros((rows, 4, w3.shape[1]))
    for j in range(h // 8):
        for e in range(2):
            z = fma(cols[:, j, :, e, None], w[j, :, e], z)
    return (z[:, 0] + z[:, 1]) + (z[:, 2] + z[:, 3])


def warp_sums(v):
    """A tile's [64, C] per-row pairs as the kernel sums them: a warp's rows g and g +
    8 a lane's value (``v`` holds it already paired: [4 warps, 8 g, C]), the
    butterfly over g, then the 4 warps in order."""
    per = butterfly(v.permute(0, 2, 1))
    total = per[0]
    for w in range(1, per.shape[0]):
        total = total + per[w]
    return total


def kernel_order(params, obs, g_mu, g_v, tile=_cuda.MLP_ROWS_PER_TILE,
                 blocks=_cuda.MLP_BACKWARD_BLOCKS, groups=8, products=3, weight_lo=True,
                 partials=None):
    """The kernels' order in PyTorch (``csrc/mlp_towers.cu``): the hidden layers'
    products and the weight gradients in 3xTF32 (``mma3``: steps of 8 k in order, the
    operands split as ``cvt.rna`` splits them), the last layer and the narrow sums
    over the lanes in the kernel's tree, each ``tile``-row tile's gradients (g3 = d mu
    * (1 - mu^2) through the actor's tanh, d v for the critic; g2 = (g3 W3^T) * (1 -
    h2^2); g1 = (g2 W2^T) * (1 - h1^2); h2^T g3, h1^T g2, x^T g1 and the bias sums)
    accumulated by block b over its tiles b, b + G, ... in order (G = min(tiles,
    ``blocks``)), then the blocks' rows summed in ``groups`` groups of consecutive
    rows, each in order from zero, and the group sums in order. Returns [mu, v, the 12
    gradients]; given a list ``partials``, appends each tower's blocks' rows to it
    ([blocks, the tower's parameters], its 6 tensors flat in order)."""
    n, d = obs.shape
    tiles = -(-n // tile)
    nblk = min(tiles, blocks)
    pad = tiles * tile - n
    x = torch.nn.functional.pad(obs, (0, 0, 0, pad))
    mm = functools.partial(product, products=products, weight_lo=weight_lo, b_is_weight=True)
    outs, grads = [], []
    for tower, g_out, final_tanh in (("actor", g_mu, True), ("critic", g_v[:, None], False)):
        (w1, b1), (w2, b2), (w3, b3) = params[tower]
        h1 = torch.tanh(mm(obs, w1) + b1)
        h2 = torch.tanh(mm(h1, w2) + b2)
        z = last_layer(h2, w3) + b3
        y = torch.tanh(z) if final_tanh else z
        outs.append(y)
        # rows past n: zero upstream gradients, so every product of theirs is zero
        h1, h2, y = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (h1, h2, y))
        g = torch.nn.functional.pad(g_out, (0, 0, 0, pad))
        g3 = g * (1 - y * y) if final_tanh else g
        d2 = g3[:, :1] * w3[:, 0]
        if w3.shape[1] == 2:
            d2 = fma(g3[:, 1:], w3[:, 1], d2)
        g2 = d2 * (1 - h2 * h2)
        g1 = mm(g2, w2.T) * (1 - h1 * h1)
        acc = [[torch.zeros_like(p) for p in (w1, b1, w2, b2, w3, b3)] for _ in range(nblk)]
        for t in range(tiles):
            rows = slice(t * tile, (t + 1) * tile)
            a = acc[t % nblk]

            def pairs(u, v=None):
                """[4 warps, 8 g, C]: rows g and g + 8 of each warp's 16 as the lane
                pairs them (u + v, or fma(u_{g+8}, v_{g+8}, u_g v_g) with v)."""
                u = u[rows].reshape(4, 2, 8, -1)
                if v is None:
                    return u[:, 0] + u[:, 1]
                v = v[rows].reshape(4, 2, 8, -1)
                return fma(u[:, 1], v[:, 1], u[:, 0] * v[:, 0])

            a[4] = a[4] + warp_sums(torch.stack(
                [pairs(h2, g3[:, o:o + 1].expand_as(h2)) for o in range(g3.shape[1])],
                -1).reshape(4, 8, -1)).reshape(w3.shape)
            a[5] = a[5] + warp_sums(pairs(g3))
            a[3] = a[3] + warp_sums(pairs(g2))
            a[1] = a[1] + warp_sums(pairs(g1))
            a[2] = product(h1[rows].T, g2[rows], a[2], products=products)
            a[0] = product(x[rows].T, g1[rows], a[0], products=products)
        if partials is not None:
            partials.append(torch.stack([torch.cat([p.reshape(-1) for p in a]) for a in acc]))
        per = -(-nblk // groups)
        for i in range(6):
            sums = []
            for k in range(groups):
                s = torch.zeros_like(acc[0][i])
                for part in acc[k * per:(k + 1) * per]:
                    s = s + part[i]
                sums.append(s)
            total = sums[0]
            for s in sums[1:]:
                total = total + s
            grads.append(total)
    return [outs[0], outs[1][:, 0]] + grads


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12,
                               3.14159265, -2.718281828e-3, 6.1e-5, 1e30])
def test_tf32_split_is_cvt_rna(x):
    """The split the kernels issue: hi = cvt.rna.tf32(x) has its low 13 bits zero and
    is x rounded to the nearest 10-bit mantissa, ties away from zero; lo = the same of
    x - hi; hi + lo is x within 2^-22 of it."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = split(t)
    assert int(hi.view(torch.int32)) & 0x1FFF == 0 and int(lo.view(torch.int32)) & 0x1FFF == 0
    v = float(t)
    ulp = 2.0 ** (np.floor(np.log2(abs(v))) - 10)
    assert abs(float(hi) - v) <= ulp / 2
    if abs(float(hi) - v) == ulp / 2:  # a tie: away from zero
        assert abs(float(hi)) > abs(v)
    assert abs(float(hi) + float(lo) - v) <= 2.0 ** -22 * abs(v)


def test_tf32_split_rounds_ties_away_from_zero():
    """Ties at the 13th dropped bit go away from zero, for either sign; below a tie
    the mantissa is cut."""
    one = 1.0 + 2 ** -11  # exactly half a TF32 ulp past 1
    got = tf32(torch.tensor([one, -one, 1.0 + 2 ** -12], dtype=torch.float32))
    assert got.tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]


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
                                     "critic with a final tanh", "one TF32 product",
                                     "weights without their low part"])
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
        elif mistake == "one TF32 product":
            got = kernel_order(params, obs, g_mu, g_v, products=1)
        elif mistake == "weights without their low part":
            got = kernel_order(params, obs, g_mu, g_v, weight_lo=False)
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
    """The kernels' tiles are 64 rows and the backward's partials a row a block of its
    fixed grid (128 blocks a tower); they are built for towers (64, 64) (every
    config's default) and (128, 128) (chip_smoke.py phase j's), obs_dim a run-time
    argument: at (64, 64) every single-car sensor count and self-play at 1 to 8 cars
    of 11 sensors (11 + 4 x cars inputs) fit a block's shared memory, to obs_dim 248
    (the FFMA kernels before took 184); at (128, 128) to 72 (27 before)."""
    assert [_cuda.mlp_tiles(n) for n in (1, 64, 65, 127, 128, 129, 4097, 65_536)] == \
        [1, 1, 2, 2, 2, 3, 65, 1024]
    assert [_cuda.mlp_partial_rows(n) for n in (1, 127, 4097, 8192, 8193, 65_536)] == \
        [1, 2, 65, 128, 128, 128]
    assert _cuda.MLP_HIDDEN == ((64, 64), (128, 128))
    assert _cuda.mlp_max_obs_dim(64, 64) == 248 and _cuda.mlp_max_obs_dim(128, 128) == 72
    assert _cuda.mlp_max_obs_dim(64, 64) >= 184 and _cuda.mlp_max_obs_dim(128, 128) >= 27
    # the least a block of either kernel needs: at (64, 64) the backward's (one tower,
    # one tile, h1, g2 and the narrow sums), at (128, 128) the forward's (two towers)
    assert _cuda.mlp_shared_bytes(19, 64, 64) == 4 * (5892 + 2560 + 2 * 64 * 72 + 1032)
    assert _cuda.mlp_shared_bytes(19, 128, 128) == 4 * (2 * 19_972 + 2560) == 170_016
    assert all(_cuda.mlp_takes(11 + 4 * cars, 64, 64) for cars in range(1, 9))
    assert not _cuda.mlp_takes(19, 64, 32) and not _cuda.mlp_takes(0, 64, 64)
    assert chip_smoke.mlp_macs(19, 64, 64) == (10_816, 19_200)


def _leaves(obs_dim, hidden, dtype=torch.float32):
    case = chip_smoke.mlp_case(obs_dim, hidden, 8, seed=0)
    params, leaves, obs, _, _ = chip_smoke.mlp_tensors(case, torch.device("cpu"), dtype)
    return params, leaves, obs


@pytest.mark.parametrize("obs_dim,hidden", SHAPES + [
    (1, (64, 64)), (11, (64, 64)), (23, (64, 64)), (43, (64, 64)), (184, (64, 64)),
    (27, (128, 128)), (248, (64, 64)), (64, (128, 128)), (72, (128, 128))])
def test_check_takes_the_instantiated_towers(obs_dim, hidden):
    _, leaves, obs = _leaves(obs_dim, hidden)
    assert mlpops._check_towers(obs, None, leaves) == (obs_dim,) + hidden
    units = obs.reshape(2, 4, obs_dim)
    assert mlpops._check_towers(units, torch.tensor([1, 0]), leaves) == (obs_dim,) + hidden


@pytest.mark.parametrize("obs_dim,hidden", [(19, (64, 32)), (73, (128, 128)), (249, (64, 64)),
                                            (19, (96, 96)), (19, (64, 64, 64))])
def test_check_takes_the_general_towers(obs_dim, hidden):
    """Towers the compiled kernels do not take go to the general route
    (``_cuda.mlp_route``), checked as the compiled ones are."""
    _, leaves, obs = _leaves(obs_dim, hidden)
    assert _cuda.mlp_route(obs_dim, hidden) == "general"
    assert mlpops._check_towers(obs, None, leaves) == (obs_dim,) + hidden


@pytest.mark.parametrize("what", ["float64", "non-contiguous obs", "towers (19, 64, 1025)",
                                  "obs 1025 at (128, 128)", "eight hidden layers",
                                  "a critic of other widths", "a last layer of 3 outputs",
                                  "int32 unit ids", "obs [n, d] with unit ids",
                                  "obs 11 against towers of 19"])
def test_check_refuses_what_the_kernels_do_not_take(what):
    """What a CUDA tensor would raise on, before any launch (``_check_towers`` on CPU
    tensors; on the card ``tests/test_torch_cuda_kernels.py`` and phase p): float64,
    non-contiguous, towers past the general route's limits (widths and obs_dim to
    1024, 7 hidden layers) or not an actor-critic pair."""
    params, leaves, obs = _leaves(19, (64, 64))
    ids = None
    if what == "float64":
        _, leaves, obs = _leaves(19, (64, 64), torch.float64)
    elif what == "non-contiguous obs":
        obs = obs.t().contiguous().t()
    elif what == "towers (19, 64, 1025)":
        _, leaves, obs = _leaves(19, (64, 1025))
    elif what == "obs 1025 at (128, 128)":
        _, leaves, obs = _leaves(1025, (128, 128))
    elif what == "eight hidden layers":
        _, leaves, obs = _leaves(19, (8,) * 8)
    elif what == "a critic of other widths":
        leaves = leaves[:6] + _leaves(19, (96, 96))[1][6:]
    elif what == "a last layer of 3 outputs":
        leaves = leaves[:4] + [torch.zeros(64, 3), torch.zeros(3)] + leaves[6:]
    elif what == "obs 11 against towers of 19":
        obs = _leaves(11, (64, 64))[2]
    elif what == "int32 unit ids":
        obs, ids = obs.reshape(2, 4, 19), torch.tensor([0, 1], dtype=torch.int32)
    else:
        ids = torch.tensor([0, 1])
    with pytest.raises((TypeError, ValueError)):
        mlpops._check_towers(obs, ids, leaves)
