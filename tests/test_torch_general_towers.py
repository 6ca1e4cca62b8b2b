"""Towers of any depth and width: the general route's plans and limits, and the plain
route at such towers against the JAX package, on the CPU.

- ``_cuda.mlp_route`` against a table (which towers the compiled kernels take, which
  the general ones) and the limits that raise (1 to 7 hidden layers, widths and
  obs_dim 1 to 1024); ``_cuda.general_plan`` (kernels A and B) against a table of
  tile rows and shared bytes, ``_cuda.general_gemm_plan`` (the layer-major forward
  and backward) against a table of the rows a partial row sums, the partial rows,
  the slabs and the scratch, and the constants they mirror against the CUDA
  sources.
- The plain route at (19, 32, 16, 8), (19, 65, 65), (19, 32, 32, 32), (19, 256, 256)
  and (184, 128, 128): ``actor_critic_mlp_plain`` and its autograd against jitted JAX
  ``_mlp`` under ``value_and_grad`` (each tensor within 1e-13 of its largest |value|
  in float64, 2e-5 in float32: the products sum in another order),
  ``policy_action_plain`` against jitted JAX's normaliser, actor and sample, and
  ``opponent_actions_plain`` against JAX's ``opponent_actions`` on JAX's draws
  (rtol/atol 1e-12 in float64, rtol 1e-5 / atol 1e-6 in float32).
- The policy wrappers take the general kernels at such towers (their launches go
  through ``tests/policy_kernel_model.py``, which models the general entries too) and
  give the plain versions' numbers.
- ``interop.params_from_jax`` at three hidden layers: the tensors in order, bitwise.
- One self-play update (16 envs x 32 steps, 2 cars, float64) at ``hidden=(32, 16,
  8)`` with a pool of such towers, fed JAX's draws, against JAX's update: the metrics
  within rtol 1e-5 / atol 1e-6, the parameters and Adam moments within rtol 1e-6 /
  atol 1e-7 (``tests/test_torch_selfplay.py``'s tolerances).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import policy_kernel_model as model
from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.self_play import make_selfplay_hooks as jhooks
from self_play_racing_tpu.configs import self_play_config as jself_play_config
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import normalize as jnorm
from self_play_racing_tpu.envs import selfplay as jsp
from self_play_racing_tpu.models import actor_critic as jnet
from test_torch_selfplay import _Feed, _draws, _jax_randoms, _jax_slots, _port_opp, _tracks
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.self_play import make_selfplay_hooks
from self_play_racing_tpu_torch.configs import self_play_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import normalize as tnorm
from self_play_racing_tpu_torch.envs import selfplay as tsp
from self_play_racing_tpu_torch.models import actor_critic as tnet
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import mlp as mlpops
from self_play_racing_tpu_torch.ops import policy as polops

TOWERS = [(19, (32, 16, 8)), (19, (65, 65)), (19, (32, 32, 32)), (19, (256, 256)),
          (184, (128, 128))]
# of each tensor's largest |value| (tests/test_torch_mlp_kernels.py's)
SCALED = {np.float64: 1e-13, np.float32: 2e-5}
CLOSE = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=1e-5, atol=1e-6)}


# ------------------------------------------------------------ route and plans

ROUTES = [((19, 64, 64), "compiled"), ((15, 64, 64), "compiled"), ((248, 64, 64), "compiled"),
          ((19, 128, 128), "compiled"), ((48, 128, 128), "compiled"),
          ((249, 64, 64), "general"), ((49, 128, 128), "general"), ((73, 128, 128), "general"),
          ((19, 32, 32), "general"), ((19, 64, 32), "general"), ((19, 64, 64, 64), "general"),
          ((19, 64), "general"), ((19, 256, 256), "general"), ((1, 1), "general"),
          ((1024,) * 8, "general"), ((19, 400, 300), "general")]


@pytest.mark.parametrize("dims,route", ROUTES)
def test_mlp_route_takes_the_compiled_kernels_where_they_fit(dims, route):
    """The compiled route where all four compiled kernels take the towers (three
    layers at ``MLP_HIDDEN``, obs_dim within the forward's and kernel A's memory: 248
    at (64, 64), 48 at (128, 128)), the general one everywhere else."""
    assert _cuda.mlp_route(dims[0], dims[1:]) == route


@pytest.mark.parametrize("dims", [(19,) + (8,) * 8, (19, 0), (19, 1025), (0, 64, 64),
                                  (1025, 64, 64), (19,)])
def test_past_the_limits_raises_naming_them(dims):
    with pytest.raises(ValueError, match="1 to 7 hidden layers of widths 1 to 1024 on "
                                         "obs_dim 1 to 1024"):
        _cuda.mlp_route(dims[0], dims[1:])


# (kind, dims): kernels A and B (tile rows, shared bytes); the forward and the
# backward at 65,536 rows (the rows a partial row sums, the partial rows, a slab's
# rows, the slabs, the scratch floats)
PLANS = {("forward", (19, 256, 256)): (512, 128, 65_536, 1, 67_390_464),
         ("backward", (19, 256, 256)): (512, 128, 65_536, 1, 135_023_616),
         ("act", (19, 256, 256)): (16, 86_240),
         ("pool", (19, 256, 256)): (16, 87_840),
         ("forward", (19, 32, 16, 8)): (512, 128, 65_536, 1, 8_393_600),
         ("backward", (19, 32, 16, 8)): (512, 128, 65_536, 1, 16_257_920),
         ("forward", (19, 1024, 1024)): (512, 128, 64_384, 2, 267_988_992),
         ("backward", (19, 1024, 1024)): (512, 128, 31_744, 3, 264_572_928),
         ("backward", (1024,) * 8): (512, 128, 12_800, 6, 265_392_128),
         ("forward", (1, 1)): (512, 128, 65_536, 1, 1_048_584),
         ("backward", (43, 256, 256, 256)): (512, 128, 65_536, 1, 168_864_768),
         ("forward", (19, 400, 300)): (512, 128, 65_536, 1, 105_368_000)}


@pytest.mark.parametrize("kind,dims", sorted(PLANS))
def test_general_plan_table(kind, dims):
    """Kernels A and B: the first plan that fits by the most n-tiles a warp, then the
    most tile rows, first within half an SM's memory, 8 warps a block. The forward and
    the backward: 128 x 128 tiles of 256 threads, 512 rows a partial row at 65,536
    rows (128 partial rows), a slab the most whole units within the scratch budget
    (one at (19, 256, 256), several at width 1024)."""
    if kind in ("act", "pool"):
        plan = _cuda.general_plan(kind, dims)
        assert (plan.rows, plan.shared_bytes) == PLANS[kind, dims]
        assert plan.shared_bytes <= _cuda.BLOCK_SMEM_LIMIT
        assert plan.stride % 32 == 4 and plan.stride >= max(dims)
        assert plan.cols == 8 * plan.groups * plan.tiles
        assert plan.groups * plan.rows // 16 == plan.warps == 8
        assert plan.chunk * _cuda.GENERAL_STAGES * 4 < plan.shared_bytes
        return
    plan = _cuda.general_gemm_plan(kind, dims, 65_536)
    assert (plan.chunk_rows, plan.partial_rows, plan.slab_rows, plan.slabs,
            plan.scratch_floats) == PLANS[kind, dims]
    assert (plan.threads, plan.tile_m, plan.tile_n, plan.tile_k, plan.shared_bytes) == \
        (256, 128, 128, 16, 92_160)
    assert plan.scratch_floats <= _cuda.GENERAL_SCRATCH_BUDGET
    assert plan.slab_rows * plan.slabs >= 65_536 > plan.slab_rows * (plan.slabs - 1)
    if kind == "backward":
        assert plan.slab_rows % plan.chunk_rows == 0


def test_general_plan_at_every_width_fits_a_block():
    for width in (1, 7, 8, 9, 31, 64, 65, 100, 255, 256, 257, 511, 512, 777, 1023, 1024):
        for depth in (1, 2, 7):
            dims = (width,) * (depth + 1)
            for kind in ("act", "pool"):
                plan = _cuda.general_plan(kind, dims)
                assert plan.rows in (16, 32, 64) and plan.shared_bytes <= _cuda.BLOCK_SMEM_LIMIT
            for kind in ("forward", "backward"):
                for n in (1, 4095, 65_536):
                    plan = _cuda.general_gemm_plan(kind, dims, n)
                    assert plan.scratch_floats <= _cuda.GENERAL_SCRATCH_BUDGET
                    assert 1 <= plan.partial_rows <= _cuda.GENERAL_MAX_PARTIAL_ROWS
    assert _cuda.general_partial_rows(1, (19, 256, 256)) == 1
    assert _cuda.general_partial_rows(4095, (19, 256, 256)) == 8
    assert _cuda.general_partial_rows(65_536, (19, 256, 256)) == 128
    assert _cuda.general_partial_rows(100, (19, 1024, 1024)) == 1
    assert _cuda.general_scratch(4095, (19, 256, 256), "cpu").numel() == 8_702_976
    assert _cuda.general_scratch(4095, (19, 1024, 1024), "cpu", "forward").numel() == 21_049_344


# (dims, rows): the backward's (rows a partial row sums, partial rows, slab rows, slabs,
# scratch floats) and the forward's (slab rows, slabs, scratch floats) at phase s's
# towers, width 1024 and (1, 1) among them, and past 65,536 rows
GEMM_PLANS = {((19, 256, 256), 1): ((512, 1, 512, 1, 1_334_272), (128, 1, 412_672)),
              ((19, 256, 256), 4095): ((512, 8, 4096, 1, 8_702_976), (4096, 1, 4_475_904)),
              ((19, 256, 256), 100_000): ((784, 128, 100_352, 1, 206_605_312),
                                          (100_096, 1, 102_779_904)),
              ((19, 32, 16, 8), 4095): ((512, 8, 4096, 1, 1_020_800), (4096, 1, 529_280)),
              ((19, 1024, 1024), 1): ((512, 1, 512, 1, 8_470_528), (128, 1, 4_796_416)),
              ((19, 1024, 1024), 4095): ((512, 8, 4096, 1, 37_859_328),
                                         (4096, 1, 21_049_344)),
              ((19, 1024, 1024), 100_000): ((784, 128, 32_144, 4, 267_852_928),
                                            (64_384, 2, 267_988_992)),
              ((1, 1), 1): ((512, 1, 512, 1, 16_392), (128, 1, 2056)),
              ((1, 1), 4095): ((512, 8, 4096, 1, 131_080), (4096, 1, 65_544)),
              ((1024,) * 8, 65_536): ((512, 128, 12_800, 6, 265_392_128),
                                      (58_368, 2, 268_435_456))}


@pytest.mark.parametrize("dims,n", sorted(GEMM_PLANS))
def test_general_gemm_plan_rows_and_scratch(dims, n):
    """The layer-major kernels' geometry: a partial row sums max(512, n / 128 rounded
    up to 16) rows, so at most 128 partial rows; the scratch holds both towers' split
    weights (K x 2 round_up(N, 2) floats a hidden layer) and a slab's activations."""
    backward = _cuda.general_gemm_plan("backward", dims, n)
    forward = _cuda.general_gemm_plan("forward", dims, n)
    assert (backward.chunk_rows, backward.partial_rows, backward.slab_rows, backward.slabs,
            backward.scratch_floats) == GEMM_PLANS[dims, n][0]
    assert (forward.slab_rows, forward.slabs, forward.scratch_floats) == GEMM_PLANS[dims, n][1]
    assert _cuda.general_partial_rows(n, dims) == backward.partial_rows


def _constant(source: str, name: str) -> int:
    text = (_cuda.CSRC_DIR / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_are_the_sources():
    """``ops/_cuda.py``'s mirror of the plan reads the constants the CUDA sources use."""
    header = {"kMaxWarps": _cuda.GENERAL_MAX_WARPS, "kMaxHidden": _cuda.MLP_MAX_HIDDEN_LAYERS,
              "kMaxWidth": _cuda.MLP_MAX_WIDTH, "kMaxTiles": _cuda.GENERAL_MAX_TILES,
              "kChunkRows": _cuda.GENERAL_CHUNK_ROWS, "kStages": _cuda.GENERAL_STAGES,
              "kPoolRange": _cuda.GENERAL_POOL_RANGE,
              "kTileMax": _cuda.GENERAL_TILE_MAX}
    assert {k: _constant("mlp_stream.cuh", k) for k in header} == header
    gemm = {"kBM": _cuda.GENERAL_GEMM_TILE[0], "kBN": _cuda.GENERAL_GEMM_TILE[1],
            "kBK": _cuda.GENERAL_GEMM_TILE[2], "kMinChunkRows": _cuda.GENERAL_MIN_CHUNK_ROWS,
            "kMaxPartialRows": _cuda.GENERAL_MAX_PARTIAL_ROWS}
    assert {k: _constant("mlp_general.cu", k) for k in gemm} == gemm
    # a warp 16 kFM rows by 8 kFN columns; the block's threads the tile's warps
    warps = gemm["kBM"] // (16 * _constant("mlp_general.cu", "kFM")) \
        * (gemm["kBN"] // (8 * _constant("mlp_general.cu", "kFN")))
    assert 32 * warps == _cuda.GENERAL_GEMM_THREADS
    text = (_cuda.CSRC_DIR / "mlp_general.cu").read_text()
    assert re.search(r"kScratchBudget = 1LL << (\d+);", text).group(1) == \
        str(_cuda.GENERAL_SCRATCH_BUDGET.bit_length() - 1)
    assert "// 92,160: two blocks an SM" in text and _cuda.GENERAL_GEMM_SHARED_BYTES == 92_160
    # the reduce's partial rows are at most the compiled route's
    assert _cuda.GENERAL_MAX_PARTIAL_ROWS == _cuda.MLP_BACKWARD_BLOCKS
    # adam_tail's table holds both towers' tensors at the deepest tower
    assert 4 * (_cuda.MLP_MAX_HIDDEN_LAYERS + 1) == _cuda.ADAM_TAIL_MAX_TENSORS


# ------------------------------------------------- the plain route against JAX

@jax.jit
def _jax_mlp(params, obs, g_mu, g_v):
    def f(p):
        mu, v = jnet.actor_mu(p, obs), jnet.critic_value(p, obs)
        return jnp.sum(mu * g_mu) + jnp.sum(v * g_v), (mu, v)

    (_, (mu, v)), grads = jax.value_and_grad(f, has_aux=True)(params)
    return [mu, v] + [g for tower in ("actor", "critic") for layer in grads[tower]
                      for g in layer]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("obs_dim,hidden", TOWERS)
def test_plain_mlp_and_its_gradient_match_jax(obs_dim, hidden, dtype):
    case = chip_smoke.mlp_case(obs_dim, hidden, 33, seed=obs_dim + len(hidden), dtype=dtype)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    got = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    jparams = {t: [tuple(jnp.asarray(a) for a in layer) for layer in layers]
               for t, layers in case["params"].items()}
    want = _jax_mlp(jparams, *(jnp.asarray(case[k]) for k in ("obs", "g_mu", "g_v")))
    assert len(got) == len(want) == 2 + 4 * (len(hidden) + 1)
    for g, w in zip(got, want):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), np.finfo(np.float32).tiny)
        assert np.abs(g - w).max() <= SCALED[dtype] * scale


def _jax_params(obs_dim, hidden, seed, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                        jnet.init_params(jax.random.key(seed), obs_dim, 2, hidden=hidden))


def _port_params(jparams, dtype):
    return {tower: [tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in layer)
                    for layer in layers] for tower, layers in jparams.items()}


@jax.jit
def _jax_policy(params, log_std, obs, noise, mean, var):
    x = jnorm.apply(jnorm.ObsNormState(mean, var, None), obs)
    mu = jnet.actor_mu(params, x)
    action = jnp.clip(mu + jnp.exp(log_std) * noise, -1.0, 1.0)
    return mu, action, jnet.normal_log_prob(action, mu, log_std), jnet.critic_value(params, x)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("obs_dim,hidden", TOWERS)
def test_plain_policy_matches_jax(obs_dim, hidden, dtype):
    n = 24
    rng = np.random.default_rng(obs_dim)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jp = _jax_params(obs_dim, hidden, 2, dtype)
    ls = np.asarray([-0.4, -0.9], dtype)
    # the observations and the normaliser in the towers' dtype: the float64 case holds
    # the towers alone (float32 normalisers round a feature an ulp apart in XLA and
    # PyTorch, tests/test_torch_policy_kernels.py's cases hold them at (64, 64))
    obs = rng.uniform(-1, 1.5, (n, obs_dim)).astype(dtype)
    noise = rng.standard_normal((n, 2)).astype(dtype)
    mean = rng.normal(0.0, 0.5, obs_dim).astype(dtype)
    var = rng.uniform(0.05, 2.0, obs_dim).astype(dtype)
    mu, act, lp, v = map(np.asarray, _jax_policy(jp, jnp.asarray(ls), jnp.asarray(obs),
                                                 jnp.asarray(noise), jnp.asarray(mean),
                                                 jnp.asarray(var)))
    tp = _port_params(jp, tdt)
    norm = tnorm.ObsNormState(torch.as_tensor(mean), torch.as_tensor(var), None)
    tol = CLOSE[dtype]
    for noisy, want in ((None, mu), (torch.as_tensor(noise), act)):
        got = polops.policy_action_plain(tp, torch.as_tensor(ls), torch.as_tensor(obs), noisy,
                                         norm)
        np.testing.assert_allclose(got.numpy(), want, **tol)
    x = tnorm.apply(norm, torch.as_tensor(obs))
    ta, tlp, tv = tnet.sample_action_plain(tp, torch.as_tensor(ls), x, torch.as_tensor(noise))
    np.testing.assert_allclose(ta.numpy(), act, **tol)
    np.testing.assert_allclose(tlp.numpy(), lp, **tol)
    np.testing.assert_allclose(tv.numpy(), v, **tol)
    np.testing.assert_allclose(polops.policy_value(tp, x).numpy(), v, **tol)


def _jax_pool(p, obs_dim, hidden, dtype, scale=3.0):
    members = [jnet.init_params(jax.random.key(10 + i), obs_dim, 2, hidden=hidden)
               for i in range(p)]
    params = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype) * scale, *members)
    rng = np.random.default_rng(p)
    return {"params": params,
            "log_std": jnp.asarray(rng.uniform(-1.5, -0.3, (p, 2)), dtype),
            "norm_mean": jnp.asarray(rng.normal(0, 0.3, (p, obs_dim)), dtype),
            "norm_var": jnp.asarray(rng.uniform(0.2, 2.0, (p, obs_dim)), dtype)}


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("obs_dim,hidden", TOWERS)
def test_plain_opponent_actions_match_jax(obs_dim, hidden, dtype, shared):
    n, p = 32, 3
    rng = np.random.default_rng(obs_dim + int(shared))
    jpool = _jax_pool(p, obs_dim, hidden, jnp.float64 if dtype == np.float64 else jnp.float32)
    idx = np.int32(2) if shared else rng.integers(0, p, n).astype(np.int32)
    use = np.bool_(True) if shared else rng.random(n) < 0.7
    jopp = {**jpool, "idx": jnp.asarray(idx), "use_policy": jnp.asarray(use)}
    obs = rng.uniform(-1, 1.5, (n, obs_dim)).astype(dtype)
    key = jax.random.key(obs_dim)
    want = np.asarray(jsp.opponent_actions(jmulti.MultiRacingConfig(), jopp, jnp.asarray(obs),
                                           key))
    noise, uniforms = _jax_randoms(key, n, jnp.float64 if dtype == np.float64 else jnp.float32)
    got = tsp.opponent_actions_plain(tmulti.MultiRacingConfig(), _port_opp(jopp),
                                     torch.as_tensor(obs), torch.as_tensor(noise),
                                     torch.as_tensor(uniforms))
    np.testing.assert_allclose(got.numpy(), want, **CLOSE[dtype])


# ----------------------------------------- the wrappers on the general route

@pytest.mark.parametrize("obs_dim,hidden", [(19, (32, 16, 8)), (19, (256, 256)), (1, (1,))])
def test_the_wrappers_launch_the_general_kernels(monkeypatch, obs_dim, hidden):
    """On the kernels' route (``policy_kernel_model`` in for the launches) every
    policy wrapper launches the general kernel at such towers, the compiled one
    never, with the plain versions' numbers."""
    model.patch(monkeypatch)
    before, compiled = dict(model.general_calls), dict(model.calls)
    n = 10
    rng = np.random.default_rng(obs_dim)
    p = _port_params(_jax_params(obs_dim, hidden, 1, np.float32), torch.float32)
    ls = torch.tensor([-0.4, -0.9])
    obs = torch.as_tensor(rng.uniform(-1, 1, (n, obs_dim)).astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((n, 2)).astype(np.float32))
    a, lp, v = polops.sample_action(p, ls, obs, noise)
    pa, plp, pv = tnet.sample_action_plain(p, ls, obs, noise)
    assert torch.equal(a, pa) and torch.equal(lp, plp) and torch.equal(v, pv)
    assert torch.equal(polops.deterministic_action({"actor": p["actor"]}, obs),
                       tnet.deterministic_action_plain(p, obs))
    assert torch.equal(polops.policy_value(p, obs), tnet.critic_value(p, obs))
    out = {}
    act = polops.rollout_sample(p, ls, obs, noise[None].expand(3, n, 2).contiguous(),
                                torch.tensor([2]), None, out)
    assert torch.equal(out["obs"][2], obs) and torch.equal(out["actions"][2], act)
    pool = [tuple(torch.stack([t, 2 * t]) for t in layer) for layer in p["actor"]]
    member = torch.tensor(rng.integers(0, 2, n), dtype=torch.int32)
    got = polops.pool_act(pool, torch.stack([ls, ls]), obs[:, None], None, member)
    for m in (0, 1):
        sel = member == m
        want = tnet.actor_mu({"actor": [(w[m], b[m]) for w, b in pool]}, obs[sel])
        assert torch.equal(got[sel, 0], want)
    assert {k: model.general_calls[k] - before[k] for k in before} == \
        {"policy_act": 4, "pool_act": 1}
    assert model.calls == compiled


def test_the_mlp_autograd_function_takes_the_general_launches(monkeypatch):
    """``MLPTowers`` on the general route: the general forward, backward and reduce
    launches (patched with the plain composition in their places), the partials sized
    by the general plan, the forward keeping its activations in the backward's scratch
    and the backward reading them (``saved``); the gradients the plain route's."""
    dims = (19, 32, 16, 8)
    case = chip_smoke.mlp_case(dims[0], dims[1:], 70, seed=3)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, torch.device("cpu"))
    calls, kept = [], []

    def forward(o, ids, w, mu, v, n, d, scratch, keep):
        calls.append(("forward", len(w), n, tuple(d), keep, scratch.numel()))
        kept.append(scratch)
        p = {"actor": [(w[i], w[i + 1]) for i in range(0, len(w) // 2, 2)],
             "critic": [(w[i], w[i + 1]) for i in range(len(w) // 2, len(w), 2)]}
        m, val = mlpops.actor_critic_mlp_plain(p, o, ids)
        mu.copy_(m)
        v.copy_(val)

    def backward(o, ids, w, gm, gv, partial, n, d, scratch, saved):
        calls.append(("backward", partial.shape[0], n, tuple(d), saved, scratch is kept[0]))
        ws = [x.detach().requires_grad_() for x in w]
        p = {"actor": [(ws[i], ws[i + 1]) for i in range(0, len(ws) // 2, 2)],
             "critic": [(ws[i], ws[i + 1]) for i in range(len(ws) // 2, len(ws), 2)]}
        with torch.enable_grad():
            m, val = mlpops.actor_critic_mlp_plain(p, o, ids)
            grads = torch.autograd.grad((m, val), ws, (gm, gv))
        partial.zero_()
        partial[0] = torch.cat([g.reshape(-1) for g in grads])

    def reduce(partial, flat, norm=None):
        flat.copy_(partial.sum(0))

    monkeypatch.setattr(_cuda, "launch_mlp_general_forward", forward)
    monkeypatch.setattr(_cuda, "launch_mlp_general_backward", backward)
    monkeypatch.setattr(_cuda, "launch_general_grad_reduce", reduce)
    monkeypatch.setattr(mlpops, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    before = (mlpops.mlp_general_forward_launches, mlpops.mlp_general_backward_launches,
              mlpops.mlp_general_grad_reduce_launches, mlpops.mlp_forward_launches,
              mlpops.mlp_grad_reduce_launches)
    got = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    want = chip_smoke.mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs, g_mu, g_v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    scratch = _cuda.general_gemm_plan("backward", dims, 70).scratch_floats
    assert calls == [("forward", 16, 70, dims, True, scratch),
                     ("backward", _cuda.general_partial_rows(70, dims), 70, dims, True, True)]
    assert (mlpops.mlp_general_forward_launches, mlpops.mlp_general_backward_launches,
            mlpops.mlp_general_grad_reduce_launches, mlpops.mlp_forward_launches,
            mlpops.mlp_grad_reduce_launches) == (before[0] + 1, before[1] + 1, before[2] + 1,
                                                 before[3], before[4])


@pytest.mark.parametrize("dims,route", [((19, 32, 16, 8), "general"), ((19, 64, 64), "compiled"),
                                        ((19, 64, 32), "general")])
def test_grad_norm_takes_the_route_of_its_towers(monkeypatch, dims, route):
    """``grad_norm(flat, params)`` launches the norm-only mode of the reduce of the
    route that the towers ``params`` take (without them, the compiled one's) and
    refuses tensors that are not whole towers of the flat's size."""
    leaves = chip_smoke.mlp_tensors(chip_smoke.mlp_case(dims[0], dims[1:], 2, seed=0),
                                    torch.device("cpu"))[1]
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    calls = []
    monkeypatch.setattr(_cuda, "launch_general_grad_reduce",
                        lambda partial, out, norm: calls.append(("general", partial.shape, out)))
    monkeypatch.setattr(_cuda, "launch_mlp_grad_norm",
                        lambda f, norm: calls.append(("compiled", f.shape, None)))
    monkeypatch.setattr(mlpops, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(mlpops, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    before = (mlpops.mlp_grad_norm_launches, mlpops.mlp_general_grad_norm_launches)
    mlpops.grad_norm(flat, leaves)
    mlpops.grad_norm(flat)
    shape = (1, flat.numel()) if route == "general" else (flat.numel(),)
    assert calls == [(route, shape, None), ("compiled", (flat.numel(),), None)]
    general = route == "general"
    assert (mlpops.mlp_grad_norm_launches, mlpops.mlp_general_grad_norm_launches) == \
        (before[0] + 2 - general, before[1] + general)
    with pytest.raises(ValueError, match="whole towers"):
        mlpops.grad_norm(flat[1:], leaves)
    with pytest.raises(ValueError, match="whole towers"):
        mlpops.grad_norm(flat, leaves[1:])


def test_params_from_jax_at_three_hidden_layers():
    jp = jnet.init_params(jax.random.key(4), 19, 2, hidden=(32, 16, 8))
    model_ = interop.params_from_jax(jax.tree.map(np.asarray, jp), np.array([-0.5, -0.6]),
                                     dtype=torch.float32, device="cpu")
    params = model_.params()
    assert [tuple(w.shape) for w, _ in params["actor"]] == [(19, 32), (32, 16), (16, 8), (8, 2)]
    assert [tuple(w.shape) for w, _ in params["critic"]] == [(19, 32), (32, 16), (16, 8),
                                                             (8, 1)]
    for tower in ("actor", "critic"):
        for (w, b), (jw, jb) in zip(params[tower], jp[tower]):
            assert np.array_equal(w.detach().numpy(), np.asarray(jw, np.float32))
            assert np.array_equal(b.detach().numpy(), np.asarray(jb, np.float32))
    assert mlpops._check_towers(torch.zeros((4, 19)), None, list(model_.parameters())) == \
        (19, 32, 16, 8)


# ---------------------------------------------- one self-play update at (32, 16, 8)

def test_selfplay_update_at_three_hidden_layers_matches_jax(monkeypatch):
    n, a, p, hidden = 16, 2, 3, (32, 16, 8)
    kw = dict(num_envs=n, num_steps=32, num_minibatches=4, update_epochs=2,
              shuffle_block_size=4, total_timesteps=n * 32 * 5, kl_target=0.5,
              learning_rate=1e-3, opponent_per_env=True, reset_envs_each_update=False,
              hidden=hidden)
    cfg, jcfg = self_play_config(**kw), jself_play_config(**kw)
    env_cfg = jmulti.MultiRacingConfig(num_agents=a, sensor_cone=1.5)
    tenv_cfg = tmulti.MultiRacingConfig(num_agents=a, sensor_cone=1.5)
    jtr, ttr = _tracks(n, width=3.5)
    rng = np.random.default_rng(0)
    jpool = _jax_pool(p, env_cfg.obs_dim, hidden, jnp.float64)
    jpool = {**jpool, "norm_mean": None, "norm_var": None}
    jopp = {**jpool, "idx": jnp.asarray(rng.integers(0, p, n).astype(np.int32)),
            "use_policy": jnp.asarray(np.ones(n, bool))}
    jaux = {"track": jtr, "opp": jopp}
    taux = {"track": ttr, "opp": _port_opp(jopp)}

    hooks = jhooks(env_cfg, p)
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jaux, env_cfg.obs_dim, 2)
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), jrunner.train.params)
    assert [w.shape for w, _ in params["actor"]] == [(19, 32), (32, 16), (16, 8), (8, 2)]
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    jstep = jax.jit(jppo.make_update_step(jcfg, hooks, 2))

    feed = _Feed(monkeypatch)
    k_env = jax.random.split(jax.random.key(3), 4)[1]
    feed.slots.append(_jax_slots(k_env, n, a))
    thooks = make_selfplay_hooks(tenv_cfg, p)
    runner = tppo.init_runner(torch.Generator().manual_seed(0), cfg, thooks, taux,
                              tenv_cfg.obs_dim, 2)
    runner.train = interop.train_state_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state), 0,
        dtype=torch.float64, device="cpu")
    step = tppo.make_update_step(cfg, thooks)
    noise, consts, feed.slots, feed.randoms = _draws(jrunner.key, jrunner.vec.key, cfg, n, a,
                                                     False)
    jrunner, jpacked = jstep(jrunner, jaux)
    runner, packed = step(runner, taux, noise=torch.as_tensor(noise),
                          perm_consts=torch.as_tensor(consts))
    assert not feed.slots and not feed.randoms

    m, jm = tppo.unpack_metrics(packed), jppo.unpack_metrics(jpacked)
    for k in ("update", "global_step", "episodes", "kl_stopped", "minibatches_applied"):
        assert m[k] == jm[k], k
    np.testing.assert_allclose(packed, np.asarray(jpacked), rtol=1e-5, atol=1e-6)
    p_, adam, _ = interop.train_state_to_numpy(runner.train)
    jadam = jrunner.train.opt_state[1]
    for got, want in zip(jax.tree.leaves((p_, adam["mu"], adam["nu"])),
                         jax.tree.leaves((jrunner.train.params, jadam.mu, jadam.nu))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
