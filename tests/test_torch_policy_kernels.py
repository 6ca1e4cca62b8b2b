"""The rollout step's policy kernels' entry points (``ops/policy.py``) on the CPU.

The kernels (``csrc/policy.cu``) run only on the card (chip_smoke.py phase q and the
``cuda`` cases of ``test_torch_cuda_kernels.py``). Here:

- the plain routes (``policy_action_plain``, ``sample_action_plain``,
  ``deterministic_action_plain``, ``opponent_actions_plain``, the rollout step's
  ``rollout_policy_plain``) against jitted JAX on shared seeded draws: float64
  within rtol 1e-12 (matrix products and tanh round differently in XLA's and
  PyTorch's CPU math), float32 within rtol 1e-5, atol 1e-6;
- the kernels' route with the launches patched to ``policy_kernel_model`` (a CPU
  model of the kernels in their float32 order of operations; its towers are the
  plain composition): the wrappers' pointers, buffers, row maps and refusals; kernel
  B's three index modes with and without the members' normalisers against JAX
  (float32, rtol 1e-5, atol 1e-6); the rollout step through kernel A's entry
  writing row t bitwise today's buffers (the plain route's);
- a float32 transcription of the epilogue (the clamp, then ``normal_lp.cuh``'s
  order) bitwise ``net.normal_log_prob`` and ``ops/minibatch.py``'s plain head;
- ``ShardedParams`` and CPU tensors routed to the plain versions.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import normalize as jnorm
from self_play_racing_tpu.envs import selfplay as jsp
from self_play_racing_tpu.models import actor_critic as jnet
import policy_kernel_model as model
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent import trainer as ttrainer
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import normalize as tnorm
from self_play_racing_tpu_torch.envs import selfplay as tsp
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.models import actor_critic as tnet
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import minibatch as mbops
from self_play_racing_tpu_torch.ops import policy as polops
from self_play_racing_tpu_torch.utils import metrics as tmetrics

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ helpers

def _jax_params(obs_dim, seed, dtype, hidden=(64, 64)):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                        jnet.init_params(jax.random.key(seed), obs_dim, 2, hidden=hidden))


def _port_params(jparams, dtype):
    """The JAX parameter tree as the port's dict on the CPU."""
    return {tower: [tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in layer)
                    for layer in layers] for tower, layers in jparams.items()}


def _norm(rng, d, members=None):
    shape = (d,) if members is None else (members, d)
    var = rng.uniform(0.05, 2.0, shape)
    var[..., 0] = 1e-4  # the +-10 clamp takes feature 0
    return rng.normal(0.0, 0.5, shape).astype(np.float32), var.astype(np.float32)


def _jax_pool(p, obs_dim, normalize, seed=0, dtype=jnp.float32, scale=30.0):
    """A stacked JAX pool of ``p`` members (weights scaled so that their actions
    differ), as ``test_torch_selfplay.py`` builds it."""
    members = [jnet.init_params(jax.random.key(seed + i), obs_dim, 2) for i in range(p)]
    params = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype) * scale, *members)
    rng = np.random.default_rng(seed)
    pool = {"params": params,
            "log_std": jnp.asarray(rng.uniform(-1.5, -0.3, (p, 2)), dtype)}
    if normalize:
        mean, var = _norm(rng, obs_dim, p)
        pool["norm_mean"], pool["norm_var"] = jnp.asarray(mean), jnp.asarray(var)
    return pool


def _port_opp(jopp):
    pool = interop.pool_from_jax(jax.tree.map(np.asarray, {
        k: v for k, v in jopp.items() if k in ("params", "log_std", "norm_mean", "norm_var")
        and v is not None}), device="cpu")
    return {**pool, "norm_mean": pool.get("norm_mean"), "norm_var": pool.get("norm_var"),
            "idx": torch.as_tensor(np.asarray(jopp["idx"])),
            "use_policy": torch.as_tensor(np.asarray(jopp["use_policy"]))}


def _jax_randoms(key, rows, dtype):
    """JAX's opponent draws from a transition key: (normal, [0, 1) uniforms)."""
    k_noise, k_rand = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, (rows, 2), dtype)),
            np.asarray(jax.random.uniform(k_rand, (rows, 2), dtype)))


@jax.jit
def _jax_policy(params, log_std, obs, noise, mean, var):
    """JAX's normaliser, actor and sample on given noise: (mu, action, log-prob)."""
    x = jnorm.apply(jnorm.ObsNormState(mean, var, None), obs)
    mu = jnet.actor_mu(params, x)
    action = jnp.clip(mu + jnp.exp(log_std) * noise, -1.0, 1.0)
    return mu, action, jnet.normal_log_prob(action, mu, log_std), jnet.critic_value(params, x)


@pytest.fixture
def kernels(monkeypatch):
    """The kernels' route on CPU tensors, launches through ``policy_kernel_model``."""
    model.patch(monkeypatch)
    before = dict(model.calls)
    yield lambda: {k: model.calls[k] - before[k] for k in before}


# --------------------------------------------- the plain routes against JAX

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sampled", [False, True])
def test_policy_action_plain_matches_jax(dtype, sampled):
    d, n = 19, 48
    rng = np.random.default_rng(int(sampled))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jp = _jax_params(d, 3, dtype)
    ls = np.asarray([-0.4, -0.9], dtype)
    obs = rng.uniform(-1, 1.5, (n, d)).astype(np.float32)
    noise = rng.standard_normal((n, 2)).astype(dtype)
    mean, var = _norm(rng, d)
    mu, act, lp, v = map(np.asarray, _jax_policy(jp, jnp.asarray(ls), jnp.asarray(obs),
                                                 jnp.asarray(noise), jnp.asarray(mean),
                                                 jnp.asarray(var)))
    tp = _port_params(jp, tdt)
    norm = tnorm.ObsNormState(torch.as_tensor(mean), torch.as_tensor(var), None)
    got = polops.policy_action_plain(tp, torch.as_tensor(ls), torch.as_tensor(obs),
                                     torch.as_tensor(noise) if sampled else None, norm)
    tol = F64 if dtype == np.float64 else F32
    np.testing.assert_allclose(got.numpy(), act if sampled else mu, **tol)
    x = tnorm.apply(norm, torch.as_tensor(obs))
    ta, tlp, tv = tnet.sample_action_plain(tp, torch.as_tensor(ls), x, torch.as_tensor(noise))
    np.testing.assert_allclose(ta.numpy(), act, **tol)
    np.testing.assert_allclose(tlp.numpy(), lp, **tol)
    np.testing.assert_allclose(tv.numpy(), v, **tol)
    np.testing.assert_allclose(tnet.deterministic_action_plain(tp, x).numpy(), mu, **tol)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_opponent_actions_with_the_learners_action_match_jax(shared, normalize):
    """``opponent_actions_all_seats(..., first=)`` (the multi env's whole action, the
    learner's as car 0) on the plain route, against JAX's all-seat opponents and the
    cat, float64."""
    n, seats = 16, 2
    cfg = jmulti.MultiRacingConfig(num_agents=seats + 1)
    d = cfg.obs_dim
    rng = np.random.default_rng(3 * int(shared) + int(normalize))
    jpool = _jax_pool(4, d, normalize, dtype=jnp.float64)
    idx = np.int32(1) if shared else rng.integers(0, 4, n).astype(np.int32)
    use = np.bool_(True) if shared else rng.random(n) < 0.6
    jopp = {**jpool, "norm_mean": jpool.get("norm_mean"), "norm_var": jpool.get("norm_var"),
            "idx": jnp.asarray(idx), "use_policy": jnp.asarray(use)}
    obs = rng.uniform(-1, 1, (n, seats, d)).astype(np.float32)
    first = rng.uniform(-1, 1, (n, 2))
    key = jax.random.key(5)
    want = np.asarray(jsp.opponent_actions_all_seats(cfg, jopp, jnp.asarray(obs), key))
    draws = _jax_randoms(key, n * seats, jnp.float64)

    class Gen:
        pass

    feed = [draws]
    orig = tsp.opponent_randoms
    try:
        tsp.opponent_randoms = lambda g, rows, dtype, device: tuple(
            torch.as_tensor(a, dtype=dtype) for a in feed.pop())
        got = tsp.opponent_actions_all_seats(tmulti.MultiRacingConfig(num_agents=seats + 1),
                                             _port_opp(jopp), torch.as_tensor(obs), Gen(),
                                             first=torch.as_tensor(first))
    finally:
        tsp.opponent_randoms = orig
    assert got.shape == (n, seats + 1, 2)
    np.testing.assert_array_equal(got[:, 0].numpy(), first.astype(np.float32))
    np.testing.assert_allclose(got[:, 1:].numpy(), want, **F64)


# ------------------------------------------- kernel B's modes against JAX

@pytest.mark.parametrize("mode", ["per env", "one", "seat"])
@pytest.mark.parametrize("normalize", [False, True])
def test_pool_act_index_modes_match_jax(kernels, mode, normalize):
    """Kernel B's route (the model) in each index mode, float32, against JAX: an [N]
    index and a 0-d one through ``opponent_actions_all_seats`` (the learner's action
    as car 0), seat mode through ``metrics._seat_actions`` (a policy a seat)."""
    n, seats = 24, (3 if mode == "seat" else 2)
    cfg = jmulti.MultiRacingConfig(num_agents=seats + (mode != "seat"))
    d = cfg.obs_dim
    rng = np.random.default_rng(11 + int(normalize))
    members = seats if mode == "seat" else 4
    jpool = _jax_pool(members, d, normalize or mode == "seat", seed=2)
    obs = rng.uniform(-1, 1, (n, cfg.num_agents, d)).astype(np.float32)
    key = jax.random.key(9)
    if mode == "seat":
        noise = rng.standard_normal((n, seats, 2)).astype(np.float32)
        mean = np.asarray(jpool["norm_mean"]) if normalize else np.zeros((seats, d), np.float32)
        var = np.asarray(jpool["norm_var"]) if normalize else np.ones((seats, d), np.float32)
        want = np.stack([np.asarray(_jax_policy(
            jax.tree.map(lambda a, s=s: a[s], jpool["params"]), jpool["log_std"][s],
            jnp.asarray(obs[:, s]), jnp.asarray(noise[:, s]), jnp.asarray(mean[s]),
            jnp.asarray(var[s]))[1]) for s in range(seats)], axis=1)
        pool = interop.pool_from_jax(jax.tree.map(np.asarray, {
            "params": jpool["params"], "log_std": jpool["log_std"]}), device="cpu")
        got = tmetrics._seat_actions(pool["params"], pool["log_std"], torch.as_tensor(obs),
                                     torch.as_tensor(noise), tnorm.ObsNormState(
                                         torch.as_tensor(mean), torch.as_tensor(var), None))
        assert kernels() == {"policy_act": 0, "pool_act": 1}
        np.testing.assert_allclose(got.numpy(), want, **F32)
        return
    idx = np.int32(2) if mode == "one" else rng.integers(0, members, n).astype(np.int32)
    use = np.bool_(True) if mode == "one" else rng.random(n) < 0.6
    jopp = {**jpool, "norm_mean": jpool.get("norm_mean"), "norm_var": jpool.get("norm_var"),
            "idx": jnp.asarray(idx), "use_policy": jnp.asarray(use)}
    want = np.asarray(jsp.opponent_actions_all_seats(cfg, jopp, jnp.asarray(obs[:, 1:]), key))
    draws = _jax_randoms(key, n * seats, jnp.float32)
    first = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    orig = tsp.opponent_randoms
    try:
        tsp.opponent_randoms = lambda g, rows, dtype, device: tuple(
            torch.as_tensor(a, dtype=dtype) for a in draws)
        got = tsp.opponent_actions_all_seats(None, _port_opp(jopp),
                                             torch.as_tensor(obs)[:, 1:], None, first=first)
    finally:
        tsp.opponent_randoms = orig
    assert kernels() == {"policy_act": 0, "pool_act": 1}
    assert got.shape == (n, seats + 1, 2)
    assert torch.equal(got[:, 0], first)
    np.testing.assert_allclose(got[:, 1:].numpy(), want, **F32)


@pytest.mark.parametrize("mode", ["per env", "one"])
@pytest.mark.parametrize("normalize", [False, True])
def test_pool_act_is_the_plain_composition_on_its_mu(kernels, mode, normalize):
    """Kernel B's epilogue (the sample with the row's member's exp(log_std), the
    uniform action, the use_policy select) bitwise the plain version's, where the
    model's mu is the plain version's (the same rows under the same member):
    ``opponent_actions`` on the flat rows, an int64 index too."""
    n, d, members = 40, 19, 3
    rng = np.random.default_rng(21 + int(normalize))
    jpool = _jax_pool(members, d, normalize, seed=4)
    idx = np.int64(1) if mode == "one" else np.full(n, 1, np.int64)
    use = np.bool_(False) if mode == "one" else rng.random(n) < 0.5
    opp = _port_opp({**jpool, "norm_mean": jpool.get("norm_mean"),
                     "norm_var": jpool.get("norm_var"), "idx": idx, "use_policy": use})
    obs = torch.as_tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((n, 2)).astype(np.float32))
    uniforms = torch.as_tensor(rng.random((n, 2)).astype(np.float32))
    got = tsp.opponent_actions(None, opp, obs, noise, uniforms)
    want = tsp.opponent_actions_plain(None, opp, obs, noise, uniforms)
    assert kernels() == {"policy_act": 0, "pool_act": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    member = opp["params"]["actor"]
    one = {"actor": [(w[1], b[1]) for w, b in member]}
    x = obs if not normalize else tsp._normalized(opp["norm_mean"][1], opp["norm_var"][1], obs)
    mu = tnet.actor_mu(one, x)
    sampled = torch.clamp(mu + torch.exp(opp["log_std"][1]) * noise, -1.0, 1.0)
    low, high = (torch.tensor(v) for v in (model.LOW, model.HIGH))
    rand = torch.maximum(low, uniforms * (high - low) + low)
    expect = torch.where(torch.as_tensor(use).expand(n)[:, None], sampled, rand)
    assert torch.equal(got, expect)


# -------------------------------------- the rollout step through kernel A's entry

def _single_runner(n, steps, normalize):
    cfg = base_config(num_envs=n, num_steps=steps, num_minibatches=2, update_epochs=1,
                      total_timesteps=n * steps * 4, normalize_obs=normalize)
    np.random.seed(5)  # gen_tracks draws each track's shape from the global RNG
    pool = ttrack.make_track_pool(ttrack.gen_tracks(2, seed=5), [7.0, 8.0],
                                  dtype=torch.float32, device="cpu")
    track = ttrack.gather_tracks(pool, np.arange(n) % 2)
    env_cfg = tsingle.RacingConfig(num_sensors=11)
    hooks = ttrainer.make_single_env_hooks(env_cfg)
    runner = tppo.init_runner(torch.Generator().manual_seed(0), cfg, hooks, track,
                              env_cfg.obs_dim, 2)
    return cfg, hooks, runner, track


@pytest.mark.parametrize("normalize", [False, True])
def test_rollout_step_through_the_kernel_entry_is_todays_buffers(monkeypatch, normalize):
    """``rollout_phase`` with the policy through kernel A's entry (the model: the
    normaliser, the towers, the sample and log-prob in the kernel's order, row t of
    the obs, actions, log-probs and values written in place) bitwise the plain
    route's buffers, final carry and normaliser, on the CPU in float32; one launch a
    step."""
    n, steps = 12, 6
    outs = {}
    for route in ("plain", "kernel"):
        with monkeypatch.context() as mp:
            if route == "kernel":
                model.patch(mp)
            before = model.calls["policy_act"]
            cfg, hooks, runner, track = _single_runner(n, steps, normalize)
            noise = tnet.sample_noise((steps, n, 2), torch.Generator().manual_seed(4))
            log_std = torch.tensor([-0.3, -0.6])
            outs[route] = tppo.rollout_phase(cfg, hooks, runner, track, log_std, noise)
            launches = model.calls["policy_act"] - before
        assert launches == (steps if route == "kernel" else 0)
    (pv, po, pd, pn, ptraj, pout), (kv, ko, kd, kn, ktraj, kout) = outs["plain"], outs["kernel"]
    assert set(pout) == set(kout)
    for k in pout:
        assert torch.equal(pout[k], kout[k]), k
    assert torch.equal(po, ko) and torch.equal(pd, kd)
    assert torch.equal(pn.mean, kn.mean) and torch.equal(pn.var, kn.var)
    assert ptraj.obs.shape == (steps, n, 15) and ktraj.actions.dtype == torch.float32


# ------------------------------------------------------------ the epilogue

def test_epilogue_transcription_is_normal_log_prob_and_the_plain_head():
    """The kernels' epilogue in float32 numpy, in their order (the sample
    ``clamp(mu + std * noise, -1, 1)``; a dimension's ``((-(d * d) / den - log_std) -
    c)``, den = 2 exp(2 log_std); ``(a + b) + 0``), bitwise ``net.normal_log_prob``
    on the CPU and the negated log-ratio of ``ops/minibatch.py``'s plain head against
    old log-probs of 0. The two exp values come from torch (libm's and numpy's exp
    may round apart); every other operation is IEEE float32 in both."""
    rng = np.random.default_rng(8)
    n = 4096
    mu = np.tanh(rng.normal(0, 1.5, (n, 2))).astype(np.float32)
    noise = rng.standard_normal((n, 2)).astype(np.float32)
    noise[:64] *= 50.0  # the clamp's both sides
    ls_t = torch.tensor([-0.4, -1.3])
    std = torch.exp(ls_t).numpy()
    den = (np.float32(2.0) * torch.exp(np.float32(2.0) * ls_t).numpy()).astype(np.float32)
    ls = ls_t.numpy()
    c = np.float32(0.5 * math.log(2.0 * math.pi))
    act = np.clip(mu + std * noise, np.float32(-1), np.float32(1))
    d = act - mu
    terms = (-(d * d) / den - ls) - c
    lp = (terms[:, 0] + terms[:, 1]) + np.float32(0.0)
    assert act.dtype == lp.dtype == np.float32
    assert (np.abs(act) == 1).sum() > 32
    t = torch.as_tensor
    want_act = torch.clamp(t(mu) + torch.exp(ls_t) * t(noise), -1.0, 1.0)
    np.testing.assert_array_equal(act, want_act.numpy())
    np.testing.assert_array_equal(lp, tnet.normal_log_prob(want_act, t(mu), ls_t).numpy())
    np.testing.assert_array_equal(lp, model.log_prob(want_act, t(mu), ls_t,
                                                     model.HALF_LOG_2PI).numpy())
    zeros = torch.zeros(n)
    neg_log_ratio = mbops.ppo_head_plain(t(mu), zeros, want_act, zeros, zeros, zeros, zeros,
                                         ls_t, torch.tensor(0.0), torch.tensor(1.0), 0.2)[0]
    np.testing.assert_array_equal(-lp, neg_log_ratio.numpy())
    assert polops._act_constants()[2] == np.float32(c) == model.HALF_LOG_2PI


# ---------------------------------------------------- what the kernels take

def _act_case(d=19, n=10, hidden=(64, 64), critic=True):
    rng = np.random.default_rng(d + n)
    p = _port_params(_jax_params(d, 1, np.float32, hidden), torch.float32)
    if not critic:
        p = {"actor": p["actor"]}
    return (p, torch.tensor([-0.4, -0.9]),
            torch.as_tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32)),
            torch.as_tensor(rng.standard_normal((n, 2)).astype(np.float32)))


@pytest.mark.parametrize("d,hidden", [(15, (64, 64)), (19, (64, 64)), (23, (64, 64)),
                                      (43, (64, 64)), (184, (64, 64)), (19, (128, 128))])
def test_the_kernels_take_the_towers_of_the_paths(kernels, d, hidden):
    """Every path's towers: kernel A sampled with the critic, greedy without it, and
    in the rollout mode (strided rows: the self-play view's seat 0), kernel B on the
    pool; each one launch, outputs of the documented shapes."""
    p, ls, obs, noise = _act_case(d, 10, hidden)
    a, lp, v = polops.sample_action(p, ls, obs, noise)
    assert a.shape == (10, 2) and lp.shape == (10,) and v.shape == (10,)
    assert polops.deterministic_action({"actor": p["actor"]}, obs).shape == (10, 2)
    wide = torch.zeros((10, 3, d))
    wide[:, 0] = obs
    out = {}
    act = polops.rollout_sample(p, ls, wide[:, 0], noise[None].expand(3, 10, 2).contiguous(),
                                torch.tensor([2]), None, out)
    assert torch.equal(out["obs"][2], obs) and torch.equal(out["actions"][2], act)
    pool = [tuple(torch.stack([t, t]) for t in layer) for layer in p["actor"]]
    got = polops.pool_act(pool, torch.stack([ls, ls]), wide[:, 1:], noise.repeat(2, 1),
                          torch.zeros(10, dtype=torch.int32), first=act)
    assert got.shape == (10, 3, 2) and torch.equal(got[:, 0], act)
    assert kernels() == {"policy_act": 3, "pool_act": 1}


def _refusals():
    p, ls, obs, noise = _act_case()
    narrow = {t: [(w[:, :32] if w.shape[-1] == 64 else w[:32], b[:32] if b.shape[0] == 64 else b)
                  for w, b in p[t]] for t in p}
    pool = [tuple(torch.stack([t, t]) for t in layer) for layer in p["actor"]]
    opp_obs = obs[:, None]
    return {
        "float64 obs": lambda: polops.sample_action(p, ls, obs.double(), noise),
        "float64 towers": lambda: polops.deterministic_action(
            {k: [(w.double(), b.double()) for w, b in v] for k, v in p.items()}, obs),
        "strided features": lambda: polops.deterministic_action(p, obs.repeat(1, 2)[:, ::2]),
        "other widths": lambda: polops.deterministic_action(narrow, obs),
        "two layers": lambda: polops.deterministic_action({"actor": p["actor"][:2]}, obs),
        "a critic of other inputs": lambda: polops.sample_action(
            {"actor": p["actor"], "critic": _act_case(15)[0]["critic"]}, ls, obs, noise),
        "an obs_dim past the general route's": lambda: polops.deterministic_action(
            _act_case(1025, 10, (128, 128))[0], _act_case(1025, 10, (128, 128))[2]),
        "noise of another shape": lambda: polops.sample_action(p, ls, obs, noise[:7]),
        "a log_std of another shape": lambda: polops.sample_action(p, ls[:1], obs, noise),
        "t of another dtype": lambda: polops.rollout_sample(
            p, ls, obs, noise[None], torch.tensor([0], dtype=torch.int32), None, {}),
        "a float index": lambda: polops.pool_act(pool, torch.stack([ls, ls]), opp_obs,
                                                 noise, torch.zeros(10)),
        "an index of another length": lambda: polops.pool_act(
            pool, torch.stack([ls, ls]), opp_obs, noise, torch.zeros(9, dtype=torch.int32)),
        "seat mode on another count": lambda: polops.pool_act(pool, torch.stack([ls, ls]),
                                                              opp_obs, noise),
        "use_policy not bool": lambda: polops.pool_act(
            pool, torch.stack([ls, ls]), opp_obs, noise, torch.zeros(10, dtype=torch.int32),
            uniforms=noise, use_policy=torch.ones(10), low=model.LOW, high=model.HIGH),
        "a pool normaliser of another shape": lambda: polops.pool_act(
            pool, torch.stack([ls, ls]), opp_obs, noise, torch.zeros(10, dtype=torch.int32),
            torch.zeros((2, 18)), torch.ones((2, 18))),
        "strided seats": lambda: polops.pool_act(
            pool, torch.stack([ls, ls]), torch.zeros((10, 4, 19))[:, ::2], noise.repeat(2, 1),
            torch.zeros(10, dtype=torch.int32)),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_the_kernels_refuse_what_they_do_not_take(kernels, case):
    """Each refused before any launch (the model counts none)."""
    with pytest.raises((TypeError, ValueError)):
        _refusals()[case]()
    assert kernels() == {"policy_act": 0, "pool_act": 0}


def _policy_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/policy.cu``."""
    src = (_cuda.CSRC_DIR / "policy.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_shared_bytes_transcribe_the_layout():
    """``policy_shared_bytes`` as ``csrc/mlp_tower.cuh:Layout`` and ``GroupTower`` lay a
    block out, with ``csrc/policy.cu``'s constants: at (19, 64, 64) a tower is
    round_up(24 x 64 + 64 + 64 x 64 + 64 + 2 x 64 + 2, 4) = 5892 floats, a row of
    observations 40 and a group's activation tile 16 x 72; kernel A both towers, 32 rows,
    the normaliser's mean and var and four groups' tiles (its warps split each
    fragment); kernel B one tower, a wave of 16 rows a group of two warps, the
    normaliser, its groups' tiles, then its range's observation offsets (int64) and
    row offsets and the warps' counts."""
    assert (_cuda.POLICY_ACT_ROWS, _cuda.POLICY_ACT_SPLIT, _cuda.POOL_ACT_RANGE,
            _cuda.POOL_ACT_WARPS, _cuda.POOL_ACT_SPLIT) == tuple(
        _policy_constant(k) for k in ("kActRows", "kActSplit", "kPoolRange", "kPoolWarps",
                                      "kPoolSplit"))
    assert _cuda.POLICY_ACT_SPLIT == 4 and _cuda.POOL_ACT_SPLIT == 2
    r, warps = _cuda.POOL_ACT_RANGE, _cuda.POOL_ACT_WARPS
    assert _cuda.policy_shared_bytes(False, 19, 64, 64) == 4 * (2 * 5892 + 32 * 40 + 2 * 40
                                                                + 4 * 16 * 72)
    assert _cuda.policy_shared_bytes(True, 19, 64, 64) == 4 * (5892 + 8 * warps * 40 + 2 * 40
                                                               + warps // 2 * 16 * 72
                                                               + 3 * r + warps)
    assert _cuda.policy_shared_bytes(True, 184, 64, 64) > 0
    assert _cuda.policy_shared_bytes(False, 19, 32, 32) == 0
    assert _cuda.policy_shared_bytes(False, 0, 64, 64) == 0
    widest = max(d for d in range(1, 400) if _cuda.policy_shared_bytes(False, d, 128, 128))
    assert _cuda.policy_shared_bytes(False, widest + 1, 128, 128) == 0
    assert 4 * (2 * (8 * 12 * 128 + 16898 + 2) + 32 * (widest + 8)) > 0 and widest >= 43


# ------------------------------------------ kernel B's packing, transcribed

def pool_blocks(rows: int, seats: int, cars: int, off: int, kind: int, member, use,
                members: int) -> dict:
    """A numpy transcription of ``pool_act_f32``'s packing (``csrc/policy.cu``:
    ``pack_rows``): the block of range b (rows [b R, (b + 1) R), R = ``kPoolRange`` read
    from the source) and grid member y takes member p = y (the 0-d index's entry for
    a 0-d index) and, of its range's rows whose member is p, those whose ``use`` holds
    (None: no uniforms, all), in row order: packed row j is fragment j // 16, position
    j % 16; the rest of them get their uniform action there. Returns {(b, p): (taken
    rows, uniform rows)}."""
    width = _policy_constant("kPoolRange")
    r = np.arange(rows)
    env = r // seats
    if kind == _cuda.POOL_SEAT:
        m = off + r % seats
    elif kind == _cuda.POOL_PER_ENV:
        m = np.asarray(member)[env]
    else:
        m = np.full(rows, int(np.asarray(member).reshape(-1)[0]))
    u = np.ones(rows, bool) if use is None else np.asarray(use).reshape(-1)[
        env if np.asarray(use).size > 1 else 0 * env]
    out = {}
    for b in range(-(-rows // width)):
        span = r[b * width:(b + 1) * width]
        for y in range(1 if kind == _cuda.POOL_ONE else members):
            p = int(m[0]) if kind == _cuda.POOL_ONE else y
            mine = span[m[span] == p]
            out[b, p] = (mine[u[mine]], mine[~u[mine]])
    return out


def _members(dist: str, envs: int, rng):
    """An [envs] index over a pool of 5 and its use_policy, as
    chip_smoke.with_members draws them."""
    use = np.ones(envs, bool)
    if dist == "uniform":
        member = rng.integers(0, 5, envs)
    elif dist == "skewed":
        member = rng.integers(1, 5, envs)
        member[rng.permutation(envs)[:-(-4 * envs // 5)]] = 0
        assert (member == 0).mean() >= 0.8
    elif dist == "two live":
        member = rng.integers(0, 2, envs)
    elif dist == "runs":
        member = np.arange(envs) * 5 // envs
    elif dist == "mixed":
        member, use = rng.integers(0, 5, envs), rng.random(envs) < 0.7
    else:  # "all random": the empty pool's index
        member, use = np.zeros(envs, np.int64), np.zeros(envs, bool)
    return member, use


def _hold_packing(blocks, rows: int, seats: int, cars: int, off: int, member_of, use_of):
    """Every row whose use holds taken exactly once, by a block of its own member, at
    consecutive fragment positions in row order; every other row taken by none and
    given its uniform action once, by its own member's block."""
    taken, uniform = np.zeros(rows, int), np.zeros(rows, int)
    for (b, p), (take, rand) in blocks.items():
        assert all(member_of(r) == p for r in np.concatenate([take, rand]))
        assert np.all(np.diff(take) > 0) and np.all(take // _cuda.POOL_ACT_RANGE == b)
        # fragment j // 16, position j % 16: no block computes a fragment of no rows
        assert -(-len(take) // 16) == len({j // 16 for j in range(len(take))})
        taken[take] += 1
        uniform[rand] += 1
    use = np.array([use_of(r) for r in range(rows)], bool)
    assert np.all(taken[use] == 1) and np.all(taken[~use] == 0)
    assert np.all(uniform[~use] == 1) and np.all(uniform[use] == 0)


@pytest.mark.parametrize("dist", ["uniform", "skewed", "two live", "runs", "mixed",
                                  "all random"])
@pytest.mark.parametrize("envs,seats", [(1, 1), (64, 1), (4095, 1), (4096, 1), (8192, 1),
                                        (2048, 2), (700, 3), (512, 7)])
def test_pool_packing_takes_each_policy_row_once_under_its_member(dist, envs, seats):
    """Kernel B's packing (``pool_blocks``) on the per-env index: each row whose
    use_policy holds runs its tower once, in its own member's block; a row whose
    use_policy is False runs none and gets its uniform action once; a block whose
    member has no such row in its range has nothing to stage. For uniform, skewed
    (one member on >= 80%), two live of five, members in runs (absent from whole
    ranges), mixed use_policy and the empty pool (all random), 1-8192 envs, 1-7
    seats."""
    rng = np.random.default_rng(envs + seats)
    member, use = _members(dist, envs, rng)
    rows = envs * seats
    blocks = pool_blocks(rows, seats, seats + 1, 1, _cuda.POOL_PER_ENV, member, use, 5)
    _hold_packing(blocks, rows, seats, seats + 1, 1, lambda r: member[r // seats],
                  lambda r: use[r // seats])
    if dist == "runs" and rows >= 5 * _cuda.POOL_ACT_RANGE:
        assert sum(len(t) == 0 for t, _ in blocks.values()) >= len(blocks) // 2
    if dist == "all random":
        assert all(len(t) == 0 for t, _ in blocks.values())


@pytest.mark.parametrize("seats", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("envs", [1, 64, 4096, 8192])
def test_pool_packing_seat_and_one_member_modes(seats, envs):
    """Seat mode (seat s's rows r = s mod seats, member s, P = seats) and a 0-d index
    (every row the one member's; use_policy 0-d True, then an [envs] mix): each row's
    tower runs once, under its member."""
    rows = envs * seats
    blocks = pool_blocks(rows, seats, seats, 0, _cuda.POOL_SEAT, None, None, seats)
    _hold_packing(blocks, rows, seats, seats, 0, lambda r: r % seats, lambda r: True)
    for use in (np.array(True), np.random.default_rng(envs).random(envs) < 0.5):
        blocks = pool_blocks(rows, seats, seats + 1, 1, _cuda.POOL_ONE, np.array(3), use, 5)
        assert set(p for _, p in blocks) == {3}
        _hold_packing(blocks, rows, seats, seats + 1, 1, lambda r: 3,
                      lambda r: bool(use.reshape(-1)[r // seats if use.size > 1 else 0]))


# ----------------------------------------------- what takes the plain version

def test_sharded_params_and_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors take the plain versions, the model unlaunched; a tensor-parallel
    rank's ``ShardedParams`` take them on any device (here with the kernels' route
    forced on), bitwise the plain version."""
    p, ls, obs, noise = _act_case()
    model.patch(monkeypatch, on_cpu_kernels=False)
    before = dict(model.calls)
    a, lp, v = tnet.sample_action(p, ls, obs, noise)
    want = tnet.sample_action_plain(p, ls, obs, noise)
    assert all(torch.equal(x, y) for x, y in zip((a, lp, v), want))
    assert torch.equal(tnet.deterministic_action(p, obs), tnet.deterministic_action_plain(p, obs))
    assert torch.equal(tmetrics._policy_action(p, ls, obs, noise),
                       polops.policy_action_plain(p, ls, obs, noise))
    assert model.calls == before
    model.patch(monkeypatch)  # now the CPU takes the kernels' route
    # a model group of one: no leaf split, so the composition is the plain one
    dims = {tower: [(None, None)] * len(p[tower]) for tower in ("actor", "critic")}
    tp = tnet.TensorParallel(dims=dims, group=None, size=1, rank=0)
    sharded = tnet.ShardedParams(p, tp)
    assert not polops.whole_towers(sharded, obs) and polops.whole_towers(p, obs)
    assert torch.equal(tnet.deterministic_action(sharded, obs),
                       tnet.deterministic_action_plain(p, obs))
    assert model.calls == before
    tnet.deterministic_action(p, obs)
    assert model.calls["policy_act"] == before["policy_act"] + 1
