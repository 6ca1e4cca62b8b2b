"""The port's learner ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; JAX runs jitted.

- GAE: the plain version equals a float64 NumPy walk of the reference's source order
  bitwise. Against jitted JAX: float64 within atol 1e-12 (XLA's CPU backend
  contracts ``a * b + c`` into FMAs under jit, so it rounds a few ulps apart),
  float32 within atol 2e-5.
- The epoch permutations from JAX's own round constants: exactly equal.
- ``anneal_fractions``: exactly equal to the JAX function run eagerly; jitted, XLA
  multiplies by the reciprocal of num_updates and contracts ``1 - u * r`` into an
  FMA, so frac, lr and log_std agree within 2^-22 of 1, lr0 and 4 respectively.
- ``_ppo_loss`` and its gradients in float64: rtol 1e-9 (transcendentals and
  reductions round differently in XLA's and PyTorch's CPU math); the entropy term
  is a float32 mean that XLA sums in another order: rtol 1e-6, and 1e-8 on the
  loss it enters with ent_coef.
- One clip + Adam step against optax in float64: rtol 1e-12.
- Adam's bias corrections ``1 - b**count`` for counts 1..20000: exactly equal to
  optax's, in float32 with x64 off (the JAX package's training setting) and in
  float64 with x64 on.
- A full ``run_ppo_update`` from the same batch and permutations in float64: params
  and Adam moments rtol 1e-8 / atol 1e-12, per-minibatch stats (float32) rtol 1e-5 /
  atol 1e-7 (every slot, the zeros past the exit among them), applied/computed
  flags and the exit exactly, in ``UPDATE_CASES``: no exit, exits mid-epoch, on an
  epoch's last minibatch and on the first, the clip taken on some minibatches and
  never, two data shards. Every approx_kl is asserted to lie farther from
  kl_target than that tolerance, so the exit decision is well-posed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.ops.gae import compute_gae as jgae
from self_play_racing_tpu.ops.prng import epoch_permutation as jperm
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.ops import gae as tgae
from self_play_racing_tpu_torch.ops import prng as tprng


def _gae_inputs(rng, steps, envs, dtype):
    rewards = rng.normal(0, 3, (steps, envs)).astype(np.float32)
    values = rng.normal(0, 5, (steps, envs)).astype(dtype)
    dones = rng.random((steps, envs)) < 0.1
    dones[0, 0] = dones[5, 1] = dones[-1, 2] = True  # terminal steps, first and last
    next_value = rng.normal(0, 5, (envs,)).astype(dtype)
    next_done = rng.random(envs) < 0.3
    next_done[2] = True
    return rewards, dones, values, next_value, next_done


def _gae_source_order(rewards, dones, values, next_value, next_done, gamma, lam):
    """The reference's recurrence walked in NumPy, one rounding per operation."""
    g = np.asarray(gamma, rewards.dtype)
    gl = np.asarray(gamma * lam, rewards.dtype)
    nt = 1.0 - np.concatenate([dones[1:], next_done[None]]).astype(rewards.dtype)
    v_next = np.concatenate([values[1:], next_value[None]])
    deltas = rewards + g * nt * v_next - values
    adv = np.zeros_like(deltas)
    running = np.zeros_like(next_value)
    for t in range(len(rewards) - 1, -1, -1):
        running = deltas[t] + gl * nt[t] * running
        adv[t] = running
    return adv, adv + values


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 2e-5)])
def test_gae_matches_jax(dtype, atol):
    args = _gae_inputs(np.random.default_rng(0), 48, 24, dtype)
    ja, jr = jax.jit(jgae, static_argnums=(5, 6))(*args, 0.99, 0.95)
    ta, tr = tgae.compute_gae(*map(torch.as_tensor, args), 0.99, 0.95)
    assert tgae.compute_gae_launches == 0  # CPU tensors take the plain version
    assert ta.dtype == torch.float64 if dtype == np.float64 else torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=atol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=atol)
    na, nr = _gae_source_order(*args, 0.99, 0.95)
    np.testing.assert_array_equal(ta.numpy(), na)
    np.testing.assert_array_equal(tr.numpy(), nr)


def test_gae_all_done_and_no_done():
    rng = np.random.default_rng(1)
    r, _, v, nv, _ = _gae_inputs(rng, 16, 8, np.float32)
    for flag in (True, False):
        d = np.full(r.shape, flag)
        nd = np.full(nv.shape, flag)
        ta, tr = tgae.compute_gae(*map(torch.as_tensor, (r, d, v, nv, nd)), 0.99, 0.95)
        na, nr = _gae_source_order(r, d, v, nv, nd, 0.99, 0.95)
        np.testing.assert_array_equal(ta.numpy(), na)
        if flag:  # every step terminal: advantage = reward - value, no bootstrap
            np.testing.assert_array_equal(ta.numpy(), r - v)


def _jax_consts(ukey, epochs, shards):
    """JAX's round constants for run_ppo_update's epoch permutations."""
    ekeys = jax.random.split(ukey, epochs)
    if shards == 1:
        keys = ekeys[:, None]
    else:
        keys = jax.vmap(lambda k: jax.random.split(k, shards))(ekeys)
    bits = jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (8,), jnp.uint32)))(keys)
    return keys, np.asarray(bits).astype(np.int64)


@pytest.mark.parametrize("n", [1, 2, 1024, 16384])
@pytest.mark.parametrize("shards", [1, 2])
def test_mixbits_permutation_matches_jax_exactly(n, shards):
    keys, consts = _jax_consts(jax.random.key(n + shards), 3, shards)
    want = np.asarray(jax.vmap(jax.vmap(lambda k: jperm(k, n)))(keys))
    got = tprng.mixbits_permutation(torch.as_tensor(consts), n)
    assert got.dtype == torch.int32 and got.shape == (3, shards, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=-1),
                                  np.broadcast_to(np.arange(n), got.shape))
    assert tprng.mixbits_permutation_launches == 0


def test_epoch_permutation_draws_and_falls_back():
    gen = torch.Generator().manual_seed(0)
    p = tprng.epoch_permutation(gen, 64, shape=(4, 2))
    assert p.shape == (4, 2, 64)
    np.testing.assert_array_equal(np.sort(p.numpy(), axis=-1),
                                  np.broadcast_to(np.arange(64), p.shape))
    assert len({tuple(r) for r in p.reshape(8, 64).tolist()}) == 8
    q = tprng.epoch_permutation(gen, 48, shape=(3,))  # not a power of two: randperm
    np.testing.assert_array_equal(np.sort(q.numpy(), axis=-1),
                                  np.broadcast_to(np.arange(48), q.shape))
    with pytest.raises(ValueError, match="power-of-two"):
        tprng.mixbits_permutation(torch.zeros((8,), dtype=torch.int64), 48)
    with pytest.raises(ValueError, match="generator"):
        tprng.epoch_permutation(None, 48)


@pytest.mark.parametrize("total", [16 * 2048 * 152, 4096 * 256 * 100, 16 * 256 * 12])
def test_anneal_fractions_in_float32(total):
    cfg, jcfg = base_config(total_timesteps=total), jbase_config(total_timesteps=total)
    jit_anneal = jax.jit(lambda u: jppo.anneal_fractions(jcfg, u))
    n = cfg.num_updates
    for update in sorted({0, 1, 2, n // 3, n // 2, n - 1, n, n + 3}):
        frac, lr, log_std = tppo.anneal_fractions(cfg, update, device="cpu")
        assert frac.dtype == lr.dtype == np.float32 and log_std.dtype == torch.float32
        u = jnp.asarray(update, jnp.int32)
        scales = (1.0, cfg.learning_rate, 4.0)
        for got, eager, jitted, scale in zip((frac, lr, log_std.numpy()),
                                             jppo.anneal_fractions(jcfg, u), jit_anneal(u),
                                             scales):
            np.testing.assert_array_equal(got, np.asarray(eager))
            np.testing.assert_allclose(got, np.asarray(jitted), rtol=0, atol=scale * 2**-22)
        # -lr * u promotes: float64 updates see lr's float32 value exactly
        assert float(lr) == float(np.asarray(jppo.anneal_fractions(jcfg, u)[1]))


# ------------------------------------------------------------------ loss and update

OBS_DIM, ACT_DIM = 15, 2


def _params(seed, hidden=(16, 16)):
    """JAX parameters in float64 with nonzero biases, as numpy."""
    p = jnet.init_params(jax.random.key(seed), OBS_DIM, ACT_DIM, hidden=hidden)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        + (rng.normal(0, 0.05, a.shape) if a.ndim == 1 else 0.0), p)


def _batch(params, size, log_std, seed, lp_noise=0.05):
    """A rollout-like flat batch (numpy): old log-probs near the current policy's."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1.5, (size, OBS_DIM)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    mu = np.asarray(jnet.actor_mu(jp, jnp.asarray(obs)))
    act = np.clip(mu + np.exp(log_std) * rng.normal(size=mu.shape), -1, 1)
    lp = np.asarray(jnet.normal_log_prob(jnp.asarray(act), jnp.asarray(mu),
                                         jnp.asarray(log_std)))
    val = np.asarray(jnet.critic_value(jp, jnp.asarray(obs)))
    adv = rng.normal(0, 2, size)
    return dict(obs=obs, actions=act, logprobs=lp + rng.normal(0, lp_noise, size),
                advantages=adv, returns=adv + val + rng.normal(0, 0.3, size),
                values=val)


def _model(params):
    return interop.params_from_jax(params, np.zeros(ACT_DIM), dtype=torch.float64,
                                   device="cpu")


def test_ppo_loss_and_grads_match_jax_f64():
    cfg = base_config(num_envs=8, num_steps=16)
    params = _params(0)
    log_std = np.full((ACT_DIM,), -0.7, np.float32)
    b = _batch(params, 256, log_std, 1, lp_noise=0.2)
    (jloss, jst), jgrads = jax.value_and_grad(jppo._ppo_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(log_std),
        jppo.Batch(**{k: jnp.asarray(v) for k, v in b.items()}),
        jbase_config(num_envs=8, num_steps=16))
    model = _model(params)
    batch = tppo.Batch(**{k: torch.as_tensor(v) for k, v in b.items()})
    loss, st = tppo._ppo_loss(model.params(), torch.as_tensor(log_std), batch, cfg,
                              *chip_smoke.flat_moments(batch.advantages))
    st = dict(zip(tppo.STAT_NAMES, st))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert loss.dtype == torch.float64
    # the entropy is a float32 mean (log_std is float32), summed in another order
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-8)
    np.testing.assert_allclose(st["entropy"].item(), float(jst["entropy"]), rtol=1e-6)
    for k in ("pg_loss", "v_loss", "approx_kl", "clip_frac"):
        np.testing.assert_allclose(st[k].item(), float(jst[k]), rtol=1e-9, err_msg=k)
    assert 0 < float(st["clip_frac"]) < 1  # some ratios clip, some do not
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("scale", [1e-3, 10.0])  # global norm below / above max_norm
def test_clip_and_adam_step_match_optax_f64(scale):
    cfg = base_config()
    params = _params(2)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: scale * rng.normal(size=a.shape), params)
    opt = jppo.make_optimizer(cfg)
    state = opt.init(jax.tree.map(jnp.asarray, params))
    # two earlier steps so the moments and count are not trivial
    for _ in range(2):
        _, state = opt.update(jax.tree.map(lambda a: jnp.asarray(0.3 * a), grads), state)
    jupd, jstate = jax.jit(opt.update)(jax.tree.map(jnp.asarray, grads), state)
    jnorm = float(optax.global_norm(grads))
    assert (jnorm < cfg.max_grad_norm) == (scale < 1)

    train = interop.train_state_from_jax(params, jax.tree.map(np.asarray, state), 0,
                                         dtype=torch.float64, device="cpu")
    tg = [torch.as_tensor(np.asarray(a)) for a in jax.tree.leaves(grads)]
    g_norm = tppo.global_norm(tg)
    np.testing.assert_allclose(float(g_norm), jnorm, rtol=1e-13)
    clipped = tppo.clip_by_global_norm(tg, g_norm, cfg.max_grad_norm)
    # the corrections of the next count, as the minibatch loop's table holds them
    state0 = train.opt_state
    bc1, bc2 = (torch.as_tensor(tppo.bias_correction_table(b, state0.count, 1,
                                                           torch.float64))[0]
                for b in (tppo.ADAM_B1, tppo.ADAM_B2))
    upd, mu, nu = tppo.adam_update(clipped, state0.mu, state0.nu, bc1, bc2)
    assert state0.count + 1 == int(jstate[1].count) == 3
    for got, want in zip(upd, jax.tree.leaves(jupd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
    for got, want in zip(mu + nu,
                         jax.tree.leaves(jstate[1].mu) + jax.tree.leaves(jstate[1].nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-18)
    # params + (-lr * u) with a float32 lr
    lr = np.float32(2.5e-4)
    want = optax.apply_updates(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(lambda u: -jnp.asarray(lr) * u, jupd))
    new = tppo.apply_updates(list(train.model.parameters()), upd, lr)
    for got, w in zip(new, jax.tree.leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=1e-13)


@pytest.mark.parametrize("x64,dtype", [(False, torch.float32), (True, torch.float64)])
def test_adam_bias_corrections_match_optax(x64, dtype):
    counts = np.arange(1, 20001, dtype=np.int32)
    with jax.enable_x64(x64):
        # optax.tree_bias_correction's ``1 - decay**count`` from its int32 count
        want = {b: np.asarray(jax.jit(lambda c, b=b: 1 - b ** c)(jnp.asarray(counts)))
                for b in (tppo.ADAM_B1, tppo.ADAM_B2)}
    for b, w in want.items():
        assert w.dtype == np.dtype(str(dtype).removeprefix("torch."))
        got = np.array([tppo.bias_correction(b, int(c), dtype) for c in counts], w.dtype)
        np.testing.assert_array_equal(got, w, err_msg=f"b={b}")


UPDATE_CASES = {
    # name: (config overrides, learning rate, batch seed, the exit: None, "mid" or
    # its (computed, applied) minibatches)
    "no_exit": (dict(kl_target=0.5), 3e-4, 5, None),
    "mid_exit": (dict(kl_target=0.02), 2e-2, 5, "mid"),
    "two_shards": (dict(kl_target=0.5, data_shards=2), 3e-4, 5, None),
    "first_minibatch_exit": (dict(kl_target=0.0005), 3e-4, 9, (1, 0)),
    "epoch_last_exit": (dict(kl_target=0.015), 8e-3, 5, (4, 3)),
    "clip_some_minibatches": (dict(kl_target=0.5, max_grad_norm=1.8), 3e-4, 5, None),
    "clip_never": (dict(kl_target=0.5, max_grad_norm=50.0), 3e-4, 5, None),
}


def update_both(case, monkeypatch):
    """One ``run_ppo_update`` of the port and of JAX for ``UPDATE_CASES[case]``,
    from the same params, batch and permutation constants. Returns (cfg, the
    port's (model, opt_state, stop, stats), JAX's (params, Adam state, stop,
    stats), the global norms the port's loop took)."""
    overrides, lr, seed, _ = UPDATE_CASES[case]
    kw = dict(num_envs=8, num_steps=16, num_minibatches=4, update_epochs=3,
              shuffle_block_size=4, total_timesteps=8 * 16 * 4, **overrides)
    cfg, jcfg = base_config(**kw), jbase_config(**kw)
    params = _params(4)
    log_std = np.full((ACT_DIM,), -0.9, np.float32)
    b = _batch(params, cfg.batch_size, log_std, seed)
    lr32 = np.float32(lr)

    opt = jppo.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    ukey = jax.random.key(11)
    run = jax.jit(lambda p, s, f, k: jppo.run_ppo_update(
        jcfg, opt, p, s, jnp.asarray(log_std), jnp.asarray(lr32), f, k))
    jparams, jstate, jstop, jstats = run(
        jp, opt.init(jp), jppo.Batch(**{k: jnp.asarray(v) for k, v in b.items()}), ukey)

    block, n_units, _ = tppo.minibatch_layout(cfg)
    assert block == 4
    _, consts = _jax_consts(ukey, cfg.update_epochs, cfg.data_shards)
    perms = tprng.epoch_permutation(None, n_units, shape=consts.shape[:2],
                                    consts=torch.as_tensor(consts))
    train = interop.train_state_from_jax(params, jax.tree.map(np.asarray, opt.init(jp)),
                                         0, dtype=torch.float64, device="cpu")
    norms, global_norm = [], tppo.global_norm

    def recorded(grads, tp=None):
        n = global_norm(grads, tp)
        norms.append(float(n))
        return n

    monkeypatch.setattr(tppo, "global_norm", recorded)
    opt_state, stop, stats = tppo.run_ppo_update(
        cfg, train.model, train.opt_state, torch.as_tensor(log_std), lr32,
        tppo.Batch(**{k: torch.as_tensor(v) for k, v in b.items()}), perms)
    jout = (jparams, jstate[1], bool(jstop), {k: np.asarray(v) for k, v in jstats.items()})
    return cfg, (train.model, opt_state, stop, stats), jout, np.asarray(norms)


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_run_ppo_update_matches_jax_f64(case, monkeypatch):
    """The minibatch loop (JAX's masked carry: the KL exit and the clip decided on
    the device, the exit flag read once an epoch) against JAX's: no exit, an exit
    mid-epoch, on an epoch's last minibatch and on the very first, the clip taken
    on some minibatches and never, and two data shards."""
    cfg, (model, opt_state, stop, stats), jout, norms = update_both(case, monkeypatch)
    jparams, jadam, jstop, jstats = jout
    exit_at = UPDATE_CASES[case][3]
    assert stop == jstop
    np.testing.assert_array_equal(stats["computed"], jstats["computed"])
    np.testing.assert_array_equal(stats["applied"], jstats["applied"])
    kl = stats["approx_kl"][stats["computed"] > 0]
    assert np.all(np.abs(kl - cfg.kl_target) > 1e-5 * cfg.kl_target)
    n_done, applied = int(stats["computed"].sum()), int(stats["applied"].sum())
    total = cfg.update_epochs * cfg.num_minibatches
    if exit_at is None:
        assert not stop and n_done == applied == total
    else:
        assert stop and applied == n_done - 1
        assert tppo._last_computed(stats, "approx_kl") > cfg.kl_target
        if exit_at == "mid":
            assert 2 < n_done < total and n_done % cfg.num_minibatches
        else:
            assert (n_done, applied) == exit_at
    # the exit's epoch runs masked and the epochs after it are skipped: the loop
    # took the norm of every minibatch up to the end of the exit's epoch
    epochs_run = -(-n_done // cfg.num_minibatches)
    assert len(norms) == epochs_run * cfg.num_minibatches
    below = norms[:n_done] < cfg.max_grad_norm
    if case == "clip_some_minibatches":
        assert below.any() and not below.all()
    elif case == "clip_never":
        assert below.all()
    for k in tppo.STAT_NAMES:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert stats[k].dtype == np.float32 and stats[k].shape == jstats[k].shape
        assert not stats[k].reshape(-1)[n_done:].any(), k  # zeros past the exit
    assert np.float32(tppo._last_computed(stats, "pg_loss")) == np.float32(
        jppo._last_computed(jstats, "pg_loss"))
    assert opt_state.count == int(jadam.count) == applied
    got = list(model.parameters()) + opt_state.mu + opt_state.nu
    want = (jax.tree.leaves(jparams) + jax.tree.leaves(jadam.mu)
            + jax.tree.leaves(jadam.nu))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)
    # the update moved the parameters, where it applied a minibatch
    moved = not np.array_equal(next(model.parameters()).detach().numpy(),
                               _params(4)["actor"][0][0])
    assert moved == (applied > 0)


def test_train_state_round_trips_through_numpy():
    params = _params(6)
    opt = jppo.make_optimizer(jbase_config())
    state = opt.init(jax.tree.map(jnp.asarray, params))
    _, state = opt.update(jax.tree.map(jnp.ones_like, state[1].mu), state)
    train = interop.train_state_from_jax(params, jax.tree.map(np.asarray, state), 7,
                                         dtype=torch.float64, device="cpu")
    assert train.update == 7 and train.opt_state.count == 1
    p, adam, update = interop.train_state_to_numpy(train)
    assert update == 7 and adam["count"] == 1
    w0 = params["actor"][0][0].copy()
    with torch.no_grad():  # the port trains its own copies, never the caller's arrays
        next(train.model.parameters()).add_(1.0)
    np.testing.assert_array_equal(params["actor"][0][0], w0)
    np.testing.assert_array_equal(p["actor"][0][0], w0)
    back = optax.ScaleByAdamState(count=jnp.asarray(adam["count"]),
                                  mu=jax.tree.map(jnp.asarray, adam["mu"]),
                                  nu=jax.tree.map(jnp.asarray, adam["nu"]))
    assert jax.tree.structure(back) == jax.tree.structure(state[1])
    assert jax.tree.structure(p) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves((p, back)), jax.tree.leaves((params, state[1]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
