"""The PPO minibatch step's two kernels' plain versions (``ops/minibatch.py``) against
the JAX package, and transcriptions of the kernels' arithmetic against the plain
versions, on the CPU.

``ppo_head`` is the loss past the MLPs (the per-row log-prob, ratio, normalized
advantage, clipped surrogate and clipped value loss, then the means, the entropy
and the loss's sum) with its backward; ``adam_tail`` everything after the global norm
(the clip, Adam, the masked apply, the stats row and the loop's counters). On the
card each is one launch (two for the head), held to these plain versions there
(``tests/test_torch_cuda_kernels.py``, chip_smoke.py phase n): the gradients and
the tail bitwise, the head's sums within the stated tolerance of float64
(``tests/test_torch_loss_sums.py`` transcribes them). Here:

- ``_ppo_loss`` on given ``mu`` and ``v`` (the MLPs bypassed on both sides, so
  the head is what is compared) against jitted JAX ``_ppo_loss`` under
  ``value_and_grad``, on ``chip_smoke.crafted_minibatch``'s rows (the ratio clipped
  above, below and not, pg1 == pg2 ties, the value clipped, tied and at its old
  value); with the minibatch's own moments (``chip_smoke.flat_moments``, the
  table the update forms without a group), and with a group's (two halves normalized by the
  whole minibatch's moments, averaged, against JAX on the whole). float64: the loss and stats within rtol 1e-12 (and atol 1e-15), the
  gradients within rtol 1e-12 and atol 1e-15 (transcendentals and means round apart
  in XLA's and PyTorch's CPU math). float32: rtol 2e-6 and atol 1e-9 on the
  gradients (XLA's CPU jit contracts products into FMAs), rtol 1e-6 and atol 1e-7
  on the loss and stats (means of 512 float32 rows summed in other orders;
  approx_kl, a mean of terms that cancel, came 7.7e-9 apart). The clamp's bounds
  themselves are left out of these rows: there PyTorch passes the gradient and
  JAX's clip halves it.
- The plain tail against optax (``make_optimizer``, ``apply_updates``) over two
  applied steps, with the clip taken and not: float64 within rtol 1e-12, float32
  within rtol 2e-5 and atol 1e-8 (under conftest's x64 optax takes a float32
  step's bias corrections in float64, 1 - 0.999 = 0.001 against float32's
  0.0009999871, which moves each 2.5e-4 step by ~6.5e-6 of itself, 4.2e-9 over
  the two seen on parameters near 1e-4; the port's float32 table is optax's with
  x64 off, ``tests/test_torch_learner.py``); then a step masked by the KL exit and one after
  it move nothing, write the stats row as computed-not-applied and as zeros, and
  advance the counters as JAX's loop does.
- A PyTorch transcription of each kernel's per-element arithmetic in the kernel's
  order (``csrc/ppo_head.cu``, ``csrc/adam_tail.cu``), with the kernel's float32
  constants (``_head_constants``, ``_tail_constants``), held bitwise in float32 to
  the autograd and ``_foreach`` composition it replaces: it catches an order or a
  rounding mistake before the card does.
- Transcriptions of the kernels' reads: ``ppo_head``'s through the unit index (a
  ``UnitBatch``'s actions, old log-probs, advantages, returns and values read where
  the rollout's units hold them, the moments at the table's row), bitwise the plain
  composition on the gathered rows;
  ``adam_tail``'s cluster shares and tensor search, at the cluster shape its source
  sets, taking every element once. Then
  ``_ppo_loss`` on a ``UnitBatch`` bitwise on the gathered ``Batch`` and within the
  tolerances above of JAX, and whole CPU updates through the unit index bitwise the
  updates with every field gathered (``chip_smoke.gathered_minibatch_step``).
"""
import re
from pathlib import Path

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
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.models import actor_critic as tnet
from self_play_racing_tpu_torch.ops import minibatch as mbops
from self_play_racing_tpu_torch.ops import mlp as mlpops

ROWS = 512
STAT_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac")
TOL = {np.float64: dict(loss=1e-12, stat_atol=1e-15, grad_rtol=1e-12, grad_atol=1e-15),
       np.float32: dict(loss=1e-6, stat_atol=1e-7, grad_rtol=2e-6, grad_atol=1e-9)}


class _JaxHead:
    """The JAX loss's ``net`` with the MLPs bypassed: ``params`` holds ``mu`` and
    ``v`` themselves."""

    @staticmethod
    def evaluate_action(params, log_std, obs, action):
        lp = jnet.normal_log_prob(action, params["mu"], log_std)
        return lp, jnet.normal_entropy(log_std, params["mu"].shape[-1], lp.shape), params["v"]


class _PortHead:
    """The port loss's ``net`` with the MLPs bypassed, as ``_JaxHead``."""

    actor_mu = staticmethod(lambda params, obs: params["mu"])
    critic_value = staticmethod(lambda params, obs: params["v"])
    normal_entropy = staticmethod(tnet.normal_entropy)


def _jax_loss(case, rows, monkeypatch):
    monkeypatch.setattr(jppo, "net", _JaxHead)
    jcfg = jbase_config()
    fn = jax.jit(lambda p, ls, mb: jax.value_and_grad(jppo._ppo_loss, has_aux=True)(
        p, ls, mb, jcfg))
    mb = jppo.Batch(obs=jnp.zeros((len(rows), 1)), actions=jnp.asarray(case["actions"][rows]),
                    logprobs=jnp.asarray(case["logprobs"][rows]),
                    advantages=jnp.asarray(case["advantages"][rows]),
                    returns=jnp.asarray(case["returns"][rows]),
                    values=jnp.asarray(case["values"][rows]))
    (loss, st), grads = fn({"mu": jnp.asarray(case["mu"][rows]),
                            "v": jnp.asarray(case["v"][rows])},
                           jnp.asarray(case["log_std"]), mb)
    return float(loss), {k: float(st[k]) for k in STAT_KEYS}, np.asarray(grads["mu"]), \
        np.asarray(grads["v"])


def _port_loss(case, rows, monkeypatch, moments=None):
    """The port's ``_ppo_loss`` on ``rows`` of ``case``: (loss, stats by name, mu, v),
    the advantages normalized by ``moments`` ((table, row)), else by their own
    (``chip_smoke.flat_moments``)."""
    monkeypatch.setattr(tppo, "net", _PortHead)
    monkeypatch.setattr(mlpops, "net", _PortHead)
    mu = torch.tensor(case["mu"][rows], requires_grad=True)
    v = torch.tensor(case["v"][rows], requires_grad=True)
    mb = tppo.Batch(obs=torch.zeros((len(rows), 1)), **{k: torch.as_tensor(case[k][rows]) for k in
                                 ("actions", "logprobs", "advantages", "returns", "values")})
    moments = chip_smoke.flat_moments(mb.advantages) if moments is None else moments
    loss, st = tppo._ppo_loss({"mu": mu, "v": v}, torch.as_tensor(case["log_std"]), mb,
                              base_config(), *moments)
    return loss, dict(zip(STAT_KEYS, st)), mu, v


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_head_matches_jax_with_the_minibatchs_own_moments(dtype, monkeypatch):
    case = chip_smoke.crafted_minibatch(ROWS, np.random.default_rng(1), dtype,
                                        boundaries=False)
    rows = np.arange(ROWS)
    jloss, jst, jg_mu, jg_v = _jax_loss(case, rows, monkeypatch)
    loss, st, mu, v = _port_loss(case, rows, monkeypatch)
    g_mu, g_v = torch.autograd.grad(loss, (mu, v))
    tol = TOL[dtype]
    np.testing.assert_allclose(loss.item(), jloss, rtol=tol["loss"])
    for k in STAT_KEYS:
        np.testing.assert_allclose(st[k].item(), jst[k], rtol=tol["loss"],
                                   atol=tol["stat_atol"], err_msg=k)
    assert 0.2 < st["clip_frac"].item() < 0.4  # rows of kinds 1 and 2 clip: 2 of 8
    np.testing.assert_allclose(g_mu.numpy(), jg_mu, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])
    np.testing.assert_allclose(g_v.numpy(), jg_v, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])
    assert mbops.ppo_head_launches == mbops.ppo_head_backward_launches == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_head_matches_jax_with_a_groups_moments(dtype, monkeypatch):
    """Each half of the minibatch normalized by the whole minibatch's moments (what
    a rank of two gets from ``advantage_moments``), the halves' losses averaged (the
    group's mean): JAX's loss and gradients on the whole."""
    case = chip_smoke.crafted_minibatch(ROWS, np.random.default_rng(2), dtype,
                                        boundaries=False)
    everything = np.arange(ROWS)
    jloss, jst, jg_mu, jg_v = _jax_loss(case, everything, monkeypatch)
    moments = chip_smoke.flat_moments(torch.as_tensor(case["advantages"]))
    halves = [_port_loss(case, h, monkeypatch, moments) for h in np.split(everything, 2)]
    loss = (halves[0][0] + halves[1][0]) / 2
    grads = torch.autograd.grad(loss, [h[2] for h in halves] + [h[3] for h in halves])
    tol = TOL[dtype]
    np.testing.assert_allclose(loss.item(), jloss, rtol=tol["loss"])
    for k in STAT_KEYS:
        got = (halves[0][1][k].item() + halves[1][1][k].item()) / 2
        np.testing.assert_allclose(got, jst[k], rtol=tol["loss"], atol=tol["stat_atol"],
                                   err_msg=k)
    np.testing.assert_allclose(torch.cat(grads[:2]).numpy(), jg_mu, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])
    np.testing.assert_allclose(torch.cat(grads[2:]).numpy(), jg_v, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])


def test_crafted_rows_take_every_branch():
    case = chip_smoke.crafted_minibatch(ROWS, np.random.default_rng(3))
    t = chip_smoke.head_tensors(case, "cpu")
    neg_log_ratio, pg_max, v_max, clipped = mbops.ppo_head_plain(
        *(t[k] for k in chip_smoke.ROW_ARGS), chip_smoke.HEAD_CLIP)
    kind = np.arange(ROWS) % chip_smoke.HEAD_ROW_KINDS
    ratio = torch.exp(-neg_log_ratio).detach().numpy()
    lo, hi = np.float32(0.8), np.float32(1.2)
    assert (ratio[kind == 1] > hi).all() and (ratio[kind == 2] < lo).all()
    assert ((ratio[kind == 0] > lo) & (ratio[kind == 0] < hi)).all()
    assert clipped.sum().item() == (kind == 1).sum() + (kind == 2).sum()
    adv = ((t["advantages"] - t["mean"]) / (t["std"] + 1e-8)).numpy()
    assert (adv[kind == 3] == 0).all()
    dv = (t["v"] - t["values"]).detach().numpy()
    assert (np.abs(dv[kind == 4]) > 0.2).all() and (dv[kind == 6] == 0).all()
    assert (np.abs(dv[kind == 7]) == np.float32(0.2)).all()  # at the clamp's bounds
    e1 = (t["v"] - t["returns"]).detach().numpy()[kind == 5]
    v_clip = (t["values"] + (t["v"] - t["values"]).clamp(-0.2, 0.2)).detach().numpy()
    assert (v_clip[kind == 5] - t["returns"].numpy()[kind == 5] == e1).all()  # a tie


ROW_OUTPUTS = chip_smoke.HEAD_ROW_VALUES + ("d/d mu", "d/d v")


def _head_model(mu, v, actions, old_lp, adv_raw, returns, values, log_std, mean, std,
                gp, gv, constants):
    """``csrc/ppo_head.cu``'s per-row forward and backward, operation by operation in
    its order, in float32 PyTorch: the four per-row values its sums take and d/d mu,
    d/d v from the maxima's upstream gradients ``gp``, ``gv``."""
    lo, hi, neg_clip, clip, half_log_2pi, adv_eps = (torch.tensor(c) for c in constants[:6])
    clamp = lambda x, a, b: torch.where(torch.isnan(x), x, torch.minimum(torch.maximum(x, a), b))
    max_nan = lambda a, b: torch.where(a != a, a, torch.where(b != b, b, torch.maximum(a, b)))
    den = 2.0 * torch.exp(2.0 * log_std)
    d = actions - mu
    lp2 = ((-(d * d)) / den - log_std) - half_log_2pi
    lp = (lp2[:, 0] + lp2[:, 1]) + 0.0
    log_ratio = lp - old_lp
    ratio = torch.exp(log_ratio)
    nadv = -((adv_raw - mean) / (std + adv_eps))
    pg1, pg2 = nadv * ratio, nadv * clamp(ratio, lo, hi)
    dv = v - values
    v_clip = values + clamp(dv, neg_clip, clip)
    e1, e2 = v - returns, v_clip - returns
    s1, s2 = e1 * e1, e2 * e2
    outputs = (-log_ratio, max_nan(pg1, pg2), max_nan(s1, s2),
               torch.where((ratio - 1.0).abs() > clip, 1.0, 0.0))

    def max_backward(x, y, g):
        h = torch.where(x == y, g * 0.5, g)
        return torch.where(x < y, 0.0, h), torch.where(x > y, 0.0, h)

    g1, g2 = max_backward(pg1, pg2, gp)
    g_ratio = g1 * nadv + torch.where((ratio >= lo) & (ratio <= hi), g2 * nadv, 0.0)
    g_log_ratio = g_ratio * ratio
    g_mu = -((-(g_log_ratio[:, None] / den)) * (d * 2.0))
    gs1, gs2 = max_backward(s1, s2, gv)
    g_e2 = gs2 * (e2 * 2.0)
    g_v = gs1 * (e1 * 2.0) + torch.where((dv >= neg_clip) & (dv <= clip), g_e2, 0.0)
    return outputs + (g_mu, g_v)


@pytest.mark.parametrize("rows", [ROWS, 1])
def test_head_transcription_is_the_plain_composition_bitwise(rows):
    """The kernel's order of operations, transcribed, against ``ppo_head_plain`` and
    autograd's backward in float32: every output and gradient bitwise, with random
    upstream gradients and with tied ones (one value for every row, as the means'
    backward hands them)."""
    t = chip_smoke.head_tensors(chip_smoke.crafted_minibatch(rows, np.random.default_rng(4)),
                                "cpu")
    g = torch.Generator().manual_seed(rows)
    for gp, gv in ((torch.randn(rows, generator=g), torch.randn(rows, generator=g)),
                   (torch.full((rows,), 1.0 / rows), torch.full((rows,), 0.5 / rows))):
        plain = mbops.ppo_head_plain(*(t[k] for k in chip_smoke.ROW_ARGS),
                                     chip_smoke.HEAD_CLIP)
        grads = torch.autograd.grad(plain[1:3], (t["mu"], t["v"]), (gp, gv))
        model = _head_model(*(t[k].detach() for k in chip_smoke.ROW_ARGS), gp, gv,
                            mbops._head_constants(*chip_smoke.HEAD_COEFS))
        for name, a, b in zip(ROW_OUTPUTS, model, list(plain) + list(grads)):
            assert chip_smoke.same_bits(a, b.detach()), name


def _tail_model(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, i, applied, stop,
                constants):
    """``csrc/adam_tail.cu``'s arithmetic in its order, in float32 PyTorch, with its
    float32 constants: (params, mu, nu, stats row, i, applied, stop) after the step."""
    max_norm, kl_target, b1, one_minus_b1, b2, one_minus_b2, eps = (
        torch.tensor(c, dtype=torch.float32) for c in constants)
    trig = bool(stats[4] > kl_target)
    active = not stop
    apply = active and not trig
    row = torch.stack([s if active else torch.zeros(()) for s in stats]
                      + [torch.tensor(float(apply)), torch.tensor(float(active))])
    if not apply:
        return params, mu, nu, row, i + 1, applied, stop or (active and trig)
    c1, c2, neg_lr = bc1[applied], bc2[applied], -lr
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        gc = g if bool(g_norm < max_norm) else (g / g_norm) * max_norm
        m = gc * one_minus_b1 + m * b1
        v = (gc * gc) * one_minus_b2 + v * b2
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        new_p.append(p + u * neg_lr)
        new_mu.append(m)
        new_nu.append(v)
    return new_p, new_mu, new_nu, row, i + 1, applied + 1, False


@pytest.mark.parametrize("case", sorted(chip_smoke.TAIL_CASES))
def test_tail_transcription_is_the_plain_composition_bitwise(case):
    kl, stop, scale = chip_smoke.TAIL_CASES[case]
    params, grads, mu, nu, bc1, bc2, loop = chip_smoke.tail_state("cpu", 9)
    grads = [g * scale for g in grads]
    g_norm = tppo.global_norm(grads)
    stats = chip_smoke.tail_stats(kl, "cpu")
    lr = torch.tensor(2.5e-4)
    loop.i.fill_(3)
    loop.applied.fill_(2)
    loop.stop.fill_(stop)
    want = _tail_model([p.clone() for p in params], grads, [m.clone() for m in mu],
                       [v.clone() for v in nu], g_norm, stats, bc1, bc2, lr, 3, 2, stop,
                       mbops._tail_constants(0.5, 0.02))
    mbops.adam_tail(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop, 0.5, 0.02)
    assert mbops.adam_tail_launches == 0  # CPU tensors take the plain version
    for got, w in zip(params + mu + nu, want[0] + want[1] + want[2]):
        assert chip_smoke.same_bits(got, w)
    assert chip_smoke.same_bits(loop.stats[3], want[3])
    assert (int(loop.i), int(loop.applied), bool(loop.stop)) == want[4:]
    assert (g_norm > 0.5).item() == (scale > 1)  # the clip taken where scaled up


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-12, 1e-18),
                                             (np.float32, 2e-5, 1e-8)])
@pytest.mark.parametrize("scale", [1.0, 100.0])  # global norm below / above max_norm
def test_plain_tail_matches_optax_and_the_exit(dtype, rtol, atol, scale):
    cfg, jcfg = base_config(), jbase_config()
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    params, grads, _, _, _, _, _ = chip_smoke.tail_state("cpu", 10, hidden=(16, 16),
                                                         obs_dim=15)
    params = [p.to(tdtype) for p in params]
    steps = [[(g * scale * (0.7 + 0.6 * k)).to(tdtype) for g in grads] for k in range(2)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    loop = tppo.MinibatchLoop.zeros(4, "cpu")
    bc1, bc2 = (torch.as_tensor(tppo.bias_correction_table(b, 0, 4, tdtype))
                for b in (tppo.ADAM_B1, tppo.ADAM_B2))
    lr_value = np.float32(2.5e-4)
    lr = torch.tensor(float(lr_value), dtype=tdtype)

    def tail(gs, kl):
        stats = chip_smoke.tail_stats(kl, "cpu", tdtype)
        mbops.adam_tail(params, gs, mu, nu, tppo.global_norm(gs), stats, bc1, bc2, lr, loop,
                        cfg.max_grad_norm, cfg.kl_target)

    opt = jppo.make_optimizer(jcfg)
    jp = [jnp.asarray(p.numpy().copy()) for p in params]  # not sharing what the tail writes
    state = opt.init(jp)
    update = jax.jit(opt.update)
    for k, gs in enumerate(steps):
        tail(gs, 0.001)
        upd, state = update([jnp.asarray(g.numpy()) for g in gs], state)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -jnp.asarray(lr_value, dtype) * u,
                                                  upd))
        for got, want in zip(params + mu + nu,
                             list(jp) + list(state[1].mu) + list(state[1].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
        assert (int(loop.i), int(loop.applied), bool(loop.stop)) == (k + 1, k + 1, False)
    assert ((tppo.global_norm(steps[0]) >= cfg.max_grad_norm).item()) == (scale > 1)
    # the KL exit: the triggering step is computed and not applied, the next masked
    frozen = [t.clone() for t in params + mu + nu]
    tail(steps[0], 0.5)
    assert (int(loop.i), int(loop.applied), bool(loop.stop)) == (3, 2, True)
    assert loop.stats[2, 6:].tolist() == [0.0, 1.0] and loop.stats[2, 4].item() == 0.5
    tail(steps[1], 0.001)
    assert (int(loop.i), int(loop.applied), bool(loop.stop)) == (4, 2, True)
    assert loop.stats[3].tolist() == [0.0] * 8
    assert all(torch.equal(a, b) for a, b in zip(params + mu + nu, frozen))
    assert loop.stats[:2, 6:].tolist() == [[1.0, 1.0]] * 2


def test_loaded_adam_moments_are_laid_out_as_the_parameters():
    """The reference's ``.pth`` holds its Adam moments (out, in); the port loads them
    transposed, and contiguous, as ``adam_tail``'s kernel takes them (and as each
    parameter is laid out), with the values the transpose gives."""
    from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
    from self_play_racing_tpu_torch.configs import self_play_config
    from self_play_racing_tpu_torch.envs import multi as tmulti
    from self_play_racing_tpu_torch.envs import track as ttrack

    pth = "models/reference_selfplay_checkpoint_update_90.pth"
    pool = ttrack.make_track_pool(ttrack.gen_tracks(2, seed=1), 3.5, device="cpu")
    tr = SelfPlayTrainer(self_play_config(num_envs=4, num_steps=32),
                         tmulti.MultiRacingConfig(), ttrack.gather_tracks(pool, [0, 1, 0, 1]))
    tr.load_torch_checkpoint(pth)
    ck = torch.load(pth, map_location="cpu", weights_only=False)["optimizer_state_dict"]
    order = ck["param_groups"][0]["params"]
    opt = tr.runner.train.opt_state
    for i, p, m, v in zip(order, tr.runner.train.model.parameters(), opt.mu, opt.nu):
        assert m.is_contiguous() and v.is_contiguous() and m.shape == v.shape == p.shape
        want = ck["state"][i]["exp_avg"].to(m.dtype)
        np.testing.assert_array_equal(m.numpy(), (want.T if want.ndim == 2 else want).numpy())


# ------------------- the redesigned kernels' reads: the unit index, the cluster's shares

# (rows a unit, unit ids): whole units, units of 3 (an odd row count), one-row units,
# one unit, every unit in order
UNIT_CASES = [(64, [5, 0, 3]), (3, [2, 7, 7, 1, 0]), (1, [4, 9, 2]), (16, [9]),
              (5, list(range(10)))]


def _upstream(n: int, coefs=chip_smoke.HEAD_COEFS):
    """The upstream gradients autograd hands the head's two maxima from the loss on
    the CPU: the loss's gradient 1 through ``_ppo_loss``'s sum, products and means."""
    _, ent_coef, vf_coef = coefs
    pg_max, v_max = (torch.zeros(n, requires_grad=True) for _ in range(2))
    loss = pg_max.mean() + ent_coef * -torch.ones(()) + vf_coef * (0.5 * v_max.mean())
    return torch.autograd.grad(loss, (pg_max, v_max))


@pytest.mark.parametrize("block,ids", UNIT_CASES)
def test_head_reads_through_the_unit_index_are_the_plain_composition_bitwise(block, ids):
    """``csrc/ppo_head.cu``'s thread for minibatch row r reads the actions, old
    log-probs, advantages, returns and old values at unit ``ids[r // block]``, offset
    ``r % block`` (``load_row``), and the moments at row ``at`` of the table; the
    kernel's per-row arithmetic (``_head_model``) on those reads, from the upstream
    gradients the loss's backward hands the maxima, is bitwise ``ppo_head`` through the
    index on the CPU, which gathers (``gather_units``) and runs the plain composition:
    d/d mu and d/d v, and the stats are the means of the model's rows."""
    n_units = 10
    t = chip_smoke.unit_head_tensors(n_units, block, ids, np.random.default_rng(block), "cpu")
    unit_ids = t["unit_ids"]
    n = len(ids) * block
    r = np.arange(n)
    src = torch.as_tensor(unit_ids.numpy()[r // block] * block + r % block)
    read = {k: t[k].reshape((n_units * block,) + t[k].shape[2:])[src]
            for k in ("actions", "logprobs", "advantages", "returns", "values")}
    for k, x in read.items():
        assert torch.equal(x, mbops.gather_units(t[k], unit_ids)), k
    mean, std = t["moments"][int(t["at"])]
    assert torch.equal(mean, t["mean"]) and torch.equal(std, t["std"])
    loss, stats = mbops.ppo_head(*(t[k] for k in chip_smoke.HEAD_ARGS), *chip_smoke.HEAD_COEFS,
                                 unit_ids)
    g_mu, g_v = torch.autograd.grad(loss, (t["mu"], t["v"]))
    model = _head_model(t["mu"].detach(), t["v"].detach(), read["actions"], read["logprobs"],
                        read["advantages"], read["returns"], read["values"], t["log_std"],
                        mean, std, *_upstream(n), mbops._head_constants(*chip_smoke.HEAD_COEFS))
    assert chip_smoke.same_bits(model[4], g_mu) and chip_smoke.same_bits(model[5], g_v)
    kl, pg, vm, clipped = (x.mean() for x in model[:4])
    for got, want in ((stats[4], kl), (stats[1], pg), (stats[2], 0.5 * vm), (stats[5], clipped),
                      (stats[0], loss.detach())):
        assert chip_smoke.same_bits(got, want)
    assert mbops.ppo_head_launches == mbops.ppo_head_backward_launches == 0


def _tail_shape():
    """(blocks of the cluster, threads a block, elements a thread loads at a time):
    ``csrc/adam_tail.cu``'s kCluster, kThreads and kBatch, read from the source."""
    src = (Path(__file__).resolve().parents[1] / "self_play_racing_tpu_torch" / "csrc"
           / "adam_tail.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kCluster", "kThreads", "kBatch"))


def _tail_walk(sizes):
    """(tensor, offset) of every flat element as ``csrc/adam_tail.cu``'s cluster
    takes them: block k of the cluster a contiguous share ceil(total / cluster) of the
    flat range, its threads ``batch`` elements at a stride of the block a pass, each
    element's tensor the last with start <= e (``tensor_of``'s binary search)."""
    cluster, threads, batch = _tail_shape()
    start = np.concatenate([[0], np.cumsum(sizes)])
    count, total = len(sizes), int(start[-1])
    share = -(-total // cluster)
    seen = []
    for rank in range(cluster):
        lo, hi = share * rank, min(share * rank + share, total)
        for tid in range(threads):
            for base in range(lo + tid, hi, batch * threads):
                for k in range(batch):
                    e = base + k * threads
                    if e >= hi:
                        continue
                    a, b = 0, count
                    while b - a > 1:
                        mid = (a + b) // 2
                        a, b = (mid, b) if start[mid] <= e else (a, mid)
                    seen.append((a, e - int(start[a])))
    return seen


@pytest.mark.parametrize("which", ["the (64, 64) policy", "one tensor", "32 with empty ones",
                                   "a total that straddles the shares",
                                   "fewer elements than blocks", "several passes a block"])
def test_tail_walk_takes_every_element_once(which):
    """The cluster's walk over the flat element range takes every element of every
    tensor exactly once: empty tensors, shares that end inside a tensor, blocks with
    no share and blocks that take several passes included."""
    cluster, threads, batch = _tail_shape()
    params = chip_smoke.tail_state("cpu", 1)[0]
    sizes = {"the (64, 64) policy": [p.numel() for p in params],
             "one tensor": [1],
             "32 with empty ones": [(k * 37) % 50 if k % 5 else 0 for k in range(32)],
             "a total that straddles the shares": [cluster * 97 + 3, 1, 2 * cluster + 5],
             "fewer elements than blocks": [3, 0, 2],
             "several passes a block": [cluster * threads * batch * 2 + 7, 5]}[which]
    seen = _tail_walk(sizes)
    want = [(t, i) for t, size in enumerate(sizes) for i in range(size)]
    assert sorted(seen) == want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loss_through_the_unit_index_is_the_gathered_loss(dtype, monkeypatch):
    """``_ppo_loss`` on a ``UnitBatch`` (what ``minibatch_step`` hands it: every field
    as the rollout's units, with the minibatch's unit ids, and the update's moments
    table, ``advantage_moments``) is bitwise ``_ppo_loss`` on the gathered ``Batch``
    with its own moments, loss, stats and gradients, and within the file's
    tolerances JAX's ``_ppo_loss`` on the gathered rows."""
    block, n_units = 16, 64
    unit_ids = torch.tensor([9, 3, 60, 3, 17, 0, 41, 22], dtype=torch.int64)
    case = chip_smoke.crafted_minibatch(block * n_units, np.random.default_rng(5), dtype,
                                        boundaries=False)
    units = {k: torch.as_tensor(case[k]).reshape((n_units, block) + case[k].shape[1:])
             for k in ("actions", "logprobs", "advantages", "returns", "values")}
    rows = (unit_ids[:, None] * block + torch.arange(block)).reshape(-1).numpy()
    gathered = _port_loss(case, rows, monkeypatch)
    mu = torch.tensor(case["mu"][rows], requires_grad=True)
    v = torch.tensor(case["v"][rows], requires_grad=True)
    mb = tppo.UnitBatch(obs=torch.zeros((n_units, block, 1)), **units, rows=unit_ids)
    moments = tppo.advantage_moments(base_config(), mb, unit_ids[None])
    loss, st = tppo._ppo_loss({"mu": mu, "v": v}, torch.as_tensor(case["log_std"]), mb,
                              base_config(), moments, torch.zeros((1,), dtype=torch.int64))
    st = dict(zip(STAT_KEYS, st))
    g_mu, g_v = torch.autograd.grad(loss, (mu, v))
    w_mu, w_v = torch.autograd.grad(gathered[0], (gathered[2], gathered[3]))
    assert chip_smoke.same_bits(loss, gathered[0])
    assert all(chip_smoke.same_bits(st[k], gathered[1][k]) for k in STAT_KEYS)
    assert chip_smoke.same_bits(g_mu, w_mu) and chip_smoke.same_bits(g_v, w_v)
    jloss, jst, jg_mu, jg_v = _jax_loss(case, rows, monkeypatch)
    tol = TOL[dtype]
    np.testing.assert_allclose(loss.item(), jloss, rtol=tol["loss"])
    for k in STAT_KEYS:
        np.testing.assert_allclose(st[k].item(), jst[k], rtol=tol["loss"],
                                   atol=tol["stat_atol"], err_msg=k)
    np.testing.assert_allclose(g_mu.numpy(), jg_mu, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])
    np.testing.assert_allclose(g_v.numpy(), jg_v, rtol=tol["grad_rtol"],
                               atol=tol["grad_atol"])


@pytest.mark.parametrize("data_shards", [1, 2])
def test_update_through_the_unit_index_is_the_gathered_update(data_shards, monkeypatch):
    """A whole CPU update (4 epochs x 4 minibatches, no KL exit) through
    ``minibatch_step``'s unit index is bitwise the same update with every field
    gathered (``chip_smoke.gathered_minibatch_step``): parameters, Adam moments and
    every stat."""
    cfg = base_config(num_envs=32, num_steps=16, num_minibatches=4, update_epochs=4,
                      shuffle_block_size=8, data_shards=data_shards, kl_target=float("inf"))
    assert tppo.minibatch_layout(cfg)[0] == 8

    def update():
        gen = torch.Generator().manual_seed(3)
        train = tppo.init_train_state(gen, cfg, 19, 2)
        b = cfg.batch_size
        rnd = lambda *shape, s=1.0: torch.randn(shape, generator=gen) * s
        obs = rnd(b, 19)
        with torch.no_grad():
            mu, v = train.model(obs)
            actions = (mu + 0.6 * rnd(b, 2)).clamp(-1, 1)
            lp = tnet.normal_log_prob(actions, mu, torch.full((2,), -0.5))
        flat = tppo.Batch(obs, actions, lp + rnd(b, s=0.05), rnd(b, s=2.0), v + rnd(b), v)
        _, n_units, _ = tppo.minibatch_layout(cfg)
        perms = torch.stack([torch.stack([torch.randperm(n_units, generator=gen)
                                          for _ in range(data_shards)])
                             for _ in range(cfg.update_epochs)])
        opt, stopped, stats = tppo.run_ppo_update(cfg, train.model, train.opt_state,
                                                  torch.full((2,), -0.5), 2.5e-4, flat, perms)
        return list(train.model.parameters()) + opt.mu + opt.nu, stopped, stats

    got = update()
    with monkeypatch.context() as m:
        m.setattr(tppo, "minibatch_step", chip_smoke.gathered_minibatch_step)
        want = update()
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == want[1]
    assert all(np.array_equal(got[2][k], want[2][k]) for k in tppo.STAT_NAMES)
    assert got[2]["applied"].sum() == cfg.update_epochs * cfg.num_minibatches
