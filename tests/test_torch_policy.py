"""The port's actor-critic, weight loading and obs normalizer against the JAX
package's, on the CPU.

Tolerances: loaded parameters are exact (the same float32 arrays). Network outputs
in float64 match within rtol 1e-12 (matrix products sum in another order, and tanh
rounds differently in XLA's and PyTorch's CPU math); in float32 within rtol 1e-5,
atol 1e-6. Log-probs and clamped samples from one shared noise array follow the
same bounds. The normalizer in float64 matches within rtol 1e-12 (the batch mean
and variance sum in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import normalize as jnorm
from self_play_racing_tpu.evaluate import load_policy_bundle as jload
from self_play_racing_tpu.models import actor_critic as jnet
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.envs import normalize as tnorm
from self_play_racing_tpu_torch.evaluate import load_policy_bundle as tload
from self_play_racing_tpu_torch.models import actor_critic as tnet

MODEL = "models/single_agent.npz"
PTH = "models/reference_selfplay_checkpoint_update_90.pth"
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=1e-5, atol=1e-6)}


def _leaves_equal(jparams, tparams):
    jl = jax.tree.leaves(jparams)
    tl = [a for tower in ("actor", "critic") for layer in tparams[tower] for a in layer]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))


def test_load_npz_matches_jax_loader():
    jp, jls, jnorm_state = jload(MODEL)
    model, obs_norm = interop.load_npz(MODEL, device="cpu")
    assert jnorm_state is None and obs_norm is None
    _leaves_equal(jp, model.params())
    np.testing.assert_array_equal(model.log_std.numpy(), np.asarray(jls))
    tp, tls, _ = tload(MODEL, device="cpu")
    _leaves_equal(jp, tp)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_network_outputs_match(dtype):
    jp, jls, _ = jload(MODEL)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), jp)
    jls = jnp.asarray(jls, dtype)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jp), np.asarray(jls),
                                    dtype=torch.float64 if dtype == np.float64 else torch.float32,
                                    device="cpu")
    tp = model.params()
    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1.5, (64, 15)).astype(np.float32)
    noise = rng.standard_normal((64, 2)).astype(dtype)
    tol = TOL[dtype]
    with torch.no_grad():
        tmu, tval = model(torch.from_numpy(obs))
        jmu = np.asarray(jnet.actor_mu(jp, jnp.asarray(obs)))
        np.testing.assert_allclose(tmu.numpy(), jmu, **tol)
        jval = np.asarray(jnet.critic_value(jp, jnp.asarray(obs)))
        np.testing.assert_allclose(tval.numpy(), jval, **tol)
        np.testing.assert_allclose(tnet.deterministic_action(tp, torch.from_numpy(obs)).numpy(),
                                   jmu, **tol)
        # JAX's sample_action draws its own noise: compare against its parts
        ta, tlp, tv = tnet.sample_action(tp, model.log_std, torch.from_numpy(obs),
                                         torch.from_numpy(noise))
        ja = np.clip(jmu + np.exp(np.asarray(jls)) * noise, -1.0, 1.0)
        np.testing.assert_allclose(ta.numpy(), ja, **tol)
        assert np.abs(ta.numpy()).max() <= 1.0
        np.testing.assert_allclose(
            tlp.numpy(), np.asarray(jnet.normal_log_prob(jnp.asarray(ja), jnp.asarray(jmu), jls)),
            **tol)
        np.testing.assert_allclose(tv.numpy(), jval, **tol)
        np.testing.assert_allclose(tnet.normal_entropy(model.log_std, 2, (64,)).numpy(),
                                   np.asarray(jnet.normal_entropy(jls, 2, (64,))), **tol)


def test_pth_checkpoint_matches_jax_conversion():
    ckpt = torch.load(PTH, map_location="cpu")
    jp, jls = jnet.params_from_torch_state_dict(ckpt["agent_state_dict"])
    tp, tls = tnet.params_from_torch_state_dict(ckpt["agent_state_dict"])
    _leaves_equal(jp, tp)
    np.testing.assert_array_equal(tls.numpy(), np.asarray(jls))
    # the port also reads the full training checkpoint, by path
    tp2, tls2, _ = tload(PTH, device="cpu")
    _leaves_equal(jp, tp2)
    np.testing.assert_array_equal(tls2.numpy(), np.asarray(jls))


def test_params_from_jax_round_trip():
    jp = jnet.init_params(jax.random.key(3), 15, 2, dtype=jnp.float32, hidden=(32, 16, 8))
    jls = np.full((2,), -0.7, np.float32)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jp), jls, device="cpu")
    _leaves_equal(jp, model.params())
    flat = interop.params_from_jax([np.asarray(a) for a in jax.tree.leaves(jp)], jls,
                                   device="cpu")
    _leaves_equal(jp, flat.params())
    sd = tnet.params_to_torch_state_dict(model.params(), model.log_std)
    jback, jls_back = jnet.params_from_torch_state_dict(sd)
    _leaves_equal(jback, model.params())
    np.testing.assert_array_equal(np.asarray(jls_back), jls)
    tback, _ = tnet.params_from_torch_state_dict(sd)
    _leaves_equal(jp, tback)


def test_init_params_orthogonal_layout():
    gen = torch.Generator().manual_seed(0)
    p = tnet.init_params(gen, 15, 2)
    shapes = [tuple(w.shape) for w, _ in p["actor"]] + [tuple(w.shape) for w, _ in p["critic"]]
    assert shapes == [(15, 64), (64, 64), (64, 2), (15, 64), (64, 64), (64, 1)]
    w = p["actor"][1][0]
    np.testing.assert_allclose((w.T @ w / 2.0).numpy(), np.eye(64), atol=1e-5)  # gain sqrt(2)
    assert all(float(b.abs().max()) == 0 for _, b in p["actor"] + p["critic"])
    assert float(p["actor"][2][0].norm(dim=0).max()) == pytest.approx(0.01, rel=1e-4)


def test_npz_obs_norm_and_normalizer_match(tmp_path):
    rng = np.random.default_rng(4)
    jstate = jnorm.init(15, jnp.float64)
    tstate = tnorm.init(15, torch.float64)
    for _ in range(3):
        obs = rng.normal(0.5, 2.0, (64, 15))
        jstate = jnorm.update(jstate, jnp.asarray(obs))
        tstate = tnorm.update(tstate, torch.from_numpy(obs))
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tstate, k).numpy(), np.asarray(getattr(jstate, k)),
                                   rtol=1e-12)
    obs = rng.normal(0.5, 30.0, (16, 15))  # some clip at +-10
    np.testing.assert_allclose(tnorm.apply(tstate, torch.from_numpy(obs)).numpy(),
                               np.asarray(jnorm.apply(jstate, jnp.asarray(obs))), rtol=1e-12)

    data = dict(np.load(MODEL))
    data.update(obs_mean=np.asarray(jstate.mean, np.float32),
                obs_var=np.asarray(jstate.var, np.float32),
                obs_count=np.asarray(jstate.count, np.float32))
    path = str(tmp_path / "normed.npz")
    np.savez(path, **data)
    _, _, jn = jload(path)
    _, obs_norm = interop.load_npz(path, device="cpu")
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(obs_norm, k).numpy(), np.asarray(getattr(jn, k)))
