"""The port's tensor-parallel towers (``parallel/mesh.py``'s ``TensorMesh`` and
``param_shardings``, ``models/actor_critic.py``'s Megatron operators) against the
JAX package's layout and its unsharded update, on the CPU, at tests/test_parallel.py's
tensor-parallel config (16 envs x 32 steps, 4 minibatches, 2 epochs, towers of
(128, 128)).

- ``param_shardings`` names JAX's split of every leaf at hidden (64, 64),
  (128, 128), (128, 128, 128) and (90, 64) (90 does not divide by 4: JAX's
  replicated fallback) for m = 2 and 4, JAX's specs taken on conftest's 8 virtual
  CPU devices.
- One update, then a second from the carried sharded state, over 2 gloo processes
  (data 1 x model 2) and over 4 (data 2 x model 2), fed JAX's draws in float64:
  each rank holds its slices (actor[0].w [15, 64], actor[1].w [64, 128], the
  Adam moments alike), ``gather_params`` of ``shard_params`` is the whole tree
  bitwise, the ranks' gathered states are bitwise alike, and they agree
  with the one-process unsharded update to rtol 1e-9 / atol 1e-12 (the partial
  products are summed in another order; the metric vector to rtol 1e-6 / atol
  1e-7 and minibatches_applied exactly). The one-process update agrees with JAX's
  unsharded update to tests/test_torch_parallel.py's tolerances (parameters and
  Adam moments rtol 1e-6 / atol 1e-7, metrics rtol 1e-5 / atol 1e-6: XLA's and
  PyTorch's CPU math round tanh and exp differently), and so the sharded ranks
  too. JAX's own sharded run is held to its unsharded one at 2e-5
  (tests/test_parallel.py).
- A self-play update over 2 processes (float32, one snapshot): the pool slot is
  the whole parameters, gathered, bitwise; they agree with one process's to 1e-6
  absolute (float32). Its checkpoint and ``.npz`` policy, written by process 0,
  load into an unsharded port trainer and into JAX's ``load_policy_bundle``.
- ``make_mesh`` raises where the model axis does not divide the world.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.trainer import make_single_env_hooks as jhooks
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.evaluate import load_policy_bundle as jload_policy_bundle
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.parallel import mesh as jmesh
from test_torch_dist_workers import (SingleBuild, run_ranks, tp_selfplay, tp_selfplay_rank,
                                     tp_selfplay_trainer, tp_update_rank, tp_updates)
from test_torch_parallel import _numpy_train, _tracks
from test_torch_trainer import _jax_draws
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.parallel import mesh as pmesh

N, T = 16, 32
TP = dict(num_envs=N, num_steps=T, num_minibatches=4, update_epochs=2,
          total_timesteps=N * T * 4, hidden=(128, 128))
TIMEOUT = 180  # seconds for a multi-process run (each child: import, build, updates)


def _close_trees(got, want, rtol, atol=0.0):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


def _dims_of(sharding, ndim):
    """The dimension a JAX NamedSharding splits over 'model', or None."""
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("hidden", [(64, 64), (128, 128), (128, 128, 128), (90, 64)])
@pytest.mark.parametrize("m", [2, 4])
def test_param_shardings_match_jax(hidden, m):
    params = jnet.init_params(jax.random.key(0), 19, 2, hidden=hidden)
    jspecs = jmesh.param_shardings(params, jmesh.make_mesh(jax.devices()[:8],
                                                           model_parallel=m))
    tparams = {k: [(torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(b)))
                   for w, b in layers] for k, layers in params.items()}
    mesh = pmesh.TensorMesh(world=8 // m, rank=0, device=torch.device("cpu"), group=None,
                            model_parallel=m, model_rank=0, model_group=None,
                            process_rank=0, all_group=None)
    got = pmesh.param_shardings(tparams, mesh)
    want = {k: [(_dims_of(ws, 2), _dims_of(bs, 1)) for ws, bs in layers]
            for k, layers in jspecs.items()}
    assert got == want
    # every hidden width m divides is split in the first layer; the heads never
    # split their outputs
    for k, layers in got.items():
        assert layers[0] == ((1, 0) if hidden[0] % m == 0 else (None, None))
        assert layers[-1][1] is None
    # a data mesh splits nothing
    one = pmesh.DataMesh(world=1, rank=0, device=torch.device("cpu"))
    assert all(d == (None, None) for layers in pmesh.param_shardings(tparams, one).values()
               for d in layers)


def _jax_unsharded(kw):
    """JAX's unsharded update_step in float64 from its seeded runner, the draws
    it took and the runner's train state as numpy."""
    jcfg = jbase_config(**kw)
    jtr, _ = _tracks()
    hooks = jhooks(jenv.RacingConfig(num_sensors=11))
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jtr, 15, 2)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jrunner.train.params)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    noise, consts = _jax_draws(jrunner.key, T, N, jcfg.update_epochs)
    jout, jpacked = jax.jit(jppo.make_update_step(jcfg, hooks, 2))(jrunner, jtr)
    return jout, np.asarray(jpacked), {"noise": noise, "perm_consts": consts}, \
        _numpy_train(params, opt_state)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_update_matches_unsharded_and_jax(world):
    kw = dict(TP, kl_target=0.5, learning_rate=1e-3)
    jout, jpacked, feed, init = _jax_unsharded(kw)
    build = SingleBuild(kw, *init)
    one = tp_updates(build, feed)
    ranks = run_ranks(tp_update_rank, world, build, feed, 2, timeout=TIMEOUT)

    # the one-process update is JAX's
    packed, (p, mu, nu, count, update) = one["updates"][0]
    jm, m = jppo.unpack_metrics(jpacked), tppo.unpack_metrics(packed)
    for k in ("update", "global_step", "episodes", "kl_stopped", "minibatches_applied"):
        assert m[k] == jm[k], k
    assert m["minibatches_applied"] == 8 and count == 8 and update == 1
    np.testing.assert_allclose(packed, jpacked, rtol=1e-5, atol=1e-6)
    jadam = jout.train.opt_state[1]
    _close_trees((p, mu, nu), (jout.train.params, jadam.mu, jadam.nu), rtol=1e-6, atol=1e-7)

    n_data = world // 2
    for r, got in enumerate(ranks):
        assert got["mesh"] == ({"data": n_data, "model": 2}, ("data", "model"), r // 2,
                               r % 2, r)
        params, mu_shapes, nu_shapes = got["shapes"]
        assert params[:4] == [(15, 64), (64,), (64, 128), (128,)]
        assert params[4:6] == [(128, 2), (2,)]          # the head stays whole
        assert params[6:8] == [(15, 64), (64,)]         # the critic alike
        assert mu_shapes == nu_shapes == params
        assert got["round_trip"]
        for u, ((gp, gstate), (op, ostate)) in enumerate(zip(got["updates"], one["updates"])):
            assert gstate[3:] == ostate[3:] == (8 * (u + 1), u + 1)
            assert tppo.unpack_metrics(gp)["minibatches_applied"] == \
                tppo.unpack_metrics(op)["minibatches_applied"]
            np.testing.assert_allclose(gp, op, rtol=1e-6, atol=1e-7)
            _close_trees(gstate[:3], ostate[:3], rtol=1e-9, atol=1e-12)
            _close_trees(gstate[:3], ranks[0]["updates"][u][1][:3], rtol=0.0)
        _close_trees(got["updates"][0][1][:3], (jout.train.params, jadam.mu, jadam.nu),
                     rtol=1e-6, atol=1e-7)


SELFPLAY = dict(num_envs=16, num_steps=32, num_minibatches=4, update_epochs=2,
                total_timesteps=16 * 32 * 4, snapshot_freq=1, pool_size=3,
                opponent_per_env=True, reset_envs_each_update=False, hidden=(128, 128))


def test_selfplay_snapshot_and_checkpoints_hold_the_whole_params(tmp_path):
    from self_play_racing_tpu_torch.evaluate import load_policy_bundle

    consts = np.random.default_rng(5).integers(0, 2**32, size=(2, 1, 8))
    one = tp_selfplay(SELFPLAY, consts)
    ranks = run_ranks(tp_selfplay_rank, 2, SELFPLAY, consts, str(tmp_path), 2,
                      timeout=TIMEOUT)
    for got in ranks:
        assert got["local"][:4] == [(19, 64), (64,), (64, 128), (128,)]
        assert got["num_snapshots"] == one["num_snapshots"] == 1
        params = [t for tower in ("actor", "critic") for layer in got["state"][0][tower]
                  for t in layer]
        assert [x.shape for x in got["slot"]] == [x.shape for x in params]
        for s, x in zip(got["slot"], params):
            np.testing.assert_array_equal(s, x)
        _close_trees(got["state"][:3], one["state"][:3], rtol=0.0, atol=1e-6)
        _close_trees(got["state"][:3], ranks[0]["state"][:3], rtol=0.0)
    # the checkpoint loads into an unsharded trainer as the whole state
    tr = tp_selfplay_trainer(SELFPLAY)
    tr.load_checkpoint(str(tmp_path / "tp_ckpt"))
    want = ranks[0]["state"]
    got = interop.train_state_to_numpy(tr.runner.train)
    _close_trees((got[0], got[1]["mu"], got[1]["nu"]), want[:3], rtol=0.0)
    assert (int(got[1]["count"]), int(got[2])) == want[3:]
    assert tr.num_snapshots == 1
    slot = [t[0].numpy() for layers in tr.pool["params"].values() for layer in layers
            for t in layer]
    for s, x in zip(slot, ranks[0]["slot"]):
        np.testing.assert_array_equal(s, x)
    # the policy file loads into the port and into JAX
    path = str(tmp_path / "tp_policy.npz")
    tparams, _, _ = load_policy_bundle(path, device="cpu")
    jparams, _, _ = jload_policy_bundle(path)
    _close_trees(jax.tree.map(np.asarray, jparams), want[0], rtol=0.0)
    _close_trees({k: [(w.detach().numpy(), b.detach().numpy()) for w, b in v]
                  for k, v in tparams.items()},
                 want[0], rtol=0.0)


def test_make_mesh_refuses_a_model_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        pmesh.make_mesh("cpu", model_parallel=2)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        jmesh.make_mesh(jax.devices()[:3], model_parallel=2)
    mesh = pmesh.make_mesh("cpu", model_parallel=1)
    assert isinstance(mesh, pmesh.DataMesh) and mesh.shape == {"data": 1}
