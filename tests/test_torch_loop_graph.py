"""The evaluation, match and recorder loops as a start, one step function and a
chunked loop (``utils/metrics.py``), against the JAX package's whole-horizon
programs, on the CPU.

- The single-car loop, the shared-policy multi-car loop and the per-seat match
  loop in float64 on a 3 x 2 evaluation grid, against JAX's ``_rollout_single_jit``
  and ``_rollout_multi_jit`` (shared and ``per_seat``) fed the same noise (the
  port's draws replaced by JAX's through ``net.sample_noise``, or handed in as
  ``noise``) and, for two cars, JAX's start-grid slots. Horizons 45 and 70, not
  multiples of 32: trained policies that run the whole horizon (32 + 13 steps), and
  policies held to a steering angle at full throttle whose episodes all end before
  step 64, so that the every-32-steps check stops the loop at 32 or 64,
  short of the horizon. steps, finished, crashed and placement exact; the floats within
  rtol 1e-9 (``tests/test_torch_tournament.py``'s: cos/sin round differently in
  XLA's and PyTorch's CPU math). The loop's step count is its chunks': the
  horizon, or the first multiple of 32 at or past the longest episode.
- The same runs' trace buffers against JAX's ``_record_single_jit`` /
  ``_record_multi_jit`` outputs: ``active`` equal on every row, the other rows
  within rtol 1e-9 / atol 1e-9 (``tests/test_torch_viz.py``'s) where a row was
  active; rows an early exit never ran stay zero; ``viz._trimmed`` equal to JAX's
  trimming (env 0, through the done step).
- A CPU loop never touches ``torch.cuda.CUDAGraph``.
- ``LoopGraphs``' decisions with a stub capture (a body replayed eagerly): the
  same signature reuses the graph, new policy tensors of the same shapes are
  copied without a recapture, a new shape captures again, and a new track tensor
  captures once more with the track copied from then on; the replayed loop and the
  caller's generator afterwards equal the eager loop's bitwise.
- The loops' modules and ``chip_smoke.py`` import neither JAX nor the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import normalize as jnorm
from self_play_racing_tpu.envs import single as jsingle
from self_play_racing_tpu.evaluate import load_policy_bundle as jload
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.utils import metrics as jM
from self_play_racing_tpu.utils import viz as jviz
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import _graph
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import normalize as tnorm
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.models import actor_critic as tnet
from self_play_racing_tpu_torch.utils import metrics as tM
from self_play_racing_tpu_torch.utils import viz as tviz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9          # the accumulators' floats (tests/test_torch_tournament.py)
TRACE_TOL = 1e-9     # the trace rows, rtol and atol (tests/test_torch_viz.py)
INTS = ("steps", "finished", "crashed", "placement")
SINGLE_MODEL = "models/single_agent.npz"
MULTI_MODEL = "models/self_play_agent.npz"
SCALE_MODEL = "models/self_play_agent_scale_1B.npz"
N = 6                # the 3 x 2 grid's envs
SINGLE_CFG = (jsingle.RacingConfig(num_sensors=11), tsingle.RacingConfig(num_sensors=11))
MULTI_CFG = (jmulti.MultiRacingConfig(num_agents=2, num_sensors=11),
             tmulti.MultiRacingConfig(num_agents=2, num_sensors=11))


@pytest.fixture(scope="module")
def grids():
    jgrid, _, _ = jM.build_eval_grid(3, 2, dtype=jnp.float64)
    tgrid, _, _ = tM.build_eval_grid(3, 2, dtype=torch.float64, device="cpu")
    return jgrid, tgrid


def _port_params(jp):
    return {tower: [(torch.as_tensor(np.array(w)), torch.as_tensor(np.array(b)))
                    for w, b in jp[tower]] for tower in ("actor", "critic")}


def _trained(path):
    """A trained policy in float64 as (JAX params, JAX log_std, port params, port
    log_std)."""
    p, ls, _ = jload(path)
    jp = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), p)
    jls = jnp.asarray(ls, jnp.float64)
    return jp, jls, _port_params(jp), torch.as_tensor(np.array(jls))


def _crashing(seed, obs_dim):
    """A random-init float64 policy whose mu head holds the wheel at 0.3 at full
    throttle, with little noise: every episode ends in a crash within 50 steps."""
    jp = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                      jnet.init_params(jax.random.key(seed), obs_dim, 2))
    w, b = jp["actor"][-1]
    jp["actor"][-1] = (w, b + jnp.arctanh(jnp.asarray([0.3, 0.95], jnp.float64)))
    jls = jnp.full((2,), -3.0, jnp.float64)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jp), np.asarray(jls),
                                    dtype=torch.float64, device="cpu")
    return jp, jls, model.params(), model.log_std


def _stack(a, b):
    """Two float64 policies as per-seat stacks, seat 0 with a seeded normalizer and
    seat 1 with identity rows: (JAX params, log_std, norm), (port ...)."""
    jp = jax.tree.map(lambda x, y: jnp.stack([x, y]), a[0], b[0])
    jl = jnp.stack([a[1], b[1]])
    rng = np.random.default_rng(0)
    mean = np.stack([rng.normal(0.0, 0.02, 19), np.zeros(19)])
    var = np.stack([rng.uniform(0.9, 1.1, 19), np.ones(19)])
    count = np.array([1.0, 1e-4])
    jn = jnorm.ObsNormState(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count))
    tn = tnorm.ObsNormState(*(torch.as_tensor(x) for x in (mean, var, count)))
    return (jp, jl, jn), (_port_params(jp), torch.as_tensor(np.array(jl)), tn)


def _jax_draws(key, steps, shape):
    """JAX's sampled-action noise of a loop from ``key``: row t is
    normal(split(key, steps)[t], shape)."""
    @jax.jit
    def draws(keys):
        return jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(keys)
    return torch.as_tensor(np.array(draws(jax.random.split(key, steps))))


def _jax_seat_noise(key, steps, n, a=2):
    """The per-seat noise of JAX's sampled match loop from ``key``, [T, N, A, 2]."""
    _, k_run = jax.random.split(key)

    @jax.jit
    def draws(keys):
        return jax.vmap(lambda k: jax.vmap(
            lambda ks: jax.random.normal(ks, (n, 2), jnp.float64))(jax.random.split(k, a)))(keys)
    return torch.as_tensor(np.array(draws(jax.random.split(k_run, steps))).transpose(0, 2, 1, 3))


def _jax_grid_slots(key, n, a=2):
    k_reset, _ = jax.random.split(key)
    order = jax.vmap(lambda k: jax.random.permutation(k, a))(jax.random.split(k_reset, n))
    return torch.as_tensor(np.array(jnp.argsort(order, axis=-1)))


def _feed(monkeypatch, rows):
    """The port's ``net.sample_noise`` returns the rows of ``rows`` in turn."""
    it = iter(rows)
    monkeypatch.setattr(tnet, "sample_noise",
                        lambda shape, generator, dtype=torch.float32, device=None:
                        next(it).reshape(shape).to(dtype))


def _counted(monkeypatch, name):
    """Counts the calls of ``metrics.<name>`` (a loop's step function)."""
    calls = [0]
    real = getattr(tM, name)

    def step(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(tM, name, step)
    return calls


# loop, horizon, policy ("trained": runs the whole horizon; "crashing": every
# episode ends before step 64, so the loop stops at its check there or at 32), sampled
LOOP_CASES = {
    "single-45-trained-sampled": ("single", 45, "trained", True),
    "single-70-crashing-greedy": ("single", 70, "crashing", False),
    "single-70-crashing-sampled": ("single", 70, "crashing", True),
    "shared-45-trained-greedy": ("shared", 45, "trained", False),
    "shared-70-crashing-sampled": ("shared", 70, "crashing", True),
    "match-45-trained-sampled": ("match", 45, "trained", True),
    "match-70-crashing-greedy": ("match", 70, "crashing", False),
    "match-70-crashing-sampled": ("match", 70, "crashing", True),
}


def _run_both(case, grids, monkeypatch):
    """(JAX accumulators, JAX trace [T, N, ...], port accumulators, port trace,
    the port loop's step count) for a ``LOOP_CASES`` case."""
    loop, steps, policy, sampled = LOOP_CASES[case]
    jgrid, tgrid = grids
    key = jax.random.key(5)
    det = not sampled
    if loop == "single":
        jp, jls, tp, tls = (_trained(SINGLE_MODEL) if policy == "trained"
                            else _crashing(1, 15))
        cfg_j, cfg_t = SINGLE_CFG
        j = jM._rollout_single_jit(cfg_j, steps, det)(jp, jls, jgrid, key, None)
        jtrace = jviz._record_single_jit(cfg_j, steps, det)(jp, jls, jgrid, key, None)
        if sampled:
            _feed(monkeypatch, _jax_draws(key, steps, (N, 2)))
        calls = _counted(monkeypatch, "_single_step")
        trace = {}
        t = tM._rollout_single_acc(tp, tls, cfg_t, tgrid, torch.Generator(), steps, det,
                                   None, trace=trace)
        return j, jtrace, t, trace, calls[0]
    cfg_j, cfg_t = MULTI_CFG
    monkeypatch.setattr(tmulti, "random_grid_slots",
                        lambda n, a, gen, device=None: _jax_grid_slots(key, n))
    calls = _counted(monkeypatch, "_multi_step")
    trace = {}
    if loop == "shared":
        jp, jls, tp, tls = _trained(MULTI_MODEL) if policy == "trained" else _crashing(2, 19)
        j = jM._rollout_multi_jit(cfg_j, steps, det)(jp, jls, jgrid, key, None)
        jtrace = jviz._record_multi_jit(cfg_j, steps, det)(jp, jls, jgrid, key, None)
        if sampled:
            _, k_run = jax.random.split(key)
            _feed(monkeypatch, _jax_draws(k_run, steps, (N * 2, 2)))
        t = tM._rollout_multi_acc(tp, tls, cfg_t, tgrid, torch.Generator(), steps, det,
                                  None, trace=trace)
        return j, jtrace, t, trace, calls[0]
    a, b = ((_trained(SCALE_MODEL), _trained(MULTI_MODEL)) if policy == "trained"
            else (_crashing(3, 19), _crashing(4, 19)))
    (jp, jl, jn), (tp, tl, tn) = _stack(a, b)
    j = jM._rollout_multi_jit(cfg_j, steps, det, per_seat=True)(jp, jl, jgrid, key, jn)
    jtrace = jviz._record_multi_jit(cfg_j, steps, det, per_seat=True)(jp, jl, jgrid, key, jn)
    noise = _jax_seat_noise(key, steps, N) if sampled else None
    t = tM._rollout_multi_acc(tp, tl, cfg_t, tgrid, torch.Generator(), steps, det, tn,
                              per_seat=True, noise=noise, trace=trace)
    return j, jtrace, t, trace, calls[0]


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_chunked_loop_matches_jax(case, grids, monkeypatch):
    _, steps, policy, _ = LOOP_CASES[case]
    j, jtrace, t, trace, ran = _run_both(case, grids, monkeypatch)
    j = {k: np.asarray(v) for k, v in j.items() if k != "distance_per_step"}
    assert sorted(t) == sorted(j)
    for k in j:
        if k in INTS:
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
        else:
            np.testing.assert_allclose(t[k].numpy(), j[k], rtol=RTOL, err_msg=k)

    # the chunks: the whole horizon in chunks of 32, or up to the check after the
    # longest episode ended
    longest = int(j["steps"].max())
    assert ran == min(steps, -(-longest // 32) * 32)
    if policy == "trained":
        assert ran == steps and longest == steps
    else:
        assert ran < steps

    # the trace buffers: JAX's scan outputs on the rows the loop ran
    jtrace = {k: np.asarray(v) for k, v in jtrace.items()}
    assert sorted(trace) == sorted(jtrace) == sorted(tM.TRACE_KEYS)
    assert all(v.shape == jtrace[k].shape for k, v in trace.items())
    active = jtrace["active"]
    np.testing.assert_array_equal(trace["active"].numpy(), active)
    for k in tM.TRACE_KEYS[:-1]:
        mine = trace[k].numpy()
        np.testing.assert_allclose(mine[active], jtrace[k][active], rtol=TRACE_TOL,
                                   atol=TRACE_TOL, err_msg=k)
        assert not mine[ran:].any(), k  # rows the loop never ran
    trimmed = tviz._trimmed(trace)
    n = int(active[:, 0].sum())
    assert 0 < n and all(len(v) == n for v in trimmed.values())
    assert trimmed["active"].all()
    for k in tM.TRACE_KEYS[:-1]:
        np.testing.assert_allclose(trimmed[k], jtrace[k][:n, 0], rtol=TRACE_TOL,
                                   atol=TRACE_TOL, err_msg=k)


def test_cpu_loops_never_build_a_graph(grids, monkeypatch):
    class NoGraph:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a CPU loop built a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(_graph, "CapturedStep", NoGraph)
    _, tgrid = grids
    before = tM.loop_graphs.captures
    _, _, tp, tls = _crashing(1, 15)
    out = tM.rollout_single(tp, tls, SINGLE_CFG[1], tgrid, torch.Generator().manual_seed(0),
                            max_steps=40)
    assert out["steps"].shape == (N,)
    _, _, mp, mls = _crashing(2, 19)
    gen = torch.Generator().manual_seed(0)
    assert tM.rollout_multi(mp, mls, MULTI_CFG[1], tgrid, gen, max_steps=40)["steps"].shape == (N,)
    stack = (tuple(_stack(_crashing(3, 19), _crashing(4, 19))[1]))
    acc = tM.rollout_match(*stack, MULTI_CFG[1], tgrid, gen, max_steps=40)
    assert acc["placement"].shape == (N, 2)
    traj = tviz.record_trajectory_single(tp, tls, SINGLE_CFG[1], tgrid, max_steps=40)
    assert traj["active"].all() and len(traj["x"]) <= 40
    assert tM.loop_graphs.captures == before and not tM.loop_graphs.graphs


class _StubCapture:
    """``_graph.CapturedStep`` replayed by calling its body (on the CPU)."""
    made = 0

    def __init__(self, body, device, generators, rewind):
        type(self).made += 1
        self.body, self.generators, self.pool_bytes = body, generators, 0

    def replay(self, times=1):
        for _ in range(times):
            self.body()


def _single_loop(graphs, cfg, params, log_std, track, gen, steps, eager=False):
    """The sampled single-car loop through ``graphs`` (or eagerly)."""
    carry = tM._start_single(cfg, track)
    inputs = {"params": params, "log_std": log_std, "obs_norm": None, "track": track}

    def step(inp, g, c, tr):
        return tM._single_step(cfg, False, inp, g, c, tr)
    if eager:
        return tM._run_loop(None, step, carry, inputs, gen, steps, None, True)
    return graphs.run(("single", cfg, False), step, carry, inputs, gen, None, steps)


def test_loop_graph_cache_decisions(grids, monkeypatch):
    monkeypatch.setattr(_graph, "CapturedStep", _StubCapture)
    _StubCapture.made = 0
    graphs = tM.LoopGraphs()
    cfg = SINGLE_CFG[1]
    _, tgrid = grids
    policies = [_trained(SINGLE_MODEL)[2:], _crashing(1, 15)[2:], _crashing(7, 15)[2:]]

    def both(params, log_std, track, seed, steps=45):
        g_graph = torch.Generator().manual_seed(seed)
        g_eager = torch.Generator().manual_seed(seed)
        got = _single_loop(graphs, cfg, params, log_std, track, g_graph, steps)
        want = _single_loop(None, cfg, params, log_std, track, g_eager, steps, eager=True)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        # the caller's generator ends where the eager loop leaves it
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        return got

    both(*policies[0], tgrid, 1)
    assert (graphs.captures, _StubCapture.made, len(graphs.graphs)) == (1, 1, 1)
    graph = next(iter(graphs.graphs.values()))
    assert graph.inputs.tree["track"].wp_x is tgrid.wp_x        # read in place
    assert graph.inputs.tree["params"]["actor"][0][0] is not policies[0][0]["actor"][0][0]
    # the same signature, another seed: the graph is reused
    both(*policies[0], tgrid, 2)
    # new policy tensors of the same shapes: copied into the graph, no recapture
    a = both(*policies[1], tgrid, 1)
    b = both(*policies[2], tgrid, 1)
    assert not torch.equal(a["total_reward"], b["total_reward"])
    assert (graphs.captures, _StubCapture.made) == (1, 1)
    # a new shape captures again; the first graph is still kept
    small, _, _ = tM.build_eval_grid(2, 1, dtype=torch.float64, device="cpu")
    both(*policies[1], small, 3)
    assert (graphs.captures, len(graphs.graphs)) == (2, 2)
    both(*policies[0], tgrid, 4)
    assert graphs.captures == 2
    # another track tensor of the same shapes: captured once more with the track
    # copied, then copied without a recapture
    other, _, _ = tM.build_eval_grid(3, 2, seed=7, dtype=torch.float64, device="cpu")
    both(*policies[0], other, 5)
    assert graphs.captures == 3
    graph = graphs.graphs[next(reversed(graphs.graphs))]
    assert ("track", "wp_x") in graph.inputs.copied and graph.inputs.tree["track"].wp_x is not other.wp_x
    both(*policies[0], tgrid, 6)
    assert graphs.captures == 3 and len(graphs.graphs) == 2
    # the horizon is the number of replays: no graph of its own
    both(*policies[0], tgrid, 7, steps=70)
    assert graphs.captures == 3
    # the least recently used graph goes when the cache is full
    graphs.size = 1
    third, _, _ = tM.build_eval_grid(2, 2, dtype=torch.float64, device="cpu")
    both(*policies[0], third, 8)
    assert graphs.captures == 4 and len(graphs.graphs) == 1


def test_loop_modules_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "from self_play_racing_tpu_torch import _graph, evaluate, tournament, render\n"
        "from self_play_racing_tpu_torch.utils import metrics, viz\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'self_play_racing_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
