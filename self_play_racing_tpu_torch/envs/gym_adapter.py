"""Gymnasium-API adapters over the port's envs (port of
``self_play_racing_tpu/envs/gym_adapter.py``).

Drop-in equivalents of the reference's env classes: the same constructor
signatures (num_sensors, track_pool, track_id, track_width, ...), the same spaces
and the same ``(obs, reward, terminated, truncated, info)`` step contract, with the
dynamics run by the batched envs (``envs/single.py``, ``envs/multi.py``) at batch
size 1. For API-compatible scripting, the SB3-style baseline and cross-checks;
training at scale uses the batched API.

- On ``cuda`` a ``RacingEnv`` step launches the single env's transition
  (``car_step_and_query``) and sensing (``raycast_walls``) once each, a
  ``MultiRacingEnv`` step its transition and ``raycast_walls_and_cars``; each step
  makes one host copy of what it returns.
- ``dtype=None`` is float64 on the CPU (the JAX adapter's default) and float32 on
  ``cuda``, whose kernels take float32 only: an explicit float64 on ``cuda``
  raises the kernels' ``TypeError``.
- Without gymnasium the classes subclass small stand-ins (``gym.Env``,
  ``gym.Wrapper`` and ``gym.spaces.Box``/``Dict`` with ``low``, ``high``,
  ``shape``, ``dtype`` and a ``sample()`` from the global NumPy RNG), so the spaces
  exist either way and ``DummyVecEnv`` and the vendored ``PPO`` run on them. With
  gymnasium the classes are gymnasium's own.
- ``EpisodeStatistics`` puts ``info["episode"] = {"r", "l", "t"}`` on the done
  step, as ``gymnasium.wrappers.RecordEpisodeStatistics`` does, with or without
  gymnasium.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import actor_critic as net
from . import multi as menv
from . import single as senv
from . import track as trk

try:
    import gymnasium as gym

    _GYM = True
except ImportError:
    _GYM = False

    class _Box:
        """The subset of ``gymnasium.spaces.Box`` the adapters and the vendored
        PPO read: bounds broadcast to ``shape`` in ``dtype``, and ``sample()``
        uniform between them from the global NumPy RNG."""

        def __init__(self, low, high, shape=None, dtype=np.float32):
            self.dtype = np.dtype(dtype)
            shape = np.shape(low) if shape is None else tuple(shape)
            self.low = np.broadcast_to(np.asarray(low, self.dtype), shape).copy()
            self.high = np.broadcast_to(np.asarray(high, self.dtype), shape).copy()
            self.shape = shape

        def sample(self):
            return np.random.uniform(self.low, self.high).astype(self.dtype)

    class _Dict:
        """The subset of ``gymnasium.spaces.Dict``: named subspaces."""

        def __init__(self, spaces):
            self.spaces = dict(spaces)

        def __getitem__(self, key):
            return self.spaces[key]

        def keys(self):
            return self.spaces.keys()

        def sample(self):
            return {k: s.sample() for k, s in self.spaces.items()}

    class gym:  # type: ignore
        class Env:
            pass

        class Wrapper:
            pass

        class spaces:
            Box = _Box
            Dict = _Dict


def _resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    if dtype is not None:
        return dtype
    return torch.float32 if device.type == "cuda" else torch.float64


def _pool_from(track_pool, track_id, track_width, dtype, device):
    """The reference's track pool and width selection: a random pool entry (global
    NumPy RNG) when ``track_id`` is None, the width by ``track_id`` when widths are
    given per track, else the default track."""
    if track_pool is not None:
        if track_id is None:
            track_id = int(np.random.randint(0, len(track_pool)))
        control_points = track_pool[track_id]
        if isinstance(track_width, (list, tuple, np.ndarray)):
            track_width = track_width[track_id]
    else:
        control_points = trk.DEFAULT_CONTROL_POINTS
    if track_width is None:
        track_width = trk.DEFAULT_TRACK_WIDTH
    pool = trk.make_track_pool([control_points], [float(track_width)], dtype=dtype,
                               device=device)
    return trk.gather_tracks(pool, [0])


def _action_box():
    return gym.spaces.Box(low=np.array([-1.0, 0.0]), high=np.array([1.0, 1.0]),
                          shape=(2,), dtype=np.float32)


def _obs_box(obs_dim):
    return gym.spaces.Box(low=np.float32(-1.0), high=np.float32(1.0), shape=(obs_dim,),
                          dtype=np.float32)


def _host(*tensors) -> np.ndarray:
    """The tensors flattened into one float64 vector, copied to the host once."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()


class RacingEnv(gym.Env):
    """Single-car adapter (the reference's racing_env contract). Runs on ``device``
    (default ``cuda``) in ``dtype`` (see the module docstring)."""

    metadata = {"render_modes": []}

    def __init__(self, num_sensors=7, track_pool=None, track_id=None, track_width=None,
                 speed_weight=8.0, dtype=None, device=None):
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(dtype, self.device)
        self.cfg = senv.RacingConfig(num_sensors=num_sensors, speed_weight=speed_weight)
        self.track = _pool_from(track_pool, track_id, track_width, self.dtype, self.device)
        self.speed_weight = speed_weight
        self.action_space = _action_box()
        self.observation_space = _obs_box(self.cfg.obs_dim)
        self.state = None

    def reset(self, seed=None, options=None):
        if _GYM:
            super().reset(seed=seed)
        self.state, obs = senv.reset(self.cfg, self.track)
        car = self.state.car
        host = _host(obs[0], car.x, car.y)
        info = {"position": (float(host[-2]), float(host[-1])),
                "speed": 0.0, "progress": 0.0, "crashed": False, "finished": False}
        return host[:-2].astype(np.float32), info

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float64), dtype=self.dtype,
                            device=self.device)[None, :]
        self.state, obs, rew, term, trunc, info = senv.step(
            self.cfg, self.track, self.state, a, speed_weight=self.speed_weight)
        n = obs.shape[-1]
        host = _host(obs[0], rew, term, trunc, *(info[k] for k in (
            "x", "y", "speed", "progress", "crashed", "finished", "progress_delta")))
        rew, term, trunc, x, y, speed, progress, crashed, finished, delta = host[n:]
        info_out = {
            "position": (float(x), float(y)),
            "speed": float(speed),
            "progress": float(progress),
            "crashed": bool(crashed),
            "finished": bool(finished),
            "reward": float(rew),
            "progress_delta": float(delta),
        }
        return host[:n].astype(np.float32), float(rew), bool(term), bool(trunc), info_out


class MultiRacingEnv(gym.Env):
    """Multi-car adapter (the reference's multi_racing_env contract): Dict spaces
    keyed by the agents' index strings, a ``dones`` dict with ``"__all__"``."""

    def __init__(self, num_agents=2, num_sensors=11, track_pool=None, track_id=None,
                 track_width=None, dtype=None, device=None):
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(dtype, self.device)
        self.cfg = menv.MultiRacingConfig(num_agents=num_agents, num_sensors=num_sensors)
        self.track = _pool_from(track_pool, track_id, track_width, self.dtype, self.device)
        self.num_agents = num_agents
        self.action_space = gym.spaces.Dict({f"{i}": _action_box() for i in range(num_agents)})
        self.observation_space = gym.spaces.Dict(
            {f"{i}": _obs_box(self.cfg.obs_dim) for i in range(num_agents)})
        self.state = None

    def reset(self, seed=None, options=None):
        if _GYM:
            super().reset(seed=seed)
        order = list(range(self.num_agents))
        np.random.shuffle(order)  # the reference's global-RNG draw
        pos = np.array([order.index(i) for i in range(self.num_agents)])
        self.state, obs = menv.reset(self.cfg, self.track, position_idx=pos[None, :])
        a, n = self.num_agents, obs.shape[-1]
        host = _host(obs[0], self.state.x[0], self.state.y[0])
        obs_h = host[:a * n].reshape(a, n).astype(np.float32)
        x, y = host[a * n:a * n + a], host[a * n + a:]
        observations = {f"{i}": obs_h[i] for i in range(a)}
        infos = {f"{i}": {"position": (float(x[i]), float(y[i])), "speed": 0.0,
                          "progress": 0.0, "crashed": False, "finished": False}
                 for i in range(a)}
        return observations, infos

    def step(self, actions):
        a = np.stack([np.asarray(actions[f"{i}"], np.float64)
                      for i in range(self.num_agents)])
        self.state, obs, rew, term, trunc, info = menv.step(
            self.cfg, self.track, self.state,
            torch.as_tensor(a, dtype=self.dtype, device=self.device)[None])
        na, n = self.num_agents, obs.shape[-1]
        host = _host(obs[0], term, trunc, rew[0], *(info[k][0] for k in (
            "x", "y", "speed", "progress", "crashed", "finished", "placement")))
        obs_h = host[:na * n].reshape(na, n).astype(np.float32)
        term, trunc = bool(host[na * n]), bool(host[na * n + 1])
        rew_h, x, y, speed, progress, crashed, finished, placement = \
            host[na * n + 2:].reshape(8, na)
        done_all = term or trunc
        observations = {f"{i}": obs_h[i] for i in range(na)}
        rewards = {f"{i}": float(rew_h[i]) for i in range(na)}
        infos = {}
        for i in range(na):
            d = {
                "position": (float(x[i]), float(y[i])),
                "speed": float(speed[i]),
                "progress": float(progress[i]),
                "crashed": bool(crashed[i]),
                "finished": bool(finished[i]),
                "reward": rewards[f"{i}"],
            }
            if done_all:
                d["placement"] = int(placement[i])
            infos[f"{i}"] = d
        dones = {f"{i}": term for i in range(na)}
        dones["__all__"] = done_all
        return observations, rewards, dones, trunc, infos


class SelfPlayWrapper(gym.Wrapper):
    """Single-agent view of the multi-car adapter with an internal frozen opponent
    (the reference's self-play wrapper contract).

    ``set_opponent`` accepts:
      - ``None``: opponents sample uniformly from the action space
        (``action_space.sample()`` with gymnasium, else ``np.random.uniform``; with
        the multi env's (a+1)/2 throttle remap random opponents drive with
        throttle in [0.5, 1]),
      - a ``(params, log_std)`` pair (the actor-critic's parameter dict, tensors or
        numpy arrays): opponents sample Normal(mu, exp(log_std)) clamped to
        [-1, 1], with noise from a ``torch.Generator`` seeded 0 on the env's
        device. The JAX adapter draws from ``jax.random.key(0)``: the streams
        differ, the distribution is the same,
      - any callable ``obs -> action`` (e.g. ``serve.Policy(...).act``).

    Opponents act on the observation stored from the *previous* step. ``step``
    returns the agent's view with ``done = dones["__all__"]``. Training at scale
    uses the batched ``envs.selfplay`` path.
    """

    def __init__(self, env: MultiRacingEnv, agent_id: int = 0):
        if _GYM:
            super().__init__(env)
        self.env = env
        self.agent_id = agent_id
        self._agent_key = str(agent_id)
        self.curr_opponent = None
        self.last_obs_dict = None
        self._generator = None
        self.action_space = env.action_space[self._agent_key]
        self.observation_space = env.observation_space[self._agent_key]

    def set_opponent(self, opponent):
        self.curr_opponent = opponent

    @torch.no_grad()
    def _opponent_action(self, obs):
        opp = self.curr_opponent
        if opp is None:
            if _GYM:
                return self.action_space.sample()
            return np.random.uniform([-1.0, 0.0], [1.0, 1.0]).astype(np.float32)
        if callable(opp):
            return np.asarray(opp(obs), np.float32)
        params, log_std = opp
        dev = self.env.device
        if self._generator is None:
            self._generator = torch.Generator(device=dev).manual_seed(0)
        as_t = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                         device=dev)
        params = {k: [(as_t(w), as_t(b)) for w, b in layers] for k, layers in params.items()}
        head_w = params["actor"][-1][0]
        # the noise in the policy's dtype, as JAX draws it in mu's
        noise = net.sample_noise((1, head_w.shape[-1]), self._generator, dtype=head_w.dtype,
                                 device=dev)
        a, _, _ = net.sample_action(params, as_t(log_std), torch.as_tensor(
            np.asarray(obs, np.float32), device=dev)[None], noise)
        return a[0].cpu().numpy()

    def reset(self, seed=None, options=None):
        obs, infos = self.env.reset(seed=seed, options=options)
        self.last_obs_dict = obs
        return obs[self._agent_key], infos[self._agent_key]

    def step(self, action):
        actions = {self._agent_key: np.asarray(action, np.float32)}
        for i in range(self.env.num_agents):
            k = f"{i}"
            if k != self._agent_key:
                actions[k] = self._opponent_action(self.last_obs_dict[k])
        obs, rewards, dones, truncated, infos = self.env.step(actions)
        self.last_obs_dict = obs
        return (obs[self._agent_key], rewards[self._agent_key], dones["__all__"],
                truncated, infos[self._agent_key])


class EpisodeStatistics(gym.Wrapper):
    """The episode's return, length and wall time as ``info["episode"] = {"r",
    "l", "t"}`` on the step that ends it, as
    ``gymnasium.wrappers.RecordEpisodeStatistics`` records them (``t`` rounded to
    microseconds, from the reset). The SB3 baseline wraps each env in it, with or
    without gymnasium."""

    def __init__(self, env):
        if _GYM:
            super().__init__(env)
        self.env = env
        self.action_space = env.action_space
        self.observation_space = env.observation_space
        self.episode_returns = 0.0
        self.episode_lengths = 0
        self.episode_start_time = -1.0

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self.episode_start_time = time.perf_counter()
        self.episode_returns = 0.0
        self.episode_lengths = 0
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.episode_returns += reward
        self.episode_lengths += 1
        if terminated or truncated:
            info["episode"] = {
                "r": self.episode_returns,
                "l": self.episode_lengths,
                "t": round(time.perf_counter() - self.episode_start_time, 6),
            }
            self.episode_start_time = time.perf_counter()
        return obs, reward, terminated, truncated, info
