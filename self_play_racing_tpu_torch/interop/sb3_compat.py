"""SB3-compatible PPO baseline in plain PyTorch, used where ``stable_baselines3`` is
not installed (port of ``self_play_racing_tpu/interop/sb3_compat.py``, which is
already torch and numpy; the one change is the device).

The reference's baseline cross-check trains SB3's PPO on the same single-car env
and evaluates it on the same grid. This module reimplements the subset that leg
uses, SB3 2.x PPO with its default hyperparameters on an ``MlpPolicy`` over Box
spaces, and the API it consumes:

  ``PPO("MlpPolicy", env, seed=...)`` / ``.learn(total_timesteps, callback)`` /
  ``.predict(obs, deterministic=True)`` / ``.save(path)`` / ``PPO.load(path)`` /
  ``.ep_info_buffer`` / ``.num_timesteps``, ``BaseCallback`` and ``DummyVecEnv``.

It is a learner independent of the port's own PPO (``agent/ppo.py``): another
update loop, ``torch.optim.Adam`` and SB3's defaults, so it still serves as the
cross-check of the env and training contract.

SB3 defaults kept (stable_baselines3/ppo/ppo.py, common/policies.py):
 - n_steps=2048, batch_size=64, n_epochs=10, gamma=0.99, gae_lambda=0.95,
   clip_range=0.2 (constant), ent_coef=0.0, vf_coef=0.5, max_grad_norm=0.5,
   learning_rate=3e-4 (constant), normalize_advantage=True, clip_range_vf=None,
   target_kl=None (no early stop)
 - MlpPolicy for Box: separate pi/vf towers [64, 64] with tanh, orthogonal init
   (gain sqrt(2) hidden, 0.01 action head, 1.0 value head), state-independent
   learned ``log_std`` initialised to 0, Adam(eps=1e-5)
 - rollout stores the *unclipped* sampled action and its log-prob; the action is
   clipped to the space only at the env boundary
 - timeout bootstrapping: on a truncated (not terminated) episode end the reward
   is augmented with gamma * V(terminal_observation)
 - advantages normalized per minibatch with +1e-8; value loss is un-clipped MSE

Device: ``PPO(device=None)`` and ``PPO.load(..., device=None)`` resolve through
``resolve_device``, so the policy lives on ``cuda`` unless the caller asks for
another device (real SB3's ``"auto"`` picks the card the same way). A rollout step
makes one host copy of the policy's outputs, a ``predict`` one of the action.
"""
from __future__ import annotations

import base64
import io
import json
import os
import pickle
import random
import zipfile
from collections import deque

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device


# ---------------------------------------------------------------------------
# Vectorized env (SB3 common/vec_env/dummy_vec_env.py subset, gymnasium API)
# ---------------------------------------------------------------------------

class DummyVecEnv:
    """Serial vectorization of gymnasium envs with SB3's SAME-STEP autoreset:
    ``step`` returns done = terminated | truncated, stores the pre-reset
    observation in ``info["terminal_observation"]`` and resets immediately."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seeds = [None] * self.num_envs

    def seed(self, seed=None):
        self._seeds = [None if seed is None else seed + i
                       for i in range(self.num_envs)]

    def reset(self):
        obs = []
        for env, s in zip(self.envs, self._seeds):
            o, _ = env.reset(seed=s)
            obs.append(o)
        self._seeds = [None] * self.num_envs  # seeds apply to the first reset only
        return np.stack(obs).astype(np.float32)

    def step(self, actions):
        obs, rews, dones, infos = [], [], [], []
        for env, act in zip(self.envs, actions):
            o, r, term, trunc, info = env.step(act)
            done = bool(term) or bool(trunc)
            if done:
                info = dict(info)
                info["terminal_observation"] = o
                info["TimeLimit.truncated"] = bool(trunc) and not bool(term)
                o, _ = env.reset()
            obs.append(o)
            rews.append(r)
            dones.append(done)
            infos.append(info)
        return (np.stack(obs).astype(np.float32),
                np.asarray(rews, np.float32),
                np.asarray(dones, bool), infos)

    def close(self):
        for env in self.envs:
            env.close() if hasattr(env, "close") else None


class SubprocVecEnv(DummyVecEnv):
    """The reference baseline uses SubprocVecEnv (train.py:155) purely for
    throughput; process isolation has no algorithmic effect, so the compat shim
    runs the same serial loop."""


# ---------------------------------------------------------------------------
# Callbacks (SB3 common/callbacks.py subset)
# ---------------------------------------------------------------------------

class BaseCallback:
    def __init__(self, verbose: int = 0):
        self.verbose = verbose
        self.model = None
        self.num_timesteps = 0
        self.n_calls = 0

    def init_callback(self, model):
        self.model = model
        self._init_callback()

    def _init_callback(self):
        pass

    def on_training_start(self):
        self.num_timesteps = self.model.num_timesteps
        self._on_training_start()

    def _on_training_start(self):
        pass

    def on_rollout_start(self):
        self._on_rollout_start()

    def _on_rollout_start(self):
        pass

    def on_step(self) -> bool:
        self.n_calls += 1
        self.num_timesteps = self.model.num_timesteps
        return self._on_step()

    def _on_step(self) -> bool:
        return True

    def on_rollout_end(self):
        self.num_timesteps = self.model.num_timesteps
        self._on_rollout_end()

    def _on_rollout_end(self):
        pass

    def on_training_end(self):
        self._on_training_end()

    def _on_training_end(self):
        pass


try:  # subclass the real SB3 callback base when stable_baselines3 is installed
    from stable_baselines3.common.callbacks import BaseCallback as _LoggerBase
except ImportError:
    _LoggerBase = BaseCallback


class TrainingLoggerCallback(_LoggerBase):
    """Learning-curve logger for the SB3 baseline leg (the role of the
    reference's utils/sb3_logger.py:4-26): record the rolling mean episode
    reward at each rollout boundary and persist the same ``{"steps": [...],
    "rewards": [...]}`` JSON schema every trainer in this framework emits, so
    ``utils.viz.eval_training`` can overlay all learning curves.

    Differences from the reference's callback: the curve is checkpointed to
    disk after every rollout via an atomic tmp+rename (the reference writes
    once at training end — a crash loses the whole multi-hour curve), and the
    accumulator is a single list of (step, reward) pairs serialized on write.
    """

    def __init__(self, save_path="data/training_info_sb3.json", verbose=0):
        super().__init__(verbose)
        self.save_path = save_path
        self._curve = []  # (global env step, mean episode reward) per rollout

    def _on_step(self) -> bool:
        return True

    def _on_rollout_end(self) -> None:
        rewards = [float(ep["r"]) for ep in self.model.ep_info_buffer]
        if rewards:
            self._curve.append((int(self.num_timesteps),
                                sum(rewards) / len(rewards)))
            self._write()

    def _on_training_end(self) -> None:
        self._write()

    @property
    def training_info(self):
        return {"steps": [s for s, _ in self._curve],
                "rewards": [r for _, r in self._curve]}

    def _write(self):
        try:
            os.makedirs(os.path.dirname(self.save_path) or ".", exist_ok=True)
            tmp = self.save_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.training_info, f, indent=2)
            os.replace(tmp, self.save_path)
        except OSError as e:
            print(f"Warning: could not save training data: {e}")


# ---------------------------------------------------------------------------
# MlpPolicy (SB3 common/policies.py ActorCriticPolicy subset for Box spaces)
# ---------------------------------------------------------------------------

def _ortho_tower(sizes, out_dim, out_gain):
    layers = []
    for i in range(len(sizes) - 1):
        lin = nn.Linear(sizes[i], sizes[i + 1])
        nn.init.orthogonal_(lin.weight, gain=float(np.sqrt(2)))
        nn.init.constant_(lin.bias, 0.0)
        layers += [lin, nn.Tanh()]
    head = nn.Linear(sizes[-1], out_dim)
    nn.init.orthogonal_(head.weight, gain=out_gain)
    nn.init.constant_(head.bias, 0.0)
    return nn.Sequential(*layers), head


class ActorCriticPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, net_arch=(64, 64)):
        super().__init__()
        sizes = [obs_dim, *net_arch]
        self.pi_tower, self.action_net = _ortho_tower(sizes, act_dim, 0.01)
        self.vf_tower, self.value_net = _ortho_tower(sizes, 1, 1.0)
        self.log_std = nn.Parameter(torch.zeros(act_dim))

    def _dist(self, obs):
        mu = self.action_net(self.pi_tower(obs))
        return torch.distributions.Normal(mu, torch.exp(self.log_std))

    def forward(self, obs):
        """(action_sampled_unclipped, value, log_prob) — collect_rollouts path."""
        dist = self._dist(obs)
        action = dist.sample()
        log_prob = dist.log_prob(action).sum(-1)
        value = self.value_net(self.vf_tower(obs)).squeeze(-1)
        return action, value, log_prob

    def evaluate_actions(self, obs, actions):
        dist = self._dist(obs)
        log_prob = dist.log_prob(actions).sum(-1)
        entropy = dist.entropy().sum(-1)
        value = self.value_net(self.vf_tower(obs)).squeeze(-1)
        return value, log_prob, entropy

    def predict_values(self, obs):
        return self.value_net(self.vf_tower(obs)).squeeze(-1)

    def act_deterministic(self, obs):
        return self.action_net(self.pi_tower(obs))


# ---------------------------------------------------------------------------
# PPO (SB3 ppo/ppo.py + common/on_policy_algorithm.py subset)
# ---------------------------------------------------------------------------

class PPO:
    def __init__(self, policy="MlpPolicy", env=None, learning_rate=3e-4,
                 n_steps=2048, batch_size=64, n_epochs=10, gamma=0.99,
                 gae_lambda=0.95, clip_range=0.2, ent_coef=0.0, vf_coef=0.5,
                 max_grad_norm=0.5, seed=None, verbose=0, device=None, **_):
        assert policy == "MlpPolicy", "sb3_compat implements MlpPolicy only"
        self.env = env
        self.learning_rate = learning_rate
        self.n_steps = n_steps
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip_range = clip_range
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.max_grad_norm = max_grad_norm
        self.device = resolve_device(device)
        self.num_timesteps = 0
        self.ep_info_buffer = deque(maxlen=100)
        self.seed = seed
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
            torch.manual_seed(seed)
            if env is not None:
                env.seed(seed)

        obs_dim = int(np.prod(env.observation_space.shape)) if env is not None else None
        act_dim = int(np.prod(env.action_space.shape)) if env is not None else None
        self._spaces = (obs_dim, act_dim,
                        None if env is None else env.action_space.low.copy(),
                        None if env is None else env.action_space.high.copy())
        if env is not None:
            self.policy = ActorCriticPolicy(obs_dim, act_dim).to(self.device)
            self.optimizer = torch.optim.Adam(self.policy.parameters(),
                                              lr=learning_rate, eps=1e-5)
        self._last_obs = None
        self._last_dones = None

    # ---- training ------------------------------------------------------------

    def learn(self, total_timesteps: int, callback=None, progress_bar=False,
              log_interval=None):
        if callback is not None:
            callback.init_callback(self)
            callback.on_training_start()
        n_envs = self.env.num_envs
        if self._last_obs is None:
            self._last_obs = self.env.reset()
            self._last_dones = np.zeros(n_envs, bool)

        while self.num_timesteps < total_timesteps:
            if callback is not None:
                callback.on_rollout_start()
            buf = self._collect_rollout(callback)
            if buf is None:  # callback requested stop
                break
            if callback is not None:
                callback.on_rollout_end()
            self._train_epochs(buf)
        if callback is not None:
            callback.on_training_end()
        return self

    def _collect_rollout(self, callback):
        n_envs = self.env.num_envs
        T = self.n_steps
        low, high = self._spaces[2], self._spaces[3]
        obs_b = np.zeros((T, n_envs) + self.env.observation_space.shape, np.float32)
        act_b = np.zeros((T, n_envs) + self.env.action_space.shape, np.float32)
        rew_b = np.zeros((T, n_envs), np.float32)
        start_b = np.zeros((T, n_envs), np.float32)  # episode_starts (prev dones)
        val_b = np.zeros((T, n_envs), np.float32)
        lp_b = np.zeros((T, n_envs), np.float32)

        for t in range(T):
            with torch.no_grad():
                obs_t = torch.as_tensor(self._last_obs, device=self.device)
                action, value, log_prob = self.policy(obs_t)
                # one host copy of the step's outputs
                host = torch.cat([action, value[:, None], log_prob[:, None]], 1).cpu().numpy()
            act_dim = action.shape[1]
            action = host[:, :act_dim]
            value, log_prob = host[:, act_dim], host[:, act_dim + 1]
            clipped = np.clip(action, low, high)
            new_obs, rewards, dones, infos = self.env.step(clipped)
            self.num_timesteps += n_envs

            for i, info in enumerate(infos):
                ep = info.get("episode")
                if ep is not None:
                    self.ep_info_buffer.append(
                        {"r": float(np.asarray(ep["r"]).item()),
                         "l": int(np.asarray(ep["l"]).item())})
                # timeout bootstrap (on_policy_algorithm.py): truncated-not-
                # terminated episodes add gamma * V(terminal_obs) to the reward
                if dones[i] and info.get("TimeLimit.truncated", False) \
                        and "terminal_observation" in info:
                    with torch.no_grad():
                        term_v = self.policy.predict_values(torch.as_tensor(
                            np.asarray(info["terminal_observation"],
                                       np.float32)[None], device=self.device))
                    rewards[i] += self.gamma * float(term_v.item())

            obs_b[t] = self._last_obs
            act_b[t] = action
            rew_b[t] = rewards
            start_b[t] = self._last_dones.astype(np.float32)
            val_b[t] = value
            lp_b[t] = log_prob
            self._last_obs = new_obs
            self._last_dones = dones
            if callback is not None and callback.on_step() is False:
                return None

        with torch.no_grad():
            last_values = self.policy.predict_values(
                torch.as_tensor(self._last_obs, device=self.device)).cpu().numpy()
        adv_b = np.zeros_like(rew_b)
        last_gae = np.zeros(n_envs, np.float32)
        for t in reversed(range(T)):
            if t == T - 1:
                next_non_terminal = 1.0 - self._last_dones.astype(np.float32)
                next_values = last_values
            else:
                next_non_terminal = 1.0 - start_b[t + 1]
                next_values = val_b[t + 1]
            delta = rew_b[t] + self.gamma * next_values * next_non_terminal - val_b[t]
            last_gae = delta + self.gamma * self.gae_lambda * next_non_terminal * last_gae
            adv_b[t] = last_gae
        ret_b = adv_b + val_b

        flat = lambda x: x.reshape((T * n_envs,) + x.shape[2:])
        return {k: torch.as_tensor(flat(v), device=self.device) for k, v in
                dict(obs=obs_b, actions=act_b, log_probs=lp_b,
                     advantages=adv_b, returns=ret_b).items()}

    def _train_epochs(self, buf):
        n = buf["obs"].shape[0]
        for _ in range(self.n_epochs):
            idx = torch.randperm(n, device=self.device)
            for s in range(0, n, self.batch_size):
                mb = idx[s:s + self.batch_size]
                values, log_prob, entropy = self.policy.evaluate_actions(
                    buf["obs"][mb], buf["actions"][mb])
                adv = buf["advantages"][mb]
                if len(mb) > 1:
                    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
                ratio = torch.exp(log_prob - buf["log_probs"][mb])
                p1 = adv * ratio
                p2 = adv * torch.clamp(ratio, 1 - self.clip_range, 1 + self.clip_range)
                policy_loss = -torch.min(p1, p2).mean()
                value_loss = F.mse_loss(buf["returns"][mb], values)
                entropy_loss = -entropy.mean()
                loss = (policy_loss + self.ent_coef * entropy_loss
                        + self.vf_coef * value_loss)
                self.optimizer.zero_grad()
                loss.backward()
                nn.utils.clip_grad_norm_(self.policy.parameters(), self.max_grad_norm)
                self.optimizer.step()

    # ---- inference / persistence --------------------------------------------

    def predict(self, observation, state=None, episode_start=None,
                deterministic=False):
        obs = np.asarray(observation, np.float32)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        with torch.no_grad():
            obs_t = torch.as_tensor(obs, device=self.device)
            if deterministic:
                action = self.policy.act_deterministic(obs_t).cpu().numpy()
            else:
                action = self.policy._dist(obs_t).sample().cpu().numpy()
        low, high = self._spaces[2], self._spaces[3]
        if low is not None:
            action = np.clip(action, low, high)
        return (action[0] if squeeze else action), state

    def save(self, path: str):
        path = str(path)
        if not path.endswith(".zip"):
            path = path + ".zip"  # match SB3's default suffixing
        obs_dim, act_dim, low, high = self._spaces
        torch.save({
            "sb3_compat": True,
            "obs_dim": obs_dim, "act_dim": act_dim, "low": low, "high": high,
            "policy_state_dict": self.policy.state_dict(),
            "num_timesteps": self.num_timesteps,
        }, path)

    @classmethod
    def load(cls, path: str, env=None, device=None, **_):
        """Load either format the baseline leg can encounter:

        - an sb3_compat checkpoint (torch pickle written by ``save`` above), or
        - a GENUINE stable_baselines3 2.x ``.zip`` archive (what the reference's
          ``model.save`` at train.py:188 produces and evaluate.py:124-171
          consumes) — parsed directly, no stable_baselines3 install needed.
        """
        path = str(path)
        if not os.path.exists(path) and not path.endswith(".zip"):
            path = path + ".zip"  # SB3 only ever suffixes, never doubles
        if _is_real_sb3_archive(path):
            return cls._load_sb3_archive(path, env=env, device=device)
        data = torch.load(path, map_location="cpu", weights_only=False)
        if not isinstance(data, dict) or not data.get("sb3_compat"):
            raise ValueError(
                f"{path} is neither an sb3_compat checkpoint nor a "
                f"stable_baselines3 .zip archive")
        model = cls("MlpPolicy", env=env, device=device)
        model._spaces = (data["obs_dim"], data["act_dim"], data["low"], data["high"])
        model.policy = ActorCriticPolicy(data["obs_dim"], data["act_dim"]).to(model.device)
        model.policy.load_state_dict(data["policy_state_dict"])
        model.num_timesteps = int(data.get("num_timesteps", 0))
        return model

    @classmethod
    def _load_sb3_archive(cls, path: str, env=None, device=None):
        """Parse a stable_baselines3 2.x zip archive (save_to_zip_file layout:
        a ``data`` JSON entry + ``policy.pth`` state dict) into a compat model.

        The MlpPolicy state-dict layout maps 1:1 onto the vendored
        ActorCriticPolicy: ``mlp_extractor.policy_net.*`` -> ``pi_tower.*``,
        ``mlp_extractor.value_net.*`` -> ``vf_tower.*``; ``action_net``/
        ``value_net``/``log_std`` keep their names; the (parameter-free)
        Flatten feature extractors are dropped.
        """
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            meta = json.loads(zf.read("data").decode("utf-8")) if "data" in names else {}
            state = torch.load(io.BytesIO(zf.read("policy.pth")),
                               map_location="cpu", weights_only=False)

        mapped, arch_sizes, vf_sizes = {}, {}, {}
        for k, v in state.items():
            if k.startswith("mlp_extractor.policy_net."):
                mapped["pi_tower." + k[len("mlp_extractor.policy_net."):]] = v
            elif k.startswith("mlp_extractor.value_net."):
                mapped["vf_tower." + k[len("mlp_extractor.value_net."):]] = v
            elif k.startswith(("action_net.", "value_net.")) or k == "log_std":
                mapped[k] = v
            elif "features_extractor" in k:
                continue  # FlattenExtractor: no parameters worth keeping
            else:
                raise ValueError(f"unsupported SB3 policy layout: key {k!r} "
                                 f"(sb3_compat implements MlpPolicy for Box only)")
            if k.startswith("mlp_extractor.policy_net.") and k.endswith(".weight"):
                arch_sizes[int(k.split(".")[2])] = v.shape[0]
            elif k.startswith("mlp_extractor.value_net.") and k.endswith(".weight"):
                vf_sizes[int(k.split(".")[2])] = v.shape[0]
        if "action_net.weight" not in mapped or not arch_sizes:
            raise ValueError(f"{path}: no MlpPolicy actor tower found in policy.pth")
        obs_dim = int(state["mlp_extractor.policy_net.0.weight"].shape[1])
        act_dim = int(mapped["action_net.weight"].shape[0])
        net_arch = tuple(arch_sizes[i] for i in sorted(arch_sizes))
        # dict net_arch (different pi/vf widths) would pass the key checks but
        # then fail load_state_dict with a raw shape mismatch — reject it with
        # the loader's explicit error instead
        vf_arch = tuple(vf_sizes[i] for i in sorted(vf_sizes))
        if vf_arch != net_arch:
            raise ValueError(
                f"unsupported SB3 policy layout: dict net_arch with distinct "
                f"pi {net_arch} / vf {vf_arch} towers (sb3_compat implements "
                f"the shared-width MlpPolicy layout only)")

        low, high = _decode_space_bounds(meta.get("action_space"), act_dim)
        model = cls("MlpPolicy", env=env, device=device)
        model._spaces = (obs_dim, act_dim, low, high)
        model.policy = ActorCriticPolicy(obs_dim, act_dim, net_arch=net_arch).to(model.device)
        model.policy.load_state_dict(mapped)
        model.num_timesteps = int(meta.get("num_timesteps", 0) or 0)
        return model


def _is_real_sb3_archive(path: str) -> bool:
    """True for a genuine SB3 save_to_zip_file archive. torch.save files are
    ALSO zipfiles (torch's zip serialization), so probe the member names: SB3
    writes top-level ``data`` + ``policy.pth``; torch writes ``*/data.pkl``."""
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
    except zipfile.BadZipFile:
        return False
    return "policy.pth" in names and "data" in names


def _decode_space_bounds(space_entry, act_dim: int):
    """Action-space bounds from the data JSON's serialized gymnasium Box.

    SB3 stores spaces as ``{":type:": ..., ":serialized:": base64(cloudpickle)}``;
    a Box pickles by value (plain numpy arrays), so ``pickle.loads`` restores it
    with gymnasium installed — no cloudpickle needed. Without gymnasium it falls
    back to [-1, 1]^d: the env's action bounds ([-1, 1] steering x [0, 1]
    throttle) are a subset, and predict() clipping to a superset is safe because
    the env clips the action itself."""
    try:
        box = pickle.loads(base64.b64decode(space_entry[":serialized:"]))
        return (np.asarray(box.low, np.float32), np.asarray(box.high, np.float32))
    except Exception:
        return (np.full((act_dim,), -1.0, np.float32),
                np.full((act_dim,), 1.0, np.float32))
