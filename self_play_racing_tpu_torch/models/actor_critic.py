"""Actor-critic MLP with an externally annealed log-std (port of
``self_play_racing_tpu/models/actor_critic.py``).

 - actor:  Linear(obs,64)-Tanh-Linear(64,64)-Tanh-Linear(64,act)-Tanh  (mu head)
 - critic: Linear(obs,64)-Tanh-Linear(64,64)-Tanh-Linear(64,1)
 - orthogonal init, gain sqrt(2) hidden / 0.01 actor-out / 1.0 critic-out, zero bias
 - ``log_std`` is not a learned parameter: it is a buffer the trainer anneals.

Actions are sampled from an unbounded Normal, clamped to [-1, 1], and the log-prob
of the clamped value is taken under the same Normal (no tanh Jacobian).

Parameters are the JAX package's layout, ``{"actor": [(w, b), ...], "critic":
[(w, b), ...]}`` with ``w`` stored (in, out), so a layer is ``x @ w + b``. The
functions below take that dict; ``ActorCritic`` is the ``nn.Module`` that owns it.
``sample_action`` takes its standard-normal noise as an argument (``sample_noise``
draws it from a ``torch.Generator``), so tests can feed both packages one stream.
"""
from __future__ import annotations

import math

import torch
from torch import nn

HIDDEN = 64
_LOG_2PI = math.log(2.0 * math.pi)


def init_params(generator: torch.Generator, obs_dim: int, action_dim: int,
                dtype=torch.float32, hidden=(HIDDEN, HIDDEN), device=None):
    """Orthogonally initialized parameter dict (weights (in, out), zero biases).
    ``generator`` lives on the CPU; the parameters are moved to ``device``."""
    hidden = tuple(hidden)
    sq2 = math.sqrt(2.0)

    def layer(din, dout, gain):
        w = torch.empty((din, dout), dtype=dtype)
        nn.init.orthogonal_(w, gain=gain, generator=generator)
        return w.to(device), torch.zeros((dout,), dtype=dtype, device=device)

    def tower(out_dim, out_gain):
        dims = (obs_dim,) + hidden
        layers = [layer(din, dout, sq2) for din, dout in zip(dims[:-1], dims[1:])]
        layers.append(layer(dims[-1], out_dim, out_gain))
        return layers

    return {"actor": tower(action_dim, 0.01), "critic": tower(1, 1.0)}


def _mlp(layers, x, final_tanh: bool):
    x = x.to(layers[0][0].dtype)  # f32 obs into f64 params promote, as in JAX
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1 or final_tanh:
            x = torch.tanh(x)
    return x


def actor_mu(params, obs):
    """Mean of the action distribution, tanh-bounded to (-1, 1)."""
    return _mlp(params["actor"], obs, final_tanh=True)


def critic_value(params, obs):
    """State value, shape obs.shape[:-1]."""
    return _mlp(params["critic"], obs, final_tanh=False)[..., 0]


def normal_log_prob(action, mu, log_std):
    """Sum over action dims of Normal(mu, exp(log_std)).log_prob(action)."""
    var = torch.exp(2.0 * log_std)
    lp = -((action - mu) ** 2) / (2.0 * var) - log_std - 0.5 * _LOG_2PI
    return lp.sum(dim=-1)


def normal_entropy(log_std, action_dim: int, batch_shape):
    """Sum over action dims of Normal entropy: 0.5 + 0.5*log(2*pi) + log_std."""
    ent = (0.5 + 0.5 * _LOG_2PI + log_std).sum()
    return ent.expand(batch_shape)


def sample_noise(shape, generator: torch.Generator, dtype=torch.float32, device=None):
    """Standard-normal noise for ``sample_action``; ``generator`` must live on
    ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def sample_action(params, log_std, obs, noise):
    """(action, log_prob, value): ``mu + exp(log_std) * noise`` clamped to [-1, 1],
    and the log-prob of the clamped action."""
    mu = actor_mu(params, obs)
    action = torch.clamp(mu + torch.exp(log_std) * noise, -1.0, 1.0)
    return action, normal_log_prob(action, mu, log_std), critic_value(params, obs)


def deterministic_action(params, obs):
    """Greedy action = tanh-bounded mu."""
    return actor_mu(params, obs)


class ActorCritic(nn.Module):
    """The actor-critic as an ``nn.Module``: owns the parameter dict's tensors
    (weights (in, out)) and the ``log_std`` buffer."""

    def __init__(self, params, log_std):
        super().__init__()
        self.actor = nn.ParameterList([t for layer in params["actor"] for t in layer])
        self.critic = nn.ParameterList([t for layer in params["critic"] for t in layer])
        self.register_buffer("log_std", torch.as_tensor(log_std))

    def params(self):
        """The parameter dict the functions of this module take."""
        def pairs(plist):
            return [(plist[i], plist[i + 1]) for i in range(0, len(plist), 2)]
        return {"actor": pairs(self.actor), "critic": pairs(self.critic)}

    def forward(self, obs):
        """(mu, value) for a batch of observations."""
        p = self.params()
        return actor_mu(p, obs), critic_value(p, obs)


def params_from_torch_state_dict(state_dict, dtype=torch.float32, device=None):
    """(params, log_std) from an ``Agent.state_dict()`` of the original torch
    implementation, or a path to one. Linear weights (out, in) are transposed.
    A full training checkpoint (a dict holding ``agent_state_dict``) is accepted
    too and its agent state is read."""
    if isinstance(state_dict, (str, bytes)):
        state_dict = torch.load(state_dict, map_location="cpu")
    if "agent_state_dict" in state_dict:
        state_dict = state_dict["agent_state_dict"]

    def arr(t):
        return torch.as_tensor(t).detach().to(dtype=dtype, device=device)

    def seq(prefix):
        # Linear layers sit at Sequential slots 0, 2, 4, ... (Tanh between each)
        slots = sorted(int(k.split(".")[1]) for k in state_dict
                       if k.startswith(f"{prefix}.") and k.endswith(".weight"))
        return [(arr(state_dict[f"{prefix}.{i}.weight"]).T.contiguous(),
                 arr(state_dict[f"{prefix}.{i}.bias"])) for i in slots]

    params = {"actor": seq("actor_mu"), "critic": seq("critic")}
    return params, arr(state_dict["log_std"])


def params_to_torch_state_dict(params, log_std):
    """Inverse of ``params_from_torch_state_dict``: CPU tensors, weights (out, in)."""
    out = {}
    for name, key in (("actor_mu", "actor"), ("critic", "critic")):
        for layer_idx, (w, b) in enumerate(params[key]):
            slot = 2 * layer_idx  # Tanh occupies every odd Sequential slot
            out[f"{name}.{slot}.weight"] = w.detach().T.contiguous().cpu()
            out[f"{name}.{slot}.bias"] = b.detach().clone().cpu()
    out["log_std"] = torch.as_tensor(log_std).detach().clone().cpu()
    return out
