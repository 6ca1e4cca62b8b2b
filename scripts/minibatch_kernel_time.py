#!/usr/bin/env python3
"""Times the PPO minibatch step's two kernels (``ops/minibatch.py``: ``ppo_head`` and
``adam_tail``) on the card, and the graphed minibatch step with the loss head's fields
read through the unit index against the same step with every field gathered.

  python scripts/minibatch_kernel_time.py            # everything below
  python scripts/minibatch_kernel_time.py --eager-tail

Prints one JSON object, with the card's name and power limit:

- ``head``: at 65,536 and 16,384 rows, the forward and the backward, us a launch in
  a CUDA graph, on gathered rows and through the unit index;
- ``tail_widths``: the tail's one cluster on the (64, 64) policy (12 tensors, 11,075
  floats) and wider ones, us in a graph beside the byte bound, to show where one
  cluster stops keeping up;
- ``step``: ``_MinibatchGraph`` at ``train scale``'s width (4096 x 256, minibatches
  of 65,536 rows), us a replay, in turns (unit index, gathered, gathered, unit
  index), and the kernels one eager step launches each way (``torch.profiler``);
- ``eager_tail`` (alone with ``--eager-tail``): ``mbops.adam_tail`` eager back to
  back, the wrapper's host work included; this part uses only what the parent
  checkout has, so a copy of the script runs there too.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.agent import ppo  # noqa: E402
from self_play_racing_tpu_torch.configs import base_config  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.ops import minibatch as mbops  # noqa: E402

TAIL_WIDTHS = [(64, 64), (128, 128), (256, 256), (512, 512), (1024, 1024)]


def time_head(dev) -> dict:
    rng = chip_smoke.np.random.default_rng(5)
    consts = mbops._head_constants(chip_smoke.HEAD_CLIP)
    out = {}
    for n in chip_smoke.MINIBATCH_ROWS:
        t = chip_smoke.head_tensors(chip_smoke.crafted_minibatch(n, rng), dev)
        u = chip_smoke.unit_case(n, rng, dev)
        args = [t[k].detach() for k in chip_smoke.HEAD_ARGS]
        u_args, ids = [u[k].detach() for k in chip_smoke.HEAD_ARGS], u["unit_ids"]
        outs = [torch.empty((n,), device=dev) for _ in range(4)]
        g_mu, g_v = torch.empty((n, 2), device=dev), torch.empty((n,), device=dev)
        up = torch.full((n,), 1.0 / n, device=dev)
        calls = {
            "forward": lambda: _cuda.launch_ppo_head_forward(args, consts, outs, n),
            "forward_by_id": lambda: _cuda.launch_ppo_head_forward(u_args, consts, outs, n,
                                                                   ids),
            "backward": lambda: _cuda.launch_ppo_head_backward(args, consts, up, 1, up, 1,
                                                               g_mu, g_v, n),
            "backward_by_id": lambda: _cuda.launch_ppo_head_backward(
                u_args, consts, up, 1, up, 1, g_mu, g_v, n, ids)}
        out[n] = {k: chip_smoke.graph_ms(f) * 1e3 for k, f in calls.items()}
    return out


def tail_call(state):
    """``mbops.adam_tail`` on ``state`` (``chip_smoke.tail_state``), every call an
    applied step."""
    params, grads, mu, nu, bc1, bc2, loop = state
    dev = params[0].device
    stats = [torch.tensor(x, device=dev) for x in (0.31, -0.02, 0.45, 1.9, 0.001, 0.11)]
    lr = torch.tensor(2.5e-4, device=dev)
    g_norm = ppo.global_norm(grads)
    return lambda: mbops.adam_tail(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop,
                                   0.5, 0.02)


def fresh_tail(dev, hidden=(64, 64)):
    state = chip_smoke.tail_state(dev, 6, hidden=hidden, steps=4096)
    return state, tail_call(state)


def time_tail_widths(dev) -> list:
    rows = []
    for hidden in TAIL_WIDTHS:
        state, call = fresh_tail(dev, hidden)
        elements = sum(p.numel() for p in state[0])
        rows.append({"hidden": hidden, "elements": elements,
                     "graph_us": chip_smoke.graph_ms(call) * 1e3,
                     "bound_us": chip_smoke.bound_ms(7 * 4 * elements,
                                                     elements * chip_smoke.TAIL_OPS)[0] * 1e3})
    return rows


def eager_tail(dev) -> dict:
    state, call = fresh_tail(dev)
    windows = [chip_smoke.per_launch_ms(call) * 1e3 for _ in range(5)]
    return {"eager_us": windows, "graph_us": chip_smoke.graph_ms(call) * 1e3}


def step_graph(cfg, dev, gathered: bool):
    """A ``_MinibatchGraph`` over random units at ``cfg``'s width, captured with
    ``minibatch_step`` or with ``chip_smoke.gathered_minibatch_step``, and the inputs
    and optimizer state to load into it."""
    train, inputs = chip_smoke.minibatch_inputs(cfg, dev)
    steps = inputs[3].shape[0]
    patch = (chip_smoke._patched(ppo, minibatch_step=chip_smoke.gathered_minibatch_step)
             if gathered else contextlib.nullcontext())
    with patch:
        graph = ppo._MinibatchGraph(cfg, train.model, inputs, train.opt_state, key=None)
        launches = count_launches(lambda: ppo.minibatch_step(
            cfg, train.model, *inputs, [m.clone() for m in train.opt_state.mu],
            [v.clone() for v in train.opt_state.nu], ppo.MinibatchLoop.zeros(steps, dev)))
    return graph, inputs, train.opt_state, launches


def count_launches(fn) -> int:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def time_step(graph, inputs, opt_state, windows: int = 5) -> float:
    """us a replay of the captured minibatch step over whole updates (the loop reset
    before each, every step applied): the median of ``windows``."""
    steps = inputs[3].shape[0]
    times = []
    for _ in range(windows + 1):
        graph.load(inputs, opt_state)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.step.replay(steps)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / steps)
    if int(graph.loop.i) != steps:
        raise AssertionError(f"the minibatch graph ran {int(graph.loop.i)} of {steps} steps")
    return statistics.median(times[1:])


def time_steps(dev) -> dict:
    cfg = base_config(num_envs=chip_smoke.NUM_ENVS, num_steps=chip_smoke.STEPS,
                      kl_target=float("inf"))
    made = {name: step_graph(cfg, dev, name == "gathered") for name in ("unit_index", "gathered")}
    turns = {"unit_index": [], "gathered": []}
    for name in ("unit_index", "gathered", "gathered", "unit_index"):
        turns[name].append(time_step(*made[name][:3]))
    return {"us_a_replay": turns,
            "eager_launches_a_step": {k: v[3] for k, v in made.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--eager-tail", action="store_true",
                   help="only the tail's eager time (runs on the parent checkout too)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("minibatch_kernel_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _cuda.build()
    out = {"card": chip_smoke.card_line(), "eager_tail": eager_tail(dev)}
    if not args.eager_tail:
        out["head"] = time_head(dev)
        out["tail_widths"] = time_tail_widths(dev)
        out["step"] = time_steps(dev)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
