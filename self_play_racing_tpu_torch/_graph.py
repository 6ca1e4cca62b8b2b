"""CUDA graphs of the learner's steps: the port's counterpart of the JAX package's
one compiled update program (``self_play_racing_tpu/agent/ppo.py:1-14``).

A ``CapturedStep`` captures one run of a body function that reads and writes only
tensors allocated before the capture (its static buffers, which the caller owns
and loads), and ``replay`` launches that run again. ``StaticTree`` holds what a
graph reads of a tree of inputs: the caller's tensors in place where the caller
writes them in place, copies where it hands new ones. Capturing moves no state:

- warm-up runs come first (the first on the caller's stream, where the body's
  lazily allocated outputs are made, the rest on the capture stream, so that
  cuBLAS's handle and workspace for that stream exist); the caller reloads its
  static buffers after the capture, before the first replay;
- the registered generators (``torch.cuda.CUDAGraph.register_generator_state``)
  get the states they had before the warm-ups back; the capture itself leaves a
  registered generator's offset where it was, and each replay draws what an eager
  run from the generator's current state would draw, then advances it as far;
- the launch counters of the kernel wrappers (``ops/*.py``, every module integer
  named ``*_launches``) are set back to their values before the warm-ups. Those
  counters count at the Python wrapper, which a replay does not run: the counts
  that one run of the body adds during the capture are recorded and added once a
  replay, so the counters read what eager runs would have counted.

Collectives of an NCCL process group inside the body are captured as graph
nodes: the first warm-up, on the caller's stream, makes the group's communicator
(one a card, whichever stream issues), and the capture runs in
``capture_error_mode="thread_local"`` wherever a process group exists, since the
group's watchdog thread queries its events while this thread captures, which the
default mode forbids to every thread of the process. Every rank of the group must
capture, and replay, the same sequence of collectives.

A capture or a replay that fails raises; nothing falls back to eager. Graphs are
built only for CUDA tensors; the CPU never builds one.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from ._tree import tree_map

WARMUP_RUNS = 3


def _counter_modules():
    from .envs import multi
    from .ops import dynamics, gae, geometry, minibatch, prng
    return (geometry, dynamics, gae, prng, multi, minibatch)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by (module, name)."""
    return {(m, name): value for m in _counter_modules()
            for name, value in vars(m).items()
            if name.endswith("_launches") and isinstance(value, int)}


def _set_counts(counts: dict) -> None:
    for (module, name), value in counts.items():
        setattr(module, name, value)


@functools.lru_cache(maxsize=None)
def _capture_stream(device_index: int) -> torch.cuda.Stream:
    """The side stream of every warm-up and capture on one card. One for the
    process: cuBLAS keeps a workspace for each stream it has run on until the
    process ends, so a new stream for each capture would leak one."""
    return torch.cuda.Stream(device=device_index)


class CapturedStep:
    """``body`` (no arguments, reading and writing static buffers) captured as a
    CUDA graph on ``device``, with ``generators`` (CUDA ``torch.Generator``s the
    body draws from) registered. ``rewind`` (no arguments) runs after each warm-up
    run: it sets back what indexes the body's buffers (a step counter), so that the
    warm-ups stay inside them. ``launches`` maps each kernel counter to what one
    replay adds; ``pool_bytes`` is the memory the capture reserved for the graph's
    private pool (the tensors the body makes and frees inside the graph)."""

    def __init__(self, body, device: torch.device, generators, rewind):
        if device.type != "cuda":
            raise ValueError(f"CapturedStep: CUDA graphs need a CUDA device, got {device}")
        before = launch_counts()
        states = [g.get_state() for g in generators]
        caller = torch.cuda.current_stream(device)
        stream = _capture_stream(torch.cuda.current_device() if device.index is None
                                 else device.index)
        try:
            body()
            rewind()
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_RUNS - 1):
                    body()
                    rewind()
            caller.wait_stream(stream)
            for g, state in zip(generators, states):
                g.set_state(state)
            counted = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            grouped = dist.is_available() and dist.is_initialized()
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local" if grouped else "global"):
                # entering the capture empties the allocator's cache: count from here
                reserved = torch.cuda.memory_reserved(device)
                body()
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            after = launch_counts()
        finally:
            _set_counts(before)
        self.launches = {k: after[k] - counted[k] for k in after if after[k] != counted[k]}

    def replay(self, times: int = 1) -> None:
        """Launch the captured run ``times`` times on the current stream."""
        for _ in range(times):
            self.graph.replay()
        for (module, name), n in self.launches.items():
            setattr(module, name, getattr(module, name) + n * times)


# ----------------------------------------------------- static buffers of a tree

def signature(tree):
    """What a captured graph fixes about ``tree``: its structure, each tensor's
    shape, dtype and device, and every other leaf by identity (generators) or
    value (ints, None). Two trees with one signature can share static buffers."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple((f.name, signature(getattr(tree, f.name)))
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return (dict,) + tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(signature(v) for v in tree)
    if isinstance(tree, torch.Generator):
        return ("generator", id(tree))
    return ("value", tree)


def tensor_leaves(tree, place=()):
    """(place, tensor) of every tensor of ``tree`` in ``tree_map``'s order, a
    place being the path of field names, keys and indices that leads to it."""
    if isinstance(tree, torch.Tensor):
        return [(place, tree)]
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return []
    return [leaf for k, v in items for leaf in tensor_leaves(v, place + (k,))]


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class StaticTree:
    """What a captured graph reads of a tree of inputs (``tree``): each tensor is
    the caller's own, read in place, except at the places in ``copied``, where it
    is a copy the graph owns and ``load`` refreshes. A tensor the caller writes in
    place between replays (the self-play pool's stacked snapshots) is read as it
    is; one the caller replaces with a new tensor (a new opponent draw) must be
    copied: ``moved`` finds those places, and the graph is captured again with
    them in ``copied``."""

    def __init__(self, tree, copied):
        self.copied = frozenset(copied)
        places = iter(tensor_leaves(tree))
        self.tree = tree_map(
            lambda t: t.clone() if next(places)[0] in self.copied else t, tree)

    def moved(self, tree) -> frozenset:
        """The places read in place where ``tree`` (of this tree's signature)
        holds another tensor."""
        mine = dict(tensor_leaves(self.tree))
        return frozenset(p for p, t in tensor_leaves(tree)
                         if p not in self.copied and not _same_memory(mine[p], t))

    def load(self, tree) -> None:
        """Copy ``tree``'s tensors at the copied places into the graph's copies."""
        mine = dict(tensor_leaves(self.tree))
        for p, t in tensor_leaves(tree):
            if p in self.copied and not _same_memory(mine[p], t):
                mine[p].copy_(t)


def clone_tree(tree):
    """A copy of ``tree`` whose tensors are new buffers (other leaves shared)."""
    return tree_map(lambda t: t.clone(), tree)


def load_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the static buffer at its place in ``dst``
    (same signature); a leaf that already is that buffer's memory is skipped."""
    def load(d, s):
        if not _same_memory(d, s):
            d.copy_(s)
        return d

    tree_map(load, dst, src)
