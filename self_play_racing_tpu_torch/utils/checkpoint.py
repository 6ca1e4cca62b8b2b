"""Checkpoints: a tree of arrays in one ``.npz`` with a JSON sidecar for host state
(port of ``self_play_racing_tpu/utils/checkpoint.py``).

The files are the JAX package's, so checkpoints move both ways between the two
packages:

- Format v1 (current): leaf ``i`` is ``leaf_{i}``, named in ``leaf_names`` by its
  key path as ``jax.tree_util.keystr`` spells it (``['train'].opt_state[1].count``),
  with ``n_leaves`` and ``format_version``. A load matches the names against the
  template's, in order, then checks every leaf's shape and dtype.
- Format v0 (no ``format_version``): leaves by position, with the shape/dtype check
  as the only guard. The repo's ``models/checkpoint_update_*.npz`` are v0.
- ``<path without .npz>.meta.json`` holds the host state (``meta``).
- In a distributed run every process holds the same replicated state (the
  caller gathers tensor-parallel slices first): process 0 writes, the others wait
  at a barrier until the files are there, and every process loads them.

A tree is built from dicts (keys sorted, as JAX flattens them: ``['key']``),
lists and tuples (``[i]``) and ``Fields`` (named fields in their order, as a
dataclass or NamedTuple flattens: ``.name``); its leaves are numpy arrays or
tensors.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..parallel import mesh as pmesh

FORMAT_VERSION = 1


class Fields(dict):
    """A tree node whose entries flatten as attributes (``.name``), in insertion
    order: the layout of a JAX dataclass or NamedTuple."""


def flatten_with_names(tree, prefix=""):
    """[(keystr name, leaf)] in JAX's leaf order."""
    if isinstance(tree, Fields):
        return [item for k, v in tree.items()
                for item in flatten_with_names(v, f"{prefix}.{k}")]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_names(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def unflatten(template, leaves):
    """The template's structure holding ``leaves`` (an iterator, in leaf order)."""
    if isinstance(template, Fields):
        return Fields((k, unflatten(v, leaves)) for k, v in template.items())
    if isinstance(template, dict):
        out = {k: unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def _npz_path(path: str) -> str:
    if not path.endswith(".npz") and not os.path.exists(path):
        return path + ".npz"
    return path


def format_version(path: str) -> int:
    """0 for a legacy position-addressed file, ``FORMAT_VERSION`` for a
    name-addressed one."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        return int(data["format_version"]) if "format_version" in data else 0


def save_pytree(path: str, tree, meta: dict | None = None, mesh=None) -> None:
    """Save ``tree`` in format v1 and ``meta`` in the JSON sidecar. With a
    ``mesh`` (``parallel.mesh.DataMesh`` or ``TensorMesh``) process 0 writes and
    every process returns once the files are written."""
    if mesh is not None and mesh.process_rank != 0:
        pmesh.barrier(mesh)
        return
    _write_pytree(path, tree, meta)
    pmesh.barrier(mesh)


def _write_pytree(path: str, tree, meta):
    named = flatten_with_names(tree)
    host = [_host(leaf) for _, leaf in named]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, n_leaves=len(host), format_version=FORMAT_VERSION,
             leaf_names=np.asarray([name for name, _ in named]),
             **{f"leaf_{i}": x for i, x in enumerate(host)})
    if meta is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f)


def load_pytree(path: str, template):
    """(tree, meta): the arrays of ``path`` (numpy) in the structure of
    ``template``; ``meta`` is {} without a sidecar. Raises ``ValueError`` naming
    the mismatched paths (v1) or leaves (either format)."""
    path = _npz_path(path)
    tpl = flatten_with_names(template)
    with np.load(path, allow_pickle=False) as data:
        n = int(data["n_leaves"])
        if "format_version" in data:
            names = [str(s) for s in data["leaf_names"]]
            tpl_names = [name for name, _ in tpl]
            if names != tpl_names:
                missing = [nm for nm in tpl_names if nm not in names]
                extra = [nm for nm in names if nm not in tpl_names]
                detail = []
                if missing:
                    detail.append(f"  template paths missing from checkpoint: {missing}")
                if extra:
                    detail.append(f"  checkpoint paths unknown to template: {extra}")
                if not detail:
                    detail.append(f"  leaf order differs: checkpoint {names[:4]}... vs "
                                  f"template {tpl_names[:4]}...")
                raise ValueError(
                    f"checkpoint {path} (format v{int(data['format_version'])}) does not "
                    "match the template's tree:\n" + "\n".join(detail))
        elif n != len(tpl):
            raise ValueError(f"legacy (v0) checkpoint has {n} leaves but template "
                             f"expects {len(tpl)}")
        flat = [data[f"leaf_{i}"] for i in range(n)]
    mismatches = []
    for i, ((_, t), x) in enumerate(zip(tpl, flat)):
        t = _host(t)
        if t.shape != x.shape or t.dtype != x.dtype:
            mismatches.append(f"  leaf {i}: checkpoint {x.shape} {x.dtype} vs "
                              f"template {t.shape} {t.dtype}")
    if mismatches:
        raise ValueError(f"checkpoint {path} does not match the template (wrong "
                         "num_envs / pool_size / hidden sizes?):\n" + "\n".join(mismatches))
    meta = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return unflatten(template, iter(flat)), meta
