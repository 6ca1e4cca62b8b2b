"""Builds of variants of the MLP kernels' source (``csrc/mlp_towers.cu``) beside the
port's, for the scripts that time them against each other on the card
(``scripts/mlp_kernel_split.py``, ``scripts/mlp_backward_plans.py``): the source of
the FFMA kernels the tensor-core ones replaced, a build of any source text with the
port's flags, and launches of a build's three entry points as ``ops/_cuda.py``
launches the port's.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

import torch

from self_play_racing_tpu_torch.ops import _cuda


# the commit whose MLP kernels (the FFMA design, a block a tower and a 128-row tile)
# the tensor-core kernels replaced
PARENT_MLP = "e8016a7"
MLP_SOURCE = "self_play_racing_tpu_torch/csrc/mlp_towers.cu"


def parent_mlp_source():
    """The MLP kernels' source at ``PARENT_MLP``: from ``git show`` where the
    checkout has its history, else from a ``git archive`` of that commit unpacked into
    the git-ignored ``scratch_checkout/PARENT_MLP/``; None where neither is there."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        return subprocess.run(["git", "show", f"{PARENT_MLP}:{MLP_SOURCE}"], cwd=root,
                              check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        pass
    path = os.path.join(root, "scratch_checkout", PARENT_MLP, MLP_SOURCE)
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return None


def build_mlp_lib(text: str, tag: str, defines=(), out_dir=None):
    """``text`` (an MLP kernels' source) compiled with the port's flags into
    ``out_dir`` (a new temporary directory by default), loaded, its entry points
    bound as ``_cuda`` binds them; the compiler's report on ``.report``."""
    import ctypes

    out_dir = out_dir or tempfile.mkdtemp(prefix="mlp_variant_")
    src = os.path.join(out_dir, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(out_dir, f"{tag}.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                           "-o", out, src], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _cuda._SIGNATURES.items():
        if fn.startswith("mlp_") and hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    lib.report = proc.stdout + proc.stderr
    return lib


def lib_partial_rows(lib, n: int) -> int:
    """The rows of ``lib``'s backward partials at ``n`` rows (the FFMA kernels': a row a
    128-row tile)."""
    if hasattr(lib, "mlp_partial_rows"):
        return lib.mlp_partial_rows(n)
    return -(-n // lib.mlp_rows_per_tile())


def mlp_lib_calls(lib, obs, unit_ids, w, mu, v, g_mu, g_v, n: int, dims):
    """(forward, backward, reduce) launches of ``lib``'s three entry points on the
    current stream, as ``_cuda.launch_mlp_*`` launch the port's, with their own
    partials buffer."""
    dev = obs.device
    params = sum(x.numel() for x in w)
    partial = torch.empty((lib_partial_rows(lib, n), params), device=dev)
    flat = torch.empty((params,), device=dev)
    ptrs, block, units = _cuda._mlp_inputs(obs, unit_ids, w)
    fwd_ptrs = _cuda._ptr_array(ptrs + [mu, v])
    bwd_ptrs = _cuda._ptr_array(ptrs + [g_mu, g_v, partial])

    keep = (obs, unit_ids, w, mu, v, g_mu, g_v, partial, flat)

    def call(fn, *args):
        # the closure holds the tensors: a CUDA graph's capture empties the
        # allocator's cache, so a freed buffer's pointer would dangle
        assert keep
        err = getattr(lib, fn)(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")

    return (lambda: call("mlp_forward_f32", fwd_ptrs, _cuda.MLP_INPUTS + 2, n, block, units,
                         *dims),
            lambda: call("mlp_backward_f32", bwd_ptrs, _cuda.MLP_INPUTS + 3, n, block, units,
                         *dims),
            lambda: call("mlp_grad_reduce_f32", _cuda._ptr(partial), _cuda._ptr(flat),
                         partial.shape[0], partial.shape[1]))
