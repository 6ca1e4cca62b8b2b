#!/usr/bin/env python3
"""Times the MLP kernels' two designs of the backward on the card: recomputing each
tile's forward (the port's ``csrc/mlp_towers.cu``) against reading the h1 and h2
that the forward saved to device memory (``scripts/mlp_save_activations.cu``, which
shares the port's device code and is built here beside it).

  python scripts/mlp_save_vs_recompute.py [--out FILE]

At 65,536 rows (a minibatch of ``train scale`` and ``train single``), towers (64,
64), 19 and 15 inputs: checks that the two designs give the same mu, v and tile
partials bitwise, then times in CUDA graphs, in turns (recompute, save, save,
recompute), the forward alone, the backward alone and the pair forward + backward +
reduce, us a launch. Prints one JSON object, with the card's name and power limit
(and writes it to ``--out``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mlp_save_activations.cu")
ROWS = 65_536
TOWERS = ((19, 64, 64), (15, 64, 64))


def build() -> ctypes.CDLL:
    """The variant's library in the port's build directory (git-ignored)."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = str(_cuda.BUILD_DIR / "mlp_save_activations.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out, SOURCE], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.mlp_saved_floats.argtypes, lib.mlp_saved_floats.restype = [ctypes.c_longlong], \
        ctypes.c_longlong
    for fn in ("mlp_forward_saving_f32", "mlp_backward_saved_f32"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, fn: str, tensors, n: int, obs_dim: int, saved):
    ptrs = _cuda._ptr_array(tensors)

    def launch():
        err = getattr(lib, fn)(ptrs, len(tensors), n, obs_dim, saved.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: cuda error {err}")
    return launch


def compare(lib, dims, dev) -> dict:
    d, h1, h2 = dims
    n = ROWS
    case = chip_smoke.mlp_case(d, (h1, h2), n, seed=7)
    _, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, dev)
    w = [x.detach() for x in leaves]
    params = sum(x.numel() for x in w)
    out = {k: [torch.empty((n, 2), device=dev), torch.empty((n,), device=dev),
               torch.empty((_cuda.mlp_tiles(n), params), device=dev)]
           for k in ("recompute", "save")}
    flat = torch.empty((params,), device=dev)
    saved = torch.empty((lib.mlp_saved_floats(n),), device=dev)
    calls = {"recompute": (
        lambda: _cuda.launch_mlp_forward(obs, None, w, *out["recompute"][:2], n, dims),
        lambda: _cuda.launch_mlp_backward(obs, None, w, g_mu, g_v, out["recompute"][2], n,
                                          dims)),
        "save": (
        launcher(lib, "mlp_forward_saving_f32", [obs, None, *w, *out["save"][:2]], n, d, saved),
        launcher(lib, "mlp_backward_saved_f32", [obs, None, *w, g_mu, g_v, out["save"][2]], n,
                 d, saved))}
    for fwd, bwd in calls.values():
        fwd()
        bwd()
    torch.cuda.synchronize()
    if not all(chip_smoke.same_bits(a, b) for a, b in zip(out["recompute"], out["save"])):
        raise AssertionError(f"{dims}: the two designs differ")
    times = {k: {"forward": [], "backward": [], "pair": []} for k in calls}
    for k in ("recompute", "save", "save", "recompute"):
        fwd, bwd = calls[k]
        red = (lambda p=out[k][2]: _cuda.launch_mlp_grad_reduce(p, flat))
        times[k]["forward"].append(chip_smoke.graph_ms(fwd) * 1e3)
        times[k]["backward"].append(chip_smoke.graph_ms(bwd) * 1e3)
        times[k]["pair"].append(chip_smoke.graph_ms(lambda: (fwd(), bwd(), red())) * 1e3)
    return {"towers": list(dims), "rows": n, "saved_mib": saved.numel() * 4 / 2**20,
            "bitwise": True, "us_in_a_graph": times}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _cuda.build()
    lib = build()
    result = {"card": chip_smoke.card_line(), "designs": [compare(lib, dims, dev)
                                                          for dims in TOWERS]}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
