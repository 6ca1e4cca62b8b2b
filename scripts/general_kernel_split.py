#!/usr/bin/env python3
"""What holds the general route's MLP kernels back, on the card.

  python scripts/general_kernel_split.py [--kernels parent new] [--out FILE]

Builds stripped variants of the general route's minibatch kernels
(``mlp_general_forward_f32`` and ``mlp_general_backward_f32``, ``csrc/mlp_general.cu`` on
``csrc/mlp_stream.cuh``), each the source compiled with ``-DGENERAL_SPLIT_STOP=k``, and
times them in turns in CUDA graphs of 20 launches (``chip_smoke.graph_ms``: median of
21 replays, CUDA events) at the towers of ``TOWERS`` on ``chip_smoke.mlp_case``'s
inputs. Two sources:

- ``parent``: the first design of the general route (commit ``PARENT``: a tile of rows
  through the layers in one block, each weight streamed through shared memory in
  16-row chunks, the backward's weight gradients added on the block's partial row in
  device memory every 32-row tile), from ``git show`` or a ``git archive`` of it
  unpacked into the git-ignored ``scratch_checkout/PARENT/``; its split points are
  text anchors (``PARENT_EDITS``);
- ``new``: the port's ``csrc/mlp_general.cu``, whose ``// split: <kernel> <name>``
  lines mark its own split points.

The variants, each everything before its split point (the outputs then wrong):

  parent forward:  staged (the tile's observations in shared memory), layer1,
                   layer2, layer3 (the first hidden layers of each tower, no narrow
                   layer), no_split_b (the whole kernel with the B operand's TF32
                   hi/lo split left out: hi the raw bits, lo zero), full;
  parent backward: recompute (the tile's forward again and the narrow layer),
                   narrow (and g3, the last layer's gradients and g down to the last
                   hidden layer), no_dw (the whole kernel but the tensor-core weight
                   gradients x^T g), no_transposed (the whole kernel but the products
                   g W^T), no_split_b, full;
  new forward:     split_weights (the hidden weights' TF32 hi/lo pairs), layer1,
                   layer2, layer3 (the first hidden layers' launches), no_split (the
                   whole forward with the activations' split left out), full;
  new backward:    (on the activations the forward kept, as the minibatch step runs
                   it) top (the narrow rows: g3 and G_L), no_dw (all but the weight
                   gradients' launches), no_gprop (all but the products g W^T (1 -
                   h^2)), no_split, full, and the full backward that computes the
                   activations again (computing_again).

Every variant is timed twice, in order and then in reverse order; then the plain
composition once (cuBLAS: the forward in a graph, autograd's backward with its
forward eager and in a graph, ``chip_smoke.autograd_graph_ms``). Each source's
full forward and backward (with the source's own reduce) are first held to the
plain composition by phase p's rule (``chip_smoke.mlp_bounds``). Prints each build's
registers and spills (``-Xptxas -v``), each time, and one JSON line with the card's
name and power limit; ``--out`` also writes it to a file. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.ops import mlp as mlpops  # noqa: E402

# the commit of the general route's first design
PARENT = "de3da6f"
CSRC = "self_play_racing_tpu_torch/csrc"
# (towers, rows): chip_smoke.GENERAL_TIMED's
TOWERS = tuple((dims, 4095 if dims == (19, 1024, 1024) else 65_536)
               for dims in chip_smoke.GENERAL_TIMED)
PARENT_FORWARD = (("staged", 0), ("layer1", 1), ("layer2", 2), ("layer3", 3),
                  ("no_split_b", 98), ("full", 99))
PARENT_BACKWARD = (("recompute", 10), ("narrow", 11), ("no_dw", 12), ("no_transposed", 13),
                   ("no_split_b", 98), ("full", 99))
# the port's split points (its "// split: forward|backward|any <name>" lines)
NEW_FORWARD = (("split_weights", 0), ("layer1", 1), ("layer2", 2), ("layer3", 3),
               ("no_split", 98), ("full", 99))
NEW_BACKWARD = (("top", 11), ("no_dw", 12), ("no_gprop", 13), ("no_split", 98), ("full", 99))
TABLES = {"parent": (PARENT_FORWARD, PARENT_BACKWARD), "new": (NEW_FORWARD, NEW_BACKWARD)}
STOP = "#ifndef GENERAL_SPLIT_STOP\n#define GENERAL_SPLIT_STOP 99\n#endif\n"
# the parent's B fragments with the split left out at stop 98
NO_SPLIT_B = """
__device__ __forceinline__ mlp_tower::FragB frag_b_split(float b0, float b1) {
#if GENERAL_SPLIT_STOP == 98
    mlp_tower::FragB f;
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
    f.lo[0] = 0u;
    f.lo[1] = 0u;
    return f;
#else
    return mlp_tower::frag_b(b0, b1);
#endif
}
"""
# the parent's split points: file -> [(anchor, replacement, count)], each anchor found
# `count` times
PARENT_EDITS = {
    "mlp_stream.cuh": [
        ("mlp_tower::frag_b(", "frag_b_split(", 3),
        ("using mlp_tower::round_up;\n", "using mlp_tower::round_up;\n" + NO_SPLIT_B, 1),
        ("    for (int l = 0; l < s.hidden; ++l) {\n        stream_product<false>(p, in, out,",
         "    const int layers = GENERAL_SPLIT_STOP < 10 && GENERAL_SPLIT_STOP < s.hidden\n"
         "        ? GENERAL_SPLIT_STOP : s.hidden;\n"
         "    for (int l = 0; l < layers; ++l) {\n        stream_product<false>(p, in, out,", 1),
        ("    narrow_layer(p, in, s.dims[s.hidden], outputs,",
         "    if (GENERAL_SPLIT_STOP >= 10)\n"
         "    narrow_layer(p, in, s.dims[s.hidden], outputs,", 1),
    ],
    "mlp_general.cu": [
        ("        narrow_layer(p, act[L], K, O, w[L], b[L], O == 2, y, 0);\n"
         "        __syncthreads();\n",
         "        narrow_layer(p, act[L], K, O, w[L], b[L], O == 2, y, 0);\n"
         "        __syncthreads();\n"
         "        if (GENERAL_SPLIT_STOP == 10) continue;\n", 1),
        ("        // a hidden layer at a time, from the top\n",
         "        if (GENERAL_SPLIT_STOP == 11) continue;\n"
         "        // a hidden layer at a time, from the top\n", 1),
        ("            weight_grad(p, act[l], cur,",
         "            if (GENERAL_SPLIT_STOP != 12) weight_grad(p, act[l], cur,", 1),
        ("            if (l > 0) {\n                stream_product<true>",
         "            if (l > 0 && GENERAL_SPLIT_STOP != 13) {\n"
         "                stream_product<true>",
         1),
    ],
}


def parent_file(name: str):
    """``name`` (a file of ``csrc/``) at ``PARENT``: ``git show``, else the unpacked
    archive; None where neither is there."""
    try:
        return subprocess.run(["git", "show", f"{PARENT}:{CSRC}/{name}"], cwd=ROOT, check=True,
                              capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        pass
    path = os.path.join(ROOT, "scratch_checkout", PARENT, CSRC, name)
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return None


def source_files(kind: str) -> dict:
    """The files a build of ``kind`` compiles: mlp_general.cu and the headers, with
    the split points as ``if (GENERAL_SPLIT_STOP ...)`` lines."""
    names = ["mlp_general.cu"] + sorted(p.name for p in _cuda.CSRC_DIR.glob("*.cuh"))
    files = {}
    for name in names:
        text = (parent_file(name) if kind == "parent"
                else (_cuda.CSRC_DIR / name).read_text())
        if text is None:
            if name == "mlp_general.cu":
                raise RuntimeError(f"no source of {PARENT}: unpack `git archive {PARENT}` into "
                                   f"scratch_checkout/{PARENT}/")
            continue
        if kind == "parent":
            for anchor, replacement, count in PARENT_EDITS.get(name, ()):
                if text.count(anchor) != count:
                    raise RuntimeError(f"{name}: anchor found {text.count(anchor)} times, "
                                       f"expected {count}: {anchor!r}")
                text = text.replace(anchor, replacement)
        elif name == "mlp_general.cu":
            text = split_lines(text)
        if name in ("mlp_general.cu", "mlp_stream.cuh"):
            text = text.replace("#pragma once\n", "#pragma once\n" + STOP, 1) \
                if "#pragma once" in text else STOP + text
        files[name] = text
    return files


def split_lines(text: str) -> str:
    """The port's ``// split: <kernel> <name>[ <statement>]`` lines as ``if
    (GENERAL_SPLIT_STOP == k) <statement>`` (``return;`` by default)."""
    forward, backward = (dict(t) for t in TABLES["new"])
    out = []
    for line in text.splitlines(keepends=True):
        found = re.match(r"(\s*)// split: (forward|backward|any) (\w+)(.*)\n", line)
        if not found:
            out.append(line)
            continue
        indent, kernel, name, tail = found.groups()
        stops = [t[name] for k, t in (("forward", forward), ("backward", backward))
                 if kernel in (k, "any") and name in t]
        cond = " || ".join(f"GENERAL_SPLIT_STOP == {s}" for s in sorted(set(stops)))
        out.append(f"{indent}if ({cond}) {tail.strip() or 'return;'}\n")
    return "".join(out)


def build(kind: str, files: dict, stop: int):
    """One variant's library in a new temporary directory, bound as ``_cuda`` binds
    the port's; the compiler's report on ``.report``."""
    out_dir = tempfile.mkdtemp(prefix=f"general_{kind}_{stop}_")
    for name, text in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    out = os.path.join(out_dir, "mlp_general.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DGENERAL_SPLIT_STOP={stop}",
                           "-o", out, os.path.join(out_dir, "mlp_general.cu")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc {kind} {stop}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    lib.mlp_general_error_string.argtypes = [ctypes.c_int]
    lib.mlp_general_error_string.restype = ctypes.c_char_p
    if kind == "parent":
        # the first design's entries: the forward without a scratch, the plans
        lib.mlp_general_forward_f32.argtypes = [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.mlp_general_backward_f32.argtypes = [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p, ctypes.c_int] \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.mlp_general_plan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.mlp_general_plan.restype = ctypes.c_int
    lib.report = proc.stdout + proc.stderr
    return lib


def report(text: str) -> dict:
    """Registers, spill stores and shared bytes of each kernel in a report."""
    out, current = {}, None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            current = found.group(1)
            out[current] = {}
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("smem", r"(\d+) bytes smem")):
            value = re.search(pattern, line)
            if value and current:
                out[current][key] = int(value.group(1))
    return {re.sub(r"^_ZN\d+_mlp_general_cu_[0-9a-f]{8}\d+", "", k): v for k, v in out.items()}


def calls(kind: str, lib, obs, w, mu, v, g_mu, g_v, n: int, dims):
    """(forward, backward, reduce) of ``lib`` on the current stream, each build's own
    buffers; reduce writes the flat gradient."""
    dev = obs.device
    arr = _cuda._int_array(dims)
    params = sum(x.numel() for x in w)
    rows = lib.mlp_general_partial_rows(n, arr, len(dims))
    partial = torch.empty((rows, params), device=dev)
    flat = torch.empty((params,), device=dev)
    if kind == "parent":
        out = (ctypes.c_longlong * 10)()
        lib.mlp_general_plan(3, arr, len(dims), out)
        bwd_scratch = rows * 2 * out[9] if out[7] else 0
        fwd_scratch = 0
    else:
        # the minibatch step's way: the forward keeps its activations in the
        # backward's scratch where the backward's plan is one slab
        out = (ctypes.c_longlong * 10)()
        lib.mlp_general_gemm_plan(3, n, arr, len(dims), out)
        bwd_scratch, kept = out[8], int(out[7] == 1)
        lib.mlp_general_gemm_plan(0, n, arr, len(dims), out)
        fwd_scratch = out[8]
    scratch = (torch.empty((max(bwd_scratch, fwd_scratch),), device=dev)
               if max(bwd_scratch, fwd_scratch) else None)
    ptrs = [obs, None] + list(w)
    fwd_ptrs = _cuda._ptr_array(ptrs + [mu, v] + ([] if kind == "parent" else [scratch]))
    if kind != "parent":
        bwd_scratch = fwd_scratch = scratch.numel()
    bwd_ptrs = _cuda._ptr_array(ptrs + [g_mu, g_v, partial, scratch])
    keep = (obs, w, mu, v, g_mu, g_v, partial, flat, scratch, arr)

    def call(fn, *args):
        # the closure holds the tensors: a capture empties the allocator's cache
        assert keep
        err = getattr(lib, fn)(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: {lib.mlp_general_error_string(err).decode()}")

    if kind == "parent":
        return (lambda: call("mlp_general_forward_f32", fwd_ptrs, len(ptrs) + 2, n, 0, 0, arr,
                             len(dims)),
                lambda: call("mlp_general_backward_f32", bwd_ptrs, len(ptrs) + 4, n, 0, 0, arr,
                             len(dims), rows, params, bwd_scratch),
                lambda: call("general_grad_reduce_f32", _cuda._ptr(partial), _cuda._ptr(flat),
                             None, None, None, rows, params),
                flat, None)
    return (lambda: call("mlp_general_forward_f32", fwd_ptrs, len(ptrs) + 3, n, 0, 0, arr,
                         len(dims), fwd_scratch, kept),
            lambda: call("mlp_general_backward_f32", bwd_ptrs, len(ptrs) + 4, n, 0, 0, arr,
                         len(dims), rows, params, bwd_scratch, kept),
            lambda: call("general_grad_reduce_f32", _cuda._ptr(partial), _cuda._ptr(flat), None,
                         None, None, rows, params),
            flat,
            lambda: call("mlp_general_backward_f32", bwd_ptrs, len(ptrs) + 4, n, 0, 0, arr,
                         len(dims), rows, params, bwd_scratch, 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="*", default=["parent", "new"], choices=["parent", "new"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("general_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
        for kind in args.kernels:
            files = source_files(kind)
            stops = sorted({s for table in TABLES[kind] for _, s in table})
            for stop in stops:
                jobs[kind, stop] = pool.submit(build, kind, files, stop)
        libs = {k: f.result() for k, f in jobs.items()}
    result = {"card": card, "builds": {f"{k}_{s}": report(lib.report)
                                       for (k, s), lib in libs.items()}, "towers": {}}
    for key, value in result["builds"].items():
        print(f"build {key}: {value}")
    for dims, n in TOWERS:
        case = chip_smoke.mlp_case(dims[0], dims[1:], n, seed=7)
        params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, dev)
        w = [x.detach() for x in leaves]
        want = chip_smoke.mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs, g_mu, g_v)
        bounds = chip_smoke.mlp_bounds(want, chip_smoke.mlp_control(params, leaves, obs, g_mu,
                                                                    g_v))
        timed = []
        for kind in args.kernels:
            for part, table in zip(("forward", "backward"), TABLES[kind]):
                for name, stop in table:
                    mu, v = torch.empty((n, 2), device=dev), torch.empty((n,), device=dev)
                    fwd, bwd, red, flat, again = calls(kind, libs[kind, stop], obs, w, mu, v,
                                                       g_mu, g_v, n, dims)
                    if name == "full" and part == "backward":
                        fwd()
                        bwd()
                        red()
                        torch.cuda.synchronize()
                        sizes = [x.numel() for x in w]
                        got = [mu, v] + [g.view_as(x) for g, x in
                                         zip(torch.split(flat, sizes), w)]
                        errs = chip_smoke.mlp_errors(got, want)
                        if not all(e <= b for e, b in zip(errs, bounds)):
                            raise AssertionError(f"{kind} {dims}: beyond phase p's rule: "
                                                 f"{list(zip(errs, bounds))}")
                        print(f"{kind} {dims} x {n}: within phase p's rule (largest ratio "
                              f"{max(e / b for e, b in zip(errs, bounds) if b):.3f})")
                    if part == "backward":
                        # the backward on the kept activations needs the forward first
                        fwd()
                    timed.append((f"{kind}.{part}.{name}", fwd if part == "forward" else bwd))
                    if again is not None and part == "backward" and name == "full":
                        timed.append((f"{kind}.backward.computing_again", again))
        times = {k: [] for k, _ in timed}
        for order in (timed, timed[::-1]):
            for key, fn in order:
                times[key].append(chip_smoke.graph_ms(fn) * 1e3)
        # the cuBLAS composition in the same call: the forward in a graph, autograd's
        # backward (with its forward) eager and in a graph
        plain_f = lambda: mlpops.actor_critic_mlp_plain(params, obs)
        plain_b = lambda: torch.autograd.grad(mlpops.actor_critic_mlp_plain(params, obs),
                                              leaves, (g_mu, g_v))
        with torch.no_grad():
            times["composition.forward.graph"] = [chip_smoke.graph_ms(plain_f) * 1e3]
        times["composition.backward.eager"] = [chip_smoke.per_launch_ms(plain_b) * 1e3]
        in_graph = chip_smoke.autograd_graph_ms(plain_b)
        times["composition.backward.graph"] = [in_graph * 1e3 if in_graph else None]
        label = "x".join(map(str, dims)) + f"_{n}"
        result["towers"][label] = times
        for key, us in times.items():
            print(f"{label} {key}: " + ", ".join("-" if u is None else f"{u:.1f}" for u in us)
                  + " us")
        torch.cuda.empty_cache()
    print(f"card: {card}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
