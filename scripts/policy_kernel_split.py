#!/usr/bin/env python3
"""What holds the rollout policy's two kernels back, on the card.

  python scripts/policy_kernel_split.py [--kernels parent new] [--variants] [--sweep]
      [--out FILE]

Builds stripped variants of ``policy_act_f32`` (kernel A) and ``pool_act_f32``
(kernel B), each source compiled with an early exit at one split point
(``-DPOLICY_SPLIT_STOP=k``), and times them in turns in CUDA graphs of 20 launches
(``chip_smoke.graph_ms``: median of 21 replays, CUDA events) through the port's
wrappers (``ops/policy.py``, the variant's library routed in for the measurement)
at 4096 rows of towers (19, 64, 64) and (15, 64, 64), with the normaliser. Two
sources:

- ``parent``: the kernels these replaced, commit ``PARENT``'s ``csrc/policy.cu`` with
  its two headers (``git show`` where the checkout has its history, else a ``git
  archive`` of it unpacked into the git-ignored ``scratch_checkout/PARENT/``);
- ``new``: the port's ``csrc/policy.cu`` (its ``// split:`` lines are the stops).

The split points, each variant everything before it:

  A: staged - the towers and the tile's observations in shared memory;
     layer1 - and the first hidden layer; layer2 - and the second;
     towers - and the last layers (mu and v, nothing written); full - the kernel.
  B: packed - (new only) the range's rows of the block's member taken, the uniform
     actions and car 0 written; staged, layer1, layer2 as A's; full.

The new kernels are also timed without the hidden layers' tanh (``no_tanh``: the
full kernel with ``bias_tanh`` adding the bias alone; the outputs wrong), its
marginal cost.

Kernel A runs ``rollout_sample`` (the rollout step's launch); kernel B the self-play
step's ``pool_act`` (one opponent seat, a pool of ``chip_smoke.POOL_MEMBERS`` per env,
the learner's action as car 0) at the member distributions of
``chip_smoke.POOL_DISTRIBUTIONS`` that the trainer's path meets (uniform, skewed, two
live; use_policy all True) and phase q's mixed ``use_policy`` (``mixed``).

``--variants`` also times builds of the new source with other constants
(``VARIANTS``: kernel A's warps a fragment, kernel B's range, warps and split).
``--sweep`` instead times only the full kernels, parent, new (and with
``--variants`` the kernel's variants), then in reverse order, at
``chip_smoke.POLICY_TOWERS`` x 1, 64, 4096 and 8192 rows (B per env, phase q's case).
Every source's and variant's full kernels are first held bitwise to the other's on
each case (the outputs and the buffers). Prints each variant's registers (``-Xptxas
-v``), the times, and one JSON line with the card's name and power limit; ``--out``
also writes it to a file. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.envs import selfplay  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.ops import policy as polops  # noqa: E402

# the commit whose policy kernels (a block a member on every tile, staging a float a
# copy, a warp a tower) the redesigned ones replaced
PARENT = "da1d74d"
FILES = ("policy.cu", "mlp_tower.cuh", "normal_lp.cuh")
ROWS = 4096
TOWERS = ((19, 64, 64), (15, 64, 64))
SWEEP_ROWS = (1, 64, 4096, 8192)
ACT_STOPS = (("staged", 0), ("layer1", 1), ("layer2", 2), ("towers", 3), ("full", 99))
POOL_STOPS = (("staged", 0), ("layer1", 1), ("layer2", 2), ("full", 99))
POOL_NEW_STOPS = (("packed", 4),)
# the new kernels also without one part (its marginal cost; the outputs wrong): the
# hidden layers' tanh (mlp_tower.cuh's bias_tanh, `// split: any no_tanh`)
WITHOUT = (("no_tanh", 5),)
# builds of the new source with other constants: kernel A's warps on a fragment of a
# tower, kernel B's range, warps and warps on a fragment
VARIANTS = {
    "act_split2": {"kActSplit": 2},
    "act_narrow_only": {"kActWideRows": 32, "kActWideSplit": 4},
    "act_wide_split2": {"kActWideSplit": 2},
    "pool_split1": {"kPoolSplit": 1},
    "pool_range256": {"kPoolRange": 256},
    "pool_warps4": {"kPoolWarps": 4},
}
PRELUDE = """#ifndef POLICY_SPLIT_STOP
#define POLICY_SPLIT_STOP 99
#endif
// what a stripped variant computed, kept so that the compiler does not drop it
__device__ float policy_split_sink;
template <int NJ>
__device__ __forceinline__ void sink(const float (&v)[NJ][4]) {
    float s = 0.0f;
    for (int j = 0; j < NJ; ++j)
        for (int e = 0; e < 4; ++e) s += v[j][e];
    if (s == 1234.5f) policy_split_sink = s;
}
__device__ __forceinline__ void sink(const float (&a)[2], const float (&b)[2]) {
    if (a[0] + a[1] + b[0] + b[1] == 1234.5f) policy_split_sink = a[0];
}
"""
# the parent's split points: (anchor, replacement) in its policy.cu, each found once
PARENT_EDITS = [
    ("    cp_async_wait_all();\n    __syncthreads();\n    const int warp = threadIdx.x >> 5, tower",
     "    cp_async_wait_all();\n    __syncthreads();\n    if (POLICY_SPLIT_STOP == 0) return;\n"
     "    const int warp = threadIdx.x >> 5, tower"),
    ("    warp_tower(L, s + tower * L.tower, x + 16 * (warp & 1) * L.xs, 2 - tower, y0, y1, l);\n",
     "    warp_tower(L, s + tower * L.tower, x + 16 * (warp & 1) * L.xs, 2 - tower, y0, y1, l);\n"
     "    if (POLICY_SPLIT_STOP >= 1 && POLICY_SPLIT_STOP <= 3) { sink(y0, y1); return; }\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n    const int warp = threadIdx.x >> 5;\n",
     "    cp_async_wait_all();\n    __syncthreads();\n    if (POLICY_SPLIT_STOP == 0) return;\n"
     "    const int warp = threadIdx.x >> 5;\n"),
    ("    warp_tower(L, s, x + 16 * warp * L.xs, 2, y0, y1, l);\n",
     "    warp_tower(L, s, x + 16 * warp * L.xs, 2, y0, y1, l);\n"
     "    if (POLICY_SPLIT_STOP >= 1 && POLICY_SPLIT_STOP <= 2) { sink(y0, y1); return; }\n"),
    ("    layer1(L, T, x, h1, l);\n    layer2(L, T, h1, h2, l);\n",
     "    layer1(L, T, x, h1, l);\n"
     "    if (POLICY_SPLIT_STOP == 1) { sink(h1); y0[0] = y0[1] = y1[0] = y1[1] = 0.0f; return; }\n"
     "    layer2(L, T, h1, h2, l);\n"
     "    if (POLICY_SPLIT_STOP == 2) { sink(h2); y0[0] = y0[1] = y1[0] = y1[1] = 0.0f; return; }\n"),
]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = "self_play_racing_tpu_torch/csrc"


def parent_files():
    """The parent's three sources {name: text}: from ``git show`` where the checkout
    has its history, else from ``scratch_checkout/PARENT/``; None where neither is."""
    out = {}
    for name in FILES:
        try:
            out[name] = subprocess.run(["git", "show", f"{PARENT}:{_CSRC}/{name}"], cwd=_ROOT,
                                       check=True, capture_output=True, text=True,
                                       timeout=60).stdout
            continue
        except (OSError, subprocess.SubprocessError):
            pass
        path = os.path.join(_ROOT, "scratch_checkout", PARENT, _CSRC, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            out[name] = f.read()
    return out


def new_files(overrides=None) -> dict:
    """The port's three sources, with ``overrides`` {constant: value} of policy.cu's
    ``constexpr int`` constants."""
    out = {name: (_cuda.CSRC_DIR / name).read_text() for name in FILES}
    for const, value in (overrides or {}).items():
        pattern = rf"constexpr int {const} = \d+;"
        if len(re.findall(pattern, out["policy.cu"])) != 1:
            raise RuntimeError(f"policy.cu: constant {const} not found once")
        out["policy.cu"] = re.sub(pattern, f"constexpr int {const} = {value};", out["policy.cu"])
    return out


def _stop_of(kind: str, name: str) -> str:
    stops = {"act": ACT_STOPS, "pool": POOL_STOPS + POOL_NEW_STOPS,
             "tower": ACT_STOPS + POOL_STOPS, "any": WITHOUT}[kind]
    return str(dict(stops)[name])


def patched(files: dict, source: str) -> dict:
    """The files with the split points: the new source's ``// split: <kernel> <name>
    {code}`` lines as ``if (POLICY_SPLIT_STOP == k) {code}``, the parent's
    ``PARENT_EDITS``; the prelude (the stop's default and ``sink``) heads the tower
    header, which policy.cu includes first."""
    out = dict(files)
    if source == "parent":
        text = out["policy.cu"]
        for anchor, replacement in PARENT_EDITS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"parent: anchor found {text.count(anchor)} times: {anchor!r}")
            text = text.replace(anchor, replacement)
        out["policy.cu"] = text
    else:
        for name, text in out.items():
            out[name] = re.sub(
                r"^(\s*)// split: (act|pool|tower|any) (\w+) (.*)$",
                lambda m: f"{m.group(1)}if (POLICY_SPLIT_STOP == {_stop_of(m.group(2), m.group(3))})"
                          f" {m.group(4)}", text, flags=re.M)
    header = out["mlp_tower.cuh"]
    at = header.index("#pragma once\n") + len("#pragma once\n")
    out["mlp_tower.cuh"] = header[:at] + PRELUDE + header[at:]
    return out


def build_lib(files: dict, tag: str, stop: int):
    """``files`` written to a new temporary directory and policy.cu compiled with the
    port's flags at ``stop``, loaded, its entry points bound as ``_cuda`` binds them;
    the compiler's report on ``.report``."""
    out_dir = tempfile.mkdtemp(prefix=f"policy_{tag}_")
    for name, text in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(out_dir, f"{tag}_{stop}.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-DPOLICY_SPLIT_STOP={stop}",
                           "-o", lib_path, os.path.join(out_dir, "policy.cu")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc {tag} {stop}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn in ("policy_act_f32", "pool_act_f32", "policy_shared_bytes", "policy_rows_per_block"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = _cuda._SIGNATURES[fn], ctypes.c_int
    lib.policy_error_string.argtypes, lib.policy_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    lib.report = proc.stdout + proc.stderr
    return lib


def build_all(jobs) -> dict:
    """{(tag, stop): library} for jobs [(tag, files, stops)], built in parallel."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
        futures = {(tag, stop): pool.submit(build_lib, files, tag, stop)
                   for tag, files, stops in jobs for stop in stops}
        return {k: f.result() for k, f in futures.items()}


@contextlib.contextmanager
def routed(lib):
    """The port's policy launches through ``lib`` for the block's duration."""
    _cuda._policy_lib()
    saved = _cuda._libs["policy"]
    _cuda._libs["policy"] = lib
    try:
        yield
    finally:
        _cuda._libs["policy"] = saved


def act_call(dims, n: int, dev, seed: int = 61):
    """(launch, outputs) of ``rollout_sample`` at ``dims`` and ``n`` rows with the
    normaliser (``chip_smoke.policy_case``)."""
    c = chip_smoke.policy_case(dims, n, seed, dev)
    out = chip_smoke.policy_buffers(n, dims[0], dev)
    got = {}

    def fn():
        got["action"] = polops.rollout_sample(c["params"], c["log_std"], c["obs"], c["noise"],
                                              c["t"], c["norm"], out)
    return fn, lambda: [got["action"], *out.values()]


def pool_call(dims, envs: int, dist: str, dev, seed: int = 63):
    """(launch, outputs) of the self-play step's ``pool_act`` at ``dims``, ``envs`` x
    one seat, members by ``dist`` (``chip_smoke.with_members``; "mixed": phase q's
    case as it is)."""
    p = chip_smoke.pool_case(dims, envs, 1, "per env", seed, dev)
    if dist != "mixed":
        p = chip_smoke.with_members(p, dist, seed)
    obs = p["obs_all"][:, 1:]
    got = {}

    def fn():
        got["out"] = polops.pool_act(p["actor"], p["log_std"], obs, p["noise"], p["member"],
                                     p["mean"], p["var"], p["uniforms"], p["use"],
                                     selfplay._ACTION_LOW, selfplay._ACTION_HIGH, p["first"])
    return fn, lambda: [got["out"]]


def hold_bitwise(fn, outputs, libs, what: str) -> None:
    """Each library's full kernel on the case, outputs compared bit for bit."""
    first = None
    for tag, lib in libs:
        with routed(lib):
            fn()
        torch.cuda.synchronize()
        got = [t.clone() for t in outputs()]
        if first is None:
            first = (tag, got)
        elif not all(chip_smoke.same_bits(a, b) for a, b in zip(got, first[1])):
            raise AssertionError(f"{what}: {tag} is not bitwise {first[0]}")


def in_turns(calls, passes=2) -> dict:
    """{key: [us, ...]}: each (key, fn, lib) timed in order, then in reverse order."""
    times = {k: [] for k, _, _ in calls}
    for i in range(passes):
        for key, fn, lib in (calls if i % 2 == 0 else calls[::-1]):
            with routed(lib):
                times[key].append(chip_smoke.graph_ms(fn) * 1e3)
    return times


def registers(lib) -> dict:
    """{kernel and its template arguments (hidden widths; kernel A's tile rows and
    warps a fragment): registers} from a build's ``-Xptxas -v`` report."""
    regs = chip_smoke.kernel_registers(lib.report, "_act_kernel")
    return {("pool" if "pool_act" in k else "act")
            + "".join(f"_{v}" for v in re.findall(r"Li(\d+)E", k)): v for k, v in regs.items()}


def split(libs, kinds, dev) -> dict:
    result = {}
    for dims in TOWERS:
        label = "x".join(map(str, dims))
        cases = [("act", act_call(dims, ROWS, dev))]
        cases += [(f"pool.{d}", pool_call(dims, ROWS, d, dev))
                  for d in chip_smoke.POOL_DISTRIBUTIONS[:3] + ("mixed",)]
        for case, (fn, outputs) in cases:
            kernel = case.split(".")[0]
            fulls = [(tag, lib) for (tag, stop), lib in libs.items() if stop == 99]
            hold_bitwise(fn, outputs, fulls, f"{label} {case}")
            calls = []
            for (tag, stop), lib in libs.items():
                stops = (ACT_STOPS if kernel == "act" else POOL_STOPS
                         + (POOL_NEW_STOPS if tag == "new" else ())) + (WITHOUT if tag == "new"
                                                                        else ())
                if tag not in kinds and (stop != 99 or not tag.startswith(kernel)):
                    continue  # a variant: its full kernel, on its own kernel's cases
                name = {s: n for n, s in stops}.get(stop)
                if name is not None:
                    calls.append((f"{tag}.{name}", fn, lib))
            times = in_turns(calls)
            result[f"{label} {case}"] = times
            for key, us in times.items():
                print(f"{label} {case} {key}: {', '.join(f'{u:.2f}' for u in us)} us in a graph")
    return result


def sweep(libs, dev) -> dict:
    """Parent, new (and each variant of the kernel), then the same in reverse."""
    result = {}
    for dims in chip_smoke.POLICY_TOWERS:
        label = "x".join(map(str, dims))
        for n in SWEEP_ROWS:
            for case, (fn, outputs) in (("act", act_call(dims, n, dev)),
                                        ("pool", pool_call(dims, n, "mixed", dev))):
                pair = [(tag, lib) for (tag, _), lib in libs.items()
                        if tag in ("parent", "new") or tag.startswith(case)]
                hold_bitwise(fn, outputs, pair, f"{label} {n} {case}")
                calls = [(tag, fn, lib) for tag, lib in pair]
                times = in_turns(calls + calls[::-1], passes=1)
                result[f"{label} {n} {case}"] = times
                print(f"{label} {n} rows {case}: " + " | ".join(
                    f"{tag} {us[0]:.2f}, {us[1]:.2f}" for tag, us in times.items())
                      + " us in a graph")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="*", default=["parent", "new"], choices=["parent", "new"])
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS' full kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="only the full kernels, parent and new in turns over towers and rows")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("policy_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    _cuda.build()
    kinds = ["parent", "new"] if args.sweep else args.kernels
    sources = {}
    if "parent" in kinds:
        sources["parent"] = parent_files()
        if sources["parent"] is None:
            raise RuntimeError(f"no source of {PARENT}: unpack `git archive {PARENT}` into "
                               f"scratch_checkout/{PARENT}/")
    if "new" in kinds:
        sources["new"] = new_files()
    full = (99,)
    act_stops = {s for _, s in ACT_STOPS + POOL_STOPS}
    jobs = [(tag, patched(files, tag), full if args.sweep else
             sorted(act_stops | ({s for _, s in POOL_NEW_STOPS + WITHOUT} if tag == "new"
                                 else set())))
            for tag, files in sources.items()]
    if args.variants:
        jobs += [(name, patched(new_files(o), "new"), full) for name, o in VARIANTS.items()]
    libs = build_all(jobs)
    result = {"card": card, "rows": ROWS, "registers": {f"{t}_{s}": registers(lib)
                                                       for (t, s), lib in libs.items()}}
    for key, regs in result["registers"].items():
        print(f"registers {key}: {regs}")
    if args.sweep:
        result["sweep"] = sweep(libs, dev)
    else:
        result["split"] = split(libs, kinds, dev)
    print(f"card: {card}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
