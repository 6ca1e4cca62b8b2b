#!/usr/bin/env python3
"""What holds the env steps' kernels back, on the card.

  python scripts/env_kernel_split.py [--envs N] [--out FILE] [--sass DIR]
      [--observe-shapes ROWS,WARPS ...] [--transition-rows N ...]
  python scripts/env_kernel_split.py --sweep N [N ...] [--out FILE]
  python scripts/env_kernel_split.py --single [--one-warp-only] [--envs N] [--out FILE] [--sass DIR]
  python scripts/env_kernel_split.py --single [--one-warp-only] --sweep N [N ...] [--out FILE]

Builds stripped variants of ``multi_observe`` and ``multi_transition`` (each source
compiled with an early return or a skipped part at one split point) and times each
in a CUDA graph of 20 launches (``chip_smoke.graph_ms``: median of 21 replays, CUDA
events) at ``--envs`` (default 4096) envs x 2 cars on the canonical pool, tiled (the
envs read the pool's 16 rows by id) and gathered (per-env rows: 73 MB of segments
at 4096), on ``chip_smoke.crafted_state``. Both the redesigned kernels (``csrc/multi_observe.cu``,
``csrc/multi_transition.cu``) and the first ones (the ``multi_observe_small_f32``
and ``multi_transition_small_f32`` entries of ``csrc/raycast_walls_and_cars.cu`` and
``csrc/car_step_and_query.cu``, which the env launches on few rows) are split the
same way:

  observe:    staged  - the rows staged and what runs while they arrive (in the
                        redesigned kernel the car pass too), no fold;
              folded  - and the wall fold, its results kept, no rays written;
              walls   - and each ray's wall distance written, without the car pass
                        (the first kernel) or the cars' minimum (the redesigned);
              full    - the kernel; also held to 5 and 6 blocks an SM by
                        __launch_bounds__ (full_5_blocks, full_6_blocks), folding
                        every run to S (full_no_extent) and without the car pass
                        (full_no_car_pass, not the plain version's bits).
  transition: staged  - the row staged and the first car stepped;
              searched - and every car's track query and its outputs;
              paired  - and the pair test and velocity response, no reward or tail;
              full    - the kernel.

Each full variant is first held to the env's plain version (bitwise); then each
full kernel is timed against the first one in turns (first, new, new, first). Also prints
each variant's registers (``-Xptxas -v``) and, from ``cuobjdump -sass`` of the full
kernels, the instructions of the fold's and the search's inner loops, and the issue
floor they give: the warp instructions the data needs (every warp's longest lane)
over 132 SMs x 4 schedulers at the card's top SM clock. ``--observe-shapes`` and
``--transition-rows`` time the redesigned kernels at other block shapes too. Prints
a summary and one JSON line with the card's name and power limit; ``--out`` also
writes the whole result (the SASS loops among it) as JSON.

``--sweep`` builds no variant: at each given env count it times the env's two
launches in turns by the first kernel and by the redesigned one (first, new, new,
first), each held to the plain version first. Where the first kernels stop being
the faster sets ``ops/_cuda.py:OBSERVE_SMALL_BELOW`` and ``TRANSITION_SMALL_BELOW``.

``--single`` does the same for the single-car env step (``envs/single.py``: one
car a row, 11 rays, ``chip_smoke.crafted_single_state``, the speed weight a tensor
on the card), whose two launches split as

  observe:    staged, folded, full - as above, the observation kernel at one car a
                        row with its car pass off, at the multi-car plan at one car
                        (a warp a row's 11 rays) and at ``single_observe_plan``'s (the full kernel
                        also at ``--single-observe-shapes``);
  transition: staged  - the rows staged, nothing stepped;
              stepped - and the cars stepped and their corners formed;
              searched - and the track query with the wall test, no tail;
              full    - the kernel; both kernels, a warp a row and, by row id on
                        the tiled layout alone, several rows a block (the full kernel
                        also at ``--single-transition-shapes``);

then the full kernels in turns with those of a warp a row, the fold's and the
search's issue floors from SASS and the registers; ``--one-warp-only`` leaves out the
grouped observation plan and the transition of several rows a block. Its ``--sweep``
times the observation by every route at each env count (``first``: the first kernel,
a block a row; ``multi_plan``: a warp a row's 11 rays; ``new``) and the transition by
each of its kernels that the layout takes (several rows a block on the tiled layout
alone), in turns.

Every launch goes through the env's own wrappers (``envs/multi.py``,
``envs/single.py``); the script picks the kernel, the library and the plan by
setting ``ops/_cuda.py``'s thresholds, libraries and plan functions for the time of
a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import single as senv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402

CARS, TRACKS = 2, 16
ENVS = 4096  # --envs
SMS, SCHEDULERS = 132, 4

# (anchor, text put before it, text put after it, replacement of the anchor or None)
OBSERVE_NEW = {
    "staged": [("    // split: staged\n", "",
                "    if (threadIdx.x == 0) p.obs[blockIdx.x] = smem[0];\n    return;\n")],
    "folded": [("    // split: folded\n", "",
                "    if (threadIdx.x < P * slots) p.obs[row0 * slots + threadIdx.x] =\n"
                "        res_a[threadIdx.x * run_fold::kRunStride] + res_d[threadIdx.x];\n"
                "    return;\n")],
    "walls": [("        // split: walls\n", "",
               "        p.obs[row0 * rays + k] = w;\n        continue;\n")],
    "full": [],
    # the full kernel folding every run to S (no real extent)
    "full_no_extent": [("        const int e = run_fold::real_extent(vx_row, vy_row, S, lane);",
                        "", "", "        const int e = S;")],
    # the full kernel without the car pass (its minima left infinite)
    "full_no_car_pass": [("        car_t[k] = run_fold::car_tmin(cars, b, t[0], t[1], t[2], t[3]);",
                          "", "", "        car_t[k] = CUDART_INF_F;")],
    # the full kernel held to fewer registers: 5 or 6 blocks of 128 threads an SM
    "full_5_blocks": [("__launch_bounds__(kMaxThreads) multi_observe_kernel", "", "",
                       "__launch_bounds__(128, 5) multi_observe_kernel")],
    "full_6_blocks": [("__launch_bounds__(kMaxThreads) multi_observe_kernel", "", "",
                       "__launch_bounds__(128, 6) multi_observe_kernel")],
}
OBSERVE_FIRST = {
    "staged": [("    __syncthreads();  // the walls, their padding and the cars are in\n", "",
                "    if (threadIdx.x == 0) out[row] = rs[0][0] + rs[4][S - 1];\n    return;\n")],
    "folded": [("                           rdy, u, pa, pd);\n", "",
                "        {\n            float sink = 0.0f;\n"
                "            for (int t = 0; t < R; ++t) sink += pa[t] * pd[t];\n"
                "            if (lane == 0) out[row * rays_per_row + g] = sink;\n"
                "            continue;\n        }\n"),
               ("    if constexpr (kObs) {\n        const int A = num_cars;\n", "", "",
                "    if constexpr (false) {\n        const int A = num_cars;\n")],
    "walls": [("car_hits::nearest(cars, ox, oy, dx, dy, max_dist)", "", "", "max_dist")],
    "full": [],
}
TRANSITION_NEW = {
    "staged": [("    // split: staged\n", "",
                "    if (threadIdx.x == 0) p.nx[car0] = stage[0];\n    return;\n")],
    "searched": [("    // split: searched\n", "", "    return;\n")],
    "paired": [("        // split: paired\n", "", "        continue;\n"),
               ("    __syncthreads();  // every car's score and flags\n", "    return;\n", "")],
    "full": [],
}
TRANSITION_FIRST = {
    "staged": [("    __syncthreads();  // the row (and its thread-copied parts) is in\n", "",
                "    if (threadIdx.x == 0) nx[row] = stage[0];\n    return;\n")],
    "searched": [("    if constexpr (kPairs) {\n        __syncthreads();  // every car's corners",
                  "    return;\n", "")],
    "paired": [("    if constexpr (kTail) {\n        __syncthreads();  // every car's raw progress",
                "    return;\n", "")],
    "full": [],
}
SINGLE_OBSERVE = {k: OBSERVE_NEW[k] for k in ("staged", "folded", "full")}
# the single-car transition, a block (one warp) a row
SINGLE_TRANSITION = {
    "staged": [("    // split: staged\n",
                "    row_stage::wait_barrier(&bar);\n    __syncthreads();\n"
                "    if (lane == 0) p.nx[i] = stage[0];\n    return;\n", "")],
    "stepped": [("    // split: stepped\n", "",
                 "    if (lane == 0) p.nx[i] = qx[4] + qy[4] + (float)count + width;\n"
                 "    return;\n")],
    "searched": [("    // split: searched\n", "",
                  "    if (lane == 0) {\n        p.nx[i] = (float)best0;\n"
                  "        p.crashed_out[i] = outside;\n    }\n    return;\n")],
    "full": [],
}
# its kernel of several rows a block (the wait before an early return lets no block
# end with a copy into its shared memory in flight)
WAIT_ROW = "    row_stage::wait_barrier(&bar);\n"
SINGLE_TRANSITION_ROWS = {
    "staged": [("    // split: rows staged\n", "",
                WAIT_ROW + "    if (threadIdx.x == 0) p.nx[env(0)] = smem[0];\n    return;\n")],
    "stepped": [("    // split: rows stepped\n", "",
                 WAIT_ROW + "    if (threadIdx.x < E) p.nx[env(threadIdx.x)] =\n"
                 "        words[threadIdx.x] + words[(kQy + 4) * P + threadIdx.x];\n"
                 "    return;\n")],
    "searched": [("    // split: rows searched\n", "",
                  "    if (warp == stepper && lane < E) {\n"
                  "        p.nx[env(lane)] = (float)iwords[kBest * P + lane];\n"
                  "        p.crashed_out[env(lane)] = iwords[kOutside * P + lane];\n"
                  "    }\n    return;\n")],
    "full": [],
}
SINGLE_KERNELS = {  # name: (source, variants, the mangled-name fragment of its kernel)
    "single_observe": ("multi_observe.cu", SINGLE_OBSERVE, "multi_observe_kernel"),
    "single_transition": ("single_transition.cu", SINGLE_TRANSITION,
                          "single_transition_kernel"),
    "single_transition_rows": ("single_transition.cu", SINGLE_TRANSITION_ROWS,
                               "single_transition_rows_kernel"),
}
KERNELS = {  # name: (source, variants)
    "multi_observe": ("multi_observe.cu", OBSERVE_NEW),
    "multi_observe_first": ("raycast_walls_and_cars.cu", OBSERVE_FIRST),
    "multi_transition": ("multi_transition.cu", TRANSITION_NEW),
    "multi_transition_first": ("car_step_and_query.cu", TRANSITION_FIRST),
}


def patched(text: str, edits) -> str:
    for anchor, before, after, replace in (e if len(e) == 4 else (*e, None) for e in edits):
        if text.count(anchor) != 1:
            raise AssertionError(f"split anchor {anchor!r} found {text.count(anchor)} times")
        text = text.replace(anchor, before + (anchor if replace is None else replace) + after)
    return text


def build_variants(workdir: str, kernels=None):
    """Every variant of every kernel (``KERNELS``, or ``kernels``) into workdir, one
    nvcc each, all started together. Returns {(kernel, variant): (library path,
    ptxas report)}."""
    jobs = {}
    for name, (source, variants, *_) in (kernels or KERNELS).items():
        text = (_cuda.CSRC_DIR / source).read_text()
        for variant, edits in variants.items():
            src = os.path.join(workdir, f"{name}_{variant}.cu")
            with open(src, "w") as fh:
                fh.write(patched(text, edits))
            out = src[:-3] + ".so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC_DIR), "-o", out, src]
            jobs[(name, variant)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        built[key] = (out, log)
    return built


def load(path: str, source: str) -> ctypes.CDLL:
    """A variant's library, with the port's argument types (``ops/_cuda.py:build``)."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
    err = getattr(lib, f"{source[:-3]}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


@contextlib.contextmanager
def routed(kernel: str, first: bool, lib=None, plan=None):
    """The env's ``kernel`` ("multi_observe" or "multi_transition") launched by the
    first kernel where ``first``, else by the redesigned one at ``plan`` (None: the
    port's plan); from ``lib`` (a variant's library; None: the port's own)."""
    observe = kernel == "multi_observe"
    below = "OBSERVE_SMALL_BELOW" if observe else "TRANSITION_SMALL_BELOW"
    plan_fn = "multi_observe_plan" if observe else "multi_transition_plan"
    source = KERNELS[f"{kernel}_first" if first else kernel][0]
    saved = getattr(_cuda, below), getattr(_cuda, plan_fn), dict(_cuda._libs)
    setattr(_cuda, below, 1 << 30 if first else 0)
    saved[1].cache_clear()
    if plan is not None:
        setattr(_cuda, plan_fn, lambda *args: plan)
    if lib is not None:
        _cuda._libs[source[:-3]] = lib
    try:
        yield
    finally:
        setattr(_cuda, below, saved[0])
        setattr(_cuda, plan_fn, saved[1])
        saved[1].cache_clear()
        _cuda._libs.update(saved[2])


def env_calls(cfg, track, state, action):
    """{kernel: (the env's call, a check that its result is the plain version's)}."""
    want_obs = menv.observe_plain(cfg, track, state)
    want_tr = chip_smoke.transition_fields(menv.transition_plain(cfg, track, state, action))

    def observe_check(got):
        if not chip_smoke.same_bits(got, want_obs):
            raise AssertionError("not the plain version")

    def transition_check(got):
        bad = chip_smoke.differing(chip_smoke.transition_fields(got), want_tr)
        if bad:
            raise AssertionError(f"differs from the plain version: {bad}")

    return {"multi_observe": (lambda: menv.observe(cfg, track, state), observe_check),
            "multi_transition": (lambda: menv.transition(cfg, track, state, action),
                                 transition_check)}


def layouts_at(pool, envs):
    return {"tiled": trk.tiled_pooled_tracks(pool, envs),
            "gathered": trk.gather_tracks(pool, np.arange(envs) % TRACKS)}


def sweep(pool, cfg, widths, dev):
    """{"kernel/layout/envs": [(route, us), ...]}: the first kernel ("first") and the
    redesigned one ("new") in turns, each held to the plain version first."""
    out = {}
    for envs in widths:
        for where, track in layouts_at(pool, envs).items():
            state, action = chip_smoke.crafted_state(track, CARS, cfg.max_steps, seed=7,
                                                     device=dev)
            for kernel, (fn, check) in env_calls(cfg, track, state, action).items():
                times = []
                for route in ("first", "new", "new", "first"):
                    with routed(kernel, route == "first"):
                        if len(times) < 2:
                            check(fn())
                        times.append((route, chip_smoke.graph_ms(fn) * 1e3))
                out[f"{kernel}/{where}/{envs}"] = times
                print(f"  {kernel} {where} {envs} envs: "
                      + ", ".join(f"{r} {us:.2f} us" for r, us in times), flush=True)
    return out


def split(pool, cfg, libs, args, dev):
    """Every variant's graph time on both layouts, the full kernels at the other
    block shapes too; then the full kernels against the first ones in turns."""
    S, W = pool.seg_sx.shape[-1], pool.wp_x.shape[-1]
    shapes = [tuple(int(v) for v in shape.split(",")) for shape in args.observe_shapes]
    graph_us, turns = {}, {}
    for where, track in layouts_at(pool, ENVS).items():
        state, action = chip_smoke.crafted_state(track, CARS, cfg.max_steps, seed=7,
                                                 device=dev)
        calls = env_calls(cfg, track, state, action)
        for (name, variant), lib in libs.items():
            first = name.endswith("_first")
            kernel = name.removesuffix("_first")
            plans = {"": None}
            if variant == "full" and not first and kernel == "multi_observe":
                plans.update({f"/rows_per_block={r},warps={w}":
                              _cuda._observe_shape(CARS, 11, S, r, w) for r, w in shapes})
            elif variant == "full" and not first:
                plans.update({f"/rows_per_block={r}": _cuda._transition_shape(CARS, W, r)
                              for r in args.transition_rows})
            fn, check = calls[kernel]
            for suffix, plan in plans.items():
                key = f"{name}/{variant}{suffix}"
                try:
                    with routed(kernel, first, lib, plan):
                        if variant.startswith("full") and variant != "full_no_car_pass":
                            check(fn())
                        us = chip_smoke.graph_ms(fn) * 1e3
                except (RuntimeError, AssertionError) as exc:
                    print(f"  {key} on the {where} rows failed: {exc}")
                    torch.cuda.synchronize()
                    us = None
                graph_us.setdefault(key, {})[where] = us
        # the full kernels against the first ones in turns: first, new, new, first
        for kernel, (fn, _) in calls.items():
            for name in (f"{kernel}_first", kernel, kernel, f"{kernel}_first"):
                with routed(kernel, name != kernel, libs[(name, "full")]):
                    turns.setdefault(f"{kernel}/{where}", []).append(
                        (name, chip_smoke.graph_ms(fn) * 1e3))
    return graph_us, turns


# ------------------------------------------------------------ the single-car env step

SINGLE_SENSORS = 11


@contextlib.contextmanager
def patched_cuda(libs=None, **attrs):
    """``ops/_cuda.py`` with ``libs`` ({stem: library}) loaded in place of its own and
    ``attrs`` set (plan functions' caches cleared around), for one measurement."""
    saved_libs = dict(_cuda._libs)
    saved = {k: getattr(_cuda, k) for k in attrs}
    plans = [getattr(_cuda, k) for k in dir(_cuda) if k.endswith("_plan")]
    for k, v in attrs.items():
        setattr(_cuda, k, v)
    for fn in plans:
        getattr(fn, "cache_clear", lambda: None)()
    _cuda._libs.update(libs or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(_cuda, k, v)
        for fn in plans:
            getattr(fn, "cache_clear", lambda: None)()
        _cuda._libs.update(saved_libs)


ONE_WARP_ONLY = False  # --one-warp-only: the launches of a warp a row (no "new" or "rows")


def single_routes(tiled=True):
    """{kernel: {route: ``patched_cuda`` keywords}}: the single-car observation by
    the first kernel (a block a row), by the multi-car plan (``multi_observe`` at one car
    a row, a warp a row's 11 rays) and by ``single_observe_plan``'s; the transition by
    its kernel of a warp a row and, on the ``tiled`` layout (the only one it takes),
    by that of several rows a block."""
    def first(num_sensors, num_segments, shared_row=False, rows=None):
        return _cuda._first_observe_plan(1, num_sensors, num_segments)

    def multi_plan(num_sensors, num_segments, shared_row=False, rows=None):
        return _cuda.multi_observe_plan(1, num_sensors, num_segments)

    routes = {"single_observe": {"first": dict(single_observe_plan=first),
                                 "multi_plan": dict(single_observe_plan=multi_plan),
                                 # the grouped plan at every width
                                 "new": dict(SINGLE_OBSERVE_MULTI_PLAN_ROWS=range(0))},
              "single_transition": {"warp": dict(SINGLE_TRANSITION_ROWS_FROM=sys.maxsize),
                                    "rows": dict(SINGLE_TRANSITION_ROWS_FROM=0)}}
    if ONE_WARP_ONLY:
        del routes["single_observe"]["new"]
    if ONE_WARP_ONLY or not tiled:
        del routes["single_transition"]["rows"]
    return routes


def single_calls(cfg, track, state, action, sw):
    """{kernel: (the env's call, a check that its result is the plain version's)}."""
    want_obs = senv.observe_plain(cfg, track, state)
    fields = chip_smoke.single_transition_fields
    want_tr = fields(senv.transition_plain(cfg, track, state, action, sw))

    def observe_check(got):
        if not chip_smoke.same_bits(got, want_obs):
            raise AssertionError("not the plain version")

    def transition_check(got):
        bad = chip_smoke.differing(fields(got), want_tr)
        if bad:
            raise AssertionError(f"differs from the plain version: {bad}")

    return {"single_observe": (lambda: senv.observe(cfg, track, state), observe_check),
            "single_transition": (lambda: senv.transition(cfg, track, state, action, sw),
                                  transition_check)}


def single_case(pool, envs, where, dev):
    cfg = senv.RacingConfig(num_sensors=SINGLE_SENSORS)
    track = (chip_smoke.by_row_id(pool, envs) if where == "by row id"
             else trk.gather_tracks(pool, np.arange(envs) % TRACKS))
    state, action = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=7, device=dev)
    sw = torch.tensor(5.3, device=dev)
    return (cfg, track, single_calls(cfg, track, state, action, sw),
            isinstance(track, trk.TiledPooledTracks))


def single_sweep(pool, widths, dev):
    """{"kernel/layout/envs": [(route, us), ...]}: each launch by each of its routes
    in turns (the routes, then again in reverse), each held to the plain version
    first."""
    out = {}
    for envs in widths:
        for where in ("gathered", "by row id"):
            _, _, calls, tiled = single_case(pool, envs, where, dev)
            for kernel, routes in single_routes(tiled).items():
                fn, check = calls[kernel]
                times = []
                for route in [*routes, *reversed(list(routes))]:
                    with patched_cuda(**routes[route]):
                        if len(times) < len(routes):
                            check(fn())
                        times.append((route, chip_smoke.graph_ms(fn) * 1e3))
                out[f"{kernel}/{where}/{envs}"] = times
                print(f"  {kernel} {where} {envs} envs: "
                      + ", ".join(f"{r} {us:.2f} us" for r, us in times), flush=True)
    return out


def single_split(pool, libs, args, dev):
    """Every single-car variant's graph time at ``ENVS`` rows, gathered and by row
    id: the observation's at the multi-car plan and at the new one (and the full
    kernel at ``--single-observe-shapes``), the transition's by both kernels (the new
    one's full kernel also at ``--single-transition-shapes``); then the full kernels in
    turns with those of a warp a row (multi_plan, new, new, multi_plan; warp, rows,
    rows, warp)."""
    graph_us, turns = {}, {}
    for where in ("gathered", "by row id"):
        _, _, calls, tiled = single_case(pool, ENVS, where, dev)
        routes = single_routes(tiled)
        for (name, variant), lib in libs.items():
            if name == "single_transition_rows" and not tiled:
                continue
            kernel = "single_observe" if name == "single_observe" else "single_transition"
            fn, check = calls[kernel]
            stem = SINGLE_KERNELS[name][0][:-3]
            if kernel == "single_observe":
                cases = {r: routes[kernel][r] for r in ("multi_plan", "new") if r in routes[kernel]}
                if variant == "full" and not ONE_WARP_ONLY:
                    cases.update({f"new/groups={g},rows={r}": dict(
                        routes[kernel]["new"], SINGLE_OBSERVE_GROUPS=g, SINGLE_OBSERVE_ROWS=r,
                        SINGLE_OBSERVE_SHARED_GROUPS=g, SINGLE_OBSERVE_SHARED_ROWS=r)
                        for g, r in args.single_observe_shapes})
            elif name == "single_transition_rows":
                cases = {"rows": routes[kernel]["rows"]}
                if variant == "full":
                    cases.update({f"rows/rows={r},warps={w}": dict(
                        routes[kernel]["rows"], SINGLE_TRANSITION_ROWS=r,
                        SINGLE_TRANSITION_WARPS=w) for r, w in args.single_transition_shapes})
            else:
                cases = {"warp": routes[kernel]["warp"]}
            for case, attrs in cases.items():
                key = f"{name}/{variant}/{case}"
                try:
                    with patched_cuda({stem: lib}, **attrs):
                        if variant == "full":
                            check(fn())
                        us = chip_smoke.graph_ms(fn) * 1e3
                except (RuntimeError, AssertionError) as exc:
                    print(f"  {key} on the {where} rows failed: {exc}")
                    torch.cuda.synchronize()
                    us = None
                graph_us.setdefault(key, {})[where] = us
        pairs = (("single_observe", ("multi_plan", "new")), ("single_transition", ("warp", "rows")))
        for kernel, (old, new) in () if ONE_WARP_ONLY else pairs:
            if new not in routes[kernel]:
                continue
            fn, _ = calls[kernel]
            for route in (old, new, new, old):
                with patched_cuda(**routes[kernel][route]):
                    turns.setdefault(f"{kernel}/{where}", []).append(
                        (route, chip_smoke.graph_ms(fn) * 1e3))
    return graph_us, turns


def single_issue_floors(pool, built, clock_mhz, sass_dir):
    """The single-car launches' inner loops from their SASS, and the issue floors:
    the fold's warp-steps from each env row's real extent in the plan's items (PR
    18's plan and the new one), the search's 32-waypoint chunks over each row's real
    waypoints, a warp a car (both transition kernels)."""
    S = pool.seg_sx.shape[-1]
    L = -(-S // 32)
    rate = SMS * SCHEDULERS * clock_mhz * 1e6
    extents = [int(((pool.seg_vx[r] != 0) | (pool.seg_vy[r] != 0)).nonzero().max()) + 1
               for r in range(TRACKS)]
    env_extents = [extents[i % TRACKS] for i in range(ENVS)]
    chunks = sum(-(-int(pool.n_wp[i % TRACKS]) // 32) for i in range(ENVS))
    plans = {"single_observe/multi_plan": _cuda.multi_observe_plan(1, SINGLE_SENSORS, S)}
    if not ONE_WARP_ONLY:
        plans["single_observe/new"] = _cuda.single_observe_plan(SINGLE_SENSORS, S)
        plans["single_observe/new tiled"] = _cuda.single_observe_plan(SINGLE_SENSORS, S, True)
    # on the tiled layout a block takes rows a period apart: the rows in block order
    tiled_extents = [extents[r] for r in range(TRACKS) for _ in range(ENVS // TRACKS)]
    launched = {}
    for key, plan in plans.items():
        groups = -(-SINGLE_SENSORS // plan.rays_per_lane)
        launched[key] = ("single_observe",
                         f"multi_observe_kernelILi{plan.rays_per_lane}ELb{int(plan.per_car)}"
                         f"ELb{int(plan.shared_row)}E",
                         2 * plan.rays_per_lane,
                         chip_smoke.observe_warp_steps(
                             tiled_extents if plan.shared_row else env_extents, L, groups,
                             plan.rows_per_block, plan.threads))
    launched["single_transition"] = ("single_transition", "single_transition_kernel", 5,
                                     chunks)
    if not ONE_WARP_ONLY:
        launched["single_transition_rows"] = ("single_transition_rows",
                                              "single_transition_rows_kernel", 5, chunks)
    loops, floors = {}, {}
    for key, (name, word, select, steps) in launched.items():
        sass = chip_smoke.kernel_sass(built[(name, "full")][0])
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as fh:
                fh.write(sass)
        loops[key] = chip_smoke.sass_loops(sass, word)
        per_step, loop = chip_smoke.inner_loop(loops[key], select, word)
        if per_step:
            floors[key] = {"instantiation": word, "instructions_per_step": per_step,
                           "loop": loop, "warp_steps": steps,
                           "issue_floor_us": steps * per_step / rate * 1e6}
    return loops, floors


def single_main(args, dev, card, clock_mhz, result):
    pool = canonical_bench_pool(TRACKS, device=dev)
    if args.sweep:
        result["sweep_graph_us"] = single_sweep(pool, args.sweep, dev)
        return {"card": card, "sweep_graph_us": result["sweep_graph_us"]}
    work = tempfile.mkdtemp(prefix="env_kernel_split_")
    kernels = {k: v for k, v in SINGLE_KERNELS.items()
               if not (ONE_WARP_ONLY and k == "single_transition_rows")}
    built = build_variants(work, kernels)
    libs = {(name, variant): load(path, SINGLE_KERNELS[name][0])
            for (name, variant), (path, _) in built.items()}
    result["graph_us"], result["in_turns_graph_us"] = single_split(pool, libs, args, dev)
    result["registers"] = {
        f"{name}/{variant}": chip_smoke.kernel_registers(log, SINGLE_KERNELS[name][2])
        for (name, variant), (_, log) in built.items()}
    result["loops"], floors = single_issue_floors(pool, built, clock_mhz, args.sass)
    result["issue_floors"] = floors
    for key, times in result["graph_us"].items():
        print(f"  {key}: " + ", ".join(f"{w} {'failed' if us is None else f'{us:.2f} us'}"
                                       for w, us in times.items()))
    for key, turns in result["in_turns_graph_us"].items():
        print(f"  in turns {key}: " + ", ".join(f"{n} {us:.2f} us" for n, us in turns))
    for key, regs in result["registers"].items():
        print(f"  registers {key}: {regs}")
    for name, f in floors.items():
        print(f"  {name} inner loop ({f['instantiation']}): "
              f"{f['instructions_per_step']:.1f} instructions a step, {f['warp_steps']} "
              f"warp-steps, issue floor {f['issue_floor_us']:.2f} us; loop body "
              f"{f['loop']['instructions']} instructions {f['loop']['ops']}")
    return {"card": card, "graph_us": result["graph_us"],
            "in_turns_graph_us": result["in_turns_graph_us"],
            "issue_floor_us": {k: f["issue_floor_us"] for k, f in floors.items()}}


def issue_floors(pool, built, clock_mhz, sass_dir):
    """The full kernels' inner loops from their SASS and the issue floors they give."""
    S = pool.seg_sx.shape[-1]
    # the instantiations the self-play launch runs (2 x 11 rays by car; the pair test)
    launched = {"multi_observe": "multi_observe_kernelILi11ELb1ELb0E",
                "multi_observe_first": "raycast_walls_and_cars_kernelILi11ELb1E",
                "multi_transition": "multi_transition_kernelILb1E",
                "multi_transition_first": "car_step_and_query_kernelILb1ELb1E"}
    rate = SMS * SCHEDULERS * clock_mhz * 1e6  # warp instructions a second
    L = -(-S // 32)
    extents = [int(((pool.seg_vx[r] != 0) | (pool.seg_vy[r] != 0)).nonzero().max()) + 1
               for r in range(TRACKS)]
    env_extents = [extents[i % TRACKS] for i in range(ENVS)]
    chunks = sum(-(-int(pool.n_wp[i % TRACKS]) // 32) for i in range(ENVS)) * CARS
    plan = _cuda.multi_observe_plan(CARS, 11, S, ENVS)
    warp_steps = {"multi_observe": chip_smoke.observe_warp_steps(
                      env_extents, L, 2, plan.rows_per_block, plan.threads),
                  "multi_observe_first": ENVS * 2 * L,  # a warp of 11 rays folds every run
                  "multi_transition": chunks,        # the real waypoints' 32-chunks
                  "multi_transition_first": ENVS * CARS * -(-pool.wp_x.shape[-1] // 32)}
    loops, floors = {}, {}
    for name in KERNELS:
        sass = chip_smoke.kernel_sass(built[(name, "full")][0])
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as fh:
                fh.write(sass)
        loops[name] = chip_smoke.sass_loops(sass, launched[name])
        per_step, loop = chip_smoke.inner_loop(
            loops[name], 2 * 11 if "observe" in name else 5, launched[name])
        if per_step:
            floors[name] = {"instructions_per_step": per_step, "loop": loop,
                            "warp_steps": warp_steps[name],
                            "issue_floor_us": warp_steps[name] * per_step / rate * 1e6}
    return loops, floors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the whole result, as JSON, here")
    ap.add_argument("--sass", default=None, help="directory to write the full kernels' SASS to")
    ap.add_argument("--observe-shapes", nargs="*", default=["1,2", "2,3", "3,6", "4,8"],
                    help="the redesigned observation's full kernel also at these block "
                         "shapes: rows_per_block,warps")
    ap.add_argument("--transition-rows", type=int, nargs="*", default=[2, 4, 8, 16],
                    help="the redesigned transition's full kernel also at these rows a block")
    ap.add_argument("--envs", type=int, default=4096, help="env rows (a multiple of 8)")
    ap.add_argument("--single", action="store_true",
                    help="the single-car env step's launches instead of the multi-car's")
    ap.add_argument("--one-warp-only", action="store_true",
                    help="with --single, the launches of a warp a row alone (the observation "
                         "at the multi-car plan, the transition a warp a row)")
    ap.add_argument("--single-observe-shapes", nargs="*", default=["2,4", "3,2", "2,2", "3,1"],
                    help="with --single, the new observation's full kernel also at these "
                         "shapes: groups,rows_per_block")
    ap.add_argument("--single-transition-shapes", nargs="*",
                    default=["8,8", "8,4", "16,8", "32,8", "4,4"],
                    help="with --single, the new transition's full kernel also at these "
                         "shapes: rows_per_block,warps")
    ap.add_argument("--sweep", type=int, nargs="*", default=None,
                    help="only time the first and the redesigned kernels in turns at these "
                         "env counts")
    args = ap.parse_args(argv)
    args.single_observe_shapes = [tuple(map(int, v.split(","))) for v in args.single_observe_shapes]
    args.single_transition_shapes = [tuple(map(int, v.split(",")))
                                     for v in args.single_transition_shapes]
    global ENVS, ONE_WARP_ONLY
    ENVS, ONE_WARP_ONLY = args.envs, args.one_warp_only
    if not torch.cuda.is_available():
        print("env_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    _cuda.build()
    if args.single:
        result = {"card": card, "device": torch.cuda.get_device_name(0),
                  "clock_max_sm_mhz": clock_mhz}
        print(f"card: {card}, top SM clock {clock_mhz:.0f} MHz")
        summary = single_main(args, dev, card, clock_mhz, result)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(result, fh, indent=1)
        print(json.dumps(summary))
        return 0
    pool = canonical_bench_pool(TRACKS, device=dev)
    cfg = menv.MultiRacingConfig(num_agents=CARS, num_sensors=11)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "clock_max_sm_mhz": clock_mhz}
    print(f"card: {card}, top SM clock {clock_mhz:.0f} MHz")
    if args.sweep:
        result["sweep_graph_us"] = sweep(pool, cfg, args.sweep, dev)
        summary = {"card": card, "sweep_graph_us": result["sweep_graph_us"]}
    else:
        work = tempfile.mkdtemp(prefix="env_kernel_split_")
        built = build_variants(work)
        libs = {(name, variant): load(path, KERNELS[name][0])
                for (name, variant), (path, _) in built.items()}
        result["graph_us"], result["in_turns_graph_us"] = split(pool, cfg, libs, args, dev)
        words = {"multi_observe": "multi_observe_kernel",
                 "multi_observe_first": "raycast_walls_and_cars_kernel",
                 "multi_transition": "multi_transition_kernel",
                 "multi_transition_first": "car_step_and_query_kernel"}
        result["registers"] = {f"{name}/{variant}": chip_smoke.kernel_registers(log, words[name])
                               for (name, variant), (_, log) in built.items()}
        result["loops"], floors = issue_floors(pool, built, clock_mhz, args.sass)
        result["issue_floors"] = floors
        for key, times in result["graph_us"].items():
            print(f"  {key}: " + ", ".join(f"{w} {'failed' if us is None else f'{us:.2f} us'}"
                                           for w, us in times.items()))
        for key, turns in result["in_turns_graph_us"].items():
            print(f"  in turns {key}: " + ", ".join(f"{n} {us:.2f} us" for n, us in turns))
        for key, regs in result["registers"].items():
            print(f"  registers {key}: {sorted(set(regs.values()))}")
        for name, f in floors.items():
            print(f"  {name} inner loop: {f['instructions_per_step']:.1f} instructions a step, "
                  f"{f['warp_steps']} warp-steps, issue floor {f['issue_floor_us']:.2f} us; "
                  f"loop body {f['loop']['instructions']} instructions {f['loop']['ops']}")
        summary = {"card": card, "graph_us": result["graph_us"],
                   "in_turns_graph_us": result["in_turns_graph_us"],
                   "issue_floor_us": {k: f["issue_floor_us"] for k, f in floors.items()}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
