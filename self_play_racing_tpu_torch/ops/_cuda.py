"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), all sources at
once in parallel, at the first launch in a process. Libraries are cached in
``_build/`` under a name that hashes the source, the headers in ``csrc/`` and the
flags, so an edited source is rebuilt and an unchanged one is loaded as is.
Pointers and the stream go to the C entry points through ``ctypes``; each entry
returns ``cudaGetLastError()`` and the caller raises on anything but 0. Nothing
here is imported or built until a CUDA tensor reaches a kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("raycast_walls.cu", "progress_collision.cu", "raycast_cars.cu",
           "rectangles_intersect.cu", "car_update.cu", "gae.cu",
           "mixbits_permutation.cu", "raycast_walls_and_cars.cu",
           "car_step_and_query.cu", "multi_observe.cu", "multi_transition.cu",
           "ppo_head.cu", "adam_tail.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # PyTorch's eager ops never contract a*b+c into an FMA; neither may the kernels
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "raycast_walls_f32": [_P] * 11 + [_I, _I, _I, _F] + [_I] * 3 + [_I, _P],
    "progress_and_collision_f32": [_P] * 12 + [_I] * 6 + [_I, _P],
    "raycast_cars_f32": [_P] * 9 + [_I, _I, _I, _F, _I, _P],
    "rectangles_intersect_u8": [_P] * 3 + [_I, _I, _I, _P],
    "car_update_f32": [_P] * 13 + [_I] + [_F] * 8 + [_I, _P],
    "compute_gae_f32": [_P] * 7 + [_I, _I, ctypes.c_float, ctypes.c_float, _I, _P],
    "mixbits_permutation_i32": [_P, _P, _I, _I, _I, _P],
    "raycast_walls_and_cars_f32": [_P] * 11 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_I, _P],
    "car_step_and_query_f32": [_P] * 25 + [_I] * 5 + [_F] * 11 + [_I, _P],
    "multi_transition_small_f32": [_P, _I, _P, _I] + [_I] * 7 + [_I, _P],
    "multi_observe_small_f32": [_P] * 15 + [_I] * 4 + [_F] * 5 + [_I] * 4 + [_I, _P],
    "multi_transition_f32": [_P, _I, _P, _I] + [_I] * 8 + [_I, _P],
    "multi_observe_f32": [_P] * 15 + [_I] * 4 + [_F] * 5 + [_I] * 7 + [_I, _P],
    "ppo_head_forward_f32": [_P, _I, _P, _I, _P, _L, _I, _P],
    "ppo_head_backward_f32": [_P, _I, _P, _I, _P, _L, _P, _L, _P, _P, _L, _I, _P],
    "adam_tail_f32": [_P, _P, _I, _P, _I, _P, _I, _L, _L, _I, _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: the compiler's report (registers, shared memory, spills) and whether
# this process compiled it or found it cached
build_report: dict[str, str] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (one ``nvcc`` per source, all started
    together) and load them all. Returns the libraries by source stem."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SOURCES:
            src = CSRC_DIR / name
            out = _target(src)
            if out.exists():
                build_report[src.stem] = "cached"
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failures = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            build_report[src.stem] = log.strip()
            if proc.returncode:
                failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        libs = {}
        for name in SOURCES:
            lib = ctypes.CDLL(str(_target(CSRC_DIR / name)))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            stem = Path(name).stem
            err_fn = getattr(lib, f"{stem}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            libs[stem] = lib
        _libs.update(libs)
        build_seconds = time.perf_counter() - t0
        return _libs


def _call(stem: str, fn: str, device: torch.device, *args) -> None:
    lib = build()[stem]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index, stream)
    if err:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {err})")


def _ptr(t):
    return None if t is None else t.data_ptr()


# A block may take 227 KB of an H100 SM's shared memory.
BLOCK_SMEM_LIMIT = 232_448
# what the redesigned env kernels' plans leave of it for their static shared memory
STATIC_SMEM_RESERVE = 1024
MAX_THREADS = 256  # the kernels' __launch_bounds__
# K1: the rays a lane may hold (the kernel's instantiations), and how many it holds
# at most: a row's rays are split into the fewest warps that hold at most
# K1_RAYS_PER_LANE each, as evenly as the instantiations allow
K1_RAYS_PER_LANE_CHOICES = (1, 2, 3, 4, 6, 8, 11)
K1_RAYS_PER_LANE = 11
K1_FIELDS = 5
K2_FIELDS = 2
K3_FLOATS_PER_CAR = 18  # corners, edge vectors and centre (csrc/car_hits.cuh)
# the transition's pair test: corners and stepped velocity (csrc/car_step_and_query.cu)
PAIR_FLOATS_PER_CAR = 10
# the multi-car env's transition tail: raw progress, velocity, score, reward and
# four flags a car (csrc/car_step_and_query.cu:kTailWords)
TAIL_WORDS_PER_CAR = 9
# multi_transition_f32's pointer and constant counts (csrc/multi_transition.cu)
TRANSITION_PTRS = 44
TRANSITION_CONSTS = 21
# multi_observe (csrc/multi_observe.cu): the rows a block stages at most, and the
# warps its plan aims at: rows_per_block = max(1, OBSERVE_WARPS // groups)
OBSERVE_MAX_ROWS_PER_BLOCK = 8
OBSERVE_WARPS = 4
OBSERVE_RAY_FLOATS = 5      # a ray's origin, direction and u in the ray table
OBSERVE_RUN_STRIDE = 33     # floats a ray's 32 run results take (run_fold.cuh:kRunStride)
# multi_transition (csrc/multi_transition.cu): the rows a block serves at most, the
# cars its plan aims at (rows_per_block = max(1, TRANSITION_CARS // cars_per_row)),
# and the words a car (queries, velocity, progress, score, reward, three flags) and
# a row (its waypoint count and width) take beside the staged positions
TRANSITION_MAX_ROWS_PER_BLOCK = 32
TRANSITION_CARS = 8
TRANSITION_WORDS_PER_CAR = 18
TRANSITION_WORDS_PER_ROW = 2
# Below these many env rows the env step launches its first kernels, a block a row
# (raycast_walls_and_cars.cu:multi_observe_small_f32 and
# car_step_and_query.cu:multi_transition_small_f32): a launch of few rows (a match's
# 40 envs, an evaluation's 200) takes about one block's chain, and theirs is the
# shorter. On an H100 (scripts/env_kernel_split.py --sweep, 2 cars, canonical pool)
# the first observation is the faster at 512 rows and the slower at 640; the first
# transition the faster at 1536, at 2048 the slower on per-env rows (train scale's
# default) and 2% the faster on the tiled pool.
OBSERVE_SMALL_BELOW = 640
TRANSITION_SMALL_BELOW = 2048


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How K1 or K2 is launched: one block of ``threads`` threads per row (the
    grid is the row count), ``smem`` bytes of dynamic shared memory for the row's
    staged fields (one buffer, filled once by bulk copies), and for K1 the rays
    each lane holds."""
    threads: int
    smem: int
    rays_per_lane: int = 0


def _field_capacity(n: int) -> int:
    """Floats the stage reserves per field (row_stage.cuh:field_capacity)."""
    return (n + 3) // 4 * 4 + 4


@functools.lru_cache(maxsize=256)
def raycast_walls_plan(rays_per_row: int, num_segments: int) -> LaunchPlan:
    """K1's launch: a block per row stages five fields of 32 * ceil(S/32) floats
    (the kernel pads the row with zero direction) and folds the row's rays in
    warps of ``rays_per_lane`` rays each, at most 8 warps looping over the rest.
    Raises ValueError where the row does not fit in 227 KB."""
    if num_segments < 1:
        raise ValueError("raycast_walls: the kernel needs at least one segment")
    groups = max(1, -(-rays_per_row // K1_RAYS_PER_LANE))
    even = -(-rays_per_row // groups)
    rays_per_lane = min(r for r in K1_RAYS_PER_LANE_CHOICES if r >= even)
    warps = min(max(1, -(-rays_per_row // rays_per_lane)), MAX_THREADS // 32)
    smem = K1_FIELDS * _field_capacity(32 * -(-num_segments // 32)) * 4
    if smem > BLOCK_SMEM_LIMIT:
        raise ValueError(f"raycast_walls: a row of {num_segments} segments needs "
                         f"{smem:,} bytes of shared memory; a block has "
                         f"{BLOCK_SMEM_LIMIT:,}")
    return LaunchPlan(32 * warps, smem, rays_per_lane)


@functools.lru_cache(maxsize=256)
def progress_collision_plan(cars_per_row: int, num_corners: int,
                            num_waypoints: int) -> LaunchPlan:
    """K2's launch: a block per waypoint row stages the row's two position fields
    (the normals are read at the winners only) and serves its ``cars_per_row``
    cars, a warp per car (at most 8 warps, looping over the rest). Raises
    ValueError on more than 31 corners or where the row does not fit in 227 KB."""
    if not 0 <= num_corners <= 31:
        raise ValueError(f"progress_and_collision: {num_corners} corners; the kernel "
                         "takes at most 31")
    if num_waypoints < 1:
        raise ValueError("progress_and_collision: the kernel needs at least one waypoint")
    smem = K2_FIELDS * _field_capacity(num_waypoints) * 4
    if smem > BLOCK_SMEM_LIMIT:
        raise ValueError(f"progress_and_collision: a row of {num_waypoints} waypoints "
                         f"needs {smem:,} bytes of shared memory; a block has "
                         f"{BLOCK_SMEM_LIMIT:,}")
    threads = 32 * min(max(1, cars_per_row), MAX_THREADS // 32)
    return LaunchPlan(threads, smem)


@functools.lru_cache(maxsize=256)
def raycast_walls_and_cars_plan(num_cars: int, num_sensors: int,
                                num_segments: int) -> LaunchPlan:
    """The multi-car sensing launch: K1's plan for the ``num_cars * num_sensors``
    rays of a row, with the row's cars (18 floats a car) staged beside its
    segment fields. Raises ValueError where the two do not fit in 227 KB."""
    walls = raycast_walls_plan(num_cars * num_sensors, num_segments)
    smem = walls.smem + K3_FLOATS_PER_CAR * num_cars * 4
    if smem > BLOCK_SMEM_LIMIT:
        raise ValueError(f"raycast_walls_and_cars: a row of {num_segments} segments and "
                         f"{num_cars} cars needs {smem:,} bytes of shared memory; a block "
                         f"has {BLOCK_SMEM_LIMIT:,}")
    return dataclasses.replace(walls, smem=smem)


@functools.lru_cache(maxsize=256)
def car_step_query_plan(cars_per_row: int, num_waypoints: int,
                        pairs: bool = False, tail: bool = False) -> LaunchPlan:
    """The transition launch: K2's plan for the centre and four corners of each
    car (the kernel forms the corners itself). With the pair test, the row's cars
    (10 floats each) sit beside the staged row; with the multi-car env's tail, 9
    words a car after them. Raises ValueError where they do not fit in 227 KB."""
    plan = progress_collision_plan(cars_per_row, 4, num_waypoints)
    if not (pairs or tail):
        return plan
    smem = plan.smem + ((PAIR_FLOATS_PER_CAR if pairs else 0)
                        + (TAIL_WORDS_PER_CAR if tail else 0)) * cars_per_row * 4
    if smem > BLOCK_SMEM_LIMIT:
        parts = " and ".join(p for p, on in (("the pair test", pairs), ("the env's tail", tail))
                             if on)
        raise ValueError(f"car_step_and_query: a row of {num_waypoints} waypoints and "
                         f"{parts} of {cars_per_row} cars need {smem:,} bytes of shared "
                         f"memory; a block has {BLOCK_SMEM_LIMIT:,}")
    return dataclasses.replace(plan, smem=smem)


@dataclasses.dataclass(frozen=True)
class ObservePlan:
    """How the multi-car observation is launched: one block of ``threads`` threads a
    ``rows_per_block`` env rows, ``smem`` bytes of dynamic shared memory, the rays of
    a row in groups of ``rays_per_lane`` (one car's rays where ``per_car``), a
    (group, run) item a lane; the run results over the staged rows where
    ``overlay``. Where ``small``, the first kernel (a block a row, as
    ``raycast_walls_and_cars_plan`` says)."""
    threads: int
    smem: int
    rays_per_lane: int
    per_car: bool
    rows_per_block: int
    overlay: bool
    small: bool = False


def _observe_shape(num_cars: int, num_sensors: int, num_segments: int, rows_per_block: int,
                   warps: int | None = None) -> ObservePlan:
    """``multi_observe`` at ``rows_per_block`` rows and ``warps`` warps a block (by
    default a warp a ray group and row, at most 8): the rays in K1's groups, the run
    results over the staged rows wherever every (group, run) item has a thread and
    the results fit there (more blocks an SM, for a barrier). Checks nothing."""
    walls = raycast_walls_plan(num_cars * num_sensors, num_segments)
    rays = num_cars * num_sensors
    rpl = walls.rays_per_lane
    groups = -(-rays // rpl)
    slots = groups * rpl
    warps = warps or min(MAX_THREADS // 32, rows_per_block * groups)
    overlay = (warps >= rows_per_block * groups
               and K1_FIELDS * _field_capacity(num_segments) >= 2 * slots * OBSERVE_RUN_STRIDE)
    # csrc/multi_observe.cu:Layout: a block's staged rows (five fields of S floats, no
    # padding), ray table, cars and (ray, car) minima, and the run results unless
    # they overlay the rows
    floats = (K1_FIELDS * _field_capacity(num_segments) + slots * OBSERVE_RAY_FLOATS
              + K3_FLOATS_PER_CAR * num_cars + rays * num_cars
              + (0 if overlay else 2 * slots * OBSERVE_RUN_STRIDE))
    return ObservePlan(32 * warps, rows_per_block * floats * 4, rpl, rpl == num_sensors,
                       rows_per_block, overlay)


@functools.lru_cache(maxsize=256)
def multi_observe_plan(num_cars: int, num_sensors: int, num_segments: int,
                       rows: int | None = None) -> ObservePlan:
    """The multi-car observation's launch of ``rows`` env rows (None: many). Under
    ``OBSERVE_SMALL_BELOW`` rows the first kernel. Else ``multi_observe``: a row's
    rays go in K1's groups (``raycast_walls_plan``: at most 11 rays a lane, as evenly
    as the instantiations allow), which are one car's rays wherever that gives one
    car a group (``per_car``: the kernel then forms each segment's cross term once a
    car); a block stages as many rows as give it ``OBSERVE_WARPS`` warps of 32 runs a
    ray group, fewer where they would not fit in 227 KB, and takes a warp a ray group
    and row (at most 8). Raises ValueError where one row does not fit."""
    if rows is not None and rows < OBSERVE_SMALL_BELOW:
        first = raycast_walls_and_cars_plan(num_cars, num_sensors, num_segments)
        return ObservePlan(first.threads, first.smem, first.rays_per_lane, False, 1, False,
                           small=True)
    groups = -(-num_cars * num_sensors
               // raycast_walls_plan(num_cars * num_sensors, num_segments).rays_per_lane)
    dynamic_limit = BLOCK_SMEM_LIMIT - STATIC_SMEM_RESERVE
    plan = _observe_shape(num_cars, num_sensors, num_segments, max(1, OBSERVE_WARPS // groups))
    while plan.rows_per_block > 1 and plan.smem > dynamic_limit:
        plan = _observe_shape(num_cars, num_sensors, num_segments, plan.rows_per_block - 1)
    if plan.smem > dynamic_limit:
        raise ValueError(f"multi_observe: a row of {num_segments} segments and {num_cars} "
                         f"cars needs {plan.smem:,} bytes of shared memory; a block has "
                         f"{dynamic_limit:,} beside the kernel's own")
    return plan


@dataclasses.dataclass(frozen=True)
class TransitionPlan:
    """How the multi-car transition is launched: one block of ``threads`` threads per
    ``rows_per_block`` env rows, ``smem`` bytes of dynamic shared memory. Where
    ``small``, the first kernel (a block a row, as ``car_step_query_plan(...,
    tail=True)`` says)."""
    threads: int
    smem: int
    rows_per_block: int
    small: bool = False


def _transition_shape(cars_per_row: int, num_waypoints: int,
                      rows_per_block: int) -> TransitionPlan:
    """``multi_transition`` at ``rows_per_block`` rows a block: each row's two
    position fields (W floats each) beside 18 words a car and 2 a row; a warp a car
    for the search, at most 4. Checks nothing."""
    smem = rows_per_block * (K2_FIELDS * _field_capacity(num_waypoints)
                             + TRANSITION_WORDS_PER_ROW
                             + TRANSITION_WORDS_PER_CAR * cars_per_row) * 4
    return TransitionPlan(32 * min(4, max(1, rows_per_block * cars_per_row)), smem,
                          rows_per_block)


@functools.lru_cache(maxsize=256)
def multi_transition_plan(cars_per_row: int, num_waypoints: int, pairs: bool,
                          rows: int | None = None) -> TransitionPlan:
    """The multi-car transition's launch of ``rows`` env rows (None: many), the pair
    test run where ``pairs``. Under ``TRANSITION_SMALL_BELOW`` rows the first kernel.
    Else ``multi_transition``: a block serves ``TRANSITION_CARS`` cars' worth of rows,
    fewer where they would not fit in 227 KB; a thread a car for the step, the pair
    test and the tail, a warp a car for the search (at most 4 warps, looping over the
    rest). Raises ValueError where one row does not fit."""
    if num_waypoints < 1:
        raise ValueError("multi_transition: the kernel needs at least one waypoint")
    if rows is not None and rows < TRANSITION_SMALL_BELOW:
        first = car_step_query_plan(cars_per_row, num_waypoints, pairs, tail=True)
        return TransitionPlan(first.threads, first.smem, 1, small=True)
    dynamic_limit = BLOCK_SMEM_LIMIT - STATIC_SMEM_RESERVE
    preferred = min(TRANSITION_MAX_ROWS_PER_BLOCK, TRANSITION_CARS // max(1, cars_per_row))
    plan = _transition_shape(cars_per_row, num_waypoints, max(1, preferred))
    while plan.rows_per_block > 1 and plan.smem > dynamic_limit:
        plan = _transition_shape(cars_per_row, num_waypoints, plan.rows_per_block - 1)
    if plan.smem > dynamic_limit:
        raise ValueError(f"multi_transition: a row of {num_waypoints} waypoints and "
                         f"{cars_per_row} cars needs {plan.smem:,} bytes of shared memory; "
                         f"a block has {dynamic_limit:,} beside the kernel's own")
    return plan


def launch_raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, c, out,
                         rows: int, rays_per_row: int, num_segments: int,
                         max_dist: float, row_ids=None) -> None:
    """Launch K1 on ``out.device``'s current stream, as ``raycast_walls_plan``
    says (which raises before any launch on what the kernel cannot take).
    Tensors are contiguous f32; ``row_ids`` (int32 [rows], or None for row i)
    names the segment row each row of rays stages."""
    plan = raycast_walls_plan(rays_per_row, num_segments)
    _call("raycast_walls", "raycast_walls_f32", out.device,
          *map(_ptr, (ox, oy, dx, dy, sx, sy, vx, vy, c, row_ids, out)),
          rows, rays_per_row, num_segments, float(max_dist), plan.threads, plan.smem,
          plan.rays_per_lane)


def launch_progress_and_collision(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp,
                                  track_width, progress, crashed, rows: int,
                                  cars_per_row: int, num_corners: int,
                                  num_waypoints: int) -> None:
    """Launch K2 on ``progress.device``'s current stream, as
    ``progress_collision_plan`` says: ``rows`` waypoint rows, car i against row
    ``i // cars_per_row``. Tensors are contiguous (f32, ``n_wp`` int32,
    ``crashed`` bool)."""
    plan = progress_collision_plan(cars_per_row, num_corners, num_waypoints)
    _call("progress_collision", "progress_and_collision_f32", progress.device,
          *map(_ptr, (x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width,
                      progress, crashed)),
          rows, cars_per_row, num_corners, num_waypoints, plan.threads, plan.smem)


def launch_raycast_cars(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, out,
                        rows: int, rays_per_row: int, num_cars: int,
                        max_dist: float) -> None:
    """Launch K3 on ``out.device``'s current stream. Tensors are contiguous f32."""
    _call("raycast_cars", "raycast_cars_f32", out.device,
          *map(_ptr, (ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, out)),
          rows, rays_per_row, num_cars, float(max_dist))


def launch_rectangles_intersect(cx, cy, pairs, rows: int, num_cars: int) -> None:
    """Launch K4 on ``pairs.device``'s current stream: corners contiguous f32
    [rows, num_cars, 4], ``pairs`` contiguous bool [rows, num_cars, num_cars]."""
    _call("rectangles_intersect", "rectangles_intersect_u8", pairs.device,
          _ptr(cx), _ptr(cy), _ptr(pairs), rows, num_cars)


def launch_car_update(x, y, angle, vx, vy, crashed, steering, throttle, nx, ny,
                      nang, nvx, nvy, n: int, constants) -> None:
    """Launch K5 on ``nx.device``'s current stream: ``n`` cars, contiguous f32
    fields (``crashed`` bool); ``constants`` the eight float32 values the kernel
    takes (steering_speed, acceleration, drag, lateral_friction, grip, max_speed,
    dt, 2*pi)."""
    _call("car_update", "car_update_f32", nx.device,
          *map(_ptr, (x, y, angle, vx, vy, crashed, steering, throttle, nx, ny, nang,
                      nvx, nvy)),
          n, *map(float, constants))


def launch_raycast_walls_and_cars(x, y, angle, rel, sx, sy, vx, vy, c, out, rows: int,
                                  num_cars: int, num_sensors: int, num_segments: int,
                                  half_length: float, half_width: float,
                                  max_dist: float, row_ids=None) -> None:
    """Launch the multi-car sensing kernel on ``out.device``'s current stream, as
    ``raycast_walls_and_cars_plan`` says. Tensors are contiguous f32;
    ``half_length`` and ``half_width`` are float32 values; ``row_ids`` (int32
    [rows], or None for row i) names the segment row each env row stages."""
    plan = raycast_walls_and_cars_plan(num_cars, num_sensors, num_segments)
    _call("raycast_walls_and_cars", "raycast_walls_and_cars_f32", out.device,
          *map(_ptr, (x, y, angle, rel, sx, sy, vx, vy, c, row_ids, out)),
          rows, num_cars, num_sensors, num_segments, float(half_length),
          float(half_width), float(max_dist), plan.threads, plan.smem, plan.rays_per_lane)


def launch_car_step_and_query(x, y, angle, vx, vy, crashed, steering, throttle, wp_x,
                              wp_y, nrm_x, nrm_y, n_wp, track_width, nx, ny, nang, nvx,
                              nvy, ccx, ccy, progress, hit_wall, rows: int,
                              cars_per_row: int, num_waypoints: int, constants,
                              num_hits=None, collision_scale: float = 1.0,
                              row_ids=None) -> None:
    """Launch the transition kernel on ``nx.device``'s current stream, as
    ``car_step_query_plan`` says: ``rows`` waypoint rows, car i against row
    ``i // cars_per_row``. Tensors are contiguous (f32, ``crashed`` and ``hit_wall``
    bool, ``n_wp`` int32; ``n_wp`` and ``track_width`` one per row); ``constants``
    the ten float32 values the kernel takes (K5's eight, then the half length and
    half width). ``num_hits`` (int32, one per car) runs the pair test over each
    row's cars, which must be one race, and scales their velocities by the float32
    ``collision_scale`` once per partner; None skips it. ``row_ids`` (int32
    [rows], or None for row i) names the waypoint row each row of cars stages;
    ``n_wp`` and ``track_width`` stay one per row of cars."""
    plan = car_step_query_plan(cars_per_row, num_waypoints, num_hits is not None)
    _call("car_step_and_query", "car_step_and_query_f32", nx.device,
          *map(_ptr, (x, y, angle, vx, vy, crashed, steering, throttle, wp_x, wp_y, nrm_x,
                      nrm_y, row_ids, n_wp, track_width, nx, ny, nang, nvx, nvy, ccx, ccy,
                      progress, hit_wall, num_hits)),
          rows, cars_per_row, num_waypoints, plan.threads, plan.smem,
          *map(float, constants), float(collision_scale))


def launch_multi_observe(x, y, angle, vx, vy, last_steering, max_track_distance, rel, sx,
                         sy, seg_vx, seg_vy, c, obs, rows: int, num_cars: int,
                         num_sensors: int, num_segments: int, half_length: float,
                         half_width: float, max_dist: float, inv_range: float,
                         inv_max_speed: float, clamp_range: bool, row_ids=None) -> None:
    """Launch the multi-car env's observation on ``obs.device``'s current stream, as
    ``multi_observe_plan`` says. Tensors are contiguous f32 (the car fields [rows *
    num_cars], ``max_track_distance`` [rows], ``obs`` [rows, num_cars, num_sensors +
    4 * num_cars]); the floats are float32 values."""
    plan = multi_observe_plan(num_cars, num_sensors, num_segments, rows)
    args = (*map(_ptr, (x, y, angle, vx, vy, last_steering, max_track_distance, rel, sx, sy,
                        seg_vx, seg_vy, c, row_ids, obs)),
            rows, num_cars, num_sensors, num_segments, float(half_length), float(half_width),
            float(max_dist), float(inv_range), float(inv_max_speed), int(clamp_range),
            plan.threads, plan.smem, plan.rays_per_lane)
    if plan.small:
        _call("raycast_walls_and_cars", "multi_observe_small_f32", obs.device, *args)
    else:
        _call("multi_observe", "multi_observe_f32", obs.device, *args, int(plan.per_car),
              plan.rows_per_block, int(plan.overlay))


def launch_multi_transition(ptrs, constants, rows: int, cars_per_row: int,
                            num_waypoints: int, pairs: bool, max_steps: int,
                            device: torch.device) -> None:
    """Launch the multi-car env's transition on ``device``'s current stream, as
    ``multi_transition_plan`` says: ``ptrs`` the ``TRANSITION_PTRS`` tensors (or None)
    in the order of ``csrc/multi_transition.cu:multi_transition_f32``, ``constants``
    its ``TRANSITION_CONSTS`` float32 values (the first kernel takes the same)."""
    if len(ptrs) != TRANSITION_PTRS or len(constants) != TRANSITION_CONSTS:
        raise ValueError(f"multi_transition: {len(ptrs)} pointers and {len(constants)} "
                         f"constants, expected {TRANSITION_PTRS} and {TRANSITION_CONSTS}")
    plan = multi_transition_plan(cars_per_row, num_waypoints, pairs, rows)
    ptr_array = (ctypes.c_void_p * TRANSITION_PTRS)(*map(_ptr, ptrs))
    const_array = (ctypes.c_float * TRANSITION_CONSTS)(*map(float, constants))
    args = (ptr_array, TRANSITION_PTRS, const_array, TRANSITION_CONSTS, rows, cars_per_row,
            num_waypoints, plan.threads, plan.smem, int(pairs), int(max_steps))
    if plan.small:
        _call("car_step_and_query", "multi_transition_small_f32", device, *args)
    else:
        _call("multi_transition", "multi_transition_f32", device, *args, plan.rows_per_block)


# ppo_head (csrc/ppo_head.cu): its input pointers and float32 constants
PPO_HEAD_INPUTS = 10
PPO_HEAD_CONSTS = 6
# adam_tail (csrc/adam_tail.cu): the parameter tensors one launch takes at most, and
# its loop pointers and float32 constants
ADAM_TAIL_MAX_TENSORS = 32
ADAM_TAIL_LOOP_PTRS = 14
ADAM_TAIL_CONSTS = 7


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*map(_ptr, tensors))


def _float_array(values):
    return (ctypes.c_float * len(values))(*map(float, values))


def launch_ppo_head_forward(inputs, constants, outputs, n: int) -> None:
    """Launch the loss head's forward on the current stream of ``outputs[0]``'s
    device: ``inputs`` the ``PPO_HEAD_INPUTS`` tensors and ``constants`` the
    ``PPO_HEAD_CONSTS`` float32 values in the order of
    ``csrc/ppo_head.cu:HeadArgs``, ``outputs`` the four [n] tensors it writes."""
    if len(inputs) != PPO_HEAD_INPUTS or len(constants) != PPO_HEAD_CONSTS:
        raise ValueError(f"ppo_head: {len(inputs)} inputs and {len(constants)} constants, "
                         f"expected {PPO_HEAD_INPUTS} and {PPO_HEAD_CONSTS}")
    _call("ppo_head", "ppo_head_forward_f32", outputs[0].device, _ptr_array(inputs),
          PPO_HEAD_INPUTS, _float_array(constants), PPO_HEAD_CONSTS, _ptr_array(outputs), n)


def launch_ppo_head_backward(inputs, constants, g_pg, pg_stride: int, g_vm, vm_stride: int,
                             g_mu, g_v, n: int) -> None:
    """Launch the loss head's backward on the current stream of ``g_mu``'s device:
    the forward's ``inputs`` and ``constants``, the upstream gradients of its two
    maxima (None for none; stride 1, or 0 for an expanded one), out ``g_mu`` [n, 2]
    and ``g_v`` [n]."""
    _call("ppo_head", "ppo_head_backward_f32", g_mu.device, _ptr_array(inputs),
          PPO_HEAD_INPUTS, _float_array(constants), PPO_HEAD_CONSTS, _ptr(g_pg), pg_stride,
          _ptr(g_vm), vm_stride, _ptr(g_mu), _ptr(g_v), n)


def launch_adam_tail(tensors, loop, constants, bc_rows: int, stats_rows: int,
                     device: torch.device) -> None:
    """Launch the minibatch step's tail on ``device``'s current stream: ``tensors``
    (parameter, gradient, mu, nu) tuples of contiguous float32 tensors, ``loop`` the
    ``ADAM_TAIL_LOOP_PTRS`` tensors and ``constants`` the ``ADAM_TAIL_CONSTS`` float32
    values in the order of ``csrc/adam_tail.cu:Loop``."""
    if not 1 <= len(tensors) <= ADAM_TAIL_MAX_TENSORS:
        raise ValueError(f"adam_tail: {len(tensors)} parameter tensors; the kernel takes "
                         f"1 to {ADAM_TAIL_MAX_TENSORS}")
    if len(loop) != ADAM_TAIL_LOOP_PTRS or len(constants) != ADAM_TAIL_CONSTS:
        raise ValueError(f"adam_tail: {len(loop)} loop tensors and {len(constants)} "
                         f"constants, expected {ADAM_TAIL_LOOP_PTRS} and {ADAM_TAIL_CONSTS}")
    sizes = (ctypes.c_longlong * len(tensors))(*(t[0].numel() for t in tensors))
    _call("adam_tail", "adam_tail_f32", device,
          _ptr_array([x for t in tensors for x in t]), sizes, len(tensors),
          _ptr_array(loop), ADAM_TAIL_LOOP_PTRS, _float_array(constants), ADAM_TAIL_CONSTS,
          bc_rows, stats_rows)


def launch_compute_gae(rewards, dones, values, next_value, next_done, adv, ret,
                       num_steps: int, num_envs: int, g: float, gl: float) -> None:
    """Launch K6 on ``adv.device``'s current stream. Tensors are contiguous (f32,
    ``dones``/``next_done`` bool)."""
    _call("gae", "compute_gae_f32", adv.device,
          *map(_ptr, (rewards, dones, values, next_value, next_done, adv, ret)),
          num_steps, num_envs, g, gl)


def launch_mixbits_permutation(consts, out, num_perms: int, log2_n: int) -> None:
    """Launch K7 on ``out.device``'s current stream: ``consts`` contiguous int64
    [num_perms, 8], ``out`` contiguous int32 [num_perms, 2^log2_n]."""
    _call("mixbits_permutation", "mixbits_permutation_i32", out.device,
          _ptr(consts), _ptr(out), num_perms, log2_n)
