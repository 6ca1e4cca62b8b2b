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
           "ppo_head.cu", "adam_tail.cu", "single_transition.cu", "mlp_towers.cu",
           "policy.cu", "mlp_general.cu", "policy_general.cu")
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
    "multi_transition_small_f32": [_P, _I, _P, _I] + [_I] * 10 + [_I, _P],
    "multi_observe_small_f32": [_P] * 15 + [_I] * 4 + [_F] * 5 + [_I] * 5 + [_I, _P],
    "multi_transition_f32": [_P, _I, _P, _I] + [_I] * 11 + [_I, _P],
    "multi_observe_f32": [_P] * 15 + [_I] * 4 + [_F] * 5 + [_I] * 9 + [_I, _P],
    "ppo_head_forward_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _L, _L, _L, _L, _I, _P],
    "ppo_head_backward_f32": [_P, _I, _P, _I, _P, _P, _P, _L, _L, _L, _L, _I, _P],
    "ppo_head_partials": [_L],
    "advantage_moments_f32": [_P, _P, _P, _L, _L, _L, _L, _I, _P],
    "adam_tail_f32": [_P, _P, _I, _P, _I, _P, _I, _L, _L, _I, _P],
    "single_transition_f32": [_P, _I, _P, _I] + [_I] * 6 + [_I, _P],
    "single_transition_rows_f32": [_P, _I, _P, _I] + [_I] * 9 + [_I, _P],
    "mlp_forward_f32": [_P, _I, _L, _L, _L, _I, _I, _I, _I, _P],
    "mlp_backward_f32": [_P, _I, _L, _L, _L, _I, _I, _I, _I, _P],
    "mlp_grad_reduce_f32": [_P, _P, _L, _L, _I, _P],
    "mlp_grad_reduce_norm_f32": [_P] * 5 + [_L, _L, _I, _P],
    "mlp_grad_norm_blocks": [_L],
    "mlp_rows_per_tile": [],
    "mlp_shared_bytes": [_I, _I, _I],
    "mlp_partial_rows": [_L],
    "mlp_blocks_per_sm": [_I, _I, _I, _I],
    "mlp_launch_plan": [_I, _I, _I, _P],
    "policy_act_f32": [_P, _I, _L, _L, _L, _I, _I, _I, _P, _I, _I, _P],
    "pool_act_f32": [_P, _I, _L, _L, _L, _L, _L] + [_I] * 7 + [_P, _I, _I, _P],
    "policy_shared_bytes": [_I] * 4,
    "policy_rows_per_block": [_I],
    "mlp_general_gemm_plan": [_I, _L, _P, _I, _P],
    "mlp_general_partial_rows": [_L, _P, _I],
    "mlp_general_forward_f32": [_P, _I, _L, _L, _L, _P, _I, _L, _I, _I, _P],
    "mlp_general_backward_f32": [_P, _I, _L, _L, _L, _P, _I, _L, _L, _L, _I, _I, _P],
    "general_grad_reduce_f32": [_P] * 5 + [_L, _L, _I, _P],
    "policy_general_plan": [_I, _P, _I, _P],
    "policy_general_act_f32": [_P, _I, _L, _L, _L, _P, _I, _P, _I, _I, _P],
    "policy_general_pool_f32": [_P, _I, _L, _L, _L, _L, _L] + [_I] * 4 + [_P, _I, _P, _I, _I, _P],
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
# the pointers the transition entries take after their own for the NEXT_STEP
# autoreset (csrc/autoreset.cuh:kPtrs; all None: the plain transition), and the bits
# of their pfsp_mode: the opponent index per env (else one for all) and int64 (else
# int32), use_policy per env
AUTORESET_PTRS = 27
PFSP_IDX_PER_ENV, PFSP_IDX_WIDE, PFSP_USE_PER_ENV = 1, 2, 4
# multi_transition_f32's pointer and constant counts (csrc/multi_transition.cu): its
# own 44 and the autoreset's; the tail's 21 constants and the start grid's two
TRANSITION_PTRS = 44 + AUTORESET_PTRS
TRANSITION_CONSTS = 23
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
# single_transition (csrc/single_transition.cu): its pointer and constant counts (its
# own 41 and the autoreset's); for its kernel of several rows a block
# (single_transition_rows_f32), the rows a block serves at most and the words a car
# takes beside the staged row (its queries, its centre's winner and wall hit, and what
# its tail reads: the stepped car, the state the step carries over and the
# autoreset's start pose and running episode)
SINGLE_TRANSITION_PTRS = 41 + AUTORESET_PTRS
SINGLE_TRANSITION_CONSTS = 18
SINGLE_TRANSITION_MAX_ROWS_PER_BLOCK = 32
SINGLE_TRANSITION_WORDS_PER_CAR = 30
# The single-car transition's kernel of several rows a block, for the tiled layout
# alone (env i reads pool row i % T, so a block's rows T apart share one staged row):
# its shape (rows and warps a block), and the env rows from which the env launches it
# there. On an H100 (PERF.md, scripts/env_kernel_split.py --single --sweep) it was
# 0.3-1.7 us faster than a warp a row at 1280-2048 tiled rows and 3.0 at 4096, as fast
# at 1024-1152 and 0.25 us slower at 64. Of the port's paths only those on the
# canonical bench pool's tiled layout (chip_smoke.py) run it; `train single`,
# evaluation and the adapters gather a row an env and run a warp a row.
SINGLE_TRANSITION_ROWS = 8
SINGLE_TRANSITION_WARPS = 4
SINGLE_TRANSITION_ROWS_FROM = 1280
# the single-car observation: a row's rays in this many groups of one car's rays (the
# fewest rays a lane of K1's instantiations that gives as many), and rows a block; on
# the tiled layout (shared: a block's rows read one staged pool row) its own. On an
# H100 (the same sweep and scripts/env_kernel_split.py --single's shapes) 4 groups of
# 3 rays, a block a row, was the fastest of 11 shapes on per-env rows at 4096 rows,
# and at 1-8192 rows faster than the first kernel (a block a row, which ran under 640
# rows before) and the multi-car plan (a warp a row's 11 rays, at 4 rows a block),
# but at 1024 (the first kernel 0.5 us faster) and at 1344-1536: there the grouped
# plan's one wave, 10 blocks of a row an SM (1320 rows on 132 SMs), is spent and the
# multi-car plan's, 3 blocks of 4 rows (1584 rows), is not, and the latter was 1.1-2.5
# us faster. So on per-env rows the env runs the multi-car plan between those waves'
# ends, SINGLE_OBSERVE_MULTI_PLAN_ROWS. On the tiled layout 2 groups of 6 rays, 4
# rows a block sharing one staged row, was the fastest of 6 shapes at 4096 rows and
# faster than both others at 1-8192.
SINGLE_OBSERVE_GROUPS = 4
SINGLE_OBSERVE_ROWS = 1
SINGLE_OBSERVE_SHARED_GROUPS = 2
SINGLE_OBSERVE_SHARED_ROWS = 4
SINGLE_OBSERVE_MULTI_PLAN_ROWS = range(1321, 1585)


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
    ``raycast_walls_and_cars_plan`` says). Where ``shared_row``, a block's rows read
    one segment row, staged once (the launch gives their period)."""
    threads: int
    smem: int
    rays_per_lane: int
    per_car: bool
    rows_per_block: int
    overlay: bool
    small: bool = False
    shared_row: bool = False


def groups_are_cars(num_cars: int, num_sensors: int, rays_per_lane: int) -> bool:
    """Whether each group of ``rays_per_lane`` rays (the last ray repeated past a
    row's rays) holds one car's rays alone, so that they share its position as origin
    (``csrc/multi_observe.cu``'s per_car)."""
    rays = num_cars * num_sensors
    return all(g // num_sensors == (min(g + rays_per_lane, rays) - 1) // num_sensors
               for g in range(0, rays, rays_per_lane))


def _observe_shape(num_cars: int, num_sensors: int, num_segments: int, rows_per_block: int,
                   warps: int | None = None, rays_per_lane: int | None = None,
                   shared_row: bool = False) -> ObservePlan:
    """``multi_observe`` at ``rows_per_block`` rows and ``warps`` warps a block (by
    default a warp a ray group and row, at most 8), the rays in groups of
    ``rays_per_lane`` (by default K1's groups), the rows' segment row staged once
    where ``shared_row``: the run results over the staged rows wherever every (group,
    run) item has a thread and the results fit there (more blocks an SM, for a
    barrier). Checks nothing."""
    rays = num_cars * num_sensors
    rpl = rays_per_lane or raycast_walls_plan(rays, num_segments).rays_per_lane
    groups = -(-rays // rpl)
    slots = groups * rpl
    warps = warps or min(MAX_THREADS // 32, rows_per_block * groups)
    staged = K1_FIELDS * _field_capacity(num_segments) * (1 if shared_row else rows_per_block)
    results = 2 * slots * OBSERVE_RUN_STRIDE * rows_per_block
    overlay = warps >= rows_per_block * groups and staged >= results
    # csrc/multi_observe.cu:Layout: a block's staged rows (five fields of S floats, no
    # padding), ray table, cars and (ray, car) minima, and the run results unless
    # they overlay the rows
    per_row = slots * OBSERVE_RAY_FLOATS + K3_FLOATS_PER_CAR * num_cars + rays * num_cars
    floats = staged + rows_per_block * per_row + (0 if overlay else results)
    return ObservePlan(32 * warps, floats * 4, rpl, groups_are_cars(num_cars, num_sensors, rpl),
                       rows_per_block, overlay, shared_row=shared_row)


def _first_observe_plan(num_cars: int, num_sensors: int, num_segments: int) -> ObservePlan:
    """The first observation kernel's launch: a block a row, as
    ``raycast_walls_and_cars_plan`` says."""
    first = raycast_walls_and_cars_plan(num_cars, num_sensors, num_segments)
    return ObservePlan(first.threads, first.smem, first.rays_per_lane, False, 1, False,
                       small=True)


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
        return _first_observe_plan(num_cars, num_sensors, num_segments)
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


@functools.lru_cache(maxsize=256)
def single_observe_plan(num_sensors: int, num_segments: int, shared_row: bool = False,
                        rows: int | None = None) -> ObservePlan:
    """The single-car observation's launch, one car a row: ``multi_observe`` with a
    row's rays in ``SINGLE_OBSERVE_GROUPS`` groups (the fewest rays a lane that give
    as many; every group is the one car's rays, so the kernel forms the cross term
    once a segment a group), ``SINGLE_OBSERVE_ROWS`` rows a block (fewer where they
    would not fit in 227 KB) and a warp a group and row. A staged row of 896 segments
    takes 18.4 KB, so an SM holds 12 rows whatever the block; the groups set the warps
    on each: 11 rays a lane (``multi_observe_plan(1, ...)``) one warp a row,
    12 warps an SM; 4 groups of 3 rays 4 warps a row, and at the kernel's 48 registers
    an SM holds 10 such blocks, 40 warps. ``shared_row`` (the tiled layout, whose
    rows a period apart read one pool row): ``SINGLE_OBSERVE_SHARED_GROUPS`` groups
    and ``SINGLE_OBSERVE_SHARED_ROWS`` rows a block, which stages that row once (a
    quarter of the bytes at 4 rows). On per-env ``rows`` in
    ``SINGLE_OBSERVE_MULTI_PLAN_ROWS``, ``multi_observe_plan(1, ...)``'s (a warp a
    row's rays). Raises ValueError where one row does not fit."""
    if num_segments < 1:
        raise ValueError("single_observe: the kernel needs at least one segment")
    if not shared_row and rows is not None and rows in SINGLE_OBSERVE_MULTI_PLAN_ROWS:
        return multi_observe_plan(1, num_sensors, num_segments, rows)
    even = -(-num_sensors // (SINGLE_OBSERVE_SHARED_GROUPS if shared_row
                              else SINGLE_OBSERVE_GROUPS))
    rpl = min(r for r in K1_RAYS_PER_LANE_CHOICES if r >= min(even, K1_RAYS_PER_LANE))
    dynamic_limit = BLOCK_SMEM_LIMIT - STATIC_SMEM_RESERVE
    rows = SINGLE_OBSERVE_SHARED_ROWS if shared_row else SINGLE_OBSERVE_ROWS
    plan = _observe_shape(1, num_sensors, num_segments, rows, rays_per_lane=rpl,
                          shared_row=shared_row)
    while plan.rows_per_block > 1 and plan.smem > dynamic_limit:
        plan = _observe_shape(1, num_sensors, num_segments, plan.rows_per_block - 1,
                              rays_per_lane=rpl, shared_row=shared_row)
    if plan.smem > dynamic_limit:
        raise ValueError(f"single_observe: a row of {num_segments} segments needs "
                         f"{plan.smem:,} bytes of shared memory; a block has "
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


def _fits(plan, what: str, num_waypoints: int) -> TransitionPlan:
    """``plan``, or ValueError where its row buffers do not fit in 227 KB."""
    dynamic_limit = BLOCK_SMEM_LIMIT - STATIC_SMEM_RESERVE
    if plan.smem > dynamic_limit:
        raise ValueError(f"{what}: a row of {num_waypoints} waypoints needs {plan.smem:,} "
                         f"bytes of shared memory; a block has {dynamic_limit:,} beside the "
                         "kernel's own")
    return plan


@functools.lru_cache(maxsize=256)
def single_transition_plan(num_waypoints: int) -> TransitionPlan:
    """The single-car transition's launch: a block (one warp) a row, which stages the
    row's two position fields (W floats each). Raises ValueError where a row does not
    fit."""
    if num_waypoints < 1:
        raise ValueError("single_transition: the kernel needs at least one waypoint")
    return _fits(TransitionPlan(32, K2_FIELDS * _field_capacity(num_waypoints) * 4, 1),
                 "single_transition", num_waypoints)


@functools.lru_cache(maxsize=256)
def single_transition_rows_plan(num_waypoints: int) -> TransitionPlan:
    """The single-car transition's kernel of several rows a block, on the tiled
    layout: ``SINGLE_TRANSITION_ROWS`` rows a block, which share one pool row, staged
    once (its two position fields), and 30 words a row beside it; one warp stepping
    them and running their tails a thread a car, ``SINGLE_TRANSITION_WARPS`` warps
    searching them a warp a car. Raises ValueError where a row does not fit."""
    if num_waypoints < 1:
        raise ValueError("single_transition: the kernel needs at least one waypoint")
    rows = SINGLE_TRANSITION_ROWS
    smem = (K2_FIELDS * _field_capacity(num_waypoints)
            + rows * SINGLE_TRANSITION_WORDS_PER_CAR) * 4
    return _fits(TransitionPlan(32 * SINGLE_TRANSITION_WARPS, smem, rows),
                 "single_transition", num_waypoints)


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
                         inv_max_speed: float, clamp_range: bool, row_ids=None,
                         cars: bool = True, plan: ObservePlan | None = None,
                         row_period: int = 0) -> None:
    """Launch the multi-car env's observation on ``obs.device``'s current stream, as
    ``plan`` says (by default ``multi_observe_plan``'s). Tensors are contiguous f32
    (the car fields [rows * num_cars], ``max_track_distance`` [rows], ``obs`` [rows,
    num_cars, num_sensors + 4 * num_cars]); the floats are float32 values.
    ``cars=False`` leaves out the rays' car pass and its minimum: each ray is its wall
    hit alone (the single-car env's observation, at one car a row, with
    ``single_observe_plan``). A plan with ``shared_row`` takes ``row_period`` T: env
    row i reads segment row i % T (the tiled layout)."""
    if plan is not None and plan.shared_row and row_period < 1:
        raise ValueError("multi_observe: a plan that shares a staged row needs its period")
    plan = plan or multi_observe_plan(num_cars, num_sensors, num_segments, rows)
    args = (*map(_ptr, (x, y, angle, vx, vy, last_steering, max_track_distance, rel, sx, sy,
                        seg_vx, seg_vy, c, row_ids, obs)),
            rows, num_cars, num_sensors, num_segments, float(half_length), float(half_width),
            float(max_dist), float(inv_range), float(inv_max_speed), int(clamp_range),
            plan.threads, plan.smem, plan.rays_per_lane)
    if plan.small:
        _call("raycast_walls_and_cars", "multi_observe_small_f32", obs.device, *args,
              int(cars))
    else:
        _call("multi_observe", "multi_observe_f32", obs.device, *args, int(plan.per_car),
              plan.rows_per_block, int(plan.overlay), int(cars),
              int(row_period) if plan.shared_row else 0)


def launch_multi_transition(ptrs, constants, rows: int, cars_per_row: int,
                            num_waypoints: int, pairs: bool, max_steps: int,
                            device: torch.device, steps: int = 0, pool: int = 0,
                            pfsp_mode: int = 0) -> None:
    """Launch the multi-car env's transition on ``device``'s current stream, as
    ``multi_transition_plan`` says: ``ptrs`` the ``TRANSITION_PTRS`` tensors (or None)
    in the order of ``csrc/multi_transition.cu:multi_transition_f32``, ``constants``
    its ``TRANSITION_CONSTS`` float32 values (the first kernel takes the same); for
    the autoreset the rollout's ``steps``, the ``pool``'s slots and ``pfsp_mode``."""
    if len(ptrs) != TRANSITION_PTRS or len(constants) != TRANSITION_CONSTS:
        raise ValueError(f"multi_transition: {len(ptrs)} pointers and {len(constants)} "
                         f"constants, expected {TRANSITION_PTRS} and {TRANSITION_CONSTS}")
    plan = multi_transition_plan(cars_per_row, num_waypoints, pairs, rows)
    ptr_array = (ctypes.c_void_p * TRANSITION_PTRS)(*map(_ptr, ptrs))
    const_array = (ctypes.c_float * TRANSITION_CONSTS)(*map(float, constants))
    args = (ptr_array, TRANSITION_PTRS, const_array, TRANSITION_CONSTS, rows, cars_per_row,
            num_waypoints, plan.threads, plan.smem, int(pairs), int(max_steps))
    reset = (int(steps), int(pool), int(pfsp_mode))
    if plan.small:
        _call("car_step_and_query", "multi_transition_small_f32", device, *args, *reset)
    else:
        _call("multi_transition", "multi_transition_f32", device, *args, plan.rows_per_block,
              *reset)


def launch_single_transition(ptrs, constants, rows: int, num_waypoints: int,
                             max_steps: int, action_stride: int, device: torch.device,
                             row_period: int = 0, steps: int = 0) -> bool:
    """Launch the single-car env's transition on ``device``'s current stream:
    ``ptrs`` the ``SINGLE_TRANSITION_PTRS`` tensors (or None) in the order of
    ``csrc/single_transition.cu:single_transition_f32``, ``constants`` its
    ``SINGLE_TRANSITION_CONSTS`` float32 values, the action's rows ``action_stride``
    floats apart. A warp a row (``single_transition_plan``); where env i reads pool
    row i % ``row_period`` (the tiled layout; 0: not known) and from
    ``SINGLE_TRANSITION_ROWS_FROM`` rows, the kernel of several rows a block
    (``single_transition_rows_plan``), which takes the same and gives a block rows
    that period apart, which share one staged row. ``steps``: the rollout's rows, for
    the autoreset's row writes. Returns whether the latter ran."""
    if len(ptrs) != SINGLE_TRANSITION_PTRS or len(constants) != SINGLE_TRANSITION_CONSTS:
        raise ValueError(f"single_transition: {len(ptrs)} pointers and {len(constants)} "
                         f"constants, expected {SINGLE_TRANSITION_PTRS} and "
                         f"{SINGLE_TRANSITION_CONSTS}")
    args = (_ptr_array(ptrs), SINGLE_TRANSITION_PTRS, _float_array(constants),
            SINGLE_TRANSITION_CONSTS, rows, num_waypoints)
    by_rows = row_period > 0 and rows >= SINGLE_TRANSITION_ROWS_FROM
    if by_rows:
        plan = single_transition_rows_plan(num_waypoints)
        _call("single_transition", "single_transition_rows_f32", device, *args, plan.threads,
              plan.smem, int(max_steps), int(action_stride), plan.rows_per_block,
              int(row_period), int(steps))
    else:
        plan = single_transition_plan(num_waypoints)
        _call("single_transition", "single_transition_f32", device, *args, plan.smem,
              int(max_steps), int(action_stride), int(steps))
    return by_rows


# ppo_head (csrc/ppo_head.cu): its input pointers (the unit ids last, null for none)
# and float32 constants
PPO_HEAD_INPUTS = 11
PPO_HEAD_CONSTS = 9
# adam_tail (csrc/adam_tail.cu): the parameter tensors one launch takes at most, and
# its loop pointers and float32 constants
ADAM_TAIL_MAX_TENSORS = 32
ADAM_TAIL_LOOP_PTRS = 14
ADAM_TAIL_CONSTS = 7
# adam_tail's pointer and size tables by the pointers they hold: the eager paths (a
# gloo rank, eager=True, a tensor-parallel rank) launch on one parameter set a
# minibatch after another, so each set's ctypes tables are built once
_ADAM_TAIL_TABLES: dict = {}
_ADAM_TAIL_TABLES_MAX = 16


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*map(_ptr, tensors))


def _float_array(values):
    return (ctypes.c_float * len(values))(*map(float, values))


def _head_inputs(inputs, unit_ids):
    """The kernel's pointer table, the unit-indexed fields' (block, units) and the
    moments' rows: with ``unit_ids``, the actions [units, block, 2] and old log-probs
    [units, block]."""
    if len(inputs) != PPO_HEAD_INPUTS - 1:
        raise ValueError(f"ppo_head: {len(inputs)} inputs, expected {PPO_HEAD_INPUTS - 1}")
    moment_rows = inputs[8].shape[0]
    if unit_ids is None:
        return _ptr_array(list(inputs) + [None]), 0, 0, moment_rows
    units, block = inputs[3].shape
    return _ptr_array(list(inputs) + [unit_ids]), block, units, moment_rows


def launch_ppo_head_forward(inputs, constants, loss, stats, n: int, unit_ids=None) -> None:
    """Launch the loss head's forward on the current stream of ``loss``'s device:
    ``inputs`` the ten tensors and ``constants`` the ``PPO_HEAD_CONSTS`` float32 values
    in the order of ``csrc/ppo_head.cu:HeadArgs``, ``loss`` (one float32) and ``stats``
    [6] what it writes; with ``unit_ids`` (int64 [n / block]) the actions, old
    log-probs, advantages, returns and old values are [units, block, ...] read
    through it. Its partial sums' scratch comes from the caller's allocator, its
    ticket is the card's (``ticket_counter``)."""
    if len(constants) != PPO_HEAD_CONSTS:
        raise ValueError(f"ppo_head: {len(constants)} constants, expected {PPO_HEAD_CONSTS}")
    dev = loss.device
    ptrs, block, units, rows = _head_inputs(inputs, unit_ids)
    partial = torch.empty((build()["ppo_head"].ppo_head_partials(n),), dtype=torch.float64,
                          device=dev)
    _call("ppo_head", "ppo_head_forward_f32", dev, ptrs, PPO_HEAD_INPUTS,
          _float_array(constants), PPO_HEAD_CONSTS, _ptr(partial),
          _ptr(ticket_counter(dev, "ppo_head")), _ptr(loss), _ptr(stats), n, block, units,
          rows)


def launch_ppo_head_backward(inputs, constants, g_loss, g_mu, g_v, n: int,
                             unit_ids=None) -> None:
    """Launch the loss head's backward on the current stream of ``g_mu``'s device:
    the forward's ``inputs``, ``constants`` and ``unit_ids``, the loss's upstream
    gradient ``g_loss`` (one float32), out ``g_mu`` [n, 2] and ``g_v`` [n]."""
    ptrs, block, units, rows = _head_inputs(inputs, unit_ids)
    _call("ppo_head", "ppo_head_backward_f32", g_mu.device, ptrs, PPO_HEAD_INPUTS,
          _float_array(constants), PPO_HEAD_CONSTS, _ptr(g_loss), _ptr(g_mu), _ptr(g_v), n,
          block, units, rows)


def launch_advantage_moments(advantages, index, table) -> None:
    """Launch every minibatch's advantage moments on the current stream of
    ``table``'s device: ``advantages`` [units, block] float32, ``index`` [rows, ids]
    int64 unit ids, out ``table`` [rows, 2] float32 (mean, unbiased std)."""
    units, block = advantages.shape
    rows, ids = index.shape
    _call("ppo_head", "advantage_moments_f32", table.device, _ptr(advantages), _ptr(index),
          _ptr(table), rows, ids, block, units)


def _adam_tail_tables(tensors, loop):
    """(pointer table of the (parameter, gradient, mu, nu) tuples ``tensors``, their
    element counts, pointer table of ``loop``): built once for each set of pointers
    and counts and kept (``_ADAM_TAIL_TABLES``)."""
    ptrs = tuple(x.data_ptr() for t in tensors for x in t)
    sizes = tuple(t[0].numel() for t in tensors)
    key = (ptrs, sizes, tuple(x.data_ptr() for x in loop))
    tables = _ADAM_TAIL_TABLES.get(key)
    if tables is None:
        if len(_ADAM_TAIL_TABLES) >= _ADAM_TAIL_TABLES_MAX:
            _ADAM_TAIL_TABLES.clear()
        tables = ((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(sizes))(*sizes),
                  (ctypes.c_void_p * len(loop))(*key[2]))
        _ADAM_TAIL_TABLES[key] = tables
    return tables


def launch_adam_tail(tensors, loop, constants, bc_rows: int, stats_rows: int,
                     device: torch.device) -> None:
    """Launch the minibatch step's tail on ``device``'s current stream, one thread
    block cluster: ``tensors`` (parameter, gradient, mu, nu) tuples of
    contiguous float32 tensors, ``loop`` the ``ADAM_TAIL_LOOP_PTRS`` tensors and
    ``constants`` the ``ADAM_TAIL_CONSTS`` float32 values (a ctypes array, or values)
    in the order of ``csrc/adam_tail.cu:Loop``."""
    if not 1 <= len(tensors) <= ADAM_TAIL_MAX_TENSORS:
        raise ValueError(f"adam_tail: {len(tensors)} parameter tensors; the kernel takes "
                         f"1 to {ADAM_TAIL_MAX_TENSORS}")
    if len(loop) != ADAM_TAIL_LOOP_PTRS or len(constants) != ADAM_TAIL_CONSTS:
        raise ValueError(f"adam_tail: {len(loop)} loop tensors and {len(constants)} "
                         f"constants, expected {ADAM_TAIL_LOOP_PTRS} and {ADAM_TAIL_CONSTS}")
    ptrs, sizes, loop_ptrs = _adam_tail_tables(tensors, loop)
    if not isinstance(constants, ctypes.Array):
        constants = _float_array(constants)
    _call("adam_tail", "adam_tail_f32", device, ptrs, sizes, len(tensors), loop_ptrs,
          ADAM_TAIL_LOOP_PTRS, constants, ADAM_TAIL_CONSTS, bc_rows, stats_rows)


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


# the actor's and critic's MLPs (csrc/mlp_towers.cu): the hidden widths (h1, h2) it
# is instantiated for (its MLP_HIDDEN; obs_dim is a run-time argument), the rows a
# tile (its kRows: 16 a warp, 4 warps a block), the backward's fixed blocks a tower
# (its kBackwardBlocks: the rows of its partials), the reduce's parameters a block
# (its kReduceLanes: a block's square of the norm), its pointer counts
MLP_HIDDEN = ((64, 64), (128, 128))
MLP_ROWS_PER_TILE = 64
MLP_BACKWARD_BLOCKS = 128
MLP_REDUCE_LANES = 32
MLP_WARPS = 4
MLP_TENSORS = 12
MLP_INPUTS = 2 + MLP_TENSORS


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mlp_shared_bytes(obs_dim: int, h1: int, h2: int) -> int:
    """The least shared bytes a block of either MLP kernel needs at towers obs_dim ->
    h1 -> h2 (the kernel's own ``mlp_shared_bytes``, held equal to this in
    chip_smoke.py phase p), 0 over ``BLOCK_SMEM_LIMIT``. As ``csrc/mlp_towers.cu:Layout``
    lays it out (floats): a tower's staged parameters (w1 padded to 8 rows, b1, w2,
    b2, w3 and b3 of two outputs, to 4 floats) and a tile of observations [rows][xs]
    (xs obs_dim rounded up to 16, and 8 more); the forward both
    towers and the tile, the backward one tower, the tile, h1 [rows][h1 + 8], g2
    [rows][h2 + 8] and the warps' narrow sums. Where more fits, the kernel's launch
    plan uses it (``mlp_launch_plan``)."""
    dk, d16 = _round_up(obs_dim, 8), _round_up(obs_dim, 16)
    xtile = MLP_ROWS_PER_TILE * (d16 + 8)
    tower = _round_up(dk * h1 + h1 + h1 * h2 + h2 + 2 * h2 + 2, 4)
    backward = (tower + xtile + MLP_ROWS_PER_TILE * (h1 + 8) + MLP_ROWS_PER_TILE * (h2 + 8)
                + _round_up(MLP_WARPS * (h1 + 3 * h2 + 2), 4))
    least = 4 * max(2 * tower + xtile, backward)
    return least if least <= BLOCK_SMEM_LIMIT else 0


def mlp_takes(obs_dim: int, h1: int, h2: int) -> bool:
    """Whether the kernels take towers obs_dim -> h1 -> h2: widths in ``MLP_HIDDEN``
    and both kernels' shared memory within ``BLOCK_SMEM_LIMIT``."""
    return (h1, h2) in MLP_HIDDEN and obs_dim >= 1 and mlp_shared_bytes(obs_dim, h1, h2) > 0


def mlp_max_obs_dim(h1: int, h2: int) -> int:
    """The largest obs_dim the kernels take at hidden (h1, h2), 0 for none."""
    d = 0
    while mlp_takes(d + 1, h1, h2):
        d += 1
    return d


def mlp_tiles(n: int) -> int:
    """The tiles of ``n`` rows (``MLP_ROWS_PER_TILE`` each)."""
    return -(-n // MLP_ROWS_PER_TILE)


def mlp_partial_rows(n: int) -> int:
    """The rows of the backward's partials at ``n`` rows: a row a block of its fixed
    grid, fewer where there are fewer tiles."""
    return min(mlp_tiles(n), MLP_BACKWARD_BLOCKS)


@functools.lru_cache(maxsize=None)
def _mlp_lib():
    lib = build()["mlp_towers"]
    got = (lib.mlp_rows_per_tile(), lib.mlp_partial_rows(1 << 40),
           lib.mlp_grad_norm_blocks(MLP_REDUCE_LANES + 1))
    if got != (MLP_ROWS_PER_TILE, MLP_BACKWARD_BLOCKS, 2):
        raise RuntimeError(f"csrc/mlp_towers.cu tiles {got[0]} rows, {got[1]} blocks a "
                           f"tower and reduces {MLP_REDUCE_LANES + 1} parameters in {got[2]} "
                           f"blocks; ops/_cuda.py {MLP_ROWS_PER_TILE}, "
                           f"{MLP_BACKWARD_BLOCKS} and 2")
    return lib


def _mlp_inputs(obs, unit_ids, params):
    """The kernels' input pointers (the observations, the unit ids or null, the 12
    parameters) and the unit-indexed observations' (block, units)."""
    if len(params) != MLP_TENSORS:
        raise ValueError(f"mlp: {len(params)} parameter tensors, expected {MLP_TENSORS}")
    if unit_ids is None:
        return [obs, None, *params], 0, 0
    return [obs, unit_ids, *params], obs.shape[1], obs.shape[0]


def launch_mlp_forward(obs, unit_ids, params, mu, v, n: int, dims) -> None:
    """Launch both towers' forward on the current stream of ``mu``'s device:
    ``obs`` [n, D] (or [units, block, D] read through ``unit_ids``), ``params`` the
    12 tensors in ``model.parameters()`` order, out ``mu`` [n, 2] and ``v`` [n];
    ``dims`` = (D, h1, h2), towers the kernels take (``mlp_takes``)."""
    _mlp_lib()
    ptrs, block, units = _mlp_inputs(obs, unit_ids, params)
    _call("mlp_towers", "mlp_forward_f32", mu.device, _ptr_array(ptrs + [mu, v]),
          MLP_INPUTS + 2, n, block, units, *dims)


def launch_mlp_backward(obs, unit_ids, params, g_mu, g_v, partial, n: int, dims) -> None:
    """Launch both towers' backward on the current stream of ``partial``'s device:
    the forward's inputs, the upstream gradients ``g_mu`` [n, 2] and ``g_v`` [n]
    (contiguous), out the blocks' gradients ``partial`` [mlp_partial_rows(n), params]."""
    _mlp_lib()
    ptrs, block, units = _mlp_inputs(obs, unit_ids, params)
    _call("mlp_towers", "mlp_backward_f32", partial.device,
          _ptr_array(ptrs + [g_mu, g_v, partial]), MLP_INPUTS + 3, n, block, units, *dims)


def mlp_grad_norm_blocks(params: int) -> int:
    """The reduce's blocks at ``params`` parameters: the squares the norm sums."""
    return -(-params // MLP_REDUCE_LANES)


# The counters behind the cross-block tickets (the reduce's norm in
# csrc/mlp_towers.cu, the loss head's sums in csrc/ppo_head.cu): one int32 a kernel
# and card, owned by this module, made 0 at its first launch on that card (outside
# any CUDA graph capture, then a synchronize, so that every stream sees the 0) and
# left 0 by every launch, so the captures take its address and replays need no
# memset. No two launches of one kernel on one card overlap on any path: the port
# launches each on its caller's current stream alone, and the minibatch step that
# calls them runs one at a time from one thread, eagerly on the current stream or as
# replays of graphs captured on the card's one capture stream
# (``_graph._capture_stream``), which replay on the current stream in turn; two ranks
# on one card are processes, each with counters of its own.
_tickets: dict[tuple[str, int], torch.Tensor] = {}


def ticket_counter(device: torch.device, kernel: str) -> torch.Tensor:
    """The card's ticket counter (int32 [1]) of ``kernel``, made at its first call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ticket = _tickets.get((kernel, index))
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: its first launch on a card is inside a CUDA graph "
                               f"capture; launch it once eagerly first")
        ticket = torch.zeros((1,), dtype=torch.int32, device=torch.device("cuda", index))
        torch.cuda.synchronize(index)
        ticket = _tickets.setdefault((kernel, index), ticket)
    return ticket


def grad_norm_ticket(device: torch.device) -> torch.Tensor:
    """The card's norm ticket counter (int32 [1]), made at its first call."""
    return ticket_counter(device, "mlp_grad_reduce")


def launch_mlp_grad_reduce(partial, out, norm=None) -> None:
    """Launch the sum of the blocks' gradients ``partial`` [rows, params] into
    ``out`` [params] on the current stream of ``out``'s device; with ``norm`` (0-d
    float32 on that card) in the same launch its global norm, sqrt(sum of out**2),
    into ``norm``."""
    if norm is None:
        _call("mlp_towers", "mlp_grad_reduce_f32", out.device, _ptr(partial), _ptr(out),
              partial.shape[0], partial.shape[1])
    else:
        _launch_reduce_norm(partial, out, norm)


def launch_mlp_grad_norm(flat, norm) -> None:
    """Launch the reduce's norm-only mode on the current stream of ``norm``'s device:
    the global norm of the flat gradient ``flat`` [params] (contiguous float32) into
    ``norm`` (0-d float32), in the fused launch's blocks and order."""
    _launch_reduce_norm(flat.view(1, -1), None, norm)


def _launch_reduce_norm(partial, out, norm) -> None:
    dev = norm.device
    params = partial.shape[1]
    block_sq = torch.empty((mlp_grad_norm_blocks(params),), dtype=torch.float32, device=dev)
    _call("mlp_towers", "mlp_grad_reduce_norm_f32", dev, _ptr(partial), _ptr(out),
          _ptr(norm), _ptr(block_sq), _ptr(grad_norm_ticket(dev)), partial.shape[0], params)


# the rollout step's policy (csrc/policy.cu): policy_act's rows a block (two 16-row
# fragments, each through each tower by a group of POLICY_ACT_SPLIT warps) and
# pool_act's range (a block's rows, of which it takes its member's: POOL_ACT_WARPS
# warps in groups of POOL_ACT_SPLIT a fragment), their pointer counts, and the member
# modes
POLICY_ACT_ROWS = 32
POLICY_ACT_SPLIT = 4
POOL_ACT_RANGE = 128
POOL_ACT_WARPS = 8
POOL_ACT_SPLIT = 2
POLICY_ACT_PTRS = 23
POOL_ACT_PTRS = 16
POOL_SEAT, POOL_PER_ENV, POOL_ONE = 0, 1, 2


def policy_shared_bytes(pool: bool, obs_dim: int, h1: int, h2: int) -> int:
    """The shared bytes a block of ``policy_act_f32`` (``pool`` False: both towers, a
    tile of ``POLICY_ACT_ROWS`` observations, the normaliser's mean and var and four
    groups' activation tiles) or ``pool_act_f32`` (True: one actor tower, a tile of a
    wave's rows, a fragment a group, the normaliser, its groups' activation tiles,
    then its range's packed rows' observation offsets as int64, their offsets and the
    warps' counts as int32) takes at towers obs_dim -> h1 -> h2, as ``csrc/mlp_tower.cuh:Layout`` and
    ``GroupTower`` lay them out (the kernel's own ``policy_shared_bytes``, held equal
    to this in chip_smoke.py phase q); 0 where the kernels do not take them (widths
    not in ``MLP_HIDDEN``, over a block's memory)."""
    if (h1, h2) not in MLP_HIDDEN or obs_dim < 1:
        return 0
    dk, xs = _round_up(obs_dim, 8), _round_up(obs_dim, 16) + 8
    tower = _round_up(dk * h1 + h1 + h1 * h2 + h2 + 2 * h2 + 2, 4)

    def group(split: int) -> int:
        return 0 if split == 1 else 16 * (max(h1, h2) + 8)

    if pool:
        groups = POOL_ACT_WARPS // POOL_ACT_SPLIT
        floats = (tower + 16 * groups * xs + 2 * xs + groups * group(POOL_ACT_SPLIT)
                  + 3 * POOL_ACT_RANGE + POOL_ACT_WARPS)
    else:
        floats = 2 * tower + POLICY_ACT_ROWS * xs + 2 * xs + 4 * group(POLICY_ACT_SPLIT)
    return 4 * floats if 4 * floats <= BLOCK_SMEM_LIMIT else 0


@functools.lru_cache(maxsize=None)
def _policy_lib():
    lib = build()["policy"]
    got = (lib.policy_rows_per_block(0), lib.policy_rows_per_block(1))
    if got != (POLICY_ACT_ROWS, POOL_ACT_RANGE):
        raise RuntimeError(f"csrc/policy.cu takes {got} rows a block; ops/_cuda.py "
                           f"{(POLICY_ACT_ROWS, POOL_ACT_RANGE)}")
    return lib


def launch_policy_act(ptrs, n: int, steps: int, stride: int, dims, consts) -> None:
    """Launch ``policy_act_f32`` on the current stream of the observations' device:
    ``ptrs`` the ``POLICY_ACT_PTRS`` tensors (or None) in the kernel's order (obs, t,
    noise, mean, var, log_std, the 12 tower tensors, action, obs_rows, action_rows,
    logprob_rows, value_rows), ``n`` rows of obs at a row stride of ``stride``
    floats, ``steps`` the buffers' rows, ``dims`` = (D, h1, h2), ``consts`` (eps,
    clip, 0.5 log 2 pi)."""
    _policy_lib()
    _call("policy", "policy_act_f32", ptrs[0].device, _ptr_array(ptrs), POLICY_ACT_PTRS,
          n, steps, stride, *dims, _float_array(consts), len(consts))


def launch_pool_act(ptrs, rows: int, seats: int, cars: int, off: int, env_stride: int,
                    members: int, kind: int, member64: bool, use_per_env: bool, dims,
                    consts) -> None:
    """Launch ``pool_act_f32`` on the current stream of the observations' device:
    ``ptrs`` the ``POOL_ACT_PTRS`` tensors (or None) in the kernel's order (obs, the
    6 stacked actor tensors, log_std, mean, var, member, noise, uniforms, use_policy,
    first, out); ``rows`` env-major, seat r % seats of env r / seats, read at an env
    stride of ``env_stride`` floats and written to car ``off`` + r % seats of out
    [envs, cars, 2]; ``kind`` one of ``POOL_SEAT``, ``POOL_PER_ENV``, ``POOL_ONE``;
    ``dims`` = (D, h1, h2); ``consts`` (eps, clip, low0, low1, high0, high1)."""
    _policy_lib()
    _call("policy", "pool_act_f32", ptrs[0].device, _ptr_array(ptrs), POOL_ACT_PTRS, rows,
          seats, cars, off, env_stride, members, kind, int(member64), int(use_per_env),
          *dims, _float_array(consts), len(consts))


# The general route (csrc/mlp_general.cu's forward and backward, layer-major over the
# card; csrc/policy_general.cu's kernels A and B on csrc/mlp_stream.cuh's per-tile
# forward): towers of any depth and width within these limits. mlp_route says which
# route a tower takes; one route for all four kernels, so that kernel A's and B's mu
# and v are bitwise the minibatch forward's on every tower.
MLP_MAX_HIDDEN_LAYERS = 7   # adam_tail's 32-tensor table holds 4 (L + 1) tensors
MLP_MAX_WIDTH = 1024        # a hidden width or obs_dim
# mlp_stream.cuh's constants (kernels A and B): a block's warps at most (the plans take
# half), the tile rows (from GENERAL_TILE_MAX down to 16), the n-tiles a warp holds in
# a column pass (at most), a staged chunk's weight rows, the chunks' ring, kernel B's
# range
GENERAL_MAX_WARPS = 16
GENERAL_TILE_MAX = 64
GENERAL_MAX_TILES = 8
GENERAL_CHUNK_ROWS = 16
GENERAL_STAGES = 3
GENERAL_POOL_RANGE = 128
GENERAL_KINDS = ("forward", "act", "pool", "backward")
# mlp_general.cu's constants: a layer launch's threads and tile (rows, columns,
# contraction chunk), the rows a partial row sums at least, the partial rows at most,
# the scratch floats a call (about), a layer launch's shared bytes
GENERAL_GEMM_THREADS = 256
GENERAL_GEMM_TILE = (128, 128, 16)
GENERAL_MIN_CHUNK_ROWS = 512
GENERAL_MAX_PARTIAL_ROWS = 128
GENERAL_SCRATCH_BUDGET = 1 << 28
GENERAL_GEMM_SHARED_BYTES = 92_160
# an SM's shared memory and what the runtime keeps a block (mlp_tower.cuh)
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024


@dataclasses.dataclass(frozen=True)
class GeneralPlan:
    """Kernel A's or B's launch plan (``csrc/mlp_stream.cuh:make_plan``): the block's
    warps, the tile's rows, the activation tiles' row stride (floats), the warps on a
    16-row fragment, the n-tiles a warp holds, a column pass's columns, one staged
    chunk's floats and the shared bytes a block."""
    warps: int
    rows: int
    stride: int
    groups: int
    tiles: int
    cols: int
    chunk: int
    shared_bytes: int

    def as_tuple(self) -> tuple:
        return dataclasses.astuple(self)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """The general forward's or backward's geometry at ``n`` rows
    (``csrc/mlp_general.cu:geometry``): a layer launch's threads and tile (rows,
    columns, contraction chunk), the rows a partial row sums, the partial rows, a
    slab's rows, the slabs, the scratch floats and a layer launch's shared bytes."""
    threads: int
    tile_m: int
    tile_n: int
    tile_k: int
    chunk_rows: int
    partial_rows: int
    slab_rows: int
    slabs: int
    scratch_floats: int
    shared_bytes: int

    def as_tuple(self) -> tuple:
        return dataclasses.astuple(self)


def _check_limits(obs_dim: int, hidden) -> None:
    if not 1 <= len(hidden) <= MLP_MAX_HIDDEN_LAYERS or not 1 <= obs_dim <= MLP_MAX_WIDTH \
            or any(not 1 <= h <= MLP_MAX_WIDTH for h in hidden):
        raise ValueError(f"the MLP kernels take towers of 1 to {MLP_MAX_HIDDEN_LAYERS} hidden "
                         f"layers of widths 1 to {MLP_MAX_WIDTH} on obs_dim 1 to "
                         f"{MLP_MAX_WIDTH}; got obs_dim {obs_dim}, hidden {tuple(hidden)}")


def mlp_route(obs_dim: int, hidden) -> str:
    """``"compiled"`` where the compiled kernels (``mlp_towers.cu``'s and ``policy.cu``'s,
    three layers at ``MLP_HIDDEN``) all take towers obs_dim -> hidden, else
    ``"general"``; past the general route's limits (``MLP_MAX_HIDDEN_LAYERS`` hidden
    layers, widths and obs_dim to ``MLP_MAX_WIDTH``) a ``ValueError`` that names them."""
    hidden = tuple(int(h) for h in hidden)
    _check_limits(int(obs_dim), hidden)
    if len(hidden) == 2 and mlp_takes(obs_dim, *hidden) \
            and policy_shared_bytes(False, obs_dim, *hidden) \
            and policy_shared_bytes(True, obs_dim, *hidden):
        return "compiled"
    return "general"


def _general_plan_at(kind: str, dims, rows: int, max_tiles: int) -> GeneralPlan:
    widest = max(dims)
    stride = _round_up(widest, 32) + 4
    warps = GENERAL_MAX_WARPS // 2
    groups = warps // (rows // 16)
    per = -(-(-(-widest // 8)) // groups)
    tiles = min(per, max_tiles)
    cols = 8 * groups * tiles
    chunk = GENERAL_CHUNK_ROWS * (_round_up(cols, 32) + 8)
    extra = _round_up(3 * rows, 4) + 2 * stride
    if kind == "pool":
        extra += _round_up(3 * GENERAL_POOL_RANGE + GENERAL_MAX_WARPS, 4)
    floats = GENERAL_STAGES * chunk + extra + 2 * rows * stride
    return GeneralPlan(warps, rows, stride, groups, tiles, cols, chunk, 4 * floats)


def _dims(dims) -> tuple:
    dims = tuple(int(x) for x in dims)
    _check_limits(dims[0], dims[1:])
    return dims


@functools.lru_cache(maxsize=None)
def general_plan(kind: str, dims) -> GeneralPlan:
    """The plan of kernel A (``kind`` ``"act"``) or B (``"pool"``) at towers ``dims`` =
    (obs_dim, *hidden), the first that fits by the most n-tiles a warp (8, 4, 2, 1),
    then the most tile rows (64, 32, 16): first within half an SM's memory, then within
    a block's (the kernels' own ``make_plan``, held equal to this in chip_smoke.py
    phase s)."""
    dims = _dims(dims)
    if kind not in ("act", "pool"):
        raise ValueError(f"general_plan: kind {kind!r}, expected 'act' or 'pool'")
    tile_counts = [GENERAL_MAX_TILES >> i for i in range(GENERAL_MAX_TILES.bit_length())]
    for limit in (SM_SMEM_BYTES // 2 - BLOCK_RESERVED_BYTES, BLOCK_SMEM_LIMIT):
        for tiles in tile_counts:
            for rows in (GENERAL_TILE_MAX, GENERAL_TILE_MAX // 2, GENERAL_TILE_MAX // 4):
                plan = _general_plan_at(kind, dims, rows, tiles)
                if plan.shared_bytes <= limit:
                    return plan
    raise ValueError(f"general_plan: no {kind} plan at towers {dims}")


@functools.lru_cache(maxsize=None)
def general_gemm_plan(kind: str, dims, n: int) -> GemmPlan:
    """The general forward's (``kind`` ``"forward"``) or backward's (``"backward"``)
    geometry at ``n`` rows of towers ``dims`` (the kernels' own ``geometry``, held
    equal to this in chip_smoke.py phase s): a partial row sums chunk_rows =
    max(GENERAL_MIN_CHUNK_ROWS, n / GENERAL_MAX_PARTIAL_ROWS rounded up to the tile's
    contraction chunk) rows; the rows go in slabs, the most whole units (the backward's
    chunks, the forward's 128-row tiles) whose scratch fits GENERAL_SCRATCH_BUDGET
    beside the split weights, at least one; the scratch holds each tower's hidden
    weights as (hi, lo) pairs and a slab's activations (the forward two buffers a
    tower, the backward every hidden layer's, two gradient buffers and g3)."""
    dims = _dims(dims)
    if kind not in ("forward", "backward") or n < 0:
        raise ValueError(f"general_gemm_plan: kind {kind!r} at {n} rows")
    threads, (tm, tn, tk) = GENERAL_GEMM_THREADS, GENERAL_GEMM_TILE
    chunk_rows = max(GENERAL_MIN_CHUNK_ROWS,
                     _round_up(-(-n // GENERAL_MAX_PARTIAL_ROWS), tk) if n else 0)
    partial_rows = -(-n // chunk_rows)
    lds = [_round_up(d, 4) for d in dims[1:]]
    widest = max(lds)
    split = 2 * sum(k * 2 * _round_up(m, 2) for k, m in zip(dims, dims[1:]))
    backward = kind == "backward"
    per_row = 2 * (sum(lds) + 2 * widest + 4) if backward else 4 * widest
    unit = chunk_rows if backward else tm
    slab = max(unit, (GENERAL_SCRATCH_BUDGET - split) // per_row // unit * unit)
    slab_rows = min(slab, _round_up(n, unit)) if n else 0
    slabs = -(-n // slab_rows) if slab_rows else 0
    return GemmPlan(threads, tm, tn, tk, chunk_rows, partial_rows, slab_rows, slabs,
                    split + slab_rows * per_row, GENERAL_GEMM_SHARED_BYTES)


def general_partial_rows(n: int, dims) -> int:
    """The general backward's partial rows at ``n`` rows: a row a chunk of
    ``general_gemm_plan(...).chunk_rows`` rows, at most ``GENERAL_MAX_PARTIAL_ROWS``."""
    return general_gemm_plan("backward", tuple(dims), n).partial_rows


def general_scratch(n: int, dims, device, kind: str = "backward") -> torch.Tensor:
    """The general forward's or backward's device scratch at ``n`` rows (the split
    weights and a slab's activations)."""
    plan = general_gemm_plan(kind, tuple(dims), n)
    return torch.empty((plan.scratch_floats,), dtype=torch.float32, device=device)


def general_keeps(n: int, dims) -> bool:
    """Whether the general forward can keep every hidden layer's activations at ``n``
    rows for the backward (its plan one slab): then a forward with ``keep`` into the
    backward's scratch lets the backward skip computing them again."""
    return general_gemm_plan("backward", tuple(dims), n).slabs == 1


def _int_array(values):
    return (ctypes.c_int * len(values))(*map(int, values))


def kernel_plan(kind: str, dims) -> tuple:
    """Kernel A's or B's plan as the library gives it (``policy_general_plan``), to
    hold against ``general_plan``."""
    out = (ctypes.c_longlong * 8)()
    err = build()["policy_general"].policy_general_plan(GENERAL_KINDS.index(kind),
                                                        _int_array(dims), len(dims), out)
    if err:
        raise RuntimeError(f"policy_general_plan({kind}, {tuple(dims)}): cudaError {err}")
    return tuple(out)


def kernel_gemm_plan(kind: str, dims, n: int) -> tuple:
    """The general forward's or backward's geometry at ``n`` rows as the library gives
    it (``mlp_general_gemm_plan``), to hold against ``general_gemm_plan``."""
    out = (ctypes.c_longlong * 10)()
    err = build()["mlp_general"].mlp_general_gemm_plan(GENERAL_KINDS.index(kind), n,
                                                       _int_array(dims), len(dims), out)
    if err:
        raise RuntimeError(f"mlp_general_gemm_plan({kind}, {n}, {tuple(dims)}): cudaError {err}")
    return tuple(out)


def kernel_partial_rows(n: int, dims) -> int:
    """The general backward's partial rows at ``n`` rows as the library gives them
    (``mlp_general_partial_rows``), to hold against ``general_partial_rows``."""
    rows = build()["mlp_general"].mlp_general_partial_rows(n, _int_array(dims), len(dims))
    if rows < 0:
        raise RuntimeError(f"mlp_general_partial_rows({n}, {tuple(dims)}): not taken")
    return rows


def general_params(dims, towers: int = 2) -> int:
    """The towers' tensors on the general route: 2 (L + 1) a tower."""
    return towers * 2 * len(dims)


def launch_mlp_general_forward(obs, unit_ids, params, mu, v, n: int, dims, scratch=None,
                               keep: bool = False) -> None:
    """Launch both towers' general forward on the current stream of ``mu``'s device:
    ``obs`` [n, D] (or [units, block, D] read through ``unit_ids``), ``params`` the 4
    (L + 1) tensors in ``model.parameters()`` order, out ``mu`` [n, 2] and ``v`` [n];
    ``dims`` = (D, *hidden); its ``scratch`` where given, else ``general_scratch``
    from the caller's allocator (the entry refuses one under its plan's). ``keep``
    (where ``general_keeps``): the scratch is the backward's and keeps every hidden
    layer's activations for ``launch_mlp_general_backward(..., saved=True)``."""
    if len(params) != general_params(dims):
        raise ValueError(f"mlp: {len(params)} parameter tensors, expected "
                         f"{general_params(dims)}")
    block, units = (0, 0) if unit_ids is None else (obs.shape[1], obs.shape[0])
    if scratch is None:
        scratch = general_scratch(n, dims, mu.device, "backward" if keep else "forward")
    ptrs = [obs, unit_ids, *params, mu, v, scratch]
    _call("mlp_general", "mlp_general_forward_f32", mu.device, _ptr_array(ptrs), len(ptrs), n,
          block, units, _int_array(dims), len(dims), scratch.numel(), int(keep))


def launch_mlp_general_backward(obs, unit_ids, params, g_mu, g_v, partial, n: int,
                                dims, scratch=None, saved: bool = False) -> None:
    """Launch both towers' general backward on the current stream of ``partial``'s
    device: the forward's inputs, the upstream gradients ``g_mu`` [n, 2] and ``g_v``
    [n] (contiguous), out the chunks' gradients ``partial`` [general_partial_rows(n),
    params]; its ``scratch`` where given, else ``general_scratch`` from the caller's
    allocator; ``saved``: the scratch holds what a forward with ``keep`` left of these
    inputs. The entry is told both buffers' sizes and refuses any other than its own
    plan's."""
    if len(params) != general_params(dims):
        raise ValueError(f"mlp: {len(params)} parameter tensors, expected "
                         f"{general_params(dims)}")
    block, units = (0, 0) if unit_ids is None else (obs.shape[1], obs.shape[0])
    if scratch is None:
        scratch = general_scratch(n, dims, partial.device)
    ptrs = [obs, unit_ids, *params, g_mu, g_v, partial, scratch]
    _call("mlp_general", "mlp_general_backward_f32", partial.device, _ptr_array(ptrs), len(ptrs),
          n, block, units, _int_array(dims), len(dims), partial.shape[0], partial.shape[1],
          scratch.numel(), int(saved))


def launch_policy_general_act(ptrs, n: int, steps: int, stride: int, dims, consts) -> None:
    """Launch the general kernel A on the current stream of the observations' device:
    ``ptrs`` as ``launch_policy_act``'s with each tower's 2 (L + 1) tensors (the
    critic's all None where absent), ``dims`` = (D, *hidden)."""
    if len(ptrs) != 6 + general_params(dims) + 5:
        raise ValueError(f"policy_act: {len(ptrs)} pointers at towers {tuple(dims)}")
    _call("policy_general", "policy_general_act_f32", ptrs[0].device, _ptr_array(ptrs),
          len(ptrs), n, steps, stride, _int_array(dims), len(dims), _float_array(consts),
          len(consts))


def launch_policy_general_pool(ptrs, rows: int, seats: int, cars: int, off: int,
                               env_stride: int, members: int, kind: int, member64: bool,
                               use_per_env: bool, dims, consts) -> None:
    """Launch the general kernel B on the current stream of the observations' device:
    ``ptrs`` as ``launch_pool_act``'s with the actor's 2 (L + 1) stacked tensors,
    ``dims`` = (D, *hidden)."""
    if len(ptrs) != 1 + general_params(dims, 1) + 9:
        raise ValueError(f"pool_act: {len(ptrs)} pointers at towers {tuple(dims)}")
    _call("policy_general", "policy_general_pool_f32", ptrs[0].device, _ptr_array(ptrs),
          len(ptrs), rows, seats, cars, off, env_stride, members, kind, int(member64),
          int(use_per_env), _int_array(dims), len(dims), _float_array(consts), len(consts))


def launch_general_grad_reduce(partial, out, norm=None) -> None:
    """The general route's reduce (``csrc/mlp_general.cu:general_grad_reduce_f32``) on
    the current stream of ``partial``'s device: ``out`` [params] the sum of the
    blocks' gradients ``partial`` [rows, params] (None: not written, the norm-only mode
    of one row) and, with ``norm`` (0-d float32), their global norm; its ticket is the
    card's (``ticket_counter``)."""
    dev = partial.device
    params = partial.shape[1]
    block_sq = (None if norm is None else
                torch.empty((mlp_grad_norm_blocks(params),), dtype=torch.float32, device=dev))
    ticket = None if norm is None else ticket_counter(dev, "general_grad_reduce")
    _call("mlp_general", "general_grad_reduce_f32", dev, _ptr(partial), _ptr(out), _ptr(norm),
          _ptr(block_sq), _ptr(ticket), partial.shape[0], params)
