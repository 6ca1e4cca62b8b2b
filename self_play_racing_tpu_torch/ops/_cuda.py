"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), all sources at
once in parallel, at the first launch in a process. Libraries are cached in
``_build/`` under a name that hashes the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as is. Pointers and the stream go to the
C entry points through ``ctypes``; each entry returns ``cudaGetLastError()`` and the
caller raises on anything but 0. Nothing here is imported or built until a CUDA
tensor reaches a kernel.
"""
from __future__ import annotations

import ctypes
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
SOURCES = ("raycast_walls.cu", "progress_collision.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # PyTorch's eager ops never contract a*b+c into an FMA; neither may the kernels
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "raycast_walls_f32": [_P] * 10 + [_I, _I, _I, ctypes.c_float, _I, _P],
    "progress_and_collision_f32": [_P] * 12 + [_I, _I, _I, _I, _P],
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
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
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


def launch_raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, c, out,
                         rows: int, rays_per_row: int, num_segments: int,
                         max_dist: float) -> None:
    """Launch K1 on ``out.device``'s current stream. Tensors are contiguous f32."""
    _call("raycast_walls", "raycast_walls_f32", out.device,
          *map(_ptr, (ox, oy, dx, dy, sx, sy, vx, vy, c, out)),
          rows, rays_per_row, num_segments, float(max_dist))


def launch_progress_and_collision(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp,
                                  track_width, progress, crashed, rows: int,
                                  num_corners: int, num_waypoints: int) -> None:
    """Launch K2 on ``progress.device``'s current stream. Tensors are contiguous
    (f32, ``n_wp`` int32, ``crashed`` bool)."""
    _call("progress_collision", "progress_and_collision_f32", progress.device,
          *map(_ptr, (x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width,
                      progress, crashed)),
          rows, num_corners, num_waypoints)
