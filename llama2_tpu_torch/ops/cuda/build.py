"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc -shared`` call into a
shared library with a plain ``extern "C"`` interface, loaded with ``ctypes``.
Nothing is compiled at import time: a kernel's library is built the first
time its wrapper launches on a CUDA tensor, or by :func:`build_all` up
front, which starts one ``nvcc`` per source at once (:func:`start_builds`
starts them without waiting; whoever needs a library first waits for its
build). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the sources and
flags, so a changed source is rebuilt and an unchanged one is reused. A build
failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

MAX_TICKETS = 8192  # the tickets of one launch's fixed-order reductions

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_pending: dict[str, tuple] = {}  # name: (library path, nvcc process, temp path) of a build in flight
_workspaces: dict = {}


def workspace(device: torch.device, n_floats: int):
    """The per-device float32 workspace of the kernels' split reductions
    (grown on demand) and the zeroed int32 tickets every kernel leaves
    zeroed: ``(ws, tickets)``. One launch at a time uses them: launches on
    one stream are ordered."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ws, tickets = _workspaces.get(index, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1 << 20), dtype=torch.float32, device=device)
        if tickets is None:
            tickets = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
        _workspaces[index] = (ws, tickets)
    return ws, tickets


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise KernelBuildError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str, so: str) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-pid temp name + rename: another process may build the same library
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp


def _finish_build(name: str, so: str, proc: subprocess.Popen, tmp: str) -> str:
    out, _ = proc.communicate()
    log = out.decode(errors="replace")
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, so)
    return log


def start_builds(names: list[str]) -> None:
    """Start, without waiting, one ``nvcc`` for each named kernel library
    that is not loaded, not built and not being built."""
    with _lock:
        for name in names:
            so = _lib_path(name)
            if name not in _libs and name not in _pending and not os.path.exists(so):
                _pending[name] = (so, *_start_build(name, so))


def build_all(names: list[str]) -> dict[str, str]:
    """Build every named kernel library that is missing, one ``nvcc`` each,
    all started together (or waited for, where :func:`start_builds` started
    them), then load them. Returns each build's compiler output (registers,
    shared memory and spills per kernel, from ptxas)."""
    start_builds(names)
    logs = {}
    with _lock:
        for name in names:
            if name in _pending:
                logs[name] = _finish_build(name, *_pending.pop(name))
    for name in names:
        load_library(name)
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in _pending:
                _finish_build(name, *_pending.pop(name))
            so = _lib_path(name)
            if not os.path.exists(so):
                _finish_build(name, so, *_start_build(name, so))
            lib = ctypes.CDLL(so)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
