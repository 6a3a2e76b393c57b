"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` on its own into a shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as built.  The build
directory ``kernels/_build/`` is not committed.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc`` or a card.  Also here: the binding every wrapper launches
through (:func:`launch`, :func:`suffix`, :func:`route`, :func:`ptr`,
:func:`check_launch`) and the lane grouping of the plain versions
(:func:`lane_groups`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "LANES", "build_all", "library",
           "nvcc_path", "launch", "suffix", "check_launch", "route", "ptr",
           "lane_groups"]

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
# one library per csrc/<name>.cu
SOURCES = ("dwt_fused", "streaming", "dwt_dense", "folded_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set $CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, verbose: bool = False):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (target, process or None).  ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills of each kernel; same binary)."""
    target = _target(name)
    if target.is_file():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: pathlib.Path, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    tmp.replace(target)            # atomic: readers never see a half file
    return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every source that is not built yet, all nvcc processes at
    once; returns {name: compiler output} (empty for cached libraries)."""
    with _LOCK:
        started = {n: _start(n, verbose) for n in SOURCES}
        return {n: _finish(n, *started[n]) for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            target, proc = _start(name)
            _finish(name, target, proc)
            _LIBS[name] = ctypes.CDLL(str(target))
        return _LIBS[name]


def launch(source: str, symbol: str, what: str, device, tensors, ints,
           floats=()):
    """Call the C launch function ``symbol`` of csrc/<source>.cu on the
    current stream of ``device``.  Its arguments are the tensors' device
    pointers (None: a null pointer), then the ints, then the floats, then
    the stream; it returns a cudaError_t, and a non-zero one raises."""
    fn = getattr(library(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) \
        + [ctypes.c_int] * len(ints) + [ctypes.c_float] * len(floats) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*(ptr(t) for t in tensors), *ints, *floats,
                 torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, what)


def suffix(dtype) -> str:
    """The dtype part of a typed C entry point: f32 or f64."""
    return "f32" if dtype == torch.float32 else "f64"


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def route(name, x):
    """"plain" for a CPU tensor, "kernel" for a CUDA one; raise for any
    other device."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"{name}: no kernel for device {x.device}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


# Lanes of one transform (C = 8 member slots x real/imag).  The plain
# versions contract each 16-lane group on its own: a BLAS product orders
# its sums by the operand shape, and a lane's result must not depend on
# how many transforms share the launch.
LANES = 16


def lane_groups(x):
    """The contiguous 16-lane groups of x's last axis."""
    return [x[..., c:c + LANES].contiguous()
            for c in range(0, x.shape[-1], LANES)]
