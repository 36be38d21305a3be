"""Build and load the port's CUDA kernels at first use.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with
``ctypes``. Nothing is built when the package is imported, so the package
imports on machines without CUDA. A failed build raises: a CUDA tensor
never falls back to the plain PyTorch versions.

Libraries go to ``build/drtk_tpu_torch/`` beside the package (git-ignored),
named by a hash of the source and flags, so an edited source is rebuilt
and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "check", "entry", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "drtk_tpu_torch"
SOURCES = ("edge_grad", "gather_rows", "rasterize", "rasterize_lines", "scatter_rows", "window_accum")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}
# ptxas' report (registers, shared memory, spills) of each build, by source.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of drtk_tpu_torch are compiled at "
        "first use and need the CUDA toolkit"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc process writing to a private temporary file; returns
    (process, temporary path, final path)."""
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file


def build_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel (one nvcc per source, all
    started together), then load them all."""
    with _lock:
        nvcc = None
        pending = {}
        for name in names:
            if name in _libs or _target(name).exists():
                continue
            nvcc = nvcc or _nvcc()
            pending[name] = _start(name, nvcc)
        errors = []
        for name, started in pending.items():
            try:
                _finish(name, started)
            except RuntimeError as err:  # reap every process before raising
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)))
        return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu``, which returns a CUDA
    error code; its argument types are set once, at its first lookup."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` returned a CUDA error code
    (its ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        lib = load(name)
        lib.drtk_cuda_error_string.restype = ctypes.c_char_p
        lib.drtk_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.drtk_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
