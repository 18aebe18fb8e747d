"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC csrc/<name>.cu -o build/<name>-<digest>.so

and loaded with ``ctypes``. No PyTorch header is compiled, which keeps the
build to seconds. The build runs at first use, from the sources in the
checkout only, into ``tpucap_torch/build/`` (git-ignored); the file name
carries a digest of the sources and flags, so an edited kernel is rebuilt.
If ``nvcc`` is missing or a compile fails, the error carries the
compiler's output.

Host code (``csrc/*.cpp``: the JPEG decoder) is built apart from the
kernels, by ``build_host(name)`` with ``g++`` (no ``nvcc``, no card), into
the same directory under the same digest naming:

    g++ -O3 -std=c++17 -shared -fPIC -pthread csrc/<name>.cpp \\
        -o build/<name>-<digest>.so
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: Must match csrc/common.cuh:DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_host_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA toolkit is needed to build tpucap_torch's kernels"
        )
    return path


def _digest(src: Path, headers: list[Path], flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in [src, *headers]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(jobs: list[tuple[list[str], Path]], what: str) -> None:
    """Run every (command, output) compile at once, each into a temporary
    file that replaces ``output`` once it succeeds. Raises with each failed
    command and its output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for cmd, out in jobs:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [*cmd, "-o", str(tmp)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((proc, cmd, tmp, out))
    failures = []
    for proc, cmd, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError(f"building {what} failed:\n" + "\n".join(failures))


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Thread-safe; the work is done once per process."""
    with _lock:
        if _libs:
            return _libs
        headers = sorted(CSRC.glob("*.cuh"))
        targets = {
            src.stem: (src, BUILD / f"{src.stem}-{_digest(src, headers)}.so")
            for src in sorted(CSRC.glob("*.cu"))
        }
        jobs = [
            ([_nvcc(), *NVCC_FLAGS, str(src)], out)
            for src, out in targets.values()
            if not out.exists()
        ]
        if jobs:
            _compile(jobs, "tpucap_torch kernels")
        for name, (_, out) in targets.items():
            lib = ctypes.CDLL(str(out))
            lib.tpucap_error_string.argtypes = [ctypes.c_int]
            lib.tpucap_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


def build_host(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load the host library ``csrc/<name>.cpp``
    with ``g++``; thread-safe, done once per process. Raises with the
    compiler's output if the build fails."""
    with _lock:
        lib = _host_libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        out = BUILD / f"{name}-{_digest(src, [], HOST_FLAGS)}.so"
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found on PATH: it builds {src.name}")
            _compile([([gxx, *HOST_FLAGS, str(src)], out)], src.name)
        lib = ctypes.CDLL(str(out))
        _host_libs[name] = lib
        return lib


@functools.cache
def kernel(lib_name: str, fn_name: str, argtypes: tuple):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with its argument
    types declared; it returns a cudaError_t as int."""
    lib = build_all()[lib_name]
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, fn_name: str, err: int) -> None:
    if err != 0:
        msg = build_all()[lib_name].tpucap_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}: {msg}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype=None, shape=None) -> None:
    """Wrapper-side checks before a pointer reaches a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
