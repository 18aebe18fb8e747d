"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<digest>.so csrc/<name>.cu

and loaded with ``ctypes``. No PyTorch header is compiled, which keeps the
build to seconds. The build runs at first use, from the sources in the
checkout only, into ``tpucap_torch/build/`` (git-ignored); the file name
carries a digest of the sources and flags, so an edited kernel is rebuilt.
If ``nvcc`` is missing or a compile fails, the error carries the
compiler's output.
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
#: Must match csrc/common.cuh:DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA toolkit is needed to build tpucap_torch's kernels"
        )
    return path


def _digest(src: Path, headers: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *headers]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


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
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (src, out) in targets.items():
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (
                subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
                out,
                cmd,
            )
        failures = []
        for name, (proc, tmp, out, cmd) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError(
                "building tpucap_torch kernels failed:\n" + "\n".join(failures)
            )
        for name, (_, out) in targets.items():
            lib = ctypes.CDLL(str(out))
            lib.tpucap_error_string.argtypes = [ctypes.c_int]
            lib.tpucap_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


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
