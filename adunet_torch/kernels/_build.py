"""Build and load the port's CUDA kernels (one shared library, plain C ABI).

The sources in ``adunet_torch/csrc/*.cu`` are compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) by ``nvcc``, one process per
source started together, and linked into ONE shared library under
``build/adunet_torch_kernels/`` at the checkout's root (``build/`` is
git-ignored). The library's file name carries a hash of the sources and
flags, so an edited source is never served by a stale build. It is built at
first use (``library()``), never at import: importing this module needs no
``nvcc`` and no GPU.

The C entry points take raw device pointers, the tensors' device index (the
call makes that device current only where it is not) and the caller's CUDA
stream (``current_stream``), and return ``cudaGetLastError()`` after the
launch; the Python wrappers raise on a non-zero code (``check``). One launch
is one C call: everything else a launch needs on the host (the SM count,
kernel attributes) is asked of the runtime once per device, in C. The library links against the CUDA runtime
only: K2's bf16 kernel gets ``cuTensorMapEncodeTiled`` from libcuda (for its
TMA descriptor) at run time through ``cudaGetDriverEntryPoint``, so no
``-lcuda`` is needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["library", "check", "build_dir", "last_build", "current_stream"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("fused_norm.cu", "conv64.cu", "resize_band.cu", "conv3x3_f32.cu")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed and how long it took (read by chip_smoke.py)
last_build: dict = {}

_P = ctypes.c_void_p


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "adunet_torch_kernels"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")


def _build(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _SOURCES:
        obj = out.parent / f"{out.stem}_{Path(src).stem}.o"
        cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"--- {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *_ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    last_build.update(seconds=time.perf_counter() - t0, log="\n".join(logs), path=str(out))


def _declare(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    lib.adunet_layer_norm_relu.argtypes = [_P, _P, _P, _P, _P, ctypes.c_longlong, i,
                                           ctypes.c_float, i, i, _P]
    lib.adunet_layer_norm_relu.restype = i
    lib.adunet_layer_norm_relu_backward.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                                    ctypes.c_longlong, i, ctypes.c_float, i, i, _P]
    lib.adunet_layer_norm_relu_backward.restype = i
    lib.adunet_layer_norm_relu_backward_partials.argtypes = [_P]
    lib.adunet_layer_norm_relu_backward_partials.restype = i
    lib.adunet_conv3x3_c64.argtypes = [_P, _P, i, _P, i, _P, _P, i, i, i, i, i, i, _P]
    lib.adunet_conv3x3_c64.restype = i
    lib.adunet_conv3x3_c64_backward.argtypes = [_P, _P, i, _P, i, i, i, _P, _P, _P, _P, i, i, i,
                                                i, i, i, i, _P]
    lib.adunet_conv3x3_c64_backward.restype = i
    lib.adunet_conv3x3_c64_backward_partials.argtypes = [_P, i]
    lib.adunet_conv3x3_c64_backward_partials.restype = i
    lib.adunet_conv3x3_f32.argtypes = [_P, _P, _P, _P, _P, i, i, i, i, i, i, _P]
    lib.adunet_conv3x3_f32.restype = i
    lib.adunet_resize_band.argtypes = [_P, _P, _P, _P, _P, _P, _P, i, _P]
    lib.adunet_resize_band.restype = i
    lib.adunet_error_string.argtypes = [ctypes.c_int]
    lib.adunet_error_string.restype = ctypes.c_char_p


def library(rebuild: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call. ``rebuild`` compiles
    the sources again even where a library of the same sources exists, so
    that ``last_build`` holds the compiler's report (the library already
    loaded, built from the same sources, stays loaded)."""
    global _lib
    if _lib is not None and not rebuild:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None or rebuild:
            digest = hashlib.sha256()
            for src in sorted(_CSRC.glob("*.cu*")):
                digest.update(src.read_bytes())
            digest.update(" ".join(_ARCH + _FLAGS).encode())
            out = build_dir() / f"libadunet_kernels_{digest.hexdigest()[:16]}.so"
            if rebuild or not out.exists():
                _build(out)
            else:
                last_build.update(seconds=0.0, log="(cached)", path=str(out))
            if _lib is None:
                lib = ctypes.CDLL(str(out))
                _declare(lib)
                _lib = lib
        return _lib


def current_stream(index: int) -> int:
    """The raw handle of torch's current CUDA stream on device ``index``
    (what ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    making a Stream object each launch)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().adunet_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
