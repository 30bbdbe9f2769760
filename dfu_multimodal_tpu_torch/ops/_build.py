"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/dfu_multimodal_tpu_torch/<hash>/`` at the root of the checkout.
The hash covers the sources, the shared headers and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  No PyTorch header is
compiled (a build takes seconds, not minutes).

Every pointer and the stream cross as ``c_void_p``, every int as
``c_int``; each C entry point returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on anything but 0.  Without ``nvcc`` the
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "dfu_multimodal_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (set CUDA_HOME or put nvcc on "
            "PATH)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for the library's kernels
    (registers, shared memory, spills).  Builds it if needed."""
    build(name)
    return library_path(name).with_suffix(".log").read_text()


def build(name: str) -> Path:
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)              # atomic: concurrent builds agree
    return so


def build_host(source: Path, name: str, flags: Sequence[str]) -> Path:
    """Build host C++ ``source`` with g++ into ``lib{name}.so`` under
    BUILD_ROOT, keyed like :func:`build` by the source, the headers
    beside it and ``flags`` (macros, include dirs, libraries).  Raises
    with g++'s message on failure."""
    source = Path(source)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-I", str(source.parent), *flags]
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in [source, *sorted(source.parent.glob("*.h"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    # libraries come after the source for the linker
    libs = [f for f in flags if f.startswith(("-l", "-L", "-Wl"))]
    other = [f for f in cmd if f not in libs]
    try:
        proc = subprocess.run([*other, str(source), "-o", str(tmp), *libs],
                              capture_output=True, text=True)
    except OSError as e:               # no g++ at all
        raise RuntimeError(f"g++ unavailable for {source.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source.name} "
                           f"({' '.join(flags)}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare ``argtypes``
    for each entry point in ``signatures`` (all return a CUDA error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.dfu_error_string.argtypes = [ctypes.c_int]
            lib.dfu_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.dfu_error_string(err).decode()})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, x: torch.Tensor,
                        compute: Dict[str, torch.Tensor],
                        fp32: Dict[str, torch.Tensor],
                        int8: Optional[Dict[str, torch.Tensor]] = None
                        ) -> None:
    """Raise unless ``x`` lies on a CUDA device in fp32 or bf16 and every
    operand lies contiguous on that device: ``compute`` operands in x's
    dtype, ``fp32`` operands (LayerNorm params, biases, scales) in fp32,
    ``int8`` operands (quantised weights) in int8."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: compute dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    for want, group in ((x.dtype, compute), (torch.float32, fp32),
                        (torch.int8, int8 or {})):
        for arg, t in group.items():
            if t.device != x.device:
                raise ValueError(
                    f"{name}: {arg} is on {t.device}, x on {x.device}")
            if t.dtype != want:
                raise TypeError(
                    f"{name}: {arg} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")


I, P, F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
