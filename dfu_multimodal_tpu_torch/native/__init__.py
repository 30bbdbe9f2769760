"""ctypes bindings for the port's native decoder (``native/decode.cpp``).

The library is built with g++ at first use into the checkout's
``build/`` tree (``ops/_build.py::build_host``).  The JPEG route is chosen
at build time from what the host has, and :func:`route` names it:

- ``libjpeg``: ``jpeglib.h`` is on g++'s include path.  Decode is
  bit-equal to PIL's (and to the JAX package's native decoder); the
  encoder is PIL's ``save(quality=q)``.
- ``nvjpeg``: no libjpeg, but the CUDA toolkit's ``nvjpeg.h``.  JPEGs
  decode and encode on the GPU through nvJPEG, whose IDCT and chroma
  upsampling differ from libjpeg's, so pixels are near PIL's, not equal;
  the resize stays the host's PIL-exact one.
- ``none``: neither; PNGs still decode (the resize builds without a JPEG
  library), and any JPEG raises.

A build that fails raises; nothing switches routes at run time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from dfu_multimodal_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "decode.cpp"
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_probe: Optional[Dict[str, object]] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _gxx_has_header(header: str) -> bool:
    """Whether g++ finds ``header`` on its default include path."""
    try:
        proc = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"],
            input=f"#include <cstdio>\n#include <{header}>\n",
            capture_output=True, text=True)
    except OSError:
        return False
    return proc.returncode == 0


def probe() -> Dict[str, object]:
    """What the host offers the decoder, and the route it selects:
    ``{"route", "jpeglib_h", "nvjpeg_h"}`` (cached)."""
    global _probe
    if _probe is None:
        jpeglib = _gxx_has_header("jpeglib.h")
        nvjpeg = CUDA_HOME / "include" / "nvjpeg.h"
        nvjpeg = str(nvjpeg) if nvjpeg.exists() else None
        _probe = {"route": ("libjpeg" if jpeglib else
                            "nvjpeg" if nvjpeg else "none"),
                  "jpeglib_h": jpeglib, "nvjpeg_h": nvjpeg}
    return _probe


def route() -> str:
    """``"libjpeg"``, ``"nvjpeg"`` or ``"none"`` (see the module doc)."""
    return str(probe()["route"])


def describe() -> str:
    """One line naming the decode route and what selected it."""
    p = probe()
    return (f"JPEG decode route: {p['route']} (g++ finds jpeglib.h: "
            f"{p['jpeglib_h']}; nvjpeg.h: {p['nvjpeg_h'] or 'absent'})")


def _flags(name: str) -> Tuple[str, ...]:
    if name == "libjpeg":
        return ("-DDFU_JPEG_LIBJPEG", "-ljpeg")
    if name == "nvjpeg":
        lib = CUDA_HOME / "lib64"
        return ("-DDFU_JPEG_NVJPEG", "-I", str(CUDA_HOME / "include"),
                f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart")
    return ()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        name = route()
        lib = ctypes.CDLL(str(_build.build_host(
            SOURCE, f"dfu_decode_{name}", _flags(name))))
        lib.resize_rgb.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                                   ctypes.c_int, ctypes.c_int]
        lib.resize_rgb.restype = None
        if name != "none":
            lib.decode_jpegs_resized.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _U8P, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
            lib.decode_jpegs_resized.restype = None
            lib.encode_jpeg.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_char_p]
            lib.encode_jpeg.restype = ctypes.c_int
        _lib = lib
        return lib


def _need_jpeg(what: str) -> ctypes.CDLL:
    lib = _load()
    if route() == "none":
        raise RuntimeError(
            f"{what}: no JPEG library on this host ({describe()}); the "
            "port decodes and writes JPEGs with libjpeg or nvJPEG only")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


Size = Union[int, Tuple[int, int]]


def target_size(size: Size) -> Tuple[int, int]:
    """An ``int`` S (a square S x S) or PIL's ``(width, height)`` ->
    ``(width, height)``, each positive."""
    w, h = (size, size) if isinstance(size, (int, np.integer)) else size
    if w <= 0 or h <= 0:
        raise ValueError(f"target size must be positive, got {size}")
    return int(w), int(h)


def decode_jpegs_resized(paths: Sequence[str], size: Size,
                         threads: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode + PIL-BILINEAR-exact resize to ``(N, H, W, 3)``
    uint8, ``size`` an int S (S x S) or ``(W, H)``.  Returns ``(images,
    status)``: ``status[i]`` is 0 on success, 1 if the file cannot be
    opened, 2 if it is not a JPEG or is corrupt, 3 for a CMYK / YCCK JPEG,
    4 if the GPU decoder failed."""
    w, h = target_size(size)
    n = len(paths)
    out = np.zeros((n, h, w, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    if n == 0:
        return out, status
    lib = _need_jpeg(f"decoding {paths[0]}")
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.decode_jpegs_resized(
        arr, n, h, w, _u8(out),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    return out, status


def resize_rgb(img: np.ndarray, size: Size) -> np.ndarray:
    """PIL's ``Image.resize(size, BILINEAR)`` of one (H, W, 3) uint8
    image, bit for bit; ``size`` an int S (S x S) or ``(W, H)``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"resize_rgb takes a non-empty (H, W, 3) uint8 "
                         f"image, got {img.shape}")
    w, h = target_size(size)
    out = np.empty((h, w, 3), np.uint8)
    _load().resize_rgb(_u8(img), img.shape[0], img.shape[1], _u8(out), h, w)
    return out


def encode_jpeg(img: np.ndarray, path, quality: int = 90) -> None:
    """Write one (H, W, 3) uint8 RGB image as a baseline 4:2:0 JPEG at
    ``quality`` (PIL's ``save(quality=q)`` on the libjpeg route)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape \
            or not 1 <= quality <= 100:
        raise ValueError(f"encode_jpeg takes a non-empty (H, W, 3) uint8 "
                         f"image and a quality in 1..100, got {img.shape}, "
                         f"{quality}")
    h, w, _ = img.shape
    rc = _need_jpeg(f"writing {path}").encode_jpeg(
        _u8(img), h, w, int(quality), str(path).encode())
    if rc != 0:
        raise OSError(f"encode_jpeg failed on {path} (code {rc}, "
                      f"{route()} route)")
