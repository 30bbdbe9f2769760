"""The port's PNG reader: stdlib ``zlib`` and numpy, no PIL.

Reads non-interlaced PNGs of 8 bits a sample (grayscale, grayscale +
alpha, RGB, RGBA, palette) and of 1, 2 or 4 bits (grayscale, palette),
and returns (H, W, 3) uint8 with PIL's ``convert("RGB")`` semantics:
alpha is dropped (not composited), a palette is expanded (``tRNS`` is
ignored), grayscale is replicated, and a low-bit grayscale sample is
scaled to 0–255 as PIL's ``L;1/2/4`` unpackers do.  Anything else
(16-bit samples, interlaced images, a bad CRC or stream) raises
:class:`PNGError` naming the file.

:func:`write_png` writes 8-bit RGB (the standardizer's ``.png`` outputs
and the evaluation plots): each row Up-filtered, zlib level 6.  Its
pixels are what PIL's writer would store; its bytes are not PIL's.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples


class PNGError(ValueError):
    """A PNG the port cannot (or may not) decode."""


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the five PNG filters row by row -> (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise PNGError(f"{path}: PNG image data is truncated "
                       f"({len(raw)} of {h * (stride + 1)} bytes)")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                       # Sub: running sum per lane
            pad = -stride % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = np.cumsum(lanes.reshape(-1, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).ravel()[:stride]
        elif ftype == 2:                       # Up
            cur = line + prior
        elif ftype in (3, 4):                  # Average, Paeth: serial
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise PNGError(f"{path}: unknown PNG filter type {ftype} in "
                           f"row {y}")
        out[y] = cur
        prior = out[y]
    return out


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, stride) packed samples (big-endian within a byte) -> (h, w)."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)   # MSB first
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w]


def read_png(path) -> np.ndarray:
    """Decode the PNG at ``path`` to (H, W, 3) uint8 (module doc)."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise PNGError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(SIGNATURE), None, None, []
    while True:
        if pos + 8 > len(data):
            raise PNGError(f"{path}: PNG ends before its IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{path}: PNG chunk {ctype!r} is truncated")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise PNGError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise PNGError(f"{path}: PNG colour type {colour} is invalid")
    allowed = (1, 2, 4, 8) if colour in (0, 3) else (8,)
    if depth not in allowed:
        raise PNGError(f"{path}: {depth}-bit PNG (colour type {colour}) is "
                       "not supported by the port's reader (8-bit, or "
                       "1/2/4-bit grayscale and palette only)")
    if interlace:
        raise PNGError(f"{path}: interlaced (Adam7) PNG is not supported by "
                       "the port's reader")
    if colour == 3 and palette is None:
        raise PNGError(f"{path}: palette PNG without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: corrupt PNG image data ({e})") from e
    ch = _CHANNELS[colour]
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, ch * depth // 8), path)
    if depth < 8:
        samples = _unpack_bits(rows, w, depth)
        if colour == 0:                       # L;1/2/4 scale to 0..255
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    else:
        samples = rows.reshape(h, w, ch)
    if colour == 3:
        # PIL pads a short palette with its grey ramp
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        lut[:len(palette)] = palette[:256]
        return lut[samples.reshape(h, w)]
    if colour in (0, 4):
        grey = samples.reshape(h, w, -1)[..., 0]
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path, img: np.ndarray) -> None:
    """Write one (H, W, 3) uint8 RGB image as an 8-bit, non-interlaced
    PNG: every row Up-filtered (its difference from the row above, which
    keeps the flat regions of a plot to runs of zeros), zlib level 6."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"write_png takes a non-empty (H, W, 3) uint8 "
                         f"image, got {img.shape}")
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]                       # uint8 wraps: mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b""))
