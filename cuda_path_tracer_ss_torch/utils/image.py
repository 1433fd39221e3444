"""Image writers: TGA (reference-compatible), PNG, NPY.

The TGA layout matches ``saveScreenshot`` (``CudaTracer/CudaTracer.cu:795-813``):
18-byte uncompressed true-color header, BGR byte order, bottom-up row order
(the GL framebuffer convention). PNG is written with the standard library
(zlib) — no external deps.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _as_uint8_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3], got {img.shape}")
    return img


def write_tga(path: str, img: np.ndarray, bottom_up: bool = True):
    """``img`` is [H,W,3] RGB with row 0 at the bottom (renderer layout)."""
    img = _as_uint8_rgb(img)
    h, w = img.shape[:2]
    if not bottom_up:
        img = img[::-1]
    header = struct.pack(
        "<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0
    )
    bgr = img[:, :, ::-1]  # reference writes GL_BGR
    with open(path, "wb") as f:
        f.write(header)
        f.write(bgr.tobytes())


def encode_png(img: np.ndarray, bottom_up: bool = True) -> bytes:
    """Minimal zlib PNG encoder; flips bottom-up renderer rows to PNG's
    top-down order. Returns the file bytes."""
    img = _as_uint8_rgb(img)
    if bottom_up:
        img = img[::-1]
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, bottom_up: bool = True):
    with open(path, "wb") as f:
        f.write(encode_png(img, bottom_up))


def read_png(path: str) -> np.ndarray:
    """Reads back PNGs written by ``write_png`` (8-bit RGB, no interlace).
    Returns [H,W,3] uint8 in top-down order."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for r in range(h):
        line = raw[r * stride:(r + 1) * stride]
        ftype, scan = line[0], np.frombuffer(line[1:], np.uint8).copy()
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(3, len(scan)):
                scan[i] = (int(scan[i]) + int(scan[i - 3])) & 0xFF
        elif ftype == 2:  # Up
            scan = ((scan.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        else:
            raise NotImplementedError(f"PNG filter {ftype}")
        rows.append(scan)
        prev = scan
    return np.stack(rows).reshape(h, w, 3)


def write_npy(path: str, img: np.ndarray):
    np.save(path, np.asarray(img))
