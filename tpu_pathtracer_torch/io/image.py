"""Image output: PNG and EXR-style float dumps.

The reference never saves an image at all — its only output surface is the
live GL window (reference main.cpp:205-232; SURVEY.md §5 "there is no image
save at all"). Here the file writer IS the primary output device. PNG is
encoded directly against zlib (no imaging dependency in the environment);
HDR data round-trips through .npy (portable float32, loadable anywhere).

Gamma: the reference defines a gamma macro but never applies it
(pathtracer.cu:29,103) and displays linear RGB; `tonemap` applies the
standard 1/2.2 encode by default, with gamma=1.0 reproducing the
reference's linear output.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(hdr: np.ndarray, gamma: float = 2.2, exposure: float = 1.0) -> np.ndarray:
    """Linear HDR float -> uint8 with clamp + gamma encode."""
    img = np.asarray(hdr, np.float32) * exposure
    img = np.clip(img, 0.0, 1.0)
    if gamma != 1.0:
        img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    if rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb8.shape}")
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        data = tag + payload
        return struct.pack(">I", len(payload)) + data + struct.pack(
            ">I", zlib.crc32(data) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_png(path: str, hdr: np.ndarray, gamma: float = 2.2,
             exposure: float = 1.0) -> None:
    """Tonemap linear radiance and write a PNG."""
    write_png(path, tonemap(np.asarray(hdr), gamma=gamma, exposure=exposure))


def save_hdr(path: str, hdr: np.ndarray) -> None:
    """Save linear float32 radiance losslessly (.npy)."""
    np.save(path, np.asarray(hdr, np.float32))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8-bit RGB, filter 0/1/2/3/4)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert (depth, ctype) == (8, 2), "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row = raw[y * (stride + 1) : (y + 1) * (stride + 1)]
        filt, line = row[0], np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if filt == 0:
            cur = line
        elif filt == 2:  # Up
            cur = (line + prev) % 256
        else:  # Sub/Average/Paeth need sequential reconstruction
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) % 256
        out[y] = cur.reshape(w, 3).astype(np.uint8)
        prev = cur
    return out
