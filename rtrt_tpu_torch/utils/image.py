"""Image I/O: dependency-free PNG and PPM read/write on numpy and zlib
(port of rtrt_tpu/utils/image.py; the files are the same bytes)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return img


def encode_png(img, compress_level: int = 6) -> bytes:
    """The bytes of an 8-bit RGB PNG of img ((H, W, 3) or (H, W) uint8, or
    float in [0,1]; numpy, or anything numpy.asarray takes: a CPU tensor),
    every row unfiltered, zlib at `compress_level`."""
    img = _u8(img)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + \
            struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, compress_level))
            + chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    """img: (H, W, 3) uint8 or float in [0,1] (see encode_png)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """8-bit RGB / RGBA PNG file without interlace -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG data") -> np.ndarray:
    """The bytes of an 8-bit RGB / RGBA PNG without interlace -> (H, W, 3)
    uint8 (path names the source in errors)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    w = h = None
    idat = b""
    channels = 3
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype not in (2, 6) or body[12] != 0:
                raise ValueError(f"{path}: unsupported PNG (bit depth "
                                 f"{depth}, colour type {ctype}, interlace "
                                 f"{body[12]})")
            channels = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # sub
            for i in range(channels, stride):
                line[i] = (line[i] + line[i - channels]) & 0xFF
        elif ftype == 2:  # up
            line = (line + prev) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                left = line[i - channels] if i >= channels else 0
                line[i] = (line[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pr) & 0xFF
        else:
            raise ValueError(f"{path}: unsupported PNG filter {ftype}")
        out[y] = line
        prev = line
    return out.reshape(h, w, channels)[..., :3]


def write_ppm(path: str, img) -> None:
    """Binary PPM (P6) dump — the reference's debug format."""
    img = _u8(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img[..., :3].tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a binary PPM (P6)")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        if int(f.readline()) != 255:
            raise ValueError(f"{path}: maxval other than 255")
        return np.frombuffer(f.read(w * h * 3), np.uint8).reshape(h, w, 3)
