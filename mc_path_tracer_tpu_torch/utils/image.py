"""Image IO: Radiance .hdr loading and PNG output (the port's copy of
mc_path_tracer_tpu/utils/image.py's `load_hdr`, `_load_radiance_hdr` and
`write_png`).

The PNG writer encodes with the standard library's zlib, so writing a frame
needs no imaging package; only `load_hdr` of a non-.hdr file imports
imageio.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance .hdr (or other float image) as float32 [H, W, 3]
    linear RGB.  .hdr goes through the RGBE decoder below: imageio without
    an HDR plugin decodes Radiance files as 8-bit LDR."""
    if path.lower().endswith(".hdr"):
        return _load_radiance_hdr(path)
    import imageio.v3 as iio

    img = np.asarray(iio.imread(path)).astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder with new-style RLE."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].decode().split()
    pos = eol + 1
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"{path}: unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # flat (uncompressed) scanline
            rgbe[y] = buf[bp : bp + 4 * w].reshape(w, 4)
            bp += 4 * w
            continue
        if (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != w:
            raise ValueError(f"{path}: scanline {y} has the wrong width")
        bp += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(buf[bp])
                bp += 1
                if n > 128:  # run
                    rgbe[y, x : x + n - 128, c] = buf[bp]
                    bp += 1
                    x += n - 128
                else:  # literal
                    rgbe[y, x : x + n, c] = buf[bp : bp + n]
                    bp += n
                    x += n
    exp = rgbe[..., 3].astype(np.int32) - 136  # 128 + 8 mantissa bits
    scale = np.ldexp(1.0, exp).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return rgb


def _chunk(kind: bytes, payload: bytes) -> bytes:
    body = kind + payload
    return struct.pack(">I", len(payload)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 or float [H, W, 3] image to an 8-bit RGB PNG (floats
    in [0, 1] are rounded to 8 bits)."""
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    # filter type 0 (none) before every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    png = b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])
    with open(path, "wb") as f:
        f.write(png)
