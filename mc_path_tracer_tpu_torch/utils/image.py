"""Image IO: Radiance .hdr, PNG and JPEG loading, PNG output (the port's
copy of mc_path_tracer_tpu/utils/image.py's `load_hdr`, `_load_radiance_hdr`
and `write_png`, and `read_png` / utils/jpeg.read_jpeg for the images that
the JAX package decodes with PIL and imageio).

PNG encoding and decoding use the standard library's zlib and JPEG
decoding is numpy (utils/jpeg.py), so writing a frame, loading a textured
glTF scene or a PNG / JPEG environment map needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mc_path_tracer_tpu_torch.utils.jpeg import read_jpeg


def load_hdr(path: str) -> np.ndarray:
    """Load an environment image as float32 [H, W, 3] (linear RGB for .hdr).
    .hdr goes through the RGBE decoder below (imageio without an HDR plugin
    decodes Radiance files as 8-bit LDR).  .png, .jpg and .jpeg give what
    the JAX package's `imageio.v3.imread(path).astype(float32)` gives, then
    the same channel handling: raw sample values, not scaled to [0, 1]
    (_png_as_imageio lists each PNG kind); other formats raise ValueError."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        return _load_radiance_hdr(path)
    if not lower.endswith((".png", ".jpg", ".jpeg")):
        raise ValueError(f"{path}: the port loads .hdr, .png, .jpg and .jpeg environment "
                         "maps; other formats (which the JAX package reads with imageio) "
                         "are not decoded")
    with open(path, "rb") as f:
        data = f.read()
    img = _png_as_imageio(data, path) if lower.endswith(".png") else read_jpeg(data, path)
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _png_as_imageio(data: bytes, name: str) -> np.ndarray:
    """A PNG as imageio's pillow plugin returns it: 1-bit grey as 0 / 1,
    grey below 16 bits scaled to 0-255, 16-bit grey as uint16 [H, W]; 16-bit
    RGB and RGBA as their high bytes; grey + alpha [H, W, 2] at 8 bits and
    RGBA (grey replicated, high bytes) at 16; palette expanded to RGB."""
    img = read_png(data, name)
    _, _, depth, ctype, *_ = png_header(data)
    if ctype == 0:
        return img[..., 0] // 255 if depth == 1 else img[..., 0]
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    return img


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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (0 grey, 2 RGB, 3 palette, 4 grey+alpha,
# 6 RGBA) and the bit depths the PNG specification allows for it
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def png_header(data: bytes) -> tuple[int, ...]:
    """(width, height, bit depth, colour type, compression, filter,
    interlace) of a PNG's IHDR chunk, which the specification puts first."""
    if not data.startswith(PNG_SIGNATURE) or data[12:16] != b"IHDR":
        raise ValueError("not a PNG image")
    return struct.unpack(">IIBBBBB", data[16:29])


def read_png(data: bytes, name: str = "image") -> np.ndarray:
    """Decode a PNG to [H, W, C]: C = 1 grey, 2 grey + alpha, 3 RGB or
    palette (expanded through PLTE), 4 RGBA; uint8, or uint16 for 16-bit
    images.  Every colour type and bit depth of the specification, filter
    types 0-4, non-interlaced and Adam7-interlaced (each of the seven passes
    is unfiltered on its own); grey below 8 bits is scaled to 0-255, as PIL
    does.  Transparency (tRNS) is not applied.  Malformed data raises
    ValueError naming `name`."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG image")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _PNG_CHANNELS or compression != 0 or filt != 0 or interlace > 1 \
            or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{name}: malformed PNG header {header}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, _PNG_CHANNELS[ctype]), np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue   # an empty pass has no rows, not even filter bytes
        samples, offset = _png_pass(raw, offset, pw, ph, depth, ctype, name)
        out[y0::dy, x0::dx] = samples
    if ctype == 3:
        if int(out.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{name}: palette index out of range")
        out = palette[out[..., 0]]
    return np.ascontiguousarray(out)


def _png_pass(raw: np.ndarray, offset: int, w: int, h: int, depth: int, ctype: int,
              name: str):
    """Unfilter and unpack the h rows of w pixels that start at `offset` in
    the inflated data: (samples [h, w, C], offset after them)."""
    channels = _PNG_CHANNELS[ctype]
    bpp = max(1, depth * channels // 8)          # filter unit in bytes
    stride = (w * channels * depth + 7) // 8     # bytes per row
    end = offset + h * (stride + 1)
    if raw.size < end:
        raise ValueError(f"{name}: PNG data ends early")
    rows = raw[offset:end].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, bpp, name)
        prior = out[y]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, channels), end
    if depth < 8:
        bits = np.unpackbits(out, axis=1).reshape(h, -1, depth)[:, :w]
        out = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=-1, dtype=np.uint8)
        if ctype == 0:   # scale grey levels to 8 bits
            out = (out.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    return out.reshape(h, w, channels), end


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int,
              name: str) -> np.ndarray:
    """One reconstructed PNG scanline.  None, Up and Sub are vectorised
    (Sub is a running sum modulo 256 per byte lane); Average and Paeth
    depend on the byte just reconstructed and run byte by byte."""
    if kind == 0:
        return line
    if kind == 2:
        return line + prior
    if kind == 1:
        pad = (-line.size) % bpp
        lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
        return np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[: line.size]
    if kind not in (3, 4):
        raise ValueError(f"{name}: unknown PNG filter type {kind}")
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    if kind == 3:
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(len(cur)):
            if i >= bpp:
                a, c = cur[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def write_hdr_npy(path: str, img) -> None:
    """Save linear HDR radiance losslessly as float32 .npy (a tensor is
    copied to the host first)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    np.save(path, np.asarray(img, np.float32))
