"""The port's image decoders against PIL and imageio, as the JAX package
uses them: `utils.gltf._decode_image` (read_jpeg / read_png, then
_to_rgb) must equal the JAX package's `_decode_image` (PIL's
convert("RGB")) exactly, and `utils.image.load_hdr` of .png / .jpg paths
the JAX package's load_hdr (imageio) exactly.

JPEGs come from PIL (qualities 50, 90, 100; 4:4:4, 4:2:2, 4:2:0; grey;
progressive; restart markers; sizes that are not multiples of the MCU;
CMYK) and from the writers below for what PIL cannot write, using the
tables of a JPEG PIL wrote: `encode_jpeg` for the sampling PIL cannot
write (4:4:0 and mixed chroma factors), `ycck_jpeg` for YCCK,
`arithmetic_jpeg` for arithmetic-coded frames (a QM-coder after libjpeg's
jcarith.c that transcodes the coefficients of a JPEG PIL wrote, which PIL
must decode to the original's pixels), `lossless_jpeg` for lossless
frames.  PNGs come from `encode_png` below (PIL writes neither interlaced
nor 16-bit colour PNGs): Adam7-interlaced in every colour type and 16-bit
in every colour type that allows it (PIL's high-byte and I;16-clip
conversions).  The JPEG kinds the port refuses, PIL refuses too."""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from mc_path_tracer_tpu.utils import gltf as jgltf
from mc_path_tracer_tpu.utils import image as jimage
from mc_path_tracer_tpu_torch.utils import gltf as tgltf
from mc_path_tracer_tpu_torch.utils import image as timage
from mc_path_tracer_tpu_torch.utils.jpeg import QM_STATES, cmyk_to_rgb, decode_jpeg, read_jpeg


# --- encoders: their output is decoded by PIL / imageio as the reference ---

# T.81 Table D.2 packed as jdarith.c / jcarith.c pack it
QM = tuple((qe, (switch << 7) | lps, mps) for qe, lps, mps, switch in QM_STATES)

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _rows(img: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, C] as the bytes of each row [h, stride]."""
    h = img.shape[0]
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, -1)
    flat = img.reshape(h, -1).astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(rows: np.ndarray, bpp: int, filter_type: int) -> bytes:
    raw = rows.astype(np.int32)
    h, n = raw.shape
    prior = np.vstack([np.zeros((1, n), np.int32), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), raw[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), prior[:, :-bpp]])
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
            4: _paeth(left, prior, upleft)}[filter_type]
    out = ((raw - pred) & 0xFF).astype(np.uint8)
    return np.hstack([np.full((h, 1), filter_type, np.uint8), out]).tobytes()


def encode_png(img: np.ndarray, depth: int = 8, ctype: int | None = None,
               interlace: bool = False, filter_type: int = 0, palette=None,
               trns: bytes | None = None) -> bytes:
    """PNG bytes of samples [H, W, C] (palette indices [H, W] with
    `palette` [N, 3]) at `depth` bits per sample."""
    img = np.asarray(img)
    if palette is not None:
        ctype, img = 3, img[..., None]
    elif img.ndim == 2:
        img = img[..., None]
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[2]]
    h, w, c = img.shape
    bpp = max(1, depth * c // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b"".join(_filtered(_rows(img[y0::dy, x0::dx], depth), bpp, filter_type)
                    for x0, y0, dx, dy in passes if x0 < w and y0 < h)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                  int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    out += [_chunk(b"IDAT", zlib.compress(data, 6)), _chunk(b"IEND", b"")]
    return b"".join(out)


def _segments(data: bytes) -> dict[int, list[bytes]]:
    """Marker -> the whole segments (marker included) of a JPEG's header."""
    out, pos = {}, 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        out.setdefault(data[pos + 1], []).append(data[pos : pos + 2 + length])
        pos += 2 + length
    return out


def _huffman_codes(segment: bytes) -> dict[int, dict[int, tuple[int, int]]]:
    """(class << 4 | id) -> {symbol: (code, length)} of a DHT segment."""
    out, i, body = {}, 0, segment[4:]
    while i < len(body):
        counts, code, k, table = body[i + 1 : i + 17], 0, 0, {}
        symbols = body[i + 17 : i + 17 + sum(counts)]
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                table[symbols[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        out[body[i]] = table
        i += 17 + sum(counts)
    return out


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(0.5), 1.0)[:, None]
    return 0.5 * c * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)


_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _pil_tables(quality: int):
    """The header segments of a 4:2:0 JPEG PIL wrote at `quality`, its
    quantisation tables {id: [8, 8]} and its Huffman codes."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG", quality=quality,
                                                           subsampling=2)
    seg = _segments(buf.getvalue())
    qt = {}
    for s in seg[0xDB]:
        body, i = s[4:], 0
        while i < len(body):
            table = np.zeros(64)
            table[_ZIGZAG] = np.frombuffer(body[i + 1 : i + 65], np.uint8)
            qt[body[i] & 15] = table.reshape(8, 8)
            i += 65
    codes = {}
    for s in seg[0xC4]:
        codes.update(_huffman_codes(s))
    return seg, qt, codes


class Coefficients:
    """A sequential JPEG's quantised coefficients, ready for another
    entropy coder: `blocks[c]` [bh, bw, 64] zigzag ints (MCU-padded),
    `comps` [(id, h, v, tq)], the frame size and the header segments that
    carry over (APPn, DQT)."""

    def __init__(self, height, width, comps, blocks, segments):
        self.height, self.width, self.comps = height, width, comps
        self.blocks, self.segments = blocks, segments
        self.hmax, self.vmax = max(c[1] for c in comps), max(c[2] for c in comps)
        self.mx, self.my = -(-width // (8 * self.hmax)), -(-height // (8 * self.vmax))

    def own_blocks(self, ci):
        """A component's blocks in a non-interleaved scan: [ny, nx]."""
        _, h, v, _ = self.comps[ci]
        dw, dh = -(-self.width * h // self.hmax), -(-self.height * v // self.vmax)
        return -(-dh // 8), -(-dw // 8)

    def mcu_blocks(self, m, cis):
        """The (component, block row, block column) of MCU m of a scan of
        components `cis`."""
        if len(cis) == 1:
            ny, nx = self.own_blocks(cis[0])
            by, bx = divmod(m, nx)
            return ((cis[0], by, bx),)
        my_, mx_ = divmod(m, self.mx)
        return tuple((ci, my_ * self.comps[ci][2] + y, mx_ * self.comps[ci][1] + x)
                     for ci in cis for y in range(self.comps[ci][2])
                     for x in range(self.comps[ci][1]))

    def mcus(self, cis):
        if len(cis) == 1:
            ny, nx = self.own_blocks(cis[0])
            return ny * nx
        return self.mx * self.my


def huffman_coefficients(data: bytes) -> Coefficients:
    """The coefficients of a baseline JPEG with one interleaved scan, as PIL
    writes it (restart markers allowed)."""
    seg = _segments(data)
    codes = {}
    for s in seg[0xC4]:
        codes.update(_huffman_codes(s))
    lookup = {k: {(code, length): sym for sym, (code, length) in t.items()}
              for k, t in codes.items()}
    body = seg[0xC0][0][4:]
    height, width, nc = struct.unpack_from(">HHB", body, 1)
    comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15, body[8 + 3 * k])
             for k in range(nc)]
    restart = struct.unpack_from(">H", seg[0xDD][0], 4)[0] if 0xDD in seg else 0
    sos = data.index(b"\xff\xda")
    (length,) = struct.unpack_from(">H", data, sos + 2)
    sel = {data[sos + 5 + 2 * k]: data[sos + 6 + 2 * k] for k in range(nc)}
    stream = data[sos + 2 + length : data.rindex(b"\xff\xd9")]
    coef = Coefficients(height, width, comps, None, [
        s for m in sorted(seg) if m == 0xDB or 0xE0 <= m <= 0xEF for s in seg[m]])
    coef.blocks = [np.zeros((coef.my * v, coef.mx * h, 64), np.int64) for _, h, v, _ in comps]
    parts = [p.replace(b"\xff\x00", b"\xff") for p in _split_restarts(stream)]
    n_mcu = coef.mx * coef.my
    per = restart or n_mcu
    for r, part in enumerate(parts):
        bits = np.unpackbits(np.frombuffer(part + bytes(4), np.uint8)).tolist()
        pos, pred = 0, [0] * nc

        def symbol(table):
            nonlocal pos
            code, length = 0, 0
            while (code, length) not in table:
                code, length, pos = (code << 1) | bits[pos], length + 1, pos + 1
            return table[(code, length)]

        def extra(size):
            nonlocal pos
            v = 0
            for _ in range(size):
                v, pos = (v << 1) | bits[pos], pos + 1
            return v - (1 << size) + 1 if size and v < 1 << (size - 1) else v

        for m in range(r * per, min(n_mcu, (r + 1) * per)):
            for ci, by, bx in coef.mcu_blocks(m, list(range(nc))):
                cid = comps[ci][0]
                blk = coef.blocks[ci][by, bx]
                pred[ci] += extra(symbol(lookup[sel[cid] >> 4]))
                blk[0] = pred[ci]
                k = 1
                while k < 64:
                    rs = symbol(lookup[0x10 | (sel[cid] & 15)])
                    if rs == 0:
                        break
                    k += rs >> 4
                    if rs & 15:
                        blk[k] = extra(rs & 15)
                    k += 1
    return coef


def _split_restarts(stream: bytes) -> list[bytes]:
    out, start, i = [], 0, 0
    while True:
        i = stream.find(b"\xff", i)
        if i < 0:
            break
        if 0xD0 <= stream[i + 1] <= 0xD7:
            out.append(stream[start:i])
            start = i = i + 2
        else:
            i += 2
    out.append(stream[start:])
    return out


def dct_coefficients(planes: np.ndarray, sampling, qt: dict, qsel) -> Coefficients:
    """Quantised DCT coefficients of component planes [H, W, C] (already in
    the JPEG's colour space, 0..255) with per-component sampling (h, v)
    and quantisation table ids `qsel`."""
    h, w, nc = planes.shape
    comps = [(ci + 1, hs, vs, qsel[ci]) for ci, (hs, vs) in enumerate(sampling)]
    coef = Coefficients(h, w, comps, [], [])
    full = np.pad(planes.astype(np.float64), ((0, coef.my * 8 * coef.vmax - h),
                                              (0, coef.mx * 8 * coef.hmax - w), (0, 0)),
                  mode="edge")
    d = _dct_matrix()
    for ci, (hs, vs) in enumerate(sampling):
        fh, fv = coef.hmax // hs, coef.vmax // vs
        plane = full[..., ci].reshape(full.shape[0] // fv, fv, full.shape[1] // fh, fh)
        plane = plane.mean(axis=(1, 3)) - 128.0
        b = plane.reshape(coef.my * vs, 8, coef.mx * hs, 8).transpose(0, 2, 1, 3)
        c = np.einsum("uk,abkl,vl->abuv", d, b, d)
        q = np.round(c / qt[qsel[ci]]).astype(np.int64)
        coef.blocks.append(q.reshape(coef.my * vs, coef.mx * hs, 64)[..., _ZIGZAG])
    return coef


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.float64)
    return np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                     128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
                     128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]], -1)


def _huffman_scan(coef: Coefficients, codes, restart: int) -> bytes:
    """One interleaved baseline scan of every component (tables 0 for the
    first component, 1 for the others)."""
    nc = len(coef.comps)
    bits, pred, count = _Bits(), [0] * nc, 0
    for m in range(coef.mcus(list(range(nc)))):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + count % 8])
            count += 1
            pred = [0] * nc
        for ci, by, bx in coef.mcu_blocks(m, list(range(nc))):
            dc_t, ac_t = codes[0x00 | (ci > 0)], codes[0x10 | (ci > 0)]
            blk = coef.blocks[ci][by, bx]
            diff = int(blk[0]) - pred[ci]
            pred[ci] = int(blk[0])
            size = abs(diff).bit_length()
            bits.put(*dc_t[size])
            bits.put(diff if diff >= 0 else diff - 1, size)
            run = 0
            last = max([k for k in range(1, 64) if blk[k]], default=0)
            for k in range(1, last + 1):
                v = int(blk[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac_t[0xF0])
                    run -= 16
                size = abs(v).bit_length()
                bits.put(*ac_t[(run << 4) | size])
                bits.put(v if v >= 0 else v - 1, size)
                run = 0
            if last < 63:
                bits.put(*ac_t[0x00])
    bits.flush()
    return bytes(bits.out)


def _frame(sof: int, coef: Coefficients, precision: int = 8) -> bytes:
    return _marker(sof, struct.pack(">BHHB", precision, coef.height, coef.width,
                                    len(coef.comps))
                   + b"".join(bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in coef.comps))


def _sos(cis, coef, ss, se, ah, al, tables=None) -> bytes:
    """A scan header; table selectors 0 for the first component, 1 for
    the others, unless `tables` gives them."""
    sel = [tables[ci] if tables else (0x11 if ci else 0x00) for ci in cis]
    return _marker(0xDA, bytes([len(cis)]) + b"".join(
        bytes([coef.comps[ci][0], s]) for ci, s in zip(cis, sel)) + bytes([ss, se, ah << 4 | al]))


def encode_jpeg(rgb: np.ndarray, sampling=((1, 2), (1, 1), (1, 1)), quality: int = 90,
                restart: int = 0) -> bytes:
    """Baseline YCbCr JPEG of uint8 [H, W, 3] with per-component sampling
    factors (h, v), restart interval `restart` MCUs (0: none)."""
    seg, qt, codes = _pil_tables(quality)
    coef = dct_coefficients(_rgb_to_ycc(rgb), sampling, qt, (0, 1, 1))
    parts = [b"\xff\xd8", *seg[0xE0], *seg[0xDB], _frame(0xC0, coef), *seg[0xC4]]
    if restart:
        parts.append(_marker(0xDD, struct.pack(">H", restart)))
    parts += [_sos([0, 1, 2], coef, 0, 63, 0, 0), _huffman_scan(coef, codes, restart),
              b"\xff\xd9"]
    return b"".join(parts)


class _QMEncoder:
    """T.81 Annex D's QM-coder as libjpeg's jcarith.c writes it (D.1.4-D.1.8,
    byte stuffing, carry over stacked 0xFF bytes, trailing zeros dropped)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _emit(self, byte):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, bins, k, val):
        sv = bins[k]
        qe, nl, nm = QM[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[k] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[k] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _qm_value(enc, st, s, v, x_bins, x1):
    """Figures F.8 / F.9: the magnitude category and bits of v - 1 (v > 0)
    from bin s (DC: then X1 = bin 20; AC: the second decision at s, then
    X2 = bin x1); returns the category's top bit m."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, s, 1)
        m, v2 = 1, v
        if x_bins == "dc":
            s = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, s, 1)
                m <<= 1
                s += 1
        elif v2 >> 1:
            v2 >>= 1
            enc.encode(st, s, 1)
            m <<= 1
            s = x1
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, s, 1)
                m <<= 1
                s += 1
    enc.encode(st, s, 0)
    category = m
    s += 14
    m >>= 1
    while m:
        enc.encode(st, s, 1 if m & v else 0)
        m >>= 1
    return category


def arithmetic_scans(coef: Coefficients, script, restart: int = 0, dc_lu=(0, 1), ac_k=5):
    """Arithmetic-coded scans of `coef` (jcarith.c's encode_mcu and
    progressive encode_mcu_*): `script` lists (component indices, Ss, Se,
    Ah, Al), or None for one sequential scan; every component uses
    conditioning table 0 for DC and AC.  Returns the scans, headers
    included."""
    sequential = script is None
    nc = len(coef.comps)
    script = [(list(range(nc)), 0, 63, 0, 0)] if sequential else script
    out = []
    for cis, ss, se, ah, al in script:
        data = bytearray()
        enc, stats = None, None
        n_mcu = coef.mcus(cis)
        for m in range(n_mcu):
            if m == 0 or (restart and m % restart == 0):
                if enc is not None:
                    data += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                enc = _QMEncoder()
                dc, ac, fixed = bytearray(64), bytearray(256), bytearray([113])
                last, ctx = [0] * nc, [0] * nc
            for ci, by, bx in coef.mcu_blocks(m, cis):
                blk = coef.blocks[ci][by, bx]
                if ss == 0 and ah and not sequential:       # DC refinement
                    enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                    continue
                if ss == 0:
                    dcv = int(blk[0]) >> al
                    v, last[ci] = dcv - last[ci], dcv
                    s = ctx[ci]
                    if v == 0:
                        enc.encode(dc, s, 0)
                        ctx[ci] = 0
                    else:
                        enc.encode(dc, s, 1)
                        enc.encode(dc, s + 1, int(v < 0))
                        ctx[ci] = 8 if v < 0 else 4
                        s += 3 if v < 0 else 2
                        mcat = _qm_value(enc, dc, s, abs(v), "dc", None)
                        if mcat < (1 << dc_lu[0]) >> 1:
                            ctx[ci] = 0
                        elif mcat > (1 << dc_lu[1]) >> 1:
                            ctx[ci] += 8
                    if not sequential:
                        continue
                    k0, k1 = 1, 63
                else:
                    k0, k1 = ss, se
                vals = [abs(int(blk[k])) >> al for k in range(64)]
                signs = [int(blk[k]) < 0 for k in range(64)]
                ke = max([k for k in range(k0, k1 + 1) if vals[k]], default=k0 - 1)
                if ah and not sequential:                   # AC refinement
                    kex = max([k for k in range(k0, ke + 1) if vals[k] >> 1], default=0)
                    k = k0
                    while k <= ke:
                        s = 3 * (k - 1)
                        if k > kex:
                            enc.encode(ac, s, 0)
                        while True:
                            if vals[k]:
                                if vals[k] >> 1:
                                    enc.encode(ac, s + 2, vals[k] & 1)
                                else:
                                    enc.encode(ac, s + 1, 1)
                                    enc.encode(fixed, 0, int(signs[k]))
                                break
                            enc.encode(ac, s + 1, 0)
                            s += 3
                            k += 1
                        k += 1
                else:
                    k = k0
                    while k <= ke:
                        s = 3 * (k - 1)
                        enc.encode(ac, s, 0)
                        while not vals[k]:
                            enc.encode(ac, s + 1, 0)
                            s += 3
                            k += 1
                        enc.encode(ac, s + 1, 1)
                        enc.encode(fixed, 0, int(signs[k]))
                        _qm_value(enc, ac, s + 2, vals[k], "ac", 189 if k <= ac_k else 217)
                        k += 1
                if k <= k1:
                    enc.encode(ac, 3 * (k - 1), 1)
        data += enc.finish()
        out.append(_sos(cis, coef, ss, se, ah, al, tables=[0x00] * nc) + bytes(data))
    return out


def arithmetic_jpeg(coef: Coefficients, script=None, restart: int = 0, dac=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with a progressive
    `script`) of `coef` with its header segments; `dac` = (dc_l, dc_u,
    ac_k) writes a DAC marker with that conditioning."""
    lu, k = ((dac[0], dac[1]), dac[2]) if dac else ((0, 1), 5)
    parts = [b"\xff\xd8", *coef.segments, _frame(0xC9 if script is None else 0xCA, coef)]
    if dac:
        parts.append(_marker(0xCC, bytes([0x00, (dac[1] << 4) | dac[0], 0x10, dac[2]])))
    if restart:
        parts.append(_marker(0xDD, struct.pack(">H", restart)))
    parts += arithmetic_scans(coef, script, restart, lu, k)
    return b"".join(parts) + b"\xff\xd9"


def _predict(x: np.ndarray, psv: int, pt: int, interval_rows: int) -> np.ndarray:
    """T.81 H.1.2.1's prediction of every sample of x [h, w] (ints): the
    first row of each restart interval from the left (its first sample
    2^(7 - Pt)), the first column of the other rows from above, the rest
    with predictor psv."""
    x = x.astype(np.int64)
    pred = np.zeros_like(x)
    for y in range(x.shape[0]):
        if y % interval_rows == 0:
            pred[y, 0] = 1 << (7 - pt)
            pred[y, 1:] = x[y, :-1]
            continue
        ra, rb, rc = x[y, :-1], x[y - 1, 1:], x[y - 1, :-1]
        pred[y, 0] = x[y - 1, 0]
        pred[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                       6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
    return pred


def lossless_jpeg(img: np.ndarray, psv: int, pt: int = 0, sampling=None,
                  restart_rows: int = 0, segments=(), precision: int = 8) -> bytes:
    """A Huffman-coded lossless JPEG (SOF3) of uint8 samples [H, W, C] (or
    [H, W]) stored as they are, in one interleaved scan with predictor
    `psv` and point transform `pt`; a component sampled (h, v) below the
    largest factors keeps every (hmax / h)-th column and (vmax / v)-th row.
    The Huffman table is PIL's luminance DC table."""
    seg, _, codes = _pil_tables(90)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    sampling = sampling or [(1, 1)] * nc
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // hmax), -(-h // vmax)
    comps = [(ci + 1, hs, vs, 0) for ci, (hs, vs) in enumerate(sampling)]
    coef = Coefficients(h, w, comps, None, [])
    coef.mx, coef.my = mx, my
    diffs = []
    for ci, (hs, vs) in enumerate(sampling):
        plane = img[:: vmax // vs, :: hmax // hs, ci].astype(np.int64) >> pt
        plane = np.pad(plane, ((0, my * vs - plane.shape[0]), (0, mx * hs - plane.shape[1])),
                       mode="edge")
        rows = restart_rows * vs if restart_rows else plane.shape[0]
        diffs.append(plane - _predict(plane, psv, pt, rows))
    dc = codes[0x00]
    bits, count = _Bits(), 0
    for m in range(mx * my):
        if restart_rows and m and m % (restart_rows * mx) == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + count % 8])
            count += 1
        my_, mx_ = divmod(m, mx)
        for ci, (hs, vs) in enumerate(sampling):
            for y in range(vs):
                for x in range(hs):
                    d = int(diffs[ci][my_ * vs + y, mx_ * hs + x])
                    size = abs(d).bit_length()
                    bits.put(*dc[size])
                    bits.put(d if d >= 0 else d - 1, size)
    bits.flush()
    parts = [b"\xff\xd8", *segments, _frame(0xC3, coef, precision), *seg[0xC4]]
    if restart_rows:
        parts.append(_marker(0xDD, struct.pack(">H", restart_rows * mx)))
    parts += [_sos(list(range(nc)), coef, psv, 0, 0, pt, tables=[0x00] * nc),
              bytes(bits.out), b"\xff\xd9"]
    return b"".join(parts)


# --- tests ---

def photo(h, w, seed=0, grey=False):
    """A smooth pattern with noise: every DCT band is in use."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(y / 5.0),
                    (x * 3 + y * 2) % 256], -1)
    img = img + np.random.default_rng(seed).normal(0, 20, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def decode_both(data: bytes, srgb: bool):
    """The two packages' _decode_image of `data` as a glTF image."""
    gltf = {"images": [{"bufferView": 0}],
            "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}]}
    return tgltf._decode_image(gltf, data, 0, srgb), jgltf._decode_image(gltf, data, 0, srgb)


def assert_decodes_as_pil(data: bytes):
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    for srgb in (True, False):
        got, ref = decode_both(data, srgb)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    if data.startswith(b"\xff\xd8"):
        np.testing.assert_array_equal(read_jpeg(data), want)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_jpeg_equals_pil(quality, subsampling, progressive):
    assert_decodes_as_pil(pil_jpeg(photo(40, 56, quality), quality=quality,
                                   subsampling=subsampling, progressive=progressive))


@pytest.mark.parametrize("size", [(23, 37), (37, 23), (1, 9), (17, 130)])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2"])
def test_jpeg_odd_sizes_equal_pil(size, subsampling):
    """Sizes that are not multiples of the MCU: the components are cropped
    to their downsampled size before upsampling (and a width of 1 takes
    libjpeg-turbo's box upsampling)."""
    assert_decodes_as_pil(pil_jpeg(photo(*size, seed=size[0]), quality=85,
                                   subsampling=subsampling))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("blocks", [1, 5])
def test_jpeg_restart_markers_equal_pil(blocks, progressive):
    data = pil_jpeg(photo(48, 41, blocks), quality=90, subsampling="4:2:0",
                    progressive=progressive, restart_marker_blocks=blocks)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("progressive", [False, True])
def test_grey_jpeg_equals_pil(progressive):
    assert_decodes_as_pil(pil_jpeg(photo(37, 23, 4, grey=True), quality=75,
                                   progressive=progressive))


@pytest.mark.parametrize("sampling", [
    ((1, 2), (1, 1), (1, 1)),            # 4:4:0
    ((2, 2), (1, 2), (2, 1)),            # chroma components sampled apart
    ((1, 1), (1, 1), (1, 1)),
], ids=["4:4:0", "mixed", "4:4:4"])
@pytest.mark.parametrize("restart", [0, 3])
def test_encoded_sampling_equals_pil(sampling, restart):
    """Sampling factors PIL cannot write (encode_jpeg): h1v2
    fancy upsampling, and h2v1 / h1v2 chroma in one image."""
    assert_decodes_as_pil(encode_jpeg(photo(23, 37, 9), sampling, 90, restart))


def test_adobe_rgb_jpeg_equals_pil():
    """A JPEG stored as RGB (Adobe transform 0): no colour conversion."""
    buf = io.BytesIO()
    Image.fromarray(photo(16, 24, 2)).save(buf, "JPEG", quality=90, keep_rgb=True)
    data = buf.getvalue()
    assert_decodes_as_pil(data)


def _patched(data: bytes, marker: int, precision=None) -> bytes:
    """`data` with its first frame marker replaced (and its sample
    precision)."""
    i = min(data.index(bytes([0xFF, m])) for m in (0xC0, 0xC3) if bytes([0xFF, m]) in data)
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with colour transform `transform`."""
    return _marker(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def progressive_script(nc: int):
    """A scan script in the shape of libjpeg's default progression: DC
    first at Al 1, spectral bands of the first component at Al 2, the
    others' at Al 1, then successive-approximation refinements."""
    every = list(range(nc))
    if nc == 1:
        return [(every, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                ([0], 1, 63, 2, 1), (every, 0, 0, 1, 0), ([0], 1, 63, 1, 0)]
    return ([(every, 0, 0, 0, 1), ([0], 1, 5, 0, 2)]
            + [([c], 1, 63, 0, 1) for c in range(1, nc)]
            + [([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), (every, 0, 0, 1, 0)]
            + [([c], 1, 63, 1, 0) for c in range(1, nc)] + [([0], 1, 63, 1, 0)])


def cmyk_photo(h, w, seed=0) -> np.ndarray:
    img = photo(h, w, seed)
    return np.dstack([img, 255 - img[..., 1:2] // 2])


def pil_cmyk_jpeg(h=48, w=64, seed=0, **kw) -> bytes:
    """A CMYK JPEG as PIL writes it: Adobe transform 0, stored inverted."""
    buf = io.BytesIO()
    Image.fromarray(cmyk_photo(h, w, seed), "CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


# name: (the Huffman JPEG PIL writes, arithmetic_jpeg's arguments)
ARITHMETIC_CASES = {
    "4:2:0": (lambda: pil_jpeg(photo(48, 64, 20), quality=90, subsampling="4:2:0"), {}),
    "4:4:4 restart": (lambda: pil_jpeg(photo(48, 64, 21), quality=75, subsampling="4:4:4"),
                      dict(restart=5)),
    "4:2:2 DAC": (lambda: pil_jpeg(photo(48, 64, 22), quality=95, subsampling="4:2:2"),
                  dict(dac=(1, 3, 2))),
    "odd size": (lambda: pil_jpeg(photo(37, 23, 23), quality=85, subsampling="4:2:0"),
                 dict(restart=2)),
    "grey": (lambda: pil_jpeg(photo(37, 23, 24, grey=True), quality=80), {}),
    "progressive 4:2:0": (lambda: pil_jpeg(photo(48, 64, 25), quality=90),
                          dict(script=progressive_script(3))),
    "progressive restart DAC": (lambda: pil_jpeg(photo(48, 64, 26), quality=90),
                                dict(script=progressive_script(3), restart=3, dac=(0, 2, 8))),
    "progressive grey": (lambda: pil_jpeg(photo(37, 23, 27, grey=True), quality=80),
                         dict(script=progressive_script(1))),
    "CMYK": (lambda: pil_cmyk_jpeg(seed=28, quality=90), {}),
    "progressive CMYK restart": (lambda: pil_cmyk_jpeg(seed=29, quality=90),
                                 dict(script=progressive_script(4), restart=2)),
}


def arithmetic_case(name: str) -> tuple[bytes, bytes]:
    """(the Huffman original, its arithmetic-coded transcode)."""
    make, kw = ARITHMETIC_CASES[name]
    orig = make()
    return orig, arithmetic_jpeg(huffman_coefficients(orig), **kw)


@pytest.mark.parametrize("case", list(ARITHMETIC_CASES))
def test_arithmetic_jpeg_equals_pil(case):
    """SOF9 / SOF10 transcodes of PIL-written JPEGs: PIL decodes each to
    the Huffman original's pixels (which checks the transcoder), and the
    port to PIL's, through the glTF path too."""
    orig, data = arithmetic_case(case)
    assert bytes([0xFF, 0xCA if "progressive" in case else 0xC9]) in data
    np.testing.assert_array_equal(pil_rgb(data), pil_rgb(orig))
    assert_decodes_as_pil(data)


LOSSLESS_CASES = {
    **{f"predictor {p}": dict(psv=p) for p in range(1, 8)},
    "grey": dict(psv=4, img="grey"),
    "point transform 2": dict(psv=5, pt=2),
    "restart rows": dict(psv=6, restart_rows=5),
    "4:2:0-like sampling": dict(psv=7, sampling=[(2, 2), (1, 1), (1, 2)]),
    "odd size 4:2:2": dict(psv=2, sampling=[(2, 1), (1, 1), (1, 1)], img="odd"),
    "Adobe RGB": dict(psv=3, segments=[adobe(0)]),
    "CMYK": dict(psv=1, img="cmyk"),
}


def lossless_case(name: str) -> tuple[np.ndarray, bytes]:
    """(the samples, their SOF3 JPEG)."""
    kw = dict(LOSSLESS_CASES[name])
    img = {"grey": photo(48, 64, 30, grey=True), "odd": photo(23, 37, 31),
           "cmyk": cmyk_photo(48, 64, 32)}.get(kw.pop("img", None), photo(48, 64, 33))
    return img, lossless_jpeg(img, **kw)


@pytest.mark.parametrize("case", list(LOSSLESS_CASES))
def test_lossless_jpeg_equals_pil(case):
    """SOF3 at 8 bits: every predictor, the point transform, restart
    intervals, sampled components (box upsampling) and 1, 3 or 4
    components; without a point transform or sampling PIL gives the
    samples back exactly."""
    img, data = lossless_case(case)
    assert_decodes_as_pil(data)
    if "pt" not in LOSSLESS_CASES[case] and "sampling" not in LOSSLESS_CASES[case]:
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(255 - want if img.ndim == 3 and img.shape[2] == 4
                                      else want, img)


def ycck_jpeg(sampling=((1, 1),) * 4, restart: int = 0, h: int = 48, w: int = 64) -> bytes:
    """A baseline YCCK JPEG (Adobe transform 2) of cmyk_photo's colours:
    PIL cannot write one."""
    seg, qt, codes = _pil_tables(90)
    src = cmyk_photo(h, w, 40)
    planes = np.dstack([_rgb_to_ycc(src[..., :3]), src[..., 3]])
    coef = dct_coefficients(planes, sampling, qt, (0, 1, 1, 0))
    parts = [b"\xff\xd8", adobe(2), *seg[0xDB], _frame(0xC0, coef), *seg[0xC4]]
    if restart:
        parts.append(_marker(0xDD, struct.pack(">H", restart)))
    return b"".join(parts + [_sos([0, 1, 2, 3], coef, 0, 63, 0, 0),
                             _huffman_scan(coef, codes, restart), b"\xff\xd9"])


def _without_adobe(data: bytes) -> bytes:
    i = data.index(b"\xff\xee")
    (length,) = struct.unpack_from(">H", data, i + 2)
    return data[:i] + data[i + 2 + length :]


FOUR_COMPONENT_CASES = {
    "Adobe CMYK": lambda: pil_cmyk_jpeg(seed=41, quality=90),
    "Adobe CMYK progressive": lambda: pil_cmyk_jpeg(seed=42, quality=80, progressive=True),
    "no Adobe marker": lambda: _without_adobe(pil_cmyk_jpeg(seed=43, quality=90)),
    "YCCK": lambda: ycck_jpeg(),
    "YCCK 4:2:0 restart": lambda: ycck_jpeg(((2, 2), (1, 1), (1, 1), (2, 2)), restart=2),
}


@pytest.mark.parametrize("case", list(FOUR_COMPONENT_CASES))
def test_four_component_jpeg_equals_pil(case):
    """CMYK and YCCK: PIL's CMYK pixels (inverted, as PIL stores Adobe
    CMYK) and their convert("RGB")."""
    data = FOUR_COMPONENT_CASES[case]()
    assert (b"\xff\xee" in data) == (case != "no Adobe marker")
    assert_decodes_as_pil(data)
    np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))


def test_cmyk_to_rgb_equals_pil():
    """Convert.c's cmyk2rgb on every K against a spread of C, M, Y."""
    g = np.random.default_rng(44)
    cmyk = np.dstack([g.integers(0, 256, (256, 64, 3)),
                      np.repeat(np.arange(256)[:, None], 64, 1)]).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(cmyk_to_rgb(cmyk), want)


REFUSED_KINDS = {
    "12-bit": lambda: _patched(pil_jpeg(photo(16, 16), quality=90), 0xC1, precision=12),
    "SOF5 hierarchical": lambda: _patched(pil_jpeg(photo(16, 16), quality=90), 0xC5),
    "SOF11 arithmetic lossless": lambda: _patched(lossless_jpeg(photo(16, 16), 1), 0xCB),
    "16-bit lossless": lambda: lossless_jpeg(photo(16, 16), 1, precision=16),
    "2-component": lambda: lossless_jpeg(photo(16, 16)[..., :2], 1),
    "lossless YCbCr": lambda: lossless_jpeg(photo(16, 16), 1, segments=[adobe(1)]),
}


@pytest.mark.parametrize("kind", list(REFUSED_KINDS))
def test_refused_jpeg_kinds(kind):
    """What the port still refuses, PIL refuses on the same bytes."""
    data = REFUSED_KINDS[kind]()
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError, match="tex.jpg: .*the JAX package's decoder .PIL. refuses too"):
        read_jpeg(data, "tex.jpg")


@pytest.fixture(scope="module")
def written_fixtures():
    from tools.jpeg_fixtures import fixtures

    return fixtures()


@pytest.mark.parametrize("name", ["baseline", "progressive", "arithmetic",
                                  "arithmetic_progressive", "lossless", "cmyk", "ycck",
                                  "cmyk_no_adobe"])
def test_embedded_jpegs_hash_as_pil(name, written_fixtures):
    """chip_smoke's [images] fixtures (chip_smoke.py needs no PIL): the
    recorded SHA-256 is PIL's decode's, and the port's decode hashes the
    same; the kinds PIL cannot write are tools/jpeg_fixtures.py's output."""
    import base64
    import hashlib

    import chip_smoke

    b64, sha, size = chip_smoke.EMBEDDED_JPEGS[name]
    data = base64.b64decode(b64)
    want = pil_rgb(data)
    assert want.shape[:2] == size
    assert hashlib.sha256(want.tobytes()).hexdigest() == sha
    np.testing.assert_array_equal(read_jpeg(data), want)
    if name not in ("baseline", "progressive"):
        assert written_fixtures[name][1] == data


def png_case(ctype, depth, seed, interlace, filter_type=4):
    """A 13x11 PNG of colour type `ctype` at `depth` bits, with the 16-bit
    values that show PIL's conversions (0x0100, 0x1234, 0x80FF)."""
    r = np.random.default_rng(seed)
    if ctype == 3:
        return encode_png(r.integers(0, 2 ** depth, (11, 13)), depth, interlace=interlace,
                          filter_type=filter_type,
                          palette=r.integers(0, 256, (2 ** depth, 3)))
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    img = r.integers(0, 2 ** depth, (11, 13, c))
    if depth == 16:
        img[0, :3, 0] = (0x0100, 0x1234, 0x80FF)
        img[1, :, 0] = np.arange(13) * 40    # grey levels around 255
    return encode_png(img, depth, ctype=ctype, interlace=interlace, filter_type=filter_type)


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype, depth", PNG_KINDS)
@pytest.mark.parametrize("interlace", [False, True])
def test_png_equals_pil(ctype, depth, interlace):
    """Every colour type and depth, plain and Adam7: 16-bit RGB, RGBA and
    grey + alpha keep the high byte; 16-bit grey clips at 255 (PIL opens it
    as I;16), ROADMAP Queue 3's reference-side findings."""
    data = png_case(ctype, depth, 10 * ctype + depth, interlace)
    assert_decodes_as_pil(data)
    got = timage.read_png(data)
    assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
    if (ctype, depth) == (0, 16):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert want[0, 0, 0] == 255 and want[0, 1, 0] == 255   # 0x0100 -> 255, not 1
    if (ctype, depth) == (2, 16):
        assert timage.read_png(data)[0, 1, 0] == 0x1234


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3])
def test_interlaced_png_filters_equal_pil(filter_type):
    """Every Adam7 pass is unfiltered on its own, from a zero prior row."""
    assert_decodes_as_pil(png_case(6, 16, filter_type, True, filter_type))
    assert_decodes_as_pil(png_case(2, 8, filter_type, True, filter_type))


def test_png_transparency_is_ignored_as_pil_does():
    r = np.random.default_rng(3)
    for data in (encode_png(r.integers(0, 4, (5, 6)), 8, palette=r.integers(0, 256, (4, 3)),
                            trns=bytes([0, 128])),
                 encode_png(r.integers(0, 256, (5, 6, 1)), 8, trns=struct.pack(">H", 7)),
                 encode_png(r.integers(0, 600, (5, 6, 1)), 16, trns=struct.pack(">H", 7))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # PIL warns on palette transparency
            assert_decodes_as_pil(data)


@pytest.mark.parametrize("ctype, depth", PNG_KINDS)
def test_load_hdr_png_equals_imageio(ctype, depth, tmp_path):
    """load_hdr of a .png path: imageio's arrays (1-bit grey as 0 / 1,
    16-bit grey as its raw values, grey + alpha as two channels at 8 bits),
    as float32."""
    path = tmp_path / "env.png"
    path.write_bytes(png_case(ctype, depth, ctype + depth, depth == 8))
    got, want = timage.load_hdr(str(path)), jimage.load_hdr(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".JPG"])
def test_load_hdr_jpeg_equals_imageio(ext, grey, tmp_path):
    path = tmp_path / f"sky{ext}"
    path.write_bytes(pil_jpeg(photo(20, 30, 1, grey=grey), quality=80, progressive=grey))
    got, want = timage.load_hdr(str(path)), jimage.load_hdr(str(path))
    assert got.shape == want.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["arithmetic", "progressive arithmetic", "lossless",
                                  "lossless grey", "Adobe CMYK", "no Adobe marker", "YCCK"])
def test_load_hdr_jpeg_kinds_equal_imageio(case, tmp_path):
    """load_hdr of the arithmetic, lossless and 4-component JPEGs against
    the JAX package's (imageio).  imageio hands back PIL's CMYK pixels, and
    the JAX package keeps their first three channels: C, M and Y as PIL
    stores them, not RGB (ROADMAP Queue 3)."""
    data = {
        "arithmetic": lambda: arithmetic_case("4:2:0")[1],
        "progressive arithmetic": lambda: arithmetic_case("progressive grey")[1],
        "lossless": lambda: lossless_case("predictor 4")[1],
        "lossless grey": lambda: lossless_case("grey")[1],
        **{k: FOUR_COMPONENT_CASES[k] for k in ("Adobe CMYK", "no Adobe marker", "YCCK")},
    }[case]()
    path = tmp_path / "sky.jpg"
    path.write_bytes(data)
    got, want = timage.load_hdr(str(path)), jimage.load_hdr(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case in FOUR_COMPONENT_CASES:
        cmy = np.asarray(Image.open(io.BytesIO(data)))[..., :3]
        np.testing.assert_array_equal(want, cmy.astype(np.float32))
        assert not np.array_equal(cmy, pil_rgb(data))


def test_load_hdr_refuses_other_formats(tmp_path):
    path = tmp_path / "sky.exr"
    path.write_bytes(b"\x76\x2f\x31\x01")
    with pytest.raises(ValueError, match="sky.exr: the port loads .hdr, .png, .jpg"):
        timage.load_hdr(str(path))


@pytest.mark.parametrize("fault", ["truncated", "no Huffman table"])
def test_corrupt_jpeg_raises_value_error(fault):
    data = pil_jpeg(photo(32, 32, 6), quality=90)
    if fault == "truncated":
        data = data[: len(data) // 2]
    else:
        i = data.index(b"\xff\xc4")
        (length,) = struct.unpack_from(">H", data, i + 2)
        data = data[:i] + data[i + 2 + length :]   # drop the first DHT segment
    with pytest.raises(ValueError, match="tex.jpg: "):
        read_jpeg(data, "tex.jpg")
