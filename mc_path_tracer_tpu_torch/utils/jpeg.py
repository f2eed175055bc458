"""JPEG decoding without an imaging package: the textures and environment
maps that the JAX package reads with PIL / imageio.

`read_jpeg` gives what PIL's `Image.open(...).convert("RGB")` gives, which
is libjpeg-turbo at its defaults, bit for bit: Huffman-coded baseline,
extended-sequential and progressive frames (SOF0, SOF1, SOF2) of 8-bit
samples, 1 or 3 components, sampling factors up to 2x2, restart intervals.
To match libjpeg-turbo it reproduces

  - the accurate integer IDCT (jidctint.c, JDCT_ISLOW) with its
    post-IDCT range-limit table, indexed modulo 1024 as there;
  - "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
    their alternating rounding biases (1/2 and 8/7), h1v2 with 1/2, the
    component cropped to its downsampled size and its edge rows and
    columns replicated; box replication where libjpeg-turbo takes it
    (downsampled width of 2 or less, other integer factors);
  - the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits).

Entropy decoding is Python over 16-bit lookup tables (one list index per
Huffman symbol); dequantisation, IDCT, upsampling and colour conversion
are numpy integer arithmetic over all blocks at once.  Arithmetic coding
(SOF9-11), lossless and hierarchical frames, 12-bit samples and 4-component
(CMYK / YCCK) images raise ValueError: ROADMAP Queue 1 lists them.
"""

from __future__ import annotations

import struct

import numpy as np

JPEG_SIGNATURE = b"\xff\xd8"
REFUSED = "not decoded by the port (ROADMAP Queue 1, image formats)"
_SOF_NAMES = {
    0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)", 0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)", 0xCC: "DAC (arithmetic coding)",
    0xDC: "DNL (height defined by a DNL marker)",
}

# ZIGZAG[k] is the natural (row-major) index of the k-th coefficient in
# zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None       # latched at the component's first scan
        self.coef = None         # flat list, 64 zigzag-ordered coefficients per block
        self.bw = self.bh = 0    # blocks per row / column (MCU-padded)
        self.dw = self.dh = 0    # downsampled width / height in samples


def _huffman_lut(counts, symbols) -> list[int]:
    """65,536-entry table: for every 16-bit window, (code length << 8) |
    symbol of the code it starts with; 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data after a SOS header at `pos`, split at restart
    markers and unstuffed (FF 00 -> FF), each padded with zero bytes; and
    the position of the marker that ends it."""
    parts, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            end = len(data)
            break
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            i += 1
            continue
        if 0xD0 <= nxt <= 0xD7:
            parts.append(data[start:i])
            i += 2
            start = i
            continue
        end = i
        break
    parts.append(data[start:end])
    return [p.replace(b"\xff\x00", b"\xff") + bytes(8) for p in parts], end


def _windows(seg: bytes) -> list[int]:
    """For every byte offset, the 32 bits that start there (big-endian)."""
    a = np.frombuffer(seg, np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _decode_scan(parts, frame, scan, restart, name):
    """Entropy-decode one scan into its components' coefficient lists."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    scomps = scan["comps"]
    dc_luts, ac_luts = scan["dc"], scan["ac"]
    progressive = frame["progressive"]
    if len(scomps) == 1:
        c = scomps[0]
        # a non-interleaved scan covers the component's own blocks only
        nx, ny = -(-c.dw // 8), -(-c.dh // 8)
        n_mcu = nx * ny

        def mcu_blocks(m):
            by, bx = divmod(m, nx)
            return ((c, by * c.bw + bx),)
    else:
        mx, my = frame["mcux"], frame["mcuy"]
        n_mcu = mx * my

        def mcu_blocks(m):
            my_, mx_ = divmod(m, mx)
            return tuple((c, (my_ * c.v + y) * c.bw + mx_ * c.h + x)
                         for c in scomps for y in range(c.v) for x in range(c.h))
    per = restart if restart else n_mcu
    intervals = -(-n_mcu // per)
    if len(parts) < intervals:
        raise ValueError(f"{name}: JPEG scan has {len(parts)} restart intervals, "
                         f"expected {intervals}")
    p1, m1 = 1 << al, -1 << al
    first_dc = ss == 0 and ah == 0
    needs_dc, needs_ac = first_dc, se > 0 and (ss > 0 or not progressive)
    for c in scomps:
        if needs_dc and dc_luts[c.id] is None or needs_ac and ac_luts[c.id] is None:
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table")
    for r in range(intervals):
        win = _windows(parts[r])
        limit = 8 * (len(parts[r]) - 8)
        pos = 0
        pred = {c.id: 0 for c in scomps}
        eobrun = 0
        for m in range(r * per, min(n_mcu, (r + 1) * per)):
            for c, blk in mcu_blocks(m):
                coef = c.coef
                base = blk * 64
                if ss == 0:
                    if first_dc or not progressive:
                        e = dc_luts[c.id][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(f"{name}: corrupt JPEG data (bad DC code)")
                        pos += e >> 8
                        s = e & 0xFF
                        v = 0
                        if s:
                            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < 1 << (s - 1):
                                v -= (1 << s) - 1
                        pred[c.id] += v
                        coef[base] = pred[c.id] << al
                    else:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                            coef[base] |= p1
                        pos += 1
                    if progressive:
                        continue
                    k = 1
                    lut = ac_luts[c.id]
                    while k < 64:
                        e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(f"{name}: corrupt JPEG data (bad AC code)")
                        pos += e >> 8
                        s = e & 15
                        if s == 0:
                            if e & 0xF0 == 0xF0:
                                k += 16
                                continue
                            break
                        k += (e >> 4) & 15
                        if k > 63:
                            raise ValueError(f"{name}: corrupt JPEG data (AC index)")
                        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        coef[base + k] = v
                        k += 1
                elif ah == 0:
                    if eobrun:
                        eobrun -= 1
                        continue
                    lut = ac_luts[c.id]
                    k = ss
                    while k <= se:
                        e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(f"{name}: corrupt JPEG data (bad AC code)")
                        pos += e >> 8
                        r_, s = (e >> 4) & 15, e & 15
                        if s:
                            k += r_
                            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < 1 << (s - 1):
                                v -= (1 << s) - 1
                            coef[base + k] = v * p1
                            k += 1
                        elif r_ < 15:
                            eobrun = (1 << r_) - 1
                            if r_:
                                eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r_)) & \
                                    ((1 << r_) - 1)
                                pos += r_
                            break
                        else:
                            k += 16
                else:
                    k = ss
                    if eobrun == 0:
                        lut = ac_luts[c.id]
                        while k <= se:
                            e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError(f"{name}: corrupt JPEG data (bad AC code)")
                            pos += e >> 8
                            r_, s = (e >> 4) & 15, e & 15
                            if s:
                                s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                                pos += 1
                            elif r_ != 15:
                                eobrun = 1 << r_
                                if r_:
                                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r_)) & \
                                        ((1 << r_) - 1)
                                    pos += r_
                                break
                            # advance over nonzero coefficients (each takes a
                            # correction bit) and r_ zero ones
                            while k <= se:
                                i = base + k
                                if coef[i]:
                                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                                            not coef[i] & p1:
                                        coef[i] += p1 if coef[i] >= 0 else m1
                                    pos += 1
                                else:
                                    r_ -= 1
                                    if r_ < 0:
                                        break
                                k += 1
                            if s and k <= se:
                                coef[base + k] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            i = base + k
                            if coef[i]:
                                if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                                        not coef[i] & p1:
                                    coef[i] += p1 if coef[i] >= 0 else m1
                                pos += 1
                            k += 1
                        eobrun -= 1
        if pos > limit:
            raise ValueError(f"{name}: JPEG data ends early")


# --- jidctint.c, JDCT_ISLOW -------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7, left_shift):
    """One pass of jpeg_idct_islow on int64 arrays; returns the 8 outputs
    before descaling."""
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << left_shift
    tmp1 = (x0 - x4) << left_shift
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (x & 1023): x + 128 clamped
    to 0..255 for |x| < 384, wrapping beyond as the C table does."""
    idx = np.arange(1024)
    out = np.where(idx < 128, idx + 128, 255)
    out = np.where((idx >= 384) & (idx < 896), 0, out)
    out = np.where(idx >= 896, idx - 896, out)
    return out.astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Blocks [N, 64] of natural-order coefficients and their natural-order
    quantisation table [64] -> samples uint8 [N, 8, 8]."""
    x = coef.astype(np.int64).reshape(-1, 8, 8) * qtable.astype(np.int64).reshape(8, 8)
    half = 1 << (_CONST_BITS - _PASS1_BITS - 1)
    # pass 1: columns (axis 1 is the vertical frequency)
    cols = _idct_1d(*(x[:, k, :] for k in range(8)), _CONST_BITS)
    ws = np.stack([(c + half) >> (_CONST_BITS - _PASS1_BITS) for c in cols], axis=1)
    # pass 2: rows
    shift = _CONST_BITS + _PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)), _CONST_BITS)
    out = np.stack([(r + (1 << (shift - 1))) >> shift for r in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


# --- jdsample.c ---------------------------------------------------------------

def _fancy_h2(x: np.ndarray, bias_even: int, bias_odd: int, shift: int, weight: int):
    """Horizontal triangle filter on int arrays [H, W] -> [H, 2W]:
    out[2j] = (weight*x[j] + x[j-1] + bias_even) >> shift and
    out[2j+1] = (weight*x[j] + x[j+1] + bias_odd) >> shift, edges
    replicated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (weight * x + left + bias_even) >> shift
    out[:, 1::2] = (weight * x + right + bias_odd) >> shift
    return out


def _colsums_v2(x: np.ndarray):
    """h2v2 / h1v2 vertical step: for output rows 2i and 2i+1, 3 * x[i] plus
    the row above / below (edges replicated): [2H, W]."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = 3 * x + up
    out[1::2] = 3 * x + down
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane [dh, dw] (uint8) upsampled by (fh, fv) as
    libjpeg-turbo does with fancy upsampling on."""
    x = plane.astype(np.int64)
    dw = x.shape[1]
    if (fh, fv) == (1, 1):
        return x
    if (fh, fv) == (2, 1) and dw > 2:
        return _fancy_h2(x, 1, 2, 2, 3)
    if (fh, fv) == (1, 2):
        sums = _colsums_v2(x)
        bias = np.tile(np.array([1, 2], np.int64), x.shape[0])[:, None]
        return (sums + bias) >> 2
    if (fh, fv) == (2, 2) and dw > 2:
        return _fancy_h2(_colsums_v2(x), 8, 7, 4, 3)
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


# --- jdcolor.c ----------------------------------------------------------------

def _ycc_tables():
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on sample arrays (ints 0..255)."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# --- markers ------------------------------------------------------------------

def read_jpeg(data: bytes, name: str = "image") -> np.ndarray:
    """Decode a JPEG to uint8 [H, W, 3] (grey replicated), as PIL's
    Image.open(...).convert("RGB") does (module docstring)."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: not a JPEG image")
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, list] = {}
    ac_tables: dict[int, list] = {}
    frame = None
    comps: list[_Component] = []
    restart = 0
    adobe_transform, jfif = None, False
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0x00 or 0xD0 <= marker <= 0xD7:
            pos += 1
            continue
        if marker == 0xD9:   # EOI
            break
        if pos + 4 > len(data):
            raise ValueError(f"{name}: JPEG data ends early")
        (length,) = struct.unpack_from(">H", data, pos + 2)
        if pos + 2 + length > len(data):
            raise ValueError(f"{name}: JPEG data ends early")
        body = data[pos + 4 : pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_NAMES:
            raise ValueError(f"{name}: JPEG {_SOF_NAMES[marker]} {REFUSED}")
        if marker == 0xDB:   # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1 : i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table
                i += 1 + n
        elif marker == 0xC4:   # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1 : i + 17]
                total = sum(counts)
                if len(counts) < 16 or i + 17 + total > len(body):
                    raise ValueError(f"{name}: malformed JPEG Huffman table")
                lut = _huffman_lut(counts, body[i + 17 : i + 17 + total])
                (ac_tables if tc else dc_tables)[th] = lut
                i += 17 + total
        elif marker in (0xC0, 0xC1, 0xC2):   # SOF0, SOF1, SOF2
            precision, height, width, nc = struct.unpack_from(">BHHB", body, 0)
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG {REFUSED}")
            if nc not in (1, 3):
                kind = "CMYK / YCCK" if nc == 4 else f"{nc}-component"
                raise ValueError(f"{name}: {kind} JPEG {REFUSED}")
            if height == 0:
                raise ValueError(f"{name}: JPEG {_SOF_NAMES[0xDC]} {REFUSED}")
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                                body[8 + 3 * k]) for k in range(nc)]
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError(f"{name}: bad JPEG sampling factors")
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.coef = [0] * (c.bw * c.bh * 64)
            frame = dict(width=width, height=height, hmax=hmax, vmax=vmax, mcux=mcux,
                         mcuy=mcuy, progressive=marker == 0xC2)
        elif marker == 0xDD:   # DRI
            (restart,) = struct.unpack_from(">H", body, 0)
        elif marker == 0xE0 and body.startswith(b"JFIF\0"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:   # SOS
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            ns = body[0]
            by_id = {c.id: c for c in comps}
            scan = dict(comps=[], dc={}, ac={}, ss=body[1 + 2 * ns], se=body[2 + 2 * ns],
                        ah=body[3 + 2 * ns] >> 4, al=body[3 + 2 * ns] & 15)
            for k in range(ns):
                c = by_id.get(body[1 + 2 * k])
                if c is None or c.tq not in qtables:
                    raise ValueError(f"{name}: JPEG scan names an unknown component or a "
                                     "missing quantisation table")
                sel = body[2 + 2 * k]
                scan["dc"][c.id] = dc_tables.get(sel >> 4)
                scan["ac"][c.id] = ac_tables.get(sel & 15)
                if c.qtable is None:
                    c.qtable = qtables[c.tq]
                scan["comps"].append(c)
            parts, pos = _segments(data, pos)
            _decode_scan(parts, frame, scan, restart, name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    planes = []
    for c in comps:
        if c.qtable is None:
            raise ValueError(f"{name}: JPEG component {c.id} has no scan")
        zz = np.asarray(c.coef, np.int64).reshape(-1, 64)
        natural = np.zeros_like(zz)
        natural[:, ZIGZAG] = zz
        blocks = idct_islow(natural, c.qtable)
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            c.bh * 8, c.bw * 8)[: c.dh, : c.dw]
        fh, fv = frame["hmax"] // c.h, frame["vmax"] // c.v
        if frame["hmax"] % c.h or frame["vmax"] % c.v:
            raise ValueError(f"{name}: JPEG sampling factors {REFUSED}")
        planes.append(_upsample(plane, fh, fv)[: frame["height"], : frame["width"]])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    # libjpeg's colour-space guess: JFIF means YCbCr, else Adobe's transform
    # flag, else component ids 'R', 'G', 'B' mean RGB
    ids = tuple(c.id for c in comps)
    rgb = adobe_transform == 0 if adobe_transform is not None else ids == (82, 71, 66)
    if rgb and not jfif:
        return np.stack(planes, axis=-1).astype(np.uint8)   # stored as RGB
    return ycc_to_rgb(*planes)
