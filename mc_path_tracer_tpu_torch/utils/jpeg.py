"""JPEG decoding without an imaging package: the textures and environment
maps that the JAX package reads with PIL / imageio.

`decode_jpeg` gives the pixels of PIL's `Image.open(...)`, which imageio
returns as they are: [H, W] grey, [H, W, 3] RGB, or [H, W, 4] CMYK in
PIL's inverted (Adobe) convention.  `read_jpeg` gives PIL's
`.convert("RGB")` of them.  Both are libjpeg-turbo at its defaults, as
PIL bundles it, bit for bit, for

  - Huffman-coded baseline, extended-sequential and progressive frames
    (SOF0, SOF1, SOF2);
  - arithmetic-coded sequential and progressive frames (SOF9, SOF10):
    T.81 Annex D's QM-coder (jdarith.c) with DAC conditioning, its
    statistics reset at every restart marker;
  - Huffman-coded lossless frames (SOF3): predictors 1-7 and the point
    transform (T.81 Annex H, jdlhuff.c / jdpred.c);
  - 8-bit samples, 1, 3 or 4 components, sampling factors up to 4x4,
    restart intervals.

To match libjpeg-turbo it reproduces

  - the accurate integer IDCT (jidctint.c, JDCT_ISLOW) with its
    post-IDCT range-limit table, indexed modulo 1024 as there;
  - "fancy" upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
    their alternating rounding biases (1/2 and 8/7), h1v2 with 1/2, the
    component cropped to its downsampled size and its edge rows and
    columns replicated; box replication where libjpeg-turbo takes it
    (downsampled width of 2 or less, other integer factors, and every
    lossless frame, whose one-sample "blocks" turn fancy upsampling off);
  - the fixed-point YCbCr -> RGB tables of jdcolor.c; four components are
    CMYK (Adobe transform 0, or no Adobe marker) or YCCK (any other
    transform), YCCK -> CMYK as jdcolor.c's ycck_cmyk_convert; PIL then
    inverts CMYK (its "CMYK;I" raw mode) and converts it to RGB as
    Convert.c's cmyk2rgb does.

Entropy decoding is Python over 16-bit lookup tables (one list index per
Huffman symbol) or one call per binary decision of the QM-coder;
dequantisation, IDCT, upsampling and colour conversion are numpy integer
arithmetic over all blocks at once.  What the JAX package's decoder refuses
raises ValueError here too: samples other than 8 bits (12-bit DCT, 16-bit
lossless), hierarchical frames (SOF5-7, SOF13-15), arithmetic lossless
frames (SOF11), 2-component images and a height left to a DNL marker.
"""

from __future__ import annotations

import struct

import numpy as np

JPEG_SIGNATURE = b"\xff\xd8"
REFUSED = "which the JAX package's decoder (PIL) refuses too"
# start-of-frame markers the port decodes: (entropy coding, progressive)
_FRAMES = {
    0xC0: ("huffman", False), 0xC1: ("huffman", False), 0xC2: ("huffman", True),
    0xC3: ("lossless", False), 0xC9: ("arithmetic", False), 0xCA: ("arithmetic", True),
}
_REFUSED_FRAMES = {
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (arithmetic differential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
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
        # per block: 64 zigzag-ordered coefficients (one sample difference
        # in a lossless frame), as one flat list
        self.coef = None
        self.samples = None      # a lossless component's samples [dh, dw]
        self.scanned = False
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


def _mcu_layout(frame, scomps):
    """A scan's MCUs: (count, MCUs per row, MCU index -> its (component,
    block index) pairs).  A block is 8x8 coefficients, or one sample in a
    lossless frame."""
    if len(scomps) == 1:
        c = scomps[0]
        # a non-interleaved scan covers the component's own blocks only
        nx, ny = -(-c.dw // frame["block"]), -(-c.dh // frame["block"])

        def one(m):
            by, bx = divmod(m, nx)
            return ((c, by * c.bw + bx),)
        return nx * ny, nx, one
    mx, my = frame["mcux"], frame["mcuy"]

    def interleaved(m):
        my_, mx_ = divmod(m, mx)
        return tuple((c, (my_ * c.v + y) * c.bw + mx_ * c.h + x)
                     for c in scomps for y in range(c.v) for x in range(c.h))
    return mx * my, mx, interleaved


def _intervals(parts, n_mcu, restart, name) -> tuple[int, int]:
    """(MCUs per restart interval, intervals) of a scan, after checking
    that its data holds them all."""
    per = restart if restart else n_mcu
    intervals = -(-n_mcu // per)
    if len(parts) < intervals:
        raise ValueError(f"{name}: JPEG scan has {len(parts)} restart intervals, "
                         f"expected {intervals}")
    return per, intervals


def _decode_scan(parts, frame, scan, restart, name):
    """Entropy-decode one Huffman-coded DCT scan into its components'
    coefficient lists."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    scomps = scan["comps"]
    progressive = frame["progressive"]
    n_mcu, _, mcu_blocks = _mcu_layout(frame, scomps)
    per, intervals = _intervals(parts, n_mcu, restart, name)
    p1, m1 = 1 << al, -1 << al
    first_dc = ss == 0 and ah == 0
    needs_dc, needs_ac = first_dc, se > 0 and (ss > 0 or not progressive)
    dc_luts = {c.id: scan["dc_tables"].get(scan["td"][c.id]) for c in scomps}
    ac_luts = {c.id: scan["ac_tables"].get(scan["ta"][c.id]) for c in scomps}
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


# --- T.81 Annex D: the QM-coder (jdarith.c) -----------------------------------

# Table D.2: (Qe, next state after an LPS, next state after an MPS, swap
# the MPS after an LPS); state 113 is the fixed probability-0.5 bin
QM_STATES = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
# jdarith.c's packing: (Qe, next after an LPS | swap << 7, next after an MPS)
_QM = tuple((qe, (switch << 7) | lps, mps) for qe, lps, mps, switch in QM_STATES)
QM_FIXED = 113
DC_BINS, AC_BINS = 64, 256
# conditioning without a DAC marker (reset at SOI): DC bounds L = 0,
# U = 1; AC threshold K = 5
DEFAULT_DC_L, DEFAULT_DC_U, DEFAULT_AC_K = 0, 1, 5


def _qm_decoder(seg: bytes):
    """The QM-decoder over one restart interval's unstuffed bytes (zero
    bytes past the end, as libjpeg supplies after a marker): decode(bins,
    k) -> the next binary decision with the statistics bin bins[k] (a
    state index | MPS << 7), which it updates (arith_decode)."""
    n = len(seg)
    reg = [0, 0, -16, 0]    # C, A, CT (-16: read two bytes first), input position

    def decode(bins, k):
        c, a, ct, pos = reg
        while a < 0x8000:   # renormalise (D.2.6)
            ct -= 1
            if ct < 0:
                c = (c << 8) | (seg[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:   # the two initial bytes are in
                        a = 0x8000
            a <<= 1
        sv = bins[k]
        qe, nl, nm = _QM[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:          # conditional exchange: the MPS
                bins[k] = (sv & 0x80) ^ nm
            else:               # the LPS
                bins[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:          # conditional exchange: the LPS
                bins[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                bins[k] = (sv & 0x80) ^ nm
        reg[0], reg[1], reg[2], reg[3] = c, a, ct, pos
        return sv >> 7

    return decode


def _decode_arith_scan(parts, frame, scan, restart, cond, name):
    """Entropy-decode one arithmetic-coded DCT scan (jdarith.c's
    decode_mcu, decode_mcu_DC_first / _AC_first / _DC_refine / _AC_refine)
    into its components' coefficient lists; `cond` holds the DAC
    conditioning (dc_l, dc_u, ac_k per table)."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    scomps = scan["comps"]
    progressive = frame["progressive"]
    n_mcu, _, mcu_blocks = _mcu_layout(frame, scomps)
    per, intervals = _intervals(parts, n_mcu, restart, name)
    dc_l, dc_u, ac_k = cond
    p1, m1 = 1 << al, -1 << al
    codes_dc = ss == 0 and (not progressive or ah == 0)
    codes_ac = not progressive or ss > 0
    td, ta = scan["td"], scan["ta"]

    def corrupt(what):
        return ValueError(f"{name}: corrupt JPEG data (arithmetic {what})")

    for r in range(intervals):
        dec = _qm_decoder(parts[r])
        # every restart interval starts from fresh statistics
        dc_stats = {td[c.id]: bytearray(DC_BINS) for c in scomps} if codes_dc else {}
        ac_stats = {ta[c.id]: bytearray(AC_BINS) for c in scomps} if codes_ac else {}
        fixed = bytearray([QM_FIXED])
        last_dc = {c.id: 0 for c in scomps}
        dc_ctx = {c.id: 0 for c in scomps}
        for mcu in range(r * per, min(n_mcu, (r + 1) * per)):
            for c, blk in mcu_blocks(mcu):
                coef = c.coef
                base = blk * 64
                if ss == 0:
                    if codes_dc:
                        t = td[c.id]
                        st = dc_stats[t]
                        s = dc_ctx[c.id]
                        if dec(st, s) == 0:            # Decode_DC_DIFF: zero
                            dc_ctx[c.id] = 0
                        else:
                            sign = dec(st, s + 1)
                            s += 2 + sign
                            m = dec(st, s)
                            if m:
                                s = 20                 # X1
                                while dec(st, s):
                                    m <<= 1
                                    if m == 0x8000:
                                        raise corrupt("DC magnitude")
                                    s += 1
                            # conditioning category of the next difference
                            if m < (1 << dc_l[t]) >> 1:
                                dc_ctx[c.id] = 0
                            elif m > (1 << dc_u[t]) >> 1:
                                dc_ctx[c.id] = 12 + sign * 4
                            else:
                                dc_ctx[c.id] = 4 + sign * 4
                            v = m
                            s += 14
                            m >>= 1
                            while m:
                                if dec(st, s):
                                    v |= m
                                m >>= 1
                            v += 1
                            last_dc[c.id] += -v if sign else v
                        if progressive:
                            coef[base] = last_dc[c.id] << al
                        else:
                            last_dc[c.id] &= 0xFFFF
                            d = last_dc[c.id]
                            coef[base] = d - 0x10000 if d >= 0x8000 else d
                    elif dec(fixed, 0):                # DC refinement bit
                        coef[base] |= p1
                    if progressive:
                        continue
                    k, end = 1, 63
                else:
                    k, end = ss, se
                st = ac_stats.get(ta[c.id])
                if ah == 0 or not progressive:         # AC coefficients
                    t = ta[c.id]
                    while k <= end:
                        s = 3 * (k - 1)
                        if dec(st, s):                 # end of block
                            break
                        while dec(st, s + 1) == 0:
                            s += 3
                            k += 1
                            if k > end:
                                raise corrupt("spectral overflow")
                        sign = dec(fixed, 0)
                        s += 2
                        m = dec(st, s)
                        if m and dec(st, s):
                            m <<= 1
                            s = 189 if k <= ac_k[t] else 217
                            while dec(st, s):
                                m <<= 1
                                if m == 0x8000:
                                    raise corrupt("AC magnitude")
                                s += 1
                        v = m
                        s += 14
                        m >>= 1
                        while m:
                            if dec(st, s):
                                v |= m
                            m >>= 1
                        v += 1
                        coef[base + k] = (-v if sign else v) << al
                        k += 1
                else:                                  # AC refinement
                    kex = end
                    while kex > 0 and not coef[base + kex]:
                        kex -= 1
                    while k <= end:
                        s = 3 * (k - 1)
                        if k > kex and dec(st, s):     # end of block
                            break
                        while True:
                            i = base + k
                            if coef[i]:                # a correction bit
                                if dec(st, s + 2):
                                    coef[i] += m1 if coef[i] < 0 else p1
                                break
                            if dec(st, s + 1):         # newly nonzero
                                coef[i] = m1 if dec(fixed, 0) else p1
                                break
                            s += 3
                            k += 1
                            if k > end:
                                raise corrupt("spectral overflow")
                        k += 1


# --- T.81 Annex H: lossless frames (jdlhuff.c, jdpred.c) ----------------------

def _undifference(diff: np.ndarray, psv: int, pt: int, interval_rows: int) -> np.ndarray:
    """Sample differences [h, w] -> samples, mod 2^16 as jdpred.c: the
    first row of the scan and of each restart interval predicts from the
    left (its first sample from 2^(7 - Pt)), the first column of the other
    rows from above, the rest with predictor `psv` (Ra left, Rb above, Rc
    above-left)."""
    h, w = diff.shape
    out = np.zeros((h, w), np.int64)
    d = diff.astype(np.int64)
    for y in range(h):
        if y % interval_rows == 0:
            out[y] = (np.cumsum(d[y]) + (1 << (7 - pt))) & 0xFFFF
            continue
        rb = out[y - 1]
        row = out[y]
        if psv == 2:
            row[:] = (d[y] + rb) & 0xFFFF
        elif psv == 3:
            row[0] = (d[y, 0] + rb[0]) & 0xFFFF
            row[1:] = (d[y, 1:] + rb[:-1]) & 0xFFFF
        else:
            ra = (int(d[y, 0]) + int(rb[0])) & 0xFFFF
            row[0] = ra
            dy, rbl = d[y].tolist(), rb.tolist()
            for x in range(1, w):
                b, c = rbl[x], rbl[x - 1]
                if psv == 1:
                    p = ra
                elif psv == 4:
                    p = ra + b - c
                elif psv == 5:
                    p = ra + ((b - c) >> 1)
                elif psv == 6:
                    p = b + ((ra - c) >> 1)
                else:
                    p = (ra + b) >> 1
                ra = (dy[x] + p) & 0xFFFF
                row[x] = ra
    return out


def _decode_lossless_scan(parts, frame, scan, restart, name):
    """Entropy-decode one Huffman-coded lossless scan (one difference per
    sample, DC-style codes; category 16 is 32768 with no extra bits), then
    undifference its components into their samples."""
    psv, pt = scan["ss"], scan["al"]
    if not 1 <= psv <= 7:
        raise ValueError(f"{name}: lossless JPEG predictor {psv} (1-7 outside "
                         "hierarchical frames)")
    if pt > 7:
        raise ValueError(f"{name}: lossless JPEG point transform {pt} of 8-bit samples")
    scomps = scan["comps"]
    n_mcu, per_row, mcu_blocks = _mcu_layout(frame, scomps)
    per, intervals = _intervals(parts, n_mcu, restart, name)
    if restart and restart % per_row:
        raise ValueError(f"{name}: lossless JPEG restart interval of {restart} MCUs is not "
                         f"a whole number of MCU rows ({per_row} MCUs)")
    luts = {c.id: scan["dc_tables"].get(scan["td"][c.id]) for c in scomps}
    if any(lut is None for lut in luts.values()):
        raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table")
    for r in range(intervals):
        win = _windows(parts[r])
        limit = 8 * (len(parts[r]) - 8)
        pos = 0
        for m in range(r * per, min(n_mcu, (r + 1) * per)):
            for c, blk in mcu_blocks(m):
                e = luts[c.id][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{name}: corrupt JPEG data (bad lossless code)")
                pos += e >> 8
                s = e & 0xFF
                v = 0
                if s == 16:
                    v = 32768
                elif s:
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                c.coef[blk] = v
        if pos > limit:
            raise ValueError(f"{name}: JPEG data ends early")
    for c in scomps:
        rows = (per // per_row) * (c.v if len(scomps) > 1 else 1) if restart else c.dh
        diff = np.asarray(c.coef, np.int64).reshape(c.bh, c.bw)[: c.dh, : c.dw]
        c.samples = ((_undifference(diff, psv, pt, rows) << pt) & 0xFF).astype(np.uint8)


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


def _upsample(plane: np.ndarray, fh: int, fv: int, fancy: bool) -> np.ndarray:
    """A component plane [dh, dw] (uint8) upsampled by (fh, fv) as
    libjpeg-turbo does with fancy upsampling on: a DCT frame's filters when
    `fancy`, box replication for a lossless frame's one-sample blocks."""
    x = plane.astype(np.int64)
    dw = x.shape[1]
    if (fh, fv) == (1, 1) or not fancy:
        return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
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


def ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - (the RGB of Y, Cb,
    Cr), K unchanged."""
    return np.concatenate([255 - ycc_to_rgb(y, cb, cr), np.asarray(k, np.uint8)[..., None]],
                          axis=-1)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of a CMYK image (Convert.c's cmyk2rgb):
    (255 - K) - round(C (255 - K) / 255) per channel."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:4]
    tmp = x[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


# --- markers ------------------------------------------------------------------

def decode_jpeg(data: bytes, name: str = "image") -> np.ndarray:
    """Decode a JPEG to the pixels of PIL's Image.open (uint8): [H, W] grey,
    [H, W, 3] RGB, or [H, W, 4] CMYK as PIL keeps it, inverted; imageio
    returns these arrays as they are (module docstring)."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: not a JPEG image")
    qtables: dict[int, np.ndarray] = {}
    dc_tables: dict[int, list] = {}
    ac_tables: dict[int, list] = {}
    # arithmetic conditioning per table: DC bounds L and U, AC threshold K
    cond = ([DEFAULT_DC_L] * 16, [DEFAULT_DC_U] * 16, [DEFAULT_AC_K] * 16)
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
        if marker in _REFUSED_FRAMES:
            raise ValueError(f"{name}: JPEG {_REFUSED_FRAMES[marker]} frame, {REFUSED}")
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
        elif marker == 0xCC:   # DAC
            for i in range(0, len(body) - 1, 2):
                tc, tb, val = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc:
                    cond[2][tb] = val
                elif (val & 15) > (val >> 4):
                    raise ValueError(f"{name}: bad JPEG DAC conditioning {val:#04x}")
                else:
                    cond[0][tb], cond[1][tb] = val & 15, val >> 4
        elif marker in _FRAMES:
            coding, progressive = _FRAMES[marker]
            precision, height, width, nc = struct.unpack_from(">BHHB", body, 0)
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG samples, {REFUSED}")
            if nc not in (1, 3, 4):
                raise ValueError(f"{name}: {nc}-component JPEG, {REFUSED}")
            if height == 0:
                raise ValueError(f"{name}: JPEG height defined by a DNL marker, {REFUSED}")
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                                body[8 + 3 * k]) for k in range(nc)]
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            block = 1 if coding == "lossless" else 8
            mcux, mcuy = -(-width // (block * hmax)), -(-height // (block * vmax))
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError(f"{name}: bad JPEG sampling factors")
                if hmax % c.h or vmax % c.v:
                    raise ValueError(f"{name}: JPEG sampling factors {c.h}x{c.v} do not divide "
                                     f"{hmax}x{vmax}")
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.coef = [0] * (c.bw * c.bh * block * block)
            frame = dict(width=width, height=height, hmax=hmax, vmax=vmax, mcux=mcux,
                         mcuy=mcuy, progressive=progressive, coding=coding, block=block)
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
            scan = dict(comps=[], td={}, ta={}, dc_tables=dc_tables, ac_tables=ac_tables,
                        ss=body[1 + 2 * ns], se=body[2 + 2 * ns],
                        ah=body[3 + 2 * ns] >> 4, al=body[3 + 2 * ns] & 15)
            for k in range(ns):
                c = by_id.get(body[1 + 2 * k])
                lossless = frame["coding"] == "lossless"
                if c is None or not lossless and c.tq not in qtables:
                    raise ValueError(f"{name}: JPEG scan names an unknown component or a "
                                     "missing quantisation table")
                scan["td"][c.id], scan["ta"][c.id] = body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15
                if c.qtable is None and not lossless:
                    c.qtable = qtables[c.tq]
                c.scanned = True
                scan["comps"].append(c)
            parts, pos = _segments(data, pos)
            if frame["coding"] == "huffman":
                _decode_scan(parts, frame, scan, restart, name)
            elif frame["coding"] == "arithmetic":
                _decode_arith_scan(parts, frame, scan, restart, cond, name)
            else:
                _decode_lossless_scan(parts, frame, scan, restart, name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    planes = []
    for c in comps:
        if not c.scanned:
            raise ValueError(f"{name}: JPEG component {c.id} has no scan")
        if frame["coding"] == "lossless":
            plane = c.samples
        else:
            zz = np.asarray(c.coef, np.int64).reshape(-1, 64)
            natural = np.zeros_like(zz)
            natural[:, ZIGZAG] = zz
            blocks = idct_islow(natural, c.qtable)
            plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
                c.bh * 8, c.bw * 8)[: c.dh, : c.dw]
        fh, fv = frame["hmax"] // c.h, frame["vmax"] // c.v
        planes.append(_upsample(plane, fh, fv, frame["coding"] != "lossless")[
            : frame["height"], : frame["width"]])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    # libjpeg's colour-space guess.  Four components: Adobe transform 0 or
    # no Adobe marker means CMYK, any other transform YCCK.  Three: JFIF
    # means YCbCr, else Adobe's transform flag, else component ids 'R', 'G',
    # 'B' mean RGB, else YCbCr for a DCT frame and RGB for a lossless one
    lossless = frame["coding"] == "lossless"
    if len(planes) == 4:
        ycc = adobe_transform is not None and adobe_transform != 0
    elif jfif:
        ycc = True
    elif adobe_transform is not None:
        ycc = adobe_transform != 0
    else:
        ycc = tuple(c.id for c in comps) != (82, 71, 66) and not lossless
    if ycc and lossless:
        raise ValueError(f"{name}: lossless JPEG stored as {'YCCK' if len(planes) == 4 else 'YCbCr'}"
                         f": its conversion is lossy, {REFUSED}")
    if len(planes) == 4:
        # PIL keeps CMYK inverted (its "CMYK;I" raw mode)
        cmyk = ycck_to_cmyk(*planes) if ycc else np.stack(planes, axis=-1).astype(np.uint8)
        return 255 - cmyk
    if ycc:
        return ycc_to_rgb(*planes)
    return np.stack(planes, axis=-1).astype(np.uint8)   # stored as RGB


def read_jpeg(data: bytes, name: str = "image") -> np.ndarray:
    """Decode a JPEG to uint8 [H, W, 3], as PIL's
    Image.open(...).convert("RGB") does: grey replicated, CMYK through
    cmyk_to_rgb."""
    img = decode_jpeg(data, name)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return cmyk_to_rgb(img) if img.shape[-1] == 4 else img
