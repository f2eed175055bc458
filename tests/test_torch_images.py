"""The port's image decoders against PIL and imageio, as the JAX package
uses them: `utils.gltf._decode_image` (read_jpeg / read_png, then
_to_rgb) must equal the JAX package's `_decode_image` (PIL's
convert("RGB")) exactly, and `utils.image.load_hdr` of .png / .jpg paths
the JAX package's load_hdr (imageio) exactly.

JPEGs come from PIL (qualities 50, 90, 100; 4:4:4, 4:2:2, 4:2:0; grey;
progressive; restart markers; sizes that are not multiples of the MCU) and
from `encode_jpeg` below for the sampling PIL cannot write (4:4:0 and mixed
chroma factors), using the tables of a JPEG PIL wrote.  PNGs come from
`encode_png` below (PIL writes neither interlaced nor 16-bit colour PNGs):
Adam7-interlaced in every colour type and 16-bit in every colour type
that allows it (PIL's high-byte and I;16-clip conversions).  The JPEG
kinds the port refuses raise ValueError naming ROADMAP Queue 1."""

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
from mc_path_tracer_tpu_torch.utils.jpeg import read_jpeg


# --- encoders: their output is decoded by PIL / imageio as the reference ---

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


def encode_jpeg(rgb: np.ndarray, sampling=((1, 2), (1, 1), (1, 1)), quality: int = 90,
                restart: int = 0) -> bytes:
    """Baseline YCbCr JPEG of uint8 [H, W, 3] with per-component sampling
    factors (h, v), restart interval `restart` MCUs (0: none)."""
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
    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
                    128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]], -1)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    full = np.pad(ycc, ((0, my * 8 * vmax - h), (0, mx * 8 * hmax - w), (0, 0)), mode="edge")
    d = _dct_matrix()
    blocks = []
    for ci, (hs, vs) in enumerate(sampling):
        fh, fv = hmax // hs, vmax // vs
        plane = full[..., ci].reshape(full.shape[0] // fv, fv, full.shape[1] // fh, fh)
        plane = plane.mean(axis=(1, 3)) - 128.0
        b = plane.reshape(my * vs, 8, mx * hs, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("uk,abkl,vl->abuv", d, b, d)
        q = np.round(coef / qt[0 if ci == 0 else 1]).astype(np.int64)
        blocks.append(q.reshape(my * vs, mx * hs, 64)[..., _ZIGZAG])
    bits, pred, count = _Bits(), [0, 0, 0], 0
    for m in range(mx * my):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + count % 8])
            count += 1
            pred = [0, 0, 0]
        by, bx = divmod(m, mx)
        for ci, (hs, vs) in enumerate(sampling):
            dc_t, ac_t = codes[0x00 | (ci > 0)], codes[0x10 | (ci > 0)]
            for yy in range(vs):
                for xx in range(hs):
                    blk = blocks[ci][by * vs + yy, bx * hs + xx]
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
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([ci + 1, (hs << 4) | vs, 0 if ci == 0 else 1])
        for ci, (hs, vs) in enumerate(sampling))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    parts = [b"\xff\xd8", *seg[0xE0], *seg[0xDB],
             b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof, *seg[0xC4]]
    if restart:
        parts.append(b"\xff\xdd" + struct.pack(">HH", 4, restart))
    parts += [b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos, bytes(bits.out),
              b"\xff\xd9"]
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
    """`data` with its SOF0 marker replaced (and its sample precision)."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind, match", [
    ("SOF9", "SOF9 .arithmetic"), ("SOF10", "SOF10 .arithmetic"), ("SOF3", "SOF3 .lossless"),
    ("12-bit", "12-bit JPEG"), ("CMYK", "CMYK / YCCK JPEG"),
])
def test_refused_jpeg_kinds(kind, match):
    base = pil_jpeg(photo(16, 16), quality=90)
    if kind == "CMYK":
        buf = io.BytesIO()
        Image.fromarray(np.full((8, 8, 4), 100, np.uint8), "CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif kind == "12-bit":
        data = _patched(base, 0xC1, precision=12)
    else:
        data = _patched(base, {"SOF9": 0xC9, "SOF10": 0xCA, "SOF3": 0xC3}[kind])
    with pytest.raises(ValueError, match=f"{match}.*ROADMAP Queue 1"):
        read_jpeg(data, "tex.jpg")


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
