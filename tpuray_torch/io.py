"""Image I/O + golden-image comparison.

Port of :mod:`tpuray.io`.  ``write_png``/``read_png`` are the analog of
png_dump (cpu_ray.c:108-165) and the wrapper's PNG loader
(opencl_wrap.c:241-320).  The codec is numpy + the standard library's
``zlib``, so that the port needs neither Pillow nor libpng.  It reads 8-bit greyscale, grey+alpha, RGB and RGBA PNGs,
non-interlaced, with all five row filters, and returns RGB (alpha dropped,
grey replicated, as Pillow's ``convert("RGB")``).  It writes 8-bit RGB.
Anything else (palette, 16-bit, Adam7) raises.

``write_png`` goes through the native libpng codec (``native_lib``, built
with g++ at first use) where it loads, and through numpy + zlib otherwise,
as the JAX package falls back from libpng to Pillow.

``encode_jpeg`` is a baseline JPEG encoder for the viewer's MJPEG stream
(the JAX viewer takes Pillow's): JFIF, YCbCr 4:2:0, the Annex K tables.

``image_diff_stats`` quantifies closeness to the reference's committed
render ``out/scene.png`` (SURVEY.md section 4).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from .config import REFERENCE_DIR

GOLDEN_PNG = os.path.join(REFERENCE_DIR, "out", "scene.png")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit images
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    while off + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters.  ``filt`` is [H, W, bpp] u8.

    Rows filtered with None/Sub/Up are undone a row at a time.  Average
    and Paeth depend on the reconstructed left, upper and upper-left
    bytes, so when any row uses them the image is reconstructed along
    anti-diagonals instead: every pixel of one diagonal depends only on
    earlier diagonals, which vectorises the H*W recurrences into H+W-1
    steps whatever mix of filters the rows use.
    """
    h, w, bpp = filt.shape
    if types.size and types.max() > 4:
        raise ValueError(f"unknown PNG row filter {int(types.max())}")
    out = np.zeros((h, w, bpp), np.uint8)
    if not np.isin(types, (3, 4)).any():
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            t = types[r]
            if t == 0:
                out[r] = filt[r]
            elif t == 1:
                out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            else:
                out[r] = filt[r] + prev
            prev = out[r]
        return out
    # padded reconstruction: row 0 and column 0 are the zero border
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)
    f16 = filt.astype(np.int16)
    t_all = types.astype(np.int16)[:, None]
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        x = k - r
        a = rec[r + 1, x]          # left
        b = rec[r, x + 1]          # up
        c = rec[r, x]              # upper-left
        t = t_all[r]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        rec[r + 1, x + 1] = (f16[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] u8 with the file's own channel count."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype} (8-bit grey/RGB(A) only)")
    if comp != 0 or filt_method != 0 or interlace != 0:
        raise ValueError("unsupported PNG: interlaced or non-standard "
                         "compression/filter method")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as RGB u8 [H, W, 3]."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] <= 2:                     # grey (+ alpha)
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _rgb_u8(img_u8, what: str) -> np.ndarray:
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} takes RGB u8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    return img


def encode_png(img_u8: np.ndarray) -> bytes:
    """RGB u8 [H, W, 3] -> PNG bytes (8-bit RGB, filter None)."""
    img = _rgb_u8(img_u8, "write_png")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write RGB u8 [H, W, 3] as a PNG: through the native library where it
    loads (``native_lib.available()`` says why where it does not), else
    through :func:`encode_png`."""
    from . import native_lib
    img = _rgb_u8(img_u8, "write_png")
    if native_lib.available():
        native_lib.write_png(path, img)
        return
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# baseline JPEG (ITU T.81): JFIF, YCbCr 4:2:0, Annex K tables
# ---------------------------------------------------------------------------

# Annex K.1 quantisation tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: (codes of each length 1..16, symbols)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
              tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# zigzag position k -> natural index
_ZIGZAG = np.array([r * 8 + c for r, c in sorted(
    ((r, c) for r in range(8) for c in range(8)),
    key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else -p[0]))])

# orthonormal 8-point DCT-II C: C @ block @ C.T is T.81's FDCT (A.3.3); on
# a row-major flattened block it is one product with kron(C, C), whose rows
# are taken here in zigzag order
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
_DCT_ZIGZAG = np.kron(_DCT, _DCT)[_ZIGZAG].astype(np.float32)
# JFIF's RGB -> YCbCr, with luma's level shift of -128 applied after
_YCBCR = np.array([[0.299, 0.587, 0.114],
                   [-0.168736, -0.331264, 0.5],
                   [0.5, -0.418688, -0.081312]], np.float32)


def _huffman_codes(table):
    """(code [256], length [256]) of a table given as (counts, symbols),
    T.81 Annex C."""
    counts, symbols = table
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c = k = 0
    for bits, n in enumerate(counts, 1):
        for _ in range(n):
            code[symbols[k]], length[symbols[k]] = c, bits
            c += 1
            k += 1
        c <<= 1
    return code, length


# codes and lengths of (table, symbol) at table * 256 + symbol, with the
# table 0 for luma and 1 for chroma
_DC_CODE, _DC_LEN = (np.concatenate(x) for x in zip(
    _huffman_codes(_DC_LUMA), _huffman_codes(_DC_CHROMA)))
_AC_CODE, _AC_LEN = (np.concatenate(x) for x in zip(
    _huffman_codes(_AC_LUMA), _huffman_codes(_AC_CHROMA)))


def _quant_table(base, quality):
    """IJG's quality scaling (jcparam.c), clamped to baseline's 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _bit_size(v):
    """Magnitude category of each value: the bit length of |v|."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v, size):
    """The ``size`` bits after a category: v, or v - 1 in ``size`` bits."""
    return np.where(v < 0, v + (1 << size) - 1, v)


def _entropy_code(coef, tables):
    """Huffman-code quantised zigzag blocks ``coef`` [N, 64] i64, in scan
    order, with their DC terms already differences, into the scan's bytes
    (padded with 1 bits, 0xFF stuffed).  ``tables`` [N] is each block's
    table (0 luma, 1 chroma).  Every step is a numpy array operation: the
    codes of all blocks are made at once, ordered by (block, position) and
    packed into bytes."""
    n = coef.shape[0]
    base = tables.astype(np.int64) * 256

    # DC: category symbol, then its extra bits (key: block * 1024)
    v = coef[:, 0]
    size = _bit_size(v)
    keys = [np.arange(n) * 1024]
    codes = [_DC_CODE[base + size] << size | _extra_bits(v, size)]
    lens = [_DC_LEN[base + size] + size]

    # AC: each nonzero coefficient after a run of zeros, a ZRL (16 zeros)
    # for every full 16 of the run (key: block * 1024 + k * 4 + sub)
    ac = coef[:, 1:]
    flat = np.flatnonzero(ac)
    v = ac.ravel()[flat]
    b, k = np.divmod(flat, 63)
    k += 1
    prev = np.empty_like(k)
    prev[1:] = k[:-1]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev[first] = 0
    run = k - prev - 1
    size = _bit_size(v)
    at = base[b] + ((run & 15) << 4 | size)
    keys.append(b * 1024 + k * 4 + 3)
    codes.append(_AC_CODE[at] << size | _extra_bits(v, size))
    lens.append(_AC_LEN[at] + size)
    zrl = np.repeat(np.arange(len(b)), run >> 4)
    nth = np.arange(len(zrl)) - np.repeat(np.cumsum(run >> 4) - (run >> 4),
                                          run >> 4)
    keys.append(b[zrl] * 1024 + k[zrl] * 4 + nth)
    codes.append(_AC_CODE[base[b[zrl]] + 0xF0])
    lens.append(_AC_LEN[base[b[zrl]] + 0xF0])

    # EOB where the last coefficient is zero
    eob = np.flatnonzero(coef[:, 63] == 0)
    keys.append(eob * 1024 + 1023)
    codes.append(_AC_CODE[base[eob]])
    lens.append(_AC_LEN[base[eob]])

    order = np.argsort(np.concatenate(keys), kind="stable")
    codes = np.concatenate(codes)[order]
    lens = np.concatenate(lens)[order]
    # an item (at most 27 bits) starting at bit s lies in the 5 bytes from
    # s // 8: shift it into that 40-bit window and add its bytes, which
    # no other item's bits overlap
    ends = np.cumsum(lens)
    total = int(ends[-1])
    starts = ends - lens
    window = codes << (40 - (starts & 7) - lens)
    first_byte = starts >> 3
    n_bytes = -(-total // 8)
    data = np.zeros(n_bytes + 4, np.int64)
    for j in range(5):
        data += np.bincount(first_byte + j,
                            weights=(window >> (32 - 8 * j)) & 0xFF,
                            minlength=n_bytes + 4).astype(np.int64)
    data = data[:n_bytes]
    data[-1] |= (1 << (-total % 8)) - 1          # pad with 1 bits
    data = data.astype(np.uint8)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def encode_jpeg(img_u8: np.ndarray, quality: int = 85) -> bytes:
    """RGB u8 [H, W, 3] -> baseline JPEG bytes: JFIF, YCbCr with 4:2:0
    chroma subsampling, the Annex K tables scaled by ``quality`` (1-100)
    with IJG's formula, the standard Huffman tables, the 8x8 DCT as a
    product with its basis matrix.  Edges are padded by replication to
    whole 16x16 units."""
    img = _rgb_u8(img_u8, "encode_jpeg")
    if not (0 < img.shape[0] < 65536 and 0 < img.shape[1] < 65536):
        raise ValueError(f"encode_jpeg takes 0 < H, W < 65536, got "
                         f"{img.shape}")
    quality = min(max(int(quality), 1), 100)
    h, w, _ = img.shape
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    ycc = rgb.reshape(-1, 3).astype(np.float32) @ _YCBCR.T
    y = ycc[:, 0].reshape(hp, wp) - np.float32(128.0)
    my, mx = hp // 16, wp // 16
    # an MCU: four luma blocks (2x2, row by row), then Cb, then Cr, each
    # chroma sample the mean of its 2x2 pixels
    y_blocks = y.reshape(my, 2, 8, mx, 2, 8).transpose(0, 3, 1, 4, 2, 5)
    c = ycc[:, 1:].reshape(hp, wp, 2)
    chroma = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
              + c[1::2, 1::2]) * np.float32(0.25)
    chroma = chroma.reshape(my, 8, mx, 8, 2).transpose(0, 2, 4, 1, 3)
    blocks = np.concatenate([y_blocks.reshape(my, mx, 4, 8, 8), chroma],
                            axis=2).reshape(-1, 64)
    q_luma = _quant_table(_Q_LUMA, quality)
    q_chroma = _quant_table(_Q_CHROMA, quality)
    q = np.stack([q_luma[_ZIGZAG]] * 4 + [q_chroma[_ZIGZAG]] * 2)
    coef = blocks @ _DCT_ZIGZAG.T                   # zigzag order
    coef = np.rint(coef.reshape(-1, 6, 64) / q).astype(np.int64)
    # DC as the difference from the same component's previous block
    dc = coef[..., 0]
    luma = np.diff(dc[:, :4].reshape(-1), prepend=0).reshape(-1, 4)
    chroma_dc = np.diff(dc[:, 4:], axis=0, prepend=0)
    coef[..., 0] = np.concatenate([luma, chroma_dc], axis=1)
    scan = _entropy_code(coef.reshape(-1, 64),
                         np.tile([0, 0, 0, 0, 1, 1], len(coef)))

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    dht = b"".join(bytes([cls_id]) + bytes(counts) + bytes(symbols)
                   for cls_id, (counts, symbols) in (
                       (0x00, _DC_LUMA), (0x10, _AC_LUMA),
                       (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)))
    return (b"\xff\xd8"
            + segment(0xFFE0, b"JFIF\x00\x01\x01\x00"
                      + struct.pack(">HHBB", 1, 1, 0, 0))
            + segment(0xFFDB, bytes([0]) + bytes(q_luma[_ZIGZAG].tolist())
                      + bytes([1]) + bytes(q_chroma[_ZIGZAG].tolist()))
            + segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                      + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
            + segment(0xFFC4, dht)
            + segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
            + scan + b"\xff\xd9")


@dataclass
class DiffStats:
    mean_abs: float          # mean |a-b| over all channels, 0..255 scale
    max_abs: float
    frac_within_1: float     # fraction of channel values within +-1
    frac_within_4: float
    frac_within_8: float
    psnr: float

    def __str__(self):
        return (f"mean|d|={self.mean_abs:.3f} max|d|={self.max_abs:.0f} "
                f"<=1:{self.frac_within_1:.4f} <=4:{self.frac_within_4:.4f} "
                f"<=8:{self.frac_within_8:.4f} psnr={self.psnr:.1f}dB")


def image_diff_stats(a: np.ndarray, b: np.ndarray) -> DiffStats:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    mse = float(np.mean(d * d))
    psnr = 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    return DiffStats(mean_abs=float(d.mean()), max_abs=float(d.max()),
                     frac_within_1=float((d <= 1).mean()),
                     frac_within_4=float((d <= 4).mean()),
                     frac_within_8=float((d <= 8).mean()),
                     psnr=psnr)
