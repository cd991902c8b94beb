"""Image I/O + golden-image comparison.

Port of :mod:`tpuray.io`.  ``write_png``/``read_png`` are the analog of
png_dump (cpu_ray.c:108-165) and the wrapper's PNG loader
(opencl_wrap.c:241-320).  The codec is numpy + the standard library's
``zlib``, so that the port needs neither Pillow nor libpng.  It reads 8-bit greyscale, grey+alpha, RGB and RGBA PNGs,
non-interlaced, with all five row filters, and returns RGB (alpha dropped,
grey replicated, as Pillow's ``convert("RGB")``).  It writes 8-bit RGB.
Anything else (palette, 16-bit, Adam7) raises.

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


def encode_png(img_u8: np.ndarray) -> bytes:
    """RGB u8 [H, W, 3] -> PNG bytes (8-bit RGB, filter None)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes RGB u8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
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
    data = encode_png(img_u8)
    with open(path, "wb") as f:
        f.write(data)


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
