"""Image files without OpenCV: ``imread`` and ``imwrite`` for PNG.

The port's entry points read and write image files through this module,
so that they need no cv2: OpenCV is not among the packages the card's
machine is set up with (runs there have found a cv2 installed, but nothing
promises it). The price is speed: the decode is numpy, several times
slower than libpng on the same host (PERF.md section 3 has the times).
``imread`` decodes a PNG with ``zlib`` and
numpy and returns what ``cv2.imread(path)`` (``IMREAD_COLOR``) returns, bit
for bit: (H, W, 3) uint8 in BGR order. It takes every colour type (grey 0,
RGB 2, palette 3, grey + alpha 4, RGBA 6), every bit depth the format
allows (1, 2, 4, 8 for grey and palette; 8 and 16 otherwise), the five row
filters and Adam7 interlacing, as libpng does under cv2:

  * grey is replicated into the three channels, alpha and ``tRNS`` are
    dropped, palette indices are looked up;
  * grey of 1, 2 or 4 bits is scaled to 8 bits (x 255, x 85, x 17);
  * 16-bit samples keep their high byte (libpng's ``png_set_strip_16``);
  * ancillary chunks (gamma, colour profiles, text) change nothing.

A PNG always goes through this decoder, whether cv2 is installed or not,
so the tests on a machine with cv2 run the code the card's machine runs.
A file that is not a PNG is handed to cv2 where it imports; without cv2
``imread`` raises an error that names the format. A truncated or corrupt
PNG (a bad critical chunk CRC, a short stream) raises ``ImageDecodeError``;
``imread`` never returns ``None``.

``imwrite`` writes 8-bit grey (H, W) or BGR (H, W, 3) uint8 arrays as PNG,
each row with the filter of the smallest sum of absolute signed bytes
(libpng's heuristic); ``cv2.imread`` of the file gives the array back.
Another extension goes to ``cv2.imwrite``, and without cv2 raises.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# channels of each colour type, and the bit depths it may have
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (row start, column start, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))

# magic numbers of the formats cv2 reads, for the error without cv2
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"),
          (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"P6", "PPM"),
          (b"P5", "PGM"))


class ImageDecodeError(ValueError):
    """The file is not a readable image: a truncated or corrupt PNG, or a
    file cv2 could not decode."""


def _format_of(head: bytes) -> str:
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return "an unknown format"


def imread(path) -> np.ndarray:
    """The image at ``path`` as (H, W, 3) uint8 BGR, as ``cv2.imread(path)``
    returns it. PNG is decoded here; other formats need cv2."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        try:
            return decode_png(data)
        except ImageDecodeError as e:
            raise ImageDecodeError(f"{path}: {e}") from None
    fmt = _format_of(data[:12])
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: {fmt} file; without cv2 only PNG can be read "
            "(improved_body_parts_tpu_torch.utils.imageio)") from None
    img = cv2.imread(path)
    if img is None:
        raise ImageDecodeError(f"{path}: cv2 could not decode it ({fmt})")
    return img


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _chunks(data: bytes):
    """(type, body) of each chunk after the signature; raises on a short
    file or a bad CRC of a critical chunk (an ancillary one is skipped, as
    libpng skips it)."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ImageDecodeError("truncated PNG (no IEND chunk)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ImageDecodeError(f"truncated PNG (in a {kind!r} chunk)")
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:end])[0]
        critical = not (kind[0] & 0x20)
        if zlib.crc32(kind + body) != crc:
            if critical:
                raise ImageDecodeError(f"bad CRC in the {kind!r} chunk")
        else:
            yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _unfilter(filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of one (sub-)image: ``filt`` (H, 1 + L) uint8,
    each row its filter type then L bytes; ``bpp`` bytes a pixel (1 under 8
    bits). Returns the (H, L) raw bytes.

    Each byte depends on the one to its left (a), above (b) and above-left
    (c), so the bytes are reconstructed a wavefront at a time: every pixel
    (r, u) with r + u = d in one vectorised step, rows of any filter type
    together. The pixels are stored skewed (row r shifted right by r), so
    that a wavefront, and the a, b, c of its pixels, are columns."""
    H, L = filt.shape[0], filt.shape[1] - 1
    types = filt[:, 0]
    if types.max(initial=0) > 4:
        raise ImageDecodeError(f"unknown row filter type {int(types.max())}")
    U = L // bpp
    if not np.any(types >= 3):         # None, Sub, Up only: row by row
        out = np.empty((H, L), np.uint8)
        prev = np.zeros(L, np.uint8)
        for r in range(H):
            row, t = filt[r, 1:], types[r]
            if t == 1:
                row = np.cumsum(row.reshape(U, bpp), axis=0,
                                dtype=np.uint64).astype(np.uint8).reshape(L)
            elif t == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # skewed padded store, column-major: pixel (r, u) at P[r + 1 + u, r + 1]
    # (wavefront d = r + u is column d + 1); row 0 and the cells before
    # and after each row's pixels stay zero
    P = np.zeros((H + U + 1, H + 1, bpp), np.int16)
    F = np.zeros_like(P)

    def skewed(x):
        s0, s1, s2 = x.strides
        return np.lib.stride_tricks.as_strided(
            x[1:, 1:], shape=(H, U, bpp), strides=(s0 + s1, s0, s2))

    skewed(F)[...] = filt[:, 1:].reshape(H, U, bpp)
    present = set(types.tolist()) - {0}
    t_col = types.astype(np.int16)[:, None]
    for d in range(H + U - 1):
        r0, r1 = max(0, d - U + 1), min(H - 1, d) + 1
        a, b, c = P[d, r0 + 1:r1 + 1], P[d, r0:r1], P[d - 1, r0:r1]
        preds = {}
        if 1 in present:
            preds[1] = a
        if 2 in present:
            preds[2] = b
        if 3 in present:
            preds[3] = (a + b) >> 1
        if 4 in present:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            preds[4] = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, b, c))
        if len(preds) == 1 and 0 not in types[r0:r1]:
            pred = next(iter(preds.values()))
        else:
            t = t_col[r0:r1]
            pred = np.zeros_like(a)
            for k, v in preds.items():
                pred = np.where(t == k, v, pred)
        np.bitwise_and(F[d + 1, r0 + 1:r1 + 1] + pred, 0xFF,
                       out=P[d + 1, r0 + 1:r1 + 1])
    return skewed(P).astype(np.uint8).reshape(H, L)


def _samples(raw: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """(H, L) unfiltered bytes -> (H, width, channels) samples: uint8 for
    depths up to 8 (sub-byte samples unpacked, MSB first), uint16 for 16."""
    H = raw.shape[0]
    if depth == 16:
        return raw.view(">u2").reshape(H, width, channels).astype(np.uint16)
    if depth == 8:
        return raw.reshape(H, width, channels)
    bits = np.unpackbits(raw, axis=1)[:, :width * depth]
    bits = bits.reshape(H, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _pixels(idat: bytes, width: int, height: int, channels: int, depth: int,
            interlaced: bool) -> np.ndarray:
    """The (height, width, channels) samples of the decompressed stream."""
    bits_pp = channels * depth
    bpp = max(bits_pp // 8, 1)
    passes = (_ADAM7 if interlaced else ((0, 0, 1, 1),))
    out = np.zeros((height, width, channels),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for r0, c0, dr, dc in passes:
        h = (height - r0 + dr - 1) // dr if height > r0 else 0
        w = (width - c0 + dc - 1) // dc if width > c0 else 0
        if h == 0 or w == 0:
            continue
        stride = (w * bits_pp + 7) // 8
        n = h * (1 + stride)
        if pos + n > len(idat):
            raise ImageDecodeError("truncated PNG (the image data is short)")
        filt = np.frombuffer(idat, np.uint8, n, pos).reshape(h, 1 + stride)
        pos += n
        out[r0::dr, c0::dc] = _samples(_unfilter(filt, bpp), w, channels, depth)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) uint8 BGR, as ``cv2.imread``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ImageDecodeError("not a PNG file")
    header = palette = None
    idat: List[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ImageDecodeError("bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ImageDecodeError("no IHDR or no IDAT chunk")
    width, height, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ImageDecodeError(f"colour type {ctype} at {depth} bits")
    if comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise ImageDecodeError("unknown compression, filter or interlace method")
    if width == 0 or height == 0:
        raise ImageDecodeError("an image of no pixels")
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageDecodeError(f"corrupt image data ({e})") from None
    px = _pixels(stream, width, height, _CHANNELS[ctype], depth, interlace == 1)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise ImageDecodeError("a palette image without a PLTE chunk")
        idx = px[:, :, 0]
        if int(idx.max()) >= len(palette):
            raise ImageDecodeError("a palette index beyond the PLTE chunk")
        rgb = palette[idx]
    elif ctype in (0, 4):
        grey = px[:, :, 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        rgb = np.repeat(grey[:, :, None], 3, axis=2)
    else:
        rgb = px[:, :, :3]
    return np.ascontiguousarray(rgb[:, :, ::-1])


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, L) uint8 -> (H, 1 + L): each row under the filter whose bytes,
    read as signed, have the smallest sum of absolute values."""
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    cost = np.abs(cand.astype(np.uint8).view(np.int8).astype(np.int32)).sum(2)
    best = cost.argmin(0)
    rows = cand[best, np.arange(raw.shape[0])].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 -> the bytes of an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, channels, img = 2, 3, img[:, :, ::-1]      # BGR -> RGB
    else:
        raise ValueError(f"imwrite takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("imwrite of an empty image")
    raw = np.ascontiguousarray(img).reshape(h, w * channels)
    stream = zlib.compress(_filter_rows(raw, channels).tobytes(), level)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", stream) + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    """Write ``img`` to ``path``: a ``.png`` here ((H, W) grey or (H, W, 3)
    BGR uint8), any other extension through cv2, which must import."""
    path = os.fspath(path)
    if not path.lower().endswith(".png"):
        try:
            import cv2
        except ImportError:
            raise RuntimeError(f"{path}: without cv2 only PNG can be written "
                               "(improved_body_parts_tpu_torch.utils.imageio)"
                               ) from None
        if not cv2.imwrite(path, img):
            raise ValueError(f"{path}: cv2 could not write it")
        return
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
