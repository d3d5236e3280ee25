"""The port's PNG reader and writer (``utils/imageio``) against OpenCV.

``imread`` must return what ``cv2.imread(path)`` returns, bit for bit, on
every PNG: files written by cv2, by PIL and by a hand-built encoder here
that forces each of the five row filters (and a mix of them a row each),
every colour type at every bit depth the format allows, Adam7 interlacing,
and odd sizes (1 x 1, 1 x N, 7 x 13; hypothesis draws more). ``imwrite``'s
files read back equal to the array through cv2 and through ``imread``. A
truncated or corrupt PNG raises; a file of another format goes to cv2, or
without cv2 raises an error that names the format.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from improved_body_parts_tpu_torch.utils import imageio

SIZES = [(1, 1), (1, 9), (9, 1), (7, 13), (32, 24)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
COMBOS = [(c, d) for c in sorted(DEPTHS) for d in DEPTHS[c]]
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _equal_to_cv2(path):
    want = cv2.imread(str(path))
    assert want is not None, "cv2 could not read the file"
    got = imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), int(np.abs(got.astype(int) - want).max())
    return got


# ---------------------------------------------------------------------------
# a hand-built encoder: any colour type and depth, a chosen filter a row
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(samples, depth):
    """(h, w, c) integer samples -> (h, L) uint8 bytes of the depth."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = ((samples[:, :, 0, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)


def _filter(raw, bpp, types):
    """Apply row filter ``types[r]`` to each row of (h, L) bytes."""
    x = raw.astype(np.int32)
    out = np.zeros((raw.shape[0], raw.shape[1] + 1), np.uint8)
    for r, t in enumerate(types):
        cur = x[r]
        up = x[r - 1] if r > 0 else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if t == 0:
            pred = 0
        elif t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out[r, 0] = t
        out[r, 1:] = (cur - pred) % 256
    return out


def hand_png(samples, ctype, depth, filters, interlace=False, palette=None,
             extra=b""):
    """The bytes of a PNG of (h, w, c) ``samples``; ``filters(n_rows)`` gives
    the filter type of each row of a (sub-)image."""
    h, w, c = samples.shape
    bpp = max(c * depth // 8, 1)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = b""
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if sub.size == 0:
            continue
        raw = _pack_rows(sub, depth)
        stream += _filter(raw, bpp, filters(sub.shape[0])).tobytes()
    out = imageio.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    out += extra
    return out + _chunk(b"IDAT", zlib.compress(stream)) + _chunk(b"IEND", b"")


def _random_image(rng, h, w, ctype, depth, smooth=True):
    """Samples of the colour type and depth, and a palette for type 3."""
    c = CHANNELS[ctype]
    top = (1 << depth) - 1
    if ctype == 3:
        n = min(top + 1, 1 + rng.randint(top + 1))
        return (rng.randint(0, n, (h, w, 1)),
                rng.randint(0, 256, (n, 3)))
    x = rng.randint(0, top + 1, (h, w, c)).astype(np.int64)
    if smooth:      # a gradient with noise: Average and Paeth rows matter
        ramp = (np.arange(h)[:, None, None] * 7 + np.arange(w)[None, :, None] * 5)
        x = (ramp * max(top // 64, 1) + x // 4) % (top + 1)
    return x, None


FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


@pytest.mark.parametrize("ctype,depth", COMBOS, ids=[f"c{c}d{d}" for c, d in COMBOS])
@pytest.mark.parametrize("rows", list(FILTERS) + ["mixed"])
def test_hand_built_filters_and_types(tmp_path, ctype, depth, rows):
    rng = np.random.RandomState(ctype * 100 + depth)
    samples, palette = _random_image(rng, 7, 13, ctype, depth)
    if rows == "mixed":
        filters = lambda n: [r % 5 for r in range(n)]          # noqa: E731
    else:
        filters = lambda n: [FILTERS[rows]] * n                # noqa: E731
    path = tmp_path / "x.png"
    path.write_bytes(hand_png(samples, ctype, depth, filters, palette=palette))
    _equal_to_cv2(path)


@pytest.mark.parametrize("ctype,depth", COMBOS, ids=[f"c{c}d{d}" for c, d in COMBOS])
def test_adam7_interlaced_is_decoded(tmp_path, ctype, depth):
    """Interlaced files are decoded (not rejected): equal to cv2 and to the
    same pixels written without interlacing."""
    rng = np.random.RandomState(7 + ctype * 10 + depth)
    samples, palette = _random_image(rng, 13, 11, ctype, depth)
    filters = lambda n: [(r * 3) % 5 for r in range(n)]        # noqa: E731
    a, b = tmp_path / "i.png", tmp_path / "p.png"
    a.write_bytes(hand_png(samples, ctype, depth, filters, interlace=True,
                           palette=palette))
    b.write_bytes(hand_png(samples, ctype, depth, filters, palette=palette))
    assert np.array_equal(_equal_to_cv2(a), imageio.imread(b))


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       combo=st.sampled_from(COMBOS), interlace=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_random_sizes_match_cv2(tmp_path_factory, h, w, combo, interlace, seed):
    ctype, depth = combo
    rng = np.random.RandomState(seed)
    samples, palette = _random_image(rng, h, w, ctype, depth,
                                     smooth=bool(seed % 2))
    types = rng.randint(0, 5, 64)
    path = tmp_path_factory.mktemp("hyp") / "x.png"
    path.write_bytes(hand_png(samples, ctype, depth, lambda n: types[:n],
                              interlace=interlace, palette=palette))
    _equal_to_cv2(path)


# ---------------------------------------------------------------------------
# files of other writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bgr8", "bgr16", "grey8", "grey16", "bgra8", "bgra16"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_cv2_written(tmp_path, kind, size):
    rng = np.random.RandomState(sum(size))
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    c = {"bgr": 3, "grey": 1, "bgra": 4}[kind.rstrip("0123456789")]
    img = rng.randint(0, np.iinfo(dtype).max + 1, size + (c,)).astype(dtype)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img[:, :, 0] if c == 1 else img)
    _equal_to_cv2(path)


PIL_MODES = ["1", "L", "LA", "RGB", "RGBA", "P", "I;16"]


@pytest.mark.parametrize("mode", PIL_MODES)
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pil_written(tmp_path, mode, size):
    rng = np.random.RandomState(len(mode) + sum(size))
    h, w = size
    if mode == "1":
        im = Image.fromarray(rng.randint(0, 2, (h, w)).astype(bool))
    elif mode == "I;16":
        im = Image.frombytes("I;16", (w, h),
                             rng.randint(0, 65536, (h, w)).astype("<u2").tobytes())
    elif mode == "P":
        rgb = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        im = rgb.convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        x = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        im = Image.fromarray(x[:, :, 0] if c == 1 else x, mode)
    path = tmp_path / "x.png"
    im.save(path, optimize=(sum(size) % 2 == 0))
    _equal_to_cv2(path)


def test_ancillary_chunks_change_nothing(tmp_path):
    rng = np.random.RandomState(3)
    samples, _ = _random_image(rng, 9, 9, 2, 8)
    extra = (_chunk(b"gAMA", struct.pack(">I", 45455))
             + _chunk(b"tEXt", b"Comment\x00test")
             + _chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3)))
    path = tmp_path / "x.png"
    path.write_bytes(hand_png(samples, 2, 8, lambda n: [4] * n, extra=extra))
    got = _equal_to_cv2(path)
    assert np.array_equal(got, samples[:, :, ::-1].astype(np.uint8))


# ---------------------------------------------------------------------------
# imwrite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 17, 3), (7, 13, 3), (40, 30, 3),
                                   (7, 13), (5, 4, 1)])
def test_imwrite_round_trip(tmp_path, shape):
    rng = np.random.RandomState(len(shape) + shape[0])
    img = rng.randint(0, 256, shape).astype(np.uint8)
    if shape[0] > 8:        # smooth rows: every filter gets picked somewhere
        img[::2] = np.sort(img[::2], axis=1)
    path = tmp_path / "x.png"
    imageio.imwrite(path, img)
    grey = img.reshape(img.shape[:2]) if img.ndim == 2 or img.shape[2] == 1 else None
    if grey is not None:
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), grey)
        assert np.array_equal(imageio.imread(path), np.repeat(grey[:, :, None], 3, 2))
    else:
        assert np.array_equal(cv2.imread(str(path)), img)
        assert np.array_equal(imageio.imread(path), img)


def test_imwrite_rejects_what_it_cannot_write(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="uint8"):
        imageio.imwrite(tmp_path / "x.png", np.zeros((2, 2, 3), np.uint16))
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        imageio.imwrite(tmp_path / "x.png", np.zeros((2, 2, 4), np.uint8))
    img = np.full((4, 4, 3), 7, np.uint8)
    imageio.imwrite(tmp_path / "x.bmp", img)            # through cv2
    assert np.array_equal(cv2.imread(str(tmp_path / "x.bmp")), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="without cv2 only PNG"):
        imageio.imwrite(tmp_path / "y.jpg", img)


# ---------------------------------------------------------------------------
# errors, and formats other than PNG
# ---------------------------------------------------------------------------

def _png_bytes():
    img = np.random.RandomState(0).randint(0, 256, (16, 16, 3)).astype(np.uint8)
    return imageio.encode_png(img)


@pytest.mark.parametrize("cut", [10, 40, -30, -12, -3])
def test_truncated_png_raises(tmp_path, cut):
    path = tmp_path / "x.png"
    path.write_bytes(_png_bytes()[:cut])
    with pytest.raises(imageio.ImageDecodeError, match="x.png"):
        imageio.imread(path)


def test_bad_crc_of_a_critical_chunk_raises(tmp_path):
    data = bytearray(_png_bytes())
    data[45] ^= 0xFF                    # a byte inside IDAT
    path = tmp_path / "x.png"
    path.write_bytes(bytes(data))
    with pytest.raises(imageio.ImageDecodeError, match="CRC"):
        imageio.imread(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        imageio.imread(tmp_path / "nope.png")


def test_png_never_needs_cv2(tmp_path, monkeypatch):
    path = tmp_path / "x.png"
    path.write_bytes(_png_bytes())
    want = cv2.imread(str(path))
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    assert np.array_equal(imageio.imread(path), want)


def test_other_formats_go_to_cv2(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (12, 10, 3)).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img)
    assert np.array_equal(imageio.imread(path), cv2.imread(path))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 20)
    with pytest.raises(imageio.ImageDecodeError, match="JPEG"):
        imageio.imread(bad)


def test_other_formats_without_cv2_name_the_format(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="JPEG file; without cv2 only PNG"):
        imageio.imread(path)
