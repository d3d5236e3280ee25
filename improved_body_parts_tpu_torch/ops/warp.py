"""Resizing and bilinear affine warping of image batches, for multi-scale
and rotation TTA, and for the resident training feed's augmentation (one
map a sample, ``data/resident.py``); and the uint8 resize of a host frame
that letterboxing needs (``resize_cubic_u8``) and the bilinear one of the
int8 export's calibration images (``resize_linear_u8``), without OpenCV.

Port of ``improved_body_parts_tpu/ops/warp.py``. The JAX functions take one
(H, W, C) array and are ``vmap``ped; these take (..., H, W, C) with any
leading batch dimensions. ``resize_cubic_cv2`` is two plain contractions
with cv2's INTER_CUBIC operator (``torch.einsum``, fp32: a float32 matmul on
the card runs without TF32 unless ``torch.backends.cuda.matmul.allow_tf32``
is set); ``affine_warp`` keeps the JAX package's fp32 arithmetic order for
the sample coordinates, so ``floor`` falls on the same cell.

``resize_cubic_u8`` reproduces ``cv2.resize(img, dsize, fx, fy,
INTER_CUBIC)`` on uint8 frames bit for bit, as OpenCV computes it itself
(imgproc/src/resize.cpp): the source coordinate ``(d + 0.5) * scale - 0.5``
in float, floored; the A = -0.75 coefficients rounded to ``short`` at
``INTER_RESIZE_COEF_SCALE`` (2048); border taps clamped; the horizontal
pass summed in ``int``; the vertical pass in ``int``, ``(v + (1 << 21)) >>
22``, except where OpenCV's SIMD loop takes the row (``VResizeCubicVec_32s8u``:
8 elements at a time, in float, each product rounded, then rounded half to
even), and a saturating cast. An OpenCV built with Intel IPP hands most
sizes of 4 x 4 and more to IPP's own cubic instead
(``cv2.ipp.useIPP()``), which rounds differently: a value near a half can
land one level off (tests/test_torch_letterbox.py measures it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from improved_body_parts_tpu_torch.ops.peaks import resize1d_cubic_matrix
from improved_body_parts_tpu_torch.utils.device import constant


def rotation_matrix(center_xy, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """2x3 float32 matrix mapping OUTPUT pixel coords to INPUT coords for a
    rotation by ``angle_deg`` about ``center_xy`` (cv2.getRotationMatrix2D's
    convention, returned as the inverse map a gather-based warp needs)."""
    a = np.deg2rad(angle_deg)
    cos_a, sin_a = np.cos(a) / scale, np.sin(a) / scale
    cx, cy = center_xy
    return np.array([
        [cos_a, sin_a, cx - cos_a * cx - sin_a * cy],
        [-sin_a, cos_a, cy + sin_a * cx - cos_a * cy],
    ], np.float32)


@functools.lru_cache(maxsize=64)
def _cubic_operator(s_in: int, s_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(resize1d_cubic_matrix(s_in, s_out, -0.75),
                           dtype=dtype, device=device)


INTER_RESIZE_COEF_BITS = 11
_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS
_VEC_LANES = 8         # OpenCV's vertical SIMD loop: 8 int16 lanes (SSE)


def _cubic_taps_u8(n_out: int, n_in: int, scale: float):
    """(taps (n_out, 4) source indices, clamped; coefficients (n_out, 4)
    int32 at 2048) of OpenCV's fixed-point cubic along one axis."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = f - s                                    # float32, as OpenCV's fx -= sx
    one, a = np.float32(1), np.float32(-0.75)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) \
        * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) \
        * (one - x) + one
    c3 = one - c0 - c1 - c2
    coef = np.rint(np.stack([c0, c1, c2, c3], 1) * np.float32(_COEF_SCALE))
    taps = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return torch.from_numpy(taps), torch.from_numpy(coef.astype(np.int32))


def resize_cubic_u8(img: np.ndarray, dsize=None, fx: float = 0.0,
                    fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=INTER_CUBIC)``
    for a uint8 (H, W) or (H, W, C) frame, bit for bit with OpenCV's own
    code (see the module docstring), in torch on the CPU. ``dsize`` is
    (width, height); without it the size is ``round(W * fx), round(H *
    fy)`` and the scales are ``fx``/``fy`` themselves, as in cv2."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 frame, got {img.dtype}")
    h, w = img.shape[:2]
    if dsize is None or tuple(dsize) == (0, 0):
        ow, oh = int(np.rint(w * fx)), int(np.rint(h * fy))
        inv_x, inv_y = fx, fy
    else:
        ow, oh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = ow / w, oh / h
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize of a {w}x{h} frame to {ow}x{oh}")
    c = img.shape[2] if img.ndim == 3 else 1
    shape = (oh, ow, c) if c > 1 else (oh, ow)     # cv2 returns 1 channel 2-D
    if (ow, oh) == (w, h):
        return img.reshape(shape).copy()
    src = torch.from_numpy(np.ascontiguousarray(img)).reshape(h, w, c)
    tx, cx = _cubic_taps_u8(ow, w, 1.0 / inv_x)
    ty, cy = _cubic_taps_u8(oh, h, 1.0 / inv_y)
    # horizontal pass, summed in int: (h, ow, c)
    hor = (src.to(torch.int32)[:, tx] * cx[None, :, :, None]).sum(2, dtype=torch.int32)
    rows = hor[ty].reshape(oh, 4, ow * c)                  # (oh, 4, ow*c)
    # vertical pass in int: (sum + 2^21) >> 22
    out = ((rows * cy[:, :, None]).sum(1, dtype=torch.int32) + (1 << 21)) >> 22
    n_vec = (ow * c) // _VEC_LANES * _VEC_LANES
    if n_vec:
        # OpenCV's SIMD loop over the first n_vec elements of a row:
        # float32 (S3 * b3), then each (S_k * b_k) added in turn, rounded
        # half to even; b_k = beta_k / 2048^2
        b = (cy.to(torch.float32) / float(_COEF_SCALE * _COEF_SCALE))[:, :, None]
        s = rows[:, :, :n_vec].to(torch.float32)
        acc = s[:, 3] * b[:, 3]
        for k in (2, 1, 0):
            acc = s[:, k] * b[:, k] + acc
        out[:, :n_vec] = torch.round(acc).to(torch.int32)
    return out.clamp_(0, 255).to(torch.uint8).reshape(shape).numpy()


def _linear_taps_u8(n_out: int, n_in: int, scale: float, clamp: bool):
    """(first source index (n_out,), clamped; coefficients (n_out, 2) int64
    at 2048) of OpenCV's fixed-point linear along one axis. ``clamp``: the
    horizontal axis's border rule, the index clamped and the fraction
    zeroed where it leaves the frame; the vertical axis keeps the fraction
    and clamps only the two rows it reads."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = f - s                                    # float32, as OpenCV's fx -= sx
    s = s.astype(np.int64)
    if clamp:
        out = (s < 0) | (s >= n_in - 1)
        x = np.where(out, np.float32(0), x)
        s = np.clip(s, 0, n_in - 1)
    coef = np.rint(np.stack([np.float32(1) - x, x], 1) * np.float32(_COEF_SCALE))
    return s, coef.astype(np.int64)


def resize_linear_u8(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR, cv2's default) for a uint8
    (H, W) or (H, W, C) frame, bit for bit with OpenCV's own code
    (imgproc/src/resize.cpp), in numpy. ``dsize`` is (width, height). The
    source coordinate ``(d + 0.5) * scale - 0.5`` in float, floored; the
    weights ``1 - f`` and ``f`` rounded to ``short`` at 2048; the
    horizontal pass summed in ``int``; the vertical pass as
    ``VResizeLinear``'s fixed point, ``((b0 * (S0 >> 4)) >> 16) + ((b1 *
    (S1 >> 4)) >> 16) + 2) >> 2`` (its SIMD loop computes the same). An
    exact halving of both sides is OpenCV's fast area mean instead, as
    there: ``(sum of the 2 x 2 block + 2) >> 2`` for 1, 3 or 4 channels,
    the float mean rounded half to even otherwise."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 frame, got {img.dtype}")
    h, w = img.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize of a {w}x{h} frame to {ow}x{oh}")
    c = img.shape[2] if img.ndim == 3 else 1
    shape = (oh, ow, c) if c > 1 else (oh, ow)     # cv2 returns 1 channel 2-D
    src = np.ascontiguousarray(img).reshape(h, w, c).astype(np.int64)
    if (ow, oh) == (w, h):
        return img.reshape(shape).copy()
    if (w, h) == (2 * ow, 2 * oh):
        block = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
                 + src[1::2, 1::2])
        if c in (1, 3, 4):
            out = (block + 2) >> 2
        else:
            out = np.rint(block.astype(np.float32) * np.float32(0.25))
        return out.astype(np.uint8).reshape(shape)
    sx, ax = _linear_taps_u8(ow, w, w / ow, clamp=True)
    sy, by = _linear_taps_u8(oh, h, h / oh, clamp=False)
    sx1 = np.minimum(sx + 1, w - 1)
    hor = (src[:, sx] * ax[None, :, 0, None]
           + src[:, sx1] * ax[None, :, 1, None])            # (h, ow, c), int
    r0 = hor[np.clip(sy, 0, h - 1)] >> 4
    r1 = hor[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((by[:, 0, None, None] * r0) >> 16)
           + ((by[:, 1, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(shape)


def resize_cubic_cv2(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(INTER_CUBIC)-exact resize of (..., H, W, C) to
    (..., out_h, out_w, C): Keys a=-0.75, half-pixel mapping, replicate
    border, no antialiasing on downscale."""
    h, w = img.shape[-3:-1]
    my = _cubic_operator(h, out_h, img.device, img.dtype)
    mx = _cubic_operator(w, out_w, img.device, img.dtype)
    out = torch.einsum("hk,...hwc->...kwc", my, img)
    return torch.einsum("wk,...hwc->...hkc", mx, out)


@functools.lru_cache(maxsize=64)
def _fill(values: tuple, shape: tuple, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    return constant(values, device, dtype).reshape(shape)


def affine_warp(img: torch.Tensor, inv_m, fill_value=0.0,
                out_hw=None) -> torch.Tensor:
    """Warp (..., H, W, C) by the inverse map ``inv_m`` (output -> input
    coords), bilinear, constant fill outside. ``inv_m`` is one (2, 3) numpy
    map for every leading index, the sample coordinates in fp32; or a
    (B, 2, 3) tensor of maps for images (B, H, W, C), one a sample, read
    where it lies (no trip through the host), the coordinates in its type
    (fp32, or float64 for a float64 reference). ``fill_value`` is a scalar
    or a (C,) vector (cv2's per-channel borderValue), kept on the device
    once per value; ``out_hw`` sets the output canvas (default: the
    input's)."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    oh, ow = out_hw or (h, w)
    dev = img.device
    per_sample = isinstance(inv_m, torch.Tensor)
    if per_sample:
        if len(lead) != 1 or inv_m.shape != (lead[0], 2, 3):
            raise ValueError(f"maps of shape {tuple(inv_m.shape)} for images "
                             f"{tuple(img.shape)}: want one (2, 3) map a sample")
        # (2, 3, B, 1, 1): m[i, j] broadcasts over each sample's canvas
        m = inv_m.to(dev).permute(1, 2, 0)[..., None, None]
    else:
        m = torch.as_tensor(np.asarray(inv_m, np.float32), device=dev)
    yy, xx = torch.meshgrid(torch.arange(oh, device=dev, dtype=torch.int32),
                            torch.arange(ow, device=dev, dtype=torch.int32),
                            indexing="ij")
    xx, yy = xx.to(m.dtype), yy.to(m.dtype)
    xs = m[0, 0] * xx + m[0, 1] * yy + m[0, 2]
    ys = m[1, 0] * xx + m[1, 1] * yy + m[1, 2]
    inb = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    xc = torch.clamp(xs, 0, w - 1)
    yc = torch.clamp(ys, 0, h - 1)
    x0 = torch.floor(xc).long()
    y0 = torch.floor(yc).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (xc - x0)[..., None]
    fy = (yc - y0)[..., None]
    flat = img.reshape(-1, h, w, c)
    # one map for all: every image at the same cells; else each at its own
    b = (torch.arange(flat.shape[0], device=dev)[:, None, None] if per_sample
         else slice(None))
    v = (flat[b, y0, x0] * (1 - fx) * (1 - fy) + flat[b, y0, x1] * fx * (1 - fy)
         + flat[b, y1, x0] * (1 - fx) * fy + flat[b, y1, x1] * fx * fy)
    fill = np.asarray(fill_value, np.float64)
    fill = _fill(tuple(fill.ravel().tolist()), fill.shape, dev, v.dtype)
    out = torch.where(inb[..., None], v, fill)
    return out.reshape(*lead, oh, ow, c)
