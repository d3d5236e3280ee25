"""Batched keypoint peak finding: NMS + top-P + sub-pixel refinement.

Port of ``improved_body_parts_tpu/ops/peaks.py`` (:55-409). The JAX function
runs per image under ``vmap``; here the batch is a leading dimension:
``find_peaks`` takes ``(B, h, w, K)`` maps and returns a ``PeakTable`` whose
fields carry a leading B.

Every JAX option is ported: the NMS ``footprint`` ("plus" or "square"),
the refinements ``"bicubic"`` (the reference's 66.1-AP cropped-patch
cv2-cubic arg-max, parse_skeletons.py:126-176, with ``cubic_a`` and a finer
``refine_upsample``), ``"centroid"`` (utils/util.py:188-213, the
reference's swapped offset grids included) and ``"none"``, the
``content_hw`` cell mask before the top-P cut, ``n_raw``, and ``fused=True``
through the fused kernel (bicubic only, as in JAX; another refinement takes
the unfused path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from improved_body_parts_tpu_torch.ops import kernels

# cv2 INTER_CUBIC's Keys kernel parameter (the reference's AP numbers)
CV2_CUBIC_A = -0.75
WIN = 2     # the refinement patch is (2*WIN+1)^2 cells


class PeakTable(NamedTuple):
    """Fixed-size per-joint-type peak table (K joint types, P slots), with a
    leading batch dimension when it comes from ``find_peaks``."""
    xy: torch.Tensor          # (B, K, P, 2) float32 refined (x, y) in pixels
    score: torch.Tensor       # (B, K, P) float32
    valid: torch.Tensor       # (B, K, P) bool
    grid_yx: torch.Tensor     # (B, K, P, 2) int32 peak cell on the stride map
    n_raw: torch.Tensor = None  # (B, K) int32 NMS peaks before the top-P cut


def resized_coords(coords: torch.Tensor, factor: float) -> torch.Tensor:
    """Half-pixel mapping between resolutions (parse_skeletons.py:122-123)."""
    return (coords.to(torch.float32) + 0.5) * factor - 0.5


# ---------------------------------------------------------------------------
# cv2-exact cubic upsampling as a linear basis (host numpy, cached)
# ---------------------------------------------------------------------------

def keys_cubic_weights(f: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic-convolution weights for the 4 taps (x0-1, x0, x0+1, x0+2)
    at fractional position f in [0, 1). Shape (..., 4)."""
    f = np.asarray(f, np.float64)
    t = np.stack([1.0 + f, f, 1.0 - f, 2.0 - f], axis=-1)
    at = np.abs(t)
    near = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1          # |t| <= 1
    far = a * (at ** 3 - 5 * at ** 2 + 8 * at - 4)            # 1 < |t| < 2
    return np.where(at <= 1.0, near, far)


def resize1d_cubic_matrix(s_in: int, s_out: int, a: float) -> np.ndarray:
    """(s_in, s_out) matrix M with (signal @ M) == cv2.resize INTER_CUBIC of
    the 1-D signal (half-pixel mapping, replicate border, Keys ``a``)."""
    m = np.zeros((s_in, s_out), np.float64)
    scale = s_in / s_out
    for X in range(s_out):
        x = (X + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        w = keys_cubic_weights(x - x0, a)
        for k in range(4):
            m[min(max(x0 - 1 + k, 0), s_in - 1), X] += w[k]
    return m


@functools.lru_cache(maxsize=None)
def _border_case_bases(win: int, up: int, a: float):
    """Per-border-case 1-D upsample bases for the cropped-patch refinement
    (the reference crops the patch at map borders, parse_skeletons.py:
    143-153). Case 0 is interior, 1..win the low side clipped by that many
    cells, win+1..2*win the high side clipped by c-win. Returns
    (bases (cases, size, size*up) float32, valid (cases, size*up) bool)."""
    size = 2 * win + 1
    bases = np.zeros((size, size, size * up), np.float64)
    valid = np.zeros((size, size * up), bool)
    for case in range(size):
        lo_clip = case if case <= win else 0
        hi_clip = case - win if case > win else 0
        s = size - lo_clip - hi_clip
        bases[case, lo_clip:lo_clip + s, :s * up] = resize1d_cubic_matrix(
            s, s * up, a)
        valid[case, :s * up] = True
    return bases.astype(np.float32), valid


def _border_case_index(c: torch.Tensor, size: int, win: int) -> torch.Tensor:
    """Case index for coordinate c on an axis of ``size`` cells."""
    lo = torch.clamp(win - c, min=0)
    hi = torch.clamp(c + win - (size - 1), min=0)
    return torch.where(lo > 0, lo, torch.where(hi > 0, hi + win, 0))


def _gather_patches(maps: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                    win: int) -> torch.Tensor:
    """maps (N, H, W), cy/cx (N, P) -> (N, P, S, S) patches around each cell,
    zero outside the map."""
    n = maps.shape[0]
    size = 2 * win + 1
    padded = torch.nn.functional.pad(maps, (win, win, win, win))
    taps = torch.arange(size, device=maps.device)
    rows = torch.arange(n, device=maps.device)[:, None, None, None]
    return padded[rows, cy[:, :, None, None] + taps[:, None],
                  cx[:, :, None, None] + taps[None, :]]


def _refine_bicubic_from_patch(patch: torch.Tensor, cy: torch.Tensor,
                               cx: torch.Tensor, h: int, w: int, stride: int,
                               cubic_a: float, up: Optional[int] = None):
    """Cropped-patch bicubic-upsample arg-max refinement into image pixels
    (parse_skeletons.py:141-173): patch (..., S, S) with zeros outside the
    map, cy/cx (...). ``up`` is the patch upsample factor: ``stride`` (the
    default) reproduces the reference's 1 px grid, a larger one samples the
    same cubic surface on a finer grid. Returns (x_img, y_img, score)."""
    up = up or stride
    size = 2 * WIN + 1
    bases_np, valids_np = _border_case_bases(WIN, up, cubic_a)
    bases = torch.from_numpy(bases_np).to(patch.device)
    valids = torch.from_numpy(valids_np).to(patch.device)
    iy = _border_case_index(cy, h, WIN)
    ix = _border_case_index(cx, w, WIN)
    by, bx = bases[iy], bases[ix]                       # (..., S, S*up)
    patch_up = torch.matmul(torch.matmul(by.transpose(-1, -2), patch), bx)
    ok = valids[iy][..., :, None] & valids[ix][..., None, :]
    patch_up = torch.where(ok, patch_up, float("-inf"))
    upsz = size * up
    flat = patch_up.flatten(-2)
    flat_idx = torch.argmax(flat, dim=-1)               # first max, like jnp
    score = torch.gather(flat, -1, flat_idx[..., None])[..., 0]
    uy, ux = flat_idx // upsz, flat_idx % upsz
    y0 = torch.clamp(cy - WIN, min=0)
    x0 = torch.clamp(cx - WIN, min=0)
    dy = (uy.to(torch.float32) - resized_coords(cy - y0, up)) * (float(stride) / up)
    dx = (ux.to(torch.float32) - resized_coords(cx - x0, up)) * (float(stride) / up)
    y_img = resized_coords(cy, stride) + dy
    x_img = resized_coords(cx, stride) + dx
    return x_img, y_img, score


def _refine_centroid(maps: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                     stride: int, radius: int = 2):
    """Weighted-centroid refinement on the stride map, into image pixels
    (utils/util.py:188-213; score = the box mean). maps (N, h, w), cy/cx
    (N, P). A window that crosses the border keeps the raw cell and its
    value, as the reference does. The reference's ``np.mgrid`` swaps the
    two offset grids, so its x offset is the row (y) moment and vice versa;
    that is reproduced."""
    h, w = maps.shape[-2:]
    patch = _gather_patches(maps, cy, cx, radius)       # zeros outside
    fully_inb = ((cy >= radius) & (cy + radius <= h - 1)
                 & (cx >= radius) & (cx + radius <= w - 1))
    grid = torch.arange(-radius, radius + 1, device=maps.device,
                        dtype=torch.float32)
    total = patch.sum(dim=(-2, -1))
    denom = torch.clamp(total, min=1e-12)
    off_x = (patch * grid[:, None]).sum(dim=(-2, -1)) / denom    # the swap
    off_y = (patch * grid[None, :]).sum(dim=(-2, -1)) / denom
    box_mean = total / (2 * radius + 1) ** 2
    raw = torch.gather(maps.flatten(-2), 1, cy * w + cx)
    fx, fy = cx.to(torch.float32), cy.to(torch.float32)
    fx = torch.where(fully_inb, fx + off_x, fx)
    fy = torch.where(fully_inb, fy + off_y, fy)
    score = torch.where(fully_inb, box_mean, raw)
    return resized_coords(fx, stride), resized_coords(fy, stride), score


def find_peaks(heat: torch.Tensor, *, thre: float = 0.1, max_peaks: int = 32,
               stride: int = 4, refine: str = "bicubic",
               footprint: Optional[str] = None, cubic_a: float = CV2_CUBIC_A,
               fused: Optional[bool] = False,
               content_hw: Optional[torch.Tensor] = None,
               refine_upsample: Optional[int] = None) -> PeakTable:
    """Up to ``max_peaks`` peaks per joint-type channel, per image.

    heat: (B, h, w, K) stride-resolution keypoint maps. ``refine`` is
    "bicubic", "centroid" or "none"; ``footprint`` defaults to "plus" for
    bicubic and "square" otherwise. ``content_hw`` ((B, 2) float [h, w] in
    padded-image pixels, or None) zeroes NMS cells whose pixel footprint
    starts at or past the content extent BEFORE the top-P cut and
    invalidates refined coordinates past it. ``fused`` (bicubic only) runs
    NMS, top-P and patch extraction in the fused kernel; there the content
    mask is applied to the input maps instead (the fused kernel runs NMS
    itself), as in the JAX package. Ties in the top-P keep the lowest flat
    index first (``lax.top_k``'s order)."""
    if refine not in ("bicubic", "centroid", "none"):
        raise ValueError(f"unknown refine scheme: {refine!r}")
    if footprint is None:
        footprint = "plus" if refine == "bicubic" else "square"
    B, h, w, K = heat.shape
    dev = heat.device
    size = 2 * WIN + 1
    chan_first = heat.permute(0, 3, 1, 2).float().contiguous()   # (B, K, h, w)

    cell_ok = None
    if content_hw is not None:
        content_hw = content_hw.to(device=dev, dtype=torch.float32)
        # a stride cell c covers pixels [c*stride, c*stride + stride - 1]
        row_ok = (torch.arange(h, device=dev, dtype=torch.float32) * stride
                  < content_hw[:, 0:1])
        col_ok = (torch.arange(w, device=dev, dtype=torch.float32) * stride
                  < content_hw[:, 1:2])
        cell_ok = (row_ok[:, :, None] & col_ok[:, None, :])[:, None]  # (B,1,h,w)

    patches = None
    if fused and refine == "bicubic":
        if cell_ok is not None:
            chan_first = torch.where(cell_ok, chan_first, 0.0)
        top_scores, yx, n_raw, patches = kernels.fused_peaks(
            chan_first.reshape(B * K, h, w).contiguous(), thre,
            max_peaks=max_peaks, footprint=footprint, win=WIN)
        top_scores = top_scores.reshape(B, K, max_peaks)
        cy = yx[..., 0].reshape(B, K, max_peaks).long()
        cx = yx[..., 1].reshape(B, K, max_peaks).long()
        n_raw = n_raw.reshape(B, K)
        patches = patches.reshape(B, K, max_peaks, size, size)
    else:
        nmsed = kernels.nms(chan_first.reshape(B * K, h, w), thre,
                            footprint=footprint).reshape(B, K, h, w)
        if cell_ok is not None:
            nmsed = torch.where(cell_ok, nmsed, 0.0)
        flat = nmsed.reshape(B, K, h * w)
        n_raw = (flat > 0.0).sum(-1).to(torch.int32)
        # a stable descending sort keeps equal scores (every empty slot is 0)
        # in index order, exactly as lax.top_k does; torch.topk promises no
        # order among ties
        top_scores, top_idx = torch.sort(flat, dim=-1, descending=True,
                                         stable=True)
        top_scores = top_scores[..., :max_peaks]
        top_idx = top_idx[..., :max_peaks]
        cy, cx = top_idx // w, top_idx % w
    valid = top_scores > 0.0
    maps = chan_first.reshape(B * K, h, w)
    cy_f, cx_f = cy.reshape(B * K, -1), cx.reshape(B * K, -1)
    if refine == "bicubic":
        if patches is None:
            patches = _gather_patches(maps, cy_f, cx_f, WIN).reshape(
                B, K, max_peaks, size, size)
        xs, ys, scores = _refine_bicubic_from_patch(
            patches, cy, cx, h, w, stride, cubic_a, up=refine_upsample)
    elif refine == "centroid":
        xs, ys, scores = (t.reshape(B, K, max_peaks) for t in
                          _refine_centroid(maps, cy_f, cx_f, stride))
    else:
        # the raw NMS cell's top-left in image pixels, and its value
        xs = cx.to(torch.float32) * stride
        ys = cy.to(torch.float32) * stride
        scores = torch.gather(maps.flatten(-2), 1,
                              cy_f * w + cx_f).reshape(B, K, max_peaks)
    xy = torch.stack([xs, ys], dim=-1)
    scores = torch.where(valid, scores, 0.0)
    if content_hw is not None:
        inb = ((xy[..., 0] < content_hw[:, None, None, 1])
               & (xy[..., 1] < content_hw[:, None, None, 0]))
        scores = torch.where(inb, scores, 0.0)
        valid = valid & inb
    return PeakTable(xy=xy.float(), score=scores.float(), valid=valid,
                     grid_yx=torch.stack([cy, cx], dim=-1).to(torch.int32),
                     n_raw=n_raw)
