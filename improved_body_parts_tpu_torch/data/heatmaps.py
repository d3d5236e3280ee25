"""Ground-truth heatmap generation (keypoint gaussians + limb gaussians +
background channels), vectorized.

Re-implementation of the reference Heatmapper (py_cocodata_server/
py_data_heatmapper.py:10-357) with per-person Python loops replaced by
whole-map vectorized numpy (people counts are tiny; pixels are not):

  * keypoint channels (HEAT_START..): windowed 2-D gaussians at grid-cell
    centers (grid = idx*stride + stride/2 - 0.5, heatmapper :45-53),
    max-combined across people (:163-165);
  * limb channels (0..29): gaussian of perpendicular distance to the limb
    segment, computed inside the limb's bbox expanded by paf_thre, floored
    at 0.01 below the threshold (:326-357), summed then averaged where
    multiple limbs overlap (:239-244);
  * background ch BKG_START: 3x3-eroded mask_all (:79-82);
    ch BKG_START+1: max over keypoint channels (:84-86);
  * clip to [0,1] (:102).

Output is NHWC (H/stride, W/stride, 50) float32.

The port's copy of ``improved_body_parts_tpu/data/heatmaps.py``: the
``Heatmapper`` and ``erode3`` (the offset maps, which no inference path
reads, are not copied).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from improved_body_parts_tpu_torch.configs import (
    BKG_START, HEAT_START, LIMBS_CONN, NUM_LAYERS, NUM_PARTS, CanonicalConfig,
)


class Heatmapper:
    def __init__(self, config: CanonicalConfig = CanonicalConfig()):
        self.config = config
        aug = config.aug
        self.stride = config.stride
        self.h = config.height // config.stride
        self.w = config.width // config.stride
        self.sigma = aug.sigma
        self.paf_sigma = aug.paf_sigma
        self.double_sigma2 = 2.0 * aug.sigma * aug.sigma
        self.limb_thre = aug.limb_gaussian_thre
        self.paf_pad = config.paf_thre  # bbox expansion, = stride
        # window size in grid cells around a keypoint (heatmapper :32-36)
        self.gaussian_size = math.ceil(
            math.sqrt(-self.double_sigma2 * math.log(aug.keypoint_gaussian_thre))
            / config.stride) * 2
        # grid-cell center coordinates in image space (heatmapper :45-54)
        self.grid_x = np.arange(self.w, dtype=np.float32) * self.stride + self.stride / 2 - 0.5
        self.grid_y = np.arange(self.h, dtype=np.float32) * self.stride + self.stride / 2 - 0.5
        self.X = np.broadcast_to(self.grid_x[None, :], (self.h, self.w))
        self.Y = np.broadcast_to(self.grid_y[:, None], (self.h, self.w))

    # ------------------------------------------------------------------
    def keypoint_channel(self, pts: np.ndarray) -> np.ndarray:
        """Max-combined windowed gaussians for one joint type.

        pts: (n, 2) visible joint coordinates in image space."""
        out = np.zeros((self.h, self.w), np.float32)
        if len(pts) == 0:
            return out
        half = self.gaussian_size // 2
        cx = np.rint(pts[:, 0] / self.stride).astype(np.int64)   # (n,)
        cy = np.rint(pts[:, 1] / self.stride).astype(np.int64)
        ix = np.arange(self.w)[None, :]
        iy = np.arange(self.h)[None, :]
        # window: cells in [c-half, c+half] inclusive, with negative mins
        # clamped to 0 (the reference slices with max(min,0))
        win_x = (ix >= np.maximum(cx[:, None] - half, 0)) & (ix <= cx[:, None] + half)
        win_y = (iy >= np.maximum(cy[:, None] - half, 0)) & (iy <= cy[:, None] + half)
        ex = np.exp(-np.square(self.grid_x[None, :] - pts[:, 0:1]) / self.double_sigma2)
        ey = np.exp(-np.square(self.grid_y[None, :] - pts[:, 1:2]) / self.double_sigma2)
        gauss = (ey * win_y)[:, :, None] * (ex * win_x)[:, None, :]  # (n, h, w)
        return gauss.max(axis=0).astype(np.float32)

    def limb_channel(self, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
        """Averaged limb gaussians for one limb type.

        p1, p2: (n, 2) endpoint coordinates of each person's limb."""
        acc = np.zeros((self.h, self.w), np.float32)
        count = np.zeros((self.h, self.w), np.float32)
        for (x1, y1), (x2, y2) in zip(p1, p2):
            dx, dy = x2 - x1, y2 - y1
            dnorm2 = dx * dx + dy * dy
            if dnorm2 == 0:
                continue
            # bbox window expanded by paf_pad, in grid cells (:205-231)
            min_sx = int(round((min(x1, x2) - self.paf_pad) / self.stride))
            min_sy = int(round((min(y1, y2) - self.paf_pad) / self.stride))
            max_sx = int(round((max(x1, x2) + self.paf_pad) / self.stride))
            max_sy = int(round((max(y1, y2) + self.paf_pad) / self.stride))
            if max_sx < 0 or max_sy < 0:
                continue
            min_sx, min_sy = max(min_sx, 0), max(min_sy, 0)
            sx = slice(min_sx, max_sx + 1)
            sy = slice(min_sy, max_sy + 1)
            X, Y = self.X[sy, sx], self.Y[sy, sx]
            norm = math.sqrt(dnorm2)
            dist = np.abs(dx * (y1 - Y) - (x1 - X) * dy) / (norm + 1e-6)
            g = np.exp(-np.square(dist) / (2 * self.paf_sigma ** 2))
            g = np.where(g <= self.limb_thre, 0.01, g).astype(np.float32)
            acc[sy, sx] += g          # g > 0 everywhere in the window
            count[sy, sx] += 1.0
        nz = count > 0
        acc[nz] /= count[nz]
        return acc

    # ------------------------------------------------------------------
    def create_heatmaps(self, joints: np.ndarray,
                        mask_all: Optional[np.ndarray] = None) -> np.ndarray:
        """joints: (n_people, 18, 3) canonical joints with visibility codes
        (0/1 = labeled, 2/3 = absent); mask_all: (h, w) all-person mask.
        Returns (h, w, 50) float32 NHWC ground truth."""
        # build channel-FIRST (each channel a contiguous plane — strided
        # (h, w, 50) channel writes cost ~7 ms/sample at 512^2), transpose
        # once at the end
        hm = np.zeros((NUM_LAYERS, self.h, self.w), np.float32)
        joints = np.asarray(joints, np.float32)

        for j in range(NUM_PARTS):
            vis = joints[:, j, 2] < 2
            hm[HEAT_START + j] = self.keypoint_channel(joints[vis, j, :2])

        for li, (fr, to) in enumerate(LIMBS_CONN):
            vis = (joints[:, fr, 2] < 2) & (joints[:, to, 2] < 2)
            hm[li] = self.limb_channel(joints[vis, fr, :2], joints[vis, to, :2])

        if mask_all is not None:
            hm[BKG_START] = erode3(np.asarray(mask_all, np.float32))
        hm[BKG_START + 1] = hm[HEAT_START:BKG_START].max(axis=0)
        np.clip(hm, 0.0, 1.0, out=hm)
        return np.ascontiguousarray(hm.transpose(1, 2, 0))


def erode3(mask: np.ndarray) -> np.ndarray:
    """3x3 binary erosion (cv2.erode with a ones kernel, heatmapper :80-82)."""
    p = np.pad(mask, 1, mode="edge")
    out = mask.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = np.minimum(out, p[1 + dy:1 + dy + mask.shape[0],
                                    1 + dx:1 + dx + mask.shape[1]])
    return out
