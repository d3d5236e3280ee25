"""Device-side ground-truth rendering: the Heatmapper on a batch of tensors.

The port of ``improved_body_parts_tpu/data/heatmaps_device.py``. The
trainer's compact feed (``--feed compact``/``compact-u8``) ships only the
scene description — (P,18,3) joints + a stride-resolution mask — and the
gaussians are rasterized here, on the card, inside the train step: at bs8
512² that keeps ~26 MB of dense fp32 GT per step off the host-to-device
copy.

Semantics are locked element-for-element to the host oracle
``data/heatmaps.py`` (itself parity-locked to the reference heatmapper):

  * keypoint channels: windowed separable gaussians at grid-cell centers,
    window = ±gaussian_size/2 cells around round(p/stride) (round half to
    even, as ``jnp.round``) with only the LOWER bound clamped to 0,
    max-combined across people;
  * limb channels: perpendicular-distance gaussians inside the limb bbox
    expanded by paf_thre (rounded to cells, mins clamped to 0), floored at
    0.01 below the threshold, summed then averaged where windows overlap;
  * background ch 48: 3×3 edge-padded erosion of mask_all;
    ch 49: max over the keypoint channels; final clip to [0,1].

The batch is rendered at once; people are taken one slot at a time, in
order (the JAX package's ``lax.scan``), so the working set is one
(B, channels, h, w) plane and the limb sums add in the same order. Padded
slots use visibility code 2 ("absent") and contribute nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from improved_body_parts_tpu_torch.configs import (
    BKG_START, HEAT_START, LIMBS_CONN, NUM_PARTS, CanonicalConfig,
)
from improved_body_parts_tpu_torch.utils.device import constant


def erode3_device(mask: torch.Tensor) -> torch.Tensor:
    """3×3 min-erosion with edge padding of (..., h, w) masks (host oracle:
    heatmaps.erode3)."""
    h, w = mask.shape[-2:]
    lead = mask.shape[:-2]
    p = F.pad(mask.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    out = mask.reshape(-1, 1, h, w)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = torch.minimum(out, p[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out.reshape(*lead, h, w)


class DeviceHeatmapper:
    """Constants mirror data/heatmaps.Heatmapper.__init__ exactly."""

    def __init__(self, config: CanonicalConfig = CanonicalConfig()):
        aug = config.aug
        self.stride = float(config.stride)
        self.h = config.height // config.stride
        self.w = config.width // config.stride
        self.double_sigma2 = 2.0 * aug.sigma * aug.sigma
        self.paf_sigma = aug.paf_sigma
        self.limb_thre = aug.limb_gaussian_thre
        self.paf_pad = float(config.paf_thre)
        self.gaussian_size = math.ceil(
            math.sqrt(-self.double_sigma2 * math.log(aug.keypoint_gaussian_thre))
            / config.stride) * 2
        self.grid_x = np.arange(self.w, dtype=np.float32) * self.stride \
            + self.stride / 2 - 0.5
        self.grid_y = np.arange(self.h, dtype=np.float32) * self.stride \
            + self.stride / 2 - 0.5
        self.limbs_from = np.asarray([fr for fr, _ in LIMBS_CONN])
        self.limbs_to = np.asarray([to for _, to in LIMBS_CONN])
        self._constants = {}

    def constants(self, dev: torch.device, dt: torch.dtype) -> tuple:
        """The grid (gx, gy, ix, iy) and the limbs' end indices on ``dev``,
        made on the first call for each (device, dtype) and kept: a copy
        from the host inside the step could not be captured in a CUDA
        graph."""
        key = (dev, dt)
        if key not in self._constants:
            self._constants[key] = (
                constant(self.grid_x, dev).to(dt),
                constant(self.grid_y, dev).to(dt),
                torch.arange(self.w, dtype=dt, device=dev),
                torch.arange(self.h, dtype=dt, device=dev),
                constant(self.limbs_from, dev),
                constant(self.limbs_to, dev))
        return self._constants[key]

    # ------------------------------------------------------------------
    def _person_kp(self, pts, vis, gx, gy, ix, iy):
        """(B,18,2) pts + (B,18) bool -> (B,18,h,w) windowed gaussians."""
        half = self.gaussian_size // 2
        cx = torch.round(pts[..., 0] / self.stride)[..., None]     # (B,18,1)
        cy = torch.round(pts[..., 1] / self.stride)[..., None]
        win_x = (ix >= torch.clamp(cx - half, min=0)) & (ix <= cx + half)
        win_y = (iy >= torch.clamp(cy - half, min=0)) & (iy <= cy + half)
        ex = torch.exp(-torch.square(gx - pts[..., 0:1]) / self.double_sigma2)
        ey = torch.exp(-torch.square(gy - pts[..., 1:2]) / self.double_sigma2)
        g = (ey * win_y)[..., :, None] * (ex * win_x)[..., None, :]
        return g * vis[..., None, None]

    def _person_limbs(self, pts, vis, X, Y, ix, iy, limbs_from, limbs_to):
        """(B,18,2)+(B,18) -> ((B,30,h,w) floored gaussians, (B,30,h,w) window)."""
        p1 = pts[:, limbs_from]                                # (B,30,2)
        p2 = pts[:, limbs_to]
        valid = vis[:, limbs_from] & vis[:, limbs_to]
        x1, y1 = p1[..., 0], p1[..., 1]
        x2, y2 = p2[..., 0], p2[..., 1]
        dx, dy = x2 - x1, y2 - y1
        dnorm2 = dx * dx + dy * dy
        valid = valid & (dnorm2 > 0)
        norm = torch.sqrt(dnorm2)

        # bbox window in grid cells; mins clamped to 0, maxes unclamped
        # (an all-negative bbox yields an empty window, = the host's skip)
        min_sx = torch.clamp(torch.round(
            (torch.minimum(x1, x2) - self.paf_pad) / self.stride), min=0)
        min_sy = torch.clamp(torch.round(
            (torch.minimum(y1, y2) - self.paf_pad) / self.stride), min=0)
        max_sx = torch.round((torch.maximum(x1, x2) + self.paf_pad) / self.stride)
        max_sy = torch.round((torch.maximum(y1, y2) + self.paf_pad) / self.stride)
        win = (((ix >= min_sx[..., None]) & (ix <= max_sx[..., None]))[..., None, :]
               & ((iy >= min_sy[..., None]) & (iy <= max_sy[..., None]))[..., :, None]
               & valid[..., None, None])

        e = (..., None, None)
        dist = torch.abs(dx[e] * (y1[e] - Y) - (x1[e] - X) * dy[e]) \
            / (norm[e] + 1e-6)
        g = torch.exp(-torch.square(dist) / (2 * self.paf_sigma ** 2))
        g = torch.where(g <= self.limb_thre, 0.01, g)
        return torch.where(win, g, 0.0), win.to(g.dtype)

    # ------------------------------------------------------------------
    def render(self, joints: torch.Tensor,
               mask_all: torch.Tensor | None = None,
               rows: tuple | None = None) -> torch.Tensor:
        """(B,P,18,3) joints (vis code 2/3 = absent; padded slots use 2) +
        optional (B,h,w) mask_all -> (B,h,w,50) float32 (float64 for float64
        joints), == the host oracle for each batch element. ``rows`` (lo,
        hi) renders only those rows of the maps, (B, hi - lo, w, 50), equal
        to the same rows of the whole render (a spatial mesh's band);
        ``mask_all`` stays whole, for the erosion's edge rows."""
        dt = torch.promote_types(joints.dtype, torch.float32)
        joints = joints.to(dt)
        dev = joints.device
        B = joints.shape[0]
        gx, gy, ix, iy, limbs_from, limbs_to = self.constants(dev, dt)
        lo, hi = rows or (0, self.h)
        if rows is not None:
            gy, iy = gy[lo:hi], iy[lo:hi]
        X, Y = gx, gy[:, None]                                  # (w,), (h, 1)
        n_limbs = len(self.limbs_from)
        h = hi - lo
        kp = torch.zeros((B, NUM_PARTS, h, self.w), dtype=dt, device=dev)
        acc = torch.zeros((B, n_limbs, h, self.w), dtype=dt, device=dev)
        cnt = torch.zeros((B, n_limbs, h, self.w), dtype=dt, device=dev)
        for p in range(joints.shape[1]):
            pts, vis = joints[:, p, :, :2], joints[:, p, :, 2] < 2
            kp = torch.maximum(kp, self._person_kp(pts, vis, gx, gy, ix, iy))
            g, win = self._person_limbs(pts, vis, X, Y, ix, iy, limbs_from,
                                        limbs_to)
            acc = acc + g
            cnt = cnt + win

        limbs = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), 0.0)
        if mask_all is None:
            bkg = torch.zeros((B, h, self.w), dtype=dt, device=dev)
        else:
            bkg = erode3_device(mask_all.to(dt))[:, lo:hi]
        hm = torch.cat([limbs, kp, bkg[:, None], kp.amax(dim=1, keepdim=True)],
                       dim=1)
        assert hm.shape[1] == BKG_START + 2 and HEAT_START == limbs.shape[1]
        return torch.clamp(hm, 0.0, 1.0).permute(0, 2, 3, 1)


def pad_people(joints: np.ndarray, max_people: int) -> np.ndarray:
    """Pad/truncate (n,18,3) host joints to (max_people,18,3); padded slots
    get visibility 2 (absent) so the renderer ignores them."""
    out = np.full((max_people, NUM_PARTS, 3), 0.0, np.float32)
    out[:, :, 2] = 2.0
    n = min(len(joints), max_people)
    out[:n] = joints[:n]
    return out
