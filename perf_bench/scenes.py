"""Traffic content from the seed: synthetic people, their frames, and the
training feed's augmentation plans.

The scene model is a frozen copy of the port's ``data/synthetic.py``
(``random_people``: jittered template skeletons; ``render_image``: blurred
joints painted over uniform noise, one colour channel a joint, clipped), and
the plans are a frozen copy of ``data/pipeline.AugmentSelection`` and
``data/resident.ResidentFeed.plan_for``. The joints are drawn on the host
with numpy; the frames are painted on the device in large batches from a
``torch.Generator`` on that device, then kept there (training) or fetched
once (serving). The same seed gives the same people, frames and plans.
"""

from __future__ import annotations

import random
from math import cos, pi, sin
from typing import List, Tuple

import numpy as np
import torch

from perf_bench.reference.layout import (
    LEFT_PARTS, NUM_PARTS, RIGHT_PARTS, AugmentationConfig,
)

# a rough body template in a unit box: (x, y) per canonical part
TEMPLATE = np.array([
    [0.50, 0.10], [0.50, 0.22], [0.38, 0.24], [0.33, 0.40], [0.30, 0.55],
    [0.62, 0.24], [0.67, 0.40], [0.70, 0.55], [0.42, 0.55], [0.41, 0.75],
    [0.40, 0.95], [0.58, 0.55], [0.59, 0.75], [0.60, 0.95], [0.46, 0.07],
    [0.54, 0.07], [0.42, 0.09], [0.58, 0.09],
], np.float32)
BLOB_SIGMA = 6.0


def random_people(rng: np.random.RandomState, height: int, width: int,
                  min_people: int, max_people: int) -> np.ndarray:
    """(n, 18, 3) joints, n in [min_people, max_people]: jittered template
    instances, all visible (``data/synthetic.random_people``)."""
    n = rng.randint(min_people, max_people + 1)
    joints = np.zeros((n, NUM_PARTS, 3), np.float32)
    for i in range(n):
        scale = rng.uniform(0.3, 0.7) * height
        cx = rng.uniform(0.2, 0.8) * width
        cy = rng.uniform(0.2, 0.8) * height
        pts = (TEMPLATE - [0.5, 0.5]) * scale + [cx, cy]
        pts += rng.normal(0, scale * 0.02, pts.shape)
        joints[i, :, :2] = pts
        joints[i, :, 2] = 1.0
    return joints


def draw_people(n: int, size: int, people: Tuple[int, int],
                rng: np.random.RandomState) -> List[np.ndarray]:
    return [random_people(rng, size, size, people[0], people[1])
            for _ in range(n)]


def paint(joints: List[np.ndarray], size: int, gen: torch.Generator,
          device, chunk: int = 64) -> torch.Tensor:
    """Frames (N, size, size, 3) uint8 on ``device``: uniform noise in
    [0.2, 0.4), each joint's gaussian (sigma 6 px) maxed into channel
    ``joint % 3``, clipped to [0, 1], rounded to uint8
    (``data/synthetic.render_image`` and ``resident_raw``)."""
    n = len(joints)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    grid = torch.arange(size, dtype=torch.float32, device=device)
    P = max(len(j) for j in joints)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        pts = np.zeros((hi - lo, P, NUM_PARTS, 3), np.float32)
        pts[..., 2] = 2.0                       # absent slots draw nothing
        for k, j in enumerate(joints[lo:hi]):
            pts[k, :len(j)] = j
        pts = torch.from_numpy(pts).to(device)
        img = torch.rand((hi - lo, 3, size, size), generator=gen,
                         device=device) * 0.2 + 0.2
        for j in range(NUM_PARTS):
            x, y, v = pts[:, :, j, 0], pts[:, :, j, 1], pts[:, :, j, 2]
            on = (v < 2) & (x >= 0) & (x < size) & (y >= 0) & (y < size)
            gx = torch.exp(-(grid - x[..., None]) ** 2 / (2 * BLOB_SIGMA ** 2))
            gy = torch.exp(-(grid - y[..., None]) ** 2 / (2 * BLOB_SIGMA ** 2))
            gx = gx * on[..., None]
            blob = torch.einsum("bpy,bpx->bpyx", gy, gx).amax(dim=1)
            c = j % 3
            img[:, c] = torch.maximum(img[:, c], blob)
        img = torch.clamp(img, 0.0, 1.0)
        out[lo:hi] = torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
    return out


class Augment:
    """One sampled augmentation (``data/pipeline.AugmentSelection``)."""

    def __init__(self, flip=False, degree=0.0, shift=(0, 0), scale=1.0):
        self.flip, self.degree, self.shift, self.scale = flip, degree, shift, scale

    @staticmethod
    def random(aug: AugmentationConfig, rng: random.Random) -> "Augment":
        flip = rng.uniform(0, 1) < aug.flip_prob
        rng.uniform(0, 1)                       # the tint draw (unused here)
        degree = rng.uniform(-1, 1) * aug.max_rotate_degree
        scale = ((aug.scale_max - aug.scale_min) * rng.uniform(0, 1) + aug.scale_min
                 if rng.uniform(0, 1) < aug.scale_prob else 1.0)
        dx = int(rng.uniform(-1, 1) * aug.center_perterb_max)
        dy = int(rng.uniform(-1, 1) * aug.center_perterb_max)
        return Augment(flip, degree, (dx, dy), scale)

    def affine(self, center, scale_provided: float, size: int,
               aug: AugmentationConfig) -> np.ndarray:
        """The combined forward 2x3 map (py_data_transformer.py:42-88)."""
        scale_self = scale_provided * (size / (size - 1))
        A = cos(self.degree / 180.0 * pi)
        B = sin(self.degree / 180.0 * pi)
        scale_size = aug.target_dist / scale_self * self.scale
        cx, cy = center
        center2zero = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
        rotate = np.array([[A, B, 0], [-B, A, 0], [0, 0, 1]], np.float64)
        scale_m = np.array([[scale_size, 0, 0], [0, scale_size, 0], [0, 0, 1]],
                           np.float64)
        flip_m = np.array([[-1 if self.flip else 1, 0, 0], [0, 1, 0], [0, 0, 1]],
                          np.float64)
        center2center = np.array([[1, 0, size / 2 - 0.5 + self.shift[0]],
                                  [0, 1, size / 2 - 0.5 + self.shift[1]],
                                  [0, 0, 1]], np.float64)
        return (center2center @ flip_m @ scale_m @ rotate @ center2zero)[0:2]


def pad_people(joints: np.ndarray, max_people: int) -> np.ndarray:
    out = np.zeros((max_people, NUM_PARTS, 3), np.float32)
    out[:, :, 2] = 2.0
    n = min(len(joints), max_people)
    out[:n] = joints[:n]
    return out


def plan_one(joints: np.ndarray, size: int, aug_cfg: AugmentationConfig,
             rng: random.Random, max_people: int):
    """(inverse map (2, 3), warped joints padded to (max_people, 18, 3)) of
    one record (``ResidentFeed.plan_for``): anchored at the first person's
    centroid, scaled by that person's height over the canvas."""
    p0 = joints[0]
    vis = p0[:, 2] < 2
    pts = p0[vis][:, :2] if vis.any() else p0[:, :2]
    center = pts.mean(0)
    scale = max(float(pts[:, 1].max() - pts[:, 1].min()) / size, 0.1)
    aug = Augment.random(aug_cfg, rng)
    M = aug.affine(tuple(center.astype(np.float32)), float(np.float32(scale)),
                   size, aug_cfg)
    homo = joints.copy()
    homo[:, :, 2] = 1.0
    warped = joints.copy()
    warped[:, :, :2] = np.matmul(M, homo.transpose(0, 2, 1)).transpose(0, 2, 1)
    if aug.flip:
        tmp = warped[:, LEFT_PARTS, :].copy()
        warped[:, LEFT_PARTS, :] = warped[:, RIGHT_PARTS, :]
        warped[:, RIGHT_PARTS, :] = tmp
    m = np.eye(3, dtype=np.float64)
    m[:2] = M
    inv = np.linalg.inv(m)[:2].astype(np.float32)
    return inv, pad_people(warped, max_people)
