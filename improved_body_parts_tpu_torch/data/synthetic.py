"""Synthetic training data: random articulated skeletons rendered as images
with exact ground truth from the Heatmapper.

Lets the full train/eval/bench stack run in environments without the COCO
hdf5 dataset (the reference requires coco_train_dataset512.h5 built by
data/coco_masks_hdf5.py). Samples follow the same tensor contract as the
real pipeline (data/mydataset.py:15-37): image (H,W,3) float32 in [0,1],
mask_miss (H/4,W/4,1), heatmaps (H/4,W/4,50).

The port's copy of ``improved_body_parts_tpu/data/synthetic.py``:
``random_people``, ``render_image`` and ``SyntheticDataset`` with its
``__getitem__`` (the compact and device-resident feeds of the JAX trainer
are not copied).
"""

from __future__ import annotations

import numpy as np

from improved_body_parts_tpu_torch.configs import NUM_PARTS, CanonicalConfig
from improved_body_parts_tpu_torch.data.heatmaps import Heatmapper

# a rough body template in a unit box: (x, y) per canonical part
_TEMPLATE = np.array([
    [0.50, 0.10],  # nose
    [0.50, 0.22],  # neck
    [0.38, 0.24],  # Rsho
    [0.33, 0.40],  # Relb
    [0.30, 0.55],  # Rwri
    [0.62, 0.24],  # Lsho
    [0.67, 0.40],  # Lelb
    [0.70, 0.55],  # Lwri
    [0.42, 0.55],  # Rhip
    [0.41, 0.75],  # Rkne
    [0.40, 0.95],  # Rank
    [0.58, 0.55],  # Lhip
    [0.59, 0.75],  # Lkne
    [0.60, 0.95],  # Lank
    [0.46, 0.07],  # Reye
    [0.54, 0.07],  # Leye
    [0.42, 0.09],  # Rear
    [0.58, 0.09],  # Lear
], np.float32)


def random_people(rng: np.random.RandomState, height: int, width: int,
                  max_people: int = 3) -> np.ndarray:
    """Sample (n, 18, 3) joints: jittered template instances, all visible."""
    n = rng.randint(1, max_people + 1)
    joints = np.zeros((n, NUM_PARTS, 3), np.float32)
    for i in range(n):
        scale = rng.uniform(0.3, 0.7) * height
        cx = rng.uniform(0.2, 0.8) * width
        cy = rng.uniform(0.2, 0.8) * height
        pts = (_TEMPLATE - [0.5, 0.5]) * scale + [cx, cy]
        pts += rng.normal(0, scale * 0.02, pts.shape)
        joints[i, :, :2] = pts
        joints[i, :, 2] = 1.0
    return joints


def render_image(joints: np.ndarray, height: int, width: int,
                 rng: np.random.RandomState) -> np.ndarray:
    """Paint blurred joints + limb strokes on noise so the image correlates
    with the ground truth."""
    img = rng.uniform(0.2, 0.4, (height, width, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for person in joints:
        for j in range(NUM_PARTS):
            x, y, v = person[j]
            if v < 2 and 0 <= x < width and 0 <= y < height:
                blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0 ** 2))
                c = (j % 3)
                img[:, :, c] = np.maximum(img[:, :, c], blob)
    return np.clip(img, 0.0, 1.0)


class SyntheticDataset:
    """Deterministic-by-index synthetic dataset (epoch reshuffling via seed)."""

    def __init__(self, config: CanonicalConfig = CanonicalConfig(),
                 length: int = 512, seed: int = 0, image_size: int | None = None):
        import dataclasses
        self.size = image_size or config.height
        # the heatmapper grid must span exactly the rendered image, otherwise
        # ground truth is spatially mis-scaled vs the network output
        if self.size != config.height or self.size != config.width:
            config = dataclasses.replace(config, width=self.size, height=self.size)
        self.config = config
        self.length = length
        self.seed = seed
        self.hm = Heatmapper(config)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H = W = self.size
        joints = random_people(rng, H, W)
        img = render_image(joints, H, W, rng)
        heat = self.hm.create_heatmaps(joints, np.ones(self.hm.X.shape, np.float32))
        mask = np.ones((self.hm.h, self.hm.w, 1), np.float32)
        return img, mask, heat
