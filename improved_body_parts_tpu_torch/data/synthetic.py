"""Synthetic training data: random articulated skeletons rendered as images
with exact ground truth from the Heatmapper.

Lets the full train/eval/bench stack run in environments without the COCO
hdf5 dataset (the reference requires coco_train_dataset512.h5 built by
data/coco_masks_hdf5.py). Samples follow the same tensor contract as the
real pipeline (data/mydataset.py:15-37): image (H,W,3) float32 in [0,1],
mask_miss (H/4,W/4,1), heatmaps (H/4,W/4,50).

The port's copy of ``improved_body_parts_tpu/data/synthetic.py``:
``random_people``, ``render_image`` and ``SyntheticDataset`` with the
trainer's feeds: ``__getitem__`` (dense), ``get_compact``, ``batches`` and
``resident_raw`` (the record of the device-resident feed,
``data/resident.py``).
The compact feed's bf16 arrays are torch tensors (numpy has no bf16): the
fp32 -> bf16 conversion rounds to nearest even, as ``ml_dtypes`` does.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

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

    def get_compact(self, idx: int, rng=None, max_people: int = 8,
                    image_u8: bool = False):
        # rng accepted for API uniformity with CocoH5Dataset.get_compact;
        # synthetic samples are deterministic-by-index
        """Compact sample for device-side GT rendering: (image bf16,
        mask_miss bf16, (joints (P,18,3) f32, mask_all (h,w) bf16)), all
        torch tensors on the CPU. ~8× less host->device payload than the
        dense form; the heatmaps are rasterized inside the train step
        (data/heatmaps_device.py). ``image_u8`` ships the image as uint8
        instead (half the bf16 bytes; the step normalizes it —
        quantization ≤1/510 per pixel, the same order as bf16 rounding)."""
        from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H = W = self.size
        joints = random_people(rng, H, W)
        img = render_image(joints, H, W, rng)
        bf16 = torch.bfloat16
        mask = torch.ones((self.hm.h, self.hm.w, 1), dtype=bf16)
        mask_all = torch.ones((self.hm.h, self.hm.w), dtype=bf16)
        img = torch.from_numpy(
            np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
            if image_u8 else img.astype(np.float32))
        if not image_u8:
            img = img.to(bf16)
        return (img, mask, (torch.from_numpy(pad_people(joints, max_people)),
                            mask_all))

    def resident_raw(self, idx: int):
        """(image uint8, joints (n,18,3)) for the device-resident feed
        (data/resident.build_store): the raw fixed-size record, no GT —
        masks are implicit ones and the gaussians rasterize on the device."""
        rng = np.random.RandomState(self.seed * 100003 + idx)
        H = W = self.size
        joints = random_people(rng, H, W)
        img = render_image(joints, H, W, rng)
        return (np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8),
                joints)

    def batches(self, batch_size: int, steps: int, seed: int = 0,
                rank: int = 0, world: int = 1, compact: bool = False,
                max_people: int = 8, image_u8: bool = False,
                ) -> Iterator[Tuple]:
        """``batch_size`` is GLOBAL; with world > 1 every process draws the
        same index plan from ``seed`` and loads only its contiguous
        1/world slice (the reference DistributedSampler pattern,
        train_distributed.py:209-211). With ``compact`` the GT slot holds
        (joints, mask_all) instead of dense heatmaps."""
        rng = np.random.RandomState(seed)
        per = batch_size // world
        assert per * world == batch_size, (batch_size, world)
        for _ in range(steps):
            idxs = rng.randint(0, self.length, batch_size)
            idxs = idxs[rank * per:(rank + 1) * per]
            if compact:
                samples = [self.get_compact(i, max_people=max_people,
                                            image_u8=image_u8)
                           for i in idxs]
            else:
                samples = [self[i] for i in idxs]
            yield stack_samples(samples, compact)


def stack_samples(samples, compact: bool) -> Tuple:
    """A list of (image, mask, gt) samples -> one batch; ``gt`` is a pair
    (joints, mask_all) when ``compact``. numpy arrays stack with numpy,
    torch tensors with torch."""
    def stack(xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)
    gt = ((stack([s[2][0] for s in samples]), stack([s[2][1] for s in samples]))
          if compact else stack([s[2] for s in samples]))
    return (stack([s[0] for s in samples]), stack([s[1] for s in samples]), gt)
