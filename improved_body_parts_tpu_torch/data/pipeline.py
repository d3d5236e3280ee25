"""Online training data pipeline: reference-format COCO hdf5 -> augmented
(image, mask, heatmaps) batches.

Re-implementation of the reference data server (py_cocodata_server/
py_data_iterator.py:36-146, py_data_transformer.py:9-183, data/mydataset.py)
with the same tensor contract so existing ``coco_*_dataset512.h5`` files
work unchanged:

  * one combined 3x3 affine (center->origin * rotate * scale * flip *
    origin->center+jitter) warps image, masks and joints together
    (py_data_transformer.py:42-88);
  * augmentation: flip p=.5, tint p=.2, rotate +-40deg, scale [0.7,1.3)
    p=.8, shift +-50 px (config/config.py:25-49);
  * joints re-ordered COCO->CMU with neck synthesis (configs.convert_coco_joints);
  * GT heatmaps from data/heatmaps.py at stride 4;
  * outputs NHWC float32: image (H,W,3)/255, mask_miss (H/4,W/4,1),
    heatmaps (H/4,W/4,50).

The port's copy of ``improved_body_parts_tpu/data/pipeline.py``; cv2 and
h5py are imported where they are used. The compact feed's bf16 arrays are
torch tensors (round to nearest even, as ``ml_dtypes`` rounds).
"""

from __future__ import annotations

import json
import random
from math import cos, pi, sin
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import (
    LEFT_PARTS, RIGHT_PARTS, CanonicalConfig, convert_coco_joints,
)
from improved_body_parts_tpu_torch.data.heatmaps import Heatmapper
from improved_body_parts_tpu_torch.data.synthetic import stack_samples


class AugmentSelection:
    """One sampled augmentation. reference: py_data_transformer.py:9-40."""

    def __init__(self, flip=False, tint=False, degree=0.0, shift=(0, 0), scale=1.0):
        self.flip = flip
        self.tint = tint
        self.degree = degree
        self.shift = shift
        self.scale = scale

    @staticmethod
    def random(aug, rng: random.Random) -> "AugmentSelection":
        flip = rng.uniform(0, 1) < aug.flip_prob
        tint = rng.uniform(0, 1) < aug.tint_prob
        degree = rng.uniform(-1, 1) * aug.max_rotate_degree
        scale = ((aug.scale_max - aug.scale_min) * rng.uniform(0, 1) + aug.scale_min
                 if rng.uniform(0, 1) < aug.scale_prob else 1.0)
        dx = int(rng.uniform(-1, 1) * aug.center_perterb_max)
        dy = int(rng.uniform(-1, 1) * aug.center_perterb_max)
        return AugmentSelection(flip, tint, degree, (dx, dy), scale)

    @staticmethod
    def identity() -> "AugmentSelection":
        return AugmentSelection()

    def affine(self, center: Tuple[float, float], scale_provided: float,
               config: CanonicalConfig) -> Tuple[np.ndarray, float]:
        """Build the combined 2x3 affine matrix.
        reference: py_data_transformer.py:42-88."""
        scale_self = scale_provided * (config.height / (config.height - 1))
        A = cos(self.degree / 180.0 * pi)
        B = sin(self.degree / 180.0 * pi)
        scale_size = config.aug.target_dist / scale_self * self.scale
        cx, cy = center

        center2zero = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
        rotate = np.array([[A, B, 0], [-B, A, 0], [0, 0, 1]], np.float64)
        scale_m = np.array([[scale_size, 0, 0], [0, scale_size, 0], [0, 0, 1]],
                           np.float64)
        flip_m = np.array([[-1 if self.flip else 1, 0, 0], [0, 1, 0], [0, 0, 1]],
                          np.float64)
        center2center = np.array(
            [[1, 0, config.width / 2 - 0.5 + self.shift[0]],
             [0, 1, config.height / 2 - 0.5 + self.shift[1]],
             [0, 0, 1]], np.float64)
        combined = center2center @ flip_m @ scale_m @ rotate @ center2zero
        return combined[0:2], scale_size


def distort_color(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """HSV tint jitter. reference: py_data_transformer.py:97-109."""
    import cv2
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.int16)
    hsv[:, :, 0] = np.clip(hsv[:, :, 0] - 10 + rng.randint(20 + 1), 0, 179)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] - 20 + rng.randint(80 + 1), 0, 255)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] - 20 + rng.randint(60 + 1), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


class Transformer:
    """Applies one combined affine to image + masks + joints.
    reference: py_data_transformer.py:91-183."""

    def __init__(self, config: CanonicalConfig):
        self.config = config

    def transform(self, img, mask_miss, mask_all, joints, objpos, scale_provided,
                  aug: Optional[AugmentSelection] = None,
                  rng: Optional[np.random.RandomState] = None):
        import cv2
        cfg = self.config
        rng = rng or np.random.RandomState()
        if aug is None:
            aug = AugmentSelection.random(cfg.aug, random.Random(rng.randint(2 ** 31)))
        if aug.tint:
            img = distort_color(img, rng)

        assert scale_provided != 0, "scale_provided is zero"
        M, _ = aug.affine(objpos, scale_provided, cfg)

        # cv2 dsize is (width, height); mask_shape is stored (h, w)
        dsize = (cfg.width, cfg.height)
        mask_dsize = cfg.mask_shape[::-1]
        img = cv2.warpAffine(img, M, dsize,
                             flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=(124, 127, 127))
        mask_miss = cv2.warpAffine(mask_miss, M, dsize,
                                   flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        mask_miss = cv2.resize(mask_miss, mask_dsize, interpolation=cv2.INTER_AREA)
        mask_all = cv2.warpAffine(mask_all, M, dsize,
                                  flags=cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        mask_all = cv2.resize(mask_all, mask_dsize, interpolation=cv2.INTER_AREA)

        # warp joint coordinates with the same matrix (homogeneous column 1)
        joints = joints.copy()
        homo = joints.copy()
        homo[:, :, 2] = 1.0
        warped = np.matmul(M, homo.transpose(0, 2, 1)).transpose(0, 2, 1)
        joints[:, :, 0:2] = warped

        if aug.flip:  # left/right identity swap (py_data_transformer.py:171-176)
            tmp = joints[:, LEFT_PARTS, :].copy()
            joints[:, LEFT_PARTS, :] = joints[:, RIGHT_PARTS, :]
            joints[:, RIGHT_PARTS, :] = tmp

        return (img.astype(np.float32) / 255.0,
                mask_miss.astype(np.float32) / 255.0,
                mask_all.astype(np.float32) / 255.0,
                joints)


class CocoH5Dataset:
    """Reads the reference hdf5 layout (groups dataset/images/masks with
    JSON metadata; py_data_iterator.py:111-146) and produces training
    triplets (image, mask_miss, heatmaps)."""

    def __init__(self, h5_path: str, config: CanonicalConfig = CanonicalConfig(),
                 augment: bool = True, seed: int = 0):
        self.h5_path = h5_path
        self.config = config
        self.augment = augment
        self.seed = seed
        self.heatmapper = Heatmapper(config)
        self.transformer = Transformer(config)
        self._h5 = None
        import h5py
        with h5py.File(h5_path, "r") as f:
            # new layout: groups dataset/images/masks; legacy: group 'datum'
            # with packed image+mask entries (py_data_iterator.py:76-109)
            self._legacy = "datum" in f and "dataset" not in f
            group = "datum" if self._legacy else "dataset"
            assert group in f, "expected reference-format h5 ('dataset' or 'datum')"
            self._keys = list(f[group].keys())

    def __len__(self) -> int:
        return len(self._keys)

    def _file(self):
        # lazy-open per process/worker (h5py handles are not fork-safe;
        # py_data_iterator.py:42-45 does the same)
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.h5_path, "r")
        return self._h5

    def read_raw(self, idx: int):
        f = self._file()
        key = self._keys[idx]
        if self._legacy:
            return self._read_raw_legacy(f, key)
        entry = f["dataset"][key]
        meta = json.loads(entry[()])
        img = f["images"][meta["image"]][()]
        mask_miss = mask_all = None
        if img.ndim == 3 and img.shape[2] > 3:      # image+mask packed
            mask_miss = img[:, :, 3]
            img = img[:, :, :3]
        if mask_miss is None and "masks" in f:
            concat = f["masks"][meta["image"]][()]
            mask_miss, mask_all = concat[:, :, 0], concat[:, :, 1]
        if mask_miss is None:                        # MPII-style fallback
            mask_miss = np.full(img.shape[:2], 255, np.uint8)
        if mask_all is None:
            mask_all = np.zeros(img.shape[:2], np.uint8)
        return img, mask_miss, mask_all, meta

    def _read_raw_legacy(self, f, key):
        """Legacy 'datum' layout: a (6, H, W) or (H, W, 6) tensor packing
        [img(3), border, mask_miss, mask_all] with meta in attrs
        (py_data_iterator.py:84-109)."""
        entry = f["datum"][key]
        meta = json.loads(entry.attrs["meta"])
        data = entry[()]
        if data.shape[0] <= 6:          # stored transposed (C, H, W)
            data = data.transpose(1, 2, 0)
        img = data[:, :, 0:3]
        mask_miss = data[:, :, 4]
        mask_all = data[:, :, 5]
        return img, mask_miss, mask_all, meta

    def __getitem__(self, idx: int, rng: Optional[np.random.RandomState] = None):
        img, mask_miss, mask_all, meta = self.read_raw(idx)
        joints = convert_coco_joints(np.asarray(meta["joints"]))
        rng = rng or np.random.RandomState(self.seed * 100003 + idx)
        aug = None if self.augment else AugmentSelection.identity()
        img, mask_miss, mask_all, joints = self.transformer.transform(
            img, mask_miss, mask_all, joints,
            tuple(meta["objpos"][0]), float(meta["scale_provided"][0]),
            aug=aug, rng=rng)
        heat = self.heatmapper.create_heatmaps(joints, mask_all)
        return img, mask_miss[..., None], heat

    def get_compact(self, idx: int, rng: Optional[np.random.RandomState] = None,
                    max_people: int = 8, image_u8: bool = False):
        """Compact sample for device-side GT rendering (image bf16,
        mask_miss bf16, (joints (P,18,3) f32, mask_all (h,w) bf16)): the
        augmentation affine runs on the host as usual, but the dense
        heatmaps are rasterized inside the jitted train step
        (data/heatmaps_device.py), so ~26 MB/step of GT upload disappears.
        The warped mask_all is downsampled to stride resolution with
        INTER_AREA, same as the dense path's heatmapper input.
        ``image_u8`` ships the image as uint8 (half the bf16 bytes; the step
        normalizes in-graph, quantization ≤1/510 ≈ bf16 rounding)."""
        from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
        img, mask_miss, mask_all, meta = self.read_raw(idx)
        joints = convert_coco_joints(np.asarray(meta["joints"]))
        rng = rng or np.random.RandomState(self.seed * 100003 + idx)
        aug = None if self.augment else AugmentSelection.identity()
        img, mask_miss, mask_all, joints = self.transformer.transform(
            img, mask_miss, mask_all, joints,
            tuple(meta["objpos"][0]), float(meta["scale_provided"][0]),
            aug=aug, rng=rng)
        def bf16(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        img = (torch.from_numpy(np.clip(np.rint(img * 255.0), 0, 255)
                                .astype(np.uint8))
               if image_u8 else bf16(img))
        return (img, bf16(mask_miss[..., None]),
                (torch.from_numpy(pad_people(joints, max_people)),
                 bf16(mask_all)))

    def batches(self, batch_size: int, steps: int, seed: int = 0,
                rank: int = 0, world: int = 1, compact: bool = False,
                max_people: int = 8, image_u8: bool = False,
                ) -> Iterator[Tuple]:
        """``batch_size`` is GLOBAL; with world > 1 every process draws the
        same index/augmentation plan from ``seed`` and loads only its
        contiguous 1/world slice (DistributedSampler pattern,
        train_distributed.py:209-211). With ``compact`` the GT slot holds
        (joints, mask_all) for device-side rasterization."""
        rng = np.random.RandomState(seed)
        per = batch_size // world
        assert per * world == batch_size, (batch_size, world)
        for _ in range(steps):
            idxs = rng.randint(0, len(self._keys), batch_size)
            # draw the full global augmentation plan so all ranks stay in
            # lockstep, then load only ours
            seeds = [rng.randint(2 ** 31) for _ in range(batch_size)]
            lo = rank * per
            pairs = list(zip(idxs[lo:lo + per], seeds[lo:lo + per]))
            if compact:
                samples = [self.get_compact(i, np.random.RandomState(s),
                                            max_people, image_u8=image_u8)
                           for i, s in pairs]
            else:
                samples = [self.__getitem__(i, np.random.RandomState(s))
                           for i, s in pairs]
            yield stack_samples(samples, compact)
