"""Device-resident training feed: the dataset lives on the card as uint8,
and each step gets only a plan a few kilobytes long.

The port of ``improved_body_parts_tpu/data/resident.py``. The whole
fixed-canvas dataset is copied to the card ONCE (``ResidentStore.
device_arrays``); each train step then receives sample indices, one 2x3
inverse affine a sample and the joints already warped on the host (18
points a person, numpy). The step (``train_lib.make_resident_train_step``)
gathers the records from the store, warps images and masks on the card
(``ops/warp.affine_warp`` with one map a sample), decimates the masks to
stride resolution (an exact 4x4 box mean, cv2 INTER_AREA at an integer
factor) and rasterizes the GT on the card (``data/heatmaps_device.py``).

The reference does all of this on the host each step, with cv2 warpAffine
and the heatmapper in DataLoader workers (py_data_transformer.py:91-183,
py_data_heatmapper.py:10-357). The host pipeline of the port
(``data/pipeline.py``) does too, and needs cv2; this feed needs neither
cv2 nor h5py on the host that trains, once the store is built: the
synthetic store is built with numpy alone, an h5 store needs h5py (and cv2
only for records larger than the canvas) on the host that builds it.

Augmentation: the same ``AugmentSelection`` stream as the host pipeline
and as the JAX package, so the plans are identical. The deviations from
the host pipeline are the JAX package's: float bilinear against cv2's
5-bit fixed-point INTER_LINEAR, and no HSV tint (a stored image cannot be
re-tinted; geometric augmentation only).

A store sharded over the ranks (``--resident-shard-store``): each rank
copies only its contiguous record range to its card
(``device_arrays(shard=(rank, world))``), and ``plan_batches(
store_shards=world)`` gives each rank indices into its own range, the JAX
package's plan exactly; the gather needs no collective.
"""

from __future__ import annotations

import random as _pyrandom
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import (
    LEFT_PARTS, RIGHT_PARTS, CanonicalConfig, convert_coco_joints,
)
from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
from improved_body_parts_tpu_torch.data.pipeline import AugmentSelection

_IDENTITY_M = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
BORDER_BGR = (124, 127, 127)         # the augmentation's border colour


def _invert_affine(m23: np.ndarray) -> np.ndarray:
    """2x3 forward affine -> 2x3 inverse map (output->input coords)."""
    m = np.eye(3, dtype=np.float64)
    m[:2] = m23
    return np.linalg.inv(m)[:2].astype(np.float32)


class ResidentStore:
    """The arrays that go to the card, and the host-side metadata each
    record's augmentation is sampled from (objpos, scale_provided, joints)."""

    def __init__(self, images_u8: np.ndarray,
                 mask_miss_u8: Optional[np.ndarray],
                 mask_all_u8: Optional[np.ndarray],
                 joints_list, objpos, scale_provided):
        self.images = images_u8              # (N, H0, W0, 3) uint8
        self.mask_miss = mask_miss_u8        # (N, H0, W0) uint8 | None (=255)
        self.mask_all = mask_all_u8          # (N, H0, W0) uint8 | None (=255)
        self.joints = joints_list            # list of (p_i, 18, 3) float32
        self.objpos = objpos                 # (N, 2) float32
        self.scale_provided = scale_provided  # (N,) float32

    def __len__(self) -> int:
        return len(self.images)

    def device_arrays(self, device, shard: Optional[Tuple[int, int]] = None
                      ) -> dict:
        """Copy the dense arrays to ``device`` once. Returns the dict the
        resident train step takes as its ``store``: ``images`` and, where
        the records have them, ``mask_miss`` and ``mask_all``. ``shard`` =
        (i, n) copies only the i-th of n contiguous record ranges (a store
        sharded over n ranks; n must divide the records)."""
        out = {"images": self.images}
        if self.mask_miss is not None:
            out["mask_miss"] = self.mask_miss
        if self.mask_all is not None:
            out["mask_all"] = self.mask_all
        if shard is not None:
            i, n_shards = shard
            if len(self) % n_shards:
                raise ValueError(f"{len(self)} records do not divide over "
                                 f"{n_shards} shards")
            per = len(self) // n_shards
            out = {k: v[i * per:(i + 1) * per] for k, v in out.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in out.items()}


def build_store(dataset, canvas_hw: Optional[Tuple[int, int]] = None,
                indices: Optional[np.ndarray] = None) -> ResidentStore:
    """Assemble a fixed-canvas store from a dataset exposing either
    ``read_raw(idx) -> (img, mask_miss, mask_all, meta)`` (``CocoH5Dataset``:
    records are padded bottom/right to the canvas with the augmentation's
    border colours, records larger than it are INTER_AREA-downscaled with
    joints, objpos and scale scaled along) or ``resident_raw(idx) ->
    (img_u8, joints)`` (``SyntheticDataset``: fixed size, no masks).
    ``indices`` picks the records (default: all), e.g. the first multiple
    of the shard count for a sharded store."""
    idxs = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    n = len(idxs)

    if hasattr(dataset, "resident_raw"):
        imgs, joints = [], []
        for i in idxs:
            im, j = dataset.resident_raw(int(i))
            imgs.append(im)
            joints.append(np.asarray(j, np.float32))
        images = np.stack(imgs)
        # augmentation anchors: the first person's centroid; scale_provided
        # = that person's height / the canvas height, so the target_dist
        # scaling normalizes the main person as the reference's bbox scale
        H0 = images.shape[1]
        objpos, scale = [], []
        for j in joints:
            p0 = j[0]
            vis = p0[:, 2] < 2
            pts = p0[vis][:, :2] if vis.any() else p0[:, :2]
            objpos.append(pts.mean(0))
            scale.append(max(float(pts[:, 1].max() - pts[:, 1].min()) / H0,
                             0.1))
        return ResidentStore(images, None, None, joints,
                             np.asarray(objpos, np.float32),
                             np.asarray(scale, np.float32))

    records = [dataset.read_raw(int(i)) for i in idxs]
    if canvas_hw is None:
        canvas_hw = (max(r[0].shape[0] for r in records),
                     max(r[0].shape[1] for r in records))
    H0, W0 = canvas_hw
    images = np.empty((n, H0, W0, 3), np.uint8)
    images[:] = BORDER_BGR
    mask_miss = np.full((n, H0, W0), 255, np.uint8)
    mask_all = np.zeros((n, H0, W0), np.uint8)
    joints_list, objpos, scale_provided = [], [], []
    for k, (img, mm, ma, meta) in enumerate(records):
        joints = convert_coco_joints(np.asarray(meta["joints"]))
        op = np.asarray(meta["objpos"][0], np.float64)
        sp = float(meta["scale_provided"][0])
        h, w = img.shape[:2]
        if h > H0 or w > W0:
            import cv2
            s = min(H0 / h, W0 / w)
            nh, nw = int(h * s), int(w * s)
            img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
            mm = cv2.resize(mm, (nw, nh), interpolation=cv2.INTER_AREA)
            ma = cv2.resize(ma, (nw, nh), interpolation=cv2.INTER_AREA)
            joints = joints.copy()
            joints[:, :, :2] *= s
            op, sp = op * s, sp * s
            h, w = nh, nw
        images[k, :h, :w] = img
        mask_miss[k, :h, :w] = mm
        mask_all[k, :h, :w] = ma
        joints_list.append(joints.astype(np.float32))
        objpos.append(op)
        scale_provided.append(sp)
    return ResidentStore(images, mask_miss, mask_all, joints_list,
                         np.asarray(objpos, np.float32),
                         np.asarray(scale_provided, np.float32))


class ResidentFeed:
    """Per-step host plans for the resident train step: (idx, inv_m, joints).

    ``augment=True`` samples the same ``AugmentSelection`` as the host
    pipeline (flip, rotate, scale, shift; no tint), builds the combined
    forward affine about each record's objpos and scale, warps the JOINTS on
    the host exactly as ``Transformer.transform`` does, and plans the 2x3
    INVERSE map for the warp of images and masks on the card.
    ``augment=False`` plans identity maps."""

    def __init__(self, store: ResidentStore, config: CanonicalConfig,
                 augment: bool = True, max_people: int = 8):
        self.store = store
        self.config = config
        self.augment = augment
        self.max_people = max_people

    def _plan_one(self, idx: int, rng: np.random.RandomState):
        if not self.augment:
            return _IDENTITY_M, pad_people(self.store.joints[idx],
                                           self.max_people)
        aug = AugmentSelection.random(
            self.config.aug, _pyrandom.Random(rng.randint(2 ** 31)))
        return self.plan_for(idx, aug)

    def plan_for(self, idx: int, aug: AugmentSelection):
        """(inv_m (2,3), padded joints (P,18,3)) for one record under a
        given ``AugmentSelection``: the host's half of the warp."""
        joints = self.store.joints[idx]
        M, _ = aug.affine(tuple(self.store.objpos[idx]),
                          float(self.store.scale_provided[idx]), self.config)
        warped = joints.copy()
        homo = joints.copy()
        homo[:, :, 2] = 1.0
        warped[:, :, :2] = np.matmul(
            M, homo.transpose(0, 2, 1)).transpose(0, 2, 1)
        if aug.flip:   # L/R identity swap (py_data_transformer.py:171-176)
            tmp = warped[:, LEFT_PARTS, :].copy()
            warped[:, LEFT_PARTS, :] = warped[:, RIGHT_PARTS, :]
            warped[:, RIGHT_PARTS, :] = tmp
        return _invert_affine(M), pad_people(warped, self.max_people)

    def plan_batches(self, batch_size: int, steps: int, seed: int = 0,
                     rank: int = 0, world: int = 1, store_shards: int = 1,
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """``steps`` plans (idx (b,) int32, inv_m (b,2,3) float32, joints
        (b,P,18,3) float32). ``batch_size`` is GLOBAL: every process draws
        the same plan from ``seed`` and keeps its contiguous 1/world slice
        of ``b = batch_size // world`` samples (the shared-plan multi-process
        pattern of the reference's DistributedSampler,
        train_distributed.py:209-211).

        ``store_shards`` > 1 plans for a store sharded in that many
        contiguous record ranges (``device_arrays(shard=)``, one a rank when
        ``store_shards == world``): batch element j draws only from the
        range of the shard it lands on, and the indices it yields are LOCAL
        to that range; the joints and affines are still planned from the
        global record. reference: JAX ``ResidentFeed.plan_batches``."""
        rng = np.random.RandomState(seed)
        per = batch_size // world
        if per * world != batch_size:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{world} processes")
        n = len(self.store)
        if store_shards > 1:
            if n % store_shards or batch_size % store_shards:
                raise ValueError(f"{n} records and batch {batch_size} must "
                                 f"divide over {store_shards} store shards")
            n_local = n // store_shards
            shard_of = np.arange(batch_size) // (batch_size // store_shards)
        for _ in range(steps):
            if store_shards > 1:
                local = rng.randint(0, n_local, batch_size)
                idxs = shard_of * n_local + local        # global, for plans
                wire_idxs = local
            else:
                idxs = rng.randint(0, n, batch_size)
                wire_idxs = idxs
            # sample every augmentation from the shared stream so ranks stay
            # in step, then slice
            plans = [self._plan_one(int(i), rng) for i in idxs]
            sl = slice(rank * per, (rank + 1) * per)
            inv_m = np.stack([p[0] for p in plans])[sl]
            joints = np.stack([p[1] for p in plans])[sl]
            yield (wire_idxs[sl].astype(np.int32), inv_m.astype(np.float32),
                   joints.astype(np.float32))
