"""Offline COCO -> hdf5 dataset builder (reference-format compatible).

Re-implementation of the reference builder (data/coco_masks_hdf5.py:39-364):
per image it builds ``mask_miss`` (people without keypoint annotations,
including crowd regions, -> 0) and ``mask_all`` (every person -> 255),
selects "main persons" (>=5 keypoints, segment area >= 32^2, not within
0.3 x bbox-max of a previously chosen main person) and writes ONE training
sample per main person — the main person gets the image-centering privilege;
all other annotated people ride along in the same sample.

Output hdf5 layout matches the reference exactly (groups ``dataset`` /
``images`` / ``masks``; JSON entry {image, joints, objpos, scale_provided}
with the full meta in attrs) so files are interchangeable between the two
code bases. Uses pycocotools when installed; otherwise decodes polygon/RLE
segmentations with the in-repo shim (data/coco_shim.py).

The port's copy of ``improved_body_parts_tpu/data/build_records.py``: the
same functions, CLI and file (tests/test_torch_records.py holds the two
builders' files equal, dataset by dataset). Images are read with
``utils/imageio.imread``. A host tool: it needs h5py, and cv2 for polygon
segmentations (``coco_shim.polygons_to_mask``) and for JPEG images, where it
runs; the card's machine has neither, and training there reads the files it
writes (``data/pipeline.CocoH5Dataset``, ``apps.train --train-h5``).

Usage:
    python -m improved_body_parts_tpu_torch.data.build_records \
        --coco-dir data/dataset/coco --out-dir data/dataset/coco
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np

IMAGE_SIZE = 512
VAL_SIZE = 100  # first N val images become the validation split


def make_masks(coco, img_meta, img_anns):
    """(mask_miss, mask_all) as uint8 0/255. reference: coco_masks_hdf5.py:39-123."""
    h, w = img_meta["height"], img_meta["width"]
    mask_all = np.zeros((h, w), bool)
    mask_miss = np.zeros((h, w), bool)
    flags = 0
    for p in img_anns:
        seg_mask = coco.annToMask(p).astype(bool)
        if p.get("iscrowd", 0) == 1:
            crowd = seg_mask & ~mask_all  # subtract overlap with real people
            mask_miss = mask_miss | crowd
            mask_all = mask_all | seg_mask
            flags += 1
            continue
        mask_all = mask_all | seg_mask
        if p.get("num_keypoints", 0) <= 0:
            mask_miss = mask_miss | seg_mask
    # mask_miss is INVERTED on save: annotated area = 255, missing = 0
    mask_miss_u8 = ((~mask_miss).astype(np.uint8)) * 255
    mask_all_u8 = mask_all.astype(np.uint8) * 255
    return mask_miss_u8, mask_all_u8


def encode_visibility(v_coco: int) -> int:
    """COCO v(0 unlabeled,1 hidden,2 visible) -> CMU-style (0 invisible,
    1 visible, 2 absent). reference: coco_masks_hdf5.py:155-169."""
    if v_coco == 2:
        return 1
    if v_coco == 1:
        return 0
    return 2


def person_records(img_anns) -> List[dict]:
    out = []
    for ann in img_anns:
        joints = np.zeros((17, 3))
        kp = ann["keypoints"]
        for j in range(17):
            joints[j, 0] = kp[j * 3]
            joints[j, 1] = kp[j * 3 + 1]
            joints[j, 2] = encode_visibility(kp[j * 3 + 2])
        out.append(dict(
            objpos=[ann["bbox"][0] + ann["bbox"][2] / 2,
                    ann["bbox"][1] + ann["bbox"][3] / 2],
            bbox=ann["bbox"],
            segment_area=ann["area"],
            num_keypoints=ann.get("num_keypoints", 0),
            joint=joints,
            scale_provided=ann["bbox"][3] / IMAGE_SIZE,
        ))
    return out


def select_main_persons(persons: List[dict]) -> List[dict]:
    """reference: coco_masks_hdf5.py:186-216."""
    mains, prev = [], []
    for p in persons:
        if p["num_keypoints"] < 5 or p["segment_area"] < 32 * 32:
            continue
        c = np.asarray(p["objpos"])
        too_close = any(np.linalg.norm(c - pc[:2]) < pc[2] * 0.3 for pc in prev)
        if too_close:
            continue
        mains.append(p)
        prev.append(np.array([c[0], c[1], max(p["bbox"][2], p["bbox"][3])]))
    return mains


def image_instances(img_meta, img_id, img_idx, img_anns, dataset_type):
    """Yield one sample dict per main person. reference: coco_masks_hdf5.py:218-266."""
    persons = person_records(img_anns)
    mains = select_main_persons(persons)
    template = dict(
        dataset=dataset_type,
        isValidation=1 if (img_idx < VAL_SIZE and "val" in dataset_type) else 0,
        img_width=img_meta["width"], img_height=img_meta["height"],
        image_id=img_id, annolist_index=img_idx,
        img_path="%012d.jpg" % img_id)
    for main in mains:
        inst = dict(template)
        inst["objpos"] = [main["objpos"]]
        inst["joints"] = [main["joint"].tolist()]
        inst["scale_provided"] = [main["scale_provided"]]
        n_other = 0
        for other in persons:
            if other is main:
                inst["people_index"] = persons.index(other)
                continue
            if other["num_keypoints"] == 0:
                continue
            inst["joints"].append(other["joint"].tolist())
            inst["scale_provided"].append(other["scale_provided"])
            inst["objpos"].append(other["objpos"])
            n_other += 1
        inst["numOtherPeople"] = n_other
        yield inst


def write_sample(data_grp, img_grp, mask_grp, inst, img, mask_miss, mask_all, count):
    """reference: coco_masks_hdf5.py:270-314."""
    img_key = "%012d" % inst["image_id"]
    if img_key not in img_grp:
        img_grp.create_dataset(img_key, data=img, chunks=None)
        concat = np.stack([mask_miss, mask_all], axis=2)
        mask_grp.create_dataset(img_key, data=concat, chunks=None)
    inst = dict(inst)
    inst["count"] = count
    required = {"image": img_key, "joints": inst["joints"],
                "objpos": inst["objpos"], "scale_provided": inst["scale_provided"]}
    ds = data_grp.create_dataset("%07d" % count, data=json.dumps(required),
                                 chunks=None)
    ds.attrs["meta"] = json.dumps(inst)


def build(coco_dir: str, out_dir: str, max_images: int = -1) -> None:
    import h5py

    from improved_body_parts_tpu_torch.utils.imageio import (
        ImageDecodeError, imread,
    )
    try:
        from pycocotools.coco import COCO
    except ImportError:
        # dependency-free fallback: polygon + RLE decoding in numpy/cv2
        from improved_body_parts_tpu_torch.data.coco_shim import MiniCOCO as COCO

    specs = [
        ("person_keypoints_val2017.json", "val2017", "COCO_val"),
        ("person_keypoints_train2017.json", "train2017", "COCO"),
    ]
    os.makedirs(out_dir, exist_ok=True)
    tr = h5py.File(os.path.join(out_dir, "coco_train_dataset512.h5"), "w")
    va = h5py.File(os.path.join(out_dir, "coco_val_dataset512.h5"), "w")
    groups = {f: (f.create_group("dataset"), f.create_group("images"),
                  f.create_group("masks")) for f in (tr, va)}
    counts = {tr: 0, va: 0}

    for ann_name, img_subdir, ds_type in specs:
        ann_file = os.path.join(coco_dir, "annotations", ann_name)
        if not os.path.exists(ann_file):
            print(f"skip missing {ann_file}")
            continue
        coco = COCO(ann_file)
        ids = list(coco.imgs.keys())
        if max_images > 0:
            ids = ids[:max_images]
        for img_idx, img_id in enumerate(ids):
            ann_ids = coco.getAnnIds(imgIds=img_id)
            anns = coco.loadAnns(ann_ids)
            if not anns:
                continue
            meta = coco.imgs[img_id]
            path = os.path.join(coco_dir, img_subdir, meta["file_name"])
            try:
                img = imread(path)
            except (OSError, ImageDecodeError):
                continue
            mask_miss, mask_all = make_masks(coco, meta, anns)
            for inst in image_instances(meta, img_id, img_idx, anns, ds_type):
                target = va if inst["isValidation"] else tr
                write_sample(*groups[target], inst, img, mask_miss, mask_all,
                             counts[target])
                counts[target] += 1
    print(f"wrote {counts[tr]} train / {counts[va]} val samples")
    tr.close()
    va.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--coco-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--max-images", type=int, default=-1)
    build(**vars(ap.parse_args()))
