"""COCO -> records -> training with the port, against the JAX builder.

A synthetic COCO is written with the port's ``make_synthetic_coco`` in the
COCO layout (``annotations/person_keypoints_{val,train}2017.json`` and
``{val,train}2017/``). Its ground truth has no ``segmentation``, so each
person gets its box as a polygon, and one image gets an RLE crowd region
and a person without keypoints. Both builders (the port's
``data/build_records`` and the JAX package's) turn it into the reference's
h5 pair; the files must agree group by group, dataset by dataset (values,
types, shapes) and attribute by attribute. Then the port's
``CocoH5Dataset`` reads the port's file and the tiny model takes one train
step on it on the CPU.
"""

import json
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from improved_body_parts_tpu.data import build_records as jbuild_records
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.data import build_records
from improved_body_parts_tpu_torch.data.pipeline import CocoH5Dataset
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.tools import make_synthetic_coco
from tests.test_builder_seam import mask_to_uncompressed_rle
from tests.test_torch_predict import (  # noqa: F401  (autouse fixture)
    _config, single_torch_thread,
)

IMAGE = 256
SPLITS = (("val2017", "person_keypoints_val2017.json"),
          ("train2017", "person_keypoints_train2017.json"))


def _synthetic_coco_dir(root):
    """The port's synthetic set in the COCO layout, with segmentations."""
    make_synthetic_coco.main(["--out-dir", os.path.join(root, "syn"),
                              "--n-images", "4", "--size", str(IMAGE),
                              "--seed", "21", "--max-people", "3"])
    with open(os.path.join(root, "syn", "gt.json")) as f:
        gt = json.load(f)
    for ann in gt["annotations"]:
        x, y, w, h = ann["bbox"]
        ann["segmentation"] = [[x, y, x + w, y, x + w, y + h, x, y + h]]
    crowd = np.zeros((IMAGE, IMAGE), np.uint8)
    crowd[:20, :30] = 1
    n = len(gt["annotations"])
    gt["annotations"] += [
        {"id": n + 1, "image_id": 0, "category_id": 1, "iscrowd": 1,
         "segmentation": mask_to_uncompressed_rle(crowd), "area": 600.0,
         "bbox": [0.0, 0.0, 30.0, 20.0], "keypoints": [0] * 51,
         "num_keypoints": 0},
        {"id": n + 2, "image_id": 1, "category_id": 1, "iscrowd": 0,
         "segmentation": [[200.0, 200.0, 240.0, 200.0, 240.0, 250.0]],
         "area": 1000.0, "bbox": [200.0, 200.0, 40.0, 50.0],
         "keypoints": [0] * 51, "num_keypoints": 0}]
    os.makedirs(os.path.join(root, "annotations"))
    for sub, ann_name in SPLITS:
        shutil.copytree(os.path.join(root, "syn", "images"), os.path.join(root, sub))
        with open(os.path.join(root, "annotations", ann_name), "w") as f:
            json.dump(gt, f)
    return gt


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    gt = _synthetic_coco_dir(root)
    build_records.build(root, os.path.join(root, "port"))
    jbuild_records.build(root, os.path.join(root, "jax"))
    return root, gt


def _walk(f):
    """{path: h5py object} of every group and dataset in the file."""
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj))
    return out


@pytest.mark.parametrize("split", ["train", "val"])
def test_both_builders_write_the_same_file(built, split):
    root, _ = built
    name = f"coco_{split}_dataset512.h5"
    with h5py.File(os.path.join(root, "port", name), "r") as a, \
            h5py.File(os.path.join(root, "jax", name), "r") as b:
        mine, ref = _walk(a), _walk(b)
        assert sorted(mine) == sorted(ref)
        assert len(a["dataset"]) > 0
        for path, obj in ref.items():
            got = mine[path]
            assert type(got) is type(obj), path
            assert dict(got.attrs) == dict(obj.attrs), path
            if isinstance(obj, h5py.Dataset):
                assert got.dtype == obj.dtype and got.shape == obj.shape, path
                assert np.array_equal(got[()], obj[()]), path


def test_records_hold_the_masks_and_people(built):
    """The crowd region and the person without keypoints are missed in
    mask_miss; every keypointed person of an image rides in its samples."""
    root, gt = built
    with h5py.File(os.path.join(root, "port", "coco_val_dataset512.h5"), "r") as f:
        masks = f["masks"]["%012d" % 0][()]
        assert masks.shape == (IMAGE, IMAGE, 2)
        assert masks[5, 5, 0] == 0 and masks[5, 5, 1] == 255        # crowd
        metas = [json.loads(f["dataset"][k].attrs["meta"]) for k in f["dataset"]]
        other = f["masks"]["%012d" % 1][()]
        assert other[230, 235, 0] == 0                                # no keypoints
    assert all(m["isValidation"] == 1 for m in metas)
    for m in metas:
        people = [a for a in gt["annotations"]
                  if a["image_id"] == m["image_id"] and a["num_keypoints"] > 0]
        assert len(m["joints"]) == len(people) == m["numOtherPeople"] + 1


def test_port_records_train_a_step(built):
    root, _ = built
    config = _config()
    ds = CocoH5Dataset(os.path.join(root, "port", "coco_val_dataset512.h5"),
                       config, augment=True)
    assert len(ds) > 0
    g = torch.Generator().manual_seed(0)
    model = PoseNet(config.model, compute_dtype=torch.float32, generator=g)
    state = train_lib.create_train_state(model, config.train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = train_lib.make_train_step(model, config)
    for imgs, mask, heat in ds.batches(batch_size=2, steps=1, seed=3):
        assert imgs.shape == (2, config.height, config.width, 3)
        metrics = step(state, torch.from_numpy(imgs), torch.from_numpy(mask),
                       torch.from_numpy(heat), 1e-3)
    assert torch.isfinite(metrics["loss"]) and float(metrics["skipped"]) == 0.0
    moved = [k for k, v in model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert moved, "the step changed no parameter"
