"""Minimal COCO-annotation API shim: the subset of pycocotools needed by
the offline builder (data/build_records.py), dependency-free.

The port's copy of ``improved_body_parts_tpu/data/coco_shim.py`` (held
against it in tests/test_torch_shared.py).

The reference builder hard-requires pycocotools for COCO() + annToMask()
(reference data/coco_masks_hdf5.py:317-364); this shim decodes the same
annotation formats with numpy + cv2 so the builder seam works in
environments without the compiled extension:

  * polygon segmentations -> cv2.fillPoly (boundary pixels may differ from
    pycocotools' own rasterizer by <=1 px — irrelevant for the 0/255
    training masks, which are downsampled to stride resolution anyway),
  * uncompressed RLE ({"counts": [..ints..], "size": [h, w]}),
  * compressed RLE ({"counts": "<ascii>", "size": [h, w]}) via the COCO
    LEB128-style varint coding with delta-encoded runs.

build_records imports pycocotools when available and falls back to this.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np


def decode_rle_counts(s: str) -> List[int]:
    """COCO compressed-RLE counts string -> run lengths (column-major runs,
    alternating background/foreground, starting with background)."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]          # runs >2 are delta-coded
        counts.append(x)
    return counts


def rle_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_rle_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((h, w), order="F")   # runs go down columns


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    import cv2
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


class MiniCOCO:
    """pycocotools.coco.COCO lookalike over a COCO-format annotation json
    (images / annotations / categories), covering the builder's usage:
    .imgs, getAnnIds(imgIds=), loadAnns(ids), annToMask(ann)."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        self.imgs = {im["id"]: im for im in self.dataset.get("images", [])}
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self._by_img = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            self._by_img[a["image_id"]].append(a["id"])

    def getAnnIds(self, imgIds=None, **_unused):
        if imgIds is None:
            return sorted(self.anns.keys())
        if np.isscalar(imgIds):
            imgIds = [imgIds]
        return [i for img in imgIds for i in self._by_img[img]]

    def loadAnns(self, ids):
        if np.isscalar(ids):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def annToMask(self, ann) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            return rle_to_mask(seg, h, w)
        return polygons_to_mask(seg, h, w)
