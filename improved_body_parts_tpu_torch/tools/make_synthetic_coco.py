"""Render held-out synthetic scenes as an image directory and a
COCO-format keypoint GT json, closing the train -> evaluate -> AP loop
without the real COCO dataset (reference protocol: evaluate.py:235-280
over val2017).

    python -m improved_body_parts_tpu_torch.tools.make_synthetic_coco \
        --out-dir syncoco --n-images 64
    python -m improved_body_parts_tpu_torch.apps.evaluate --checkpoint <pth> \
        --image-dir syncoco/images --gt-json syncoco/gt.json

Port of the JAX package's ``tools/make_synthetic_coco.py``: the same
images (decoded pixel for pixel; the PNG files are written by
``utils/imageio``, not cv2, so their bytes differ) and ``gt.json``. The scenes and their ground truth come from
``apps.evaluate.synthetic_coco``, which the evaluator also uses in memory,
so the set written here and the set evaluated without files cannot drift
apart. The GT follows the real annotation schema (images / annotations /
categories, 17 COCO-order keypoints, area, bbox, num_keypoints, iscrowd),
so it also scores under pycocotools where that is installed. Host only, no
card, no cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def write(out_dir: str, frames, gt) -> str:
    """``frames`` ([(image_id, BGR uint8)]) as ``<out_dir>/images/<file
    name of gt>`` PNGs and ``gt`` as ``<out_dir>/gt.json``; the json's
    path."""
    from improved_body_parts_tpu_torch.utils.imageio import imwrite

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    names = {im["id"]: im["file_name"] for im in gt["images"]}
    for image_id, img in frames:
        imwrite(os.path.join(img_dir, names[image_id]), img)
    gt_path = os.path.join(out_dir, "gt.json")
    with open(gt_path, "w") as f:
        json.dump(gt, f)
    return gt_path


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--n-images", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="cycle these image sizes over the scenes (a "
                         "variable-size set: per-image scale factors)")
    ap.add_argument("--seed", type=int, default=777,
                    help="held-out seed family (training draws seed*100003+i "
                         "streams; pick a seed training does not use)")
    ap.add_argument("--max-people", type=int, default=3)
    args = ap.parse_args(argv)

    frames, gt = synthetic_coco(args.n_images, size=args.size, seed=args.seed,
                                max_people=args.max_people, sizes=args.sizes)
    gt_path = write(args.out_dir, frames, gt)
    print(f"wrote {len(gt['images'])} images to "
          f"{os.path.join(args.out_dir, 'images')} and "
          f"{len(gt['annotations'])} annotations to {gt_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
