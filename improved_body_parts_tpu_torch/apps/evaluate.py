"""COCO keypoint evaluation with the port (the JAX package's
``evaluate.py`` with the same flags).

    python -m improved_body_parts_tpu_torch.apps.evaluate \
        --checkpoint weights.pth --image-dir DIR --gt-json gt.json \
        [--scale-search 0.5 1 1.5 2] [--letterbox --pipeline 4] [--device cpu]

It runs on the card unless ``--device cpu`` is given (``default_device``).

The evaluation itself is ``evaluate_frames``, over frames already in
memory; ``main`` reads the images (``utils/imageio.imread``: PNG without
cv2, so also on the card's machine; other formats through cv2), writes
``<results-dir>/<subset>_<dump-name>_results.json`` and scores it: with the
port's ``utils/oks_eval`` for ``--gt-json``, and for a COCO
directory with pycocotools where it is installed. ``synthetic_coco`` makes
frames and their COCO-format ground truth in memory (the scenes of
``tools/make_synthetic_coco.py``), without cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from improved_body_parts_tpu_torch.apps.demo_image import (
    DTYPES, build_predictor, default_device,
)
from improved_body_parts_tpu_torch.configs import ORDER_COCO
from improved_body_parts_tpu_torch.data.synthetic import random_people, render_image
from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
from improved_body_parts_tpu_torch.utils import imageio
from improved_body_parts_tpu_torch.utils.oks_eval import KeypointEval

NUM_COCO_KEYPOINTS = 17
COCO_KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle",
    "right_ankle"]


def to_coco_keypoints(kps: np.ndarray) -> np.ndarray:
    """(18, 3) CMU-order -> (17, 3) COCO-order (reference evaluate.py:40,169)."""
    return kps[ORDER_COCO, :]


def append_result(image_id, kps_list, scores, all_outputs) -> None:
    """One image's people -> COCO result dicts (reference
    evaluate.py:182-232, refactor-path branch)."""
    for kps, score in zip(kps_list, scores):
        coco_kps = to_coco_keypoints(kps)
        out = np.zeros((NUM_COCO_KEYPOINTS, 3), np.float64)
        out[:, :2] = coco_kps[:, :2]
        out[:, 2] = (coco_kps[:, 2] > 0).astype(np.float64)
        all_outputs.append({
            "image_id": int(image_id),
            "category_id": 1,
            "keypoints": [float(x) for x in out.reshape(-1)],
            "score": float(score),
        })


def image_scales(scale_search: Sequence[float], boxsize: int, img_h: int,
                 quant: int) -> Tuple[float, ...]:
    """The reference protocol's per-image TTA factors s * boxsize / img_h
    (parse_skeletons.py:186), quantised to 1/``quant`` steps (0 = exact)."""
    return tuple(sorted({
        max(round(s * boxsize / img_h * quant) / quant, 0.25) if quant > 0
        else s * boxsize / img_h
        for s in scale_search}))


class EvalRun(NamedTuple):
    outputs: List[Dict]       # COCO keypoint results
    image_ids: List[int]      # the images evaluated
    seconds: float            # device + host time over those images


def evaluate_frames(predictor, frames: Sequence[Tuple[int, np.ndarray]], *,
                    scale_search: Optional[Sequence[float]] = None,
                    scale_quant: int = 4,
                    rotation_search: Optional[Sequence[float]] = None,
                    letterbox: bool = False, pipeline: int = 0,
                    pipeline_batch: int = 8, run_cpp: bool = False,
                    show_eval_speed: bool = False) -> EvalRun:
    """Run ``predictor`` over (image_id, BGR uint8) frames, as the JAX
    ``evaluate.py`` loop does: per image through ``predict_skeletons``, or
    with ``pipeline`` (needs ``letterbox``) through ``PipelinedServer``
    with that many batches in flight."""
    use_cpp = True if run_cpp else None
    angles = tuple(rotation_search) if rotation_search else (0.0,)
    outputs: List[Dict] = []
    if pipeline:
        if not letterbox:
            raise ValueError("--pipeline requires --letterbox")
        # letterboxed content height ~= boxsize, so the reference's
        # per-image multiplier (scale * boxsize / img_h) is the scale itself
        scales = tuple(scale_search) if scale_search else None
        serve = PipelinedServer(predictor, batch_size=pipeline_batch,
                                depth=pipeline, use_cpp=use_cpp,
                                scales=scales, angles=angles)
        size = predictor.config.infer.boxsize
        warm = np.zeros((pipeline_batch, size, size, 3), np.uint8)
        predictor.predict_batch(warm, scales=scales, angles=angles)
        try:
            t0 = time.time()
            futs = [(image_id, serve.submit(img)) for image_id, img in frames]
            for image_id, fut in futs:
                kps, scores = fut.result()
                append_result(image_id, kps, scores, outputs)
            seconds = time.time() - t0
        finally:
            serve.close()
        return EvalRun(outputs, [i for i, _ in futs], seconds)

    seconds, ids = 0.0, []
    for n, (image_id, img) in enumerate(frames):
        t0 = time.time()
        scales = None
        if scale_search:
            scales = (tuple(scale_search) if letterbox else image_scales(
                scale_search, predictor.config.infer.boxsize, img.shape[0],
                scale_quant))
        kps, scores, _ = predictor.predict_skeletons(
            img, use_cpp=use_cpp, scales=scales, fixed_size=letterbox,
            angles=angles)
        dt = time.time() - t0
        seconds += dt
        ids.append(image_id)
        append_result(image_id, kps, scores, outputs)
        if show_eval_speed and n % 50 == 0:
            print(f"[{n}/{len(frames)}] {1 / dt:.2f} ({len(ids) / seconds:.2f}) FPS")
    return EvalRun(outputs, ids, seconds)


def score(gt_data: Dict, outputs: List[Dict], image_ids: List[int],
          print_fn=print) -> np.ndarray:
    """OKS keypoint AP of ``outputs`` against COCO-format ``gt_data`` with
    the port's evaluator (``utils/oks_eval``); returns its 10 stats."""
    return KeypointEval(gt_data, outputs, img_ids=list(image_ids)).run(
        print_fn=print_fn)


def ap_line(stats: np.ndarray) -> str:
    return (f"AP={stats[0]:.4f} AP50={stats[1]:.4f} AP75={stats[2]:.4f} "
            f"APM={stats[3]:.4f} APL={stats[4]:.4f} AR={stats[5]:.4f}")


def _cmu_to_coco_gt(joints: np.ndarray) -> np.ndarray:
    """(18, 3) CMU-order joints (visibility 1 = visible) -> (17, 3)
    COCO-order with COCO's visibility code (2 = labelled and visible)."""
    out = joints[ORDER_COCO].copy()
    out[:, 2] = np.where(joints[ORDER_COCO, 2] <= 1, 2.0, 0.0)
    return out


def synthetic_coco(n_images: int, size: int = 512, seed: int = 777,
                   max_people: int = 3, sizes: Optional[Sequence[int]] = None):
    """``n_images`` rendered multi-person scenes (``data.synthetic``) as
    [(image_id, BGR uint8 frame)] and their COCO-format ground truth, the
    set ``tools/make_synthetic_coco`` writes to disk. ``sizes`` cycles
    these square sizes over the scenes instead of ``size``."""
    frames, images, annotations = [], [], []
    for i in range(n_images):
        rng = np.random.RandomState(seed * 100003 + i)
        S = sizes[i % len(sizes)] if sizes else size
        joints = random_people(rng, S, S, max_people=max_people)
        frames.append((i, (render_image(joints, S, S, rng) * 255)
                       .astype(np.uint8)))
        images.append({"id": i, "file_name": f"synthetic_{i:06d}.png",
                       "width": S, "height": S})
        for person in joints:
            coco = _cmu_to_coco_gt(person)
            x0, y0 = float(coco[:, 0].min()), float(coco[:, 1].min())
            bw, bh = float(coco[:, 0].max() - x0), float(coco[:, 1].max() - y0)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i, "category_id": 1,
                "keypoints": [round(float(v), 2) for v in coco.reshape(-1)],
                "num_keypoints": int((coco[:, 2] > 0).sum()),
                "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0})
    gt = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person", "supercategory": "person",
                          "keypoints": COCO_KEYPOINT_NAMES}]}
    return frames, gt


def _coco_images(args):
    """(images [(id, path)], gt_data or None, pycocotools COCO or None)."""
    if args.image_dir:
        names = sorted(os.listdir(args.image_dir))
        images = [(i, os.path.join(args.image_dir, n)) for i, n in enumerate(names)
                  if n.lower().endswith((".jpg", ".jpeg", ".png"))]
        gt_data = None
        if args.gt_json:
            with open(args.gt_json) as f:
                gt_data = json.load(f)
            by_name = {im["file_name"]: im["id"] for im in gt_data["images"]}
            images = [(by_name[os.path.basename(p)], p) for _, p in images
                      if os.path.basename(p) in by_name]
        return images, gt_data, None
    ann = ("person_keypoints_val2017.json" if args.subset == "val2017"
           else "image_info_test-dev2017.json")
    ann_file = os.path.join(args.coco_dir, "annotations", ann)
    if not os.path.exists(ann_file):
        raise FileNotFoundError(f"annotations not found: {ann_file}")
    coco_gt = gt_data = None
    try:
        from pycocotools.coco import COCO
        coco_gt = COCO(ann_file)
        img_ids = coco_gt.getImgIds(catIds=coco_gt.getCatIds(catNms=["person"]))
        file_names = {i: coco_gt.imgs[i]["file_name"] for i in img_ids}
    except ImportError:
        with open(ann_file) as f:
            gt_data = json.load(f)
        person_ids = {c["id"] for c in gt_data.get("categories", [])
                      if c.get("name") == "person"} or {1}
        img_ids = sorted({a["image_id"] for a in gt_data.get("annotations", [])
                          if a.get("category_id", 1) in person_ids}) or \
            sorted(im["id"] for im in gt_data["images"])
        file_names = {im["id"]: im["file_name"] for im in gt_data["images"]}
    images = [(i, os.path.join(args.coco_dir, args.subset, file_names[i]))
              for i in img_ids]
    return images, gt_data, coco_gt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="PoseNet evaluation (PyTorch port)")
    parser.add_argument("--checkpoint", "-p", default="",
                        help="reference-layout torch .pth")
    parser.add_argument("--config", default="Canonical")
    parser.add_argument("--coco-dir", default="data/dataset/coco",
                        help="COCO root (annotations/ + val2017/)")
    parser.add_argument("--subset", default="val2017", choices=["val2017", "test2017"])
    parser.add_argument("--image-dir", default="", help="plain image directory mode")
    parser.add_argument("--gt-json", default="",
                        help="COCO-format keypoint GT json to score against "
                             "(with --image-dir; e.g. from "
                             "tools/make_synthetic_coco.py)")
    parser.add_argument("--max-images", type=int, default=-1)
    parser.add_argument("--dump-name", default="torch_imhn")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--run_cpp", action="store_true")
    parser.add_argument("--show_eval_speed", action="store_true")
    parser.add_argument("--scale-search", type=float, nargs="*", default=None,
                        help="multi-scale TTA factors (reference INI scale_search)")
    parser.add_argument("--scale-quant", type=int, default=4,
                        help="quantise per-image scale multipliers to 1/N "
                             "steps (0 = the reference's exact factors)")
    parser.add_argument("--letterbox", action="store_true",
                        help="fixed boxsize^2 letterbox canvas for every image")
    parser.add_argument("--boxsize", type=int, default=0,
                        help="override the model's boxsize (the letterbox "
                             "canvas and scale normalisation target)")
    parser.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                        help="with --letterbox: evaluate through "
                             "PipelinedServer with DEPTH batches in flight")
    parser.add_argument("--pipeline-batch", type=int, default=8)
    parser.add_argument("--refine", default="bicubic",
                        choices=["bicubic", "centroid", "none"],
                        help="peak sub-pixel refinement scheme")
    parser.add_argument("--rotation-search", type=float, nargs="*",
                        default=None, metavar="DEG",
                        help="rotation TTA angles (reference INI rotation_search)")
    parser.add_argument("--quantize", default="", choices=["", "int8"],
                        help="post-training int8 quantization of the forward "
                             "(apps.demo_image.build_predictor)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, and an error when "
                             "no card is visible; pass cpu to run on the CPU)")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                        help="type the network's convs run in")
    args = parser.parse_args(argv)
    if args.pipeline and not args.letterbox:
        parser.error("--pipeline requires --letterbox")

    device = default_device(args.device)
    print(f"device: {device}")
    predictor = build_predictor(args.checkpoint, args.config, args.refine,
                                device=device, quantize=args.quantize,
                                dtype=DTYPES[args.dtype])
    if args.boxsize:
        import dataclasses
        predictor.config = dataclasses.replace(
            predictor.config, infer=dataclasses.replace(
                predictor.config.infer, boxsize=args.boxsize))

    try:
        images, gt_data, coco_gt = _coco_images(args)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if args.max_images > 0:
        images = images[:args.max_images]
    print(f"evaluating {len(images)} images")

    frames = []
    for image_id, path in images:
        try:
            img = imageio.imread(path)
        except (OSError, imageio.ImageDecodeError) as e:
            print(f"skip unreadable {path} ({e})")
            continue
        frames.append((image_id, img))
    run = evaluate_frames(
        predictor, frames, scale_search=args.scale_search,
        scale_quant=args.scale_quant, rotation_search=args.rotation_search,
        letterbox=args.letterbox, pipeline=args.pipeline,
        pipeline_batch=args.pipeline_batch, run_cpp=args.run_cpp,
        show_eval_speed=args.show_eval_speed)

    results_file = os.path.join(args.results_dir,
                                f"{args.subset}_{args.dump_name}_results.json")
    os.makedirs(args.results_dir, exist_ok=True)
    with open(results_file, "w") as f:
        json.dump(run.outputs, f)
    fps = (f" (avg {len(run.image_ids) / run.seconds:.2f} FPS)"
           if run.image_ids and run.seconds > 0 else "")
    print(f"wrote {len(run.outputs)} detections to {results_file}{fps}")

    if coco_gt is not None and run.outputs:
        from pycocotools.cocoeval import COCOeval
        ev = COCOeval(coco_gt, coco_gt.loadRes(results_file), "keypoints")
        ev.params.imgIds = run.image_ids
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
    elif gt_data is not None and run.outputs:
        print(ap_line(score(gt_data, run.outputs, run.image_ids)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
