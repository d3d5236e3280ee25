"""Multi-scale TTA evaluation by the reference's host scale loop, as an
independent A/B arm for the fused TTA (``Predictor._tta_maps``).

    python -m improved_body_parts_tpu_torch.tools.eval_tta_split \
        --checkpoint weights.pth --image-dir syn/images --gt-json syn/gt.json \
        [--scale-search 0.5 1 1.5 2] [--dump-name tta_split] [--device cpu]

Port of the repo's ``tools/eval_tta_split.py`` (reference
utils/parse_skeletons.py:186-281: per scale, resize the frame, forward,
resize the maps back, average). For each factor the bucket-padded uint8
frame is resized on the host with ``ops/warp.resize_cubic_u8`` (OpenCV's
uint8 cubic, as the JAX tool's ``cv2.resize``), the flip-averaged stride
maps come from the predictor's forward (``predict_avg_maps`` without the
copy to the host), and they are resized back to the base grid with
``ops/warp.resize_cubic_cv2`` on the device and summed. One
``Predictor._postprocess`` of the average and the C++ grouping follow.
The fused TTA resizes the float frame on the device instead, so the two
arms' inputs differ by the uint8 rounding of the resized frame.

The flags and the results JSON (``<results-dir>/val2017_<dump-name>_
results.json``) and the AP line are the JAX tool's; ``--device``,
``--dtype`` and ``--results-dir`` are the port's. Images are read with
``utils/imageio`` (PNG without cv2). Runs on the card unless ``--device
cpu`` is given, and raises when there is no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch


def split_tta_maps(predictor, img: np.ndarray, factors: Sequence[float]):
    """Per-scale forward, maps resized back on the device -> (the average
    of the flip-averaged stride-4 maps on the base padded grid, (bh4, bw4,
    50) float32 on the predictor's device; (orig_h, orig_w))."""
    from improved_body_parts_tpu_torch.configs import NUM_LAYERS
    from improved_body_parts_tpu_torch.ops.warp import (
        resize_cubic_cv2, resize_cubic_u8,
    )

    stride = predictor.config.stride
    padded, orig_hw = predictor._pad(img)
    ph, pw = padded.shape[:2]
    bh4, bw4 = ph // stride, pw // stride
    acc = torch.zeros((bh4, bw4, NUM_LAYERS), dtype=torch.float32,
                      device=predictor.device)
    with torch.inference_mode():
        for f in factors:
            sh, sw = int(round(ph * f)), int(round(pw * f))
            scaled = padded if f == 1.0 else resize_cubic_u8(padded, (sw, sh))
            maps = predictor._maps(predictor._pad(scaled)[0][None])[0]
            vh = max(int(round(sh / stride)), 1)
            vw = max(int(round(sw / stride)), 1)
            acc += resize_cubic_cv2(maps[:vh, :vw].float(), bh4, bw4)
    return acc / len(factors), orig_hw


def skeletons(predictor, img: np.ndarray, factors: Sequence[float]):
    """One BGR uint8 frame -> (keypoints (N, 18, 3), scores (N,)) through
    the split TTA maps, ``_postprocess`` and the grouping."""
    from improved_body_parts_tpu_torch.infer.predict import unpack_results
    from improved_body_parts_tpu_torch.ops import group

    avg, (h, w) = split_tta_maps(predictor, img, factors)
    dev = predictor.device
    with torch.inference_mode():
        packed = predictor._postprocess(
            avg[None], torch.tensor([h], dtype=torch.float32, device=dev),
            torch.tensor([[h, w]], dtype=torch.float32, device=dev))[0]
    peaks_np, conns_np = unpack_results(packed[0].cpu().numpy(),
                                        predictor.config.infer.max_peaks)
    table, cands = predictor._group(peaks_np, conns_np, None)
    return group.humans_to_keypoints(table, cands)


def evaluate_split(predictor, frames, scale_search: Sequence[float],
                   scale_quant: int = 4, log=print):
    """The split arm over (image_id, BGR uint8) frames, each at the
    reference's per-image factors (``apps.evaluate.image_scales``) ->
    ``apps.evaluate.EvalRun``."""
    from improved_body_parts_tpu_torch.apps.evaluate import (
        EvalRun, append_result, image_scales,
    )

    boxsize = predictor.config.infer.boxsize
    outputs, ids, seconds = [], [], 0.0
    for n, (image_id, img) in enumerate(frames):
        t0 = time.time()
        factors = image_scales(scale_search, boxsize, img.shape[0], scale_quant)
        kps, scores = skeletons(predictor, img, factors)
        seconds += time.time() - t0
        ids.append(image_id)
        append_result(image_id, kps, scores, outputs)
        if n % 50 == 0:
            log(f"[{n}/{len(frames)}] {len(ids) / max(seconds, 1e-9):.2f} FPS avg")
    return EvalRun(outputs, ids, seconds)


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        DTYPES, build_predictor, default_device,
    )
    from improved_body_parts_tpu_torch.apps.evaluate import ap_line, score
    from improved_body_parts_tpu_torch.utils.imageio import imread

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference-layout torch .pth")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--gt-json", default="")
    ap.add_argument("--scale-search", type=float, nargs="+",
                    default=[0.5, 1.0, 1.5, 2.0])
    ap.add_argument("--scale-quant", type=int, default=4,
                    help="same semantics as apps.evaluate --scale-quant")
    ap.add_argument("--refine", default="bicubic")
    ap.add_argument("--dump-name", default="tta_split")
    ap.add_argument("--max-images", type=int, default=-1)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="type the network's convs run in")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    predictor = build_predictor(args.checkpoint, args.config, args.refine,
                                device=device, dtype=DTYPES[args.dtype])
    names = sorted(n for n in os.listdir(args.image_dir)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    gt_data = None
    if args.gt_json:
        with open(args.gt_json) as f:
            gt_data = json.load(f)
        by_name = {im["file_name"]: im["id"] for im in gt_data["images"]}
        images = [(by_name[n], os.path.join(args.image_dir, n))
                  for n in names if n in by_name]
    else:
        images = [(i, os.path.join(args.image_dir, n))
                  for i, n in enumerate(names)]
    if args.max_images > 0:
        images = images[:args.max_images]
    print(f"evaluating {len(images)} images "
          f"(split-TTA scales {args.scale_search})")

    frames = [(i, imread(p)) for i, p in images]
    run = evaluate_split(predictor, frames, args.scale_search, args.scale_quant)
    out = os.path.join(args.results_dir, f"val2017_{args.dump_name}_results.json")
    os.makedirs(args.results_dir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(run.outputs, f)
    print(f"wrote {len(run.outputs)} detections to {out} "
          f"(avg {len(run.image_ids) / max(run.seconds, 1e-9):.2f} FPS)")
    if gt_data is not None and run.outputs:
        print(ap_line(score(gt_data, run.outputs, run.image_ids)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
