"""End-to-end trained-checkpoint smoke: train -> checkpoint -> detect.

    python -m improved_body_parts_tpu_torch.tools.e2e_trained_smoke \
        --checkpoint ck/pth/epoch_2.pth [--image-size 512] [--scenes 3]

Port of the JAX package's ``tools/e2e_trained_smoke.py``. It renders
held-out synthetic scenes (seed ``--seed`` + i, at most 2 people, seeds the
training never draws), runs the whole serving path (``predict_skeletons``)
with the checkpoint's weights, matches each ground-truth person to its
nearest detection by mean joint distance (over the detection's visible
joints, at least 4 of them), and prints a line a scene. The exit code is 0
only if every person of every scene is found under ``--tol`` pixels.
``score_scenes`` is the scoring, on a predictor already built.

Runs on the card unless ``--device cpu`` is given, and raises when there is
no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Tuple

import numpy as np


def score_scene(kps: np.ndarray, joints: np.ndarray, tol: float) -> Tuple[int, float]:
    """(people found under ``tol``, mean of the matched errors; inf when no
    person matched any detection) for detections ``kps`` (N, 18, 3) and
    ground truth ``joints`` (M, 18, 3)."""
    errs = []
    for gt in joints:
        best = None
        for det in kps:
            vis = det[:, 2] > 0
            if vis.sum() < 4:
                continue
            d = np.linalg.norm(det[vis, :2] - gt[vis, :2], axis=1).mean()
            best = d if best is None else min(best, d)
        errs.append(best)
    found = int(sum(e is not None and e < tol for e in errs))
    matched = [e for e in errs if e is not None]
    return found, (float(np.mean(matched)) if matched else float("inf"))


def score_scenes(predictor, size: int, scenes: int = 3, seed: int = 777,
                 tol: float = 10.0, log=print) -> Tuple[bool, List[dict]]:
    """The smoke on ``predictor``: (every person of every scene found under
    ``tol``, a row a scene)."""
    from improved_body_parts_tpu_torch.data.synthetic import (
        random_people, render_image,
    )
    ok, rows = True, []
    for si in range(scenes):
        rng = np.random.RandomState(seed + si)
        joints = random_people(rng, size, size, max_people=2)
        img = (render_image(joints, size, size, rng) * 255).astype(np.uint8)
        kps, _, aux = predictor.predict_skeletons(img)
        found, mean_err = score_scene(kps, joints, tol)
        row = dict(scene=si, people=len(joints), matched=found,
                   mean_err_px=mean_err, detections=len(kps),
                   dropped_peaks=int(aux["peaks_dropped"].sum()),
                   ok=found == len(joints))
        rows.append(row)
        log(f"scene {si}: {len(joints)} people, matched {found}, mean joint "
            f"err {mean_err:.2f}px, detections {len(kps)}, dropped_peaks "
            f"{row['dropped_peaks']}  [{'OK' if row['ok'] else 'MISS'}]")
        ok &= row["ok"]
    return ok, rows


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        build_predictor, default_device,
    )
    from improved_body_parts_tpu_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="reference-layout .pth (an apps.train epoch .pth)")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--tol", type=float, default=10.0,
                    help="the largest mean joint error accepted (pixels)")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.checkpoint):
        raise FileNotFoundError(f"no checkpoint at {args.checkpoint}")
    device = default_device(args.device)
    config = get_config(args.config)
    if args.image_size != config.height:
        config = dataclasses.replace(config, width=args.image_size,
                                     height=args.image_size)
    predictor = build_predictor(args.checkpoint, config, device=device)
    ok, _ = score_scenes(predictor, args.image_size, args.scenes, args.seed,
                         args.tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
