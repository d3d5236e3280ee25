"""AP against the epoch over the per-epoch checkpoints of one training run.

    python -m improved_body_parts_tpu_torch.tools.eval_curve --ckpt-root ck \
        --image-dir syn/images --gt-json syn/gt.json --epochs 1 3 5 --swa

Port of the JAX package's ``tools/eval_curve.py``. It reads the checkpoints
``apps.train -p <ckpt-root>`` writes: ``pth/epoch_<N>.pth`` for each of
``--epochs`` and, with ``--swa``, the newest of ``pth_swa/``. One predictor
is built and each arm's weights are copied into its model in place (the
shapes do not change, so neither do the kernels or cuDNN's plans). Each
arm scores the same images with the port's OKS evaluator
(``utils/oks_eval.KeypointEval``) through ``apps.evaluate.evaluate_frames``
(``predict_skeletons`` per image, as the JAX tool), and prints one JSON row
with the JAX tool's keys (``arm``, ``ap``, ``ap50``, ``ap75``, ``ar``,
``n_dets``, ``seconds``). A missing checkpoint is reported and skipped, as
there. ``curve`` takes frames already in memory; ``main`` reads the
images with ``utils/imageio.imread`` (PNG without cv2, so also on the
card's machine).

Runs on the card unless ``--device cpu`` is given, and raises when there is
no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple


def arms(ckpt_root: str, epochs: Sequence[int],
         swa: bool = False) -> List[Tuple[str, Optional[str]]]:
    """[(arm name, .pth path or None when there is none)]: ``epoch<N>``
    for each epoch, then ``swa`` (the newest of ``pth_swa/``)."""
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt_lib
    out = []
    for e in epochs:
        path = ckpt_lib.checkpoint_path(os.path.join(ckpt_root, "pth"), e)
        out.append((f"epoch{e}", path if os.path.isfile(path) else None))
    if swa:
        swa_dir = os.path.join(ckpt_root, "pth_swa")
        steps = ckpt_lib.saved_steps(swa_dir)
        out.append(("swa", ckpt_lib.checkpoint_path(swa_dir, steps[-1])
                    if steps else None))
    return out


def curve(predictor, arm_paths: Sequence[Tuple[str, Optional[str]]],
          frames, gt_data: Dict, log=print) -> List[Dict]:
    """Score each arm's weights, copied into ``predictor.model`` in place,
    on ``frames`` ([(image_id, BGR uint8)]) against ``gt_data``; one row
    an arm that has a checkpoint."""
    import torch

    from improved_body_parts_tpu_torch.apps.evaluate import evaluate_frames
    from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth
    from improved_body_parts_tpu_torch.utils.oks_eval import KeypointEval

    rows = []
    for name, path in arm_paths:
        if path is None:
            log(f"{name}: skip (no checkpoint)")
            continue
        with torch.no_grad():
            predictor.model.load_state_dict(load_reference_pth(path), strict=True)
        run = evaluate_frames(predictor, frames)
        stats = KeypointEval(gt_data, run.outputs, img_ids=run.image_ids).run(
            print_fn=log)
        rows.append(dict(arm=name, ap=round(float(stats[0]), 4),
                         ap50=round(float(stats[1]), 4),
                         ap75=round(float(stats[2]), 4),
                         ar=round(float(stats[5]), 4), n_dets=len(run.outputs),
                         seconds=round(run.seconds, 1)))
        log(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        build_predictor, default_device,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-root", required=True,
                    help="apps.train -p dir (holds pth/ and pth_swa/)")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--epochs", type=int, nargs="+", required=True)
    ap.add_argument("--swa", action="store_true",
                    help="also score the SWA-averaged model (pth_swa/)")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--out-json", default="",
                    help="write the curve as one json list")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    from improved_body_parts_tpu_torch.utils.imageio import imread

    device = default_device(args.device)
    with open(args.gt_json) as f:
        gt_data = json.load(f)
    by_name = {im["file_name"]: im["id"] for im in gt_data["images"]}
    images = sorted((by_name[n], os.path.join(args.image_dir, n))
                    for n in os.listdir(args.image_dir) if n in by_name)
    frames = [(i, imread(p)) for i, p in images]
    print(f"{len(frames)} images, epochs {args.epochs}"
          f"{' + swa' if args.swa else ''}")
    predictor = build_predictor("", args.config, device=device)
    rows = curve(predictor, arms(args.ckpt_root, args.epochs, args.swa),
                 frames, gt_data)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
