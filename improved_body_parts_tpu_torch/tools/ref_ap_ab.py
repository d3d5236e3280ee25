"""AP A/B of the reference's own inference stack against the port's, with
the same weights on the same images.

    python -m improved_body_parts_tpu_torch.tools.ref_ap_ab \
        --checkpoint weights.pth --image-dir syn/images --gt-json syn/gt.json \
        [--boxsize 256] [--device cpu]

Port of the repo's ``tools/ref_ap_ab.py``. The reference arm is the
reference checkout's torch stack, unchanged (the directory that
``REFERENCE_DIR`` names; there is no default): its ``PoseNet`` (models/posenet.py:50-122) with the
weights of a reference-layout ``.pth``, then ``predict_refactor``,
``heatmap_nms``, ``find_connections`` and ``find_humans``
(utils/parse_skeletons.py:28-103, 126-176, 324-600; the refactor branch of
the reference's evaluate.py), on the CPU with its ``.cuda()`` calls made
no-ops, as the JAX tool runs it. The port's arm is what ``apps.evaluate``
runs on the same ``.pth`` and images (``build_predictor``, fp32, and
``evaluate_frames``), which the JAX tool leaves to a separate
``evaluate.py`` run. Both arms format with ``apps.evaluate.append_result``
and score with ``utils/oks_eval.KeypointEval``, so an AP difference is the
pipelines'.

Writes ``<results-dir>/<dump-name>_results.json`` (the reference arm, the
JAX tool's file) and ``<dump-name>_ours_results.json``, and prints both
arms' AP lines. Images are read with ``utils/imageio`` (PNG without cv2);
the reference stack itself needs cv2. The port's arm runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import torch



def reference_dir() -> str:
    """The reference checkout that ``REFERENCE_DIR`` names, or "" when it is
    unset: nothing outside the caller's choice is read."""
    return os.environ.get("REFERENCE_DIR", "")


def import_reference() -> None:
    """Put the reference checkout on ``sys.path``, with stand-ins for the
    modules it imports and does not use here (thop, torchvision)."""
    reference = reference_dir()
    if not reference:
        raise FileNotFoundError("no reference checkout: set REFERENCE_DIR")
    if not os.path.isdir(reference):
        raise FileNotFoundError(f"no reference checkout at {reference} "
                                "(REFERENCE_DIR)")
    sys.path.insert(0, reference)
    thop = types.ModuleType("thop")
    thop.profile = lambda *a, **k: (0, 0)
    sys.modules.setdefault("thop", thop)
    tv = types.ModuleType("torchvision")
    tvm = types.ModuleType("torchvision.models")
    tvm.densenet = types.ModuleType("torchvision.models.densenet")
    tv.models = tvm
    sys.modules.setdefault("torchvision", tv)
    sys.modules.setdefault("torchvision.models", tvm)
    sys.modules.setdefault("torchvision.models.densenet", tvm.densenet)


def reference_net(model_cfg, state_dict):
    """The reference ``PoseNet`` of ``model_cfg`` with ``state_dict``, on the
    CPU in eval mode."""
    from models.posenet import PoseNet

    net = PoseNet(model_cfg.nstack, model_cfg.inp_dim, model_cfg.oup_dim,
                  bn=True, increase=model_cfg.increase)
    net.load_state_dict(state_dict)
    return net.eval()


def reference_detections(net, frames, config, boxsize: int, thre1: float,
                         log=print):
    """The reference stack over (image_id, path, BGR uint8) frames -> COCO
    keypoint results."""
    import cv2
    import utils.parse_skeletons as rps

    from improved_body_parts_tpu_torch.apps.evaluate import append_result
    from improved_body_parts_tpu_torch.ops import group

    # the reference INI's defaults (reference utils/config:1-40);
    # predict_refactor hardcodes multiplier=[1.] (parse_skeletons.py:36-38),
    # so scale_search is inert
    test_cfg = dict(scale_search=[1.0], rotation_search=[0.0],
                    thre1=thre1, thre2=0.1, connect_ration=0.8, mid_num=20,
                    len_rate=16, connection_tole=0.7, remove_recon=0)
    model_cfg = dict(boxsize=boxsize, max_downsample=64, padValue=128, stride=4)
    cfg_ns = types.SimpleNamespace(
        flip_heat_ord=config.flip_heat_ord, flip_paf_ord=config.flip_paf_ord,
        paf_layers=config.paf_layers, num_layers=config.num_layers)
    pairs = [tuple(p) for p in config.limbs_conn]
    outputs = []
    t0 = time.time()
    orig_cuda = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self      # predict_refactor's .cuda()
    try:
        for n, (image_id, path, img) in enumerate(frames):
            with torch.no_grad():
                heat, paf = rps.predict_refactor(img, net, test_cfg, model_cfg,
                                                 path, flip_avg=True,
                                                 config=cfg_ns)
            peaks = rps.heatmap_nms(heat, upsample_factor=4.0)
            paf_up = cv2.resize(paf, None, fx=4, fy=4,
                                interpolation=cv2.INTER_CUBIC)
            conns, special = rps.find_connections(peaks, paf_up, img.shape[0],
                                                  test_cfg, pairs)
            table, cands = rps.find_humans(conns, special, peaks, test_cfg, pairs)
            kps, scores = group.humans_to_keypoints(np.asarray(table),
                                                    np.asarray(cands))
            append_result(image_id, kps, scores, outputs)
            if n % 8 == 0:
                log(f"[{n + 1}/{len(frames)}] {len(scores)} persons "
                    f"({(time.time() - t0) / (n + 1):.1f} s/img)")
    finally:
        torch.Tensor.cuda = orig_cuda
    return outputs


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        build_predictor, default_device,
    )
    from improved_body_parts_tpu_torch.apps.evaluate import (
        ap_line, evaluate_frames, score,
    )
    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth
    from improved_body_parts_tpu_torch.utils.imageio import imread

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", "-p", required=True,
                    help="reference-layout torch .pth")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--boxsize", type=int, default=0,
                    help="override config boxsize (match the training res)")
    ap.add_argument("--max-images", type=int, default=-1)
    ap.add_argument("--dump-name", default="reference_ab")
    ap.add_argument("--thre1", type=float, default=0.1)
    ap.add_argument("--nstack", type=int, default=0,
                    help="override config nstack (tiny-model testing)")
    ap.add_argument("--inp-dim", type=int, default=0)
    ap.add_argument("--increase", type=int, default=0)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default=None,
                    help="the port's arm: cpu, or a CUDA device (default: "
                         "the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    config = get_config(args.config)
    m = dataclasses.replace(config.model, nstack=args.nstack or config.model.nstack,
                            inp_dim=args.inp_dim or config.model.inp_dim,
                            increase=args.increase or config.model.increase)
    boxsize = args.boxsize or config.infer.boxsize
    config = dataclasses.replace(config, model=m, infer=dataclasses.replace(
        config.infer, boxsize=boxsize, thre1=args.thre1))

    with open(args.gt_json) as f:
        gt_data = json.load(f)
    by_name = {im["file_name"]: im["id"] for im in gt_data["images"]}
    images = sorted((by_name[n], os.path.join(args.image_dir, n))
                    for n in os.listdir(args.image_dir) if n in by_name)
    if args.max_images > 0:
        images = images[:args.max_images]
    frames = [(i, p, imread(p)) for i, p in images]
    ids = [i for i, _ in images]

    import_reference()
    sd = load_reference_pth(args.checkpoint)
    net = reference_net(m, sd)
    print(f"loaded {len(sd)} tensors into the reference PoseNet "
          f"(nstack={m.nstack}, inp_dim={m.inp_dim}); {len(frames)} images "
          f"through the REFERENCE stack (torch CPU, boxsize {boxsize})")
    t0 = time.time()
    ref_out = reference_detections(net, frames, config, boxsize, args.thre1)
    ref_s = time.time() - t0

    predictor = build_predictor(args.checkpoint, config, device=device,
                                dtype=torch.float32)
    ours = evaluate_frames(predictor, [(i, img) for i, _, img in frames])

    os.makedirs(args.results_dir, exist_ok=True)
    for suffix, outputs in (("", ref_out), ("_ours", ours.outputs)):
        path = os.path.join(args.results_dir,
                            f"{args.dump_name}{suffix}_results.json")
        with open(path, "w") as f:
            json.dump(outputs, f)
        print(f"wrote {len(outputs)} detections to {path}")
    quiet = lambda *a: None                                    # noqa: E731
    print(f"REFERENCE-STACK {ap_line(score(gt_data, ref_out, ids, quiet))} "
          f"({ref_s / max(len(frames), 1):.2f} s/img)")
    print(f"PORT ({device}) {ap_line(score(gt_data, ours.outputs, ids, quiet))} "
          f"({ours.seconds / max(len(frames), 1):.2f} s/img)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
