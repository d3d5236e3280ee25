"""Single-image pose-estimation demo of the port (the JAX package's
``demo_image.py`` with the same flags): flip-TTA forward (plus multi-scale
/ rotation TTA on request), peaks, limbs and greedy selection on the
device, host person assembly, skeleton rendering.

    python -m improved_body_parts_tpu_torch.apps.demo_image --image in.jpg \
        --checkpoint weights.pth --output out.jpg [--device cpu]
    python -m improved_body_parts_tpu_torch.apps.demo_image --synthetic

It runs on the card unless ``--device cpu`` is given, and raises when no card
is visible and no ``--device`` was named.

``--synthetic`` runs the post-processing on a two-person ground-truth
scene (no network, no weights) and exits 0 when it finds both people.
Images are read and written with ``utils/imageio`` (PNG without cv2,
other formats through cv2); drawing the skeletons (``utils/common``)
needs cv2. ``run_synthetic`` and ``build_predictor`` need neither.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import (
    LIMBS_CONN, NUM_PARTS, PAF_LAYERS, CanonicalConfig, get_config,
)
from improved_body_parts_tpu_torch.ops import group, group_cpp
from improved_body_parts_tpu_torch.infer.predict import Predictor
from improved_body_parts_tpu_torch.models import quantize as qz
from improved_body_parts_tpu_torch.models.imhn import create_model
from improved_body_parts_tpu_torch.ops.limbs import (
    connections_to_numpy, score_connections, select_connections,
)
from improved_body_parts_tpu_torch.ops.peaks import PeakTable, find_peaks
from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth
from improved_body_parts_tpu_torch.utils.common import (
    draw_humans, draw_humans_ellipse, show_color_vector,
)
from improved_body_parts_tpu_torch.utils import imageio
from improved_body_parts_tpu_torch.utils.device import require_cuda

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def default_device(name: Optional[str]) -> torch.device:
    """``name`` when given (``"cpu"`` is the only way to the CPU), else the
    card; raises when no card is visible and none was named."""
    if name:
        return torch.device(name)
    return require_cuda()


def build_predictor(checkpoint: str, config: Union[str, CanonicalConfig],
                    refine: str = "bicubic", *, device: torch.device,
                    quantize: str = "", dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0) -> Predictor:
    """A ``Predictor`` over the config's network (``create_model``) on
    ``device``, with the weights of a reference-layout ``.pth``
    (``utils/checkpoint.load_reference_pth``: a released reference file or
    JAX ``export_to_torch_state_dict`` output), or the reference init from
    ``seed`` when ``checkpoint`` is empty or missing (as the JAX demo falls
    back to a fresh init).

    ``quantize="int8"`` serves the int8 ``PoseNet`` (JAX demo_image.py:
    41-77): an int8 export (``models/quantize.save_quantized``) given as
    ``checkpoint`` loads directly; otherwise the fp model is folded and
    calibrated on ``SyntheticDataset(config, length=8, seed=1234)`` in two
    batches of 4."""
    if quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = get_config(config) if isinstance(config, str) else config
    if quantize and cfg.model.legacy_blocks:
        raise ValueError(f"--quantize {quantize}: quantization supports the "
                         "live PoseNet only (not legacy_blocks)")
    if quantize and checkpoint and qz.is_quantized_checkpoint(checkpoint):
        model = qz.load_quantized(cfg.model, checkpoint, device=device,
                                  compute_dtype=dtype)
        print(f"loaded int8 quantized checkpoint: {checkpoint}")
        return Predictor(model, cfg, device=device, refine=refine)
    if checkpoint and os.path.isdir(checkpoint):
        raise ValueError(
            f"{checkpoint} is a directory (an orbax checkpoint?); reading "
            "orbax needs jax. Convert it to a .pth with the JAX package's "
            "improved_body_parts_tpu.utils.checkpoint.export_to_torch_state_dict "
            "and torch.save, then pass the .pth")
    g = torch.Generator().manual_seed(seed)
    model = create_model(cfg.model, compute_dtype=dtype, generator=g)
    if checkpoint and os.path.exists(checkpoint):
        model.load_state_dict(load_reference_pth(checkpoint), strict=True)
        print(f"loaded checkpoint: {checkpoint}")
    elif checkpoint:
        print(f"WARNING: checkpoint '{checkpoint}' not found; using fresh init")
    model.eval()
    fmt = (torch.channels_last if torch.device(device).type == "cuda"
           else torch.contiguous_format)
    model = model.to(device, memory_format=fmt)
    if quantize:
        from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
        t0 = time.time()
        # calibrate on rendered multi-person scenes at the serving
        # resolution (per-tensor activation scales; models/quantize.py)
        calib_ds = SyntheticDataset(cfg, length=8, seed=1234)
        calib = [np.stack([calib_ds[i][0] for i in range(b * 4, b * 4 + 4)])
                 for b in range(2)]
        model = qz.quantize_model(model, calib)
        print(f"int8 PTQ: folded BN + calibrated on "
              f"{sum(len(b) for b in calib)} scenes in {time.time() - t0:.1f}s")
    return Predictor(model, cfg, device=device, refine=refine)


# ---------------------------------------------------------------------------
# the synthetic two-person scene (ground-truth stride maps, no network)
# ---------------------------------------------------------------------------

def _gaussian_blob(shape, cx, cy, sigma=2.0):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    return np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))


def _limb_band(shape, x1, y1, x2, y2, sigma=1.75):
    """Gaussian of the distance to the segment (stride-map coords)."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    dx, dy = x2 - x1, y2 - y1
    norm = np.sqrt(dx * dx + dy * dy) + 1e-6
    dist = np.abs(dx * (y1 - yy) - (x1 - xx) * dy) / norm
    t = ((xx - x1) * dx + (yy - y1) * dy) / (norm * norm)
    return np.exp(-dist ** 2 / (2 * sigma ** 2)) * ((t > -0.2) & (t < 1.2))


def two_person_scene(H: int = 64, W: int = 64):
    """Two people with nose, neck, shoulders and hips on (H, W) stride maps
    (the scene of the JAX demo's ``--synthetic``). Returns (paf (H, W, 30),
    heat (H, W, 20)) float32."""
    heat = np.zeros((H, W, NUM_PARTS + 2), np.float32)
    paf = np.zeros((H, W, PAF_LAYERS), np.float32)
    people = [
        {0: (20, 10), 1: (20, 16), 2: (14, 17), 5: (26, 17), 8: (16, 30), 11: (24, 30)},
        {0: (44, 12), 1: (44, 18), 2: (38, 19), 5: (50, 19), 8: (40, 32), 11: (48, 32)},
    ]
    for person in people:
        for j, (gx, gy) in person.items():
            heat[:, :, j] = np.maximum(heat[:, :, j], _gaussian_blob((H, W), gx, gy))
    for li, (fr, to) in enumerate(LIMBS_CONN):
        for person in people:
            if int(fr) in person and int(to) in person:
                x1, y1 = person[int(fr)]
                x2, y2 = person[int(to)]
                paf[:, :, li] = np.maximum(paf[:, :, li],
                                           _limb_band((H, W), x1, y1, x2, y2))
    return paf, heat


def run_synthetic(config: Union[str, CanonicalConfig] = "Canonical", *,
                  device: torch.device, use_cpp: bool = False):
    """Peaks -> connections -> grouping on the two-person scene, on
    ``device``. Returns (keypoints (N, 18, 3), scores (N,))."""
    cfg = get_config(config) if isinstance(config, str) else config
    icfg = cfg.infer
    paf, heat = two_person_scene(64, 64)
    heat_t = torch.from_numpy(heat[None, :, :, :NUM_PARTS]).to(device)
    paf_t = torch.from_numpy(paf[None]).to(device)
    peaks = find_peaks(heat_t, thre=icfg.thre1, max_peaks=icfg.max_peaks,
                       stride=cfg.stride)
    cand = score_connections(paf_t, peaks.xy, peaks.score, peaks.valid,
                             torch.tensor([256.0], device=device),
                             mid_num=icfg.mid_num, stride=cfg.stride,
                             thre2=icfg.thre2, connect_ration=icfg.connect_ration)
    conns = select_connections(cand, peaks.valid)
    pk = PeakTable(*(t[0] for t in peaks))
    connected = connections_to_numpy(type(conns)(*(t[0] for t in conns)), pk)
    cands = group.build_joint_candidates(pk.xy.cpu().numpy(),
                                         pk.score.cpu().numpy(),
                                         pk.valid.cpu().numpy())
    if use_cpp:
        table, cands = group_cpp.find_humans(connected, cands, icfg)
    else:
        table, cands = group.find_humans(connected, cands, icfg)
    return group.humans_to_keypoints(table, cands)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="PoseNet demo (PyTorch port)")
    parser.add_argument("--image", type=str, default="", help="input image path")
    parser.add_argument("--output", type=str, default="result.jpg", help="output image")
    parser.add_argument("--checkpoint", "-p", type=str, default="",
                        help="reference-layout torch .pth to load")
    parser.add_argument("--config", type=str, default="Canonical")
    parser.add_argument("--refine", type=str, default="bicubic",
                        choices=["bicubic", "centroid"],
                        help="sub-pixel peak refinement scheme")
    parser.add_argument("--run_cpp", action="store_true",
                        help="use the C++ grouping fast path")
    parser.add_argument("--scale-search", type=float, nargs="*", default=None,
                        help="multi-scale TTA factors, e.g. 0.5 1 1.5 2")
    parser.add_argument("--rotation-search", type=float, nargs="*", default=[0.0],
                        help="rotation TTA angles in degrees")
    parser.add_argument("--quantize", default="", choices=["", "int8"],
                        help="post-training int8 quantization of the forward "
                             "(models/quantize.py): an int8 export given as "
                             "--checkpoint loads directly, else BN is folded "
                             "and the activations calibrated on 8 synthetic "
                             "scenes")
    parser.add_argument("--synthetic", action="store_true",
                        help="run post-processing on a synthetic scene (no weights needed)")
    parser.add_argument("--ellipse", action="store_true",
                        help="reference-style filled-ellipse limb rendering "
                             "instead of lines")
    parser.add_argument("--show-maps", action="store_true",
                        help="also save heatmap/limb-map overlay diagnostics")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, and an error when "
                             "no card is visible; pass cpu to run on the CPU)")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                        help="type the network's convs run in")
    args = parser.parse_args(argv)
    device = default_device(args.device)
    print(f"device: {device}")

    if args.synthetic:
        t0 = time.time()
        kps, scores = run_synthetic(args.config, device=device,
                                    use_cpp=args.run_cpp)
        print(f"synthetic scene: found {len(kps)} people "
              f"(scores: {np.round(scores, 3).tolist()}) in {time.time()-t0:.2f}s")
        imageio.imwrite(args.output,
                        draw_humans(np.zeros((256, 256, 3), np.uint8), kps))
        print(f"wrote {args.output}")
        return 0 if len(kps) == 2 else 1

    if not args.image:
        parser.error("--image is required (or use --synthetic)")
    try:
        img = imageio.imread(args.image)
    except (OSError, imageio.ImageDecodeError) as e:
        print(f"cannot read image: {args.image} ({e})")
        return 1

    predictor = build_predictor(args.checkpoint, args.config, args.refine,
                                device=device, quantize=args.quantize,
                                dtype=DTYPES[args.dtype])
    t0 = time.time()
    kps, scores, aux = predictor.predict_skeletons(
        img, use_cpp=True if args.run_cpp else None,
        scales=tuple(args.scale_search) if args.scale_search else None,
        angles=tuple(args.rotation_search))
    print(f"found {len(kps)} people in {time.time() - t0:.3f}s")

    canvas = (draw_humans_ellipse(img, kps) if args.ellipse
              else draw_humans(img, kps))
    imageio.imwrite(args.output, canvas)
    print(f"wrote {args.output}")

    if args.show_maps:
        import cv2
        # stride-4 maps -> image resolution, like the reference's upsampled
        # paf_avg/heatmap_avg (demo_image.py:96-122)
        h, w = img.shape[:2]
        paf = cv2.resize(aux["paf"].float().cpu().numpy(), (w, h),
                         interpolation=cv2.INTER_CUBIC)
        heat = cv2.resize(aux["heat"].float().cpu().numpy(), (w, h),
                          interpolation=cv2.INTER_CUBIC)
        prefix = os.path.splitext(args.output)[0]
        for p in show_color_vector(img, paf, heat, out_prefix=prefix):
            print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
