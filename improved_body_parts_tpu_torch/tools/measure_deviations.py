"""Measure the port's documented deviations from the reference.

    python -m improved_body_parts_tpu_torch.tools.measure_deviations \
        [--scenes 20] [--which all|centroid|scale|letterbox] [--device cpu]

Port of the repo's ``tools/measure_deviations.py``:

  1. the ``--refine centroid`` radius: the port refines on the stride map
     with a 2-cell window (``ops/peaks``), the reference's original path
     with a 2-pixel window on the x4 cubic upsample (utils/util.py:
     188-213). Measured on ``blob_scene`` maps as the matched peaks' mean,
     p95 and largest coordinate distance. Needs cv2 and scipy (the
     reference path), where it runs;
  2. the 1/4-step quantization of the per-image TTA factors (``apps.
     evaluate --scale-quant``): the map and peak deltas of exact against
     quantized factors through the port's TTA;
  3. the letterbox against bucket padding: the joints of
     ``predict_skeletons(fixed_size=True)`` against the padded path.

2 and 3 run the seeded reference-recipe network: the reference's own
``PoseNet`` (nstack 2, inp_dim 256) from the reference checkout that
``REFERENCE_DIR`` names (``tools/ref_ap_ab.reference_dir``) with the
weights of ``seeded_state_dict_arrays``, saved as a ``.pth`` and served by
the port through ``utils/checkpoint.load_reference_pth``. Without
``REFERENCE_DIR`` they are skipped with a message. ``blob_scene`` and the weight recipe are the
port's copies of tests/reference_parity_common.py's. Prints its results;
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

SCENE_H, SCENE_W = 32, 40


# ---------------------------------------------------------------------------
# the shared deterministic scenes and weights (tests/reference_parity_common)
# ---------------------------------------------------------------------------

def _blob_maps(rng, H, W, K, n_blobs):
    heat = np.zeros((H, W, K), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for k in range(K):
        for _ in range(n_blobs):
            cx, cy = rng.uniform(0, W - 1), rng.uniform(0, H - 1)
            s = rng.uniform(1.5, 3.5)
            a = rng.uniform(0.3, 1.0)
            heat[:, :, k] = np.maximum(
                heat[:, :, k],
                a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
    return heat


def blob_scene(scene_idx: int):
    """Random gaussian blobs as keypoint maps and broad bands as limb maps
    on a (32, 40) stride grid -> (heat (H, W, 18), paf (H, W, 30), img_h)."""
    rng = np.random.RandomState(1000 + scene_idx)
    heat = _blob_maps(rng, SCENE_H, SCENE_W, 18, rng.randint(1, 5))
    paf = _blob_maps(rng, SCENE_H, SCENE_W, 30, rng.randint(2, 6))
    return heat, paf, float(SCENE_H * 4)


def seeded_state_dict_arrays(keys, shapes):
    """RandomState(0) drawn over the SORTED state-dict keys (int64
    ``num_batches_tracked`` skipped), x 0.05; BN running variances and 1-D
    ``.weight`` (BN scales) made positive."""
    rng = np.random.RandomState(0)
    out = {}
    for k in keys:
        if k.endswith("num_batches_tracked"):
            continue
        arr = rng.randn(*shapes[k]).astype(np.float32) * 0.05
        if k.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        if k.endswith(".weight") and len(shapes[k]) == 1:
            arr = np.abs(arr) + 0.5
        out[k] = arr
    return out


def match_delta(kps_a, kps_b):
    """Greedy nearest matching of two (N, 2) point sets -> (the distances
    of the matched pairs, the count left unmatched)."""
    if len(kps_a) == 0 or len(kps_b) == 0:
        return np.zeros((0,)), max(len(kps_a), len(kps_b))
    d = np.linalg.norm(kps_a[:, None, :] - kps_b[None, :, :], axis=-1)
    deltas = []
    used_a, used_b = set(), set()
    for _ in range(min(len(kps_a), len(kps_b))):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if not np.isfinite(d[i, j]):
            break
        deltas.append(d[i, j])
        used_a.add(i)
        used_b.add(j)
        d[i, :] = np.inf
        d[:, j] = np.inf
    unmatched = (len(kps_a) - len(used_a)) + (len(kps_b) - len(used_b))
    return np.asarray(deltas), unmatched


# ---------------------------------------------------------------------------
# 1: the centroid refinement radius
# ---------------------------------------------------------------------------

def reference_original_peaks(heat: np.ndarray):
    """The reference's original path: x4 cubic upsample, 3x3 max-pool NMS
    >= 0.1, 2-pixel weighted-centroid refine (utils/util.py:177-213,
    parse_skeletons.py:286-321). A list of (n, 2) xy a channel."""
    import cv2
    import scipy.ndimage as ndi

    out = []
    up = cv2.resize(heat, None, fx=4, fy=4, interpolation=cv2.INTER_CUBIC)
    for k in range(heat.shape[2]):
        m = up[:, :, k]
        mx = ndi.maximum_filter(m, size=3, mode="reflect")
        ys, xs = np.nonzero((mx == m) & (m >= 0.1))
        pts = []
        for x, y in zip(xs, ys):
            r = 2
            if (x - r < 0 or x + r >= m.shape[1] or y - r < 0
                    or y + r >= m.shape[0]):
                pts.append((float(x), float(y)))
                continue
            box = m[y - r:y + r + 1, x - r:x + r + 1]
            grid = np.arange(-r, r + 1, dtype=np.float64)
            tot = box.sum()
            # the reference mgrid swap: x offset from the y moment
            off_x = (box * grid[:, None]).sum() / max(tot, 1e-12)
            off_y = (box * grid[None, :]).sum() / max(tot, 1e-12)
            pts.append((x + off_x, y + off_y))
        out.append(np.asarray(pts).reshape(-1, 2))
    return out


def centroid_deltas(n_scenes: int, device: torch.device):
    """(matched distances, unmatched, total) of deviation 1 over scenes
    200 .. 200 + n_scenes, the port's ``find_peaks`` on ``device``."""
    from improved_body_parts_tpu_torch.ops.peaks import find_peaks

    all_d, unmatched_tot, n_tot = [], 0, 0
    for si in range(200, 200 + n_scenes):
        heat, _, _ = blob_scene(si)
        ref = reference_original_peaks(heat)
        with torch.inference_mode():
            ours = find_peaks(torch.from_numpy(heat)[None].to(device), thre=0.1,
                              max_peaks=64, stride=4, refine="centroid")
        xy, va = ours.xy[0].cpu().numpy(), ours.valid[0].cpu().numpy()
        for k in range(heat.shape[2]):
            d, um = match_delta(ref[k], xy[k][va[k]])
            all_d.extend(d)
            unmatched_tot += um
            n_tot += max(len(ref[k]), int(va[k].sum()))
    return np.asarray(all_d), unmatched_tot, n_tot


def measure_centroid_radius(n_scenes: int, device: torch.device) -> None:
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("centroid: cv2 unavailable, skipped")
        return
    all_d, unmatched_tot, n_tot = centroid_deltas(n_scenes, device)
    print(f"centroid-refine radius: {len(all_d)} matched peaks over "
          f"{n_scenes} scenes; mean |delta| {all_d.mean():.3f} px, "
          f"p95 {np.percentile(all_d, 95):.3f} px, max {all_d.max():.3f} px, "
          f"unmatched {unmatched_tot}/{n_tot}")


# ---------------------------------------------------------------------------
# 2 and 3: through the seeded reference-recipe network
# ---------------------------------------------------------------------------

def seeded_reference_state_dict(nstack: int = 2):
    """The reference ``PoseNet`` (inp_dim 256) with the seeded weights: its
    state dict."""
    from improved_body_parts_tpu_torch.tools.ref_ap_ab import import_reference

    import_reference()
    from models.posenet import PoseNet

    net = PoseNet(nstack, 256, 50, bn=True, increase=128)
    sd = net.state_dict()
    keys = sorted(sd.keys())
    arrays = seeded_state_dict_arrays(keys, {k: tuple(sd[k].shape) for k in keys})
    with torch.no_grad():
        for k in keys:
            if k in arrays:
                sd[k].copy_(torch.from_numpy(arrays[k]))
    return sd


def seeded_predictor(device: torch.device, max_peaks: int = 128):
    """The port's fp32 predictor of the seeded reference network, its
    weights through a ``.pth`` and ``load_reference_pth``; the inference
    thresholds of the reference INI, peaks in the pad band kept (the
    reference's refactor path)."""
    import dataclasses

    from improved_body_parts_tpu_torch.apps.demo_image import build_predictor
    from improved_body_parts_tpu_torch.configs import CanonicalConfig, ModelConfig

    cfg = CanonicalConfig(model=ModelConfig(nstack=2, inp_dim=256, increase=128))
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, max_peaks=max_peaks, thre1=0.1, thre2=0.1,
        connect_ration=0.8, mid_num=20, len_rate=16, connection_tole=0.7,
        remove_recon=0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seeded.pth")
        torch.save({"weights": seeded_reference_state_dict()}, path)
        predictor = build_predictor(path, cfg, device=device, dtype=torch.float32)
    predictor.suppress_pad_peaks = False
    return predictor


def measure_scale_quantization(n_scenes: int, predictor) -> None:
    """Deviation 2: 1/4-step quantization of the per-image TTA factors."""
    from improved_body_parts_tpu_torch.infer.predict import unpack_results

    rng = np.random.RandomState(3)
    scale_search = [0.5, 1.0, 1.5]
    boxsize = 512
    P = predictor.config.infer.max_peaks
    map_deltas, peak_deltas, unmatched = [], [], 0
    for _ in range(n_scenes):
        ih = int(rng.randint(90, 140))
        iw = int(rng.randint(100, 180))
        img = rng.randint(0, 255, (ih, iw, 3)).astype(np.uint8)
        exact = tuple(sorted({min(s * boxsize / ih, 2.0) for s in scale_search}))
        quant = tuple(sorted({max(round(s * 4) / 4, 0.25) for s in exact}))
        pk_e, _, heat_e, _ = predictor.predict_maps_tta(img, exact)
        pk_q, _, heat_q, _ = predictor.predict_maps_tta(img, quant)
        map_deltas.append(float((heat_e - heat_q).abs().mean()))
        pe, _ = unpack_results(pk_e.cpu().numpy(), P)
        pq, _ = unpack_results(pk_q.cpu().numpy(), P)
        for k in range(18):
            d, um = match_delta(pe.xy[k][pe.valid[k]], pq.xy[k][pq.valid[k]])
            peak_deltas.extend(d)
            unmatched += um
    peak_deltas = np.asarray(peak_deltas) if peak_deltas else np.zeros(1)
    print(f"scale quantization (exact vs 1/4-step, {n_scenes} images): "
          f"mean |map delta| {np.mean(map_deltas):.5f}, "
          f"peak mean |delta| {peak_deltas.mean():.3f} px, "
          f"p95 {np.percentile(peak_deltas, 95):.3f} px, "
          f"unmatched peaks {unmatched}")


def measure_letterbox(n_scenes: int, predictor) -> None:
    """Deviation 3: letterbox canvas against per-image bucket padding."""
    rng = np.random.RandomState(4)
    deltas, unmatched = [], 0
    for _ in range(n_scenes):
        ih = int(rng.randint(90, 140))
        iw = int(rng.randint(100, 180))
        img = rng.randint(0, 255, (ih, iw, 3)).astype(np.uint8)
        kps_pad, _, _ = predictor.predict_skeletons(img)
        kps_box, _, _ = predictor.predict_skeletons(img, fixed_size=True)
        a = (kps_pad[:, :, :2][kps_pad[:, :, 2] > 0] if len(kps_pad)
             else np.zeros((0, 2)))
        b = (kps_box[:, :, :2][kps_box[:, :, 2] > 0] if len(kps_box)
             else np.zeros((0, 2)))
        d, um = match_delta(a, b)
        deltas.extend(d)
        unmatched += um
    deltas = np.asarray(deltas) if deltas else np.zeros(1)
    print(f"letterbox vs bucket padding ({n_scenes} images): joint mean "
          f"|delta| {deltas.mean():.3f} px, p95 "
          f"{np.percentile(deltas, 95):.3f} px, unmatched joints {unmatched}")


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=20)
    ap.add_argument("--which", default="all",
                    choices=["all", "centroid", "scale", "letterbox"])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.which in ("all", "centroid"):
        measure_centroid_radius(args.scenes, device)
    if args.which in ("all", "scale", "letterbox"):
        from improved_body_parts_tpu_torch.tools.ref_ap_ab import reference_dir
        reference = reference_dir()
        if not reference or not os.path.isdir(reference):
            print("scale, letterbox: no reference checkout (set "
                  f"REFERENCE_DIR; now {reference or 'unset'}), skipped")
            return 0
        predictor = seeded_predictor(device)
        if args.which in ("all", "scale"):
            measure_scale_quantization(max(args.scenes // 2, 5), predictor)
        if args.which in ("all", "letterbox"):
            measure_letterbox(max(args.scenes // 2, 5), predictor)
    return 0


if __name__ == "__main__":
    sys.exit(main())
