"""Ground-truth heatmap overlays of a synthetic scene.

    python -m improved_body_parts_tpu_torch.visual.heatmap_vis [--out heatmap_vis.png]

Port of the repo's ``visual/heatmap_vis.py`` (reference
visual/heatmap_gen.py and the jet colouring of utils/util.py:12-41): a
two-person scene of ``data/synthetic`` (seed 0) at Canonical's 512², its
GT maps from ``data/heatmaps.Heatmapper``, and three panels side by side:
the maximum over the keypoint channels, the maximum over the limb channels,
and the background channel, each jet-coloured, upsampled to the image by
nearest neighbour and blended 0.4 image + 0.6 colour (``cv2.addWeighted``'s
arithmetic). Written with ``utils/imageio`` as PNG. Host only, no cv2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def jet(gray: np.ndarray) -> np.ndarray:
    """Jet colour map of [0, 1] maps -> BGR uint8 (the JAX script's)."""
    v = np.clip(gray, 0.0, 1.0)
    b = np.clip(np.where(v < 0.125, 0.5 + 4 * v,
                np.where(v < 0.375, 1.0, np.where(v < 0.625, -4 * v + 2.5, 0))), 0, 1)
    g = np.clip(np.where(v < 0.125, 0, np.where(v < 0.375, 4 * (v - 0.125),
                np.where(v < 0.625, 1.0, np.where(v < 0.875, -4 * v + 3.5, 0)))), 0, 1)
    r = np.clip(np.where(v < 0.625, np.where(v >= 0.375, 4 * (v - 0.375), 0),
                np.where(v < 0.875, 1.0, -4 * v + 4.5)), 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def blend(img: np.ndarray, color: np.ndarray) -> np.ndarray:
    """``cv2.addWeighted(img, 0.4, color, 0.6, 0)`` on uint8: float32
    arithmetic, rounded half to even, saturated."""
    out = (img.astype(np.float32) * np.float32(0.4)
           + color.astype(np.float32) * np.float32(0.6))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def render(seed: int = 0) -> np.ndarray:
    """The three overlay panels side by side, (512, 1536, 3) BGR uint8."""
    from improved_body_parts_tpu_torch.configs import (
        HEAT_START, NUM_PARTS, CanonicalConfig,
    )
    from improved_body_parts_tpu_torch.data.heatmaps import Heatmapper
    from improved_body_parts_tpu_torch.data.synthetic import (
        random_people, render_image,
    )

    cfg = CanonicalConfig()
    rng = np.random.RandomState(seed)
    joints = random_people(rng, cfg.height, cfg.width, max_people=2)
    img = (render_image(joints, cfg.height, cfg.width, rng) * 255).astype(np.uint8)
    hm = Heatmapper(cfg).create_heatmaps(joints, np.ones((128, 128), np.float32))
    fy, fx = cfg.height // hm.shape[0], cfg.width // hm.shape[1]
    panels = []
    for m in (hm[:, :, HEAT_START:HEAT_START + NUM_PARTS].max(axis=2),
              hm[:, :, :30].max(axis=2),
              hm[:, :, -1]):
        color = jet(m).repeat(fy, axis=0).repeat(fx, axis=1)   # INTER_NEAREST
        panels.append(blend(img, color))
    return np.concatenate(panels, axis=1)


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.utils.imageio import imwrite

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="heatmap_vis.png")
    args = ap.parse_args(argv)
    imwrite(args.out, render())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
