"""The line integral that scores a candidate limb.

    python -m improved_body_parts_tpu_torch.visual.line_integral [--device cpu]

Port of the repo's ``visual/line_integral.py`` (reference
visual/line_integral.py): a limb map drawn along the segment (10, 10) ->
(50, 50) of a 64 x 64 grid, sampled at 20 points along the true pairing and
along a wrong one with ``ops/limbs.bilinear_sample``, the sampler of the
port's connection scoring, on the device. The score is the mean sample.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

PAIRINGS = {"true limb": (10.0, 10.0, 50.0, 50.0),
            "wrong pairing": (10.0, 50.0, 50.0, 10.0)}
N_SAMPLES = 20


def limb_map(h: int = 64, w: int = 64) -> np.ndarray:
    """A gaussian band (sigma 2) about the segment (10, 10) -> (50, 50)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x1, y1, x2, y2 = PAIRINGS["true limb"]
    d = np.hypot(x2 - x1, y2 - y1)
    dist = np.abs((x2 - x1) * (y1 - yy) - (x1 - xx) * (y2 - y1)) / d
    return np.exp(-dist ** 2 / (2 * 2.0 ** 2)).astype(np.float32)


def segment_points(ax, ay, bx, by, n: int = N_SAMPLES):
    t = np.linspace(0, 1, n).astype(np.float32)
    return ax + t * (bx - ax), ay + t * (by - ay)


def samples(device: torch.device) -> dict:
    """{pairing: its N_SAMPLES samples, float32 numpy}, sampled on
    ``device``, both pairings in one call."""
    from improved_body_parts_tpu_torch.ops.limbs import bilinear_sample

    pts = [segment_points(*seg) for seg in PAIRINGS.values()]
    fx = torch.from_numpy(np.stack([p[0] for p in pts])).to(device)
    fy = torch.from_numpy(np.stack([p[1] for p in pts])).to(device)
    maps = torch.from_numpy(limb_map()).to(device).expand(len(pts), -1, -1)
    vals = bilinear_sample(maps.contiguous(), fx, fy).cpu().numpy()
    return dict(zip(PAIRINGS, vals))


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    for name, vals in samples(default_device(args.device)).items():
        print(f"{name:14s}: mean sample = {vals.mean():.3f}, "
              f"{np.count_nonzero(vals > 0.1)}/{N_SAMPLES} above threshold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
