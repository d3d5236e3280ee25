"""Export an int8 serving checkpoint from an fp ``.pth``.

    python -m improved_body_parts_tpu_torch.tools.export_quantized \
        --checkpoint ck/pth/epoch_9.pth --out ck/int8.pth
    python -m improved_body_parts_tpu_torch.apps.evaluate --quantize int8 \
        --checkpoint ck/int8.pth ...

Port of the JAX package's ``tools/export_quantized.py``. It folds BN,
calibrates the activation scales on rendered multi-person scenes
(``SyntheticDataset(config, length=8, seed=1234)`` in batches of 4) or on
``--calib-dir`` images (read with ``utils/imageio.imread`` and resized
with ``ops/warp.resize_linear_u8``, cv2's bilinear bit for bit, so no cv2
is needed), and writes the int8 ``.pth`` of
``models.quantize.save_quantized``, about 4x smaller than the fp32 weights,
which every app loads with ``--quantize int8 --checkpoint <out>`` without
calibrating. The input is a reference-layout ``.pth`` (a released file, a
train state of ``apps.train``, or JAX ``export_to_torch_state_dict``
output). The reference's fastest serving mode is apex AMP fp16
(demo_image.py:300-304); it has no quantized path.

Runs on the card unless ``--device cpu`` is given, and raises when there is
no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

import numpy as np


def calibration_batches(config, size: int, n: int = 8,
                        calib_dir: str = "") -> List[np.ndarray]:
    """(B, size, size, 3) float images in [0, 1], RGB, in batches of 4:
    ``n`` synthetic scenes (seed 1234), or the first ``n`` images of
    ``calib_dir`` resized to size x size with ``cv2.resize``'s default
    (bilinear) as the JAX tool does; an entry that is not a readable image
    (a subdirectory, a corrupt file) is skipped, as there."""
    if calib_dir:
        from improved_body_parts_tpu_torch.ops.warp import resize_linear_u8
        from improved_body_parts_tpu_torch.utils.imageio import (
            ImageDecodeError, imread,
        )
        imgs = []
        for name in sorted(os.listdir(calib_dir))[:n]:
            try:
                img = imread(os.path.join(calib_dir, name))
            except (OSError, ImageDecodeError):
                continue
            img = resize_linear_u8(img, (size, size))[:, :, ::-1]
            imgs.append(img.astype(np.float32) / 255.0)
        return [np.stack(imgs[i:i + 4]) for i in range(0, len(imgs), 4)]
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(config, length=n, seed=1234, image_size=size)
    return [np.stack([ds[i][0] for i in range(b * 4, b * 4 + 4)])
            for b in range(max(n // 4, 1))]


def export(model, batches, out: str):
    """PTQ of the fp ``PoseNet`` on ``batches``, written to ``out``;
    (the int8 model, its bytes, seconds)."""
    from improved_body_parts_tpu_torch.models import quantize as qz
    t0 = time.time()
    qmodel = qz.quantize_model(model, batches)
    qz.save_quantized(out, qmodel)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in qmodel.state_dict().values())
    return qmodel, n_bytes, time.time() - t0


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        DTYPES, build_predictor, default_device,
    )
    from improved_body_parts_tpu_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="fp reference-layout .pth (or an apps.train epoch .pth)")
    ap.add_argument("--out", required=True, help="the int8 .pth to write")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--calib-dir", default="",
                    help="directory of calibration images (default: "
                         "rendered synthetic scenes)")
    ap.add_argument("--calib-images", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=0,
                    help="calibration resolution (default: the config's)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="compute type of the calibration forward and of "
                         "the model the file serves")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.checkpoint):
        raise FileNotFoundError(f"no fp checkpoint at {args.checkpoint}")
    device = default_device(args.device)
    config = get_config(args.config)
    size = args.image_size or config.height
    model = build_predictor(args.checkpoint, config, device=device,
                            dtype=DTYPES[args.dtype]).model
    batches = calibration_batches(config, size, args.calib_images, args.calib_dir)
    _, n_bytes, seconds = export(model, batches, args.out)
    print(f"int8 export: {args.out} ({n_bytes / 1e6:.0f} MB, calibrated on "
          f"{sum(len(b) for b in batches)} images, {seconds:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
