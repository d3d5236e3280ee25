#!/usr/bin/env python3
"""How well conditioned the port's train step is at the tests' tiny size.

Takes the gradient of the training loss of the tiny model of
tests/test_torch_train.py (nstack 2, inp_dim 32, increase 16, 64² images,
batch 8, the reference init, the same numpy batch) with train-mode and with
frozen BatchNorm, and prints, for each mode:

  * how far the float64 gradient moves when the input images are changed by
    a relative ``eps`` (N(0, 1) noise times ``eps``), for each ``eps``:
    linear in ``eps`` while no LeakyReLU or max-pool kink flips, a jump when
    one does;
  * how far the fp32 gradient lies from the float64 one: as a whole (norm of
    the difference over norm) and in the worst tensor (max difference over
    the tensor's max, at least 1e-3 of the largest).

    python3 tools/train_bn_conditioning.py --device cpu
    python3 tools/train_bn_conditioning.py                  # on the card

Imports torch and the port only.
"""

import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from improved_body_parts_tpu_torch.configs import CanonicalConfig, ModelConfig  # noqa: E402
from improved_body_parts_tpu_torch.data.heatmaps_device import (  # noqa: E402
    DeviceHeatmapper, pad_people,
)
from improved_body_parts_tpu_torch.data.synthetic import random_people  # noqa: E402
from improved_body_parts_tpu_torch.losses import multi_task_loss  # noqa: E402
from improved_body_parts_tpu_torch.models.imhn import PoseNet  # noqa: E402
from improved_body_parts_tpu_torch.utils.device import require_cuda  # noqa: E402

SIZE, BATCH, PEOPLE = 64, 8, 4


def tiny_batch():
    """tests/test_torch_train.py's batch: images, mask, joints, mask_all."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    mask = (rng.rand(BATCH, SIZE // 4, SIZE // 4, 1) > 0.2).astype(np.float32)
    joints = np.stack([pad_people(random_people(rng, SIZE, SIZE), PEOPLE)
                       for _ in range(BATCH)])
    mask_all = (rng.rand(BATCH, SIZE // 4, SIZE // 4) > 0.2).astype(np.float32)
    return imgs, mask, joints, mask_all


def gradients(model, cfg, imgs, mask, heat, dtype, train):
    m = copy.deepcopy(model).to(dtype=dtype)
    m.compute_dtype = dtype
    outs = m(imgs.to(dtype), bn_stats={} if train else None)
    loss = multi_task_loss(outs, heat.to(dtype), mask.to(dtype), cfg.train)
    names = [k for k, _ in m.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))


def global_rel(a, b):
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def worst_rel(a, b):
    top = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k].double() - b[k].double()).abs().max())
               / max(float(b[k].abs().max()), 1e-3 * top) for k in b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default; raises without one)")
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-9, 1e-11])
    args = ap.parse_args()
    dev = torch.device(args.device) if args.device else require_cuda()
    torch.backends.cudnn.allow_tf32 = False

    cfg = CanonicalConfig(width=SIZE, height=SIZE,
                          model=ModelConfig(nstack=2, inp_dim=32, increase=16))
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    imgs, mask, joints, mask_all = (torch.from_numpy(a).to(dev) for a in tiny_batch())
    heat = DeviceHeatmapper(cfg).render(joints.double(), mask_all)
    noise = torch.from_numpy(np.random.RandomState(9).randn(*imgs.shape)).to(dev)
    f64 = imgs.double()
    for train in (True, False):
        mode = "train-mode BN" if train else "frozen BN"
        exact = gradients(model, cfg, f64, mask, heat, torch.float64, train)
        for eps in args.eps:
            moved = gradients(model, cfg, f64 * (1 + eps * noise), mask, heat,
                              torch.float64, train)
            print(f"{mode}: images x (1 + {eps:g} N(0,1)) moves the float64 "
                  f"gradient by {global_rel(moved, exact):.3e} as a whole", flush=True)
        fp32 = gradients(model, cfg, imgs, mask, heat, torch.float32, train)
        print(f"{mode}: fp32 gradient against float64: {global_rel(fp32, exact):.3e} "
              f"as a whole, {worst_rel(fp32, exact):.3e} in the worst tensor "
              f"({dev.type}, torch {torch.__version__})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
