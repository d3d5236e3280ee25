"""The benchmark's arithmetic: the chip's peaks, and the operations and
bytes of the work it measures, counted from shapes.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` (2 x the
multiply-accumulates of every conv, linear and matmul) on the plain
reference model on the ``meta`` device: no memory, no device time, and the
same count whatever the program does to run it (a folded BN, an int8 conv,
a kernel launched through ctypes). Bytes are each input byte read once and
each output byte written once.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
NUM_PARTS = 18


def _model(model_cfg: dict):
    from perf_bench.reference.model import build
    return build(model_cfg, device="meta")


def serve_flops_per_frame(model_cfg: dict, size: int) -> float:
    """FLOPs of one served frame at ``size``²: the read-out forward of the
    frame and of its mirror image."""
    from torch.utils.flop_counter import FlopCounterMode
    model = _model(model_cfg)
    imgs = torch.zeros((2, size, size, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.predict_maps(imgs)
    return float(counter.get_total_flops())


def train_flops_per_step(model_cfg: dict, size: int, batch: int) -> float:
    """FLOPs of one train step on ``batch`` images of ``size``²: the full
    forward (every stack and scale) and the backward to every parameter."""
    from torch.utils.flop_counter import FlopCounterMode
    from perf_bench.reference.model import Ctx
    model = _model(model_cfg)
    imgs = torch.zeros((batch, size, size, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        outs = model.run(imgs, Ctx({}))
        loss = sum(o.sum() for stack in outs for o in stack)
        torch.autograd.grad(loss, list(model.parameters()))
    return float(counter.get_total_flops())


def nms_bytes(frames: int, size: int, stride: int = 4) -> int:
    """Bytes of one ``nms`` launch over a batch of flip-averaged keypoint
    maps: (frames x 18) fp32 maps of (size / stride)² read once and the
    same written once."""
    cells = frames * NUM_PARTS * (size // stride) ** 2
    return 2 * 4 * cells
