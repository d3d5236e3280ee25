"""Network-only throughput on the card: the IMHN forward alone (no flip TTA,
no post-processing) on a batch resident on the card.

    python -m improved_body_parts_tpu_torch.apps.inference_speed --mfu
    python -m improved_body_parts_tpu_torch.apps.inference_speed --quantize int8 --mfu
    python -m improved_body_parts_tpu_torch.apps.inference_speed --device cpu \
        --config <name> --image-size 64 --iters 2     # a small config, CPU

Port of the JAX package's ``test_inference_speed.py`` (the reference
recorded 38.5 frames/s for batch 4 at 512x512 on a 2080 Ti,
test_inference_speed.py:117-120). The forward is ``PoseNet.predict_maps``
(the serving read-out) in bf16 on a channels_last model; its time is taken
between two CUDA events around ``--iters`` forwards after a warm-up.

``--mfu`` adds the FLOPs a frame (``utils/profiling.flops_of``, counted on
the float model of the config for an int8 forward, whose ctypes-launched
convs the counter cannot see), the effective rate, and the model FLOPs
utilization against the H100 SXM's dense data-sheet peaks: 989 TFLOP/s in
bf16 and 1,979 TOP/s in int8 (the int8 forward still runs its
dequantization, SE layers and merges in bf16, so it is given against both).

Prints the JAX tool's text lines, then one JSON line with the numbers.
Runs on the card unless ``--device cpu`` is given, and raises when there is
no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from improved_body_parts_tpu_torch.utils.profiling import device_timer, flops_of, sync

PEAK_BF16 = 989e12      # H100 SXM, dense bf16 (data sheet)
PEAK_INT8 = 1979e12     # H100 SXM, dense int8 (data sheet)


def measure(model, imgs: torch.Tensor, iters: int, *, mfu: bool = False,
            int8: bool = False, flop_model=None) -> dict:
    """Time ``iters`` forwards of ``model.predict_maps(imgs)`` after one
    warm-up: CUDA events on the card, the host clock around a synchronized
    loop on the CPU. ``mfu`` counts the FLOPs of one forward on
    ``flop_model`` (default ``model``; pass the float model for an int8
    one). Returns frames/s, ms a step and, with ``mfu``, GFLOP a frame,
    TFLOP/s and the MFU against the bf16 (and, for ``int8``, the int8)
    peak."""
    batch = imgs.shape[0]
    with torch.inference_mode():
        out = model.predict_maps(imgs)              # warm-up (cuDNN plans)
        sync(out)
        with device_timer(imgs.device) as t:
            for _ in range(iters):
                out = model.predict_maps(imgs)
    dt = t["elapsed"]
    if not torch.isfinite(out).all():
        raise AssertionError("the forward gave non-finite maps")
    res = dict(fps=batch * iters / dt, ms_per_step=dt / iters * 1e3,
               batch=batch, size=int(imgs.shape[1]), iters=iters, int8=int8)
    if mfu:
        flops = flops_of((flop_model or model).predict_maps, imgs)
        eff = flops * iters / dt
        res.update(gflop_per_frame=flops / batch / 1e9, tflops=eff / 1e12,
                   mfu_bf16=eff / PEAK_BF16)
        if int8:
            res["mfu_int8"] = eff / PEAK_INT8
    return res


def report_lines(res: dict, where: str) -> list:
    """The JAX tool's text lines for ``measure``'s result."""
    s = res["size"]
    lines = [f"network-only: {res['fps']:.1f} FPS (batch {res['batch']}, "
             f"{s}x{s}, {res['ms_per_step']:.1f} ms/step, device {where})"]
    if "gflop_per_frame" in res:
        lines.append(
            f"forward: {res['gflop_per_frame']:.1f} GFLOP/frame, "
            f"{res['tflops']:.1f} TFLOP/s effective, "
            f"MFU {res['mfu_bf16'] * 100:.1f}% of bf16 peak"
            + (f" / {res['mfu_int8'] * 100:.1f}% of int8 peak"
               if "mfu_int8" in res else ""))
    return lines


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device
    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.models.imhn import create_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--quantize", default="", choices=["", "int8"],
                    help="the int8 forward (models/quantize.py)")
    ap.add_argument("--mfu", action="store_true",
                    help="also report FLOPs a frame and the model FLOPs "
                         "utilization against the H100's peaks")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    config = get_config(args.config)
    fmt = (torch.channels_last if device.type == "cuda"
           else torch.contiguous_format)
    model = create_model(config.model, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(device, memory_format=fmt)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.rand(args.batch_size, args.image_size,
                                     args.image_size, 3).astype(np.float32)).to(device)
    net = model
    if args.quantize:
        from improved_body_parts_tpu_torch.models import quantize as qz
        calib = [np.random.RandomState(1).rand(
            2, args.image_size, args.image_size, 3).astype(np.float32)]
        with contextlib.redirect_stdout(sys.stderr):
            net = qz.quantize_model(model, calib)
        print("int8 PTQ applied")
    res = measure(net, imgs, args.iters, mfu=args.mfu, int8=bool(args.quantize),
                  flop_model=model)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    for line in report_lines(res, where):
        print(line)
    print(json.dumps(dict(res, device=where)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
