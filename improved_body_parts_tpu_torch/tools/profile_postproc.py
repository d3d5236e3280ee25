"""The inference post-processing on the card, stage by stage.

    python -m improved_body_parts_tpu_torch.tools.profile_postproc
    python -m improved_body_parts_tpu_torch.tools.profile_postproc --device cpu --iters 2

Port of the JAX package's ``tools/profile_postproc.py``. On the maps of an
8-person crowd scene (``tools/stress_grouping.make_crowd_scene``) at
``--hw``² stride resolution (128: a 512² frame), each stage is timed over
``--iters`` calls between CUDA events, after a warm-up call:

  * ``nms``: the ``nms`` kernel alone;
  * ``nms+topk``: NMS and the top-P cut of ``find_peaks`` (a stable
    descending sort: ``torch.topk`` promises no order among equal scores,
    and the table keeps ``lax.top_k``'s);
  * ``find_peaks(+refine)``: NMS, top-P and the bicubic refinement;
  * ``find_peaks FUSED``: the same through the ``fused_peaks`` kernel;
  * ``full postproc``: ``find_peaks``, ``score_connections`` and
    ``select_connections``, as ``Predictor._postprocess`` runs them;

then the differences: the top-P alone, the refinement alone, the limbs and
selection alone. A failing stage fails the run. On the CPU (``--device
cpu``) the times are the host clock's around each stage's plain version.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import torch

from improved_body_parts_tpu_torch.configs import CanonicalConfig
from improved_body_parts_tpu_torch.utils.profiling import device_timer, sync


def stages(config: CanonicalConfig = CanonicalConfig()) -> Dict[str, Callable]:
    """{stage name: fn(heat (1, h, w, 18), paf (1, h, w, 30), img_h (1,))}:
    the post-processing cut where the JAX tool cuts it."""
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.ops.limbs import (
        score_connections, select_connections,
    )
    from improved_body_parts_tpu_torch.ops.peaks import find_peaks

    icfg = config.infer

    def stage_nms(h, p, img_h):
        B, hh, ww, K = h.shape
        x = h.permute(0, 3, 1, 2).float().contiguous().reshape(B * K, hh, ww)
        return kernels.nms(x, icfg.thre1, footprint="plus")

    def stage_topk(h, p, img_h):
        B, hh, ww, K = h.shape
        flat = stage_nms(h, p, img_h).reshape(B, K, hh * ww)
        scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        return scores[..., :icfg.max_peaks], idx[..., :icfg.max_peaks]

    def peaks(h, fused):
        return find_peaks(h, thre=icfg.thre1, max_peaks=icfg.max_peaks,
                          stride=config.stride, fused=fused)

    def stage_full(h, p, img_h):
        pk = peaks(h, False)
        cand = score_connections(p, pk.xy, pk.score, pk.valid, img_h,
                                 mid_num=icfg.mid_num, stride=config.stride,
                                 thre2=icfg.thre2,
                                 connect_ration=icfg.connect_ration)
        return pk, select_connections(cand, pk.valid)

    return {"nms": stage_nms,
            "nms+topk": stage_topk,
            "find_peaks(+refine)": lambda h, p, img_h: peaks(h, False),
            "find_peaks FUSED": lambda h, p, img_h: peaks(h, True),
            "full postproc": stage_full}


def stage_ms(fn: Callable, args, iters: int) -> float:
    """ms a call of ``fn(*args)``: CUDA events around ``iters`` calls on the
    card, the host clock on the CPU; one warm-up call first."""
    with torch.inference_mode():
        fn(*args)
        sync(args[0])
        with device_timer(args[0].device) as t:
            for _ in range(iters):
                fn(*args)
    return t["elapsed"] / iters * 1e3


def profile(device, hw: int = 128, iters: int = 16,
            config: CanonicalConfig = CanonicalConfig()) -> Dict[str, float]:
    """Every stage's ms at ``hw``² on ``device``, then the three
    differences (``-> topk alone``, ``-> refine alone``, ``-> limbs+select
    alone``)."""
    from improved_body_parts_tpu_torch.tools.stress_grouping import make_crowd_scene

    paf_np, heat_np, _ = make_crowd_scene(8, H=hw, W=hw)
    args = (torch.from_numpy(heat_np).to(device)[None],
            torch.from_numpy(paf_np).to(device)[None],
            torch.full((1,), float(hw * config.stride), device=device))
    rows = {name: stage_ms(fn, args, iters)
            for name, fn in stages(config).items()}
    rows["-> topk alone"] = rows["nms+topk"] - rows["nms"]
    rows["-> refine alone"] = rows["find_peaks(+refine)"] - rows["nms+topk"]
    rows["-> limbs+select alone"] = (rows["full postproc"]
                                     - rows["find_peaks(+refine)"])
    return rows


def table_lines(rows: Dict[str, float], device, hw: int, P: int) -> list:
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    return ([f"{name:24s} {ms:8.3f} ms" for name, ms in rows.items()]
            + [f"(device: {where}, map {hw}x{hw}, P={P})"])


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--hw", type=int, default=128, help="stride-map size")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    config = CanonicalConfig()
    rows = profile(device, args.hw, args.iters, config)
    for line in table_lines(rows, device, args.hw, config.infer.max_peaks):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
