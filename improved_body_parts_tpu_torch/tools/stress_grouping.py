"""The post-processing and the host grouping at COCO-crowd scale.

    python -m improved_body_parts_tpu_torch.tools.stress_grouping
    python -m improved_body_parts_tpu_torch.tools.stress_grouping --device cpu \
        --people 2 8 --iters 3

Port of the JAX package's ``tools/stress_grouping.py``. It builds N-person
scenes (full 18-joint skeletons on 128x128 stride maps, the maps of a 512²
frame), runs the real post-processing (``find_peaks`` with the ``nms``
kernel, ``score_connections``, ``select_connections``) on the card, and
measures on the host:

  * the grouping's ms a frame, numpy and C++ (reference counterpart:
    pafprocess.cpp:26-309, whose capacities pafprocess.h:6-17 cap silently);
  * the top-P saturation: raw NMS peaks against the P-slot tables
    (``peaks.n_raw``);
  * the persons recovered against the people drawn.

One JSON line a scene size on stdout (the JAX tool's keys, plus the
device), a summary on stderr. Runs on the card unless ``--device cpu`` is
given, and raises when there is no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import (
    CanonicalConfig, LIMBS_CONN, NUM_PARTS, PAF_LAYERS,
)


def make_crowd_scene(n_people: int, H: int = 128, W: int = 128, seed: int = 0):
    """N full-skeleton people on (H, W) stride maps, on a jittered grid:
    dense crowding, but peaks that stay mostly resolvable (the COCO-crowd
    regime). Returns (paf (H, W, 30), heat (H, W, 18), joints (N, 18, 2)
    in stride coordinates), float32."""
    from improved_body_parts_tpu_torch.apps.demo_image import (
        _gaussian_blob, _limb_band,
    )
    from improved_body_parts_tpu_torch.data.synthetic import _TEMPLATE

    rng = np.random.RandomState(seed)
    cols = int(np.ceil(np.sqrt(n_people)))
    rows = int(np.ceil(n_people / cols))
    heat = np.zeros((H, W, NUM_PARTS), np.float32)
    paf = np.zeros((H, W, PAF_LAYERS), np.float32)
    joints = np.zeros((n_people, NUM_PARTS, 2), np.float32)
    for i in range(n_people):
        r, c = divmod(i, cols)
        cell_h, cell_w = H / rows, W / cols
        cy = (r + 0.5) * cell_h + rng.uniform(-0.1, 0.1) * cell_h
        cx = (c + 0.5) * cell_w + rng.uniform(-0.1, 0.1) * cell_w
        scale = min(cell_h, cell_w) * rng.uniform(0.7, 0.95)
        pts = (_TEMPLATE - [0.5, 0.5]) * scale + [cx, cy]
        pts += rng.normal(0, 0.3, pts.shape)
        pts[:, 0] = np.clip(pts[:, 0], 1, W - 2)
        pts[:, 1] = np.clip(pts[:, 1], 1, H - 2)
        joints[i] = pts
        for j in range(NUM_PARTS):
            heat[:, :, j] = np.maximum(
                heat[:, :, j], _gaussian_blob((H, W), pts[j, 0], pts[j, 1],
                                              sigma=1.2))
        for li, (fr, to) in enumerate(LIMBS_CONN):
            paf[:, :, li] = np.maximum(
                paf[:, :, li],
                _limb_band((H, W), pts[fr, 0], pts[fr, 1],
                           pts[to, 0], pts[to, 1], sigma=1.0))
    return paf, heat, joints


def scene_tables(paf: np.ndarray, heat: np.ndarray, device, config=None):
    """One scene's maps through the post-processing on ``device`` (the
    limb-length prior of a 512-pixel frame) -> (host PeakTable, the
    reference's connection list)."""
    from improved_body_parts_tpu_torch.ops.limbs import (
        connections_to_numpy, score_connections, select_connections,
    )
    from improved_body_parts_tpu_torch.ops.peaks import PeakTable, find_peaks

    config = config or CanonicalConfig()
    icfg = config.infer
    with torch.inference_mode():
        h = torch.from_numpy(heat).to(device)[None]
        p = torch.from_numpy(paf).to(device)[None]
        peaks = find_peaks(h, thre=icfg.thre1, max_peaks=icfg.max_peaks,
                           stride=config.stride)
        cand = score_connections(p, peaks.xy, peaks.score, peaks.valid,
                                 torch.full((1,), 512.0, device=device),
                                 mid_num=icfg.mid_num, stride=config.stride,
                                 thre2=icfg.thre2,
                                 connect_ration=icfg.connect_ration)
        conns = select_connections(cand, peaks.valid)
        peaks1 = PeakTable(*(t[0] for t in peaks))
        connected = connections_to_numpy(type(conns)(*(t[0] for t in conns)),
                                         peaks1)
        host = PeakTable(*(t.cpu().numpy() for t in peaks1))
    return host, connected


def run_scene(n_people: int, iters: int, device, seed: int = 0) -> dict:
    """The JAX tool's ``run_scene``: one scene of ``n_people``, its tables
    on ``device``, the grouping timed on the host (median of ``iters``)."""
    from improved_body_parts_tpu_torch.ops import group, group_cpp

    icfg = CanonicalConfig().infer
    paf, heat, _ = make_crowd_scene(n_people, seed=seed)
    peaks, connected = scene_tables(paf, heat, device)
    n_conns = int(sum(len(c) for c in connected))
    dropped = int(np.maximum(peaks.n_raw - icfg.max_peaks, 0).sum())

    def time_grouper(grouper):
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            c = group.build_joint_candidates(peaks.xy, peaks.score, peaks.valid)
            table, jc = grouper(connected, c, icfg)
            group.humans_to_keypoints(table, jc)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), table

    np_ms, np_table = time_grouper(group.find_humans)
    cpp_ms, cpp_table = time_grouper(group_cpp.find_humans)
    if len(cpp_table) != len(np_table):
        raise AssertionError("numpy and C++ grouping found different "
                             f"person counts: {len(np_table)} vs "
                             f"{len(cpp_table)}")
    return {
        "people": n_people,
        "raw_peaks_total": int(peaks.n_raw.sum()),
        "peaks_dropped": dropped,
        "max_raw_per_type": int(peaks.n_raw.max()),
        "P": icfg.max_peaks,
        "connections": n_conns,
        "persons_found": int(len(np_table)),
        "group_numpy_ms": round(np_ms * 1e3, 3),
        "group_cpp_ms": round(cpp_ms * 1e3, 3),
    }


def summary(stats: dict) -> str:
    return (f"people={stats['people']:3d} raw={stats['raw_peaks_total']:4d} "
            f"dropped={stats['peaks_dropped']:3d} "
            f"conns={stats['connections']:4d} found={stats['persons_found']:3d} "
            f"numpy={stats['group_numpy_ms']:.2f}ms "
            f"cpp={stats['group_cpp_ms']:.2f}ms")


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--people", type=int, nargs="+", default=[2, 8, 15, 20, 32])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    for n in args.people:
        stats = run_scene(n, args.iters, device)
        print(json.dumps(dict(stats, device=where)), flush=True)
        print(summary(stats), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
