"""End-to-end inference benchmark at 512x512 on the card: the IMHN forward
with flip TTA, the post-processing on the card (peaks, limb scores, greedy
connection selection) and the person assembly on the host.

    python -m improved_body_parts_tpu_torch.apps.bench
    python -m improved_body_parts_tpu_torch.apps.bench --quantize int8
    python -m improved_body_parts_tpu_torch.apps.bench --fused-peaks
    python -m improved_body_parts_tpu_torch.apps.bench --device cpu \
        --config <name> --image-size 128          # a small config, CPU

Port of the JAX package's ``bench.py`` with its protocol: batches of
``BATCH`` frames, ``N_BATCHES`` of them served by ``PIPELINE_DEPTH``
threads, the inputs staged on the card as uint8 once; each batch is the
flip-averaged forward (``Predictor._flip_avg_maps``) and the
post-processing (``Predictor._postprocess``), the counterpart of JAX's
``_device_fn_batch``, with one packed fetch a batch, then the C++ grouping
of every frame inline (``ops/group_cpp``; a failure to build it fails the
run).

Random weights find no peaks, which would make the grouping trivially
fast; without ``--checkpoint`` the timed loop therefore groups realistic
tables: the same post-processing run once on GT-rendered multi-person
scene maps (``realistic_packed_buffers``). The post-processing's cost on
the card does not depend on the content (fixed shapes); only the host's
grouping does. With ``--checkpoint`` the network's own tables are grouped.

The reference pipeline runs 7.3 frames/s end to end (Python + C++
pafprocess on a 2080 Ti, reference README.md:37,125). One JSON line on
stdout: ``{"metric", "value", "unit", "vs_baseline"}``; the full-ingest
rate (``predict_batch`` from host frames), the single-image latency and the
device on stderr. Runs on the card unless ``--device cpu`` is given, and
raises when there is no card and no ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import CanonicalConfig
from improved_body_parts_tpu_torch.infer.predict import unpack_results
from improved_body_parts_tpu_torch.ops import group, group_cpp
from improved_body_parts_tpu_torch.ops.limbs import connections_to_list
from improved_body_parts_tpu_torch.utils.profiling import sync

BASELINE_E2E_FPS = 7.3
BATCH = 8
N_BATCHES = 12
PIPELINE_DEPTH = 4
METRIC = "e2e_fps_512_flipTTA_net_grouping"


def realistic_packed_buffers(predictor, n: int, size: int = 512) -> List[np.ndarray]:
    """Packed peak/connection tables of ``n`` GT-rendered multi-person
    scenes (``SyntheticDataset(CanonicalConfig())`` at ``size``²), each
    through the predictor's own post-processing on its device: realistic
    content for the inline grouping when the weights find no people."""
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(CanonicalConfig(), length=n, image_size=size)
    dev = predictor.device
    hs = torch.full((1,), float(size), device=dev)
    chws = torch.tensor([[float(size), float(size)]], device=dev)
    bufs = []
    with torch.inference_mode():
        for i in range(n):
            heat50 = torch.from_numpy(ds[i][2]).to(dev)[None]  # GT layout
            bufs.append(predictor._postprocess(heat50, hs, chws)[0][0]
                        .cpu().numpy())
    return bufs


def group_frame(buf: np.ndarray, config) -> int:
    """Group one packed table into people on the host (C++); the count."""
    P = config.infer.max_peaks
    peaks_np, conns_np = unpack_results(buf, P)
    connected = connections_to_list(conns_np, P, config.limbs_conn)
    cands = group.build_joint_candidates(peaks_np.xy, peaks_np.score,
                                         peaks_np.valid)
    table, jc = group_cpp.find_humans(connected, cands, config.infer)
    group.humans_to_keypoints(table, jc)
    return len(table)


def _serve(fn, n_batches: int, depth: int) -> float:
    """``n_batches`` calls of ``fn(slot)`` spread over ``depth`` threads
    (slot = the thread's), each taking the next batch until none is left;
    the wall seconds. A call's exception is raised here."""
    work_q = queue.Queue()
    for i in range(n_batches):
        work_q.put(i)

    def worker(slot):
        while True:
            try:
                work_q.get_nowait()
            except queue.Empty:
                return
            fn(slot)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(depth) as pool:
        futs = [pool.submit(worker, s) for s in range(depth)]
        for f in futs:
            f.result()
    return time.perf_counter() - t0


def run(predictor, frames: Sequence[np.ndarray],
        realistic_bufs: Optional[Sequence[np.ndarray]] = None, *,
        n_batches: int = N_BATCHES, log=None) -> dict:
    """The benchmark over ``predictor`` (module docstring). ``frames``:
    one (B, H, W, 3) uint8 batch per pipeline slot (``PIPELINE_DEPTH`` of
    them); ``realistic_bufs``: B packed tables to group in place of the
    network's own (None groups the network's). Returns the rates and
    times; ``log`` (a print function) gets the stderr lines."""
    config = predictor.config
    dev = predictor.device
    depth = len(frames)
    B, H, W = frames[0].shape[:3]

    # warm-up of both paths (cuDNN plans, kernel build), then the latency
    predictor.predict_batch(frames[0])
    predictor.predict_skeletons(frames[0][0])
    sync(dev)
    t0 = time.perf_counter()
    predictor.predict_skeletons(frames[0][0])
    single_latency = time.perf_counter() - t0

    # the headline: inputs staged on the card once, as uint8
    staged = [torch.from_numpy(np.ascontiguousarray(f)).to(dev) for f in frames]
    hs = torch.full((B,), float(H), device=dev)
    chws = torch.tensor([[float(H), float(W)]] * B, device=dev)

    def device_round(slot: int) -> int:
        with torch.inference_mode():
            imgs = staged[slot].to(torch.float32) / 255.0
            avg = predictor._flip_avg_maps(imgs)
            packed = predictor._postprocess(avg, hs, chws)[0]
            bufs = packed.cpu().numpy()               # one fetch a batch
        return sum(group_frame(bufs[b] if realistic_bufs is None
                               else realistic_bufs[b], config)
                   for b in range(B))

    warm_found = device_round(0)
    wall = _serve(device_round, n_batches, depth)
    n_frames = n_batches * B
    fps = n_frames / wall
    # secondary: full ingest, the host frames copied to the card each batch
    ingest_fps = n_frames / _serve(
        lambda slot: predictor.predict_batch(frames[slot]), n_batches, depth)

    where = (f"{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
             else "cpu")
    out = dict(fps=fps, wall_s=wall, n_frames=n_frames, ingest_fps=ingest_fps,
               single_latency_ms=single_latency * 1e3, warm_found=warm_found,
               batch=B, depth=depth, device=where)
    if log is not None:
        log(f"{'GT-table' if realistic_bufs is not None else 'network-table'} "
            f"grouping inline: {warm_found} persons found in the warm-up batch "
            f"of {B}")
        log(f"net+postproc+inline grouping: {n_frames} frames in {wall:.2f}s "
            f"(batch={B}, pipeline={depth}) -> {fps:.2f} FPS; with the image "
            f"upload (predict_batch): {ingest_fps:.2f} FPS; single-image "
            f"latency {single_latency * 1e3:.1f} ms (device: {where})")
    return out


def result_line(fps: float) -> dict:
    """The benchmark's JSON line (the JAX bench.py's keys)."""
    return {"metric": METRIC, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_E2E_FPS, 2)}


def bench_frames(size: int, synthetic: bool) -> List[np.ndarray]:
    """``PIPELINE_DEPTH`` batches of ``BATCH`` uint8 frames: noise from
    seed 0, or rendered multi-person scenes."""
    if synthetic:
        from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
        ds = SyntheticDataset(CanonicalConfig(), length=BATCH * PIPELINE_DEPTH,
                              image_size=size)
        imgs = [(ds[i][0] * 255).astype(np.uint8)
                for i in range(BATCH * PIPELINE_DEPTH)]
        return [np.stack(imgs[d * BATCH:(d + 1) * BATCH])
                for d in range(PIPELINE_DEPTH)]
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, (BATCH, size, size, 3), np.uint8)
            for _ in range(PIPELINE_DEPTH)]


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import (
        build_predictor, default_device,
    )
    from improved_body_parts_tpu_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default="",
                    help="reference-layout or port .pth (with --quantize "
                         "int8 also an int8 .pth): bench with trained "
                         "weights, grouping the network's own tables")
    ap.add_argument("--synthetic-frames", action="store_true",
                    help="bench on rendered multi-person scenes instead of "
                         "noise (pairs with --checkpoint)")
    ap.add_argument("--quantize", default="", choices=["", "int8"],
                    help="the int8 forward (models/quantize.py): an int8 "
                         ".pth, or PTQ calibrated on 8 synthetic scenes")
    ap.add_argument("--fused-peaks", action="store_true",
                    help="the fused peak kernel in the post-processing")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    config = get_config(args.config)
    log = lambda s: print(s, file=sys.stderr, flush=True)
    with contextlib.redirect_stdout(sys.stderr):   # stdout: the JSON line
        predictor = build_predictor(args.checkpoint, config, device=device,
                                    quantize=args.quantize)
    predictor.fused_peaks = args.fused_peaks
    if args.checkpoint:
        log(f"benching with checkpoint {args.checkpoint}")
    frames = bench_frames(args.image_size, args.synthetic_frames)
    bufs = (None if args.checkpoint
            else realistic_packed_buffers(predictor, BATCH, args.image_size))
    out = run(predictor, frames, bufs, n_batches=N_BATCHES, log=log)
    print(json.dumps(result_line(out["fps"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
