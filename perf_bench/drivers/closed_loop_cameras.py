"""Closed-loop cameras through the program's ``PipelinedServer``.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "closed_loop_cameras"``):
``cameras`` (clients, each with one frame in flight: it submits its next
frame when its last skeletons return, the "latest frame" loop of a
real-time pose demo), ``frames`` (distinct frames rendered from the seed,
shared out as a block a camera, so no two frames in flight are the same),
``frame_size`` (the frames' side in pixels), ``people`` ([min, max] a
scene), ``batch_size`` and ``depth`` (the server's), ``dtype`` (the
network's compute type), ``init`` (``weights.INITS``), ``warm_batches``
(batches served before the window opens), ``sample_batches`` (batches of
the window whose answers are checked, drawn from the seed among its first
``sample_from``), ``reference_chunk`` (frames a reference forward).

The window runs from one batch's return to another's: it opens at the
first return once the loop runs warm, and closes at the first return
``--seconds`` or more later. The frames of every batch that returns in it
count (whole batches, so the count has no edge), each with its latency from
its submit. Then the cameras stop, the loop drains, the server closes, and
the sampled batches are checked (``compare``): the flip-averaged maps the
program computed against the plain fp32 network on the same frames, and
the skeletons each camera received against the plain post-processing and
Python assembly of those same maps (the program's own maps: the greedy
assembly turns a rounding-level change of a map into a different person
table, so the skeletons are judged from the maps they came from, and the
maps on their own).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from perf_bench import core, scenes, weights
from perf_bench.reference import model as ref_model
from perf_bench.reference import post as ref_post
from perf_bench.timers import DeviceTrace, Spans

FINGERPRINT = 256        # bytes of a frame that identify it


class Camera:
    """One client: its block of frames and its submissions
    (submit time, frame index, return time, result)."""

    def __init__(self, frames: List[int]):
        self.frames = frames
        self.k = 0
        self.log: List[list] = []


class Loop:
    """The cameras around one server: each resubmits from the server's
    completion callback until ``t_close``. ``returns`` holds (time, frames)
    of each batch the server has delivered."""

    def __init__(self, server, frames: np.ndarray, cameras: List[Camera]):
        self.server, self.frames, self.cameras = server, frames, cameras
        self.t_close = float("inf")
        self.lock = threading.Lock()
        self.in_flight = 0
        self.idle = threading.Event()
        self.returns: List[tuple] = []
        self.returned = threading.Condition()
        run_batch = server._run_batch

        def counted_run_batch(items):
            run_batch(items)       # delivers every frame of the batch
            with self.returned:
                self.returns.append((time.perf_counter(), len(items)))
                self.returned.notify_all()
        server._run_batch = counted_run_batch

    def next_return(self, after: float) -> float:
        """The time of the first batch delivered after ``after``."""
        with self.returned:
            while True:
                later = [t for t, _ in self.returns if t > after]
                if later:
                    return min(later)
                self.returned.wait()

    def submit(self, cam: Camera) -> None:
        idx = cam.frames[cam.k % len(cam.frames)]
        cam.k += 1
        entry = [time.perf_counter(), idx, None, None, None]
        cam.log.append(entry)
        with self.lock:
            self.in_flight += 1
        fut = self.server.submit(self.frames[idx])
        fut.add_done_callback(lambda f: self.done(cam, entry, f))

    def done(self, cam: Camera, entry: list, fut) -> None:
        entry[2] = time.perf_counter()
        exc = fut.exception()
        entry[3 if exc is None else 4] = fut.result() if exc is None else exc
        if entry[2] < self.t_close:
            self.submit(cam)
        with self.lock:
            self.in_flight -= 1
            if self.in_flight == 0:
                self.idle.set()

    def start(self) -> None:
        for cam in self.cameras:
            self.submit(cam)


def build_model(job: core.Job, model_cfg: dict, dtype, init: str):
    """The program's network with the seed's weights, on the card."""
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    cfg = job.program_config
    spec = weights.spec(ref_model.build(model_cfg, device="meta"))
    sd = weights.make(spec, job.seed, job.device, init)
    model = PoseNet(cfg.model, device="meta", compute_dtype=dtype)
    model = model.to_empty(device=job.device)
    model.load_state_dict(sd, strict=True)
    del sd
    if job.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def fingerprint_positions(size: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed % 2 ** 32)
    return rng.randint(0, size * size * 3, FINGERPRINT)


def run(job: core.Job) -> core.Outcome:
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.infer.serving import PipelinedServer

    tr, cfg, dev = job.traffic, job.program_config, job.device
    # the set-up's parts, each by the time it ended
    parts = {"process_and_imports": time.perf_counter()}
    size = tr["frame_size"]
    rng = np.random.RandomState(job.seed % 2 ** 32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(job.seed % 2 ** 63)

    model = build_model(job, job.config["model"], core.dtype(tr["dtype"]), tr["init"])
    people = scenes.draw_people(tr["frames"], size, tuple(tr["people"]), rng)
    frames = scenes.paint(people, size, gen, dev).cpu().numpy()
    if job.candidate == "int8":
        # the control: the program's own int8 path, calibrated on frames of
        # the mix
        from improved_body_parts_tpu_torch.models.quantize import quantize_model
        calib = [frames[i:i + 4].astype(np.float32) / 255.0 for i in (0, 4)]
        model = quantize_model(model, calib)
    pred = Predictor(model, cfg, device=dev)

    pos = fingerprint_positions(size, job.seed)
    by_print = {frames[i].reshape(-1)[pos].tobytes(): i for i in range(len(frames))}
    if len(by_print) != len(frames):
        raise RuntimeError("two frames of the mix share a fingerprint")
    block = tr["frames"] // tr["cameras"]
    cameras = [Camera(list(range(c * block, (c + 1) * block)))
               for c in range(tr["cameras"])]

    # -- the harness's spans around the program's calls, and the sample -------
    spans = Spans()
    local = threading.local()
    records: List[Dict] = []
    window = {"open": float("inf"), "close": float("inf"), "index": 0}
    sample_rng = np.random.RandomState((job.seed + 1) % 2 ** 32)
    keep_at = set(sample_rng.choice(tr["sample_from"], tr["sample_batches"],
                                    replace=False).tolist())
    predict_batch, postprocess = pred.predict_batch, pred._postprocess
    counter_lock = threading.Lock()

    def wrapped_predict_batch(imgs, *args, **kwargs):
        t = time.perf_counter()
        keep = False
        if window["open"] <= t < window["close"]:
            with counter_lock:
                keep = window["index"] in keep_at
                window["index"] += 1
        local.maps = None
        local.keep = keep
        with spans.span("predict_batch"):
            out = predict_batch(imgs, *args, **kwargs)
        if keep:
            records.append(dict(t=t, imgs=imgs, maps=local.maps,
                                img_hs=np.asarray(kwargs["img_hs"]),
                                content_hws=np.asarray(kwargs["content_hws"])))
        return out

    def wrapped_postprocess(avg, *args, **kwargs):
        if getattr(local, "keep", False):
            local.maps = avg
        return postprocess(avg, *args, **kwargs)

    pred.predict_batch = wrapped_predict_batch
    pred._postprocess = wrapped_postprocess

    # -- warm-up: the shapes of this cell, then the loop until it runs warm ---
    parts["weights_frames_predictor"] = time.perf_counter()
    pred.predict_batch(frames[:tr["batch_size"]], use_cpp=True)
    parts["first_batch"] = time.perf_counter()
    server = PipelinedServer(pred, batch_size=tr["batch_size"], depth=tr["depth"],
                             use_cpp=True)
    loop = Loop(server, frames, cameras)
    loop.start()
    while len(spans.items) < tr["warm_batches"] + 1:
        time.sleep(0.01)
    parts["warm_batches"] = time.perf_counter()
    trace = DeviceTrace(spans) if job.trace else None
    if trace is not None:
        trace.start()
    t_open = loop.next_return(time.perf_counter())
    window["open"] = t_open
    window["close"] = loop.t_close = t_open + job.seconds
    time.sleep(max(0.0, loop.t_close - time.perf_counter()))
    t_close = loop.next_return(loop.t_close)
    window["close"] = t_close
    trace_result = trace.stop() if trace is not None else None
    loop.idle.wait(timeout=600)
    server.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- the window's numbers ---------------------------------------------------
    entries = [e for cam in cameras for e in cam.log]
    returned = [e for e in entries if e[2] is not None and t_open < e[2] <= t_close]
    batches = [n for t, n in loop.returns if t_open < t <= t_close]
    lat_ms = [(e[2] - e[0]) * 1e3 for e in returned]
    failed = sum(1 for e in entries if e[4] is not None
                 or (e[2] is None and e[0] < t_close))
    calls = spans.within("predict_batch", t_open, t_close)
    end_to_end = {
        "serve_frames_per_s": sum(batches) / (t_close - t_open),
        "setup_s": t_open - job.setup_origin,
    }
    job.setup_parts.update(core.setup_parts(job.setup_origin, parts, t_open))
    layer = dict(frames_returned=sum(batches), window_s=t_close - t_open,
                 batches_returned=len(batches), batch_size=tr["batch_size"],
                 predict_batch_ms=[(b - a) * 1e3 for a, b in calls],
                 latency_ms=lat_ms, frame_size=size, model=job.config["model"])

    # -- the comparison, after the program's state is freed ----------------------
    del pred.predict_batch, pred._postprocess
    del server, loop, pred, model, predict_batch, postprocess
    del wrapped_predict_batch, wrapped_postprocess
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(job, records, cameras, by_print, pos)
    return core.Outcome(attempted=len(entries), failed=failed,
                        end_to_end=end_to_end, layer=layer, checks=checks,
                        memory_peak_bytes=memory_peak, trace=trace_result)


def delivered(cameras: List[Camera], idx: int, t: float):
    """What the camera that owns frame ``idx`` received for the submission
    of it in flight at ``t``."""
    for cam in cameras:
        if cam.frames[0] <= idx <= cam.frames[-1]:
            for sub_t, i, ret_t, result, exc in cam.log:
                if i == idx and sub_t <= t and ret_t is not None and ret_t >= t:
                    return result
    return None


@torch.no_grad()
def compare(job: core.Job, records: List[Dict], cameras: List[Camera],
            by_print: dict, pos: np.ndarray) -> List[core.Check]:
    """The sampled batches against the plain reference (module docstring).
    ``maps_gap_vs_bf16``: the largest, over the frames, of the gap of the
    program's flip-averaged maps from the fp32 network's (L2 over the
    frame's maps), in units of the gap of the same network computed in
    bf16 (``reference.model.bf16_round``) on the same frame: the program's
    departure measured in the rounding of the type the configuration
    states, so that the weights' and the frame's conditioning cancel.
    ``people_mismatch``: the frames whose person count differs from the
    plain assembly of the program's maps (or that no camera received).
    ``keypoint_gap``: the largest gap of a keypoint's x, y or a person's
    score there, in pixels and score units."""
    lim = job.limits
    dev = job.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    spec = weights.spec(ref_model.build(job.config["model"], device="meta"))
    ref = ref_model.build(job.config["model"], device="meta").to_empty(device=dev)
    ref.load_state_dict(weights.make(spec, job.seed, dev, job.traffic["init"]))
    chunk = job.traffic["reference_chunk"]

    def flip_maps(imgs, lower=None):
        out = []
        for i in range(0, imgs.shape[0], chunk):
            x = imgs[i:i + chunk]
            both = ref.predict_maps(torch.cat([x, x.flip(2)]), lower=lower)
            out.append(ref_post.flip_average(both[:x.shape[0]], both[x.shape[0]:]))
        return torch.cat(out)

    def l2(t):
        return torch.linalg.vector_norm(t.flatten(1), dim=1)

    gap, rel, mismatch, kp_gap, people = [], [], 0, 0.0, 0
    records = [r for r in records if r["maps"] is not None]
    for rec in records:
        imgs = torch.from_numpy(rec["imgs"]).to(dev).float() / 255.0
        want = flip_maps(imgs)
        low = flip_maps(imgs, ref_model.bf16_round)
        got = rec["maps"].float()
        gap.extend((l2(got - want) / l2(low - want)).tolist())
        rel.extend((l2(got - want) / l2(want)).tolist())
        skel = ref_post.skeletons(got, torch.from_numpy(rec["img_hs"]).to(dev),
                                  torch.from_numpy(rec["content_hws"]).to(dev),
                                  stride=job.ref_config.stride,
                                  icfg=job.ref_config.infer)
        for b in range(len(rec["imgs"])):
            idx = by_print.get(rec["imgs"][b].reshape(-1)[pos].tobytes())
            got_b = None if idx is None else delivered(cameras, idx, rec["t"])
            kps_w, sc_w = skel[b]
            people += len(kps_w)
            if got_b is None or len(got_b[0]) != len(kps_w):
                mismatch += 1
                continue
            if len(kps_w):
                kp_gap = max(kp_gap, float(np.abs(got_b[0][..., :2] - kps_w[..., :2]).max()),
                             float(np.abs(got_b[1] - sc_w).max()))
    missing = job.traffic["sample_batches"] - len(records)
    job.diagnostics.update(
        frames_checked=len(gap), people_found=people,
        maps_rel_l2_max=max(rel, default=None),
        maps_gap_vs_bf16_median=float(np.median(gap)) if gap else None,
        reference_s=time.perf_counter() - t_ref)
    return [core.Check("sampled_batches_missing", float(missing), 0.0),
            core.Check("maps_gap_vs_bf16", max(gap, default=0.0), lim["maps_gap_vs_bf16"]),
            core.Check("people_mismatch", float(mismatch), lim["people_mismatch"]),
            core.Check("keypoint_gap", kp_gap, lim["keypoint_gap"])]
