#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``improved_body_parts_tpu_torch``) on
one NVIDIA GPU: builds the CUDA kernels from ``csrc/``, checks each against
its plain PyTorch version (``fused_peaks`` on an edge-case grid at three map
shapes) and times it beside its bound, runs the full-width ``Canonical``
model, the
post-processing on GT-rendered scenes, the batched flip-TTA serving path
behind ``PipelinedServer``, multi-scale and rotation TTA (single image, fp32
against the CPU; served, bf16), and the port's evaluator and demo entry
points on in-memory synthetic frames (the card's machine has no cv2); then
trains: train steps of the full-width model at 512², batch 8, with the
dense and the compact-u8 feed through the trainer's loader and staging
(step time, images/s, peak memory; for the dense feed the profiler's busy
share and top operations), one step with remat, a step of the tiny model on the card
against the CPU (fp32 with frozen BN, float64 in train mode), the
abnormal-loss rollback, checkpoint resume, a trained
checkpoint served through ``apps.evaluate.build_predictor``, and a falling
loss; then the model variants (FinalAttention and Independent at full width
served through ``apps.demo_image.build_predictor``, AEPoseNet trained at
Canonical widths through the ``apps.train`` path, a tiny fp32 forward of
each variant on the card against the CPU); then int8: ``int8_conv`` bit for
bit against its plain version on an edge grid and at every distinct conv
shape of a Canonical int8 ``predict_maps`` of 16 frames, timed beside its
bound, the plain version and the unfold + ``torch._int_mm`` route; the
Canonical post-training quantization (fold, calibrate on 8 synthetic
scenes), the int8 maps against the bf16 folded maps, the int8 network and
``PipelinedServer`` with ``int8_conv`` launched once per conv block per
batch, and the int8 ``.pth`` served from the file; then training with the
device-resident feed and the K-steps dispatch (phase 11): the resident
preprocessing against the CPU, Canonical resident steps at 512², batch 8,
eagerly (K = 1) and replayed from a CUDA graph of the captured step
(K = 4), each with its step time, images/s and memory (the graph's busy
share and host launch calls beside phase 8's eager step's), graph against
eager (bf16 train mode, and bit for bit in fp32 with frozen BN), the rollback inside a replay, remat and the SWA graph on
the graph, the dense feed on the graph through the loader, and
``apps.train --feed resident --steps-per-dispatch 4`` written and resumed;
then multi-GPU on the card(s) there are (phase 12): ``predict_batch(mesh=)``
on a mesh of the card and on one that lists it twice, against unsharded
serving (fp32 packed buffers bit for bit, bf16 people and peaks) and
``PipelinedServer(mesh=)``'s frames/s; two gloo ranks sharing the card
(``torch.multiprocessing``, at 256²) with the resident store sharded over
them, against one process at the whole batch (bf16 train-mode losses, fp32
frozen-BN parameters); one NCCL rank with its all-reduces captured in the
CUDA graph of the K = 4 step, beside phase 11's graph step and bit for bit
against eager; ``apps.train`` under ``torchrun --nproc-per-node 1``
written and resumed, and the dry run
(``improved_body_parts_tpu_torch.tools.dryrun_multichip``) over the cards,
both in processes of their own beside the gloo ranks and the NCCL
rank's fp32 check;
and the letterbox without cv2 on camera-sized frames (equal to a plain
numpy version, timed) with 64 640x480 requests served; then the
measurement and evaluation entry points (phase 13), each through the
function its CLI wraps: ``apps.bench`` with its full protocol on the bf16,
fused and int8 arms (each kernel's launches counted exactly),
``apps.inference_speed`` with MFU, ``tools.profile_postproc``'s stages,
``tools.stress_grouping`` at 2, 8 and 20 people, ``tools.bench_train_step``
(dense K = 1, resident K = 4 on the graph), ``tools.export_quantized`` on
an ``apps.train``-layout ``.pth`` served bit for bit from the file,
``tools.eval_curve`` over two epochs and ``tools.e2e_trained_smoke``'s
scoring; then the ``spatial`` mesh axis (phase 14): the full-width
``Canonical`` train step at 512² with the image height sharded over two
gloo ranks sharing the card (data 1 × spatial 2, halos exchanged around
every conv), against one process on the same global batch of 2 (fp32
frozen-BN parameters and losses, bf16 train-mode losses), with its ms a
step, peak GiB a rank and halo exchanges a step, and the gloo reason its
K-steps dispatch runs eagerly; last, image files and the
remaining tools (phase 15): a synthetic set written as PNG and read back
through the port's own codec (``utils/imageio``, no cv2), bit for bit,
``apps.evaluate.main`` on that directory against the in-memory frames,
``tools.eval_tta_split`` against the fused TTA, and the ``visual`` scripts.

    python3 chip_smoke.py

Phases print on earlier lines; any failure raises and the exit code is not
0 (a rank that fails or hangs fails phase 12: no rank carries on alone). Without a CUDA device it exits 2 before doing anything. The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launch count in the serving run and per batch, its error against the
plain version, its times (input warm in L2 and cold), its bound, the plain
version's time and, for ``fused_peaks``, the unfused route's; for
``int8_conv`` the sums over one batch's launches, with each shape's row
under ``at_shapes``. Weights are
random, drawn from a seed. Imports no jax and nothing of the JAX package.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 8            # serving batch (bench.py's protocol)
DEPTH = 4            # requests in flight
N_REQUESTS = 64
TIMING_RUNS = 20
CPU = torch.device("cpu")
TTA_SCALES = (0.5, 1.0, 1.5, 2.0)   # the reference INI's scale_search
TTA_DEPTH = 2
TTA_REQUESTS = 32
N_EVAL = 16
TRAIN_BATCH = 8      # the README's JAX training row: batch 8, 512²
TRAIN_WARM = 2
TRAIN_TIMED = 3
TRAIN_PROFILED = 1
TRAIN_DEVICE_RUNS = 2  # the step alone between CUDA events (median)
LEARN_LR = 1e-2      # the raised learning rate of the falling-loss check
LEARN_STEPS = 6      # its steps on one batch
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
# fused_peaks' edge-case grid, held exactly against the plain version at the
# main-path shape (B=8 x 18 maps of 128^2), a 1024^2 frame's 256^2 maps and
# a 1088x1920 frame's 272x480 maps
EDGE_SHAPES = ((144, 128, 128), (18, 256, 256), (18, 272, 480))
EDGE_THRES = (0.1, 0.0, -0.2)
EDGE_PEAKS = (1, 8, 33)
EDGE_FOOTPRINTS = (("plus", 2), ("square", 1))


_START = time.perf_counter()


def phase(name: str) -> None:
    """The phase's header on stdout; the seconds since the start on stderr,
    so the run's time can be split by phase."""
    print(f"== {name}", flush=True)
    print(f"chip_smoke: phase {name.split()[0]} starts at "
          f"{time.perf_counter() - _START:.1f} s", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


_flush = []


def device_ms(fn, runs: int = TIMING_RUNS, cold: bool = False) -> float:
    """Median per-call time between two CUDA events, after 3 warm-up calls.
    A sleep kernel queued first keeps the card busy while the host enqueues
    the call, so launch latency is hidden wherever the host keeps ahead.
    ``cold`` writes 256 MB before each call (outside the events), so the
    call finds its inputs in device memory and not in the 50 MB L2."""
    if cold and not _flush:
        _flush.append(torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if cold:
            _flush[0].zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over tensors of any dtype; shapes must match."""
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        errs.append((g.double() - w.double()).abs().max().item() if g.numel() else 0.0)
    return max(errs)


def main_path_maps(device) -> torch.Tensor:
    """(144, 128, 128): B=8 x 18 joint maps at 512^2; channel 3 saturated
    (a checkerboard of isolated maxima, n_raw >> 32)."""
    g = torch.Generator().manual_seed(SEED)
    heat = torch.rand((BATCH * 18, 128, 128), generator=g) * 0.6
    checker = (torch.arange(128)[:, None] + torch.arange(128)[None]) % 2 == 0
    heat[3] = torch.where(checker, heat[3] + 0.5, torch.zeros(()))
    return heat.to(device)


def edge_maps(shape, device) -> torch.Tensor:
    """Maps of ``shape`` whose channel c is case c % 8 of: noise; a
    checkerboard of isolated maxima (n_raw >> P); noise with -0 and +0
    ties; all zeros; a constant plateau of -0.1 (every cell kept and
    negative when thre < -0.1); a constant plateau of -0.5 (nothing kept);
    signed noise; a constant plateau of 0.25 (every cell kept)."""
    k, h, w = shape
    g = torch.Generator().manual_seed(SEED + h)
    noise = torch.rand(shape, generator=g)
    checker = (torch.arange(h)[:, None] + torch.arange(w)[None]) % 2 == 0
    case = torch.arange(k)[:, None, None] % 8
    zero, nzero = torch.zeros(()), torch.tensor(-0.0)
    heat = torch.where(case == 0, noise * 0.6, zero)
    heat = torch.where(case == 1, torch.where(checker, noise * 0.5 + 0.5, zero), heat)
    ties = torch.where(noise < 0.3, nzero, torch.where(noise < 0.5, zero, noise))
    heat = torch.where(case == 2, ties, heat)
    heat = torch.where(case == 4, torch.tensor(-0.1), heat)
    heat = torch.where(case == 5, torch.tensor(-0.5), heat)
    heat = torch.where(case == 6, noise - 0.5, heat)
    heat = torch.where(case == 7, torch.tensor(0.25), heat)
    return heat.contiguous().to(device)


def unfused_route(kernels, peaks, heat, thre=0.1, max_peaks=32,
                  footprint="plus", win=2):
    """What ``fused_peaks`` stands in for on the unfused path
    (ops/peaks.py find_peaks): the nms kernel, a stable descending sort of
    each map, the top-P cut and the patch gather."""
    k, h, w = heat.shape
    flat = kernels.nms(heat, thre, footprint).reshape(k, h * w)
    top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    idx = idx[:, :max_peaks]
    cy, cx = idx // w, idx % w
    return top[:, :max_peaks], cy, cx, peaks._gather_patches(heat, cy, cx, win)


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` through device memory once."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_fused_edge_grid(kernels, device) -> float:
    """fused_peaks on the edge-case grid at every EDGE_SHAPES shape,
    exact against its plain version (torch.equal on all four outputs)."""
    errs, n = [], 0
    for shape in EDGE_SHAPES:
        heat = edge_maps(shape, device)
        for thre in EDGE_THRES:
            for max_peaks in EDGE_PEAKS:
                for fp, win in EDGE_FOOTPRINTS:
                    got = kernels.fused_peaks(heat, thre, max_peaks, fp, win)
                    want = kernels.fused_peaks_plain(heat, thre, max_peaks, fp, win)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("scores", "yx", "n_raw", "patches"),
                                          got, want):
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"fused_peaks{shape} thre={thre} P={max_peaks} "
                                f"{fp} win={win}: {name} differs")
                    errs.append(max_abs_err(got, want))
                    n += 1
    heat = edge_maps((8, 64, 64), device)
    for max_peaks in (300, 5000):   # lists beyond 48 KB; P above h*w
        got = kernels.fused_peaks(heat, 0.1, max_peaks, "plus")
        want = kernels.fused_peaks_plain(heat, 0.1, max_peaks, "plus")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"fused_peaks P={max_peaks} differs")
        errs.append(max_abs_err(got, want))
        n += 1
    print(f"fused_peaks edge grid: {n} cases exact (shapes {EDGE_SHAPES}, thre "
          f"{EDGE_THRES}, P {EDGE_PEAKS}, (footprint, win) {EDGE_FOOTPRINTS}; "
          "and P 300, 5000 at (8, 64, 64))",
          flush=True)
    return max(errs)


def fused_times(kernels, peaks, heat) -> dict:
    """fused_peaks at the main path's arguments on ``heat``: kernel (input
    warm in L2, as behind the flip average, and cold), plain version,
    the unfused route, and the bound."""
    out = kernels.fused_peaks(heat, 0.1, 32, "plus")
    nbytes = heat.nbytes + sum(t.nbytes for t in out)
    row = dict(shape=list(heat.shape),
               ms=device_ms(lambda: kernels.fused_peaks(heat, 0.1, 32, "plus")),
               ms_cold=device_ms(lambda: kernels.fused_peaks(heat, 0.1, 32, "plus"),
                                 cold=True),
               plain_ms=device_ms(lambda: kernels.fused_peaks_plain(heat, 0.1, 32, "plus")),
               unfused_ms=device_ms(lambda: unfused_route(kernels, peaks, heat)),
               bound_ms=bound_ms(nbytes))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def check_kernels(kernels, peaks, device, smi):
    """Each kernel against its plain version at the main-path shape, exact;
    fused_peaks also on the edge-case grid at every EDGE_SHAPES shape. Then
    each kernel's times beside its bound (device-memory bytes at 3.35 TB/s:
    each input byte read once, each output byte written once)."""
    heat = main_path_maps(device)
    plateau = torch.zeros((1, 8, 8), device=device)
    plateau[0, 3, 3] = plateau[0, 3, 4] = 0.7
    errs = []
    for fp in ("plus", "square"):
        for x in (heat, plateau):
            got = kernels.nms(x, 0.1, fp)
            want = kernels.nms_plain(x, 0.1, fp)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"nms[{fp}] differs from its plain version")
            errs.append(max_abs_err([got], [want]))
    nms_row = dict(
        name="nms", route="cuda", source="improved_body_parts_tpu_torch/csrc/nms.cu",
        replaces="improved_body_parts_tpu/ops/pallas_kernels.py:72",
        max_abs_err=max(errs), shape=list(heat.shape),
        ms=device_ms(lambda: kernels.nms(heat, 0.1, "plus")),
        ms_cold=device_ms(lambda: kernels.nms(heat, 0.1, "plus"), cold=True),
        plain_ms=device_ms(lambda: kernels.nms_plain(heat, 0.1, "plus")),
        bound_ms=bound_ms(2 * heat.nbytes), bound_by="bytes", library_ms=None)
    nms_row["share_of_bound"] = nms_row["bound_ms"] / nms_row["ms"]

    errs = []
    for fp in ("plus", "square"):
        got = kernels.fused_peaks(heat, 0.1, 32, fp)
        want = kernels.fused_peaks_plain(heat, 0.1, 32, fp)
        torch.cuda.synchronize()
        for name, a, b in zip(("scores", "yx", "n_raw", "patches"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"fused_peaks[{fp}] {name} differs")
        if not int(got[2][3]) > 32:
            raise AssertionError("the saturated channel did not saturate")
        errs.append(max_abs_err(got, want))
    errs.append(check_fused_edge_grid(kernels, device))
    times = [fused_times(kernels, peaks, heat)]
    times += [fused_times(kernels, peaks, edge_maps(shape, device))
              for shape in EDGE_SHAPES[1:]]
    fused_row = dict(
        name="fused_peaks", route="cuda",
        source="improved_body_parts_tpu_torch/csrc/fused_peaks.cu",
        replaces="improved_body_parts_tpu/ops/pallas_kernels.py:194",
        max_abs_err=max(errs), **times[0], bound_by="bytes", library_ms=None,
        at_other_shapes=times[1:])
    for r in [nms_row] + times:
        name = "nms" if r is nms_row else "fused_peaks"
        extra = "" if r is nms_row else f", unfused route {r['unfused_ms']:.5f} ms"
        print(f"{name} {tuple(r['shape'])}: kernel {r['ms']:.5f} ms warm in L2 / "
              f"{r['ms_cold']:.5f} ms cold, bound {r['bound_ms']:.5f} ms (share "
              f"{r['share_of_bound']:.3f}), plain {r['plain_ms']:.5f} ms{extra} "
              f"(median of {TIMING_RUNS}, {smi})", flush=True)
    return [nms_row, fused_row]


@torch.no_grad()
def fan_in_init(model: torch.nn.Module, g: torch.Generator) -> None:
    """Random weights that keep activations O(1) through the full-width
    network (the reference init, N(0, 0.001), drives every output to ~0)."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
            m.weight.uniform_(0.5, 1.0, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)


def compare_tables(got: np.ndarray, want: np.ndarray, P: int, unpack) -> float:
    """Decoded tables: masks, counts and slots exactly; floats to 1e-4."""
    worst = 0.0
    for b in range(got.shape[0]):
        gp, gc = unpack(got[b], P)
        wp, wc = unpack(want[b], P)
        for name, a, c in (("peak valid", gp.valid, wp.valid),
                           ("n_raw", gp.n_raw, wp.n_raw),
                           ("conn valid", gc.valid, wc.valid),
                           ("src_slot", gc.src_slot, wc.src_slot),
                           ("dst_slot", gc.dst_slot, wc.dst_slot)):
            if not np.array_equal(a, c):
                raise AssertionError(f"image {b}: {name} differs from the CPU run")
        for a, c in ((gp.xy[gp.valid], wp.xy[wp.valid]),
                     (gp.score[gp.valid], wp.score[wp.valid]),
                     (gc.score[gc.valid], wc.score[wc.valid]),
                     (gc.limb_len[gc.valid], wc.limb_len[wc.valid])):
            if a.size:
                worst = max(worst, float(np.abs(a - c).max()))
    if worst > 1e-4:
        raise AssertionError(f"tables differ from the CPU run by {worst}")
    return worst


def tta_maps_and_serving(model, model_cpu, config, frames, requests, device,
                         smi, net_ms):
    """fp32 single-image TTA maps on the card against the CPU; then bf16
    TTA serving through PipelinedServer, without and with rotation."""
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
    from improved_body_parts_tpu_torch.ops import kernels

    angles = (0.0, 10.0)
    model.compute_dtype = model_cpu.compute_dtype = torch.float32
    p_dev = Predictor(model, config, device=device)
    p_cpu = Predictor(model_cpu, config, device=CPU)
    frame = np.ascontiguousarray(frames[0][:128, :128])
    got = p_dev.predict_maps_tta(frame, TTA_SCALES, angles)
    want = p_cpu.predict_maps_tta(frame, TTA_SCALES, angles)
    scale, err = 0.0, 0.0
    for g_, w in zip(got[1:3], want[1:3]):
        if g_.shape != w.shape or not torch.isfinite(g_).all():
            raise AssertionError("TTA maps: shape or non-finite values")
        scale = max(scale, w.abs().max().item())
        err = max(err, (g_.cpu() - w).abs().max().item())
    tol = 1e-3 * scale
    print(f"fp32 single-image TTA maps of 1 x 128^2, scales {TTA_SCALES} x "
          f"angles {angles}, card vs CPU: max abs err {err:.3e} (maps up to "
          f"{scale:.3f}; tolerance 1e-3 x that = {tol:.3e}: summation order "
          f"differs, TF32 off)", flush=True)
    if not err <= tol:
        raise AssertionError("fp32 TTA maps on the card disagree with the CPU")
    model.compute_dtype = model_cpu.compute_dtype = torch.bfloat16

    pred = Predictor(model, config, device=device)
    imgs = torch.from_numpy(frames).to(device).float() / 255.0
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        tta_ms = device_ms(lambda: pred._tta_maps(imgs, TTA_SCALES, (0.0,)),
                           runs=3)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"bf16 4-scale TTA maps of {BATCH} x 512^2 (+flips; the 2.0 scale "
          f"forwards {2 * BATCH} x 1024^2): {tta_ms:.1f} ms per batch, "
          f"{tta_ms / net_ms:.2f}x the single-scale {net_ms:.1f} ms (predicted "
          f"7.5x); peak device memory {peak_gb:.2f} GiB ({smi})", flush=True)

    for angles, n_req in (((0.0,), TTA_REQUESTS), ((0.0, 10.0, -10.0), TTA_REQUESTS)):
        pred.predict_batch(frames, use_cpp=True, scales=TTA_SCALES, angles=angles)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        serve = PipelinedServer(pred, batch_size=BATCH, depth=TTA_DEPTH,
                                use_cpp=True, scales=TTA_SCALES, angles=angles)
        try:
            t0 = time.perf_counter()
            futs = [serve.submit(requests[i]) for i in range(n_req)]
            results = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        finally:
            serve.close()
        if len(results) != n_req or any(k.shape[1:] != (18, 3) for k, _ in results):
            raise AssertionError("TTA serving returned malformed results")
        if kernels.nms.launches == 0:
            raise AssertionError("TTA serving did not launch nms")
        print(f"TTA serving, scales {TTA_SCALES} angles {angles}, batch {BATCH} "
              f"depth {TTA_DEPTH}: {n_req} requests in {wall:.3f} s = "
              f"{n_req / wall:.2f} frames/s end to end; nms launches "
              f"{kernels.nms.launches} ({smi})", flush=True)


def entry_points(model, config, device, smi):
    """The port's evaluator function over in-memory synthetic frames, single
    scale and with the reference scale search; then the demo's synthetic
    scene, which must give 2 people."""
    import os

    from improved_body_parts_tpu_torch.apps import demo_image, evaluate
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.ops import kernels

    frames, gt = evaluate.synthetic_coco(N_EVAL, size=512, seed=777)
    pred = Predictor(model, config, device=device)
    pred.predict_skeletons(frames[0][1], use_cpp=True)          # warm-up
    os.makedirs("results", exist_ok=True)
    for name, search in (("single", None), ("scale_search", TTA_SCALES)):
        kernels.reset_launch_counts()
        run = evaluate.evaluate_frames(pred, frames, scale_search=search,
                                       run_cpp=True)
        if kernels.nms.launches == 0 or run.image_ids != [i for i, _ in frames]:
            raise AssertionError(f"evaluator ({name}) did not run through nms")
        path = os.path.join("results", f"chip_smoke_eval_{name}.json")
        with open(path, "w") as f:
            json.dump(run.outputs, f)
        stats = evaluate.score(gt, run.outputs, run.image_ids,
                               print_fn=lambda *a: None)
        print(f"evaluator {name}: {len(run.outputs)} detections on {N_EVAL} "
              f"frames written to {path}; {evaluate.ap_line(stats)} (random "
              f"weights, not asserted); {len(run.image_ids) / run.seconds:.2f} "
              f"frames/s; nms launches {kernels.nms.launches} ({smi})", flush=True)
    kernels.reset_launch_counts()
    kps, scores = demo_image.run_synthetic("Canonical", device=device, use_cpp=True)
    if len(kps) != 2 or kernels.nms.launches == 0:
        raise AssertionError(f"demo --synthetic found {len(kps)} people, "
                             f"nms launches {kernels.nms.launches}")
    print(f"demo --synthetic: found 2 people (scores "
          f"{np.round(scores, 3).tolist()}), nms launches {kernels.nms.launches}",
          flush=True)


def busy_ms(fn, runs: int = 5) -> float:
    """The device time the profiler attributes to the kernels of one call
    of ``fn`` (the mean over ``runs``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # the kernels' own rows (an operator's row repeats its kernels' time),
    # or the operators' rows where the kernels have none
    rows = prof.key_averages()
    total = (sum(e.self_device_time_total for e in rows
                 if e.device_type == DeviceType.CUDA)
             or sum(e.self_device_time_total for e in rows))
    return total / runs / 1e3


def host_ms(fn, runs: int = 5) -> float:
    """Median host time to enqueue one call of ``fn`` on an idle card."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def postprocess_times(posts, dev_args, smi) -> None:
    """Post-processing of one batch, unfused against fused, in turns
    (unfused, fused, fused, unfused): CUDA events around each call (the
    card's wall time, host-bound gaps included) and the device time the
    profiler attributes to its kernels."""
    res = {False: [], True: []}
    with torch.inference_mode():
        for fused in (False, True, True, False):
            fn = (lambda p=posts[fused]: p._postprocess(*dev_args))
            res[fused].append((device_ms(fn), busy_ms(fn)))
    for fused, runs in res.items():
        print(f"post-processing of {BATCH}, fused={fused}: "
              f"{' / '.join(f'{e:.3f}' for e, _ in runs)} ms between CUDA events "
              f"(median of {TIMING_RUNS}, two turns); device busy "
              f"{' / '.join(f'{b:.3f}' for _, b in runs)} ms by the profiler "
              f"({smi})", flush=True)


def _train_state_tensors(state):
    """Clones of every parameter, momentum buffer and BN running statistic."""
    out = {("p", k): v.detach().clone() for k, v in state.model.named_parameters()}
    out.update({("m", k): v.clone() for k, v in state.momentum.items()})
    out.update({("b", k): v.clone() for k, v in state.model.named_buffers()
                if "running" in k})
    return out


def _rel_err(a: dict, b: dict, floor: float = 1e-3) -> float:
    """Largest max|a - b| over tensors, each over its scale (its max|b|, at
    least ``floor`` of the largest)."""
    top = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k].double() - b[k].double()).abs().max())
               / max(float(b[k].abs().max()), floor * top) for k in b)


def _global_rel_err(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def train_profile(step_fn, state, batch, lr, step_ms, smi):
    """torch.profiler over TRAIN_PROFILED steps on one staged batch: the
    card's busy time a step (its kernels' time), as a share of the step's
    time between CUDA events without the profiler (``step_ms``), the host's
    launch calls a step, and the five operators whose kernels took most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from improved_body_parts_tpu_torch.utils.profiling import LAUNCH_CALLS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            step_fn(state, *batch, lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == DeviceType.CUDA) / 1e6
    kernels_a_step = sum(e.count for e in rows
                         if e.device_type == DeviceType.CUDA) / TRAIN_PROFILED
    calls = sum(e.count for e in rows if e.key in LAUNCH_CALLS) / TRAIN_PROFILED
    ops = sorted((e for e in rows if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:5]
    top = [(e.key, e.self_device_time_total / 1e3 / TRAIN_PROFILED, e.count // TRAIN_PROFILED)
           for e in ops]
    busy_ms = busy / TRAIN_PROFILED * 1e3
    print(f"  profiler over {TRAIN_PROFILED} steps ({wall / TRAIN_PROFILED * 1e3:.1f} ms "
          f"a step while profiled): the card busy {busy_ms:.1f} ms a step, "
          f"{busy_ms / step_ms:.3f} of the {step_ms:.1f} ms step; "
          f"{kernels_a_step:.0f} device kernels and copies a step, {calls:.0f} host "
          f"launch calls a step; top operators "
          f"by device time a step: "
          + "; ".join(f"{k} {ms:.2f} ms ({n} calls)" for k, ms, n in top)
          + f" ({smi})", flush=True)
    return busy_ms / step_ms, top, calls


def train_feed_run(model, config, feed, device, smi, profiled: bool):
    """TRAIN_WARM + TRAIN_TIMED steps of the Canonical model at 512², batch
    8, bf16 compute, through PrefetchingLoader and the trainer's staging;
    then the step alone on a staged batch (CUDA events) and, if
    ``profiled``, a profile."""
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.parallel.mesh import staged_batches
    from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset

    compact = feed != "dense"
    tcfg = config.train
    state = train_lib.create_train_state(model, tcfg)
    step = train_lib.make_train_step(model, config, compact_gt=compact)
    loader = PrefetchingLoader(SyntheticDataset(config, length=64,
                                                image_size=config.height),
                               num_workers=6)
    n = TRAIN_WARM + TRAIN_TIMED
    batches = staged_batches(device, loader.batches(
        TRAIN_BATCH, n, seed=1, compact=compact, image_u8=feed == "compact-u8"),
        depth=2)
    lr = tcfg.learning_rate
    losses = []
    for i, batch in enumerate(batches):
        if i == TRAIN_WARM:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        losses.append(step(state, *batch, lr)["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{feed}: non-finite training loss {losses.tolist()}")
    kept = batch
    step_ms = device_ms(lambda: step(state, *kept, lr), runs=TRAIN_DEVICE_RUNS)
    busy, top, calls = (train_profile(step, state, kept, lr, step_ms, smi)
                        if profiled else (None, [], None))
    row = dict(feed=feed, e2e_ms=wall * 1e3, step_ms=step_ms,
               images_per_s=TRAIN_BATCH / step_ms * 1e3,
               e2e_images_per_s=TRAIN_BATCH / wall, peak_gib=peak, busy=busy,
               host_launches=calls, top=[k for k, _, _ in top])
    print(f"{feed}: {step_ms:.1f} ms a step alone (median of {TRAIN_DEVICE_RUNS}, "
          f"CUDA events) = "
          f"{row['images_per_s']:.1f} images/s; through the loader and staging "
          f"{wall * 1e3:.1f} ms a step = {row['e2e_images_per_s']:.1f} images/s; "
          f"peak {peak:.2f} GiB; losses {[round(x, 3) for x in losses.tolist()]} "
          f"({smi})", flush=True)
    return row, state


def tiny_train_config(config):
    import dataclasses

    from improved_body_parts_tpu_torch.configs import ModelConfig
    return dataclasses.replace(
        config, width=64, height=64,
        model=ModelConfig(nstack=2, inp_dim=32, increase=16),
        train=dataclasses.replace(config.train, max_grad_norm=1.0, swa=True))


def tiny_batch(n=8):
    from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
    from improved_body_parts_tpu_torch.data.synthetic import random_people
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.rand(n, 64, 64, 3).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n, 16, 16, 1) > 0.2).astype(np.float32))
    joints = torch.from_numpy(np.stack([pad_people(random_people(rng, 64, 64), 4)
                                        for _ in range(n)]))
    mask_all = torch.from_numpy((rng.rand(n, 16, 16) > 0.2).astype(np.float32))
    return imgs, mask, (joints, mask_all)


def _to(batch, device, dtype=None):
    if isinstance(batch, tuple):
        return tuple(_to(b, device, dtype) for b in batch)
    return batch.to(device, dtype)


def training(device, smi, init, config_name: str = "Canonical") -> dict:
    """Phase 8: the training path (train_lib, apps/train's staging, the
    checkpoints) at the width of ``config_name``, from a copy of ``init``
    (its reference init on the card), and its checks. Returns the dense
    feed's row (its eager step's profile is phase 11's reference)."""
    import dataclasses
    import os
    import tempfile

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.apps.evaluate import build_predictor
    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    model = copy.deepcopy(init)

    # -- steps: dense and compact-u8 feeds, then remat --------------------------
    rows = []
    for feed in ("dense", "compact-u8"):
        # one profile: the feeds differ only in what the step renders first
        row, state = train_feed_run(model, config, feed, device, smi,
                                    profiled=feed == "dense")
        rows.append(row)
    remat_cfg = dataclasses.replace(config.model, remat=True)
    remat = PoseNet(remat_cfg, compute_dtype=torch.bfloat16, device="meta")
    remat = remat.to_empty(device=device).to(memory_format=torch.channels_last)
    remat.load_state_dict(model.state_dict())
    rstate = train_lib.create_train_state(remat, config.train)
    rstep = train_lib.make_train_step(remat, dataclasses.replace(config, model=remat_cfg),
                                      compact_gt=True)
    ds = SyntheticDataset(config, length=TRAIN_BATCH, image_size=config.height)
    samples = [ds.get_compact(i, image_u8=True) for i in range(TRAIN_BATCH)]
    batch = _to((torch.stack([s[0] for s in samples]), torch.stack([s[1] for s in samples]),
                 (torch.stack([s[2][0] for s in samples]),
                  torch.stack([s[2][1] for s in samples]))), device)
    rstep(rstate, *batch, config.train.learning_rate)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_ms = device_ms(lambda: rstep(rstate, *batch, config.train.learning_rate),
                         runs=2)
    remat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"remat (each hourglass recomputed in the backward pass), compact-u8: "
          f"{remat_ms:.1f} ms a step, peak {remat_peak:.2f} GiB against "
          f"{rows[1]['peak_gib']:.2f} GiB without ({smi})", flush=True)
    del remat, rstate, rstep
    torch.cuda.empty_cache()

    # -- rollback: abnormal loss keeps everything bit-identical ---------------------
    bad = dataclasses.replace(config, train=dataclasses.replace(
        config.train, abnormal_loss_thresh=1e-9))
    bstep = train_lib.make_train_step(model, bad, compact_gt=True)
    before = _train_state_tensors(state)
    metrics = bstep(state, *batch, 1e-2)
    after = _train_state_tensors(state)
    same = all(torch.equal(after[k], v) for k, v in before.items())
    if float(metrics["skipped"]) != 1.0 or not same:
        raise AssertionError("the abnormal-loss rule did not keep the state")
    print(f"rollback: abnormal_loss_thresh 1e-9 -> skipped 1, {len(before)} "
          "parameters, momentum buffers and BN statistics bit-identical", flush=True)
    del before, after

    # -- train to serve: the checkpoint of this state through build_predictor -------
    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt.save_train_state(tmp, train_lib.state_payload(
            state, config.train, epoch=0, train_loss=float(metrics["loss"])), step=0)
        mb = os.path.getsize(path) / 2 ** 20
        pred = build_predictor(path, config_name, device=device)
        trained = model.state_dict()
        for k, v in pred.model.state_dict().items():
            if not torch.equal(v, trained[k]):
                raise AssertionError(f"served weights differ from trained: {k}")
        frames = (batch[0].cpu().numpy())
        pred.predict_batch(frames, use_cpp=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = pred.predict_batch(frames, use_cpp=True)
        torch.cuda.synchronize()
        if len(results) != TRAIN_BATCH or kernels.nms.launches == 0:
            raise AssertionError("the trained checkpoint did not serve through nms")
        print(f"train to serve: {mb:.0f} MiB checkpoint -> apps.evaluate."
              f"build_predictor -> predict_batch of {TRAIN_BATCH}: "
              f"{sum(len(k) for k, _ in results)} people (two steps from the "
              f"reference init), nms launches {kernels.nms.launches}", flush=True)
        del pred

    # -- learning: one fixed batch, raised LR -----------------------------------
    lcfg = dataclasses.replace(config, train=dataclasses.replace(
        config.train, max_grad_norm=1.0))
    lstep = train_lib.make_train_step(model, lcfg, compact_gt=True)
    lstate = train_lib.create_train_state(model, lcfg.train)
    losses = torch.stack([lstep(lstate, *batch, LEARN_LR)["loss"]
                          for _ in range(LEARN_STEPS)]).cpu()
    print(f"learning: {LEARN_STEPS} steps on one batch at lr {LEARN_LR}, clip 1: losses "
          f"{[round(x, 3) for x in losses.tolist()]}", flush=True)
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall over {LEARN_STEPS} steps")
    del lstate, state
    torch.cuda.empty_cache()

    # -- tiny steps: the card against the CPU ------------------------------------
    # Frozen BN in fp32, every tensor at 1e-4. Train-mode BN in float64 on
    # both, every tensor at 1e-6 (floor 1e-6 of the largest): at this size
    # the train-mode step is chaotic, a 1e-7 change of the images moves the
    # float64 gradient by percents (tools/train_bn_conditioning.py), so an
    # fp32 step of either device lies percents from the exact one; those
    # distances are printed as readings, and only the loss is held.
    tcfg = tiny_train_config(config)
    host = PoseNet(tcfg.model, compute_dtype=torch.float32,
                   generator=torch.Generator().manual_seed(SEED))
    tb = tiny_batch()

    def tiny_step(dev, dtype, freeze_bn):
        m = copy.deepcopy(host).to(dev, dtype)
        m.compute_dtype = dtype
        st = train_lib.create_train_state(m, tcfg.train)
        step = train_lib.make_train_step(m, tcfg, freeze_bn=freeze_bn,
                                         compact_gt=True)
        met = step(st, *_to(tb, dev, dtype), 1e-2)
        return ({k: float(v) for k, v in met.items()},
                {k: v.cpu() for k, v in _train_state_tensors(st).items()})

    def errors(got, want, floor):
        (mg, tg), (mw, tw) = got, want
        err = dict(loss=abs(mg["loss"] - mw["loss"]) / abs(mw["loss"]),
                   gn=abs(mg["grad_norm"] - mw["grad_norm"]) / mw["grad_norm"])
        for part in "pmb":
            keys = [k for k in tw if k[0] == part]
            err[part] = _rel_err({k: tg[k] for k in keys}, {k: tw[k] for k in keys},
                                 floor)
        return err

    def show(what, err, tol):
        names = dict(loss="loss", gn="grad norm", p="params", m="momentum",
                     b="BN stats")
        print(f"tiny step (nstack 2, inp_dim 32, 64², batch 8), {what}: "
              + ", ".join(f"{names[k]} {v:.2e}" + (f" (tol {tol[k]})" if k in tol else "")
                          for k, v in err.items()), flush=True)
        if not all(err[k] <= tol[k] for k in tol):
            raise AssertionError(f"the tiny train step disagrees: {what}")

    show("fp32, frozen BN, card vs CPU",
         errors(tiny_step(device, torch.float32, True),
                tiny_step(CPU, torch.float32, True), 1e-3),
         dict(loss=1e-5, gn=1e-4, p=1e-4, m=1e-4, b=0.0))
    exact = tiny_step(CPU, torch.float64, False)
    show("float64, train-mode BN, card vs CPU",
         errors(tiny_step(device, torch.float64, False), exact, 1e-6),
         dict(loss=1e-9, gn=1e-6, p=1e-6, m=1e-6, b=1e-6))
    for where, dev in (("card", device), ("CPU", CPU)):
        show(f"fp32, train-mode BN, {where} vs CPU float64 (readings; loss held)",
             errors(tiny_step(dev, torch.float32, False), exact, 1e-3),
             dict(loss=1e-5))

    # -- checkpoint: step, save, restore, step == two steps straight ----------
    # (tiny, fp32; the second step with frozen BN, whose backward is well
    # conditioned, since atomics in some CUDA backward kernels make two runs
    # of one step differ in the last bits)
    torch.backends.cudnn.deterministic = True
    m1 = copy.deepcopy(host).to(device)
    s1 = train_lib.create_train_state(m1, tcfg.train)
    dev_b = _to(tb, device)
    train_lib.make_train_step(m1, tcfg, compact_gt=True)(s1, *dev_b, 1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save_train_state(tmp, train_lib.state_payload(s1, tcfg.train, epoch=0),
                              step=0)
        m2 = copy.deepcopy(host).to(device)
        s2 = train_lib.create_train_state(m2, tcfg.train)
        train_lib.load_payload(s2, ckpt.restore_train_state(tmp))
    outs = []
    for m, st in ((m1, s1), (m2, s2)):
        met = train_lib.make_train_step(m, tcfg, freeze_bn=True, compact_gt=True)(
            st, *dev_b, 5e-3)
        outs.append((float(met["loss"]), _train_state_tensors(st)))
    torch.backends.cudnn.deterministic = False
    (la, a), (lb, b) = outs
    worst = max(float((a[k] - b[k]).abs().max()) for k in a)
    err = _rel_err(b, a)
    print(f"checkpoint: step, save, restore, step against two steps straight: "
          f"losses {la!r} / {lb!r}, max abs difference {worst:.3e} over "
          f"{len(a)} tensors ({err:.2e} of scale; tolerance 1e-5)", flush=True)
    if not (err <= 1e-5 and abs(la - lb) <= 1e-6 * abs(la)):
        raise AssertionError("resumed training differs from training straight through")

    line = {r["feed"]: {k: r[k] for k in ("step_ms", "images_per_s", "e2e_ms",
                                          "e2e_images_per_s", "peak_gib", "busy",
                                          "host_launches")}
            for r in rows}
    line["remat"] = {"step_ms": remat_ms, "peak_gib": remat_peak}
    print(json.dumps({"training": line}), flush=True)
    return rows[0]


# ---------------------------------------------------------------------------
# phase 9: the model variants
# ---------------------------------------------------------------------------

VARIANT_REQUESTS = 16
AE_STEPS = 4
TINY_VARIANTS = (("cross_stack=False", dict(cross_stack=False)),
                 ("extra_attention", dict(extra_attention=True)),
                 ("Independent", dict(cross_stack=False, legacy_blocks=True)),
                 ("AEPoseNet", None))


def serve_requests(pred, requests, depth, what, **server_kw):
    """``requests`` through ``PipelinedServer(batch 8, depth, **server_kw)``;
    checks the results' shapes; returns frames/s end to end."""
    from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
    serve = PipelinedServer(pred, batch_size=BATCH, depth=depth, use_cpp=True,
                            **server_kw)
    try:
        t0 = time.perf_counter()
        futs = [serve.submit(im) for im in requests]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        serve.close()
    if len(results) != len(requests) or any(k.shape[1:] != (18, 3) for k, _ in results):
        raise AssertionError(f"{what}: serving returned malformed results")
    return len(requests) / wall


def variants(frames, requests, device, smi,
             names=("FinalAttention", "Independent")) -> dict:
    """Phase 9: FinalAttention and Independent at full width served through
    ``apps.demo_image.build_predictor``; AEPoseNet trained at Canonical
    widths through the ``apps.train`` path; a tiny fp32 forward of each
    variant on the card against the CPU."""
    import argparse

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.apps.demo_image import build_predictor
    from improved_body_parts_tpu_torch.apps.train import build_model
    from improved_body_parts_tpu_torch.parallel.mesh import staged_batches
    from improved_body_parts_tpu_torch.configs import ModelConfig, get_config
    from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.models.ae_pose import AEPoseNet
    from improved_body_parts_tpu_torch.models.imhn import create_model
    from improved_body_parts_tpu_torch.ops import kernels

    line = {}
    imgs = torch.from_numpy(frames).to(device).float() / 255.0
    for name in names:
        pred = build_predictor("", name, device=device)      # reference init
        n_params = sum(p.numel() for p in pred.model.parameters())
        with torch.inference_mode():
            pred.predict_batch(frames, use_cpp=True)           # warm-up
            ms = device_ms(lambda: pred._flip_avg_maps(imgs), runs=5)
        kernels.reset_launch_counts()
        fps = serve_requests(pred, requests[:VARIANT_REQUESTS], 2, name)
        if kernels.nms.launches == 0:
            raise AssertionError(f"{name}: serving did not launch nms")
        print(f"{name} ({type(pred.model).__name__}, {n_params / 1e6:.1f}M "
              f"parameters): bf16 forward of {BATCH} x 512^2 + flips {ms:.1f} ms "
              f"per batch; {VARIANT_REQUESTS} requests served (batch {BATCH}, "
              f"depth 2) at {fps:.2f} frames/s; nms launches "
              f"{kernels.nms.launches} ({smi})", flush=True)
        line[name] = dict(ms=ms, frames_per_s=fps, params=n_params)
        del pred
        torch.cuda.empty_cache()

    # AEPoseNet at Canonical widths: apps.train's model, feed and staging
    config = get_config("Canonical")
    args = argparse.Namespace(tiny_model=False, remat=False, model="ae",
                              dtype="bfloat16")
    _, model = build_model(args, config, device)
    state = train_lib.create_train_state(model, config.train)
    step = train_lib.make_train_step(model, config, compact_gt=True)
    loader = PrefetchingLoader(SyntheticDataset(config, length=32), num_workers=6)
    batches = staged_batches(device, loader.batches(
        TRAIN_BATCH, AE_STEPS, seed=2, compact=True, image_u8=True), depth=2)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i, batch in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(state, *batch, config.train.learning_rate)["loss"])
    torch.cuda.synchronize()
    ae_ms = (time.perf_counter() - t0) / (AE_STEPS - 1) * 1e3
    losses = torch.stack(losses).float().cpu()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.isfinite(losses).all():
        raise AssertionError(f"AEPoseNet: non-finite loss {losses.tolist()}")
    print(f"AEPoseNet (Canonical widths, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
          f"parameters), 512² batch {TRAIN_BATCH}, compact-u8 feed through the "
          f"loader and staging: {AE_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses.tolist()]}, {ae_ms:.1f} ms a step "
          f"after the first (host clock), peak {peak:.2f} GiB ({smi})", flush=True)
    line["AEPoseNet_train"] = dict(step_ms=ae_ms, peak_gib=peak,
                                   losses=losses.tolist())
    del model, state, step
    torch.cuda.empty_cache()

    # tiny fp32 forward of each variant, card against CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(SEED).rand(2, 64, 64, 3).astype(np.float32))
    for name, flags in TINY_VARIANTS:
        g = torch.Generator().manual_seed(SEED)
        kw = dict(compute_dtype=torch.float32, generator=g)
        if flags is None:
            host = AEPoseNet(ModelConfig(nstack=2, inp_dim=32, increase=16), **kw)
        else:
            host = create_model(ModelConfig(nstack=2, inp_dim=32, increase=16, **flags),
                                **kw)
        fan_in_init(host, g)
        dev = copy.deepcopy(host).to(device)
        with torch.inference_mode():
            want, got = host(x), dev(x.to(device))
        scale = max(w.abs().max().item() for st in want for w in st)
        err = max((a.cpu() - b).abs().max().item()
                  for gs, ws in zip(got, want) for a, b in zip(gs, ws))
        print(f"tiny {name} fp32 forward (nstack 2, inp_dim 32, 2 x 64²), card vs "
              f"CPU at every output: max abs err {err:.3e} (outputs up to "
              f"{scale:.3f}; tolerance 1e-3 x that)", flush=True)
        if not err <= 1e-3 * scale:
            raise AssertionError(f"tiny {name}: the card disagrees with the CPU")
    return line


# ---------------------------------------------------------------------------
# phase 10: int8 post-training quantization and the int8 conv kernel
# ---------------------------------------------------------------------------

INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core rate


def _ceil8(n: int) -> int:
    return (n + 7) // 8 * 8


def int8_library_route(w, bias, w_scale, a_scale, stride, pad, dil, relu,
                       out_dtype=None, a_next=None):
    """``x -> int8_conv(x, w, ...)`` computed by PyTorch calls: quantize
    (unless x is int8 already), ``F.unfold`` (im2col: every activation
    copied k*k times) in fp16 (the integers are exact), then
    ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) on K and N padded to
    multiples of 8, then the same epilogue [and requantize]. Timed as the
    yardstick ``library_ms``; the port never calls it."""
    import torch.nn.functional as F
    cout, k, _, cin = w.shape
    K, Kp, Np = cin * k * k, max(_ceil8(cin * k * k), 24), _ceil8(cout)
    B = torch.zeros((Kp, Np), dtype=torch.int8, device=w.device)
    B[:K, :cout] = w.permute(3, 1, 2, 0).reshape(K, cout)      # (ci, ky, kx) rows
    scale = a_scale * w_scale

    def route(x):
        n, h, wd, _ = x.shape
        if x.dtype == torch.int8:
            xq, dt = x.half(), out_dtype
        else:
            xq = torch.clamp(torch.round(x.float() / a_scale), -127, 127).half()
            dt = x.dtype
        cols = F.unfold(xq.permute(0, 3, 1, 2), k, dilation=dil, padding=pad,
                        stride=stride)                        # (n, K, L)
        ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
        wo = (wd + 2 * pad - dil * (k - 1) - 1) // stride + 1
        A = torch.zeros((n * ho * wo, Kp), dtype=torch.int8, device=x.device)
        A[:, :K] = cols.transpose(1, 2).reshape(n * ho * wo, K)
        acc = torch._int_mm(A, B)[:, :cout]
        y = (acc.float() * scale + bias).to(dt)
        y = F.leaky_relu(y, 0.01) if relu else y
        if a_next is not None:
            y = torch.clamp(torch.round(y.float() / a_next), -127, 127).to(torch.int8)
        return y.reshape(n, ho, wo, cout)
    return route


# the wgmma route's edges, (N, H, W, Cin, Cout, k, dilation): maps narrower
# than the 16-column box (8x8, 16x16, 1x1), H*W no multiple of the
# 128-pixel tile, Cout no multiple of 64 or 128, Cin below one 64-channel
# slice, dilation 3, 4 and 5 past the map's edges, batch 1; each with float
# or int8 input and float or requantized int8 output; the last two take the
# 256-column tile
INT8_WGMMA_EDGES = ((16, 8, 8, 64, 64, 3, 1), (16, 16, 16, 320, 320, 3, 1),
                    (2, 19, 13, 32, 50, 3, 3), (1, 23, 29, 48, 130, 3, 4),
                    (2, 12, 12, 64, 200, 3, 5), (3, 5, 7, 16, 24, 1, 1),
                    (1, 1, 1, 64, 16, 3, 1), (4, 33, 17, 192, 136, 1, 1),
                    (2, 16, 16, 256, 50, 1, 1), (16, 32, 32, 256, 256, 3, 1),
                    (16, 64, 64, 128, 256, 3, 1), (4, 96, 90, 128, 512, 3, 1))


def _int8_operands(g, shape, cout, k, device, a_scale):
    """Activations with rounding ties and clipped outliers, a full-range
    int8 kernel, per-channel scales and a bias."""
    x = torch.randn(shape, generator=g) * 1.5
    ties = torch.rand(x.shape, generator=g) < 0.2
    x = torch.where(ties, (torch.randint(-130, 130, x.shape, generator=g) + 0.5)
                    * a_scale, x).to(device)
    w = torch.randint(-127, 128, (cout, k, k, shape[3]), generator=g,
                      dtype=torch.int8).to(device)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(device)
    bias = (torch.randn(cout, generator=g) * 0.1).to(device)
    return x, w, bias, w_scale


def _held(kernels, got, want, what) -> float:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")
    return max_abs_err([got], [want.contiguous()])


def int8_edge_grid(kernels, device) -> tuple:
    """int8_conv against its plain version, bit for bit, on kernel 1/3/7 x
    stride 1/2 x dilation 1/3/5 x Cin 3/50/64 (K not a multiple of 32),
    Cout 50 and 130, bf16 and fp32, with rounding ties and clipped
    outliers, plus the extreme operand (every product 127 * 127) at the
    largest K (3x3 on 768 channels, 8x8 maps of 16 frames) and a 1x1 map;
    the wgmma route's edges (INT8_WGMMA_EDGES) with float and int8 input and
    output; int8_quantize on each input."""
    n, worst, q_worst = 0, 0.0, 0.0
    g = torch.Generator().manual_seed(SEED)
    a_scale = torch.tensor(2.0 ** -5, device=device)
    a_next = torch.tensor(2.0 ** -3, device=device)
    for k, dil in ((1, 1), (3, 1), (3, 3), (3, 5), (7, 1), (7, 3), (7, 5)):
        for stride in (1, 2):
            for cin in (3, 50, 64):
                cout = 130 if cin == 64 else 50
                x, w, bias, w_scale = _int8_operands(g, (2, 19, 13, cin), cout, k,
                                                     device, 2.0 ** -5)
                pad = dil * (k - 1) // 2
                for dt in (torch.bfloat16, torch.float32):
                    relu = (k + stride + dil + n) % 2 == 0
                    args = (x.to(dt), w, bias, w_scale, a_scale, stride, pad, dil, relu)
                    worst = max(worst, _held(kernels, kernels.int8_conv(*args),
                                             kernels.int8_conv_plain(*args),
                                             f"int8_conv k={k} s={stride} d={dil} "
                                             f"cin={cin} {dt}"))
                    n += 1
    for shape in ((16, 8, 8, 768, 768, 3), (4, 1, 1, 32, 16, 3)):
        b, h, wd, cin, cout, k = shape
        x = (torch.rand((b, h, wd, cin), generator=g) + 1.0).to(device)
        w = torch.full((cout, k, k, cin), 127, dtype=torch.int8, device=device)
        args = (x.bfloat16(), w, torch.zeros(cout, device=device),
                torch.full((cout,), 1e-6, device=device), torch.tensor(1e-3, device=device),
                1, 1, 1, False)
        _held(kernels, kernels.int8_conv(*args), kernels.int8_conv_plain(*args),
              f"int8_conv extreme operand {shape}")
        n += 1
    for b, h, wd, cin, cout, k, dil in INT8_WGMMA_EDGES:
        x, w, bias, w_scale = _int8_operands(g, (b, h, wd, cin), cout, k, device,
                                             2.0 ** -5)
        pad = dil * (k - 1) // 2
        for dt in (torch.bfloat16, torch.float32):
            xf = x.to(dt)
            xq = kernels.int8_quantize(xf, a_scale)
            q_worst = max(q_worst, _held(kernels, xq,
                                         kernels.int8_quantize_plain(xf, a_scale),
                                         f"int8_quantize {tuple(x.shape)} {dt}"))
            for xx in (xf, xq):
                for nxt in (None, a_next):
                    args = (xx, w, bias, w_scale, a_scale, 1, pad, dil,
                            (cin + dil) % 2 == 0, dt, nxt)
                    worst = max(worst, _held(
                        kernels, kernels.int8_conv(*args), kernels.int8_conv_plain(*args),
                        f"int8_conv wgmma route {(b, h, wd, cin, cout, k, dil)} {dt} "
                        f"in {xx.dtype} out {'int8' if nxt is not None else dt}"))
                    n += 1
    return n, worst, q_worst


def int8_calls(qmodel, both):
    """Every distinct int8_conv call of one int8 ``predict_maps(both)``:
    {key: [count, module, NHWC input as given (float, or int8 on a fused
    link), relu, out_dtype, a_next]}, in first-call order (hooks; the
    kernels run)."""
    from improved_body_parts_tpu_torch.models.imhn import QConv2d
    found = {}

    def hook(mod, args, kwargs):
        x, relu = args[0], bool(args[1])
        a_next, out_dtype = kwargs.get("a_next"), kwargs.get("out_dtype")
        key = (tuple(x.shape), x.dtype, mod.k, mod.stride, mod.padding,
               mod.dilation, mod.outs, relu, a_next is not None, out_dtype)
        if key in found:
            found[key][0] += 1
        else:
            found[key] = [1, mod, x.permute(0, 2, 3, 1).contiguous().clone(), relu,
                          out_dtype, a_next]

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in qmodel.modules() if isinstance(m, QConv2d)]
    try:
        with torch.inference_mode():
            qmodel.predict_maps(both)
    finally:
        for h in handles:
            h.remove()
    return found


def _conv_bounds(x, w, out, cout, k, cin) -> tuple:
    """(operations bound ms, bytes bound ms): the int8 operations at 1,979
    TOPS; the input, int8 weights, output and scales, each once, at 3.35
    TB/s."""
    m = out.shape[0] * out.shape[1] * out.shape[2]
    ops = 2 * m * cout * cin * k * k
    nbytes = x.nbytes + w.nbytes + out.nbytes + 3 * cout * 4 + 4
    return ops / INT8_OPS_PER_S * 1e3, bound_ms(nbytes)


def _route(kernels, mod, x, a_next=None) -> str:
    """The route int8_conv takes for this call (NHWC ``x``)."""
    return kernels.int8_conv_route(mod.ins, mod.stride, x.shape[1], x.shape[2],
                                   mod.outs, mod.k,
                                   x.dtype == torch.int8 or a_next is not None)


def int8_shape_rows(kernels, found):
    """At each distinct conv shape of the unfused forward (bf16 in and out,
    the definition of the mma.sync kernel's recorded rows): the route's
    result against the plain version and the mma.sync kernel (both bit for
    bit); times of the route, of the wgmma route's two launches alone
    (int8_quantize, the GEMM: also where the static table sends the shape
    back to the mma.sync kernel), of the mma.sync kernel, the plain version
    and the library route, beside the bound."""
    rows, worst = [], 0.0
    for key, (count, mod, x, relu, _, _) in found.items():
        w = mod.weight_q.view(mod.outs, mod.k, mod.k, mod.ins)
        args = (w, mod.bias, mod.w_scale, mod.a_scale, mod.stride, mod.padding,
                mod.dilation, relu)
        route = _route(kernels, mod, x)
        tma = kernels.int8_conv_route(mod.ins, mod.stride, int8_io=True) == "wgmma"
        got = kernels.int8_conv(x, *args)
        want = kernels.int8_conv_plain(x, *args)
        worst = max(worst, _held(kernels, got, want, f"int8_conv at {key}"))
        _held(kernels, kernels.int8_conv_mma_sync(x, *args), want,
              f"the mma_sync kernel at {key}")
        lib = int8_library_route(*args)
        try:
            lib_equal = torch.equal(lib(x), got)
        except RuntimeError as e:      # a yardstick only: note it and go on
            print(f"unfold+_int_mm route refused at {key}: {e}", flush=True)
            lib = lib_equal = None
        ops_ms, bytes_ms = _conv_bounds(x, w, got, mod.outs, mod.k, mod.ins)
        row = dict(shape=list(x.shape), k=mod.k, stride=mod.stride,
                   dilation=mod.dilation, cout=mod.outs, relu=relu, route=route,
                   launches_per_batch=count,
                   ms=device_ms(lambda: kernels.int8_conv(x, *args), runs=10),
                   ms_cold=device_ms(lambda: kernels.int8_conv(x, *args), runs=10,
                                     cold=True),
                   mma_sync_ms=device_ms(lambda: kernels.int8_conv_mma_sync(x, *args),
                                    runs=10),
                   plain_ms=device_ms(lambda: kernels.int8_conv_plain(x, *args), runs=3),
                   library_ms=None if lib is None else device_ms(lambda: lib(x), runs=5),
                   library_equal=lib_equal,
                   ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)
        if tma:
            xq = kernels.int8_quantize(x, mod.a_scale)
            _held(kernels, kernels.int8_conv(xq, *args, x.dtype), want,
                  f"the wgmma route at {key}")
            row["quantize_ms"] = device_ms(
                lambda: kernels.int8_quantize(x, mod.a_scale), runs=10)
            row["gemm_ms"] = device_ms(
                lambda: kernels.int8_conv(xq, *args, x.dtype), runs=10)
        row["bound_ms"] = max(ops_ms, bytes_ms)
        row["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        split = ""
        if tma:
            split = (f" (quantize {row['quantize_ms']:.4f} + gemm {row['gemm_ms']:.4f})"
                     if route == "wgmma" else " (sent back by the static table: the "
                     f"wgmma route's quantize {row['quantize_ms']:.4f} + gemm "
                     f"{row['gemm_ms']:.4f})")
        print(f"int8_conv {tuple(x.shape)} k{mod.k} s{mod.stride} d{mod.dilation} "
              f"-> {mod.outs} x{count} [{route}]: {row['ms']:.4f} ms warm{split} / "
              f"{row['ms_cold']:.4f} cold; mma.sync kernel {row['mma_sync_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, share "
              f"{row['share_of_bound']:.3f}), plain {row['plain_ms']:.3f}, "
              f"unfold+_int_mm {row['library_ms']}"
              f"{'' if lib_equal else ' (NOT equal)'}", flush=True)
    return rows, worst


def int8_forward_rows(kernels, calls):
    """Each distinct int8_conv call of the forward as it runs (fused links:
    int8 in, int8 out), bit for bit against the plain version; the time of
    the call, of its int8_quantize launch alone (a float input on the
    wgmma route) and of its conv kernel alone, beside the conv kernel's
    bound (its own input and output types), the plain version and the
    library route on the same arguments."""
    rows, worst, q_worst = [], 0.0, 0.0
    for key, (count, mod, x, relu, out_dtype, a_next) in calls.items():
        w = mod.weight_q.view(mod.outs, mod.k, mod.k, mod.ins)
        args = (w, mod.bias, mod.w_scale, mod.a_scale, mod.stride, mod.padding,
                mod.dilation, relu, out_dtype, a_next)
        route = _route(kernels, mod, x, a_next)
        got = kernels.int8_conv(x, *args)
        worst = max(worst, _held(kernels, got, kernels.int8_conv_plain(*(x,) + args),
                                 f"int8_conv as run at {key}"))
        quantizes = route == "wgmma" and x.dtype != torch.int8
        row = dict(shape=list(x.shape), dtype=str(x.dtype).removeprefix("torch."),
                   k=mod.k, dilation=mod.dilation, cout=mod.outs, route=route,
                   requantizes=a_next is not None, launches_per_batch=count,
                   call_ms=device_ms(lambda: kernels.int8_conv(x, *args), runs=10),
                   plain_ms=device_ms(lambda: kernels.int8_conv_plain(x, *args), runs=3))
        lib = int8_library_route(*args)
        try:
            lib(x)
            row["library_ms"] = device_ms(lambda: lib(x), runs=5)
        except RuntimeError:
            row["library_ms"] = None
        xk = x
        if quantizes:
            xk = kernels.int8_quantize(x, mod.a_scale)
            q_worst = max(q_worst, _held(kernels, xk,
                                         kernels.int8_quantize_plain(x, mod.a_scale),
                                         f"int8_quantize at {key}"))
            row["quantize_ms"] = device_ms(
                lambda: kernels.int8_quantize(x, mod.a_scale), runs=10)
            row["quantize_plain_ms"] = device_ms(
                lambda: kernels.int8_quantize_plain(x, mod.a_scale), runs=5)
            row["quantize_bound_ms"] = bound_ms(x.nbytes + xk.nbytes)
            kargs = args[:8] + (x.dtype, a_next)
            row["ms"] = device_ms(lambda: kernels.int8_conv(xk, *kargs), runs=10)
        else:
            row["quantize_ms"] = row["quantize_bound_ms"] = 0.0
            row["quantize_plain_ms"] = 0.0
            row["ms"] = row["call_ms"]
        ops_ms, bytes_ms = _conv_bounds(xk, w, got, mod.outs, mod.k, mod.ins)
        row.update(ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
                   bound_ms=max(ops_ms, bytes_ms))
        rows.append(row)
    return rows, worst, q_worst


def corr_err(got: torch.Tensor, want: torch.Tensor):
    g, w = got.double().flatten(), want.double().flatten()
    corr = torch.corrcoef(torch.stack([g, w]))[0, 1].item()
    return corr, (g - w).abs().max().item() / (w.max() - w.min()).item()


def int8(model_cpu, config, frames, requests, device, smi, net_ms,
         config_name: str = "Canonical") -> tuple:
    """Phase 10: Canonical PTQ (fold, calibrate on 8 synthetic scenes,
    quantize), int8_conv at every distinct conv shape of its predict_maps
    and on the edge grid, the int8 maps against the bf16 folded maps, the
    int8 network and PipelinedServer, and the int8 .pth served from file."""
    import os
    import tempfile

    from improved_body_parts_tpu_torch.apps.demo_image import build_predictor
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.models import quantize as qz
    from improved_body_parts_tpu_torch.ops import kernels

    n_edge, edge_err, q_err = int8_edge_grid(kernels, device)
    print(f"int8_conv edge grid: {n_edge} cases bit-identical to the plain "
          "version (k 1/3/7 x stride 1/2 x dilation 1/3/5 x Cin 3/50/64, "
          "bf16 and fp32, ties and clipped outliers; the extreme operand at "
          "K 6,912 and on a 1x1 map; the wgmma route on "
          f"{len(INT8_WGMMA_EDGES)} edge shapes x bf16/fp32 x int8 or float "
          "in x int8 or float out); int8_quantize on each input", flush=True)

    model = copy.deepcopy(model_cpu).to(device, memory_format=torch.channels_last)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calib_ds = SyntheticDataset(config, length=8, seed=1234)
    calib_imgs = [np.stack([calib_ds[i][0] for i in range(b * 4, b * 4 + 4)])
                  for b in range(2)]
    t_data = time.perf_counter() - t0
    folded = qz.fold_conv_bn(model)
    calib = qz.make_quant_model(config.model, "calib", device, torch.bfloat16)
    calib.load_state_dict(folded, strict=True)
    stats = qz.calibrate(calib, calib_imgs)
    qmodel = qz.make_quant_model(config.model, "int8", device, torch.bfloat16)
    qmodel.load_state_dict(qz.build_quantized(folded, stats), strict=True)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    del model, folded
    print(f"Canonical PTQ: 8 synthetic scenes rendered in {t_data:.2f} s; fold + "
          f"calibrate (2 batches of 4, bf16) + quantize: {ptq_s:.2f} s in all; "
          f"{qz.count_int8_convs(qmodel)} int8 conv blocks", flush=True)

    imgs = torch.from_numpy(frames).to(device).float() / 255.0
    both = torch.cat([imgs, imgs.flip(2)], dim=0)             # 8 frames + flips
    # every conv bf16 -> bf16, no int8 links: the mma.sync kernel's recorded rows
    qz.set_int8_links(qmodel, False)
    found = int8_calls(qmodel, both)
    with torch.inference_mode():
        unfused_maps = qmodel.predict_maps(both)
    qz.set_int8_links(qmodel, True)
    n_convs = sum(v[0] for v in found.values())
    print(f"int8 predict_maps of {both.shape[0]} x {both.shape[1]}^2 runs {n_convs} "
          f"conv blocks in {len(found)} distinct shapes", flush=True)
    rows, shape_err = int8_shape_rows(kernels, found)
    del found
    torch.cuda.empty_cache()

    # the forward as it runs: int8 passed along the residual chains
    calls = int8_calls(qmodel, both)
    with torch.inference_mode():
        q_maps = qmodel.predict_maps(both)
    if not torch.equal(q_maps, unfused_maps):
        raise AssertionError("the fused int8 forward differs from the unfused one")
    routes = {r: sum(v[0] for v in calls.values() if _route(kernels, v[1], v[2], v[5]) == r)
              for r in ("wgmma", "mma_sync")}
    print(f"the fused forward's {sum(v[0] for v in calls.values())} conv calls in "
          f"{len(calls)} distinct forms, by route {routes}", flush=True)
    fwd_rows, fwd_err, fwd_q_err = int8_forward_rows(kernels, calls)
    del calls, unfused_maps
    torch.cuda.empty_cache()

    with torch.inference_mode():
        f_maps = calib.predict_maps(both)
    corr, err = corr_err(q_maps, f_maps)
    print(f"int8 predict_maps of {both.shape[0]} x {both.shape[1]}^2 (int8 links "
          f"fused: bit-identical to unfused) against the bf16 folded maps: corr "
          f"{corr:.6f}, max error {err:.4f} of the span (JAX's own bound: corr > "
          f"0.98, < 0.15)", flush=True)
    if not (torch.isfinite(q_maps).all() and corr > 0.98 and err < 0.15):
        raise AssertionError("the int8 maps do not track the folded bf16 maps")
    del calib, q_maps, f_maps
    torch.cuda.empty_cache()

    pred = Predictor(qmodel, config, device=device)
    with torch.inference_mode():
        pred.predict_batch(frames, use_cpp=True)             # warm-up
        int8_ms = device_ms(lambda: pred._flip_avg_maps(imgs), runs=5)
        int8_busy = busy_ms(lambda: pred._flip_avg_maps(imgs))
        int8_host = host_ms(lambda: pred._flip_avg_maps(imgs))
    print(f"int8 network: {int8_ms:.1f} ms per batch of {BATCH} x 512^2 + flips "
          f"against {net_ms:.1f} ms for the bf16 network in phase 3 "
          f"({net_ms / int8_ms:.2f}x; with the mma.sync kernel alone it took 78.6 ms); the card busy "
          f"{int8_busy:.1f} ms of it (profiler), the host enqueues it in "
          f"{int8_host:.1f} ms ({smi})", flush=True)

    calls_n = [0]
    predict_maps = qmodel.predict_maps

    def counted(x):
        calls_n[0] += 1
        return predict_maps(x)
    qmodel.predict_maps = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fps = serve_requests(pred, requests, DEPTH, "int8")
    torch.cuda.synchronize()
    launches = kernels.int8_conv.launches
    by_route = dict(kernels.int8_conv.launches_by_route)
    q_launches = kernels.int8_quantize.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del qmodel.predict_maps
    q_per_batch = sum(r["launches_per_batch"] for r in fwd_rows if r["quantize_ms"])
    print(f"int8 PipelinedServer (batch {BATCH}, depth {DEPTH}): {len(requests)} "
          f"requests at {fps:.2f} frames/s end to end; int8_conv launches "
          f"{launches} = {n_convs} conv blocks x {calls_n[0]} batches, by route "
          f"{by_route}; int8_quantize launches {q_launches} ({q_per_batch} a batch); "
          f"nms launches {kernels.nms.launches}; peak {peak:.2f} GiB ({smi})", flush=True)
    if (launches != n_convs * calls_n[0] or calls_n[0] == 0 or kernels.nms.launches == 0
            or sum(by_route.values()) != launches
            or any(by_route[r] != routes[r] * calls_n[0] for r in routes)
            or q_launches != q_per_batch * calls_n[0]):
        raise AssertionError("int8 serving did not launch int8_conv once per conv "
                             "block per batch on the routes of its shapes")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "canonical_int8.pth")
        qz.save_quantized(path, qmodel)
        mib = os.path.getsize(path) / 2 ** 20
        fp32_mib = sum(v.numel() * 4 for v in model_cpu.state_dict().values()
                       if v.is_floating_point()) / 2 ** 20
        kernels.reset_launch_counts()
        served = build_predictor(path, config_name, quantize="int8", device=device)
        results = served.predict_batch(frames, use_cpp=True)
        torch.cuda.synchronize()
        if (len(results) != BATCH or kernels.int8_conv.launches != n_convs
                or kernels.nms.launches == 0):
            raise AssertionError("the int8 .pth did not serve through int8_conv")
        print(f"int8 .pth: {mib:.1f} MiB (fp32 weights {fp32_mib:.1f} MiB, "
              f"{fp32_mib / mib:.2f}x); served from the file through "
              f"apps.demo_image.build_predictor: {kernels.int8_conv.launches} "
              f"int8_conv launches for one batch", flush=True)
        del served
    del pred
    torch.cuda.empty_cache()

    def total(rs, f):
        if any(r.get(f) is None for r in rs):
            return None
        return sum(r[f] * r["launches_per_batch"] for r in rs)
    bf16_sum = dict(ms=total(rows, "ms"), ms_cold=total(rows, "ms_cold"),
                    mma_sync_ms=total(rows, "mma_sync_ms"), plain_ms=total(rows, "plain_ms"),
                    bound_ms=total(rows, "bound_ms"), library_ms=total(rows, "library_ms"))
    bf16_sum["share_of_bound"] = bf16_sum["bound_ms"] / bf16_sum["ms"]
    print(f"int8_conv bf16 -> bf16 over one batch's {n_convs} launches: "
          f"{bf16_sum['ms']:.2f} ms warm / {bf16_sum['ms_cold']:.2f} cold (the "
          f"mma.sync kernel alone in this run {bf16_sum['mma_sync_ms']:.2f}; its "
          f"recorded time 67.19), bound {bf16_sum['bound_ms']:.2f} ms (share "
          f"{bf16_sum['share_of_bound']:.3f}), plain {bf16_sum['plain_ms']:.1f} ms, "
          f"unfold+_int_mm {bf16_sum['library_ms']} ms ({smi})", flush=True)
    conv_ms, quant_ms = total(fwd_rows, "ms"), total(fwd_rows, "quantize_ms")
    forward_ms = conv_ms + quant_ms
    print(f"int8_conv + int8_quantize over one batch as the forward runs them "
          f"(fused links): {forward_ms:.2f} ms (conv kernels {conv_ms:.2f}, "
          f"{q_per_batch} quantize passes {quant_ms:.2f}; the calls timed whole "
          f"{total(fwd_rows, 'call_ms'):.2f}) against the 67.19 ms recorded for the mma.sync kernel alone; share "
          f"{bf16_sum['bound_ms'] / forward_ms:.3f} of the bf16 -> bf16 bound "
          f"{bf16_sum['bound_ms']:.2f} ms ({smi})", flush=True)
    conv_row = dict(
        name="int8_conv", route="cuda",
        source="improved_body_parts_tpu_torch/csrc/int8_conv.cu",
        replaces="improved_body_parts_tpu/models/imhn.py:90",
        launches=launches, launches_by_route=by_route, launches_per_batch=n_convs,
        max_abs_err=max(edge_err, shape_err, fwd_err),
        per="one int8 predict_maps of 16 x 512^2 (8 frames + flips) as it runs "
            "(int8 links fused): the sum over its conv kernel launches",
        ms=conv_ms, plain_ms=total(fwd_rows, "plain_ms"),
        bound_ms=total(fwd_rows, "bound_ms"), library_ms=total(fwd_rows, "library_ms"),
        bound_by=("operations" if total(fwd_rows, "ops_bound_ms")
                  >= total(fwd_rows, "bytes_bound_ms") else "bytes"),
        forward_ms=forward_ms, bf16_to_bf16=bf16_sum)
    conv_row["share_of_bound"] = conv_row["bound_ms"] / conv_row["ms"]
    conv_row["at_shapes"] = rows
    conv_row["as_run"] = fwd_rows
    q_rows = [r for r in fwd_rows if r["quantize_ms"]]
    quant_row = dict(
        name="int8_quantize", route="cuda",
        source="improved_body_parts_tpu_torch/csrc/int8_conv.cu",
        replaces="improved_body_parts_tpu/models/imhn.py:87",
        launches=q_launches, launches_per_batch=q_per_batch,
        max_abs_err=max(q_err, fwd_q_err),
        per="one int8 predict_maps of 16 x 512^2: the sum over its int8_quantize "
            "launches",
        ms=quant_ms, plain_ms=total(q_rows, "quantize_plain_ms"),
        bound_ms=total(q_rows, "quantize_bound_ms"),
        bound_by="bytes", library_ms=None)
    quant_row["share_of_bound"] = quant_row["bound_ms"] / quant_row["ms"]
    print(f"int8_quantize over one batch's {q_per_batch} launches: {quant_ms:.3f} ms, "
          f"bound {quant_row['bound_ms']:.3f} ms (bytes, share "
          f"{quant_row['share_of_bound']:.3f}), plain {quant_row['plain_ms']:.3f} ms "
          f"({smi})", flush=True)
    line = dict(ptq_s=ptq_s, corr=corr, err_of_span=err, int8_ms=int8_ms,
                int8_busy_ms=int8_busy, int8_host_ms=int8_host,
                bf16_ms=net_ms, frames_per_s=fps, peak_gib=peak, pth_mib=mib,
                convs_per_batch=n_convs, distinct_shapes=len(rows),
                launches_by_route_per_batch=routes, forward_ms=forward_ms,
                bf16_to_bf16_ms=bf16_sum["ms"], mma_sync_kernel_ms=bf16_sum["mma_sync_ms"])
    return [quant_row, conv_row], line, qmodel


# ---------------------------------------------------------------------------
# phase 11: the resident feed and the K-steps dispatch (a CUDA graph)
# ---------------------------------------------------------------------------

RESIDENT_RECORDS = 64
APP_RECORDS = 16             # the store apps.train builds in phase 11
FP32_STEPS = 2               # fp32 frozen-BN steps, graph against eager
DISPATCH_K = 4
RESIDENT_STEPS = 6           # 4 recorded from the start, then 2 timed
GRAPH_TOL = 1e-5             # fp32 graph vs eager, if not bit-identical


def _events_ms(run, n_steps: int) -> float:
    """CUDA events around ``run()`` (n_steps steps, no sync inside): the
    card's wall time a step, host-bound gaps included."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_steps


def _launches_and_busy(run, n_steps: int):
    """``utils/profiling.launches_and_busy``: the host's launch calls a step
    (and by name) and the card's busy ms a step over ``run()``."""
    from improved_body_parts_tpu_torch.utils.profiling import launches_and_busy
    return launches_and_busy(run, n_steps)


def _state_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def _saved_step(pth_dir: str) -> dict:
    """The newest checkpoint of ``save_train_state`` in ``pth_dir``, its
    tensors memory-mapped, not read (for its ``step`` and ``epoch``)."""
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt

    path = ckpt.checkpoint_path(pth_dir, ckpt.saved_steps(pth_dir)[-1])
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def resident_and_dispatch(device, smi, init, eager_profile: dict) -> tuple:
    """Phase 11: the device-resident feed and the K-steps dispatch, a CUDA
    graph of the captured train step, at Canonical 512², batch 8, bf16, on
    a 64-record synthetic store with augmented plans, from copies of
    ``init`` (the reference init on the card); their checks against eager
    steps, the shared memory pool, and ``apps.train`` with both. The graph's
    profile is read beside phase 8's of the eager step (``eager_profile``,
    its dense feed's row). Returns its JSON line and the host store (phase
    12 (c) trains on it too)."""
    import dataclasses
    import os
    import tempfile

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.apps import train as train_app
    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader
    from improved_body_parts_tpu_torch.data.resident import ResidentFeed, build_store
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib

    line = {}
    kernels.reset_launch_counts()

    # -- the resident preprocessing, card against CPU, tiny config ------------
    tcfg = tiny_train_config(get_config("Canonical"))
    tiny = build_store(SyntheticDataset(tcfg, length=6, image_size=64))
    idx, inv_m, _ = next(ResidentFeed(tiny, tcfg).plan_batches(8, 1, seed=4))
    want = train_lib.resident_inputs(tiny.device_arrays(CPU), torch.from_numpy(idx),
                                     torch.from_numpy(inv_m), tcfg)
    got = train_lib.resident_inputs(tiny.device_arrays(device),
                                    torch.from_numpy(idx).to(device),
                                    torch.from_numpy(inv_m).to(device), tcfg)
    err = max_abs_err([g.cpu() for g in got], want)
    print(f"resident preprocessing (gather, /255, per-sample warp, 4x4 box mean), "
          f"tiny 64², batch 8, card vs CPU: max abs err {err:.3e} (tolerance 1e-6)",
          flush=True)
    if not err <= 1e-6:
        raise AssertionError("the resident preprocessing on the card disagrees")

    # -- the store and the plans ------------------------------------------------
    config = get_config("Canonical")
    t0 = time.perf_counter()
    store_h = build_store(SyntheticDataset(config, length=RESIDENT_RECORDS,
                                           image_size=config.height))
    store = store_h.device_arrays(device)
    mb = sum(v.numel() for v in store.values()) / 1e6
    print(f"resident store: {len(store_h)} records at 512², {mb:.1f} MB uint8 on "
          f"the card, built and copied in {time.perf_counter() - t0:.1f} s", flush=True)
    plans = list(ResidentFeed(store_h, config, augment=True).plan_batches(
        TRAIN_BATCH, RESIDENT_STEPS, seed=1))
    stacked = [torch.from_numpy(np.stack([p[i] for p in plans])).to(device)
               for i in range(3)]
    lrs = torch.full((RESIDENT_STEPS,), config.train.learning_rate, device=device)

    def plan(k):
        return [x[k] for x in stacked]

    def chunk(lo, hi):
        return [x[lo:hi] for x in stacked]

    pre_ms = device_ms(lambda: train_lib.resident_inputs(store, *plan(0)[:2], config),
                       runs=5)

    # -- K = 1, eager -----------------------------------------------------------------
    model = copy.deepcopy(init)
    state = train_lib.create_train_state(model, config.train)
    step = train_lib.make_resident_train_step(model, config)
    eager_losses = [step(state, store, *plan(k), lrs[k])["loss"] for k in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_ms = _events_ms(lambda: [step(state, store, *plan(k), lrs[k])
                                   for k in range(4, RESIDENT_STEPS)],
                          RESIDENT_STEPS - 4)
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"resident K=1 eager: {eager_ms:.1f} ms a step (CUDA events over "
          f"{RESIDENT_STEPS - 4} steps) = {TRAIN_BATCH / eager_ms * 1e3:.1f} images/s; "
          f"peak {eager_peak:.2f} GiB; the preprocessing alone {pre_ms:.3f} ms "
          f"({pre_ms / eager_ms:.4f} of the step) ({smi})", flush=True)
    eager_losses = torch.stack(eager_losses).float().cpu()
    line["resident_k1_eager"] = dict(
        step_ms=eager_ms, images_per_s=TRAIN_BATCH / eager_ms * 1e3,
        peak_gib=eager_peak, preprocess_ms=pre_ms)
    del model, state, step
    torch.cuda.empty_cache()

    # -- K = 4 on the graph, then the SWA graph in the same pool -------------------
    model = copy.deepcopy(init)
    state = train_lib.create_train_state(model, config.train)
    pool = torch.cuda.graph_pool_handle()
    multi = train_lib.make_multi_resident_train_step(model, config, pool=pool)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph_losses = multi(state, store, *chunk(0, DISPATCH_K), lrs[:DISPATCH_K])["loss"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    capture_s = multi.graphed.capture_seconds
    graph_ms = _events_ms(lambda: [multi(state, store, *chunk(lo, lo + DISPATCH_K),
                                         lrs[lo:lo + DISPATCH_K])
                                   for lo in range(DISPATCH_K, RESIDENT_STEPS, DISPATCH_K)],
                          RESIDENT_STEPS - DISPATCH_K)
    graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    graph_calls, graph_by, graph_busy = _launches_and_busy(
        lambda: multi(state, store, *chunk(0, 1), lrs[:1]), 1)
    graph_losses = graph_losses.float().cpu()
    torch.cuda.empty_cache()
    one_reserved = torch.cuda.memory_reserved() / 2 ** 30
    print(f"resident K={DISPATCH_K} on the CUDA graph: {graph_ms:.1f} ms a step (CUDA "
          f"events over {RESIDENT_STEPS - DISPATCH_K} steps) = "
          f"{TRAIN_BATCH / graph_ms * 1e3:.1f} images/s; card busy "
          + (f"{graph_busy:.1f} ms a step ({graph_busy / graph_ms:.3f})" if graph_busy
             else "not seen by the profiler inside the graph")
          + f"; {graph_calls:.1f} host launch calls a step "
          f"({', '.join(f'{k} {v:g}' for k, v in sorted(graph_by.items()))}) against "
          f"{eager_profile['host_launches']:.0f} for phase 8's eager step (busy "
          f"{eager_profile['busy']:.3f} of it); peak {graph_peak:.2f} GiB allocated (warm-up "
          f"and capture included), {one_reserved:.2f} GiB reserved after; capture "
          f"{capture_s:.2f} s (first call, warm-up and 4 replays included, "
          f"{first_s:.2f} s) ({smi})", flush=True)
    print(f"  bf16 train-mode losses of the first 4 steps from one state and one "
          f"set of plans, eager / graph: "
          + "; ".join(f"{a:.6f} / {b:.6f}" for a, b in zip(eager_losses.tolist(),
                                                          graph_losses.tolist()))
          + f" (max rel diff {float(((graph_losses - eager_losses).abs() / eager_losses.abs()).max()):.2e})",
          flush=True)
    if not torch.isfinite(graph_losses).all():
        raise AssertionError("non-finite loss on the graph")
    line[f"resident_k{DISPATCH_K}_graph"] = dict(
        step_ms=graph_ms, images_per_s=TRAIN_BATCH / graph_ms * 1e3,
        busy_ms=graph_busy, busy=graph_busy / graph_ms, host_launches=graph_calls,
        peak_gib=graph_peak, reserved_gib=one_reserved, capture_s=capture_s,
        eager_losses=eager_losses.tolist(), graph_losses=graph_losses.tolist())

    swa = train_lib.make_multi_resident_train_step(model, config, freeze_bn=True,
                                                   pool=pool)
    torch.cuda.reset_peak_memory_stats()
    swa(state, store, *chunk(0, DISPATCH_K), lrs[:DISPATCH_K])
    multi(state, store, *chunk(0, DISPATCH_K), lrs[:DISPATCH_K])
    torch.cuda.synchronize()
    both_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    both_reserved = torch.cuda.memory_reserved() / 2 ** 30
    print(f"train-mode and SWA (frozen BN) graphs in one pool, both captured and "
          f"replayed: {both_reserved:.2f} GiB reserved (one graph: "
          f"{one_reserved:.2f}); peak {both_peak:.2f} GiB allocated, the SWA "
          f"graph's warm-up and capture included ({smi})", flush=True)
    line["train_and_swa_graphs"] = dict(reserved_gib=both_reserved,
                                        peak_gib=both_peak)

    # -- the abnormal-loss rollback inside a replay ----------------------------------
    bad = dataclasses.replace(config, train=dataclasses.replace(
        config.train, abnormal_loss_thresh=1e-9))
    bmulti = train_lib.make_multi_resident_train_step(model, bad, pool=pool)
    before = _train_state_tensors(state)
    met = bmulti(state, store, *chunk(0, 2), lrs[:2])
    after = _train_state_tensors(state)
    if met["skipped"].tolist() != [1.0, 1.0] or not _state_equal(after, before):
        raise AssertionError("a replayed step with an abnormal loss moved the state")
    print(f"rollback inside a replay: abnormal_loss_thresh 1e-9, 2 replayed steps -> "
          f"skipped [1, 1], {len(before)} parameters, momentum buffers and BN "
          "statistics bit-identical", flush=True)
    del model, state, multi, swa, bmulti, before, after, pool
    torch.cuda.empty_cache()

    # -- remat on the graph ------------------------------------------------------------
    rcfg = dataclasses.replace(config, model=dataclasses.replace(config.model,
                                                                 remat=True))
    remat = PoseNet(rcfg.model, compute_dtype=torch.bfloat16, device="meta")
    remat = remat.to_empty(device=device).to(memory_format=torch.channels_last)
    remat.load_state_dict(init.state_dict())
    rstate = train_lib.create_train_state(remat, rcfg.train)
    rmulti = train_lib.make_multi_resident_train_step(remat, rcfg)
    torch.cuda.reset_peak_memory_stats()
    rlosses = rmulti(rstate, store, *chunk(0, 2), lrs[:2])["loss"].float().cpu()
    remat_ms = _events_ms(lambda: rmulti(rstate, store, *chunk(2, 4), lrs[2:4]), 2)
    remat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"remat on the graph (K=2): {remat_ms:.1f} ms a step, peak "
          f"{remat_peak:.2f} GiB, losses {[round(x, 6) for x in rlosses.tolist()]} "
          f"(eager without remat: {[round(x, 6) for x in eager_losses[:2].tolist()]}) "
          f"({smi})", flush=True)
    if not torch.isfinite(rlosses).all():
        raise AssertionError("remat on the graph: non-finite loss")
    line["remat_k2_graph"] = dict(step_ms=remat_ms, peak_gib=remat_peak)
    del remat, rstate, rmulti
    torch.cuda.empty_cache()

    # -- graph against eager, fp32, frozen BN, deterministic cuDNN ---------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    runs = []
    for graphed in (False, True):
        m = copy.deepcopy(init)
        m.compute_dtype = torch.float32
        st = train_lib.create_train_state(m, config.train)
        if graphed:
            met = train_lib.make_multi_resident_train_step(m, config, freeze_bn=True)(
                st, store, *chunk(0, FP32_STEPS), lrs[:FP32_STEPS])
        else:
            fstep = train_lib.make_resident_train_step(m, config, freeze_bn=True)
            mets = [fstep(st, store, *plan(k), lrs[k]) for k in range(FP32_STEPS)]
            met = {k: torch.stack([x[k] for x in mets]) for k in mets[0]}
        runs.append((met, _train_state_tensors(st)))     # compared on the card
        del m, st, met
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (me, se), (mg, sg) = runs
    identical = _state_equal(sg, se) and all(torch.equal(mg[k], me[k]) for k in me)
    rel = _rel_err(sg, se)
    print(f"fp32, frozen BN, {FP32_STEPS} steps (the graph captured for K="
          f"{DISPATCH_K}) from one state and one set of plans, "
          f"graph against eager: {'bit-identical' if identical else 'not bit-identical'}"
          f" ({len(se)} tensors; largest relative difference {rel:.2e}, tolerance "
          f"{GRAPH_TOL}); losses {me['loss'].tolist()} / {mg['loss'].tolist()}",
          flush=True)
    if not (identical or rel <= GRAPH_TOL):
        raise AssertionError("the graph's steps disagree with eager steps")
    line["fp32_frozen_graph_vs_eager"] = dict(bit_identical=identical, max_rel=rel)
    del runs

    # -- the dense wire feed, K = 4 on the graph, through the loader and staging -------
    model = copy.deepcopy(init)
    state = train_lib.create_train_state(model, config.train)
    dmulti = train_lib.make_multi_train_step(model, config)
    loader = PrefetchingLoader(SyntheticDataset(config, length=64,
                                                image_size=config.height),
                               num_workers=6)
    n_dense = DISPATCH_K + 2            # the capture chunk, then 2 timed steps
    with_lr = ((*b, np.asarray(config.train.learning_rate, np.float32))
               for b in loader.batches(TRAIN_BATCH, n_dense, seed=1))
    dense_losses = []
    torch.cuda.reset_peak_memory_stats()
    for i, (n, c) in enumerate(mesh_lib.staged_chunks(device, with_lr, DISPATCH_K)):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        dense_losses.append(dmulti(state, *c)["loss"])
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) / (n_dense - DISPATCH_K) * 1e3
    dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    dense_reserved = torch.cuda.memory_reserved() / 2 ** 30
    dense_losses = torch.cat(dense_losses).float().cpu()
    if dense_losses.shape != (n_dense,) or not torch.isfinite(dense_losses).all():
        raise AssertionError("dense feed on the graph: bad losses")
    print(f"dense wire feed, K={DISPATCH_K} on the graph, PrefetchingLoader (6 "
          f"workers) and staged_chunks: {dense_ms:.1f} ms a step after the capture "
          f"chunk (host clock) = {TRAIN_BATCH / dense_ms * 1e3:.1f} images/s; peak "
          f"{dense_peak:.2f} GiB allocated (warm-up and capture included), "
          f"{dense_reserved:.2f} GiB reserved after ({smi})", flush=True)
    line[f"dense_k{DISPATCH_K}_graph"] = dict(
        e2e_ms=dense_ms, images_per_s=TRAIN_BATCH / dense_ms * 1e3,
        peak_gib=dense_peak, reserved_gib=dense_reserved)
    del model, state, dmulti, loader
    torch.cuda.empty_cache()

    # -- the trainer: --feed resident --steps-per-dispatch 4, write and resume --------
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--feed", "resident", "--resident-augment", "--steps-per-dispatch",
                str(DISPATCH_K), "--epochs", "1", "--steps-per-epoch",
                str(DISPATCH_K), "--batch-size", str(TRAIN_BATCH),
                "--synthetic-length", str(APP_RECORDS), "--print-freq", "4",
                "-p", tmp]
        t0 = time.perf_counter()
        if train_app.main(argv) != 0:
            raise AssertionError("apps.train --feed resident failed")
        first = _saved_step(os.path.join(tmp, "pth"))
        argv[argv.index("--epochs") + 1] = "2"
        if train_app.main(argv + ["-r"]) != 0:
            raise AssertionError("apps.train -r failed")
        resumed = _saved_step(os.path.join(tmp, "pth"))
        if (first["step"], resumed["step"], resumed["epoch"]) != (
                DISPATCH_K, 2 * DISPATCH_K, 1):
            raise AssertionError(f"the trainer's checkpoints: steps {first['step']}, "
                                 f"{resumed['step']}, epoch {resumed['epoch']}")
        print(f"apps.train --feed resident (Canonical 512²) "
              f"--resident-augment --steps-per-dispatch {DISPATCH_K}, a "
              f"{APP_RECORDS}-record store: epoch 0 ({DISPATCH_K} "
              f"steps) written, resumed with -r for epoch 1 (step "
              f"{resumed['step']}), in {time.perf_counter() - t0:.1f} s", flush=True)
    line["hand_kernel_launches"] = {k: getattr(kernels, k).launches
                                    for k in ("nms", "fused_peaks", "int8_quantize",
                                              "int8_conv")}
    if any(line["hand_kernel_launches"].values()):
        raise AssertionError("the training path launched a serving kernel")
    return line, store_h


# ---------------------------------------------------------------------------
# phase 12: multi-GPU (data-parallel training, the sharded store, mesh
# serving, the dry run) and the cv2-free letterbox
# ---------------------------------------------------------------------------

LETTERBOX_FRAMES = ((1080, 1920), (480, 640), (1000, 300))   # (h, w)
GLOO_SIZE = 256        # phase 12 (b)'s images: two gloo ranks share the card
GLOO_STEPS = 2         # and its steps a BN mode


def mesh_serving(model, config, frames, requests, device, smi) -> dict:
    """Phase 12 (a): ``predict_batch(mesh=)`` against ``predict_batch``."""
    from improved_body_parts_tpu_torch.infer.predict import Predictor, unpack_results
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.parallel.mesh import make_mesh

    line = {}
    one, two = make_mesh(), make_mesh(devices=[device, device])
    print(f"meshes: {[str(d) for d in one.devices]} and {[str(d) for d in two.devices]} "
          "(the one card listed twice: two replicas, two streams)", flush=True)
    B = len(frames)
    hs = np.full((B,), 512.0, np.float32)
    chws = np.tile(np.float32([512.0, 512.0]), (B, 1))
    key = ((1.0,), (0.0,))

    # fp32, deterministic cuDNN: the packed buffers equal
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model.compute_dtype = torch.float32
    pred = Predictor(model, config, device=device)
    with torch.inference_mode():
        flat = pred._run(frames, hs, chws, *key)[0].cpu().numpy()
        halves = np.concatenate([pred._run(frames[i:i + B // 2], hs[:B // 2],
                                           chws[:B // 2], *key)[0].cpu().numpy()
                                 for i in (0, B // 2)])
    got1 = pred._run_mesh(one, frames, hs, chws, *key)
    got2 = pred._run_mesh(two, frames, hs, chws, *key)
    eq1, eq2 = np.array_equal(got1, flat), np.array_equal(got2, halves)
    d2 = float(np.abs(got2 - flat).max())
    print(f"fp32, deterministic cuDNN, batch {B}: mesh of 1 == unsharded packed "
          f"buffers: {eq1}; mesh of 2 replicas == the unsharded predictor on each "
          f"half: {eq2} (against the batch of {B} in one pass: max abs diff "
          f"{d2:.3e}, cuDNN's choice for 4 frames against 8)", flush=True)
    if not (eq1 and eq2):
        raise AssertionError("mesh serving changed the packed buffers")
    torch.backends.cudnn.deterministic = False
    model.compute_dtype = torch.bfloat16
    line["fp32_packed_equal"] = dict(mesh1=eq1, mesh2_vs_halves=eq2,
                                     mesh2_vs_batch_max_abs=d2)

    # bf16: the same people and peaks, the largest keypoint difference
    pred = Predictor(model, config, device=device)
    want = pred.predict_batch(frames, use_cpp=True)
    with torch.inference_mode():
        want_buf = pred._run(frames, hs, chws, *key)[0].cpu().numpy()
    P = config.infer.max_peaks
    worst, people, peaks, peaks_want, same = 0.0, 0, 0, 0, 0
    for mesh, n in ((one, B), (two, B), (two, B - 1)):
        got = pred.predict_batch(frames[:n], mesh=mesh, use_cpp=True)
        if len(got) != n:
            raise AssertionError("mesh serving returned a wrong count")
        for (kg, _), (kw, _) in zip(got, want):
            if kg.shape != kw.shape:
                raise AssertionError(f"mesh serving found {len(kg)} people, "
                                     f"unsharded {len(kw)}")
            if len(kg):
                worst = max(worst, float(np.abs(kg[..., :2] - kw[..., :2]).max()))
            people += len(kg)
        buf = pred._run_mesh(mesh, frames, hs, chws, *key)
        if mesh is one and not np.array_equal(buf, want_buf):
            raise AssertionError("bf16: the mesh of 1 changed the packed buffers")
        for b in range(n):
            gp, _ = unpack_results(buf[b], P)
            wp, _ = unpack_results(want_buf[b], P)
            peaks += int(gp.valid.sum())
            peaks_want += int(wp.valid.sum())
            for k in range(gp.valid.shape[0]):       # joint type k: same places?
                a = {tuple(p) for p in np.round(gp.xy[k][gp.valid[k]], 2)}
                same += len(a & {tuple(p) for p in np.round(wp.xy[k][wp.valid[k]], 2)})
    print(f"bf16: meshes of 1 and 2 replicas (and 7 frames padded to 8 on 2) find "
          f"the unsharded people ({people} in 3 runs; random weights); the mesh of "
          f"1 gives the unsharded packed buffers bit for bit; peaks {peaks} on the "
          f"meshes against {peaks_want} unsharded, {same} of them at the same "
          f"place to 0.01 px (2 replicas run cuDNN on 4 frames, not 8); largest "
          f"keypoint difference {worst:.3e} px", flush=True)
    line["bf16_same_people"] = dict(people=people, max_keypoint_px=worst,
                                    peaks=peaks, peaks_unsharded=peaks_want,
                                    peaks_same_place=same)

    # PipelinedServer(mesh=), frames/s beside the unsharded server
    p = Predictor(model, config, device=device)
    for mesh in (one, two):
        p.predict_batch(frames, mesh=mesh, use_cpp=True)          # replicas, plans
    torch.cuda.synchronize()
    for what, kw in (("unsharded", {}), ("mesh of 1", {"mesh": one}),
                     ("mesh of 2 replicas", {"mesh": two}), ("unsharded", {})):
        kernels.reset_launch_counts()
        fps = serve_requests(p, requests, DEPTH, f"PipelinedServer {what}", **kw)
        nms = kernels.nms.launches
        if nms == 0:
            raise AssertionError(f"PipelinedServer {what}: nms never launched")
        print(f"PipelinedServer({what}), batch {BATCH} depth {DEPTH}: "
              f"{len(requests)} requests at {fps:.2f} frames/s; nms launches "
              f"{nms} ({smi})", flush=True)
        line.setdefault("serving", []).append(dict(mesh=what, frames_per_s=fps,
                                                   nms_launches=nms))
    return line


def letterbox_plain(img: np.ndarray, size: int, pad: int):
    """The letterbox of ``Predictor.letterbox`` in plain numpy: OpenCV's
    fixed-point cubic (int64 sums; the float32 SIMD rows of 8) written out
    column by column, independently of ``ops/warp.resize_cubic_u8``."""
    h, w = img.shape[:2]
    scale = min(size / h, size / w)
    ow, oh = int(round(w * scale)), int(round(h * scale))

    def taps(n_out, n_in, sc):
        rows = []
        for d in range(n_out):
            f = np.float32((d + 0.5) * sc - 0.5)
            s = int(np.floor(f))
            x = np.float32(f - np.float32(s))
            a = np.float32(-0.75)
            c = [((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a,
                 ((a + 2) * x - (a + 3)) * x * x + 1,
                 ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1]
            c.append(np.float32(1) - c[0] - c[1] - c[2])
            rows.append(([min(max(s + k, 0), n_in - 1) for k in (-1, 0, 1, 2)],
                         [int(np.rint(np.float32(v) * np.float32(2048))) for v in c]))
        return rows

    if (ow, oh) == (w, h):
        out = img
    else:
        hor = np.zeros((h, ow, 3), np.int64)
        for x, (ix, cx) in enumerate(taps(ow, w, 1.0 / (ow / w))):
            hor[:, x] = sum(img[:, i].astype(np.int64) * c for i, c in zip(ix, cx))
        out = np.zeros((oh, ow * 3), np.int64)
        flat = hor.reshape(h, ow * 3)
        nv = (ow * 3) // 8 * 8
        for y, (iy, cy) in enumerate(taps(oh, h, 1.0 / (oh / h))):
            v = sum(flat[i] * c for i, c in zip(iy, cy))
            out[y] = (v + (1 << 21)) >> 22
            acc = flat[iy[3], :nv].astype(np.float32) * np.float32(cy[3] / 2048 ** 2)
            for k in (2, 1, 0):
                acc = (flat[iy[k], :nv].astype(np.float32)
                       * np.float32(cy[k] / 2048 ** 2) + acc).astype(np.float32)
            out[y, :nv] = np.rint(acc)
        out = np.clip(out, 0, 255).astype(np.uint8).reshape(oh, ow, 3)
    canvas = np.full((size, size, 3), pad, np.uint8)
    canvas[:oh, :ow] = out
    return canvas, scale


def letterbox_and_serve(model, config, frames, device, smi) -> dict:
    """Phase 12 (f): the cv2-free letterbox on camera-sized frames against
    its plain version, its ms, and 64 requests of 640x480 frames served."""
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    line = {}
    pred = Predictor(model, config, device=device)
    rng = np.random.RandomState(SEED)
    size, pad = config.infer.boxsize, config.infer.pad_value
    for h, w in LETTERBOX_FRAMES:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got, scale = pred.letterbox(img)
        want, want_scale = letterbox_plain(img, size, pad)
        if not (np.array_equal(got, want) and scale == want_scale):
            raise AssertionError(f"letterbox of {w}x{h} differs from its plain "
                                 "version")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.letterbox(img)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        print(f"letterbox {w}x{h} -> {size}² (cv2 not imported): equal to its "
              f"plain version; {ms:.2f} ms on the host (median of 5, torch on "
              f"the CPU; {smi})", flush=True)
        line[f"{w}x{h}"] = dict(equal=True, ms=ms)
    if "cv2" in sys.modules:
        raise AssertionError("cv2 was imported")
    requests = []
    for i in range(N_REQUESTS):
        img = np.full((480, 640, 3), 128, np.uint8)
        img[:, 64:576] = frames[i % len(frames)][16:496]
        requests.append(img)
    fps = serve_requests(pred, requests, DEPTH, "640x480 serving")
    print(f"PipelinedServer on {N_REQUESTS} 640x480 frames (each letterboxed "
          f"without cv2): answered, {fps:.2f} frames/s ({smi})", flush=True)
    line["serve_640x480_frames_per_s"] = fps
    return line


def _torchrun_train(ports) -> tuple:
    """Phase 12 (d): ``apps.train`` under ``torchrun --nproc-per-node 1``
    (tiny, 128²), written, then resumed with ``-r``, on the two ``ports``:
    (line, message)."""
    import os
    import tempfile

    from improved_body_parts_tpu_torch.tools import multi_card
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
               "--master-port", str(ports[0]), "-m",
               "improved_body_parts_tpu_torch.apps.train", "--tiny-model",
               "--image-size", "128", "--batch-size", "4", "--feed", "resident",
               "--resident-augment", "--resident-shard-store", "--steps-per-dispatch",
               str(DISPATCH_K), "--epochs", "1", "--steps-per-epoch", "4",
               "--synthetic-length", "8", "--print-freq", "4", "-p", tmp]
        t0 = time.perf_counter()
        out = multi_card.run_tree(cmd, 300, "torchrun apps.train")
        if "rank 0 of 1 (nccl)" not in out:
            raise AssertionError("apps.train under torchrun did not join NCCL")
        written = ckpt.restore_train_state(os.path.join(tmp, "pth"))
        cmd[cmd.index("--epochs") + 1] = "2"
        cmd[cmd.index("--master-port") + 1] = str(ports[1])
        multi_card.run_tree(cmd + ["-r"], 300, "torchrun apps.train -r")
        resumed = ckpt.restore_train_state(os.path.join(tmp, "pth"))
        if (written["step"], resumed["step"], resumed["epoch"]) != (4, 8, 1):
            raise AssertionError(f"torchrun checkpoints: steps {written['step']}, "
                                 f"{resumed['step']}, epoch {resumed['epoch']}")
        tr_s = time.perf_counter() - t0
    return (dict(written_step=4, resumed_step=8, seconds=tr_s),
            f"torchrun --nproc-per-node 1 apps.train --feed resident "
            f"--resident-shard-store --steps-per-dispatch {DISPATCH_K} (tiny model, "
            f"128²): epoch 0 written (step 4), resumed with -r (step 8), in "
            f"{tr_s:.1f} s, two launches (beside (b) and (e))")


def _dry_run(n: int, port: int) -> tuple:
    """Phase 12 (e): ``tools/dryrun_multichip`` over the ``n`` cards in a
    process of its own, its ranks' rendezvous on ``port``: (line, its
    result line)."""
    from improved_body_parts_tpu_torch.tools import multi_card

    t0 = time.perf_counter()
    out = multi_card.run_tree(
        [sys.executable, "-m", "improved_body_parts_tpu_torch.tools.dryrun_multichip",
         str(n), "--port", str(port)], 600, "dryrun_multichip")
    ok = [ln for ln in out.splitlines() if "dryrun_multichip(" in ln]
    return (dict(n=n, rc=0, seconds=time.perf_counter() - t0),
            (ok[-1] if ok else out[-2000:]) + " (beside (b) and (d))")


def multi_gpu(model, config, frames, requests, device, smi, graph_ms: float,
              init, store_h) -> dict:
    """Phase 12: (a) mesh serving, (b) two gloo ranks on the one card
    against one process (at GLOO_SIZE²), (c) one NCCL rank, K = 4 on the
    CUDA graph, from copies of ``init`` (the reference init on the card)
    on phase 11's 64-record store ``store_h``,
    (d) apps.train under torchrun, (e) the dry run (both beside (b) and
    (c)'s fp32 check), (f) the letterbox."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    from improved_body_parts_tpu_torch.tools import multi_card
    from improved_body_parts_tpu_torch.tools.dryrun_multichip import distinct_ports

    line = {"card": smi, "cards_visible": torch.cuda.device_count()}
    print("-- (a) serving on the mesh", flush=True)
    line["mesh_serving"] = mesh_serving(model, config, frames, requests, device, smi)

    # (d) and (e) run processes of their own on tiny models, beside (b),
    # whose two ranks mostly wait on gloo, and beside (c)'s fp32 graph =
    # eager check (deterministic cuDNN with heuristic algorithm choice, and
    # the card's memory two-thirds free: no load changes its bits). So (b)'s
    # times are taken under their load; (a)'s, (c)'s and (f)'s alone, after
    # both have ended. Every port is picked here, before any launch starts.
    from improved_body_parts_tpu_torch.configs import get_config

    n = torch.cuda.device_count()
    gloo_port, dry_port, nccl_port, *run_ports = distinct_ports(5)
    with ThreadPoolExecutor(2) as pool:
        torchrun_future = pool.submit(_torchrun_train, run_ports)
        dryrun_future = pool.submit(_dry_run, n, dry_port)
        print("-- (b) two ranks on the one card over gloo, against one process "
              "(beside (d) and (e): its times are taken under their load)",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()        # the card's memory for the two ranks
        line["gloo_two_ranks"] = multi_card.agreement(
            2, TRAIN_BATCH // 2, True, device, smi, image_size=GLOO_SIZE,
            steps=GLOO_STEPS, port=gloo_port)
        line["gloo_two_ranks"]["timed_beside"] = ["(d) torchrun apps.train",
                                                  "(e) dryrun_multichip"]

        print("-- (c) one rank over NCCL: fp32 frozen BN, graph against eager "
              "(beside (d) and (e))", flush=True)
        cfg = get_config("Canonical")
        store = store_h.device_arrays(device)
        dev = mesh_lib.initialize_multihost(f"localhost:{nccl_port}", 1, 0)
        mesh = mesh_lib.make_mesh()
        rplans = multi_card.make_plans(store_h, cfg, TRAIN_BATCH, RESIDENT_STEPS,
                                       0, 1, 1)
        stacked = [torch.from_numpy(np.stack([p[i] for p in rplans])).to(dev)
                   for i in range(3)]
        lrs = torch.full((RESIDENT_STEPS,), cfg.train.learning_rate, device=dev)

        def chunk(lo, hi):
            return [x[lo:hi] for x in stacked]

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        runs, free_gib, peak_gib = [], [], []
        for graphed in (False, True):
            free_gib.append(torch.cuda.mem_get_info(device)[0] / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
            m = copy.deepcopy(init)
            m.compute_dtype = torch.float32
            st = train_lib.create_train_state(m, cfg.train)
            if graphed:
                met = train_lib.make_multi_resident_train_step(
                    m, cfg, freeze_bn=True, mesh=mesh)(st, store, *chunk(0, FP32_STEPS),
                                                       lrs[:FP32_STEPS])
            else:
                fstep = train_lib.make_resident_train_step(m, cfg, freeze_bn=True,
                                                           mesh=mesh)
                mets = [fstep(st, store, *[x[k] for x in stacked], lrs[k])
                        for k in range(FP32_STEPS)]
                met = {k: torch.stack([x[k] for x in mets]) for k in mets[0]}
            runs.append((met, _train_state_tensors(st)))  # compared on the card
            peak_gib.append(torch.cuda.max_memory_reserved() / 2 ** 30)
            del m, st, met
            mets = fstep = None
            gc.collect()
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        (me, se), (mg, sg) = runs
        identical = _state_equal(sg, se) and all(torch.equal(mg[k], me[k]) for k in me)
        n_diff = sum(not torch.equal(sg[k], se[k]) for k in se)
        print(f"1 NCCL rank, fp32 frozen BN, {FP32_STEPS} steps, graph against eager: "
              f"{'bit-identical' if identical else 'NOT bit-identical'} ({n_diff} of "
              f"{len(se)} tensors differ; largest relative difference "
              f"{_rel_err(sg, se):.2e}; losses equal by step "
              f"{[bool(x) for x in (mg['loss'] == me['loss'])]}; card memory free "
              f"before eager/graph {free_gib[0]:.2f}/{free_gib[1]:.2f} GiB, peak "
              f"reserved {peak_gib[0]:.2f}/{peak_gib[1]:.2f} GiB, (d) and (e) "
              f"running)", flush=True)
        if not identical:
            raise AssertionError("the data-parallel graph differs from eager steps")
        del runs
        torchrun_result = torchrun_future.result()
        dryrun_result = dryrun_future.result()
    print("-- (d) apps.train under torchrun --nproc-per-node 1", flush=True)
    line["torchrun_train"], msg = torchrun_result
    print(msg, flush=True)
    print(f"-- (e) the dry run over {n} card(s)", flush=True)
    line["dryrun"], msg = dryrun_result
    print(msg, flush=True)

    print("-- (c) one rank over NCCL, K=4 on the CUDA graph (alone)", flush=True)
    m = copy.deepcopy(init)
    st = train_lib.create_train_state(m, cfg.train)
    multi = train_lib.make_multi_resident_train_step(m, cfg, mesh=mesh)
    first = multi(st, store, *chunk(0, DISPATCH_K), lrs[:DISPATCH_K])["loss"]
    dp_ms = _events_ms(lambda: [multi(st, store, *chunk(lo, lo + DISPATCH_K),
                                      lrs[lo:lo + DISPATCH_K])
                                for lo in range(DISPATCH_K, RESIDENT_STEPS, DISPATCH_K)],
                       RESIDENT_STEPS - DISPATCH_K)
    calls, by, busy = _launches_and_busy(
        lambda: multi(st, store, *chunk(0, 1), lrs[:1]), 1)
    first = first.float().cpu()
    if multi.graphed is None or not torch.isfinite(first).all():
        raise AssertionError("the data-parallel step was not captured, or diverged")
    print(f"1 NCCL rank, K={DISPATCH_K} on the CUDA graph (all-reduces captured): "
          f"{dp_ms:.1f} ms a step against {graph_ms:.1f} ms for phase 11's graph "
          f"step without the data-parallel code (x{dp_ms / graph_ms:.3f}); "
          f"{calls:.1f} host launch calls a step "
          f"({', '.join(f'{k} {v:g}' for k, v in sorted(by.items()))}); busy "
          f"{busy:.1f} ms; capture {multi.graphed.capture_seconds:.2f} s; losses "
          f"{[round(x, 6) for x in first.tolist()]} ({smi})", flush=True)
    line["nccl_one_rank_graph"] = dict(step_ms=dp_ms, phase11_graph_ms=graph_ms,
                                       ratio=dp_ms / graph_ms, host_launches=calls,
                                       busy_ms=busy, losses=first.tolist(),
                                       fp32_frozen_graph_vs_eager_identical=identical)
    del m, st, multi
    torch.distributed.destroy_process_group()
    del store, init
    gc.collect()
    torch.cuda.empty_cache()

    print("-- (f) the letterbox without cv2", flush=True)
    line["letterbox"] = letterbox_and_serve(model, config, frames, device, smi)
    return line


# ---------------------------------------------------------------------------
# phase 13: the measurement and evaluation entry points
# ---------------------------------------------------------------------------

MEASURE_TRAIN_WARM = 2
MEASURE_TRAIN_TIMED = 4
EVAL_CURVE_FRAMES = 8


def _expect_launches(what: str, want: dict) -> dict:
    """The launch counts since the last reset; raises unless each kernel of
    ``want`` launched exactly that many times."""
    from improved_body_parts_tpu_torch.ops import kernels
    got = {k: getattr(kernels, k).launches for k in
           ("nms", "fused_peaks", "int8_quantize", "int8_conv")}
    for k, n in want.items():
        if got[k] != n:
            raise AssertionError(f"{what}: {k} launched {got[k]} times, "
                                 f"expected {n} ({got})")
    return got


def _two_epochs(model, config, root: str, device) -> list:
    """``<root>/pth/epoch_0.pth`` (``model``'s weights) and ``epoch_1.pth``
    (those after two SGD steps on synthetic 512² batches of 2, through
    ``staged_batches``), the layout ``apps.train`` writes; their paths."""
    import os

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.parallel.mesh import staged_batches
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt

    pth = os.path.join(root, "pth")
    net = copy.deepcopy(model)
    state = train_lib.create_train_state(net, config.train)
    ckpt.save_train_state(pth, train_lib.state_payload(state, config.train, epoch=0),
                          step=0)
    step = train_lib.make_train_step(net, config)
    ds = SyntheticDataset(config, length=8, seed=SEED, image_size=config.height)
    losses = [step(state, *b, config.train.learning_rate)["loss"]
              for b in staged_batches(device, ds.batches(2, 2, seed=3), depth=0)]
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("non-finite loss in the two SGD steps")
    ckpt.save_train_state(pth, train_lib.state_payload(state, config.train, epoch=1),
                          step=1)
    del net, state, step
    torch.cuda.empty_cache()
    return [ckpt.checkpoint_path(pth, e) for e in (0, 1)]


def measurement_entry_points(model, qmodel, config, device, smi) -> dict:
    """Phase 13: the port's benchmark and evaluation entry points, each
    through the function its CLI wraps, on the phase-3 model and phase 10's
    int8 model: (a) ``apps.bench`` bf16, fused and int8 with the launches
    each arm must make; (b) ``apps.inference_speed`` bf16 and int8 with
    MFU; (c) ``tools.profile_postproc``'s stages at 128²; (d)
    ``tools.stress_grouping`` at 2, 8 and 20 people; (e)
    ``tools.bench_train_step`` dense K = 1 and resident K = 4 on the graph;
    (f) ``tools.export_quantized`` from an ``apps.train``-layout ``.pth``,
    one batch served from the file bit for bit against in-process PTQ;
    (g) ``tools.eval_curve`` over two epochs' ``.pth`` on synthetic
    frames; (h) ``tools.e2e_trained_smoke``'s scoring on the second."""
    import dataclasses
    import os
    import tempfile

    from improved_body_parts_tpu_torch.apps import bench, inference_speed
    from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.models import quantize as qz
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.tools import (
        bench_train_step, e2e_trained_smoke, eval_curve, export_quantized,
        profile_postproc, stress_grouping,
    )
    from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth

    line = {}
    card = torch.cuda.get_device_name(0)
    # (a) the e2e benchmark, its full protocol, each arm's launches counted:
    # a post-processing for each realistic table, the 4 warm-up calls and
    # the two timed runs' batches; a forward for the last two
    frames = bench.bench_frames(512, synthetic=False)
    n_post = bench.BATCH + 4 + 2 * bench.N_BATCHES
    n_fwd = 4 + 2 * bench.N_BATCHES
    kernels.reset_launch_counts()
    with torch.inference_mode():
        qmodel.predict_maps(torch.zeros(2, 512, 512, 3, device=device))
    # launches of one int8 serving forward (the read-out runs 296 of the
    # 308 conv blocks)
    q_per_fwd = kernels.int8_quantize.launches
    convs = kernels.int8_conv.launches
    arms = {"bf16": (model, False, dict(nms=n_post, fused_peaks=0, int8_conv=0)),
            "fused": (model, True, dict(nms=0, fused_peaks=n_post, int8_conv=0)),
            "int8": (qmodel, False, dict(nms=n_post, fused_peaks=0,
                                         int8_conv=convs * n_fwd,
                                         int8_quantize=q_per_fwd * n_fwd))}
    line["bench"] = {}
    for arm, (net, fused, want) in arms.items():
        pred = Predictor(net, config, device=device, fused_peaks=fused)
        kernels.reset_launch_counts()
        out = bench.run(pred, frames, bench.realistic_packed_buffers(pred, bench.BATCH),
                        n_batches=bench.N_BATCHES)
        torch.cuda.synchronize()
        got = _expect_launches(f"apps.bench {arm}", want)
        if out["warm_found"] == 0:
            raise AssertionError(f"apps.bench {arm}: the GT tables grouped nobody")
        print(json.dumps(dict(bench.result_line(out["fps"]), arm=arm)), flush=True)
        print(f"apps.bench {arm}: {out['fps']:.2f} frames/s e2e ({out['n_frames']} "
              f"frames, batch {out['batch']}, {out['depth']} threads); ingest "
              f"{out['ingest_fps']:.2f} frames/s; single image "
              f"{out['single_latency_ms']:.1f} ms; launches {got} ({smi})",
              flush=True)
        line["bench"][arm] = dict(out, launches=got)
        del pred

    # (b) the network alone, with MFU
    imgs = torch.from_numpy(np.random.RandomState(0).rand(4, 512, 512, 3)
                            .astype(np.float32)).to(device)
    line["inference_speed"] = {}
    for arm, net in (("bf16", model), ("int8", qmodel)):
        res = inference_speed.measure(net, imgs, 20, mfu=True, int8=arm == "int8",
                                      flop_model=model)
        for text in inference_speed.report_lines(res, card):
            print(f"apps.inference_speed {arm}: {text} ({smi})", flush=True)
        line["inference_speed"][arm] = res

    # (c) the post-processing stage by stage: 17 calls a stage (a warm-up
    # and 16 timed); nms in every stage but the fused one
    kernels.reset_launch_counts()
    rows = profile_postproc.profile(device, hw=128, iters=16)
    _expect_launches("profile_postproc", dict(nms=4 * 17, fused_peaks=17))
    for text in profile_postproc.table_lines(rows, device, 128,
                                             config.infer.max_peaks):
        print(f"profile_postproc: {text} ({smi})", flush=True)
    line["profile_postproc_ms"] = rows

    # (d) crowd grouping
    line["stress_grouping"] = []
    for n in (2, 8, 20):
        kernels.reset_launch_counts()
        st = stress_grouping.run_scene(n, 30, device)
        _expect_launches(f"stress_grouping {n}", dict(nms=1))
        if st["persons_found"] != n:
            raise AssertionError(f"stress_grouping: {st['persons_found']} of {n} found")
        print(json.dumps(dict(st, device=card)), flush=True)
        line["stress_grouping"].append(st)

    # (e) the train step against the feed
    mcfg, init = bench_train_step.build_model(config, tiny=False, remat=True,
                                              device=device)
    tcfg = dataclasses.replace(config, model=mcfg)
    line["bench_train_step"] = []
    for feed, k in (("dense", 1), ("resident", 4)):
        rec = bench_train_step.run_config(
            init, tcfg, feed, k, steps=MEASURE_TRAIN_TIMED, batch=TRAIN_BATCH,
            device=device, warmup=MEASURE_TRAIN_WARM)
        if k > 1 and not rec["graph"]:
            raise AssertionError("bench_train_step resident K=4 did not run the graph")
        print(json.dumps(rec), flush=True)
        line["bench_train_step"].append(rec)
    del init
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        paths = _two_epochs(model, config, root, device)

        # (f) the int8 export, served from the file against in-process PTQ
        fp = copy.deepcopy(model)
        fp.load_state_dict(load_reference_pth(paths[0]))
        batches = export_quantized.calibration_batches(config, config.height)
        out_path = os.path.join(root, "int8.pth")
        inproc, n_bytes, secs = export_quantized.export(fp, batches, out_path)
        loaded = qz.load_quantized(config.model, out_path, device=device)
        nb = len(frames[0])
        hs = np.full((nb,), 512.0, np.float32)
        chws = np.tile(np.float32([512.0, 512.0]), (nb, 1))
        kernels.reset_launch_counts()
        a = Predictor(loaded, config, device=device)._run(frames[0], hs, chws)[0].cpu()
        _expect_launches("export_quantized serving", dict(int8_conv=convs, nms=1))
        b = Predictor(inproc, config, device=device)._run(frames[0], hs, chws)[0].cpu()
        if not torch.equal(a, b):
            raise AssertionError("the int8 export does not serve as in-process PTQ")
        print(f"export_quantized: {n_bytes / 1e6:.0f} MB from epoch_0.pth, "
              f"calibrated on {sum(len(x) for x in batches)} images in {secs:.1f} s; "
              f"one batch served from the file equals in-process PTQ bit for bit "
              f"(packed buffers)", flush=True)
        line["export_quantized"] = dict(mb=n_bytes / 1e6, seconds=secs, bitwise=True)
        del fp, inproc, loaded

        # (g) the AP curve over both epochs (and one missing) on in-memory frames
        eval_frames, gt = synthetic_coco(EVAL_CURVE_FRAMES, size=512)
        pred = Predictor(copy.deepcopy(model), config, device=device)
        kernels.reset_launch_counts()
        rows = eval_curve.curve(pred, eval_curve.arms(root, [0, 1, 5]),
                                eval_frames, gt, log=lambda s: None)
        _expect_launches("eval_curve", dict(nms=2 * EVAL_CURVE_FRAMES))
        keys = {"arm", "ap", "ap50", "ap75", "ar", "n_dets", "seconds"}
        if [r["arm"] for r in rows] != ["epoch0", "epoch1"] or any(
                set(r) != keys or not 0.0 <= r["ap"] <= 1.0 for r in rows):
            raise AssertionError(f"eval_curve rows malformed: {rows}")
        for r in rows:
            print(f"eval_curve: {json.dumps(r)}", flush=True)
        line["eval_curve"] = rows

        # (h) the trained-checkpoint smoke's scoring on the second epoch
        with torch.no_grad():
            pred.model.load_state_dict(load_reference_pth(paths[1]))
        ok, scenes = e2e_trained_smoke.score_scenes(
            pred, 512, log=lambda s: print(f"e2e_trained_smoke: {s}", flush=True))
        scene_keys = {"scene", "people", "matched", "mean_err_px", "detections",
                      "dropped_peaks", "ok"}
        if len(scenes) != 3 or any(set(r) != scene_keys for r in scenes):
            raise AssertionError(f"e2e_trained_smoke rows malformed: {scenes}")
        print(f"e2e_trained_smoke: {'passes' if ok else 'does not pass'} on "
              "weights two SGD steps from random (a well-formed result is "
              "what is checked)", flush=True)
        line["e2e_trained_smoke"] = dict(ok=ok, scenes=scenes)
        del pred
    torch.cuda.empty_cache()
    return line

# ---------------------------------------------------------------------------
# phase 14: the spatial mesh axis
def spatial_axis(smi: str) -> dict:
    """Phase 14: ``tools.multi_card.spatial`` on the one card: 2 gloo ranks
    sharing it as data 1 × spatial 2 (each its band of the 512² images'
    rows) against one process on the same global batch of 2, 2 fp32
    frozen-BN steps (parameters within 1e-5 of their move, losses) and 2
    bf16 train-mode steps (losses within 5%); ms a step, peak GiB a rank,
    halo exchanges a step; and the reason the ranks' K-steps dispatch runs
    eagerly (gloo cannot be captured; NCCL, which is captured, takes a
    card a rank, and ``multi_card spatial`` holds its graph on four cards).
    Raises on any failure: nothing falls back to one process."""
    import gc

    from improved_body_parts_tpu_torch.tools import multi_card
    gc.collect()
    torch.cuda.empty_cache()        # the card's memory for the two ranks
    return multi_card.spatial(1, smi)


# ---------------------------------------------------------------------------
# phase 15: image files and the remaining tools on the card
# ---------------------------------------------------------------------------

N_FILES = 8
SPLIT_SCALES = (0.5, 1.0, 1.5)
ANY_PEAK = "Phase15AnyPeak"      # Canonical with every threshold at 0


def _median_ms(fn, items) -> tuple:
    """(median ms of ``fn`` over ``items`` on the host's clock, results)."""
    out, times = [], []
    for x in items:
        t0 = time.perf_counter()
        out.append(fn(x))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def image_files_and_tools(model, config, device, smi, n_params: int) -> dict:
    """Phase 15: (a) ``make_synthetic_coco``'s set of 8 512² frames written
    with ``utils/imageio`` and read back, equal to the in-memory frames bit
    for bit (ms a frame each way; whether cv2 imports here); (b)
    ``apps.evaluate.main`` on that directory with the phase-3 weights as a
    ``.pth``: its detections equal ``evaluate_frames`` on the in-memory
    frames (deterministic cuDNN), ``nms`` launched once a frame; (c)
    ``tools.eval_tta_split`` at scales (0.5, 1, 1.5) through its CLI and
    timed on the frames beside the fused TTA (``evaluate_frames(
    scale_search=)``): both APs, both ms a frame, the two maps' largest
    difference as a share of the fused maps' span on one frame; (d)
    ``visual.draw_net`` (the parameter count of phase 3), ``visual.
    line_integral`` on the card and ``visual.heatmap_vis`` through
    ``imageio``. (b) and (c) run ``Canonical`` with its peak, limb and
    person thresholds at 0 (registered as ``ANY_PEAK`` for the CLIs): the
    random weights' maps find no one at the reference's thresholds, and the
    comparisons need detections."""
    import dataclasses
    import os
    import tempfile

    from improved_body_parts_tpu_torch import configs

    from improved_body_parts_tpu_torch.apps import evaluate
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.tools import eval_tta_split, make_synthetic_coco
    from improved_body_parts_tpu_torch.utils import imageio
    from improved_body_parts_tpu_torch.visual import draw_net, heatmap_vis, line_integral

    probe = subprocess.run([sys.executable, "-c", "import cv2; print(cv2.__version__)"],
                           capture_output=True, text=True, timeout=120)
    line = {"cv2": probe.stdout.strip() if probe.returncode == 0 else None}
    config = dataclasses.replace(config, infer=dataclasses.replace(
        config.infer, thre1=0.0, thre2=0.0, min_person_score=0.0,
        min_person_parts=1))
    configs.CONFIGS[ANY_PEAK] = config
    frames, gt = evaluate.synthetic_coco(N_FILES, size=512)
    with tempfile.TemporaryDirectory() as root:
        # (a) the PNG set, written and read back without cv2
        img_dir = os.path.join(root, "syn", "images")
        names = {im["id"]: im["file_name"] for im in gt["images"]}
        t0 = time.perf_counter()
        gt_json = make_synthetic_coco.write(os.path.join(root, "syn"), frames, gt)
        write_ms = (time.perf_counter() - t0) * 1e3 / N_FILES
        read_ms, back = _median_ms(
            lambda f: imageio.imread(os.path.join(img_dir, names[f[0]])), frames)
        for (image_id, want), got in zip(frames, back):
            if got.dtype != np.uint8 or not np.array_equal(got, want):
                raise AssertionError(f"PNG {names[image_id]} read back differs")
        n_bytes = sum(os.path.getsize(os.path.join(img_dir, n)) for n in names.values())
        # libpng's time on the same files and host, where cv2 imports (in a
        # child process: the port's process never imports cv2 here)
        cv2_ms = None
        if line["cv2"]:
            code = ("import cv2, statistics, sys, time\nts = []\n"
                    "for p in sys.argv[1:]:\n"
                    "    t0 = time.perf_counter()\n"
                    "    assert cv2.imread(p) is not None\n"
                    "    ts.append((time.perf_counter() - t0) * 1e3)\n"
                    "print(statistics.median(ts))")
            cv2_ms = float(subprocess.run(
                [sys.executable, "-c", code,
                 *(os.path.join(img_dir, names[i]) for i, _ in frames)],
                check=True, capture_output=True, text=True, timeout=120).stdout)
        print(f"image files: {N_FILES} 512² PNGs written by utils/imageio "
              f"({write_ms:.1f} ms a frame, {n_bytes / N_FILES / 1e3:.0f} kB each) "
              f"and read back equal to the in-memory frames bit for bit "
              f"(decode {read_ms:.1f} ms a frame, median; host CPU); cv2 "
              f"here: {line['cv2'] or 'does not import'} (PNG never goes "
              "through it; its cv2.imread of the same files: "
              f"{'%.2f ms a frame' % cv2_ms if cv2_ms is not None else 'not run'})",
              flush=True)
        line["png"] = dict(frames=N_FILES, equal=True, write_ms=write_ms,
                           decode_ms=read_ms, decode_ms_cv2=cv2_ms,
                           kb_each=n_bytes / N_FILES / 1e3)

        # (b) the evaluator's CLI on the files against the in-memory frames
        pth = os.path.join(root, "phase3.pth")
        torch.save({"weights": {k: v.cpu() for k, v in model.state_dict().items()}},
                   pth)
        pred = Predictor(model, config, device=device)
        results = os.path.join(root, "results")
        split_dir = os.path.join(root, "split")
        torch.backends.cudnn.deterministic = True      # CLI = function, exactly
        try:
            want = evaluate.evaluate_frames(pred, frames).outputs
            kernels.reset_launch_counts()
            rc = evaluate.main(["--checkpoint", pth, "--config", ANY_PEAK,
                                "--image-dir", img_dir,
                                "--gt-json", gt_json, "--results-dir", results,
                                "--dump-name", "phase15", "--device", str(device)])
            torch.cuda.synchronize()
            nms_launches = kernels.nms.launches
            # (c)'s CLI, on the files, and its function on the frames
            split_rc = eval_tta_split.main([
                "--checkpoint", pth, "--config", ANY_PEAK, "--image-dir", img_dir,
                "--gt-json", gt_json, "--scale-search", *map(str, SPLIT_SCALES), "--results-dir",
                split_dir, "--device", str(device)])
            split_want = eval_tta_split.evaluate_split(
                pred, frames, SPLIT_SCALES, log=lambda s: None).outputs
        finally:
            torch.backends.cudnn.deterministic = False
        with open(os.path.join(results, "val2017_phase15_results.json")) as f:
            got = json.load(f)
        if rc != 0 or got != want or not got:
            raise AssertionError(f"apps.evaluate.main on the PNGs: rc {rc}, "
                                 f"{len(got)} detections against {len(want)} "
                                 "in memory, none, or they differ")
        if nms_launches != N_FILES:
            raise AssertionError(f"apps.evaluate.main launched nms {nms_launches} "
                                 f"times for {N_FILES} frames")
        print(f"apps.evaluate.main on the PNG directory: {len(got)} detections, "
              f"equal to evaluate_frames on the in-memory frames; nms launches "
              f"{nms_launches}", flush=True)
        line["evaluate_main"] = dict(detections=len(got), equal=True,
                                     nms_launches=nms_launches)

        # (c) the split TTA (the reference's host scale loop) against the fused
        with open(os.path.join(split_dir, "val2017_tta_split_results.json")) as f:
            split_cli = json.load(f)
        if split_rc != 0 or split_cli != split_want or not split_cli:
            raise AssertionError(f"tools.eval_tta_split's CLI on the PNGs (rc "
                                 f"{split_rc}) and its function on the frames "
                                 "disagree, or found no one")
        ids = [i for i, _ in frames]
        runs = {}
        for arm in ("fused", "split", "split", "fused"):    # in turns, warm
            if arm == "fused":
                run = evaluate.evaluate_frames(pred, frames, scale_search=SPLIT_SCALES)
            else:
                run = eval_tta_split.evaluate_split(pred, frames, SPLIT_SCALES,
                                                    log=lambda s: None)
            torch.cuda.synchronize()
            runs.setdefault(arm, []).append(run)
        ap = {arm: float(evaluate.score(gt, rs[-1].outputs, ids,
                                        print_fn=lambda *a: None)[0])
              for arm, rs in runs.items()}
        ms = {arm: min(r.seconds for r in rs) * 1e3 / N_FILES
              for arm, rs in runs.items()}
        img = frames[0][1]
        factors = evaluate.image_scales(SPLIT_SCALES, config.infer.boxsize,
                                        img.shape[0], 4)
        split_maps, _ = eval_tta_split.split_tta_maps(pred, img, factors)
        with torch.inference_mode():
            fused_maps = pred._maps(pred._pad(img)[0][None], scales=factors)[0]
        span = float(fused_maps.max() - fused_maps.min())
        gap = float((split_maps - fused_maps.float()).abs().max()) / span
        if not (np.isfinite(gap) and span > 0):
            raise AssertionError(f"split against fused maps: gap {gap}, span {span}")
        print(f"eval_tta_split at scales {SPLIT_SCALES}: AP {ap['split']:.4f} "
              f"(fused TTA {ap['fused']:.4f}; random weights); "
              f"{ms['split']:.1f} ms a frame against {ms['fused']:.1f} for the "
              f"fused TTA (ratio {ms['split'] / ms['fused']:.3f}); maps of frame "
              f"0 differ by at most {gap:.3e} of their span ({smi})", flush=True)
        line["tta_split"] = dict(scales=SPLIT_SCALES, ap_split=ap["split"],
                                 ap_fused=ap["fused"], ms_split=ms["split"],
                                 ms_fused=ms["fused"],
                                 ratio=ms["split"] / ms["fused"],
                                 map_gap_of_span=gap,
                                 detections=len(runs["split"][-1].outputs))
        del pred

        # (d) the visual scripts
        stats = draw_net.describe(config.model, device)
        if stats["params"] != n_params:
            raise AssertionError(f"draw_net counts {stats['params']} parameters, "
                                 f"phase 3 {n_params}")
        samples = line_integral.samples(device)
        means = {k: float(v.mean()) for k, v in samples.items()}
        if not means["true limb"] > 0.9 > 0.2 > means["wrong pairing"]:
            raise AssertionError(f"line_integral means {means}")
        vis = os.path.join(root, "heatmap_vis.png")
        heatmap_vis.main(["--out", vis])
        if imageio.imread(vis).shape != (512, 1536, 3):
            raise AssertionError("heatmap_vis wrote a malformed PNG")
        print(f"visual: draw_net {stats['params']:,} parameters (= phase 3), "
              f"{stats['flops'] / 1e9:.1f} GFLOPs a 128² frame; line_integral on "
              f"the card: true limb {means['true limb']:.3f}, wrong pairing "
              f"{means['wrong pairing']:.3f}; heatmap_vis written", flush=True)
        line["visual"] = dict(draw_net_params=stats["params"],
                              draw_net_gflops_128=stats["flops"] / 1e9,
                              line_integral=means, heatmap_vis=True)
    del configs.CONFIGS[ANY_PEAK]
    torch.cuda.empty_cache()
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.infer.predict import Predictor, unpack_results
    from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    from improved_body_parts_tpu_torch.ops import build, kernels, peaks
    from improved_body_parts_tpu_torch.utils.device import require_cuda

    # -- 0: the card ---------------------------------------------------------
    phase("0 device")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = require_cuda()
    kind = torch.cuda.get_device_name(0)

    # -- 1: build ------------------------------------------------------------
    phase("1 build")
    t0 = time.perf_counter()
    build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({build.build_info['path']})", flush=True)
    for line in build.build_info["log"].splitlines():
        if any(t in line for t in ("registers", "Compiling entry", "spill")):
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    # -- 2: kernels against their plain versions -------------------------------
    phase("2 kernels vs plain: (144, 128, 128); fused_peaks' edge grid at "
          f"{EDGE_SHAPES}")
    kernel_rows = check_kernels(kernels, peaks, device, smi)

    # -- 3: the model at full Canonical width -----------------------------------
    phase("3 model, Canonical width")
    config = get_config("Canonical")
    g = torch.Generator().manual_seed(SEED)
    model_cpu = PoseNet(config.model, compute_dtype=torch.bfloat16, generator=g)
    fan_in_init(model_cpu, g)
    model_cpu.eval()
    n_params = sum(p.numel() for p in model_cpu.parameters())
    model = copy.deepcopy(model_cpu).to(device, memory_format=torch.channels_last)
    print(f"PoseNet nstack {config.model.nstack} inp_dim {config.model.inp_dim} "
          f"increase {config.model.increase}: {n_params / 1e6:.1f}M parameters",
          flush=True)
    ds = SyntheticDataset(config, length=BATCH, seed=SEED, image_size=512)
    samples = [ds[i] for i in range(BATCH)]
    frames = np.stack([(s[0] * 255).astype(np.uint8) for s in samples])
    gt_maps = np.stack([s[2] for s in samples]).astype(np.float32)

    pred = Predictor(model, config, device=device)
    imgs = torch.from_numpy(frames).to(device).float() / 255.0
    with torch.inference_mode():
        avg = pred._flip_avg_maps(imgs)            # 8 frames + their flips
        torch.cuda.synchronize()
        if avg.shape != (BATCH, 128, 128, 50) or not torch.isfinite(avg).all():
            raise AssertionError(f"bf16 forward: shape {tuple(avg.shape)} or "
                                 "non-finite values")
        net_ms = device_ms(lambda: pred._flip_avg_maps(imgs), runs=5)
    print(f"bf16 channels_last forward of {BATCH} x 512^2 + flips: finite, "
          f"|max| {avg.abs().max().item():.3f}; {net_ms:.1f} ms per batch "
          f"(network-only {BATCH / net_ms * 1e3:.1f} frames/s, {smi})",
          flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model.compute_dtype = model_cpu.compute_dtype = torch.float32
    x = torch.from_numpy(frames[:1, :128, :128]).float() / 255.0
    with torch.inference_mode():
        want = model_cpu(x)
        got = model(x.to(device))
    scale = max(w.abs().max().item() for st in want for w in st)
    err = max((g_.cpu() - w).abs().max().item()
              for gs, ws in zip(got, want) for g_, w in zip(gs, ws))
    tol = 1e-3 * scale
    print(f"fp32 forward of 1 x 128^2, card vs CPU at every stack x scale: "
          f"max abs err {err:.3e} (outputs up to {scale:.3f}; tolerance "
          f"1e-3 x that = {tol:.3e}: summation order differs)", flush=True)
    if not err <= tol:
        raise AssertionError("fp32 forward on the card disagrees with the CPU")
    model.compute_dtype = model_cpu.compute_dtype = torch.bfloat16

    # -- 4: post-processing on GT-rendered scenes ----------------------------------
    phase("4 post-processing, 8 GT scenes at 512^2")
    P = config.infer.max_peaks
    hs = np.full((BATCH,), 512.0, np.float32)
    chws = np.tile(np.float32([512.0, 512.0]), (BATCH, 1))
    chws[1] = [512.0, 384.0]
    host_args = [torch.from_numpy(a) for a in (gt_maps, hs, chws)]
    dev_args = [a.to(device) for a in host_args]
    posts = {}
    for fused, counter in ((False, kernels.nms), (True, kernels.fused_peaks)):
        kernels.reset_launch_counts()
        p_dev = Predictor(model, config, device=device, fused_peaks=fused)
        p_cpu = Predictor(model_cpu, config, device=CPU, fused_peaks=fused)
        posts[fused] = p_dev
        with torch.inference_mode():
            got = p_dev._postprocess(*dev_args)[0].cpu().numpy()
            want = p_cpu._postprocess(*host_args)[0].numpy()
        launches_per_batch = counter.launches
        kernel_rows[0 if counter is kernels.nms else 1][
            "launches_per_batch"] = launches_per_batch
        worst = compare_tables(got, want, P, unpack_results)
        people = 0
        for b in range(BATCH):
            peaks_np, conns_np = unpack_results(got[b], P)
            table, _ = p_dev._group(peaks_np, conns_np, use_cpp=True)
            people += len(table)
        if people == 0:
            raise AssertionError("C++ grouping found nobody in 8 GT scenes")
        if counter.launches == 0:
            raise AssertionError(f"{counter.__name__} was not launched")
        print(f"fused={fused}: tables equal to the CPU run (floats within "
              f"{worst:.2e}); {people} people in 8 scenes; "
              f"{counter.__name__} launches per batch {launches_per_batch}",
              flush=True)
    postprocess_times(posts, dev_args, smi)

    # a 1088x1920 photo through predict_skeletons with the fused kernel: its
    # 272x480 stride maps split each channel over a cluster of blocks
    photo = np.full((1088, 1920, 3), 128, np.uint8)
    for i in range(BATCH):
        r, c = divmod(i, 4)
        if r * 512 + 512 <= 1088:
            photo[r * 512:r * 512 + 512, c * 480:c * 480 + 480] = frames[i][:, :480]
    p_fused = Predictor(model, config, device=device, fused_peaks=True)
    kernels.reset_launch_counts()
    kps, _, aux = p_fused.predict_skeletons(photo, use_cpp=True)
    torch.cuda.synchronize()
    if kernels.fused_peaks.launches == 0 or aux["heat"].shape[:2] != (272, 480):
        raise AssertionError("the 1088x1920 frame did not take the fused kernel")
    print(f"fused=True on a 1088x1920 frame: predict_skeletons ran, stride maps "
          f"{tuple(aux['heat'].shape[:2])}, fused_peaks launches "
          f"{kernels.fused_peaks.launches}, {len(kps)} people (random weights)",
          flush=True)

    # -- 5: serve ---------------------------------------------------------------------
    phase(f"5 serve: PipelinedServer batch {BATCH} depth {DEPTH}, {N_REQUESTS} requests")
    requests = [frames[i % BATCH] if i % 2 == 0 else frames[i % BATCH][:384]
                for i in range(N_REQUESTS)]    # longer side 512: no resize
    servers = {}
    for fused in (False, True):
        p = Predictor(model, config, device=device, fused_peaks=fused)
        p.predict_batch(frames, use_cpp=True)          # warm-up (cuDNN plans)
        servers[fused] = p
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    launches_by_run = {}
    for fused, p in servers.items():
        serve = PipelinedServer(p, batch_size=BATCH, depth=DEPTH, use_cpp=True)
        try:
            t0 = time.perf_counter()
            futs = [serve.submit(im) for im in requests]
            results = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        finally:
            serve.close()
        if len(results) != N_REQUESTS or any(k.shape[1:] != (18, 3) for k, _ in results):
            raise AssertionError("serving returned malformed results")
        launches_by_run[fused] = (kernels.nms.launches, kernels.fused_peaks.launches)
        print(f"fused_peaks={fused}: {N_REQUESTS} requests answered in "
              f"{wall:.3f} s = {N_REQUESTS / wall:.2f} frames/s end to end "
              f"({smi}; random weights, C++ grouping inline)", flush=True)
    nms_a, fused_a = launches_by_run[False]
    if nms_a == 0 or fused_a != 0:
        raise AssertionError(f"default serving run launched nms {nms_a}, "
                             f"fused_peaks {fused_a}")
    if kernels.fused_peaks.launches == 0:
        raise AssertionError("fused serving run did not launch fused_peaks")
    for r in kernel_rows:
        r["launches"] = getattr(kernels, r["name"]).launches

    # -- 6: multi-scale and rotation TTA at Canonical width ---------------------
    phase(f"6 TTA, scales {TTA_SCALES}")
    tta_maps_and_serving(model, model_cpu, config, frames, requests, device, smi,
                         net_ms)

    # -- 7: the entry points ----------------------------------------------------------
    phase(f"7 apps: evaluator on {N_EVAL} synthetic frames, demo --synthetic")
    entry_points(model, config, device, smi)

    # -- 8: training ------------------------------------------------------------------
    phase(f"8 training, Canonical 512², batch {TRAIN_BATCH}")
    # the reference init that phases 8, 11 and 12 copy
    ref_init = PoseNet(config.model, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED)).to(
        device, memory_format=torch.channels_last)
    dense_profile = training(device, smi, ref_init)

    # -- 9: the model variants -----------------------------------------------------------
    phase("9 variants: FinalAttention and Independent served, AEPoseNet trained, "
          "tiny variants card vs CPU")
    variant_line = variants(frames, requests, device, smi)

    # -- 10: int8 ----------------------------------------------------------------------
    phase("10 int8: PTQ of Canonical, int8_conv vs plain, int8 serving")
    int8_rows, int8_line, qmodel = int8(model_cpu, config, frames, requests,
                                        device, smi, net_ms)
    kernel_rows += int8_rows
    print(json.dumps({"variants": variant_line, "int8": int8_line}), flush=True)

    # -- 11: the resident feed and the K-steps dispatch --------------------------------
    phase(f"11 resident feed and multi-step dispatch: Canonical 512², batch "
          f"{TRAIN_BATCH}, K={DISPATCH_K} on a CUDA graph")
    resident_line, resident_store = resident_and_dispatch(device, smi, ref_init,
                                                          dense_profile)
    print(json.dumps({"resident_and_dispatch": resident_line}), flush=True)

    # -- 12: multi-GPU and the letterbox without cv2 ------------------------------------
    phase(f"12 multi-GPU: mesh serving, 2 gloo ranks and 1 NCCL rank on the card, "
          f"torchrun, the dry run; the letterbox without cv2")
    kernels.reset_launch_counts()
    mg_line = multi_gpu(model, config, frames, requests, device, smi,
                        resident_line[f"resident_k{DISPATCH_K}_graph"]["step_ms"],
                        ref_init, resident_store)
    del ref_init
    print(json.dumps({"multi_gpu": mg_line}), flush=True)

    # -- 13: the measurement and evaluation entry points --------------------------------
    phase("13 measurement and evaluation entry points: apps.bench (bf16, fused, int8), "
          "apps.inference_speed, profile_postproc, stress_grouping, bench_train_step, "
          "export_quantized, eval_curve, e2e_trained_smoke")
    measure_line = measurement_entry_points(model, qmodel, config, device, smi)
    print(json.dumps({"measurement": measure_line}), flush=True)

    # -- 14: the spatial mesh axis ------------------------------------------------------
    phase("14 spatial: Canonical 512², global batch 2, 2 gloo ranks on the card as "
          "data 1 x spatial 2 (bands of rows, halo exchanges) against one process")
    spatial_line = spatial_axis(smi)
    print(json.dumps({"spatial": spatial_line}), flush=True)

    # -- 15: image files and the remaining tools ----------------------------------------
    phase(f"15 image files and the remaining tools: {N_FILES} PNGs through utils/imageio, "
          f"apps.evaluate.main on them, eval_tta_split at {SPLIT_SCALES} against the "
          "fused TTA, draw_net, line_integral, heatmap_vis")
    files_line = image_files_and_tools(model, config, device, smi, n_params)
    print(json.dumps({"image_io_and_tools": files_line}), flush=True)

    print(f"chip_smoke: all phases done at {time.perf_counter() - _START:.1f} s",
          file=sys.stderr, flush=True)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
