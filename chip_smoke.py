#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``improved_body_parts_tpu_torch``) on
one NVIDIA GPU: builds the CUDA kernels from ``csrc/``, checks each against
its plain PyTorch version (``fused_peaks`` also on maps beyond one block's
shared memory), runs the full-width ``Canonical`` model, the
post-processing on GT-rendered scenes, the batched flip-TTA serving path
behind ``PipelinedServer``, multi-scale and rotation TTA (single image, fp32
against the CPU; served, bf16), and the port's evaluator and demo entry
points on in-memory synthetic frames (the card's machine has no cv2).

    python3 chip_smoke.py

Phases print on earlier lines; any failure raises and the exit code is not
0. Without a CUDA device it exits 2 before doing anything. The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launch count in the serving run, its error against the plain version
and both times. Weights are random, drawn from a seed. Imports no jax.
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
# maps beyond one block's shared memory: 256^2 stride maps (a 1024^2 frame)
# and 272x480 (a 1088x1920 frame)
LARGE_MAP_SHAPES = ((18, 256, 256), (18, 272, 480))


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median per-call time between two CUDA events, after 3 warm-up calls.
    A sleep kernel queued first keeps the card busy while the host enqueues
    the call, so launch latency is hidden wherever the host keeps ahead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
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


def large_maps(shape, device) -> torch.Tensor:
    """Random joint maps of ``shape`` with one saturated channel, one empty
    channel (every slot repeats cell (0, 0)) and -0/+0 ties."""
    k, h, w = shape
    g = torch.Generator().manual_seed(SEED + h)
    heat = torch.rand(shape, generator=g) * 0.6
    checker = (torch.arange(h)[:, None] + torch.arange(w)[None]) % 2 == 0
    heat[3] = torch.where(checker, heat[3] + 0.5, torch.zeros(()))
    heat[5] = 0.0
    heat[7] = torch.where(heat[7] < 0.3, torch.tensor(-0.0), heat[7])
    return heat.to(device)


def check_fused_large(kernels, device):
    """fused_peaks on maps beyond shared memory against its plain version,
    exact; returns (max_abs_err, [(shape, ms, plain_ms)])."""
    errs, times = [], []
    for shape in LARGE_MAP_SHAPES:
        heat = large_maps(shape, device)
        assert shape[1] * shape[2] * 4 > kernels.FUSED_PEAKS_SMEM_BYTES
        for fp in ("plus", "square"):
            got = kernels.fused_peaks(heat, 0.1, 32, fp)
            want = kernels.fused_peaks_plain(heat, 0.1, 32, fp)
            torch.cuda.synchronize()
            for name, a, b in zip(("scores", "yx", "n_raw", "patches"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"fused_peaks{shape}[{fp}] {name} differs")
            if not (int(got[2][3]) > 32 and int(got[2][5]) == 0):
                raise AssertionError("saturated/empty channels misbehaved")
            errs.append(max_abs_err(got, want))
        ms = device_ms(lambda: kernels.fused_peaks(heat, 0.1, 32, "plus"))
        plain_ms = device_ms(lambda: kernels.fused_peaks_plain(heat, 0.1, 32, "plus"))
        times.append((shape, ms, plain_ms))
        print(f"fused_peaks {shape} (global-scratch variant): exact; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMING_RUNS})",
              flush=True)
    return max(errs), times


def check_kernels(kernels, device):
    """Each kernel against its plain version at the main-path shape; exact.
    fused_peaks also on maps beyond shared memory."""
    heat = main_path_maps(device)
    plateau = torch.zeros((1, 8, 8), device=device)
    plateau[0, 3, 3] = plateau[0, 3, 4] = 0.7
    rows = []
    errs = []
    for fp in ("plus", "square"):
        for x in (heat, plateau):
            got = kernels.nms(x, 0.1, fp)
            want = kernels.nms_plain(x, 0.1, fp)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"nms[{fp}] differs from its plain version")
            errs.append(max_abs_err([got], [want]))
    rows.append(dict(
        name="nms", route="cuda", source="improved_body_parts_tpu_torch/csrc/nms.cu",
        replaces="improved_body_parts_tpu/ops/pallas_kernels.py:72",
        max_abs_err=max(errs),
        ms=device_ms(lambda: kernels.nms(heat, 0.1, "plus")),
        plain_ms=device_ms(lambda: kernels.nms_plain(heat, 0.1, "plus"))))

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
    large_err, _ = check_fused_large(kernels, device)
    rows.append(dict(
        name="fused_peaks", route="cuda",
        source="improved_body_parts_tpu_torch/csrc/fused_peaks.cu",
        replaces="improved_body_parts_tpu/ops/pallas_kernels.py:194",
        max_abs_err=max(errs + [large_err]),
        ms=device_ms(lambda: kernels.fused_peaks(heat, 0.1, 32, "plus")),
        plain_ms=device_ms(lambda: kernels.fused_peaks_plain(heat, 0.1, 32, "plus"))))
    for r in rows:
        print(f"{r['name']}: exact (max_abs_err {r['max_abs_err']}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              f"(median of {TIMING_RUNS}, (144, 128, 128) fp32)", flush=True)
    return rows


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
    from improved_body_parts_tpu.infer.serving import PipelinedServer
    from improved_body_parts_tpu_torch.infer.predict import Predictor
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from improved_body_parts_tpu.configs import get_config
    from improved_body_parts_tpu.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu.infer.serving import PipelinedServer
    from improved_body_parts_tpu_torch.infer.predict import Predictor, unpack_results
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    from improved_body_parts_tpu_torch.ops import build, kernels
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
        if "registers" in line or "Compiling entry" in line or "smem" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    # -- 2: kernels against their plain versions -------------------------------
    phase("2 kernels vs plain, (144, 128, 128) and fused_peaks beyond shared memory")
    kernel_rows = check_kernels(kernels, device)

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
    for fused, counter in ((False, kernels.nms), (True, kernels.fused_peaks)):
        kernels.reset_launch_counts()
        p_dev = Predictor(model, config, device=device, fused_peaks=fused)
        p_cpu = Predictor(model_cpu, config, device=CPU, fused_peaks=fused)
        with torch.inference_mode():
            got = p_dev._postprocess(*dev_args)[0].cpu().numpy()
            want = p_cpu._postprocess(*host_args)[0].numpy()
            post_ms = device_ms(lambda: p_dev._postprocess(*dev_args), runs=5)
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
              f"{counter.__name__} launches {counter.launches}; "
              f"post-processing {post_ms:.2f} ms per batch of {BATCH}",
              flush=True)

    # a 1088x1920 photo through predict_skeletons with the fused kernel: its
    # 272x480 stride maps exceed one block's shared memory
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

    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
