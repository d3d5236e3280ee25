"""Data-parallel training and sharded serving across the visible cards,
each held against one process on one card, at ``Canonical`` width.

    python -m improved_body_parts_tpu_torch.tools.multi_card [agreement scaling spatial dryrun serving]

With N cards visible it runs (all five parts unless some are named):

  * scaling (N > 1): the resident step at K = 4 on the CUDA graph, 8
    samples a card, on N ranks against 1 (ms a step between CUDA events,
    images/s, the share of N times one card's rate);
  * agreement: N NCCL ranks, a card each, the resident store (64 synthetic
    records at 512²) sharded over them, 2 samples a rank, 4 bf16
    train-mode steps and 4 fp32 frozen-BN steps from the reference init,
    against one process taking the global batch on one card with the same
    plans (the loss of each step; the fp32 parameters after the last);
  * spatial (N even): the image height sharded over cards, N NCCL ranks
    as data N/2 × spatial 2 (``make_mesh(spatial=2)``: each rank its band
    of the rows, halos exchanged around every conv) against N ranks as
    data N, the same global batch (2 a card) of the compact-u8 feed at
    512²: 2 fp32 frozen-BN steps (the parameters' agreement) and 2 bf16
    train-mode steps (losses), ms a step (eager), peak GiB a rank and the
    halo exchanges a step. With one card: 2 gloo ranks sharing it as data
    1 × spatial 2 against one process (``chip_smoke.py`` phase 14);
  * the dry run (``tools/dryrun_multichip.py``) over the N cards (data ×
    spatial for an even N of 4 or more);
  * serving: ``PipelinedServer(mesh=make_mesh())`` over the N cards (8
    frames a card a batch) against one card (batch 8), and the mesh's fp32
    packed buffers against the unsharded predictor on each card's frames.

With one card the agreement runs two gloo ranks sharing it (what
``chip_smoke.py`` phase 12 (b) runs). Prints one JSON line last; exits 1
on any failure (a rank that fails or outlasts its time limit included:
every rank is killed with SIGKILL).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

SEED = 0
RECORDS = 64           # the resident store of chip_smoke.py phase 11
STEPS = 4              # the steps compared across processes
K = 4                  # steps a dispatch on the graph
FROZEN_TOL = 1e-5      # fp32 frozen BN, N ranks vs one process: of the move
SPATIAL_STEPS = 2      # the spatial steps compared, each BN mode
BF16_LOSS_TOL = 0.05   # bf16 train mode, bands vs whole images: relative


def _kill_tree(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_tree(cmd, timeout: float, what: str) -> str:
    """Run ``cmd`` in a session of its own; its output, or raise on a
    non-zero exit or the time limit (then every process of the session is
    killed)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        _kill_tree(proc)
        proc.communicate()
        raise AssertionError(f"{what}: still running after {timeout} s, killed")
    finally:
        _kill_tree(proc)
    if proc.returncode != 0:
        print(out[-6000:], flush=True)
        raise AssertionError(f"{what}: exit code {proc.returncode}")
    return out


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.splitlines()[0]


def setup(device):
    """Canonical, and its reference init from SEED on ``device`` (bf16
    convs, channels_last)."""
    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    config = get_config("Canonical")
    g = torch.Generator().manual_seed(SEED)
    init = PoseNet(config.model, compute_dtype=torch.bfloat16, generator=g).to(
        device, memory_format=torch.channels_last)
    return config, init


def build_store(config):
    from improved_body_parts_tpu_torch.data.resident import build_store as build
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    return build(SyntheticDataset(config, length=RECORDS, image_size=config.height))


def make_plans(store_h, config, global_batch: int, steps: int, rank: int,
               world: int, shards: int):
    from improved_body_parts_tpu_torch.data.resident import ResidentFeed
    return list(ResidentFeed(store_h, config, augment=True).plan_batches(
        global_batch, steps, seed=1, rank=rank, world=world, store_shards=shards))


def eager_steps(model, config, store, plans, freeze_bn: bool, mesh=None):
    """Resident steps from a fresh state of ``model``, one a plan: (losses,
    host ms a step after the first, the state)."""
    from improved_body_parts_tpu_torch import train_lib
    state = train_lib.create_train_state(model, config.train)
    step = train_lib.make_resident_train_step(model, config, freeze_bn=freeze_bn,
                                              mesh=mesh)
    dev = next(model.parameters()).device
    losses = []
    for k, p in enumerate(plans):
        if k == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(state, store, *(torch.from_numpy(a).to(dev) for a in p),
                           config.train.learning_rate)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(plans) - 1) * 1e3
    return torch.stack(losses).float().cpu(), ms, state


def graph_steps(model, config, store, plans, mesh):
    """Train-mode resident steps K a dispatch on the CUDA graph: the first
    chunk captures, the rest are timed between CUDA events. (losses, ms a
    step)."""
    from improved_body_parts_tpu_torch import train_lib
    dev = next(model.parameters()).device
    state = train_lib.create_train_state(model, config.train)
    multi = train_lib.make_multi_resident_train_step(model, config, mesh=mesh)
    stacked = [torch.from_numpy(np.stack([p[i] for p in plans])).to(dev)
               for i in range(3)]
    lrs = torch.full((len(plans),), config.train.learning_rate, device=dev)
    losses = [multi(state, store, *[x[:K] for x in stacked], lrs[:K])["loss"]]
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for lo in range(K, len(plans), K):
        losses.append(multi(state, store, *[x[lo:lo + K] for x in stacked],
                            lrs[lo:lo + K])["loss"])
    end.record()
    end.synchronize()
    if multi.graphed is None:
        raise AssertionError(f"the step was not captured: {multi.eager_reason}")
    return (torch.cat(losses).float().cpu(),
            start.elapsed_time(end) / (len(plans) - K))


def rank_main(rank: int, world: int, port: int, tmp: str, spec: dict) -> None:
    """One rank: joins the group, runs ``spec["modes"]`` on its slice, and
    writes ``rank<r>.pt`` (losses and ms of each mode; rank 0 also the fp32
    parameters after the frozen-BN steps)."""
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh_lib.initialize_multihost(
        f"localhost:{port}", world, rank,
        device="cuda:0" if spec["share_card"] else "cuda",
        backend=spec["backend"], timeout_s=600)
    mesh = mesh_lib.make_mesh()
    with open(os.path.join(tmp, "store.pkl"), "rb") as f:
        store_h = pickle.load(f)
    config, init = setup(device)
    store = store_h.device_arrays(device, shard=(rank, world))
    out = {}
    for mode in spec["modes"]:
        plans = make_plans(store_h, config, spec["batch"] * world, spec["steps"],
                           rank, world, world)
        model = copy.deepcopy(init)
        # deterministic cuDNN where the ranks are compared with one process
        torch.backends.cudnn.deterministic = mode != "bf16_graph"
        if mode == "bf16_graph":
            losses, ms = graph_steps(model, config, store, plans, mesh)
        else:
            frozen = mode == "fp32_frozen"
            if frozen:
                model.compute_dtype = torch.float32
            losses, ms, state = eager_steps(model, config, store, plans, frozen, mesh)
            if frozen and rank == 0:
                torch.save({k: v.detach().cpu() for k, v in
                            state.model.named_parameters()},
                           os.path.join(tmp, "params.pt"))
            del state
        out[mode] = dict(losses=losses, ms=ms)
        del model
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def spatial_batches(config, global_batch: int, steps: int) -> list:
    """Global batches of the compact-u8 feed (``SyntheticDataset.
    get_compact``, deterministic by index): (imgs uint8, mask, joints,
    mask_all) numpy, float32 but the images."""
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(config, length=global_batch * steps, seed=SEED,
                          image_size=config.height)
    out = []
    for k in range(steps):
        samples = [ds.get_compact(k * global_batch + i, image_u8=True)
                   for i in range(global_batch)]
        out.append((torch.stack([x[0] for x in samples]).numpy(),
                    torch.stack([x[1] for x in samples]).float().numpy(),
                    torch.stack([x[2][0] for x in samples]).numpy(),
                    torch.stack([x[2][1] for x in samples]).float().numpy()))
    return out


def spatial_steps(model, config, batches, frozen: bool, mesh=None) -> dict:
    """Compact-u8 steps from a fresh state of ``model``, one a batch, on
    this process's share of each global batch (its data slice of a mesh,
    and its band of the rows with a spatial axis; all of it without a
    mesh). Returns the losses, ms a step after the first (CUDA events),
    the halo exchanges a step, the peak allocated GiB and the state."""
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    from improved_body_parts_tpu_torch.parallel import spatial as sp
    dev = next(model.parameters()).device
    staged = []
    for imgs, mask, joints, mask_all in batches:
        if mesh is None:
            imgs, mask, joints, mask_all = (torch.from_numpy(a).to(dev) for a in
                                            (imgs, mask, joints, mask_all))
        else:
            imgs, mask = mesh_lib.shard_batch(mesh, (imgs, mask),
                                              shard_spatial=mesh.spatial > 1)
            joints, mask_all = mesh_lib.shard_batch(mesh, (joints, mask_all))
        staged.append((imgs, mask, (joints, mask_all)))
    state = train_lib.create_train_state(model, config.train)
    step = train_lib.make_train_step(model, config, freeze_bn=frozen,
                                     compact_gt=True, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for k, b in enumerate(staged):
        if k == 1:
            torch.cuda.synchronize(dev)
            sp.reset_counts()
            start.record()
        losses.append(step(state, *b, config.train.learning_rate)["loss"])
    end.record()
    end.synchronize()
    n = len(staged) - 1
    return dict(losses=torch.stack(losses).float().cpu(),
                ms=start.elapsed_time(end) / n, halos=sp.counts["halo"] / n,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                state=state)


def spatial_modes(init, config, batches, mesh=None) -> dict:
    """SPATIAL_STEPS fp32 frozen-BN and bf16 train-mode steps
    (``spatial_steps``) from copies of ``init``: {mode: their results}, and
    ``params``: the fp32 parameters after the frozen steps, on the CPU."""
    out = {}
    for mode in ("fp32_frozen", "bf16_train"):
        model = copy.deepcopy(init)
        frozen = mode == "fp32_frozen"
        # deterministic cuDNN where the bands are compared bit-close
        torch.backends.cudnn.deterministic = frozen
        if frozen:
            model.compute_dtype = torch.float32
        res = spatial_steps(model, config, batches, frozen, mesh)
        state = res.pop("state")
        if frozen:
            out["params"] = {k: v.detach().cpu() for k, v in
                             state.model.named_parameters()}
        out[mode] = res
        del model, state
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def spatial_rank_main(rank: int, world: int, port: int, tmp: str,
                      spec: dict) -> None:
    """One rank of the spatial part: joins the group, lays the mesh out
    with ``spec["spatial"]``, takes SPATIAL_STEPS fp32 frozen-BN and bf16
    train-mode steps of the compact-u8 feed and writes ``rank<r>.pt``
    (rank 0 also the fp32 parameters)."""
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh_lib.initialize_multihost(
        f"localhost:{port}", world, rank,
        device="cuda:0" if spec["share_card"] else "cuda",
        backend=spec["backend"], timeout_s=600)
    mesh = mesh_lib.make_mesh(spatial=spec["spatial"])
    config, init = setup(device)
    out = spatial_modes(init, config, spatial_batches(
        config, spec["global_batch"], SPATIAL_STEPS), mesh)
    params = out.pop("params")
    if rank == 0:
        torch.save(params, os.path.join(tmp, "params.pt"))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh_lib.shutdown(mesh)


def _entry(rank, world, port, tmp, spec):
    try:
        (spatial_rank_main if "spatial" in spec else rank_main)(
            rank, world, port, tmp, spec)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)             # no rank carries on alone


def run_ranks(world: int, store_h, spec: dict, timeout: float = 900.0) -> list:
    """Spawn ``world`` ranks of ``rank_main``; every rank's output, or
    raise (every rank killed) when one fails or the time runs out."""
    from improved_body_parts_tpu_torch.tools.dryrun_multichip import free_port
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "store.pkl"), "wb") as f:
            pickle.dump(store_h, f)
        ctx = mp.start_processes(_entry, args=(world, free_port(), tmp, spec),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{world} ranks still running after "
                                         f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
        if os.path.exists(os.path.join(tmp, "params.pt")):
            outs[0]["params"] = torch.load(os.path.join(tmp, "params.pt"))
    return outs


def agreement(world: int, batch: int, share_card: bool, device, smi: str) -> dict:
    """``world`` ranks (NCCL a card each; gloo sharing cuda:0 with
    ``share_card``) at ``batch`` a rank against one process at the global
    batch on ``device``: STEPS bf16 train-mode and fp32 frozen-BN steps
    from one init and one set of plans."""
    backend = "gloo" if share_card else "nccl"
    torch.cuda.empty_cache()
    config, init = setup(device)
    store_h = build_store(config)
    t0 = time.perf_counter()
    outs = run_ranks(world, store_h, dict(
        backend=backend, share_card=share_card, batch=batch, steps=STEPS,
        modes=("bf16_train", "fp32_frozen")))
    ranks_s = time.perf_counter() - t0
    # one process: the same plans, their record indices made global
    glob = batch * world
    n_local = len(store_h) // world
    plans = [(p[0] + (np.arange(glob) // batch) * n_local, *p[1:])
             for p in make_plans(store_h, config, glob, STEPS, 0, 1, world)]
    store = store_h.device_arrays(device)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    line = {}
    for mode, frozen in (("bf16_train", False), ("fp32_frozen", True)):
        model = copy.deepcopy(init)
        if frozen:
            model.compute_dtype = torch.float32
        losses, ms, state = eager_steps(model, config, store, plans, frozen)
        a = outs[0][mode]["losses"]
        if not all(torch.equal(o[mode]["losses"], a) for o in outs):
            raise AssertionError(f"{mode}: the ranks' losses differ")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{mode}: non-finite loss on the ranks")
        rel = ((a - losses).abs() / losses.abs()).tolist()
        print(f"{mode}, {STEPS} steps, {world} {backend} ranks x {batch} (sharded "
              f"store) / one process x {glob}: losses "
              + "; ".join(f"{x:.6f} / {y:.6f}" for x, y in zip(a.tolist(),
                                                              losses.tolist()))
              + f"; relative differences {[f'{r:.2e}' for r in rel]}; "
              f"{outs[0][mode]['ms']:.1f} ms a step on the ranks (eager) against "
              f"{ms:.1f} ms in one process ({smi})", flush=True)
        line[mode] = dict(rank_losses=a.tolist(), one_process_losses=losses.tolist(),
                          rel_diff=rel, ranks_ms=outs[0][mode]["ms"],
                          one_process_ms=ms)
        if frozen:
            diff, move = _max_diff_and_move(outs[0]["params"], {
                k: p.detach().cpu() for k, p in state.model.named_parameters()}, init)
            print(f"fp32 frozen BN after {STEPS} steps: parameters of the {world} "
                  f"ranks against one process, largest difference {diff:.3e} "
                  f"against a largest move of {move:.3e} (tolerance {FROZEN_TOL} "
                  f"x the move); the ranks ran in {ranks_s:.1f} s, start-up "
                  f"included", flush=True)
            if not diff <= FROZEN_TOL * move:
                raise AssertionError(f"{world} ranks disagree with one process")
            line["fp32_frozen_params"] = dict(max_abs_diff=diff, max_move=move,
                                              tol_of_move=FROZEN_TOL)
        del model, state
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return line


def _max_diff_and_move(params: dict, want: dict, init) -> tuple:
    """Largest |params - want| and the largest move of ``want`` from
    ``init``'s parameters, over every parameter (CPU tensors)."""
    start = {k: v.detach().cpu() for k, v in init.named_parameters()}
    return (max(float((params[k] - want[k]).abs().max()) for k in want),
            max(float((want[k] - start[k]).abs().max()) for k in want))


def spatial(n: int, smi: str) -> dict:
    """The image height sharded over ranks (module docstring): n NCCL
    ranks as (n/2) × 2 against n as data only, or, on one card, 2 gloo
    ranks sharing it as 1 × 2 against one process."""
    share = n == 1
    world = 2 if share else n
    if world % 2:
        raise ValueError(f"a spatial axis of 2 on {world} ranks")
    backend = "gloo" if share else "nccl"
    glob = 2 * n
    spec = dict(backend=backend, share_card=share, global_batch=glob)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = run_ranks(world, None, dict(spec, spatial=2))
    ranks_s = time.perf_counter() - t0
    device = torch.device("cuda", 0)
    config, init = setup(device)
    if share:
        what = "one process"
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = spatial_modes(init, config,
                            spatial_batches(config, glob, SPATIAL_STEPS))
    else:
        what = f"{n} ranks as data {n}"
        ref = run_ranks(world, None, dict(spec, spatial=1))[0]
    layout = f"{world} {backend} ranks as data {world // 2} x spatial 2"
    line = dict(layout=layout, against=what, global_batch=glob, card=smi,
                ranks_seconds=ranks_s)
    for mode in ("fp32_frozen", "bf16_train"):
        a = outs[0][mode]["losses"]
        if not all(torch.equal(o[mode]["losses"], a) for o in outs):
            raise AssertionError(f"spatial {mode}: the ranks' losses differ")
        if not torch.isfinite(a).all():
            raise AssertionError(f"spatial {mode}: non-finite loss on the ranks")
        b = ref[mode]["losses"]
        rel = ((a - b).abs() / b.abs()).tolist()
        peak = max(o[mode]["peak_gib"] for o in outs)
        print(f"spatial {mode}, {SPATIAL_STEPS} steps, {layout}, global batch "
              f"{glob} at {config.height}²: losses "
              + "; ".join(f"{x:.6f} / {y:.6f}" for x, y in zip(a.tolist(), b.tolist()))
              + f" against {what}; relative differences "
              f"{[f'{r:.2e}' for r in rel]}; {outs[0][mode]['ms']:.1f} ms a step "
              f"on the bands (eager) against {ref[mode]['ms']:.1f} ms "
              f"({outs[0][mode]['ms'] / ref[mode]['ms']:.3f}x); peak "
              f"{peak:.2f} GiB a rank (against {ref[mode]['peak_gib']:.2f}); "
              f"{outs[0][mode]['halos']:.0f} halo exchanges a step, remat "
              f"recomputes included ({smi})", flush=True)
        line[mode] = dict(rank_losses=a.tolist(), reference_losses=b.tolist(),
                          rel_diff=rel, ms=outs[0][mode]["ms"],
                          reference_ms=ref[mode]["ms"], peak_gib=peak,
                          reference_peak_gib=ref[mode]["peak_gib"],
                          halos_a_step=outs[0][mode]["halos"])
        if mode == "bf16_train" and not max(rel) < BF16_LOSS_TOL:
            raise AssertionError(f"bf16 losses on bands off {what}'s by more "
                                 f"than {BF16_LOSS_TOL}")
    diff, move = _max_diff_and_move(outs[0]["params"], ref["params"], init)
    print(f"spatial fp32 frozen BN after {SPATIAL_STEPS} steps: parameters of "
          f"the bands against {what}, largest difference {diff:.3e} against a "
          f"largest move of {move:.3e} (tolerance {FROZEN_TOL} x the move); the "
          f"ranks ran in {ranks_s:.1f} s, start-up included", flush=True)
    line["fp32_frozen_params"] = dict(max_abs_diff=diff, max_move=move,
                                      tol_of_move=FROZEN_TOL)
    if not diff <= FROZEN_TOL * move:
        raise AssertionError(f"the bands disagree with {what}")
    return line


def scaling(n: int, smi: str) -> dict:
    """The resident step, K = 4 on the graph, 8 samples a card: n NCCL
    ranks against one."""
    from improved_body_parts_tpu_torch.configs import get_config
    store_h = build_store(get_config("Canonical"))
    spec = dict(backend="nccl", share_card=False, batch=8, steps=3 * K,
                modes=("bf16_graph",))
    one = run_ranks(1, store_h, spec)[0]["bf16_graph"]["ms"]
    many = run_ranks(n, store_h, spec)[0]["bf16_graph"]["ms"]
    rate1, rate_n = 8 / one * 1e3, 8 * n / many * 1e3
    print(f"resident step, K={K} on the graph, 8 samples a card: 1 card "
          f"{one:.1f} ms a step ({rate1:.1f} images/s); {n} cards {many:.1f} ms "
          f"a step ({rate_n:.1f} images/s), {rate_n / (n * rate1):.3f} of {n} x "
          f"one card ({smi})", flush=True)
    return dict(one_card_ms=one, cards=n, n_cards_ms=many, one_card_images_per_s=rate1,
                n_cards_images_per_s=rate_n, efficiency=rate_n / (n * rate1))


def serving(n: int, smi: str, requests: int = 64) -> dict:
    """``PipelinedServer(mesh=)`` over n cards (8 frames a card a batch)
    against one card (batch 8); the fp32 packed buffers of the mesh against
    the unsharded predictor on each card's frames."""
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.infer.serving import PipelinedServer
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", 0)
    config, model = setup(device)
    model.eval()
    mesh = make_mesh()
    ds = SyntheticDataset(config, length=8, seed=SEED, image_size=512)
    frames = np.stack([(ds[i][0] * 255).astype(np.uint8) for i in range(8)])
    batch = np.concatenate([frames] * n)
    hs = np.full((len(batch),), 512.0, np.float32)
    chws = np.tile(np.float32([512.0, 512.0]), (len(batch), 1))
    key = ((1.0,), (0.0,))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    pred = Predictor(model, config, device=device)
    got = pred._run_mesh(mesh, batch, hs, chws, *key)
    with torch.inference_mode():
        want = pred._run(frames, hs[:8], chws[:8], *key)[0].cpu().numpy()
    if not all(np.array_equal(got[i * 8:(i + 1) * 8], want) for i in range(n)):
        raise AssertionError("the mesh's fp32 packed buffers differ")
    torch.backends.cudnn.deterministic = False
    model.compute_dtype = torch.bfloat16
    pred = Predictor(model, config, device=device)
    line = dict(fp32_packed_equal=True)
    reqs = [frames[i % 8] for i in range(requests)]
    for what, kw, bs in (("one card", {}, 8), (f"mesh of {n}", {"mesh": mesh}, 8 * n)):
        pred.predict_batch(batch[:bs], use_cpp=True, **kw)            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        serve = PipelinedServer(pred, batch_size=bs, depth=2, use_cpp=True, **kw)
        try:
            t0 = time.perf_counter()
            res = [f.result(timeout=600) for f in [serve.submit(im) for im in reqs]]
            fps = len(reqs) / (time.perf_counter() - t0)
        finally:
            serve.close()
        if len(res) != len(reqs):
            raise AssertionError("serving lost requests")
        print(f"PipelinedServer({what}), batch {bs}, depth 2: {len(reqs)} requests "
              f"at {fps:.2f} frames/s; nms launches {kernels.nms.launches} ({smi})",
              flush=True)
        line[what] = dict(batch=bs, frames_per_s=fps, nms_launches=kernels.nms.launches)
    return line


PARTS = ("agreement", "scaling", "spatial", "dryrun", "serving")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parts", nargs="*", choices=PARTS, default=list(PARTS),
                        help="what to run (default: all)")
    parts = parser.parse_args(argv).parts
    if not torch.cuda.is_available():
        print("multi_card: no CUDA card", file=sys.stderr)
        return 2
    from improved_body_parts_tpu_torch.ops import build
    n = torch.cuda.device_count()
    smi = f"{card_line()}, {n} card(s)"
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.load()
    line = {"cards": n, "card": smi}
    if "scaling" in parts and n > 1:
        line["scaling"] = scaling(n, smi)
    if "agreement" in parts:
        line["agreement"] = agreement(max(n, 2), 2, n == 1,
                                      torch.device("cuda", 0), smi)
    if "spatial" in parts and (n == 1 or n % 2 == 0):
        line["spatial"] = spatial(n, smi)
    if "dryrun" in parts:
        t0 = time.perf_counter()
        out = run_tree([sys.executable, "-m",
                        "improved_body_parts_tpu_torch.tools.dryrun_multichip",
                        str(n)], 900, f"the dry run over {n} cards")
        print([ln for ln in out.splitlines() if "dryrun_multichip(" in ln][-1],
              flush=True)
        line["dryrun"] = dict(n=n, rc=0, seconds=time.perf_counter() - t0)
    if "serving" in parts:
        line["serving"] = serving(n, smi)
    print(json.dumps({"multi_card": line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
