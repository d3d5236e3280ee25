"""Data-parallel training and sharded serving across the visible cards,
each held against one process on one card, at ``Canonical`` width.

    python -m improved_body_parts_tpu_torch.tools.multi_card [agreement scaling spatial dryrun serving large]

With N cards visible it runs (all five parts but large unless some are named):

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
    halo exchanges a step. Then the graph part on the same ranks:
    ``make_multi_train_step(shard_spatial=True)``, K = 4 steps as one
    dispatch on the CUDA graph against the same 4 steps eager (their host
    syncs counted by ``torch.cuda.set_sync_debug_mode("warn")``) from
    copies of one state, fp32 frozen BN and bf16 train mode, deterministic
    cuDNN: the stacked metrics and every parameter, momentum buffer, BN
    statistic and the step count bit for bit; and in bf16 train mode, ms a
    step on the graph and eagerly, host launch calls a step
    (``torch.profiler``), capture seconds, peak GiB a rank and halo
    exchanges a step (counted at the capture), beside data N's graph step
    on the same global batch. With
    one card: 2 gloo ranks sharing it as data 1 × spatial 2 against one
    process (``chip_smoke.py`` phase 14), and the reason their dispatch
    runs eagerly (gloo cannot be captured);
  * large (only when named; N ≥ 4): a step one card cannot hold.
    ``Canonical`` at 1024², batch 8 a data slice, bf16, train-mode BN, no
    remat: one process on one card takes one step (its out-of-memory
    error, or its peak; when it fits, 1024² at batch 12, then 1280² at
    batch 8, until one does not), then 4 NCCL ranks as data 2 × spatial 2
    take that step K = 4 a dispatch on the CUDA graph for 2 dispatches,
    the first held bit for bit against 4 eager steps: losses, ms a step,
    peak GiB a rank;
  * the dry run (``tools/dryrun_multichip.py``) over the N cards (data ×
    spatial for an even N of 4 or more);
  * serving: ``PipelinedServer(mesh=make_mesh())`` over the N cards (8
    frames a card a batch) against one card (batch 8), and the mesh's fp32
    packed buffers against the unsharded predictor on each card's frames.

With one card the agreement runs two gloo ranks sharing it (what
``chip_smoke.py`` phase 12 (b) runs); ``large`` needs four. Prints one
JSON line last; exits 1 on any failure (a rank that fails or outlasts its time limit included:
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
import warnings

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
TIMED_DISPATCHES = 2   # the graph part's timed dispatches (K steps each)
# the large part's sizes, tried in order on one card until one does not fit:
# (image size, batch a data slice)
LARGE_SIZES = ((1024, 8), (1024, 12), (1280, 8))


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


def setup(device, image_size: int = 0):
    """Canonical (at ``image_size``² when given), and its reference init
    from SEED on ``device`` (bf16 convs, channels_last)."""
    import dataclasses

    from improved_body_parts_tpu_torch.configs import get_config
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    config = get_config("Canonical")
    if image_size:
        config = dataclasses.replace(config, width=image_size, height=image_size)
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
    config, init = setup(device, spec.get("image_size", 0))
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
    if spec["backend"] == "gloo":
        from improved_body_parts_tpu_torch import train_lib
        out["dispatch_eager_reason"] = train_lib.make_multi_train_step(
            init, config, compact_gt=True, mesh=mesh,
            shard_spatial=mesh.spatial > 1).eager_reason
    else:
        out["graph"] = graph_part(init, config, spatial_batches(
            config, spec["global_batch"], K), mesh)
    if rank == 0:
        torch.save(params, os.path.join(tmp, "params.pt"))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh_lib.shutdown(mesh)


def staged_steps(mesh, batches) -> list:
    """This rank's share of each global batch on its card: (imgs, mask,
    joints, mask_all), the images and the mask its band of the rows on a
    spatial mesh, the joints and mask_all whole (its data slice)."""
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    out = []
    for imgs, mask, joints, mask_all in batches:
        imgs, mask = mesh_lib.shard_batch(mesh, (imgs, mask),
                                          shard_spatial=mesh.spatial > 1)
        out.append((imgs, mask, *mesh_lib.shard_batch(mesh, (joints, mask_all))))
    return out


def _chunk(staged, lo: int, hi: int) -> tuple:
    """Steps lo..hi of ``staged_steps`` stacked on a step axis, as
    ``make_multi_train_step`` takes them: (imgs, mask, (joints, mask_all))."""
    imgs, mask, joints, mask_all = (torch.stack([s[i] for s in staged[lo:hi]])
                                    for i in range(4))
    return imgs, mask, (joints, mask_all)


def graph_against_eager(init, config, staged, frozen: bool, mesh,
                        dispatches: int = 1) -> dict:
    """K steps of ``staged`` from a copy of ``init`` eagerly
    (``make_train_step``, under ``torch.cuda.set_sync_debug_mode("warn")``:
    the host syncs inside the steps are counted), and from
    another copy as one dispatch on the CUDA graph
    (``make_multi_train_step``), deterministic cuDNN, fp32 with ``frozen``
    BN or bf16 in train mode: whether the stacked metrics and every state
    tensor (``train_graph._state_tensors``) are equal bit for bit. Then
    ``dispatches - 1`` more dispatches on the graph, of the steps after
    the first K (ms a step between CUDA events). Peak GiB of each route,
    the graph's losses, its capture seconds."""
    import gc

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    from improved_body_parts_tpu_torch.train_graph import _state_tensors
    from improved_body_parts_tpu_torch.utils.profiling import cuda_timer
    dev = mesh.device
    banded = mesh.spatial > 1
    torch.backends.cudnn.deterministic = True
    lrs = torch.full((len(staged),), config.train.learning_rate, device=dev)

    def fresh():
        model = copy.deepcopy(init)
        if frozen:
            model.compute_dtype = torch.float32
        return model, train_lib.create_train_state(model, config.train)

    model, state = fresh()
    step = train_lib.make_train_step(model, config, freeze_bn=frozen,
                                     compact_gt=True, mesh=mesh,
                                     shard_spatial=banded)
    mesh_lib.warm(mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            mets = [step(state, s[0], s[1], (s[2], s[3]), lrs[k])
                    for k, s in enumerate(staged[:K])]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in syncs
             if "synchroniz" in str(w.message).lower()]
    want = {key: torch.stack([m[key] for m in mets]) for key in mets[0]}
    want_state = [t.detach().clone() for t in _state_tensors(state)]
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del model, state, step, mets
    gc.collect()
    torch.cuda.empty_cache()

    model, state = fresh()
    multi = train_lib.make_multi_train_step(model, config, freeze_bn=frozen,
                                            compact_gt=True, mesh=mesh,
                                            shard_spatial=banded)
    torch.cuda.reset_peak_memory_stats(dev)
    got = multi(state, *_chunk(staged, 0, K), lrs[:K])
    if multi.graphed is None:
        raise AssertionError(f"the step was not captured: {multi.eager_reason}")
    got_state = _state_tensors(state)
    differ = [i for i, (a, b) in enumerate(zip(got_state, want_state))
              if not torch.equal(a, b)]
    metrics_equal = all(torch.equal(got[key], want[key]) for key in want)
    largest = max((float((got_state[i].double() - want_state[i].double()).abs().max())
                   for i in differ), default=0.0)
    losses = [got["loss"]]
    ms = None
    if dispatches > 1:
        rest = [_chunk(staged, lo, lo + K) for lo in range(K, dispatches * K, K)]
        torch.cuda.synchronize(dev)
        with cuda_timer() as t:
            losses += [multi(state, *c, lrs[:K])["loss"] for c in rest]
        ms = t["elapsed"] * 1e3 / (len(rest) * K)
    out = dict(identical=metrics_equal and not differ, metrics_equal=metrics_equal,
               tensors_differ=len(differ), tensors=len(want_state),
               largest_difference=largest,
               losses=torch.cat(losses).float().cpu().tolist(),
               eager_losses=want["loss"].float().cpu().tolist(),
               graph_ms=ms, capture_seconds=multi.graphed.capture_seconds,
               eager_host_syncs=len(syncs), first_sync=syncs[0] if syncs else None,
               halos_a_step=multi.graphed.exchanges["halo"],
               eager_peak_gib=eager_peak,
               graph_peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    multi.close()
    del model, state, multi, got, got_state, want_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def graph_timing(init, config, staged, mesh, eager: bool) -> dict:
    """The bf16 train-mode step on ``staged`` (K steps), default cuDNN: K
    a dispatch on the CUDA graph (the first dispatch captures, then
    TIMED_DISPATCHES timed between CUDA events), the host's launch calls a
    step over one dispatch, the capture seconds, peak GiB and the halo
    exchanges a step (counted at the capture, and as the replays add
    them); with ``eager``, the same steps eagerly (one warm-up, K timed)
    and their launch calls."""
    import gc

    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.parallel import spatial as sp
    from improved_body_parts_tpu_torch.utils.profiling import (
        cuda_timer, launches_and_busy,
    )
    dev = mesh.device
    lrs = torch.full((K,), config.train.learning_rate, device=dev)
    chunk = _chunk(staged, 0, K)
    model = copy.deepcopy(init)
    state = train_lib.create_train_state(model, config.train)
    multi = train_lib.make_multi_train_step(model, config, compact_gt=True,
                                            mesh=mesh,
                                            shard_spatial=mesh.spatial > 1)
    torch.cuda.reset_peak_memory_stats(dev)
    multi(state, *chunk, lrs)
    sp.reset_counts()
    torch.cuda.synchronize(dev)
    with cuda_timer() as t:
        for _ in range(TIMED_DISPATCHES):
            multi(state, *chunk, lrs)
    out = dict(graph_ms=t["elapsed"] * 1e3 / (TIMED_DISPATCHES * K),
               halos_counted=sp.counts["halo"] / (TIMED_DISPATCHES * K),
               halos_captured=multi.graphed.exchanges["halo"],
               capture_seconds=multi.graphed.capture_seconds,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    out["graph_launches"], out["graph_launches_by"], out["graph_busy_ms"] = (
        launches_and_busy(lambda: multi(state, *chunk, lrs), K))
    multi.close()
    del multi
    gc.collect()
    torch.cuda.empty_cache()
    if eager:
        step = train_lib.make_train_step(model, config, compact_gt=True,
                                         mesh=mesh, shard_spatial=mesh.spatial > 1)
        run = lambda: [step(state, s[0], s[1], (s[2], s[3]), lrs[k])
                       for k, s in enumerate(staged[:K])]
        step(state, *staged[0][:2], staged[0][2:], lrs[0])
        torch.cuda.synchronize(dev)
        with cuda_timer() as t:
            run()
        out["eager_ms"] = t["elapsed"] * 1e3 / K
        out["eager_launches"], _, out["eager_busy_ms"] = launches_and_busy(run, K)
        del step
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_part(init, config, batches, mesh) -> dict:
    """The graph part of ``spatial`` on this rank (module docstring): on a
    spatial mesh, K steps of ``batches`` on the graph against eager steps
    bit for bit in both BN modes, then the bf16 timings, graph and eager;
    on a data mesh the graph timing alone."""
    staged = staged_steps(mesh, batches)
    out = {}
    if mesh.spatial > 1:
        for mode in ("fp32_frozen", "bf16_train"):
            out[mode] = graph_against_eager(init, config, staged,
                                            mode == "fp32_frozen", mesh)
    out["timing"] = graph_timing(init, config, staged, mesh,
                                 eager=mesh.spatial > 1)
    return out


def _entry(rank, world, port, tmp, spec):
    try:
        (large_rank_main if "large" in spec else
         spatial_rank_main if "spatial" in spec else rank_main)(
            rank, world, port, tmp, spec)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)             # no rank carries on alone


def run_ranks(world: int, store_h, spec: dict, timeout: float = 900.0,
              port: int = 0) -> list:
    """Spawn ``world`` ranks of ``rank_main`` (their rendezvous on
    ``port``, a free one if 0); every rank's output, or raise (every rank
    killed) when one fails or the time runs out."""
    from improved_body_parts_tpu_torch.tools.dryrun_multichip import free_port
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "store.pkl"), "wb") as f:
            pickle.dump(store_h, f)
        ctx = mp.start_processes(_entry, args=(world, port or free_port(), tmp, spec),
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


def agreement(world: int, batch: int, share_card: bool, device, smi: str,
              image_size: int = 0, steps: int = STEPS, port: int = 0) -> dict:
    """``world`` ranks (NCCL a card each; gloo sharing cuda:0 with
    ``share_card``) at ``batch`` a rank against one process at the global
    batch on ``device``: ``steps`` bf16 train-mode and fp32 frozen-BN steps
    from one init and one set of plans, at ``image_size``² (Canonical's
    512² when 0), the ranks' rendezvous on ``port`` (a free one if 0)."""
    backend = "gloo" if share_card else "nccl"
    torch.cuda.empty_cache()
    config, init = setup(device, image_size)
    store_h = build_store(config)
    t0 = time.perf_counter()
    outs = run_ranks(world, store_h, dict(
        backend=backend, share_card=share_card, batch=batch, steps=steps,
        modes=("bf16_train", "fp32_frozen"), image_size=image_size), port=port)
    ranks_s = time.perf_counter() - t0
    # one process: the same plans, their record indices made global
    glob = batch * world
    n_local = len(store_h) // world
    plans = [(p[0] + (np.arange(glob) // batch) * n_local, *p[1:])
             for p in make_plans(store_h, config, glob, steps, 0, 1, world)]
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
        print(f"{mode}, {steps} steps, {world} {backend} ranks x {batch} (sharded "
              f"store) / one process x {glob} at {config.height}²: losses "
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
            print(f"fp32 frozen BN after {steps} steps: parameters of the {world} "
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
    if share:
        reason = outs[0]["dispatch_eager_reason"]
        print(f"spatial K-steps dispatch on {layout}: eager ({reason})", flush=True)
        line["dispatch_eager_reason"] = reason
        if not reason or "gloo" not in reason:
            raise AssertionError(f"a gloo dispatch gives the reason {reason!r}")
    else:
        line["graph"] = spatial_graph_report(outs, ref, layout, n, smi)
    return line


def spatial_graph_report(outs, ref, layout: str, n: int, smi: str) -> dict:
    """Print and check the graph part of ``spatial`` (every rank's)."""
    line = {}
    for mode in ("fp32_frozen", "bf16_train"):
        res = [o["graph"][mode] for o in outs]
        r = res[0]
        print(f"spatial graph, {mode}, {layout}: K={K} steps as one dispatch on "
              f"the CUDA graph against {K} eager steps from copies of one state "
              f"(deterministic cuDNN): "
              f"{'bit for bit' if all(x['identical'] for x in res) else 'NOT EQUAL'}"
              f" on every rank (tensors differing by rank "
              f"{[x['tensors_differ'] for x in res]} of {r['tensors']}, largest "
              f"{max(x['largest_difference'] for x in res):.3e}; stacked metrics "
              f"equal {[x['metrics_equal'] for x in res]}); host syncs in the "
              f"eager steps {[x['eager_host_syncs'] for x in res]}; losses "
              f"{[round(v, 6) for v in r['losses']]}; capture "
              f"{r['capture_seconds']:.2f} s ({smi})", flush=True)
        line[mode] = dict(identical=[x["identical"] for x in res],
                          tensors_differ=[x["tensors_differ"] for x in res],
                          tensors=r["tensors"],
                          largest_difference=max(x["largest_difference"] for x in res),
                          losses=r["losses"], capture_seconds=r["capture_seconds"],
                          eager_host_syncs=[x["eager_host_syncs"] for x in res],
                          first_sync=r["first_sync"])
        if not all(x["identical"] for x in res):
            raise AssertionError(f"spatial {mode}: the graph differs from eager steps")
    t = outs[0]["graph"]["timing"]
    d = ref["graph"]["timing"]
    peak = max(o["graph"]["timing"]["peak_gib"] for o in outs)
    print(f"spatial graph, bf16 train mode, {layout}, K={K}: {t['graph_ms']:.1f} ms "
          f"a step on the graph, {t['eager_ms']:.1f} eagerly "
          f"(x{t['eager_ms'] / t['graph_ms']:.3f}); data {n}'s graph step "
          f"{d['graph_ms']:.1f} ms (bands x{t['graph_ms'] / d['graph_ms']:.3f}); "
          f"host launch calls a step {t['graph_launches']:.1f} on the graph "
          f"({', '.join(f'{k} {v:g}' for k, v in sorted(t['graph_launches_by'].items()))})"
          f", {t['eager_launches']:.0f} eagerly, {d['graph_launches']:.1f} for "
          f"data {n}'s graph; busy {t['graph_busy_ms']:.1f} ms a step on the graph; "
          f"capture {t['capture_seconds']:.2f} s (data {n}: "
          f"{d['capture_seconds']:.2f}); peak {peak:.2f} GiB a rank (data {n}: "
          f"{d['peak_gib']:.2f}); halo exchanges a step {t['halos_captured']} "
          f"captured, {t['halos_counted']:g} counted over the replays ({smi})",
          flush=True)
    line["timing"] = dict(t, peak_gib=peak, data_graph=d,
                          ratio_to_data=t["graph_ms"] / d["graph_ms"],
                          eager_over_graph=t["eager_ms"] / t["graph_ms"])
    if t["halos_counted"] != t["halos_captured"]:
        raise AssertionError("the replays' halo count is not the capture's")
    return line


def one_card_rank(tmp: str, image_size: int, batch: int) -> None:
    """One process, one card: one bf16 train-mode step of ``Canonical`` at
    ``image_size``² and ``batch`` (compact-u8, no remat); writes
    ``one_card.pt``: whether it fit, its peak allocated and reserved GiB,
    and the out-of-memory error's first line."""
    from improved_body_parts_tpu_torch import train_lib
    device = torch.device("cuda", 0)
    config, init = setup(device, image_size)
    imgs, mask, joints, mask_all = (torch.from_numpy(a).to(device) for a in
                                    spatial_batches(config, batch, 1)[0])
    state = train_lib.create_train_state(init, config.train)
    step = train_lib.make_train_step(init, config, compact_gt=True)
    out = dict(image_size=image_size, batch=batch)
    try:
        loss = step(state, imgs, mask, (joints, mask_all),
                    config.train.learning_rate)["loss"]
        out.update(fits=True, loss=float(loss))
    except torch.OutOfMemoryError as e:
        out.update(fits=False, error=str(e).splitlines()[0])
    out.update(peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
               reserved_gib=torch.cuda.max_memory_reserved(device) / 2 ** 30,
               card_gib=torch.cuda.get_device_properties(device).total_memory / 2 ** 30)
    torch.save(out, os.path.join(tmp, "one_card.pt"))


def _one_card_entry(tmp, image_size, batch):
    try:
        one_card_rank(tmp, image_size, batch)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def one_card(image_size: int, batch: int, timeout: float = 600.0) -> dict:
    """``one_card_rank`` in a process of its own (its memory is the card's
    alone): its result, or raise if it failed otherwise."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        p = ctx.Process(target=_one_card_entry, args=(tmp, image_size, batch))
        p.start()
        p.join(timeout)
        if p.is_alive():
            p.kill()
            raise AssertionError(f"one card at {image_size}²: still running "
                                 f"after {timeout} s")
        if p.exitcode != 0:
            raise AssertionError(f"one card at {image_size}²: exit code {p.exitcode}")
        return torch.load(os.path.join(tmp, "one_card.pt"))


def large_rank_main(rank: int, world: int, port: int, tmp: str,
                    spec: dict) -> None:
    """One rank of the large part: data world/2 × spatial 2 over NCCL,
    ``spec["image_size"]``² and ``spec["batch"]`` a data slice, bf16
    train mode; 2 dispatches of K steps on the graph, the first against
    K eager steps (``graph_against_eager``); writes ``rank<r>.pt``."""
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    device = mesh_lib.initialize_multihost(f"localhost:{port}", world, rank,
                                           device="cuda", backend="nccl",
                                           timeout_s=600)
    mesh = mesh_lib.make_mesh(spatial=2)
    config, init = setup(device, spec["image_size"])
    staged = staged_steps(mesh, spatial_batches(
        config, spec["batch"] * mesh.data_size, 2 * K))
    out = graph_against_eager(init, config, staged, False, mesh, dispatches=2)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh_lib.shutdown(mesh)


def large(n: int, smi: str) -> dict:
    """A step one card cannot hold (module docstring): one card's error or
    peak at each size of LARGE_SIZES until one does not fit, then that size
    on 4 NCCL ranks as data 2 × spatial 2, K = 4 a dispatch on the graph."""
    if n < 4:
        raise ValueError(f"the large part needs 4 cards, and {n} are visible")
    tried = []
    for size, batch in LARGE_SIZES:
        r = one_card(size, batch)
        print(f"one card, Canonical {size}², batch {batch}, bf16 train mode, no "
              f"remat, one step: "
              + (f"fits, peak {r['peak_gib']:.2f} GiB allocated"
                 if r["fits"] else f"out of memory ({r['error']})")
              + f"; peak allocated {r['peak_gib']:.2f} GiB, reserved "
              f"{r['reserved_gib']:.2f} GiB of {r['card_gib']:.2f} ({smi})", flush=True)
        tried.append(r)
        if not r["fits"]:
            break
    size, batch = tried[-1]["image_size"], tried[-1]["batch"]
    t0 = time.perf_counter()
    outs = run_ranks(4, None, dict(large=True, image_size=size, batch=batch))
    ranks_s = time.perf_counter() - t0
    r = outs[0]
    losses = torch.tensor(r["losses"])
    peak = max(max(o["eager_peak_gib"], o["graph_peak_gib"]) for o in outs)
    identical = all(o["identical"] for o in outs)
    print(f"4 NCCL ranks as data 2 x spatial 2, Canonical {size}², batch {batch} a "
          f"data slice (global {2 * batch}), bf16 train mode, no remat: "
          f"{len(r['losses'])} steps K={K} a dispatch on the CUDA graph, losses "
          f"{[round(v, 4) for v in r['losses']]}; the first dispatch against "
          f"{K} eager steps: {'bit for bit' if identical else 'NOT EQUAL'} "
          f"(tensors differing by rank {[o['tensors_differ'] for o in outs]}; "
          f"host syncs in the eager steps {[o['eager_host_syncs'] for o in outs]}); "
          f"{r['graph_ms']:.1f} ms a step on the graph (deterministic cuDNN); "
          f"peak {peak:.2f} GiB a rank (eager "
          f"{max(o['eager_peak_gib'] for o in outs):.2f}, graph "
          f"{max(o['graph_peak_gib'] for o in outs):.2f}); halo exchanges a step "
          f"{r['halos_a_step']}; capture {r['capture_seconds']:.2f} s; the ranks "
          f"ran in {ranks_s:.1f} s ({smi})", flush=True)
    if not torch.isfinite(losses).all() or len(losses) < 2 * K:
        raise AssertionError(f"large: {len(losses)} losses, finite "
                             f"{torch.isfinite(losses).all()}")
    if not identical:
        raise AssertionError("large: the graph differs from eager steps")
    return dict(one_card=tried, image_size=size, batch=batch,
                layout="4 nccl ranks as data 2 x spatial 2", losses=r["losses"],
                eager_losses=r["eager_losses"], identical=identical,
                graph_ms=r["graph_ms"], peak_gib=peak,
                eager_peak_gib=[o["eager_peak_gib"] for o in outs],
                graph_peak_gib=[o["graph_peak_gib"] for o in outs],
                halos_a_step=r["halos_a_step"],
                capture_seconds=r["capture_seconds"], ranks_seconds=ranks_s)


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
    parser.add_argument("parts", nargs="*", choices=PARTS + ("large",),
                        default=list(PARTS),
                        help="what to run (default: all but large)")
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
    if "large" in parts:
        line["large"] = large(n, smi)
    print(json.dumps({"multi_card": line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
