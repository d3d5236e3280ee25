"""Multi-process dry run of the port's multi-GPU features, on a tiny
model: the counterpart of the JAX package's ``__graft_entry__.
dryrun_multichip``, on its data × spatial mesh.

    python -m improved_body_parts_tpu_torch.tools.dryrun_multichip 4 --device cpu
    python -m improved_body_parts_tpu_torch.tools.dryrun_multichip 4

starts N ranks (``torch.multiprocessing``, one process each): gloo on the
CPU with ``--device cpu``, else NCCL over the first N visible cards (it
refuses N larger than the card count rather than put two NCCL ranks on one
card). The mesh is the JAX dry run's: spatial 2 when N is even and at
least 4, else 1, and data N / spatial (printed as ``mesh: data=D
spatial=S``). Every rank runs, on the nstack-2 model of the tests at 64²,
with a global batch of 2 a data slice:

  * two remat'd train-mode steps with the images' rows sharded over the
    spatial axis (``shard_batch(shard_spatial=True)``: each rank its band);
  * an SWA accumulate and swap, and a frozen-BN step on the average;
  * the compact feed's step (ground truth rendered on the device, each
    rank its band) with fp32 images, and from the same state with uint8
    images: losses within 5% of each other;
  * a ``.pth`` of rank 0's state restored by every rank, which then takes
    one more step: its loss and parameters equal the unrestored state's;
  * a resident step with the store sharded over the data axis
    (``device_arrays(shard=(data_index, D))``, ``plan_batches(
    store_shards=D)``), the batch replicated over the spatial axis, then
    two more in one K = 2 dispatch (a CUDA graph under NCCL);

after each, the parameters agree on every rank (checksums gathered). The
group is then closed and rank 0 serves over a mesh of N devices (the N
cards, or N CPU replicas):
the int8 PTQ model and multi-scale TTA (``scales=(0.5, 1.0)``) through
``predict_batch(mesh=)`` on a batch that needs padding, each with the same
skeletons as without the mesh. Any failure, a rank that dies or hangs past
``--timeout`` included, kills every rank (SIGKILL) and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import os
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZE = 64
PER_RANK = 2
LR = 1e-4


def free_port() -> int:
    return distinct_ports(1)[0]


def distinct_ports(n: int) -> list:
    """``n`` free ports, all bound at once while they are picked, so that
    no two are the same (for launches that will run side by side)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _log(rank: int, t0: float, what: str) -> None:
    """One progress line on stderr, so a hang shows the last stage reached."""
    print(f"[rank {rank} +{time.monotonic() - t0:.1f} s] {what}",
          file=sys.stderr, flush=True)


def _checksum(state) -> tuple:
    """Sum and sum of squares of every parameter and BN buffer, float64."""
    ts = list(state.model.parameters()) + list(state.model.buffers())
    return tuple(float(sum(t.detach().double().pow(p).sum() for t in ts))
                 for p in (1, 2))


def _agree(value, what: str) -> None:
    """Raise unless every rank holds the same ``value``."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    if any(g != got[0] for g in got):
        raise AssertionError(f"{what} differs across ranks: {got}")


def _config():
    from improved_body_parts_tpu_torch.configs import (
        CanonicalConfig, ModelConfig, TrainConfig,
    )
    return CanonicalConfig(
        width=SIZE, height=SIZE,
        model=ModelConfig(nstack=2, inp_dim=32, increase=16, remat=True),
        train=dataclasses.replace(TrainConfig(), swa=True))


def _model(config, device):
    from improved_body_parts_tpu_torch.models.imhn import create_model
    g = torch.Generator().manual_seed(0)
    return create_model(config.model, compute_dtype=torch.float32,
                        generator=g).to(device)


def _serve(config, state, n: int, device_kind: str, device, log) -> str:
    """Rank 0: int8 and multi-scale TTA serving over a mesh of n devices
    against the same predictor without the mesh."""
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.models import quantize as qz
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.parallel.mesh import make_mesh

    devices = (["cpu"] * n if device_kind == "cpu"
               else [f"cuda:{i}" for i in range(n)])
    mesh = make_mesh(devices=devices)
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 255, (2 * n + 1, SIZE, SIZE, 3), np.uint8)
    model = state.model.eval()
    calib = [rng.rand(2, SIZE, SIZE, 3).astype(np.float32)]
    qmodel = qz.quantize_model(model, calib)
    lines = []
    for what, net, kw in (("int8", qmodel, {}),
                          ("fp32 TTA (0.5, 1.0)", model, {"scales": (0.5, 1.0)})):
        pred = Predictor(net, config, device=device)
        kernels.reset_launch_counts()
        sharded = pred.predict_batch(frames, mesh=mesh, use_cpp=True, **kw)
        launches = dict(nms=kernels.nms.launches,
                        int8_conv=kernels.int8_conv.launches)
        flat = pred.predict_batch(frames, use_cpp=True, **kw)
        assert len(sharded) == len(flat) == len(frames)
        for (km, sm), (kf, sf) in zip(sharded, flat):
            assert km.shape == kf.shape, (what, km.shape, kf.shape)
            np.testing.assert_allclose(km, kf, atol=1e-4, err_msg=what)
            np.testing.assert_allclose(sm, sf, atol=1e-4, err_msg=what)
        log(f"served {what} over the mesh")
        lines.append(f"{what}: {len(frames)} frames over {n} devices == "
                     f"unsharded ({sum(len(k) for k, _ in flat)} people; "
                     f"launches on the mesh {launches})")
    return "; ".join(lines)


def rank_main(rank: int, world: int, port: int, device_kind: str,
              ckpt_dir: str) -> None:
    """One rank of the dry run (module docstring). Raises on any failure."""
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.configs import NUM_LAYERS
    from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
    from improved_body_parts_tpu_torch.data.resident import ResidentFeed, build_store
    from improved_body_parts_tpu_torch.data.synthetic import (
        SyntheticDataset, random_people,
    )
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt_lib

    t0 = time.monotonic()
    torch.set_num_threads(1)
    device = mesh_lib.initialize_multihost(f"localhost:{port}", world, rank,
                                           device=device_kind, timeout_s=300)
    spatial = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = mesh_lib.make_mesh(spatial=spatial)
    D = mesh.data_size
    if rank == 0:
        print(f"mesh: data={D} spatial={spatial}", flush=True)
    _log(rank, t0, f"joined the group on {device}, mesh {mesh.shape}")
    config = _config()
    torch.backends.cudnn.deterministic = True   # restored == unrestored
    state = train_lib.create_train_state(_model(config, device), config.train)
    B = PER_RANK * D
    rng = np.random.RandomState(0)      # every rank draws the global batch

    def batch():
        """(imgs, mask, heat): this rank's data slice, its band of rows."""
        glob = (rng.rand(B, SIZE, SIZE, 3).astype(np.float32),
                np.ones((B, SIZE // 4, SIZE // 4, 1), np.float32),
                rng.rand(B, SIZE // 4, SIZE // 4, NUM_LAYERS).astype(np.float32))
        return mesh_lib.shard_batch(mesh, glob, shard_spatial=True)

    step = train_lib.make_train_step(state.model, config, mesh=mesh)
    losses = [float(step(state, *batch(), LR)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and int(state.step) == 2, losses
    _agree((losses, _checksum(state)), "two remat'd train steps")
    _log(rank, t0, "two remat'd train steps agree")

    train_lib.swa_update(state)
    train_lib.swa_swap(state)
    swa_step = train_lib.make_train_step(state.model, config, freeze_bn=True,
                                         mesh=mesh)
    swa_loss = float(swa_step(state, *batch(), LR * 0.1)["loss"])
    assert np.isfinite(swa_loss) and int(state.swa_count) == 1
    _agree((swa_loss, _checksum(state)), "SWA swap and frozen-BN step")
    _log(rank, t0, "SWA swap and frozen-BN step agree")

    # the compact feed: the ground truth rendered in the step, each rank its
    # band; then the uint8 wire from the same state: the losses differ by
    # the <= 1/510 quantization of the images only
    compact = train_lib.make_train_step(state.model, config, compact_gt=True,
                                        mesh=mesh)
    imgs, mask, _ = batch()
    gt = mesh_lib.shard_batch(mesh, (
        np.stack([pad_people(random_people(rng, SIZE, SIZE), 4) for _ in range(B)]),
        np.ones((B, SIZE // 4, SIZE // 4), np.float32)))
    pre_compact = train_lib.state_payload(state, config.train)
    c_loss = float(compact(state, imgs, mask, gt, LR)["loss"])
    u8_state = train_lib.create_train_state(_model(config, device), config.train)
    train_lib.load_payload(u8_state, pre_compact)
    u8 = torch.clamp(torch.round(imgs * 255.0), 0, 255).to(torch.uint8)
    u8_loss = float(train_lib.make_train_step(u8_state.model, config,
                                              compact_gt=True, mesh=mesh)(
        u8_state, u8, mask, gt, LR)["loss"])
    assert np.isfinite(c_loss) and abs(u8_loss - c_loss) < 0.05 * max(1.0, abs(c_loss))
    _agree((c_loss, u8_loss, _checksum(state)), "compact fp32 and uint8 steps")
    _log(rank, t0, "compact fp32 and uint8 steps agree")
    del u8_state

    # .pth round trip: rank 0 writes, every rank restores and steps on
    if rank == 0:
        ckpt_lib.save_train_state(ckpt_dir, train_lib.state_payload(
            state, config.train, epoch=0), step=0)
    dist.barrier()
    restored = train_lib.create_train_state(_model(config, device), config.train)
    train_lib.load_payload(restored, ckpt_lib.restore_train_state(ckpt_dir))
    b = batch()
    m_a = step(state, *b, LR)
    m_b = train_lib.make_train_step(restored.model, config, mesh=mesh)(
        restored, *b, LR)
    assert float(m_a["loss"]) == float(m_b["loss"]), (m_a, m_b)
    assert _checksum(state) == _checksum(restored)
    _agree(_checksum(restored), "restored state after a step")
    _log(rank, t0, "restored state agrees")

    # the resident feed with the store sharded over the data axis; the
    # ranks of a spatial group take the same slice whole
    ds = SyntheticDataset(config, length=4 * D, image_size=SIZE)
    store_h = build_store(ds)
    di = mesh.data_index
    store = store_h.device_arrays(device, shard=(di, D))
    feed = ResidentFeed(store_h, config, augment=True)
    res_step = train_lib.make_resident_train_step(state.model, config, mesh=mesh)
    (plan,) = feed.plan_batches(B, 1, seed=2, rank=di, world=D, store_shards=D)
    plan = mesh_lib.assemble_global_batch(mesh, plan)
    res_loss = float(res_step(state, store, *plan, LR)["loss"])
    multi = train_lib.make_multi_resident_train_step(state.model, config,
                                                     mesh=mesh)
    plans = list(feed.plan_batches(B, 2, seed=3, rank=di, world=D,
                                   store_shards=D))
    chunk = tuple(torch.from_numpy(np.stack([p[i] for p in plans]))
                  for i in range(3))
    m_k = multi(state, store, *chunk, torch.full((2,), LR))
    k_losses = [float(x) for x in m_k["loss"]]
    assert np.isfinite(res_loss) and all(np.isfinite(k_losses))
    _agree((res_loss, k_losses, _checksum(state)), "sharded resident steps")
    _log(rank, t0, "sharded resident steps agree")

    backend = mesh.backend
    route = "graph" if multi.graphed is not None else "eager"
    # the K = 2 graph captured NCCL all-reduces: it goes before the group
    mesh_lib.shutdown(mesh, multi)
    _log(rank, t0, "group closed")
    if rank == 0:
        # after the group is gone: no rank waits in a collective on the
        # cards rank 0 now serves on
        serving = _serve(config, state, world, device_kind, device,
                         lambda what: _log(rank, t0, what))
        print(f"dryrun_multichip({world}, {backend}) OK: mesh data={D} "
              f"spatial={spatial}; losses {losses} swa {swa_loss:.4f} compact "
              f"{c_loss:.4f} uint8 {u8_loss:.4f} restored {float(m_b['loss']):.4f} "
              f"resident (sharded store) {res_loss:.4f} K=2 ({route}) "
              f"{k_losses}; {serving}", flush=True)


def _entry(rank, world, port, device_kind, ckpt_dir, hang_s):
    # a rank still running after hang_s prints every thread's stack, so a
    # hang shows where it waits before the parent kills it
    faulthandler.dump_traceback_later(hang_s, exit=False)
    try:
        rank_main(rank, world, port, device_kind, ckpt_dir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)          # no rank carries on alone


def run(n: int, device_kind: str = "cuda", timeout: float = 600.0,
        port: int = 0) -> int:
    """Start ``n`` ranks (their rendezvous on ``port``, a free one if 0)
    and wait; 0 when every rank passed."""
    if device_kind != "cpu":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            print(f"dryrun_multichip: {n} NCCL ranks need {n} cards, "
                  f"{cards} visible (use --device cpu for gloo ranks)",
                  file=sys.stderr)
            return 2
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ctx = mp.start_processes(_entry, args=(n, port or free_port(), device_kind,
                                               ckpt_dir, max(timeout - 15.0, 1.0)),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s")
        except BaseException as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            print(f"dryrun_multichip({n}) FAILED: {e}", file=sys.stderr)
            return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cpu: gloo ranks on the CPU; cuda: NCCL, a card a rank")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--port", type=int, default=0,
                        help="the ranks' rendezvous port (0: a free one)")
    args = parser.parse_args(argv)
    return run(args.n, args.device, args.timeout, args.port)


if __name__ == "__main__":
    sys.exit(main())
