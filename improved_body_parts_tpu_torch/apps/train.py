"""Train the IMHN pose network with the port (the JAX package's
``train.py`` with its flags and epoch loop), on one CUDA card, or data
parallel on several, one process a card.

    python -m improved_body_parts_tpu_torch.apps.train --epochs 2 \
        --steps-per-epoch 10 --batch-size 4 --image-size 256 -p ckpt_dir
    python -m improved_body_parts_tpu_torch.apps.train --device cpu \
        --tiny-model --epochs 1 --steps-per-epoch 2 --batch-size 1 \
        --image-size 64 -p /tmp/ck

It trains on the card unless ``--device cpu`` is given, and raises when no
card is visible and no ``--device`` was named. Without ``--train-h5`` a
synthetic dataset exercises the same training path. Each epoch writes
``<checkpoint_path>/log`` (rank 0's line, as the reference) and
``<checkpoint_path>/pth/epoch_<N>.pth`` in the reference's checkpoint
layout; its ``weights`` load into ``apps.evaluate``/``apps.demo_image``
through ``--checkpoint``. ``--swa`` also writes the averaged model to
``<checkpoint_path>/pth_swa/``.

``--model ae`` trains the second model family (``models/ae_pose.py``),
whose single output scale takes the loss's leading scale weight.

``--feed resident`` copies the whole uint8 dataset to the card once
(``data/resident.py``) and sends each step only its plan (indices, one
inverse affine a sample, the joints warped on the host); the gather, the
augmentation warp, the mask decimation and the GT rendering run on the
card, so training needs no cv2 on the host (``--resident-augment``
augments the synthetic store; an h5 store always augments, and needs h5py
where it is built). ``--steps-per-dispatch K`` runs K steps a call, for
every feed: on the card a CUDA graph of the captured step, replayed K
times (``train_graph.py``); on the CPU K eager steps.

    python -m improved_body_parts_tpu_torch.apps.train --feed resident \
        --resident-augment --steps-per-dispatch 4 --batch-size 8 -p ckpt_dir

Several cards: under ``torchrun`` (or with ``--multihost --coordinator
host:port --num-processes N --process-id i``) each process trains on its
card (nccl; gloo with ``--device cpu``), ``--batch-size`` is a card's and
the global batch is ``batch_size x world`` (the learning rate scaled by the
world, as the JAX package scales it by its devices); each rank reads its
``process_batch_slice`` of the shared plan, the train-mode BatchNorm
statistics are the global batch's and the gradients are averaged by one
all-reduce (``train_lib``). Rank 0 alone writes the log and the ``.pth``;
every rank resumes from it. ``--resident-shard-store`` keeps only a rank's
contiguous record range of the resident store on its card (the records
trimmed to a multiple of the world).

    torchrun --nproc-per-node 8 -m improved_body_parts_tpu_torch.apps.train \
        --feed resident --resident-shard-store --steps-per-dispatch 4 \
        --batch-size 8 -p ckpt_dir
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.apps.demo_image import DTYPES, default_device
from improved_body_parts_tpu_torch.configs import ModelConfig, get_config
from improved_body_parts_tpu_torch.models.ae_pose import AEPoseNet
from improved_body_parts_tpu_torch.models.imhn import create_model
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt_lib


def build_model(args, config, device: torch.device) -> tuple:
    """(model config, the network on ``device``, in fp32 storage with
    ``--dtype`` compute), the reference init drawn from seed 0: the
    ``AEPoseNet`` for ``--model ae``, else the config's (``create_model``)."""
    mcfg = (ModelConfig(nstack=2, inp_dim=64, increase=32)
            if args.tiny_model else config.model)
    if args.remat:
        mcfg = dataclasses.replace(mcfg, remat=True)
    kw = dict(compute_dtype=DTYPES[args.dtype],
              generator=torch.Generator().manual_seed(0))
    model = (AEPoseNet(mcfg, **kw) if args.model == "ae"
             else create_model(mcfg, **kw))
    fmt = (torch.channels_last if device.type == "cuda"
           else torch.contiguous_format)
    return mcfg, model.to(device, memory_format=fmt)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="PoseNet Training (PyTorch port)")
    parser.add_argument("--config", default="Canonical")
    parser.add_argument("--checkpoint_path", "-p", default="link2checkpoints_distributed",
                        help="checkpoint + log directory")
    parser.add_argument("--resume", "-r", action="store_true", help="resume from checkpoint")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="0 = full dataset")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="batch size (0 = config default)")
    parser.add_argument("--image-size", type=int, default=0,
                        help="override input resolution (debug)")
    parser.add_argument("--train-h5", default="", help="COCO train hdf5 (reference format)")
    parser.add_argument("--val-h5", default="", help="COCO val hdf5")
    parser.add_argument("--synthetic-length", type=int, default=512,
                        help="records in the synthetic fallback dataset (no --train-h5)")
    parser.add_argument("--swa", action="store_true", help="stochastic weight averaging")
    parser.add_argument("--swa-start-epoch", type=int, default=0)
    parser.add_argument("--swa-freq", type=int, default=0,
                        help="epochs per SWA cycle (0 = config default, 5)")
    parser.add_argument("--loss", choices=["focal", "l2"], default="focal")
    parser.add_argument("--lr", type=float, default=0.0,
                        help="override base learning rate (0 = config value)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="disable the 3-epoch linear LR warmup")
    parser.add_argument("--workers", type=int, default=4,
                        help="host data-prefetch threads (0 = synchronous)")
    parser.add_argument("--stage-depth", type=int, default=2,
                        help="host->device staging lookahead: batches pinned "
                             "and copied on a side stream while the steps "
                             "before them run (0 = copy in the step loop)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="optimizer steps a call: K>1 replays a CUDA "
                             "graph of the captured step K times on the "
                             "card (train_graph.py), K eager steps on the CPU")
    parser.add_argument("--feed",
                        choices=["dense", "compact", "compact-u8", "resident"],
                        default="dense",
                        help="GT format: 'dense' copies the (B,h,w,50) fp32 "
                             "heatmaps; 'compact' copies bf16 images + "
                             "(joints, mask_all) and rasterizes the gaussians "
                             "on the device (data/heatmaps_device.py); "
                             "'compact-u8' copies the images as uint8; "
                             "'resident' copies the whole uint8 dataset to "
                             "the card once and each step only its plan "
                             "(indices, affines, joints): gather, "
                             "augmentation warp and GT rendering run on the "
                             "card (data/resident.py)")
    parser.add_argument("--resident-augment", action="store_true",
                        help="with --feed resident: the geometric "
                             "augmentation on the card for the synthetic "
                             "dataset too (h5 datasets always augment, as "
                             "the host pipeline; no tint)")
    parser.add_argument("--resident-shard-store", action="store_true",
                        help="with --feed resident: each rank keeps only its "
                             "contiguous record range of the store on its "
                             "card")
    parser.add_argument("--max-people", type=int, default=8,
                        help="people-slot padding for --feed compact")
    parser.add_argument("--max_grad_norm", type=float, default=0.0)
    parser.add_argument("--keep", type=int, default=3,
                        help="epoch checkpoints to retain")
    parser.add_argument("--print-freq", type=int, default=20)
    parser.add_argument("--tiny-model", action="store_true",
                        help="small IMHN for smoke tests")
    parser.add_argument("--model", choices=["imhn", "ae"], default="imhn",
                        help="model family: the IMHN of --config, or the "
                             "AE stacked hourglass")
    parser.add_argument("--remat", action="store_true",
                        help="recompute hourglass activations in the backward "
                             "pass (torch.utils.checkpoint)")
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel training, one process a card: "
                             "torchrun's environment, or --coordinator")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous for "
                             "--multihost without torchrun")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="processes of a --coordinator run")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank in a --coordinator run")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, and an error when "
                             "no card is visible; pass cpu to run on the CPU)")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                        help="type the network's convs run in (parameters "
                             "and BatchNorm stay fp32)")
    args = parser.parse_args(argv)

    if args.resident_shard_store and args.feed != "resident":
        raise ValueError("--resident-shard-store shards the resident store: "
                         "it needs --feed resident")
    multi = args.multihost or "WORLD_SIZE" in os.environ
    if multi:
        device = mesh_lib.initialize_multihost(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
        mesh = mesh_lib.make_mesh()
    else:
        device = default_device(args.device)
        mesh = None
    rank, world = (mesh.rank, mesh.world) if multi else (0, 1)
    print(f"device: {device}" + (f", rank {rank} of {world} "
                                 f"({mesh.backend})" if multi else ""))

    config = get_config(args.config)
    tcfg = dataclasses.replace(
        config.train,
        swa=args.swa,
        max_grad_norm=args.max_grad_norm,
        batch_size=args.batch_size or config.train.batch_size,
        learning_rate=args.lr or config.train.learning_rate,
        swa_freq_epochs=args.swa_freq or config.train.swa_freq_epochs,
    )
    config = dataclasses.replace(config, train=tcfg)
    image_size = args.image_size or config.height
    batch = tcfg.batch_size * world               # global
    print(f"batch {tcfg.batch_size} a card" + (f", global batch {batch}"
                                             if multi else " on one device"))

    mcfg, model = build_model(args, config, device)
    state = train_lib.create_train_state(model, tcfg)
    start_epoch = 0

    os.makedirs(args.checkpoint_path, exist_ok=True)
    ckpt_dir = os.path.join(args.checkpoint_path, "pth")
    if args.resume and ckpt_lib.saved_steps(ckpt_dir):
        restored = ckpt_lib.restore_train_state(ckpt_dir)
        train_lib.load_payload(state, restored)
        start_epoch = int(restored["epoch"]) + 1
        print(f"resumed from epoch {start_epoch - 1}")

    # data -------------------------------------------------------------
    if args.train_h5:
        from improved_body_parts_tpu_torch.data.pipeline import CocoH5Dataset
        train_ds = CocoH5Dataset(args.train_h5, config, augment=True)
        val_ds = (CocoH5Dataset(args.val_h5, config, augment=False)
                  if args.val_h5 else None)
    else:
        from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
        print("no --train-h5 given: using the synthetic dataset")
        train_ds = SyntheticDataset(config, length=args.synthetic_length,
                                    image_size=image_size)
        val_ds = SyntheticDataset(config, length=64, seed=999,
                                  image_size=image_size)
    resident = args.feed == "resident"
    store = feed_r = None
    if resident:
        # the dataset lives on the card: build the fixed-canvas store once,
        # copy it there, and plan each step on the host
        from improved_body_parts_tpu_torch.data import resident as resident_lib
        t0 = time.time()
        store_shards = world if args.resident_shard_store else 1
        indices = None
        if len(train_ds) % store_shards:
            # contiguous record ranges must divide evenly over the ranks
            indices = np.arange(len(train_ds) - len(train_ds) % store_shards)
            print(f"sharded store: trimming {len(train_ds) - len(indices)} "
                  f"records to divide over {store_shards} ranks")
        store_h = resident_lib.build_store(train_ds, indices=indices)
        store = store_h.device_arrays(
            device, shard=(rank, store_shards) if store_shards > 1 else None)
        feed_r = resident_lib.ResidentFeed(
            store_h, dataclasses.replace(config, width=image_size,
                                         height=image_size),
            augment=bool(args.train_h5) or args.resident_augment,
            max_people=args.max_people)
        mb = sum(v.numel() for v in store.values()) / 1e6
        print(f"resident store: {len(store_h)} records, {mb:.0f} MB uint8 "
              f"copied to {device} in {time.time() - t0:.1f}s"
              + (f" (records {rank}/{store_shards} of the store)"
                 if store_shards > 1 else ""))
    elif args.workers > 0:
        from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader
        train_ds = PrefetchingLoader(train_ds, num_workers=args.workers)

    steps = args.steps_per_epoch or max(len(train_ds) // batch, 1)
    kd = max(args.steps_per_dispatch, 1)
    compact = args.feed.startswith("compact")
    image_u8 = args.feed == "compact-u8"
    # the GT rasterizer (--feed compact, resident) sizes its stride grid
    # from the config; keep it in lockstep with --image-size like the
    # datasets do
    step_config = dataclasses.replace(config, width=image_size, height=image_size,
                                      model=mcfg)
    use_focal = args.loss == "focal"
    # the train-mode and SWA graphs share one memory pool
    pool = (torch.cuda.graph_pool_handle()
            if kd > 1 and device.type == "cuda" else None)

    def make_step(freeze_bn: bool):
        kw = dict(use_focal=use_focal, freeze_bn=freeze_bn, mesh=mesh)
        if resident:
            if kd > 1:
                return train_lib.make_multi_resident_train_step(
                    model, step_config, pool=pool, **kw)
            return train_lib.make_resident_train_step(model, step_config, **kw)
        if kd > 1:
            return train_lib.make_multi_train_step(
                model, step_config, compact_gt=compact, pool=pool, **kw)
        return train_lib.make_train_step(model, step_config, compact_gt=compact,
                                         **kw)

    train_step = make_step(freeze_bn=False)
    # SWA epochs run with frozen BatchNorm (train_distributed_SWA.py:221)
    swa_step = make_step(freeze_bn=True) if args.swa else None
    if getattr(train_step, "eager_reason", None):
        print(f"--steps-per-dispatch {kd}: {train_step.eager_reason}")
    eval_step = train_lib.make_eval_step(model, step_config, use_focal=use_focal)
    fixed = (store,) if resident else ()

    log_path = os.path.join(args.checkpoint_path, "log")
    for epoch in range(start_epoch, args.epochs):
        t_epoch = time.time()
        # metrics stay on the device; one fetch an epoch
        loss_accs, skip_accs = [], []
        swa_active = args.swa and epoch >= args.swa_start_epoch
        if resident:
            host_batches = feed_r.plan_batches(batch, steps, seed=epoch,
                                               rank=rank, world=world,
                                               store_shards=store_shards)
        else:
            host_batches = train_ds.batches(batch, steps, seed=epoch, rank=rank,
                                            world=world, compact=compact,
                                            image_u8=image_u8,
                                            max_people=args.max_people)

        def step_lr(step):
            if swa_active:
                # cyclic LR while averaging (train_distributed_SWA.py:365-371)
                return train_lib.cyclic_learning_rate(tcfg, epoch,
                                                      args.swa_start_epoch)
            return train_lib.learning_rate(tcfg, epoch, step, steps, world,
                                           use_warmup=not args.no_warmup)

        def report(step, metrics, lr):
            loss = float(metrics["loss"])          # sync only every print_freq
            print(f"epoch {epoch} step {step}/{steps} loss {loss:.4f} "
                  f"lr {lr:.2e} gnorm {float(metrics['grad_norm']):.2f}")

        active_step = swa_step if (swa_active and swa_step) else train_step
        if kd > 1:
            # K steps a call; each step's LR rides along with its batch
            with_lr = ((*b, np.asarray(step_lr(i), np.float32))
                       for i, b in enumerate(host_batches))
            step = 0
            for n, chunk in mesh_lib.staged_chunks(device, with_lr, kd,
                                                   args.stage_depth):
                metrics = active_step(state, *fixed, *chunk)
                loss_accs.append(metrics["loss"])          # (n,)
                skip_accs.append(metrics["skipped"])
                if (step // kd) % max(args.print_freq // kd, 1) == 0:
                    report(step + n - 1, {k: v[-1] for k, v in metrics.items()},
                           step_lr(step + n - 1))
                step += n
        else:
            for step, b in enumerate(mesh_lib.staged_batches(
                    device, host_batches, args.stage_depth)):
                lr = step_lr(step)
                metrics = active_step(state, *fixed, *b, lr)
                loss_accs.append(metrics["loss"])
                skip_accs.append(metrics["skipped"])
                if step % args.print_freq == 0:
                    report(step, metrics, lr)
        epoch_losses = torch.cat([x.reshape(-1) for x in loss_accs]).cpu().numpy()
        skipped = int(torch.cat([x.reshape(-1) for x in skip_accs]).sum())

        # SWA snapshot at the LOW point of each cyclic-LR cycle
        # (train_distributed_SWA.py: '% swa_freq == swa_freq - 1')
        if swa_active and \
                (epoch - args.swa_start_epoch) % tcfg.swa_freq_epochs == \
                tcfg.swa_freq_epochs - 1:
            train_lib.swa_update(state)
            print(f"SWA accumulate #{int(state.swa_count)}")

        # validation loss (reference test(), train_distributed.py:341-393)
        val_losses = []
        if val_ds is not None:
            for imgs, masks, heats in mesh_lib.staged_batches(
                    device, val_ds.batches(batch, max(steps // 8, 1), seed=0,
                                           rank=rank, world=world), 0):
                val_losses.append(eval_step(imgs, masks, heats))
        train_loss = float(epoch_losses.mean()) if len(epoch_losses) else float("nan")
        val_loss = torch.stack(val_losses).mean() if val_losses else None
        if val_loss is not None and multi:
            # every rank's slice weighs the same: the mean of the means
            val_loss = mesh_lib.all_reduce_mean([val_loss], mesh.group)[0]
        val_loss = float("nan") if val_loss is None else float(val_loss)
        dt = time.time() - t_epoch
        print(f"=== epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
              f"({dt:.1f}s, {skipped} skipped batches)")
        if rank == 0:  # rank-0-only logging (train_distributed.py:318-324)
            with open(log_path, "a") as f:
                f.write(f"Epoch {epoch}\ttrain_loss: {train_loss}\tval_loss: {val_loss}\n")
            ckpt_lib.save_train_state(
                ckpt_dir, train_lib.state_payload(state, tcfg, epoch=epoch,
                                                  train_loss=train_loss),
                step=epoch, keep=args.keep)
        if multi:
            torch.distributed.barrier()     # the epoch's .pth is written

    if args.swa and int(state.swa_count) > 0 and rank == 0:
        # publish the averaged model (reference swap_swa_sgd before the final
        # save, train_distributed_SWA.py:403-424)
        train_lib.swa_swap(state)
        swa_dir = os.path.join(args.checkpoint_path, "pth_swa")
        ckpt_lib.save_train_state(
            swa_dir, train_lib.state_payload(state, tcfg, epoch=args.epochs - 1),
            step=args.epochs - 1)
        print(f"wrote SWA-averaged model ({int(state.swa_count)} snapshots) "
              f"to {swa_dir}")
    if multi:
        mesh_lib.shutdown(mesh, train_step, swa_step)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
