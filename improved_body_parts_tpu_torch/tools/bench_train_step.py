"""Train-step time of the flagship model against the feed that brings the
batches to the card.

    python -m improved_body_parts_tpu_torch.tools.bench_train_step
    python -m improved_body_parts_tpu_torch.tools.bench_train_step \
        --configs dense:1,resident:4 --steps 8
    python -m improved_body_parts_tpu_torch.tools.bench_train_step --device cpu \
        --tiny-model --image-size 64 --batch-size 2 --steps 2 --workers 1

Port of the JAX package's ``tools/bench_train_step.py``. Its k x depth
matrix becomes the port's own feeds, given as ``feed:k`` pairs:

  dense:1        dense GT through ``PrefetchingLoader`` and
                 ``parallel/mesh.staged_batches`` (pinned copies on a side
                 stream, 2 ahead), one step a call;
  compact-u8:1   the same with uint8 images and the GT rendered on the card;
  resident:1     the device-resident store (``data/resident.py``): only the
                 step's plan crosses to the card, eager steps;
  resident:4     4 steps a call, replayed from a CUDA graph of the captured
                 step (``train_graph.py``; eager steps on the CPU).

Any feed of ``dense``, ``compact``, ``compact-u8`` and ``resident`` takes any
k (k > 1: ``staged_chunks`` and ``make_multi_*_train_step``). As in the JAX
tool, a small pool of host batches (plans, for the resident feed) is made
first and cycled, so sample synthesis is not timed; the copy to the card,
the dispatch and the step are. Each configuration starts from the same
weights (the reference init from seed 0), in bf16 with remat (``--no-remat``
turns it off). Times are host wall clock between synchronizations of the
card: the warm-up (``compile_s``: cuDNN plans, the graph capture) and the
timed steps.

One JSON line a configuration with the JAX tool's keys (``k``, ``depth``,
``steps``, ``wall_s``, ``s_per_step``, ``samples_per_s``, ``compile_s``) and
``feed`` and ``graph`` (the steps were replayed from a CUDA graph), then
the ``summary`` line (``speedup_vs_blocking`` is the first
configuration's time a step over the best one's). Runs on the card unless
``--device cpu`` is given, and raises when there is no card and no
``--device``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from improved_body_parts_tpu_torch.utils.profiling import sync

FEEDS = ("dense", "compact", "compact-u8", "resident")
POOL_BATCHES = 4
RECORDS = 64
STAGE_DEPTH = 2


def parse_configs(spec: str) -> List[Tuple[str, int]]:
    """"dense:1,resident:4" -> [("dense", 1), ("resident", 4)]."""
    out = []
    for item in spec.split(","):
        feed, _, k = item.partition(":")
        if feed not in FEEDS or not k.isdigit() or int(k) < 1:
            raise ValueError(f"a configuration is feed:k with a feed of "
                             f"{FEEDS} and k >= 1, got {item!r}")
        out.append((feed, int(k)))
    return out


def build_model(config, tiny: bool, remat: bool, device):
    """(model config, the bf16 network on ``device``, reference init from
    seed 0)."""
    from improved_body_parts_tpu_torch.configs import ModelConfig
    from improved_body_parts_tpu_torch.models.imhn import create_model
    mcfg = (ModelConfig(nstack=2, inp_dim=64, increase=32) if tiny
            else config.model)
    if remat:
        mcfg = dataclasses.replace(mcfg, remat=True)
    model = create_model(mcfg, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    fmt = (torch.channels_last if torch.device(device).type == "cuda"
           else torch.contiguous_format)
    return mcfg, model.to(device, memory_format=fmt)


def run_config(init: torch.nn.Module, config, feed: str, k: int, *, steps: int,
               batch: int, device, warmup: Optional[int] = None,
               workers: int = 6, lr: float = 1e-4, store=None) -> dict:
    """One configuration from a copy of ``init``: ``warmup`` steps (default
    k), then ``steps`` rounded up to a multiple of k, timed. ``config`` has
    the image size as its width and height and ``init``'s model config.
    ``store`` (``(ResidentStore, its device tensors)``) is shared by the
    resident configurations; made here when None."""
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib

    warmup = k if warmup is None else warmup
    steps = -(-steps // k) * k
    model = copy.deepcopy(init)
    state = train_lib.create_train_state(model, config.train)
    resident = feed == "resident"
    if resident:
        from improved_body_parts_tpu_torch.data.resident import ResidentFeed
        store_h, store_d = store or make_store(config, device)
        pool = list(ResidentFeed(store_h, config, augment=True).plan_batches(
            batch, POOL_BATCHES, seed=0))
        fixed = (store_d,)
        make = (train_lib.make_multi_resident_train_step if k > 1
                else train_lib.make_resident_train_step)
        step = make(model, config)
    else:
        from improved_body_parts_tpu_torch.data.prefetch import PrefetchingLoader
        loader = PrefetchingLoader(
            SyntheticDataset(config, length=RECORDS, image_size=config.height),
            num_workers=workers)
        compact = feed.startswith("compact")
        pool = list(loader.batches(batch, POOL_BATCHES, seed=0, compact=compact,
                                   image_u8=feed == "compact-u8"))
        fixed = ()
        make = (train_lib.make_multi_train_step if k > 1
                else train_lib.make_train_step)
        step = make(model, config, compact_gt=compact)
    depth = 0 if resident else STAGE_DEPTH

    def cycled(n):
        return itertools.islice(itertools.cycle(pool), n)

    def run(n_steps):
        metrics = None
        if k > 1:
            with_lr = ((*b, np.asarray(lr, np.float32)) for b in cycled(n_steps))
            for _, chunk in mesh_lib.staged_chunks(device, with_lr, k,
                                                   max(depth, 1)):
                metrics = step(state, *fixed, *chunk)
        else:
            for b in mesh_lib.staged_batches(device, cycled(n_steps), depth):
                metrics = step(state, *fixed, *b, lr)
        sync(metrics["loss"])
        if not torch.isfinite(metrics["loss"]).all():
            raise AssertionError(f"{feed} k={k}: non-finite loss")

    t0 = time.perf_counter()
    run(warmup)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(steps)
    wall = time.perf_counter() - t0
    return {"feed": feed, "k": k, "depth": depth, "steps": steps,
            "wall_s": round(wall, 3), "s_per_step": round(wall / steps, 4),
            "samples_per_s": round(steps * batch / wall, 2),
            "compile_s": round(compile_s, 1),
            "graph": getattr(step, "graphed", None) is not None}


def make_store(config, device):
    """The resident store of ``RECORDS`` synthetic records at the config's
    size, and its tensors on ``device``."""
    from improved_body_parts_tpu_torch.data.resident import build_store
    from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
    store_h = build_store(SyntheticDataset(config, length=RECORDS,
                                           image_size=config.height))
    return store_h, store_h.device_arrays(device)


def summary(results: Sequence[dict]) -> dict:
    """The JAX tool's summary line: the best configuration, and the first
    one's time a step over the best one's."""
    base = results[0]
    best = min(results, key=lambda r: r["s_per_step"])
    return {"summary": f"best feed={best['feed']} k={best['k']} d={best['depth']}",
            "speedup_vs_blocking": round(base["s_per_step"] / best["s_per_step"], 2)}


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device
    from improved_body_parts_tpu_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16,
                    help="timed optimizer steps a configuration")
    ap.add_argument("--configs", default="dense:1,compact-u8:1,resident:1,resident:4",
                    help="comma list of feed:k pairs")
    ap.add_argument("--workers", type=int, default=6,
                    help="PrefetchingLoader processes for the pool")
    ap.add_argument("--tiny-model", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    configs = parse_configs(args.configs)
    config = get_config("Canonical")
    size = args.image_size
    mcfg, init = build_model(config, args.tiny_model, not args.no_remat, device)
    config = dataclasses.replace(config, width=size, height=size, model=mcfg)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device={where} batch={args.batch_size} size={size}", file=sys.stderr)
    store = (make_store(config, device)
             if any(f == "resident" for f, _ in configs) else None)
    results = []
    for feed, k in configs:
        rec = run_config(init, config, feed, k, steps=args.steps,
                         batch=args.batch_size, device=device,
                         workers=args.workers, store=store)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps(summary(results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
