"""Host-side batch prefetching: a thread pool generates (image, mask,
heatmaps) samples ahead of the device step.

The port's copy of ``improved_body_parts_tpu/data/prefetch.py``; batches
are stacked by ``data.synthetic.stack_samples`` (numpy arrays with numpy,
the compact feed's torch tensors with torch).

The reference keeps the TPU fed with N DataLoader worker processes
(train_distributed.py:213-226, num_workers=2, ~40 samples/s/proc per
README.md:50); here a thread pool + a sliding work window plays that role
(the heavy work — cv2 warps, numpy heatmaps — releases the GIL).

Backpressure: work items are released at most ``queue_depth`` steps ahead
of the step being consumed, so host memory holds O(queue_depth x batch)
decoded samples no matter how skewed individual sample latencies are.
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Iterator, Tuple

import numpy as np

from improved_body_parts_tpu_torch.data.synthetic import stack_samples


def _supports_rng(dataset) -> bool:
    """Whether dataset.__getitem__ accepts an rng argument (checked once —
    a try/except around the call would misread dataset-internal TypeErrors
    as 'no rng parameter')."""
    try:
        sig = inspect.signature(dataset.__getitem__)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 2


class PrefetchingLoader:
    """Wraps a dataset with __getitem__ -> (img, mask, heat) into a
    prefetched batch iterator with the same ``batches`` contract."""

    def __init__(self, dataset, num_workers: int = 4, queue_depth: int = 4):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.queue_depth = max(1, queue_depth)
        self._rng_ok = _supports_rng(dataset)

    def __len__(self):
        return len(self.dataset)

    def batches(self, batch_size: int, steps: int, seed: int = 0,
                rank: int = 0, world: int = 1, compact: bool = False,
                max_people: int = 8, image_u8: bool = False,
                ) -> Iterator[Tuple]:
        """``batch_size`` is GLOBAL; the full index/seed plan is drawn on
        every process and only this rank's contiguous slice is fetched
        (DistributedSampler pattern)."""
        rng = np.random.RandomState(seed)
        per = batch_size // world
        assert per * world == batch_size, (batch_size, world)
        lo = rank * per
        idx_plan = [rng.randint(0, len(self.dataset), batch_size)[lo:lo + per]
                    for _ in range(steps)]
        # per-work-item rng seeds so augmenting datasets (CocoH5Dataset)
        # draw FRESH augmentations every epoch, matching the synchronous path
        seed_rng = np.random.RandomState(seed ^ 0x5F5E100)
        item_seeds = [int(seed_rng.randint(2 ** 31))
                      for _ in range(steps * batch_size)]
        item_seeds = [item_seeds[s * batch_size + lo + j]
                      for s in range(steps) for j in range(per)]
        batch_size = per

        sample_q: "queue.Queue" = queue.Queue()
        work_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def release(step):
            for slot, i in enumerate(idx_plan[step]):
                work_q.put((step, slot, int(i)))

        # sliding window: at most queue_depth steps of work outstanding
        window = min(self.queue_depth, steps)
        for s in range(window):
            release(s)

        def fetch(step, slot, i):
            if compact:
                # compact wire format for device-side GT rasterization
                # (data/heatmaps_device.py): (img bf16, mask bf16,
                # (joints, mask_all))
                rng = (np.random.RandomState(item_seeds[step * batch_size + slot])
                       if self._rng_ok else None)
                return self.dataset.get_compact(i, rng, max_people=max_people,
                                                image_u8=image_u8)
            if self._rng_ok:
                s = item_seeds[step * batch_size + slot]
                return self.dataset.__getitem__(i, np.random.RandomState(s))
            return self.dataset[i]

        def worker():
            while not stop.is_set():
                try:
                    step, slot, i = work_q.get(timeout=0.2)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                try:
                    item = (step, slot, fetch(step, slot, i))
                except Exception as e:  # surface dataset errors to consumer
                    item = (step, slot, e)
                # bounded retry-put so a shut-down consumer can't pin us
                while not stop.is_set():
                    try:
                        sample_q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        pending = {}
        try:
            for step in range(steps):
                got = 0
                buf = [None] * batch_size
                for slot, s in pending.pop(step, []):
                    buf[slot] = s
                    got += 1
                while got < batch_size:
                    s_step, slot, s = sample_q.get()
                    if isinstance(s, Exception):
                        raise s
                    if s_step == step:
                        buf[slot] = s
                        got += 1
                    else:
                        pending.setdefault(s_step, []).append((slot, s))
                if step + window < steps:
                    release(step + window)
                yield stack_samples(buf, compact)
        finally:
            stop.set()
