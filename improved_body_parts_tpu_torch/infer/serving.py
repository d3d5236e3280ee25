"""Pipelined batch serving on top of the Predictor.

The port's copy of ``improved_body_parts_tpu/infer/serving.py``, unchanged
in behaviour: N worker threads keep up to ``depth`` batches in flight so
host work (letterbox, the one device-to-host fetch per batch, unpack + C++
grouping) overlaps with device compute on the other workers' batches.

The reference has no serving layer (its demo/evaluator loop is strictly
sequential, demo_image.py:80-160).

Usage::

    serve = PipelinedServer(predictor, batch_size=8, depth=4)
    futures = [serve.submit(img) for img in images]   # BGR uint8, any size
    results = [f.result() for f in futures]           # (kps, scores)
    serve.close()
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np


class PipelinedServer:
    """Batches letterboxed images and runs ``depth`` overlapping device
    dispatches; each submit returns a Future of (keypoints (N,18,3) in the
    ORIGINAL image coordinates, scores (N,))."""

    def __init__(self, predictor, batch_size: int = 8, depth: int = 4,
                 flush_ms: float = 5.0, use_cpp: Optional[bool] = None,
                 max_pending: Optional[int] = None, mesh=None,
                 scales: Optional[Tuple[float, ...]] = None,
                 angles: Tuple[float, ...] = (0.0,)):
        self.predictor = predictor
        self.batch_size = batch_size
        self.flush_ms = flush_ms
        self.use_cpp = use_cpp
        # multi-scale/rotation TTA in the batched device pass
        # (Predictor._tta_maps) — the serving path's answer to the
        # reference's sequential scale loop (parse_skeletons.py:186-209)
        self.scales = tuple(scales) if scales is not None else (1.0,)
        self.angles = tuple(angles)
        # sharded serving (Predictor.predict_batch(mesh=...)); the port's
        # Predictor raises NotImplementedError for a mesh
        self.mesh = mesh
        # bounded input queue: a producer faster than the device BLOCKS in
        # submit() instead of accumulating decoded frames in host RAM.
        # Default bound: enough to keep every in-flight batch full plus one
        # spare batch per worker.
        if max_pending is None:
            max_pending = 2 * batch_size * max(1, depth)
        self.max_pending = max_pending
        self._inq: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._closed = False
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, depth))]
        for w in self._workers:
            w.start()

    # -- client API ---------------------------------------------------------
    def submit(self, img_bgr_u8: np.ndarray,
               timeout: Optional[float] = None) -> "Future":
        """Enqueue one image; returns a Future of (kps, scores). Blocks when
        ``max_pending`` images are already queued (backpressure); a
        ``timeout`` (seconds) raises queue.Full instead of waiting
        indefinitely."""
        if self._closed:
            raise RuntimeError("server is closed")
        fut: "Future" = Future()
        self._inq.put((img_bgr_u8, fut), timeout=timeout)
        return fut

    def pending(self) -> int:
        """Queued-but-not-yet-batched image count (bounded by max_pending)."""
        return self._inq.qsize()

    def predict_many(self, imgs: List[np.ndarray]) -> List[Tuple[np.ndarray, np.ndarray]]:
        futs = [self.submit(im) for im in imgs]
        return [f.result() for f in futs]

    def close(self):
        self._closed = True
        for _ in self._workers:
            self._inq.put(None)
        for w in self._workers:
            w.join()

    # -- internals ----------------------------------------------------------
    def _collect_batch(self):
        """Block for one item, then greedily take up to batch_size within
        flush_ms — keeps single-request latency bounded while letting
        bursts fill whole batches. Returns (items, saw_shutdown); a worker
        that consumes a shutdown sentinel exits after its current batch
        (never re-queued: a re-put could deadlock against the bounded
        queue once every peer has already exited)."""
        first = self._inq.get()
        if first is None:
            return [], True
        items = [first]
        while len(items) < self.batch_size:
            try:
                nxt = self._inq.get(timeout=self.flush_ms / 1e3)
            except queue.Empty:
                return items, False
            if nxt is None:
                return items, True
            items.append(nxt)
        return items, False

    def _worker(self):
        while True:
            items, shutdown = self._collect_batch()
            if items:
                try:
                    self._run_batch(items)
                except Exception as e:  # pragma: no cover - defensive
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)
            if shutdown:
                return

    def _run_batch(self, items):
        boxed, scales, orig_hws = [], [], []
        for img, _ in items:
            out, scale = self.predictor.letterbox(img)
            boxed.append(out)
            scales.append(scale)
            orig_hws.append(img.shape[:2])
        # pad the batch to full size with a copy of the last frame so every
        # dispatch has one shape (results are dropped)
        n_real = len(boxed)
        while len(boxed) < self.batch_size:
            boxed.append(boxed[-1])
        canvas_h = float(boxed[0].shape[0])
        img_hs = np.asarray([hw[0] * s for hw, s in zip(orig_hws, scales)]
                            + [canvas_h] * (self.batch_size - n_real), np.float32)
        # valid-content extent per image: the letterbox pad band beyond it is
        # suppressed on device (Predictor.suppress_pad_peaks)
        content_hws = np.asarray(
            [[hw[0] * s, hw[1] * s] for hw, s in zip(orig_hws, scales)]
            + [[canvas_h, canvas_h]] * (self.batch_size - n_real), np.float32)
        kw = {} if self.mesh is None else {"mesh": self.mesh}
        results = self.predictor.predict_batch(
            np.stack(boxed), img_hs=img_hs, use_cpp=self.use_cpp,
            content_hws=content_hws, scales=self.scales, angles=self.angles,
            **kw)
        for i, (_, fut) in enumerate(items):
            kps, scores = results[i]
            kps = np.array(kps, copy=True)
            kps[:, :, :2] /= scales[i]     # letterbox -> original coords
            fut.set_result((kps, scores))
