"""Clocks of the benchmark: host spans and the device trace.

``Spans`` records the harness's own host spans around its calls into the
program. ``DeviceTrace`` runs ``torch.profiler`` (CUDA activity only:
kernels, copies and fills) over a window and reduces it to the numbers the
per-layer metrics read: the union of the device's busy intervals, each
kernel's time, and the longest idle gaps named by the harness span the host
was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_KERNEL = "spin_kernel"          # in the name of torch.cuda._sleep's kernel


class Spans:
    """Host spans (name, start, end) in ``time.perf_counter`` seconds, from
    any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))

    def within(self, name: str, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The (start, end) of the spans ``name`` that end in [lo, hi]."""
        with self._lock:
            return [(a, b) for n, a, b in self.items if n == name and lo <= b <= hi]

    def at(self, t: float) -> Optional[str]:
        with self._lock:
            for n, a, b in self.items:
                if a <= t <= b:
                    return n
        return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """``torch.profiler`` over ``[start(), stop()]``, reduced on ``stop``.

    The device's clock is tied to the host's by a marker kernel
    (``torch.cuda._sleep``) enqueued at the start after a synchronize: its
    end is taken as the host time at which the synchronize after it
    returned. Results, in seconds: ``window_s``, ``busy_s`` (the union of
    the device's operations inside the window), ``kernels`` ({name: (count,
    total s)}), ``longest_gaps`` (the 10 longest idle gaps, each named by
    the harness span the host was in at its middle)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.result: Dict = {}

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()

    def stop(self) -> Dict:
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)
        tmp = tempfile.mkdtemp(prefix="pb_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prof = None
        ops = [(e.get("name", ""), float(e["ts"]) * 1e-6,
                float(e["ts"] + e.get("dur", 0)) * 1e-6)
               for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = [b for n, _, b in ops if MARK_KERNEL in n]
        if not marks:
            raise RuntimeError("the device trace holds no marker kernel: "
                               "the profiler saw no device activity")
        offset = self.t_start - marks[0]        # host = device + offset
        lo, hi = self.t_start, self.t_stop
        kernels: Dict[str, List[float]] = {}
        busy_iv = []
        for name, a, b in ops:
            a, b = a + offset, b + offset
            if MARK_KERNEL in name or b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            busy_iv.append((a, b))
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += b - a
        merged = _union(busy_iv)
        busy = sum(b - a for a, b in merged)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        self.result = dict(window_s=hi - lo, busy_s=busy,
                           kernels={n: tuple(v) for n, v in kernels.items()},
                           longest_gaps=[(self.spans.at(0.5 * (a + b))
                                          or "no_harness_span", b - a)
                                         for a, b in gaps[:10]])
        return self.result


def breakdown(result: Dict) -> Dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time, and the 10 longest idle gaps by what the host was doing."""
    ops = sorted(result["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n[:64], v[1]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in result["longest_gaps"]]}
