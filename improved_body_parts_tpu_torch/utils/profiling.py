"""Timing, tracing and FLOP counting for the port's measurement tools.

Port of ``improved_body_parts_tpu/utils/profiling.py``. The reference
times with wall-clock deltas around ``torch.cuda.synchronize()``
(train_distributed.py:299), keeps ``AverageMeter`` running averages
(evaluate.py:286-302) and counts FLOPs with thop (models/posenet.py:217).
Here:

  * ``sync(x)``: wait for the card (``torch.cuda.synchronize`` of the device
    ``x`` is or lives on; a no-op on the CPU);
  * ``timer(meter)``: host wall clock around a block that ends in ``sync``,
    added to ``meter`` (an ``AverageMeter``) when one is given;
    ``cuda_timer()``: device time between two CUDA events;
    ``device_timer(device)``: the one of the two for ``device``;
  * ``trace(logdir)``: a ``torch.profiler`` trace of CPU and CUDA activity,
    written as a Chrome trace (``trace.json``) into ``logdir``;
  * ``flops_of(fn, *args)``: ``torch.utils.flop_counter.FlopCounterMode``'s
    count for one call (2 x multiply-accumulates of every conv and matmul);
  * ``model_stats``: parameters and FLOPs of a ``PoseNet`` forward;
  * ``launches_and_busy(run, n)``: the host's calls that start work on the
    card (``LAUNCH_CALLS``) a step, by name, and the card's busy ms a
    step, from ``torch.profiler`` over ``run()`` (n steps).

``FlopCounterMode`` sees the operators dispatched through PyTorch. The int8
convs of a ``quant="int8"`` model are launched through ctypes on the card
(``ops/kernels.int8_conv``), where it sees nothing, so count an int8
forward's FLOPs on the float model of the same config: it has the same
convs with the same multiply-accumulates.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


# the host's calls that start work on the card, counted by the profiler
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


class AverageMeter:
    """Running average (reference evaluate.py:286-302)."""

    def __init__(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def sync(x=None) -> None:
    """Wait until the card has finished the work queued for ``x`` (a tensor
    or a device): synchronize the CUDA device it lives on. A no-op for the
    CPU. ``None`` synchronizes the current CUDA device when there is one."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    d = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if d.type == "cuda":
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def timer(meter: Optional[AverageMeter] = None):
    """Host wall clock around a block; the block ends with ``sync`` so the
    card's work is inside. Yields a dict that holds ``elapsed`` (s) after
    the block."""
    t0 = time.perf_counter()
    holder = {}
    yield holder
    holder["elapsed"] = time.perf_counter() - t0
    if meter is not None:
        meter.update(holder["elapsed"])


@contextlib.contextmanager
def cuda_timer():
    """Device time of the work a block queues on the current stream,
    between two CUDA events: the block is not timed on the host. Waits for
    the end event on exit. Yields a dict that holds ``elapsed`` (s) after
    the block."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    holder = {}
    yield holder
    end.record()
    end.synchronize()
    holder["elapsed"] = start.elapsed_time(end) / 1e3


def device_timer(device):
    """``cuda_timer`` for a CUDA ``device``, else ``timer`` (the CPU runs
    its ops before it returns)."""
    if torch.device(device).type == "cuda":
        return cuda_timer()
    return timer()


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity); writes ``<logdir>/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` sum
    the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def launches_and_busy(run: Callable, n_steps: int):
    """torch.profiler over ``run()`` (``n_steps`` steps, no sync inside):
    (the host's launch calls a step, those calls a step by name, the card's
    busy ms a step: its kernels' and copies' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    calls = {e.key: e.count / n_steps for e in rows if e.key in LAUNCH_CALLS}
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == DeviceType.CUDA) / 1e3 / n_steps
    return sum(calls.values()), calls, busy


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)`` as ``FlopCounterMode``
    counts them (the thop replacement): 2 x the multiply-accumulates of
    every conv, linear and matmul it dispatches. Runs ``fn`` once, without
    gradients. Blind to kernels launched through ctypes (module
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def model_stats(model: torch.nn.Module, height: int = 512, width: int = 512,
                batch: int = 1, device=None) -> dict:
    """Parameters and forward FLOPs of a ``PoseNet`` (reference
    posenet.py:205-222): the serving read-out (``predict_maps``) on a
    zero batch of (batch, height, width, 3)."""
    device = device or next(model.parameters()).device
    imgs = torch.zeros((batch, height, width, 3), device=device)
    return dict(params=sum(p.numel() for p in model.parameters()),
                flops=flops_of(model.predict_maps, imgs),
                input=(batch, height, width, 3))
