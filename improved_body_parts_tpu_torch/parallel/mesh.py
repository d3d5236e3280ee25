"""Multi-GPU scaffolding: the process group, the port's device mesh, the
collectives of the data-parallel train step, and the per-rank staging of a
process-local batch slice.

The port of ``improved_body_parts_tpu/parallel/mesh.py``. The JAX package
lays one ``jax.sharding.Mesh`` over every chip and lets XLA insert the
gradient all-reduce and the global-batch BatchNorm statistics. PyTorch's
idiom is one process per card for training (``torchrun``, or
``initialize_multihost`` with a coordinator) and one process over its local
cards for serving, so a ``Mesh`` here is:

  * for training, this rank's card, the rank, the world size and the
    process group the step's collectives run on (``train_lib``: one flat
    all-reduce of the gradients and the loss; ``BatchStats``: the
    train-mode BatchNorm statistics over the global batch, with their
    gradient flowing back through the reduction);
  * for serving, the explicit list of local devices that
    ``Predictor.predict_batch(mesh=)`` splits a batch over, one model
    replica each (a card may be listed twice: two replicas, two streams).

The data axis keeps its name (``DATA_AXIS``): its size is ``world`` times
the local devices. The JAX package's ``spatial`` axis (the image height
sharded over chips, with XLA's halo exchange around every conv) is not
ported (ROADMAP A13b).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from improved_body_parts_tpu_torch.utils.device import require_cuda

DATA_AXIS = "data"

# this process's card (or the CPU), chosen by initialize_multihost
_rank_device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: the local devices (one a rank in training; the serving
    replicas' devices); ``rank``/``world``: this process in its group;
    ``group``: the process group of the data-parallel step, None when no
    process group is initialized (then the step is the one-card step)."""
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world * len(self.devices)}

    @property
    def data_parallel(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None, backend: Optional[str] = None,
                         timeout_s: float = 600.0) -> torch.device:
    """Join the process group (the reference's
    ``init_process_group('nccl', 'env://')`` under torch.distributed.launch,
    train_distributed.py:77-83). Under ``torchrun`` the rank, world size,
    local rank and rendezvous come from ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``; otherwise from
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``. ``device`` is "cuda" by default: the card of the local
    rank is pinned (``torch.cuda.set_device``); "cuda:i" pins card i for
    every rank (ranks may share a card over gloo); "cpu" runs on the CPU.
    ``backend``: nccl on cuda and gloo on the CPU unless given. Returns this
    rank's device."""
    global _rank_device
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    elif coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the number of "
                             "processes and this process's id")
        rank, world, local = int(process_id), int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator_address}"
    else:
        raise ValueError("multi-process training needs torchrun's environment "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or a "
                         "coordinator address (--coordinator host:port)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        require_cuda()
        index = local if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants card {index}, and "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = device
    return device


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process. ``devices`` lists the local devices
    explicitly (a card may repeat); without it: this rank's device when a
    process group is initialized, else every visible card (the first
    ``n_devices``), and an error when there is none."""
    if devices is None:
        if dist.is_initialized():
            devices = [_rank_device or torch.device("cuda",
                                                    torch.cuda.current_device())]
        else:
            require_cuda()
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if dist.is_initialized():
        return Mesh(devices, dist.get_rank(), dist.get_world_size(),
                    dist.group.WORLD)
    return Mesh(devices)


def process_batch_slice(global_batch: int, rank: Optional[int] = None,
                        world: Optional[int] = None) -> slice:
    """This process's rows of a globally indexed batch (the reference's
    ``DistributedSampler``, train_distributed.py:209-211): ``rank``/
    ``world`` default to the process group's, else (0, 1)."""
    if rank is None or world is None:
        rank, world = ((dist.get_rank(), dist.get_world_size())
                       if dist.is_initialized() else (0, 1))
    per = global_batch // world
    assert per * world == global_batch, (global_batch, world)
    return slice(rank * per, (rank + 1) * per)


# ---------------------------------------------------------------------------
# the collectives of the data-parallel step
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """sum over ranks, whose backward is the sum over ranks of the
    gradients (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


class BatchStats(dict):
    """The train-mode ``bn_stats`` dict of a data-parallel step: each
    BatchNorm takes its batch statistics over the global batch of ``group``
    (``models/imhn.conv_bn``) and records them here, as ``{}`` does for
    one card."""

    def __init__(self, group):
        super().__init__()
        self.group = group


def global_var_mean(y: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per channel of (N, C, H, W) ``y`` over the
    batches of every rank: the counts and sums are all-reduced, then the
    squared deviations from the global mean (the two-pass variance the
    one-card step takes with ``torch.var_mean``). Differentiable: the
    gradient flows back through both reductions."""
    c = y.shape[1]
    count = torch.full((1,), y.numel() // c, dtype=y.dtype, device=y.device)
    sums = all_reduce_sum(torch.cat([y.sum(dim=(0, 2, 3)), count]), group)
    n = sums[c]
    mean = sums[:c] / n
    dev2 = torch.square(y - mean[None, :, None, None]).sum(dim=(0, 2, 3))
    return mean, all_reduce_sum(dev2, group) / n


@torch.no_grad()
def all_reduce_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, by ONE all-reduce of a flat
    buffer (cast to the first tensor's type); returns new tensors."""
    dt = tensors[0].dtype
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view(t.shape).to(t.dtype))
        o += t.numel()
    return out


def shutdown(mesh: Mesh, *steps) -> None:
    """Leave the data-parallel group of ``mesh`` after the last step: drop
    the CUDA graphs of ``steps`` (``train_graph.MultiStep.close``; other
    steps are passed over), wait for the card, meet the other ranks and
    destroy the group. NCCL's communicator must outlive every CUDA graph
    that captured its collectives: with a graph still alive, every rank of
    the four-card dry run waited in ``destroy_process_group`` for ever."""
    for step in steps:
        close = getattr(step, "close", None)
        if close is not None:
            close()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier()
    dist.destroy_process_group()


def warm(mesh: Mesh) -> None:
    """One eager all-reduce on the mesh's device, waited for: the
    communicator exists before a CUDA graph captures the step's
    collectives."""
    if mesh.data_parallel:
        t = torch.ones(1, device=mesh.device)
        dist.all_reduce(t, group=mesh.group)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)


# ---------------------------------------------------------------------------
# staging a process-local batch slice on this rank's device
# ---------------------------------------------------------------------------

def _device(mesh) -> torch.device:
    return mesh.device if isinstance(mesh, Mesh) else torch.device(mesh)


def _to_tensors(batch):
    """A host batch (numpy arrays or torch tensors, nested tuples) -> CPU
    tensors."""
    if isinstance(batch, (tuple, list)):
        return tuple(_to_tensors(b) for b in batch)
    return batch if isinstance(batch, torch.Tensor) else torch.from_numpy(batch)


def _map(fn, batch):
    if isinstance(batch, tuple):
        return tuple(_map(fn, b) for b in batch)
    return fn(batch)


def assemble_global_batch(mesh, batch):
    """This rank's slice of the global batch (a process-local host batch)
    on its device: the rank-local slices together are the global batch
    the data-parallel step trains on (JAX
    ``make_array_from_process_local_data``)."""
    dev = _device(mesh)
    return _map(lambda t: t.to(dev), _to_tensors(batch))


def shard_batch(mesh, batch):
    """A GLOBAL host batch -> this rank's ``process_batch_slice`` of it on
    its device."""
    batch = _to_tensors(batch)
    first = batch
    while isinstance(first, tuple):
        first = first[0]
    rank, world = ((mesh.rank, mesh.world) if isinstance(mesh, Mesh)
                   else (None, None))
    sl = process_batch_slice(first.shape[0], rank, world)
    return assemble_global_batch(mesh, _map(lambda t: t[sl], batch))


def staged_batches(mesh, host_batches: Iterable, depth: int = 2) -> Iterator:
    """Host batches (this rank's slices) -> batches on the mesh's device
    (a ``Mesh``, or a device), ``depth`` ahead: each is pinned and copied
    with ``non_blocking=True`` on a side stream while the steps before it
    run (the reference overlaps H2D with non_blocking copies,
    train_distributed.py:256-258); the consumer's stream waits on the
    copy's event. ``depth`` 0 copies in the loop. On the CPU the batches
    pass through as tensors."""
    device = _device(mesh)
    if device.type != "cuda":
        for b in host_batches:
            yield _to_tensors(b)
        return
    if depth <= 0:
        for b in host_batches:
            yield assemble_global_batch(device, b)
        return
    side = torch.cuda.Stream(device)
    pending: collections.deque = collections.deque()

    def stage(b):
        pinned = _map(lambda t: t.pin_memory(), _to_tensors(b))
        with torch.cuda.stream(side):
            dev = _map(lambda t: t.to(device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    it = iter(host_batches)
    for b in it:
        pending.append(stage(b))
        if len(pending) >= depth:
            break
    while pending:
        dev, done = pending.popleft()
        for b in it:                          # top the window up first
            pending.append(stage(b))
            break
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        _map(lambda t: t.record_stream(cur), dev)
        yield dev


def _stack(group):
    """K host batches (tuples of numpy arrays or CPU tensors, nested) ->
    one batch with a leading step axis."""
    first = group[0]
    if isinstance(first, tuple):
        return tuple(_stack([g[i] for g in group]) for i in range(len(first)))
    return torch.stack([_to_tensors(g) for g in group])


def staged_chunks(mesh, host_batches: Iterable, k: int,
                  depth: int = 2) -> Iterator:
    """``staged_batches`` for the K-steps dispatch: the host batches in
    chunks of ``k`` stacked on a leading step axis, each pinned and copied
    on the side stream ``depth`` chunks ahead (at least one). Yields
    ``(n, chunk)``; a short last chunk keeps its true length n, so the
    epoch's step count is exact."""
    def chunks():
        group = []
        for b in host_batches:
            group.append(b)
            if len(group) == k:
                yield _stack(group)
                group = []
        if group:
            yield _stack(group)

    for chunk in staged_batches(mesh, chunks(), max(depth, 1)):
        first = chunk
        while isinstance(first, tuple):
            first = first[0]
        yield len(first), chunk
