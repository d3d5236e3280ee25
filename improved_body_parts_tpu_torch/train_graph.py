"""K train steps a dispatch: a CUDA graph of the captured train step.

The JAX package runs K optimizer steps in one device call (``lax.scan``,
``train_lib.make_multi_train_step``, ``--steps-per-dispatch``), so the
host's fixed cost of a dispatch is paid once for K steps. The port's step
is ~18,000 kernels launched one by one from the host, which the card
outruns (PERF.md section 5). Here the step is captured once in a CUDA graph
and replayed: a dispatch of n <= K steps is n times (copy step k's inputs
into the graph's static inputs, replay, copy the metrics out), a few
launches a step, and a short last chunk replays fewer times with no second
graph.

On the CPU ``MultiStep`` is the plain version: n eager steps in a loop.
The route follows the device of the state's parameters; a capture or
replay that fails raises, and no path falls back to eager steps.

What capture needs from the step, and where it gets it:
  * no copy from the host and no host sync inside the step: the learning
    rate is a 0-d tensor, the loss's weights and the GT renderer's grid are
    made once per device (``losses._weights``, ``DeviceHeatmapper.constants``),
    the warp's fill too (``ops/warp._fill``);
  * the warm-up PyTorch needs before a capture (cuDNN plans, cuBLAS
    handles, lazy inits) runs real steps: the state they move (parameters,
    momentum, BN statistics, the step count) is copied before and restored
    in place after, so the first replayed step starts from the state given;
  * the graph reads and writes the state's tensors where they lie: keep
    their addresses (``train_lib.load_payload`` and ``swa_swap`` copy in
    place); a model moved with ``.to()`` after the capture needs a new
    ``MultiStep``;
  * memory: the warm-up's cached blocks are returned before the capture,
    and graphs given one ``pool`` (the train-mode and the SWA epochs'
    graphs in ``apps/train.py``) reuse each other's temporaries;
  * remat (``torch.utils.checkpoint``, non-reentrant) captures too: the
    network draws no random numbers, so it keeps no RNG state to restore;
  * a data-parallel step (``mesh=`` with an NCCL group) captures its
    collectives inside the graph: every communicator the step may use (the
    mesh's group, and on a spatial mesh its spatial and data subgroups) is
    made by one eager all-reduce each first (``parallel/mesh.warm``), the
    warm-up steps run on the current stream (no collective on a side
    stream), and the capture lets the process group's watchdog thread
    query the card (``capture_error_mode="thread_local"``). A gloo group
    cannot be captured: its steps run eagerly, as on the CPU
    (``eager_reason``);
  * a step sharded into bands of rows (``parallel/spatial.py``) captures
    its halo exchanges, row gathers and spatial sums with the rest: each is
    one all-reduce over the spatial group of a buffer allocated inside the
    step (from the graph's pool under capture), with every size read from
    shapes, never from a tensor's value. The exchanges a step are counted
    by Python code, which runs at the capture and not at a replay: the
    capture records them a step (``GraphedStep.exchanges``) and each replay
    adds them to ``parallel/spatial.counts``, on the host.

tests/test_torch_train_graph.py holds replayed steps bit for bit against
eager steps on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from improved_body_parts_tpu_torch.parallel import spatial
from improved_body_parts_tpu_torch.parallel.mesh import warm

WARMUP_STEPS = 2


def _flat(tree) -> list:
    """The tensors of nested tuples, lists and dicts (dicts by key)."""
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure around the tensors of ``leaves`` (an iterator)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _state_tensors(state) -> list:
    """Every tensor a train step writes: parameters, BN buffers, momentum
    buffers and the step count."""
    return (list(state.model.parameters()) + list(state.model.buffers())
            + list(state.momentum.values()) + [state.step])


class GraphedStep:
    """One train step ``step_fn(state, *fixed, *inputs, lr)`` captured in a
    CUDA graph on ``state``'s card, for the shapes of ``example`` (one
    step's inputs) and the tensors of ``fixed`` (e.g. the resident store),
    which the graph reads where they lie. ``replay_chunk`` runs it."""

    def __init__(self, step_fn: Callable, state, fixed: tuple, example: tuple,
                 lr: torch.Tensor, pool=None, mesh=None):
        dev = lr.device
        data_parallel = mesh is not None and mesh.data_parallel
        self.state = state
        self.fixed_ptrs = [t.data_ptr() for t in _flat(fixed)]
        self.inputs = [t.clone() for t in _flat(example)]
        self.lr = lr.clone()
        args = _rebuild(example, iter(self.inputs))

        saved = [t.detach().clone() for t in _state_tensors(state)]
        cur = torch.cuda.current_stream(dev)
        side = cur if data_parallel else torch.cuda.Stream(dev)
        if data_parallel:
            warm(mesh)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step_fn(state, *fixed, *args, self.lr)
        cur.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(_state_tensors(state), saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        mode = "thread_local" if data_parallel else "global"
        before = dict(spatial.counts)
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode=mode):
            m = step_fn(state, *fixed, *args, self.lr)
            dt = m["loss"].dtype
            self.metrics = torch.stack([m["loss"], m["grad_norm"].to(dt),
                                        m["skipped"].to(dt)])
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        # the exchanges of one step, recorded and not yet run: a replay runs
        # (and counts) them
        self.exchanges = {k: spatial.counts[k] - before[k] for k in before}
        spatial.counts.update(before)

    def replay_chunk(self, state, fixed: tuple, chunk: tuple,
                     lrs: torch.Tensor) -> torch.Tensor:
        """Replay the step once for each of the n slots of ``chunk`` (one
        step's inputs with a leading axis n) and ``lrs`` (n,); returns the
        (n, 3) metrics (loss, grad_norm, skipped) on the card."""
        if state is not self.state:
            raise ValueError("the CUDA graph was captured on another train state")
        if [t.data_ptr() for t in _flat(fixed)] != self.fixed_ptrs:
            raise ValueError("the CUDA graph was captured on other fixed "
                             "inputs (the resident store)")
        leaves = _flat(chunk)
        n = lrs.shape[0]
        for s, t in zip(self.inputs, leaves):
            if t.shape != (n, *s.shape) or t.dtype != s.dtype:
                raise ValueError(f"a chunk input of {tuple(t.shape)} {t.dtype} "
                                 f"for the graph's ({n}, {tuple(s.shape)}) "
                                 f"{s.dtype}")
        out = torch.empty((n, 3), dtype=self.metrics.dtype,
                          device=self.metrics.device)
        for k in range(n):
            for s, t in zip(self.inputs, leaves):
                s.copy_(t[k])
            self.lr.copy_(lrs[k])
            self.graph.replay()
            out[k].copy_(self.metrics)
        for key, n_step in self.exchanges.items():
            spatial.counts[key] += n * n_step
        return out


class MultiStep:
    """n steps of ``step_fn(state, *fixed, *inputs, lr) -> metrics`` a call:
    ``multi(state, *fixed, *stacked, lrs)``, where the first ``n_fixed``
    arguments pass to every step as they are, every other input carries a
    leading step axis of length n and ``lrs`` is (n,); returns the metrics
    stacked (n,). On the card the step is captured in a CUDA graph at the
    first call (``GraphedStep``, in ``pool``) and replayed; on the CPU the
    steps run eagerly (the plain version). ``graphed`` is the capture, or
    None before the first call on the card. ``mesh``: the data-parallel
    mesh of the step, if any (a spatial one too: bands of rows are
    captured as whole images are); ``eager_reason`` says why steps on the
    card run eagerly (a gloo group), else None."""

    def __init__(self, step_fn: Callable, n_fixed: int = 0, pool=None,
                 mesh=None):
        self.step_fn = step_fn
        self.n_fixed = n_fixed
        self.pool = pool
        self.mesh = mesh
        self.graphed: Optional[GraphedStep] = None
        self.eager_reason = None
        if (mesh is not None and mesh.data_parallel
                and mesh.device.type == "cuda" and mesh.backend == "gloo"):
            self.eager_reason = ("the gloo process group cannot be captured "
                                 "in a CUDA graph: K steps a dispatch run "
                                 "eagerly")

    def __call__(self, state, *args) -> dict:
        fixed, stacked = args[:self.n_fixed], args[self.n_fixed:-1]
        dev = next(state.model.parameters()).device
        lrs = torch.as_tensor(args[-1]).to(dev, non_blocking=True)
        stacked = _rebuild(stacked, iter([t.to(dev, non_blocking=True)
                                          for t in _flat(stacked)]))
        n = lrs.shape[0]
        if dev.type != "cuda" or self.eager_reason:
            outs = [self.step_fn(state, *fixed,
                                 *_rebuild(stacked, iter([t[k] for t in _flat(stacked)])),
                                 lrs[k])
                    for k in range(n)]
            return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
        if self.graphed is None:
            first = _rebuild(stacked, iter([t[0] for t in _flat(stacked)]))
            self.graphed = GraphedStep(self.step_fn, state, fixed, first,
                                       lrs[0], self.pool, self.mesh)
        out = self.graphed.replay_chunk(state, fixed, stacked, lrs)
        return {"loss": out[:, 0], "grad_norm": out[:, 1], "skipped": out[:, 2]}

    def close(self) -> None:
        """Drop the captured graph and its memory; a later call captures
        anew. Under NCCL the graph holds the communicator's captured
        collectives, and it must be gone before the group is destroyed
        (``parallel/mesh.shutdown``): it is reset here, whatever else still
        holds the ``GraphedStep``."""
        if self.graphed is not None:
            self.graphed.graph.reset()
        self.graphed = None
