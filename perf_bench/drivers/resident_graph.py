"""Training on the program's resident feed, K steps a CUDA-graph dispatch.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "resident_graph"``):
``batch_size`` (a card's), ``steps_per_dispatch`` (K), ``records_per_second``
(the store holds this many records a second of the window, plus the
set-up's, so a record repeats within a window only beyond that rate),
``people`` ([min, max] a record), ``max_people`` (the joints' slots),
``dtype`` (the network's compute type), ``init`` (``weights.INITS``).

Set-up renders the store on the card from the seed (uint8, as the
program's ``data/resident.ResidentStore.device_arrays`` holds it), plans
every step's records (a permutation, no record twice until the store is
spent) and augmentation (flip, rotation, scale, shift) from the seed, and
builds ONE train state: ``train_lib.make_multi_resident_train_step`` on
the program's ``PoseNet``. That state takes its first step alone and its
next two as one dispatch, through the window's own call (the graph is
captured at the first), then one whole dispatch warms the window's shape.
The window replays dispatches of K steps, one in flight behind the one the
host enqueues, until ``--seconds`` have passed, then waits for the last:
the rate is every image of every dispatch over that whole time.

The comparison (``compare``) follows the first three steps with the plain
fp32 reference from the same weights, records, maps and learning rates:
the stem's output in the first step's forward, in units of the same
stem's bf16 rounding; each step's loss, the first step's gradient (the program's,
worked out from its momentum after one step: m1 = g1 + wd * p0) and the
parameters' change after three steps, both by the worst leaf. The window's
own steps must be finite and none skipped.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from perf_bench import core, scenes, weights
from perf_bench.reference import model as ref_model
from perf_bench.reference import train as ref_train
from perf_bench.timers import DeviceTrace, Spans

CHECKED_STEPS = 3
# candidates computed by the reference in the program's place: the
# precision control, the fault of half the batch left out, and the
# reference on images moved by one part in 2^20 (a witness of how far a
# rounding-level change moves each number)
REFERENCE_CANDIDATES = ("fp8", "half_batch", "jitter")


def plans(job: core.Job, n_records: int, joints: List[np.ndarray], steps: int):
    """(idx (steps, B), inv_m (steps, B, 2, 3), joints (steps, B, P, 18, 3))
    numpy, from the seed."""
    tr, cfg = job.traffic, job.ref_config
    B = tr["batch_size"]
    rng = np.random.RandomState((job.seed + 2) % 2 ** 32)
    aug_rng = random.Random(job.seed + 3)
    order = np.concatenate([rng.permutation(n_records)
                            for _ in range(-(-steps * B // n_records))])
    idx = order[:steps * B].reshape(steps, B).astype(np.int64)
    inv_m = np.empty((steps, B, 2, 3), np.float32)
    warped = np.empty((steps, B, tr["max_people"], 18, 3), np.float32)
    for s in range(steps):
        for b in range(B):
            inv_m[s, b], warped[s, b] = scenes.plan_one(
                joints[idx[s, b]], cfg.height, cfg.aug, aug_rng, tr["max_people"])
    return idx, inv_m, warped


def run(job: core.Job) -> core.Outcome:
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.models.imhn import PoseNet

    tr, cfg, dev = job.traffic, job.ref_config, job.device
    # the set-up's parts, each by the time it ended
    parts = {"process_and_imports": time.perf_counter()}
    B, K = tr["batch_size"], tr["steps_per_dispatch"]
    size = cfg.height
    rng = np.random.RandomState(job.seed % 2 ** 32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(job.seed % 2 ** 63)
    warm_steps = CHECKED_STEPS + K
    n_records = int(np.ceil(tr["records_per_second"] * job.seconds)) + warm_steps * B
    joints = scenes.draw_people(n_records, size, tuple(tr["people"]), rng)
    store = {"images": scenes.paint(joints, size, gen, dev)}
    parts["store"] = time.perf_counter()
    max_steps = warm_steps + K * int(np.ceil(2 * tr["records_per_second"]
                                             * job.seconds / (B * K)) + 1)
    idx, inv_m, warped = plans(job, n_records, joints, max_steps)
    parts["plans"] = time.perf_counter()
    plan = [torch.from_numpy(x).to(dev) for x in (idx, inv_m, warped)]
    lrs = torch.full((max_steps,), cfg.train.learning_rate, device=dev)

    def chunk(lo, hi):
        # past the planned steps the plans repeat: a program faster than
        # the mix's rate sees records again, and never runs out
        if hi <= max_steps:
            return [x[lo:hi] for x in plan] + [lrs[lo:hi]]
        at = torch.arange(lo, hi, device=dev) % max_steps
        return [x.index_select(0, at) for x in plan] + [lrs.index_select(0, at)]

    spec = weights.spec(ref_model.build(job.config["model"], device="meta"))
    spans = Spans()
    program = job.candidate not in REFERENCE_CANDIDATES
    if program:
        prog_cfg = job.program_config
        model = PoseNet(prog_cfg.model, device="meta", compute_dtype=core.dtype(tr["dtype"]))
        model = model.to_empty(device=dev)
        model.load_state_dict(weights.make(spec, job.seed, dev, tr["init"]),
                              strict=True)
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        state = train_lib.create_train_state(model, prog_cfg.train)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        multi = train_lib.make_multi_resident_train_step(model, prog_cfg, pool=pool)
        if job.candidate == "frozen":          # the fault: state unchanged
            multi = _frozen(multi, state)
        parts["model_and_state"] = time.perf_counter()
        names = [k for k, _ in model.named_parameters()]

        # -- the checked steps: step 1 alone, steps 2-3 as one dispatch -----
        # a hook keeps the stem's output tensor (a reference, no copy: the
        # captured graph's kernels are the window's) and is gone before
        # step 2; the tensor holds step 1's value once that step has run
        seen = {}
        hook = model.pre.register_forward_hook(
            lambda mod, args, out: seen.__setitem__("stem", out))
        m1 = multi(state, store, *chunk(0, 1))
        hook.remove()
        stem1 = seen["stem"].detach().to(torch.float32, copy=True)
        moms1 = {k: state.momentum[k].detach().clone() for k in names}
        parts["step_1_and_capture"] = time.perf_counter()
        m23 = multi(state, store, *chunk(1, CHECKED_STEPS))
        params3 = {k: p.detach().clone() for k, p in model.named_parameters()}
        prog_losses = torch.cat([m1["loss"], m23["loss"]]).float().cpu().tolist()
        # -- the window's shape, once ----------------------------------------
        multi(state, store, *chunk(CHECKED_STEPS, warm_steps))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        parts["steps_2_to_%d" % warm_steps] = time.perf_counter()

        # -- the window -------------------------------------------------------
        trace = DeviceTrace(spans) if job.trace else None
        if trace is not None:
            trace.start()
        t_open = time.perf_counter()
        metrics, pending, step = [], None, warm_steps
        while True:
            with spans.span("dispatch"):
                out = multi(state, store, *chunk(step, step + K))
                done = torch.cuda.Event() if dev.type == "cuda" else None
                if done is not None:
                    done.record()
            metrics.append(out)
            step += K
            if pending is not None:
                with spans.span("wait"):
                    pending.synchronize()
            pending = done
            if time.perf_counter() - t_open >= job.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_close = time.perf_counter()
        trace_result = trace.stop() if trace is not None else None
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        steps_done = step - warm_steps
        losses = torch.cat([m["loss"] for m in metrics]).float()
        skipped = torch.cat([m["skipped"] for m in metrics]).float()
        window_nonfinite = int((~torch.isfinite(losses)).sum())
        window_skipped = int((skipped > 0).sum())
        end_to_end = {"train_images_per_s": steps_done * B * job.chips / (t_close - t_open),
                      "setup_s": t_open - job.setup_origin}
        job.setup_parts.update(core.setup_parts(job.setup_origin, parts, t_open))
        layer = dict(steps=steps_done, batch_size=B, chips=job.chips,
                     window_s=t_close - t_open, image_size=size,
                     model=job.config["model"])
        wd = cfg.train.weight_decay
        p0 = weights.make(spec, job.seed, dev, tr["init"])
        cand = dict(losses=prog_losses, stem=stem1,
                    grad={k: moms1[k] - wd * p0[k] for k in names},
                    change={k: params3[k] - p0[k] for k in names})
        del p0, moms1, params3, multi, state, model, pool, seen
    else:
        end_to_end, layer, trace_result, memory_peak = {}, {}, None, 0
        steps_done, window_nonfinite, window_skipped = 0, 0, 0
        cand = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(job, spec, store, chunk, cand)
    checks += [core.Check("window_nonfinite_losses", float(window_nonfinite), 0.0),
               core.Check("window_skipped_steps", float(window_skipped), 0.0)]
    return core.Outcome(attempted=steps_done + warm_steps, failed=0,
                        end_to_end=end_to_end, layer=layer, checks=checks,
                        memory_peak_bytes=memory_peak, trace=trace_result)


def _frozen(multi, state):
    """``multi`` with every tensor of the state put back after each call."""
    saved = [t.detach().clone() for t in
             list(state.model.parameters()) + list(state.momentum.values())]

    def call(*args):
        out = multi(*args)
        with torch.no_grad():
            for t, s in zip(list(state.model.parameters())
                            + list(state.momentum.values()), saved):
                t.copy_(s)
        return out
    return call


def reference_steps(job: core.Job, spec, store, chunk, lower=None,
                    half: bool = False, jitter: float = 0.0,
                    unit: bool = False) -> Dict:
    """The plain step from the seed's weights over the first three steps,
    on the same store and plans: losses, the first step's stem output, the
    first gradient, the change of the parameters; with ``unit``, also the
    first step's stem output computed in bf16 (``stem_bf16``)."""
    dev, cfg = job.device, job.ref_config
    model = ref_model.build(job.config["model"], device="meta").to_empty(device=dev)
    model.load_state_dict(weights.make(spec, job.seed, dev, job.traffic["init"]))
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    momentum = {k: torch.zeros_like(p) for k, p in p0.items()}
    losses, grad, stem, stem_bf16 = [], None, None, None
    for s in range(CHECKED_STEPS):
        idx, inv_m, warped, lr = (x[0] for x in chunk(s, s + 1))
        if half:
            n = idx.shape[0] // 2
            idx, inv_m, warped = idx[:n], inv_m[:n], warped[:n]
        if s == 0 and unit:
            stem_bf16 = ref_train.forward_stem(model, store, idx, inv_m, cfg,
                                               ref_model.bf16_round)
        out = ref_train.train_step(model, momentum, store, idx, inv_m, warped,
                                   float(lr), cfg, lower, jitter)
        losses.append(float(out["loss"]))
        if s == 0:
            grad, stem = out["grads"], out["stem"]
    change = {k: p.detach() - p0[k] for k, p in model.named_parameters()}
    return dict(losses=losses, grad=grad, change=change, stem=stem,
                stem_bf16=stem_bf16)


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keys):
    """Each leaf's gap of norms, over the larger of that leaf's norm and the
    median leaf's norm (reference side); and the three worst leaves (name,
    gap, reference norm, program norm)."""
    keys = list(keys)
    wn = torch.stack([torch.linalg.vector_norm(want[k].double()) for k in keys])
    gn = torch.stack([torch.linalg.vector_norm(got[k].double()) for k in keys])
    gap = (gn - wn).abs() / torch.maximum(wn, wn.median())
    order = torch.argsort(gap, descending=True)[:3].tolist()
    return gap, [(keys[i], float(gap[i]), float(wn[i]), float(gn[i])) for i in order]


@torch.no_grad()
def _gaps(cand: Dict, ref: Dict):
    """The numbers compared, and what else the comparison saw.
    ``stem_gap_vs_bf16``: the largest, over the batch's images, of the gap
    of the first step's stem output from the fp32 stem's (L2 over the
    image), in units of the gap of the same stem computed in bf16 on the
    same image: the forward's rounding, which the sums of the loss and the
    gradients average away. (Deeper, the train-mode forward at a random
    init amplifies any rounding until every precision's gap is of the map's
    own size, so a later map cannot tell bf16 from fp8.) ``loss1_gap``: the first step's loss,
    relative. ``heads_grad_gap``: the
    first gradient of the last stack's output heads, the norm of the
    difference over the reference's norm: those leaves are one product
    away from the loss, so their gradient carries the forward's rounding
    and not the backward's chaos. ``grad_median_gap`` and
    ``change_median_gap``: the median leaf's gap of norms (over the larger
    of that leaf's norm and the median leaf's) of the first gradient and of
    the change after three steps. The worst leaf's gaps and the later
    losses swing from seed to seed in sound runs (PERF.md): only printed."""
    names = list(ref["grad"])
    gnorm = {k: float(torch.linalg.vector_norm(ref["grad"][k].double())) for k in names}
    median = float(np.median(list(gnorm.values())))
    # leaves whose reference gradient is nought to rounding move under the
    # optimizer by round-off alone: left out of the change by this rule
    moving = [k for k in names if gnorm[k] >= 1e-3 * median]
    losses = [abs(a - b) / abs(b) for a, b in zip(cand["losses"], ref["losses"])]
    grad, grad_worst = _leaf_gaps(cand["grad"], ref["grad"], names)
    change, change_worst = _leaf_gaps(cand["change"], ref["change"], moving)
    last = max(int(k.split(".")[1]) for k in names if k.startswith("outs."))
    heads = [k for k in names if k.startswith(f"outs.{last}.")]
    num = sum(float(torch.sum((cand["grad"][k].double() - ref["grad"][k].double()) ** 2))
              for k in heads)
    den = sum(float(torch.sum(ref["grad"][k].double() ** 2)) for k in heads)
    got = cand["stem"].double()
    n = got.shape[0]                 # half a batch where half is left out
    want, low = ref["stem"][:n].double(), ref["stem_bf16"][:n].double()

    def l2(t):
        return torch.linalg.vector_norm(t.flatten(1), dim=1)
    stem_gap = l2(got - want) / l2(low - want)
    return (dict(stem_gap_vs_bf16=float(stem_gap.max()), loss1_gap=losses[0],
                 heads_grad_gap=(num / den) ** 0.5,
                 grad_median_gap=float(grad.median()),
                 change_median_gap=float(change.median())),
            dict(stem_gap_vs_bf16_median=float(stem_gap.median()),
                 stem_rel_l2_max=float((l2(got - want) / l2(want)).max()),
                 loss_gaps=losses, grad_worst_leaf=grad_worst,
                 change_worst_leaf=change_worst, leaves=len(names),
                 moving=len(moving)))


def compare(job: core.Job, spec, store, chunk, cand) -> List[core.Check]:
    dev = job.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference_steps(job, spec, store, chunk, unit=True)
    if cand is None:
        cand = reference_steps(job, spec, store, chunk,
                               lower=ref_model.fp8_round if job.candidate == "fp8" else None,
                               half=job.candidate == "half_batch",
                               jitter=2.0 ** -20 if job.candidate == "jitter" else 0.0)
    gaps, worst = _gaps(cand, ref)
    job.diagnostics.update(worst)
    lim = job.limits
    return [core.Check(k, v, lim[k]) for k, v in gaps.items()]
