"""The metric level: train ``Canonical`` on the card with the JAX package's
round-4 recipe, score every other epoch on the held-out synthetic set, and
bring the last epoch's weights back small enough to score them elsewhere.

    # on the card: train and score (one command; the machine that trains
    # is the one that scores)
    python -m improved_body_parts_tpu_torch.tools.metric_level run \
        --work /tmp/metric --out out/metric
    # a short rehearsal of the same chain
    python -m improved_body_parts_tpu_torch.tools.metric_level run \
        --work /tmp/metric --out out/rehearsal --epochs 2 --steps-per-epoch 8 \
        --curve-epochs 0 1
    # anywhere: the weights the paired arms score, as a .pth
    python -m improved_body_parts_tpu_torch.tools.metric_level restore \
        --delta out/metric/weights_delta.bz2 --out weights.pth

``run``'s stages, each timed:

  1. ``apps.train.main`` with the JAX round-4 flags (``RECIPE``: batch 8,
     remat, the resident feed augmented on the card, 4 steps a dispatch,
     SWA from epoch 18, lr 2e-4, gradient norm 5; ``--image-size``, 512)
     and ``--keep`` = every epoch; its output also goes to
     ``<out>/train.log``.
  2. ``tools.make_synthetic_coco`` writes the held-out set (48 scenes of
     512², seed 777: the JAX curve's set) to ``<work>/syn``.
  3. ``tools.eval_curve`` over ``--curve-epochs`` and the SWA model:
     ``<out>/curve.json``.
  4. The last epoch's weights W as a delta from the trainer's init W0
     (``export_delta``): each conv and linear weight's W - W0 rounded to a
     step of a fraction of its output channel's standard deviation (int8,
     bz2; coarser where the channel's largest change needs it), every
     other tensor whole: ~50 MB at ``Canonical`` where the fp32 weights
     take 493 MB, for moving them off the machine that trained them. Its
     restored weights Ŵ (``restore_delta``: W0 + q·step,
     computed on the CPU, so every machine gets the same bits) are the
     weights of every paired arm.
  5. ``apps.evaluate`` bf16 on W and on Ŵ (their paired ΔAP says how far
     Ŵ is from W at the metric), and ``--quantize int8`` on W:
     ``<out>/val2017_port_card_{bf16,bf16_restored,int8}_results.json``.

``<out>/summary.json`` holds the per-epoch train and val loss (the
trainer's ``log``), the learning rate, loss and gradient norm of every
step the trainer printed, the epoch seconds, the held-out set's GT person
count, the curve, the delta's size, step and error, the kernels' launches
in each stage (``ops.kernels``), each stage's seconds, the bytes the run
wrote and the card's ``nvidia-smi`` name and power limit. ``run`` works on
the card unless ``--device cpu`` is given, and raises when there is none.
"""

from __future__ import annotations

import argparse
import bz2
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import sys
import time
from typing import Dict, List, Tuple

RECIPE = ["--batch-size", "8", "--remat",
          "--feed", "resident", "--resident-augment",
          "--steps-per-dispatch", "4", "--swa", "--swa-start-epoch", "18",
          "--lr", "2e-4", "--max_grad_norm", "5"]
HELD_OUT_SEED = "777"
# the delta's rounding step, as a fraction of a channel's standard
# deviation of W - W0: the finest whose file fits DELTA_BUDGET
DELTA_STEPS = (0.5, 0.75, 1.0, 1.5)
DELTA_BUDGET = 50 * 2 ** 20

_STEP = re.compile(r"^epoch (\d+) step (\d+)/(\d+) loss (\S+) lr (\S+) gnorm (\S+)$")
_EPOCH = re.compile(r"^=== epoch (\d+): train \S+ val \S+ \((\S+)s, (\d+) skipped")
_LOG = re.compile(r"^Epoch (\d+)\ttrain_loss: (\S+)\tval_loss: (\S+)$")


def parse_training(train_log: str, epoch_log: str) -> List[Dict]:
    """One row an epoch: train and val loss (the trainer's ``log``), its
    seconds and skipped batches, and every printed step's
    (step, loss, lr, grad norm) (its standard output). Raises when an
    epoch of the log has no step line or no epoch line in the output."""
    rows: Dict[int, Dict] = {}
    with open(epoch_log) as f:
        for line in f:
            m = _LOG.match(line.rstrip("\n"))
            if m:
                rows[int(m[1])] = dict(epoch=int(m[1]), train_loss=float(m[2]),
                                       val_loss=float(m[3]), steps=[])
    with open(train_log) as f:
        for line in f:
            line = line.rstrip("\n")
            m = _STEP.match(line)
            if m and int(m[1]) in rows:
                rows[int(m[1])]["steps"].append(dict(
                    step=int(m[2]), loss=float(m[4]), lr=float(m[5]),
                    grad_norm=float(m[6])))
            m = _EPOCH.match(line)
            if m and int(m[1]) in rows:
                rows[int(m[1])].update(seconds=float(m[2]), skipped=int(m[3]))
    unmatched = [e for e in sorted(rows) if not rows[e]["steps"]
                 or "seconds" not in rows[e]]
    if unmatched:
        raise ValueError(f"epochs {unmatched} of {epoch_log}: no step or epoch "
                         f"line of {train_log} matched")
    return [rows[e] for e in sorted(rows)]


# ---------------------------------------------------------------------------
# the weights as a delta from the trainer's init
# ---------------------------------------------------------------------------

def initial_weights(config: str) -> Dict:
    """W0: the state_dict ``apps.train`` starts ``config`` from (its
    ``build_model``, seed 0, drawn on the CPU), fp32, on the CPU."""
    import torch

    from improved_body_parts_tpu_torch.apps import train as train_app
    from improved_body_parts_tpu_torch.configs import get_config

    args = argparse.Namespace(tiny_model=False, remat=True, dtype="bfloat16",
                              model="imhn")
    _, model = train_app.build_model(args, get_config(config),
                                     torch.device("cpu"))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _sha(sd: Dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def _is_delta(v) -> bool:
    """Conv and linear weights travel as a delta, the rest whole."""
    return v.is_floating_point() and v.dim() >= 2


def _quantize(d, frac: float) -> Tuple:
    """(int8 q, fp32 step a channel) with d ≈ q·step: the step is ``frac``
    of the channel's standard deviation, or its largest |d| / 127 where
    that is coarser (no value is clamped)."""
    import torch

    flat = d.reshape(d.shape[0], -1)
    step = torch.maximum(flat.std(dim=1) * frac, flat.abs().amax(dim=1) / 127)
    step = torch.where(step > 0, step, torch.ones_like(step))
    q = torch.round(flat / step[:, None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(d.shape), step


def _dequantize(w0, q, step):
    return w0 + q.float() * step.reshape((-1,) + (1,) * (q.dim() - 1))


def export_delta(weights: Dict, config: str, path: str,
                 budget: int = DELTA_BUDGET) -> Dict:
    """Write ``weights`` (W) to ``path`` as a delta from
    ``initial_weights(config)`` (W0), at the finest of ``DELTA_STEPS`` whose
    file fits ``budget`` bytes; the report (step, bytes, the hashes of W0
    and of the restored Ŵ, the norms |W - W0| / |W0| and |Ŵ - W| /
    |W - W0| over the delta's tensors)."""
    import torch

    w0 = initial_weights(config)
    w = {k: v.detach().cpu().float() if v.is_floating_point() else v.cpu()
         for k, v in weights.items()}
    if sorted(w) != sorted(w0):
        raise KeyError("the weights' keys are not the config's")
    for frac in DELTA_STEPS:
        payload, restored = {}, {}
        for k, v in w.items():
            if _is_delta(v):
                q, step = _quantize(v - w0[k], frac)
                payload[k] = dict(q=q, step=step)
                restored[k] = _dequantize(w0[k], q, step)
            else:
                payload[k] = dict(whole=v)
                restored[k] = v
        buf = io.BytesIO()
        torch.save(dict(config=config, frac=frac, w0_sha=_sha(w0),
                        restored_sha=_sha(restored), tensors=payload), buf)
        blob = bz2.compress(buf.getvalue(), 9)
        if len(blob) <= budget:
            break
    else:
        raise ValueError(f"the delta takes {len(blob)} bytes at the coarsest "
                         f"step, over the budget of {budget}")
    with open(path, "wb") as f:
        f.write(blob)

    def sq(fn):
        return sum(float((fn(k) ** 2).sum()) for k in w if _is_delta(w[k]))

    moved = sq(lambda k: w[k] - w0[k])
    return dict(path=path, bytes=len(blob), step_of_std=frac,
                w0_sha=_sha(w0), restored_sha=_sha(restored),
                moved_over_w0=(moved / sq(lambda k: w0[k])) ** 0.5,
                error_over_moved=(sq(lambda k: restored[k] - w[k]) / moved) ** 0.5
                if moved else 0.0)


def restore_delta(path: str) -> Tuple[Dict, Dict]:
    """(Ŵ, report): the weights ``export_delta`` wrote, rebuilt on this
    machine's CPU; the report says whether W0 and Ŵ hash as they did where
    the delta was written."""
    import torch

    with open(path, "rb") as f:
        blob = torch.load(io.BytesIO(bz2.decompress(f.read())),
                          map_location="cpu", weights_only=True)
    w0 = initial_weights(blob["config"])
    restored = {k: (_dequantize(w0[k], t["q"], t["step"]) if "q" in t
                    else t["whole"]) for k, t in blob["tensors"].items()}
    return restored, dict(w0_same=_sha(w0) == blob["w0_sha"],
                          restored_same=_sha(restored) == blob["restored_sha"],
                          step_of_std=blob["frac"])


# ---------------------------------------------------------------------------
# the card run
# ---------------------------------------------------------------------------

class _Tee:
    """Writes to a file and to the stream it replaces."""

    def __init__(self, f, stream):
        self.f, self.stream = f, stream

    def write(self, s):
        self.f.write(s)
        return self.stream.write(s)

    def flush(self):
        self.f.flush()
        self.stream.flush()


def tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(root) for n in names)


def run(args) -> int:
    import torch

    from improved_body_parts_tpu_torch.apps import evaluate
    from improved_body_parts_tpu_torch.apps import train as train_app
    from improved_body_parts_tpu_torch.apps.demo_image import default_device
    from improved_body_parts_tpu_torch.ops import kernels
    from improved_body_parts_tpu_torch.tools import (
        eval_curve, make_synthetic_coco, multi_card,
    )
    from improved_body_parts_tpu_torch.utils import checkpoint as ckpt_lib

    device = default_device(args.device)  # no card and no --device: raise
    os.makedirs(args.out, exist_ok=True)
    ck, syn = os.path.join(args.work, "ck"), os.path.join(args.work, "syn")
    dev = ["--device", args.device] if args.device else []
    summary: Dict = dict(card=multi_card.card_line() if device.type == "cuda"
                         else str(device), seconds={}, launches={})

    def stage(name, fn):
        kernels.reset_launch_counts()
        t0 = time.time()
        print(f"--- {name}", flush=True)
        fn()
        summary["seconds"][name] = round(time.time() - t0, 1)
        summary["launches"][name] = {
            w.__name__: w.launches for w in (
                kernels.nms, kernels.fused_peaks, kernels.int8_conv,
                kernels.int8_quantize)}
        print(f"--- {name}: {summary['seconds'][name]} s, launches "
              f"{summary['launches'][name]}", flush=True)

    last = args.epochs - 1
    train_argv = (["-p", ck, "--config", args.config,
                   "--epochs", str(args.epochs),
                   "--steps-per-epoch", str(args.steps_per_epoch),
                   "--image-size", str(args.image_size),
                   "--keep", str(args.epochs)] + RECIPE + dev)
    summary["train_argv"] = train_argv
    train_log = os.path.join(args.out, "train.log")

    def train():
        with open(train_log, "w") as f, \
                contextlib.redirect_stdout(_Tee(f, sys.stdout)):
            if train_app.main(train_argv) != 0:
                raise RuntimeError("apps.train failed")

    stage("train", train)
    shutil.copy(os.path.join(ck, "log"), os.path.join(args.out, "epoch_log"))
    summary["training"] = parse_training(train_log, os.path.join(ck, "log"))
    summary["work_bytes_after_train"] = tree_bytes(args.work)

    stage("held_out_set", lambda: make_synthetic_coco.main(
        ["--out-dir", syn, "--n-images", str(args.n_images),
         "--size", str(args.image_size), "--seed", HELD_OUT_SEED]))
    gt_json, images = os.path.join(syn, "gt.json"), os.path.join(syn, "images")
    with open(gt_json) as f:
        gt = json.load(f)
    summary["held_out"] = dict(images=len(gt["images"]),
                               gt_persons=len(gt["annotations"]))

    curve_json = os.path.join(args.out, "curve.json")
    stage("curve", lambda: eval_curve.main(
        ["--ckpt-root", ck, "--image-dir", images, "--gt-json", gt_json,
         "--config", args.config, "--swa", "--out-json", curve_json, "--epochs"]
        + [str(e) for e in args.curve_epochs] + dev))
    with open(curve_json) as f:
        summary["curve"] = json.load(f)

    weights = ckpt_lib.checkpoint_path(os.path.join(ck, "pth"), last)
    restored_pth = os.path.join(args.work, "restored.pth")

    def delta():
        summary["delta"] = export_delta(
            ckpt_lib.load_reference_pth(weights), args.config,
            os.path.join(args.out, "weights_delta.bz2"))
        restored, report = restore_delta(summary["delta"]["path"])
        if not report["restored_same"]:
            raise AssertionError("the delta does not restore to the weights "
                                 "it was written from")
        torch.save({"weights": restored}, restored_pth)

    stage("delta", delta)
    for arm, path, extra in (("bf16", weights, []),
                             ("bf16_restored", restored_pth, []),
                             ("int8", weights, ["--quantize", "int8"])):
        def score(arm=arm, path=path, extra=extra):
            if evaluate.main(["--checkpoint", path, "--config", args.config,
                              "--image-dir", images, "--gt-json", gt_json,
                              "--results-dir", args.out,
                              "--dump-name", f"port_card_{arm}"]
                             + extra + dev) != 0:
                raise RuntimeError(f"apps.evaluate failed on {arm}")
        stage(f"evaluate_{arm}", score)

    summary["work_bytes"] = tree_bytes(args.work)
    summary["out_bytes"] = tree_bytes(args.out)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in (
        "card", "seconds", "launches", "held_out", "delta", "work_bytes",
        "out_bytes")}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="train and score (on the card)")
    r.add_argument("--work", required=True,
                   help="checkpoints and the held-out set (not kept)")
    r.add_argument("--out", required=True,
                   help="logs, curve, detections, the delta, summary")
    r.add_argument("--epochs", type=int, default=24)
    r.add_argument("--steps-per-epoch", type=int, default=100)
    r.add_argument("--curve-epochs", type=int, nargs="+",
                   default=list(range(1, 24, 2)))
    r.add_argument("--n-images", type=int, default=48,
                   help="held-out scenes (the JAX curve's: 48)")
    r.add_argument("--image-size", type=int, default=512,
                   help="training and held-out image size (the recipe's: 512)")
    r.add_argument("--config", default="Canonical")
    r.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the card)")
    s = sub.add_parser("restore", help="the delta's weights as a .pth")
    s.add_argument("--delta", required=True)
    s.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run(args)

    import torch
    restored, report = restore_delta(args.delta)
    torch.save({"weights": restored}, args.out)
    print(json.dumps(report))
    return 0 if report["restored_same"] else 1


if __name__ == "__main__":
    sys.exit(main())
