"""The metric level's command chain (``tools/metric_level``) at the tiny
size on the CPU, and the JAX arm that the full-width pairing runs.

  * ``run`` (``apps.train`` with the JAX round-4 flags for one epoch, the
    held-out set, the curve, the delta, the three ``apps.evaluate`` arms)
    writes what the paired arms need, and the delta restores to the same
    bits here.
  * The JAX package's ``load_for_inference`` reads the trainer's
    ``pth/epoch_0.pth``: the JAX fp32 network gives the port's outputs on a
    held-out PNG (2e-4, tests/test_torch_parity.py's tolerance).
  * The pairing on the delta's weights: the JAX fp32 evaluation loop
    (``jax_arm``) and ``apps.evaluate --device cpu --dtype float32`` on
    the ``.pth`` of ``metric_level restore`` score the same
    ``make_synthetic_coco`` PNGs: the same detections (keypoints within
    1e-3 px, scores within 1e-4) and a paired |ΔAP| ≤ 1e-4 from
    ``tools.bootstrap_ap``. The tiny model one epoch from the reference
    init draws near-flat maps, whose peaks tie within rounding; so the
    weights that travel are the trained ones with every conv and linear
    weight redrawn N(0, 0.1) and the BatchNorm statistics spread (as
    tests/test_torch_tools.py's ``_random_model``), at that file's
    thresholds (0.05), and the comparison must see detections.

Run as a script, ``jax_arm`` is the J-fp32 arm at full width::

    python -m tests.test_torch_metric_level --checkpoint W.pth \\
        --image-dir syn/images --gt-json syn/gt.json --out J.json

and with ``--bf16-maps N``, ``bf16_maps`` holds each package's bf16
network against its fp32 one on the first N frames instead (JSON on
standard output; ``--layers`` adds ``bf16_layers``, the same at each
stack's modules)::

    python -m tests.test_torch_metric_level --checkpoint W.pth \\
        --image-dir syn/images --bf16-maps 6 [--layers]
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
from typing import Dict, List

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jevaluate
from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.utils.checkpoint import load_for_inference
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.apps import evaluate
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.tools import bootstrap_ap, metric_level
from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

NAME = "MetricLevelTiny"
SIZE = 64
KP_TOL = 1e-3            # px, fp32 on both sides
SCORE_TOL = 1e-4
DELTA_AP_TOL = 1e-4


def _config(cfgs):
    """The tiny model at SIZE² (tests/test_torch_predict.py's, at 64²)."""
    cfg = cfgs.CanonicalConfig(width=SIZE, height=SIZE, model=cfgs.ModelConfig(
        nstack=2, inp_dim=32, increase=16, se_reduction=8))
    return dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, boxsize=SIZE, thre1=0.05, thre2=0.05, min_person_score=0.0,
        min_person_parts=1))


def jax_arm(checkpoint: str, config, image_dir: str, gt_json: str,
            dtype=jnp.float32) -> List[Dict]:
    """The JAX ``evaluate.py`` loop over ``image_dir`` (its sequential
    path: the GT's files in sorted order, ``cv2.imread``,
    ``predict_skeletons``, ``append_result``) on a ``Predictor`` built as
    ``demo_image.build_predictor`` builds it, but in ``dtype`` (the CLI's
    is bf16): the COCO detections."""
    with open(gt_json) as f:
        by_name = {im["file_name"]: im["id"] for im in json.load(f)["images"]}
    jmodel = jimhn.create_model(config.model, dtype=dtype)
    pred = jpredict.Predictor(jmodel, load_for_inference(checkpoint, jmodel),
                              config, refine="bicubic")
    dets: List[Dict] = []
    for name in sorted(os.listdir(image_dir)):
        if name in by_name:
            img = cv2.imread(os.path.join(image_dir, name))
            kps, scores, _ = pred.predict_skeletons(img)
            jevaluate.append_result(by_name[name], kps, scores, dets)
    return dets


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """``metric_level run`` on the CPU at the tiny size: (work, out)."""
    root = tmp_path_factory.mktemp("metric")
    work, out = str(root / "work"), str(root / "out")
    mp = pytest.MonkeyPatch()
    mp.setitem(tconfigs.CONFIGS, NAME, _config(tconfigs))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = metric_level.main([
            "run", "--work", work, "--out", out, "--epochs", "1",
            "--steps-per-epoch", "4", "--curve-epochs", "0", "--n-images", "3",
            "--image-size", str(SIZE), "--config", NAME, "--device", "cpu"])
    assert rc == 0
    yield work, out
    mp.undo()


def test_run_writes_what_the_paired_arms_need(chain, tmp_path):
    work, out = chain
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    argv = summary["train_argv"]
    assert argv[argv.index("--keep") + 1] == "1"
    assert " ".join(metric_level.RECIPE) in " ".join(argv)
    (epoch,) = summary["training"]
    assert epoch["epoch"] == 0 and np.isfinite([epoch["train_loss"],
                                                epoch["val_loss"]]).all()
    assert epoch["steps"] and all(s["lr"] > 0 for s in epoch["steps"])
    # an epoch whose step lines went unmatched is an error, not an empty row
    with open(os.path.join(out, "train.log")) as f:
        no_steps = [ln for ln in f if not ln.startswith("epoch ")]
    (tmp_path / "train.log").write_text("".join(no_steps))
    with pytest.raises(ValueError, match=r"epochs \[0\]"):
        metric_level.parse_training(str(tmp_path / "train.log"),
                                    os.path.join(out, "epoch_log"))
    assert summary["held_out"] == {"images": 3, "gt_persons": 4}
    assert [r["arm"] for r in summary["curve"]] == ["epoch0"]   # SWA from 18
    assert os.path.isfile(os.path.join(work, "ck", "pth", "epoch_0.pth"))
    for arm in ("bf16", "bf16_restored", "int8"):
        with open(os.path.join(out, f"val2017_port_card_{arm}_results.json")) as f:
            assert isinstance(json.load(f), list)
    # the delta: small, and restored to the same bits here
    assert 0 < summary["delta"]["bytes"] <= metric_level.DELTA_BUDGET
    restored, report = metric_level.restore_delta(summary["delta"]["path"])
    assert report["w0_same"] and report["restored_same"]
    assert report["step_of_std"] == summary["delta"]["step_of_std"]
    assert 0 < summary["delta"]["error_over_moved"] < 0.5


def test_jax_reads_the_trainers_pth(chain):
    work, _ = chain
    path = os.path.join(work, "ck", "pth", "epoch_0.pth")
    port = PoseNet(_config(tconfigs).model, compute_dtype=torch.float32)
    port.load_state_dict(load_reference_pth(path), strict=True)
    jmodel = jimhn.create_model(_config(jconfigs).model, dtype=jnp.float32)
    variables = load_for_inference(path, jmodel)
    img = cv2.imread(os.path.join(work, "syn", "images", "synthetic_000000.png"))
    x = (img[None] / 255.0).astype(np.float32)
    with torch.no_grad():
        want = port.eval()(torch.from_numpy(x))
    got = jmodel.apply(variables, jnp.asarray(x), train=False)
    for t in range(len(want)):
        for s in range(len(want[t])):
            np.testing.assert_allclose(np.asarray(got[t][s]), want[t][s].numpy(),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"stack {t} scale {s}")


def _peaky(weights: Dict, seed: int = 0) -> Dict:
    """``weights`` with every conv and linear weight redrawn N(0, 0.1) and
    the BatchNorm statistics spread: maps with clear peaks."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in weights.items():
        if v.is_floating_point() and v.dim() >= 2:
            v = torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_mean"):
            v = torch.randn(v.shape, generator=g) * 0.2
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) * 1.5 + 0.5
        out[k] = v
    return out


def test_port_and_jax_fp32_score_the_same_pngs(chain, tmp_path):
    work, _ = chain
    syn = os.path.join(work, "syn")
    img_dir, gt_json = os.path.join(syn, "images"), os.path.join(syn, "gt.json")
    delta = str(tmp_path / "delta.bz2")
    metric_level.export_delta(_peaky(load_reference_pth(os.path.join(
        work, "ck", "pth", "epoch_0.pth"))), NAME, delta)
    path = str(tmp_path / "restored.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        assert metric_level.main(["restore", "--delta", delta, "--out", path]) == 0
        assert evaluate.main([
            "--checkpoint", path, "--config", NAME, "--image-dir", img_dir,
            "--gt-json", gt_json, "--device", "cpu", "--dtype", "float32",
            "--results-dir", str(tmp_path), "--dump-name", "port_fp32"]) == 0
    port_json = str(tmp_path / "val2017_port_fp32_results.json")
    with open(port_json) as f:
        port = json.load(f)
    jdets = jax_arm(path, _config(jconfigs), img_dir, gt_json)
    jax_json = str(tmp_path / "jax_fp32.json")
    with open(jax_json, "w") as f:
        json.dump(jdets, f)

    assert len(port) == len(jdets) > 0, "the comparison saw no detections"
    for a, b in zip(sorted(port, key=lambda d: (d["image_id"], -d["score"])),
                    sorted(jdets, key=lambda d: (d["image_id"], -d["score"]))):
        assert a["image_id"] == b["image_id"]
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=0,
                                   atol=KP_TOL)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bootstrap_ap.main(["--gt-json", gt_json, "--dets", port_json,
                                  jax_json, "--draws", "50"]) == 0
    delta_ap = json.loads(buf.getvalue().splitlines()[-1])["delta_ap"]
    assert abs(delta_ap["point"]) <= DELTA_AP_TOL
    assert max(abs(x) for x in delta_ap["ci"]) <= DELTA_AP_TOL


def bf16_maps(checkpoint: str, image_dir: str, n: int,
              name: str = "Canonical") -> Dict:
    """The last stack's finest maps of the port's and the JAX package's
    networks on the first ``n`` frames of ``image_dir`` (``/ 255``, no
    padding), bf16 and fp32: each package's bf16 - fp32 (relative L2, mean,
    mean and largest |d|), the two bf16 maps' gap, and the fp32 maps' gap."""
    import jax

    names = sorted(os.listdir(image_dir))[:n]
    x = np.stack([cv2.imread(os.path.join(image_dir, f))
                  for f in names]).astype(np.float32) / 255.0
    state = load_reference_pth(checkpoint)
    maps = {}
    for dt, tdt, jdt in (("fp32", torch.float32, jnp.float32),
                         ("bf16", torch.bfloat16, jnp.bfloat16)):
        port = PoseNet(tconfigs.get_config(name).model, compute_dtype=tdt)
        port.load_state_dict(state, strict=True)
        with torch.no_grad():
            maps["port", dt] = np.concatenate([
                port.eval()(torch.from_numpy(x[i:i + 2]))[-1][0].float().numpy()
                for i in range(0, n, 2)])
        jmodel = jimhn.create_model(jconfigs.get_config(name).model, dtype=jdt)
        variables = load_for_inference(checkpoint, jmodel)
        fwd = jax.jit(lambda v, a: jmodel.apply(v, a, train=False)[-1][0])
        maps["jax", dt] = np.concatenate([
            np.asarray(fwd(variables, jnp.asarray(x[i:i + 2])), np.float32)
            for i in range(0, n, 2)])
    ref = np.linalg.norm(maps["port", "fp32"])
    out = {"frames": names}
    for pkg in ("port", "jax"):
        d = maps[pkg, "bf16"] - maps[pkg, "fp32"]
        out[f"{pkg}_bf16_minus_fp32"] = dict(
            rel_l2=float(np.linalg.norm(d) / np.linalg.norm(maps[pkg, "fp32"])),
            mean=float(d.mean()), mean_abs=float(np.abs(d).mean()),
            max_abs=float(np.abs(d).max()))
    out["port_bf16_minus_jax_bf16_rel_l2"] = float(
        np.linalg.norm(maps["port", "bf16"] - maps["jax", "bf16"]) / ref)
    out["port_fp32_minus_jax_fp32_max_abs"] = float(
        np.abs(maps["port", "fp32"] - maps["jax", "fp32"]).max())
    return out


def bf16_layers(checkpoint: str, x: np.ndarray, name: str = "Canonical") -> Dict:
    """Relative L2 of bf16 against fp32 at the outputs of the stem, each
    stack's hourglass (its 5 scales), its scale-0 trunk and its scale-0
    head, in each package on images ``x`` (NHWC, [0, 1]): the port's
    forward hooks against the JAX model's captured intermediates, applied
    op by op (no jit, so XLA fuses no rounding away)."""
    state = load_reference_pth(checkpoint)
    nstack = tconfigs.get_config(name).model.nstack

    def port(dt):
        m = PoseNet(tconfigs.get_config(name).model, compute_dtype=dt)
        m.load_state_dict(state, strict=True)
        cap = {}

        def hook(key):
            def fn(mod, inp, out):
                outs = out if isinstance(out, (list, tuple)) else [out]
                cap[key] = [o.float().permute(0, 2, 3, 1).numpy() for o in outs]
            return fn
        m.pre.register_forward_hook(hook("pre"))
        for t in range(nstack):
            m.hourglass[t].register_forward_hook(hook(f"hg{t}"))
            m.features[t].before_regress[0][2].register_forward_hook(
                hook(f"features{t}_s0"))
            m.outs[t][0].register_forward_hook(hook(f"out{t}_s0"))
        with torch.no_grad():
            m.eval()(torch.from_numpy(x))
        return cap

    def jax(dt):
        jmodel = jimhn.create_model(jconfigs.get_config(name).model, dtype=dt)
        _, st = jmodel.apply(load_for_inference(checkpoint, jmodel), jnp.asarray(x),
                             train=False, capture_intermediates=True,
                             mutable=["intermediates"])
        it = st["intermediates"]
        cap = {"pre": [it["pre"]["__call__"][0]]}
        for t in range(nstack):
            cap[f"hg{t}"] = list(it[f"hg{t}"]["__call__"][0])
            cap[f"features{t}_s0"] = [it[f"features{t}"]["s0_se"]["__call__"][0]]
            cap[f"out{t}_s0"] = [it[f"out{t}_s0"]["__call__"][0]]
        return {k: [np.asarray(a, np.float32) for a in v] for k, v in cap.items()}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    p32, p16 = port(torch.float32), port(torch.bfloat16)
    j32, j16 = jax(jnp.float32), jax(jnp.bfloat16)
    return {f"{k}[{i}]": dict(port=rel(p16[k][i], p32[k][i]),
                              jax=rel(j16[k][i], j32[k][i]))
            for k in p32 for i in range(len(p32[k]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The J-fp32 arm: the JAX "
                                 "package's evaluation loop on an fp32 model")
    ap.add_argument("--checkpoint", required=True, help="a reference .pth")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--gt-json")
    ap.add_argument("--out", help="the detections json")
    ap.add_argument("--config", default="Canonical")
    ap.add_argument("--bf16-maps", type=int, default=0, metavar="N",
                    help="instead: bf16 against fp32 maps, both packages, "
                    "on the first N frames")
    ap.add_argument("--layers", action="store_true",
                    help="with --bf16-maps: also at each stack's modules")
    args = ap.parse_args(argv)
    if args.bf16_maps:
        out = bf16_maps(args.checkpoint, args.image_dir, args.bf16_maps,
                        args.config)
        if args.layers:
            names = out["frames"]
            x = np.stack([cv2.imread(os.path.join(args.image_dir, f))
                          for f in names]).astype(np.float32) / 255.0
            out["bf16_layers"] = bf16_layers(args.checkpoint, x, args.config)
        print(json.dumps(out))
        return 0
    if not (args.gt_json and args.out):
        ap.error("--gt-json and --out are required for the J-fp32 arm")
    dets = jax_arm(args.checkpoint, jconfigs.get_config(args.config),
                   args.image_dir, args.gt_json)
    with open(args.out, "w") as f:
        json.dump(dets, f)
    print(f"wrote {len(dets)} detections to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
