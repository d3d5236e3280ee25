"""The port's entry points (``apps/evaluate.py``, ``apps/demo_image.py``)
against the JAX package's evaluation loop, on a small synthetic COCO set
(``apps.evaluate.synthetic_coco``, written to disk as PNG) with the tiny
model of tests/test_torch_predict.py: the same fp32 weights reach the port
through a reference-layout ``.pth`` and JAX through
``convert_torch_state_dict``.

Detections: the same images, people and order; keypoints and scores 1e-4
absolute (fp32 on both sides, as test_torch_predict.py). AP: equal.
"""

import argparse
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demo_image as jdemo
import evaluate as jevaluate
from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu.utils.oks_eval import KeypointEval
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.apps import demo_image as tdemo
from improved_body_parts_tpu_torch.apps import evaluate as tevaluate
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from tests.test_torch_predict import (  # noqa: F401  (autouse fixture)
    ATOL, SIZE, _config, single_torch_thread,
)

CONFIG_NAME = "TorchAppsTiny"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(.pth path, JAX Predictor) over the same fp32 weights; the tiny
    config is registered as ``CONFIG_NAME`` for the CLIs."""
    config = _config()
    g = torch.Generator().manual_seed(0)
    model = PoseNet(config.model, compute_dtype=torch.float32, generator=g)
    with torch.no_grad():   # weights large enough to give a few peaks
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, 0.1, generator=g)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    sd = model.state_dict()
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"weights": {"module." + k: v for k, v in sd.items()},
                "epoch": 0}, path)
    params, stats = convert_torch_state_dict(sd)
    jconfig = _config(jconfigs)
    jpred = jpredict.Predictor(create_model(jconfig.model, dtype=jnp.float32),
                               {"params": params, "batch_stats": stats}, jconfig)
    mp = pytest.MonkeyPatch()
    mp.setitem(tconfigs.CONFIGS, CONFIG_NAME, config)
    yield path, jpred
    mp.undo()


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """4 synthetic scenes at 128^2 as an image dir + gt.json, written by
    tools/make_synthetic_coco.py, and the frames read back."""
    import tools.make_synthetic_coco as msc
    out = str(tmp_path_factory.mktemp("coco"))
    msc.main(["--out-dir", out, "--n-images", "4", "--size", str(SIZE),
              "--seed", "11"])
    with open(os.path.join(out, "gt.json")) as f:
        gt = json.load(f)
    img_dir = os.path.join(out, "images")
    frames = [(im["id"], cv2.imread(os.path.join(img_dir, im["file_name"])))
              for im in gt["images"]]
    return frames, gt, img_dir, os.path.join(out, "gt.json")


def test_synthetic_coco_matches_the_tool(coco):
    """The in-memory set the card's smoke run evaluates is the set
    tools/make_synthetic_coco.py writes to disk."""
    frames, gt, _, _ = coco
    got_frames, got_gt = tevaluate.synthetic_coco(4, size=SIZE, seed=11)
    assert json.loads(json.dumps(got_gt)) == gt
    for (gi, gimg), (wi, wimg) in zip(got_frames, frames):
        assert gi == wi
        np.testing.assert_array_equal(gimg, wimg)


def _port_predictor(path, refine="bicubic"):
    return tdemo.build_predictor(path, CONFIG_NAME, refine, device=CPU,
                                 dtype=torch.float32)


def _jax_loop(jpred, frames, scale_search=None, letterbox=False):
    """The JAX evaluate.py per-image loop (its non-pipeline branch)."""
    outputs = []
    for image_id, img in frames:
        scales = None
        if scale_search:
            scales = (tuple(scale_search) if letterbox else
                      tevaluate.image_scales(scale_search,
                                             jpred.config.infer.boxsize,
                                             img.shape[0], 4))
        kps, scores, _ = jpred.predict_skeletons(img, use_cpp=True,
                                                 scales=scales,
                                                 fixed_size=letterbox)
        jevaluate.append_result(image_id, kps, scores, outputs)
    return outputs


def _assert_detections_match(got, want):
    assert [d["image_id"] for d in got] == [d["image_id"] for d in want]
    assert len(got) > 0, "the comparison saw no detections"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=ATOL)
        assert abs(g["score"] - w["score"]) <= ATOL


def _ap(gt, outputs, ids):
    return KeypointEval(gt, outputs, img_ids=ids).run(print_fn=lambda *a: None)


def test_evaluate_cli_scale_search_matches_jax(tiny, coco, tmp_path, capsys):
    """python -m ...apps.evaluate --image-dir --gt-json --scale-search
    0.5 1 1.5 2, on the CPU, against the JAX Predictor loop."""
    path, jpred = tiny
    frames, gt, img_dir, gt_json = coco
    rc = tevaluate.main([
        "--checkpoint", path, "--config", CONFIG_NAME, "--image-dir", img_dir,
        "--gt-json", gt_json, "--scale-search", "0.5", "1", "1.5", "2",
        "--run_cpp", "--device", "cpu", "--dtype", "float32",
        "--results-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "AP=" in out and "FPS" in out
    with open(tmp_path / "val2017_torch_imhn_results.json") as f:
        got = json.load(f)
    want = _jax_loop(jpred, frames, scale_search=(0.5, 1, 1.5, 2))
    _assert_detections_match(got, want)
    ids = [i for i, _ in frames]
    np.testing.assert_array_equal(_ap(gt, got, ids), _ap(gt, want, ids))


@pytest.mark.parametrize("letterbox", [False, True], ids=["bucket", "letterbox"])
def test_evaluate_frames_matches_jax(tiny, coco, letterbox):
    path, jpred = tiny
    frames, gt, _, _ = coco
    run = tevaluate.evaluate_frames(_port_predictor(path), frames,
                                    letterbox=letterbox, run_cpp=True)
    want = _jax_loop(jpred, frames, letterbox=letterbox)
    _assert_detections_match(run.outputs, want)
    assert run.image_ids == [i for i, _ in frames] and run.seconds > 0
    np.testing.assert_array_equal(_ap(gt, run.outputs, run.image_ids),
                                  _ap(gt, want, run.image_ids))


def test_evaluate_pipeline_matches_per_image_letterbox(tiny, coco):
    """--letterbox --pipeline 2 (PipelinedServer, TTA fused into the batch)
    gives what the per-image letterbox loop gives."""
    path, _ = tiny
    frames, _, _, _ = coco
    pred = _port_predictor(path)
    kw = dict(letterbox=True, scale_search=(0.5, 1.0), run_cpp=True)
    piped = tevaluate.evaluate_frames(pred, frames, pipeline=2,
                                      pipeline_batch=2, **kw)
    single = tevaluate.evaluate_frames(pred, frames, **kw)
    assert piped.image_ids == single.image_ids
    _assert_detections_match(piped.outputs, single.outputs)
    with pytest.raises(ValueError):
        tevaluate.evaluate_frames(pred, frames, pipeline=2)


def test_evaluate_cli_coco_layout_pipeline(tiny, coco, tmp_path, capsys):
    """--coco-dir (annotations/ + val2017/, scored without pycocotools)
    with --letterbox --pipeline: the CLI writes what evaluate_frames gives."""
    import shutil
    path, _ = tiny
    frames, gt, img_dir, gt_json = coco
    root = tmp_path / "coco"
    os.makedirs(root / "annotations")
    shutil.copy(gt_json, root / "annotations" / "person_keypoints_val2017.json")
    shutil.copytree(img_dir, root / "val2017")
    rc = tevaluate.main([
        "--checkpoint", path, "--config", CONFIG_NAME, "--coco-dir", str(root),
        "--letterbox", "--pipeline", "2", "--pipeline-batch", "2", "--run_cpp",
        "--rotation-search", "0", "15", "--device", "cpu", "--dtype",
        "float32", "--results-dir", str(tmp_path), "--dump-name", "piped"])
    assert rc == 0
    assert "evaluating 4 images" in capsys.readouterr().out
    with open(tmp_path / "val2017_piped_results.json") as f:
        got = json.load(f)
    want = tevaluate.evaluate_frames(
        _port_predictor(path), frames, letterbox=True, pipeline=2,
        pipeline_batch=2, rotation_search=(0.0, 15.0), run_cpp=True)
    _assert_detections_match(got, want.outputs)


def test_evaluate_cli_skips_listed_but_unreadable_files(tiny, coco, tmp_path,
                                                        capsys):
    """--coco-dir whose annotations list a file that is absent and one that
    is a directory: both are reported and skipped (as cv2.imread's None was),
    and the rest is evaluated as evaluate_frames evaluates it."""
    import shutil
    path, _ = tiny
    frames, gt, img_dir, gt_json = coco
    root = tmp_path / "coco"
    os.makedirs(root / "annotations")
    shutil.copy(gt_json, root / "annotations" / "person_keypoints_val2017.json")
    shutil.copytree(img_dir, root / "val2017")
    names = {im["id"]: im["file_name"] for im in gt["images"]}
    gone, folder = frames[1][0], frames[2][0]
    os.remove(root / "val2017" / names[gone])
    os.remove(root / "val2017" / names[folder])
    os.makedirs(root / "val2017" / names[folder])
    rc = tevaluate.main([
        "--checkpoint", path, "--config", CONFIG_NAME, "--coco-dir", str(root),
        "--run_cpp", "--device", "cpu", "--dtype", "float32",
        "--results-dir", str(tmp_path), "--dump-name", "gaps"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "evaluating 4 images" in out
    for image_id in (gone, folder):
        assert f"skip unreadable {root / 'val2017' / names[image_id]}" in out
    with open(tmp_path / "val2017_gaps_results.json") as f:
        got = json.load(f)
    kept = [f for f in frames if f[0] not in (gone, folder)]
    want = tevaluate.evaluate_frames(_port_predictor(path), kept, run_cpp=True)
    _assert_detections_match(got, want.outputs)


def test_build_predictor_loads_pth_and_refuses_the_rest(tiny, tmp_path):
    path, jpred = tiny
    pred = _port_predictor(path)
    sd = pred.model.state_dict()
    want = torch.load(path, weights_only=False)["weights"]
    for k, v in sd.items():
        assert torch.equal(v, want["module." + k]), k
    with pytest.raises(ValueError, match="export_to_torch_state_dict"):
        tdemo.build_predictor(str(tmp_path), CONFIG_NAME, device=CPU)
    with pytest.raises(ValueError, match="quantize mode"):
        tdemo.build_predictor(path, CONFIG_NAME, device=CPU, quantize="int4")


def test_default_device_is_the_card(monkeypatch):
    """Without a card the apps raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tdemo.default_device(None)
    assert tdemo.default_device("cpu") == CPU
    assert tevaluate.default_device is tdemo.default_device


@pytest.mark.parametrize("app", ["evaluate", "demo_image"])
def test_apps_without_a_card_or_device_raise(monkeypatch, coco, tmp_path, app):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, img_dir, gt_json = coco
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        if app == "evaluate":
            tevaluate.main(["--image-dir", img_dir, "--gt-json", gt_json,
                            "--results-dir", str(tmp_path)])
        else:
            tdemo.main(["--synthetic", "--output", str(tmp_path / "out.jpg")])


@pytest.mark.parametrize("app", ["evaluate", "demo_image"])
def test_apps_quantize_int8_raises(tiny, coco, tmp_path, app, monkeypatch):
    """--quantize int8 works (tests/test_torch_quantize.py) except on the
    legacy-block family, which JAX refuses too."""
    path, _ = tiny
    _, _, img_dir, gt_json = coco
    legacy = tconfigs.CanonicalConfig(width=SIZE, height=SIZE, model=tconfigs.ModelConfig(
        nstack=2, inp_dim=32, increase=16, legacy_blocks=True, cross_stack=False))
    monkeypatch.setitem(tconfigs.CONFIGS, "LegacyTiny", legacy)
    common = ["--checkpoint", "", "--config", "LegacyTiny", "--quantize",
              "int8", "--device", "cpu"]
    with pytest.raises(ValueError, match="live PoseNet"):
        if app == "evaluate":
            tevaluate.main(common + ["--image-dir", img_dir, "--gt-json",
                                     gt_json, "--results-dir", str(tmp_path)])
        else:
            image = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
            tdemo.main(common + ["--image", image,
                                 "--output", str(tmp_path / "out.jpg")])


def test_demo_synthetic_finds_two_people(tmp_path):
    kps, scores = tdemo.run_synthetic("Canonical", device=CPU)
    assert len(kps) == 2 and len(scores) == 2
    # the scene's noses, at stride-map cells (20, 10) and (44, 12), land
    # within a pixel of their image coordinates
    noses = np.array(sorted(k[0, :2].tolist() for k in kps))
    np.testing.assert_allclose(noses, [[81.5, 41.5], [177.5, 49.5]], atol=1.0)
    out = str(tmp_path / "synthetic.jpg")
    assert tdemo.main(["--synthetic", "--output", out, "--device", "cpu",
                       "--run_cpp"]) == 0
    assert cv2.imread(out) is not None
    # the JAX demo's own --synthetic run finds the same two people
    assert jdemo.run_synthetic(argparse.Namespace(
        config="Canonical", run_cpp=False, output=out)) == 0


def test_demo_image_with_tta_and_maps(tiny, coco, tmp_path):
    path, _ = tiny
    _, _, img_dir, _ = coco
    image = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
    out = tmp_path / "demo.jpg"
    assert tdemo.main([
        "--image", image, "--output", str(out), "--checkpoint", path,
        "--config", CONFIG_NAME, "--scale-search", "0.5", "1",
        "--rotation-search", "0", "10", "--ellipse", "--show-maps",
        "--device", "cpu", "--dtype", "float32", "--run_cpp"]) == 0
    assert cv2.imread(str(out)).shape == (SIZE, SIZE, 3)
    assert len(os.listdir(tmp_path)) > 1          # the map overlays


# ---------------------------------------------------------------------------
# apps/train.py
# ---------------------------------------------------------------------------

def test_train_cli_writes_log_and_a_checkpoint_the_apps_serve(tmp_path, capsys):
    """python -m ...apps.train --device cpu --tiny-model for one epoch of 2
    steps writes its log and epoch checkpoint, and build_predictor serves
    the checkpoint's weights (the tiny model registered as a config)."""
    from improved_body_parts_tpu_torch.apps import train as ttrain
    out = tmp_path / "ck"
    assert ttrain.main(["--device", "cpu", "--tiny-model", "--epochs", "1",
                        "--steps-per-epoch", "2", "--batch-size", "1",
                        "--image-size", "64", "-p", str(out), "--workers", "2",
                        "--print-freq", "1"]) == 0
    assert "=== epoch 0: train" in capsys.readouterr().out
    assert (out / "log").read_text().startswith("Epoch 0\ttrain_loss: ")
    path = out / "pth" / "epoch_0.pth"
    saved = torch.load(path, weights_only=True)
    assert {"weights", "optimizer_weight", "train_loss", "epoch", "step",
            "swa_params", "swa_count"} <= set(saved)
    assert saved["epoch"] == 0 and saved["step"] == 2
    tiny = tconfigs.CanonicalConfig(width=64, height=64, model=tconfigs.ModelConfig(
        nstack=2, inp_dim=64, increase=32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfigs.CONFIGS, "TrainedTiny", tiny)
        pred = tdemo.build_predictor(str(path), "TrainedTiny", device=CPU,
                                     dtype=torch.float32)
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, saved["weights"][k]), k
    kps, scores = pred.predict_batch(np.zeros((1, 64, 64, 3), np.uint8))[0]
    assert kps.shape[1:] == (18, 3)


def test_train_cli_resume_swa_and_compact_feed(tmp_path):
    from improved_body_parts_tpu_torch.apps import train as ttrain
    out = str(tmp_path / "ck")
    common = ["--device", "cpu", "--tiny-model", "--steps-per-epoch", "1",
              "--batch-size", "2", "--image-size", "64", "-p", out,
              "--workers", "0", "--dtype", "float32"]
    assert ttrain.main(common + ["--epochs", "1"]) == 0
    assert ttrain.main(common + ["--epochs", "2", "--resume", "--swa",
                                 "--swa-freq", "1", "--feed", "compact-u8"]) == 0
    saved = torch.load(os.path.join(out, "pth", "epoch_1.pth"), weights_only=True)
    assert saved["step"] == 2 and saved["swa_count"] == 1
    swa = torch.load(os.path.join(out, "pth_swa", "epoch_1.pth"), weights_only=True)
    # the published model is the average (one snapshot: the epoch-1 weights)
    for k, v in swa["weights"].items():
        if k in saved["swa_params"]:
            assert torch.equal(v, saved["swa_params"][k]), k
    assert open(os.path.join(out, "log")).read().count("Epoch") == 2


def test_train_cli_needs_a_card_and_refuses_unported_modes(monkeypatch, tmp_path):
    from improved_body_parts_tpu_torch.apps import train as ttrain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        ttrain.main(["--tiny-model", "-p", str(tmp_path)])
    # --multihost needs torchrun's environment or a coordinator
    with pytest.raises(ValueError, match="coordinator"):
        ttrain.main(["--device", "cpu", "-p", str(tmp_path), "--multihost"])
