"""The port's measurement and evaluation tools (``tools/stress_grouping``,
``profile_postproc``, ``bootstrap_ap``, ``make_synthetic_coco``,
``export_quantized``, ``eval_curve``, ``e2e_trained_smoke``) against the
JAX package's tools, on the CPU, with the tiny model of
tests/test_torch_predict.py (nstack 2, inp_dim 32) at 128² in fp32.

  * ``make_crowd_scene``: the JAX tool's arrays, bit for bit; the grouping
    on them finds the same people, keypoints within 1e-3 px.
  * ``profile_postproc``: its stages compose to ``Predictor._postprocess``'s
    packed buffer exactly (the same operations on the same inputs).
  * ``bootstrap_ap``, ``make_synthetic_coco``: the JAX tool's output
    exactly (the same seeds, the same evaluator and renderer; the PNGs
    decode to the same pixels, their bytes differ as cv2 writes JAX's).
  * ``export_quantized``: the int8 parameters of JAX ``quantize_model`` on
    the same ``.pth`` and calibration batches at test_torch_quantize.py's
    tolerances (``w_scale`` and ``bias`` 1e-6 relative, ``a_scale`` 1e-5);
    the file serves bit for bit as the in-process PTQ.
  * ``eval_curve``: on two epochs' ``.pth`` (the ``apps.train`` layout) and
    an SWA one, the rows of ``curve`` on an fp32 predictor equal JAX's
    ``Predictor`` + ``KeypointEval`` on the same files; AP held equal, as
    tests/test_torch_apps.py holds it. The CLI (bf16) gives well-formed rows.
  * ``e2e_trained_smoke``: the JAX tool's matched counts, and its mean
    joint errors within 1e-3 px, from ``score_scenes`` on an fp32
    predictor; the CLI (bf16) prints a line a scene and exits on its verdict.
"""

import json
import os
import re
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jevaluate
import tools.bootstrap_ap as jbootstrap
import tools.e2e_trained_smoke as je2e
import tools.make_synthetic_coco as jmsc
import tools.stress_grouping as jstress
from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.models import quantize as jqz
from improved_body_parts_tpu.ops import group as jgroup
from improved_body_parts_tpu.ops.limbs import (
    connections_to_numpy as jconnections_to_numpy,
    score_connections as jscore_connections,
    select_connections as jselect_connections,
)
from improved_body_parts_tpu.ops.peaks import find_peaks as jfind_peaks
from improved_body_parts_tpu.utils.checkpoint import load_for_inference
from improved_body_parts_tpu.utils.oks_eval import KeypointEval as JKeypointEval
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.infer.predict import Predictor, pack_results
from improved_body_parts_tpu_torch.models import quantize as qz
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.ops import group
from improved_body_parts_tpu_torch.tools import (
    bootstrap_ap, e2e_trained_smoke, eval_curve, export_quantized,
    make_synthetic_coco, profile_postproc, stress_grouping,
)
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt_lib
from improved_body_parts_tpu_torch.utils import imageio
from improved_body_parts_tpu_torch.utils.checkpoint import qstate_from_flax
from tests.test_torch_predict import (  # noqa: F401  (autouse fixture)
    SIZE, _config, single_torch_thread,
)

NAME = "TorchToolsTiny"
CPU = torch.device("cpu")
KP_TOL = 1e-3          # px: fp32 on both sides


# ---------------------------------------------------------------------------
# crowd scenes and the grouping
# ---------------------------------------------------------------------------

def _jax_people(paf, heat):
    """The JAX tool's ``run_scene`` path up to the people, on the CPU."""
    icfg = jconfigs.CanonicalConfig().infer
    peaks = jfind_peaks(jnp.asarray(heat), thre=icfg.thre1,
                        max_peaks=icfg.max_peaks, stride=4)
    cand = jscore_connections(jnp.asarray(paf), peaks.xy, peaks.score,
                              peaks.valid, jnp.float32(512.0),
                              mid_num=icfg.mid_num, stride=4, thre2=icfg.thre2,
                              connect_ration=icfg.connect_ration)
    connected = jconnections_to_numpy(jselect_connections(cand, peaks.valid), peaks)
    cands = jgroup.build_joint_candidates(np.asarray(peaks.xy),
                                          np.asarray(peaks.score),
                                          np.asarray(peaks.valid))
    return jgroup.humans_to_keypoints(*jgroup.find_humans(connected, cands, icfg))


@pytest.mark.parametrize("n", [2, 8, 20])
def test_crowd_scene_and_its_people_match_jax(n):
    got = stress_grouping.make_crowd_scene(n, seed=n)
    want = jstress.make_crowd_scene(n, seed=n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    paf, heat, _ = got
    peaks, connected = stress_grouping.scene_tables(paf, heat, CPU)
    cands = group.build_joint_candidates(peaks.xy, peaks.score, peaks.valid)
    kps, scores = group.humans_to_keypoints(*group.find_humans(
        connected, cands, tconfigs.CanonicalConfig().infer))
    wkps, wscores = _jax_people(paf, heat)
    assert len(kps) == len(wkps) == n
    np.testing.assert_allclose(kps, wkps, rtol=0, atol=KP_TOL)
    np.testing.assert_allclose(scores, wscores, rtol=0, atol=KP_TOL)


def test_run_scene_counts_match_jax():
    timing = {"group_numpy_ms", "group_cpp_ms"}
    for n in (2, 8):
        got = stress_grouping.run_scene(n, 1, CPU)
        want = jstress.run_scene(n, 1)
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in timing} == \
            {k: v for k, v in want.items() if k not in timing}
        assert got["persons_found"] == n


def test_profile_postproc_stages_compose_to_postprocess():
    config = tconfigs.CanonicalConfig()
    paf, heat, _ = stress_grouping.make_crowd_scene(8)
    h = torch.from_numpy(heat)[None]
    p = torch.from_numpy(paf)[None]
    img_h = torch.full((1,), 512.0)
    st = profile_postproc.stages(config)
    with torch.inference_mode():
        peaks, conns = st["full postproc"](h, p, img_h)
        avg = torch.cat([p, h, torch.zeros(1, 128, 128, 2)], dim=-1)
        want = Predictor(None, config, device=CPU)._postprocess(avg, img_h)[0]
        assert torch.equal(pack_results(peaks, conns), want)
        # each shorter stage is a prefix of the same computation
        alone = st["find_peaks(+refine)"](h, p, img_h)
        fused = st["find_peaks FUSED"](h, p, img_h)
        for a, b in zip(alone, peaks):
            assert torch.equal(a, b)
        # the fused kernel's table: the same peaks (empty slots are not read)
        v = peaks.valid
        assert torch.equal(fused.valid, v) and torch.equal(fused.n_raw, peaks.n_raw)
        assert torch.equal(fused.xy[v], peaks.xy[v])
        assert torch.equal(fused.score[v], peaks.score[v])
        scores, idx = st["nms+topk"](h, p, img_h)
        assert torch.equal(scores > 0, peaks.valid)
        nms = st["nms"](h, p, img_h).reshape(1, 18, -1)
        assert torch.equal(torch.gather(nms, -1, idx), scores)
    rows = profile_postproc.profile(CPU, hw=32, iters=1)
    assert list(rows)[-3:] == ["-> topk alone", "-> refine alone",
                               "-> limbs+select alone"]
    assert len(profile_postproc.table_lines(rows, CPU, 32, 32)) == len(rows) + 1


# ---------------------------------------------------------------------------
# AP bootstrap and the synthetic COCO set
# ---------------------------------------------------------------------------

def test_bootstrap_ap_matches_jax(tmp_path, capsys):
    from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco
    _, gt = synthetic_coco(6, size=128, seed=11)
    paths = [str(tmp_path / "gt.json")]
    with open(paths[0], "w") as f:
        json.dump(gt, f)
    for arm, noise in (("a", 2.0), ("b", 5.0)):
        rng = np.random.RandomState(len(arm) + int(noise))
        dets = []
        for a in gt["annotations"]:
            kps = np.asarray(a["keypoints"], np.float64).reshape(17, 3)
            kps[:, :2] += rng.normal(0, noise, (17, 2))
            dets.append({"image_id": a["image_id"], "category_id": 1,
                         "keypoints": kps.reshape(-1).tolist(),
                         "score": float(rng.rand())})
        paths.append(str(tmp_path / f"{arm}.json"))
        with open(paths[-1], "w") as f:
            json.dump(dets, f)
    argv = ["--gt-json", paths[0], "--dets", *paths[1:], "--draws", "12",
            "--seed", "3"]
    assert bootstrap_ap.main(argv) == 0
    got = capsys.readouterr().out
    jbootstrap.main(argv)
    want = capsys.readouterr().out
    assert got == want
    out = json.loads(got.strip().splitlines()[-1])
    assert out["draws"] == 12 and "delta_ap" in out


def test_make_synthetic_coco_matches_jax(tmp_path):
    argv = ["--n-images", "3", "--size", "96", "--sizes", "96", "128",
            "--seed", "5", "--max-people", "2"]
    make_synthetic_coco.main(["--out-dir", str(tmp_path / "port"), *argv])
    jmsc.main(["--out-dir", str(tmp_path / "jax"), *argv])
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d / "images")) == [
            f"synthetic_{i:06d}.png" for i in range(3)]
    with open(tmp_path / "port" / "gt.json") as f, \
            open(tmp_path / "jax" / "gt.json") as g:
        assert json.load(f) == json.load(g)
    # the port writes its PNGs with utils/imageio, the JAX tool with cv2: the
    # files' bytes differ (filters, zlib level), the images they hold do not
    for name in os.listdir(tmp_path / "jax" / "images"):
        want = cv2.imread(str(tmp_path / "jax" / "images" / name))
        got = tmp_path / "port" / "images" / name
        assert np.array_equal(cv2.imread(str(got)), want)
        assert np.array_equal(imageio.imread(got), want)


# ---------------------------------------------------------------------------
# checkpoints of the apps.train layout, and the JAX side over them
# ---------------------------------------------------------------------------

def _random_model(seed):
    """The tiny fp32 PoseNet, weights large enough to give a few peaks."""
    config = _config()
    g = torch.Generator().manual_seed(seed)
    model = PoseNet(config.model, compute_dtype=torch.float32, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, 0.1, generator=g)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.eval()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A training run's checkpoints as ``apps.train`` writes them: epochs 0
    and 1 in ``pth/``, the average in ``pth_swa/``; and the tiny config
    registered as ``NAME``."""
    root = tmp_path_factory.mktemp("run")
    config = _config()
    for epoch, seed, sub in ((0, 0, "pth"), (1, 1, "pth"), (1, 2, "pth_swa")):
        state = train_lib.create_train_state(_random_model(seed), config.train)
        ckpt_lib.save_train_state(str(root / sub), train_lib.state_payload(
            state, config.train, epoch=epoch), step=epoch)
    mp = pytest.MonkeyPatch()
    mp.setitem(tconfigs.CONFIGS, NAME, config)
    mp.setitem(jconfigs.CONFIGS, NAME, _config(jconfigs))
    yield str(root)
    mp.undo()


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco.main(["--out-dir", out, "--n-images", "3", "--size",
                              str(SIZE), "--seed", "11"])
    with open(os.path.join(out, "gt.json")) as f:
        gt = json.load(f)
    img_dir = os.path.join(out, "images")
    frames = [(im["id"], cv2.imread(os.path.join(img_dir, im["file_name"])))
              for im in gt["images"]]
    return frames, gt, img_dir, os.path.join(out, "gt.json")


@pytest.fixture(scope="module")
def jax_predictor():
    """One JAX fp32 Predictor of the tiny config; arms swap its variables."""
    jconfig = _config(jconfigs)
    jmodel = jimhn.create_model(jconfig.model, dtype=jnp.float32)
    return jmodel, jconfig, {}


def _jax_pred(jax_predictor, path):
    jmodel, jconfig, cache = jax_predictor
    variables = load_for_inference(path, jmodel)
    if "pred" not in cache:
        cache["pred"] = jpredict.Predictor(jmodel, variables, jconfig)
    else:
        cache["pred"].variables = jax.device_put(variables)
    return cache["pred"]


def test_eval_curve_rows_match_jax(run_dir, coco, jax_predictor, tmp_path):
    frames, gt, img_dir, gt_json = coco
    # the CLI (bf16, as it serves) on one arm: a well-formed row
    out = str(tmp_path / "curve.json")
    assert eval_curve.main([
        "--ckpt-root", run_dir, "--image-dir", img_dir, "--gt-json", gt_json,
        "--epochs", "1", "--config", NAME, "--device", "cpu",
        "--out-json", out]) == 0
    with open(out) as f:
        cli_rows = json.load(f)
    assert [r["arm"] for r in cli_rows] == ["epoch1"]
    assert set(cli_rows[0]) == {"arm", "ap", "ap50", "ap75", "ar", "n_dets", "seconds"}
    # the curve on an fp32 predictor, every arm held against JAX's
    pred = Predictor(_random_model(0), _config(), device=CPU)
    rows = eval_curve.curve(pred, eval_curve.arms(run_dir, [0, 1, 5], swa=True),
                            frames, gt, log=lambda s: None)
    assert [r["arm"] for r in rows] == ["epoch0", "epoch1", "swa"]   # 5: none
    paths = [ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth"), 0),
             ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth"), 1),
             ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth_swa"), 1)]
    for row, path in zip(rows, paths):
        jpred = _jax_pred(jax_predictor, path)
        dets = []
        for image_id, img in frames:
            kps, scores, _ = jpred.predict_skeletons(img)
            jevaluate.append_result(image_id, kps, scores, dets)
        stats = JKeypointEval(gt, dets, img_ids=[i for i, _ in frames]).run(
            print_fn=None)
        assert set(row) == {"arm", "ap", "ap50", "ap75", "ar", "n_dets", "seconds"}
        assert row["n_dets"] == len(dets)
        assert (row["ap"], row["ap50"], row["ap75"], row["ar"]) == (
            round(stats[0], 4), round(stats[1], 4), round(stats[2], 4),
            round(stats[5], 4))
    assert sum(r["n_dets"] for r in rows) > 0, "the comparison saw no detections"


_SCENE = re.compile(r"scene (\d+): (\d+) people, matched (\d+), mean joint err "
                    r"(\S+)px, detections (\d+)")


def test_e2e_trained_smoke_matches_jax(run_dir, jax_predictor, monkeypatch, capsys):
    path = ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth"), 1)
    pred = Predictor(_random_model(0), _config(), device=CPU)
    with torch.no_grad():
        pred.model.load_state_dict(ckpt_lib.load_reference_pth(path))
    ok, rows = e2e_trained_smoke.score_scenes(pred, SIZE, scenes=3, seed=777,
                                              log=lambda s: None)
    # the JAX tool itself, on the fp32 model (its own is bf16) of the config
    jcreate = jimhn.create_model
    monkeypatch.setattr(jimhn, "create_model",
                        lambda cfg, dtype=None, **kw: jcreate(cfg, dtype=jnp.float32, **kw))
    monkeypatch.setattr(sys, "argv", ["e2e", "--checkpoint", path, "--config", NAME,
                                      "--image-size", str(SIZE), "--scenes", "3"])
    rc = je2e.main()
    want = [_SCENE.match(ln).groups() for ln in
            capsys.readouterr().out.strip().splitlines() if _SCENE.match(ln)]
    assert len(want) == len(rows) == 3
    for row, (si, people, matched, err, n_det) in zip(rows, want):
        assert (row["scene"], row["people"], row["matched"], row["detections"]) == (
            int(si), int(people), int(matched), int(n_det))
        if np.isfinite(float(err)):
            assert abs(row["mean_err_px"] - float(err)) <= KP_TOL
        else:
            assert not np.isfinite(row["mean_err_px"])
    assert ok == (rc == 0)
    assert sum(r["detections"] for r in rows) > 0, "the comparison saw no detections"
    # the CLI (bf16, as it serves): a line a scene, its exit code the verdict
    rc = e2e_trained_smoke.main(["--checkpoint", path, "--config", NAME,
                                 "--image-size", str(SIZE), "--scenes", "1",
                                 "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if _SCENE.match(ln)]
    assert len(lines) == 1 and rc == (0 if "[OK]" in lines[0] else 1)


def _assert_qstate_matches(got, want):
    """The int8 weights equal, the scales and biases within 1e-5 (activation
    scales) or 1e-6 (the rest) of each tensor's largest magnitude."""
    assert set(got) == set(want)
    n_q = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith("weight_q"):
            n_q += 1
            assert torch.equal(g, w), k
        else:
            tol = 1e-5 if k.endswith("a_scale") else 1e-6
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= tol * max(scale, 1e-30), k
    assert n_q > 0


def test_export_quantized_matches_jax_ptq(run_dir, tmp_path):
    path = ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth"), 0)
    out = str(tmp_path / "int8.pth")
    assert export_quantized.main([
        "--checkpoint", path, "--out", out, "--config", NAME, "--image-size", "64",
        "--dtype", "float32", "--device", "cpu"]) == 0
    got = torch.load(out, weights_only=True)["weights"]
    # JAX quantize_model on the same .pth and the same calibration batches
    jconfig = _config(jconfigs)
    variables = load_for_inference(path, jimhn.create_model(jconfig.model,
                                                            dtype=jnp.float32))
    ds = JSyntheticDataset(jconfig, length=8, seed=1234, image_size=64)
    batches = [np.stack([ds[i][0] for i in range(b * 4, b * 4 + 4)])
               for b in range(2)]
    _, jq = jqz.quantize_model(jconfig.model, variables, batches, dtype=jnp.float32)
    _assert_qstate_matches(got, qstate_from_flax(jq["params"]))
    # the file serves bit for bit as the in-process PTQ of the same weights
    config = _config()
    fp = _random_model(0)
    fp.load_state_dict(ckpt_lib.load_reference_pth(path))
    inproc = qz.quantize_model(fp, export_quantized.calibration_batches(config, 64))
    loaded = qz.load_quantized(config.model, out, device=CPU,
                               compute_dtype=torch.float32)
    imgs = np.random.RandomState(4).randint(0, 255, (2, SIZE, SIZE, 3), np.uint8)
    hs = np.float32([SIZE, SIZE])
    chws = np.float32([[SIZE, SIZE]] * 2)
    a = Predictor(loaded, config, device=CPU)._run(imgs, hs, chws)
    b = Predictor(inproc, config, device=CPU)._run(imgs, hs, chws)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_export_quantized_calib_dir_matches_jax_tool(run_dir, tmp_path, monkeypatch):
    """--calib-dir: the port's calibration batches equal, bit for bit, the
    ones the repo's tools/export_quantized.py hands to quantize_model
    (cv2.imread, cv2.resize's bilinear default, RGB in [0, 1], batches of
    4; a subdirectory and a file cv2 cannot read are skipped), on PNGs of
    odd sizes, an identity and an exact halving (cv2's area mean); and the
    exported int8 file holds JAX quantize_model's tensors on them."""
    import importlib
    path = ckpt_lib.checkpoint_path(os.path.join(run_dir, "pth"), 0)
    calib = tmp_path / "calib"
    calib.mkdir()
    rs = np.random.RandomState(7)
    for name, (h, w) in (("a.png", (128, 128)), ("b.png", (64, 64)),
                         ("c.png", (50, 77)), ("e.png", (97, 33)),
                         ("g.png", (70, 90))):
        cv2.imwrite(str(calib / name), rs.randint(0, 256, (h, w, 3), np.uint8))
    (calib / "d_sub").mkdir()
    (calib / "f.txt").write_text("not an image")
    # the JAX tool's own batches: its main, stopped at quantize_model (no
    # persistent compilation cache: the tool enables one when imported)
    monkeypatch.setenv("IBP_JAX_CACHE_DIR", "")
    jexport = importlib.import_module("tools.export_quantized")
    seen = {}

    class Captured(Exception):
        pass

    def capture(model_cfg, variables, batches, **kw):
        seen["batches"] = batches
        raise Captured

    monkeypatch.setattr(jqz, "quantize_model", capture)
    monkeypatch.setattr(sys, "argv", [
        "export_quantized", "--checkpoint", path, "--out", str(tmp_path / "jax"),
        "--config", NAME, "--calib-dir", str(calib), "--calib-images", "7",
        "--image-size", "64"])
    with pytest.raises(Captured):
        jexport.main()
    monkeypatch.undo()
    want = seen["batches"]
    got = export_quantized.calibration_batches(_config(), 64, 7, str(calib))
    assert [b.shape for b in want] == [(4, 64, 64, 3), (1, 64, 64, 3)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the exported file against JAX quantize_model on those batches (fp32)
    out = str(tmp_path / "int8.pth")
    assert export_quantized.main([
        "--checkpoint", path, "--out", out, "--config", NAME, "--image-size", "64",
        "--calib-dir", str(calib), "--calib-images", "7", "--dtype", "float32",
        "--device", "cpu"]) == 0
    jconfig = _config(jconfigs)
    variables = load_for_inference(path, jimhn.create_model(jconfig.model,
                                                            dtype=jnp.float32))
    _, jq = jqz.quantize_model(jconfig.model, variables, want, dtype=jnp.float32)
    _assert_qstate_matches(torch.load(out, weights_only=True)["weights"],
                           qstate_from_flax(jq["params"]))
