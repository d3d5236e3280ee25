"""The port's split-TTA, deviation, reference A/B and pipeline tools and its
visual scripts, against the repo's JAX-side tools, on the CPU, with the
tiny model of tests/test_torch_predict.py (nstack 2, inp_dim 32) at 128².

  * ``eval_tta_split``: its maps against the JAX tool's ``split_tta_maps``
    on the same fp32 weights and frame, within 1e-4 of the maps' span. The
    uint8 resize of the frame is OpenCV's own on both sides (the port's
    ``resize_cubic_u8`` is bit for bit with cv2 when cv2's IPP route is
    off, tests/test_torch_letterbox.py; with IPP a pixel can be one level
    off), so what differs is the fp32 summation order of the two
    networks, held at the 1e-4 the predictor's tests use. Its results JSON
    on two PNG frames, read without cv2, against the JAX tool's: the same
    detections, keypoints within 1e-3 px.
  * ``apps.evaluate.main`` on the PNG set with cv2 unimportable: the
    detections of ``evaluate_frames`` on the in-memory frames, exactly.
  * ``measure_deviations``: deviation 1 (the centroid radius) against the
    numbers the JAX tool prints for the same scenes.
  * ``ref_ap_ab``: on a stand-in reference checkout (its calls recorded),
    the reference arm's JSON and its inputs, and the port's arm against
    ``evaluate_frames``; the live A/B where a reference checkout exists.
  * ``bench_pipeline``: the JAX tool's h5 records, and its JSON keys on 4.
  * ``visual``: ``line_integral``'s samples against the JAX
    ``bilinear_sample`` at 1e-6, ``heatmap_vis``'s image against the JAX
    script's, ``draw_net --tiny``'s parameter count against the JAX
    model's.
"""

import contextlib
import dataclasses
import json
import os
import sys
import textwrap

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demo_image as jdemo_image
import tools.bench_pipeline as jbench_pipeline
import tools.eval_tta_split as jtta_split
import tools.measure_deviations as jdeviations
from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.infer import predict as jpredict
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.ops.limbs import bilinear_sample as jbilinear_sample
from improved_body_parts_tpu.utils.checkpoint import load_for_inference
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.apps import evaluate as tevaluate
from improved_body_parts_tpu_torch.apps.demo_image import build_predictor
from improved_body_parts_tpu_torch.tools import (
    bench_pipeline, eval_tta_split, make_synthetic_coco, measure_deviations,
    ref_ap_ab,
)
from improved_body_parts_tpu_torch.utils.checkpoint import load_reference_pth
from improved_body_parts_tpu_torch.visual import draw_net, heatmap_vis, line_integral
from tests.test_torch_predict import (  # noqa: F401  (autouse fixture)
    SIZE, _config, single_torch_thread,
)
from tests.test_torch_tools import _random_model

NAME = "TorchRemainingTiny"
CPU = torch.device("cpu")
SCALES = (0.5, 1.0)
MAP_TOL = 1e-4         # of the maps' span: fp32 on both sides
KP_TOL = 1e-3          # px


@contextlib.contextmanager
def no_ipp():
    """cv2's resize without Intel IPP: OpenCV's own cubic, which the
    port's ``resize_cubic_u8`` reproduces bit for bit."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-layout .pth of the tiny model, the tiny config
    registered as ``NAME`` on both sides, and a 2-frame PNG set."""
    root = tmp_path_factory.mktemp("tta")
    path = str(root / "tiny.pth")
    torch.save({"weights": _random_model(0).state_dict()}, path)
    syn = str(root / "syn")
    make_synthetic_coco.main(["--out-dir", syn, "--n-images", "2", "--size",
                              str(SIZE), "--seed", "11"])
    mp = pytest.MonkeyPatch()
    mp.setitem(tconfigs.CONFIGS, NAME, _config())
    mp.setitem(jconfigs.CONFIGS, NAME, _config(jconfigs))
    yield path, os.path.join(syn, "images"), os.path.join(syn, "gt.json")
    mp.undo()


@pytest.fixture(scope="module")
def jax_predictor(weights):
    jconfig = _config(jconfigs)
    jmodel = jimhn.create_model(jconfig.model, dtype=jnp.float32)
    return jpredict.Predictor(jmodel, load_for_inference(weights[0], jmodel), jconfig)


def _port_predictor(path):
    return build_predictor(path, _config(), device=CPU, dtype=torch.float32)


# ---------------------------------------------------------------------------
# eval_tta_split
# ---------------------------------------------------------------------------

def test_split_tta_maps_match_jax(weights, jax_predictor):
    path, img_dir, _ = weights
    img = cv2.imread(os.path.join(img_dir, "synthetic_000000.png"))[:, :112]
    with no_ipp():
        want, want_hw = jtta_split.split_tta_maps(jax_predictor, img, SCALES)
    got, got_hw = eval_tta_split.split_tta_maps(_port_predictor(path), img, SCALES)
    assert got_hw == tuple(want_hw) and got.shape == want.shape
    span = float(want.max() - want.min())
    assert span > 0
    err = float(np.abs(got.numpy() - want).max())
    assert err <= MAP_TOL * span, (err, span)


def test_split_tta_results_json_matches_jax(weights, jax_predictor, tmp_path,
                                            monkeypatch, capsys):
    path, img_dir, gt_json = weights
    argv = ["--checkpoint", path, "--config", NAME, "--image-dir", img_dir,
            "--gt-json", gt_json, "--scale-search", *map(str, SCALES),
            "--dump-name", "split"]
    monkeypatch.setattr(jdemo_image, "build_predictor",
                        lambda *a, **k: jax_predictor)
    monkeypatch.chdir(tmp_path)
    with no_ipp():
        assert jtta_split.main(argv) == 0
    with open(tmp_path / "results" / "val2017_split_results.json") as f:
        want = json.load(f)
    jax_ap = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("AP=")]
    monkeypatch.setitem(sys.modules, "cv2", None)          # the card's host
    assert eval_tta_split.main(argv + ["--device", "cpu", "--dtype", "float32",
                                       "--results-dir", str(tmp_path / "port")]) == 0
    with open(tmp_path / "port" / "val2017_split_results.json") as f:
        got = json.load(f)
    assert [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("AP=")] == jax_ap
    assert len(want) > 0, "the comparison saw no detections"
    assert len(got) == len(want)
    key = lambda d: (d["image_id"], d["keypoints"])       # noqa: E731
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert g["image_id"] == w["image_id"]
        assert abs(g["score"] - w["score"]) <= 1e-4
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=KP_TOL)


def test_evaluate_main_reads_pngs_without_cv2(weights, tmp_path, monkeypatch, capsys):
    path, img_dir, gt_json = weights
    with open(gt_json) as f:
        gt = json.load(f)
    frames, _ = tevaluate.synthetic_coco(2, size=SIZE, seed=11)
    want = tevaluate.evaluate_frames(_port_predictor(path), frames).outputs
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tevaluate.main(["--checkpoint", path, "--config", NAME, "--image-dir",
                           img_dir, "--gt-json", gt_json, "--device", "cpu",
                           "--dtype", "float32", "--results-dir", str(tmp_path),
                           "--dump-name", "png"]) == 0
    with open(tmp_path / "val2017_png_results.json") as f:
        assert json.load(f) == want
    assert len(gt["images"]) == 2 and "AP=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# measure_deviations
# ---------------------------------------------------------------------------

def test_centroid_deviation_matches_jax(capsys):
    n = 3
    jdeviations.measure_centroid_radius(n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    nums = [float(x) for x in line.replace("/", " ").replace(",", " ").split()
            if x.replace(".", "", 1).isdigit()]
    matched, scenes, mean, p95, mx, unmatched, total = nums
    d, um, tot = measure_deviations.centroid_deltas(n, CPU)
    assert (len(d), um, tot, n) == (matched, unmatched, total, scenes)
    for got, want in ((d.mean(), mean), (np.percentile(d, 95), p95), (d.max(), mx)):
        assert abs(got - want) <= 1e-3            # printed to 3 decimals
    measure_deviations.main(["--which", "centroid", "--scenes", str(n),
                             "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == line


def test_blob_scene_and_weight_recipe_match_tests_copies():
    from tests.reference_parity_common import blob_scene, seeded_state_dict_arrays
    for si in (0, 200, 7):
        for a, b in zip(measure_deviations.blob_scene(si), blob_scene(si)):
            assert np.array_equal(a, b)
    keys = ["a.weight", "a.bias", "bn.weight", "bn.running_var",
            "bn.num_batches_tracked", "c.weight"]
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "bn.weight": (4,),
              "bn.running_var": (4,), "bn.num_batches_tracked": (),
              "c.weight": (2, 4)}
    got = measure_deviations.seeded_state_dict_arrays(keys, shapes)
    want = seeded_state_dict_arrays(keys, shapes)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# ref_ap_ab
# ---------------------------------------------------------------------------

FAKE_POSENET = '''
import torch


class PoseNet(torch.nn.Module):
    def __init__(self, nstack, inp_dim, oup_dim, bn=False, increase=0):
        super().__init__()
        self.args = (nstack, inp_dim, oup_dim, bn, increase)
        self.w = torch.nn.Parameter(torch.zeros(1))

    def load_state_dict(self, sd, strict=True):
        self.loaded = dict(sd)
'''

FAKE_PARSE = '''
import numpy as np
import torch

CALLS = []


def predict_refactor(img, net, test_cfg, model_cfg, path, flip_avg, config):
    torch.zeros(1).cuda()          # the tool makes .cuda() a no-op
    CALLS.append(dict(img=img.copy(), net=net, training=net.training,
                      test_cfg=test_cfg, model_cfg=model_cfg, path=path,
                      flip_avg=flip_avg, config=config))
    h, w = img.shape[:2]
    return np.zeros((h, w, 19), np.float32), np.zeros((h // 4, w // 4, 30), np.float32)


def heatmap_nms(heat, upsample_factor):
    return ("peaks", heat.shape, upsample_factor)


def find_connections(peaks, paf_up, img_h, test_cfg, pairs):
    CALLS[-1].update(paf_up=paf_up.shape, img_h=img_h, pairs=pairs, peaks=peaks)
    return "conns", "special"


def find_humans(conns, special, peaks, test_cfg, pairs):
    n = len(CALLS)
    cands = np.array([[5.0 + j + n, 7.0 + 2 * j, 0.5, j] for j in range(18)])
    table = np.zeros((1, 20, 2))
    table[0, :18, 0] = np.arange(18)
    table[0, 18, 0], table[0, 19, 0] = 9.0, 18.0
    return table, cands
'''


@pytest.fixture
def fake_reference(tmp_path, monkeypatch):
    """A stand-in reference checkout (models/posenet, utils/
    parse_skeletons), named by ``REFERENCE_DIR``; the modules the tool
    imports from it are dropped again afterwards."""
    root = tmp_path / "reference"
    for pkg, name, src in (("models", "posenet", FAKE_POSENET),
                           ("utils", "parse_skeletons", FAKE_PARSE)):
        (root / pkg).mkdir(parents=True)
        (root / pkg / "__init__.py").write_text("")
        (root / pkg / f"{name}.py").write_text(textwrap.dedent(src))
    monkeypatch.setenv("REFERENCE_DIR", str(root))
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = set(sys.modules)
    yield str(root)
    for m in set(sys.modules) - before:
        if m.split(".")[0] in ("models", "utils", "thop", "torchvision"):
            del sys.modules[m]


def test_ref_ap_ab_drives_the_reference_stack(weights, fake_reference, tmp_path,
                                              capsys):
    path, img_dir, gt_json = weights
    cuda = torch.Tensor.cuda
    assert ref_ap_ab.main(["--checkpoint", path, "--config", NAME, "--image-dir",
                           img_dir, "--gt-json", gt_json, "--boxsize", "96",
                           "--results-dir", str(tmp_path), "--device", "cpu"]) == 0
    calls = sys.modules["utils.parse_skeletons"].CALLS
    with open(gt_json) as f:
        gt = json.load(f)
    names = sorted(im["file_name"] for im in gt["images"])
    assert [os.path.basename(c["path"]) for c in calls] == names
    sd = load_reference_pth(path)
    for c, name in zip(calls, names):
        assert np.array_equal(c["img"], cv2.imread(os.path.join(img_dir, name)))
        assert not c["training"] and c["flip_avg"]
        assert c["net"].args == (2, 32, 50, True, 16)
        assert c["net"].loaded.keys() == sd.keys()
        assert c["model_cfg"] == dict(boxsize=96, max_downsample=64, padValue=128,
                                      stride=4)
        assert c["test_cfg"]["thre1"] == 0.1 and c["test_cfg"]["mid_num"] == 20
        assert c["paf_up"] == (SIZE, SIZE, 30) and c["img_h"] == SIZE
        assert c["pairs"] == [tuple(p) for p in tconfigs.LIMBS_CONN]
        assert c["peaks"] == ("peaks", (SIZE, SIZE, 19), 4.0)
    assert torch.Tensor.cuda is cuda                           # restored
    # the reference arm: one person an image, formatted by append_result
    with open(tmp_path / "reference_ab_results.json") as f:
        ref = json.load(f)
    by_name = {im["file_name"]: im["id"] for im in gt["images"]}
    want = []
    for n, name in enumerate(names, start=1):
        kps = np.zeros((1, 18, 3))
        kps[0, :, 0] = 5.0 + np.arange(18) + n
        kps[0, :, 1] = 7.0 + 2 * np.arange(18)
        kps[0, :, 2] = 1.0
        tevaluate.append_result(by_name[name], kps, np.array([0.5]), want)
    assert ref == want
    # the port's arm: apps.evaluate's protocol on the same weights
    config = dataclasses.replace(_config(), infer=dataclasses.replace(
        _config().infer, boxsize=96, thre1=0.1))
    pred = build_predictor(path, config, device=CPU, dtype=torch.float32)
    frames = [(by_name[n], cv2.imread(os.path.join(img_dir, n))) for n in names]
    with open(tmp_path / "reference_ab_ours_results.json") as f:
        assert json.load(f) == tevaluate.evaluate_frames(pred, frames).outputs
    out = capsys.readouterr().out
    assert "REFERENCE-STACK AP=" in out and "PORT (cpu) AP=" in out


def test_ref_ap_ab_live_reference(tmp_path):
    """The tool's reference arm on a seeded tiny reference network against
    the port's pipeline with every peak kept and none suppressed in the pad
    band (as the refactor path; tests/test_ref_ap_ab.py builds the JAX
    side's so): the same detections within that test's tolerances."""
    reference = ref_ap_ab.reference_dir()
    if not reference or not os.path.isdir(reference):
        pytest.skip("no reference checkout (set REFERENCE_DIR)")
    ckpt = str(tmp_path / "seeded.pth")
    torch.save({"weights": measure_deviations.seeded_reference_state_dict()}, ckpt)
    syn = tmp_path / "syn"
    make_synthetic_coco.main(["--out-dir", str(syn), "--n-images", "2", "--size",
                              "128", "--seed", "777", "--max-people", "2"])
    assert ref_ap_ab.main([
        "--checkpoint", ckpt, "--image-dir", str(syn / "images"), "--gt-json",
        str(syn / "gt.json"), "--nstack", "2", "--inp-dim", "256", "--increase",
        "128", "--boxsize", "128", "--results-dir", str(tmp_path / "r"),
        "--device", "cpu"]) == 0
    with open(tmp_path / "r" / "reference_ab_results.json") as f:
        refs = json.load(f)
    config = tconfigs.CanonicalConfig(
        model=tconfigs.ModelConfig(nstack=2, inp_dim=256, increase=128))
    config = dataclasses.replace(config, infer=dataclasses.replace(
        config.infer, boxsize=128, thre1=0.1, max_peaks=128))
    pred = build_predictor(ckpt, config, device=CPU, dtype=torch.float32)
    pred.suppress_pad_peaks = False
    with open(syn / "gt.json") as f:
        gt = json.load(f)
    frames = [(im["id"], cv2.imread(str(syn / "images" / im["file_name"])))
              for im in sorted(gt["images"], key=lambda x: x["id"])]
    ours = tevaluate.evaluate_frames(pred, frames).outputs
    assert len(ours) > 0 and len(ours) == len(refs)

    def canon(dets):
        return sorted((d["image_id"], round(d["score"], 3),
                       tuple(round(v, 1) for v in d["keypoints"])) for d in dets)

    for o, r in zip(canon(ours), canon(refs)):
        assert o[0] == r[0] and abs(o[1] - r[1]) <= 2e-3, (o, r)
        np.testing.assert_allclose(np.asarray(o[2]), np.asarray(r[2]), atol=0.05)


# ---------------------------------------------------------------------------
# bench_pipeline
# ---------------------------------------------------------------------------

def test_bench_pipeline_records_and_keys(tmp_path, capsys):
    a, b = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    bench_pipeline.write_crowd_h5(a, 4)
    jbench_pipeline.write_crowd_h5(b, 4)
    with h5py.File(a, "r") as f, h5py.File(b, "r") as g:
        for grp in ("dataset", "images", "masks"):
            assert list(f[grp]) == list(g[grp])
            for k in g[grp]:
                assert np.array_equal(f[grp][k][()], g[grp][k][()])
                assert dict(f[grp][k].attrs) == dict(g[grp][k].attrs)
    assert bench_pipeline.main(["--h5", a, "--steps", "2", "--batch", "2",
                                "--workers", "1", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"single_sample_ms", "stage_ms", "samples_per_s_w1",
                        "samples_per_s_w2"}
    assert set(out["stage_ms"]) == {"read", "warp", "heatmaps"}
    assert all(v > 0 for k, v in out.items() if k != "stage_ms")


# ---------------------------------------------------------------------------
# the visual scripts
# ---------------------------------------------------------------------------

def test_line_integral_samples_match_jax(capsys):
    got = line_integral.samples(CPU)
    limb = jnp.asarray(line_integral.limb_map())
    for name, seg in line_integral.PAIRINGS.items():
        px, py = line_integral.segment_points(*seg)
        want = np.asarray(jbilinear_sample(limb, jnp.asarray(px), jnp.asarray(py)))
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-6)
    assert got["true limb"].mean() > 0.9 > 0.2 > got["wrong pairing"].mean()
    assert line_integral.main(["--device", "cpu"]) == 0
    assert "true limb     : mean sample = 0.981" in capsys.readouterr().out


def test_heatmap_vis_matches_jax(tmp_path, monkeypatch):
    import visual.heatmap_vis as jheatmap_vis
    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda p, img: written.setdefault("img", img))
    jheatmap_vis.main()                          # captured, not written
    got = heatmap_vis.render()
    assert got.shape == written["img"].shape == (512, 1536, 3)
    assert np.array_equal(got, written["img"])
    assert np.array_equal(heatmap_vis.jet(np.linspace(-0.1, 1.1, 97)),
                          jheatmap_vis.jet(np.linspace(-0.1, 1.1, 97)))
    out = tmp_path / "hv.png"
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert heatmap_vis.main(["--out", str(out)]) == 0
    from improved_body_parts_tpu_torch.utils.imageio import imread
    assert np.array_equal(imread(out), got)


def test_draw_net_tiny_parameter_count(capsys):
    jcfg = jconfigs.ModelConfig(nstack=2, inp_dim=32, increase=16)
    jmodel = jimhn.create_model(jcfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    stats = draw_net.describe(tconfigs.ModelConfig(nstack=2, inp_dim=32, increase=16),
                              CPU, print_fn=lambda s: None)
    assert stats["params"] == want and stats["flops"] > 0
    assert draw_net.main(["--tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith(f"total: {want:,} parameters")
    rows = {ln.split()[0]: ln for ln in out[1:-1]}
    assert "hourglass.0" in rows and "1x32x32x32" in rows["hourglass.0"]
