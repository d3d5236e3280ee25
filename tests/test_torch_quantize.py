"""The port's int8 post-training quantization (``models/quantize.py``, the
quant modes of ``models/imhn.py``, ``ops.kernels.int8_conv_plain``) against
the JAX package's (``models/quantize.py``), on the CPU, with the tiny
PoseNet of tests/test_quantize.py (nstack 2, inp_dim 32, increase 16) at
64² and weights and BN statistics randomised from a numpy seed.

  * ``fold_conv_bn``: every folded tensor within 1e-6 of its scale (the
    same fp32 operations in the same order).
  * Calibration abs-max of every conv block within 1e-5 relative (two fp32
    forwards, summation order differs).
  * ``build_quantized`` on the same folded tree and statistics: ``weight_q``
    bit-identical, the scales and biases equal.
  * One conv's int32 sums on the same int8 operands: equal to
    ``lax.conv_general_dilated(..., preferred_element_type=int32)``.
  * The whole int8 forward on the same int8 parameters
    (``qstate_from_flax``): correlation >= 0.999 and max error <= 1% of
    the span at every output (measured: corr 1 - 1e-15 and the error
    6.0e-8 of the span at worst: no quantized activation differs, what
    remains is the fp32 rounding of the dequantization).
Then the port's own PTQ against its fp forward (the JAX package's own
bound, corr > 0.98, error < 15%; measured corr 0.99995, error 0.94% of
the span), the int8 ``.pth`` round trip and the
apps' ``--quantize int8``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.models import quantize as jqz
from improved_body_parts_tpu_torch import configs
from improved_body_parts_tpu_torch.apps import demo_image as tdemo
from improved_body_parts_tpu_torch.apps import evaluate as tevaluate
from improved_body_parts_tpu_torch.models import quantize as qz
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.ops import kernels
from improved_body_parts_tpu_torch.utils.checkpoint import (
    flax_to_reference_key, qstate_from_flax, state_dict_from_flax,
)
from tests.test_torch_variants import run_jitted
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

TINY = dict(nstack=2, inp_dim=32, increase=16)
SIZE = 64
CPU = torch.device("cpu")


def _randomised(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            v = rng.uniform(0.5, 2.0, x.shape)
        elif "scale" in name:
            v = rng.uniform(0.5, 1.5, x.shape)
        elif "mean" in name:
            v = rng.randn(*x.shape) * 0.2
        else:
            v = rng.randn(*x.shape) * 0.05
        return np.asarray(v, np.float32).reshape(x.shape)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _conv_names(tree, leaf_key):
    """{port conv name: value} for every JAX ConvBlock dict holding
    ``leaf_key`` (the calibration's ``absmax``)."""
    out = {}

    def walk(t, path):
        if leaf_key in t:
            v = t[leaf_key]
            v = v[0] if isinstance(v, tuple) else v
            out[flax_to_reference_key(path + ("conv",), "kernel")[:-len(".weight")]] = v
            return
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def ptq():
    """Both packages' PTQ of the same randomised tiny model on the same
    calibration batch: JAX folded tree, statistics, int8 tree and int8
    outputs; the port's fp model, folded state and statistics."""
    jcfg = jconfigs.ModelConfig(**TINY)
    jmodel = jimhn.create_model(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                                  train=False),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _randomised(shapes, 0)
    params, stats = variables["params"], variables["batch_stats"]
    imgs = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)

    jfolded = jqz.fold_conv_bn(params, stats)
    jstats = jqz.calibrate(jcfg, jfolded, [imgs], dtype=jnp.float32)
    jq = jqz.build_quantized(jfolded, jstats)
    jint8 = jimhn.create_model(jcfg, dtype=jnp.float32, quant="int8")
    jout = run_jitted(lambda p, x: jint8.apply({"params": p}, x, train=False),
                      jq, jnp.asarray(imgs))

    port = PoseNet(configs.ModelConfig(**TINY), compute_dtype=torch.float32,
                   device="meta").to_empty(device=CPU)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    folded = qz.fold_conv_bn(port)
    calib = qz.make_quant_model(port.cfg, "calib", CPU, torch.float32)
    calib.load_state_dict(folded, strict=True)
    pstats = qz.calibrate(calib, [imgs])
    return dict(jfolded=jfolded, jstats=jstats, jq=jq, jout=jout,
                port=port, folded=folded, pstats=pstats, imgs=imgs)


@pytest.fixture(scope="module")
def qmodel(ptq):
    """The port's own PTQ of the fp model (``quantize_model``)."""
    return qz.quantize_model(ptq["port"], [ptq["imgs"]])


def _assert_rel(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        w = torch.as_tensor(np.array(w)).float()
        g = torch.as_tensor(got[k]).float()
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * scale, k


def test_fold_conv_bn_matches_jax(ptq):
    want = state_dict_from_flax(ptq["jfolded"], {})
    _assert_rel(ptq["folded"], want, 1e-6)
    assert not any("running" in k or ".bn" in k for k in ptq["folded"])


def test_calibration_absmax_matches_jax(ptq):
    want = _conv_names(ptq["jstats"], "absmax")
    assert len(want) == qz.count_int8_convs(
        qz.make_quant_model(ptq["port"].cfg, "int8", "meta", torch.float32))
    _assert_rel(ptq["pstats"], want, 1e-5)
    # the first conv sees the image itself
    assert float(ptq["pstats"]["pre.conv1"]) == float(np.abs(ptq["imgs"]).max())


def test_build_quantized_is_bit_identical_to_jax(ptq):
    folded = state_dict_from_flax(ptq["jfolded"], {})
    stats = {k: torch.tensor(np.asarray(v)) for k, v in
             _conv_names(ptq["jstats"], "absmax").items()}
    got = qz.build_quantized(folded, stats)
    want = qstate_from_flax(ptq["jq"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert sum(k.endswith("weight_q") for k in got) == len(stats)


CONV_GRID = [(k, s, d, c) for k, d in ((1, 1), (3, 1), (3, 3), (3, 5), (7, 1),
                                       (7, 3), (7, 5))
             for s in (1, 2) for c in (3, 50, 64)]


@pytest.mark.parametrize("k,stride,dilation,cin", CONV_GRID)
def test_int32_sums_match_lax(k, stride, dilation, cin):
    rng = np.random.RandomState(k * 1000 + dilation * 100 + cin + stride)
    xq = rng.randint(-127, 128, (2, 13, 11, cin)).astype(np.int8)
    xq[0, 0, 0] = 127                                    # the extremes
    wq = rng.randint(-127, 128, (k, k, cin, 24)).astype(np.int8)
    pad = dilation * (k - 1) // 2
    want = run_jitted(lambda a, b: jax.lax.conv_general_dilated(
        a, b, window_strides=(stride, stride), padding=[(pad, pad), (pad, pad)],
        rhs_dilation=(dilation, dilation), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32), jnp.asarray(xq), jnp.asarray(wq))
    got = kernels.int8_conv_sums(torch.from_numpy(xq).float(),
                                 torch.from_numpy(wq).permute(3, 0, 1, 2),
                                 stride, pad, dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _corr_err(got, want):
    g, w = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    span = w.max() - w.min()
    return np.corrcoef(g, w)[0, 1], np.abs(g - w).max() / span


def test_int8_forward_matches_jax_on_the_same_int8_params(ptq):
    model = qz.make_quant_model(ptq["port"].cfg, "int8", CPU, torch.float32)
    model.load_state_dict(qstate_from_flax(ptq["jq"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ptq["imgs"]))
        read_out = model.predict_maps(torch.from_numpy(ptq["imgs"]))
    for t in range(TINY["nstack"]):
        for s in range(5):
            corr, err = _corr_err(got[t][s].numpy(), ptq["jout"][t][s])
            assert corr >= 0.999 and err <= 0.01, (t, s, corr, err)
    torch.testing.assert_close(read_out, got[-1][0], rtol=0, atol=0)


def test_port_ptq_tracks_the_folded_fp_forward(ptq, qmodel):
    """quantize_model end to end against the fp forward (the JAX package's
    own bound, tests/test_quantize.py)."""
    assert qmodel.quant == "int8" and qz.count_int8_convs(qmodel) > 0
    x = torch.from_numpy(ptq["imgs"])
    with torch.no_grad():
        out, fp = qmodel(x), ptq["port"](x)
    corr, err = _corr_err(out[-1][0].numpy(), fp[-1][0].numpy())
    assert corr > 0.98 and err < 0.15, (corr, err)
    with pytest.raises(ValueError, match="live PoseNet"):
        qz.quantize_model(qmodel, [ptq["imgs"]])


def test_int8_checkpoint_round_trip(ptq, qmodel, tmp_path):
    path = str(tmp_path / "int8.pth")
    qz.save_quantized(path, qmodel)
    fp_path = str(tmp_path / "fp.pth")
    torch.save({"weights": ptq["port"].state_dict()}, fp_path)
    assert qz.is_quantized_checkpoint(path)
    assert not qz.is_quantized_checkpoint(fp_path)
    assert not qz.is_quantized_checkpoint(str(tmp_path))
    back = qz.load_quantized(qmodel.cfg, path, device=CPU,
                             compute_dtype=torch.float32)
    for k, v in qmodel.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    x = torch.from_numpy(ptq["imgs"])
    with torch.no_grad():
        assert torch.equal(back.predict_maps(x), qmodel.predict_maps(x))
    # int8 weights: about a quarter of the fp32 file
    assert os.path.getsize(path) < 0.4 * os.path.getsize(fp_path)


def test_int8_conv_wrapper_checks_its_inputs():
    x = torch.zeros((1, 4, 4, 8), device="meta")
    w = torch.zeros((4, 3, 3, 8), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError):            # neither CPU nor CUDA
        kernels.int8_conv(x, w, s, s, torch.ones(()))
    n0 = kernels.int8_conv.launches
    got = kernels.int8_conv(torch.zeros((1, 4, 4, 8)), w, s, s, torch.ones(()), 1, 1)
    assert got.shape == (1, 4, 4, 4) and kernels.int8_conv.launches == n0


@pytest.mark.parametrize("source", ["calibration", "int8 export"])
def test_apps_quantize_int8(ptq, qmodel, tmp_path, monkeypatch, capsys, source):
    """``--quantize int8``: build_predictor from calibration on the
    synthetic scenes and from a saved int8 ``.pth``; the first through
    apps.demo_image's CLI, the second through apps.evaluate's."""
    import cv2

    from improved_body_parts_tpu_torch.apps.evaluate import synthetic_coco
    tiny = configs.CanonicalConfig(width=SIZE, height=SIZE,
                                   model=configs.ModelConfig(**TINY))
    monkeypatch.setitem(configs.CONFIGS, "QuantTiny", tiny)
    path = str(tmp_path / "fp.pth")
    torch.save({"weights": ptq["port"].state_dict()}, path)
    if source == "int8 export":
        qpath = str(tmp_path / "int8.pth")
        qz.save_quantized(qpath, qmodel)
        path = qpath
        pred = tdemo.build_predictor(path, "QuantTiny", device=CPU,
                                     quantize="int8", dtype=torch.float32)
        assert "loaded int8 quantized checkpoint" in capsys.readouterr().out
        assert pred.model.quant == "int8"

    frames, _ = synthetic_coco(2, size=SIZE, seed=5)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, (_, frame) in enumerate(frames):
        cv2.imwrite(str(img_dir / f"{i:012d}.png"), frame)
    image = str(img_dir / "000000000000.png")
    common = ["--checkpoint", path, "--config", "QuantTiny", "--quantize", "int8",
              "--device", "cpu", "--dtype", "float32"]
    if source == "calibration":
        assert tdemo.main(common + ["--image", image, "--output",
                                    str(tmp_path / "out.jpg")]) == 0
        out = capsys.readouterr().out
        assert "int8 PTQ: folded BN + calibrated on 8 scenes" in out
        assert "found" in out
    else:
        assert tevaluate.main(common + ["--image-dir", str(img_dir), "--results-dir",
                                        str(tmp_path), "--max-images", "2"]) == 0
        assert "detections to" in capsys.readouterr().out
