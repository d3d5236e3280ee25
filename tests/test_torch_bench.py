"""The port's benchmark entry points (``apps/bench.py``,
``apps/inference_speed.py``, ``tools/bench_train_step.py``) and
``utils/profiling.py``, on the CPU at the tiny size of
tests/test_torch_predict.py.

  * ``realistic_packed_buffers``: the tables of the JAX ``bench.py``'s
    function on the same GT maps; valid masks and slots equal, floats
    within 1e-4 (fp32 on both sides, as test_torch_predict.py holds
    ``_postprocess``).
  * Each CLI's ``main`` prints the JAX tool's lines and keys.
  * ``flops_of``: exactly 2 x the multiply-accumulates of every conv and
    linear the forward calls, counted from the shapes of the calls.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bench as jbench
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.apps import bench as tbench
from improved_body_parts_tpu_torch.apps import inference_speed
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.tools import bench_train_step
from improved_body_parts_tpu_torch.utils import profiling
from tests.test_torch_predict import (  # noqa: F401  (fixtures)
    _assert_tables_match, _config, pair, single_torch_thread,
)

NAME = "TorchBenchTiny"
JAX_TRAIN_KEYS = {"k", "depth", "steps", "wall_s", "s_per_step",
                  "samples_per_s", "compile_s"}


@pytest.fixture
def tiny_cli(monkeypatch):
    """The tiny config registered as ``NAME``; the bench protocol cut to
    2 batches of 2 frames, 2 threads."""
    monkeypatch.setitem(tconfigs.CONFIGS, NAME, _config())
    monkeypatch.setattr(tbench, "BATCH", 2)
    monkeypatch.setattr(tbench, "N_BATCHES", 2)
    monkeypatch.setattr(tbench, "PIPELINE_DEPTH", 2)


def test_realistic_packed_buffers_match_jax(pair):
    jpred, tpred = pair
    want = jbench.realistic_packed_buffers(jpred, jpred.config, 2)
    got = tbench.realistic_packed_buffers(tpred, 2)
    assert len(got) == len(want) == 2
    P = tpred.config.infer.max_peaks
    n = sum(_assert_tables_match(g, np.asarray(w), P) for g, w in zip(got, want))
    assert n > 0, "the comparison saw no peaks"


def jax_bench_line(fps: float) -> dict:
    """The line the JAX ``bench.py`` prints for ``fps`` (its :241-246)."""
    return {"metric": "e2e_fps_512_flipTTA_net_grouping",
            "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / jbench.BASELINE_E2E_FPS, 2)}


@pytest.mark.parametrize("arm", [[], ["--fused-peaks"], ["--quantize", "int8"]],
                         ids=["default", "fused", "int8"])
def test_bench_main_prints_the_jax_line(tiny_cli, capsys, monkeypatch, arm):
    """The printed line is the JAX construction of the unrounded fps that
    ``main`` measured (recorded by a spy on ``result_line``), whatever
    that fps is."""
    seen = []

    def spy(fps):
        seen.append(fps)
        return result_line(fps)

    result_line = tbench.result_line
    monkeypatch.setattr(tbench, "result_line", spy)
    rc = tbench.main(["--device", "cpu", "--config", NAME,
                      "--image-size", "64", *arm])
    out = capsys.readouterr()
    assert rc == 0
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, out.out            # stdout: the JSON line alone
    assert len(seen) == 1 and seen[0] > 0
    assert json.loads(lines[0]) == jax_bench_line(seen[0])
    assert "grouping inline:" in out.err and "(device: cpu)" in out.err


@pytest.mark.parametrize("fps", [0.9127, 7.3, 42.68])
def test_result_line_is_the_jax_construction(fps):
    """At 0.9127 fps / 7.3 rounds to 0.13 and round(0.91 / 7.3, 2) to 0.12:
    the baseline ratio is taken of the unrounded fps, as in JAX."""
    assert tbench.result_line(fps) == jax_bench_line(fps)


@pytest.mark.parametrize("quant", [[], ["--quantize", "int8"]], ids=["bf16", "int8"])
def test_inference_speed_main_prints_the_jax_lines(tiny_cli, capsys, quant):
    rc = inference_speed.main(["--device", "cpu", "--config", NAME,
                               "--image-size", "64", "--batch-size", "2",
                               "--iters", "2", "--mfu", *quant])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert out[-3].startswith("network-only: ") and "device cpu" in out[-3]
    assert out[-2].startswith("forward: ") and "GFLOP/frame" in out[-2]
    assert ("of int8 peak" in out[-2]) == bool(quant)
    res = json.loads(out[-1])
    assert {"fps", "ms_per_step", "gflop_per_frame", "tflops",
            "mfu_bf16"} <= set(res)
    assert ("mfu_int8" in res) == bool(quant)
    # the int8 forward's FLOPs are the float model's (the same convs)
    model = PoseNet(_config().model, compute_dtype=torch.float32)
    flops = profiling.flops_of(model.predict_maps, torch.zeros(2, 64, 64, 3))
    assert res["gflop_per_frame"] == flops / 2 / 1e9
    assert res["mfu_bf16"] == pytest.approx(res["tflops"] * 1e12 / 989e12, rel=1e-12)


def test_flops_of_is_twice_the_conv_and_linear_macs(monkeypatch):
    model = PoseNet(_config().model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    macs = []
    conv2d, linear = F.conv2d, F.linear

    def counted_conv(inp, w, *args, **kw):
        out = conv2d(inp, w, *args, **kw)
        macs.append(out.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return out

    def counted_linear(inp, w, *args, **kw):
        out = linear(inp, w, *args, **kw)
        macs.append(out.numel() * w.shape[1])
        return out

    monkeypatch.setattr(F, "conv2d", counted_conv)
    monkeypatch.setattr(F, "linear", counted_linear)
    with torch.inference_mode():
        model.predict_maps(x)
    monkeypatch.undo()
    assert len(macs) > 0
    assert profiling.flops_of(model.predict_maps, x) == 2 * sum(macs)
    stats = profiling.model_stats(model, 64, 64, batch=2)
    assert stats["flops"] == 2 * sum(macs)
    assert stats["params"] == sum(p.numel() for p in model.parameters())


def test_bench_train_step_main_prints_the_jax_keys(capsys):
    rc = bench_train_step.main([
        "--device", "cpu", "--tiny-model", "--image-size", "64",
        "--batch-size", "2", "--steps", "2", "--workers", "1",
        "--configs", "dense:1,resident:2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and len(lines) == 3
    for rec, (feed, k) in zip(lines, [("dense", 1), ("resident", 2)]):
        assert JAX_TRAIN_KEYS <= set(rec)
        assert (rec["feed"], rec["k"], rec["steps"]) == (feed, k, 2)
        assert rec["samples_per_s"] > 0 and rec["graph"] is False   # CPU: eager
    assert set(lines[2]) == {"summary", "speedup_vs_blocking"}
    with pytest.raises(ValueError):
        bench_train_step.parse_configs("resident:0")


def test_profiling_helpers_on_the_cpu(tmp_path):
    meter = profiling.AverageMeter()
    for v in (1.0, 3.0):
        with profiling.timer(meter) as t:
            profiling.sync(torch.ones(2))
        assert t["elapsed"] >= 0.0
    meter.update(2.0, n=2)
    assert meter.count == 4 and meter.val == 2.0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
