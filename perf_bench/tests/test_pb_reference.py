"""The plain reference against the program on the CPU, at the tiny size:
the network's maps, the post-processing and assembly from maps to
skeletons, and one train step from its loss through its parameters."""

import numpy as np
import torch

from perf_bench import core, weights
from perf_bench.reference import model as ref_model
from perf_bench.reference import post as ref_post
from perf_bench.tests import _tiny


def port_model(init="fan_in", seed=5):
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    cfg = _tiny.program_config()
    spec = weights.spec(ref_model.build(_tiny.TINY_MODEL, device="meta"))
    sd = weights.make(spec, seed, "cpu", init)
    prog = PoseNet(cfg.model, compute_dtype=torch.float32)
    prog.load_state_dict(sd, strict=True)
    ref = ref_model.build(_tiny.TINY_MODEL)
    ref.load_state_dict(sd, strict=True)
    return prog, ref


def test_the_networks_agree():
    prog, ref = port_model()
    x = torch.rand(2, _tiny.SIZE, _tiny.SIZE, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(prog.predict_maps(x), ref.predict_maps(x))
        got = prog(x, bn_stats={})
        want = ref.run(x, ref_model.Ctx({}))
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                assert torch.equal(g, w)


def test_maps_to_skeletons_agree():
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    from improved_body_parts_tpu_torch.ops import group
    prog, _ = port_model()
    cfg = _tiny.program_config()
    pred = Predictor(prog, cfg, device=torch.device("cpu"))
    maps = torch.rand(3, 16, 16, 50, generator=torch.Generator().manual_seed(1))
    img_h = torch.full((3,), 64.0)
    content = torch.full((3, 2), 64.0)
    packed, _, _ = pred._postprocess(maps, img_h, content)
    want = ref_post.skeletons(maps, img_h, content, icfg=_tiny.ref_config().infer)
    from improved_body_parts_tpu_torch.infer.predict import unpack_results
    people = 0
    for b in range(3):
        peaks, conns = unpack_results(packed[b].numpy(), cfg.infer.max_peaks)
        table, cands = pred._group(peaks, conns, use_cpp=False)
        kps, scores = group.humans_to_keypoints(table, cands)
        assert np.array_equal(kps, want[b][0]) and np.array_equal(scores, want[b][1])
        people += len(kps)
    assert people > 0


def test_the_serving_cell_agrees():
    job = _tiny.serve_job()
    out = core.driver("closed_loop_cameras").run(job)
    got = _tiny.readings(out)
    assert got["sampled_batches_missing"] == 0
    assert got["maps_gap_vs_bf16"] < 1e-3 and got["people_mismatch"] == 0
    assert got["keypoint_gap"] < 1e-4
    assert job.diagnostics["people_found"] > 0
    assert out.correct and out.end_to_end["serve_frames_per_s"] > 0


def test_the_serving_window_counts_whole_batches():
    job = _tiny.serve_job(seed=11, seconds=3.0)
    out = core.driver("closed_loop_cameras").run(job)
    L, B = out.layer, job.traffic["batch_size"]
    assert L["batches_returned"] > 0
    assert 0 < L["frames_returned"] <= L["batches_returned"] * B
    assert abs(len(L["latency_ms"]) - L["frames_returned"]) <= B
    assert out.end_to_end["serve_frames_per_s"] == L["frames_returned"] / L["window_s"]
    assert set(job.setup_parts) == {"process_and_imports", "weights_frames_predictor",
                                    "first_batch", "warm_batches", "to_window"}


def test_the_training_cell_agrees():
    out = core.driver("resident_graph").run(_tiny.train_job())
    got = _tiny.readings(out)
    assert got["stem_gap_vs_bf16"] < 1e-3
    assert got["loss1_gap"] < 1e-6 and got["grad_median_gap"] < 1e-5
    assert got["heads_grad_gap"] < 1e-6
    assert got["change_median_gap"] < 1e-4
    assert out.correct and out.end_to_end["train_images_per_s"] > 0
