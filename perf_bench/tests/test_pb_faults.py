"""Each fault a cell can have, planted under a run that skips only the
look for a card, makes ``correct`` come out false (the tiny size on the
CPU, with the limits of ``_tiny``)."""

import torch

from perf_bench import core
from perf_bench.tests import _tiny


def test_serving_an_altered_answer_is_caught(monkeypatch):
    from improved_body_parts_tpu_torch.ops import group
    real = group.humans_to_keypoints

    def moved(table, cands):
        kps, scores = real(table, cands)
        kps[..., 0] += 1.0
        return kps, scores
    monkeypatch.setattr(group, "humans_to_keypoints", moved)
    out = core.driver("closed_loop_cameras").run(_tiny.serve_job())
    assert not out.correct
    assert _tiny.readings(out)["keypoint_gap"] >= 1.0


def test_serving_half_the_batch_left_out_is_caught(monkeypatch):
    from improved_body_parts_tpu_torch.infer.predict import Predictor
    real = Predictor._flip_avg_maps

    def half(self, imgs):
        n = max(1, imgs.shape[0] // 2)
        kept = real(self, imgs[:n])
        rest = kept.mean(dim=0, keepdim=True).expand(imgs.shape[0] - n, *kept.shape[1:])
        return torch.cat([kept, rest])
    monkeypatch.setattr(Predictor, "_flip_avg_maps", half)
    out = core.driver("closed_loop_cameras").run(_tiny.serve_job())
    assert not out.correct
    assert _tiny.readings(out)["maps_gap_vs_bf16"] > 1.0


def test_training_a_state_left_unchanged_is_caught():
    out = core.driver("resident_graph").run(_tiny.train_job(candidate="frozen"))
    assert not out.correct
    assert _tiny.readings(out)["change_median_gap"] > 0.5


def test_training_half_the_batch_left_out_is_caught():
    out = core.driver("resident_graph").run(_tiny.train_job(candidate="half_batch"))
    assert not out.correct
    assert _tiny.readings(out)["loss1_gap"] > 1e-2


def test_training_the_precision_control_is_caught():
    """The plain step in fp8 in the program's place reads beyond the
    committed limit of the training cell's stem number; the program in bf16
    reads inside it."""
    limit = core.read_json("perf_bench", "limits",
                           "canonical.train.graph.json")["stem_gap_vs_bf16"]
    out = core.driver("resident_graph").run(_tiny.train_job(candidate="fp8"))
    assert not out.correct
    assert _tiny.readings(out)["stem_gap_vs_bf16"] > limit
    out = core.driver("resident_graph").run(_tiny.train_job(dtype="bfloat16"))
    assert _tiny.readings(out)["stem_gap_vs_bf16"] < limit
