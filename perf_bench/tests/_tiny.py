"""A tiny cell of each kind for the CPU tests: the drivers at 64 px on a
2-stack network 32 channels wide."""

from __future__ import annotations

import dataclasses
import time

import torch

from perf_bench import core

TINY_MODEL = {"nstack": 2, "inp_dim": 32, "increase": 16, "depth": 4,
              "oup_dim": 50, "num_scales": 5, "bn": True, "se_reduction": 16,
              "cross_stack": True, "legacy_blocks": False,
              "extra_attention": False, "remat": False}
SIZE = 64


def _config(module):
    return module.CanonicalConfig(
        width=SIZE, height=SIZE,
        model=module.ModelConfig(nstack=2, inp_dim=32, increase=16),
        infer=module.InferenceConfig(boxsize=SIZE))


def program_config():
    from improved_body_parts_tpu_torch import configs
    return _config(configs)


def ref_config():
    from perf_bench.reference import layout
    return _config(layout)


def serve_job(seed: int = 7, seconds: float = 5.0, candidate=None,
              limits=None, trace: bool = False) -> core.Job:
    traffic = dict(core.read_json("perf_bench", "traffic", "serve.cameras.json"),
                   cameras=4, frames=16, frame_size=SIZE, batch_size=2, depth=2,
                   warm_batches=2, sample_from=3, sample_batches=2,
                   reference_chunk=2, dtype="float32")
    return core.Job(workload="tiny.serve", config={"model": TINY_MODEL},
                    traffic=traffic, limits=limits or {
                        "maps_gap_vs_bf16": 1e-2, "people_mismatch": 0.0,
                        "keypoint_gap": 1e-3},
                    seed=seed, seconds=seconds, trace=trace,
                    device=torch.device("cpu"), program_config=program_config(),
                    ref_config=ref_config(),
                    candidate=candidate, setup_origin=time.perf_counter())


def train_job(seed: int = 7, seconds: float = 1.0, candidate=None,
              limits=None, dtype: str = "float32") -> core.Job:
    traffic = dict(core.read_json("perf_bench", "traffic", "train.graph.json"),
                   batch_size=2, steps_per_dispatch=2, records_per_second=4,
                   dtype=dtype)
    return core.Job(workload="tiny.train", config={"model": TINY_MODEL},
                    traffic=traffic, limits=limits or {
                        "stem_gap_vs_bf16": 0.5, "loss1_gap": 1e-5, "heads_grad_gap": 1e-4,
                        "grad_median_gap": 1e-3,
                        "change_median_gap": 1e-2},
                    seed=seed, seconds=seconds, trace=False,
                    device=torch.device("cpu"), program_config=program_config(),
                    ref_config=ref_config(),
                    candidate=candidate, setup_origin=time.perf_counter())


def readings(outcome: core.Outcome) -> dict:
    return {c.name: c.value for c in outcome.checks}


def replace(job: core.Job, **kw) -> core.Job:
    return dataclasses.replace(job, **kw)
