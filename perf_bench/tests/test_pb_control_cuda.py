"""The control and the faults at each cell's own size, on the card, each
on three seeds, against the committed limits: the program's int8 serving
path must fail each serving cell; the plain step in fp8 (the precision
control), a train state left unchanged and half of each batch left out must
fail the training cell. Needs a CUDA card; skips without one. On the
machine with the card:
``python -m pytest perf_bench/tests/test_pb_control_cuda.py -q``."""

import time

import pytest
import torch

from perf_bench import core

CASES = [("canonical.serve.cameras", "int8", 4.0),
         ("dense384.serve.cameras", "int8", 6.0),
         ("canonical.train.graph", "fp8", 1.0),
         ("canonical.train.graph", "frozen", 1.0),
         ("canonical.train.graph", "half_batch", 1.0)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload,candidate,seconds", CASES)
def test_the_control_and_the_faults_are_not_correct(card, workload, candidate,
                                                    seconds):
    bench = core.benchmark()
    cell = core.cell(bench, workload)
    config = core.read_json("perf_bench", "configs", f"{cell['config']}.json")
    traffic = core.read_json("perf_bench", "traffic", f"{cell['traffic']}.json")
    limits = core.read_json("perf_bench", "limits", f"{workload}.json")
    prog_cfg, ref_cfg = core.configs_of(config)
    for seed in (9001, 9002, 9003):
        job = core.Job(workload=workload, config=config, traffic=traffic,
                       limits=limits, seed=seed, seconds=seconds, trace=False,
                       device=card, program_config=prog_cfg, ref_config=ref_cfg,
                       candidate=candidate, setup_origin=time.perf_counter())
        out = core.driver(traffic["kind"]).run(job)
        assert not out.correct, (seed, [(c.name, c.value, c.limit) for c in out.checks])
        del out, job
        torch.cuda.empty_cache()
