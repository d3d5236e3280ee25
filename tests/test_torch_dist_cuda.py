"""The data-parallel step on the card (skipped without one; run on the GPU
machine with ``python -m pytest tests/test_torch_dist_cuda.py --noconftest``,
which has no jax): one NCCL rank whose step is captured, all-reduces
included, in a CUDA graph, bit for bit against the same step taken
eagerly (fp32, frozen BN, deterministic cuDNN); and 2 gloo ranks sharing
the one card against one process on it with the whole batch (train-mode
BN in float64, at 1e-9 of each tensor's scale). The tiny config of
tests/test_torch_train.py.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

from improved_body_parts_tpu_torch import configs, train_lib
from improved_body_parts_tpu_torch.data.heatmaps_device import pad_people
from improved_body_parts_tpu_torch.data.synthetic import random_people
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from tests._torch_dist_child import run_ranks

B, SIZE, K = 8, 64, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _config():
    return configs.CanonicalConfig(
        width=SIZE, height=SIZE,
        model=configs.ModelConfig(nstack=2, inp_dim=32, increase=16),
        train=dataclasses.replace(configs.TrainConfig(), max_grad_norm=1.0))


def _model(cfg, device, dtype):
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    model.to(device, dtype)
    model.compute_dtype = dtype
    return model


def _batches(n, dtype=np.float32):
    out = []
    for k in range(n):
        rng = np.random.RandomState(k)
        joints = np.stack([pad_people(random_people(rng, SIZE, SIZE), 4)
                           for _ in range(B)])
        out.append(tuple(a.astype(dtype) for a in (
            rng.rand(B, SIZE, SIZE, 3), rng.rand(B, SIZE // 4, SIZE // 4, 1) > 0.2,
            joints, rng.rand(B, SIZE // 4, SIZE // 4) > 0.2)))
    return out


def _tensors(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [b.clone() for b in state.model.buffers()]
            + [m.clone() for m in state.momentum.values()])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_one_nccl_rank_graph_equals_eager(cuda):
    cfg = _config()
    mesh_lib.initialize_multihost(f"localhost:{_free_port()}", 1, 0, device=cuda)
    try:
        mesh = mesh_lib.make_mesh()
        assert mesh.data_parallel and mesh.backend == "nccl"
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        batches = [tuple(torch.from_numpy(a).to(cuda) for a in b)
                   for b in _batches(K)]
        runs = []
        for graphed in (False, True):
            model = _model(cfg, cuda, torch.float32)
            state = train_lib.create_train_state(model, cfg.train)
            if graphed:
                multi = train_lib.make_multi_train_step(model, cfg, freeze_bn=True,
                                                        compact_gt=True, mesh=mesh)
                stacked = [torch.stack([b[i] for b in batches]) for i in range(4)]
                met = multi(state, stacked[0], stacked[1], (stacked[2], stacked[3]),
                            torch.full((K,), 1e-2, device=cuda))
                assert multi.graphed is not None and multi.eager_reason is None
                loss = met["loss"]
            else:
                step = train_lib.make_train_step(model, cfg, freeze_bn=True,
                                                 compact_gt=True, mesh=mesh)
                loss = torch.stack([step(state, b[0], b[1], (b[2], b[3]), 1e-2)["loss"]
                                    for b in batches])
            runs.append((loss.cpu(), [t.cpu() for t in _tensors(state)]))
        (le, te), (lg, tg) = runs
        assert torch.equal(le, lg)
        assert all(torch.equal(a, b) for a, b in zip(te, tg))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_on_one_card_match_one_process(cuda, tmp_path):
    cfg = _config()
    batches = _batches(K, np.float64)
    lrs = [1e-2, 5e-3]
    model = _model(cfg, cuda, torch.float64)
    state = train_lib.create_train_state(model, cfg.train)
    start = train_lib.state_payload(state, cfg.train)
    step = train_lib.make_train_step(model, cfg, compact_gt=True)
    want = [float(step(state, *(torch.from_numpy(a).to(cuda) for a in b[:2]),
                       tuple(torch.from_numpy(a).to(cuda) for a in b[2:]), lr)["loss"])
            for b, lr in zip(batches, lrs)]
    one = train_lib.state_payload(state, cfg.train)
    outs = run_ranks(dict(kind="train", config=cfg, payload=start, batches=batches,
                          lrs=lrs, freeze_bn=False, dtype="float64", device="cuda:0"),
                     tmp_path)
    got = outs[0]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want, rtol=1e-9)
    top = max(float(v.abs().max()) for v in one["weights"].values())
    for k, v in one["weights"].items():
        if "num_batches" not in k:
            assert float((got["payload"]["weights"][k] - v).abs().max()) <= 1e-9 * max(
                float(v.abs().max()), 1e-3 * top), k
