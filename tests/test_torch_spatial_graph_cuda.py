"""The spatially sharded step K a dispatch on the CUDA graph, over NCCL,
against the same steps taken eagerly (skipped without two cards; run on a
machine with the cards, which has no jax, with
``python -m pytest tests/test_torch_spatial_graph_cuda.py --noconftest -q``).

NCCL takes one card a rank, so the bands need two cards: 4 ranks as data
2 × spatial 2 where four are visible, else 2 as data 1 × spatial 2. Each
rank is a process of ``tests/_torch_dist_child.py`` with a card of its
own. The tiny model of tests/test_torch_train.py at 64², fp32 train-mode
BN, deterministic cuDNN, remat off and on, two steps of the compact feed:
once as two eager steps (under ``torch.cuda.set_sync_debug_mode("error")``:
a host sync or a copy from the host inside a step raises), once as one
dispatch of K = 2 on the CUDA graph (``make_multi_train_step(
shard_spatial=True)``, halo exchanges captured). Held bit for bit: each
step's loss, gradient norm and skipped flag, and every parameter, momentum
buffer and BN statistic after them, on every rank.

At full width the same check is ``tools/multi_card.py spatial`` on four
cards (``Canonical`` at 512², K = 4, fp32 frozen BN and bf16 train mode,
with the graph's and the eager step's ms, launch calls and peak memory)::

    python -m improved_body_parts_tpu_torch.tools.multi_card spatial
"""

import dataclasses

import numpy as np
import pytest
import torch

from improved_body_parts_tpu_torch import configs, train_lib
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from tests._torch_dist_child import run_ranks
from tests.test_torch_dist_cuda import _batches

SIZE, K = 64, 2
LRS = [1e-2, 5e-3]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("NCCL takes a card a rank: the bands need two cards")
    return 4 if n >= 4 else 2


def _config(remat: bool):
    return configs.CanonicalConfig(
        width=SIZE, height=SIZE,
        model=configs.ModelConfig(nstack=2, inp_dim=32, increase=16, remat=remat),
        train=dataclasses.replace(configs.TrainConfig(), max_grad_norm=1.0))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_banded_graph_dispatch_equals_eager_steps(cards, tmp_path, remat):
    cfg = _config(remat)
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    start = train_lib.state_payload(train_lib.create_train_state(model, cfg.train),
                                    cfg.train)
    spec = dict(kind="train", config=cfg, payload=start, batches=_batches(K),
                lrs=LRS, freeze_bn=False, dtype="float32", spatial=2,
                device="cuda", backend="nccl")
    runs = []
    for k in (1, K):
        (tmp_path / f"k{k}").mkdir()
        runs.append(run_ranks(dict(spec, k=k), tmp_path / f"k{k}", world=cards,
                              timeout=300))
    for eager, graph in zip(*runs):
        assert graph["metrics"] == eager["metrics"]
        assert all(np.isfinite(m["loss"]) for m in graph["metrics"])
        a, b = eager["payload"], graph["payload"]
        assert a["step"] == b["step"] == K
        assert all(torch.equal(a["weights"][k], b["weights"][k]) for k in a["weights"])
        ma, mb = (p["optimizer_weight"]["momentum_buffer"] for p in (a, b))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
