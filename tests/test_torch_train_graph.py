"""The K-steps dispatch on the card (``train_graph.py``): steps replayed
from a CUDA graph of the captured train step against the same steps run
eagerly, on the tiny model (nstack 2, inp_dim 32, increase 16, 64²,
batch 4) in fp32, with cuDNN held to deterministic kernels so that two runs
of one step are bit-identical. Every case needs a CUDA card and skips
without one; this module imports no jax, so on the machine with the card
(which has no jax) they run with
``python -m pytest tests/test_torch_train_graph.py --noconftest -q``.

Held exactly (``torch.equal``): the metrics of each step and every
parameter, momentum buffer, BN statistic and the step count after them,
for the resident feed in both BatchNorm modes, the dense and compact wire
feeds, remat, a 5-step epoch in chunks of 2 + 2 + 1, and the abnormal-loss
rollback inside a replay. The eager steps run with
``torch.cuda.set_sync_debug_mode("error")``: a copy from the host or a
host sync inside a step raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from improved_body_parts_tpu_torch import configs, train_lib
from improved_body_parts_tpu_torch.data.resident import ResidentFeed, build_store
from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
from improved_body_parts_tpu_torch.models.imhn import PoseNet

SIZE, B, K = 64, 4, 4
TINY = dict(nstack=2, inp_dim=32, increase=16)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = det


def _config(remat=False, **train):
    return configs.CanonicalConfig(
        width=SIZE, height=SIZE, model=configs.ModelConfig(**TINY, remat=remat),
        train=dataclasses.replace(configs.TrainConfig(), max_grad_norm=1.0,
                                  **train))


def _state(cfg, device):
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).to(device)
    return train_lib.create_train_state(model, cfg.train)


def _tensors(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [b.clone() for b in state.model.buffers()]
            + [m.clone() for m in state.momentum.values()] + [state.step.clone()])


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _resident(cfg, device, steps, seed=1):
    ds = SyntheticDataset(cfg, length=6, image_size=SIZE)
    store_h = build_store(ds)
    plans = list(ResidentFeed(store_h, cfg, augment=True).plan_batches(
        B, steps, seed=seed))
    chunk = tuple(torch.from_numpy(np.stack([p[i] for p in plans])).to(device)
                  for i in range(3))
    return store_h.device_arrays(device), chunk


def _lrs(n, device):
    return torch.tensor([1e-2 / (1 + k) for k in range(n)], device=device)


def _eager(step, state, fixed, chunk, lrs):
    """The steps one by one, eagerly, under the sync debug mode."""
    mets = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(lrs.shape[0]):
            args = [tuple(x[k] for x in c) if isinstance(c, tuple) else c[k]
                    for c in chunk]
            mets.append(step(state, *fixed, *args, lrs[k]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {key: torch.stack([m[key] for m in mets]) for key in mets[0]}


def _check(cfg, device, make_single, make_multi, fixed, chunk, n, k=K):
    """n eager steps against the same n steps replayed in chunks of k."""
    lrs = _lrs(n, device)
    eager, graph = _state(cfg, device), _state(cfg, device)
    want = _eager(make_single(eager.model), eager, fixed, chunk, lrs)
    multi = make_multi(graph.model)
    got = []
    for lo in range(0, n, k):
        part = tuple(tuple(x[lo:lo + k] for x in c) if isinstance(c, tuple)
                     else c[lo:lo + k] for c in chunk)
        got.append(multi(graph, *fixed, *part, lrs[lo:lo + k]))
    assert multi.graphed is not None
    for key in want:
        assert torch.equal(torch.cat([g[key] for g in got]), want[key]), key
    _assert_same(_tensors(graph), _tensors(eager))
    assert int(graph.step) == n


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_resident_graph_steps_equal_eager_steps(cuda, freeze_bn):
    cfg = _config()
    store, chunk = _resident(cfg, cuda, K)
    _check(cfg, cuda,
           lambda m: train_lib.make_resident_train_step(m, cfg, freeze_bn=freeze_bn),
           lambda m: train_lib.make_multi_resident_train_step(m, cfg,
                                                              freeze_bn=freeze_bn),
           (store,), chunk, K)


def test_short_last_chunk_replays_the_same_graph(cuda):
    """A 5-step epoch at K = 2: chunks of 2, 2 and 1, one capture."""
    cfg = _config()
    store, chunk = _resident(cfg, cuda, 5)
    _check(cfg, cuda, lambda m: train_lib.make_resident_train_step(m, cfg),
           lambda m: train_lib.make_multi_resident_train_step(m, cfg),
           (store,), chunk, 5, k=2)


@pytest.mark.parametrize("feed", ["dense", "compact"])
def test_wire_feed_graph_steps_equal_eager_steps(cuda, feed):
    cfg = _config()
    ds = SyntheticDataset(cfg, length=8, image_size=SIZE)
    batches = list(ds.batches(B, K, seed=2, compact=feed == "compact"))

    def stack(xs):
        if isinstance(xs[0], tuple):
            return tuple(stack([x[i] for x in xs]) for i in range(len(xs[0])))
        return torch.stack([torch.as_tensor(x) for x in xs]).float().to(cuda)

    chunk = tuple(stack([b[i] for b in batches]) for i in range(3))
    compact = feed == "compact"
    _check(cfg, cuda,
           lambda m: train_lib.make_train_step(m, cfg, compact_gt=compact),
           lambda m: train_lib.make_multi_train_step(m, cfg, compact_gt=compact),
           (), chunk, K)


def test_remat_graph_steps_equal_eager_steps(cuda):
    cfg = _config(remat=True)
    store, chunk = _resident(cfg, cuda, 2)
    _check(cfg, cuda, lambda m: train_lib.make_resident_train_step(m, cfg),
           lambda m: train_lib.make_multi_resident_train_step(m, cfg),
           (store,), chunk, 2)


def test_rollback_inside_a_replay_keeps_the_state(cuda):
    cfg = _config(abnormal_loss_thresh=1e-9)
    store, chunk = _resident(cfg, cuda, 3)
    state = _state(cfg, cuda)
    before = _tensors(state)
    multi = train_lib.make_multi_resident_train_step(state.model, cfg)
    metrics = multi(state, store, *chunk, _lrs(3, cuda))
    assert metrics["skipped"].tolist() == [1.0, 1.0, 1.0]
    after = _tensors(state)
    assert int(after[-1]) == int(before[-1]) + 3
    _assert_same(after[:-1], before[:-1])


def test_graph_refuses_another_state(cuda):
    cfg = _config()
    store, chunk = _resident(cfg, cuda, 1)
    state = _state(cfg, cuda)
    multi = train_lib.make_multi_resident_train_step(state.model, cfg)
    multi(state, store, *chunk, _lrs(1, cuda))
    other = train_lib.create_train_state(state.model, cfg.train)
    with pytest.raises(ValueError, match="another train state"):
        multi(other, store, *chunk, _lrs(1, cuda))


def test_resident_inputs_card_against_cpu(cuda):
    cfg = _config()
    ds = SyntheticDataset(cfg, length=6, image_size=SIZE)
    store_h = build_store(ds)
    idx, inv_m, _ = next(ResidentFeed(store_h, cfg, augment=True)
                         .plan_batches(B, 1, seed=4))
    want = train_lib.resident_inputs(store_h.device_arrays("cpu"),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(inv_m), cfg)
    got = train_lib.resident_inputs(store_h.device_arrays(cuda),
                                    torch.from_numpy(idx).to(cuda),
                                    torch.from_numpy(inv_m).to(cuda), cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)
