"""The port's multi-GPU scaffolding (``parallel/mesh.py``), the sharded
resident store's plans and mesh-sharded serving, against the JAX package's.

Exact: ``process_batch_slice`` against JAX's with the process count and
index it reads; the sharded store's records and plans
(``plan_batches(store_shards=2, rank, world)``: indices, joints; the
float32 inverse maps at 1e-6, as tests/test_torch_resident.py holds the
unsharded plans); the per-rank staging. ``predict_batch(mesh=)`` over a
CPU mesh of two replicas against JAX ``predict_batch(mesh=make_mesh(2))``
on two of the 8 CPU devices of tests/conftest.py, flip TTA and
``scales=(0.5, 1.0)``, with a batch of 3 that is padded to 4: the same
skeletons at 1e-4 (fp32 on both sides, tests/test_torch_predict.py's
tolerance), and the mesh's packed buffers equal the unsharded port's.
"""

import jax
import numpy as np
import pytest
import torch

from improved_body_parts_tpu.data import resident as jresident
from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu_torch.data import resident
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_predict import (  # noqa: F401  (fixtures)
    SIZE, _assert_people_match, _frames, pair, single_torch_thread,
)
from tests.test_torch_resident import (  # noqa: F401  (fixture)
    JSynthetic, SyntheticDataset, feeds, synthetic_stores,
)
from tests.test_torch_train import _configs

CPU = torch.device("cpu")


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_process_batch_slice_matches_jax(monkeypatch, rank, world):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    assert mesh_lib.process_batch_slice(8, rank, world) == jmesh.process_batch_slice(8)
    with pytest.raises(AssertionError):
        mesh_lib.process_batch_slice(7, rank, 2)


def test_mesh_without_a_process_group():
    mesh = mesh_lib.make_mesh(devices=["cpu", "cpu", "cpu"], n_devices=2)
    assert mesh.devices == (CPU, CPU) and mesh.device == CPU
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert mesh.shape == {mesh_lib.DATA_AXIS: 2} and not mesh.data_parallel
    assert mesh_lib.process_batch_slice(6) == slice(0, 6)


def test_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        mesh_lib.make_mesh()
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        mesh_lib.initialize_multihost()
    with pytest.raises(ValueError, match="number of processes"):
        mesh_lib.initialize_multihost("localhost:1234")


def test_per_rank_staging():
    """``shard_batch`` keeps this rank's rows of a global batch;
    ``staged_batches``/``staged_chunks`` take a mesh or a device."""
    glob = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
            (np.arange(8, dtype=np.int32), np.ones((8, 2), np.float32)))
    mesh = mesh_lib.Mesh((CPU,), rank=1, world=2)
    imgs, (idx, ones) = mesh_lib.shard_batch(mesh, glob)
    assert torch.equal(imgs, torch.from_numpy(glob[0][4:]))
    assert idx.tolist() == [4, 5, 6, 7] and ones.shape == (4, 2)
    batches = [(np.full((2,), i, np.float32),) for i in range(5)]
    got = list(mesh_lib.staged_batches(mesh, iter(batches)))
    assert [int(b[0][0]) for b in got] == list(range(5))
    chunks = list(mesh_lib.staged_chunks(CPU, iter(batches), k=2))
    assert [n for n, _ in chunks] == [2, 2, 1]
    assert chunks[0][1][0].shape == (2, 2)


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("augment", [False, True])
def test_sharded_plans_match_jax(synthetic_stores, augment, rank, world):
    jfeed, feed = feeds(synthetic_stores, augment)
    got = list(feed.plan_batches(6, 3, seed=7, rank=rank, world=world,
                                 store_shards=2))
    want = list(jfeed.plan_batches(6, 3, seed=7, rank=rank, world=world,
                                   store_shards=2))
    assert len(got) == len(want) == 3
    for (i, m, j), (ji, jm, jj) in zip(got, want):
        np.testing.assert_array_equal(i, ji)
        assert i.dtype == ji.dtype and i.max() < len(synthetic_stores[1]) // 2
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(j, jj)


def test_sharded_store_arrays_and_trimmed_records(synthetic_stores):
    """``build_store(indices=)`` equals JAX's; each rank's copy is its
    contiguous record range."""
    _, store = synthetic_stores
    jcfg, cfg = _configs()
    keep = np.arange(4)
    jtrim = jresident.build_store(JSynthetic(jcfg, length=6, image_size=SIZE // 2),
                                  indices=keep)
    trim = resident.build_store(SyntheticDataset(cfg, length=6,
                                                 image_size=SIZE // 2), indices=keep)
    np.testing.assert_array_equal(trim.images, jtrim.images)
    np.testing.assert_array_equal(trim.objpos, jtrim.objpos)
    assert len(trim) == 4
    halves = [store.device_arrays(CPU, shard=(r, 2))["images"] for r in range(2)]
    assert torch.equal(torch.cat(halves), torch.from_numpy(store.images))
    with pytest.raises(ValueError, match="divide"):
        store.device_arrays(CPU, shard=(0, 4))


@pytest.mark.parametrize("scales", [None, (0.5, 1.0)], ids=["flip", "scales"])
def test_predict_batch_on_a_mesh_matches_jax(pair, scales):
    """Three frames over two CPU replicas (padded to four) against JAX on
    two CPU devices, and the mesh's packed buffers against the unsharded
    port's."""
    jpred, tpred = pair
    imgs = _frames(3, seed=5)
    hs = np.float32([SIZE, SIZE * 0.75, SIZE])
    chws = np.float32([[SIZE, SIZE], [SIZE * 0.75, SIZE], [SIZE, SIZE * 0.5]])
    mesh = mesh_lib.make_mesh(devices=[CPU, CPU])
    kw = dict(img_hs=hs, content_hws=chws, use_cpp=True, scales=scales)
    got = tpred.predict_batch(imgs, mesh=mesh, **kw)
    want = jpred.predict_batch(imgs, mesh=jmesh.make_mesh(2), **kw)
    assert len(got) == 3 and sum(len(k) for k, _ in got) > 0
    _assert_people_match(got, want)
    _assert_people_match(got, tpred.predict_batch(imgs, **kw))
    key = ((1.0,) if scales is None else scales, (0.0,))
    padded = np.concatenate([imgs, imgs[-1:]])
    reps = tpred._mesh_replicas(mesh)
    assert reps[0][0] is tpred and reps[1][0].model is not tpred.model
    packed = tpred._run_mesh(mesh, padded, np.append(hs, hs[-1]),
                             np.concatenate([chws, chws[-1:]]), *key)
    with torch.inference_mode():
        flat = np.concatenate([tpred._run(padded[i:i + 2], np.append(hs, hs[-1])[i:i + 2],
                                          np.concatenate([chws, chws[-1:]])[i:i + 2],
                                          *key)[0].numpy() for i in (0, 2)])
    np.testing.assert_array_equal(packed, flat)
    assert tpred._mesh_replicas(mesh) is reps          # made once per device set
