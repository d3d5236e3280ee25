"""The port's resident train step with the store sharded over 2 gloo
ranks (``device_arrays(shard=)``, ``plan_batches(store_shards=2)``,
``make_resident_train_step(mesh=)``) against JAX
``make_resident_train_step(store_mesh=)`` with the store sharded over a
2-device mesh of tests/conftest.py's CPU devices (the same split: 3
records and 4 samples a shard), on the synthetic store and augmented plans
of tests/test_torch_resident.py, two steps in train mode in float64
(``jax_float64_resident``) at 1e-6 of each tensor's scale, the ranks
bit-identical. Each rank gathers from its own record range with its local
indices; no collective moves records.

Then the order the four-card dry run hung in, on 4 gloo ranks: steps K = 2
a dispatch, then the group destroyed (``parallel/mesh.shutdown``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.data import resident
from improved_body_parts_tpu_torch.data.synthetic import SyntheticDataset
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests._torch_dist_child import run_ranks
from tests.test_torch_dist_train import assert_ranks_identical
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import (  # noqa: F401  (fixture)
    assert_held, feeds, jax_float64_resident, jax_state, port_model,
    synthetic_stores,
)
from tests.test_torch_train import B, LRS, P, SIZE, _configs


def test_sharded_store_steps_match_jax_store_mesh_float64(synthetic_stores, tmp_path):
    jcfg, cfg = _configs()
    jstore_h, store_h = synthetic_stores
    _, feed = feeds(synthetic_stores, augment=True)
    plans = list(feed.plan_batches(B, 2, seed=5, store_shards=2))
    model = port_model(cfg, torch.float32)
    mesh = jmesh.make_mesh(2)
    with jax_float64_resident():
        jstate = jax.device_put(jax_state(model, jcfg, np.float64),
                                jmesh.replicated(mesh))
        jstep = jtrain_lib.make_resident_train_step(
            create_model(jcfg.model, dtype=jnp.float64), jcfg, donate=False,
            store_mesh=mesh)
        jstore = jstore_h.device_arrays(jmesh.batch_sharding(mesh))
        traj = []
        for (idx, inv_m, joints), lr in zip(plans, LRS):
            args = jmesh.shard_batch(mesh, (idx, inv_m.astype(np.float64),
                                            joints.astype(np.float64)))
            jstate, jm = jstep(jstate, jstore, *args, jnp.asarray(lr, jnp.float64))
            traj.append((ckpt.train_state_from_flax(jstate),
                         {k: float(v) for k, v in jm.items()}))
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float64), cfg.train), cfg.train)
    store = dict(images=store_h.images, joints=None, objpos=None, scale=None)
    outs = run_ranks(dict(kind="resident", config=cfg, payload=start, store=store,
                          plans=plans, lrs=list(LRS), freeze_bn=False,
                          dtype="float64"), tmp_path)
    assert_ranks_identical(outs)
    np.testing.assert_allclose([m["loss"] for m in outs[0]["metrics"]],
                               [m["loss"] for _, m in traj], rtol=1e-6)
    assert_held(outs[0]["payload"], outs[0]["metrics"][-1], traj[-1][0],
                traj[-1][1], traj[0][0], freeze_bn=False)


def test_four_ranks_let_go_of_the_dispatch_graph_before_the_group_goes(tmp_path):
    """4 ranks, each with a quarter of the store, take 2 train steps in one
    K = 2 dispatch and leave through ``parallel/mesh.shutdown``. On cards
    the dispatch is a CUDA graph holding NCCL's captured all-reduces, and
    destroying the group while it lived hung every rank of the four-card
    dry run; gloo runs the steps eagerly, so the dispatch holds a stand-in
    for the graph here (tests/_torch_dist_child.py ``graph_probe``), which
    must be reset when the group is destroyed, though the rank still holds
    a reference to it. The ranks agree."""
    _, cfg = _configs()
    store_h = resident.build_store(SyntheticDataset(cfg, length=8, image_size=SIZE))
    feed = resident.ResidentFeed(store_h, cfg, augment=True, max_people=P)
    plans = list(feed.plan_batches(B, 2, seed=5, store_shards=4))
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float32), cfg.train), cfg.train)
    store = dict(images=store_h.images, joints=None, objpos=None, scale=None)
    outs = run_ranks(dict(kind="resident", config=cfg, payload=start, store=store,
                          plans=plans, lrs=list(LRS), freeze_bn=False,
                          dtype="float32", k=2, graph_probe=True),
                     tmp_path, world=4)
    assert [o["graph_alive_at_destroy"] for o in outs] == [False] * 4
    losses = [m["loss"] for m in outs[0]["metrics"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for o in outs[1:]:
        np.testing.assert_equal(o["metrics"], outs[0]["metrics"])
