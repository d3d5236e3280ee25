"""The port's K-steps dispatch of the spatially sharded train step
(``train_lib.make_multi_train_step(shard_spatial=True)``) on 2 gloo ranks
as data 1 × spatial 2, against the JAX package's
``make_multi_train_step`` (one ``lax.scan`` of the K steps) on
``make_mesh(2, spatial=2)`` of tests/conftest.py's CPU devices, the chunk
on ``chunked_batch_sharding(mesh, True)`` for the images and the mask and
``chunked_batch_sharding(mesh)`` for the joints and ``mask_all``.

K = 2 in one dispatch, the tiny model of the tests with ``remat=True`` at
64², global batch 4, the compact feed, train-mode BN in float64 in both
packages (``jax_float64``). On the CPU (and under gloo on a card) the
port's dispatch runs its K steps eagerly (``MultiStep``); on the card over
NCCL the same steps replay from a CUDA graph, held bit for bit against
eager steps by ``tools/multi_card spatial`` on four cards. The JAX 1 × 2
mesh is where its sharded step agrees with its unsharded one (ROADMAP §C).
Held: the stacked metrics of both steps (loss, gradient norm, skipped),
and every parameter, momentum buffer and BN statistic after the dispatch,
within 1e-6 of each tensor's scale; the two ranks bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests._torch_dist_child import run_ranks
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import assert_held, jax_state, port_model
from tests.test_torch_spatial import (
    assert_ranks_bit_identical, remat_configs, spatial_spec,
)
from tests.test_torch_spatial_train import two_batches
from tests.test_torch_train import LRS, TOL64, jax_float64

K = len(LRS)


def jax_dispatch(jcfg, jstate, batches):
    """One JAX dispatch of the K steps on ``make_mesh(2, spatial=2)``: the
    payload after it and the stacked metrics, a dict a step."""
    mesh = jmesh.make_mesh(2, spatial=2)
    assert mesh.shape == {"data": 1, "spatial": 2}
    multi = jtrain_lib.make_multi_train_step(
        create_model(jcfg.model, dtype=jnp.float64), jcfg, donate=False,
        compact_gt=True)
    imgs, mask, joints, mask_all = (np.stack([b[i] for b in batches])
                                    for i in range(4))
    rows = jmesh.chunked_batch_sharding(mesh, True)
    data = jmesh.chunked_batch_sharding(mesh)
    jstate, jm = multi(jax.device_put(jstate, jmesh.replicated(mesh)),
                       jax.device_put(imgs, rows), jax.device_put(mask, rows),
                       (jax.device_put(joints, data), jax.device_put(mask_all, data)),
                       jnp.asarray(LRS, jnp.float64))
    metrics = [{k: float(v[i]) for k, v in jm.items()} for i in range(K)]
    return ckpt.train_state_from_flax(jstate), metrics


def test_k2_banded_dispatch_matches_jax_multi_train_step_float64(tmp_path):
    jcfg, cfg = remat_configs()
    batches = two_batches(np.float64)
    with jax_float64():
        jstate = jax_state(port_model(cfg, torch.float32), jcfg, np.float64)
        want, jmetrics = jax_dispatch(jcfg, jstate, batches)
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float64), cfg.train), cfg.train)
    outs = run_ranks(dict(spatial_spec(cfg, start, batches, False, "float64"),
                          k=K), tmp_path, world=2)
    assert_ranks_bit_identical(outs)
    got = outs[0]["metrics"]
    assert len(got) == len(jmetrics) == K
    for g, w in zip(got, jmetrics):
        assert g["skipped"] == w["skipped"] == 0.0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TOL64)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=TOL64)
    assert_held(outs[0]["payload"], got[-1], want, jmetrics[-1], start,
                freeze_bn=False)
