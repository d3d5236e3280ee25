"""The port's spatially sharded train step on 4 gloo ranks as data 2 ×
spatial 2 (``make_mesh(spatial=2)``: each rank runs the network on its
band of the rows, halos exchanged around every conv) against the JAX step
on a spatial mesh of tests/conftest.py's CPU devices, with the images on
``batch_sharding(mesh, True)`` and the rest on ``P("data")``, as the JAX
dry run puts them (``__graft_entry__.py``).

The JAX step is held on ``make_mesh(2, spatial=2)`` (data 1 × spatial
2): on a mesh with both axes longer than 1 (2 × 2, 2 × 4, 4 × 2) the JAX
step's train-mode gradient is not its own unsharded one (gradient norm
40162.5 on 2 × 2 and 1888202.4 on 4 × 2, against 1540.947 unsharded, on
data-only meshes and on 1 × 2 and 1 × 4; the loss agrees; ROADMAP §C).
The port's four ranks agree with the unsharded step.

The tiny model of the tests with ``remat=True`` at 64², global batch 8,
the compact feed, two steps. At 64² the stride-4 map has 16 rows, 8 a
band; the hourglass halves them to 4, 2 and 1 a band, and its innermost
level (one row for two bands) is gathered and runs replicated, its scale's
loss counted once. Train-mode BN in float64 in both packages
(``jax_float64``, as tests/test_torch_dist_train.py holds it): loss,
gradient norm, parameters, momentum buffers and BN statistics within 1e-6
of each tensor's scale, the four ranks bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from tests.test_torch_train import LRS, _batch, jax_float64


def two_batches(dtype):
    first = _batch(dtype)
    rng = np.random.RandomState(1)
    return [first, tuple(rng.permutation(a) for a in first)]


def jax_spatial_steps(step, jstate, batches, dtype, n=4):
    """JAX steps on ``make_mesh(n, spatial=2)``: the images' rows on the
    spatial axis, every other leaf on the data axis, the state replicated;
    [(payload, metrics)] a step."""
    mesh = jmesh.make_mesh(n, spatial=2)
    assert mesh.shape == {"data": n // 2, "spatial": 2}
    jstate = jax.device_put(jstate, jmesh.replicated(mesh))
    rows, data = jmesh.batch_sharding(mesh, True), jmesh.batch_sharding(mesh)
    traj = []
    for (imgs, mask, joints, mask_all), lr in zip(batches, LRS):
        imgs = jax.device_put(imgs, rows)
        mask, joints, mask_all = (jax.device_put(a, data)
                                  for a in (mask, joints, mask_all))
        jstate, jm = step(jstate, imgs, mask, (joints, mask_all),
                          jnp.asarray(lr, dtype))
        traj.append((ckpt.train_state_from_flax(jstate),
                     {k: float(v) for k, v in jm.items()}))
    return traj


def test_four_ranks_data2_spatial2_train_mode_match_jax_spatial_float64(tmp_path):
    """data 2 × spatial 2 ranks against JAX's data 1 × spatial 2 mesh."""
    jcfg, cfg = remat_configs()
    batches = two_batches(np.float64)
    model = port_model(cfg, torch.float32)
    with jax_float64():
        jstate = jax_state(model, jcfg, np.float64)
        jstep = jtrain_lib.make_train_step(
            create_model(jcfg.model, dtype=jnp.float64), jcfg, donate=False,
            compact_gt=True)
        traj = jax_spatial_steps(jstep, jstate, batches, np.float64, n=2)
    start = train_lib.state_payload(train_lib.create_train_state(
        port_model(cfg, torch.float64), cfg.train), cfg.train)
    outs = run_ranks(spatial_spec(cfg, start, batches, False, "float64"),
                     tmp_path, world=4)
    assert_ranks_bit_identical(outs)
    assert [m["loss"] for m in outs[0]["metrics"]] == pytest.approx(
        [t[1]["loss"] for t in traj], rel=1e-6)
    assert_held(outs[0]["payload"], outs[0]["metrics"][-1], traj[-1][0],
                traj[-1][1], traj[0][0], freeze_bn=False)
