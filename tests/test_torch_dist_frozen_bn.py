"""The port's data-parallel train step with frozen BatchNorm (the SWA
epochs' mode) in fp32, on 2 gloo ranks on the CPU, against the JAX step on
the 8-device CPU mesh of tests/conftest.py: the tiny config and global
batch 8 of tests/test_torch_dist_train.py, two steps, the compact feed.
Only the gradients and the loss are reduced (no BN statistics). Held at
1e-5 of each tensor's scale (loss, gradient norm, parameters, momentum
buffers), the BN statistics unchanged, and the ranks bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu_torch import train_lib
from tests._torch_dist_child import run_ranks
from tests.test_torch_dist_train import assert_ranks_identical, dist_spec, jax_mesh_steps
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import assert_held, jax_state, port_model
from tests.test_torch_train import _batch, _configs

TOL = 1e-5


def test_two_ranks_frozen_bn_match_the_jax_mesh_fp32(tmp_path):
    jcfg, cfg = _configs()
    batches = [_batch(np.float32)]
    rng = np.random.RandomState(1)
    batches.append(tuple(rng.permutation(a) for a in batches[0]))
    model = port_model(cfg, torch.float32)
    jstate = jax_state(model, jcfg, np.float32)
    jstep = jtrain_lib.make_train_step(create_model(jcfg.model, dtype=jnp.float32),
                                       jcfg, donate=False, freeze_bn=True,
                                       compact_gt=True)
    traj = jax_mesh_steps(jstep, jstate, batches, np.float32)
    start = train_lib.state_payload(train_lib.create_train_state(
        model, cfg.train), cfg.train)
    outs = run_ranks(dist_spec(cfg, start, batches, True, "float32"), tmp_path)
    assert_ranks_identical(outs)
    assert_held(outs[0]["payload"], outs[0]["metrics"][-1], traj[-1][0],
                traj[-1][1], traj[0][0], freeze_bn=True, tol=TOL)
    np.testing.assert_allclose([m["loss"] for m in outs[0]["metrics"]],
                               [m["loss"] for _, m in traj], rtol=TOL)
